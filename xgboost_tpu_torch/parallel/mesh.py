"""The data-parallel world of row-split training (port of
``xgboost_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of
devices with axis ``"data"``.  The port runs one process per rank: a
:class:`DataMesh` is this process's view of the world, its rank, the
world size, the rank's device, the ``torch.distributed`` process group
and its backend.  There is no ``shard_map``: each rank runs the plain
function on its block of rows and the collectives of
:mod:`~xgboost_tpu_torch.parallel.dp` join the partial sums.

Rank r holds the contiguous block ``[r * m, (r + 1) * m)`` of the rows
padded to a multiple of the world, ``m = (N + pad) / W`` with ``pad =
(-N) % W``: the block the JAX mesh gives device r, so every partial sum
covers the same rows in both packages.  Without an initialised process
group the world is one rank.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch


class DataMesh:
    """This rank's view of the row-split world.

    ``group`` is None in a world of one (every collective is then the
    identity).  ``backend`` is ``"gloo"`` or ``"nccl"`` (``"none"`` for a
    world of one)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 group=None, backend: str = "none"):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.group = group
        self.backend = backend

    # ---------------------------------------------------------- row blocks
    def block(self, n: int) -> Tuple[int, int, int]:
        """``(start, stop, rows)`` of this rank's block of ``n`` rows
        padded to the world: rows ``[start, stop)`` of the padded layout,
        ``rows = stop - start`` each rank alike."""
        m = (n + (-n) % self.world) // self.world
        return self.rank * m, (self.rank + 1) * m, m

    # ---------------------------------------------------------- collectives
    def _timed(self, op: str, nbytes: int):
        from xgboost_tpu_torch.obs import comm
        return comm.timed(op, nbytes=nbytes)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        if self.world == 1:
            return [t]
        import torch.distributed as dist
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        with self._timed("allgather", t.numel() * t.element_size()
                         * self.world):
            dist.all_gather(out, t, group=self.group)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t``, bitwise the same on every rank:
        integers ``all_reduce(SUM)`` (exact, any order), floats gathered
        and added in rank order, ``((p0 + p1) + p2) + ...``, so that no
        backend's reduction order can make two ranks' split decisions
        differ."""
        if self.world == 1:
            return t
        if not t.dtype.is_floating_point:
            import torch.distributed as dist
            t = t.contiguous().clone()
            with self._timed("allreduce", t.numel() * t.element_size()):
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            return t
        parts = self.all_gather(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ranks (exact in any order)."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        t = t.contiguous().clone()
        with self._timed("allreduce", t.numel() * t.element_size()):
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (equal shapes)."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        t = t.contiguous().clone()
        with self._timed("broadcast", t.numel() * t.element_size()):
            dist.broadcast(t, src, group=self.group)
        return t

    def broadcast_bytes(self, raw: bytes, src: int = 0) -> bytes:
        """``raw`` of rank ``src`` on every rank (length first, then the
        bytes), through host tensors."""
        if self.world == 1:
            return raw
        import torch.distributed as dist
        n = torch.tensor([len(raw) if self.rank == src else 0],
                         dtype=torch.int64)
        dev = self._host_device()
        n = n.to(dev)
        t0 = time.perf_counter()
        dist.broadcast(n, src, group=self.group)
        buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
        if self.rank == src and len(raw):
            buf.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
        if buf.numel():
            dist.broadcast(buf, src, group=self.group)
        from xgboost_tpu_torch.obs import comm
        comm.record("broadcast", nbytes=8 + buf.numel(),
                    seconds=time.perf_counter() - t0, count=2)
        return bytes(buf.cpu().numpy().tobytes())

    def allsum_host(self, vec) -> "np.ndarray":
        """A small float64 host vector summed over the ranks, in rank
        order (the metric ``(sum, wsum)`` allreduce)."""
        import numpy as np
        v = torch.from_numpy(np.ascontiguousarray(np.asarray(vec,
                                                             np.float64)))
        if self.world == 1:
            return v.numpy()
        return self.sum(v.to(self._host_device())).cpu().numpy()

    def _host_device(self) -> torch.device:
        """Where host payloads travel: the CPU under gloo, the rank's
        card under NCCL (which takes no host tensor)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier(group=self.group)


_default_mesh: Optional[DataMesh] = None


def set_mesh(mesh: Optional[DataMesh]) -> None:
    """Install a process-wide default world for ``dsplit=row``."""
    global _default_mesh
    _default_mesh = mesh


def get_mesh() -> Optional[DataMesh]:
    return _default_mesh


def data_parallel_mesh(device=None) -> DataMesh:
    """The installed world, else the initialised ``torch.distributed``
    world, else a world of one.  Its device is ``device``, or by default
    the rank's card under NCCL and the CPU otherwise (where host
    payloads travel)."""
    if _default_mesh is not None:
        return _default_mesh
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        if device is None:
            from xgboost_tpu_torch.parallel.launch import rank_device
            device = rank_device() if backend == "nccl" else "cpu"
        return DataMesh(dist.get_rank(), dist.get_world_size(),
                        torch.device(device), None, backend)
    return DataMesh(0, 1, torch.device("cpu" if device is None else device))


def mesh_available(min_ranks: int = 2) -> bool:
    """True when this process is a rank of an initialised world of at
    least ``min_ranks`` ranks."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() >= min_ranks)
