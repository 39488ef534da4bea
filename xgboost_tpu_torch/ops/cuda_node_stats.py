"""Kernel K2: per-node (G, H) sums, hand-written CUDA.

Replaces the TPU kernel ``xgboost_tpu/ops/pallas_hist.py:_nst_kernel``
(launched through ``node_stats_pallas``).  The CUDA source is
``csrc/node_stats.cu``; this module holds its wrapper, its plain PyTorch
version and its launch count.

The function: gh (T, N, 2) f32 and pos (T, N) int32 -> (T, n_node, 2)
f32, ``out[t, m] = sum of gh[t, r] over the rows with pos[t, r] == m``;
rows with ``pos`` outside ``[0, n_node)`` are dropped.  The kernel is
one launch: a thread block cluster a (tree, node tile), its blocks'
rows and the order of every addition fixed by :func:`node_stats_plan`
from N, T and n_node alone, so its result is the same bits from run to
run and on any card; it differs from the plain version's order by f32
rounding only.

:func:`node_stats` launches the kernel for a CUDA tensor and runs
:func:`node_stats_plain` for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from xgboost_tpu_torch.ops import nvcc

CLUSTER = 8     # blocks a (tree, node tile): csrc/node_stats.cu

# launches of the CUDA kernel by node_stats (never by the plain version)
launches = 0
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


class NodeStatsPlan(NamedTuple):
    """One launch of K2 (``csrc/node_stats.cu``)."""
    node_tile: int        # nodes a cluster sums in registers: 1 or 32
    threads: int          # a block: 1024 at one node, 512 at 32
    cluster: int          # blocks a (tree, node tile), CLUSTER
    rows_per_block: int   # block rank b sums rows [b, b + 1) x this
    grid: tuple           # (cluster, T, node tiles)


def node_stats_plan(n_rows: int, n_tree: int,
                    n_node: int) -> NodeStatsPlan:
    """K2's launch, pure Python, from the shapes alone: the rows each
    block sums and so the order of every addition never depend on the
    card.  One node (the depth-0 path) sums two registers a thread;
    more nodes take tiles of 32."""
    tile, threads = (1, 1024) if n_node == 1 else (32, 512)
    return NodeStatsPlan(tile, threads, CLUSTER,
                         max(1, -(-n_rows // CLUSTER)),
                         (CLUSTER, n_tree, -(-n_node // tile)))


def _check(gh, pos, n_node):
    if gh.dim() != 3 or gh.shape[2] != 2 or pos.shape != gh.shape[:2]:
        raise ValueError(f"shapes: gh {tuple(gh.shape)}, pos "
                         f"{tuple(pos.shape)}: want (T, N, 2) and (T, N)")
    if gh.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError(f"gh must be float32 (got {gh.dtype}), pos int32 "
                        f"(got {pos.dtype})")
    if n_node < 1:
        raise ValueError(f"n_node={n_node}")


def node_stats(gh: torch.Tensor, pos: torch.Tensor,
               n_node: int) -> torch.Tensor:
    """K2: (T, n_node, 2) f32 node sums.  CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    _check(gh, pos, n_node)
    if gh.device.type == "cpu":
        return node_stats_plain(gh, pos, n_node)
    if gh.device.type != "cuda":
        raise NotImplementedError(f"no node-stat kernel for {gh.device}")
    return _launch(gh, pos, n_node)


def _launch(gh, pos, n_node):
    global launches
    if gh.device != pos.device:
        raise ValueError("gh and pos must be on one device")
    if not (gh.is_contiguous() and pos.is_contiguous()) \
            or gh.data_ptr() % 8:
        raise ValueError("gh and pos must be contiguous, gh 8-aligned")
    T, N, _ = gh.shape
    if T == 0:
        return torch.zeros((T, n_node, 2), dtype=torch.float32,
                           device=gh.device)
    p = node_stats_plan(N, T, n_node)
    out = torch.empty((T, n_node, 2), dtype=torch.float32, device=gh.device)
    lib = _lib()
    with torch.cuda.device(gh.device):     # the launch targets this card
        stream = torch.cuda.current_stream(gh.device).cuda_stream
        rc = lib.node_stats_launch(pos.data_ptr(), gh.data_ptr(),
                                   out.data_ptr(), N, T, n_node, p.node_tile,
                                   p.threads, p.cluster, p.rows_per_block,
                                   stream)
    if rc != 0:
        raise RuntimeError("node_stats kernel launch failed: "
                           + lib.node_stats_error_string(rc).decode())
    with _COUNT_LOCK:     # lane threads launch at once
        launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = nvcc.load("node_stats")
    if lib.node_stats_launch.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.node_stats_launch.argtypes = [P, P, P, L, I, I, I, I, I, L, P]
        lib.node_stats_launch.restype = I
        lib.node_stats_error_string.argtypes = [I]
        lib.node_stats_error_string.restype = ctypes.c_char_p
    return lib


def node_stats_plain(gh: torch.Tensor, pos: torch.Tensor,
                     n_node: int) -> torch.Tensor:
    """Plain PyTorch K2 on any device: one ``index_add_`` into
    ``n_node + 1`` slots per tree (the last one takes the dropped rows,
    the JAX scatter's ``mode="drop"``).  On the CPU the adds run in row
    order, the order of the JAX scatter."""
    _check(gh, pos, n_node)
    T, N, _ = gh.shape
    slot = torch.where(pos < 0, n_node, pos).to(torch.int64)
    idx = slot + (n_node + 1) * torch.arange(
        T, dtype=torch.int64, device=gh.device)[:, None]
    out = torch.zeros((T * (n_node + 1), 2), dtype=torch.float32,
                      device=gh.device)
    out.index_add_(0, idx.reshape(-1), gh.reshape(-1, 2))
    return out.reshape(T, n_node + 1, 2)[:, :n_node]
