"""Per-rank split loading: each rank parses only its block of rows (port
of ``xgboost_tpu/parallel/sharded.py``; the reference's per-worker
partition of the input text, ``simple_dmatrix-inl.hpp:89-96``).

:class:`ShardedDMatrix` parses the contiguous block of a libsvm text
file that rank r holds under row split (:meth:`DataMesh.block` of the
global row count, the block the JAX mesh gives device r), so a model
trained from a split load is byte-equal to one trained from a
replicated load over the same world.  The cuts come from the device
sketch (:func:`~.sketch_device.sketch_cuts_global`), since no rank holds
a full column, and evaluation reduces per-rank metric partials
(:meth:`ShardedDMatrix.allsum`, the reference's rabit ``Allreduce`` of
``(sum, wsum)``) or gathers value runs for the exact AUC
(:meth:`ShardedDMatrix.allgatherv`).

Ranking groups do not compose with row blocks (a group would straddle
two ranks), and custom objectives and metrics need the full vectors:
both raise, naming replicated loading.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from xgboost_tpu_torch.data import DMatrix, MetaInfo


def _count_rows(path: str) -> int:
    """Data rows (non-empty lines) of a libsvm text file."""
    n = 0
    with open(path, "rb") as f:
        for raw in f:
            if raw.strip():
                n += 1
    return n


def _read_row_block(path: str, start: int, end: int):
    """Rows ``[start, end)`` (0-based, counting non-empty lines) as CSR
    ``(indptr, indices, values, labels)``; rows before ``start`` are
    only tested for emptiness, not tokenised."""
    labels: list = []
    indptr: list = [0]
    indices: list = []
    values: list = []
    row = 0
    with open(path, "rb") as f:
        for raw in f:
            if not raw.strip():
                continue
            if row >= end:
                break
            if row >= start:
                parts = raw.split()
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    k, _, v = tok.partition(b":")
                    indices.append(int(k))
                    values.append(float(v))
                indptr.append(len(indices))
            row += 1
    return (np.asarray(indptr, np.int64), np.asarray(indices, np.int32),
            np.asarray(values, np.float32), np.asarray(labels, np.float32))


class ShardedDMatrix:
    """A libsvm text file's block of rows for this rank.  ``num_row`` is
    the global row count; the learner pads and places the block exactly
    as it would a replicated matrix's."""

    is_sharded = True
    is_external = False

    def __init__(self, data: str, label=None, weight=None,
                 missing: float = np.nan, silent: bool = True, mesh=None):
        from xgboost_tpu_torch.parallel import mesh as pmesh
        if not isinstance(data, (str, os.PathLike)):
            raise TypeError(
                "ShardedDMatrix loads from a libsvm text path; in-memory "
                "arrays are already on the host: use DMatrix")
        data = os.fspath(data)
        self.mesh = mesh or pmesh.data_parallel_mesh()
        n_global = _count_rows(data)
        self.global_num_row = n_global
        self.block_start, stop, self.block_rows = self.mesh.block(n_global)
        self.padded_global_rows = self.block_rows * self.mesh.world
        self.row_start = min(self.block_start, n_global)
        self.row_end = min(stop, n_global)
        indptr, indices, values, labels = _read_row_block(
            data, self.row_start, self.row_end)
        # the global feature count: the maximum over the ranks of the
        # local one (the reference allreduces num_feature,
        # learner-inl.hpp:136)
        local_ncol = int(indices.max()) + 1 if len(indices) else 0
        self._num_col = int(self.mesh.max(torch.tensor(
            [local_ncol], dtype=torch.int64,
            device=self.mesh._host_device()))[0])
        self._local = DMatrix((indptr, indices, values, self._num_col))
        self._cuts = {}
        self.info = MetaInfo()
        self.info.label = labels
        self._full_base_margin: Optional[np.ndarray] = None
        if label is not None:
            self.info.set_field("label", self._slice_if_global(
                np.asarray(label), "label"))
        if weight is not None:
            self.info.set_field("weight", self._slice_if_global(
                np.asarray(weight), "weight"))
        self._load_sidecars(data)
        self.feature_names = None
        if not silent:
            print(f"[shard_load] rank {self.mesh.rank}: rows "
                  f"[{self.row_start}, {self.row_end}) of {n_global}")

    # ------------------------------------------------------------- metadata
    @property
    def num_row(self) -> int:
        return self.global_num_row

    @property
    def num_col(self) -> int:
        return self._num_col

    @property
    def local_num_row(self) -> int:
        return self.row_end - self.row_start

    def get_label(self):
        """This rank's labels."""
        return None if self.info.label is None else self.info.label.copy()

    def get_weight(self):
        return np.array(self.info.get_weight(self.local_num_row))

    def _slice_if_global(self, arr: np.ndarray, what: str) -> np.ndarray:
        """A per-row vector of all rows (sliced to this block) or of this
        block's rows; any other length raises."""
        if arr.shape[0] == self.global_num_row:
            return arr[self.row_start:self.row_end]
        if arr.shape[0] == self.local_num_row:
            return arr
        raise ValueError(
            f"{what}: expected {self.global_num_row} (global) or "
            f"{self.local_num_row} (this rank's block) values, got "
            f"{arr.shape[0]}")

    def _load_sidecars(self, path: str) -> None:
        """Sidecar files hold every row's values; this block's are kept
        (the reference's ``MetaInfo::TryLoadFloatInfo``)."""
        if os.path.exists(path + ".group"):
            raise NotImplementedError(
                "ranking group files do not compose with per-rank row-block "
                "loading (a group would straddle two ranks); load this data "
                "with DMatrix (replicated) instead")
        if os.path.exists(path + ".weight"):
            full = np.loadtxt(path + ".weight", dtype=np.float32, ndmin=1)
            self.info.set_field("weight", full[self.row_start:self.row_end])
        if os.path.exists(path + ".base_margin"):
            # may hold N * K values; K is the learner's, which slices
            self._full_base_margin = np.loadtxt(
                path + ".base_margin", dtype=np.float32, ndmin=1)

    def set_label(self, label):
        self.info.set_field("label", self._slice_if_global(
            np.asarray(label), "label"))

    def set_weight(self, weight):
        self.info.set_field("weight", self._slice_if_global(
            np.asarray(weight), "weight"))

    def slice(self, rindex):
        raise NotImplementedError(
            "slice has no meaning on a ShardedDMatrix; load replicated "
            "for cv or slicing")

    # ------------------------------------------------------------ the block
    def pad_local(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """A (local_num_row, ...) array padded to the block's rows."""
        pad = self.block_rows - arr.shape[0]
        if pad == 0:
            return arr
        widths = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
        return np.pad(arr, widths, constant_values=fill)

    def local_block_of(self, x) -> np.ndarray:
        """This rank's block of a per-row tensor, on the host."""
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    def row_valid(self, device) -> torch.Tensor:
        """(block_rows,) bool: True on this block's real rows."""
        gids = self.block_start + np.arange(self.block_rows)
        return torch.from_numpy(gids < self.global_num_row).to(device)

    def device_raw(self, device):
        """The device sketch's inputs: this block's raw values (+inf =
        missing or padding) and weights (0 on padding rows)."""
        vals = self.pad_local(self._local.to_dense(missing=np.inf),
                              fill=np.inf)
        w = self.pad_local(np.asarray(self.info.get_weight(
            self.local_num_row), np.float32), fill=0.0)
        return (torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(
            device), torch.from_numpy(w).to(device))

    # ---------------------------------------------------------- collectives
    def allsum(self, vec) -> np.ndarray:
        """A small float64 host vector summed over the ranks in rank
        order (the metric ``(sum, wsum)`` allreduce)."""
        return self.mesh.allsum_host(vec)

    def allgatherv(self, mat) -> np.ndarray:
        """Every rank's float64 (k_i, C) rows concatenated in rank order
        (k_i may differ: rows pad to the largest and are trimmed); the
        exact AUC's value runs."""
        m = np.ascontiguousarray(np.asarray(mat, np.float64))
        if self.mesh.world == 1:
            return m
        dev = self.mesh._host_device()
        lens = [int(x[0]) for x in self.mesh.all_gather(torch.tensor(
            [m.shape[0]], dtype=torch.int64, device=dev))]
        kmax = max(lens)
        pad = np.zeros((kmax, m.shape[1]), np.float64)
        pad[:m.shape[0]] = m
        parts = self.mesh.all_gather(torch.from_numpy(pad).to(dev))
        return np.concatenate([p.cpu().numpy()[:k]
                               for p, k in zip(parts, lens)], axis=0)
