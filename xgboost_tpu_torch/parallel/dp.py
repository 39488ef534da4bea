"""Row-split data-parallel tree growth (port of
``xgboost_tpu/parallel/dp.py``; the reference's ``dsplit=row`` with
``histred.Allreduce``, ``updater_histmaker-inl.hpp:343-346``, and the
node-stat allreduce of ``updater_basemaker-inl.hpp:266-306``).

Each rank holds one block of rows (:meth:`DataMesh.block`) and grows
the round's trees on it; every level histogram (K1, K3) and node-stat
tensor (K2) is reduced over the ranks at the ``hist_reduce`` seam of
:func:`~xgboost_tpu_torch.models.tree.grow_trees`.  Every rank must end
a level with bitwise the same tensor, since each takes the split
decisions on its own (the JAX package gets them replicated for free):
integer sums ("fixed", int8) are ``all_reduce(SUM)``, exact in any
order; float sums are gathered and added in rank order
(:meth:`DataMesh.sum`).  The trees are then the same on every rank
and need no broadcast (the reference's TreeSyncher is free).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from xgboost_tpu_torch.parallel.mesh import DataMesh


class HistReduce:
    """The collective seam of tree growth: called with a tensor of this
    rank's partial sums, returns their sum over the ranks (bitwise the
    same on every rank); :meth:`max` gives the int8 scales' maxima."""

    def __init__(self, mesh: DataMesh):
        self.mesh = mesh
        self.world = mesh.world

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.sum(t)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.max(t)


def hist_reduce(mesh: Optional[DataMesh]) -> Optional[HistReduce]:
    """The seam for ``mesh``: None (no collective) in a world of one, so
    a world of one runs the single-device code as it is."""
    if mesh is None or mesh.world == 1:
        return None
    return HistReduce(mesh)


def grow_tree_dp(mesh: DataMesh, binned: torch.Tensor, gh: torch.Tensor,
                 cut_values: torch.Tensor, n_cuts: torch.Tensor, cfg,
                 row_valid: Optional[torch.Tensor] = None, key=None,
                 split_finder=None, root: Optional[torch.Tensor] = None):
    """Grow one tree on this rank's block of rows (``dp.py:32-62``):
    binned (m, F), gh (m, 2), row_valid (m,) False on padding rows.
    Returns (tree, the block's row_leaf (m,), row_val (m,)); the tree is
    the same on every rank."""
    from xgboost_tpu_torch.models.tree import grow_tree
    return grow_tree(binned, gh, cut_values, n_cuts, cfg, row_valid, key,
                     root, split_finder, hist_reduce(mesh))


def pad_rows(n: int, multiple: int) -> int:
    """Rows to add so ``n`` divides evenly across the ranks."""
    return (-n) % multiple


def shard_rows(mesh: DataMesh, arr, fill=0):
    """This rank's block of a per-row array (numpy or tensor), the rows
    padded with ``fill`` to a multiple of the world first."""
    n = arr.shape[0]
    start, stop, m = mesh.block(n)
    if isinstance(arr, torch.Tensor):
        if stop > n:
            pad = torch.full((stop - n,) + tuple(arr.shape[1:]), fill,
                             dtype=arr.dtype, device=arr.device)
            return torch.cat([arr[start:n], pad]) if start < n else pad[
                :m]
        return arr[start:stop]
    arr = np.asarray(arr)
    if stop > n:
        widths = ((0, stop - max(start, n)),) + ((0, 0),) * (arr.ndim - 1)
        return np.pad(arr[min(start, n):n], widths, constant_values=fill)
    return arr[start:stop]
