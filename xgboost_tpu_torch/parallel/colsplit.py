"""Column-split distributed tree growth, ``dsplit=col`` (port of
``xgboost_tpu/parallel/colsplit.py``; the reference's DistColMaker,
``src/tree/updater_distcol-inl.hpp``).

Every rank holds ALL rows and one block of the features: the F features
are padded to a multiple of the world W, and rank r holds features
``[r * F_pad / W, (r + 1) * F_pad / W)``.  Padding features have no cut
(``n_cuts == 0``) or, in exact mode, all-NaN columns, so none can win a
split.  The growth loops are the single-device ones
(:func:`~xgboost_tpu_torch.models.tree.grow_tree`,
:func:`~xgboost_tpu_torch.models.colmaker.grow_tree_exact`); this module
fills their seams with the collectives of a :class:`ColSplit`:

- the split finder: each rank's best split of each node over its own
  features, with global feature ids, then an ``all_gather`` of every
  rank's best and an argmax whose ties go to the lowest rank, which is
  the lowest feature id (the reference's ``SplitEntry`` allreduce,
  ``distcol-inl.hpp:136-153``);
- the router: the rank that holds a node's split feature decides its
  rows, and the go-left bits, packed eight rows a byte, are summed over
  the ranks (the reference's bitmap allreduce, ``:115-117``);
- the feature sampler: the masks are drawn over the global feature ids
  with the shared key and each rank keeps its block
  (``basemaker-inl.hpp:79-88``);
- the level totals: a histogram level's node totals are rank 0's, the
  bin sums of global feature 0, which is what a single device takes.

Every rank ends each level with the same decisions, so the trees are
the same on every rank without a broadcast.  The same router makes
prediction on a rank's block of a matrix's features collective
(:meth:`ColSplit.bin_router`, :meth:`ColSplit.raw_router`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from xgboost_tpu_torch.models.colmaker import grow_tree_exact
from xgboost_tpu_torch.models.tree import (bin_router, grow_tree,
                                           sample_features)
from xgboost_tpu_torch.ops.split import (NEG, RT_EPS, BestSplit,
                                         find_best_splits_native)
from xgboost_tpu_torch.parallel.mesh import DataMesh, data_parallel_mesh


def feature_parallel_mesh(device=None) -> DataMesh:
    """The world of column split (``colsplit.py:43-50``): the installed
    or initialised ``torch.distributed`` world, else a world of one."""
    return data_parallel_mesh(device)


def pad_features(arr: np.ndarray, multiple: int, axis: int,
                 fill=0) -> np.ndarray:
    """``arr`` with its feature axis padded to a multiple of ``multiple``
    (``colsplit.py:306-314``)."""
    pad = (-arr.shape[axis]) % multiple
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


class ColSplit:
    """This rank's block of ``n_feature`` features in ``mesh``, and the
    collectives of column-split growth and prediction."""

    def __init__(self, mesh: DataMesh, n_feature: int):
        self.mesh = mesh
        self.world, self.rank = mesh.world, mesh.rank
        self.f_real = int(n_feature)
        self.f_pad = self.f_real + (-self.f_real) % self.world
        self.f_local = self.f_pad // self.world
        self.lo = self.rank * self.f_local
        self.hi = self.lo + self.f_local

    def block(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """This rank's columns of a host (N, F) matrix, padded first."""
        return np.ascontiguousarray(pad_features(
            np.asarray(arr), self.world, 1, fill)[:, self.lo:self.hi])

    # ------------------------------------------------------- collectives
    def any_rank(self, bits: torch.Tensor) -> torch.Tensor:
        """A boolean tensor's OR over the ranks, where at most one rank
        sets each element: packed eight to a byte and summed, which adds
        disjoint bits."""
        if self.world == 1:
            return bits
        flat = bits.reshape(-1).to(torch.uint8)
        n = flat.numel()
        flat = torch.nn.functional.pad(flat, (0, (-n) % 8)).reshape(-1, 8)
        shift = torch.arange(8, dtype=torch.uint8, device=bits.device)
        packed = (flat << shift).sum(dim=1, dtype=torch.uint8)
        packed = self.mesh.sum(packed)
        out = (packed[:, None] >> shift) & 1
        return out.reshape(-1)[:n].reshape(bits.shape).to(torch.bool)

    def level_totals(self, nst: torch.Tensor) -> torch.Tensor:
        """Rank 0's node totals of a histogram level on every rank."""
        return self.mesh.broadcast(nst, 0)

    def merge(self, local: BestSplit, thr: Optional[torch.Tensor] = None):
        """Every rank's best split of each node (local feature ids) to
        the best of all ranks (``colsplit.py:120-147``, ``:257-284``): an
        invalid split competes at NEG, the first maximum wins.  Returns
        the BestSplit with global feature ids, and the winners' ``thr``
        when given."""
        M = local.gain.shape[0]
        zero = torch.zeros(M, dtype=torch.float32, device=local.gain.device)
        cols = [torch.where(local.valid, local.gain, NEG),
                (local.feature + self.lo).to(torch.int32).view(
                    torch.float32),
                local.cut_index.to(torch.int32).view(torch.float32),
                local.default_left.to(torch.float32),
                zero if local.left_g is None else local.left_g,
                zero if local.left_h is None else local.left_h]
        if thr is not None:
            cols.append(thr)
        parts = torch.stack(self.mesh.all_gather(torch.stack(cols)))
        win = torch.argmax(parts[:, 0], dim=0)           # (M,): first max
        pick = parts.gather(0, win[None, None, :].expand(
            1, len(cols), M))[0].contiguous()
        gain = pick[0]
        best = BestSplit(gain, pick[1].contiguous().view(torch.int32),
                         pick[2].contiguous().view(torch.int32),
                         pick[3] != 0, gain > RT_EPS,
                         None if local.left_g is None else pick[4],
                         None if local.left_h is None else pick[5])
        return best, (pick[6] if thr is not None else None)

    # ------------------------------------------------------------ seams
    def split_finder(self, hist, nst, n_cuts, cfg, fmask=None) -> BestSplit:
        """The histogram finder on this rank's features, merged; ``n_cuts``
        holds every (padded) feature's count."""
        local = find_best_splits_native(hist, nst, n_cuts[self.lo:self.hi],
                                        cfg, fmask)
        return self.merge(local)[0]

    def feat_sampler(self, keys, rate: float) -> np.ndarray:
        """The masks over the real features, padded with False, this
        rank's block (``colsplit.py:165-178``)."""
        real = sample_features(keys, self.f_real, rate)
        full = np.zeros(real.shape[:-1] + (self.f_pad,), np.bool_)
        full[..., :self.f_real] = real
        return np.ascontiguousarray(full[..., self.lo:self.hi])

    def _own(self, f_row: torch.Tensor):
        """Whether this rank holds each row's feature, and its local id."""
        own = (f_row >= self.lo) & (f_row < self.hi)
        return own, torch.clamp(f_row - self.lo, 0, self.f_local - 1)

    def bin_router(self, f_row, j_row, dl_row, binned) -> torch.Tensor:
        """Go-left per row on a block of bins (``colsplit.py:149-163``)."""
        own, lf = self._own(f_row)
        return self.any_rank(bin_router(lf, j_row, dl_row, binned) & own)

    def raw_router(self, f_row, thr_row, dl_row, X) -> torch.Tensor:
        """Go-left per row on a block of raw values
        (``colsplit.py:286-305``): a missing value takes the default
        direction, a value compares as ``nan_to_num`` makes it."""
        own, lf = self._own(f_row)
        lf = lf.to(torch.int64)
        go = torch.where(_take(torch.isnan(X), lf), dl_row,
                         _take(torch.nan_to_num(X), lf) < thr_row)
        return self.any_rank(go & own)


def _take(X: torch.Tensor, f_row: torch.Tensor) -> torch.Tensor:
    """``X[r, f_row[..., r]]`` for (N,) or (T, N) ``f_row``."""
    N = X.shape[0]
    cols = f_row.reshape(-1, N).T                          # (N, T)
    return X.gather(1, cols).T.reshape(f_row.shape)


def grow_tree_colsplit(col: ColSplit, binned: torch.Tensor,
                       gh: torch.Tensor, cut_values: torch.Tensor,
                       n_cuts: torch.Tensor, cfg,
                       row_valid: Optional[torch.Tensor] = None, key=None,
                       root: Optional[torch.Tensor] = None):
    """Grow one tree on this rank's (N, F_pad / W) block of bins
    (``colsplit.py:52-118``): K1 on the block with the gradients of every
    row (N, 2), the merged finder, the owner's routing.  ``cut_values``
    (F_pad, C) and ``n_cuts`` (F_pad,) hold every feature's (padding:
    +inf, 0).  Returns (tree, row_leaf (N,), row_val (N,)), the same on
    every rank."""
    return grow_tree(binned, gh, cut_values, n_cuts, cfg, row_valid, key,
                     root, col.split_finder, router=col.bin_router,
                     feat_sampler=col.feat_sampler,
                     level_totals=col.level_totals)


def grow_tree_exact_colsplit(col: ColSplit, X: torch.Tensor,
                             gh: torch.Tensor, cfg,
                             row_valid: Optional[torch.Tensor] = None,
                             has_missing: bool = True, rank_t=None,
                             uniq=None, key=None):
    """Exact greedy growth on this rank's (N, F_pad / W) block of raw
    values (``colsplit.py:180-305``): the exact finder on the block (K2
    at every level on all rows), the merged winners, the owner's
    raw-value routing.  ``rank_t`` / ``uniq`` are the block's
    (:func:`~xgboost_tpu_torch.models.colmaker.build_exact_ranks`).
    Returns (tree, row_leaf (N,)), the same on every rank."""
    return grow_tree_exact(X, gh, cfg, row_valid, has_missing, rank_t, uniq,
                           key, split_merge=col.merge, router=col.raw_router,
                           feat_sampler=col.feat_sampler)
