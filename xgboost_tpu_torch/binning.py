"""Quantize a DMatrix into dense bin ids (port of ``xgboost_tpu/binning.py``).

Bin 0 is reserved for MISSING.  A present value v maps to bin
``1 + searchsorted(cuts_f, v, 'right')``; a split at cut index j sends a
row left iff ``v < cuts_f[j]``, i.e. ``bin(v) <= j + 1``.  The host side
is numpy, kept line for line with the JAX package so both propose the
same cuts and bins; :func:`bin_dense_device` is the device-side
quantizer, in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from xgboost_tpu_torch.data import DMatrix, stored_mask
from xgboost_tpu_torch.sketch import (make_summary, prune_summary,
                                      propose_cuts, sketch_column)

# auto bin alignment trims at most this many cuts (align_cut_lists)
DEFAULT_TRIM_MARGIN = 4


@dataclasses.dataclass
class CutMatrix:
    """Per-feature cut points, +inf padded to a rectangle."""

    cut_values: np.ndarray  # (F, max_cuts) float32
    n_cuts: np.ndarray      # (F,) int32

    @property
    def num_feature(self) -> int:
        return self.cut_values.shape[0]

    @property
    def max_bin(self) -> int:
        # value bins 1..max_cuts+1 plus missing bin 0
        return self.cut_values.shape[1] + 2


def compute_cuts(dmat: DMatrix, max_bin: int = 256, sketch_eps: float = 0.03,
                 sketch_ratio: float = 2.0,
                 hess_weights: Optional[np.ndarray] = None,
                 bin_align: int = 0,
                 bin_align_margin: Optional[int] = DEFAULT_TRIM_MARGIN
                 ) -> CutMatrix:
    """Cut points for every feature from the weighted quantile sketch;
    ``bin_align`` aligns the bin count (see :func:`align_cut_lists`)."""
    per_feature = []
    for f in range(dmat.num_col):
        rows, vals = dmat.column_values(f)
        w = None if hess_weights is None else hess_weights[rows]
        if len(vals) > (1 << 16):
            summary = sketch_column(vals, w, sketch_eps, sketch_ratio)
        else:
            summary = prune_summary(
                make_summary(vals, w),
                max(2, int(sketch_ratio / max(sketch_eps, 1.0 / max_bin))))
        per_feature.append(propose_cuts(summary, max_bin - 1))
    return pack_cuts(align_cut_lists(per_feature, bin_align,
                                     bin_align_margin))


def align_cut_lists(per_feature, quantum: int = 32,
                    trim_margin: Optional[int] = DEFAULT_TRIM_MARGIN):
    """Trim the densest features' cut lists so the bin count
    ``max_cuts + 2`` lands on a multiple of ``quantum`` (trimmed
    features keep evenly rank-spaced cuts).  No-op when quantum is 0,
    when already aligned, when more than ``trim_margin`` cuts would go,
    or when fewer than 8 cuts would remain."""
    if quantum <= 0 or not per_feature:
        return per_feature
    B = max((len(c) for c in per_feature), default=1) + 2
    excess = B % quantum
    if excess == 0:
        return per_feature
    if trim_margin is not None and excess > trim_margin:
        return per_feature
    target = (B // quantum) * quantum - 2
    if target < 8:
        return per_feature
    out = []
    for cuts in per_feature:
        if len(cuts) > target:
            idx = np.unique(np.round(
                np.linspace(0, len(cuts) - 1, target)).astype(np.int64))
            cuts = np.asarray(cuts)[idx]
        out.append(cuts)
    return out


def pack_cuts(per_feature) -> CutMatrix:
    """Per-feature cut lists as an inf-padded rectangular CutMatrix."""
    F = len(per_feature)
    max_cuts = max(1, max((len(c) for c in per_feature), default=1))
    cut_values = np.full((F, max_cuts), np.inf, dtype=np.float32)
    n_cuts = np.zeros(F, dtype=np.int32)
    for f, cuts in enumerate(per_feature):
        cut_values[f, :len(cuts)] = cuts
        n_cuts[f] = len(cuts)
    return CutMatrix(cut_values, n_cuts)


def compute_cuts_exact(dmat: DMatrix, max_exact_bin: int = 4096
                       ) -> CutMatrix:
    """Cuts at every distinct value of each feature, the minimum
    included (``binning.py:162-200``): the quantized form of exact greedy
    growth that ``updater=grow_colmaker`` trains under ``dsplit=row``.  A
    split before each distinct value enumerates the reference's sorted
    scan's partitions (only the recorded threshold differs); a cut at
    the minimum, with the learned default direction, is the
    missing-against-present split.  A feature with more than
    ``max_exact_bin`` distinct values gets that many quantile cuts, with
    a note on stderr from rank 0."""
    import sys
    per_feature = []
    n_capped = 0
    for f in range(dmat.num_col):
        _, vals = dmat.column_values(f)
        uniq = np.unique(vals)
        if len(uniq) > max_exact_bin:
            n_capped += 1
            cuts = propose_cuts(
                prune_summary(make_summary(vals), 2 * max_exact_bin),
                max_exact_bin)
        else:
            cuts = uniq.astype(np.float32)
        per_feature.append(cuts)
    if n_capped and _rank0():
        print(f"[grow_colmaker] {n_capped}/{dmat.num_col} features exceed "
              f"max_exact_bin={max_exact_bin} distinct values and were "
              "quantized to that many cuts: dsplit=row exact mode is "
              "approximate past the cap (single-device training uses the "
              "uncapped exact grower; the reference itself runs histmaker, "
              "not exact, under row split)", file=sys.stderr)
    return pack_cuts(per_feature)


def _rank0() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def bin_matrix(dmat: DMatrix, cuts: CutMatrix) -> np.ndarray:
    """Dense (n_rows, F) bin ids (0 = missing): u8, or u16 past 256 bins.
    Absent entries and stored NaNs are missing."""
    src = dmat.dense_source()
    if src is not None:
        arr, missing = src
        return bin_dense(arr, cuts,
                         stored_mask(arr, missing) & ~np.isnan(arr))
    n, F = dmat.num_row, cuts.num_feature
    dtype = np.uint8 if cuts.max_bin <= 256 else np.uint16
    out = np.zeros((n, F), dtype=dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(dmat.indptr))
    cols = dmat.indices
    in_range = (cols < F) & ~np.isnan(dmat.values)
    rows, cols, vals = rows[in_range], cols[in_range], dmat.values[in_range]
    for f in range(F):
        m = cols == f
        if not m.any():
            continue
        b = 1 + np.searchsorted(cuts.cut_values[f, :cuts.n_cuts[f]],
                                vals[m], side="right")
        out[rows[m], f] = b.astype(dtype)
    return out


def bin_dense(X: np.ndarray, cuts: CutMatrix,
              present: Optional[np.ndarray] = None) -> np.ndarray:
    """Quantize a dense float matrix; ``present`` defaults to not-NaN."""
    n, F = X.shape
    dtype = np.uint8 if cuts.max_bin <= 256 else np.uint16
    out = np.zeros((n, cuts.num_feature), dtype=dtype)
    for f in range(min(F, cuts.num_feature)):
        col = X[:, f]
        p = ~np.isnan(col) if present is None else present[:, f]
        b = 1 + np.searchsorted(cuts.cut_values[f, :cuts.n_cuts[f]],
                                col[p], side="right")
        out[p, f] = b.astype(dtype)
    return out


def bin_dense_device(X, cut_values, block_rows: int = 1 << 16):
    """Device quantization of a dense (N, F) float tensor (NaN = missing
    -> bin 0): ``1 + #{finite c: x >= c}``, identical to the host
    ``searchsorted(side="right")`` (``xgboost_tpu/binning.py:227-246``).
    Returns uint8 bins (int32 past 256 bins), in row blocks of
    ``block_rows`` to bound the (rows, F, C) compare."""
    import torch
    X = torch.as_tensor(X, dtype=torch.float32)
    cv = torch.as_tensor(cut_values, dtype=torch.float32, device=X.device)
    finite = torch.isfinite(cv)
    dtype = torch.uint8 if cv.shape[1] + 2 <= 256 else torch.int32
    out = torch.empty(X.shape, dtype=dtype, device=X.device)
    for s in range(0, X.shape[0], block_rows):
        x = X[s:s + block_rows]
        b = 1 + ((x[:, :, None] >= cv[None]) & finite[None]).sum(
            dim=2, dtype=torch.int32)
        out[s:s + block_rows] = torch.where(torch.isnan(x), 0, b).to(dtype)
    return out
