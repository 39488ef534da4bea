"""SketchMaker: split finding from per-node quantile summaries (port of
``xgboost_tpu/models/skmaker.py``; the reference's ``grow_skmaker``).

Each (node, feature) column of a level histogram is compressed into three
summaries of K entries: the positive-gradient, negative-gradient and
hessian mass by bin (:func:`_compress_row`), and the split is chosen by
rank queries at the hessian summary's support values (:func:`_rank_at`):

    GL(v) = rank_pos(<= v) - rank_neg(<= v)      HL(v) = rank_hess(<= v)

The finder reads the grower's native ``(F, B, 2, T * n_node)`` histogram
and its cut counts, as :func:`~xgboost_tpu_torch.ops.split.
find_best_splits_native` does, and leaves no left sums behind, so the
grower's terminal level takes its node sums from K2.  Every step is a
batched torch op over (node, feature), on the histogram's device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from xgboost_tpu_torch.ops.split import (NEG, RT_EPS, BestSplit,
                                         SplitConfig, calc_gain, prefix_sum)


def _compress_row(mass: torch.Tensor, K: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin nonnegative masses (..., B) -> K-entry summaries
    (``skmaker.py:38-72``): the bins are the values, the ranks the
    cumulative mass at each bin, pruned to K entries by even-rank
    selection with both extremes kept.  Returns (values (..., K) f32,
    rank_next (..., K), total (...)); padding entries hold value B and
    rank total.  The cumulative mass is summed in the JAX package's CPU
    order (:func:`~xgboost_tpu_torch.ops.split.prefix_sum`)."""
    B = mass.shape[-1]
    dev = mass.device
    cum = prefix_sum(mass, -1)
    total = cum[..., -1]
    present = mass > 0
    n_real = present.sum(dim=-1)                            # (...,)
    # present bins first, each group in bin order
    order = torch.sort((~present).to(torch.int8), dim=-1, stable=True
                       ).indices
    vals = order.to(torch.float32)
    ranks = cum.gather(-1, order)
    k = torch.arange(1, max(K - 1, 1), dtype=torch.float32, device=dev)
    target = k * (total / max(K - 1, 1))[..., None]         # (..., K - 2)
    mid = ranks - mass.gather(-1, order) * 0.5
    mid = torch.where(torch.arange(B, device=dev) < n_real[..., None], mid,
                      float("inf"))
    last = torch.clamp_min(n_real - 1, 0)[..., None]
    sel = torch.searchsorted(mid.contiguous(), target.contiguous(),
                             side="left")
    sel = torch.minimum(torch.clamp_min(sel, 0), last)
    sel = torch.cat([torch.zeros_like(last), sel, last], dim=-1)
    sv, sr = vals.gather(-1, sel), ranks.gather(-1, sel)
    keep = torch.cat([torch.ones_like(sv[..., :1], dtype=torch.bool),
                      sv[..., 1:] != sv[..., :-1]], dim=-1)
    keep &= (n_real > 0)[..., None]
    sv = torch.where(keep, sv, float(B))
    sr = torch.where(keep, sr, total[..., None])
    order2 = torch.sort(sv, dim=-1, stable=True).indices
    return sv.gather(-1, order2), sr.gather(-1, order2), total


def _rank_at(values: torch.Tensor, rank_next: torch.Tensor,
             q: torch.Tensor) -> torch.Tensor:
    """Mass <= q from summaries (``skmaker.py:75-80``): the rank of the
    last retained entry at or below q, 0 below the first.  ``values`` /
    ``rank_next`` (..., K), ``q`` (..., Q) -> (..., Q)."""
    idx = torch.searchsorted(values.contiguous(), q.contiguous(),
                             side="right") - 1
    safe = torch.clamp(idx, 0, values.shape[-1] - 1)
    return torch.where(idx < 0, 0.0, rank_next.gather(-1, safe))


@functools.lru_cache(maxsize=None)
def skmaker_split_finder(K: int):
    """The skmaker split finder of summary size K (``skmaker.py:83-174``;
    the reference's ``max_sketch_size = sketch_ratio / sketch_eps``),
    memoized so equal K is one function: lanes stack only boosters whose
    finders are the same object.

    ``finder(hist, nst, n_cuts, split_cfg, fmask)`` takes what
    :func:`~xgboost_tpu_torch.ops.split.find_best_splits_native` takes
    (``n_cuts`` and ``fmask`` (F,) or one per column (F, n_col)) and
    returns a BestSplit without left sums."""

    def finder(hist: torch.Tensor, nst: torch.Tensor, n_cuts: torch.Tensor,
               split_cfg: SplitConfig,
               fmask: Optional[torch.Tensor] = None) -> BestSplit:
        F, B, _, M = hist.shape
        dev = hist.device
        g = hist[:, :, 0, :].permute(2, 0, 1)              # (M, F, B)
        h = hist[:, :, 1, :].permute(2, 0, 1)
        pv, pr, _ = _compress_row(torch.clamp_min(g, 0.0), K)
        nv, nr, _ = _compress_row(torch.clamp_min(-g, 0.0), K)
        hv, hr, _ = _compress_row(h, K)                    # (M, F, K)

        # candidates: the hessian summary's support values (bin ids),
        # floored at bin 1 so the missing bin 0 is never a boundary
        cand = torch.clamp(hv, 1.0, float(B))
        zero = torch.zeros(hv.shape[:-1] + (1,), dtype=torch.float32,
                           device=dev)

        def left_mass(vals, ranks):
            # mass <= c without the missing bin's
            return _rank_at(vals, ranks, cand) - _rank_at(vals, ranks, zero)

        GL_excl = left_mass(pv, pr) - left_mass(nv, nr)    # (M, F, K)
        HL_excl = left_mass(hv, hr)
        G, H = nst[:, 0], nst[:, 1]
        g0 = _rank_at(pv, pr, zero) - _rank_at(nv, nr, zero)   # (M, F, 1)
        h0 = _rank_at(hv, hr, zero)

        # direction 0: missing right; 1: missing left
        GLs = torch.stack([GL_excl, GL_excl + g0], dim=-1)  # (M, F, K, 2)
        HLs = torch.stack([HL_excl, HL_excl + h0], dim=-1)
        GRs = G[:, None, None, None] - GLs
        HRs = H[:, None, None, None] - HLs
        root_gain = calc_gain(G, H, split_cfg)
        loss_chg = (calc_gain(GLs, HLs, split_cfg)
                    + calc_gain(GRs, HRs, split_cfg)
                    - root_gain[:, None, None, None])
        ok = ((HLs >= split_cfg.min_child_weight)
              & (HRs >= split_cfg.min_child_weight))
        # candidate bin b splits {<= b | > b}: a real boundary needs
        # b <= n_cuts[f]
        nc = n_cuts[None, :] if n_cuts.dim() == 1 else n_cuts.T
        ok &= (cand <= nc[..., None].to(torch.float32))[..., None]
        if fmask is not None:
            fm = fmask[None, :] if fmask.dim() == 1 else fmask.T
            ok &= fm[..., None, None]
        if split_cfg.default_direction in (1, 2):  # forced left / right
            dirs = torch.tensor([split_cfg.default_direction == 2,
                                 split_cfg.default_direction == 1],
                                device=dev)
            ok &= dirs
        loss_chg = torch.where(ok, loss_chg, NEG)

        Kc = cand.shape[-1]
        flat = loss_chg.reshape(M, F * Kc * 2)
        best = torch.argmax(flat, dim=1)                   # first maximum
        best_gain = flat.gather(1, best[:, None])[:, 0]
        feature = torch.div(best, Kc * 2, rounding_mode="floor")
        kidx = torch.div(best, 2, rounding_mode="floor") % Kc
        default_left = (best % 2).to(torch.bool)
        bsel = cand.reshape(M, F * Kc).gather(
            1, (feature * Kc + kidx)[:, None])[:, 0].to(torch.int32)
        cut_index = torch.clamp_min(bsel - 1, 0)   # left iff bin <= b
        return BestSplit(best_gain, feature.to(torch.int32), cut_index,
                         default_left, best_gain > RT_EPS, None, None)

    return finder


def sketch_size(sketch_ratio: float, sketch_eps: float, n_bin: int) -> int:
    """K of ``gbtree.py:408-422``: ``sketch_ratio / sketch_eps``, at
    least 4 and at most the bin count."""
    return min(max(4, int(sketch_ratio / max(sketch_eps, 1e-6))), n_bin)
