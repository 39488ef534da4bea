"""The device-side distributed weighted quantile sketch (port of
``xgboost_tpu/parallel/sketch_device.py``; the reference's
``SerializeReducer`` of quantile summaries,
``updater_histmaker-inl.hpp:417-424``, ``quantile.h:587-593``).

Each rank summarises every feature of its block of rows on its device,
the (F, K) summaries are gathered (``all_gather``) and folded pairwise
in rank order, and the cuts are proposed from the fold: no process
needs a full column.  A summary is four (F, K) f32 tensors (value,
rmin, rmax, wmin) sorted by value, padded with slots at ``value=+inf,
rmin=rmax=total, wmin=0`` that sit above every real value, so merges
need no masks.  Every function is batched over the leading feature axis
(the JAX package's ``jax.vmap``) and follows the JAX code op for op:
with unit weights every rank is an exact f32 integer and the cuts are
byte-equal to the JAX package's ``sketch_cuts_mesh`` at the same world
size, and equal on every rank (the fold is deterministic).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceSummary(NamedTuple):
    """Padded weighted quantile summaries, each field (F, K)."""
    value: torch.Tensor
    rmin: torch.Tensor
    rmax: torch.Tensor
    wmin: torch.Tensor


_INF = float("inf")


def _first_true(shape_lead, dev) -> torch.Tensor:
    return torch.ones(shape_lead + (1,), dtype=torch.bool, device=dev)


def _select_prune(value, rmin, rmax, wmin, last_idx, n_real, total,
                  K: int) -> DeviceSummary:
    """SetPrune (``quantile.h:189-219``, ``sketch_device.py:50-98``) on
    sorted, possibly duplicated entries (F, L): keep the extremes, pick
    the interior entries nearest evenly spaced ranks with the
    (RMinNext, RMaxPrev) straddle test, dedup, re-sort, pad to K."""
    F, L = value.shape
    dev = value.device
    begin = rmax[:, :1]
    last = torch.clamp_min(n_real - 1, 0)[:, None]              # (F, 1)
    rng = rmin.gather(1, last) - begin
    n = K - 2
    k = torch.arange(1, max(n, 1), dtype=torch.float32, device=dev)
    dx2 = 2.0 * (k[None, :] * rng / max(n, 1) + begin)          # (F, n-1)
    mid = rmin + rmax
    ii = torch.clamp(torch.searchsorted(mid.contiguous(), dx2.contiguous(),
                                        right=True) - 1, 0, L - 1)
    rmin_next = rmin + wmin
    rmax_prev = rmax - wmin
    nxt = torch.clamp_max(last_idx.gather(1, ii) + 1, L - 1)
    use_i = dx2 < rmin_next.gather(1, ii) + rmax_prev.gather(1, nxt)
    sel = torch.where(use_i, ii, nxt)
    sel = torch.cat([torch.zeros((F, 1), dtype=sel.dtype, device=dev), sel,
                     last.to(sel.dtype)], dim=1)
    sel = torch.minimum(torch.clamp_min(sel, 0), last.to(sel.dtype))
    sv, srmin = value.gather(1, sel), rmin.gather(1, sel)
    srmax, swmin = rmax.gather(1, sel), wmin.gather(1, sel)
    keep = torch.cat([_first_true((F,), dev), sv[:, 1:] != sv[:, :-1]], 1)
    keep = keep & torch.isfinite(sv) & (n_real > 0)[:, None]
    tot = total[:, None]
    sv = torch.where(keep, sv, _INF)
    srmin = torch.where(keep, srmin, tot)
    srmax = torch.where(keep, srmax, tot)
    swmin = torch.where(keep, swmin, 0.0)
    order = torch.argsort(sv, dim=1, stable=True)
    fields = [x.gather(1, order) for x in (sv, srmin, srmax, swmin)]
    pad = K - sv.shape[1]
    pads = (torch.full((F, pad), _INF, device=dev), tot.expand(F, pad),
            tot.expand(F, pad), torch.zeros((F, pad), device=dev))
    return DeviceSummary(*(torch.cat([f, p], dim=1)
                           for f, p in zip(fields, pads)))


def local_summary(values: torch.Tensor, weights: torch.Tensor,
                  K: int) -> DeviceSummary:
    """Exact summaries of this rank's rows, pruned to K slots
    (``sketch_device.py:101-135``): values (F, N) raw (non-finite =
    missing), weights (N,) (zero-weight rows are dropped)."""
    F, N = values.shape
    dev = values.device
    valid = torch.isfinite(values) & (weights > 0)[None, :]
    v = torch.where(valid, values, _INF).to(torch.float32)
    w = torch.where(valid, weights[None, :], 0.0).to(torch.float32)
    order = torch.argsort(v, dim=1, stable=True)
    vs, ws = v.gather(1, order), w.gather(1, order)
    cum = torch.cumsum(ws, dim=1)
    total = cum[:, -1]
    n_real = valid.sum(dim=1)
    i = torch.arange(N, device=dev)[None, :].expand(F, N)
    neq = vs[:, 1:] != vs[:, :-1]
    first_b = torch.cat([_first_true((F,), dev), neq], dim=1)
    last_b = torch.cat([neq, _first_true((F,), dev)], dim=1)
    first_idx = torch.cummax(torch.where(first_b, i, 0), dim=1).values
    last_idx = torch.flip(torch.cummin(torch.flip(
        torch.where(last_b, i, N - 1), [1]), dim=1).values, [1])
    cum0 = torch.cat([torch.zeros((F, 1), device=dev), cum], dim=1)
    rmin = cum0.gather(1, first_idx)
    rmax = cum.gather(1, last_idx)
    wmin = rmax - rmin
    real = i < n_real[:, None]
    tot = total[:, None]
    vs = torch.where(real, vs, _INF)
    rmin = torch.where(real, rmin, tot)
    rmax = torch.where(real, rmax, tot)
    wmin = torch.where(real, wmin, 0.0)
    return _select_prune(vs, rmin, rmax, wmin, last_idx, n_real, total, K)


def _total(s: DeviceSummary) -> torch.Tensor:
    return s.rmax[:, -1]


def merge_summaries_dev(a: DeviceSummary, b: DeviceSummary,
                        K: int) -> DeviceSummary:
    """Associative merge, pruned back to K (SetCombine,
    ``quantile.h:225-278``, ``sketch_device.py:143-191``)."""
    F = a.value.shape[0]
    dev = a.value.device

    def contrib(x: DeviceSummary, other: DeviceSummary):
        L = other.value.shape[1]
        ov = other.value.contiguous()
        xv = x.value.contiguous()
        lo = torch.searchsorted(ov, xv)
        hi = torch.searchsorted(ov, xv, right=True)
        exact = hi > lo
        tot = _total(other)[:, None]
        rmin_next = torch.cat([torch.zeros((F, 1), device=dev),
                               other.rmin + other.wmin], dim=1)
        rmax_prev = torch.cat([other.rmax - other.wmin, tot], dim=1)
        loc = torch.clamp_max(lo, L - 1)
        add_rmin = torch.where(exact, other.rmin.gather(1, loc),
                               rmin_next.gather(1, lo))
        add_rmax = torch.where(exact, other.rmax.gather(1, loc),
                               rmax_prev.gather(1, hi))
        add_wmin = torch.where(exact, other.wmin.gather(1, loc), 0.0)
        return add_rmin, add_rmax, add_wmin

    ar, ax, aw = contrib(a, b)
    br, bx, bw = contrib(b, a)
    allv = torch.cat([a.value, b.value], dim=1)
    fields = [allv, torch.cat([a.rmin + ar, b.rmin + br], dim=1),
              torch.cat([a.rmax + ax, b.rmax + bx], dim=1),
              torch.cat([a.wmin + aw, b.wmin + bw], dim=1)]
    order = torch.argsort(allv, dim=1, stable=True)
    allv, allrmin, allrmax, allwmin = (f.gather(1, order) for f in fields)
    total = _total(a) + _total(b)
    keep = torch.cat([_first_true((F,), dev), allv[:, 1:] != allv[:, :-1]],
                     dim=1) & torch.isfinite(allv)
    tot = total[:, None]
    allv = torch.where(keep, allv, _INF)
    allrmin = torch.where(keep, allrmin, tot)
    allrmax = torch.where(keep, allrmax, tot)
    allwmin = torch.where(keep, allwmin, 0.0)
    order = torch.argsort(allv, dim=1, stable=True)
    allv, allrmin, allrmax, allwmin = (
        f.gather(1, order) for f in (allv, allrmin, allrmax, allwmin))
    n_real = torch.isfinite(allv).sum(dim=1)
    L = allv.shape[1]
    last_idx = torch.arange(L, device=dev)[None, :].expand(F, L)
    return _select_prune(allv, allrmin, allrmax, allwmin, last_idx,
                         n_real, total, K)


def propose_cuts_dev(s: DeviceSummary, max_bin: int) -> torch.Tensor:
    """Up to ``max_bin - 1`` strictly increasing cuts a feature, +inf
    padded (F, max_bin - 1) (``sketch_device.py:194-223``): every
    distinct value when there are few enough, else the values nearest
    evenly spaced ranks."""
    F, K = s.value.shape
    dev = s.value.device
    n_cut = max_bin - 1
    n_real = torch.isfinite(s.value).sum(dim=1)
    total = _total(s)
    ranks = torch.arange(1, n_cut + 1, dtype=torch.float32,
                         device=dev)[None, :] * (total / (n_cut + 1))[:, None]
    mid = (s.rmin + s.rmax) * 0.5
    idx = torch.searchsorted(mid.contiguous(), ranks.contiguous())
    idx = torch.minimum(torch.clamp_min(idx, 1),
                        torch.clamp_min(n_real - 1, 1)[:, None])
    qv = s.value.gather(1, idx)
    keep = torch.cat([_first_true((F,), dev), qv[:, 1:] != qv[:, :-1]], 1)
    qv = torch.sort(torch.where(keep & torch.isfinite(qv), qv, _INF),
                    dim=1).values
    use_dense = (n_real <= n_cut)[:, None]
    out_len = max(n_cut, K)
    dense_p = torch.full((F, out_len), _INF, device=dev)
    dense_p[:, :K] = s.value
    quant_p = torch.full((F, out_len), _INF, device=dev)
    quant_p[:, :n_cut] = qv
    return torch.where(use_dense, dense_p, quant_p)[:, :n_cut]


def sketch_size(max_bin: int, sketch_eps: float, sketch_ratio: float) -> int:
    return max(8, int(sketch_ratio / max(sketch_eps, 1.0 / max_bin)))


def fold_summaries(parts, K: int) -> DeviceSummary:
    """The pairwise tree fold of summaries in rank order
    (``sketch_device.py:206-219``): O(log W) dependent merge stages."""
    parts = list(parts)
    while len(parts) > 1:
        nxt = [merge_summaries_dev(parts[i], parts[i + 1], K)
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def sketch_cuts_global(mesh, values: torch.Tensor, weights: torch.Tensor,
                       max_bin: int = 256, sketch_eps: float = 0.03,
                       sketch_ratio: float = 2.0):
    """Cuts from every rank's block of rows (``sketch_device.py:230-263``):
    values (m, F) f32 on the rank's device, +inf = missing or padding;
    weights (m,) f32, 0 on padding rows.  Local summaries, one
    ``all_gather`` of the (4, F, K) stack, the pairwise fold in rank
    order, the proposal; returns a host CutMatrix, the same on every
    rank."""
    from xgboost_tpu_torch.binning import pack_cuts
    K = sketch_size(max_bin, sketch_eps, sketch_ratio)
    summ = local_summary(values.T.contiguous(), weights, K)
    stacked = torch.stack(list(summ))                          # (4, F, K)
    parts = [DeviceSummary(*p) for p in mesh.all_gather(stacked)]
    acc = fold_summaries(parts, K)
    # max_bin - 1 cuts leave room for the missing bin (binning.py:73)
    cuts = propose_cuts_dev(acc, max_bin - 1).cpu().numpy()
    return pack_cuts([c[np.isfinite(c)].astype(np.float32) for c in cuts])


def sketch_cuts_mesh(mesh, values: np.ndarray, weights, max_bin: int = 256,
                     sketch_eps: float = 0.03, sketch_ratio: float = 2.0):
    """The ``dsplit=row`` cut proposal from the full host matrix every
    rank holds (``sketch_device.py:266-302``): missing values become
    +inf, the rows pad to the world with +inf values and zero weights,
    and this rank sketches its block (:func:`sketch_cuts_global`)."""
    N, F = values.shape
    start, stop, m = mesh.block(N)
    blk = np.full((m, F), np.inf, np.float32)
    real = max(0, min(stop, N) - start)
    blk[:real] = values[start:start + real]
    blk[np.isnan(blk)] = np.inf
    w = np.zeros(m, np.float32)
    w[:real] = 1.0 if weights is None else np.asarray(
        weights, np.float32)[start:start + real]
    dev = mesh.device
    return sketch_cuts_global(mesh, torch.from_numpy(blk).to(dev),
                              torch.from_numpy(w).to(dev), max_bin,
                              sketch_eps, sketch_ratio)
