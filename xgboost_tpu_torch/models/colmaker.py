"""Exact-greedy tree growth, the reference's ColMaker (port of
``xgboost_tpu/models/colmaker.py``).

Exact mode is bin-free: the training matrix, the margins and prediction
all hold raw values (NaN = missing), and a split sends a row left when
``x < threshold``, the node-local midpoint between two adjacent distinct
values (:func:`traverse_raw`).

Per level, :func:`_find_exact_splits` sorts every feature's rows by
(node, value), gradients riding along; missing and retired rows sort into
a trash segment past the last node.  A node's running (G, H) sums are
then one global prefix sum of the mean-centred gradients minus the sum
before the node's segment (:func:`_blocked_cumsum`), split candidates lie
between adjacent slots of one segment with distinct values, and with
missing values the reference's end-of-scan candidates (all present values
on one side, the missing ones on the other) compete too.  Nothing of size
(F, N, n_node) is built: per-slot values of a per-node table are a gather
from an (F, n_node + 1) table whose last column (the trash segment) is 0,
and each segment's best slot is a ``scatter_reduce`` maximum followed by
the lowest slot that reaches it, the slot ``jnp.argmax`` picks.

Node sums come from K2 (:func:`~xgboost_tpu_torch.ops.histogram.node_stats`)
at every level, D + 1 launches a tree on a GPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.models.tree import (GrowConfig, TreeArrays,
                                           apply_level, draw_masks,
                                           empty_tree, table_lookup)
from xgboost_tpu_torch.objectives import fma_f32
from xgboost_tpu_torch.ops.cpu_sort import float_sort_key, unstable_sort_order
from xgboost_tpu_torch.ops.histogram import bin_sum, node_stats
from xgboost_tpu_torch.ops.split import (NEG, RT_EPS, BestSplit, calc_gain,
                                         prefix_sum)

BLOCK = 512     # rows a block of the blocked prefix sum


def build_exact_ranks(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature dense ranks of a training matrix, on the host, once
    (``colmaker.py:55-89``): equal values share a rank, so adjacent ranks
    are adjacent distinct values and the level sort takes one packed key
    ``(node << shift) | rank``.  X (N, F) f32, NaN = missing.  Returns
    (rank_t (F, N) int32, uniq (F, N) f32 the distinct values of each
    feature in order, padded with +inf)."""
    vals = np.ascontiguousarray(X.T, dtype=np.float32)     # (F, N)
    F, N = vals.shape
    order = np.argsort(vals, axis=1, kind="stable")        # NaN last
    sv = np.take_along_axis(vals, order, axis=1)
    fin = ~np.isnan(sv)
    newd = np.empty((F, N), bool)
    newd[:, 0] = fin[:, 0]
    newd[:, 1:] = (sv[:, 1:] > sv[:, :-1]) & fin[:, 1:]
    dr = np.cumsum(newd, axis=1) - 1                       # dense rank
    np.clip(dr, 0, None, out=dr)
    rank_t = np.empty((F, N), np.int32)
    np.put_along_axis(rank_t, order, dr.astype(np.int32), axis=1)
    uniq = np.full((F, N), np.inf, np.float32)
    # NaN slots write +inf at N - 1, which no real rank reaches when a
    # NaN exists; a feature without NaN has no NaN slot
    np.put_along_axis(uniq, np.where(fin, dr, N - 1),
                      np.where(fin, sv, np.inf), axis=1)
    return rank_t, uniq


def _blocked_cumsum(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Inclusive f32 prefix sum along axis 1 of (F, N) (``colmaker.py:
    92-123``).  On the CPU every sum runs in the order of the JAX
    package's CPU run, which computes it as 512-row blocks times an
    upper-triangular matrix of ones plus the exclusive prefix of the
    block sums: the product's k axis left to right in halves of 256
    added at the end when there are 2 to 32 blocks, in one run of 512
    otherwise (one block, or more than 32), the block sums in XLA's
    reduction order (:func:`~xgboost_tpu_torch.ops.histogram.bin_sum`)
    and their prefix in its scan order
    (:func:`~xgboost_tpu_torch.ops.split.prefix_sum`).  On a GPU one
    ``torch.cumsum`` in f32, each row scanned on its own, so a feature's
    sums do not depend on the features beside it."""
    if x.device.type != "cpu":
        return torch.cumsum(x, dim=1)
    F, N = x.shape
    nb = -(-N // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - N)).reshape(
        F, nb, block)
    w = _triangular_sums_cpu(xb, block if nb == 1 or nb > 32
                             else block // 2)
    s = bin_sum(xb)
    return (w + (prefix_sum(s, 1) - s)[..., None]).reshape(
        F, nb * block)[:, :N]


def _triangular_sums_cpu(xb: torch.Tensor, kc: int) -> torch.Tensor:
    """``xb @ triu(ones)`` over the last axis as running f32 sums, left
    to right within each run of ``kc``, the runs' partial sums added in
    order."""
    B = xb.shape[-1]
    w = torch.zeros_like(xb)
    for k0 in range(0, B, kc):
        acc = torch.zeros_like(xb[..., 0])
        cols = []
        for k in range(k0, k0 + kc):
            acc = acc + xb[..., k]
            cols.append(acc)
        run = torch.stack(cols, dim=-1)
        w[..., k0:k0 + kc] = w[..., k0:k0 + kc] + run
        w[..., k0 + kc:] = w[..., k0 + kc:] + acc[..., None]
    return w


def _centred(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, 1) row means of (F, N) and the rows minus them.  On the CPU
    as the JAX package's CPU run computes them: the sum in XLA's
    reduction order times the f32 reciprocal of N, and the centred value
    one fused multiply-add ``x - sum * (1 / N)`` (XLA recomputes the
    mean inside the subtraction's fusion, where the product is not
    rounded).  On a GPU one reduction a feature: torch's order over a row
    depends on how many rows one call reduces, and a feature's sums must
    not depend on the features beside it (column split gives each rank
    some of them)."""
    N = x.shape[1]
    if x.device.type != "cpu":
        mean = torch.stack([row.mean() for row in x])[:, None]
        return mean, x - mean
    inv = np.float32(1.0 / N)
    s = bin_sum(x)[:, None]
    return s * inv, fma_f32(-s, inv, x)


def _mul_add(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c``: on the CPU one fused multiply-add, as XLA's CPU
    backend contracts it inside a fusion (so a near-tie such as a node's
    missing-left against missing-right gain falls as in the JAX
    package's CPU run); on a GPU two torch ops."""
    if a.device.type == "cpu":
        return fma_f32(a, b, c)
    return a * b + c


def _default_exact_router(f_row: torch.Tensor, thr_row: torch.Tensor,
                          dl_row: torch.Tensor, X: torch.Tensor
                          ) -> torch.Tensor:
    """Go-left per row by raw-value comparison (``colmaker.py:126-137``):
    a missing value takes the node's default direction.  ``f_row``,
    ``thr_row`` and ``dl_row`` are the split at each row's node."""
    f_row = torch.clamp_min(f_row, 0).to(torch.int64)
    x_row = X.gather(1, f_row[:, None])[:, 0]
    return torch.where(torch.isnan(x_row), dl_row, x_row < thr_row)


def grow_tree_exact(X: torch.Tensor, gh: torch.Tensor, cfg: GrowConfig,
                    row_valid: Optional[torch.Tensor] = None,
                    has_missing: bool = True,
                    rank_t: Optional[torch.Tensor] = None,
                    uniq: Optional[torch.Tensor] = None, key=None, *,
                    split_merge=None, router=None, feat_sampler=None
                    ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree by exact enumeration (``colmaker.py:142-235``).

    X (N, F) raw values on the tree's device (NaN = missing); gh (N, 2)
    f32; ``has_missing=False`` (a fact of the data, established on the
    host) drops the default-left scan and the end-of-scan candidates;
    ``rank_t`` / ``uniq`` (:func:`build_exact_ranks`, on the device)
    select the packed-key sort, else the two-key (node, value) sort;
    ``key`` the tree's host key (2,) uint32, needed when the config
    samples (the three draws of :func:`~.tree.draw_masks`).  Node sums
    come from K2 at every level.  Returns (tree (n_nodes,), row_leaf (N,)
    int32).

    The seams of column split (``colmaker.py:159-169``,
    :mod:`xgboost_tpu_torch.parallel.colsplit`): ``split_merge(best,
    thr)`` takes the level's best splits of X's features to the best of
    every rank's, with their thresholds; ``router(f_row, thr_row, dl_row,
    X)`` sends rows left (default: by X's own raw values);
    ``feat_sampler(keys, rate)`` draws X's feature masks."""
    N, F = X.shape
    D = cfg.max_depth
    dev = X.device
    if cfg.n_roots > 1:
        raise NotImplementedError(
            "num_roots > 1 is not supported by the exact grower")
    if cfg.sampled and key is None:
        raise ValueError("a sampled grow config needs the tree's key")
    xt = X.T.contiguous()                                  # (F, N)
    miss_t = torch.isnan(xt)
    if router is None:
        router = _default_exact_router
    draws = draw_masks(None if key is None else
                       np.asarray(key, np.uint32)[None], N, F, cfg, dev,
                       feat_sampler)
    gh_used = gh.to(torch.float32)
    if draws.keep is not None:
        gh_used = gh_used * draws.keep[0][:, None].to(gh_used.dtype)
    if row_valid is not None:
        gh_used = gh_used * row_valid[:, None].to(gh_used.dtype)
    gh_used = gh_used.contiguous()

    tree = empty_tree(D, 1, dev)
    pos = torch.zeros(N, dtype=torch.int32, device=dev)
    if row_valid is not None:
        pos = torch.where(row_valid, pos, -1)
    row_leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    all_f = torch.ones(F, dtype=torch.bool, device=dev)

    for depth in range(D + 1):
        n_node = 1 << depth
        base = n_node - 1
        nst = node_stats(gh_used, pos, n_node)             # (n_node, 2)
        if depth == D:
            make_leaf = torch.ones(n_node, dtype=torch.bool, device=dev)
            best = thr = None
        else:
            fmask = (draws.fmask[depth, 0] if draws.fmask is not None
                     else all_f)
            best, thr = _find_exact_splits(xt, miss_t, gh_used, pos, nst,
                                           n_node, fmask, cfg.split,
                                           has_missing, rank_t, uniq)
            if split_merge is not None:
                best, thr = split_merge(best, thr)
            can_try = nst[:, 1] >= 2.0 * cfg.split.min_child_weight
            make_leaf = ~(best.valid & can_try)
        tree = apply_level(tree, depth, nst, best, thr, make_leaf, cfg.split)

        active = pos >= 0
        node = torch.clamp(pos, 0, n_node - 1).to(torch.int64)
        row_is_leaf = active & table_lookup(make_leaf, node)
        row_leaf = torch.where(row_is_leaf, base + pos, row_leaf)
        if best is not None:
            go_left = router(table_lookup(best.feature, node),
                             table_lookup(thr, node),
                             table_lookup(best.default_left, node), X)
            new_pos = 2 * pos + (~go_left).to(torch.int32)
            pos = torch.where(active & ~row_is_leaf, new_pos, -1)
    return TreeArrays(*(x[0] for x in tree)), row_leaf


def _sort_order(key: torch.Tensor) -> torch.Tensor:
    """Each row's sorting permutation of an (F, N) int64 key: on the CPU
    the order XLA's unstable CPU sort leaves ties in (the JAX package's
    ``lax.sort(is_stable=False)``, :mod:`~xgboost_tpu_torch.ops.cpu_sort`),
    on a GPU a stable sort."""
    if key.device.type != "cpu":
        return torch.sort(key, dim=1, stable=True).indices
    k = key.numpy()
    return torch.from_numpy(np.stack([unstable_sort_order(row) for row in k]))


def _argmax_per_segment(lg: torch.Tensor, key_s: torch.Tensor,
                        M: int) -> torch.Tensor:
    """(F, M) slot of each segment's maximum of ``lg`` (F, N): the first
    slot of the row at that value, which is the segment's lowest slot
    that reaches it, as ``jnp.argmax`` over the row masked to the segment
    picks it; 0 where the segment has no value above NEG (the masked row
    is NEG everywhere)."""
    F, N = lg.shape
    dev = lg.device
    seg = key_s                                 # node, or M for trash
    top = torch.full((F, M + 1), NEG, dtype=lg.dtype, device=dev)
    top = top.scatter_reduce(1, seg, lg, "amax", include_self=True)
    slots = torch.arange(N, dtype=torch.int64, device=dev).expand(F, N)
    at_top = lg == top.gather(1, seg)
    first = torch.full((F, M + 1), N, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(1, seg, torch.where(at_top, slots, N),
                                 "amin", include_self=True)
    return torch.where(top[:, :M] > NEG, first[:, :M], 0)


def _find_exact_splits(xt, miss_t, gh_used, pos, nst, n_node: int, fmask,
                       scfg, has_missing: bool = True, rank_t=None,
                       uniq=None) -> Tuple[BestSplit, torch.Tensor]:
    """Best split of every node of a level by the segment-sorted scan
    (``colmaker.py:238-502``).  xt (F, N) raw values, miss_t (F, N)
    bool, gh_used (N, 2), pos (N,) level-local node (-1 = retired), nst
    (n_node, 2) node sums, fmask (F,) bool.  With ``rank_t`` / ``uniq``
    the sort key is ``(node << shift) | rank`` in int64, else the rows
    sort by value and then, stably, by node.  Returns (BestSplit with
    cut_index 0, its (n_node,) raw thresholds)."""
    N = gh_used.shape[0]
    F = xt.shape[0]
    M = n_node
    dev = xt.device
    G_tot, H_tot = nst[:, 0], nst[:, 1]
    root_gain = calc_gain(G_tot, H_tot, scfg)             # (M,)
    ranked = rank_t is not None

    # missing and retired rows key to the trash segment M; rows sampled
    # out keep their node with zero gradients
    keep = (pos >= 0)[None, :] & ~miss_t
    key1 = torch.where(keep, pos.to(torch.int64)[None, :], M)   # (F, N)
    shift = max(1, int(N - 1).bit_length())
    if ranked:
        packed = (key1 << shift) | rank_t.to(torch.int64)
        order = _sort_order(packed)
        key_ps = packed.gather(1, order)
        key_s = key_ps >> shift
        rank_s = key_ps & ((1 << shift) - 1)
        vs = None
    elif dev.type == "cpu":
        # (node, value) as one int64 key, values compared as lax.sort does
        vkey = torch.from_numpy(float_sort_key(xt.numpy()) + 2 ** 31)
        order = _sort_order((key1 << 32) | vkey)
        key_s = key1.gather(1, order)
        vs = xt.gather(1, order)
    else:
        by_v = torch.sort(xt, dim=1, stable=True).indices
        key_s, o2 = torch.sort(key1.gather(1, by_v), dim=1, stable=True)
        order = by_v.gather(1, o2)
        vs = xt.gather(1, order)
    g_s = gh_used[:, 0][order]                              # (F, N)
    h_s = gh_used[:, 1][order]

    # segment m holds slots [offs[m], offs[m + 1])
    ids = torch.arange(M + 1, dtype=key_s.dtype, device=dev)
    offs = torch.searchsorted(key_s, ids.expand(F, M + 1).contiguous(),
                              side="left")
    seg_lo, seg_hi = offs[:, :M], offs[:, 1:]
    has_fin = seg_hi > seg_lo                               # (F, M)

    # mean-centred prefix sums: a late segment's prefix is then not a
    # small difference of large sums (colmaker.py:298-323)
    cbar_g, g_c = _centred(g_s)                             # (F, 1)
    cbar_h, h_c = _centred(h_s)
    cg = _blocked_cumsum(g_c)
    ch = _blocked_cumsum(h_c)
    cgp = torch.nn.functional.pad(cg, (1, 0))               # exclusive at i
    chp = torch.nn.functional.pad(ch, (1, 0))
    base_g = cgp.gather(1, seg_lo)                          # (F, M)
    base_h = chp.gather(1, seg_lo)
    cnt_f = (seg_hi - seg_lo).to(torch.float32)
    Gf = _mul_add(cbar_g, cnt_f, cgp.gather(1, seg_hi) - base_g)
    Hf = _mul_add(cbar_h, cnt_f, chp.gather(1, seg_hi) - base_h)
    Gmiss = G_tot[None, :] - Gf
    Hmiss = H_tot[None, :] - Hf

    zero_col = torch.zeros((F, 1), dtype=torch.float32, device=dev)

    def lut(tab):
        # (F, M) per-node table at each slot's node; trash slots read 0
        return torch.cat([tab, zero_col], dim=1).gather(1, key_s)

    # within-segment inclusive count for the mean-centring identity
    n_in = (torch.arange(N, dtype=torch.float32, device=dev)[None, :] + 1.0
            - lut(seg_lo.to(torch.float32)))
    GL_dr = _mul_add(cbar_g, n_in, cg - lut(base_g))
    HL_dr = _mul_add(cbar_h, n_in, ch - lut(base_h))
    gtot_s = lut(G_tot.expand(F, M))
    htot_s = lut(H_tot.expand(F, M))
    if has_missing:
        GL_dl = GL_dr + lut(Gmiss)
        HL_dl = HL_dr + lut(Hmiss)

    # a candidate boundary after slot i: the next slot is in the same
    # segment with a strictly greater value
    tail_k = torch.full((F, 1), M, dtype=key_s.dtype, device=dev)
    nxt_k = torch.cat([key_s[:, 1:], tail_k], dim=1)
    if ranked:
        nxt_r = torch.cat([rank_s[:, 1:], torch.zeros_like(rank_s[:, :1])],
                          dim=1)
        bnd = (key_s < M) & (nxt_k == key_s) & (nxt_r != rank_s)
        thr_s = None
    else:
        nxt_v = torch.cat([vs[:, 1:], torch.full_like(vs[:, :1],
                                                      float("nan"))], dim=1)
        bnd = (key_s < M) & (nxt_k == key_s) & (nxt_v > vs)
        thr_s = torch.where(bnd, 0.5 * (vs + nxt_v), 0.0)

    def side_gain(GL, HL):
        # the node's own gain is the same for every slot of a segment:
        # it is taken off the winner only
        GR = gtot_s - GL
        HR = htot_s - HL
        ok = (bnd & (HL >= scfg.min_child_weight)
              & (HR >= scfg.min_child_weight))
        lg = calc_gain(GL, HL, scfg) + calc_gain(GR, HR, scfg)
        return torch.where(ok, lg, NEG)

    lg_dr = side_gain(GL_dr, HL_dr)                         # (F, N)
    if has_missing:
        lg_dl = side_gain(GL_dl, HL_dl)
        if scfg.default_direction == 1:                     # forced left
            lg_dr = torch.full_like(lg_dr, NEG)
        elif scfg.default_direction == 2:                   # forced right
            lg_dl = torch.full_like(lg_dl, NEG)
        lg = torch.maximum(lg_dr, lg_dl)                    # dr wins ties
    else:
        lg = lg_dr

    bi = _argmax_per_segment(lg, key_s, M)                  # (F, M)
    node_ids = torch.arange(M, dtype=key_s.dtype, device=dev)[None, :]
    in_seg = key_s.gather(1, bi) == node_ids
    bg_raw = lg.gather(1, bi)
    ok_w = in_seg & (bg_raw > NEG)
    bg = torch.where(ok_w, bg_raw - root_gain[None, :], NEG)
    if ranked:
        r0 = rank_s.gather(1, bi)
        r1 = rank_s.gather(1, torch.clamp_max(bi + 1, N - 1))
        v0 = uniq.gather(1, r0)
        v1 = uniq.gather(1, r1)
        b_thr = torch.where(ok_w, 0.5 * (v0 + v1), 0.0)
    else:
        b_thr = thr_s.gather(1, bi)
    if has_missing:
        dl_slot = lg_dl > lg_dr
        b_dl = dl_slot.gather(1, bi)
        b_gl = torch.where(dl_slot, GL_dl, GL_dr).gather(1, bi)
        b_hl = torch.where(dl_slot, HL_dl, HL_dr).gather(1, bi)
    else:
        b_dl = torch.full((F, M), scfg.default_direction == 1,
                          dtype=torch.bool, device=dev)
        b_gl = GL_dr.gather(1, bi)
        b_hl = HL_dr.gather(1, bi)

    if has_missing:
        # end-of-scan candidates: all present values left and the
        # missing ones right (a threshold just above the node's largest
        # value), or missing left and present right (just below its
        # smallest); on a presence-only column the only split there is
        if ranked:
            rr_hi = rank_s.gather(1, torch.clamp_min(seg_hi - 1, 0))
            rr_lo = rank_s.gather(1, torch.clamp_max(seg_lo, N - 1))
            a_max = torch.where(has_fin, uniq.gather(1, rr_hi), 0.0)
            a_min = torch.where(has_fin, uniq.gather(1, rr_lo), 0.0)
        else:
            a_max = torch.where(has_fin, vs.gather(
                1, torch.clamp_min(seg_hi - 1, 0)), 0.0)
            a_min = torch.where(has_fin, vs.gather(
                1, torch.clamp_max(seg_lo, N - 1)), 0.0)
        eps_hi = torch.clamp_min(a_max.abs() * 1e-6, 1e-6)
        eps_lo = torch.clamp_min(a_min.abs() * 1e-6, 1e-6)

        def end_gain(GL, HL):
            GR = G_tot[None, :] - GL
            HR = H_tot[None, :] - HL
            ok = (has_fin & (HL >= scfg.min_child_weight)
                  & (HR >= scfg.min_child_weight))
            lgv = (calc_gain(GL, HL, scfg) + calc_gain(GR, HR, scfg)
                   - root_gain[None, :])
            return torch.where(ok, lgv, NEG)

        g_end_dr = end_gain(Gf, Hf)        # present left, missing right
        g_end_dl = end_gain(Gmiss, Hmiss)  # missing left, present right
        if scfg.default_direction == 1:
            g_end_dr = torch.full_like(g_end_dr, NEG)
        elif scfg.default_direction == 2:
            g_end_dl = torch.full_like(g_end_dl, NEG)

        cand_g = torch.stack([bg, g_end_dr, g_end_dl])      # (3, F, M)
        pick = torch.argmax(cand_g, dim=0)  # boundary wins ties, then dr
        bg = cand_g.amax(dim=0)
        b_thr = torch.where(
            pick == 0, b_thr,
            torch.where(pick == 1,
                        torch.where(has_fin, a_max + eps_hi, 0.0),
                        torch.where(has_fin, a_min - eps_lo, 0.0)))
        b_dl = torch.where(pick == 0, b_dl, pick == 2)
        b_gl = torch.where(pick == 0, b_gl, torch.where(pick == 1, Gf, Gmiss))
        b_hl = torch.where(pick == 0, b_hl, torch.where(pick == 1, Hf, Hmiss))

    # the lowest feature wins ties; "+ 0.0" is the sign of zero of the
    # JAX package's one-hot sum
    gains = torch.where(fmask[:, None], bg, NEG)
    bf = torch.argmax(gains, dim=0)                         # (M,)
    bgain = gains.amax(dim=0)
    sel = bf[None, :]
    thr = b_thr.gather(0, sel)[0] + 0.0
    dl = b_dl.gather(0, sel)[0]
    gl = b_gl.gather(0, sel)[0] + 0.0
    hl = b_hl.gather(0, sel)[0] + 0.0
    zeros = torch.zeros(M, dtype=torch.int32, device=dev)
    best = BestSplit(bgain, bf.to(torch.int32), zeros, dl,
                     bgain > RT_EPS, gl, hl)
    return best, thr


# ---------------------------------------------------------------- traversal

def traverse_raw(tree: TreeArrays, X: torch.Tensor,
                 max_depth: int, router=None) -> torch.Tensor:
    """Leaf node per row by raw-value comparison (``colmaker.py:507-
    524``): a missing value takes the default direction, and a value
    compares as ``nan_to_num`` makes it, as in the JAX package.
    ``router(f_row, thr_row, dl_row, X)``: column split's, on a rank's
    block of X's features."""
    N, F = X.shape
    node = torch.zeros(N, dtype=torch.int64, device=X.device)
    miss_x = torch.isnan(X)
    xz = torch.nan_to_num(X)
    for _ in range(max_depth):
        f = table_lookup(tree.feature, node)
        leaf = table_lookup(tree.is_leaf, node) | (f < 0)
        dl_row = table_lookup(tree.default_left, node)
        thr_row = table_lookup(tree.threshold, node)
        if router is not None:
            go_left = router(torch.clamp_min(f, 0), thr_row, dl_row, X)
        else:
            fc = torch.clamp_min(f, 0).to(torch.int64)[:, None]
            go_left = torch.where(miss_x.gather(1, fc)[:, 0], dl_row,
                                  xz.gather(1, fc)[:, 0] < thr_row)
        nxt = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(leaf, node, nxt)
    return node.to(torch.int32)


def predict_margin_raw(stack: TreeArrays, tree_group: torch.Tensor,
                       X: torch.Tensor, base: torch.Tensor, max_depth: int,
                       n_group: int, router=None) -> torch.Tensor:
    """(N, n_group) margins of raw rows (``colmaker.py:527-544``):
    ``base`` plus each tree's leaf value added to its group's column, in
    tree order."""
    N = X.shape[0]
    margin = torch.broadcast_to(base, (N, n_group)).to(torch.float32).clone()
    groups = tree_group.tolist()
    for t in range(stack.feature.shape[0]):
        tree = TreeArrays(*(x[t] for x in stack))
        leaf = traverse_raw(tree, X, max_depth, router)
        margin[:, groups[t]] += table_lookup(tree.leaf_value, leaf)
    return margin


def predict_leaf_raw(stack: TreeArrays, X: torch.Tensor,
                     max_depth: int, router=None) -> torch.Tensor:
    """(N, T) leaf node per tree of raw rows."""
    return torch.stack([traverse_raw(TreeArrays(*(x[t] for x in stack)), X,
                                     max_depth, router)
                        for t in range(stack.feature.shape[0])], dim=1)
