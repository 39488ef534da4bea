"""LambdaRank gradients on the device (port of ``xgboost_tpu/rank_device.py``).

Two layouts, both plain torch on the margin's device:

- the sort path (:func:`rank_gradient`) on rows as the user gave them:
  the static per-dataset tables of :class:`RankPrep` (each row's group,
  its label-sorted order and label bucket, each group's IDCG), built
  once on the host; per round one stable sort gives each row's position
  in its group by prediction, and each row draws a partner of another
  label with threefry (``randint`` of :mod:`xgboost_tpu_torch.random`,
  the JAX package's keys and draws bit for bit).  Rows of one group
  that tie on the prediction are ordered by row id here, where XLA's
  unstable sort has an order of its own (ROADMAP.md section 3);
- the group-padded path (:func:`rank_gradient_padded`) on the layout of
  :class:`PadRankPrep`: group g owns slots ``[g L, (g + 1) L)``, its rows
  sorted by label, padding lanes at the end.  The position by
  prediction is a count of better peers across the L lanes, the partner
  draw is a lane formula, and the partner's values are one gather along
  the lanes (the JAX package's one-hot batched dot, whose bf16 operands
  round the partner's prediction: :func:`_lane_select`).

Each row adds its own side of its pairs and the importance-weighted
estimate of what it receives as other rows' partner (the JAX package's
receive-side accumulation), so no scatter is needed.  The NDCG and MAP
swap weights are the reference's (objective-inl.hpp:435-570).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xgboost_tpu_torch import random as prng
from xgboost_tpu_torch.objectives import sigmoid
from xgboost_tpu_torch.ops.split import prefix_sum

_EPS = 1e-16
_INT32_MAX = 2 ** 31 - 1


class RankPrep(NamedTuple):
    """Static tables of the sort path, (N,) tensors on one device."""
    group_of: torch.Tensor   # int32 group id, -1 for a row of no group
    g_start: torch.Tensor    # int64 first row of the row's group
    g_size: torch.Tensor     # int32 rows in the row's group
    lab_order: torch.Tensor  # int64 row ids sorted by (group, -label)
    lab_rank: torch.Tensor   # int32 the row's place in lab_order, in-group
    b_lo: torch.Tensor       # int32 label-bucket start (in-group place)
    b_sz: torch.Tensor       # int32 label-bucket size
    idcg: torch.Tensor       # f32 the group's IDCG on each row
    label: torch.Tensor      # f32 labels, 0 past the last user row


def build_prep(labels: np.ndarray, group_ptr: np.ndarray, n_pad: int,
               device) -> RankPrep:
    """The sort path's tables for ``n_pad`` rows (``rank_device.py:
    62-105``), built on the host once and moved to ``device``; the row
    indices as int64, torch's index type."""
    labels = np.asarray(labels, np.float32)
    gptr = np.asarray(group_ptr, np.int64)
    n = n_pad
    group_of = np.full(n, -1, np.int32)
    g_start = np.zeros(n, np.int64)
    g_size = np.ones(n, np.int32)
    lab_order = np.arange(n, dtype=np.int64)
    lab_rank = np.zeros(n, np.int32)
    b_lo = np.zeros(n, np.int32)
    b_sz = np.ones(n, np.int32)
    idcg = np.zeros(n, np.float32)
    lab_full = np.zeros(n, np.float32)
    lab_full[:len(labels)] = labels
    for g in range(len(gptr) - 1):
        s, e = int(gptr[g]), int(gptr[g + 1])
        group_of[s:e] = g
        g_start[s:e] = s
        g_size[s:e] = e - s
        lg = labels[s:e]
        order = np.argsort(-lg, kind="stable")
        lab_order[s:e] = s + order
        lab_rank[s + order] = np.arange(e - s)
        ls = lg[order]
        starts = np.concatenate(
            [[0], np.nonzero(ls[1:] != ls[:-1])[0] + 1, [e - s]])
        for bi in range(len(starts) - 1):
            i, j = starts[bi], starts[bi + 1]
            rows = s + order[i:j]
            b_lo[rows] = i
            b_sz[rows] = j - i
        rel = ls.astype(np.int64)
        disc = 1.0 / np.log(np.arange(e - s) + 2.0)
        idcg[s:e] = np.sum((2.0 ** rel - 1.0) * disc)
    return RankPrep(*(torch.from_numpy(x).to(device) for x in (
        group_of, g_start, g_size, lab_order, lab_rank, b_lo, b_sz, idcg,
        lab_full)))


def _seg_cumsum(x_sorted: torch.Tensor, seg_start_sorted: torch.Tensor
                ) -> torch.Tensor:
    """The running sum within each segment of a segment-sorted array:
    the whole running sum less its value just before the segment
    (``rank_device.py:235``), in the JAX package's CPU summation order."""
    c = prefix_sum(x_sorted, 0)
    c0 = torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device), c])
    return c - c0[seg_start_sorted]


def _ndcg_delta(lab_hi, lab_lo, p_pos, p_neg, idcg):
    """|NDCG swap delta| of a (pos, neg) pair at prediction positions
    (p_pos, p_neg), float32 (``rank_device.py:367``)."""
    pos_li = 1.0 / torch.log(p_pos + 2.0)
    neg_li = 1.0 / torch.log(p_neg + 2.0)
    pg = torch.pow(2.0, lab_hi) - 1.0
    ng = torch.pow(2.0, lab_lo) - 1.0
    original = pg * pos_li + ng * neg_li
    changed = ng * pos_li + pg * neg_li
    return torch.where(idcg > 0.0,
                       torch.abs((original - changed)
                                 / torch.clamp_min(idcg, _EPS)), 0.0)


def _map_delta(a1_i2, a1_i1m, a2_i2m, a2_i1, a3_i2m, a3_i1, hits_i1,
               hits_i2, i1f, i2f, lab1, lab2, i1, i2, total_hits):
    """|MAP swap delta| from the running hit statistics at the pair's
    positions i1 <= i2 (``rank_device.py:382``)."""
    original = a1_i2 - torch.where(i1 > 0, a1_i1m, 0.0)
    ch_insert = a3_i2m - a3_i1 + (hits_i1 + 1.0) / (i1f + 1.0)
    ch_remove = a2_i2m - a2_i1 + hits_i2 / (i2f + 1.0)
    changed = torch.where(lab1 < lab2, ch_insert, ch_remove)
    w = torch.where(total_hits > 0,
                    torch.abs((changed - original)
                              / torch.clamp_min(total_hits, _EPS)), 0.0)
    return torch.where((lab1 == lab2) | (i1 == i2), 0.0, w)


def _accumulate(g_out, h_out, w, scale, fix_list_weight, g_size, can_pair,
                hi, pred, pred_p, ratio):
    """One pair draw's contribution to each row: its own side plus the
    importance-weighted side it receives, both in one ``1 + ratio``
    factor (pair weights are symmetric in the pair and the sign a row
    receives is its own sign)."""
    wv = w * scale
    if fix_list_weight != 0.0:
        wv = wv * fix_list_weight / g_size.to(torch.float32)
    wv = torch.where(can_pair, wv, 0.0)
    p = sigmoid(torch.where(hi, pred - pred_p, pred_p - pred))
    g = (p - 1.0) * wv
    h = torch.clamp_min(p * (1.0 - p), _EPS) * 2.0 * wv
    both = 1.0 + ratio
    return (g_out + torch.where(hi, g, -g) * both, h_out + h * both)


def _partner_lanes(key, k: int, shape, n_other, b_lo, b_sz, device):
    """Draw ``k`` of a round: a uniform place among the rows of other
    labels, skipping the row's own label bucket (reference
    objective-inl.hpp:323-344), as the JAX package draws it."""
    u = prng.randint_rows(prng.fold_in(key, k), shape, 0, 1 << 30,
                          device) % n_other
    return torch.where(u < b_lo, u, u + b_sz)


def sort_partners(key, k: int, prep: RankPrep) -> torch.Tensor:
    """(N,) int64 partner row of each row in draw ``k`` of the sort path."""
    n_other = torch.clamp_min(prep.g_size - prep.b_sz, 1)
    lab_pos = _partner_lanes(key, k, (prep.label.shape[0],), n_other,
                             prep.b_lo, prep.b_sz, prep.label.device)
    return prep.lab_order[prep.g_start + lab_pos]


def pred_order(pred: torch.Tensor, prep: RankPrep) -> torch.Tensor:
    """Row ids sorted by (group, -pred, row id): two stable sorts, rows
    of no group last so group g holds sorted places ``[g_start, g_end)``."""
    gkey = torch.where(prep.group_of < 0, _INT32_MAX, prep.group_of)
    by_pred = torch.sort(-pred, stable=True).indices
    return by_pred[torch.sort(gkey[by_pred], stable=True).indices]


def rank_gradient(pred: torch.Tensor, key, prep: RankPrep, kind: str,
                  num_pairsample: int = 1,
                  fix_list_weight: float = 0.0) -> torch.Tensor:
    """(N, 2) gradient pairs of one LambdaRank round on the sort path
    (``rank_device.py:108-232``); ``key`` the round's host key."""
    n = pred.shape[0]
    dev = pred.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    valid = (prep.group_of >= 0) & (prep.g_size > prep.b_sz)
    order = pred_order(pred, prep)
    inv = torch.empty_like(order)
    inv[order] = rows
    posn = inv - prep.g_start                      # (N,) place by pred

    if kind == "map":
        gs_o = prep.g_start[order]
        hit = (prep.label[order] > 0).to(torch.float32)
        inv_i = 1.0 / ((rows - gs_o).to(torch.float32) + 1.0)
        hits = _seg_cumsum(hit, gs_o)
        acc1 = _seg_cumsum(hit * hits * inv_i, gs_o)
        acc2 = _seg_cumsum(hit * (hits - 1.0) * inv_i, gs_o)
        acc3 = _seg_cumsum(hit * (hits + 1.0) * inv_i, gs_o)

        def at(arr_sorted, p):     # value at place p of the row's group
            return arr_sorted[prep.g_start + p]

    g_out = torch.zeros(n, dtype=torch.float32, device=dev)
    h_out = torch.zeros(n, dtype=torch.float32, device=dev)
    n_other_f = torch.clamp_min(prep.g_size - prep.b_sz, 1).to(torch.float32)
    scale = 1.0 / num_pairsample
    for k in range(num_pairsample):
        partner = sort_partners(key, k, prep)             # (N,) row ids
        lab_p = prep.label[partner]
        pred_p = pred[partner]
        posn_p = posn[partner]
        ratio = n_other_f / n_other_f[partner]
        hi = prep.label > lab_p
        p_pos = torch.where(hi, posn, posn_p)
        p_neg = torch.where(hi, posn_p, posn)
        lab_hi = torch.maximum(prep.label, lab_p)
        lab_lo = torch.minimum(prep.label, lab_p)
        if kind == "pairwise":
            w = torch.ones(n, dtype=torch.float32, device=dev)
        elif kind == "ndcg":
            w = _ndcg_delta(lab_hi, lab_lo, p_pos.to(torch.float32),
                            p_neg.to(torch.float32), prep.idcg)
        elif kind == "map":
            i1 = torch.minimum(p_pos, p_neg)
            i2 = torch.maximum(p_pos, p_neg)
            first = p_pos <= p_neg
            lab1 = (torch.where(first, lab_hi, lab_lo) > 0).to(torch.float32)
            lab2 = (torch.where(first, lab_lo, lab_hi) > 0).to(torch.float32)
            i1m = torch.clamp_min(i1 - 1, 0)
            i2m = torch.clamp_min(i2 - 1, 0)
            w = _map_delta(at(acc1, i2), at(acc1, i1m), at(acc2, i2m),
                           at(acc2, i1), at(acc3, i2m), at(acc3, i1),
                           at(hits, i1), at(hits, i2),
                           i1.to(torch.float32), i2.to(torch.float32),
                           lab1, lab2, i1, i2, at(hits, prep.g_size - 1))
        else:
            raise ValueError(f"unknown rank kind {kind!r}")
        g_out, h_out = _accumulate(g_out, h_out, w, scale, fix_list_weight,
                                   prep.g_size, valid, hi, pred, pred_p,
                                   ratio)
    return torch.stack([g_out, h_out], dim=1)


# ---------------------------------------------------------- padded layout
class PadRankPrep(NamedTuple):
    """Static tables of the group-padded layout: G groups of L lanes,
    slot (g, j) the row with the j-th largest label of group g (ties in
    row order) or padding (j >= g_size[g]); rows past the last group
    keep flat slots after G L.  Tensors on one device; the maps stay on
    the host."""
    G: int
    L: int                   # lanes: the largest group, a multiple of 8
    n_tail: int              # rows of no group after the padded block
    label: torch.Tensor      # (G, L) f32, 0 in padding lanes
    valid: torch.Tensor      # (G, L) bool
    g_size: torch.Tensor     # (G, 1) int32 rows of the group
    b_lo: torch.Tensor       # (G, L) int32 label-bucket start (lane)
    b_sz: torch.Tensor       # (G, L) int32 label-bucket size
    idcg: torch.Tensor       # (G, 1) f32
    pad_map: np.ndarray      # (G L + n_tail,) int32 user row a slot, -1 pad
    user_map: np.ndarray     # (n_user,) int32 slot of each user row


def build_pad_prep(labels: np.ndarray, group_ptr: np.ndarray, device,
                   lane_align: int = 8) -> PadRankPrep:
    """The padded layout's tables (``rank_device.py:286-337``)."""
    labels = np.asarray(labels, np.float32)
    gptr = np.asarray(group_ptr, np.int64)
    n_user = len(labels)
    G = len(gptr) - 1
    sizes = np.diff(gptr).astype(np.int64)
    max_gs = int(sizes.max()) if G else 1
    L = max(lane_align, -(-max_gs // lane_align) * lane_align)
    n_tail = int(n_user - gptr[-1])

    pad_map = np.full(G * L + n_tail, -1, np.int32)
    user_map = np.zeros(n_user, np.int32)
    label_pad = np.zeros((G, L), np.float32)
    valid = np.zeros((G, L), np.bool_)
    b_lo = np.zeros((G, L), np.int32)
    b_sz = np.ones((G, L), np.int32)
    idcg = np.zeros(G, np.float32)
    for g in range(G):
        s, e = int(gptr[g]), int(gptr[g + 1])
        sz = e - s
        lg = labels[s:e]
        order = np.argsort(-lg, kind="stable")
        rows = (s + order).astype(np.int32)
        pad_map[g * L: g * L + sz] = rows
        user_map[rows] = g * L + np.arange(sz, dtype=np.int32)
        ls = lg[order]
        label_pad[g, :sz] = ls
        valid[g, :sz] = True
        starts = np.concatenate(
            [[0], np.nonzero(ls[1:] != ls[:-1])[0] + 1, [sz]])
        for bi in range(len(starts) - 1):
            i, j = int(starts[bi]), int(starts[bi + 1])
            b_lo[g, i:j] = i
            b_sz[g, i:j] = j - i
        rel = ls.astype(np.int64)
        disc = 1.0 / np.log(np.arange(sz) + 2.0)
        idcg[g] = np.sum((2.0 ** rel - 1.0) * disc)
    if n_tail:
        tail_rows = np.arange(gptr[-1], n_user, dtype=np.int32)
        pad_map[G * L:] = tail_rows
        user_map[tail_rows] = G * L + np.arange(n_tail, dtype=np.int32)
    sizes_dev = sizes.astype(np.int32)[:, None]

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return PadRankPrep(G, L, n_tail, dev(label_pad), dev(valid),
                       dev(sizes_dev), dev(b_lo), dev(b_sz),
                       dev(idcg[:, None]), pad_map, user_map)


def _lane_select(idx: torch.Tensor, tab: torch.Tensor,
                 exact: bool = False) -> torch.Tensor:
    """``tab[g, idx[g, i], :]``: idx (G, L) lanes, tab (G, L, C) ->
    (G, L, C) float32.  The JAX package selects with a one-hot batched
    dot (``rank_device.py:340-364``) on bf16 operands with f32
    accumulation: one non-zero term, so its result is the bf16 rounding
    of the selected value, which the default mode gives; ``exact=True``
    (its f32 HIGHEST dot) selects the value itself."""
    src = tab if exact else tab.to(torch.bfloat16).to(torch.float32)
    C = tab.shape[2]
    return torch.gather(src, 1, idx.to(torch.int64)[:, :, None].expand(
        -1, -1, C))


def pad_partners(key, k: int, prep: PadRankPrep) -> torch.Tensor:
    """(G, L) int32 partner lane of each lane in draw ``k``."""
    return _partner_lanes(key, k, (prep.G, prep.L),
                          torch.clamp_min(prep.g_size - prep.b_sz, 1),
                          prep.b_lo, prep.b_sz, prep.label.device)


def pad_positions(P: torch.Tensor, prep: PadRankPrep) -> torch.Tensor:
    """(G, L) int32 place of each lane by prediction within its group:
    the count of valid peers that are better, ties broken by lane."""
    L = prep.L
    lane = torch.arange(L, dtype=torch.int32, device=P.device)
    better = (P[:, None, :] > P[:, :, None]) | (
        (P[:, None, :] == P[:, :, None])
        & (lane[None, None, :] < lane[None, :, None]))
    better &= prep.valid[:, None, :]
    return better.sum(dim=2, dtype=torch.int32)


def rank_gradient_padded(pred: torch.Tensor, key, prep: PadRankPrep,
                         kind: str, num_pairsample: int = 1,
                         fix_list_weight: float = 0.0) -> torch.Tensor:
    """(G L + n_tail, 2) gradient pairs of one LambdaRank round on the
    group-padded layout (``rank_device.py:398-513``): the sort path's
    sampling and weights, with places and partner reads along the lanes.
    The partner's prediction rounds through bf16 as in the JAX package."""
    G, L = prep.G, prep.L
    dev = pred.device
    P = pred[:G * L].reshape(G, L)
    lane = torch.arange(L, dtype=torch.int64, device=dev)
    posn = pad_positions(P, prep)                          # (G, L)
    n_other_f = torch.clamp_min(prep.g_size - prep.b_sz, 1).to(torch.float32)
    can_pair = prep.valid & (prep.g_size > prep.b_sz)

    if kind == "map":
        hit = ((prep.label > 0.0) & prep.valid).to(torch.float32)
        # hits in place space: each valid lane's hit lands at its place
        # (places of one group's valid lanes are distinct); padding
        # lanes go to a column past the last place
        where = torch.where(prep.valid, posn.to(torch.int64), L)
        hits_at = torch.zeros((G, L + 1), dtype=torch.float32, device=dev)
        hits_at = hits_at.scatter_add(1, where, hit)[:, :L]
        hits_cum = prefix_sum(hits_at, 1)
        inv_i = 1.0 / (lane.to(torch.float32)[None, :] + 1.0)
        acc1 = prefix_sum(hits_at * hits_cum * inv_i, 1)
        acc2 = prefix_sum(hits_at * (hits_cum - 1.0) * inv_i, 1)
        acc3 = prefix_sum(hits_at * (hits_cum + 1.0) * inv_i, 1)
        pos_tab = torch.stack([acc1, acc2, acc3, hits_cum], dim=2)
        total_hits = hits_cum[:, L - 1:L]

    g_out = torch.zeros((G, L), dtype=torch.float32, device=dev)
    h_out = torch.zeros((G, L), dtype=torch.float32, device=dev)
    scale = 1.0 / num_pairsample
    posn_f = posn.to(torch.float32)
    tab = torch.stack([prep.label, P, posn_f, n_other_f], dim=2)
    for k in range(num_pairsample):
        part = _lane_select(pad_partners(key, k, prep), tab)
        lab_p, pred_p, posn_p = part[..., 0], part[..., 1], part[..., 2]
        ratio = n_other_f / torch.clamp_min(part[..., 3], 1.0)
        hi = prep.label > lab_p
        p_pos = torch.where(hi, posn_f, posn_p)
        p_neg = torch.where(hi, posn_p, posn_f)
        lab_hi = torch.maximum(prep.label, lab_p)
        lab_lo = torch.minimum(prep.label, lab_p)
        if kind == "pairwise":
            w = torch.ones((G, L), dtype=torch.float32, device=dev)
        elif kind == "ndcg":
            w = _ndcg_delta(lab_hi, lab_lo, p_pos, p_neg, prep.idcg)
        elif kind == "map":
            i1 = torch.minimum(p_pos, p_neg).to(torch.int32)
            i2 = torch.maximum(p_pos, p_neg).to(torch.int32)
            first = p_pos <= p_neg
            lab1 = (torch.where(first, lab_hi, lab_lo) > 0).to(torch.float32)
            lab2 = (torch.where(first, lab_lo, lab_hi) > 0).to(torch.float32)
            r1 = _lane_select(i1, pos_tab, exact=True)
            r1m = _lane_select(torch.clamp_min(i1 - 1, 0), pos_tab,
                               exact=True)
            r2 = _lane_select(i2, pos_tab, exact=True)
            r2m = _lane_select(torch.clamp_min(i2 - 1, 0), pos_tab,
                               exact=True)
            w = _map_delta(r2[..., 0], r1m[..., 0], r2m[..., 1], r1[..., 1],
                           r2m[..., 2], r1[..., 2], r1[..., 3], r2[..., 3],
                           i1.to(torch.float32), i2.to(torch.float32),
                           lab1, lab2, i1, i2, total_hits)
        else:
            raise ValueError(f"unknown rank kind {kind!r}")
        g_out, h_out = _accumulate(g_out, h_out, w, scale, fix_list_weight,
                                   prep.g_size, can_pair, hi, P, pred_p,
                                   ratio)
    gh = torch.stack([g_out.reshape(-1), h_out.reshape(-1)], dim=1)
    if prep.n_tail:
        gh = torch.cat([gh, torch.zeros((prep.n_tail, 2),
                                        dtype=torch.float32, device=dev)])
    return gh
