"""Struct-of-arrays regression trees: growth and traversal (port of
``xgboost_tpu/models/tree.py``).

A tree of ``max_depth`` D is a perfect binary layout of ``2**(D+1)-1``
nodes (node g has children 2g+1 / 2g+2), one tensor per field.  Growth
is level by level: a histogram, the split search, :func:`apply_level`,
then row routing.  :func:`grow_trees` grows the T trees of a multiclass
or forest round together on shared bins, with one histogram launch per
level for all of them (kernel K3 on a GPU) and one split search over
their ``T * n_node`` nodes; :func:`grow_tree` is its T = 1 case, whose
histogram is kernel K1.  Given bins with a leading lane axis,
:func:`grow_trees` grows one tree for each of L tenant lanes (the JAX
package's ``jax.vmap(grow_tree)`` over lanes), each on its own bins,
cuts and gradients, with one K4 launch per level.  Everything stays on
the tensors' device; nothing in a level reads a value back to the
host.

Sampling draws from each tree's host key (:func:`draw_masks`, threefry
bit for bit as ``jax.random``): the row mask on the device, the feature
masks of every level on the host, uploaded once a tree.  Multi-root
trees start growth and traversal at the root-slot level, each row at
its ``root_index`` slot.  Under histogram subtraction a level from the
second on builds only each parent's smaller child, on compacted rows
(:func:`_subtracted_level_hist`).

The JAX package reads per-node values per row with one-hot compare-sums
(gathers serialize on a TPU) for tables of up to 1024 entries, and
gathers past that (``tree.py:121-134``).  Here they are gathers:
integers come out the same, and :func:`table_lookup` adds ``+ 0.0`` to
float values from small tables, which makes a -0 a +0 exactly as the
one-hot sum does and changes nothing else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch import random as prng
from xgboost_tpu_torch.ops.histogram import (HistPrep, build_level_histogram,
                                             build_level_histogram_batched,
                                             build_level_histogram_lanes,
                                             node_stats, prepare_hist,
                                             stats_from_histogram_native)
from xgboost_tpu_torch.ops.split import (BestSplit, SplitConfig,
                                         calc_weight,
                                         find_best_splits_native)

_FIELDS_DTYPE = (("feature", torch.int32), ("cut_index", torch.int32),
                 ("threshold", torch.float32), ("default_left", torch.bool),
                 ("is_leaf", torch.bool), ("leaf_value", torch.float32),
                 ("gain", torch.float32), ("sum_hess", torch.float32))


class TreeArrays(NamedTuple):
    """One regression tree, or a (T, n_nodes) stack of them."""
    feature: torch.Tensor       # int32, -1 if leaf/unused
    cut_index: torch.Tensor     # int32
    threshold: torch.Tensor     # f32 raw-value cut (v < thr -> left)
    default_left: torch.Tensor  # bool
    is_leaf: torch.Tensor       # bool
    leaf_value: torch.Tensor    # f32 (eta-scaled)
    gain: torch.Tensor          # f32 loss_chg of the split
    sum_hess: torch.Tensor      # f32 node hessian sum


class GrowConfig(NamedTuple):
    """Static configuration of tree growth (``tree.py:47-69``; the JAX
    package's field names, ``hist_precision`` kept fourth)."""
    split: SplitConfig
    max_depth: int
    n_bin: int                  # histogram bins B (incl. missing bin 0)
    hist_precision: str = "auto"
    subsample: float = 1.0
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    # build only each parent's smaller child on compacted rows and take
    # the sibling as parent - small (:func:`_subtracted_level_hist`)
    hist_subtraction: bool = False
    # multi-root trees: the top root_level(n_roots) levels are root slots
    # and row i enters at node (2**d0 - 1) + root_index[i]
    n_roots: int = 1

    @property
    def sampled(self) -> bool:
        return min(self.subsample, self.colsample_bytree,
                   self.colsample_bylevel) < 1.0


def root_level(n_roots: int) -> int:
    """Depth of the level holding the root slots (0 for one root)."""
    return max(n_roots - 1, 0).bit_length()


def tree_capacity(max_depth: int, n_roots: int = 1) -> int:
    return 2 ** (root_level(n_roots) + max_depth + 1) - 1


def empty_tree(max_depth: int, n_tree: int, device=None,
               n_roots: int = 1) -> TreeArrays:
    """A (n_tree, n_nodes) stack of all-unused arrays for a
    depth-``max_depth`` perfect layout under ``n_roots`` root slots."""
    shape = (n_tree, tree_capacity(max_depth, n_roots))
    return TreeArrays(**{
        name: (torch.full(shape, -1, dtype=dt, device=device)
               if name == "feature"
               else torch.zeros(shape, dtype=dt, device=device))
        for name, dt in _FIELDS_DTYPE})


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (or per tree, ``table[t, idx[t]]`` for a (T, M)
    table and (T, N) indices), with the sign of zero of the JAX
    package's lookup."""
    idx = idx.to(torch.int64)
    v = table.gather(1, idx) if table.dim() == 2 else table[idx]
    if table.dtype.is_floating_point and table.shape[-1] <= 1024:
        v = v + 0.0
    return v


def bin_of_feature(binned: torch.Tensor, f_row: torch.Tensor) -> torch.Tensor:
    """``binned[r, f_row[..., r]]`` as int32, for (N,) or (T, N)
    ``f_row``; with lane bins (L, N, F) and (L, N) ``f_row``,
    ``binned[l, r, f_row[l, r]]``."""
    if binned.dim() == 3:
        return binned.gather(2, f_row.to(torch.int64)[..., None])[
            ..., 0].to(torch.int32)
    N = binned.shape[0]
    cols = f_row.reshape(-1, N).T.to(torch.int64)          # (N, T)
    return binned.gather(1, cols).T.reshape(f_row.shape).to(torch.int32)


def bin_router(f_row: torch.Tensor, j_row: torch.Tensor,
               dl_row: torch.Tensor, binned: torch.Tensor) -> torch.Tensor:
    """Go-left per row when every feature is local (``tree.py:162-176``):
    bin 0 (missing) takes the default direction, else bins up to cut
    ``j + 1`` go left.  ``f_row`` (>= 0), ``j_row`` and ``dl_row`` are the
    split feature, cut and default direction at each row's node.  The
    ``router`` seam of growth, traversal and refresh; column split
    replaces it (:mod:`xgboost_tpu_torch.parallel.colsplit`)."""
    b = bin_of_feature(binned, f_row)
    return torch.where(b == 0, dl_row, b <= j_row + 1)


# ---------------------------------------------------------------- sampling

def sample_features(keys: np.ndarray, n_feature: int,
                    rate: float) -> np.ndarray:
    """Each key's feature mask, (..., F) bool on the host for keys
    (..., 2) (``tree.py:520-527``): a feature is kept when its uniform
    draw is below ``rate``; an empty mask becomes the one feature of a
    ``randint`` on the same key (drawn only for the keys that need it:
    the others never read it)."""
    if rate >= 1.0:
        return np.ones(keys.shape[:-1] + (n_feature,), np.bool_)
    mask = prng.uniform(keys, n_feature) < np.float32(rate)
    empty = ~mask.any(axis=-1)
    if empty.any():
        pick = prng.randint(keys[empty], (), 0, n_feature)
        mask[empty] = np.arange(n_feature)[None, :] == pick[:, None]
    return mask


class _Draws(NamedTuple):
    """One grow call's random draws: the row keep masks on the device,
    and the feature masks of every level as one device tensor."""
    keep: Optional[torch.Tensor]        # (T, N) bool, None = every row
    fmask: Optional[torch.Tensor]       # (levels, T, F) bool, None = all


def draw_masks(keys, n_rows: int, n_feature: int, cfg: GrowConfig,
               device, feat_sampler=None) -> _Draws:
    """The draws of ``tree.py:305-320,400-405`` for T trees' keys (T, 2):
    each key splits into (rows, tree features, level features); rows are
    kept where ``uniform(key_rows, (N,)) < subsample``; the level at
    depth d keeps the tree's features that ``fold_in(key_flevel, d)``
    also keeps.  Keys and feature masks are host values; the row draw
    runs on ``device`` and the feature masks go up in one copy.
    ``feat_sampler(keys, rate)`` gives the (..., n_feature) masks of
    keys (..., 2) (default :func:`sample_features` over the
    ``n_feature`` features; column split draws over every rank's
    features and keeps its own)."""
    if not cfg.sampled:
        return _Draws(None, None)
    if feat_sampler is None:
        def feat_sampler(k, rate):
            return sample_features(k, n_feature, rate)
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    parts = prng.split(keys, 3)                   # (T, 3, 2)
    keep = None
    if cfg.subsample < 1.0:
        rows = parts[:, 0] if len(keys) > 1 else parts[0, 0]
        keep = (prng.uniform_rows(rows, n_rows, device)
                < cfg.subsample).reshape(len(keys), n_rows)
    fmask = None
    if min(cfg.colsample_bytree, cfg.colsample_bylevel) < 1.0:
        d0 = root_level(cfg.n_roots)
        depths = np.arange(d0, d0 + cfg.max_depth)[:, None]   # (D, 1)
        host = np.broadcast_to(
            feat_sampler(parts[:, 1], cfg.colsample_bytree),
            (cfg.max_depth, len(keys), n_feature))
        if cfg.colsample_bylevel < 1.0:
            # every level's key at once: fold_in(key_flevel, depth)
            host = host & feat_sampler(
                prng.fold_in(parts[None, :, 2], depths),
                cfg.colsample_bylevel)
        fmask = torch.from_numpy(np.ascontiguousarray(host)).to(
            device, non_blocking=True)
    return _Draws(keep, fmask)


# ---------------------------------------------------------------- growth

def grow_tree(binned: torch.Tensor, gh: torch.Tensor,
              cut_values: torch.Tensor, n_cuts: torch.Tensor,
              cfg: GrowConfig, row_valid: Optional[torch.Tensor] = None,
              key=None, root: Optional[torch.Tensor] = None,
              split_finder=None, hist_reduce=None, *, router=None,
              feat_sampler=None, level_totals=None
              ) -> Tuple[TreeArrays, torch.Tensor, torch.Tensor]:
    """Grow one tree level by level (``tree.py:260-465``):
    :func:`grow_trees` for T = 1, with the one-tree histogram K1.

    binned (N, F) u8 bins (0 = missing); gh (N, 2) f32; cut_values
    (F, C) f32 and n_cuts (F,) int32 on the same device; row_valid
    optional (N,) bool (rows outside it add nothing and reach no leaf);
    ``key`` the tree's host key (2,) uint32, needed when the config
    samples; ``root`` optional (N,) int32 root slot of each row.

    Returns (tree, row_leaf (N,) int32 leaf node per row, row_val (N,)
    f32 the row's leaf value, recorded when the row is parked)."""
    keys = None if key is None else np.asarray(key, np.uint32)[None]
    trees, row_leaf, row_val = grow_trees(binned, gh[None], cut_values,
                                          n_cuts, cfg, row_valid, keys,
                                          root, split_finder, hist_reduce,
                                          router=router,
                                          feat_sampler=feat_sampler,
                                          level_totals=level_totals)
    return TreeArrays(*(x[0] for x in trees)), row_leaf[0], row_val[0]


def grow_trees(binned: torch.Tensor, gh: torch.Tensor,
               cut_values: torch.Tensor, n_cuts: torch.Tensor,
               cfg: GrowConfig, row_valid: Optional[torch.Tensor] = None,
               keys=None, root: Optional[torch.Tensor] = None,
               split_finder=None, hist_reduce=None, *, router=None,
               feat_sampler=None, level_totals=None
               ) -> Tuple[TreeArrays, torch.Tensor, torch.Tensor]:
    """Grow T trees together on shared bins, each on its own gradients
    ``gh`` (T, N, 2) and its own host key ``keys[t]`` (T, 2) uint32 (the
    JAX package's ``jax.vmap`` of ``grow_tree`` over an ensemble round,
    ``gbtree.py:681``, with tree t's key ``fold_in(round_key, t)``).

    Per level: one histogram of all T trees, ``(F, B, 2, T * n_node)``
    tree outer (K3, or K1 when T = 1); one split search over the
    ``T * n_node`` columns, which are independent (the prefix sum runs
    along the bins only), so each tree's splits are bitwise those of a
    solo search; routing gathers ``binned[r, feature[t, node]]`` per
    tree.  Sampling (:func:`draw_masks`) zeroes the gradients of each
    tree's dropped rows, which still flow to a leaf, and gives each
    tree's columns its own feature mask in the split search.  With
    ``cfg.n_roots > 1`` growth starts at the root-slot level, each row
    at its ``root`` slot (slot 0 without ``root``).  Returns (tree stack
    (T, n_nodes), row_leaf (T, N) int32, row_val (T, N) f32).

    Lanes: with binned (L, N, F), the T = L trees are L tenants' (the
    JAX package's ``jax.vmap`` of the round scan over lanes,
    ``gbtree.py:275-318``), each with its own cut_values (L, F, W),
    n_cuts (L, F), row_valid (L, N) (pad rows and pad lanes False) and
    key.  The histogram is K4's ``(F, B, 2, L * n_node)``, the split
    search reads each column's own cut count, thresholds come from each
    lane's own cuts and routing gathers ``binned[l, r, feature[l,
    node]]``.

    ``split_finder`` replaces :func:`find_best_splits_native` with a
    function of the same arguments (the skmaker finder,
    :mod:`.skmaker`); a finder that leaves no left sums makes the
    terminal level take its node sums from K2 (``tree.py:367-380``).

    ``hist_reduce`` is the collective seam of row-split training
    (``tree.py:263,296,377-392``), a
    :class:`~xgboost_tpu_torch.parallel.dp.HistReduce` or None: it sums a
    tensor of this rank's partial sums over the ranks, bitwise alike on
    every rank, and is applied to every level histogram and node-stat
    tensor before dequantisation; its ``max`` gives the int8 scales of
    all ranks' rows, and its ``world`` the row count they must hold.  Split decisions are
    then taken on every rank alike, and each rank routes its own rows.

    Column split (``tree.py:259-299``, :mod:`~xgboost_tpu_torch.parallel.
    colsplit`) fills the other seams: ``router(f_row, j_row, dl_row,
    binned)`` sends rows left or right (default :func:`bin_router`),
    ``feat_sampler(keys, rate)`` draws the feature masks
    (:func:`draw_masks`), and ``level_totals(nst)`` gives the (T *
    n_node, 2) node totals every rank takes for the level's histogram
    totals (default: these).  The finder then reads ``cut_values`` and
    ``n_cuts`` of every feature, and ``binned`` holds the rank's."""
    lanes = binned.dim() == 3
    red = hist_reduce
    if split_finder is None:
        split_finder = find_best_splits_native
    if router is None:
        router = bin_router
    T, N = gh.shape[:2]
    F = binned.shape[-1]
    D = cfg.max_depth
    d0 = root_level(cfg.n_roots)
    dev = binned.device
    if cfg.sampled and keys is None:
        raise ValueError("a sampled grow config needs one key per tree")
    draws = draw_masks(keys, N, F, cfg, dev, feat_sampler)
    gh_used = gh
    if draws.keep is not None:
        gh_used = gh * draws.keep[..., None].to(gh.dtype)
    if root is not None and d0 > 0:
        # a copy per tree: the kernels take contiguous positions only
        pos = torch.clamp(root.to(torch.int32), 0, cfg.n_roots - 1)
        pos = pos.expand(T, N).contiguous()
    else:
        pos = torch.zeros((T, N), dtype=torch.int32, device=dev)
    if row_valid is not None:
        rv = row_valid if lanes else row_valid[None, :]
        gh_used = gh_used * rv[..., None].to(gh.dtype)
        pos = torch.where(rv, pos, -1)

    tree = empty_tree(D, T, dev, cfg.n_roots)
    row_leaf = torch.zeros((T, N), dtype=torch.int32, device=dev)
    row_val = torch.zeros((T, N), dtype=torch.float32, device=dev)
    prep = prepare_hist(gh_used[0] if T == 1 and not lanes else gh_used,
                        cfg.hist_precision,
                        N * (1 if red is None else red.world),
                        None if red is None else red.max)
    if lanes:
        W = cut_values.shape[2]
        flat_cuts = cut_values.reshape(T * F, W)
        lane_row = (torch.arange(T, dtype=torch.int64, device=dev)
                    * F)[:, None]                    # lane l's first row
    prev = None  # (best, nst, do_split) of the previous level
    hist_prev = None

    for depth in range(d0, d0 + D + 1):
        n_node = 1 << depth
        base = n_node - 1
        if depth == d0 + D:
            # terminal level: node stats from the parent's split (left =
            # the winner's left sums, right = parent - left) where the
            # finder gave them, else K2
            if prev is not None and prev[0].left_g is not None:
                p_best, p_nst, p_split = prev
                gl = torch.where(p_split, p_best.left_g, 0.0)
                hl = torch.where(p_split, p_best.left_h, 0.0)
                gr = torch.where(p_split, p_nst[:, 0] - p_best.left_g, 0.0)
                hr = torch.where(p_split, p_nst[:, 1] - p_best.left_h, 0.0)
                nst = torch.stack(
                    [torch.stack([gl, gr], 1).reshape(-1),
                     torch.stack([hl, hr], 1).reshape(-1)], dim=1)
            else:
                nst = node_stats(gh_used, pos, n_node, cfg.hist_precision,
                                 red).reshape(T * n_node, 2)
            make_leaf = torch.ones(T * n_node, dtype=torch.bool, device=dev)
            best = thr = None
        else:
            if hist_prev is not None:
                hist = _subtracted_level_hist(binned, prep, pos, n_node,
                                              cfg.n_bin, hist_prev, prev[2],
                                              red=red)
            else:
                hist = _full_level_hist(binned, prep, pos, n_node,
                                        cfg.n_bin, red)
            if cfg.hist_subtraction:
                hist_prev = hist
            nst = stats_from_histogram_native(hist)     # (T * n_node, 2)
            if level_totals is not None:
                nst = level_totals(nst)
            fmask = None
            if draws.fmask is not None:
                # each column's own tree's features: (F, T * n_node)
                fmask = draws.fmask[depth - d0].T[:, :, None].expand(
                    -1, T, n_node).reshape(F, T * n_node)
            if lanes:
                # each column's own lane's cut counts: (F, L * n_node)
                col_cuts = n_cuts.T[:, :, None].expand(
                    -1, T, n_node).reshape(-1, T * n_node)
                best = split_finder(hist, nst, col_cuts, cfg.split, fmask)
                cut_row = (lane_row + best.feature.reshape(T, n_node)
                           ).reshape(-1)
                thr = flat_cuts[cut_row, _cut_col(best, W)]
            else:
                best = split_finder(hist, nst, n_cuts, cfg.split, fmask)
                thr = cut_values[best.feature.to(torch.int64),
                                 _cut_col(best, cut_values.shape[1])]
            # cannot_split (param.h:174): too little hessian to split
            can_try = nst[:, 1] >= 2.0 * cfg.split.min_child_weight
            do_split = best.valid & can_try
            make_leaf = ~do_split
            prev = (best, nst, do_split)

        tree = apply_level(tree, depth, nst, best, thr, make_leaf, cfg.split)
        leaf_w = calc_weight(nst[:, 0], nst[:, 1], cfg.split) * cfg.split.eta

        # park rows whose node became a leaf; route the rest to children
        active = pos >= 0
        node = torch.clamp(pos, 0, n_node - 1).to(torch.int64)

        def per_row(v):   # a (T * n_node,) level vector at each row's node
            return v.reshape(T, n_node).gather(1, node)
        val_row = table_lookup(leaf_w.reshape(T, n_node), node)
        if best is None:
            row_is_leaf = active
        else:
            row_is_leaf = active & per_row(make_leaf)
            go_left = router(per_row(best.feature), per_row(best.cut_index),
                             per_row(best.default_left), binned)
        row_leaf = torch.where(row_is_leaf, base + pos, row_leaf)
        row_val = torch.where(row_is_leaf, val_row, row_val)
        if best is not None:
            new_pos = 2 * pos + (~go_left).to(torch.int32)
            pos = torch.where(active & ~row_is_leaf, new_pos, -1)
    return tree, row_leaf, row_val


def _cut_col(best: BestSplit, width: int) -> torch.Tensor:
    """The cut column of each node's threshold, clamped to the table as
    the skmaker finder clamps it (``skmaker.py:168-169``); the default
    finder's cut indices are always inside."""
    return torch.clamp(best.cut_index.to(torch.int64), 0, width - 1)


def _full_level_hist(binned: torch.Tensor, prep: HistPrep,
                     pos: torch.Tensor, n_node: int, n_bin: int,
                     red=None) -> torch.Tensor:
    """A level's ``(F, B, 2, T * n_node)`` histogram of every active row:
    K4 for lane bins (L, N, F), K1 for one tree, K3 for T trees."""
    if binned.dim() == 3:
        return build_level_histogram_lanes(binned, prep, pos, n_node, n_bin,
                                           red)
    if pos.shape[0] == 1:
        return build_level_histogram(binned, prep, pos[0], n_node, n_bin,
                                     red)
    return build_level_histogram_batched(binned, prep, pos, n_node, n_bin,
                                         red)


def _subtracted_level_hist(binned: torch.Tensor, prep: HistPrep,
                           pos: torch.Tensor, n_node: int, n_bin: int,
                           hist_parent: torch.Tensor,
                           parent_split: torch.Tensor,
                           red=None) -> torch.Tensor:
    """A level's ``(F, B, 2, T * n_node)`` histogram by subtraction
    (``tree.py:183-246``): per parent only the child with fewer active
    rows is built, on its rows compacted into ``cap`` rows, and the
    sibling is ``parent - small`` under a split parent (0 under a leaf,
    whose children have no rows).

    The per-child row counts come from K2; the small children of one
    tree are built by K1 on its compacted rows, those of T trees or
    lanes by K4 with each tree's compacted rows as a lane's bins.  The
    counts are f32 sums, exact below 2**24 rows.  Under row split
    (``red``) the counts are every rank's, so every rank builds the same
    children; the small children of all ranks hold at most half of all
    rows, but one rank's share of them can exceed its buffer of half its
    own rows, so the local overflow flag is reduced and every rank takes
    the full build together when any rank overflows (the JAX package's
    ``lax.cond`` on a psum'd flag).  On one device the small children
    hold at most N/2 rows and the full build never runs."""
    T, N = pos.shape
    F = binned.shape[-1]
    dev = binned.device
    half = n_node // 2
    ones = (pos >= 0).to(torch.float32)[..., None].expand(T, N, 2)
    counts = node_stats(ones.contiguous(), pos, n_node,
                        reduce=red)[..., 0]                     # (T, M)
    small_is_left = counts[:, 0::2] <= counts[:, 1::2]
    is_small = torch.stack([small_is_left, ~small_is_left],
                           dim=2).reshape(T, n_node)
    node = torch.clamp(pos, 0, n_node - 1).to(torch.int64)
    msk = (pos >= 0) & is_small.gather(1, node)
    cap = max(256, -(-(N // 2) // 256) * 256)
    if red is not None:
        over = (msk.sum(dim=1).max() > cap).to(torch.int32).reshape(1)
        if int(red(over)[0]) > 0:
            return _full_level_hist(binned, prep, pos, n_node, n_bin, red)
    dest = torch.where(msk, (torch.cumsum(msk, dim=1) - 1).clamp_max(cap),
                       cap)                      # row cap: the dump row

    def compact(src, fill, t):
        out = torch.full((cap + 1,) + src.shape[1:], fill, dtype=src.dtype,
                         device=dev)
        return out.index_copy_(0, dest[t], src)[:cap]
    lanes = binned.dim() == 3
    if T == 1 and not lanes:
        hist_small = build_level_histogram(
            compact(binned, 0, 0), HistPrep(compact(prep.gh_in, 0, 0),
                                            prep.scale, prep.mode),
            compact(pos[0], -1, 0), n_node, n_bin, red)
    else:
        b_small = torch.stack([compact(binned[t] if lanes else binned, 0,
                                       t) for t in range(T)])
        g_small = torch.stack([compact(prep.gh_in[t], 0, t)
                               for t in range(T)])
        p_small = torch.stack([compact(pos[t], -1, t) for t in range(T)])
        hist_small = build_level_histogram_lanes(
            b_small, HistPrep(g_small, prep.scale, prep.mode), p_small,
            n_node, n_bin, red)
    hs = hist_small.reshape(F, n_bin, 2, T, n_node)
    # the small child of each parent: the pair's sum (the sibling's
    # slots are zero)
    small_of_parent = hs.reshape(F, n_bin, 2, T, half, 2).sum(dim=-1)
    sibling = torch.where(parent_split.reshape(T, half),
                          hist_parent.reshape(F, n_bin, 2, T, half)
                          - small_of_parent, 0.0)
    sib_child = sibling.repeat_interleave(2, dim=-1)
    return torch.where(is_small, hs, sib_child).reshape(
        F, n_bin, 2, T * n_node)


def apply_level(tree: TreeArrays, depth: int, nst: torch.Tensor,
                best: Optional[BestSplit], threshold: Optional[torch.Tensor],
                make_leaf: torch.Tensor, split_cfg: SplitConfig
                ) -> TreeArrays:
    """Write one level's decisions into a (T, n_nodes) tree stack, in
    place.  ``nst`` (T * n_node, 2), ``best`` with its raw ``threshold``
    values (None at the terminal level) and ``make_leaf`` hold the
    level's T * n_node nodes, tree outer."""
    n_node = 1 << depth
    T = tree.feature.shape[0]
    sl = slice(n_node - 1, 2 * n_node - 1)

    def lv(v):
        return v.reshape(T, n_node)
    live = lv(nst[:, 1] > 0.0)
    if depth == 0:
        live = live | (torch.arange(n_node, device=nst.device) == 0)
    # the would-be leaf weight of EVERY live node: pruning turns split
    # nodes back into leaves and needs it
    leaf_w = calc_weight(nst[:, 0], nst[:, 1], split_cfg) * split_cfg.eta
    tree.sum_hess[:, sl] = lv(nst[:, 1])
    tree.is_leaf[:, sl] = lv(make_leaf) & live
    tree.leaf_value[:, sl] = lv(leaf_w)
    if best is not None:
        keep_split = ~make_leaf
        tree.feature[:, sl] = lv(torch.where(keep_split, best.feature, -1))
        tree.cut_index[:, sl] = lv(best.cut_index)
        tree.threshold[:, sl] = lv(threshold)
        tree.default_left[:, sl] = lv(best.default_left)
        tree.gain[:, sl] = lv(torch.where(keep_split, best.gain, 0.0))
    return tree


# ---------------------------------------------------------------- traversal

def traverse_one(tree: TreeArrays, binned: torch.Tensor, max_depth: int,
                 root: Optional[torch.Tensor] = None,
                 n_roots: int = 1, router=None) -> torch.Tensor:
    """Leaf node index per row for one tree on binned data, missing
    values following the default direction (``tree.py:532-597``); with
    ``n_roots > 1`` each row starts at its ``root`` slot (slot 0 without
    ``root``).  ``router``: as in :func:`grow_trees` (column split's on
    a rank's block of features)."""
    router = bin_router if router is None else router
    N = binned.shape[0]
    dev = binned.device
    d0 = root_level(n_roots)
    if n_roots > 1 and root is not None:
        pos = torch.clamp(root.to(torch.int32), 0, n_roots - 1)
    else:
        pos = torch.zeros(N, dtype=torch.int32, device=dev)
    leaf_node = torch.zeros(N, dtype=torch.int32, device=dev)
    for d in range(d0, d0 + max_depth + 1):
        n_node = 1 << d
        base = n_node - 1
        sl = slice(base, base + n_node)
        active = pos >= 0
        node = torch.clamp(pos, 0, n_node - 1).to(torch.int64)
        f_row = tree.feature[sl][node]
        stop = active & (tree.is_leaf[sl][node] | (f_row < 0)
                         | (d == d0 + max_depth))
        leaf_node = torch.where(stop, base + pos, leaf_node)
        if d == d0 + max_depth:
            break
        go_left = router(torch.clamp_min(f_row, 0), tree.cut_index[sl][node],
                         tree.default_left[sl][node], binned)
        new_pos = 2 * pos + (~go_left).to(torch.int32)
        pos = torch.where(active & ~stop, new_pos, -1)
    return leaf_node


def _tree(stack: TreeArrays, t: int) -> TreeArrays:
    return TreeArrays(*(x[t] for x in stack))


def traverse_chunk(chunk: TreeArrays, binned: torch.Tensor, max_depth: int,
                   root: Optional[torch.Tensor] = None,
                   n_roots: int = 1, router=None) -> torch.Tensor:
    """(C, N) leaf node indices of a (C, n_nodes) chunk of trees, all C
    traversing at once (the JAX package's ``_chunk_leaves``, its
    ``_traverse_one`` vmapped over trees): each level is one batch of
    gathers and compares on a (C, N) position tensor, and row ``r`` of
    tree ``c`` follows exactly :func:`traverse_one`'s path."""
    router = bin_router if router is None else router
    C = chunk.feature.shape[0]
    N = binned.shape[0]
    dev = binned.device
    d0 = root_level(n_roots)
    if n_roots > 1 and root is not None:
        pos = torch.clamp(root.to(torch.int32), 0, n_roots - 1)[None, :] \
            .expand(C, N).contiguous()
    else:
        pos = torch.zeros((C, N), dtype=torch.int32, device=dev)
    leaf_node = torch.zeros((C, N), dtype=torch.int32, device=dev)
    for d in range(d0, d0 + max_depth + 1):
        n_node = 1 << d
        base = n_node - 1
        sl = slice(base, base + n_node)
        active = pos >= 0
        node = torch.clamp(pos, 0, n_node - 1).to(torch.int64)

        def pick(v):
            return v[:, sl].gather(1, node)
        f_row = pick(chunk.feature)
        stop = active & (pick(chunk.is_leaf) | (f_row < 0)
                         | (d == d0 + max_depth))
        leaf_node = torch.where(stop, base + pos, leaf_node)
        if d == d0 + max_depth:
            break
        go_left = router(torch.clamp_min(f_row, 0), pick(chunk.cut_index),
                         pick(chunk.default_left), binned)
        new_pos = 2 * pos + (~go_left).to(torch.int32)
        pos = torch.where(active & ~stop, new_pos, -1)
    return leaf_node


def padded_tree_count(T: int, tree_chunk: int) -> int:
    """Padded ensemble size of the chunked traversal for ``T`` trees
    (``tree.py:600-620``): below the chunk the next power of two >= T,
    capped at ``tree_chunk``; above it the next multiple of
    ``tree_chunk``."""
    if tree_chunk <= 1:
        return T
    if T <= tree_chunk:
        return min(1 << max(T - 1, 0).bit_length(), tree_chunk)
    return -(-T // tree_chunk) * tree_chunk


def predict_chunk_layout(T: int, tree_chunk: int):
    """(T_padded, chunk_size, n_chunks) of the chunked traversal
    (``tree.py:623-632``); below the chunk the whole padded ensemble is
    one chunk."""
    if tree_chunk <= 1:
        return T, 1, T
    T_pad = padded_tree_count(T, tree_chunk)
    C = T_pad if T <= tree_chunk else tree_chunk
    return T_pad, C, T_pad // C


def pad_predict_stack(stack: TreeArrays, tree_group: torch.Tensor,
                      tree_chunk: int):
    """A (T, ...) stack padded to :func:`padded_tree_count` with trees
    that are a leaf of value 0 at the root (``tree.py:635-660``).
    Returns ``(stack_padded, group_padded, n_valid)``; the traversal
    never adds a padded tree to the margin."""
    T = int(stack.feature.shape[0])
    T_pad = padded_tree_count(T, tree_chunk)
    if T_pad == T:
        return stack, tree_group, T

    def pad(x, fill=0):
        return torch.cat([x, torch.full((T_pad - T,) + tuple(x.shape[1:]),
                                        fill, dtype=x.dtype,
                                        device=x.device)])
    stack = TreeArrays(**{f: pad(getattr(stack, f), -1 if f == "feature"
                                 else 0) for f in TreeArrays._fields})
    return stack, pad(tree_group), T


def predict_margin_chunked(stack: TreeArrays, tree_group: torch.Tensor,
                           n_valid: int, binned: torch.Tensor,
                           base: torch.Tensor, max_depth: int, n_group: int,
                           root: Optional[torch.Tensor], n_roots: int,
                           tree_chunk: int, router=None) -> torch.Tensor:
    """The chunked traversal core (``tree.py:698-743``) on a stack
    already padded to a multiple of ``tree_chunk``: each chunk's leaves
    come from one :func:`traverse_chunk`, and the first ``n_valid``
    trees' leaf values go into their group's margin column in tree
    order.  ``tree_group`` is read on its own device, never on the host,
    so the whole function runs without a device-to-host read (a CUDA
    graph can hold it).

    A tree adds ``margin[:, g] + contrib`` to its own column and leaves
    the others as they are, the per-tree path's ``margin[:, g] +=``, so
    margins equal it byte for byte.  The JAX package adds
    ``contrib * one_hot(g)`` to every column, which turns a -0.0 of
    another group into +0.0: the two agree as values, not always as
    bytes."""
    N = binned.shape[0]
    T_pad = stack.feature.shape[0]
    C = tree_chunk
    margin = torch.broadcast_to(base, (N, n_group)).to(torch.float32)
    margin = margin.clone()
    sel = None
    if n_group > 1:
        sel = tree_group.to(torch.int64)[:, None] == torch.arange(
            n_group, device=tree_group.device)                 # (T_pad, K)
        sel = sel.to(binned.device)
    for s in range(0, min(T_pad, n_valid), C):
        chunk = TreeArrays(*(x[s:s + C] for x in stack))
        leaves = traverse_chunk(chunk, binned, max_depth, root, n_roots,
                                router)
        contribs = table_lookup(chunk.leaf_value, leaves)        # (C, N)
        for c in range(min(C, n_valid - s)):
            if sel is None:
                margin = margin + contribs[c][:, None]
            else:
                margin = torch.where(sel[s + c], margin
                                     + contribs[c][:, None], margin)
    return margin


def predict_margin_binned(stack: TreeArrays, tree_group: torch.Tensor,
                          binned: torch.Tensor, base: torch.Tensor,
                          max_depth: int, n_group: int,
                          root: Optional[torch.Tensor] = None,
                          n_roots: int = 1,
                          tree_chunk: int = 0, router=None) -> torch.Tensor:
    """(N, n_group) margins: ``base`` plus every tree's leaf values added
    to its group's column, in tree order (the JAX scan's order,
    ``tree.py:746-778``).  ``tree_chunk > 1`` pads the stack to the
    :func:`padded_tree_count` ladder and traverses ``tree_chunk`` trees
    at once (:func:`predict_margin_chunked`); ``tree_chunk <= 1`` runs
    the trees one by one, the reference path, which reads the group ids
    on the host.  Both give the same bytes."""
    if tree_chunk > 1:
        _, C, _ = predict_chunk_layout(int(stack.feature.shape[0]),
                                       tree_chunk)
        stack, tree_group, n_valid = pad_predict_stack(stack, tree_group,
                                                       tree_chunk)
        return predict_margin_chunked(stack, tree_group, n_valid, binned,
                                      base, max_depth, n_group, root,
                                      n_roots, C, router)
    N = binned.shape[0]
    margin = torch.broadcast_to(base, (N, n_group)).to(torch.float32)
    margin = margin.clone()
    groups = tree_group.tolist()
    for t in range(stack.feature.shape[0]):
        tree = _tree(stack, t)
        leaf = traverse_one(tree, binned, max_depth, root,
                            n_roots, router).to(torch.int64)
        margin[:, groups[t]] += table_lookup(tree.leaf_value, leaf)
    return margin


def predict_margin_fused(stack: TreeArrays, tree_group: torch.Tensor,
                         X: torch.Tensor, cut_values: torch.Tensor,
                         base: torch.Tensor, max_depth: int, n_group: int,
                         root: Optional[torch.Tensor] = None,
                         n_roots: int = 1,
                         tree_chunk: int = 0,
                         n_valid: Optional[int] = None) -> torch.Tensor:
    """Quantize and traverse in one function (``tree.py:822-856``): raw
    f32 rows (NaN = missing) and the cut matrix in, margins out.  The
    quantization is :func:`~xgboost_tpu_torch.binning.bin_dense_device`
    itself, so the margins are those of quantize-then-
    :func:`predict_margin_binned` on the same rows, byte for byte.

    ``n_valid`` says that ``stack`` and ``tree_group`` are already
    padded by :func:`pad_predict_stack` and hold that many real trees:
    the serving engine pads once per model and captures this function
    per row bucket, so no padding runs inside the graph."""
    from xgboost_tpu_torch.binning import bin_dense_device
    binned = bin_dense_device(X, cut_values)
    if n_valid is not None and tree_chunk > 1:
        _, C, _ = predict_chunk_layout(n_valid, tree_chunk)
        return predict_margin_chunked(stack, tree_group, n_valid, binned,
                                      base, max_depth, n_group, root,
                                      n_roots, C)
    return predict_margin_binned(stack, tree_group, binned, base,
                                 max_depth, n_group, root, n_roots,
                                 tree_chunk)


def predict_leaf_binned(stack: TreeArrays, binned: torch.Tensor,
                        max_depth: int, root: Optional[torch.Tensor] = None,
                        n_roots: int = 1,
                        tree_chunk: int = 0, router=None) -> torch.Tensor:
    """(N, T) leaf node index per tree, every group's trees in tree
    order (``tree.py:889-906``); ``tree_chunk > 1`` traverses chunks of
    trees at once, padded like the margins, and drops the padded
    columns."""
    T = int(stack.feature.shape[0])
    if tree_chunk > 1:
        _, C, _ = predict_chunk_layout(T, tree_chunk)
        group = torch.zeros(T, dtype=torch.int32)   # layout only
        stack, _, _ = pad_predict_stack(stack, group, tree_chunk)
        leaves = torch.cat([traverse_chunk(
            TreeArrays(*(x[s:s + C] for x in stack)), binned, max_depth,
            root, n_roots, router)
            for s in range(0, stack.feature.shape[0], C)])
        return leaves[:T].T
    leaves = [traverse_one(_tree(stack, t), binned, max_depth, root,
                           n_roots, router)
              for t in range(T)]
    return torch.stack(leaves, dim=1)
