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

The JAX package reads per-node values per row with one-hot compare-sums
(gathers serialize on a TPU) for tables of up to 1024 entries, and
gathers past that (``tree.py:121-134``).  Here they are gathers:
integers come out the same, and :func:`table_lookup` adds ``+ 0.0`` to
float values from small tables, which makes a -0 a +0 exactly as the
one-hot sum does and changes nothing else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from xgboost_tpu_torch.ops.histogram import (build_level_histogram,
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
    """Static configuration of tree growth."""
    split: SplitConfig
    max_depth: int
    n_bin: int                  # histogram bins B (incl. missing bin 0)
    hist_precision: str = "auto"


def tree_capacity(max_depth: int) -> int:
    return 2 ** (max_depth + 1) - 1


def empty_tree(max_depth: int, n_tree: int, device=None) -> TreeArrays:
    """A (n_tree, n_nodes) stack of all-unused arrays for a
    depth-``max_depth`` perfect layout."""
    shape = (n_tree, tree_capacity(max_depth))
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


def grow_tree(binned: torch.Tensor, gh: torch.Tensor,
              cut_values: torch.Tensor, n_cuts: torch.Tensor,
              cfg: GrowConfig, row_valid: Optional[torch.Tensor] = None
              ) -> Tuple[TreeArrays, torch.Tensor, torch.Tensor]:
    """Grow one tree level by level (``tree.py:260-465``, single root):
    :func:`grow_trees` for T = 1, with the one-tree histogram K1.

    binned (N, F) u8 bins (0 = missing); gh (N, 2) f32; cut_values
    (F, C) f32 and n_cuts (F,) int32 on the same device; row_valid
    optional (N,) bool (rows outside it add nothing and reach no leaf).

    Returns (tree, row_leaf (N,) int32 leaf node per row, row_val (N,)
    f32 the row's leaf value, recorded when the row is parked)."""
    trees, row_leaf, row_val = grow_trees(binned, gh[None], cut_values,
                                          n_cuts, cfg, row_valid)
    return TreeArrays(*(x[0] for x in trees)), row_leaf[0], row_val[0]


def grow_trees(binned: torch.Tensor, gh: torch.Tensor,
               cut_values: torch.Tensor, n_cuts: torch.Tensor,
               cfg: GrowConfig, row_valid: Optional[torch.Tensor] = None
               ) -> Tuple[TreeArrays, torch.Tensor, torch.Tensor]:
    """Grow T trees together on shared bins, each on its own gradients
    ``gh`` (T, N, 2) (the JAX package's ``jax.vmap`` of ``grow_tree``
    over an ensemble round, ``gbtree.py:681``).

    Per level: one histogram of all T trees, ``(F, B, 2, T * n_node)``
    tree outer (K3, or K1 when T = 1); one split search over the
    ``T * n_node`` columns, which are independent (the prefix sum runs
    along the bins only), so each tree's splits are bitwise those of a
    solo search; routing gathers ``binned[r, feature[t, node]]`` per
    tree.  Returns (tree stack (T, n_nodes), row_leaf (T, N) int32,
    row_val (T, N) f32).

    Lanes: with binned (L, N, F), the T = L trees are L tenants' (the
    JAX package's ``jax.vmap`` of the round scan over lanes,
    ``gbtree.py:275-318``), each with its own cut_values (L, F, W),
    n_cuts (L, F) and row_valid (L, N) (pad rows and pad lanes False).
    The histogram is K4's ``(F, B, 2, L * n_node)``, the split search
    reads each column's own cut count, thresholds come from each lane's
    own cuts and routing gathers ``binned[l, r, feature[l, node]]``."""
    lanes = binned.dim() == 3
    T, N = gh.shape[:2]
    D = cfg.max_depth
    dev = binned.device
    gh_used = gh
    pos = torch.zeros((T, N), dtype=torch.int32, device=dev)
    if row_valid is not None:
        rv = row_valid if lanes else row_valid[None, :]
        gh_used = gh * rv[..., None].to(gh.dtype)
        pos = torch.where(rv, pos, -1)

    tree = empty_tree(D, T, dev)
    row_leaf = torch.zeros((T, N), dtype=torch.int32, device=dev)
    row_val = torch.zeros((T, N), dtype=torch.float32, device=dev)
    prep = prepare_hist(gh_used[0] if T == 1 and not lanes else gh_used,
                        cfg.hist_precision)
    if lanes:
        F, W = cut_values.shape[1:]
        flat_cuts = cut_values.reshape(T * F, W)
        lane_row = (torch.arange(T, dtype=torch.int64, device=dev)
                    * F)[:, None]                    # lane l's first row
    prev = None  # (best, nst, do_split) of the previous level

    for depth in range(D + 1):
        n_node = 1 << depth
        base = n_node - 1
        if depth == D:
            # terminal level: node stats from the parent's split (left =
            # the winner's left sums, right = parent - left)
            if prev is not None:
                p_best, p_nst, p_split = prev
                gl = torch.where(p_split, p_best.left_g, 0.0)
                hl = torch.where(p_split, p_best.left_h, 0.0)
                gr = torch.where(p_split, p_nst[:, 0] - p_best.left_g, 0.0)
                hr = torch.where(p_split, p_nst[:, 1] - p_best.left_h, 0.0)
                nst = torch.stack(
                    [torch.stack([gl, gr], 1).reshape(-1),
                     torch.stack([hl, hr], 1).reshape(-1)], dim=1)
            else:
                nst = node_stats(gh_used, pos, n_node,
                                 cfg.hist_precision).reshape(T * n_node, 2)
            make_leaf = torch.ones(T * n_node, dtype=torch.bool, device=dev)
            best = thr = None
        else:
            if lanes:
                hist = build_level_histogram_lanes(binned, prep, pos,
                                                   n_node, cfg.n_bin)
            elif T == 1:
                hist = build_level_histogram(binned, prep, pos[0], n_node,
                                             cfg.n_bin)
            else:
                hist = build_level_histogram_batched(binned, prep, pos,
                                                     n_node, cfg.n_bin)
            nst = stats_from_histogram_native(hist)     # (T * n_node, 2)
            if lanes:
                # each column's own lane's cut counts: (F, L * n_node)
                col_cuts = n_cuts.T[:, :, None].expand(
                    -1, T, n_node).reshape(-1, T * n_node)
                best = find_best_splits_native(hist, nst, col_cuts,
                                               cfg.split)
                cut_row = (lane_row + best.feature.reshape(T, n_node)
                           ).reshape(-1)
                thr = flat_cuts[cut_row, best.cut_index.to(torch.int64)]
            else:
                best = find_best_splits_native(hist, nst, n_cuts,
                                               cfg.split)
                thr = cut_values[best.feature.to(torch.int64),
                                 best.cut_index.to(torch.int64)]
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
            b = bin_of_feature(binned, per_row(best.feature))
            go_left = torch.where(b == 0, per_row(best.default_left),
                                  b <= per_row(best.cut_index) + 1)
        row_leaf = torch.where(row_is_leaf, base + pos, row_leaf)
        row_val = torch.where(row_is_leaf, val_row, row_val)
        if best is not None:
            new_pos = 2 * pos + (~go_left).to(torch.int32)
            pos = torch.where(active & ~row_is_leaf, new_pos, -1)
    return tree, row_leaf, row_val


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

def traverse_one(tree: TreeArrays, binned: torch.Tensor,
                 max_depth: int) -> torch.Tensor:
    """Leaf node index per row for one tree on binned data, missing
    values following the default direction (``tree.py:532-597``)."""
    N = binned.shape[0]
    dev = binned.device
    pos = torch.zeros(N, dtype=torch.int32, device=dev)
    leaf_node = torch.zeros(N, dtype=torch.int32, device=dev)
    for d in range(max_depth + 1):
        n_node = 1 << d
        base = n_node - 1
        sl = slice(base, base + n_node)
        active = pos >= 0
        node = torch.clamp(pos, 0, n_node - 1).to(torch.int64)
        f_row = tree.feature[sl][node]
        stop = active & (tree.is_leaf[sl][node] | (f_row < 0)
                         | (d == max_depth))
        leaf_node = torch.where(stop, base + pos, leaf_node)
        if d == max_depth:
            break
        b = bin_of_feature(binned, torch.clamp_min(f_row, 0))
        go_left = torch.where(b == 0, tree.default_left[sl][node],
                              b <= tree.cut_index[sl][node] + 1)
        new_pos = 2 * pos + (~go_left).to(torch.int32)
        pos = torch.where(active & ~stop, new_pos, -1)
    return leaf_node


def _tree(stack: TreeArrays, t: int) -> TreeArrays:
    return TreeArrays(*(x[t] for x in stack))


def predict_margin_binned(stack: TreeArrays, tree_group: torch.Tensor,
                          binned: torch.Tensor, base: torch.Tensor,
                          max_depth: int, n_group: int) -> torch.Tensor:
    """(N, n_group) margins: ``base`` plus every tree's leaf values added
    to its group's column, in tree order (the JAX scan's order,
    ``tree.py:676-695``)."""
    N = binned.shape[0]
    margin = torch.broadcast_to(base, (N, n_group)).to(torch.float32)
    margin = margin.clone()
    groups = tree_group.tolist()
    for t in range(stack.feature.shape[0]):
        tree = _tree(stack, t)
        leaf = traverse_one(tree, binned, max_depth).to(torch.int64)
        margin[:, groups[t]] += table_lookup(tree.leaf_value, leaf)
    return margin


def predict_leaf_binned(stack: TreeArrays, binned: torch.Tensor,
                        max_depth: int) -> torch.Tensor:
    """(N, T) leaf node index per tree, every group's trees in tree
    order."""
    leaves = [traverse_one(_tree(stack, t), binned, max_depth)
              for t in range(stack.feature.shape[0])]
    return torch.stack(leaves, dim=1)
