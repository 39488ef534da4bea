"""Tree updaters beyond growth (port of ``xgboost_tpu/models/updaters.py``:
the updater registry, the prune updater and the refresh updater).

- ``grow_histmaker``: the histogram grower of :mod:`.tree`;
- ``grow_colmaker``: exact greedy growth on raw values (:mod:`.colmaker`);
- ``grow_skmaker``: the histogram grower with the quantile-summary split
  finder of :mod:`.skmaker`;
- ``prune``: post-prunes splits with ``loss_chg < gamma`` bottom-up;
- ``refresh``: recomputes every tree's node sums, leaf values and gains
  on (new) data, keeping its structure (:func:`refresh_trees`);
- ``sync``: broadcasts trees from rank 0 in the reference, a no-op on one
  device.

``distcol`` (column-split growth) comes with distributed training
(ROADMAP.md section 1 item 13) and raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.models.tree import (TreeArrays, bin_of_feature,
                                           root_level)
from xgboost_tpu_torch.ops.histogram import node_stats
from xgboost_tpu_torch.ops.split import SplitConfig, calc_gain, calc_weight

KNOWN_UPDATERS = ("grow_colmaker", "grow_histmaker", "grow_skmaker",
                  "prune", "refresh", "distcol", "sync")
PORTED_UPDATERS = ("grow_histmaker", "grow_colmaker", "grow_skmaker",
                   "prune", "refresh", "sync")


def parse_updaters(updater: str) -> Tuple[str, ...]:
    seq = tuple(u.strip() for u in updater.split(",") if u.strip())
    for u in seq:
        if u not in KNOWN_UPDATERS:
            raise ValueError(
                f"unknown updater {u!r} (known: {KNOWN_UPDATERS})")
        if u not in PORTED_UPDATERS:
            raise NotImplementedError(
                f"updater {u!r} is column-split distributed growth: "
                "ROADMAP.md section 1 item 13")
    return seq


def prune_tree(tree: TreeArrays, gamma: float, n_roots: int = 1
               ) -> Tuple[TreeArrays, np.ndarray]:
    """Bottom-up post-prune (reference TreePruner::TryPruneLeaf,
    updater_prune-inl.hpp:42-72): a split node whose children are both
    leaves and whose loss_chg < gamma becomes a leaf, recursively.

    Host-side numpy (trees are tiny).  Returns (pruned tree, resolve
    [n_nodes] mapping every node to its surviving self-or-ancestor leaf,
    to re-target grow-time row -> leaf assignments)."""
    feature = tree.feature.cpu().numpy().copy()
    is_leaf = tree.is_leaf.cpu().numpy().copy()
    gain = tree.gain.cpu().numpy().copy()
    n = feature.shape[0]

    def leaf_like(c: int) -> bool:
        return c >= n or is_leaf[c] or feature[c] < 0

    for nid in range(n - 1, -1, -1):  # deepest first
        if is_leaf[nid] or feature[nid] < 0:
            continue
        left, right = 2 * nid + 1, 2 * nid + 2
        if leaf_like(left) and leaf_like(right) and gain[nid] < gamma:
            is_leaf[nid] = True
            feature[nid] = -1
            gain[nid] = 0.0

    resolve = np.arange(n, dtype=np.int32)
    # the levels above a multi-root tree's root slots are placeholders
    # that never split: a root slot must not resolve into them
    start_real = (1 << root_level(n_roots)) - 1
    for nid in range(1, n):  # a node under a pruned ancestor -> ancestor
        parent = (nid - 1) // 2
        if parent < start_real:
            continue
        if is_leaf[resolve[parent]] or feature[resolve[parent]] < 0:
            resolve[nid] = resolve[parent]

    dev = tree.feature.device
    pruned = tree._replace(feature=torch.as_tensor(feature, device=dev),
                           is_leaf=torch.as_tensor(is_leaf, device=dev),
                           gain=torch.as_tensor(gain, device=dev))
    return pruned, resolve


# ----------------------------------------------------------------- refresh
def refresh_trees(stack: TreeArrays, binned: torch.Tensor, gh: torch.Tensor,
                  cfg: SplitConfig, max_depth: int,
                  row_valid: Optional[torch.Tensor] = None,
                  root: Optional[torch.Tensor] = None,
                  n_roots: int = 1) -> TreeArrays:
    """Recompute T trees' node sums, leaf values and gains on (new) data
    (``updaters.py:103-169``, the reference's TreeRefresher): each row
    adds its gradients at every node on its root-to-leaf path, the leaf
    included, and then ``leaf_value = calc_weight * eta``, ``sum_hess =
    H``, and a split node's ``gain = gain(L) + gain(R) - gain(self)``.
    Structure is kept.

    stack (T, n_nodes) trees; binned (N, F) bins; gh (T, N, 2) each
    tree's gradients; ``row_valid`` (N,) masks rows; a multi-root tree
    starts row r at ``(1 << root_level(n_roots)) - 1 + root[r]``.  The
    sums of one level are one K2 call for all T trees: at step i a row's
    position is its node minus the level's first id, -1 once it is
    parked at a leaf.  On the CPU the sums run in row order, the order
    of the JAX package's scatter, so they are its bits."""
    T, n_nodes = stack.feature.shape
    N = binned.shape[0]
    dev = binned.device
    d0 = root_level(n_roots)
    gh_used = gh.to(torch.float32)
    if row_valid is not None:
        gh_used = gh_used * row_valid[None, :, None].to(torch.float32)
    gh_used = gh_used.contiguous()
    node = torch.zeros((T, N), dtype=torch.int64, device=dev)
    if n_roots > 1:
        node = node + (1 << d0) - 1
        if root is not None:
            node = node + torch.clamp(root.to(torch.int64), 0,
                                      n_roots - 1)[None, :]
    parked = torch.zeros((T, N), dtype=torch.bool, device=dev)
    parts = [torch.zeros((T, (1 << d0) - 1, 2), dtype=torch.float32,
                         device=dev)]
    for i in range(max_depth + 1):
        first = (1 << (d0 + i)) - 1
        n_node = first + 1
        pos = torch.where(parked, -1, node - first).to(torch.int32)
        parts.append(node_stats(gh_used, pos.contiguous(), n_node))
        if i == max_depth:
            break
        f = stack.feature.gather(1, node)
        leaf = stack.is_leaf.gather(1, node) | (f < 0)
        b = bin_of_feature(binned, torch.clamp_min(f, 0))
        go_left = torch.where(b == 0, stack.default_left.gather(1, node),
                              b <= stack.cut_index.gather(1, node) + 1)
        node = torch.where(leaf, node, 2 * node + 2
                           - go_left.to(torch.int64))
        parked = parked | leaf
    acc = torch.cat(parts, dim=1)                          # (T, n_nodes, 2)
    G, H = acc[..., 0], acc[..., 1]
    new_weight = calc_weight(G, H, cfg) * cfg.eta
    left = torch.arange(n_nodes, device=dev) * 2 + 1
    has_l, has_r = left < n_nodes, left + 1 < n_nodes
    li = torch.clamp_max(left, n_nodes - 1)
    ri = torch.clamp_max(left + 1, n_nodes - 1)
    GL = torch.where(has_l, G[:, li], 0.0)
    HL = torch.where(has_l, H[:, li], 0.0)
    GR = torch.where(has_r, G[:, ri], 0.0)
    HR = torch.where(has_r, H[:, ri], 0.0)
    split_gain = (calc_gain(GL, HL, cfg) + calc_gain(GR, HR, cfg)
                  - calc_gain(G, H, cfg))
    is_split = ~stack.is_leaf & (stack.feature >= 0)
    return stack._replace(leaf_value=new_weight, sum_hess=H,
                          gain=torch.where(is_split, split_gain, 0.0))


def refresh_tree(tree: TreeArrays, binned: torch.Tensor, gh: torch.Tensor,
                 cfg: SplitConfig, max_depth: int,
                 row_valid: Optional[torch.Tensor] = None,
                 root: Optional[torch.Tensor] = None,
                 n_roots: int = 1) -> TreeArrays:
    """One tree's refresh (``updaters.py:103-169``): :func:`refresh_trees`
    with T = 1; gh (N, 2)."""
    out = refresh_trees(TreeArrays(*(x[None] for x in tree)), binned,
                        gh[None], cfg, max_depth, row_valid, root, n_roots)
    return TreeArrays(*(x[0] for x in out))


def prune_stack(stack: TreeArrays, gamma: float,
                n_roots: int = 1) -> Tuple[TreeArrays, List[np.ndarray]]:
    """:func:`prune_tree` on each tree of a (T, n_nodes) stack: (the
    pruned stack, each tree's ``resolve``)."""
    pruned, resolves = [], []
    for t in range(stack.feature.shape[0]):
        tree, resolve = prune_tree(TreeArrays(*(x[t] for x in stack)),
                                   gamma, n_roots)
        pruned.append(tree)
        resolves.append(resolve)
    return TreeArrays(*(torch.stack(xs) for xs in zip(*pruned))), resolves
