"""Tree updaters beyond growth (port of ``xgboost_tpu/models/updaters.py``:
the updater registry and the prune updater).

``grow_histmaker`` is the grower of :mod:`.tree`; ``prune`` post-prunes
splits with ``loss_chg < gamma`` bottom-up.  The other updaters of the
reference (``grow_colmaker``, ``grow_skmaker``, ``refresh``,
``distcol``, ``sync``) are not ported yet (ROADMAP.md section 1 items 9
and 13).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from xgboost_tpu_torch.models.tree import TreeArrays, root_level

KNOWN_UPDATERS = ("grow_colmaker", "grow_histmaker", "grow_skmaker",
                  "prune", "refresh", "distcol", "sync")
PORTED_UPDATERS = ("grow_histmaker", "prune")


def parse_updaters(updater: str) -> Tuple[str, ...]:
    seq = tuple(u.strip() for u in updater.split(",") if u.strip())
    for u in seq:
        if u not in KNOWN_UPDATERS:
            raise ValueError(
                f"unknown updater {u!r} (known: {KNOWN_UPDATERS})")
        if u not in PORTED_UPDATERS:
            raise NotImplementedError(
                f"updater {u!r} is not ported yet (ROADMAP.md section 1)")
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
