"""GBTree: the gradient-boosted tree ensemble (port of
``xgboost_tpu/models/gbtree.py``, the single-device path).

Trees are fixed-shape tensors on the booster's device.  A boosting round
grows ``num_output_group x num_parallel_tree`` trees together
(:func:`~.tree.grow_trees`; tree j of a round belongs to group
``j // num_parallel_tree``) and returns the (N, K) margin delta read off
the grow-time leaf positions, the reference's prediction-buffer
shortcut.  The JAX package's fused multi-round ``lax.scan`` becomes the
learner's plain loop over rounds, which reads nothing back to the host.
:func:`scan_rounds_lanes` is the lane-stacked counterpart of the JAX
package's ``_scan_rounds_lanes_impl``: L tenant boosters' rounds of a
segment in one loop, one K4 launch per level for all of them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.binning import CutMatrix
from xgboost_tpu_torch.config import TrainParam
from xgboost_tpu_torch.models.tree import (GrowConfig, TreeArrays,
                                           grow_trees, predict_leaf_binned,
                                           predict_margin_binned,
                                           table_lookup)
from xgboost_tpu_torch.models.updaters import parse_updaters, prune_tree
from xgboost_tpu_torch.ops.split import SplitConfig

_NUMPY_DTYPES = {"feature": np.int32, "cut_index": np.int32,
                 "threshold": np.float32, "default_left": np.bool_,
                 "is_leaf": np.bool_, "leaf_value": np.float32,
                 "gain": np.float32, "sum_hess": np.float32}


def make_grow_config(p: TrainParam, n_bin: int) -> GrowConfig:
    """The grower's configuration; options not ported yet raise."""
    sampled = [name for name in ("subsample", "colsample_bytree",
                                 "colsample_bylevel")
               if getattr(p, name) < 1.0]
    if sampled:
        raise NotImplementedError(
            f"{', '.join(sampled)} < 1 needs the threefry port: ROADMAP.md "
            "section 1 item 4")
    if p.num_roots > 1:
        raise NotImplementedError(
            "num_roots > 1 (multi-root trees): ROADMAP.md section 1 item 4")
    if "hist_subtraction" in p.extras:
        raise NotImplementedError(
            "hist_subtraction: ROADMAP.md section 1 item 4")
    parse_updaters(p.updater)
    split = SplitConfig(
        reg_lambda=p.reg_lambda, reg_alpha=p.reg_alpha,
        max_delta_step=p.max_delta_step, min_child_weight=p.min_child_weight,
        gamma=p.gamma, eta=p.eta, default_direction=p.default_direction)
    return GrowConfig(split=split, max_depth=p.max_depth, n_bin=n_bin,
                      hist_precision=p.hist_precision)


def scan_rounds_lanes(binned: torch.Tensor, margin: torch.Tensor,
                      label: torch.Tensor, weight: torch.Tensor,
                      cut_values: torch.Tensor, n_cuts: torch.Tensor,
                      row_valid: torch.Tensor, *, n_rounds: int,
                      cfg: GrowConfig, grad_fn
                      ) -> Tuple[torch.Tensor, List[TreeArrays]]:
    """``n_rounds`` boosting rounds of L same-shape tenant lanes at once
    (``gbtree.py:275-318``, ``_scan_rounds_lanes_impl``): (L, N, F)
    bins, (L, N, 1) margins, (L, N) labels / weights / row_valid (pad
    rows and pad lanes False), (L, F, W) cut values and (L, F) cut
    counts.  ``grad_fn(margin (M, 1), label (M,), weight (M,))`` is the
    lanes' shared objective gradient, run once over all L * N rows.
    Each round grows one tree per lane through :func:`grow_trees` (one
    K4 launch per level) and adds its leaf values to the lane's margin,
    exactly as a solo round of :meth:`GBTree.do_boost` does.  Reads
    nothing back to the host.

    Returns (final margins (L, N, 1), one (L, n_nodes) tree stack per
    round)."""
    L, N, K = margin.shape
    valid = row_valid.to(torch.float32)
    stacks = []
    for _ in range(n_rounds):
        gh = grad_fn(margin.reshape(L * N, K), label.reshape(-1),
                     weight.reshape(-1)).reshape(L, N, K, 2)
        trees, _, row_val = grow_trees(binned, gh[:, :, 0, :], cut_values,
                                       n_cuts, cfg, row_valid)
        margin = margin + (row_val * valid)[..., None]
        stacks.append(trees)
    return margin, stacks


def unstack_lane_flats(stacks: List[TreeArrays],
                       n_lane: int) -> List[TreeArrays]:
    """Per-lane flat ``(n_rounds, n_nodes)`` tree stacks from a
    segment's per-round ``(L, n_nodes)`` stacks (``gbtree.py:85``): the
    rounds stacked once per field, then each lane a view."""
    flat = TreeArrays(*(torch.stack(xs, dim=1) for xs in zip(*stacks)))
    return [TreeArrays(*(x[i] for x in flat)) for i in range(n_lane)]


class GBTree:
    """Tree ensemble state and boosting step (reference IGradBooster)."""

    def __init__(self, param: TrainParam, cuts: CutMatrix,
                 device: torch.device):
        self.param = param
        self.cuts = cuts
        self.device = device
        self.cfg = make_grow_config(param, cuts.max_bin)
        self.cut_values_dev = torch.as_tensor(cuts.cut_values).to(device)
        self.n_cuts_dev = torch.as_tensor(cuts.n_cuts).to(device)
        self._parts: List[TreeArrays] = []   # (t_i, n_nodes) stacks
        self.tree_group: List[int] = []
        self._stack_cache: Optional[Tuple[int, TreeArrays,
                                          torch.Tensor]] = None

    @property
    def num_trees(self) -> int:
        return len(self.tree_group)

    @property
    def num_boosted_rounds(self) -> int:
        return self.num_trees // self.trees_per_round

    @property
    def n_group(self) -> int:
        return max(1, self.param.num_output_group)

    @property
    def trees_per_round(self) -> int:
        return self.n_group * max(1, self.param.num_parallel_tree)

    def do_boost(self, binned: torch.Tensor, gh: torch.Tensor,
                 row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One boosting round: grow the round's T = K x num_parallel_tree
        trees on ``gh`` (N, K, 2) together, prune each when ``gamma > 0``,
        append them.  Returns the (N, K) margin delta: each group's trees
        added in tree order (``gbtree.py:681-757``)."""
        npar = max(1, self.param.num_parallel_tree)
        T, K = self.trees_per_round, self.n_group
        group = [j // npar for j in range(T)]
        # (T, N, 2) from views: no index tensor sent to the device
        gh_t = torch.stack([gh[:, g, :] for g in group])
        trees, row_leaf, ds = grow_trees(binned, gh_t, self.cut_values_dev,
                                         self.n_cuts_dev, self.cfg,
                                         row_valid)
        if "prune" in parse_updaters(self.param.updater) \
                and self.param.gamma > 0.0:
            pruned, ds = [], list(ds)
            for j in range(T):
                tree, resolve = prune_tree(TreeArrays(*(x[j] for x in trees)),
                                           self.param.gamma)
                ds[j] = table_lookup(tree.leaf_value[torch.as_tensor(
                    resolve, dtype=torch.int64, device=binned.device)],
                    row_leaf[j])
                pruned.append(tree)
            trees = TreeArrays(*(torch.stack(xs) for xs in zip(*pruned)))
        if row_valid is not None:
            ds = [d * row_valid.to(d.dtype) for d in ds]
        self._parts.append(trees)
        self.tree_group.extend(group)
        self._stack_cache = None
        if T == 1:
            # the JAX package returns a lone tree's delta as it is; its
            # batched path adds into zeros, which makes a -0 a +0
            return ds[0][:, None]
        delta = torch.zeros((binned.shape[0], K), dtype=torch.float32,
                            device=binned.device)
        for j in range(T):
            delta[:, group[j]] += ds[j]
        return delta

    def absorb_round_stacks(self, flat: TreeArrays, n_rounds: int) -> None:
        """Install one lane's flat ``(n_rounds * T, n_nodes)`` tree stack
        as this booster's newest trees (``gbtree.py:950``): the lane
        dispatcher grew every lane's trees together, and each tenant appends
        its own, as :meth:`do_boost` appends a round's."""
        npar = max(1, self.param.num_parallel_tree)
        self._parts.append(flat)
        self.tree_group.extend(j // npar for _ in range(n_rounds)
                               for j in range(self.trees_per_round))
        self._stack_cache = None

    def _stack(self, ntree_limit: int = 0) -> Tuple[TreeArrays, torch.Tensor]:
        """The first ``ntree_limit`` trees (all when <= 0, clamped to the
        ensemble) as a (T, n_nodes) stack."""
        T = self.num_trees if ntree_limit <= 0 else min(int(ntree_limit),
                                                        self.num_trees)
        if T <= 0:
            raise ValueError("model is empty")
        if self._stack_cache is None or self._stack_cache[0] != self.num_trees:
            if len(self._parts) > 1:
                self._parts = [TreeArrays(*(torch.cat(xs) for xs in
                                            zip(*self._parts)))]
            group = torch.as_tensor(self.tree_group, dtype=torch.int32)
            self._stack_cache = (self.num_trees, self._parts[0], group)
        _, stack, group = self._stack_cache
        return TreeArrays(*(x[:T] for x in stack)), group[:T]

    def predict_margin(self, binned: torch.Tensor, base: torch.Tensor,
                       ntree_limit: int = 0) -> torch.Tensor:
        stack, group = self._stack(ntree_limit)
        return predict_margin_binned(stack, group, binned, base,
                                     self.cfg.max_depth, self.n_group)

    def predict_incremental(self, binned: torch.Tensor, margin: torch.Tensor,
                            first_tree: int, n_trees: int) -> torch.Tensor:
        """``margin`` plus trees ``[first_tree, first_tree + n_trees)``,
        their contributions summed from 0 first (``gbtree.py:1103-1128``)."""
        stack, group = self._stack(first_tree + n_trees)
        part = TreeArrays(*(x[first_tree:] for x in stack))
        zero = torch.zeros((), dtype=torch.float32, device=binned.device)
        return predict_margin_binned(part, group[first_tree:], binned, zero,
                                     self.cfg.max_depth,
                                     self.n_group) + margin

    def predict_leaf(self, binned: torch.Tensor,
                     ntree_limit: int = 0) -> torch.Tensor:
        stack, _ = self._stack(ntree_limit)
        return predict_leaf_binned(stack, binned, self.cfg.max_depth)

    def get_state(self) -> dict:
        """The model-file arrays, numpy (``gbtree.py:1145-1152``)."""
        stack, group = self._stack(0)
        state = {f"tree_{f}": getattr(stack, f).cpu().numpy().astype(
            _NUMPY_DTYPES[f]) for f in TreeArrays._fields}
        state["tree_group_arr"] = group.numpy().astype(np.int32)
        state["cut_values"] = self.cuts.cut_values
        state["cut_n"] = self.cuts.n_cuts
        return state

    @classmethod
    def from_state(cls, param: TrainParam, state: dict,
                   device: torch.device) -> "GBTree":
        cuts = CutMatrix(np.asarray(state["cut_values"], np.float32),
                         np.asarray(state["cut_n"], np.int32))
        gbt = cls(param, cuts, device)
        stack = TreeArrays(**{f: torch.as_tensor(np.array(
            state[f"tree_{f}"], _NUMPY_DTYPES[f])).to(device)
            for f in TreeArrays._fields})
        groups = [int(g) for g in np.asarray(state["tree_group_arr"])]
        if stack.feature.shape[0]:
            gbt._parts = [stack]
        gbt.tree_group = groups
        return gbt
