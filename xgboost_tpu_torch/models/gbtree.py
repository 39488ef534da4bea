"""GBTree: the gradient-boosted tree ensemble (port of
``xgboost_tpu/models/gbtree.py``, the single-device path).

Trees are fixed-shape tensors on the booster's device.  A boosting round
grows ``num_output_group x num_parallel_tree`` trees together
(:func:`~.tree.grow_trees`; tree j of a round belongs to group
``j // num_parallel_tree`` and draws its samples from
``fold_in(round_key, j)``) and returns the (N, K) margin delta read off
the grow-time leaf positions, the reference's prediction-buffer
shortcut.  The JAX package's fused multi-round ``lax.scan`` becomes the
learner's plain loop over rounds, which reads nothing back to the host.
:func:`scan_rounds_lanes` is the lane-stacked counterpart of the JAX
package's ``_scan_rounds_lanes_impl``: L tenant boosters' rounds of a
segment in one loop, one K4 launch per level for all of them.

Row and column sampling, multi-root trees (``num_roots``) and histogram
subtraction (the ``XGBTPU_HIST_SUBTRACTION=1`` switch; a
``hist_subtraction`` parameter is ignored with the JAX package's
warning) follow the JAX grow config, :func:`make_grow_config`.

``updater=grow_colmaker`` makes an exact-mode ensemble (``exact_raw``):
its trees grow one by one on raw values (:mod:`.colmaker`) and predict
from raw values.  ``grow_skmaker`` swaps the grower's split finder for
the skmaker finder (:mod:`.skmaker`), and :meth:`GBTree.do_refresh` is
the ``refresh`` updater over every tree at once.

Under row split (``dsplit=row``) :meth:`GBTree.do_boost`,
:meth:`~GBTree.do_boost_paged` and :meth:`~GBTree.do_refresh` take the
rank's :class:`~xgboost_tpu_torch.parallel.mesh.DataMesh` (``mesh=``)
and grow on its block of rows through the ``hist_reduce`` seam
(:mod:`xgboost_tpu_torch.parallel.dp`); ``grow_colmaker`` is then the
histogram grower on the cuts of every distinct value
(``compute_cuts_exact``), as in the JAX package.  Under column split
(``dsplit=col``) they take the rank's
:class:`~xgboost_tpu_torch.parallel.colsplit.ColSplit` (``col=``) and
grow one tree at a time on its block of the features, K1 (or the exact
grower) on every row, as the JAX package does on its column mesh.
"""

from __future__ import annotations

import os
import sys
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch import random as prng
from xgboost_tpu_torch.binning import CutMatrix
from xgboost_tpu_torch.config import TrainParam
from xgboost_tpu_torch.models.tree import (GrowConfig, TreeArrays,
                                           grow_trees, predict_leaf_binned,
                                           predict_margin_binned,
                                           table_lookup, tree_capacity)
from xgboost_tpu_torch.models.updaters import (parse_updaters, prune_stack,
                                               prune_tree, refresh_trees)
from xgboost_tpu_torch.ops.split import FusedSplitConfig

_NUMPY_DTYPES = {"feature": np.int32, "cut_index": np.int32,
                 "threshold": np.float32, "default_left": np.bool_,
                 "is_leaf": np.bool_, "leaf_value": np.float32,
                 "gain": np.float32, "sum_hess": np.float32}


_WARNED: set = set()    # the one-time warnings given


def make_grow_config(p: TrainParam, n_bin: int) -> GrowConfig:
    """The grower's configuration (``gbtree.py:45-72``).  Histogram
    subtraction is the environment switch ``XGBTPU_HIST_SUBTRACTION=1``,
    not a parameter: a ``hist_subtraction=...`` parameter is ignored,
    with the JAX package's one-time warning under ``silent=0``."""
    parse_updaters(p.updater)
    split = FusedSplitConfig(
        reg_lambda=p.reg_lambda, reg_alpha=p.reg_alpha,
        max_delta_step=p.max_delta_step, min_child_weight=p.min_child_weight,
        gamma=p.gamma, eta=p.eta, default_direction=p.default_direction)
    hs = os.environ.get("XGBTPU_HIST_SUBTRACTION", "0") == "1"
    if ("hist_subtraction" in p.extras and int(p.silent) == 0
            and "hist_subtraction" not in _WARNED):
        _WARNED.add("hist_subtraction")
        print("[config] hist_subtraction is no longer a parameter "
              "(measured ~10x slower on TPU; PROFILE.md round 3) — "
              "ignored.  Set env XGBTPU_HIST_SUBTRACTION=1 to force "
              "the subtraction path for kernel A/Bs.", file=sys.stderr)
    return GrowConfig(split=split, max_depth=p.max_depth, n_bin=n_bin,
                      hist_precision=p.hist_precision,
                      subsample=p.subsample,
                      colsample_bytree=p.colsample_bytree,
                      colsample_bylevel=p.colsample_bylevel,
                      hist_subtraction=hs, n_roots=max(1, p.num_roots))


def resolve_pred_chunk(param: TrainParam, device: torch.device) -> int:
    """Trees a chunk of the chunked traversal traverses at once
    (``gbtree.py:363-375``): ``XGBTPU_PREDICT_TREE_CHUNK`` when set,
    else ``predict_tree_chunk``, whose -1 (auto) is 32 on a GPU and the
    per-tree path (0) on the CPU.  0 and 1 mean the per-tree path."""
    env_chunk = os.environ.get("XGBTPU_PREDICT_TREE_CHUNK")
    if env_chunk not in (None, ""):
        return max(0, int(env_chunk))
    pc = int(param.predict_tree_chunk)
    if pc < 0:
        pc = 32 if torch.device(device).type == "cuda" else 0
    return pc


def tree_keys(round_key, n_tree: int) -> np.ndarray:
    """Tree j of a round samples with ``fold_in(round_key, j)``
    (``gbtree.py:154,565``): (n_tree, 2) host keys."""
    return prng.fold_in(round_key, np.arange(n_tree))


def scan_rounds_lanes(binned: torch.Tensor, margin: torch.Tensor,
                      label: torch.Tensor, weight: torch.Tensor,
                      cut_values: torch.Tensor, n_cuts: torch.Tensor,
                      row_valid: torch.Tensor, *, n_rounds: int,
                      cfg: GrowConfig, grad_fn, base_keys=None,
                      first_iterations=None, split_finder=None
                      ) -> Tuple[torch.Tensor, List[TreeArrays]]:
    """``n_rounds`` boosting rounds of L same-shape tenant lanes at once
    (``gbtree.py:275-318``, ``_scan_rounds_lanes_impl``): (L, N, F)
    bins, (L, N, 1) margins, (L, N) labels / weights / row_valid (pad
    rows and pad lanes False), (L, F, W) cut values and (L, F) cut
    counts.  ``grad_fn(margin (M, 1), label (M,), weight (M,))`` is the
    lanes' shared objective gradient, run once over all L * N rows.
    Each round grows one tree per lane through :func:`grow_trees` (one
    K4 launch per level) and adds its leaf values to the lane's margin,
    exactly as a solo round of :meth:`GBTree.do_boost` does.  A sampled
    config needs ``base_keys`` (L, 2), each lane's ``PRNGKey(seed)``,
    and ``first_iterations`` (L,), each lane's absolute round: lane l's
    round i samples with ``fold_in(base_keys[l], first_iterations[l] +
    i)``, its tree with that key folded with 0, the keys of its solo
    rounds.  ``split_finder`` is the lanes' shared finder (None = the
    histogram argmax).  Reads nothing back to the host.

    Returns (final margins (L, N, 1), one (L, n_nodes) tree stack per
    round)."""
    L, N, K = margin.shape
    valid = row_valid.to(torch.float32)
    stacks = []
    for i in range(n_rounds):
        keys = None
        if cfg.sampled:
            keys = prng.fold_in(prng.fold_in(
                base_keys, np.asarray(first_iterations) + i), 0)
        gh = grad_fn(margin.reshape(L * N, K), label.reshape(-1),
                     weight.reshape(-1)).reshape(L, N, K, 2)
        trees, _, row_val = grow_trees(binned, gh[:, :, 0, :], cut_values,
                                       n_cuts, cfg, row_valid, keys,
                                       split_finder=split_finder)
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
        # exact greedy growth on raw values (gbtree.py:329-337), except
        # under dsplit=row, which quantizes at every distinct value
        self.exact_raw = ("grow_colmaker" in parse_updaters(param.updater)
                          and param.dsplit != "row")
        self.cut_values_dev = torch.as_tensor(cuts.cut_values).to(device)
        self.n_cuts_dev = torch.as_tensor(cuts.n_cuts).to(device)
        self._parts: List[TreeArrays] = []   # (t_i, n_nodes) stacks
        self.tree_group: List[int] = []
        self._stack_cache: Optional[Tuple[int, TreeArrays,
                                          torch.Tensor]] = None
        self._group_dev: Optional[Tuple[int, torch.Tensor]] = None
        self.pred_chunk = resolve_pred_chunk(param, device)
        self._col_cuts = None    # (F_pad, padded cut values, cut counts)

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

    def split_finder(self):
        """The grower's split finder (``gbtree.py:408-422``): skmaker's
        of summary size K under ``updater=grow_skmaker``, else None (the
        histogram argmax).  Memoized by K, so equal configurations share
        one function."""
        if "grow_skmaker" not in parse_updaters(self.param.updater):
            return None
        from xgboost_tpu_torch.models.skmaker import (sketch_size,
                                                      skmaker_split_finder)
        return skmaker_split_finder(sketch_size(
            self.param.sketch_ratio, self.param.sketch_eps, self.cfg.n_bin))

    def col_arrays(self, col) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cut values and counts padded to ``col``'s features, +inf
        and 0 on padding (``gbtree.py:396-406``), made once."""
        if self._col_cuts is None or self._col_cuts[0] != col.f_pad:
            from xgboost_tpu_torch.parallel.colsplit import pad_features
            cv = pad_features(self.cuts.cut_values, col.world, 0, np.inf)
            nc = pad_features(self.cuts.n_cuts, col.world, 0)
            self._col_cuts = (col.f_pad, torch.as_tensor(cv).to(self.device),
                              torch.as_tensor(nc).to(self.device))
        return self._col_cuts[1], self._col_cuts[2]

    def _do_prune(self) -> bool:
        return ("prune" in parse_updaters(self.param.updater)
                and self.param.gamma > 0.0)

    def do_boost(self, binned: torch.Tensor, gh: torch.Tensor,
                 row_valid: Optional[torch.Tensor] = None, key=None,
                 root: Optional[torch.Tensor] = None,
                 exact_has_missing: bool = True,
                 exact_ranks=None, mesh=None, col=None) -> torch.Tensor:
        """One boosting round: grow the round's T = K x num_parallel_tree
        trees on ``gh`` (N, K, 2) together, tree j sampling with
        ``fold_in(key, j)`` (``key`` the round's host key, needed when the
        config samples) and rows entering at their ``root`` slot, prune
        each when ``gamma > 0``, append them.  Returns the (N, K) margin
        delta: each group's trees added in tree order
        (``gbtree.py:681-757``).  An exact-mode ensemble grows on the raw
        values ``binned`` holds (:meth:`_do_boost_exact`).  ``mesh``: this
        rank's world under row split; ``binned`` and ``gh`` are its
        block.  ``col``: this rank's ColSplit under column split;
        ``binned`` is its block of the features (:meth:`_do_boost_col`)."""
        from xgboost_tpu_torch.parallel.dp import hist_reduce
        npar = max(1, self.param.num_parallel_tree)
        T, K = self.trees_per_round, self.n_group
        group = [j // npar for j in range(T)]
        # (T, N, 2) from views: no index tensor sent to the device
        gh_t = torch.stack([gh[:, g, :] for g in group])
        keys = None if key is None else tree_keys(key, T)
        if col is not None and root is not None:
            raise NotImplementedError(
                "root_index needs num_roots > 1 (and dsplit != col): set "
                "num_roots to the number of tree roots")
        if self.exact_raw:
            return self._do_boost_exact(binned, gh_t, group, row_valid, keys,
                                        exact_has_missing, exact_ranks, col)
        if col is not None:
            return self._do_boost_col(binned, gh_t, group, row_valid, keys,
                                      col)
        trees, row_leaf, ds = grow_trees(binned, gh_t, self.cut_values_dev,
                                         self.n_cuts_dev, self.cfg,
                                         row_valid, keys, root,
                                         split_finder=self.split_finder(),
                                         hist_reduce=hist_reduce(mesh))
        if self._do_prune():
            trees, resolves = prune_stack(trees, self.param.gamma,
                                          self.cfg.n_roots)
            ds = [table_lookup(trees.leaf_value[j][torch.as_tensor(
                resolves[j], dtype=torch.int64, device=binned.device)],
                row_leaf[j]) for j in range(T)]
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

    def _do_boost_col(self, binned: torch.Tensor, gh_t: torch.Tensor,
                      group: List[int], row_valid, keys, col) -> torch.Tensor:
        """A round under column split (``gbtree.py:557-620``): the round's
        trees grow one at a time on this rank's block of the features
        (:func:`~xgboost_tpu_torch.parallel.colsplit.grow_tree_colsplit`,
        one K1 launch a level, no K3 batching), each pruned when ``gamma >
        0``; each group's delta is its first tree's, then the others added
        in tree order.  The skmaker finder merges no summaries and
        raises."""
        from xgboost_tpu_torch.parallel.colsplit import grow_tree_colsplit
        if self.split_finder() is not None:
            raise NotImplementedError(
                "updater=grow_skmaker is not supported under dsplit=col "
                "(the column-split grower reduces SplitEntry tuples, not "
                "summaries)")
        cv, nc = self.col_arrays(col)
        trees, deltas = [], {}
        for j, g in enumerate(group):
            tree, row_leaf, d = grow_tree_colsplit(
                col, binned, gh_t[j], cv, nc, self.cfg, row_valid,
                None if keys is None else keys[j])
            if self._do_prune():
                tree, resolve = prune_tree(tree, self.param.gamma,
                                           self.cfg.n_roots)
                d = table_lookup(tree.leaf_value[torch.as_tensor(
                    resolve, dtype=torch.int64, device=binned.device)],
                    row_leaf)
            if row_valid is not None:
                d = d * row_valid.to(d.dtype)
            trees.append(tree)
            deltas[g] = d if g not in deltas else deltas[g] + d
        return self._append_round(trees, group, deltas)

    def _append_round(self, trees: List[TreeArrays], group: List[int],
                      deltas: dict) -> torch.Tensor:
        """Append a round grown tree by tree; its (N, K) delta."""
        self._parts.append(TreeArrays(*(torch.stack(xs)
                                        for xs in zip(*trees))))
        self.tree_group.extend(group)
        self._stack_cache = None
        return torch.stack([deltas[k] for k in range(self.n_group)], dim=1)

    def _do_boost_exact(self, X: torch.Tensor, gh_t: torch.Tensor,
                        group: List[int], row_valid, keys,
                        has_missing: bool, ranks, col=None) -> torch.Tensor:
        """An exact round (``gbtree.py:623-680``): the round's trees grow
        one after another on raw values X (their scans share nothing),
        each pruned when ``gamma > 0``; each group's delta is its trees'
        leaf values summed in tree order.  Under column split X is this
        rank's block of the features
        (:func:`~xgboost_tpu_torch.parallel.colsplit.grow_tree_exact_colsplit`)."""
        from xgboost_tpu_torch.models.colmaker import grow_tree_exact
        rk, uq = ranks if ranks is not None else (None, None)
        grow = grow_tree_exact
        if col is not None:
            from xgboost_tpu_torch.parallel.colsplit import \
                grow_tree_exact_colsplit
            grow = partial(grow_tree_exact_colsplit, col)
        trees, deltas = [], {}
        for j, g in enumerate(group):
            tree, row_leaf = grow(
                X, gh_t[j], self.cfg, row_valid, has_missing, rk, uq,
                None if keys is None else keys[j])
            leaf_value = tree.leaf_value
            if self._do_prune():
                tree, resolve = prune_tree(tree, self.param.gamma)
                leaf_value = tree.leaf_value[torch.as_tensor(
                    resolve, dtype=torch.int64, device=X.device)]
            d = table_lookup(leaf_value, row_leaf)
            if row_valid is not None:
                d = d * row_valid.to(d.dtype)
            trees.append(tree)
            deltas[g] = d if g not in deltas else deltas[g] + d
        return self._append_round(trees, group, deltas)

    def do_boost_paged(self, dmat, gh: torch.Tensor, key=None, mesh=None
                       ) -> torch.Tensor:
        """One boosting round over an external-memory matrix
        (``gbtree.py:961-1005``): each of the round's K x
        ``num_parallel_tree`` trees grows on its own over the streamed
        batches (:func:`~xgboost_tpu_torch.external.grow_tree_paged`),
        tree j sampling with ``fold_in(key, j)``, and is pruned when
        ``gamma > 0``.  gh (N, K, 2) on the device; returns the (N, K)
        margin delta, each group's trees added into zeros in tree
        order.  ``mesh``: under row split every batch's rows are split
        into the ranks' blocks and this rank builds the partial sums of
        its part of each; every rank routes all rows, so all N rows'
        delta comes back on every rank."""
        from xgboost_tpu_torch.external import grow_tree_paged
        if self.cfg.n_roots > 1:
            raise NotImplementedError(
                "num_roots > 1 is not supported on external-memory "
                "matrices (root_index routing is in-memory only)")
        npar = max(1, self.param.num_parallel_tree)
        T, K = self.trees_per_round, self.n_group
        keys = None if key is None else tree_keys(key, T)
        deltas = torch.zeros((dmat.num_row, K), dtype=torch.float32,
                             device=gh.device)
        trees = []
        for j in range(T):
            k = j // npar
            tree, row_leaf = grow_tree_paged(
                dmat, gh[:, k, :], self.cut_values_dev, self.n_cuts_dev,
                self.cfg, key=None if keys is None else keys[j],
                split_finder=self.split_finder(), mesh=mesh)
            if self._do_prune():
                pruned, resolve = prune_tree(TreeArrays(*(x[0]
                                                          for x in tree)),
                                             self.param.gamma)
                tree = TreeArrays(*(x[None] for x in pruned))
                row_leaf = torch.as_tensor(
                    resolve, dtype=torch.int64,
                    device=gh.device)[row_leaf.to(torch.int64)]
            # each row's leaf from growth: the JAX package traverses the
            # batches once more for it (_paged_leaf_delta), the same leaf
            deltas[:, k] += table_lookup(tree.leaf_value[0], row_leaf)
            trees.append(tree)
            self.tree_group.append(k)
        self._parts.append(TreeArrays(*(torch.cat(xs) for xs in zip(*trees))))
        self._stack_cache = None
        return deltas

    def do_refresh(self, binned: torch.Tensor, gh: torch.Tensor,
                   row_valid: Optional[torch.Tensor] = None,
                   root: Optional[torch.Tensor] = None, mesh=None,
                   router=None) -> None:
        """The ``refresh`` updater (``gbtree.py:1009-1034``): every tree's
        node sums, leaf values and gains recomputed on ``binned`` with
        the gradients ``gh`` (N, K, 2) of its group, one snapshot for all
        trees, as in the JAX package; one K2 launch a level for all of
        them (:func:`~.updaters.refresh_trees`); under row split the node
        sums of every rank's block are reduced (``mesh``); under column
        split ``binned`` is the rank's block of the features and
        ``router`` the ranks'."""
        from xgboost_tpu_torch.parallel.dp import hist_reduce
        if self.exact_raw:
            # the JAX package would read the raw values as bin ids here
            raise NotImplementedError(
                "refresh routes rows by bins; an exact-mode (grow_colmaker) "
                "ensemble has none")
        if self.num_trees == 0:
            return
        stack, group = self._stack(0)
        idx = group.to(device=binned.device, dtype=torch.int64)
        gh_t = gh.index_select(1, idx).permute(1, 0, 2)
        self._parts = [refresh_trees(stack, binned, gh_t, self.cfg.split,
                                     self.cfg.max_depth, row_valid, root,
                                     self.cfg.n_roots, hist_reduce(mesh),
                                     router)]
        self._stack_cache = None

    def prune_all(self) -> None:
        """``refresh,prune``: every tree pruned against its refreshed
        gains (``learner.py:1364-1370``)."""
        if self.num_trees:
            self._parts = [prune_stack(self._stack(0)[0], self.param.gamma,
                                       self.cfg.n_roots)[0]]
            self._stack_cache = None

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

    def group_on_device(self, n_trees: int) -> torch.Tensor:
        """The first ``n_trees`` tree groups on the booster's device,
        uploaded once per ensemble size: the chunked traversal reads
        them there, never on the host."""
        cached = self._group_dev
        if cached is None or cached[0] != self.num_trees:
            cached = self._group_dev = (self.num_trees,
                                        self._stack(0)[1].to(self.device))
        return cached[1][:n_trees]

    def predict_margin(self, binned: torch.Tensor, base: torch.Tensor,
                       ntree_limit: int = 0,
                       root: Optional[torch.Tensor] = None,
                       router=None) -> torch.Tensor:
        """Margins of ``binned`` (raw values in exact mode); ``router``:
        column split's, for a rank's block of the features."""
        stack, group = self._stack(ntree_limit)
        if self.exact_raw:
            from xgboost_tpu_torch.models.colmaker import predict_margin_raw
            return predict_margin_raw(stack, group, binned, base,
                                      self.cfg.max_depth, self.n_group,
                                      router)
        if self.pred_chunk > 1:
            group = self.group_on_device(len(group))
        return predict_margin_binned(stack, group, binned, base,
                                     self.cfg.max_depth, self.n_group,
                                     root, self.cfg.n_roots,
                                     tree_chunk=self.pred_chunk,
                                     router=router)

    def predict_incremental(self, binned: torch.Tensor, margin: torch.Tensor,
                            first_tree: int, n_trees: int,
                            root: Optional[torch.Tensor] = None,
                            router=None) -> torch.Tensor:
        """``margin`` plus trees ``[first_tree, first_tree + n_trees)``,
        their contributions summed from 0 first (``gbtree.py:1103-1128``)."""
        return self.predict_contrib(binned, first_tree, n_trees,
                                    root, router) + margin

    def predict_contrib(self, binned: torch.Tensor, first_tree: int,
                        n_trees: int, root: Optional[torch.Tensor] = None,
                        router=None) -> torch.Tensor:
        """The (N, K) sum of trees ``[first_tree, first_tree + n_trees)``
        from 0."""
        stack, group = self._stack(first_tree + n_trees)
        part = TreeArrays(*(x[first_tree:] for x in stack))
        zero = torch.zeros((), dtype=torch.float32, device=binned.device)
        if self.exact_raw:
            from xgboost_tpu_torch.models.colmaker import predict_margin_raw
            return predict_margin_raw(part, group[first_tree:], binned, zero,
                                      self.cfg.max_depth, self.n_group,
                                      router)
        if self.pred_chunk > 1:
            group = self.group_on_device(len(group))
        return predict_margin_binned(part, group[first_tree:], binned, zero,
                                     self.cfg.max_depth, self.n_group,
                                     root, self.cfg.n_roots,
                                     tree_chunk=self.pred_chunk,
                                     router=router)

    def predict_leaf(self, binned: torch.Tensor, ntree_limit: int = 0,
                     root: Optional[torch.Tensor] = None,
                     router=None) -> torch.Tensor:
        stack, _ = self._stack(ntree_limit)
        if self.exact_raw:
            from xgboost_tpu_torch.models.colmaker import predict_leaf_raw
            return predict_leaf_raw(stack, binned, self.cfg.max_depth,
                                    router)
        return predict_leaf_binned(stack, binned, self.cfg.max_depth, root,
                                   self.cfg.n_roots,
                                   tree_chunk=self.pred_chunk, router=router)

    def get_state(self) -> dict:
        """The model-file arrays, numpy (``gbtree.py:1145-1152``): each
        tree a row of ``tree_capacity(max_depth, num_roots)`` nodes, the
        multi-root layout with its root-slot levels included."""
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
        want = tree_capacity(gbt.cfg.max_depth, gbt.cfg.n_roots)
        if stack.feature.shape[0] and stack.feature.shape[1] != want:
            raise ValueError(
                f"model trees hold {stack.feature.shape[1]} nodes; "
                f"max_depth={gbt.cfg.max_depth} with num_roots="
                f"{gbt.cfg.n_roots} lays out {want}")
        if stack.feature.shape[0]:
            gbt._parts = [stack]
        gbt.tree_group = groups
        return gbt
