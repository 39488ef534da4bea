"""Booster and ``train`` (port of ``xgboost_tpu/learner.py``, the
single-device main path).

``Booster`` orchestrates objective, ensemble and metrics: cuts at first
use, one binned matrix and running margin per DMatrix it has seen
(advanced incrementally per round, the reference's prediction buffer),
``update`` / ``update_many``, ``predict``, ``eval_set`` lines, and model
files (npz + JSON header + CRC footer) that load in both packages, or
the reference's binary model files (:mod:`~xgboost_tpu_torch.compat`).
A gblinear booster keeps the (F, N) dense matrix of each DMatrix
instead of its bins; an external-memory matrix over the device budget
keeps no matrix on the device, its batches streamed at every level
(:mod:`~xgboost_tpu_torch.external`).

Every entry point runs on ``device`` (default ``"cuda"``); without a GPU
it raises unless the caller asks for ``"cpu"``.

``dsplit=row`` trains across the ranks of a ``torch.distributed`` world
(:mod:`xgboost_tpu_torch.parallel`): each rank keeps the block of every
matrix's rows that the JAX mesh gives its device, and the histograms,
node sums and gblinear sums are reduced over the ranks.  Custom
objectives and ``boost`` see and give every row; ``predict`` and the eval
lines of a replicated matrix read the gathered margins, so they are
byte-equal to a world of one; a split-loaded matrix
(:class:`~xgboost_tpu_torch.parallel.sharded.ShardedDMatrix`) reduces
metric partials instead.  Without a process group ``dsplit=row`` is a
world of one and trains the model of ``dsplit=auto``.  Ranking
objectives take their gradient over every row's margin, gathered, and
each rank keeps its block of it.

``dsplit=col`` trains across the same world by features
(:mod:`xgboost_tpu_torch.parallel.colsplit`): every rank keeps all rows
of each matrix and uploads its block of the features, padded to a
multiple of the world; growth merges the ranks' best splits and routes
rows by the owner's bits, and so does the margin of every cached matrix,
so ``predict``, the eval lines and the model file are the same on every
rank.  gblinear ignores ``dsplit=col``, as in the JAX package.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
import sys
import zipfile
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_tpu_torch import random as prng
from xgboost_tpu_torch.binning import (CutMatrix, bin_dense_device,
                                       bin_matrix, compute_cuts)
from xgboost_tpu_torch.config import TrainParam, params_to_dict
from xgboost_tpu_torch.data import DMatrix, write_npz
from xgboost_tpu_torch.metrics import create_metric
from xgboost_tpu_torch.models.gbtree import GBTree
from xgboost_tpu_torch.objectives import create_objective
from xgboost_tpu_torch.parallel import mock
from xgboost_tpu_torch.reliability.integrity import (ModelIntegrityError,
                                                     add_footer, atomic_write,
                                                     read_file,
                                                     verify_model_bytes)

_MAGIC = "xgbtpu001"

# The JAX package's fit of its round time on its own chip
# (ROUND_MODEL.json: fixed_round_s, per_row_s).  Kept only so that auto-
# sized round segments, and the checkpoints at their ends, fall on the
# same rounds as in the JAX package; they are no timing of the port.
_FIT_FIXED_ROUND_S = 4.465142270643514e-3
_FIT_PER_ROW_S = 9.974174160066542e-09


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device, ``"cuda"`` by default.  A CUDA
    device without a GPU raises: nothing falls back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available; pass device='cpu' to "
                           "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: expected cuda or cpu")
    return dev


def _check_param(p: TrainParam) -> None:
    if p.dsplit not in ("auto", "row", "col"):
        raise ValueError(f"dsplit={p.dsplit!r}: expected auto, row or col")


class _CacheEntry:
    """Per-DMatrix device state: bins, base margin, running margin, the
    rows' root slots of a multi-root model, and the group-padded rank
    layout (``learner.py:48-80``)."""

    def __init__(self, dmat: DMatrix, binned: torch.Tensor,
                 base: torch.Tensor,
                 row_valid: Optional[torch.Tensor] = None,
                 rank_pad_prep=None):
        self.dmat = dmat            # strong ref: id(dmat) keys the cache
        self.binned = binned        # (N, F) on the booster's device
        self.base = base            # (N, K) f32
        self.root: Optional[torch.Tensor] = None   # (N,) int32 root slots
        self.margin: Optional[torch.Tensor] = None
        self.applied = 0            # trees folded into margin
        self.info_version = dmat.info.version
        self.labels_checked = -1    # info version whose labels passed
        self.row_valid = row_valid  # (N,) bool on a padded layout
        # rank_device.PadRankPrep of a group-padded entry: its rows are
        # relaid (label-sorted, lane-padded per group), so what users
        # see comes back through user_rows
        self.rank_pad_prep = rank_pad_prep
        # exact mode (grow_colmaker): ``binned`` holds raw values; whether
        # any is missing, and the one-off dense ranks of a training matrix
        # (built from ``exact_host`` at its first boost, then dropped)
        self.exact_has_missing = True
        self.exact_ranks = None
        self.exact_host: Optional[np.ndarray] = None
        # an external-memory matrix over the device budget: no ``binned``
        # tensor; its batches stream from the matrix's binned memmap
        self.external = False
        # row split: the metadata of this rank's block, and the block
        # (start, stop, rows, all rows) of the padded layout
        self.info = dmat.info
        self.block: Optional[Tuple[int, int, int, int]] = None

    def user_rows(self, x):
        """The user's rows of a host per-row array, in the user's order."""
        if self.rank_pad_prep is not None:
            return x[self.rank_pad_prep.user_map]
        return x


class LaneSpec(NamedTuple):
    """One tenant's gang-batching contract (:meth:`Booster.fused_lane_spec`,
    ``learner.py:82``): everything the lane dispatcher
    (``pipeline/lanes.py``) needs to advance this booster's next rounds
    together with its shape-bucket peers.  The static fields (shapes,
    K / npar, cfg, the gradient's identity, round counts) form the
    bucket key; the tensors are the solo round loop's own operands,
    with the margin already synced."""
    booster: "Booster"
    entry: _CacheEntry
    n_rows: int              # device row count of the entry
    n_features: int
    n_rounds: int
    first_iteration: int
    seg_k: int               # resolved rounds-per-segment
    K: int                   # num_output_group
    npar: int                # num_parallel_tree
    cfg: object              # GrowConfig (hashable)
    grad_fn: object          # Objective.fused_grad (stable identity)
    split_finder: object     # GBTree.split_finder() (stable identity)
    subsample: float
    base_key: np.ndarray     # (2,) uint32 PRNGKey(seed): sampling keys
    binned: torch.Tensor     # (N, F) device bins
    margin: torch.Tensor     # (N, K) synced margins
    label: torch.Tensor      # (N,) f32
    weight: torch.Tensor     # (N,) f32
    cut_values: torch.Tensor  # (F, W) f32
    n_cuts: torch.Tensor     # (F,) int32


class Booster:
    """Learner handle (reference wrapper/xgboost.py Booster)."""

    def __init__(self, params=None, cache: Sequence[DMatrix] = (),
                 model_file: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.param = TrainParam.from_dict(params or {})
        self.obj = None
        self.gbtree: Optional[GBTree] = None
        self.num_feature = 0
        self._cache: Dict[int, _CacheEntry] = {}
        self.best_iteration: int = -1
        self.best_score: float = float("nan")
        self.attributes: Dict[str, str] = {}
        self._profiler = None
        self._rank_path_told = False
        # dsplit=row: this rank's world (resolved at _lazy_init), and
        # the same when it has more than one rank (None otherwise)
        self._mesh = None
        self._dist = None
        # dsplit=col: this rank's block of the features (a ColSplit,
        # resolved at _lazy_init; None otherwise)
        self._col = None
        self._pending_cache = list(cache)
        if model_file is not None:
            self.load_model(model_file)

    # ----------------------------------------------------------- parameters
    def set_param(self, name, value=None):
        if isinstance(name, (dict, list, tuple)):
            for k, v in params_to_dict(name).items():
                self.param.set_param(k, v)
        else:
            self.param.set_param(name, value)
        if self.obj is not None:
            self._init_obj()
        if self.gbtree is not None:
            from xgboost_tpu_torch.models.gbtree import (make_grow_config,
                                                         resolve_pred_chunk)
            self.gbtree.param = self.param
            if self._linear:
                return
            self.gbtree.cfg = make_grow_config(self.param,
                                               self.gbtree.cuts.max_bin)
            self.gbtree.pred_chunk = resolve_pred_chunk(self.param,
                                                        self.device)

    def _init_obj(self):
        _check_param(self.param)
        self.obj = create_objective(self.param.objective)
        for name in ("scale_pos_weight", "num_class", "num_pairsample",
                     "fix_list_weight", "rank_impl", "seed"):
            self.obj.set_param(name, getattr(self.param, name))

    @property
    def _K(self) -> int:
        """Output groups: the margin's columns."""
        return max(1, self.param.num_output_group)

    @property
    def _linear(self) -> bool:
        """A gblinear model (``booster=gblinear``)."""
        return self.param.booster == "gblinear"

    def _bin_align(self) -> int:
        """Bin-count quantum of the cut proposal: 32 where the histogram
        kernel runs (a GPU, any precision but "fixed"), as the JAX
        package aligns for its TPU kernel; 0 on the CPU.
        ``hist_bin_align >= 0`` overrides."""
        hba = int(self.param.hist_bin_align)
        if hba >= 0:
            return hba
        return 32 if (self.device.type == "cuda"
                      and self.param.hist_precision != "fixed") else 0

    def _lazy_init(self, dtrain: DMatrix):
        if self.obj is None:
            self._init_obj()
        if self.param.dsplit == "row" and self._mesh is None:
            self._mesh = self._resolve_mesh(dtrain)
            self._dist = self._mesh if self._mesh.world > 1 else None
        if self.gbtree is None and self._linear:
            from xgboost_tpu_torch.models.gblinear import GBLinear
            if getattr(dtrain, "is_sharded", False):
                raise NotImplementedError(
                    "gblinear reads dense feature columns; per-rank split "
                    "loading supports gbtree only")
            self.num_feature = dtrain.num_col
            self.gbtree = GBLinear(self.param, dtrain.num_col, self.device)
        elif self.gbtree is None:
            self.num_feature = dtrain.num_col
            self.gbtree = GBTree(self.param, self._initial_cuts(dtrain),
                                 self.device)
            if getattr(dtrain, "is_external", False):
                self.gbtree.exact_raw = False
        if (self.param.dsplit == "col" and not self._linear
                and self._col is None):
            # learner.py:326-336; entries made before hold every column
            from xgboost_tpu_torch.parallel.colsplit import ColSplit
            self._col = ColSplit(self._resolve_mesh(dtrain), self.num_feature)
            self._cache.clear()
        for d in self._pending_cache:
            self._entry(d)
        self._pending_cache = []

    def _resolve_mesh(self, dtrain):
        """This booster's world under ``dsplit=row`` or ``col``: the
        installed one (``set_mesh``), else the initialised
        ``torch.distributed`` world, else a world of one, on this
        booster's device."""
        from xgboost_tpu_torch.parallel import colsplit
        from xgboost_tpu_torch.parallel import mesh as pmesh
        from xgboost_tpu_torch.parallel.mesh import DataMesh
        find = (colsplit.feature_parallel_mesh if self.param.dsplit == "col"
                else pmesh.data_parallel_mesh)
        m = find(self.device)
        if getattr(dtrain, "is_sharded", False) and (
                dtrain.mesh.world, dtrain.mesh.rank) != (m.world, m.rank):
            raise ValueError("the ShardedDMatrix was loaded for another "
                             "world than this booster's")
        return DataMesh(m.rank, m.world, self.device, m.group, m.backend)

    def _initial_cuts(self, dtrain) -> CutMatrix:
        """The new model's cuts, in the JAX package's order
        (``learner.py:223-300``)."""
        from xgboost_tpu_torch.models.updaters import parse_updaters
        exact = "grow_colmaker" in parse_updaters(self.param.updater)
        p = self.param
        if getattr(dtrain, "is_sharded", False):
            # per-rank split loading: no rank holds a full column, so
            # the device sketch over the ranks' blocks
            if p.dsplit == "col":
                raise NotImplementedError(
                    "a ShardedDMatrix is row-block loaded; dsplit=col needs "
                    "feature-shard loading (load replicated for column "
                    "split)")
            if p.dsplit != "row":
                raise NotImplementedError(
                    "a ShardedDMatrix is row-block loaded: train it with "
                    "dsplit=row")
            if exact:
                raise NotImplementedError(
                    "updater=grow_colmaker needs cuts at every distinct "
                    "value, which no rank can propose from its block; "
                    "load replicated for exact-greedy training")
            if p.objective.startswith("rank:"):
                raise NotImplementedError(
                    "ranking objectives need global group structure, which "
                    "row-block split loading cannot provide; load "
                    "replicated for rank:* training")
            from xgboost_tpu_torch.parallel.sketch_device import \
                sketch_cuts_global
            vals, w = dtrain.device_raw(self.device)
            return sketch_cuts_global(self._mesh, vals, w, p.max_bin,
                                      p.sketch_eps, p.sketch_ratio)
        if getattr(dtrain, "is_external", False):
            # the streaming sketch over the raw pages, shared by the
            # boosters on the matrix as a DMatrix's cuts are; paged
            # matrices are binned end to end, whatever the updater
            # (learner.py:252-260, :313-316)
            key = (p.max_bin, p.sketch_eps, p.sketch_ratio)
            cuts = dtrain._cuts.get(key)
            if cuts is None:
                cuts = dtrain._cuts[key] = dtrain.sketch_cuts(*key)
            return cuts
        if exact and p.dsplit == "row":
            # exact greedy under row split is the histogram grower on
            # the cuts of every distinct value (learner.py:261-270)
            from xgboost_tpu_torch.binning import compute_cuts_exact
            return compute_cuts_exact(dtrain, p.max_exact_bin)
        if exact:
            # exact mode is bin-free: an (F, 1) cut matrix of +inf holds
            # the place (learner.py:271-283)
            return CutMatrix(np.full((dtrain.num_col, 1), np.inf, np.float32),
                             np.zeros(dtrain.num_col, np.int32))
        if p.dsplit == "row" and (p.device_sketch > 0 or (
                p.device_sketch < 0 and self._mesh.world > 1)):
            # the device sketch: every rank summarises its block, the
            # summaries are gathered and folded in rank order
            from xgboost_tpu_torch.parallel.sketch_device import \
                sketch_cuts_mesh
            return sketch_cuts_mesh(self._mesh, dtrain.to_dense(),
                                    dtrain.info.weight, p.max_bin,
                                    p.sketch_eps, p.sketch_ratio)
        return self._cuts_of(dtrain)

    def _cuts_of(self, dtrain: DMatrix) -> CutMatrix:
        """The training matrix's quantile cuts.  The sketch reads every
        column on the host, the most costly step of a first round;
        boosters on one matrix share its cuts."""
        margin_kw = ({"bin_align_margin": None}
                     if int(self.param.hist_bin_align) > 0 else {})
        key = (self.param.max_bin, self.param.sketch_eps,
               self.param.sketch_ratio, self._bin_align(),
               tuple(margin_kw.items()))
        cuts = dtrain._cuts.get(key)
        if cuts is None:
            cuts = dtrain._cuts[key] = compute_cuts(
                dtrain, self.param.max_bin, self.param.sketch_eps,
                self.param.sketch_ratio, bin_align=self._bin_align(),
                **margin_kw)
        return cuts

    def _raw_dense(self, dmat: DMatrix, col=None
                   ) -> Tuple[torch.Tensor, bool, np.ndarray]:
        """An exact-mode matrix (``learner.py:752-773``): raw values, NaN
        = missing, cut or NaN-padded to the model's width; with ``col``
        its block of the features, padded with all-NaN columns, which
        leave ``has_missing`` as it is.  Returns (the device matrix,
        whether a value is missing, the host matrix)."""
        X = dmat.to_dense(missing=np.nan)[:, :self.num_feature]
        has_missing = bool(np.isnan(X).any())
        if X.shape[1] < self.num_feature:
            X = np.pad(X, ((0, 0), (0, self.num_feature - X.shape[1])),
                       constant_values=np.nan)
            has_missing = True
        if col is not None:
            X = col.block(X, fill=np.nan)
        X = np.ascontiguousarray(X, np.float32)
        return torch.from_numpy(X).to(self.device), has_missing, X

    def _base_margin_of(self, dmat: DMatrix, n: int) -> torch.Tensor:
        bm = dmat.info.base_margin
        if bm is not None:
            return torch.as_tensor(np.asarray(bm, np.float32).reshape(
                n, self._K)).to(self.device)
        base = self.obj.prob_to_margin(self.param.base_score)
        return torch.full((n, self._K), base, dtype=torch.float32,
                          device=self.device)

    def _device_bins(self, host: np.ndarray) -> torch.Tensor:
        if host.dtype == np.uint16:   # torch has no general uint16
            host = host.astype(np.int32)
        return torch.from_numpy(host).to(self.device)

    def _entry(self, dmat: DMatrix) -> _CacheEntry:
        key = id(dmat)
        entry = self._cache.get(key)
        if entry is not None and entry.external \
                and dmat._binned_cuts is not self.gbtree.cuts:
            # another model re-binned this matrix meanwhile: bin it again
            # and rebuild the margins (learner.py:361-367)
            entry = self._cache[key] = self._build_ext_entry(dmat)
        if entry is not None and entry.rank_pad_prep is not None and (
                entry.info_version != dmat.info.version
                or not self._device_rank()):
            # the padded layout derives from the labels and groups, and
            # only the device rank gradient reads it (learner.py:376-390)
            del self._cache[key]
            entry = None
        if entry is None:
            if self.num_feature and dmat.num_col > self.num_feature:
                raise ValueError(
                    f"data has {dmat.num_col} features, model was trained "
                    f"with {self.num_feature}")
            if getattr(dmat, "is_sharded", False):
                entry = self._cache[key] = self._make_shard_loaded_entry(
                    dmat)
                return entry
            if getattr(dmat, "is_external", False):
                entry = self._cache[key] = self._build_ext_entry(dmat)
            elif self._dist is not None:
                entry = self._cache[key] = self._make_sharded_entry(dmat)
                return entry
            elif self._linear:
                entry = self._cache[key] = _CacheEntry(
                    dmat, self.gbtree.device_matrix(dmat),
                    self._base_margin_of(dmat, dmat.num_row))
            elif self.gbtree.exact_raw:
                raw, has_missing, host = self._raw_dense(dmat, self._col)
                entry = self._cache[key] = _CacheEntry(
                    dmat, raw, self._base_margin_of(dmat, dmat.num_row))
                entry.exact_has_missing = has_missing
                entry.exact_host = host
            elif self._rank_pad_ok(dmat):
                entry = self._cache[key] = self._make_rank_padded_entry(dmat)
            else:
                binned = bin_matrix(dmat, self.gbtree.cuts)
                if self._col is not None:
                    # this rank's block of the features, padded once
                    binned = self._col.block(binned)
                entry = self._cache[key] = _CacheEntry(
                    dmat, self._device_bins(binned),
                    self._base_margin_of(dmat, dmat.num_row))
            entry.root = self._root_of(dmat, self._entry_rows(entry))
        elif entry.info_version != dmat.info.version and (
                entry.block is not None):
            # a set_field since: a block entry's metadata is rebuilt
            del self._cache[key]
            return self._entry(dmat)
        elif entry.info_version != dmat.info.version:
            # a set_field since: the base margin, the root slots and the
            # margin built on them are stale
            entry.base = self._base_margin_of(dmat, dmat.num_row)
            entry.root = self._root_of(dmat, self._entry_rows(entry))
            entry.margin, entry.applied = None, 0
            entry.info_version = dmat.info.version
        return entry

    def _entry_rows(self, entry: _CacheEntry) -> int:
        """The entry's device row count: its bins' rows (a padded rank
        layout has more than the matrix), the block's rows under row
        split, the matrix's rows for a gblinear (feature-major) or
        streamed entry."""
        if entry.block is not None:
            return entry.block[2]
        if entry.external or self._linear:
            return entry.dmat.num_row
        return int(entry.binned.shape[0])

    # ------------------------------------------------------------ row split
    def _block_info(self, info, rows: np.ndarray, m: int):
        """The metadata of a block: the rows ``rows`` of ``info``, padded
        to ``m`` rows with label 0 and weight 0, so that padding rows
        give zero gradients (``learner.py:1992-2022``)."""
        from xgboost_tpu_torch.data import MetaInfo
        pad = m - len(rows)
        out = MetaInfo()
        if info.label is not None:
            out.label = np.concatenate([np.asarray(info.label,
                                                   np.float32)[rows],
                                        np.zeros(pad, np.float32)])
        weight = (np.ones(len(rows), np.float32) if info.weight is None
                  else np.asarray(info.weight, np.float32)[rows])
        out.weight = np.concatenate([weight, np.zeros(pad, np.float32)])
        return out

    def _make_sharded_entry(self, dmat: DMatrix,
                            binned_mm=None) -> _CacheEntry:
        """This rank's block of a replicated matrix under row split
        (``learner.py:544-577``): the rows of the padded layout that the
        JAX mesh gives this rank's device, binned here (byte-equal to
        that block of the whole binned matrix), padding rows as bin 0
        outside ``row_valid``, with the block's label, weight (0 on
        padding) and base margin on the device.  A gblinear entry holds
        the block's (F, m) columns; an external matrix that fits the
        device passes its binned rows (``binned_mm``)."""
        mesh = self._dist
        n = dmat.num_row
        start, stop, m = mesh.block(n)
        rows = np.arange(start, min(stop, n), dtype=np.int64)
        if self._linear:
            XT = np.zeros((self.num_feature, m), np.float32)
            XT[:, :len(rows)] = self.gbtree.host_matrix(dmat.slice(rows)).T
            binned = torch.from_numpy(XT).to(self.device)
        else:
            b = (bin_matrix(dmat.slice(rows), self.gbtree.cuts)
                 if binned_mm is None else binned_mm[start:start + len(rows)])
            host = np.zeros((m, b.shape[1]), b.dtype)
            host[:len(rows)] = b
            binned = self._device_bins(host)
        from xgboost_tpu_torch.parallel.dp import shard_rows
        base = shard_rows(mesh, self._base_margin_of(dmat, n))
        row_valid = torch.from_numpy(np.arange(start, stop) < n).to(
            self.device)
        entry = _CacheEntry(dmat, binned, base, row_valid=row_valid)
        entry.info = self._block_info(dmat.info, rows, m)
        entry.block = (start, stop, m, n)
        root = self._root_of(dmat, n)
        if root is not None:
            entry.root = shard_rows(mesh, root)
        return entry

    def _make_shard_loaded_entry(self, dmat) -> _CacheEntry:
        """The entry of a split-loaded matrix (``learner.py:579-630``):
        the rank bins its own rows, padded to the block, which is the
        same block a replicated load gives it, so both train the same
        model."""
        if self._linear:
            raise NotImplementedError(
                "gblinear reads dense feature columns; per-rank split "
                "loading supports gbtree only")
        if self.param.objective.startswith("rank:"):
            raise NotImplementedError(
                "ranking objectives need global group structure, which "
                "row-block split loading cannot provide; load replicated "
                "for rank:*")
        n_loc, m, K = dmat.local_num_row, dmat.block_rows, self._K
        b = bin_matrix(dmat._local, self.gbtree.cuts)
        host = np.zeros((m, self.num_feature), b.dtype)
        host[:n_loc, :b.shape[1]] = b[:, :self.num_feature]
        if dmat._full_base_margin is not None:
            base = np.asarray(dmat._full_base_margin, np.float32).reshape(
                dmat.global_num_row, K)[dmat.row_start:dmat.row_end]
        elif dmat.info.base_margin is not None:
            base = np.asarray(dmat.info.base_margin,
                              np.float32).reshape(n_loc, K)
        else:
            base = np.full((n_loc, K), self.obj.prob_to_margin(
                self.param.base_score), np.float32)
        base = torch.from_numpy(dmat.pad_local(base)).to(self.device)
        entry = _CacheEntry(dmat, self._device_bins(host), base,
                            row_valid=dmat.row_valid(self.device))
        entry.info = self._block_info(dmat.info, np.arange(n_loc), m)
        entry.block = (dmat.block_start, dmat.block_start + m, m,
                       dmat.global_num_row)
        return entry

    def _gather_rows(self, entry: _CacheEntry, x: torch.Tensor
                     ) -> torch.Tensor:
        """A per-row tensor of a block entry gathered over the ranks,
        padding rows cut: every row of the matrix, on every rank."""
        if entry.block is None or self._dist is None:
            return x
        return torch.cat(self._dist.all_gather(x))[:entry.block[3]]

    def _build_ext_entry(self, dmat) -> _CacheEntry:
        """An external-memory matrix's entry (``learner.py:509-542``),
        binned with this model's cuts (again when another model binned
        it since).  When the binned matrix fits the device budget
        (:meth:`ExtMemDMatrix.fits_device_budget`), external memory has
        done its job and the entry is an in-memory one; otherwise its
        batches stream at every level."""
        if self._linear:
            raise NotImplementedError(
                "gblinear reads a dense design matrix; load this matrix in "
                "memory (DMatrix) for booster=gblinear")
        if self.gbtree.exact_raw:
            raise NotImplementedError(
                "exact-mode (grow_colmaker) models route on raw values; "
                "external-memory matrices are binned — load this matrix "
                "in memory (DMatrix) for exact-mode predict/eval/train")
        if self._col is not None:
            raise NotImplementedError(
                "external-memory matrices do not support dsplit=col (the "
                "reference routes paged matrices to the histogram row-split "
                "path too, learner-inl.hpp:263-267)")
        if dmat._binned_mm is None or dmat._binned_cuts is not self.gbtree.cuts:
            dmat.build_binned(self.gbtree.cuts)
        fits = dmat.fits_device_budget(self.device)
        if fits and self._dist is not None:
            return self._make_sharded_entry(dmat, dmat._binned_mm)
        base = self._base_margin_of(dmat, dmat.num_row)
        if fits:
            return _CacheEntry(dmat,
                               self._device_bins(np.array(dmat._binned_mm)),
                               base)
        entry = _CacheEntry(dmat, None, base)
        entry.external = True
        return entry

    # ------------------------------------------------------------- ranking
    def _device_rank(self) -> bool:
        """A LambdaRank objective with its gradient on the device."""
        return getattr(self.obj, "rank_impl", None) == "device"

    def _rank_pad_ok(self, dmat: DMatrix) -> bool:
        """The gate of the group-padded rank layout (``learner.py:
        669-709``): device LambdaRank, one output group, grouped data
        with lanes of at most ``XGBTPU_RANK_PAD_MAXLANE`` (256, the last
        lane count exact in the JAX package's bf16 partner dot), a
        padding blow-up of at most 1.4 (3.0 up to 200,000 rows), and
        labels that are integers in [0, 32).  ``XGBTPU_RANK_PAD=0``
        turns it off; row and column split take the sort path, as the
        JAX package's meshes do."""
        info = dmat.info
        if (os.environ.get("XGBTPU_RANK_PAD", "1") == "0"
                or not self._device_rank()
                or self.param.dsplit == "row"
                or self._col is not None
                or self._K != 1
                or info.group_ptr is None or len(info.group_ptr) < 2
                or info.label is None
                or (info.root_index is not None
                    and max(1, self.param.num_roots) > 1)):
            return False
        gptr = np.asarray(info.group_ptr, np.int64)
        sizes = np.diff(gptr)
        if len(sizes) == 0 or sizes.min() <= 0:
            return False
        G = len(sizes)
        L = max(8, int(-(-sizes.max() // 8) * 8))
        n = dmat.num_row
        max_lane = min(256, int(os.environ.get("XGBTPU_RANK_PAD_MAXLANE",
                                               "256")))
        la = np.asarray(info.label)
        blow = (G * L + (n - int(gptr[-1]))) / max(n, 1)
        return (L <= max_lane
                and G * L * L <= (1 << 28)       # the (G, L, L) planes
                and (blow <= 1.4 or (n <= 200_000 and blow <= 3.0))
                and bool(np.all(la >= 0)) and bool(np.all(la < 32))
                and bool(np.all(la == np.round(la))))

    def _make_rank_padded_entry(self, dmat: DMatrix) -> _CacheEntry:
        """An entry in the group-padded layout (``learner.py:711-749``):
        group g owns slots ``[g L, (g + 1) L)``, its rows sorted by
        label; padding slots carry bin 0, zero gradients, and the first
        row's base margin.  The layout's tables are kept on the info."""
        from xgboost_tpu_torch.rank_device import build_pad_prep
        info = dmat.info
        tag = ("rank_pad_prep", str(self.device))
        if tag not in info._dev:
            info._dev[tag] = build_pad_prep(
                np.asarray(info.label, np.float32),
                np.asarray(info.group_ptr, np.int64), self.device)
        prep = info._dev[tag]
        n_slots = prep.G * prep.L + prep.n_tail
        occupied = prep.pad_map >= 0
        src = prep.pad_map[occupied]
        binned_host = bin_matrix(dmat, self.gbtree.cuts)
        binned_pad = np.zeros((n_slots, binned_host.shape[1]),
                              binned_host.dtype)
        binned_pad[occupied] = binned_host[src]
        base = self._base_margin_of(dmat, dmat.num_row).cpu().numpy()
        base_pad = np.full((n_slots, self._K),
                           float(base.reshape(-1)[0]) if base.size else 0.0,
                           np.float32)
        base_pad[occupied] = base.reshape(dmat.num_row, self._K)[src]
        return _CacheEntry(dmat, self._device_bins(binned_pad),
                           torch.from_numpy(base_pad).to(self.device),
                           row_valid=torch.from_numpy(occupied).to(
                               self.device),
                           rank_pad_prep=prep)

    def _announce_rank_path(self, entry: _CacheEntry) -> None:
        """Once, under ``silent=0``: the LambdaRank gradient path of the
        training matrix on stderr (``learner.py:645-667``)."""
        if self._rank_path_told or not self._device_rank():
            return
        self._rank_path_told = True
        path = ("group-padded" if entry.rank_pad_prep is not None
                else "sort-based")
        if int(self.param.silent) == 0:
            print(f"[rank] LambdaRank gradient path: {path} "
                  "(set XGBTPU_RANK_PAD=0 to force sort-based; "
                  "see README 'Ranking')", file=sys.stderr)

    def _root_of(self, dmat: DMatrix, n_rows: int) -> Optional[torch.Tensor]:
        """The rows' root slots (``root_index``, reference data.h:39-58)
        of a multi-root model as an (n_rows,) int32 tensor, rows past the
        info's 0 (a cache entry's: its device row count,
        ``learner.py:486-505``); None for a single-root model or without
        ``root_index``."""
        ri = dmat.info.root_index
        if ri is None or max(1, self.param.num_roots) <= 1:
            return None
        if getattr(dmat, "is_external", False):
            raise NotImplementedError(
                "root_index on external-memory matrices is not supported")
        r = np.zeros(n_rows, np.int32)
        r[:len(ri)] = np.asarray(ri, np.int64).astype(np.int32)
        return torch.from_numpy(r).to(self.device)

    def _sync_margin(self, entry: _CacheEntry) -> None:
        """Fold not-yet-applied trees into the entry's margin, one round's
        trees at a time (the order of the JAX package's per-round path,
        ``learner.py:790-818``); a gblinear margin is recomputed whole,
        a streamed entry's margin batch by batch (:meth:`_sync_margin_ext`)."""
        if entry.external:
            self._sync_margin_ext(entry)
            return
        if self._linear:
            if entry.margin is None or entry.applied != self.gbtree.version:
                entry.margin = self.gbtree.predict_margin(entry.binned,
                                                          entry.base)
                entry.applied = self.gbtree.version
            return
        if entry.applied > self.gbtree.num_trees:
            entry.margin, entry.applied = None, 0
        if entry.margin is None:
            entry.margin = entry.base.clone()
        per_round = self.gbtree.trees_per_round
        while entry.applied < self.gbtree.num_trees:
            n = min(per_round, self.gbtree.num_trees - entry.applied)
            entry.margin = self.gbtree.predict_incremental(
                entry.binned, entry.margin, entry.applied, n, entry.root,
                router=self._router())
            entry.applied += n

    def _sync_margin_ext(self, entry: _CacheEntry) -> None:
        """A streamed entry's margin (``learner.py:820-846``): the trees
        not yet applied, summed from 0 batch by batch, added to the
        margin at once."""
        if entry.margin is None:
            entry.margin = entry.base.clone()
            entry.applied = 0
        if entry.applied >= self.gbtree.num_trees:
            return
        n_new = self.gbtree.num_trees - entry.applied
        parts = [self.gbtree.predict_contrib(batch, entry.applied, n_new)
                 for _, batch in entry.dmat.device_batches(self.device)]
        entry.margin = entry.margin + torch.cat(parts)
        entry.applied = self.gbtree.num_trees

    def _router(self):
        """The row router of the cached matrices' traversal: column
        split's on their blocks of the features, else None."""
        if self._col is None:
            return None
        return (self._col.raw_router if self.gbtree.exact_raw
                else self._col.bin_router)

    # ------------------------------------------------------------ profiling
    @property
    def profiler(self):
        """The :class:`~xgboost_tpu_torch.obs.RoundProfiler`, made at
        first use when ``profile >= 1``, or at level 0 when the event log
        is on (``obs.phases_enabled``), else None
        (``learner.py:851-870``).  Phases end on device barriers and keep
        the rounds per round, the cost contract of ``profile=1``."""
        if self._profiler is not None:
            return self._profiler
        from xgboost_tpu_torch import obs
        if self.param.profile <= 0 and not obs.phases_enabled():
            return None
        self._profiler = obs.RoundProfiler(self.param.profile,
                                           self.param.profile_dir or None)
        self._profiler.start()
        return self._profiler

    # ------------------------------------------------------------- training
    def _round_key(self, iteration: int):
        """The round's sampling key, ``fold_in(PRNGKey(seed), iteration)``
        (``learner.py:1313-1316``), a host value; None when nothing
        samples."""
        if not self.gbtree.cfg.sampled:
            return None
        return prng.fold_in(prng.PRNGKey(self.param.seed), iteration)

    def _round(self, entry: _CacheEntry, iteration: int, prof=None,
               fobj=None) -> None:
        """One boosting round on an entry, all on the device, in the
        phases ``predict`` (fold new trees into the margin), ``gradient``
        and ``grow`` when ``prof`` is a profiler (``learner.py:873-930``).
        The objective's gradient reads the entry's info, the round and a
        padded rank layout; a custom objective ``fobj(preds, dtrain)``
        instead sees the transformed predictions of the user's rows
        (1-D for one group) and its ``(grad, hess)`` go through
        :meth:`boost`."""
        def ph(name):
            return prof.phase(name) if prof else nullcontext()
        with ph("predict") as p:
            self._announce_rank_path(entry)
            self._sync_margin(entry)
            if prof:
                p.block(entry.margin)
        if fobj is not None:
            if getattr(entry.dmat, "is_sharded", False):
                raise NotImplementedError(
                    "custom objectives need every row's prediction and "
                    "gradient; load replicated (DMatrix) for them")
            pred = entry.user_rows(self._gather_rows(
                entry, self.obj.pred_transform(entry.margin)).cpu().numpy())
            grad, hess = fobj(pred[:, 0] if pred.shape[1] == 1 else pred,
                              entry.dmat)
            self._boost(entry.dmat, grad, hess)
            return
        with ph("gradient") as p:
            info = entry.info
            if entry.labels_checked != info.version:
                self.obj.validate_labels(info)
                entry.labels_checked = info.version
            if (entry.block is not None
                    and self.param.objective.startswith("rank:")):
                # the groups span the ranks' blocks: every row's margin,
                # every row's gradient, this rank's block of it
                from xgboost_tpu_torch.parallel.dp import shard_rows
                gh = shard_rows(self._dist, self.obj.get_gradient(
                    self._gather_rows(entry, entry.margin), entry.dmat.info,
                    iteration))
            else:
                gh = self.obj.get_gradient(entry.margin, info, iteration,
                                           pad_prep=entry.rank_pad_prep)
            if prof:
                p.block(gh)
        with ph("grow") as p:
            self._grow(entry, gh, iteration)
            if prof:
                p.block(entry.margin)

    def _grow(self, entry: _CacheEntry, gh: torch.Tensor,
              iteration: int) -> None:
        """The round's updaters on the gradient snapshot ``gh``
        (``learner.py:1337-1376``): growth (the exact grower builds the
        training matrix's ranks once), then ``refresh`` over every tree,
        ``refresh,prune`` pruning against the refreshed gains, after which
        every cached margin is stale."""
        if self._linear:
            # gblinear (learner.py:1317-1323): the margin is recomputed
            self.gbtree.do_boost(entry.binned, gh, entry.info,
                                 mesh=self._dist)
            entry.margin = None
            self._sync_margin(entry)
            return
        from xgboost_tpu_torch.models.updaters import grows, parse_updaters
        ups = parse_updaters(self.param.updater)
        if entry.external:
            # paged growth (learner.py:1326-1336)
            if "refresh" in ups:
                raise NotImplementedError(
                    "updater=refresh is not supported on external-memory "
                    "matrices")
            entry.margin = entry.margin + self.gbtree.do_boost_paged(
                entry.dmat, gh, key=self._round_key(iteration),
                mesh=self._dist)
            entry.applied = self.gbtree.num_trees
            return
        grow = grows(ups)
        if grow and self.gbtree.exact_raw and entry.exact_ranks is None:
            from xgboost_tpu_torch.models.colmaker import build_exact_ranks
            rk, uq = build_exact_ranks(entry.exact_host)
            entry.exact_ranks = (torch.from_numpy(rk).to(self.device),
                                 torch.from_numpy(uq).to(self.device))
            entry.exact_host = None
        if grow:
            entry.margin = entry.margin + self.gbtree.do_boost(
                entry.binned, gh, row_valid=entry.row_valid,
                key=self._round_key(iteration), root=entry.root,
                exact_has_missing=entry.exact_has_missing,
                exact_ranks=entry.exact_ranks, mesh=self._dist,
                col=self._col)
            entry.applied = self.gbtree.num_trees
        if "refresh" in ups:
            self.gbtree.do_refresh(entry.binned, gh,
                                   row_valid=entry.row_valid, root=entry.root,
                                   mesh=self._dist, router=self._router())
            if "prune" in ups and self.param.gamma > 0.0 and not grow:
                self.gbtree.prune_all()
            for e in self._cache.values():
                e.margin, e.applied = None, 0
            self._sync_margin(entry)

    def _profiled_round(self, entry: _CacheEntry, iteration: int,
                        fobj=None) -> None:
        prof = self.profiler
        if prof is None:
            self._round(entry, iteration, fobj=fobj)
            return
        prof.begin_round(iteration)
        try:
            self._round(entry, iteration, prof, fobj)
        finally:
            prof.end_round()

    def update(self, dtrain: DMatrix, iteration: int, fobj=None):
        """One boosting round (reference UpdateOneIter); ``iteration``
        picks the round's sampling key.  With ``fobj`` the round boosts
        from the custom objective's gradients (``learner.py:915-929``)."""
        self.update_many(dtrain, iteration, 1, fobj)

    def boost(self, dtrain: DMatrix, grad, hess) -> None:
        """One round grown from given gradients (``learner.py:1276-1304``;
        reference XGBoosterBoostOneIter): ``grad`` / ``hess`` per user row
        (and group), scattered to their slots on a padded rank entry,
        whose padding slots get zeros; under row split every row's,
        of which this rank takes its block.  The round's sampling key is
        that of round ``num_boosted_rounds``, which is also the round of
        the ``mock=`` coordinates."""
        if getattr(dtrain, "is_sharded", False):
            raise NotImplementedError(
                "boost needs every row's gradients; load replicated "
                "(DMatrix) for it")
        self._lazy_init(dtrain)
        mock.begin_round(self.gbtree.num_boosted_rounds)
        self._boost(dtrain, grad, hess)

    def _boost(self, dtrain: DMatrix, grad, hess) -> None:
        entry = self._entry(dtrain)
        self._sync_margin(entry)
        K = self._K
        g = np.asarray(grad, np.float32).reshape(dtrain.num_row, K)
        h = np.asarray(hess, np.float32).reshape(dtrain.num_row, K)
        if entry.block is not None:
            # every row's gradients: this rank takes its block's
            from xgboost_tpu_torch.parallel.dp import shard_rows
            g, h = shard_rows(self._dist, g), shard_rows(self._dist, h)
        if entry.rank_pad_prep is not None:
            n_dev = self._entry_rows(entry)
            gp = np.zeros((n_dev, K), np.float32)
            hp = np.zeros((n_dev, K), np.float32)
            gp[entry.rank_pad_prep.user_map] = g
            hp[entry.rank_pad_prep.user_map] = h
            g, h = gp, hp
        gh = torch.from_numpy(np.stack([g, h], axis=-1)).to(self.device)
        self._grow(entry, gh, self.gbtree.num_boosted_rounds)

    def _resolve_rounds_per_dispatch(self, n_rows: int,
                                     override=None) -> int:
        """Rounds per segment (``learner.py:935``): env
        ``XGBTPU_ROUNDS_PER_DISPATCH`` > ``override`` > the
        ``rounds_per_dispatch`` parameter; ``-1`` (auto) sizes it with
        the JAX package's formula, ``K >= 9 * fixed / (per_row * rows)``
        clamped to [1, 64]; ``0`` = one round per segment."""
        env = os.environ.get("XGBTPU_ROUNDS_PER_DISPATCH")
        if env not in (None, ""):
            k = int(env)
        elif override is not None:
            k = int(override)
        else:
            k = int(self.param.rounds_per_dispatch)
        if k >= 0:
            return k
        per_round = _FIT_PER_ROW_S * max(1, int(n_rows))
        return max(1, min(64, math.ceil(9.0 * _FIT_FIXED_ROUND_S
                                        / per_round)))

    def _segment_blockers(self, n_rounds: int, fobj=None, entry=None,
                          evals=(), feval=None) -> List[str]:
        """The JAX package's reasons for one round per dispatch
        (``learner.py:1041-1062``) that apply to the port, in its order."""
        from xgboost_tpu_torch.models.updaters import parse_updaters
        ups = parse_updaters(self.param.updater)
        checks = (
            ("custom_objective", fobj is not None),
            ("single_round", n_rounds <= 1),
            ("booster", self.param.booster != "gbtree"),
            ("external_train", entry is not None and entry.external),
            ("col_split", self._col is not None),
            ("profiler", self.profiler is not None),
            ("prune", self.param.gamma > 0.0 and "prune" in ups),
            ("multi_root", max(1, self.param.num_roots) != 1),
            ("exact", getattr(self.gbtree, "exact_raw", False)),
            ("refresh", "refresh" in ups),
            ("no_grow_updater", not any(u.startswith("grow") for u in ups)),
            ("no_fused_grad", getattr(self.obj, "needs_host_margin", False)),
            ("external_eval", any(self._entry(d).external
                                  for d, _ in evals)),
            ("sharded_eval_feval", feval is not None and any(
                getattr(d, "is_sharded", False) for d, _ in evals)),
        )
        return [name for name, blocked in checks if blocked]

    def update_many(self, dtrain: DMatrix, first_iteration: int,
                    n_rounds: int, fobj=None, *, evals=None, feval=None,
                    eval_callback=None, round_callback=None,
                    segment_callback=None, plan_callback=None,
                    boundary_align: int = 0,
                    rounds_per_dispatch=None) -> None:
        """``n_rounds`` rounds in a plain loop that reads nothing back to
        the host inside a segment unless ``evals`` asks for it (the JAX
        package's fused round scan, ``learner.py:967``).  Segments are
        ``rounds_per_dispatch`` rounds
        (:meth:`_resolve_rounds_per_dispatch`), or one round where the
        JAX package would not fuse (a profiler, multi-root trees, pruning
        ...).  Round i's index picks its sampling key,
        ``fold_in(PRNGKey(seed), i)``, on either path, so a segment and
        per-round training give the same bits; it also numbers the
        callbacks and eval lines.  ``fobj`` is a custom objective
        (:meth:`_round`).  On the per-round path an active
        profiler times each round's ``predict``, ``gradient`` and
        ``grow`` phases and its eval lines as ``eval``.

        Hooks (the CLI and the pipeline ride these):

        - ``evals`` / ``feval``: a watchlist ``[(dmat, name), ...]`` and
          a custom metric; round i's line is :meth:`eval_set`'s for i;
        - ``eval_callback(iteration, msg)``: each round's eval line;
        - ``round_callback(iteration)``: before each round, on the
          per-round path only (a segment has no host point between its
          rounds);
        - ``segment_callback(last_iteration)``: a segment ended (the
          checkpoint and save hook);
        - ``plan_callback(k)``: the resolved segment size, once, 0 where
          the JAX package would not fuse;
        - ``boundary_align``: end segments at multiples of it (periodic
          saves need the model exactly there)."""
        self._lazy_init(dtrain)
        entry = self._entry(dtrain)
        evals = list(evals) if evals else []
        k = 0
        if not self._segment_blockers(n_rounds, fobj, entry, evals,
                                      feval):
            k = self._resolve_rounds_per_dispatch(dtrain.num_row,
                                                  rounds_per_dispatch)
        if plan_callback is not None:
            plan_callback(k)
        per_round = k <= 0
        k = max(1, k)
        align = max(0, int(boundary_align))
        self._sync_margin(entry)
        done = 0
        while done < n_rounds:
            first = first_iteration + done
            seg = min(k, n_rounds - done)
            if align:
                seg = min(seg, align - first % align)
            for i in range(first, first + seg):
                if per_round and round_callback is not None:
                    round_callback(i)
                # the round boundary before the gradient (learner.py:
                # 1307-1311, gbtree.py:861): the version of the mock=
                # coordinates, the heartbeat, the gang hook, the
                # collective tallies' round; segments do not block it
                mock.begin_round(i)
                # a profiler blocks segments: it only ever times per round
                self._profiled_round(entry, i, fobj)
                if evals:
                    prof = self.profiler
                    with prof.phase("eval") if prof else nullcontext():
                        msg = self.eval_set(evals, i, feval)
                    if eval_callback is not None:
                        eval_callback(i, msg)
            done += seg
            if segment_callback is not None:
                segment_callback(first + seg - 1)

    # ------------------------------------------------------- tenant lanes
    def fused_lane_spec(self, dtrain: DMatrix, first_iteration: int,
                        n_rounds: int, rounds_per_dispatch=None):
        """Gang-batching eligibility and operands for this booster's next
        ``n_rounds`` rounds (``learner.py:1193``): ``(LaneSpec, None)``
        when the lane dispatcher may stack it with its bucket peers, else
        ``(None, reason)``, the reasons of the JAX package that apply to
        the port (``mesh``: lanes are single-process), plus ``ensemble``:
        a round of more than one tree
        (``K * num_parallel_tree > 1``) runs solo through K3 here, and
        ``rank``: a device LambdaRank lane on the sort path, which the
        JAX package stacks, runs solo here (its gradient needs the
        matrix's groups and the round).  A padded rank entry declines
        with ``rank_layout`` and the host rank path with
        ``no_fused_grad``, as in the JAX package.  On
        eligibility the labels are checked and the entry's margin is
        synced, as :meth:`update_many` would.  A sampled lane draws with
        its own ``PRNGKey(seed)`` (``LaneSpec.base_key``) and absolute
        iterations, the keys of its solo rounds."""
        from xgboost_tpu_torch.models.updaters import parse_updaters
        if self.param.booster != "gbtree":
            return None, "booster"
        self._lazy_init(dtrain)
        entry = self._entry(dtrain)
        ups = parse_updaters(self.param.updater)
        npar = max(1, self.param.num_parallel_tree)
        checks = (
            ("no_rounds", n_rounds < 1),
            ("external_train", entry.external),
            ("mesh", self._dist is not None),
            ("col_split", self._col is not None),
            ("ensemble", self._K * npar > 1),
            ("rank", self._device_rank() and entry.rank_pad_prep is None),
            ("profiler", self.profiler is not None),
            ("prune", self.param.gamma > 0.0 and "prune" in ups),
            ("multi_root", max(1, self.param.num_roots) != 1),
            ("exact", self.gbtree.exact_raw),
            ("refresh", "refresh" in ups),
            ("no_grow_updater", not any(u.startswith("grow") for u in ups)),
            ("rank_layout", entry.rank_pad_prep is not None),
            ("no_fused_grad", self.obj.fused_grad() is None),
        )
        blockers = [name for name, blocked in checks if blocked]
        if blockers:
            return None, blockers[0]
        k = self._resolve_rounds_per_dispatch(dtrain.num_row,
                                              rounds_per_dispatch)
        if k <= 0:
            return None, "rounds_per_dispatch_0"
        self.obj.validate_labels(dtrain.info)
        entry.labels_checked = dtrain.info.version
        self._sync_margin(entry)
        N = int(entry.binned.shape[0])
        return LaneSpec(
            booster=self, entry=entry, n_rows=N,
            n_features=int(entry.binned.shape[1]), n_rounds=int(n_rounds),
            first_iteration=int(first_iteration), seg_k=int(k), K=self._K,
            npar=npar, cfg=self.gbtree.cfg, grad_fn=self.obj.fused_grad(),
            split_finder=self.gbtree.split_finder(),
            subsample=float(self.param.subsample),
            base_key=prng.PRNGKey(self.param.seed), binned=entry.binned,
            margin=entry.margin,
            label=dtrain.info.on_device("label", N, self.device),
            weight=dtrain.info.on_device("weight", N, self.device),
            cut_values=self.gbtree.cut_values_dev,
            n_cuts=self.gbtree.n_cuts_dev), None

    def absorb_lane_segment(self, spec: LaneSpec, stacks, margin,
                            n_rounds: int) -> None:
        """Install one gang segment's outputs for this lane
        (``learner.py:1264``): its flat ``(n_rounds, n_nodes)`` tree
        stack joins the ensemble and ``margin`` (the lane's rows of the
        stacked margins) becomes the entry's."""
        self.gbtree.absorb_round_stacks(stacks, n_rounds)
        spec.entry.margin = margin
        spec.entry.applied = self.gbtree.num_trees

    # ----------------------------------------------------------- prediction
    def _bins_for(self, data: DMatrix) -> torch.Tensor:
        """Bins of a one-off matrix: a dense source quantizes on the
        device, sparse data on the host; both give the same bins.  An
        exact-mode model reads raw values (``learner.py:1645-1647``), a
        gblinear one its (F, N) dense matrix."""
        if self._linear:
            return self.gbtree.device_matrix(data)
        if self.gbtree.exact_raw:
            return self._raw_dense(data)[0]
        src = data.dense_source()
        if src is not None and np.isnan(src[1]):
            X = torch.from_numpy(np.ascontiguousarray(src[0])).to(self.device)
            F = self.gbtree.cuts.num_feature
            if X.shape[1] < F:   # absent columns are missing
                X = torch.nn.functional.pad(X, (0, F - X.shape[1]),
                                            value=float("nan"))
            return bin_dense_device(X, self.gbtree.cut_values_dev)
        return self._device_bins(bin_matrix(data, self.gbtree.cuts))

    def predict(self, data, output_margin: bool = False,
                ntree_limit: int = 0, pred_leaf: bool = False) -> np.ndarray:
        """Predictions as numpy (reference BoostLearner::Predict); ``data``
        may also be a 2-D array (NaN = missing)."""
        if self.gbtree is None:
            raise ValueError("model not trained/loaded")
        if not isinstance(data, DMatrix) and \
                not getattr(data, "is_external", False) and \
                not getattr(data, "is_sharded", False):
            data = DMatrix(np.asarray(data, dtype=np.float32))
        cached = self._cache.get(id(data))
        if cached is None and getattr(data, "is_external", False):
            # a one-off external matrix: an entry that is not registered
            # (learner.py:1594-1598)
            cached = self._build_ext_entry(data)
        if cached is not None and cached.external:
            return self._predict_streamed(cached, output_margin,
                                          ntree_limit, pred_leaf)
        if cached is None and getattr(data, "is_sharded", False):
            cached = self._make_shard_loaded_entry(data)   # not registered
        if cached is not None and cached.block is not None:
            return self._predict_block(cached, output_margin, ntree_limit,
                                       pred_leaf)
        if cached is not None:
            binned, base, root = cached.binned, cached.base, cached.root
        else:
            if self.num_feature and data.num_col > self.num_feature:
                raise ValueError(
                    f"data has {data.num_col} features, model was trained "
                    f"with {self.num_feature}")
            binned = self._bins_for(data)
            base = self._base_margin_of(data, data.num_row)
            root = self._root_of(data, data.num_row)
        # a cached matrix under column split: the rank's block of it
        col = {"router": self._router()} if (
            cached is not None and self._col is not None) else {}
        if pred_leaf:
            leaves = self.gbtree.predict_leaf(binned, ntree_limit, root,
                                              **col).cpu().numpy()
            return cached.user_rows(leaves) if cached is not None else leaves
        if cached is not None and ntree_limit == 0:
            self._sync_margin(cached)
            margin = cached.margin
        else:
            margin = self.gbtree.predict_margin(binned, base, ntree_limit,
                                                root, **col)
        out = self.obj.pred_transform(margin, output_margin=output_margin)
        out = out.cpu().numpy()
        if cached is not None:
            out = cached.user_rows(out)
        from xgboost_tpu_torch.obs.metrics import predict_metrics
        predict_metrics().rows.inc(out.shape[0])
        # one column -> (N,); softprob and multiclass margins stay (N, K)
        return out[:, 0] if out.shape[1] == 1 else out

    def _predict_block(self, entry: _CacheEntry, output_margin: bool,
                       ntree_limit: int, pred_leaf: bool) -> np.ndarray:
        """Predictions of a row-split entry (``learner.py:1565-1590,
        1689-1702``): a replicated matrix's blocks gathered over the
        ranks, padding cut, so every rank returns all N rows, byte-equal
        to a world of one; a split-loaded matrix's rows of this rank
        only (no rank holds them all)."""
        if pred_leaf:
            out = self.gbtree.predict_leaf(entry.binned, ntree_limit,
                                           entry.root)
        else:
            if ntree_limit == 0:
                self._sync_margin(entry)
                margin = entry.margin
            else:
                margin = self.gbtree.predict_margin(
                    entry.binned, entry.base, ntree_limit, entry.root)
            out = self.obj.pred_transform(margin,
                                          output_margin=output_margin)
        if getattr(entry.dmat, "is_sharded", False):
            out = out.cpu().numpy()[:entry.dmat.local_num_row]
        else:
            out = self._gather_rows(entry, out).cpu().numpy()
        from xgboost_tpu_torch.obs.metrics import predict_metrics
        predict_metrics().rows.inc(out.shape[0])
        if pred_leaf or out.shape[1] != 1:
            return out
        return out[:, 0]

    def _predict_streamed(self, entry: _CacheEntry, output_margin: bool,
                          ntree_limit: int, pred_leaf: bool) -> np.ndarray:
        """Predictions of a streamed external entry, batch by batch
        (``learner.py:1599-1615``)."""
        batches = entry.dmat.device_batches(self.device)
        if pred_leaf:
            out = torch.cat([self.gbtree.predict_leaf(b, ntree_limit)
                             for _, b in batches]).cpu().numpy()
        else:
            if ntree_limit == 0:
                self._sync_margin(entry)
                margin = entry.margin
            else:
                margin = torch.cat([self.gbtree.predict_margin(
                    b, entry.base[s:s + b.shape[0]], ntree_limit)
                    for s, b in batches])
            out = self.obj.pred_transform(
                margin, output_margin=output_margin).cpu().numpy()
        from xgboost_tpu_torch.obs.metrics import predict_metrics
        predict_metrics().rows.inc(out.shape[0])
        return out[:, 0] if out.ndim == 2 and out.shape[1] == 1 else out

    # ----------------------------------------------------------- evaluation
    def _metrics(self, feval=None) -> List:
        names = list(self.param.eval_metric)
        if not names and feval is None:
            names = [self.obj.default_metric]
        return [create_metric(n) for n in names]

    def eval_set(self, evals: Sequence[Tuple[DMatrix, str]],
                 iteration: int = 0, feval=None) -> str:
        """``[iter]\\tname-metric:value`` (reference EvalSet::Eval)."""
        parts = [f"[{iteration}]"]
        for dmat, name in evals:
            entry = self._entry(dmat)
            self._sync_margin(entry)
            if getattr(dmat, "is_sharded", False):
                self._eval_sharded(dmat, entry, name, parts, feval)
                continue
            tr = entry.user_rows(self._gather_rows(
                entry, self.obj.eval_transform(entry.margin)).cpu().numpy())
            preds = tr[:, 0] if tr.shape[1] == 1 else tr   # (N,) or (N, K)
            labels = np.asarray(dmat.get_label())
            weights = np.asarray(dmat.get_weight())
            gptr = dmat.info.group_ptr
            for m in self._metrics(feval):
                if getattr(m, "needs_fold_index", False):
                    val = m(preds, labels, weights, gptr,
                            fold_index=dmat.info.fold_index)
                else:
                    val = m(preds, labels, weights, gptr)
                parts.append(f"{name}-{m.metric_name}:{val:.6f}")
            if feval is not None:
                mname, val = feval(preds, dmat)
                parts.append(f"{name}-{mname}:{val:.6f}")
        return "\t".join(parts)

    def _eval_sharded(self, dmat, entry: _CacheEntry, name: str,
                      parts: List[str], feval) -> None:
        """The eval of a split-loaded matrix (``learner.py:1765-1840``):
        each rank's metric partials on its own rows, summed over the
        ranks (the reference's rabit ``Allreduce`` of ``(sum, wsum)``);
        the exact AUC merges every rank's value runs, unless their count
        passes ``dist_auc_max_runs`` or ``dist_auc=approx`` asks for the
        mean of the ranks' AUCs."""
        if feval is not None:
            raise NotImplementedError(
                "a custom feval needs every row's prediction; load the eval "
                "set replicated (DMatrix)")
        from xgboost_tpu_torch.metrics import (_DIST_METRICS, auc_compress,
                                               auc_exact_from_runs)
        tr = self.obj.eval_transform(entry.margin).cpu().numpy()[
            :dmat.local_num_row]
        p = tr[:, 0] if tr.shape[1] == 1 else tr
        labels = np.asarray(dmat.info.label)
        weights = np.asarray(dmat.info.get_weight(dmat.local_num_row))
        for m in self._metrics():
            if not hasattr(m, "partial_fn"):
                raise NotImplementedError(
                    f"metric {m.metric_name!r} has no distributed "
                    "partial-sum form; supported on split-loaded data: "
                    f"{sorted(_DIST_METRICS)}")
            if m.metric_name == "auc" and self.param.dist_auc != "approx":
                runs = auc_compress(p, labels, weights)
                limit = int(self.param.dist_auc_max_runs)
                # decided on the summed run count, so every rank takes the
                # same collective
                total_runs = int(dmat.allsum(
                    np.array([float(len(runs))]))[0])
                if total_runs > limit:
                    if not getattr(self, "_warned_auc_runs", False):
                        self._warned_auc_runs = True
                        print(f"[dist-auc] {total_runs} distinct-value runs "
                              f"across ranks exceeds dist_auc_max_runs="
                              f"{limit}; falling back to the reference's "
                              "approximate mean-of-shards AUC",
                              file=sys.stderr)
                    val = m.finalize_fn(dmat.allsum(
                        m.partial_fn(p, labels, weights, None)))
                else:
                    val = auc_exact_from_runs(dmat.allgatherv(runs))
            else:
                val = m.finalize_fn(dmat.allsum(
                    m.partial_fn(p, labels, weights, None)))
            parts.append(f"{name}-{m.metric_name}:{val:.6f}")

    def eval(self, data: DMatrix, name: str = "eval",
             iteration: int = 0) -> str:
        return self.eval_set([(data, name)], iteration)

    # ---------------------------------------------------------- model store
    def _header(self, full: bool) -> dict:
        header = {"magic": _MAGIC, "param": _jsonable(self.param.to_dict())}
        if full:
            header.update(objective=self.param.objective,
                          booster=self.param.booster)
        header.update(num_feature=self.num_feature,
                      attributes=self.attributes,
                      best_iteration=self.best_iteration)
        return header

    def save_model(self, path: str, save_base64: bool = False):
        """Write the model file through :func:`atomic_write` with its CRC
        footer; ``save_base64`` writes the text-safe ``bs64`` encoding."""
        if self.gbtree is None:
            raise ValueError("nothing to save")
        payload = _npz_bytes(self._header(True), self.gbtree.get_state())
        if save_base64:
            payload = b"bs64\t" + base64.b64encode(payload) + b"\n"
        atomic_write(path, add_footer(payload))

    def load_model(self, path: str):
        self.load_raw(verify_model_bytes(read_file(path), name=path),
                      name=path)

    def load_raw(self, raw: bytes, name: str = "<buffer>"):
        """Load from bytes (``learner.py:1895-1924``): our npz, its bs64
        encoding, or the reference's binary model (``binf``, or its own
        ``bs64`` encoding), which :mod:`~xgboost_tpu_torch.compat`
        reads."""
        head = raw[:5]
        if head[:4] in (b"binf", b"bs64") and head != b"bs64\t":
            self._load_reference(raw)
            return
        if head == b"bs64\t":
            try:
                raw = base64.b64decode(b"".join(raw[5:].split()),
                                       validate=True)
            except ValueError as e:
                raise ModelIntegrityError(
                    f"{name}: torn/invalid bs64 payload: {e}")
            if not raw.startswith(b"PK"):   # the reference's stream
                self._load_reference(raw)
                return
        try:
            z = np.load(io.BytesIO(raw), allow_pickle=False)
        except (ValueError, OSError, zipfile.BadZipFile) as e:
            raise ModelIntegrityError(
                f"{name} is not an xgboost_tpu model file: {e}")
        with z:
            header = json.loads(bytes(z["header"]).decode())
            if header.get("magic") != _MAGIC:
                raise ValueError(f"{name}: not an xgboost_tpu model")
            param = TrainParam.from_dict(header["param"])
            state = {k: z[k] for k in z.files if k != "header"}
        self.param = param
        self.num_feature = header["num_feature"]
        self.attributes = header.get("attributes", {})
        self.best_iteration = header.get("best_iteration", -1)
        self._init_obj()
        if self._linear:
            from xgboost_tpu_torch.models.gblinear import GBLinear
            self.gbtree = GBLinear.from_state(self.param, state, self.device)
        else:
            self.gbtree = GBTree.from_state(self.param, state, self.device)
        self._cache.clear()

    def _load_reference(self, src) -> None:
        """Adopt a reference-format model's state (path or bytes;
        ``learner.py:1952-1961``)."""
        from xgboost_tpu_torch.compat import load_reference_model
        other = load_reference_model(src, device=self.device)
        self.param = other.param
        self.obj = other.obj
        self.gbtree = other.gbtree
        self.num_feature = other.num_feature
        self._cache.clear()

    def save_raw(self) -> bytes:
        return _npz_bytes(self._header(False), self.gbtree.get_state())

    # ---------------------------------------------------------------- dumps
    def get_dump(self, fmap: str = "", with_stats: bool = False) -> List[str]:
        """One text block a tree (:func:`xgboost_tpu_torch.dump.dump_trees`)."""
        from xgboost_tpu_torch.dump import dump_trees
        return dump_trees(self, fmap, with_stats)

    def dump_model(self, fout: str, fmap: str = "",
                   with_stats: bool = False) -> None:
        """The dump with ``booster[i]:`` headers, written atomically."""
        atomic_write(fout, "".join(
            f"booster[{i}]:\n{s}" for i, s in
            enumerate(self.get_dump(fmap, with_stats))).encode())

    def get_fscore(self, fmap: str = "") -> Dict[str, int]:
        """Split counts by feature (reference ``get_fscore``)."""
        from xgboost_tpu_torch.dump import feature_importance
        return feature_importance(self, fmap)


_MAXIMIZE_METRICS = ("auc", "ams", "ndcg", "map", "pre")


def _parse_eval(msg: str) -> Dict[str, float]:
    """``{"name-metric": value}`` from an eval line."""
    out = {}
    for part in msg.split("\t")[1:]:
        k, _, v = part.rpartition(":")
        out[k] = float(v)
    return out


def _npz_bytes(header: dict, state: dict) -> bytes:
    """An npz archive (``np.load`` reads it) with fixed member times, so
    equal models give equal bytes (``np.savez`` stamps the clock)."""
    buf = io.BytesIO()
    write_npz(buf, [("header", np.frombuffer(json.dumps(header).encode(),
                                             dtype=np.uint8)),
                    *state.items()])
    return buf.getvalue()


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


def train(params, dtrain: DMatrix, num_boost_round: int = 10,
          evals: Sequence[Tuple[DMatrix, str]] = (), obj=None, feval=None,
          maximize: Optional[bool] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval=True,
          xgb_model=None, init_model=None, device=None) -> Booster:
    """Train a booster (reference wrapper/xgboost.py:533-632;
    ``xgboost_tpu/learner.py:2042``).  ``init_model`` / ``xgb_model``
    (aliases; a Booster or a model path) continue training: new rounds
    append to its ensemble.  ``early_stopping_rounds`` stops after that
    many rounds without improvement of the last metric of the last eval
    set (larger is better for ``auc``, ``ams``, ``ndcg``, ``map`` and
    ``pre`` unless ``maximize`` says otherwise) and sets
    ``best_score`` / ``best_iteration``.  ``obj`` is a custom objective
    ``obj(preds, dtrain) -> (grad, hess)`` (:meth:`Booster.update`)."""
    if init_model is not None and xgb_model is not None:
        raise ValueError("pass init_model or xgb_model, not both "
                         "(they are aliases)")
    xgb_model = xgb_model if xgb_model is not None else init_model
    start_round = 0
    if xgb_model is not None:
        bst = xgb_model if isinstance(xgb_model, Booster) else Booster(
            params, model_file=xgb_model, device=device)
        bst.set_param(params or {})
        if bst.gbtree is not None:
            start_round = bst.gbtree.num_boosted_rounds
    else:
        bst = Booster(params, cache=[dtrain] + [d for d, _ in evals],
                      device=device)
    best_score, best_iter, best_msg = None, 0, ""
    if not evals and early_stopping_rounds is None:
        bst.update_many(dtrain, start_round, num_boost_round, obj)
        rounds = ()
    else:
        rounds = range(num_boost_round)
    for i in rounds:
        bst.update(dtrain, start_round + i, obj)
        if not evals:
            continue
        prof = bst.profiler
        with prof.phase("eval") if prof else nullcontext():
            msg = bst.eval_set(evals, i, feval)
        if verbose_eval and (verbose_eval is True or int(verbose_eval) <= 1
                             or i % int(verbose_eval) == 0
                             or i == num_boost_round - 1):
            print(msg)
        scores = _parse_eval(msg)
        if evals_result is not None:
            for k, v in scores.items():
                evals_result.setdefault(k, []).append(v)
        if early_stopping_rounds is not None:
            last_key = list(scores)[-1]
            score = scores[last_key]
            mx = maximize
            if mx is None:
                metric = last_key.split("-", 1)[1]
                mx = any(metric.startswith(m) for m in _MAXIMIZE_METRICS)
            if best_score is None or (score > best_score if mx
                                      else score < best_score):
                best_score, best_iter, best_msg = score, i, msg
            elif i - best_iter >= early_stopping_rounds:
                if verbose_eval:
                    print(f"Stopping. Best iteration:\n{best_msg}")
                break
    if early_stopping_rounds is not None and best_score is not None:
        bst.best_score = best_score
        bst.best_iteration = best_iter
    finish_profile(bst)
    return bst


class CVPack:
    """One fold's train and test matrices and its booster
    (``learner.py:2144``; reference wrapper/xgboost.py:635-650)."""

    def __init__(self, dtrain: DMatrix, dtest: DMatrix, params,
                 device=None):
        self.dtrain, self.dtest = dtrain, dtest
        self.bst = Booster(params, cache=[dtrain, dtest], device=device)
        self.watchlist = [(dtrain, "train"), (dtest, "test")]

    def update(self, i, fobj):
        self.bst.update(self.dtrain, i, fobj)

    def eval(self, i, feval):
        return self.bst.eval_set(self.watchlist, i, feval)


def mknfold(dall: DMatrix, nfold: int, params, seed: int, evals=(),
            fpreproc=None, device=None) -> List[CVPack]:
    """``nfold`` folds of ``dall`` (``learner.py:2157``): the rows of
    ``RandomState(seed).permutation`` in ``np.array_split`` parts, each
    fold's rows sorted; ``fpreproc(dtrain, dtest, params)`` may rewrite
    each fold's matrices and parameters."""
    rng = np.random.RandomState(seed)
    folds = np.array_split(rng.permutation(dall.num_row), nfold)
    packs = []
    for k in range(nfold):
        train_idx = np.concatenate([folds[j] for j in range(nfold)
                                    if j != k])
        dtrain = dall.slice(np.sort(train_idx))
        dtest = dall.slice(np.sort(folds[k]))
        p = params_to_dict(params)
        if fpreproc is not None:
            dtrain, dtest, p = fpreproc(dtrain, dtest, p)
        packs.append(CVPack(dtrain, dtest, p, device))
    return packs


def aggcv(rlist: List[str], show_stdv: bool = True) -> str:
    """The folds' eval lines of one round as one line of means (and
    standard deviations), ``cv-<set>-<metric>`` (``learner.py:2177``)."""
    cvmap: Dict[str, List[float]] = {}
    ret = rlist[0].split("\t")[0]
    for line in rlist:
        for part in line.split("\t")[1:]:
            k, _, v = part.rpartition(":")
            cvmap.setdefault(k, []).append(float(v))
    for k, vals in cvmap.items():
        v = np.asarray(vals)
        if show_stdv:
            ret += f"\tcv-{k}:{v.mean():.6f}+{v.std():.6f}"
        else:
            ret += f"\tcv-{k}:{v.mean():.6f}"
    return ret


def cv(params, dtrain: DMatrix, num_boost_round: int = 10, nfold: int = 3,
       metrics=(), obj=None, feval=None, fpreproc=None,
       show_stdv: bool = True, seed: int = 0, verbose_eval: bool = True,
       device=None) -> List[str]:
    """k-fold cross validation (``learner.py:2195``; reference
    wrapper/xgboost.py:697-740): each round boosts every fold, then
    prints and returns the :func:`aggcv` line; ``metrics`` replace the
    parameters' ``eval_metric``."""
    params = params_to_dict(params)
    if metrics:
        params["eval_metric"] = list(metrics)
    packs = mknfold(dtrain, nfold, params, seed, fpreproc=fpreproc,
                    device=device)
    results = []
    for i in range(num_boost_round):
        for p in packs:
            p.update(i, obj)
        line = aggcv([p.eval(i, feval) for p in packs], show_stdv)
        if verbose_eval:
            print(line)
        results.append(line)
    return results


def finish_profile(bst: Booster) -> None:
    """The end of a training run (``learner.py:2128-2130``): the
    profiler's summary at ``profile >= 1``, and its trace written at
    ``profile=2``."""
    if bst._profiler is not None:
        bst._profiler.print_summary()
        bst._profiler.stop()
