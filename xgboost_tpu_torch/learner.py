"""Booster and ``train`` (port of ``xgboost_tpu/learner.py``, the
single-device main path).

``Booster`` orchestrates objective, ensemble and metrics: cuts at first
use, one binned matrix and running margin per DMatrix it has seen
(advanced incrementally per round, the reference's prediction buffer),
``update`` / ``update_many``, ``predict``, ``eval_set`` lines, and model
files (npz + JSON header + CRC footer) that load in both packages.

Every entry point runs on ``device`` (default ``"cuda"``); without a GPU
it raises unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
import zipfile
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.binning import (bin_dense_device, bin_matrix,
                                       compute_cuts)
from xgboost_tpu_torch.config import TrainParam, params_to_dict
from xgboost_tpu_torch.data import DMatrix
from xgboost_tpu_torch.metrics import create_metric
from xgboost_tpu_torch.models.gbtree import GBTree
from xgboost_tpu_torch.objectives import create_objective
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
    if p.booster != "gbtree":
        raise NotImplementedError(
            f"booster={p.booster}: gblinear is ROADMAP.md section 1 item 11")
    if p.dsplit not in ("auto",):
        raise NotImplementedError(
            f"dsplit={p.dsplit}: distributed training is ROADMAP.md section "
            "1 item 13")


class _CacheEntry:
    """Per-DMatrix device state: bins, base margin, running margin."""

    def __init__(self, dmat: DMatrix, binned: torch.Tensor,
                 base: torch.Tensor):
        self.dmat = dmat            # strong ref: id(dmat) keys the cache
        self.binned = binned        # (N, F) on the booster's device
        self.base = base            # (N, K) f32
        self.margin: Optional[torch.Tensor] = None
        self.applied = 0            # trees folded into margin
        self.info_version = dmat.info.version
        self.labels_checked = -1    # info version whose labels passed


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
    subsample: float
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
        self.attributes: Dict[str, str] = {}
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
            from xgboost_tpu_torch.models.gbtree import make_grow_config
            self.gbtree.param = self.param
            self.gbtree.cfg = make_grow_config(self.param,
                                               self.gbtree.cuts.max_bin)

    def _init_obj(self):
        _check_param(self.param)
        self.obj = create_objective(self.param.objective)
        self.obj.set_param("scale_pos_weight", self.param.scale_pos_weight)
        self.obj.set_param("num_class", self.param.num_class)

    @property
    def _K(self) -> int:
        """Output groups: the margin's columns."""
        return max(1, self.param.num_output_group)

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
        if self.gbtree is None:
            self.num_feature = dtrain.num_col
            margin_kw = ({"bin_align_margin": None}
                         if int(self.param.hist_bin_align) > 0 else {})
            cuts = compute_cuts(dtrain, self.param.max_bin,
                                self.param.sketch_eps,
                                self.param.sketch_ratio,
                                bin_align=self._bin_align(), **margin_kw)
            self.gbtree = GBTree(self.param, cuts, self.device)
        for d in self._pending_cache:
            self._entry(d)
        self._pending_cache = []

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
        if entry is None:
            if self.num_feature and dmat.num_col > self.num_feature:
                raise ValueError(
                    f"data has {dmat.num_col} features, model was trained "
                    f"with {self.num_feature}")
            binned = self._device_bins(bin_matrix(dmat, self.gbtree.cuts))
            entry = self._cache[key] = _CacheEntry(
                dmat, binned, self._base_margin_of(dmat, dmat.num_row))
        elif entry.info_version != dmat.info.version:
            # a set_field since: the base margin and the margin built on
            # it are stale
            entry.base = self._base_margin_of(dmat, dmat.num_row)
            entry.margin, entry.applied = None, 0
            entry.info_version = dmat.info.version
        return entry

    def _sync_margin(self, entry: _CacheEntry) -> None:
        """Fold not-yet-applied trees into the entry's margin, one round's
        trees at a time (the order of the JAX package's per-round path,
        ``learner.py:790-818``)."""
        if entry.applied > self.gbtree.num_trees:
            entry.margin, entry.applied = None, 0
        if entry.margin is None:
            entry.margin = entry.base.clone()
        per_round = self.gbtree.trees_per_round
        while entry.applied < self.gbtree.num_trees:
            n = min(per_round, self.gbtree.num_trees - entry.applied)
            entry.margin = self.gbtree.predict_incremental(
                entry.binned, entry.margin, entry.applied, n)
            entry.applied += n

    # ------------------------------------------------------------- training
    def _round(self, entry: _CacheEntry) -> None:
        """One boosting round on a synced entry; all on the device."""
        info = entry.dmat.info
        if entry.labels_checked != info.version:
            self.obj.validate_labels(info)
            entry.labels_checked = info.version
        n = entry.margin.shape[0]
        gh = self.obj.get_gradient(entry.margin,
                                   info.on_device("label", n, self.device),
                                   info.on_device("weight", n, self.device))
        entry.margin = entry.margin + self.gbtree.do_boost(entry.binned, gh)
        entry.applied = self.gbtree.num_trees

    def update(self, dtrain: DMatrix, iteration: int, fobj=None):
        """One boosting round (reference UpdateOneIter)."""
        if fobj is not None:
            raise NotImplementedError(
                "custom objectives: ROADMAP.md section 1 item 6")
        self.update_many(dtrain, iteration, 1)

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

    def _segment_blockers(self, n_rounds: int) -> List[str]:
        """The JAX package's reasons for one round per dispatch
        (``learner.py:1041-1062``) that apply to the port."""
        from xgboost_tpu_torch.models.updaters import parse_updaters
        ups = parse_updaters(self.param.updater)
        checks = (
            ("single_round", n_rounds <= 1),
            ("prune", self.param.gamma > 0.0 and "prune" in ups),
            ("no_grow_updater", not any(u.startswith("grow") for u in ups)),
        )
        return [name for name, blocked in checks if blocked]

    def update_many(self, dtrain: DMatrix, first_iteration: int,
                    n_rounds: int, *, segment_callback=None,
                    rounds_per_dispatch=None) -> None:
        """``n_rounds`` rounds in a plain loop that reads nothing back to
        the host inside a segment (the JAX package's fused round scan,
        ``learner.py:967``).  Segments are ``rounds_per_dispatch`` rounds
        (:meth:`_resolve_rounds_per_dispatch`), or one round where the
        JAX package would not fuse; ``segment_callback(last_iteration)``
        runs at the end of each (the checkpoint hook).  Without sampling
        the round's index changes nothing, so ``first_iteration`` only
        numbers the callbacks."""
        self._lazy_init(dtrain)
        entry = self._entry(dtrain)
        k = 1
        if not self._segment_blockers(n_rounds):
            k = max(1, self._resolve_rounds_per_dispatch(
                dtrain.num_row, rounds_per_dispatch))
        self._sync_margin(entry)
        done = 0
        while done < n_rounds:
            seg = min(k, n_rounds - done)
            for _ in range(seg):
                self._round(entry)
            done += seg
            if segment_callback is not None:
                segment_callback(first_iteration + done - 1)

    # ------------------------------------------------------- tenant lanes
    def fused_lane_spec(self, dtrain: DMatrix, first_iteration: int,
                        n_rounds: int, rounds_per_dispatch=None):
        """Gang-batching eligibility and operands for this booster's next
        ``n_rounds`` rounds (``learner.py:1193``): ``(LaneSpec, None)``
        when the lane dispatcher may stack it with its bucket peers, else
        ``(None, reason)``, the reasons of the JAX package that apply to
        the port, plus ``ensemble``: a round of more than one tree
        (``K * num_parallel_tree > 1``) runs solo through K3 here.  On
        eligibility the labels are checked and the entry's margin is
        synced, as :meth:`update_many` would."""
        from xgboost_tpu_torch.models.updaters import parse_updaters
        if self.param.booster != "gbtree":
            return None, "booster"
        self._lazy_init(dtrain)
        entry = self._entry(dtrain)
        ups = parse_updaters(self.param.updater)
        npar = max(1, self.param.num_parallel_tree)
        checks = (
            ("no_rounds", n_rounds < 1),
            ("prune", self.param.gamma > 0.0 and "prune" in ups),
            ("no_grow_updater", not any(u.startswith("grow") for u in ups)),
            ("ensemble", self._K * npar > 1),
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
            subsample=float(self.param.subsample), binned=entry.binned,
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
        device, sparse data on the host; both give the same bins."""
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
        if not isinstance(data, DMatrix):
            data = DMatrix(np.asarray(data, dtype=np.float32))
        cached = self._cache.get(id(data))
        if cached is not None:
            binned, base = cached.binned, cached.base
        else:
            if self.num_feature and data.num_col > self.num_feature:
                raise ValueError(
                    f"data has {data.num_col} features, model was trained "
                    f"with {self.num_feature}")
            binned = self._bins_for(data)
            base = self._base_margin_of(data, data.num_row)
        if pred_leaf:
            return self.gbtree.predict_leaf(binned, ntree_limit).cpu().numpy()
        if cached is not None and ntree_limit == 0:
            self._sync_margin(cached)
            margin = cached.margin
        else:
            margin = self.gbtree.predict_margin(binned, base, ntree_limit)
        out = self.obj.pred_transform(margin, output_margin=output_margin)
        out = out.cpu().numpy()
        # one column -> (N,); softprob and multiclass margins stay (N, K)
        return out[:, 0] if out.shape[1] == 1 else out

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
            tr = self.obj.eval_transform(entry.margin).cpu().numpy()
            preds = tr[:, 0] if tr.shape[1] == 1 else tr   # (N,) or (N, K)
            labels = np.asarray(dmat.get_label())
            weights = np.asarray(dmat.get_weight())
            for m in self._metrics(feval):
                val = m(preds, labels, weights, dmat.info.group_ptr)
                parts.append(f"{name}-{m.metric_name}:{val:.6f}")
            if feval is not None:
                mname, val = feval(preds, dmat)
                parts.append(f"{name}-{mname}:{val:.6f}")
        return "\t".join(parts)

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
        """Load from bytes: our npz, or its bs64 encoding."""
        if raw[:5] == b"bs64\t":
            try:
                raw = base64.b64decode(b"".join(raw[5:].split()),
                                       validate=True)
            except ValueError as e:
                raise ModelIntegrityError(
                    f"{name}: torn/invalid bs64 payload: {e}")
        if not raw.startswith(b"PK"):
            raise NotImplementedError(
                f"{name}: not an xgboost_tpu npz model (the reference's "
                "binary format is ROADMAP.md section 1 item 11)")
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
        self.gbtree = GBTree.from_state(self.param, state, self.device)
        self._cache.clear()

    def save_raw(self) -> bytes:
        return _npz_bytes(self._header(False), self.gbtree.get_state())


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
    members = [("header", np.frombuffer(json.dumps(header).encode(),
                                        dtype=np.uint8))]
    members += list(state.items())
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for key, val in members:
            info = zipfile.ZipInfo(key + ".npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(val),
                                          allow_pickle=False)
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
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval=True,
          xgb_model=None, device=None) -> Booster:
    """Train a booster (reference wrapper/xgboost.py:533-632) without
    early stopping.  ``xgb_model`` (a Booster or a model path) continues
    training: new rounds append to its ensemble."""
    if obj is not None:
        raise NotImplementedError(
            "custom objectives: ROADMAP.md section 1 item 6")
    if early_stopping_rounds is not None:
        raise NotImplementedError(
            "early stopping: ROADMAP.md section 1 item 6")
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
    if not evals:
        bst.update_many(dtrain, start_round, num_boost_round)
        return bst
    for i in range(num_boost_round):
        bst.update(dtrain, start_round + i)
        msg = bst.eval_set(evals, i, feval)
        if verbose_eval and (verbose_eval is True or int(verbose_eval) <= 1
                             or i % int(verbose_eval) == 0
                             or i == num_boost_round - 1):
            print(msg)
        if evals_result is not None:
            for part in msg.split("\t")[1:]:
                k, _, v = part.rpartition(":")
                evals_result.setdefault(k, []).append(float(v))
    return bst
