"""Typed training parameters (port of ``xgboost_tpu/config.py``).

The fields, their order and their defaults are those of the JAX
package's ``TrainParam``, so :meth:`TrainParam.to_dict` writes the same
model-file header and a file saved by either package loads in the other.
Many fields select paths this port does not have yet; the learner raises
``NotImplementedError`` for those (see ROADMAP.md).  The command line's
pieces live here too: :func:`parse_config_file` and the
``task=pipeline`` / ``task=lanes`` knob tables with the JAX package's
names, defaults and help.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

# accepted alias -> field name (reference param.h SetParam)
_ALIASES: Dict[str, str] = {
    "learning_rate": "eta",
    "min_split_loss": "gamma",
    "lambda": "reg_lambda",
    "alpha": "reg_alpha",
    "gbm": "booster",
}


def canonical_name(name: str) -> str:
    return _ALIASES.get(name, name)


def params_to_dict(params) -> Dict[str, Any]:
    """A params dict OR (name, value) pairs as a dict, repeated
    ``eval_metric`` entries collected into a list."""
    if isinstance(params, dict):
        return dict(params)
    out: Dict[str, Any] = {}
    ems: List[str] = []
    for k, v in (params or ()):
        if k == "eval_metric":
            ems.extend(v if isinstance(v, (list, tuple)) else [v])
        else:
            out[k] = v
    if ems:
        out["eval_metric"] = ems
    return out


@dataclasses.dataclass
class TrainParam:
    """All training hyperparameters (same fields as the JAX package)."""

    # tree booster
    eta: float = 0.3
    gamma: float = 0.0
    max_depth: int = 6
    min_child_weight: float = 1.0
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    max_delta_step: float = 0.0
    subsample: float = 1.0
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    default_direction: int = 0  # 0=learn, 1=left, 2=right
    sketch_eps: float = 0.03
    sketch_ratio: float = 2.0
    max_bin: int = 256
    device_sketch: int = -1
    # auto = the int8 CUDA kernel on a GPU, exact f32 on the CPU
    hist_precision: str = "auto"
    # -1 auto = align the bin count to 32 on a GPU, 0 on the CPU
    hist_bin_align: int = -1
    ema_fs: float = 0.0
    ema_fs_decay: float = 0.9
    ema_fs_min_features: int = 8
    linear_block: int = 1
    # gbtree
    num_parallel_tree: int = 1
    predict_tree_chunk: int = -1
    rounds_per_dispatch: int = -1
    num_roots: int = 1
    updater: str = "grow_histmaker,prune"
    max_exact_bin: int = 4096
    # learner
    booster: str = "gbtree"
    objective: str = "reg:linear"
    base_score: float = 0.5
    num_class: int = 0
    scale_pos_weight: float = 1.0
    eval_metric: Tuple[str, ...] = ()
    seed: int = 0
    seed_per_iteration: bool = False
    dsplit: str = "auto"
    dist_auc: str = "exact"
    dist_auc_max_runs: int = 1 << 22
    nthread: int = 0
    silent: int = 0
    profile: int = 0
    profile_dir: str = ""
    obs_log: str = ""
    metrics_port: int = -1
    # gblinear
    lambda_bias: float = 0.0
    # ranking
    num_pairsample: int = 1
    fix_list_weight: float = 0.0
    rank_impl: str = "device"

    # unknown params are kept and written back (the reference forwards
    # unrecognized names through its SetParam cascades)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def field_names(cls) -> List[str]:
        return [f.name for f in dataclasses.fields(cls) if f.name != "extras"]

    def set_param(self, name: str, value: Any) -> "TrainParam":
        """Set one parameter (string values are coerced), returning self."""
        name = canonical_name(name)
        if name == "eval_metric":
            # repeated eval_metric appends, like the reference EvalSet
            if isinstance(value, str):
                value = (*self.eval_metric, value)
            else:
                value = tuple(value)
            self.eval_metric = value
            return self
        if name == "default_direction" and isinstance(value, str):
            value = {"learn": 0, "left": 1, "right": 2}.get(value, value)
        if name in self.field_names():
            setattr(self, name, _coerce(value, getattr(self, name)))
        else:
            self.extras[name] = value
        return self

    @classmethod
    def from_dict(cls, params: Optional[Dict[str, Any]]) -> "TrainParam":
        """Build from a dict OR a sequence of (name, value) pairs."""
        p = cls()
        for k, v in params_to_dict(params).items():
            p.set_param(k, v)
        return p

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self.field_names()}
        d["eval_metric"] = list(self.eval_metric)
        d.update(self.extras)
        return d

    @property
    def num_output_group(self) -> int:
        return max(1, self.num_class)


def _coerce(value: Any, current: Any) -> Any:
    """Coerce a (possibly string) value to the current value's type."""
    target = type(current) if current is not None else str
    if isinstance(value, str):
        if target is bool:
            return value.lower() in ("1", "true", "yes")
        if target is int:
            return int(float(value))
        if target is float:
            return float(value)
        return value
    if target is bool:
        return bool(value)
    if target is int:
        return int(value)
    if target is float:
        return float(value)
    return value


# ------------------------------------------------------------- pipeline
# task=pipeline parameters (``xgboost_tpu/config.py:401``): name ->
# (default, help).  The CLI seeds its knobs and its usage text from
# this table; names, defaults and help are the JAX package's.
PIPELINE_PARAMS: Dict[str, Tuple[Any, str]] = {
    "pipeline_publish_path": ("", "model file the serving tier polls; "
                                  "each gated candidate is atomically "
                                  "published here (REQUIRED; also the "
                                  "warm-start incumbent)"),
    "pipeline_dir": ("./pipeline", "pipeline working directory: cycle "
                                   "state, candidate model, checkpoint "
                                   "ring, quarantine, gated-hash "
                                   "ledger"),
    "pipeline_rounds_per_cycle": (5, "boosting rounds appended to the "
                                     "incumbent per cycle"),
    "pipeline_cycles": (1, "cycles to run before exiting (0 = run "
                           "forever)"),
    "pipeline_data": ("", "fresh training data per cycle; a {cycle} "
                          "placeholder substitutes the cycle index "
                          "(falls back to data=)"),
    "pipeline_holdout": ("", "held-out eval window the gate scores "
                             "candidate vs incumbent on (REQUIRED "
                             "unless a custom DataSource provides "
                             "one)"),
    "pipeline_metric": ("", "gate metric name (empty = the "
                            "objective's default metric)"),
    "pipeline_min_delta": (0.0, "gate: minimum improvement over the "
                                "incumbent required to publish "
                                "(> 0 demands strict improvement)"),
    "pipeline_max_regression": (0.0, "gate: tolerated worsening vs the "
                                     "incumbent when pipeline_min_delta "
                                     "<= 0 (fresh-data drift allowance)"),
    "pipeline_router_url": ("", "fleet router base URL: publish through "
                                "the canary rollout lane (POST "
                                "/fleet/rollout) instead of a direct "
                                "atomic swap (empty = direct)"),
    "pipeline_publish_timeout_sec": (600.0, "rollout-lane publish "
                                            "timeout; must outlive the "
                                            "router's canary soak "
                                            "window"),
    "pipeline_sleep_sec": (0.0, "pause between cycles (and after an "
                                "idle cycle with no fresh data)"),
}


def pipeline_params_help() -> str:
    """One line per task=pipeline parameter, for CLI usage text."""
    return "\n".join(f"  {name:<26} {help_} (default {default!r})"
                     for name, (default, help_) in PIPELINE_PARAMS.items())


# ---------------------------------------------------------------- lanes
# task=lanes parameters (``xgboost_tpu/config.py:452``).  Per-lane gate
# knobs reuse the pipeline_* table (metric, min_delta, max_regression,
# router_url, publish_timeout_sec, sleep_sec apply to every lane).
LANE_PARAMS: Dict[str, Tuple[Any, str]] = {
    "lanes": ("", "tenant lane manifest: inline 'name=publish_path' "
                  "pairs (comma-separated) or a 'name = publish_path' "
                  "config file — one continuous-training pipeline per "
                  "tenant (REQUIRED for task=lanes)"),
    "lanes_dir": ("./lanes", "root working directory; each lane keeps "
                             "its own cycle state, checkpoint ring, "
                             "quarantine and gated-hash ledger under "
                             "<lanes_dir>/<name>"),
    "lane_stack": (-1, "gang-batched execution: 1 = vmap-stack "
                       "same-shape lanes into one device dispatch per "
                       "round segment, 0 = independent host-loop "
                       "pipelines (the A/B baseline), -1 = auto "
                       "(XGBTPU_LANE_STACK env, default stacked)"),
    "lane_window_ms": (200.0, "rendezvous window: a cycle's boosting "
                              "dispatches when every active lane has "
                              "arrived or this many ms passed since "
                              "the first arrival; late lanes join the "
                              "next batch (model bytes never depend "
                              "on batch composition — only dispatch "
                              "sharing does)"),
    "lane_max_workers": (0, "concurrent lane threads (0 = auto: all "
                            "lanes when stacked — threads idle at the "
                            "rendezvous while the device works — else "
                            "min(lanes, 8) for the host loop)"),
    "lane_data": ("", "per-lane training data: {lane} and {cycle} "
                      "placeholders substitute the lane name and "
                      "cycle index (falls back to data=)"),
    "lane_holdout": ("", "per-lane gate holdout; a {lane} placeholder "
                         "substitutes the lane name"),
    "lane_rounds_per_cycle": (5, "boosting rounds appended per cycle "
                                 "in every lane (equal-shape lanes "
                                 "share one compiled stacked scan)"),
    "lane_cycles": (1, "cycles each lane runs before exiting (0 = run "
                       "forever)"),
}


def lane_params_help() -> str:
    """One line per task=lanes parameter, for CLI usage text."""
    return "\n".join(f"  {name:<26} {help_} (default {default!r})"
                     for name, (default, help_) in LANE_PARAMS.items())


# ------------------------------------------------------------- serving
# task=serve parameters (``xgboost_tpu/config.py:270-300``), the one table
# both surfaces read: ``python -m xgboost_tpu_torch task=serve serve_port=...``
# and ``python -m xgboost_tpu_torch.serving --port ...``.  Values are
# (default, help); the default's type drives coercion.  The three fleet
# rows (serve_router_url, serve_replica_id, serve_advertise_url) are kept
# so both CLIs take the same names; a non-empty value raises until the
# fleet is ported (ROADMAP.md section 1 item 14b).
SERVE_PARAMS: Dict[str, Tuple[Any, str]] = {
    "serve_host": ("127.0.0.1", "bind address for the HTTP server"),
    "serve_port": (8080, "HTTP port (0 = ephemeral, printed at startup)"),
    "serve_min_bucket": (8, "smallest power-of-two row bucket"),
    "serve_max_bucket": (8192, "largest row bucket; bigger requests are "
                               "chunked through it"),
    "serve_max_batch_rows": (1024, "max rows coalesced into one device "
                                   "call by the micro-batcher"),
    "serve_max_wait_ms": (2.0, "micro-batch window: how long the first "
                               "request waits for company"),
    "serve_queue_rows": (8192, "bounded queue size in rows; overflow "
                               "rejects with HTTP 503"),
    "serve_poll_sec": (1.0, "model-file hot-reload poll interval "
                            "(0 disables watching)"),
    "serve_keep_versions": (2, "previous model versions kept warm for "
                               "instant rollback"),
    "serve_warmup": (1, "pre-compile every row bucket at startup "
                        "(recompile-free steady state)"),
    "serve_drain_sec": (30.0, "SIGTERM drain grace: max seconds to wait "
                              "for in-flight requests before exit"),
    "serve_max_body_mb": (64.0, "largest accepted request body; bigger "
                                "Content-Length is rejected with 413 "
                                "before buffering"),
    "serve_featurestore_mb": (0.0, "device byte budget for the "
                                   "hot-entity feature store backing "
                                   "POST /predict_by_id (0 disables; "
                                   "LRU-evicts past the budget)"),
    "serve_router_url": ("", "not ported (ROADMAP.md item 14b): the "
                             "fleet router base URL"),
    "serve_replica_id": ("", "not ported (ROADMAP.md item 14b): the "
                             "replica's fleet identity"),
    "serve_advertise_url": ("", "not ported (ROADMAP.md item 14b): the "
                                "URL the router dials"),
}


def serve_params_help() -> str:
    """One line per task=serve parameter, for CLI usage text."""
    return "\n".join(f"  {name:<22} {help_} (default {default!r})"
                     for name, (default, help_) in SERVE_PARAMS.items())


# The catalog parameters task=serve passes (``config.py:579-596``); the
# router's tenant quotas stay with the fleet (ROADMAP.md item 14b).
CATALOG_PARAMS: Dict[str, Tuple[Any, str]] = {
    "catalog": ("", "model catalog manifest: inline "
                    "'name=path,name=path' pairs, or a path to a "
                    "'name = path' config file (one model per line). "
                    "Empty = single-model serving (a catalog of one)"),
    "catalog_default": ("", "model served by bare /predict (no "
                            "?model=); default: the model= file when "
                            "given, else the manifest's first entry"),
    "serve_catalog_mb": (0.0, "shared device byte budget across ALL "
                              "resident catalog models (engines + "
                              "per-model feature stores); past it the "
                              "coldest non-default models are evicted "
                              "(0 = unlimited, everything stays "
                              "resident)"),
    "catalog_hysteresis_sec": (3.0, "minimum residency before a model "
                                    "becomes evictable — bounds "
                                    "admit/evict thrash when the "
                                    "working set exceeds the budget"),
}


def catalog_params_help() -> str:
    """One line per catalog parameter, for CLI usage text."""
    return "\n".join(f"  {name:<22} {help_} (default {default!r})"
                     for name, (default, help_) in CATALOG_PARAMS.items())


def parse_config_file(path: str) -> List[Tuple[str, str]]:
    """Parse a ``name = value`` config file (``xgboost_tpu/config.py:681``):
    one pair per line, ``#`` comments, quoted values.  Returns pairs in
    file order (later pairs override earlier ones on apply)."""
    pairs: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            name, value = line.split("=", 1)
            name = name.strip()
            value = value.strip().strip('"').strip("'")
            if name:
                pairs.append((name, value))
    return pairs
