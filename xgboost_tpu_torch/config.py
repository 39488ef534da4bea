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
# (default, help); the default's type drives coercion.
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
    "serve_router_url": ("", "fleet router base URL (e.g. "
                             "http://127.0.0.1:8000); the replica "
                             "registers there and renews a heartbeat "
                             "lease (empty = standalone, no fleet)"),
    "serve_replica_id": ("", "stable replica identity used with the "
                            "fleet router (default host:port; a "
                            "restarted replica re-registering under "
                            "its old id is the recover path)"),
    "serve_advertise_url": ("", "endpoint the router should dial for "
                                "this replica (default the bind "
                                "address; REQUIRED for cross-host "
                                "fleets binding 0.0.0.0)"),
}


def serve_params_help() -> str:
    """One line per task=serve parameter, for CLI usage text."""
    return "\n".join(f"  {name:<22} {help_} (default {default!r})"
                     for name, (default, help_) in SERVE_PARAMS.items())


# --------------------------------------------------------------- fleet
# task=fleet_router parameters (``xgboost_tpu/config.py:327-392``), the
# same single-table discipline as SERVE_PARAMS: the CLI derives its
# surface from this dict, so usage text stays complete as knobs are added.
FLEET_PARAMS: Dict[str, Tuple[Any, str]] = {
    "fleet_host": ("127.0.0.1", "bind address for the router"),
    "fleet_port": (8000, "router HTTP port (0 = ephemeral, printed at "
                         "startup)"),
    "fleet_lease_sec": (10.0, "replica heartbeat lease: a replica that "
                              "stops renewing leaves rotation within "
                              "this window"),
    "fleet_hc_sec": (2.0, "health-check interval: the router probes "
                          "each replica's /healthz (draining/degraded "
                          "replicas leave rotation; 0 disables)"),
    "fleet_inflight": (256, "global in-flight request budget; requests "
                            "past it are shed with HTTP 503"),
    "fleet_breaker_failures": (3, "consecutive dispatch failures that "
                                  "trip a replica's circuit breaker "
                                  "open"),
    "fleet_breaker_cooldown_sec": (5.0, "seconds an open breaker waits "
                                        "before allowing one half-open "
                                        "probe request"),
    "fleet_retry": (1, "retry a failed /predict once on a different "
                       "healthy replica (predictions are idempotent; "
                       "the retry spends the request's REMAINING "
                       "deadline budget after a jittered backoff)"),
    "fleet_timeout_sec": (30.0, "per-hop forward timeout to a replica "
                                "(shrunk to the remaining deadline "
                                "budget when the request carries one)"),
    "fleet_deadline_ms": (0.0, "default end-to-end deadline stamped "
                               "(X-Deadline-Ms) on requests that carry "
                               "none; expired requests are rejected 504 "
                               "before any dispatch (0 = off)"),
    "fleet_slow_eject_factor": (3.0, "eject a replica from least-"
                                     "loaded dispatch when its latency "
                                     "EWMA exceeds this multiple of "
                                     "its peers' median (0 disables; "
                                     "entity-id owners are exempt — "
                                     "sticky routes have no failover)"),
    "fleet_slow_eject_cooldown_sec": (5.0, "seconds an ejected replica "
                                           "waits before one probe "
                                           "request decides "
                                           "readmission"),
    "fleet_max_body_mb": (64.0, "largest accepted request body (413 "
                                "past it, before buffering)"),
    "fleet_canaries": (1, "default canary replica count for POST "
                          "/fleet/rollout"),
    "fleet_soak_sec": (3.0, "default canary soak window before the "
                            "rollout gate reads canary /metrics"),
    "fleet_gate_error_rate": (0.02, "rollout gate: max canary error "
                                    "rate (errors/requests) during the "
                                    "soak"),
    "fleet_gate_p99_ms": (250.0, "rollout gate: max canary p99 request "
                                 "latency in milliseconds"),
    "fleet_state_path": ("", "membership snapshot file (CRC-footered, "
                             "atomically rewritten on membership "
                             "changes and each health pass): a "
                             "restarted router restores its replica "
                             "set from here instead of waiting for "
                             "heartbeats (empty = stateless restart)"),
}


def fleet_params_help() -> str:
    """One line per task=fleet_router parameter, for CLI usage text."""
    return "\n".join(f"  {name:<26} {help_} (default {default!r})"
                     for name, (default, help_) in FLEET_PARAMS.items())


# The catalog parameters (``config.py:570-606``): the replica-side catalog
# of task=serve and the per-tenant quotas of task=fleet_router.
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
    "tenant_inflight": (0, "router: per-tenant in-flight request "
                           "budget; a tenant past it sheds 503 without "
                           "touching its neighbors (0 = no per-tenant "
                           "cap)"),
    "tenant_rate": (0.0, "router: per-tenant sustained request rate "
                         "limit in req/s (token bucket; over-rate "
                         "requests shed 429; 0 = unlimited)"),
    "tenant_burst": (8.0, "router: token-bucket burst size — requests "
                          "a tenant may send back-to-back before "
                          "tenant_rate applies"),
}


def catalog_params_help() -> str:
    """One line per catalog parameter, for CLI usage text."""
    return "\n".join(f"  {name:<22} {help_} (default {default!r})"
                     for name, (default, help_) in CATALOG_PARAMS.items())


# --------------------------------------------------------------- placer
# Autonomous placement + elastic fleet (``xgboost_tpu/config.py:616-678``,
# SERVING.md "Autonomous placement"): knobs for task=placer, the control
# plane that decides which replicas host which catalog models and how
# many replicas the fleet should run.  Same single-table discipline as
# the other *_PARAMS tables.
PLACER_PARAMS: Dict[str, Tuple[Any, str]] = {
    "placer_router_url": ("", "base URL of the fleet router whose "
                              "catalog the placer manages (required "
                              "for task=placer)"),
    "placer_catalog": ("", "tenant manifest the placer places: inline "
                           "'name=path,name=path' pairs or a 'name = "
                           "path' config file — same syntax as "
                           "catalog="),
    "placer_plan_path": ("", "CRC-footered snapshot of the target "
                             "assignment; a restarted placer resumes "
                             "this plan instead of replanning from "
                             "scratch (empty = no snapshot)"),
    "placer_id": ("", "placer identity for the router-side single-"
                      "holder lease (default: host:pid)"),
    "placer_tick_sec": (2.0, "control-loop period: scrape load, "
                             "replan, push manifest deltas (jittered "
                             "±20%)"),
    "placer_lease_sec": (10.0, "router-side placer lease: a standby "
                               "placer takes over this long after the "
                               "holder's last renewal"),
    "placer_replication": (1, "replication floor — every tenant is "
                              "placed on at least this many in-"
                              "rotation replicas (capped by fleet "
                              "size)"),
    "placer_hot_replication": (2, "replication floor for HOT tenants "
                                  "(load share >= placer_hot_fraction)"),
    "placer_hot_fraction": (0.5, "a tenant whose share of observed "
                                 "request load meets this fraction is "
                                 "hot and gets the raised floor"),
    "placer_load_alpha": (0.3, "EWMA smoothing for per-tenant request "
                               "rates scraped from the router's "
                               "xgbtpu_tenant_* counters"),
    "placer_util_low": (0.2, "elastic band floor: fleet in-flight/"
                             "slot utilization (EWMA) below this "
                             "drains one replica"),
    "placer_util_high": (0.75, "elastic band ceiling: utilization "
                               "above this spawns one replica"),
    "placer_util_alpha": (0.3, "EWMA smoothing for the fleet "
                               "utilization signal"),
    "placer_replica_slots": (8, "nominal concurrent requests one "
                                "replica absorbs; utilization = "
                                "in-flight / (slots * replicas)"),
    "placer_cooldown_sec": (10.0, "minimum gap between elastic "
                                  "resizes, so one burst cannot "
                                  "thrash the fleet size"),
    "placer_min_replicas": (1, "elastic supervisor never drains the "
                               "fleet below this many replicas"),
    "placer_max_replicas": (8, "elastic supervisor never spawns the "
                               "fleet above this many replicas"),
}


def placer_params_help() -> str:
    """One line per task=placer parameter, for CLI usage text."""
    return "\n".join(f"  {name:<26} {help_} (default {default!r})"
                     for name, (default, help_) in PLACER_PARAMS.items())


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
