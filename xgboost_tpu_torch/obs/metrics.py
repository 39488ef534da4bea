"""Prometheus-style metric primitives and the metric groups of training,
the pipeline, tenant lanes, prediction, the feature store, the catalog,
the fleet router, tenant quotas, the placer and serving (port of
``xgboost_tpu/obs/metrics.py:45-672,672-815,896-1289``, with the same
metric names).

One process-wide :class:`MetricsRegistry` holds every group's render
function, so ``registry().render()`` is the whole process's exposition
text, and a :class:`ServingMetrics` render appends every other group.
The stream group is not ported (ROADMAP.md section 1 item 15).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# latency buckets in seconds: 0.5ms .. 5s, roughly x2 per step
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
# batch-size buckets in rows: powers of two
_ROWS_BUCKETS = tuple(float(1 << i) for i in range(15))
# per-round wall-time buckets in seconds: 1ms .. 60s
_ROUND_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


def _fmt(v: float) -> str:
    return f"{int(v)}" if float(v).is_integer() else repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    def __init__(self, name: str, help_text: str = ""):
        self.name, self.help = name, help_text
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v

    def render(self) -> str:
        return (f"# HELP {self.name} {self.help}\n"
                f"# TYPE {self.name} counter\n"
                f"{self.name} {_fmt(self._v)}\n")


class Gauge(Counter):
    """Settable value (Prometheus ``gauge``)."""

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def render(self) -> str:
        return super().render().replace(" counter\n", " gauge\n", 1)


class LabeledCounter:
    """A counter family with one label dimension, e.g.
    ``xgbtpu_lane_solo_total{reason="ensemble"}``."""

    def __init__(self, name: str, label: str, help_text: str = ""):
        self.name, self.label, self.help = name, label, help_text
        self._v: Dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, label_value: str, v: float = 1.0) -> None:
        with self._lock:
            self._v[label_value] = self._v.get(label_value, 0.0) + v

    def value(self, label_value: str) -> float:
        return self._v.get(label_value, 0.0)

    def values(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._v)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for lv, v in sorted(self.values().items()):
            lines.append(f'{self.name}{{{self.label}="{_escape_label(lv)}"}}'
                         f' {_fmt(v)}')
        return "\n".join(lines) + "\n"


class LabeledGauge:
    """A gauge family with one label dimension (``obs/metrics.py:127``)."""

    def __init__(self, name: str, label: str, help_text: str = ""):
        self.name, self.label, self.help = name, label, help_text
        self._v: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, label_value: str, v: float) -> None:
        with self._lock:
            self._v[label_value] = float(v)

    def value(self, label_value: str) -> float:
        return self._v.get(label_value, 0.0)

    def values(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._v)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for lv, v in sorted(self.values().items()):
            lines.append(f'{self.name}{{{self.label}="{_escape_label(lv)}"}}'
                         f' {_fmt(v)}')
        return "\n".join(lines) + "\n"


class Histogram:
    """Fixed-bucket histogram (Prometheus ``histogram``) with quantiles
    interpolated within the winning bucket (``obs/metrics.py:158``)."""

    def __init__(self, name: str, help_text: str = "",
                 buckets: Sequence[float] = _ROUND_BUCKETS):
        self.name, self.help = name, help_text
        self.bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        i = bisect.bisect_left(self.bounds, x)
        with self._lock:
            self._counts[i] += 1
            self._sum += x
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Approximate q-quantile from the bucket counts: 0.0 without
        observations; ``q <= 0`` the lower edge of the first non-empty
        bucket; ``q >= 1`` the upper edge of the last non-empty finite
        bucket."""
        with self._lock:
            n = self._n
            counts = list(self._counts)
        if n == 0:
            return 0.0
        if q <= 0.0:
            for i, c in enumerate(counts):
                if c > 0:
                    return self.bounds[i - 1] if i > 0 else 0.0
            return 0.0
        target = min(q, 1.0) * n
        cum = 0.0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else lo
                if hi <= lo:
                    return hi
                return lo + (hi - lo) * (target - prev) / c
        return self.bounds[-1]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            counts, total, s = list(self._counts), self._n, self._sum
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{self.name}_sum {_fmt(s)}")
        lines.append(f"{self.name}_count {total}")
        return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Process-wide registry of named metric groups; :meth:`render`
    concatenates them."""

    def __init__(self):
        self._groups: Dict[str, Callable[[], str]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, render_fn: Callable[[], str]) -> None:
        with self._lock:
            self._groups[name] = render_fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._groups)

    def render(self, exclude: Sequence[str] = ()) -> str:
        with self._lock:
            fns = [fn for n, fn in self._groups.items() if n not in exclude]
        return "".join(fn() for fn in fns)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


class _Group:
    """A metric group: its metrics in ``_all``, registered under a name."""

    _all: tuple = ()

    def render(self) -> str:
        return "".join(m.render() for m in self._all)


class TrainingMetrics(_Group):
    """``xgbtpu_training_*``: what the round profiler (obs/profiler.py)
    and the checkpoint ring write (``obs/metrics.py:443-470``)."""

    def __init__(self, prefix: str = "xgbtpu_training"):
        p = prefix
        self.rounds = Counter(
            f"{p}_rounds_total", "boosting rounds completed")
        self.round = Gauge(
            f"{p}_round", "most recently completed boosting round index")
        self.round_seconds = Histogram(
            f"{p}_round_seconds", "wall time per boosting round",
            _ROUND_BUCKETS)
        self.phase_seconds = LabeledCounter(
            f"{p}_phase_seconds_total", "phase",
            "cumulative wall seconds per round phase "
            "(predict/gradient/grow/eval)")
        self.checkpoints = Counter(
            f"{p}_checkpoints_total", "model checkpoints written")
        self.checkpoint_seconds = Counter(
            f"{p}_checkpoint_seconds_total",
            "cumulative wall seconds spent writing checkpoints "
            "(the reference report_stats' checkpoint cost)")
        self._all = (self.rounds, self.round, self.round_seconds,
                     self.phase_seconds, self.checkpoints,
                     self.checkpoint_seconds)
        registry().register("training", self.render)


class ReliabilityMetrics(_Group):
    """``xgbtpu_reliability_*`` and ``xgbtpu_deadline_*``: how often the
    crash-safety machinery engaged (``obs/metrics.py:342-428``): the
    checkpoint ring and model I/O, the serving stack's shed, dropped and
    rejected requests, poisoned reloads, drains and injected faults."""

    def __init__(self, prefix: str = "xgbtpu_reliability"):
        p = prefix
        self.integrity_failures = Counter(
            f"{p}_integrity_failures_total",
            "persisted files that failed CRC/footer verification")
        self.ring_fallbacks = Counter(
            f"{p}_ckpt_ring_fallbacks_total",
            "checkpoint loads that fell back past a corrupt ring member")
        self.quarantines = Counter(
            f"{p}_quarantined_files_total",
            "corrupt files moved aside as *.corrupt")
        self.poisoned_reloads = Counter(
            f"{p}_poisoned_reload_skips_total",
            "reload polls skipped because the file content is known-bad")
        self.shed_requests = Counter(
            f"{p}_shed_requests_total",
            "abandoned (caller timed out) requests shed before dispatch")
        self.faults_injected = Counter(
            f"{p}_faults_injected_total",
            "chaos faults fired by the injection registry")
        self.drain_seconds = Gauge(
            f"{p}_drain_seconds",
            "duration of the last HTTP drain (SIGTERM to stopped)")
        self.deadline_rejected = Counter(
            "xgbtpu_deadline_rejected_total",
            "requests rejected before device work because the deadline "
            "budget was spent or cannot cover observed service time")
        self.deadline_dropped = Counter(
            "xgbtpu_deadline_dropped_total",
            "expired requests dropped by the micro-batcher pre-dispatch")
        self.swallowed = LabeledCounter(
            "xgbtpu_swallowed_errors_total", "site",
            "exceptions deliberately swallowed, by site")
        self._all = (self.integrity_failures, self.ring_fallbacks,
                     self.quarantines, self.poisoned_reloads,
                     self.shed_requests, self.faults_injected,
                     self.drain_seconds, self.deadline_rejected,
                     self.deadline_dropped, self.swallowed)
        registry().register("reliability", self.render)


class PredictMetrics(_Group):
    """``xgbtpu_predict_*`` (``obs/metrics.py:552-606``): rows through
    the tree traversal, its seconds per tree chunk, and the host-to-device
    feature uploads of the prediction paths."""

    def __init__(self, prefix: str = "xgbtpu_predict"):
        p = prefix
        self.rows = Counter(
            f"{p}_rows_total",
            "rows predicted through the gbtree traversal "
            "(Learner.predict + serving engine)")
        self.chunk_seconds = Histogram(
            f"{p}_chunk_seconds",
            "device traversal wall seconds per tree chunk "
            "(margin launch time / chunk count)", _LATENCY_BUCKETS)
        self.transfer_seconds = Histogram(
            f"{p}_transfer_seconds",
            "host→device feature upload wall seconds per transfer "
            "(prediction paths: learner blocks, engine batches, "
            "feature-store puts)", _LATENCY_BUCKETS)
        self.transfer_bytes = Counter(
            f"{p}_transfer_bytes_total",
            "host→device feature bytes uploaded on prediction paths "
            "(flat while the feature store serves resident entities)")
        self._all = (self.rows, self.chunk_seconds,
                     self.transfer_seconds, self.transfer_bytes)
        registry().register("predict", self.render)

    def observe_transfer(self, nbytes: int, seconds: float) -> None:
        """Account one host-to-device feature upload."""
        self.transfer_bytes.inc(nbytes)
        self.transfer_seconds.observe(seconds)


def timed_device_put(arr, out, observe=None):
    """The prediction upload (``obs/metrics.py:608``): host array ``arr``
    copied into the device tensor ``out`` of its shape, synchronised so
    the copy is timed whole, and ``observe(nbytes, seconds)`` called
    when given (``predict_metrics().observe_transfer``; None for warmup
    traffic).  Returns ``out``."""
    import torch
    t0 = time.perf_counter()
    out.copy_(torch.from_numpy(arr))
    if out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()
    if observe is not None:
        observe(getattr(arr, "nbytes", 0), time.perf_counter() - t0)
    return out


class FeatureStoreMetrics(_Group):
    """``xgbtpu_featurestore_*`` (``obs/metrics.py:628``): hits, misses,
    evictions and resident bytes of the device feature store."""

    def __init__(self, prefix: str = "xgbtpu_featurestore"):
        p = prefix
        self.hits = Counter(
            f"{p}_hits_total",
            "entity rows served from the device-resident store")
        self.misses = Counter(
            f"{p}_misses_total",
            "entity lookups that were not resident")
        self.evictions = Counter(
            f"{p}_evictions_total",
            "entity rows evicted by LRU byte-budget pressure")
        self.resident_bytes = Gauge(
            f"{p}_resident_bytes",
            "feature bytes currently resident on device")
        self._all = (self.hits, self.misses, self.evictions,
                     self.resident_bytes)
        registry().register("featurestore", self.render)


class PipelineMetrics(_Group):
    """``xgbtpu_pipeline_*``: the train -> gate -> publish cycle loop."""

    def __init__(self, prefix: str = "xgbtpu_pipeline"):
        p = prefix
        self.cycles = Counter(
            f"{p}_cycles_total", "train→gate→publish cycles completed "
            "(any outcome: published, gate-failed, or idle)")
        self.cycle_seconds = Histogram(
            f"{p}_cycle_seconds", "wall time per pipeline cycle")
        self.gate_pass = Counter(
            f"{p}_gate_pass_total", "candidates that passed the eval gate")
        self.gate_fail = Counter(
            f"{p}_gate_fail_total",
            "candidates rejected by the eval gate (incl. corrupt "
            "candidates failing CRC verification)")
        self.publishes = Counter(
            f"{p}_publishes_total",
            "gated models published to the serving path")
        self.publish_failures = Counter(
            f"{p}_publish_failures_total",
            "publish attempts that failed (I/O error)")
        self.publish_seconds = Counter(
            f"{p}_publish_seconds_total",
            "cumulative wall seconds spent publishing gated models")
        self.trees_published = Counter(
            f"{p}_trees_published_total",
            "trees appended to the incumbent and published")
        self.quarantines = Counter(
            f"{p}_quarantines_total",
            "candidates quarantined (failed gate or failed verification)")
        self.resumes = Counter(
            f"{p}_resumes_total",
            "cycles resumed after a crash (checkpoint-ring mid-train "
            "resume or a re-gate of an already-trained candidate)")
        self.incumbent_age = Gauge(
            f"{p}_incumbent_age_seconds",
            "seconds since this pipeline last published (0 until the "
            "first publish)")
        self._published_at: Optional[float] = None
        self._all = (self.cycles, self.cycle_seconds, self.gate_pass,
                     self.gate_fail, self.publishes,
                     self.publish_failures, self.publish_seconds,
                     self.trees_published, self.quarantines,
                     self.resumes, self.incumbent_age)
        registry().register("pipeline", self.render)

    def note_publish(self) -> None:
        """Stamp the incumbent-age clock (monotonic: the gauge is a
        duration)."""
        self._published_at = time.perf_counter()

    def render(self) -> str:
        if self._published_at is not None:
            self.incumbent_age.set(time.perf_counter()
                                   - self._published_at)
        return super().render()


class LaneMetrics(_Group):
    """``xgbtpu_lane_*``: how many tenants each stacked dispatch
    carried, how much of the stack was padding, how often a lane ran
    solo and why, and the shape buckets."""

    def __init__(self, prefix: str = "xgbtpu_lane"):
        p = prefix
        self.dispatches = Counter(
            f"{p}_dispatches_total",
            "stacked multi-tenant segment dispatches (one per segment, "
            "regardless of how many lanes it carried)")
        self.stacked = Counter(
            f"{p}_stacked_total",
            "real tenant lane-segments advanced by stacked dispatches")
        self.padded = Counter(
            f"{p}_padded_total",
            "inactive pad lane-segments dispatched to round a bucket up "
            "to its power-of-two stack width")
        self.solo = LabeledCounter(
            f"{p}_solo_total", "reason",
            "lane cycles that ran the solo host-loop path instead of "
            "stacking, by first blocking reason")
        self.stack_width = Gauge(
            f"{p}_stack_width",
            "lane count (incl. padding) of the most recent stacked "
            "dispatch")
        self.buckets = Gauge(
            f"{p}_buckets",
            "distinct shape buckets in the most recent gang window")
        self.dispatch_seconds = Histogram(
            f"{p}_dispatch_seconds",
            "wall time per stacked segment dispatch (all lanes in the "
            "bucket advance together)")
        self.restacks = Counter(
            f"{p}_restack_total",
            "bucket re-stacks: dispatches that rebuilt the stacked "
            "device columns instead of reusing the steady-bucket carry "
            "(lane churn, fresh data, or a first arrival)")
        self._all = (self.dispatches, self.stacked, self.padded,
                     self.solo, self.stack_width, self.buckets,
                     self.dispatch_seconds, self.restacks)
        registry().register("lanes", self.render)


class CatalogMetrics(_Group):
    """``xgbtpu_catalog_*`` (``obs/metrics.py:1011``): configured and
    resident models, the shared device budget, admissions, evictions and
    resolves by model."""

    def __init__(self, prefix: str = "xgbtpu_catalog"):
        p = prefix
        self.models_configured = Gauge(
            f"{p}_models_configured",
            "models named in this replica's catalog manifest")
        self.models_resident = Gauge(
            f"{p}_models_resident",
            "models with a live engine on device right now")
        self.bytes_used = Gauge(
            f"{p}_bytes_used",
            "estimated device bytes held by resident model engines")
        self.bytes_budget = Gauge(
            f"{p}_bytes_budget",
            "serve_catalog_mb budget in bytes (0 = unlimited)")
        self.admissions = Counter(
            f"{p}_admissions_total",
            "evicted models re-built and re-warmed on demand")
        self.evictions = Counter(
            f"{p}_evictions_total",
            "cold models' engines LRU-evicted to fit the budget")
        self.requests = LabeledCounter(
            f"{p}_requests_total", "model",
            "catalog resolves served, by model name")
        self.unknown_model = Counter(
            f"{p}_unknown_model_total",
            "requests naming a model the catalog does not hold (404)")
        self._all = (self.models_configured, self.models_resident,
                     self.bytes_used, self.bytes_budget, self.admissions,
                     self.evictions, self.requests, self.unknown_model)
        registry().register("catalog", self.render)


class FleetMetrics(_Group):
    """Router-side fleet accounting (``xgbtpu_fleet_*``, SERVING.md
    fleet section): per-replica request/error attribution, the global
    admission budget's shed count, retry and breaker activity, and the
    membership gauge pair (registered vs in-rotation — their gap is the
    fleet's sick-replica count).  One instance per process
    (:func:`fleet_metrics`); rendered into every /metrics body via the
    registry."""

    def __init__(self, prefix: str = "xgbtpu_fleet"):
        p = prefix
        self.requests = LabeledCounter(
            f"{p}_requests_total", "replica",
            "requests dispatched by the router, by replica")
        self.errors = LabeledCounter(
            f"{p}_errors_total", "replica",
            "dispatches that failed (connect/5xx), by replica")
        self.latency = Histogram(
            f"{p}_latency_seconds",
            "router-side request latency, dispatch to response "
            "(includes the replica hop and any retry)")
        self.shed = Counter(
            f"{p}_shed_total",
            "requests shed with 503 by the router's in-flight budget")
        self.retries = Counter(
            f"{p}_retries_total",
            "requests retried on a second replica after a failure")
        self.breaker_trips = Counter(
            f"{p}_breaker_trips_total",
            "circuit breakers tripped open (consecutive failures)")
        self.breaker_open = LabeledGauge(
            f"{p}_breaker_open", "replica",
            "1 while a replica's circuit breaker is open/half-open")
        self.members = Gauge(
            f"{p}_members",
            "replicas currently in rotation (lease live + healthy + "
            "serving)")
        self.members_registered = Gauge(
            f"{p}_members_registered",
            "replicas currently registered (any state)")
        self.inflight = Gauge(
            f"{p}_inflight", "requests in flight through the router")
        self.rollouts = Counter(
            f"{p}_rollouts_total", "canary rollouts completed fleet-wide")
        self.rollbacks = Counter(
            f"{p}_rollbacks_total",
            "rollouts rolled back (gate failure or operator command)")
        # latency-aware ejection (fleet/membership.py): a slow-but-alive
        # replica sails under the failure-count breaker while wrecking
        # fleet p99 — these make the ejection state machine scrapeable
        self.slow_ejections = Counter(
            f"{p}_slow_ejections_total",
            "replicas ejected from least-loaded dispatch for latency "
            "(EWMA above k x the peers' median)")
        self.ejected = LabeledGauge(
            f"{p}_ejected", "replica",
            "1 while a replica is latency-ejected (awaiting its "
            "readmission probe)")
        self.replica_latency = LabeledGauge(
            f"{p}_replica_latency_ewma_seconds", "replica",
            "per-replica EWMA of router-observed dispatch latency")
        # heartbeat payload drift fix: every advertisement change the
        # membership table absorbs mid-lease (catalog delta, eviction)
        # is counted, so "how stale could the routing map have been"
        # is answerable from a scrape
        self.advert_updates = Counter(
            f"{p}_advert_updates_total",
            "heartbeats whose model/device advertisement differed "
            "from the membership table (map updated in place)")
        self._all = (self.requests, self.errors, self.latency, self.shed,
                     self.retries, self.breaker_trips, self.breaker_open,
                     self.members, self.members_registered, self.inflight,
                     self.rollouts, self.rollbacks, self.slow_ejections,
                     self.ejected, self.replica_latency,
                     self.advert_updates)
        registry().register("fleet", self.render)


class TenantMetrics(_Group):
    """Router-side per-tenant accounting (``xgbtpu_tenant_*``,
    SERVING.md catalog section): request/shed/latency per model name at
    the front door, so one tenant's overload is attributable — and
    provably isolated — at a glance.  Latency is a labeled
    milliseconds-sum counter; pair with ``requests_total`` for the
    per-tenant mean (per-tenant quantiles live in the bench/chaos
    reports, which sample client-side).  One instance per process
    (:func:`tenant_metrics`)."""

    def __init__(self, prefix: str = "xgbtpu_tenant"):
        p = prefix
        self.requests = LabeledCounter(
            f"{p}_requests_total", "model",
            "requests entering the router, by model name")
        self.shed = LabeledCounter(
            f"{p}_shed_total", "model",
            "requests shed by that tenant's quota (429 rate / "
            "503 in-flight)")
        self.latency_ms = LabeledCounter(
            f"{p}_latency_ms_total", "model",
            "cumulative router-side request milliseconds, by model")
        self.inflight = LabeledGauge(
            f"{p}_inflight", "model",
            "requests currently in flight through the router, by model")
        self._all = (self.requests, self.shed, self.latency_ms,
                     self.inflight)
        registry().register("tenant", self.render)


class PlacerMetrics(_Group):
    """Control-plane accounting for the autonomous placer
    (``xgbtpu_placer_*``, SERVING.md "Autonomous placement"): plan
    churn, manifest-delta pushes, convergence state, and the elastic
    supervisor's band/resize activity.  One instance per process
    (:func:`placer_metrics`); rendered into every /metrics body via
    the registry."""

    def __init__(self, prefix: str = "xgbtpu_placer"):
        p = prefix
        self.ticks = Counter(
            f"{p}_ticks_total",
            "placement control-loop iterations (lease held)")
        self.standby_ticks = Counter(
            f"{p}_standby_ticks_total",
            "iterations skipped because another placer holds the lease")
        self.plans = Counter(
            f"{p}_plans_total",
            "target assignments computed that differ from the last")
        self.moves = LabeledCounter(
            f"{p}_moves_total", "kind",
            "tenant placement deltas decided, kind=attach|detach")
        self.pushes = Counter(
            f"{p}_pushes_total",
            "manifest-delta pushes sent to replica admin surfaces")
        self.push_errors = Counter(
            f"{p}_push_errors_total",
            "manifest-delta pushes that failed (replica unreachable "
            "or rejected)")
        self.tenants = Gauge(
            f"{p}_tenants",
            "tenant models under placer management")
        self.tenants_placed = Gauge(
            f"{p}_tenants_placed",
            "managed tenants with >=1 in-rotation host advertising "
            "them")
        self.converged = Gauge(
            f"{p}_converged",
            "1 while the fleet's advertised hosting matches the "
            "target assignment")
        self.fleet_util = Gauge(
            f"{p}_fleet_utilization",
            "EWMA of fleet in-flight / (replica_slots * replicas), "
            "the elastic band signal")
        self.replicas_target = Gauge(
            f"{p}_replicas_target",
            "replica count the elastic supervisor is converging to")
        self.resizes = LabeledCounter(
            f"{p}_resizes_total", "direction",
            "elastic resizes executed, direction=up|down")
        self.resize_holds = Counter(
            f"{p}_resize_holds_total",
            "resizes deferred because a rollout/canary soak was in "
            "flight (path-group pinning)")
        self._all = (self.ticks, self.standby_ticks, self.plans,
                     self.moves, self.pushes, self.push_errors,
                     self.tenants, self.tenants_placed, self.converged,
                     self.fleet_util, self.replicas_target, self.resizes,
                     self.resize_holds)
        registry().register("placer", self.render)


class ServingMetrics(_Group):
    """``xgbtpu_serving_*`` (``obs/metrics.py:1197-1289``): one instance
    is shared by engine, batcher, registry and HTTP front end.  It
    registers as group ``"serving"`` (the latest instance wins), and its
    :meth:`render` appends every other registered group, so one scrape
    covers the process."""

    def __init__(self, prefix: str = "xgbtpu_serving"):
        self.prefix = prefix
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        p = prefix
        self.requests = self.counter(
            f"{p}_requests_total", "prediction requests received")
        self.rows = self.counter(
            f"{p}_rows_total", "real (caller-supplied) rows predicted")
        self.padded_rows = self.counter(
            f"{p}_padded_rows_total",
            "padding rows added to reach the shape bucket")
        self.rejected = self.counter(
            f"{p}_rejected_total", "requests rejected with QueueFull (503)")
        self.errors = self.counter(
            f"{p}_errors_total", "requests that raised during prediction")
        self.batches = self.counter(
            f"{p}_batches_total", "coalesced device batches executed")
        self.compiles = self.counter(
            f"{p}_compiles_total", "predict executables compiled")
        self.reloads = self.counter(
            f"{p}_reloads_total", "successful model hot-reloads")
        self.reload_errors = self.counter(
            f"{p}_reload_errors_total", "failed model reload attempts")
        self.queue_rows = self.gauge(
            f"{p}_queue_rows", "rows currently waiting in the batch queue")
        self.model_version = self.gauge(
            f"{p}_model_version", "monotonic version of the served model")
        self.batch_rows = self.histogram(
            f"{p}_batch_rows", "rows per coalesced device batch",
            _ROWS_BUCKETS)
        self.latency = self.histogram(
            f"{p}_latency_seconds",
            "request latency, submit to result (includes queueing)")
        self.latency_p50 = self.gauge(
            f"{p}_latency_p50_seconds", "p50 request latency")
        self.latency_p99 = self.gauge(
            f"{p}_latency_p99_seconds", "p99 request latency")
        registry().register("serving", self._render_own)

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = _LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_text, buckets))

    def _register(self, m):
        with self._lock:
            if m.name in self._metrics:
                return self._metrics[m.name]
            self._metrics[m.name] = m
            return m

    @property
    def uptime_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def quantiles(self, qs: Tuple[float, ...] = (0.5, 0.99)
                  ) -> Dict[float, float]:
        return {q: self.latency.quantile(q) for q in qs}

    def _render_own(self) -> str:
        self.latency_p50.set(self.latency.quantile(0.5))
        self.latency_p99.set(self.latency.quantile(0.99))
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.render() for m in metrics)

    def render(self) -> str:
        reliability_metrics()
        return self._render_own() + registry().render(exclude=("serving",))


_SINGLETONS: Dict[type, _Group] = {}
_SINGLETON_LOCK = threading.Lock()


def _singleton(cls):
    group = _SINGLETONS.get(cls)
    if group is None:
        with _SINGLETON_LOCK:
            group = _SINGLETONS.get(cls)
            if group is None:
                group = _SINGLETONS[cls] = cls()
    return group


def training_metrics() -> TrainingMetrics:
    return _singleton(TrainingMetrics)


def reliability_metrics() -> ReliabilityMetrics:
    return _singleton(ReliabilityMetrics)


def pipeline_metrics() -> PipelineMetrics:
    return _singleton(PipelineMetrics)


def lane_metrics() -> LaneMetrics:
    return _singleton(LaneMetrics)


def predict_metrics() -> PredictMetrics:
    return _singleton(PredictMetrics)


def featurestore_metrics() -> FeatureStoreMetrics:
    return _singleton(FeatureStoreMetrics)


def catalog_metrics() -> CatalogMetrics:
    return _singleton(CatalogMetrics)


def fleet_metrics() -> FleetMetrics:
    return _singleton(FleetMetrics)


def tenant_metrics() -> TenantMetrics:
    return _singleton(TenantMetrics)


def placer_metrics() -> PlacerMetrics:
    return _singleton(PlacerMetrics)


_TENANT_DEQUEUES: Optional[LabeledCounter] = None


def tenant_dequeues() -> LabeledCounter:
    """``xgbtpu_batcher_tenant_dequeues_total{model}``
    (``obs/metrics.py:896``): requests the micro-batcher dequeued per
    tenant, the observable side of its weighted round robin."""
    global _TENANT_DEQUEUES
    if _TENANT_DEQUEUES is None:
        with _SINGLETON_LOCK:
            if _TENANT_DEQUEUES is None:
                c = LabeledCounter(
                    "xgbtpu_batcher_tenant_dequeues_total", "model",
                    "micro-batcher dequeues per tenant (WRR fairness)")
                registry().register("batcher", c.render)
                _TENANT_DEQUEUES = c
    return _TENANT_DEQUEUES


def swallowed_error(site: str, exc: Optional[BaseException] = None) -> None:
    """Count a deliberately swallowed exception
    (``xgbtpu_swallowed_errors_total{site=...}``) and log it as an
    ``error.swallowed`` event.  Never raises: it runs inside ``except``
    blocks."""
    try:
        reliability_metrics().swallowed.inc(site)
        from xgboost_tpu_torch.obs.trace import event
        event("error.swallowed", site=site,
              error=f"{type(exc).__name__}: {exc}" if exc else "")
    except Exception:  # noqa: BLE001 -- accounting must not raise
        pass
