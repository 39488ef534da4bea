"""Prometheus-style metric primitives and the metric groups the pipeline
and tenant lanes feed (port of ``xgboost_tpu/obs/metrics.py:45-235,
443-551,672-815``, with the same metric names), and the round
profiler's training metrics.

One process-wide :class:`MetricsRegistry` holds every group's render
function, so ``registry().render()`` is the whole process's exposition
text.  Only what the pipeline, the checkpoint ring and the lane dispatcher
call is ported; serving, predict, stream and catalog groups are not
(ROADMAP.md section 1 item 16).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, Optional, Sequence

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


class Histogram:
    """Fixed-bucket histogram (Prometheus ``histogram``)."""

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

    def render(self) -> str:
        with self._lock:
            fns = list(self._groups.values())
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
    """``xgbtpu_*`` failure-path counters the checkpoint ring feeds."""

    def __init__(self, prefix: str = "xgbtpu"):
        p = prefix
        self.ring_fallbacks = Counter(
            f"{p}_ckpt_ring_fallbacks_total",
            "checkpoint loads that fell back past a corrupt ring member")
        self.quarantines = Counter(
            f"{p}_quarantined_files_total",
            "corrupt files moved aside as *.corrupt")
        self.swallowed = LabeledCounter(
            f"{p}_swallowed_errors_total", "site",
            "exceptions deliberately swallowed, by site")
        self._all = (self.ring_fallbacks, self.quarantines, self.swallowed)
        registry().register("reliability", self.render)


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
