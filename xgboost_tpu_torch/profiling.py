"""Compatibility shim (port of ``xgboost_tpu/profiling.py``): the round
profiler and the metric primitives live in :mod:`xgboost_tpu_torch.obs`;
``from xgboost_tpu_torch.profiling import RoundProfiler`` keeps working.
The serving metric group is not ported (ROADMAP.md section 1 item 16)."""

from __future__ import annotations

from xgboost_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                           LabeledCounter, MetricsRegistry,
                                           ReliabilityMetrics,
                                           TrainingMetrics, registry,
                                           reliability_metrics,
                                           training_metrics)
from xgboost_tpu_torch.obs.profiler import RoundProfiler

__all__ = [
    "RoundProfiler",
    "Counter", "Gauge", "Histogram", "LabeledCounter",
    "MetricsRegistry", "registry",
    "ReliabilityMetrics", "TrainingMetrics",
    "reliability_metrics", "training_metrics",
]
