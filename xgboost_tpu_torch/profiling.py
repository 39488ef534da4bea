"""Compatibility shim (port of ``xgboost_tpu/profiling.py``): the round
profiler and the metric primitives and groups live in
:mod:`xgboost_tpu_torch.obs`; ``from xgboost_tpu_torch.profiling import
RoundProfiler`` (or ``ServingMetrics``) keeps working."""

from __future__ import annotations

from xgboost_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                           LabeledCounter, LabeledGauge,
                                           MetricsRegistry,
                                           ReliabilityMetrics,
                                           ServingMetrics, TrainingMetrics,
                                           registry, reliability_metrics,
                                           training_metrics)
from xgboost_tpu_torch.obs.profiler import RoundProfiler

__all__ = [
    "RoundProfiler",
    "Counter", "Gauge", "Histogram", "LabeledCounter", "LabeledGauge",
    "MetricsRegistry", "registry",
    "ReliabilityMetrics", "ServingMetrics", "TrainingMetrics",
    "reliability_metrics", "training_metrics",
]
