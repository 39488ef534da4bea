"""xgboost_tpu_torch.obs: spans, trace ids, the JSONL event log, the
round profiler and the metric groups of training, the pipeline, tenant
lanes, prediction, the feature store, the catalog and serving (port of
the part of ``xgboost_tpu/obs`` that these paths call; same metric and
event names)."""

import os

from xgboost_tpu_torch.obs.events import configure_log, get_log
from xgboost_tpu_torch.obs.metrics import (CatalogMetrics, Counter,
                                           FeatureStoreMetrics, Gauge,
                                           Histogram, LabeledCounter,
                                           LabeledGauge, LaneMetrics,
                                           PipelineMetrics, PredictMetrics,
                                           ServingMetrics, TrainingMetrics,
                                           catalog_metrics,
                                           featurestore_metrics,
                                           lane_metrics, pipeline_metrics,
                                           predict_metrics, registry,
                                           reliability_metrics,
                                           tenant_dequeues, timed_device_put,
                                           training_metrics)
from xgboost_tpu_torch.obs.profiler import RoundProfiler
from xgboost_tpu_torch.obs.trace import (current_span_id,
                                         current_trace_id, event, span,
                                         trace_context)


def phases_enabled() -> bool:
    """True when round-phase instrumentation runs without ``profile>=1``
    (``obs/__init__.py:51-70``): the event log is configured or
    ``XGBTPU_OBS=1``.  Phases end on device barriers and keep the round
    loop per round (no segment, no lane stacking), the cost contract of
    ``profile=1``.  ``XGBTPU_OBS_PHASES=0`` keeps a configured event log
    without them.  The port has no metrics server yet (ROADMAP.md
    section 1 item 16)."""
    if os.environ.get("XGBTPU_OBS_PHASES", "") == "0":
        return False
    if get_log() is not None:
        return True
    return os.environ.get("XGBTPU_OBS", "") not in ("", "0")


__all__ = ["CatalogMetrics", "Counter", "FeatureStoreMetrics", "Gauge",
           "Histogram", "LabeledCounter", "LabeledGauge", "LaneMetrics",
           "PipelineMetrics", "PredictMetrics", "RoundProfiler",
           "ServingMetrics", "TrainingMetrics", "catalog_metrics",
           "configure_log", "current_span_id", "current_trace_id", "event",
           "featurestore_metrics", "get_log", "lane_metrics",
           "phases_enabled", "pipeline_metrics", "predict_metrics",
           "registry", "reliability_metrics", "span", "tenant_dequeues",
           "timed_device_put", "trace_context", "training_metrics"]
