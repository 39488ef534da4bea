"""xgboost_tpu_torch.obs: spans, trace ids, the JSONL event log, the
round profiler, the live metrics server and the metric groups of
training, the pipeline, tenant lanes, prediction, the feature store, the
catalog, the fleet, tenant quotas, the placer and serving (port of the
part of ``xgboost_tpu/obs`` that these paths call; same metric and event
names)."""

import os

from xgboost_tpu_torch.obs.events import configure_log, get_log
from xgboost_tpu_torch.obs.metrics import (CatalogMetrics, Counter,
                                           FeatureStoreMetrics, FleetMetrics,
                                           Gauge, Histogram, LabeledCounter,
                                           LabeledGauge, LaneMetrics,
                                           PipelineMetrics, PlacerMetrics,
                                           PredictMetrics, ServingMetrics,
                                           TenantMetrics, TrainingMetrics,
                                           catalog_metrics,
                                           featurestore_metrics,
                                           fleet_metrics, lane_metrics,
                                           pipeline_metrics, placer_metrics,
                                           predict_metrics, registry,
                                           reliability_metrics,
                                           tenant_dequeues, tenant_metrics,
                                           timed_device_put,
                                           training_metrics)
from xgboost_tpu_torch.obs.profiler import RoundProfiler
from xgboost_tpu_torch.obs.server import (get_metrics_server,
                                          start_metrics_server,
                                          stop_metrics_server)
from xgboost_tpu_torch.obs.trace import (current_span_id,
                                         current_trace_id, event, span,
                                         trace_context)


def phases_enabled() -> bool:
    """True when round-phase instrumentation runs without ``profile>=1``
    (``obs/__init__.py:51-70``): the event log is configured or
    ``XGBTPU_OBS=1``.  Phases end on device barriers and keep the round
    loop per round (no segment, no lane stacking), the cost contract of
    ``profile=1``.  ``XGBTPU_OBS_PHASES=0`` keeps a configured event log
    without them."""
    if os.environ.get("XGBTPU_OBS_PHASES", "") == "0":
        return False
    if get_log() is not None:
        return True
    return os.environ.get("XGBTPU_OBS", "") not in ("", "0")


__all__ = ["CatalogMetrics", "Counter", "FeatureStoreMetrics", "FleetMetrics",
           "Gauge", "Histogram", "LabeledCounter", "LabeledGauge",
           "LaneMetrics", "PipelineMetrics", "PlacerMetrics", "PredictMetrics",
           "RoundProfiler", "ServingMetrics", "TenantMetrics",
           "TrainingMetrics", "catalog_metrics", "configure_log",
           "current_span_id", "current_trace_id", "event",
           "featurestore_metrics", "fleet_metrics", "get_log",
           "get_metrics_server", "lane_metrics", "phases_enabled",
           "pipeline_metrics", "placer_metrics", "predict_metrics", "registry",
           "reliability_metrics", "span", "start_metrics_server",
           "stop_metrics_server", "tenant_dequeues", "tenant_metrics",
           "timed_device_put", "trace_context", "training_metrics"]
