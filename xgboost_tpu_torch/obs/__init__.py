"""xgboost_tpu_torch.obs: spans, the JSONL event log and the metric groups
of the pipeline and tenant lanes (port of the part of ``xgboost_tpu/obs``
that these paths call; same metric and event names)."""

from xgboost_tpu_torch.obs.events import configure_log, get_log
from xgboost_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                           LabeledCounter, LaneMetrics,
                                           PipelineMetrics, TrainingMetrics,
                                           lane_metrics, pipeline_metrics,
                                           registry, reliability_metrics,
                                           training_metrics)
from xgboost_tpu_torch.obs.trace import event, span

__all__ = ["Counter", "Gauge", "Histogram", "LabeledCounter", "LaneMetrics",
           "PipelineMetrics", "TrainingMetrics", "configure_log", "event",
           "get_log", "lane_metrics", "pipeline_metrics", "registry",
           "reliability_metrics", "span", "training_metrics"]
