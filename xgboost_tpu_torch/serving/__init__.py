"""xgboost_tpu_torch.serving: batched prediction service with one CUDA
graph per row bucket (port of ``xgboost_tpu/serving``).

:class:`PredictEngine` holds one loaded model and a captured CUDA graph
of its margin function per power-of-two row bucket (eager on the CPU);
:class:`MicroBatcher` coalesces concurrent requests into one engine call
with bounded-queue backpressure, tenant-weighted round robin and
deadlines; :class:`ModelRegistry` hot-reloads a watched model path
atomically, with rollback, CRC verification before build and
poisoned-fingerprint memory; :class:`FeatureStore` keeps hot entities'
rows on the device for :func:`predict_by_id`; :class:`PredictServer` is
the stdlib HTTP front end (``/predict``, ``/predict_by_id``,
``/featurestore/*``, ``/healthz``, ``/metrics``, ``/-/reload``,
``/-/rollback``, ``/-/catalog``), draining on SIGTERM.  The fleet (router,
membership, rollout) is not ported (ROADMAP.md section 1 item 14b).

Quickstart::

    python -m xgboost_tpu_torch.serving --model m.bin --port 8080

(``--device cpu`` on a machine without a GPU), or from the classic CLI:
``python -m xgboost_tpu_torch task=serve model_in=m.bin serve_port=8080``.
"""

from xgboost_tpu_torch.serving.batcher import MicroBatcher, QueueFull
from xgboost_tpu_torch.serving.engine import (PredictEngine,
                                              power_of_two_buckets)
from xgboost_tpu_torch.serving.featurestore import (FeatureStore,
                                                    FeatureStoreMiss,
                                                    predict_by_id)
from xgboost_tpu_torch.serving.http import PredictServer, run_server
from xgboost_tpu_torch.serving.registry import ModelRegistry

__all__ = [
    "PredictEngine",
    "MicroBatcher",
    "QueueFull",
    "ModelRegistry",
    "PredictServer",
    "run_server",
    "power_of_two_buckets",
    "FeatureStore",
    "FeatureStoreMiss",
    "predict_by_id",
]
