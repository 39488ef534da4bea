"""xgboost_tpu_torch.pipeline: continuous training and gang-batched
tenant lanes (port of ``xgboost_tpu/pipeline``).

A :class:`ContinuousTrainer` loads the published model, appends trees
on fresh data from a :class:`DataSource`, judges the candidate against
the incumbent on a held-out window (:class:`EvalGate`) and atomically
publishes gated models (:class:`Publisher`), surviving a kill at every
boundary through its checkpoint ring and ledger.
:func:`run_tenant_lanes` runs one such pipeline per tenant, their
boosting rounds stacked into one launch per level (K4) by default.
Every booster lives on ``device`` (``"cuda"`` unless the caller passes
``"cpu"``).  ``router_url`` publishes through the fleet router's
canary rollout (:class:`RolloutPublisher`) instead.
"""

from typing import Optional

from xgboost_tpu_torch.pipeline.datasource import (CallableDataSource,
                                                   DataSource,
                                                   FileDataSource,
                                                   SyntheticDataSource)
from xgboost_tpu_torch.pipeline.gate import EvalGate
from xgboost_tpu_torch.pipeline.publisher import (Publisher,
                                                  PublishRejected,
                                                  RolloutPublisher)
from xgboost_tpu_torch.pipeline.trainer import ContinuousTrainer


def run_pipeline(publish_path: str, workdir: str = "./pipeline",
                 data: str = "", holdout: str = "",
                 rounds_per_cycle: int = 5, cycles: int = 1,
                 metric: str = "", min_delta: float = 0.0,
                 max_regression: float = 0.0, router_url: str = "",
                 publish_timeout_sec: float = 600.0,
                 sleep_sec: float = 0.0,
                 params: Optional[dict] = None,
                 source: Optional[DataSource] = None,
                 quiet: bool = False, lane: str = "",
                 trainer_cls=None, device=None) -> dict:
    """Assemble the default pipeline from flat knob values and run it
    (``pipeline/__init__.py:38``).  ``source`` overrides the file seam.
    ``lane`` names the tenant: its events are lane-tagged and, unless
    params pin one, the booster seed derives from the lane NAME, so a
    tenant's model bytes never depend on its neighbours.
    ``trainer_cls`` swaps the trainer (the lane dispatcher passes a
    :class:`~xgboost_tpu_torch.pipeline.lanes.GangTrainer` factory).
    ``router_url`` publishes through the fleet's canary rollout
    (:class:`RolloutPublisher`, ``pipeline/__init__.py:72-75``)."""
    if not publish_path:
        raise ValueError("pipeline_publish_path is required")
    if source is None:
        if not data or not holdout:
            raise ValueError(
                "pipeline_data and pipeline_holdout are required "
                "(or pass a custom DataSource)")
        source = FileDataSource(data, holdout)
    if lane and "seed" not in (params or {}):
        import zlib
        params = dict(params or {})
        params["seed"] = zlib.crc32(lane.encode("utf-8")) & 0x7FFFFFFF
    publisher = (RolloutPublisher(publish_path, router_url,
                                  timeout=publish_timeout_sec,
                                  model=lane)
                 if router_url else Publisher(publish_path))
    gate = EvalGate(metric=metric, min_delta=min_delta,
                    max_regression=max_regression)
    trainer = (trainer_cls or ContinuousTrainer)(
        publish_path, source, workdir,
        rounds_per_cycle=rounds_per_cycle, params=params, gate=gate,
        publisher=publisher, quiet=quiet, lane=lane,
        device=device)
    return trainer.run(cycles=cycles, sleep_sec=sleep_sec)


def run_lane_workers(lanes: dict, one, max_workers: int) -> None:
    """Call ``one(name, kwargs)`` for every lane on ``max_workers``
    threads that take lanes in order."""
    import threading
    pending = list(lanes)
    plock = threading.Lock()

    def _worker() -> None:
        while True:
            with plock:
                if not pending:
                    return
                name = pending.pop(0)
            one(name, lanes[name])

    threads = [threading.Thread(target=_worker, name=f"lane-worker-{i}",
                                daemon=True)
               for i in range(max_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_tenant_lanes(lanes: dict, quiet: bool = False,
                     max_workers: Optional[int] = None,
                     stacked: Optional[bool] = None,
                     window_sec: float = 0.2, device=None) -> dict:
    """Run one training lane per tenant, concurrently
    (``pipeline/__init__.py:83``).

    ``lanes`` maps a tenant name to :func:`run_pipeline` kwargs (each
    with its own ``publish_path`` / ``workdir``; the name goes in as
    ``lane=`` and ``device`` as ``device=`` unless the kwargs set them).
    Lanes are isolated: one raising or gate-failing never stalls its
    neighbours; the error stays in its own result entry.  Returns
    ``{name: {"status": "ok", "summary": ...} | {"status": "error",
    "error": ...}}``.

    Two modes, byte-identical per tenant:

    - **stacked** (default): same-shape lanes advance their boosting
      rounds together, one K4 launch per level for the whole bucket
      (:mod:`xgboost_tpu_torch.pipeline.lanes`); gate, publish and
      ledger stay per lane.  ``XGBTPU_LANE_STACK=0`` (or
      ``stacked=False``) selects the host loop.
    - **host loop**: each lane an independent pipeline, at most
      ``max_workers`` at once (default ``min(len(lanes), 8)``).
    """
    import os
    import threading

    from xgboost_tpu_torch.learner import resolve_device
    from xgboost_tpu_torch.obs import event

    device = resolve_device(device)
    if stacked is None:
        stacked = os.environ.get("XGBTPU_LANE_STACK", "1") not in ("0",)
    if stacked:
        from xgboost_tpu_torch.pipeline.lanes import run_tenant_lanes_stacked
        return run_tenant_lanes_stacked(lanes, quiet=quiet,
                                        window_sec=window_sec,
                                        max_workers=max_workers,
                                        device=device)

    results: dict = {}
    rlock = threading.Lock()

    def _one(name: str, kw: dict) -> None:
        kw = dict(kw)
        kw.setdefault("lane", name)
        kw.setdefault("quiet", quiet)
        kw.setdefault("device", device)
        try:
            summary = run_pipeline(**kw)
            with rlock:
                results[name] = {"status": "ok", "summary": summary}
        except Exception as e:  # lane isolation: never kill siblings
            with rlock:
                results[name] = {"status": "error",
                                 "error": f"{type(e).__name__}: {e}"}
            event("pipeline.lane_error", lane=name,
                  error=f"{type(e).__name__}: {e}")

    if max_workers is None:
        max_workers = min(len(lanes), 8)
    if lanes:
        run_lane_workers(lanes, _one, max(1, min(int(max_workers),
                                                 len(lanes))))
    return results


__all__ = [
    "ContinuousTrainer", "DataSource", "FileDataSource",
    "SyntheticDataSource", "CallableDataSource", "EvalGate",
    "Publisher", "RolloutPublisher", "PublishRejected", "run_pipeline",
    "run_tenant_lanes",
]
