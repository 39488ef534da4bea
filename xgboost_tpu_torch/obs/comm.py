"""Per-worker collective statistics (port of ``xgboost_tpu/obs/comm.py``;
the reference's ``report_stats``, ``allreduce_mock.h:52-56,87-95``).

Every collective of the port's row-split training is a host call on a
``torch.distributed`` process group, so each one is recorded here as
``(op, count, bytes, seconds)`` with its real payload and its wall
time: cumulatively (the ``xgbtpu_comm_<op>_total``,
``_bytes_total`` and ``_seconds_total`` counters of registry group
``"comm"``, served on ``/metrics``) and per boosting round (the round
span's ``comm`` attribute, :mod:`~xgboost_tpu_torch.obs.profiler`).

Ops: ``allreduce`` (an integer level histogram or node-stat tensor
summed in place; a float one's ``all_reduce(MAX)`` int8 scale),
``allgather`` (a float tensor's partials gathered and added in rank
order, the eval margins, the device sketch's summaries, metric
partials) and ``broadcast`` (rank 0's checkpoint to every rank).
Seconds are host wall time around the call; on a card under gloo the
call includes the backend's copies through the host.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

OPS = ("allreduce", "allgather", "broadcast")

_lock = threading.Lock()
_metrics = None
_round: Optional[int] = None
# per-round tallies: round -> op -> {"count", "bytes", "seconds"}
_per_round: Dict[int, Dict[str, Dict[str, float]]] = {}
_MAX_ROUND_HISTORY = 4096


class CommMetrics:
    """Cumulative per-op counters, registered as registry group
    ``"comm"``."""

    def __init__(self, prefix: str = "xgbtpu_comm"):
        from xgboost_tpu_torch.obs.metrics import Counter, registry
        self.count: Dict[str, object] = {}
        self.bytes: Dict[str, object] = {}
        self.seconds: Dict[str, object] = {}
        for op in OPS:
            self.count[op] = Counter(f"{prefix}_{op}_total",
                                     f"host-side {op} collective calls")
            self.bytes[op] = Counter(
                f"{prefix}_{op}_bytes_total",
                f"payload bytes of this rank's {op} collectives")
            self.seconds[op] = Counter(
                f"{prefix}_{op}_seconds_total",
                f"host wall seconds in {op} collective calls")
        registry().register("comm", self.render)

    def render(self) -> str:
        parts = []
        for op in OPS:
            parts += [self.count[op].render(), self.bytes[op].render(),
                      self.seconds[op].render()]
        return "".join(parts)


def metrics() -> CommMetrics:
    """The process-wide CommMetrics singleton."""
    global _metrics
    if _metrics is None:
        with _lock:
            if _metrics is None:
                _metrics = CommMetrics()
    return _metrics


def begin_round(version: int) -> None:
    """Open the per-round tally of round ``version``."""
    global _round
    with _lock:
        _round = int(version)
        _per_round.setdefault(_round, {})
        if len(_per_round) > _MAX_ROUND_HISTORY:
            for k in sorted(_per_round)[:len(_per_round) // 2]:
                del _per_round[k]


def record(op: str, nbytes: float = 0.0, seconds: float = 0.0,
           count: int = 1) -> None:
    """Record ``count`` collective calls of ``op`` with their payload
    bytes and host wall seconds."""
    m = metrics()
    if count:
        m.count[op].inc(count)
    if nbytes:
        m.bytes[op].inc(float(nbytes))
    if seconds:
        m.seconds[op].inc(float(seconds))
    with _lock:
        if _round is None:
            return
        tally = _per_round[_round].setdefault(
            op, {"count": 0.0, "bytes": 0.0, "seconds": 0.0})
        tally["count"] += count
        tally["bytes"] += float(nbytes)
        tally["seconds"] += float(seconds)


@contextmanager
def timed(op: str, nbytes: float = 0.0, count: int = 1):
    """Time a block as ``count`` collective calls of ``op``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(op, nbytes=nbytes, seconds=time.perf_counter() - t0,
               count=count)


def round_stats(version: Optional[int] = None
                ) -> Dict[str, Dict[str, float]]:
    """Per-op tallies of one round (default: the current round); empty
    when nothing was recorded."""
    with _lock:
        v = _round if version is None else int(version)
        if v is None or v not in _per_round:
            return {}
        return {op: dict(t) for op, t in _per_round[v].items()}


def totals() -> Dict[str, Dict[str, float]]:
    """Cumulative per-op totals of this rank."""
    m = metrics()
    return {op: {"count": m.count[op].value, "bytes": m.bytes[op].value,
                 "seconds": m.seconds[op].value} for op in OPS}
