"""Fault injection at the collective seam (port of
``xgboost_tpu/parallel/mock.py``; the reference's ``AllreduceMock``,
``subtree/rabit/src/allreduce_mock.h:37-44,166-172``).

A worker dies, or hangs, at an exact ``(version, seqno, ntrial)``
coordinate: ``version`` is the boosting round (:func:`begin_round`),
``seqno`` counts the round's tree launches (:func:`collective`, one a
tree, before the tree's device work) and ``ntrial`` the gang's restarts
(``XGBTPU_NUM_TRIAL``), so a fault fires once and the restarted run
sails past it.  The coordinates are the JAX package's: a ``mock=`` spec
fires at the same round and tree in both.

Two kinds share the coordinates:

- ``die`` (the default) raises :class:`WorkerFailure`, the reference
  mock's ``exit(-2)``: a crash that a keepalive restart absorbs;
- ``stall`` sleeps at the coordinate (``STALL_SEC``, in 0.25 s slices
  so that a SIGTERM lands), the hang that only the launcher's heartbeat
  watchdog (``parallel/launch.py``) can end.

The round boundary is also the worker's liveness beacon: under
``XGBTPU_HEARTBEAT_DIR`` every rank touches ``hb-<rank>`` there each
round, after the gang protocol's hook (``parallel/gang.py``) has had its
say (it may end the process, or drop the beacon while a partition
window is open).

One deliberate difference: the JAX ``collective()`` records one logical
``allreduce`` into ``obs/comm.py`` a seqno, because its collectives run
inside jitted programs.  The port's collectives are host calls that
``parallel/mesh.py`` records with their real bytes and seconds, so
:func:`collective` counts the seqno only, and :func:`collective_calls`
is the number of seqnos, not ``xgbtpu_comm_allreduce_total``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

#: directory of per-rank heartbeat files, exported by the launcher's
#: watchdog (parallel/launch.py); unset = no beacon
HEARTBEAT_DIR_ENV = "XGBTPU_HEARTBEAT_DIR"

#: how long a ``stall`` sleeps: in effect forever, the watchdog ends it
STALL_SEC = 10_000.0


class WorkerFailure(RuntimeError):
    """A simulated worker death (the reference mock's ``exit(-2)``)."""


class FaultInjector:
    """Fires at a registered ``(version, seqno, ntrial)`` coordinate:
    ``die`` raises :class:`WorkerFailure`, ``stall`` sleeps.  Spec
    entries are 3-tuples (die) or ``(version, seqno, ntrial, kind)``."""

    def __init__(self, spec: List[Tuple], trial: int = 0,
                 stall_sec: float = STALL_SEC):
        self.spec = {}
        for item in spec:
            if len(item) == 3:
                v, s, t = item
                kind = "die"
            else:
                v, s, t, kind = item
            if kind not in ("die", "stall"):
                raise ValueError(f"unknown mock fault kind {kind!r}")
            self.spec[(int(v), int(s), int(t))] = kind
        self.trial = trial
        self.stall_sec = float(stall_sec)
        self.version = -1
        self.seqno = 0

    def begin_round(self, version: int) -> None:
        self.version = version
        self.seqno = 0

    def collective(self) -> None:
        coord = (self.version, self.seqno, self.trial)
        self.seqno += 1
        kind = self.spec.get(coord)
        if kind is None:
            return
        from xgboost_tpu_torch.obs import trace
        if kind == "die":
            trace.event("fault.injected", kind="worker_death",
                        seam="collective", seqno=coord[1],
                        trial=self.trial)
            raise WorkerFailure(
                f"[mock] die at version={coord[0]} seqno={coord[1]} "
                f"trial={self.trial}")
        trace.event("fault.injected", kind="worker_stall",
                    seam="collective", seqno=coord[1], trial=self.trial)
        print(f"[mock] stall at version={coord[0]} seqno={coord[1]} "
              f"trial={self.trial} (heartbeats stop; the watchdog "
              "must kill this gang)", file=sys.stderr)
        sys.stderr.flush()
        deadline = time.monotonic() + self.stall_sec
        while time.monotonic() < deadline:
            time.sleep(0.25)


_injector: Optional[FaultInjector] = None
_calls = 0  # lifetime collective-seam entries


def set_fault_injection(spec: List[Tuple], trial: int = 0,
                        stall_sec: float = STALL_SEC) -> None:
    """Install a process-wide injector (the CLI's ``mock=``)."""
    global _injector
    _injector = FaultInjector(spec, trial, stall_sec=stall_sec)


def clear_fault_injection() -> None:
    global _injector
    _injector = None


def touch_heartbeat(version: int) -> None:
    """Touch this rank's ``hb-<rank>`` file under
    ``XGBTPU_HEARTBEAT_DIR`` (a no-op without it).  Never raises: a
    beacon failure must not kill a healthy worker."""
    hb_dir = os.environ.get(HEARTBEAT_DIR_ENV)
    if not hb_dir:
        return
    rank = os.environ.get("XGBTPU_WORKER_ID", "0")
    try:
        # a liveness beacon: the watchdog reads only its mtime
        with open(os.path.join(hb_dir, f"hb-{rank}"), "w") as f:
            f.write(str(version))
    except OSError as e:
        from xgboost_tpu_torch.obs.metrics import swallowed_error
        swallowed_error("parallel.mock.touch_heartbeat", e)


def begin_round(version: int) -> None:
    """The round boundary, in the JAX package's order: the gang hook
    (which may end the process or drop the beacon), the heartbeat, the
    collective tallies' round, the trace round, the injector."""
    from xgboost_tpu_torch.obs import comm, trace
    from xgboost_tpu_torch.parallel import gang
    if gang.on_round(version):
        touch_heartbeat(version)
    comm.begin_round(version)
    trace.set_round(version)
    if _injector is not None:
        _injector.begin_round(version)


def collective() -> None:
    """One seqno: called once a tree, before the tree's device work."""
    global _calls
    _calls += 1
    if _injector is not None:
        _injector.collective()


def collective_calls() -> int:
    """Lifetime number of :func:`collective` entries in this process."""
    return _calls


def active() -> bool:
    """True while an injector is installed."""
    return _injector is not None
