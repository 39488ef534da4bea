"""The worker's side of the gang protocol: partition fencing, host loss,
done markers (port of ``xgboost_tpu/parallel/gang.py``).

The launcher (``parallel/launch.py``) detects deaths and stalls, re-plans
the gang's size and snapshots its own state; a worker makes the two
decisions only it can make:

- **self-fencing**: a worker that sees no fresh coordinator beacon for
  ``XGBTPU_GANG_PARTITION_SEC`` seconds assumes it has been replaced.
  It stops writing heartbeats and checkpoints and exits
  :data:`FENCE_RC`, so a healed partition never puts two writers on the
  checkpoint ring;
- **host loss**: the ``host_loss`` fault (``reliability/faults.py``'s
  gang seam) writes a ``lost-<rank>`` tombstone and exits
  :data:`HOST_LOSS_RC`.  The environment's spec fires again in every
  respawn, so the host stays lost until the launcher re-plans without it
  (a degraded attempt exports ``XGBTPU_GANG_DEGRADED``, which skips the
  check).

The coordinator's beacon is the ``coord`` file in ``XGBTPU_GANG_DIR``,
touched by the launcher every poll tick; a worker reads it at round
boundaries (``mock.begin_round`` -> :func:`on_round`).  Freshness is a
change of its mtime seen on the worker's monotonic clock, never a
difference of wall times.  ``done-<rank>`` markers (:func:`mark_done`)
tell a coordinator that re-adopted workers it did not start their clean
exits from crashes.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

from xgboost_tpu_torch.reliability.rc import (FENCE_RC,  # noqa: F401
                                              HOST_LOSS_RC)

#: the gang protocol's directory (beacon, tombstones, done markers, the
#: grow signal); unset = the protocol is a no-op
GANG_DIR_ENV = "XGBTPU_GANG_DIR"
#: seconds without a coordinator beacon before a worker self-fences
#: (0 / unset = fencing off)
PARTITION_SEC_ENV = "XGBTPU_GANG_PARTITION_SEC"
#: set on attempts below full size: the host_loss fault no longer fires
DEGRADED_ENV = "XGBTPU_GANG_DEGRADED"

#: the beacon file the launcher touches every poll tick
BEACON_NAME = "coord"
#: a partition window's seconds when the fault spec gives none
DEFAULT_WINDOW_SEC = 5.0


class PartitionClock:
    """One worker's view of the coordinator's reachability, on an
    injectable monotonic clock.  :meth:`open_window` starts a
    message-drop window (the ``partition`` fault); :meth:`observe` takes
    the newest beacon mtime and returns ``"ok"`` (reachable),
    ``"partitioned"`` (messages dropping, not yet for ``partition_sec``)
    or ``"fence"`` (unreachable past ``partition_sec``; never when it is
    0)."""

    def __init__(self, partition_sec: float = 0.0, monotonic=None):
        self.partition_sec = float(partition_sec)
        self._mono = monotonic if monotonic is not None else time.monotonic
        self._window_until = 0.0
        self._last_mtime: Optional[float] = None
        self._last_change: Optional[float] = None

    def open_window(self, sec: float) -> None:
        """Open (or extend) a message-drop window both ways."""
        self._window_until = max(self._window_until,
                                 self._mono() + float(sec))

    def window_open(self) -> bool:
        return self._mono() < self._window_until

    def observe(self, beacon_mtime: Optional[float]) -> str:
        now = self._mono()
        if self._last_change is None:
            self._last_change = now  # the grace starts at the first look
        dropped = self.window_open()
        if not dropped and beacon_mtime is not None \
                and beacon_mtime != self._last_mtime:
            # a beacon read lands only while the link is up
            self._last_mtime = beacon_mtime
            self._last_change = now
            return "ok"
        unreachable = now - self._last_change
        if self.partition_sec > 0 and unreachable > self.partition_sec:
            return "fence"
        return "partitioned" if dropped else "ok"


_clock: Optional[PartitionClock] = None
_fenced = False


def _reset() -> None:
    """Forget this process's gang state (test isolation)."""
    global _clock, _fenced
    _clock = None
    _fenced = False


def fenced() -> bool:
    """True once this worker has self-fenced: checkpoint writers must
    leave the ring alone."""
    return _fenced


def _get_clock(partition_sec: float) -> PartitionClock:
    global _clock
    if _clock is None:
        _clock = PartitionClock(partition_sec)
    return _clock


def _rank_trial() -> Tuple[str, str]:
    return (os.environ.get("XGBTPU_WORKER_ID", "0"),
            os.environ.get("XGBTPU_NUM_TRIAL", "0"))


def _die(rc: int) -> None:
    # end the process at once: the launcher must see it dead now, and a
    # normal exit can wait in a process group's teardown
    sys.stderr.flush()
    os._exit(rc)


def on_round(version: int) -> bool:
    """The round boundary's gang hook (from ``mock.begin_round``): fires
    armed gang faults at ``t<trial>.r<rank>.v<version>.``, tracks the
    coordinator's reachability and self-fences past the threshold (then
    it does not return).  False when this round's heartbeat must be
    dropped (a partition window is open)."""
    global _fenced
    rank, trial = _rank_trial()
    gang_dir = os.environ.get(GANG_DIR_ENV)
    partition_sec = float(os.environ.get(PARTITION_SEC_ENV) or 0.0)

    if not os.environ.get(DEGRADED_ENV):
        from xgboost_tpu_torch.reliability import faults
        coord = f"t{trial}.r{rank}.v{version}."
        for kind, arg in faults.gang_fault(coord):
            if kind == "host_loss":
                _host_loss(gang_dir, rank, trial, version)  # no return
            elif kind == "partition":
                sec = float(arg) if arg is not None else DEFAULT_WINDOW_SEC
                _get_clock(partition_sec).open_window(sec)
                from xgboost_tpu_torch.obs import trace
                trace.event("gang.partition", rank=rank, trial=trial,
                            window_sec=sec)
                print(f"[gang] partition window {sec}s open at "
                      f"version={version} trial={trial} (beacons drop "
                      "both ways)", file=sys.stderr)

    if _clock is None and partition_sec <= 0:
        return True  # no window ever opened, fencing off
    clock = _get_clock(partition_sec)
    mtime = None
    if gang_dir:
        try:
            mtime = os.stat(os.path.join(gang_dir, BEACON_NAME)).st_mtime
        except OSError:
            mtime = None  # an unreadable beacon counts as unreachable
    elif partition_sec > 0:
        return True  # a threshold but no gang dir: nothing to watch
    status = clock.observe(mtime)
    if status == "fence":
        _fenced = True
        from xgboost_tpu_torch.obs import trace
        from xgboost_tpu_torch.obs.metrics import reliability_metrics
        reliability_metrics().launch_fences.inc()
        trace.event("gang.fence", rank=rank, trial=trial,
                    version=version, partition_sec=partition_sec)
        print(f"[gang] FENCED: coordinator unreachable > "
              f"{partition_sec}s at version={version} trial={trial}; "
              "no further checkpoint/beacon writes, exiting "
              f"rc={FENCE_RC}", file=sys.stderr)
        _die(FENCE_RC)
    return status == "ok"


def _host_loss(gang_dir: Optional[str], rank: str, trial: str,
               version: int) -> None:
    from xgboost_tpu_torch.obs import trace
    trace.event("gang.host_loss", rank=rank, trial=trial, version=version)
    if gang_dir:
        try:
            # a tombstone: the launcher also reads HOST_LOSS_RC, so a
            # torn marker costs nothing
            with open(os.path.join(gang_dir, f"lost-{rank}"), "w") as f:
                f.write(f"v{version} t{trial}\n")
        except OSError as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("parallel.gang.tombstone", e)
    print(f"[gang] HOST LOSS at version={version} trial={trial} "
          f"rank={rank}: permanent, exiting rc={HOST_LOSS_RC} (the "
          "launcher must re-plan without this host)", file=sys.stderr)
    _die(HOST_LOSS_RC)


def mark_done() -> None:
    """Touch ``done-<rank>`` in the gang dir on a clean exit, so that a
    coordinator that re-adopted this worker (and cannot ``wait()`` it)
    tells success from a crash.  A no-op without a gang dir or once
    fenced; never raises."""
    gang_dir = os.environ.get(GANG_DIR_ENV)
    if not gang_dir or _fenced:
        return
    rank, _ = _rank_trial()
    try:
        with open(os.path.join(gang_dir, f"done-{rank}"), "w") as f:
            f.write("done\n")
    except OSError as e:
        from xgboost_tpu_torch.obs.metrics import swallowed_error
        swallowed_error("parallel.gang.mark_done", e)


def live_tombstones(gang_dir: str) -> List[str]:
    """Ranks with a ``lost-<rank>`` tombstone in the gang dir."""
    try:
        names = os.listdir(gang_dir)
    except OSError:
        return []
    return sorted(n[len("lost-"):] for n in names if n.startswith("lost-"))
