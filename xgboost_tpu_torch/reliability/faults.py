"""Process-wide fault registry for the I/O and serving seams (port of
``xgboost_tpu/reliability/faults.py``, whole).  In the port the I/O
seams (``integrity.atomic_write`` / ``read_file``), the registry reload,
the replica predict path (``slow_replica``) and the fleet lease client
(``heartbeat_loss``, ``replica_kill``) fire; the gang kinds parse and arm
here but have no seam until the launcher's fault tolerance is ported
(ROADMAP.md section 1 item 13c; the row-split launcher of
:mod:`xgboost_tpu_torch.parallel.launch` has none).

The reference proves recovery by *injecting* failures at exact
coordinates (``AllreduceMock``, ``subtree/rabit/src/allreduce_mock.h``);
``parallel/mock.py`` carries that injector for the collective seam.
This module generalizes the idea to every other failure surface the
system persists or serves through:

============== =============================== =========================
kind            effect                          seam
============== =============================== =========================
torn_write      truncate written bytes at N     ``integrity.atomic_write``
bit_flip        flip one bit at byte N on write ``integrity.atomic_write``
enospc          raise ``OSError(ENOSPC)``       ``integrity.atomic_write``
slow_read       sleep N seconds before read     ``integrity.read_file``
read_flip       flip one bit at byte N on read  ``integrity.read_file``
reload          raise at the registry reload    ``ModelRegistry`` rebuild
heartbeat_loss  drop a lease renewal            fleet ``LeaseClient``
replica_kill    sudden replica death (no drain) fleet ``LeaseClient``
slow_replica    sleep N sec per predict         replica predict path
partition       coordinator<->worker drop N sec gang round boundary
host_loss       permanent host death, no respawn gang round boundary
============== =============================== =========================

The three fleet kinds (``@path`` matches the replica id the lease
client registered) prove the router's failure paths: ``heartbeat_loss``
lets a lease decay so the membership sweep drops the replica from
rotation; ``replica_kill`` fires the lease client's ``on_kill`` —
``os._exit(43)`` in a real replica process — without drain or
deregistration, exactly the crash the health checker + retry-once
dispatch must absorb; ``slow_replica`` wedges the predict path (arg =
seconds of added latency per request, lease + health still fine) —
the stall twin of ``replica_kill``, which the router's latency-aware
ejection (fleet/membership.py) must route around.

The two GANG kinds fire at the worker's round boundary
(``parallel/gang.py`` calls :func:`gang_fault` from
``parallel/mock.py``'s ``begin_round``), where ``@path`` matches the
coordinate string ``t<trial>.r<rank>.v<version>.`` (note the trailing
dots — ``@v2.`` targets round 2 exactly).  ``partition`` (arg =
seconds, default 5) opens a both-directions message-drop window: the
worker stops touching its heartbeat beacon and treats the
coordinator's beacon as unreadable, so after ``gang_partition_sec`` it
self-fences (RECOVERY.md degraded-mode matrix).  ``host_loss``
simulates a permanently dead host: the worker writes a tombstone and
dies with ``HOST_LOSS_RC``; because the env spec re-arms in every
respawn, the host stays dead until the launcher re-plans the gang
WITHOUT it (degraded attempts export ``XGBTPU_GANG_DEGRADED`` and skip
the host_loss check — the lost host is no longer scheduled).

Faults are armed with :func:`inject` (tests), the CLI ``faults=``
parameter, or the ``XGBTPU_FAULTS`` env var (subprocess chaos drivers,
parsed once at import).  Spec grammar, semicolon-separated::

    kind[=arg][@path_substring][*times]

(``#times`` also works, but not inside CLI config files, where ``#``
starts a comment), e.g.
``XGBTPU_FAULTS="torn_write=128@ckpt-000003;slow_read=0.05*3"``
truncates the write of the third checkpoint at byte 128 (once) and
delays the next three reads by 50 ms.  Each armed fault fires
``times`` times (default 1) and then disarms — the restarted run sails
past it, exactly the reference mock's ``ntrial`` semantics.

A spec that does not parse raises the typed :class:`FaultSpecError` at
ARM time (after emitting a ``faults.invalid_spec`` obs event), and a
bad entry arms NOTHING from the whole spec: a chaos driver with a
typo'd spec must die loudly at startup, not report a clean pass its
faults never tested.

Because the seams are the REAL production code paths (the injector
only mutates bytes or raises at them), a passing chaos suite certifies
the actual recovery logic, not a test double.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Tuple

_WRITE_KINDS = ("torn_write", "bit_flip", "enospc")
_READ_KINDS = ("slow_read", "read_flip")
_POINT_KINDS = ("reload", "heartbeat_loss", "replica_kill",
                "slow_replica")
#: gang-seam kinds (parallel/gang.py round-boundary check): the
#: @path coordinate is "t<trial>.r<rank>.v<version>."
_GANG_KINDS = ("partition", "host_loss")
_KINDS = _WRITE_KINDS + _READ_KINDS + _POINT_KINDS + _GANG_KINDS


class InjectedFault(OSError):
    """An injected (not organic) failure; carries the fault kind."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"[fault] injected {kind}"
                         + (f": {detail}" if detail else ""))
        self.kind = kind


class FaultSpecError(ValueError):
    """An ``XGBTPU_FAULTS``/``faults=`` spec failed to parse or names an
    unknown kind.  Raised at ARM time (import for the env var, ``run()``
    for the CLI param, :func:`inject` for tests) so a typo'd chaos spec
    kills the run loudly instead of silently arming nothing.
    Subclasses ``ValueError`` so pre-existing broad handlers keep
    working."""


class _Fault:
    __slots__ = ("kind", "arg", "path_sub", "remaining")

    def __init__(self, kind: str, arg: Optional[float],
                 path_sub: Optional[str], times: int):
        if kind not in _KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r}; "
                                 f"known: {', '.join(_KINDS)}")
        self.kind = kind
        self.arg = arg
        self.path_sub = path_sub
        self.remaining = int(times)

    def matches(self, path: Optional[str]) -> bool:
        if self.remaining <= 0:
            return False
        if self.path_sub is None:
            return True
        return path is not None and self.path_sub in str(path)


_registry: List[_Fault] = []
_lock = threading.Lock()
_fired: dict = {}


def inject(kind: str, arg: Optional[float] = None,
           path_sub: Optional[str] = None, times: int = 1) -> None:
    """Arm one fault (see module docstring for kinds/args)."""
    with _lock:
        _registry.append(_Fault(kind, arg, path_sub, times))


def clear_faults() -> None:
    """Disarm everything (test teardown)."""
    with _lock:
        _registry.clear()


def active() -> bool:
    with _lock:
        return any(f.remaining > 0 for f in _registry)


def fired(kind: Optional[str] = None) -> int:
    """How many faults have fired (optionally of one kind)."""
    with _lock:
        if kind is None:
            return sum(_fired.values())
        return _fired.get(kind, 0)


def _spec_error(spec: str, part: str, why: str) -> FaultSpecError:
    """Build the typed arm-time error and log it to the obs timeline
    first, so a chaos post-mortem sees WHY the run died at startup."""
    try:
        from xgboost_tpu_torch.obs import event
        event("faults.invalid_spec", spec=spec, part=part, error=why)
    except Exception as e:  # the report must not mask the parse error
        from xgboost_tpu_torch.obs.metrics import swallowed_error
        swallowed_error("faults.invalid_spec_event", e)
    return FaultSpecError(
        f"fault spec entry {part!r}: {why} (full spec {spec!r})")


def install_spec(spec: str) -> None:
    """Parse and arm a ``kind[=arg][@path][*times];...`` spec string.
    ``#times`` is accepted as an alias everywhere EXCEPT CLI config
    files, whose parser strips ``#`` comments — use ``*times`` there.

    Fails LOUD: any unparseable entry (or a spec that reduces to zero
    entries) raises :class:`FaultSpecError` after emitting a
    ``faults.invalid_spec`` obs event, and arms NOTHING — the whole
    spec is validated before the first fault is armed, so a trailing
    typo cannot leave a half-armed chaos run."""
    parsed = []
    for raw in spec.split(";"):
        part = raw.strip()
        if not part:
            continue
        times = 1
        for sep in ("*", "#"):
            if sep in part:
                part, _, t = part.rpartition(sep)
                try:
                    times = int(t)
                except ValueError:
                    raise _spec_error(spec, raw.strip(),
                                      f"repeat count {t!r} is not an "
                                      "integer") from None
                break
        if times < 1:
            raise _spec_error(spec, raw.strip(),
                              f"repeat count {times} arms a fault that "
                              "can never fire (must be >= 1)")
        path_sub = None
        if "@" in part:
            part, _, path_sub = part.partition("@")
        arg: Optional[float] = None
        if "=" in part:
            part, _, a = part.partition("=")
            try:
                arg = float(a)
            except ValueError:
                raise _spec_error(spec, raw.strip(),
                                  f"arg {a!r} is not a number") from None
        kind = part.strip()
        if not kind:
            raise _spec_error(spec, raw.strip(), "missing fault kind")
        if kind not in _KINDS:
            raise _spec_error(spec, raw.strip(),
                              f"unknown fault kind {kind!r} (known: "
                              f"{', '.join(_KINDS)})")
        parsed.append((kind, arg, path_sub or None, times))
    if not parsed:
        raise _spec_error(spec, spec, "spec arms nothing")
    for kind, arg, path_sub, times in parsed:
        inject(kind, arg, path_sub, times)


def _take(kinds, path: Optional[str], seam: str = "") -> List[_Fault]:
    """Pop (decrement) every armed fault of the given kinds matching
    ``path``, in arm order."""
    out = []
    with _lock:
        for f in _registry:
            if f.kind in kinds and f.matches(path):
                f.remaining -= 1
                _fired[f.kind] = _fired.get(f.kind, 0) + 1
                out.append(f)
    if out:
        from xgboost_tpu_torch.obs import event
        from xgboost_tpu_torch.profiling import reliability_metrics
        reliability_metrics().faults_injected.inc(len(out))
        for f in out:
            # each fired fault lands in the event-log timeline (fault
            # name, seam, path; the current boosting round attaches
            # automatically) so a CHAOS.json run correlates its deaths
            # and corruptions with the rounds they hit (post-mortems
            # read the rendered tools/obs_report.py view)
            event("fault.injected", kind=f.kind,
                  seam=seam or f.kind, path=str(path) if path else None)
    return out


def _flip_bit(data: bytes, at: int) -> bytes:
    if not data:
        return data  # nothing to corrupt in an empty payload
    at = min(max(int(at), 0), len(data) - 1)
    b = bytearray(data)
    b[at] ^= 0x40
    return bytes(b)


# ------------------------------------------------------------------ seams
def mutate_write(path: str, data: bytes) -> bytes:
    """Write seam: called by ``integrity.atomic_write`` with the bytes
    about to be persisted.  May truncate (torn_write), corrupt
    (bit_flip), or raise ``OSError(ENOSPC)``."""
    for f in _take(_WRITE_KINDS, path, seam="write"):
        if f.kind == "enospc":
            import errno
            raise OSError(errno.ENOSPC,
                          f"[fault] injected ENOSPC writing {path}")
        if f.kind == "torn_write":
            n = int(f.arg if f.arg is not None else len(data) // 2)
            data = data[:n]
        elif f.kind == "bit_flip":
            data = _flip_bit(data, f.arg if f.arg is not None
                             else len(data) // 2)
    return data


def mutate_read(path: str, data: bytes) -> bytes:
    """Read seam: called by ``integrity.read_file`` with the bytes just
    read.  May delay (slow_read) or corrupt (read_flip)."""
    for f in _take(_READ_KINDS, path, seam="read"):
        if f.kind == "slow_read":
            time.sleep(float(f.arg if f.arg is not None else 0.05))
        elif f.kind == "read_flip":
            data = _flip_bit(data, f.arg if f.arg is not None
                             else len(data) // 2)
    return data


def check(point: str, path: Optional[str] = None) -> None:
    """Named-point seam (currently ``reload``: the registry's engine
    rebuild).  Raises :class:`InjectedFault` when armed."""
    if _take((point,), path, seam=point):
        raise InjectedFault(point, str(path) if path else "")


def delay_for(point: str, path: Optional[str] = None) -> float:
    """Delay seam (``slow_replica``): seconds the calling hot path
    should sleep, summed over every armed matching fault (0.0 = none).
    Unlike :func:`check` this never raises — a wedged-but-alive
    component keeps answering, just late, which is exactly the failure
    the latency-ejection machinery exists for."""
    return sum(float(f.arg if f.arg is not None else 0.25)
               for f in _take((point,), path, seam=point))


def gang_fault(path: str) -> List[Tuple[str, Optional[float]]]:
    """Gang seam (``parallel/gang.py``): fire every armed gang fault
    matching the round coordinate ``t<trial>.r<rank>.v<version>.`` and
    return ``(kind, arg)`` pairs — ``("partition", seconds)`` opens a
    message-drop window, ``("host_loss", _)`` is a permanent host
    death.  The caller owns the effects; this just pops coordinates
    (and logs ``fault.injected``, like every other seam)."""
    return [(f.kind, f.arg)
            for f in _take(_GANG_KINDS, path, seam="gang")]


# subprocess chaos drivers arm faults via the environment; parse once at
# import so any seam hit afterwards sees them
if os.environ.get("XGBTPU_FAULTS"):
    install_spec(os.environ["XGBTPU_FAULTS"])
