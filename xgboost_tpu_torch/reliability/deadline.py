"""Deadlines as a first-class value (port of
``xgboost_tpu/reliability/deadline.py``; RELIABILITY.md stall matrix).

Every failure mode the reliability layer handled before this module is
a *death* — SIGKILL, torn write, bit flip.  The reference's fault model
is wider: rabit recovers from workers that stop making *progress*, not
just workers that exit (``allreduce_robust`` timeout recovery), and at
serving scale the analog is a request whose caller has already given
up.  A caller-less request is pure waste: the router forwards it, the
replica batches it, the device executes it, and nobody reads the
answer.

:class:`Deadline` is the budget object that kills that waste.  It is
created once at the edge (the client's ``X-Deadline-Ms`` header, or the
router's ``fleet_deadline_ms`` default), and every hop *spends* from it
instead of arming a fresh timeout:

- the fleet router rejects an already-expired request before any
  dispatch, stamps the REMAINING budget onto the replica hop
  (:data:`DEADLINE_HEADER`), and bounds each forward attempt (and the
  retry-once backoff) by what is left;
- the replica rejects before any device work when the remaining budget
  cannot cover the bucket's observed service time (admission by
  deadline — a 504 up front beats a 200 that arrives after the caller
  hung up);
- the :class:`~xgboost_tpu_torch.serving.batcher.MicroBatcher` drops expired
  entries pre-dispatch (the deadline twin of abandoned-request
  shedding).

Rejections count on ``xgbtpu_deadline_rejected_total``; batcher drops
on ``xgbtpu_deadline_dropped_total`` (both in the reliability metric
group).

All arithmetic uses ``time.monotonic()`` — a budget is a DURATION, and
an NTP step must not expire every request in flight (XGT006).

The module also hosts :func:`jittered`, the shared anti-lockstep
helper: periodic fleet loops (lease heartbeats, registry reload polls,
router health checks) multiply their period by ``uniform(1-f, 1+f)``
so a fleet restarted together does not heartbeat in phase forever.
"""

from __future__ import annotations

import random
import time
from typing import Optional

#: the one header name the router and replicas share — both sides
#: import THIS constant, so the propagation contract cannot drift
DEADLINE_HEADER = "X-Deadline-Ms"


class DeadlineExceeded(TimeoutError):
    """A request's deadline budget ran out before useful work started
    (batcher pre-dispatch drop, or an admission check).  Maps to HTTP
    504 at the serving front ends."""


class Deadline:
    """A monotonic spend-down budget for one request.

    Constructed from a millisecond budget; hops read the remaining
    budget (never the original) so queueing time anywhere in the chain
    is charged against the request, not forgiven."""

    __slots__ = ("_expires_at",)

    def __init__(self, budget_ms: float):
        self._expires_at = time.monotonic() + float(budget_ms) / 1e3

    # ------------------------------------------------------------ queries
    def remaining(self) -> float:
        """Seconds of budget left (never negative)."""
        return max(0.0, self._expires_at - time.monotonic())

    def remaining_ms(self) -> float:
        return self.remaining() * 1e3

    def expired(self) -> bool:
        return time.monotonic() >= self._expires_at

    # ------------------------------------------------------- propagation
    def header_value(self) -> str:
        """The remaining budget as the :data:`DEADLINE_HEADER` value —
        stamped fresh at every hop (propagating the ORIGINAL budget
        would hand downstream a lie)."""
        return str(int(self.remaining_ms()))

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["Deadline"]:
        """Parse a header value; None/garbage/negative -> no deadline
        (an unparseable budget must not fail a request that would have
        succeeded without one)."""
        if value is None:
            return None
        try:
            ms = float(value)
        except (TypeError, ValueError):
            return None
        if ms < 0:
            return None
        return cls(ms)

    @classmethod
    def from_headers(cls, headers) -> Optional["Deadline"]:
        """Parse from an ``email.message``-style headers mapping (the
        stdlib HTTP server's ``self.headers``)."""
        return cls.from_header(headers.get(DEADLINE_HEADER))

    def describe_ms(self) -> float:
        return round(self.remaining_ms(), 1)


def jittered(seconds: float, frac: float = 0.2) -> float:
    """``seconds`` scaled by ``uniform(1 - frac, 1 + frac)`` — the
    anti-lockstep discipline for periodic fleet loops.  A fleet of
    replicas restarted together would otherwise heartbeat (and poll,
    and health-check) in phase forever, turning every period into a
    synchronized thundering herd at the router."""
    return max(0.0, seconds) * random.uniform(1.0 - frac, 1.0 + frac)


def backoff_delay(attempt: int, base: float = 0.05,
                  cap: float = 2.0,
                  deadline: Optional[Deadline] = None) -> float:
    """Jittered exponential backoff for retry ``attempt`` (1-based),
    bounded so a deadline-carrying request never sleeps its remaining
    budget away: at most a quarter of what is left."""
    d = min(cap, base * (2 ** max(0, attempt - 1))) * random.uniform(0.5, 1.0)
    if deadline is not None:
        d = min(d, deadline.remaining() * 0.25)
    return max(0.0, d)
