"""Elastic supervisor: hold fleet utilization inside a target band (port
of ``xgboost_tpu/placer/elastic.py``).

The second placer loop (SERVING.md "Autonomous placement"): where the
:class:`~xgboost_tpu_torch.placer.controller.PlacementController` decides
WHERE models live, this decides HOW MANY replicas exist.  The signal
is fleet utilization — router in-flight over nominal capacity
(``placer_replica_slots`` per replica), EWMA-smoothed — and the policy
is a band state machine:

- ``steady``     — utilization inside ``[util_low, util_high]``.
- ``scale_up``   — above the band and below ``max_replicas``: spawn
  one replica through the launcher; it registers through the normal
  lease path and starts taking traffic when healthy.
- ``scale_down`` — below the band and above ``min_replicas``: drain
  one replica.  The drain deregisters AT DRAIN START (the replica's
  SIGTERM drain path, PR 7) so the router stops dispatching before the
  first 503 — no request is lost.
- ``hold``       — a rollout/canary soak is in flight
  (``rollout_in_progress`` on the router's ``/healthz``): the fleet
  size is pinned, because a drain mid-soak could remove the canary's
  pinned path-groups and invalidate the gate.  The withheld resize is
  counted (``xgbtpu_placer_resize_holds_total``).

One resize per ``cooldown_sec`` — a burst walks the fleet up one
replica at a time instead of thrashing.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Callable, Optional

from xgboost_tpu_torch.obs import event
from xgboost_tpu_torch.obs.metrics import placer_metrics, swallowed_error


class ElasticSupervisor:
    """Band controller over a replica launcher.

    The launcher contract is three callables, so tests drive a fake
    and ``xgboost_tpu_torch/tools/launch_fleet.py --supervise`` passes its
    ``FleetLauncher`` methods: ``spawn_fn()`` starts one replica,
    ``drain_fn()`` drains one (deregister-at-drain-start) and returns
    an identifier or None, ``count_fn()`` is the current replica
    count.  ``probe_fn`` (tests) overrides the router ``/healthz``
    probe."""

    def __init__(self, router_url: str,
                 spawn_fn: Callable[[], object],
                 drain_fn: Callable[[], Optional[object]],
                 count_fn: Callable[[], int],
                 min_replicas: int = 1, max_replicas: int = 8,
                 util_low: float = 0.2, util_high: float = 0.75,
                 util_alpha: float = 0.3, replica_slots: int = 8,
                 cooldown_sec: float = 10.0, http_timeout: float = 5.0,
                 probe_fn: Optional[Callable[[], dict]] = None):
        self.router_url = router_url.rstrip("/")
        self.spawn_fn = spawn_fn
        self.drain_fn = drain_fn
        self.count_fn = count_fn
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.util_low = float(util_low)
        self.util_high = float(util_high)
        self.util_alpha = float(util_alpha)
        self.replica_slots = max(int(replica_slots), 1)
        self.cooldown_sec = float(cooldown_sec)
        self.http_timeout = float(http_timeout)
        self.probe_fn = probe_fn or self._probe_router
        self.util = 0.0                 # EWMA utilization
        self.state = "steady"
        self._rollout_active = False
        self._last_resize = 0.0         # monotonic; 0 = never
        self.metrics = placer_metrics()

    # ------------------------------------------------------------- signal
    def _probe_router(self) -> dict:
        with urllib.request.urlopen(self.router_url + "/healthz",
                                    timeout=self.http_timeout) as r:
            return json.loads(r.read())

    def observe(self) -> float:
        """Fold one router probe into the utilization EWMA."""
        st = self.probe_fn()
        members = max(int(st.get("members") or 0), 1)
        inflight = float(st.get("inflight") or 0.0)
        raw = inflight / float(self.replica_slots * members)
        self.util += self.util_alpha * (raw - self.util)
        self.metrics.fleet_util.set(round(self.util, 4))
        self._rollout_active = bool(st.get("rollout_in_progress"))
        return self.util

    # --------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One band evaluation; returns ``{"state": ..., "util": ...,
        "replicas": ...}``."""
        try:
            self.observe()
        except (OSError, ValueError) as e:
            # router unreachable: freeze the fleet size — resizing
            # blind could drain the last healthy replica
            swallowed_error("placer.elastic.probe", e)
            self.state = "steady"
            return {"state": self.state, "util": round(self.util, 4),
                    "replicas": self.count_fn(), "error": str(e)}
        n = int(self.count_fn())
        now = time.monotonic()
        cooled = (self._last_resize == 0.0
                  or now - self._last_resize >= self.cooldown_sec)
        want_up = self.util > self.util_high and n < self.max_replicas
        want_down = self.util < self.util_low and n > self.min_replicas
        if (want_up or want_down) and self._rollout_active:
            # resize-during-rollout rule: the soak's path-groups are
            # pinned — defer until the gate settles
            self.state = "hold"
            self.metrics.resize_holds.inc()
            event("placer.resize_hold", util=round(self.util, 4),
                  replicas=n)
        elif want_up and cooled:
            self.state = "scale_up"
            self.spawn_fn()
            self._last_resize = now
            n += 1
            self.metrics.resizes.inc("up")
            event("placer.scale_up", util=round(self.util, 4),
                  replicas=n)
        elif want_down and cooled:
            self.state = "scale_down"
            victim = self.drain_fn()
            if victim is not None:
                self._last_resize = now
                n -= 1
                self.metrics.resizes.inc("down")
                event("placer.scale_down", util=round(self.util, 4),
                      replicas=n, victim=str(victim))
        else:
            self.state = "steady"
        self.metrics.replicas_target.set(n)
        return {"state": self.state, "util": round(self.util, 4),
                "replicas": n}
