"""Replica membership: heartbeat leases, health, consistent hashing (port
of ``xgboost_tpu/fleet/membership.py``; the same wire format and ring).

The reference's tracker tier (``tracker/rabit_tracker.py``, SURVEY.md
L0) is a rendezvous service: workers connect, get assigned a rank,
report liveness, and a restarted worker sends ``recover`` to rejoin the
job.  The serving-fleet analog lives here:

- :class:`Membership` (router side) — replicas register over HTTP and
  renew a **heartbeat lease**; a replica whose lease expires, whose
  ``/healthz`` stops answering, or whose drain state machine left
  ``serving`` drops out of rotation automatically.  A restarted replica
  simply registers again under the same id — the ``recover`` path —
  and is back in rotation on the next health pass.
- :class:`HashRing` — consistent hashing for ``/predict_by_id``
  dispatch: an entity id maps to the same replica across requests (so
  device-resident feature rows concentrate there), and a membership
  change remaps only the keys owned by the changed replica.
- :class:`LeaseClient` (replica side) — the registration/heartbeat
  client the HTTP server runs when ``serve_router_url`` is set; it
  re-registers on lease loss and deregisters on drain.  The chaos
  kinds ``heartbeat_loss`` / ``replica_kill`` (reliability/faults.py)
  hook its loop, so fleet recovery is provable the same way checkpoint
  recovery is.

All lease arithmetic uses ``time.monotonic()`` — leases are durations,
and an NTP step must not expire the whole fleet (XGT006).
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from xgboost_tpu_torch.reliability.rc import REPLICA_KILL_RC

# breaker states (per replica, managed by Membership under its lock)
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"


class Replica:
    """One registered replica: identity, lease, health, breaker, load.

    All mutable fields are guarded by the owning :class:`Membership`'s
    lock; read-mostly snapshots go out through ``describe()``."""

    def __init__(self, replica_id: str, url: str,
                 model_path: Optional[str] = None,
                 model_hash: Optional[str] = None,
                 pid: Optional[int] = None,
                 models: Optional[Dict[str, dict]] = None,
                 device: Optional[dict] = None):
        self.replica_id = replica_id
        self.url = url.rstrip("/")
        self.model_path = model_path
        self.model_hash = model_hash
        self.pid = pid
        # catalog advertisement: {model_name: {"path":..., "hash":...,
        # "bytes":...}} — which named models this replica can serve
        # (empty = a pre-catalog replica that only answers bare
        # /predict)
        self.models: Dict[str, dict] = dict(models or {})
        # device budget advertisement: {"budget_bytes":..,
        # "used_bytes":..} — the placer bin-packs against this
        self.device: dict = dict(device or {})
        self.lease_deadline = 0.0       # monotonic
        self.registered_count = 0       # bumps on every (re-)register
        self.health_ok = True           # last /healthz verdict
        self.health_state = "serving"   # replica's drain state
        self.outstanding = 0            # requests in flight via router
        # circuit breaker (consecutive-failure trip, half-open probe)
        self.breaker = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.breaker_opened_at = 0.0    # monotonic
        self.probe_inflight = False
        # latency-aware ejection (distinct from the breaker: a
        # slow-but-alive replica never fails a request, so the failure
        # counter never sees it — the EWMA does)
        self.lat_ewma = 0.0             # seconds; 0 = no samples yet
        self.lat_samples = 0
        self.ejected = False
        self.ejected_at = 0.0           # monotonic
        self.eject_probe_inflight = False
        # thread id that was GRANTED the readmission probe: release()
        # attributes the probe outcome only to that dispatch, so a
        # concurrent entity-id hop (not ejection-gated) finishing fast
        # cannot readmit a still-wedged replica
        self.eject_probe_tid = 0

    def lease_live(self, now: float) -> bool:
        return now < self.lease_deadline

    def describe(self, now: float) -> dict:
        return {
            "replica_id": self.replica_id,
            "url": self.url,
            "model_path": self.model_path,
            "model_hash": self.model_hash,
            "models": sorted(self.models),
            "models_detail": {m: dict(v) for m, v in self.models.items()},
            "device": dict(self.device),
            "pid": self.pid,
            "lease_remaining_sec": round(self.lease_deadline - now, 3),
            "health_ok": self.health_ok,
            "state": self.health_state,
            "outstanding": self.outstanding,
            "breaker": self.breaker,
            "consecutive_failures": self.consecutive_failures,
            "registered_count": self.registered_count,
            "ejected": self.ejected,
            "latency_ewma_ms": round(self.lat_ewma * 1e3, 3),
        }


class HashRing:
    """Consistent-hash ring over replica ids (virtual nodes).

    ``route(key, eligible)`` walks clockwise from the key's point to
    the first vnode whose replica is in ``eligible`` — so keys owned by
    a dead/draining replica fail over to its ring successor while every
    other key stays put (feature-store residency concentrates and
    survives membership churn)."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = int(vnodes)
        # (points, owners) swapped in ONE assignment so lock-free
        # readers (route_ids hashes outside the membership lock) always
        # see a consistent pair
        self._nodes: tuple = ((), ())

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha1(key.encode("utf-8", "replace")).digest()[:8],
            "big")

    def rebuild(self, replica_ids: List[str]) -> None:
        pts = []
        for rid in replica_ids:
            for v in range(self.vnodes):
                pts.append((self._hash(f"{rid}#{v}"), rid))
        pts.sort()
        self._nodes = (tuple(p for p, _ in pts),
                       tuple(r for _, r in pts))

    def route(self, key: str, eligible) -> Optional[str]:
        """First eligible replica clockwise from ``key``'s point."""
        points, owners = self._nodes  # one read: rebuild swaps atomically
        n = len(points)
        if n == 0:
            return None
        start = bisect.bisect_left(points, self._hash(str(key)))
        for i in range(n):
            owner = owners[(start + i) % n]
            if owner in eligible:
                return owner
        return None


class Membership:
    """The router's replica table: register/heartbeat/expire + health.

    ``in_rotation()`` is the dispatch view: lease live, last health
    check OK, drain state ``serving``.  The breaker is tracked here too
    (it is per-replica state the dispatcher consults), with the classic
    three states: CLOSED (normal) -> OPEN after
    ``breaker_failures`` consecutive errors (no traffic) ->
    HALF-OPEN after ``breaker_cooldown_sec`` (exactly one probe
    request) -> CLOSED on success / OPEN again on failure."""

    #: EWMA smoothing for per-replica dispatch latency (~last 25 obs)
    LAT_ALPHA = 0.2
    #: minimum EWMA samples (per replica) before ejection may fire —
    #: one cold-start compile must not eject a fresh replica
    EJECT_MIN_SAMPLES = 10

    def __init__(self, lease_sec: float = 10.0,
                 breaker_failures: int = 3,
                 breaker_cooldown_sec: float = 5.0,
                 slow_eject_factor: float = 3.0,
                 slow_eject_cooldown_sec: float = 5.0,
                 vnodes: int = 64):
        self.lease_sec = float(lease_sec)
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_sec = float(breaker_cooldown_sec)
        # latency ejection: EWMA above factor x the PEERS' median
        # ejects from least-loaded dispatch (0 disables); after the
        # cooldown, ONE probe request decides readmission
        self.slow_eject_factor = float(slow_eject_factor)
        self.slow_eject_cooldown_sec = float(slow_eject_cooldown_sec)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._ring = HashRing(vnodes)
        self._ring_stale = True

    # ---------------------------------------------------------- lifecycle
    def register(self, replica_id: str, url: str,
                 model_path: Optional[str] = None,
                 model_hash: Optional[str] = None,
                 pid: Optional[int] = None,
                 models: Optional[Dict[str, dict]] = None,
                 device: Optional[dict] = None) -> dict:
        """Add (or revive — the tracker ``recover`` path) a replica and
        grant a heartbeat lease.  Returns the lease grant."""
        from xgboost_tpu_torch.obs import event
        from xgboost_tpu_torch.obs.metrics import fleet_metrics
        now = time.monotonic()
        with self._lock:
            rep = self._replicas.get(replica_id)
            recovered = rep is not None
            if rep is None:
                rep = Replica(replica_id, url, model_path, model_hash, pid,
                              models=models, device=device)
                self._replicas[replica_id] = rep
            else:
                # a restarted process re-registers under its old id:
                # fresh endpoint/pid; breaker, health AND ejection
                # state start clean (the fresh process neither inherits
                # the wedged era's EWMA nor its ejection — and the
                # EJECT_MIN_SAMPLES cold-start guard applies to it like
                # any new replica)
                rep.url = url.rstrip("/")
                rep.model_path = model_path or rep.model_path
                rep.model_hash = model_hash or rep.model_hash
                rep.pid = pid if pid is not None else rep.pid
                if models is not None:
                    rep.models = dict(models)
                if device is not None:
                    rep.device = dict(device)
                rep.breaker = BREAKER_CLOSED
                rep.consecutive_failures = 0
                rep.probe_inflight = False
                rep.outstanding = 0
                rep.ejected = False
                rep.ejected_at = 0.0
                rep.eject_probe_inflight = False
                rep.eject_probe_tid = 0
                rep.lat_ewma = 0.0
                rep.lat_samples = 0
            rep.health_ok = True
            rep.health_state = "serving"
            rep.registered_count += 1
            rep.lease_deadline = now + self.lease_sec
            self._ring_stale = True
            total = len(self._replicas)
        fm = fleet_metrics()
        fm.members_registered.set(total)
        if recovered:
            fm.ejected.set(replica_id, 0.0)
        event("fleet.register", replica_id=replica_id, url=url,
              recovered=recovered)
        return {"lease_sec": self.lease_sec, "recovered": recovered}

    def heartbeat(self, replica_id: str,
                  model_hash: Optional[str] = None,
                  models: Optional[Dict[str, dict]] = None,
                  device: Optional[dict] = None) -> bool:
        """Renew a lease.  False = unknown replica (the client should
        re-register — its lease expired or the router restarted).
        ``models``/``device`` keep the catalog + budget advertisement
        fresh: the payload is DIFFED against the table so a mid-lease
        catalog change (placement delta, eviction, rollout hash bump)
        is visible as an event the moment it lands — model-aware
        routing and the placer never act on a map older than one
        heartbeat."""
        now = time.monotonic()
        added: List[str] = []
        removed: List[str] = []
        changed: List[str] = []
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return False
            rep.lease_deadline = now + self.lease_sec
            if model_hash:
                rep.model_hash = model_hash
            if models is not None and models != rep.models:
                added = sorted(m for m in models if m not in rep.models)
                removed = sorted(m for m in rep.models if m not in models)
                changed = sorted(
                    m for m in models if m in rep.models
                    and models[m] != rep.models[m])
                rep.models = dict(models)
            if device is not None:
                rep.device = dict(device)
        if added or removed or changed:
            from xgboost_tpu_torch.obs import event
            from xgboost_tpu_torch.obs.metrics import fleet_metrics
            fleet_metrics().advert_updates.inc()
            event("fleet.models_changed", replica_id=replica_id,
                  added=added, removed=removed, changed=changed)
        return True

    def deregister(self, replica_id: str) -> bool:
        """Remove a replica (drain shutdown announces itself)."""
        from xgboost_tpu_torch.obs import event
        from xgboost_tpu_torch.obs.metrics import fleet_metrics
        with self._lock:
            rep = self._replicas.pop(replica_id, None)
            self._ring_stale = True
            total = len(self._replicas)
        fleet_metrics().members_registered.set(total)
        if rep is not None:
            event("fleet.deregister", replica_id=replica_id)
        return rep is not None

    # ------------------------------------------------------------- views
    def get(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(replica_id)

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def urls(self):
        """Base URLs of every registered replica (any state) — the
        router's connection pool prunes against this set."""
        with self._lock:
            return {r.url for r in self._replicas.values()}

    def in_rotation(self) -> List[Replica]:
        """Replicas eligible for dispatch: lease live, healthy,
        drain state ``serving``.  (Breaker gating is separate — an
        OPEN breaker blocks dispatch but a half-open probe may pass.)"""
        now = time.monotonic()
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.lease_live(now) and r.health_ok
                    and r.health_state == "serving"]

    def hosting(self, model: str) -> set:
        """Replica ids advertising ``model`` in their catalog.  Empty
        model = no filter (every replica hosts its own bare default).
        A pre-catalog replica (empty advertisement) hosts no NAMED
        model — routing one there would bounce off its 404."""
        with self._lock:
            if not model:
                return set(self._replicas)
            return {rid for rid, r in self._replicas.items()
                    if model in r.models}

    def models_hosted(self) -> Dict[str, int]:
        """model name -> number of replicas advertising it (the
        router's /fleet/members summary)."""
        out: Dict[str, int] = {}
        with self._lock:
            for r in self._replicas.values():
                for m in r.models:
                    out[m] = out.get(m, 0) + 1
        return out

    def describe(self) -> dict:
        now = time.monotonic()
        with self._lock:
            reps = [r.describe(now) for r in self._replicas.values()]
        rotation = {r.replica_id for r in self.in_rotation()}
        for d in reps:
            d["in_rotation"] = d["replica_id"] in rotation
        return {"replicas": sorted(reps, key=lambda d: d["replica_id"]),
                "in_rotation": len(rotation),
                "registered": len(reps)}

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Serializable membership state for the router's zero-downtime
        restart (``fleet_state_path``): identity + endpoint + catalog
        advertisement of every LEASE-LIVE replica.  Transient state
        (breaker, EWMA, outstanding) is deliberately dropped — a
        restarted router re-learns it in seconds, while a stale 'open'
        breaker would wrongly blackhole a recovered replica."""
        now = time.monotonic()
        with self._lock:
            return {"replicas": [
                {"replica_id": r.replica_id, "url": r.url,
                 "model_path": r.model_path, "model_hash": r.model_hash,
                 "pid": r.pid, "models": r.models, "device": r.device}
                for r in self._replicas.values() if r.lease_live(now)]}

    def restore(self, state: dict) -> int:
        """Re-register every snapshotted replica with a FRESH lease:
        restored members take traffic immediately (zero-downtime
        restart), and any that died while the router was down fall out
        on the first health pass / lease expiry — exactly how a crashed
        replica is handled in steady state."""
        n = 0
        for d in state.get("replicas", []):
            try:
                self.register(d["replica_id"], d["url"],
                              model_path=d.get("model_path"),
                              model_hash=d.get("model_hash"),
                              pid=d.get("pid"),
                              models=d.get("models"),
                              device=d.get("device"))
                n += 1
            except (KeyError, TypeError) as e:
                from xgboost_tpu_torch.obs.metrics import swallowed_error
                swallowed_error("fleet.membership.restore", e)
        return n

    # ---------------------------------------------------------- dispatch
    def _breaker_allows_locked(self, rep: Replica, now: float) -> bool:
        if rep.breaker == BREAKER_CLOSED:
            return True
        if rep.breaker == BREAKER_OPEN:
            if now - rep.breaker_opened_at < self.breaker_cooldown_sec:
                return False
            rep.breaker = BREAKER_HALF_OPEN
            rep.probe_inflight = False
        # half-open: exactly one probe request at a time
        if rep.probe_inflight:
            return False
        rep.probe_inflight = True
        return True

    def _eject_allows_locked(self, rep: Replica, now: float) -> bool:
        """Latency-ejection gate (the breaker's slow twin): an ejected
        replica takes no traffic until its cooldown elapses, then
        exactly ONE probe request at a time decides readmission."""
        if not rep.ejected:
            return True
        if now - rep.ejected_at < self.slow_eject_cooldown_sec:
            return False
        if rep.eject_probe_inflight:
            return False
        rep.eject_probe_inflight = True
        # the probe outcome belongs to THIS dispatch (acquire and
        # release run on one thread end to end)
        rep.eject_probe_tid = threading.get_ident()
        return True

    @staticmethod
    def _giveback_probe_slots_locked(allowed, chosen) -> None:
        """Un-take the single-probe slots of candidates that passed the
        gates but were not picked (both the breaker's half-open slot
        and the ejection's readmission slot)."""
        for r in allowed:
            if r is chosen:
                continue
            if r.breaker == BREAKER_HALF_OPEN and r.probe_inflight:
                r.probe_inflight = False
            if r.ejected and r.eject_probe_inflight:
                r.eject_probe_inflight = False
                r.eject_probe_tid = 0

    def acquire(self, exclude=(), model: str = "") -> Optional[Replica]:
        """Pick the LEAST-LOADED dispatch target (fewest outstanding
        requests) over in-rotation, breaker- and ejection-permitting
        replicas and count it as outstanding.  ``exclude`` removes
        replicas already tried (the retry path); ``model`` restricts
        the pool to replicas HOSTING that catalog model (least-loaded
        within the hosting set — model-aware routing).  Entity-id
        traffic uses :meth:`acquire_specific` on the resolved ring
        owner instead.  Callers MUST pair with :meth:`release`.

        Latency ejection shapes the pool only where an alternative
        exists: when every permitted replica is ejected (a 2-replica
        fleet whose fast replica just died), the least-loaded ejected
        one with a closed breaker answers, late, instead of a 503.  The
        JAX package's ``acquire`` returns None there until a cooldown
        ends."""
        now = time.monotonic()
        rotation = {r.replica_id for r in self.in_rotation()}
        if model:
            rotation &= self.hosting(model)
        with self._lock:
            candidates = [r for rid, r in self._replicas.items()
                          if rid in rotation and rid not in exclude]
            allowed, slow = [], []
            for r in candidates:
                if not self._breaker_allows_locked(r, now):
                    continue
                if not self._eject_allows_locked(r, now):
                    # give back the breaker's half-open slot the first
                    # gate just took — a leaked slot blocks every
                    # future breaker probe on this replica
                    if r.breaker == BREAKER_HALF_OPEN and r.probe_inflight:
                        r.probe_inflight = False
                    slow.append(r)
                    continue
                allowed.append(r)
            # the gates mark single-probe slots taken; give back the
            # slots of candidates we do not pick
            chosen: Optional[Replica] = None
            if allowed:
                chosen = min(allowed,
                             key=lambda r: (r.outstanding,
                                            r.replica_id))
            self._giveback_probe_slots_locked(allowed, chosen)
            if chosen is None:
                # no slot taken: a plain dispatch, never the
                # readmission probe (release tells them apart by thread)
                slow = [r for r in slow if r.breaker == BREAKER_CLOSED]
                if not slow:
                    return None
                chosen = min(slow, key=lambda r: (r.outstanding,
                                                  r.replica_id))
            chosen.outstanding += 1
            return chosen

    def acquire_specific(self, replica_id: str) -> Optional[Replica]:
        """Count a dispatch against ONE named replica (the router's
        split-merge path already resolved ring ownership): in-rotation
        and breaker-permitting, else None.  Pair with :meth:`release`.

        Deliberately NOT ejection-gated: entity-id traffic is sticky by
        design (the owner holds the resident rows — there is no correct
        replica to route around TO), and the invalidate broadcast must
        reach a wedged-but-alive replica or it serves stale rows after
        readmission.  A slow owner answers its entity traffic late;
        latency ejection shapes only the LEAST-LOADED pool, where an
        alternative exists (:meth:`acquire`)."""
        now = time.monotonic()
        rotation = {r.replica_id for r in self.in_rotation()}
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or replica_id not in rotation:
                return None
            if not self._breaker_allows_locked(rep, now):
                return None
            rep.outstanding += 1
            return rep

    def route_ids(self, ids: List, model: str = "") -> Dict[str, List[int]]:
        """Partition entity ids by their consistent-hash owner among
        in-rotation replicas: ``{replica_id: [positions...]}`` in input
        order.  Empty when no replica is available.  ``model`` keys
        ownership per (model, entity): the hash input is prefixed with
        the model name AND the eligible set shrinks to its hosting
        replicas, so each tenant's hot rows concentrate independently.

        Only the ring FRESHNESS check holds the membership lock; the
        per-id hashing runs outside it (the ring's node arrays swap
        atomically on rebuild), so a large id list cannot stall every
        concurrent dispatch/heartbeat behind SHA-1 work."""
        eligible = {r.replica_id for r in self.in_rotation()}
        if model:
            eligible &= self.hosting(model)
        out: Dict[str, List[int]] = {}
        if not eligible:
            return out
        with self._lock:
            if self._ring_stale:
                self._ring.rebuild(sorted(self._replicas))
                self._ring_stale = False
            ring = self._ring
        prefix = f"{model}\x00" if model else ""
        for i, eid in enumerate(ids):
            rid = ring.route(prefix + str(eid), eligible)
            if rid is not None:
                out.setdefault(rid, []).append(i)
        return out

    def _peer_median_lat_locked(self, rep: Replica) -> float:
        """Median of the LEASE-LIVE peers' latency EWMAs — the
        ejection comparator.  Excluding ``rep`` itself matters: in a
        2-replica fleet a median that includes the wedged replica's
        own EWMA can never be exceeded by ``factor >= 2`` no matter
        how slow it gets (b > f*(a+b)/2 is unsatisfiable), silently
        disabling the feature in the most common small-fleet shape.
        Excluding lease-dead members matters too: a killed replica's
        stale (possibly wedged-era) EWMA would otherwise skew the
        comparator forever — only deregister() removes entries.  0.0
        when no live peer has samples (a fleet of one has no 'slow
        relative to whom')."""
        now = time.monotonic()
        vals = sorted(r.lat_ewma for r in self._replicas.values()
                      if r is not rep and r.lat_samples > 0
                      and r.lease_live(now))
        if not vals:
            return 0.0
        n = len(vals)
        return (vals[n // 2] if n % 2
                else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))

    def release(self, rep: Replica, ok: Optional[bool],
                latency: Optional[float] = None) -> None:
        """Report a dispatch outcome: drives load counts, the breaker
        state machine, AND (with ``latency``, successful hops only) the
        per-replica latency EWMA behind slow ejection.  A replica whose
        EWMA exceeds ``slow_eject_factor`` x its PEERS' median leaves
        least-loaded dispatch until a post-cooldown probe comes back
        fast — the stall analog of the breaker, for replicas that never
        FAIL a request but wreck the fleet p99 answering it.

        ``ok=None`` is a NEUTRAL release: the hop was cut short by the
        REQUEST'S deadline budget, not by the replica — load counts and
        probe slots are returned, but neither the breaker nor the EWMA
        is charged (a few tight-budget clients must not trip a healthy
        replica's breaker for everyone else)."""
        from xgboost_tpu_torch.obs import event
        from xgboost_tpu_torch.obs.metrics import fleet_metrics
        tripped = False
        ejected_now = False
        readmitted = False
        with self._lock:
            rep.outstanding = max(0, rep.outstanding - 1)
            if rep.breaker == BREAKER_HALF_OPEN:
                rep.probe_inflight = False
            # probe attribution is by thread token: a concurrent
            # entity-id hop releasing on an ejected replica must not
            # be mistaken for the readmission probe (nor free its slot)
            was_eject_probe = (rep.ejected and rep.eject_probe_inflight
                               and rep.eject_probe_tid
                               == threading.get_ident())
            if was_eject_probe:
                rep.eject_probe_inflight = False
                rep.eject_probe_tid = 0
            if ok is None:
                return
            if ok:
                rep.consecutive_failures = 0
                if rep.breaker != BREAKER_CLOSED:
                    rep.breaker = BREAKER_CLOSED
            else:
                rep.consecutive_failures += 1
                if rep.breaker == BREAKER_HALF_OPEN:
                    # failed probe: back to OPEN for another cooldown
                    rep.breaker = BREAKER_OPEN
                    rep.breaker_opened_at = time.monotonic()
                elif (rep.breaker == BREAKER_CLOSED
                      and rep.consecutive_failures
                      >= self.breaker_failures):
                    rep.breaker = BREAKER_OPEN
                    rep.breaker_opened_at = time.monotonic()
                    tripped = True
                if was_eject_probe:
                    # a FAILED readmission probe stays ejected for
                    # another cooldown (the breaker will handle the
                    # failure side on its own)
                    rep.ejected_at = time.monotonic()
            if ok and latency is not None:
                rep.lat_ewma = (latency if rep.lat_samples == 0
                                else (1 - self.LAT_ALPHA) * rep.lat_ewma
                                + self.LAT_ALPHA * latency)
                rep.lat_samples += 1
                median = self._peer_median_lat_locked(rep)
                if was_eject_probe:
                    if (median <= 0.0
                            or latency <= self.slow_eject_factor * median):
                        # the probe came back at fleet speed: readmit,
                        # and restart the EWMA from the probe (the old
                        # wedged-era average must not re-eject it)
                        rep.ejected = False
                        rep.lat_ewma = latency
                        rep.lat_samples = 1
                        readmitted = True
                    else:
                        rep.ejected_at = time.monotonic()
                elif (not rep.ejected
                      and self.slow_eject_factor > 0.0
                      and rep.lat_samples >= self.EJECT_MIN_SAMPLES
                      and median > 0.0
                      and rep.lat_ewma
                      > self.slow_eject_factor * median):
                    rep.ejected = True
                    rep.ejected_at = time.monotonic()
                    rep.eject_probe_inflight = False
                    ejected_now = True
            state = rep.breaker
            ewma = rep.lat_ewma
            is_ejected = rep.ejected
        fm = fleet_metrics()
        fm.breaker_open.set(rep.replica_id,
                            0.0 if state == BREAKER_CLOSED else 1.0)
        if latency is not None:
            fm.replica_latency.set(rep.replica_id, ewma)
        if ejected_now or readmitted:
            fm.ejected.set(rep.replica_id, 1.0 if is_ejected else 0.0)
        if ejected_now:
            fm.slow_ejections.inc()
            event("fleet.slow_eject", replica_id=rep.replica_id,
                  latency_ewma_ms=round(ewma * 1e3, 3))
        if readmitted:
            event("fleet.slow_readmit", replica_id=rep.replica_id,
                  probe_latency_ms=round(ewma * 1e3, 3))
        if tripped:
            fm.breaker_trips.inc()
            event("fleet.breaker_open", replica_id=rep.replica_id,
                  consecutive_failures=rep.consecutive_failures)

    # ------------------------------------------------------------- health
    def health_check(self, timeout: float = 2.0) -> None:
        """One pass over every lease-live replica's ``/healthz``:
        drain/stopped/unreachable replicas leave rotation, recovered
        ones rejoin, and the reported model hash is recorded (the
        rollout controller reads it).  Called from the router's
        background loop."""
        now = time.monotonic()
        with self._lock:
            targets = [(r.replica_id, r.url)
                       for r in self._replicas.values()
                       if r.lease_live(now)]
        for rid, url in targets:
            ok, state, mhash = self._probe(url, timeout)
            with self._lock:
                rep = self._replicas.get(rid)
                if rep is None or rep.url != url:
                    continue  # deregistered/re-registered mid-probe
                rep.health_ok = ok
                rep.health_state = state
                if mhash:
                    rep.model_hash = mhash
        from xgboost_tpu_torch.obs.metrics import fleet_metrics
        fleet_metrics().members.set(len(self.in_rotation()))

    @staticmethod
    def _probe(url: str, timeout: float):
        """GET /healthz -> (reachable_and_ok, state, model_hash)."""
        try:
            with urllib.request.urlopen(url + "/healthz",
                                        timeout=timeout) as resp:
                h = json.loads(resp.read())
            return True, h.get("state", "serving"), h.get("model_hash")
        except Exception as e:
            # unreachable is exactly the signal this probe exists to
            # turn into "out of rotation"; the reason rides along in
            # the recorded state for /fleet/members
            return False, f"unreachable ({type(e).__name__})", None


class LeaseClient:
    """Replica-side registration/heartbeat client (the worker half of
    the tracker protocol).  Runs a daemon thread that registers with
    the router, renews the lease at ``lease_sec / 3``, and
    RE-registers whenever the router forgot us (router restart, lease
    expiry during a stall) — the ``recover`` path.

    Chaos seams (reliability/faults.py): ``heartbeat_loss`` skips
    renewals (the lease decays and the router drops us from rotation);
    ``replica_kill`` fires ``on_kill`` — ``os._exit(43)`` in a real
    replica process, a server hard-stop in in-process tests."""

    def __init__(self, router_url: str, replica_id: str, self_url: str,
                 model_path: Optional[str] = None,
                 model_hash_fn: Optional[Callable[[], Optional[str]]] = None,
                 models_fn: Optional[Callable[[], dict]] = None,
                 device_fn: Optional[Callable[[], Optional[dict]]] = None,
                 on_kill: Optional[Callable[[], None]] = None):
        self.router_url = router_url.rstrip("/")
        self.replica_id = replica_id
        self.self_url = self_url.rstrip("/")
        self.model_path = model_path
        self.model_hash_fn = model_hash_fn or (lambda: None)
        # catalog advertisement: () -> {name: {"path":..., "hash":...}}
        # carried on register AND every heartbeat (rollouts move
        # hashes, placement deltas move whole entries)
        self.models_fn = models_fn or (lambda: None)
        # device budget advertisement: () -> {"budget_bytes":..,
        # "used_bytes":..} — the placer bin-packs against this
        self.device_fn = device_fn or (lambda: None)
        self.on_kill = on_kill or (lambda: os._exit(REPLICA_KILL_RC))
        self.lease_sec = 10.0
        self.registered = False
        self.heartbeats_sent = 0
        self.heartbeats_skipped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ protocol
    def _post(self, path: str, payload: dict, timeout: float = 3.0) -> dict:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.router_url + path, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def register(self) -> bool:
        """One registration attempt; returns success."""
        try:
            grant = self._post("/fleet/register", {
                "replica_id": self.replica_id,
                "url": self.self_url,
                "model_path": self.model_path,
                "model_hash": self.model_hash_fn(),
                "models": self.models_fn(),
                "device": self.device_fn(),
                "pid": os.getpid(),
            })
            self.lease_sec = float(grant.get("lease_sec", self.lease_sec))
            self.registered = True
            return True
        except Exception as e:
            # router down/unreachable: stay up and keep retrying — a
            # replica must serve direct traffic even with no router
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.lease_client.register", e)
            self.registered = False
            return False

    def _heartbeat_once(self) -> None:
        from xgboost_tpu_torch.reliability import faults
        faults.check("replica_kill", path=self.replica_id)
        try:
            faults.check("heartbeat_loss", path=self.replica_id)
        except faults.InjectedFault:
            # chaos: lose this renewal — the lease decays toward expiry
            self.heartbeats_skipped += 1
            return
        try:
            resp = self._post("/fleet/heartbeat",
                              {"replica_id": self.replica_id,
                               "model_hash": self.model_hash_fn(),
                               "models": self.models_fn(),
                               "device": self.device_fn()})
            self.heartbeats_sent += 1
            if not resp.get("known", True):
                # the router forgot us (restart / expired lease):
                # recover by re-registering
                self.register()
        except Exception as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.lease_client.heartbeat", e)
            self.registered = False

    def deregister(self) -> None:
        """Announce shutdown (the drain path calls this)."""
        try:
            self._post("/fleet/deregister",
                       {"replica_id": self.replica_id})
        except Exception as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.lease_client.deregister", e)
        self.registered = False

    # ----------------------------------------------------------- lifecycle
    def _loop(self) -> None:
        from xgboost_tpu_torch.reliability import faults
        from xgboost_tpu_torch.reliability.deadline import jittered
        # lease/3 nominal, ±20% jitter: a fleet restarted together must
        # not renew in lockstep forever (every heartbeat tick would be
        # a synchronized burst at the router)
        while not self._stop.wait(
                jittered(max(self.lease_sec / 3.0, 0.05))):
            try:
                if not self.registered:
                    self.register()
                else:
                    self._heartbeat_once()
            except faults.InjectedFault as f:
                if f.kind == "replica_kill":
                    # simulated sudden death: no drain, no deregister —
                    # the router must notice via lease/health alone
                    self.on_kill()
                    return

    def start(self) -> "LeaseClient":
        self.register()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="xgbtpu-fleet-lease")
        self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if deregister and self.registered:
            self.deregister()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None
