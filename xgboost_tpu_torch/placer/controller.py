"""Placement controller: observed load -> target assignment -> deltas
(port of ``xgboost_tpu/placer/controller.py``).  The budgets it packs
against are the replicas' advertised device bytes: on a GPU replica the
engines' CUDA-graph pools are most of them.

One control loop (SERVING.md "Autonomous placement"):

1. **Lease** — ``POST /placer/lease`` on the router grants a
   single-holder lease; a standby placer that is refused skips the
   tick.  The holder renews every tick, so holder death hands over
   within ``placer_lease_sec``.
2. **Observe** — the router's ``/metrics`` exposition yields per-tenant
   request counters (``xgbtpu_tenant_requests_total{model=}``, parsed
   by :func:`~xgboost_tpu_torch.fleet.rollout.scrape_labeled_samples`);
   counter deltas over the tick interval become per-tenant EWMA rates.
   ``/fleet/members`` yields the replica set, each replica's catalog
   advertisement, and its device budget (heartbeat payload).
3. **Plan** — greedy bin-pack, hottest tenant first: every managed
   tenant gets ``placer_replication`` hosts (``placer_hot_replication``
   once its load share reaches ``placer_hot_fraction``), existing
   assignments are kept wherever still valid (stickiness bounds
   remap), and NEW slots are anchored on the
   :class:`~xgboost_tpu_torch.fleet.membership.HashRing` over replica ids —
   so a fleet change moves only the tenants whose anchors moved, never
   a full reshuffle.  Device budgets are respected where possible; a
   tenant that fits nowhere is still placed (least-used replica) and
   flagged, because an over-budget replica degrades while an orphaned
   tenant hard-404s.
4. **Converge** — diff target against the fleet's ADVERTISED hosting
   and push manifest deltas: attach = ``POST /-/catalog {"add": ...}``
   then ``POST /-/reload?model=`` to warm; detach only once the model
   has enough OTHER in-rotation advertisers (a detach can never orphan
   a tenant).  The router's map follows within one heartbeat (the
   heartbeat-diff path in fleet/membership.py).
5. **Snapshot** — the target plan is written through
   ``atomic_write``+CRC on every change and restored on startup, so a
   SIGKILL'd placer resumes ITS OWN last plan instead of replanning
   from a cold load map; the plan is also recorded on the router
   (``POST /placer/plan``) for observability and takeover hand-off.

Every decision is an obs event (``placer.*``) and every tick a span.
"""

from __future__ import annotations

import json
import os
import socket
import time
import urllib.request
from typing import Dict, List, Optional

from xgboost_tpu_torch.fleet.membership import HashRing
from xgboost_tpu_torch.fleet.rollout import scrape_labeled_samples
from xgboost_tpu_torch.obs import event, span
from xgboost_tpu_torch.obs.metrics import placer_metrics, swallowed_error

#: the router-side counter family the load signal is scraped from
TENANT_LOAD_FAMILY = "xgbtpu_tenant_requests_total"


class PlacementController:
    """Drives one fleet router's catalog placement.

    ``manifest`` is the set of tenant models under management
    (name -> model file path, same shape as ``catalog=``); models
    OUTSIDE it (each replica's default, other operators' tenants) are
    never touched.  Call :meth:`tick` on a cadence (or use
    :func:`run_placer`); each tick is self-contained and idempotent —
    a converged fleet produces no pushes."""

    def __init__(self, router_url: str, manifest: Dict[str, str],
                 plan_path: str = "", placer_id: str = "",
                 tick_sec: float = 2.0, lease_sec: float = 10.0,
                 replication: int = 1, hot_replication: int = 2,
                 hot_fraction: float = 0.5, load_alpha: float = 0.3,
                 vnodes: int = 64, http_timeout: float = 5.0):
        self.router_url = router_url.rstrip("/")
        self.manifest = {str(k): str(v) for k, v in manifest.items()}
        self.plan_path = str(plan_path)
        self.placer_id = placer_id or f"{socket.gethostname()}:{os.getpid()}"
        self.tick_sec = float(tick_sec)
        self.lease_sec = float(lease_sec)
        self.replication = max(int(replication), 1)
        self.hot_replication = max(int(hot_replication), self.replication)
        self.hot_fraction = float(hot_fraction)
        self.load_alpha = float(load_alpha)
        self.http_timeout = float(http_timeout)
        self._ring = HashRing(vnodes)
        # per-tenant EWMA request rates (req/s) from counter deltas
        self.loads: Dict[str, float] = {}
        self._last_counts: Dict[str, float] = {}
        self._last_scrape = 0.0          # monotonic
        # the target assignment: tenant -> sorted replica ids
        self.target: Dict[str, List[str]] = {}
        self.plan_seq = 0
        self.metrics = placer_metrics()
        self.metrics.tenants.set(len(self.manifest))
        self._restore_plan()

    # --------------------------------------------------------------- http
    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.router_url + path,
                                    timeout=self.http_timeout) as r:
            return r.read()

    def _post_json(self, url: str, payload: dict) -> dict:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req,
                                    timeout=self.http_timeout) as r:
            return json.loads(r.read())

    # -------------------------------------------------------------- lease
    def _acquire_lease(self) -> bool:
        """Renew (or contend for) the router's single-holder placer
        lease; False = another placer is driving, stand by."""
        try:
            grant = self._post_json(self.router_url + "/placer/lease",
                                    {"placer_id": self.placer_id,
                                     "lease_sec": self.lease_sec})
            return bool(grant.get("granted"))
        except OSError as e:
            # router unreachable: nothing to place against this tick
            swallowed_error("placer.lease", e)
            return False

    # ------------------------------------------------------------ observe
    def observe_load(self) -> Dict[str, float]:
        """Fold the router's per-tenant request counters into the EWMA
        rate map.  Counter RESETS (router restart) clamp the delta at
        zero instead of going negative."""
        text = self._get("/metrics").decode("utf-8", "replace")
        counts = scrape_labeled_samples(text, TENANT_LOAD_FAMILY)
        now = time.monotonic()
        dt = now - self._last_scrape if self._last_scrape else 0.0
        for t in self.manifest:
            c = counts.get(t, 0.0)
            prev = self._last_counts.get(t)
            if prev is not None and dt > 0:
                rate = max(c - prev, 0.0) / dt
                if t in self.loads:
                    self.loads[t] += self.load_alpha * (rate
                                                        - self.loads[t])
                else:
                    self.loads[t] = rate
            self._last_counts[t] = c
        self._last_scrape = now
        return dict(self.loads)

    # --------------------------------------------------------------- plan
    @staticmethod
    def _replica_map(members: dict) -> Dict[str, dict]:
        return {d["replica_id"]: d for d in members.get("replicas", [])
                if d.get("in_rotation")}

    def _model_cost(self, tenant: str, reps: Dict[str, dict]) -> int:
        """Device-byte cost of placing ``tenant``: the largest live
        advertisement wins (a resident engine's real footprint).  A cold
        tenant costs its file size or, when larger, the largest bytes
        any replica advertises for one model: on a GPU replica an
        engine's footprint is its CUDA-graph pools (one a row bucket:
        266-274 MiB for the 8-8192 ladder on an H100 80GB HBM3 at 700
        W, ``chip_smoke.py`` ``[serve]``), which the file's size says
        nothing of.  The JAX package costs a cold tenant by its
        file size alone, so the two plans differ only for cold tenants
        beside smaller files."""
        best = 0
        for d in reps.values():
            adv = (d.get("models_detail") or {}).get(tenant) or {}
            best = max(best, int(adv.get("bytes") or 0))
        if best:
            return best
        engine = max((int((adv or {}).get("bytes") or 0)
                      for d in reps.values()
                      for adv in (d.get("models_detail") or {}).values()),
                     default=0)
        try:
            return max(os.path.getsize(self.manifest[tenant]), engine)
        except OSError:
            return engine

    def plan(self, members: dict) -> Dict[str, List[str]]:
        """Compute the target assignment for the current fleet + load.

        Deterministic in its inputs (same members, loads, and previous
        target -> same plan), which is what makes the chaos cell's
        "resumed placer converges to the same target" assertion
        meaningful."""
        reps = self._replica_map(members)
        rids = sorted(reps)
        if not rids:
            return {t: list(v) for t, v in self.target.items()}
        self._ring.rebuild(rids)
        budget = {r: int((reps[r].get("device") or {})
                         .get("budget_bytes") or 0) for r in rids}
        # usage baseline: bytes already resident for models OUTSIDE the
        # managed manifest (each replica's default model etc.)
        usage = {}
        for r in rids:
            usage[r] = sum(
                int((adv or {}).get("bytes") or 0)
                for m, adv in (reps[r].get("models_detail") or {}).items()
                if m not in self.manifest)
        total = sum(self.loads.get(t, 0.0) for t in self.manifest)
        order = sorted(self.manifest,
                       key=lambda t: (-self.loads.get(t, 0.0), t))
        target: Dict[str, List[str]] = {}
        for t in order:
            share = (self.loads.get(t, 0.0) / total) if total > 0 else 0.0
            floor = (self.hot_replication if share >= self.hot_fraction
                     else self.replication)
            floor = min(max(floor, 1), len(rids))
            cost = self._model_cost(t, reps)

            def fits(r: str) -> bool:
                return (budget[r] == 0
                        or usage[r] + cost <= budget[r]
                        or t in (reps[r].get("models") or []))

            chosen: List[str] = []
            # stickiness first: keep every still-valid assignment (this
            # is what bounds remap — a load shift on tenant X never
            # moves tenant Y's hosts)
            for r in self.target.get(t, []):
                if r in reps and len(chosen) < floor and fits(r):
                    chosen.append(r)
                    usage[r] += cost
            # new slots anchor on the ring: stable for a fixed replica
            # set, and a replica death moves only ITS tenants to their
            # ring successors
            slot = 0
            while len(chosen) < floor and slot < floor + len(rids):
                eligible = [r for r in rids
                            if r not in chosen and fits(r)]
                if not eligible:
                    # nothing fits: least-used replica takes it anyway
                    # (over budget beats orphaned), flagged for the
                    # operator
                    spill = [r for r in rids if r not in chosen]
                    if not spill:
                        break
                    pick = min(spill, key=lambda r: (usage[r], r))
                    event("placer.over_budget", model=t, replica=pick,
                          cost_bytes=cost, budget_bytes=budget[pick])
                else:
                    pick = self._ring.route(f"{t}#{slot}", set(eligible))
                    if pick is None:
                        pick = eligible[0]
                chosen.append(pick)
                usage[pick] += cost
                slot += 1
            target[t] = sorted(chosen)
        return target

    # ----------------------------------------------------------- converge
    def converge(self, members: dict) -> dict:
        """Push the deltas between the target assignment and what the
        fleet currently ADVERTISES.  Detach is orphan-safe: a replica
        sheds a tenant only while enough other in-rotation replicas
        advertise it."""
        reps = self._replica_map(members)
        pushed = {"attach": 0, "detach": 0, "errors": 0}
        advertisers = {t: {r for r, d in reps.items()
                           if t in (d.get("models") or [])}
                       for t in self.manifest}
        for t, want in sorted(self.target.items()):
            if t not in self.manifest:
                continue
            have = advertisers.get(t, set())
            for r in want:
                if r in reps and r not in have:
                    self.metrics.moves.inc("attach")
                    if self._push_attach(reps[r], t):
                        pushed["attach"] += 1
                    else:
                        pushed["errors"] += 1
            keep = len(have & set(want))
            for r in sorted(have - set(want)):
                # never shed below the number of target hosts that
                # already advertise: the LAST copy moves only after its
                # replacement is up
                if keep < max(len(want), 1):
                    break
                self.metrics.moves.inc("detach")
                if self._push_detach(reps[r], t):
                    pushed["detach"] += 1
                else:
                    pushed["errors"] += 1
        placed = sum(1 for t in self.manifest if advertisers.get(t))
        self.metrics.tenants.set(len(self.manifest))
        self.metrics.tenants_placed.set(placed)
        converged = (pushed["attach"] == 0 and pushed["detach"] == 0
                     and pushed["errors"] == 0
                     and all(set(self.target.get(t, []))
                             <= advertisers.get(t, set())
                             for t in self.manifest))
        self.metrics.converged.set(1.0 if converged else 0.0)
        pushed["converged"] = converged
        return pushed

    def _push_attach(self, rep: dict, tenant: str) -> bool:
        self.metrics.pushes.inc()
        url = rep["url"]
        try:
            with span("placer.push", replica=rep["replica_id"],
                      model=tenant, kind="attach"):
                self._post_json(url + "/-/catalog",
                                {"add": {tenant: self.manifest[tenant]}})
                # warm eagerly: the first tenant request should not pay
                # the admission build (path is per-tenant, so reload is
                # scoped); lazy admission is the fallback on failure
                self._post_json(f"{url}/-/reload?model={tenant}", {})
            event("placer.attach", replica=rep["replica_id"],
                  model=tenant)
            return True
        except OSError as e:
            self.metrics.push_errors.inc()
            event("placer.push_error", replica=rep["replica_id"],
                  model=tenant, kind="attach",
                  error=f"{type(e).__name__}: {e}")
            return False

    def _push_detach(self, rep: dict, tenant: str) -> bool:
        self.metrics.pushes.inc()
        try:
            with span("placer.push", replica=rep["replica_id"],
                      model=tenant, kind="detach"):
                self._post_json(rep["url"] + "/-/catalog",
                                {"remove": [tenant]})
            event("placer.detach", replica=rep["replica_id"],
                  model=tenant)
            return True
        except OSError as e:
            self.metrics.push_errors.inc()
            event("placer.push_error", replica=rep["replica_id"],
                  model=tenant, kind="detach",
                  error=f"{type(e).__name__}: {e}")
            return False

    # ----------------------------------------------------------- snapshot
    def _snapshot_plan(self) -> None:
        """Persist the target plan (atomic, fsync'd, CRC-footered like
        every durable artifact) so a SIGKILL'd placer resumes exactly
        this assignment.  Best-effort: a full disk must not stop
        placement."""
        if not self.plan_path:
            return
        from xgboost_tpu_torch.reliability.integrity import (add_footer,
                                                       atomic_write)
        payload = json.dumps({"seq": self.plan_seq,
                              "target": self.target,
                              "manifest": self.manifest},
                             sort_keys=True).encode()
        try:
            atomic_write(self.plan_path, add_footer(payload))
        except OSError as e:
            swallowed_error("placer.snapshot_plan", e)

    def _restore_plan(self) -> None:
        if not self.plan_path or not os.path.exists(self.plan_path):
            return
        try:
            from xgboost_tpu_torch.reliability.integrity import \
                verify_model_bytes
            with open(self.plan_path, "rb") as f:
                state = json.loads(verify_model_bytes(f.read(),
                                                      self.plan_path))
            self.target = {str(t): [str(r) for r in rs]
                           for t, rs in state.get("target", {}).items()
                           if str(t) in self.manifest}
            self.plan_seq = int(state.get("seq", 0))
            event("placer.resume", seq=self.plan_seq,
                  tenants=len(self.target), plan_path=self.plan_path)
        except Exception as e:
            # corrupt/stale snapshot: replan from scratch — the greedy
            # pack is deterministic, so a cold start still converges
            swallowed_error("placer.restore_plan", e)

    def _record_plan(self) -> None:
        """Mirror the plan onto the router (observability + takeover);
        best-effort — the CRC snapshot is the durable copy."""
        try:
            self._post_json(self.router_url + "/placer/plan",
                            {"placer_id": self.placer_id,
                             "plan": {"seq": self.plan_seq,
                                      "target": self.target}})
        except OSError as e:
            swallowed_error("placer.record_plan", e)

    # ---------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One full control-loop iteration; returns a report dict."""
        if not self._acquire_lease():
            self.metrics.standby_ticks.inc()
            return {"standby": True}
        self.metrics.ticks.inc()
        with span("placer.tick", placer_id=self.placer_id):
            try:
                members = json.loads(self._get("/fleet/members"))
                self.observe_load()
            except (OSError, ValueError) as e:
                swallowed_error("placer.observe", e)
                return {"standby": False, "error": str(e)}
            target = self.plan(members)
            if target != self.target:
                self.target = target
                self.plan_seq += 1
                self.metrics.plans.inc()
                event("placer.plan", seq=self.plan_seq,
                      target={t: list(v) for t, v in target.items()})
                self._snapshot_plan()
            self._record_plan()
            report = self.converge(members)
        report["standby"] = False
        report["seq"] = self.plan_seq
        return report


def run_placer(router_url: str, manifest: Dict[str, str],
               supervisor: Optional[object] = None,
               block: bool = True, **kwargs) -> PlacementController:
    """CLI entry (``task=placer``): run the placement loop until
    SIGTERM/Ctrl-C.  ``supervisor`` (an
    :class:`~xgboost_tpu_torch.placer.elastic.ElasticSupervisor`) ticks on
    the same cadence when given.  ``block=False`` returns the built
    controller without looping (tests drive ticks by hand)."""
    from xgboost_tpu_torch.reliability.deadline import jittered
    ctl = PlacementController(router_url, manifest, **kwargs)
    if not block:
        return ctl
    import signal as _signal
    stop: List[int] = []
    try:
        _signal.signal(_signal.SIGTERM, lambda *_: stop.append(1))
    except ValueError:
        pass  # non-main thread: rely on KeyboardInterrupt/stop()
    try:
        while not stop:
            ctl.tick()
            if supervisor is not None:
                supervisor.tick()
            time.sleep(jittered(max(ctl.tick_sec, 0.05)))
    except KeyboardInterrupt:
        pass
    return ctl
