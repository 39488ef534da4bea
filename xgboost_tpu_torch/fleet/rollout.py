"""Staged canary model rollout across the fleet, keyed by content hash
(port of ``xgboost_tpu/fleet/rollout.py``).

The fleet-wide analog of the single-replica hot-reload protocol
(serving/registry.py): a new model is pushed to a FEW canary replicas
first, the canaries soak under live traffic, a gate reads their error
rate and latency from their own ``/metrics``, and only a passing gate
rolls the remaining replicas.  Every step verifies what a replica
ACTUALLY serves via the ``model_hash`` its ``/healthz`` reports
(ModelRegistry content hashes — not what the controller *hopes* it
pushed), and one command rolls the whole fleet back instantly.

Push mechanics: each replica registered a ``model_path`` (the file its
registry watches); the controller atomically rewrites that file
(reliability.integrity.atomic_write — a crash mid-push tears nothing)
and forces ``POST /-/reload``.  Rollback is the instant engine-ring
swap (``POST /-/rollback``, no disk I/O) plus restoration of the
previous file bytes, so a later replica restart comes back on the
rolled-back model, not the bad push.

Replicas sharing one model file (a fleet launched off a single path)
are pushed as one unit: the canary set closes over path groups, so a
"canary" file write can never leak into uncanaried replicas through
their reload pollers.
"""

from __future__ import annotations

import hashlib
import json
import re
import time
from typing import Callable, Dict, List, Optional

from xgboost_tpu_torch.obs import event
from xgboost_tpu_torch.obs.metrics import fleet_metrics
from xgboost_tpu_torch.fleet.membership import Membership, Replica

# metric names the gate reads from a canary's /metrics exposition.
# The value class must admit a '-' ANYWHERE, not just leading: repr()
# renders small floats in e-notation ("9.5e-05") and dropping those
# would feed the gate a silent 0.0; float() below is the real parser.
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{[^}]*\})? "
                        r"([-+0-9.eEnaif]+)$")


def scrape_samples(text: str) -> Dict[str, float]:
    """Parse unlabeled samples (``name value``) out of a Prometheus
    text exposition; labeled samples are skipped (the gate reads plain
    counters/gauges only)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line.strip())
        if m and "{" not in line.split(" ", 1)[0]:
            try:
                out[m.group(1)] = float(m.group(2))
            except ValueError:
                continue
    return out


# one-label samples (name{label="value"} value) — the shape every
# LabeledCounter/LabeledGauge in obs/metrics.py renders
_LABELED_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)\{([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"\} '
    r"([-+0-9.eEnaif]+)$")


def scrape_labeled_samples(text: str, family: str
                           ) -> Dict[str, float]:
    """Parse the single-label samples of one metric ``family`` out of a
    Prometheus text exposition: label value -> sample value.  The
    placer reads per-tenant load this way
    (``xgbtpu_tenant_requests_total{model="a"} 42`` -> ``{"a": 42.0}``);
    :func:`scrape_samples` deliberately skips labeled samples, so this
    is its labeled counterpart rather than a change to the gate's
    parser."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _LABELED_RE.match(line.strip())
        if m and m.group(1) == family:
            try:
                out[m.group(3)] = float(m.group(4))
            except ValueError:
                continue
    return out


class RolloutController:
    """Drives staged rollouts over a :class:`Membership` using the
    router's forward function (``(rep, method, path_qs, body, headers)
    -> (status, headers, body)``)."""

    def __init__(self, membership: Membership, forward: Callable,
                 state: Optional[dict] = None):
        self.membership = membership
        self.forward = forward
        # backups of replaced model files (path -> previous bytes),
        # shared across controller instances via the router's state
        # dict so an operator rollback can restore files pushed by an
        # earlier rollout request
        self.state = state if state is not None else {}

    # ------------------------------------------------------------ plumbing
    def _call(self, rep: Replica, method: str, path: str,
              payload: Optional[dict] = None) -> Optional[dict]:
        """One control-plane call to a replica; None = unreachable."""
        body = json.dumps(payload).encode() if payload is not None else b""
        try:
            status, _, out = self.forward(rep, method, path, body,
                                          {"Content-Type":
                                           "application/json"})
        except Exception as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.rollout.call", e)
            return None
        if status >= 400:
            return None
        try:
            return json.loads(out)
        except ValueError:
            return None

    @staticmethod
    def _model_path(rep: Replica, model: str = "") -> Optional[str]:
        """The file to rewrite on ``rep`` for this rollout: its bare
        registered path, or — for a named tenant — the path its catalog
        advertisement maps the model to."""
        if not model:
            return rep.model_path
        return (rep.models.get(model) or {}).get("path")

    @staticmethod
    def _admin_path(path: str, model: str = "") -> str:
        return f"{path}?model={model}" if model else path

    def _served_hash(self, rep: Replica, model: str = "") -> Optional[str]:
        """What the replica ACTUALLY serves: the top-level hash, or —
        for a named tenant — its row in /healthz ``models`` (per-model
        content hashes, serving/http.py)."""
        h = self._call(rep, "GET", "/healthz")
        if h is None:
            return None
        if not model:
            return h.get("model_hash")
        return (h.get("models", {}).get(model) or {}).get("model_hash")

    def _metrics_snapshot(self, rep: Replica) -> Optional[Dict[str, float]]:
        try:
            status, _, out = self.forward(rep, "GET", "/metrics", b"", {})
        except Exception as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.rollout.scrape", e)
            return None
        if status != 200:
            return None
        return scrape_samples(out.decode("utf-8", "replace"))

    # ---------------------------------------------------------------- push
    def _push(self, rep: Replica, raw: bytes, expect_hash: str,
              model: str = "") -> dict:
        """Write + force-reload + verify one replica (one tenant's
        path/reload/hash when ``model`` names one).  Returns a
        per-replica report entry."""
        from xgboost_tpu_torch.reliability.integrity import atomic_write
        path = self._model_path(rep, model)
        entry = {"replica_id": rep.replica_id, "path": path}
        if model:
            entry["model"] = model
        if not path:
            entry["result"] = (f"model {model!r} not hosted" if model
                               else "no model_path registered")
            return entry
        try:
            atomic_write(path, raw)
        except OSError as e:
            entry["result"] = f"write failed: {e}"
            return entry
        resp = self._call(rep, "POST",
                          self._admin_path("/-/reload", model))
        if resp is None:
            entry["result"] = "reload unreachable"
            return entry
        got = self._served_hash(rep, model)
        entry["served_hash"] = got
        entry["result"] = ("ok" if got == expect_hash
                           else f"hash mismatch (serves {got})")
        return entry

    def _unpush(self, rep: Replica, model: str = "") -> dict:
        """Instant engine rollback + file restore for one replica
        (scoped to one tenant's registry when ``model`` names one —
        the other tenants' engines and files are untouched)."""
        from xgboost_tpu_torch.reliability.integrity import atomic_write
        entry = {"replica_id": rep.replica_id}
        if model:
            entry["model"] = model
        resp = self._call(rep, "POST",
                          self._admin_path("/-/rollback", model))
        entry["engine_rollback"] = bool(resp and resp.get("rolled_back"))
        path = self._model_path(rep, model)
        backup = self.state.get(path)
        if backup is not None:
            try:
                atomic_write(path, backup)
                entry["file_restored"] = True
            except OSError as e:
                entry["file_restored"] = f"failed: {e}"
        return entry

    # ---------------------------------------------------------------- gate
    def _gate(self, rep: Replica, before: Optional[Dict[str, float]],
              gate_error_rate: float, gate_p99_ms: float) -> dict:
        """Read one canary's own /metrics and judge it.  An unreachable
        canary FAILS the gate — a rollout must not proceed past a
        replica it cannot observe (the chaos-killed-canary case) — and
        so does one that is no longer in the ``serving`` state (killed
        or draining mid-soak: its metrics may still answer over a
        lingering keep-alive connection, but it is not a canary
        anymore)."""
        h = self._call(rep, "GET", "/healthz")
        if h is None or h.get("state") != "serving":
            return {"replica_id": rep.replica_id, "pass": False,
                    "reason": "canary unreachable or not serving "
                              f"(state {h.get('state') if h else None!r})"}
        after = self._metrics_snapshot(rep)
        if after is None or before is None:
            return {"replica_id": rep.replica_id, "pass": False,
                    "reason": "canary metrics unreachable"}
        d_req = (after.get("xgbtpu_serving_requests_total", 0.0)
                 - before.get("xgbtpu_serving_requests_total", 0.0))
        d_err = (after.get("xgbtpu_serving_errors_total", 0.0)
                 - before.get("xgbtpu_serving_errors_total", 0.0))
        err_rate = d_err / d_req if d_req > 0 else 0.0
        p99_ms = after.get("xgbtpu_serving_latency_p99_seconds", 0.0) * 1e3
        verdict = {"replica_id": rep.replica_id,
                   "soak_requests": d_req, "soak_errors": d_err,
                   "error_rate": round(err_rate, 6),
                   "p99_ms": round(p99_ms, 3)}
        if err_rate > gate_error_rate:
            verdict["pass"] = False
            verdict["reason"] = (f"error rate {err_rate:.4f} > "
                                 f"gate {gate_error_rate}")
        elif p99_ms > gate_p99_ms:
            verdict["pass"] = False
            verdict["reason"] = f"p99 {p99_ms:.1f}ms > gate {gate_p99_ms}ms"
        else:
            verdict["pass"] = True
        return verdict

    # -------------------------------------------------------------- public
    def rollout(self, model_path: str, canaries: int = 1,
                soak_sec: float = 3.0, gate_error_rate: float = 0.02,
                gate_p99_ms: float = 250.0, model: str = "") -> dict:
        """One staged rollout of the model file at ``model_path``.

        Stages: verify bytes -> push to ``canaries`` path-groups ->
        soak ``soak_sec`` under whatever traffic the router is carrying
        -> gate on the canaries' own error-rate/latency metrics ->
        fleet-wide push, or rollback of the canaries.  Returns a full
        report (also kept on ``GET /fleet/rollout``).

        When ``model`` names a catalog tenant the rollout is scoped to
        that tenant's lane: only replicas advertising the model are
        touched, each replica's file target is its OWN advertised path
        for that model, and push/gate/rollback leave every other
        tenant's engines, files, and backups untouched."""
        from xgboost_tpu_torch.reliability.integrity import (read_file,
                                                       verify_model_bytes)
        raw = read_file(model_path)
        verify_model_bytes(raw, name=model_path)  # never push torn bytes
        expect = hashlib.sha256(raw).hexdigest()
        report: dict = {"model_path": model_path, "model_hash": expect,
                        "started_ts": round(time.time(), 3)}
        if model:
            report["model"] = model
        members = sorted(self.membership.in_rotation(),
                         key=lambda r: r.replica_id)
        if model:
            members = [r for r in members
                       if self._model_path(r, model)]
            if not members:
                report.update(status="error",
                              error=f"no replica in rotation hosts "
                                    f"model {model!r}")
                return report
        if not members:
            report.update(status="error", error="no replicas in rotation")
            return report
        # canary selection closes over model-path groups (replicas
        # sharing a file reload together whether we like it or not)
        canaries = max(1, int(canaries))
        canary_set: List[Replica] = []
        canary_paths = set()
        for rep in members:
            path = self._model_path(rep, model)
            if len(canary_set) < canaries or path in canary_paths:
                canary_set.append(rep)
                canary_paths.add(path)
        rest = [r for r in members if r not in canary_set
                and self._model_path(r, model) not in canary_paths]
        report["canaries"] = [r.replica_id for r in canary_set]
        event("fleet.rollout_start", model_hash=expect,
              canaries=report["canaries"], model=model or None)

        # refresh the rollback backups for THIS rollout, before any
        # file is touched: a backup taken only on first-ever push would
        # go stale after one successful rollout, and a later rollback
        # would restore the pre-FIRST-rollout bytes — the engine ring
        # pops to version N-1 while the file (and the poller) goes to
        # N-2, silently splitting the fleet
        for path in {self._model_path(r, model) for r in members}:
            if not path:
                continue
            try:
                self.state[path] = read_file(path)
            except OSError as e:
                from xgboost_tpu_torch.obs.metrics import swallowed_error
                swallowed_error("fleet.rollout.backup", e)
                self.state.pop(path, None)  # never restore stale bytes

        before = {r.replica_id: self._metrics_snapshot(r)
                  for r in canary_set}
        pushes = [self._push(r, raw, expect, model=model)
                  for r in canary_set]
        report["canary_push"] = pushes
        failed_push = [p for p in pushes if p.get("result") != "ok"]
        if not failed_push and soak_sec > 0:
            time.sleep(soak_sec)
        verdicts = ([] if failed_push else
                    [self._gate(r, before[r.replica_id],
                                gate_error_rate, gate_p99_ms)
                     for r in canary_set])
        report["canary_gate"] = verdicts
        if failed_push or not all(v["pass"] for v in verdicts):
            report["rollback"] = [self._unpush(r, model=model)
                                  for r in canary_set]
            report["status"] = "rolled_back"
            report["reason"] = (failed_push[0]["result"] if failed_push
                                else next(v["reason"] for v in verdicts
                                          if not v["pass"]))
            fleet_metrics().rollbacks.inc()
            event("fleet.rollout_rolled_back", model_hash=expect,
                  reason=report["reason"], model=model or None)
            return report

        report["fleet_push"] = [self._push(r, raw, expect, model=model)
                                for r in rest]
        bad = [p for p in report["fleet_push"] if p.get("result") != "ok"]
        report["status"] = "ok" if not bad else "partial"
        report["serving_hash"] = expect
        fleet_metrics().rollouts.inc()
        event("fleet.rollout_done", model_hash=expect,
              status=report["status"], model=model or None)
        return report

    def rollback(self, model: str = "") -> dict:
        """The one-command fleet rollback: every registered replica
        swaps its previous engine back in (instant, no disk) and any
        file this controller's state pushed is restored.  With
        ``model`` the sweep is scoped to replicas hosting that tenant
        and only its registry/file are rolled back."""
        reps = [self.membership.get(rid) for rid in self.membership.ids()]
        if model:
            reps = [r for r in reps
                    if r is not None and self._model_path(r, model)]
        entries = [self._unpush(r, model=model)
                   for r in reps if r is not None]
        fleet_metrics().rollbacks.inc()
        event("fleet.rollback", replicas=len(entries), model=model or None)
        out = {"status": "rolled_back", "replicas": entries}
        if model:
            out["model"] = model
        return out
