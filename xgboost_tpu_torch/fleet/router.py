"""Fleet router: the HTTP front door over a pool of serving replicas
(port of ``xgboost_tpu/fleet/router.py``, the same routes, JSON bodies
and metric names, so replicas of either package work under a router of
either package).  The router does no device work: its replicas are
``PredictServer``s, each on its own CUDA device or sharing one.

The scale step past one `PredictServer` process (SERVING.md fleet
section): N shared-nothing replicas register with this router
(fleet/membership.py, the tracker analog) and clients talk to ONE
endpoint that speaks the same API the replicas do:

- ``POST /predict`` — **least-loaded** dispatch (fewest outstanding
  router requests) over in-rotation replicas; a failed dispatch
  (connect error / 5xx / replica draining) is retried ONCE on a
  different healthy replica — predictions are idempotent, so the retry
  is safe and a rolling restart or replica kill costs zero client
  failures.
- ``POST /predict_by_id`` / ``POST /featurestore/put`` /
  ``/featurestore/invalidate`` — **consistent-hash** dispatch on
  entity id (fleet/membership.py HashRing): an entity's feature row is
  ``put`` to, and served from, the same replica across requests, so
  device-resident feature-store residency CONCENTRATES per replica
  instead of diluting N ways.  Requests spanning owners are split and
  the responses merged in input order.
- **admission control** — a global in-flight budget
  (``fleet_inflight``); requests past it are shed with 503 before any
  replica work (``xgbtpu_fleet_shed_total``), the router-level
  reject-don't-buffer stance.
- **circuit breakers** — per replica, consecutive-failure trip with a
  half-open probe after cooldown (state machine in
  fleet/membership.py; ``xgbtpu_fleet_breaker_*``).
- **tracing** — the client's ``X-Request-Id`` (or a generated one)
  becomes the trace id of a ``router.request`` span AND is forwarded
  to the replica, whose ``serve.request`` span lands under the same
  trace: one id correlates client log, router timeline, and replica
  timeline.

Admin surface: ``/fleet/register|heartbeat|deregister`` (the replica
protocol), ``GET /fleet/members``, ``POST /fleet/rollout`` /
``/fleet/rollback`` (fleet/rollout.py), ``GET /healthz``,
``GET /metrics``.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from xgboost_tpu_torch.obs import span, trace, trace_context
from xgboost_tpu_torch.obs.metrics import fleet_metrics
from xgboost_tpu_torch.obs.server import PROM_CONTENT_TYPE
from xgboost_tpu_torch.fleet.membership import Membership, Replica
from xgboost_tpu_torch.reliability.deadline import (DEADLINE_HEADER, Deadline,
                                              DeadlineExceeded,
                                              backoff_delay, jittered)


class ForwardError(RuntimeError):
    """A dispatch to one replica failed (connect/read error or a
    retryable status); carries the replica id for breaker accounting."""

    def __init__(self, replica_id: str, detail: str,
                 status: Optional[int] = None):
        super().__init__(f"replica {replica_id}: {detail}")
        self.replica_id = replica_id
        self.status = status


class _ConnPool:
    """Tiny keep-alive connection pool, keyed by replica base URL.
    Idle connections are reused (loopback TCP connect costs more than
    the forward itself at fleet request rates); errored connections are
    closed, never returned."""

    def __init__(self, timeout: float = 30.0, max_idle: int = 8):
        self.timeout = float(timeout)
        self.max_idle = int(max_idle)
        self._idle: Dict[str, List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    def acquire(self, url: str) -> http.client.HTTPConnection:
        with self._lock:
            conns = self._idle.get(url)
            if conns:
                return conns.pop()
        p = urlparse(url)
        return http.client.HTTPConnection(p.hostname, p.port,
                                          timeout=self.timeout)

    def release(self, url: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            conns = self._idle.setdefault(url, [])
            if len(conns) < self.max_idle:
                conns.append(conn)
                return
        conn.close()

    def prune(self, live_urls) -> None:
        """Close idle connections to URLs no longer registered —
        replicas bind ephemeral ports, so every restart is a NEW url
        and the old one's sockets would otherwise accumulate forever
        (fd exhaustion under long replica churn)."""
        with self._lock:
            dead = [u for u in self._idle if u not in live_urls]
            conns = [c for u in dead for c in self._idle.pop(u)]
        for c in conns:
            c.close()

    def close(self) -> None:
        with self._lock:
            conns = [c for lst in self._idle.values() for c in lst]
            self._idle.clear()
        for c in conns:
            c.close()


# response headers worth passing through from a replica (hop-by-hop
# headers like Connection/Keep-Alive must NOT cross the proxy)
_PASS_HEADERS = ("Content-Type",)


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # same Nagle/delayed-ACK stall fix as the replica handler
    # (serving/http.py): without it every hop adds a flat ~40 ms
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        if not self.server.quiet:
            super().log_message(fmt, *args)

    # --------------------------------------------------------------- util
    def _send(self, code: int, body: bytes,
              content_type: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        rid = getattr(self, "_request_id", None)
        if rid is not None:
            self.send_header("X-Request-Id", rid)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    def _read_body(self) -> Optional[bytes]:
        """Drain the request body — THE shared keep-alive hygiene
        (serving/http.py read_request_body); None = an error response
        was already sent."""
        from xgboost_tpu_torch.serving.http import read_request_body
        return read_request_body(self, self.server.router.max_body_bytes)

    # ---------------------------------------------------------------- GET
    def do_GET(self):
        self._request_id = None
        rt: FleetRouter = self.server.router
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._send_json(200, rt.health())
            return
        if url.path == "/metrics":
            from xgboost_tpu_torch.obs.metrics import registry
            self._send(200, registry().render().encode(),
                       PROM_CONTENT_TYPE)
            return
        if url.path == "/fleet/members":
            self._send_json(200, rt.membership.describe())
            return
        if url.path == "/fleet/rollout":
            self._send_json(200, rt.rollout_status())
            return
        if url.path == "/placer/status":
            self._send_json(200, rt.placer_status())
            return
        self._send_json(404, {"error": f"no route {url.path}"})

    # --------------------------------------------------------------- POST
    def do_POST(self):
        self._request_id = None
        rt: FleetRouter = self.server.router
        url = urlparse(self.path)
        body = self._read_body()
        if body is None:
            return
        if url.path == "/predict":
            self._proxy_predict(url, body)
            return
        if url.path in ("/predict_by_id", "/featurestore/put",
                        "/featurestore/invalidate"):
            self._proxy_by_id(url, body)
            return
        if url.path == "/fleet/register":
            self._fleet_register(body)
            return
        if url.path == "/fleet/heartbeat":
            self._fleet_heartbeat(body)
            return
        if url.path == "/fleet/deregister":
            self._fleet_deregister(body)
            return
        if url.path == "/fleet/rollout":
            self._fleet_rollout(body)
            return
        if url.path == "/fleet/rollback":
            self._fleet_rollback(body)
            return
        if url.path == "/placer/lease":
            self._placer_lease(body)
            return
        if url.path == "/placer/plan":
            self._placer_plan(body)
            return
        self._send_json(404, {"error": f"no route {url.path}"})

    # ----------------------------------------------------- replica protocol
    def _fleet_register(self, body: bytes) -> None:
        try:
            req = json.loads(body)
            rid, rurl = str(req["replica_id"]), str(req["url"])
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        grant = self.server.router.membership.register(
            rid, rurl, model_path=req.get("model_path"),
            model_hash=req.get("model_hash"), pid=req.get("pid"),
            models=req.get("models"), device=req.get("device"))
        self.server.router.save_state()
        self._send_json(200, grant)

    def _fleet_heartbeat(self, body: bytes) -> None:
        try:
            req = json.loads(body)
            rid = str(req["replica_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        known = self.server.router.membership.heartbeat(
            rid, model_hash=req.get("model_hash"),
            models=req.get("models"), device=req.get("device"))
        # 200 either way: "known": false tells the client to re-register
        # (the tracker recover path) without an error-path round trip
        self._send_json(200, {"known": known})

    def _fleet_deregister(self, body: bytes) -> None:
        try:
            req = json.loads(body)
            rid = str(req["replica_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        removed = self.server.router.membership.deregister(rid)
        self.server.router.save_state()
        self._send_json(200, {"removed": removed})

    # -------------------------------------------------------------- placer
    def _placer_lease(self, body: bytes) -> None:
        try:
            req = json.loads(body)
            placer_id = str(req["placer_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        self._send_json(200, self.server.router.placer_acquire(
            placer_id, lease_sec=req.get("lease_sec")))

    def _placer_plan(self, body: bytes) -> None:
        try:
            req = json.loads(body)
            placer_id = str(req["placer_id"])
            plan = dict(req["plan"])
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        code, resp = self.server.router.placer_record_plan(
            placer_id, plan)
        self._send_json(code, resp)

    # ------------------------------------------------------------- rollout
    def _fleet_rollout(self, body: bytes) -> None:
        try:
            req = json.loads(body) if body.strip() else {}
            model_path = req["model_path"]
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        code, report = self.server.router.run_rollout(model_path, req)
        self._send_json(code, report)

    def _fleet_rollback(self, body: bytes) -> None:
        try:
            req = json.loads(body) if body.strip() else {}
        except ValueError as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        code, report = self.server.router.run_rollback(
            model=str(req.get("model", "")))
        self._send_json(code, report)

    # ------------------------------------------------------------ proxying
    def _proxy_predict(self, url, body: bytes) -> None:
        rt: FleetRouter = self.server.router
        self._proxy(url, body,
                    lambda path_qs, hdrs, sp, dl, model: rt.dispatch(
                        "POST", path_qs, body, hdrs, sp, deadline=dl,
                        model=model))

    def _proxy_by_id(self, url, body: bytes) -> None:
        rt: FleetRouter = self.server.router
        self._proxy(url, body,
                    lambda path_qs, hdrs, sp, dl, model: rt.dispatch_by_id(
                        url.path, path_qs, body, hdrs, sp, deadline=dl,
                        model=model))

    def _proxy(self, url, body: bytes, dispatch_fn) -> None:
        """THE proxy shell shared by every forwarded route: admission
        (per-tenant quota shed -> 429/503, budget shed -> 503, expired
        deadline -> 504), the router.request span under the client's
        trace id, and the error mapping (NoReplica -> 503, ForwardError
        -> 502, spent deadline -> 504, bad by-id payload -> 400).

        ``?model=`` names the tenant: requests route only to replicas
        HOSTING that catalog model, and the per-tenant quota + the
        labeled ``xgbtpu_tenant_*`` metrics key on it — one tenant's
        overload sheds as ITS 429/503s while its neighbors' traffic
        flows untouched."""
        rid = self.headers.get("X-Request-Id") or trace.new_id()
        self._request_id = rid
        rt: FleetRouter = self.server.router
        model = (parse_qs(url.query).get("model", [""])[0]
                 if url.query else "")
        tenant = model or "default"
        # the request's end-to-end budget: the client's X-Deadline-Ms,
        # or the router's fleet_deadline_ms default when configured —
        # every downstream hop SPENDS from this one object
        dl = Deadline.from_headers(self.headers)
        if dl is None and rt.deadline_ms > 0:
            dl = Deadline(rt.deadline_ms)
        if dl is not None and dl.expired():
            # reject before any dispatch: nobody is waiting for this
            from xgboost_tpu_torch.profiling import reliability_metrics
            reliability_metrics().deadline_rejected.inc()
            self._send_json(504, {"error": "deadline expired before "
                                           "dispatch",
                                  "deadline_exceeded": True})
            return
        from xgboost_tpu_torch.obs.metrics import tenant_metrics
        tm = tenant_metrics()
        tm.requests.inc(tenant)
        if model and not rt.membership.hosting(model):
            # no replica advertises this model: 404 (a client error)
            # when the fleet is otherwise alive, 503 when it is empty
            # (nothing can answer ANY model — same as NoReplica)
            if rt.membership.ids():
                tm.shed.inc(tenant)
                self._send_json(404, {
                    "error": f"no replica hosts model {model!r}",
                    "models": sorted(rt.membership.models_hosted())})
                return
        if rt.quotas.enabled:
            why = rt.quotas.try_admit(tenant)
            if why is not None:
                # rate -> 429 (slow down), inflight -> 503 (shed now):
                # the tenant's OWN budget said no — no global slot, no
                # replica work, no neighbor touched
                tm.shed.inc(tenant)
                self.close_connection = True
                if why == "rate":
                    self._send_json(429, {
                        "error": f"tenant {tenant!r} over rate limit",
                        "shed": True, "model": tenant})
                else:
                    self._send_json(503, {
                        "error": f"tenant {tenant!r} over in-flight "
                                 "budget", "shed": True, "model": tenant})
                return
            tm.inflight.set(tenant, rt.quotas.inflight(tenant))
        try:
            if not rt.enter_request():
                fleet_metrics().shed.inc()
                self.close_connection = True
                self._send_json(503, {"error": "router overloaded "
                                               "(in-flight budget)",
                                      "shed": True})
                return
            t_req = time.perf_counter()
            try:
                with trace_context(rid):
                    with span("router.request", request_id=rid,
                              path=url.path, model=model or None) as sp:
                        status, headers, out = dispatch_fn(
                            _path_qs(url), self._fwd_headers(rid, dl), sp,
                            dl, model)
                tm.latency_ms.inc(
                    tenant, (time.perf_counter() - t_req) * 1e3)
                self._relay(status, headers, out)
            except NoReplica:
                self._send_json(503, {"error": "no replica available"})
            except DeadlineExceeded as e:
                from xgboost_tpu_torch.profiling import reliability_metrics
                reliability_metrics().deadline_rejected.inc()
                self._send_json(504, {"error": str(e),
                                      "deadline_exceeded": True})
            except ForwardError as e:
                self._send_json(502, {"error": str(e)})
            except ValueError as e:
                self._send_json(400, {"error": f"bad request: {e}"})
            finally:
                rt.exit_request()
        finally:
            if rt.quotas.enabled:
                rt.quotas.release(tenant)
                tm.inflight.set(tenant, rt.quotas.inflight(tenant))

    def _fwd_headers(self, rid: str, dl=None) -> Dict[str, str]:
        h = {"X-Request-Id": rid}
        if dl is not None:
            # stamp the REMAINING budget (never the original): queue
            # time at this hop is charged to the request
            h[DEADLINE_HEADER] = dl.header_value()
        ctype = self.headers.get("Content-Type")
        if ctype:
            h["Content-Type"] = ctype
        return h

    def _relay(self, status: int, headers: Dict[str, str],
               body: bytes) -> None:
        self._send(status, body,
                   headers.get("Content-Type", "application/json"))


def _path_qs(url) -> str:
    return url.path + (f"?{url.query}" if url.query else "")


class NoReplica(RuntimeError):
    """No in-rotation replica could accept the dispatch."""


class FleetRouter:
    """Membership + dispatch + admission control behind one HTTP port.

    ``port=0`` binds ephemeral (tests); the bound port is on
    ``self.port``.  :meth:`start` runs on a background thread,
    :meth:`serve_forever` blocks (SIGTERM stops the health loop and
    closes the listener — replicas keep serving direct traffic)."""

    # statuses that justify trying a different replica: the replica
    # cannot take the request (503 draining/overloaded, 502) or faulted
    # while handling it (500) — predicts are idempotent, so retrying on
    # a sibling is safe; deterministic client errors (4xx) pass through
    RETRYABLE_STATUS = (500, 502, 503)

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 lease_sec: float = 10.0, hc_sec: float = 2.0,
                 inflight_budget: int = 256,
                 breaker_failures: int = 3,
                 breaker_cooldown_sec: float = 5.0,
                 retry: bool = True,
                 forward_timeout: float = 30.0,
                 max_body_mb: float = 64.0,
                 deadline_ms: float = 0.0,
                 slow_eject_factor: float = 3.0,
                 slow_eject_cooldown_sec: float = 5.0,
                 rollout_defaults: Optional[dict] = None,
                 state_path: str = "",
                 tenant_inflight: int = 0,
                 tenant_rate: float = 0.0,
                 tenant_burst: float = 8.0,
                 quiet: bool = True):
        from xgboost_tpu_torch.catalog import TenantQuotas
        self.membership = Membership(
            lease_sec=lease_sec, breaker_failures=breaker_failures,
            breaker_cooldown_sec=breaker_cooldown_sec,
            slow_eject_factor=slow_eject_factor,
            slow_eject_cooldown_sec=slow_eject_cooldown_sec)
        # per-tenant quotas (?model= names the tenant): in-flight cap
        # and token-bucket rate limit, both 0 = disabled
        self.quotas = TenantQuotas(inflight_limit=tenant_inflight,
                                   rate=tenant_rate, burst=tenant_burst)
        # membership snapshot for zero-downtime restart: written
        # (CRC-footered, atomic+fsync) on register/deregister and each
        # health pass, restored — with fresh leases — on startup
        self.state_path = str(state_path)
        self.hc_sec = float(hc_sec)
        self.inflight_budget = int(inflight_budget)
        # default end-to-end budget stamped on requests that carry no
        # X-Deadline-Ms of their own (0 = none)
        self.deadline_ms = float(deadline_ms)
        self.retry = bool(retry)
        self.max_body_bytes = int(max_body_mb * (1 << 20))
        self.rollout_defaults = dict(rollout_defaults or {})
        self.quiet = quiet
        self.t0 = time.perf_counter()
        self._pool = _ConnPool(timeout=forward_timeout)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._rollout_lock = threading.Lock()
        self._rollout_state: dict = {}   # model-file backups for rollback
        self._last_rollout: dict = {"status": "none"}
        # placer single-holder lease + last recorded target plan: one
        # placer drives placement at a time; a standby that polls
        # /placer/lease takes over only after the holder's lease decays
        self._placer_lock = threading.Lock()
        self._placer_holder: Optional[str] = None
        self._placer_deadline = 0.0      # monotonic
        self._placer_lease_sec = max(float(lease_sec), 1.0)
        self._placer_plan: dict = {}
        self._stop = threading.Event()
        self._hc_thread: Optional[threading.Thread] = None
        self._httpd = ThreadingHTTPServer((host, port), _RouterHandler)
        self._httpd.daemon_threads = True
        self._httpd.router = self
        self._httpd.quiet = quiet
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._shut = False
        self._restore_state()

    # ----------------------------------------------------- state snapshot
    def save_state(self) -> None:
        """Persist the membership table (atomic, fsync'd, CRC-footered
        like every other durable artifact).  Best-effort: a full disk
        must not fail a registration."""
        if not self.state_path:
            return
        from xgboost_tpu_torch.reliability.integrity import (add_footer,
                                                       atomic_write)
        try:
            atomic_write(
                self.state_path,
                add_footer(json.dumps(self.membership.snapshot(),
                                      sort_keys=True).encode()))
        except OSError as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.router.save_state", e)

    def _restore_state(self) -> None:
        """Zero-downtime restart: re-register every snapshotted replica
        with a fresh lease, so a SIGKILL'd router comes back already
        routing.  A corrupt/absent snapshot starts empty — replicas
        re-register within a heartbeat period anyway (the recover
        path); restore just removes that window."""
        if not self.state_path or not os.path.exists(self.state_path):
            return
        try:
            from xgboost_tpu_torch.reliability.integrity import \
                verify_model_bytes
            with open(self.state_path, "rb") as f:
                payload = verify_model_bytes(f.read(), self.state_path)
            n = self.membership.restore(json.loads(payload))
            from xgboost_tpu_torch.obs import event
            event("fleet.router.restore", replicas=n,
                  state_path=self.state_path)
            if not self.quiet:
                print(f"[fleet] restored {n} replica(s) from "
                      f"{self.state_path}", file=sys.stderr)
        except Exception as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("fleet.router.restore_state", e)

    # -------------------------------------------------------- admission
    def enter_request(self) -> bool:
        with self._inflight_lock:
            if self._inflight >= self.inflight_budget:
                return False
            self._inflight += 1
            fleet_metrics().inflight.set(self._inflight)
            return True

    def exit_request(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            fleet_metrics().inflight.set(self._inflight)

    @property
    def inflight(self) -> int:
        return self._inflight

    # --------------------------------------------------------- forwarding
    def _forward(self, rep: Replica, method: str, path_qs: str,
                 body: bytes, headers: Dict[str, str],
                 timeout: Optional[float] = None,
                 deadline: Optional[Deadline] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """One HTTP hop to one replica over the keep-alive pool.
        Raises :class:`ForwardError` on transport failure or a
        retryable status; other statuses (2xx/4xx) return verbatim.
        ``timeout`` overrides the pool default for THIS hop (the
        deadline path bounds each attempt by the remaining budget).

        A hop that times out because the DEADLINE shrank its window —
        the budget is spent when the timeout fires — raises
        :class:`DeadlineExceeded` instead of ForwardError: the replica
        did not fail, the request ran out of money, and charging the
        breaker would let a few tight-budget clients 503 a healthy
        replica for everyone (callers release neutrally)."""
        conn = self._pool.acquire(rep.url)
        # always (re)set: a pooled socket remembers the previous hop's
        # deadline-shortened timeout otherwise.  Applies to both a
        # fresh connect (conn.timeout is read at connect()) and a
        # pooled socket already connected.
        t = self._pool.timeout if timeout is None else timeout
        conn.timeout = t
        if conn.sock is not None:
            conn.sock.settimeout(t)
        try:
            hdrs = dict(headers)
            hdrs["Content-Length"] = str(len(body))
            conn.request(method, path_qs, body=body, headers=hdrs)
            resp = conn.getresponse()
            out = resp.read()
            status = resp.status
            will_close = resp.will_close
            keep = {k: v for k in _PASS_HEADERS
                    if (v := resp.getheader(k)) is not None}
        except Exception as e:
            conn.close()
            # socket.timeout is TimeoutError since 3.10; a connect
            # REFUSED stays a ForwardError (the breaker should see a
            # dead replica even from tight-budget traffic)
            if (deadline is not None and deadline.expired()
                    and isinstance(e, TimeoutError)):
                raise DeadlineExceeded(
                    f"budget exhausted mid-hop to {rep.replica_id}"
                ) from e
            raise ForwardError(rep.replica_id,
                               f"{type(e).__name__}: {e}") from e
        if will_close:
            # the replica announced Connection: close (drain/shed 503s
            # do) — pooling this socket would hand the NEXT dispatch a
            # dead connection and charge the miss to a healthy replica
            conn.close()
        else:
            self._pool.release(rep.url, conn)
        if status in self.RETRYABLE_STATUS:
            raise ForwardError(rep.replica_id, f"status {status}",
                               status=status)
        return status, keep, out

    def _hop_timeout(self, deadline: Optional[Deadline]
                     ) -> Optional[float]:
        """Per-attempt forward timeout: the pool default, shrunk to the
        request's remaining budget when one exists — a hop must never
        outwait the caller."""
        if deadline is None:
            return None
        return max(0.01, min(self._pool.timeout, deadline.remaining()))

    def dispatch(self, method: str, path_qs: str, body: bytes,
                 headers: Dict[str, str], sp=None,
                 deadline: Optional[Deadline] = None,
                 model: str = ""
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """Route one LEAST-LOADED request (`/predict`): forward, and —
        on failure — retry ONCE on a different replica (predictions are
        idempotent), after a jittered backoff, spending the REMAINING
        deadline budget rather than arming a fresh timeout.  Breaker +
        per-replica metrics are driven from the outcomes, and each
        successful hop's latency feeds the membership's per-replica
        EWMA (the latency-ejection signal).  Entity-id routes never
        come through here: they address their ring owner single-attempt
        (:meth:`_dispatch_owner` — a put retried on the ring successor
        while the owner is merely slow would store rows where no later
        predict looks, and a by-id predict retried there answers a
        wrong 404; entity traffic fails over only when MEMBERSHIP
        changes)."""
        fm = fleet_metrics()
        t0 = time.perf_counter()
        tried: List[str] = []
        attempts = 2 if self.retry else 1
        last_err: Optional[ForwardError] = None
        try:
            for attempt in range(attempts):
                if deadline is not None and deadline.expired():
                    # the budget died with the last attempt: a retry
                    # would burn a replica on an answer nobody reads
                    if sp is not None:
                        sp.set("status", 504)
                    raise DeadlineExceeded(
                        "deadline spent after "
                        f"{attempt} attempt(s)")
                if attempt:
                    # jittered backoff before the retry (a fleet that
                    # retries in lockstep re-overloads the survivor),
                    # bounded so it never eats the remaining budget
                    time.sleep(backoff_delay(attempt, deadline=deadline))
                rep = self.membership.acquire(exclude=tried, model=model)
                if rep is None:
                    break
                tried.append(rep.replica_id)
                if attempt:
                    # counted only when a second replica was actually
                    # acquired — a 1-replica fleet's failed dispatch is
                    # not a retry
                    fm.retries.inc()
                fm.requests.inc(rep.replica_id)
                hdrs_out = dict(headers)
                if deadline is not None:
                    # restamped per attempt: the retry hop sees what is
                    # actually left, not the first hop's budget
                    hdrs_out[DEADLINE_HEADER] = deadline.header_value()
                t_hop = time.perf_counter()
                try:
                    status, hdrs, out = self._forward(
                        rep, method, path_qs, body, hdrs_out,
                        timeout=self._hop_timeout(deadline),
                        deadline=deadline)
                except DeadlineExceeded:
                    # the BUDGET cut the hop short, not the replica:
                    # neutral release (no breaker/EWMA charge), 504 out
                    self.membership.release(rep, ok=None)
                    if sp is not None:
                        sp.set("status", 504)
                    raise
                except ForwardError as e:
                    self.membership.release(rep, ok=False)
                    fm.errors.inc(rep.replica_id)
                    last_err = e
                    continue
                self.membership.release(
                    rep, ok=True,
                    latency=time.perf_counter() - t_hop)
                if sp is not None:
                    sp.set("replica", rep.replica_id)
                    sp.set("status", status)
                    if attempt:
                        sp.set("retried", attempt)
                return status, hdrs, out
            if last_err is not None:
                if sp is not None:
                    sp.set("status", 502)
                raise last_err
            if sp is not None:
                sp.set("status", 503)
            raise NoReplica()
        finally:
            fm.latency.observe(time.perf_counter() - t0)

    # ----------------------------------------------- id-keyed dispatching
    def dispatch_by_id(self, path: str, path_qs: str, body: bytes,
                       headers: Dict[str, str], sp=None,
                       deadline: Optional[Deadline] = None,
                       model: str = ""
                       ) -> Tuple[int, Dict[str, str], bytes]:
        """Consistent-hash dispatch for the entity-id routes.  The
        common case — every id owned by one replica — forwards the body
        verbatim (responses stay byte-identical to a direct replica
        call); requests spanning owners split into per-replica
        sub-requests whose responses merge in input order.  The
        deadline budget (already stamped on ``headers`` by the proxy
        shell) bounds each owner hop; entity hops are single-attempt,
        so the only deadline decision here is not starting one that
        cannot finish."""
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded("deadline spent before owner dispatch")
        try:
            req = json.loads(body) if body.strip() else {}
        except ValueError as e:
            raise ValueError(f"invalid JSON body: {e}") from None
        if path == "/featurestore/invalidate" and req.get("all"):
            return self._broadcast_invalidate(path_qs, body, headers, sp)
        ids = req.get("ids")
        if not isinstance(ids, list) or not ids:
            raise ValueError("'ids' must be a non-empty list")
        # per-(model, entity) ownership: each tenant's hot rows
        # concentrate independently, on replicas hosting that model
        groups = self.membership.route_ids(ids, model=model)
        if not groups:
            raise NoReplica()
        if len(groups) == 1:
            # single owner: pure passthrough (bit-identical response).
            # The OWNER is addressed directly (acquire_specific), never
            # its ring successor: a breaker-open owner fails fast as
            # 503 rather than silently parking entity rows where no
            # later predict will look — the same stance as the split
            # path below; the ring reroutes only on membership change
            (rid,) = groups
            return self._dispatch_owner(rid, path_qs, body, headers, sp,
                                        deadline=deadline)
        return self._split_merge(path, path_qs, req, groups, headers, sp,
                                 deadline=deadline)

    def _dispatch_owner(self, rid: str, path_qs: str, body: bytes,
                        headers: Dict[str, str], sp=None,
                        deadline: Optional[Deadline] = None
                        ) -> Tuple[int, Dict[str, str], bytes]:
        """One single-attempt hop to a NAMED replica (the resolved ring
        owner), with the same accounting dispatch() does."""
        fm = fleet_metrics()
        t0 = time.perf_counter()
        rep = self.membership.acquire_specific(rid)
        if rep is None:
            if sp is not None:
                sp.set("status", 503)
            raise NoReplica()
        fm.requests.inc(rid)
        try:
            t_hop = time.perf_counter()
            try:
                status, hdrs, out = self._forward(
                    rep, "POST", path_qs, body, headers,
                    timeout=self._hop_timeout(deadline),
                    deadline=deadline)
            except DeadlineExceeded:
                self.membership.release(rep, ok=None)
                if sp is not None:
                    sp.set("status", 504)
                raise
            except ForwardError:
                self.membership.release(rep, ok=False)
                fm.errors.inc(rid)
                if sp is not None:
                    sp.set("status", 502)
                raise
            self.membership.release(rep, ok=True,
                                    latency=time.perf_counter() - t_hop)
            if sp is not None:
                sp.set("replica", rid)
                sp.set("status", status)
            return status, hdrs, out
        finally:
            fm.latency.observe(time.perf_counter() - t0)

    def _sub_body(self, path: str, req: dict, positions: List[int]
                  ) -> bytes:
        sub = dict(req)
        sub["ids"] = [req["ids"][i] for i in positions]
        if path == "/featurestore/put":
            rows = req.get("rows")
            if not isinstance(rows, list) or len(rows) != len(req["ids"]):
                raise ValueError("'rows' must be a list matching 'ids'")
            sub["rows"] = [rows[i] for i in positions]
        return json.dumps(sub).encode()

    def _split_merge(self, path: str, path_qs: str, req: dict,
                     groups: Dict[str, List[int]],
                     headers: Dict[str, str], sp=None,
                     deadline: Optional[Deadline] = None
                     ) -> Tuple[int, Dict[str, str], bytes]:
        """Fan a multi-owner id request out and merge the JSON
        responses: predictions land back in input order; missing-id
        404s union across replicas; the first other error wins.  Same
        single-attempt stance as key-routed dispatch: a sub-request
        that fails surfaces as 502 rather than being retried on a
        non-owner (see :meth:`dispatch`) — the client retries after
        membership converges."""
        ids = req["ids"]
        fm = fleet_metrics()
        n = len(ids)
        merged_preds: List = [None] * n
        missing: List = []
        versions: Dict[str, int] = {}
        invalidated = 0
        for rid, positions in sorted(groups.items()):
            # built BEFORE acquiring: a malformed request (rows/ids
            # length mismatch) must raise while no outstanding count or
            # half-open probe slot is held
            sub = self._sub_body(path, req, positions)
            rep = self.membership.acquire_specific(rid)
            if rep is None:
                # the owner left rotation (or its breaker opened)
                # between routing and dispatch: fail fast with 503 —
                # same stance as the single-owner path; "missing" would
                # be a lie (the rows may well be resident there) and a
                # re-put it provoked would land on the wrong replica
                if sp is not None:
                    sp.set("status", 503)
                raise NoReplica()
            fm.requests.inc(rid)
            t_hop = time.perf_counter()
            try:
                status, _, out = self._forward(
                    rep, "POST", path_qs, sub, headers,
                    timeout=self._hop_timeout(deadline),
                    deadline=deadline)
            except DeadlineExceeded:
                self.membership.release(rep, ok=None)
                raise
            except ForwardError:
                self.membership.release(rep, ok=False)
                fm.errors.inc(rid)
                raise
            self.membership.release(rep, ok=True,
                                    latency=time.perf_counter() - t_hop)
            try:
                payload = json.loads(out)
            except ValueError:
                payload = {}
            if status == 404 and "missing" in payload:
                missing.extend(payload["missing"])
                continue
            if status != 200:
                return status, {"Content-Type": "application/json"}, out
            if "predictions" in payload:
                for pos, p in zip(positions, payload["predictions"]):
                    merged_preds[pos] = p
                versions[rid] = payload.get("model_version")
            invalidated += int(payload.get("invalidated", 0))
        if sp is not None:
            sp.set("split", len(groups))
        ctype = {"Content-Type": "application/json"}
        if missing:
            body = json.dumps({"error": f"{len(missing)} id(s) not "
                                        "resident", "missing": missing})
            if sp is not None:
                sp.set("status", 404)
            return 404, ctype, body.encode()
        if path == "/featurestore/invalidate":
            resp = {"invalidated": invalidated, "split": len(groups)}
        elif path == "/featurestore/put":
            resp = {"stored": n, "split": len(groups)}
        else:
            vs = set(versions.values())
            resp = {"predictions": merged_preds, "rows": n,
                    "model_version": (vs.pop() if len(vs) == 1
                                      else sorted(versions.values())),
                    "split": len(groups)}
        if sp is not None:
            sp.set("status", 200)
        return 200, ctype, json.dumps(resp).encode()

    def _broadcast_invalidate(self, path_qs: str, body: bytes,
                              headers: Dict[str, str], sp=None
                              ) -> Tuple[int, Dict[str, str], bytes]:
        """``{"all": true}`` goes to every in-rotation replica."""
        total = 0
        reached = 0
        for rid in sorted(r.replica_id
                          for r in self.membership.in_rotation()):
            rep = self.membership.acquire_specific(rid)
            if rep is None:
                continue
            try:
                status, _, out = self._forward(rep, "POST", path_qs,
                                               body, headers)
            except ForwardError as e:
                self.membership.release(rep, ok=False)
                fleet_metrics().errors.inc(e.replica_id)
                continue
            self.membership.release(rep, ok=True)
            if status == 200:
                reached += 1
                try:
                    total += int(json.loads(out).get("invalidated", 0))
                except ValueError:
                    pass  # non-JSON 200 from a replica: count nothing
        if sp is not None:
            sp.set("status", 200)
        return 200, {"Content-Type": "application/json"}, json.dumps(
            {"invalidated": total, "replicas": reached}).encode()

    # -------------------------------------------------------------- admin
    def health(self) -> dict:
        desc = self.membership.describe()
        return {
            "status": "ok" if desc["in_rotation"] > 0 else "degraded",
            "role": "fleet_router",
            "members": desc["in_rotation"],
            "registered": desc["registered"],
            "inflight": self._inflight,
            "inflight_budget": self.inflight_budget,
            "models": self.membership.models_hosted(),
            # the elastic supervisor pins the fleet size while a
            # rollout/canary soak runs — a drain mid-soak would remove
            # the soak's pinned path-groups and invalidate the gate
            "rollout_in_progress": self._rollout_lock.locked(),
            "uptime_seconds": round(time.perf_counter() - self.t0, 3),
        }

    def run_rollout(self, model_path: str, req: dict
                    ) -> Tuple[int, dict]:
        """One staged canary rollout (fleet/rollout.py); serialized —
        a second rollout while one runs gets 409."""
        from xgboost_tpu_torch.fleet.rollout import RolloutController
        if not self._rollout_lock.acquire(blocking=False):
            return 409, {"error": "a rollout is already in progress"}
        try:
            ctl = RolloutController(self.membership, self._forward,
                                    state=self._rollout_state)
            kw = dict(self.rollout_defaults)
            for k in ("canaries", "soak_sec", "gate_error_rate",
                      "gate_p99_ms", "model"):
                if k in req:
                    kw[k] = req[k]
            report = ctl.rollout(model_path, **kw)
            with self._inflight_lock:
                self._last_rollout = report
            return (200 if report["status"] == "ok" else 500), report
        except Exception as e:
            report = {"status": "error",
                      "error": f"{type(e).__name__}: {e}"}
            with self._inflight_lock:
                self._last_rollout = report
            return 500, report
        finally:
            self._rollout_lock.release()

    def run_rollback(self, model: str = "") -> Tuple[int, dict]:
        from xgboost_tpu_torch.fleet.rollout import RolloutController
        # serialized against rollouts: a rollback racing an in-flight
        # rollout's fleet push would interleave writes to the same
        # model files and leave a mixed fleet behind an authoritative-
        # looking report
        if not self._rollout_lock.acquire(blocking=False):
            return 409, {"error": "a rollout is in progress — retry "
                                  "after it completes (its gate rolls "
                                  "a failing push back itself)"}
        try:
            ctl = RolloutController(self.membership, self._forward,
                                    state=self._rollout_state)
            report = ctl.rollback(model=model)
            with self._inflight_lock:
                self._last_rollout = report
            return 200, report
        finally:
            self._rollout_lock.release()

    def rollout_status(self) -> dict:
        with self._inflight_lock:
            return dict(self._last_rollout)

    # --------------------------------------------------------------- placer
    def placer_acquire(self, placer_id: str,
                       lease_sec: Optional[float] = None) -> dict:
        """Grant (or renew) the single-holder placer lease.  A second
        placer asking while the lease is live is told who holds it and
        stands by; the holder renews by re-asking.  Monotonic clock
        throughout (XGT006)."""
        from xgboost_tpu_torch.obs import event
        now = time.monotonic()
        sec = float(lease_sec) if lease_sec else self._placer_lease_sec
        renewal = False
        with self._placer_lock:
            free = (self._placer_holder is None
                    or now >= self._placer_deadline
                    or self._placer_holder == placer_id)
            took_over = free and self._placer_holder not in (None,
                                                             placer_id)
            if free:
                renewal = self._placer_holder == placer_id
                self._placer_holder = placer_id
                self._placer_deadline = now + sec
                self._placer_lease_sec = sec
            holder = self._placer_holder
        if free and not renewal:
            event("placer.lease", placer_id=placer_id,
                  took_over=took_over)
        return {"granted": free, "holder": holder, "lease_sec": sec}

    def placer_record_plan(self, placer_id: str,
                           plan: dict) -> Tuple[int, dict]:
        """Record the placer's target assignment (observability +
        takeover hand-off).  Only the lease holder may write — a
        zombie placer that lost its lease gets 409, not a split-brain
        plan."""
        now = time.monotonic()
        with self._placer_lock:
            if (self._placer_holder != placer_id
                    or now >= self._placer_deadline):
                return 409, {"error": "not the placer lease holder",
                             "holder": self._placer_holder}
            self._placer_plan = dict(plan)
        return 200, {"recorded": True}

    def placer_status(self) -> dict:
        now = time.monotonic()
        with self._placer_lock:
            return {
                "holder": self._placer_holder,
                "lease_remaining_sec": round(
                    max(self._placer_deadline - now, 0.0), 3),
                "plan": dict(self._placer_plan),
            }

    # ---------------------------------------------------------- lifecycle
    def _hc_loop(self) -> None:
        # ±20% jitter: N routers (or a router restarted with its fleet)
        # must not probe every replica in lockstep forever
        while not self._stop.wait(jittered(self.hc_sec)):
            try:
                self.membership.health_check()
                self._pool.prune(self.membership.urls())
                # advertisement drift (a rollout moved a tenant's hash)
                # arrives on heartbeats; fold it into the snapshot here
                # rather than fsync-ing on every heartbeat
                self.save_state()
            except Exception as e:  # the health loop must survive anything
                from xgboost_tpu_torch.obs.metrics import swallowed_error
                swallowed_error("fleet.router.health_loop", e)

    def start(self) -> "FleetRouter":
        if self.hc_sec > 0:
            self._hc_thread = threading.Thread(
                target=self._hc_loop, daemon=True, name="xgbtpu-fleet-hc")
            self._hc_thread.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="xgbtpu-fleet-router")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        if self.hc_sec > 0:
            self._hc_thread = threading.Thread(
                target=self._hc_loop, daemon=True, name="xgbtpu-fleet-hc")
            self._hc_thread.start()
        if threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGTERM,
                              lambda *_: threading.Thread(
                                  target=self.shutdown,
                                  daemon=True).start())
            except ValueError:
                pass
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        with self._inflight_lock:
            if self._shut:
                return
            self._shut = True
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._pool.close()
        if self._hc_thread is not None:
            self._hc_thread.join(self.hc_sec + 2.0)
            self._hc_thread = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


def run_router(host: str = "127.0.0.1", port: int = 8000,
               lease_sec: float = 10.0, hc_sec: float = 2.0,
               inflight_budget: int = 256, breaker_failures: int = 3,
               breaker_cooldown_sec: float = 5.0, retry: bool = True,
               forward_timeout: float = 30.0, max_body_mb: float = 64.0,
               deadline_ms: float = 0.0,
               slow_eject_factor: float = 3.0,
               slow_eject_cooldown_sec: float = 5.0,
               rollout_defaults: Optional[dict] = None,
               state_path: str = "",
               tenant_inflight: int = 0, tenant_rate: float = 0.0,
               tenant_burst: float = 8.0,
               quiet: bool = False, block: bool = True
               ) -> Optional[FleetRouter]:
    """Build and run the fleet router (CLI ``task=fleet_router``).
    ``block=False`` returns the started router (tests, launchers)."""
    rt = FleetRouter(host=host, port=port, lease_sec=lease_sec,
                     hc_sec=hc_sec, inflight_budget=inflight_budget,
                     breaker_failures=breaker_failures,
                     breaker_cooldown_sec=breaker_cooldown_sec,
                     retry=retry, forward_timeout=forward_timeout,
                     max_body_mb=max_body_mb, deadline_ms=deadline_ms,
                     slow_eject_factor=slow_eject_factor,
                     slow_eject_cooldown_sec=slow_eject_cooldown_sec,
                     rollout_defaults=rollout_defaults,
                     state_path=state_path,
                     tenant_inflight=tenant_inflight,
                     tenant_rate=tenant_rate, tenant_burst=tenant_burst,
                     quiet=quiet)
    if not quiet:
        print(f"[fleet] router on http://{rt.host}:{rt.port} "
              f"(lease {lease_sec}s, budget {inflight_budget} in-flight)",
              file=sys.stderr)
    if block:
        rt.serve_forever()
        return None
    return rt.start()
