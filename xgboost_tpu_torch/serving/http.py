"""Stdlib-only HTTP front end for the serving stack (port of
``xgboost_tpu/serving/http.py``, the same routes and JSON keys).

Endpoints (SERVING.md):

- ``POST /predict`` — body is CSV rows (default) or libsvm rows
  (``?format=libsvm`` or ``Content-Type: text/libsvm``); responds
  ``{"predictions": [...], "model_version": v, "rows": n}``.
  ``?output_margin=1`` returns raw margins.  A full batch queue maps to
  HTTP 503 (the batcher's reject-with-backpressure contract).
  ``?model=NAME`` selects a model from the replica's catalog
  (xgboost_tpu_torch.catalog); the bare path resolves to the configured
  default model — the catalog-of-one path IS the single-model path.
  An unknown model name is 404.  ``?model=`` also applies to
  ``/predict_by_id``, the ``/featurestore/*`` admin routes, and
  ``/-/reload`` / ``/-/rollback``.
- ``POST /predict_by_id`` — JSON ``{"ids": [...]}``: predictions for
  DEVICE-RESIDENT entities (serving/featurestore.py) with zero
  host→device feature bytes; absent ids → 404 listing them.  Enabled
  by ``serve_featurestore_mb > 0``.
- ``POST /featurestore/put`` — JSON ``{"ids": [...], "rows": [[...]]}``
  pins entity rows on device (LRU-evicting past the byte budget);
  ``POST /featurestore/invalidate`` — ``{"ids": [...]}`` or
  ``{"all": true}`` drops them.
- ``GET /healthz`` — liveness + model version + queue depth + p50/p99,
  plus the failure-path fields (RELIABILITY.md): drain ``state``,
  ``status: degraded`` while the watched model file is poisoned,
  ``reload_failures`` count and ``last_reload_error``.
- ``GET /metrics`` — Prometheus text exposition (ServingMetrics +
  the process-wide ReliabilityMetrics).
- ``POST /-/reload`` — force one reload poll (also happens on the
  background poll timer); ``POST /-/rollback`` swaps the previous
  version back in.

Shutdown is a drain state machine (``serving -> draining -> stopped``):
SIGTERM (or :meth:`PredictServer.drain`) stops admitting ``/predict``
with 503, waits for in-flight requests to finish (bounded by
``drain_grace``), then exits — a rolling restart loses zero accepted
requests.

``ThreadingHTTPServer`` gives one thread per connection; all of them
funnel into the single MicroBatcher queue, which is where concurrency
turns into coalesced device batches.
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from xgboost_tpu_torch.obs import span, trace, trace_context
from xgboost_tpu_torch.obs.server import PROM_CONTENT_TYPE
from xgboost_tpu_torch.reliability.deadline import Deadline, DeadlineExceeded
from xgboost_tpu_torch.serving.batcher import MicroBatcher, QueueFull
from xgboost_tpu_torch.serving.registry import ModelRegistry


def parse_csv_rows(text: str) -> np.ndarray:
    """CSV rows -> (n, F) float32 (empty fields / 'nan' = missing)."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rows.append([float(tok) if tok.strip() not in ("", "na", "nan")
                     else np.nan for tok in line.split(",")])
    if not rows:
        return np.zeros((0, 0), np.float32)
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), np.nan, np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def parse_libsvm_rows(text: str, num_feature: int) -> np.ndarray:
    """libsvm rows -> (n, F) float32 with NaN for absent features.  A
    leading label token (no ':') is tolerated and ignored — serving
    inputs are features-only, but clients often replay training files.
    A feature index beyond the model's width is a client error (400),
    same as the CSV path's too-many-columns check — silently dropping
    it would return confidently wrong predictions for a mis-deployed
    client."""
    rows = []
    for line in text.splitlines():
        toks = line.split("#", 1)[0].split()
        if not toks:
            continue
        feats = {}
        for j, tok in enumerate(toks):
            if ":" not in tok:
                if j == 0:
                    continue  # label column
                raise ValueError(f"bad libsvm token {tok!r}")
            idx, _, val = tok.partition(":")
            feats[int(idx)] = float(val)
        rows.append(feats)
    out = np.full((len(rows), num_feature), np.nan, np.float32)
    for i, feats in enumerate(rows):
        for idx, val in feats.items():
            if not 0 <= idx < num_feature:
                raise ValueError(
                    f"feature index {idx} out of range for a "
                    f"{num_feature}-feature model")
            out[i, idx] = val
    return out


def read_request_body(handler, max_bytes: int):
    """Drain and validate a POST body on a keep-alive connection — THE
    body-hygiene discipline, shared by the replica handler here and the
    fleet router's (fleet/router.py).  Under HTTP/1.1 keep-alive,
    unread body bytes would be parsed as the next request line on the
    reused connection; bodies we cannot drain deterministically
    (chunked encoding, bad/negative Content-Length) get an error AND a
    closed connection, and anything over ``max_bytes`` is refused with
    413 BEFORE buffering.  Returns the raw bytes, or None when an
    error response has already been sent (the handler must have
    ``close_connection``/``_send_json``, i.e. be one of ours)."""
    te = (handler.headers.get("Transfer-Encoding") or "").lower()
    if "chunked" in te:
        handler.close_connection = True
        handler._send_json(411, {"error": "chunked bodies not "
                                          "supported; send "
                                          "Content-Length"})
        return None
    try:
        length = int(handler.headers.get("Content-Length", 0))
    except ValueError:
        length = -1
    if length < 0:
        handler.close_connection = True
        handler._send_json(400, {"error": "bad Content-Length"})
        return None
    if length > max_bytes:
        handler.close_connection = True
        handler._send_json(413, {"error": f"request body {length} "
                                          f"bytes exceeds limit "
                                          f"{max_bytes}"})
        return None
    return handler.rfile.read(length)


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries registry/batcher/metrics (see
    # PredictServer below)
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: the response goes out as two writes (header buffer,
    # then body) — with Nagle on, the body write stalls behind the
    # peer's delayed ACK of the header segment, a flat ~40 ms added to
    # EVERY response on an otherwise sub-millisecond predict
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # route access logs through quiet
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
            # the id that correlates this response with its span in the
            # event log (and with the client's own tracing)
            self.send_header("X-Request-Id", rid)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    # ---------------------------------------------------------------- GET
    def do_GET(self):
        # handler instances persist across a keep-alive connection:
        # a request id set by an earlier /predict must not leak onto
        # this response
        self._request_id = None
        url = urlparse(self.path)
        if url.path == "/healthz":
            reg: ModelRegistry = self.server.registry
            ps: PredictServer = self.server.pserver
            m = self.server.metrics
            q = m.quantiles((0.5, 0.99))
            # "degraded" = still serving, but the watched file is
            # poisoned (its newest bytes cannot be loaded) — alerts fire
            # while traffic keeps flowing on the last good model
            health = {
                "status": "degraded" if reg.poisoned else "ok",
                "state": ps.state,
                "model_version": reg.version,
                # content hash of what the live engine ACTUALLY serves
                # (follows rollbacks) — the fleet rollout controller
                # verifies pushes against it (fleet/rollout.py)
                "model_hash": reg.content_hash,
                "uptime_seconds": round(time.perf_counter() - ps.t0, 3),
                "queue_rows": self.server.batcher.queued_rows,
                "inflight": ps.inflight,
                "buckets_compiled": reg.engine.num_compiled,
                "reload_failures": reg.reload_failures,
                "last_reload_error": reg.last_reload_error,
                "latency_p50_ms": round(q[0.5] * 1e3, 3),
                "latency_p99_ms": round(q[0.99] * 1e3, 3),
            }
            if ps.featurestore is not None:
                health["featurestore_rows"] = len(ps.featurestore)
            if ps.catalog is not None:
                # per-model rows (name -> path/resident/version/hash/
                # buckets/device bytes) — the rollout controller verifies
                # per-tenant pushes against models[m]["model_hash"]
                cd = ps.catalog.describe()
                health["models"] = cd["models"]
                health["catalog"] = {
                    k: cd[k] for k in ("default", "configured",
                                       "resident", "bytes_used",
                                       "bytes_budget")}
            self._send_json(200, health)
            return
        if url.path == "/metrics":
            # the full Prometheus exposition content type (scrapers key
            # the text-format parser off version=0.0.4 + charset)
            self._send(200, self.server.metrics.render().encode(),
                       PROM_CONTENT_TYPE)
            return
        self._send_json(404, {"error": f"no route {url.path}"})

    # --------------------------------------------------------------- POST
    def do_POST(self):
        self._request_id = None  # no leak across keep-alive requests
        url = urlparse(self.path)
        # ALWAYS drain the body (read_request_body: keep-alive hygiene,
        # 411 chunked / 400 bad length / 413 reject-before-buffering)
        raw = read_request_body(self, self.server.pserver.max_body_bytes)
        if raw is None:
            return
        body = raw.decode("utf-8", "replace")
        if url.path == "/predict":
            self._predict(url, body)
            return
        if url.path == "/predict_by_id":
            self._predict_by_id(url, body)
            return
        if url.path in ("/featurestore/put", "/featurestore/invalidate"):
            # the mutating store routes pass the same drain admission
            # gate as predictions: a draining server must not accept
            # new device uploads, and in-flight ones must be visible to
            # the inflight counter the drain waits on
            ps: PredictServer = self.server.pserver
            if not ps.enter_request():
                self.close_connection = True
                self._send_json(503, {"error": "server is draining",
                                      "state": ps.state})
                return
            try:
                if url.path == "/featurestore/put":
                    self._featurestore_put(url, body)
                else:
                    self._featurestore_invalidate(url, body)
            finally:
                ps.exit_request()
            return
        if url.path == "/-/reload":
            # forced: bypasses the poisoned-fingerprint skip, so an
            # operator can retry after a TRANSIENT build failure.
            # ?model= scopes the reload to one catalog entry (the
            # per-tenant rollout path); bare = the default model
            reg = self._resolve_registry(url)
            if reg is None:
                return
            reloaded = reg.check_reload(force=True)
            self._send_json(200, {"reloaded": reloaded,
                                  "model_version": reg.version})
            return
        if url.path == "/-/rollback":
            reg = self._resolve_registry(url)
            if reg is None:
                return
            ok = reg.rollback()
            self._send_json(200 if ok else 409,
                            {"rolled_back": ok,
                             "model_version": reg.version})
            return
        if url.path == "/-/catalog":
            self._catalog_delta(body)
            return
        self._send_json(404, {"error": f"no route {url.path}"})

    def _catalog_delta(self, body: str) -> None:
        """Placer manifest delta: ``{"add": {name: path, ...},
        "remove": [name, ...]}``.  Attach is tolerant — a name the
        catalog already holds is skipped, not an error — so a placer
        retrying a push after a timeout converges instead of failing;
        attached models admit lazily on first resolve (or eagerly via a
        follow-up ``/-/reload?model=``).  Detach refuses the pinned
        default (409) and is idempotent for unknown names."""
        import os as _os
        from xgboost_tpu_torch.obs import event
        ps: PredictServer = self.server.pserver
        if ps.catalog is None:
            self._send_json(409, {"error": "no catalog on this replica"})
            return
        try:
            req = json.loads(body) if body.strip() else {}
            add = {str(k): str(v)
                   for k, v in dict(req.get("add") or {}).items()}
            remove = [str(n) for n in list(req.get("remove") or [])]
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        added, skipped, removed, errors = [], [], [], []
        for name, path in sorted(add.items()):
            if not _os.path.exists(path):
                errors.append(f"{name}: no model file at {path!r}")
                continue
            try:
                ps.catalog.add_model(name, path)
                added.append(name)
            except ValueError:
                # already attached (placer retry / concurrent push)
                skipped.append(name)
        for name in remove:
            try:
                if ps.catalog.remove_model(name):
                    removed.append(name)
            except ValueError as e:  # pinned default
                errors.append(str(e))
        if added or removed:
            event("serving.catalog_delta", added=added, removed=removed,
                  skipped=skipped, errors=len(errors))
        self._send_json(200 if not errors else 409,
                        {"added": added, "removed": removed,
                         "skipped": skipped, "errors": errors,
                         "models": ps.catalog.names()})

    # ------------------------------------------------------------ catalog
    def _resolve_entry(self, url, sp=None):
        """``(registry, batcher, entry)`` for the request's ``?model=``
        (entry is None on a catalog-less server).  On an unknown model
        a 404 naming the known set is already sent and ``(None, None,
        None)`` returns — mirroring the router's UnknownModel answer so
        clients see one shape fleet-wide."""
        from xgboost_tpu_torch.catalog import UnknownModel
        model = parse_qs(url.query).get("model", [""])[0]
        ps: PredictServer = self.server.pserver
        try:
            return ps.resolve_model(model)
        except UnknownModel as e:
            from xgboost_tpu_torch.obs.metrics import catalog_metrics
            catalog_metrics().unknown_model.inc()
            if sp is not None:
                sp.set("status", 404)
            self._send_json(404, {"error": str(e), "models": e.known})
            return None, None, None
        except Exception as e:
            # admission failed (bad model file, device OOM building the
            # engine): the model EXISTS but cannot serve right now
            if sp is not None:
                sp.set("status", 503)
            self._send_json(503, {"error": f"model {model!r} failed to "
                                           f"load: {e}"})
            return None, None, None

    def _resolve_registry(self, url, sp=None):
        reg, _, _ = self._resolve_entry(url, sp)
        return reg

    def _predict(self, url, body: str) -> None:
        # request tracing (OBSERVABILITY.md): the caller's X-Request-Id
        # (or a generated one) becomes the trace id for every span this
        # request produces, and is echoed on the response — including
        # the 503/400/500 branches — so client logs, server timeline
        # and response headers all correlate on one id
        rid = self.headers.get("X-Request-Id") or trace.new_id()
        self._request_id = rid
        ps: PredictServer = self.server.pserver
        if not ps.enter_request():
            # draining: load balancers read the 503 as "instance going
            # away", retry elsewhere; requests already in flight finish
            self.close_connection = True
            self._send_json(503, {"error": "server is draining",
                                  "state": ps.state})
            return
        try:
            with trace_context(rid):
                with span("serve.request", request_id=rid) as sp:
                    self._predict_admitted(url, body, sp)
        finally:
            ps.exit_request()

    def _deadline_reject(self, reason: str, dl, sp=None) -> None:
        """504 a request whose budget cannot buy useful work — BEFORE
        any parsing/device cost is spent on it (admission by deadline,
        RELIABILITY.md stall matrix).  Counter-backed so 'rejected
        early ≫ completed late' is assertable from /metrics."""
        from xgboost_tpu_torch.profiling import reliability_metrics
        reliability_metrics().deadline_rejected.inc()
        if sp is not None:
            sp.set("status", 504)
        self._send_json(504, {
            "error": reason, "deadline_exceeded": True,
            "remaining_ms": dl.describe_ms() if dl is not None else 0})

    def _predict_admitted(self, url, body: str, sp=None) -> None:
        def _st(code: int) -> None:
            if sp is not None:
                sp.set("status", code)
        ps: PredictServer = self.server.pserver
        dl = Deadline.from_headers(self.headers)
        if dl is not None and dl.expired():
            # spent before we even parse: the router's stamp (or the
            # client's) says nobody is waiting for this answer
            self._deadline_reject("deadline expired on arrival", dl, sp)
            return
        # model resolution BEFORE body parsing: admission of a cold
        # catalog entry (engine build + warmup) is the expensive step,
        # and an unknown model must 404 without paying any parse cost
        reg, batcher, entry = self._resolve_entry(url, sp)
        if reg is None:
            return
        if sp is not None and entry is not None:
            sp.set("model", entry.name)
        try:
            qs = parse_qs(url.query)
            fmt = qs.get("format", [None])[0]
            if fmt is None:
                ctype = (self.headers.get("Content-Type") or "").lower()
                fmt = "libsvm" if "libsvm" in ctype else "csv"
            output_margin = qs.get("output_margin", ["0"])[0] in ("1", "true")
            if fmt == "libsvm":
                X = parse_libsvm_rows(body, reg.engine.num_feature)
            elif fmt == "csv":
                X = parse_csv_rows(body)
            else:
                _st(400)
                self._send_json(400, {"error": f"unknown format {fmt!r}"})
                return
            if X.shape[0] == 0:
                _st(400)
                self._send_json(400, {"error": "no rows in request body"})
                return
        except Exception as e:
            _st(400)
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        if sp is not None:
            sp.set("rows", int(X.shape[0]))
        if dl is not None:
            # admission by deadline: when the remaining budget cannot
            # cover this row-bucket's OBSERVED service time, a 504 now
            # beats device work whose answer lands after the caller
            # hung up (the stall analog of reject-don't-buffer)
            est = ps.service_estimate(int(X.shape[0]))
            if est > 0.0 and dl.remaining() < est:
                # anti-latch: only completed predicts refresh the EWMA,
                # so an estimate inflated by a past backlog could
                # otherwise reject this bucket FOREVER once it exceeds
                # every client's budget — each rejection decays it
                # until requests are admitted and real observations
                # take over
                ps.decay_service(int(X.shape[0]))
                self._deadline_reject(
                    f"remaining budget {dl.describe_ms()}ms cannot "
                    f"cover observed service time {est * 1e3:.1f}ms",
                    dl, sp)
                return
        # chaos seam: `slow_replica` (keyed on this replica's fleet id,
        # like the lease client's heartbeat_loss/replica_kill) wedges
        # the predict path without killing anything — the
        # latency-ejection machinery must route around it
        from xgboost_tpu_torch.reliability import faults
        wedge = faults.delay_for(
            "slow_replica",
            path=(ps.lease_client.replica_id
                  if ps.lease_client is not None else None))
        if wedge > 0.0:
            time.sleep(wedge)
        t_submit = time.perf_counter()
        try:
            preds = batcher.submit(X, output_margin=output_margin,
                                   deadline=dl,
                                   tenant=(entry.name if entry is not None
                                           else ""))
        except QueueFull as e:
            _st(503)
            self._send_json(503, {"error": str(e)})
            return
        except DeadlineExceeded as e:
            # expired in the queue (dropped pre-dispatch) or while
            # waiting: no result exists and none was paid for
            _st(504)
            self._send_json(504, {"error": str(e),
                                  "deadline_exceeded": True})
            return
        except ValueError as e:
            # deterministic client-input errors surfaced by the engine
            # (e.g. more columns than model features) are 400s, not
            # server faults — keeps 5xx alerting honest
            _st(400)
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:
            _st(500)
            self._send_json(500, {"error": str(e)})
            return
        ps.observe_service(int(X.shape[0]),
                           time.perf_counter() - t_submit)
        # the version that actually PRODUCED these predictions (tagged
        # by the registry; reg.version may have moved during a reload)
        version = getattr(preds, "model_version", reg.version)
        _st(200)
        if sp is not None:
            sp.set("model_version", int(version))
        resp = {"predictions": np.asarray(preds).tolist(),
                "model_version": version,
                "rows": int(X.shape[0])}
        if entry is not None:
            resp["model"] = entry.name
        self._send_json(200, resp)


    # -------------------------------------------------- feature store
    def _entry_store(self, entry):
        """The FeatureStore serving ``entry`` (the default model rides
        the server-level store; other catalog entries own per-model
        stores), or None + a 404 already sent."""
        ps: PredictServer = self.server.pserver
        if entry is None or (ps.catalog is not None
                             and entry.name == ps.catalog.default):
            store = (ps.featurestore_for()
                     if ps.featurestore is not None else None)
        else:
            store = entry.featurestore_for()
        if store is None:
            self._send_json(404, {
                "error": "feature store disabled "
                         "(start with serve_featurestore_mb > 0)"})
        return store

    def _predict_by_id(self, url, body: str) -> None:
        """Zero-upload prediction for device-resident entities: the
        repeat-traffic fast path (SERVING.md feature store)."""
        rid = self.headers.get("X-Request-Id") or trace.new_id()
        self._request_id = rid
        ps: PredictServer = self.server.pserver
        if not ps.enter_request():
            self.close_connection = True
            self._send_json(503, {"error": "server is draining",
                                  "state": ps.state})
            return
        try:
            with trace_context(rid):
                with span("serve.request", request_id=rid,
                          by_id=True) as sp:
                    self._predict_by_id_admitted(url, body, sp)
        finally:
            ps.exit_request()

    def _predict_by_id_admitted(self, url, body: str, sp=None) -> None:
        from xgboost_tpu_torch.serving.featurestore import (FeatureStoreMiss,
                                                      predict_by_id)

        def _st(code: int) -> None:
            if sp is not None:
                sp.set("status", code)
        dl = Deadline.from_headers(self.headers)
        if dl is not None and dl.expired():
            self._deadline_reject("deadline expired on arrival", dl, sp)
            return
        reg, _, entry = self._resolve_entry(url, sp)
        if reg is None:
            return
        if sp is not None and entry is not None:
            sp.set("model", entry.name)
        store = self._entry_store(entry)
        if store is None:
            _st(404)
            return
        try:
            qs = parse_qs(url.query)
            output_margin = qs.get("output_margin",
                                   ["0"])[0] in ("1", "true")
            req = json.loads(body)
            ids = req["ids"]
            if not isinstance(ids, list) or not ids:
                raise ValueError("'ids' must be a non-empty list")
            om = req.get("output_margin", output_margin)
            # same truthiness contract as the query string: "0"/"false"
            # must DISABLE margins (bool("0") is True)
            output_margin = (om is True or om == 1
                             or str(om).lower() in ("1", "true"))
        except (ValueError, KeyError, TypeError) as e:
            _st(400)
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        if sp is not None:
            sp.set("rows", len(ids))
        # (version, engine) resolved atomically: the response names the
        # model that actually ran, across hot-reloads — and a reload's
        # new cuts rebin the SAME resident raw rows on device.  A
        # reload that changed the FEATURE WIDTH swaps the store (empty,
        # same budget): these ids then 404 as misses, not shape errors
        version, engine = reg.current()
        store = self._entry_store(entry)
        if store is None:
            _st(404)
            return
        if store.num_feature != engine.num_feature:
            # the engine snapshot raced a width-changing reload:
            # re-resolve once (the store swap keyed on the registry's
            # CURRENT engine, so the fresh snapshot matches it)
            version, engine = reg.current()
        if store.num_feature != engine.num_feature:
            _st(503)
            self._send_json(503, {
                "error": "model reloading (feature width changed) — "
                         "retry"})
            return
        try:
            preds = predict_by_id(engine, store, ids,
                                  output_margin=output_margin)
        except FeatureStoreMiss as e:
            _st(404)
            self._send_json(404, {"error": str(e), "missing": e.missing})
            return
        except Exception as e:
            _st(500)
            self._send_json(500, {"error": str(e)})
            return
        _st(200)
        if sp is not None:
            sp.set("model_version", int(version))
        resp = {"predictions": np.asarray(preds).tolist(),
                "model_version": version,
                "rows": len(ids)}
        if entry is not None:
            resp["model"] = entry.name
        self._send_json(200, resp)

    def _featurestore_put(self, url, body: str) -> None:
        reg, _, entry = self._resolve_entry(url)
        if reg is None:
            return
        # puts validate against the CURRENT model's width (a width-
        # changing hot-reload swaps in a fresh store of the new width)
        store = self._entry_store(entry)
        if store is None:
            return
        try:
            req = json.loads(body)
            ids, rows = req["ids"], req["rows"]
            if (not isinstance(ids, list) or not ids
                    or not isinstance(rows, list)):
                raise ValueError("'ids' and 'rows' must be lists")
            X = np.asarray(rows, np.float32)
            res = store.put(ids, X)
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        except Exception as e:
            # device failure during the upload/scatter: put committed
            # nothing (staged slot math) — surface it, don't drop the
            # socket with a handler traceback
            self._send_json(500, {"error": str(e)})
            return
        res.update(store.describe())
        self._send_json(200, res)

    def _featurestore_invalidate(self, url, body: str) -> None:
        reg, _, entry = self._resolve_entry(url)
        if reg is None:
            return
        store = self._entry_store(entry)
        if store is None:
            return
        try:
            req = json.loads(body) if body.strip() else {}
            if req.get("all"):
                dropped = store.invalidate()
            else:
                ids = req.get("ids")
                if not isinstance(ids, list) or not ids:
                    raise ValueError(
                        "pass {'ids': [...]} or {'all': true}")
                dropped = store.invalidate(ids)
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return
        self._send_json(200, {"invalidated": dropped,
                              "resident_rows": len(store)})


class PredictServer:
    """Bundles registry + batcher + metrics behind ThreadingHTTPServer.

    ``port=0`` binds an ephemeral port (tests); the bound port is on
    ``self.port``.  Use :meth:`start` for a background thread or
    :meth:`serve_forever` to block.

    Lifecycle is a drain state machine: ``serving`` (admitting
    ``/predict``) -> ``draining`` (new predictions get 503, in-flight
    ones finish, ``/healthz`` still answers) -> ``stopped``.  SIGTERM
    triggers it when :meth:`serve_forever` runs on the main thread;
    :meth:`drain` triggers it programmatically.
    """

    def __init__(self, registry: ModelRegistry, batcher: MicroBatcher,
                 metrics, host: str = "127.0.0.1", port: int = 8080,
                 quiet: bool = True, drain_grace: float = 30.0,
                 max_body_mb: float = 64.0, featurestore=None,
                 catalog=None):
        self.registry = registry
        self.batcher = batcher
        self.metrics = metrics
        # optional ModelCatalog (xgboost_tpu_torch.catalog): N named models on
        # this replica, resolved by ?model=.  registry/batcher above stay
        # the DEFAULT entry's — every existing single-model caller sees
        # the same attributes whether or not a catalog is attached
        self.catalog = catalog
        # optional device-resident FeatureStore (serving/featurestore.py)
        # backing /predict_by_id and the /featurestore/* admin routes;
        # access through featurestore_for() on model-facing paths so a
        # hot-reload that CHANGES THE FEATURE WIDTH swaps in a fresh
        # store instead of feeding wrong-width rows to the new engine
        self.featurestore = featurestore
        self._fs_lock = threading.Lock()
        # per-row-bucket EWMA of observed predict service time (submit
        # -> result), feeding admission-by-deadline: a request whose
        # remaining budget is below its bucket's estimate is 504'd
        # before any device work (reliability/deadline.py)
        self._svc_lock = threading.Lock()
        self._svc_ewma: dict = {}
        self.drain_grace = float(drain_grace)
        self.max_body_bytes = int(max_body_mb * (1 << 20))
        # fleet membership (attach_fleet): registration/heartbeat lease
        # client against a fleet router; None = standalone replica
        self.lease_client = None
        # /healthz uptime_seconds: perf_counter — uptime is a duration,
        # and an NTP step must not make it jump (XGT006)
        self.t0 = time.perf_counter()
        self.state = "serving"          # serving -> draining -> stopped
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._shut = False
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        # handler threads must not be able to pin the process: a wedged
        # device call (the case the drain grace exists for) leaves its
        # handler blocked in batcher.submit() forever, and non-daemon
        # threads would keep the interpreter alive after main returns
        self._httpd.daemon_threads = True
        self._httpd.registry = registry
        self._httpd.batcher = batcher
        self._httpd.metrics = metrics
        self._httpd.quiet = quiet
        self._httpd.pserver = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ catalog
    def resolve_model(self, name: str = ""):
        """``(registry, batcher, entry)`` serving model ``name`` (the
        default model when empty).  Without a catalog only the bare
        path exists — a named model raises UnknownModel (the handler's
        404).  With one, a cold entry is admitted on demand (engine
        build + warmup happen on THIS request's thread; hot models are
        a dict probe)."""
        if self.catalog is None:
            if name:
                from xgboost_tpu_torch.catalog import UnknownModel
                raise UnknownModel(name, [])
            return self.registry, self.batcher, None
        entry = self.catalog.resolve(name)
        return entry.registry, entry.batcher, entry

    # ------------------------------------------------------ feature store
    def featurestore_for(self):
        """The live FeatureStore, re-created (same byte budget, empty)
        when the registry's CURRENT engine has a different feature
        width than the store.

        Raw-row storage makes cut/max_bin hot-reloads free (the next
        predict_by_id rebins resident rows on device), but a reload to
        a DIFFERENT FEATURE COUNT makes every resident row meaningless
        for the new model — the swap drops them, and callers see
        404-miss (re-``put`` with new-width features), never a
        shape-mismatched executable call.  The swap keys on the
        registry's current engine, NOT any caller's resolved snapshot:
        a request still in flight across the reload must not wipe a
        store that has already been re-populated at the new width."""
        store = self.featurestore
        if store is None:
            return None
        width = self.registry.engine.num_feature
        if store.num_feature == width:
            return store
        with self._fs_lock:
            store = self.featurestore
            width = self.registry.engine.num_feature
            if store.num_feature != width:
                from xgboost_tpu_torch.obs.metrics import featurestore_metrics
                from xgboost_tpu_torch.serving.featurestore import FeatureStore
                store = FeatureStore(
                    width, budget_mb=store.budget_bytes / (1 << 20),
                    device=self.registry.engine.device)
                self.featurestore = store
                featurestore_metrics().resident_bytes.set(0)
        return store

    # ---------------------------------------------------- service estimate
    @staticmethod
    def _svc_bucket(rows: int) -> int:
        """Power-of-two row bucket for the service-time EWMA — mirrors
        the engine's shape-bucket ladder without coupling to it."""
        b = 1
        while b < rows:
            b <<= 1
        return b

    def observe_service(self, rows: int, seconds: float) -> None:
        """Fold one completed predict into its bucket's service-time
        EWMA (alpha 0.2: stable against one slow batch, responsive to a
        real shift)."""
        key = self._svc_bucket(max(1, int(rows)))
        with self._svc_lock:
            prev = self._svc_ewma.get(key)
            self._svc_ewma[key] = (seconds if prev is None
                                   else 0.8 * prev + 0.2 * seconds)

    def service_estimate(self, rows: int) -> float:
        """Expected service seconds for a request of ``rows`` rows
        (its bucket's EWMA, or — when its bucket has no samples — the
        largest EWMA among smaller buckets as a floor).  0.0 = no
        observations yet — admission stays open until the estimate
        exists, so a cold replica never rejects."""
        key = self._svc_bucket(max(1, int(rows)))
        with self._svc_lock:
            if key in self._svc_ewma:
                return self._svc_ewma[key]
            smaller = [v for k, v in self._svc_ewma.items() if k < key]
        return max(smaller) if smaller else 0.0

    def decay_service(self, rows: int, factor: float = 0.95) -> None:
        """Walk an estimate down on every admission rejection it
        causes: rejections produce no completions, so without this a
        backlog-inflated estimate above every caller's budget would
        latch the bucket into rejecting forever.  Decays the bucket
        that actually SUPPLIED the estimate — the request's own, or
        the smaller bucket whose EWMA served as its floor (decaying
        only the absent request bucket would be a no-op and the latch
        would stand)."""
        key = self._svc_bucket(max(1, int(rows)))
        with self._svc_lock:
            if key not in self._svc_ewma:
                smaller = [k for k in self._svc_ewma if k < key]
                if not smaller:
                    return
                key = max(smaller, key=lambda k: self._svc_ewma[k])
            self._svc_ewma[key] *= factor

    # -------------------------------------------------------------- fleet
    def attach_fleet(self, router_url: str,
                     replica_id: Optional[str] = None,
                     advertise_url: str = "",
                     on_kill=None) -> None:
        """Join a fleet (SERVING.md fleet section): register with the
        router at ``router_url`` and keep a heartbeat lease alive.  The
        lease client starts with :meth:`start`/:meth:`serve_forever`
        and deregisters when the drain begins, so a draining replica
        leaves rotation BEFORE it starts 503ing (the router's health
        checker is the backstop for crashes).  ``replica_id`` defaults
        to ``host:port`` — a restarted replica re-registering under its
        old id is the tracker ``recover`` path."""
        from xgboost_tpu_torch.fleet.membership import LeaseClient
        rid = replica_id or f"{self.host}:{self.port}"
        # the ADVERTISED endpoint is what the router dials — a wildcard
        # bind (0.0.0.0/::) is reachable locally but unroutable from
        # the router's side, so cross-host replicas must say where they
        # actually live (serve_advertise_url)
        self_url = (advertise_url.rstrip("/") if advertise_url
                    else f"http://{self.host}:{self.port}")
        if not advertise_url and self.host in ("0.0.0.0", "::", ""):
            print(f"[fleet] WARNING: advertising wildcard bind "
                  f"{self_url} to the router — unroutable from other "
                  "hosts; set serve_advertise_url", file=sys.stderr)
        self.lease_client = LeaseClient(
            router_url, rid, self_url,
            model_path=self.registry.path,
            model_hash_fn=lambda: self.registry.content_hash,
            # catalog advertisement: every heartbeat carries the model
            # set (name -> path/hash) so the router can route ?model=
            # to replicas that actually HOST the model
            models_fn=(self.catalog.models
                       if self.catalog is not None else None),
            # device budget advertisement: the placer bin-packs tenant
            # models against (budget - used) per replica; the used bytes
            # are the card's, each engine's CUDA-graph pools included
            device_fn=(
                (lambda: {"budget_bytes": self.catalog.budget_bytes,
                          "used_bytes": self.catalog.bytes_used()})
                if self.catalog is not None else None),
            on_kill=on_kill)

    # -------------------------------------------------------- drain state
    @property
    def inflight(self) -> int:
        return self._inflight

    def enter_request(self) -> bool:
        """Admission check + in-flight count, one atomic step (a drain
        that begins between the two could otherwise miss a request).
        False = draining/stopped, caller answers 503."""
        with self._inflight_cv:
            if self.state != "serving":
                return False
            self._inflight += 1
            return True

    def exit_request(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def drain(self, grace: Optional[float] = None) -> float:
        """Stop admitting predictions, wait (bounded by ``grace``) for
        in-flight ones to finish, then shut down.  Returns the drain
        duration in seconds (also on the ``drain_seconds`` gauge)."""
        from xgboost_tpu_torch.profiling import reliability_metrics
        grace = self.drain_grace if grace is None else float(grace)
        t0 = time.perf_counter()
        deadline = t0 + grace
        if self.lease_client is not None:
            # leave the fleet FIRST: the router stops dispatching here
            # before this replica starts answering 503 (requests already
            # routed ride the retry path)
            self.lease_client.stop(deregister=True)
        with self._inflight_cv:
            if self.state == "serving":
                self.state = "draining"
            while self._inflight > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    print(f"[serving] drain grace ({grace:.1f}s) expired "
                          f"with {self._inflight} request(s) in flight",
                          file=sys.stderr)
                    # the stragglers are wedged (their submit() has no
                    # timeout); joining their daemon threads would block
                    # forever and defeat the grace bound — skip the join
                    # and let process exit reap them
                    self._httpd.block_on_close = False
                    break
                self._inflight_cv.wait(left)
        # the gauge lands BEFORE the listener closes, so a last /metrics
        # scrape during the drain can observe it (and once more after,
        # with the total, for embedders holding the object)
        reliability_metrics().drain_seconds.set(time.perf_counter() - t0)
        self.shutdown()
        dur = time.perf_counter() - t0
        reliability_metrics().drain_seconds.set(dur)
        from xgboost_tpu_torch.obs import event
        event("serving.drain", grace=grace, duration_s=round(dur, 3),
              stragglers=self._inflight)
        return dur

    def _handle_sigterm(self, signum, frame) -> None:
        # runs on the main thread, which is inside serve_forever's
        # select loop: the actual drain+shutdown must happen elsewhere
        # (shutdown() blocks until that very loop exits)
        print("[serving] SIGTERM: draining (in-flight requests finish, "
              "new /predict gets 503)", file=sys.stderr)
        threading.Thread(target=self.drain, daemon=True,
                         name="xgbtpu-drain").start()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "PredictServer":
        self.registry.start()
        if self.catalog is not None:
            self.catalog.start()  # idempotent for the default registry
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="xgbtpu-http")
        self._thread.start()
        if self.lease_client is not None:
            self.lease_client.start()
        return self

    def serve_forever(self) -> None:
        self.registry.start()
        if self.catalog is not None:
            self.catalog.start()
        if threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGTERM, self._handle_sigterm)
            except ValueError:
                pass  # exotic embedding; drain() stays available
        if self.lease_client is not None:
            self.lease_client.start()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        with self._inflight_cv:
            if self._shut:
                return
            self._shut = True
            self.state = "stopped"
        if self.lease_client is not None:
            self.lease_client.stop(deregister=True)
        self.registry.stop()
        if self.catalog is not None:
            self.catalog.stop()  # re-stop of the default entry is a no-op
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


def run_server(model_path: str = "", host: str = "127.0.0.1",
               port: int = 8080,
               min_bucket: int = 8, max_bucket: int = 8192,
               max_batch_rows: int = 1024, max_wait_ms: float = 2.0,
               max_queue_rows: int = 8192, poll_sec: float = 1.0,
               keep_versions: int = 2, warmup: bool = True,
               drain_sec: float = 30.0, max_body_mb: float = 64.0,
               featurestore_mb: float = 0.0,
               catalog: str = "", catalog_default: str = "",
               catalog_mb: float = 0.0,
               catalog_hysteresis_sec: float = 3.0,
               router_url: str = "", replica_id: str = "",
               advertise_url: str = "",
               quiet: bool = False,
               block: bool = True, device=None) -> Optional[PredictServer]:
    """Build the full serving stack and run it.

    Every server is a catalog server: ``model_path`` alone is a
    catalog of one (entry name ``default``, bare ``/predict`` hits
    it — byte-identical behavior to the pre-catalog stack).
    ``catalog`` adds named models (inline ``name=path,...`` or a
    manifest file, see :func:`xgboost_tpu_torch.catalog.parse_manifest`),
    all admitted under one ``catalog_mb`` device budget with
    LRU-evict + ``catalog_hysteresis_sec`` anti-thrash;
    ``catalog_default`` picks which entry bare requests resolve to.

    ``featurestore_mb > 0`` attaches a device-resident
    :class:`~xgboost_tpu_torch.serving.featurestore.FeatureStore` of that
    byte budget PER MODEL, enabling ``POST /predict_by_id``
    (zero-upload repeat traffic) and the ``/featurestore/*`` admin
    routes.

    ``router_url`` joins a fleet (xgboost_tpu_torch.fleet): the replica
    registers with the router there, heartbeats a lease (advertising
    its model set and its device bytes), and deregisters when draining.

    ``device`` is where every engine runs: ``"cuda"`` (the default,
    raising without a GPU) or ``"cpu"``.

    With ``block=False`` the server runs on a background thread and the
    :class:`PredictServer` is returned (tests, embedding)."""
    from xgboost_tpu_torch.catalog import ModelCatalog, parse_manifest
    from xgboost_tpu_torch.profiling import ServingMetrics
    metrics = ServingMetrics()
    manifest = parse_manifest(catalog) if catalog else {}
    default_name = catalog_default or ("default" if model_path
                                       else next(iter(manifest), ""))
    paths = dict(manifest)
    if model_path:
        # an explicit model_in IS the default model, even when the
        # manifest also names one under default_name
        paths[default_name] = model_path
    if not paths:
        raise ValueError("run_server needs model_in or a catalog= "
                         "manifest")
    if default_name not in paths:
        raise ValueError(f"catalog_default {default_name!r} is not in "
                         f"the catalog (holds: {sorted(paths)})")

    def registry_factory(path):
        return ModelRegistry(path, keep_versions=keep_versions,
                             warmup=warmup, poll_sec=poll_sec,
                             metrics=metrics, min_bucket=min_bucket,
                             max_bucket=max_bucket, device=device)

    def batcher_factory(reg):
        return MicroBatcher(reg.predict, max_batch_rows=max_batch_rows,
                            max_wait_ms=max_wait_ms,
                            max_queue_rows=max_queue_rows,
                            metrics=metrics)

    registry = registry_factory(paths[default_name])
    batcher = batcher_factory(registry)
    store = None
    if featurestore_mb > 0:
        from xgboost_tpu_torch.serving.featurestore import FeatureStore
        store = FeatureStore(registry.engine.num_feature,
                             budget_mb=featurestore_mb,
                             device=registry.engine.device)
    cat = ModelCatalog(budget_mb=catalog_mb,
                       hysteresis_sec=catalog_hysteresis_sec,
                       default=default_name,
                       registry_factory=registry_factory,
                       batcher_factory=batcher_factory)
    cat.add_model(default_name, paths[default_name], registry=registry,
                  batcher=batcher, featurestore_mb=featurestore_mb)
    for name, path in paths.items():
        if name != default_name:
            cat.add_model(name, path, featurestore_mb=featurestore_mb)
    if warmup:
        # admit the whole manifest up front — compiles land at startup,
        # not on first traffic; past the budget the LRU tail re-evicts
        # once it ages out of the hysteresis window
        for name in cat.names():
            if name != default_name:
                try:
                    cat.resolve(name)
                except Exception as e:
                    print(f"[serving] WARNING: model {name!r} failed to "
                          f"warm: {e} (will retry on first request)",
                          file=sys.stderr)
    server = PredictServer(registry, batcher, metrics, host=host, port=port,
                           quiet=quiet, drain_grace=drain_sec,
                           max_body_mb=max_body_mb, featurestore=store,
                           catalog=cat)
    if router_url:
        server.attach_fleet(router_url, replica_id=replica_id or None,
                            advertise_url=advertise_url)
    if not quiet:
        eng = registry.engine
        print(f"[serving] model {paths[default_name]} "
              f"(v{registry.version}, "
              f"{eng.gbtree.num_trees} trees, {eng.num_feature} features, "
              f"{eng.device}) "
              f"on http://{server.host}:{server.port} — buckets "
              f"{eng.buckets}"
              + (f"; catalog of {len(cat)} "
                 f"(default {default_name!r})" if len(cat) > 1 else ""),
              file=sys.stderr)
    if block:
        server.serve_forever()
        return None
    return server.start()
