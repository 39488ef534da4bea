"""Training-side metrics endpoint: ``/metrics`` + ``/healthz`` from a
daemon thread (port of ``xgboost_tpu/obs/server.py``, the same routes and
bodies).

The serving stack has always been scrapeable; a multi-hour TRAINING run
was dark.  ``metrics_port=`` (CLI) or :func:`start_metrics_server`
starts a stdlib HTTP server on a daemon thread that renders the
process-wide :func:`~xgboost_tpu_torch.obs.metrics.registry` — training
progress, per-phase seconds, reliability counters,
and any in-process serving metrics — in the Prometheus text exposition
format.  ``port=0`` binds an ephemeral port (printed, and on
``server.port``); under the multi-host launcher each rank serves its
own process's registry (rank r binds ``metrics_port + r``), which is
how per-rank collective stats are exported.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # header/body go out as two writes: without TCP_NODELAY the body
    # stalls ~40 ms behind the delayed ACK (same fix as serving/http.py)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # metrics scrapes stay quiet
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        from xgboost_tpu_torch.obs.metrics import registry, training_metrics
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, registry().render().encode(),
                       PROM_CONTENT_TYPE)
            return
        if path == "/healthz":
            tm = training_metrics()
            body = json.dumps({
                "status": "ok",
                "uptime_seconds": round(
                    time.perf_counter() - self.server.obs_t0, 3),
                "rounds_completed": int(tm.rounds.value),
                "round": int(tm.round.value),
                "rank": self.server.obs_rank,
            }).encode()
            self._send(200, body, "application/json")
            return
        self._send(404, json.dumps(
            {"error": f"no route {path}"}).encode(), "application/json")

    def do_POST(self):
        # the training metrics endpoint is read-only; an unknown POST
        # gets the same JSON 404 body every handler in the tree sends
        # (the stdlib default would be a 501 HTML page) — the route
        # sweep's consistency contract of the JAX package's
        # tests/test_analysis_contracts.py.  The body is drained
        # (bounded) so a keep-alive client's next request line is not
        # parsed out of the unread payload.
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            length = 0
        if length > 0:
            self.rfile.read(min(length, 1 << 20))
        self.close_connection = True
        path = self.path.split("?", 1)[0]
        self._send(404, json.dumps(
            {"error": f"no route {path}"}).encode(), "application/json")


class MetricsServer:
    """Bind + serve the registry from a daemon thread (``stop()`` to
    close; the thread dies with the process otherwise)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 rank: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.obs_t0 = time.perf_counter()  # uptime = duration
        self._httpd.obs_rank = rank
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="xgbtpu-obs-metrics")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)


_server: Optional[MetricsServer] = None
_lock = threading.Lock()


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         rank: int = 0) -> MetricsServer:
    """Start (or return the already-running) process-wide metrics
    server.  Eagerly creates the training and reliability metric groups
    so a scrape that lands before the first round still sees the
    families."""
    global _server
    with _lock:
        if _server is None:
            from xgboost_tpu_torch.obs.metrics import (reliability_metrics,
                                                 training_metrics)
            training_metrics()
            reliability_metrics()
            _server = MetricsServer(port=port, host=host, rank=rank)
        return _server


def get_metrics_server() -> Optional[MetricsServer]:
    return _server


def stop_metrics_server() -> None:
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None
