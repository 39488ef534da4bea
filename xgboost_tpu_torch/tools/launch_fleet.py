#!/usr/bin/env python
"""Launch a local serving fleet: N replica processes + the router (port
of ``tools/launch_fleet.py``).

One command brings up the fleet router (in this process) and N replica
subprocesses (``python -m xgboost_tpu_torch task=serve
serve_router_url=... device=cuda``), each serving its OWN copy of the
model file (so canary rollouts stage per replica), with keepalive — a
replica that dies is restarted and re-registers under its old id (the
tracker ``recover`` path).  Replicas run on the GPU unless
``--device cpu``; every replica of one host shares its card, each with
its own CUDA-graph pools.

Usage::

    python xgboost_tpu_torch/tools/launch_fleet.py \
        --model m.bin --replicas 3 --port 8000 [--device cpu]

Ctrl-C drains: replicas get SIGTERM (their drain state machine
finishes in-flight requests and deregisters), then the router stops.

The :class:`FleetLauncher` class is importable.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.request
from typing import Dict, List, Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)


class RetryingPredictClient:
    """Keep-alive ``POST /predict`` client for fleet drivers.

    A reset/close on a REUSED keep-alive connection is the standard
    retry-safe race (RFC 7230 §6.3.1): every real HTTP client retries
    an idempotent request once on a fresh connection.  A second
    transport failure is a REAL failure.  Non-200 responses close the
    connection (the server does too) and reconnect lazily."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 path: str = "/predict"):
        import http.client
        from urllib.parse import urlparse
        p = urlparse(base_url)
        self._host, self._port = p.hostname, p.port
        self._timeout = timeout
        self._path = path  # e.g. "/predict?model=b" for catalog tenants
        self._http = http.client
        self._conn = self._connect()

    def _connect(self):
        return self._http.HTTPConnection(self._host, self._port,
                                         timeout=self._timeout)

    def post(self, body: bytes, headers=None):
        """-> (status, detail).  status None = transport failure after
        the one retry (detail = error string); non-200 statuses carry a
        response-body excerpt in detail; 200 -> (200, None)."""
        for attempt in range(2):
            try:
                self._conn.request("POST", self._path, body=body,
                                   headers=headers or {})
                r = self._conn.getresponse()
                out = r.read()
            except OSError as e:
                self._conn.close()
                self._conn = self._connect()
                if attempt:
                    return None, f"{type(e).__name__}: {e}"
                continue
            if r.status != 200:
                self._conn.close()
                self._conn = self._connect()
                return r.status, out[:120].decode("utf-8", "replace")
            return 200, None
        return None, "unreachable"

    def close(self) -> None:
        self._conn.close()


class FleetLauncher:
    """Owns one local fleet: an in-process router + replica
    subprocesses, with per-replica model-file copies and optional
    keepalive restarts."""

    def __init__(self, model_path: str, replicas: int = 3,
                 workdir: str = ".fleet", host: str = "127.0.0.1",
                 port: int = 0, featurestore_mb: float = 0.0,
                 serve_args: Optional[List[str]] = None,
                 router_kwargs: Optional[dict] = None,
                 quiet: bool = True, shared_model: bool = False,
                 replica_faults: Optional[Dict[int, str]] = None,
                 device: str = "cuda"):
        self.model_path = model_path
        # where every replica's engines run (the router does no device
        # work): one card shared by the host's replicas, or the CPU
        self.device = device
        # shared_model: every replica polls the SAME file (the
        # continuous-training pipeline's publish path) instead of a
        # per-replica copy — the blind-swap reload lane, where one
        # atomic publish hot-reloads the whole fleet (PIPELINE.md);
        # per-replica copies remain the default (canary rollouts stage
        # per replica)
        self.shared_model = bool(shared_model)
        self.n = int(replicas)
        self.workdir = workdir
        self.host = host
        self.featurestore_mb = featurestore_mb
        self.serve_args = list(serve_args or [])
        self.router_kwargs = dict(router_kwargs or {})
        self.quiet = quiet
        # per-replica XGBTPU_FAULTS specs (reliability/faults.py):
        # chaos drivers arm e.g. slow_replica on ONE replica subprocess
        # while its siblings stay healthy
        self.replica_faults = dict(replica_faults or {})
        self.router = None
        self.procs: Dict[int, subprocess.Popen] = {}
        self.restarts = 0
        self._port = port

    # ----------------------------------------------------------- plumbing
    @property
    def url(self) -> str:
        return f"http://{self.router.host}:{self.router.port}"

    def replica_model(self, i: int) -> str:
        if self.shared_model:
            return self.model_path
        return os.path.join(self.workdir, f"replica-{i}", "model.bin")

    def _replica_cmd(self, i: int) -> List[str]:
        return [sys.executable, "-m", "xgboost_tpu_torch", "task=serve",
                f"device={self.device}",
                f"model_in={self.replica_model(i)}", "serve_port=0",
                f"serve_host={self.host}",
                f"serve_router_url={self.url}",
                f"serve_replica_id=r{i}",
                f"serve_featurestore_mb={self.featurestore_mb}",
                "silent=1"] + self.serve_args

    def spawn(self, i: int) -> subprocess.Popen:
        log = open(os.path.join(self.workdir, f"replica-{i}.log"), "ab")
        env = dict(os.environ)
        if i in self.replica_faults:
            env["XGBTPU_FAULTS"] = self.replica_faults[i]
        p = subprocess.Popen(self._replica_cmd(i), stdout=log, stderr=log,
                             env=env, cwd=_ROOT)
        log.close()  # the child holds its own fd
        self.procs[i] = p
        return p

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "FleetLauncher":
        from xgboost_tpu_torch.fleet import run_router
        os.makedirs(self.workdir, exist_ok=True)
        for i in range(self.n):
            if self.shared_model:
                continue  # all replicas poll model_path itself
            os.makedirs(os.path.dirname(self.replica_model(i)),
                        exist_ok=True)
            shutil.copyfile(self.model_path, self.replica_model(i))
        self.router = run_router(host=self.host, port=self._port,
                                 quiet=self.quiet, block=False,
                                 **self.router_kwargs)
        for i in range(self.n):
            self.spawn(i)
        return self

    def members(self) -> dict:
        with urllib.request.urlopen(self.url + "/fleet/members",
                                    timeout=5) as r:
            return json.load(r)

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 120.0) -> int:
        """Block until ``n`` replicas are in rotation (default: all)."""
        want = self.n if n is None else n
        deadline = time.perf_counter() + timeout
        got = 0
        while time.perf_counter() < deadline:
            try:
                got = self.members()["in_rotation"]
            except OSError:
                got = 0
            if got >= want:
                return got
            time.sleep(0.25)
        raise TimeoutError(
            f"fleet not ready: {got}/{want} replicas in rotation "
            f"after {timeout}s (see {self.workdir}/replica-*.log)")

    # ------------------------------------------------------------ elastic
    def live_indices(self) -> List[int]:
        return [i for i, p in self.procs.items() if p.poll() is None]

    def count(self) -> int:
        return len(self.live_indices())

    def spawn_next(self) -> int:
        """Scale-up: start one more replica (fresh index, own model
        copy).  It registers through the normal lease path and enters
        rotation when its first health check passes."""
        i = max(self.procs, default=-1) + 1
        if not self.shared_model:
            os.makedirs(os.path.dirname(self.replica_model(i)),
                        exist_ok=True)
            shutil.copyfile(self.model_path, self.replica_model(i))
        self.spawn(i)
        return i

    def drain_replica(self, i: Optional[int] = None) -> Optional[str]:
        """Scale-down: drain one replica (default: the newest).  The
        replica's SIGTERM drain path deregisters AT DRAIN START — it
        leaves rotation before finishing its in-flight requests, so no
        request is lost; the router-side deregister below is the
        belt-and-braces for a replica too wedged to announce itself.
        The process is dropped from the keepalive set so it is not
        resurrected.  Returns the drained replica id, or None."""
        live = self.live_indices()
        if not live:
            return None
        i = max(live) if i is None else i
        p = self.procs.pop(i, None)
        if p is None or p.poll() is not None:
            return None
        p.terminate()
        try:
            req = urllib.request.Request(
                self.url + "/fleet/deregister",
                data=json.dumps({"replica_id": f"r{i}"}).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as r:
                r.read()
        except OSError:
            pass  # the replica's own drain deregister is the main path
        return f"r{i}"

    # ------------------------------------------------------------- chaos
    def kill_replica(self, i: int) -> Optional[int]:
        """SIGKILL replica ``i`` (no drain, no deregister — the crash
        case).  Returns the dead pid, or None if it was not running."""
        p = self.procs.get(i)
        if p is None or p.poll() is not None:
            return None
        p.kill()
        p.wait()
        return p.pid

    def reap_and_restart(self) -> int:
        """The keepalive pass: restart every dead replica (it re-uses
        its replica id — the recover path).  Returns restarts made."""
        n = 0
        for i, p in list(self.procs.items()):
            if p.poll() is not None:
                self.spawn(i)
                self.restarts += 1
                n += 1
        return n

    def stop(self, drain_timeout: float = 15.0) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()  # SIGTERM -> replica drain state machine
        deadline = time.perf_counter() + drain_timeout
        for p in self.procs.values():
            left = max(0.1, deadline - time.perf_counter())
            try:
                p.wait(left)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()
        if self.router is not None:
            self.router.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="model file to serve")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="router port (0 = ephemeral)")
    ap.add_argument("--workdir", default=".fleet",
                    help="per-replica model copies + logs land here")
    ap.add_argument("--featurestore-mb", type=float, default=0.0)
    ap.add_argument("--keepalive", type=int, default=1,
                    help="restart dead replicas (0 disables)")
    ap.add_argument("--serve-arg", action="append", default=[],
                    help="extra name=value passed to every replica "
                         "(repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the replicas' engines run")
    # elastic supervision (xgboost_tpu_torch.placer.elastic): band
    # defaults come from PLACER_PARAMS — one knob table drives the CLI
    # and this tool alike
    from xgboost_tpu_torch.config import PLACER_PARAMS
    ap.add_argument("--supervise", action="store_true",
                    help="hold fleet utilization inside the "
                         "[--util-low, --util-high] band by "
                         "spawning/draining replicas")
    ap.add_argument("--min-replicas", type=int,
                    default=PLACER_PARAMS["placer_min_replicas"][0])
    ap.add_argument("--max-replicas", type=int,
                    default=PLACER_PARAMS["placer_max_replicas"][0])
    ap.add_argument("--util-low", type=float,
                    default=PLACER_PARAMS["placer_util_low"][0])
    ap.add_argument("--util-high", type=float,
                    default=PLACER_PARAMS["placer_util_high"][0])
    ap.add_argument("--util-alpha", type=float,
                    default=PLACER_PARAMS["placer_util_alpha"][0])
    ap.add_argument("--replica-slots", type=int,
                    default=PLACER_PARAMS["placer_replica_slots"][0])
    ap.add_argument("--cooldown-sec", type=float,
                    default=PLACER_PARAMS["placer_cooldown_sec"][0])
    args = ap.parse_args(argv)

    fl = FleetLauncher(args.model, replicas=args.replicas,
                       workdir=args.workdir, host=args.host,
                       port=args.port,
                       featurestore_mb=args.featurestore_mb,
                       serve_args=args.serve_arg, quiet=False,
                       device=args.device)
    fl.start()
    print(f"[fleet] router {fl.url}; waiting for {args.replicas} "
          "replica(s) to register...", file=sys.stderr)
    fl.wait_ready()
    print(f"[fleet] up: {args.replicas} replicas in rotation "
          f"(logs in {args.workdir}/)", file=sys.stderr)

    supervisor = None
    if args.supervise:
        from xgboost_tpu_torch.placer import ElasticSupervisor
        supervisor = ElasticSupervisor(
            fl.url, spawn_fn=fl.spawn_next, drain_fn=fl.drain_replica,
            count_fn=fl.count,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            util_low=args.util_low, util_high=args.util_high,
            util_alpha=args.util_alpha,
            replica_slots=args.replica_slots,
            cooldown_sec=args.cooldown_sec)
        print(f"[fleet] supervising: util band "
              f"[{args.util_low}, {args.util_high}], "
              f"{args.min_replicas}..{args.max_replicas} replicas",
              file=sys.stderr)

    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    try:
        while not stop:
            time.sleep(1.0)
            if args.keepalive:
                n = fl.reap_and_restart()
                if n:
                    print(f"[fleet] keepalive restarted {n} replica(s)",
                          file=sys.stderr)
            if supervisor is not None:
                st = supervisor.tick()
                if st["state"] not in ("steady",):
                    print(f"[fleet] supervisor: {st}", file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        print("[fleet] draining...", file=sys.stderr)
        fl.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
