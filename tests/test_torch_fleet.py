"""The PyTorch port's fleet (``xgboost_tpu_torch.fleet``) held to
``tests/test_fleet.py``: each of its tests ported onto the port's
replicas (``run_server(..., device="cpu")``) and router, at its fixture
(300 x 6 rows, depth 3, buckets of 8-32, no warmup), and cross-package
tests: a router of either package over one replica of each package, both
routers answering the same bytes apart from fields that hold times,
pids or ports, and the ring and the exposition scrapers equal to the
JAX package's.

Covered, as in the JAX file:
(a) router /predict responses are BIT-identical to a direct replica
    call (pure passthrough dispatch);
(b) consistent-hash stickiness: an entity id maps to one replica
    across requests, so feature-store residency concentrates — and
    membership churn only remaps the changed replica's keys;
(c) circuit breaker: consecutive failures trip it open, a half-open
    probe after cooldown closes it again, and client traffic never
    fails while it does (retry-once on a healthy replica);
(d) drain -> leaves rotation -> re-register (the tracker `recover`
    path), and a heartbeat-loss chaos fault decays the lease;
(e) canary rollout gates on canary /metrics and ROLLS BACK when the
    canary is chaos-killed mid-soak, with the fleet still serving the
    prior content hash;
(f) the router's global in-flight budget sheds with 503.
"""

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

pytest.importorskip("torch")

import xgboost_tpu_torch as xgb  # noqa: E402
from xgboost_tpu_torch.fleet import (FleetRouter, HashRing,  # noqa: E402
                                     scrape_samples)
from xgboost_tpu_torch.serving import run_server  # noqa: E402


def _train(seed=0, rounds=3, **params):
    rng = np.random.RandomState(seed)
    X = rng.rand(300, 6).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.4,
         "silent": 1, "seed": seed, **params}
    return xgb.train(p, xgb.DMatrix(X, label=y), rounds,
                     device="cpu"), X


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    bst_a, X = _train()
    bst_b, _ = _train(seed=7, rounds=4, max_depth=2)
    pa, pb = str(d / "model_a.bin"), str(d / "model_b.bin")
    bst_a.save_model(pa)
    bst_b.save_model(pb)
    return bst_a, bst_b, X, pa, pb


def _file_hash(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _replica(model_path, router_url, rid, fs_mb=0.0):
    return run_server(model_path, port=0, min_bucket=8, max_bucket=32,
                      max_wait_ms=1.0, poll_sec=0, warmup=False,
                      featurestore_mb=fs_mb, quiet=True, block=False,
                      router_url=router_url, replica_id=rid, device="cpu")


def _post(url, payload=None, data=None, headers=None):
    """POST -> (status, parsed-json, raw-bytes, response-headers)."""
    body = (json.dumps(payload).encode() if payload is not None
            else (data or b""))
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read()
            return r.status, json.loads(raw), raw, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw), raw, dict(e.headers)
        except ValueError:
            return e.code, {}, raw, dict(e.headers)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _csv(rows):
    return "\n".join(",".join(f"{v:.6f}" for v in row)
                     for row in rows).encode()


# ---------------------------------------------------------------- ring
def test_hash_ring_sticky_and_minimal_remap():
    ring = HashRing(vnodes=64)
    ring.rebuild(["r0", "r1", "r2"])
    keys = [f"user-{i}" for i in range(400)]
    owners = {k: ring.route(k, {"r0", "r1", "r2"}) for k in keys}
    # deterministic: same key -> same owner, every replica owns some
    assert owners == {k: ring.route(k, {"r0", "r1", "r2"}) for k in keys}
    assert set(owners.values()) == {"r0", "r1", "r2"}
    # dropping r1 from ELIGIBILITY remaps only r1's keys (ring walk
    # skips it); everyone else stays put — the failover property
    for k in keys:
        moved = ring.route(k, {"r0", "r2"})
        if owners[k] != "r1":
            assert moved == owners[k], f"{k} moved needlessly"
        else:
            assert moved in ("r0", "r2")
    # removing r1 from the RING entirely keeps survivors' keys put too
    ring.rebuild(["r0", "r2"])
    for k in keys:
        if owners[k] != "r1":
            assert ring.route(k, {"r0", "r2"}) == owners[k]


def test_scrape_samples_parses_exposition():
    text = ("# HELP x_total help\n# TYPE x_total counter\n"
            "x_total 41\n"
            'labeled_total{replica="r1"} 7\n'
            "x_p99 0.25\n"
            "x_small 9.5e-05\n"       # repr() e-notation below 1e-4
            "x_neg -2.5\n")
    s = scrape_samples(text)
    assert s["x_total"] == 41.0 and s["x_p99"] == 0.25
    assert s["x_small"] == 9.5e-05 and s["x_neg"] == -2.5
    assert "labeled_total" not in s


# ------------------------------------------------------- routing parity
def test_router_predict_bit_identical_and_traced(models, tmp_path):
    """(a) router passthrough: byte-identical body to a direct replica
    call, X-Request-Id echoed end to end."""
    bst_a, _, X, pa, _ = models
    rt = FleetRouter(port=0, hc_sec=0.5, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    srv = _replica(pa, base, "r1")
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 1
        body = _csv(np.round(X[:5], 6))
        st_r, js_r, raw_r, hdr_r = _post(
            base + "/predict", data=body,
            headers={"X-Request-Id": "trace-123"})
        st_d, js_d, raw_d, _ = _post(
            f"http://{srv.host}:{srv.port}/predict", data=body)
        assert st_r == st_d == 200
        assert raw_r == raw_d, "router response differs from direct call"
        assert hdr_r["X-Request-Id"] == "trace-123"
        # predictions match the model bit for bit through json
        ref = bst_a.predict(xgb.DMatrix(np.round(X[:5], 6)))
        assert np.array_equal(
            np.asarray(js_r["predictions"], np.float32), ref)
        # output_margin query string passes through
        st_m, js_m, _, _ = _post(base + "/predict?output_margin=1",
                                 data=body)
        refm = bst_a.predict(xgb.DMatrix(np.round(X[:5], 6)),
                             output_margin=True)
        assert st_m == 200
        assert np.array_equal(
            np.asarray(js_m["predictions"], np.float32), refm)
        # replica /healthz carries the content hash of what it serves
        h = _get(f"http://{srv.host}:{srv.port}/healthz")
        assert h["model_hash"] == _file_hash(pa)
    finally:
        srv.shutdown()
        rt.shutdown()


# ----------------------------------------------- consistent-hash by id
def test_predict_by_id_consistent_hash_stickiness(models):
    """(b) puts and predicts for one entity land on ONE replica:
    residency concentrates, and by-id traffic via the router is
    bit-identical to the engine on the same rows."""
    bst_a, _, X, pa, _ = models
    rt = FleetRouter(port=0, hc_sec=0.5, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    s1 = _replica(pa, base, "r1", fs_mb=4.0)
    s2 = _replica(pa, base, "r2", fs_mb=4.0)
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 2
        ids = [f"user-{i}" for i in range(12)]
        rows = np.round(X[:12], 6).astype(np.float32)
        st, js, _, _ = _post(base + "/featurestore/put",
                             {"ids": ids, "rows": rows.tolist()})
        assert st == 200, js
        # residency split across replicas, nothing duplicated
        n1 = _get(f"http://{s1.host}:{s1.port}/healthz")["featurestore_rows"]
        n2 = _get(f"http://{s2.host}:{s2.port}/healthz")["featurestore_rows"]
        assert n1 + n2 == 12 and n1 > 0 and n2 > 0
        # by-id predictions through the router match the model exactly
        st, js, _, _ = _post(base + "/predict_by_id", {"ids": ids})
        assert st == 200 and js["rows"] == 12
        ref = bst_a.predict(xgb.DMatrix(rows))
        assert np.array_equal(np.asarray(js["predictions"], np.float32),
                              ref)
        # residency is EXCLUSIVE: each id lives on exactly one replica
        # (the put split followed the same ring the predicts follow)
        for eid in ids:
            on_1 = not s1.featurestore.missing([eid])
            on_2 = not s2.featurestore.missing([eid])
            assert on_1 != on_2, f"{eid} resident on {on_1 + on_2} stores"
        # stickiness: repeated single-id requests keep succeeding —
        # only the one replica holding the row can serve them, so a
        # routing flap would surface as a 404 miss
        for _i in range(3):
            st, js1, _, _ = _post(base + "/predict_by_id",
                                  {"ids": [ids[0]]})
            assert st == 200
            assert np.float32(js1["predictions"][0]) == ref[0]
        # absent ids 404 with the missing list (merged across replicas)
        st, js, _, _ = _post(base + "/predict_by_id",
                             {"ids": ["ghost-1", ids[0], "ghost-2"]})
        assert st == 404
        assert set(js["missing"]) == {"ghost-1", "ghost-2"}
    finally:
        s1.shutdown()
        s2.shutdown()
        rt.shutdown()


# -------------------------------------------------------- stub replica
class _Stub:
    """Minimal fake replica: /healthz always serving; /predict fails
    (500) while ``fail`` is set, else answers after ``delay``."""

    def __init__(self):
        self.fail = False
        self.delay = 0.0
        self.hits = 0
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *a):
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send(200, {"status": "ok", "state": "serving",
                                 "model_hash": "stub"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                stub.hits += 1
                if stub.fail:
                    self._send(500, {"error": "stub failure"})
                    return
                if stub.delay:
                    time.sleep(stub.delay)
                self._send(200, {"predictions": [0.5], "rows": 1,
                                 "model_version": 1})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _register_stub(base, rid, stub):
    st, js, _, _ = _post(base + "/fleet/register",
                         {"replica_id": rid, "url": stub.url})
    assert st == 200, js


# ------------------------------------------------------------- breaker
def test_breaker_trip_half_open_recovery():
    """(c) consecutive failures trip the breaker; traffic keeps
    succeeding via retry on the healthy replica; after cooldown one
    half-open probe closes it again."""
    rt = FleetRouter(port=0, hc_sec=0, breaker_failures=2,
                     breaker_cooldown_sec=0.5, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    bad, good = _Stub(), _Stub()
    bad.fail = True
    try:
        _register_stub(base, "bad", bad)
        _register_stub(base, "good", good)
        # every request succeeds (retry-once covers the bad replica)
        for _ in range(6):
            st, js, _, _ = _post(base + "/predict", data=b"0.5")
            assert st == 200, js
        members = {m["replica_id"]: m
                   for m in _get(base + "/fleet/members")["replicas"]}
        assert members["bad"]["breaker"] == "open"
        assert members["good"]["breaker"] == "closed"
        bad_hits_at_trip = bad.hits
        assert bad_hits_at_trip >= 2
        # while OPEN no traffic reaches the bad replica
        for _ in range(4):
            st, _, _, _ = _post(base + "/predict", data=b"0.5")
            assert st == 200
        assert bad.hits == bad_hits_at_trip
        # heal the replica, wait out the cooldown: the half-open probe
        # closes the breaker and traffic flows there again
        bad.fail = False
        time.sleep(0.6)
        for _ in range(6):
            st, _, _, _ = _post(base + "/predict", data=b"0.5")
            assert st == 200
        members = {m["replica_id"]: m
                   for m in _get(base + "/fleet/members")["replicas"]}
        assert members["bad"]["breaker"] == "closed"
        assert bad.hits > bad_hits_at_trip, "no traffic after recovery"
        # a failed probe would have re-opened: verify metrics recorded
        # the trip
        mtext = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "xgbtpu_fleet_breaker_trips_total" in mtext
    finally:
        bad.close()
        good.close()
        rt.shutdown()


# ------------------------------------------------- drain / re-register
def test_drain_leaves_rotation_then_reregister(models):
    """(d) a draining replica deregisters (leaves rotation BEFORE
    503ing); a restart re-registers under the same id — recover."""
    _, _, X, pa, _ = models
    rt = FleetRouter(port=0, hc_sec=0.3, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    s1 = _replica(pa, base, "r1")
    s2 = _replica(pa, base, "r2")
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 2
        body = _csv(X[:2])
        s1.drain(grace=5.0)  # deregisters via the lease client
        desc = _get(base + "/fleet/members")
        assert desc["in_rotation"] == 1
        assert [m["replica_id"] for m in desc["replicas"]
                if m["in_rotation"]] == ["r2"]
        # fleet keeps serving through the survivor
        for _ in range(3):
            st, _, _, _ = _post(base + "/predict", data=body)
            assert st == 200
        # restart under the SAME id: back in rotation (recover path)
        s1b = _replica(pa, base, "r1")
        try:
            desc = _get(base + "/fleet/members")
            assert desc["in_rotation"] == 2
            r1 = [m for m in desc["replicas"]
                  if m["replica_id"] == "r1"][0]
            assert r1["in_rotation"] and r1["url"].endswith(
                str(s1b.port))
            # traffic reaches the rejoined fleet
            st, _, _, _ = _post(base + "/predict", data=body)
            assert st == 200
        finally:
            s1b.shutdown()
    finally:
        s2.shutdown()
        rt.shutdown()


def test_heartbeat_loss_decays_lease_then_recovers(models):
    """(d) chaos ``heartbeat_loss``: missed renewals expire the lease
    (out of rotation, no process death); the next successful heartbeat
    re-registers — the router never stopped knowing how to take it
    back."""
    from xgboost_tpu_torch.reliability import faults
    _, _, X, pa, _ = models
    rt = FleetRouter(port=0, hc_sec=0, lease_sec=0.6, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    s1 = _replica(pa, base, "r1")
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 1
        faults.inject("heartbeat_loss", path_sub="r1", times=50)
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            if _get(base + "/fleet/members")["in_rotation"] == 0:
                break
            time.sleep(0.1)
        assert _get(base + "/fleet/members")["in_rotation"] == 0, \
            "lease survived lost heartbeats"
        assert s1.lease_client.heartbeats_skipped > 0
        faults.clear_faults()
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            if _get(base + "/fleet/members")["in_rotation"] == 1:
                break
            time.sleep(0.1)
        assert _get(base + "/fleet/members")["in_rotation"] == 1, \
            "replica did not recover after heartbeats resumed"
    finally:
        faults.clear_faults()
        s1.shutdown()
        rt.shutdown()


# ------------------------------------------------------------ rollout
def test_canary_rollout_success_then_fleet_rollback(models):
    """(e) happy path: canary gate passes, the fleet converges on the
    new content hash (verified via each replica's OWN /healthz), and
    the one-command rollback restores the previous hash fleet-wide."""
    bst_a, bst_b, X, pa, pb = models
    rt = FleetRouter(port=0, hc_sec=0.3, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="xgbtpu_fleetroll_")
    m1, m2 = f"{d}/r1.bin", f"{d}/r2.bin"
    shutil.copyfile(pa, m1)
    shutil.copyfile(pa, m2)
    hash_a, hash_b = _file_hash(pa), _file_hash(pb)
    s1 = _replica(m1, base, "r1")
    s2 = _replica(m2, base, "r2")
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 2
        st, js, _, _ = _post(base + "/fleet/rollout",
                             {"model_path": pb, "canaries": 1,
                              "soak_sec": 0.2,
                              "gate_error_rate": 0.5,
                              "gate_p99_ms": 10_000.0})
        assert st == 200 and js["status"] == "ok", js
        assert js["model_hash"] == hash_b
        assert js["canaries"] == ["r1"]
        for s in (s1, s2):
            h = _get(f"http://{s.host}:{s.port}/healthz")
            assert h["model_hash"] == hash_b, "replica not on new model"
        # responses now come from model B
        body = _csv(np.round(X[:4], 6))
        st, js, _, _ = _post(base + "/predict", data=body)
        ref_b = bst_b.predict(xgb.DMatrix(np.round(X[:4], 6)))
        assert np.array_equal(np.asarray(js["predictions"], np.float32),
                              ref_b)
        # one-command instant rollback, fleet-wide
        st, js, _, _ = _post(base + "/fleet/rollback")
        assert st == 200 and js["status"] == "rolled_back"
        for s in (s1, s2):
            h = _get(f"http://{s.host}:{s.port}/healthz")
            assert h["model_hash"] == hash_a, "rollback missed a replica"
        st, js, _, _ = _post(base + "/predict", data=body)
        ref_a = bst_a.predict(xgb.DMatrix(np.round(X[:4], 6)))
        assert np.array_equal(np.asarray(js["predictions"], np.float32),
                              ref_a)
        # backups refresh PER ROLLOUT: after rolling B then A, a
        # rollback must restore the PREVIOUS version (B) — files
        # included — not the pre-first-rollout bytes (a stale backup
        # would split engines from files here)
        roll_args = {"canaries": 1, "soak_sec": 0.2,
                     "gate_error_rate": 0.5, "gate_p99_ms": 10_000.0}
        st, js, _, _ = _post(base + "/fleet/rollout",
                             {"model_path": pb, **roll_args})
        assert st == 200 and js["status"] == "ok", js
        st, js, _, _ = _post(base + "/fleet/rollout",
                             {"model_path": pa, **roll_args})
        assert st == 200 and js["status"] == "ok", js
        st, js, _, _ = _post(base + "/fleet/rollback")
        assert st == 200
        for s, path in ((s1, m1), (s2, m2)):
            h = _get(f"http://{s.host}:{s.port}/healthz")
            assert h["model_hash"] == hash_b, \
                "rollback restored the wrong (stale) version"
            assert _file_hash(path) == hash_b, \
                "rollback restored stale file bytes"
    finally:
        s1.shutdown()
        s2.shutdown()
        rt.shutdown()


def test_canary_rollout_rolls_back_when_canary_killed(models):
    """(e) the chaos case: the canary dies mid-soak, the gate cannot
    observe it -> the rollout rolls back and the SURVIVING fleet still
    serves the prior hash."""
    bst_a, _, X, pa, pb = models
    rt = FleetRouter(port=0, hc_sec=0.2, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="xgbtpu_fleetkill_")
    m1, m2 = f"{d}/r1.bin", f"{d}/r2.bin"
    shutil.copyfile(pa, m1)
    shutil.copyfile(pa, m2)
    hash_a = _file_hash(pa)
    s1 = _replica(m1, base, "r1")  # r1 sorts first -> the canary
    s2 = _replica(m2, base, "r2")
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 2
        killer = threading.Timer(0.4, s1.shutdown)  # dies mid-soak
        killer.start()
        st, js, _, _ = _post(base + "/fleet/rollout",
                             {"model_path": pb, "canaries": 1,
                              "soak_sec": 1.5,
                              "gate_error_rate": 0.5,
                              "gate_p99_ms": 10_000.0})
        killer.join()
        assert st == 500 and js["status"] == "rolled_back", js
        assert "unreachable" in js["reason"]
        # the untouched replica still serves the prior hash; the fleet
        # still answers predictions (health check dropped the corpse)
        h = _get(f"http://{s2.host}:{s2.port}/healthz")
        assert h["model_hash"] == hash_a
        time.sleep(0.5)  # let the health checker notice the kill
        body = _csv(np.round(X[:3], 6))
        for _ in range(3):
            st, js, _, _ = _post(base + "/predict", data=body)
            assert st == 200
        ref_a = bst_a.predict(xgb.DMatrix(np.round(X[:3], 6)))
        assert np.array_equal(np.asarray(js["predictions"], np.float32),
                              ref_a)
        # the rollback restored the canary's model FILE too: a restart
        # of r1 comes back serving hash A, not the failed push
        assert _file_hash(m1) == hash_a
    finally:
        s2.shutdown()
        rt.shutdown()


# ----------------------------------------------- latency-aware ejection
def test_latency_ejection_routes_around_wedged_replica():
    """A slow-but-alive replica — every request
    SUCCEEDS, so the failure-count breaker never sees it — is ejected
    on its latency EWMA (k × fleet median), traffic routes around it
    with zero failures, and a fast post-cooldown probe readmits it."""
    rt = FleetRouter(port=0, hc_sec=0, slow_eject_factor=3.0,
                     slow_eject_cooldown_sec=0.8, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    slow, f1, f2 = _Stub(), _Stub(), _Stub()
    slow.delay = 0.12  # wedged-but-alive: answers, late
    try:
        # "a-slow" sorts first, so least-loaded ties prefer the wedge
        _register_stub(base, "a-slow", slow)
        _register_stub(base, "b-fast", f1)
        _register_stub(base, "c-fast", f2)
        codes = []
        lock = threading.Lock()

        def fire(n):
            for _ in range(n):
                st, _, _, _ = _post(base + "/predict", data=b"0.5")
                with lock:
                    codes.append(st)

        # concurrent traffic until the ejection fires (scheduling on a
        # loaded 1-core host decides how fast the wedge accumulates
        # its EWMA samples; the CONTRACT is that it ejects, not when)
        members = {}
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            ts = [threading.Thread(target=fire, args=(6,))
                  for _ in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            members = {m["replica_id"]: m for m in
                       _get(base + "/fleet/members")["replicas"]}
            if members["a-slow"]["ejected"]:
                break
        assert set(codes) == {200}, "a slow replica cost client errors"
        assert members["a-slow"]["ejected"] is True
        # the breaker never saw it — this is the DISTINCT state
        assert members["a-slow"]["breaker"] == "closed"
        assert members["a-slow"]["latency_ewma_ms"] > 50
        assert members["b-fast"]["ejected"] is False
        samples = scrape_samples(urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode())
        assert samples["xgbtpu_fleet_slow_ejections_total"] >= 1
        # while ejected the wedge takes no REGULAR traffic — at most
        # one readmission probe may slip in if the burst already aged
        # past the cooldown (the probe is ejection working as designed,
        # not a dispatch leak)
        hits_at_eject = slow.hits
        fire(8)
        assert slow.hits <= hits_at_eject + 1, \
            "ejected replica kept receiving regular dispatches"
        # heal it; after the cooldown ONE probe decides readmission
        slow.delay = 0.0
        time.sleep(0.9)
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            fire(4)
            members = {m["replica_id"]: m for m in
                       _get(base + "/fleet/members")["replicas"]}
            if not members["a-slow"]["ejected"]:
                break
        assert members["a-slow"]["ejected"] is False, \
            "healed replica never readmitted"
        assert slow.hits > hits_at_eject
        assert set(codes) == {200}
    finally:
        slow.close()
        f1.close()
        f2.close()
        rt.shutdown()


def test_ejection_state_machine_edge_cases():
    """Direct-state checks on the ejection machinery: (a) lease-dead
    ghosts are excluded from the peer-median comparator; (b) a recover
    re-registration resets ejection state like it resets the breaker;
    (c) only the dispatch that was GRANTED the readmission probe can
    resolve it (thread-token attribution)."""
    import time as _t

    from xgboost_tpu_torch.fleet.membership import Membership
    m = Membership(lease_sec=30.0, slow_eject_factor=3.0)
    for rid in ("r1", "r2", "r3"):
        m.register(rid, f"http://x/{rid}")
    r1, r2, r3 = (m.get(r) for r in ("r1", "r2", "r3"))
    # (a) ghost exclusion: r3 dies without deregistering, carrying a
    # huge wedged-era EWMA — the live pair's comparator must not see it
    r1.lat_ewma, r1.lat_samples = 0.002, 20
    r2.lat_ewma, r2.lat_samples = 0.002, 20
    r3.lat_ewma, r3.lat_samples = 0.600, 20
    r3.lease_deadline = _t.monotonic() - 1.0  # lease-dead ghost
    with m._lock:
        assert m._peer_median_lat_locked(r1) == pytest.approx(0.002)
    # (b) recover reset: an ejected, wedged-history replica restarts
    # and re-registers under its old id — clean slate
    r2.ejected = True
    r2.ejected_at = _t.monotonic()
    r2.lat_ewma, r2.lat_samples = 0.600, 50
    assert m.register("r2", "http://x/r2b")["recovered"] is True
    r2 = m.get("r2")
    assert r2.ejected is False and r2.lat_samples == 0
    assert r2.lat_ewma == 0.0
    # (c) probe attribution: grant the probe on this thread, then a
    # release from ANOTHER thread (a fast entity-id hop) must neither
    # resolve the probe nor readmit the replica.  (r2 gets fresh fast
    # samples first: with no live sampled peer there is no comparator
    # and a successful probe readmits unconditionally.)
    r2.lat_ewma, r2.lat_samples = 0.002, 20
    r1.ejected = True
    r1.ejected_at = _t.monotonic() - 60.0  # cooldown long past
    rep = m.acquire()  # grants r1's readmission probe to THIS thread
    assert rep is r1 and r1.eject_probe_inflight
    other = m.acquire_specific("r1")  # entity-id hop, not gated
    assert other is r1
    done = []
    t = threading.Thread(
        target=lambda: done.append(m.release(r1, ok=True, latency=0.001)))
    t.start()
    t.join()
    assert r1.ejected is True, "foreign release resolved the probe"
    assert r1.eject_probe_inflight, "foreign release freed the slot"
    # the GRANTED thread's slow probe outcome keeps it ejected
    m.release(r1, ok=True, latency=0.5)
    assert r1.ejected is True and not r1.eject_probe_inflight


def test_slow_replica_fault_kind_delays_predicts(models):
    """The `slow_replica` chaos kind (reliability/faults.py) wedges a
    real replica's predict path — keyed on its fleet replica id, lease
    and health untouched — so the ejection machinery is chaos-testable
    end to end."""
    from xgboost_tpu_torch.reliability import faults
    _, _, X, pa, _ = models
    rt = FleetRouter(port=0, hc_sec=0.3, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    srv = _replica(pa, base, "r-wedge")
    try:
        assert _get(base + "/fleet/members")["in_rotation"] == 1
        body = _csv(X[:2])
        # warm the replica first: the baseline must not include the
        # cold-start bucket compile (which alone can exceed the wedge)
        for _ in range(3):
            st, _, _, _ = _post(base + "/predict", data=body)
            assert st == 200
        t0 = time.perf_counter()
        st, _, _, _ = _post(base + "/predict", data=body)
        assert st == 200
        fast = time.perf_counter() - t0
        assert fast < 0.4, f"warm baseline too slow ({fast:.2f}s)"
        faults.inject("slow_replica", 0.4, path_sub="r-wedge", times=1)
        t0 = time.perf_counter()
        st, _, _, _ = _post(base + "/predict", data=body)
        wedged = time.perf_counter() - t0
        assert st == 200, "the wedge must delay, never fail"
        assert wedged >= 0.4 > fast
        # the fault disarmed after `times`: back to fast
        t0 = time.perf_counter()
        st, _, _, _ = _post(base + "/predict", data=body)
        assert st == 200
        assert time.perf_counter() - t0 < 0.4
    finally:
        faults.clear_faults()
        srv.shutdown()
        rt.shutdown()


# ----------------------------------------------------------- load shed
def test_router_inflight_budget_sheds_503():
    """(f) admission control: concurrent requests past the global
    budget shed with 503 immediately; admitted ones all succeed."""
    rt = FleetRouter(port=0, hc_sec=0, inflight_budget=2,
                     quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    stub = _Stub()
    stub.delay = 0.4
    try:
        _register_stub(base, "slow", stub)
        results = []
        lock = threading.Lock()

        def fire():
            st, js, _, _ = _post(base + "/predict", data=b"0.5")
            with lock:
                results.append((st, js))

        ts = [threading.Thread(target=fire) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        codes = [st for st, _ in results]
        assert codes.count(200) >= 1
        assert codes.count(503) >= 1, f"no shedding: {codes}"
        assert set(codes) <= {200, 503}
        for st, js in results:
            if st == 503:
                assert js.get("shed") is True
        def scrape():
            return scrape_samples(urllib.request.urlopen(
                base + "/metrics", timeout=10).read().decode())

        shed = scrape()
        assert shed["xgbtpu_fleet_shed_total"] == codes.count(503)
        # settle poll: a handler thread sends its response BEFORE its
        # finally-block exit_request runs, so the gauge can trail the
        # client's join by a scheduling quantum
        deadline = time.perf_counter() + 5.0
        while (shed["xgbtpu_fleet_inflight"]
               and time.perf_counter() < deadline):
            time.sleep(0.05)
            shed = scrape()
        assert shed["xgbtpu_fleet_inflight"] == 0
    finally:
        stub.close()
        rt.shutdown()


# ------------------------------------------------------ registry hash
def test_registry_describe_and_hash_follow_rollback(models, tmp_path):
    """Satellite: ModelRegistry.describe()/content_hash name what the
    live engine ACTUALLY serves — through reloads AND rollbacks."""
    from xgboost_tpu_torch.serving import ModelRegistry
    bst_a, bst_b, _, pa, pb = models
    path = str(tmp_path / "m.bin")
    import shutil
    shutil.copyfile(pa, path)
    hash_a, hash_b = _file_hash(pa), _file_hash(pb)
    reg = ModelRegistry(path, warmup=False, poll_sec=0,
                        min_bucket=8, max_bucket=32, device="cpu")
    assert reg.content_hash == hash_a
    d = reg.describe()
    assert d["model_hash"] == hash_a and d["model_version"] == 1
    assert d["engine"]["num_feature"] == 6
    shutil.copyfile(pb, path)
    assert reg.check_reload() is True
    assert reg.content_hash == hash_b
    # rollback: the hash follows the ENGINE, not the on-disk file
    assert reg.rollback() is True
    assert reg.content_hash == hash_a
    assert reg.describe()["model_hash"] == hash_a
    assert reg.rollback() is True  # toggles back
    assert reg.content_hash == hash_b


def test_cli_usage_lists_fleet_params(capsys):
    from xgboost_tpu_torch.cli import main as cli_main
    assert cli_main([]) == 0
    out = capsys.readouterr().out
    assert "fleet_router" in out
    for name in ("fleet_port", "fleet_lease_sec", "fleet_inflight",
                 "fleet_breaker_failures", "serve_router_url"):
        assert name in out, f"{name} missing from CLI usage"


# ------------------------------------------------------- cross-package
# fields that hold times, pids or ports (and the replicas' URLs, which
# carry their ports): the only ones allowed to differ between routers
_VOLATILE = {"url", "pid", "lease_remaining_sec", "latency_ewma_ms",
             "uptime_seconds"}


def _stable(obj):
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def mixed_fleets(models):
    """A router of each package, each over one port replica (``r-port``)
    and one JAX replica (``r-jax``), all four serving one model file with
    a feature store; the same ids, so the rings agree."""
    jax = pytest.importorskip("jax")
    del jax
    from xgboost_tpu.fleet import FleetRouter as JaxRouter
    from xgboost_tpu.serving import run_server as jax_run_server
    _, _, X, pa, _ = models
    routers = {"t": FleetRouter(port=0, hc_sec=0.5, quiet=True).start(),
               "j": JaxRouter(port=0, hc_sec=0.5, quiet=True).start()}
    servers = []
    for rt in routers.values():
        base = f"http://{rt.host}:{rt.port}"
        servers.append(_replica(pa, base, "r-port", fs_mb=4.0))
        servers.append(jax_run_server(
            pa, port=0, min_bucket=8, max_bucket=32, max_wait_ms=1.0,
            poll_sec=0, warmup=False, featurestore_mb=4.0, quiet=True,
            block=False, router_url=base, replica_id="r-jax"))
    bases = {k: f"http://{rt.host}:{rt.port}" for k, rt in routers.items()}
    try:
        # the admin routes are read before any traffic: a replica's
        # advertised device bytes grow with the row buckets its engine
        # has built, which least-loaded dispatch spreads by timing
        plan = {"placer_id": "p1",
                "plan": {"a": ["r-port"], "b": ["r-jax"]}}
        admin = {"placer": []}
        for b in bases.values():
            lease = _post(b + "/placer/lease", {"placer_id": "p1"})
            admin["placer"].append((lease[0], lease[2],
                                    _post(b + "/placer/plan", plan)[2]))
        for route in ("/healthz", "/fleet/members", "/fleet/rollout",
                      "/placer/status"):
            admin[route] = _both(bases, lambda b: _get(b + route))
        yield bases, X, admin
    finally:
        for s in servers:
            s.shutdown()
        for rt in routers.values():
            rt.shutdown()


def _both(bases, fn):
    return fn(bases["t"]), fn(bases["j"])


def test_mixed_routers_answer_predict_with_equal_bytes(mixed_fleets):
    """/predict through either router, whichever replica answers, is
    byte-equal: the port and JAX replicas print the same body."""
    bases, X, _ = mixed_fleets
    for b in bases.values():
        assert _get(b + "/fleet/members")["in_rotation"] == 2
    for rows in (X[:1], X[:5], X[:64]):
        body = _csv(np.round(rows, 6))
        bodies = set()
        for _ in range(4):   # least-loaded dispatch visits both replicas
            for b in bases.values():
                st, _, raw, _ = _post(b + "/predict", data=body)
                assert st == 200
                bodies.add(raw)
        assert len(bodies) == 1
    st_t, js_t, raw_t, _ = _post(bases["t"] + "/predict?output_margin=1",
                                 data=_csv(np.round(X[:5], 6)))
    st_j, _, raw_j, _ = _post(bases["j"] + "/predict?output_margin=1",
                              data=_csv(np.round(X[:5], 6)))
    assert st_t == st_j == 200 and raw_t == raw_j and js_t["rows"] == 5


def test_mixed_routers_predict_by_id_split_and_merged(mixed_fleets):
    """Feature-store puts split across r-port and r-jax by the same
    ring in both routers; merged and single-id answers are byte-equal."""
    bases, X, _ = mixed_fleets
    ids = [f"ent-{i}" for i in range(16)]
    rows = np.round(X[:16], 6).astype(np.float32)
    for b in bases.values():
        st, js, _, _ = _post(b + "/featurestore/put",
                             {"ids": ids, "rows": rows.tolist()})
        assert st == 200, js
    merged = _both(bases, lambda b: _post(b + "/predict_by_id",
                                          {"ids": ids}))
    assert merged[0][0] == merged[1][0] == 200
    assert merged[0][2] == merged[1][2]
    assert merged[0][1]["rows"] == 16
    for eid in ids[:4]:
        one = _both(bases, lambda b: _post(b + "/predict_by_id",
                                           {"ids": [eid]}))
        assert one[0][2] == one[1][2]
    miss = _both(bases, lambda b: _post(b + "/predict_by_id",
                                        {"ids": ["ghost", ids[0]]}))
    assert miss[0][0] == miss[1][0] == 404
    assert miss[0][2] == miss[1][2]


def test_mixed_routers_admin_routes_equal(mixed_fleets):
    """/healthz, GET /fleet/members, GET /fleet/rollout and GET
    /placer/status: equal apart from times, pids and ports; the placer
    lease and plan routes answer the same."""
    _, _, admin = mixed_fleets
    (st_t, lease_t, plan_t), (st_j, lease_j, plan_j) = admin["placer"]
    assert st_t == st_j == 200 and lease_t == lease_j and plan_t == plan_j
    assert json.loads(lease_t)["granted"] is True
    for route in ("/healthz", "/fleet/members", "/fleet/rollout",
                  "/placer/status"):
        t, j = admin[route]
        assert _stable(t) == _stable(j), route
    t = admin["/fleet/members"][0]
    assert [m["replica_id"] for m in t["replicas"]] == ["r-jax", "r-port"]
    assert t["in_rotation"] == 2
    assert admin["/placer/status"][0]["plan"] == {"a": ["r-port"],
                                                  "b": ["r-jax"]}


def test_hash_ring_owners_equal_jax_ring_under_churn():
    """1,000 ids: the port's ring gives the JAX ring's owner through
    joins, leaves and eligibility changes."""
    pytest.importorskip("jax")
    from xgboost_tpu.fleet import HashRing as JaxRing
    keys = [f"user-{i}" for i in range(1000)]
    tr, jr = HashRing(vnodes=64), JaxRing(vnodes=64)
    steps = [(["r0", "r1", "r2"], {"r0", "r1", "r2"}),
             (["r0", "r1", "r2", "r3"], {"r0", "r1", "r2", "r3"}),
             (["r0", "r1", "r2", "r3"], {"r0", "r2", "r3"}),
             (["r0", "r2", "r3"], {"r0", "r2", "r3"}),
             (["r2", "r3", "r4", "r5"], {"r3", "r4", "r5"})]
    for ids, eligible in steps:
        tr.rebuild(ids)
        jr.rebuild(ids)
        got = [tr.route(k, eligible) for k in keys]
        assert got == [jr.route(k, eligible) for k in keys]
        assert set(got) == eligible


def test_scrapers_equal_jax_scrapers_on_one_exposition():
    pytest.importorskip("jax")
    from xgboost_tpu.fleet import scrape_labeled_samples as jax_labeled
    from xgboost_tpu.fleet import scrape_samples as jax_samples
    from xgboost_tpu_torch.fleet import scrape_labeled_samples
    from xgboost_tpu_torch.obs.metrics import (fleet_metrics,
                                               tenant_metrics)
    fleet_metrics().requests.inc("r-port", 3)
    tenant_metrics().requests.inc("a", 2)
    tenant_metrics().latency_ms.inc("a", 1.5)
    text = ("# HELP x_total help\n# TYPE x_total counter\n"
            "x_total 41\n"
            'labeled_total{replica="r1"} 7\n'
            'labeled_total{replica="r2"} 9.5e-05\n'
            'xgbtpu_tenant_requests_total{model="b"} 4\n'
            "x_neg -2.5\n" + fleet_metrics().render()
            + tenant_metrics().render())
    assert scrape_samples(text) == jax_samples(text)
    for name in ("labeled_total", "xgbtpu_tenant_requests_total",
                 "xgbtpu_fleet_requests_total",
                 "xgbtpu_tenant_latency_ms_total"):
        assert scrape_labeled_samples(text, name) == \
            jax_labeled(text, name), name
    assert scrape_labeled_samples(
        text, "xgbtpu_tenant_requests_total")["a"] >= 2


def test_the_last_replica_answers_even_when_ejected():
    """Latency ejection routes around a slow replica only while another
    can take its traffic: with the fast peer gone, the ejected replica
    is dispatched (a plain dispatch, not its readmission probe) rather
    than the 503 the JAX package's ``acquire`` gives until the
    cooldown ends; with the peer back, ejection holds again."""
    import time as _t

    from xgboost_tpu_torch.fleet.membership import Membership
    m = Membership(lease_sec=30.0, slow_eject_factor=3.0,
                   slow_eject_cooldown_sec=60.0)
    for rid in ("r1", "r2"):
        m.register(rid, f"http://x/{rid}")
    r1 = m.get("r1")
    r1.ejected, r1.ejected_at = True, _t.monotonic()
    got = m.acquire()
    assert got is m.get("r2")
    m.release(got, ok=True, latency=0.001)
    m.deregister("r2")
    got = m.acquire()
    assert got is r1 and not r1.eject_probe_inflight
    m.release(got, ok=True, latency=0.5)
    assert r1.ejected and r1.outstanding == 0
    r1.breaker = "open"
    r1.breaker_opened_at = _t.monotonic()
    assert m.acquire() is None          # the breaker still rules
    jax = pytest.importorskip("jax")
    del jax
    from xgboost_tpu.fleet.membership import Membership as JaxMembership
    jm = JaxMembership(lease_sec=30.0, slow_eject_cooldown_sec=60.0)
    jm.register("r1", "http://x/r1")
    jm.get("r1").ejected = True
    jm.get("r1").ejected_at = _t.monotonic()
    assert jm.acquire() is None


def test_launch_fleet_brings_up_replica_processes(models, tmp_path):
    """``xgboost_tpu_torch/tools/launch_fleet.py``'s ``FleetLauncher``:
    an in-process router over ``python -m xgboost_tpu_torch task=serve``
    replica processes (``device=cpu`` here, cuda by default), routed
    answers equal to ``Booster.predict``, and the elastic hooks
    (``spawn_next``, ``drain_replica``) that ``--supervise`` drives."""
    from xgboost_tpu_torch.tools.launch_fleet import FleetLauncher
    bst_a, _, X, pa, _ = models
    fl = FleetLauncher(pa, replicas=1, workdir=str(tmp_path / "fleet"),
                       device="cpu", serve_args=["serve_warmup=0"])
    try:
        fl.start()
        assert "device=cpu" in fl._replica_cmd(0)
        assert fl.wait_ready(timeout=120) == 1
        st, js, _, _ = _post(fl.url + "/predict",
                             data=_csv(np.round(X[:3], 6)))
        assert st == 200
        assert np.array_equal(np.asarray(js["predictions"], np.float32),
                              bst_a.predict(xgb.DMatrix(np.round(X[:3], 6))))
        assert fl.spawn_next() == 1
        assert fl.wait_ready(n=2, timeout=120) == 2
        assert fl.drain_replica() == "r1" and fl.count() == 1
    finally:
        fl.stop()
    assert FleetLauncher(pa).device == "cuda"


def test_tenant_quotas_admit_as_the_jax_quotas():
    """``TenantQuotas``: the same admit / shed sequence as the JAX
    package's (an in-flight cap of 2 and a burst of 3 tokens that barely
    refill), each tenant isolated from the other; and through a router
    with ``tenant_inflight=1`` a tenant past its cap sheds 503."""
    jax = pytest.importorskip("jax")
    del jax
    from xgboost_tpu.catalog import TenantQuotas as JaxQuotas
    from xgboost_tpu_torch.catalog import TenantQuotas

    def run(cls):
        q = cls(inflight_limit=2, rate=1e-6, burst=3)
        out = [q.try_admit("a"), q.try_admit("a"), q.try_admit("a"),
               q.try_admit("b")]
        q.release("a")
        out += [q.try_admit("a"), q.try_admit("a"), q.inflight("a"),
                q.inflight("b"), q.enabled]
        return out
    got = run(TenantQuotas)
    assert got == run(JaxQuotas)
    assert got == [None, None, "inflight", None, None, "rate", 2, 1, True]
    rt = FleetRouter(port=0, hc_sec=0, tenant_inflight=1,
                     quiet=True).start()
    stub = _Stub()
    stub.delay = 0.8
    base = f"http://{rt.host}:{rt.port}"
    try:
        _register_stub(base, "s", stub)
        codes = []
        ts = [threading.Thread(target=lambda: codes.append(
            _post(base + "/predict", data=b"0.5")[0])) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert sorted(codes) == [200, 503, 503, 503]
    finally:
        stub.close()
        rt.shutdown()
