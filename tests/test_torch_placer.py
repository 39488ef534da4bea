"""Autonomous placement and the elastic fleet of the PyTorch port
(``xgboost_tpu_torch.placer``) held to ``tests/test_placer.py``: each of
its tests ported onto the port's replicas (``device="cpu"``) and router,
plus the port's plan equal to the JAX ``PlacementController``'s on the
same load, budgets and membership, and the ``RolloutPublisher`` (and
``run_pipeline(router_url=)``) publishing through the port's router.

Covered, as in the JAX file:
(a) end-to-end autonomy: an empty 2-replica fleet plus a placer with a
    4-tenant catalog ends with every tenant placed within device
    budgets and serving through the router;
(b) minimal remap: a load shift rebalances ONLY the shifted tenant(s),
    and the HashRing property holds — a delta moving K of M models
    remaps only keys owned by those K, including under concurrent
    replica death;
(c) failure re-homing: killing one replica re-homes its models onto
    the survivors with zero non-shed request failures afterward;
(d) durability: the target plan round-trips through the CRC-footered
    snapshot, a truncated snapshot replans cold instead of raising,
    and a resumed placer starts from its predecessor's plan;
(e) single-holder lease: a standby placer's ticks are no-ops until the
    holder's lease expires; plan recording from a non-holder is 409;
(f) manifest deltas: the replica ``POST /-/catalog`` surface attaches
    tolerantly, detaches idempotently, and refuses the pinned default;
(g) heartbeat advertisement drift: a catalog delta pushed straight to a
    replica reaches the router's hosting map within ONE heartbeat,
    device budgets ride along, and the diff is counted;
(h) elastic band: the supervisor scales up/down one replica per
    cooldown, holds resizes while a rollout soak is in flight, and
    freezes the fleet when the router is unreachable.
"""

import hashlib
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

import xgboost_tpu_torch as xgb  # noqa: E402
from xgboost_tpu_torch.fleet import (FleetRouter,  # noqa: E402
                                     scrape_labeled_samples)
from xgboost_tpu_torch.fleet.membership import HashRing  # noqa: E402
from xgboost_tpu_torch.fleet.rollout import scrape_samples  # noqa: E402
from xgboost_tpu_torch.placer import (ElasticSupervisor,  # noqa: E402
                                      PlacementController, run_placer)
from xgboost_tpu_torch.serving import run_server  # noqa: E402


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.rand(200, 6).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    bst = xgb.train({"objective": "binary:logistic", "max_depth": 3,
                     "eta": 0.4, "silent": 1},
                    xgb.DMatrix(X, label=y), 3, device="cpu")
    path = str(tmp_path_factory.mktemp("placer") / "model.bin")
    bst.save_model(path)
    return path, X


def _post(url, payload=None, data=None):
    body = (json.dumps(payload).encode() if payload is not None
            else (data or b""))
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, {}


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _csv(rows):
    return "\n".join(",".join(f"{v:.6f}" for v in row)
                     for row in rows).encode()


def _replica(catalog, router_url="", rid="", **kw):
    return run_server("", catalog=catalog, port=0, min_bucket=8,
                      max_bucket=32, max_wait_ms=1.0, poll_sec=0,
                      warmup=False, quiet=True, block=False,
                      router_url=router_url, replica_id=rid,
                      catalog_mb=64.0, device="cpu", **kw)


def _members(rids, models=None, budget=0):
    """A fake /fleet/members payload for pure plan() tests."""
    return {"replicas": [
        {"replica_id": r, "url": f"http://127.0.0.1:1/{r}",
         "in_rotation": True,
         "models": sorted((models or {}).get(r, [])),
         "models_detail": {m: {} for m in (models or {}).get(r, [])},
         "device": {"budget_bytes": budget}}
        for r in rids]}


# ------------------------------------------------- ring minimal remap
@pytest.mark.parametrize("n_replicas,killed", [(4, 1), (6, 2), (3, 1)])
def test_hashring_minimal_remap(n_replicas, killed):
    """(b) a replica death remaps ONLY the keys that replica owned —
    first through eligibility filtering (the concurrent-death view,
    before any rebuild) and then through a rebuild on the survivors,
    and the two agree."""
    ring = HashRing(64)
    rids = [f"r{i}" for i in range(n_replicas)]
    ring.rebuild(rids)
    keys = [f"m{i}#{s}" for i in range(25) for s in range(2)]
    before = {k: ring.route(k, set(rids)) for k in keys}
    assert len(set(before.values())) > 1, "degenerate ring"
    dead = set(rids[:killed])
    live = set(rids) - dead
    # concurrent death: the ring still holds the dead vnodes, dispatch
    # filters by eligibility — survivors' keys must not move
    during = {k: ring.route(k, live) for k in keys}
    moved = [k for k in keys if during[k] != before[k]]
    assert all(before[k] in dead for k in moved)
    assert all(during[k] in live for k in keys)
    # rebuild on the survivors gives the SAME answer: failover is not
    # a transient that a later rebuild reshuffles
    ring.rebuild(sorted(live))
    after = {k: ring.route(k, live) for k in keys}
    assert after == during


def test_plan_minimal_remap_on_load_shift():
    """(b) at the plan level: a load shift on one tenant adds hosts
    for THAT tenant and leaves every other assignment untouched."""
    manifest = {f"t{i}": f"/nonexistent/t{i}.bin" for i in range(8)}
    ctl = PlacementController("http://127.0.0.1:9", manifest,
                              replication=1, hot_replication=2,
                              hot_fraction=0.5)
    rids = ["r0", "r1", "r2", "r3"]
    base = ctl.plan(_members(rids))
    assert all(len(v) == 1 and v[0] in rids for v in base.values())
    ctl.target = base
    # t3 goes hot: >= half the fleet's load -> replication floor 2
    ctl.loads = {t: 0.0 for t in manifest}
    ctl.loads["t3"] = 100.0
    shifted = ctl.plan(_members(rids))
    assert len(shifted["t3"]) == 2 and set(base["t3"]) <= set(shifted["t3"])
    for t in manifest:
        if t != "t3":
            assert shifted[t] == base[t], f"{t} moved on t3's load shift"
    # a replica death moves only ITS tenants (stickiness + ring anchor)
    ctl.target = shifted
    survivors = [r for r in rids if r != "r0"]
    rehomed = ctl.plan(_members(survivors))
    for t in manifest:
        kept = [r for r in shifted[t] if r != "r0"]
        assert set(kept) <= set(rehomed[t])
        if "r0" not in shifted[t]:
            assert rehomed[t] == shifted[t], f"{t} moved on r0's death"
        else:
            assert "r0" not in rehomed[t]


def test_plan_respects_device_budget_and_spills(tmp_path):
    """A tenant is packed onto replicas with headroom; when nothing
    fits it is STILL placed (least-used) — over budget beats orphaned."""
    p = tmp_path / "m.bin"
    p.write_bytes(b"x" * 600)
    manifest = {"a": str(p), "b": str(p), "c": str(p)}
    ctl = PlacementController("http://127.0.0.1:9", manifest)
    target = ctl.plan(_members(["r0", "r1"], budget=1000))
    # each replica fits exactly one 600-byte model under a 1000-byte
    # budget; the third spills instead of orphaning
    placed = [r for hosts in target.values() for r in hosts]
    assert sorted(target) == ["a", "b", "c"]
    assert all(len(v) == 1 for v in target.values())
    assert set(placed) == {"r0", "r1"}


# ---------------------------------------------------- plan durability
def test_plan_snapshot_resume_and_corrupt(tmp_path):
    """(d) CRC-footered snapshot round-trip; truncation replans cold;
    tenants no longer in the manifest are filtered on restore."""
    plan = str(tmp_path / "plan.bin")
    manifest = {"a": "/m/a.bin", "b": "/m/b.bin"}
    ctl = PlacementController("http://127.0.0.1:9", manifest,
                              plan_path=plan)
    ctl.target = {"a": ["r1"], "b": ["r1", "r2"]}
    ctl.plan_seq = 7
    ctl._snapshot_plan()
    assert os.path.exists(plan)
    ctl2 = PlacementController("http://127.0.0.1:9", manifest,
                               plan_path=plan)
    assert ctl2.target == ctl.target and ctl2.plan_seq == 7
    # a tenant dropped from the manifest does not resurrect
    ctl3 = PlacementController("http://127.0.0.1:9", {"a": "/m/a.bin"},
                               plan_path=plan)
    assert ctl3.target == {"a": ["r1"]}
    # truncated snapshot: cold start, no exception
    with open(plan, "r+b") as f:
        f.truncate(10)
    ctl4 = PlacementController("http://127.0.0.1:9", manifest,
                               plan_path=plan)
    assert ctl4.target == {} and ctl4.plan_seq == 0


# -------------------------------------------------------------- lease
def test_placer_lease_single_holder_and_plan_record():
    """(e) one placer drives at a time: the standby's tick is a no-op,
    the holder's death hands over within the lease, and only the
    holder may record a plan (409 otherwise)."""
    rt = FleetRouter(port=0, hc_sec=0, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    try:
        c1 = PlacementController(base, {}, placer_id="p1", lease_sec=1.0)
        c2 = PlacementController(base, {}, placer_id="p2", lease_sec=1.0)
        assert c1._acquire_lease() is True
        assert c2._acquire_lease() is False
        assert c1._acquire_lease() is True          # renewal
        assert c2.tick() == {"standby": True}
        st = _get(base + "/placer/status")
        assert st["holder"] == "p1" and st["lease_remaining_sec"] > 0
        # only the holder records plans
        code, _ = _post(base + "/placer/plan",
                        {"placer_id": "p1",
                         "plan": {"seq": 3, "target": {"a": ["r1"]}}})
        assert code == 200
        code, err = _post(base + "/placer/plan",
                          {"placer_id": "p2", "plan": {"seq": 9}})
        assert code == 409 and err["holder"] == "p1"
        assert _get(base + "/placer/status")["plan"]["seq"] == 3
        # holder stops renewing: the standby takes over after expiry
        time.sleep(1.1)
        assert c2._acquire_lease() is True
        assert _get(base + "/placer/status")["holder"] == "p2"
    finally:
        rt.shutdown()


# ---------------------------------------------------- manifest deltas
def test_catalog_delta_endpoint(model_file, tmp_path):
    """(f) POST /-/catalog: tolerant attach, idempotent detach, the
    pinned default refuses, missing files error without wedging the
    rest of the delta."""
    path, X = model_file
    srv = _replica(f"d={path}")
    base = f"http://127.0.0.1:{srv.port}"
    try:
        st, r = _post(base + "/-/catalog", {"add": {"b": path}})
        assert st == 200 and r["added"] == ["b"]
        assert sorted(r["models"]) == ["b", "d"]
        Q = np.round(X[:3], 6)
        st, pr = _post(base + "/predict?model=b", data=_csv(Q))
        assert st == 200 and pr["model"] == "b" and pr["rows"] == 3
        # retrying the same attach is convergence, not an error
        st, r = _post(base + "/-/catalog", {"add": {"b": path}})
        assert st == 200 and r["skipped"] == ["b"] and not r["added"]
        # missing file errors; the valid part of the delta still lands
        st, r = _post(base + "/-/catalog",
                      {"add": {"c": str(tmp_path / "nope.bin")},
                       "remove": ["b"]})
        assert st == 409 and r["removed"] == ["b"] and r["errors"]
        st, _ = _post(base + "/predict?model=b", data=_csv(Q))
        assert st == 404
        # detach of an unknown name is idempotent
        st, r = _post(base + "/-/catalog", {"remove": ["b"]})
        assert st == 200 and not r["removed"] and not r["errors"]
        # the pinned default never detaches
        st, r = _post(base + "/-/catalog", {"remove": ["d"]})
        assert st == 409 and "default" in r["errors"][0]
        st, _ = _post(base + "/predict", data=_csv(Q))
        assert st == 200
    finally:
        srv.shutdown()


# ------------------------------------------------ heartbeat drift fix
def test_heartbeat_carries_catalog_and_device_drift(model_file):
    """(g) a delta pushed straight to the replica reaches the router's
    hosting map within one heartbeat — the heartbeat payload carries
    the full model map + device budget and the router diffs it."""
    path, _ = model_file
    rt = FleetRouter(port=0, hc_sec=0, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    srv = _replica(f"a={path}", router_url=base, rid="r1")
    try:
        rep = rt.membership.get("r1")
        assert rt.membership.hosting("a") == {"r1"}
        assert rep.device["budget_bytes"] == 64 * 10**6
        before = scrape_samples(
            urllib.request.urlopen(base + "/metrics", timeout=30)
            .read().decode()).get("xgbtpu_fleet_advert_updates_total", 0)
        st, _ = _post(f"http://127.0.0.1:{srv.port}/-/catalog",
                      {"add": {"b": path}})
        assert st == 200
        assert rt.membership.hosting("b") == set()   # not yet heartbeat
        srv.lease_client._heartbeat_once()
        assert rt.membership.hosting("b") == {"r1"}
        assert "b" in rt.membership.get("r1").models
        after = scrape_samples(
            urllib.request.urlopen(base + "/metrics", timeout=30)
            .read().decode())["xgbtpu_fleet_advert_updates_total"]
        assert after >= before + 1
        # an unchanged advertisement is NOT a diff
        srv.lease_client._heartbeat_once()
        final = scrape_samples(
            urllib.request.urlopen(base + "/metrics", timeout=30)
            .read().decode())["xgbtpu_fleet_advert_updates_total"]
        assert final == after
    finally:
        srv.shutdown()
        rt.shutdown()


def test_scrape_labeled_samples():
    text = ("# HELP xgbtpu_tenant_requests_total per-tenant\n"
            'xgbtpu_tenant_requests_total{model="a"} 42\n'
            'xgbtpu_tenant_requests_total{model="b"} 7.5\n'
            'xgbtpu_tenant_shed_total{model="a"} 3\n'
            "xgbtpu_fleet_dispatch_total 9\n")
    assert scrape_labeled_samples(
        text, "xgbtpu_tenant_requests_total") == {"a": 42.0, "b": 7.5}
    assert scrape_labeled_samples(text, "xgbtpu_missing") == {}
    # the unlabeled parser still skips labeled samples (gate contract)
    assert "xgbtpu_tenant_requests_total" not in scrape_samples(text)


# ------------------------------------------------------- elastic band
def test_elastic_supervisor_band():
    """(h) band state machine: scale up above the band, down below it,
    one resize per cooldown, hold while a rollout soak is in flight,
    freeze when the router probe fails."""
    state = {"n": 2, "inflight": 4, "rollout": False}

    def probe():
        return {"members": state["n"], "inflight": state["inflight"],
                "rollout_in_progress": state["rollout"]}

    def spawn():
        state["n"] += 1

    def drain():
        state["n"] -= 1
        return f"r{state['n']}"

    sup = ElasticSupervisor("http://127.0.0.1:9", spawn, drain,
                            lambda: state["n"], min_replicas=1,
                            max_replicas=4, util_low=0.2, util_high=0.6,
                            util_alpha=1.0, replica_slots=4,
                            cooldown_sec=60.0, probe_fn=probe)
    # util = 4 / (4 slots * 2 replicas) = 0.5: inside the band
    assert sup.tick()["state"] == "steady" and state["n"] == 2
    # above the band: one spawn, then the cooldown gates the next
    state["inflight"] = 16
    assert sup.tick()["state"] == "scale_up" and state["n"] == 3
    assert sup.tick()["state"] == "steady" and state["n"] == 3
    sup._last_resize -= 61.0
    # below the band during a rollout soak: HOLD, fleet size pinned
    state["inflight"] = 0
    state["rollout"] = True
    holds0 = sup.metrics.resize_holds.value
    assert sup.tick()["state"] == "hold" and state["n"] == 3
    assert sup.metrics.resize_holds.value == holds0 + 1
    # soak settles: the withheld drain goes through
    state["rollout"] = False
    assert sup.tick()["state"] == "scale_down" and state["n"] == 2
    sup._last_resize -= 61.0
    assert sup.tick()["state"] == "scale_down" and state["n"] == 1
    # the floor: never below min_replicas
    sup._last_resize -= 61.0
    assert sup.tick()["state"] == "steady" and state["n"] == 1
    # router unreachable: freeze, report the error, change nothing
    def bad_probe():
        raise OSError("router down")
    sup.probe_fn = bad_probe
    r = sup.tick()
    assert r["state"] == "steady" and "error" in r and state["n"] == 1


# ------------------------------------------------------- end to end
def test_placer_end_to_end_autonomy(model_file, tmp_path):
    """(a)+(b)+(c)+(d): empty 2-replica fleet + placer + 4-tenant
    manifest -> everything placed and serving; a load shift rebalances
    only the shifted tenant; a replica death re-homes its models with
    every post-convergence request succeeding; a second placer resumes
    the CRC-snapshotted plan."""
    path, X = model_file
    plan_path = str(tmp_path / "placer.plan")
    rt = FleetRouter(port=0, hc_sec=0, lease_sec=30.0, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    s1 = _replica(f"d1={path}", router_url=base, rid="r1")
    s2 = _replica(f"d2={path}", router_url=base, rid="r2")
    manifest = {f"t{i}": path for i in range(1, 5)}
    ctl = run_placer(base, manifest, block=False, plan_path=plan_path,
                     placer_id="e2e", lease_sec=30.0, replication=1,
                     hot_replication=2, hot_fraction=0.5, load_alpha=1.0)

    def heartbeat(*servers):
        for s in servers:
            s.lease_client._heartbeat_once()

    def settle(servers, ticks=4):
        report = {}
        for _ in range(ticks):
            report = ctl.tick()
            heartbeat(*servers)
            if report.get("converged"):
                break
        return report

    try:
        report = settle([s1, s2])
        assert report["converged"], report
        hosted = rt.membership.models_hosted()
        for t in manifest:
            assert hosted.get(t, 0) >= 1, f"{t} orphaned: {hosted}"
        # within budget on both replicas
        for rid in ("r1", "r2"):
            dev = rt.membership.get(rid).device
            assert dev["used_bytes"] <= dev["budget_bytes"]
        # every tenant actually serves through the router
        Q = np.round(X[:3], 6)
        for t in manifest:
            st, pr = _post(base + f"/predict?model={t}", data=_csv(Q))
            assert st == 200 and pr["rows"] == 3, (t, st, pr)
        target0 = {t: list(v) for t, v in ctl.target.items()}
        assert all(len(v) == 1 for v in target0.values())

        # ---- skewed load: t1 takes the whole request stream
        for _ in range(25):
            _post(base + "/predict?model=t1", data=_csv(Q[:1]))
        ctl.tick()                      # observes the shift, replans
        heartbeat(s1, s2)
        target1 = {t: list(v) for t, v in ctl.target.items()}
        assert len(target1["t1"]) == 2, target1   # hot floor kicked in
        assert set(target0["t1"]) <= set(target1["t1"])
        for t in ("t2", "t3", "t4"):
            assert target1[t] == target0[t], "unshifted tenant moved"

        # ---- a resumed placer starts from the snapshotted plan
        ctl2 = run_placer(base, manifest, block=False,
                          plan_path=plan_path, placer_id="resumed")
        assert ctl2.target == ctl.target
        assert ctl2.tick() == {"standby": True}   # e2e holds the lease

        # ---- replica death: its models re-home to the survivor
        victims = {t for t, hosts in target1.items() if "r2" in hosts}
        s2.shutdown()                   # drain deregisters immediately
        report = settle([s1])
        assert report["converged"], report
        for t in manifest:
            assert rt.membership.hosting(t) == {"r1"}, t
        assert victims, "degenerate split: r2 hosted nothing"
        # zero non-shed failures once converged
        for t in manifest:
            st, pr = _post(base + f"/predict?model={t}", data=_csv(Q))
            assert st == 200, (t, st, pr)
    finally:
        s1.shutdown()
        try:
            s2.shutdown()
        except Exception:
            pass
        rt.shutdown()


# ------------------------------------------------- against the JAX plan
def _jax_and_port_controllers(manifest, **kw):
    pytest.importorskip("jax")
    from xgboost_tpu.placer import PlacementController as JaxController
    return [cls("http://127.0.0.1:9", manifest, **kw)
            for cls in (PlacementController, JaxController)]


def test_plan_equals_jax_placement_controller(tmp_path):
    """The port's greedy bin-pack against the JAX controller's on the
    same manifest, loads (one hot tenant), budgets, advertised bytes,
    previous target and membership: equal plans, as dicts, through a
    replica's death; and on a cold fleet (no bytes advertised), where
    both cost a tenant by its file size."""
    manifest = {}
    for i, size in enumerate((900, 400, 1500, 700, 300, 1100)):
        p = tmp_path / f"t{i}.bin"
        p.write_bytes(b"x" * size)
        manifest[f"t{i}"] = str(p)
    hosted = {"r0": ("t0", "t1"), "r1": ("t2", "t3"), "r2": ("t4", "t5")}
    members = {"replicas": [
        {"replica_id": r, "url": f"http://127.0.0.1:1/{r}",
         "in_rotation": True, "models": list(ms),
         "models_detail": {m: {"bytes": 500 + 100 * int(m[1])}
                           for m in ms},
         "device": {"budget_bytes": 2500, "used_bytes": 1200}}
        for r, ms in hosted.items()]}
    ctls = _jax_and_port_controllers(manifest, replication=1,
                                     hot_replication=2, hot_fraction=0.4)
    for ctl in ctls:
        ctl.loads = {t: float(i) for i, t in enumerate(manifest)}
        ctl.loads["t3"] = 50.0
    plans = [ctl.plan(members) for ctl in ctls]
    assert plans[0] == plans[1]
    assert len(plans[0]["t3"]) == 2 and set(plans[0]) == set(manifest)
    for ctl, plan in zip(ctls, plans):
        ctl.target = plan
    members["replicas"] = members["replicas"][1:]
    again = [ctl.plan(members) for ctl in ctls]
    assert again[0] == again[1]
    assert all("r0" not in hosts for hosts in again[0].values())
    cold = {"replicas": [
        {"replica_id": r, "url": f"http://127.0.0.1:1/{r}",
         "in_rotation": True, "models": [], "models_detail": {},
         "device": {"budget_bytes": 2000}} for r in ("r0", "r1", "r2")]}
    ctls = _jax_and_port_controllers(manifest)
    plans = [ctl.plan(cold) for ctl in ctls]
    assert plans[0] == plans[1] and set(plans[0]) == set(manifest)


def test_cold_tenant_costs_an_advertised_engine(tmp_path):
    """The deliberate difference: a cold tenant whose file is smaller
    than the engines the fleet advertises costs the largest of those
    engines in the port (a GPU engine is its graph pools, not its file)
    and its file size in the JAX package.  Two tenants of 300-byte
    files beside 1,000-byte default engines under 2,500-byte budgets:
    the port gives each replica one, the JAX controller packs by file
    size."""
    manifest = {}
    for t in ("a", "b"):
        p = tmp_path / f"{t}.bin"
        p.write_bytes(b"x" * 300)
        manifest[t] = str(p)
    members = {"replicas": [
        {"replica_id": r, "url": f"http://127.0.0.1:1/{r}",
         "in_rotation": True, "models": ["default"],
         "models_detail": {"default": {"bytes": 1000}},
         "device": {"budget_bytes": 2500, "used_bytes": 1000}}
        for r in ("r0", "r1")]}
    port, jax_ctl = _jax_and_port_controllers(manifest)
    assert port._model_cost("a", port._replica_map(members)) == 1000
    assert jax_ctl._model_cost("a", jax_ctl._replica_map(members)) == 300
    plan = port.plan(members)
    assert sorted(h for hosts in plan.values() for h in hosts) == \
        ["r0", "r1"]
    budget_left = {"r0": 1500, "r1": 1500}
    for hosts in plan.values():
        for r in hosts:
            budget_left[r] -= 1000
    assert min(budget_left.values()) >= 0


# ---------------------------------------------------- rollout publisher
def _file_hash(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture()
def rollout_fleet(model_file, tmp_path):
    """A port router over two port replicas, each on its own copy of
    the model file, with a lenient rollout gate."""
    path, X = model_file
    rt = FleetRouter(port=0, hc_sec=0.3, quiet=True,
                     rollout_defaults={"gate_error_rate": 0.5,
                                       "gate_p99_ms": 10_000.0}).start()
    base = f"http://{rt.host}:{rt.port}"
    servers = []
    for rid in ("r1", "r2"):
        m = str(tmp_path / f"{rid}.bin")
        shutil.copyfile(path, m)
        servers.append(run_server(
            m, port=0, min_bucket=8, max_bucket=32, max_wait_ms=1.0,
            poll_sec=0, warmup=False, quiet=True, block=False,
            router_url=base, replica_id=rid, device="cpu"))
    try:
        yield base, servers, X
    finally:
        for s in servers:
            s.shutdown()
        rt.shutdown()


def test_rollout_publisher_through_the_port_router(rollout_fleet,
                                                   tmp_path):
    """``RolloutPublisher`` stages the candidate beside the publish
    path, the router's canary lane rolls it over both replicas, and
    only then are the bytes recorded at the publish path; the fleet
    then answers with the candidate's predictions."""
    from xgboost_tpu_torch.pipeline import RolloutPublisher
    base, servers, X = rollout_fleet
    rng = np.random.RandomState(3)
    Xc = rng.rand(200, 6).astype(np.float32)
    cand = xgb.train({"objective": "binary:logistic", "max_depth": 2,
                      "silent": 1},
                     xgb.DMatrix(Xc, label=(Xc[:, 2] > 0.5)
                                 .astype(np.float32)), 4, device="cpu")
    cpath = str(tmp_path / "candidate.bin")
    cand.save_model(cpath)
    publish = str(tmp_path / "published.bin")
    pub = RolloutPublisher(publish, base, canaries=1, soak_sec=0.2,
                           timeout=60.0)
    out = pub.publish(cpath)
    assert out["mode"] == "rollout" and out["report"]["status"] == "ok"
    assert out["model_hash"] == _file_hash(cpath) == _file_hash(publish)
    assert out["report"]["canaries"] == ["r1"]
    assert not os.path.exists(publish + ".staging")
    for s in servers:
        h = _get(f"http://{s.host}:{s.port}/healthz")
        assert h["model_hash"] == out["model_hash"]
    Q = np.round(X[:4], 6)
    st, pr = _post(base + "/predict", data=_csv(Q))
    assert st == 200
    assert np.array_equal(np.asarray(pr["predictions"], np.float32),
                          cand.predict(xgb.DMatrix(Q)))


def test_pipeline_router_url_publishes_through_the_rollout(
        rollout_fleet, model_file, tmp_path):
    """``run_pipeline(router_url=)``: each gated cycle goes out through
    the fleet's canary rollout, and the replicas end on the published
    bytes."""
    from xgboost_tpu_torch.pipeline import (SyntheticDataSource,
                                            run_pipeline)
    base, servers, _ = rollout_fleet
    path, _ = model_file
    publish = str(tmp_path / "pub" / "model.bin")
    os.makedirs(os.path.dirname(publish))
    shutil.copyfile(path, publish)
    res = run_pipeline(publish, workdir=str(tmp_path / "work"),
                       rounds_per_cycle=2, cycles=1,
                       router_url=base, quiet=True, device="cpu",
                       source=SyntheticDataSource(256, 6, seed=4),
                       params={"objective": "binary:logistic",
                               "max_depth": 3, "silent": 1})
    assert res["published"] == 1, res
    for s in servers:
        h = _get(f"http://{s.host}:{s.port}/healthz")
        assert h["model_hash"] == _file_hash(publish)
