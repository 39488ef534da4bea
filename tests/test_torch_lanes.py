"""Gang-batched tenant lanes of the PyTorch port
(``xgboost_tpu_torch.pipeline.lanes``), held against its own host loop
and against the JAX package's stacked lanes, at ``tests/test_lanes.py``'s
size: 64 rows x 4 features, depth 2, 2 cycles x 2 rounds, three tenants
in a stack of four, on the CPU (fp32; K4's plain version).

Tolerances and why:

- port stacked against port host loop: model bytes identical for every
  tenant.  The stack runs the same f32 operations on each lane's rows,
  pad rows add nothing and leave each lane's int8 scale alone;
- port against the JAX package's stacked lanes, reg:linear: tree
  structure bitwise (which nodes split, on which feature, at which cut
  and default direction; a leaf's cut_index is whatever its rejected
  best candidate was and is no structure), cuts bitwise, leaf values
  and holdout margins at rtol 1e-5: the node totals differ by f32
  rounding (torch and XLA sum in different orders, ROADMAP.md section
  3).  reg:linear because its gradients (margin - label, 1) are exact in
  both packages, so what is compared is the lane machinery;
- binary:logistic (the JAX tests' objective): the same, and the gate
  verdicts equal.  The logistic gradients are bitwise: on the CPU the
  port's ``exp`` is XLA's (before, an ulp of it flipped a near-tie split
  of tenant001 at 64 rows, gain 0.0212, cycle 0, round 1).

The JAX side runs once per objective (module-scoped fixture): its
vmapped scan compiles take seconds each.
"""

import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch.obs import configure_log, lane_metrics  # noqa: E402
from xgboost_tpu_torch.pipeline import (DataSource,  # noqa: E402
                                        SyntheticDataSource,
                                        run_tenant_lanes)
from xgboost_tpu_torch.pipeline.lanes import (LaneGang,  # noqa: E402
                                              _Arrival, _bucket_of)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary:logistic", "max_depth": 2, "eta": 0.3,
          "silent": 1}
N_LANES, CYCLES, ROUNDS = 3, 2, 2
OBJECTIVES = ["reg:linear", "binary:logistic"]


def lane_kwargs(root, mode, name, seed, source_cls=SyntheticDataSource,
                cycles=CYCLES, params=None, **kw):
    d = os.path.join(str(root), mode, name)
    base = {
        "publish_path": os.path.join(d, "model.bin"),
        "workdir": os.path.join(d, "work"),
        "source": source_cls(n_rows=64, n_features=4, seed=seed),
        "rounds_per_cycle": ROUNDS, "cycles": cycles,
        "params": dict(params or PARAMS),
    }
    base.update(kw)
    return base


def make_lanes(root, mode, n=N_LANES, **kw):
    return {f"tenant{i:03d}": lane_kwargs(root, mode, f"tenant{i:03d}",
                                          100 + i, **kw)
            for i in range(n)}


def model_bytes(kwargs):
    with open(kwargs["publish_path"], "rb") as f:
        return f.read()


def gated_cycles(kwargs):
    with open(os.path.join(kwargs["workdir"], "gated.log")) as f:
        return [int(line.split()[0]) for line in f]


def lane_counts():
    lm = lane_metrics()
    return {"dispatches": lm.dispatches.value, "stacked": lm.stacked.value,
            "padded": lm.padded.value, "restacks": lm.restacks.value}


def counts_delta(before):
    after = lane_counts()
    return {k: after[k] - before[k] for k in before}


def assert_all_ok(results):
    for name, r in results.items():
        assert r["status"] == "ok", (name, r)


def run_port(root, mode, stacked, **kw):
    lanes = make_lanes(root, mode, **kw)
    before = lane_counts()
    res = run_tenant_lanes(lanes, quiet=True, stacked=stacked,
                           window_sec=2.0, device="cpu")
    return lanes, res, counts_delta(before)


@pytest.fixture(scope="module", params=OBJECTIVES)
def runs(request, tmp_path_factory):
    """Per objective: the JAX package's stacked lanes, the port's stacked
    lanes and the port's host loop on the same SyntheticDataSource
    seeds."""
    from xgboost_tpu.pipeline import SyntheticDataSource as JaxSource
    from xgboost_tpu.pipeline import run_tenant_lanes as jax_run
    obj = request.param
    params = dict(PARAMS, objective=obj)
    root = tmp_path_factory.mktemp(obj.replace(":", "_"))
    jlanes = make_lanes(root, "jax", source_cls=JaxSource, params=params)
    jres = jax_run(jlanes, quiet=True, stacked=True, window_sec=2.0)
    out = {"obj": obj, "jax": (jlanes, jres)}
    out["stacked"] = run_port(root, "stacked", True, params=params)
    out["host"] = run_port(root, "host", False, params=params)
    return out


def _state(path):
    return xt.Booster(model_file=path, device="cpu").gbtree.get_state()


def _assert_structure_equal(a, b, trees=slice(None)):
    a = {k: v[trees] for k, v in a.items() if k.startswith("tree_")}
    b = {k: v[trees] for k, v in b.items() if k.startswith("tree_")}
    np.testing.assert_array_equal(a["tree_feature"], b["tree_feature"])
    np.testing.assert_array_equal(a["tree_is_leaf"], b["tree_is_leaf"])
    split = a["tree_feature"] >= 0
    for k in ("tree_cut_index", "tree_threshold", "tree_default_left"):
        np.testing.assert_array_equal(a[k][split], b[k][split], err_msg=k)


# ---------------------------------------------------- stacked == host loop
def test_stacked_bytes_equal_host_loop(runs):
    """Every tenant's published bytes and cycle outcomes: stacked ==
    host loop; one stacked dispatch per cycle for the whole bucket, with
    the pad accounting of a width-4 stack."""
    s_lanes, s_res, s_delta = runs["stacked"]
    h_lanes, h_res, h_delta = runs["host"]
    assert_all_ok(s_res)
    assert_all_ok(h_res)
    for name in s_lanes:
        assert model_bytes(s_lanes[name]) == model_bytes(h_lanes[name]), \
            name
        assert s_res[name]["summary"] == h_res[name]["summary"]
        assert gated_cycles(s_lanes[name]) == gated_cycles(h_lanes[name])
    assert s_delta["dispatches"] == CYCLES
    assert s_delta["stacked"] == N_LANES * CYCLES
    assert s_delta["padded"] == (4 - N_LANES) * CYCLES
    assert h_delta["dispatches"] == 0


# --------------------------------------------------------- against the JAX
def test_first_tree_matches_jax_lanes(runs):
    """Tree 0 of every tenant: bitwise structure against the JAX
    package's stacked lanes, leaf values at rtol 1e-5; cuts bitwise."""
    jlanes, _ = runs["jax"]
    s_lanes = runs["stacked"][0]
    for name in jlanes:
        sj = _state(jlanes[name]["publish_path"])
        st = _state(s_lanes[name]["publish_path"])
        for k in ("cut_values", "cut_n", "tree_group_arr"):
            np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
        assert st["tree_feature"].shape == (CYCLES * ROUNDS, 7)
        _assert_structure_equal(sj, st, slice(0, 1))
        np.testing.assert_allclose(st["tree_leaf_value"][0],
                                   sj["tree_leaf_value"][0], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("runs", ["reg:linear"], indirect=True)
def test_published_models_match_jax_lanes_reg_linear(runs):
    """reg:linear: every published tree bitwise in structure, leaf values
    and holdout margins at rtol 1e-5."""
    _assert_published_models_match(runs)


@pytest.mark.parametrize("runs", ["binary:logistic"], indirect=True)
def test_published_models_match_jax_lanes_binary_logistic(runs):
    """binary:logistic, the same holds: the logistic gradients are
    bitwise since the port's CPU exp is XLA's."""
    _assert_published_models_match(runs)


def _assert_published_models_match(runs):
    jlanes, _ = runs["jax"]
    s_lanes = runs["stacked"][0]
    for i, name in enumerate(jlanes):
        sj = _state(jlanes[name]["publish_path"])
        st = _state(s_lanes[name]["publish_path"])
        _assert_structure_equal(sj, st)
        np.testing.assert_allclose(st["tree_leaf_value"],
                                   sj["tree_leaf_value"], rtol=1e-5,
                                   atol=1e-7)
        X = np.random.RandomState(100 + i).rand(256, 4).astype(np.float32)
        mj = xt.Booster(model_file=jlanes[name]["publish_path"],
                        device="cpu").predict(X, output_margin=True)
        mt = xt.Booster(model_file=s_lanes[name]["publish_path"],
                        device="cpu").predict(X, output_margin=True)
        np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=1e-6)


def test_gate_verdicts_match_jax_lanes(runs):
    """Every tenant publishes (or gate-fails) the same cycles in both
    packages; the cycle summaries are equal."""
    jlanes, jres = runs["jax"]
    s_lanes, s_res, _ = runs["stacked"]
    assert_all_ok(jres)
    for name in jlanes:
        assert s_res[name]["summary"] == jres[name]["summary"], name
        assert gated_cycles(s_lanes[name]) == gated_cycles(jlanes[name])


# -------------------------------------------------------------- bucket key
def test_bucket_of_groups_by_shape_and_pads_rows():
    def spec(n_rows=100, n_features=4, w=7, subsample=1.0, K=1,
             dtype=torch.uint8):
        return SimpleNamespace(
            n_rows=n_rows, n_features=n_features, subsample=subsample,
            binned=torch.zeros((n_rows, n_features), dtype=dtype),
            cut_values=torch.zeros((n_features, w)), K=K, npar=1,
            n_rounds=2, seg_k=64, cfg="cfg", grad_fn="g")

    # rows pad to a shared power-of-two bucket (floor 64) at subsample 1
    assert _bucket_of(spec(n_rows=65)) == _bucket_of(spec(n_rows=100))
    assert _bucket_of(spec(n_rows=64)) != _bucket_of(spec(n_rows=100))
    assert _bucket_of(spec(n_rows=3)) == _bucket_of(spec(n_rows=64))
    # subsample < 1 draws are N-shaped: exact rows only
    assert (_bucket_of(spec(n_rows=65, subsample=0.5))
            != _bucket_of(spec(n_rows=100, subsample=0.5)))
    # cut width pads to a power of two (floor 8); features never pad
    assert _bucket_of(spec(w=5)) == _bucket_of(spec(w=8))
    assert _bucket_of(spec(w=9)) != _bucket_of(spec(w=8))
    assert _bucket_of(spec(n_features=5)) != _bucket_of(spec())
    assert _bucket_of(spec(K=2)) != _bucket_of(spec())
    assert _bucket_of(spec(dtype=torch.int32)) != _bucket_of(spec())


# --------------------------------------------------------------- isolation
def test_gate_fail_isolated_from_neighbors(tmp_path):
    lanes_s = make_lanes(tmp_path, "stacked", 2)
    lanes_s["picky"] = lane_kwargs(tmp_path, "stacked", "picky", 999,
                                   min_delta=1e9)
    res_s = run_tenant_lanes(lanes_s, quiet=True, stacked=True,
                             window_sec=2.0, device="cpu")
    lanes_h = make_lanes(tmp_path, "solo", 2)
    res_h = run_tenant_lanes(lanes_h, quiet=True, stacked=False,
                             device="cpu")
    assert_all_ok(res_s)
    assert_all_ok(res_h)
    assert res_s["picky"]["summary"]["gate_failed"] == CYCLES - 1
    assert os.listdir(os.path.join(lanes_s["picky"]["workdir"],
                                   "quarantine"))
    for name in lanes_h:
        assert model_bytes(lanes_s[name]) == model_bytes(lanes_h[name])


class _CrashOnCycle(DataSource):
    def __init__(self, crash_cycle, seed):
        self.crash_cycle = crash_cycle
        self.inner = SyntheticDataSource(n_rows=64, n_features=4,
                                         seed=seed)

    def next_cycle(self, cycle):
        if cycle == self.crash_cycle:
            raise RuntimeError("poisoned source cycle")
        return self.inner.next_cycle(cycle)


def test_crashing_lane_isolated_from_neighbors(tmp_path):
    lanes_s = make_lanes(tmp_path, "stacked", 2)
    lanes_s["crashy"] = lane_kwargs(
        tmp_path, "stacked", "crashy", 999,
        source=_CrashOnCycle(crash_cycle=1, seed=999))
    res_s = run_tenant_lanes(lanes_s, quiet=True, stacked=True,
                             window_sec=0.2, device="cpu")
    lanes_h = make_lanes(tmp_path, "solo", 2)
    res_h = run_tenant_lanes(lanes_h, quiet=True, stacked=False,
                             device="cpu")
    assert_all_ok(res_h)
    assert res_s["crashy"]["status"] == "ok"
    assert res_s["crashy"]["summary"]["errors"] >= 1
    for name in lanes_h:
        assert res_s[name]["status"] == "ok"
        assert model_bytes(lanes_s[name]) == model_bytes(lanes_h[name])


# -------------------------------------------------------------- the switch
def test_lane_stack_env_switch(tmp_path, monkeypatch):
    """XGBTPU_LANE_STACK=0 routes through the host loop (no stacked
    dispatch), with the same bytes as the stacked default."""
    monkeypatch.setenv("XGBTPU_LANE_STACK", "0")
    off = make_lanes(tmp_path, "env_off", 2, cycles=1)
    before = lane_counts()
    assert_all_ok(run_tenant_lanes(off, quiet=True, device="cpu"))
    assert counts_delta(before)["dispatches"] == 0
    monkeypatch.setenv("XGBTPU_LANE_STACK", "1")
    on = make_lanes(tmp_path, "env_on", 2, cycles=1)
    before = lane_counts()
    assert_all_ok(run_tenant_lanes(on, quiet=True, window_sec=2.0,
                                   device="cpu"))
    assert counts_delta(before)["dispatches"] == 1
    for name in on:
        assert model_bytes(on[name]) == model_bytes(off[name])


# ------------------------------------------------------ steady-bucket carry
def _boosters(n=4, **params):
    out = []
    for i in range(n):
        rng = np.random.RandomState(300 + i)
        X = rng.rand(70 + 9 * i, 4).astype(np.float32)   # one bucket
        y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
        d = xt.DMatrix(X, label=y)
        out.append((xt.Booster(dict(PARAMS, seed=300 + i, **params), [d],
                               device="cpu"), d))
    return out


def test_carry_reuses_the_stack_and_stays_identical():
    """Long-lived boosters re-dispatching one bucket restack once; the
    bytes equal round-for-round solo runs."""
    gang = LaneGang(expected=0)
    stacked = _boosters()
    before = lane_counts()
    for cycle in range(3):
        arrs = []
        for i, (b, d) in enumerate(stacked):
            spec, why = b.fused_lane_spec(d, cycle * 2, 2)
            assert spec is not None, why
            arrs.append(_Arrival(f"lane{i}", spec, lambda it: None))
        gang._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
        assert all(a.exc is None for a in arrs)
    delta = counts_delta(before)
    assert delta["dispatches"] == 3
    assert delta["restacks"] == 1      # cycles 2 and 3 rode the carry
    solo = _boosters()
    for cycle in range(3):
        for b, d in solo:
            b.update_many(d, cycle * 2, 2)
    for (bs, _), (bh, _) in zip(stacked, solo):
        assert bs.save_raw() == bh.save_raw()


def test_carry_rebuilds_when_a_lane_changes():
    gang = LaneGang(expected=0)
    lanes = _boosters(2)
    before = lane_counts()
    for cycle in range(2):
        arrs = []
        for i, (b, d) in enumerate(lanes):
            if cycle == 1 and i == 1:   # fresh data for one tenant
                d = xt.DMatrix(np.asarray(d.dense_source()[0]) * 0.5,
                               label=d.get_label())
            spec, _ = b.fused_lane_spec(d, cycle * 2, 2)
            arrs.append(_Arrival(f"lane{i}", spec, lambda it: None))
        gang._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
    assert counts_delta(before)["restacks"] == 2


# -------------------------------------------------------------- solo lanes
def test_ensemble_lanes_run_solo_loudly(tmp_path):
    """Lanes with more than one tree per round decline stacking
    (reason ``ensemble``): they run solo through K3, counted and logged,
    with the host loop's bytes."""
    params = dict(PARAMS, objective="multi:softprob", num_class=3)

    class ThreeClass(SyntheticDataSource):
        def _draw(self, seed, n):
            rng = np.random.RandomState(seed)
            X = rng.rand(n, self.n_features).astype(np.float32)
            return xt.DMatrix(X, label=np.floor(X[:, 0] * 3).astype(
                np.float32))

    log = tmp_path / "events.jsonl"
    configure_log(str(log))
    try:
        solo_before = lane_metrics().solo.value("ensemble")
        before = lane_counts()
        lanes_s = make_lanes(tmp_path, "stacked", 2,
                             source_cls=ThreeClass, params=params)
        assert_all_ok(run_tenant_lanes(lanes_s, quiet=True, stacked=True,
                                       window_sec=2.0, device="cpu"))
    finally:
        configure_log(None)
    assert lane_metrics().solo.value("ensemble") - solo_before == 2 * CYCLES
    assert counts_delta(before)["dispatches"] == 0
    events = [json.loads(line) for line in log.read_text().splitlines()]
    solo = [e for e in events if e["name"] == "lanes.solo"]
    assert len(solo) == 2 * CYCLES
    assert {e["attrs"]["reason"] for e in solo} == {"ensemble"}
    lanes_h = make_lanes(tmp_path, "host", 2, source_cls=ThreeClass,
                         params=params)
    assert_all_ok(run_tenant_lanes(lanes_h, quiet=True, stacked=False,
                                   device="cpu"))
    for name in lanes_s:
        assert model_bytes(lanes_s[name]) == model_bytes(lanes_h[name])


def test_a_solo_lane_does_not_split_its_peers_batch(tmp_path):
    """One ensemble lane (solo every cycle) beside two stackable lanes:
    still one stacked dispatch per cycle for the two."""
    lanes = make_lanes(tmp_path, "mixed", 2)
    lanes["forest"] = lane_kwargs(tmp_path, "mixed", "forest", 7,
                                  params=dict(PARAMS, num_parallel_tree=2))
    before = lane_counts()
    assert_all_ok(run_tenant_lanes(lanes, quiet=True, stacked=True,
                                   window_sec=30.0, device="cpu"))
    delta = counts_delta(before)
    assert delta["dispatches"] == CYCLES
    assert delta["stacked"] == 2 * CYCLES


def test_fused_lane_spec_reasons():
    (b, d), = _boosters(1)
    assert b.fused_lane_spec(d, 0, 0) == (None, "no_rounds")
    spec, why = b.fused_lane_spec(d, 0, 3)
    assert why is None and spec.n_rows == 70 and spec.seg_k == 64
    (b, d), = _boosters(1, gamma=0.5)
    assert b.fused_lane_spec(d, 0, 2) == (None, "prune")
    (b, d), = _boosters(1, rounds_per_dispatch=0)
    assert b.fused_lane_spec(d, 0, 2) == (None, "rounds_per_dispatch_0")
    (b, d), = _boosters(1, num_parallel_tree=2)
    assert b.fused_lane_spec(d, 0, 2) == (None, "ensemble")


# ------------------------------------------------------------ the growers
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_lane_growth_equals_solo_growth(precision):
    """``grow_trees`` over lane bins (own cuts, pad rows, a pad lane)
    equals ``grow_tree`` per lane on its unpadded rows, every field
    bitwise, signs of zero included."""
    from xgboost_tpu_torch.models.tree import GrowConfig, grow_tree, grow_trees
    from xgboost_tpu_torch.ops.split import SplitConfig
    rng = np.random.RandomState(8)
    L, N, F, B, W = 4, 512, 5, 16, 14
    n_real = [512, 480, 131, 0]
    cfg = GrowConfig(split=SplitConfig(min_child_weight=0.5, eta=0.3),
                     max_depth=3, n_bin=B, hist_precision=precision)
    binned = torch.from_numpy(rng.randint(0, B, (L, N, F)).astype(np.uint8))
    gh = rng.randn(L, N, 2).astype(np.float32)
    gh[..., 1] = np.abs(gh[..., 1]) + 0.1
    cuts = np.sort(rng.rand(L, F, W).astype(np.float32), axis=-1)
    n_cuts = rng.randint(3, W + 1, (L, F)).astype(np.int32)
    valid = np.zeros((L, N), bool)
    for lane, n in enumerate(n_real):
        valid[lane, :n] = True
        cuts[lane, :, :][np.arange(W)[None, :] >= n_cuts[lane][:, None]] = \
            np.inf
    gh_t, cuts_t = torch.from_numpy(gh), torch.from_numpy(cuts)
    nc_t, rv_t = torch.from_numpy(n_cuts), torch.from_numpy(valid)
    trees, row_leaf, row_val = grow_trees(binned, gh_t, cuts_t, nc_t, cfg,
                                          rv_t)
    for lane, n in enumerate(n_real[:-1]):
        w = int(n_cuts[lane].max())   # solo cuts: the lane's own width
        tree, leaf, val = grow_tree(
            binned[lane, :n].contiguous(), gh_t[lane, :n].contiguous(),
            cuts_t[lane, :, :w].contiguous(), nc_t[lane], cfg)
        for field, a, b in zip(tree._fields, trees, tree):
            assert torch.equal(a[lane], b), (lane, field)
            if a.dtype.is_floating_point:
                assert torch.equal(torch.signbit(a[lane]),
                                   torch.signbit(b)), (lane, field)
        assert torch.equal(row_leaf[lane, :n], leaf)
        assert torch.equal(row_val[lane, :n], val)
    assert not bool(row_val[3].any())
    assert not bool(row_val[:, 512:].any())


def test_scan_rounds_lanes_equals_solo_rounds():
    """A segment of three rounds over a padded stack == three solo
    ``do_boost`` rounds per lane: trees and margins bitwise."""
    from xgboost_tpu_torch.models.gbtree import (scan_rounds_lanes,
                                                 unstack_lane_flats)
    from xgboost_tpu_torch.pipeline.lanes import _stack_bucket
    lanes = _boosters(3)
    specs = [b.fused_lane_spec(d, 0, 3)[0] for b, d in lanes]
    key = _bucket_of(specs[0])
    cols = _stack_bucket(specs, 4, key[0], key[2])
    binned, margin, label, weight, cuts, ncut, valid = cols
    margin, stacks = scan_rounds_lanes(
        binned, margin, label, weight, cuts, ncut, valid, n_rounds=3,
        cfg=specs[0].cfg, grad_fn=specs[0].grad_fn)
    flats = unstack_lane_flats(stacks, 4)
    for i, (b, d) in enumerate(_boosters(3)):
        b.update_many(d, 0, 3)
        st = b.gbtree._stack(0)[0]
        for field, x, y in zip(st._fields, flats[i], st):
            assert torch.equal(x, y), (i, field)
        entry = b._entry(d)
        assert torch.equal(margin[i, :entry.margin.shape[0]], entry.margin)


# ---------------------------------------------------------- the port alone
def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|xgboost_tpu)\b",
                     re.M)
    root = os.path.join(REPO, "xgboost_tpu_torch")
    seen = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                seen += 1
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert not pat.search(text), os.path.join(dirpath, f)
                # also no importlib / __import__ of them
                assert "import_module(\"jax" not in text
                assert "__import__(\"jax" not in text
    assert seen >= 30
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())


def test_entry_points_default_to_the_gpu(tmp_path):
    """``device`` defaults to cuda: without a GPU the entry points raise
    rather than run on the CPU unasked; a router URL publishes through
    the fleet's canary rollout (``RolloutPublisher``)."""
    from xgboost_tpu_torch.pipeline import RolloutPublisher, run_pipeline
    kw = lane_kwargs(tmp_path, "dev", "t", 1)
    seen = {}

    class Capture:
        def __init__(self, *args, publisher=None, **kwargs):
            seen["publisher"] = publisher

        def run(self, cycles, sleep_sec):
            return {}
    run_pipeline(router_url="http://localhost:1", device="cpu",
                 trainer_cls=Capture, **kw)
    assert isinstance(seen["publisher"], RolloutPublisher)
    assert seen["publisher"].router_url == "http://localhost:1"
    if torch.cuda.is_available():
        return   # the default is a real card here
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_tenant_lanes({"t": kw}, quiet=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline(**kw)


def jax_lanes_auc(n_tenants: int, workdir: str) -> list:
    """The JAX package's own stacked lanes on ``chip_smoke.py``'s
    ``[lanes]`` tenants (the first ``n_tenants``): the same arrays,
    parameters, cycles and rounds, on the CPU.  Returns each tenant's
    holdout AUC of its last published model; ``chip_smoke.py``'s
    ``LANE_AUC_FLOOR`` is the lowest of them minus 0.005."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import xgboost_tpu as xj
    from xgboost_tpu.pipeline import CallableDataSource as JaxCallable
    from xgboost_tpu.pipeline import run_tenant_lanes as jax_run
    data = [cs.tenant_arrays(i) for i in range(n_tenants)]
    lanes = {}
    for i, (X, y, Xh, yh) in enumerate(data):
        pair = (xj.DMatrix(X, label=y), xj.DMatrix(Xh, label=yh))
        d = os.path.join(workdir, f"tenant{i:02d}")
        lanes[f"tenant{i:02d}"] = {
            "publish_path": os.path.join(d, "model.bin"),
            "workdir": os.path.join(d, "work"),
            "source": JaxCallable(lambda c, p=pair: p),
            "rounds_per_cycle": cs.LANE_ROUNDS, "cycles": cs.LANE_CYCLES,
            "metric": "auc", "params": dict(cs.LANE_PARAMS)}
    res = jax_run(lanes, quiet=True, stacked=True, window_sec=600.0)
    aucs = []
    for i, (name, kw) in enumerate(lanes.items()):
        assert res[name]["status"] == "ok", res[name]
        bst = xj.Booster(model_file=kw["publish_path"])
        bst.set_param("eval_metric", "auc")
        msg = bst.eval_set([(xj.DMatrix(data[i][2], label=data[i][3]),
                             "h")])
        aucs.append(float(msg.rsplit(":", 1)[1]))
    return aucs


if __name__ == "__main__":
    # python tests/test_torch_lanes.py [N_TENANTS]: the JAX package's
    # holdout AUC on chip_smoke.py's tenant lanes (JAX_PLATFORMS=cpu)
    import sys
    import tempfile
    import time
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        aucs = jax_lanes_auc(n, tmp)
    print(json.dumps({"tenants": n, "auc": aucs, "min": min(aucs),
                      "floor": min(aucs) - 0.005,
                      "seconds": time.perf_counter() - t0}))
