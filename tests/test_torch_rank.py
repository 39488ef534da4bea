"""LambdaRank in the PyTorch port against the JAX package, on the CPU:
``rank:pairwise|ndcg|map`` on the group-padded and the sort layouts, the
host path, the layout gate, the path line, model files and the CLI.

Data: 48 groups of 8-29 rows (``RandomState`` seeds below), labels 0-2
from a noisy score, depth 3, 4 rounds.

Tolerances and why:

- the tables of both layouts, the host path's gradients and the partner
  draws: bitwise (the same numpy code; threefry bit for bit);
- device gradients: ``|got - want| <= 16 ulp(want) + 2^-21 (1 + n_other)
  s``, with n_other the rows of other labels in the row's group and s
  the pair scale (``1 / num_pairsample``, times ``fix_list_weight /
  g_size``).  XLA's ``log`` and its logistic round differently from
  torch's, by an ulp or two; the NDCG weight is a difference of two
  such sums, divided by the IDCG, which turns those ulps into an
  absolute error of a few 2^-24 of the pair's weight, and a row adds
  its own side and ``ratio <= n_other`` times the side it receives;
- padded training: tree structure bitwise and eval lines equal (the
  gradients differ by the ulps above only, far from any split);
- sort-path training: the trained NDCG / MAP within 0.05 of the JAX
  package's, the bound its own tests hold between its two layouts
  (``tests/test_rank_padded.py``): XLA's unstable sort orders tied
  predictions its own way, so the pair weights of round 0 differ;
- model files: predictions bitwise in either package (same trees, same
  bins, leaves added in the same order).
"""

import contextlib
import io
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu import rank_device as jrd  # noqa: E402
from xgboost_tpu.rank_obj import LambdaRankObj as JRank  # noqa: E402
from xgboost_tpu.data import MetaInfo as JMeta  # noqa: E402
from xgboost_tpu_torch import random as prng  # noqa: E402
from xgboost_tpu_torch import rank_device as trd  # noqa: E402
from xgboost_tpu_torch.data import MetaInfo as TMeta  # noqa: E402
from xgboost_tpu_torch.rank_obj import LambdaRankObj as TRank  # noqa: E402

KINDS = ["pairwise", "ndcg", "map"]
CONFIGS = [(1, 0.0), (2, 0.0), (1, 2.5)]   # (num_pairsample, fix_list_weight)
PARAMS = {"max_depth": 3, "eta": 0.3, "max_bin": 32,
          "hist_precision": "fp32"}
ROUNDS = 4


def make_ranking(seed=0, n_groups=48, lo=8, hi=30, F=6):
    rng = np.random.RandomState(seed)
    rows, labels, groups = [], [], []
    for _ in range(n_groups):
        n = rng.randint(lo, hi)
        Xg = rng.rand(n, F).astype(np.float32)
        score = Xg[:, 0] * 2 + Xg[:, 1] - 0.5 * Xg[:, 2] + 0.3 * rng.randn(n)
        rel = np.zeros(n, np.int32)
        order = np.argsort(-score)
        rel[order[:max(1, n // 6)]] = 2
        rel[order[max(1, n // 6):max(2, n // 3)]] = 1
        rows.append(Xg)
        labels.append(rel)
        groups.append(n)
    return (np.concatenate(rows), np.concatenate(labels).astype(np.float32),
            np.array(groups))


@pytest.fixture(scope="module")
def data():
    X, y, groups = make_ranking()
    return X, y, groups, np.concatenate([[0], np.cumsum(groups)])


def _bound(want, n_other, scale):
    want = np.asarray(want, np.float32)
    return (16 * np.spacing(np.abs(want))
            + 2.0 ** -21 * (1.0 + n_other)[:, None] * scale[:, None])


def _scale(nps, flw, g_size):
    s = np.full(g_size.shape, 1.0 / nps)
    return s * flw / g_size if flw else s


# --------------------------------------------------------------- tables
@pytest.mark.parametrize("n_pad", [0, 7], ids=["exact", "tail"])
def test_build_prep_matches_the_jax_package(data, n_pad):
    _, y, _, gptr = data
    n = len(y) + n_pad
    want = jrd.build_prep(y, gptr, n)
    got = trd.build_prep(y, gptr, n, "cpu")
    for f in trd.RankPrep._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("tail", [0, 5])
def test_build_pad_prep_matches_the_jax_package(data, tail):
    _, y, _, gptr = data
    labels = np.concatenate([y, np.ones(tail, np.float32)])
    want = jrd.build_pad_prep(labels, gptr)
    got = trd.build_pad_prep(labels, gptr, "cpu")
    assert (got.G, got.L, got.n_tail) == (want.G, want.L, want.n_tail)
    for f in ("label", "valid", "g_size", "b_lo", "b_sz", "idcg",
              "pad_map", "user_map"):
        g = getattr(got, f)
        np.testing.assert_array_equal(
            g.numpy() if isinstance(g, torch.Tensor) else g,
            np.asarray(getattr(want, f)), err_msg=f)


# ------------------------------------------------------------ gradients
def _objectives(kind, nps, flw, impl, seed=3):
    out = []
    for cls in (JRank, TRank):
        o = cls(f"rank:{kind}")
        for k, v in (("num_pairsample", nps), ("fix_list_weight", flw),
                     ("rank_impl", impl), ("seed", seed)):
            o.set_param(k, v)
        out.append(o)
    return out


def _infos(y, groups):
    infos = []
    for cls in (JMeta, TMeta):
        info = cls()
        info.set_field("label", y)
        info.set_field("group", groups)
        infos.append(info)
    return infos


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nps,flw", CONFIGS)
def test_host_gradient_bitwise(data, kind, nps, flw):
    _, y, groups, _ = data
    margin = np.random.RandomState(5).randn(len(y), 1).astype(np.float32)
    jo, to = _objectives(kind, nps, flw, "host")
    ji, ti = _infos(y, groups)
    for it in (0, 3):
        want = np.asarray(jo.get_gradient(jnp.asarray(margin), ji, it,
                                          len(y)))
        got = to.get_gradient(torch.from_numpy(margin), ti, it).numpy()
        assert got.shape == (len(y), 1, 2)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nps,flw", CONFIGS)
def test_padded_gradient_partners_bitwise_and_within_ulps(data, kind, nps,
                                                          flw):
    _, y, _, gptr = data
    jp = jrd.build_pad_prep(y, gptr)
    tp = trd.build_pad_prep(y, gptr, "cpu")
    n = jp.G * jp.L + jp.n_tail
    pred = np.random.RandomState(6).randn(n).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(4177 + 3), 5)
    tkey = prng.fold_in(prng.PRNGKey(4177 + 3), 5)
    n_other = np.maximum(np.asarray(jp.g_size) - np.asarray(jp.b_sz), 1)
    for k in range(nps):
        u = jax.random.randint(jax.random.fold_in(jkey, k), (jp.G, jp.L),
                               0, 1 << 30) % jnp.asarray(n_other)
        want_lanes = np.asarray(jnp.where(u < jp.b_lo, u, u + jp.b_sz))
        np.testing.assert_array_equal(
            trd.pad_partners(tkey, k, tp).numpy(), want_lanes)
    want = np.asarray(jrd.rank_gradient_padded(jnp.asarray(pred), jkey, jp,
                                               kind, nps, flw))
    got = trd.rank_gradient_padded(torch.from_numpy(pred), tkey, tp, kind,
                                   nps, flw).numpy()
    g_size = np.broadcast_to(np.asarray(jp.g_size), n_other.shape)
    bound = _bound(want, n_other.reshape(-1),
                   _scale(nps, flw, g_size.reshape(-1)))
    assert (np.abs(got - want) <= bound).all()
    valid = np.asarray(jp.valid).reshape(-1)
    assert (got[~valid] == 0).all()


def _sort_case(data, kind, nps, flw, pred):
    _, y, _, gptr = data
    n = len(y)
    jp = jrd.build_prep(y, gptr, n)
    tp = trd.build_prep(y, gptr, n, "cpu")
    jkey = jax.random.fold_in(jax.random.PRNGKey(4177), 2)
    tkey = prng.fold_in(prng.PRNGKey(4177), 2)
    n_other = np.maximum(np.asarray(jp.g_size) - np.asarray(jp.b_sz), 1)
    for k in range(nps):
        u = jax.random.randint(jax.random.fold_in(jkey, k), (n,), 0,
                               1 << 30) % jnp.asarray(n_other)
        lab_pos = jnp.where(u < jp.b_lo, u, u + jp.b_sz)
        want_rows = np.asarray(jp.lab_order[jp.g_start + lab_pos])
        np.testing.assert_array_equal(
            trd.sort_partners(tkey, k, tp).numpy(), want_rows)
    want = np.asarray(jrd.rank_gradient(jnp.asarray(pred), jkey, jp, kind,
                                        nps, flw))
    got = trd.rank_gradient(torch.from_numpy(pred), tkey, tp, kind, nps,
                            flw).numpy()
    bound = _bound(want, n_other, _scale(nps, flw, np.asarray(jp.g_size)))
    return got, want, bound, tp


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nps,flw", CONFIGS)
def test_sort_gradient_without_ties_within_ulps(data, kind, nps, flw):
    """Predictions drawn from the seed have no ties within a group, so
    the places by prediction are the JAX package's."""
    n = len(data[1])
    pred = np.random.RandomState(7).randn(n).astype(np.float32)
    got, want, bound, _ = _sort_case(data, kind, nps, flw, pred)
    assert (np.abs(got - want) <= bound).all()


def test_sort_gradient_with_ties(data):
    """All predictions tied (round 0 without a base margin): pairwise
    reads no places and still matches; the port orders tied rows of a
    group by row id (ROADMAP.md section 3)."""
    n = len(data[1])
    pred = np.zeros(n, np.float32)
    got, want, bound, tp = _sort_case(data, "pairwise", 1, 0.0, pred)
    assert (np.abs(got - want) <= bound).all()
    pred = np.random.RandomState(8).randint(0, 3, n).astype(np.float32)
    order = trd.pred_order(torch.from_numpy(pred), tp).numpy()
    gptr = data[3]
    for g in range(len(gptr) - 1):
        rows = np.arange(gptr[g], gptr[g + 1])
        np.testing.assert_array_equal(
            order[gptr[g]:gptr[g + 1]],
            rows[np.lexsort((rows, -pred[rows]))])


# ------------------------------------------------------------- training
def _train(pkg, kind, X, y, groups, rounds=ROUNDS, extra=None, **kw):
    d = pkg.DMatrix(X, label=y, group=groups)
    params = dict(PARAMS, objective=f"rank:{kind}", **(extra or {}))
    res = {}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        bst = pkg.train(params, d, rounds, evals=[(d, "train")],
                        evals_result=res, verbose_eval=False, **kw)
    return bst, d, res, err.getvalue()


@pytest.fixture(scope="module", params=KINDS)
def padded(request, data):
    X, y, groups, _ = data
    kind = request.param
    return (kind, _train(xj, kind, X, y, groups),
            _train(xt, kind, X, y, groups, device="cpu"))


def test_padded_training_grows_the_jax_trees(padded):
    kind, (bj, dj, rj, _), (bt, dt, rt, _) = padded
    assert bt._cache[id(dt)].rank_pad_prep is not None
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    for k in ("tree_feature", "tree_cut_index", "tree_threshold",
              "tree_default_left", "tree_is_leaf"):
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    np.testing.assert_allclose(st["tree_leaf_value"],
                               np.asarray(sj["tree_leaf_value"]),
                               rtol=1e-5, atol=1e-6)
    assert rt == rj


def test_padded_outputs_in_user_order(padded):
    """predict, pred_leaf and eval through the padded entry equal those
    of an uncached matrix (user order), and the JAX package's."""
    kind, (bj, dj, _, _), (bt, dt, _, _) = padded
    X, y = dt.dense_source()[0], dt.get_label()
    fresh = xt.DMatrix(X, label=y, group=np.diff(dt.info.group_ptr))
    np.testing.assert_array_equal(bt.predict(dt), bt.predict(fresh))
    np.testing.assert_array_equal(bt.predict(dt, pred_leaf=True),
                                  bt.predict(fresh, pred_leaf=True))
    np.testing.assert_array_equal(bt.predict(dt, pred_leaf=True),
                                  np.asarray(bj.predict(dj, pred_leaf=True)))
    assert bt.eval(dt, "x") == bt.eval(fresh, "x") == bj.eval(dj, "x")


@pytest.mark.parametrize("kind", KINDS)
def test_sort_path_trains_to_the_jax_metric(data, kind, monkeypatch):
    monkeypatch.setenv("XGBTPU_RANK_PAD", "0")
    X, y, groups, _ = data
    extra = {"eval_metric": ["ndcg", "map"]}
    bj, _, rj, _ = _train(xj, kind, X, y, groups, 8, extra)
    bt, dt, rt, err = _train(xt, kind, X, y, groups, 8, extra, device="cpu")
    assert bt._cache[id(dt)].rank_pad_prep is None
    assert "sort-based" in err
    for k in ("train-ndcg", "train-map"):
        assert abs(rt[k][-1] - rj[k][-1]) < 0.05, (k, rt[k], rj[k])
    assert rt["train-ndcg"][-1] > 0.85


@pytest.mark.parametrize("kind", ["ndcg", "map"])
def test_host_path_training_matches(data, kind):
    """rank_impl=host: bitwise gradients, so the JAX trees."""
    X, y, groups, _ = data
    extra = {"rank_impl": "host"}
    bj, _, rj, ej = _train(xj, kind, X, y, groups, 3, extra)
    bt, _, rt, et = _train(xt, kind, X, y, groups, 3, extra, device="cpu")
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    for k in ("tree_feature", "tree_cut_index", "tree_is_leaf"):
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    assert rt == rj
    assert "[rank]" not in et and "[rank]" not in ej


# ----------------------------------------------------------------- gate
def _gate_cases():
    rng = np.random.RandomState(0)
    base_y = rng.randint(0, 3, 400).astype(np.float32)
    sizes = np.full(20, 20)
    return {
        "plain": (base_y, sizes, {}),
        "lane_over_256": (rng.randint(0, 3, 300).astype(np.float32),
                          np.array([300]), {}),
        "non_integer_label": (base_y + 0.5, sizes, {}),
        "label_32": (np.where(np.arange(400) == 7, 32.0, base_y)
                     .astype(np.float32), sizes, {}),
        "two_roots": (base_y, sizes, {"num_roots": 2}),
        "blow_up": (rng.randint(0, 3, 400).astype(np.float32),
                    np.concatenate([[100], np.ones(300, np.int64)]), {}),
        "maxlane_env": (base_y, sizes, {"env": ("XGBTPU_RANK_PAD_MAXLANE",
                                                "16")}),
        "pad_off_env": (base_y, sizes, {"env": ("XGBTPU_RANK_PAD", "0")}),
        "host_impl": (base_y, sizes, {"rank_impl": "host"}),
        "tail_rows": (base_y, np.full(19, 20), {}),
    }


GATE = _gate_cases()


@pytest.mark.parametrize("case", sorted(GATE))
def test_rank_pad_gate_decides_as_the_jax_package(case, monkeypatch):
    y, sizes, extra = GATE[case]
    extra = dict(extra)
    env = extra.pop("env", None)
    if env:
        monkeypatch.setenv(*env)
    X = np.random.RandomState(1).rand(len(y), 4).astype(np.float32)
    params = dict(PARAMS, objective="rank:ndcg", **extra)
    got = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y)
        d.set_group(sizes)
        if "num_roots" in extra:
            d.set_uint_info("root_index", np.arange(len(y)) % 2)
        bst = pkg.Booster(params, **kw)
        bst._init_obj()
        got.append(bool(bst._rank_pad_ok(d)))
    assert got[0] == got[1]
    assert got[1] == (case in ("plain", "tail_rows"))


def test_path_line_as_the_jax_package(data, monkeypatch):
    X, y, groups, _ = data
    for pad in ("1", "0"):
        monkeypatch.setenv("XGBTPU_RANK_PAD", pad)
        lines = []
        for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
            err = _train(pkg, "ndcg", X[:200], y[:200], [100, 100], 1,
                         **kw)[3]
            lines.append([ln for ln in err.splitlines()
                          if ln.startswith("[rank]")])
        assert lines[0] == lines[1] and len(lines[1]) == 1
        assert ("group-padded" if pad == "1" else "sort-based") \
            in lines[1][0]
    monkeypatch.delenv("XGBTPU_RANK_PAD")
    assert not _train(xt, "ndcg", X, y, groups, 1, {"silent": 1},
                      device="cpu")[3]


def test_objective_switch_rebuilds_the_entry(data):
    X, y, groups, _ = data
    d = xt.DMatrix(X, label=y, group=groups)
    bst = xt.Booster(dict(PARAMS, objective="rank:ndcg"), cache=[d],
                     device="cpu")
    bst.update(d, 0)
    prep = bst._cache[id(d)].rank_pad_prep
    assert prep is not None
    bst.set_param("rank_impl", "host")
    bst.update(d, 1)
    assert bst._cache[id(d)].rank_pad_prep is None
    bst.set_param({"rank_impl": "device", "objective": "reg:linear"})
    bst.update(d, 2)
    assert bst._cache[id(d)].rank_pad_prep is None
    assert bst.predict(d).shape == (len(y),)
    # a set_group rebuilds the layout
    bst.set_param("objective", "rank:ndcg")
    d2 = xt.DMatrix(X, label=y, group=groups)
    bst.update(d2, 3)
    old = bst._cache[id(d2)].rank_pad_prep
    g2 = groups.copy()
    g2[0] -= 1
    g2[1] += 1
    d2.set_group(g2)
    bst.update(d2, 4)
    assert bst._cache[id(d2)].rank_pad_prep is not old


def test_fused_lane_spec_reasons(data, monkeypatch):
    X, y, groups, _ = data
    reasons = []
    for impl, pad in (("device", "1"), ("device", "0"), ("host", "1")):
        monkeypatch.setenv("XGBTPU_RANK_PAD", pad)
        d = xt.DMatrix(X, label=y, group=groups)
        bst = xt.Booster(dict(PARAMS, objective="rank:map",
                              rank_impl=impl), device="cpu")
        reasons.append(bst.fused_lane_spec(d, 0, 2)[1])
    assert reasons == ["rank_layout", "rank", "no_fused_grad"]


# ---------------------------------------------------------- model files
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_rank_model_files_load_in_both(padded, saver, tmp_path):
    kind, (bj, dj, _, _), (bt, dt, _, _) = padded
    path = str(tmp_path / "rank.model")
    (bj if saver == "jax" else bt).save_model(path)
    lj = xj.Booster(model_file=path)
    lt = xt.Booster(model_file=path, device="cpu")
    assert lt.param.objective == f"rank:{kind}"
    X = dt.dense_source()[0]
    np.testing.assert_array_equal(lt.predict(xt.DMatrix(X)),
                                  np.asarray(lj.predict(xj.DMatrix(X))))
    assert lt.get_dump() == lj.get_dump()


# ------------------------------------------------------------------ CLI
def test_cli_reads_the_group_sidecar(data, tmp_path):
    from xgboost_tpu.cli import main as jax_main
    from xgboost_tpu_torch.cli import main as port_main
    X, y, groups, _ = data
    path = tmp_path / "rank.txt"
    with open(path, "w") as f:
        for row, label in zip(X, y):
            f.write(f"{label:g} " + " ".join(f"{j}:{v:.6f}" for j, v in
                                             enumerate(row)) + "\n")
    np.savetxt(str(path) + ".group", groups, fmt="%d")
    conf = tmp_path / "rank.conf"
    conf.write_text(f"objective = rank:ndcg\nmax_depth = 3\neta = 0.3\n"
                    f"max_bin = 32\nhist_precision = fp32\nnum_round = 3\n"
                    f"data = {path}\neval[train] = {path}\n"
                    f"eval_metric = ndcg@5\neval_metric = map\n")
    lines = []
    for main, extra in ((jax_main, []), (port_main, ["device=cpu"])):
        out = tmp_path / ("j" if not extra else "t")
        out.mkdir()
        err = io.StringIO()
        old = os.getcwd()
        os.chdir(out)
        try:
            with contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(io.StringIO()):
                assert main([str(conf), *extra]) == 0
        finally:
            os.chdir(old)
        lines.append([ln for ln in err.getvalue().splitlines()
                      if ln.startswith("[") and "\t" in ln])
        model = out / "0003.model"
        eerr = io.StringIO()
        os.chdir(out)
        try:
            with contextlib.redirect_stderr(eerr), \
                    contextlib.redirect_stdout(io.StringIO()):
                assert main([str(conf), "task=eval",
                             f"model_in={model}", *extra]) == 0
        finally:
            os.chdir(old)
        lines[-1] += [ln for ln in eerr.getvalue().splitlines()
                      if ln.startswith("[") and "\t" in ln]
    assert len(lines[0]) == 4 and "train-ndcg@5:" in lines[0][0]
    assert lines[0] == lines[1]
