"""The PyTorch port's multiclass and forest path against the JAX package:
``multi:softmax`` / ``multi:softprob`` and ``num_parallel_tree``, the T
trees of a round grown together on shared bins (``grow_trees``, kernel
K3 on a GPU), on the same numpy data, at ``hist_precision=fp32`` on the
CPU.

Tolerances and why:
- softmax gradients bitwise: on the CPU the port's ``exp`` is XLA's
  CPU ``exp`` and p sums the K classes in XLA's order;
- merror / mlogloss within 1e-7: host float64 numpy on both sides;
- ``grow_trees`` against T solo ``grow_tree`` calls: every field
  bitwise (the same histograms, node totals and split search per tree);
- trained trees' structure (feature, cut, threshold, default direction,
  leaf flags, groups) bitwise in every round; leaf values, gains,
  hessian sums, margins and predictions rtol 1e-5 (atol 1e-6), as in
  ``test_torch_train.py``: node totals differ by f32 rounding; eval
  metrics within 1e-5, and equal as printed;
- model files predict the same margins in either package bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu import metrics as jm  # noqa: E402
from xgboost_tpu.objectives import _softmax_grad  # noqa: E402
from xgboost_tpu_torch import metrics as tm  # noqa: E402
from xgboost_tpu_torch import objectives as to  # noqa: E402
from xgboost_tpu_torch.models.tree import (GrowConfig,  # noqa: E402
                                           TreeArrays, grow_tree,
                                           grow_trees)
from xgboost_tpu_torch.ops.split import SplitConfig  # noqa: E402

N, F, K, ROUNDS = 3000, 6, 3, 3
STRUCTURE = ("tree_feature", "tree_cut_index", "tree_threshold",
             "tree_default_left", "tree_is_leaf", "tree_group_arr")
VALUES = ("tree_leaf_value", "tree_gain", "tree_sum_hess")


def _data(seed, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.1] = np.nan
    Z = np.nan_to_num(X)
    logits = Z[:, :K] + 0.5 * Z[:, K:2 * K] ** 2 + 0.4 * rng.randn(n, K)
    return X, np.argmax(logits, axis=1).astype(np.float32)


# ------------------------------------------------------------ objective

def test_softmax_gradient_within_ulps():
    rng = np.random.RandomState(0)
    for k in (2, 3, 6, 9):
        m = (rng.randn(4000, k) * 3).astype(np.float32)
        lab = rng.randint(0, k, 4000).astype(np.float32)
        w = rng.uniform(0.5, 2.0, 4000).astype(np.float32)
        want = np.asarray(_softmax_grad(jnp.asarray(m), jnp.asarray(lab),
                                        jnp.asarray(w)))
        got = to.softmax_grad(*(torch.from_numpy(a)
                                for a in (m, lab, w))).numpy()
        assert got.shape == want.shape == (4000, k, 2)
        np.testing.assert_array_equal(got, want, err_msg=str(k))


@pytest.mark.parametrize("name", ["multi:softmax", "multi:softprob"])
def test_softmax_objective_transforms_and_labels(name):
    from xgboost_tpu import objectives as jo
    from xgboost_tpu.data import MetaInfo as JMeta
    oj, ot = jo.create_objective(name), to.create_objective(name)
    for o in (oj, ot):
        o.set_param("num_class", 4)
    assert ot.default_metric == oj.default_metric == "merror"
    assert ot.output_group_count == 4
    assert ot.prob_to_margin(0.5) == oj.prob_to_margin(0.5)
    m = (np.random.RandomState(1).randn(500, 4) * 2).astype(np.float32)
    for out_margin in (False, True):
        got = ot.pred_transform(torch.from_numpy(m), out_margin).numpy()
        want = np.asarray(oj.pred_transform(jnp.asarray(m), out_margin))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=8 * 2.0 ** -23, atol=0)
    np.testing.assert_allclose(ot.eval_transform(torch.from_numpy(m)),
                               np.asarray(oj.eval_transform(jnp.asarray(m))),
                               rtol=8 * 2.0 ** -23, atol=0)
    info = JMeta()
    info.set_field("label", np.array([0.0, 3.0, 4.0], np.float32))
    with pytest.raises(ValueError):
        ot.validate_labels(info)
    info.set_field("label", np.array([0.0, 3.0, np.nan], np.float32))
    with pytest.raises(ValueError):
        ot.validate_labels(info)
    info.set_field("label", np.array([0.0, 3.0, 1.0], np.float32))
    ot.validate_labels(info)
    with pytest.raises(ValueError):
        to.create_objective(name).validate_labels(info)   # num_class unset


@pytest.mark.parametrize("name", ["merror", "mlogloss"])
def test_multiclass_metrics_within_1e7(name):
    rng = np.random.RandomState(4)
    logits = rng.randn(3000, 5)
    preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
             ).astype(np.float32)
    preds[:50, 2] = 0.0                   # clipped at _EPS by mlogloss
    labels = rng.randint(0, 5, 3000).astype(np.float32)
    weights = rng.uniform(0.1, 3.0, 3000).astype(np.float32)
    want = jm.create_metric(name)(preds, labels, weights, None)
    got = tm.create_metric(name)(preds, labels, weights, None)
    assert tm.create_metric(name).metric_name == name
    assert abs(got - want) <= 1e-7


# ---------------------------------------------------------------- growth

@pytest.mark.parametrize("precision", ["fp32", "int8", "fixed"])
@pytest.mark.parametrize("depth", [0, 4])
def test_grow_trees_equals_solo_grow_tree(precision, depth):
    """T trees grown together == T solo growths, every field and every
    row's leaf and value bitwise (row_valid included)."""
    rng = np.random.RandomState(7)
    T, n, f, B = 5, 2000, 7, 24
    binned = torch.from_numpy(rng.randint(0, B, (n, f)).astype(np.uint8))
    gh = torch.from_numpy(np.stack([rng.randn(T, n), rng.rand(T, n) + 0.1],
                                   -1).astype(np.float32))
    cut_values = torch.from_numpy(
        np.sort(rng.randn(f, B - 2), 1).astype(np.float32))
    n_cuts = torch.from_numpy(rng.randint(5, B - 2, f).astype(np.int32))
    row_valid = torch.from_numpy(rng.rand(n) < 0.9)
    cfg = GrowConfig(SplitConfig(), depth, B, precision)
    stack, row_leaf, row_val = grow_trees(binned, gh, cut_values, n_cuts,
                                          cfg, row_valid)
    assert stack.feature.shape == (T, 2 ** (depth + 1) - 1)
    for t in range(T):
        solo, rl, rv = grow_tree(binned, gh[t], cut_values, n_cuts, cfg,
                                 row_valid)
        for name in TreeArrays._fields:
            a, b = getattr(stack, name)[t], getattr(solo, name)
            assert torch.equal(a, b), (t, name)
            if a.dtype.is_floating_point:
                assert torch.equal(torch.signbit(a), torch.signbit(b))
        assert torch.equal(row_leaf[t], rl) and torch.equal(row_val[t], rv)


# --------------------------------------------------------------- boosters

@pytest.fixture(scope="module", params=[("multi:softmax", 1),
                                        ("multi:softprob", 1),
                                        ("multi:softmax", 2)],
                ids=["softmax", "softprob", "softmax-forest2"])
def trained(request):
    """Both packages trained on one dataset, with per-round eval lines
    on a train and a test set."""
    obj, npar = request.param
    X, y = _data(0)
    Xt, yt = _data(1, 1000)
    params = {"objective": obj, "num_class": K, "max_depth": 3, "eta": 0.3,
              "max_bin": 32, "hist_precision": "fp32",
              "num_parallel_tree": npar, "eval_metric": ["merror",
                                                         "mlogloss"]}
    out = {"X": X, "Xt": Xt, "y": y, "yt": yt, "params": params,
           "npar": npar}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        dtr, dte = pkg.DMatrix(X, label=y), pkg.DMatrix(Xt, label=yt)
        res = {}
        bst = pkg.train(params, dtr, ROUNDS,
                        evals=[(dtr, "train"), (dte, "test")],
                        evals_result=res, verbose_eval=False, **kw)
        out[name] = bst
        out[name + "_res"] = res
        d = pkg.DMatrix(Xt)
        out[name + "_margin"] = np.asarray(bst.predict(d, output_margin=True))
        out[name + "_pred"] = np.asarray(bst.predict(d))
        out[name + "_leaf"] = np.asarray(bst.predict(d, pred_leaf=True))
    return out


def _state(bst):
    return bst.gbtree.get_state()


def test_multiclass_structure_bitwise(trained):
    sj, st = _state(trained["j"]), _state(trained["t"])
    assert set(sj) == set(st)
    for k in STRUCTURE + ("cut_values", "cut_n"):
        a, b = np.asarray(sj[k]), np.asarray(st[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    T = ROUNDS * K * trained["npar"]
    assert st["tree_feature"].shape == (T, 15)
    np.testing.assert_array_equal(
        st["tree_group_arr"],
        [j // trained["npar"] for _ in range(ROUNDS)
         for j in range(K * trained["npar"])])
    assert trained["t"].gbtree.num_boosted_rounds == \
        trained["j"].gbtree.num_boosted_rounds == ROUNDS


def test_multiclass_values_and_predictions_close(trained):
    sj, st = _state(trained["j"]), _state(trained["t"])
    for k in VALUES:
        np.testing.assert_allclose(st[k], np.asarray(sj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(trained["t_margin"], trained["j_margin"],
                               rtol=1e-5, atol=1e-6)
    if trained["params"]["objective"] == "multi:softprob":
        np.testing.assert_allclose(trained["t_pred"], trained["j_pred"],
                                   rtol=1e-5, atol=1e-6)
    else:   # class ids: equal wherever the top two margins are apart
        top2 = np.sort(trained["j_margin"], axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(trained["t_pred"][clear],
                                      trained["j_pred"][clear])


def test_prediction_shapes_match(trained):
    for k in ("margin", "pred", "leaf"):
        assert trained["t_" + k].shape == trained["j_" + k].shape, k
        assert trained["t_" + k].dtype == trained["j_" + k].dtype, k
    n = len(trained["Xt"])
    assert trained["t_margin"].shape == (n, K)
    want = (n, K) if trained["params"]["objective"] == "multi:softprob" \
        else (n,)
    assert trained["t_pred"].shape == want
    np.testing.assert_array_equal(trained["t_leaf"], trained["j_leaf"])


def test_multiclass_eval_metrics_close(trained):
    rj, rt = trained["j_res"], trained["t_res"]
    assert list(rj) == list(rt) == ["train-merror", "train-mlogloss",
                                    "test-merror", "test-mlogloss"]
    for k in rj:
        assert len(rt[k]) == ROUNDS
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-5)
        assert rt[k] == rj[k], k


def test_multiclass_model_files_cross_load(trained, tmp_path):
    Xt = trained["Xt"]
    jpath, tpath = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    trained["j"].save_model(jpath)
    trained["t"].save_model(tpath)
    t_of_j = xt.Booster(model_file=jpath, device="cpu")
    np.testing.assert_array_equal(
        t_of_j.predict(xt.DMatrix(Xt), output_margin=True),
        trained["j_margin"])
    j_of_t = xj.Booster(model_file=tpath)
    np.testing.assert_array_equal(
        np.asarray(j_of_t.predict(xj.DMatrix(Xt), output_margin=True)),
        trained["t_margin"])
    assert j_of_t.param.num_class == K
    assert j_of_t.param.to_dict() == trained["t"].param.to_dict()
    again = xt.Booster(model_file=tpath, device="cpu")
    np.testing.assert_array_equal(again.predict(xt.DMatrix(Xt)),
                                  trained["t_pred"])
    again.save_model(str(tmp_path / "t2.model"))
    assert open(tpath, "rb").read() == \
        open(str(tmp_path / "t2.model"), "rb").read()


def test_gbtree_from_jax_multiclass_state(trained):
    bj = trained["j"]
    gbt = xt.gbtree_from_jax_state(bj.gbtree.get_state(), bj.param,
                                   device="cpu")
    from xgboost_tpu_torch.binning import bin_matrix
    Xt = trained["Xt"]
    binned = torch.from_numpy(bin_matrix(xt.DMatrix(Xt), gbt.cuts))
    got = gbt.predict_margin(binned, torch.full((len(Xt), K), 0.5))
    np.testing.assert_array_equal(got.numpy(), trained["j_margin"])
    assert gbt.num_trees == ROUNDS * K * trained["npar"]
    assert gbt.tree_group == [int(g) for g in
                              bj.gbtree.get_state()["tree_group_arr"]]


def test_fed_gradients_grow_identical_trees():
    """From identical fed-in (N, K, 2) gradients, one round of
    ``do_boost`` in each package grows the same K x 2 trees (structure
    bitwise) and the same margin delta (rtol 1e-5)."""
    X, y = _data(5)
    params = {"objective": "multi:softprob", "num_class": K,
              "max_depth": 3, "max_bin": 32, "hist_precision": "fp32",
              "num_parallel_tree": 2}
    rng = np.random.RandomState(9)
    gh = np.stack([rng.randn(N, K), rng.rand(N, K) + 0.05],
                  -1).astype(np.float32)
    dj, dt = xj.DMatrix(X, label=y), xt.DMatrix(X, label=y)
    bj = xj.train(params, dj, 1)
    bt = xt.train(params, dt, 1, device="cpu")
    _, delta_j = bj.gbtree.do_boost(bj._cache[id(dj)].binned,
                                    jnp.asarray(gh), jax.random.PRNGKey(0))
    delta_t = bt.gbtree.do_boost(bt._cache[id(dt)].binned,
                                 torch.from_numpy(gh))
    sj, st = _state(bj), _state(bt)
    for k in STRUCTURE:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    assert st["tree_feature"].shape[0] == 2 * K * 2
    np.testing.assert_allclose(delta_t.numpy(), np.asarray(delta_j),
                               rtol=1e-5, atol=1e-6)


def test_int8_multiclass_matches_the_pallas_batched_path(monkeypatch):
    """The GPU's default mode, int8, through the port's plain K3 on the
    CPU against the JAX package's batched Pallas kernel (interpret
    mode, forced by its XGBTPU_HIST test seam; ``jax.vmap`` over the
    round's trees dispatches to it).  Round 0's margins are all
    base_score, so both packages' gradients (p = 1/K) are bitwise and
    so are the quantized histograms: round-0 trees bitwise in
    structure, values within rtol 1e-5."""
    monkeypatch.setenv("XGBTPU_HIST", "pallas_int8")
    X, y = _data(3)
    params = {"objective": "multi:softmax", "num_class": K,
              "max_depth": 3, "eta": 0.3, "max_bin": 32,
              "hist_precision": "int8", "hist_bin_align": 0}
    sj = xj.train(params, xj.DMatrix(X, label=y), 1).gbtree.get_state()
    st = xt.train(params, xt.DMatrix(X, label=y), 1,
                  device="cpu").gbtree.get_state()
    assert st["tree_feature"].shape == (K, 15)
    for k in STRUCTURE:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    for k in VALUES:
        np.testing.assert_allclose(st[k], np.asarray(sj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("extra", [
    {"objective": "binary:logistic"},
    {"objective": "multi:softprob", "num_class": 3}], ids=["binary", "k3"])
def test_depth_zero_booster(extra):
    """``max_depth=0`` (the config of tests/test_edge_cases.py:54): the
    root is the only node, its statistics from node_stats (K2 on a
    GPU).  Every tree a single leaf; values and predictions within
    rtol 1e-5 of the JAX package's."""
    X = np.random.RandomState(3).rand(100, 3).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    if "num_class" in extra:
        y = (X[:, 0] * 3).astype(np.int32).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 0, "eta": 0.5,
              **extra}
    bj = xj.train(params, xj.DMatrix(X, label=y), 2, verbose_eval=False)
    bt = xt.train(params, xt.DMatrix(X, label=y), 2, device="cpu")
    sj, st = _state(bj), _state(bt)
    for k in STRUCTURE:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    assert st["tree_is_leaf"].all() and st["tree_feature"].shape[1] == 1
    for k in VALUES:
        np.testing.assert_allclose(st[k], np.asarray(sj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    pj = np.asarray(bj.predict(xj.DMatrix(X)))
    pt = bt.predict(xt.DMatrix(X))
    assert pt.shape == pj.shape and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)
    assert np.allclose(pt, pt[0])


# ------------------------------------------------------------------- F6

def _f6_data():
    """ROADMAP.md's F6 fixture: 2,500 x 7 rows with 12% NaN, 4 classes
    by quantiles of x0 + x1 x2 - 0.5 x3, weights in [0.3, 2)."""
    rs = np.random.RandomState(2)
    X = rs.randn(2500, 7).astype(np.float32)
    X[rs.rand(2500, 7) < 0.12] = np.nan
    Z = np.nan_to_num(X)
    s = Z[:, 0] + Z[:, 1] * Z[:, 2] - 0.5 * Z[:, 3]
    y = np.digitize(s, np.quantile(s, [0.25, 0.5, 0.75])).astype(np.float32)
    w = np.random.RandomState(5).uniform(0.3, 2.0, 2500).astype(np.float32)
    return X, y, w


def test_f6_softprob_tie_eval_lines_byte_equal(capsys):
    """F6: row 207's margins (0.49999997, 0.5, 0.2, 0.2) tie classes 0
    and 1 once exp(-2.98e-8) rounds to 1.0, as XLA's CPU exp rounds it;
    with the port's exp the softprob eval lines, round 1's train-merror
    0.321383 among them, equal the JAX package's byte for byte."""
    X, y, w = _f6_data()
    params = {"objective": "multi:softprob", "num_class": 4,
              "max_depth": 4, "eta": 0.3, "max_bin": 32,
              "hist_precision": "fp32", "max_delta_step": 0.5,
              "eval_metric": "merror"}
    lines, probs = {}, {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        dtr = pkg.DMatrix(X, label=y, weight=w)
        dte = pkg.DMatrix(X[:400], label=y[:400], weight=w[:400])
        capsys.readouterr()
        bst = pkg.train(params, dtr, 4, evals=[(dtr, "train"),
                                               (dte, "test")], **kw)
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("[")]
        probs[name] = np.asarray(bst.predict(pkg.DMatrix(X[207:208]),
                                             ntree_limit=8))
    assert len(lines["j"]) == 4
    assert lines["t"] == lines["j"]
    assert "train-merror:0.321383" in lines["t"][1]
    p_t, p_j = probs["t"][0], probs["j"][0]   # after round 1's trees
    np.testing.assert_array_equal(p_t, p_j)
    assert p_t[0] == p_t[1] == np.float32(0.28722125)
    assert np.argmax(p_t) == 0 == y[207]
