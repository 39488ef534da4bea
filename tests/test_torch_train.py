"""The PyTorch port's main path against the JAX package, end to end:
``train`` -> trees -> ``predict`` / eval lines -> model files, on the
same numpy data, at ``hist_precision=fp32`` on the CPU.

Tolerances and why:
- tree structure (feature, cut_index, threshold, default_left, is_leaf)
  bitwise: histograms and the split search match bit for bit, and the
  node totals differ by f32 rounding only, far from any decision;
- leaf values, gains, hessian sums, predictions: rtol 1e-5 (atol 1e-6):
  torch and XLA reduce the node totals in different orders, and XLA's
  ``exp`` rounds differently from torch's, a few ulp per value;
- eval metrics: within 1e-5, float64 metrics over those predictions;
- a model file predicts the same margins in either package bit for bit:
  same trees, same bins, leaf values added in the same order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F, ROUNDS = 4096, 8, 3
OBJECTIVES = ["reg:linear", "binary:logistic"]


def _data(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    X[rng.rand(N, F) < 0.1] = np.nan
    Z = np.nan_to_num(X)
    y_reg = (2 * Z[:, 0] + Z[:, 1] ** 2 - Z[:, 2] * Z[:, 3]
             + 0.1 * rng.randn(N)).astype(np.float32)
    y_bin = (Z[:, 0] + Z[:, 1] * Z[:, 2] > 0.3).astype(np.float32)
    return X, y_reg, y_bin


@pytest.fixture(scope="module", params=OBJECTIVES)
def trained(request):
    """Both packages trained on one dataset, with per-round eval lines
    on a train and a test set."""
    obj = request.param
    X, y_reg, y_bin = _data(0)
    Xt, yt_reg, yt_bin = _data(1)
    y, yt = (y_reg, yt_reg) if obj == "reg:linear" else (y_bin, yt_bin)
    params = {"objective": obj, "max_depth": 3, "eta": 0.3, "max_bin": 32,
              "hist_precision": "fp32"}
    out = {"obj": obj, "X": X, "Xt": Xt, "y": y, "yt": yt,
           "params": params}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        dtr, dte = pkg.DMatrix(X, label=y), pkg.DMatrix(Xt, label=yt)
        res = {}
        bst = pkg.train(params, dtr, ROUNDS,
                        evals=[(dtr, "train"), (dte, "test")],
                        evals_result=res, verbose_eval=False, **kw)
        out[name] = bst
        out[name + "_res"] = res
        out[name + "_margin"] = bst.predict(pkg.DMatrix(Xt),
                                            output_margin=True)
        out[name + "_pred"] = bst.predict(pkg.DMatrix(Xt))
    return out


def _state(bst):
    return bst.gbtree.get_state()


def test_tree_structure_bitwise(trained):
    sj, st = _state(trained["j"]), _state(trained["t"])
    assert set(sj) == set(st)
    for k in ("tree_feature", "tree_cut_index", "tree_threshold",
              "tree_default_left", "tree_is_leaf", "tree_group_arr",
              "cut_values", "cut_n"):
        a, b = np.asarray(sj[k]), np.asarray(st[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert st["tree_feature"].shape == (ROUNDS, 15)


def test_leaf_values_and_predictions_close(trained):
    sj, st = _state(trained["j"]), _state(trained["t"])
    for k in ("tree_leaf_value", "tree_gain", "tree_sum_hess"):
        np.testing.assert_allclose(st[k], np.asarray(sj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("margin", "pred"):
        np.testing.assert_allclose(trained["t_" + k], trained["j_" + k],
                                   rtol=1e-5, atol=1e-6)


def test_eval_metrics_close(trained):
    rj, rt = trained["j_res"], trained["t_res"]
    assert list(rj) == list(rt)
    for k in rj:
        assert len(rt[k]) == ROUNDS
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-5)


def _margins(bst, pkg, X):
    return bst.predict(pkg.DMatrix(X), output_margin=True)


def test_model_files_cross_load(trained, tmp_path):
    Xt = trained["Xt"]
    jpath, tpath = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    trained["j"].save_model(jpath)
    trained["t"].save_model(tpath)
    # a JAX-saved model in the port
    t_of_j = xt.Booster(model_file=jpath, device="cpu")
    np.testing.assert_array_equal(_margins(t_of_j, xt, Xt),
                                  trained["j_margin"])
    # a port-saved model in JAX
    j_of_t = xj.Booster(model_file=tpath)
    np.testing.assert_array_equal(_margins(j_of_t, xj, Xt),
                                  trained["t_margin"])
    assert j_of_t.param.to_dict() == trained["t"].param.to_dict()
    # the port's own round trip: predictions and file bytes
    again = xt.Booster(model_file=tpath, device="cpu")
    np.testing.assert_array_equal(again.predict(xt.DMatrix(Xt)),
                                  trained["t_pred"])
    again.save_model(str(tmp_path / "t2.model"))
    assert open(tpath, "rb").read() == \
        open(str(tmp_path / "t2.model"), "rb").read()
    # raw bytes and the bs64 encoding load in JAX too
    from_raw = xj.Booster()
    from_raw.load_raw(trained["t"].save_raw())
    np.testing.assert_array_equal(_margins(from_raw, xj, Xt),
                                  trained["t_margin"])
    b64 = str(tmp_path / "t.b64")
    trained["t"].save_model(b64, save_base64=True)
    np.testing.assert_array_equal(
        _margins(xj.Booster(model_file=b64), xj, Xt), trained["t_margin"])


def test_corrupt_model_file_is_refused(trained, tmp_path):
    from xgboost_tpu_torch.reliability.integrity import ModelIntegrityError
    path = str(tmp_path / "m.model")
    trained["t"].save_model(path)
    raw = bytearray(open(path, "rb").read())
    raw[100] ^= 0x40
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ModelIntegrityError):
        xt.Booster(model_file=path, device="cpu")


def test_gbtree_from_jax_state(trained):
    bj = trained["j"]
    gbt = xt.gbtree_from_jax_state(bj.gbtree.get_state(), bj.param,
                                   device="cpu")
    Xt = trained["Xt"]
    from xgboost_tpu_torch.binning import bin_matrix
    binned = torch.from_numpy(bin_matrix(xt.DMatrix(Xt), gbt.cuts))
    base = bj.obj.prob_to_margin(bj.param.base_score)
    got = gbt.predict_margin(
        binned, torch.full((len(Xt), 1), base, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy()[:, 0], trained["j_margin"])
    assert gbt.num_trees == ROUNDS


def test_continued_training_and_leaf_prediction(trained):
    """Continuing for one more round appends a tree; pred_leaf indices
    agree between the packages."""
    X, y, params = trained["X"], trained["y"], trained["params"]
    d = xt.DMatrix(X, label=y)
    resumed = xt.Booster(device="cpu")
    resumed.load_raw(trained["t"].save_raw())
    more = xt.train(params, d, 1, xgb_model=resumed, device="cpu")
    assert more.gbtree.num_trees == ROUNDS + 1
    leaves_t = trained["t"].predict(xt.DMatrix(trained["Xt"]),
                                    pred_leaf=True)
    leaves_j = trained["j"].predict(xj.DMatrix(trained["Xt"]),
                                    pred_leaf=True)
    np.testing.assert_array_equal(leaves_t, np.asarray(leaves_j))


def test_import_and_train_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, xgboost_tpu_torch as xt\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.rand(256, 4).astype(np.float32)\n"
        "y = (X[:, 0] > 0.5).astype(np.float32)\n"
        "b = xt.train({'objective': 'binary:logistic', 'max_depth': 2},\n"
        "             xt.DMatrix(X, label=y), 2, device='cpu')\n"
        "assert b.predict(xt.DMatrix(X)).shape == (256,)\n"
        "assert not any(m == 'xgboost_tpu' or m.startswith('xgboost_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.Booster({})
    with pytest.raises(RuntimeError):
        xt.train({}, xt.DMatrix(np.zeros((4, 2), np.float32),
                                label=np.zeros(4)), 1)


@pytest.mark.parametrize("params", [
    {"booster": "gblinear", "dsplit": "row"}, {"dsplit": "row"},
    {"updater": "distcol"}])
def test_unported_options_raise(params):
    X, y, _ = _data(2)
    with pytest.raises(NotImplementedError):
        xt.train(params, xt.DMatrix(X[:64], label=y[:64]), 1, device="cpu")


@pytest.mark.parametrize("objective", ["rank:pairwise", "rank:ndcg",
                                       "rank:map"])
def test_rank_objectives_train_like_the_jax_package(objective):
    """``rank:*`` on 64 groups of 64 rows: the group-padded layout in
    both packages, tree structure bitwise and eval lines equal."""
    X, y_reg, _ = _data(4)
    y = np.clip(np.round(np.nan_to_num(y_reg)), 0, 3).astype(np.float32)
    params = {"objective": objective, "max_depth": 3, "eta": 0.3,
              "max_bin": 32, "hist_precision": "fp32", "silent": 1}
    out = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y, group=np.full(64, 64))
        res = {}
        out.append((pkg.train(params, d, ROUNDS, evals=[(d, "train")],
                              evals_result=res, verbose_eval=False, **kw),
                    res))
    (bj, rj), (bt, rt) = out
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    for k in ("tree_feature", "tree_cut_index", "tree_threshold",
              "tree_default_left", "tree_is_leaf"):
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    assert rt == rj


def test_int8_training_matches_the_pallas_path(monkeypatch):
    """The GPU's default mode, int8, through the port's plain version on
    the CPU against the JAX package's Pallas int8 kernel (interpret
    mode, forced by the JAX package's own XGBTPU_HIST test seam).
    reg:linear keeps the gradients bitwise, so the quantized gradients
    and histograms are bitwise too: tree structure bitwise, values
    within the node-total rounding (rtol 1e-5)."""
    monkeypatch.setenv("XGBTPU_HIST", "pallas_int8")
    X, y, _ = _data(3)
    params = {"objective": "reg:linear", "max_depth": 3, "eta": 0.3,
              "max_bin": 32, "hist_precision": "int8", "hist_bin_align": 0}
    sj = xj.train(params, xj.DMatrix(X, label=y), ROUNDS).gbtree.get_state()
    st = xt.train(params, xt.DMatrix(X, label=y), ROUNDS,
                  device="cpu").gbtree.get_state()
    for k in ("tree_feature", "tree_cut_index", "tree_threshold",
              "tree_default_left", "tree_is_leaf"):
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    for k in ("tree_leaf_value", "tree_gain", "tree_sum_hess"):
        np.testing.assert_allclose(st[k], np.asarray(sj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------- early stopping
EARLY = {
    "reg-rmse": ({"objective": "reg:linear", "max_depth": 3, "eta": 0.3,
                  "max_bin": 32, "hist_precision": "fp32"}, None, 3),
    "logistic-auc": ({"objective": "binary:logistic", "max_depth": 3,
                      "eta": 0.3, "max_bin": 32, "hist_precision": "fp32",
                      "eval_metric": ["error", "auc"]}, None, 2),
    "error-maximize": ({"objective": "binary:logistic", "max_depth": 3,
                        "eta": 0.3, "max_bin": 32, "hist_precision": "fp32",
                        "eval_metric": "error"}, True, 2),
}


@pytest.mark.parametrize("case", sorted(EARLY))
def test_early_stopping_matches_the_jax_package(case, capsys):
    """``early_stopping_rounds`` on the last metric of the last eval set
    (auc maximized by its name, error by ``maximize=True``):
    ``best_iteration`` equal, ``best_score`` and ``evals_result`` within
    rtol 1e-5, the same rounds run and the same "Stopping" line keys."""
    params, maximize, patience = EARLY[case]
    X, y_reg, y_bin = _data(4)
    Xt, yt_reg, yt_bin = _data(5)
    n = 1024
    y, yt = ((y_reg, yt_reg) if params["objective"] == "reg:linear"
             else (y_bin, yt_bin))
    out = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        dtr = pkg.DMatrix(X[:n], label=y[:n])
        dte = pkg.DMatrix(Xt[:n], label=yt[:n])
        res = {}
        bst = pkg.train(params, dtr, 40, evals=[(dtr, "train"),
                                                (dte, "test")],
                        maximize=maximize, early_stopping_rounds=patience,
                        evals_result=res, verbose_eval=True, **kw)
        printed = capsys.readouterr().out
        out[name] = (bst, res, printed)
    (bj, rj, pj), (bt, rt, pt) = out["j"], out["t"]
    assert bt.best_iteration == bj.best_iteration
    np.testing.assert_allclose(bt.best_score, bj.best_score, rtol=1e-5)
    assert list(rt) == list(rj)
    for k in rj:
        assert len(rt[k]) == len(rj[k]) < 40, k
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert "Stopping. Best iteration:" in pt
    stop_j = pj.split("Stopping. Best iteration:\n")[1].split("\t")[0]
    stop_t = pt.split("Stopping. Best iteration:\n")[1].split("\t")[0]
    assert stop_t == stop_j == f"[{bt.best_iteration}]"
    assert bt.gbtree.num_trees == len(rt["test-" + list(rt)[-1]
                                         .split("-", 1)[1]])


def test_init_model_is_an_alias_of_xgb_model(tmp_path):
    X, y, _ = _data(6)
    params = {"max_depth": 2, "max_bin": 16}
    d = xt.DMatrix(X[:512], label=y[:512])
    path = str(tmp_path / "m.model")
    xt.train(params, d, 2, device="cpu").save_model(path)
    a = xt.train(params, d, 1, init_model=path, device="cpu")
    b = xt.train(params, d, 1, xgb_model=path, device="cpu")
    assert a.gbtree.num_trees == b.gbtree.num_trees == 3
    assert a.save_raw() == b.save_raw()
    with pytest.raises(ValueError, match="aliases"):
        xt.train(params, d, 1, init_model=path, xgb_model=path,
                 device="cpu")


def test_update_many_hooks():
    """Eval lines per round equal ``eval_set``'s for that round;
    ``boundary_align`` ends segments at its multiples; ``plan_callback``
    reports the segment size (0 where the JAX package would not fuse);
    ``round_callback`` runs on the per-round path only."""
    X, y, _ = _data(7)
    d = xt.DMatrix(X[:512], label=y[:512])
    dv = xt.DMatrix(X[512:1024], label=y[512:1024])
    params = {"max_depth": 2, "max_bin": 16}

    def feval(preds, dmat):
        return "maxerr", float(np.abs(preds - dmat.get_label()).max())
    calls = {"plan": [], "round": [], "seg": [], "eval": []}
    bst = xt.Booster(params, cache=[d, dv], device="cpu")
    bst.update_many(d, 0, 7, evals=[(dv, "v"), (d, "t")], feval=feval,
                    eval_callback=lambda i, m: calls["eval"].append((i, m)),
                    round_callback=calls["round"].append,
                    segment_callback=calls["seg"].append,
                    plan_callback=calls["plan"].append, boundary_align=3,
                    rounds_per_dispatch=4)
    assert calls["plan"] == [4] and calls["round"] == []
    assert calls["seg"] == [2, 5, 6]
    ref = xt.Booster(params, cache=[d, dv], device="cpu")
    for i, (it, msg) in enumerate(calls["eval"]):
        ref.update(d, i)
        assert it == i and msg == ref.eval_set([(dv, "v"), (d, "t")], i,
                                               feval)
        assert "v-maxerr:" in msg
    assert bst.save_raw() == ref.save_raw()
    per_round = {"plan": [], "round": []}
    xt.Booster(dict(params, gamma=0.5), device="cpu").update_many(
        d, 3, 2, plan_callback=per_round["plan"].append,
        round_callback=per_round["round"].append)
    assert per_round == {"plan": [0], "round": [3, 4]}
