"""The port's gblinear booster (``xgboost_tpu_torch/models/gblinear.py``)
against the JAX package, on the CPU, on the same numpy inputs (a few
hundred to 3,000 rows, 5-8 features, every input from a seed).

Tolerances and why:

- the bias of a boosting step bitwise: its row sums follow XLA's CPU
  reduction order (``ops/histogram.bin_sum``);
- boosting steps bitwise, one output group at blocks 1 and 4 and
  several at block 1 (the port replays XLA's CPU dot and update orders,
  read from its dumped LLVM IR, ``models/gblinear._xla_loop_dot`` /
  ``_fma_chain`` / ``_update_cpu``), and so the trained weights of one
  group; a multiclass model within rtol 1e-5 / atol 1e-6, since its
  margin ``X @ W`` is a library GEMM (Eigen) in the JAX package, as are
  the products at a block above 1, and fewer than ~500 rows unroll
  otherwise (a few ulp; ROADMAP.md section 3, F9); a weight the elastic
  net zeroes is zero in both;
- eval lines (``train`` and ``cv``) byte-equal; predictions within
  1e-5;
- one model file: dumps, predictions and the CLI's ``task=pred`` /
  ``task=dump`` output byte-equal in both packages, each package's file
  loading in the other.
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
from xgboost_tpu.cli import main as jax_main  # noqa: E402
from xgboost_tpu.models import gblinear as jgl  # noqa: E402
from xgboost_tpu_torch.cli import main as port_main  # noqa: E402
from xgboost_tpu_torch.models import gblinear as tgl  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N, F = 3000, 8
ROUNDS = 5


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    X[rng.rand(N, F) < 0.1] = np.nan
    Z = np.nan_to_num(X)
    y_reg = (Z @ np.linspace(1.0, -0.5, F) + 0.1 * rng.randn(N)).astype(
        np.float32)
    y_bin = (Z[:, 0] + Z[:, 1] - Z[:, 2] > 0).astype(np.float32)
    y_mc = np.argmax(Z[:, :3], axis=1).astype(np.float32)
    return X, y_reg, y_bin, y_mc


OBJECTIVES = {"reg:linear": ({}, 1), "binary:logistic": ({}, 2),
              "multi:softmax": ({"num_class": 3}, 3)}


def _params(objective, **kw):
    extra, _ = OBJECTIVES[objective]
    return {"booster": "gblinear", "objective": objective, "eta": 0.5,
            "lambda": 1.0, "alpha": 0.01, "silent": 1, **extra, **kw}


def _label(objective, data):
    return data[OBJECTIVES[objective][1]]


@pytest.mark.parametrize("block", [1, 3, F])
def test_linear_boost_step_matches_jax(block):
    """One round at block 1, 3 (the last block padded) and F, with an
    alpha that zeroes the noise features' weights: three steps chained
    on each package's own weights."""
    rng = np.random.RandomState(block)
    n, f, K = 500, 7, 2
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n, f) < 0.1] = 0.0
    g = (X[:, :2] @ rng.randn(2, K) + 0.05 * rng.randn(n, K))
    gh = np.stack([g, rng.rand(n, K) + 0.5], -1).astype(np.float32)
    wj = wt = np.zeros((f, K), np.float32)
    bj = bt = np.zeros(K, np.float32)
    XT = torch.from_numpy(np.ascontiguousarray(X.T))
    for _ in range(3):
        wj, bj = (np.asarray(a) for a in jgl._linear_boost_step(
            jnp.asarray(X), jnp.asarray(gh), jnp.asarray(wj),
            jnp.asarray(bj), 0.5, 1.0, 40.0, 0.0, block=block))
        wt, bt = (a.numpy() for a in tgl._linear_boost_step(
            XT, torch.from_numpy(gh), torch.from_numpy(wt),
            torch.from_numpy(bt), 0.5, 1.0, 40.0, 0.0, block=block))
        np.testing.assert_allclose(wt, wj, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(bt, bj)
    assert ((wj == 0) == (wt == 0)).all()
    assert (wj == 0).any() and (wj != 0).any()


def test_linear_predict_is_base_bias_and_product():
    rng = np.random.RandomState(3)
    X = rng.randn(50, 4).astype(np.float32)
    w = rng.randn(4, 2).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    base = np.full((50, 2), 0.25, np.float32)
    want = np.asarray(jgl._linear_predict(jnp.asarray(X), jnp.asarray(w),
                                          jnp.asarray(b), jnp.asarray(base)))
    got = tgl._linear_predict(torch.from_numpy(np.ascontiguousarray(X.T)),
                              torch.from_numpy(w), torch.from_numpy(b),
                              torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=list(OBJECTIVES))
def trained(request, tmp_path_factory):
    """Both packages trained 5 rounds on one dataset, with eval lines on
    a train and a test set, and each package's model file."""
    obj = request.param
    data = _data()
    X, y = data[0], _label(obj, data)
    root = tmp_path_factory.mktemp(obj.replace(":", "_"))
    out = {}
    for name, pkg, kw in (("jax", xj, {}), ("port", xt, {"device": "cpu"})):
        dtr = pkg.DMatrix(X[:2400], label=y[:2400])
        dte = pkg.DMatrix(X[2400:], label=y[2400:])
        res = {}
        bst = pkg.train(_params(obj), dtr, ROUNDS,
                        evals=[(dtr, "train"), (dte, "test")],
                        evals_result=res, verbose_eval=False, **kw)
        path = str(root / f"{name}.model")
        bst.save_model(path)
        out[name] = dict(bst=bst, res=res, path=path, dte=dte)
    out["X"], out["obj"] = X, obj
    return out


def test_weights_and_bias_match_jax(trained):
    bj, bt = trained["jax"]["bst"], trained["port"]["bst"]
    for got, want in ((bt.gbtree.weight, bj.gbtree.weight),
                      (bt.gbtree.bias, bj.gbtree.bias)):
        # K > 1 included: the margin X @ W replays the JAX package's CPU
        # product order (gblinear._xla_cpu_gemm, F9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bt.gbtree.version == bj.gbtree.version == ROUNDS


@pytest.mark.parametrize("n,block,K", [(2400, 1, 1), (2400, 4, 1),
                                       (3000, 1, 1), (1200, 4, 1),
                                       (2400, 1, 3), (2403, 1, 3)])
def test_one_group_step_is_bitwise(n, block, K):
    """Three chained steps bitwise: one output group at blocks 1 and 4,
    rows a multiple of 32 or not (the dot's epilogue loop at 8 lanes,
    16 and 24 rows past the main loop), and three groups at block 1
    (FMA chains, the update's third column rounded apart, 3 rows past
    the last whole 8)."""
    rng = np.random.RandomState(n + block)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.1] = 0.0
    gh = np.stack([rng.randn(n, K), rng.rand(n, K) + 0.5],
                  -1).astype(np.float32)
    wj, bj = jnp.zeros((F, K)), jnp.zeros(K)
    wt, bt = torch.zeros(F, K), torch.zeros(K)
    XT = torch.from_numpy(np.ascontiguousarray(X.T))
    for _ in range(3):
        wj, bj = jgl._linear_boost_step(jnp.asarray(X), jnp.asarray(gh),
                                        wj, bj, 0.5, 1.0, 0.01, 0.0,
                                        block=block)
        wt, bt = tgl._linear_boost_step(XT, torch.from_numpy(gh), wt, bt,
                                        0.5, 1.0, 0.01, 0.0, block=block)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def test_k_group_products_are_fma_chains():
    """K = 3 at block 1: each block's ``Gf`` / ``Hf`` is XLA's elemental
    dot, one FMA chain over the rows (``_fma_chain``), bitwise against
    the same product by an XLA CPU dot of that form."""
    rng = np.random.RandomState(9)
    n = 2400
    x = rng.randn(n).astype(np.float32)
    Y = rng.randn(n, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, Y, b: jax.lax.dynamic_slice_in_dim(
        x[:, None], b, 1, 1).T @ Y)(jnp.asarray(x), jnp.asarray(Y), 0))[0]
    np.testing.assert_array_equal(tgl._fma_chain(x, Y), want)


def test_eval_lines_byte_equal(trained):
    rj, rt = trained["jax"]["res"], trained["port"]["res"]
    assert list(rj) == list(rt)
    for k in rj:
        assert [f"{v:.6f}" for v in rj[k]] == [f"{v:.6f}" for v in rt[k]], k


def test_predictions_match_jax(trained):
    X = trained["X"][2400:]
    for margin in (False, True):
        pj = trained["jax"]["bst"].predict(xj.DMatrix(X),
                                           output_margin=margin)
        pt = trained["port"]["bst"].predict(xt.DMatrix(X),
                                            output_margin=margin)
        np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=1e-5)


def test_model_files_cross_load(trained):
    """Each package's file in the other: the same weights, the same
    predictions (one group's margins bitwise: the port replays XLA's
    CPU matrix-vector order), and the dump text byte-equal."""
    X = trained["X"][:200]
    for owner in ("jax", "port"):
        path = trained[owner]["path"]
        bj = xj.Booster(model_file=path)
        bt = xt.Booster(model_file=path, device="cpu")
        np.testing.assert_array_equal(bt.gbtree.weight.numpy(),
                                      np.asarray(bj.gbtree.weight))
        np.testing.assert_array_equal(bt.gbtree.bias.numpy(),
                                      np.asarray(bj.gbtree.bias))
        assert bt.gbtree.version == bj.gbtree.version
        for margin in (False, True):
            pt = bt.predict(xt.DMatrix(X), output_margin=margin)
            pj = bj.predict(xj.DMatrix(X), output_margin=margin)
            if trained["obj"] == "multi:softmax" and margin:
                # a K > 1 product is an XLA CPU GEMM (F9)
                np.testing.assert_allclose(pt, pj, rtol=RTOL, atol=1e-6)
            else:
                np.testing.assert_array_equal(pt, pj)
        assert bt.get_dump() == bj.get_dump()
        assert bt.get_dump()[0].startswith("bias:\n")


def test_pred_leaf_raises_value_error(trained):
    X = trained["X"][:10]
    for pkg, bst in ((xj, trained["jax"]["bst"]),
                     (xt, trained["port"]["bst"])):
        with pytest.raises(ValueError, match="gblinear"):
            bst.predict(pkg.DMatrix(X), pred_leaf=True)


def test_boost_with_given_gradients_matches_jax():
    """``Booster.boost`` from user gradients: three rounds, the version
    counting them, weights within the tolerance."""
    X, y, _, _ = _data(1)
    g = (np.nan_to_num(X[:, 0]) - y / 4).astype(np.float32)
    h = np.full(N, 1.0, np.float32)
    out = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y)
        bst = pkg.Booster(_params("reg:linear"), cache=[d], **kw)
        for _ in range(3):
            bst.boost(d, g, h)
        out.append(bst)
    bj, bt = out
    assert bj.gbtree.version == bt.gbtree.version == 3
    np.testing.assert_allclose(bt.gbtree.weight.numpy(),
                               np.asarray(bj.gbtree.weight),
                               rtol=RTOL, atol=ATOL)


def test_cv_lines_byte_equal():
    X, _, y, _ = _data(2)
    params = _params("binary:logistic", eval_metric="logloss")
    lines = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        with contextlib.redirect_stdout(io.StringIO()):
            lines.append(pkg.cv(params, pkg.DMatrix(X[:900], label=y[:900]),
                                3, nfold=3, seed=5, **kw))
    assert lines[0] == lines[1]


def test_set_param_and_continued_training():
    """``set_param`` on a trained linear booster changes eta for the next
    rounds in both packages alike, and ``train(xgb_model=)`` continues."""
    X, y, _, _ = _data(3)
    out = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X[:600], label=y[:600])
        bst = pkg.train(_params("reg:linear"), d, 2, verbose_eval=False,
                        **kw)
        bst.set_param({"eta": 0.1})
        bst = pkg.train(_params("reg:linear", eta=0.1), d, 2,
                        xgb_model=bst, verbose_eval=False, **kw)
        out.append(bst)
    assert out[0].gbtree.version == out[1].gbtree.version == 4
    np.testing.assert_allclose(out[1].gbtree.weight.numpy(),
                               np.asarray(out[0].gbtree.weight),
                               rtol=RTOL, atol=ATOL)


def test_engine_and_feature_importance_refuse_gblinear(trained):
    from xgboost_tpu_torch.serving import PredictEngine
    bt = trained["port"]["bst"]
    with pytest.raises(NotImplementedError, match="gblinear"):
        PredictEngine(bt)
    with pytest.raises(AttributeError):
        bt.get_fscore()


def test_dsplit_row_gblinear_names_item_13():
    """``dsplit=row`` gblinear trains (a world of one without a process
    group: the weights of ``dsplit=auto``); gblinear ignores ``dsplit=col``
    (item 13b), as the JAX package does: the weights of ``dsplit=auto``."""
    X, y, _, _ = _data(4)
    d = xt.DMatrix(X[:640], label=y[:640])
    row = xt.train(_params("reg:linear", dsplit="row"), d, 2, device="cpu")
    auto = xt.train(_params("reg:linear"), d, 2, device="cpu")
    np.testing.assert_array_equal(row.gbtree.weight.numpy(),
                                  auto.gbtree.weight.numpy())
    col = xt.train(_params("reg:linear", dsplit="col"), d, 2, device="cpu")
    np.testing.assert_array_equal(col.gbtree.weight.numpy(),
                                  auto.gbtree.weight.numpy())


def test_sklearn_gblinear_matches_jax():
    pytest.importorskip("sklearn")
    from xgboost_tpu.sklearn import XGBRegressor as JReg
    from xgboost_tpu_torch.sklearn import XGBRegressor as TReg
    X, y, _, _ = _data(5)
    X = np.nan_to_num(X[:800])
    kw = dict(booster="gblinear", n_estimators=4, learning_rate=0.5)
    pj = JReg(**kw).fit(X, y[:800]).predict(X)
    mt = TReg(device="cpu", **kw).fit(X, y[:800])
    np.testing.assert_allclose(mt.predict(X), pj, rtol=RTOL, atol=1e-5)
    with pytest.raises(AttributeError, match="gblinear"):
        mt.feature_importances_


# ---------------------------------------------------------------- the CLI
def _write_svm(path, X, y):
    with open(path, "w") as f:
        for row, label in zip(X, y):
            feats = " ".join(f"{j}:{v:.6g}" for j, v in enumerate(row)
                             if not np.isnan(v))
            f.write(f"{label:g} {feats}\n")


def _run(main, argv, cwd):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(list(argv))
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``booster=gblinear`` in a config file, trained by both CLIs, then
    the JAX model file read by both with task=pred and task=dump."""
    root = tmp_path_factory.mktemp("lincli")
    X, _, y, _ = _data(6)
    _write_svm(root / "train.svm", X[:1500], y[:1500])
    _write_svm(root / "test.svm", X[1500:2000], y[1500:2000])
    conf = root / "lin.conf"
    conf.write_text(
        "task = train\nbooster = gblinear\nobjective = binary:logistic\n"
        "eta = 0.5\nalpha = 0.01\nnum_round = 4\n"
        f"data = {root / 'train.svm'}\neval[test] = {root / 'test.svm'}\n"
        "eval_metric = error\nmodel_out = final.model\nsilent = 1\n")
    runs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["device=cpu"])):
        d = root / name
        d.mkdir()
        runs[name, "train"] = _run(main, [str(conf), *extra], d)
    model = str(root / "jax" / "final.model")
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["device=cpu"])):
        d = root / name
        runs[name, "pred"] = _run(main, [str(conf), *extra, "task=pred",
                                         f"model_in={model}",
                                         f"test:data={root / 'test.svm'}",
                                         "name_pred=pred.txt"], d)
        runs[name, "dump"] = _run(main, [str(conf), *extra, "task=dump",
                                         f"model_in={model}",
                                         "name_dump=dump.txt"], d)
        runs[name, "eval"] = _run(main, [str(conf), *extra, "task=eval",
                                         f"model_in={model}"], d)
    return root, runs


def test_cli_train_eval_lines_byte_equal(cli_runs):
    _, runs = cli_runs
    (rcj, _, ej), (rct, _, et) = runs["jax", "train"], runs["port", "train"]
    assert rcj == rct == 0
    lines = [[ln for ln in e.splitlines() if ln.startswith("[")]
             for e in (ej, et)]
    assert lines[0] and lines[0] == lines[1]


def test_cli_eval_line_byte_equal(cli_runs):
    _, runs = cli_runs
    (rcj, _, ej), (rct, _, et) = runs["jax", "eval"], runs["port", "eval"]
    assert rcj == rct == 0
    lines = [[ln for ln in e.splitlines() if ln.startswith("[")]
             for e in (ej, et)]
    assert lines[0] and lines[0] == lines[1]


@pytest.mark.parametrize("task,out", [("pred", "pred.txt"),
                                      ("dump", "dump.txt")])
def test_cli_pred_and_dump_byte_equal(cli_runs, task, out):
    root, runs = cli_runs
    assert runs["jax", task][0] == runs["port", task][0] == 0
    with open(root / "jax" / out, "rb") as a, \
            open(root / "port" / out, "rb") as b:
        assert a.read() == b.read()
