"""Multi-root trees in the PyTorch port against the JAX package, on the
CPU at fp32: ``num_roots`` with a per-row ``root_index`` (the scenario
of ``tests/test_updaters.py::test_multi_root_trees_route_by_root_index``),
model files both ways, ``meta_root_index`` buffers and the dump.

Tolerances: trees, predictions, leaf indices and dump text equal; a
model file predicts the same bits in either package (same trees, same
bins, leaf values added in the same order)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402

PARAMS = {"objective": "binary:logistic", "max_depth": 2, "eta": 1.0,
          "num_roots": 2, "hist_precision": "fp32"}


def regime_data():
    rng = np.random.RandomState(7)
    n = 2000
    X = rng.rand(n, 3).astype(np.float32)
    regime = (rng.rand(n) > 0.5).astype(np.uint32)
    # opposite relationships per regime: two roots capture both
    y = np.where(regime == 0, X[:, 0] > 0.5, X[:, 0] <= 0.5).astype(
        np.float32)
    return X, y, regime


def dmat(pkg, X, y, root=None):
    d = pkg.DMatrix(X, label=y)
    if root is not None:
        d.set_uint_info("root_index", root)
    return d


@pytest.fixture(scope="module")
def trained():
    X, y, regime = regime_data()
    out = {"X": X, "y": y, "regime": regime}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        d = dmat(pkg, X, y, regime)
        res = {}
        bst = pkg.train(PARAMS, d, 3, evals=[(d, "train")],
                        evals_result=res, verbose_eval=False, **kw)
        out[name] = bst
        out[name + "_res"] = res
    return out


def test_trees_and_predictions_equal(trained):
    X, y, regime = trained["X"], trained["y"], trained["regime"]
    assert trained["t_res"] == trained["j_res"]
    assert trained["t_res"]["train-error"][-1] < 0.02
    sj = trained["j"].gbtree.get_state()
    st = trained["t"].gbtree.get_state()
    assert st["tree_feature"].shape == (3, 15)     # 2 ** (1 + 2 + 1) - 1
    for k in sj:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    for root in (regime, 1 - regime, None):
        for kw in ({}, {"output_margin": True}, {"pred_leaf": True}):
            pj = trained["j"].predict(dmat(xj, X, y, root), **kw)
            pt = trained["t"].predict(dmat(xt, X, y, root), **kw)
            np.testing.assert_array_equal(pt, np.asarray(pj))
    # root routing matters: every row's root flipped is wrong
    flip = trained["t"].predict(dmat(xt, X, y, 1 - regime))
    assert float(np.mean((flip > 0.5) == y)) < 0.2
    # the training matrix's cached margin agrees with a fresh one
    d = dmat(xt, X, y, regime)
    np.testing.assert_array_equal(trained["t"].predict(d),
                                  trained["t"].predict(dmat(xt, X, y,
                                                            regime)))


def test_model_files_cross_load(trained, tmp_path):
    X, y, regime = trained["X"], trained["y"], trained["regime"]
    jpath, tpath = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    trained["j"].save_model(jpath)
    trained["t"].save_model(tpath)
    want = np.asarray(trained["j"].predict(dmat(xj, X, y, regime),
                                           output_margin=True))
    t_of_j = xt.Booster(model_file=jpath, device="cpu")
    np.testing.assert_array_equal(
        t_of_j.predict(dmat(xt, X, y, regime), output_margin=True), want)
    j_of_t = xj.Booster(model_file=tpath)
    np.testing.assert_array_equal(
        np.asarray(j_of_t.predict(dmat(xj, X, y, regime),
                                  output_margin=True)), want)
    # the JAX state carried across in memory predicts the same
    gbt = xt.gbtree_from_jax_state(trained["j"].gbtree.get_state(),
                                   trained["j"].param, device="cpu")
    assert gbt.cfg.n_roots == 2
    t_of_j.gbtree = gbt
    np.testing.assert_array_equal(
        t_of_j.predict(dmat(xt, X, y, regime), output_margin=True), want)


def test_dump_text_equal(trained):
    dj, dt = trained["j"].get_dump(), trained["t"].get_dump()
    assert dt == dj
    assert dt[0].count(":[") >= 2    # a split under each root
    assert dt[0].startswith("1:[") and "\n2:[" in dt[0]
    assert (trained["t"].get_dump(with_stats=True)
            == trained["j"].get_dump(with_stats=True))


def test_root_index_buffers_round_trip(tmp_path):
    """``meta_root_index`` / ``meta_fold_index`` written by either
    package load in both, and a buffer trains the same model as its
    matrix."""
    X, y, regime = regime_data()
    fold = (np.arange(len(y)) % 5).astype(np.uint32)
    paths = {}
    for name, pkg in (("j", xj), ("t", xt)):
        d = dmat(pkg, X, y, regime)
        d.set_uint_info("fold_index", fold)
        paths[name] = str(tmp_path / f"{name}.buffer")
        d.save_binary(paths[name])
    for path in paths.values():
        for pkg in (xj, xt):
            d = pkg.DMatrix.load_binary(path)
            np.testing.assert_array_equal(d.get_uint_info("root_index"),
                                          regime)
            np.testing.assert_array_equal(d.get_uint_info("fold_index"),
                                          fold)
        b_buf = xt.train(PARAMS, xt.DMatrix.load_binary(path), 2,
                         device="cpu")
        b_mat = xt.train(PARAMS, dmat(xt, X, y, regime), 2, device="cpu")
        assert b_buf.save_raw() == b_mat.save_raw()
    d = xt.DMatrix(X, label=y)
    assert d.get_uint_info("root_index").size == 0
    with pytest.raises(ValueError, match="uint32"):
        d.set_uint_info("root_index", np.array([-1, 0]))
    with pytest.raises(ValueError, match="unknown"):
        d.set_uint_info("label", regime)


@pytest.mark.parametrize("extra", [
    {"objective": "reg:linear", "num_parallel_tree": 2},
    {"objective": "multi:softmax", "num_class": 3},
], ids=["forest", "multiclass"])
def test_multi_root_rounds_of_several_trees(extra, monkeypatch):
    """Multi-root growth with T > 1 trees a round (K3's path): trees and
    margins equal to the JAX package's (the forest with reg:linear's
    (g, 1), as ``tests/test_torch_sampling.py`` holds forests bitwise:
    under binary:logistic the JAX package's batched node totals at the
    root-slot level differ from the port's by an ulp in round 1), and
    every position tensor handed
    to the level histogram is contiguous, as the CUDA kernel requires (a
    stride-0 view of the root slots passes the plain version but not the
    kernel)."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    X, y, regime = regime_data()
    X, y, regime = X[:600], y[:600], regime[:600]
    if "num_class" in extra:
        y = np.where(regime == 1, 2.0, y).astype(np.float32)
    params = {**PARAMS, **extra}
    seen = []
    plain = kb.level_histogram_batched

    def checked(bins, gh, pos, *args):
        seen.append(pos.is_contiguous() and gh.is_contiguous()
                    and bins.is_contiguous())
        return plain(bins, gh, pos, *args)
    monkeypatch.setattr(kb, "level_histogram_batched", checked)
    res = {}
    for name, pkg, kw in (("t", xt, {"device": "cpu"}), ("j", xj, {})):
        d = dmat(pkg, X, y, regime)
        res[name] = {}
        # per round in both packages (a watchlist), as ``trained`` runs
        res[name + "b"] = pkg.train(params, d, 2, evals=[(d, "train")],
                                    evals_result=res[name],
                                    verbose_eval=False, **kw)
    bt, bj = res["tb"], res["jb"]
    assert res["t"] == res["j"]
    assert seen and all(seen)
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    for k in sj:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    np.testing.assert_array_equal(
        bt.predict(dmat(xt, X, y, regime), output_margin=True),
        np.asarray(bj.predict(dmat(xj, X, y, regime), output_margin=True)))
