"""The rest of the Booster API in the PyTorch port against the JAX
package, on the CPU: custom objectives (``train(obj=)``), ``boost``,
``mknfold`` / ``cv`` / ``aggcv``, ``DMatrix.slice`` and the float info,
and the ``ct-`` metric's errors.

Tolerances and why:

- a numpy ``fobj`` on ``binary:logitraw`` sees the margins, which are
  bitwise in both packages at fp32, so its gradients are bitwise, the
  trees' structure and eval lines equal, leaf values within rtol 1e-5
  (node totals summed in another order, ROADMAP.md section 3);
- ``boost`` in the port: the built-in gradient pulled to the host and
  boosted gives the model bytes of ``update`` (the same gradients);
  against the JAX package, structure bitwise and leaves within 1e-5;
- folds, slices, float info, cuts and bins: equal (the same numpy code);
- ``cv`` text equal to the byte: per-fold eval lines are equal, so the
  float64 means and deviations are too.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu import metrics as jm  # noqa: E402
from xgboost_tpu_torch import metrics as tm  # noqa: E402

N, F = 1500, 6
PARAMS = {"max_depth": 3, "eta": 0.3, "max_bin": 32, "hist_precision": "fp32"}
STRUCTURE = ("tree_feature", "tree_cut_index", "tree_threshold",
             "tree_default_left", "tree_is_leaf")


def _data(seed=0, missing_share=0.1):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    X[rng.rand(N, F) < missing_share] = np.nan
    Z = np.nan_to_num(X)
    y = (Z[:, 0] + Z[:, 1] * Z[:, 2] > 0.3).astype(np.float32)
    return X, y


def logistic_fobj(preds, dtrain):
    """Logistic loss on margins, in float64 numpy."""
    p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
    y = dtrain.get_label()
    return p - y, p * (1.0 - p)


def _assert_trees(bj, bt, rtol=1e-5):
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    for k in STRUCTURE:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    np.testing.assert_allclose(st["tree_leaf_value"],
                               np.asarray(sj["tree_leaf_value"]),
                               rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("with_evals", [True, False])
def test_custom_objective_trains_the_jax_trees(with_evals):
    X, y = _data()
    params = dict(PARAMS, objective="binary:logitraw", eval_metric="auc")
    out = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y)
        res = {}
        evals = [(d, "train")] if with_evals else []
        out[name] = (pkg.train(params, d, 4, evals=evals, obj=logistic_fobj,
                               evals_result=res, verbose_eval=False, **kw),
                     res)
    _assert_trees(out["j"][0], out["t"][0])
    assert out["t"][1] == out["j"][1]
    assert out["t"][0].gbtree.num_trees == 4


def test_custom_objective_sees_user_rows_of_a_padded_entry():
    from test_torch_rank import make_ranking
    X, y, groups = make_ranking(seed=1, n_groups=30)
    seen = {}

    def fobj(preds, dtrain):
        seen.setdefault("shape", preds.shape)
        return preds - dtrain.get_label(), np.ones_like(preds)
    out = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y, group=groups)
        out.append(pkg.train(dict(PARAMS, objective="rank:ndcg"), d, 3,
                             obj=fobj, **kw))
    assert seen["shape"] == (len(y),)
    _assert_trees(*out)


def test_boost_from_the_builtin_gradient_equals_update():
    X, y = _data(1)
    params = dict(PARAMS, objective="binary:logistic", subsample=0.8)
    d1, d2 = xt.DMatrix(X, label=y), xt.DMatrix(X, label=y)
    b1 = xt.Booster(params, cache=[d1], device="cpu")
    b2 = xt.Booster(params, cache=[d2], device="cpu")
    for i in range(3):
        b1.update(d1, i)
        b2._lazy_init(d2)
        e = b2._entry(d2)
        b2._sync_margin(e)
        gh = b2.obj.get_gradient(e.margin, d2.info, i).numpy()
        b2.boost(d2, gh[:, 0, 0], gh[:, 0, 1])
    assert b1.save_raw() == b2.save_raw()


@pytest.mark.parametrize("objective", ["reg:linear", "rank:ndcg"])
def test_boost_matches_the_jax_package(objective):
    """Given gradients, both packages grow the same trees; on a rank
    matrix both lay the rows out padded and scatter the user rows."""
    from test_torch_rank import make_ranking
    X, y, groups = make_ranking(seed=2, n_groups=30)
    rng = np.random.RandomState(0)
    g = rng.randn(len(y)).astype(np.float32)
    h = (np.abs(rng.randn(len(y))) + 0.1).astype(np.float32)
    out = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y, group=groups)
        b = pkg.Booster(dict(PARAMS, objective=objective), cache=[d], **kw)
        b.boost(d, g, h)
        b.boost(d, g * 0.5, h)
        out.append((b, b.predict(d, output_margin=True)))
    (bj, pj), (bt, pt) = out
    assert (bt._cache[id(next(iter(bt._cache.values())).dmat)]
            .rank_pad_prep is not None) == (objective == "rank:ndcg")
    _assert_trees(bj, bt)
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- cv
def _cv_data(pkg, seed=3):
    X, y = _data(seed)
    w = np.random.RandomState(seed).uniform(0.5, 2.0, N).astype(np.float32)
    return pkg.DMatrix(X, label=y, weight=w)


def test_mknfold_folds_equal():
    dj, dt = _cv_data(xj), _cv_data(xt)
    pj = xj.mknfold(dj, 4, PARAMS, seed=5)
    pt = xt.mknfold(dt, 4, PARAMS, seed=5, device="cpu")
    assert len(pt) == 4
    for a, b in zip(pj, pt):
        for da, db in ((a.dtrain, b.dtrain), (a.dtest, b.dtest)):
            np.testing.assert_array_equal(db.get_label(), da.get_label())
            np.testing.assert_array_equal(db.get_weight(), da.get_weight())
            np.testing.assert_array_equal(db.to_dense(), da.to_dense())


def _fpreproc(dtrain, dtest, param):
    label = dtrain.get_label()
    param["scale_pos_weight"] = float(np.sum(label == 0) / np.sum(label == 1))
    return dtrain, dtest, param


def _feval(preds, dmat):
    return "mae", float(np.mean(np.abs(preds - dmat.get_label())))


@pytest.mark.parametrize("case", ["plain", "fpreproc", "no_stdv", "feval"])
def test_cv_text_equal_to_the_byte(case, capsys):
    kw = {"nfold": 3, "seed": 1, "metrics": ["auc", "ams@0.15",
                                             "pratio@0.1"]}
    if case == "fpreproc":
        kw["fpreproc"] = _fpreproc
    elif case == "no_stdv":
        kw["show_stdv"] = False
    elif case == "feval":
        kw = {"nfold": 3, "seed": 2, "feval": _feval}
    params = dict(PARAMS, objective="binary:logistic")
    want = xj.cv(params, _cv_data(xj), 3, **kw)
    printed_j = capsys.readouterr().out
    got = xt.cv(params, _cv_data(xt), 3, device="cpu", **kw)
    assert got == want
    assert capsys.readouterr().out == printed_j
    assert all(line.startswith(f"[{i}]\tcv-") for i, line in enumerate(got))


def test_aggcv_equal():
    lines = ["[2]\ttrain-auc:0.9\ttest-auc:0.8\ttest-auc:0.7",
             "[2]\ttrain-auc:0.95\ttest-auc:0.75\ttest-auc:0.72"]
    for stdv in (True, False):
        assert xt.aggcv(lines, stdv) == xj.aggcv(lines, stdv)


# ---------------------------------------------------------- DMatrix API
@pytest.mark.parametrize("missing", [np.nan, -999.0])
def test_slice_and_its_cuts_and_bins_equal(missing):
    from xgboost_tpu.binning import bin_matrix as jbin, compute_cuts as jcut
    from xgboost_tpu_torch.binning import (bin_matrix as tbin,
                                           compute_cuts as tcut)
    X, y = _data(4, missing_share=0.2)
    if not np.isnan(missing):
        X = np.where(np.isnan(X), np.float32(missing), X)
        X[::7, 1] = np.nan          # stored as a value under -999
    rows = np.random.RandomState(4).permutation(N)[:900]
    out = []
    for pkg in (xj, xt):
        d = pkg.DMatrix(X, label=y, missing=missing, base_margin=y * 0.5)
        d.set_uint_info("fold_index", np.arange(N) % 3)
        d.set_group(np.full(N // 100, 100))
        out.append(d.slice(rows))
    sj, st = out
    assert (st.num_row, st.num_col) == (sj.num_row, sj.num_col)
    assert st.get_uint_info("group_ptr").size == 0
    for f in ("label", "weight", "base_margin"):
        np.testing.assert_array_equal(st.get_float_info(f),
                                      sj.get_float_info(f), err_msg=f)
    np.testing.assert_array_equal(st.get_base_margin(), sj.get_base_margin())
    np.testing.assert_array_equal(st.get_uint_info("fold_index"),
                                  sj.get_uint_info("fold_index"))
    np.testing.assert_array_equal(st.to_dense(), sj.to_dense())
    np.testing.assert_array_equal(st.to_dense(-1.0), sj.to_dense(-1.0))
    cj, ct = jcut(sj, 32, 0.03, 2.0), tcut(st, 32, 0.03, 2.0)
    np.testing.assert_array_equal(ct.cut_values, cj.cut_values)
    np.testing.assert_array_equal(ct.n_cuts, cj.n_cuts)
    np.testing.assert_array_equal(tbin(st, ct), jbin(sj, cj))


def test_float_info_round_trip():
    X, y = _data(5)
    out = []
    for pkg in (xj, xt):
        d = pkg.DMatrix(X)
        empty = d.get_float_info("weight")
        d.set_float_info("label", y.astype(np.float64))
        d.set_float_info("weight", np.arange(N))
        assert d.get_base_margin() is None
        d.set_float_info("base_margin", y * 2)
        with pytest.raises(ValueError) as e:
            d.set_float_info("group", y)
        out.append((empty, [d.get_float_info(f) for f in
                            ("label", "weight", "base_margin")],
                    d.get_base_margin(), str(e.value)))
    (ej, fj, bj, mj), (et, ft, bt, mt) = out
    assert ej.size == et.size == 0 and et.dtype == np.float32
    for a, b in zip(fj, ft):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(bt, bj)
    assert mt == mj


@pytest.mark.parametrize("case", ["no_fold_index", "one_set", "fold_gap",
                                  "ragged"])
def test_ct_metric_raises_the_jax_errors(case):
    n = 60
    rng = np.random.RandomState(6)
    labels = (rng.rand(n) < 0.5).astype(np.float32)
    weights = np.ones(n, np.float32)
    preds = rng.rand(n * 4)                 # the model and 3 folds
    fold = np.arange(n) % 3
    if case == "no_fold_index":
        fold = None
    elif case == "one_set":
        preds = preds[:n * 2]
    elif case == "fold_gap":
        fold = np.where(fold == 1, 2, fold)
    else:
        preds = preds[:n * 3 + 1]
    errs = []
    for mod in (jm, tm):
        with pytest.raises(ValueError) as e:
            mod.create_metric("ct-auc")(preds, labels, weights, None,
                                        fold_index=fold)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    stacked, fold = np.arange(n * 4) % 7 / 7.0, np.arange(n) % 3
    assert (tm.create_metric("ct-auc")(stacked, labels, weights, None,
                                       fold_index=fold)
            == jm.create_metric("ct-auc")(stacked, labels, weights, None,
                                          fold_index=fold))


def test_ct_metric_in_eval_set_raises_the_jax_error():
    """``eval_set`` hands a ``ct-`` metric the rows' fold index; one
    prediction set is not the stacked layout, so both packages raise the
    same error."""
    X, y = _data(7)
    errs = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y)
        d.set_uint_info("fold_index", np.arange(N) % 3)
        b = pkg.train(dict(PARAMS, objective="binary:logistic"), d, 1, **kw)
        b.set_param("eval_metric", "ct-error")
        with pytest.raises(ValueError) as e:
            b.eval(d, "x")
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "ct-: pred size does not meet requirement"
