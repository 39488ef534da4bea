"""The scikit-learn estimators of the PyTorch port
(``xgboost_tpu_torch.sklearn``) against the JAX package's, on the CPU:
the cases of ``tests/test_sklearn.py`` run on both packages with the
same data and arguments (the port's with ``device="cpu"``).

Tolerances and why:

- predictions and probabilities within 1e-5: the same trees (depth 3,
  where structure is bitwise between the packages), leaf values and
  logistic / softmax transforms within f32 rounding;
- ``apply`` leaf indices and ``feature_importances_`` equal: they read
  only the structure;
- ``best_iteration_`` equal, ``best_score_`` and ``evals_result_``
  within rtol 1e-5 (metrics over those predictions);
- without scikit-learn (a subprocess where importing it fails, the
  card's machine's case): the fallback label encoder and the estimators
  run, and predict what the same estimators predict with it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu.sklearn as js  # noqa: E402
import xgboost_tpu_torch.sklearn as ts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"j": (js, {}), "t": (ts, {"device": "cpu"})}


def _reg_data(n=600, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = 3.0 * X[:, 0] - 2.0 * X[:, 1] ** 2 + 0.1 * rng.randn(n)
    return X, y.astype(np.float32)


def both(fn):
    """``fn(module, extra_kwargs)`` for the JAX package and the port."""
    return [fn(mod, kw) for mod, kw in PKGS.values()]


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=0, atol=tol)


def test_regressor_fit_predict():
    X, y = _reg_data()

    def run(m, kw):
        model = m.XGBRegressor(n_estimators=20, max_depth=3,
                               learning_rate=0.3, **kw)
        model.fit(X[:500], y[:500])
        return model.predict(X[500:]), model.feature_importances_
    (pj, ij), (pt, it) = both(run)
    close(pj, pt)
    np.testing.assert_array_equal(it, ij)
    assert float(np.mean((pt - y[500:]) ** 2)) < 0.1
    assert it.shape == (8,) and abs(it.sum() - 1.0) < 1e-5


def test_binary_classifier_with_string_labels():
    rng = np.random.RandomState(1)
    X = rng.rand(500, 5).astype(np.float32)
    y_raw = np.where(X[:, 0] + X[:, 1] > 1.0, "pos", "neg")

    def run(m, kw):
        model = m.XGBClassifier(n_estimators=15, max_depth=3, **kw)
        model.fit(X, y_raw)
        return model.predict(X), model.predict_proba(X)
    (lj, pj), (lt, pt) = both(run)
    np.testing.assert_array_equal(lt, lj)
    close(pj, pt)
    assert set(lt) <= {"pos", "neg"} and (lt == y_raw).mean() > 0.93
    assert pt.shape == (500, 2)


def test_multiclass_classifier_auto_switch():
    rng = np.random.RandomState(2)
    X = rng.rand(600, 6).astype(np.float32)
    y = (X[:, 0] * 3).astype(int)

    def run(m, kw):
        model = m.XGBClassifier(n_estimators=10, max_depth=3, **kw)
        model.fit(X, y)
        assert model.get_booster().param.objective == "multi:softprob"
        assert model.objective == "binary:logistic"
        assert model.n_classes_ == 3
        return model.predict_proba(X), model.predict(X), model.apply(X)
    (pj, lj, aj), (pt, lt, at) = both(run)
    assert pt.shape == (600, 3)
    close(pj, pt)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(at, aj)
    assert (lt == y).mean() > 0.9


def test_early_stopping_and_eval_set():
    X, y = _reg_data()

    def run(m, kw):
        model = m.XGBRegressor(n_estimators=200, max_depth=3,
                               learning_rate=0.3, **kw)
        model.fit(X[:400], y[:400], eval_set=[(X[400:], y[400:])],
                  early_stopping_rounds=5)
        return (model.best_iteration_, model.best_score_,
                model.evals_result_, model.predict(X[400:]))
    (bj, sj, ej, pj), (bt, st, et, pt) = both(run)
    assert bt == bj and bt < 199
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    assert list(et) == list(ej) == ["validation_0-rmse"]
    np.testing.assert_allclose(et["validation_0-rmse"],
                               ej["validation_0-rmse"], rtol=1e-5)
    close(pj, pt)


def test_get_set_params_roundtrip():
    model = ts.XGBRegressor(n_estimators=7, subsample=0.8)
    p = model.get_params()
    assert p["n_estimators"] == 7 and p["subsample"] == 0.8
    assert p["device"] == "cuda"
    assert set(p) - {"device"} == set(js.XGBRegressor().get_params())
    model.set_params(max_depth=5, device="cpu")
    assert model.max_depth == 5 and model.device == "cpu"
    assert "device" not in model.get_xgb_params()
    with pytest.raises(ValueError):
        model.set_params(bogus=1)


@pytest.mark.skipif(not ts.SKLEARN_INSTALLED, reason="sklearn not installed")
def test_sklearn_cross_val_integration():
    from sklearn.base import clone
    from sklearn.model_selection import cross_val_score
    X, y = _reg_data(n=300)

    def run(m, kw):
        return cross_val_score(
            m.XGBRegressor(n_estimators=40, max_depth=3, learning_rate=0.3,
                           **kw), X, y, cv=3,
            scoring="neg_mean_squared_error")
    sj, st = both(run)
    close(sj, st)
    assert st.mean() > -0.2
    assert clone(ts.XGBClassifier(device="cpu")).device == "cpu"


def test_apply_leaf_indices():
    X, y = _reg_data(n=200)

    def run(m, kw):
        return m.XGBRegressor(n_estimators=5, max_depth=3, **kw).fit(
            X, y).apply(X)
    aj, at = both(run)
    assert at.shape == (200, 5)
    np.testing.assert_array_equal(at, aj)


def test_classifier_refit_binary_after_multiclass():
    rng = np.random.RandomState(4)
    X3 = rng.rand(300, 4).astype(np.float32)
    y3 = (X3[:, 0] * 3).astype(int)
    X2 = rng.rand(300, 4).astype(np.float32)
    y2 = (X2[:, 0] > 0.5).astype(int)

    def run(m, kw):
        model = m.XGBClassifier(n_estimators=5, max_depth=3, **kw)
        model.fit(X3, y3)
        model.fit(X2, y2)
        return model.predict_proba(X2), model.predict(X2)
    (pj, lj), (pt, lt) = both(run)
    assert pt.shape == (300, 2)
    close(pj, pt)
    np.testing.assert_array_equal(lt, lj)
    assert (lt == y2).mean() > 0.9


def test_early_stopping_without_eval_set_raises():
    X, y = _reg_data(n=100)
    with pytest.raises(ValueError, match="early stopping"):
        ts.XGBRegressor(n_estimators=10, device="cpu").fit(
            X, y, early_stopping_rounds=3)


def test_estimators_default_to_the_gpu():
    X, y = _reg_data(n=50)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ts.XGBRegressor(n_estimators=2).fit(X, y)


_NO_SKLEARN = r"""
import sys, builtins
real_import = builtins.__import__
def no_sklearn(name, *a, **k):
    if name == "sklearn" or name.startswith("sklearn."):
        raise ImportError("scikit-learn made unimportable")
    return real_import(name, *a, **k)
builtins.__import__ = no_sklearn
import numpy as np
import xgboost_tpu_torch as xt
from xgboost_tpu_torch import sklearn as s
assert not s.SKLEARN_INSTALLED and s.BaseEstimator is object
rng = np.random.RandomState(3)
X = rng.rand(300, 4).astype(np.float32)
y = np.where(X[:, 0] > 0.5, "b", "a")
m = xt.XGBClassifier(n_estimators=4, max_depth=3, device="cpu").fit(X, y)
np.save(sys.argv[1], m.predict_proba(X))
print(",".join(m.predict(X[:5])))
r = xt.XGBRegressor(n_estimators=3, device="cpu").fit(X, X[:, 1])
print(r.apply(X).shape)
try:
    s.LabelEncoder().fit(["a", "b"]).transform(["c"])
except ValueError as e:
    print("unseen:", e)
"""


def test_estimators_run_without_sklearn(tmp_path):
    out = str(tmp_path / "proba.npy")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", _NO_SKLEARN, out],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    rng = np.random.RandomState(3)
    X = rng.rand(300, 4).astype(np.float32)
    y = np.where(X[:, 0] > 0.5, "b", "a")
    m = ts.XGBClassifier(n_estimators=4, max_depth=3, device="cpu").fit(X, y)
    np.testing.assert_array_equal(np.load(out), m.predict_proba(X))
    lines = p.stdout.splitlines()
    assert lines[0] == ",".join(m.predict(X[:5]))
    assert lines[1] == "(300, 3)"
    assert lines[2].startswith("unseen: y contains previously unseen")
