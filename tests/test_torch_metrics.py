"""Metric names in the PyTorch port against the JAX package's factory.

A name the JAX package does not know raises its ``ValueError``, with the
same message, in both; every name it knows gives a metric of that name
whose value is the JAX package's to the bit (host float64 numpy, the
same code) on seeded predictions, labels, weights, groups and, for
``ct-``, fold indices.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from xgboost_tpu import metrics as jm  # noqa: E402
from xgboost_tpu_torch import metrics as tm  # noqa: E402


@pytest.mark.parametrize("name", [
    "rmsee", "auc@x", "ct-bogus", "auc@5", "rmse@3-", "ndcg-", "ams@x",
    "ndcg@x", "ct-map@y", "ct-ct-nope", "", "@"])
def test_unknown_names_raise_the_reference_error(name):
    with pytest.raises(ValueError) as want:
        jm.create_metric(name)
    with pytest.raises(ValueError) as got:
        tm.create_metric(name)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def _inputs(name, n=600):
    """Seeded inputs for ``name``: ranking labels 0-2 in 12 groups of
    50 rows, 0/1 labels otherwise; a ``ct-`` metric gets four stacked
    prediction sets (the model and three folds) and fold indices."""
    rng = np.random.RandomState(sum(map(ord, name)))
    preds = rng.rand(n).astype(np.float32)
    preds[:40] = preds[40:80]                 # ties
    labels = rng.randint(0, 3, n).astype(np.float32)
    if name.removeprefix("ct-").split("@")[0] not in ("ndcg", "map", "pre"):
        labels = (labels > 0).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    gptr = np.arange(0, n + 1, 50)
    kw = {}
    if name.startswith("ct-"):
        preds = rng.rand(4 * n).astype(np.float32)
        kw["fold_index"] = np.arange(n) % 3
    return (preds, labels, weights, gptr), kw


@pytest.mark.parametrize("name", [
    "ams", "ams@0.2", "pratio", "pratio@", "pratio@0.3", "apratio",
    "apratio@0.5", "ndcg", "ndcg@10", "ndcg@10-", "map", "map@5-", "pre",
    "pre@3", "ct-rmse", "ct-auc", "ct-ndcg@4"])
def test_known_names_match_the_jax_package(name):
    args, kw = _inputs(name)
    want = jm.create_metric(name)(*args, **kw)
    got = tm.create_metric(name)
    assert got.metric_name == name
    assert getattr(got, "needs_fold_index", False) == name.startswith("ct-")
    value = got(*args, **kw)
    assert isinstance(value, float)
    assert np.float64(value).tobytes() == np.float64(want).tobytes()


@pytest.mark.parametrize("name", [
    "rmse", "logloss", "error", "merror", "mlogloss", "auc"])
def test_ported_names_carry_their_name(name):
    assert jm.create_metric(name).metric_name == name
    assert tm.create_metric(name).metric_name == name
