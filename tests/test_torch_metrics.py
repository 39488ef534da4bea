"""Metric names in the PyTorch port against the JAX package's factory.

A name the JAX package does not know raises its ``ValueError``, with the
same message, in both; a name it knows that the port has not ported yet
raises ``NotImplementedError`` in the port, where the JAX package
returns a metric.
"""

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


@pytest.mark.parametrize("name", [
    "ams", "ams@0.2", "pratio", "pratio@", "pratio@0.3", "apratio",
    "apratio@0.5", "ndcg", "ndcg@10", "ndcg@10-", "map", "map@5-", "pre",
    "pre@3", "ct-rmse", "ct-auc", "ct-ndcg@4"])
def test_known_unported_names_raise_not_implemented(name):
    assert callable(jm.create_metric(name))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.create_metric(name)


@pytest.mark.parametrize("name", [
    "rmse", "logloss", "error", "merror", "mlogloss", "auc"])
def test_ported_names_carry_their_name(name):
    assert jm.create_metric(name).metric_name == name
    assert tm.create_metric(name).metric_name == name
