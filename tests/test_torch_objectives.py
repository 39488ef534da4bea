"""Objectives and metrics of the PyTorch port against the JAX package.

Gradients: ``reg:linear`` is exact arithmetic on both sides and must be
bitwise; the logistic losses go through ``exp``, which XLA and torch
round differently.  The sigmoid p in (0, 1) may differ by a few ulp, at
most 2^-24 each, and ``g = (p - y) * w`` cancels, so g and h are held
within 4 * 2^-24 * w (w the row's weight times scale_pos_weight) plus 4
ulp of their own size.  Metrics are host float64 numpy on both sides;
they are held within 1e-7.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xgboost_tpu import metrics as jm  # noqa: E402
from xgboost_tpu import objectives as jo  # noqa: E402
from xgboost_tpu.data import MetaInfo as JMeta  # noqa: E402
from xgboost_tpu_torch import metrics as tm  # noqa: E402
from xgboost_tpu_torch import objectives as to  # noqa: E402

ULP4 = 4 * 2.0 ** -23
P_ULP4 = 4 * 2.0 ** -24   # 4 ulp of any p in [0.5, 1)


def _inputs(seed=0, N=2000):
    rng = np.random.RandomState(seed)
    margin = (rng.randn(N, 1) * 3).astype(np.float32)
    label = (rng.rand(N) < 0.4).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, N).astype(np.float32)
    return margin, label, weight


def _grads(name, margin, label, weight, spw=1.0):
    oj = jo.create_objective(name)
    oj.set_param("scale_pos_weight", spw)
    info = JMeta()
    info.set_field("label", label)
    info.set_field("weight", weight)
    want = np.asarray(oj.get_gradient(jnp.asarray(margin), info, 0,
                                      len(label)))
    ot = to.create_objective(name)
    ot.set_param("scale_pos_weight", spw)
    got = ot.get_gradient(torch.from_numpy(margin), torch.from_numpy(label),
                          torch.from_numpy(weight)).numpy()
    return got, want


def test_linear_gradient_bitwise():
    margin, _, weight = _inputs()
    label = np.random.RandomState(1).randn(len(weight)).astype(np.float32)
    got, want = _grads("reg:linear", margin, label, weight)
    assert got.shape == want.shape == (len(label), 1, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["binary:logistic", "reg:logistic",
                                  "binary:logitraw"])
@pytest.mark.parametrize("spw", [1.0, 3.0])
def test_logistic_gradients_within_ulps(name, spw):
    margin, label, weight = _inputs(seed=2)
    got, want = _grads(name, margin, label, weight, spw=spw)
    w = np.where(label == 1.0, weight * spw, weight)[:, None, None]
    bound = P_ULP4 * w + ULP4 * np.abs(want)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("name", ["reg:linear", "reg:logistic",
                                  "binary:logistic", "binary:logitraw"])
def test_transforms_and_base_margin(name):
    margin, _, _ = _inputs(seed=3, N=500)
    oj, ot = jo.create_objective(name), to.create_objective(name)
    assert ot.default_metric == oj.default_metric
    base_j, base_t = oj.prob_to_margin(0.3), ot.prob_to_margin(0.3)
    assert np.float32(base_j).tobytes() == np.float32(base_t).tobytes()
    assert np.float32(oj.prob_to_margin(0.5)).tobytes() == \
        np.float32(ot.prob_to_margin(0.5)).tobytes()   # -0.0 both
    np.testing.assert_allclose(
        ot.pred_transform(torch.from_numpy(margin)).numpy(),
        np.asarray(oj.pred_transform(jnp.asarray(margin))),
        rtol=ULP4, atol=0)


def test_label_validation():
    ot = to.create_objective("binary:logistic")
    info = JMeta()
    info.set_field("label", np.array([0.0, 1.0, 2.0], np.float32))
    with pytest.raises(ValueError):
        ot.validate_labels(info)
    to.create_objective("reg:linear").validate_labels(info)


def test_unported_objectives_raise():
    for name in ("rank:pairwise", "rank:ndcg"):
        with pytest.raises(NotImplementedError):
            to.create_objective(name)


@pytest.mark.parametrize("name", ["rmse", "logloss", "error", "auc"])
def test_metrics_within_1e7(name):
    rng = np.random.RandomState(4)
    preds = rng.rand(3000).astype(np.float32)
    preds[:100] = preds[100:200]          # ties for AUC
    labels = (rng.rand(3000) < 0.5).astype(np.float32)
    weights = rng.uniform(0.1, 3.0, 3000).astype(np.float32)
    want = jm.create_metric(name)(preds, labels, weights, None)
    got = tm.create_metric(name)(preds, labels, weights, None)
    assert tm.create_metric(name).metric_name == name
    assert abs(got - want) <= 1e-7


def test_grouped_auc():
    rng = np.random.RandomState(5)
    preds = rng.rand(600)
    labels = (rng.rand(600) < 0.3).astype(np.float32)
    gptr = np.array([0, 100, 350, 600])
    w = np.ones(600, np.float32)
    assert abs(tm.auc(preds, labels, w, gptr)
               - jm.auc(preds, labels, w, gptr)) <= 1e-7


def test_unported_metric_raises():
    with pytest.raises(NotImplementedError):
        tm.create_metric("ndcg@5")
