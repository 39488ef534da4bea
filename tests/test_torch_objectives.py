"""Objectives and metrics of the PyTorch port against the JAX package.

Gradients and transforms are bitwise: ``reg:linear`` is exact arithmetic
on both sides, and the logistic losses' ``exp`` is, on the CPU, XLA's
CPU ``exp`` bit for bit (``objectives.exp``; its sweep is
``test_exp_equals_xla_cpu_exp_bitwise``).  Metrics are host float64
numpy on both sides; they are held within 1e-7.
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
from xgboost_tpu_torch.data import MetaInfo as TMeta  # noqa: E402



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
    tinfo = TMeta()
    tinfo.set_field("label", label)
    tinfo.set_field("weight", weight)
    got = ot.get_gradient(torch.from_numpy(margin), tinfo, 0).numpy()
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
    np.testing.assert_array_equal(got, want)


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
    np.testing.assert_array_equal(
        ot.pred_transform(torch.from_numpy(margin)).numpy(),
        np.asarray(oj.pred_transform(jnp.asarray(margin))))


def test_label_validation():
    ot = to.create_objective("binary:logistic")
    info = JMeta()
    info.set_field("label", np.array([0.0, 1.0, 2.0], np.float32))
    with pytest.raises(ValueError):
        ot.validate_labels(info)
    to.create_objective("reg:linear").validate_labels(info)


@pytest.mark.parametrize("name", ["rank:pairwise", "rank:ndcg", "rank:map"])
def test_rank_objectives_match_the_jax_package(name):
    """The LambdaRank objectives: default metric, base margin and
    transforms as the JAX package's, and the host path's gradients (the
    same numpy code on the same RandomState) bitwise."""
    oj, ot = jo.create_objective(name), to.create_objective(name)
    assert ot.default_metric == oj.default_metric
    assert ot.prob_to_margin(0.3) == oj.prob_to_margin(0.3)
    rng = np.random.RandomState(9)
    margin = rng.randn(300, 1).astype(np.float32)
    label = rng.randint(0, 3, 300).astype(np.float32)
    np.testing.assert_array_equal(
        ot.pred_transform(torch.from_numpy(margin)).numpy(),
        np.asarray(oj.pred_transform(jnp.asarray(margin))))
    infos = []
    for o, meta in ((oj, JMeta()), (ot, TMeta())):
        o.set_param("rank_impl", "host")
        o.set_param("num_pairsample", 2)
        meta.set_field("label", label)
        meta.set_field("group", [100, 120, 80])
        infos.append(meta)
    want = np.asarray(oj.get_gradient(jnp.asarray(margin), infos[0], 4, 300))
    got = ot.get_gradient(torch.from_numpy(margin), infos[1], 4).numpy()
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("name", ["ndcg@5", "map@5-", "pre@5"])
def test_grouped_ranking_metrics_bitwise(name):
    """The ranklist metrics over groups, on float32 predictions of a
    trained model's size, equal to the JAX package's to the bit."""
    rng = np.random.RandomState(6)
    preds = rng.randn(600).astype(np.float32)
    labels = rng.randint(0, 3, 600).astype(np.float32)
    labels[:50] = 0                       # a group without relevant rows
    gptr = np.array([0, 50, 170, 350, 600])
    w = np.ones(600, np.float32)
    want = jm.create_metric(name)(preds, labels, w, gptr)
    got = tm.create_metric(name)(preds, labels, w, gptr)
    assert np.float64(got).tobytes() == np.float64(want).tobytes()


def test_exp_equals_xla_cpu_exp_bitwise():
    """The port's CPU ``exp`` against ``jax.jit(jnp.exp)`` bit for bit on
    2^24 inputs spread over [-104, 89] and on the edges: +-0, subnormal
    inputs, results under 2^-126 (flushed to 0 by XLA), overflow, +-inf
    and NaN."""
    f = jax.jit(jnp.exp)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, -2.98e-8,
                      2.0 ** -25, -2.0 ** -25, -87.33654, -87.33655,
                      -87.8, -87.9, -95.0, -103.9, 88.72283, 88.72284,
                      88.8, 89.0, 3.4e38, -3.4e38, np.inf, -np.inf,
                      np.nan], np.float32)
    grid = np.linspace(-104, 89, 1 << 24, dtype=np.float32)
    for x in (edges, *np.split(grid, 8)):
        want = np.asarray(f(x))
        got = to.exp(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    assert to.exp(torch.tensor([-2.98e-8])).item() == 1.0
