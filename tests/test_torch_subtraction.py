"""Histogram subtraction in the PyTorch port against the JAX package, on
the CPU: ``_subtracted_level_hist`` on the same inputs (the port of
``tests/test_updaters.py::test_hist_subtraction_env_gate``), the
``XGBTPU_HIST_SUBTRACTION=1`` switch, and the ``hist_subtraction``
parameter, which is ignored with the JAX package's warning.

Tolerances and why:

- fp32 level histograms: within 1e-4 of the JAX function's (that test's
  tolerance; the built child's sums and the sibling's subtraction run in
  the same order in both, so they agree to far less);
- ``hist_precision=fixed``: bitwise (int32 sums, dequantized by a power
  of two);
- training under the switch, 3 rounds: tree structure bitwise with the
  JAX package's under the same switch, eval metrics within 1e-6."""

import contextlib
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch.models import tree as tt  # noqa: E402
from xgboost_tpu_torch.ops import histogram as th  # noqa: E402

STRUCTURE = ("tree_feature", "tree_cut_index", "tree_threshold",
             "tree_default_left", "tree_is_leaf", "tree_group_arr")


def level_inputs(seed=0, N=512, F=4, B=8, n_node=2):
    """Bins, gradients, a parent level's positions and the child level's
    (rows of a leaf parent inactive below it)."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    gh = rng.rand(N, 2).astype(np.float32)
    half = n_node // 2
    parent = rng.randint(-1, half, N).astype(np.int32)
    child = np.where(parent >= 0, 2 * parent + (rng.rand(N) < 0.3), -1)
    split = rng.rand(half) < 0.8
    split[0] = True
    child = np.where((parent >= 0) & split[np.clip(parent, 0, None)],
                     child, -1).astype(np.int32)
    return binned, gh, parent, child, split, B


@pytest.mark.parametrize("precision", ["fp32", "fixed"])
@pytest.mark.parametrize("n_node", [2, 8])
def test_subtracted_level_hist_matches_jax(precision, n_node):
    from xgboost_tpu.models import tree as jt
    from xgboost_tpu.ops.histogram import (build_level_histogram,
                                           dequantize_hist)
    binned, gh, parent, child, split, B = level_inputs(n_node=n_node)
    half = n_node // 2

    class Cfg:
        n_bin = B
        hist_precision = precision

    jb, jg = jax.numpy.asarray(binned), jax.numpy.asarray(gh)
    j_parent = dequantize_hist(build_level_histogram(
        jb, jg, jax.numpy.asarray(parent), half, B, precision))
    want = np.asarray(jt._subtracted_level_hist(
        jb, jg, jax.numpy.asarray(child), n_node, Cfg, lambda x: x,
        j_parent, jax.numpy.asarray(split)))          # (n_node, F, B, 2)
    full = np.asarray(dequantize_hist(build_level_histogram(
        jb, jg, jax.numpy.asarray(child), n_node, B, precision)))

    tb = torch.from_numpy(binned)
    prep = th.prepare_hist(torch.from_numpy(gh), precision)
    t_parent = th.build_level_histogram(tb, prep, torch.from_numpy(parent),
                                        half, B)
    got = tt._subtracted_level_hist(
        tb, prep, torch.from_numpy(child)[None], n_node, B, t_parent,
        torch.from_numpy(split)).permute(3, 0, 1, 2).numpy()
    if precision == "fixed":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, full, atol=1e-4)


def test_parameter_warns_as_the_jax_package_does(monkeypatch):
    """``hist_subtraction=...`` is no parameter in either package: the
    same one-time warning under ``silent=0``, then training as without
    it (only the environment switch turns subtraction on)."""
    from xgboost_tpu.models import gbtree as jg

    from xgboost_tpu_torch.models import gbtree as tg
    monkeypatch.delenv("XGBTPU_HIST_SUBTRACTION", raising=False)
    rng = np.random.RandomState(1)
    X = rng.rand(300, 4).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    texts = []
    for pkg, mod, kw in ((xj, jg, {}), (xt, tg, {"device": "cpu"})):
        mod._WARNED.discard("hist_subtraction")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            bst = pkg.train({"max_depth": 2, "silent": 0,
                             "hist_subtraction": 1},
                            pkg.DMatrix(X, label=y), 2, **kw)
            pkg.train({"max_depth": 2, "silent": 0, "hist_subtraction": 1},
                      pkg.DMatrix(X, label=y), 1, **kw)   # once only
        texts.append([ln for ln in err.getvalue().splitlines()
                      if "hist_subtraction" in ln])
        assert bst.gbtree.cfg.hist_subtraction is False
    assert len(texts[1]) == 1 and texts[0] == texts[1]
    plain = xt.train({"max_depth": 2}, xt.DMatrix(X, label=y), 2,
                     device="cpu").gbtree.get_state()
    with_param = xt.train({"max_depth": 2, "hist_subtraction": 1},
                          xt.DMatrix(X, label=y), 2,
                          device="cpu").gbtree.get_state()
    for k in plain:
        np.testing.assert_array_equal(plain[k], with_param[k], err_msg=k)


@pytest.mark.parametrize("params", [
    {"objective": "reg:linear"},
    {"objective": "binary:logistic"},
    {"objective": "reg:linear", "num_parallel_tree": 2},
    {"objective": "binary:logistic", "hist_precision": "fixed"}],
    ids=["linear", "logistic", "forest", "fixed"])
def test_env_gate_trains_as_the_jax_package(monkeypatch, params):
    """Under ``XGBTPU_HIST_SUBTRACTION=1`` both packages grow the same
    trees; a forest's trees build their small children together (K4's
    plain version here)."""
    monkeypatch.setenv("XGBTPU_HIST_SUBTRACTION", "1")
    rng = np.random.RandomState(0)
    X = rng.rand(2000, 6).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(2000) > 0.6).astype(np.float32)
    p = {"max_depth": 4, "eta": 0.3, "hist_precision": "fp32", **params}
    out = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y)
        res = {}
        bst = pkg.train(p, d, 3, evals=[(d, "train")], evals_result=res,
                        verbose_eval=False, **kw)
        assert bst.gbtree.cfg.hist_subtraction is True
        out[name] = (bst.gbtree.get_state(), res)
    sj, st = out["j"][0], out["t"][0]
    for k in STRUCTURE:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    rj, rt = out["j"][1], out["t"][1]
    assert list(rj) == list(rt)
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-6)
