"""Row and column sampling in the PyTorch port against the JAX package,
on the CPU at fp32: ``subsample``, ``colsample_bytree`` and
``colsample_bylevel`` below 1, each alone and together.

Tolerances and why:

- ``grow_tree`` / ``grow_trees`` on the same numpy bins and gradients
  (reg:linear's (g, 1)): trees, each row's leaf and leaf value bitwise.
  The keys, the row and feature draws (``xgboost_tpu_torch.random``,
  pinned bitwise by ``tests/test_torch_random.py``), the histograms and
  the split search are all bitwise;
- ``train`` with binary:logistic: eval lines and ``evals_result`` equal,
  margins within rtol 1e-5 (XLA's ``exp`` against torch's, a few ulp,
  as ``tests/test_torch_train.py`` holds them); reg:linear forests and
  a 3-class softprob: tree structure bitwise;
- sampled lanes stacked against the host loop, and a segment against
  per-round training: identical model bytes (the same keys and the same
  operations on each lane's rows)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch import random as prng  # noqa: E402
from xgboost_tpu_torch.models import tree as tt  # noqa: E402
from xgboost_tpu_torch.ops.split import SplitConfig  # noqa: E402

SAMPLINGS = {
    "rows": {"subsample": 0.6},
    "tree_cols": {"colsample_bytree": 0.5},
    "level_cols": {"colsample_bylevel": 0.4},
    "all": {"subsample": 0.8, "colsample_bytree": 0.7,
            "colsample_bylevel": 0.6},
}
STRUCTURE = ("tree_feature", "tree_cut_index", "tree_threshold",
             "tree_default_left", "tree_is_leaf", "tree_group_arr",
             "cut_values", "cut_n")


def grow_inputs(seed=0, N=1500, F=9, B=16, D=3):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    C = B - 2
    n_cuts = rng.randint(C // 2, C + 1, F).astype(np.int32)
    cut_values = np.sort(rng.randn(F, C).astype(np.float32), axis=1)
    gh = np.stack([rng.randn(N).astype(np.float32),
                   np.ones(N, np.float32)], axis=1)
    return binned, gh, cut_values, n_cuts, B, D


def jax_tree(cfg_kw, key, binned, gh, cut_values, n_cuts, B, D):
    from xgboost_tpu.models.tree import GrowConfig, grow_tree
    from xgboost_tpu.ops.split import SplitConfig as JSplit
    cfg = GrowConfig(split=JSplit(min_child_weight=0.5, eta=0.3),
                     max_depth=D, n_bin=B, hist_precision="fp32", **cfg_kw)
    tree, row_leaf, row_val = grow_tree(key, binned, gh, cut_values,
                                        n_cuts, cfg)
    return ({f: np.asarray(v) for f, v in tree._asdict().items()},
            np.asarray(row_leaf), np.asarray(row_val))


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_grow_trees_match_jax_grow_tree(name):
    """T = 3 trees of one round grown together, tree t on its key
    ``fold_in(round_key, t)`` and its own gradients, each bitwise equal
    to the JAX package's ``grow_tree`` on that key; the one-tree
    ``grow_tree`` equals tree 0."""
    binned, gh, cut_values, n_cuts, B, D = grow_inputs()
    kw = SAMPLINGS[name]
    cfg = tt.GrowConfig(SplitConfig(min_child_weight=0.5, eta=0.3), D, B,
                        "fp32", **kw)
    rng = np.random.RandomState(1)
    ghs = np.stack([gh, gh * rng.rand(*gh.shape).astype(np.float32),
                    gh[::-1].copy()])
    round_j = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    round_t = prng.fold_in(prng.PRNGKey(5), 2)
    keys = np.stack([prng.fold_in(round_t, t) for t in range(3)])
    args = (torch.from_numpy(binned), torch.from_numpy(ghs),
            torch.from_numpy(cut_values), torch.from_numpy(n_cuts), cfg)
    stack, row_leaf, row_val = tt.grow_trees(*args, keys=keys)
    for t in range(3):
        want, leaf, val = jax_tree(kw, jax.random.fold_in(round_j, t),
                                   binned, ghs[t], cut_values, n_cuts, B, D)
        for f, v in want.items():
            np.testing.assert_array_equal(getattr(stack, f)[t].numpy(), v,
                                          err_msg=f"{name} tree {t} {f}")
        np.testing.assert_array_equal(row_leaf[t].numpy(), leaf)
        np.testing.assert_array_equal(row_val[t].numpy(), val)
    solo = tt.grow_tree(args[0], args[1][0], *args[2:], key=keys[0])
    for f in tt.TreeArrays._fields:
        assert torch.equal(getattr(solo[0], f), getattr(stack, f)[0]), f
    # a sampled config draws: it needs the keys
    with pytest.raises(ValueError, match="key"):
        tt.grow_trees(*args)


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.8])
def test_feature_masks_match_jax_sample_features(rate):
    """``sample_features`` on a stack of keys against the JAX package's
    ``_sample_features`` key by key, at rates where many masks come out
    empty and take the ``randint`` fallback feature."""
    from xgboost_tpu.models.tree import _sample_features
    keys_t = np.stack([prng.fold_in(prng.PRNGKey(9), i) for i in range(40)])
    got = tt.sample_features(keys_t.reshape(8, 5, 2), 5, rate)
    n_fallback = 0
    for i in range(40):
        kj = jax.random.fold_in(jax.random.PRNGKey(9), i)
        want = np.asarray(_sample_features(kj, 5, rate))
        np.testing.assert_array_equal(got.reshape(40, 5)[i], want)
        n_fallback += int(not (np.asarray(jax.random.uniform(kj, (5,)))
                               < rate).any())
    assert rate > 0.1 or n_fallback > 10


def _data(seed, n=2000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n, f) < 0.1] = np.nan
    Z = np.nan_to_num(X)
    y_reg = (2 * Z[:, 0] + Z[:, 1] ** 2 - Z[:, 2] * Z[:, 3]
             + 0.1 * rng.randn(n)).astype(np.float32)
    y_bin = (Z[:, 0] + Z[:, 1] * Z[:, 2] > 0.3).astype(np.float32)
    y_cls = (np.digitize(Z[:, 0] + 0.5 * Z[:, 4], [-0.5, 0.5])
             ).astype(np.float32)
    return X, y_reg, y_bin, y_cls


def both(params, label, rounds=4, evals=True):
    """Both packages trained on one dataset: (state, evals_result,
    holdout margins) per package."""
    X, *ys = _data(0)
    Xt, *yts = _data(1)
    col = {"reg": 0, "bin": 1, "cls": 2}[label]
    out = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        dtr = pkg.DMatrix(X, label=ys[col])
        dte = pkg.DMatrix(Xt, label=yts[col])
        res = {}
        bst = pkg.train(params, dtr, rounds,
                        evals=[(dtr, "train"), (dte, "test")] if evals
                        else (), evals_result=res, verbose_eval=False, **kw)
        out[name] = (bst.gbtree.get_state(), res,
                     bst.predict(pkg.DMatrix(Xt), output_margin=True))
    return out


BASE = {"max_depth": 3, "eta": 0.3, "max_bin": 32, "hist_precision": "fp32",
        "seed": 11}


def assert_structure(out):
    sj, st = out["j"][0], out["t"][0]
    for k in STRUCTURE:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)


def test_train_binary_logistic_sampled():
    out = both({**BASE, "objective": "binary:logistic",
                **SAMPLINGS["all"]}, "bin")
    assert out["j"][1] == out["t"][1]
    np.testing.assert_allclose(out["t"][2], out["j"][2], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("evals", [True, False], ids=["per_round",
                                                      "segment"])
def test_forest_sampled_structure_bitwise(evals):
    """A random forest (num_parallel_tree 3) with row and column
    sampling, per round and as one segment (the JAX package's fused
    scan): each tree its own key.  Per round the leaf values are bitwise
    too; the JAX package's fused scan differs from its own per-round
    path by an ulp in the margins it carries (1.8e-7 in the leaf values
    here), so there they are held at rtol 1e-5."""
    out = both({**BASE, "objective": "reg:linear", "num_parallel_tree": 3,
                **SAMPLINGS["all"]}, "reg", rounds=3, evals=evals)
    assert_structure(out)
    leaf_t = out["t"][0]["tree_leaf_value"]
    leaf_j = np.asarray(out["j"][0]["tree_leaf_value"])
    if evals:
        np.testing.assert_array_equal(leaf_t, leaf_j)
    else:
        np.testing.assert_allclose(leaf_t, leaf_j, rtol=1e-5, atol=1e-6)


def test_softprob_sampled_structure():
    out = both({**BASE, "objective": "multi:softprob", "num_class": 3,
                "subsample": 0.7, "colsample_bytree": 0.6}, "cls",
               rounds=3)
    assert_structure(out)
    np.testing.assert_allclose(out["t"][0]["tree_leaf_value"],
                               np.asarray(out["j"][0]["tree_leaf_value"]),
                               rtol=1e-5, atol=1e-6)
    assert list(out["t"][1]) == list(out["j"][1])


def test_segment_equals_per_round_training():
    X, y, _, _ = _data(2)
    params = {**BASE, "objective": "reg:linear", **SAMPLINGS["all"]}
    raws = []
    for k in (0, 3):
        d = xt.DMatrix(X, label=y)
        bst = xt.Booster(params, cache=[d], device="cpu")
        plans = []
        bst.update_many(d, 0, 5, rounds_per_dispatch=k,
                        plan_callback=plans.append)
        assert plans == [k]
        raws.append(bst.save_raw())
    assert raws[0] == raws[1]
    # a continuation picks up the absolute round: 2 + 3 == 5 rounds
    d = xt.DMatrix(X, label=y)
    first = xt.train(params, d, 2, device="cpu")
    cont = xt.train(params, d, 3, xgb_model=first, device="cpu")
    assert cont.save_raw() == raws[0]


def test_sampled_lanes_stacked_equal_host_loop(tmp_path):
    """Sampled tenants (equal row counts: the row draw is N-shaped) stack
    into one bucket and give the host loop's bytes; each lane samples
    with its own PRNGKey(seed)."""
    from xgboost_tpu_torch.obs import lane_metrics
    from xgboost_tpu_torch.pipeline import (SyntheticDataSource,
                                            run_tenant_lanes)
    params = {"objective": "reg:linear", "max_depth": 2, "eta": 0.3,
              "silent": 1, "subsample": 0.8, "colsample_bytree": 0.75}

    def lanes(mode):
        out = {}
        for i in range(3):
            d = tmp_path / mode / f"t{i}"
            out[f"t{i}"] = {
                "publish_path": str(d / "model.bin"),
                "workdir": str(d / "work"),
                "source": SyntheticDataSource(n_rows=64, n_features=4,
                                              seed=200 + i),
                "rounds_per_cycle": 2, "cycles": 2,
                "params": dict(params, seed=i)}
        return out
    before = lane_metrics().dispatches.value
    stacked = lanes("stacked")
    res = run_tenant_lanes(stacked, quiet=True, stacked=True,
                           window_sec=2.0, device="cpu")
    assert all(r["status"] == "ok" for r in res.values()), res
    assert lane_metrics().dispatches.value - before == 2
    host = lanes("host")
    res = run_tenant_lanes(host, quiet=True, stacked=False, device="cpu")
    assert all(r["status"] == "ok" for r in res.values()), res
    blobs = set()
    for name in stacked:
        with open(stacked[name]["publish_path"], "rb") as f:
            a = f.read()
        with open(host[name]["publish_path"], "rb") as f:
            assert a == f.read(), name
        blobs.add(a)
    assert len(blobs) == 3
