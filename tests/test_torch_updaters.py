"""The port's other updaters against the JAX package, on the CPU: exact
``grow_colmaker`` (``models/colmaker.py``), ``grow_skmaker``
(``models/skmaker.py``), ``refresh`` (``models/updaters.py``) and
``sync``, on the same numpy inputs (a few hundred to 2,000 rows, 4-8
features, depth 2-4, every input from a seed).

Tolerances and why:

- exact trees bitwise, every field: the exact grower's sums follow the
  JAX package's CPU order (its unstable sort's tie order, XLA's
  reductions and block products, its fused multiply-adds), so near-ties
  fall the same way and gains come out the same bits (F7, ROADMAP.md
  section 3);
- elsewhere tree structure (feature, is_leaf, default_left) equal and
  thresholds bitwise; gains, leaf values, hessian sums and margins within
  rtol 1e-5 / atol 1e-6, the bar of ``tests/test_torch_train.py``;
- eval lines and dumps without stats byte-equal; ``_compress_row`` and
  ``build_exact_ranks`` bitwise; ``_blocked_cumsum`` within
  ``2 n 2^-24 sum|x|`` of an f64 prefix sum, and bitwise against the
  JAX package's CPU run;
- model files saved by either package predict the same margins in the
  other (``np.array_equal``) and the same ``pred_leaf``.
"""

import contextlib
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu.models import colmaker as jcm  # noqa: E402
from xgboost_tpu.models import skmaker as jsk  # noqa: E402
from xgboost_tpu.models import tree as jtree  # noqa: E402
from xgboost_tpu.models import updaters as jup  # noqa: E402
from xgboost_tpu.ops import split as jsplit  # noqa: E402
from xgboost_tpu_torch import random as prng  # noqa: E402
from xgboost_tpu_torch.models import colmaker as tcm  # noqa: E402
from xgboost_tpu_torch.models import skmaker as tsk  # noqa: E402
from xgboost_tpu_torch.models import tree as ttree  # noqa: E402
from xgboost_tpu_torch.models import updaters as tup  # noqa: E402
from xgboost_tpu_torch.ops import split as tsplit  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
STRUCT = ("feature", "is_leaf", "default_left", "threshold", "cut_index")
VALUES = ("leaf_value", "gain", "sum_hess")


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_trees_match(tj, tt, tag=""):
    """Structure and thresholds bitwise, values within the tolerance."""
    for f in STRUCT:
        np.testing.assert_array_equal(_arr(getattr(tt, f)),
                                      _arr(getattr(tj, f)),
                                      err_msg=f"{tag} {f}")
    for f in VALUES:
        np.testing.assert_allclose(_arr(getattr(tt, f)),
                                   _arr(getattr(tj, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag} {f}")


def assert_states_match(sj, st):
    for f in STRUCT:
        np.testing.assert_array_equal(st["tree_" + f],
                                      np.asarray(sj["tree_" + f]),
                                      err_msg=f)
    for f in VALUES:
        np.testing.assert_allclose(st["tree_" + f],
                                   np.asarray(sj["tree_" + f]), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(st["tree_group_arr"],
                                  np.asarray(sj["tree_group_arr"]))


def _matrix(seed, n=2000, f=6, kind="nan"):
    """Synthetic features: ``dense`` randn with ties (a rounded column),
    ``nan`` 10% missing, ``onehot`` presence-only columns (1.0 or
    missing) beside two continuous ones."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    if kind == "onehot":
        X[:, 2:] = np.where(rng.rand(n, f - 2) < 0.4, 1.0, np.nan)
    else:
        X[:, f - 1] = np.round(X[:, f - 1] * 2) / 2
        if kind == "nan":
            X[rng.rand(n, f) < 0.1] = np.nan
    return X


def _grad(seed, n):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randn(n), rng.rand(n) + 0.05],
                    axis=1).astype(np.float32)


# ------------------------------------------------------------ exact grower
def test_build_exact_ranks_bitwise():
    X = _matrix(1, 500, 5, "nan")
    X[:7, 0] = -0.0
    X[7:14, 0] = 0.0
    rj, uj = jcm.build_exact_ranks(X)
    rt, ut = tcm.build_exact_ranks(X)
    assert rt.dtype == np.int32 and ut.dtype == np.float32
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ut.view(np.int32), uj.view(np.int32))


@pytest.mark.parametrize("n", [300, 2000, 4096, 20000])
def test_blocked_cumsum_bound_and_bits(n):
    """Within 2 n 2^-24 sum|x| of the f64 prefix sum, and the JAX
    package's CPU bits (one block, 2-32 blocks and more than 32)."""
    x = np.random.RandomState(n).randn(3, n).astype(np.float32)
    got = tcm._blocked_cumsum(torch.from_numpy(x)).numpy()
    ref = np.cumsum(x.astype(np.float64), axis=1)
    bound = 2 * n * 2.0 ** -24 * np.abs(x).sum(axis=1, keepdims=True)
    assert np.all(np.abs(got - ref) <= bound)
    np.testing.assert_array_equal(got, np.asarray(
        jcm._blocked_cumsum(jnp.asarray(x))))


def test_cpu_sort_order_is_xla_unstable_sort():
    """The tie order of ``lax.sort(is_stable=False)`` on the CPU, on
    random keys with many ties and on inputs that reach the heap sort."""
    from xgboost_tpu_torch.ops.cpu_sort import unstable_sort_order
    rng = np.random.RandomState(0)
    n = 3000
    ar = np.arange(n)
    killer = np.zeros(n, np.int64)
    k = n // 2
    for i in range(1, k + 1):
        if i % 2:
            killer[i - 1], killer[i] = i, k + i
        killer[k + i - 1] = 2 * i
    cases = [rng.randint(0, 7, n), rng.randint(0, 1000, n),
             np.concatenate([ar[:k], ar[:k][::-1]]), killer, ar % 2]
    for keys in cases:
        pay = np.arange(n, dtype=np.float32)
        _, ps = jax.lax.sort((jnp.asarray(keys.astype(np.int32)),
                              jnp.asarray(pay)), num_keys=1,
                             is_stable=False)
        np.testing.assert_array_equal(
            unstable_sort_order(keys.astype(np.int64)),
            np.asarray(ps).astype(np.int64))


EXACT_CASES = {
    "dense": dict(kind="dense"),
    "nan": dict(kind="nan"),
    "onehot": dict(kind="onehot"),
    "left": dict(kind="nan", default_direction=1),
    "right": dict(kind="nan", default_direction=2),
    "sampled": dict(kind="nan", subsample=0.7, colsample_bylevel=0.6),
}


def _exact_configs(case):
    c = dict(EXACT_CASES[case])
    kind = c.pop("kind")
    dd = c.pop("default_direction", 0)
    kw = dict(max_depth=4, n_bin=3, **c)
    js = jsplit.SplitConfig(min_child_weight=1.0, eta=0.3,
                            default_direction=dd)
    ts = tsplit.SplitConfig(min_child_weight=1.0, eta=0.3,
                            default_direction=dd)
    return kind, jtree.GrowConfig(split=js, **kw), ttree.GrowConfig(
        split=ts, **kw)


@pytest.mark.parametrize("ranked", [True, False], ids=["ranked", "two_key"])
@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_grow_tree_exact_matches_jax(case, ranked):
    kind, jcfg, tcfg = _exact_configs(case)
    X = _matrix(11, 1500, 6, kind)
    gh = _grad(12, len(X))
    has_missing = bool(np.isnan(X).any())
    key = prng.fold_in(prng.PRNGKey(5), 3)
    rk = uq = None
    if ranked:
        rk, uq = tcm.build_exact_ranks(X)
    tj, lj = jcm.grow_tree_exact(
        jnp.asarray(key), jnp.asarray(X), jnp.asarray(gh), jcfg,
        has_missing=has_missing,
        rank_t=None if rk is None else jnp.asarray(rk),
        uniq=None if uq is None else jnp.asarray(uq))
    tt, lt = tcm.grow_tree_exact(
        torch.from_numpy(X), torch.from_numpy(gh), tcfg,
        has_missing=has_missing,
        rank_t=None if rk is None else torch.from_numpy(rk),
        uniq=None if uq is None else torch.from_numpy(uq), key=key)
    for f in tt._fields:
        np.testing.assert_array_equal(_arr(getattr(tt, f)),
                                      _arr(getattr(tj, f)), f"{case} {f}")
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int((tt.feature >= 0).sum()) >= 3     # the fixture splits


def test_ranked_and_two_key_forms_agree():
    """The packed-key and the two-key sorts grow the same trees, down to
    the last bit of every split (a leaf's threshold holds a rejected
    candidate of its form)."""
    _, _, tcfg = _exact_configs("nan")
    X = _matrix(21, 2000, 6, "nan")
    gh = torch.from_numpy(_grad(22, len(X)))
    rk, uq = tcm.build_exact_ranks(X)
    a, la = tcm.grow_tree_exact(torch.from_numpy(X), gh, tcfg,
                                rank_t=torch.from_numpy(rk),
                                uniq=torch.from_numpy(uq))
    b, lb = tcm.grow_tree_exact(torch.from_numpy(X), gh, tcfg)
    split = a.feature >= 0
    assert torch.equal(a.feature, b.feature)
    assert torch.equal(a.is_leaf, b.is_leaf)
    assert torch.equal(la, lb)
    for f in ("threshold", "default_left", "gain", "leaf_value"):
        assert torch.equal(getattr(a, f)[split], getattr(b, f)[split]), f
    assert torch.equal(a.leaf_value, b.leaf_value)


def test_exact_finder_never_builds_an_f_n_m_tensor():
    """The per-slot lookups are gathers from (F, n_node + 1) tables: no
    tensor of the grower holds F * N * 4 elements or more (a depth-4
    tree has levels of 4 and 8 nodes)."""
    from torch.overrides import TorchFunctionMode
    _, _, tcfg = _exact_configs("nan")
    F, N = 4, 600
    X = _matrix(3, N, F, "nan")
    big = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, tuple) else (out,)):
                if isinstance(t, torch.Tensor) and t.numel() >= F * N * 4:
                    big.append((str(func), tuple(t.shape)))
            return out
    with Watch():
        tree, _ = tcm.grow_tree_exact(torch.from_numpy(X), torch.from_numpy(
            _grad(4, N)), tcfg)
    assert int((tree.feature[7:15] >= 0).sum()) > 0    # depth 3 splits
    assert not big, big[:5]


# ------------------------------------------------------ exact end to end
def _capture(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn()
    return res, out.getvalue()


def _train_both(params, X, y, Xt, yt, rounds=3):
    """Both packages trained on one matrix with eval lines on a train and
    a test set; returns {pkg: (booster, printed lines)}."""
    out = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        dtr, dte = pkg.DMatrix(X, label=y), pkg.DMatrix(Xt, label=yt)
        out[name] = _capture(lambda: pkg.train(
            params, dtr, rounds, evals=[(dtr, "train"), (dte, "test")],
            **kw))
    return out


@pytest.fixture(scope="module", params=["binary:logistic", "multi:softmax"])
def exact_run(request):
    obj = request.param
    X, Xt = _matrix(31, 2000, 6, "nan"), _matrix(32, 700, 6, "nan")
    Z, Zt = np.nan_to_num(X), np.nan_to_num(Xt)
    if obj == "multi:softmax":
        y = Z[:, :3].argmax(1).astype(np.float32)
        yt = Zt[:, :3].argmax(1).astype(np.float32)
        params = {"objective": obj, "num_class": 3}
    else:
        y = (Z[:, 0] + Z[:, 1] * Z[:, 2] > 0.3).astype(np.float32)
        yt = (Zt[:, 0] + Zt[:, 1] * Zt[:, 2] > 0.3).astype(np.float32)
        params = {"objective": obj}
    params.update(updater="grow_colmaker,prune", gamma=0.5, max_depth=3,
                  eta=0.3, silent=1)
    runs = _train_both(params, X, y, Xt, yt)
    return dict(runs=runs, X=X, Xt=Xt, params=params)


def test_exact_training_trees(exact_run):
    (bj, _), (bt, _) = exact_run["runs"]["j"], exact_run["runs"]["t"]
    assert bt.gbtree.exact_raw and bj.gbtree.exact_raw
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    assert set(sj) == set(st)
    for k in st:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), k)
    assert st["cut_values"].shape == (6, 1) and np.isinf(
        st["cut_values"]).all() and not st["cut_n"].any()


def test_exact_training_eval_lines_byte_equal(exact_run):
    (_, lj), (_, lt) = exact_run["runs"]["j"], exact_run["runs"]["t"]
    assert lt == lj and lt.count("\n") == 3


def test_exact_training_predictions(exact_run):
    (bj, _), (bt, _) = exact_run["runs"]["j"], exact_run["runs"]["t"]
    Xt = exact_run["Xt"]
    for kw in ({"output_margin": True}, {}):
        np.testing.assert_allclose(bt.predict(xt.DMatrix(Xt), **kw),
                                   bj.predict(xj.DMatrix(Xt), **kw),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        bt.predict(xt.DMatrix(Xt), pred_leaf=True),
        bj.predict(xj.DMatrix(Xt), pred_leaf=True))
    # a plain array predicts through the raw path too
    np.testing.assert_array_equal(bt.predict(Xt, output_margin=True),
                                  bt.predict(xt.DMatrix(Xt),
                                             output_margin=True))


def test_exact_dumps_byte_equal(exact_run):
    (bj, _), (bt, _) = exact_run["runs"]["j"], exact_run["runs"]["t"]
    assert bt.get_dump() == bj.get_dump()
    sj, st = bj.get_dump(with_stats=True), bt.get_dump(with_stats=True)
    assert len(sj) == len(st)
    for a, b in zip(sj, st):     # gain and cover within the tolerance
        for la, lb in zip(a.splitlines(), b.splitlines()):
            ha, _, ra = la.partition(",gain=")
            hb, _, rb = lb.partition(",gain=")
            assert ha == hb
            if ra:
                va = [float(v.split("=")[-1]) for v in ra.split(",")]
                vb = [float(v.split("=")[-1]) for v in rb.split(",")]
                np.testing.assert_allclose(vb, va, rtol=RTOL, atol=1e-4)


def test_exact_model_files_cross_load(exact_run, tmp_path):
    (bj, _), (bt, _) = exact_run["runs"]["j"], exact_run["runs"]["t"]
    Xt = exact_run["Xt"]
    pj, pt = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    bj.save_model(pj)
    bt.save_model(pt)
    for path, src in ((pj, bj), (pt, bt)):
        tj = xj.Booster(model_file=path)
        tt = xt.Booster(model_file=path, device="cpu")
        assert tt.gbtree.exact_raw
        mj = tj.predict(xj.DMatrix(Xt), output_margin=True)
        mt = tt.predict(xt.DMatrix(Xt), output_margin=True)
        assert np.array_equal(mt, mj), path
        np.testing.assert_array_equal(
            tt.predict(xt.DMatrix(Xt), pred_leaf=True),
            tj.predict(xj.DMatrix(Xt), pred_leaf=True))
        assert tt.get_dump() == tj.get_dump()


def test_exact_cli_train_pred_dump_byte_equal(tmp_path):
    """``task=train``, ``task=pred pred_margin=1`` and ``task=dump``
    with ``updater=grow_colmaker`` in both CLIs: the same dump and
    prediction bytes from each package's model, and each CLI reading the
    other's model file."""
    from test_torch_cli import run_cli, write_conf, write_libsvm
    from xgboost_tpu.cli import main as jax_main
    from xgboost_tpu_torch.cli import main as port_main
    X = _matrix(41, 400, 6, "nan")
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    write_libsvm(tmp_path / "train.libsvm", X, y)
    outs = {}
    for name, main, extra in (("j", jax_main, []),
                              ("t", port_main, ["device=cpu"])):
        d = tmp_path / name
        d.mkdir()
        conf = write_conf(d / "run.conf", data=str(tmp_path / "train.libsvm"),
                          objective="binary:logistic",
                          updater="grow_colmaker", max_depth=3,
                          num_round=2, model_out="m.model", silent=1)
        assert run_cli(main, [conf] + extra, d)[0] == 0
        for task, tail in (("dump", ["name_dump=dump.txt"]),
                           ("pred", ["test:data=" + str(
                               tmp_path / "train.libsvm"),
                               "pred_margin=1", "name_pred=pred.txt"])):
            assert run_cli(main, [conf, f"task={task}", "model_in=m.model"]
                           + tail + extra, d)[0] == 0
        outs[name] = {f: (d / f).read_bytes()
                      for f in ("dump.txt", "pred.txt")}
    assert outs["t"]["dump.txt"] == outs["j"]["dump.txt"]
    assert outs["t"]["pred.txt"] == outs["j"]["pred.txt"]


@pytest.mark.parametrize("updater", ["grow_colmaker", "grow_skmaker",
                                     "grow_histmaker,refresh"])
def test_cv_and_boost_take_the_updaters(updater):
    """``cv`` prints the JAX package's lines, and ``boost`` with given
    gradients grows its trees, under each of the other updaters."""
    X, _, y = _class_data(71, 600)
    params = {"objective": "binary:logistic", "updater": updater,
              "max_depth": 3, "eta": 0.3, "max_bin": 16,
              "hist_precision": "fp32", "eval_metric": "auc", "silent": 1}
    lines = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        lines[name] = _capture(lambda: pkg.cv(
            params, pkg.DMatrix(X, label=y), 2, nfold=3, **kw))
    assert lines["t"] == lines["j"]
    g = np.random.RandomState(72).randn(len(X)).astype(np.float32)
    h = np.full(len(X), 0.25, np.float32)
    states = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        d = pkg.DMatrix(X, label=y)
        b = pkg.train(params, d, 1, verbose_eval=False, **kw)
        b.boost(d, g, h)
        states[name] = b.gbtree.get_state()
    assert_states_match(states["j"], states["t"])


# ------------------------------------------------------------- skmaker
def test_compress_row_bitwise():
    rng = np.random.RandomState(2)
    mass = np.abs(rng.randn(7, 5, 40)).astype(np.float32)
    mass[rng.rand(7, 5, 40) < 0.4] = 0.0
    mass[0, 0] = 0.0                          # an empty row
    mass[1, 1, :] = 0.0
    mass[1, 1, 3] = 2.5                       # a single present bin
    for K in (4, 8, 17, 40):
        jf = jax.vmap(jax.vmap(lambda r: jsk._compress_row(r, K)))
        sj = [np.asarray(a) for a in jf(jnp.asarray(mass))]
        st = [a.numpy() for a in tsk._compress_row(torch.from_numpy(mass), K)]
        for a, b in zip(st, sj):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_skmaker_finder_on_a_random_histogram():
    rng = np.random.RandomState(5)
    M, F, B, K = 4, 5, 18, 8
    hist = np.zeros((M, F, B, 2), np.float32)
    hist[..., 0] = rng.randn(M, F, B) * (rng.rand(M, F, B) < 0.7)
    hist[..., 1] = np.abs(rng.randn(M, F, B)) * (hist[..., 0] != 0)
    nst = hist[:, 0].sum(axis=1)
    n_cuts = rng.randint(4, B - 2, F).astype(np.int32)
    cuts = np.sort(rng.randn(F, B - 2).astype(np.float32), axis=1)
    fmask = np.array([True, True, False, True, True])
    for dd in (0, 1, 2):
        js = jsplit.SplitConfig(min_child_weight=0.5, default_direction=dd)
        ts = tsplit.SplitConfig(min_child_weight=0.5, default_direction=dd)
        dj = jsk.skmaker_split_finder(K)(
            jnp.asarray(hist), jnp.asarray(nst), jnp.asarray(n_cuts),
            jnp.asarray(cuts), jnp.asarray(fmask), js)
        bt = tsk.skmaker_split_finder(K)(
            torch.from_numpy(hist).permute(1, 2, 3, 0).contiguous(),
            torch.from_numpy(nst), torch.from_numpy(n_cuts), ts,
            torch.from_numpy(fmask))
        assert bt.left_g is None
        for f in ("gain", "feature", "cut_index", "default_left", "valid"):
            np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                          np.asarray(getattr(dj, f)), f)
        thr = torch.from_numpy(cuts)[bt.feature.long(), ttree._cut_col(
            bt, cuts.shape[1])]
        np.testing.assert_array_equal(thr.numpy(), np.asarray(dj.threshold))
    assert tsk.skmaker_split_finder(K) is tsk.skmaker_split_finder(K)


def _class_data(seed, n=2000):
    X = _matrix(seed, n, 6, "nan")
    Z = np.nan_to_num(X)
    return X, Z[:, :3].argmax(1).astype(np.float32), (
        Z[:, 0] + Z[:, 1] * Z[:, 2] > 0.3).astype(np.float32)


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softprob"])
def test_skmaker_training_matches_jax(objective):
    X, yc, yb = _class_data(51)
    Xt, ytc, ytb = _class_data(52, 600)
    params = {"objective": objective, "updater": "grow_skmaker",
              "max_depth": 3, "eta": 0.3, "max_bin": 32,
              "hist_precision": "fp32", "sketch_eps": 0.2, "silent": 1}
    y, yt = yb, ytb
    if objective.startswith("multi"):
        params["num_class"] = 3
        y, yt = yc, ytc
    runs = _train_both(params, X, y, Xt, yt)
    (bj, lj), (bt, lt) = runs["j"], runs["t"]
    assert bt.gbtree.split_finder() is tsk.skmaker_split_finder(
        tsk.sketch_size(2.0, 0.2, bt.gbtree.cfg.n_bin))
    assert_states_match(bj.gbtree.get_state(), bt.gbtree.get_state())
    assert lt == lj
    np.testing.assert_allclose(
        bt.predict(xt.DMatrix(Xt), output_margin=True),
        bj.predict(xj.DMatrix(Xt), output_margin=True), rtol=RTOL,
        atol=ATOL)
    assert bt.get_dump() == bj.get_dump()


def test_skmaker_lanes_equal_solo_growth():
    """``grow_trees`` over lane bins with the skmaker finder (own cuts,
    pad rows, a pad lane; the terminal level from K2's plain version)
    equals ``grow_tree`` per lane at every split node, and every leaf
    value bitwise."""
    rng = np.random.RandomState(8)
    L, N, F, B, W = 4, 512, 5, 16, 14
    n_real = [512, 480, 131, 0]
    cfg = ttree.GrowConfig(split=tsplit.SplitConfig(min_child_weight=0.5,
                                                    eta=0.3),
                           max_depth=3, n_bin=B, hist_precision="fp32")
    finder = tsk.skmaker_split_finder(8)
    binned = torch.from_numpy(rng.randint(0, B, (L, N, F)).astype(np.uint8))
    gh = rng.randn(L, N, 2).astype(np.float32)
    gh[..., 1] = np.abs(gh[..., 1]) + 0.1
    cuts = np.sort(rng.rand(L, F, W).astype(np.float32), axis=-1)
    n_cuts = rng.randint(3, W + 1, (L, F)).astype(np.int32)
    valid = np.zeros((L, N), bool)
    for lane, n in enumerate(n_real):
        valid[lane, :n] = True
        cuts[lane][np.arange(W)[None, :] >= n_cuts[lane][:, None]] = np.inf
    gh_t, cuts_t = torch.from_numpy(gh), torch.from_numpy(cuts)
    nc_t, rv_t = torch.from_numpy(n_cuts), torch.from_numpy(valid)
    trees, row_leaf, row_val = ttree.grow_trees(
        binned, gh_t, cuts_t, nc_t, cfg, rv_t, split_finder=finder)
    for lane, n in enumerate(n_real[:-1]):
        tree, leaf, val = ttree.grow_tree(
            binned[lane, :n].contiguous(), gh_t[lane, :n].contiguous(),
            cuts_t[lane].contiguous(), nc_t[lane], cfg,
            split_finder=finder)
        split = tree.feature >= 0
        assert torch.equal(trees.feature[lane], tree.feature)
        assert torch.equal(trees.is_leaf[lane], tree.is_leaf)
        for f in ("cut_index", "threshold", "default_left", "gain"):
            assert torch.equal(getattr(trees, f)[lane][split],
                               getattr(tree, f)[split]), (lane, f)
        assert torch.equal(trees.leaf_value[lane], tree.leaf_value)
        assert torch.equal(row_leaf[lane, :n], leaf)
        assert torch.equal(row_val[lane, :n], val)


def test_skmaker_stacked_lanes_equal_host_loop(tmp_path):
    """``run_tenant_lanes`` with ``updater=grow_skmaker``: the stacked
    dispatch publishes the host loop's bytes, one dispatch a cycle."""
    from xgboost_tpu_torch.obs import lane_metrics
    from xgboost_tpu_torch.pipeline import (SyntheticDataSource,
                                            run_tenant_lanes)
    params = {"objective": "binary:logistic", "max_depth": 3,
              "updater": "grow_skmaker", "sketch_eps": 0.2,
              "hist_precision": "fp32"}

    def lanes(mode):
        return {f"t{i}": {"publish_path": str(tmp_path / mode / f"t{i}.bin"),
                          "workdir": str(tmp_path / mode / f"w{i}"),
                          "source": SyntheticDataSource(
                              n_rows=70 + 5 * i, n_features=4, seed=300 + i),
                          "rounds_per_cycle": 2, "cycles": 2,
                          "params": dict(params)} for i in range(3)}
    before = lane_metrics().dispatches.value
    s = lanes("stacked")
    res_s = run_tenant_lanes(s, quiet=True, stacked=True, window_sec=2.0,
                             device="cpu")
    assert lane_metrics().dispatches.value - before == 2
    h = lanes("host")
    res_h = run_tenant_lanes(h, quiet=True, stacked=False, device="cpu")
    for name in s:
        assert res_s[name]["status"] == "ok" == res_h[name]["status"]
        with open(s[name]["publish_path"], "rb") as a, \
                open(h[name]["publish_path"], "rb") as b:
            assert a.read() == b.read(), name


# ------------------------------------------------------------- refresh
def _random_tree_stack(rng, n_roots, depth=3, F=5, B=12):
    """A grown tree of the port's on random bins, its gradients and its
    bins (the structure refresh keeps)."""
    N = 900
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    gh = _grad(int(rng.randint(1 << 30)), N)
    cfg = ttree.GrowConfig(split=tsplit.SplitConfig(min_child_weight=0.5,
                                                    eta=0.3),
                           max_depth=depth, n_bin=B, hist_precision="fp32",
                           n_roots=n_roots)
    cuts = np.sort(rng.rand(F, B - 2).astype(np.float32), axis=1)
    root = torch.from_numpy(rng.randint(0, n_roots, N).astype(np.int32)) \
        if n_roots > 1 else None
    tree, _, _ = ttree.grow_tree(torch.from_numpy(binned),
                                 torch.from_numpy(gh), torch.from_numpy(cuts),
                                 torch.full((F,), B - 2, dtype=torch.int32),
                                 cfg, root=root)
    return tree, binned, cfg, root


@pytest.mark.parametrize("n_roots", [1, 2])
def test_refresh_tree_matches_jax(n_roots):
    rng = np.random.RandomState(60 + n_roots)
    tree, binned, cfg, root = _random_tree_stack(rng, n_roots)
    N = binned.shape[0]
    gh = _grad(70 + n_roots, N)
    valid = rng.rand(N) < 0.85
    js = jsplit.SplitConfig(**cfg.split._asdict())
    jtree_in = jtree.TreeArrays(**{f: jnp.asarray(getattr(tree, f).numpy())
                                   for f in tree._fields})
    rj = jup.refresh_tree(jtree_in, jnp.asarray(binned), jnp.asarray(gh), js,
                          cfg.max_depth, jnp.asarray(valid),
                          root=None if root is None else jnp.asarray(
                              root.numpy()), n_roots=n_roots)
    rt = tup.refresh_tree(tree, torch.from_numpy(binned),
                          torch.from_numpy(gh), cfg.split, cfg.max_depth,
                          torch.from_numpy(valid), root, n_roots)
    for f in rt._fields:       # every field bitwise: the same row order
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), f)
    for f in ("feature", "threshold", "is_leaf"):
        assert torch.equal(getattr(rt, f), getattr(tree, f))


def test_refresh_trees_batches_trees_exactly():
    """One K2 call a level for T trees equals T single-tree refreshes."""
    rng = np.random.RandomState(80)
    trees, binned = [], None
    for _ in range(3):
        t, binned, cfg, _ = _random_tree_stack(np.random.RandomState(
            int(rng.randint(1 << 30))), 1)
        trees.append(t)
    stack = ttree.TreeArrays(*(torch.stack(xs) for xs in zip(*trees)))
    gh = torch.from_numpy(np.stack([_grad(90 + i, binned.shape[0])
                                    for i in range(3)]))
    bins = torch.from_numpy(binned)
    out = tup.refresh_trees(stack, bins, gh, cfg.split, cfg.max_depth)
    for i, t in enumerate(trees):
        one = tup.refresh_tree(t, bins, gh[i], cfg.split, cfg.max_depth)
        for f in one._fields:
            assert torch.equal(getattr(out, f)[i], getattr(one, f)), f


@pytest.mark.parametrize("updater", ["grow_histmaker,refresh", "refresh",
                                     "refresh,prune", "grow_skmaker,refresh"])
def test_refresh_training_matches_jax(updater):
    """Three rounds of ``grow_histmaker``, then a round with the updater
    on a fresh matrix (``gamma=1``); trees and margins against the JAX
    package's, eval lines byte-equal."""
    X, _, y = _class_data(61)
    X2, _, y2 = _class_data(62)
    params = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
              "max_bin": 32, "hist_precision": "fp32", "silent": 1}
    out = {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        d, d2 = pkg.DMatrix(X, label=y), pkg.DMatrix(X2, label=y2)
        b = pkg.train(params, d, 3, verbose_eval=False, **kw)
        b.set_param({"updater": updater, "gamma": 1.0})
        b.update(d2, 3)
        b.update(d2, 4)
        out[name] = (b, b.predict(d2, output_margin=True),
                     b.eval_set([(d2, "fresh"), (d, "train")], 4))
    (bj, mj, ej), (bt, mt, et) = out["j"], out["t"]
    assert_states_match(bj.gbtree.get_state(), bt.gbtree.get_state())
    np.testing.assert_allclose(mt, mj, rtol=RTOL, atol=ATOL)
    assert et == ej
    n_new = 2 if updater.startswith("grow") else 0
    assert bt.gbtree.num_trees == 3 + n_new


def test_refresh_refuses_an_exact_ensemble():
    X, _, y = _class_data(63, 300)
    b = xt.train({"updater": "grow_colmaker", "max_depth": 2, "silent": 1},
                 xt.DMatrix(X, label=y), 1, device="cpu")
    b.set_param({"updater": "grow_colmaker,refresh"})
    with pytest.raises(NotImplementedError, match="exact"):
        b.update(xt.DMatrix(X, label=y), 1)


# ------------------------------------------------------------- the rest
def test_sync_is_a_no_op():
    X, _, y = _class_data(64, 500)
    params = {"objective": "binary:logistic", "max_depth": 3,
              "hist_precision": "fp32", "silent": 1}
    a = xt.train(params, xt.DMatrix(X, label=y), 2, device="cpu")
    b = xt.train(dict(params, updater="grow_histmaker,sync,prune"),
                 xt.DMatrix(X, label=y), 2, device="cpu")
    for k, v in a.gbtree.get_state().items():
        np.testing.assert_array_equal(b.gbtree.get_state()[k], v, k)
    assert set(tup.PORTED_UPDATERS) == {
        "grow_histmaker", "grow_colmaker", "grow_skmaker", "prune",
        "refresh", "sync"}


def test_distcol_raises_naming_item_13():
    X, _, y = _class_data(65, 64)
    with pytest.raises(NotImplementedError, match="item 13"):
        xt.train({"updater": "distcol"}, xt.DMatrix(X, label=y), 1,
                 device="cpu")


def test_predict_engine_refuses_an_exact_model():
    from xgboost_tpu_torch.serving.engine import PredictEngine
    X, _, y = _class_data(66, 300)
    b = xt.train({"updater": "grow_colmaker", "max_depth": 2, "silent": 1},
                 xt.DMatrix(X, label=y), 1, device="cpu")
    with pytest.raises(NotImplementedError, match="exact-mode"):
        PredictEngine(b, device="cpu")


@pytest.mark.parametrize("updater,reason", [
    ("grow_colmaker", "exact"), ("grow_histmaker,refresh", "refresh"),
    ("grow_skmaker", None)])
def test_blocker_reasons_match_jax(updater, reason):
    """``fused_lane_spec``'s reason and the segment plan: the JAX
    package's, ``exact`` before ``refresh`` before ``no_grow_updater``."""
    X, _, y = _class_data(67, 128)
    params = {"objective": "binary:logistic", "updater": updater,
              "max_depth": 2, "silent": 1}
    got, boosters = {}, {}
    for name, pkg, kw in (("j", xj, {}), ("t", xt, {"device": "cpu"})):
        b = boosters[name] = pkg.Booster(params, **kw)
        d = pkg.DMatrix(X, label=y)
        spec, why = b.fused_lane_spec(d, 0, 2)
        plans = []
        b.update_many(d, 0, 2, plan_callback=plans.append)
        got[name] = (why, plans[0] == 0)
    assert got["t"] == got["j"]
    assert got["t"][0] == reason
    blockers = boosters["t"]._segment_blockers(2)
    assert (reason in blockers) if reason else not blockers


if __name__ == "__main__":
    # The JAX package's holdout AUCs behind chip_smoke.py's [updaters]
    # floors (EXACT_AUC_JAX, SK_AUC_JAX): [main]'s data and configuration
    # on the CPU, trained on the first ROWS of its training set.
    #     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_updaters.py
    import sys
    import chip_smoke
    from xgboost_tpu.metrics import auc
    jax.config.update("jax_platforms", "cpu")
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.UPD_JAX_ROWS
    X, y = chip_smoke.make_higgs_like(chip_smoke.N_TRAIN
                                      + chip_smoke.N_TEST)
    hold = slice(chip_smoke.N_TRAIN, None)
    for name, params, rounds in (
            ("EXACT_AUC_JAX", chip_smoke.EXACT_PARAMS,
             chip_smoke.UPD_EXACT_ROUNDS),
            ("SK_AUC_JAX", chip_smoke.SK_PARAMS, chip_smoke.UPD_SK_ROUNDS)):
        b = xj.train(dict(params, hist_precision="fp32", silent=1),
                     xj.DMatrix(X[:rows], label=y[:rows]), rounds,
                     verbose_eval=False)
        p = np.asarray(b.predict(xj.DMatrix(X[hold])))
        print(f"{name} = {auc(p, y[hold], np.ones(len(p), np.float32))!r}")
