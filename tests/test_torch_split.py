"""The port's split finder against the JAX package's, on identical
histograms: every output bit for bit, including planted ties (the first
maximum in (feature, cut, direction) order wins) and forced default
directions.  The JAX functions run op by op here, as does the port's
plain SplitConfig.

The F10 tests hold the growers' configuration (``FusedSplitConfig``)
against the JAX functions under ``jax.jit``, as the JAX package's
growers run them: there XLA's CPU backend contracts the gain under
``max_delta_step`` into one fused multiply-add, which the port's CPU
gain replays (ROADMAP.md section 3): the gain, the finders and every
other caller of the gain (exact, skmaker, refresh), and a trained
probe's dumps, eval lines and margins byte-equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xgboost_tpu.ops import split as jsplit  # noqa: E402
from xgboost_tpu_torch.ops import split as tsplit  # noqa: E402


def _hist(M, F, B, seed, dyadic=True):
    """(M, F, B, 2) histogram with positive hessians and its node totals
    (bin sums of feature 0, as the growers derive them)."""
    rng = np.random.RandomState(seed)
    g = rng.randint(-64, 64, (M, F, B)) / 16.0
    h = rng.randint(0, 32, (M, F, B)) / 8.0
    if not dyadic:
        g = g + rng.randn(M, F, B) * 0.01
        h = h + rng.rand(M, F, B) * 0.01
    hist = np.stack([g, h], axis=-1).astype(np.float32)
    # every feature must carry the node's totals: rescale features 1.. to
    # feature 0's per-node sums through their missing bin
    tot = hist[:, 0].sum(axis=1)
    hist[:, 1:, 0, :] = tot[:, None, :] - hist[:, 1:, 1:, :].sum(axis=2)
    nst = hist[:, 0].sum(axis=1)
    return hist, nst


def _n_cuts(F, B, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(1, B - 1, F).astype(np.int32)


CFGS = [jsplit.SplitConfig(),
        jsplit.SplitConfig(reg_lambda=2.0, reg_alpha=0.5,
                           min_child_weight=0.5),
        jsplit.SplitConfig(max_delta_step=0.7, reg_alpha=0.25),
        jsplit.SplitConfig(default_direction=1),
        jsplit.SplitConfig(default_direction=2)]


def _assert_same(got, want):
    for name in ("gain", "feature", "cut_index", "default_left", "valid",
                 "left_g", "left_h"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("ci", range(len(CFGS)))
@pytest.mark.parametrize("dyadic", [True, False])
def test_standard_layout_bitwise(ci, dyadic):
    M, F, B = 8, 5, 16
    hist, nst = _hist(M, F, B, seed=ci + 10 * dyadic, dyadic=dyadic)
    nc = _n_cuts(F, B, ci)
    cfg = CFGS[ci]
    want = jsplit.find_best_splits(jnp.asarray(hist), jnp.asarray(nst),
                                   jnp.asarray(nc), cfg)
    got = tsplit.find_best_splits(torch.from_numpy(hist),
                                  torch.from_numpy(nst),
                                  torch.from_numpy(nc),
                                  tsplit.SplitConfig(*cfg))
    _assert_same(got, want)


@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_native_layout_bitwise(ci):
    M, F, B = 4, 6, 12
    hist, nst = _hist(M, F, B, seed=40 + ci)
    native = np.ascontiguousarray(np.transpose(hist, (1, 2, 3, 0)))
    nc = _n_cuts(F, B, ci + 1)
    cfg = CFGS[ci]
    want = jsplit.find_best_splits_native(
        jnp.asarray(native), jnp.asarray(nst), jnp.asarray(nc), cfg)
    got = tsplit.find_best_splits_native(
        torch.from_numpy(native), torch.from_numpy(nst),
        torch.from_numpy(nc), tsplit.SplitConfig(*cfg))
    _assert_same(got, want)


def test_planted_ties_pick_the_first_candidate():
    """Features 1 and 3 identical (the best), and no missing values so
    both default directions tie: the winner is feature 1, direction 0
    (missing right), in both packages."""
    M, F, B = 3, 5, 10
    hist, nst = _hist(M, F, B, seed=7)
    rng = np.random.RandomState(8)
    strong = np.zeros((M, B, 2), np.float32)
    strong[:, 1:, 1] = 2.0
    strong[:, 1:5, 0] = -3.0
    strong[:, 5:, 0] = 3.0
    strong[:, 0, :] = 0.0
    hist[:] = np.abs(rng.randint(1, 3, hist.shape)).astype(np.float32) / 4.0
    hist[:, :, :, 0] = 0.0
    hist[:, :, 0, :] = 0.0
    hist[:, 1] = strong
    hist[:, 3] = strong
    # rebalance the other features to the strong features' totals
    tot = strong.sum(axis=1)
    for f in (0, 2, 4):
        hist[:, f, 0, :] = tot - hist[:, f, 1:, :].sum(axis=1)
    nst = hist[:, 1].sum(axis=1)
    nc = np.full(F, B - 2, np.int32)
    cfg = jsplit.SplitConfig()
    want = jsplit.find_best_splits(jnp.asarray(hist), jnp.asarray(nst),
                                   jnp.asarray(nc), cfg)
    got = tsplit.find_best_splits(torch.from_numpy(hist),
                                  torch.from_numpy(nst),
                                  torch.from_numpy(nc),
                                  tsplit.SplitConfig(*cfg))
    _assert_same(got, want)
    assert (got.feature.numpy() == 1).all()
    assert not got.default_left.numpy().any()
    assert (got.cut_index.numpy() == 3).all()


def test_calc_weight_and_gain_bitwise():
    rng = np.random.RandomState(3)
    G = rng.randn(500).astype(np.float32) * 4
    H = rng.rand(500).astype(np.float32) * 3
    H[:20] = 0.0
    for cfg in CFGS[:3]:
        tcfg = tsplit.SplitConfig(*cfg)
        np.testing.assert_array_equal(
            tsplit.calc_weight(torch.from_numpy(G), torch.from_numpy(H),
                               tcfg).numpy(),
            np.asarray(jsplit.calc_weight(jnp.asarray(G), jnp.asarray(H),
                                          cfg)))
        np.testing.assert_array_equal(
            tsplit.calc_gain(torch.from_numpy(G), torch.from_numpy(H),
                             tcfg).numpy(),
            np.asarray(jsplit.calc_gain(jnp.asarray(G), jnp.asarray(H),
                                        cfg)))


# ------------------------------------------------------------------ F10
_JIT_STD = jax.jit(jsplit.find_best_splits, static_argnums=3)
_JIT_NATIVE = jax.jit(jsplit.find_best_splits_native, static_argnums=3)
_JIT_GAIN = jax.jit(jsplit.calc_gain, static_argnums=2)


# (max_delta_step, alpha, lambda) of ROADMAP.md's F10 probe
F10_CFGS = [(0.7, 0.5, 1.0), (0.7, 0.0, 1.0), (0.3, 0.25, 2.0)]


def _f10_cfg(mds, alpha, lam, **kw):
    return jsplit.SplitConfig(max_delta_step=mds, reg_alpha=alpha,
                              reg_lambda=lam, **kw)


@pytest.mark.parametrize("mds,alpha,lam", F10_CFGS)
def test_f10_gain_matches_jitted_jax(mds, alpha, lam):
    """200,000 random (G, H): the CPU gain is the jitted JAX gain's bits
    (its ``G * w + t`` one fused multiply-add, the alpha term after)."""
    rng = np.random.RandomState(0)
    G = (rng.randn(200_000) * 5).astype(np.float32)
    H = (rng.rand(200_000) * 10 + 0.1).astype(np.float32)
    cfg = _f10_cfg(mds, alpha, lam)
    got = tsplit.calc_gain(torch.from_numpy(G), torch.from_numpy(H),
                           tsplit.FusedSplitConfig(*cfg)).numpy()
    want = np.asarray(_JIT_GAIN(jnp.asarray(G), jnp.asarray(H), cfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("mds,alpha,lam", F10_CFGS)
def test_f10_finders_match_jitted_jax(mds, alpha, lam, M):
    """Both layouts' finders on non-dyadic histograms of M nodes at the
    Higgs configuration's 64 bins (B = 66), every output bitwise against
    the jitted JAX finders.  At some smaller bin counts XLA fuses the
    other product of the gain instead (F10's remainder, ROADMAP.md
    section 3)."""
    F, B = 6, 66
    hist, nst = _hist(M, F, B, seed=90 + M, dyadic=False)
    nc = _n_cuts(F, B, 91)
    cfg = _f10_cfg(mds, alpha, lam, min_child_weight=0.5)
    tcfg = tsplit.FusedSplitConfig(*cfg)
    got = tsplit.find_best_splits(torch.from_numpy(hist),
                                  torch.from_numpy(nst),
                                  torch.from_numpy(nc), tcfg)
    _assert_same(got, _JIT_STD(jnp.asarray(hist), jnp.asarray(nst),
                               jnp.asarray(nc), cfg))
    native = np.ascontiguousarray(np.transpose(hist, (1, 2, 3, 0)))
    got = tsplit.find_best_splits_native(torch.from_numpy(native),
                                         torch.from_numpy(nst),
                                         torch.from_numpy(nc), tcfg)
    _assert_same(got, _JIT_NATIVE(jnp.asarray(native), jnp.asarray(nst),
                                  jnp.asarray(nc), cfg))


def _f10_probe(seed, n):
    """ROADMAP.md's F10 probe: randn f32, the last column rounded to
    halves, 10% missing, label ``x0 + x1 * x2 > 0.3`` (missing read as
    0)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 5] = np.round(X[:, 5] * 2) / 2
    X[rng.rand(n, 6) < 0.1] = np.nan
    Z = np.nan_to_num(X)
    return X, (Z[:, 0] + Z[:, 1] * Z[:, 2] > 0.3).astype(np.float32)


@pytest.mark.parametrize("precision", ["fixed", "fp32", "auto"])
def test_f10_probe_trains_the_jax_trees(precision):
    """The probe that found F10 (node 3 split at cut 28 against the JAX
    package's 23): 3 rounds of depth 3 under ``max_delta_step`` 0.7,
    dumps with statistics, eval lines and test margins byte-equal."""
    import xgboost_tpu as xj
    import xgboost_tpu_torch as xt
    X, y = _f10_probe(1, 2000)
    Xt, yt = _f10_probe(2, 700)
    params = {"objective": "binary:logistic", "max_delta_step": 0.7,
              "max_depth": 3, "eta": 0.3, "hist_precision": precision,
              "silent": 1}
    out = []
    for pkg, kw in ((xj, {}), (xt, {"device": "cpu"})):
        d, dt = pkg.DMatrix(X, label=y), pkg.DMatrix(Xt, label=yt)
        res = {}
        bst = pkg.train(params, d, 3, evals=[(d, "train"), (dt, "test")],
                        evals_result=res, verbose_eval=False, **kw)
        out.append((bst.get_dump(with_stats=True), res,
                    np.asarray(bst.predict(dt, output_margin=True))))
    (dj, rj, mj), (dt_, rt, mt) = out
    assert dt_ == dj
    assert rt == rj
    np.testing.assert_array_equal(mt, mj)


def _f10_split(**kw):
    return (_f10_cfg(0.7, 0.5, 1.0, min_child_weight=0.5, **kw),
            tsplit.FusedSplitConfig(*_f10_cfg(0.7, 0.5, 1.0,
                                              min_child_weight=0.5, **kw)))


def test_f10_exact_finder_matches_jitted_jax():
    """The exact grower's finder (``colmaker.py`` gains of the root, the
    scan and the end-of-scan candidates) on one level of 4 nodes."""
    from xgboost_tpu.models import colmaker as jcm
    from xgboost_tpu_torch.models import colmaker as tcm
    rng = np.random.RandomState(11)
    N, F, M = 1500, 6, 4
    X = rng.randn(N, F).astype(np.float32)
    X[rng.rand(N, F) < 0.1] = np.nan
    gh = np.stack([rng.randn(N), rng.rand(N) + 0.05], 1).astype(np.float32)
    pos = rng.randint(-1, M, N).astype(np.int32)
    nst = np.stack([np.bincount(pos[pos >= 0], gh[pos >= 0, c], M)
                    for c in (0, 1)], 1).astype(np.float32)
    fmask = np.ones(F, bool)
    cfg, tcfg = _f10_split()
    find = jax.jit(jcm._find_exact_splits,
                   static_argnames=("n_node", "scfg", "has_missing"))
    want = find(jnp.asarray(X.T), jnp.asarray(np.isnan(X.T)),
                jnp.asarray(gh), jnp.asarray(pos), jnp.asarray(nst),
                n_node=M, fmask=jnp.asarray(fmask), scfg=cfg,
                has_missing=True)
    got, thr = tcm._find_exact_splits(
        torch.from_numpy(np.ascontiguousarray(X.T)),
        torch.from_numpy(np.isnan(X.T)), torch.from_numpy(gh),
        torch.from_numpy(pos), torch.from_numpy(nst), M,
        torch.from_numpy(fmask), tcfg, True)
    for f in ("gain", "feature", "default_left", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(thr.numpy(), np.asarray(want.threshold))


def test_f10_refresh_gains_match_jitted_jax():
    """``refresh`` recomputes every split's gain from its children's
    sums: tree 0 of a ``grow_histmaker,refresh`` probe read 5.3684998
    against the JAX package's 5.3685303 before F10's fix."""
    from xgboost_tpu.models import tree as jtree
    from xgboost_tpu.models import updaters as jup
    from xgboost_tpu_torch.models import tree as ttree
    from xgboost_tpu_torch.models import updaters as tup
    rng = np.random.RandomState(12)
    N, F, B, D = 900, 5, 12, 3
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    gh = np.stack([rng.randn(N), rng.rand(N) + 0.05], 1).astype(np.float32)
    cfg, tcfg = _f10_split(eta=0.3)
    grow = ttree.GrowConfig(split=tcfg, max_depth=D, n_bin=B,
                            hist_precision="fp32")
    cuts = np.sort(rng.rand(F, B - 2).astype(np.float32), axis=1)
    tree, _, _ = ttree.grow_tree(torch.from_numpy(binned),
                                 torch.from_numpy(gh), torch.from_numpy(cuts),
                                 torch.full((F,), B - 2, dtype=torch.int32),
                                 grow)
    gh2 = np.stack([rng.randn(N), rng.rand(N) + 0.05], 1).astype(np.float32)
    jt = jtree.TreeArrays(**{f: jnp.asarray(getattr(tree, f).numpy())
                             for f in tree._fields})
    want = jax.jit(jup.refresh_tree, static_argnums=(3, 4))(
        jt, jnp.asarray(binned), jnp.asarray(gh2), cfg, D)
    got = tup.refresh_tree(tree, torch.from_numpy(binned),
                           torch.from_numpy(gh2), tcfg, D)
    for f in ("gain", "leaf_value", "sum_hess"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
