"""The port's chunked tree-parallel and fused quantize+traverse
prediction against its own per-tree path and against the JAX package's
traversal, on the same model files (trained by the port on the CPU,
loaded by both packages).

Comparisons and why:
- the port's chunked margins against its per-tree margins: BYTES
  (``tobytes``), the sign of zero included: a tree writes only its own
  group's column in both;
- the port's margins against the JAX package's: values
  (``np.array_equal``, which takes -0.0 == +0.0).  The JAX traversal adds
  ``contrib * one_hot(group)`` to every column, which can turn a -0.0 of
  another group into +0.0; :func:`test_negative_zero_base_is_kept` plants
  that case and checks both sides of it;
- leaf indices are integers: equal arrays;
- fused against quantize-then-traverse: bytes.
The JAX traversal is pure XLA (no Pallas kernel), run as it is on the CPU.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu.binning import bin_matrix as j_bin_matrix  # noqa: E402
from xgboost_tpu.models import tree as jtree  # noqa: E402
from xgboost_tpu_torch.binning import bin_dense_device  # noqa: E402
from xgboost_tpu_torch.binning import bin_matrix as t_bin_matrix  # noqa: E402
from xgboost_tpu_torch.models import tree as ttree  # noqa: E402

F = 6
T_MAX = 70
CHUNKS = (0, 1, 8, 32)
TREE_COUNTS = (1, 7, 32, 33, 70)


def _data(seed, n, f=F, nan=0.1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n, f) < nan] = np.nan
    Z = np.nan_to_num(X)
    y = (Z[:, 0] + 0.5 * Z[:, 1] * Z[:, 2] > 0.2).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Model files the port trains: binary (70 trees), multiclass (3
    groups, 36 trees) and two roots (10 trees)."""
    d = tmp_path_factory.mktemp("chunk")
    X, y = _data(0, 300)
    out = {}
    b = xt.train({"objective": "binary:logistic", "max_depth": 3,
                  "eta": 0.3}, xt.DMatrix(X, label=y), T_MAX, device="cpu")
    out["binary"] = str(d / "binary.bin")
    b.save_model(out["binary"])
    yk = (np.nan_to_num(X[:, 0]) * 1.5 + 1.5).clip(0, 2).astype(np.int64)
    m = xt.train({"objective": "multi:softmax", "num_class": 3,
                  "max_depth": 3, "eta": 0.3},
                 xt.DMatrix(X, label=yk.astype(np.float32)), 12,
                 device="cpu")
    out["multi"] = str(d / "multi.bin")
    m.save_model(out["multi"])
    regime = (np.arange(len(X)) % 2).astype(np.uint32)
    dr = xt.DMatrix(X, label=np.where(regime == 0, y, 1 - y))
    dr.set_uint_info("root_index", regime)
    r = xt.train({"objective": "binary:logistic", "max_depth": 2,
                  "eta": 0.5, "num_roots": 2}, dr, 10, device="cpu")
    out["roots"] = str(d / "roots.bin")
    r.save_model(out["roots"])
    return out


def _pair(path):
    return (xt.Booster(model_file=path, device="cpu"),
            xj.Booster(model_file=path))


def _bins(tb, X):
    b = t_bin_matrix(xt.DMatrix(X), tb.gbtree.cuts)
    return torch.from_numpy(b.astype(np.int32) if b.dtype == np.uint16
                            else b)


def _t_margin(tb, binned, chunk, ntree_limit=0, base=0.0, root=None):
    g = tb.gbtree
    saved, g.pred_chunk = g.pred_chunk, chunk
    try:
        return g.predict_margin(binned, torch.tensor(base,
                                                     dtype=torch.float32),
                                ntree_limit, root).numpy()
    finally:
        g.pred_chunk = saved


def _t_leaves(tb, binned, chunk, ntree_limit=0, root=None):
    g = tb.gbtree
    saved, g.pred_chunk = g.pred_chunk, chunk
    try:
        return g.predict_leaf(binned, ntree_limit, root).numpy()
    finally:
        g.pred_chunk = saved


def _j_margin(jb, X, ntree_limit=0, base=0.0, root=None):
    binned = jnp.asarray(j_bin_matrix(xj.DMatrix(X), jb.gbtree.cuts))
    g = jb.gbtree
    saved, g.pred_chunk = g.pred_chunk, 0
    try:
        return np.asarray(g.predict_margin(binned, jnp.float32(base),
                                           ntree_limit, root))
    finally:
        g.pred_chunk = saved


def _j_leaves(jb, X, ntree_limit=0, root=None):
    binned = jnp.asarray(j_bin_matrix(xj.DMatrix(X), jb.gbtree.cuts))
    g = jb.gbtree
    saved, g.pred_chunk = g.pred_chunk, 0
    try:
        return np.asarray(g.predict_leaf(binned, ntree_limit, root))
    finally:
        g.pred_chunk = saved


# ------------------------------------------------------------- layout

@pytest.mark.parametrize("chunk", [0, 1, 2, 3, 4, 6, 8, 12, 32])
def test_ladder_and_layout_match_jax(chunk):
    for T in range(1, 100):
        assert ttree.padded_tree_count(T, chunk) == \
            jtree.padded_tree_count(T, chunk), (T, chunk)
        assert ttree.predict_chunk_layout(T, chunk) == \
            jtree.predict_chunk_layout(T, chunk), (T, chunk)


@pytest.mark.parametrize("T", TREE_COUNTS)
def test_pad_predict_stack_matches_jax(files, T):
    tb, jb = _pair(files["binary"])
    ts, tg = tb.gbtree._stack(T)
    js, jg = jb.gbtree._stack(T)
    for chunk in CHUNKS:
        tp, tgp, tn = ttree.pad_predict_stack(ts, tg, chunk)
        jp, jgp, jn = jtree.pad_predict_stack(js, jg, chunk)
        assert tn == jn == T
        np.testing.assert_array_equal(tgp.numpy(), np.asarray(jgp))
        for f in ttree.TreeArrays._fields:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))


# ------------------------------------------------------ binary, every T

@pytest.mark.parametrize("T", TREE_COUNTS)
def test_chunked_margins_and_leaves_binary(files, T):
    """T trees (ntree_limit) at every chunk: bytes against the per-tree
    path, values against the JAX traversal."""
    tb, jb = _pair(files["binary"])
    X, _ = _data(1, 97)                       # NaN in 10% of the cells
    binned = _bins(tb, X)
    ref = _t_margin(tb, binned, 0, T)
    ref_l = _t_leaves(tb, binned, 0, T)
    assert ref.shape == (97, 1) and ref_l.shape == (97, T)
    for chunk in CHUNKS:
        assert _t_margin(tb, binned, chunk, T).tobytes() == ref.tobytes(), \
            chunk
        np.testing.assert_array_equal(_t_leaves(tb, binned, chunk, T), ref_l)
    assert np.array_equal(ref, _j_margin(jb, X, T))
    np.testing.assert_array_equal(ref_l, _j_leaves(jb, X, T))


def test_chunked_jax_chunked_agree(files):
    """The JAX package's own chunked core at chunk 8 against the port's
    at 8 (one compile of the JAX program)."""
    tb, jb = _pair(files["binary"])
    X, _ = _data(2, 64)
    binned = jnp.asarray(j_bin_matrix(xj.DMatrix(X), jb.gbtree.cuts))
    stack, group = jb.gbtree._stack(33)
    want = np.asarray(jtree.predict_margin_binned(
        stack, group, binned, jnp.float32(0.0), 3, 1, tree_chunk=8))
    got = _t_margin(tb, _bins(tb, X), 8, 33)
    assert np.array_equal(got, want)


# ----------------------------------------------------------- multiclass

def test_chunked_multiclass_three_groups(files):
    tb, jb = _pair(files["multi"])
    assert tb.gbtree.num_trees == 36
    X, _ = _data(3, 80)
    binned = _bins(tb, X)
    for lim in (0, 5, 33):
        ref = _t_margin(tb, binned, 0, lim)
        assert ref.shape == (80, 3)
        for chunk in CHUNKS:
            assert _t_margin(tb, binned, chunk, lim).tobytes() \
                == ref.tobytes(), (lim, chunk)
        assert np.array_equal(ref, _j_margin(jb, X, lim))
        np.testing.assert_array_equal(_t_leaves(tb, binned, 8, lim),
                                      _j_leaves(jb, X, lim))


def test_negative_zero_base_is_kept(files):
    """A -0.0 base in the columns of groups no tree has reached yet: the
    port keeps it (as its per-tree path does); the JAX traversal makes
    it +0.0 where it adds ``+0.0 * contrib``.  Equal as values."""
    tb, jb = _pair(files["multi"])
    X, _ = _data(4, 40)
    binned = _bins(tb, X)
    ref = _t_margin(tb, binned, 0, 1, base=-0.0)     # one tree: group 0
    assert np.signbit(ref[:, 1:]).all()
    for chunk in CHUNKS:
        assert _t_margin(tb, binned, chunk, 1, base=-0.0).tobytes() \
            == ref.tobytes()
    want = _j_margin(jb, X, 1, base=-0.0)
    assert np.array_equal(ref, want)


# ---------------------------------------------------------------- roots

def test_chunked_two_roots(files):
    tb, jb = _pair(files["roots"])
    X, _ = _data(5, 90)
    regime = (np.arange(90) % 2).astype(np.int32)
    binned = _bins(tb, X)
    root = torch.from_numpy(regime)
    ref = _t_margin(tb, binned, 0, root=root)
    ref_l = _t_leaves(tb, binned, 0, root=root)
    for chunk in CHUNKS:
        assert _t_margin(tb, binned, chunk, root=root).tobytes() \
            == ref.tobytes()
        np.testing.assert_array_equal(_t_leaves(tb, binned, chunk,
                                                root=root), ref_l)
    jroot = jnp.asarray(regime)
    assert np.array_equal(ref, _j_margin(jb, X, root=jroot))
    np.testing.assert_array_equal(ref_l, _j_leaves(jb, X, root=jroot))


# ---------------------------------------------------------------- fused

@pytest.mark.parametrize("chunk", CHUNKS)
def test_fused_equals_quantize_then_traverse(files, chunk):
    tb, jb = _pair(files["binary"])
    X, _ = _data(6, 50, nan=0.3)
    X[3] = np.nan                              # an all-missing row
    g = tb.gbtree
    stack, group = g._stack(33)
    base = torch.tensor(0.25)
    Xt = torch.from_numpy(X)
    got = ttree.predict_margin_fused(stack, group, Xt, g.cut_values_dev,
                                     base, 3, 1, tree_chunk=chunk)
    want = ttree.predict_margin_binned(
        stack, group, bin_dense_device(Xt, g.cut_values_dev), base, 3, 1,
        tree_chunk=chunk)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    jwant = jb.gbtree.predict_margin_fused(jnp.asarray(X), jnp.float32(0.25),
                                           33)
    assert np.array_equal(got.numpy(), np.asarray(jwant))


def test_narrow_rows_through_the_booster(files, monkeypatch):
    """Rows narrower than the model (absent columns missing) through
    ``Booster.predict`` at chunk 0 and 32, against the JAX Booster."""
    X, _ = _data(7, 33, f=F - 2)
    outs = []
    for chunk in ("0", "32"):
        monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", chunk)
        tb = xt.Booster(model_file=files["multi"], device="cpu")
        assert tb.gbtree.pred_chunk == int(chunk)
        outs.append(tb.predict(X, output_margin=True))
    assert outs[0].tobytes() == outs[1].tobytes()
    monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", "0")
    jb = xj.Booster(model_file=files["multi"])
    assert np.array_equal(outs[1], jb.predict(xj.DMatrix(X),
                                              output_margin=True))


def test_pred_chunk_resolution(monkeypatch):
    from xgboost_tpu_torch.config import TrainParam
    from xgboost_tpu_torch.models.gbtree import resolve_pred_chunk
    monkeypatch.delenv("XGBTPU_PREDICT_TREE_CHUNK", raising=False)
    p = TrainParam.from_dict({})
    assert resolve_pred_chunk(p, torch.device("cpu")) == 0
    assert resolve_pred_chunk(p, torch.device("cuda")) == 32
    p = TrainParam.from_dict({"predict_tree_chunk": 5})
    assert resolve_pred_chunk(p, torch.device("cpu")) == 5
    monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", "7")
    assert resolve_pred_chunk(p, torch.device("cuda")) == 7
    monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", "-3")
    assert resolve_pred_chunk(p, torch.device("cuda")) == 0


def test_chunked_reads_groups_on_their_device(files):
    """The chunked core takes the group ids as a tensor and never calls
    ``tolist``/``item`` on it (a device read would break capture)."""
    tb, _ = _pair(files["multi"])
    X, _ = _data(8, 20)
    binned = _bins(tb, X)
    stack, group = tb.gbtree._stack(0)

    class NoHostRead(torch.Tensor):
        def tolist(self):
            raise AssertionError("host read of the group ids")

        def item(self):
            raise AssertionError("host read of the group ids")

    g = group.as_subclass(NoHostRead)
    got = ttree.predict_margin_binned(stack, g, binned, torch.tensor(0.0),
                                      3, 3, tree_chunk=8)
    want = ttree.predict_margin_binned(stack, group, binned,
                                       torch.tensor(0.0), 3, 3)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_eval_margin_unchanged_by_chunking(monkeypatch):
    """Training with eval sets at chunk 0 and 8: the same eval lines and
    model bytes (eval margins fold through the chunked traversal)."""
    X, y = _data(9, 200)
    out = []
    for chunk in ("0", "8"):
        monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", chunk)
        d = xt.DMatrix(X, label=y)
        dv = xt.DMatrix(X[:50], label=y[:50])
        lines = []
        b = xt.Booster({"objective": "multi:softprob", "num_class": 2,
                        "max_depth": 2}, cache=[d, dv], device="cpu")
        for i in range(4):
            b.update(d, i)
            lines.append(b.eval_set([(dv, "v")], i))
        out.append((lines, b.save_raw()))
    assert out[0] == out[1]
