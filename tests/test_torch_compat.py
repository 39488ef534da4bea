"""The reference's binary model format in the port
(``xgboost_tpu_torch/compat.py``) against the JAX package's reader and
writer, on the CPU.

The fixtures are the reference CLI's files ``tests/data/ref_agaricus
.model`` (``binf``, with a prediction buffer at its end) and ``.bs64``
(the same model base64-encoded).  The reference's own predictions
(``ref_agaricus.pred``) are of agaricus's test file, which is not in the
repository, so the port is held against the JAX package's reading of
the same files, on synthetic 126-feature presence rows from a seed.

Tolerances: parse results equal; predictions bitwise; written reference
files byte-equal; files written by either package read by the other.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu import compat as jc  # noqa: E402
from xgboost_tpu_torch import compat as tc  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
REF = {"binf": os.path.join(DATA, "ref_agaricus.model"),
       "bs64": os.path.join(DATA, "ref_agaricus.bs64")}


def _rows(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 126) < 0.2).astype(np.float32)


@pytest.mark.parametrize("fmt", ["binf", "bs64"])
def test_parse_equals_jax(fmt):
    with open(REF[fmt], "rb") as f:
        raw = f.read()
    pj, pt = jc.parse_reference_model(raw), tc.parse_reference_model(raw)
    assert sorted(pj) == sorted(pt)
    for k in ("base_margin", "num_feature", "num_class", "objective", "gbm",
              "num_output_group"):
        assert pj[k] == pt[k], k
    np.testing.assert_array_equal(pj["tree_info"], pt["tree_info"])
    assert len(pj["trees"]) == len(pt["trees"]) == 2
    for (nj, sj), (nt, st) in zip(pj["trees"], pt["trees"]):
        assert nj.tobytes() == nt.tobytes() and sj.tobytes() == st.tobytes()


def test_headerless_stream_parses_like_binf():
    with open(REF["binf"], "rb") as f:
        raw = f.read()
    pj = jc.parse_reference_model(raw[4:])
    pt = tc.parse_reference_model(raw[4:])
    assert pt["objective"] == pj["objective"] == "binary:logistic"
    assert [n.tobytes() for n, _ in pt["trees"]] == \
        [n.tobytes() for n, _ in pj["trees"]]


def test_old_format_string_gap():
    """An old file's string length carries a 4-byte gap: a length word
    of ``len << 32`` (``compat.py:55-62``)."""
    import struct
    raw = (tc._LEARNER_PARAM.pack(0.0, 3, 0)
           + struct.pack("<Q", 15 << 32) + b"\0" * 4 + b"binary:logistic"
           + struct.pack("<Q", 8) + b"gblinear"
           + tc._GBLINEAR_PARAM.pack(3, 1) + struct.pack("<Q", 4)
           + np.arange(4, dtype="<f4").tobytes())
    pj, pt = jc.parse_reference_model(raw), tc.parse_reference_model(raw)
    assert pt["objective"] == pj["objective"] == "binary:logistic"
    np.testing.assert_array_equal(pt["weights"], pj["weights"])


@pytest.mark.parametrize("fmt", ["binf", "bs64"])
def test_reference_model_predicts_bitwise(fmt):
    """The loaded reference model's predictions (margins and
    probabilities) and leaves equal the JAX package's."""
    X = _rows()
    bj = jc.load_reference_model(REF[fmt])
    bt = tc.load_reference_model(REF[fmt], device="cpu")
    assert bt.param.max_depth == bj.param.max_depth
    np.testing.assert_array_equal(bt.gbtree.cuts.cut_values,
                                  bj.gbtree.cuts.cut_values)
    for margin in (False, True):
        np.testing.assert_array_equal(
            bt.predict(xt.DMatrix(X), output_margin=margin),
            bj.predict(xj.DMatrix(X), output_margin=margin))
    np.testing.assert_array_equal(bt.predict(xt.DMatrix(X), pred_leaf=True),
                                  bj.predict(xj.DMatrix(X), pred_leaf=True))


def test_booster_load_model_sniffs_reference_formats(tmp_path):
    """``Booster(model_file=)`` and ``load_raw`` read ``binf``, the
    reference's ``bs64`` and a ``bs64`` of a headerless stream."""
    import base64
    X = _rows(300, 1)
    want = jc.load_reference_model(REF["binf"]).predict(xj.DMatrix(X))
    with open(REF["binf"], "rb") as f:
        raw = f.read()
    ours64 = b"bs64\t" + base64.b64encode(raw[4:]) + b"\n"
    for src in (REF["binf"], REF["bs64"], ours64):
        bt = xt.Booster(device="cpu")
        if isinstance(src, bytes):
            bt.load_raw(src)
        else:
            bt.load_model(src)
        np.testing.assert_array_equal(bt.predict(xt.DMatrix(X)), want)
        assert bt.num_feature == 126


def _jax_model(tmp_path, params, n_rounds, X, y, name):
    bst = xj.train(params, xj.DMatrix(X, label=y), n_rounds,
                   verbose_eval=False)
    path = str(tmp_path / f"{name}.bin")
    bst.save_model(path)
    return path


def _models(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.rand(400, 5).astype(np.float32)
    X[rng.rand(*X.shape) < 0.1] = np.nan
    Z = np.nan_to_num(X)
    y_bin = (Z[:, 0] + Z[:, 1] > 1).astype(np.float32)
    y_mc = np.clip((Z[:, 0] * 3).astype(int), 0, 2).astype(np.float32)
    return X, {
        "binary": _jax_model(tmp_path, {"objective": "binary:logistic",
                                        "max_depth": 3, "eta": 0.5},
                             3, X, y_bin, "binary"),
        "multiclass": _jax_model(tmp_path, {"objective": "multi:softmax",
                                            "num_class": 3, "max_depth": 3,
                                            "eta": 0.5},
                                 3, X, y_mc, "multiclass"),
        "linear": _jax_model(tmp_path, {"booster": "gblinear",
                                        "objective": "binary:logistic",
                                        "eta": 0.5}, 4, X, y_bin, "linear"),
    }


@pytest.mark.parametrize("kind", ["binary", "multiclass", "linear"])
@pytest.mark.parametrize("b64,npb", [(False, None), (True, 7)])
def test_writer_bytes_equal_jax(tmp_path, kind, b64, npb):
    """One model file in both packages: ``save_reference_model`` writes
    the same bytes (``binf`` and ``bs64``, with and without a prediction
    buffer), and each package reads the other's file."""
    X, paths = _models(tmp_path)
    bj = xj.Booster(model_file=paths[kind])
    bt = xt.Booster(model_file=paths[kind], device="cpu")
    raw_j = jc.save_reference_model(bj, base64_mode=b64, num_pbuffer=npb)
    raw_t = tc.save_reference_model(bt, str(tmp_path / "t.ref"),
                                    base64_mode=b64, num_pbuffer=npb)
    assert raw_t == raw_j
    with open(tmp_path / "t.ref", "rb") as f:
        assert f.read() == raw_t
    with open(tmp_path / "j.ref", "wb") as f:
        f.write(raw_j)
    from_j = xt.Booster(model_file=str(tmp_path / "j.ref"), device="cpu")
    from_t = xj.Booster(model_file=str(tmp_path / "t.ref"))
    Xd = np.nan_to_num(X) if kind == "linear" else X
    np.testing.assert_array_equal(from_j.predict(xt.DMatrix(Xd)),
                                  from_t.predict(xj.DMatrix(Xd)))
    np.testing.assert_allclose(from_j.predict(xt.DMatrix(Xd)),
                               bj.predict(xj.DMatrix(Xd)),
                               rtol=1e-6, atol=1e-7)


def test_writer_counts_cached_rows_as_the_buffer(tmp_path):
    """By default the prediction buffer holds the booster's cached rows
    (``num_pbuffer``), zeroed, num_pbuffer x K entries twice."""
    rng = np.random.RandomState(1)
    X = rng.rand(300, 4).astype(np.float32)
    y = np.clip((X[:, 0] * 3).astype(int), 0, 2).astype(np.float32)
    bst = xt.train({"objective": "multi:softmax", "num_class": 3,
                    "max_depth": 2}, xt.DMatrix(X, label=y), 2,
                   device="cpu")
    raw = tc.save_reference_model(bst)[4:]
    off = tc._LEARNER_PARAM.size
    _, off = tc._read_str(raw, off)
    _, off = tc._read_str(raw, off)
    _, _, _, npb, nog, _ = tc._GBTREE_PARAM.unpack_from(raw, off)
    assert npb == 300 and nog == 3
    assert raw.endswith(b"\x00" * (8 * 300 * 3))


def test_base_score_inverts_the_margin():
    for obj in ("reg:linear", "binary:logistic"):
        oj = xj.objectives.create_objective(obj)
        from xgboost_tpu_torch.objectives import create_objective
        ot = create_objective(obj)
        for m in (-1.5, 0.0, 0.7):
            assert tc._margin_to_base_score(ot, m) == \
                jc._margin_to_base_score(oj, m)


def test_cli_predicts_with_a_reference_model_file(tmp_path):
    """``task=pred model_in=ref_agaricus.model`` in both CLIs: the same
    bytes (the file the reference CLI wrote, read by the port's)."""
    import contextlib
    import io
    from xgboost_tpu.cli import main as jax_main
    from xgboost_tpu_torch.cli import main as port_main
    X = _rows(500, 3)
    svm = tmp_path / "t.svm"
    with open(svm, "w") as f:
        for row in X:
            feats = " ".join(f"{j}:1" for j in np.nonzero(row)[0])
            f.write(f"0 {feats}\n")
    outs = []
    for name, main, extra in (("j", jax_main, []),
                              ("t", port_main, ["device=cpu"])):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(f"task = pred\nmodel_in = {REF['binf']}\n"
                        f"test:data = {svm}\n"
                        f"name_pred = {tmp_path / (name + '.pred')}\n"
                        "silent = 1\n")
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert main([str(conf), *extra]) == 0
        with open(tmp_path / f"{name}.pred", "rb") as f:
            outs.append(f.read())
    assert outs[0] and outs[0] == outs[1]
