"""External memory, the native IO library and remote URIs in the port
(``xgboost_tpu_torch/external.py``, ``native.py``, ``io/dispatch.py``)
against the JAX package, on the CPU (500-4,000 rows, 5-10 features,
every input from a seed).  Paged training is forced to stream with
``XGBTPU_EXT_DEVICE_CACHE_MB=0`` unless a test says otherwise.

Tolerances and why:

- pages, cuts and the binned memmap byte-equal: one native library, one
  streaming sketch, one binning;
- paged trees: structure equal, thresholds bitwise and leaf values
  within rtol 1e-5 (the port's CPU path sums the batches' partial
  histograms and node sums in the JAX package's batch order, so they
  come out bitwise on these fixtures too); eval lines byte-equal;
- the native parser equals the port's Python parser; page files cross
  between the packages both ways.
"""

import contextlib
import io
import os
import stat
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu import native as jnat  # noqa: E402
from xgboost_tpu.external import ExtMemDMatrix as JExt  # noqa: E402
from xgboost_tpu_torch import native as tnat  # noqa: E402
from xgboost_tpu_torch.external import ExtMemDMatrix as TExt  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
PARAMS = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.5,
          "silent": 1}
STRUCT = ("tree_feature", "tree_is_leaf", "tree_default_left",
          "tree_threshold", "tree_cut_index")


@pytest.fixture(autouse=True)
def _stream(monkeypatch):
    monkeypatch.setenv("XGBTPU_EXT_DEVICE_CACHE_MB", "0")


def make_data(n=3000, f=10, seed=0, nan=0.05):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[rng.rand(n, f) < nan] = np.nan
    Z = np.nan_to_num(X)
    y = ((Z[:, 0] > 0.5) ^ (Z[:, 1] > 0.3)).astype(np.float32)
    return X, y


def chunked(X, y, size):
    for s in range(0, len(X), size):
        yield X[s:s + size], y[s:s + size]


def write_svm(path, X, y):
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            feats = " ".join(f"{j}:{v:.6f}" for j, v in enumerate(row)
                             if not np.isnan(v))
            f.write(f"{lab:g} {feats}\n")
    return str(path)


def both(tmp_path, X, y, chunk, page_rows, tag):
    return (JExt(chunked(X, y, chunk), cache=str(tmp_path / f"j{tag}"),
                 page_rows=page_rows),
            TExt(chunked(X, y, chunk), cache=str(tmp_path / f"t{tag}"),
                 page_rows=page_rows))


def train_both(params, dj, dt, rounds, evals=True):
    rj, rt = {}, {}
    bj = xj.train(params, dj, rounds, evals=[(dj, "train")] if evals else (),
                  evals_result=rj, verbose_eval=False)
    bt = xt.train(params, dt, rounds, evals=[(dt, "train")] if evals else (),
                  evals_result=rt, verbose_eval=False, device="cpu")
    return bj, bt, rj, rt


def assert_models_match(bj, bt):
    sj, st = bj.gbtree.get_state(), bt.gbtree.get_state()
    for k in STRUCT:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    for k in ("tree_leaf_value", "tree_gain", "tree_sum_hess"):
        np.testing.assert_allclose(st[k], sj[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(st["cut_values"], sj["cut_values"])


# ------------------------------------------------------------ the matrix
def test_pages_cuts_and_binned_bytes_equal_jax(tmp_path):
    X, y = make_data(2500, 8, seed=1)
    dj, dt = both(tmp_path, X, y, 300, 512, "p")
    assert (dt.num_row, dt.num_col) == (dj.num_row, dj.num_col)
    with open(dj._pages_path(), "rb") as a, open(dt._pages_path(), "rb") as b:
        assert a.read() == b.read()
    for max_bin in (16, 256, 300):
        cj, ct = dj.sketch_cuts(max_bin), dt.sketch_cuts(max_bin)
        np.testing.assert_array_equal(ct.cut_values, cj.cut_values)
        np.testing.assert_array_equal(ct.n_cuts, cj.n_cuts)
        dj.build_binned(cj)
        dt.build_binned(ct)
        assert dt._binned_mm.dtype == dj._binned_mm.dtype
        assert np.asarray(dt._binned_mm).tobytes() == \
            np.asarray(dj._binned_mm).tobytes()
    with open(dj.cache_prefix + ".binned", "rb") as a, \
            open(dt.cache_prefix + ".binned", "rb") as b:
        assert a.read() == b.read()


def test_libsvm_ingest_equals_jax(tmp_path):
    X, y = make_data(1200, 6, seed=2)
    svm = write_svm(tmp_path / "a.svm", X, y)
    dj = JExt(f"{svm}#{tmp_path / 'j'}", page_rows=256)
    dt = TExt(f"{svm}#{tmp_path / 't'}", page_rows=256)
    assert (dt.num_row, dt.num_col) == (dj.num_row, dj.num_col) == (1200, 6)
    np.testing.assert_array_equal(dt.get_label(), dj.get_label())
    for (a, b, c), (d, e, f) in zip(dj.iter_raw_pages(), dt.iter_raw_pages()):
        for u, v in ((a, d), (b, e), (c, f)):
            np.testing.assert_array_equal(u, v)


def test_python_page_store_without_the_library(tmp_path, monkeypatch):
    """Without the native library the pages stay in RAM and the chunk
    parser ingests; cuts and bins are the same."""
    X, y = make_data(900, 5, seed=3)
    svm = write_svm(tmp_path / "b.svm", X, y)
    d_nat = TExt(f"{svm}#{tmp_path / 'n'}", page_rows=200)
    c1 = d_nat.sketch_cuts(64)
    d_nat.build_binned(c1)
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "_load_failed", True)
    d_py = TExt(f"{svm}#{tmp_path / 'p'}", page_rows=200)
    assert not os.path.exists(str(tmp_path / "p") + ".pages")
    assert len(d_py._ram_pages) == 5
    c2 = d_py.sketch_cuts(64)
    np.testing.assert_array_equal(c1.cut_values, c2.cut_values)
    d_py.build_binned(c2)
    np.testing.assert_array_equal(np.asarray(d_nat._binned_mm),
                                  np.asarray(d_py._binned_mm))


# ------------------------------------------------------- paged training
@pytest.mark.parametrize("name,page_rows,extra", [
    ("one-page", 3000, {}),
    ("pages", 512, {}),
    ("sampled", 512, {"subsample": 0.8, "colsample_bytree": 0.8,
                      "colsample_bylevel": 0.7, "seed": 3}),
    ("gamma", 512, {"gamma": 0.5}),
    ("fixed", 700, {"hist_precision": "fixed"}),
    ("depth0", 512, {"max_depth": 0}),
])
def test_paged_training_matches_jax(tmp_path, name, page_rows, extra):
    X, y = make_data()
    dj, dt = both(tmp_path, X, y, 256, page_rows, name)
    bj, bt, rj, rt = train_both({**PARAMS, **extra}, dj, dt, 4)
    assert_models_match(bj, bt)
    assert rj == rt
    entry = bt._cache[id(dt)]
    assert entry.external and entry.binned is None


def test_multiclass_and_forest_paged(tmp_path):
    X, _ = make_data(2000, 6, seed=4)
    y = np.argmax(np.nan_to_num(X[:, :3]), axis=1).astype(np.float32)
    dj, dt = both(tmp_path, X, y, 400, 512, "mc")
    params = {"objective": "multi:softprob", "num_class": 3,
              "max_depth": 3, "num_parallel_tree": 2, "silent": 1}
    bj, bt, rj, rt = train_both(params, dj, dt, 3)
    assert bt.gbtree.tree_group == bj.gbtree.tree_group
    assert_models_match(bj, bt)
    assert rj == rt
    np.testing.assert_allclose(bt.predict(dt), bj.predict(dj),
                               rtol=RTOL, atol=ATOL)


def test_streamed_predict_ntree_limit_and_leaves(tmp_path):
    X, y = make_data(1500, 6, seed=5)
    dj, dt = both(tmp_path, X, y, 300, 256, "nt")
    bj, bt, _, _ = train_both(PARAMS, dj, dt, 5, evals=False)
    for kw in ({}, {"ntree_limit": 2}, {"output_margin": True},
               {"pred_leaf": True}):
        np.testing.assert_allclose(bt.predict(dt, **kw), bj.predict(dj, **kw),
                                   rtol=RTOL, atol=ATOL, err_msg=str(kw))
    # one-off external matrices (not in the cache) stream too
    dj2, dt2 = both(tmp_path, X[:700], y[:700], 300, 256, "nt2")
    np.testing.assert_allclose(bt.predict(dt2), bj.predict(dj2),
                               rtol=RTOL, atol=ATOL)
    assert id(dt2) not in bt._cache


def test_separate_external_eval_set(tmp_path):
    X, y = make_data(4000, 6, seed=6)
    dj_tr, dt_tr = both(tmp_path, X[:3000], y[:3000], 500, 512, "tr")
    dj_te, dt_te = both(tmp_path, X[3000:], y[3000:], 500, 512, "te")
    rj, rt = {}, {}
    xj.train(PARAMS, dj_tr, 4, evals=[(dj_te, "test")], evals_result=rj,
             verbose_eval=False)
    bt = xt.train(PARAMS, dt_tr, 4, evals=[(dt_te, "test")],
                  evals_result=rt, verbose_eval=False, device="cpu")
    assert rj == rt
    assert "external_eval" in bt._segment_blockers(
        5, entry=bt._entry(dt_tr), evals=[(dt_te, "test")])


def test_continued_training_custom_objective_and_rebinning(tmp_path):
    """``xgb_model=`` continues a paged model; a custom objective boosts
    over the stream; another model's cuts re-bin the matrix and the first
    model re-bins it back."""
    X, y = make_data(1500, 6, seed=7)
    dj, dt = both(tmp_path, X, y, 300, 512, "co")

    def logistic(preds, dmat):
        labels = dmat.get_label()
        return preds - labels, preds * (1.0 - preds)
    out = []
    for pkg, d, kw in ((xj, dj, {}), (xt, dt, {"device": "cpu"})):
        b = pkg.train(PARAMS, d, 2, obj=logistic, verbose_eval=False, **kw)
        b = pkg.train(PARAMS, d, 2, xgb_model=b, verbose_eval=False, **kw)
        out.append(b)
    assert out[1].gbtree.num_trees == out[0].gbtree.num_trees == 4
    assert_models_match(*out)
    bt = out[1]
    p0 = bt.predict(dt)
    other = xt.train({**PARAMS, "max_bin": 16},
                     xt.DMatrix(X * 10.0, label=y), 2, device="cpu")
    assert other.predict(dt).shape == (1500,)
    assert dt._binned_cuts is other.gbtree.cuts
    np.testing.assert_array_equal(bt.predict(dt), p0)


def test_half_ram_route_matches_paged(tmp_path):
    X, y = make_data(1500, 6, seed=8)
    svm = write_svm(tmp_path / "hr.svm", X, y)
    d_page = xt.DMatrix(f"ext:{svm}#{tmp_path / 'p'}")
    d_half = xt.DMatrix(f"!{svm}#{tmp_path / 'h'}")
    assert isinstance(d_page, TExt) and not d_page.half_ram
    assert isinstance(d_half, TExt) and d_half.half_ram
    b1 = xt.train(PARAMS, d_page, 3, device="cpu")
    b2 = xt.train(PARAMS, d_half, 3, device="cpu")
    np.testing.assert_array_equal(b1.predict(d_page), b2.predict(d_half))
    assert not os.path.exists(str(tmp_path / "h") + ".binned")
    bj = xj.train(PARAMS, xj.DMatrix(f"!{svm}#{tmp_path / 'hj'}"), 3,
                  verbose_eval=False)
    assert_models_match(bj, b2)


def test_dmatrix_routes_refuse_in_memory_fields(tmp_path):
    X, y = make_data(50, 3, seed=9)
    svm = write_svm(tmp_path / "r.svm", X, y)
    for kw in ({"base_margin": np.zeros(50)}, {"group": [50]},
               {"num_col": 3}, {"feature_names": ["a", "b", "c"]}):
        with pytest.raises(ValueError, match="external-memory"):
            xt.DMatrix(f"ext:{svm}#{tmp_path / 'c'}", **kw)
    d = xt.DMatrix(f"ext:{svm}#{tmp_path / 'c'}", y * 2)
    np.testing.assert_array_equal(d.get_label(), y * 2)
    # '!' without '#cache' is a plain file name, as in the reference
    with pytest.raises(FileNotFoundError):
        xt.DMatrix(f"!{svm}")


def test_in_budget_matrix_collapses_to_the_in_memory_path(tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("XGBTPU_EXT_DEVICE_CACHE_MB")
    X, y = make_data(2500, 8, seed=10)
    dj, dt = both(tmp_path, X, y, 300, 512, "ib")
    bj, bt, rj, rt = train_both(PARAMS, dj, dt, 4)
    entry = bt._cache[id(dt)]
    assert not entry.external and entry.binned.shape == (2500, 8)
    assert_models_match(bj, bt)
    assert rj == rt


@pytest.mark.parametrize("case", ["refresh", "exact", "num_roots", "slice"])
def test_paged_refusals(tmp_path, case):
    X, y = make_data(600, 5, seed=11)
    dt = TExt(chunked(X, y, 200), cache=str(tmp_path / case),
              page_rows=256)
    with pytest.raises(NotImplementedError):
        if case == "refresh":
            bst = xt.train(PARAMS, dt, 1, device="cpu")
            bst.set_param({"updater": "refresh"})
            bst.update(dt, 1)
        elif case == "exact":
            bst = xt.train({**PARAMS, "updater": "grow_colmaker"},
                           xt.DMatrix(X, label=y), 1, device="cpu")
            bst.predict(dt)
        elif case == "num_roots":
            xt.train({**PARAMS, "num_roots": 2}, dt, 1, device="cpu")
        else:
            dt.slice(np.arange(10))


def test_paged_gblinear_is_refused(tmp_path):
    X, y = make_data(300, 4, seed=12)
    dt = TExt(chunked(X, y, 100), cache=str(tmp_path / "lin"))
    with pytest.raises(NotImplementedError, match="gblinear"):
        xt.train({"booster": "gblinear"}, dt, 1, device="cpu")


# ---------------------------------------------------------- the prefetch
def test_prefetch_exception_and_early_close():
    """The prefetcher relays the worker's exception to the consumer and
    joins its worker when the consumer stops early
    (``tests/test_external.py:280``)."""
    from xgboost_tpu_torch.external import _prefetch_to_device
    batches = [(i, np.full((4, 3), i, np.uint8)) for i in range(5)]
    for depth in (0, 1, 2):
        got = list(_prefetch_to_device(iter(batches), "cpu", depth))
        assert [s for s, _ in got] == [0, 1, 2, 3, 4]
        for (_, a), (_, b) in zip(batches, got):
            np.testing.assert_array_equal(a, b.numpy())

    def bad():
        yield 0, np.zeros((4, 3), np.uint8)
        raise RuntimeError("disk gone")
    it = _prefetch_to_device(bad(), "cpu", 2)
    next(it)
    with pytest.raises(RuntimeError, match="disk gone"):
        next(it)

    before = {t.ident for t in threading.enumerate()}
    it = _prefetch_to_device(iter(batches), "cpu", 2)
    next(it)
    it.close()
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.is_alive()]
    assert not leaked, leaked


def test_prefetch_switch_keeps_the_model_bytes(tmp_path, monkeypatch):
    """``XGBTPU_EXT_PREFETCH`` picks the worker (default, "1") or the
    synchronous staging ("0") of a streamed matrix; both grow the same
    model bytes, and every batch passes in order."""
    from xgboost_tpu_torch import external
    monkeypatch.setenv("XGBTPU_EXT_DEVICE_CACHE_MB", "0")
    X, y = make_data(3000, 6, seed=13)
    d = TExt(chunked(X, y, 1000), cache=str(tmp_path / "pf"),
             page_rows=1000)
    params = {"objective": "binary:logistic", "max_depth": 3,
              "max_bin": 32}
    forms, raws = [], []
    real = external._prefetch_to_device
    monkeypatch.setattr(external, "_prefetch_to_device",
                        lambda b, dev, depth: forms.append(depth)
                        or real(b, dev, depth))
    for switch in ("1", "0"):
        monkeypatch.setenv("XGBTPU_EXT_PREFETCH", switch)
        del forms[:]
        bst = xt.train(params, d, 2, device="cpu")
        assert bst._cache[id(d)].external
        assert forms and set(forms) == {2 if switch == "1" else 0}
        assert [s for s, _ in d.device_batches("cpu")] == [0, 1000, 2000]
        raws.append(bst.save_raw())
    assert raws[0] == raws[1]


# ------------------------------------------------------- native and IO
def _write_libsvm(path, n=500, f=12, seed=0, sparsity=0.4):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        label = rng.randint(0, 2)
        feats = [f"{j}:{rng.rand():.6f}" for j in range(f)
                 if rng.rand() > sparsity]
        lines.append(f"{label} {' '.join(feats)}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_native_library_builds_under_the_package():
    assert tnat.available()
    assert str(tnat._target()).startswith(str(tnat.BUILD_DIR))


def test_native_parser_equals_the_python_parser(tmp_path):
    from xgboost_tpu_torch.data import parse_libsvm_python
    path = _write_libsvm(tmp_path / "a.svm")
    got = tnat.parse_libsvm_native(path)
    for g, w in zip(got, parse_libsvm_python(path)):
        np.testing.assert_array_equal(g, w)
    for a, b in zip(got, tnat.parse_libsvm_native(path, nthread=5)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tnat.parse_libsvm_native(str(tmp_path / "nope.svm"))
    bad = tmp_path / "bad.svm"
    bad.write_text("1 3:abc\n")
    with pytest.raises(ValueError):
        tnat.parse_libsvm_native(str(bad))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_page_files_cross_packages(tmp_path, writer):
    rng = np.random.RandomState(1)
    pages = []
    for n in (7, 1, 30):
        counts = rng.randint(0, 5, n)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        pages.append((indptr, rng.randint(0, 9, indptr[-1]).astype(np.int32),
                      rng.rand(indptr[-1]).astype(np.float32)))
    path = str(tmp_path / "p.pages")
    W, R = ((jnat.PageWriter, tnat.PageReader) if writer == "jax"
            else (tnat.PageWriter, jnat.PageReader))
    with W(path) as w:
        for p in pages:
            w.push(*p)
    with R(path) as r:
        got = list(r)
    assert len(got) == len(pages)
    for g, p in zip(got, pages):
        for a, b in zip(g, p):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tnat.PageWriter(str(tmp_path / "e.pages")).push(
            np.zeros(0, np.int64), np.zeros(0, np.int32),
            np.zeros(0, np.float32))


def test_remote_cat_override_trains_and_cache_skips(tmp_path, monkeypatch):
    X, y = make_data(400, 5, seed=14)
    local = write_svm(tmp_path / "train.svm", X, y)
    fetcher = tmp_path / "fake_s3_cat.sh"
    fetcher.write_text(f"#!/bin/sh\nexec cat {local}\n")
    fetcher.chmod(fetcher.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("XGBTPU_REMOTE_CAT", str(fetcher))
    cache = tmp_path / "c"
    d = xt.DMatrix(f"s3://fake-bucket/train.svm#{cache}")
    ref = xt.DMatrix(local)
    assert (d.num_row, d.num_col) == (ref.num_row, ref.num_col)
    np.testing.assert_array_equal(d.values, ref.values)
    bst = xt.train({"objective": "binary:logistic", "max_depth": 2}, d, 1,
                   device="cpu")
    assert len(bst.predict(d)) == d.num_row
    monkeypatch.setenv("XGBTPU_REMOTE_CAT", "/nonexistent-fetcher")
    d2 = xt.DMatrix(f"s3://fake-bucket/train.svm#{cache}")
    assert d2.num_row == d.num_row
    with pytest.raises(ValueError, match="fetching"):
        xt.DMatrix("s3://fake-bucket/other.svm")


@pytest.mark.parametrize("uri", ["nosuchscheme://bucket/x.svm",
                                 "nosuchscheme://bucket/x.svm#cache"])
def test_unknown_opener_names_all_seams(monkeypatch, uri):
    """A scheme no opener knows (fsspec has no driver for it, so nothing
    is contacted) raises the JAX package's error, naming all three
    seams."""
    monkeypatch.delenv("XGBTPU_REMOTE_CAT", raising=False)
    with pytest.raises(ValueError, match="XGBTPU_REMOTE_CAT") as ej:
        xj.DMatrix(uri)
    with pytest.raises(ValueError, match="XGBTPU_REMOTE_CAT") as et:
        xt.DMatrix(uri)
    assert "fsspec" in str(et.value)
    assert str(et.value) == str(ej.value)


# ------------------------------------------------------------- the CLI
def test_cli_trains_an_ext_matrix_like_jax(tmp_path):
    from xgboost_tpu.cli import main as jax_main
    from xgboost_tpu_torch.cli import main as port_main
    X, y = make_data(1200, 6, seed=15)
    svm = write_svm(tmp_path / "train.svm", X, y)
    lines = []
    for name, main, extra in (("j", jax_main, []),
                              ("t", port_main, ["device=cpu"])):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(
            "task = train\nobjective = binary:logistic\nmax_depth = 3\n"
            f"eta = 0.5\nnum_round = 3\ndata = ext:{svm}#{tmp_path / name}\n"
            f"eval[train] = ext:{svm}#{tmp_path / (name + 'e')}\n"
            f"model_out = {tmp_path / (name + '.model')}\nsilent = 1\n")
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            assert main([str(conf), *extra]) == 0
        lines.append([ln for ln in err.getvalue().splitlines()
                      if ln.startswith("[")])
    assert lines[0] and lines[0] == lines[1]
    sj = xj.Booster(model_file=str(tmp_path / "j.model")).gbtree.get_state()
    st = xt.Booster(model_file=str(tmp_path / "t.model"),
                    device="cpu").gbtree.get_state()
    for k in STRUCT:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


def test_streamed_lanes_decline_with_the_jax_reason(tmp_path):
    X, y = make_data(800, 5, seed=16)
    dj, dt = both(tmp_path, X, y, 200, 256, "ln")
    bj = xj.Booster(PARAMS, cache=[dj])
    bt = xt.Booster(PARAMS, cache=[dt], device="cpu")
    (sj, rj), (st, rt) = bj.fused_lane_spec(dj, 0, 2), \
        bt.fused_lane_spec(dt, 0, 2)
    assert sj is None and st is None and rt == rj == "external_train"
