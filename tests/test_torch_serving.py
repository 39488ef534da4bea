"""The port's serving stack (``xgboost_tpu_torch.serving``) on the CPU,
mirroring ``tests/test_serving.py``'s cases, against the port's own
``Booster.predict`` and against the JAX package's serving stack on the
same model files.

Comparisons and why:
- engine predictions and margins against the port's ``Booster.predict``:
  BYTES (``tobytes``): the engine runs the same quantization, traversal
  and transform on the same rows;
- engine margins against the JAX ``PredictEngine``'s: bytes for one
  output group (both add each tree's leaf value to its column in tree
  order), values (``np.array_equal``) for several groups, where the JAX
  one-hot sum can turn a -0.0 into +0.0 (tests/test_torch_predict_chunk.py);
- transformed outputs against the JAX engine's: within 4 ulp, since
  XLA's ``exp`` and torch's round differently in the last bits;
- HTTP responses: predictions through JSON (``repr`` of a float32 read
  back), equal to the engine's and, within the same 4 ulp, to the JAX
  server's; the JSON keys of both servers equal.

On the CPU the engine runs its margin function eagerly, one build per
bucket (``compile_count``); the CUDA graphs are held against it in
``tests/test_torch_cuda.py``.  Every server and thread has a timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch.serving import (FeatureStore,  # noqa: E402
                                       FeatureStoreMiss, MicroBatcher,
                                       ModelRegistry, PredictEngine,
                                       QueueFull, power_of_two_buckets,
                                       predict_by_id, run_server)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
F = 6
BUCKETS = dict(min_bucket=8, max_bucket=16)


def _train(seed=0, rounds=5, **params):
    rng = np.random.RandomState(seed)
    X = rng.rand(300, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    p = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.4,
         "seed": seed, **params}
    return xt.train(p, xt.DMatrix(X, label=y), rounds, device="cpu"), X


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    bst, X = _train()
    path = str(tmp_path_factory.mktemp("serving") / "model.bin")
    bst.save_model(path)
    return bst, X, path


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    rng = np.random.RandomState(3)
    X = rng.rand(200, 5).astype(np.float32)
    y = rng.randint(0, 3, 200).astype(np.float32)
    bst = xt.train({"objective": "multi:softprob", "num_class": 3,
                    "max_depth": 3}, xt.DMatrix(X, label=y), 3,
                   device="cpu")
    path = str(tmp_path_factory.mktemp("serving") / "multi.bin")
    bst.save_model(path)
    return bst, X, path


def _ref(bst, X, **kw):
    return bst.predict(xt.DMatrix(X), **kw)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# --------------------------------------------------------------- engine
def test_engine_bitwise_parity_all_buckets(model):
    bst, _, path = model
    eng = PredictEngine(path, device="cpu", **BUCKETS)
    assert eng.buckets == [8, 16]
    rng = np.random.RandomState(1)
    for n in (1, 5, 7, 8, 9, 15, 16, 17, 40):      # 17, 40: top-bucket chunks
        Xq = rng.rand(n, F).astype(np.float32)
        assert _same(eng.predict(Xq), _ref(bst, Xq)), n
        assert _same(eng.predict(Xq, output_margin=True),
                     _ref(bst, Xq, output_margin=True)), n


@pytest.mark.parametrize("chunk", ["0", "8"])
def test_engine_margins_equal_the_jax_engine(model, chunk, monkeypatch):
    """The port's engine and the JAX package's on one model file: margins
    byte for byte (one group), predictions within 4 ulp."""
    _, _, path = model
    monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", chunk)
    from xgboost_tpu.serving import PredictEngine as JaxEngine
    eng = PredictEngine(path, device="cpu", **BUCKETS)
    jeng = JaxEngine(path, **BUCKETS)
    rng = np.random.RandomState(2)
    for n in (3, 16, 21):
        Xq = rng.rand(n, F).astype(np.float32)
        Xq[Xq < 0.1] = np.nan
        assert _same(eng.predict(Xq, output_margin=True),
                     np.asarray(jeng.predict(Xq, output_margin=True)))
        np.testing.assert_array_max_ulp(eng.predict(Xq),
                                        np.asarray(jeng.predict(Xq)), 4)


def test_engine_multiclass_parity(multi):
    bst, _, path = multi
    eng = PredictEngine(bst, **BUCKETS)
    rng = np.random.RandomState(3)
    Xq = rng.rand(11, 5).astype(np.float32)
    got = eng.predict(Xq)
    assert got.shape == (11, 3) and _same(got, _ref(bst, Xq))
    assert eng.predict(np.zeros((0, 5), np.float32)).shape == (0, 3)
    from xgboost_tpu.serving import PredictEngine as JaxEngine
    jm = np.asarray(JaxEngine(path, **BUCKETS).predict(
        Xq, output_margin=True))
    assert np.array_equal(eng.predict(Xq, output_margin=True), jm)
    # multi:softmax squeezes to (n,), empty batches included
    bst.set_param("objective", "multi:softmax")
    try:
        eng2 = PredictEngine(bst, **BUCKETS)
        cls = eng2.predict(Xq)
        assert cls.shape == (11,) and _same(cls, _ref(bst, Xq))
        assert eng2.predict(np.zeros((0, 5), np.float32)).shape == (0,)
    finally:
        bst.set_param("objective", "multi:softprob")


def test_engine_empty_batch_shapes(model):
    _, _, path = model
    eng = PredictEngine(path, device="cpu", **BUCKETS)
    empty = np.zeros((0, F), np.float32)
    assert eng.predict(empty).shape == (0,)
    assert eng.predict(empty, output_margin=True).shape == (0,)
    assert eng.compile_count == 0        # no bucket built for nothing


def test_engine_missing_and_narrow_rows(model):
    bst, _, path = model
    rng = np.random.RandomState(4)
    Xq = rng.rand(10, F).astype(np.float32)
    Xq[Xq < 0.2] = np.nan
    narrow = rng.rand(6, 4).astype(np.float32)
    eng = PredictEngine(path, device="cpu", **BUCKETS)
    assert eng.describe()["fused"] is True
    assert _same(eng.predict(Xq), _ref(bst, Xq))
    assert _same(eng.predict(narrow),
                 bst.predict(xt.DMatrix(narrow, num_col=F)))
    with pytest.raises(ValueError, match="features"):
        eng.predict(rng.rand(2, F + 1).astype(np.float32))


def test_two_step_env_switch(model, monkeypatch):
    """The JAX package's two-step form (host quantization) is not
    ported: ``XGBTPU_SERVE_FUSED=0`` raises, ``1`` serves fused."""
    bst, X, path = model
    monkeypatch.setenv("XGBTPU_SERVE_FUSED", "0")
    with pytest.raises(NotImplementedError, match="two-step"):
        PredictEngine(path, device="cpu", **BUCKETS)
    monkeypatch.setenv("XGBTPU_SERVE_FUSED", "1")
    eng = PredictEngine(path, device="cpu", **BUCKETS)
    assert _same(eng.predict(X[:9]), _ref(bst, X[:9]))


def test_zero_builds_after_warmup(model):
    _, _, path = model
    eng = PredictEngine(path, device="cpu", warmup=True, **BUCKETS)
    assert eng.num_compiled == len(eng.buckets) == eng.compile_count
    rng = np.random.RandomState(5)
    c0 = eng.compile_count
    for n in rng.randint(1, 40, size=60):
        eng.predict(rng.rand(n, F).astype(np.float32))
    assert eng.compile_count == c0
    d = eng.describe()
    assert d["compiled"] == [8, 16] and d["graphs"] is False
    assert eng.device_bytes() > 0


def test_warmup_does_not_pollute_row_counters(model):
    from xgboost_tpu_torch.profiling import ServingMetrics
    _, _, path = model
    m = ServingMetrics()
    eng = PredictEngine(path, device="cpu", metrics=m, warmup=True,
                        **BUCKETS)
    assert m.rows.value == 0 and m.padded_rows.value == 0
    assert m.compiles.value == len(eng.buckets)
    eng.predict(np.zeros((3, F), np.float32))
    assert m.rows.value == 3 and m.padded_rows.value == 5


def test_concurrent_predicts_share_buckets(model):
    """24 threads on one engine's two buckets, with a short switch
    interval: the bucket lock keeps each caller's rows and answer
    together (a lost update would hand a caller another's rows)."""
    bst, X, path = model
    eng = PredictEngine(path, device="cpu", warmup=True, **BUCKETS)
    want = {n: _ref(bst, X[n:2 * n]) for n in range(1, 17)}
    bad = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        for _ in range(15):
            n = int(rng.randint(1, 17))
            if not _same(eng.predict(X[n:2 * n]), want[n]):
                bad.append((seed, n))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert not bad, bad[:5]
    assert eng.compile_count == 2


def test_released_engine_builds_again(model):
    bst, X, path = model
    eng = PredictEngine(path, device="cpu", warmup=True, **BUCKETS)
    c0 = eng.compile_count
    eng.release()
    assert eng.num_compiled == 0
    assert _same(eng.predict(X[:4]), _ref(bst, X[:4]))
    assert eng.compile_count == c0 + 1


def test_engine_rejects_gblinear(tmp_path):
    rng = np.random.RandomState(6)
    X = rng.rand(60, 4).astype(np.float32)
    jb = xj.train({"booster": "gblinear", "objective": "reg:linear",
                   "silent": 1}, xj.DMatrix(X, label=X[:, 0]), 2)
    path = str(tmp_path / "lin.bin")
    jb.save_model(path)
    with pytest.raises(NotImplementedError, match="gblinear"):
        PredictEngine(path, device="cpu")


def test_engine_defaults_to_the_gpu(model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PredictEngine(model[2])


def test_bucket_ladder():
    from xgboost_tpu.serving import power_of_two_buckets as jax_ladder
    for lo, hi in ((8, 64), (1, 1), (8, 100), (9, 10), (8, 8192)):
        assert power_of_two_buckets(lo, hi) == jax_ladder(lo, hi)
    assert power_of_two_buckets(8, 8192) == [8 << i for i in range(11)]
    with pytest.raises(ValueError):
        power_of_two_buckets(16, 8)


# -------------------------------------------------------------- batcher
def test_batcher_coalesces_concurrent_requests():
    calls = []

    def predict_fn(X, output_margin=False):
        calls.append(X.shape[0])
        time.sleep(0.01)
        return X[:, 0].copy()

    b = MicroBatcher(predict_fn, max_batch_rows=100, max_wait_ms=50,
                     max_queue_rows=1000)
    try:
        results = [None] * 6
        barrier = threading.Barrier(6)

        def worker(i):
            barrier.wait(5.0)
            results[i] = b.submit(np.full((2, 3), float(i), np.float32),
                                  timeout=10.0)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10.0)
        for i, r in enumerate(results):
            assert np.array_equal(r, np.full(2, float(i), np.float32))
        assert len(calls) < 6, f"no coalescing: {calls}"
        assert sum(calls) == 12
    finally:
        b.close()


def test_batcher_backpressure_queuefull():
    from xgboost_tpu_torch.profiling import ServingMetrics
    release = threading.Event()
    metrics = ServingMetrics()

    def predict_fn(X, output_margin=False):
        release.wait(5.0)
        return np.zeros(X.shape[0], np.float32)

    b = MicroBatcher(predict_fn, max_batch_rows=4, max_wait_ms=1,
                     max_queue_rows=10, metrics=metrics)
    try:
        t = threading.Thread(target=lambda: b.submit(np.zeros((4, 2)),
                                                     timeout=10.0))
        t.start()
        time.sleep(0.05)
        t2 = threading.Thread(target=lambda: b.submit(np.zeros((8, 2)),
                                                      timeout=10.0))
        t2.start()
        time.sleep(0.05)
        with pytest.raises(QueueFull):
            b.submit(np.zeros((5, 2)))
        assert metrics.requests.value == 3
        assert metrics.rejected.value == 1
        release.set()
        t.join(5.0)
        t2.join(5.0)
    finally:
        release.set()
        b.close()


def test_batcher_admits_oversized_request_when_idle():
    b = MicroBatcher(lambda X, output_margin=False: X[:, 0].copy(),
                     max_batch_rows=8, max_wait_ms=1, max_queue_rows=10)
    try:
        big = np.arange(50, dtype=np.float32).reshape(25, 2)
        assert np.array_equal(b.submit(big, timeout=10.0), big[:, 0])
    finally:
        b.close()


def test_batcher_error_propagates_to_all_callers():
    gate = threading.Event()

    def predict_fn(X, output_margin=False):
        gate.wait(5.0)
        raise RuntimeError("boom")

    b = MicroBatcher(predict_fn, max_batch_rows=100, max_wait_ms=100)
    errors = []

    def worker():
        try:
            b.submit(np.zeros((2, 2)), timeout=10.0)
        except RuntimeError as e:
            errors.append(str(e))
    try:
        ts = [threading.Thread(target=worker) for _ in range(3)]
        for t in ts:
            t.start()
        time.sleep(0.05)
        gate.set()
        for t in ts:
            t.join(10.0)
    finally:
        gate.set()
        b.close()
    assert errors == ["boom"] * 3


def test_batcher_tenant_weighted_round_robin():
    gate = threading.Event()
    order = []

    def predict_fn(X, output_margin=False):
        gate.wait(5.0)
        return X[:, 0].copy()

    b = MicroBatcher(predict_fn, max_batch_rows=2, max_wait_ms=1,
                     max_queue_rows=1000)
    b.set_tenant_weight("heavy", 2.0)
    orig = b._next_request

    def spy():
        req = orig()
        order.append(req.tenant)
        return req

    b._next_request = spy
    try:
        def worker(tenant):
            b.submit(np.zeros((2, 3), np.float32), tenant=tenant,
                     timeout=10)

        warm = threading.Thread(target=worker, args=("warm",))
        warm.start()
        time.sleep(0.1)
        ts = [threading.Thread(target=worker, args=("heavy",))
              for _ in range(6)]
        for t in ts:
            t.start()
        time.sleep(0.1)
        tl = [threading.Thread(target=worker, args=("light",))
              for _ in range(3)]
        for t in tl:
            t.start()
        time.sleep(0.1)
        gate.set()
        for t in [warm] + ts + tl:
            t.join(10.0)
    finally:
        gate.set()
        b.close()
    assert order == ["warm", "heavy", "light", "heavy", "heavy", "light",
                     "heavy", "heavy", "light", "heavy"]
    from xgboost_tpu_torch.obs.metrics import tenant_dequeues
    rendered = tenant_dequeues().render()
    assert 'xgbtpu_batcher_tenant_dequeues_total{model="heavy"}' in rendered


def test_batcher_drops_expired_deadlines():
    from xgboost_tpu_torch.obs import reliability_metrics
    from xgboost_tpu_torch.reliability.deadline import (Deadline,
                                                        DeadlineExceeded)
    gate = threading.Event()
    calls = []

    def predict_fn(X, output_margin=False):
        calls.append(X.shape[0])
        gate.wait(5.0)
        return X[:, 0].copy()

    b = MicroBatcher(predict_fn, max_batch_rows=2, max_wait_ms=1,
                     max_queue_rows=100)
    rm = reliability_metrics()
    d0 = rm.deadline_dropped.value + rm.shed_requests.value
    try:
        t = threading.Thread(target=lambda: b.submit(np.zeros((2, 2)),
                                                     timeout=10.0))
        t.start()
        time.sleep(0.05)                 # the worker blocks on the gate
        out = {}

        def late():
            try:
                b.submit(np.zeros((2, 2)), deadline=Deadline(150.0))
            except DeadlineExceeded as e:
                out["err"] = e
        t2 = threading.Thread(target=late)
        t2.start()
        time.sleep(0.17)                 # its 150 ms budget runs out
        gate.set()
        t.join(10.0)
        t2.join(10.0)
    finally:
        gate.set()
        b.close()
    assert isinstance(out.get("err"), DeadlineExceeded)
    assert calls == [2]                  # the expired request never ran
    # dropped at flush while its caller waits (the usual case), or shed
    # when the caller's own wait, budget + 50 ms, ran out first
    assert rm.deadline_dropped.value + rm.shed_requests.value - d0 == 1


# ------------------------------------------------------------- registry
def test_hot_reload_swap_and_rollback(model, tmp_path):
    bst_a, X, _ = model
    path = str(tmp_path / "m.bin")
    bst_a.save_model(path)
    reg = ModelRegistry(path, keep_versions=2, warmup=False, poll_sec=0,
                        device="cpu", **BUCKETS)
    Xq = X[:10]
    ref_a = _ref(bst_a, Xq)
    assert reg.version == 1 and _same(np.asarray(reg.predict(Xq)), ref_a)
    bst_a.save_model(path)
    assert reg.check_reload() is False and reg.version == 1
    bst_b, _ = _train(seed=9, rounds=7, max_depth=2)
    bst_b.save_model(path)
    ref_b = _ref(bst_b, Xq)
    assert reg.check_reload() is True and reg.version == 2
    assert _same(np.asarray(reg.predict(Xq)), ref_b)
    assert reg.rollback() is True
    assert _same(np.asarray(reg.predict(Xq)), ref_a)
    assert reg.check_reload() is False
    assert reg.rollback() is True
    assert _same(np.asarray(reg.predict(Xq)), ref_b)
    reg0 = ModelRegistry(path, keep_versions=0, warmup=False, poll_sec=0,
                         device="cpu", **BUCKETS)
    assert reg0.rollback() is False


def test_ring_drops_release_their_buckets(model, tmp_path):
    """An engine that falls off the rollback ring releases its buckets."""
    bst_a, X, _ = model
    path = str(tmp_path / "m.bin")
    bst_a.save_model(path)
    reg = ModelRegistry(path, keep_versions=1, warmup=True, poll_sec=0,
                        device="cpu", **BUCKETS)
    first = reg.engine
    for seed in (21, 22):
        _train(seed=seed, rounds=2)[0].save_model(path)
        assert reg.check_reload()
    assert first.num_compiled == 0               # fell off: released
    assert reg.describe()["previous_versions"] == [2]


def test_catalog_eviction_releases_every_engine(model, tmp_path):
    """Evicting a model releases the graphs (on the CPU the buckets) of
    its live engine and of every engine in its rollback ring."""
    from xgboost_tpu_torch.catalog import ModelCatalog
    bst_a, X, _ = model
    path = str(tmp_path / "m.bin")
    bst_a.save_model(path)

    def factory(p):
        return ModelRegistry(p, keep_versions=2, warmup=True, poll_sec=0,
                             device="cpu", **BUCKETS)
    cat = ModelCatalog(registry_factory=factory)
    cat.add_model("default", str(tmp_path / "other.bin"),
                  registry=factory(path))
    cat.add_model("b", path)
    reg = cat.resolve("b").registry
    first = reg.engine
    _train(seed=23, rounds=2)[0].save_model(path)
    assert reg.check_reload()
    live = reg.engine
    assert first.num_compiled == live.num_compiled == len(first.buckets)
    assert cat.bytes_used() > 0
    assert cat.remove_model("b")
    assert first.num_compiled == live.num_compiled == 0
    assert cat.get("default").registry.engine.num_compiled == 2


def test_poisoned_file_and_reload_fault(model, tmp_path):
    from xgboost_tpu_torch.obs import reliability_metrics
    from xgboost_tpu_torch.reliability import faults
    bst_a, X, _ = model
    path = str(tmp_path / "m.bin")
    bst_a.save_model(path)
    reg = ModelRegistry(path, warmup=False, poll_sec=0, device="cpu",
                        **BUCKETS)
    ref_a = _ref(bst_a, X[:5])
    raw = bytearray(open(path, "rb").read())
    raw[100] ^= 0x10                              # a bit flip
    with open(path, "wb") as f:
        f.write(bytes(raw))
    n0 = reliability_metrics().poisoned_reloads.value
    assert reg.check_reload() is False
    assert reg.poisoned and "CRC32" in reg.last_reload_error
    assert reg.check_reload() is False            # skipped, not rebuilt
    assert reliability_metrics().poisoned_reloads.value - n0 == 1
    assert _same(np.asarray(reg.predict(X[:5])), ref_a)
    # the registry's reload seam: an injected fault keeps v1 serving
    _train(seed=5, rounds=3)[0].save_model(path)
    faults.inject("reload")
    try:
        assert reg.check_reload() is False
        assert "InjectedFault" in reg.last_reload_error
    finally:
        faults.clear_faults()
    assert reg.version == 1 and reg.check_reload(force=True) is True
    assert not reg.poisoned and reg.version == 2


def test_hot_reload_under_concurrent_requests(model, tmp_path):
    bst_a, X, _ = model
    path = str(tmp_path / "m.bin")
    bst_a.save_model(path)
    reg = ModelRegistry(path, warmup=True, poll_sec=0, device="cpu",
                        **BUCKETS)
    batcher = MicroBatcher(reg.predict, max_batch_rows=64, max_wait_ms=1,
                           max_queue_rows=100_000)
    bst_b, _ = _train(seed=11, rounds=6, max_depth=2)
    Xq = X[:7]
    ref_a, ref_b = _ref(bst_a, Xq), _ref(bst_b, Xq)
    assert not np.array_equal(ref_a, ref_b)
    stop = threading.Event()
    outputs, errors = [], []

    def hammer():
        while not stop.is_set():
            try:
                outputs.append(batcher.submit(Xq, timeout=10.0))
            except BaseException as e:  # noqa: BLE001 -- asserted below
                errors.append(e)
    try:
        ts = [threading.Thread(target=hammer) for _ in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.2)
        bst_b.save_model(path)
        assert reg.check_reload()
        post_swap = batcher.submit(Xq, timeout=30.0)
        stop.set()
        for t in ts:
            t.join(10.0)
    finally:
        stop.set()
        batcher.close()
    assert not errors, errors[:3]
    assert _same(np.asarray(post_swap), ref_b)
    assert post_swap.model_version == 2
    for o in outputs:
        expect = 1 if _same(np.asarray(o), ref_a) else 2
        assert _same(np.asarray(o), ref_a if expect == 1 else ref_b)
        assert o.model_version == expect


# --------------------------------------------------------- feature store
def test_featurestore_put_gather_evict_miss():
    from xgboost_tpu_torch.obs.metrics import featurestore_metrics
    fm = featurestore_metrics()
    store = FeatureStore(4, budget_mb=3 * 4 * 4 / (1 << 20), device="cpu")
    assert store.capacity == 3
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    e0 = fm.evictions.value
    assert store.put(["a", "b", "c"], rows) == {"stored": 3, "evicted": 0}
    X, missing = store.gather(["c", "a"], pad_to=4)
    assert missing == [] and X.shape == (4, 4)
    np.testing.assert_array_equal(X[:2].numpy(), rows[[2, 0]])
    assert np.isnan(X[2:].numpy()).all()       # the NaN padding row
    # "b" is now least recently used: a new entity evicts it
    assert store.put(["d"], np.ones((1, 2), np.float32))["evicted"] == 1
    assert fm.evictions.value - e0 == 1
    X, missing = store.gather(["b", "d"])
    assert X is None and missing == ["b"]
    X, _ = store.gather(["d"])
    assert np.isnan(X[0, 2:].numpy()).all()    # narrow rows NaN-padded
    # a repeated id keeps its last row
    store.put(["a", "a"], np.stack([rows[1], rows[2]]))
    np.testing.assert_array_equal(store.gather(["a"])[0][0].numpy(),
                                  rows[2])
    assert store.invalidate(["a", "zz"]) == 1 and len(store) == 2
    assert store.invalidate() == 2 and len(store) == 0
    with pytest.raises(ValueError):
        store.put(["x"], np.ones((1, 5), np.float32))


def test_predict_by_id_equals_predict_with_zero_upload(model):
    from xgboost_tpu_torch.obs.metrics import predict_metrics
    bst, X, path = model
    eng = PredictEngine(path, device="cpu", warmup=True, **BUCKETS)
    store = FeatureStore(F, budget_mb=1.0, device="cpu")
    ids = [f"u{i}" for i in range(37)]
    store.put(ids, X[:37])
    b0 = predict_metrics().transfer_bytes.value
    got = predict_by_id(eng, store, ids)
    gotm = predict_by_id(eng, store, ids[3:9], output_margin=True)
    assert predict_metrics().transfer_bytes.value == b0
    assert _same(got, eng.predict(X[:37]))
    assert _same(got, _ref(bst, X[:37]))
    assert _same(gotm, _ref(bst, X[3:9], output_margin=True))
    with pytest.raises(FeatureStoreMiss) as ei:
        predict_by_id(eng, store, ["u1", "nope", "gone"])
    assert ei.value.missing == ["nope", "gone"]
    assert predict_by_id(eng, store, []).shape == (0,)


# ----------------------------------------------------------------- http
def _post(url, body, timeout=30.0):
    return json.load(urllib.request.urlopen(urllib.request.Request(
        url, data=body, method="POST"), timeout=timeout))


def _get(url, timeout=30.0):
    return urllib.request.urlopen(url, timeout=timeout).read()


def test_http_roundtrip_both_packages(model, tmp_path):
    bst, X, _ = model
    path = str(tmp_path / "m.bin")
    bst.save_model(path)
    from xgboost_tpu.serving import run_server as jax_run_server
    kw = dict(port=0, min_bucket=8, max_bucket=16, max_wait_ms=1,
              poll_sec=0, warmup=False, quiet=True, block=False,
              featurestore_mb=1.0)
    srv = run_server(path, device="cpu", **kw)
    jsrv = jax_run_server(path, **kw)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        jbase = f"http://127.0.0.1:{jsrv.port}"
        Xq = np.round(X[:5], 6)
        body = "\n".join(",".join(f"{v:.6f}" for v in row)
                         for row in Xq).encode()
        resp, jresp = _post(base + "/predict", body), \
            _post(jbase + "/predict", body)
        assert set(resp) == set(jresp)
        assert resp["rows"] == 5 and resp["model_version"] == 1
        assert resp["model"] == jresp["model"] == "default"
        ref = _ref(bst, Xq)
        assert _same(np.asarray(resp["predictions"], np.float32), ref)
        np.testing.assert_array_max_ulp(
            np.asarray(resp["predictions"], np.float32),
            np.asarray(jresp["predictions"], np.float32), 4)
        respm = _post(base + "/predict?output_margin=1", body)
        jrespm = _post(jbase + "/predict?output_margin=1", body)
        assert respm["predictions"] == jrespm["predictions"]
        lib = "\n".join("1 " + " ".join(f"{j}:{v:.6f}"
                                        for j, v in enumerate(row))
                        for row in Xq).encode()
        assert _post(base + "/predict?format=libsvm", lib)["predictions"] \
            == resp["predictions"]
        # feature store routes
        put = json.dumps({"ids": ["a", "b"],
                          "rows": Xq[:2].tolist()}).encode()
        p1, p2 = _post(base + "/featurestore/put", put), \
            _post(jbase + "/featurestore/put", put)
        assert set(p1) == set(p2) and p1["stored"] == 2
        byid = json.dumps({"ids": ["b", "a"]}).encode()
        r1, r2 = _post(base + "/predict_by_id", byid), \
            _post(jbase + "/predict_by_id", byid)
        assert set(r1) == set(r2)
        assert r1["predictions"] == [resp["predictions"][1],
                                     resp["predictions"][0]]
        # healthz and metrics
        h = json.loads(_get(base + "/healthz"))
        jh = json.loads(_get(jbase + "/healthz"))
        assert set(h) == set(jh)
        assert h["status"] == "ok" and h["model_version"] == 1
        mtext = _get(base + "/metrics").decode()
        for metric in ("xgbtpu_serving_requests_total",
                       "xgbtpu_serving_batch_rows_bucket",
                       "xgbtpu_serving_padded_rows_total",
                       "xgbtpu_serving_queue_rows",
                       "xgbtpu_serving_latency_seconds_bucket",
                       "xgbtpu_serving_latency_p99_seconds",
                       "xgbtpu_serving_model_version",
                       "xgbtpu_predict_transfer_bytes_total",
                       "xgbtpu_featurestore_hits_total",
                       "xgbtpu_catalog_requests_total",
                       "xgbtpu_reliability_shed_requests_total"):
            assert metric in mtext, f"{metric} missing from /metrics"
        # errors: 400 empty, 400 too wide, 404 route, 404 unknown model
        for url, data, code in ((base + "/predict", b"", 400),
                                (base + "/predict",
                                 ",".join(["0.5"] * 9).encode(), 400),
                                (base + "/predict?model=zz", body, 404),
                                (base + "/predict_by_id",
                                 json.dumps({"ids": ["q"]}).encode(), 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, data)
            assert ei.value.code == code, url
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nope")
        assert ei.value.code == 404
        # reload and rollback routes
        _train(seed=33, rounds=3)[0].save_model(path)
        assert _post(base + "/-/reload", b"") == {"reloaded": True,
                                                   "model_version": 2}
        assert _post(base + "/-/rollback", b"")["rolled_back"] is True
        assert _post(base + "/predict", body)["predictions"] \
            == resp["predictions"]
    finally:
        srv.shutdown()
        jsrv.shutdown()


def test_drain_answers_503_then_stops(model, tmp_path):
    bst, X, _ = model
    path = str(tmp_path / "m.bin")
    bst.save_model(path)
    srv = run_server(path, port=0, min_bucket=8, max_bucket=16,
                     poll_sec=0, warmup=False, quiet=True, block=False,
                     device="cpu")
    assert srv.enter_request()
    srv.exit_request()
    dur = srv.drain(grace=5.0)
    assert srv.state == "stopped" and dur < 5.0
    assert not srv.enter_request()


@pytest.mark.parametrize("kw", [{"router_url": "http://127.0.0.1:1"},
                                {"replica_id": "r1"},
                                {"advertise_url": "http://127.0.0.1:2"}])
def test_router_url_names_the_fleet_item(model, kw):
    with pytest.raises(NotImplementedError, match="item 14b"):
        run_server(model[2], block=False, device="cpu", **kw)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_module_server_on_the_cpu(model, tmp_path):
    """``python -m xgboost_tpu_torch.serving --device cpu``: /healthz,
    /predict and /metrics, then SIGTERM drains it."""
    bst, X, _ = model
    path = str(tmp_path / "m.bin")
    bst.save_model(path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch.serving", "--model", path,
         "--port", str(port), "--device", "cpu", "--min-bucket", "8",
         "--max-bucket", "16", "--warmup", "0", "--poll-sec", "0",
         "--quiet"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"
    try:
        t_end = time.time() + 60
        while True:
            try:
                h = json.loads(_get(base + "/healthz", timeout=2.0))
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                if time.time() > t_end or proc.poll() is not None:
                    raise AssertionError(proc.stderr.read().decode()[-2000:])
                time.sleep(0.2)
        assert h["status"] == "ok"
        body = "\n".join(",".join(repr(float(v)) for v in row)
                         for row in X[:3]).encode()
        got = np.asarray(_post(base + "/predict", body)["predictions"],
                         np.float32)
        assert _same(got, _ref(bst, X[:3]))
        assert b"xgbtpu_serving_requests_total 1" in _get(base + "/metrics")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


# ------------------------------------------------------------------ cli
def test_cli_usage_lists_serve_params(capsys):
    from xgboost_tpu_torch.cli import main as cli_main
    assert cli_main([]) == 0
    out = capsys.readouterr().out
    for name in ("serve_port", "serve_max_batch_rows", "serve_max_wait_ms",
                 "serve_poll_sec", "serve_keep_versions",
                 "serve_featurestore_mb", "catalog_default",
                 "serve_catalog_mb"):
        assert name in out, f"{name} missing from CLI usage"
    assert "faults=" in out and "item 14b" in out


def test_serving_main_parser_builds():
    from xgboost_tpu_torch.serving.__main__ import _build_parser
    args = _build_parser().parse_args(
        ["--model", "m.bin", "--port", "0", "--max-wait-ms", "5",
         "--device", "cpu"])
    assert args.model == "m.bin" and args.port == 0
    assert args.max_wait_ms == 5.0 and args.device == "cpu"


def test_task_serve_routes_to_run_server(model, tmp_path, monkeypatch):
    """``task=serve`` hands its serve_* and catalog parameters and the
    device to ``run_server``; a router URL raises naming item 14b."""
    from xgboost_tpu_torch import cli, serving
    seen = {}
    monkeypatch.setattr(serving, "run_server",
                        lambda path, **kw: seen.update(path=path, **kw))
    rc = cli.main(["task=serve", f"model_in={model[2]}", "device=cpu",
                   "serve_port=0", "serve_max_bucket=64",
                   "serve_featurestore_mb=2", "catalog_hysteresis_sec=1",
                   "silent=1"])
    assert rc == 0 and seen["path"] == model[2]
    assert seen["port"] == 0 and seen["max_bucket"] == 64
    assert seen["featurestore_mb"] == 2.0
    assert seen["catalog_hysteresis_sec"] == 1.0
    assert str(seen["device"]) == "cpu" and seen["block"] is True
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="item 14b"):
        cli.main(["task=serve", f"model_in={model[2]}", "device=cpu",
                  "serve_router_url=http://127.0.0.1:1"])
    with pytest.raises(ValueError, match="model_in"):
        cli.main(["task=serve", "device=cpu"])


def test_cli_faults_arms_the_registry(model, tmp_path):
    """``faults=`` arms the I/O seams: a bit flipped on read makes
    ``task=dump`` of a good model file fail its CRC check."""
    from xgboost_tpu_torch import cli
    from xgboost_tpu_torch.reliability import ModelIntegrityError, faults
    try:
        with pytest.raises(ModelIntegrityError, match="CRC32"):
            cli.main(["task=dump", f"model_in={model[2]}", "device=cpu",
                      f"name_dump={tmp_path / 'd.txt'}",
                      "faults=read_flip=200@model.bin"])
        assert faults.fired("read_flip") == 1
        assert cli.main(["task=dump", f"model_in={model[2]}",
                         "device=cpu",
                         f"name_dump={tmp_path / 'd.txt'}"]) == 0
    finally:
        faults.clear_faults()
