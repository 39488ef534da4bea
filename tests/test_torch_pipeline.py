"""The continuous-training pipeline of the PyTorch port
(``xgboost_tpu_torch.pipeline``): data sources, the eval gate, the
publisher, the checkpoint ring and ``ContinuousTrainer``, on the CPU,
held against the JAX package where both compute the same thing.

Tolerances and why:

- data sources: the same numpy arrays as the JAX package's, bitwise;
- gate verdicts on the same scores: equal dicts;
- auto segment sizes: equal integers (the same formula and constants);
- a resumed cycle against an uninterrupted one: model state bitwise
  (the port's own determinism, as ``tests/test_pipeline.py`` pins for
  the JAX package);
- the port's published models against the JAX package's, reg:linear:
  tree structure bitwise, leaf values at rtol 1e-5 (the node totals
  differ by f32 rounding, ROADMAP.md section 3).

Faults are injected by replacing the port's own write functions for
one call (the JAX package's fault injector is not ported).
"""

import hashlib
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch import cli  # noqa: E402
from xgboost_tpu_torch.obs import (configure_log,  # noqa: E402
                                   lane_metrics, pipeline_metrics,
                                   registry)
from xgboost_tpu_torch.pipeline import (CallableDataSource,  # noqa: E402
                                        ContinuousTrainer, EvalGate,
                                        FileDataSource, SyntheticDataSource)
from xgboost_tpu_torch.pipeline import publisher as pub_mod  # noqa: E402

PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.4,
          "silent": 1}


def make_trainer(workdir, publish, rounds=2, source=None, gate=None,
                 params=None, cls=ContinuousTrainer):
    source = source if source is not None else SyntheticDataSource(
        n_rows=300, n_features=6, seed=0)
    gate = gate if gate is not None else EvalGate(max_regression=0.5)
    return cls(str(publish), source, str(workdir), rounds_per_cycle=rounds,
               params=dict(params or PARAMS), gate=gate, quiet=True,
               device="cpu")


def gated_hashes(trainer):
    with open(trainer.gated_log) as f:
        return [line.split()[1] for line in f]


def file_hash(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def states_equal(a, b):
    sa, sb = a.gbtree.get_state(), b.gbtree.get_state()
    return set(sa) == set(sb) and all(np.array_equal(sa[k], sb[k])
                                      for k in sa)


# ----------------------------------------------------------- data sources
def test_synthetic_source_draws_the_jax_arrays():
    from xgboost_tpu.pipeline import SyntheticDataSource as JaxSource
    mine = SyntheticDataSource(n_rows=100, n_features=5, seed=7)
    ref = JaxSource(n_rows=100, n_features=5, seed=7)
    for cycle in (0, 3):
        (dt, dh), (jt, jh) = mine.next_cycle(cycle), ref.next_cycle(cycle)
        for a, b in ((dt, jt), (dh, jh)):
            assert a.num_row == b.num_row and a.num_col == b.num_col
            np.testing.assert_array_equal(a.dense_source()[0],
                                          b.to_dense())
            np.testing.assert_array_equal(a.get_label(), b.get_label())
    assert mine.next_cycle(1)[1] is mine.next_cycle(2)[1]   # one holdout


def test_file_and_callable_sources(tmp_path):
    rng = np.random.RandomState(0)

    def write(path, n):
        with open(path, "w") as f:
            for _ in range(n):
                x = rng.rand(3)
                f.write(f"{int(x[0] > 0.5)} " + " ".join(
                    f"{j}:{v:.4f}" for j, v in enumerate(x)) + "\n")
    write(tmp_path / "fresh-0.libsvm", 40)
    write(tmp_path / "hold.libsvm", 20)
    src = FileDataSource(str(tmp_path / "fresh-{cycle}.libsvm"),
                         str(tmp_path / "hold.libsvm"))
    dtrain, dhold = src.next_cycle(0)
    assert (dtrain.num_row, dhold.num_row) == (40, 20)
    assert src.next_cycle(1) is None           # no file for cycle 1 yet
    assert src.holdout_for(1) is dhold         # unchanged: not re-parsed
    call = CallableDataSource(lambda c: None if c else (dtrain, dhold))
    assert call.next_cycle(0) == (dtrain, dhold)
    assert call.holdout_for(1) is None


# ------------------------------------------------------------------ gate
class _Scored:
    """A stand-in booster whose holdout score is fixed."""

    def __init__(self, value, metric="auc"):
        self.value, self.metric = value, metric
        self.param = type("P", (), {"eval_metric": ()})()

    def eval_set(self, evals, iteration=0, feval=None):
        return f"[{iteration}]\tgate-{self.metric}:{self.value:.6f}"


@pytest.mark.parametrize("metric,cand,inc,kw", [
    ("auc", 0.80, 0.79, {}),
    ("auc", 0.78, 0.79, {}),
    ("auc", 0.78, 0.79, {"max_regression": 0.02}),
    ("rmse", 0.30, 0.31, {"min_delta": 0.005}),
    ("rmse", 0.30, 0.31, {"min_delta": 0.05}),
    ("logloss", 0.5, None, {}),
])
def test_gate_verdicts_equal_the_jax_gate(metric, cand, inc, kw):
    from xgboost_tpu.pipeline import EvalGate as JaxGate
    args = (_Scored(cand, metric),
            None if inc is None else _Scored(inc, metric), "holdout", 3)
    assert EvalGate(**kw).judge(*args) == JaxGate(**kw).judge(*args)
    cached = EvalGate(**kw).judge(args[0], None, "holdout", 3,
                                  incumbent_score=inc)
    assert cached == JaxGate(**kw).judge(args[0], None, "holdout", 3,
                                         incumbent_score=inc)


# ----------------------------------------------------- segments and rounds
def test_auto_segment_size_equals_the_jax_package():
    import xgboost_tpu as xj
    mine, ref = xt.Booster({}, device="cpu"), xj.Booster({})
    for n in (64, 5000, 16384, 10 ** 5, 10 ** 6, 10 ** 7):
        assert mine._resolve_rounds_per_dispatch(n) == \
            ref._resolve_rounds_per_dispatch(n), n
    for override in (0, 3):
        assert mine._resolve_rounds_per_dispatch(10, override) == override


def test_update_many_segments_end_where_the_callbacks_say(monkeypatch):
    rng = np.random.RandomState(4)
    X = rng.rand(300, 4).astype(np.float32)
    d = xt.DMatrix(X, label=(X[:, 0] > 0.5).astype(np.float32))

    def calls(params, n, **kw):
        seen = []
        b = xt.Booster(dict(PARAMS, **params), [d], device="cpu")
        b.update_many(d, 10, n, segment_callback=seen.append, **kw)
        return seen, b.save_raw()
    auto, raw = calls({}, 5)
    assert auto == [14]                          # one segment of 5 (auto)
    per2, raw2 = calls({"rounds_per_dispatch": 2}, 5)
    assert per2 == [11, 13, 14]
    assert calls({}, 5, rounds_per_dispatch=0)[0] == [10, 11, 12, 13, 14]
    assert calls({"gamma": 0.5}, 3)[0] == [10, 11, 12]   # prune: per round
    monkeypatch.setenv("XGBTPU_ROUNDS_PER_DISPATCH", "3")
    assert calls({}, 5)[0] == [12, 14]
    # segments only decide where the callbacks fall, not the trees
    b1, b2 = xt.Booster(device="cpu"), xt.Booster(device="cpu")
    b1.load_raw(raw2)
    b2.load_raw(raw)
    assert states_equal(b1, b2)


# ------------------------------------------------------------ the trainer
def test_cycles_publish_gate_and_ledger(tmp_path):
    pm = pipeline_metrics()
    p0, g0 = pm.publishes.value, pm.gate_pass.value
    publish = tmp_path / "published.model"
    tr = make_trainer(tmp_path / "wd", publish)
    summary = tr.run(cycles=2)
    assert summary["published"] == 2 and summary["errors"] == 0
    hashes = gated_hashes(tr)
    assert len(hashes) == 2 and file_hash(publish) == hashes[-1]
    assert file_hash(tr.backup_path) == hashes[-1]
    assert tr._read_state() == {"cycle": 2, "phase": "train"}
    assert not os.path.exists(tr.candidate_path)
    assert pm.publishes.value - p0 == 2 and pm.gate_pass.value - g0 == 2
    bst = xt.Booster(model_file=str(publish), device="cpu")
    assert bst.gbtree.num_trees == 4               # two cycles of 2 rounds


def test_mid_train_kill_resumes_bitwise(tmp_path, monkeypatch):
    """A cycle killed after its first segment's checkpoint resumes from
    the ring and ends bitwise where an uninterrupted run ends."""
    src = lambda: SyntheticDataSource(n_rows=300, n_features=6, seed=0)
    ref_pub = tmp_path / "ref.model"
    ref = make_trainer(tmp_path / "ref_wd", ref_pub, rounds=4,
                       source=src())
    assert ref.run_cycle()["status"] == "published"
    assert ref.run_cycle()["status"] == "published"

    seg_params = dict(PARAMS, rounds_per_dispatch=2)
    pub = tmp_path / "published.model"
    tr = make_trainer(tmp_path / "wd", pub, rounds=4, source=src(),
                      params=seg_params)
    assert tr.run_cycle()["status"] == "published"
    real_save = cli._save_checkpoint

    def dies_at_4(ckpt_dir, bst, version):
        if version == 4:
            raise OSError("killed mid-train")
        real_save(ckpt_dir, bst, version)
    monkeypatch.setattr(cli, "_save_checkpoint", dies_at_4)
    summary = tr.run(cycles=1)
    monkeypatch.setattr(cli, "_save_checkpoint", real_save)
    assert summary["errors"] == 1
    assert tr._read_state() == {"cycle": 1, "phase": "train"}
    assert sorted(os.listdir(tr.ckpt_dir)) == ["ckpt-000002.model"]

    pm = pipeline_metrics()
    r0 = pm.resumes.value
    tr2 = make_trainer(tmp_path / "wd", pub, rounds=4, source=src())
    assert tr2.run_cycle()["status"] == "published"
    assert pm.resumes.value == r0 + 1
    assert states_equal(xt.Booster(model_file=str(pub), device="cpu"),
                        xt.Booster(model_file=str(ref_pub), device="cpu"))


def test_regate_on_restart_after_publish_failure(tmp_path, monkeypatch):
    publish = tmp_path / "published.model"
    tr = make_trainer(tmp_path / "wd", publish)
    assert tr.run_cycle()["status"] == "published"
    before = publish.read_bytes()
    real_write = pub_mod.atomic_write

    def no_space(path, data, *a, **k):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(pub_mod, "atomic_write", no_space)
    assert tr.run(cycles=1)["errors"] == 1
    monkeypatch.setattr(pub_mod, "atomic_write", real_write)
    assert publish.read_bytes() == before
    assert tr._read_state() == {"cycle": 1, "phase": "publish"}

    pm = pipeline_metrics()
    r0 = pm.resumes.value
    tr2 = make_trainer(tmp_path / "wd", publish)
    out = tr2.run_cycle()
    assert out["status"] == "published" and out["cycle"] == 1
    assert pm.resumes.value == r0 + 1
    assert file_hash(publish) == out["gate"]["model_hash"]


class _CorruptsCandidate(ContinuousTrainer):
    def _train(self, cycle, st):
        path = super()._train(cycle, st)
        if cycle == 1:
            with open(path, "r+b") as f:
                f.seek(100)
                f.write(b"\xff\x00\xff")
        return path


def test_corrupt_candidate_is_quarantined(tmp_path):
    publish = tmp_path / "published.model"
    tr = make_trainer(tmp_path / "wd", publish, cls=_CorruptsCandidate)
    assert tr.run_cycle()["status"] == "published"
    before = publish.read_bytes()
    out = tr.run_cycle()
    assert out["status"] == "gate_failed"
    assert out["gate"]["verified"] is False
    assert publish.read_bytes() == before
    assert os.listdir(tr.quarantine_dir) == ["cycle-0001.model"]


def test_checkpoint_ring_falls_back_past_a_corrupt_member(tmp_path):
    rng = np.random.RandomState(1)
    X = rng.rand(200, 3).astype(np.float32)
    d = xt.DMatrix(X, label=(X[:, 1] > 0.4).astype(np.float32))
    b = xt.Booster(dict(PARAMS), [d], device="cpu")
    ring = str(tmp_path / "ckpt")
    for v in (1, 2, 3):
        b.update(d, v - 1)
        cli._save_checkpoint(ring, b, v)
    assert sorted(os.listdir(ring)) == ["ckpt-000002.model",
                                        "ckpt-000003.model"]
    with open(os.path.join(ring, "ckpt-000003.model"), "r+b") as f:
        f.seek(50)
        f.write(b"\x00\x01\x02")
    got, version = cli._load_checkpoint(ring, xt.Booster(device="cpu"),
                                        dict(PARAMS))
    assert version == 2 and got.gbtree.num_trees == 2
    assert "ckpt-000003.model.corrupt" in os.listdir(ring)
    assert cli._load_checkpoint(str(tmp_path / "none"),
                                xt.Booster(device="cpu"), {})[1] == 0


# -------------------------------------------------------- observability
def test_spans_events_and_metric_names(tmp_path):
    log = tmp_path / "events.jsonl"
    configure_log(str(log))
    try:
        tr = make_trainer(tmp_path / "wd", tmp_path / "pub.model")
        tr.run(cycles=2)
    finally:
        configure_log(None)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    names = {(r["kind"], r["name"]) for r in recs}
    for want in (("span", "pipeline.train"), ("span", "pipeline.gate"),
                 ("span", "pipeline.publish"), ("span", "ckpt.save"),
                 ("span", "pipeline.cycle"), ("event", "pipeline.gate"),
                 ("event", "pipeline.publish")):
        assert want in names, want
    spans = {r["span"]: r for r in recs if r["kind"] == "span"}
    train = next(r for r in recs if r["name"] == "pipeline.train")
    assert spans[train["parent"]]["name"] == "pipeline.cycle"
    lane_metrics()      # groups register at first use
    text = registry().render()
    for metric in ("xgbtpu_pipeline_cycles_total",
                   "xgbtpu_pipeline_publishes_total",
                   "xgbtpu_lane_dispatches_total",
                   "xgbtpu_lane_solo_total",
                   "xgbtpu_training_checkpoints_total",
                   "xgbtpu_pipeline_cycle_seconds_bucket"):
        assert metric in text, metric


# ---------------------------------------------------- against the JAX
def test_published_models_match_the_jax_pipeline(tmp_path):
    """Two cycles of the JAX package's ContinuousTrainer and the port's
    on the same source, reg:linear: structure bitwise, leaf values at
    rtol 1e-5, the same cycles published."""
    from xgboost_tpu.pipeline import ContinuousTrainer as JaxTrainer
    from xgboost_tpu.pipeline import EvalGate as JaxGate
    from xgboost_tpu.pipeline import SyntheticDataSource as JaxSource
    params = dict(PARAMS, objective="reg:linear")
    jt = JaxTrainer(str(tmp_path / "j.model"),
                    JaxSource(n_rows=300, n_features=6, seed=3),
                    str(tmp_path / "jwd"), rounds_per_cycle=2,
                    params=params, gate=JaxGate(max_regression=0.5),
                    quiet=True)
    tt = make_trainer(tmp_path / "twd", tmp_path / "t.model",
                      source=SyntheticDataSource(n_rows=300, n_features=6,
                                                 seed=3), params=params)
    assert jt.run(cycles=2) == tt.run(cycles=2)
    sj = xt.Booster(model_file=str(tmp_path / "j.model"),
                    device="cpu").gbtree.get_state()
    st = xt.Booster(model_file=str(tmp_path / "t.model"),
                    device="cpu").gbtree.get_state()
    for k in ("tree_feature", "tree_is_leaf", "cut_values", "cut_n"):
        np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
    split = sj["tree_feature"] >= 0
    for k in ("tree_cut_index", "tree_threshold", "tree_default_left"):
        np.testing.assert_array_equal(sj[k][split], st[k][split], err_msg=k)
    np.testing.assert_allclose(st["tree_leaf_value"], sj["tree_leaf_value"],
                               rtol=1e-5, atol=1e-7)
