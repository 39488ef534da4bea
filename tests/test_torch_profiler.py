"""The round profiler of the PyTorch port (``xgboost_tpu_torch.obs.
profiler``) against the JAX package's ``RoundProfiler``, and ``profile=1``
training on the CPU.

Held equal: the summary text for the same phase durations (both clocks
monkeypatched), the ``[prof]`` line format and the phase names
(``predict``, ``gradient``, ``grow``, ``eval``), the event-log span
names, and the model of a profiled run, which is the unprofiled run's to
the byte once the ``profile`` parameter (recorded in the header) is
reset."""

import contextlib
import io
import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch import obs  # noqa: E402
from xgboost_tpu_torch.obs import profiler as tprof  # noqa: E402

ROUND_LINE = re.compile(r"^\[prof\] round (\d+): total=[0-9.]+ms"
                        r"( [a-z]+=[0-9.]+ms)+$")


def test_round_profiler_summary_no_division_by_zero():
    from xgboost_tpu_torch.profiling import RoundProfiler
    prof = RoundProfiler(level=0)
    # a round whose phases all measured 0.0s must not raise
    prof.rounds.append({"round": 0, "phases": {"grow": 0.0}, "t0": None})
    s = prof.summary()
    assert "1 rounds" in s and "grow" in s and "0.0%" in s
    prof2 = RoundProfiler(level=0)
    prof2.rounds.append({"round": 0, "phases": {}, "t0": None})
    s2 = prof2.summary()
    assert "1 rounds" in s2 and "no phases" in s2
    assert "no rounds" in RoundProfiler(level=0).summary()


def test_profiling_compat_shim():
    from xgboost_tpu_torch.profiling import (Counter, Gauge,  # noqa: F401
                                             Histogram, ReliabilityMetrics,
                                             RoundProfiler,
                                             reliability_metrics)
    assert RoundProfiler is tprof.RoundProfiler
    assert RoundProfiler is obs.RoundProfiler
    assert reliability_metrics() is obs.reliability_metrics()


def _fake_clock(monkeypatch, module):
    """A perf_counter that advances by a fixed schedule: each call 1.25
    ms, every third call 7.5 ms."""
    ticks = iter(range(10 ** 6))

    def clock():
        i = next(ticks)
        return i * 1.25e-3 + (i // 3) * 6.25e-3
    monkeypatch.setattr(module.time, "perf_counter", clock)


def _drive(prof, rounds=3):
    for r in range(rounds):
        prof.begin_round(r)
        for name in ("predict", "gradient", "grow"):
            with prof.phase(name):
                pass
        prof.end_round()
        with prof.phase("eval"):
            pass
    prof.print_summary()


def test_lines_and_summary_equal_the_jax_profiler(monkeypatch):
    from xgboost_tpu.obs import profiler as jprof
    texts = []
    for mod in (jprof, tprof):
        _fake_clock(monkeypatch, mod)
        out = io.StringIO()
        _drive(mod.RoundProfiler(level=1, out=out))
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    lines = texts[1].splitlines()
    assert sum(bool(ROUND_LINE.match(ln)) for ln in lines) == 3
    assert lines[3].startswith("[prof] 3 rounds, ")
    assert {ln.split()[1] for ln in lines[4:]} == {"predict", "gradient",
                                                   "grow", "eval"}


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    X = rng.rand(600, 5).astype(np.float32)
    y = (X[:, 0] + 0.2 * X[:, 1] > 0.6).astype(np.float32)
    return X, y


def test_profile1_training(data, tmp_path):
    """``profile=1``: a ``[prof]`` line a round and the summary on
    stderr, ``train.phase`` / ``train.round`` spans in the event log, the
    ``profiler`` blocker, and the model of the run without it."""
    X, y = data
    params = {"objective": "binary:logistic", "max_depth": 3,
              "subsample": 0.8, "colsample_bytree": 0.8}
    plain = xt.train(params, xt.DMatrix(X, label=y), 4, device="cpu")
    log = tmp_path / "events.jsonl"
    obs.configure_log(str(log))
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            d = xt.DMatrix(X, label=y)
            bst = xt.train(dict(params, profile=1), d, 4,
                           evals=[(d, "train")], verbose_eval=False,
                           device="cpu")
    finally:
        obs.configure_log(None)
    lines = err.getvalue().splitlines()
    rounds = [ln for ln in lines if ROUND_LINE.match(ln)]
    assert [int(ROUND_LINE.match(ln).group(1)) for ln in rounds] == [0, 1,
                                                                     2, 3]
    for ln in rounds:
        assert [p.split("=")[0] for p in ln.split()[4:]] == [
            "predict", "gradient", "grow"]
    assert any(ln.startswith("[prof] 4 rounds, ") for ln in lines)
    assert any(ln.split()[1:2] == ["eval"] for ln in lines
               if ln.startswith("[prof]   "))
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    spans = [r for r in recs if r["kind"] == "span"]
    phases = [r["attrs"]["phase"] for r in spans
              if r["name"] == "train.phase"]
    assert phases.count("grow") == 4 and phases.count("eval") == 4
    rspans = [r for r in spans if r["name"] == "train.round"]
    assert [r["round"] for r in rspans] == [0, 1, 2, 3]
    assert set(rspans[0]["attrs"]["phases_ms"]) == {"predict", "gradient",
                                                    "grow"}
    assert "comm" not in rspans[0]["attrs"]
    assert "profiler" in bst._segment_blockers(4)
    spec, why = bst.fused_lane_spec(d, 4, 2)
    assert spec is None and why == "profiler"
    bst.set_param("profile", 0)
    assert bst.save_raw() == plain.save_raw()


def test_event_log_alone_times_phases(data, tmp_path, monkeypatch):
    """An event log without ``profile`` keeps the phase spans at level 0
    (``obs.phases_enabled``) and prints nothing; ``XGBTPU_OBS_PHASES=0``
    keeps the log without them, segments included."""
    X, y = data
    log = tmp_path / "events.jsonl"
    obs.configure_log(str(log))
    err = io.StringIO()
    try:
        assert obs.phases_enabled()
        with contextlib.redirect_stderr(err):
            bst = xt.train({"max_depth": 2}, xt.DMatrix(X, label=y), 3,
                           device="cpu")
        assert bst.profiler.level == 0
        monkeypatch.setenv("XGBTPU_OBS_PHASES", "0")
        assert not obs.phases_enabled()
        assert xt.Booster({}, device="cpu").profiler is None
    finally:
        obs.configure_log(None)
    assert "[prof]" not in err.getvalue()
    names = [json.loads(ln)["name"] for ln in log.read_text().splitlines()]
    assert names.count("train.round") == 3


def test_profile2_writes_a_trace(data, tmp_path):
    X, y = data
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        xt.train({"max_depth": 2, "profile": 2,
                  "profile_dir": str(tmp_path / "trace")},
                 xt.DMatrix(X, label=y), 2, device="cpu")
    assert (f"[prof] torch.profiler trace written to {tmp_path / 'trace'}"
            in err.getvalue())
    trace = json.loads((tmp_path / "trace" / tprof.TRACE_FILE).read_text())
    assert trace["traceEvents"]
