"""Per-round phase timing: stderr lines, tracing spans and training
metrics from one instrument (port of ``xgboost_tpu/obs/profiler.py``).

Three consumers, all driven by the same phase boundaries:

- ``level>=1``: the ``[prof]`` stderr line of each round and the
  end-of-run summary (``profile=1``); ``level>=2`` also records a
  ``torch.profiler`` trace of the CPU and, on a GPU, the CUDA activity
  into ``trace_dir`` (``profile=2``; the JAX package records a
  ``jax.profiler`` trace there);
- the event log: every phase and every round emit ``kind="span"``
  records (``train.phase`` / ``train.round``) when ``obs_log=`` is set,
  the round's carrying its phase breakdown.  The port has no
  collectives yet (ROADMAP.md section 1 item 13), so a round span
  carries no ``comm`` attributes;
- metrics: rounds completed, the last round, round wall time and
  per-phase seconds on :class:`~xgboost_tpu_torch.obs.metrics.
  TrainingMetrics`.

A phase that :meth:`_Phase.block` a tensor ends with a device barrier
(``torch.cuda.synchronize`` on the tensor's card; nothing on the CPU),
so the card's queued work is timed in the phase that issued it.  That is
why the learner only instruments rounds when profiling or the event log
asks for it.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Optional

from xgboost_tpu_torch.obs import events, trace
from xgboost_tpu_torch.obs.metrics import training_metrics

TRACE_FILE = "xgtpu_trace.json"


class RoundProfiler:
    """Per-phase wall time per boosting round.

    ``level=0`` keeps the spans and metrics and prints nothing (an
    ``obs_log=``-only run); ``level>=1`` adds the ``[prof]`` stderr
    lines; ``level>=2`` adds the ``torch.profiler`` trace."""

    def __init__(self, level: int = 1, trace_dir: Optional[str] = None,
                 out=None):
        import sys
        self.level = level
        self.trace_dir = trace_dir or "./xgtpu_profile"
        self.out = out if out is not None else sys.stderr
        self.rounds = []
        self._current = None
        self._trace = None
        self._round_t0: Optional[float] = None
        self._round_trace: Optional[str] = None

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self.level >= 2 and self._trace is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._trace = profile(activities=acts)
            self._trace.start()

    def stop(self):
        if self._trace is not None:
            prof, self._trace = self._trace, None
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.trace_dir,
                                                  TRACE_FILE))
            print(f"[prof] torch.profiler trace written to "
                  f"{self.trace_dir}", file=self.out)

    # ---------------------------------------------------------- round phases
    def begin_round(self, iteration: int):
        self._current = {"round": iteration, "phases": {}, "t0": None}
        self._round_t0 = time.perf_counter()
        self._round_trace = trace.new_id()
        trace.set_round(iteration)

    def phase(self, name: str):
        """Context manager timing one phase of the current round.  Call
        ``.block(x)`` inside to close the phase on the device work that
        produces ``x``."""
        return _Phase(self, name)

    def end_round(self):
        if self._current is None:
            return
        c = self._current
        total = sum(c["phases"].values())
        dur = (time.perf_counter() - self._round_t0
               if self._round_t0 is not None else total)
        tm = training_metrics()
        tm.rounds.inc()
        tm.round.set(c["round"])
        tm.round_seconds.observe(dur)
        if events.get_log() is not None:
            events.emit({
                "ts": round(time.time(), 6), "kind": "span",
                "name": "train.round", "trace": self._round_trace,
                "span": trace.new_id(), "round": c["round"],
                "dur_ms": round(dur * 1e3, 3),
                "attrs": {"phases_ms": {k: round(v * 1e3, 3)
                                        for k, v in c["phases"].items()}}})
        if self.level >= 1:
            parts = " ".join(f"{k}={v * 1e3:.1f}ms"
                             for k, v in c["phases"].items())
            print(f"[prof] round {c['round']}: total={total * 1e3:.1f}ms "
                  f"{parts}", file=self.out)
        self.rounds.append(c)
        self._current = None
        trace.set_round(None)

    # ------------------------------------------------------------- summary
    def summary(self) -> str:
        if not self.rounds:
            return "[prof] no rounds recorded"
        agg = defaultdict(float)
        for r in self.rounds:
            for k, v in r["phases"].items():
                agg[k] += v
        total = sum(agg.values())
        n = len(self.rounds)
        lines = [f"[prof] {n} rounds, {total:.3f}s total, "
                 f"{total / n * 1e3:.1f}ms/round"]
        if not agg:
            # rounds without phases: nothing to break down, no total to
            # divide by
            lines.append("[prof]   (no phases recorded)")
            return "\n".join(lines)
        for k, v in sorted(agg.items(), key=lambda kv: -kv[1]):
            # all-zero phase durations (clock granularity) give a line,
            # not a ZeroDivisionError
            pct = (v / total * 100) if total > 0 else 0.0
            lines.append(f"[prof]   {k:<10s} {v:8.3f}s  "
                         f"{pct:5.1f}%  {v / n * 1e3:8.1f}ms/round")
        return "\n".join(lines)

    def print_summary(self):
        if self.level >= 1:
            print(self.summary(), file=self.out)


class _Phase:
    def __init__(self, prof: RoundProfiler, name: str):
        self.prof = prof
        self.name = name
        self._blocked = None

    def block(self, x):
        """Close this phase on the device work that produces ``x``."""
        self._blocked = x
        return x

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.ts = time.time()
        return self

    def __exit__(self, *exc):
        x = self._blocked
        if x is not None and exc[0] is None and getattr(x, "is_cuda",
                                                        False):
            import torch
            torch.cuda.synchronize(x.device)
        dur = time.perf_counter() - self.t0
        cur = self.prof._current
        if cur is None and self.prof.rounds:
            # outside begin/end (eval after end_round): fold into the
            # most recent round
            cur = self.prof.rounds[-1]
        if cur is not None:
            cur["phases"][self.name] = (
                cur["phases"].get(self.name, 0.0) + dur)
        training_metrics().phase_seconds.inc(self.name, dur)
        if events.get_log() is not None:
            events.emit({
                "ts": round(self.ts, 6), "kind": "span",
                "name": "train.phase", "trace": self.prof._round_trace,
                "span": trace.new_id(),
                "round": cur["round"] if cur is not None else None,
                "dur_ms": round(dur * 1e3, 3),
                "attrs": {"phase": self.name}})
        return False
