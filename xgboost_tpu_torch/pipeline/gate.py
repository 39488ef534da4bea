"""Eval gate: candidate-vs-incumbent scoring on a held-out window (port
of ``xgboost_tpu/pipeline/gate.py``).

Both models score the same holdout through ``Booster.eval_set``.  With
``min_delta > 0`` the candidate must beat the incumbent by at least
``min_delta``; otherwise ``max_regression`` is the tolerated worsening.
A missing incumbent (cold start) passes.
"""

from __future__ import annotations

from typing import Optional

from xgboost_tpu_torch.learner import _MAXIMIZE_METRICS, _parse_eval


class EvalGate:
    """Judge a candidate model against the incumbent on a holdout."""

    def __init__(self, metric: str = "", min_delta: float = 0.0,
                 max_regression: float = 0.0):
        self.metric = metric
        self.min_delta = float(min_delta)
        self.max_regression = float(max_regression)

    def _score(self, bst, holdout, cycle: int) -> tuple:
        """-> (metric_name, value) through the learner's eval path."""
        if self.metric:
            bst.param.eval_metric = (self.metric,)
        scores = _parse_eval(bst.eval_set([(holdout, "gate")], cycle))
        key = list(scores)[-1]
        return key.split("-", 1)[1], scores[key]

    def judge(self, candidate, incumbent: Optional[object], holdout,
              cycle: int = 0,
              incumbent_score: Optional[float] = None) -> dict:
        """-> verdict: ``passed``, ``metric``, ``candidate``,
        ``incumbent``, ``improvement`` (positive = better),
        ``threshold``, ``reason``.  ``incumbent_score`` is a cached
        incumbent value on this holdout under this gate."""
        name, c = self._score(candidate, holdout, cycle)
        if incumbent is None and incumbent_score is None:
            return {"passed": True, "metric": name, "candidate": c,
                    "incumbent": None, "improvement": None,
                    "reason": "no incumbent (cold start)"}
        i = (incumbent_score if incumbent_score is not None
             else self._score(incumbent, holdout, cycle)[1])
        maximize = any(name.startswith(m) for m in _MAXIMIZE_METRICS)
        improvement = (c - i) if maximize else (i - c)
        threshold = (self.min_delta if self.min_delta > 0.0
                     else -self.max_regression)
        passed = improvement >= threshold
        verdict = {"passed": passed, "metric": name, "candidate": c,
                   "incumbent": i, "improvement": improvement,
                   "threshold": threshold}
        if not passed:
            verdict["reason"] = (
                f"{name} improvement {improvement:.6f} < "
                f"threshold {threshold:.6f} "
                f"(candidate {c:.6f} vs incumbent {i:.6f})")
        return verdict
