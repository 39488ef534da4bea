"""Evaluation metrics (port of ``xgboost_tpu/metrics.py``: rmse,
logloss, error, merror, mlogloss, auc).

Host-side numpy on float64, the same arithmetic as the JAX package, so
the eval lines agree.  Predictions arrive already eval-transformed by
the objective: (N,) for one output group, (N, K) softmax probabilities
for the multiclass metrics.  The ranking, AMS and precision-ratio
metrics are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_EPS = 1e-16


def _wmean(values: np.ndarray, weights: np.ndarray) -> float:
    return float(np.sum(values * weights) / np.sum(weights))


def rmse(preds, labels, weights, group_ptr=None):
    return float(np.sqrt(_wmean((preds - labels) ** 2, weights)))


def logloss(preds, labels, weights, group_ptr=None):
    p = np.clip(preds, _EPS, 1.0 - _EPS)
    ll = -(labels * np.log(p) + (1.0 - labels) * np.log(1.0 - p))
    return _wmean(ll, weights)


def error(preds, labels, weights, group_ptr=None):
    wrong = np.where(preds > 0.5, labels != 1.0, labels != 0.0)
    return _wmean(wrong.astype(np.float64), weights)


def merror(preds, labels, weights, group_ptr=None):
    yhat = np.argmax(preds, axis=1)
    return _wmean((yhat != labels.astype(np.int64)).astype(np.float64),
                  weights)


def mlogloss(preds, labels, weights, group_ptr=None):
    p = np.clip(preds[np.arange(len(labels)), labels.astype(np.int64)],
                _EPS, None)
    return _wmean(-np.log(p), weights)


def auc(preds, labels, weights, group_ptr=None):
    """Weighted AUC, averaged over groups when group_ptr is given; tied
    predictions count half (reference EvalAuc)."""
    preds = preds.ravel()
    if group_ptr is None:
        group_ptr = np.array([0, len(preds)])
    total, ngroup = 0.0, 0
    for g in range(len(group_ptr) - 1):
        s, e = group_ptr[g], group_ptr[g + 1]
        v = _auc_group(preds[s:e], labels[s:e], weights[s:e])
        if v is None:
            continue
        total += v
        ngroup += 1
    if ngroup == 0:
        raise ValueError("AUC: the dataset only contains pos or neg samples")
    return float(total / ngroup)


def _value_runs(p, wpos, wneg):
    """Sorted distinct-value runs of (value, pos weight, neg weight)."""
    order = np.argsort(p, kind="stable")
    p, wpos, wneg = p[order], wpos[order], wneg[order]
    if len(p) == 0:
        return p, wpos, wneg
    boundary = np.concatenate([[True], p[1:] != p[:-1]])
    gid = np.cumsum(boundary) - 1
    gpos = np.zeros(gid[-1] + 1)
    gneg = np.zeros(gid[-1] + 1)
    np.add.at(gpos, gid, wpos)
    np.add.at(gneg, gid, wneg)
    return p[boundary], gpos, gneg


def _runs_auc(gpos, gneg):
    tot_pos, tot_neg = gpos.sum(), gneg.sum()
    if tot_pos <= 0 or tot_neg <= 0:
        return None
    cum_neg_before = np.cumsum(gneg) - gneg
    return np.sum(gpos * (cum_neg_before + 0.5 * gneg)) / (
        tot_pos * tot_neg)


def _auc_group(p, y, w):
    _, gpos, gneg = _value_runs(p, w * (y > 0), w * (y <= 0))
    return _runs_auc(gpos, gneg)


_METRICS: Dict[str, Callable] = {"rmse": rmse, "logloss": logloss,
                                 "error": error, "merror": merror,
                                 "mlogloss": mlogloss, "auc": auc}


def create_metric(name: str) -> Callable:
    """Metric by name (reference CreateEvaluator).

    Parses the name as the JAX package's factory does (``ct-`` prefix,
    ``@suffix``, trailing ``-``), so a name that factory does not know
    raises its ``ValueError``; a name it knows that is not ported here
    (``ct-``, ``ams``, ``pratio``, ``apratio``, ``ndcg``, ``map``,
    ``pre``) raises ``NotImplementedError``.
    """
    if name.startswith("ct-"):
        create_metric(name[3:])
        raise _unported(name)
    base, at, suffix = name.partition("@")
    if suffix.endswith("-"):
        suffix = suffix[:-1]
    fn = _METRICS.get(base)
    if fn is not None and not at:
        def metric(preds, labels, weights, group_ptr=None):
            return fn(preds, labels, weights, group_ptr)
        metric.metric_name = name
        return metric
    # the reference parses a ratio (ams, pratio, apratio) or a top-n (the
    # rankers, and any other suffixed name) before it looks the name up
    if base in ("ams", "pratio", "apratio"):
        if suffix:
            float(suffix)
        raise _unported(name)
    if suffix:
        int(float(suffix))
    if base in ("ndcg", "map", "pre"):
        raise _unported(name)
    raise ValueError(f"unknown evaluation metric type: {name}")


def _unported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"metric {name!r} is not ported yet (ported: {sorted(_METRICS)}; "
        f"ROADMAP.md section 1)")
