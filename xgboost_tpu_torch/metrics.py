"""Evaluation metrics (port of ``xgboost_tpu/metrics.py``): rmse,
logloss, error, merror, mlogloss, auc, ams, the precision ratios
``pratio`` / ``apratio``, the cross-fold ``ct-<base>``, and the ranklist
metrics ``ndcg``, ``map`` and ``pre`` with ``@n`` and the trailing
``-`` (a list without positives scores 0 instead of 1).

Host-side numpy on float64, the same arithmetic as the JAX package, so
every value is equal to its value there to the bit.  Predictions arrive
already eval-transformed by the objective: (N,) for one output group,
(N, K) softmax probabilities for the multiclass metrics.  The JAX
package's per-shard partial sums (its split-loaded evaluation) are not
ported: the port has no distributed training yet (ROADMAP.md).
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


def ams(preds, labels, weights, group_ptr=None, ratio: float = 0.15):
    """Approximate median significance at threshold ``ratio``
    (``metrics.py:123``; reference EvalAMS)."""
    preds = preds.ravel()
    order = np.argsort(-preds, kind="stable")
    ntop = int(ratio * len(preds))
    if ntop == 0:
        ntop = len(preds)
    sel = order[:ntop]
    br = 10.0
    s = float(np.sum(weights[sel] * (labels[sel] == 1.0)))
    b = float(np.sum(weights[sel] * (labels[sel] != 1.0)))
    val = 2.0 * ((s + b + br) * np.log(1.0 + s / (b + br)) - s)
    return float(np.sqrt(max(val, 0.0)))


def precision_ratio(preds, labels, weights, group_ptr=None,
                    ratio: float = 0.1, use_ap: bool = False):
    """Weighted precision in the top ``ratio`` of the predictions
    (``metrics.py:141``): ``pratio@r`` the hit rate at the cutoff,
    ``apratio@r`` the running precision averaged over the ranks up to
    it.  Like the reference, only the first ``len(labels)`` entries of
    the flat (row-major) prediction vector are ranked."""
    n = len(labels)
    preds = np.asarray(preds).ravel()[:n]
    order = np.argsort(-preds, kind="stable")
    cutoff = int(ratio * len(preds))
    if cutoff == 0:
        return 0.0
    sel = order[:cutoff]
    w = weights[sel]
    hit = np.cumsum(labels[sel] * w)
    wsum = np.cumsum(w)
    if use_ap:
        return float(np.mean(hit / wsum))
    return float(hit[-1] / wsum[-1])


def ctest(base_fn, preds, labels, weights, fold_index):
    """``ct-<base>`` (``metrics.py:173``; reference EvalCTest): the
    predictions stack ``ngroup + 1`` sets of ``len(labels)`` each, set
    ``k + 1`` the model that held out fold ``k``; the base metric of
    each fold's held-out rows, averaged over the folds."""
    preds = np.asarray(preds)
    if preds.ndim != 1:
        raise ValueError(
            "ct-: expects 1D stacked prediction sets (got shape "
            f"{preds.shape}); multiclass per-class outputs are not a "
            "fold-stacked layout")
    n = len(labels)
    if preds.size % n != 0:
        raise ValueError("ct-: label and prediction size not match")
    ngroup = preds.size // n - 1
    if ngroup <= 1:
        raise ValueError("ct-: pred size does not meet requirement")
    if fold_index is None or len(fold_index) != n:
        raise ValueError("ct-: need fold index")
    fold_index = np.asarray(fold_index)
    wsum = 0.0
    for k in range(ngroup):
        mask = fold_index == k
        if not mask.any():
            raise ValueError(
                f"ct-: fold {k} has no rows — fold_index must be 0-based "
                f"ids in [0, {ngroup})")
        wsum += base_fn(preds[(k + 1) * n:(k + 2) * n][mask],
                        labels[mask], weights[mask], None)
    return float(wsum / ngroup)


def _dcg_at(rels: np.ndarray, n: int) -> float:
    rels = rels[:n]
    return float(np.sum((2.0 ** rels - 1.0)
                        / np.log2(np.arange(len(rels)) + 2.0)))


def ndcg(preds, labels, weights, group_ptr=None, n: int = 0, minus=False):
    return _rank_metric(preds, labels, group_ptr, n, minus, _ndcg_group)


def _ndcg_group(p, y, n):
    n = n if n > 0 else len(p)
    order = np.argsort(-p, kind="stable")
    dcg = _dcg_at(y[order], n)
    idcg = _dcg_at(np.sort(y)[::-1], n)
    if idcg == 0.0:
        return None
    return dcg / idcg


def map_metric(preds, labels, weights, group_ptr=None, n: int = 0,
               minus=False):
    return _rank_metric(preds, labels, group_ptr, n, minus, _map_group)


def _map_group(p, y, n):
    order = np.argsort(-p, kind="stable")
    rel = (y[order] > 0).astype(np.float64)
    if rel.sum() == 0:
        return None
    n = n if n > 0 else len(p)
    hits = np.cumsum(rel)
    prec = rel * hits / np.arange(1, len(rel) + 1)
    return float(np.sum(prec[:n]) / min(rel.sum(), n))


def precision_at(preds, labels, weights, group_ptr=None, n: int = 0,
                 minus=False):
    return _rank_metric(preds, labels, group_ptr, n, minus, _pre_group)


def _pre_group(p, y, n):
    n = n if n > 0 else len(p)
    order = np.argsort(-p, kind="stable")
    return float(np.sum(y[order][:n] > 0) / n)


def _rank_metric(preds, labels, group_ptr, n, minus, fn):
    """The mean over groups of ``fn`` (``metrics.py:261-273``); a group
    ``fn`` cannot score (no relevant rows) counts 1, or 0 with the
    trailing ``-``."""
    preds = preds.ravel()
    if group_ptr is None:
        group_ptr = np.array([0, len(preds)])
    total, ngroup = 0.0, 0
    for g in range(len(group_ptr) - 1):
        s, e = group_ptr[g], group_ptr[g + 1]
        v = fn(preds[s:e], labels[s:e], n)
        if v is None:
            v = 0.0 if minus else 1.0
        total += v
        ngroup += 1
    return float(total / max(ngroup, 1))


_SIMPLE: Dict[str, Callable] = {"rmse": rmse, "logloss": logloss,
                                "error": error, "merror": merror,
                                "mlogloss": mlogloss, "auc": auc}
_RANKERS: Dict[str, Callable] = {"ndcg": ndcg, "map": map_metric,
                                 "pre": precision_at}


def create_metric(name: str) -> Callable:
    """Metric by name (``metrics.py:373-417``; reference
    CreateEvaluator): the simple names, ``ams[@ratio]``,
    ``pratio[@ratio]`` / ``apratio[@ratio]``, ``ndcg`` / ``map`` /
    ``pre`` with ``@n`` and the trailing ``-``, and ``ct-<name>``, which
    takes the rows' ``fold_index`` (``needs_fold_index``).  A name the
    JAX package does not know raises its ``ValueError``."""
    if name.startswith("ct-"):
        base_fn = create_metric(name[3:])
        wrapped = _named(
            lambda p, l, w, g=None, fold_index=None: ctest(
                base_fn, p, l, w, fold_index), name)
        wrapped.needs_fold_index = True
        return wrapped
    base, at, suffix = name.partition("@")
    minus = False
    if suffix.endswith("-"):
        minus, suffix = True, suffix[:-1]
    if not at and base in _SIMPLE:
        return _named(_SIMPLE[base], name)
    if base == "ams":
        ratio = float(suffix) if suffix else 0.15
        return _named(lambda p, l, w, g=None: ams(p, l, w, g, ratio), name)
    if base in ("pratio", "apratio"):
        ratio = float(suffix) if suffix else 0.1
        use_ap = base == "apratio"
        return _named(lambda p, l, w, g=None: precision_ratio(
            p, l, w, g, ratio, use_ap), name)
    topn = int(float(suffix)) if suffix else 0
    if base in _RANKERS:
        fn = _RANKERS[base]
        return _named(
            lambda p, l, w, g=None: fn(p, l, w, g, topn, minus), name)
    raise ValueError(f"unknown evaluation metric type: {name}")


def _named(fn: Callable, name: str) -> Callable:
    """A fresh function carrying ``metric_name`` (a shared function
    would carry the last name given)."""
    def metric(*args, **kwargs):
        return fn(*args, **kwargs)
    metric.metric_name = name
    return metric
