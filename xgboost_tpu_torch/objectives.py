"""Objective functions (port of ``xgboost_tpu/objectives.py``: the
one-group regression losses ``reg:linear``, ``reg:logistic``,
``binary:logistic`` and ``binary:logitraw``, the softmax multiclass
objectives ``multi:softmax`` and ``multi:softprob``, and the LambdaRank
objectives ``rank:pairwise|ndcg|map`` of :mod:`.rank_obj`).

Margins are (N, K) tensors, K = 1 unless multiclass.  Every objective's
gradient is ``get_gradient(margin, info, iteration, pad_prep=None)``:
the entry's margin, the DMatrix's :class:`~.data.MetaInfo` (labels,
weights, groups), the round, and the padded rank layout of an entry
laid out so; gradients come back as (N, K, 2) on the margin's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-16


def _label_weight(margin: torch.Tensor, info):
    """The info's labels and weights (ones when unset) as f32 tensors on
    the margin's device, one per margin row."""
    n = margin.shape[0]
    return (info.on_device("label", n, margin.device),
            info.on_device("weight", n, margin.device))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the f64
    product of two f32 values is exact, the f64 sum is rounded to odd
    (two-sum error, then a step to the odd neighbour) so that its one
    rounding to f32 is the correctly rounded result."""
    p = a.double() * torch.as_tensor(b, dtype=torch.float64)
    c = torch.as_tensor(c, dtype=torch.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    away = torch.where(err > 0, torch.tensor(float("inf"), dtype=s.dtype),
                       torch.tensor(float("-inf"), dtype=s.dtype))
    return torch.where(step, torch.nextafter(s, away), s).float()


# XLA's CPU f32 exp (the Cephes polynomial of its LLVM emitter), in
# the order it evaluates: clamp, n = floor(x log2(e) + 1/2), the
# two-part reduction x - n C1 - n C2, a degree-5 polynomial, 1 + z, and
# z 2^n with results below 2^-126 flushed to zero.  Every multiply-add
# there is one FMA.
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_F32_TINY = float(np.finfo(np.float32).tiny)


def _xla_cpu_exp(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(fma_f32(x, np.float32(_EXP_LOG2E), 0.5)),
                    -127.0, 127.0)
    r = fma_f32(n, np.float32(-_EXP_C1), x)
    r = fma_f32(n, np.float32(-_EXP_C2), r)
    z = fma_f32(r, np.float32(_EXP_P[0]), np.float32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        z = fma_f32(z, r, np.float32(p))
    z = 1.0 + fma_f32(z, r * r, r)
    y = z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(y < _F32_TINY, torch.zeros_like(y), y)


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp``: on the CPU bit for bit the JAX package's (XLA's CPU
    ``exp``, which ``torch.exp`` misses by an ulp on ~10% of inputs and
    which breaks softmax ties its own way); ``torch.exp`` on a GPU."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return _xla_cpu_exp(x)
    return torch.exp(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in f32, the JAX package's expression (not
    ``torch.sigmoid``, which rounds differently)."""
    return 1.0 / (1.0 + exp(-x))


def regloss_grad(margin, label, weight, loss: str,
                 spw: float) -> torch.Tensor:
    """(N, 1, 2) gradient pairs (``objectives.py:100-111``)."""
    x = margin[:, 0]
    if loss == "linear":
        g, h = x - label, torch.ones_like(x)
    else:
        p = sigmoid(x)
        g = p - label
        h = torch.clamp_min(p * (1.0 - p), _EPS)
    w = torch.where(label == 1.0, weight * spw, weight)
    return torch.stack([g * w, h * w], dim=-1)[:, None, :]


@functools.lru_cache(maxsize=None)
def _regloss_fused(loss: str, spw: float):
    return functools.partial(regloss_grad, loss=loss, spw=spw)


class RegLossObj:
    """reg:linear, reg:logistic, binary:logistic, binary:logitraw
    (reference RegLossObj, objective-inl.hpp:117-174)."""

    def __init__(self, name: str):
        self.name = name
        self.scale_pos_weight = 1.0
        self.loss = "linear" if name == "reg:linear" else "logistic"
        self.transform_pred = name in ("reg:logistic", "binary:logistic")
        self.default_metric = {"reg:linear": "rmse", "reg:logistic": "rmse",
                               "binary:logistic": "error",
                               "binary:logitraw": "auc"}[name]

    def set_param(self, name, value):
        if name == "scale_pos_weight":
            self.scale_pos_weight = float(value)

    def validate_labels(self, info) -> None:
        if self.loss != "linear":
            lab = np.asarray(info.label)
            # negated form so NaN labels fail too
            if (~((lab >= 0) & (lab <= 1))).any():
                raise ValueError(
                    "label must be in [0,1] for logistic regression")

    def get_gradient(self, margin, info, iteration: int = 0,
                     pad_prep=None) -> torch.Tensor:
        label, weight = _label_weight(margin, info)
        return regloss_grad(margin, label, weight, self.loss,
                            float(self.scale_pos_weight))

    def fused_grad(self):
        """``get_gradient`` as a function of (margin, label, weight) with
        a stable identity per (loss, scale_pos_weight): equal objectives
        of different boosters give the same object, so it can key a
        lane bucket (the JAX package's ``Objective.fused_grad``)."""
        return _regloss_fused(self.loss, float(self.scale_pos_weight))

    def pred_transform(self, margin, output_margin=False):
        if output_margin or not self.transform_pred:
            return margin
        return sigmoid(margin)

    def eval_transform(self, margin):
        return self.pred_transform(margin)

    def prob_to_margin(self, base_score: float) -> float:
        if self.name != "reg:linear":
            if not 0.0 < base_score < 1.0:
                raise ValueError(
                    "base_score must be in (0,1) for logistic loss")
            return -np.log(1.0 / base_score - 1.0)
        return base_score


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax along axis 1 in f32 with ``jax.nn.softmax``'s expression:
    ``exp(x - max) / sum(exp(x - max))``.  On the CPU the sum runs over
    the classes left to right, XLA's CPU order, so p is the JAX
    package's bit for bit."""
    e = exp(x - x.amax(dim=1, keepdim=True))
    if x.device.type != "cpu":
        return e / e.sum(dim=1, keepdim=True)
    s = e[:, 0].clone()
    for k in range(1, e.shape[1]):
        s += e[:, k]
    return e / s[:, None]


def softmax_grad(margin, label, weight) -> torch.Tensor:
    """(N, K, 2) softmax gradient pairs (``objectives.py:173-181``):
    ``g = (p - y) w``, ``h = 2 p (1 - p) w`` with y the one-hot label."""
    p = softmax(margin)
    classes = torch.arange(margin.shape[1], device=margin.device)
    y = (label.to(torch.int64)[:, None] == classes).to(p.dtype)
    w = weight[:, None]
    return torch.stack([(p - y) * w, 2.0 * p * (1.0 - p) * w], dim=-1)


class SoftmaxMultiClassObj:
    """multi:softmax / multi:softprob (reference SoftmaxMultiClassObj,
    objective-inl.hpp:177-271)."""

    def __init__(self, output_prob: bool):
        self.name = "multi:softprob" if output_prob else "multi:softmax"
        self.output_prob = output_prob
        self.nclass = 0
        self.default_metric = "merror"

    @property
    def output_group_count(self) -> int:
        return max(1, self.nclass)

    def set_param(self, name, value):
        if name == "num_class":
            self.nclass = int(value)

    def validate_labels(self, info) -> None:
        if self.nclass <= 0:
            raise ValueError("must set num_class to use softmax")
        lab = np.asarray(info.label)
        # negated form so NaN labels fail too
        if (~((lab >= 0) & (lab < self.nclass))).any():
            raise ValueError(
                f"SoftmaxMultiClassObj: label must be in [0, {self.nclass})")

    def get_gradient(self, margin, info, iteration: int = 0,
                     pad_prep=None) -> torch.Tensor:
        return softmax_grad(margin, *_label_weight(margin, info))

    def fused_grad(self):
        """See :meth:`RegLossObj.fused_grad`."""
        return softmax_grad

    def pred_transform(self, margin, output_margin=False):
        if output_margin:
            return margin
        if self.output_prob:
            return softmax(margin)
        return torch.argmax(margin, dim=1).to(torch.float32)[:, None]

    def eval_transform(self, margin):
        return softmax(margin)

    def prob_to_margin(self, base_score: float) -> float:
        return base_score


def create_objective(name: str):
    """Objective factory (reference CreateObjFunction)."""
    if name in ("reg:linear", "reg:logistic", "binary:logistic",
                "binary:logitraw"):
        return RegLossObj(name)
    if name == "multi:softmax":
        return SoftmaxMultiClassObj(False)
    if name == "multi:softprob":
        return SoftmaxMultiClassObj(True)
    if name in ("rank:pairwise", "rank:ndcg", "rank:map"):
        from xgboost_tpu_torch.rank_obj import LambdaRankObj
        return LambdaRankObj(name)
    raise ValueError(f"unknown objective function type: {name}")
