"""Objective functions (port of ``xgboost_tpu/objectives.py``: the
one-group regression losses ``reg:linear``, ``reg:logistic``,
``binary:logistic`` and ``binary:logitraw``, and the softmax multiclass
objectives ``multi:softmax`` and ``multi:softprob``).

Margins are (N, K) tensors, K = 1 unless multiclass; gradients come back
as (N, K, 2) on the margin's device.  Ranking objectives are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-16


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in f32, the JAX package's expression (not
    ``torch.sigmoid``, which rounds differently)."""
    return 1.0 / (1.0 + torch.exp(-x))


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

    def get_gradient(self, margin, label, weight) -> torch.Tensor:
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
    ``exp(x - max) / sum(exp(x - max))``."""
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


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

    def get_gradient(self, margin, label, weight) -> torch.Tensor:
        return softmax_grad(margin, label, weight)

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
        raise NotImplementedError(
            f"objective {name}: ranking is ROADMAP.md section 1 item 10")
    raise ValueError(f"unknown objective function type: {name}")
