"""GBLinear: the elastic-net linear booster (port of
``xgboost_tpu/models/gblinear.py``; reference ``src/gbm/gblinear-inl.hpp``).

One boosting round is the bias Newton step (``CalcDeltaBias``) followed
by block-sequential coordinate descent over the features in blocks of
``linear_block``: within a block every feature's elastic-net step
(``CalcDelta``, soft threshold at ``alpha``) reads the same residual
gradient, and between blocks the residual absorbs the block's update
exactly (``g += h * (X_b @ delta_b)``).  Block size 1, the default, is
exact sequential coordinate descent.  ``num_output_group`` weight
columns carry multiclass models.  Missing entries contribute 0.

The design matrix is kept feature-major on the device, ``(F, N)``
contiguous, so a block is a run of contiguous rows.  The products are
``torch.matmul`` in true f32: on a GPU the step refuses to run while
TF32 products are allowed (``torch.set_float32_matmul_precision``).
On the CPU the bias sums add the rows in XLA's CPU order
(:func:`~xgboost_tpu_torch.ops.histogram.bin_sum`), and a one-group
prediction's ``X @ w`` is XLA's CPU matrix-vector product
(:func:`_xla_cpu_gemv`), so the JAX package's predictions of one model
come out the same bits.  The coordinate steps' block products are
``torch.matmul`` on the CPU too: the weights of a trained model differ
from the JAX package's by a few ulp (ROADMAP.md section 3, F9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from xgboost_tpu_torch.config import TrainParam
from xgboost_tpu_torch.objectives import fma_f32
from xgboost_tpu_torch.ops.histogram import bin_sum


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, K) -> (K,): the sum over rows, in XLA's CPU order on the CPU."""
    return bin_sum(x.T.contiguous())


def _xla_cpu_gemv(XT: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X @ w`` for the (F, N) matrix ``XT`` and a (F,) vector, in the
    order of XLA's CPU row-major matrix-vector product: per row, eight
    lanes of fused multiply-adds over each full tile of eight columns,
    the lanes summed pairwise ((l0 + l1) + (l2 + l3)) + ... in the row
    tiles of eight rows and by halves (l0 + l4, ...) in the rows past
    the last whole tile, the leftover columns fused-multiply-added from
    0 and added last."""
    F, N = XT.shape
    nfull = F // 8 * 8
    total = torch.zeros(N, dtype=torch.float32)
    if nfull:
        acc = torch.zeros((N, 8), dtype=torch.float32)
        for c in range(0, nfull, 8):
            acc = fma_f32(XT[c:c + 8].T, w[c:c + 8], acc)
        n_tiled = N // 8 * 8
        head, tail = acc[:n_tiled], acc[n_tiled:]
        while head.shape[1] > 1:
            head = head[:, 0::2] + head[:, 1::2]
        while tail.shape[1] > 1:
            h = tail.shape[1] // 2
            tail = tail[:, :h] + tail[:, h:]
        total = torch.cat([head[:, 0], tail[:, 0]])
    rest = torch.zeros(N, dtype=torch.float32)
    for c in range(nfull, F):
        rest = fma_f32(XT[c], w[c], rest)
    return total + rest if nfull else rest


def _check_f32_products(device: torch.device) -> None:
    if device.type == "cuda" and \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "gblinear needs true f32 products on the GPU; the float32 "
            f"matmul precision is {torch.get_float32_matmul_precision()!r} "
            "(TF32): set torch.set_float32_matmul_precision('highest')")


def _linear_boost_step(XT: torch.Tensor, gh: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor, eta: float,
                       lam: float, alpha: float, lam_bias: float,
                       block: int = 1):
    """One round of bias + block-sequential coordinate updates
    (``gblinear.py:37-89``).

    XT: (F, N) feature-major dense matrix (0 = missing); gh: (N, K, 2);
    weight: (F, K); bias: (K,).  Returns the new (weight, bias)."""
    _check_f32_products(XT.device)
    g, h = gh[..., 0], gh[..., 1]                     # (N, K)
    # bias step (CalcDeltaBias)
    sum_g, sum_h = _row_sum(g), _row_sum(h)
    dbias = eta * (-(sum_g + lam_bias * bias) / (sum_h + lam_bias + 1e-12))
    bias = bias + dbias
    g = g + h * dbias[None, :]                        # remove the bias effect

    F = XT.shape[0]
    bf = max(1, min(block, F))
    n_blocks = -(-F // bf)
    f_pad = n_blocks * bf
    weight = weight.clone()
    if f_pad != F:
        XT = torch.nn.functional.pad(XT, (0, 0, 0, f_pad - F))
        weight = torch.nn.functional.pad(weight, (0, 0, 0, f_pad - F))
    for b in range(n_blocks):
        Xb = XT[b * bf:(b + 1) * bf]                  # (bf, N) contiguous
        wb = weight[b * bf:(b + 1) * bf]              # (bf, K)
        Gf = Xb @ g                                   # (bf, K)
        Hf = (Xb * Xb) @ h
        # CalcDelta's elastic-net step
        tmp = wb - (Gf + lam * wb) / (Hf + lam)
        pos = -(Gf + lam * wb + alpha) / (Hf + lam)
        neg = -(Gf + lam * wb - alpha) / (Hf + lam)
        delta = torch.where(tmp >= 0, torch.maximum(pos, -wb),
                            torch.minimum(neg, -wb))
        delta = torch.where(Hf < 1e-5, 0.0, eta * delta)
        weight[b * bf:(b + 1) * bf] = wb + delta
        # exact residual propagation to the later blocks
        g = g + h * (Xb.T @ delta)
    return weight[:F], bias


def _linear_predict(XT: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """``base + bias + X @ weight`` from the (F, N) matrix, (N, K)."""
    _check_f32_products(XT.device)
    if XT.device.type == "cpu" and weight.shape[1] == 1:
        return base + bias[None, :] + _xla_cpu_gemv(XT, weight[:, 0])[:, None]
    return base + bias[None, :] + XT.T @ weight


class GBLinear:
    """Linear booster state (reference gblinear-inl.hpp Model): an
    (F, K) weight matrix and a (K,) bias on the booster's device."""

    def __init__(self, param: TrainParam, num_feature: int,
                 device: torch.device):
        self.param = param
        self.num_feature = num_feature
        self.device = device
        K = max(1, param.num_output_group)
        self.weight = torch.zeros((num_feature, K), dtype=torch.float32,
                                  device=device)
        self.bias = torch.zeros((K,), dtype=torch.float32, device=device)
        self.version = 0  # boosting rounds applied

    @property
    def num_boosted_rounds(self) -> int:
        return self.version

    def host_matrix(self, dmat) -> np.ndarray:
        """Dense (N, F) host matrix of the model's width, 0 for missing."""
        X = dmat.to_dense(missing=np.nan)
        if X.shape[1] < self.num_feature:
            X = np.pad(X, ((0, 0), (0, self.num_feature - X.shape[1])),
                       constant_values=np.nan)
        return np.nan_to_num(X[:, :self.num_feature], nan=0.0)

    def device_matrix(self, dmat) -> torch.Tensor:
        """The (F, N) feature-major device matrix of :meth:`host_matrix`."""
        XT = np.ascontiguousarray(self.host_matrix(dmat).T, np.float32)
        return torch.from_numpy(XT).to(self.device)

    def do_boost(self, XT: torch.Tensor, gh: torch.Tensor, info=None,
                 mesh=None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "row-sharded gblinear (dsplit=row) is ROADMAP.md section 1 "
                "item 13")
        p = self.param
        self.weight, self.bias = _linear_boost_step(
            XT, gh.to(torch.float32), self.weight, self.bias, float(p.eta),
            float(p.reg_lambda), float(p.reg_alpha), float(p.lambda_bias),
            block=max(1, p.linear_block))
        self.version += 1

    def predict_margin(self, XT: torch.Tensor, base, ntree_limit: int = 0,
                       root: Optional[torch.Tensor] = None) -> torch.Tensor:
        # root (multi-root trees) means nothing to a linear model
        base = torch.as_tensor(base, dtype=torch.float32).to(XT.device)
        return _linear_predict(XT, self.weight, self.bias, base)

    def predict_leaf(self, XT, ntree_limit: int = 0, root=None):
        raise ValueError("pred_leaf is not defined for the gblinear booster")

    # ------------------------------------------------------------ serialize
    def get_state(self) -> dict:
        return {"linear_weight": self.weight.cpu().numpy(),
                "linear_bias": self.bias.cpu().numpy(),
                "linear_version": np.int64(self.version)}

    @classmethod
    def from_state(cls, param: TrainParam, state: dict,
                   device: torch.device) -> "GBLinear":
        w = np.asarray(state["linear_weight"], np.float32)
        m = cls(param, w.shape[0], device)
        m.weight = torch.from_numpy(np.array(w)).to(device)
        m.bias = torch.from_numpy(np.array(state["linear_bias"],
                                           np.float32)).to(device)
        m.version = int(state.get("linear_version", 1))
        return m

    def dump_text(self) -> str:
        """Text dump (reference GBLinear::DumpModel)."""
        lines = ["bias:"]
        lines += [f"{float(b):g}" for b in self.bias.cpu().numpy()]
        lines.append("weight:")
        for row in self.weight.cpu().numpy():
            lines += [f"{float(v):g}" for v in row]
        return "\n".join(lines) + "\n"
