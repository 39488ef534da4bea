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
contiguous, so a block is a run of contiguous rows.  On a GPU the
products are ``torch.matmul`` in true f32: the step refuses to run
while TF32 products are allowed (``torch.set_float32_matmul_precision``).
On the CPU every product replays the order of the JAX package's XLA
CPU code, read from its optimised LLVM IR (``--xla_dump_to``), where
LLVM contracts each multiply-add into one FMA:

- the bias sums add the rows in XLA's CPU reduction order
  (:func:`~xgboost_tpu_torch.ops.histogram.bin_sum`), and the bias and
  the residual update the gradient as XLA's vectorised loop does,
  ``fma(h, d, g)`` an element (:func:`_update_cpu`);
- one output group: each feature's ``x . g`` and ``(x * x) . h`` is a
  vectorised loop (:func:`_xla_loop_dot`), and the residual ``X_b @
  delta`` a per-row FMA chain over the block's columns from 0;
- several groups at block 1: each ``Gf`` / ``Hf`` product is one FMA
  chain over the rows, from the first row's product (:func:`_fma_chain`);
  at a block above 1 the JAX package's products are a library GEMM
  (Eigen), whose order is not replayed: ``torch.matmul`` there, and
  weights within a few ulp (ROADMAP.md section 3, F9, open for that
  form and for one group below ~500 rows, where LLVM unrolls the dot
  loop otherwise); the replays are host loops, so past
  ``REPLAY_MAX_ROWS`` (32,768 rows at one group, 4,096 at several) the
  products are ``torch.matmul`` too;
- a one-group prediction's ``X @ w`` is XLA's CPU matrix-vector product
  (:func:`_xla_cpu_gemv`), and a prediction of several groups the
  order of its matrix product at four or more features
  (:func:`_xla_cpu_gemm`), a single-threaded order: the JAX step's bits
  are the same with ``--xla_cpu_multi_thread_eigen=false``.

With a ``reduce`` (``dsplit=row``, :mod:`xgboost_tpu_torch.parallel`),
the bias sums and each block's ``Gf`` / ``Hf`` are this rank's partial
sums, reduced over the ranks; the residual update stays local
(``gblinear.py:44-56,71-73``).
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


def _fma64(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """f32 ``a * b + c`` rounded once, on f64 arrays holding f32 values:
    the product is exact, the sum rounded to odd, then to f32
    (:func:`~xgboost_tpu_torch.objectives.fma_f32` in numpy)."""
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = (s.view(np.int64) & 1) == 1
    fix = (err != 0) & ~odd & np.isfinite(s)
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf,
                                                   -np.inf)), s)
    return s.astype(np.float32).astype(np.float64)


def _halve(v: np.ndarray) -> np.ndarray:
    """A reassociated ``llvm.vector.reduce.fadd`` of the last axis (8 or
    4 lanes) as x86 lowers it: lanes ``i + w/2`` onto ``i`` until one
    is left, in f32."""
    v = v.astype(np.float32)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _xla_loop_dot(x: np.ndarray, y: np.ndarray) -> np.float32:
    """``x . y`` of two (N,) f32 vectors in the order of XLA's CPU loop
    fusion for a vector dot (the JAX step's ``Xb.T @ g`` at one output
    group): LLVM's vectorised reduction at 8 lanes, four accumulators
    (32 rows a step) over the rows before the last 32-row step that
    would reach the end, accumulators added (1 + 0, + 2, + 3) and
    reduced by halves; then an epilogue loop started from that sum at 8
    lanes (the rest a multiple of 8) or 4 lanes (a multiple of 4), over
    all but its last step, reduced by halves; then the rows left, one
    FMA each.  A rest of 32 rows has no epilogue loop.  The shapes
    where LLVM picks fewer accumulators (a few hundred rows or less) are
    not replayed (F9)."""
    n = x.shape[0]
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    m1 = max(0, (n - 1) // 32 * 32)
    acc = np.full((4, 8), -0.0)
    acc[0, 0] = 0.0
    for i in range(0, m1, 32):
        acc = _fma64(xd[i:i + 32].reshape(4, 8), yd[i:i + 32].reshape(4, 8),
                     acc)
    a32 = acc.astype(np.float32)
    s = _halve(((a32[1] + a32[0]) + a32[2]) + a32[3])
    rest = n - m1
    vf = 4 if rest % 8 and rest % 4 == 0 else 8
    if rest < 32 and rest > vf:
        m2 = (rest - 1) // vf * vf
        e = np.full(vf, -0.0)
        e[0] = s
        for i in range(m1, m1 + m2, vf):
            e = _fma64(xd[i:i + vf], yd[i:i + vf], e)
        s = _halve(e)
        m1 += m2
    acc1 = np.asarray([s], np.float64)
    for i in range(m1, n):
        acc1 = _fma64(xd[i:i + 1], yd[i:i + 1], acc1)
    return np.float32(acc1[0])


def _fma_chain(x: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """``x @ Y`` for (N,) and (N, K) f32 in the order of XLA's CPU
    elemental dot (the JAX step's products at K > 1, block 1): the
    first row's product, then one FMA a row, in row order."""
    xd, Yd = x.astype(np.float64), Y.astype(np.float64)
    acc = (xd[0] * Yd[0]).astype(np.float32).astype(np.float64)
    for i in range(1, x.shape[0]):
        acc = _fma64(xd[i], Yd[i], acc)
    return acc.astype(np.float32)


def _update_cpu(g: torch.Tensor, h: torch.Tensor,
                d: torch.Tensor) -> torch.Tensor:
    """``g + h * d`` (N, K) on the CPU as XLA's vectorised loop computes
    it: one FMA an element, except at K = 3, where the loop's third
    column of each 8-row vector is a product rounded, then added (LLVM
    contracts the multiply-adds of the first two only); rows past the
    last whole 8 are scalar FMAs."""
    out = fma_f32(h, d, g)
    if g.shape[1] == 3:
        n8 = g.shape[0] // 8 * 8
        out[:n8, 2] = g[:n8, 2] + h[:n8, 2] * d.expand_as(h)[:n8, 2]
    return out


# The replayed orders are sequential host loops: a one-group dot takes
# N / 32 steps of numpy, a K > 1 chain N.  Past these row counts (one
# group, several) a product is ``torch.matmul`` (the JAX order within a
# few ulp), so a CPU run at full size (1M rows) takes seconds, not hours.
REPLAY_MAX_ROWS = (1 << 15, 1 << 12)


def _products_cpu(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor):
    """``(Xb @ g, (Xb * Xb) @ h)`` for a (bf, N) block on the CPU in the
    JAX package's CPU order (module docstring), or None for the forms
    that are not replayed: K > 1 at a block above 1, and more rows than
    ``REPLAY_MAX_ROWS``."""
    bf, K = Xb.shape[0], g.shape[1]
    if Xb.shape[1] > REPLAY_MAX_ROWS[K > 1]:
        return None
    xs = Xb.numpy()
    gn, hn = g.numpy(), h.numpy()
    if K == 1:
        Gf = [_xla_loop_dot(xs[j], gn[:, 0]) for j in range(bf)]
        Hf = [_xla_loop_dot(xs[j] * xs[j], hn[:, 0]) for j in range(bf)]
        return (torch.tensor(Gf, dtype=torch.float32)[:, None],
                torch.tensor(Hf, dtype=torch.float32)[:, None])
    if bf == 1:
        return (torch.from_numpy(_fma_chain(xs[0], gn))[None],
                torch.from_numpy(_fma_chain(xs[0] * xs[0], hn))[None])
    return None


def _residual_cpu(Xb: torch.Tensor, delta: torch.Tensor, g: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """``g + h * (Xb.T @ delta)`` on the CPU as XLA's code computes it:
    the row product an FMA chain over the block's columns from 0 (one
    product at block 1), then :func:`_update_cpu`; at K > 1 and a block
    above 1 the product is ``torch.matmul`` (a library GEMM in the JAX
    package, F9)."""
    bf, K = Xb.shape[0], g.shape[1]
    if K > 1 and bf > 1:
        return fma_f32(h, Xb.T @ delta, g)
    prod = torch.zeros((Xb.shape[1], K), dtype=torch.float32)
    for j in range(bf):
        prod = fma_f32(Xb[j][:, None], delta[j][None, :], prod)
    return _update_cpu(g, h, prod)


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
                       block: int = 1, reduce=None):
    """One round of bias + block-sequential coordinate updates
    (``gblinear.py:37-89``).

    XT: (F, N) feature-major dense matrix (0 = missing); gh: (N, K, 2);
    weight: (F, K); bias: (K,).  ``reduce`` sums a tensor of this
    rank's partial row sums over the ranks (``dsplit=row``).  Returns
    the new (weight, bias)."""
    _check_f32_products(XT.device)
    red = reduce if reduce is not None else (lambda x: x)
    cpu = XT.device.type == "cpu"
    g, h = gh[..., 0], gh[..., 1]                     # (N, K)
    # bias step (CalcDeltaBias)
    sum_g, sum_h = red(_row_sum(g)), red(_row_sum(h))
    dbias = eta * (-(sum_g + lam_bias * bias) / (sum_h + lam_bias + 1e-12))
    bias = bias + dbias
    # remove the bias effect
    g = _update_cpu(g, h, dbias[None, :]) if cpu else g + h * dbias[None, :]

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
        prods = _products_cpu(Xb, g, h) if cpu else None
        if prods is None:
            prods = (Xb @ g, (Xb * Xb) @ h)
        Gf, Hf = red(prods[0]), red(prods[1])         # (bf, K)
        # CalcDelta's elastic-net step
        tmp = wb - (Gf + lam * wb) / (Hf + lam)
        pos = -(Gf + lam * wb + alpha) / (Hf + lam)
        neg = -(Gf + lam * wb - alpha) / (Hf + lam)
        delta = torch.where(tmp >= 0, torch.maximum(pos, -wb),
                            torch.minimum(neg, -wb))
        delta = torch.where(Hf < 1e-5, 0.0, eta * delta)
        weight[b * bf:(b + 1) * bf] = wb + delta
        # exact residual propagation to the later blocks
        g = (_residual_cpu(Xb, delta, g, h) if cpu
             else g + h * (Xb.T @ delta))
    return weight[:F], bias


def _xla_cpu_gemm(XT: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``X @ W`` (N, K) for K > 1 from the (F, N) matrix, F >= 4, in the
    order of the JAX package's CPU product: four FMA chains over the
    features, feature k into chain ``k % 4`` up to the last whole four,
    summed ``(c0 + c1) + (c2 + c3)``, then the rest's products, each
    rounded, added left to right and added to that."""
    F = XT.shape[0]
    F4 = F // 4 * 4
    acc = [torch.zeros((XT.shape[1], W.shape[1]), dtype=torch.float32)
           for _ in range(4)]
    for k in range(F4):
        acc[k % 4] = fma_f32(XT[k][:, None], W[k][None, :], acc[k % 4])
    out = (acc[0] + acc[1]) + (acc[2] + acc[3])
    if F4 < F:
        rest = XT[F4][:, None] * W[F4][None, :]
        for k in range(F4 + 1, F):
            rest = rest + XT[k][:, None] * W[k][None, :]
        out = out + rest
    return out


def _linear_predict(XT: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """``base + bias + X @ weight`` from the (F, N) matrix, (N, K)."""
    _check_f32_products(XT.device)
    if XT.device.type == "cpu" and weight.shape[1] == 1:
        return base + bias[None, :] + _xla_cpu_gemv(XT, weight[:, 0])[:, None]
    if (XT.device.type == "cpu" and XT.shape[0] >= 4
            and XT.shape[1] <= REPLAY_MAX_ROWS[1]):
        return base + bias[None, :] + _xla_cpu_gemm(XT, weight)
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
        """One round on ``XT`` (F, N) and ``gh`` (N, K, 2); under row
        split (``mesh``, ``gblinear.py:101-130``) this rank's block, its
        row sums reduced over the ranks."""
        p = self.param
        reduce = mesh.sum if mesh is not None and mesh.world > 1 else None
        self.weight, self.bias = _linear_boost_step(
            XT, gh.to(torch.float32), self.weight, self.bias, float(p.eta),
            float(p.reg_lambda), float(p.reg_alpha), float(p.lambda_bias),
            block=max(1, p.linear_block), reduce=reduce)
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
