"""Split gain math and the vectorized best-split search (port of
``xgboost_tpu/ops/split.py``).

Candidates are ``(feature, cut, default_direction)`` flattened feature
major, and the winner is the FIRST maximum (``torch.argmax`` returns the
first maximal index), which gives the reference's lowest-feature-wins
tie-break.  Directions: 0 = missing goes right, 1 = missing goes left.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xgboost_tpu_torch.objectives import fma_f32

NEG = -1e30
RT_EPS = 1e-6  # reference rt_eps accept threshold
SCAN_BLOCK = 16


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along ``dim`` in a fixed order: running
    sums within blocks of 16, then each block plus the running total of
    the blocks before it.  That is the order of the JAX package's
    ``jnp.cumsum`` on the CPU (XLA's blocked scan), so the split search
    matches it bit for bit; the order is the same on every device
    (``torch.cumsum`` accumulates in f64 on the CPU and in a parallel
    order on a GPU)."""
    x = x.movedim(dim, -1)
    return _prefix_sum_last(x).movedim(-1, dim)


def _prefix_sum_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        acc = torch.zeros_like(x[..., 0])
        cols = []
        for j in range(n):
            acc = acc + x[..., j]
            cols.append(acc)
        return torch.stack(cols, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    inner = _prefix_sum_last(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    outer = _prefix_sum_last(inner[..., -1])
    before = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                       dim=-1)
    out = inner + before[..., None]
    return out.reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]


class SplitConfig(NamedTuple):
    """Split hyperparameters (the subset of TrainParam used here)."""
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    max_delta_step: float = 0.0
    min_child_weight: float = 1.0
    gamma: float = 0.0
    eta: float = 0.3
    default_direction: int = 0  # 0=learn, 1=left, 2=right


class FusedSplitConfig(SplitConfig):
    """The growers' SplitConfig (``gbtree.make_grow_config``): its gains
    under ``max_delta_step`` are computed on the CPU as the JAX package's
    jitted growers compute them (:func:`calc_gain`, F10), not as its
    functions run op by op."""
    __slots__ = ()


def _threshold_l1(w, alpha):
    return torch.sign(w) * torch.clamp_min(torch.abs(w) - alpha, 0.0)


def calc_weight(G, H, cfg: SplitConfig):
    """Leaf weight (reference CalcWeight, param.h:138-152)."""
    dw = -_threshold_l1(G, cfg.reg_alpha) / (H + cfg.reg_lambda)
    if cfg.max_delta_step != 0.0:
        dw = torch.clamp(dw, -cfg.max_delta_step, cfg.max_delta_step)
    return torch.where(H < cfg.min_child_weight, 0.0, dw)


def calc_gain(G, H, cfg: SplitConfig):
    """Node objective reduction (reference CalcGain, param.h:109-126);
    min_child_weight is enforced by the finder on both children.

    Under ``max_delta_step`` with a :class:`FusedSplitConfig` the CPU
    rounds ``G * w + t``, ``t = 0.5 * (H + lambda) * w * w``, once,
    ``fma(G, w, t)``, as XLA's CPU backend contracts it in the JAX
    package's jitted growers (F10); the alpha term is added after it.
    Otherwise, and on a GPU, two roundings, as the JAX functions run op
    by op."""
    if cfg.max_delta_step == 0.0:
        t = _threshold_l1(G, cfg.reg_alpha) if cfg.reg_alpha != 0.0 else G
        return t * t / (H + cfg.reg_lambda)
    w = calc_weight(G, H, cfg)
    t = 0.5 * (H + cfg.reg_lambda) * w * w
    if isinstance(cfg, FusedSplitConfig) and G.device.type == "cpu":
        ret = fma_f32(G, w, t)
    else:
        ret = G * w + t
    if cfg.reg_alpha != 0.0:
        ret = ret + cfg.reg_alpha * torch.abs(w)
    return -2.0 * ret


class BestSplit(NamedTuple):
    gain: torch.Tensor          # (n_node,) f32 loss_chg of the best split
    feature: torch.Tensor       # (n_node,) int32
    cut_index: torch.Tensor     # (n_node,) int32 (left iff bin <= cut+1)
    default_left: torch.Tensor  # (n_node,) bool
    valid: torch.Tensor         # (n_node,) bool: accept the split
    left_g: torch.Tensor        # (n_node,) f32 winner's left-child sums,
    left_h: torch.Tensor        # missing mass included when it goes left


def find_best_splits_native(hist: torch.Tensor, nstats: torch.Tensor,
                            n_cuts: torch.Tensor, cfg: SplitConfig,
                            feature_mask: Optional[torch.Tensor] = None
                            ) -> BestSplit:
    """Best split per node from a ``(F, B, 2, n_node)`` histogram (bin 0
    = missing), ``nstats`` (n_node, 2) node totals, ``n_cuts`` (F,)
    valid cuts per feature (``split.py:147-201``), or (F, n_node): one
    count per column, for lane-stacked levels whose tenants have cuts
    of their own.  Only the valid-cut mask reads ``n_cuts``.
    ``feature_mask`` (F,) bool, or (F, n_node): one column mask per node
    (each tree's or lane's sampled features on its own columns), keeps
    the candidates of the features it holds."""
    F, B, _, n_node = hist.shape
    C = B - 2
    cum = prefix_sum(hist, dim=1)                       # (F, B, 2, M)
    miss = hist[:, 0, :, :]                             # (F, 2, M)
    total = nstats.T[None, None, None, :, :]            # (1, 1, 1, 2, M)

    left_excl = cum[:, 1:C + 1, :, :] - miss[:, None, :, :]
    left = torch.stack([left_excl, left_excl + miss[:, None, :, :]],
                       dim=2)                           # (F, C, 2dir, 2, M)
    right = total - left

    GL, HL = left[..., 0, :], left[..., 1, :]           # (F, C, 2dir, M)
    GR, HR = right[..., 0, :], right[..., 1, :]
    root_gain = calc_gain(nstats[:, 0], nstats[:, 1], cfg)
    loss_chg = (calc_gain(GL, HL, cfg) + calc_gain(GR, HR, cfg)
                - root_gain[None, None, None, :])

    ok = (HL >= cfg.min_child_weight) & (HR >= cfg.min_child_weight)
    cut_ids = torch.arange(C, dtype=torch.int32, device=hist.device)
    if n_cuts.dim() == 1:
        ok &= (cut_ids[None, :] < n_cuts[:, None])[:, :, None, None]
    else:   # (F, C, M) per column
        ok &= (cut_ids[None, :, None] < n_cuts[:, None, :])[:, :, None, :]
    if feature_mask is not None:
        fm = feature_mask
        if fm.dim() == 1:
            fm = fm[:, None]
        ok &= fm[:, None, None, :]
    if cfg.default_direction in (1, 2):   # forced left / forced right
        dirs = torch.tensor([cfg.default_direction == 2,
                             cfg.default_direction == 1], device=hist.device)
        ok &= dirs[None, None, :, None]
    loss_chg = torch.where(ok, loss_chg, NEG)

    flat = loss_chg.reshape(F * C * 2, n_node)
    best = torch.argmax(flat, dim=0)    # first max -> lowest feature
    best_gain = flat.amax(dim=0)
    feature = torch.div(best, C * 2, rounding_mode="floor").to(torch.int32)
    cut_index = (torch.div(best, 2, rounding_mode="floor") % C
                 ).to(torch.int32)
    default_left = (best % 2).to(torch.bool)
    # accept a positive reduction; gamma is the prune updater's job
    valid = best_gain > RT_EPS
    # "+ 0.0": the JAX package reads the winner with a one-hot sum, which
    # turns a -0 into +0; the gather must agree to the sign of zero
    left_g = GL.reshape(F * C * 2, n_node).gather(0, best[None, :])[0] + 0.0
    left_h = HL.reshape(F * C * 2, n_node).gather(0, best[None, :])[0] + 0.0
    return BestSplit(best_gain, feature, cut_index, default_left, valid,
                     left_g, left_h)


def find_best_splits(hist: torch.Tensor, nstats: torch.Tensor,
                     n_cuts: torch.Tensor, cfg: SplitConfig,
                     feature_mask: Optional[torch.Tensor] = None
                     ) -> BestSplit:
    """The same search on the standard ``(n_node, F, B, 2)`` layout
    (``split.py:82-144``)."""
    return find_best_splits_native(hist.permute(1, 2, 3, 0), nstats, n_cuts,
                                   cfg, feature_mask)
