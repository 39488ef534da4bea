"""Kernel K4: L tenants' level histograms in one launch, hand-written CUDA.

Replaces the TPU kernel ``xgboost_tpu/ops/pallas_hist.py:
_hist_pallas_lanes_pre`` (the lane-stacked launch of ``_hist_kernel``;
raw-operand entry ``build_level_histogram_pallas_lanes``).  The CUDA
source is ``csrc/hist_lanes.cu``, which binds the scatter kernel of K1
and K3 (``csrc/hist_scatter.cuh``) with the lanes as its trees, each on
bins of its own, planned and launched as K3's
(:mod:`.cuda_hist_batched`, ``shared_bins=False``); this module holds
its wrapper, its plain PyTorch version and its launch count.

The function: for every lane ``l``, every row ``r`` with
``pos[l, r] >= 0`` and every feature ``f``, add ``gh[l, r]`` into the
cell ``[f, bins[l, r, f], :, l * n_node + pos[l, r]]`` of an
``(F, B, 2, L * n_node)`` histogram: each lane has its own bins, K1's
node-minor layout with the lanes outer in the last axis, so the split
finder runs once over ``L * n_node`` columns.  Modes as K1 (``fp32``,
``bf16``, ``int``); in mode ``int`` each lane's slice is bitwise a solo
K1 launch on that lane's rows, and pad rows and pad lanes (``pos = -1``)
add nothing.

:func:`level_histogram_lanes` launches the kernel for a CUDA tensor and
runs :func:`level_histogram_lanes_plain` for a CPU tensor; any other
device raises.
"""

from __future__ import annotations

import threading

import torch

from xgboost_tpu_torch.ops import cuda_hist_batched
from xgboost_tpu_torch.ops.cuda_hist import MODES

# launches of the CUDA kernel by level_histogram_lanes (never by the
# plain version)
launches = 0
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


def _check(bins, gh, pos, n_node, n_bin, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {sorted(MODES)}")
    if bins.dim() != 3 or gh.shape != (*bins.shape[:2], 2) \
            or pos.shape != bins.shape[:2]:
        raise ValueError(f"shapes: bins {tuple(bins.shape)}, gh "
                         f"{tuple(gh.shape)}, pos {tuple(pos.shape)}: want "
                         "(L, N, F), (L, N, 2) and (L, N)")
    want = torch.int32 if mode == "int" else torch.float32
    if gh.dtype != want or pos.dtype != torch.int32:
        raise TypeError(f"mode {mode}: gh must be {want} (got {gh.dtype}), "
                        f"pos int32 (got {pos.dtype})")
    if n_node < 1 or n_bin < 1:
        raise ValueError(f"n_node={n_node}, n_bin={n_bin}")


def level_histogram_lanes(bins: torch.Tensor, gh: torch.Tensor,
                          pos: torch.Tensor, n_node: int, n_bin: int,
                          mode: str) -> torch.Tensor:
    """K4: bins (L, N, F) u8, gh (L, N, 2), pos (L, N) int32 -> the
    ``(F, n_bin, 2, L * n_node)`` histogram, f32 (int32 in mode
    "int").  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    _check(bins, gh, pos, n_node, n_bin, mode)
    if bins.device.type == "cpu":
        return level_histogram_lanes_plain(bins, gh, pos, n_node, n_bin,
                                           mode)
    if bins.device.type != "cuda":
        raise NotImplementedError(f"no histogram kernel for {bins.device}")
    return _launch(bins, gh, pos, n_node, n_bin, mode)


def _launch(bins, gh, pos, n_node, n_bin, mode):
    global launches
    L, N, F = bins.shape
    out = cuda_hist_batched.scatter_launch("hist_lanes", bins, gh, pos, L,
                                           n_node, n_bin, mode)
    if out is None:
        acc = torch.int32 if mode == "int" else torch.float32
        return torch.zeros((F, n_bin, 2, L * n_node), dtype=acc,
                           device=bins.device)
    with _COUNT_LOCK:     # lane threads launch at once
        launches += 1
    return out


def lane_cell_index(bins: torch.Tensor, pos: torch.Tensor, n_node: int,
                    n_bin: int) -> torch.Tensor:
    """(L, N, F, 2) int64 flat cell of each (lane, row, feature,
    channel) in the ``(F, n_bin, 2, L * n_node)`` histogram; inactive
    rows, and bins >= B (binning never makes them; the kernel skips
    them), point at the dump cell ``F * n_bin * 2 * L * n_node``."""
    L, N, F = bins.shape
    dev = bins.device
    n_col = L * n_node
    col = (torch.arange(L, dtype=torch.int64, device=dev)[:, None] * n_node
           + pos.to(torch.int64))                                  # (L, N)
    f_ids = torch.arange(F, dtype=torch.int64, device=dev)
    b64 = bins.to(torch.int64)
    base = ((f_ids * n_bin + b64) * 2) * n_col + col[:, :, None]  # (L,N,F)
    idx = base[..., None] + torch.tensor([0, n_col], dtype=torch.int64,
                                         device=dev)
    keep = (pos >= 0)[:, :, None] & (b64 < n_bin)                  # (L,N,F)
    return torch.where(keep[..., None], idx, F * n_bin * 2 * n_col)


def level_histogram_lanes_plain(bins: torch.Tensor, gh: torch.Tensor,
                                pos: torch.Tensor, n_node: int, n_bin: int,
                                mode: str) -> torch.Tensor:
    """Plain PyTorch K4 on any device: one ``index_add_`` over the
    lane-offset cell indices of :func:`lane_cell_index`.  A cell takes
    additions from one lane only, and on the CPU in row order, so each
    lane's slice is bitwise K1's plain version on that lane's rows."""
    _check(bins, gh, pos, n_node, n_bin, mode)
    L, N, F = bins.shape
    n_cells = F * n_bin * 2 * L * n_node
    if mode == "bf16":
        gh = gh.to(torch.bfloat16).to(torch.float32)
    idx = lane_cell_index(bins, pos, n_node, n_bin)
    src = gh[:, :, None, :].expand(L, N, F, 2)
    out = torch.zeros(n_cells + 1, dtype=gh.dtype, device=bins.device)
    out.index_add_(0, idx.reshape(-1), src.reshape(-1))
    return out[:n_cells].reshape(F, n_bin, 2, L * n_node)
