"""Kernel K1: one tree level's gradient histogram, hand-written CUDA.

Replaces the TPU kernel ``xgboost_tpu/ops/pallas_hist.py:_hist_kernel``
(launched through ``_hist_pallas_pre``).  The CUDA source is
``csrc/hist_level.cu``: the scatter kernel of ``csrc/hist_scatter.cuh``
at T = 1, planned and launched as K3's (:mod:`.cuda_hist_batched`).
This module holds K1's wrapper, its plain PyTorch version and its
launch count.

The function: for every row ``r`` with ``pos[r] >= 0`` and every feature
``f``, add ``gh[r]`` into the cell ``[f, bins[r, f], :, pos[r]]`` of a
``(F, B, 2, n_node)`` histogram (node minor: the layout the split finder
reads).  Three modes:

- ``"fp32"``: f32 gh, f32 sums;
- ``"bf16"``: gh rounded to bf16, f32 sums;
- ``"int"``: int32 gh (already quantized by :func:`quantize_gh` or the
  "fixed" encoding), exact int32 sums.

:func:`level_histogram` launches the kernel for a CUDA tensor and runs
:func:`level_histogram_plain` for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch


MODES = {"fp32": 0, "bf16": 1, "int": 2}

# launches of the CUDA kernel by level_histogram (never by the plain version)
launches = 0
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


def resolve_precision(precision: str, n_rows: int) -> str:
    """int8 needs int32-safe cell sums (N * 127 < 2^31), else bf16
    (``pallas_hist.py:126-130``)."""
    if precision == "int8" and n_rows * 127 >= 2 ** 31:
        return "bf16"
    return precision


def quantize_gh(gh: torch.Tensor, scale_reduce=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization of (N, 2) grad/hess:
    ``(gh_q int32, scale f32)``, with the op order of
    ``pallas_hist.py:152-162`` so the bits match: the scale is the
    channel's max |gh| over ALL rows (every rank's, after
    ``scale_reduce``, under row split), rounding is half to even."""
    amax = gh.abs().amax(dim=-2)
    if scale_reduce is not None:
        amax = scale_reduce(amax)
    scale = torch.clamp_min(amax, 1e-30)
    gh_q = torch.clamp(torch.round(gh / scale[..., None, :] * 127.0),
                       -127, 127).to(torch.int32)
    return gh_q, scale


def _check(bins, gh, pos, n_node, n_bin, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {sorted(MODES)}")
    if bins.dim() != 2 or gh.shape != (bins.shape[0], 2) \
            or pos.shape != (bins.shape[0],):
        raise ValueError(f"shapes: bins {tuple(bins.shape)}, gh "
                         f"{tuple(gh.shape)}, pos {tuple(pos.shape)}")
    want = torch.int32 if mode == "int" else torch.float32
    if gh.dtype != want or pos.dtype != torch.int32:
        raise TypeError(f"mode {mode}: gh must be {want} (got {gh.dtype}), "
                        f"pos int32 (got {pos.dtype})")
    if n_node < 1 or n_bin < 1:
        raise ValueError(f"n_node={n_node}, n_bin={n_bin}")


def level_histogram(bins: torch.Tensor, gh: torch.Tensor, pos: torch.Tensor,
                    n_node: int, n_bin: int, mode: str) -> torch.Tensor:
    """K1: the level histogram ``(F, n_bin, 2, n_node)``, f32 (int32 in
    mode "int").  CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    _check(bins, gh, pos, n_node, n_bin, mode)
    if bins.device.type == "cpu":
        return level_histogram_plain(bins, gh, pos, n_node, n_bin, mode)
    if bins.device.type != "cuda":
        raise NotImplementedError(f"no histogram kernel for {bins.device}")
    return _launch(bins, gh, pos, n_node, n_bin, mode)


def _launch(bins, gh, pos, n_node, n_bin, mode):
    global launches
    # K1 is K3's scatter kernel at T = 1 (csrc/hist_scatter.cuh); the plan
    # and the launch live beside K3's wrapper, which imports this module
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    out = kb.scatter_launch("hist_level", bins, gh, pos, 1, n_node, n_bin,
                            mode)
    if out is None:
        acc = torch.int32 if mode == "int" else torch.float32
        return torch.zeros((bins.shape[1], n_bin, 2, n_node), dtype=acc,
                           device=bins.device)
    with _COUNT_LOCK:     # lane threads launch at once
        launches += 1
    return out


def level_histogram_plain(bins: torch.Tensor, gh: torch.Tensor,
                          pos: torch.Tensor, n_node: int, n_bin: int,
                          mode: str) -> torch.Tensor:
    """Plain PyTorch K1 on any device: flat cell index
    ``((f * B + bin) * 2 + c) * n_node + pos`` and one ``index_add_``;
    inactive rows add into a dump cell that is cut off (the "drop" of
    the JAX scatter, ``ops/histogram.py:284-294``), and so do bins >= B,
    which binning never makes and the kernel skips.  On the CPU the adds
    run in row order, the order of the JAX scatter."""
    _check(bins, gh, pos, n_node, n_bin, mode)
    N, F = bins.shape
    dev = bins.device
    n_cells = F * n_bin * 2 * n_node
    if mode == "bf16":
        gh = gh.to(torch.bfloat16).to(torch.float32)
    f_ids = torch.arange(F, dtype=torch.int64, device=dev)
    b64 = bins.to(torch.int64)
    base = ((f_ids[None, :] * n_bin + b64) * 2) * n_node \
        + pos.to(torch.int64)[:, None]                       # (N, F)
    chan = torch.tensor([0, n_node], dtype=torch.int64, device=dev)
    idx = base[:, :, None] + chan                            # (N, F, 2)
    keep = (pos >= 0)[:, None] & (b64 < n_bin)               # (N, F)
    idx = torch.where(keep[:, :, None], idx, n_cells)
    src = gh[:, None, :].expand(N, F, 2)
    out = torch.zeros(n_cells + 1, dtype=gh.dtype, device=dev)
    out.index_add_(0, idx.reshape(-1), src.reshape(-1))
    return out[:n_cells].reshape(F, n_bin, 2, n_node)
