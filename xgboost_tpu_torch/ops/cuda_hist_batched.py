"""Kernel K3: T trees' level histograms over one shared bins matrix,
hand-written CUDA.

Replaces the TPU kernel ``xgboost_tpu/ops/pallas_hist.py:
_batched_hist_kernel`` (launched through ``_hist_pallas_batched_pre``).
The CUDA source is ``csrc/hist_batched.cu``; this module holds its
wrapper, its plain PyTorch version and its launch count.

The function: for every tree ``t``, every row ``r`` with
``pos[t, r] >= 0`` and every feature ``f``, add ``gh[t, r]`` into the
cell ``[f, bins[r, f], :, t * n_node + pos[t, r]]`` of an
``(F, B, 2, T * n_node)`` histogram: K1's node-minor layout with the
trees outer in the last axis, so the split finder runs once over
``T * n_node`` independent nodes.  Modes as K1 (``fp32``, ``bf16``,
``int``); in mode ``int`` each tree's slice is bitwise a solo K1 launch
on that tree's gh and pos.

:func:`level_histogram_batched` launches the kernel for a CUDA tensor
and runs :func:`level_histogram_batched_plain` for a CPU tensor; any
other device raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from xgboost_tpu_torch.ops import nvcc
from xgboost_tpu_torch.ops.cuda_hist import (BLOCKS_PER_SM, MODES, THREADS,
                                             level_histogram_plain)

T_TILE_MAX = 8                 # trees per block (csrc/hist_batched.cu)
M_TILE_MAX = 64                # nodes per block
SMEM_BUDGET = 96 * 1024        # per block: two blocks fit on an SM
SMEM_MAX = 227 * 1024          # the opt-in limit of one block on Hopper

# launches of the CUDA kernel by level_histogram_batched (never by the
# plain version)
launches = 0
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


def tiling(n_rows: int, n_feat: int, n_bin: int, n_tree: int, n_node: int,
           n_sm: int) -> Tuple[int, int, int, int, int, int]:
    """(f_tile, t_tile, m_tile, n_row_blocks, rows_per_block, smem_bytes)
    of one launch.  A block's shared histogram holds f_tile features x B
    bins x 2 channels x t_tile trees x m_tile nodes of 4 bytes; node
    tiles, then tree tiles, halve until one feature fits in a block's
    shared memory; features fill the budget; enough row blocks give
    every SM several blocks."""
    t_tile = min(n_tree, T_TILE_MAX)
    m_tile = min(n_node, M_TILE_MAX)

    def per_feat():
        return n_bin * 2 * t_tile * m_tile * 4
    while per_feat() > SMEM_MAX and m_tile > 1:
        m_tile = -(-m_tile // 2)
    while per_feat() > SMEM_MAX and t_tile > 1:
        t_tile = -(-t_tile // 2)
    f_tile = max(1, min(n_feat, SMEM_BUDGET // per_feat()))
    n_tiles = (-(-n_feat // f_tile)) * (-(-n_tree // t_tile)) \
        * (-(-n_node // m_tile))
    want = max(1, -(-BLOCKS_PER_SM * n_sm // n_tiles))
    n_row_blocks = max(1, min(want, -(-n_rows // THREADS)))
    rows_per_block = -(-max(n_rows, 1) // n_row_blocks)
    return (f_tile, t_tile, m_tile, n_row_blocks, rows_per_block,
            f_tile * per_feat())


def _check(bins, gh, pos, n_node, n_bin, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {sorted(MODES)}")
    if bins.dim() != 2 or gh.dim() != 3 or gh.shape[1:] != (
            bins.shape[0], 2) or pos.shape != gh.shape[:2]:
        raise ValueError(f"shapes: bins {tuple(bins.shape)}, gh "
                         f"{tuple(gh.shape)}, pos {tuple(pos.shape)}")
    want = torch.int32 if mode == "int" else torch.float32
    if gh.dtype != want or pos.dtype != torch.int32:
        raise TypeError(f"mode {mode}: gh must be {want} (got {gh.dtype}), "
                        f"pos int32 (got {pos.dtype})")
    if n_node < 1 or n_bin < 1:
        raise ValueError(f"n_node={n_node}, n_bin={n_bin}")


def level_histogram_batched(bins: torch.Tensor, gh: torch.Tensor,
                            pos: torch.Tensor, n_node: int, n_bin: int,
                            mode: str) -> torch.Tensor:
    """K3: bins (N, F) u8, gh (T, N, 2), pos (T, N) int32 -> the
    ``(F, n_bin, 2, T * n_node)`` histogram, f32 (int32 in mode
    "int").  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    _check(bins, gh, pos, n_node, n_bin, mode)
    if bins.device.type == "cpu":
        return level_histogram_batched_plain(bins, gh, pos, n_node, n_bin,
                                             mode)
    if bins.device.type != "cuda":
        raise NotImplementedError(f"no histogram kernel for {bins.device}")
    return _launch(bins, gh, pos, n_node, n_bin, mode)


def _launch(bins, gh, pos, n_node, n_bin, mode):
    global launches
    if not (gh.device == pos.device == bins.device):
        raise ValueError("bins, gh and pos must be on one device")
    if bins.dtype != torch.uint8 or n_bin > 256:
        raise NotImplementedError(
            f"the CUDA histogram takes u8 bins with B <= 256 (got "
            f"{bins.dtype}, B={n_bin})")
    if not (bins.is_contiguous() and gh.is_contiguous()
            and pos.is_contiguous()) or gh.data_ptr() % 8:
        raise ValueError("bins, gh and pos must be contiguous, gh 8-aligned")
    T, N, _ = gh.shape
    F = bins.shape[1]
    acc = torch.int32 if mode == "int" else torch.float32
    out = torch.zeros((F, n_bin, 2, T * n_node), dtype=acc,
                      device=bins.device)
    if N == 0 or F == 0 or T == 0:
        return out
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    f_tile, t_tile, m_tile, n_rb, rpb, smem = tiling(N, F, n_bin, T, n_node,
                                                     n_sm)
    lib = _lib()
    with torch.cuda.device(bins.device):   # the launch targets this card
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        rc = lib.hist_batched_launch(
            MODES[mode], bins.data_ptr(), pos.data_ptr(), gh.data_ptr(),
            out.data_ptr(), N, F, n_bin, T, n_node, f_tile, t_tile, m_tile,
            n_rb, rpb, THREADS, smem, stream)
    if rc != 0:
        raise RuntimeError("hist_batched kernel launch failed: "
                           + lib.hist_batched_error_string(rc).decode())
    with _COUNT_LOCK:     # lane threads launch at once
        launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = nvcc.load("hist_batched")
    if lib.hist_batched_launch.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hist_batched_launch.argtypes = [I, P, P, P, P, L, I, I, I, I, I,
                                            I, I, I, L, I, L, P]
        lib.hist_batched_launch.restype = I
        lib.hist_batched_error_string.argtypes = [I]
        lib.hist_batched_error_string.restype = ctypes.c_char_p
    return lib


def level_histogram_batched_plain(bins: torch.Tensor, gh: torch.Tensor,
                                  pos: torch.Tensor, n_node: int,
                                  n_bin: int, mode: str) -> torch.Tensor:
    """Plain PyTorch K3 on any device: per tree, K1's plain version (one
    ``index_add_`` over flat cell indices), the trees concatenated
    along the node axis."""
    _check(bins, gh, pos, n_node, n_bin, mode)
    return torch.cat([level_histogram_plain(bins, gh[t], pos[t], n_node,
                                            n_bin, mode)
                      for t in range(gh.shape[0])], dim=-1)
