"""Kernel K2: per-node (G, H) sums, hand-written CUDA.

Replaces the TPU kernel ``xgboost_tpu/ops/pallas_hist.py:_nst_kernel``
(launched through ``node_stats_pallas``).  The CUDA source is
``csrc/node_stats.cu``; this module holds its wrapper, its plain PyTorch
version and its launch count.

The function: gh (T, N, 2) f32 and pos (T, N) int32 -> (T, n_node, 2)
f32, ``out[t, m] = sum of gh[t, r] over the rows with pos[t, r] == m``;
rows with ``pos < 0`` are dropped.  The kernel sums in a fixed order
(per-block partials, then the blocks in index order), so its result is
the same bits from run to run; it differs from the plain version's
order by f32 rounding only.

:func:`node_stats` launches the kernel for a CUDA tensor and runs
:func:`node_stats_plain` for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from xgboost_tpu_torch.ops import nvcc

ROWS_PER_BLOCK = 4096          # rows of one pass-1 block (csrc/node_stats.cu)

# launches of the CUDA kernel by node_stats (never by the plain version)
launches = 0
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


def _check(gh, pos, n_node):
    if gh.dim() != 3 or gh.shape[2] != 2 or pos.shape != gh.shape[:2]:
        raise ValueError(f"shapes: gh {tuple(gh.shape)}, pos "
                         f"{tuple(pos.shape)}: want (T, N, 2) and (T, N)")
    if gh.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError(f"gh must be float32 (got {gh.dtype}), pos int32 "
                        f"(got {pos.dtype})")
    if n_node < 1:
        raise ValueError(f"n_node={n_node}")


def node_stats(gh: torch.Tensor, pos: torch.Tensor,
               n_node: int) -> torch.Tensor:
    """K2: (T, n_node, 2) f32 node sums.  CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    _check(gh, pos, n_node)
    if gh.device.type == "cpu":
        return node_stats_plain(gh, pos, n_node)
    if gh.device.type != "cuda":
        raise NotImplementedError(f"no node-stat kernel for {gh.device}")
    return _launch(gh, pos, n_node)


def _launch(gh, pos, n_node):
    global launches
    if gh.device != pos.device:
        raise ValueError("gh and pos must be on one device")
    if not (gh.is_contiguous() and pos.is_contiguous()) \
            or gh.data_ptr() % 8:
        raise ValueError("gh and pos must be contiguous, gh 8-aligned")
    T, N, _ = gh.shape
    out = torch.empty((T, n_node, 2), dtype=torch.float32, device=gh.device)
    if N == 0 or T == 0:
        return out.zero_()
    n_blocks = -(-N // ROWS_PER_BLOCK)
    part = torch.empty((n_blocks, T, n_node, 2), dtype=torch.float32,
                       device=gh.device)
    lib = _lib()
    with torch.cuda.device(gh.device):     # the launch targets this card
        stream = torch.cuda.current_stream(gh.device).cuda_stream
        rc = lib.node_stats_launch(pos.data_ptr(), gh.data_ptr(),
                                   part.data_ptr(), out.data_ptr(), N, T,
                                   n_node, n_blocks, ROWS_PER_BLOCK, stream)
    if rc != 0:
        raise RuntimeError("node_stats kernel launch failed: "
                           + lib.node_stats_error_string(rc).decode())
    with _COUNT_LOCK:     # lane threads launch at once
        launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = nvcc.load("node_stats")
    if lib.node_stats_launch.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.node_stats_launch.argtypes = [P, P, P, P, L, I, I, I, L, P]
        lib.node_stats_launch.restype = I
        lib.node_stats_error_string.argtypes = [I]
        lib.node_stats_error_string.restype = ctypes.c_char_p
    return lib


def node_stats_plain(gh: torch.Tensor, pos: torch.Tensor,
                     n_node: int) -> torch.Tensor:
    """Plain PyTorch K2 on any device: one ``index_add_`` into
    ``n_node + 1`` slots per tree (the last one takes the dropped rows,
    the JAX scatter's ``mode="drop"``).  On the CPU the adds run in row
    order, the order of the JAX scatter."""
    _check(gh, pos, n_node)
    T, N, _ = gh.shape
    slot = torch.where(pos < 0, n_node, pos).to(torch.int64)
    idx = slot + (n_node + 1) * torch.arange(
        T, dtype=torch.int64, device=gh.device)[:, None]
    out = torch.zeros((T * (n_node + 1), 2), dtype=torch.float32,
                      device=gh.device)
    out.index_add_(0, idx.reshape(-1), gh.reshape(-1, 2))
    return out.reshape(T, n_node + 1, 2)[:, :n_node]
