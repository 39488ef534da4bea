"""Kernels T5, T3, T2 and T7: the one-hot histogram prototypes of the TPU
rounds, hand-written CUDA for the tensor cores.

Each replaces one Pallas prototype in ``tools/`` and keeps its argument
list and output layout:

- :func:`onehot_variant` (T5, ``tools/hist_microbench.py:variant``):
  ``(n_node, F, B, 2)`` f32, any ``n_node`` in node tiles of 64, bf16 or
  exact f32 products; source ``csrc/onehot_variant.cu``;
- :func:`onehot_i8` (T3, ``tools/hist_int8_proto.py:build_i8``): int8
  products of feature-major int32 bins, ``(1, F * B, 2 * m_pad)`` int32;
  source ``csrc/onehot_i8.cu``;
- :func:`onehot_notrans` (T2, ``tools/hist_notrans_proto.py:build``): the
  same on row-major u8 bins; source ``csrc/onehot_notrans.cu``;
- :func:`onehot_r5` (T7, ``tools/hist_r5_ab.py:build``): int8 products of
  feature-major u8 bins at M = 64, ``n_levels`` level operands against one
  one-hot, ``(n_levels, F * B, 128)`` int32; source ``csrc/onehot_r5.cu``.

The four share the device code of ``csrc/onehot_mma.cuh``.  Each has a
plain PyTorch version (``*_plain``) with the prototype's exact semantics,
which the kernel matches:

- T3, T2, T7 count only the first ``(n // r_tile) * r_tile`` rows (their
  grids drop the rest) and wrap ``gh`` to int8 (``astype(int8)``); sums
  are int32 and wrap.
- T7 with ``n_levels > 1``: row r is active in node j at level lv iff
  ``floor_mod(pos[r] + lv, M) == j``, so pad rows (pos = -1) count.
- T5: rows with ``pos < 0`` or ``pos >= n_node`` add nothing; ``gh`` is
  rounded to bf16 (nearest even) when ``precision == "bf16"`` or
  ``hot_dtype`` is bf16, as the TPU's matrix unit rounds it.  (The JAX
  function run on a CPU sums unrounded f32 there.)  ``bin_dtype`` changes
  the bytes read, never the result.

A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
or raises; any other device raises.  Each kernel has a launch counter in
:data:`COUNTERS`, raised by one where its wrapper launches it and
nowhere else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from xgboost_tpu_torch.ops import nvcc

THREADS = 256                  # 8 warps a block (onehot_mma.cuh)
BIN_TILES = 5                  # bin tiles of 16 per task
COL_TILES = 4                  # column tiles of 8 per task (1 with levels)
LEVELS_PER_TASK = 6            # level operands per task when n_levels > 1
STEP_ROWS = 2048               # rows a block stages per step (T3, T2, T7)
BLOCKS_PER_SM = 4
M_TILE = 64                    # T5's node tile; T7's M
R5_R_TILE = 2048               # tools/hist_r5_ab.py:R_TILE


class Counter:
    """One kernel's launch count: ``launches`` goes up by one where the
    wrapper launches the kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._lock = threading.Lock()

    def reset_launches(self) -> None:
        with self._lock:
            self.launches = 0

    def add(self) -> None:
        with self._lock:
            self.launches += 1


COUNTERS: Dict[str, Counter] = {
    name: Counter(name)
    for name in ("onehot_variant", "onehot_i8", "onehot_notrans",
                 "onehot_r5")}


class OnehotArgs(ctypes.Structure):
    """``struct OnehotArgs`` of ``csrc/onehot_mma.cuh``, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("bins", "pos", "gh", "out")]
                + [(n, ctypes.c_longlong) for n in (
                    "bin_sr", "bin_sf", "gh_sr", "gh_sc", "s_lv", "s_f",
                    "s_b", "s_c", "s_node", "n_rows", "rows_per_block")]
                + [(n, ctypes.c_int) for n in (
                    "n_feat", "n_bin", "m_pad", "n_node_out", "n_levels",
                    "n_bg", "n_cg", "n_lg", "n_mt", "r_tile")])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiling(n_rows: int, n_feat: int, n_bin: int, m_pad: int, n_levels: int,
           n_mt: int, r_tile: int, col_tiles: int, levels_per_task: int,
           n_sm: int) -> Tuple[int, int, int, int, int]:
    """(n_bg, n_cg, n_lg, n_row_blocks, rows_per_block) of one launch:
    the task groups of one block (bin tiles, column tiles, levels) and
    enough row chunks, each a whole number of ``r_tile`` steps, to give
    every SM a few blocks."""
    n_bg = _cdiv(_cdiv(n_bin, 16), BIN_TILES)
    n_cg = _cdiv(_cdiv(2 * m_pad, 8), col_tiles)
    n_lg = _cdiv(n_levels, levels_per_task)
    steps = max(1, _cdiv(n_rows, r_tile))
    want = _cdiv(BLOCKS_PER_SM * n_sm, n_feat * n_bg * n_cg * n_lg * n_mt)
    rows_per_block = _cdiv(steps, max(1, min(steps, want))) * r_tile
    return n_bg, n_cg, n_lg, _cdiv(max(n_rows, 1), rows_per_block), \
        rows_per_block


def _col_tiles(m_pad: int) -> int:
    """Column tiles of 8 per task: one where all 2 * m_pad columns fit
    (M <= 4: the kernel instance with 20 accumulator registers, two
    blocks an SM), else four."""
    return 1 if 2 * m_pad <= 8 else COL_TILES


def _device(*ts: torch.Tensor) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no one-hot histogram kernel for {dev}")
    return dev.type


def _launch(name: str, variant: int, bins: torch.Tensor, pos: torch.Tensor,
            gh: torch.Tensor, out: torch.Tensor, *, bin_sr: int,
            bin_sf: int, gh_sr: int, gh_sc: int,
            out_strides: Tuple[int, int, int, int, int], n_rows: int,
            n_feat: int, n_bin: int, m_pad: int, n_node_out: int,
            n_levels: int, mod_levels: bool, n_mt: int, r_tile: int,
            col_tiles: int, levels_per_task: int) -> torch.Tensor:
    if not (bins.is_contiguous() and pos.is_contiguous()
            and gh.is_contiguous() and out.is_contiguous()):
        raise ValueError("bins, pos, gh and out must be contiguous")
    if n_bin > 256 or r_tile % THREADS or not 0 < r_tile <= STEP_ROWS \
            or not 0 < m_pad <= 128 or (mod_levels and m_pad & (m_pad - 1)):
        raise NotImplementedError(
            f"the one-hot kernels take B <= 256, up to 128 nodes a tile (a "
            f"power of two with levels) and a row step that is a multiple "
            f"of {THREADS} up to {STEP_ROWS} (got B={n_bin}, m_pad={m_pad}, "
            f"r_tile={r_tile})")
    if n_rows == 0 or n_feat == 0:
        return out
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    n_bg, n_cg, n_lg, n_rb, rpb = tiling(
        n_rows, n_feat, n_bin, m_pad, n_levels, n_mt, r_tile, col_tiles,
        levels_per_task, n_sm)
    if n_bg * n_cg * n_lg * n_mt > 65535 or n_rb > 65535:
        raise NotImplementedError("too many node tiles for one launch")
    args = OnehotArgs(
        bins.data_ptr(), pos.data_ptr(), gh.data_ptr(), out.data_ptr(),
        bin_sr, bin_sf, gh_sr, gh_sc, *out_strides, n_rows, rpb, n_feat,
        n_bin, m_pad, n_node_out, n_levels, n_bg, n_cg, n_lg, n_mt, r_tile)
    lib = _lib(name)
    with torch.cuda.device(bins.device):   # the launch targets this card
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(ctypes.byref(args), variant,
                                            n_rb, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + getattr(lib, f"{name}_error_string")(rc)
                           .decode())
    COUNTERS[name].add()
    return out


def _lib(name: str) -> ctypes.CDLL:
    lib = nvcc.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch.argtypes = [ctypes.POINTER(OnehotArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


# ------------------------------------------------------------ plain parts
def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums to the int32 values a wrapping int32 sum gives."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _wrap_i8(x: torch.Tensor) -> torch.Tensor:
    """``astype(int8)`` of int32: the low byte, signed (as int64)."""
    return torch.remainder(x.to(torch.int64) + 128, 256) - 128


def proto_cells(bins_fr: torch.Tensor, node: torch.Tensor, gh2: torch.Tensor,
                n_bin: int, m_pad: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                 int]:
    """(index, values, n_cells) of one level of the int prototypes'
    ``(F * B, 2 * m_pad)`` histogram: bins_fr (F, n), node (n,) the node
    of each row (outside [0, m_pad) = inactive), gh2 (n, 2) the values.
    Inactive entries index the dump cell ``n_cells``."""
    F, n = bins_fr.shape
    dev = bins_fr.device
    b = bins_fr.to(torch.int64)
    node = node.to(torch.int64)
    n_cells = F * n_bin * 2 * m_pad
    valid = (((node >= 0) & (node < m_pad))[None, :] & (b >= 0)
             & (b < n_bin))
    f_ids = torch.arange(F, dtype=torch.int64, device=dev)
    cell = (f_ids[:, None] * n_bin + b) * (2 * m_pad) + node[None, :]
    idx = torch.stack([cell, cell + m_pad], dim=-1)          # (F, n, 2)
    idx = torch.where(valid[..., None], idx, n_cells)
    src = gh2[None, :, :].expand(F, n, 2)
    return idx.reshape(-1), src.reshape(-1), n_cells


def _proto_level(bins_fr, node, gh_q, n_bin, m_pad) -> torch.Tensor:
    idx, src, n_cells = proto_cells(bins_fr, node, _wrap_i8(gh_q), n_bin,
                                    m_pad)
    out = torch.zeros(n_cells + 1, dtype=torch.int64, device=idx.device)
    out.index_add_(0, idx, src)
    return _wrap_i32(out[:n_cells]).reshape(-1, 2 * m_pad)


def _check_int_proto(bins, pos, gh, layout):
    if bins.dim() != 2:
        raise ValueError(f"bins must be 2-D ({layout}), got "
                         f"{tuple(bins.shape)}")
    if pos.dtype != torch.int32 or gh.dtype != torch.int32:
        raise TypeError(f"pos and gh must be int32 (got {pos.dtype}, "
                        f"{gh.dtype})")


# -------------------------------------------------------------- T3 / T2
def onehot_i8(binned_t: torch.Tensor, pos: torch.Tensor, gh: torch.Tensor,
              m_pad: int, n_bin: int = 64,
              r_tile: int = 2048) -> torch.Tensor:
    """T3: ``(1, F * n_bin, 2 * m_pad)`` int32 from feature-major int32
    bins ``(F, n)``, pos ``(n, 1)`` and int32 gh ``(n, 2)`` (wrapped to
    int8); rows past ``(n // r_tile) * r_tile`` are dropped."""
    _check_int_proto(binned_t, pos, gh, "(F, n) int32")
    F, n = binned_t.shape
    if binned_t.dtype != torch.int32 or pos.numel() != n \
            or gh.shape != (n, 2):
        raise ValueError(f"T3 takes bins (F, n) int32, pos (n, 1), gh "
                         f"(n, 2); got {tuple(binned_t.shape)} "
                         f"{binned_t.dtype}, {tuple(pos.shape)}, "
                         f"{tuple(gh.shape)}")
    if _device(binned_t, pos, gh) == "cpu":
        return onehot_i8_plain(binned_t, pos, gh, m_pad, n_bin, r_tile)
    out = torch.zeros((1, F * n_bin, 2 * m_pad), dtype=torch.int32,
                      device=binned_t.device)
    ct = _col_tiles(m_pad)
    return _launch("onehot_i8", int(ct > 1), binned_t, pos, gh, out, bin_sr=1,
                   bin_sf=n, gh_sr=2, gh_sc=1,
                   out_strides=(0, n_bin * 2 * m_pad, 2 * m_pad, m_pad, 1),
                   n_rows=(n // r_tile) * r_tile, n_feat=F, n_bin=n_bin,
                   m_pad=m_pad, n_node_out=m_pad, n_levels=1,
                   mod_levels=False, n_mt=1, r_tile=STEP_ROWS,
                   col_tiles=ct, levels_per_task=1)


def onehot_i8_plain(binned_t, pos, gh, m_pad, n_bin=64, r_tile=2048):
    n = (binned_t.shape[1] // r_tile) * r_tile
    return _proto_level(binned_t[:, :n], pos.reshape(-1)[:n], gh[:n],
                        n_bin, m_pad)[None]


def onehot_notrans(binned: torch.Tensor, pos: torch.Tensor,
                   gh: torch.Tensor, m_pad: int, n_bin: int = 64,
                   r_tile: int = 2048) -> torch.Tensor:
    """T2: T3's function on row-major u8 bins ``(n, F)``, no transpose."""
    _check_int_proto(binned, pos, gh, "(n, F) u8")
    n, F = binned.shape
    if binned.dtype != torch.uint8 or pos.numel() != n or gh.shape != (n, 2):
        raise ValueError(f"T2 takes bins (n, F) u8, pos (n, 1), gh (n, 2); "
                         f"got {tuple(binned.shape)} {binned.dtype}, "
                         f"{tuple(pos.shape)}, {tuple(gh.shape)}")
    if _device(binned, pos, gh) == "cpu":
        return onehot_notrans_plain(binned, pos, gh, m_pad, n_bin, r_tile)
    out = torch.zeros((1, F * n_bin, 2 * m_pad), dtype=torch.int32,
                      device=binned.device)
    ct = _col_tiles(m_pad)
    return _launch("onehot_notrans", int(ct > 1), binned, pos, gh, out,
                   bin_sr=F,
                   bin_sf=1, gh_sr=2, gh_sc=1,
                   out_strides=(0, n_bin * 2 * m_pad, 2 * m_pad, m_pad, 1),
                   n_rows=(n // r_tile) * r_tile, n_feat=F, n_bin=n_bin,
                   m_pad=m_pad, n_node_out=m_pad, n_levels=1,
                   mod_levels=False, n_mt=1, r_tile=STEP_ROWS,
                   col_tiles=ct, levels_per_task=1)


def onehot_notrans_plain(binned, pos, gh, m_pad, n_bin=64, r_tile=2048):
    n = (binned.shape[0] // r_tile) * r_tile
    return _proto_level(binned[:n].t(), pos.reshape(-1)[:n], gh[:n], n_bin,
                        m_pad)[None]


# ------------------------------------------------------------------- T7
def r5_nodes(pos: torch.Tensor, lv: int, n_levels: int,
             m: int = M_TILE) -> torch.Tensor:
    """T7's node of each row at level ``lv``: ``floor_mod(pos + lv, m)``
    when ``n_levels > 1`` (pad rows count), else ``pos``."""
    p = pos.reshape(-1).to(torch.int64)
    return torch.remainder(p + lv, m) if n_levels > 1 else p


def onehot_r5(binned_t: torch.Tensor, pos: torch.Tensor, gh: torch.Tensor,
              n_bin: int, n_levels: int = 1,
              mode: str = "prod") -> torch.Tensor:
    """T7: ``(n_levels, F * n_bin, 128)`` int32 from feature-major u8 bins
    ``(F, n)``, pos ``(1, n)`` and int32 gh ``(2, n)`` (wrapped to int8),
    M = 64; rows past ``(n // 2048) * 2048`` are dropped.  ``mode`` is
    "prod" (bins widened to int32) or "u8cmp" (packed byte compares)."""
    if mode not in ("prod", "u8cmp"):
        raise ValueError(f"mode {mode!r}: expected 'prod' or 'u8cmp'")
    _check_int_proto(binned_t, pos, gh, "(F, n) u8")
    F, n = binned_t.shape
    if binned_t.dtype != torch.uint8 or pos.numel() != n \
            or gh.shape != (2, n) or n_levels < 1:
        raise ValueError(f"T7 takes bins (F, n) u8, pos (1, n), gh (2, n), "
                         f"n_levels >= 1; got {tuple(binned_t.shape)} "
                         f"{binned_t.dtype}, {tuple(pos.shape)}, "
                         f"{tuple(gh.shape)}, {n_levels}")
    if _device(binned_t, pos, gh) == "cpu":
        return onehot_r5_plain(binned_t, pos, gh, n_bin, n_levels, mode)
    M = M_TILE
    out = torch.zeros((n_levels, F * n_bin, 2 * M), dtype=torch.int32,
                      device=binned_t.device)
    shared = n_levels > 1
    return _launch("onehot_r5", 2 * (mode == "u8cmp") + int(shared),
                   binned_t, pos, gh, out, bin_sr=1, bin_sf=n, gh_sr=1,
                   gh_sc=n,
                   out_strides=(F * n_bin * 2 * M, n_bin * 2 * M, 2 * M, M,
                                1),
                   n_rows=(n // R5_R_TILE) * R5_R_TILE, n_feat=F,
                   n_bin=n_bin, m_pad=M, n_node_out=M, n_levels=n_levels,
                   mod_levels=shared, n_mt=1, r_tile=STEP_ROWS,
                   col_tiles=1 if shared else COL_TILES,
                   levels_per_task=LEVELS_PER_TASK if shared else 1)


def onehot_r5_plain(binned_t, pos, gh, n_bin, n_levels=1, mode="prod"):
    n = (binned_t.shape[1] // R5_R_TILE) * R5_R_TILE
    b, p, g2 = binned_t[:, :n], pos.reshape(-1)[:n], gh[:, :n].t()
    return torch.stack([
        _proto_level(b, r5_nodes(p, lv, n_levels), g2, n_bin, M_TILE)
        for lv in range(n_levels)])


# ------------------------------------------------------------------- T5
def _variant_rounds(precision: str, hot_dtype: torch.dtype) -> bool:
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision {precision!r}: 'bf16' or 'fp32'")
    if hot_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hot_dtype {hot_dtype}: float32 or bfloat16")
    return precision == "bf16" or hot_dtype == torch.bfloat16


def variant_cells(binned, gh, pos, n_node, n_bin, precision="bf16",
                  hot_dtype=torch.float32, bin_dtype=torch.int32):
    """(index, values, n_cells) of T5's node-major histogram, inactive
    entries at the dump cell ``n_cells``."""
    N, F = binned.shape
    dev = binned.device
    b = binned.to(bin_dtype).to(torch.int64)
    if _variant_rounds(precision, hot_dtype):
        gh = gh.to(torch.bfloat16).to(torch.float32)
    p = pos.to(torch.int64)
    n_cells = n_node * F * n_bin * 2
    valid = ((p >= 0) & (p < n_node))[:, None] & (b >= 0) & (b < n_bin)
    f_ids = torch.arange(F, dtype=torch.int64, device=dev)
    cell = ((p[:, None] * F + f_ids[None, :]) * n_bin + b) * 2   # (N, F)
    idx = torch.stack([cell, cell + 1], dim=-1)
    idx = torch.where(valid[..., None], idx, n_cells)
    return idx.reshape(-1), gh[:, None, :].expand(N, F, 2).reshape(-1), \
        n_cells


def onehot_variant(binned: torch.Tensor, gh: torch.Tensor, pos: torch.Tensor,
                   n_node: int, n_bin: int, precision: str = "bf16",
                   hot_dtype: torch.dtype = torch.float32,
                   bin_dtype: torch.dtype = torch.int32,
                   r_tile: int = 1024) -> torch.Tensor:
    """T5: the node-major level histogram ``(n_node, F, n_bin, 2)`` f32 of
    bins ``(N, F)``, f32 gh ``(N, 2)`` and int32 pos ``(N,)``."""
    rounded = _variant_rounds(precision, hot_dtype)
    if bin_dtype not in (torch.int32, torch.int16):
        raise ValueError(f"bin_dtype {bin_dtype}: int32 or int16")
    if binned.dim() != 2 or gh.shape != (binned.shape[0], 2) \
            or pos.shape != (binned.shape[0],) or n_node < 1:
        raise ValueError(f"shapes: bins {tuple(binned.shape)}, gh "
                         f"{tuple(gh.shape)}, pos {tuple(pos.shape)}, "
                         f"n_node {n_node}")
    if gh.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError(f"gh must be float32 (got {gh.dtype}), pos int32 "
                        f"(got {pos.dtype})")
    if _device(binned, gh, pos) == "cpu":
        return onehot_variant_plain(binned, gh, pos, n_node, n_bin,
                                    precision, hot_dtype, bin_dtype, r_tile)
    bins = binned if binned.dtype == bin_dtype else binned.to(bin_dtype)
    N, F = bins.shape
    m_pad = min(n_node, M_TILE)
    out = torch.zeros((n_node, F, n_bin, 2), dtype=torch.float32,
                      device=bins.device)
    variant = (0 if rounded else 2) + int(bin_dtype == torch.int16)
    return _launch("onehot_variant", variant, bins, pos, gh, out, bin_sr=F,
                   bin_sf=1, gh_sr=2, gh_sc=1,
                   out_strides=(0, n_bin * 2, 2, 1, F * n_bin * 2),
                   n_rows=N, n_feat=F, n_bin=n_bin, m_pad=m_pad,
                   n_node_out=n_node, n_levels=1, mod_levels=False,
                   n_mt=_cdiv(n_node, m_pad), r_tile=r_tile,
                   col_tiles=COL_TILES, levels_per_task=1)


def onehot_variant_plain(binned, gh, pos, n_node, n_bin, precision="bf16",
                         hot_dtype=torch.float32, bin_dtype=torch.int32,
                         r_tile=1024):
    """Plain T5: one ``index_add_`` over the cells of
    :func:`variant_cells` (``r_tile`` changes nothing here)."""
    idx, src, n_cells = variant_cells(binned, gh, pos, n_node, n_bin,
                                      precision, hot_dtype, bin_dtype)
    out = torch.zeros(n_cells + 1, dtype=torch.float32, device=idx.device)
    out.index_add_(0, idx, src)
    return out[:n_cells].reshape(n_node, binned.shape[1], n_bin, 2)
