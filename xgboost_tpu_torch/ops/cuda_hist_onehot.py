"""Kernels T5, T3, T2, T7, T1, T4a, T4b and T6: the one-hot histogram
prototypes of the TPU rounds, hand-written CUDA for the tensor cores.

Each replaces one Pallas prototype in ``tools/`` and keeps its argument
list and output layout:

- :func:`onehot_variant` (T5, ``tools/hist_microbench.py:variant``):
  ``(n_node, F, B, 2)`` f32, any ``n_node`` in node tiles of 64, bf16 or
  exact f32 products; source ``csrc/onehot_variant.cu``;
- :func:`onehot_i8` (T3, ``tools/hist_int8_proto.py:build_i8``): int8
  (``s8``) products of feature-major int32 bins, ``(1, F * B, 2 * m_pad)``
  int32; source ``csrc/onehot_i8.cu``;
- :func:`onehot_notrans` (T2, ``tools/hist_notrans_proto.py:build``): the
  same on row-major u8 bins; source ``csrc/onehot_notrans.cu``;
- :func:`onehot_r5` (T7, ``tools/hist_r5_ab.py:build``): int8 (``s8``)
  products of feature-major u8 bins at M = 64, ``n_levels`` level operands
  against one one-hot, ``(n_levels, F * B, 128)`` int32; source
  ``csrc/onehot_r5.cu``;
- :func:`onehot_group` (T1, ``tools/hist_group_proto.py:grouped``): bf16
  products of ``fg`` features per task, node-major ``(n_node, F, B, 2)``
  f32; source ``csrc/onehot_group.cu``;
- :func:`onehot_pack2` (T4a, ``tools/hist_pack2_proto.py:build``, modes
  "prod" and "pack2": one and two features per task) and
  :func:`onehot_onebig` (T4b, ``build_onebig``: all F features per task),
  ``(1, F * B, 2 * m_pad)`` f32; source ``csrc/onehot_pack2.cu``;
- :func:`onehot_r4` (T6, ``tools/hist_r4_ab.py:build``): bf16 products at
  M = 64 whose one-hot is built four ways ("prod", "dotfloor", "u8bins",
  "i16hot"), ``(1, F * B, 128)`` f32; source ``csrc/onehot_r4.cu``.

T5, T1, T6, T7, T3 and T2 share one kernel, the ``wgmma`` product of
``csrc/onehot_wgmma.cuh`` (tiled by :func:`wgmma_plan`): bf16 on row-major
bins for T5 and T1, bf16 on feature-major bins with four one-hot builds for
T6, ``s8`` on feature-major u8 bins (with levels, A from shared memory) for
T7, ``s8`` at N = 8-64 (its small-N form) on feature-major int32 bins for
T3 and on row-major u8 bins for T2.  T4a and T4b run the ``mma.sync``
feature-grouped kernel of ``csrc/onehot_mma.cuh``.  Each has a plain
PyTorch version (``*_plain``) with the prototype's exact semantics, which
the kernel matches:

- T3, T2, T7 count only the first ``(n // r_tile) * r_tile`` rows (their
  grids drop the rest) and wrap ``gh`` to int8 (``astype(int8)``); sums
  are int32 and wrap.  Pos outside ``[0, m_pad)`` is inactive, and a bin
  outside ``[0, n_bin)`` adds nothing to its feature.
- T7 with ``n_levels > 1``: row r is active in node j at level lv iff
  ``floor_mod(pos[r] + lv, M) == j``, so pad rows (pos = -1) count.
- T5: rows with ``pos < 0`` or ``pos >= n_node`` add nothing; ``gh`` is
  rounded to bf16 (nearest even) when ``precision == "bf16"`` or
  ``hot_dtype`` is bf16, as the TPU's matrix unit rounds it.  (The JAX
  function run on a CPU sums unrounded f32 there.)  ``bin_dtype`` changes
  the bytes read, never the result; ``r_tile`` (and T1's ``fg``) change
  nothing.
- T1, T4a, T4b, T6 round ``gh`` to bf16 (the prototypes' bf16 ``gh_exp``;
  T1 with ``hot_dtype=float32`` too, as the TPU's ``Precision.DEFAULT``
  rounds an f32 operand).  T4a, T4b and T6 count only the first
  ``(n // r_tile) * r_tile`` rows; T1 pads, so it drops none.  Rows with
  pos outside the node tile and bins outside ``[0, n_bin)`` add nothing
  (a bad bin only in its own feature); T6 "dotfloor" ignores the bins
  and puts every feature's node totals in bin 0.

A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
or raises; any other device raises.  Each kernel has a launch counter in
:data:`COUNTERS`, raised by one where its wrapper launches it and
nowhere else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from xgboost_tpu_torch.ops import nvcc

THREADS = 256                  # 8 warps a block (onehot_mma.cuh)
STEP_ROWS = 2048               # rows a grouped block stages per step
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
                 "onehot_r5", "onehot_group", "onehot_pack2",
                 "onehot_onebig", "onehot_r4")}
# the source (``csrc/<name>.cu``) of each kernel: T4b is built from T4a's
SOURCES: Dict[str, str] = {name: name for name in COUNTERS}
SOURCES["onehot_onebig"] = "onehot_pack2"


class OnehotArgs(ctypes.Structure):
    """``struct OnehotArgs`` of ``csrc/onehot_mma.cuh``, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("bins", "pos", "gh", "out")]
                + [(n, ctypes.c_longlong) for n in (
                    "bin_sr", "bin_sf", "gh_sr", "gh_sc", "s_f", "s_b",
                    "s_c", "s_node", "n_rows", "rows_per_block")]
                + [(n, ctypes.c_int) for n in (
                    "n_feat", "n_bin", "m_pad", "n_node_out", "n_cg",
                    "n_mt", "r_tile", "fg", "rep")])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _device(*ts: torch.Tensor) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no one-hot histogram kernel for {dev}")
    return dev.type


def _call(name: str, args: ctypes.Structure, variant: int, n_rb: int,
          device: torch.device, out: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` on the current stream of ``device``; raise
    on a refused launch, count a launched one."""
    lib_name = SOURCES[name]
    lib = _lib(lib_name, type(args))
    with torch.cuda.device(device):   # the launch targets this card
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{lib_name}_launch")(ctypes.byref(args), variant,
                                                n_rb, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + getattr(lib, f"{lib_name}_error_string")(rc)
                           .decode())
    COUNTERS[name].add()
    return out


GROUP_ACC_TILES = 16   # PW units x CT column tiles a warp: 64 accumulators
GROUP_SMEM_B = 32768   # the B fragments of a sub-step (onehot_mma.cuh)
SMEM_MAX = 232448      # dynamic shared memory a block may use (H100)


def group_plan(fg: int, n_bin: int) -> Tuple[int, int, int]:
    """(variant, column tiles a task, warps a unit) of the grouped
    kernel: ``fg`` features x the bin tiles of 16 are the task's units,
    8 warps take them, each at most PW = 2^variant units of CT = 16 / PW
    column tiles; fewer than 8 units get several warps each."""
    units = fg * _cdiv(n_bin, 16)
    pw = 1
    while THREADS // 32 * pw < units:
        pw *= 2
    if pw > GROUP_ACC_TILES:
        raise NotImplementedError(
            f"{fg} features of {n_bin} bins are {units} units: the grouped "
            f"kernel takes at most {THREADS // 32 * GROUP_ACC_TILES}")
    return pw.bit_length() - 1, GROUP_ACC_TILES // pw, \
        max(1, THREADS // 32 // units)


def group_step(r_tile: int) -> int:
    """The grouped kernel's rows per block step for a prototype's
    ``r_tile``: the largest power of two at most ``min(r_tile, 2048)``
    (4,096 is staged as two steps of 2,048)."""
    if r_tile < THREADS:
        raise NotImplementedError(f"r_tile {r_tile}: at least {THREADS}")
    return 1 << (min(r_tile, STEP_ROWS).bit_length() - 1)


def _launch_group(name: str, bins: torch.Tensor, pos: torch.Tensor,
                  gh: torch.Tensor, out: torch.Tensor, *, bin_sr: int,
                  bin_sf: int, out_strides: Tuple[int, int, int, int],
                  n_rows: int, n_feat: int, n_bin: int, m_pad: int,
                  n_node_out: int, n_mt: int, r_tile: int,
                  fg: int) -> torch.Tensor:
    """One launch of the feature-grouped kernel on int32 bins, f32 gh
    ``(n, 2)`` and int32 pos; ``out_strides`` are (s_f, s_b, s_c,
    s_node)."""
    if not (bins.is_contiguous() and pos.is_contiguous()
            and gh.is_contiguous() and out.is_contiguous()):
        raise ValueError("bins, pos, gh and out must be contiguous")
    if bins.dtype != torch.int32 or n_bin > 255 or not 0 < m_pad <= 128:
        raise NotImplementedError(
            f"the grouped kernel takes int32 bins, B <= 255 and up to 128 "
            f"nodes a tile (got {bins.dtype}, B={n_bin}, m_pad={m_pad})")
    step = group_step(r_tile)
    fg = max(1, min(fg, n_feat))
    variant, ct, rep = group_plan(fg, n_bin)
    if GROUP_SMEM_B + step * (5 + fg) > SMEM_MAX:
        raise NotImplementedError(f"{fg} features a task at {step} rows a "
                                  "step exceed a block's shared memory")
    if n_rows == 0 or n_feat == 0:
        return out
    n_fg = _cdiv(n_feat, fg)
    n_cg = _cdiv(_cdiv(2 * m_pad, 8), ct)
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    steps = _cdiv(n_rows, step)
    want = _cdiv(BLOCKS_PER_SM * n_sm, n_fg * n_cg * n_mt)
    rpb = _cdiv(steps, max(1, min(steps, want))) * step
    n_rb = _cdiv(n_rows, rpb)
    if n_cg * n_mt > 65535 or n_rb > 65535:
        raise NotImplementedError("too many node tiles for one launch")
    args = OnehotArgs(
        bins.data_ptr(), pos.data_ptr(), gh.data_ptr(), out.data_ptr(),
        bin_sr, bin_sf, 2, 1, *out_strides, n_rows, rpb, n_feat, n_bin,
        m_pad, n_node_out, n_cg, n_mt, step, fg, rep)
    return _call(name, args, variant, n_rb, bins.device, out)


def _lib(name: str, arg_type: type) -> ctypes.CDLL:
    lib = nvcc.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch.argtypes = [ctypes.POINTER(arg_type), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


# ------------------------------------------- wgmma (T5, T1, T6, T7, T3, T2)
WGMMA_COLS = (8, 16, 32, 64, 128)  # the N the kernel is instantiated at
WGMMA_WARPGROUPS = 4               # warpgroups a block
WGMMA_STAGE_BINS = 2048            # staged bins a block step
WGMMA_LEVEL_BLOCKS = (4, 2, 1)     # levels a block in the levels form
# the small-N s8 form (T3, T2): M tiles a warpgroup at each N, as many as
# their accumulators and live A fragments leave registers for
WGMMA_S8_TILES = {8: 7, 16: 5, 32: 3, 64: 2}


class WgmmaArgs(ctypes.Structure):
    """``struct WgmmaArgs`` of ``csrc/onehot_wgmma.cuh``, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("bins", "pos", "gh", "out")]
                + [(n, ctypes.c_longlong) for n in (
                    "bin_sr", "bin_sf", "gh_sr", "gh_sc", "s_lv", "s_f",
                    "s_b", "s_c", "s_node", "n_rows", "rows_per_block")]
                + [(n, ctypes.c_int) for n in (
                    "n_feat", "n_bin", "b_pad", "m_pad", "n_node_out",
                    "n_col", "n_mblk", "n_mt", "step", "bin_bytes", "fm",
                    "vec", "n_levels", "lv_block")])


class WgmmaPlan(NamedTuple):
    """The tiling of one launch of the ``wgmma`` kernel."""
    n_col: int            # N: 2 m_pad rounded up to one of WGMMA_COLS
    b_pad: int            # Bp: B rounded up to 8 (16 in the small-N form)
    m_pad: int            # nodes a node tile
    n_mt: int             # node tiles (a grid dimension)
    tiles_per_block: int  # M tiles of 64 a block (the last may hold fewer)
    n_tiles: int          # M tiles of the F * Bp (feature, bin) rows
    n_mblk: int           # M blocks
    step: int             # rows a block step
    bin_bytes: int        # 4: int32 bins, 2: int16, 1: uint8
    n_parts: int          # bf16 parts of gh: 1, or 3 in the exact mode
    smem: int             # dynamic shared memory of a block, bytes
    acc_regs: int         # accumulators a thread
    elem: str             # "bf16" or "s8" products
    feature_major: bool   # bins (F, n), staged with rows inner
    n_levels: int         # > 1: the levels form (s8, A from shared memory)
    lv_block: int         # levels a block (1 outside the levels form)
    n_lg: int             # level groups (the grid's y in the levels form)
    a_smem: int           # the block's A tiles (levels form), bytes
    tiles_per_wg: int     # M tiles a warpgroup holds at most
    stage_bins: int       # staged bin bytes a stage


def wgmma_small(plan: WgmmaPlan) -> bool:
    """The small-N form: ``s8`` products below N = 128 without levels (T3,
    T2), whose block spreads its tiles evenly over its warpgroups."""
    return plan.elem == "s8" and plan.n_levels == 1 and plan.n_col < 128


def wgmma_block_features(n_feat: int, b_pad: int,
                         tiles_per_block: int) -> list:
    """The features each M block stages: block k holds M rows [k R, (k +
    1) R) of the ``n_feat * b_pad`` (feature, bin) rows (R = 64 x its
    tiles), so the features of its first to its last row."""
    m_rows, rows = n_feat * b_pad, 64 * tiles_per_block
    return [range(m0 // b_pad, (min(m_rows, m0 + rows) - 1) // b_pad + 1)
            for m0 in range(0, m_rows, rows)]


def wgmma_level_block(n_levels: int) -> int:
    """Levels a block of the levels form (its four warpgroups own 4 /
    lv_block M tiles x lv_block levels): of 4, 2 and 1 the one that
    leaves the fewest warpgroups without a level, the largest of those
    (fewest level groups, so fewest builds of each one-hot)."""
    return min(WGMMA_LEVEL_BLOCKS, key=lambda lb: lb * _cdiv(n_levels, lb))


def wgmma_block_pairs(plan: WgmmaPlan) -> list:
    """The (M tile, level) pairs of each warpgroup of each block, blocks
    in grid order (level group, then M block): in the levels form one
    pair, or none for a warpgroup past the last tile or level; outside it
    the warpgroup's ``tiles_per_block / 4`` tiles at level 0, or in the
    small-N form its share of the block's tiles (a quarter, the first
    warpgroups one more)."""
    out = []
    for lg in range(plan.n_lg):
        for blk in range(plan.n_mblk):
            t0 = blk * plan.tiles_per_block
            pairs = []
            for wg in range(WGMMA_WARPGROUPS):
                if plan.n_levels > 1:
                    t = t0 + wg % plan.tiles_per_block
                    lv = lg * plan.lv_block + wg // plan.tiles_per_block
                    ok = t < plan.n_tiles and lv < plan.n_levels
                    pairs.append([(t, lv)] if ok else [])
                elif wgmma_small(plan):
                    q, r = divmod(min(plan.tiles_per_block,
                                      plan.n_tiles - t0), WGMMA_WARPGROUPS)
                    lo = t0 + wg * q + min(wg, r)
                    pairs.append([(t, 0)
                                  for t in range(lo, lo + q + (wg < r))])
                else:
                    tw = plan.tiles_per_block // WGMMA_WARPGROUPS
                    pairs.append([(t, 0) for t in range(t0 + wg * tw,
                                                         t0 + (wg + 1) * tw)
                                  if t < plan.n_tiles])
            out.append(pairs)
    return out


def wgmma_plan(n_feat: int, n_bin: int, n_node: int,
               bin_dtype: torch.dtype = torch.int32,
               exact: bool = False, *, feature_major: bool = False,
               elem: str = "bf16", n_levels: int = 1) -> WgmmaPlan:
    """The ``wgmma`` kernel's tiling of a level histogram of ``n_feat``
    features of ``n_bin`` bins at ``n_node`` nodes
    (``csrc/onehot_wgmma.cuh``): M tiles of 64 over the F * Bp (feature,
    bin) rows, four warpgroups a block of one tile each at N = 128 (two
    below), the row step as large as a stage's 2,048 staged bins and the
    block's shared memory allow (at most 256 rows, 64 in the exact mode; a
    multiple of the instruction's K: 16 rows in bf16, 32 in ``s8``).

    Row-major bins (T5, T1) are int32 or int16, feature-major ones (T6,
    T7) int32 or uint8.  ``elem="s8"`` is the int8 product: at 64 nodes
    (N = 128) T7's; with ``n_levels > 1`` (at 64 nodes) the levels form,
    whose block of ``4 / lv_block`` tiles x ``lv_block`` levels keeps two
    stages of its tiles' one-hot in shared memory; below N = 128 the
    small-N form (T3 on feature-major int32 bins, T2 on row-major uint8
    ones): Bp = B rounded up to 16, up to ``WGMMA_S8_TILES[N]`` tiles a
    warpgroup, the tiles spread evenly over as few blocks as hold them,
    and a stage of 4,096 bins.  Raises ``NotImplementedError`` on what
    the kernel does not take."""
    if elem not in ("bf16", "s8"):
        raise NotImplementedError(f"elem {elem!r}: 'bf16' or 's8'")
    s8 = elem == "s8"
    dtypes = ((torch.int32, torch.uint8) if feature_major
              else (torch.uint8,) if s8 else (torch.int32, torch.int16))
    if bin_dtype not in dtypes:
        raise NotImplementedError(
            f"the wgmma kernel reads {'feature' if feature_major else 'row'}"
            f"-major {elem} bins of {dtypes} (got {bin_dtype})")
    if not 1 <= n_bin <= 255 or n_feat < 1 or n_node < 1 or n_levels < 1:
        raise NotImplementedError(
            f"the wgmma kernel takes 1 <= B <= 255 (byte 255 marks a bad "
            f"bin), F >= 1, n_node >= 1 and n_levels >= 1 (got B={n_bin}, "
            f"F={n_feat}, n_node={n_node}, n_levels={n_levels})")
    levels = n_levels > 1
    if s8 and exact:
        raise NotImplementedError("the s8 product has no exact mode")
    if levels and (not s8 or n_node != M_TILE):
        raise NotImplementedError(
            f"levels are s8 products at {M_TILE} nodes (got {elem}, "
            f"n_node={n_node})")
    m_pad = min(n_node, M_TILE)
    n_col = next(n for n in WGMMA_COLS if n >= 2 * m_pad)
    small = s8 and not levels and n_col < 128
    b_q = 16 if small else 8
    b_pad = _cdiv(n_bin, b_q) * b_q
    n_tiles = _cdiv(n_feat * b_pad, 64)
    tw = (WGMMA_S8_TILES[n_col] if small       # M tiles a warpgroup
          else 1 if n_col >= 128 or levels else 2)
    lv_block = wgmma_level_block(n_levels) if levels else 1
    if levels:
        tpb = WGMMA_WARPGROUPS // lv_block
    elif small:   # as few blocks as hold the tiles, evenly filled
        tpb = _cdiv(n_tiles, _cdiv(n_tiles, WGMMA_WARPGROUPS * tw))
    else:
        tpb = WGMMA_WARPGROUPS * tw
    feats = wgmma_block_features(n_feat, b_pad, tpb)
    n_parts = 3 if exact else 1
    k_rows = 32 if s8 else 16                    # K of one instruction
    n_b = lv_block if levels else n_parts        # B tiles a stage
    stage_bins = 2 * WGMMA_STAGE_BINS if small else WGMMA_STAGE_BINS

    def smem(step):
        return (2 * n_b * step * n_col * (1 if s8 else 2)
                + 2 * stage_bins + a_smem(step))

    def a_smem(step):
        return 2 * tpb * 64 * step if levels else 0

    step = min(64 if exact else 256,
               stage_bins // max(len(r) for r in feats) // k_rows * k_rows)
    while step >= k_rows and smem(step) > SMEM_MAX:
        step -= k_rows
    if step < k_rows:
        raise NotImplementedError(
            f"{max(len(r) for r in feats)} features a block leave a row "
            f"step below the instruction's {k_rows} rows")
    return WgmmaPlan(
        n_col=n_col, b_pad=b_pad, m_pad=m_pad, n_mt=_cdiv(n_node, m_pad),
        tiles_per_block=tpb, n_tiles=n_tiles, n_mblk=len(feats), step=step,
        bin_bytes=torch.empty((), dtype=bin_dtype).element_size(),
        n_parts=n_parts, smem=smem(step), acc_regs=tw * n_col // 2,
        elem=elem, feature_major=feature_major, n_levels=n_levels,
        lv_block=lv_block, n_lg=_cdiv(n_levels, lv_block),
        a_smem=a_smem(step), tiles_per_wg=tw, stage_bins=stage_bins)


def _launch_wgmma(name: str, variant: int, plan: WgmmaPlan,
                  bins: torch.Tensor, pos: torch.Tensor, gh: torch.Tensor,
                  out: torch.Tensor, *, bin_sr: int, bin_sf: int,
                  gh_sr: int, gh_sc: int,
                  out_strides: Tuple[int, int, int, int, int], n_rows: int,
                  n_bin: int, n_node_out: int) -> torch.Tensor:
    """One launch of the ``wgmma`` kernel at ``plan`` over the first
    ``n_rows`` rows into the zeroed ``out``, cell (level, feature, bin,
    channel, node) at ``out_strides`` (s_lv, s_f, s_b, s_c, s_node)."""
    if not (bins.is_contiguous() and pos.is_contiguous()
            and gh.is_contiguous() and out.is_contiguous()):
        raise ValueError("bins, pos, gh and out must be contiguous")
    if n_rows == 0:
        return out
    n_sm = torch.cuda.get_device_properties(bins.device).multi_processor_count
    n_y = plan.n_lg if plan.n_levels > 1 else plan.n_mt
    steps = _cdiv(n_rows, plan.step)
    want = max(1, n_sm // (plan.n_mblk * n_y))
    rpb = _cdiv(steps, min(steps, want)) * plan.step
    n_rb = _cdiv(n_rows, rpb)
    if n_y > 65535 or n_rb > 65535:
        raise NotImplementedError("too many node tiles for one launch")
    # uint8 bins: feature-major rows 16 a load where every feature's rows
    # are 16-byte aligned, row-major rows a word (four features) a load
    # where every row is 4-byte aligned
    align = (bin_sf, 16) if plan.feature_major else (bin_sr, 4)
    vec = int(plan.bin_bytes == 1 and align[0] % align[1] == 0
              and bins.data_ptr() % align[1] == 0)
    n_feat = bins.shape[0] if plan.feature_major else bins.shape[1]
    args = WgmmaArgs(
        bins.data_ptr(), pos.data_ptr(), gh.data_ptr(), out.data_ptr(),
        bin_sr, bin_sf, gh_sr, gh_sc, *out_strides, n_rows, rpb, n_feat,
        n_bin, plan.b_pad, plan.m_pad, n_node_out, plan.n_col, plan.n_mblk,
        n_y, plan.step, plan.bin_bytes, int(plan.feature_major), vec,
        plan.n_levels, plan.lv_block)
    return _call(name, args, variant, n_rb, bins.device, out)


def _launch_rows(name: str, bins: torch.Tensor, pos: torch.Tensor,
                 gh: torch.Tensor, n_node: int, n_bin: int,
                 exact: bool) -> torch.Tensor:
    """T5's and T1's launch (variant 1: the exact mode) on row-major bins
    ``(N, F)``, f32 gh ``(N, 2)`` and int32 pos: the node-major ``(n_node,
    F, n_bin, 2)`` histogram."""
    N, F = bins.shape
    plan = wgmma_plan(F, n_bin, n_node, bins.dtype, exact)
    out = torch.zeros((n_node, F, n_bin, 2), dtype=torch.float32,
                      device=bins.device)
    return _launch_wgmma(name, int(exact), plan, bins, pos, gh, out,
                         bin_sr=F, bin_sf=1, gh_sr=2, gh_sc=1,
                         out_strides=(0, n_bin * 2, 2, 1, F * n_bin * 2),
                         n_rows=N, n_bin=n_bin, n_node_out=n_node)


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
def _launch_int(name: str, bins: torch.Tensor, pos: torch.Tensor,
                gh: torch.Tensor, m_pad: int, n_bin: int, r_tile: int,
                feature_major: bool) -> torch.Tensor:
    """T3's and T2's launch of the ``s8`` product on int32 gh ``(n, 2)``
    and int32 pos over the first ``(n // r_tile) * r_tile`` rows:
    ``(1, F * n_bin, 2 * m_pad)`` int32, nodes past 64 in node tiles."""
    F, n = bins.shape if feature_major else bins.shape[::-1]
    out = torch.zeros((1, F * n_bin, 2 * m_pad), dtype=torch.int32,
                      device=bins.device)
    # no features: nothing to launch, though B and m_pad are still checked
    plan = wgmma_plan(max(F, 1), n_bin, m_pad, bins.dtype,
                      feature_major=feature_major, elem="s8")
    if F == 0:
        return out
    return _launch_wgmma(name, 0, plan, bins, pos, gh, out,
                         bin_sr=1 if feature_major else F,
                         bin_sf=n if feature_major else 1, gh_sr=2, gh_sc=1,
                         out_strides=(0, n_bin * 2 * m_pad, 2 * m_pad, m_pad,
                                      1),
                         n_rows=(n // r_tile) * r_tile, n_bin=n_bin,
                         n_node_out=m_pad)


def onehot_i8(binned_t: torch.Tensor, pos: torch.Tensor, gh: torch.Tensor,
              m_pad: int, n_bin: int = 64,
              r_tile: int = 2048) -> torch.Tensor:
    """T3: ``(1, F * n_bin, 2 * m_pad)`` int32 from feature-major int32
    bins ``(F, n)``, pos ``(n, 1)`` and int32 gh ``(n, 2)`` (wrapped to
    int8); rows past ``(n // r_tile) * r_tile`` are dropped.  On the card
    the ``wgmma`` kernel's ``s8`` product (B <= 255); ``r_tile`` only says
    where the tail is dropped."""
    _check_int_proto(binned_t, pos, gh, "(F, n) int32")
    F, n = binned_t.shape
    if binned_t.dtype != torch.int32 or pos.numel() != n \
            or gh.shape != (n, 2) or r_tile < 1:
        raise ValueError(f"T3 takes bins (F, n) int32, pos (n, 1), gh "
                         f"(n, 2), r_tile >= 1; got {tuple(binned_t.shape)} "
                         f"{binned_t.dtype}, {tuple(pos.shape)}, "
                         f"{tuple(gh.shape)}, {r_tile}")
    if _device(binned_t, pos, gh) == "cpu":
        return onehot_i8_plain(binned_t, pos, gh, m_pad, n_bin, r_tile)
    return _launch_int("onehot_i8", binned_t, pos, gh, m_pad, n_bin, r_tile,
                       feature_major=True)


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
    if binned.dtype != torch.uint8 or pos.numel() != n or gh.shape != (n, 2) \
            or r_tile < 1:
        raise ValueError(f"T2 takes bins (n, F) u8, pos (n, 1), gh (n, 2), "
                         f"r_tile >= 1; got {tuple(binned.shape)} "
                         f"{binned.dtype}, {tuple(pos.shape)}, "
                         f"{tuple(gh.shape)}, {r_tile}")
    if _device(binned, pos, gh) == "cpu":
        return onehot_notrans_plain(binned, pos, gh, m_pad, n_bin, r_tile)
    return _launch_int("onehot_notrans", binned, pos, gh, m_pad, n_bin,
                       r_tile, feature_major=False)


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
    plan = wgmma_plan(F, n_bin, M, torch.uint8, feature_major=True,
                      elem="s8", n_levels=n_levels)
    out = torch.zeros((n_levels, F * n_bin, 2 * M), dtype=torch.int32,
                      device=binned_t.device)
    return _launch_wgmma("onehot_r5",
                         2 * (mode == "u8cmp") + int(n_levels > 1), plan,
                         binned_t, pos, gh, out, bin_sr=1, bin_sf=n,
                         gh_sr=1, gh_sc=n,
                         out_strides=(F * n_bin * 2 * M, n_bin * 2 * M,
                                      2 * M, M, 1),
                         n_rows=(n // R5_R_TILE) * R5_R_TILE, n_bin=n_bin,
                         n_node_out=M)


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
    bins ``(N, F)``, f32 gh ``(N, 2)`` and int32 pos ``(N,)``.  On the card
    the ``wgmma`` kernel reads the bins as ``bin_dtype``; ``r_tile``
    changes nothing (the kernel's row step is its own)."""
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
    return _launch_rows("onehot_variant", bins, pos, gh, n_node, n_bin,
                        exact=not rounded)


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


# ------------------------------------------------------ bf16 prototypes
def _round_bf16(gh: torch.Tensor) -> torch.Tensor:
    """f32 gh rounded to bf16 (nearest even), as the prototypes' bf16
    ``gh_exp`` and the TPU's ``Precision.DEFAULT`` round it."""
    return gh.to(torch.bfloat16).to(torch.float32)


def _bf16_proto_level(bins_fr, node, gh, n_bin, m_pad) -> torch.Tensor:
    """``(F * n_bin, 2 * m_pad)`` f32: one ``index_add_`` of the rounded
    gh over the cells of :func:`proto_cells`."""
    idx, src, n_cells = proto_cells(bins_fr, node, _round_bf16(gh), n_bin,
                                    m_pad)
    out = torch.zeros(n_cells + 1, dtype=torch.float32, device=idx.device)
    out.index_add_(0, idx, src)
    return out[:n_cells].reshape(-1, 2 * m_pad)


def _check_bf16_proto(binned_t, pos, gh, name, bin_dtypes):
    if binned_t.dim() != 2 or binned_t.dtype not in bin_dtypes:
        raise TypeError(f"{name} takes bins (F, n) of {bin_dtypes}; got "
                        f"{tuple(binned_t.shape)} {binned_t.dtype}")
    n = binned_t.shape[1]
    if pos.numel() != n or gh.shape != (n, 2):
        raise ValueError(f"{name} takes pos (n, 1) and gh (n, 2) for n={n}; "
                         f"got {tuple(pos.shape)}, {tuple(gh.shape)}")
    if pos.dtype != torch.int32 or gh.dtype != torch.float32:
        raise TypeError(f"pos must be int32 and gh float32 (got {pos.dtype}, "
                        f"{gh.dtype})")


# ------------------------------------------------------------------- T1
def onehot_group(binned: torch.Tensor, gh: torch.Tensor, pos: torch.Tensor,
                 n_node: int, n_bin: int, fg: int = 4, r_tile: int = 2048,
                 hot_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """T1: the node-major level histogram ``(n_node, F, n_bin, 2)`` f32 of
    int bins ``(N, F)``, f32 gh ``(N, 2)`` and int32 pos ``(N,)``: T5's
    bf16 function through the same ``wgmma`` kernel.  gh is rounded to bf16
    whatever ``hot_dtype``; ``fg`` and ``r_tile`` change nothing (a block
    stages its rows once for all the features of its M tiles)."""
    if hot_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hot_dtype {hot_dtype}: float32 or bfloat16")
    if binned.dim() != 2 or gh.shape != (binned.shape[0], 2) \
            or pos.shape != (binned.shape[0],) or n_node < 1 or fg < 1 \
            or r_tile < 1:
        raise ValueError(f"shapes: bins {tuple(binned.shape)}, gh "
                         f"{tuple(gh.shape)}, pos {tuple(pos.shape)}, "
                         f"n_node {n_node}, fg {fg}, r_tile {r_tile}")
    if gh.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError(f"gh must be float32 (got {gh.dtype}), pos int32 "
                        f"(got {pos.dtype})")
    if _device(binned, gh, pos) == "cpu":
        return onehot_group_plain(binned, gh, pos, n_node, n_bin, fg,
                                  r_tile, hot_dtype)
    return _launch_rows("onehot_group", binned.to(torch.int32), pos, gh,
                        n_node, n_bin, exact=False)


def onehot_group_plain(binned, gh, pos, n_node, n_bin, fg=4, r_tile=2048,
                       hot_dtype=torch.bfloat16):
    """Plain T1: T5's bf16 cells (:func:`onehot_variant_plain`); ``fg``,
    ``r_tile`` and ``hot_dtype`` change nothing here."""
    return onehot_variant_plain(binned, gh, pos, n_node, n_bin, "bf16")


# ------------------------------------------------------------ T4a / T4b
PACK2_MODES = ("prod", "pack2")


def _check_pack2(binned_t, pos, gh, mode, name):
    if mode not in PACK2_MODES:
        raise ValueError(f"mode {mode!r}: expected 'prod' or 'pack2'")
    _check_bf16_proto(binned_t, pos, gh, name, (torch.int32,))
    if mode == "pack2" and binned_t.shape[0] % 2:
        raise ValueError(f"pack2 pairs features: F = {binned_t.shape[0]} "
                         "is odd (the prototype would drop the last one)")


def onehot_pack2(binned_t: torch.Tensor, pos: torch.Tensor, gh: torch.Tensor,
                 m_pad: int, mode: str = "prod", n_bin: int = 64,
                 r_tile: int = 2048) -> torch.Tensor:
    """T4a: ``(1, F * n_bin, 2 * m_pad)`` f32 from feature-major int32 bins
    ``(F, n)``, pos ``(n, 1)`` and f32 gh ``(n, 2)`` rounded to bf16; rows
    past ``(n // r_tile) * r_tile`` are dropped.  ``mode`` "prod" takes
    one feature a task, "pack2" two (F must be even)."""
    _check_pack2(binned_t, pos, gh, mode, "T4a")
    if _device(binned_t, pos, gh) == "cpu":
        return onehot_pack2_plain(binned_t, pos, gh, m_pad, mode, n_bin,
                                  r_tile)
    return _pack2_launch("onehot_pack2", binned_t, pos, gh, m_pad, n_bin,
                         r_tile, 1 if mode == "prod" else 2)


def _pack2_launch(name, binned_t, pos, gh, m_pad, n_bin, r_tile, fg):
    F, n = binned_t.shape
    out = torch.zeros((1, F * n_bin, 2 * m_pad), dtype=torch.float32,
                      device=binned_t.device)
    return _launch_group(name, binned_t, pos, gh, out, bin_sr=1, bin_sf=n,
                         out_strides=(n_bin * 2 * m_pad, 2 * m_pad, m_pad, 1),
                         n_rows=(n // r_tile) * r_tile, n_feat=F,
                         n_bin=n_bin, m_pad=m_pad, n_node_out=m_pad, n_mt=1,
                         r_tile=r_tile, fg=fg)


def onehot_pack2_plain(binned_t, pos, gh, m_pad, mode="prod", n_bin=64,
                       r_tile=2048):
    """Plain T4a (and T4b): the bf16 cells of the first whole tiles; the
    mode changes nothing here."""
    _check_pack2(binned_t, pos, gh, mode, "T4a")
    n = (binned_t.shape[1] // r_tile) * r_tile
    return _bf16_proto_level(binned_t[:, :n], pos.reshape(-1)[:n], gh[:n],
                             n_bin, m_pad)[None]


def onehot_onebig(binned_t: torch.Tensor, pos: torch.Tensor,
                  gh: torch.Tensor, m_pad: int, n_bin: int = 64,
                  r_tile: int = 2048) -> torch.Tensor:
    """T4b: T4a's function with all F features in one task (the
    prototype's one ``(F * B, R)`` product per row tile)."""
    _check_bf16_proto(binned_t, pos, gh, "T4b", (torch.int32,))
    if _device(binned_t, pos, gh) == "cpu":
        return onehot_onebig_plain(binned_t, pos, gh, m_pad, n_bin, r_tile)
    return _pack2_launch("onehot_onebig", binned_t, pos, gh, m_pad, n_bin,
                         r_tile, binned_t.shape[0])


def onehot_onebig_plain(binned_t, pos, gh, m_pad, n_bin=64, r_tile=2048):
    return onehot_pack2_plain(binned_t, pos, gh, m_pad, "prod", n_bin,
                              r_tile)


# ------------------------------------------------------------------- T6
R4_MODES = ("prod", "dotfloor", "u8bins", "i16hot")


def _check_r4(binned_t, pos, gh, mode):
    if mode not in R4_MODES:
        raise ValueError(f"mode {mode!r}: one of {R4_MODES}")
    _check_bf16_proto(binned_t, pos, gh, f"T6 {mode}",
                      (torch.uint8,) if mode == "u8bins" else (torch.int32,))


def onehot_r4(binned_t: torch.Tensor, pos: torch.Tensor, gh: torch.Tensor,
              mode: str = "prod", r_tile: int = 2048,
              n_bin: int = 64) -> torch.Tensor:
    """T6: ``(1, F * n_bin, 128)`` f32 from feature-major bins ``(F, n)``
    (uint8 for "u8bins", else int32), pos ``(n, 1)`` and f32 gh ``(n, 2)``
    rounded to bf16, M = 64; rows past ``(n // r_tile) * r_tile`` are
    dropped.  "dotfloor" puts the node totals in every feature's bin 0."""
    _check_r4(binned_t, pos, gh, mode)
    if _device(binned_t, pos, gh) == "cpu":
        return onehot_r4_plain(binned_t, pos, gh, mode, r_tile, n_bin)
    F, n = binned_t.shape
    M = M_TILE
    plan = wgmma_plan(F, n_bin, M, binned_t.dtype, feature_major=True)
    out = torch.zeros((1, F * n_bin, 2 * M), dtype=torch.float32,
                      device=binned_t.device)
    return _launch_wgmma("onehot_r4", R4_MODES.index(mode), plan, binned_t,
                         pos, gh, out, bin_sr=1, bin_sf=n, gh_sr=2, gh_sc=1,
                         out_strides=(0, n_bin * 2 * M, 2 * M, M, 1),
                         n_rows=(n // r_tile) * r_tile, n_bin=n_bin,
                         n_node_out=M)


def onehot_r4_plain(binned_t, pos, gh, mode="prod", r_tile=2048, n_bin=64):
    """Plain T6: T4a's bf16 cells at M = 64, or for "dotfloor" one
    ``index_add_`` of the node totals copied into every feature's bin 0."""
    _check_r4(binned_t, pos, gh, mode)
    F, n = binned_t.shape
    n = (n // r_tile) * r_tile
    M = M_TILE
    if mode != "dotfloor":
        return _bf16_proto_level(binned_t[:, :n], pos.reshape(-1)[:n],
                                 gh[:n], n_bin, M)[None]
    p = pos.reshape(-1)[:n].to(torch.int64)
    col = torch.where((p >= 0) & (p < M), p, 2 * M)
    idx = torch.stack([col, torch.where(col < M, col + M, col)], dim=-1)
    tot = torch.zeros(2 * M + 1, dtype=torch.float32, device=gh.device)
    tot.index_add_(0, idx.reshape(-1), _round_bf16(gh[:n]).reshape(-1))
    out = torch.zeros((F, n_bin, 2 * M), dtype=torch.float32,
                      device=gh.device)
    out[:, 0, :] = tot[:2 * M]
    return out.reshape(1, F * n_bin, 2 * M)
