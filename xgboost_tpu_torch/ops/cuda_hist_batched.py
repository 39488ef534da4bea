"""Kernel K3: T trees' level histograms over one shared bins matrix,
hand-written CUDA.

Replaces the TPU kernel ``xgboost_tpu/ops/pallas_hist.py:
_batched_hist_kernel`` (launched through ``_hist_pallas_batched_pre``).
The CUDA source is ``csrc/hist_batched.cu``, which binds the scatter
kernel of ``csrc/hist_scatter.cuh`` for any T (K1 binds it at T = 1, K4
for lanes with bins of their own); this module holds the launch plan of
all three (:func:`scatter_plan`), their launch, K3's wrapper, its plain
PyTorch version and its launch count.

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
from typing import NamedTuple, Optional

import torch

from xgboost_tpu_torch.ops import nvcc
from xgboost_tpu_torch.ops.cuda_hist import MODES, level_histogram_plain

THREADS = 1024                 # a block (csrc/hist_scatter.cuh)
SMEM_MAX = 232_448             # the opt-in limit of one block on Hopper
SMEM_SM = 233_472              # an SM's shared memory (228 KB)
SMEM_RESERVED = 1024           # the runtime's share of each resident block
PAIRS_PER_STEP = 2048          # (row, tree) pairs a step lists
# K4 (bins of each lane's own): as many pairs a step as keep the blocks an
# SM holds, up to this (fewer steps, each with more pairs in the unit's
# tile; PERF.md)
LANE_PAIRS_PER_STEP = 16384
# weights of the plan's cost, in bytes, set by hand (PERF.md says how the
# tilings they choose compare with their neighbours on the card): a global
# atomic at the flush; a shared-memory addition where fewer blocks than SMs
# run; and a block's step (its three barriers and a round trip to L2 for
# its rows' pos, ~0.3 us of a card that streams ~5 TB/s from L2)
ATOMIC_BYTES = 16
ADD_BYTES = 4
STEP_BYTES = 1.5e6

# launches of the CUDA kernel by level_histogram_batched (never by the
# plain version)
launches = 0
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    global launches
    with _COUNT_LOCK:
        launches = 0


class ScatterPlan(NamedTuple):
    """One launch of the scatter kernel (``csrc/hist_scatter.cuh``)."""
    f_tile: int
    t_tile: int
    m_tile: int
    n_units: int          # feature tiles x tree tiles x node tiles
    copies: int           # blocks a unit
    n_groups: int         # groups of ``copies`` blocks; each walks units
    rows_per_copy: int    # a multiple of 16
    rows_per_step: int    # R, a multiple of 16
    bin_pitch: int        # B | 1
    hist_bytes: int       # two planes of f_tile x t_tile x m_tile x bin_pitch
    smem: int             # smem_bytes(): histogram and pair list
    grid: int             # n_groups x copies: one wave
    store: bool           # copies == 1: each block stores its units' cells
                          # into an uninitialised output (else atomics on
                          # a zeroed one)
    cost: float           # the bytes-like cost the plan minimised


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _tile_sizes(n: int):
    """The distinct tile sizes that cut ``n`` into equal-count tiles."""
    return sorted({-(-n // k) for k in range(1, n + 1)})


def smem_bytes(hist: int, t_tile: int, rows: int) -> int:
    """A block's shared memory: the histogram and the step's list of
    (row, tree) pairs (a 16-byte header, 4 bytes a pair)."""
    return hist + 16 + 4 * t_tile * rows


def scatter_plan(n_rows: int, n_feat: int, n_bin: int, n_tree: int,
                 n_node: int, n_sm: int = 132, smem_per_sm: int = SMEM_SM,
                 max_blocks: Optional[int] = None,
                 shared_bins: bool = True) -> ScatterPlan:
    """The (f_tile, t_tile, m_tile) units and the copies of one launch of
    the scatter kernel, pure Python: of the tilings that fit
    (:func:`tile_plan`), the one of least cost in bytes
    (:func:`plan_cost`), then the fewest units, then the widest node
    tile.  ``shared_bins``: the trees read one (N, F) bins matrix (K1,
    K3), or each its own (K4's lanes)."""
    best = None
    for f_tile in _tile_sizes(n_feat):
        for t_tile in _tile_sizes(n_tree):
            for m_tile in _tile_sizes(n_node):
                plan = tile_plan(n_rows, n_feat, n_bin, n_tree, n_node,
                                 f_tile, t_tile, m_tile, n_sm, smem_per_sm,
                                 max_blocks, shared_bins)
                if plan is None:
                    continue
                key = (plan.cost, plan.n_units, -m_tile)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise NotImplementedError(
            f"no scatter plan fits {SMEM_MAX} bytes of shared memory at "
            f"F={n_feat}, B={n_bin}, T={n_tree}, n_node={n_node}")
    return best[1]


def tile_plan(n_rows: int, n_feat: int, n_bin: int, n_tree: int,
              n_node: int, f_tile: int, t_tile: int, m_tile: int,
              n_sm: int = 132, smem_per_sm: int = SMEM_SM,
              max_blocks: Optional[int] = None,
              shared_bins: bool = True) -> Optional[ScatterPlan]:
    """The launch at one tiling, or None where it does not fit.

    A unit's private histogram (two planes of f_tile x t_tile x m_tile x
    ``B | 1`` cells of 4 bytes) plus a list of R x t_tile pairs fits one
    block (:func:`smem_bytes`).  The grid is one wave: at most the
    blocks resident at once (from the shared memory a block takes, or
    ``max_blocks`` where the card's occupancy query says fewer).  Copies
    fill the blocks resident at once, no more than the rows are worth (a
    block adds at least as many values as its histogram has cells).
    Where every unit has one copy, every output cell is owned by one
    block, which stores it (``store``).  Without shared bins (K4) a step
    lists up to LANE_PAIRS_PER_STEP pairs where that keeps the blocks an
    SM holds."""
    hist = _round16(8 * f_tile * t_tile * m_tile * (n_bin | 1))
    rows = _round16(max(16, min(4096, PAIRS_PER_STEP // t_tile)))
    while rows > 16 and smem_bytes(hist, t_tile, rows) > SMEM_MAX:
        rows -= 16

    def per_sm(r):
        return min(smem_per_sm // (smem_bytes(hist, t_tile, r)
                                   + SMEM_RESERVED), 2048 // THREADS)
    if not shared_bins:
        for pairs in (LANE_PAIRS_PER_STEP, LANE_PAIRS_PER_STEP // 2,
                      LANE_PAIRS_PER_STEP // 4):
            more = _round16(max(16, pairs // t_tile))
            if more > rows and smem_bytes(hist, t_tile, more) <= SMEM_MAX \
                    and per_sm(more) == per_sm(rows):
                rows = more
                break
    smem = smem_bytes(hist, t_tile, rows)
    if smem > SMEM_MAX:
        return None
    res = per_sm(rows) * n_sm
    if max_blocks is not None:
        res = min(res, max_blocks)
    if res < 1:
        return None
    units = -(-n_feat // f_tile) * -(-n_tree // t_tile) * -(-n_node // m_tile)
    cells = f_tile * n_bin * 2 * t_tile * m_tile
    rows_min = max(16, -(-cells // (2 * f_tile * t_tile)))
    copies = max(1, min(res // units if units <= res else 1,
                        -(-n_rows // rows_min)))
    n_groups = min(units, res // copies)
    plan = ScatterPlan(
        f_tile, t_tile, m_tile, units, copies, n_groups,
        _round16(-(-max(n_rows, 1) // copies)), rows, n_bin | 1, hist, smem,
        n_groups * copies, copies == 1, 0.0)
    return plan._replace(cost=plan_cost(plan, n_rows, n_feat, n_tree, n_sm,
                                        shared_bins))


def plan_cost(p: ScatterPlan, n_rows: int, n_feat: int, n_tree: int,
              n_sm: int, shared_bins: bool = True) -> float:
    """A plan's cost in bytes: every unit reads its rows' bins of its
    features (a row's slice costs the 32-byte sectors it spans; a unit of
    t_tile trees with bins of their own reads t_tile rows' slices), pos
    and gh once; every copy of a unit zeroes its histogram, reads it once
    and adds it to global memory once (ATOMIC_BYTES a cell), or, under
    the store flush, stores it once (4 bytes a cell); where the grid
    leaves SMs idle, or where the groups walk unequal numbers of units,
    the additions cost ADD_BYTES each in proportion; and each group's
    steps, one after another, cost STEP_BYTES each."""
    if shared_bins:
        reads = p.n_units * n_rows * (min(n_feat, p.f_tile + 32)
                                      + 12 * p.t_tile)
    else:
        reads = p.n_units * n_rows * p.t_tile * (
            min(n_feat, p.f_tile + 32) + 12)
    flush = p.n_units * p.copies * p.hist_bytes * (
        2 if p.store else 1 + ATOMIC_BYTES / 4)
    adds = n_tree * n_rows * n_feat * 2
    rounds = -(-p.n_units // p.n_groups)      # units the busiest group walks
    idle = ADD_BYTES * adds * (max(0.0, n_sm / min(p.grid, n_sm) - 1)
                               + rounds * p.n_groups / p.n_units - 1)
    steps = rounds * -(-min(n_rows, p.rows_per_copy) // p.rows_per_step)
    return reads + flush + idle + STEP_BYTES * steps


_PLANS = {}       # every launch's plan, by library, card, mode and shapes


def launch_plan(name: str, n_rows: int, n_feat: int, n_bin: int,
                n_tree: int, n_node: int, mode: str,
                device: torch.device) -> ScatterPlan:
    """The plan a launch of K1 (``name`` ``hist_level``, T = 1), K3
    (``hist_batched``) or K4 (``hist_lanes``, T lanes with bins of their
    own) takes on this card: :func:`scatter_plan` at its SM count,
    planned again below the blocks its occupancy query (the library's
    ``resident(mode, smem, &blocks)``) lets run at once where that is
    fewer than the shared memory allows.  Cached, so that a level's
    launch after the first costs one dictionary lookup on the host."""
    lib = _lib(name)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (id(lib), idx, MODES[mode], n_rows, n_feat, n_bin, n_tree, n_node)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    n_sm = torch.cuda.get_device_properties(idx).multi_processor_count
    cap = None
    while True:
        plan = scatter_plan(n_rows, n_feat, n_bin, n_tree, n_node, n_sm,
                            SMEM_SM, cap, shared_bins=name != "hist_lanes")
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = getattr(lib, f"{name}_resident")(MODES[mode], plan.smem,
                                                  ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"{name} occupancy query failed (error {rc})")
        if plan.grid <= blocks.value:
            _PLANS[key] = plan
            return plan
        cap = blocks.value  # fewer than the formula: plan again below it


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
    T, N, _ = gh.shape
    out = scatter_launch("hist_batched", bins, gh, pos, T, n_node, n_bin,
                         mode)
    if out is None:
        return torch.zeros((bins.shape[1], n_bin, 2, T * n_node),
                           dtype=_acc(mode), device=bins.device)
    with _COUNT_LOCK:     # lane threads launch at once
        launches += 1
    return out


def _acc(mode):
    return torch.int32 if mode == "int" else torch.float32


def scatter_launch(name, bins, gh, pos, n_tree, n_node, n_bin, mode):
    """Launch the scatter kernel of library ``name`` (``hist_batched``
    for any T, ``hist_level`` at T = 1, both on (N, F) bins;
    ``hist_lanes`` on (T, N, F) bins) on CUDA tensors; returns the
    histogram, or None where there is nothing to launch (no rows,
    features or trees: the caller returns zeros and counts nothing)."""
    if not (gh.device == pos.device == bins.device):
        raise ValueError("bins, gh and pos must be on one device")
    if bins.dtype != torch.uint8 or n_bin > 256:
        raise NotImplementedError(
            f"the CUDA histogram takes u8 bins with B <= 256 (got "
            f"{bins.dtype}, B={n_bin})")
    if not (bins.is_contiguous() and gh.is_contiguous()
            and pos.is_contiguous()) or gh.data_ptr() % 8 \
            or pos.data_ptr() % 4:
        raise ValueError("bins, gh and pos must be contiguous, gh 8-aligned")
    N, F = bins.shape[-2:]
    if N == 0 or F == 0 or n_tree == 0:
        return None
    dev = bins.device
    lib = _lib(name)
    p = launch_plan(name, N, F, n_bin, n_tree, n_node, mode, dev)
    # the store flush writes every cell: nothing to zero
    out = (torch.empty if p.store else torch.zeros)(
        (F, n_bin, 2, n_tree * n_node), dtype=_acc(mode), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = (p.f_tile, p.m_tile) if name == "hist_level" \
        else (p.f_tile, p.t_tile, p.m_tile)
    trees = () if name == "hist_level" else (n_tree,)
    with torch.cuda.device(dev):   # the launch targets this card
        rc = getattr(lib, f"{name}_launch")(
            MODES[mode], bins.data_ptr(), pos.data_ptr(), gh.data_ptr(),
            out.data_ptr(), N, F, n_bin, *trees, n_node, *tiles, p.copies,
            p.n_groups, p.rows_per_copy, p.rows_per_step, p.hist_bytes,
            int(p.store), stream)
    if rc != 0:
        step = ("", "arguments", "shared-memory opt-in",
                "launch")[min(rc >> 16, 3)]
        raise RuntimeError(f"{name} kernel launch failed at {step}: "
                           + getattr(lib, f"{name}_error_string")(
                               rc).decode() + f" (N={N}, F={F}, B={n_bin}, "
                           f"T={n_tree}, n_node={n_node}, {p})")
    return out


def _lib(name: str = "hist_batched") -> ctypes.CDLL:
    """The scatter library ``name`` (``hist_batched``, K3;
    ``hist_level``, K1; ``hist_lanes``, K4), built at first use, its
    entry points typed."""
    lib = nvcc.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        shapes = [I, I, I, I, I] if name == "hist_level" \
            else [I, I, I, I, I, I, I]  # (F, B, [T,] n_node, f, [t,] m)
        fn.argtypes = [I, P, P, P, P, L, *shapes, I, I, L, I, I, I, P]
        fn.restype = I
        res = getattr(lib, f"{name}_resident")
        res.argtypes = [I, L, ctypes.POINTER(ctypes.c_int)]
        res.restype = I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
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
