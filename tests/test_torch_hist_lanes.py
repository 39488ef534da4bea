"""Kernel K4 (the lane-stacked histogram) of the PyTorch port, held
against the JAX package, and the lane branches of the histogram and the
split search.

The port's plain K4 (what a CPU tensor runs) against the JAX package's
``build_level_histogram_pallas_lanes`` in interpret mode, on the same
numpy inputs.  Tolerances and why:

- int8 with per-lane scales: bitwise on any gradients (integer sums,
  the same quantization and the same ``scale * f32(1/127)`` step);
- fp32 on dyadic gradients (multiples of 1/256, small): bitwise, f32
  sums of them are exact in any order; on random gradients within
  2 n 2^-24 sum|x| per cell: the Pallas kernel sums each 2048-row tile
  in a dot of its own order, the plain version in row order, and each
  order is within n 2^-24 sum|x| of the exact sum;
- each lane's slice against K1's plain version on that lane's unpadded
  rows, and the split search over a lane level against solo searches:
  bitwise, the same additions in the same order.

The CUDA kernel runs only on a GPU: its cases against this plain
version are in ``tests/test_torch_cuda.py`` (marked ``cuda``; that file
imports no JAX, so it runs on a machine with only torch), and
``chip_smoke.py`` holds it against the plain version at full size.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xgboost_tpu.ops import pallas_hist as ph  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist_batched as kb  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist_lanes as k4  # noqa: E402
from xgboost_tpu_torch.ops import histogram as thist  # noqa: E402
from xgboost_tpu_torch.ops.split import (SplitConfig,  # noqa: E402
                                         find_best_splits_native)


def _case(L, N, F, B, M, seed=5, dyadic=True, n_real=None):
    """L lanes of N rows; lane l has ``n_real[l]`` real rows, the rest
    pad rows (pos -1, gh 0, random bins)."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (L, N, F)).astype(np.uint8)
    if dyadic:
        gh = (rng.randint(-512, 512, (L, N, 2)) / 256.0).astype(np.float32)
    else:
        gh = (rng.randn(L, N, 2) * [0.8, 0.3]).astype(np.float32)
    pos = rng.randint(0, M, (L, N)).astype(np.int32)
    pos[rng.rand(L, N) < 0.2] = -1
    if n_real is not None:
        for lane, n in enumerate(n_real):
            pos[lane, n:] = -1
            gh[lane, n:] = 0.0
    return binned, gh, pos


def _per_lane(native, L, M):
    """(F, B, 2, L*M) -> the JAX lane kernel's (L, M, F, B, 2)."""
    F, B = native.shape[:2]
    return np.transpose(native.reshape(F, B, 2, L, M), (3, 4, 0, 1, 2))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pallas_lanes(binned, gh, pos, M, B, precision):
    return np.asarray(ph.build_level_histogram_pallas_lanes(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
        precision=precision, interpret=True))


@pytest.mark.parametrize("L,N,F,B,M", [
    (3, 300, 5, 16, 4),
    (2, 257, 4, 67, 64),    # bench-like bins, one full node tile
    (4, 64, 3, 8, 1),       # root level, a stack of 4
])
def test_plain_int8_per_lane_scales_match_pallas_lanes(L, N, F, B, M):
    """Random gradients, int8: quantize per lane -> int32 sums ->
    dequantize with each lane's scale, bit for bit."""
    binned, gh, pos = _case(L, N, F, B, M, seed=L + M, dyadic=False)
    gh[1] *= 9.0                            # lanes of different scales
    want = _pallas_lanes(binned, gh, pos, M, B, "int8")
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    prep = thist.prepare_hist(gh_t, "int8")
    assert prep.mode == "int8" and prep.scale.shape == (L, 2)
    got = thist.build_level_histogram_lanes(b_t, prep, pos_t, M, B)
    assert got.shape == (F, B, 2, L * M)
    np.testing.assert_array_equal(_per_lane(got.numpy(), L, M), want)


@pytest.mark.parametrize("dyadic", [True, False])
def test_plain_fp32_matches_pallas_lanes(dyadic):
    L, N, F, B, M = 3, 700, 6, 32, 8
    binned, gh, pos = _case(L, N, F, B, M, seed=17, dyadic=dyadic)
    want = _pallas_lanes(binned, gh, pos, M, B, "fp32")
    got = k4.level_histogram_lanes(*_t(binned, gh, pos), M, B, "fp32")
    got = _per_lane(got.numpy(), L, M)
    if dyadic:
        np.testing.assert_array_equal(got, want)
        return
    n = _per_lane(k4.level_histogram_lanes_plain(
        *_t(binned, np.ones_like(gh), pos), M, B, "fp32").numpy(), L, M)
    a = _per_lane(k4.level_histogram_lanes_plain(
        *_t(binned, np.abs(gh), pos), M, B, "fp32").numpy(), L, M)
    assert (np.abs(got - want) <= 2.0 * n * 2.0 ** -24 * a).all()
    assert not np.array_equal(got, np.zeros_like(got))


@pytest.mark.parametrize("mode", ["int", "fp32", "bf16"])
def test_each_lane_equals_plain_k1_on_its_unpadded_rows(mode):
    """Lane l's columns are bitwise K1's plain version on the lane's
    first n_l rows, random gradients, every mode."""
    L, N, F, B, M = 4, 640, 5, 24, 8
    n_real = [640, 601, 333, 0]             # the last lane is a pad lane
    binned, gh, pos = _case(L, N, F, B, M, seed=3, dyadic=False,
                            n_real=n_real)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    if mode == "int":
        gh_t = cuda_hist.quantize_gh(gh_t)[0]
    got = k4.level_histogram_lanes(b_t, gh_t, pos_t, M, B, mode)
    for lane, n in enumerate(n_real):
        solo = cuda_hist.level_histogram_plain(
            b_t[lane, :n].contiguous(), gh_t[lane, :n].contiguous(),
            pos_t[lane, :n].contiguous(), M, B, mode)
        assert torch.equal(got[..., lane * M:(lane + 1) * M], solo), lane
    assert not got[..., 3 * M:].any()       # the pad lane adds nothing


@pytest.mark.parametrize("precision", ["int8", "fp32", "fixed"])
def test_lane_level_equals_solo_levels_through_the_dispatch(precision):
    """``build_level_histogram_lanes`` with pad rows == each lane's solo
    ``build_level_histogram`` on its own unpadded rows, bitwise: pad
    rows have zero gradients, so a lane's int8 scale is its solo
    scale."""
    L, N, F, B, M = 3, 512, 4, 16, 4
    n_real = [512, 450, 97]
    binned, gh, pos = _case(L, N, F, B, M, seed=41, dyadic=False,
                            n_real=n_real)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    stacked = thist.build_level_histogram_lanes(
        b_t, thist.prepare_hist(gh_t, precision), pos_t, M, B)
    for lane, n in enumerate(n_real):
        solo = thist.build_level_histogram(
            b_t[lane, :n].contiguous(),
            thist.prepare_hist(gh_t[lane, :n].contiguous(), precision),
            pos_t[lane, :n].contiguous(), M, B)
        got = stacked[..., lane * M:(lane + 1) * M]
        assert torch.equal(got, solo), lane
        assert torch.equal(torch.signbit(got), torch.signbit(solo)), lane


def _plant(rng, binned, B, share):
    """``share`` of the bins at values in [B, 256), and the last
    feature of each lane's first rows at 255: binning never makes them,
    the kernel and every plain version skip them."""
    hit = rng.rand(*binned.shape) < share
    binned[hit] = rng.randint(B, 256, int(hit.sum()))
    binned[:, :7, -1] = 255
    return binned


@pytest.mark.parametrize("mode", ["int", "fp32"])
def test_bins_past_b_are_skipped_as_by_solo_k1(mode):
    """Bins >= B (planted, one in the last feature of every lane) add
    nothing: each lane's slice is K1's plain version on the lane's
    unpadded rows, bitwise, and no index leaves the histogram."""
    L, N, F, B, M = 3, 300, 5, 8, 4
    n_real = [300, 251, 120]
    binned, gh, pos = _case(L, N, F, B, M, seed=13, dyadic=False,
                            n_real=n_real)
    binned = _plant(np.random.RandomState(14), binned, B, 0.05)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    if mode == "int":
        gh_t = cuda_hist.quantize_gh(gh_t)[0]
    got = k4.level_histogram_lanes(b_t, gh_t, pos_t, M, B, mode)
    for lane, n in enumerate(n_real):
        solo = cuda_hist.level_histogram_plain(
            b_t[lane, :n].contiguous(), gh_t[lane, :n].contiguous(),
            pos_t[lane, :n].contiguous(), M, B, mode)
        assert torch.equal(got[..., lane * M:(lane + 1) * M], solo), lane


def test_bins_past_b_int8_match_pallas_lanes():
    """The same planted bins through the int8 dispatch equal the JAX
    package's lane kernel, which matches them to no one-hot column."""
    L, N, F, B, M = 3, 200, 5, 8, 4
    binned, gh, pos = _case(L, N, F, B, M, seed=15, dyadic=False)
    binned = _plant(np.random.RandomState(16), binned, B, 0.05)
    want = _pallas_lanes(binned, gh, pos, M, B, "int8")
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    got = thist.build_level_histogram_lanes(
        b_t, thist.prepare_hist(gh_t, "int8"), pos_t, M, B)
    np.testing.assert_array_equal(_per_lane(got.numpy(), L, M), want)


def test_pad_rows_and_pad_lanes_add_nothing():
    """Appending pad rows (pos -1, zero gh, any bins) and pad lanes
    (every row inactive) leaves the real lanes' columns bitwise as they
    were; the pad lanes' columns are zero."""
    L, N, F, B, M = 3, 200, 4, 16, 8
    binned, gh, pos = _case(L, N, F, B, M, seed=9, dyadic=False)
    base = k4.level_histogram_lanes(*_t(binned, gh, pos), M, B, "fp32")
    rng = np.random.RandomState(1)
    Lp, Np = 4, 256
    pb = rng.randint(0, B, (Lp, Np, F)).astype(np.uint8)
    pg = np.zeros((Lp, Np, 2), np.float32)
    pp = np.full((Lp, Np), -1, np.int32)
    pb[:L, :N], pg[:L, :N], pp[:L, :N] = binned, gh, pos
    padded = k4.level_histogram_lanes(*_t(pb, pg, pp), M, B, "fp32")
    assert torch.equal(padded[..., :L * M], base)
    assert not padded[..., L * M:].any()


def _nst(hist):
    return thist.stats_from_histogram_native(hist)


def test_per_column_n_cuts_equal_shared_n_cuts():
    """``n_cuts`` of shape (F, n_col) that repeats one (F,) count per
    column gives the same bits as the (F,) form."""
    L, N, F, B, M = 3, 1500, 6, 40, 8
    binned, gh, pos = _case(L, N, F, B, M, seed=23, dyadic=False)
    gh[..., 1] = np.abs(gh[..., 1]) + 0.05
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    hist = thist.build_level_histogram_lanes(
        b_t, thist.prepare_hist(gh_t, "fp32"), pos_t, M, B)
    n_cuts = torch.from_numpy(
        np.random.RandomState(1).randint(3, B - 2, F).astype(np.int32))
    cfg = SplitConfig(min_child_weight=0.5)
    shared = find_best_splits_native(hist, _nst(hist), n_cuts, cfg)
    per_col = find_best_splits_native(
        hist, _nst(hist), n_cuts[:, None].expand(F, L * M).contiguous(),
        cfg)
    assert bool(shared.valid.any())
    for name, a, b in zip(shared._fields, shared, per_col):
        assert torch.equal(a, b), name


def test_per_lane_n_cuts_equal_solo_searches():
    """Lanes with cut counts of their own: the search over the lane
    level's L * n_node columns equals each lane's solo search with its
    own (F,) counts, bitwise."""
    L, N, F, B, M = 3, 1200, 5, 32, 4
    binned, gh, pos = _case(L, N, F, B, M, seed=29, dyadic=False)
    gh[..., 1] = np.abs(gh[..., 1]) + 0.05
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    hist = thist.build_level_histogram_lanes(
        b_t, thist.prepare_hist(gh_t, "fp32"), pos_t, M, B)
    n_cuts = torch.from_numpy(np.random.RandomState(2).randint(
        2, B - 2, (L, F)).astype(np.int32))
    cfg = SplitConfig(min_child_weight=0.5)
    col_cuts = n_cuts.T[:, :, None].expand(-1, L, M).reshape(-1, L * M)
    lanes = find_best_splits_native(hist, _nst(hist), col_cuts, cfg)
    for lane in range(L):
        h = hist[..., lane * M:(lane + 1) * M].contiguous()
        solo = find_best_splits_native(h, _nst(h), n_cuts[lane], cfg)
        for name, a, b in zip(solo._fields, lanes, solo):
            assert torch.equal(a[lane * M:(lane + 1) * M], b), (lane, name)


@pytest.mark.parametrize("L,N,F,B,M", [(64, 16384, 28, 64, 32),
                                       (48, 16384, 28, 64, 1),
                                       (1, 10**6, 28, 64, 128),
                                       (8, 4096, 93, 256, 64),
                                       (3, 10, 3, 7, 3)])
@pytest.mark.parametrize("n_sm", [132, 114])     # H100 SXM, H100 PCIe
def test_lane_tiling_covers_rows_and_fits_shared_memory(L, N, F, B, M,
                                                        n_sm):
    """K4's launch plan (the scatter plan with bins of each lane's own):
    every (feature, lane, node) cell owned by one unit, every unit walked
    by one group of blocks, every row in one step of one copy, histogram
    and pair list within a block's shared memory, one wave of blocks;
    and the store flush exactly where each unit has one copy, so that
    every output cell is written by one block."""
    p = kb.scatter_plan(N, F, B, L, M, n_sm, shared_bins=False)
    n_t, n_m = -(-L // p.t_tile), -(-M // p.m_tile)
    assert p.n_units == -(-F // p.f_tile) * n_t * n_m
    owner = np.zeros((F, L, M), dtype=np.int64)
    for u in range(p.n_units):              # the kernel's unit order
        mi, ti, fi = u % n_m, (u // n_m) % n_t, u // (n_m * n_t)
        owner[fi * p.f_tile:(fi + 1) * p.f_tile,
              ti * p.t_tile:(ti + 1) * p.t_tile,
              mi * p.m_tile:(mi + 1) * p.m_tile] += 1
    assert (owner == 1).all()
    flushes = np.zeros(p.n_units, dtype=np.int64)   # blocks flushing a unit
    for block in range(p.grid):
        flushes[block // p.copies::p.n_groups] += 1
    assert (flushes == p.copies).all()
    rows = np.zeros(N, dtype=np.int64)
    for c in range(p.copies):
        rb, re = c * p.rows_per_copy, min(N, (c + 1) * p.rows_per_copy)
        for r0 in range(rb, re, p.rows_per_step):
            rows[r0:min(re, r0 + p.rows_per_step)] += 1
    assert (rows == 1).all()
    assert p.rows_per_step <= 65_536 and p.t_tile <= 64  # (k << 16) | r
    assert p.smem == kb.smem_bytes(p.hist_bytes, p.t_tile,
                                   p.rows_per_step) <= kb.SMEM_MAX
    assert p.grid <= min(kb.SMEM_SM // (p.smem + kb.SMEM_RESERVED),
                         2048 // kb.THREADS) * n_sm
    assert p.store == (p.copies == 1)
    assert p == kb.tile_plan(N, F, B, L, M, p.f_tile, p.t_tile, p.m_tile,
                             n_sm, shared_bins=False)
    if (L, M) == (64, 32):       # the lanes' deepest level: the store flush
        assert p.store and p.n_units > p.grid


def test_lane_wrapper_checks_inputs():
    binned, gh, pos = _case(2, 10, 2, 8, 2)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    with pytest.raises(TypeError):
        k4.level_histogram_lanes(b_t, gh_t, pos_t, 2, 8, "int")
    with pytest.raises(ValueError):
        k4.level_histogram_lanes(b_t[0], gh_t[0], pos_t[0], 2, 8, "fp32")
    with pytest.raises(ValueError):
        k4.level_histogram_lanes(b_t, gh_t, pos_t[:, :5], 2, 8, "fp32")
    with pytest.raises(ValueError):
        k4.level_histogram_lanes(b_t, gh_t, pos_t, 2, 8, "fp16")
    before = k4.launches
    k4.level_histogram_lanes(b_t, gh_t, pos_t, 2, 8, "fp32")
    assert k4.launches == before    # the plain version counts nothing
