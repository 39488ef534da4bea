"""Kernels T1, T4a, T4b and T6 of the PyTorch port, held against the JAX
package's bf16 Pallas prototypes in ``tools/``.

The port's plain versions (``xgboost_tpu_torch.ops.cuda_hist_onehot``, what
a CPU tensor runs) against the prototypes run unchanged under
``pltpu.force_tpu_interpret_mode()`` (``pallas_call`` has no other CPU
mode), on the same numpy inputs made from a seed.  On gradients exact in
bf16 (multiples of 1/64 below 2, whose f32 sums are exact in any order)
every comparison is bitwise; on random gradients each cell is held within
2 n 2^-24 sum|x| (n the cell's rows, x their bf16-rounded values), since
each order of an n-term f32 sum is within n 2^-24 sum|x| of the exact sum.
The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda.py``; ``chip_smoke.py`` at full size).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tools import hist_group_proto as jt1  # noqa: E402
from tools import hist_pack2_proto as jt4  # noqa: E402
from tools import hist_r4_ab as jt6  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist_onehot as oh  # noqa: E402

F, B = 28, 64           # the T4 / T6 prototypes' module constants
N_ROWS = 4196           # two whole 2,048-row tiles and a dropped tail
T1_F, T1_B = 6, 67      # T1 takes both from its input


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bound_ok(got, want, cnt, a):
    return bool((np.abs(got - want) <= 2.0 * cnt * 2.0 ** -24 * a).all())


@pytest.fixture(scope="module")
def fr_case():
    """T4 / T6 inputs: feature-major int32 bins in [0, 64) with ~3% planted
    at 64-99 (past n_bin), pos in [-1, 70) (a tenth at -1), gh exact in
    bf16 and random."""
    rng = np.random.RandomState(41)
    bins = rng.randint(0, B, (F, N_ROWS)).astype(np.int32)
    bad = rng.rand(F, N_ROWS) < 0.03
    bins[bad] = rng.randint(B, 100, int(bad.sum()))
    pos = rng.randint(0, 70, (N_ROWS, 1)).astype(np.int32)
    pos[rng.rand(N_ROWS) < 0.1] = -1
    dyadic = (rng.randint(-128, 128, (N_ROWS, 2)) / 64.0).astype(np.float32)
    rand = rng.randn(N_ROWS, 2).astype(np.float32)
    return bins, pos, dyadic, rand


def _t4(mode, m, bins, pos, gh, r_tile=2048):
    with pltpu.force_tpu_interpret_mode():
        if mode == "onebig":
            fn = jt4.build_onebig(m, r_tile)
        else:
            fn = jt4.build(mode, m, r_tile)
        want = np.asarray(fn(jnp.asarray(bins), jnp.asarray(pos),
                             jnp.asarray(gh)))
    if mode == "onebig":
        got = oh.onehot_onebig(_t(bins), _t(pos), _t(gh), m, B, r_tile)
    else:
        got = oh.onehot_pack2(_t(bins), _t(pos), _t(gh), m, mode, B, r_tile)
    return got.numpy(), want


@pytest.mark.parametrize("mode,m", [
    ("prod", 1), ("prod", 4), ("prod", 32),
    ("pack2", 1), ("pack2", 4), ("pack2", 32)])
def test_t4a_plain_matches_prototype_bitwise_on_bf16_exact_gh(fr_case, mode,
                                                             m):
    bins, pos, dyadic, _ = fr_case
    got, want = _t4(mode, m, bins, pos, dyadic)
    assert got.shape == want.shape == (1, F * B, 2 * m)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,r_tile", [(1, 1024), (4, 2048), (32, 2048)])
def test_t4b_plain_matches_onebig_and_prod_bitwise(fr_case, m, r_tile):
    """T4b against its prototype, and (as the JAX main checks) equal to
    T4a prod, bitwise on gh exact in bf16."""
    bins, pos, dyadic, _ = fr_case
    got, want = _t4("onebig", m, bins, pos, dyadic, r_tile)
    np.testing.assert_array_equal(got, want)
    prod, _ = _t4("prod", m, bins, pos, dyadic, r_tile)
    np.testing.assert_array_equal(got, prod)


def _t6(mode, r_tile, bins, pos, gh):
    b = bins.astype(np.uint8) if mode == "u8bins" else bins
    fn, _ = jt6.build(mode, r_tile)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(b), jnp.asarray(pos),
                             jnp.asarray(gh)))
    got = oh.onehot_r4(_t(b), _t(pos), _t(gh), mode, r_tile, B).numpy()
    return got, want


@pytest.mark.parametrize("mode,r_tile", [
    ("prod", 1024), ("prod", 2048), ("prod", 4096), ("dotfloor", 2048),
    ("u8bins", 2048), ("i16hot", 2048)])
def test_t6_plain_matches_prototype_bitwise_on_bf16_exact_gh(fr_case, mode,
                                                            r_tile):
    bins, pos, dyadic, _ = fr_case
    got, want = _t6(mode, r_tile, bins, pos, dyadic)
    assert got.shape == want.shape == (1, F * B, 128)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def t1_case():
    """T1 inputs: row-major int32 bins in [0, 80) (67-79 past n_bin but
    inside the prototype's b_pad = 72 or beyond it), pos in [-1, 75),
    gh exact in bf16 and random."""
    rng = np.random.RandomState(17)
    bins = rng.randint(0, 80, (N_ROWS, T1_F)).astype(np.int32)
    pos = rng.randint(-1, 75, N_ROWS).astype(np.int32)
    dyadic = (rng.randint(-128, 128, (N_ROWS, 2)) / 64.0).astype(np.float32)
    rand = rng.randn(N_ROWS, 2).astype(np.float32)
    return bins, pos, dyadic, rand


def _t1(bins, gh, pos, n_node, fg, r_tile=2048, hot="bfloat16"):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt1.grouped(
            jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(pos), n_node,
            T1_B, fg=fg, r_tile=r_tile, hot_dtype=getattr(jnp, hot)))
    got = oh.onehot_group(_t(bins), _t(gh), _t(pos), n_node, T1_B, fg,
                          r_tile, getattr(torch, hot)).numpy()
    return got, want


@pytest.mark.parametrize("n_node,fg,r_tile", [
    (3, 2, 1024), (64, 4, 2048), (70, 4, 1024), (64, 7, 2048)])
def test_t1_plain_matches_grouped_bitwise_on_bf16_exact_gh(t1_case, n_node,
                                                          fg, r_tile):
    bins, pos, dyadic, _ = t1_case
    got, want = _t1(bins, dyadic, pos, n_node, fg, r_tile)
    assert got.shape == want.shape == (n_node, T1_F, T1_B, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["t1", "pack2", "onebig", "t6_prod"])
def test_bf16_plain_within_sum_bound_of_prototype_on_random_gh(
        fr_case, t1_case, kernel):
    if kernel == "t1":
        bins, pos, _, rand = t1_case
        got, want = _t1(bins, rand, pos, 64, 4)

        def plain(gh):
            return oh.onehot_group(_t(bins), _t(gh), _t(pos), 64,
                                   T1_B).numpy()
    else:
        bins, pos, _, rand = fr_case
        if kernel == "t6_prod":
            got, want = _t6("prod", 2048, bins, pos, rand)

            def plain(gh):
                return oh.onehot_r4(_t(bins), _t(pos), _t(gh)).numpy()
        else:
            got, want = _t4(kernel, 32, bins, pos, rand)

            def plain(gh):
                return oh.onehot_pack2(_t(bins), _t(pos), _t(gh),
                                       32).numpy()
    ones = np.ones_like(rand)
    absx = np.abs(_t(rand).to(torch.bfloat16).float().numpy())
    assert _bound_ok(got, want, plain(ones), plain(absx))


def test_t4_t6_drop_the_partial_tile_and_t1_does_not(fr_case, t1_case):
    """Rows past the last whole r_tile add nothing in T4a, T4b and T6;
    T1 pads its rows to the tile, so every row counts."""
    bins, pos, dyadic, _ = fr_case
    whole = 2 * 2048
    cut = (_t(bins[:, :whole]), _t(pos[:whole]), _t(dyadic[:whole]))
    full = (_t(bins), _t(pos), _t(dyadic))
    for mode in ("prod", "pack2"):
        assert torch.equal(oh.onehot_pack2(*full, 4, mode),
                           oh.onehot_pack2(*cut, 4, mode))
    assert torch.equal(oh.onehot_onebig(*full, 4), oh.onehot_onebig(*cut, 4))
    assert torch.equal(oh.onehot_r4(*full), oh.onehot_r4(*cut))
    tb, tp, tg, _ = t1_case
    got, want = _t1(tb, tg, tp, 8, 2, r_tile=4096)
    np.testing.assert_array_equal(got, want)
    head = oh.onehot_group(_t(tb[:whole]), _t(tg[:whole]), _t(tp[:whole]),
                           8, T1_B)
    assert not torch.equal(torch.from_numpy(got), head)


def test_rows_outside_the_node_tile_add_nothing(fr_case):
    """pos < 0 or pos >= m_pad: the row's gh may be anything."""
    bins, pos, dyadic, _ = fr_case
    wild = dyadic.copy()
    out = ((pos[:, 0] < 0) | (pos[:, 0] >= 32))
    wild[out] = 1e6
    for mode in ("prod", "pack2"):
        got, want = _t4(mode, 32, bins, pos, wild)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, oh.onehot_pack2(_t(bins), _t(pos), _t(dyadic), 32,
                                 mode).numpy())


def test_bins_past_n_bin_add_nothing(fr_case):
    """The fixture plants ~3% bins at 64-99: the histogram equals the one
    of the same rows with those entries' gh contributions removed."""
    bins, pos, dyadic, _ = fr_case
    got = oh.onehot_pack2(_t(bins), _t(pos), _t(dyadic), 16).numpy()
    clean = np.where(bins < B, bins, 0)
    ref = np.zeros((F, B, 2, 16))
    n = 2 * 2048
    p = pos[:n, 0]
    for f in range(F):
        ok = (bins[f, :n] < B) & (p >= 0) & (p < 16)
        for c in range(2):
            np.add.at(ref[f, :, c, :], (clean[f, :n][ok], p[ok]),
                      dyadic[:n, c][ok])
    np.testing.assert_array_equal(got[0].reshape(F, B, 2, 16), ref)


def test_t1_out_of_range_bin_leaves_the_row_in_other_features(t1_case):
    """fg = 4: a bin of -1 or 1000 in one feature drops that (row,
    feature) alone; the row still counts in the group's other three."""
    bins, pos, dyadic, _ = t1_case
    planted = bins.copy()
    rows = np.arange(0, N_ROWS, 7)
    planted[rows, 1] = -1
    planted[rows[::2], 2] = 1000
    got, want = _t1(planted, dyadic, pos, 64, 4)
    np.testing.assert_array_equal(got, want)
    base = oh.onehot_group(_t(bins), _t(dyadic), _t(pos), 64, T1_B).numpy()
    np.testing.assert_array_equal(got[:, [0, 3, 4, 5]],
                                  base[:, [0, 3, 4, 5]])
    assert not np.array_equal(got[:, 1], base[:, 1])
    assert not np.array_equal(got[:, 2], base[:, 2])


def test_t6_dotfloor_puts_node_totals_in_bin_0_and_ignores_bins(fr_case):
    bins, pos, dyadic, _ = fr_case
    got = oh.onehot_r4(_t(bins), _t(pos), _t(dyadic), "dotfloor").numpy()
    other = oh.onehot_r4(_t(np.zeros_like(bins) + 5), _t(pos), _t(dyadic),
                         "dotfloor").numpy()
    np.testing.assert_array_equal(got, other)
    h = got[0].reshape(F, B, 128)
    assert not h[:, 1:].any()
    n = 2 * 2048
    p = pos[:n, 0]
    ok = (p >= 0) & (p < 64)
    tot = np.zeros((2, 64))
    for c in range(2):
        np.add.at(tot[c], p[ok], dyadic[:n, c][ok])
    for f in range(F):
        np.testing.assert_array_equal(h[f, 0], tot.reshape(-1))


def test_t1_f32_hot_rounds_gh_to_bf16_where_the_tpu_does(t1_case):
    """Deliberate difference from the JAX function on a CPU: with
    hot_dtype float32 the port rounds gh to bf16, as the TPU's
    Precision.DEFAULT does; interpret mode sums unrounded f32.  gh here
    are multiples of 1/256 below 4 (11 bits: not exact in bf16, sums
    exact in f32), so every comparison is bitwise."""
    bins, pos, _, _ = t1_case
    gh = (np.random.RandomState(9).randint(-1024, 1024, (N_ROWS, 2))
          / 256.0).astype(np.float32)
    got, want_f32hot = _t1(bins, gh, pos, 8, 2, hot="float32")
    rounded, want_bf16hot = _t1(bins, gh, pos, 8, 2, hot="bfloat16")
    np.testing.assert_array_equal(got, rounded)
    np.testing.assert_array_equal(rounded, want_bf16hot)
    assert not np.array_equal(got, want_f32hot)
    assert np.abs(got - want_f32hot).max() < 0.05


def test_pack2_with_odd_f_raises(fr_case):
    """The prototype's loop over f_tile // 2 pairs would silently drop the
    last of an odd F; the port refuses it."""
    bins, pos, dyadic, _ = fr_case
    with pytest.raises(ValueError):
        oh.onehot_pack2(_t(bins[:27]), _t(pos), _t(dyadic), 4, "pack2")
    oh.onehot_pack2(_t(bins[:27]), _t(pos), _t(dyadic), 4, "prod")
    oh.onehot_onebig(_t(bins[:27]), _t(pos), _t(dyadic), 4)


def test_t6_bin_dtype_follows_the_mode(fr_case):
    bins, pos, dyadic, _ = fr_case
    with pytest.raises(TypeError):
        oh.onehot_r4(_t(bins), _t(pos), _t(dyadic), "u8bins")
    with pytest.raises(TypeError):
        oh.onehot_r4(_t(bins.astype(np.uint8)), _t(pos), _t(dyadic), "prod")
    with pytest.raises(ValueError):
        oh.onehot_r4(_t(bins), _t(pos), _t(dyadic), "bf16hot")


def test_grouped_kernel_plan_fits_its_registers():
    """The grouped kernel's tiling: units of (feature, bin tile) over 8
    warps, at most 16 a warp with one column tile; fewer than 8 units get
    several warps each."""
    assert oh.group_plan(1, 64) == (0, 16, 2)      # T4a prod
    assert oh.group_plan(2, 64) == (0, 16, 1)      # T4a pack2
    assert oh.group_plan(4, 67) == (2, 4, 1)       # T1 fg=4
    assert oh.group_plan(14, 67) == (4, 1, 1)      # T1 fg=14
    assert oh.group_plan(28, 64) == (4, 1, 1)      # T4b onebig
    with pytest.raises(NotImplementedError):
        oh.group_plan(28, 67)                      # 140 units
    assert [oh.group_step(r) for r in (256, 1024, 2048, 3000, 4096)] == \
        [256, 1024, 2048, 2048, 2048]


WGMMA_PLANS = [  # (F, B, n_node, bin_dtype, exact)
    (28, 67, 64, "int32", False),    # the T5 and T1 mains
    (28, 67, 64, "int16", False),    # T5 i16cmp
    (28, 67, 64, "int32", True),     # T5 exact
    (28, 255, 64, "int32", False),   # the largest B
    (28, 255, 70, "int32", True),
    (5, 67, 1, "int32", False),      # F Bp not a multiple of 64
    (28, 67, 3, "int16", True),
    (28, 67, 70, "int32", False),    # two node tiles
    (93, 8, 5, "int32", False),      # narrow features, many a block
    (1, 1, 1, "int32", False),
]


def _tile_cells(plan, F, B):
    """The (feature, bin) cells each M tile of the plan holds: M row m is
    bin m % Bp of feature m // Bp, pad bins and rows past F Bp hold none."""
    return [{(m // plan.b_pad, m % plan.b_pad)
             for m in range(64 * k, 64 * (k + 1))
             if m < F * plan.b_pad and m % plan.b_pad < B}
            for k in range(plan.n_tiles)]


@pytest.mark.parametrize("F,B,n_node,bin_dtype,exact", WGMMA_PLANS)
def test_wgmma_plan_tiles_cover_every_cell_once(F, B, n_node, bin_dtype,
                                                exact):
    """T5's and T1's wgmma kernel: its M tiles hold every (feature, bin)
    cell exactly once, and each block stages every feature of its tiles,
    a feature split across two tiles in both."""
    plan = oh.wgmma_plan(F, B, n_node, getattr(torch, bin_dtype), exact)
    cells = _tile_cells(plan, F, B)
    assert sum(len(c) for c in cells) == F * B
    assert set().union(*cells) == {(f, b) for f in range(F)
                                   for b in range(B)}
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    assert len(feats) == plan.n_mblk
    split = 0
    for k, c in enumerate(cells):
        staged = feats[k // plan.tiles_per_block]
        assert {f for f, _ in c} <= set(staged)
        if k and {f for f, _ in c} & {f for f, _ in cells[k - 1]}:
            split += 1
    assert split > 0 or plan.n_tiles == 1 or 64 % plan.b_pad == 0
    assert 2 * plan.m_pad <= plan.n_col in oh.WGMMA_COLS
    assert plan.m_pad * plan.n_mt >= n_node > plan.m_pad * (plan.n_mt - 1)


@pytest.mark.parametrize("F,B,n_node,bin_dtype,exact", WGMMA_PLANS)
def test_wgmma_plan_fits_the_card(F, B, n_node, bin_dtype, exact):
    """The block's shared memory and accumulators fit an H100 SM: at most
    232,448 bytes, and accumulators at most half the 65,536 registers of
    the block's 512 threads; a step's staged bins fit the stage."""
    plan = oh.wgmma_plan(F, B, n_node, getattr(torch, bin_dtype), exact)
    assert plan.smem <= oh.SMEM_MAX
    assert plan.acc_regs * 128 * oh.WGMMA_WARPGROUPS <= 65536 // 2
    assert plan.step >= 16 and plan.step % 16 == 0
    assert plan.step <= (64 if exact else 256)
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    assert plan.step * max(len(r) for r in feats) <= oh.WGMMA_STAGE_BINS
    assert plan.n_parts == (3 if exact else 1)
    assert plan.bin_bytes == (2 if bin_dtype == "int16" else 4)


def test_wgmma_plan_at_the_mains_shape():
    """F = 28, B = 67, n_node = 64: Bp = 72, 2,016 (feature, bin) rows in
    32 tiles of 64, 4 a block, N = 128, 256 rows a step (64 exact)."""
    plan = oh.wgmma_plan(28, 67, 64)
    assert (plan.b_pad, plan.n_tiles, plan.tiles_per_block, plan.n_mblk,
            plan.n_col, plan.step, plan.acc_regs) == (72, 32, 4, 8, 128,
                                                      256, 64)
    assert oh.wgmma_plan(28, 67, 64, exact=True).step == 64
    assert oh.wgmma_plan(5, 67, 1).n_col == 8


@pytest.mark.parametrize("F,B,n_node,bin_dtype", [
    (28, 256, 64, torch.int32), (28, 0, 64, torch.int32),
    (28, 67, 64, torch.int64), (28, 67, 64, torch.uint8)])
def test_wgmma_plan_refuses_what_the_kernel_does_not_take(F, B, n_node,
                                                          bin_dtype):
    with pytest.raises(NotImplementedError):
        oh.wgmma_plan(F, B, n_node, bin_dtype)


R4_PLANS = [  # (F, B, bin_dtype): T6's feature-major bf16 plans
    (28, 64, "int32"),     # the T6 main: prod, dotfloor, i16hot
    (28, 64, "uint8"),     # u8bins
    (5, 67, "int32"),      # F Bp not a multiple of 64
    (5, 67, "uint8"),
    (28, 255, "uint8"),    # the largest B
    (93, 8, "int32"),      # narrow features, many a block
    (1, 1, "int32"),
]


def _r4_plan(F, B, bin_dtype):
    return oh.wgmma_plan(F, B, oh.M_TILE, getattr(torch, bin_dtype),
                         feature_major=True)


@pytest.mark.parametrize("F,B,bin_dtype", R4_PLANS)
def test_r4_plan_tiles_cover_every_cell_once(F, B, bin_dtype):
    """T6 on the wgmma kernel: its M tiles hold every (feature, bin) cell
    exactly once, each tile belongs to one warpgroup of one block, and
    each block stages every feature of its tiles."""
    plan = _r4_plan(F, B, bin_dtype)
    cells = _tile_cells(plan, F, B)
    assert sum(len(c) for c in cells) == F * B
    assert set().union(*cells) == {(f, b) for f in range(F)
                                   for b in range(B)}
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    blocks = oh.wgmma_block_pairs(plan)
    assert len(blocks) == plan.n_mblk == len(feats)
    owned = [t for k, pairs in enumerate(blocks) for wg in pairs
             for t, lv in wg if lv == 0
             and {f for f, _ in cells[t]} <= set(feats[k])]
    assert sorted(owned) == list(range(plan.n_tiles))


@pytest.mark.parametrize("F,B,bin_dtype", R4_PLANS)
def test_r4_plan_fits_the_card(F, B, bin_dtype):
    """One node tile of 64 nodes at N = 128, one M tile a warpgroup (64
    accumulators a thread, half the registers of 512 threads), a row step
    that is a multiple of the bf16 instruction's 16 rows, its staged bins
    within a stage, and two stages of one B tile and of the bins within
    the block's 232,448 bytes of shared memory."""
    plan = _r4_plan(F, B, bin_dtype)
    assert (plan.n_col, plan.m_pad, plan.n_mt, plan.elem) == (128, 64, 1,
                                                              "bf16")
    assert plan.feature_major and plan.n_parts == 1 and plan.n_levels == 1
    assert plan.acc_regs * 128 * oh.WGMMA_WARPGROUPS <= 65536 // 2
    assert 16 <= plan.step <= 256 and plan.step % 16 == 0
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    assert plan.step * max(len(r) for r in feats) <= oh.WGMMA_STAGE_BINS
    assert plan.smem == 2 * plan.step * 128 * 2 + 2 * oh.WGMMA_STAGE_BINS
    assert plan.smem <= oh.SMEM_MAX and plan.a_smem == 0
    assert plan.bin_bytes == (1 if bin_dtype == "uint8" else 4)


def test_r4_plan_at_the_mains_shape():
    """F = 28, B = 64: Bp = 64, one feature a tile, 28 tiles in 7 blocks
    of 4, 256 rows a step (T5 has 32 tiles at B = 67)."""
    plan = _r4_plan(28, 64, "int32")
    assert (plan.b_pad, plan.n_tiles, plan.tiles_per_block, plan.n_mblk,
            plan.step, plan.smem) == (64, 28, 4, 7, 256, 135168)


@pytest.mark.parametrize("kw", [
    dict(bin_dtype=torch.int16), dict(bin_dtype=torch.int64),
    dict(n_bin=256), dict(n_bin=0), dict(n_feat=0), dict(exact=True,
                                                        elem="s8"),
    dict(n_levels=2), dict(elem="fp8")])
def test_r4_plan_refuses_what_the_kernel_does_not_take(kw):
    """Feature-major bins are int32 or uint8; B up to 255; levels and an
    exact mode exist only where the kernel has them."""
    args = dict(n_feat=28, n_bin=64, n_node=64, bin_dtype=torch.int32,
                feature_major=True)
    args.update(kw)
    with pytest.raises(NotImplementedError):
        oh.wgmma_plan(**args)


@pytest.mark.parametrize("target", ["t1", "t7", "t3", "t2"])
def test_wgmma_split_passages_are_in_the_header(target):
    """``tools/hist_wgmma_split`` builds T1 (T7's levels form, T3's or
    T2's small-N form) with passages of ``csrc/onehot_wgmma.cuh``
    replaced, on the card only: each variant's passages are found exactly
    once in the header as it stands, every variant but ``full`` changes
    it, and its braces still pair."""
    from xgboost_tpu_torch.ops import nvcc
    from xgboost_tpu_torch.tools import hist_wgmma_split as split
    src = (nvcc.CSRC / split.HEADER).read_text()
    for name, subs in split.TARGETS[target][1].items():
        out = split.variant_source(src, subs)
        assert (out == src) == (name == "full")
        assert out.count("{") - out.count("}") == 0


def test_new_cpu_tensors_never_launch_and_meta_raises(fr_case, t1_case):
    bins, pos, dyadic, _ = fr_case
    before = {k: c.launches for k, c in oh.COUNTERS.items()}
    oh.onehot_pack2(_t(bins), _t(pos), _t(dyadic), 2, "pack2")
    oh.onehot_onebig(_t(bins), _t(pos), _t(dyadic), 2)
    oh.onehot_r4(_t(bins), _t(pos), _t(dyadic), "dotfloor")
    tb, tp, tg, _ = t1_case
    oh.onehot_group(_t(tb), _t(tg), _t(tp), 4, T1_B)
    assert {k: c.launches for k, c in oh.COUNTERS.items()} == before
    meta = torch.empty((F, N_ROWS), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        oh.onehot_pack2(meta, torch.empty((N_ROWS, 1), dtype=torch.int32,
                                          device="meta"),
                        torch.empty((N_ROWS, 2), device="meta"), 4)


def test_bf16_ported_mains_run_on_the_cpu_when_asked():
    """The three entry points at a tiny size on the CPU: every variant and
    level runs, the match checks pass and T1's accuracy line is at bf16's
    scale; without device="cpu" they want a GPU."""
    from xgboost_tpu_torch.tools import (hist_group_proto, hist_pack2_proto,
                                         hist_r4_ab)
    rows, acc = hist_group_proto.main(3000, 4, 67, 8, device="cpu", reps=1,
                                      fgs=(2, 4), r_tiles=(1024, 4096))
    assert [r["name"] for r in rows] == [
        "production bf16 (K1)", "grouped fg=2 r=1024", "grouped fg=2 r=4096",
        "grouped fg=4 r=1024", "grouped fg=4 r=4096"]
    assert 0 < acc["err"] < 0.1
    rows, chk = hist_pack2_proto.main(5000, levels=2, device="cpu", iters=1)
    assert chk["match"] and [r["name"] for r in rows] == [
        "prod M=1", "pack2 M=1", "prod M=2", "pack2 M=2"]
    rows, chk = hist_pack2_proto.main_onebig(5000, levels=1, device="cpu",
                                             iters=1)
    assert chk["match"] and len(rows) == 2
    rows = hist_r4_ab.main(5000, device="cpu", iters=1)
    assert [r["name"] for r in rows] == [
        "prod@r1024", "prod@r2048", "prod@r4096", "dotfloor@r2048",
        "u8bins@r2048", "i16hot@r2048"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            hist_r4_ab.main(3000)
