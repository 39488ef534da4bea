"""Kernels T5, T3, T2 and T7 of the PyTorch port, held against the JAX
package's Pallas prototypes in ``tools/``.

The port's plain versions (``xgboost_tpu_torch.ops.cuda_hist_onehot``, what
a CPU tensor runs) against the prototypes run under
``pltpu.force_tpu_interpret_mode()`` (``pallas_call`` has no other CPU
mode), on the same numpy inputs made from a seed.  int results are
bitwise, including the rows the prototypes' grids drop, the int8 wrap of
gh and T7's floor-mod that counts pad rows.  T5 is bitwise on gradients
exact in bf16; on random gradients it is held within 2 n 2^-24 sum|x| of
the JAX function with a bf16 one-hot, the two summing f32 in other
orders.  The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda.py``; ``chip_smoke.py`` at full size).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tools import hist_int8_proto as jt3  # noqa: E402
from tools import hist_microbench as jt5  # noqa: E402
from tools import hist_notrans_proto as jt2  # noqa: E402
from tools import hist_r5_ab as jt7  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist_onehot as oh  # noqa: E402

F, B = 28, 64           # the int prototypes' module constants
N_ROWS = 4196           # two whole 2,048-row tiles and a dropped tail


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def int_case():
    """Inputs of T3 / T2: bins both ways, pos (a fifth at -1) for up to 32
    nodes, int32 gh well beyond the int8 range."""
    rng = np.random.RandomState(11)
    bins_fr = rng.randint(0, B, (F, N_ROWS)).astype(np.int32)
    pos = rng.randint(0, 32, (N_ROWS, 1)).astype(np.int32)
    pos[rng.rand(N_ROWS) < 0.2] = -1
    gh = rng.randint(-300, 300, (N_ROWS, 2)).astype(np.int32)
    return bins_fr, pos, gh


@pytest.mark.parametrize("m", [1, 4, 32])
def test_t3_plain_matches_prototype(int_case, m):
    bins_fr, pos, gh = int_case
    p = np.where(pos < m, pos, -1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt3.build_i8(m)(jnp.asarray(bins_fr),
                                          jnp.asarray(p), jnp.asarray(gh)))
    got = oh.onehot_i8(_t(bins_fr), _t(p), _t(gh), m).numpy()
    assert got.shape == want.shape == (1, F * B, 2 * m)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [2, 16])
def test_t2_plain_matches_prototype(int_case, m):
    bins_fr, pos, gh = int_case
    bins = bins_fr.T.astype(np.uint8)
    p = np.where(pos < m, pos, -1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt2.build(m)(jnp.asarray(bins), jnp.asarray(p),
                                       jnp.asarray(gh)))
    got = oh.onehot_notrans(_t(bins), _t(p), _t(gh), m).numpy()
    np.testing.assert_array_equal(got, want)


def test_int_prototypes_drop_the_partial_tile_and_wrap_gh(int_case):
    """Rows past the last whole r_tile add nothing; a gh of 200 counts as
    -56 (int8 wrap)."""
    bins_fr, pos, gh = int_case
    whole = 2 * 2048
    full = oh.onehot_i8(_t(bins_fr), _t(pos), _t(gh), 32)
    head = oh.onehot_i8(_t(bins_fr[:, :whole]), _t(pos[:whole]),
                        _t(gh[:whole]), 32)
    assert torch.equal(full, head)
    one = np.zeros((whole, 2), np.int32)
    one[0] = 200
    got = oh.onehot_notrans(_t(bins_fr[:, :whole].T.astype(np.uint8)),
                            _t(np.zeros((whole, 1), np.int32)), _t(one), 1)
    assert int(got[0, bins_fr[0, 0], 0]) == -56


@pytest.fixture(scope="module")
def r5_case():
    """T7's main on a small scale: 4,196 real rows padded to 6,144 with
    pos -1 and random gh, so pad rows count under the floor-mod; the
    last 2,048-row tile holds rows 4,096-6,143."""
    rng = np.random.RandomState(5)
    n_pad = 6144 + 100                       # 100 rows past the last tile
    pos = np.pad(rng.randint(0, 64, N_ROWS).astype(np.int32),
                 (0, n_pad - N_ROWS), constant_values=-1)[None, :]
    gh = rng.randint(-127, 127, (2, n_pad)).astype(np.int32)
    bins = {b: rng.randint(0, b, (F, n_pad)).astype(np.uint8)
            for b in (67, 64, 32)}
    return bins, pos, gh


@pytest.mark.parametrize("mode,n_bin,n_levels", [
    ("prod", 67, 1), ("u8cmp", 64, 1), ("prod", 64, 3), ("u8cmp", 32, 2)])
def test_t7_plain_matches_prototype(r5_case, mode, n_bin, n_levels):
    bins, pos, gh = r5_case
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt7.build(mode, n_bin, n_levels)(
            jnp.asarray(bins[n_bin]), jnp.asarray(pos), jnp.asarray(gh)))
    got = oh.onehot_r5(_t(bins[n_bin]), _t(pos), _t(gh), n_bin, n_levels,
                       mode).numpy()
    assert got.shape == (n_levels, F * n_bin, 128)
    np.testing.assert_array_equal(got, want)


def test_t7_pad_rows_count_through_the_floor_mod(r5_case):
    """With n_levels > 1 a pad row (pos -1) lands in node 63 at level 0
    and node lv - 1 at level lv; with one level it adds nothing."""
    bins, pos, gh = r5_case
    pad = (pos[0] < 0)[None, :]
    quiet = np.where(np.repeat(pad, 2, 0), 0, gh)
    b = _t(bins[64])
    multi = oh.onehot_r5(b, _t(pos), _t(gh), 64, 3)
    multi_q = oh.onehot_r5(b, _t(pos), _t(quiet), 64, 3)
    diff = (multi != multi_q).reshape(3, F, 64, 2, 64).any(dim=(1, 2, 3))
    assert diff[0].nonzero().flatten().tolist() == [63]
    assert diff[1].nonzero().flatten().tolist() == [0]
    assert diff[2].nonzero().flatten().tolist() == [1]
    assert torch.equal(oh.onehot_r5(b, _t(pos), _t(gh), 64, 1),
                       oh.onehot_r5(b, _t(pos), _t(quiet), 64, 1))


@pytest.fixture(scope="module")
def t5_case():
    """T5's inputs at 4,196 x 5 rows, B = 67: pos over [-1, 140) so some
    rows fall past every node count below; gh exact in bf16 (multiples of
    1/64 below 2) and random."""
    rng = np.random.RandomState(3)
    bins = rng.randint(0, 67, (N_ROWS, 5)).astype(np.int32)
    pos = rng.randint(-1, 140, N_ROWS).astype(np.int32)
    dyadic = (rng.randint(-128, 128, (N_ROWS, 2)) / 64.0).astype(np.float32)
    rand = rng.randn(N_ROWS, 2).astype(np.float32)
    return bins, pos, dyadic, rand


def _t5(bins, gh, pos, n_node, precision, hot, bin_dtype="int32"):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt5.variant(
            jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(pos), n_node,
            67, precision=precision, hot_dtype=getattr(jnp, hot),
            bin_dtype=getattr(jnp, bin_dtype)))
    got = oh.onehot_variant(_t(bins), _t(gh), _t(pos), n_node, 67,
                            precision, getattr(torch, hot),
                            getattr(torch, bin_dtype)).numpy()
    return got, want


@pytest.mark.parametrize("n_node,precision,hot,bin_dtype", [
    (5, "bf16", "bfloat16", "int32"),
    (64, "bf16", "float32", "int32"),
    (64, "fp32", "float32", "int16"),
    (130, "bf16", "bfloat16", "int16"),     # three node tiles of 64
    (130, "fp32", "float32", "int32"),
])
def test_t5_plain_matches_variant_bitwise_on_bf16_exact_gh(
        t5_case, n_node, precision, hot, bin_dtype):
    bins, pos, dyadic, _ = t5_case
    got, want = _t5(bins, dyadic, pos, n_node, precision, hot, bin_dtype)
    assert got.shape == want.shape == (n_node, 5, 67, 2)
    np.testing.assert_array_equal(got, want)


def test_t5_plain_within_sum_bound_of_variant_on_random_gh(t5_case):
    """Against the JAX function with a bf16 one-hot (so both sum the same
    bf16-rounded gh): each cell within 2 n 2^-24 sum|x|, since each order
    of an n-term f32 sum is within n 2^-24 sum|x| of the exact sum."""
    bins, pos, _, rand = t5_case
    got, want = _t5(bins, rand, pos, 64, "bf16", "bfloat16")
    r = _t(rand).to(torch.bfloat16).float()
    n = oh.onehot_variant(_t(bins), torch.ones_like(r), _t(pos), 64, 67,
                          "fp32").numpy()
    a = oh.onehot_variant(_t(bins), r.abs(), _t(pos), 64, 67,
                          "fp32").numpy()
    assert (np.abs(got - want) <= 2.0 * n * 2.0 ** -24 * a).all()


def test_t5_rounds_gh_to_bf16_where_the_tpu_does(t5_case):
    """Deliberate difference from the JAX function on a CPU: with
    precision bf16 and an f32 one-hot the port rounds gh to bf16, as the
    TPU's matrix unit does; interpret mode sums unrounded f32.  gh here
    are multiples of 1/256 below 4 (11 bits: not exact in bf16, sums
    exact in f32), so every comparison is bitwise."""
    bins, pos, _, _ = t5_case
    gh = (np.random.RandomState(9).randint(-1024, 1024, (N_ROWS, 2))
          / 256.0).astype(np.float32)
    got, want_f32hot = _t5(bins, gh, pos, 8, "bf16", "float32")
    rounded, want_bf16hot = _t5(bins, gh, pos, 8, "bf16", "bfloat16")
    np.testing.assert_array_equal(got, rounded)
    np.testing.assert_array_equal(rounded, want_bf16hot)
    assert not np.array_equal(got, want_f32hot)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_int_plain_versions_equal_k1_int(m):
    """On gh in the int8 range and whole row tiles, T3, T2 and T7 (one
    level), re-laid to (F, B, 2, M), are K1's int histogram."""
    rng = np.random.RandomState(m)
    n = 4096
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    pos = rng.randint(0, m, n).astype(np.int32)
    pos[rng.rand(n) < 0.2] = -1
    gh = rng.randint(-127, 128, (n, 2)).astype(np.int32)
    k1 = cuda_hist.level_histogram_plain(_t(bins), _t(gh), _t(pos), m, B,
                                         "int")
    t3 = oh.onehot_i8(_t(bins.T.astype(np.int32)), _t(pos[:, None]),
                      _t(gh), m)
    t2 = oh.onehot_notrans(_t(bins), _t(pos[:, None]), _t(gh), m)
    assert torch.equal(t3[0].reshape(F, B, 2, m), k1)
    assert torch.equal(t2[0].reshape(F, B, 2, m), k1)
    if m == 64:
        t7 = oh.onehot_r5(_t(bins.T), _t(pos[None, :]), _t(gh.T), B)
        assert torch.equal(t7[0].reshape(F, B, 2, m), k1)


R5_PLANS = [  # (F, B, n_levels): T7's s8 plans, the main's and odd ones
    (28, 67, 1), (28, 64, 1), (28, 32, 1),    # the main's bin counts
    (28, 64, 6),                              # shared6
    (28, 67, 8), (28, 64, 2), (1, 8, 3),      # level groups of 4, 2, 1
    (5, 1, 1), (5, 8, 1), (5, 255, 1), (5, 8, 2), (28, 255, 8),
]


def _r5_plan(F, B, n_levels):
    return oh.wgmma_plan(F, B, oh.M_TILE, torch.uint8, feature_major=True,
                         elem="s8", n_levels=n_levels)


@pytest.mark.parametrize("F,B,n_levels", R5_PLANS)
def test_r5_plan_covers_every_cell_and_level_once(F, B, n_levels):
    """T7 on the wgmma kernel: the warpgroups' (M tile, level) pairs over
    every block of every level group hold each (feature, bin, level) cell
    exactly once, and each block stages every feature of its tiles."""
    plan = _r5_plan(F, B, n_levels)
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    blocks = oh.wgmma_block_pairs(plan)
    assert len(blocks) == plan.n_mblk * plan.n_lg
    cells = {}
    for k, pairs in enumerate(blocks):
        for wg in pairs:
            for t, lv in wg:
                for m in range(64 * t, min(64 * (t + 1), F * plan.b_pad)):
                    f, b = divmod(m, plan.b_pad)
                    if b < B:
                        assert f in feats[k % plan.n_mblk]
                        cells[f, b, lv] = cells.get((f, b, lv), 0) + 1
    assert set(cells) == {(f, b, lv) for f in range(F) for b in range(B)
                          for lv in range(n_levels)}
    assert set(cells.values()) == {1}


@pytest.mark.parametrize("F,B,n_levels", R5_PLANS)
def test_r5_plan_fits_the_card(F, B, n_levels):
    """N = 128, 64 s32 accumulators a thread (half the registers of 512
    threads), a row step that is a multiple of the s8 instruction's 32
    rows with its staged bins within a stage, and two stages of B tiles
    (one a level), of the levels form's A tiles and of the bins within
    the block's 232,448 bytes of shared memory."""
    plan = _r5_plan(F, B, n_levels)
    assert (plan.elem, plan.n_col, plan.m_pad, plan.bin_bytes) == ("s8", 128,
                                                                   64, 1)
    assert plan.acc_regs == 64
    assert plan.acc_regs * 128 * oh.WGMMA_WARPGROUPS <= 65536 // 2
    assert 32 <= plan.step <= 256 and plan.step % 32 == 0
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    assert plan.step * max(len(r) for r in feats) <= oh.WGMMA_STAGE_BINS
    if n_levels > 1:
        assert plan.lv_block * plan.tiles_per_block == oh.WGMMA_WARPGROUPS
        assert plan.n_lg == -(-n_levels // plan.lv_block)
        assert plan.a_smem == 2 * plan.tiles_per_block * 64 * plan.step
    else:
        assert (plan.lv_block, plan.n_lg, plan.a_smem) == (1, 1, 0)
    assert plan.smem == (2 * plan.lv_block * plan.step * 128 + plan.a_smem
                         + 2 * oh.WGMMA_STAGE_BINS) <= oh.SMEM_MAX


def test_r5_plan_at_the_mains_shapes():
    """B = 67: Bp = 72, 32 tiles in 8 blocks of 4, 256 rows a step;
    shared6: 2 tiles x 2 levels a block, 3 level groups; 8 levels: 1 tile
    x 4 levels, 2 groups, 192 rows a step (four levels' B tiles)."""
    p = _r5_plan(28, 67, 1)
    assert (p.b_pad, p.n_tiles, p.tiles_per_block, p.n_mblk,
            p.step) == (72, 32, 4, 8, 256)
    p = _r5_plan(28, 64, 6)
    assert (p.lv_block, p.tiles_per_block, p.n_lg, p.n_mblk,
            p.step) == (2, 2, 3, 14, 256)
    p = _r5_plan(28, 67, 8)
    assert (p.lv_block, p.tiles_per_block, p.n_lg, p.step) == (4, 1, 2, 192)
    assert [oh.wgmma_level_block(n) for n in (2, 3, 4, 6, 8)] == \
        [2, 1, 4, 2, 4]


@pytest.mark.parametrize("kw", [
    dict(exact=True), dict(elem="bf16", n_levels=2),
    dict(n_levels=2, n_node=32), dict(n_levels=0), dict(n_bin=256),
    dict(bin_dtype=torch.int16),
    dict(feature_major=False, bin_dtype=torch.int32),
    dict(elem="int8")])
def test_r5_plan_refuses_what_the_kernel_does_not_take(kw):
    """No exact mode in s8; levels only in s8 at 64 nodes; B up to 255;
    row-major s8 bins are uint8 (T2's), not int32."""
    args = dict(n_feat=28, n_bin=64, n_node=64, bin_dtype=torch.uint8,
                feature_major=True, elem="s8")
    args.update(kw)
    with pytest.raises(NotImplementedError):
        oh.wgmma_plan(**args)


# T3's and T2's s8 plans: (M, N) of the small-N form at both layouts,
# then odd shapes (B = 1, 8, 255 on five features, F = 3, B = 67, and
# above 32 nodes T7's instance at N = 128, 100 nodes in two node tiles)
INT_N = [(1, 8), (8, 16), (16, 32), (32, 64)]
INT_ODD = [(5, 1, 4), (5, 8, 16), (5, 255, 4), (3, 7, 3), (3, 64, 32),
           (28, 67, 8), (28, 64, 2), (28, 64, 5), (28, 64, 33),
           (28, 64, 100), (93, 8, 1)]
INT_PLANS = ([(28, 64, m, fm) for m, _ in INT_N for fm in (True, False)]
             + [(f, b, m, fm) for f, b, m in INT_ODD for fm in (True, False)])


def _int_plan(F, B, M, fm):
    return oh.wgmma_plan(F, B, M, torch.int32 if fm else torch.uint8,
                         feature_major=fm, elem="s8")


@pytest.mark.parametrize("F,B,M,fm", INT_PLANS)
def test_int_plan_covers_every_cell_once(F, B, M, fm):
    """T3 and T2 on the wgmma kernel: over every node tile, M block and
    warpgroup, the tiles' (feature, bin) rows and the instruction's N
    columns hold each (feature, bin, channel, node) cell exactly once;
    every M tile belongs to one warpgroup, which holds at most
    ``tiles_per_wg``, and each block stages every feature of its
    tiles."""
    plan = _int_plan(F, B, M, fm)
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    blocks = oh.wgmma_block_pairs(plan)
    assert len(blocks) == plan.n_mblk == len(feats)
    tiles = [t for pairs in blocks for wg in pairs for t, _ in wg]
    assert sorted(tiles) == list(range(plan.n_tiles))
    cells = {}
    for nt in range(plan.n_mt):
        for k, pairs in enumerate(blocks):
            for wg in pairs:
                assert len(wg) <= plan.tiles_per_wg
                for t, _ in wg:
                    for m in range(64 * t, min(64 * (t + 1), F * plan.b_pad)):
                        f, b = divmod(m, plan.b_pad)
                        if b >= B:
                            continue
                        assert f in feats[k]
                        for c in range(min(plan.n_col, 2 * plan.m_pad)):
                            ch, j = divmod(c, plan.m_pad)
                            node = nt * plan.m_pad + j
                            if node < M:
                                key = (f, b, ch, node)
                                cells[key] = cells.get(key, 0) + 1
    assert set(cells) == {(f, b, c, j) for f in range(F) for b in range(B)
                          for c in range(2) for j in range(M)}
    assert set(cells.values()) == {1}


@pytest.mark.parametrize("F,B,M,fm", INT_PLANS)
def test_int_plan_fits_the_card(F, B, M, fm):
    """At most 64 s32 accumulators a thread (half the registers of 512
    threads), with the live A fragments at most 72; the row step a
    multiple of the s8 instruction's 32 rows, its staged bins (and T2's
    words, at most ``stage / 4 + 384``) within a stage of 4,096 bins below
    N = 128 (2,048 at 128); shared memory within 232,448 bytes; Bp a
    multiple of 16 below N = 128 (one word serves M rows g and g + 8)."""
    plan = _int_plan(F, B, M, fm)
    small = plan.n_col < 128
    assert oh.wgmma_small(plan) == small
    assert (plan.elem, plan.bin_bytes, plan.n_levels) == (
        "s8", 4 if fm else 1, 1)
    assert 2 * plan.m_pad <= plan.n_col in oh.WGMMA_COLS
    assert plan.m_pad * plan.n_mt >= M > plan.m_pad * (plan.n_mt - 1)
    assert plan.acc_regs == plan.tiles_per_wg * plan.n_col // 2 <= 64
    assert plan.acc_regs * 128 * oh.WGMMA_WARPGROUPS <= 65536 // 2
    assert plan.acc_regs + 4 * plan.tiles_per_wg <= 72
    assert plan.b_pad % (16 if small else 8) == 0
    assert plan.b_pad - (16 if small else 8) < B <= plan.b_pad
    assert plan.stage_bins == (4096 if small else oh.WGMMA_STAGE_BINS)
    assert 32 <= plan.step <= 256 and plan.step % 32 == 0
    feats = oh.wgmma_block_features(F, plan.b_pad, plan.tiles_per_block)
    assert plan.step * max(len(r) for r in feats) <= plan.stage_bins
    slots = (plan.stage_bins // 4 + 384 + 511) // 512
    for r in feats:
        words = (r.stop - 1) // 4 - r.start // 4 + 1
        assert plan.step * words <= slots * 512
    assert plan.smem == 2 * plan.step * plan.n_col + 2 * plan.stage_bins
    assert plan.smem <= oh.SMEM_MAX


@pytest.mark.parametrize("fm", [True, False])
def test_int_plan_at_the_mains_shapes(fm):
    """F = 28, B = 64 (28 tiles of one feature each): N = 8 at M = 1-4, 7
    tiles a warpgroup, all 28 in one block, 128 rows a step; N = 16 (M =
    8) 5 a warpgroup, two blocks of 14, 256 rows; N = 32 (M = 16) 3, three
    blocks of 10, 10 and 8; N = 64 (M = 32) 2, four blocks of 7, spread 2,
    2, 2, 1 over the warpgroups; M = 33: T7's instance, N = 128."""
    want = {1: (8, 7, 28, 1, 128), 2: (8, 7, 28, 1, 128),
            4: (8, 7, 28, 1, 128), 8: (16, 5, 14, 2, 256),
            16: (32, 3, 10, 3, 256), 32: (64, 2, 7, 4, 256),
            33: (128, 1, 4, 7, 256)}
    for m, w in want.items():
        p = _int_plan(28, 64, m, fm)
        assert (p.n_col, p.tiles_per_wg, p.tiles_per_block, p.n_mblk,
                p.step) == w, m
        assert p.b_pad == 64 and p.n_tiles == 28
    p = _int_plan(28, 64, 32, fm)
    assert [[len(wg) for wg in pairs] for pairs in oh.wgmma_block_pairs(p)] \
        == [[2, 2, 2, 1]] * 4
    assert [len(wg) for wg in oh.wgmma_block_pairs(_int_plan(
        28, 64, 8, fm))[1]] == [4, 4, 3, 3]


@pytest.mark.parametrize("fm", [True, False])
@pytest.mark.parametrize("kw", [dict(n_bin=256), dict(n_bin=0),
                                dict(n_node=0)])
def test_int_plan_refuses_what_the_kernel_does_not_take(fm, kw):
    """B = 256 (the mma.sync port took it; byte 255 marks a bad bin), B =
    0 and no nodes raise ``NotImplementedError``."""
    args = dict(n_feat=28, n_bin=64, n_node=4,
                bin_dtype=torch.int32 if fm else torch.uint8,
                feature_major=fm, elem="s8")
    args.update(kw)
    with pytest.raises(NotImplementedError):
        oh.wgmma_plan(**args)


def test_int_wrappers_take_any_r_tile_and_check_it(int_case):
    """r_tile only says where the tail is dropped: any r_tile >= 1 runs
    (here the plain version, as on the CPU), 0 raises."""
    bins_fr, pos, gh = int_case
    got = oh.onehot_i8(_t(bins_fr), _t(pos), _t(gh), 4, r_tile=1000)
    head = oh.onehot_i8(_t(bins_fr[:, :4000]), _t(pos[:4000]),
                        _t(gh[:4000]), 4, r_tile=4000)
    assert torch.equal(got, head)
    got2 = oh.onehot_notrans(_t(bins_fr.T.astype(np.uint8)), _t(pos),
                             _t(gh), 4, r_tile=1000)
    assert torch.equal(got, got2)
    with pytest.raises(ValueError):
        oh.onehot_i8(_t(bins_fr), _t(pos), _t(gh), 4, r_tile=0)


def test_cpu_tensors_never_launch_and_meta_raises(int_case):
    bins_fr, pos, gh = int_case
    before = {k: c.launches for k, c in oh.COUNTERS.items()}
    oh.onehot_i8(_t(bins_fr), _t(pos), _t(gh), 4)
    oh.onehot_notrans(_t(bins_fr.T.astype(np.uint8)), _t(pos), _t(gh), 4)
    oh.onehot_r5(_t(bins_fr.astype(np.uint8)), _t(pos.T), _t(gh.T), 64)
    oh.onehot_variant(_t(bins_fr.T), _t(gh.astype(np.float32)),
                      _t(pos[:, 0]), 4, 64)
    assert {k: c.launches for k, c in oh.COUNTERS.items()} == before
    meta = torch.empty((F, N_ROWS), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        oh.onehot_i8(meta, torch.empty((N_ROWS, 1), dtype=torch.int32,
                                       device="meta"),
                     torch.empty((N_ROWS, 2), dtype=torch.int32,
                                 device="meta"), 4)


def test_ported_mains_run_on_the_cpu_when_asked():
    """The four entry points at a tiny size on the CPU: every variant and
    level runs, T3's dequantized error is small and T2's sums are exact;
    without device="cpu" they want a GPU."""
    from xgboost_tpu_torch.tools import (hist_int8_proto, hist_microbench,
                                         hist_notrans_proto, hist_r5_ab)
    rows = hist_microbench.main(2000, 4, 67, device="cpu", reps=1)
    assert [r["name"] for r in rows][1:] == [v for v, _ in
                                             hist_microbench.VARIANTS]
    rows, acc = hist_int8_proto.main(3000, levels=2, device="cpu", iters=1)
    assert len(rows) == 2 and acc["within_bound"]
    rows, acc = hist_notrans_proto.main(3000, levels=2, device="cpu",
                                        iters=1)
    assert acc["exact"]
    rows = hist_r5_ab.main(3000, bin_counts=(32,), device="cpu", iters=1)
    assert [r["name"] for r in rows] == ["prod B=32", "u8cmp B=32",
                                         "shared6 B=64"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            hist_r5_ab.main(3000)
