"""Kernel K1 of the PyTorch port, held against the JAX package.

The port's plain K1 (``xgboost_tpu_torch.ops.cuda_hist``, what a CPU
tensor runs) against the JAX scatter (``build_level_histogram``) and the
Pallas kernel in interpret mode, on the same numpy inputs.  Gradients
are dyadic (multiples of 1/256, small), so f32 sums are exact in any
order and fp32 / bf16 must match bit for bit; int8 sums are integers and
match bit for bit on any gradients.  The CUDA kernel itself runs only on
a GPU (``tests/test_torch_cuda.py``; ``chip_smoke.py`` holds it against
the plain version at full size).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xgboost_tpu.ops import pallas_hist as ph  # noqa: E402
from xgboost_tpu.ops.histogram import build_level_histogram  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist  # noqa: E402
from xgboost_tpu_torch.ops import histogram as thist  # noqa: E402


def _case(N, F, B, M, seed=0, frac_inactive=0.2, dyadic=True):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    if dyadic:
        gh = (rng.randint(-512, 512, (N, 2)) / 256.0).astype(np.float32)
    else:
        gh = rng.randn(N, 2).astype(np.float32)
    pos = rng.randint(0, M, N).astype(np.int32)
    pos[rng.rand(N) < frac_inactive] = -1
    return binned, gh, pos


def _plain(binned, gh, pos, M, B, mode):
    out = cuda_hist.level_histogram(torch.from_numpy(binned),
                                    torch.from_numpy(gh),
                                    torch.from_numpy(pos), M, B, mode)
    return out.numpy()


def _standard(native):
    """(F, B, 2, M) -> the JAX package's (M, F, B, 2)."""
    return np.transpose(native, (3, 0, 1, 2))


@pytest.mark.parametrize("N,F,B,M,dyadic", [
    (1000, 5, 32, 8, True),      # generic
    (513, 7, 67, 64, True),      # unaligned rows, bench-like bin count
    (300, 3, 16, 1, True),       # root level
    (400, 4, 8, 128, True),      # two node tiles of the TPU kernel
    # random f32 gh: still bitwise, because on the CPU both the plain
    # index_add_ and the XLA scatter add a cell's rows in row order
    (3000, 5, 32, 4, False),
])
def test_plain_fp32_matches_jax_scatter(N, F, B, M, dyadic):
    binned, gh, pos = _case(N, F, B, M, dyadic=dyadic)
    want = np.asarray(build_level_histogram(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B))
    got = _plain(binned, gh, pos, M, B, "fp32")
    assert got.shape == (F, B, 2, M)
    np.testing.assert_array_equal(_standard(got), want)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_plain_float_modes_match_pallas_interpret(mode):
    N, F, B, M = 700, 4, 32, 8
    binned, gh, pos = _case(N, F, B, M, seed=3)
    want = np.asarray(ph.build_level_histogram_pallas(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
        precision=mode, interpret=True))
    got = _plain(binned, gh, pos, M, B, mode)
    np.testing.assert_array_equal(_standard(got), want)


def test_quantize_gh_bitwise():
    """Random (non-dyadic) gradients: the same scale and int8 codes."""
    rng = np.random.RandomState(5)
    gh = (rng.randn(3000, 2) * [0.7, 0.2]).astype(np.float32)
    gh[7] = [0.5, -0.25]
    q_j, s_j = ph.quantize_gh(jnp.asarray(gh))
    q_t, s_t = cuda_hist.quantize_gh(torch.from_numpy(gh))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t.dtype == torch.int32 and s_t.dtype == torch.float32


@pytest.mark.parametrize("M", [4, 128])
def test_int8_histogram_matches_pallas_bitwise(M):
    """quantize -> int32 sums -> dequantize, on random gradients: the
    port's dispatch equals the Pallas int8 kernel bit for bit, node
    tiling (M > 64) included."""
    N, F, B = 900, 3, 16
    binned, gh, pos = _case(N, F, B, M, seed=7, dyadic=False)
    want = np.asarray(ph.build_level_histogram_pallas(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
        precision="int8", interpret=True))
    prep = thist.prepare_hist(torch.from_numpy(gh), "int8")
    assert prep.mode == "int8" and prep.gh_in.dtype == torch.int32
    got = thist.build_level_histogram(torch.from_numpy(binned), prep,
                                      torch.from_numpy(pos), M, B)
    np.testing.assert_array_equal(_standard(got.numpy()), want)


def test_native_layout_matches_pallas_native():
    """The kernel-native (F, B, 2, n_node) layout, int8, straight from
    the Pallas kernel's prepared-operand entry."""
    N, F, B, M = 600, 5, 32, 16
    binned, gh, pos = _case(N, F, B, M, seed=9, dyadic=False)
    gq, scale = ph.quantize_gh(jnp.asarray(gh))
    want = np.asarray(ph._hist_pallas_pre(
        ph.transpose_bins(jnp.asarray(binned), B), gq, scale,
        jnp.asarray(pos), (N, F), M, B, "int8", True, native=True))
    prep = thist.prepare_hist(torch.from_numpy(gh), "int8")
    got = thist.build_level_histogram(torch.from_numpy(binned), prep,
                                      torch.from_numpy(pos), M, B)
    assert want.shape == got.shape == (F, B, 2, M)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int"])
def test_all_inactive_rows_give_zeros(mode):
    binned, gh, pos = _case(64, 2, 8, 4)
    pos[:] = -1
    if mode == "int":
        gh = np.round(gh * 100).astype(np.int32)
    got = _plain(binned, gh, pos, 4, 8, mode)
    assert not got.any()
    assert not np.signbit(got).any()


def test_fixed_mode_is_the_jax_fixed_point_scatter():
    N, F, B, M = 800, 4, 16, 8
    binned, gh, pos = _case(N, F, B, M, seed=13, dyadic=False)
    want = np.asarray(build_level_histogram(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
        precision="fixed"))
    prep = thist.prepare_hist(torch.from_numpy(gh), "fixed")
    raw = cuda_hist.level_histogram(torch.from_numpy(binned), prep.gh_in,
                                    torch.from_numpy(pos), M, B, "int")
    np.testing.assert_array_equal(_standard(raw.numpy()), want)


def test_resolve_precision_and_modes():
    assert cuda_hist.resolve_precision("int8", 1_000_000) == "int8"
    n_big = 2 ** 31 // 127 + 1
    assert cuda_hist.resolve_precision("int8", n_big) == "bf16"
    assert cuda_hist.resolve_precision("int8", n_big) == \
        ph.resolve_precision("int8", n_big)
    assert cuda_hist.resolve_precision("fp32", n_big) == "fp32"
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert thist.resolve_mode("auto", gpu, 100) == "int8"
    assert thist.resolve_mode("auto", cpu, 100) == "fp32"
    assert thist.resolve_mode("auto", gpu, n_big) == "bf16"
    assert thist.resolve_mode("bf16", cpu, 100) == "bf16"
    assert thist.resolve_mode("fixed", gpu, 100) == "fixed"
    with pytest.raises(ValueError):
        thist.resolve_mode("fp64", cpu, 100)


def test_wrapper_checks_inputs():
    binned, gh, pos = _case(10, 2, 8, 2)
    t = torch.from_numpy
    with pytest.raises(TypeError):
        cuda_hist.level_histogram(t(binned), t(gh), t(pos), 2, 8, "int")
    with pytest.raises(ValueError):
        cuda_hist.level_histogram(t(binned), t(gh)[:5], t(pos), 2, 8,
                                  "fp32")
    with pytest.raises(ValueError):
        cuda_hist.level_histogram(t(binned), t(gh), t(pos), 2, 8, "fp16")


@pytest.mark.parametrize("N,F,B,M", [(1_000_000, 28, 64, 1),
                                     (1_000_000, 28, 64, 32),
                                     (1_000_000, 28, 256, 64),
                                     (1_000_000, 28, 64, 128),
                                     (10, 3, 7, 3)])
@pytest.mark.parametrize("n_sm", [132, 114])     # H100 SXM, H100 PCIe
def test_tiling_covers_rows_and_fits_shared_memory(N, F, B, M, n_sm):
    """K4's plan (bins of each lane's own) for one lane at K1's shapes:
    every row in one step of one copy, histogram and pair list within a
    block's shared memory, one wave of blocks, and the store flush
    exactly where each unit has one copy."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    p = kb.scatter_plan(N, F, B, 1, M, n_sm, shared_bins=False)
    rows = np.zeros(N, dtype=np.int64)
    for c in range(p.copies):
        rb, re = c * p.rows_per_copy, min(N, (c + 1) * p.rows_per_copy)
        for r0 in range(rb, re, p.rows_per_step):
            rows[r0:min(re, r0 + p.rows_per_step)] += 1
    assert (rows == 1).all()
    assert p.smem <= kb.SMEM_MAX and p.grid == p.n_groups * p.copies
    assert p.grid <= min(kb.SMEM_SM // (p.smem + kb.SMEM_RESERVED),
                         2048 // kb.THREADS) * n_sm
    assert p.store == (p.copies == 1)
    if p.store:                  # each unit flushed by one block only
        assert p.n_groups <= p.n_units


def test_node_totals_from_histogram():
    """Node (G, H) totals from either layout, and node_stats, equal the
    JAX package's on dyadic gradients (sums exact in any order)."""
    from xgboost_tpu.ops import histogram as jhist
    N, F, B, M = 800, 4, 16, 8
    binned, gh, pos = _case(N, F, B, M, seed=17)
    want = np.asarray(jhist.node_stats(jnp.asarray(gh), jnp.asarray(pos), M))
    native = torch.from_numpy(_plain(binned, gh, pos, M, B, "fp32"))
    np.testing.assert_array_equal(
        thist.stats_from_histogram_native(native).numpy(), want)
    np.testing.assert_array_equal(
        thist.stats_from_histogram(native.permute(3, 0, 1, 2)).numpy(), want)
    np.testing.assert_array_equal(
        thist.node_stats(torch.from_numpy(gh), torch.from_numpy(pos),
                         M).numpy(), want)
    np.testing.assert_array_equal(
        thist.node_stats(torch.from_numpy(gh), torch.from_numpy(pos), M,
                         "fixed").numpy(),
        np.asarray(jhist.dequantize_hist(jhist.node_stats(
            jnp.asarray(gh), jnp.asarray(pos), M, "fixed"))))


def test_int8_dequantization_matches_pallas_over_scales():
    """The int8 step is ``scale * f32(1/127)``, as XLA compiles the JAX
    package's ``scale / 127.0``: bitwise over many scales (a true
    division differs in the last bit for some of them)."""
    N, F, B, M = 300, 3, 16, 4
    for seed in range(12):
        rng = np.random.RandomState(seed)
        binned = rng.randint(0, B, (N, F)).astype(np.uint8)
        gh = (rng.randn(N, 2) * rng.rand(2) * 5).astype(np.float32)
        pos = rng.randint(0, M, N).astype(np.int32)
        want = np.asarray(ph.build_level_histogram_pallas(
            jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
            precision="int8", interpret=True))
        got = thist.build_level_histogram(
            torch.from_numpy(binned), thist.prepare_hist(
                torch.from_numpy(gh), "int8"), torch.from_numpy(pos), M, B)
        np.testing.assert_array_equal(_standard(got.numpy()), want)


@pytest.mark.parametrize("B", [1, 17, 32, 33, 34, 64, 65, 100, 129, 258])
def test_node_totals_bitwise_in_xla_cpu_order(B):
    """On random (not dyadic) cells of every width, the port's node
    totals on the CPU equal the JAX package's bit for bit: both sum the
    bins in XLA's CPU order (``ops/histogram.bin_sum``).  A sum in
    torch's own order flipped a near-tie split at depth 8
    (``tests/test_torch_cli.py::test_depth8_continuation_from_a_shared_model_file``)."""
    from xgboost_tpu.ops import histogram as jhist
    rng = np.random.RandomState(B)
    native = (rng.randn(3, B, 2, 5)
              * np.exp(3 * rng.randn(3, B, 2, 5))).astype(np.float32)
    want = np.asarray(jhist.stats_from_histogram_native(jnp.asarray(native)))
    got = thist.stats_from_histogram_native(torch.from_numpy(native))
    np.testing.assert_array_equal(got.numpy(), want)
    std = np.ascontiguousarray(native.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(
        thist.stats_from_histogram(torch.from_numpy(std)).numpy(),
        np.asarray(jhist.stats_from_histogram(jnp.asarray(std))))
