"""Kernels K3 (tree-batched histogram) and K2 (node statistics) of the
PyTorch port, held against the JAX package.

The port's plain versions (what a CPU tensor runs) against the JAX
package's Pallas kernels in interpret mode and its scatter, on the same
numpy inputs.  Tolerances and why:

- K3 fp32 on dyadic gradients (multiples of 1/256, small): bitwise, f32
  sums of them are exact in any order; K3 int8 with per-tree scales:
  bitwise on any gradients (integer sums, the same quantization);
- K3 against T solo K1 calls, and the split search over a batched
  level against T solo searches: bitwise, the same additions in the
  same order;
- K2 on dyadic gradients: bitwise; on random gradients bitwise against
  the JAX scatter (both add a node's rows in row order on the CPU) and
  within 2 n 2^-24 sum|x| per node against the Pallas kernel, which
  sums each 2048-row tile in a dot of its own order (each order is
  within n 2^-24 sum|x| of the exact sum).

Interpret-mode cases are few: each costs seconds on the CPU.  The CUDA
kernels themselves run only on a GPU (``tests/test_torch_cuda.py``;
``chip_smoke.py`` holds them against the plain versions at full size).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xgboost_tpu.ops import histogram as jhist  # noqa: E402
from xgboost_tpu.ops import pallas_hist as ph  # noqa: E402
from xgboost_tpu.ops.split import find_best_splits  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist  # noqa: E402
from xgboost_tpu_torch.ops import cuda_hist_batched as kb  # noqa: E402
from xgboost_tpu_torch.ops import cuda_node_stats as kn  # noqa: E402
from xgboost_tpu_torch.ops import histogram as thist  # noqa: E402
from xgboost_tpu_torch.ops.split import (SplitConfig,  # noqa: E402
                                         find_best_splits_native)


def _case(T, N, F, B, M, seed=11, dyadic=True):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    if dyadic:
        gh = (rng.randint(-512, 512, (T, N, 2)) / 256.0).astype(np.float32)
    else:
        gh = (rng.randn(T, N, 2) * [0.8, 0.3]).astype(np.float32)
    pos = rng.randint(0, M, (T, N)).astype(np.int32)
    pos[rng.rand(T, N) < 0.2] = -1
    return binned, gh, pos


def _per_tree(native, T, M):
    """(F, B, 2, T*M) -> the JAX batched kernel's (T, M, F, B, 2)."""
    F, B = native.shape[:2]
    return np.transpose(native.reshape(F, B, 2, T, M), (3, 4, 0, 1, 2))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T,N,F,B,M", [
    (3, 500, 5, 16, 8),
    (6, 257, 4, 67, 64),    # bench-like bins, node-tiled level
    (2, 64, 3, 8, 1),       # root level
    (9, 300, 93, 64, 4),    # otto: 9 classes, feature-tiled
])
def test_plain_fp32_matches_pallas_batched(T, N, F, B, M):
    binned, gh, pos = _case(T, N, F, B, M)
    want = np.asarray(ph.build_level_histogram_pallas_batched(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
        precision="fp32", interpret=True))
    got = kb.level_histogram_batched(*_t(binned, gh, pos), M, B, "fp32")
    assert got.shape == (F, B, 2, T * M)
    np.testing.assert_array_equal(_per_tree(got.numpy(), T, M), want)


@pytest.mark.parametrize("T,N,F,B,M", [(4, 700, 5, 32, 16),
                                       (9, 300, 93, 64, 2)])
def test_int8_per_tree_scales_match_pallas_batched(T, N, F, B, M):
    """Random gradients, int8: quantize per tree -> int32 sums ->
    dequantize with each tree's scale, bit for bit."""
    binned, gh, pos = _case(T, N, F, B, M, seed=3, dyadic=False)
    gh[1] *= 7.0                           # trees of different scales
    want = np.asarray(ph.build_level_histogram_pallas_batched(
        jnp.asarray(binned), jnp.asarray(gh), jnp.asarray(pos), M, B,
        precision="int8", interpret=True))
    prep = thist.prepare_hist(torch.from_numpy(gh), "int8")
    assert prep.mode == "int8" and prep.scale.shape == (T, 2)
    got = thist.build_level_histogram_batched(*_t(binned), prep,
                                              torch.from_numpy(pos), M, B)
    np.testing.assert_array_equal(_per_tree(got.numpy(), T, M), want)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "fixed"])
def test_batched_level_equals_solo_levels(mode):
    """K3 (plain) through the dispatch == T solo K1 (plain) levels,
    bitwise, on random gradients, in every precision."""
    T, N, F, B, M = 5, 900, 6, 24, 8
    binned, gh, pos = _case(T, N, F, B, M, seed=21, dyadic=False)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    batched = thist.build_level_histogram_batched(
        b_t, thist.prepare_hist(gh_t, mode), pos_t, M, B)
    for t in range(T):
        solo = thist.build_level_histogram(
            b_t, thist.prepare_hist(gh_t[t], mode), pos_t[t], M, B)
        assert torch.equal(batched[..., t * M:(t + 1) * M], solo), t
    raw = kb.level_histogram_batched_plain(
        b_t, thist.prepare_hist(gh_t, "int8").gh_in, pos_t, M, B, "int")
    for t in range(T):
        q = thist.prepare_hist(gh_t[t], "int8").gh_in
        assert torch.equal(raw[..., t * M:(t + 1) * M],
                           cuda_hist.level_histogram_plain(
                               b_t, q, pos_t[t], M, B, "int"))


def test_batched_split_search_equals_solo_searches():
    """The finder over a batched level's T * n_node columns equals T
    solo searches bitwise: the prefix sum runs along the bins only."""
    T, N, F, B, M = 4, 1500, 6, 40, 8
    binned, gh, pos = _case(T, N, F, B, M, seed=23, dyadic=False)
    gh[..., 1] = np.abs(gh[..., 1]) + 0.05
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    n_cuts = torch.from_numpy(
        np.random.RandomState(1).randint(3, B - 2, F).astype(np.int32))
    cfg = SplitConfig(min_child_weight=0.5)
    hist = thist.build_level_histogram_batched(
        b_t, thist.prepare_hist(gh_t, "fp32"), pos_t, M, B)
    nst = thist.stats_from_histogram_native(hist)
    batched = find_best_splits_native(hist, nst, n_cuts, cfg)
    assert bool(batched.valid.any())
    for t in range(T):
        h_t = hist[..., t * M:(t + 1) * M].contiguous()
        solo = find_best_splits_native(
            h_t, thist.stats_from_histogram_native(h_t), n_cuts, cfg)
        for name, a, b in zip(solo._fields, batched, solo):
            a = a[t * M:(t + 1) * M]
            assert torch.equal(a, b), (t, name)
            if a.dtype.is_floating_point:
                assert torch.equal(torch.signbit(a), torch.signbit(b))
    # and the JAX finder agrees on the winners, tree by tree
    from xgboost_tpu.ops.split import SplitConfig as JCfg
    for t in range(T):
        h_t = hist[..., t * M:(t + 1) * M]
        std = jnp.asarray(h_t.permute(3, 0, 1, 2).numpy())
        j = find_best_splits(std, jnp.asarray(
            nst[t * M:(t + 1) * M].numpy()), jnp.asarray(n_cuts.numpy()),
            JCfg(min_child_weight=0.5))
        np.testing.assert_array_equal(
            np.asarray(j.feature), batched.feature[t * M:(t + 1) * M])
        np.testing.assert_array_equal(
            np.asarray(j.cut_index), batched.cut_index[t * M:(t + 1) * M])


def test_plain_batched_equals_plain_k1_per_tree():
    T, N, F, B, M = 7, 2000, 4, 32, 16
    binned, gh, pos = _case(T, N, F, B, M, seed=29, dyadic=False)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    got = kb.level_histogram_batched_plain(b_t, gh_t, pos_t, M, B, "fp32")
    for t in range(T):
        assert torch.equal(got[..., t * M:(t + 1) * M],
                           cuda_hist.level_histogram_plain(
                               b_t, gh_t[t], pos_t[t], M, B, "fp32"))


@pytest.mark.parametrize("N,F,B,T,M,max_blocks", [
    (10**6, 28, 64, 1, 1, None),        # Higgs (K1), root
    (10**6, 28, 64, 1, 32, None),       # Higgs, depth 5
    (200_000, 28, 64, 6, 1, None),      # multiclass (K3), root
    (200_000, 28, 64, 6, 32, None),     # multiclass, depth 5
    (200_000, 28, 64, 6, 32, 64),       # fewer blocks resident
    (200_000, 93, 64, 9, 32, None),     # otto
    (12_288, 28, 64, 1, 8, None),       # a lanes tenant (K1)
    (200_000, 28, 64, 24, 16, None),    # a wide forest
    (200_000, 28, 256, 6, 64, None),    # B = 256
    (10**6, 28, 64, 1, 128, None),      # 128 nodes
    (10, 3, 7, 3, 3, None),             # N = 10
])
@pytest.mark.parametrize("n_sm", [132, 114])     # H100 SXM, H100 PCIe
def test_scatter_plan_covers_and_fits_shared_memory(N, F, B, T, M,
                                                    max_blocks, n_sm):
    """K1's and K3's launch plan: every (feature, tree, node) cell in one
    unit, every unit walked by one group of blocks, every row in one step
    of one copy, histogram and staging within a block's shared memory,
    and one wave of blocks on a card of ``n_sm`` SMs."""
    p = kb.scatter_plan(N, F, B, T, M, n_sm, kb.SMEM_SM, max_blocks)
    n_t, n_m = -(-T // p.t_tile), -(-M // p.m_tile)
    assert p.n_units == -(-F // p.f_tile) * n_t * n_m
    owner = np.zeros((F, T, M), dtype=np.int64)
    for u in range(p.n_units):              # the kernel's unit order
        mi, ti, fi = u % n_m, (u // n_m) % n_t, u // (n_m * n_t)
        owner[fi * p.f_tile:(fi + 1) * p.f_tile,
              ti * p.t_tile:(ti + 1) * p.t_tile,
              mi * p.m_tile:(mi + 1) * p.m_tile] += 1
    assert (owner == 1).all()
    walked = sorted(u for g in range(p.n_groups)
                    for u in range(g, p.n_units, p.n_groups))
    assert walked == list(range(p.n_units))
    rows = np.zeros(N, dtype=np.int64)
    for c in range(p.copies):
        rb, re = c * p.rows_per_copy, min(N, (c + 1) * p.rows_per_copy)
        for r0 in range(rb, re, p.rows_per_step):
            rows[r0:min(re, r0 + p.rows_per_step)] += 1
    assert (rows == 1).all()
    assert p.rows_per_copy % 16 == 0 and p.rows_per_step % 16 == 0
    assert p.rows_per_step <= 65_536          # a list entry holds the row
    assert p.bin_pitch % 2 == 1 and p.bin_pitch >= B
    assert p.hist_bytes >= 8 * p.f_tile * p.t_tile * p.m_tile * p.bin_pitch
    assert p.smem == kb.smem_bytes(p.hist_bytes, p.t_tile,
                                   p.rows_per_step) <= 232_448
    assert p.grid == p.n_groups * p.copies
    assert p == kb.tile_plan(N, F, B, T, M, p.f_tile, p.t_tile, p.m_tile,
                             n_sm, kb.SMEM_SM, max_blocks)
    resident = min(kb.SMEM_SM // (p.smem + kb.SMEM_RESERVED),
                   2048 // kb.THREADS) * n_sm
    assert p.grid <= min(resident, max_blocks or resident)
    if (N, T, M) == (200_000, 6, 32):
        assert p.f_tile > 1      # pos and gh not re-read for every feature


def test_scatter_split_passages_are_in_the_header():
    """``tools/hist_scatter_split`` builds the scatter kernel with
    passages of ``csrc/hist_scatter.cuh`` replaced, on the card only:
    each variant's passages are found exactly once in the header as it
    stands, every variant but ``full`` changes it, and its braces still
    pair; the cluster variants launch clusters and cut the plan's copies
    to a multiple of their cluster size; ``store-off`` is ``full``'s
    build with the atomic flush in the plan; every path names a
    library and its wrapper."""
    from xgboost_tpu_torch.ops import nvcc
    from xgboost_tpu_torch.tools import hist_scatter_split as split
    src = (nvcc.CSRC / split.SCATTER_HEADER).read_text()
    for name, files in split.SCATTER_VARIANTS.items():
        assert set(files) <= {split.SCATTER_HEADER}
        out = split.variant_text(src, files.get(split.SCATTER_HEADER, []),
                                 split.SCATTER_HEADER)
        assert (out == src) == (name == "full"), name
        assert out.count("{") - out.count("}") == 0
        assert ("map_shared_rank" in out) == (name in split.CLUSTERS)
    p = kb.scatter_plan(200_000, 28, 64, 6, 1)
    for name, c in split.CLUSTERS.items():
        q = split._cluster_plan(c)(p, 200_000)
        assert q.copies % c == 0 and q.grid == q.n_groups * q.copies
        assert q.copies * q.rows_per_copy >= 200_000
    deep = kb.scatter_plan(16384, 28, 64, 64, 32, shared_bins=False)
    assert deep.store and not split._store_off(deep, 16384).store
    assert set(split.PLAN_VARIANTS.values()) <= set(split.SCATTER_VARIANTS)
    for target, paths in split.PATHS.items():
        for path in paths:
            src = split.SOURCE[path]
            assert src in split.PARENT_FILES and src in split.PLAIN
            mod, entry = split.ENTRY[src]
            assert (nvcc.CSRC / f"{src}.cu").exists()
            assert callable(getattr(getattr(split.ops_pkg, mod), entry))


@pytest.mark.parametrize("every", [False, True])
def test_scatter_split_tilings_enumerate_launchable_plans(every,
                                                          monkeypatch):
    """``hist_scatter_split tilings`` / ``plans`` at K4's 32-node level,
    with the card's occupancy query replaced by the formula the plan
    uses: the plan first, no plan twice, every one within a block's
    shared memory and one wave, ``plans`` over t_tile <= 4 and steps of
    2,048-16,384 pairs, each at its own cost."""
    from xgboost_tpu_torch.tools import hist_scatter_split as split

    class Card:
        multi_processor_count = 132

    def resident(name, mode, smem, dev):
        return min(kb.SMEM_SM // (smem + kb.SMEM_RESERVED), 2) * 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a, **k: Card())
    monkeypatch.setattr(split, "_resident", resident)
    monkeypatch.setattr(kb, "launch_plan", lambda name, N, F, nb, T, m,
                        mode, dev: kb.scatter_plan(N, F, nb, T, m,
                                                   shared_bins=False))
    N, F, B, L, M = 16384, 28, 64, 64, 32
    level = (torch.zeros((L, N, F), dtype=torch.uint8),
             torch.zeros((L, N, 2), dtype=torch.int32),
             torch.zeros((L, N), dtype=torch.int32), M, B, "int")
    plans = split.neighbour_tilings("hist_lanes", level, None, every)
    assert plans[0] == kb.scatter_plan(N, F, B, L, M, shared_bins=False)
    assert len(set(plans)) == len(plans) > (100 if every else 2)
    for p in plans:
        assert p.smem == kb.smem_bytes(p.hist_bytes, p.t_tile,
                                       p.rows_per_step) <= kb.SMEM_MAX
        assert p.grid <= resident("", "", p.smem, None)
        assert p.cost == kb.plan_cost(p, N, F, L, 132, shared_bins=False)
    if every:
        assert max(p.t_tile for p in plans) <= 4
        assert {p.rows_per_step for p in plans if p.t_tile == 1} \
            >= {2048, 4096, 8192, 16384}


@pytest.mark.parametrize("N,T,M", [(200_000, 6, 1), (200_000, 1, 1),
                                   (50_000, 6, 8), (50_000, 2, 20),
                                   (1_000_003, 3, 64), (7, 6, 1), (0, 2, 3)])
def test_k2_row_split_depends_on_the_shapes_only(N, T, M, monkeypatch):
    """K2's launch (``node_stats_plan``): every row of every tree summed
    by exactly one block of its tree's cluster, the blocks in rank order
    over the rows, every node in one tile; the same split on a card of
    132 SMs and of 114 (it reads nothing of the card, so two cards add in
    the same order)."""
    class Card:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a, **k: Card())
    p = kn.node_stats_plan(N, T, M)
    Card.multi_processor_count = 114
    assert kn.node_stats_plan(N, T, M) == p
    assert p.cluster == kn.CLUSTER and p.grid == (p.cluster, T,
                                                  -(-M // p.node_tile))
    assert (p.node_tile, p.threads) in ((1, 1024), (32, 512))
    assert p.node_tile >= min(M, 32) and (p.node_tile == 1) == (M == 1)
    rows = np.zeros(N, dtype=np.int64)
    for rank in range(p.cluster):
        lo = rank * p.rows_per_block
        rows[lo:min(N, lo + p.rows_per_block)] += 1
    assert (rows == 1).all()
    nodes = np.zeros(M, dtype=np.int64)
    for tile in range(p.grid[2]):
        nodes[tile * p.node_tile:(tile + 1) * p.node_tile] += 1
    assert (nodes == 1).all()


def test_batched_wrapper_checks_inputs():
    binned, gh, pos = _case(2, 10, 2, 8, 2)
    b_t, gh_t, pos_t = _t(binned, gh, pos)
    with pytest.raises(TypeError):
        kb.level_histogram_batched(b_t, gh_t, pos_t, 2, 8, "int")
    with pytest.raises(ValueError):
        kb.level_histogram_batched(b_t, gh_t[0], pos_t, 2, 8, "fp32")
    with pytest.raises(ValueError):
        kb.level_histogram_batched(b_t, gh_t, pos_t[:, :5], 2, 8, "fp32")
    with pytest.raises(TypeError):
        kn.node_stats(gh_t, pos_t.to(torch.int64), 2)


# ------------------------------------------------------------------- K2

@pytest.fixture(scope="module")
def nst_case():
    """Random and dyadic (T, N, 2) gradients, (T, N) pos, and the JAX
    package's answers (Pallas interpret and scatter, vmapped)."""
    T, N, M = 3, 5000, 5
    out = {}
    for dyadic in (True, False):
        _, gh, pos = _case(T, N, 1, 2, M, seed=31, dyadic=dyadic)
        pallas = np.asarray(jax.vmap(lambda g, p: ph.node_stats_pallas(
            g, p, M, interpret=True))(jnp.asarray(gh), jnp.asarray(pos)))
        scatter = np.asarray(jax.vmap(lambda g, p: jhist.node_stats(
            g, p, M))(jnp.asarray(gh), jnp.asarray(pos)))
        out[dyadic] = (gh, pos, pallas, scatter)
    return M, out


def test_plain_k2_dyadic_bitwise(nst_case):
    M, cases = nst_case
    gh, pos, pallas, scatter = cases[True]
    got = kn.node_stats(*_t(gh, pos), M).numpy()
    assert got.shape == (gh.shape[0], M, 2)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scatter)
    # without a tree axis, through the dispatch
    solo = thist.node_stats(*_t(gh[1], pos[1]), M).numpy()
    np.testing.assert_array_equal(solo, scatter[1])


def test_plain_k2_random_within_reassociation_bound(nst_case):
    M, cases = nst_case
    gh, pos, pallas, scatter = cases[False]
    got = kn.node_stats(*_t(gh, pos), M).numpy()
    np.testing.assert_array_equal(got, scatter)
    n = kn.node_stats(*_t(np.ones_like(gh), pos), M).numpy()
    a = kn.node_stats(*_t(np.abs(gh), pos), M).numpy()
    bound = 2.0 * n * 2.0 ** -24 * a
    assert (np.abs(got - pallas) <= bound).all()
    for t in range(gh.shape[0]):
        solo = thist.node_stats(*_t(gh[t], pos[t]), M).numpy()
        np.testing.assert_array_equal(solo, got[t])


def test_k2_fixed_precision_with_a_tree_axis():
    T, N, M = 4, 3000, 8
    _, gh, pos = _case(T, N, 1, 2, M, seed=37, dyadic=False)
    want = np.asarray(jax.vmap(lambda g, p: jhist.dequantize_hist(
        jhist.node_stats(g, p, M, "fixed")))(jnp.asarray(gh),
                                             jnp.asarray(pos)))
    got = thist.node_stats(*_t(gh, pos), M, "fixed")
    np.testing.assert_array_equal(got.numpy(), want)
    pos[:] = -1
    assert not thist.node_stats(*_t(gh, pos), M).numpy().any()
