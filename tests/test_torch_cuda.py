"""The port's CUDA kernels (K1, K3, K2, K4; the one-hot kernels T5, T3,
T2, T7, T1, T4a, T4b, T6) against their plain PyTorch versions, on a GPU,
and every one-hot library holding wgmma instructions.  Marked ``cuda``:
without an NVIDIA GPU (and nvcc) they skip.  No JAX here, so they also
run where only torch is installed (the repo's conftest imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xgboost_tpu_torch.ops import cuda_hist  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _plant(rng, bins, B, share):
    """Set ``share`` of the bins to values in [B, 256): binning never
    makes them, the kernels and their plain versions skip them."""
    if share and B < 256:
        hit = rng.rand(*bins.shape) < share
        bins[hit] = rng.randint(B, 256, int(hit.sum()))
    return bins


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int", "fp32", "bf16"])
@pytest.mark.parametrize("N,F,B,M,inactive,oob", [
    (20000, 6, 64, 16, 0.2, 0.0),
    (1, 28, 64, 1, 0.0, 0.0),         # one row
    (3, 28, 64, 2, 0.2, 0.0),
    (12373, 28, 64, 32, 0.2, 0.02),   # odd rows, 2% of bins >= B
    (5000, 93, 64, 8, 0.2, 0.0),      # otto's width
    (3000, 5, 1, 4, 0.2, 0.02),       # B = 1
    (4000, 4, 256, 64, 0.2, 0.0),     # B = 256
    (3000, 6, 64, 128, 0.2, 0.0),     # 128 nodes: node tiles
    (2000, 6, 64, 8, 1.0, 0.0),       # every row inactive
])
def test_hist_level_kernel_matches_plain(cuda_device, mode, N, F, B, M,
                                         inactive, oob):
    """Bitwise: int sums are exact, and fp32 / bf16 sums of dyadic
    gradients (multiples of 1/256) are exact in any order."""
    rng = np.random.RandomState(2)
    bins = _plant(rng, rng.randint(0, B, (N, F)).astype(np.uint8), B, oob)
    gh = (rng.randint(-512, 512, (N, 2)) / 256.0).astype(np.float32)
    pos = rng.randint(0, M, N).astype(np.int32)
    pos[rng.rand(N) < inactive] = -1
    gh_t = torch.from_numpy(gh)
    if mode == "int":
        gh_t = cuda_hist.quantize_gh(gh_t)[0]
    args = [t.to(cuda_device) for t in (torch.from_numpy(bins), gh_t,
                                        torch.from_numpy(pos))]
    before = cuda_hist.launches
    got = cuda_hist.level_histogram(*args, M, B, mode)
    want = cuda_hist.level_histogram_plain(*args, M, B, mode)
    torch.cuda.synchronize()
    assert cuda_hist.launches == before + 1
    assert torch.equal(got, want)


def _batched_case(dev, T, N, F, B, M, seed, dyadic=True, inactive=0.2,
                  oob=0.0):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(_plant(rng, rng.randint(0, B, (N, F)).astype(
        np.uint8), B, oob))
    if dyadic:
        gh = (rng.randint(-512, 512, (T, N, 2)) / 256.0).astype(np.float32)
    else:
        gh = rng.randn(T, N, 2).astype(np.float32)
    pos = rng.randint(0, M, (T, N)).astype(np.int32)
    pos[rng.rand(T, N) < inactive] = -1
    return (bins.to(dev), torch.from_numpy(gh).to(dev),
            torch.from_numpy(pos).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int", "fp32", "bf16"])
@pytest.mark.parametrize("T,N,F,B,M,inactive,oob", [
    (6, 20000, 28, 64, 32, 0.2, 0.0),     # multiclass, depth 5
    (9, 5000, 93, 64, 4, 0.2, 0.0),       # otto: many feature tiles
    (24, 3000, 5, 16, 8, 0.2, 0.0),       # wide forest: tree tiles
    (3, 4000, 4, 256, 64, 0.2, 0.0),      # B = 256: node tiles
    (6, 1, 28, 64, 1, 0.0, 0.0),          # one row
    (6, 3, 28, 64, 2, 0.2, 0.0),
    (6, 12373, 28, 64, 32, 0.2, 0.02),    # odd rows, 2% of bins >= B
    (9, 3000, 93, 64, 32, 0.2, 0.0),      # otto at 32 nodes
    (24, 2000, 28, 64, 16, 0.2, 0.0),
    (3, 2000, 5, 1, 4, 0.2, 0.02),        # B = 1
    (2, 2000, 6, 64, 128, 0.2, 0.0),      # 128 nodes
    (6, 2000, 6, 64, 8, 1.0, 0.0),        # every row inactive
])
def test_hist_batched_kernel_matches_plain(cuda_device, mode, T, N, F, B,
                                           M, inactive, oob):
    """K3 against its plain version, bitwise: int sums are exact, fp32
    and bf16 sums of dyadic gradients are exact in any order."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    bins, gh, pos = _batched_case(cuda_device, T, N, F, B, M, seed=T + M,
                                  inactive=inactive, oob=oob)
    if mode == "int":
        gh = cuda_hist.quantize_gh(gh)[0]
    before = kb.launches
    got = kb.level_histogram_batched(bins, gh, pos, M, B, mode)
    want = kb.level_histogram_batched_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    assert kb.launches == before + 1
    assert got.shape == (F, B, 2, T * M)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_hist_level_from_threads_at_mixed_levels(cuda_device):
    """K1 launched from four threads at once, each at its own level and
    so with its own shared memory, as the lanes' host loop launches it:
    every launch succeeds and equals the plain version (int mode)."""
    import threading
    N, F, B = 12288, 28, 64
    cases = []
    for i, M in enumerate((1, 8, 32, 128)):
        rng = np.random.RandomState(40 + i)
        bins = rng.randint(0, B, (N, F)).astype(np.uint8)
        gh = (rng.randint(-512, 512, (N, 2)) / 256.0).astype(np.float32)
        pos = rng.randint(0, M, N).astype(np.int32)
        args = [t.to(cuda_device) for t in (
            torch.from_numpy(bins),
            cuda_hist.quantize_gh(torch.from_numpy(gh))[0],
            torch.from_numpy(pos))]
        cases.append((args, M,
                      cuda_hist.level_histogram_plain(*args, M, B, "int")))
    torch.cuda.synchronize()
    errors = []
    start = threading.Barrier(len(cases))

    def run(args, M, want):
        try:
            start.wait()
            for _ in range(50):
                got = cuda_hist.level_histogram(*args, M, B, "int")
                torch.cuda.current_stream().synchronize()
                if not torch.equal(got, want):
                    errors.append(f"n_node={M}: != plain")
                    return
        except Exception as e:   # a failed launch raises RuntimeError
            errors.append(f"n_node={M}: {e!r}")

    threads = [threading.Thread(target=run, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


@pytest.mark.cuda
def test_hist_batched_tree_slices_match_solo_k1(cuda_device):
    """Each tree's slice of one K3 launch is a solo K1 launch on that
    tree's gh and pos, bitwise (int mode)."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    T, M, B = 6, 16, 64
    bins, gh, pos = _batched_case(cuda_device, T, 30000, 28, B, M, seed=5,
                                  dyadic=False)
    gh_q = cuda_hist.quantize_gh(gh)[0]
    got = kb.level_histogram_batched(bins, gh_q, pos, M, B, "int")
    for t in range(T):
        solo = cuda_hist.level_histogram(bins, gh_q[t].contiguous(),
                                         pos[t].contiguous(), M, B, "int")
        assert torch.equal(got[..., t * M:(t + 1) * M], solo)


@pytest.mark.cuda
@pytest.mark.parametrize("T,M", [(1, 1), (6, 1), (1, 8), (6, 8), (1, 20),
                                 (6, 20), (2, 64)])
def test_node_stats_kernel_matches_plain(cuda_device, T, M):
    """K2 against its plain version: bitwise on dyadic gradients (exact
    in any order); on random ones within 2 n 2^-24 sum|x| per node (each
    order is within n 2^-24 sum|x| of the exact sum); and the same bits
    on a second launch (fixed summation order)."""
    from xgboost_tpu_torch.ops import cuda_node_stats as kn
    N = 50000
    _, gh, pos = _batched_case(cuda_device, T, N, 1, 2, M, seed=M + T)
    before = kn.launches
    got = kn.node_stats(gh, pos, M)
    torch.cuda.synchronize()
    assert kn.launches == before + 1
    assert got.shape == (T, M, 2)
    assert torch.equal(got, kn.node_stats_plain(gh, pos, M))
    _, gh, pos = _batched_case(cuda_device, T, N, 1, 2, M, seed=M + T,
                               dyadic=False)
    got = kn.node_stats(gh, pos, M)
    want = kn.node_stats_plain(gh, pos, M)
    n = kn.node_stats_plain(torch.ones_like(gh), pos, M)
    a = kn.node_stats_plain(gh.abs(), pos, M)
    assert bool(((got - want).abs() <= 2.0 * n * 2.0 ** -24 * a).all())
    assert torch.equal(kn.node_stats(gh, pos, M), got)


@pytest.mark.cuda
@pytest.mark.parametrize("T,M", [(1, 1), (6, 1), (6, 8), (6, 20)])
def test_node_stats_is_one_kernel_a_call(cuda_device, T, M):
    """One K2 call issues one GPU activity, its kernel: no memset, no
    second pass (``torch.profiler``'s CUDA activities of 5 calls between
    two marker kernels, after 5 calls while the trace starts: the
    profiler can drop activities at a trace's edges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgboost_tpu_torch.ops import cuda_node_stats as kn
    _, gh, pos = _batched_case(cuda_device, T, 200_000, 1, 2, M, seed=7)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kn.node_stats(gh, pos, M)
            torch.cuda._sleep(100)
            for _ in range(5):
                kn.node_stats(gh, pos, M)
            for _ in range(4):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        acts = sorted((e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA),
                      key=lambda e: e.start_ns())
        marks = [i for i, e in enumerate(acts) if "spin_kernel" in e.name()]
        names = [e.name() for e in acts[marks[0] + 1:marks[1]]] \
            if len(marks) >= 2 else []
        if sum("node_stats" in n for n in names) == 5:
            break
    assert len(names) == 5 and all("node_stats" in n for n in names), names


def _lanes_case(dev, L, N, F, B, M, seed, dyadic=True, n_real=None,
                oob=0.0):
    """L lanes of N rows each (own bins, ``oob`` of them planted at B or
    above); lane l keeps ``n_real[l]`` real rows, the rest are pad rows
    (pos -1, gh 0)."""
    rng = np.random.RandomState(seed)
    bins = _plant(rng, rng.randint(0, B, (L, N, F)).astype(np.uint8), B, oob)
    if dyadic:
        gh = (rng.randint(-512, 512, (L, N, 2)) / 256.0).astype(np.float32)
    else:
        gh = rng.randn(L, N, 2).astype(np.float32)
    pos = rng.randint(0, M, (L, N)).astype(np.int32)
    pos[rng.rand(L, N) < 0.2] = -1
    for lane, n in enumerate(n_real or []):
        pos[lane, n:] = -1
        gh[lane, n:] = 0.0
    return (torch.from_numpy(bins).to(dev), torch.from_numpy(gh).to(dev),
            torch.from_numpy(pos).to(dev))


# (L, N, F, B, M, share of bins planted at B or above) of K4: the lanes'
# stack at the root (the atomic flush) and at 16 and 32 nodes (the store
# flush), one lane, three, B = 7 and 256, 128 nodes, odd row counts
LANES_CASES = [
    (64, 16384, 28, 64, 32, 0.0),    # tenant lanes, depth 5: store flush
    (64, 16384, 28, 64, 1, 0.02),    # the root: atomic flush
    (64, 16384, 28, 64, 16, 0.0),
    (8, 16384, 28, 64, 32, 0.0),
    (3, 5000, 93, 64, 4, 0.0),       # many feature tiles
    (3, 3001, 6, 7, 128, 0.02),      # B = 7, 128 nodes
    (64, 2048, 28, 256, 128, 0.0),   # B = 256, node tiles
    (1, 20000, 5, 16, 1, 0.02),      # one lane, root level
    (1, 12373, 28, 64, 128, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int", "fp32", "bf16"])
@pytest.mark.parametrize("L,N,F,B,M,oob", LANES_CASES)
def test_hist_lanes_kernel_matches_plain(cuda_device, mode, L, N, F, B, M,
                                         oob):
    """K4 against its plain version, bitwise: int sums are exact, fp32
    and bf16 sums of dyadic gradients are exact in any order; in int
    mode each lane's slice is also a solo K1 launch on its rows."""
    from xgboost_tpu_torch.ops import cuda_hist_lanes as k4
    bins, gh, pos = _lanes_case(cuda_device, L, N, F, B, M, seed=L + M,
                                oob=oob)
    if mode == "int":
        gh = cuda_hist.quantize_gh(gh)[0]
    before = k4.launches
    got = k4.level_histogram_lanes(bins, gh, pos, M, B, mode)
    want = k4.level_histogram_lanes_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    assert got.shape == (F, B, 2, L * M)
    assert torch.equal(got, want)
    for lane in range(L if mode == "int" else 0):
        solo = cuda_hist.level_histogram(bins[lane], gh[lane], pos[lane],
                                         M, B, "int")
        assert torch.equal(got[..., lane * M:(lane + 1) * M], solo), lane


@pytest.mark.cuda
@pytest.mark.parametrize("L,M,store", [(4, 16, False), (64, 1, False),
                                       (64, 32, True), (64, 128, True)])
def test_hist_lanes_slices_match_solo_k1_with_padding(cuda_device, L, M,
                                                      store):
    """Each lane's slice of one K4 launch is a solo K1 launch on that
    lane's unpadded rows, bitwise (int mode); a pad lane's is zero; under
    the flush the plan names (the store flush at the lanes' deep levels,
    atomics where units have several copies)."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    from xgboost_tpu_torch.ops import cuda_hist_lanes as k4
    N, F, B = 16384, 28, 64
    n_real = [16384, 12288, 9001] + [
        int(n) for n in np.random.RandomState(L).randint(12288, 16384,
                                                         L - 4)] + [0]
    bins, gh, pos = _lanes_case(cuda_device, L, N, F, B, M, seed=3,
                                dyadic=False, n_real=n_real, oob=0.02)
    assert kb.launch_plan("hist_lanes", N, F, B, L, M, "int",
                          cuda_device).store == store
    gh_q = cuda_hist.quantize_gh(gh)[0]
    got = k4.level_histogram_lanes(bins, gh_q, pos, M, B, "int")
    for lane, n in enumerate(n_real[:-1]):
        solo = cuda_hist.level_histogram(
            bins[lane, :n].contiguous(), gh_q[lane, :n].contiguous(),
            pos[lane, :n].contiguous(), M, B, "int")
        assert torch.equal(got[..., lane * M:(lane + 1) * M], solo), lane
    assert not bool(got[..., (L - 1) * M:].any())


# ---------------------------------------------------------------- one-hot
def _onehot_int_case(dev, n, F, B, M, seed, layout):
    """Bins, pos (a fifth inactive) and int32 gh beyond the int8 range
    (the kernels wrap it to int8, as the prototypes do)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n) if layout == "fr" else (n, F))
    pos = rng.randint(0, M, n).astype(np.int32)
    pos[rng.rand(n) < 0.2] = -1
    gh = rng.randint(-300, 300, (n, 2)).astype(np.int32)
    return bins, pos, gh


# (n, F, B, M, r_tile) of T3 and T2: the mains' M = 1, 4, 32 (N = 8, 8,
# 64), every N of the small-N form and M = 33 (N = 128, T7's instance),
# two node tiles (M = 100), B = 1, 8, 255 on five features, F = 3 (T2 a
# byte a load), r_tile = 1000; every row count past the last whole tile
INT_CASES = [
    (2048 * 9 + 333, 28, 64, 1, 2048), (2048 * 9 + 333, 28, 64, 4, 2048),
    (2048 * 9 + 333, 28, 64, 32, 2048), (2048 * 9 + 333, 28, 64, 2, 2048),
    (2048 * 9 + 333, 28, 64, 3, 2048), (2048 * 9 + 333, 28, 64, 5, 2048),
    (2048 * 9 + 333, 28, 64, 8, 2048), (2048 * 9 + 333, 28, 64, 16, 2048),
    (2048 * 9 + 333, 28, 64, 33, 2048), (2048 * 5 + 7, 28, 64, 100, 2048),
    (2048 * 9 + 333, 5, 1, 4, 2048), (2048 * 9 + 333, 5, 8, 16, 2048),
    (2048 * 9 + 333, 5, 255, 4, 2048), (5000, 3, 7, 3, 2048),
    (20001, 3, 64, 32, 2048), (20001, 28, 67, 8, 1000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,B,M,r_tile", INT_CASES)
@pytest.mark.parametrize("kernel", ["onehot_i8", "onehot_notrans"])
def test_onehot_int_kernels_match_plain_and_k1(cuda_device, kernel, n, F, B,
                                               M, r_tile):
    """T3 and T2 (the wgmma kernel's s8 product) bitwise against their
    plain versions on a row count that is not a multiple of r_tile (the
    tail is dropped), gh beyond int8 (wrapped) and 2% of the bins out of
    range (T3: -1, 256 and 1000 too; they add nothing to their feature);
    on whole tiles, in-range bins and int8 gh, re-laid to (F, B, 2, M),
    bitwise a K1 int launch."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    layout = "fr" if kernel == "onehot_i8" else "rf"
    bins, pos, gh = _onehot_int_case(cuda_device, n, F, B, M, n + M + B,
                                     layout)
    rng = np.random.RandomState(n + F)
    bad = rng.rand(*bins.shape) < 0.02
    planted = bins.copy()
    planted[bad] = rng.choice([-1, 256, 1000, B, 255] if layout == "fr"
                              else [B, 255], int(bad.sum()))
    dt = np.int32 if layout == "fr" else np.uint8
    bins, planted = (torch.from_numpy(b.astype(dt)).to(cuda_device)
                     for b in (bins, planted))
    pos_t = torch.from_numpy(pos[:, None]).to(cuda_device)
    gh_t = torch.from_numpy(gh).to(cuda_device)
    fn = getattr(oh, kernel)
    plain = getattr(oh, kernel + "_plain")
    before = oh.COUNTERS[kernel].launches
    got = fn(planted, pos_t, gh_t, M, B, r_tile)
    want = plain(planted, pos_t, gh_t, M, B, r_tile)
    torch.cuda.synchronize()
    assert oh.COUNTERS[kernel].launches == before + 1
    assert got.shape == (1, F * B, 2 * M) and torch.equal(got, want)
    n_whole = (n // r_tile) * r_tile
    gh8 = torch.from_numpy(np.clip(gh, -127, 127)[:n_whole]).to(cuda_device)
    rows = bins[:, :n_whole] if layout == "fr" else bins[:n_whole]
    got = fn(rows.contiguous(), pos_t[:n_whole].contiguous(), gh8, M, B,
             r_tile)
    bins_rm = (rows.t() if layout == "fr" else rows).contiguous().to(
        torch.uint8)
    k1 = cuda_hist.level_histogram(bins_rm, gh8, pos_t[:n_whole, 0]
                                   .contiguous(), M, B, "int")
    assert torch.equal(got[0].reshape(F, B, 2, M), k1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prod", "u8cmp"])
@pytest.mark.parametrize("B,n_levels", [(67, 1), (32, 1), (64, 6), (67, 8)])
def test_onehot_r5_kernel_matches_plain(cuda_device, mode, B, n_levels):
    """T7 bitwise against its plain version, pad rows (pos = -1, random
    gh) and a dropped tail included: with n_levels > 1 the pad rows count
    through the floor-mod; with one level, bitwise a K1 int launch."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    rng = np.random.RandomState(B + n_levels)
    n, n_real, F, M = 2048 * 7 + 100, 2048 * 6 + 77, 28, 64
    bt = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    pos = np.full(n, -1, np.int32)
    pos[:n_real] = rng.randint(0, M, n_real)
    pos = torch.from_numpy(pos[None, :])
    gh = torch.from_numpy(rng.randint(-127, 127, (2, n)).astype(np.int32))
    bt, pos, gh = (t.to(cuda_device) for t in (bt, pos, gh))
    before = oh.COUNTERS["onehot_r5"].launches
    got = oh.onehot_r5(bt, pos, gh, B, n_levels, mode)
    want = oh.onehot_r5_plain(bt, pos, gh, B, n_levels, mode)
    torch.cuda.synchronize()
    assert oh.COUNTERS["onehot_r5"].launches == before + 1
    assert got.shape == (n_levels, F * B, 2 * M) and torch.equal(got, want)
    if n_levels == 1:
        n_used = 2048 * 7
        k1 = cuda_hist.level_histogram(
            bt[:, :n_used].t().contiguous(), gh[:, :n_used].t().contiguous(),
            pos[0, :n_used].contiguous(), M, B, "int")
        assert torch.equal(got[0].reshape(F, B, 2, M), k1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_node", [5, 64, 130])
@pytest.mark.parametrize("precision,hot,bin_dtype", [
    ("bf16", "float32", "int32"), ("bf16", "bfloat16", "int16"),
    ("fp32", "float32", "int32"), ("fp32", "float32", "int16")])
def test_onehot_variant_kernel_matches_plain(cuda_device, n_node, precision,
                                             hot, bin_dtype):
    """T5 against its plain version: bitwise on gh exact in bf16 (sums of
    multiples of 1/64 below 2 are exact in any order); on random gh within
    2 n 2^-24 sum|x| per cell (two orders of an n-term f32 sum)."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    rng = np.random.RandomState(n_node)
    N, F, B = 30000, 28, 67
    bins = torch.from_numpy(rng.randint(0, B, (N, F)).astype(np.int32))
    pos = rng.randint(0, n_node + 10, N).astype(np.int32)
    pos[rng.rand(N) < 0.1] = -1
    pos = torch.from_numpy(pos).to(cuda_device)
    bins = bins.to(cuda_device)
    kw = dict(precision=precision, hot_dtype=getattr(torch, hot),
              bin_dtype=getattr(torch, bin_dtype))
    dy = torch.from_numpy((rng.randint(-128, 128, (N, 2)) / 64.0).astype(
        np.float32)).to(cuda_device)
    before = oh.COUNTERS["onehot_variant"].launches
    got = oh.onehot_variant(bins, dy, pos, n_node, B, **kw)
    torch.cuda.synchronize()
    assert oh.COUNTERS["onehot_variant"].launches == before + 1
    assert got.shape == (n_node, F, B, 2)
    assert torch.equal(got, oh.onehot_variant_plain(bins, dy, pos, n_node,
                                                    B, **kw))
    gh = torch.from_numpy(rng.randn(N, 2).astype(np.float32)).to(cuda_device)
    got = oh.onehot_variant(bins, gh, pos, n_node, B, **kw)
    want = oh.onehot_variant_plain(bins, gh, pos, n_node, B, **kw)
    src = gh.to(torch.bfloat16).float() if precision == "bf16" else gh
    cnt = oh.onehot_variant_plain(bins, torch.ones_like(gh), pos, n_node, B,
                                  "fp32")
    a = oh.onehot_variant_plain(bins, src.abs(), pos, n_node, B, "fp32")
    assert bool(((got - want).abs() <= 2.0 * cnt * 2.0 ** -24 * a).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,n_node", [(30001, 5, 1), (30001, 5, 70),
                                        (4099, 3, 3)])
@pytest.mark.parametrize("kernel,kw", [
    ("onehot_variant", dict(precision="bf16")),
    ("onehot_variant", dict(precision="fp32", bin_dtype="int16")),
    ("onehot_group", dict(fg=4))])
def test_onehot_wgmma_kernels_on_odd_shapes(cuda_device, kernel, kw, N, F,
                                            n_node):
    """T5 and T1 share the wgmma kernel: F Bp (5 x 72 = 360) not a
    multiple of its 64-row M tiles, a row count that is not a multiple of
    its row step (256, 64 exact), one node (N = 8) and two node tiles;
    bitwise on gh exact in bf16 and within the f32 summation bound on
    random gh, with a bad bin planted in some (row, feature)s."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    kw = {k: getattr(torch, v) if k.endswith("dtype") else v
          for k, v in kw.items()}
    rng = np.random.RandomState(N + F + n_node)
    B = 67
    bins = rng.randint(0, B, (N, F)).astype(np.int32)
    bins[rng.rand(N, F) < 0.01] = 300
    pos = rng.randint(-1, n_node + 10, N).astype(np.int32)
    dy = (rng.randint(-128, 128, (N, 2)) / 64.0).astype(np.float32)
    gh = rng.randn(N, 2).astype(np.float32)
    bins, pos, dy, gh = (torch.from_numpy(a).to(cuda_device)
                         for a in (bins, pos, dy, gh))
    fn, plain = getattr(oh, kernel), getattr(oh, kernel + "_plain")
    before = oh.COUNTERS[kernel].launches
    got = fn(bins, dy, pos, n_node, B, **kw)
    torch.cuda.synchronize()
    assert oh.COUNTERS[kernel].launches == before + 1
    assert got.shape == (n_node, F, B, 2)
    assert torch.equal(got, plain(bins, dy, pos, n_node, B, **kw))
    exact = kw.get("precision") == "fp32"
    src = gh if exact else gh.to(torch.bfloat16).float()
    got, want = fn(bins, gh, pos, n_node, B, **kw), plain(bins, gh, pos,
                                                          n_node, B, **kw)
    cnt = oh.onehot_variant_plain(bins, torch.ones_like(gh), pos, n_node, B,
                                  "fp32")
    a = oh.onehot_variant_plain(bins, src.abs(), pos, n_node, B, "fp32")
    assert bool(((got - want).abs() <= 2.0 * cnt * 2.0 ** -24 * a).all())


def _sass(name):
    """The SASS of the built library of ``csrc/<name>.cu``."""
    import os
    import subprocess
    from xgboost_tpu_torch.ops import nvcc
    built, = nvcc.build([name])
    cuobjdump = os.path.join(os.path.dirname(nvcc.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(built.path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["onehot_variant", "onehot_group",
                                  "onehot_r4", "onehot_pack2"])
def test_onehot_wgmma_libraries_hold_hgmma(cuda_device, name):
    """T5's, T1's, T6's and T4a's (T4b's) libraries run wgmma: their SASS
    (``cuobjdump -sass``) holds HGMMA instructions and no mma.sync (HMMA)
    ones."""
    sass = _sass(name)
    assert sass.count("HGMMA") > 0
    assert sass.count("HMMA") == 0


@pytest.mark.cuda
def test_onehot_r5_library_holds_integer_gmma(cuda_device):
    """T7's library runs the s8 wgmma: its SASS holds integer GMMA
    (IGMMA) instructions and no integer mma.sync (IMMA) ones."""
    sass = _sass("onehot_r5")
    assert sass.count("IGMMA") > 0
    assert sass.count("IMMA") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["onehot_i8", "onehot_notrans"])
def test_onehot_int_libraries_hold_integer_gmma(cuda_device, name):
    """T3's and T2's libraries run the s8 wgmma at every N: their SASS
    holds integer GMMA (IGMMA) instructions and no integer mma.sync (IMMA)
    ones."""
    sass = _sass(name)
    assert sass.count("IGMMA") > 0
    assert sass.count("IMMA") == 0


def _bf16_bound(got, want, cnt, a):
    """|got - want| <= 2 n 2^-24 sum|x| per cell (two orders of an
    n-term f32 sum of the bf16-rounded values)."""
    return bool(((got - want).abs() <= 2.0 * cnt * 2.0 ** -24 * a).all())


def _bf16_fr_case(dev, n, F, B, M, seed, planted=None):
    """Feature-major int32 bins (2% past B: in [B, 255), or drawn from
    ``planted``), pos over [-1, M + 6) and gh exact in bf16 (multiples of
    1/64 below 2) and random."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(np.int32)
    bad = rng.rand(F, n) < 0.02
    bins[bad] = (rng.randint(B, 255, int(bad.sum())) if planted is None
                 else rng.choice(planted, int(bad.sum())))
    pos = rng.randint(-1, M + 6, (n, 1)).astype(np.int32)
    dy = (rng.randint(-128, 128, (n, 2)) / 64.0).astype(np.float32)
    gh = rng.randn(n, 2).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (bins, pos, dy, gh))


# (mode, n, F, B, M, r_tile): the mains' F, B and M = 1, 4, 32 with a
# dropped tail, then odd shapes: F = 5 (prod, onebig) and 6 (pack2), B =
# 1, 8, 255, M = 3, 5 (N = 8, 16), 33 (N = 128), 100 (two node tiles),
# r_tile = 1000 and 300
T4_CUDA_CASES = (
    [(mode, 2048 * 9 + 333, 28, 64, M, 2048) for M in (1, 4, 32)
     for mode in ("prod", "pack2", "onebig")]
    + [(mode, 100_037, 6 if mode == "pack2" else 5, B, M, r_tile)
       for B, M, r_tile in [(1, 3, 1000), (8, 5, 300), (255, 33, 1000),
                            (8, 100, 300), (255, 5, 300), (1, 100, 1000)]
       for mode in ("prod", "pack2", "onebig")])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n,F,B,M,r_tile", T4_CUDA_CASES)
def test_onehot_pack2_kernels_match_plain(cuda_device, mode, n, F, B, M,
                                          r_tile):
    """T4a (prod, pack2) and T4b (onebig) against their plain version,
    with a dropped tail, bins past B (odd shapes: -1, 256, 1000, B, 255)
    and pos past M: bitwise on gh exact in bf16 (and T4b == T4a prod),
    within the f32 summation bound on random gh."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    planted = None if F == 28 else [-1, 256, 1000, B, 255]
    bins, pos, dy, gh = _bf16_fr_case(cuda_device, n, F, B, M, M + 3 + B,
                                      planted)
    name = "onehot_onebig" if mode == "onebig" else "onehot_pack2"

    def fn(g, plain=False):
        if mode == "onebig":
            f = oh.onehot_onebig_plain if plain else oh.onehot_onebig
            return f(bins, pos, g, M, B, r_tile)
        f = oh.onehot_pack2_plain if plain else oh.onehot_pack2
        return f(bins, pos, g, M, mode, B, r_tile)
    before = oh.COUNTERS[name].launches
    got = fn(dy)
    torch.cuda.synchronize()
    assert oh.COUNTERS[name].launches == before + 1
    assert got.shape == (1, F * B, 2 * M) and torch.equal(got, fn(dy, True))
    if mode == "onebig":
        assert torch.equal(got, oh.onehot_pack2(bins, pos, dy, M, "prod", B,
                                                r_tile))
    got, want = fn(gh), fn(gh, True)
    assert _bf16_bound(got, want, fn(torch.ones_like(gh), True),
                       fn(gh.abs(), True))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,r_tile", [
    ("prod", 1024), ("prod", 2048), ("prod", 4096), ("dotfloor", 2048),
    ("u8bins", 2048), ("i16hot", 2048)])
def test_onehot_r4_kernel_matches_plain(cuda_device, mode, r_tile):
    """T6 in each one-hot build against its plain version (dotfloor: node
    totals in bin 0), with a dropped tail; u8bins and i16hot equal prod
    bitwise on gh exact in bf16."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    n, F, B = 4096 * 5 + 1000, 28, 64
    bins, pos, dy, gh = _bf16_fr_case(cuda_device, n, F, B, 64, 11)
    b = bins.to(torch.uint8) if mode == "u8bins" else bins
    before = oh.COUNTERS["onehot_r4"].launches
    got = oh.onehot_r4(b, pos, dy, mode, r_tile, B)
    torch.cuda.synchronize()
    assert oh.COUNTERS["onehot_r4"].launches == before + 1
    assert torch.equal(got, oh.onehot_r4_plain(b, pos, dy, mode, r_tile, B))
    if mode in ("u8bins", "i16hot"):
        assert torch.equal(got, oh.onehot_r4(bins, pos, dy, "prod", r_tile,
                                             B))
    got = oh.onehot_r4(b, pos, gh, mode, r_tile, B)

    def plain(g):
        return oh.onehot_r4_plain(b, pos, g, mode, r_tile, B)
    assert _bf16_bound(got, plain(gh), plain(torch.ones_like(gh)),
                       plain(gh.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prod", "dotfloor", "u8bins", "i16hot"])
@pytest.mark.parametrize("n,F,B,r_tile", [
    (4096 * 5 + 1001, 28, 64, 1000), (4096 * 5, 28, 64, 1000),
    (4096 * 5 + 1001, 5, 67, 2048), (20001, 1, 8, 1000)])
def test_onehot_r4_kernel_on_odd_shapes(cuda_device, mode, n, F, B,
                                        r_tile):
    """T6 on the wgmma kernel where its tiling is odd: rows that are not
    a multiple of its 256-row step (r_tile = 1000 drops the tail at a
    multiple of 1,000; n = 20,480 takes u8 bins 16 rows a load up to a
    partial group), F Bp not a multiple of 64 and one feature of 8 bins;
    bitwise on bf16-exact gh, within the f32 summation bound on random
    gh."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    bins, pos, dy, gh = _bf16_fr_case(cuda_device, n, F, B, 64, n + F + B)
    b = bins.to(torch.uint8) if mode == "u8bins" else bins
    before = oh.COUNTERS["onehot_r4"].launches
    got = oh.onehot_r4(b, pos, dy, mode, r_tile, B)
    torch.cuda.synchronize()
    assert oh.COUNTERS["onehot_r4"].launches == before + 1
    assert got.shape == (1, F * B, 128)
    assert torch.equal(got, oh.onehot_r4_plain(b, pos, dy, mode, r_tile, B))

    def plain(g):
        return oh.onehot_r4_plain(b, pos, g, mode, r_tile, B)
    assert _bf16_bound(oh.onehot_r4(b, pos, gh, mode, r_tile, B), plain(gh),
                       plain(torch.ones_like(gh)), plain(gh.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prod", "u8cmp"])
@pytest.mark.parametrize("n,F,B,n_levels", [
    (2048 * 9 + 333, 5, 1, 1), (2048 * 9 + 333, 5, 8, 1),
    (2048 * 9 + 333, 5, 255, 1), (2048 * 9 + 5, 28, 8, 2),
    (2048 * 9 + 5, 5, 67, 2), (2048 * 9 + 5, 5, 255, 8),
    (2048 * 5, 1, 8, 3)])
def test_onehot_r5_kernel_on_odd_shapes(cuda_device, mode, n, F, B,
                                        n_levels):
    """T7 on the wgmma kernel where its tiling is odd: B = 1, 8 and 255,
    five features (F Bp not a multiple of 64), and the levels form at 2,
    3 (one level a block) and 8 levels, with pad rows (pos = -1, random
    gh) that count through the floor-mod and a dropped tail; bitwise."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    rng = np.random.RandomState(n + F + B + n_levels)
    bt = rng.randint(0, B, (F, n)).astype(np.uint8)
    pos = rng.randint(0, 64, (1, n)).astype(np.int32)
    pos[0, n - n // 10:] = -1
    gh = rng.randint(-300, 300, (2, n)).astype(np.int32)
    bt, pos, gh = (torch.from_numpy(a).to(cuda_device) for a in (bt, pos, gh))
    before = oh.COUNTERS["onehot_r5"].launches
    got = oh.onehot_r5(bt, pos, gh, B, n_levels, mode)
    want = oh.onehot_r5_plain(bt, pos, gh, B, n_levels, mode)
    torch.cuda.synchronize()
    assert oh.COUNTERS["onehot_r5"].launches == before + 1
    assert got.shape == (n_levels, F * B, 128) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_node,fg", [
    (3, 2), (64, 4), (64, 14), (70, 7), (70, 1)])
def test_onehot_group_kernel_matches_plain(cuda_device, n_node, fg):
    """T1 against its plain version: bitwise on gh exact in bf16, within
    the f32 summation bound on random gh; n_node 70 takes two node tiles,
    the second partial."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    rng = np.random.RandomState(n_node + fg)
    N, F, B = 30000, 28, 67
    bins = torch.from_numpy(rng.randint(0, B, (N, F)).astype(
        np.int32)).to(cuda_device)
    pos = torch.from_numpy(rng.randint(-1, n_node + 10, N).astype(
        np.int32)).to(cuda_device)
    dy = torch.from_numpy((rng.randint(-128, 128, (N, 2)) / 64.0).astype(
        np.float32)).to(cuda_device)
    before = oh.COUNTERS["onehot_group"].launches
    got = oh.onehot_group(bins, dy, pos, n_node, B, fg)
    torch.cuda.synchronize()
    assert oh.COUNTERS["onehot_group"].launches == before + 1
    assert got.shape == (n_node, F, B, 2)
    assert torch.equal(got, oh.onehot_group_plain(bins, dy, pos, n_node, B))
    gh = torch.from_numpy(rng.randn(N, 2).astype(np.float32)).to(cuda_device)

    def plain(g):
        return oh.onehot_group_plain(bins, g, pos, n_node, B)
    got = oh.onehot_group(bins, gh, pos, n_node, B, fg, 1024)
    assert _bf16_bound(got, plain(gh), plain(torch.ones_like(gh)),
                       plain(gh.abs()))


@pytest.mark.cuda
def test_onehot_group_out_of_range_bin_leaves_the_row_in_other_features(
        cuda_device):
    """fg = 4: a bin of -1 or 1000 in one feature of a row drops that
    (row, feature) alone; the other features of the group still count the
    row, as in the plain version."""
    from xgboost_tpu_torch.ops import cuda_hist_onehot as oh
    rng = np.random.RandomState(5)
    N, F, B = 20000, 8, 67
    bins = rng.randint(0, B, (N, F)).astype(np.int32)
    bins[::7, 1] = -1
    bins[::5, 2] = 1000
    pos = rng.randint(0, 64, N).astype(np.int32)
    dy = (rng.randint(-128, 128, (N, 2)) / 64.0).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (bins, dy, pos)]
    got = oh.onehot_group(*args, 64, B, 4)
    want = oh.onehot_group_plain(*args, 64, B)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    clean = torch.from_numpy(np.clip(bins, 0, B - 1)).to(cuda_device)
    ref = oh.onehot_group_plain(clean, args[1], args[2], 64, B)
    assert torch.equal(got[:, [0, 3, 4, 5, 6, 7]], ref[:, [0, 3, 4, 5, 6, 7]])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
def test_row_draw_on_the_card_matches_the_cpu(cuda_device, n):
    """The subsample draw (threefry in int64 torch arithmetic) gives the
    same bits on the card as on the CPU, for one key and a stack."""
    from xgboost_tpu_torch import random as prng
    key = prng.fold_in(prng.PRNGKey(42), 7)
    keys = prng.split(key, 3)
    for k in (key, keys):
        got = prng.uniform_rows(k, n, cuda_device).cpu()
        assert torch.equal(got.view(torch.int32),
                           prng.uniform_rows(k, n, "cpu").view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 3])
def test_subtracted_level_matches_the_plain_versions(cuda_device, T):
    """A subtracted level (K2 counts; K1, or K4 for T trees, on the
    compacted rows) bitwise equals the same subtraction with the plain
    versions, in int8."""
    from xgboost_tpu_torch.models import tree as tt
    from xgboost_tpu_torch.ops import cuda_hist_lanes, cuda_node_stats
    from xgboost_tpu_torch.ops import histogram as th
    rng = np.random.RandomState(4)
    N, F, B, M = 20011, 7, 64, 8
    bins = torch.from_numpy(rng.randint(0, B, (N, F)).astype(np.uint8))
    gh = torch.from_numpy(rng.randn(T, N, 2).astype(np.float32))
    parent = rng.randint(-1, M // 2, (T, N)).astype(np.int32)
    child = np.where(parent >= 0, 2 * parent + (rng.rand(T, N) < 0.4),
                     -1).astype(np.int32)
    split = torch.from_numpy(rng.rand(T * M // 2) < 0.8)
    out = []
    for plain in (False, True):
        saved = (cuda_hist.level_histogram, cuda_node_stats.node_stats,
                 cuda_hist_lanes.level_histogram_lanes)
        if plain:
            cuda_hist.level_histogram = cuda_hist.level_histogram_plain
            cuda_node_stats.node_stats = cuda_node_stats.node_stats_plain
            cuda_hist_lanes.level_histogram_lanes = \
                cuda_hist_lanes.level_histogram_lanes_plain
        try:
            dev = [t.to(cuda_device) for t in (
                bins, gh if T > 1 else gh[0], torch.from_numpy(parent),
                torch.from_numpy(child), split)]
            prep = th.prepare_hist(dev[1], "int8")
            if T == 1:
                hp = th.build_level_histogram(dev[0], prep, dev[2][0],
                                              M // 2, B)
            else:
                hp = th.build_level_histogram_batched(dev[0], prep, dev[2],
                                                      M // 2, B)
            out.append(tt._subtracted_level_hist(dev[0], prep, dev[3], M, B,
                                                 hp, dev[4]).cpu())
        finally:
            (cuda_hist.level_histogram, cuda_node_stats.node_stats,
             cuda_hist_lanes.level_histogram_lanes) = saved
    assert torch.equal(out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"num_parallel_tree": 2},
    {"objective": "multi:softmax", "num_class": 3},
], ids=["forest", "multiclass"])
def test_multi_root_rounds_of_several_trees_match_plain(cuda_device, extra):
    """Multi-root training with T > 1 trees a round goes through K3 on
    the card (the root slots copied per tree: the kernel takes
    contiguous positions) and grows the model bytes of the plain K3."""
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    rng = np.random.RandomState(9)
    N = 30001
    X = rng.rand(N, 6).astype(np.float32)
    root = (X[:, 5] > 0.5).astype(np.uint32)
    y = np.where(root == 1, X[:, 0] > 0.5, X[:, 0] <= 0.5).astype(np.float32)
    if "num_class" in extra:
        y = np.where(X[:, 1] > 0.7, 2.0, y).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 64,
              "num_roots": 2, **extra}
    raws = []
    for fn in (kb.level_histogram_batched, kb.level_histogram_batched_plain):
        saved = kb.level_histogram_batched
        kb.level_histogram_batched = fn
        kb.reset_launches()
        try:
            d = xt.DMatrix(X, label=y)
            d.set_uint_info("root_index", root)
            raws.append(xt.train(params, d, 3, device="cuda").save_raw())
        finally:
            kb.level_histogram_batched = saved
        if len(raws) == 1:
            assert kb.launches == 3 * 3
    assert raws[0] == raws[1]


def _rank_case(seed, n_groups=300, lo=20, hi=100):
    """Ragged groups of 20-99 rows, relevance 0-2 from a noisy score."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(lo, hi, n_groups)
    n = int(sizes.sum())
    X = rng.rand(n, 6).astype(np.float32)
    score = X[:, 0] * 2 + X[:, 1] + 0.3 * rng.randn(n)
    y = np.digitize(score, np.quantile(score, [0.7, 0.9])).astype(np.float32)
    return X, y, sizes, np.concatenate([[0], np.cumsum(sizes)])


def _rank_bound(want, n_other, scale):
    """``tests/test_torch_rank.py``'s bound: 16 ulp + 2^-21 (1 + n_other)
    times the pair scale (the card's log and exp against the CPU's)."""
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return 16 * ulp + 2.0 ** -21 * (1.0 + n_other)[:, None] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pairwise", "ndcg", "map"])
@pytest.mark.parametrize("nps", [1, 2])
def test_rank_gradients_on_the_card_match_the_cpu(cuda_device, kind, nps):
    """Both device rank gradients on the card against the same code on
    the CPU: partners bitwise, g / h within the stated bound."""
    from xgboost_tpu_torch import random as prng
    from xgboost_tpu_torch import rank_device as rd
    _, y, _, gptr = _rank_case(3)
    key = prng.fold_in(prng.PRNGKey(4177), 7)
    rng = np.random.RandomState(4)
    pp = {d: rd.build_pad_prep(y, gptr, d) for d in ("cpu", cuda_device)}
    n = pp["cpu"].G * pp["cpu"].L
    pred = torch.from_numpy(rng.randn(n).astype(np.float32))
    got = rd.rank_gradient_padded(pred.to(cuda_device), key,
                                  pp[cuda_device], kind, nps).cpu()
    want = rd.rank_gradient_padded(pred, key, pp["cpu"], kind, nps)
    for k in range(nps):
        assert torch.equal(rd.pad_partners(key, k, pp[cuda_device]).cpu(),
                           rd.pad_partners(key, k, pp["cpu"]))
    n_other = torch.clamp_min(pp["cpu"].g_size - pp["cpu"].b_sz,
                              1).reshape(-1).float()
    assert bool(((got - want).abs() <= _rank_bound(want, n_other,
                                                   1.0 / nps)).all())
    sp = {d: rd.build_prep(y, gptr, len(y), d) for d in ("cpu", cuda_device)}
    pred = torch.from_numpy(rng.randn(len(y)).astype(np.float32))
    got = rd.rank_gradient(pred.to(cuda_device), key, sp[cuda_device], kind,
                           nps).cpu()
    want = rd.rank_gradient(pred, key, sp["cpu"], kind, nps)
    assert torch.equal(rd.pred_order(pred.to(cuda_device),
                                     sp[cuda_device]).cpu(),
                       rd.pred_order(pred, sp["cpu"]))
    for k in range(nps):
        assert torch.equal(rd.sort_partners(key, k, sp[cuda_device]).cpu(),
                           rd.sort_partners(key, k, sp["cpu"]))
    n_other = torch.clamp_min(sp["cpu"].g_size - sp["cpu"].b_sz, 1).float()
    assert bool(((got - want).abs() <= _rank_bound(want, n_other,
                                                   1.0 / nps)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pairwise", "ndcg", "map"])
def test_padded_rank_training_matches_plain_k1(cuda_device, kind):
    """rank:* on the group-padded layout through K1 (padding slots at
    pos -1 with zero gradients) grows the model bytes of the plain K1."""
    import xgboost_tpu_torch as xt
    X, y, sizes, _ = _rank_case(5)
    params = {"objective": f"rank:{kind}", "max_depth": 4, "max_bin": 64,
              "silent": 1}
    raws = []
    for fn in (cuda_hist.level_histogram, cuda_hist.level_histogram_plain):
        saved = cuda_hist.level_histogram
        cuda_hist.level_histogram = fn
        cuda_hist.reset_launches()
        try:
            d = xt.DMatrix(X, label=y, group=sizes)
            bst = xt.train(params, d, 3, device="cuda")
            assert bst._cache[id(d)].rank_pad_prep is not None
            raws.append(bst.save_raw())
        finally:
            cuda_hist.level_histogram = saved
        if len(raws) == 1:
            assert cuda_hist.launches == 3 * 4
    assert raws[0] == raws[1]


# ---------------------------------------------------------------- serving
def _serving_model(dev, rounds=12, num_class=0, seed=0):
    import xgboost_tpu_torch as xt
    rng = np.random.RandomState(seed)
    X = rng.randn(4000, 8).astype(np.float32)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    if num_class:
        y = np.argmax(Z[:, :num_class], axis=1).astype(np.float32)
        p = {"objective": "multi:softprob", "num_class": num_class}
    else:
        y = (Z[:, 0] + Z[:, 1] * Z[:, 2] > 0).astype(np.float32)
        p = {"objective": "binary:logistic"}
    p.update(max_depth=5, eta=0.3, max_bin=64)
    return xt.train(p, xt.DMatrix(X, label=y), rounds, device=dev), X


@pytest.mark.cuda
@pytest.mark.parametrize("num_class,chunk", [(0, "32"), (3, "32"),
                                             (3, "0")])
def test_graph_replay_equals_eager_at_every_bucket(cuda_device, num_class,
                                                   chunk, monkeypatch):
    """Every bucket's captured graph against the eager margin function
    on the same input, byte for byte, and predictions against
    ``Booster.predict``."""
    monkeypatch.setenv("XGBTPU_PREDICT_TREE_CHUNK", chunk)
    from xgboost_tpu_torch.serving import PredictEngine
    bst, X = _serving_model(cuda_device, num_class=num_class)
    eng = PredictEngine(bst, min_bucket=8, max_bucket=1024, warmup=True)
    assert eng.compile_count == len(eng.buckets) == 8
    pools = [exe.pool for exe in eng._compiled.values()]
    assert min(pools) > 0 and eng.device_bytes() > sum(pools)
    fn = eng.margin_function()
    for b in eng.buckets:
        x = torch.from_numpy(X[:b]).to(cuda_device)
        base = torch.full((b, eng._K), eng._base_scalar,
                          device=cuda_device)
        exe = eng._executable(b)
        with exe.lock:
            exe.x.copy_(x)
            got = exe.run().clone()
        assert torch.equal(got, fn(x, base)), b
        assert got.cpu().numpy().tobytes() == fn(x, base).cpu().numpy() \
            .tobytes()
    for n in (1, 7, 100, 1024, 3000):
        assert eng.predict(X[:n]).tobytes() == bst.predict(X[:n]).tobytes()
    assert eng.compile_count == 8


@pytest.mark.cuda
@pytest.mark.parametrize("num_class", [0, 3])
def test_chunked_prediction_equals_the_per_tree_path(cuda_device,
                                                     num_class):
    """On the card ``Booster.predict`` and the engine run the chunked
    traversal (``pred_chunk`` 32); its margins, predictions and leaf
    indices equal the per-tree path's (``pred_chunk`` 0) and chunk 8's,
    byte for byte."""
    from xgboost_tpu_torch.serving import PredictEngine
    bst, X = _serving_model(cuda_device, num_class=num_class)
    g = bst.gbtree
    assert g.pred_chunk == 32
    outs = {}
    try:
        for chunk in (32, 8, 0):
            g.pred_chunk = chunk
            outs[chunk] = [bst.predict(X, output_margin=True),
                           bst.predict(X), bst.predict(X, pred_leaf=True)]
    finally:
        g.pred_chunk = 32
    for chunk in (8, 0):
        for want, got in zip(outs[chunk], outs[32]):
            assert got.shape == want.shape
            assert got.tobytes() == want.tobytes(), chunk
    eng = PredictEngine(bst, min_bucket=8, max_bucket=1024, warmup=True)
    assert eng.describe()["tree_chunk"] == 32
    for n in (1, 100, 3000):
        assert eng.predict(X[:n], output_margin=True).tobytes() == \
            outs[0][0][:n].tobytes()
        assert eng.predict(X[:n]).tobytes() == outs[0][1][:n].tobytes()


@pytest.mark.cuda
def test_graph_replays_from_eight_threads(cuda_device):
    import threading
    from xgboost_tpu_torch.serving import PredictEngine
    bst, X = _serving_model(cuda_device)
    eng = PredictEngine(bst, min_bucket=8, max_bucket=64, warmup=True)
    want = {n: bst.predict(X[n:2 * n + 1]) for n in range(1, 65)}
    errors = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        for _ in range(50):
            n = int(rng.randint(1, 65))
            got = eng.predict(X[n:2 * n + 1])
            if got.tobytes() != want[n].tobytes():
                errors.append((seed, n))
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errors, errors[:5]
    assert eng.compile_count == len(eng.buckets)


@pytest.mark.cuda
def test_capture_during_replay_on_reload(cuda_device, tmp_path):
    """The registry captures the new version in its own thread while
    the batcher's thread replays the old one (thread-local capture
    mode); every answer is one model's, never a mixture."""
    import threading
    from xgboost_tpu_torch.serving import MicroBatcher, ModelRegistry
    bst_a, X = _serving_model(cuda_device, seed=0)
    bst_b, _ = _serving_model(cuda_device, rounds=7, seed=1)
    path = str(tmp_path / "m.bin")
    bst_a.save_model(path)
    reg = ModelRegistry(path, warmup=True, poll_sec=0, min_bucket=8,
                        max_bucket=256)
    batcher = MicroBatcher(reg.predict, max_batch_rows=256, max_wait_ms=1)
    Xq = X[:37]
    ref_a, ref_b = bst_a.predict(Xq), bst_b.predict(Xq)
    stop, outs, errors = threading.Event(), [], []

    def hammer():
        while not stop.is_set():
            try:
                outs.append(batcher.submit(Xq, timeout=30.0))
            except BaseException as e:  # noqa: BLE001 -- asserted below
                errors.append(e)
    ts = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        for t in ts:
            t.start()
        bst_b.save_model(path)
        reloaded = {}
        poll = threading.Thread(
            target=lambda: reloaded.update(ok=reg.check_reload()))
        poll.start()
        poll.join(300)
        post = batcher.submit(Xq, timeout=30.0)
    finally:
        stop.set()
        for t in ts:
            t.join(60)
        batcher.close()
    assert reloaded.get("ok") and not errors, errors[:3]
    assert post.tobytes() == ref_b.tobytes()
    for o in outs:
        assert o.tobytes() in (ref_a.tobytes(), ref_b.tobytes())


# ------------------------------------------------------------------ fleet
def _fleet_replica(path, base, rid):
    from xgboost_tpu_torch.serving import run_server
    return run_server(path, port=0, min_bucket=8, max_bucket=256,
                      max_wait_ms=1.0, poll_sec=0, quiet=True, block=False,
                      router_url=base, replica_id=rid, device="cuda")


def _post_csv(url, X):
    import json
    import urllib.request
    body = "\n".join(",".join(repr(float(v)) for v in row)
                     for row in X).encode()
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, method="POST"), timeout=120) as r:
        raw = r.read()
    return raw, np.asarray(json.loads(raw)["predictions"], np.float32)


@pytest.mark.cuda
def test_router_bytes_equal_engine_bytes_on_the_card(cuda_device, tmp_path):
    """Two replicas on one card behind a router: the routed body equals
    the direct one byte for byte, and its predictions equal each
    replica engine's bytes."""
    from xgboost_tpu_torch.fleet import FleetRouter
    bst, X = _serving_model(cuda_device)
    path = str(tmp_path / "m.bin")
    bst.save_model(path)
    X = np.nan_to_num(X)
    rt = FleetRouter(port=0, hc_sec=0.5, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    reps = [_fleet_replica(path, base, rid) for rid in ("r0", "r1")]
    try:
        assert rt.membership.describe()["in_rotation"] == 2
        for n in (1, 37, 256, 600):
            raw, got = _post_csv(base + "/predict", X[:n])
            for srv in reps:
                assert _post_csv(f"http://127.0.0.1:{srv.port}/predict",
                                 X[:n])[0] == raw
                assert got.tobytes() == \
                    srv.registry.engine.predict(X[:n]).tobytes()
            assert got.tobytes() == bst.predict(X[:n]).tobytes()
        for srv in reps:
            assert srv.registry.engine.compile_count == 6
    finally:
        for srv in reps:
            srv.shutdown()
        rt.shutdown()


@pytest.mark.cuda
def test_two_replicas_one_capturing_while_the_other_replays(cuda_device,
                                                           tmp_path):
    """Two replicas share the card: r0 reloads (captures its buckets'
    graphs in the reload thread) while clients keep r1 and r0 busy
    through the router; every answer is one model's bytes, r1's never
    change, and afterwards r0 serves the new model."""
    import threading
    import time
    import urllib.request
    from xgboost_tpu_torch.fleet import FleetRouter
    bst_a, X = _serving_model(cuda_device, seed=0)
    bst_b, _ = _serving_model(cuda_device, rounds=7, seed=1)
    X = np.nan_to_num(X)
    paths = {rid: str(tmp_path / f"{rid}.bin") for rid in ("r0", "r1")}
    for p in paths.values():
        bst_a.save_model(p)
    rt = FleetRouter(port=0, hc_sec=0.5, quiet=True).start()
    base = f"http://{rt.host}:{rt.port}"
    reps = {rid: _fleet_replica(p, base, rid) for rid, p in paths.items()}
    Xq = X[:37]
    ref_a, ref_b = bst_a.predict(Xq).tobytes(), bst_b.predict(Xq).tobytes()
    stop, seen, errors = threading.Event(), [], []

    def hammer(url):
        while not stop.is_set():
            try:
                seen.append((url, _post_csv(url, Xq)[1].tobytes()))
            except BaseException as e:  # noqa: BLE001 -- asserted below
                errors.append(e)
    r1_url = f"http://127.0.0.1:{reps['r1'].port}/predict"
    ts = [threading.Thread(target=hammer, args=(u,))
          for u in (base + "/predict", r1_url, r1_url, base + "/predict")]
    try:
        for t in ts:
            t.start()
        bst_b.save_model(paths["r0"])
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{reps['r0'].port}/-/reload", data=b"",
                method="POST"), timeout=300) as r:
            r.read()
        time.sleep(0.5)
    finally:
        stop.set()
        for t in ts:
            t.join(60)
    try:
        assert not errors, errors[:3]
        assert reps["r0"].registry.version == 2
        assert all(b in (ref_a, ref_b) for _, b in seen)
        assert all(b == ref_a for u, b in seen if u == r1_url)
        assert _post_csv(f"http://127.0.0.1:{reps['r0'].port}/predict",
                         Xq)[1].tobytes() == ref_b
        assert reps["r1"].registry.engine.compile_count == 6
    finally:
        for srv in reps.values():
            srv.shutdown()
        rt.shutdown()
