"""Smoke run of xgboost_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls and holds
every kernel against its plain PyTorch version.  The paths:

- Higgs: the JAX package's headline benchmark configuration
  (``bench.py``: 1,000,000 x 28, binary logistic, max_depth 6, eta 0.1,
  max_bin 64, hist_precision auto = int8), 20 rounds, kernel K1;
- multiclass: ``bench.py:bench_multiclass`` (200,000 x 28, 6-class
  softmax, max_depth 6, eta 0.3, max_bin 64), all 60 rounds, kernel K3
  (one launch per level for the round's 6 trees);
- otto: ``bench.py:bench_otto`` (200,000 x 93, 9-class softprob), cut
  to 10 rounds, kernel K3 with feature tiling;
- depth 0: a max_depth=0 6-class booster, 5 rounds, kernel K2 (one
  launch a round, one kernel a launch);
- lanes: ``pipeline.run_tenant_lanes`` over 48 tenant pipelines at the
  Higgs booster's width (depth 6, eta 0.1, max_bin 64, 28 features),
  12,288 to 16,283 rows each, 2 cycles of 10 rounds, stacked into one
  K4 launch per level for all tenants (a stack of 64 lanes of 16,384
  rows; K4 is K1's and K3's scatter kernel with the lanes as its trees),
  then the same tenants through the host loop (K1 per tenant);
- the histogram microbenchmarks: the seven ported Pallas prototypes'
  ``main``s (``xgboost_tpu_torch.tools``: T5 ``hist_microbench``, T3
  ``hist_int8_proto``, T2 ``hist_notrans_proto``, T7 ``hist_r5_ab``; the
  bf16 family T1 ``hist_group_proto``, T4a and T4b ``hist_pack2_proto``
  ``main`` and ``main_onebig``, T6 ``hist_r4_ab``) at their full shapes
  (1M x 28), each timing its one-hot tensor-core kernel beside K1.

Phases, in order; any failure exits non-zero:

  1. environment: the card's name and power limit;
  2. build: nvcc compiles every kernel from xgboost_tpu_torch/csrc/, one
     process per source, all at once;
  3. each kernel against its plain version on the card, at its paths'
     shapes and beyond (int8 bitwise; fp32 / bf16 bitwise on dyadic
     gradients, within the f32 summation bound on random ones; K3's tree
     slices and K4's lanes against solo K1 launches, bitwise; K1 and K3
     also at 1, 3 and 12,373 rows, 93 features, 24 trees, B = 1 and 256,
     64 and 128 nodes, every row inactive, and 2% of the bins at B or
     above; K4 under both of its flushes, at 1, 3 and 64 lanes, B = 7
     and 256, 128 nodes and 2% of the bins at B or above);
  4. each path: ``train`` with every launch count reset just before and
     read just after, its quality metric against a floor, the same
     rounds with the plain version forced (identical model bytes where
     the sums are integers), save/load (bitwise predictions), and the
     kernel against the plain version on every level's real inputs;
  5. times on the card: ms per round, and per kernel call on the paths'
     real inputs the kernel's ms (CUDA events around back-to-back
     calls) and, for K1-K4, its device ms (``torch.profiler``'s CUDA
     activities of 20 calls: the kernel and any memset, without the
     host's issue time) beside its bound, the plain version's and one
     PyTorch call's (``index_add_``), with K1's, K3's and K4's launch
     plan at each level (tiles, units, copies, blocks, rows a step, the
     store or the atomic flush) and K2's one kernel a call; for the
     lanes, the stacked and the host-loop cycle (gate and publish left
     out, as ``tools/bench_lanes.py`` times them) and tenants per
     second.

The ``[onehot]`` phase holds each one-hot kernel against its plain
version (int bitwise, including the int8 wrap, the dropped tail and T7's
floor-mod pad rows; T3 and T2 at M = 1-5, 8, 16, 32, 33 and 100, B = 1,
8 and 255 on five features, F = 3, r_tile = 1000 and with bins out of
range; T7 also at B = 1, 8 and 255 on five features and at 2, 6 and 8
levels; T5 bitwise on bf16-exact gradients, within the f32 summation
bound on random ones, also at F Bp not a multiple of 64, rows not a
multiple of the row step and one node) and each int kernel against a K1
int launch on the same inputs, fails unless T5's built library holds
wgmma (HGMMA) instructions and no mma.sync (HMMA) ones and T7's, T3's
and T2's integer wgmma (IGMMA) and no integer mma.sync (IMMA) ones
(``cuobjdump -sass``), then runs the four mains with every launch count
set to 0 just before and read just after, and fails on any count but the
mains' exact ones (a fall to the plain version would leave it short), on
T2's int32 sums differing from exact ones, and on T3's dequantized
histogram beyond its rows' half quantization steps.

The ``[onehot-bf16]`` phase does the same for T1, T4a, T4b and T6: each
kernel bitwise against its plain version on bf16-exact gradients and
within the f32 summation bound on random ones (dropped tails, bins past
B, rows outside the node tile, T1's node tiles and every fg and r_tile
of its main, F Bp not a multiple of 64 on rows that are not a multiple
of the row step, one node, a planted out-of-range bin that must leave
its row in the group's other features, T4b == T4a prod, T4 at F = 5 and
6, B = 1, 8, 255, M = 3, 5, 33, 100 and r_tile = 1000 and 300, T6's
u8bins == i16hot == prod, every T6 mode on rows that are not a multiple
of its row step and at F Bp not a multiple of 64), the same SASS check
of T1's, T6's and T4's libraries, then the three
bf16 mains with exact launch counts, T1's accuracy line within bf16's
rounding of K1 fp32, and T4a's and T4b's match checks. Every path counts
the launches of all twelve kernels and fails on any kernel it should not
run.

The ``[lanes]`` phase fails on a solo lane or a ``lanes.stack_error``
event in the stacked run (the solo fallback would hide a K4 that does
not build or launch), on any K1 or K3 launch there, on a launch count
other than cycles x rounds x 6 levels for K4, on any difference in a
tenant's published bytes or gate verdicts between the stacked run and
the host loop, and on a holdout AUC under ``LANE_AUC_FLOOR``.

Prints a ``{"kernels": [...]}`` line and the card's name and power limit
before the last line, ``{"ok": true, "device": {...}}``.  Scratch files
go to ``.smoke_out/`` beside this script (git-ignored).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRAIN, N_TEST, N_FEAT = 1_000_000, 100_000, 28
ROUNDS, DEPTH = 20, 6
AUC_FLOOR = 0.93
PARAMS = {"objective": "binary:logistic", "max_depth": DEPTH, "eta": 0.1,
          "max_bin": 64}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the f32 rate of
# the CUDA cores, which do the kernel's additions (no tensor cores)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# bench.py:bench_multiclass, all 60 rounds
MC_N, MC_TEST, MC_FEAT, MC_K, MC_ROUNDS = 200_000, 20_000, 28, 6, 60
MC_PARAMS = {"objective": "multi:softmax", "num_class": MC_K,
             "max_depth": DEPTH, "eta": 0.3, "max_bin": 64}
# The JAX package reaches holdout merror 0.1827 on this task and config
# (BENCH_r04.json, BENCH_r05.json).  The 20,000 holdout rows give that
# rate a standard error of about 0.0027, so 0.195 lies ~4.5 of them above
# it: a model of the JAX package's quality passes, one that is a point of
# accuracy worse fails.
MERROR_FLOOR = 0.195
# bench.py:bench_otto, its 60 rounds cut to 10
OTTO_N, OTTO_FEAT, OTTO_K, OTTO_ROUNDS = 200_000, 93, 9, 10
OTTO_PARAMS = {"objective": "multi:softprob", "num_class": OTTO_K,
               "max_depth": DEPTH, "eta": 0.3, "max_bin": 64}
# max_depth=0 (tests/test_edge_cases.py:54) on the multiclass task: the
# root's node statistics come from K2, one launch per round for its trees
D0_ROUNDS = 5
D0_PARAMS = {**MC_PARAMS, "max_depth": 0}
# [lanes]: gang-batched tenant training at the Higgs booster's width
# (binary:logistic, depth 6, eta 0.1, max_bin 64, 28 features) and tenant
# scale: tenant i trains on 12,288 + 85 i rows from seed 1000 + i and is
# judged on 2,048 holdout rows from seed 5000 + i; 48 tenants share one
# bucket of 16,384 rows and pad to a stack of 64 lanes
LANES_N, LANE_ROWS0, LANE_ROWS_STEP, LANE_HOLD = 48, 12_288, 85, 2048
LANE_CYCLES, LANE_ROUNDS = 2, 10
LANE_PARAMS = dict(PARAMS)
LANE_STACK = 64                  # 48 tenants pad to a power of two
# The JAX package's own stacked lanes on these 48 tenants' arrays, the
# same parameters, cycles and rounds, on a CPU (``JAX_PLATFORMS=cpu
# python tests/test_torch_lanes.py 48``): holdout AUC 0.920299 at the
# lowest tenant, 0.932 on average.  The floor is that lowest minus 0.005.
LANE_AUC_FLOOR = 0.915299


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def make_higgs_like(n, f=28, seed=42):
    """The JAX package's benchmark task (``bench.py:make_higgs_like``):
    kinematic-ish features, a nonlinear decision surface, ~30% noise."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, f), dtype=np.float32)
    X[:, : f // 3] = rng.exponential(1.0, (n, f // 3))
    X[:, f // 3: 2 * f // 3] = rng.randn(n, f - 2 * (f // 3) + f // 3)[
        :, : f // 3]
    X[:, 2 * (f // 3):] = rng.rand(n, f - 2 * (f // 3))
    score = (np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2] - 0.5 * X[:, 3] ** 2
             + 2.0 * (X[:, 4] > 1.0) + 0.8 * rng.randn(n))
    y = (score > np.median(score)).astype(np.float32)
    return X, y


def tenant_arrays(i):
    """Tenant i's (X, y) train rows and (Xh, yh) holdout rows."""
    X, y = make_higgs_like(LANE_ROWS0 + LANE_ROWS_STEP * i, seed=1000 + i)
    Xh, yh = make_higgs_like(LANE_HOLD, seed=5000 + i)
    return X, y, Xh, yh


def cuda_ms(torch, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profiled_ms(torch, fn, reps=20):
    """Device time of ``fn()``: the per-call mean of the GPU activities it
    issues (kernels, memsets, copies), summed from ``torch.profiler``'s
    CUDA activities over ``reps`` calls, and those activities by name,
    per call.  The profiler can drop or add activities at a trace's
    edges, so a trace holds ``reps`` warm-up calls, a marker kernel
    (``torch.cuda._sleep``), the ``reps`` timed calls and four markers,
    and only the activities between the markers count; a trace that does
    not see the call's own kernel exactly ``reps`` times there is taken
    again, up to three times.  Back-to-back CUDA-event timing
    (:func:`cuda_ms`) also counts the host's issue time between calls;
    this counts only the card's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda._sleep(100)
            for _ in range(reps):
                fn()
            for _ in range(4):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        acts = sorted((e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA),
                      key=lambda e: e.start_ns())
        marks = [i for i, e in enumerate(acts) if "spin_kernel" in e.name()]
        acts = acts[marks[0] + 1:marks[1]] if len(marks) >= 2 else []
        names = {}
        for e in acts:
            names[e.name()] = names.get(e.name(), 0) + 1
        if names and max(names.values()) == reps:
            break
    else:
        fail(f"torch.profiler saw no clean trace of {reps} calls: {names}")
    return (sum(e.duration_ns() for e in acts) / 1e6 / reps,
            {k: v / reps for k, v in names.items()})


def make_multiclass(n, f=MC_FEAT, k=MC_K, seed=7):
    """``bench.py:bench_multiclass``'s data: Gaussian features, labels
    the argmax of noisy linear class scores."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    centers = rng.randn(k, f).astype(np.float32) * 1.2
    logits = X @ centers.T + 0.8 * rng.randn(n, k)
    return X, logits.argmax(axis=1).astype(np.float32)


def make_otto(n, f=OTTO_FEAT, k=OTTO_K, seed=21):
    """``bench.py:bench_otto``'s data: skewed count-like features."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32) ** 2
    centers = rng.randn(k, f).astype(np.float32)
    logits = X @ centers.T + 0.5 * rng.randn(n, k)
    return X, logits.argmax(axis=1).astype(np.float32)


def sum_bound_ok(torch, got, want, n, a):
    """|got - want| <= 2 n 2^-24 sum|x| everywhere: each of two orders
    of an n-term f32 sum is within n 2^-24 sum|x| of the exact sum."""
    return not bool(((got - want).abs() > 2.0 * n * 2.0 ** -24 * a).any())


def reset_counts(kernels):
    for mod in kernels.values():
        mod.reset_launches()


def read_counts(kernels):
    return {name: mod.launches for name, mod in kernels.items()}


def only(kernels, **launches):
    """The launch counts of a run that launched ``launches`` and no
    other kernel of ``kernels``."""
    return {**{name: 0 for name in kernels}, **launches}


# ------------------------------------------------------------- phase 3
def plant_bins(torch, bins, B, share, g, dev):
    """Set ``share`` of the bins to values in [B, 256): binning never makes
    them, and the kernels and their plain versions skip them."""
    if share and B < 256:
        hit = torch.rand(bins.shape, generator=g, device=dev) < share
        bins[hit] = torch.randint(B, 256, (int(hit.sum()),), generator=g,
                                  device=dev, dtype=torch.int32).to(
                                      torch.uint8)
    return bins


def hist_case(torch, cuda_hist, N, F, B, M, mode, dyadic, seed, dev,
              inactive=0.2, oob=0.0):
    """One K1 comparison on the same CUDA tensors: ``inactive`` of the
    rows at pos -1, ``oob`` of the bins planted at B or above.  Returns
    max |kernel - plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (N, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[torch.rand(N, generator=g, device=dev) < inactive] = -1
    bins = plant_bins(torch, bins, B, oob, g, dev)
    if dyadic:  # multiples of 1/256: f32 sums exact in any order
        gh = torch.randint(-512, 512, (N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
    else:
        gh = torch.randn(N, 2, generator=g, device=dev)
    if mode == "int":
        gh, _ = cuda_hist.quantize_gh(gh)
    got = cuda_hist.level_histogram(bins, gh, pos, M, B, mode)
    want = cuda_hist.level_histogram_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    tag = (f"K1 {mode} N={N} F={F} B={B} n_node={M} dyadic={dyadic} "
           f"inactive={inactive} oob={oob}")
    if got.shape != (F, B, 2, M) or got.dtype != want.dtype:
        fail(f"{tag}: shape {tuple(got.shape)} {got.dtype}")
    if mode == "int" or dyadic:
        if not torch.equal(got, want):
            fail(f"{tag}: not bitwise equal to the plain version")
        return 0.0
    # random f32 gh: the two differ only in the order of additions.  A
    # sum of n terms in any order is within n * 2^-24 * sum|x| of the
    # exact sum (the gamma_n bound), so they are within twice that
    src = gh.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else gh
    n = cuda_hist.level_histogram_plain(bins, torch.ones_like(gh), pos, M,
                                        B, "fp32")
    a = cuda_hist.level_histogram_plain(bins, src.abs(), pos, M, B, "fp32")
    err = (got - want).abs()
    torch.cuda.synchronize()
    if bool((err > 2.0 * n * 2.0 ** -24 * a).any()):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x| "
             f"(max {float(err.max())})")
    return float(err.max())


def phase_kernels(torch, cuda_hist, dev):
    """K1 at the Higgs path's level shapes and beyond: (N, F, B, n_node,
    share of rows inactive, share of bins planted at B or above)."""
    errs = {}
    cases = [(N_TRAIN, N_FEAT, 64, m, 0.2, 0.0)
             for m in (1, 2, 4, 8, 16, 32, 128)]
    cases += [(N_TRAIN, N_FEAT, 256, 64, 0.2, 0.0),
              (N_TRAIN, N_FEAT, 200, 8, 0.2, 0.0), (1000, 3, 7, 3, 0.2, 0.0),
              (1, N_FEAT, 64, 1, 0.0, 0.0), (3, N_FEAT, 64, 2, 0.2, 0.0),
              (12_373, N_FEAT, 64, 32, 0.2, 0.02),
              (OTTO_N, OTTO_FEAT, 64, 32, 0.2, 0.0),
              (100_000, N_FEAT, 1, 4, 0.2, 0.02),
              (100_000, N_FEAT, 64, 64, 0.2, 0.0),
              (100_000, N_FEAT, 64, 8, 1.0, 0.0),
              (N_TRAIN, N_FEAT, 64, 16, 0.2, 0.02)]
    for (n, f, b, m, inactive, oob) in cases:
        variants = [("int", False), ("fp32", True), ("bf16", True)]
        if m in (1, 32, 128) or b != 64 or oob:
            variants += [("fp32", False), ("bf16", False)]
        for mode, dyadic in variants:
            e = hist_case(torch, cuda_hist, n, f, b, m, mode, dyadic,
                          seed=m * 7 + b, dev=dev, inactive=inactive,
                          oob=oob)
            key = mode + ("" if dyadic or mode == "int" else "_random_gh")
            errs[key] = max(errs.get(key, 0.0), e)
        print(f"[K1] N={n} F={f} B={b} n_node={m} inactive={inactive} "
              f"bins>=B {oob}: int8 bitwise, fp32/bf16 bitwise on dyadic gh"
              + (", within bound on random gh" if len(variants) > 3 else ""),
              flush=True)
    print(f"[K1] max |kernel - plain| by mode: {json.dumps(errs)}",
          flush=True)


def batched_case(torch, kb, cuda_hist, N, F, B, T, M, mode, dyadic, seed,
                 dev, inactive=0.2, oob=0.0):
    """One K3 comparison on the same CUDA tensors (rows and bins as
    :func:`hist_case`); in int mode also each tree's slice against a
    solo K1 launch.  Returns max |kernel - plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (N, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (T, N), generator=g, device=dev,
                        dtype=torch.int32)
    pos[torch.rand(T, N, generator=g, device=dev) < inactive] = -1
    bins = plant_bins(torch, bins, B, oob, g, dev)
    if dyadic:  # multiples of 1/256: f32 sums exact in any order
        gh = torch.randint(-512, 512, (T, N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
    else:
        gh = torch.randn(T, N, 2, generator=g, device=dev)
    if mode == "int":
        gh, _ = cuda_hist.quantize_gh(gh)
    got = kb.level_histogram_batched(bins, gh, pos, M, B, mode)
    want = kb.level_histogram_batched_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    tag = (f"K3 {mode} N={N} F={F} B={B} T={T} n_node={M} "
           f"dyadic={dyadic} inactive={inactive} oob={oob}")
    if got.shape != (F, B, 2, T * M) or got.dtype != want.dtype:
        fail(f"{tag}: shape {tuple(got.shape)} {got.dtype}")
    if mode == "int":
        for t in range(T):
            solo = cuda_hist.level_histogram(bins, gh[t].contiguous(),
                                             pos[t].contiguous(), M, B,
                                             "int")
            if not torch.equal(got[..., t * M:(t + 1) * M], solo):
                fail(f"{tag}: tree {t} differs from a solo K1 launch")
    if mode == "int" or dyadic:
        if not torch.equal(got, want):
            fail(f"{tag}: not bitwise equal to the plain version")
        return 0.0
    src = gh.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else gh
    n = kb.level_histogram_batched_plain(bins, torch.ones_like(gh), pos, M,
                                         B, "fp32")
    a = kb.level_histogram_batched_plain(bins, src.abs(), pos, M, B, "fp32")
    if not sum_bound_ok(torch, got, want, n, a):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x|")
    return float((got - want).abs().max())


def phase_k3(torch, kb, cuda_hist, dev):
    """K3 at the multiclass path's level shapes, otto's, a wide forest's,
    B = 256 and beyond: (N, F, B, T, n_node, share of rows inactive,
    share of bins planted at B or above)."""
    errs = {}
    cases = [(MC_N, MC_FEAT, 64, MC_K, m, 0.2, 0.0)
             for m in (1, 2, 4, 8, 16, 32)]
    cases += [(OTTO_N, OTTO_FEAT, 64, OTTO_K, m, 0.2, 0.0)
              for m in (1, 8, 32)]
    cases += [(MC_N, MC_FEAT, 64, 24, m, 0.2, 0.0) for m in (8, 32, 64)]
    cases += [(MC_N, MC_FEAT, 256, MC_K, m, 0.2, 0.0) for m in (8, 64)]
    cases += [(1000, 3, 7, 3, 3, 0.2, 0.0), (1, MC_FEAT, 64, MC_K, 1, 0.0, 0.0),
              (3, MC_FEAT, 64, MC_K, 2, 0.2, 0.0),
              (12_373, MC_FEAT, 64, MC_K, 32, 0.2, 0.02),
              (MC_N, MC_FEAT, 1, MC_K, 4, 0.2, 0.02),
              (MC_N, MC_FEAT, 64, MC_K, 128, 0.2, 0.0),
              (MC_N, MC_FEAT, 64, MC_K, 8, 1.0, 0.0),
              (MC_N, MC_FEAT, 64, MC_K, 16, 0.2, 0.02)]
    for (n, f, b, t, m, inactive, oob) in cases:
        variants = [("int", False), ("fp32", True), ("bf16", True)]
        if m in (1, 32) or b != 64 or oob:
            variants += [("fp32", False), ("bf16", False)]
        for mode, dyadic in variants:
            e = batched_case(torch, kb, cuda_hist, n, f, b, t, m, mode,
                             dyadic, seed=m * 7 + b + t, dev=dev,
                             inactive=inactive, oob=oob)
            key = mode + ("" if dyadic or mode == "int" else "_random_gh")
            errs[key] = max(errs.get(key, 0.0), e)
        print(f"[K3] N={n} F={f} B={b} T={t} n_node={m} inactive={inactive} "
              f"bins>=B {oob}: int8 bitwise and each tree == solo K1, "
              "fp32/bf16 bitwise on dyadic gh"
              + (", within bound on random gh" if len(variants) > 3 else ""),
              flush=True)
    print(f"[K3] max |kernel - plain| by mode: {json.dumps(errs)}",
          flush=True)


def phase_k2(torch, kn, dev):
    """K2 at the depth-0 path's shapes (T = 1 and 6 trees of 200k rows)
    and with more nodes: dyadic gh bitwise, random gh within the f32
    summation bound, and the same bits on a second launch."""
    max_err = 0.0
    for T, M in ((1, 1), (MC_K, 1), (MC_K, 8), (2, 20)):
        g = torch.Generator(device=dev).manual_seed(T * 31 + M)
        pos = torch.randint(0, M, (T, MC_N), generator=g, device=dev,
                            dtype=torch.int32)
        pos[torch.rand(T, MC_N, generator=g, device=dev) < 0.2] = -1
        dy = torch.randint(-512, 512, (T, MC_N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
        tag = f"K2 N={MC_N} T={T} n_node={M}"
        got = kn.node_stats(dy, pos, M)
        if got.shape != (T, M, 2) or not torch.equal(
                got, kn.node_stats_plain(dy, pos, M)):
            fail(f"{tag}: not bitwise equal to the plain version on "
                 "dyadic gh")
        gh = torch.randn(T, MC_N, 2, generator=g, device=dev)
        got = kn.node_stats(gh, pos, M)
        want = kn.node_stats_plain(gh, pos, M)
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M)
        a = kn.node_stats_plain(gh.abs(), pos, M)
        torch.cuda.synchronize()
        if not sum_bound_ok(torch, got, want, n, a):
            fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x|")
        if not torch.equal(kn.node_stats(gh, pos, M), got):
            fail(f"{tag}: two launches gave different bits")
        max_err = max(max_err, float((got - want).abs().max()))
        print(f"[K2] N={MC_N} T={T} n_node={M}: bitwise on dyadic gh, "
              "within bound on random gh, deterministic", flush=True)
    print(f"[K2] max |kernel - plain| on random gh: {max_err}", flush=True)


def lanes_case(torch, k4, cuda_hist, L, L_real, N, F, B, M, mode, dyadic,
               seed, dev, oob=0.0):
    """One K4 comparison on the same CUDA tensors: L lanes, the first
    L_real real with their own row counts (pad rows past them), the rest
    pad lanes, ``oob`` of the bins planted at B or above.  In int mode
    also each lane against a solo K1 launch on its unpadded rows.
    Returns max |kernel - plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (L, N, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (L, N), generator=g, device=dev,
                        dtype=torch.int32)
    pos[torch.rand(L, N, generator=g, device=dev) < 0.2] = -1
    bins = plant_bins(torch, bins, B, oob, g, dev)
    if dyadic:  # multiples of 1/256: f32 sums exact in any order
        gh = torch.randint(-512, 512, (L, N, 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.float32) / 256.0
    else:
        gh = torch.randn(L, N, 2, generator=g, device=dev)
    n_real = [int(n) for n in np.random.RandomState(seed).randint(
        N // 2, N + 1, L)]
    n_real = [N] + n_real[1:L_real] + [0] * (L - L_real)
    real = (torch.arange(N, device=dev)[None, :]
            < torch.tensor(n_real, device=dev)[:, None])
    pos = torch.where(real, pos, -1)
    gh = torch.where(real[..., None], gh, 0.0)
    if mode == "int":
        gh, _ = cuda_hist.quantize_gh(gh)      # per-lane scales
    got = k4.level_histogram_lanes(bins, gh, pos, M, B, mode)
    want = k4.level_histogram_lanes_plain(bins, gh, pos, M, B, mode)
    torch.cuda.synchronize()
    tag = (f"K4 {mode} L={L} ({L_real} real) N={N} F={F} B={B} "
           f"n_node={M} dyadic={dyadic} oob={oob}")
    if got.shape != (F, B, 2, L * M) or got.dtype != want.dtype:
        fail(f"{tag}: shape {tuple(got.shape)} {got.dtype}")
    if mode == "int":
        for lane, n in enumerate(n_real):
            sl = got[..., lane * M:(lane + 1) * M]
            if n == 0:
                if bool(sl.any()):
                    fail(f"{tag}: pad lane {lane} is not zero")
                continue
            solo = cuda_hist.level_histogram(
                bins[lane, :n].contiguous(), gh[lane, :n].contiguous(),
                pos[lane, :n].contiguous(), M, B, "int")
            if not torch.equal(sl, solo):
                fail(f"{tag}: lane {lane} differs from a solo K1 launch")
    if mode == "int" or dyadic:
        if not torch.equal(got, want):
            fail(f"{tag}: not bitwise equal to the plain version")
        return 0.0
    src = gh.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else gh
    n = k4.level_histogram_lanes_plain(bins, torch.ones_like(gh), pos, M, B,
                                       "fp32")
    a = k4.level_histogram_lanes_plain(bins, src.abs(), pos, M, B, "fp32")
    if not sum_bound_ok(torch, got, want, n, a):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x|")
    return float((got - want).abs().max())


def phase_k4(torch, k4, cuda_hist, dev):
    """K4 at the lanes path's level shapes (64 lanes, 48 real, of 16,384
    rows; the atomic flush at the shallow levels, the store flush at the
    deep ones), with F = 93, B = 7 and 256, node tiles past 64 nodes,
    one lane and three, a tiny odd shape, and 2% of the bins planted at
    B or above; pad rows in every real lane but the first."""
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    errs = {}
    cases = [(LANE_STACK, LANES_N, 16384, N_FEAT, 64, m, 0.0)
             for m in (1, 8, 16, 32)]
    cases += [(LANE_STACK, LANES_N, 16384, N_FEAT, 64, 32, 0.02),
              (LANE_STACK, LANES_N, 16384, N_FEAT, 64, 2, 0.02),
              (8, 8, 16384, OTTO_FEAT, 64, 4, 0.0),
              (3, 3, 20000, N_FEAT, 256, 64, 0.0),
              (3, 2, 3001, 6, 7, 128, 0.02),
              (1, 1, 50000, N_FEAT, 64, 128, 0.02),
              (LANE_STACK, 40, 2048, N_FEAT, 256, 128, 0.0),
              (4, 3, 1000, 3, 7, 3, 0.02)]
    for (L, Lr, n, f, b, m, oob) in cases:
        variants = [("int", False), ("fp32", True), ("bf16", True)]
        if m in (1, 32, 128) or b != 64 or oob:
            variants += [("fp32", False), ("bf16", False)]
        for mode, dyadic in variants:
            e = lanes_case(torch, k4, cuda_hist, L, Lr, n, f, b, m, mode,
                           dyadic, seed=L * 13 + m + b, dev=dev, oob=oob)
            key = mode + ("" if dyadic or mode == "int" else "_random_gh")
            errs[key] = max(errs.get(key, 0.0), e)
        flush = "store" if kb.launch_plan("hist_lanes", n, f, b, L, m, "int",
                                          dev).store else "atomic"
        print(f"[K4] L={L} ({Lr} real, pad rows) N={n} F={f} B={b} "
              f"n_node={m} bins>=B {oob} ({flush} flush): int8 bitwise and "
              "each lane == solo K1, pad lanes zero, fp32/bf16 bitwise on "
              "dyadic gh"
              + (", within bound on random gh" if len(variants) > 3 else ""),
              flush=True)
    print(f"[K4] max |kernel - plain| by mode: {json.dumps(errs)}",
          flush=True)


# ------------------------------------------------------------- phase 4
def phase_main(torch, xt, cuda_hist, kernels, device, card):
    from xgboost_tpu_torch.metrics import auc

    t0 = time.perf_counter()
    X, y = make_higgs_like(N_TRAIN + N_TEST)
    dtrain = xt.DMatrix(X[:N_TRAIN], label=y[:N_TRAIN])
    dtest = xt.DMatrix(X[N_TRAIN:], label=y[N_TRAIN:])
    print(f"[main] data {N_TRAIN} + {N_TEST} x {N_FEAT}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the counted run: counts to 0 just before, read just after
    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(PARAMS, dtrain, ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    launches = counts["hist_level"]
    print(f"[main] train {ROUNDS} rounds (cuts and binning included): "
          f"{train_s:.2f} s; hist_level launches {launches}; all counts "
          f"{json.dumps(counts)}", flush=True)
    if counts != only(kernels, hist_level=ROUNDS * DEPTH):
        fail(f"launch counts {counts}: want hist_level {ROUNDS * DEPTH}, "
             "the others 0")
    B = bst.gbtree.cuts.max_bin
    print(f"[main] bins B={B} (hist_bin_align auto -> 32 on the GPU)",
          flush=True)

    pred = bst.predict(dtest)
    if pred.shape != (N_TEST,) or not np.isfinite(pred).all():
        fail(f"holdout predictions: shape {pred.shape}, finite "
             f"{np.isfinite(pred).all()}")
    score = auc(pred, y[N_TRAIN:], np.ones(N_TEST, np.float32))
    print(f"[main] holdout AUC {score:.6f} (floor {AUC_FLOOR})", flush=True)
    if not score >= AUC_FLOOR:
        fail(f"holdout AUC {score} < {AUC_FLOOR}")
    raw = bst.save_raw()

    # ms per round: a second booster, round 0 (cuts, binning) untimed
    bst2 = xt.Booster(PARAMS, cache=[dtrain], device=device)
    bst2.update(dtrain, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst2.update_many(dtrain, 1, ROUNDS - 1)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) * 1e3 / (ROUNDS - 1)
    print(f"[main] {ms_round:.3f} ms per round ({N_TRAIN / ms_round * 1e3:.4g}"
          f" rows/s) | {card}", flush=True)
    if bst2.save_raw() != raw:
        fail("a second int8 run gave different model bytes")

    # the same rounds with the plain histogram forced on the card
    kernel_fn = cuda_hist.level_histogram
    cuda_hist.level_histogram = cuda_hist.level_histogram_plain
    try:
        plain = xt.train(PARAMS, dtrain, ROUNDS, device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    if plain.save_raw() != raw:
        fail("kernel and plain histograms grew different models")
    print("[main] plain-histogram run: identical model bytes", flush=True)

    path = os.path.join(HERE, ".smoke_out", "smoke_model.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bst.save_model(path)
    loaded = xt.Booster(model_file=path, device=device)
    if not np.array_equal(loaded.predict(dtest), pred):
        fail("predictions changed over save_model / load_model")
    print("[main] save/load: bitwise-equal predictions", flush=True)

    # every level's real inputs, captured from one more round
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    cuda_hist.level_histogram = capture
    try:
        xt.train(PARAMS, dtrain, 1, device=device)
    finally:
        cuda_hist.level_histogram = kernel_fn
    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = kernel_fn(bins, gh, pos, M, nb, mode)
        want = cuda_hist.level_histogram_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want).abs().max()))
        if mode != "int" or not torch.equal(got, want):
            fail(f"main-path level n_node={M}: mode {mode}, kernel != plain")
    print(f"[main] kernel == plain, int8 bitwise, at all {len(captured)} "
          "main-path levels", flush=True)
    return launches, ms_round, captured, max_err


def phase_multiclass(torch, xt, kernels, device, card):
    """``bench_multiclass`` at full width, all 60 rounds, through K3."""
    from xgboost_tpu_torch.metrics import merror
    from xgboost_tpu_torch.ops import cuda_hist
    kb = kernels["hist_batched"]

    t0 = time.perf_counter()
    X, y = make_multiclass(MC_N + MC_TEST)
    dtrain = xt.DMatrix(X[:MC_N], label=y[:MC_N])
    dtest = xt.DMatrix(X[MC_N:], label=y[MC_N:])
    print(f"[multiclass] data {MC_N} + {MC_TEST} x {MC_FEAT}, {MC_K} "
          f"classes: {time.perf_counter() - t0:.2f} s", flush=True)

    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(MC_PARAMS, dtrain, MC_ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    launches = counts["hist_batched"]
    want = MC_ROUNDS * DEPTH
    print(f"[multiclass] train {MC_ROUNDS} rounds (cuts and binning "
          f"included): {train_s:.2f} s; hist_batched launches {launches}; "
          f"all counts {json.dumps(counts)}", flush=True)
    if counts != only(kernels, hist_batched=want):
        fail(f"launch counts {counts}: want hist_batched {want} "
             f"({MC_ROUNDS} rounds x {DEPTH} levels), the others 0")
    if bst.gbtree.num_trees != MC_ROUNDS * MC_K:
        fail(f"{bst.gbtree.num_trees} trees, want {MC_ROUNDS * MC_K}")

    pred = bst.predict(dtest)
    if pred.shape != (MC_TEST,) or not np.isfinite(pred).all():
        fail(f"holdout class predictions: shape {pred.shape}")
    margin = bst.predict(dtest, output_margin=True)
    if margin.shape != (MC_TEST, MC_K) or not np.isfinite(margin).all():
        fail(f"holdout margins: shape {margin.shape}")
    onehot = np.eye(MC_K, dtype=np.float32)[pred.astype(np.int64)]
    err = merror(onehot, y[MC_N:], np.ones(MC_TEST, np.float32))
    print(f"[multiclass] holdout merror {err:.6f} (floor {MERROR_FLOOR}; "
          "the JAX package 0.1827)", flush=True)
    if not err <= MERROR_FLOOR:
        fail(f"holdout merror {err} > {MERROR_FLOOR}")
    raw = bst.save_raw()

    # ms per round: a second booster, round 0 (cuts, binning) untimed
    bst2 = xt.Booster(MC_PARAMS, cache=[dtrain], device=device)
    bst2.update(dtrain, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst2.update_many(dtrain, 1, MC_ROUNDS - 1)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) * 1e3 / (MC_ROUNDS - 1)
    print(f"[multiclass] {ms_round:.3f} ms per round of {MC_K} trees | "
          f"{card}", flush=True)
    if bst2.save_raw() != raw:
        fail("a second int8 multiclass run gave different model bytes")

    kernel_fn = kb.level_histogram_batched
    kb.level_histogram_batched = kb.level_histogram_batched_plain
    try:
        plain = xt.train(MC_PARAMS, dtrain, MC_ROUNDS, device=device)
    finally:
        kb.level_histogram_batched = kernel_fn
    if plain.save_raw() != raw:
        fail("kernel and plain batched histograms grew different models")
    print("[multiclass] plain-histogram run: identical model bytes",
          flush=True)

    path = os.path.join(HERE, ".smoke_out", "smoke_multiclass.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bst.save_model(path)
    loaded = xt.Booster(model_file=path, device=device)
    if not (np.array_equal(loaded.predict(dtest), pred) and np.array_equal(
            loaded.predict(dtest, output_margin=True), margin)):
        fail("multiclass predictions changed over save_model / load_model")
    print("[multiclass] save/load: bitwise-equal predictions and margins",
          flush=True)
    loaded.set_param("objective", "multi:softprob")
    prob = loaded.predict(dtest)
    if prob.shape != (MC_TEST, MC_K) or not np.allclose(prob.sum(1), 1.0,
                                                        atol=1e-5) \
            or not np.array_equal(prob.argmax(1), pred.astype(np.int64)):
        fail(f"softprob output: shape {prob.shape}")
    print(f"[multiclass] softprob output shape {prob.shape}, rows sum to "
          "1, argmax == softmax classes", flush=True)

    # every level's real inputs, captured from one more round
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    kb.level_histogram_batched = capture
    try:
        xt.train(MC_PARAMS, dtrain, 1, device=device)
    finally:
        kb.level_histogram_batched = kernel_fn
    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = kernel_fn(bins, gh, pos, M, nb, mode)
        want_h = kb.level_histogram_batched_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want_h).abs().max()))
        if mode != "int" or not torch.equal(got, want_h):
            fail(f"multiclass level n_node={M}: mode {mode}, kernel != "
                 "plain")
        for t in range(gh.shape[0]):
            solo = cuda_hist.level_histogram(bins, gh[t].contiguous(),
                                             pos[t].contiguous(), M, nb,
                                             mode)
            if not torch.equal(got[..., t * M:(t + 1) * M], solo):
                fail(f"multiclass level n_node={M}: tree {t} != solo K1")
    print(f"[multiclass] K3 == plain and each tree == solo K1, int8 "
          f"bitwise, at all {len(captured)} levels of a round", flush=True)
    return launches, ms_round, captured, max_err, err


def phase_otto(torch, xt, kernels, device, card):
    """``bench_otto`` (93 features, 9 classes) cut to 10 rounds."""
    from xgboost_tpu_torch.metrics import mlogloss
    X, y = make_otto(OTTO_N + MC_TEST)
    dtrain = xt.DMatrix(X[:OTTO_N], label=y[:OTTO_N])
    dtest = xt.DMatrix(X[OTTO_N:], label=y[OTTO_N:])
    reset_counts(kernels)
    t0 = time.perf_counter()
    bst = xt.train(OTTO_PARAMS, dtrain, OTTO_ROUNDS, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    want = OTTO_ROUNDS * DEPTH
    if counts != only(kernels, hist_batched=want):
        fail(f"otto launch counts {counts}: want hist_batched {want}")
    prob = bst.predict(dtest)
    if prob.shape != (MC_TEST, OTTO_K) or not np.isfinite(prob).all():
        fail(f"otto softprob output: shape {prob.shape}")
    ll = mlogloss(prob, y[OTTO_N:], np.ones(MC_TEST, np.float32))
    print(f"[otto] {OTTO_N} x {OTTO_FEAT}, {OTTO_K} classes, "
          f"{OTTO_ROUNDS} rounds: {train_s:.2f} s (cuts and binning "
          f"included); hist_batched launches {counts['hist_batched']}; "
          f"holdout mlogloss {ll:.6f} (uniform {np.log(OTTO_K):.6f}) | "
          f"{card}", flush=True)
    if not ll < np.log(OTTO_K):
        fail(f"otto mlogloss {ll} is no better than uniform")


def depth0_margin_bound(torch, kn, captured):
    """The stated bound on depth-0 margins, K2 run against plain run.
    Per round and tree the two node sums differ by at most
    eG = 2 n 2^-24 sum|g| (eH likewise, the bound of [K2]); the leaf
    w = -eta G / (H + lambda) then moves by at most
    eta (eG (H + lambda) + |G| eH) / ((H + lambda) (H + lambda - eH)).
    Summed over the rounds and doubled for the first-order effect of a
    margin difference on the next round's gradients (a Newton step
    carries an offset d into the next leaf as about -eta d / 2 of its
    own class, and less of the others')."""
    eta, lam = D0_PARAMS["eta"], 1.0
    total = 0.0
    for gh, pos, M in captured:
        s = kn.node_stats_plain(gh, pos, M).double()
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M).double()
        a = kn.node_stats_plain(gh.abs(), pos, M).double()
        e = 2.0 * n * 2.0 ** -24 * a
        G, H = s[..., 0].abs(), s[..., 1] + lam
        dw = eta * (e[..., 0] * H + G * e[..., 1]) / (H * (H - e[..., 1]))
        total += float(dw.max())
    return 2.0 * total


def phase_depth0(torch, xt, kernels, device):
    """A max_depth=0 6-class booster: node statistics through K2."""
    kn = kernels["node_stats"]
    X, y = make_multiclass(MC_N)
    dtrain = xt.DMatrix(X, label=y)
    reset_counts(kernels)
    bst = xt.train(D0_PARAMS, dtrain, D0_ROUNDS, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    launches = counts["node_stats"]
    print(f"[depth0] {D0_ROUNDS} rounds of {MC_K} single-leaf trees; "
          f"node_stats launches {launches}; all counts "
          f"{json.dumps(counts)}", flush=True)
    if counts != only(kernels, node_stats=D0_ROUNDS):
        fail(f"depth-0 launch counts {counts}: want node_stats "
             f"{D0_ROUNDS}, the others 0")
    margin = bst.predict(dtrain, output_margin=True)
    kernel_fn = kn.node_stats
    captured = []

    def plain(gh, pos, n_node):
        captured.append((gh.clone(), pos.clone(), n_node))
        return kn.node_stats_plain(gh, pos, n_node)
    kn.node_stats = plain
    try:
        ref = xt.train(D0_PARAMS, dtrain, D0_ROUNDS, device=device)
    finally:
        kn.node_stats = kernel_fn
    diff = float(np.abs(ref.predict(dtrain, output_margin=True)
                        - margin).max())
    bound = depth0_margin_bound(torch, kn, captured)
    print(f"[depth0] margins vs the plain-node-stats run: max |diff| "
          f"{diff:.3e} (bound {bound:.3e})", flush=True)
    if not diff <= bound or not np.isfinite(margin).all():
        fail(f"depth-0 margins differ from the plain run by {diff} > "
             f"{bound}")
    again = xt.train(D0_PARAMS, dtrain, D0_ROUNDS, device=device)
    if again.save_raw() != bst.save_raw():
        fail("two depth-0 runs gave different model bytes")
    print("[depth0] a second run: identical model bytes (K2 sums in a "
          "fixed order)", flush=True)
    max_err = err_k2 = err_plain = 0.0
    for gh, pos, M in captured:
        got = kernel_fn(gh, pos, M)
        want = kn.node_stats_plain(gh, pos, M)
        n = kn.node_stats_plain(torch.ones_like(gh), pos, M)
        a = kn.node_stats_plain(gh.abs(), pos, M)
        torch.cuda.synchronize()
        if not sum_bound_ok(torch, got, want, n, a):
            fail("depth-0 node stats: |K2 - plain| beyond the bound")
        max_err = max(max_err, float((got - want).abs().max()))
        # which of the two is nearer the exact sums: float64 index_add_
        T, N, _ = gh.shape
        slot = torch.where(pos < 0, M, pos).to(torch.int64)
        idx = slot + (M + 1) * torch.arange(
            T, device=gh.device, dtype=torch.int64)[:, None]
        exact = torch.zeros((T * (M + 1), 2), dtype=torch.float64,
                            device=gh.device).index_add_(
            0, idx.reshape(-1), gh.reshape(-1, 2).double()).reshape(
            T, M + 1, 2)[:, :M]
        err_k2 = max(err_k2, float((got.double() - exact).abs().max()))
        err_plain = max(err_plain,
                        float((want.double() - exact).abs().max()))
    print(f"[depth0] K2 within 2 n 2^-24 sum|x| of plain at all "
          f"{len(captured)} rounds' inputs (max |diff| {max_err:.3e}); "
          f"max |error| against float64 sums: K2 {err_k2:.3e}, plain "
          f"{err_plain:.3e}", flush=True)
    return launches, captured[:1], max_err


def lane_runs(root, data, mode):
    """``run_tenant_lanes`` kwargs of the 48 tenants under ``root/mode``:
    a CallableDataSource each (the same pair every cycle), the holdout
    gate on AUC."""
    import shutil

    from xgboost_tpu_torch.pipeline import CallableDataSource
    base = os.path.join(root, mode)
    shutil.rmtree(base, ignore_errors=True)   # no state from an old run
    lanes = {}
    for i, pair in enumerate(data):
        d = os.path.join(base, f"tenant{i:02d}")
        lanes[f"tenant{i:02d}"] = {
            "publish_path": os.path.join(d, "model.bin"),
            "workdir": os.path.join(d, "work"),
            "source": CallableDataSource(lambda c, p=pair: p),
            "rounds_per_cycle": LANE_ROUNDS, "cycles": LANE_CYCLES,
            "metric": "auc", "params": dict(LANE_PARAMS)}
    return lanes


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def gate_verdicts(events):
    """{(lane, cycle): (passed, metric, candidate, incumbent)} of the
    ``pipeline.gate`` events."""
    out = {}
    for e in events:
        if e["kind"] == "event" and e["name"] == "pipeline.gate":
            a = e["attrs"]
            out[(a["lane"], a["cycle"])] = (a["passed"], a["metric"],
                                            a["candidate"], a["incumbent"])
    return out


def run_lanes(torch, kernels, root, data, mode, device):
    """One ``run_tenant_lanes`` over the tenants, counts set to 0 just
    before and read just after, its events logged to a file of its own.
    Returns (lanes, results, launch counts, lane-metric deltas, events,
    seconds)."""
    from xgboost_tpu_torch.obs import configure_log, lane_metrics
    from xgboost_tpu_torch.pipeline import run_tenant_lanes
    lanes = lane_runs(root, data, mode)
    log = os.path.join(root, f"events-{mode}.jsonl")
    if os.path.exists(log):
        os.remove(log)
    lm = lane_metrics()
    before = (lm.dispatches.value, lm.stacked.value, lm.padded.value,
              lm.restacks.value, lm.solo.values())
    configure_log(log)
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        # every tenant must reach the rendezvous before its window
        # closes: 48 lanes' host phases (cuts, binning) take seconds
        res = run_tenant_lanes(lanes, quiet=True, window_sec=300.0,
                               device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(kernels)
    finally:
        configure_log(None)
    solo = {k: v - before[4].get(k, 0.0) for k, v in lm.solo.values().items()}
    delta = {"dispatches": lm.dispatches.value - before[0],
             "stacked": lm.stacked.value - before[1],
             "padded": lm.padded.value - before[2],
             "restacks": lm.restacks.value - before[3],
             "solo": {k: v for k, v in solo.items() if v}}
    return lanes, res, counts, delta, read_events(log), seconds



def phase_lanes(torch, xt, kernels, device, card):
    """``run_tenant_lanes`` on 48 tenants, stacked (K4) and as the host
    loop (K1), with every check of the module docstring."""
    from xgboost_tpu_torch.metrics import auc
    root = os.path.join(HERE, ".smoke_out", "lanes")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    arrays = [tenant_arrays(i) for i in range(LANES_N)]
    data = [(xt.DMatrix(X, label=y), xt.DMatrix(Xh, label=yh))
            for X, y, Xh, yh in arrays]
    rows = [a[0].shape[0] for a in arrays]
    print(f"[lanes] data: {LANES_N} tenants of {min(rows)}-{max(rows)} x "
          f"{N_FEAT} rows, {LANE_HOLD} holdout rows each: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 1. stacked (the default)
    os.environ.pop("XGBTPU_LANE_STACK", None)
    s_lanes, s_res, counts, delta, s_events, s_sec = run_lanes(
        torch, kernels, root, data, "stacked", device)
    want = LANE_CYCLES * LANE_ROUNDS * DEPTH
    print(f"[lanes] stacked run: {s_sec:.2f} s; hist_lanes launches "
          f"{counts['hist_lanes']}; all counts {json.dumps(counts)}; lane "
          f"metrics {json.dumps(delta)} | {card}", flush=True)
    bad = {n: r for n, r in s_res.items() if r["status"] != "ok"}
    if bad or len(s_res) != LANES_N:
        fail(f"stacked lanes not ok: {bad}")
    if counts != only(kernels, hist_lanes=want):
        fail(f"stacked launch counts {counts}: want hist_lanes {want} "
             f"({LANE_CYCLES} cycles x {LANE_ROUNDS} rounds x {DEPTH} "
             "levels), the others 0")
    stack_errors = [e for e in s_events
                    if e["name"] in ("lanes.stack_error", "lanes.solo")]
    if delta["solo"] or stack_errors:
        fail(f"a lane ran solo in the stacked run: {delta['solo']} "
             f"{stack_errors[:3]}")
    want_delta = {"dispatches": LANE_CYCLES,
                  "stacked": LANES_N * LANE_CYCLES,
                  "padded": (LANE_STACK - LANES_N) * LANE_CYCLES}
    if any(delta[k] != v for k, v in want_delta.items()):
        fail(f"lane dispatch accounting {delta}: want {want_delta}")
    for name, kw in s_lanes.items():
        with open(os.path.join(kw["workdir"], "gated.log")) as f:
            cycles = [int(line.split()[0]) for line in f]
        if not cycles or cycles[0] != 0:
            fail(f"{name} did not publish its cycle-0 model: {cycles}")
    spans = {}
    for e in s_events:
        if e["kind"] == "span":
            spans.setdefault(e["name"], []).append(e["dur_ms"])
    print("[lanes] stacked run spans, ms summed over the lane threads "
          "(they overlap): " + json.dumps(
              {k: round(sum(v), 1) for k, v in sorted(spans.items())})
          + "; lanes.dispatch each: "
          + json.dumps(spans.get("lanes.dispatch", [])), flush=True)
    print(f"[lanes] {LANES_N} tenants ok, each published its cycle-0 model; "
          f"{delta['dispatches']} dispatches carried {delta['stacked']} "
          f"lane-segments and {delta['padded']} pad lanes; no solo lane, "
          "no stack error", flush=True)

    # 2. the host loop, same tenants
    os.environ["XGBTPU_LANE_STACK"] = "0"
    try:
        h_lanes, h_res, h_counts, _, h_events, h_sec = run_lanes(
            torch, kernels, root, data, "host", device)
    finally:
        os.environ.pop("XGBTPU_LANE_STACK", None)
    want_k1 = LANES_N * want
    print(f"[lanes] host loop: {h_sec:.2f} s; all counts "
          f"{json.dumps(h_counts)} | {card}", flush=True)
    if h_counts != only(kernels, hist_level=want_k1):
        fail(f"host-loop launch counts {h_counts}: want hist_level "
             f"{want_k1}, the others 0")
    if any(r["status"] != "ok" for r in h_res.values()):
        fail("host-loop lanes not ok")
    for name in s_lanes:
        logs = []
        for lanes in (s_lanes, h_lanes):
            with open(lanes[name]["publish_path"], "rb") as f:
                raw = f.read()
            with open(os.path.join(lanes[name]["workdir"],
                                   "gated.log")) as f:
                logs.append((raw, f.read()))
        if logs[0] != logs[1]:
            fail(f"{name}: stacked and host-loop published models differ")
    sv, hv = gate_verdicts(s_events), gate_verdicts(h_events)
    if sv != hv or len(sv) != LANES_N * LANE_CYCLES:
        fail(f"gate verdicts differ: {len(sv)} stacked, {len(hv)} host")
    print(f"[lanes] stacked == host loop: every tenant's published model "
          f"bytes and ledger (its published bytes in each cycle) "
          f"identical, all {len(sv)} gate verdicts identical", flush=True)

    # 3. quality on each tenant's holdout
    aucs = []
    for i, (name, kw) in enumerate(s_lanes.items()):
        bst = xt.Booster(model_file=kw["publish_path"], device=device)
        pred = bst.predict(data[i][1])
        if pred.shape != (LANE_HOLD,) or not np.isfinite(pred).all():
            fail(f"{name}: holdout predictions {pred.shape}")
        aucs.append(auc(pred, arrays[i][3], np.ones(LANE_HOLD, np.float32)))
    print(f"[lanes] holdout AUC min {min(aucs):.6f} mean "
          f"{float(np.mean(aucs)):.6f} max {max(aucs):.6f} (floor "
          f"{LANE_AUC_FLOOR}: the JAX package's lowest 0.920299 - 0.005)",
          flush=True)
    if not min(aucs) >= LANE_AUC_FLOOR:
        fail(f"tenant holdout AUC {min(aucs)} < {LANE_AUC_FLOOR}")
    return counts["hist_lanes"], data, rows, (s_sec, h_sec), min(aucs)


def lanes_round_inputs(torch, xt, k4, data, device):
    """Every level's K4 inputs of one stacked round of all tenants."""
    from xgboost_tpu_torch.pipeline.lanes import LaneGang, _Arrival, _bucket_of
    kernel_fn = k4.level_histogram_lanes
    captured = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        captured.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    arrs = []
    for i, (d, _) in enumerate(data):
        bst = xt.Booster(LANE_PARAMS, [d], device=device)
        spec, why = bst.fused_lane_spec(d, 0, 1)
        if spec is None:
            fail(f"tenant {i} declined stacking: {why}")
        arrs.append(_Arrival(f"tenant{i:02d}", spec, lambda it: None))
    k4.level_histogram_lanes = capture
    try:
        LaneGang(expected=0)._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
    finally:
        k4.level_histogram_lanes = kernel_fn
    if any(a.exc is not None for a in arrs) or len(captured) != DEPTH:
        fail(f"one stacked round: {len(captured)} K4 levels, errors "
             f"{[a.exc for a in arrs if a.exc is not None][:2]}")
    return captured


def check_lanes_levels(torch, k4, cuda_hist, captured, rows):
    """At every level of one stacked round, on its real inputs: K4 ==
    plain, each tenant's slice == a solo K1 launch on its unpadded rows,
    the pad lanes' slices zero."""
    max_err = 0.0
    for bins, gh, pos, M, nb, mode in captured:
        got = k4.level_histogram_lanes(bins, gh, pos, M, nb, mode)
        want = k4.level_histogram_lanes_plain(bins, gh, pos, M, nb, mode)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want).abs().max()))
        if mode != "int" or not torch.equal(got, want):
            fail(f"lanes level n_node={M}: mode {mode}, K4 != plain")
        for lane in range(bins.shape[0]):
            sl = got[..., lane * M:(lane + 1) * M]
            if lane >= len(rows):
                if bool(sl.any()):
                    fail(f"lanes level n_node={M}: pad lane {lane} not 0")
                continue
            n = rows[lane]
            solo = cuda_hist.level_histogram(
                bins[lane, :n].contiguous(), gh[lane, :n].contiguous(),
                pos[lane, :n].contiguous(), M, nb, mode)
            if not torch.equal(sl, solo):
                fail(f"lanes level n_node={M}: tenant {lane} != solo K1")
    print(f"[lanes] K4 == plain and each tenant == solo K1 on its "
          f"unpadded rows, int8 bitwise, pad lanes zero, at all "
          f"{len(captured)} levels of a stacked round", flush=True)
    return max_err


# ------------------------------------------------------------- phase 5
def plan_text(kb, name, N, F, nb, T, M, mode, dev):
    """The scatter launch plan K1, K3 or K4 takes at this level."""
    p = kb.launch_plan(name, N, F, nb, T, M, mode, dev)
    return (f"plan f_tile {p.f_tile} t_tile {p.t_tile} m_tile {p.m_tile} "
            f"units {p.n_units} copies {p.copies} blocks {p.grid} rows a "
            f"step {p.rows_per_step} {'store' if p.store else 'atomic'} "
            "flush")


def phase_times(torch, cuda_hist, captured, card):
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    rows = []
    for bins, gh, pos, M, nb, mode in captured:
        N, F = bins.shape
        active = int((pos >= 0).sum())
        ms = cuda_ms(torch, lambda: cuda_hist.level_histogram(
            bins, gh, pos, M, nb, mode), 20)
        dev_ms, _ = profiled_ms(torch, lambda: cuda_hist.level_histogram(
            bins, gh, pos, M, nb, mode))
        plain_ms = cuda_ms(torch, lambda: cuda_hist.level_histogram_plain(
            bins, gh, pos, M, nb, mode), 5)
        # one PyTorch call for the same sums: index_add_ on flat cell
        # indices computed beforehand (inactive rows to a dump cell)
        f_ids = torch.arange(F, device=bins.device, dtype=torch.int64)
        base = ((f_ids[None, :] * nb + bins.to(torch.int64)) * 2) * M \
            + pos.to(torch.int64)[:, None]
        idx = base[:, :, None] + torch.tensor([0, M], device=bins.device)
        idx = torch.where((pos >= 0)[:, None, None], idx, F * nb * 2 * M)
        idx = idx.reshape(-1)
        src = gh[:, None, :].expand(N, F, 2).reshape(-1)
        out = torch.zeros(F * nb * 2 * M + 1, dtype=gh.dtype,
                          device=bins.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 5)
        # least work: every row's pos, the active rows' bins and gh, the
        # histogram written once; one addition per (active row, feature,
        # channel)
        nbytes = 4 * N + active * (F + 8) + F * nb * 2 * M * 4
        ops = active * F * 2
        bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S) * 1e3
        by = "bytes" if nbytes / PEAK_BYTES_S >= ops / PEAK_OPS_S \
            else "operations"
        plan = plan_text(kb, "hist_level", N, F, nb, 1, M, mode, bins.device)
        rows.append(dict(n_node=M, active_rows=active, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
        print(f"[time] K1 n_node={M}: {ms:.4f} ms, device {dev_ms:.4f} ms "
              f"(bound {bound_ms:.4f} ms, {by}; plain {plain_ms:.4f} ms; "
              f"index_add_ {lib_ms:.4f} ms; {plan}) | {card}", flush=True)
    return rows


def bound_of(nbytes, ops):
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``ops``
    f32 operations at the card's peak rates."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_k3(torch, kb, captured, card):
    rows = []
    for bins, gh, pos, M, nb, mode in captured:
        N, F = bins.shape
        T = gh.shape[0]
        act = pos >= 0
        pairs = int(act.sum())
        any_rows = int(act.any(dim=0).sum())
        ms = cuda_ms(torch, lambda: kb.level_histogram_batched(
            bins, gh, pos, M, nb, mode), 20)
        dev_ms, _ = profiled_ms(torch, lambda: kb.level_histogram_batched(
            bins, gh, pos, M, nb, mode))
        plain_ms = cuda_ms(torch, lambda: kb.level_histogram_batched_plain(
            bins, gh, pos, M, nb, mode), 5)
        # one PyTorch call for the same sums: index_add_ over flat cell
        # indices of all T trees computed beforehand (inactive to a dump)
        cells = F * nb * 2 * T * M
        f_ids = torch.arange(F, device=bins.device, dtype=torch.int64)
        col = (torch.arange(T, device=bins.device, dtype=torch.int64)[:, None]
               * M + pos.to(torch.int64))                      # (T, N)
        base = ((f_ids[None, None, :] * nb + bins.to(torch.int64)[None])
                * 2) * (T * M) + col[:, :, None]               # (T, N, F)
        idx = base[..., None] + torch.tensor([0, T * M], device=bins.device)
        idx = torch.where(act[:, :, None, None], idx, cells).reshape(-1)
        src = gh[:, :, None, :].expand(T, N, F, 2).reshape(-1)
        out = torch.zeros(cells + 1, dtype=gh.dtype, device=bins.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 5)
        del idx, src, base
        # least work: every tree's pos, the bins of rows active in some
        # tree, the active (tree, row) pairs' gh, the histogram written
        # once; one addition per (active pair, feature, channel)
        bound_ms, by = bound_of(4 * T * N + any_rows * F + 8 * pairs
                                + cells * 4, pairs * F * 2)
        plan = plan_text(kb, "hist_batched", N, F, nb, T, M, mode,
                         bins.device)
        rows.append(dict(n_node=M, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by))
        print(f"[time] K3 T={T} n_node={M}: {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms (bound {bound_ms:.4f} ms, {by}; plain "
              f"{plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms; {plan}) | "
              f"{card}", flush=True)
    return rows


def time_k2(torch, kn, captured, card):
    rows = []
    for gh, pos, M in captured:
        T, N, _ = gh.shape
        active = int((pos >= 0).sum())
        ms = cuda_ms(torch, lambda: kn.node_stats(gh, pos, M), 20)
        dev_ms, acts = profiled_ms(torch, lambda: kn.node_stats(gh, pos, M))
        if len(acts) != 1 or list(acts.values()) != [1.0] \
                or "node_stats" not in next(iter(acts)):
            fail(f"K2 T={T} n_node={M}: a call issued {acts}, not one "
                 "kernel")
        plain_ms = cuda_ms(torch, lambda: kn.node_stats_plain(gh, pos, M),
                           20)
        slot = torch.where(pos < 0, M, pos).to(torch.int64)
        idx = (slot + (M + 1) * torch.arange(
            T, device=gh.device, dtype=torch.int64)[:, None]).reshape(-1)
        src = gh.reshape(-1, 2)
        out = torch.zeros((T * (M + 1), 2), dtype=torch.float32,
                          device=gh.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 20)
        bound_ms, by = bound_of(4 * T * N + 8 * active + T * M * 8,
                                2 * active)
        rows.append(dict(n_node=M, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by))
        print(f"[time] K2 T={T} n_node={M}: {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms, one kernel a call (bound {bound_ms:.4f} "
              f"ms, {by}; plain {plain_ms:.4f} ms; index_add_ "
              f"{lib_ms:.4f} ms) | {card}", flush=True)
    return rows


def time_k4(torch, k4, captured, card):
    from xgboost_tpu_torch.ops import cuda_hist_batched as kb
    rows = []
    for bins, gh, pos, M, nb, mode in captured:
        L, N, F = bins.shape
        active = int((pos >= 0).sum())
        ms = cuda_ms(torch, lambda: k4.level_histogram_lanes(
            bins, gh, pos, M, nb, mode), 20)
        dev_ms, _ = profiled_ms(torch, lambda: k4.level_histogram_lanes(
            bins, gh, pos, M, nb, mode))
        plain_ms = cuda_ms(torch, lambda: k4.level_histogram_lanes_plain(
            bins, gh, pos, M, nb, mode), 5)
        # one PyTorch call for the same sums: index_add_ over all lanes'
        # flat cell indices computed beforehand (inactive to a dump cell)
        cells = F * nb * 2 * L * M
        idx = k4.lane_cell_index(bins, pos, M, nb).reshape(-1)
        src = gh[:, :, None, :].expand(L, N, F, 2).reshape(-1)
        out = torch.zeros(cells + 1, dtype=gh.dtype, device=bins.device)
        lib_ms = cuda_ms(torch, lambda: out.index_add_(0, idx, src), 5)
        del idx, src
        # least work: every row's pos, the active rows' bins and gh, the
        # histogram written once; one addition per (active row, feature,
        # channel)
        bound_ms, by = bound_of(4 * L * N + active * (F + 8) + cells * 4,
                                active * F * 2)
        plan = plan_text(kb, "hist_lanes", N, F, nb, L, M, mode,
                         bins.device)
        rows.append(dict(n_node=M, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by))
        print(f"[time] K4 L={L} n_node={M}: {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms (bound {bound_ms:.4f} ms, {by}; plain "
              f"{plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms; {plan}) | "
              f"{card}", flush=True)
    return rows


def time_lane_cycles(torch, xt, data, device, card):
    """The training step the lane dispatcher changes, as
    ``tools/bench_lanes.py`` times it (gate, publish and ledger left
    out): per cycle, the 48 tenants' boosters each advance LANE_ROUNDS
    rounds, as 48 ``update_many`` calls (the host loop's boost path) or
    as one ``LaneGang`` bucket dispatch (rendezvous cost aside: the
    lanes are handed over at once).  Cycle 0 (cuts, binning, first
    launches) is left out; cycles 1-3 alternate host loop and stacked
    on one card.  Both end with the same model bytes per tenant."""
    from xgboost_tpu_torch.pipeline.lanes import LaneGang, _Arrival, _bucket_of

    def boosters():
        return [(xt.Booster(LANE_PARAMS, [d], device=device), d)
                for d, _ in data]
    host, stacked = boosters(), boosters()
    gang = LaneGang(expected=0)
    host_ts, stacked_ts = [], []
    for c in range(4):
        it0 = c * LANE_ROUNDS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, d in host:
            b.update_many(d, it0, LANE_ROUNDS)
        torch.cuda.synchronize()
        host_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        arrs = [_Arrival(f"tenant{i:02d}",
                         b.fused_lane_spec(d, it0, LANE_ROUNDS)[0],
                         lambda it: None)
                for i, (b, d) in enumerate(stacked)]
        gang._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
        torch.cuda.synchronize()
        stacked_ts.append(time.perf_counter() - t0)
        if any(a.exc is not None for a in arrs):
            fail(f"bench cycle {c}: a lane failed")
    if any(bs.save_raw() != bh.save_raw()
           for (bs, _), (bh, _) in zip(stacked, host)):
        fail("bench: stacked and host-loop boosters differ in bytes")
    h_ms = [t * 1e3 for t in host_ts[1:]]
    s_ms = [t * 1e3 for t in stacked_ts[1:]]
    h, st = float(np.mean(h_ms)), float(np.mean(s_ms))
    print(f"[time] lanes cycle ({LANES_N} tenants x {LANE_ROUNDS} rounds, "
          f"gate and publish left out): host loop {h:.3f} ms "
          f"({[round(x, 3) for x in h_ms]}; {LANES_N / h * 1e3:.4g} "
          f"tenants/s), stacked {st:.3f} ms ({[round(x, 3) for x in s_ms]}; "
          f"{LANES_N / st * 1e3:.4g} tenants/s); cycle 0 (setup) host "
          f"{host_ts[0] * 1e3:.1f} ms, stacked {stacked_ts[0] * 1e3:.1f} "
          f"ms; identical model bytes | {card}", flush=True)
    return h, st


# ------------------------------------------------------------- [onehot]
# The one-hot tensor-core kernels (T5, T3, T2, T7; the bf16 family T1,
# T4a, T4b, T6) and the TPU prototypes they replace (the Pallas kernel
# body of each)
ONEHOT_SOURCES = {
    "onehot_variant": ("xgboost_tpu_torch/csrc/onehot_variant.cu",
                       "tools/hist_microbench.py:26"),
    "onehot_i8": ("xgboost_tpu_torch/csrc/onehot_i8.cu",
                  "tools/hist_int8_proto.py:31"),
    "onehot_notrans": ("xgboost_tpu_torch/csrc/onehot_notrans.cu",
                       "tools/hist_notrans_proto.py:28"),
    "onehot_r5": ("xgboost_tpu_torch/csrc/onehot_r5.cu",
                  "tools/hist_r5_ab.py:41"),
    "onehot_group": ("xgboost_tpu_torch/csrc/onehot_group.cu",
                     "tools/hist_group_proto.py:23"),
    "onehot_pack2": ("xgboost_tpu_torch/csrc/onehot_pack2.cu",
                     "tools/hist_pack2_proto.py:29"),
    "onehot_onebig": ("xgboost_tpu_torch/csrc/onehot_pack2.cu",
                      "tools/hist_pack2_proto.py:143"),
    "onehot_r4": ("xgboost_tpu_torch/csrc/onehot_r4.cu",
                  "tools/hist_r4_ab.py:35"),
}
# H100 SXM dense tensor-core peaks (NVIDIA data sheet): the one-hot
# product's floor, printed beside the function's bound
PEAK_INT8_OPS_S = 1979e12
PEAK_BF16_OPS_S = 989e12
# launches of each kernel by the four ported mains at their defaults:
# a warm-up and the timed calls per level or variant, plus T3's and T2's
# accuracy launch; K1 timed beside them
ONEHOT_MAIN_LAUNCHES = {
    "onehot_variant": 6 * 21, "onehot_i8": 6 * 201 + 1,
    "onehot_notrans": 6 * 201 + 1, "onehot_r5": 6 * 41 + 21,
    "hist_level": 21 + 6 * 201 + 6 * 201 + 3 * 41}
# launches by the bf16 mains at their defaults (T1: 20 calls after a
# warm-up for each of 4 x 3 (fg, r_tile) and one accuracy launch; T4a:
# 30 + 1 for prod and pack2 at 6 levels, and one of each for the M = 32
# match; T4b: 30 + 1 at 6 levels x 2 r_tiles, and its match against one
# prod; T6: 30 + 1 for 6 variants); K1 timed beside them (T1: and its
# fp32 accuracy reference)
ONEHOT_BF16_MAIN_LAUNCHES = {
    "onehot_group": 12 * 21 + 1, "onehot_pack2": 6 * 2 * 31 + 2 + 1,
    "onehot_onebig": 6 * 2 * 31 + 1, "onehot_r4": 6 * 31,
    "hist_level": 1 + 21 + 6 * 31 + 6 * 31 + 31}
# the mains' row count (bench.py's Higgs size)
OH_N = 1_000_000
T5_CHECK_KW = [dict(precision="bf16"),
               dict(precision="bf16", hot_dtype="bfloat16",
                    bin_dtype="int16"),
               dict(precision="fp32"),
               dict(precision="fp32", bin_dtype="int16", r_tile=2048)]


def onehot_int_case(torch, oh, cuda_hist, kernel, n, F, B, M, seed, dev,
                    n_levels=1, mode="prod", r_tile=2048):
    """One int comparison (T3, T2 or T7) on the same CUDA tensors: the
    kernel against its plain version, bitwise, on gh beyond the int8 range
    (wrapped) and a row count past the last whole tile (dropped); T7 with
    pad rows (pos -1, random gh) past the 97% real ones; T3 and T2 at
    ``r_tile`` with 2% of the bins out of range (T3: -1, 256, 1000, B,
    255; T2: B, 255), which add nothing to their feature.  Then, on whole
    tiles, in-range bins and gh in the int8 range, the kernel (one level)
    re-laid to (F, B, 2, M) against a K1 int launch, bitwise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fr = kernel != "onehot_notrans"
    dt = torch.int32 if kernel == "onehot_i8" else torch.uint8
    bins = torch.randint(0, B, (F, n) if fr else (n, F), generator=g,
                         device=dev, dtype=torch.int32).to(dt)
    planted = bins
    if kernel != "onehot_r5":
        bad = torch.tensor([-1, 256, 1000, B, 255] if fr else [B, 255],
                           device=dev)
        hit = torch.rand(bins.shape, generator=g, device=dev) < 0.02
        pick = torch.randint(0, len(bad), bins.shape, generator=g,
                             device=dev)
        planted = torch.where(hit, bad[pick].to(torch.int32),
                              bins.to(torch.int32)).to(dt)
    pos = torch.randint(0, M, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if kernel == "onehot_r5":
        pos[int(n * 0.97):] = -1
    else:
        pos[torch.rand(n, generator=g, device=dev) < 0.2] = -1
    gh = torch.randint(-300, 300, (n, 2), generator=g, device=dev,
                       dtype=torch.int32)

    def call(fn, b, p, q):
        if kernel == "onehot_r5":
            return fn(b, p[None, :], q.t().contiguous(), B, n_levels, mode)
        return fn(b, p[:, None], q, M, B, r_tile)
    tag = (f"{kernel} N={n} F={F} B={B} M={M} levels={n_levels} "
           f"mode={mode} r_tile={r_tile}")
    got = call(getattr(oh, kernel), planted, pos, gh)
    want = call(getattr(oh, kernel + "_plain"), planted, pos, gh)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"{tag}: not bitwise equal to the plain version")
    if n_levels > 1:
        return
    if kernel == "onehot_r5":
        r_tile = oh.R5_R_TILE
    n_used = (n // r_tile) * r_tile
    bins_w = (bins[:, :n_used] if fr else bins[:n_used]).contiguous()
    pos_w = pos[:n_used].contiguous()
    gh8 = gh[:n_used].clamp(-127, 127).contiguous()
    got = call(getattr(oh, kernel), bins_w, pos_w, gh8)
    k1 = cuda_hist.level_histogram(
        (bins_w.t() if fr else bins_w).contiguous().to(torch.uint8), gh8,
        pos_w, M, B, "int")
    torch.cuda.synchronize()
    if not torch.equal(got[0].reshape(F, B, 2, M), k1):
        fail(f"{tag}: differs from a K1 int launch on the same inputs")


def onehot_variant_case(torch, oh, n, F, B, n_node, kw, seed, dev):
    """One T5 comparison on the same CUDA tensors: bitwise on gh exact in
    bf16 (multiples of 1/64 below 2: f32 sums exact in any order), within
    2 n 2^-24 sum|x| on random gh.  Returns max |kernel - plain|."""
    kw = {k: getattr(torch, v) if k.endswith("dtype") else v
          for k, v in kw.items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                         dtype=torch.int32)
    pos = torch.randint(-1, n_node + 10, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    tag = f"onehot_variant N={n} F={F} B={B} n_node={n_node} {kw}"
    dy = torch.randint(-128, 128, (n, 2), generator=g, device=dev,
                       dtype=torch.int32).to(torch.float32) / 64.0
    got = oh.onehot_variant(bins, dy, pos, n_node, B, **kw)
    want = oh.onehot_variant_plain(bins, dy, pos, n_node, B, **kw)
    torch.cuda.synchronize()
    if got.shape != (n_node, F, B, 2) or not torch.equal(got, want):
        fail(f"{tag}: not bitwise equal to the plain version on gh exact "
             "in bf16")
    gh = torch.randn(n, 2, generator=g, device=dev)
    got = oh.onehot_variant(bins, gh, pos, n_node, B, **kw)
    want = oh.onehot_variant_plain(bins, gh, pos, n_node, B, **kw)
    src = gh.to(torch.bfloat16).float() if oh._variant_rounds(
        kw.get("precision", "bf16"), kw.get("hot_dtype", torch.float32)) \
        else gh
    cnt = oh.onehot_variant_plain(bins, torch.ones_like(gh), pos, n_node, B,
                                  "fp32")
    a = oh.onehot_variant_plain(bins, src.abs(), pos, n_node, B, "fp32")
    if not sum_bound_ok(torch, got, want, cnt, a):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x| on random gh")
    return float((got - want).abs().max())


def sass_check(nvcc, name, tag, gmma="HGMMA", mma="HMMA"):
    """The built library of ``csrc/<name>.cu`` runs wgmma: its SASS
    holds ``gmma`` instructions (HGMMA for bf16, IGMMA for s8) and no
    mma.sync ones (``mma``: HMMA, IMMA)."""
    built, = nvcc.build([name])
    cuobjdump = os.path.join(os.path.dirname(nvcc.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(built.path)],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"{tag} cuobjdump -sass {built.path.name}: {sass.stderr[-500:]}")
    n_gmma = sass.stdout.count(gmma)
    n_mma = sass.stdout.count(mma)
    if n_gmma == 0 or n_mma:
        fail(f"{tag} {name}: {n_gmma} {gmma} and {n_mma} {mma} instructions "
             f"in its SASS; the wgmma kernel has {gmma} only")
    print(f"{tag} {name}: SASS holds {n_gmma} {gmma} instructions, no "
          f"{mma}", flush=True)


def phase_onehot_checks(torch, oh, cuda_hist, nvcc, dev):
    """Each one-hot kernel against its plain version in every mode, at
    the mains' shapes and beyond (T3 and T2 at every N of their small-N
    form, above 32 nodes, in two node tiles, at B = 1, 8, 255 on five
    features, F = 3 and r_tile = 1000; T7 at B = 1, 8, 255, five features
    and 2, 6 and 8 levels); each int kernel against K1; T5's library
    holds bf16 wgmma (HGMMA) and no mma.sync, T7's, T3's and T2's integer
    wgmma (IGMMA) and no integer mma.sync (IMMA)."""
    n_pad = -(-OH_N // 8192) * 8192     # the T3 and T2 mains' rows
    n_r5 = -(-OH_N // 2048) * 2048      # the T7 main's rows
    n_odd = 2048 * 50 + 333             # a dropped tail
    # (n, F, B, M, r_tile): the mains' M = 1, 4, 32, then M = 2, 3, 5, 8,
    # 16 (N = 8-64), 33 (N = 128), 100 (two node tiles), B = 1, 8, 255 on
    # five features, F = 3 (T2 a byte a load) and r_tile = 1000
    int_cases = ([(n_pad, 28, 64, m, 2048) for m in (1, 4, 32)]
                 + [(n_odd, 28, 64, m, 2048) for m in (2, 3, 5, 8, 16, 33)]
                 + [(2048 * 20 + 100, 28, 64, 100, 2048),
                    (n_odd, 28, 67, 8, 2048), (n_odd, 5, 1, 4, 2048),
                    (n_odd, 5, 8, 16, 2048), (n_odd, 5, 255, 4, 2048),
                    (5000, 3, 7, 3, 2048), (20001, 3, 64, 32, 2048),
                    (n_odd, 28, 64, 8, 1000)])
    for kernel in ("onehot_i8", "onehot_notrans"):
        for n, F, B, M, r_tile in int_cases:
            onehot_int_case(torch, oh, cuda_hist, kernel, n, F, B, M,
                            seed=n % 97 + M + B, dev=dev, r_tile=r_tile)
            print(f"[onehot] {kernel} N={n} F={F} B={B} M={M} r_tile="
                  f"{r_tile}: bitwise == plain (int8 wrap, dropped tail, "
                  "bins out of range), == K1 int", flush=True)
    for mode in ("prod", "u8cmp"):
        # then the odd shapes: B = 1, 8, 255 on five features, and level
        # groups of 2 and 4 (2 and 8 levels)
        for n, F, B, nl in [(n_r5, 28, 67, 1), (n_r5, 28, 64, 1),
                            (n_r5, 28, 32, 1), (n_r5, 28, 64, 6),
                            (2048 * 20 + 100, 28, 67, 8),
                            (2048 * 50 + 333, 5, 1, 1),
                            (2048 * 50 + 333, 5, 8, 1),
                            (2048 * 50 + 333, 5, 255, 1),
                            (2048 * 20 + 100, 28, 64, 2),
                            (2048 * 20 + 100, 5, 255, 8)]:
            onehot_int_case(torch, oh, cuda_hist, "onehot_r5", n, F, B, 64,
                            seed=B + nl + F, dev=dev, n_levels=nl, mode=mode)
            print(f"[onehot] onehot_r5 {mode} N={n} F={F} B={B} levels={nl}:"
                  " bitwise == plain (pad rows, floor-mod)"
                  + (", == K1 int" if nl == 1 else ""), flush=True)
    sass_check(nvcc, "onehot_variant", "[onehot]")
    sass_check(nvcc, "onehot_r5", "[onehot]", "IGMMA", "IMMA")
    sass_check(nvcc, "onehot_i8", "[onehot]", "IGMMA", "IMMA")
    sass_check(nvcc, "onehot_notrans", "[onehot]", "IGMMA", "IMMA")
    err = 0.0
    # then F Bp not a multiple of 64, rows not a multiple of the row step,
    # one node
    for n, F, B, n_node in [(OH_N, 28, 67, 5), (OH_N, 28, 67, 64),
                            (OH_N, 28, 67, 128), (3000, 3, 7, 3),
                            (OH_N + 37, 5, 67, 1), (OH_N + 37, 5, 67, 70)]:
        for kw in T5_CHECK_KW:
            err = max(err, onehot_variant_case(torch, oh, n, F, B, n_node,
                                               kw, seed=n_node, dev=dev))
        print(f"[onehot] onehot_variant N={n} F={F} B={B} n_node={n_node}: "
              "bf16 / fp32 (int32 and int16 bins) bitwise on bf16-exact gh, "
              "within bound on random gh", flush=True)
    print(f"[onehot] onehot_variant max |kernel - plain| on random gh: "
          f"{err}", flush=True)
    return {"onehot_variant": err, "onehot_i8": 0.0, "onehot_notrans": 0.0,
            "onehot_r5": 0.0}


def bf16_fr_inputs(torch, n, F, B, M, seed, dev, planted=None):
    """T4 / T6 inputs on the card: feature-major int32 bins (2% past B: in
    [B, 255), or drawn from ``planted``), pos over [-1, M + 6), gh exact
    in bf16 (multiples of 1/64 below 2: f32 sums exact in any order) and
    random."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (F, n), generator=g, device=dev,
                         dtype=torch.int32)
    bad = torch.rand(F, n, generator=g, device=dev) < 0.02
    if planted is None:
        bins[bad] = torch.randint(B, 255, (int(bad.sum()),), generator=g,
                                  device=dev, dtype=torch.int32)
    else:
        vals = torch.tensor(planted, device=dev, dtype=torch.int32)
        bins[bad] = vals[torch.randint(0, len(planted), (int(bad.sum()),),
                                       generator=g, device=dev)]
    pos = torch.randint(-1, M + 6, (n, 1), generator=g, device=dev,
                        dtype=torch.int32)
    dy = torch.randint(-128, 128, (n, 2), generator=g, device=dev,
                       dtype=torch.int32).float() / 64.0
    gh = torch.randn(n, 2, generator=g, device=dev)
    return bins, pos, dy, gh


def bf16_case(torch, oh, kernel, args_of, kw, dy, gh, tag):
    """One bf16 kernel against its plain version on the same CUDA
    tensors: bitwise on ``dy`` (exact in bf16), within 2 n 2^-24 sum|x|
    on ``gh``.  ``args_of(g)`` are the call's arguments with gh = g.
    Returns (max |kernel - plain| on gh, the kernel's result on dy)."""
    fn, plain = getattr(oh, kernel), getattr(oh, kernel + "_plain")
    got_dy = fn(*args_of(dy), **kw)
    want = plain(*args_of(dy), **kw)
    torch.cuda.synchronize()
    if not torch.equal(got_dy, want):
        fail(f"{tag}: not bitwise equal to the plain version on gh exact "
             "in bf16")
    args = args_of(gh)
    got, want = fn(*args, **kw), plain(*args, **kw)
    if not onehot_bound_ok(torch, plain, args, kw, got, want,
                           GH_ARG[kernel]):
        fail(f"{tag}: |kernel - plain| beyond 2 n 2^-24 sum|x| on random gh")
    return float((got - want).abs().max()), got_dy


def phase_onehot_bf16_checks(torch, oh, nvcc, dev):
    """T1, T4a, T4b and T6 against their plain versions at the mains'
    shapes and beyond: T4 and T6 with a dropped tail and bins past B, T4b
    and T6's u8bins and i16hot equal to prod bitwise on bf16-exact gh, T4
    at F = 5 and 6, B = 1, 8, 255, M = 3, 5, 33, 100 and r_tile = 1000 and
    300,
    T1 at several node counts (70: two node tiles, the second partial),
    every fg and r_tile of its main, F Bp not a multiple of 64, rows not a
    multiple of the row step, one node, and a planted out-of-range bin
    that leaves its row in the group's other features; T6 in every mode
    on rows that are not a multiple of its row step (r_tile = 1000) and
    F Bp not a multiple of 64; T1's, T6's and T4's libraries hold wgmma
    (HGMMA) and no mma.sync."""
    errs = {k: 0.0 for k in ("onehot_group", "onehot_pack2",
                             "onehot_onebig", "onehot_r4")}
    n = -(-OH_N // 8192) * 8192 + 333    # the mains' rows and a tail
    F, B = 28, 64
    for M in (1, 4, 32):
        bins, pos, dy, gh = bf16_fr_inputs(torch, n, F, B, M, M, dev)

        def fr(g):
            return bins, pos, g, M
        prod = None
        for kernel, kw in [("onehot_pack2", dict(mode="prod")),
                           ("onehot_pack2", dict(mode="pack2")),
                           ("onehot_onebig", {}),
                           ("onehot_onebig", dict(r_tile=1024))]:
            tag = f"[onehot-bf16] {kernel} N={n} M={M} {kw}"
            err, got = bf16_case(torch, oh, kernel, fr, dict(n_bin=B, **kw),
                                 dy, gh, tag)
            errs[kernel] = max(errs[kernel], err)
            if kw.get("mode") == "prod":
                prod = got
            elif kernel == "onehot_onebig" and not kw and \
                    not torch.equal(got, prod):
                fail(f"{tag}: onebig != prod on gh exact in bf16")
        print(f"[onehot-bf16] onehot_pack2 prod / pack2, onehot_onebig "
              f"N={n} M={M}: bitwise == plain on bf16-exact gh (dropped "
              "tail, bins past B, pos past M), onebig == prod; within "
              "bound on random gh", flush=True)
    bins, pos, dy, gh = bf16_fr_inputs(torch, n, F, B, 64, 64, dev)
    b8 = bins.to(torch.uint8)
    prod = {}
    for mode, r_tile in [("prod", 1024), ("prod", 2048), ("prod", 4096),
                         ("dotfloor", 2048), ("u8bins", 2048),
                         ("i16hot", 2048)]:
        bt = b8 if mode == "u8bins" else bins
        tag = f"[onehot-bf16] onehot_r4 {mode} r_tile={r_tile} N={n}"
        err, got = bf16_case(torch, oh, "onehot_r4",
                             lambda g: (bt, pos, g),
                             dict(mode=mode, r_tile=r_tile, n_bin=B), dy,
                             gh, tag)
        errs["onehot_r4"] = max(errs["onehot_r4"], err)
        if mode == "prod":
            prod[r_tile] = got
        elif mode != "dotfloor" and not torch.equal(got, prod[r_tile]):
            fail(f"{tag}: != prod on gh exact in bf16")
    print(f"[onehot-bf16] onehot_r4 N={n}: prod (r_tile 1024, 2048, 4096), "
          "dotfloor, u8bins, i16hot bitwise == plain on bf16-exact gh, "
          "u8bins == i16hot == prod; within bound on random gh", flush=True)
    # T6 where the wgmma kernel's tiling is odd: rows not a multiple of
    # its 256-row step (r_tile = 1000), F Bp not a multiple of 64
    for n, F, B, r_tile in [(OH_N + 37, 28, 64, 1000),
                            (OH_N + 37, 5, 67, 1000),
                            (OH_N + 37, 5, 67, 2048)]:
        bins, pos, dy, gh = bf16_fr_inputs(torch, n, F, B, 64, F + r_tile,
                                           dev)
        b8 = bins.to(torch.uint8)
        for mode in oh.R4_MODES:
            bt = b8 if mode == "u8bins" else bins
            tag = (f"[onehot-bf16] onehot_r4 {mode} r_tile={r_tile} N={n} "
                   f"F={F} B={B}")
            err, _ = bf16_case(torch, oh, "onehot_r4",
                               lambda g: (bt, pos, g),
                               dict(mode=mode, r_tile=r_tile, n_bin=B), dy,
                               gh, tag)
            errs["onehot_r4"] = max(errs["onehot_r4"], err)
        print(f"[onehot-bf16] onehot_r4 N={n} F={F} B={B} r_tile={r_tile}: "
              "every mode bitwise == plain on bf16-exact gh, within bound "
              "on random gh", flush=True)
    # T4 where the small-N form's tiling is odd: F = 5 (prod, onebig) and
    # 6 (pack2), B = 1, 8, 255 (Bp 16, 16, 256), M = 3, 5 (N = 8, 16), 33
    # (N = 128) and 100 (two node tiles), r_tile 1000 and 300 on rows that
    # are not a multiple of the row step, bins -1, 256, 1000, B, 255
    n = OH_N + 37
    for k, (B, M) in enumerate((B, M) for B in (1, 8, 255)
                               for M in (3, 5, 33, 100)):
        r_tile = (1000, 300)[k % 2]
        prod = None
        for kernel, F, kw in [("onehot_pack2", 5, dict(mode="prod")),
                              ("onehot_onebig", 5, {}),
                              ("onehot_pack2", 6, dict(mode="pack2"))]:
            if kernel != "onehot_onebig":
                bins, pos, dy, gh = bf16_fr_inputs(
                    torch, n, F, B, M, 100 * B + M + F, dev,
                    planted=[-1, 256, 1000, B, 255])
            tag = (f"[onehot-bf16] {kernel} N={n} F={F} B={B} M={M} "
                   f"r_tile={r_tile} {kw}")
            err, got = bf16_case(torch, oh, kernel,
                                 lambda g: (bins, pos, g, M),
                                 dict(n_bin=B, r_tile=r_tile, **kw), dy, gh,
                                 tag)
            errs[kernel] = max(errs[kernel], err)
            if kernel == "onehot_onebig" and not torch.equal(got, prod):
                fail(f"{tag}: onebig != prod on gh exact in bf16")
            prod = got
        print(f"[onehot-bf16] onehot_pack2 prod (F=5), onehot_onebig (F=5), "
              f"pack2 (F=6) N={n} B={B} M={M} r_tile={r_tile}: bitwise == "
              "plain on bf16-exact gh (bins -1, 256, 1000, B, 255 planted, "
              "pos past M), onebig == prod; within bound on random gh",
              flush=True)
    sass_check(nvcc, "onehot_group", "[onehot-bf16]")
    sass_check(nvcc, "onehot_r4", "[onehot-bf16]")
    sass_check(nvcc, "onehot_pack2", "[onehot-bf16]")
    g = torch.Generator(device=dev).manual_seed(70)
    B = 67
    # 5 features (F Bp not a multiple of 64) on rows that are not a
    # multiple of the row step, then the main's 28 features and rows
    for n, F, cases in [(OH_N + 37, 5, [(1, 4, 2048), (70, 2, 1024)]),
                        (OH_N, 28, [(3, 2, 2048), (64, 2, 1024),
                                    (64, 4, 2048), (64, 7, 4096),
                                    (64, 14, 2048), (70, 4, 2048),
                                    (70, 14, 1024)])]:
        bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                             dtype=torch.int32)
        dy = torch.randint(-128, 128, (n, 2), generator=g, device=dev,
                           dtype=torch.int32).float() / 64.0
        gh = torch.randn(n, 2, generator=g, device=dev)
        for n_node, fg, r_tile in cases:
            pos = torch.randint(-1, n_node + 10, (n,), generator=g,
                                device=dev, dtype=torch.int32)
            tag = (f"[onehot-bf16] onehot_group N={n} F={F} n_node={n_node}"
                   f" fg={fg} r_tile={r_tile}")
            err, _ = bf16_case(torch, oh, "onehot_group",
                               lambda x: (bins, x, pos, n_node, B),
                               dict(fg=fg, r_tile=r_tile), dy, gh, tag)
            errs["onehot_group"] = max(errs["onehot_group"], err)
            print(f"{tag}: bitwise == plain on bf16-exact gh, within bound "
                  "on random gh", flush=True)
    # a bin of -1 or 1000 in one feature drops that (row, feature) alone
    planted = bins.clone()
    planted[::7, 1] = -1
    planted[::5, 2] = 1000
    pos = torch.randint(0, 64, (OH_N,), generator=g, device=dev,
                        dtype=torch.int32)
    got = oh.onehot_group(planted, dy, pos, 64, B, 4)
    clean = oh.onehot_group(bins, dy, pos, 64, B, 4)
    want = oh.onehot_group_plain(planted, dy, pos, 64, B)
    torch.cuda.synchronize()
    keep = [f for f in range(F) if f not in (1, 2)]
    if not torch.equal(got, want) or \
            not torch.equal(got[:, keep], clean[:, keep]):
        fail("[onehot-bf16] onehot_group fg=4 with out-of-range bins in "
             "features 1 and 2: != plain, or their rows lost from the "
             "group's other features")
    print("[onehot-bf16] onehot_group fg=4, bins -1 and 1000 planted in "
          "features 1 and 2: == plain, the other features equal a clean "
          "run's", flush=True)
    return errs


def wgmma_cols(B, n_node):
    """Bp x N of T5's and T1's wgmma product a row and feature: B rounded
    up to 8 (the M rows of a feature), times 2 m_pad rounded up to 8 in
    each node tile (the N it needs)."""
    m_pad = min(n_node, 64)
    return -(-B // 8) * 8 * -(-n_node // m_pad) * (-(-2 * m_pad // 8) * 8)


def onehot_work(torch, oh, kernel, args, kw):
    """(cells, bytes, additions, tensor-core ms) of one call: the flat
    index and values of one ``index_add_`` computing the same sums
    (inactive entries at the dump cell), the bytes the function must move
    (each input read once, the output written once), its additions, and
    the one-hot product's floor at the dense tensor-core rate."""
    if kernel == "onehot_variant":
        binned, gh, pos, n_node, B = args
        cells_kw = {k: v for k, v in kw.items() if k != "r_tile"}
        idx, src, n_cells = oh.variant_cells(binned, gh, pos, n_node, B,
                                             **cells_kw)
        N, F = binned.shape
        bin_bytes = 2 if kw.get("bin_dtype") == torch.int16 else 4
        active = int(((pos >= 0) & (pos < n_node)).sum())
        nbytes = N * F * bin_bytes + 4 * N + 8 * active + n_cells * 4
        split = 3 if kw.get("precision") == "fp32" \
            and kw.get("hot_dtype", torch.float32) == torch.float32 else 1
        tc = 2 * N * F * wgmma_cols(B, n_node) * split / PEAK_BF16_OPS_S
        return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3
    if kernel == "onehot_group":
        binned, gh, pos, n_node, B = args
        idx, src, n_cells = oh.variant_cells(binned, gh, pos, n_node, B,
                                             "bf16")
        N, F = binned.shape
        active = int(((pos >= 0) & (pos < n_node)).sum())
        nbytes = N * F * 4 + 4 * N + 8 * active + n_cells * 4
        tc = 2 * N * F * wgmma_cols(B, n_node) / PEAK_BF16_OPS_S
        return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3
    if kernel in ("onehot_pack2", "onehot_onebig", "onehot_r4"):
        if kernel == "onehot_r4":
            (bt, pos, gh), M = args, oh.M_TILE
        else:
            bt, pos, gh, M = args
        B, r_tile = kw["n_bin"], kw.get("r_tile", 2048)
        F, n = bt.shape
        n_used = (n // r_tile) * r_tile
        p = pos.reshape(-1)[:n_used]
        floor = kw.get("mode") == "dotfloor"
        # dotfloor: every row's gh lands in bin 0 of each feature
        b = torch.zeros_like(bt[:, :n_used]) if floor else bt[:, :n_used]
        idx, src, n_cells = oh.proto_cells(
            b, p, gh[:n_used].to(torch.bfloat16).float(), B, M)
        active = int(((p >= 0) & (p < M)).sum())
        bin_bytes = 0 if floor else bt.element_size()
        nbytes = n_used * F * bin_bytes + 4 * n_used + 8 * active \
            + n_cells * 4
        tc = 2 * n_used * F * (-(-B // 16) * 16) * (-(-2 * M // 8) * 8) \
            / PEAK_BF16_OPS_S
        return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3
    if kernel == "onehot_r5":
        bt, pos, gh, B = args
        nl = kw["n_levels"]
        F, n = bt.shape
        n_used = (n // oh.R5_R_TILE) * oh.R5_R_TILE
        q = oh._wrap_i8(gh[:, :n_used].t()).to(torch.int32)
        idxs, srcs, active = [], [], 0
        for lv in range(nl):
            node = oh.r5_nodes(pos[0, :n_used], lv, nl)
            idx, src, n_cells = oh.proto_cells(bt[:, :n_used], node, q, B,
                                               oh.M_TILE)
            idxs.append(torch.where(idx == n_cells, nl * n_cells,
                                    idx + lv * n_cells))
            srcs.append(src)
            active += int(((node >= 0) & (node < oh.M_TILE)).sum())
        n_cells *= nl
        nbytes = n_used * (F + 4) + 8 * (n_used if nl > 1 else active) \
            + n_cells * 4
        tc = 2 * n_used * F * (-(-B // 16) * 16) * 128 * nl / PEAK_INT8_OPS_S
        return ((torch.cat(idxs), torch.cat(srcs), n_cells), nbytes,
                active * F * 2, tc * 1e3)
    binned, pos, gh, M, B = args
    fr = kernel == "onehot_i8"
    n = binned.shape[1] if fr else binned.shape[0]
    F = binned.shape[0] if fr else binned.shape[1]
    n_used = (n // 2048) * 2048
    bins_fr = binned[:, :n_used] if fr else binned[:n_used].t()
    p = pos.reshape(-1)[:n_used]
    q = oh._wrap_i8(gh[:n_used]).to(torch.int32)
    idx, src, n_cells = oh.proto_cells(bins_fr, p, q, B, M)
    active = int(((p >= 0) & (p < M)).sum())
    nbytes = n_used * F * (4 if fr else 1) + 4 * n_used + 8 * active \
        + n_cells * 4
    tc = 2 * n_used * F * (-(-B // 16) * 16) * (-(-2 * M // 8) * 8) \
        / PEAK_INT8_OPS_S
    return (idx, src, n_cells), nbytes, active * F * 2, tc * 1e3


def phase_onehot(torch, oh, cuda_hist, kernels, card, device="cuda"):
    """The four ported int / T5 microbenchmark mains at their full shapes,
    every launch count set to 0 just before and read just after; then each
    main's rows (:func:`time_onehot_rows`)."""
    from xgboost_tpu_torch.tools import (hist_int8_proto, hist_microbench,
                                         hist_notrans_proto, hist_r5_ab)
    reset_counts(kernels)
    t0 = time.perf_counter()
    rows = hist_microbench.main(OH_N, device=device)
    t3_rows, t3_acc = hist_int8_proto.main(OH_N, device=device)
    t2_rows, t2_acc = hist_notrans_proto.main(OH_N, device=device)
    t7_rows = hist_r5_ab.main(OH_N, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    print(f"[onehot] the four mains: {time.perf_counter() - t0:.1f} s; "
          f"launch counts {json.dumps(counts)} | {card}", flush=True)
    want = only(kernels, **ONEHOT_MAIN_LAUNCHES)
    if counts != want:
        fail(f"[onehot] launch counts {counts}: want {want}")
    if not t2_acc["exact"]:
        fail("[onehot] T2's int32 sums differ from exact float64 sums")
    if not t3_acc["within_bound"]:
        fail("[onehot] T3's dequantized histogram is beyond the rows' "
             "half quantization steps of the float64 sums")
    out = time_onehot_rows(torch, oh, rows + t3_rows + t2_rows + t7_rows,
                           card, "[onehot]")
    print(f"[onehot] production bf16 (K1) in the T5 main: {rows[0]['ms']:.4f}"
          f" ms | {card}", flush=True)
    return counts, out


def phase_onehot_bf16(torch, oh, cuda_hist, kernels, card, device="cuda"):
    """The three bf16 mains (T1; T4a and T4b; T6) at their full shapes,
    every launch count set to 0 just before and read just after; T1's
    accuracy line within bf16's rounding of the f32 sums, T4a's and T4b's
    match checks; then each main's rows (:func:`time_onehot_rows`)."""
    from xgboost_tpu_torch.tools import (hist_group_proto, hist_pack2_proto,
                                         hist_r4_ab)
    reset_counts(kernels)
    t0 = time.perf_counter()
    t1_rows, t1_acc = hist_group_proto.main(OH_N, device=device)
    t4_rows, t4_chk = hist_pack2_proto.main(OH_N, device=device)
    t4b_rows, t4b_chk = hist_pack2_proto.main_onebig(OH_N, device=device)
    t6_rows = hist_r4_ab.main(OH_N, device=device)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    print(f"[onehot-bf16] the three mains: {time.perf_counter() - t0:.1f} s;"
          f" launch counts {json.dumps(counts)} | {card}", flush=True)
    want = only(kernels, **ONEHOT_BF16_MAIN_LAUNCHES)
    if counts != want:
        fail(f"[onehot-bf16] launch counts {counts}: want {want}")
    if not (t4_chk["match"] and t4b_chk["match"]):
        fail(f"[onehot-bf16] match checks at M = 32: pack2 "
             f"{t4_chk['match']}, onebig {t4b_chk['match']}")
    # T1's accuracy line: bf16 rounding (8 significant bits) moves each
    # row's gh by at most 2^-8 of it, and two f32 orders add
    # 2 n 2^-24 sum|x|
    binned, gh, pos, n_node, B = t1_acc["args"]
    a = oh.onehot_variant_plain(binned, gh.abs(), pos, n_node, B, "fp32")
    cnt = oh.onehot_variant_plain(binned, torch.ones_like(gh), pos, n_node,
                                  B, "fp32")
    diff = (t1_acc["got"] - t1_acc["ref"]).abs()
    if bool((diff > a * (2.0 ** -8 + 2.0 * cnt * 2.0 ** -24)).any()):
        fail(f"[onehot-bf16] T1's accuracy line {t1_acc['err']}: beyond "
             "bf16's rounding of the f32 sums")
    print(f"[onehot-bf16] T1 accuracy line (4,096 rows, fg=4 against K1 "
          f"fp32): max err {t1_acc['err']}, within 2^-8 sum|g| + 2 n 2^-24 "
          f"sum|g| of every cell; T4a pack2 and T4b onebig match prod at "
          f"M = 32", flush=True)
    out = time_onehot_rows(torch, oh, t1_rows + t4_rows + t4b_rows + t6_rows,
                           card, "[onehot-bf16]")
    print(f"[onehot-bf16] production bf16 (K1) in the T1 main: "
          f"{t1_rows[0]['ms']:.4f} ms | {card}", flush=True)
    return counts, out


def onehot_bound_ok(torch, plain, args, kw, got, want, gh_at):
    """The kernel's float sums within 2 n 2^-24 sum|x| of the plain
    version's (``gh_at``: the index of gh in ``args``)."""
    gh = args[gh_at]

    def with_gh(g):
        return plain(*args[:gh_at], g, *args[gh_at + 1:], **kw)
    cnt = with_gh(torch.ones_like(gh))
    a = with_gh(gh.to(torch.bfloat16).float().abs())
    return sum_bound_ok(torch, got, want, cnt, a)


# where gh sits in each float one-hot kernel's arguments
GH_ARG = {"onehot_group": 1, "onehot_pack2": 2, "onehot_onebig": 2,
          "onehot_r4": 2}


def time_onehot_rows(torch, oh, rows, card, tag):
    """Each row of the mains: the kernel against its plain version on the
    main's inputs (int bitwise; float within the f32 summation bound),
    and beside its time the bound, the tensor-core floor, the plain
    version's time and one ``index_add_``'s.  Returns the rows by
    kernel."""
    out = {}
    for row in rows:
        kernel = row["kernel"]
        if kernel == "hist_level":
            continue
        fn = getattr(oh, kernel)
        plain = getattr(oh, kernel + "_plain")
        args, kw = row["args"], row["kw"]
        got, want_h = fn(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if kernel == "onehot_variant":
            if not torch.equal(got, want_h):
                # float sums in another order: the bound of [K1]
                binned, gh, pos, n_node, B = args
                src = gh.to(torch.bfloat16).float() if oh._variant_rounds(
                    kw.get("precision", "bf16"),
                    kw.get("hot_dtype", torch.float32)) else gh
                cnt = oh.onehot_variant_plain(binned, torch.ones_like(gh),
                                              pos, n_node, B, "fp32")
                a = oh.onehot_variant_plain(binned, src.abs(), pos, n_node,
                                            B, "fp32")
                if not sum_bound_ok(torch, got, want_h, cnt, a):
                    fail(f"{tag} {row['name']}: beyond the sum bound")
        elif kernel in GH_ARG:
            if not onehot_bound_ok(torch, plain, args, kw, got, want_h,
                                   GH_ARG[kernel]):
                fail(f"{tag} {row['name']}: beyond the sum bound")
        elif not torch.equal(got, want_h):
            fail(f"{tag} {row['name']}: kernel != plain on the main's "
                 "inputs")
        err = float((got.double() - want_h.double()).abs().max())
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), 3)
        (idx, src, n_cells), nbytes, adds, tc_ms = onehot_work(
            torch, oh, kernel, args, kw)
        acc = torch.zeros(n_cells + 1, dtype=src.dtype, device=src.device)
        lib_ms = cuda_ms(torch, lambda: acc.index_add_(0, idx, src), 3)
        del idx, src, acc
        bound_ms, by = bound_of(nbytes, adds)
        out.setdefault(kernel, []).append(dict(
            name=row["name"], ms=row["ms"], k1_ms=row.get("k1_ms"),
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=by, tc_ms=tc_ms, err=err))
        k1 = f"K1 {row['k1_ms']:.4f} ms; " if row.get("k1_ms") else ""
        print(f"{tag} {row['name']} ({kernel}): {row['ms']:.4f} ms ({k1}"
              f"bound {bound_ms:.4f} ms, {by}; tensor-core floor of the "
              f"one-hot product {tc_ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"index_add_ {lib_ms:.4f} ms) | {card}", flush=True)
    return out


def kernel_record(name, source, replaces, launches, max_err, rows):
    def mean(key):
        return sum(r[key] for r in rows) / len(rows)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_err, "ms": mean("ms"),
           "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
           "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows) else "operations",
           "library_ms": mean("library_ms")}
    if all("device_ms" in r for r in rows):
        rec["device_ms"] = mean("device_ms")
    return rec


def main():
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import xgboost_tpu_torch as xt
    except ImportError as e:
        fail(f"xgboost_tpu_torch is not beside this script: {e}")
    from xgboost_tpu_torch.ops import (cuda_hist, cuda_hist_batched,
                                       cuda_hist_lanes, cuda_hist_onehot,
                                       cuda_node_stats, nvcc)
    # every kernel's launch count: each path checks all of them
    kernels = {"hist_level": cuda_hist, "hist_batched": cuda_hist_batched,
               "node_stats": cuda_node_stats, "hist_lanes": cuda_hist_lanes,
               **cuda_hist_onehot.COUNTERS}

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[env] {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    sources = ["hist_level", "hist_batched", "node_stats", "hist_lanes",
               *dict.fromkeys(cuda_hist_onehot.SOURCES.values())]
    for b in nvcc.build(sources):
        print(f"[build] {b.name}: {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line \
                    or "Performance" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] total {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_kernels(torch, cuda_hist, dev)
    print(f"[K1] checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_k3(torch, cuda_hist_batched, cuda_hist, dev)
    print(f"[K3] checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_k2(torch, cuda_node_stats, dev)
    print(f"[K2] checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_k4(torch, cuda_hist_lanes, cuda_hist, dev)
    print(f"[K4] checks {time.perf_counter() - t0:.1f} s")

    launches, ms_round, captured, max_err = phase_main(
        torch, xt, cuda_hist, kernels, "cuda", card)
    rows = phase_times(torch, cuda_hist, captured, card)
    del captured
    mc_launches, mc_ms_round, mc_captured, mc_err, _ = phase_multiclass(
        torch, xt, kernels, "cuda", card)
    k3_rows = time_k3(torch, cuda_hist_batched, mc_captured, card)
    del mc_captured
    phase_otto(torch, xt, kernels, "cuda", card)
    d0_launches, d0_captured, d0_err = phase_depth0(torch, xt, kernels,
                                                    "cuda")
    k2_rows = time_k2(torch, cuda_node_stats, d0_captured, card)
    t0 = time.perf_counter()
    k4_launches, lane_data, lane_rows, lane_secs, _ = phase_lanes(
        torch, xt, kernels, "cuda", card)
    k4_captured = lanes_round_inputs(torch, xt, cuda_hist_lanes, lane_data,
                                     "cuda")
    k4_err = check_lanes_levels(torch, cuda_hist_lanes, cuda_hist,
                                k4_captured, lane_rows)
    k4_rows = time_k4(torch, cuda_hist_lanes, k4_captured, card)
    del k4_captured
    host_ms, stacked_ms = time_lane_cycles(torch, xt, lane_data, "cuda",
                                           card)
    print(f"[lanes] phase {time.perf_counter() - t0:.1f} s (pipeline runs "
          f"{lane_secs[0]:.2f} s stacked, {lane_secs[1]:.2f} s host loop)")
    t0 = time.perf_counter()
    oh_errs = phase_onehot_checks(torch, cuda_hist_onehot, cuda_hist, nvcc,
                                  dev)
    print(f"[onehot] checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oh_launches, oh_rows = phase_onehot(torch, cuda_hist_onehot, cuda_hist,
                                        kernels, card)
    print(f"[onehot] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oh_errs.update(phase_onehot_bf16_checks(torch, cuda_hist_onehot, nvcc,
                                            dev))
    print(f"[onehot-bf16] checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf_launches, bf_rows = phase_onehot_bf16(torch, cuda_hist_onehot,
                                             cuda_hist, kernels, card)
    print(f"[onehot-bf16] phase {time.perf_counter() - t0:.1f} s")

    records = [
        kernel_record("hist_level", "xgboost_tpu_torch/csrc/hist_level.cu",
                      "xgboost_tpu/ops/pallas_hist.py:46", launches,
                      max_err, rows),
        kernel_record("hist_batched",
                      "xgboost_tpu_torch/csrc/hist_batched.cu",
                      "xgboost_tpu/ops/pallas_hist.py:374", mc_launches,
                      mc_err, k3_rows),
        kernel_record("node_stats", "xgboost_tpu_torch/csrc/node_stats.cu",
                      "xgboost_tpu/ops/pallas_hist.py:609", d0_launches,
                      d0_err, k2_rows),
        kernel_record("hist_lanes", "xgboost_tpu_torch/csrc/hist_lanes.cu",
                      "xgboost_tpu/ops/pallas_hist.py:283", k4_launches,
                      k4_err, k4_rows),
    ]
    for name, (source, replaces) in ONEHOT_SOURCES.items():
        bf16 = name in ONEHOT_BF16_MAIN_LAUNCHES
        rows_k = (bf_rows if bf16 else oh_rows)[name]
        records.append(kernel_record(
            name, source, replaces, (bf_launches if bf16 else oh_launches)[
                name], max([oh_errs[name]] + [r["err"] for r in rows_k]),
            rows_k))
    print(f"[time] Higgs path: {ms_round:.3f} ms per round; multiclass "
          f"path: {mc_ms_round:.3f} ms per round; lanes: {host_ms:.3f} ms "
          f"per host-loop cycle, {stacked_ms:.3f} ms per stacked cycle; "
          f"kernel times are means over the levels of one round (K2: one "
          f"depth-0 round) | {card}")
    print(json.dumps({"kernels": records}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
