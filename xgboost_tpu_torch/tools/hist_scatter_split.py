"""Where the scatter histogram kernels K1, K3 and K4 spend their time, on
the card.

Times a kernel source beside builds of the same source with one passage
replaced, on every level of one round of these paths, captured the way
``chip_smoke.py`` captures them (``train`` with the wrapper wrapped, or
one stacked dispatch of the lanes):

  k3       the multiclass path, K3: 200,000 x 28 u8 bins, B = 64, six
           trees, int mode (``auto`` is int8 on the card)
  k1       the Higgs path, K1: 1,000,000 x 28, B = 64, int mode
  k1small  one tenant of the lanes host loop, K1: 12,288 x 28
  otto     200,000 x 93, nine trees, K3 (``compare`` only, by default)
  k4       one stacked round of the 48 lanes tenants, K4: 64 lanes of
           16,384 rows x 28, B = 64, int mode

Each target takes the paths to run after its arguments (by default
``k3 k1 k1small`` for ``parent``, those and ``k4`` for ``scatter``, all
five for ``compare``, ``k3 k1 k4`` for ``tilings``, ``k4`` for
``plans``).

``parent DIR``: a parent's kernels with passages of their block code
replaced, driven through ``DIR``'s own wrappers (``ops/cuda_hist.py``,
``ops/cuda_hist_batched.py``, ``ops/cuda_hist_lanes.py``).  ``DIR`` is a
``git archive`` of the commit that holds them, so this still runs after
the change: ``1ad0bdb`` for K3 (``hist_batched.cu``) and K1 before the
scatter redesign, ``233769c`` (or ``1ad0bdb``) for K4 before its
redesign (``hist_lanes.cu`` on ``hist_block.cuh``, the block K1 had
before).

  full      the kernels as they stand in DIR
  no-flush  no global atomics at the flush
  no-zero   the private histogram is not zeroed
  no-rows   zero and flush only: no row is added
  no-load   pos and gh not read: each row's node taken from its index,
            a constant gh

``scatter``: ``csrc/hist_scatter.cuh`` as committed, through this
package's wrappers.

  full      the kernel as committed: each block flushes its histogram,
            stored where every unit has one copy (the plan's ``store``),
            else with global atomics onto a zeroed output
  store-off the same build with the atomic flush forced on a zeroed
            output where the plan would store
  c2, c4,   a cluster-reduced flush: blocks of a unit launched as thread
  c8        block clusters of 2, 4 or 8 (where the plan's copies allow;
            the copies cut to a multiple of the cluster) sum their
            private histograms through distributed shared memory, each
            its slice, before the global atomics
  pack64    int mode adds (h << 32) + g as one 64-bit shared-memory add
            in place of two 32-bit ones and splits the sum at the
            atomic flush, which its plans keep (exact while every cell's
            |sum g| < 2^31, which int8 keeps and "fixed" does not:
            measured only, shipped nowhere); the ``ATOMS`` instructions
            of its SASS are printed
  no-adds   no row is added
  no-flush  no writes at the flush (the store flush's loop left empty)
  spread    each lane's bin replaced by one that puts the 32 lanes of a
            warp on 32 banks: the adds without bank conflicts or equal
            addresses (B >= 32)

``compare DIR``: the parent's ``full`` (DIR's kernels and wrappers, as
``parent``) and this package's kernels on the paths' levels, in turns
parent, change, change, parent.

``tilings``: at every level of the paths, the plan's tiling
(``scatter_plan``) beside its neighbours, each of f_tile, t_tile and
m_tile set to the next smaller and the next larger size (under the
card's occupancy, as ``launch_plan`` plans), with each tiling's cost:
whether the hand-set weights of ``plan_cost`` choose the fastest.

``plans``: the same at every level of ``k4``, over every tiling of
t_tile <= 4, each at 2,048 to 16,384 (row, tree) pairs a step where the
card's occupancy keeps its grid: the plan's rank and the five fastest.

``full`` (both targets), ``store-off``, ``c2``, ``c4``, ``c8``,
``pack64`` and every tiling compute the histogram and are held bitwise
against the plain version on every level; the others do not.  A
variant whose passage is no longer in its source raises.  Each round
times every variant once, the second round in reverse order: the mean
ms of back-to-back calls between CUDA events.  Needs the card and
``nvcc``; the variants build into ``xgboost_tpu_torch/_build/split/``.

Usage: python -m xgboost_tpu_torch.tools.hist_scatter_split
           parent DIR | scatter | compare DIR | tilings | plans
           [paths] [reps]
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import xgboost_tpu_torch.ops as ops_pkg
from xgboost_tpu_torch.ops import (cuda_hist, cuda_hist_batched,
                                   cuda_hist_lanes, nvcc)
from xgboost_tpu_torch.tools import device_ms, device_name

# each path's library, wrapper module and entry point
SOURCE = {"k3": "hist_batched", "otto": "hist_batched", "k1": "hist_level",
          "k1small": "hist_level", "k4": "hist_lanes"}
ENTRY = {"hist_batched": ("cuda_hist_batched", "level_histogram_batched"),
         "hist_level": ("cuda_hist", "level_histogram"),
         "hist_lanes": ("cuda_hist_lanes", "level_histogram_lanes")}
PLAIN = {"hist_batched": "level_histogram_batched_plain",
         "hist_level": "level_histogram_plain",
         "hist_lanes": "level_histogram_lanes_plain"}
PATHS = {"parent": ("k3", "k1", "k1small"),
         "scatter": ("k3", "k1", "k1small", "k4"),
         "compare": ("k3", "k1", "k1small", "otto", "k4"),
         "tilings": ("k3", "k1", "k4"),
         "plans": ("k4",)}

# ---------------------------------------------------------------- parent
_P_ZERO = "for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = T(0);"
_P_ROWS = ("for (long long r = r_begin + threadIdx.x; r < r_end; "
           "r += blockDim.x) {")
_P_FLUSH = "atomicAdd(o + dst, v);"
_P_GH_INT = "const int2 v = static_cast<const int2*>(gh)[{}];"
_P_GH_F32 = "float2 v = static_cast<const float2*>(gh)[{}];"


def _parent_subs(file: str, idx: str, pos_line: str, node_of: str):
    return {
        "full": {},
        "no-flush": {file: [(_P_FLUSH, "(void)dst; (void)v;")]},
        "no-zero": {file: [(_P_ZERO, "")]},
        "no-rows": {file: [(_P_ROWS, _P_ROWS.replace("r_begin +",
                                                     "r_end +"))]},
        "no-load": {file: [
            (pos_line, pos_line.split("=")[0] + f"= {node_of} - m0;"),
            (_P_GH_INT.format(idx), "const int2 v = make_int2(1, 1);"),
            (_P_GH_F32.format(idx), "float2 v = make_float2(1.f, 1.f);")]},
    }


# each variant: file -> (passage, replacement) pairs; K3's passages in
# hist_batched.cu, K1's (before 233769c) and K4's in hist_block.cuh
PARENT_FILES = {"hist_batched": ("hist_batched.cu",),
                "hist_level": ("hist_block.cuh",),
                "hist_lanes": ("hist_block.cuh",)}
PARENT_VARIANTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {
    name: {**_parent_subs("hist_batched.cu", "tr",
                          "const int j = pos[tr] - m0;",
                          "(int)(r % n_node)")[name],
           **_parent_subs("hist_block.cuh", "r",
                          "const int j = pos[r] - m0;",
                          "(int)(r % n_col)")[name]}
    for name in ("full", "no-flush", "no-zero", "no-rows", "no-load")}

# ---------------------------------------------------------------- scatter
SCATTER_HEADER = "hist_scatter.cuh"
_S_ADD = ("              atomicAdd(cell, g);\n"
          "              atomicAdd(cell + P, h);\n")
_S_ADD64 = ("              if constexpr (MODE == 2) {\n"
            "                atomicAdd(reinterpret_cast<unsigned long long*>"
            "(hist)\n"
            "                              + (cell - hist),\n"
            "                          ((unsigned long long)(long long)h "
            "<< 32)\n"
            "                              + (unsigned long long)(long long)"
            "g);\n"
            "              } else {\n"
            "  " + _S_ADD.replace("\n              ", "\n                ")
            + "              }\n")
_S_SUM = "        const T v = hist[c * P + cell];\n"
_S_SUM64 = ("        T v;\n"
            "        if constexpr (MODE == 2) {\n"
            "          const long long sum = "
            "reinterpret_cast<const long long*>(hist)[cell];\n"
            "          const int g = (int)(unsigned)(sum & 0xffffffffLL);\n"
            "          v = c ? (T)((sum - g) >> 32) : (T)g;\n"
            "        } else {\n"
            "          v = hist[c * P + cell];\n"
            "        }\n")
# the cluster-reduced flush: block `rank` of a cluster of C sums slice
# `rank` of the unit's cells over the C private histograms; the cluster
# size is the launch's, the largest of 2, 4, 8 up to the variant's that
# divides the plan's copies (the plan is cut to fit: _cluster_plan)
_S_INCLUDE = "#include <cuda_bf16.h>\n"
_S_FLUSH = ("    __syncthreads();  // every add done (a copy with no rows: "
            "the zeroing)\n")
_S_FLUSH_C = ("    cooperative_groups::cluster_group cluster =\n"
              "        cooperative_groups::this_cluster();\n"
              "    const int C = (int)cluster.num_blocks();\n"
              "    const int rank = (int)cluster.block_rank();\n"
              "    cluster.sync();\n")
_S_CELLS = "      for (int e = threadIdx.x; e < cells; e += blockDim.x) {\n"
_S_CELLS_C = ("      const int c_lo = (int)((long long)cells * rank / C);\n"
              "      const int c_hi = (int)((long long)cells * (rank + 1) "
              "/ C);\n"
              "      for (int e = c_lo + threadIdx.x; e < c_hi; "
              "e += blockDim.x) {\n")
_S_SUM_C = ("        T v = hist[c * P + cell];\n"
            "        for (int p = 1; p < C; ++p)\n"
            "          v += *cluster.map_shared_rank(hist + c * P + cell, "
            "(rank + p) % C);\n")
_S_END = ("    __syncthreads();  // the histogram is zeroed for the next "
          "unit\n")
_S_END_C = "    cluster.sync();  // no peer still reads this block\n"
_S_LAUNCH = "  kernel<MODE><<<grid, THREADS, smem, stream>>>(a);\n"


def _cluster_launch(c: int) -> str:
    return ("  int cl = %d;\n"
            "  while (a.copies %% cl) cl /= 2;\n"
            "  cudaLaunchConfig_t cfg = {};\n"
            "  cfg.gridDim = dim3(grid, 1, 1);\n"
            "  cfg.blockDim = dim3(THREADS, 1, 1);\n"
            "  cfg.dynamicSmemBytes = smem;\n"
            "  cfg.stream = stream;\n"
            "  cudaLaunchAttribute attr[1];\n"
            "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
            "  attr[0].val.clusterDim.x = cl;\n"
            "  attr[0].val.clusterDim.y = 1;\n"
            "  attr[0].val.clusterDim.z = 1;\n"
            "  cfg.attrs = attr;\n"
            "  cfg.numAttrs = 1;\n"
            "  (void)cudaLaunchKernelEx(&cfg, kernel<MODE>, a);\n" % c)


def _cluster_subs(c: int) -> List[Tuple[str, str]]:
    return [(_S_INCLUDE, "#include <cooperative_groups.h>\n" + _S_INCLUDE),
            (_S_FLUSH, _S_FLUSH_C), (_S_CELLS, _S_CELLS_C),
            (_S_SUM, _S_SUM_C), (_S_END, _S_END_C),
            (_S_LAUNCH, _cluster_launch(c))]


# the two flushes' writes: the store (every unit one copy) and the atomic
_S_STORE = ("        o[(((long long)(f0 + f) * B + b) * 2 + c) * cols\n"
            "          + (long long)(t0 + k) * a.n_node + m0 + j] = "
            "hist[c * P + cell];\n")
_S_SKIP = "        if (v == T(0)) continue;\n"
SCATTER_VARIANTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {
    "full": {},
    "c2": {SCATTER_HEADER: _cluster_subs(2)},
    "c4": {SCATTER_HEADER: _cluster_subs(4)},
    "c8": {SCATTER_HEADER: _cluster_subs(8)},
    "pack64": {SCATTER_HEADER: [(_S_ADD, _S_ADD64), (_S_SUM, _S_SUM64)]},
    "no-adds": {SCATTER_HEADER: [
        ("      for (int p = threadIdx.x; p < n; p += blockDim.x) {",
         "      for (int p = threadIdx.x; p < n && false; p += blockDim.x) {")]},
    "no-flush": {SCATTER_HEADER: [
        (_S_STORE, "        (void)cell;\n"),
        (_S_SKIP, "        if (v == T(0) || true) continue;\n")]},
    "spread": {SCATTER_HEADER: [
        ("            const int b = (bytes >> (8 * q)) & 0xff;",
         "            const int b = ((lane - j - k * a.m_tile) & 31) % B;"
         " (void)bytes;")]},
}
CLUSTERS = {"c2": 2, "c4": 4, "c8": 8}
# variants of the launch plan on the build of another variant
PLAN_VARIANTS = {"store-off": "full"}
COMPUTES = ("full", "store-off", "c2", "c4", "c8", "pack64")


def _store_off(p, n_rows):
    """The plan with the atomic flush forced (on a zeroed output)."""
    return p._replace(store=False)


def _cluster_plan(c: int) -> Callable:
    """The plan of a cluster variant of size ``c``: its copies cut to a
    multiple of the largest power of two up to ``c`` that they reach, the
    rows split again over them (as the kernel's launch finds its cluster
    size from the copies)."""
    def plan_fn(p, n_rows):
        cl = 1
        while cl * 2 <= min(c, p.copies):
            cl *= 2
        copies = p.copies // cl * cl
        return p._replace(copies=copies, grid=p.n_groups * copies,
                          rows_per_copy=cuda_hist_batched._round16(
                              -(-max(n_rows, 1) // copies)))
    return plan_fn


# ---------------------------------------------------------------- inputs
HIGGS_N, LANE_N, MC_N, OTTO_N = 1_000_000, 12_288, 200_000, 200_000
# chip_smoke.py's lanes: tenant i trains on 12,288 + 85 i rows from seed
# 1000 + i; 48 tenants stack into 64 lanes of 16,384 rows
LANES, LANE_STEP = 48, 85
HIGGS = {"objective": "binary:logistic", "max_depth": 6, "eta": 0.1,
         "max_bin": 64}
MC = {"objective": "multi:softmax", "num_class": 6, "max_depth": 6,
      "eta": 0.3, "max_bin": 64}
OTTO = {"objective": "multi:softprob", "num_class": 9, "max_depth": 6,
        "eta": 0.3, "max_bin": 64}


def make_higgs_like(n, f=28, seed=42):
    """``bench.py:make_higgs_like``'s task, as ``chip_smoke.py`` makes it."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, f), dtype=np.float32)
    X[:, : f // 3] = rng.exponential(1.0, (n, f // 3))
    X[:, f // 3: 2 * f // 3] = rng.randn(n, f - 2 * (f // 3) + f // 3)[
        :, : f // 3]
    X[:, 2 * (f // 3):] = rng.rand(n, f - 2 * (f // 3))
    score = (np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2] - 0.5 * X[:, 3] ** 2
             + 2.0 * (X[:, 4] > 1.0) + 0.8 * rng.randn(n))
    return X, (score > np.median(score)).astype(np.float32)


def make_classes(n, f, k, seed, skew):
    """``bench.py``'s multiclass (``skew`` False) and otto (True) data."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32) ** 2 if skew \
        else rng.randn(n, f).astype(np.float32)
    centers = rng.randn(k, f).astype(np.float32) * (1.0 if skew else 1.2)
    logits = X @ centers.T + (0.5 if skew else 0.8) * rng.randn(n, k)
    return X, logits.argmax(axis=1).astype(np.float32)


def capture_k4(device="cuda"):
    """Every level's K4 inputs of one stacked round of the 48 lanes
    tenants, as ``chip_smoke.py``'s ``lanes_round_inputs`` captures
    them: one bucket dispatch of the lane gang."""
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.pipeline.lanes import (LaneGang, _Arrival,
                                                  _bucket_of)
    kernel_fn = cuda_hist_lanes.level_histogram_lanes
    got = []

    def capture(bins, gh, pos, n_node, n_bin, mode):
        got.append((bins, gh.clone(), pos.clone(), n_node, n_bin, mode))
        return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
    arrs = []
    for i in range(LANES):
        X, y = make_higgs_like(LANE_N + LANE_STEP * i, seed=1000 + i)
        d = xt.DMatrix(X, label=y)
        spec, why = xt.Booster(HIGGS, [d], device=device).fused_lane_spec(
            d, 0, 1)
        if spec is None:
            raise RuntimeError(f"tenant {i} declined stacking: {why}")
        arrs.append(_Arrival(f"tenant{i:02d}", spec, lambda it: None))
    cuda_hist_lanes.level_histogram_lanes = capture
    try:
        LaneGang(expected=0)._dispatch_bucket(_bucket_of(arrs[0].spec), arrs)
    finally:
        cuda_hist_lanes.level_histogram_lanes = kernel_fn
    errors = [a.exc for a in arrs if a.exc is not None]
    if errors or not got:
        raise RuntimeError(f"one stacked round: {len(got)} levels, errors "
                           f"{errors[:2]}")
    return got


def capture_levels(paths, device="cuda"):
    """Every level's kernel inputs of one round of each path in
    ``paths`` (``k3``, ``k1``, ``k1small``, ``otto``, ``k4``): path ->
    list of (bins, gh, pos, n_node, n_bin, mode)."""
    import xgboost_tpu_torch as xt
    data = {"k1": (HIGGS, lambda: make_higgs_like(HIGGS_N), cuda_hist,
                   "level_histogram"),
            "k1small": (HIGGS, lambda: make_higgs_like(LANE_N, seed=1000),
                        cuda_hist, "level_histogram"),
            "k3": (MC, lambda: make_classes(MC_N, 28, 6, 7, False),
                   cuda_hist_batched, "level_histogram_batched"),
            "otto": (OTTO, lambda: make_classes(OTTO_N, 93, 9, 21, True),
                     cuda_hist_batched, "level_histogram_batched")}
    out = {}
    for path in paths:
        if path == "k4":
            out[path] = capture_k4(device)
            continue
        params, make, mod, attr = data[path]
        X, y = make()
        kernel_fn = getattr(mod, attr)
        got = out[path] = []

        def capture(bins, gh, pos, n_node, n_bin, mode):
            got.append((bins, gh.clone(), pos.clone(), n_node, n_bin,
                        mode))
            return kernel_fn(bins, gh, pos, n_node, n_bin, mode)
        setattr(mod, attr, capture)
        try:
            xt.train(params, xt.DMatrix(X, label=y), 1, device=device)
        finally:
            setattr(mod, attr, kernel_fn)
    return out


def plain_of(path):
    mod, _ = ENTRY[SOURCE[path]]
    return getattr(getattr(ops_pkg, mod), PLAIN[SOURCE[path]])


# ---------------------------------------------------------------- builds
def _load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _modules(mods: Dict[str, object]):
    """``xgboost_tpu_torch.ops.<name>`` resolved to ``mods[name]`` inside
    the block (imports at call time included), restored after."""
    saved = {}
    for name, mod in mods.items():
        key = f"xgboost_tpu_torch.ops.{name}"
        saved[name] = (sys.modules.get(key), getattr(ops_pkg, name, None))
        sys.modules[key] = mod
        setattr(ops_pkg, name, mod)
    try:
        yield
    finally:
        for name, (mod, attr) in saved.items():
            key = f"xgboost_tpu_torch.ops.{name}"
            if mod is None:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = mod
            setattr(ops_pkg, name, attr)


def parent_wrappers(root: Path) -> Dict[str, object]:
    """DIR's wrapper modules of K1, K3 and K4 (those DIR has), each
    importing DIR's others: they build through this package's ``nvcc``,
    whose library cache the timing swaps."""
    ops = root / "xgboost_tpu_torch" / "ops"
    mods: Dict[str, object] = {}
    for name in ("cuda_hist", "cuda_hist_batched", "cuda_hist_lanes"):
        if (ops / f"{name}.py").exists():
            with _modules(mods):
                mods[name] = _load_module(f"parent_{name}",
                                          ops / f"{name}.py")
    return mods


def variant_text(src: str, subs, name: str) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"passage {old!r} not once in {name}")
        src = src.replace(old, new)
    return src


def build_variants(csrc: Path, variants, tag: str, sources
                   ) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """variant -> {source: lib} for each of ``sources`` (``hist_level``,
    ``hist_batched``, ``hist_lanes``), every build of every variant at
    once.  A variant that nvcc refuses raises."""
    root = nvcc.BUILD_DIR / "split" / tag
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, files in variants.items():
        d = root / name
        shutil.copytree(csrc, d)
        for file, subs in files.items():
            (d / file).write_text(variant_text((d / file).read_text(), subs,
                                               file))
        for src in sources:
            so = d / f"lib{src}.so"
            procs[(name, src)] = (so, subprocess.Popen(
                [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                 str(d / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {}
    for (name, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name} {src}:\n{log}")
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"[build] {tag} {name} {src}: {'; '.join(regs) or '?'}",
              flush=True)
        libs.setdefault(name, {})[src] = ctypes.CDLL(str(so))
    return libs


def sass_atoms(so: Path) -> Dict[str, int]:
    """Counts of the shared-memory atomic opcodes (``ATOMS...``) in a
    library's SASS."""
    cuobjdump = Path(nvcc.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    out: Dict[str, int] = {}
    for line in text.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith("ATOMS"):
                out[word] = out.get(word, 0) + 1
    return out


class Kernels:
    """The K1, K3 and K4 calls of one build: ``call(path, level)``; the
    libraries are swapped into ``nvcc``'s cache around each call, and
    ``mods`` (a parent's wrapper modules; this package's where empty)
    into ``xgboost_tpu_torch.ops``; where ``plan_fn(plan, n_rows)`` is
    given, it turns the wrapper's launch plan into the one launched
    (``launch_plan`` of ``cuda_hist_batched``, which plans all three)."""

    def __init__(self, libs, mods=None, plan_fn: Optional[Callable] = None):
        self.libs, self.mods = libs, dict(mods or {})
        self.plan_fn = plan_fn

    def call(self, path, level):
        mod_name, entry = ENTRY[SOURCE[path]]
        mod = self.mods.get(mod_name, getattr(ops_pkg, mod_name))
        kb = self.mods.get("cuda_hist_batched", cuda_hist_batched)
        saved = {k: nvcc._LIBS.get(k) for k in self.libs}
        nvcc._LIBS.update(self.libs)
        if self.plan_fn is not None:
            planned = kb.launch_plan
            kb.launch_plan = lambda *a: self.plan_fn(planned(*a), a[1])
        try:
            with _modules(self.mods):
                return getattr(mod, entry)(*level)
        finally:
            if self.plan_fn is not None:
                kb.launch_plan = planned
            for k, v in saved.items():
                if v is None:
                    nvcc._LIBS.pop(k, None)
                else:
                    nvcc._LIBS[k] = v


def time_rounds(builds: Dict[str, Kernels], levels, reps: int,
                order: List[str], check: Tuple[str, ...], dev
                ) -> Dict[str, List[float]]:
    """ms of every (build, path, level) in the rounds of ``order``
    (build names, repeats allowed); the builds in ``check`` are first
    held bitwise against the plain version at every level."""
    for name in check:
        for path, lv in levels.items():
            for i, level in enumerate(lv):
                got = builds[name].call(path, level)
                want = plain_of(path)(*level)
                torch.cuda.synchronize(dev)
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name} {path} level {i} != plain")
    out: Dict[str, List[float]] = {}
    for name in order:
        for path, lv in levels.items():
            for i, level in enumerate(lv):
                key = f"{name} {path} n_node={level[3]}"
                out.setdefault(key, []).append(device_ms(
                    lambda: builds[name].call(path, level), reps, dev))
    return out


def report(out: Dict[str, List[float]], computes=()) -> None:
    means: Dict[str, List[float]] = {}
    for key, ms in out.items():
        print(f"{key:32s}: {' / '.join(f'{m:.4f}' for m in ms)} ms"
              + (" (== plain)" if key.split()[0] in computes else ""),
              flush=True)
        name, path = key.split()[:2]
        means.setdefault(f"{name} {path}", []).append(min(ms))
    for key, ms in means.items():
        print(f"{key:32s}: mean of levels {sum(ms) / len(ms):.4f} ms",
              flush=True)


def _resident(name: str, mode: str, smem: int, dev) -> int:
    """Blocks of ``smem`` bytes the card holds at once (the library's
    occupancy query)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = getattr(cuda_hist_batched._lib(name), f"{name}_resident")(
            cuda_hist.MODES[mode], smem, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed ({rc})")
    return blocks.value


def neighbour_tilings(name: str, level, dev, every: bool = False) -> List:
    """The plan's own launch at ``level`` first, then each of its
    tilings with one tile set to the next smaller or larger size, as
    ``launch_plan`` would launch it (below the card's occupancy); with
    ``every``, all tilings of t_tile <= 4 instead, each at every step of
    2,048 to 16,384 (row, tree) pairs the card's occupancy keeps."""
    bins, gh, pos, m, nb, mode = level
    N, F = bins.shape[-2:]
    T = gh.shape[0] if gh.dim() == 3 else 1
    shared = name != "hist_lanes"
    k = cuda_hist_batched
    own = k.launch_plan(name, N, F, nb, T, m, mode, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = [own]
    tiles = (own.f_tile, own.t_tile, own.m_tile)
    if every:
        cands = [(f, t, mt) for f in k._tile_sizes(F)
                 for t in k._tile_sizes(T) if t <= 4
                 for mt in k._tile_sizes(m)]
    else:
        cands = []
        for d, n in enumerate((F, T, m)):
            sizes = k._tile_sizes(n)
            i = sizes.index(tiles[d])
            cands += [tiles[:d] + (sizes[j],) + tiles[d + 1:]
                      for j in (i - 1, i + 1) if 0 <= j < len(sizes)]
    for t in cands:
        p = k.tile_plan(N, F, nb, T, m, *t, n_sm, shared_bins=shared)
        if p is not None and p.grid > _resident(name, mode, p.smem, dev):
            p = k.tile_plan(N, F, nb, T, m, *t, n_sm, shared_bins=shared,
                            max_blocks=_resident(name, mode, p.smem, dev))
        if p is None:
            continue
        steps = [p.rows_per_step]
        if every:
            steps += [k._round16(max(16, pairs // t[1]))
                      for pairs in (2048, 4096, 8192, 16384)]
        for r in dict.fromkeys(steps):
            q = p._replace(rows_per_step=r,
                           smem=k.smem_bytes(p.hist_bytes, t[1], r))
            if q.smem > k.SMEM_MAX \
                    or q.grid > _resident(name, mode, q.smem, dev):
                continue
            q = q._replace(cost=k.plan_cost(q, N, F, T, n_sm, shared))
            if q not in out:
                out.append(q)
    return out


def tilings(levels, reps: int, dev, every: bool = False
            ) -> Dict[str, List[float]]:
    """ms of the plan's tiling and its neighbours (with ``every``, all
    tilings and steps: :func:`neighbour_tilings`) at every level, each
    held bitwise against the plain version first; two rounds, the
    second in reverse order."""
    runs = []
    for path, lv in levels.items():
        for level in lv:
            want = plain_of(path)(*level)
            for i, p in enumerate(neighbour_tilings(SOURCE[path], level,
                                                    dev, every)):
                kern = Kernels({}, plan_fn=lambda _p, _n, p=p: p)
                got = kern.call(path, level)
                if not torch.equal(got, want):
                    raise RuntimeError(f"tiling {p} of {path} != plain")
                key = (f"{path} n_node={level[3]} "
                       f"{'plan' if i == 0 else 'next'} "
                       f"{p.f_tile}/{p.t_tile}/{p.m_tile} units "
                       f"{p.n_units} blocks {p.grid} rows a step "
                       f"{p.rows_per_step}"
                       f"{' store' if p.store else ''} cost {p.cost:.4g}")
                runs.append((key, kern, path, level))
            del want
    out: Dict[str, List[float]] = {}
    for key, kern, path, level in runs + runs[::-1]:
        out.setdefault(key, []).append(device_ms(
            lambda: kern.call(path, level), reps, dev))
    ranked: Dict[str, List[Tuple[float, str]]] = {}
    for key, ms in out.items():
        if not every:
            print(f"{key}: {' / '.join(f'{x:.4f}' for x in ms)} ms",
                  flush=True)
        ranked.setdefault(" ".join(key.split()[:2]), []).append(
            (min(ms), key))
    for lvl, rows in ranked.items():
        rows.sort()
        rank = next(i for i, (_, key) in enumerate(rows)
                    if key.startswith(lvl + " plan "))
        own = rows[rank][0]
        ms, key = rows[0]
        print(f"{lvl}: fastest {key.split(' ', 2)[2]} {ms:.4f} ms; the "
              f"plan's {own:.4f} ({own / ms - 1:+.1%}), rank {rank + 1} "
              f"of {len(rows)}", flush=True)
        for ms, key in rows[:5] if every else ():
            print(f"    {ms:.4f} {key.split(' ', 2)[2]}", flush=True)
    return out


def main(target: str = "scatter", parent_dir: str = "", reps: int = 20,
         paths: Tuple[str, ...] = ()) -> Dict[str, List[float]]:
    if not torch.cuda.is_available():
        raise RuntimeError("hist_scatter_split times CUDA kernels: no GPU")
    if target not in PATHS:
        raise ValueError(f"target {target!r}: parent, scatter, compare, "
                         "tilings or plans")
    paths = tuple(paths) or PATHS[target]
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    sources = tuple(dict.fromkeys(SOURCE[p] for p in paths))
    builds: Dict[str, Kernels] = {}
    if target in ("tilings", "plans"):
        levels = capture_levels(paths)
        print(f"scatter plan {target} | {device_name(dev)} | {card}",
              flush=True)
        return tilings(levels, reps, dev, every=target == "plans")
    if target in ("parent", "compare"):
        root = Path(parent_dir).resolve()
        mods = parent_wrappers(root)
        files = {f for src in sources for f in PARENT_FILES[src]}
        variants = PARENT_VARIANTS if target == "parent" \
            else {"full": PARENT_VARIANTS["full"]}
        variants = {name: {f: subs for f, subs in v.items() if f in files}
                    for name, v in variants.items()}
        for name, libs in build_variants(
                root / "xgboost_tpu_torch" / "csrc", variants, "parent",
                sources).items():
            builds["parent" if target == "compare" else name] = \
                Kernels(libs, mods)
    if target in ("scatter", "compare"):
        variants = SCATTER_VARIANTS if target == "scatter" \
            else {"full": SCATTER_VARIANTS["full"]}
        libs_of = build_variants(nvcc.CSRC, variants, "scatter", sources)
        for name, libs in libs_of.items():
            # pack64's planes are unpacked by its atomic flush only
            plan_fn = _cluster_plan(CLUSTERS[name]) if name in CLUSTERS \
                else _store_off if name == "pack64" else None
            builds["change" if target == "compare" else name] = \
                Kernels(libs, plan_fn=plan_fn)
        if target == "scatter":
            for name, base in PLAN_VARIANTS.items():
                builds[name] = Kernels(libs_of[base], plan_fn=_store_off)
            if "hist_batched" in sources:
                for name in ("full", "pack64"):
                    so = nvcc.BUILD_DIR / "split" / "scatter" / name \
                        / "libhist_batched.so"
                    print(f"[sass] {name} hist_batched: {sass_atoms(so)}",
                          flush=True)
    levels = capture_levels(paths)
    print(f"scatter histogram split ({target}; "
          + ", ".join(f"{p}: {len(v)} levels of {tuple(v[0][0].shape)}"
                      for p, v in levels.items())
          + f") | {device_name(dev)} | {card}", flush=True)
    names = list(builds)
    if target == "compare":
        order = ["parent", "change", "change", "parent"]
        check = tuple(names)
    else:
        order = names + names[::-1]
        check = tuple(n for n in names if n in COMPUTES)
    out = time_rounds(builds, levels, reps, order, check, dev)
    report(out, () if target == "compare" else COMPUTES)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    tgt = args.pop(0) if args else "scatter"
    pdir = args.pop(0) if tgt in ("parent", "compare") else ""
    main(tgt, pdir, *(int(a) for a in args if a.isdigit()),
         paths=tuple(a for a in args if not a.isdigit()))
