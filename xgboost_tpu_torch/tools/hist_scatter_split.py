"""Where the scatter histogram kernels K1 and K3 spend their time, on the
card.

Times a kernel source beside builds of the same source with one passage
replaced, on every level of one round of three paths, captured the way
``chip_smoke.py`` captures them (``train`` with the wrapper wrapped):

  k3       the multiclass path, K3: 200,000 x 28 u8 bins, B = 64, six
           trees, int mode (``auto`` is int8 on the card)
  k1       the Higgs path, K1: 1,000,000 x 28, B = 64, int mode
  k1small  one tenant of the lanes host loop, K1: 12,288 x 28

Two targets:

``parent DIR``: the kernels before the scatter redesign,
``DIR/xgboost_tpu_torch/csrc/hist_batched.cu`` (K3) and
``hist_block.cuh`` (K1's block), driven through ``DIR``'s own wrappers
(``ops/cuda_hist.py``, ``ops/cuda_hist_batched.py``).  ``DIR`` is a
``git archive`` of the commit that holds them (``1ad0bdb``), so this
still runs after the change.

  full      the kernels as they stand in DIR
  no-flush  no global atomics at the flush
  no-zero   the private histogram is not zeroed
  no-rows   zero and flush only: no row is added
  no-load   pos and gh not read: each row's node taken from its index,
            a constant gh

``scatter``: ``csrc/hist_scatter.cuh`` as committed, through this
package's wrappers.

  full      the kernel as committed: each block flushes its histogram
            with global atomics
  c2, c4,   a cluster-reduced flush: blocks of a unit launched as thread
  c8        block clusters of 2, 4 or 8 (where the plan's copies allow;
            the copies cut to a multiple of the cluster) sum their
            private histograms through distributed shared memory, each
            its slice, before the global atomics
  pack64    int mode adds (h << 32) + g as one 64-bit shared-memory add
            in place of two 32-bit ones and splits the sum at the flush
            (exact while every cell's |sum g| < 2^31, which int8 keeps
            and "fixed" does not: measured only, shipped nowhere); the
            ``ATOMS`` instructions of its SASS are printed
  no-adds   no row is added
  no-flush  no global atomics at the flush

``compare DIR``: the parent's ``full`` and this package's kernels on the
three paths' levels and on otto's (200,000 x 93, nine trees), in turns
parent, change, change, parent.

``tilings``: at every level of ``k3`` and ``k1``, the plan's tiling
(``scatter_plan``) beside its neighbours, each of f_tile, t_tile and
m_tile set to the next smaller and the next larger size (under the
card's occupancy, as ``launch_plan`` plans), with each tiling's cost:
whether the hand-set weights of ``plan_cost`` choose the fastest.

``full`` (both targets), ``c2``, ``c4``, ``c8``, ``pack64`` and every
tiling compute the histogram and are held bitwise against the plain
version on every level; the others do not.  A variant whose passage is
no longer in its source raises.  Each round times every variant once,
the second round in reverse order.  Needs the card and ``nvcc``; the
variants build into ``xgboost_tpu_torch/_build/split/``.

Usage: python -m xgboost_tpu_torch.tools.hist_scatter_split
           parent DIR | scatter | compare DIR | tilings  [reps]
"""

from __future__ import annotations

import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_batched, nvcc
from xgboost_tpu_torch.tools import device_ms, device_name

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
# hist_batched.cu, K1's in hist_block.cuh
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
_S_SUM = "      const T v = hist[c * P + cell];\n"
_S_SUM64 = ("      T v;\n"
            "      if constexpr (MODE == 2) {\n"
            "        const long long sum = "
            "reinterpret_cast<const long long*>(hist)[cell];\n"
            "        const int g = (int)(unsigned)(sum & 0xffffffffLL);\n"
            "        v = c ? (T)((sum - g) >> 32) : (T)g;\n"
            "      } else {\n"
            "        v = hist[c * P + cell];\n"
            "      }\n")
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
_S_CELLS = "    for (int e = threadIdx.x; e < cells; e += blockDim.x) {\n"
_S_CELLS_C = ("    const int c_lo = (int)((long long)cells * rank / C);\n"
              "    const int c_hi = (int)((long long)cells * (rank + 1) / C);\n"
              "    for (int e = c_lo + threadIdx.x; e < c_hi; "
              "e += blockDim.x) {\n")
_S_SUM_C = ("      T v = hist[c * P + cell];\n"
            "      for (int p = 1; p < C; ++p)\n"
            "        v += *cluster.map_shared_rank(hist + c * P + cell, "
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
        ("      if (v == T(0)) continue;",
         "      if (v == T(0) || true) continue;")]},
}
CLUSTERS = {"c2": 2, "c4": 4, "c8": 8}
COMPUTES = ("full", "c2", "c4", "c8", "pack64")


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


def capture_levels(paths, device="cuda"):
    """Every level's kernel inputs of one round of each path in
    ``paths`` (``k3``, ``k1``, ``k1small``, ``otto``): path -> list of
    (bins, gh, pos, n_node, n_bin, mode)."""
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
    return (cuda_hist_batched.level_histogram_batched_plain
            if path in ("k3", "otto") else cuda_hist.level_histogram_plain)


# ---------------------------------------------------------------- builds
def _load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_wrappers(root: Path):
    """DIR's K1 and K3 wrapper modules (they build through this
    package's ``nvcc``, whose library cache the timing swaps)."""
    ops = root / "xgboost_tpu_torch" / "ops"
    return (_load_module("parent_cuda_hist", ops / "cuda_hist.py"),
            _load_module("parent_cuda_hist_batched",
                         ops / "cuda_hist_batched.py"))


def variant_text(src: str, subs, name: str) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"passage {old!r} not once in {name}")
        src = src.replace(old, new)
    return src


def build_variants(csrc: Path, variants, tag: str
                   ) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """variant -> {"hist_level": lib, "hist_batched": lib}, every build
    of every variant at once.  A variant that nvcc refuses raises."""
    root = nvcc.BUILD_DIR / "split" / tag
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, files in variants.items():
        d = root / name
        shutil.copytree(csrc, d)
        for file, subs in files.items():
            (d / file).write_text(variant_text((d / file).read_text(), subs,
                                               file))
        for src in ("hist_level", "hist_batched"):
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
    """The K1 and K3 calls of one build: ``call(path, level)``; the
    libraries are swapped into ``nvcc``'s cache around each call, and
    where ``plan_fn(plan, n_rows)`` is given, it turns the wrapper's
    launch plan into the one launched (``launch_plan`` of k3's module,
    which plans both K1 and K3)."""

    def __init__(self, libs, k1, k3, plan_fn: Optional[Callable] = None):
        self.libs, self.k1, self.k3 = libs, k1, k3
        self.plan_fn = plan_fn

    def call(self, path, level):
        bins, gh, pos, m, nb, mode = level
        mod = self.k3 if path in ("k3", "otto") else self.k1
        fn = mod.level_histogram_batched if mod is self.k3 \
            else mod.level_histogram
        saved = {k: nvcc._LIBS.get(k) for k in self.libs}
        nvcc._LIBS.update(self.libs)
        if self.plan_fn is not None:
            planned = self.k3.launch_plan
            self.k3.launch_plan = lambda *a: self.plan_fn(planned(*a), a[1])
        try:
            return fn(bins, gh, pos, m, nb, mode)
        finally:
            if self.plan_fn is not None:
                self.k3.launch_plan = planned
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


def neighbour_tilings(name: str, level, dev) -> List:
    """The plan's own launch at ``level`` first, then each of its
    tilings with one tile set to the next smaller or larger size, as
    ``launch_plan`` would launch it (below the card's occupancy)."""
    bins, gh, pos, m, nb, mode = level
    N, F = bins.shape
    T = gh.shape[0] if gh.dim() == 3 else 1
    k = cuda_hist_batched
    own = k.launch_plan(name, N, F, nb, T, m, mode, dev)
    lib = k._lib(name)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = [own]
    tiles = (own.f_tile, own.t_tile, own.m_tile)
    for d, n in enumerate((F, T, m)):
        sizes = k._tile_sizes(n)
        i = sizes.index(tiles[d])
        for j in (i - 1, i + 1):
            if not 0 <= j < len(sizes):
                continue
            t = list(tiles)
            t[d] = sizes[j]
            p = k.tile_plan(N, F, nb, T, m, *t, n_sm)
            if p is None:
                continue
            blocks = ctypes.c_int(0)
            with torch.cuda.device(dev):
                rc = getattr(lib, f"{name}_resident")(
                    cuda_hist.MODES[mode], p.smem, ctypes.byref(blocks))
            if rc != 0:
                raise RuntimeError(f"{name} occupancy query failed ({rc})")
            if p.grid > blocks.value:
                p = k.tile_plan(N, F, nb, T, m, *t, n_sm,
                                max_blocks=blocks.value)
            if p is not None:
                out.append(p)
    return out


def tilings(levels, reps: int, dev) -> Dict[str, List[float]]:
    """ms of the plan's tiling and its neighbours at every level, each
    held bitwise against the plain version first; two rounds, the
    second in reverse order."""
    runs = []
    for path, lv in levels.items():
        name = "hist_batched" if path in ("k3", "otto") else "hist_level"
        for level in lv:
            for i, p in enumerate(neighbour_tilings(name, level, dev)):
                kern = Kernels({}, cuda_hist, cuda_hist_batched,
                               lambda _p, _n, p=p: p)
                got = kern.call(path, level)
                if not torch.equal(got, plain_of(path)(*level)):
                    raise RuntimeError(f"tiling {p} of {path} != plain")
                key = (f"{path} n_node={level[3]} "
                       f"{'plan' if i == 0 else 'next'} "
                       f"{p.f_tile}/{p.t_tile}/{p.m_tile} units "
                       f"{p.n_units} blocks {p.grid} cost {p.cost:.4g}")
                runs.append((key, kern, path, level))
    out: Dict[str, List[float]] = {}
    for key, kern, path, level in runs + runs[::-1]:
        out.setdefault(key, []).append(device_ms(
            lambda: kern.call(path, level), reps, dev))
    best: Dict[str, Tuple[float, str]] = {}
    for key, ms in out.items():
        print(f"{key}: {' / '.join(f'{x:.4f}' for x in ms)} ms", flush=True)
        lvl = " ".join(key.split()[:2])
        if lvl not in best or min(ms) < best[lvl][0]:
            best[lvl] = (min(ms), key)
    for lvl, (ms, key) in best.items():
        own = next(min(v) for k, v in out.items()
                   if k.startswith(lvl + " plan "))
        print(f"{lvl}: fastest {key.split(' ', 2)[2]} {ms:.4f} ms; the "
              f"plan's {own:.4f} ({own / ms - 1:+.1%})", flush=True)
    return out


def main(target: str = "scatter", parent_dir: str = "", reps: int = 20
         ) -> Dict[str, List[float]]:
    if not torch.cuda.is_available():
        raise RuntimeError("hist_scatter_split times CUDA kernels: no GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    builds: Dict[str, Kernels] = {}
    if target == "tilings":
        levels = capture_levels(("k3", "k1"))
        print(f"scatter plan tilings | {device_name(dev)} | {card}",
              flush=True)
        return tilings(levels, reps, dev)
    if target in ("parent", "compare"):
        root = Path(parent_dir).resolve()
        k1, k3 = parent_wrappers(root)
        variants = PARENT_VARIANTS if target == "parent" \
            else {"full": PARENT_VARIANTS["full"]}
        for name, libs in build_variants(
                root / "xgboost_tpu_torch" / "csrc", variants,
                "parent").items():
            builds["parent" if target == "compare" else name] = \
                Kernels(libs, k1, k3)
    if target in ("scatter", "compare"):
        variants = SCATTER_VARIANTS if target == "scatter" \
            else {"full": SCATTER_VARIANTS["full"]}
        for name, libs in build_variants(nvcc.CSRC, variants,
                                         "scatter").items():
            builds["change" if target == "compare" else name] = \
                Kernels(libs, cuda_hist, cuda_hist_batched,
                        _cluster_plan(CLUSTERS[name]) if name in CLUSTERS
                        else None)
        if target == "scatter":
            for name in ("full", "pack64"):
                so = nvcc.BUILD_DIR / "split" / "scatter" / name \
                    / "libhist_batched.so"
                print(f"[sass] {name} hist_batched: {sass_atoms(so)}",
                      flush=True)
    if not builds:
        raise ValueError(f"target {target!r}: parent, scatter or compare")
    paths = ("k3", "k1", "k1small") + (("otto",) if target == "compare"
                                       else ())
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
    main(tgt, pdir, *(int(a) for a in args[:1]))
