"""Where the wgmma one-hot kernel of T5 and T1 spends its time, on the card.

Times ``csrc/onehot_wgmma.cuh`` through T1's ``onehot_group`` at the
mains' shape (1M x 28 int32 bins, B = 67, n_node = 64) beside builds of
the same source with one passage replaced:

  full      the kernel as committed
  2x2       two warpgroups of two M tiles a block (the same four tiles)
            instead of four warpgroups of one
  no-B      no gh_exp entries written: staging, the one-hot build and the
            products ("A only")
  no-A      a constant A fragment in place of the one-hot build
  no-stage  no staging after a block's first row step
  no-mma    no products: staging and the one-hot build

``full`` and ``2x2`` compute the histogram and are held bitwise against
the plain version on bf16-exact gradients; the others do not.  A variant
whose passage is no longer in the source raises.  Each round times every
variant once, the second round in reverse order.  Needs the card and
``nvcc``; the variants build into ``xgboost_tpu_torch/_build/split/``.

Usage: python -m xgboost_tpu_torch.tools.hist_wgmma_split [reps]
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.ops import cuda_hist_onehot, nvcc
from xgboost_tpu_torch.tools import device_ms, device_name

N, F, B, N_NODE = 1_000_000, 28, 67, 64
HEADER = "onehot_wgmma.cuh"
_A_BUILD = ("        const uint32_t q0 = ohw_prmt(", "      ohw_fence();")
# each variant: (passage, replacement) pairs, or a (start, end) marker
# pair whose span is replaced (an A fragment that changes every step, so
# the products are not hoisted)
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "2x2": [("constexpr int OHW_WARPGROUPS = 4;",
             "constexpr int OHW_WARPGROUPS = 2;"),
            ("return n >= 128 ? 1 : 2;", "return 2;")],
    "no-B": [("    if (nw >= 0) {", "    if (nw >= 0 && false) {")],
    "no-A": [(_A_BUILD, "        af[T][0] = a_one[T][0] ^ w;\n"
                        "        af[T][1] = a_one[T][1];\n"
                        "        af[T][2] = a_one[T][0];\n"
                        "        af[T][3] = a_one[T][1] ^ kb;\n      }\n")],
    "no-stage": [("    if (s + 1 < n_steps) store_step(",
                  "    if (s + 1 < n_steps && false) store_step("),
                 ("    if (s + 2 < n_steps) load_step(",
                  "    if (s + 2 < n_steps && false) load_step(")],
    "no-mma": [("          ohw_mma<N>(acc[T], af[T],",
                "          if (p < 0) ohw_mma<N>(acc[T], af[T],"),
               ("      ohw_commit();\n",
                "      ohw_commit();\n#pragma unroll\n"
                "      for (int T = 0; T < TW; ++T)\n"
                "        asm volatile(\"\" ::\"r\"(af[T][0]), "
                "\"r\"(af[T][1]), \"r\"(af[T][2]), \"r\"(af[T][3]));\n")],
}
COMPUTES = ("full", "2x2")   # variants that still compute the histogram


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if isinstance(old, tuple):
            i, j = src.find(old[0]), src.find(old[1])
            if i < 0 or j < i:
                raise ValueError(f"passage {old} not in {HEADER}")
            src = src[:i] + new + src[j:]
        else:
            if src.count(old) != 1:
                raise ValueError(f"passage {old!r} not once in {HEADER}")
            src = src.replace(old, new)
    return src


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Each variant's ``onehot_group`` library, built in parallel."""
    root = nvcc.BUILD_DIR / "split"
    shutil.rmtree(root, ignore_errors=True)
    src = (nvcc.CSRC / HEADER).read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        d = root / name
        shutil.copytree(nvcc.CSRC, d)
        (d / HEADER).write_text(variant_source(src, subs))
        so = d / "libonehot_group.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
             str(d / "onehot_group.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"[build] {name}: N = 128 kernel {regs[0] if regs else '?'}",
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(reps: int = 20) -> Dict[str, List[float]]:
    """Times every variant in two rounds; returns its ms by name."""
    if not torch.cuda.is_available():
        raise RuntimeError("hist_wgmma_split times CUDA kernels: no GPU")
    dev = torch.device("cuda", 0)
    libs = build_variants()
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, B, (N, F)).astype(np.int32)).to(
        dev)
    gh = torch.from_numpy(rng.randn(N, 2).astype(np.float32)).to(dev)
    dy = torch.from_numpy((rng.randint(-128, 128, (N, 2)) / 64.0).astype(
        np.float32)).to(dev)
    pos = torch.from_numpy(rng.randint(0, N_NODE, N).astype(np.int32)).to(
        dev)
    want = cuda_hist_onehot.onehot_group_plain(bins, dy, pos, N_NODE, B)
    print(f"wgmma one-hot kernel split (T1 at {N} x {F}, B={B}, "
          f"n_node={N_NODE}) | {device_name(dev)}", flush=True)
    committed = nvcc.load("onehot_group")
    out: Dict[str, List[float]] = {}
    try:
        for rnd, names in enumerate((list(libs), list(libs)[::-1])):
            for name in names:
                nvcc._LIBS["onehot_group"] = libs[name]
                if rnd == 0 and name in COMPUTES:
                    got = cuda_hist_onehot.onehot_group(bins, dy, pos,
                                                        N_NODE, B)
                    torch.cuda.synchronize(dev)
                    if not torch.equal(got, want):
                        raise RuntimeError(f"variant {name} != plain")
                out.setdefault(name, []).append(device_ms(
                    lambda: cuda_hist_onehot.onehot_group(bins, gh, pos,
                                                          N_NODE, B),
                    reps, dev))
    finally:
        nvcc._LIBS["onehot_group"] = committed
    for name, ms in out.items():
        print(f"{name:9s}: {' / '.join(f'{m:.4f}' for m in ms)} ms"
              + (" (== plain)" if name in COMPUTES else ""), flush=True)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
