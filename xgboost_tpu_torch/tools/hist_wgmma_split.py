"""Where the wgmma one-hot kernel spends its time, on the card.

Times ``csrc/onehot_wgmma.cuh`` beside builds of the same source with one
passage replaced, for one of five targets.

``t1`` (the default): T1's ``onehot_group`` at the mains' shape (1M x 28
int32 bins, B = 67, n_node = 64), A from registers:

  full      the kernel as committed
  2x2       two warpgroups of two M tiles a block (the same four tiles)
            instead of four warpgroups of one
  no-B      no gh_exp entries written: staging, the one-hot build and the
            products ("A only")
  no-A      a constant A fragment in place of the one-hot build
  no-stage  no staging after a block's first row step
  no-mma    no products: staging and the one-hot build

``t7``: T7's ``onehot_r5`` in the levels form (A from shared memory) at
the shared6 shape of its main (1,001,472 x 28 u8 bins, B = 64, 6 levels),
``u8cmp`` and ``prod``:

  full      the kernel as committed
  no-A      the A tiles written with a constant, no stage read or compare
  no-B      no gh_exp entries written
  no-load   no loads of the next step's rows (the stage keeps old bytes)
  no-mma    no products

``t3`` and ``t2``: T3's ``onehot_i8`` (feature-major int32 bins) and T2's
``onehot_notrans`` (row-major u8 bins, a word of four features a load) in
the small-N ``s8`` form at their mains' shape (1,007,616 x 28, B = 64),
M = 1, 4 and 32 (N = 8, 8, 64):

  full      the kernel as committed
  no-A      a constant A fragment in place of the stage reads and compares
  no-B      no gh_exp entries written
  no-load   no loads of the next step's rows (the stage keeps old bytes)
  no-mma    no products: staging and the one-hot build
  overlap   each tile's product issued as soon as its fragment is built
            (one fence a tile), one wait a k32 step
  groups    one commit group a tile, ``wait_group TW - 1`` before its next
            fragment, so products never drain within a row step (drained
            before the stage hand-over)

``t4``: T4a's ``onehot_pack2`` (T4b launches the same instance) in the
small-N bf16 form at the same shape and M, the same seven variants, its
``no-A`` a constant fragment in place of the byte permute, the compares
and the widening.

``full`` (and ``2x2``; ``overlap`` and ``groups``) compute the histogram
and are held bitwise against the plain version (T1 and T4 on bf16-exact
gradients; T3, T2 and T4 at all three M); the others do not.  A
variant whose passage is no longer in the source raises; one that nvcc
does not build is reported and left out.  Each round times every variant
once, the second round in reverse order.  Needs the card and ``nvcc``; the
variants build into ``xgboost_tpu_torch/_build/split/``.

Usage: python -m xgboost_tpu_torch.tools.hist_wgmma_split [reps]
           [t1|t7|t3|t2|t4]
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
_A_BUILD = ("          const uint32_t q0 = ohw_prmt(", "        ohw_fence();")
_STAGE = ("      if (s + 1 < n_steps) store_step(cur ^ 1);\n"
          "      if (s + 2 < n_steps) load_step(r_begin + (long long)(s + 2) "
          "* KS);\n"
          "      ohw_fence_proxy();")
_COMMIT = "        ohw_commit();\n        // A wgmma reads its A registers"
# each variant: (passage, replacement) pairs, or a (start, end) marker
# pair whose span is replaced (an A fragment that changes every step, so
# the products are not hoisted)
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "2x2": [("constexpr int OHW_WARPGROUPS = 4;",
             "constexpr int OHW_WARPGROUPS = 2;"),
            ("return n >= 128 ? 1 : 2;", "return 2;")],
    "no-B": [("    if (nw >= 0) {", "    if (nw >= 0 && false) {")],
    "no-A": [(_A_BUILD, "          af[T][0] = a_one[T][0] ^ w;\n"
                        "          af[T][1] = a_one[T][1];\n"
                        "          af[T][2] = a_one[T][0];\n"
                        "          af[T][3] = a_one[T][1] ^ kb;\n"
                        "        }\n      }\n")],
    "no-stage": [(_STAGE, _STAGE.replace("n_steps)", "n_steps && false)"))],
    "no-mma": [("            ohw_mma<N>(acc[T], af[T],",
                "            if (p < 0) ohw_mma<N>(acc[T], af[T],"),
               (_COMMIT,
                "        ohw_commit();\n#pragma unroll\n"
                "        for (int T = 0; T < TW; ++T)\n"
                "          asm volatile(\"\" ::\"r\"(af[T][0]), "
                "\"r\"(af[T][1]), \"r\"(af[T][2]), \"r\"(af[T][3]));\n"
                "        // A wgmma reads its A registers")],
}
_R5_BUILD = ("          const uint4 w =\n", "        }\n      }\n    }\n  };")
_R5_LOAD = ("      if (s + 2 < n_steps) load_step(r_begin + (long long)"
            "(s + 2) * KS);\n      __syncthreads();")
R5_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no-A": [(_R5_BUILD,
              "          *reinterpret_cast<uint4*>(\n"
              "              at + T * a_bytes + i * 16 * OHW_THREADS) =\n"
              "              make_uint4(c_key[T] ^ (uint32_t)jb, c_one[T], "
              "c_key[T],\n"
              "                         c_one[T] ^ (uint32_t)i);\n")],
    "no-B": [("    if (nw >= 0) {", "    if (nw >= 0 && false) {")],
    "no-load": [(_R5_LOAD, _R5_LOAD.replace("n_steps)", "n_steps && false)"))],
    "no-mma": [("        ohw_mma_s8_ss(acc[0],",
                "        if (kb < 0) ohw_mma_s8_ss(acc[0],")],
}
# the small-N form's fragments of a K step and their products, as
# committed (shared by s8 and bf16)
_MMA = "ohw_mma<N>(acc[T], af[T], desc0 + (uint64_t)((kb * 32 * N) >> 4));\n"
_INT_HEAD = ("#pragma unroll\n        for (int T = 0; T < TW; ++T) {\n"
             "          if (T < ntw) {\n"
             "            if constexpr (S8) {\n")
_INT_TAIL = ("          }\n        }\n        ohw_fence();\n#pragma unroll\n"
             "        for (int T = 0; T < TW; ++T)\n"
             "          " + _MMA +
             "        ohw_commit();\n"
             "        // one wait a K step for all the warpgroup's tiles\n"
             "        ohw_wait();\n")
# the fragments stay live until their products' wait (a wgmma reads its A
# registers until then)
_INT_PIN = ("          asm volatile(\"\" ::\"r\"(af[T][0]), \"r\"(af[T][1]), "
            "\"r\"(af[T][2]), \"r\"(af[T][3]));\n")
_INT_ISSUE = "          ohw_fence();\n          " + _MMA
_WAIT = ("__device__ __forceinline__ void ohw_wait() {\n"
         "  asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: \"memory\");\n}\n")
_WAIT_N = ("template <int K>\n__device__ __forceinline__ void ohw_wait_n() {\n"
           "  asm volatile(\"wgmma.wait_group.sync.aligned %0;\\n\" ::\"n\"(K) "
           ": \"memory\");\n}\n")
_HANDOVER = ("      // hand the stages over: step s + 1 into the other stage (its "
             "last\n")
# the s8 and the bf16 A build (a passage from its first line up to the
# end marker)
_INT_BUILD = ("              // the 16 A bytes of M rows g, g + 8 from two words\n",
              "            } else {\n")
_T4_BUILD = ("              // the bf16 A of M rows g, g + 8",
             "            }\n          }\n        }\n        ohw_fence();")
_INT_LOAD = ("      if (s + 2 < n_steps)\n"
             "        load_step(r_begin + (long long)(s + 2) * KS);")
_INT_COMMIT = ("        ohw_commit();\n"
               "        // one wait a K step for all the warpgroup's tiles")
INT_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no-A": [(_INT_BUILD, "              af[T][0] = s_key[T] ^ (uint32_t)w;\n"
                          "              af[T][1] = s_key[T];\n"
                          "              af[T][2] = (uint32_t)s_word[T];\n"
                          "              af[T][3] = s_key[T] ^ (uint32_t)kb;\n")],
    "no-B": [("    if (nw >= 0) {", "    if (nw >= 0 && false) {")],
    "no-load": [(_INT_LOAD, _INT_LOAD.replace("n_steps)", "n_steps && false)"))],
    "no-mma": [("          " + _MMA, "          if (kb < 0) " + _MMA),
               (_INT_COMMIT,
                "        ohw_commit();\n#pragma unroll\n"
                "        for (int T = 0; T < TW; ++T)\n"
                "          asm volatile(\"\" ::\"r\"(af[T][0]), "
                "\"r\"(af[T][1]), \"r\"(af[T][2]), \"r\"(af[T][3]));\n"
                "        // one wait a K step")],
    "overlap": [(_INT_TAIL, "          }\n" + _INT_ISSUE + "        }\n"
                 "        ohw_commit();\n        ohw_wait();\n#pragma unroll\n"
                 "        for (int T = 0; T < TW; ++T)\n" + _INT_PIN)],
    "groups": [(_WAIT, _WAIT + _WAIT_N),
               (_INT_HEAD, _INT_HEAD.replace(
                   "          if (T < ntw) {\n",
                   "          ohw_wait_n<TW - 1>();\n" + _INT_PIN
                   + "          if (T < ntw) {\n")),
               (_INT_TAIL, "          }\n" + _INT_ISSUE
                + "          ohw_commit();\n        }\n"),
               # another warpgroup's last step may still read the stage
               # store_step overwrites
               (_HANDOVER, "      ohw_wait();\n" + _HANDOVER)],
}
# T4a's bf16 small-N form: the same passages but its own A build
T4_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    **INT_VARIANTS,
    "no-A": [(_T4_BUILD, "              af[T][0] = s_key[T] ^ (uint32_t)kb;\n"
                         "              af[T][1] = s_key[T];\n"
                         "              af[T][2] = (uint32_t)s_word[T];\n"
                         "              af[T][3] = ONE2 ^ (uint32_t)kb;\n")],
}
# per target: the source built, its variants, those that compute the
# histogram
TARGETS = {"t1": ("onehot_group", VARIANTS, ("full", "2x2")),
           "t7": ("onehot_r5", R5_VARIANTS, ("full",)),
           "t3": ("onehot_i8", INT_VARIANTS, ("full", "overlap", "groups")),
           "t2": ("onehot_notrans", INT_VARIANTS,
                  ("full", "overlap", "groups")),
           "t4": ("onehot_pack2", T4_VARIANTS,
                  ("full", "overlap", "groups"))}
T7_N, T7_B, T7_LEVELS = 1_001_472, 64, 6
INT_N, INT_B, INT_MS = 1_007_616, 64, (1, 4, 32)   # the T3 / T2 mains' shape


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if isinstance(old, tuple):
            i = src.find(old[0])
            j = src.find(old[1], max(i, 0))
            if i < 0 or j < i:
                raise ValueError(f"passage {old} not in {HEADER}")
            src = src[:i] + new + src[j:]
        else:
            if src.count(old) != 1:
                raise ValueError(f"passage {old!r} not once in {HEADER}")
            src = src.replace(old, new)
    return src


def build_variants(target: str = "t1") -> Dict[str, ctypes.CDLL]:
    """Each variant's library of the target's source, built in parallel;
    a variant other than ``full`` that nvcc does not build is left out."""
    source, variants, _ = TARGETS[target]
    root = nvcc.BUILD_DIR / "split" / target
    shutil.rmtree(root, ignore_errors=True)
    src = (nvcc.CSRC / HEADER).read_text()
    procs = {}
    for name, subs in variants.items():
        d = root / name
        shutil.copytree(nvcc.CSRC, d)
        (d / HEADER).write_text(variant_source(src, subs))
        so = d / f"lib{source}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
             str(d / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if name == "full":
                raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
            print(f"[build] {name}: nvcc failed ({log.strip()[-200:]}); "
                  "left out", flush=True)
            continue
        regs = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"[build] {name}: kernels {', '.join(regs) or '?'}",
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _t1_calls(dev):
    """(check, timed calls) of T1: bf16-exact gradients against the plain
    version, random ones timed."""
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
    return ((lambda: cuda_hist_onehot.onehot_group(bins, dy, pos, N_NODE, B),
             want),
            {"": lambda: cuda_hist_onehot.onehot_group(bins, gh, pos,
                                                       N_NODE, B)})


def _t7_calls(dev):
    """(check, timed calls) of T7's levels form, as in its main: u8 bins,
    pad rows past 1,000,000, int8 gradients."""
    rng = np.random.RandomState(0)
    n_real = 1_000_000
    pos = np.pad(rng.randint(0, 64, n_real).astype(np.int32),
                 (0, T7_N - n_real), constant_values=-1)[None, :]
    pos = torch.from_numpy(pos).to(dev)
    gh = torch.from_numpy(rng.randint(-127, 127, (2, T7_N)).astype(
        np.int32)).to(dev)
    bt = torch.from_numpy(rng.randint(0, T7_B, (F, T7_N)).astype(
        np.uint8)).to(dev)
    want = cuda_hist_onehot.onehot_r5_plain(bt, pos, gh, T7_B, T7_LEVELS,
                                            "u8cmp")
    print(f"wgmma one-hot kernel split (T7 at {T7_N} x {F} u8, B={T7_B}, "
          f"{T7_LEVELS} levels) | {device_name(dev)}", flush=True)

    def call(mode):
        return lambda: cuda_hist_onehot.onehot_r5(bt, pos, gh, T7_B,
                                                  T7_LEVELS, mode)
    return (call("u8cmp"), want), {m: call(m) for m in ("u8cmp", "prod")}


def _int_calls(target):
    """(check, timed calls) of T3 or T2 at the mains' shape and quantized
    gradients, M = 1, 4 and 32; the check holds all three against the
    plain version."""
    def calls(dev):
        rng = np.random.RandomState(0)
        bt = rng.randint(0, INT_B, (F, INT_N)).astype(np.int32)
        gh = torch.from_numpy(rng.randint(-127, 128, (INT_N, 2)).astype(
            np.int32)).to(dev)
        pos = {m: torch.from_numpy(rng.randint(0, m, (INT_N, 1)).astype(
            np.int32)).to(dev) for m in INT_MS}
        if target == "t3":
            bins = torch.from_numpy(bt).to(dev)
            fn, plain = (cuda_hist_onehot.onehot_i8,
                         cuda_hist_onehot.onehot_i8_plain)
        else:
            bins = torch.from_numpy(np.ascontiguousarray(
                bt.T.astype(np.uint8))).to(dev)
            fn, plain = (cuda_hist_onehot.onehot_notrans,
                         cuda_hist_onehot.onehot_notrans_plain)
        want = torch.cat([plain(bins, pos[m], gh, m, INT_B).flatten()
                          for m in INT_MS])
        print(f"wgmma one-hot kernel split ({target.upper()} at {INT_N} x "
              f"{F}, B={INT_B}, M={INT_MS}) | {device_name(dev)}",
              flush=True)
        return ((lambda: torch.cat([fn(bins, pos[m], gh, m, INT_B).flatten()
                                    for m in INT_MS]), want),
                {f"M={m}": (lambda m=m: fn(bins, pos[m], gh, m, INT_B))
                 for m in INT_MS})
    return calls


def _t4_calls(dev):
    """(check, timed calls) of T4a prod at the mains' shape, M = 1, 4 and
    32: bf16-exact gradients held against the plain version, random ones
    timed."""
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, INT_B, (F, INT_N)).astype(
        np.int32)).to(dev)
    gh = torch.from_numpy(rng.randn(INT_N, 2).astype(np.float32)).to(dev)
    dy = torch.from_numpy((rng.randint(-128, 128, (INT_N, 2)) / 64.0).astype(
        np.float32)).to(dev)
    pos = {m: torch.from_numpy(rng.randint(0, m, (INT_N, 1)).astype(
        np.int32)).to(dev) for m in INT_MS}
    fn = cuda_hist_onehot.onehot_pack2
    want = torch.cat([cuda_hist_onehot.onehot_pack2_plain(
        bins, pos[m], dy, m, n_bin=INT_B).flatten() for m in INT_MS])
    print(f"wgmma one-hot kernel split (T4 at {INT_N} x {F}, B={INT_B}, "
          f"M={INT_MS}, bf16) | {device_name(dev)}", flush=True)
    return ((lambda: torch.cat([fn(bins, pos[m], dy, m, n_bin=INT_B).flatten()
                                for m in INT_MS]), want),
            {f"M={m}": (lambda m=m: fn(bins, pos[m], gh, m, n_bin=INT_B))
             for m in INT_MS})


CALLS = {"t1": _t1_calls, "t7": _t7_calls, "t3": _int_calls("t3"),
         "t2": _int_calls("t2"), "t4": _t4_calls}


def main(reps: int = 20, target: str = "t1") -> Dict[str, List[float]]:
    """Times every variant in two rounds; returns its ms by name (and,
    for t7, mode; for t3, t2 and t4, M)."""
    if not torch.cuda.is_available():
        raise RuntimeError("hist_wgmma_split times CUDA kernels: no GPU")
    if target not in TARGETS:
        raise ValueError(f"target {target!r}: one of {sorted(TARGETS)}")
    source, _, computes = TARGETS[target]
    dev = torch.device("cuda", 0)
    libs = build_variants(target)
    (check, want), timed = CALLS[target](dev)
    committed = nvcc.load(source)
    out: Dict[str, List[float]] = {}
    try:
        for rnd, names in enumerate((list(libs), list(libs)[::-1])):
            for name in names:
                nvcc._LIBS[source] = libs[name]
                if rnd == 0 and name in computes:
                    got = check()
                    torch.cuda.synchronize(dev)
                    if not torch.equal(got, want):
                        raise RuntimeError(f"variant {name} != plain")
                for mode, fn in timed.items():
                    key = f"{name} {mode}".strip()
                    out.setdefault(key, []).append(device_ms(fn, reps, dev))
    finally:
        nvcc._LIBS[source] = committed
    for key, ms in out.items():
        print(f"{key:15s}: {' / '.join(f'{m:.4f}' for m in ms)} ms"
              + (" (== plain)" if key.split()[0] in computes else ""),
              flush=True)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]), *sys.argv[2:3])
