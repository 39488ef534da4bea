"""Round-4 bf16 one-hot histogram A/B (T6) on the card.

Port of ``tools/hist_r4_ab.py`` at its bench shape (1,007,616 x 28, B =
64, deep level M = 64; ``ops/cuda_hist_onehot.onehot_r4``,
``csrc/onehot_r4.cu``).  Variants, which differ only in how the one-hot
operand is built:

  prod      numbers: each bin compared alone, 1.0 / 0.0 selected and
            converted to bf16 in pairs (the prototype's astype(bfloat16))
  dotfloor  a constant one-hot (1.0 in bin 0): the same staging, gh_exp
            build and products, no one-hot built; prod - dotfloor is the
            one-hot build's cost
  u8bins    prod on uint8 bins (a quarter of the bin bytes)
  i16hot    the bit pattern: four bins compared at once, the flags
            widened and ANDed with bf16 1.0 (the prototype's int16 select
            of 0x3F80 and bitcast)
  rtile=K   prod at r_tile 1024, 2048 and 4096 (where the tail is
            dropped: the wgmma kernel's row step is its own)

K1, the production scatter, is timed in bf16 on the same rows.  The JAX
script's bench ceiling (from its TPU round time) is left out.

Usage: python -m xgboost_tpu_torch.tools.hist_r4_ab
"""

from __future__ import annotations

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import (_round_up, device_ms, device_name,
                                     tensor_device)

N, F, B, M = 1_000_000, 28, 64, 64
MODES = cuda_hist_onehot.R4_MODES


def build(mode, r_tile):
    """T6's ``build``: ``(fn, bins dtype)``, ``fn(binned_t (F, n), pos
    (n, 1), gh (n, 2) f32) -> (1, F * B, 128)`` f32."""
    def fn(binned_t, pos, gh):
        return cuda_hist_onehot.onehot_r4(binned_t, pos, gh, mode, r_tile, B)
    return fn, torch.uint8 if mode == "u8bins" else torch.int32


def timed(fn, binned_t, pos, gh, iters=30):
    """Mean ms of ``fn(binned_t, pos, gh)`` over ``iters`` calls (CUDA
    events after one warm-up)."""
    return device_ms(lambda: fn(binned_t, pos, gh), iters,
                     tensor_device(binned_t))


def main(n=N, device=None, iters=30):
    """Times the variants beside K1; returns the rows (name, ms, K1's ms
    and the call)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    r_tile0 = 2048
    n_pad = _round_up(n, 8192)
    binned = torch.from_numpy(rng.randint(0, B, (F, n_pad)).astype(
        np.int32)).to(dev)
    pos = torch.from_numpy(rng.randint(0, M, (n_pad, 1)).astype(
        np.int32)).to(dev)
    gh = torch.from_numpy(rng.randn(n_pad, 2).astype(np.float32)).to(dev)
    bins_u8 = binned.to(torch.uint8)
    bins_rm = bins_u8.t().contiguous()
    pos1 = pos.reshape(-1)
    print(f"T6 round-4 A/B, {n_pad} x {F}, B={B}, M={M} | "
          f"{device_name(dev)}", flush=True)
    k1 = timed(lambda b, p, g: cuda_hist.level_histogram(b, g, p, M, B,
                                                         "bf16"),
               bins_rm, pos1, gh, iters=iters)
    print(f"{'K1 bf16':18s} {k1:9.4f} ms/level", flush=True)

    results, rows = {}, []
    for mode in MODES:
        for r_tile in ((1024, 2048, 4096) if mode == "prod"
                       else (r_tile0,)):
            fn, bdt = build(mode, r_tile)
            bt = bins_u8 if bdt == torch.uint8 else binned
            ms = timed(fn, bt, pos, gh, iters=iters)
            tag = f"{mode}@r{r_tile}"
            results[tag] = ms
            print(f"{tag:18s} {ms:9.4f} ms/level (x6 = {ms * 6:8.4f} "
                  f"ms/round-equiv)", flush=True)
            rows.append(dict(name=tag, kernel="onehot_r4", ms=ms, k1_ms=k1,
                             args=(bt, pos, gh),
                             kw=dict(mode=mode, r_tile=r_tile, n_bin=B),
                             k1_args=(bins_rm, gh, pos1, M, B, "bf16")))
    p, d = results["prod@r2048"], results["dotfloor@r2048"]
    i = results["i16hot@r2048"]
    print(f"\none-hot build cost: {p - d:.4f} ms/level "
          f"({(p - d) / p * 100:.0f}% of kernel); dot floor {d:.4f} "
          f"ms/level; i16hot build cost {i - d:.4f} ms/level", flush=True)
    return rows


if __name__ == "__main__":
    main()
