"""Round-5 one-hot histogram A/B (T7) on the card.

Port of ``tools/hist_r5_ab.py``, int8 products of feature-major u8 bins at
M = 64 (``ops/cuda_hist_onehot.onehot_r5``, ``csrc/onehot_r5.cu``).
Variants:

  prod      bins widened to int32, one compare each
  u8cmp     four packed u8 bins compared at once (SWAR); on the TPU this
            variant did not compile
  B = 67, 64, 32   the bin count
  shared6   ONE one-hot per (M tile, row step), built into shared memory
            and multiplied against 6 levels' gh_exp operands (level lv
            takes node floor_mod(pos + lv, 64), so pad rows count, as in
            the prototype)

K1's int mode is timed beside each bin count on the same rows.

Usage: python -m xgboost_tpu_torch.tools.hist_r5_ab
"""

from __future__ import annotations

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import (_round_up, device_ms, device_name,
                                     tensor_device)

N, F, M = 1_000_000, 28, 64
R_TILE = cuda_hist_onehot.R5_R_TILE


def build(mode, n_bin, n_levels=1):
    """T7's ``build``: ``fn(binned_t (F, n) u8, pos (1, n), gh (2, n)
    int32) -> (n_levels, F * n_bin, 128)`` int32."""
    def fn(binned_t, pos, gh):
        return cuda_hist_onehot.onehot_r5(binned_t, pos, gh, n_bin,
                                          n_levels, mode)
    return fn


def timed(fn, binned_t, pos, gh, iters=40):
    """Mean ms of ``fn(binned_t, pos, gh)`` over ``iters`` calls (CUDA
    events after one warm-up)."""
    return device_ms(lambda: fn(binned_t, pos, gh), iters,
                     tensor_device(binned_t))


def main(n=N, bin_counts=(67, 64, 32), device=None, iters=40):
    """Times the variants; returns their rows (name, ms, K1's ms where
    timed, and the call)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_pad = _round_up(n, R_TILE)
    pos_np = np.pad(rng.randint(0, M, n).astype(np.int32), (0, n_pad - n),
                    constant_values=-1)[None, :]
    gh_np = rng.randint(-127, 127, (2, n_pad)).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    gh = torch.from_numpy(gh_np).to(dev)
    pos1 = pos.reshape(-1)
    gh_rows = gh.t().contiguous()                     # K1's (n, 2)
    print(f"T7 round-5 A/B, {n_pad} x {F} u8 ({n} real rows), M={M} | "
          f"{device_name(dev)}", flush=True)

    rows = []
    for n_bin in bin_counts:
        bt = torch.from_numpy(rng.randint(0, n_bin, (F, n_pad)).astype(
            np.uint8)).to(dev)
        bins_rm = bt.t().contiguous()
        k1 = timed(lambda b, p, g: cuda_hist.level_histogram(
            b, g, p, M, n_bin, "int"), bins_rm, pos1, gh_rows, iters=iters)
        for mode in ("prod", "u8cmp"):
            t = timed(build(mode, n_bin), bt, pos, gh, iters=iters)
            print(f"{mode:7s} B={n_bin}: {t:8.4f} ms/level  (K1 int "
                  f"{k1:8.4f} ms)", flush=True)
            rows.append(dict(name=f"{mode} B={n_bin}", kernel="onehot_r5",
                             ms=t, k1_ms=k1, args=(bt, pos, gh, n_bin),
                             kw=dict(n_levels=1, mode=mode),
                             k1_args=(bins_rm, gh_rows, pos1, M, n_bin,
                                      "int")))
    bt = torch.from_numpy(rng.randint(0, 64, (F, n_pad)).astype(
        np.uint8)).to(dev)
    t6 = timed(build("prod", 64, n_levels=6), bt, pos, gh,
               iters=max(1, iters // 2))
    print(f"shared6 B=64: {t6:8.4f} ms for 6 levels "
          f"({t6 / 6:.4f} ms/level-equivalent)", flush=True)
    rows.append(dict(name="shared6 B=64", kernel="onehot_r5", ms=t6,
                     args=(bt, pos, gh, 64), kw=dict(n_levels=6,
                                                     mode="prod")))
    return rows


if __name__ == "__main__":
    main()
