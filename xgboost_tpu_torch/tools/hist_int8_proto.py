"""The int8 one-hot histogram prototype (T3) on the card.

Port of ``tools/hist_int8_proto.py``: gradients quantized per round to
int8 (``round(g / s * 127)``), one-hot products of int8 x int8 summed
exactly in int32 on the tensor cores (``ops/cuda_hist_onehot.onehot_i8``,
``csrc/onehot_i8.cu``).  Times ms per level for M = 1..32 beside K1's
int mode (the production scatter on the same quantized gh), then checks
the dequantized histogram against float64 sums.

Usage: python -m xgboost_tpu_torch.tools.hist_int8_proto
"""

from __future__ import annotations

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import (_round_up, device_ms, device_name,
                                     tensor_device)

N, F, B = 1_000_000, 28, 64


def build_i8(m_pad, r_tile=2048):
    """T3's ``build_i8``: ``fn(binned_t (F, n) int32, pos (n, 1), gh (n, 2)
    int32 holding int8 values) -> (1, F * B, 2 * m_pad)`` int32."""
    def fn(binned_t, pos, gh_i8_as_i32):
        return cuda_hist_onehot.onehot_i8(binned_t, pos, gh_i8_as_i32,
                                          m_pad, B, r_tile)
    return fn


def timed(fn, *args, iters=200):
    """Mean ms of ``fn(*args)`` over ``iters`` calls (CUDA events after
    one warm-up)."""
    return device_ms(lambda: fn(*args), iters, tensor_device(*args))


def main(n=N, levels=6, device=None, iters=200):
    """Times the levels and runs the accuracy check; returns the level
    rows (M, ms, K1's ms and the call) and the check's numbers."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_pad = _round_up(n, 8192)
    binned_np = rng.randint(0, B, (F, n_pad)).astype(np.int32)
    gh = rng.randn(n_pad, 2).astype(np.float32)
    gh[:, 1] = np.abs(gh[:, 1]) * 0.25
    s_g = np.abs(gh[:, 0]).max()
    s_h = gh[:, 1].max()
    gh_i8 = np.round(gh / np.array([s_g, s_h]) * 127.0).astype(np.int32)
    binned = torch.from_numpy(binned_np).to(dev)
    gh_q = torch.from_numpy(gh_i8).to(dev)
    bins_rm = binned.t().contiguous().to(torch.uint8)   # K1's (n, F) u8
    print(f"T3 int8 one-hot, {n_pad} x {F}, B={B} | {device_name(dev)}",
          flush=True)

    rows, tot = [], 0.0
    for d in range(levels):
        m = 1 << d
        pos = torch.from_numpy(rng.randint(0, m, (n_pad, 1)).astype(
            np.int32)).to(dev)
        ms = timed(build_i8(m), binned, pos, gh_q, iters=iters)
        pos1 = pos.reshape(-1)
        k1 = timed(cuda_hist.level_histogram, bins_rm, gh_q, pos1, m, B,
                   "int", iters=iters)
        tot += ms
        print(f"int8 M={m:3d}: {ms:8.4f} ms  (K1 int {k1:8.4f} ms)",
              flush=True)
        rows.append(dict(name=f"int8 M={m}", kernel="onehot_i8", m=m,
                         ms=ms, k1_ms=k1, args=(binned, pos, gh_q, m, B),
                         kw={}, k1_args=(bins_rm, gh_q, pos1, m, B, "int")))
    print(f"int8 total: {tot:.4f} ms/round-equiv", flush=True)

    # accuracy: dequantized histogram vs float64 sums at M=32
    m = 32
    pos_np = rng.randint(0, m, (n_pad, 1)).astype(np.int32)
    hi = build_i8(m)(binned, torch.from_numpy(pos_np).to(dev), gh_q)
    deq = hi[0].cpu().numpy().reshape(F, B, 2, m).astype(np.float64)
    deq[:, :, 0, :] *= s_g / 127.0
    deq[:, :, 1, :] *= s_h / 127.0
    ref = np.zeros((F, B, 2, m))
    pb = pos_np[:, 0]
    for fi in range(F):
        np.add.at(ref[fi, :, 0, :], (binned_np[fi], pb), gh[:, 0])
        np.add.at(ref[fi, :, 1, :], (binned_np[fi], pb), gh[:, 1])
    err_g = float(np.abs(deq[:, :, 0] - ref[:, :, 0]).max())
    rel = err_g / float(np.abs(ref[:, :, 0]).max())
    # each row's code is within half a step (s / 127) of its gradient, so
    # a cell of c rows is within c * s / 254 of the exact sum (plus the
    # f32 rounding of gh / s * 127, under 1e-4 of a step)
    cnt = np.stack([np.bincount(binned_np[fi] * m + pb, minlength=B * m)
                    for fi in range(F)]).reshape(F, B, 1, m)
    step = np.array([s_g, s_h], np.float64).reshape(1, 1, 2, 1) / 127.0
    within = bool((np.abs(deq - ref) <= cnt * (0.5 + 1e-4) * step).all())
    print(f"max abs G-cell error {err_g:.3f} (rel to max cell {rel:.2e}; "
          f"cells hold ~{n_pad // (B * m)} rows); every cell within its "
          f"rows' half quantization steps: {within}", flush=True)
    return rows, dict(err_g=err_g, rel=rel, within_bound=within)


if __name__ == "__main__":
    main()
