"""The no-transpose int8 one-hot histogram prototype (T2) on the card.

Port of ``tools/hist_notrans_proto.py``: T3's int8 product fed the
original row-major (n, F) u8 bins, with no transpose and no copy
(``ops/cuda_hist_onehot.onehot_notrans``, ``csrc/onehot_notrans.cu``).
Times ms per level for M = 1..32 beside K1's int mode on the same bins,
then checks at M = 4 that the int32 sums equal exact float64 ones.

Usage: python -m xgboost_tpu_torch.tools.hist_notrans_proto
"""

from __future__ import annotations

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import (_round_up, device_ms, device_name,
                                     tensor_device)

N, F, B = 1_000_000, 28, 64


def build(m_pad, r_tile=2048):
    """T2's ``build``: ``fn(binned (n, F) u8, pos (n, 1), gh_q (n, 2)
    int32) -> (1, F * B, 2 * m_pad)`` int32."""
    def fn(binned, pos, gh_q):
        return cuda_hist_onehot.onehot_notrans(binned, pos, gh_q, m_pad, B,
                                               r_tile)
    return fn


def timed(fn, *args, iters=200):
    """Mean ms of ``fn(*args)`` over ``iters`` calls (CUDA events after
    one warm-up)."""
    return device_ms(lambda: fn(*args), iters, tensor_device(*args))


def main(n=N, levels=6, device=None, iters=200):
    """Times the levels and runs the exactness check; returns the level
    rows (M, ms, K1's ms and the call) and whether the check held."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_pad = _round_up(n, 8192)
    binned_np = rng.randint(0, B, (n_pad, F)).astype(np.uint8)
    gh = rng.randn(n_pad, 2).astype(np.float32)
    s = np.abs(gh).max(axis=0)
    ghq_np = np.round(gh / s * 127).astype(np.int32)
    binned = torch.from_numpy(binned_np).to(dev)
    gh_q = torch.from_numpy(ghq_np).to(dev)
    print(f"T2 no-transpose int8 one-hot, {n_pad} x {F} u8, B={B} | "
          f"{device_name(dev)}", flush=True)

    rows, tot = [], 0.0
    for d in range(levels):
        m = 1 << d
        pos = torch.from_numpy(rng.randint(0, m, (n_pad, 1)).astype(
            np.int32)).to(dev)
        ms = timed(build(m), binned, pos, gh_q, iters=iters)
        pos1 = pos.reshape(-1)
        k1 = timed(cuda_hist.level_histogram, binned, gh_q, pos1, m, B,
                   "int", iters=iters)
        tot += ms
        print(f"notrans-int8 M={m:3d}: {ms:8.4f} ms  (K1 int {k1:8.4f} ms)",
              flush=True)
        rows.append(dict(name=f"notrans-int8 M={m}", kernel="onehot_notrans",
                         m=m, ms=ms, k1_ms=k1, args=(binned, pos, gh_q, m, B),
                         kw={}, k1_args=(binned, gh_q, pos1, m, B, "int")))
    print(f"notrans-int8 total: {tot:.4f} ms/round-equiv", flush=True)

    # correctness vs float64 at M=4
    m = 4
    pos_np = rng.randint(0, m, (n_pad, 1)).astype(np.int32)
    out = build(m)(binned, torch.from_numpy(pos_np).to(dev), gh_q)
    out = out[0].cpu().numpy().reshape(F, B, 2, m)
    ref = np.zeros((F, B, 2, m))
    pb = pos_np[:, 0]
    for fi in range(F):
        np.add.at(ref[fi, :, 0, :], (binned_np[:, fi], pb), ghq_np[:, 0])
        np.add.at(ref[fi, :, 1, :], (binned_np[:, fi], pb), ghq_np[:, 1])
    exact = bool((out == ref).all())
    print("int32-exact match:", exact, flush=True)
    return rows, dict(exact=exact)


if __name__ == "__main__":
    main()
