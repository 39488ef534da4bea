"""Microbenchmark of the one-hot histogram variants (T5) on the card.

Port of ``tools/hist_microbench.py``: times K1, the production scatter
(``ops/cuda_hist.level_histogram`` in bf16 on u8 bins), then the six
variants of the one-hot tensor-core kernel (the ``wgmma`` kernel of
``csrc/onehot_wgmma.cuh``) at the bench shape (1M x 28, B = 67, depth-6
level n_node = 64).  Variants:

  base      bf16 products, f32 one-hot
  bf16hot   one-hot in bf16 (the same kernel here: the one-hot is 0/1)
  i16cmp    int16 bins read by the kernel (half the bin bytes)
  r2048     the prototype's 2,048-row tile (the same kernel here: its
            row step is its own)
  f32 HIGHEST  exact f32 sums from three bf16 products per row

Usage: python -m xgboost_tpu_torch.tools.hist_microbench [n_rows] [n_feat]
[n_bin]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import device_ms, device_name, tensor_device

N_NODE = 64
VARIANTS = [
    ("base f32hot bf16mm", dict(precision="bf16", hot_dtype=torch.float32)),
    ("bf16hot bf16mm", dict(precision="bf16", hot_dtype=torch.bfloat16)),
    ("i16cmp f32hot", dict(precision="bf16", hot_dtype=torch.float32,
                           bin_dtype=torch.int16)),
    ("i16cmp bf16hot", dict(precision="bf16", hot_dtype=torch.bfloat16,
                            bin_dtype=torch.int16)),
    ("bf16hot r2048", dict(precision="bf16", hot_dtype=torch.bfloat16,
                           r_tile=2048)),
    ("f32 HIGHEST (exact)", dict(precision="fp32", hot_dtype=torch.float32)),
]


def variant(binned, gh, pos, n_node, n_bin, precision="bf16",
            hot_dtype=torch.float32, bin_dtype=torch.int32, r_tile=1024):
    """T5's ``variant``: the node-major histogram ``(n_node, F, n_bin, 2)``
    through the one-hot kernel (``cuda_hist_onehot.onehot_variant``)."""
    return cuda_hist_onehot.onehot_variant(binned, gh, pos, n_node, n_bin,
                                           precision, hot_dtype, bin_dtype,
                                           r_tile)


def timeit(fn, *args, reps=20, **kw):
    """Mean ms of ``fn(*args, **kw)``: CUDA events after one warm-up."""
    return device_ms(lambda: fn(*args, **kw), reps, tensor_device(*args))


def main(n=1_000_000, f=28, b=67, device=None, reps=20):
    """Times production and the variants; returns their rows (name, ms
    and the call) for callers that measure more."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    binned = torch.from_numpy(rng.randint(0, b, size=(n, f)).astype(
        np.int32)).to(dev)
    gh = torch.from_numpy(rng.randn(n, 2).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.randint(0, N_NODE, size=n).astype(
        np.int32)).to(dev)
    bins_u8 = binned.to(torch.uint8)
    print(f"T5 one-hot variants, {n} x {f}, B={b}, n_node={N_NODE} | "
          f"{device_name(dev)}", flush=True)

    rows = []
    ms = timeit(cuda_hist.level_histogram, bins_u8, gh, pos, N_NODE, b,
                "bf16", reps=reps)
    print(f"production bf16 (K1)   : {ms:9.4f} ms", flush=True)
    rows.append(dict(name="production bf16 (K1)", kernel="hist_level",
                     ms=ms, args=(bins_u8, gh, pos, N_NODE, b, "bf16"),
                     kw={}))
    for name, kw in VARIANTS:
        ms = timeit(variant, binned, gh, pos, N_NODE, b, reps=reps, **kw)
        print(f"{name:22s} : {ms:9.4f} ms", flush=True)
        rows.append(dict(name=name, kernel="onehot_variant", ms=ms,
                         args=(binned, gh, pos, N_NODE, b), kw=kw))
    return rows


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
