"""Feature-grouped bf16 one-hot histogram (T1) on the card.

Port of ``tools/hist_group_proto.py``: the node-major level histogram of
1M x 28 int32 bins, B = 67, n_node = 64 through T1's tensor-core kernel
(``ops/cuda_hist_onehot.onehot_group``, ``csrc/onehot_group.cu``) for fg
in (2, 4, 7, 14) and r_tile in (1024, 2048, 4096), timed beside K1, the
production scatter, in bf16 on the same rows.  A 4,096-row accuracy line
holds the kernel at fg = 4 against K1 fp32.

On the TPU a group of fg features filled more of the MXU's rows.  Here
the ``wgmma`` kernel (``csrc/onehot_wgmma.cuh``, T5's too) concatenates
every feature's one-hot along M and stages a block's rows once for all
the features of its M tiles, so fg and r_tile change nothing and the
rows time the same kernel.  The JAX script also builds an fp32 K1
histogram of all rows that it never reads; this port leaves it out.

Usage: python -m xgboost_tpu_torch.tools.hist_group_proto
"""

from __future__ import annotations

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import device_name
from xgboost_tpu_torch.tools.hist_microbench import timeit

N, F, B, N_NODE = 1_000_000, 28, 67, 64
FGS = (2, 4, 7, 14)
R_TILES = (1024, 2048, 4096)
CHECK_ROWS = 4096


def grouped(binned, gh, pos, n_node, n_bin, fg=4, r_tile=2048,
            hot_dtype=torch.bfloat16):
    """T1's ``grouped``: ``(n_node, F, n_bin, 2)`` f32 through the
    feature-grouped kernel (``cuda_hist_onehot.onehot_group``)."""
    return cuda_hist_onehot.onehot_group(binned, gh, pos, n_node, n_bin, fg,
                                         r_tile, hot_dtype)


def main(n=N, f=F, b=B, n_node=N_NODE, device=None, reps=20, fgs=FGS,
         r_tiles=R_TILES):
    """Runs the accuracy line and times K1 and every (fg, r_tile);
    returns the rows (name, ms, K1's ms and the call) and the accuracy
    line (its error, the two histograms and their inputs)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    binned = torch.from_numpy(rng.randint(0, b, size=(n, f)).astype(
        np.int32)).to(dev)
    gh = torch.from_numpy(rng.randn(n, 2).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.randint(0, n_node, size=n).astype(
        np.int32)).to(dev)
    bins_u8 = binned.to(torch.uint8)
    print(f"T1 feature-grouped one-hot, {n} x {f}, B={b}, n_node={n_node} | "
          f"{device_name(dev)}", flush=True)

    k = min(CHECK_ROWS, n)
    got = grouped(binned[:k], gh[:k], pos[:k], n_node, b, fg=4)
    ref4 = cuda_hist.level_histogram(bins_u8[:k], gh[:k], pos[:k], n_node, b,
                                     "fp32").permute(3, 0, 1, 2)
    err = float((got - ref4).abs().max())
    print(f"small parity max err (bf16 vs f32): {err}", flush=True)

    k1 = timeit(cuda_hist.level_histogram, bins_u8, gh, pos, n_node, b,
                "bf16", reps=reps)
    print(f"production bf16   : {k1:9.4f} ms", flush=True)
    rows = [dict(name="production bf16 (K1)", kernel="hist_level", ms=k1,
                 args=(bins_u8, gh, pos, n_node, b, "bf16"), kw={})]
    for fg in fgs:
        for r in r_tiles:
            ms = timeit(grouped, binned, gh, pos, n_node, b, fg=fg,
                        r_tile=r, reps=reps)
            print(f"grouped fg={fg:2d} r={r:5d}: {ms:9.4f} ms", flush=True)
            rows.append(dict(name=f"grouped fg={fg} r={r}",
                             kernel="onehot_group", ms=ms, k1_ms=k1,
                             args=(binned, gh, pos, n_node, b),
                             kw=dict(fg=fg, r_tile=r)))
    return rows, dict(err=err, got=got, ref=ref4,
                      args=(binned[:k], gh[:k], pos[:k], n_node, b))


if __name__ == "__main__":
    main()
