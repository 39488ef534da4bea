"""Feature-paired and one-big bf16 one-hot histograms (T4a, T4b) on the
card.

Port of ``tools/hist_pack2_proto.py`` at its bench shape (1,007,616 x
28 int32 bins, B = 64) and every real level size M = 1..32:

  prod    one feature a task (``cuda_hist_onehot.onehot_pack2``)
  pack2   two features a task (on the TPU: a full 128-row MXU operand)
  onebig  all 28 features a task (``onehot_onebig``; the TPU's one
          (F * B, R) product per row tile), at r_tile 1024 and 2048

each timed beside K1, the production scatter, in bf16 on the same rows,
with a match check at M = 32 (pack2 and onebig against prod).  On the
card all three are one launch of ``csrc/onehot_pack2.cu``, the bf16
small-N form of the ``wgmma`` kernel of ``onehot_wgmma.cuh`` (a block
stages every feature of its M tiles whatever the mode).

Usage: python -m xgboost_tpu_torch.tools.hist_pack2_proto [onebig]
(with "onebig", ``main_onebig`` runs after ``main``, as in the JAX
script).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_onehot
from xgboost_tpu_torch.tools import (_round_up, device_ms, device_name,
                                     tensor_device)

N, F, B = 1_000_000, 28, 64


def build(mode, m_pad, r_tile=2048):
    """T4a's ``build``: ``fn(binned_t (F, n) int32, pos (n, 1), gh (n, 2)
    f32) -> (1, F * B, 2 * m_pad)`` f32."""
    def fn(binned_t, pos, gh):
        return cuda_hist_onehot.onehot_pack2(binned_t, pos, gh, m_pad, mode,
                                             B, r_tile)
    return fn


def build_onebig(m_pad, r_tile=2048):
    """T4b's ``build_onebig``: T4a's function, all features a task."""
    def fn(binned_t, pos, gh):
        return cuda_hist_onehot.onehot_onebig(binned_t, pos, gh, m_pad, B,
                                              r_tile)
    return fn


def timed(fn, binned_t, pos, gh, iters=30):
    """Mean ms of ``fn(binned_t, pos, gh)`` over ``iters`` calls (CUDA
    events after one warm-up)."""
    return device_ms(lambda: fn(binned_t, pos, gh), iters,
                     tensor_device(binned_t))


def _inputs(n, device):
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_pad = _round_up(n, 8192)
    binned = torch.from_numpy(rng.randint(0, B, (F, n_pad)).astype(
        np.int32)).to(dev)
    gh = torch.from_numpy(rng.randn(n_pad, 2).astype(np.float32)).to(dev)
    return dev, rng, n_pad, binned, gh, binned.t().contiguous().to(
        torch.uint8)


def _k1(bins_rm, gh, pos, m, iters):
    pos1 = pos.reshape(-1)
    ms = timed(lambda b, p, g: cuda_hist.level_histogram(b, g, p, m, B,
                                                         "bf16"),
               bins_rm, pos1, gh, iters=iters)
    return ms, (bins_rm, gh, pos1, m, B, "bf16")


def main(n=N, levels=6, device=None, iters=30):
    """Times prod and pack2 at M = 1, 2, .. 2^(levels - 1) beside K1 and
    checks them against each other at M = 32; returns the rows (name, ms,
    K1's ms and the call) and the check."""
    dev, rng, n_pad, binned, gh, bins_rm = _inputs(n, device)
    print(f"T4a prod / pack2, {n_pad} x {F}, B={B} | {device_name(dev)}",
          flush=True)
    tot = {"prod": 0.0, "pack2": 0.0}
    rows = []
    print(f"{'M':>3s} {'prod ms':>9s} {'pack2 ms':>9s} {'K1 bf16':>9s}",
          flush=True)
    for d in range(levels):
        m = 1 << d
        pos = torch.from_numpy(rng.randint(0, m, (n_pad, 1)).astype(
            np.int32)).to(dev)
        k1, k1_args = _k1(bins_rm, gh, pos, m, iters)
        line = [m]
        for mode in ("prod", "pack2"):
            ms = timed(build(mode, m), binned, pos, gh, iters=iters)
            tot[mode] += ms
            line.append(ms)
            rows.append(dict(name=f"{mode} M={m}", kernel="onehot_pack2",
                             m=m, ms=ms, k1_ms=k1,
                             args=(binned, pos, gh, m),
                             kw=dict(mode=mode, n_bin=B),
                             k1_args=k1_args))
        print(f"{line[0]:3d} {line[1]:9.4f} {line[2]:9.4f} {k1:9.4f}",
              flush=True)
    pos = torch.from_numpy(rng.randint(0, 32, (n_pad, 1)).astype(
        np.int32)).to(dev)
    a = build("prod", 32)(binned, pos, gh)
    b = build("pack2", 32)(binned, pos, gh)
    ok = bool(torch.allclose(a, b, atol=1e-3, rtol=1e-3))
    print(f"\nper-round hist totals: prod {tot['prod']:.4f} ms, "
          f"pack2 {tot['pack2']:.4f} ms  (match at M=32: {ok})", flush=True)
    return rows, dict(match=ok)


def main_onebig(n=N, levels=6, device=None, iters=30, r_tiles=(1024, 2048)):
    """Times onebig at M = 1.. 2^(levels - 1) for each r_tile beside K1
    and checks it against prod at M = 32; returns the rows and the
    check."""
    dev, rng, n_pad, binned, gh, bins_rm = _inputs(n, device)
    print(f"T4b onebig, {n_pad} x {F}, B={B} | {device_name(dev)}",
          flush=True)
    tot = 0.0
    rows = []
    for d in range(levels):
        m = 1 << d
        pos = torch.from_numpy(rng.randint(0, m, (n_pad, 1)).astype(
            np.int32)).to(dev)
        k1, k1_args = _k1(bins_rm, gh, pos, m, iters)
        for rt in r_tiles:
            ms = timed(build_onebig(m, rt), binned, pos, gh, iters=iters)
            print(f"onebig M={m:3d} r{rt}: {ms:9.4f} ms  (K1 bf16 "
                  f"{k1:9.4f} ms)", flush=True)
            if rt == 2048:
                tot += ms
            rows.append(dict(name=f"onebig M={m} r{rt}",
                             kernel="onehot_onebig", m=m, ms=ms, k1_ms=k1,
                             args=(binned, pos, gh, m),
                             kw=dict(n_bin=B, r_tile=rt),
                             k1_args=k1_args))
    pos = torch.from_numpy(rng.randint(0, 32, (n_pad, 1)).astype(
        np.int32)).to(dev)
    a = build("prod", 32)(binned, pos, gh)
    b = build_onebig(32)(binned, pos, gh)
    ok = bool(torch.allclose(a, b, atol=1e-3, rtol=1e-3))
    print(f"onebig total {tot:.4f} ms/round-equiv; match: {ok}", flush=True)
    return rows, dict(match=ok)


if __name__ == "__main__":
    main()
    if len(sys.argv) > 1 and sys.argv[1] == "onebig":
        main_onebig()
