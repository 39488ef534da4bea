"""The port's histogram microbenchmark entry points: the Pallas
prototypes of ``tools/`` (T5 ``hist_microbench``, T3 ``hist_int8_proto``,
T2 ``hist_notrans_proto``, T7 ``hist_r5_ab``, T1 ``hist_group_proto``,
T4a and T4b ``hist_pack2_proto``, T6 ``hist_r4_ab``) on the card, each
through its hand-written CUDA one-hot kernel (``ops/cuda_hist_onehot.py``)
and timed beside K1, the production scatter; and ``hist_wgmma_split``,
which times the ``wgmma`` kernel (through T1, T7's levels form, or T3's
and T2's small-N form) with one part taken out; and
``hist_scatter_split``, which does the same for K1's and K3's scatter
kernel (``csrc/hist_scatter.cuh``), times it beside its parent's
kernels and its launch plan beside the neighbouring tilings.  Run one
with

    python -m xgboost_tpu_torch.tools.hist_microbench

``launch_fleet`` brings up a local serving fleet (the router in its
process, N replicas on the card as ``python -m xgboost_tpu_torch
task=serve`` subprocesses; ``--supervise`` holds utilization in a band).

Each ``main`` runs on the card unless it is given ``device="cpu"``.
Unlike the JAX scripts, none of them catches a variant's exception: a
kernel that does not build or launch fails the run.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def device_ms(fn: Callable[[], object], reps: int,
              device: torch.device) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / reps


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (host clock: no device metric)")


def tensor_device(*args) -> torch.device:
    """The device of the first tensor among ``args``."""
    return next(a.device for a in args if isinstance(a, torch.Tensor))
