"""PredictEngine: batched prediction on a loaded model with one CUDA graph
per row bucket (port of ``xgboost_tpu/serving/engine.py``).

A model is loaded once, its tree stack pinned on the device, and every
incoming batch is padded up to a small ladder of power-of-two row
buckets.  The JAX package compiles one AOT executable per bucket; here
each bucket's margin function is captured once as a
``torch.cuda.CUDAGraph`` with static input, base and output buffers.
Replaying a graph is one host call however many kernels the traversal
issues (hundreds for a 20-tree model, thousands for a multiclass one),
so a request costs its device work and not the host's launch rate.
:attr:`PredictEngine.compile_count` counts captures at the one capture
site; after :meth:`warmup` it does not move.

A graph's static buffers make it non-reentrant, unlike a JAX executable:
each bucket has a lock, and copy-in, replay and copy-out run under it.
Each bucket also has a CUDA stream of its own, on which its copies,
replays and transform run, never the legacy default stream.  Captures
take one process-wide lock (``_CAPTURE_LOCK``) and run, warm-up
included, on one capture stream per device that nothing else uses (the
one stream this module takes from PyTorch's high-priority pool, so no
bucket stream, drawn from the default-priority pool, can alias it), with
``capture_error_mode="thread_local"`` and Python's garbage collector
paused.  Entering ``torch.cuda.graph`` synchronises the device and
empties the allocator's cache, which tears a capture open in another
thread, so captures (and the destruction of graphs) take turns, while
replays never wait on that lock.  The registry can thus capture a new
model version in its poll thread while other threads replay the old
one, or another engine's buckets.  A failed capture raises; nothing on
``cuda`` runs the eager function instead.  On the CPU the same margin
function runs eagerly, one "build" per bucket.

Bitwise parity: quantization, traversal, margin accumulation and the
objective's ``pred_transform`` are row-independent, so the unpadded rows
of a padded batch equal ``Booster.predict`` on the same rows (padding
rows are NaN, which quantizes to bin 0, and are sliced off).  Every
bucket runs the fused quantize+traverse function
(:func:`~xgboost_tpu_torch.models.tree.predict_margin_fused`: raw f32
rows and the device cut matrix in), and :meth:`predict_resident` serves
device-resident feature-store rows with no host-to-device feature
bytes.  The JAX package's two-step form (``XGBTPU_SERVE_FUSED=0``:
quantize on the host, upload bins) is not ported; the variable set to
``0`` raises.

Memory: on ``cuda`` each bucket pins its static input and base buffers
and its graph's private memory pool (the output and every intermediate
of the traversal), which stays reserved while the graph lives.  The
pool's size is read at capture as the growth of
``torch.cuda.memory_reserved`` over the capture (an estimate: another
thread's allocations in that window count too), and
:meth:`PredictEngine.device_bytes` counts it.
"""

from __future__ import annotations

import gc
import os
import threading
import time as _time
from bisect import bisect_left
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_MIN_BUCKET = 8
DEFAULT_MAX_BUCKET = 8192

# One CUDA graph capture at a time in the process, and no graph destroyed
# during one (see the module docstring).  Replays never take it.
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's capture stream (under ``_CAPTURE_LOCK``): the one
    stream taken from the high-priority pool, used for nothing else."""
    s = _CAPTURE_STREAMS.get(device)
    if s is None:
        s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device, priority=-1)
    return s


def power_of_two_buckets(min_bucket: int = DEFAULT_MIN_BUCKET,
                         max_bucket: int = DEFAULT_MAX_BUCKET) -> List[int]:
    """The default bucket ladder (``engine.py:39-55``): powers of two in
    [min_bucket, max_bucket]; ``max_bucket`` is a hard cap, and when no
    power of two fits, the one bucket is ``max_bucket`` itself."""
    if min_bucket < 1 or max_bucket < min_bucket:
        raise ValueError(f"bad bucket range {min_bucket}:{max_bucket}")
    b, out = 1, []
    while b < min_bucket:
        b <<= 1
    while b <= max_bucket:
        out.append(b)
        b <<= 1
    return out or [max_bucket]


def pad_to_width(X: np.ndarray, num_feature: int) -> np.ndarray:
    """NaN-pad narrow feature rows to the model's width (NaN = missing
    quantizes to bin 0 on every path); the one definition of
    missing-width semantics for the engine and the feature store."""
    if X.shape[1] < num_feature:
        X = np.pad(X, ((0, 0), (0, num_feature - X.shape[1])),
                   constant_values=np.nan)
    return X


class _Bucket:
    """One bucket's runner: the captured graph, its static buffers and
    its stream on ``cuda``, the eager function on the CPU.  ``lock``
    serialises copy-in, run and copy-out."""

    __slots__ = ("rows", "x", "base", "out", "graph", "fn", "pool",
                 "lock", "stream")

    def __init__(self, rows, x, base, out, graph, fn, pool=0, stream=None):
        self.rows, self.x, self.base, self.out = rows, x, base, out
        self.graph, self.fn = graph, fn
        self.pool = pool                # bytes the graph's pool reserved
        self.stream = stream            # the bucket's CUDA stream
        self.lock = threading.Lock()

    def on_stream(self):
        """The context that makes the bucket's stream current (nothing
        on the CPU)."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())

    def run(self) -> torch.Tensor:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.out = self.fn(self.x, self.base)
        return self.out

    def nbytes(self) -> int:
        """The static input and base, plus the graph's pool (which holds
        the output) on ``cuda`` or the last output on the CPU."""
        out = () if self.graph is not None else (self.out,)
        return self.pool + sum(t.numel() * t.element_size()
                               for t in (self.x, self.base) + out
                               if t is not None)


class PredictEngine:
    """Batched prediction over one loaded model.

    Args:
      model: a model file path, raw model bytes, or a trained/loaded
        :class:`~xgboost_tpu_torch.learner.Booster` (whose device the
        engine uses).
      buckets: explicit row-bucket ladder; default powers of two
        ``min_bucket..max_bucket``.  Larger requests go through the top
        bucket in chunks.
      warmup: capture (or build) and run every bucket at construction.
      metrics: optional :class:`xgboost_tpu_torch.obs.ServingMetrics`.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``,
        for a model given as a path or bytes.
    """

    def __init__(self, model, buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: int = DEFAULT_MAX_BUCKET,
                 warmup: bool = False, metrics=None, device=None):
        if os.environ.get("XGBTPU_SERVE_FUSED", "1") == "0":
            raise NotImplementedError(
                "XGBTPU_SERVE_FUSED=0: the two-step serving form (host "
                "quantization, bins uploaded) is not ported; the engine "
                "quantizes inside each bucket's graph")
        from xgboost_tpu_torch.learner import Booster
        if isinstance(model, Booster):
            booster = model
        else:
            booster = Booster(device=device)
            if isinstance(model, (bytes, bytearray)):
                booster.load_raw(bytes(model))
            else:
                booster.load_model(model)
        if booster.gbtree is None:
            raise ValueError("PredictEngine needs a trained/loaded model")
        if booster.param.booster == "gblinear":
            raise NotImplementedError(
                "PredictEngine serves gbtree models (binned tree "
                "traversal); gblinear predict is already a single matmul "
                "— serve it via Learner.predict")
        if booster.gbtree.exact_raw:
            raise NotImplementedError(
                "exact-mode (grow_colmaker) models route on raw values; "
                "the serving engine's binned bucket cache does not apply")
        self.booster = booster
        self.device = booster.device
        self.gbtree = booster.gbtree
        self.obj = booster.obj
        self.cuts = self.gbtree.cuts
        self.num_feature = booster.num_feature or self.cuts.num_feature
        self._K = max(1, booster.param.num_output_group)
        self._max_depth = self.gbtree.cfg.max_depth
        self._n_roots = self.gbtree.cfg.n_roots
        self.buckets = (sorted(set(int(b) for b in buckets)) if buckets
                        else power_of_two_buckets(min_bucket, max_bucket))
        if self.buckets[0] < 1:
            raise ValueError("buckets must be >= 1")
        self.metrics = metrics
        self.compile_count = 0          # bumped at the ONLY capture site
        self._compiled: Dict[int, _Bucket] = {}
        self._lock = threading.Lock()
        self._base_scalar = float(
            self.obj.prob_to_margin(booster.param.base_score))
        # the traversal layout: the serving T is fixed, so the padded
        # stack and its groups are built once, on the device
        from xgboost_tpu_torch.models.tree import (pad_predict_stack,
                                                   predict_chunk_layout)
        self._tree_chunk = self.gbtree.pred_chunk
        stack, group = self.gbtree._stack(0)
        T = int(stack.feature.shape[0])
        _, _, self._n_chunks = predict_chunk_layout(
            T, max(self._tree_chunk, 1))
        if self._tree_chunk > 1:
            stack, group, self._n_valid = pad_predict_stack(
                stack, group.to(self.device), self._tree_chunk)
        else:
            # the per-tree path reads the groups from this host tensor
            self._n_valid = T
        self._stack, self._group = stack, group
        self._cuts_dev = self.gbtree.cut_values_dev
        self._warming = False
        if warmup:
            self.warmup()

    # ------------------------------------------------------------- buckets
    def bucket_for(self, n_rows: int) -> int:
        """Smallest bucket >= n_rows (the top bucket for larger batches;
        callers chunk through it)."""
        i = bisect_left(self.buckets, n_rows)
        return self.buckets[min(i, len(self.buckets) - 1)]

    # ------------------------------------------------------------- compile
    def margin_function(self):
        """``fn(x, base) -> (rows, K) margins`` for one bucket, x raw f32
        rows (NaN = missing): :func:`predict_margin_fused` on the stack
        padded at load.  The function the graphs capture; the CPU runs
        it eagerly."""
        from xgboost_tpu_torch.models.tree import predict_margin_fused
        stack, group, cuts = self._stack, self._group, self._cuts_dev
        max_depth, K, n_roots = self._max_depth, self._K, self._n_roots
        chunk = self._tree_chunk
        n_valid = self._n_valid if chunk > 1 else None

        def fn(x, base):
            return predict_margin_fused(stack, group, x, cuts, base,
                                        max_depth, K, None, n_roots, chunk,
                                        n_valid)
        return fn

    def _inputs(self, bucket: int):
        x = torch.full((bucket, self.cuts.num_feature), float("nan"),
                       dtype=torch.float32, device=self.device)
        base = torch.full((bucket, self._K), self._base_scalar,
                          dtype=torch.float32, device=self.device)
        return x, base

    def _executable(self, bucket: int) -> _Bucket:
        """The bucket's runner: on ``cuda`` a CUDA graph of the margin
        function, captured once on the bucket's own stream (after a
        warm-up run there) with its static buffers, under the
        process-wide capture lock; on the CPU the eager function.  A
        failed capture raises."""
        exe = self._compiled.get(bucket)
        if exe is not None:
            return exe
        with self._lock:
            exe = self._compiled.get(bucket)
            if exe is not None:
                return exe
            fn = self.margin_function()
            if self.device.type == "cuda":
                stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(stream):
                    x, base = self._inputs(bucket)
                with _CAPTURE_LOCK:
                    cs = _capture_stream(self.device)
                    cs.wait_stream(stream)
                    gc_on = gc.isenabled()
                    gc.disable()
                    try:
                        with torch.cuda.stream(cs):
                            fn(x, base)      # allocations before capture
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(
                                graph, stream=cs,
                                capture_error_mode="thread_local"):
                            # read after entering: entering empties the
                            # cache
                            r0 = torch.cuda.memory_reserved(self.device)
                            out = fn(x, base)
                        pool = max(0, torch.cuda.memory_reserved(self.device)
                                   - r0)
                    finally:
                        if gc_on:
                            gc.enable()
                    stream.wait_stream(cs)
                exe = _Bucket(bucket, x, base, out, graph, None, pool,
                              stream)
            else:
                x, base = self._inputs(bucket)
                exe = _Bucket(bucket, x, base, None, None, fn)
            self.compile_count += 1
            if self.metrics is not None:
                self.metrics.compiles.inc()
            self._compiled[bucket] = exe
            return exe

    def warmup(self) -> None:
        """Capture every bucket and run each once end to end, margins
        and transform, so a reloaded model warms off the serving path.
        Row counters skip the warmup rows; ``compiles_total`` counts
        the captures."""
        F = self.cuts.num_feature
        saved, self.metrics = self.metrics, None
        self._warming = True
        c0 = self.compile_count
        try:
            for b in self.buckets:
                self.predict(np.zeros((b, F), np.float32))
                self.predict(np.zeros((b, F), np.float32),
                             output_margin=True)
        finally:
            self.metrics = saved
            self._warming = False
            if saved is not None and self.compile_count > c0:
                saved.compiles.inc(self.compile_count - c0)

    def release(self) -> None:
        """Drop every bucket's graph and static buffers (each graph holds
        a memory pool of its own), waiting for a replay in progress.  A
        later call captures again."""
        with self._lock:
            runners = list(self._compiled.values())
            self._compiled = {}
        with _CAPTURE_LOCK if self.device.type == "cuda" else nullcontext():
            for r in runners:
                with r.lock:
                    r.graph = r.x = r.base = r.out = None

    # ------------------------------------------------------------- predict
    def predict(self, X, output_margin: bool = False) -> np.ndarray:
        """Predict a 2-D float batch; bitwise-equal to
        ``booster.predict(DMatrix(X))`` on the supplied rows."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"expected 2-D rows, got shape {X.shape}")
        if X.shape[1] > self.num_feature:
            raise ValueError(
                f"data has {X.shape[1]} features, model was trained "
                f"with {self.num_feature}")
        n = X.shape[0]
        if n == 0:
            out = self.obj.pred_transform(
                torch.zeros((0, self._K), dtype=torch.float32),
                output_margin=output_margin).numpy()
            return out[:, 0] if out.shape[1] == 1 else out
        top = self.buckets[-1]
        if n > top:
            parts = [self.predict(X[i:i + top], output_margin)
                     for i in range(0, n, top)]
            return np.concatenate(parts, axis=0)
        bucket = self.bucket_for(n)
        payload = pad_to_width(X, self.num_feature)
        if bucket > n:
            payload = np.pad(payload, ((0, bucket - n), (0, 0)),
                             constant_values=np.nan)
        if self.metrics is not None:
            self.metrics.rows.inc(n)
            self.metrics.padded_rows.inc(bucket - n)
        from xgboost_tpu_torch.obs.metrics import (predict_metrics,
                                                   timed_device_put)
        pm = None if self._warming else predict_metrics()
        exe = self._executable(bucket)
        payload = np.ascontiguousarray(payload)

        def load(x):
            # the upload is timed and counted apart from the traversal
            timed_device_put(payload, x, pm.observe_transfer
                             if pm is not None else None)
        return self._margin_out(exe, load, n, output_margin, pm,
                                transfer_bytes=payload.nbytes)

    def predict_resident(self, X_dev: torch.Tensor, n: int,
                         output_margin: bool = False) -> np.ndarray:
        """Predict a device-resident ``(bucket, F)`` f32 block with no
        host-to-device feature bytes (the feature-store path): the block
        is copied device to device into the bucket's static input.  Rows
        past ``n`` are padding.  The block's row count must be a bucket
        (callers pad through :meth:`bucket_for`)."""
        bucket = int(X_dev.shape[0])
        if self.metrics is not None:
            self.metrics.rows.inc(n)
            self.metrics.padded_rows.inc(bucket - n)
        from xgboost_tpu_torch.obs.metrics import predict_metrics
        pm = None if self._warming else predict_metrics()
        exe = self._executable(bucket)

        src = (torch.cuda.current_stream(self.device)
               if self.device.type == "cuda" else None)

        def load(x):
            if src is not None:
                # the block was written on the caller's stream; the copy
                # runs on the bucket's
                torch.cuda.current_stream(self.device).wait_stream(src)
                X_dev.record_stream(torch.cuda.current_stream(self.device))
            x.copy_(X_dev)
        return self._margin_out(exe, load, n, output_margin, pm,
                                transfer_bytes=0)

    def _margin_out(self, exe: _Bucket, load, n: int, output_margin: bool,
                    pm, transfer_bytes: int) -> np.ndarray:
        """Load the bucket's input, run it and transform, under the
        bucket's lock: the shared tail of :meth:`predict` and
        :meth:`predict_resident`.  The transform runs outside the graph
        through the objective's own ``pred_transform``, the function
        ``Booster.predict`` calls."""
        from xgboost_tpu_torch.obs import span
        with span("serve.predict", rows=n, bucket=exe.rows,
                  chunk=self._tree_chunk, chunks=self._n_chunks,
                  transfer_bytes=transfer_bytes):
            while True:
                exe.lock.acquire()
                if exe.x is not None:
                    break
                # released since it was looked up (an engine the registry
                # dropped, still finishing a batch): capture it again
                exe.lock.release()
                exe = self._executable(exe.rows)
            try:
                with exe.on_stream():
                    load(exe.x)
                    t0 = _time.perf_counter()
                    margin = exe.run()
                    if exe.stream is not None:
                        exe.stream.synchronize()
                    if pm is not None:
                        pm.chunk_seconds.observe(
                            (_time.perf_counter() - t0)
                            / max(self._n_chunks, 1))
                    out = self.obj.pred_transform(
                        margin, output_margin=output_margin)[:n].cpu().numpy()
            finally:
                exe.lock.release()
        if pm is not None:
            pm.rows.inc(n)
        return out[:, 0] if out.shape[1] == 1 else out

    # ------------------------------------------------------------- info
    @property
    def num_compiled(self) -> int:
        return len(self._compiled)

    def device_bytes(self) -> int:
        """Device bytes this engine pins: the padded tree stack, groups
        and cut matrix, plus every bucket's static input and base buffers
        and, on ``cuda``, its graph's private pool as reserved at capture
        (output and intermediates).  What the catalog's
        ``serve_catalog_mb`` budget meters."""
        n = sum(t.numel() * t.element_size() for t in self._stack)
        n += self._group.numel() * self._group.element_size()
        n += self._cuts_dev.numel() * self._cuts_dev.element_size()
        for exe in list(self._compiled.values()):
            n += exe.nbytes()
        return int(n)

    def describe(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "compiled": sorted(self._compiled),
            "compile_count": self.compile_count,
            "num_feature": self.num_feature,
            "num_trees": self.gbtree.num_trees,
            "objective": self.booster.param.objective,
            "tree_chunk": self._tree_chunk,
            "tree_chunks": self._n_chunks,
            "fused": True,
            "device": str(self.device),
            "graphs": self.device.type == "cuda",
        }
