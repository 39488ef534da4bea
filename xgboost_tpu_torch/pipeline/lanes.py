"""Gang-batched tenant lanes: N same-shape boosters, one launch per level
(port of ``xgboost_tpu/pipeline/lanes.py``).

The host loop of ``run_tenant_lanes`` gives each tenant its own thread
and its own launches, so the tenant count multiplies the launches of
every level.  Here a packer groups lanes by shape bucket, pads each
bucket to a power-of-two stack of lanes and of rows, and advances the
whole bucket through :func:`~xgboost_tpu_torch.models.gbtree.
scan_rounds_lanes`: per level one K4 launch and one split search for
all L tenants.

Contracts:

- **Bit-identity.**  A stacked lane's model bytes equal its host-loop
  run's.  Pad rows ride at ``row_valid=False`` / ``pos = -1`` (the
  histogram's inactive-row convention) and never touch a real lane's
  sums; a lane's int8 scale is a max over its rows and pad gradients
  are 0, so padding leaves it alone.
- **Pad lanes.**  A bucket of L real lanes pads to the next power of
  two with inactive lanes (zero bins, +inf cuts, no valid row): they
  grow degenerate trees that are thrown away.
- **Per-tenant isolation.**  Only the boosting rounds stack; gate,
  publish, ledger, quarantine and checkpoints stay per lane.  A lane
  whose absorb or checkpoint raises keeps its error to itself; a
  failure of the stacked dispatch itself sends every lane of the bucket
  back to its solo path, loudly (a ``lanes.stack_error`` event and
  ``xgbtpu_lane_solo_total{reason="stack_error"}``).
- **Solo lanes.**  A booster that :meth:`Booster.fused_lane_spec`
  declines (``ensemble``: more than one tree per round; ``prune`` with
  ``gamma > 0``; ...) runs its own rounds, with a ``lanes.solo`` event
  and ``xgbtpu_lane_solo_total{reason=...}``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from xgboost_tpu_torch.obs import event, lane_metrics, span
from xgboost_tpu_torch.pipeline.trainer import ContinuousTrainer

__all__ = ["LaneGang", "GangTrainer", "run_tenant_lanes_stacked"]


def _pow2_at_least(n: int, floor: int = 1) -> int:
    p = max(1, int(floor))
    while p < n:
        p *= 2
    return p


def _bucket_of(spec):
    """Shape-bucket key (``lanes.py:76``): everything that must agree for
    lanes to advance together -- padded rows (a power of two, at least
    64, when ``subsample == 1``), features, padded cut width (a power of
    two, at least 8), the bins' type and device, K / npar, round and
    segment counts, the grow config and the gradient's identity."""
    if spec.subsample >= 1.0:
        n_key = _pow2_at_least(spec.n_rows, 64)
    else:
        n_key = spec.n_rows
    w_key = _pow2_at_least(int(spec.cut_values.shape[1]), 8)
    return (n_key, spec.n_features, w_key, str(spec.binned.dtype),
            str(spec.binned.device), spec.K, spec.npar, spec.n_rounds,
            spec.seg_k, spec.cfg, spec.grad_fn)


def _stack_bucket(specs, n_lane: int, n_pad: int, w_pad: int):
    """The stacked device columns of a bucket: (L, n_pad, F) bins,
    (L, n_pad, K) margins, (L, n_pad) labels, weights and row_valid,
    (L, F, w_pad) cut values (+inf pad columns are inert: thresholds
    read ``cut_values[f, i]`` at ``i < n_cuts[f]`` only) and (L, F) cut
    counts.  Lanes past ``len(specs)`` are pad lanes."""
    s0 = specs[0]
    dev, F, K = s0.binned.device, s0.n_features, s0.K
    binned = torch.zeros((n_lane, n_pad, F), dtype=s0.binned.dtype,
                         device=dev)
    margin = torch.zeros((n_lane, n_pad, K), dtype=torch.float32,
                         device=dev)
    label = torch.zeros((n_lane, n_pad), dtype=torch.float32, device=dev)
    weight = torch.zeros_like(label)
    valid = torch.zeros((n_lane, n_pad), dtype=torch.bool, device=dev)
    cuts = torch.full((n_lane, F, w_pad), float("inf"),
                      dtype=torch.float32, device=dev)
    ncut = torch.zeros((n_lane, F), dtype=torch.int32, device=dev)
    for i, s in enumerate(specs):
        n = s.n_rows
        binned[i, :n] = s.binned
        margin[i, :n] = s.margin
        label[i, :n] = s.label
        weight[i, :n] = s.weight
        valid[i, :n] = True
        cuts[i, :, :s.cut_values.shape[1]] = s.cut_values
        ncut[i] = s.n_cuts
    return binned, margin, label, weight, cuts, ncut, valid


def _tokens(arrs, specs, margins) -> tuple:
    """The identities the steady-bucket carry keys on."""
    return tuple(
        (a.name, id(s.binned), id(s.label), id(s.weight), id(s.cut_values),
         id(s.n_cuts), id(m))
        for a, s, m in zip(arrs, specs, margins))


class _Arrival:
    """One lane's pending boost request at the gang rendezvous."""

    def __init__(self, name: str, spec, segment_callback):
        self.name = name
        self.spec = spec
        self.segment_callback = segment_callback
        self.done = False
        self.fallback = False   # stacked dispatch failed: run solo
        self.exc: Optional[BaseException] = None


class LaneGang:
    """Rendezvous and dispatcher for gang-batched lane training
    (``lanes.py:108``).

    Lanes call :meth:`boost` once per training cycle.  Arrivals collect
    until every registered lane is present or ``window_sec`` has passed
    since the first arrival; then one lane thread becomes the
    dispatcher: it groups the arrivals into shape buckets, pads each
    bucket and advances it segment by segment.  Late lanes form the next
    batch; batch composition never changes a lane's bytes, only how many
    lanes share the launches.  Lanes that finish or fail call
    :meth:`resign` so the rendezvous stops waiting for them.
    """

    def __init__(self, expected: int, window_sec: float = 0.2):
        self._cv = threading.Condition()
        self._expected = int(expected)
        self._window = float(window_sec)
        self._arrivals: Dict[str, _Arrival] = {}
        self._t0: Optional[float] = None
        self._dispatching = False
        self._resigned: set = set()
        # steady-bucket carry: bucket key -> (identity tokens, strong
        # refs pinning the tokenized objects, stacked device columns,
        # carried margin stack).  When the same lanes re-arrive with the
        # same operand OBJECTS (static data, the margin views handed
        # back last dispatch) the stack is reused and the margins
        # continue from the last dispatch's output; any identity change
        # re-stacks (xgbtpu_lane_restack_total).  The refs keep every
        # tokenized object alive, so a recycled id() cannot alias.
        self._carry: Dict[tuple, tuple] = {}

    def resign(self, name: str) -> None:
        """This lane will not arrive again (finished, failed, or never
        eligible): stop holding the rendezvous for it.  A lane counts
        once however often it resigns: a solo lane resigns every cycle
        and again when it finishes (the JAX package counts each call,
        so there a solo lane's later cycles split its peers' batch)."""
        with self._cv:
            if name in self._resigned:
                return
            self._resigned.add(name)
            self._expected = max(0, self._expected - 1)
            self._cv.notify_all()

    def boost(self, name: str, bst, dtrain, it0: int, n_rounds: int,
              segment_callback) -> None:
        """Advance one lane ``n_rounds`` rounds, stacked with whatever
        bucket peers arrive with it, or solo (loudly) when ineligible.
        Returns when the lane's rounds are absorbed, as
        ``Booster.update_many`` does."""
        spec, why = bst.fused_lane_spec(dtrain, it0, n_rounds)
        if spec is None:
            lane_metrics().solo.inc(why)
            event("lanes.solo", lane=name, reason=why)
            self.resign(name)  # permanent: eligibility is config-shaped
            bst.update_many(dtrain, it0, n_rounds,
                            segment_callback=segment_callback)
            return
        arr = _Arrival(name, spec, segment_callback)
        batch = None
        with self._cv:
            self._arrivals[name] = arr
            if self._t0 is None:
                self._t0 = time.monotonic()
            self._cv.notify_all()
            while not arr.done:
                full = len(self._arrivals) >= self._expected
                waited = (time.monotonic() - self._t0
                          if self._t0 is not None else 0.0)
                if ((full or waited >= self._window)
                        and not self._dispatching and not arr.done):
                    self._dispatching = True
                    batch = list(self._arrivals.values())
                    self._arrivals.clear()
                    self._t0 = None
                    break
                self._cv.wait(timeout=max(0.01, self._window / 4.0))
        if batch is not None:
            try:
                self._dispatch(batch)
            finally:
                with self._cv:
                    self._dispatching = False
                    for a in batch:
                        a.done = True
                    self._cv.notify_all()
        if arr.fallback:
            lane_metrics().solo.inc("stack_error")
            bst.update_many(dtrain, it0, n_rounds,
                            segment_callback=segment_callback)
            return
        if arr.exc is not None:
            raise arr.exc

    def _dispatch(self, batch: List[_Arrival]) -> None:
        buckets: Dict[tuple, List[_Arrival]] = {}
        for arr in batch:
            buckets.setdefault(_bucket_of(arr.spec), []).append(arr)
        lane_metrics().buckets.set(float(len(buckets)))
        for key, arrs in buckets.items():
            # a fixed lane order inside the stack (order cannot change
            # bytes; it keeps dispatch logs stable)
            arrs.sort(key=lambda a: a.name)
            try:
                self._dispatch_bucket(key, arrs)
            except Exception as e:  # whole-bucket failure: solo, loudly
                event("lanes.stack_error", lanes=[a.name for a in arrs],
                      error=f"{type(e).__name__}: {e}")
                for arr in arrs:
                    arr.fallback = True

    def _dispatch_bucket(self, key, arrs: List[_Arrival]) -> None:
        from xgboost_tpu_torch.models.gbtree import (scan_rounds_lanes,
                                                     unstack_lane_flats)
        n_pad, w_pad = key[0], key[2]
        specs = [a.spec for a in arrs]
        s0 = specs[0]
        L_real = len(specs)
        L = _pow2_at_least(L_real)
        lm = lane_metrics()

        tokens = _tokens(arrs, specs, [s.margin for s in specs])
        carry = self._carry.get(key)
        if carry is not None and carry[0] == tokens:
            binned_s, label_s, weight_s, cut_s, ncut_s, rv_s = carry[2]
            margin_s = carry[3]
        else:
            lm.restacks.inc()
            (binned_s, margin_s, label_s, weight_s, cut_s, ncut_s,
             rv_s) = _stack_bucket(specs, L, n_pad, w_pad)

        n_rounds, seg_k = s0.n_rounds, s0.seg_k
        done = 0
        views: List[Optional[torch.Tensor]] = [None] * L_real
        while done < n_rounds:
            seg = min(seg_k, n_rounds - done)
            with span("lanes.dispatch", lanes=L_real, width=L,
                      n_rounds=seg, bucket_rows=n_pad):
                t0 = time.perf_counter()
                margin_s, stacks = scan_rounds_lanes(
                    binned_s, margin_s, label_s, weight_s, cut_s, ncut_s,
                    rv_s, n_rounds=seg, cfg=s0.cfg, grad_fn=s0.grad_fn)
                # the segment's wall time includes the device's work
                if margin_s.is_cuda:
                    torch.cuda.synchronize(margin_s.device)
                dt = time.perf_counter() - t0
            lm.dispatches.inc()
            lm.dispatch_seconds.observe(dt)
            lm.stack_width.set(float(L))
            lm.stacked.inc(float(L_real))
            lm.padded.inc(float(L - L_real))
            # per-lane trees and margins are views of the stacked
            # tensors: no copy and no launch per lane
            lane_stacks = unstack_lane_flats(stacks, L)
            for i, arr in enumerate(arrs):
                if arr.exc is not None:
                    continue  # this lane failed an earlier segment
                try:
                    spec = arr.spec
                    views[i] = margin_s[i, :spec.n_rows]
                    spec.booster.absorb_lane_segment(
                        spec, lane_stacks[i], views[i], seg)
                    arr.segment_callback(
                        spec.first_iteration + done + seg - 1)
                except Exception as e:  # isolation: keep it in-lane
                    arr.exc = e
            done += seg
        if all(a.exc is None for a in arrs):
            self._carry[key] = (
                _tokens(arrs, specs, views),
                (specs, views),  # pin tokenized objects (id-reuse guard)
                (binned_s, label_s, weight_s, cut_s, ncut_s, rv_s),
                margin_s)
        else:
            self._carry.pop(key, None)


class GangTrainer(ContinuousTrainer):
    """A :class:`ContinuousTrainer` whose boosting rounds go through a
    shared :class:`LaneGang`; resume, gate, publish and ledger stay the
    per-tenant base behaviour."""

    def __init__(self, *args, gang: Optional[LaneGang] = None, **kw):
        super().__init__(*args, **kw)
        self._gang = gang

    def _boost_rounds(self, bst, dtrain, it0: int, n_rounds: int,
                      segment_callback) -> None:
        if self._gang is None:
            super()._boost_rounds(bst, dtrain, it0, n_rounds,
                                  segment_callback)
            return
        self._gang.boost(self.lane or self.publish_path, bst, dtrain,
                         it0, n_rounds, segment_callback)


def run_tenant_lanes_stacked(lanes: dict, quiet: bool = False,
                             window_sec: float = 0.2,
                             max_workers: Optional[int] = None,
                             device=None) -> dict:
    """The stacked mode of :func:`xgboost_tpu_torch.pipeline.
    run_tenant_lanes`: one thread per lane for the host phases (idle at
    the rendezvous while the device works), boosting rounds through a
    shared :class:`LaneGang`.  Same call and return shape as the host
    loop."""
    import functools

    from xgboost_tpu_torch.pipeline import run_lane_workers, run_pipeline

    gang = LaneGang(expected=len(lanes), window_sec=window_sec)
    results: dict = {}
    rlock = threading.Lock()

    def _one(name: str, kw: dict) -> None:
        kw = dict(kw)
        kw.setdefault("lane", name)
        kw.setdefault("quiet", quiet)
        kw.setdefault("device", device)
        try:
            summary = run_pipeline(
                trainer_cls=functools.partial(GangTrainer, gang=gang),
                **kw)
            with rlock:
                results[name] = {"status": "ok", "summary": summary}
        except Exception as e:  # lane isolation: never kill siblings
            with rlock:
                results[name] = {"status": "error",
                                 "error": f"{type(e).__name__}: {e}"}
            event("pipeline.lane_error", lane=name,
                  error=f"{type(e).__name__}: {e}")
        finally:
            gang.resign(name)

    if max_workers is None:
        max_workers = len(lanes)
    if lanes:
        run_lane_workers(lanes, _one, max(1, min(int(max_workers),
                                                 len(lanes))))
    return results
