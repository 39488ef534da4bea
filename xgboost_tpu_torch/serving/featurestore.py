"""Device-resident feature store: zero-upload prediction for hot
entities (port of ``xgboost_tpu/serving/featurestore.py``).

Repeat traffic scores the same entities over and over.  The store keeps
the hot set's raw f32 feature rows on the device, keyed by entity id, so
``predict_by_id`` gathers rows there and runs the engine's bucket graphs
with no host-to-device feature bytes
(``xgbtpu_predict_transfer_bytes_total`` stays flat); the index vector is
the only upload.

- Raw features, not bins: quantization runs per prediction against the
  current model's cuts, so a hot-reload that changes the cuts needs no
  invalidation.  A change of feature width does: the server swaps in a
  fresh store of the new width.
- LRU under a byte budget: capacity is ``budget // (F * 4)`` rows; a
  ``put`` past it evicts the least recently used entity (gathers and
  puts refresh recency).
- Functional slab updates: rows live in one ``(capacity + 1, F)`` device
  tensor whose last row is a permanent NaN row (the gather padding
  target, bin 0 like engine padding).  A ``put`` builds a new slab with
  ``index_copy`` and swaps it in with the id map under one lock, so a
  reader holding the previous slab never sees a torn row.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np


class FeatureStoreMiss(KeyError):
    """predict_by_id asked for entities that are not resident."""

    def __init__(self, missing: List[str]):
        super().__init__(f"{len(missing)} entity id(s) not resident")
        self.missing = missing

    def __str__(self) -> str:  # KeyError would quote the message
        return self.args[0]


class FeatureStore:
    """Device-pinned hot-entity feature rows with LRU byte-budget
    eviction.

    Args:
      num_feature: feature width F; rows are NaN-padded/truncated-
        rejected to it at ``put`` time (the model's width — take it
        from the engine).
      budget_mb: device byte budget for resident rows (capacity =
        budget / 4F rows, minimum 1).
      device: where the slab lives (``"cuda"`` by default; the engine's
        device, ``engine.device``).
    """

    def __init__(self, num_feature: int, budget_mb: float = 64.0,
                 device=None):
        if num_feature < 1:
            raise ValueError("num_feature must be >= 1")
        self.num_feature = int(num_feature)
        self.budget_bytes = int(budget_mb * (1 << 20))
        self.capacity = max(1, self.budget_bytes
                            // (4 * self.num_feature))
        # _lock guards _slots/_free/_slab for readers and the commit
        # swap; _put_lock serializes WRITERS (put/invalidate) so a put
        # can stage its slot math and run the device upload OUTSIDE
        # _lock — gathers (all /predict_by_id traffic) never wait on a
        # transfer, only on the brief map/slab swap
        self._lock = threading.Lock()
        self._put_lock = threading.Lock()
        self._slots: "OrderedDict[str, int]" = OrderedDict()  # LRU order
        self._free: List[int] = list(range(self.capacity))
        import torch
        from xgboost_tpu_torch.learner import resolve_device
        self._torch = torch
        self.device = resolve_device(device)
        # slot `capacity` is the permanent NaN padding row: gathers pad
        # their index vector with it, and every feature quantizes NaN to
        # bin 0 — identical to the engine's own batch padding
        self._slab = torch.full((self.capacity + 1, self.num_feature),
                                float("nan"), dtype=torch.float32,
                                device=self.device)

    # --------------------------------------------------------------- info
    def __len__(self) -> int:
        return len(self._slots)

    @property
    def resident_bytes(self) -> int:
        return len(self._slots) * self.num_feature * 4

    def device_bytes(self) -> int:
        """Actual device bytes of the pinned slab (allocated up front,
        independent of how many slots are filled) — what per-model
        catalog rows report next to the engine estimate."""
        return int(self._slab.numel() * self._slab.element_size())

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._slots)

    def missing(self, ids: Sequence) -> List[str]:
        """The subset of ``ids`` not resident, in request order —
        O(len(ids)) dict probes under the lock (NOT an O(capacity)
        snapshot; predict_by_id pre-scans every request through
        this)."""
        with self._lock:
            return [k for k in (str(i) for i in ids)
                    if k not in self._slots]

    def describe(self) -> dict:
        with self._lock:
            return {"rows": len(self._slots), "capacity": self.capacity,
                    "num_feature": self.num_feature,
                    "resident_bytes": self.resident_bytes}

    # ---------------------------------------------------------------- put
    def put(self, ids: Sequence, X) -> Dict[str, int]:
        """Pin rows for ``ids`` (existing ids update in place; new ids
        take free slots, evicting LRU entities past capacity).  ``X`` is
        ``(len(ids), f)`` with ``f <= num_feature`` (NaN-pads to model
        width).  A repeated id in one batch keeps its LAST row (the
        semantics of sequential puts; de-duplicated before the scatter,
        whose repeated-index winner ``index_copy`` leaves undefined).
        One upload, one functional slab update, COMMITTED only after the
        device write succeeds: slot math is staged on copies, so a failed
        upload (device OOM, runtime error) leaves membership and the
        slab exactly as they were — no id ever maps to a row that was
        not written for it.  Returns ``{"stored": n, "evicted": k}``."""
        from xgboost_tpu_torch.obs.metrics import (featurestore_metrics,
                                             predict_metrics)
        from xgboost_tpu_torch.serving.engine import pad_to_width
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[0] != len(ids):
            raise ValueError(
                f"rows {X.shape} do not match {len(ids)} ids")
        if X.shape[1] > self.num_feature:
            raise ValueError(
                f"rows have {X.shape[1]} features, store width is "
                f"{self.num_feature}")
        keys = [str(i) for i in ids]
        last = {k: j for j, k in enumerate(keys)}   # last occurrence wins
        if len(last) != len(keys):
            keys = list(last)
            X = X[list(last.values())]
        if len(keys) > self.capacity:
            raise ValueError(
                f"{len(keys)} rows exceed store capacity "
                f"{self.capacity} (budget {self.budget_bytes} bytes)")
        X = pad_to_width(X, self.num_feature)
        fm = featurestore_metrics()
        with self._put_lock:
            with self._lock:
                slots = self._slots.copy()
                free = list(self._free)
                slab0 = self._slab
            evicted = 0
            idx = np.empty(len(keys), np.int32)
            for j, k in enumerate(keys):
                slot = slots.get(k)
                if slot is None:
                    if free:
                        slot = free.pop()
                    else:
                        _, slot = slots.popitem(last=False)  # LRU
                        evicted += 1
                slots[k] = slot
                slots.move_to_end(k)
                idx[j] = slot
            torch = self._torch
            t0 = _time.perf_counter()
            rows_dev = torch.from_numpy(np.ascontiguousarray(X)).to(
                self.device)
            slab = slab0.index_copy(
                0, torch.from_numpy(idx.astype(np.int64)).to(self.device),
                rows_dev)
            if self.device.type == "cuda":
                # failure raises BEFORE any commit
                torch.cuda.current_stream(self.device).synchronize()
            # the ONE upload these rows ever cost: every later
            # predict_by_id gathers them on device for free
            predict_metrics().observe_transfer(
                X.nbytes, _time.perf_counter() - t0)
            with self._lock:
                # membership is writer-only (serialized by _put_lock);
                # gather recency refreshes that landed during the
                # upload are folded into a slightly stale LRU order —
                # an approximation, never a correctness issue
                self._slots = slots
                self._free = free
                self._slab = slab
                if evicted:
                    fm.evictions.inc(evicted)
                fm.resident_bytes.set(self.resident_bytes)
        return {"stored": len(keys), "evicted": evicted}

    # --------------------------------------------------------- invalidate
    def invalidate(self, ids: Optional[Sequence] = None) -> int:
        """Drop entities (all of them when ``ids`` is None).  Returns
        how many were resident.  Slots return to the free list; the
        slab rows are left in place (unreachable — no id maps to
        them)."""
        from xgboost_tpu_torch.obs.metrics import featurestore_metrics
        with self._put_lock, self._lock:
            if ids is None:
                n = len(self._slots)
                self._free.extend(self._slots.values())
                self._slots.clear()
            else:
                n = 0
                for k in (str(i) for i in ids):
                    slot = self._slots.pop(k, None)
                    if slot is not None:
                        self._free.append(slot)
                        n += 1
            featurestore_metrics().resident_bytes.set(self.resident_bytes)
        return n

    # -------------------------------------------------------------- gather
    def gather(self, ids: Sequence, pad_to: Optional[int] = None):
        """Device gather of the rows for ``ids``:
        ``(device (pad_to or n, F) f32, missing_ids)``.  When any id is
        missing, no device work happens (``None`` array) — the caller
        surfaces the miss.  Padding indices point at the permanent NaN
        row.  Hits refresh LRU recency; hit/miss counts feed
        ``xgbtpu_featurestore_{hits,misses}_total``."""
        from xgboost_tpu_torch.obs.metrics import featurestore_metrics
        keys = [str(i) for i in ids]
        n = len(keys)
        out_rows = pad_to if pad_to is not None else n
        if pad_to is not None and pad_to < n:
            raise ValueError(f"pad_to={pad_to} < {n} ids")
        fm = featurestore_metrics()
        with self._lock:
            missing = [k for k in keys if k not in self._slots]
            if missing:
                fm.hits.inc(n - len(missing))
                fm.misses.inc(len(missing))
                return None, missing
            idx = np.full(out_rows, self.capacity, np.int32)
            for j, k in enumerate(keys):
                idx[j] = self._slots[k]
                self._slots.move_to_end(k)
            slab = self._slab
        fm.hits.inc(n)
        # index vector is the only host→device traffic (8 bytes/row of
        # METADATA, not features — the transfer counters stay flat)
        torch = self._torch
        return slab.index_select(0, torch.from_numpy(
            idx.astype(np.int64)).to(self.device)), []


def predict_by_id(engine, store: FeatureStore, ids: Sequence,
                  output_margin: bool = False) -> np.ndarray:
    """Predict for resident entities with zero feature upload: gather
    rows on device (padded to the engine's warmed bucket), run
    :meth:`PredictEngine.predict_resident`.  Oversized id lists chunk
    through the top bucket like ``predict``.  Raises
    :class:`FeatureStoreMiss` listing absent ids (the HTTP layer maps
    it to 404 so callers know to ``put`` first)."""
    if len(ids) == 0:
        return engine.predict(np.zeros((0, store.num_feature),
                                       np.float32),
                              output_margin=output_margin)
    # pre-scan membership across ALL chunks so the miss error lists
    # every absent id at once (one put-and-retry round trip, not one
    # per chunk) and no device work runs for a doomed request; a
    # concurrent eviction between this scan and a gather still raises
    # that chunk's (smaller) miss.  This IS the dominant miss path, so
    # it feeds the hit/miss counters (gathers only run when the
    # pre-scan found everything resident)
    absent = store.missing(ids)
    if absent:
        from xgboost_tpu_torch.obs.metrics import featurestore_metrics
        fm = featurestore_metrics()
        fm.misses.inc(len(absent))
        fm.hits.inc(len(ids) - len(absent))
        raise FeatureStoreMiss(absent)
    top = engine.buckets[-1]
    parts = []
    for i in range(0, len(ids), top):
        chunk = ids[i:i + top]
        bucket = engine.bucket_for(len(chunk))
        X_dev, missing = store.gather(chunk, pad_to=bucket)
        if missing:
            raise FeatureStoreMiss(missing)
        parts.append(engine.predict_resident(X_dev, len(chunk),
                                             output_margin=output_margin))
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
