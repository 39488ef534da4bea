"""Model registry: watch a model path, hot-reload atomically, keep
previous versions for instant rollback (port of
``xgboost_tpu/serving/registry.py``).  An engine that falls off the
rollback ring releases its CUDA graphs, each of which holds a memory
pool of its own.

Reload protocol (the "load + warm OFF the serving path, then swap a
reference" design, SERVING.md):

1. a poll notices the file changed (mtime/size fast path, content hash
   to confirm — a rewrite with identical bytes is NOT a reload);
2. the new model is loaded into a FRESH :class:`PredictEngine` and
   warmed (every bucket captured and run) while the old engine keeps
   serving;
3. one reference assignment swaps the engines.  In-flight batches hold
   the old engine reference and finish on it — no request ever sees a
   half-loaded model;
4. the old (version, engine) pair is pushed onto a bounded rollback
   ring (``keep_versions`` deep); :meth:`rollback` swaps it straight
   back without touching disk.

Failure paths (RELIABILITY.md): file bytes are CRC-verified BEFORE any
engine build, and content that fails to load is remembered as a
poisoned fingerprint — hashed-and-rejected on later polls instead of
re-built and re-warmed every second — until the file changes again.
``last_reload_error``/``reload_failures`` feed the HTTP ``/healthz``
degraded state.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
from collections import deque
from typing import Optional, Tuple

import numpy as np

from xgboost_tpu_torch.obs import event, span
from xgboost_tpu_torch.reliability import faults
from xgboost_tpu_torch.reliability.integrity import (read_file,
                                                     verify_model_bytes)
from xgboost_tpu_torch.serving.engine import PredictEngine


class VersionedArray(np.ndarray):
    """ndarray tagged with the model version that PRODUCED it.  The tag
    survives slicing (the batcher scatters one batch's output across
    callers), so a response's ``model_version`` names the model that
    actually ran — not whatever was current when the request arrived,
    which can differ across a hot-reload."""

    model_version: int = 0

    def __array_finalize__(self, obj):
        self.model_version = getattr(obj, "model_version", 0)

    @classmethod
    def tag(cls, arr: np.ndarray, version: int) -> "VersionedArray":
        out = np.asarray(arr).view(cls)
        out.model_version = version
        return out


class ModelRegistry:
    """Owns the live engine + its predecessors for one model path."""

    def __init__(self, path: str, keep_versions: int = 2,
                 warmup: bool = True, poll_sec: float = 1.0,
                 metrics=None, **engine_kwargs):
        self.path = path
        self.keep_versions = int(keep_versions)
        self.warmup = bool(warmup)
        self.poll_sec = float(poll_sec)
        self.metrics = metrics
        self.engine_kwargs = engine_kwargs
        self.version = 0
        self._engine: Optional[PredictEngine] = None
        # the content hash of the model the live engine was BUILT from
        # (not necessarily the on-disk file's — a rollback diverges
        # them): what /healthz reports and the fleet rollout controller
        # verifies (fleet/rollout.py)
        self._hash: Optional[str] = None
        self._previous: deque = deque(maxlen=max(0, self.keep_versions))
        self._fp: Optional[Tuple] = None
        # the failure-path ledger: the fingerprint of content that
        # failed to load (so it is never re-built until the file changes
        # AGAIN), plus what /healthz reports about it
        self._poisoned: Optional[Tuple] = None
        self.last_reload_error: Optional[str] = None
        self.reload_failures = 0
        self.build_attempts = 0
        self._reload_lock = threading.Lock()   # one reload at a time
        self._swap_lock = threading.Lock()     # guards engine/version swap
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._load_initial()

    # ------------------------------------------------------------- loading
    def _read_fingerprinted(self) -> Tuple[bytes, Tuple]:
        """One read of the watched file -> (raw bytes, (mtime_ns, size,
        sha256)).  The same bytes feed verification AND the engine
        build, so the content that was hashed is the content that
        loads — no torn-rewrite race between a hash pass and a second
        read."""
        st = os.stat(self.path)
        raw = read_file(self.path)
        return raw, (st.st_mtime_ns, st.st_size,
                     hashlib.sha256(raw).hexdigest())

    def _build_engine(self, raw: bytes) -> PredictEngine:
        """Verify + build + warm an engine from raw file bytes.  Raises
        ModelIntegrityError on torn/bit-flipped content BEFORE any
        device work is spent on it."""
        self.build_attempts += 1
        payload = verify_model_bytes(raw, name=self.path)
        faults.check("reload", path=self.path)  # chaos seam
        engine = PredictEngine(bytes(payload), metrics=self.metrics,
                               **self.engine_kwargs)
        if self.warmup:
            engine.warmup()
        return engine

    def _load_initial(self) -> None:
        raw, fp = self._read_fingerprinted()
        engine = self._build_engine(raw)
        with self._swap_lock:
            self._engine, self._fp = engine, fp
            self._hash = fp[2]
            self.version = 1
        if self.metrics is not None:
            self.metrics.model_version.set(self.version)

    @property
    def poisoned(self) -> bool:
        """True while the on-disk file is known-bad (the last reload
        failed and the file has not changed since) — the serving stack
        is healthy but DEGRADED: it cannot pick up the newest bytes."""
        return self._poisoned is not None

    # --------------------------------------------------------------- state
    @property
    def engine(self) -> PredictEngine:
        """The live engine.  Reference reads are atomic; callers that
        need (version, engine) consistent use :meth:`current`."""
        return self._engine

    @property
    def content_hash(self) -> Optional[str]:
        """sha256 of the model content the LIVE engine serves.  Follows
        engine swaps — after a rollback it names the rolled-back-to
        content, not the newer on-disk file — so a fleet controller
        (or a human) can verify what each replica actually runs."""
        return self._hash

    def current(self) -> Tuple[int, PredictEngine]:
        with self._swap_lock:
            return self.version, self._engine

    def describe(self) -> dict:
        """Registry + engine description for operators (the fleet
        rollout controller reads ``model_hash`` to verify a push)."""
        with self._swap_lock:
            d = {"path": self.path,
                 "model_version": self.version,
                 "model_hash": self._hash,
                 "previous_versions": [v for v, _, _ in self._previous],
                 "poisoned": self._poisoned is not None,
                 "reload_failures": self.reload_failures,
                 "last_reload_error": self.last_reload_error,
                 "build_attempts": self.build_attempts}
            engine = self._engine
        d["engine"] = engine.describe()
        return d

    def device_bytes(self) -> int:
        """Device bytes pinned by the LIVE engine plus the warm
        rollback ring — the unit the model catalog's shared budget
        accounts (catalog/catalog.py)."""
        with self._swap_lock:
            engines = [self._engine] + [e for _, e, _ in self._previous]
        return sum(e.device_bytes() for e in engines if e is not None)

    def release(self) -> None:
        """Release the graphs of the live engine and of every engine in
        the rollback ring (each graph holds a memory pool of its own):
        the catalog calls it when it evicts the model."""
        with self._swap_lock:
            engines = [self._engine] + [e for _, e, _ in self._previous]
        for e in engines:
            if e is not None:
                e.release()

    def predict(self, X, output_margin: bool = False):
        """Predict on whatever model is current when the call starts
        (the batcher's per-batch engine resolution); the result is
        tagged with the version that ran (:class:`VersionedArray`)."""
        version, engine = self.current()
        out = engine.predict(X, output_margin=output_margin)
        return VersionedArray.tag(out, version)

    # -------------------------------------------------------------- reload
    def check_reload(self, force: bool = False) -> bool:
        """Poll once: reload + swap if the file content changed.
        Returns True when a new model went live.

        Failure paths (RELIABILITY.md): a load that fails — torn file
        racing the poll, CRC mismatch, injected fault — keeps the old
        model serving and POISONS the new content's fingerprint: the
        bad bytes are hashed-and-rejected (cheap) on later polls
        instead of re-built and re-warmed (every bucket captured again)
        every second, until the file changes again.  ``/healthz``
        surfaces ``last_reload_error`` while poisoned.

        ``force=True`` (the ``POST /-/reload`` endpoint) bypasses BOTH
        short-circuits — the poisoned skip and the stat fast path — and
        re-reads the file: the operator's escape hatch when the failure
        was transient (device OOM during warmup, injected fault) rather
        than bad bytes, and the only way to pick up a rewrite that
        preserved mtime+size (``rsync -a`` / ``cp -p`` of a same-sized
        model), which the stat-compare poll is blind to by design."""
        with self._reload_lock:
            try:
                st = os.stat(self.path)
            except OSError:
                return False  # file mid-replace; next poll sees the result
            stat = (st.st_mtime_ns, st.st_size)
            if (not force and self._fp is not None
                    and stat == self._fp[:2]):
                return False  # per-poll fast path: stat unchanged, no read
            if (not force and self._poisoned is not None
                    and stat == self._poisoned[:2]):
                # known-bad file, not even touched since: skip the read
                self._count_poisoned_skip()
                return False
            try:
                raw, fp = self._read_fingerprinted()
            except OSError:
                return False
            if self._hash is not None and fp[2] == self._hash:
                # file content matches what the LIVE ENGINE serves:
                # not a reload.  Compared against the engine's hash,
                # NOT the last-loaded fingerprint — after a rollback
                # the two diverge, and a push of the very bytes the
                # engine rolled back FROM must load again (the fleet
                # controller's rollback restores files, then a later
                # rollout may legitimately re-push the same model)
                self._fp = fp
                if self._poisoned is not None:
                    # the file was rolled BACK to the live content (an
                    # operator undoing a bad push): it is no longer
                    # known-bad — clear the degraded state
                    self._poisoned = None
                    self.last_reload_error = None
                return False
            if (not force and self._poisoned is not None
                    and fp[2] == self._poisoned[2]):
                # rewritten with the SAME bad bytes: refresh the stat so
                # the next poll short-circuits, but do not rebuild
                self._poisoned = fp
                self._count_poisoned_skip()
                return False
            try:
                with span("serving.reload_build", path=self.path):
                    engine = self._build_engine(raw)
            except Exception as e:
                self.reload_failures += 1
                self.last_reload_error = f"{type(e).__name__}: {e}"
                self._poisoned = fp
                if self.metrics is not None:
                    self.metrics.reload_errors.inc()
                event("serving.reload_failed", path=self.path,
                      error=self.last_reload_error)
                print(f"[serving] reload failed, keeping v{self.version} "
                      f"(file poisoned until it changes): {e}",
                      file=sys.stderr)
                return False
            with self._swap_lock:
                dropped = self._push_previous(self.version, self._engine,
                                              self._hash)
                self._engine, self._fp = engine, fp
                self._hash = fp[2]
                self._poisoned = None
                self.last_reload_error = None
                self.version += 1
                v = self.version
            if dropped is not None:
                dropped.release()
            if self.metrics is not None:
                self.metrics.reloads.inc()
                self.metrics.model_version.set(v)
            event("serving.reload", path=self.path, model_version=v)
            return True

    def _push_previous(self, version: int, engine: PredictEngine,
                       content_hash: Optional[str]):
        """Push onto the rollback ring; returns the engine that fell off
        it (None when nothing did), for the caller to release outside
        the swap lock.  With ``keep_versions=0`` the outgoing engine
        itself falls off."""
        if self._previous.maxlen == 0:
            return engine
        dropped = (self._previous[0][1]
                   if len(self._previous) == self._previous.maxlen else None)
        self._previous.append((version, engine, content_hash))
        return dropped

    @staticmethod
    def _count_poisoned_skip() -> None:
        from xgboost_tpu_torch.profiling import reliability_metrics
        reliability_metrics().poisoned_reloads.inc()

    def rollback(self) -> bool:
        """Swap the most recent previous version back in (no disk I/O —
        its engine is still warm).  Returns False when the ring is
        empty.

        Deliberately NOT serialized behind ``_reload_lock``: rollback is
        the emergency path and must stay instant even while a (slow)
        reload build holds that lock — it only mutates in-memory state,
        so the swap lock suffices.  A reload that completes after the
        rollback still swaps its model in (it was requested by a newer
        file change); roll back again to undo it."""
        with self._swap_lock:
            if not self._previous:
                return False
            old_version, old_engine, old_hash = self._previous.pop()
            # the outgoing engine goes onto the ring in turn, so an
            # accidental rollback is itself reversible (rollback twice
            # toggles between the two newest versions)
            self._previous.append((self.version, self._engine,
                                   self._hash))
            self._engine = old_engine
            self._hash = old_hash
            # _fp still holds the on-disk fingerprint, so the next
            # poll will NOT re-load the model just rolled back from;
            # the rollback sticks until the file actually changes
            self.version += 1
            v = self.version
        if self.metrics is not None:
            self.metrics.model_version.set(v)
        event("serving.rollback", to_engine_of=old_version,
              model_version=v)
        print(f"[serving] rolled back to engine of v{old_version} "
              f"(now v{v})", file=sys.stderr)
        return True

    # ---------------------------------------------------------------- poll
    def start(self) -> None:
        """Start the background poll thread (no-op when poll_sec <= 0)."""
        if self.poll_sec <= 0 or self._poller is not None:
            return
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="xgbtpu-model-poll")
        self._poller.start()

    def _poll_loop(self) -> None:
        from xgboost_tpu_torch.reliability.deadline import jittered
        # ±20% jitter: a fleet of replicas watching the same published
        # model file must not stat it in lockstep every poll tick
        while not self._stop.wait(jittered(self.poll_sec)):
            try:
                self.check_reload()
            except Exception as e:  # the poller must survive anything
                print(f"[serving] poll error: {e}", file=sys.stderr)

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(self.poll_sec + 5.0)
            self._poller = None
