"""ModelCatalog: N named models per replica under one device budget
(port of ``xgboost_tpu/catalog/catalog.py``; ``parse_manifest`` is also
the grammar of ``task=lanes``' tenant manifest).

Each entry is an independent :class:`~xgboost_tpu_torch.serving.registry.
ModelRegistry` — its own captured bucket graphs, its own hot-reload
poll on its own published path, its own micro-batcher and optional
feature store — so per-model behavior (bitwise parity, no
steady-state capture, instant rollback) is exactly the single-model
serving stack's.  What the catalog adds is the SHARED part:

- **one device-memory budget** (``serve_catalog_mb``) across all
  resident engines.  Admitting a model past the budget LRU-evicts the
  coldest resident entries' engines (registry poller stopped, batcher
  closed, references dropped); a later request re-admits on demand
  (rebuild + warm off the serving path, like any reload).  Eviction
  respects a **hysteresis** window: an entry used within the last
  ``hysteresis_sec`` is never evicted, so hot models keep their
  captured graphs — the capture-free steady state survives a churning
  cold tail;
- **one resolve surface** (``/predict?model=``): requests name a model,
  the bare path resolves to the configured default — the catalog-of-one
  path IS the old single-model path.

Admission builds happen OUTSIDE the catalog lock (an engine warmup is
seconds of capture; requests for other models must not queue behind
it) under a per-entry admit lock — the same staged-commit discipline
as the feature store's ``put``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from xgboost_tpu_torch.obs import event, span


class UnknownModel(KeyError):
    """The request named a model the catalog does not hold (HTTP 404)."""

    def __init__(self, name: str, known):
        super().__init__(name)
        self.model = name
        self.known = sorted(known)

    def __str__(self):
        return (f"unknown model {self.model!r} (catalog holds: "
                f"{', '.join(self.known) or '<empty>'})")


def parse_manifest(spec: str) -> Dict[str, str]:
    """Parse the ``catalog=`` knob: ``name=path`` entries, either
    inline comma-separated (``a=./a.model,b=./b.model``) or one per
    line in a manifest file (``#`` comments allowed — the same grammar
    as ``parse_config_file``).  Entry order is preserved; the first
    entry is the default model unless ``catalog_default`` overrides."""
    out: Dict[str, str] = {}
    if "=" in spec:
        pairs = [p for p in spec.split(",") if p.strip()]
    else:
        from xgboost_tpu_torch.config import parse_config_file
        return dict(parse_config_file(spec))
    for p in pairs:
        name, path = p.split("=", 1)
        name, path = name.strip(), path.strip()
        if not name or not path:
            raise ValueError(f"bad catalog manifest entry {p!r} "
                             "(want name=path)")
        out[name] = path
    if not out:
        raise ValueError(f"empty catalog manifest {spec!r}")
    return out


class CatalogEntry:
    """One named model's slot: path + (when resident) its registry,
    batcher and feature store.  ``last_hash`` outlives eviction so
    /healthz keeps naming the content this entry would serve."""

    def __init__(self, name: str, path: str, featurestore_mb: float = 0.0):
        self.name = name
        self.path = os.fspath(path)
        self.featurestore_mb = float(featurestore_mb)
        self.registry = None            # ModelRegistry when resident
        self.batcher = None             # MicroBatcher when resident
        self._featurestore = None
        self._fs_lock = threading.Lock()
        self._admit_lock = threading.Lock()
        self.last_used = 0.0            # monotonic; 0 = never touched
        self.last_hash: Optional[str] = None
        self.admissions = 0
        self.evictions = 0
        self._file_hash_cache = None    # ((mtime_ns, size), sha256)

    @property
    def resident(self) -> bool:
        return self.registry is not None

    def device_bytes(self) -> int:
        reg = self.registry
        return reg.device_bytes() if reg is not None else 0

    def content_hash(self) -> Optional[str]:
        """The hash of what this entry serves (resident) or WOULD serve
        on admission: its last served content, else the manifest file's
        bytes (cached by mtime+size — every /healthz reads this, and a
        cold model's file rarely changes)."""
        reg = self.registry
        if reg is not None:
            return reg.content_hash
        if self.last_hash is not None:
            return self.last_hash
        import hashlib
        try:
            st = os.stat(self.path)
            key = (st.st_mtime_ns, st.st_size)
            cached = self._file_hash_cache
            if cached is not None and cached[0] == key:
                return cached[1]
            with open(self.path, "rb") as f:
                h = hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return None
        self._file_hash_cache = (key, h)
        return h

    def featurestore_for(self):
        """The entry's feature store, swapped when the model's feature
        width changes across a reload (same width-swap discipline as
        the single-model server's ``featurestore_for``)."""
        if self.featurestore_mb <= 0 or self.registry is None:
            return None
        engine = self.registry.engine
        with self._fs_lock:
            fs = self._featurestore
            if fs is None or fs.num_feature != engine.num_feature:
                from xgboost_tpu_torch.serving.featurestore import FeatureStore
                fs = FeatureStore(engine.num_feature,
                                  budget_mb=self.featurestore_mb,
                                  device=engine.device)
                self._featurestore = fs
            return fs

    def describe(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        d = {"path": self.path, "resident": self.resident,
             "model_hash": self.content_hash(),
             "evictions": self.evictions,
             "last_used_sec": (round(now - self.last_used, 3)
                               if self.last_used else None)}
        reg = self.registry
        if reg is not None:
            d["model_version"] = reg.version
            d["model_hash"] = reg.content_hash
            d["buckets_compiled"] = reg.engine.num_compiled
            d["device_bytes"] = reg.device_bytes()
            d["poisoned"] = reg.poisoned
        fs = self._featurestore
        if fs is not None:
            d["featurestore_rows"] = len(fs)
        return d


class ModelCatalog:
    """Named models -> independent serving stacks, one shared budget.

    Args:
      budget_mb: shared device byte budget across all resident engines
        (0 = unlimited; the catalog-of-one default).
      hysteresis_sec: entries used within this window are never
        evicted (anti-thrash; keeps hot models' executables pinned).
      default: model name bare requests resolve to (default: the first
        added entry).
      registry_factory: ``path -> ModelRegistry`` — how an admitted
        entry builds (run_server closes this over its engine kwargs).
      batcher_factory: optional ``registry -> MicroBatcher`` for the
        HTTP tier; direct API users skip it and predict on
        ``entry.registry`` themselves.
    """

    def __init__(self, budget_mb: float = 0.0, hysteresis_sec: float = 3.0,
                 default: str = "",
                 registry_factory: Optional[Callable] = None,
                 batcher_factory: Optional[Callable] = None):
        self.budget_bytes = int(budget_mb * 1e6) if budget_mb > 0 else 0
        self.hysteresis_sec = float(hysteresis_sec)
        self.default = default
        self._registry_factory = registry_factory
        self._batcher_factory = batcher_factory
        self._entries: Dict[str, CatalogEntry] = {}  # insertion-ordered
        self._lock = threading.Lock()
        from xgboost_tpu_torch.obs.metrics import catalog_metrics
        self.metrics = catalog_metrics()

    # ------------------------------------------------------------- build
    def add_model(self, name: str, path: str, registry=None, batcher=None,
                  featurestore=None,
                  featurestore_mb: float = 0.0) -> CatalogEntry:
        """Register a named model.  With ``registry`` the entry starts
        resident (run_server's eagerly-built default model); without,
        it is admitted lazily on first resolve."""
        entry = CatalogEntry(name, path, featurestore_mb=featurestore_mb)
        if registry is not None:
            entry.registry = registry
            entry.batcher = batcher
            entry._featurestore = featurestore
            entry.last_hash = registry.content_hash
            entry.last_used = time.monotonic()
            entry.admissions += 1
        with self._lock:
            if name in self._entries:
                raise ValueError(f"catalog already holds model {name!r}")
            self._entries[name] = entry
            if not self.default:
                self.default = name
            self.metrics.models_configured.set(len(self._entries))
            self._note_gauges_locked()
        return entry

    def remove_model(self, name: str) -> bool:
        """Detach a named model (the manifest-delta remove path): evict
        its engine if resident and drop the entry.  The default model is
        pinned (the HTTP tier's single-model attributes alias it) —
        removing it raises.  Returns False for a name the catalog does
        not hold (detach is idempotent)."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                return False
            if name == self.default:
                raise ValueError(
                    f"model {name!r} is the catalog default and cannot "
                    "be detached")
            if entry.resident:
                self._evict_locked(entry)
            del self._entries[name]
            self.metrics.models_configured.set(len(self._entries))
            self._note_gauges_locked()
        event("catalog.remove", model=name)
        return True

    @classmethod
    def from_manifest(cls, manifest: Dict[str, str], **kwargs
                      ) -> "ModelCatalog":
        cat = cls(**kwargs)
        for name, path in manifest.items():
            cat.add_model(name, path)
        return cat

    # ----------------------------------------------------------- resolve
    def resolve(self, name: str = "") -> CatalogEntry:
        """The serving entry for ``name`` (default model when empty),
        admitted on demand.  Touches the LRU clock."""
        name = name or self.default
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise UnknownModel(name, self._entries)
            entry.last_used = time.monotonic()
            if entry.resident:
                if (self.budget_bytes
                        and self._bytes_used_locked() > self.budget_bytes):
                    # an eagerly-warmed catalog can START over budget
                    # with every entry inside the hysteresis window;
                    # the cold tail sheds here once it ages out
                    self._enforce_budget_locked(keep=name)
                    self._note_gauges_locked()
                self.metrics.requests.inc(name)
                return entry
        self._admit(entry)
        self.metrics.requests.inc(name)
        return entry

    def get(self, name: str = "") -> CatalogEntry:
        """Peek without admitting or touching the LRU clock."""
        name = name or self.default
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise UnknownModel(name, self.names())
        return entry

    def _admit(self, entry: CatalogEntry) -> None:
        """Build + warm an evicted entry OFF the catalog lock (per-entry
        admit lock serializes concurrent resolves of the same model),
        then install and enforce the budget."""
        if self._registry_factory is None:
            raise RuntimeError(
                f"model {entry.name!r} is not resident and the catalog "
                "has no registry_factory to admit it")
        with entry._admit_lock:
            if entry.resident:
                return
            with span("catalog.admit", model=entry.name, path=entry.path):
                registry = self._registry_factory(entry.path)
                batcher = (self._batcher_factory(registry)
                           if self._batcher_factory is not None else None)
            with self._lock:
                entry.registry = registry
                entry.batcher = batcher
                entry.last_hash = registry.content_hash
                entry.last_used = time.monotonic()
                entry.admissions += 1
                self.metrics.admissions.inc()
                self._enforce_budget_locked(keep=entry.name)
                self._note_gauges_locked()
            registry.start()
            event("catalog.admit", model=entry.name,
                  model_hash=registry.content_hash)

    # ------------------------------------------------------------ budget
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes_used_locked()

    def _bytes_used_locked(self) -> int:
        return sum(e.device_bytes() for e in self._entries.values())

    def _enforce_budget_locked(self, keep: str = "") -> None:
        """LRU-evict cold residents until the budget holds.  Entries
        inside the hysteresis window (and ``keep``, the entry being
        admitted) are exempt — a fully-hot catalog is allowed to sit
        over budget rather than thrash its own working set."""
        if not self.budget_bytes:
            return
        now = time.monotonic()
        while self._bytes_used_locked() > self.budget_bytes:
            # the default entry is pinned: the HTTP tier's registry/
            # batcher attributes alias it (single-model back-compat), so
            # evicting it would leave the server pointing at a stopped
            # registry while resolve() rebuilds a fresh one
            victims = [e for e in self._entries.values()
                       if e.resident and e.name != keep
                       and e.name != self.default
                       and now - e.last_used >= self.hysteresis_sec]
            if not victims:
                break
            self._evict_locked(min(victims, key=lambda e: e.last_used))

    def _evict_locked(self, entry: CatalogEntry) -> None:
        registry, batcher = entry.registry, entry.batcher
        entry.last_hash = registry.content_hash
        entry.registry = None
        entry.batcher = None
        entry._featurestore = None
        entry.evictions += 1
        self.metrics.evictions.inc()
        registry.stop()
        if batcher is not None:
            batcher.close()
        registry.release()
        event("catalog.evict", model=entry.name,
              model_hash=entry.last_hash)

    def _note_gauges_locked(self) -> None:
        self.metrics.models_resident.set(
            sum(1 for e in self._entries.values() if e.resident))
        self.metrics.bytes_used.set(self._bytes_used_locked())
        self.metrics.bytes_budget.set(self.budget_bytes)

    # ------------------------------------------------------------- state
    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def entries(self) -> List[CatalogEntry]:
        with self._lock:
            return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def models(self) -> Dict[str, Dict[str, Optional[str]]]:
        """The advertisement a fleet replica's heartbeat carries
        (``catalog/catalog.py:374``): every configured model, resident
        or not, with the content hash it would serve and its device
        bytes (CUDA-graph pools included; 0 while evicted, when the
        placer costs it by its file size)."""
        with self._lock:
            return {e.name: {"path": e.path, "hash": e.content_hash(),
                             "bytes": e.device_bytes()}
                    for e in self._entries.values()}

    def describe(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "default": self.default,
                "configured": len(self._entries),
                "resident": sum(1 for e in self._entries.values()
                                if e.resident),
                "bytes_used": self._bytes_used_locked(),
                "bytes_budget": self.budget_bytes,
                "models": {e.name: e.describe(now)
                           for e in self._entries.values()},
            }

    # --------------------------------------------------------- lifecycle
    def start(self) -> None:
        for e in self.entries():
            if e.registry is not None:
                e.registry.start()

    def stop(self) -> None:
        for e in self.entries():
            reg, batcher = e.registry, e.batcher
            if reg is not None:
                reg.stop()
            if batcher is not None:
                batcher.close()
