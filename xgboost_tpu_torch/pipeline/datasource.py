"""Fresh-data seam of the continuous-training pipeline (port of
``xgboost_tpu/pipeline/datasource.py``).

A :class:`DataSource` answers, per cycle, what the trainer appends trees
on and what the gate judges on: ``next_cycle(cycle) -> (dtrain,
dholdout) | None``.  For a given cycle it must hand back the same data
on every call: a cycle killed mid-train resumes from the checkpoint
ring and re-reads its data, and the resumed run must be bit-identical
to an uninterrupted one.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from xgboost_tpu_torch.data import DMatrix


class DataSource:
    """Pluggable fresh-data feed.  ``next_cycle`` returns the cycle's
    ``(train DMatrix, holdout DMatrix)`` pair, or ``None`` when no fresh
    data is available yet (the trainer idles and retries)."""

    def next_cycle(self, cycle: int):
        raise NotImplementedError

    def holdout_for(self, cycle: int):
        """The holdout alone, or None: a crash-recovery re-gate needs no
        train data (the producer may have rotated it away)."""
        data = self.next_cycle(cycle)
        return None if data is None else data[1]


class FileDataSource(DataSource):
    """Per-cycle libsvm files: ``train_path`` may carry a ``{cycle}``
    placeholder; ``holdout_path`` is the fixed held-out window, re-parsed
    only when its (mtime, size) changes."""

    def __init__(self, train_path: str, holdout_path: str):
        self.train_path = train_path
        self.holdout_path = holdout_path
        self._holdout = None
        self._holdout_stat = None

    def _load_holdout(self):
        st = os.stat(self.holdout_path)
        stat = (st.st_mtime_ns, st.st_size)
        if self._holdout is None or stat != self._holdout_stat:
            self._holdout = DMatrix(self.holdout_path)
            self._holdout_stat = stat
        return self._holdout

    def next_cycle(self, cycle: int):
        path = self.train_path.replace("{cycle}", str(cycle))
        if not os.path.exists(path) or not os.path.exists(
                self.holdout_path):
            return None
        return DMatrix(path), self._load_holdout()

    def holdout_for(self, cycle: int):
        if not os.path.exists(self.holdout_path):
            return None
        return self._load_holdout()


class SyntheticDataSource(DataSource):
    """Deterministic synthetic stream: cycle ``k`` draws ``n_rows`` rows
    from ``RandomState(seed + k + 1)`` against a fixed target, the
    holdout is one draw at ``seed`` -- the same numpy arrays as the JAX
    package's source."""

    def __init__(self, n_rows: int = 512, n_features: int = 8,
                 seed: int = 0):
        self.n_rows = int(n_rows)
        self.n_features = int(n_features)
        self.seed = int(seed)
        self._holdout = None

    def _draw(self, seed: int, n: int):
        rng = np.random.RandomState(seed)
        X = rng.rand(n, self.n_features).astype(np.float32)
        y = ((X[:, 0] + 0.25 * X[:, 1]) > 0.6).astype(np.float32)
        return DMatrix(X, label=y)

    def next_cycle(self, cycle: int):
        if self._holdout is None:
            self._holdout = self._draw(self.seed, max(self.n_rows, 256))
        return (self._draw(self.seed + cycle + 1, self.n_rows),
                self._holdout)


class CallableDataSource(DataSource):
    """Wrap a plain ``cycle -> (dtrain, dholdout) | None`` function."""

    def __init__(self, fn: Callable[[int], Optional[Tuple]]):
        self.fn = fn

    def next_cycle(self, cycle: int):
        return self.fn(cycle)
