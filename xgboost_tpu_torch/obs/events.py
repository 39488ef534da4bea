"""Crash-safe structured event log: append-only JSONL (port of
``xgboost_tpu/obs/events.py``).

Spans and discrete events (obs/trace.py) append one JSON object per
line: ``write()`` + ``flush()`` per line, ``fsync`` at most once per
``fsync_interval_s``, and a size-based rotation to ``<path>.1``.
Configured by :func:`configure_log` or the ``XGBTPU_OBS_LOG`` env var
(read at first use); unconfigured, every emit is a cheap no-op.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class EventLog:
    """One append-only JSONL sink with throttled fsync and rotation."""

    def __init__(self, path: str, rotate_bytes: int = 64 << 20,
                 fsync_interval_s: float = 1.0):
        self.path = os.fspath(path)
        self.rotate_bytes = int(rotate_bytes)
        self.fsync_interval_s = float(fsync_interval_s)
        self._lock = threading.Lock()
        self._last_fsync = 0.0
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._f = open(self.path, "ab")

    def emit(self, record: dict) -> None:
        """Append one record; never raises into the instrumented path (a
        full disk degrades observability, not training)."""
        try:
            line = json.dumps(record, separators=(",", ":"),
                              default=str).encode() + b"\n"
            with self._lock:
                self._f.write(line)
                self._f.flush()
                now = time.monotonic()
                if now - self._last_fsync >= self.fsync_interval_s:
                    os.fsync(self._f.fileno())
                    self._last_fsync = now
                if self._f.tell() >= self.rotate_bytes:
                    self._f.close()
                    os.replace(self.path, self.path + ".1")
                    self._f = open(self.path, "ab")
        except (OSError, ValueError, TypeError):
            pass  # the event is lost; training goes on

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
            except (OSError, ValueError):
                pass


_UNSET = object()
_log = _UNSET  # _UNSET -> consult the env once; None -> off
_log_lock = threading.Lock()


def configure_log(path: Optional[str]) -> Optional[EventLog]:
    """Install (or with ``path=None`` remove) the process-wide event
    log; returns it."""
    global _log
    with _log_lock:
        if _log not in (_UNSET, None):
            _log.close()
        _log = EventLog(path) if path else None
        return _log


def get_log() -> Optional[EventLog]:
    """The process-wide event log, or None when logging is off."""
    global _log
    if _log is _UNSET:
        with _log_lock:
            if _log is _UNSET:
                env = os.environ.get("XGBTPU_OBS_LOG")
                _log = EventLog(env) if env else None
    return _log


def emit(record: dict) -> None:
    log = get_log()
    if log is not None:
        log.emit(record)
