"""Tracing spans and discrete events (port of ``xgboost_tpu/obs/trace.py``).

:func:`span` times a named unit of work and, when the event log is
configured (obs/events.py), appends one ``kind="span"`` record at exit
with ``trace`` / ``span`` / ``parent`` ids (a thread-local stack links
nested spans), ``dur_ms`` and the caller's attributes.  :func:`event`
appends a discrete record.  With the log off both cost a dictionary
look-up and nothing is formatted.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

from xgboost_tpu_torch.obs import events

_tls = threading.local()


def new_id() -> str:
    """Random 64-bit hex id (span and trace ids)."""
    return os.urandom(8).hex()


@contextmanager
def span(name: str, **attrs):
    """Time one named unit of work; emit a span record at exit when the
    event log is configured.  Exceptions propagate, recorded as
    ``status="error"``."""
    if events.get_log() is None:
        yield attrs
        return
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    parent = stack[-1] if stack else None
    trace = getattr(_tls, "trace", None)
    own_trace = trace is None
    if own_trace:
        trace = _tls.trace = new_id()
    sid = new_id()
    stack.append(sid)
    t0, ts = time.perf_counter(), time.time()
    err = None
    try:
        yield attrs
    except BaseException as e:
        err = e
        raise
    finally:
        stack.pop()
        if own_trace:
            _tls.trace = None
        rec = {"ts": round(ts, 6), "kind": "span", "name": name,
               "trace": trace, "span": sid,
               "dur_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        if parent is not None:
            rec["parent"] = parent
        if err is not None:
            rec["status"] = "error"
            rec["error"] = f"{type(err).__name__}: {err}"
        if attrs:
            rec["attrs"] = attrs
        events.emit(rec)


def event(name: str, **fields) -> None:
    """Append one discrete event record (no-op when the log is off)."""
    if events.get_log() is None:
        return
    rec = {"ts": round(time.time(), 6), "kind": "event", "name": name}
    trace = getattr(_tls, "trace", None)
    if trace is not None:
        rec["trace"] = trace
    if fields:
        rec["attrs"] = fields
    events.emit(rec)
