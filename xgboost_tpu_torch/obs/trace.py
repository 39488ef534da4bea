"""Tracing spans and discrete events (port of ``xgboost_tpu/obs/trace.py``).

:func:`span` times a named unit of work and, when the event log is
configured (obs/events.py), appends one ``kind="span"`` record at exit
with ``trace`` / ``span`` / ``parent`` ids (a thread-local stack links
nested spans), ``dur_ms``, the boosting round in progress and the
caller's attributes; the :class:`SpanHandle` it yields takes more
attributes after the span opened (``sp.set("status", 200)``).
:func:`trace_context` sets the ambient trace id of a thread (the serving
front end seeds it from ``X-Request-Id``), which :func:`current_trace_id`
reads.  :func:`event` appends a discrete record.  With the log off a span
costs a list push and pop and nothing is formatted.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from xgboost_tpu_torch.obs import events

_tls = threading.local()
_round_lock = threading.Lock()
_current_round: Optional[int] = None


def new_id() -> str:
    """Random 64-bit hex id (span/trace ids)."""
    return os.urandom(8).hex()


def current_trace_id() -> Optional[str]:
    return getattr(_tls, "trace", None)


def current_span_id() -> Optional[str]:
    stack = getattr(_tls, "spans", None)
    return stack[-1] if stack else None


@contextmanager
def trace_context(trace_id: Optional[str] = None):
    """Set the ambient trace id for this thread (e.g. from an incoming
    ``X-Request-Id``); restores the previous one on exit.  ``None``
    generates a fresh id."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace_id or new_id()
    try:
        yield _tls.trace
    finally:
        _tls.trace = prev


def set_round(version: Optional[int]) -> None:
    """Record the boosting round in progress (profiler/mock seam), so
    discrete events correlate with the round that produced them."""
    global _current_round
    with _round_lock:
        _current_round = version


def current_round() -> Optional[int]:
    return _current_round


class SpanHandle:
    """Yielded by :func:`span`; ``set(k, v)`` adds attributes after the
    span opened (row counts, status codes, ...)."""

    __slots__ = ("name", "attrs", "trace", "span_id", "parent")

    def __init__(self, name, attrs, trace, span_id, parent):
        self.name = name
        self.attrs = attrs
        self.trace = trace
        self.span_id = span_id
        self.parent = parent

    def set(self, key: str, value) -> None:
        self.attrs[key] = value


@contextmanager
def span(name: str, **attrs):
    """Time one named unit of work; emit a span record at exit when the
    event log is configured.  Exceptions propagate (recorded as
    ``status="error"``).

    Truly cheap when logging is off: no ids are generated and nothing
    is timed or formatted — only a ``None`` sentinel keeps the
    thread-local nesting depth consistent (a log enabled mid-span emits
    from the NEXT span on; the in-flight one is dropped, which is the
    right trade for a hot serving path)."""
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    if events.get_log() is None:
        stack.append(None)
        try:
            yield SpanHandle(name, attrs, getattr(_tls, "trace", None),
                             None, None)
        finally:
            stack.pop()
        return
    parent = stack[-1] if stack else None
    trace = getattr(_tls, "trace", None)
    own_trace = trace is None
    if own_trace:
        trace = new_id()
        _tls.trace = trace
    sid = new_id()
    stack.append(sid)
    handle = SpanHandle(name, attrs, trace, sid, parent)
    t0 = time.perf_counter()
    ts = time.time()
    err: Optional[BaseException] = None
    try:
        yield handle
    except BaseException as e:
        err = e
        raise
    finally:
        stack.pop()
        if own_trace:
            _tls.trace = None
        if events.get_log() is not None:
            rec = {"ts": round(ts, 6), "kind": "span", "name": name,
                   "trace": trace, "span": sid,
                   "dur_ms": round((time.perf_counter() - t0) * 1e3, 3)}
            if parent is not None:
                rec["parent"] = parent
            rnd = current_round()
            if rnd is not None:
                rec["round"] = rnd
            if err is not None:
                rec["status"] = "error"
                rec["error"] = f"{type(err).__name__}: {err}"
            if handle.attrs:
                rec["attrs"] = handle.attrs
            events.emit(rec)


def event(name: str, **fields) -> None:
    """Append one discrete (non-timed) event record (no-op when the log
    is off)."""
    if events.get_log() is None:
        return
    rec = {"ts": round(time.time(), 6), "kind": "event", "name": name}
    trace = current_trace_id()
    if trace is not None:
        rec["trace"] = trace
    rnd = current_round()
    if rnd is not None:
        rec["round"] = rnd
    if fields:
        rec["attrs"] = fields
    events.emit(rec)
