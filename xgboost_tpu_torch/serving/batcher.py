"""Queue-based micro-batcher: coalesce concurrent requests into one
device call, scatter results back to callers (port of
``xgboost_tpu/serving/batcher.py``; host logic, unchanged).

Concurrent ``submit`` calls within a window (first request arms a
``max_wait_ms`` deadline; ``max_batch_rows`` caps the coalesced size)
are stacked into ONE engine call — the serving analog of the training
side's "one launch per round" stance: device dispatch overhead is paid
per batch, not per request.

Backpressure is explicit: the queue is bounded in ROWS (the unit that
costs device time/memory), and a submit that would exceed it raises
:class:`QueueFull` immediately instead of growing memory without bound
— the HTTP front end maps that to 503.

Abandoned requests are SHED: when a caller's ``submit(timeout=...)``
wait expires, the request is marked abandoned and the worker skips it
at flush time — no device dispatch is paid for a result nobody reads
(counted on ``xgbtpu_reliability_shed_requests_total``).

Deadlines compose with shedding (reliability/deadline.py): a request
submitted with a :class:`~xgboost_tpu_torch.reliability.deadline.Deadline`
whose budget runs out while it waits in the queue is dropped at flush
time BEFORE dispatch — its caller gets
:class:`~xgboost_tpu_torch.reliability.deadline.DeadlineExceeded` (HTTP 504
at the front end) and the drop counts on
``xgbtpu_deadline_dropped_total``.  Shedding covers callers that gave
up; the deadline drop covers callers whose BUDGET gave up, which the
worker can see without waiting for anyone's timeout.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np


class QueueFull(RuntimeError):
    """The batch queue is at capacity; retry later (HTTP 503)."""


class _Request:
    __slots__ = ("X", "output_margin", "done", "result", "error", "t0",
                 "abandoned", "trace_id", "deadline", "tenant")

    def __init__(self, X: np.ndarray, output_margin: bool, deadline=None,
                 tenant: str = ""):
        self.X = X
        self.output_margin = output_margin
        # catalog tenant (model name) the request belongs to: the
        # accept queue dequeues across tenants by weighted round-robin
        self.tenant = tenant
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        # optional Deadline budget: the worker drops this request
        # pre-dispatch once it expires (the caller is answered with
        # DeadlineExceeded instead of a late result)
        self.deadline = deadline
        # set by submit() when its caller's wait timed out: the caller
        # is gone, so the worker sheds the request instead of paying
        # device dispatch for a result nobody will read
        self.abandoned = False
        # the submitter's ambient trace id (e.g. the HTTP X-Request-Id):
        # crosses the queue so the worker's batch span can name the
        # requests it coalesced (OBSERVABILITY.md)
        from xgboost_tpu_torch.obs import current_trace_id
        self.trace_id = current_trace_id()


class MicroBatcher:
    """Coalesces concurrent predict requests into single engine calls.

    Args:
      predict_fn: callable ``(X, output_margin=...) -> np.ndarray``.
        Resolved per BATCH, so a hot-reload between batches is picked up
        atomically (pass ``lambda X, **kw: registry.engine.predict(X,
        **kw)``); requests already inside a batch finish on the engine
        the batch started with.
      max_batch_rows: cap on rows coalesced into one device call.
      max_wait_ms: how long the first request of a batch waits for
        company before the batch launches anyway.
      max_queue_rows: bound on rows waiting in the queue (backpressure).
      metrics: optional :class:`xgboost_tpu_torch.obs.ServingMetrics`.
    """

    def __init__(self, predict_fn: Callable, max_batch_rows: int = 1024,
                 max_wait_ms: float = 2.0, max_queue_rows: int = 8192,
                 metrics=None):
        self.predict_fn = predict_fn
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue_rows = int(max_queue_rows)
        self.metrics = metrics
        # the Queue is now only a WAKE-TOKEN channel (one True per
        # accepted request, None = close sentinel); the requests
        # themselves wait in per-tenant deques so the worker dequeues
        # across tenants by smooth weighted round-robin — a heavy
        # tenant below its quota can no longer queue ahead of a light
        # one just by arriving first
        self._q: "queue.Queue[Optional[bool]]" = queue.Queue()
        self._tenant_q: Dict[str, Deque[_Request]] = {}
        self._tenant_weights: Dict[str, float] = {}
        self._wrr_current: Dict[str, float] = {}
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="xgbtpu-batcher")
        self._worker.start()

    # ------------------------------------------------------------- submit
    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Set a tenant's WRR share (default 1.0; a tenant with weight
        2 is dequeued twice as often as a weight-1 tenant while both
        have work queued).  ``weight <= 0`` resets to the default."""
        with self._lock:
            if weight <= 0:
                self._tenant_weights.pop(tenant, None)
            else:
                self._tenant_weights[tenant] = float(weight)

    def submit(self, X, output_margin: bool = False,
               timeout: Optional[float] = None,
               deadline=None, tenant: str = "") -> np.ndarray:
        """Enqueue one request and block until its predictions arrive.

        Raises :class:`QueueFull` when accepting the rows would exceed
        ``max_queue_rows`` (reject-don't-buffer backpressure).  With a
        ``deadline`` (:class:`~xgboost_tpu_torch.reliability.deadline.
        Deadline`), the wait is bounded by the remaining budget and the
        worker drops the entry pre-dispatch once it expires (the caller
        sees :class:`~xgboost_tpu_torch.reliability.deadline.
        DeadlineExceeded`)."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"expected 2-D rows, got shape {X.shape}")
        n = X.shape[0]
        if self.metrics is not None:
            # counted BEFORE admission: "requests received" includes the
            # ones backpressure rejects (reject ratio must be computable
            # as rejected_total / requests_total)
            self.metrics.requests.inc()
        if deadline is not None:
            # the caller has no reason to outwait its own budget (plus
            # a small grace so a pre-dispatch drop resolves the wait
            # with the typed error, not a bare TimeoutError race)
            budget = deadline.remaining() + 0.05
            timeout = budget if timeout is None else min(timeout, budget)
        req = _Request(X, output_margin, deadline=deadline, tenant=tenant)
        with self._lock:
            # closed-check AND enqueue under the same lock as close()'s
            # closed-set: a request can never land BEHIND the close
            # sentinel (which would leave its caller blocked forever)
            if self._closed:
                raise RuntimeError("batcher is closed")
            # backpressure bounds rows WAITING behind other requests.  A
            # single oversized request is admitted when the queue is
            # empty (the engine chunks it through the top bucket; its
            # memory is already materialized by the caller) — otherwise
            # a request larger than max_queue_rows would 503 forever,
            # even on an idle server
            if (self._queued_rows + n > self.max_queue_rows
                    and self._queued_rows > 0):
                if self.metrics is not None:
                    self.metrics.rejected.inc()
                raise QueueFull(
                    f"queue holds {self._queued_rows} rows; adding {n} "
                    f"exceeds max_queue_rows={self.max_queue_rows}")
            self._queued_rows += n
            if self.metrics is not None:
                self.metrics.queue_rows.set(self._queued_rows)
            self._tenant_q.setdefault(tenant, deque()).append(req)
            self._q.put(True)  # one wake token per accepted request
        if not req.done.wait(timeout):
            # mark-then-raise: the request still sits in the queue, but
            # the worker will skip it at flush time (counted in
            # reliability metrics as a shed request).  Benign race: if
            # the flush already started, the result is computed and
            # simply dropped — never a wrong answer to a later caller.
            req.abandoned = True
            if deadline is not None and deadline.expired():
                from xgboost_tpu_torch.reliability.deadline import \
                    DeadlineExceeded
                raise DeadlineExceeded(
                    "deadline budget spent waiting for dispatch")
            raise TimeoutError("prediction timed out")
        if self.metrics is not None:
            self.metrics.latency.observe(time.perf_counter() - req.t0)
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------- worker
    def _dequeue_rows(self, n: int) -> None:
        with self._lock:
            self._queued_rows -= n
            if self.metrics is not None:
                self.metrics.queue_rows.set(self._queued_rows)

    def _next_request(self) -> _Request:
        """Pop the next request by smooth weighted round-robin across
        the tenants with queued work.  Called once per consumed wake
        token, so a non-empty deque is guaranteed."""
        with self._lock:
            total = sum(self._weight(t) for t in self._tenant_q)
            best = None
            for t in self._tenant_q:
                c = self._wrr_current.get(t, 0.0) + self._weight(t)
                self._wrr_current[t] = c
                if best is None or c > self._wrr_current[best]:
                    best = t
            self._wrr_current[best] -= total
            dq = self._tenant_q[best]
            req = dq.popleft()
            if not dq:
                # drained tenants leave the rotation (and drop their
                # WRR credit — an idle tenant must not bank priority)
                del self._tenant_q[best]
                self._wrr_current.pop(best, None)
        from xgboost_tpu_torch.obs.metrics import tenant_dequeues
        tenant_dequeues().inc(best if best else "default")
        return req

    def _weight(self, tenant: str) -> float:
        return self._tenant_weights.get(tenant, 1.0)

    def _run(self) -> None:
        carry: Optional[_Request] = None
        while True:
            if carry is not None:
                req, carry = carry, None
            else:
                if self._q.get() is None:  # close sentinel
                    return
                req = self._next_request()
            batch: List[_Request] = [req]
            rows = req.X.shape[0]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            while rows < self.max_batch_rows:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    tok = self._q.get(timeout=wait)
                except queue.Empty:
                    break
                if tok is None:
                    self._q.put(None)  # re-arm the sentinel for after flush
                    break
                nxt = self._next_request()
                if (nxt.X.shape[1] != req.X.shape[1]
                        or nxt.output_margin != req.output_margin
                        or rows + nxt.X.shape[0] > self.max_batch_rows):
                    # incompatible or overflowing: flush what we have,
                    # lead the next batch with this request
                    carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.X.shape[0]
            self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        self._dequeue_rows(sum(r.X.shape[0] for r in batch))
        # drop entries whose DEADLINE expired in the queue: unlike an
        # abandoned request (caller gone, nothing to tell it), the
        # caller here may still be waiting — answer it with the typed
        # 504-mapping error instead of paying device dispatch for a
        # result that arrives past its budget
        expired = [r for r in batch if not r.abandoned
                   and r.deadline is not None and r.deadline.expired()]
        if expired:
            from xgboost_tpu_torch.profiling import reliability_metrics
            from xgboost_tpu_torch.reliability.deadline import DeadlineExceeded
            reliability_metrics().deadline_dropped.inc(len(expired))
            for r in expired:
                r.error = DeadlineExceeded(
                    "deadline expired before dispatch")
                r.abandoned = True
                r.done.set()
        # shed requests whose caller already timed out: their rows would
        # cost device dispatch (and inflate the batch's bucket) for a
        # result nobody is waiting on
        live = [r for r in batch if not r.abandoned]
        if len(live) < len(batch):
            from xgboost_tpu_torch.profiling import reliability_metrics
            reliability_metrics().shed_requests.inc(
                len(batch) - len(live) - len(expired))
            for r in batch:
                if r.abandoned and r.error is None:
                    r.done.set()
            if not live:
                return
        rows = sum(r.X.shape[0] for r in live)
        if self.metrics is not None:
            self.metrics.batches.inc()
            self.metrics.batch_rows.observe(rows)
        from xgboost_tpu_torch.obs import span
        try:
            # one span per coalesced device batch, naming the traces it
            # carries — the link between a request's serve.request span
            # and the batch that actually ran it
            with span("serve.batch", rows=rows, requests=len(live),
                      request_ids=[r.trace_id for r in live
                                   if r.trace_id is not None][:32]):
                X = (live[0].X if len(live) == 1
                     else np.concatenate([r.X for r in live], axis=0))
                out = self.predict_fn(X,
                                      output_margin=live[0].output_margin)
            off = 0
            for r in live:
                n = r.X.shape[0]
                r.result = out[off:off + n]
                off += n
        except BaseException as e:  # propagate to every caller in the batch
            if self.metrics is not None:
                self.metrics.errors.inc(len(live))
            for r in live:
                r.error = e
        finally:
            for r in live:
                r.done.set()

    # -------------------------------------------------------------- close
    @property
    def queued_rows(self) -> int:
        return self._queued_rows

    def close(self, timeout: float = 5.0) -> None:
        """Drain the queue and stop the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # ordered after every accepted request
        self._worker.join(timeout)
