"""Request queue, per-request futures, and admission bookkeeping.

Counterpart of ``singa_tpu/serving/scheduler.py`` (the part the stateless
engine uses): a bounded FIFO of :class:`Request` records and a
:class:`ServeFuture` per request, fulfilled exactly once. Rejection is
synchronous and typed. Outcomes are counted in
``serve_requests_total{status}``; queue depth in ``serve_queue_depth``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from ..observability import metrics as _metrics


class ServingError(RuntimeError):
    """Base class for serve-path failures."""


class QueueFull(ServingError):
    """Admission refused: the bounded request queue is at capacity."""


class EngineDraining(ServingError):
    """Admission refused: the engine is draining or stopped."""


class RequestTimeout(ServingError):
    """The request's deadline passed before a response completed."""


class ReplicaCrashed(ServingError):
    """The engine that held this request died; the request may be
    re-dispatched elsewhere."""


class ServeFuture:
    """One request's response slot: fulfilled exactly once.
    ``deliveries`` counts fulfilment attempts; a second one raises."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error = None
        self.deliveries = 0

    def _fulfill(self, result=None, error=None):
        with self._lock:
            self.deliveries += 1
            if self._event.is_set():
                raise RuntimeError(
                    "double delivery: this request already has a "
                    "response (exactly-once violation)")
            self._result = result
            self._error = error
            self._event.set()

    def set_result(self, result):
        self._fulfill(result=result)

    def set_error(self, error):
        self._fulfill(error=error)

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise RequestTimeout(
                f"no response within {timeout}s (request still in flight)")
        if self._error is not None:
            raise self._error
        return self._result


class Request:
    """One stateless request: its input array (``payload``), deadline and
    future."""

    _ids = itertools.count(1)

    def __init__(self, payload, timeout=None, trace_id=None):
        self.id = next(Request._ids)
        self.trace_id = str(trace_id) if trace_id else f"req-{self.id}"
        self.payload = payload
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + float(timeout)
                         if timeout is not None else None)
        self.first_token_at = None
        self.future = ServeFuture()

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline


class RequestQueue:
    """Bounded FIFO admission queue with deadline sweeping."""

    def __init__(self, capacity=64, registry=None):
        self.capacity = int(capacity)
        self._q = deque()
        self._lock = threading.Lock()
        reg = registry if registry is not None \
            else _metrics.default_registry()
        self._depth = reg.gauge("serve_queue_depth",
                                "requests admitted but not yet served")
        self._outcomes = reg.counter("serve_requests_total",
                                     "terminal request outcomes",
                                     labels=("status",))

    def finish(self, status):
        """Record a request's terminal outcome."""
        self._outcomes.inc(status=status)

    def put(self, req):
        """Admit or raise :class:`QueueFull` (counted as rejected)."""
        with self._lock:
            full = len(self._q) >= self.capacity
            if not full:
                self._q.append(req)
            depth = len(self._q)
        self._depth.set(depth)
        if full:
            self.finish("rejected")
            raise QueueFull(f"request queue at capacity ({self.capacity})")

    def pop_batch(self, n, now=None):
        """Up to ``n`` non-expired requests, FIFO. Expired ones are
        failed with :class:`RequestTimeout` here and never take a row."""
        taken, expired = [], []
        with self._lock:
            while self._q and len(taken) < n:
                req = self._q.popleft()
                (expired if req.expired(now) else taken).append(req)
            depth = len(self._q)
        self._depth.set(depth)
        for req in expired:
            req.future.set_error(RequestTimeout(
                "deadline passed while queued"))
            self.finish("timed_out")
        return taken

    def drain_pending(self, error):
        """Fail every queued request with ``error``."""
        with self._lock:
            pending = list(self._q)
            self._q.clear()
        self._depth.set(0)
        for req in pending:
            if not req.future.done():
                req.future.set_error(error)
                self.finish("failed")
        return len(pending)

    def __len__(self):
        with self._lock:
            return len(self._q)


__all__ = ["ServingError", "QueueFull", "EngineDraining", "RequestTimeout",
           "ReplicaCrashed", "ServeFuture", "Request", "RequestQueue"]
