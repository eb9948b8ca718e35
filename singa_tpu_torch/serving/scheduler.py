"""Request queue, per-request futures, and admission bookkeeping.

Counterpart of ``singa_tpu/serving/scheduler.py``: a bounded FIFO of
:class:`Request` records and a :class:`ServeFuture` per request, fulfilled
exactly once. Rejection is synchronous and typed. Outcomes are counted in
``serve_requests_total{status}``; queue depth in ``serve_queue_depth``.

A :class:`Request` is either a generation request (``prompt`` and its
sampling settings, for the autoregressive ``ServingEngine``) or a
stateless one (``payload``, for the ``BatchServingEngine``). A sampled
request draws from its own ``numpy.random.RandomState(seed + id)``, as in
the JAX package, so a re-ordered schedule cannot change what one request
samples; ``id`` comes from a process-wide counter.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

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


class RequestShed(ServingError):
    """The fleet refused this request on purpose under sustained
    backpressure; ``retry_after`` is the hint in seconds."""

    def __init__(self, message, retry_after=1.0):
        super().__init__(message)
        self.retry_after = float(retry_after)


class PoolSaturated(RequestShed):
    """The disaggregated decode pool refused this request after its
    degradation ladder ran dry (a :class:`RequestShed`)."""


class HandoffRefused(ServingError):
    """A live-KV snapshot inject was refused (corrupt frame or a geometry
    that does not match the engine's programs)."""


class BlockPoolExhausted(ServingError):
    """Admission refused: the paged KV block pool cannot cover the
    request's ``prompt + max_new_tokens`` reservation without evicting a
    live sequence's blocks. Raised at ``submit`` for a request that could
    never fit the pool; one that only has to wait stays queued."""


def deadline_in(timeout, now=None):
    """Monotonic deadline for a timeout budget; ``None`` means none."""
    if timeout is None:
        return None
    return (now if now is not None else time.monotonic()) + float(timeout)


def budget_remaining(deadline, now=None):
    """Seconds left until ``deadline``, floored at 0.0 (``None``: no
    deadline, unlimited)."""
    if deadline is None:
        return None
    return max(0.0, deadline - (now if now is not None
                                else time.monotonic()))


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
    """One request: a generation request's prompt token ids and sampling
    settings, or a stateless request's input array (``payload``); its
    deadline and future. ``tokens`` and ``first_token_at`` belong to the
    engine."""

    _ids = itertools.count(1)

    def __init__(self, prompt=None, max_new_tokens=16, temperature=0.0,
                 top_k=None, eos_id=None, seed=0, timeout=None,
                 payload=None, trace_id=None):
        self.id = next(Request._ids)
        self.trace_id = str(trace_id) if trace_id else f"req-{self.id}"
        self.prompt = np.asarray(prompt, np.int32).reshape(-1) \
            if prompt is not None else None
        self.payload = payload
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.eos_id = eos_id
        self.rng = np.random.RandomState(int(seed) + self.id)
        self.submitted_at = time.monotonic()
        # timeout=0 is "already due" (a fail-fast probe), not no deadline
        self.deadline = (self.submitted_at + float(timeout)
                         if timeout is not None else None)
        self.first_token_at = None
        self.future = ServeFuture()
        self.tokens: list = []

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

    def pop_batch(self, n, now=None, admit=None):
        """Up to ``n`` non-expired requests, FIFO. Expired ones are failed
        with :class:`RequestTimeout` here and never take a row. ``admit``
        (a predicate) gates each pop: the first request it refuses stops
        the batch and stays at the head (the paged engine's block-pool
        backpressure; nothing behind it jumps it), and the deadline sweep
        still reaches every request queued behind it."""
        taken, expired = [], []
        with self._lock:
            while self._q and len(taken) < n:
                req = self._q[0]
                if req.expired(now):
                    expired.append(self._q.popleft())
                    continue
                if admit is not None and not admit(req):
                    keep = deque()
                    while self._q:
                        r = self._q.popleft()
                        (expired if r.expired(now) else keep).append(r)
                    self._q.extend(keep)
                    break
                taken.append(self._q.popleft())
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
           "ReplicaCrashed", "RequestShed", "PoolSaturated",
           "BlockPoolExhausted", "HandoffRefused", "ServeFuture", "Request",
           "RequestQueue", "deadline_in", "budget_remaining"]
