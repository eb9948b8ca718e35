"""Stateless batch serving engine.

Counterpart of ``singa_tpu/serving/engine.py``: the shared control plane
(:class:`_EngineBase` -- admission, background loop, synchronous
stepping, stop, crash handling, TTFT and per-tick latency) and
:class:`BatchServingEngine` (``engine.py:2094-2269``), which serves
classifier models. Each tick gathers up to ``batch`` queued requests, pads
them to the fixed width, runs ONE forward of the model under
``torch.inference_mode()`` and the precision policy, and delivers each
request its row. Where the JAX package jits the forward
(``engine.py:2163``), the port replays it from a CUDA graph
(``graph.StepGraph``); the BN+ReLU tails go through kernel K2 when
``ops.fused_epilogue`` is enabled.

Not ported in this slice (ROADMAP): the autoregressive
:class:`ServingEngine` (``build_engine`` raises for a model with a
``decode_adapter``), fault injection, AOT export, HBM sampling, profiled
ticks, quantized policies and sharded serving.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..autograd_base import CTX
from ..graph import StepGraph, resources
from ..observability import metrics as _metrics
from .scheduler import (EngineDraining, ReplicaCrashed, Request,
                        RequestQueue, ServingError)


class _EngineBase:
    """Shared control plane: queue, loop thread, stop, SLO metrics."""

    def __init__(self, *, queue_capacity=64, registry=None):
        self._reg = registry if registry is not None \
            else _metrics.default_registry()
        self.queue = RequestQueue(queue_capacity, registry=self._reg)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread = None
        self._running = False
        self._stopped = False
        self._crashed = None
        self._tick_count = 0
        self._ttft = self._reg.histogram(
            "serve_ttft_seconds",
            "request submit to first result (queue wait included)")
        self._tick_lat = self._reg.histogram(
            "serve_token_seconds",
            "latency of one serving tick (host batch in to host result "
            "out)")

    def _admit(self, req):
        if self._crashed is not None:
            self.queue.finish("rejected")
            raise ReplicaCrashed(f"engine crashed ({self._crashed}); not "
                                 "accepting requests")
        if self._stopped:
            self.queue.finish("rejected")
            raise EngineDraining(
                "engine is stopped; not accepting new requests")
        self.queue.put(req)
        self._wake.set()
        return req.future

    def start(self):
        """Run the serve loop on a daemon thread. Idempotent."""
        with self._lock:
            if self._thread is not None:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serve-loop")
            self._thread.start()
        return self

    def _busy(self):
        raise NotImplementedError

    def _tick(self):
        raise NotImplementedError

    def _fail_batch(self, batch, exc):
        """Fail requests popped from the queue whose tick died (exactly
        once)."""
        err = ReplicaCrashed(f"serve tick failed: {exc}")
        err.__cause__ = exc
        for req in batch:
            if not req.future.done():
                req.future.set_error(err)
                self.queue.finish("failed")

    def _loop(self):
        while self._running:
            if not self._busy():
                self._wake.wait(0.02)
                self._wake.clear()
                continue
            try:
                self._tick()
                self._tick_count += 1
            except Exception as e:          # noqa: BLE001 — crash path
                self._crash(e)
                return

    def _crash(self, exc):
        """Serve-loop death: fail every pending future exactly once."""
        self._crashed = exc
        self._running = False
        self._stopped = True
        err = ReplicaCrashed(f"serve loop crashed: {exc}")
        err.__cause__ = exc
        self.queue.drain_pending(err)

    def step(self):
        """Run ONE tick inline (only without the background thread).
        Returns True when there was work."""
        if self._thread is not None:
            raise RuntimeError("step() is for synchronous use; the "
                               "background loop is running")
        if not self._busy():
            return False
        self._tick()
        self._tick_count += 1
        return True

    def run_until_idle(self, max_ticks=10_000):
        """Tick synchronously until no work remains; returns the tick
        count."""
        ticks = 0
        while self._busy():
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"engine did not go idle within "
                                   f"{max_ticks} ticks")
        return ticks

    @property
    def ticks(self):
        return self._tick_count

    def ttft_stats(self):
        """Caller-felt TTFT quantiles ``{"count", "p50_s", "p99_s"}``."""
        s = self._ttft.summary()
        return {"count": s["count"], "p50_s": s["p50"], "p99_s": s["p99"]}

    def tick_stats(self):
        """Per-tick latency quantiles ``{"count", "p50_s", "p99_s"}``."""
        s = self._tick_lat.summary()
        return {"count": s["count"], "p50_s": s["p50"], "p99_s": s["p99"]}

    def stop(self):
        """Hard stop: end the loop and fail what is still queued."""
        self._stopped = True
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._crashed is None:
            return self.queue.drain_pending(EngineDraining("engine stopped"))
        return 0


class BatchServingEngine(_EngineBase):
    """Stateless serving: one fixed-width forward per tick over a padded
    batch of queued requests.

    With ``use_graph`` (the default) the forward is a
    :class:`~..graph.StepGraph`: the construction runs the materialising
    forward and captures the next one, and each tick copies the pinned
    host batch into the static device input, replays and copies the
    outputs to the host (on the CPU: the same books, the forward run
    where the card replays). The graph reads the BN folds that K2's
    peephole caches (``ops/fused_epilogue.py``), so a model state that
    is replaced or written (``load_states``, a training step) makes the
    next tick forward eagerly and the one after capture anew. What the
    forward reads from a process-wide switch (``fused_epilogue.enable``)
    is fixed when it is captured. ``use_graph=False`` forwards eagerly
    every tick."""

    def __init__(self, model, *, input_shape, batch=8,
                 input_dtype=np.float32, policy=None, device=None,
                 use_graph=True, **kw):
        super().__init__(**kw)
        from .. import mixed_precision as mp
        from ..device import get_default_device
        from ..tensor import Tensor

        self.model = model
        self.batch = int(batch)
        self.input_shape = tuple(int(d) for d in input_shape)
        self.input_dtype = np.dtype(input_dtype)
        self.policy = mp.resolve(policy) if policy is not None \
            else getattr(model, "_policy", None)
        dev = device or getattr(model, "dev", None) or get_default_device()
        if getattr(model, "dev", None) is None:
            model.dev = dev
        self.dev = dev
        self.use_graph = bool(use_graph)
        self._Tensor = Tensor
        # padded host batch; pinned on the card so the copy in is async
        self._host = torch.zeros((self.batch,) + self.input_shape,
                                 dtype=torch.from_numpy(
                                     np.zeros(0, self.input_dtype)).dtype,
                                 pin_memory=dev.is_cuda)
        self._graph = None
        self._watched = None          # [(state, its data, its version)]
        self._graph_resources = resources(dev) if self.use_graph else None
        # materialise the lazily-initialised params with one forward; in
        # graph mode capture the next
        self._forward()
        if self.use_graph:
            self._forward()
        self._occupancy = self._reg.gauge(
            "serve_slot_occupancy", "rows of the batch holding a request")
        self._reg.gauge("serve_slots", "batch width").set(self.batch)

    def graph_stats(self):
        """``{"n_captures", "n_replays"}`` of the current graph (zeros
        without one)."""
        return self._graph.stats() if self._graph is not None \
            else {"n_captures": 0, "n_replays": 0}

    def _forward(self):
        """One forward of the padded host batch; returns the output
        tensors on the host."""
        if not self.use_graph:
            leaves = self._run(self._host)
        else:
            if self._graph is None or not self._states_unchanged():
                self._graph = StepGraph(self._run, self.dev,
                                        self._graph_resources)
            leaves = self._graph(self._host)
            if self._watched is None:
                self._watched = [(t, t.data, t.data._version) for t in
                                 self.model.get_states().values()]
        return [v.cpu().numpy() for v in leaves]

    def _states_unchanged(self):
        """Whether every model state holds the tensor and the version it
        held when the current graph was made; if not, a fresh graph (and
        a fresh watch) is due."""
        if self._watched is not None and all(
                t.data is d and d._version == v
                for t, d, v in self._watched):
            return True
        self._watched = None
        return False

    def _run(self, x):
        """The forward of batch ``x`` (host or device): its outputs as
        device tensors, under the policy, bf16 ones in f32."""
        from .. import mixed_precision as mp
        x = x.to(self.dev.torch_device, non_blocking=True)
        prev = CTX.training
        CTX.training = False
        try:
            with torch.inference_mode(), mp.policy_scope(self.policy):
                out = self.model.forward(self._Tensor(data=x,
                                                      device=self.dev))
                outs = out if isinstance(out, (list, tuple)) else (out,)
                leaves = [o.data if isinstance(o, self._Tensor) else o
                          for o in outs]
                if self.policy is not None:
                    leaves = [self.policy.cast_output(v) for v in leaves]
                return [v.float() if v.dtype == torch.bfloat16 else v
                        for v in leaves]
        finally:
            CTX.training = prev

    def submit(self, x, timeout=None, trace_id=None):
        """Queue one input of ``input_shape``; the future's result is the
        model's row for it (array, or tuple for multi-output models)."""
        x = np.asarray(x, self.input_dtype)
        if x.shape != self.input_shape:
            self.queue.finish("rejected")
            raise ServingError(f"input shape {x.shape} != engine "
                               f"input_shape {self.input_shape}")
        return self._admit(Request(x, timeout=timeout, trace_id=trace_id))

    def _busy(self):
        return len(self.queue) > 0

    def _tick(self):
        batch = self.queue.pop_batch(self.batch)
        if not batch:
            return
        self._occupancy.set(len(batch))
        host = self._host.numpy()
        host[len(batch):] = 0
        for i, req in enumerate(batch):
            host[i] = req.payload
        t0 = time.perf_counter()
        try:
            leaves = self._forward()
        except Exception as e:
            self._fail_batch(batch, e)
            raise
        self._tick_lat.observe(time.perf_counter() - t0)
        for i, req in enumerate(batch):
            now = time.monotonic()
            req.first_token_at = now
            self._ttft.observe(now - req.submitted_at)
            row = tuple(leaf[i] for leaf in leaves)
            req.future.set_result(row[0] if len(row) == 1 else row)
            self.queue.finish("completed")
        self._occupancy.set(0)


_BATCH_KEYS = ("input_shape", "batch", "input_dtype", "policy",
               "queue_capacity", "registry", "device", "use_graph")
_NOT_PORTED = ("faults", "aot_store", "profile_every", "telemetry_dir",
               "max_retries", "trace_requests", "mesh", "model_shards")


def build_engine(model, **kw):
    """The ``Model.compile_serving`` backend: a
    :class:`BatchServingEngine` for a stateless model (pass
    ``input_shape=``)."""
    if hasattr(model, "decode_adapter"):
        raise NotImplementedError(
            "autoregressive serving (ServingEngine) is not ported yet "
            "(ROADMAP: slice D, LM serving)")
    not_ported = sorted(set(kw) & set(_NOT_PORTED))
    if not_ported:
        raise NotImplementedError(
            f"serving option(s) {not_ported} are not ported yet (ROADMAP: "
            "left out of the serving slice)")
    if "input_shape" not in kw:
        raise TypeError("stateless serving needs input_shape=(per-sample "
                        f"shape) for {type(model).__name__}")
    unknown = sorted(set(kw) - set(_BATCH_KEYS))
    if unknown:
        raise TypeError(
            f"unknown serving option(s) {unknown} for stateless "
            f"{type(model).__name__} (accepted: {sorted(_BATCH_KEYS)})")
    return BatchServingEngine(model, **kw)


__all__ = ["BatchServingEngine", "build_engine"]
