"""Continuous-batching and stateless serving engines.

Counterpart of ``singa_tpu/serving/engine.py``. Two engines share one
control plane (:class:`_EngineBase`: admission, the background loop,
synchronous stepping, drain, stop, crash handling, TTFT and per-tick
latency):

- :class:`ServingEngine` (``engine.py:621-2093``) serves an
  autoregressive model through its ``decode_adapter`` (the Transformer
  LM's ``_LMServeAdapter``): a ``slots``-wide slot table over a KV cache
  (``kv_cache.py``: the ring, or with ``kv_layout="paged"`` the block pool
  with its prefix cache), and two fixed-shape programs, a batched
  ``prefill`` of ``prefill_batch`` padded prompts and a ``decode`` of one
  token for every slot (with ``speculative_k=K`` on the paged layout, a
  K-token verify of n-gram drafts). Finished sequences free their slot
  mid-batch and queued requests refill it. Where the JAX package jits
  each program once and donates the KV state, the port captures each
  into a CUDA graph once and replays it every tick, with the host inputs
  copied into static device buffers and the KV state written in place.
  Each program runs under ``torch.inference_mode()``; the logits come to
  the host once per tick, where ``models.decode.sample_logits`` draws
  each request's token, as in the JAX engine. ``use_graph=False`` runs
  the same programs eagerly every tick.
- :class:`BatchServingEngine` (``engine.py:2094-2269``) serves classifier
  models: each tick gathers up to ``batch`` queued requests, pads them to
  the fixed width, runs ONE forward under ``torch.inference_mode()`` and
  the precision policy (replayed from a ``graph.StepGraph``; the BN+ReLU
  tails through kernel K2 when ``ops.fused_epilogue`` is enabled), and
  delivers each request its row.

Not ported yet, each raising ``NotImplementedError`` naming ROADMAP.md:
fault injection and retries, the telemetry and per-request traces,
profiled ticks and AOT export (slice E); sharded serving (``mesh``,
``model_shards``), the host spill tier (``spill_bytes``), KV snapshots
(``snapshot_every``, ``snapshot_slot``, ``inject_snapshot``,
``drain(handoff=...)``) and the disaggregated pools (``pool_role``,
``set_transfer``) (slice D2); quantized policies (``mixed_precision``).
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

from ..autograd_base import CTX
from ..graph import StepGraph, resources, stepping
from ..models import decode as _decode
from ..observability import metrics as _metrics
from . import kv_cache as _kvc
from .scheduler import (BlockPoolExhausted, EngineDraining, ReplicaCrashed,
                        Request, RequestQueue, RequestTimeout, ServingError)


def _not_ported(what, where):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md: {where})")


class _EngineBase:
    """Shared control plane: queue, loop thread, drain, stop, SLO
    metrics."""

    def __init__(self, *, queue_capacity=64, registry=None):
        self._reg = registry if registry is not None \
            else _metrics.default_registry()
        self.queue = RequestQueue(queue_capacity, registry=self._reg)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle_evt = threading.Event()
        self._thread = None
        self._running = False
        self._draining = False
        self._stopped = False
        self._crashed = None
        self._tick_count = 0
        self._ttft = self._reg.histogram(
            "serve_ttft_seconds",
            "request submit to first result (queue wait included)")
        self._tick_lat = self._reg.histogram(
            "serve_token_seconds",
            "latency of one serving tick (one decode tick of the "
            "continuous-batching engine)")

    def _admit(self, req):
        if self._crashed is not None:
            self.queue.finish("rejected")
            raise ReplicaCrashed(f"engine crashed ({self._crashed}); not "
                                 "accepting requests")
        if self._draining or self._stopped:
            self.queue.finish("rejected")
            raise EngineDraining(
                "engine is draining/stopped; not accepting new requests")
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

    def _fail_inflight(self, error):
        """Fail the requests that hold a slot (none between ticks of a
        stateless engine)."""

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
                self._idle_evt.set()
                self._wake.wait(0.02)
                self._wake.clear()
                continue
            self._idle_evt.clear()
            try:
                self._tick()
                self._tick_count += 1
            except Exception as e:          # noqa: BLE001 — crash path
                self._crash(e)
                return
        self._idle_evt.set()

    def _crash(self, exc):
        """Serve-loop death: fail every pending and in-flight future
        exactly once."""
        self._crashed = exc
        self._running = False
        self._stopped = True
        err = ReplicaCrashed(f"serve loop crashed: {exc}")
        err.__cause__ = exc
        self.queue.drain_pending(err)
        self._fail_inflight(err)
        self._idle_evt.set()

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

    @property
    def draining(self):
        return self._draining

    def ttft_stats(self):
        """Caller-felt TTFT quantiles ``{"count", "p50_s", "p99_s"}``."""
        s = self._ttft.summary()
        return {"count": s["count"], "p50_s": s["p50"], "p99_s": s["p99"]}

    def tick_stats(self):
        """Per-tick latency quantiles ``{"count", "p50_s", "p99_s"}``."""
        s = self._tick_lat.summary()
        return {"count": s["count"], "p50_s": s["p50"], "p99_s": s["p99"]}

    def drain(self, timeout=60.0, handoff=None):
        """Graceful drain: refuse new requests, finish everything in
        flight and queued, return True once idle (False when the loop
        crashed or ``timeout`` passed first). Without the background
        thread the drain ticks inline. A ``handoff`` (migrating requests
        to a survivor by the deadline) is not ported yet."""
        if handoff is not None:
            raise _not_ported("drain(handoff=...), the live-KV handoff",
                              "slice D2, integrity.py framing")
        self._draining = True
        self._wake.set()
        if self._thread is None:
            self.run_until_idle()
            return True
        deadline = time.monotonic() + float(timeout)
        while True:
            if self._crashed is not None:
                return False
            if not self._busy() and self._idle_evt.wait(0.05):
                if not self._busy():
                    return True
            if time.monotonic() >= deadline:
                return not self._busy()
            time.sleep(0.01)

    def stop(self):
        """Hard stop: end the loop and fail what is still queued or in
        flight (``drain`` first for a graceful exit). Returns the number
        of queued requests failed."""
        self._stopped = True
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._crashed is None:
            err = EngineDraining("engine stopped")
            n = self.queue.drain_pending(err)
            self._fail_inflight(err)
            return n
        return 0


class _Program(StepGraph):
    """One of a :class:`ServingEngine`'s programs as a CUDA graph. The
    first call runs ``fn`` eagerly (on the card on the capture's side
    stream, which warms cuBLAS and the allocator) and captures it right
    after, which runs nothing; every later call copies its inputs into
    the static buffers and replays. On the CPU the first call also runs
    ``fn`` on the static buffers where the card captures (a tick run twice
    on the same inputs writes the same rows), and later calls run it on
    them. ``n_captures`` is 1 from the first call on. The outputs are the
    static tensors themselves: the engine copies them to the host before
    its next call."""

    def __call__(self, *args):
        first = self.n_calls == 0
        out = super().__call__(*args)
        if first:
            with stepping():
                self._record(args)
        return out

    def _cloned(self):
        return self._rebuild(self._outs)


class _EagerProgram:
    """A program run eagerly at every call (``use_graph=False``); it counts
    as built from its first call on, as a captured one."""

    def __init__(self, fn):
        self.fn = fn
        self.n_captures = 0

    def __call__(self, *args):
        self.n_captures = 1
        return self.fn(*args)


class ServingEngine(_EngineBase):
    """Continuous-batching autoregressive engine (module docstring).

    ``adapter`` is a model's ``decode_adapter()``; the engine runs on its
    device (the model's). ``policy`` is what ``compiled_step_info``
    reports; the adapter applies it. The KV layout declines loudly where
    the JAX engine does: ``kv_layout="paged"`` on an adapter without paged
    programs warns and serves on the ring, and ``speculative_k`` on the
    ring warns and decodes one token a tick."""

    def __init__(self, adapter, *, slots=4, max_len=64, prefill_len=16,
                 prefill_batch=2, policy=None, kv_layout="ring",
                 kv_block_size=16, kv_blocks=None, speculative_k=0,
                 pool_role="colocated", use_graph=True, **kw):
        pool_role = str(pool_role)
        if pool_role not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"pool_role must be 'colocated', 'prefill' or 'decode', "
                f"got {pool_role!r}")
        if pool_role != "colocated":
            raise _not_ported(f"pool_role={pool_role!r} (the disaggregated "
                              "prefill/decode pools)",
                              "slice D2, integrity.py framing")
        super().__init__(**kw)
        self.adapter = adapter
        self.pool_role = pool_role
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len)
        self.prefill_batch = max(1, min(int(prefill_batch), self.slots))
        if self.prefill_len > self.max_len:
            raise ValueError(
                f"prefill_len {self.prefill_len} exceeds the ring "
                f"length max_len {self.max_len}: prompt rows must fit "
                "the cache without wrapping over themselves")
        validate = getattr(adapter, "validate", None)
        if validate is not None:
            validate(prefill_len=self.prefill_len, max_len=self.max_len)
        self.policy = policy
        self.dev = adapter.device
        self.use_graph = bool(use_graph)
        self._P = adapter.params()
        self._slots = [None] * self.slots        # host-side slot table
        self._on_logits = None      # hook(kind, host logits, rows)

        # -- KV layout (decline loudly, never silently) -------------------
        kv_layout = str(kv_layout)
        if kv_layout not in ("ring", "paged"):
            raise ValueError(
                f"kv_layout must be 'ring' or 'paged', got {kv_layout!r}")
        self._kv_declined = None
        if kv_layout == "paged" and \
                not getattr(adapter, "supports_paged", False):
            warnings.warn(
                f"kv_layout='paged' declined: {type(adapter).__name__} "
                "has no paged block-pool programs; serving on the ring "
                "layout instead", stacklevel=3)
            self._kv_declined = "adapter_unsupported"
            kv_layout = "ring"
        self.kv_layout = kv_layout
        # the verify program needs the paged mask's position-exactness: a
        # wrapped ring would put a rejected draft's row in the window
        spec = int(speculative_k or 0)
        self._spec_declined = None
        if spec > 1 and self.kv_layout != "paged":
            warnings.warn(
                "speculative_k declined: speculative decoding needs "
                "kv_layout='paged' (the ring's wraparound would "
                "re-attribute rejected-draft rows into the attention "
                "window); decoding one token per tick", stacklevel=3)
            self._spec_declined = "requires_paged_layout"
            spec = 0
        self._spec_width = max(1, spec)
        self.speculative_k = self._spec_width \
            if self._spec_width > 1 else 0
        self._spec_throttled = False

        B, S, W = self.prefill_batch, self.prefill_len, self.slots
        i64, flag = torch.int64, torch.bool
        if self.kv_layout == "paged":
            self.kv_block_size = int(kv_block_size)
            if self.kv_block_size < 1:
                raise ValueError(
                    f"kv_block_size must be >= 1, got {kv_block_size}")
            self._max_blocks = -(-self.max_len // self.kv_block_size)
            # the default pool covers slots x max_len; a smaller one is
            # where paged memory saves, admission backpressure keeps it safe
            self.kv_blocks = int(kv_blocks) if kv_blocks \
                else self.slots * self._max_blocks
            if self.kv_blocks < 1:
                raise ValueError(f"kv_blocks must be >= 1, got {kv_blocks}")
            self._mgr = _kvc.BlockManager(self.kv_blocks, self.kv_block_size)
            self._cache = adapter.init_pool(self.kv_blocks,
                                            self.kv_block_size)
            MB, K = self._max_blocks, self._spec_width
            prefill_raw = adapter.paged_prefill_fn()
            decode_raw = adapter.paged_decode_fn()
            # tables, tokens, starts, lengths, valid
            prefill_in = [((B, MB), i64), ((B, S), i64), ((B,), i64),
                          ((B,), i64), ((B,), flag)]
            # tables, tokens, positions, counts
            decode_in = [((W, MB), i64), ((W, K), i64), ((W,), i64),
                         ((W,), i64)]
        else:
            self._mgr = None
            self.kv_block_size = None
            self.kv_blocks = None
            self._cache = adapter.init_cache(self.slots, self.max_len)
            prefill_raw = adapter.prefill_fn()
            decode_raw = adapter.decode_fn()
            # tokens, lengths, slot_ids, valid
            prefill_in = [((B, S), i64), ((B,), i64), ((B,), i64),
                          ((B,), flag)]
            # tokens, positions, active
            decode_in = [((W,), i64), ((W,), i64), ((W,), flag)]
        pinned = self.dev.is_cuda
        self._prefill_in = [torch.zeros(sh, dtype=dt, pin_memory=pinned)
                            for sh, dt in prefill_in]
        self._decode_in = [torch.zeros(sh, dtype=dt, pin_memory=pinned)
                           for sh, dt in decode_in]
        self._out_host = {}
        self._graph_res = resources(self.dev) if self.use_graph else None
        self._prefill = self._program(prefill_raw)
        self._decode = self._program(decode_raw)

        self._occupancy = self._reg.gauge(
            "serve_slot_occupancy", "active sequences in the slot array")
        self._reg.gauge("serve_slots",
                        "slot array width (max in-flight sequences)"
                        ).set(self.slots)
        self._tokens_total = self._reg.counter(
            "serve_tokens_total", "tokens generated")
        self._decode_steps = self._reg.counter(
            "serve_decode_steps_total",
            "continuous-batching decode ticks executed")
        self._prefills = self._reg.counter(
            "serve_prefill_total", "prompts prefilled into a slot")
        self._prefill_tok = self._reg.counter(
            "serve_prefill_tokens_total",
            "prompt tokens run through the prefill program (the suffix "
            "only under paged prefix hits)")
        if self.kv_layout == "paged":
            self._reg.gauge("kv_blocks_total",
                            "paged KV pool size in blocks").set(self.kv_blocks)
            self._blocks_in_use = self._reg.gauge(
                "kv_blocks_in_use",
                "pool blocks referenced by live sequences (never evicted)")
            self._blocks_cached = self._reg.gauge(
                "kv_blocks_cached",
                "unreferenced blocks held by the prefix cache "
                "(reclaimable, LRU)")
            self._prefix_hits = self._reg.counter(
                "prefix_cache_hits_total",
                "admitted prompts whose prefix matched cached blocks")
            self._prefix_tokens = self._reg.counter(
                "prefix_cache_tokens_total",
                "prompt tokens served from cached prefix blocks instead "
                "of prefill compute")
            self._spec_proposed = self._reg.counter(
                "speculative_proposed_total",
                "draft tokens proposed to the verify program")
            self._spec_accepted = self._reg.counter(
                "speculative_accepted_total",
                "draft tokens accepted by the greedy verify rule")
            self._spec_ratio = self._reg.gauge(
                "speculative_accepted_ratio",
                "cumulative accepted/proposed draft-token ratio")

    def _program(self, raw):
        """``raw`` over this engine's weights and KV state, as a function
        of the host input tensors, captured (or eager: ``use_graph``)."""
        P, cache, dev = self._P, self._cache, self.dev.torch_device

        def fn(*inputs):
            with torch.inference_mode():
                return raw(P, cache, *[x.to(dev, non_blocking=True)
                                       for x in inputs])
        if not self.use_graph:
            return _EagerProgram(fn)
        return _Program(fn, self.dev, self._graph_res)

    def _call(self, program, inputs):
        """One program call; its logits on the host (pinned on the card,
        read after the copy: the tick's one wait for the device)."""
        out = program(*inputs)
        if not self.dev.is_cuda:
            return out.numpy()
        buf = self._out_host.get(program)
        if buf is None:
            buf = self._out_host[program] = torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True)
        buf.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.dev.torch_device).synchronize()
        return buf.numpy()

    # -- public API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, temperature=0.0,
               top_k=None, eos_id=None, seed=0, timeout=None,
               trace_id=None):
        """Queue one generation request; returns its
        :class:`~.scheduler.ServeFuture`, whose result is ``{"tokens":
        [...], "prompt_len": n, "ttft_s": ...}``. Refusals are typed and
        synchronous: an empty prompt or ``max_new_tokens < 1``
        (``ValueError``), a prompt longer than ``prefill_len`` or with ids
        outside the vocabulary, a paged request past ``max_len``
        (``ServingError``), and one no pool could ever hold
        (``BlockPoolExhausted``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (got {max_new_tokens}): "
                "the first token is sampled from the prefill logits, "
                "so every accepted request generates at least one")
        if prompt.size > self.prefill_len:
            self.queue.finish("rejected")
            raise ServingError(
                f"prompt of {prompt.size} tokens exceeds this engine's "
                f"prefill_len {self.prefill_len}")
        vocab = getattr(self.adapter, "vocab_size", None)
        if vocab is not None and (prompt.min() < 0 or prompt.max() >= vocab):
            self.queue.finish("rejected")
            raise ServingError(
                f"prompt token ids must lie in [0, {vocab}); got "
                f"[{prompt.min()}, {prompt.max()}]")
        if self.kv_layout == "paged":
            total = int(prompt.size) + int(max_new_tokens)
            if total > self.max_len:
                self.queue.finish("rejected")
                raise ServingError(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({int(max_new_tokens)}) = {total} exceeds "
                    f"max_len {self.max_len}: the paged layout is "
                    "exact full attention within max_len -- raise "
                    "max_len, or use the ring layout for sliding-window "
                    "generation")
            if self._mgr.n_for(total) > self._mgr.n_blocks:
                self.queue.finish("rejected")
                raise BlockPoolExhausted(
                    f"request needs {self._mgr.n_for(total)} KV blocks "
                    f"but the whole pool is {self._mgr.n_blocks} "
                    f"(x {self.kv_block_size} tokens): it can NEVER "
                    "be admitted -- raise kv_blocks or lower "
                    "max_new_tokens")
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k,
                      eos_id=eos_id, seed=seed, timeout=timeout,
                      trace_id=trace_id)
        return self._admit(req)

    def compiled_step_info(self):
        """Serve-path audit: ``n_traces`` (decode) and ``prefill_n_traces``
        count each program's captures on the card and its builds on the
        CPU (or with ``use_graph=False``); both stay 1 across any refill
        pattern, prefix hit and speculative tick."""
        info = {"n_traces": self._decode.n_captures,
                "prefill_n_traces": self._prefill.n_captures,
                "slots": self.slots, "max_len": self.max_len,
                "prefill_len": self.prefill_len,
                "prefill_batch": self.prefill_batch,
                "kv_layout": self.kv_layout,
                "speculative_k": self.speculative_k,
                "policy": self.policy.describe()
                if self.policy is not None else None,
                "use_graph": self.use_graph, "aot": None}
        if self._kv_declined:
            info["kv_layout_declined"] = self._kv_declined
        if self._spec_declined:
            info["speculative_declined"] = self._spec_declined
        if self.kv_layout == "paged":
            info.update(
                kv_block_size=self.kv_block_size,
                kv_blocks=self.kv_blocks,
                kv_blocks_in_use=self._mgr.blocks_live(),
                kv_blocks_cached=self._mgr.blocks_cached(),
                prefix_cache_entries=len(self._mgr._cache))
        return info

    def active_slots(self):
        return sum(1 for s in self._slots if s is not None)

    def throttle_speculation(self, on=True):
        """Brownout: suspend draft proposal (one token per tick through the
        unchanged verify program) while ``on``. Returns ``self``."""
        self._spec_throttled = bool(on)
        return self

    def set_transfer(self, cb):
        raise _not_ported("the prefill-to-decode transfer (set_transfer)",
                          "slice D2, integrity.py framing")

    def snapshot_slot(self, i):
        raise _not_ported("live-KV snapshots (snapshot_slot)",
                          "slice D2, integrity.py framing")

    def inject_snapshot(self, meta, frame, timeout=None):
        raise _not_ported("live-KV snapshot injection (inject_snapshot)",
                          "slice D2, integrity.py framing")

    # -- loop internals ----------------------------------------------------
    def _busy(self):
        return len(self.queue) > 0 or any(
            s is not None for s in self._slots)

    def _release_blocks(self, slot):
        """Return a paged sequence's block references to the manager (its
        full prompt blocks enter the prefix cache)."""
        alloc = slot.get("alloc")
        if alloc is not None and self._mgr is not None:
            self._mgr.release(alloc, slot["req"].prompt)
            self._update_pool_gauges()

    def _update_pool_gauges(self):
        if self._mgr is not None:
            self._blocks_in_use.set(self._mgr.blocks_live())
            self._blocks_cached.set(self._mgr.blocks_cached())

    def _fail_inflight(self, error):
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                self._release_blocks(slot)
                if not slot["req"].future.done():
                    slot["req"].future.set_error(error)
                    self.queue.finish("failed")
        self._occupancy.set(0)

    def _fail_batch(self, batch, exc):
        # popped but never slotted paged requests carry their reservation
        for req in batch:
            alloc = getattr(req, "_alloc", None)
            if alloc is not None and self._mgr is not None:
                self._mgr.release(alloc, req.prompt)
                req._alloc = None
        self._update_pool_gauges()
        super()._fail_batch(batch, exc)

    def _finish_slot(self, i, status="completed"):
        slot = self._slots[i]
        self._slots[i] = None
        self._release_blocks(slot)
        req = slot["req"]
        if status == "completed":
            req.future.set_result({
                "tokens": list(req.tokens),
                "prompt_len": int(req.prompt.size),
                "ttft_s": (req.first_token_at - req.submitted_at
                           if req.first_token_at else None)})
        elif status == "timed_out":
            req.future.set_error(RequestTimeout(
                f"deadline passed mid-generation after "
                f"{len(req.tokens)} tokens"))
        else:
            req.future.set_error(ServingError(status))
        self.queue.finish(status)

    def _emit(self, req, logits):
        """Draw ``req``'s next token from its logits row; returns the token
        and whether the request is done."""
        tok = _decode.sample_logits(logits, temperature=req.temperature,
                                    top_k=req.top_k, rng=req.rng)
        req.tokens.append(tok)
        self._tokens_total.inc()
        done = (len(req.tokens) >= req.max_new_tokens or
                (req.eos_id is not None and tok == req.eos_id))
        return tok, done

    def _sample_and_place(self, req, logits, slot_idx, pos, alloc=None):
        """The first token after prefill, or the next after a decode tick:
        draw it, then keep the slot hot or finish it."""
        tok, done = self._emit(req, logits)
        self._slots[slot_idx] = {"req": req, "pos": pos, "tok": tok,
                                 "alloc": alloc}
        if done:
            self._finish_slot(slot_idx)

    def _tick(self):
        now = time.monotonic()
        # 1) reap deadline-expired in-flight requests (their slot frees
        #    mid-batch)
        for i, slot in enumerate(self._slots):
            if slot is not None and slot["req"].expired(now):
                self._finish_slot(i, status="timed_out")
        # 2) admit into free slots, one fixed-width prefill batch a tick;
        #    a paged engine reserves each request's blocks in the pop's
        #    predicate, and a request that does not fit now stays at the
        #    head (backpressure; live sequences are never evicted)
        free = [i for i, s in enumerate(self._slots) if s is None]
        if free and len(self.queue) > 0:
            admit = None
            if self.kv_layout == "paged":
                def admit(req):
                    try:
                        req._alloc = self._mgr.admit(
                            req.prompt,
                            int(req.prompt.size) + req.max_new_tokens)
                        return True
                    except BlockPoolExhausted:
                        return False
            batch = self.queue.pop_batch(
                min(len(free), self.prefill_batch), now, admit=admit)
            if batch:
                try:
                    self._run_prefill(batch, free)
                except Exception as e:
                    # popped but not yet slotted: neither the queue nor
                    # the slot table holds them, so fail them here
                    self._fail_batch(batch, e)
                    raise
        # 3) decode: one token (or one verified draft) for every slot
        if any(s is not None for s in self._slots):
            t0 = time.perf_counter()
            self._run_decode()
            self._tick_lat.observe(time.perf_counter() - t0)
            self._decode_steps.inc()
        self._occupancy.set(self.active_slots())

    def _run_prefill(self, batch, free):
        if self.kv_layout == "paged":
            return self._run_prefill_paged(batch, free)
        return self._run_prefill_ring(batch, free)

    def _host_inputs(self, bufs):
        """The numpy views of a program's pinned inputs, zeroed."""
        views = [b.numpy() for b in bufs]
        for v in views:
            v[...] = 0
        return views

    def _first_tokens(self, placed, out):
        for b, (req, slot_idx, alloc) in enumerate(placed):
            req.first_token_at = time.monotonic()
            self._ttft.observe(req.first_token_at - req.submitted_at)
            self._prefills.inc()
            # the first generated token sits at position prompt_len; the
            # next decode tick writes its k/v
            self._sample_and_place(req, out[b], slot_idx,
                                   pos=int(req.prompt.size), alloc=alloc)

    def _run_prefill_ring(self, batch, free):
        tokens, lengths, slot_ids, valid = self._host_inputs(
            self._prefill_in)
        placed = []
        for b, req in enumerate(batch):
            n = req.prompt.size
            tokens[b, :n] = req.prompt
            lengths[b] = n
            slot_ids[b] = free[b]
            valid[b] = True
            placed.append((req, free[b], None))
            self._prefill_tok.inc(int(n))
        out = self._call(self._prefill, self._prefill_in)
        if self._on_logits is not None:
            self._on_logits("prefill", out, [p[0] for p in placed])
        self._first_tokens(placed, out)

    def _run_prefill_paged(self, batch, free):
        """Each popped request arrives with its block reservation taken; a
        prefix hit enters the program with ``start > 0`` and only its
        suffix, attending to the shared blocks it never recomputes."""
        tables, tokens, starts, lengths, valid = self._host_inputs(
            self._prefill_in)
        placed = []
        for b, req in enumerate(batch):
            alloc = req._alloc
            suffix = req.prompt[alloc.shared_tokens:]
            tokens[b, :suffix.size] = suffix
            starts[b] = alloc.shared_tokens
            lengths[b] = suffix.size
            tables[b, :len(alloc.blocks)] = alloc.blocks
            valid[b] = True
            placed.append((req, free[b], alloc))
            self._prefill_tok.inc(int(suffix.size))
            if alloc.shared_tokens:
                self._prefix_hits.inc()
                self._prefix_tokens.inc(alloc.shared_tokens)
        out = self._call(self._prefill, self._prefill_in)
        self._update_pool_gauges()
        for req, _i, _a in placed:
            req._alloc = None          # the slot owns the reservation now
        if self._on_logits is not None:
            self._on_logits("prefill", out, [p[0] for p in placed])
        self._first_tokens(placed, out)

    def _run_decode(self):
        if self.kv_layout == "paged":
            return self._run_decode_paged()
        return self._run_decode_ring()

    def _run_decode_ring(self):
        tokens, positions, active = self._host_inputs(self._decode_in)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                tokens[i] = slot["tok"]
                positions[i] = slot["pos"]
                active[i] = True
        out = self._call(self._decode, self._decode_in)
        if self._on_logits is not None:
            self._on_logits("decode", out, [
                s["req"] if s is not None else None for s in self._slots])
        for i, slot in enumerate(list(self._slots)):
            if slot is not None:
                self._sample_and_place(slot["req"], out[i], i,
                                       pos=slot["pos"] + 1)

    def _run_decode_paged(self):
        """One verify tick: each active slot's row is its pending token
        plus up to ``speculative_k - 1`` n-gram drafts; the program writes
        every row's k/v and scores every position, and the accept walk
        emits the longest run of drafts greedy agrees with, each token
        exactly what sequential greedy decoding gives. A rejected draft's
        rows lie past the new ``pos``, unreachable under the paged mask
        until overwritten."""
        W, K = self.slots, self._spec_width
        tables, tokens, positions, counts = self._host_inputs(
            self._decode_in)
        rows = {}
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            req = slot["req"]
            n = 1
            if K > 1 and req.temperature == 0 \
                    and not self._spec_throttled:
                # greedy only: a sampled request's rng draw order must not
                # change, so it decodes one token a tick
                remaining = req.max_new_tokens - len(req.tokens)
                room = self.max_len - slot["pos"]
                n = max(1, min(K, remaining, room))
            row = [slot["tok"]]
            if n > 1:
                row += _decode.ngram_propose(
                    list(req.prompt) + req.tokens, n - 1)
                self._spec_proposed.inc(n - 1)
            tokens[i, :len(row)] = row
            positions[i] = slot["pos"]
            counts[i] = len(row)
            tables[i, :len(slot["alloc"].blocks)] = slot["alloc"].blocks
            rows[i] = row
        out = self._call(self._decode, self._decode_in)     # (W, K, V)
        if self._on_logits is not None:
            self._on_logits("decode", out, [
                s["req"] if s is not None else None for s in self._slots])
        for i, slot in enumerate(list(self._slots)):
            if slot is None:
                continue
            req, row, cnt = slot["req"], rows[i], int(counts[i])
            emitted = 0
            done = False
            for j in range(cnt):
                tok, done = self._emit(req, out[i, j])
                emitted += 1
                if done:
                    break
                if j + 1 < cnt and row[j + 1] == tok:
                    continue        # draft accepted: its k/v row is right
                break
            if cnt > 1:
                self._spec_accepted.inc(emitted - 1)
                proposed = self._spec_proposed.total()
                if proposed:
                    self._spec_ratio.set(
                        self._spec_accepted.total() / proposed)
            self._slots[i] = {"req": req, "pos": slot["pos"] + emitted,
                              "tok": req.tokens[-1],
                              "alloc": slot["alloc"]}
            if done:
                self._finish_slot(i)


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
        return self._admit(Request(None, payload=x, timeout=timeout,
                                   trace_id=trace_id))

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
_AR_KEYS = ("slots", "max_len", "prefill_len", "prefill_batch", "policy",
            "queue_capacity", "registry", "kv_layout", "kv_block_size",
            "kv_blocks", "speculative_k", "pool_role", "use_graph")
# option -> where ROADMAP.md puts it
_NOT_PORTED = {
    "faults": "slice E, resilience/faults.py",
    "max_retries": "slice E, resilience/faults.py",
    "telemetry_dir": "slice E, observability/",
    "trace_requests": "slice E, observability/",
    "profile_every": "slice E, observability/ and profiling.py",
    "aot_store": "slice E, aot/",
    "mesh": "slice D2, the serving half of parallel/gspmd.py",
    "model_shards": "slice D2, the serving half of parallel/gspmd.py",
    "spill_bytes": "slice D2, integrity.py framing",
    "snapshot_every": "slice D2, integrity.py framing",
}


def build_engine(model, **kw):
    """The ``Model.compile_serving`` backend: a :class:`ServingEngine` over
    the ``decode_adapter`` of an autoregressive model, on the model's
    device; a :class:`BatchServingEngine` for a stateless model (pass
    ``input_shape=``). An option that is not ported yet raises
    ``NotImplementedError`` naming ROADMAP.md, an unknown one
    ``TypeError``."""
    not_ported = sorted(set(kw) & set(_NOT_PORTED))
    if not_ported:
        where = "; ".join(f"{k}: {_NOT_PORTED[k]}" for k in not_ported)
        raise NotImplementedError(
            f"serving option(s) {not_ported} are not ported yet "
            f"(ROADMAP.md: {where})")
    if hasattr(model, "decode_adapter"):
        unknown = sorted(set(kw) - set(_AR_KEYS))
        if unknown:
            raise TypeError(
                f"unknown serving option(s) {unknown} for autoregressive "
                f"{type(model).__name__} (accepted: {sorted(_AR_KEYS)})")
        adapter = model.decode_adapter(policy=kw.get("policy"))
        return ServingEngine(adapter, **kw)
    if "input_shape" not in kw:
        raise TypeError("stateless serving needs input_shape=(per-sample "
                        f"shape) for {type(model).__name__}")
    unknown = sorted(set(kw) - set(_BATCH_KEYS))
    if unknown:
        raise TypeError(
            f"unknown serving option(s) {unknown} for stateless "
            f"{type(model).__name__} (accepted: {sorted(_BATCH_KEYS)})")
    return BatchServingEngine(model, **kw)


__all__ = ["ServingEngine", "BatchServingEngine", "build_engine"]
