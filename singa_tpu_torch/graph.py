"""Graph mode: a step captured once per input signature and replayed.

Counterpart of the graph-mode machinery of ``singa_tpu/model.py``
(``_build_step`` ``:645``, ``_run_step`` ``:855-1050``): where the JAX
package jits the train step into one executable, the port captures it in
one ``torch.cuda.CUDAGraph``. A :class:`StepGraph` holds one input
signature's step:

- call 1 runs ``fn`` eagerly on the caller's inputs, so every lazily made
  state exists (optimizer aux states, a guard's shadows, BN statistics)
  and cuDNN, cuBLAS and the allocator are warm; on the card it runs on the
  side stream that the capture uses;
- call 2 copies the inputs into static buffers on the step's device (a
  pinned host batch is copied in asynchronously) and captures ``fn`` on
  them: on the card on the side stream, in the memory pool the owner
  shares among its signatures (``torch.cuda.graph_pool_handle()``), with
  the device's ``torch.Generator`` registered, so that a step which draws
  random numbers advances it on every replay (the JAX step splits its key
  inside the trace, ``singa_tpu/model.py:660-664``); then it replays;
- later calls copy their inputs into the static buffers and replay.

Every call after the first returns clones of the static outputs: a
returned loss must not change under the caller at the next call (the JAX
step returns fresh arrays). ``n_captures`` is the JAX package's
``n_traces`` and stays 1 in steady state; ``n_replays`` counts replays.
The kernel wrappers' launch counters count host calls, so they move while
a step is captured and not while it replays: a replay launches what its
capture counted.

A replay runs what was captured: a process-wide switch that ``fn`` reads
(``fused_epilogue.enable``, ``attention.USE_PLAIN``) counts as it stood at
the capture. A data-parallel step's NCCL collectives (``opt.DistOpt``) are
captured with it: the communicator exists before the capture
(``parallel.communicator.init_process`` makes it eagerly) and call 1 has
run every collective once. A gloo group's collectives go through the host
and cannot be captured; ``Model`` refuses graph mode on the card over one.

On the CPU the same class keeps the same books (static buffers, the eager
first call, clone-out) and runs ``fn`` on the static buffers where the
card would replay. That is the caller's device, not a fallback: on the
card a capture or replay error raises and nothing runs eagerly instead
(a failed capture leaves the pool and the generators usable, and the
signature's next call captures again).
"""

from __future__ import annotations

import contextlib
import gc

import torch

from .tensor import Tensor

__all__ = ["StepGraph", "epoch", "resources", "signature", "in_step",
           "stepping"]

_epoch = 0
_in_step = 0


def epoch() -> int:
    """A number that moves when a :class:`StepGraph` begins or ends a
    capture and at every replay. Tensor versions do not move at a replay,
    so a host cache of device values keys on this too: a capture then
    records the computation and not a tensor cached before it, and no host
    read after a replay finds a tensor computed before it."""
    return _epoch


def in_step() -> bool:
    """Whether a :class:`StepGraph` is running its step (any call: the
    eager first one, the capture, a replay's run on the CPU). An op whose
    output shape depends on values (``autograd.nonzero``) refuses to run
    then: it would read the device back to the host."""
    return _in_step > 0


@contextlib.contextmanager
def stepping():
    """Mark a step as running for :func:`in_step` (a :class:`StepGraph`
    call, or a capture its owner makes itself)."""
    global _in_step
    _in_step += 1
    try:
        yield
    finally:
        _in_step -= 1


def _tick():
    global _epoch
    _epoch += 1


def resources(device):
    """What the StepGraphs of one owner share: ``[memory pool, capture
    side stream]`` on the card, ``[None, None]`` on the CPU. A failed
    capture replaces both in the list, so every StepGraph that holds it
    goes on with the fresh ones."""
    if not device.is_cuda:
        return [None, None]
    return [torch.cuda.graph_pool_handle(),
            torch.cuda.Stream(device.torch_device)]


def _data(a):
    return a.data if isinstance(a, Tensor) else a


def signature(args):
    """The cache key of one call's arguments: shape, dtype, strides and
    device of each tensor; the value (or, unhashable, the repr) of
    anything else."""
    key = []
    for a in args:
        t = _data(a)
        if isinstance(t, torch.Tensor):
            key.append((tuple(t.shape), t.dtype, t.stride(), str(t.device)))
        else:
            try:
                hash(t)
                key.append(t)
            except TypeError:
                key.append(repr(t))
    return tuple(key)


def _flatten(out):
    """The torch tensors of ``out`` (a Tensor, a torch tensor, or a tuple
    or list of them, nested) and a function that rebuilds ``out`` around
    other tensors; anything else is kept as it is."""
    if isinstance(out, Tensor):
        dev = out.device
        return [out.data], lambda ts: Tensor(data=ts[0], device=dev)
    if isinstance(out, torch.Tensor):
        return [out], lambda ts: ts[0]
    if isinstance(out, (tuple, list)):
        parts = [_flatten(o) for o in out]

        def rebuild(ts):
            res, at = [], 0
            for leaves, build in parts:
                res.append(build(ts[at:at + len(leaves)]))
                at += len(leaves)
            return type(out)(res)
        return [t for leaves, _ in parts for t in leaves], rebuild
    return [], lambda ts: out


class StepGraph:
    """One input signature's step ``fn`` (module docstring). ``device`` is
    the port :class:`~.device.Device` the step runs on; ``shared`` is the
    list that :func:`resources` makes, which the owner's signatures share
    (a list of their own by default)."""

    def __init__(self, fn, device, shared=None):
        self.fn = fn
        self.device = device
        self.shared = resources(device) if shared is None else shared
        self.n_calls = 0
        self.n_captures = 0
        self.n_replays = 0
        self._static = None     # per argument: its static buffer, or None
        self._outs = None       # the static outputs
        self._rebuild = None
        self._graph = None

    def __call__(self, *args):
        with stepping():
            if self.n_calls == 0:
                out = self._on_side_stream(lambda: self.fn(*args))
            elif self._static is None:
                out = self._capture(args)
            else:
                out = self._replay(args)
        self.n_calls += 1
        return out

    @property
    def pool(self):
        return self.shared[0]

    @property
    def stream(self):
        return self.shared[1]

    def stats(self):
        return {"n_captures": self.n_captures, "n_replays": self.n_replays}

    def _on_side_stream(self, run):
        if not self.device.is_cuda:
            return run()
        main = torch.cuda.current_stream(self.device.torch_device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = run()
        main.wait_stream(self.stream)
        return out

    def _wrap(self, args, static):
        return [a if buf is None else
                Tensor(data=buf, device=a.device) if isinstance(a, Tensor)
                else buf for a, buf in zip(args, static)]

    def _capture(self, args):
        self._record(args)
        if self._graph is not None:
            self._graph.replay()
        _tick()
        self.n_replays += 1
        return self._cloned()

    def _record(self, args):
        """Copy ``args`` into static buffers and capture ``fn`` on them (on
        the CPU: run it there); nothing runs on the card."""
        static = [_data(a).detach().to(self.device.torch_device, copy=True)
                  if isinstance(_data(a), torch.Tensor) else None
                  for a in args]
        graph = None
        _tick()
        try:
            if self.device.is_cuda:
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(self.device.generator)
                self.stream.wait_stream(
                    torch.cuda.current_stream(self.device.torch_device))
                # a dropped model and its StepGraphs hold each other (the
                # step is a bound method), so the cyclic collector frees
                # their CUDA graphs, whenever it runs; freeing a graph
                # inside a capture invalidates it: collect now, and hold
                # the collector off until the capture ends
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self.pool,
                                          stream=self.stream):
                        out = self.fn(*self._wrap(args, static))
                except BaseException:
                    self._recover_from_capture()
                    raise
                finally:
                    if collecting:
                        gc.enable()
            else:
                out = self.fn(*self._wrap(args, static))
        finally:
            _tick()
        self._keep(out)
        self._static, self._graph = static, graph
        self.n_captures += 1

    def _recover_from_capture(self):
        """A capture that fails stops before its end: the generators it
        registered (the device's and PyTorch's default one) stay in
        capture mode, so their next draw outside a graph raises, and the
        caching allocator goes on recording into its pool, so a later
        capture into the pool raises. An empty capture that registers the
        same generators, in a pool of its own, runs their start and end
        and puts them back as they were; the owner's signatures go on
        with a fresh pool and side stream."""
        empty = torch.cuda.CUDAGraph()
        empty.register_generator_state(self.device.generator)
        with torch.cuda.graph(empty, stream=self.stream):
            pass
        self.shared[:] = resources(self.device)

    def _replay(self, args):
        for buf, a in zip(self._static, args):
            if buf is not None:
                buf.copy_(_data(a), non_blocking=True)
        _tick()
        if self._graph is not None:
            self._graph.replay()
        else:
            self._keep(self.fn(*self._wrap(args, self._static)))
        self.n_replays += 1
        return self._cloned()

    def _keep(self, out):
        leaves, self._rebuild = _flatten(out)
        self._outs = [t.detach() for t in leaves]

    def _cloned(self):
        return self._rebuild([t.clone() for t in self._outs])
