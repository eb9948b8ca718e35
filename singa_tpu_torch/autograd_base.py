"""Global autograd mode flags and reverse mode over torch autograd.

Counterpart of ``singa_tpu/autograd_base.py:29-49`` (the ``CTX`` training
flag and :func:`is_training`) and ``:217-262`` (:func:`backward`,
:func:`gradients`). The JAX package records its own tape of
``Operator``s; the port lets torch autograd record the graph of the
forward and walks it: :func:`backward` finds the parameter leaves the
output depends on (the Tensors made with ``stores_grad``) and computes
their gradients with one ``torch.autograd.grad``. The port's own ops with
a custom gradient are ``torch.autograd.Function``s (flash attention,
``ops/attention.py``; the fused CE head, ``ops/losses.py``).

:class:`Operator` (``singa_tpu/autograd_base.py:62-180``) stays as the
user's extension point: a subclass writes ``forward`` (and, for a custom
gradient, ``backward``) on raw torch tensors. Without a ``backward`` of
its own, torch autograd differentiates ``forward`` (the JAX package takes
its vjp); with one, the op runs as a ``torch.autograd.Function`` whose
backward calls it. Like the JAX tape, an op called in training records
its sources (``src``), which :func:`infer_dependency` counts, and
:class:`Dummy` stands for a leaf.

The serving path runs under ``torch.inference_mode()`` and records
nothing.
"""

from __future__ import annotations

import weakref
from collections import deque

import torch

from . import device as device_mod


class _Context:
    def __init__(self):
        self.training = False


CTX = _Context()


def is_training() -> bool:
    return CTX.training


def set_training(flag: bool) -> None:
    CTX.training = bool(flag)


def _raw(x):
    from .tensor import Tensor
    return x.data if isinstance(x, Tensor) else x


class _OperatorFunction(torch.autograd.Function):
    """Runs an :class:`Operator` that has a ``backward`` of its own: its
    ``forward`` on the raw inputs, its ``backward`` on the output
    cotangents (None where an input takes no gradient)."""

    @staticmethod
    def forward(ctx, op, *raws):
        ctx.op = op
        ctx.takes = [isinstance(r, torch.Tensor) for r in raws]
        ys = op.forward(*raws)
        return tuple(ys) if isinstance(ys, (tuple, list)) else ys

    @staticmethod
    def backward(ctx, *dys):
        dxs = ctx.op.backward(*dys)
        if not isinstance(dxs, (tuple, list)):
            dxs = (dxs,)
        if len(dxs) != len(ctx.takes):
            raise RuntimeError(f"{ctx.op.name}: backward returned "
                               f"{len(dxs)} gradients for "
                               f"{len(ctx.takes)} inputs")
        return (None,) + tuple(d if take else None
                               for d, take in zip(dxs, ctx.takes))


class Operator:
    """A differentiable operation on Tensors: ``forward(*raw tensors)``
    returns a raw tensor or a tuple of them. A subclass that defines
    ``backward(*dys)`` (one gradient per input, on raw tensors) gets that
    gradient; otherwise torch autograd differentiates ``forward``, and
    :meth:`backward` returns its vector-Jacobian product of the last
    recorded call."""

    op_count = 0
    differentiable = True

    def __init__(self, name=None):
        if name is None:
            name = f"{type(self).__name__}#{Operator.op_count}"
            Operator.op_count += 1
        self.name = name
        self.src = []
        self.y_ids = ()
        self.y_shapes = ()
        self.y_dtypes = ()
        self.dev = None
        self._recorded = None

    def __call__(self, *xs):
        return self._do_forward(*xs)

    def _has_custom_backward(self) -> bool:
        return type(self).backward is not Operator.backward

    def _do_forward(self, *xs):
        from .tensor import Tensor
        raws = [_raw(x) for x in xs]
        self.dev = next((x.device for x in xs if isinstance(x, Tensor)),
                        None) or device_mod.get_default_device()
        grads = torch.is_grad_enabled() and self.differentiable and any(
            isinstance(r, torch.Tensor) and r.requires_grad for r in raws)
        if grads and self._has_custom_backward():
            ys = _OperatorFunction.apply(self, *raws)
        elif self.differentiable:
            ys = self.forward(*raws)
        else:
            with torch.no_grad():
                ys = self.forward(*raws)
        multiple = isinstance(ys, (tuple, list))
        ys_t = tuple(ys) if multiple else (ys,)
        outs = [Tensor(data=y, device=self.dev) for y in ys_t]
        tape = grads and CTX.training
        if tape:
            for t in outs:
                t.requires_grad = True
                t.creator = self
            self.src = []
            for x, r in zip(xs, raws):
                if isinstance(r, torch.Tensor) and r.requires_grad:
                    if isinstance(x, Tensor) and x.creator is None:
                        x.creator = Dummy(x)
                    self.src.append((getattr(x, "creator", None), id(x),
                                     x if getattr(x, "stores_grad", False)
                                     else None, True))
                else:
                    self.src.append((None, id(x), x if isinstance(
                        x, Tensor) else None, False))
            self.y_ids = tuple(id(t) for t in outs)
            self.y_shapes = tuple(tuple(y.shape) for y in ys_t)
            self.y_dtypes = tuple(y.dtype for y in ys_t)
            self._recorded = (raws, ys_t)
        return tuple(outs) if multiple else outs[0]

    def forward(self, *xs):
        raise NotImplementedError

    def backward(self, *dys):
        """The vector-Jacobian product of the last recorded call: one
        gradient per input (None where it takes none)."""
        if self._recorded is None:
            raise RuntimeError(f"{self.name}: backward called without a "
                               "recorded forward")
        raws, ys = self._recorded
        wrt = [r for r in raws if isinstance(r, torch.Tensor) and
               r.requires_grad]
        got = iter(torch.autograd.grad(
            ys, wrt, grad_outputs=[_raw(d) for d in dys],
            retain_graph=True, allow_unused=True))
        grads = tuple(next(got) if isinstance(r, torch.Tensor) and
                      r.requires_grad else None for r in raws)
        return grads if len(grads) > 1 else grads[0]


class Dummy(Operator):
    """The creator of a leaf: a graph input or a parameter."""

    def __init__(self, tensor, name=None):
        super().__init__(name)
        self.tensor = tensor
        self.src = []
        self.y_ids = (id(tensor),)
        self.y_shapes = (tuple(tensor.shape),)
        self.y_dtypes = (tensor.dtype,)


def infer_dependency(op: Operator):
    """For every op upstream of ``op``, the number of consumer edges that
    reach it (``singa_tpu/autograd_base.py:162-176``)."""
    dependency = {op: 0}
    queue = deque([op])
    while queue:
        cur = queue.popleft()
        for (src_op, _xid, _t, requires) in cur.src:
            if src_op is None or not requires:
                continue
            if src_op not in dependency:
                dependency[src_op] = 0
                queue.append(src_op)
            dependency[src_op] += 1
    return dependency


def register_param(t):
    """Mark Tensor ``t``'s torch tensor as a parameter leaf that
    :func:`backward` yields: it requires grad and points back at ``t``."""
    t.data.requires_grad_(True)
    t.data._singa_param = weakref.ref(t)


def _leaf_chain(fn):
    """Whether ``fn`` reaches a leaf through nodes of one input each: the
    reshape or cast of a parameter that the JAX package does inside the op
    consuming it."""
    while not hasattr(fn, "variable"):
        if len(fn.next_functions) != 1 or fn.next_functions[0][0] is None:
            return False
        fn = fn.next_functions[0][0]
    return True


def _param_leaves(root):
    """The parameter Tensors ``root``'s autograd graph reaches, in reverse
    topological order (a node after every node that consumes it), in the
    order of the JAX package's tape walk (``singa_tpu/autograd_base.py``:
    first in, first out over ops; the last layer's first, its bias before
    its weight). A node that only reshapes or casts a parameter is no op
    of the JAX tape: the walk goes through it at once."""
    consumers, stack, seen = {}, [root], {root}
    while stack:
        for fn, _ in stack.pop().next_functions:
            if fn is None:
                continue
            consumers[fn] = consumers.get(fn, 0) + 1
            if fn not in seen:
                seen.add(fn)
                stack.append(fn)
    out, ready = [], deque([root])
    while ready:
        fn = ready.popleft()
        leaf = getattr(fn, "variable", None)
        if leaf is not None:
            ref = getattr(leaf, "_singa_param", None)
            t = ref() if ref is not None else None
            if t is not None and t.stores_grad and t.data is leaf:
                out.append(t)
        through = leaf is None and _leaf_chain(fn)
        for nxt, _ in fn.next_functions:
            if nxt is None:
                continue
            consumers[nxt] -= 1
            if consumers[nxt] == 0:
                if through:
                    ready.appendleft(nxt)
                else:
                    ready.append(nxt)
    return out


def backward(y, dy=None):
    """Reverse mode from Tensor ``y``; yields ``(param, grad)`` pairs, one
    per parameter Tensor ``y`` depends on, each ``grad`` a Tensor that is
    also left on ``param.grad``. ``dy`` seeds the output gradient (ones
    by default), e.g. a loss scale."""
    from .tensor import Tensor
    if y.data.grad_fn is None:
        raise RuntimeError(
            "backward needs an output computed from parameters in training "
            "mode (model.train(), outside torch.no_grad)")
    params = _param_leaves(y.data.grad_fn)
    if dy is None:
        seed = torch.ones_like(y.data)
    else:
        seed = (dy.data if isinstance(dy, Tensor) else
                torch.as_tensor(dy)).to(device=y.data.device,
                                        dtype=y.data.dtype)
        seed = seed.expand_as(y.data)
    grads = torch.autograd.grad(y.data, [p.data for p in params],
                                grad_outputs=seed)
    for p, g in zip(params, grads):
        gt = Tensor(data=g, device=p.device)
        p.grad = gt
        yield p, gt


def gradients(y, dy=None):
    """All ``(param, grad)`` pairs of :func:`backward` as a dict keyed by
    param."""
    return dict(backward(y, dy))
