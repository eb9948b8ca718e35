"""Global autograd mode flags and reverse mode over torch autograd.

Counterpart of ``singa_tpu/autograd_base.py:29-49`` (the ``CTX`` training
flag and :func:`is_training`) and ``:217-262`` (:func:`backward`,
:func:`gradients`). The JAX package records its own tape of
``Operator``s; the port lets torch autograd record the graph of the
forward and walks it: :func:`backward` finds the parameter leaves the
output depends on (the Tensors made with ``stores_grad``) and computes
their gradients with one ``torch.autograd.grad``. There is no ``Operator``
class: an op with a custom gradient is a ``torch.autograd.Function``
(flash attention, ``ops/attention.py``; the fused CE head,
``ops/losses.py``).

The serving path runs under ``torch.inference_mode()`` and records
nothing.
"""

from __future__ import annotations

import weakref
from collections import deque

import torch


class _Context:
    def __init__(self):
        self.training = False


CTX = _Context()


def is_training() -> bool:
    return CTX.training


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
