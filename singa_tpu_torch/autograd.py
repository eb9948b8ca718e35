"""Functional ops of the serving path.

Counterpart of the serving subset of ``singa_tpu/autograd.py``: ``relu``
(with the epilogue peephole, ``autograd.py:984-995``), ``add`` (with the
residual tag, ``autograd.py:832-847``), ``transpose``, ``flatten``,
``matmul`` and ``add_bias``. Each takes and returns :class:`~.tensor.Tensor`s.
The tape arrives with the training slice of the port.
"""

from __future__ import annotations

import torch

from .mixed_precision import cast_compute
from .tensor import Tensor

# how many times a plain elementwise add actually ran
add_runs = 0


def _plain_add(a, b):
    global add_runs
    add_runs += 1
    return a.data + b.data


def add(a, b):
    """``a + b``. A sum with a tagged inference-BN operand is returned
    lazy and tagged (``_bn_add_epilogue``): a consuming ReLU may fuse BN
    fold + add + ReLU into one pass, and then this add never runs. When
    both operands are tagged (a block with a downsample), the tail fuses
    around ``a``'s BN and ``b`` is the residual input, computed normally."""
    ta = getattr(a, "_bn_epilogue", None)
    tb = getattr(b, "_bn_epilogue", None)
    if ta is None and tb is None:
        return Tensor(data=_plain_add(a, b), device=a.device)
    out = Tensor.lazy(lambda: _plain_add(a, b),
                      torch.broadcast_shapes(a.shape, b.shape),
                      torch.promote_types(a.dtype, b.dtype), a.device)
    out._bn_add_epilogue = (ta, b) if ta is not None else (tb, a)
    return out


def relu(x):
    if getattr(x, "_bn_epilogue", None) is not None or \
            getattr(x, "_bn_add_epilogue", None) is not None:
        from .ops import fused_epilogue
        fused = fused_epilogue.try_relu_epilogue(x)
        if fused is not None:
            return fused
    return Tensor(data=torch.relu(x.data), device=x.device)


def add_bias(x, b, axis=0):
    """``x + b`` with ``b`` broadcast along ``axis``, in the compute
    dtype."""
    xa, ba = cast_compute(x.data, b.data)
    if axis == 0:
        y = xa + ba.reshape((1,) + tuple(ba.shape))
    else:
        y = xa + ba.reshape(tuple(ba.shape) + (1,) * (xa.dim() - 1 - axis))
    return Tensor(data=y, device=x.device)


def matmul(a, b):
    aa, ba = cast_compute(a.data, b.data)
    return Tensor(data=torch.matmul(aa, ba), device=a.device)


def flatten(x, axis=1):
    lead = 1
    for d in x.shape[:axis]:
        lead *= d
    return Tensor(data=x.data.reshape(lead, -1), device=x.device)


def transpose(x, shape=None):
    """Permute axes (reverse them when ``shape`` is None) and make the
    result contiguous in the new order."""
    perm = tuple(shape) if shape is not None else \
        tuple(reversed(range(x.ndim)))
    return Tensor(data=x.data.permute(perm).contiguous(), device=x.device)
