"""Functional ops of the CNN and Transformer LM paths.

Counterpart of the CNN and LM subset of ``singa_tpu/autograd.py``: ``relu``
(with the epilogue peephole, ``autograd.py:984-995``), ``add`` (with the
residual tag, ``autograd.py:832-847``), ``transpose``, ``flatten``,
``matmul``, ``add_bias``, the losses ``softmax_cross_entropy`` and
``cross_entropy`` (``autograd.py:333-364``), and for the LM ``gelu``
(``GELU`` ``:297``), ``reshape`` (``Reshape`` ``:496``), ``onehot``
(``OneHot`` ``:698``), ``embedding`` (``Embedding`` ``:714``), ``astype``
(``AsType`` ``:778``) and ``layernorm`` (``_LayerNorm`` ``:793``), and
``dropout`` (``Dropout`` ``:814``). Each takes and returns
:class:`~.tensor.Tensor`s. Torch autograd records their gradients when
they run outside ``no_grad`` (:func:`~.autograd_base.backward`); the
peephole declines in training, so a training forward never makes a lazy
tensor.
"""

from __future__ import annotations

import torch

from .autograd_base import is_training
from .mixed_precision import accum_f32, cast_compute
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


def softmax_cross_entropy(x, t):
    """Mean cross entropy of softmax(x) over the batch, in f32. ``t`` is
    one-hot rows of x's shape, or integer class ids."""
    xa = accum_f32(x.data)
    ta = t.data if isinstance(t, Tensor) else torch.as_tensor(t)
    ta = ta.detach().to(xa.device)
    logp = torch.log_softmax(xa, dim=-1)
    if tuple(ta.shape) == tuple(xa.shape):
        ce = -torch.sum(accum_f32(ta) * logp, dim=-1)
    else:
        ids = ta.reshape(ta.shape[0:1]) if ta.dim() > 1 else ta
        ce = -torch.gather(logp, -1, ids.long()[:, None])[:, 0]
    return Tensor(data=torch.mean(ce), device=x.device)


def cross_entropy(x, t):
    """``-sum(t * log(x + 1e-10)) / batch`` for probabilities ``x``, in
    f32."""
    xa = accum_f32(x.data)
    ta = t.data if isinstance(t, Tensor) else torch.as_tensor(t)
    ta = accum_f32(ta.detach().to(xa.device))
    return Tensor(data=-torch.sum(ta * torch.log(xa + 1e-10)) / xa.shape[0],
                  device=x.device)


def gelu(x):
    """GELU in its tanh approximation, the default of ``jax.nn.gelu``
    (PyTorch's default is the erf form)."""
    return Tensor(data=torch.nn.functional.gelu(x.data, approximate="tanh"),
                  device=x.device)


def reshape(x, shape):
    return Tensor(data=x.data.reshape(tuple(int(s) for s in shape)),
                  device=x.device)


def onehot(axis, indices, depth, values=(0.0, 1.0)):
    """One-hot f32 rows of the (float-encoded) integer ``indices`` along
    ``axis``: ``on`` at the index, ``off`` elsewhere, all ``off`` for an
    index outside ``[0, depth)``, as ``jax.nn.one_hot`` gives. Not
    differentiable."""
    off, on = values
    idx = indices.data.detach().long()
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)) \
        .to(torch.float32)
    if axis not in (-1, idx.dim()):
        oh = torch.movedim(oh, -1, axis)
    return Tensor(data=oh * (on - off) + off, device=indices.device)


def embedding(x, W):
    """Rows of ``W`` at the (float-encoded) ids ``x``, which are cast to
    integers and never differentiated; the policy cast applies to the
    gathered rows, not to the table."""
    ids = x.data.detach().long()
    return Tensor(data=cast_compute(torch.nn.functional.embedding(ids,
                                                                  W.data)),
                  device=x.device)


def astype(x, to):
    """Differentiable dtype cast, the mixed-precision boundary: the
    gradient is cast back to x's dtype."""
    from .tensor import _torch_dtype
    return Tensor(data=x.data.to(_torch_dtype(to)), device=x.device)


def layernorm(x, scale, bias, eps=1e-5):
    """Normalise over the trailing dim, then scale and shift: statistics
    in f32 (biased variance), output in x's dtype."""
    xf = accum_f32(x.data)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.data + bias.data
    return Tensor(data=y.to(x.dtype), device=x.device)


def dropout(x, ratio=0.5):
    """Inverted dropout: the identity outside training and at ``ratio``
    0; in training each element is kept with probability ``1 - ratio``
    and scaled by ``1 / (1 - ratio)``, the rest set to 0, so the gradient
    is ``mask / (1 - ratio)``. The keep mask is ``U[0, 1) < 1 - ratio``
    drawn from ``x``'s device generator (never torch's global one), which
    a captured step registers, so each replay draws a fresh mask. In the
    train step of a model compiled with a mesh (``parallel.gspmd``) each
    rank draws the mask of the global batch (its ranks' rows in rank
    order; the ranks' generators seeded alike) and keeps its own rows, as
    the JAX package draws one global-batch mask from one shared key: the
    ranks then drop what one rank on the whole batch would."""
    from .parallel.gspmd import active_step
    if not is_training() or ratio <= 0.0:
        return x
    keep = 1.0 - ratio
    step = active_step()
    shape, rows = tuple(x.shape), slice(None)
    if step is not None and step.world > 1:
        n = shape[0]
        shape = (n * step.world,) + shape[1:]
        rows = slice(step.rank * n, (step.rank + 1) * n)
    u = torch.rand(shape, generator=x.device.generator, dtype=torch.float32,
                   device=x.device.torch_device)[rows]
    return Tensor(data=torch.where(u < keep, x.data / keep, 0.0),
                  device=x.device)
