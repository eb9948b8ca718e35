"""The functional ops of the SINGA API.

Counterpart of every public function of ``singa_tpu/autograd.py``
(``:832-1263``) and of its re-exports (``conv2d``, ``batchnorm_2d``,
``pooling_2d``, ``globalaveragepool``, ``backward``, ``gradients``,
``infer_dependency``, ``is_training``, ``set_training``). Each takes and
returns :class:`~.tensor.Tensor`s; torch autograd records the gradients of
an op that runs outside ``no_grad`` (:func:`~.autograd_base.backward`).
``autograd.training`` reads and sets the shared training flag
(``_AutogradModule``, ``:40-53``).

The JAX package differentiates each op's ``jax.numpy`` forward. The port
writes the same expressions in torch where the two frameworks' gradient
rules agree, and spells them so that they agree where they would not:

- ``abs`` is ``where(x >= 0, x, -x)``: JAX's gradient at 0 is 1, torch's
  ``abs`` gives 0;
- ``clip`` (and ``hardsigmoid``) is ``minimum(maximum(x, lo), hi)`` with
  tensor bounds: JAX's ``clip`` gives 0.5 at either bound, as
  ``torch.maximum``/``minimum`` do at a tie, where ``torch.clamp`` gives
  1; the elementwise ``max``/``min``, ``reduce_max`` and the ``minimum``
  inside ``elu``/``selu`` split ties 0.5/0.5 in both;
- ``round`` is half away from zero, ``trunc(x + sign(x) / 2)``;
  ``rounde`` is half to even (``torch.round``); their gradients, and
  ``ceil``'s, ``floor``'s and ``sign``'s, are 0.

One rule is left as torch has it: ``relu``'s gradient at exactly 0 is
torch's 0 where the JAX package's ``maximum(x, 0)`` gives 0.5, so that the
training path keeps saving only the ReLU's output (``maximum`` would save
its input too, one activation more per ReLU).

Results follow the JAX package's dtypes with 64-bit types off: the
comparisons and ``_and``/``_or``/``_xor``/``_not`` give f32; ``cast`` and
``astype`` to a 64-bit type give its 32-bit one; ``shape`` and
``nonzero`` give int32. numpy names keep numpy's meaning: ``pad``'s
"edge" is torch's "replicate"; ``gather`` and ``scatter_elements`` take
negative indices from the end. A JAX array is never a view, so the ops
that would hand out a strided view of their input (``split``, ``slice``,
``expand``, ``transpose``, ``depth_to_space``) return contiguous tensors.

``shape``, ``constant_of_shape`` and ``nonzero`` read values back to the
host (``nonzero`` and ``constant_of_shape`` have shapes that depend on
values); inside a step of graph mode (``graph.in_step``) or a CUDA-graph
capture they raise rather than synchronise.

:func:`checkpoint` (``singa_tpu/autograd.py:1315-1380``) rematerialises a
block in the backward through non-reentrant ``torch.utils.checkpoint``;
the random draws of its forward (``dropout``'s keep masks) are recorded
and handed to the recompute, as the JAX package hands the recompute the
forward's key, so the recompute drops what the forward dropped, eagerly
and inside a CUDA-graph capture alike (no generator state is read).

Not ported here (ROADMAP.md): ``rnn_op`` (``ops/rnn.py``, slice E)
raises; the CamelCase op classes of the JAX module wait for the ``sonnx``
slice (E): reading one raises :class:`OpClassNotPorted`.
"""

from __future__ import annotations

import builtins
import contextlib
import sys
import types

import numpy as np
import torch
import torch.nn.functional as F

from .autograd_base import (CTX, Dummy, Operator,  # noqa: F401
                            backward, gradients, infer_dependency,
                            is_training, set_training)
from .mixed_precision import accum_f32 as _f32a
from .mixed_precision import cast_compute as _cast_compute
from .tensor import Tensor, _torch_dtype
from .tensor import host_copy as _host_copy


class _AutogradModule(types.ModuleType):
    """``autograd.training = True`` sets the shared training flag that the
    ops and ``Model`` read."""

    @property
    def training(self):
        return CTX.training

    @training.setter
    def training(self, flag):
        CTX.training = bool(flag)


sys.modules[__name__].__class__ = _AutogradModule

# how many times a plain elementwise add actually ran
add_runs = 0


def _d(x, like=None):
    """The torch payload of ``x``: a Tensor's data, a torch tensor or a
    python number as it is, anything else (a numpy array, a list) as a
    tensor on ``like``'s device, 64-bit types as their 32-bit ones. (A
    number stays a number: a host tensor copied to the card cannot be part
    of a captured step.)"""
    if isinstance(x, Tensor):
        return x.data
    if isinstance(x, (torch.Tensor, int, float, bool)):
        return x
    arr = np.asarray(x)
    if arr.dtype in (np.float64, np.int64):
        arr = arr.astype(np.float32 if arr.dtype == np.float64 else np.int32)
    return torch.as_tensor(arr, device=like.device if like is not None
                           else None)


def _dev(*xs):
    return next(x.device for x in xs if isinstance(x, Tensor))


def _new(arr, *like):
    return Tensor(data=arr, device=_dev(*like))


def _zero(x):
    return x.new_zeros(())


def _x32(dtype):
    """``dtype`` with 64-bit types off (the JAX package's default)."""
    t = _torch_dtype(dtype)
    return {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.complex128: torch.complex64}.get(t, t)


def _host_read(what):
    """Refuse a read of device values back to the host inside a step of
    graph mode or a CUDA-graph capture."""
    from .graph import in_step
    if in_step() or (torch.cuda.is_available() and
                     torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            f"autograd.{what} reads values back to the host, which a "
            "captured step cannot do (graph mode replays without the "
            "host); call it outside the step, or compile with "
            "use_graph=False")


# ---- arithmetic -----------------------------------------------------------

def _plain_add(a, b):
    global add_runs
    add_runs += 1
    return a.data + _d(b, a.data)


def add(a, b):
    """``a + b``. A sum with a tagged inference-BN operand is returned
    lazy and tagged (``_bn_add_epilogue``): a consuming ReLU may fuse BN
    fold + add + ReLU into one pass, and then this add never runs. When
    both operands are tagged (a block with a downsample), the tail fuses
    around ``a``'s BN and ``b`` is the residual input, computed normally."""
    ta = getattr(a, "_bn_epilogue", None)
    tb = getattr(b, "_bn_epilogue", None)
    if ta is None and tb is None:
        return _new(_plain_add(a, b), a, b)
    out = Tensor.lazy(lambda: _plain_add(a, b),
                      torch.broadcast_shapes(a.shape, b.shape),
                      torch.promote_types(a.dtype, b.dtype), a.device)
    out._bn_add_epilogue = (ta, b) if ta is not None else (tb, a)
    return out


def sub(a, b):
    return _new(_d(a) - _d(b, _d(a)), a, b)


def mul(a, b):
    return _new(_d(a) * _d(b, _d(a)), a, b)


def div(a, b):
    return _new(_d(a) / _d(b, _d(a)), a, b)


def pow(a, b):  # noqa: A001
    return _new(_d(a) ** _d(b, _d(a)), a, b)


def negative(x):
    return _new(-x.data, x)


def reciprocal(x):
    return _new(1.0 / x.data, x)


def add_bias(x, b, axis=0):
    """``x + b`` with ``b`` broadcast along ``axis``, in the compute
    dtype."""
    xa, ba = _cast_compute(x.data, b.data)
    if axis == 0:
        y = xa + ba.reshape((1,) + tuple(ba.shape))
    else:
        y = xa + ba.reshape(tuple(ba.shape) + (1,) * (xa.dim() - 1 - axis))
    return Tensor(data=y, device=x.device)


def matmul(a, b):
    aa, ba = _cast_compute(a.data, b.data)
    return Tensor(data=torch.matmul(aa, ba), device=a.device)


def gemm(A, B, C=None, alpha=1.0, beta=1.0, transA=0, transB=0):
    """``alpha * A' @ B' + beta * C`` (ONNX Gemm; ``'`` a transpose when
    asked), in the compute dtype."""
    a, b, c = _cast_compute(A.data, B.data, C.data if C is not None
                           else None)
    y = alpha * ((a.T if transA else a) @ (b.T if transB else b))
    if c is not None:
        y = y + beta * c
    return _new(y, A)


def _nary(xs, fn):
    out = _d(xs[0])
    for x in xs[1:]:
        out = fn(out, _d(x, out))
    return out


def add_all(*xs):
    """Elementwise sum of the Tensors."""
    return _new(_nary(xs, torch.add), *xs)


def sum(*xs):  # noqa: A001 - the reference's N-ary elementwise sum
    return add_all(*xs)


def mean(*xs):
    """Elementwise mean of the Tensors."""
    return _new(_nary(xs, torch.add) / len(xs), *xs)


def max(*xs):  # noqa: A001
    """Elementwise maximum (a tie splits the gradient in half)."""
    return _new(_nary(xs, torch.maximum), *xs)


def min(*xs):  # noqa: A001
    """Elementwise minimum (a tie splits the gradient in half)."""
    return _new(_nary(xs, torch.minimum), *xs)


# ---- unary math -----------------------------------------------------------

def _unary(fn, doc=None):
    def op(x):
        return _new(fn(x.data), x)
    op.__doc__ = doc
    return op


def abs(x):  # noqa: A001
    """``|x|`` with the JAX package's gradient at 0 (1, not 0)."""
    xa = x.data
    return _new(torch.where(xa >= 0, xa, -xa), x)


exp = _unary(torch.exp)
log = _unary(torch.log)
sqrt = _unary(torch.sqrt)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
tanh = _unary(torch.tanh)
erf = _unary(torch.erf)
ceil = _unary(torch.ceil, "Round up; gradient 0.")
floor = _unary(torch.floor, "Round down; gradient 0.")
sign = _unary(torch.sign, "-1, 0 or 1; gradient 0.")
rounde = _unary(torch.round, "Round half to even; gradient 0.")


def round(x):  # noqa: A001
    """Round half away from zero, ``trunc(x + sign(x) * 0.5)``; gradient
    0."""
    xa = x.data
    return _new(torch.trunc(xa + torch.sign(xa) * 0.5), x)


def identity(x):
    return _new(x.data, x)


# ---- activations ----------------------------------------------------------

def relu(x):
    if getattr(x, "_bn_epilogue", None) is not None or \
            getattr(x, "_bn_add_epilogue", None) is not None:
        from .ops import fused_epilogue
        fused = fused_epilogue.try_relu_epilogue(x)
        if fused is not None:
            return fused
    return Tensor(data=torch.relu(x.data), device=x.device)


def leakyrelu(x, a=0.01):
    xa = x.data
    return _new(torch.where(xa >= 0, xa, a * xa), x)


def _elu_neg(xa, alpha):
    return alpha * (torch.exp(torch.minimum(xa, _zero(xa))) - 1)


def elu(x, alpha=1.0):
    xa = x.data
    return _new(torch.where(xa > 0, xa, _elu_neg(xa, alpha)), x)


def selu(x, alpha=1.67326, gamma=1.0507):
    xa = x.data
    return _new(gamma * torch.where(xa > 0, xa, _elu_neg(xa, alpha)), x)


def sigmoid(x):
    return _new(torch.sigmoid(x.data), x)


def softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``."""
    xa = x.data
    return _new(torch.logaddexp(xa, torch.zeros_like(xa)), x)


def softsign(x):
    return _new(x.data / (1 + abs(x).data), x)


def _clip(xa, lo, hi):
    """``minimum(maximum(xa, lo), hi)``, the bounds as 0-d tensors made on
    ``xa``'s device (a fill, not a copy from the host)."""
    if lo is not None:
        xa = torch.maximum(xa, torch.full((), lo, dtype=xa.dtype,
                                          device=xa.device))
    if hi is not None:
        xa = torch.minimum(xa, torch.full((), hi, dtype=xa.dtype,
                                          device=xa.device))
    return xa


def hardsigmoid(x, alpha=0.2, gamma=0.5):
    return _new(_clip(alpha * x.data + gamma, 0.0, 1.0), x)


def prelu(x, slope):
    xa = x.data
    return _new(torch.where(xa >= 0, xa, _d(slope, xa) * xa), x)


def softmax(x, axis=1):
    """Softmax over ``axis`` with the sum in f32; the input's dtype."""
    return _new(torch.softmax(_f32a(x.data), dim=axis).to(x.dtype), x)


def gelu(x):
    """GELU in its tanh approximation, the default of ``jax.nn.gelu``
    (PyTorch's default is the erf form)."""
    return Tensor(data=F.gelu(x.data, approximate="tanh"), device=x.device)


def lrn(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    """Across-channel local response normalisation of NCHW ``x``:
    ``x * (k + alpha / size * sum of x**2 over a window of size
    channels) ** -beta``, the window from ``size // 2`` channels before to
    ``size - 1 - size // 2`` after (``F.local_response_norm``'s
    convention)."""
    xa = x.data
    half = size // 2
    sq = F.pad(xa * xa, (0, 0, 0, 0, half, size - 1 - half))
    win = sq.unfold(1, size, 1).sum(-1)
    return _new(xa * torch.pow(k + alpha / size * win, -beta), x)


# ---- losses ---------------------------------------------------------------

def _target(t, like):
    ta = t.data if isinstance(t, Tensor) else torch.as_tensor(np.asarray(t))
    return ta.detach().to(like.device)


def softmax_cross_entropy(x, t):
    """Mean cross entropy of softmax(x) over the batch, in f32. ``t`` is
    one-hot rows of x's shape, or integer class ids."""
    xa = _f32a(x.data)
    ta = _target(t, xa)
    logp = torch.log_softmax(xa, dim=-1)
    if tuple(ta.shape) == tuple(xa.shape):
        ce = -torch.sum(_f32a(ta) * logp, dim=-1)
    else:
        ids = ta.reshape(ta.shape[0:1]) if ta.dim() > 1 else ta
        ce = -torch.gather(logp, -1, ids.long()[:, None])[:, 0]
    return Tensor(data=torch.mean(ce), device=x.device)


def cross_entropy(x, t):
    """``-sum(t * log(x + 1e-10)) / batch`` for probabilities ``x``, in
    f32."""
    xa = _f32a(x.data)
    ta = _f32a(_target(t, xa))
    return Tensor(data=-torch.sum(ta * torch.log(xa + 1e-10)) / xa.shape[0],
                  device=x.device)


def mse_loss(x, t):
    """``sum((x - t)**2) / (2 * batch)``, in f32."""
    xa = _f32a(x.data)
    ta = _f32a(_target(t, xa))
    return _new(torch.sum(torch.square(xa - ta)) / (2.0 * xa.shape[0]), x)


def binary_cross_entropy(x, t):
    """Mean over the batch of the summed ``-(t log x + (1 - t) log(1 -
    x))`` (1e-10 inside each log), in f32."""
    xa = _f32a(x.data)
    ta = _f32a(_target(t, xa))
    per = -(ta * torch.log(xa + 1e-10) + (1 - ta) * torch.log(1 - xa + 1e-10))
    return _new(torch.mean(torch.sum(per.reshape(per.shape[0], -1), -1)), x)


def ranking_loss(pos, neg, M=0.2):
    """``mean(max(M - (pos - neg), 0))``."""
    v = M - (pos.data - _d(neg, pos.data))
    return _new(torch.mean(torch.maximum(v, _zero(v))), pos)


# ---- reductions -----------------------------------------------------------

def _axes(x, axes):
    if axes is None:
        return tuple(range(x.dim()))
    return tuple(int(a) for a in axes)


def _reduce(fn, x, axes, keepdims):
    xa = x.data
    ax = _axes(xa, axes)
    if not ax:
        return _new(xa, x)
    return _new(fn(xa, dim=ax, keepdim=bool(keepdims)), x)


def reduce_sum(x, axes=None, keepdims=1):
    return _reduce(torch.sum, x, axes, keepdims)


def reduce_mean(x, axes=None, keepdims=1):
    return _reduce(torch.mean, x, axes, keepdims)


def reduce_max(x, axes=None, keepdims=1):
    """Max over ``axes``; tied maxima share the gradient evenly."""
    return _reduce(torch.amax, x, axes, keepdims)


def reduce_prod(x, axes=None, keepdims=1):
    xa = x.data
    ax = sorted({a % builtins.max(xa.dim(), 1) for a in _axes(xa, axes)},
                reverse=True)
    for a in ax:
        xa = torch.prod(xa, dim=a, keepdim=True)
    if not keepdims and ax:
        xa = xa.squeeze(tuple(ax))
    return _new(xa, x)


def clip(x, min=None, max=None):  # noqa: A002
    """``x`` clipped to ``[min, max]`` (either may be None); the gradient
    is 0.5 at either bound, as in the JAX package."""
    return _new(_clip(x.data, min, max), x)


# ---- comparisons and logic (f32 0/1) --------------------------------------

def _cmp(fn):
    def op(a, b):
        aa = _d(a)
        with torch.no_grad():
            return _new(fn(aa, _d(b, aa)).float(), a, b)
    return op


less = _cmp(torch.lt)
greater = _cmp(torch.gt)
equal = _cmp(torch.eq)
_and = _cmp(lambda a, b: torch.logical_and(a > 0, b > 0))
_or = _cmp(lambda a, b: torch.logical_or(a > 0, b > 0))
_xor = _cmp(lambda a, b: torch.logical_xor(a > 0, b > 0))


def _not(a):
    with torch.no_grad():
        return _new(torch.logical_not(a.data > 0).float(), a)


# ---- shape ops ------------------------------------------------------------

def reshape(x, shape):
    return Tensor(data=x.data.reshape(tuple(int(s) for s in shape)),
                  device=x.device)


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


def squeeze(x, axis=None):
    xa = x.data
    if axis is None:
        return _new(xa.squeeze(), x)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return _new(xa.squeeze(ax), x)


def unsqueeze(x, axis):
    xa = x.data
    for a in sorted(axis if isinstance(axis, (list, tuple)) else [axis]):
        xa = xa.unsqueeze(a)
    return _new(xa, x)


def cat(xs, axis=0):
    return _new(torch.cat([t.data for t in xs], dim=axis), *xs)


def split(x, axis, parts=None, num_output=None):
    """``x`` split along ``axis`` into pieces of sizes ``parts``, or into
    ``num_output`` equal pieces; each piece a contiguous tensor."""
    xa = x.data
    if parts is not None:
        pieces = torch.split(xa, [int(p) for p in parts], dim=axis)
    else:
        n = xa.shape[axis]
        if n % num_output:
            raise ValueError(f"split: {n} does not divide into "
                             f"{num_output} equal parts")
        pieces = torch.split(xa, n // num_output, dim=axis)
    return tuple(_new(p.contiguous(), x) for p in pieces)


def _slice_axis(xa, a, s, e, st):
    if st > 0:
        idx = [builtins.slice(None)] * xa.dim()
        idx[a] = builtins.slice(s, e, st)
        return xa[tuple(idx)]
    rows = range(*builtins.slice(s, e, st).indices(xa.shape[a]))
    return xa.index_select(a, torch.arange(rows.start, rows.stop, rows.step,
                                           device=xa.device))


def slice(x, starts, ends, axes=None, steps=None):  # noqa: A001
    """numpy slicing ``starts[i]:ends[i]:steps[i]`` along ``axes[i]`` (a
    negative step too); a contiguous tensor."""
    xa = x.data
    axes = list(axes) if axes is not None else list(range(len(starts)))
    steps = list(steps) if steps is not None else [1] * len(starts)
    for s, e, a, st in zip(starts, ends, axes, steps):
        xa = _slice_axis(xa, a, s, e, st)
    return _new(xa.contiguous(), x)


def make_slice(x, axis, idx):
    """Index ``idx`` along ``axis``, the axis kept."""
    return slice(x, [idx], [idx + 1], [axis])


def _index(indices, like):
    """Integer indices (a Tensor, float-encoded or not, or a list) as a
    long tensor on ``like``'s device."""
    idx = indices.data if isinstance(indices, Tensor) else \
        torch.as_tensor(np.asarray(indices))
    return idx.detach().to(device=like.device).long()


def gather(x, axis, indices):
    """``take(x, indices, axis)``: a negative index counts from the
    end."""
    xa = x.data
    idx = _index(indices, xa)
    n = xa.shape[axis]
    flat = torch.where(idx < 0, idx + n, idx).reshape(-1)
    y = xa.index_select(axis, flat)
    ax = axis % xa.dim()
    return _new(y.reshape(tuple(xa.shape[:ax]) + tuple(idx.shape)
                          + tuple(xa.shape[ax + 1:])), x)


def scatter_elements(x, indices, updates, axis=0):
    """ONNX ScatterElements: ``x`` with ``updates[p]`` written at ``p``
    with its ``axis`` coordinate replaced by ``indices[p]`` (negative from
    the end)."""
    xa = x.data
    idx = _index(indices, xa)
    idx = torch.where(idx < 0, idx + xa.shape[axis], idx)
    return _new(xa.scatter(axis, idx, _d(updates, xa).to(xa.dtype)), x)


def tile(x, repeats):
    reps = tuple(repeats) if isinstance(repeats, (list, tuple)) \
        else (int(repeats),)
    return _new(torch.tile(x.data, reps), x)


def expand(x, shape):
    """``x`` broadcast to ``broadcast(x.shape, shape)``, materialised."""
    xa = x.data
    out = torch.broadcast_shapes(tuple(xa.shape), tuple(int(s)
                                                        for s in shape))
    return _new(xa.expand(out).contiguous(), x)


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def pad(x, mode, pads, constant=0.0):
    """ONNX Pad: ``pads`` is ``[begin_0, ..., begin_n, end_0, ...,
    end_n]``; ``mode`` "constant" (with ``constant``), "reflect" (numpy's:
    the edge element not repeated) or "edge" (the edge element
    repeated)."""
    xa = x.data
    n = xa.dim()
    width = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if mode == "constant":
        flat = [v for b, e in reversed(width) for v in (b, e)]
        return _new(F.pad(xa, flat, value=constant), x)
    if mode not in ("reflect", "edge"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for a, (b, e) in enumerate(width):
        if b or e:
            xa = xa.index_select(a, _pad_index(xa.shape[a], b, e, mode,
                                               xa.device))
    return _new(xa, x)


def upsample(x, mode="nearest", scales=None):
    """Nearest-neighbour upsampling by an integer scale per axis."""
    if mode.lower() != "nearest":
        raise ValueError(f"upsample mode {mode!r}: only 'nearest'")
    xa = x.data
    for axis, s in enumerate(scales):
        if int(s) != 1:
            xa = torch.repeat_interleave(xa, int(s), dim=axis)
    return _new(xa, x)


def depth_to_space(x, blocksize, mode="DCR"):
    """NCHW depth to space, ``mode`` "DCR" (depth, column, row) or
    "CRD"."""
    N, C, H, W = x.shape
    b = blocksize
    if mode == "DCR":
        y = x.data.reshape(N, b, b, C // (b * b), H, W) \
            .permute(0, 3, 4, 1, 5, 2)
    else:
        y = x.data.reshape(N, C // (b * b), b, b, H, W) \
            .permute(0, 1, 4, 2, 5, 3)
    return _new(y.reshape(N, C // (b * b), H * b, W * b), x)


def space_to_depth(x, blocksize):
    N, C, H, W = x.shape
    b = blocksize
    y = x.data.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return _new(y.reshape(N, C * b * b, H // b, W // b), x)


# ---- indexing and generation ----------------------------------------------

def where(cond, a, b):
    """``a`` where ``cond > 0``, else ``b`` (no gradient to ``cond``)."""
    aa = _d(a)
    c = _d(cond, aa).detach() > 0
    return _new(torch.where(c, aa, _d(b, aa)), a, b, cond)


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
    return Tensor(data=_cast_compute(F.embedding(ids, W.data)),
                  device=x.device)


def cossim(a, b):
    """Cosine similarity over the last axis (1e-12 added to the norms'
    product)."""
    aa, ba = a.data, _d(b, a.data)
    num = torch.sum(aa * ba, dim=-1)
    den = torch.linalg.vector_norm(aa, dim=-1) * \
        torch.linalg.vector_norm(ba, dim=-1)
    return _new(num / (den + 1e-12), a, b)


def shape(x):
    """``x``'s shape as an int32 tensor on its device."""
    _host_read("shape")
    return _new(torch.tensor(tuple(x.shape), dtype=torch.int32,
                             device=x.device.torch_device), x)


def constant_of_shape(x, value=0.0):
    """An f32 tensor of the shape that ``x``'s values give, filled with
    ``value``."""
    _host_read("constant_of_shape")
    dims = tuple(int(v) for v in x.data.detach().cpu().reshape(-1))
    return _new(torch.full(dims, float(value), dtype=torch.float32,
                           device=x.device.torch_device), x)


def nonzero(x):
    """The indices of ``x``'s nonzero elements, one row per axis
    (int32)."""
    _host_read("nonzero")
    return _new(torch.nonzero(x.data.detach()).T.contiguous()
                .to(torch.int32), x)


def cast(x, to):
    """``x`` in dtype ``to`` (64-bit as 32-bit); not differentiable
    (:func:`astype` is)."""
    with torch.no_grad():
        return _new(x.data.to(_x32(to)), x)


def astype(x, to):
    """Differentiable dtype cast, the mixed-precision boundary: the
    gradient is cast back to x's dtype (64-bit as 32-bit)."""
    return Tensor(data=x.data.to(_x32(to)), device=x.device)


def layernorm(x, scale, bias, eps=1e-5):
    """Normalise over the trailing dim, then scale and shift: statistics
    in f32 (biased variance), output in x's dtype."""
    xf = _f32a(x.data)
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
    shp, rows = tuple(x.shape), builtins.slice(None)
    if step is not None and step.world > 1:
        n = shp[0]
        shp = (n * step.world,) + shp[1:]
        rows = builtins.slice(step.rank * n, (step.rank + 1) * n)
    tape = _REMAT[-1] if _REMAT else None
    if tape is not None and tape.replaying:
        u = tape.draws[tape.next_draw]
        tape.next_draw += 1
    else:
        u = torch.rand(shp, generator=x.device.generator,
                       dtype=torch.float32,
                       device=x.device.torch_device)[rows]
        if tape is not None:
            tape.draws.append(u)
    return Tensor(data=torch.where(u < keep, x.data / keep, 0.0),
                  device=x.device)


# ---- helpers --------------------------------------------------------------

def axis_helper(y_shape, x_shape):
    """The axes along which ``x_shape`` was broadcast to ``y_shape``."""
    res = []
    j = len(x_shape) - 1
    for i in range(len(y_shape) - 1, -1, -1):
        if j < 0 or x_shape[j] != y_shape[i]:
            res.append(i)
        j -= 1
    return tuple(res[::-1])


def back_broadcast(y_shape, x_shape, x):
    """A broadcast result (a cotangent) summed back to ``x_shape``: a
    Tensor for a Tensor, a torch tensor for anything else."""
    if tuple(y_shape) == tuple(x_shape):
        return x
    arr = x.data if isinstance(x, Tensor) else torch.as_tensor(x)
    ax = axis_helper(y_shape, x_shape)
    if ax:
        arr = torch.sum(arr, dim=ax)
    arr = arr.reshape(tuple(x_shape))
    if isinstance(x, Tensor):
        return Tensor(data=arr, device=x.device,
                      requires_grad=x.requires_grad)
    return arr


def ctensor2numpy(x):
    """A host numpy copy of a Tensor or torch tensor."""
    return _host_copy(x.data if isinstance(x, Tensor) else x)


# the JAX module's CamelCase op classes (``Add``, ``ReLU``, ...): no caller
# of the JAX package uses them outside its ``autograd.py`` (``sonnx.py``
# calls the functions), so they wait for the ``sonnx`` slice
_OP_CLASSES = frozenset("""
    Abs Acos Acosh Add AddBias And AsType Asin Asinh Atan Atanh
    BinaryCrossEntropy Cast Ceil Clip Concat ConstantOfShape Cos CosSim Cosh
    CrossEntropy DepthToSpace Div Dropout Elu Embedding Equal Erf Exp Expand
    Flatten Floor GELU Gather Gemm Greater HardSigmoid Identity LRN LeakyRelu
    Less Log Matmul Max Mean MeanSquareError Min Mul Negative NonZero Not
    OneHot Or PRelu Pad Pow RankingLoss ReLU Reciprocal ReduceMax ReduceMean
    ReduceProd ReduceSum Reshape Round Rounde ScatterElements SeLU Shape
    Sigmoid Sign Sin Sinh Slice SoftMax SoftMaxCrossEntropy SoftPlus SoftSign
    SpaceToDepth Split Sqrt Squeeze Sub Sum Tan Tanh Tile Transpose Unsqueeze
    UpSample Where Xor""".split())


class OpClassNotPorted(NotImplementedError, AttributeError):
    """An op class of the JAX module that is not ported (``hasattr`` is
    False for it)."""


def __getattr__(name):
    if name in _OP_CLASSES:
        raise OpClassNotPorted(
            f"autograd.{name}: the op classes are not ported yet (ROADMAP.md:"
            f" slice E, with sonnx); call the function instead "
            f"(autograd.{name.lower()} and its kin)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class _RematDraws:
    """The random draws of one rematerialised forward, in order: recorded
    while the forward runs, handed back one by one while the backward
    recomputes it."""

    def __init__(self):
        self.draws = []
        self.replaying = False
        self.next_draw = 0

    @contextlib.contextmanager
    def _scope(self, replaying):
        self.replaying, self.next_draw = replaying, 0
        _REMAT.append(self)
        try:
            yield
        finally:
            _REMAT.pop()

    def contexts(self):
        return self._scope(False), self._scope(True)


_REMAT: list = []


def checkpoint(block, x):
    """``block(x)`` (a Layer on a Tensor) with a rematerialised backward:
    numerically ``block(x)``, but only the block's input is kept for the
    backward, which reruns the block's forward (kernel K3 included) to
    rebuild what it needs (``jax.checkpoint``). The first call runs
    un-checkpointed so that the block's parameters materialise; a block
    holding non-parameter state (BatchNorm's running statistics, which a
    recompute would update twice) raises ``ValueError``; the block must
    return one Tensor. A dropout inside the block keeps its masks: the
    recompute reads the forward's draws. A sublayer's ``aux_loss`` (the
    MoE load-balance term) read before the backward is the forward's: a
    loss built from it reaches the router's weights through the
    checkpoint (the backward's recompute sets the attribute again, to the
    same value)."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    from .layer import Layer
    if not isinstance(block, Layer):
        raise TypeError("checkpoint() wraps a Layer; for plain functions "
                        "use torch.utils.checkpoint directly")
    if not block._initialized:
        return block(x)
    params = block.get_params()
    if len(block.get_states()) != len(params):
        raise ValueError(
            "checkpoint() cannot wrap blocks holding non-parameter state "
            "(e.g. BatchNorm running stats); use normalization without "
            "running statistics (LayerNorm) inside checkpointed blocks")

    def run(x_arr):
        out = block(Tensor(data=x_arr, device=x.device))
        if not isinstance(out, Tensor):
            raise TypeError(
                "checkpoint() supports single-Tensor-output blocks; "
                f"{type(block).__name__}.forward returned "
                f"{type(out).__name__}")
        return out.data

    draws = _RematDraws()
    y = torch_checkpoint(run, x.data, use_reentrant=False,
                         preserve_rng_state=False,
                         context_fn=draws.contexts)
    return Tensor(data=y, device=x.device)


def rnn_op(*args, **kwargs):
    raise NotImplementedError(
        "autograd.rnn_op (ops/rnn.py) is not ported yet (ROADMAP.md: "
        "slice E, with char_rnn)")


# ---- conv / BN / pooling live in ops; re-exported as the JAX module does
from .ops.conv import (ConvHandle, ConvTransposeHandle,  # noqa: E402,F401
                       conv2d, conv_transpose2d)
from .ops.batchnorm import BatchNormHandle, batchnorm_2d  # noqa: E402,F401
from .ops.pooling import (PoolingHandle, pooling_2d,  # noqa: E402,F401
                          globalaveragepool, GlobalAveragePool)
