"""Tensor: a ``torch.Tensor`` with a :class:`~.device.Device` and the
fused-epilogue tags.

Counterpart of ``singa_tpu/tensor.py``: construction, metadata, dtype
casts, numpy in and out, in-place refills, ``grad``, the arithmetic and
comparison operators (``:231-298``), the shape methods (``:199-229``),
the norms (``:308-316``) and the module functions (``:350-637``). The JAX
payload is a ``jax.Array``; here it is a ``torch.Tensor`` on the tensor's
device. A parameter's payload is a torch leaf that requires grad
(``autograd_base.register_param``); the refills (``copy_from_numpy``,
``copy_from``, ``gaussian``, ``set_value``) write into it in place under
``no_grad``, so it stays the same leaf, and
:func:`~.autograd_base.backward` leaves its gradient on ``grad``.

The in-place operators (``+=``, ``-=``, ``*=``, ``/=``) and the module
functions with an output argument write into the tensor's storage when the
result keeps its shape and dtype (a captured step replays the write), and
rebind ``data`` only when it does not. A JAX array is never a view of
another, so the methods that return a new tensor (``reshape``,
``transpose``, ``__getitem__``, ``clone``, ...) hand out storage of their
own: an in-place write to one never shows in another, as in the JAX
package.

A tensor may be *lazy*: ``ops/batchnorm.py`` and ``autograd.add`` return
their outputs with a thunk instead of a value, plus the tag the ReLU
epilogue peephole reads (``_bn_epilogue`` / ``_bn_add_epilogue``). The
thunk runs the first time ``.data`` is read. When the fusing ReLU is the
only consumer it never reads ``.data``, so the bypassed BN and add never
run -- the eager counterpart of XLA removing them as dead code under the
JAX package's jit.

Random fills draw from the tensor's device generator (``torch.Generator``,
seeded by ``Device.SetRandSeed``), so one seed gives one draw; the JAX
package draws from ``jax.random``, so the two packages' draws differ.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from . import device as device_mod

__all__ = [
    "Tensor", "float16", "bfloat16", "float32", "float64", "int32",
    "int64", "int8", "uint8", "from_numpy", "to_numpy", "to_host",
    "from_raw_tensor", "from_raw_tensors", "dtype_name",
    "zeros_like", "ones_like", "zeros", "ones", "random", "product",
    "sizeof", "reshape", "transpose", "contiguous", "copy_data_to_from",
    "abs", "exp", "ceil", "log", "sigmoid", "sign", "sqrt", "square",
    "tanh", "relu", "sum", "pow", "average", "softmax", "lt", "le", "gt",
    "ge", "eq", "add", "sub", "eltwise_mult", "mult", "div", "axpy",
    "einsum", "repeat", "tensordot", "bernoulli", "gaussian", "uniform",
    "add_column", "add_row", "sum_columns", "sum_rows", "copy_from_numpy",
    "concatenate", "to_host_array", "to_host_tree", "host_copy",
]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int32 = torch.int32
int64 = torch.int64
int8 = torch.int8
uint8 = torch.uint8


def dtype_name(dtype) -> str:
    """numpy-style dtype name (``"float32"``, ``"bfloat16"``) -- the
    spelling the ``save_states`` archive records."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype_name(np.dtype(dtype)) if not isinstance(dtype, str) \
        else dtype
    return getattr(torch, name)


def _raw(x, like=None):
    """A Tensor's payload; a numpy array or list on ``like``'s device (a
    torch tensor, or a Tensor); anything else (python scalars, torch
    tensors) as it is."""
    if isinstance(x, Tensor):
        return x.data
    if isinstance(x, (np.ndarray, list, tuple)):
        dev = like.device if isinstance(like, torch.Tensor) else \
            like.device.torch_device if isinstance(like, Tensor) else None
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.as_tensor(arr, device=dev)
    return x


def _shares_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _own(r, src):
    """``r`` in storage of its own (a copy when it is a view of ``src``):
    what a new JAX array is."""
    if isinstance(r, torch.Tensor) and r.numel() and \
            _shares_storage(r, src):
        return r.clone(memory_format=torch.contiguous_format)
    return r


class Tensor:
    """nd-array with device placement and dtype."""

    creator = None      # the autograd_base.Operator that made it, if any

    def __init__(self, shape=(), device=None, dtype=None, data=None,
                 requires_grad=False, stores_grad=False, name=None):
        if device is None:
            device = device_mod.get_default_device()
        self.device = device
        dtype = _torch_dtype(dtype)
        if data is None:
            data = torch.zeros(tuple(shape), dtype=dtype or torch.float32,
                               device=device.torch_device)
        elif isinstance(data, Tensor):
            data = data.data
        if not isinstance(data, torch.Tensor) or \
                data.device != device.torch_device:
            data = device.put(data)
        if dtype is not None and data.dtype != dtype:
            data = data.to(dtype)
        self._data = data
        self._thunk = None
        self.requires_grad = requires_grad
        self.stores_grad = stores_grad
        self.name = name
        self.grad = None
        # (dim, full shape) of a shard (parallel.gspmd: ZeRO/FSDP, or the
        # tensor-parallel layout its spec announces)
        self.sharding = None
        # the layout a tensor-parallel layer announces (a PartitionSpec)
        self.spec = None

    @classmethod
    def lazy(cls, thunk, shape, dtype, device):
        """A tensor whose value ``thunk()`` computes on first read, in the
        grad mode of the time it was made."""
        t = cls.__new__(cls)
        t._data = None
        grad = torch.is_grad_enabled()

        def run():
            with torch.set_grad_enabled(grad):
                return thunk()
        t._thunk = run
        t._meta = (tuple(shape), dtype)
        t.device = device
        t.requires_grad = False
        t.stores_grad = False
        t.name = None
        t.grad = None
        t.sharding = None
        t.spec = None
        return t

    @property
    def data(self) -> torch.Tensor:
        if self._thunk is not None:
            self._data = self._thunk()
            self._thunk = None
        return self._data

    @data.setter
    def data(self, value):
        self._data = value
        self._thunk = None

    # ---- metadata -------------------------------------------------------
    @property
    def shape(self):
        if self._thunk is not None:
            return self._meta[0]
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        if self._thunk is not None:
            return self._meta[1]
        return self._data.dtype

    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def memsize(self):
        return self.size() * self.data.element_size()

    def is_empty(self):
        return self.size() == 0

    def is_transpose(self):
        """Always False: no method hands out a strided view."""
        return False

    def ndim_(self):
        return self.ndim

    # ---- placement / conversion ----------------------------------------
    def to_device(self, device):
        self.device = device
        self.data = device.put(self.data)
        return self

    def to_host(self):
        return self.to_device(device_mod.host_device())

    def as_type(self, dtype):
        return Tensor(data=_own(self.data.to(_torch_dtype(dtype)),
                                self.data),
                      device=self.device, requires_grad=self.requires_grad)

    def astype(self, dtype):
        return self.as_type(dtype)

    def to_numpy(self) -> np.ndarray:
        """Host copy (:func:`host_copy`). numpy has no bfloat16, so a
        bf16 tensor comes back as float32 (lossless)."""
        return host_copy(self.data)

    def numpy(self) -> np.ndarray:
        return self.to_numpy()

    def tolist(self):
        return self.to_numpy().tolist()

    def item(self):
        return self.to_numpy().item()

    # ---- mutation (in place) --------------------------------------------
    def copy_from_numpy(self, np_array, offset=0):
        """Refill in place from a host array of the same element count,
        cast to this tensor's dtype."""
        if offset != 0:
            raise ValueError("copy_from_numpy: offset copy not supported")
        arr = np.ascontiguousarray(np_array)
        if arr.size != self.size():
            raise ValueError(f"copy_from_numpy: {arr.shape} does not fit "
                             f"{self.shape}")
        src = torch.from_numpy(arr.reshape(self.shape))
        with torch.no_grad():
            self.data.copy_(src.to(self.dtype))
        return self

    def copy_data(self, other):
        """Refill in place from ``other`` (a Tensor or torch tensor of the
        same element count), cast to this tensor's dtype."""
        src = _raw(other, self)
        with torch.no_grad():
            self.data.copy_(torch.as_tensor(src).reshape(self.shape)
                            .to(self.dtype))
        return self

    def copy_from(self, other):
        if isinstance(other, np.ndarray):
            return self.copy_from_numpy(other)
        return self.copy_data(other)

    def reset_like(self, other):
        """Zeros of ``other``'s shape and dtype, on this tensor's
        device."""
        self.data = torch.zeros(tuple(other.shape), dtype=other.dtype,
                                device=self.device.torch_device)
        return self

    def set_value(self, x):
        with torch.no_grad():
            self.data.fill_(x)
        return self

    # ---- random fills (the device generator, or the one passed) ----------
    def _draw(self, fn, generator):
        g = generator if generator is not None else self.device.generator
        return fn(self.shape, generator=g, dtype=torch.float32,
                  device=self.device.torch_device)

    def gaussian(self, mean=0.0, std=1.0, generator=None):
        """Refill from N(mean, std) drawn in f32."""
        r = self._draw(torch.randn, generator)
        with torch.no_grad():
            self.data.copy_(r * std + mean)
        return self

    def uniform(self, low=0.0, high=1.0, generator=None):
        """Refill from U(low, high) drawn in f32."""
        r = self._draw(torch.rand, generator)
        with torch.no_grad():
            self.data.copy_(r * (high - low) + low)
        return self

    def bernoulli(self, p, generator=None):
        """Refill with 1 where a U[0, 1) draw is below ``p``, else 0."""
        r = self._draw(torch.rand, generator)
        with torch.no_grad():
            self.data.copy_((r < p).to(self.dtype))
        return self

    # ---- shape ops (each a tensor of its own) -----------------------------
    def _new(self, arr):
        return _wrap(_own(arr, self.data), self)

    def reshape(self, shape):
        return self._new(self.data.reshape(tuple(shape)))

    def T(self):  # noqa: N802 - the reference API (tensor.h Tensor::T)
        return self.transpose()

    def transpose(self, axes=None):
        """numpy's transpose: every axis reversed, or permuted by
        ``axes``."""
        perm = tuple(axes) if axes is not None else \
            tuple(reversed(range(self.ndim)))
        return self._new(self.data.permute(perm))

    def flatten(self):
        return self.reshape((self.size(),))

    def repeat(self, repeats, axis):
        """numpy's ``repeat``: each element ``repeats`` times along
        ``axis`` (None: over the flattened tensor), not torch's tiling
        ``Tensor.repeat``."""
        return _wrap(_repeat(self.data, repeats, axis), self)

    def clone(self):
        t = _wrap(self.data.clone(), self)
        t.stores_grad = self.stores_grad
        t.name = self.name
        return t

    def deepcopy(self):
        return self.clone()

    # ---- arithmetic and comparisons (new tensors) ---------------------------
    def __add__(self, o):
        return _wrap(self.data + _raw(o, self), self)

    __radd__ = __add__

    def __sub__(self, o):
        return _wrap(self.data - _raw(o, self), self)

    def __rsub__(self, o):
        return _wrap(_raw(o, self) - self.data, self)

    def __mul__(self, o):
        return _wrap(self.data * _raw(o, self), self)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _wrap(self.data / _raw(o, self), self)

    def __rtruediv__(self, o):
        return _wrap(_raw(o, self) / self.data, self)

    __div__ = __truediv__

    def __neg__(self):
        return _wrap(-self.data, self)

    def __pow__(self, o):
        return _wrap(self.data ** _raw(o, self), self)

    def __matmul__(self, o):
        return _wrap(self.data @ _raw(o, self), self)

    def __lt__(self, o):
        return _wrap((self.data < _raw(o, self)).float(), self)

    def __le__(self, o):
        return _wrap((self.data <= _raw(o, self)).float(), self)

    def __gt__(self, o):
        return _wrap((self.data > _raw(o, self)).float(), self)

    def __ge__(self, o):
        return _wrap((self.data >= _raw(o, self)).float(), self)

    # ---- in place (written into the storage) -------------------------------
    def _inplace(self, r):
        """Take the value ``r``: copied into this tensor's storage when it
        has the same shape and dtype (a parameter stays its leaf), else
        rebound."""
        if tuple(r.shape) == self.shape and r.dtype == self.dtype:
            with torch.no_grad():
                self.data.copy_(r)
        else:
            self.data = r
        return self

    def __iadd__(self, o):
        return self._inplace(self.data + _raw(o, self))

    def __isub__(self, o):
        return self._inplace(self.data - _raw(o, self))

    def __imul__(self, o):
        return self._inplace(self.data * _raw(o, self))

    def __itruediv__(self, o):
        return self._inplace(self.data / _raw(o, self))

    def __getitem__(self, keys):
        if isinstance(keys, Tensor):
            keys = keys.data
        return self._new(self.data[keys])

    def __len__(self):
        return self.shape[0] if self.shape else 0

    # ---- norms (the reference's, over the element count) -------------------
    def l2(self):
        """``sqrt(sum(x * x)) / size`` (reference ``tensor.cc:833-843``)."""
        x = self.data.detach().float()
        return float(torch.sqrt(torch.sum(x * x)) / builtins.max(
            1, self.size()))

    def l1(self):
        """``sum(|x|) / size`` (reference ``tensor.cc:815-827``)."""
        x = self.data.detach().float()
        return float(torch.sum(torch.abs(x)) / builtins.max(1, self.size()))

    def __repr__(self):
        lazy = " lazy" if self._thunk is not None else ""
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)},"
                f" device={self.device.torch_device}{lazy})")


def _wrap(arr, like) -> Tensor:
    """A new Tensor holding ``arr`` on ``like``'s device."""
    t = Tensor.__new__(Tensor)
    t._data = arr
    t._thunk = None
    t.device = like.device
    t.requires_grad = like.requires_grad
    t.stores_grad = False
    t.name = None
    t.grad = None
    t.sharding = None
    t.spec = None
    return t


def _repeat(arr, repeats, axis):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    if isinstance(repeats, (list, tuple, np.ndarray)):
        repeats = torch.as_tensor(np.asarray(repeats), device=arr.device)
    return torch.repeat_interleave(arr, repeats, dim=axis)


def _out(r, out, like):
    """``r`` into ``out`` (in place, :meth:`Tensor._inplace`) when given,
    else a new Tensor like ``like``."""
    if out is not None:
        return out._inplace(r)
    return _wrap(r, like)


# ---------------------------------------------------------------------------
# module functions (singa_tpu/tensor.py:350-637)
# ---------------------------------------------------------------------------

def from_numpy(np_array, dev=None) -> Tensor:
    """A Tensor of a host array, f64 stored as f32 and int64 as int32 (the
    JAX package's 32-bit default)."""
    arr = np.asarray(np_array)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return Tensor(data=arr, device=dev)


def to_numpy(t: Tensor) -> np.ndarray:
    return t.to_numpy()


def to_host(t: Tensor) -> Tensor:
    return t.clone().to_host()


def from_raw_tensor(arr, dev=None) -> Tensor:
    return Tensor(data=arr, device=dev)


def from_raw_tensors(arrs, dev=None) -> list:
    return [from_raw_tensor(a, dev) for a in arrs]


def zeros_like(t: Tensor) -> Tensor:
    return Tensor(shape=t.shape, device=t.device, dtype=t.dtype)


def ones_like(t: Tensor) -> Tensor:
    return Tensor(shape=t.shape, device=t.device, dtype=t.dtype).set_value(1)


def zeros(shape, dtype=float32, device=None) -> Tensor:
    return Tensor(shape=shape, dtype=dtype, device=device)


def ones(shape, dtype=float32, device=None) -> Tensor:
    return Tensor(shape=shape, dtype=dtype, device=device).set_value(1)


def random(shape, device=None) -> Tensor:
    """U[0, 1) of ``shape`` from the device generator."""
    return Tensor(shape=shape, device=device).uniform(0.0, 1.0)


def product(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def sizeof(dtype) -> int:
    return torch.empty((), dtype=_torch_dtype(dtype)).element_size()


def contiguous(t: Tensor) -> Tensor:
    return t.clone()


def reshape(t: Tensor, shape) -> Tensor:
    return t.reshape(shape)


def transpose(t: Tensor, axes=None) -> Tensor:
    return t.transpose(axes)


def copy_data_to_from(dst: Tensor, src: Tensor, size=None,
                      dst_offset=0, src_offset=0) -> None:
    """The first ``size`` elements of ``src`` into ``dst``, in place (all
    of them by default)."""
    if dst_offset != 0 or src_offset != 0:
        raise ValueError("copy_data_to_from: offsets are not supported")
    if size is None or size == dst.size():
        dst.copy_data(src)
        return
    flat = _raw(src, dst).reshape(-1)[:size]
    with torch.no_grad():
        dst.data.view(-1)[:size].copy_(flat.to(dst.dtype))


def copy_from_numpy(t: Tensor, arr) -> None:
    t.copy_from_numpy(arr)


def _unary(fn):
    def g(t):
        return _wrap(fn(_raw(t)), t)
    return g


abs = _unary(torch.abs)  # noqa: A001 - the reference module's API
exp = _unary(torch.exp)
ceil = _unary(torch.ceil)
log = _unary(torch.log)
sign = _unary(torch.sign)
sqrt = _unary(torch.sqrt)
square = _unary(torch.square)
tanh = _unary(torch.tanh)
sigmoid = _unary(torch.sigmoid)
relu = _unary(torch.relu)


def _axis(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _reduced(r, t, out):
    if out is not None:
        return out._inplace(r)
    return _wrap(r, t) if r.dim() else float(r)


def sum(t, axis=None, out=None):  # noqa: A001
    """Sum over ``axis`` (all by default): a float for a 0-d result."""
    x = _raw(t)
    r = torch.sum(x) if axis is None else torch.sum(x, dim=_axis(axis))
    return _reduced(r, t, out)


def pow(t, x, out=None):  # noqa: A001
    return _out(_raw(t) ** _raw(x, t), out, t)


def average(t, axis=None):
    x = _raw(t)
    r = torch.mean(x) if axis is None else torch.mean(x, dim=_axis(axis))
    return _reduced(r, t, None)


def softmax(t, out=None):
    return _out(torch.softmax(_raw(t), dim=-1), out, t)


def _cmp(fn):
    def g(t, x):
        return _wrap(fn(_raw(t), _raw(x, t)).float(), t)
    return g


lt = _cmp(torch.lt)
le = _cmp(torch.le)
gt = _cmp(torch.gt)
ge = _cmp(torch.ge)
eq = _cmp(torch.eq)


def _binary(fn):
    def g(lhs, rhs, ret=None):
        like = lhs if isinstance(lhs, Tensor) else rhs
        r = fn(_raw(lhs, like), _raw(rhs, like))
        return _out(r, ret, like)
    return g


add = _binary(torch.add)
sub = _binary(torch.sub)
eltwise_mult = _binary(torch.mul)
div = _binary(torch.div)


def mult(A, B, C=None, alpha=1.0, beta=0.0):
    """GEMM: ``alpha * A @ B``, plus ``beta * C`` written into ``C`` when
    it is given."""
    r = alpha * (_raw(A) @ _raw(B, A))
    if C is not None:
        return C._inplace(r + beta * C.data)
    return _wrap(r, A)


def axpy(alpha, x, y):
    """``y += alpha * x`` in place on ``y``."""
    return y._inplace(y.data + alpha * _raw(x, y))


def einsum(ops, *args):
    like = next(a for a in args if isinstance(a, Tensor))
    return _wrap(torch.einsum(ops, *[_raw(a, like) for a in args]), like)


def tensordot(A, B, axes=2):
    return _wrap(torch.tensordot(_raw(A), _raw(B, A), dims=axes), A)


def repeat(t, repeats, axis=None):
    """numpy's ``repeat`` (:meth:`Tensor.repeat`)."""
    return _wrap(_repeat(_raw(t), repeats, axis), t)


def concatenate(tensors, axis=0):
    like = tensors[0]
    return _wrap(torch.cat([_raw(t, like) for t in tensors], dim=axis),
                 like)


def bernoulli(p, t: Tensor):
    return t.bernoulli(p)


def gaussian(mean, std, t: Tensor):
    return t.gaussian(mean, std)


def uniform(low, high, t: Tensor):
    return t.uniform(low, high)


def add_column(alpha, v, beta, M):
    """``M = alpha * v[:, None] + beta * M``, in place on M."""
    return M._inplace(alpha * _raw(v, M)[:, None] + beta * M.data)


def add_row(alpha, v, beta, M):
    """``M = alpha * v[None, :] + beta * M``, in place on M."""
    return M._inplace(alpha * _raw(v, M)[None, :] + beta * M.data)


def sum_columns(M):
    return _wrap(torch.sum(_raw(M), dim=1), M)


def sum_rows(M):
    return _wrap(torch.sum(_raw(M), dim=0), M)


def host_copy(a: torch.Tensor) -> np.ndarray:
    """A numpy array of ``a`` in memory of its own (bf16 as f32): the one
    way every host snapshot is taken. On the card ``.cpu()`` copies; a CPU
    tensor's ``.numpy()`` is a view of its storage, so it is copied here,
    and a later in-place write to the tensor (an optimizer step, ``+=``,
    ``copy_from_numpy``) leaves an array taken earlier as it was, as a
    JAX array's host copy is."""
    a = a.detach()
    if a.dtype == torch.bfloat16:
        return a.float().cpu().numpy()       # .float() made a new tensor
    if a.device.type == "cpu":
        return a.numpy().copy()
    return a.cpu().numpy()


def to_host_array(arr):
    """Host numpy copy of a torch tensor or Tensor (bf16 as f32). A
    ZeRO/FSDP shard is gathered by ``Model.get_states``, not here."""
    if isinstance(arr, Tensor):
        return arr.to_numpy()
    if isinstance(arr, torch.Tensor):
        return host_copy(arr)
    return np.asarray(arr)


def to_host_tree(named):
    """:func:`to_host_array` of each entry of a dict."""
    return {k: to_host_array(a) for k, a in named.items()}
