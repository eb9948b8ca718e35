"""Tensor: a ``torch.Tensor`` with a :class:`~.device.Device` and the
fused-epilogue tags.

Counterpart of ``singa_tpu/tensor.py`` (construction, metadata, dtype
casts, numpy in and out, in-place refills, ``grad``). The JAX payload is a
``jax.Array``; here it is a ``torch.Tensor`` on the tensor's device. A
parameter's payload is a torch leaf that requires grad
(``autograd_base.register_param``); the refills (``copy_from_numpy``,
``copy_from``, ``gaussian``) write into it in place under ``no_grad``, so
it stays the same leaf, and :func:`~.autograd_base.backward` leaves its
gradient on ``grad``.

A tensor may be *lazy*: ``ops/batchnorm.py`` and ``autograd.add`` return
their outputs with a thunk instead of a value, plus the tag the ReLU
epilogue peephole reads (``_bn_epilogue`` / ``_bn_add_epilogue``). The
thunk runs the first time ``.data`` is read. When the fusing ReLU is the
only consumer it never reads ``.data``, so the bypassed BN and add never
run -- the eager counterpart of XLA removing them as dead code under the
JAX package's jit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod

__all__ = ["Tensor", "float16", "bfloat16", "float32", "from_numpy",
           "to_numpy", "dtype_name"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32


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


class Tensor:
    """nd-array with device placement and dtype."""

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
        # (dim, full shape) of a ZeRO/FSDP shard (parallel.gspmd)
        self.sharding = None

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

    def as_type(self, dtype):
        return Tensor(data=self.data.to(_torch_dtype(dtype)),
                      device=self.device, requires_grad=self.requires_grad)

    def to_numpy(self) -> np.ndarray:
        """Host copy. numpy has no bfloat16, so a bf16 tensor comes back
        as float32 (lossless)."""
        arr = self.data.detach()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.cpu().numpy()

    def copy_from_numpy(self, np_array):
        """Refill in place from a host array of the same element count,
        cast to this tensor's dtype."""
        arr = np.ascontiguousarray(np_array)
        if arr.size != self.size():
            raise ValueError(f"copy_from_numpy: {arr.shape} does not fit "
                             f"{self.shape}")
        src = torch.from_numpy(arr.reshape(self.shape))
        with torch.no_grad():
            self.data.copy_(src.to(self.dtype))
        return self

    def copy_from(self, other):
        if isinstance(other, np.ndarray):
            return self.copy_from_numpy(other)
        src = other.data if isinstance(other, Tensor) else other
        with torch.no_grad():
            self.data.copy_(src.reshape(self.shape).to(self.dtype))
        return self

    def gaussian(self, mean=0.0, std=1.0, generator=None):
        """Refill from N(mean, std) drawn in f32 from ``generator`` (the
        device's own by default)."""
        g = generator if generator is not None else self.device.generator
        r = torch.randn(self.shape, generator=g, dtype=torch.float32,
                        device=self.device.torch_device)
        with torch.no_grad():
            self.data.copy_(r * std + mean)
        return self

    def uniform(self, low=0.0, high=1.0, generator=None):
        """Refill from U(low, high) drawn in f32 from ``generator`` (the
        device's own by default)."""
        g = generator if generator is not None else self.device.generator
        r = torch.rand(self.shape, generator=g, dtype=torch.float32,
                       device=self.device.torch_device)
        with torch.no_grad():
            self.data.copy_(r * (high - low) + low)
        return self

    def __repr__(self):
        lazy = " lazy" if self._thunk is not None else ""
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)},"
                f" device={self.device.torch_device}{lazy})")


def from_numpy(np_array, dev=None) -> Tensor:
    return Tensor(data=np.asarray(np_array), device=dev)


def to_numpy(t: Tensor) -> np.ndarray:
    return t.to_numpy()
