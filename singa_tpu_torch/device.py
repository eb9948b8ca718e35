"""Device abstraction for the PyTorch/CUDA port.

Counterpart of ``singa_tpu/device.py:44-300``. A :class:`Device` names one
``torch.device`` and owns an explicit ``torch.Generator`` that every
parameter filler draws from (the role the JAX package's per-device PRNG key
plays), so weights are reproducible from ``SetRandSeed``.

Entry points run on the card unless the caller asks for the CPU:
:func:`get_default_device` is ``cuda:0`` and raises when no CUDA device is
present. It never drops to the CPU; tests pass :func:`create_cpu_device`
explicitly.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["Device", "CppCPU", "CudaGPU", "create_cpu_device",
           "create_cuda_gpu", "get_default_device"]


class Device:
    """One torch device plus its random generator."""

    _seed_counter = 0
    _lock = threading.Lock()

    def __init__(self, torch_device, device_id: int = 0):
        self.id = device_id
        self.torch_device = torch.device(torch_device)
        self.generator = torch.Generator(device=self.torch_device)
        with Device._lock:
            Device._seed_counter += 1
            seed = Device._seed_counter
        self.generator.manual_seed(seed)

    @property
    def is_cuda(self) -> bool:
        return self.torch_device.type == "cuda"

    def SetRandSeed(self, seed: int) -> None:
        self.generator.manual_seed(int(seed))

    def put(self, array, dtype=None) -> torch.Tensor:
        """Place a host array (numpy or torch) on this device."""
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.ascontiguousarray(array))
        elif not isinstance(array, torch.Tensor):
            array = torch.as_tensor(array)
        return array.to(device=self.torch_device, dtype=dtype)

    def name(self) -> str:
        return f"{type(self).__name__}({self.id})"

    def __repr__(self) -> str:
        return f"<{self.name()} device={self.torch_device}>"


class CppCPU(Device):
    """Host CPU device (the port's tests run here)."""

    def __init__(self, device_id: int = 0):
        super().__init__("cpu", device_id)


class CudaGPU(Device):
    """One CUDA card. Raises when CUDA is not available."""

    def __init__(self, device_id: int = 0):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: singa_tpu_torch runs on the "
                "GPU by default; pass device.create_cpu_device() "
                "explicitly to run on the CPU")
        n = torch.cuda.device_count()
        if not 0 <= device_id < n:
            raise ValueError(f"CUDA device {device_id} does not exist "
                             f"({n} visible)")
        super().__init__(f"cuda:{device_id}", device_id)


_default_device = None
_default_lock = threading.Lock()


def get_default_device() -> Device:
    """The default device is ``cuda:0``; raises without a CUDA device."""
    global _default_device
    with _default_lock:
        if _default_device is None:
            _default_device = CudaGPU(0)
    return _default_device


def create_cpu_device() -> Device:
    return CppCPU()


def create_cuda_gpu(device_id: int = 0) -> Device:
    return CudaGPU(device_id)
