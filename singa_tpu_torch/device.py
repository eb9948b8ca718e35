"""Device abstraction for the PyTorch/CUDA port.

Counterpart of ``singa_tpu/device.py:44-300``. A :class:`Device` names one
``torch.device`` and owns an explicit ``torch.Generator`` that every
parameter filler draws from (the role the JAX package's per-device PRNG key
plays), so weights are reproducible from ``SetRandSeed``.

It keeps the JAX device's user-visible contract (``device.py:44-300``):
``SetRandSeed``, ``Sync`` (``torch.cuda.synchronize`` on the card), the
graph flags (``EnableGraph``/``RunGraph``/``ResetGraph``: recorded; a
model's graph mode is ``Model.compile(use_graph=)``), and the time
profiling knobs: at verbosity 1 ``Model``'s train calls after
``skip_iteration`` record their whole-step times (CUDA events on the
card), which ``PrintTimeProfiling`` prints. Verbosity 2, the JAX
package's per-op and per-fusion profile, waits for the ``observability``
slice (ROADMAP.md, slice E).

Entry points run on the card unless the caller asks for the CPU:
:func:`get_default_device` is ``cuda:0`` and raises when no CUDA device is
present. It never drops to the CPU; tests pass :func:`create_cpu_device`
explicitly.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["Device", "CppCPU", "CudaGPU", "Platform", "create_cpu_device",
           "create_cuda_gpu", "create_cuda_gpus", "create_cuda_gpu_on",
           "create_cuda_gpus_on", "get_default_device", "get_num_gpus",
           "device_query", "enable_lazy_alloc", "host_device"]


class Device:
    """One torch device plus its random generator."""

    _seed_counter = 0
    _lock = threading.Lock()

    def __init__(self, torch_device, device_id: int = 0, lang="kCpp"):
        self.id = device_id
        self.lang = lang
        self.torch_device = torch.device(torch_device)
        self.graph_enabled = False
        self.verbosity = 0
        self.skip_iteration = 5
        self.time_profiling = {}
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

    def set_rand_seed(self, seed: int) -> None:
        self.SetRandSeed(seed)

    # ---- execution mode (recorded; graph mode is Model.compile's) --------
    def EnableGraph(self, enable: bool) -> None:
        self.graph_enabled = bool(enable)

    def RunGraph(self, sequential: bool = False) -> None:
        """A no-op: a model's captured step replays when it is called
        (``graph.StepGraph``)."""

    def ResetGraph(self) -> None:
        """A no-op (see :meth:`RunGraph`)."""

    # ---- time profiling ---------------------------------------------------
    def _record_time(self, name: str, seconds: float) -> None:
        """Add one sample (count, total seconds) under ``name``."""
        rec = self.time_profiling.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += seconds

    def PrintTimeProfiling(self) -> None:
        """Print the samples: calls, total and mean ms by name."""
        if not self.time_profiling:
            print("No time profiling data collected; "
                  "set verbosity>0 and run model steps.")
            return
        rows = sorted(self.time_profiling.items(), key=lambda kv: -kv[1][1])
        width = max(len(k) for k, _ in rows)
        print(f"  {'op':<{width}}  {'calls':>6}  {'total ms':>10}  "
              f"{'avg ms':>9}")
        for name, (count, total) in rows:
            avg = total / count if count else 0.0
            print(f"  {name:<{width}}  {count:>6}  {total * 1e3:>10.3f}  "
                  f"{avg * 1e3:>9.3f}")

    def ResetTimeProfiling(self) -> None:
        self.time_profiling = {}

    def SetVerbosity(self, verbosity: int) -> None:
        """0: off; 1: whole train steps after ``skip_iteration`` steps.
        The JAX package's level 2 (per-op and per-fusion times) is not
        ported."""
        verbosity = int(verbosity)
        if verbosity >= 2:
            raise NotImplementedError(
                "verbosity 2 (per-op and per-fusion profiles) is not ported "
                "yet (ROADMAP.md: observability, slice E); use 1 for "
                "whole-step times")
        self.verbosity = verbosity

    def SetSkipIteration(self, skip: int) -> None:
        self.skip_iteration = int(skip)

    def Sync(self) -> None:
        """Block until the work queued on this device is done."""
        if self.is_cuda:
            torch.cuda.synchronize(self.torch_device)

    def put(self, array, dtype=None) -> torch.Tensor:
        """Place a host array (numpy or torch) on this device. A numpy
        array is copied, on the CPU too: the tensor never shares the
        caller's memory (as a JAX device array does not), so an in-place
        update of it leaves the array as it was."""
        if isinstance(array, np.ndarray):
            if self.torch_device.type == "cpu":
                return torch.tensor(array, dtype=dtype)
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
        super().__init__(f"cuda:{device_id}", device_id, lang="kCuda")


class Platform:
    """Device discovery (reference ``src/core/device/platform.cc``)."""

    @staticmethod
    def GetNumGPUs() -> int:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    @staticmethod
    def DeviceQuery(device_id: int = 0, verbose: bool = False) -> str:
        if device_id >= Platform.GetNumGPUs():
            return f"no device {device_id}"
        p = torch.cuda.get_device_properties(device_id)
        info = (f"Device {device_id}: platform=gpu kind={p.name} "
                f"capability={p.major}.{p.minor} "
                f"memory={p.total_memory} multiprocessors="
                f"{p.multi_processor_count}")
        if verbose:
            print(info)
        return info


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


def create_cuda_gpu_on(device_id: int) -> Device:
    return CudaGPU(device_id)


def create_cuda_gpus(num: int):
    return [CudaGPU(i) for i in range(num)]


def create_cuda_gpus_on(device_ids):
    return [CudaGPU(i) for i in device_ids]


def get_num_gpus() -> int:
    return Platform.GetNumGPUs()


def device_query(device_id: int = 0, verbose: bool = False) -> str:
    return Platform.DeviceQuery(device_id, verbose)


def enable_lazy_alloc(enable: bool) -> None:
    """A no-op kept for the API: PyTorch's caching allocator allocates
    when a tensor is made (reference ``lazy_alloc_``,
    ``src/core/device/device.cc:23``)."""
    _ = enable


_host_device = None


def host_device() -> Device:
    """The host CPU device that ``Tensor.to_host`` moves tensors to (one
    per process)."""
    global _host_device
    with _default_lock:
        if _host_device is None:
            _host_device = CppCPU()
    return _host_device
