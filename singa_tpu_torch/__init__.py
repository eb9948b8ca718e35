"""singa_tpu_torch: the PyTorch/CUDA port of ``singa_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``singa_tpu`` stays as the reference; this package imports
neither it nor JAX. Module names mirror ``singa_tpu``'s. This slice serves
ResNet through ``Model.compile_serving`` -> ``BatchServingEngine``, with
every frozen-BN -> (add ->) ReLU tail in one pass of the hand-written CUDA
kernel in ``csrc/fused_epilogue.cu`` (``ops.fused_epilogue``).

Entry points run on the card: ``device.get_default_device()`` is
``cuda:0`` and raises without CUDA. Pass ``device.create_cpu_device()``
to run on the CPU, where the kernel's plain PyTorch version stands in.
"""

from . import (device, tensor, mixed_precision, autograd_base,  # noqa: F401
               autograd, initializer, layer, model, ops, models, serving)

__version__ = "0.1.0"
