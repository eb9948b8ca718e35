"""singa_tpu_torch: the PyTorch/CUDA port of ``singa_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``singa_tpu`` stays as the reference; this package imports
neither it nor JAX. Module names mirror ``singa_tpu``'s. It serves ResNet
through ``Model.compile_serving`` -> ``BatchServingEngine``, with every
frozen-BN -> (add ->) ReLU tail in one pass of the hand-written CUDA kernel
in ``csrc/fused_epilogue.cu`` (``ops.fused_epilogue``, K2), and trains it
in f32 through ``Model.compile(is_train=True)`` and ``model(x, y)``, with
``opt.SGD/Adam/RMSProp/AdaGrad(fused=True)`` updating every parameter in
one pass of a hand-written CUDA kernel in ``csrc/fused_optim.cu``
(``ops.fused_optim``, K1, K5, K6, K7). It trains and evaluates the
Transformer LM (``models.transformer``) on one device, every attention
call through the hand-written flash-attention kernels in
``csrc/flash_attention.cu`` (``ops.attention``, K3 forward, K4 backward).
Under ``Model.compile(policy="bf16_mixed", is_train=True)`` it trains
with f32 masters, bf16 convolutions and products and dynamic loss scaling
(``resilience.GuardedOptimizer``), a bad step skipped on the card.

Entry points run on the card: ``device.get_default_device()`` is
``cuda:0`` and raises without CUDA. Pass ``device.create_cpu_device()``
to run on the CPU, where each kernel's plain PyTorch version stands in.
"""

from . import (device, tensor, mixed_precision, autograd_base,  # noqa: F401
               autograd, initializer, layer, model, ops, models, serving,
               opt, resilience, metric, data, datasets, parallel)

__version__ = "0.3.0"
