"""Structured ops of the port (counterpart of ``singa_tpu/ops``): conv,
BN, pooling, layout selection, the fused BN+ReLU epilogue (kernel K2), the
fused optimizer updates (kernels K1, K5, K6, K7), flash attention (kernels
K3, K4) and the fused chunked CE head of the LM."""

from . import (layout, conv, batchnorm, pooling, fused_epilogue,  # noqa: F401
               fused_optim, attention, losses)
