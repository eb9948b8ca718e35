"""Structured ops of the port (counterpart of ``singa_tpu/ops``): conv,
BN, pooling, layout selection, the fused BN+ReLU epilogue (kernel K2) and
the fused optimizer updates (kernels K1, K5, K6, K7)."""

from . import (layout, conv, batchnorm, pooling, fused_epilogue,  # noqa: F401
               fused_optim)
