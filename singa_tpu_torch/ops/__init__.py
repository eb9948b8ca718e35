"""Structured ops of the port (counterpart of ``singa_tpu/ops``): conv,
inference BN, pooling, layout selection and the fused BN+ReLU epilogue
(kernel K2)."""

from . import layout, conv, batchnorm, pooling, fused_epilogue  # noqa: F401
