"""Inference batch normalization with frozen running statistics.

Counterpart of ``singa_tpu/ops/batchnorm.py:24-163`` (the inference op
and its epilogue tag). The 4-D output is a LAZY tensor tagged with its
folding ingredients (``_bn_epilogue``): a ReLU that consumes it may fuse
scale/shift (+ residual add) + ReLU into one pass over the conv output
(``ops/fused_epilogue.py``), and then this normalisation never runs.
Anything else that reads the output (a downsample branch feeding a
residual, a disabled epilogue) runs it on first read.

Statistics and the normalisation stay f32 under every precision policy;
the output takes the input's dtype. Training-mode BN (batch statistics and
the running-stat update) comes with the training slice of the port.
"""

from __future__ import annotations

import torch

from ..autograd_base import is_training
from ..tensor import Tensor

# how many times the plain inference normalisation actually ran
normalise_runs = 0


class BatchNormHandle:
    """Static BN config; 2-D (N, C) and 4-D inputs."""

    def __init__(self, momentum, x, eps: float = 1e-5, layout=None):
        from .layout import resolve as _resolve_layout
        self.factor = float(momentum)
        self.layout = _resolve_layout(layout)
        xs = x.shape if hasattr(x, "shape") else tuple(x)
        self.is_2d = len(xs) == 2
        self.channels = int(xs[-1]) \
            if self.layout == "NHWC" and not self.is_2d else int(xs[1])
        self.eps = eps
        self.batchsize = int(xs[0])

    def _bshape(self, ndim):
        if ndim == 2:
            return (1, self.channels)
        return (1, 1, 1, self.channels) if self.layout == "NHWC" \
            else (1, self.channels, 1, 1)


def batchnorm_inference(x, scale, bias, rmean, rvar, eps, bshape):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, cast to
    x's dtype (the JAX package's ``_BatchNorm2dInference`` math)."""
    global normalise_runs
    normalise_runs += 1
    inv = torch.rsqrt(rvar.float() + eps).reshape(bshape)
    y = (x.float() - rmean.float().reshape(bshape)) * inv \
        * scale.float().reshape(bshape) + bias.float().reshape(bshape)
    return y.to(x.dtype)


def batchnorm_2d(handle: BatchNormHandle, x, scale, bias,
                 running_mean: Tensor, running_var: Tensor,
                 freeze_stats=False):
    """Inference BN over Tensors. In training mode without
    ``freeze_stats`` it raises: training-mode BN is not ported yet."""
    if is_training() and not freeze_stats:
        raise NotImplementedError(
            "training-mode BatchNorm is not ported yet (ROADMAP: slice A, "
            "ResNet-50 training); serve under model.eval()")
    h = handle
    bshape = h._bshape(x.ndim)

    def run():
        return batchnorm_inference(x.data, scale.data, bias.data,
                                   running_mean.data, running_var.data,
                                   h.eps, bshape)

    if h.is_2d:
        return Tensor(data=run(), device=x.device)
    out = Tensor.lazy(run, x.shape, x.dtype, x.device)
    out._bn_epilogue = (x, scale, bias, running_mean, running_var, h.eps,
                        h.layout)
    return out
