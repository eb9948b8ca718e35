"""Batch normalization: batch statistics in training, frozen running
statistics in inference.

Counterpart of ``singa_tpu/ops/batchnorm.py:24-163``.

Training (``batchnorm_2d`` with ``is_training()`` and not
``freeze_stats``): the batch mean and the biased variance ``mean((x -
mean)**2)`` are taken in f32, in two passes, over every axis but the
channel's; the output ``(x - mean) * rsqrt(var + eps) * scale + bias`` is
an ordinary tensor that torch autograd differentiates (the JAX package
takes the vjp of the same expression). The running statistics update in
place as ``m * running + (1 - m) * batch`` with ``m`` the layer's momentum,
from the biased variance for both -- ``F.batch_norm(training=True)`` would
update ``running_var`` with the unbiased variance and read ``momentum`` as
``1 - m``, so it is not used.

Sync-BN (``_global_moments``, ``singa_tpu/ops/batchnorm.py:53-80``): in
the train step of a ``DistOpt`` over more than one rank
(``parallel.communicator.collective_context``) each rank holds its shard
of the batch, and the moments are averaged over the ranks: the mean, then
the variance around that global mean, each through a differentiable
all-reduce divided by the world. The normalisation and the running
statistics then use the global batch's moments, and the sharded step is
the full-batch step. At world 1 nothing is added.

Inference: the 4-D output is a LAZY tensor tagged with its folding
ingredients (``_bn_epilogue``): a ReLU that consumes it may fuse
scale/shift (+ residual add) + ReLU into one pass over the conv output
(``ops/fused_epilogue.py``), and then this normalisation never runs.
Anything else that reads the output (a downsample branch feeding a
residual, a disabled epilogue) runs it on first read.

Statistics and the normalisation stay f32 under every precision policy
(f64 for an f64 input, which the data-parallel checks use as a witness
free of summation-order noise); the output takes the input's dtype.
"""

from __future__ import annotations

import torch

from ..autograd_base import is_training
from ..mixed_precision import accum_f32
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

    def _axes(self, ndim):
        if ndim == 2:
            return (0,)
        return (0, 1, 2) if self.layout == "NHWC" else (0, 2, 3)

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


def batch_moments(x, axes):
    """Batch mean and biased variance of ``x`` over ``axes`` in f32 (f64
    for f64), two passes (the variance is taken around the mean),
    averaged over the ranks of an active data-parallel step (sync-BN,
    module docstring)."""
    from ..parallel.communicator import active_communicator
    comm = active_communicator()
    world = comm.effective_world_size() if comm is not None else 1
    xb = accum_f32(x)
    mean = torch.mean(xb, dim=axes)
    if world > 1:
        mean = comm.all_reduce_grad(mean) / world
    shape = [1 if i in axes else d for i, d in enumerate(xb.shape)]
    var = torch.mean(torch.square(xb - mean.reshape(shape)), dim=axes)
    if world > 1:
        var = comm.all_reduce_grad(var) / world
    return mean, var


def batchnorm_training(x, scale, bias, running_mean, running_var, momentum,
                       eps, axes, bshape):
    """Normalise ``x`` by its batch statistics (differentiable) and update
    the running statistics in place; returns the output in x's dtype."""
    mean, var = batch_moments(x, axes)
    with torch.no_grad():
        m = momentum
        for run, batch in ((running_mean, mean), (running_var, var)):
            run.copy_((accum_f32(run) * m + batch * (1 - m))
                      .to(run.dtype))
    inv = torch.rsqrt(var + eps).reshape(bshape)
    y = (accum_f32(x) - mean.reshape(bshape)) * inv \
        * accum_f32(scale).reshape(bshape) \
        + accum_f32(bias).reshape(bshape)
    return y.to(x.dtype)


def batchnorm_2d(handle: BatchNormHandle, x, scale, bias,
                 running_mean: Tensor, running_var: Tensor,
                 freeze_stats=False):
    """BN over Tensors: batch statistics and a running-stat update in
    training (unless ``freeze_stats``), the running statistics
    otherwise."""
    h = handle
    bshape = h._bshape(x.ndim)
    if is_training() and not freeze_stats:
        return Tensor(data=batchnorm_training(
            x.data, scale.data, bias.data, running_mean.data,
            running_var.data, h.factor, h.eps, h._axes(x.ndim), bshape),
            device=x.device)

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
