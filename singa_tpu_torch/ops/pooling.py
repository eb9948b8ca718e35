"""Max and average pooling with the JAX package's padding semantics.

Counterpart of ``singa_tpu/ops/pooling.py:25-117``. Padding is applied
explicitly (``-inf`` for max, zeros for average) before a zero-padding
``F.max_pool2d`` / ``F.avg_pool2d``, so asymmetric padding works and the
windows match ``lax.reduce_window``. Average pooling divides by the full
window (``count_include_pad=True``, the default) or by the valid element
count. NHWC tensors are pooled through a channels-last NCHW view.
:class:`GlobalAveragePool` / :func:`globalaveragepool` (``:102-121``)
average over every spatial axis, keeping them as size 1. The 1-D pools
(``layer.MaxPool1d``/``AvgPool1d``) are this 2-D pooling over an
``(N, C, 1, L)`` input with ``(1, k)`` windows, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tensor import Tensor


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


class PoolingHandle:
    """Static pooling config; ``padding`` is an int, a pair, or explicit
    ((ph0, ph1), (pw0, pw1))."""

    def __init__(self, x, kernel_size, stride=None, padding=0, is_max=True,
                 layout=None, count_include_pad=True):
        from .layout import resolve as _resolve_layout
        self.count_include_pad = bool(count_include_pad)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        if (isinstance(padding, (tuple, list)) and len(padding) == 2
                and isinstance(padding[0], (tuple, list))):
            self.pad_pairs = tuple(tuple(int(v) for v in p) for p in padding)
        else:
            ph, pw = _pair(padding)
            self.pad_pairs = ((ph, ph), (pw, pw))
        self.padding = (self.pad_pairs[0][0], self.pad_pairs[1][0])
        self.is_max_pooling = bool(is_max)
        self.layout = _resolve_layout(layout)


def pooling_2d(handle: PoolingHandle, x):
    """Pool Tensor ``x``; returns a Tensor of x's dtype."""
    h = handle
    xa = x.data
    if h.layout == "NHWC":
        xa = xa.permute(0, 3, 1, 2)
    (p0, p1), (q0, q1) = h.pad_pairs
    pads = (q0, q1, p0, p1)
    if h.is_max_pooling:
        if any(pads):
            xa = F.pad(xa, pads, value=float("-inf"))
        y = F.max_pool2d(xa, h.kernel_size, h.stride)
    else:
        padded = F.pad(xa, pads) if any(pads) else xa
        y = F.avg_pool2d(padded, h.kernel_size, h.stride)
        if not h.count_include_pad and any(pads):
            ones = F.pad(torch.ones_like(xa[:1, :1]), pads)
            frac = F.avg_pool2d(ones, h.kernel_size, h.stride)
            y = y / frac
    if h.layout == "NHWC":
        y = y.permute(0, 2, 3, 1)
    return Tensor(data=y.contiguous(), device=x.device)


class GlobalAveragePool:
    """``(N, C, H, W) -> (N, C, 1, 1)`` mean (``"channels_first"``), or
    ``(N, H, W, C) -> (N, 1, 1, C)`` (``"channels_last"``); any number of
    spatial axes."""

    def __init__(self, data_format="channels_first"):
        self.data_format = data_format

    def __call__(self, x):
        xa = x.data
        if self.data_format == "channels_first":
            axes = tuple(range(2, xa.dim()))
        else:
            axes = tuple(range(1, xa.dim() - 1))
        return Tensor(data=torch.mean(xa, dim=axes, keepdim=True),
                      device=x.device)


def globalaveragepool(x, data_format="channels_first"):
    return GlobalAveragePool(data_format)(x)
