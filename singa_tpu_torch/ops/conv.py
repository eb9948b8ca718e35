"""2-D convolution through cuDNN.

Counterpart of ``singa_tpu/ops/conv.py:37-206``: a :class:`ConvHandle`
fixes the geometry once per layer, and :func:`conv2d` runs one
``F.conv2d`` (cuDNN on the card), as the JAX package leaves the conv to
XLA. Weights are OIHW in both layouts. Groups, dilation, symmetric,
asymmetric and SAME/VALID padding follow the JAX package.

Under ``layout="NHWC"`` the activations are logical NHWC tensors: the
input is handed to ``F.conv2d`` as a channels-last NCHW view
(``permute``), and the output comes back as a contiguous logical NHWC
tensor, which is what the NHWC epilogue kernel takes.

The ``space_to_depth`` stem is not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch.nn.functional as F

from ..mixed_precision import cast_compute
from ..tensor import Tensor


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _same_pads(size, k, s, d, lower):
    """lax's SAME padding for one axis: output ceil(size / s); the odd
    pixel goes after (SAME) or before (SAME_LOWER)."""
    out = -(-size // s)
    total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
    small, big = total // 2, total - total // 2
    return (big, small) if lower else (small, big)


class ConvHandle:
    """Static conv config. ``padding`` is an int, an (ph, pw) pair, or
    explicit ((ph0, ph1), (pw0, pw1))."""

    def __init__(self, x, kernel_size, stride, padding, in_channels,
                 out_channels, bias=True, group=1, pad_mode=None,
                 dilation=1, layout=None, space_to_depth=False):
        from .layout import resolve as _resolve_layout
        if space_to_depth:
            raise NotImplementedError(
                "the space_to_depth stem is not ported yet (ROADMAP: left "
                "out of the serving slice); use stem='conv7'")
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        if (isinstance(padding, (tuple, list)) and len(padding) == 2
                and isinstance(padding[0], (tuple, list))):
            self.padding = tuple(tuple(int(v) for v in p) for p in padding)
        else:
            ph, pw = _pair(padding)
            self.padding = ((ph, ph), (pw, pw))
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.bias = bool(bias)
        self.group = int(group)
        if pad_mode not in (None, "SAME", "SAME_LOWER", "VALID"):
            raise ValueError(f"unknown pad_mode {pad_mode!r}")
        self.pad_mode = pad_mode
        self.layout = _resolve_layout(layout)
        xs = x.shape if hasattr(x, "shape") else tuple(x)
        self.batchsize = int(xs[0]) if len(xs) > 0 else 0
        if len(xs) == 4:
            if self.layout == "NHWC":
                self.height, self.width = int(xs[1]), int(xs[2])
            else:
                self.height, self.width = int(xs[2]), int(xs[3])

    def pads(self, h, w):
        """((top, bottom), (left, right)) for an (h, w) input."""
        if self.pad_mode == "VALID":
            return ((0, 0), (0, 0))
        if self.pad_mode in ("SAME", "SAME_LOWER"):
            lower = self.pad_mode == "SAME_LOWER"
            (kh, kw), (sh, sw), (dh, dw) = (self.kernel_size, self.stride,
                                            self.dilation)
            return (_same_pads(h, kh, sh, dh, lower),
                    _same_pads(w, kw, sw, dw, lower))
        return self.padding


def conv2d(handle: ConvHandle, x, W, b=None):
    """Conv of Tensor ``x`` with OIHW ``W`` (+ bias) under the active
    precision policy; returns a Tensor in the (cast) input's dtype."""
    h = handle
    xa, wa, ba = cast_compute(x.data, W.data,
                              b.data if b is not None else None)
    if h.layout == "NHWC":
        xa = xa.permute(0, 3, 1, 2)
    (p0, p1), (q0, q1) = h.pads(xa.shape[2], xa.shape[3])
    if p0 == p1 and q0 == q1:
        pad = (p0, q0)
    else:
        xa = F.pad(xa, (q0, q1, p0, p1))
        pad = (0, 0)
    y = F.conv2d(xa, wa, ba, stride=h.stride, padding=pad,
                 dilation=h.dilation, groups=h.group)
    if h.layout == "NHWC":
        y = y.permute(0, 2, 3, 1)
    return Tensor(data=y.contiguous(), device=x.device)
