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

``space_to_depth=True`` (``singa_tpu/ops/conv.py:113-168``) runs a KxK
stride-2 stem conv as the same function of the same OIHW weights: one
``F.conv2d`` at stride 1 on the space-to-depth'd input (4x the channels,
half the height and width) with a re-indexed kernel. The re-index is one
gather from the OIHW weights, so gradients land on ``W`` and checkpoints
do not change; its index table is built once per handle and device, on
the device, at the first (eager) call, so a CUDA-graph capture copies
nothing from the host.

:class:`ConvTransposeHandle` and :func:`conv_transpose2d`
(``singa_tpu/ops/conv.py:208-298``): the transposed conv with groups,
dilation, asymmetric padding and output padding, NCHW and NHWC, on the
JAX package's weight layout ``(C_in, C_out / group, kH, kW)``, which is
``F.conv_transpose2d``'s. Symmetric padding with an output padding below
the stride or the dilation runs as one ``F.conv_transpose2d``; any other
geometry runs the unpadded transposed conv and crops (or, for an output
padding past the input's reach, extends with zeros) each spatial edge,
which is what the JAX package's input-dilated conv computes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..mixed_precision import cast_compute
from ..tensor import Tensor
from ..utils import same_pads


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


class ConvHandle:
    """Static conv config. ``padding`` is an int, an (ph, pw) pair, or
    explicit ((ph0, ph1), (pw0, pw1))."""

    def __init__(self, x, kernel_size, stride, padding, in_channels,
                 out_channels, bias=True, group=1, pad_mode=None,
                 dilation=1, layout=None, space_to_depth=False):
        from .layout import resolve as _resolve_layout
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
        self.space_to_depth = bool(space_to_depth)
        self._s2d_index = {}    # torch device -> gather index on it
        if self.space_to_depth:
            kh, kw = self.kernel_size
            (p0, p1), (q0, q1) = self.padding
            if (self.stride != (2, 2) or kh != kw or p0 != p1
                    or q0 != q1 or p0 != q0 or 2 * p0 != kh - 1
                    or self.group != 1 or self.dilation != (1, 1)
                    or self.pad_mode
                    or (getattr(self, "height", 0) and self.height % 2)
                    or (getattr(self, "width", 0) and self.width % 2)):
                raise ValueError(
                    "space_to_depth stem requires stride 2, square odd "
                    "kernel with pad = (K-1)/2, group 1, no dilation, "
                    "and even spatial dims (the 7x7/s2 ResNet stem "
                    "shape)")

    def pads(self, h, w):
        """((top, bottom), (left, right)) for an (h, w) input."""
        if self.pad_mode == "VALID":
            return ((0, 0), (0, 0))
        if self.pad_mode in ("SAME", "SAME_LOWER"):
            lower = self.pad_mode == "SAME_LOWER"
            (kh, kw), (sh, sw), (dh, dw) = (self.kernel_size, self.stride,
                                            self.dilation)
            return (same_pads(h, kh, sh, dh, lower),
                    same_pads(w, kw, sw, dw, lower))
        return self.padding


def _s2d_geometry(K, P):
    """Tap decomposition of a stride-2 conv axis: kernel position p maps
    to block offset t and parity a via p - P = 2t + a. Returns
    (t_min, t_max): the transformed kernel spans t_max - t_min + 1."""
    qs = [p - P for p in range(K)]
    ts = [(q - (q % 2)) // 2 for q in qs]
    return min(ts), max(ts)


def _s2d_gather_index(handle):
    """numpy table ``idx`` of the weight re-index: the transformed kernel
    ``W4[o].ravel()`` (shape (4C, Kp, Kp), channel ``c*4 + ah*2 + aw``) is
    ``Wpad[o, idx]`` with ``Wpad[o] = [W[o].ravel(), 0]``: each tap
    ``W[o, c, p_h, p_w]`` lands at ``(c*4 + ah*2 + aw, th - t_min, tw -
    t_min)`` with ``p - P = 2t + a``; a position no tap reaches reads the
    appended zero."""
    K, _ = handle.kernel_size
    (P, _), _ = handle.padding
    C = handle.in_channels
    t_min, t_max = _s2d_geometry(K, P)
    Kp = t_max - t_min + 1
    idx = np.full((C * 4, Kp, Kp), C * K * K, np.int64)
    c_i, ph_i, pw_i = np.meshgrid(np.arange(C), np.arange(K), np.arange(K),
                                  indexing="ij")
    qh, qw = ph_i - P, pw_i - P
    ah, aw = qh % 2, qw % 2
    th, tw = (qh - ah) // 2, (qw - aw) // 2
    idx[c_i * 4 + ah * 2 + aw, th - t_min, tw - t_min] = \
        (c_i * K + ph_i) * K + pw_i
    return idx.ravel(), Kp, -t_min, t_max


def _space_to_depth_conv(h, xa, wa, ba):
    """The stem conv of ``h`` on logical-layout input ``xa`` as one
    stride-1 ``F.conv2d`` of the space-to-depth'd input (NCHW out)."""
    dev = wa.device
    entry = h._s2d_index.get(dev)
    if entry is None:
        idx, Kp, lo, hi = _s2d_gather_index(h)
        entry = h._s2d_index[dev] = (torch.from_numpy(idx).to(dev), Kp,
                                     lo, hi)
    idx, Kp, lo, hi = entry
    O, C = wa.shape[0], h.in_channels
    wflat = F.pad(wa.reshape(O, -1), (0, 1))
    w4 = wflat[:, idx].reshape(O, C * 4, Kp, Kp)
    if h.layout == "NHWC":
        N, H, Wd, _ = xa.shape
        xb = xa.reshape(N, H // 2, 2, Wd // 2, 2, C) \
            .permute(0, 1, 3, 5, 2, 4).reshape(N, H // 2, Wd // 2, C * 4) \
            .permute(0, 3, 1, 2)
    else:
        N, _, H, Wd = xa.shape
        xb = xa.reshape(N, C, H // 2, 2, Wd // 2, 2) \
            .permute(0, 1, 3, 5, 2, 4).reshape(N, C * 4, H // 2, Wd // 2)
    xb = F.pad(xb, (lo, hi, lo, hi))
    return F.conv2d(xb, w4, ba)


def conv2d(handle: ConvHandle, x, W, b=None, odd_padding=None):
    """Conv of Tensor ``x`` with OIHW ``W`` (+ bias) under the active
    precision policy; returns a Tensor in the (cast) input's dtype.
    ``odd_padding`` ``(top, bottom, left, right)`` adds to the handle's
    explicit padding."""
    h = handle
    if odd_padding is not None:
        import copy
        t, bo, le, r = odd_padding
        (p0, p1), (q0, q1) = h.padding
        h = copy.copy(h)
        h.pad_mode = None
        h.padding = ((p0 + t, p1 + bo), (q0 + le, q1 + r))
    xa, wa, ba = cast_compute(x.data, W.data,
                              b.data if b is not None else None)
    if h.space_to_depth:
        y = _space_to_depth_conv(h, xa, wa, ba)
        if h.layout == "NHWC":
            y = y.permute(0, 2, 3, 1)
        return Tensor(data=y.contiguous(), device=x.device)
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


class ConvTransposeHandle:
    """Static transposed-conv config (ONNX ConvTranspose); weights
    ``(C_in, C_out / group, kH, kW)``."""

    def __init__(self, x, kernel_size, stride, padding, in_channels,
                 out_channels, bias=True, group=1, dilation=1,
                 output_padding=0, layout=None):
        from .layout import resolve as _resolve_layout
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.output_padding = _pair(output_padding)
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
        self.layout = _resolve_layout(layout)

    def output_shape(self, x_shape):
        if self.layout == "NHWC":
            n, h, w, _ = x_shape
        else:
            n, _, h, w = x_shape
        (p0, p1), (q0, q1) = self.padding
        kh, kw = self.kernel_size
        sh, sw = self.stride
        dh, dw = self.dilation
        oph, opw = self.output_padding
        oh = (h - 1) * sh - p0 - p1 + dh * (kh - 1) + 1 + oph
        ow = (w - 1) * sw - q0 - q1 + dw * (kw - 1) + 1 + opw
        if self.layout == "NHWC":
            return (n, oh, ow, self.out_channels)
        return (n, self.out_channels, oh, ow)


def conv_transpose2d(handle: ConvTransposeHandle, x, W, b=None):
    """Transposed conv of Tensor ``x`` with ``W`` (+ bias) under the
    active precision policy; a Tensor in the (cast) input's dtype."""
    h = handle
    xa, wa, ba = cast_compute(x.data, W.data,
                              b.data if b is not None else None)
    if h.layout == "NHWC":
        xa = xa.permute(0, 3, 1, 2)
    (p0, p1), (q0, q1) = h.padding
    oph, opw = h.output_padding
    native = (p0 == p1 and q0 == q1 and
              oph < max(h.stride[0], h.dilation[0]) and
              opw < max(h.stride[1], h.dilation[1]))
    if native:
        y = F.conv_transpose2d(xa, wa, ba, stride=h.stride,
                               padding=(p0, q0), output_padding=(oph, opw),
                               groups=h.group, dilation=h.dilation)
    else:
        y = F.conv_transpose2d(xa, wa, None, stride=h.stride,
                               groups=h.group, dilation=h.dilation)
        y = F.pad(y, (-q0, opw - q1, -p0, oph - p1))
        if ba is not None:
            y = y + ba.reshape(1, -1, 1, 1)
    if h.layout == "NHWC":
        y = y.permute(0, 2, 3, 1)
    return Tensor(data=y.contiguous(), device=x.device)
