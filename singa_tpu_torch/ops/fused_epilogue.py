"""Fused conv epilogue: inference BN scale/shift (+ residual) + ReLU in one
pass -- kernel K2 of the port.

Counterpart of ``singa_tpu/ops/fused_epilogue.py``. At inference the BN
after a conv is a frozen per-channel affine ``y = x * s + b`` with ``s =
scale * rsqrt(running_var + eps)`` and ``b = bias - running_mean * s``
(:func:`fold_bn`, f32). The kernel applies that affine, the optional
residual add, and the ReLU in ONE pass over the conv output:

- :func:`scale_shift_relu` -- ``max(x*s + b, 0)``;
- :func:`scale_shift_add_relu` -- ``max(x*s + b + r, 0)``, the residual
  tail at every ResNet block's exit.

Each has a plain PyTorch version beside it
(:func:`scale_shift_relu_reference`, :func:`scale_shift_add_relu_reference`).
A wrapper uses the plain version only for a tensor on the CPU. A CUDA
tensor always goes to the hand-written kernel in ``csrc/fused_epilogue.cu``
(built at first use by :mod:`..cuda_build`) or raises: there is no
fallback and no size gate. ``launches`` counts kernel launches by variant.

Wiring is the JAX package's peephole, made lazy for eager PyTorch: the
inference BN returns a lazy tensor tagged with its folding ingredients
(``ops/batchnorm.py``), ``autograd.add`` tags a sum with a tagged operand,
and ``autograd.relu`` hands a tagged input to :func:`try_relu_epilogue`.
When that fuses, the lazy BN output and sum are never read, so they never
run (the JAX package gets the same from XLA dead-code elimination).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..autograd_base import is_training

_ENABLED = False

# kernel launches, by variant (only where the CUDA kernel runs)
launches = {"affine_relu_nchw": 0, "affine_relu_nhwc": 0,
            "affine_add_relu_nchw": 0, "affine_add_relu_nhwc": 0}
# tails try_relu_epilogue fused, on any device
fused_tails = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LAYOUTS = ("NCHW", "NHWC")


def enable(on=True):
    """Process-wide opt-in (never on by default). Returns the previous
    value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


@contextlib.contextmanager
def enabled_scope(on=True):
    prev = enable(on)
    try:
        yield
    finally:
        enable(prev)


def enabled():
    return _ENABLED


def reset_counts():
    """Zero the launch and fused-tail counters."""
    global fused_tails
    for k in launches:
        launches[k] = 0
    fused_tails = 0


def variant(layout, residual) -> str:
    """The ``launches`` key of one kernel variant."""
    kind = "affine_add_relu" if residual else "affine_relu"
    return f"{kind}_{layout.lower()}"


# -- plain PyTorch versions -------------------------------------------------

def _reference(x, scale, shift, layout, residual=None):
    c = x.shape[1] if layout == "NCHW" else x.shape[-1]
    b = (1, c, 1, 1) if layout == "NCHW" else (1, 1, 1, c)
    y = x.float() * scale.float().reshape(b) + shift.float().reshape(b)
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y).to(x.dtype)


def scale_shift_relu_reference(x, scale, shift, layout="NCHW"):
    """Plain version of :func:`scale_shift_relu`: multiply, add, relu in
    f32, cast to x's dtype."""
    return _reference(x, scale, shift, layout)


def scale_shift_add_relu_reference(x, scale, shift, residual,
                                   layout="NCHW"):
    """Plain version of :func:`scale_shift_add_relu`."""
    return _reference(x, scale, shift, layout, residual)


# -- the CUDA kernel --------------------------------------------------------

def _library():
    from .. import cuda_build
    lib = cuda_build.load("fused_epilogue")
    fn = lib.singa_affine_relu
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_void_p] * 5 + \
            [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]
    return fn


def _check(x, scale, shift, layout, residual):
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}, got {layout!r}")
    if x.dim() != 4:
        raise ValueError(f"the epilogue kernel takes a 4-D activation, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the epilogue kernel takes f32, bf16 or f16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"the {layout} epilogue kernel needs x contiguous as a logical "
            f"{layout} tensor (channel {'minor' if layout == 'NHWC' else 'per plane'}); "
            f"got strides {x.stride()}")
    c = x.shape[1] if layout == "NCHW" else x.shape[-1]
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or \
                not v.is_contiguous() or v.device != x.device:
            raise ValueError(
                f"{name} must be a contiguous f32 ({c},) tensor on "
                f"{x.device}; got {v.dtype} {tuple(v.shape)} on {v.device}")
    if residual is not None:
        if tuple(residual.shape) != tuple(x.shape) or \
                residual.dtype != x.dtype or \
                residual.device != x.device or \
                not residual.is_contiguous():
            raise ValueError(
                "residual must be a contiguous tensor of x's shape, dtype "
                f"and device; got {residual.dtype} {tuple(residual.shape)} "
                f"on {residual.device}")
    return c


def _launch(x, scale, shift, layout, residual=None):
    c = _check(x, scale, shift, layout, residual)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    hw = x.shape[2] * x.shape[3] if layout == "NCHW" else 1
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_KERNEL_DTYPES[x.dtype], int(layout == "NHWC"),
                 x.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                 x.numel(), c, hw, stream)
    if err != 0:
        raise RuntimeError(f"fused epilogue kernel launch failed: CUDA "
                           f"error {err}")
    launches[variant(layout, residual is not None)] += 1
    return out


def _dispatch(x, scale, shift, layout, residual):
    if x.device.type == "cpu":
        return _reference(x, scale, shift, layout, residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"no epilogue kernel for device {x.device}")
    return _launch(x, scale, shift, layout, residual)


def scale_shift_relu(x, scale, shift, layout="NCHW"):
    """``max(x * scale + shift, 0)`` with per-channel f32 scale/shift over
    a 4-D activation; ``layout`` names the channel axis. The CUDA kernel
    on the card, the plain version on the CPU."""
    return _dispatch(x, scale, shift, layout, None)


def scale_shift_add_relu(x, scale, shift, residual, layout="NCHW"):
    """The residual tail ``max(x * scale + shift + residual, 0)``;
    ``residual`` has x's shape and dtype."""
    return _dispatch(x, scale, shift, layout, residual)


def fold_bn(scale, bias, rmean, rvar, eps):
    """Frozen-BN folding in f32: per-channel ``(s, b)`` with
    ``bn(x) == x * s + b``."""
    s2 = scale.float() * torch.rsqrt(rvar.float() + eps)
    b2 = bias.float() - rmean.float() * s2
    return s2, b2


def _folded(scale, bias, rmean, rvar, eps):
    """:func:`fold_bn` of one BN layer's states, kept on its
    ``running_var`` Tensor until one of the four tensors is replaced or
    written in place (torch's version counter says so): a serving forward
    then folds nothing, where folding every tick costs five small launches
    per tail."""
    parts = (scale.data, bias.data, rmean.data, rvar.data)
    cached = getattr(rvar, "_fold_cache", None)
    if cached is not None and cached[0] == eps and all(
            t is c and t._version == v
            for t, (c, v) in zip(parts, cached[1])):
        return cached[2]
    with torch.no_grad():       # the peephole runs outside training only
        folded = fold_bn(*parts, eps)
    rvar._fold_cache = (eps, tuple((t, t._version) for t in parts), folded)
    return folded


def try_relu_epilogue(x_tensor):
    """ReLU peephole: when ``x_tensor`` is a tagged inference-BN output, or
    a tagged BN-output + residual sum, and the epilogue is enabled and
    eligible, return the tail computed in one pass on the BN's input (+
    the residual); else None and the caller runs the plain ReLU.

    Declines, as the JAX package does: the epilogue not enabled; training
    (a frozen-stats BN still backprops through scale/bias); a non-4-D
    input; a residual that broadcasts (or, here, has another dtype)."""
    global fused_tails
    residual = None
    tag = getattr(x_tensor, "_bn_epilogue", None)
    if tag is None:
        add_tag = getattr(x_tensor, "_bn_add_epilogue", None)
        if add_tag is None:
            return None
        tag, residual = add_tag
    if not _ENABLED or is_training():
        return None
    xin, scale, bias, rmean, rvar, eps, layout = tag
    if xin.ndim != 4:
        return None
    if residual is not None and (tuple(residual.shape) != tuple(xin.shape)
                                 or residual.dtype != xin.dtype):
        return None
    s2, b2 = _folded(scale, bias, rmean, rvar, eps)
    if residual is not None:
        out = scale_shift_add_relu(xin.data, s2, b2, residual.data,
                                   layout=layout)
    else:
        out = scale_shift_relu(xin.data, s2, b2, layout=layout)
    fused_tails += 1
    from ..tensor import Tensor
    return Tensor(data=out, device=x_tensor.device)
