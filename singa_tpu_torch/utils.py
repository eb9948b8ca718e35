"""Misc helpers: the completion barrier, the progress bar, ONNX-style
padding math, tape walking.

Counterpart of ``singa_tpu/utils.py``: ``force_completion``,
``update_progress``, the odd/SAME padding helpers that the conv and pool
layers use for ONNX ``auto_pad`` (``ops/conv.py`` takes its SAME pads from
:func:`same_pads`), ``force_unicode`` and a post-order tape traversal.
The conv and pool handles take explicit ((top, bottom), (left, right))
pad pairs and torch differentiates through them, so
``handle_odd_pad_fwd`` is a plain asymmetric pad and needs no backward
twin.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from .tensor import Tensor

__all__ = ["force_completion", "update_progress", "same_pads",
           "get_padding_shape", "get_output_shape", "handle_odd_pad_fwd",
           "same_pad_shape_check", "force_unicode", "post_order_recursive"]


def _leaves(x):
    """The torch tensors of a Tensor, a torch tensor, or a list, tuple or
    dict of them (nested)."""
    if isinstance(x, Tensor):
        return [x.data]
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def force_completion(x) -> float:
    """Completion barrier: fetch one element of an output to the host.
    The value does not exist until the work that makes it has run, so the
    fetch waits for it (one ``.item()`` of a one-element slice; on the
    card it waits for the stream that computed it, not only for the
    default stream). One leaf suffices: the leaves of one step's outputs
    come from one stream. Accepts a Tensor, a torch tensor or a list,
    tuple or dict of them; returns the fetched element as a float.
    With no element to fetch it synchronizes the devices the leaves live
    on and returns 0.0."""
    leaves = _leaves(x)
    for leaf in leaves:
        if leaf.numel():
            return float(leaf.detach().reshape(-1)[:1].float().sum().item())
    for leaf in leaves:
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
    return 0.0


def update_progress(progress: float, info: str = "") -> None:
    """Render a textual progress bar; ``progress`` in [0, 1], where 1.0
    appends Done."""
    length = 20
    progress = max(0.0, min(1.0, float(progress)))
    filled = int(round(length * progress))
    bar = "#" * filled + "-" * (length - filled)
    status = " Done." if progress >= 1.0 else ""
    sys.stdout.write(f"\r[{bar}] {progress * 100:3.1f}% {info}{status}")
    sys.stdout.flush()
    if progress >= 1.0:
        sys.stdout.write("\n")


def same_pads(size, k, s, d=1, lower=False):
    """SAME padding of one axis as (begin, end): the output is
    ceil(size / s); the odd pixel goes at the end (SAME_UPPER) or at the
    beginning (SAME_LOWER). ``d`` is the dilation."""
    out = -(-size // s)
    total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
    small, big = total // 2, total - total // 2
    return (big, small) if lower else (small, big)


def get_padding_shape(pad_mode, input_spatial_shape, kernel_spatial_shape,
                      strides_spatial):
    """ONNX auto_pad ('SAME_UPPER'/'SAME_LOWER') -> per-dim (begin, end)
    pads."""
    return [same_pads(d, k, s, lower=pad_mode == "SAME_LOWER")
            for d, k, s in zip(input_spatial_shape, kernel_spatial_shape,
                               strides_spatial)]


def get_output_shape(auto_pad, input_spatial_shape, kernel_spatial_shape,
                     strides_spatial):
    """Spatial output shape under an ONNX auto_pad mode."""
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        return [(d + s - 1) // s
                for d, s in zip(input_spatial_shape, strides_spatial)]
    if auto_pad == "VALID":
        return [(d - k) // s + 1
                for d, k, s in zip(input_spatial_shape,
                                   kernel_spatial_shape, strides_spatial)]
    raise ValueError(f"unsupported auto_pad {auto_pad}")


def handle_odd_pad_fwd(x, odd_padding, is_pool=False):
    """Apply an asymmetric (top, bottom, left, right) pad to NCHW data,
    with -inf for a pool and 0 otherwise. A Tensor goes through the
    differentiable ``autograd.pad``; a numpy array or torch tensor comes
    back as a padded torch tensor."""
    t, b, l, r = odd_padding
    fill = float("-inf") if is_pool else 0.0
    if isinstance(x, Tensor):
        from . import autograd
        # pads layout: begin per dim, then end per dim (N, C, H, W)
        return autograd.pad(x, "constant", [0, 0, t, l, 0, 0, b, r], fill)
    xa = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                         else x)
    return F.pad(xa, (l, r, t, b), value=fill)


def same_pad_shape_check(handle, pad_mode, x):
    """Whether the handle's explicit pads equal the auto_pad-derived ones.
    ``ConvHandle`` keeps ((t, b), (l, r)) in ``padding``,
    ``PoolingHandle`` in ``pad_pairs``."""
    spatial = x.shape[2:]
    expect = get_padding_shape(pad_mode, spatial, handle.kernel_size,
                               handle.stride)
    got = getattr(handle, "pad_pairs", None)
    if got is None:
        got = handle.padding
    return tuple(map(tuple, got)) == tuple(map(tuple, expect))


def force_unicode(s):
    """bytes -> str; anything else through ``str``."""
    if isinstance(s, bytes):
        return s.decode("utf-8", errors="replace")
    return str(s)


def post_order_recursive(root, visit):
    """Post-order walk over a tape from a root op, calling ``visit(op)``
    per op. Iterative, so a deep tape does not hit the recursion
    limit."""
    seen = set()
    stack = [(root, False)]
    while stack:
        op, expanded = stack.pop()
        if op is None:
            continue
        if expanded:
            visit(op)
            continue
        if id(op) in seen:
            continue
        seen.add(id(op))
        stack.append((op, True))
        for (src_op, _x, _t, _r) in getattr(op, "src", []):
            if src_op is not None and id(src_op) not in seen:
                stack.append((src_op, False))
