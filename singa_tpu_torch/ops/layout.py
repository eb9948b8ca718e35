"""Activation-layout selection for the 2-D CNN stack (NCHW vs NHWC).

Counterpart of ``singa_tpu/ops/layout.py``. Handles read the layout once
at construction. The public tensor API stays NCHW; a model that opts in
(``models.resnet.ResNet(layout="NHWC")``) transposes its input once at the
stem and runs the trunk on logical NHWC tensors, with weights still OIHW so
checkpoints are layout-independent. ``ops/conv.py`` feeds such a tensor to
``F.conv2d`` as a channels-last NCHW view.
"""

from __future__ import annotations

import contextlib
import os
from contextvars import ContextVar

_VALID = ("NCHW", "NHWC")


def _env_default() -> str:
    v = os.environ.get("SINGA_CONV_LAYOUT", "NCHW").upper()
    return v if v in _VALID else "NCHW"


_stack: ContextVar[tuple] = ContextVar("singa_tpu_torch_conv_layout",
                                       default=(_env_default(),))


def current_layout() -> str:
    return _stack.get()[-1]


def channel_axis(ndim: int = 4) -> int:
    """Channel axis of an activation under the current layout."""
    return 1 if current_layout() == "NCHW" or ndim == 2 else ndim - 1


def resolve(layout) -> str:
    """An explicit (validated) layout, or the ambient one."""
    v = (str(layout).upper() if layout else current_layout())
    if v not in _VALID:
        raise ValueError(f"layout must be one of {_VALID}, got {layout!r}")
    return v


@contextlib.contextmanager
def use_layout(layout: str):
    """Scope a layout for handle construction and deferred layer init."""
    layout = str(layout).upper()
    if layout not in _VALID:
        raise ValueError(f"layout must be one of {_VALID}, got {layout!r}")
    token = _stack.set(_stack.get() + (layout,))
    try:
        yield
    finally:
        _stack.reset(token)
