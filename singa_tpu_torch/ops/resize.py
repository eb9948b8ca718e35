"""ONNX Resize (``singa_tpu/ops/resize.py``): not ported yet. Its one
caller in the JAX package is ``sonnx.py``, and it comes with that slice
(ROADMAP.md: slice E, with sonnx).
"""


def _not_ported(*args, **kwargs):
    raise NotImplementedError(
        "ops.resize is not ported yet (ROADMAP.md: slice E, with sonnx)")


class ResizeHandle:
    def __init__(self, *args, **kwargs):
        _not_ported()


def resize(*args, **kwargs):
    _not_ported()
