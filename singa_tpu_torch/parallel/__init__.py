"""Parallel layers of the port (counterpart of ``singa_tpu/parallel``):
the tensor-parallel layers in their single-device form. Meshes,
collectives and the sharded forms are not ported yet (ROADMAP.md)."""

from . import tensor_parallel  # noqa: F401
