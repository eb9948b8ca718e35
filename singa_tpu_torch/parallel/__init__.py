"""Parallel training of the port (counterpart of ``singa_tpu/parallel``):
``communicator`` (collectives over ``torch.distributed`` and the mesh's
axis context), ``mesh`` (the ``data``, ``seq`` and ``model`` axes),
``ops`` (the differentiable collectives over a mesh axis), ``gspmd`` (the
train mesh and ZeRO/FSDP) and the tensor-parallel layers. The expert axis
(``moe``) and pipeline stages are not ported yet (ROADMAP.md)."""

from . import communicator, gspmd, mesh, ops, tensor_parallel  # noqa: F401
