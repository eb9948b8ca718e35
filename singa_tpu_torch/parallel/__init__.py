"""Parallel training of the port (counterpart of ``singa_tpu/parallel``):
``communicator`` (collectives over ``torch.distributed`` and the mesh's
axis context), ``mesh`` (the ``data``, ``expert``, ``seq`` and ``model``
axes), ``ops`` (the differentiable collectives over a mesh axis),
``gspmd`` (the train mesh and ZeRO/FSDP), the tensor-parallel layers and
``moe`` (the Mixture-of-Experts FFN over the ``expert`` axis). Pipeline
stages are not ported yet (ROADMAP.md)."""

from . import (communicator, gspmd, mesh, moe, ops,  # noqa: F401
               tensor_parallel)
