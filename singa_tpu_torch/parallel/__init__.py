"""Parallel training of the port (counterpart of ``singa_tpu/parallel``):
the data-parallel ``communicator`` (collectives over ``torch.distributed``)
and ``mesh`` (the ``data`` axis), ``gspmd`` (the train mesh and ZeRO/FSDP),
and the tensor-parallel layers in their single-device form. The sharded
forms and the other mesh axes are not ported yet (ROADMAP.md)."""

from . import communicator, gspmd, mesh, tensor_parallel  # noqa: F401
