"""The device mesh of data-parallel training.

Counterpart of ``singa_tpu/parallel/mesh.py:18-93``. :class:`MeshConfig`
and its :meth:`~MeshConfig.degrees` are the JAX package's own (one axis
table: ``data``, ``expert``, ``seq``, ``pipe``, ``model``). The port runs
the ``data`` axis only: :func:`make_mesh` builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised process group (``parallel.communicator.init_process``), and a
``model``, ``pipe``, ``seq`` or ``expert`` degree above 1 raises
(ROADMAP.md, slice C2). :func:`axis_sizes` reads a mesh as the JAX
package's axis table, the unported axes at degree 1, as the JAX package
keeps them; ``parallel.gspmd.train_mesh`` builds its mesh through
:func:`make_mesh`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch.distributed as dist

__all__ = ["MeshConfig", "make_mesh", "elastic_mesh", "axis_sizes"]


@dataclass
class MeshConfig:
    """Logical parallelism degrees; -1 on ``data`` means "everything
    left"."""

    data: int = -1      # dp replicas
    model: int = 1      # tp shards
    pipe: int = 1       # pp stages
    seq: int = 1        # sp shards
    expert: int = 1     # ep shards

    axis_order: tuple = ("data", "expert", "seq", "pipe", "model")

    def degrees(self, n_devices: int):
        fixed = {"model": self.model, "pipe": self.pipe, "seq": self.seq,
                 "expert": self.expert}
        rest = n_devices
        for v in fixed.values():
            if rest % v:
                raise ValueError(
                    f"{n_devices} devices not divisible by {fixed}")
            rest //= v
        data = self.data if self.data != -1 else rest
        if data * self.model * self.pipe * self.seq * self.expert \
                != n_devices:
            raise ValueError(f"mesh {self} does not cover {n_devices} "
                             "devices")
        return {"data": data, "expert": self.expert, "seq": self.seq,
                "pipe": self.pipe, "model": self.model}


def _world():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh spans the ranks of a process group: call "
            "parallel.communicator.init_process first")
    return dist.get_world_size()


def make_mesh(device_type=None, config: MeshConfig | None = None):
    """A one-axis ``DeviceMesh`` named ``data`` over every rank of the
    process group. ``device_type`` defaults to ``"cuda"`` under NCCL and
    ``"cpu"`` otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    deg = (config or MeshConfig()).degrees(_world())
    sharded = {a: n for a, n in deg.items() if a != "data" and n > 1}
    if sharded:
        raise NotImplementedError(
            f"mesh axes {sharded}: only the data axis is ported; tensor, "
            "pipeline, sequence and expert parallelism are not (ROADMAP.md:"
            " slice C2)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (deg["data"],),
                            mesh_dim_names=("data",))


def elastic_mesh(device_type=None, config: MeshConfig | None = None,
                 saved_world: int | None = None):
    """:func:`make_mesh` for a restart whose world may differ from the
    checkpoint's ``saved_world``: the data axis absorbs the change, and a
    mismatch is warned, not an error."""
    world = _world()
    if saved_world is not None and int(saved_world) != world:
        warnings.warn(
            f"elastic mesh: data-parallel degree is now {world} "
            f"(checkpoint was saved at {saved_world}); state will be "
            "re-sharded onto the new mesh on restore", stacklevel=2)
    return make_mesh(device_type, config)


def axis_sizes(mesh) -> dict:
    """``{axis name: degree}`` of ``mesh`` over every axis of
    :class:`MeshConfig` (the JAX package's ``mesh.shape``): a
    ``DeviceMesh``'s named dimensions, the others at 1. A mapping is
    taken as such a table already."""
    if hasattr(mesh, "mesh_dim_names"):
        named = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    else:
        named = dict(mesh)
    table = dict.fromkeys(MeshConfig.axis_order, 1)
    table.update({k: int(v) for k, v in named.items()})
    return table
