"""The device mesh of parallel training.

Counterpart of ``singa_tpu/parallel/mesh.py:18-93``. :class:`MeshConfig`
and its :meth:`~MeshConfig.degrees` are the JAX package's own (one axis
table: ``data``, ``expert``, ``seq``, ``pipe``, ``model``).
:func:`make_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the initialised process group
(``parallel.communicator.init_process``) with the ``data`` axis and every
other axis whose degree is above 1, in the JAX package's axis order and
rank layout (row-major, ``model`` innermost: rank r holds the shard that
JAX device r holds, so weights carry across shard for shard). The
``data``, ``expert``, ``seq`` and ``model`` axes run; a ``pipe`` degree
above 1 raises (ROADMAP.md: pipeline stages, slice E). :func:`axis_sizes`
reads a mesh as the JAX package's axis table, the absent axes at degree
1, as the JAX package keeps them; :func:`axis_rank` is a rank's
coordinate on an axis and :func:`axes_group` the process group of the
ranks that differ only along some axes. ``parallel.gspmd.train_mesh``
builds its mesh through :func:`make_mesh`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch.distributed as dist

__all__ = ["MeshConfig", "make_mesh", "elastic_mesh", "axis_sizes",
           "axis_rank", "axes_group"]


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
    """A ``DeviceMesh`` over every rank of the process group: the
    ``data`` axis and each other axis of degree above 1, in
    :attr:`MeshConfig.axis_order` (a data-only config gives the one-axis
    mesh named ``data``). ``device_type`` defaults to ``"cuda"`` under
    NCCL and ``"cpu"`` otherwise. A ``pipe`` degree above 1 raises."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = config or MeshConfig()
    deg = cfg.degrees(_world())
    if deg["pipe"] > 1:
        raise NotImplementedError(
            f"mesh axis pipe={deg['pipe']}: pipeline stages "
            "(parallel/pipeline.py) are not ported yet (ROADMAP.md: slice "
            "E)")
    names = tuple(a for a in cfg.axis_order if a == "data" or deg[a] > 1)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(deg[a] for a in names),
                            mesh_dim_names=names)


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


def axis_rank(mesh, axis) -> int:
    """This rank's coordinate on ``axis`` of ``mesh`` (0 on an axis the
    mesh lacks, or with no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def axes_group(mesh, axes):
    """The process group of this rank and the ranks that differ from it
    only along ``axes`` (names of ``mesh``; absent or degree-1 axes are
    dropped), ordered row-major over those axes as the JAX package's
    collectives over an axis tuple are. One axis is ``mesh.get_group``;
    several are made once per mesh, by every rank in the same order
    (``torch.distributed.new_subgroups_by_enumeration``); none is the
    first axis's group (of one rank only when that axis's degree is 1:
    the caller checks the degrees)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    live = tuple(a for a in names if a in axes and sizes[a] > 1)
    if len(live) <= 1:
        return mesh.get_group(live[0] if live else names[0])
    cache = mesh.__dict__.setdefault("_singa_axes_groups", {})
    if live not in cache:
        ranks = mesh.mesh
        keep = [names.index(a) for a in live]
        rest = [i for i in range(len(names)) if i not in keep]
        n = 1
        for a in live:
            n *= int(sizes[a])
        rows = ranks.permute(*rest, *keep).reshape(-1, n).tolist()
        cache[live] = dist.new_subgroups_by_enumeration(rows)[0]
    return cache[live]
