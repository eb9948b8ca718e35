"""Collective communication over the ranks of a process group.

Counterpart of ``singa_tpu/parallel/communicator.py:126-300``. The JAX
package's collectives are XLA's over the mesh's ``data`` axis inside a
``shard_map``; the port's are ``torch.distributed``'s over a process
group, one process per rank: NCCL for ranks on CUDA devices, gloo when
the caller asks for the CPU (or names it).

- :func:`init_process` joins the process group. :class:`NcclIdHolder`
  holds where the ranks meet: ``MASTER_ADDR``/``MASTER_PORT`` or a file.
- :class:`Communicator` sums, gathers, scatters and broadcasts over the
  group, one ``torch.distributed`` call per collective, each counted by
  kind. Outside an initialised process group every collective is the
  identity and the world is 1, the JAX package's rule outside a mesh
  context: single-device scripts run unchanged.
- A collective reduces the tensor it is given in place and returns it.
  Started with ``async_op=True`` it stays in flight until :meth:`wait`
  (the reference's stream join, ``communicator.cc:169-186``).
- :func:`collective_context` marks the training step of a ``DistOpt``:
  inside it sync-BN (``ops/batchnorm.py``) averages its batch moments over
  the context's ranks through :meth:`Communicator.all_reduce_grad`, a sum
  whose backward sums the cotangents.
- The mesh context (``singa_tpu/parallel/communicator.py:40-120``):
  ``collective_context(*axis_names, mesh=...)`` marks the code within as
  running over those axes of a ``DeviceMesh`` (``parallel.mesh``), as the
  JAX package's marks a ``shard_map`` body; :func:`active_axis`,
  :func:`axis_size`, :func:`axis_index` and :func:`axis_group` read it
  (each axis is its process group, ``DeviceMesh.get_group``), and
  :func:`batch_shard_axes` / :func:`active_batch_axes`, :func:`get_mesh`,
  :func:`set_mesh` and :func:`partitioner` are the JAX package's. The
  differentiable collectives over an axis are ``parallel/ops.py``'s.
- ``Communicator(reduce_axes=("data", "seq"))`` sums over the ranks of
  every reduce axis of its mesh (one process group spanning them), as the
  JAX package's ``psum`` over an axis tuple does.
- :func:`rescale_batch` and :func:`replica_fingerprint` are the JAX
  package's.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["NcclIdHolder", "init_process", "Communicator",
           "collective_context", "active_communicator", "active_axis",
           "axis_size", "axis_index", "axis_group", "axes_group_of",
           "batch_shard_axes", "active_batch_axes", "get_mesh", "set_mesh",
           "partitioner", "rescale_batch", "replica_fingerprint"]


# the tensor forms of all-gather and reduce-scatter (torch 2.13 renamed
# them and warns on the old names; the card's torch 2.11 has the old ones)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def gather_over(x, group, dim=0):
    """The ranks' ``x`` of ``group`` concatenated along ``dim``, in rank
    order: one all-gather into a new tensor. Along a ``dim`` other than 0
    the pieces are gathered with that dimension moved to the front and
    the result is moved back (a copy). What :meth:`Communicator.all_gather`
    and ``parallel/ops.py``'s ``gather`` run."""
    dim = dim % x.dim()
    src = (x if dim == 0 else x.movedim(dim, 0)).contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    _ALL_GATHER(out, src, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def scatter_sum_over(x, group, dim=0):
    """This rank's slice along ``dim`` of the sum of ``group``'s ``x``
    (the slices in rank order): one reduce-scatter into a new tensor; the
    size along ``dim`` must divide by the group's ranks. What
    :meth:`Communicator.reduce_scatter` and ``parallel/ops.py``'s
    ``psum_scatter`` run."""
    dim = dim % x.dim()
    world = dist.get_world_size(group)
    src = (x if dim == 0 else x.movedim(dim, 0)).contiguous()
    if src.shape[0] % world:
        raise ValueError(
            f"reduce_scatter: dimension {dim} of {tuple(x.shape)} does not "
            f"divide over {world} ranks")
    out = src.new_empty((src.shape[0] // world,) + tuple(src.shape[1:]))
    _REDUCE_SCATTER(out, src, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


class NcclIdHolder:
    """Where the ranks meet (the reference's ``NcclIdHolder``,
    ``include/singa/io/communicator.h:69``): a shared ``file`` path, else
    ``coordinator_address`` (``host:port``), else ``MASTER_ADDR`` and
    ``MASTER_PORT`` from the environment (``torchrun`` sets them)."""

    def __init__(self, coordinator_address: str | None = None,
                 file: str | None = None):
        self.file = file
        self.coordinator_address = coordinator_address or "{}:{}".format(
            os.environ.get("MASTER_ADDR", "localhost"),
            os.environ.get("MASTER_PORT", "29500"))

    @property
    def init_method(self) -> str:
        if self.file is not None:
            return f"file://{os.path.abspath(self.file)}"
        return f"tcp://{self.coordinator_address}"


def init_process(nccl_id: NcclIdHolder | None = None, rank: int = 0,
                 world: int = 1, device=None, backend=None, timeout_s=300):
    """Join the process group as ``rank`` of ``world`` (the reference's
    MPI rank exchange, ``communicator.cc:73-103``).

    ``device`` is the rank's port :class:`~..device.Device` or a
    ``torch.device``; by default the card ``cuda:LOCAL_RANK``, which raises
    without CUDA. The backend is NCCL for a CUDA device and gloo for the
    CPU, or ``backend`` when given (``"gloo"`` runs CUDA tensors through
    host copies and cannot be captured in a CUDA graph). Under NCCL the
    device is made current and passed as ``device_id``, so the
    communicator is made here, eagerly, and never inside a capture."""
    from .. import device as device_mod
    if device is None:
        device = device_mod.create_cuda_gpu(
            int(os.environ.get("LOCAL_RANK", 0)))
    tdev = torch.device(getattr(device, "torch_device", device))
    if backend is None:
        backend = "nccl" if tdev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        if tdev.type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, not {tdev}")
        torch.cuda.set_device(tdev)
        kw["device_id"] = tdev
    dist.init_process_group(
        backend, init_method=(nccl_id or NcclIdHolder()).init_method,
        rank=int(rank), world_size=int(world),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the cotangents: the
    transpose of a replicated sum (what ``lax.pmean`` differentiates to in
    the JAX package's sync-BN)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone()), None


class Communicator:
    """All-reduce (and friends) over the ranks of the ``data`` axis: the
    process group of ``mesh`` (a ``DeviceMesh`` from ``mesh.make_mesh``),
    else the default one.

    Reference op mapping (``src/io/communicator.cc``): ``synch`` ->
    :meth:`all_reduce`; ``fusedSynch`` -> ``DistOpt``'s buckets;
    ``synchHalf`` -> a 16-bit all-reduce (``DistOpt`` casts);
    ``sparsification`` -> a masked dense all-reduce (``DistOpt``);
    ``wait`` -> :meth:`wait`. ZeRO/FSDP (``parallel.gspmd``) gathers
    parameters with :meth:`all_gather` and scatters gradients with
    :meth:`reduce_scatter`.

    Each collective is one ``torch.distributed`` call into a preallocated
    output: ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` (named
    ``all_gather_single`` and ``reduce_scatter_single`` from torch 2.13 on;
    the names are picked once, from the torch release). Both backends the
    port runs take every one of them for the tensors it hands them: NCCL
    for CUDA tensors, gloo for CPU tensors and, on torch 2.11, for CUDA
    tensors too (``chip_smoke.py`` phase 18 (b) runs them so on the card). So no backend needs another
    form of a collective. ``counts`` holds the collectives started, by kind
    (``all_reduce``, ``all_gather``, ``reduce_scatter``, ``broadcast``),
    and ``n_collectives`` their sum: host calls (a CUDA-graph replay runs
    what its capture counted)."""

    KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")

    def __init__(self, axis_name: str = "data", world_size=None,
                 mesh=None, reduce_axes=None):
        self.axis_name = axis_name
        # the axes gradients are summed over: the data axis and any other
        # batch-like one (sequence parallelism splits the tokens, so
        # 'seq' joins the reduction)
        self.reduce_axes = tuple(reduce_axes) if reduce_axes is not None \
            else (axis_name,)
        self.mesh = mesh
        self.local_rank = int(os.environ.get("LOCAL_RANK", 0))
        if world_size is not None and \
                int(world_size) != self.effective_world_size():
            raise ValueError(
                f"world_size={world_size} disagrees with the process "
                f"group's {self.effective_world_size()} ranks (1 outside "
                "one): the world is the group's, pass None")
        self.counts = dict.fromkeys(self.KINDS, 0)
        self._pending = []

    @property
    def n_collectives(self) -> int:
        """Every collective started, all kinds together."""
        return sum(self.counts.values())

    @property
    def world_size(self) -> int:
        """The data axis's ranks: :meth:`effective_world_size`."""
        return self.effective_world_size()

    @property
    def global_rank(self) -> int:
        return dist.get_rank() if initialized() else 0

    def _reduce_axes(self, exclude=()):
        return tuple(a for a in self.reduce_axes if a not in exclude)

    def _one_rank(self, axes):
        """Whether ``axes`` (other than the data axis alone) span this rank
        only: none of the mesh's is above degree 1, or, without a mesh,
        the process group is of one rank."""
        if axes == (self.axis_name,):
            return False
        if self.mesh is None:
            return dist.get_world_size() == 1
        from .mesh import axis_sizes
        sizes = axis_sizes(self.mesh)
        return all(sizes.get(a, 1) <= 1 for a in axes)

    def _group_of(self, axes):
        """The process group over ``axes`` of the mesh (None: the default
        group, without a mesh)."""
        if self.mesh is None:
            return None
        if axes == (self.axis_name,):
            return self.mesh.get_group(self.axis_name)
        from .mesh import axes_group
        return axes_group(self.mesh, axes)

    @property
    def group(self):
        """The process group gradients are summed over: the reduce axes'
        ranks of the mesh (the data axis's by default), the default group
        without a mesh."""
        return self._group_of(self.reduce_axes)

    @property
    def axis_group(self):
        """The process group of the data axis alone (gathers, scatters,
        broadcasts and the rank)."""
        return self._group_of((self.axis_name,))

    def active(self, exclude=()) -> bool:
        """Whether collectives run: a process group is initialised and
        some reduce axis is not excluded."""
        return initialized() and bool(self._reduce_axes(exclude))

    @property
    def backend(self):
        return dist.get_backend(self.group) if initialized() else None

    def effective_world_size(self, exclude=()) -> int:
        """Ranks taking part in a gradient sum: the size of the group of
        the reduce axes not in ``exclude``, 1 outside a process group."""
        if not self.active(exclude) or \
                self._one_rank(self._reduce_axes(exclude)):
            return 1
        return dist.get_world_size(self._group_of(
            self._reduce_axes(exclude)))

    def _count(self, kind, work=None, async_op=False):
        self.counts[kind] += 1
        if async_op:
            self._pending.append(work)

    # -- collectives (identity outside a process group) -------------------
    def all_reduce(self, arr, exclude=(), async_op=False):
        """Sum ``arr`` over the ranks, in place; returns ``arr``."""
        if self.active(exclude):
            axes = self._reduce_axes(exclude)
            if self._one_rank(axes):
                return arr      # reduce axes of one rank: a sum of one
            self._count("all_reduce", dist.all_reduce(
                arr, group=self._group_of(axes), async_op=async_op),
                async_op)
        return arr

    def all_reduce_grad(self, arr):
        """:meth:`all_reduce` on a copy of ``arr``, differentiable: the
        backward sums the cotangents over the ranks."""
        if not self.active():
            return arr
        return _AllReduceSum.apply(arr, self)

    def all_gather(self, arr, axis=0):
        """The ranks' ``arr`` concatenated along ``axis``, in rank order: a
        new tensor (``arr`` itself outside a process group). Along an
        ``axis`` other than 0 the ranks' pieces are gathered with that
        axis moved to the front, and the result is moved back (a copy)."""
        if not self.active():
            return arr
        out = gather_over(arr, self.axis_group, axis)
        self._count("all_gather")
        return out

    def reduce_scatter(self, arr, axis=0):
        """This rank's slice along ``axis`` of the sum of the ranks' ``arr``
        (the slices in rank order): a new tensor (``arr`` itself outside a
        process group). ``arr``'s size along ``axis`` must divide by the
        world; ``arr`` may be overwritten. Along an ``axis`` other than 0
        the sum is taken with that axis moved to the front (a copy)."""
        if not self.active():
            return arr
        out = scatter_sum_over(arr, self.axis_group, axis)
        self._count("reduce_scatter")
        return out

    def broadcast(self, arr, root=0):
        """``arr`` of rank ``root`` on every rank, in place."""
        if self.active():
            group = self.axis_group
            dist.broadcast(arr, src=root if group is None else
                           dist.get_global_rank(group, root), group=group)
            self._count("broadcast")
        return arr

    def barrier(self):
        """Wait for every rank of the group (no collective is counted)."""
        if self.active():
            dist.barrier(group=self.axis_group)

    def rank(self) -> int:
        return dist.get_rank(self.axis_group) if self.active() else 0

    def wait(self):
        """Join every collective started with ``async_op=True``: the
        current stream waits for them (a gloo one blocks the host)."""
        pending, self._pending = self._pending, []
        for work in pending:
            work.wait()


_ACTIVE: list = []
# (mesh, axis names) of each enclosing axis context, innermost last
_ACTIVE_AXES: list = []
# the axes sharding the batch dimension, per enclosing step
_BATCH_SHARD_AXES: list = []
_global_mesh = None


@contextlib.contextmanager
def collective_context(*args, mesh=None):
    """Two forms. ``collective_context(communicator)`` marks the code
    within as one rank's share of a data-parallel step over
    ``communicator`` (``Model``'s train step under a ``DistOpt``);
    ``None`` is a no-op. ``collective_context(*axis_names, mesh=None)``
    marks it as running over those axes of ``mesh`` (default: the
    process-wide mesh of :func:`set_mesh`), as the JAX package's marks a
    ``shard_map`` body: inside, the collectives of ``parallel/ops.py``
    over an axis of the mesh run, and outside they are the identity."""
    if args and isinstance(args[0], str):
        m = mesh if mesh is not None else _global_mesh
        _ACTIVE_AXES.append((m, tuple(args)))
        try:
            yield
        finally:
            _ACTIVE_AXES.pop()
        return
    communicator = args[0] if args else None
    if communicator is None:
        yield
        return
    _ACTIVE.append(communicator)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_communicator():
    """The innermost :func:`collective_context`'s communicator, or
    None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _frame(axis_name):
    for m, axes in reversed(_ACTIVE_AXES):
        if axis_name in axes:
            if m is not None and axis_name in (m.mesh_dim_names or ()):
                return m
            return None
    return None


def active_axis(axis_name: str) -> bool:
    """Whether ``axis_name`` is an axis of the mesh of an enclosing axis
    context (:func:`collective_context` with axis names)."""
    return _frame(axis_name) is not None


def axis_size(axis_name: str) -> int:
    """The degree of an active axis; 1 for one that is not active."""
    m = _frame(axis_name)
    if m is None:
        return 1
    return int(dict(zip(m.mesh_dim_names, m.mesh.shape))[axis_name])


def axis_index(axis_name: str) -> int:
    """This rank's coordinate on an active axis (``lax.axis_index``); 0
    on one that is not active."""
    from .mesh import axis_rank
    return axis_rank(_frame(axis_name), axis_name)


def axis_group(axis_name: str):
    """The process group of an active axis: this rank and those that
    differ from it only along the axis."""
    m = _frame(axis_name)
    if m is None:
        raise RuntimeError(f"mesh axis {axis_name!r} is not active")
    return m.get_group(axis_name)


def axes_group_of(axes):
    """The process group of this rank and the ranks that differ from it
    only along the active axes among ``axes`` (one mesh's, row-major over
    them, as ``lax.psum`` over an axis tuple spans them), or None when
    none is active."""
    from .mesh import axes_group
    live = tuple(a for a in axes if active_axis(a))
    if not live:
        return None
    meshes = {id(_frame(a)) for a in live}
    if len(meshes) != 1:
        raise RuntimeError(f"axes {live} are active over different meshes")
    return axes_group(_frame(live[0]), live)


@contextlib.contextmanager
def batch_shard_axes(axes):
    """Declare the mesh axes sharding the batch dimension for the code
    within (``Model``'s step enters it from its input specs)."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    _BATCH_SHARD_AXES.append(axes)
    try:
        yield
    finally:
        _BATCH_SHARD_AXES.pop()


def active_batch_axes() -> tuple:
    """The axes cross-replica batch statistics reduce over: the declared
    batch-shard axes (default ``data``) that are active."""
    axes = _BATCH_SHARD_AXES[-1] if _BATCH_SHARD_AXES else ("data",)
    return tuple(a for a in axes if a is not None and active_axis(a))


def get_mesh(config=None):
    """The process-wide mesh: the one :func:`set_mesh` gave, else (and
    whenever ``config`` is given) one made by ``parallel.mesh.make_mesh``
    over every rank of the process group."""
    global _global_mesh
    if _global_mesh is None or config is not None:
        from .mesh import make_mesh
        _global_mesh = make_mesh(config=config)
    return _global_mesh


def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None) the process-wide mesh."""
    global _global_mesh
    _global_mesh = mesh


def process_mesh():
    """The mesh :func:`set_mesh` gave, or None (never makes one)."""
    return _global_mesh


def partitioner(mesh=None, batch_axis="data", model_axis="model"):
    """The JAX package's shim onto ``gspmd.Partitioner``: its serving
    partitioner, which the port has not yet (``gspmd.Partitioner``
    raises, naming ROADMAP.md: slice D)."""
    from .gspmd import Partitioner
    return Partitioner(mesh if mesh is not None else get_mesh(),
                       batch_axis=batch_axis, model_axis=model_axis)


def rescale_batch(manifest, new_world):
    """Data-parallel batch accounting across an elastic restart: the
    per-replica batch a checkpoint's manifest records (or its global batch
    over its ``world``) is kept, and the global batch scales with the new
    world. Returns ``(per_replica, new_global)``, ``(None, None)`` when
    the manifest has no batch size."""
    saved_world = max(1, int(manifest.get("world", 1)))
    per = manifest.get("per_replica_batch")
    if per is None:
        gb = manifest.get("global_batch")
        if gb is None:
            return None, None
        per = max(1, int(gb) // saved_world)
    return int(per), int(per) * int(new_world)


def replica_fingerprint(arrays, communicator=None):
    """Cross-replica fingerprint of ``arrays`` (Tensors or torch tensors):
    each rank reduces every array to its sum and sum of squares in f32 and
    the ranks all-gather those vectors. Returns ``(gathered, agree)``:
    ``gathered`` is ``(world, 2 * len(arrays))``, ``agree`` a 0-d bool,
    True when every row equals the first as int32 bit patterns (a NaN
    computed alike agrees). Outside a process group: the local vector and
    True."""
    comm = communicator or Communicator()
    parts = []
    for a in arrays:
        x = getattr(a, "data", a).detach().float()
        parts += [x.sum(), (x * x).sum()]
    dev = parts[0].device if parts else None
    vec = torch.stack(parts) if parts else torch.zeros(0, device=dev)
    if not comm.active():
        return vec[None], torch.ones((), dtype=torch.bool, device=dev)
    gathered = comm.all_gather(vec[None], axis=0)
    bits = gathered.view(torch.int32)
    return gathered, (bits == bits[0:1]).all()
