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
           "collective_context", "active_communicator", "rescale_batch",
           "replica_fingerprint"]


# the tensor forms of all-gather and reduce-scatter (torch 2.13 renamed
# them and warns on the old names; the card's torch 2.11 has the old ones)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


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
        self.reduce_axes = tuple(reduce_axes) if reduce_axes is not None \
            else (axis_name,)
        if self.reduce_axes != (axis_name,):
            raise NotImplementedError(
                f"reduce_axes {self.reduce_axes}: only the {axis_name!r} "
                "axis is ported; gradients summed over sequence- or "
                "expert-sharded axes are not (ROADMAP.md: slice C2)")
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

    @property
    def group(self):
        return self.mesh.get_group(self.axis_name) \
            if self.mesh is not None else None

    def active(self, exclude=()) -> bool:
        """Whether collectives run: a process group is initialised and
        the data axis is not excluded."""
        return initialized() and self.axis_name not in exclude

    @property
    def backend(self):
        return dist.get_backend(self.group) if initialized() else None

    def effective_world_size(self, exclude=()) -> int:
        """Ranks taking part in a collective: the group's size, 1 outside
        a process group."""
        return dist.get_world_size(self.group) if self.active(exclude) \
            else 1

    def _count(self, kind, work=None, async_op=False):
        self.counts[kind] += 1
        if async_op:
            self._pending.append(work)

    # -- collectives (identity outside a process group) -------------------
    def all_reduce(self, arr, exclude=(), async_op=False):
        """Sum ``arr`` over the ranks, in place; returns ``arr``."""
        if self.active(exclude):
            self._count("all_reduce", dist.all_reduce(
                arr, group=self.group, async_op=async_op), async_op)
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
        src = (arr if axis == 0 else arr.movedim(axis, 0)).contiguous()
        out = src.new_empty((self.effective_world_size() * src.shape[0],)
                            + tuple(src.shape[1:]))
        _ALL_GATHER(out, src, group=self.group)
        self._count("all_gather")
        return out if axis == 0 else out.movedim(0, axis).contiguous()

    def reduce_scatter(self, arr, axis=0):
        """This rank's slice along ``axis`` of the sum of the ranks' ``arr``
        (the slices in rank order): a new tensor (``arr`` itself outside a
        process group). ``arr``'s size along ``axis`` must divide by the
        world; ``arr`` may be overwritten. Along an ``axis`` other than 0
        the sum is taken with that axis moved to the front (a copy)."""
        if not self.active():
            return arr
        world = self.effective_world_size()
        src = (arr if axis == 0 else arr.movedim(axis, 0)).contiguous()
        if src.shape[0] % world:
            raise ValueError(
                f"reduce_scatter: dimension {axis} of {tuple(arr.shape)} "
                f"does not divide over {world} ranks")
        out = src.new_empty((src.shape[0] // world,)
                            + tuple(src.shape[1:]))
        _REDUCE_SCATTER(out, src, group=self.group)
        self._count("reduce_scatter")
        return out if axis == 0 else out.movedim(0, axis).contiguous()

    def broadcast(self, arr, root=0):
        """``arr`` of rank ``root`` on every rank, in place."""
        if self.active():
            dist.broadcast(arr, src=root, group=self.group)
            self._count("broadcast")
        return arr

    def barrier(self):
        """Wait for every rank of the group (no collective is counted)."""
        if self.active():
            dist.barrier(group=self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group) if self.active() else 0

    def wait(self):
        """Join every collective started with ``async_op=True``: the
        current stream waits for them (a gloo one blocks the host)."""
        pending, self._pending = self._pending, []
        for work in pending:
            work.wait()


_ACTIVE: list = []


@contextlib.contextmanager
def collective_context(communicator):
    """Marks the code within as one rank's share of a data-parallel step
    over ``communicator`` (``Model``'s train step under a ``DistOpt``);
    ``None`` is a no-op."""
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
