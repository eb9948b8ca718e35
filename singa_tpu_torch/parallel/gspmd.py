"""The train mesh and ZeRO/FSDP: one sharding vocabulary for training.

Counterpart of the training half of ``singa_tpu/parallel/gspmd.py``: the
axis names (``:44-49``), :class:`ShardingDecline` (``:52``), the spec
vocabulary (``:62-100``), :func:`fit_state_spec` (``:103-127``),
:func:`fsdp_state_spec` (``:130-163``), :func:`train_mesh` (``:203-232``)
and :class:`Partitioner`'s byte accounting (``:350-371``), as the port's
own copies. A PartitionSpec here is :class:`PartitionSpec` (``P``), a
tuple of axis names (or None) per dimension, and a mesh is a
``DeviceMesh`` (``parallel.mesh``) or a ``{axis: degree}`` mapping.

The JAX package jits one program over the global batch and XLA
partitions it. The port's ranks are processes, each with its slice of
the global batch, as under ``opt.DistOpt``. ``Model.compile(mesh=...,
fsdp_axis=...)`` trains through a :class:`MeshStep`: the step runs inside
the mesh's collective context (sync-BN's moments are global), the
gradients are averaged over the data ranks by ``DistOpt.reduced_mean``
(the model's ``DistOpt``, or one made around a plain optimizer, as XLA
averages them for the JAX package), a dropout mask is drawn for the
global batch and each rank keeps its rows, and the loss comes back as the
mean over the ranks.

With ``fsdp_axis`` a :class:`ShardedLayout` holds the model's trainable
parameters, and the optimizer states that mirror them (``<param>:<kind>``,
the f32 masters under ``bf16_mixed`` being the parameters themselves), as
shards: a parameter's data between steps is this rank's contiguous slice
along the dimension :func:`fsdp_state_spec` shards, and its
``Tensor.sharding`` is ``(cuts, full shape)``, the cuts ``(layout, dim)``
innermost first (:func:`cuts_of`, :func:`full_data`,
:func:`local_part`). A step all-gathers every
sharded parameter into its full tensor, runs forward and backward on
them, reduce-scatters each of their gradients into this rank's slice
(divided by the world with the rest), puts the shard back as the
parameter's data and updates the shards, in the same multi-tensor
launches. At degree 1 the layout still shards, along the dimension it
would shard at any degree: the gathers and scatters are then one-rank
copies, and one card runs the path that D ranks take. Tensors with no
dimension the degree divides stay replicated and are averaged as under a
``DistOpt``. The model's forward-mutated states (BN running statistics)
and a guard's scalars and shadows stay replicated too: sync-BN gives every
rank the same values, and they are a small share of the bytes.

The tensor- and expert-parallel layouts of ``Model`` under a ``model`` or
``expert`` axis above 1 are :class:`ShardedLayout` objects too (``by_spec``:
the parameters' announced specs choose the dimension), so all share one
slicing code, and ZeRO/FSDP cuts on top of them (:func:`fsdp_state_spec`:
the first dimension still whole that the data degree divides), the
``model`` axis of :func:`train_mesh` included. Reduce-scattering an
FSDP shard's gradient sums it over the data ranks and, through the
``DistOpt``, over the other reduce axes but the parameter's own shard
axes.

Not ported: pipeline stages (``stage`` > 1, slice E) and the serving half
of the module (the serving mesh, partitioner and rule tables, sharded
serving: slice D2); each raises naming ROADMAP.md.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..autograd_base import register_param
from ..tensor import Tensor

__all__ = ["BATCH_AXIS", "MODEL_AXIS", "DATA_AXIS", "EXPERT_AXIS",
           "SPEC_AXES", "ShardingDecline",
           "PartitionSpec", "P", "replicated_spec", "col_spec",
           "col_bias_spec", "row_spec", "vocab_spec", "expert_spec",
           "batch_spec", "fit_state_spec", "fsdp_state_spec", "fsdp_dim",
           "train_degrees", "train_mesh", "Partitioner", "ShardedLayout",
           "cuts_of", "full_data", "full_tensor", "local_part",
           "MeshStep", "step_scope", "active_step", "active_layout",
           "active_reducer", "serving_mesh", "serving_partitioner",
           "lm_param_specs", "ring_cache_specs", "pool_specs",
           "serving_arg_specs"]

BATCH_AXIS = "batch"
MODEL_AXIS = "model"
# the training batch axis (serving's is BATCH_AXIS)
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
# the axes whose announced specs a model keeps cut between steps
SPEC_AXES = (MODEL_AXIS, EXPERT_AXIS)


class ShardingDecline(ValueError):
    """A sharding request the mesh cannot honour, raised when it is made
    and naming the offending dimension, never a silently replicated
    "sharded" program."""


class PartitionSpec(tuple):
    """Per-dimension axis names (a name, a tuple of names, or None for a
    replicated dimension): ``P("data")`` shards dimension 0 over
    ``data``. Equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _sizes(mesh):
    from .mesh import axis_sizes
    return axis_sizes(mesh)


# -- the spec vocabulary -------------------------------------------------------

def replicated_spec():
    """Fully replicated (LN scale/bias, small biases, scalars)."""
    return P()


def col_spec(axis=MODEL_AXIS):
    """Column-parallel ``(in, out)`` weight: the out features sharded."""
    return P(None, axis)


def col_bias_spec(axis=MODEL_AXIS):
    """Bias of a column-parallel layer: sharded like its out features."""
    return P(axis)


def row_spec(axis=MODEL_AXIS):
    """Row-parallel ``(in, out)`` weight: the in features sharded."""
    return P(axis, None)


def vocab_spec(axis=MODEL_AXIS):
    """Embedding table ``(vocab, d)``: the vocab rows sharded."""
    return P(axis, None)


def expert_spec(axis="expert"):
    """Expert-banked weight ``(E, ...)``: the expert dimension sharded."""
    return P(axis)


def batch_spec(axis=BATCH_AXIS, rank=1):
    """Leading-dimension batch sharding of a ``rank``-dimensional array."""
    return P(axis, *([None] * (rank - 1)))


def fit_state_spec(spec, shape, mesh):
    """A state's announced spec with every dimension that does not divide
    its mesh axes replicated instead; trailing replicated entries are
    dropped. ``spec`` None is :func:`replicated_spec`."""
    if spec is None:
        return P()
    sizes = _sizes(mesh)
    fitted = []
    for dim, names in enumerate(spec):
        if names is None:
            fitted.append(None)
            continue
        tup = names if isinstance(names, tuple) else (names,)
        size = 1
        for n in tup:
            size *= sizes[n]
        fitted.append(names if dim < len(shape) and
                      shape[dim] % size == 0 else None)
    while fitted and fitted[-1] is None:
        fitted.pop()
    return P(*fitted)


def _check_axis(sizes, axis):
    if axis not in sizes:
        raise ShardingDecline(
            f"fsdp axis {axis!r} is not in the mesh {sizes}: build the "
            f"train mesh with a {axis!r} axis (parallel.mesh.MeshConfig "
            "names it)")


def fsdp_state_spec(spec, shape, mesh, axis=DATA_AXIS):
    """ZeRO/FSDP layout of one parameter or optimizer state: the
    announced spec (mesh-fitted, :func:`fit_state_spec`) with the first
    still-replicated dimension that the ``axis`` degree divides sharded
    over it as well. Scalars, tensors with no divisible dimension and a
    degree of 1 stay as the fitted spec. An ``axis`` not in the mesh
    raises :class:`ShardingDecline`."""
    sizes = _sizes(mesh)
    _check_axis(sizes, axis)
    base = fit_state_spec(spec, shape, sizes)
    deg = int(sizes[axis])
    if deg <= 1 or not shape:
        return base
    entries = list(base) + [None] * (len(shape) - len(base))
    for dim, names in enumerate(entries):
        if names is None and shape[dim] % deg == 0:
            entries[dim] = axis
            break
    else:
        return base
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def fsdp_dim(spec, shape, mesh, axis=DATA_AXIS):
    """The dimension :class:`ShardedLayout` shards a state along: the one
    :func:`fsdp_state_spec` gives ``axis``, and at degree 1 the one it
    would give at any degree (the first replicated dimension); None for a
    state that stays replicated."""
    sizes = _sizes(mesh)
    _check_axis(sizes, axis)
    if int(sizes[axis]) > 1:
        got = fsdp_state_spec(spec, shape, sizes, axis)
        return list(got).index(axis) if axis in got else None
    base = list(fit_state_spec(spec, shape, sizes))
    for dim in range(len(shape)):
        if dim >= len(base) or base[dim] is None:
            return dim
    return None


# -- the train mesh ------------------------------------------------------------

def train_degrees(n_devices, data=-1, model=1, stage=1):
    """``{"data", "model", "pipe"}`` degrees of a train mesh over
    ``n_devices`` devices (ranks), as the JAX package's
    :func:`train_mesh` decides them: ``data=-1`` is everything left, and
    fully explicit degrees may cover a leading subset. Degrees that cannot
    tile the devices raise :class:`ShardingDecline`."""
    d, m, s = int(data), int(model), int(stage)
    if m < 1 or s < 1:
        raise ShardingDecline(
            f"model={m} / stage={s} degrees must be >= 1")
    n = int(n_devices)
    need = m * s * (d if d != -1 else 1)
    if need > n or n % (m * s) != 0:
        raise ShardingDecline(
            f"train mesh data={d} model={m} stage={s} cannot tile the "
            f"{n} available devices: degrees must cover the device "
            "set exactly")
    return {"data": d if d != -1 else n // (m * s), "model": m, "pipe": s}


def train_mesh(data=-1, model=1, stage=1, device_type=None):
    """A named train mesh over the ranks of the initialised process group
    (``parallel.communicator.init_process``): a ``DeviceMesh`` from
    ``parallel.mesh.make_mesh``, ``stage`` bound to its ``pipe`` axis name
    as in the JAX package. Degrees are decided by :func:`train_degrees`.
    The port's mesh covers every rank (each rank is a process that
    trains), so a subset of the ranks raises :class:`ShardingDecline`;
    ``stage`` > 1 raises ``NotImplementedError``. A ``model`` degree above
    1 trains the tensor-parallel layers over its axis (``Model.compile(
    mesh=)``, with ZeRO/FSDP over ``data`` on top when asked)."""
    from . import mesh as mesh_mod
    deg = train_degrees(mesh_mod._world(), data, model, stage)
    if deg["pipe"] > 1:
        raise NotImplementedError(
            f"train mesh stage={deg['pipe']}: pipeline stages "
            "(parallel/pipeline.py) are not ported yet (ROADMAP.md: "
            "slice E)")
    world = mesh_mod._world()
    covered = deg["data"] * deg["model"]
    if covered != world:
        raise ShardingDecline(
            f"train mesh data={deg['data']} model={deg['model']} covers "
            f"{covered} of the {world} ranks: each rank of the port is a "
            "process that trains, so the mesh spans every rank: launch "
            "that many ranks or pass data=-1")
    return mesh_mod.make_mesh(device_type, mesh_mod.MeshConfig(
        data=deg["data"], model=deg["model"], pipe=deg["pipe"]))


# -- the serving half: slice D2 -------------------------------------------------

def _serving(name):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"gspmd.{name}: sharded serving is not ported yet (ROADMAP.md: "
            "slice D2, sharded LM serving)")
    refused.__name__ = name
    return refused


serving_mesh = _serving("serving_mesh")
serving_partitioner = _serving("serving_partitioner")
lm_param_specs = _serving("lm_param_specs")
ring_cache_specs = _serving("ring_cache_specs")
pool_specs = _serving("pool_specs")
serving_arg_specs = _serving("serving_arg_specs")


class Partitioner:
    """The JAX package's serving partitioner (slice D2: constructing one
    raises) and its byte accounting, which training uses."""

    def __init__(self, *args, **kwargs):
        _serving("Partitioner")()

    @staticmethod
    def per_device_bytes(tensors):
        """Bytes one rank holds of ``tensors`` (Tensors or torch tensors):
        a shard counts its own size."""
        datas = [getattr(t, "data", t) for t in tensors]
        return int(sum(d.numel() * d.element_size() for d in datas))

    @staticmethod
    def global_bytes(tensors):
        """Bytes of ``tensors`` at their full shapes (a shard's
        ``Tensor.sharding``)."""
        total = 0
        for t in tensors:
            data = getattr(t, "data", t)
            sharding = getattr(t, "sharding", None)
            shape = sharding[1] if sharding is not None else data.shape
            total += int(np.prod(shape, dtype=np.int64)) \
                * data.element_size()
        return int(total)


# -- ZeRO/FSDP ------------------------------------------------------------------

def base_optimizer(opt):
    """The optimizer that holds the states: ``opt`` without its guard
    (``inner``) and its ``DistOpt`` (``opt``)."""
    from ..opt import DistOpt
    while hasattr(opt, "inner") and not isinstance(opt, DistOpt):
        opt = opt.inner
    return opt.opt if isinstance(opt, DistOpt) else opt


def _local(full, dim, rank, world):
    k = full.shape[dim] // world
    index = [slice(None)] * full.ndim
    index[dim] = slice(rank * k, (rank + 1) * k)
    part = full[tuple(index)]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part)
    # a copy, never a view: a view would keep the full tensor alive
    return part.clone(memory_format=torch.contiguous_format)


def cuts_of(t):
    """The cuts of Tensor ``t``: ``((layout, dim), ...)``, innermost
    first (``Tensor.sharding`` is ``(cuts, full shape)``); () for a whole
    tensor."""
    return t.sharding[0] if t.sharding else ()


def full_data(t):
    """The full torch tensor of state ``t``: every cut gathered, the
    outermost first (collective: every rank calls it); ``t.data`` for a
    whole tensor."""
    data = t.data
    for lay, dim in reversed(cuts_of(t)):
        data = lay.gather(data.detach(), dim, t.name)
    return data


def full_tensor(t):
    """A new Tensor holding the full value of ``t`` (collective)."""
    return Tensor(data=full_data(t), device=t.device, name=t.name,
                  requires_grad=t.requires_grad, stores_grad=t.stores_grad)


def local_part(full, cuts):
    """This rank's block of ``full`` (torch or numpy) under ``cuts``."""
    for lay, dim in cuts:
        full = lay.local(full, dim)
    return full


class ShardedLayout:
    """One cut of a model's parameters, and of the optimizer states that
    mirror them, over the ``axis`` ranks of a mesh (module docstring):
    ZeRO/FSDP by default, or with ``by_spec`` a tensor- or expert-parallel
    layout, each parameter cut along the dimension its announced
    ``Tensor.spec`` gives ``axis`` (mesh-fitted by
    :func:`fit_state_spec`) and never gathered for a step (``Model`` keeps
    it over the ``model`` and ``expert`` axes). ``sizes`` is the mesh's
    axis table and ``comm`` a ``Communicator``; its gathers and scatters
    run over ``axis`` (``comm`` itself when ``axis`` is its axis, else
    one over ``axis`` of ``comm``'s mesh).

    Cuts stack: an FSDP layout made after a spec layout cuts each
    parameter on its first dimension that is still whole and divides the
    ``axis`` degree (:func:`fsdp_state_spec` on top of the announced spec),
    so ``Tensor.sharding`` lists every cut, innermost first
    (:func:`cuts_of`), beside the full shape. A layout undoes only its
    own cut, the outermost."""

    def __init__(self, comm, sizes, axis=DATA_AXIS, by_spec=False):
        from .communicator import Communicator
        _check_axis(sizes, axis)
        if axis != comm.axis_name:
            comm = Communicator(axis_name=axis, mesh=comm.mesh)
        self.comm = comm
        self.sizes = sizes
        self.axis = axis
        self.by_spec = by_spec
        self.world = int(sizes[axis])
        self.rank = comm.rank()
        self.dims = {}          # parameter name -> its sharded dimension
        self.named = {}         # parameter name -> the Tensor it cut
        self.params = []        # the live parameter Tensors it cuts
        self.optimizer = None   # the base optimizer it cuts the states of
        self._held = None       # inside gathered(): id -> (param, shard)

    def local(self, full, dim):
        """This rank's contiguous slice of ``full`` (torch or numpy)
        along ``dim``."""
        return _local(full, dim, self.rank, self.world)

    def gather(self, part, dim, name=None):
        """The ranks' ``part`` concatenated along ``dim``: an all-gather
        (a collective: every rank calls it)."""
        if self.world > 1 and not self.comm.active():
            raise RuntimeError(
                f"{name}: a shard of {self.world} ranks is gathered over "
                "their process group, which is no longer initialised")
        return self.comm.all_gather(part, dim)

    def _dim(self, t):
        return next(d for lay, d in cuts_of(t) if lay is self)

    def full(self, t):
        """``t`` with this layout's cut gathered (collective)."""
        return self.gather(t.data.detach(), self._dim(t), t.name)

    def _cut(self, t, dim):
        """Replace ``t``'s data by this rank's slice along ``dim``."""
        cuts, shape = t.sharding if t.sharding else ((), tuple(t.shape))
        param = t.data.requires_grad
        t.data = self.local(t.data.detach(), dim)
        if param:
            register_param(t)
        t.sharding = (cuts + ((self, dim),), shape)

    def _join(self, t):
        """Undo this layout's cut of ``t``, its outermost (collective)."""
        cuts, shape = t.sharding
        if cuts[-1][0] is not self:
            raise RuntimeError(f"{t.name}: another layout's cut is on top")
        param = t.data.requires_grad
        t.data = self.full(t)
        if param:
            register_param(t)
        t.sharding = (cuts[:-1], shape) if len(cuts) > 1 else None

    def _rule_dim(self, t):
        """The dimension this layout cuts ``t`` along, or None."""
        shape = t.sharding[1] if t.sharding else tuple(t.shape)
        if self.by_spec:
            spec = fit_state_spec(t.spec, shape, self.sizes)
            return list(spec).index(self.axis) if self.axis in spec \
                else None
        # ZeRO/FSDP: the first dimension the degree divides among those no
        # other layout cut (as before the layers announced specs, where
        # none did); a tensor already cut over this axis holds distinct
        # blocks on its ranks, not replicas, and stays as it is
        taken = {d: lay.axis for lay, d in cuts_of(t)}
        if self.axis in taken.values():
            return None
        return fsdp_dim(P(*[taken.get(d) for d in range(len(shape))]),
                        shape, self.sizes, self.axis)

    def shard(self, named_params):
        """Cut each parameter of ``{name: Tensor}`` that the layout's rule
        cuts; returns self."""
        for name, t in named_params.items():
            dim = self._rule_dim(t)
            if dim is None:
                continue
            self.dims[name] = dim
            self.named[name] = t
            self.params.append(t)
            self._cut(t, dim)
        return self

    def adopt(self, optimizer, comm):
        """Cut the states of ``optimizer`` (a plain, guarded or ``DistOpt``
        one) that mirror a parameter this layout cuts, and make its later
        ones cut too (``Optimizer.layouts``); gather and scatter through
        ``comm`` (the step's, over the same ranks) from now on when it
        runs over this layout's axis."""
        if comm.axis_name == self.axis:
            self.comm = comm
        base = base_optimizer(optimizer)
        if self.optimizer is not None and self.optimizer is not base:
            self.optimizer.layouts.remove(self)
        self.optimizer = base
        if self not in base.layouts:
            base.layouts.append(self)
        for key, t in base._aux.items():
            dim = self.dims.get(key.rpartition(":")[0])
            if dim is not None and \
                    not any(lay is self for lay, _ in cuts_of(t)):
                self._cut(t, dim)

    def unshard(self):
        """Every parameter and optimizer state this layout cut back to what
        it was before the cut (collective); the layout is done."""
        for t in self.params:
            self._join(t)
        if self.optimizer is not None:
            for t in self.optimizer._aux.values():
                if any(lay is self for lay, _ in cuts_of(t)):
                    self._join(t)
            self.optimizer.layouts.remove(self)
        self.params, self.dims, self.named = [], {}, {}
        self.optimizer = None

    @contextlib.contextmanager
    def gathered(self):
        """Every parameter this layout cuts with its cut gathered as its
        data (a parameter leaf) within; its shard again after. A gradient
        reduced by :meth:`reduce_mean` within puts its parameter's shard
        back at once, so the update writes the shard."""
        if self._held is not None:
            yield
            return
        held = {}
        for t in self.params:
            shard = t.data
            t.data = self.full(t)
            register_param(t)
            held[id(t)] = (t, shard)
        self._held = held
        try:
            yield
        finally:
            self._held = None
            for t, shard in held.values():
                t.data = shard

    def reduce_mean(self, pairs, dist, wire=None):
        """Backward's ``(param, grad)`` pairs averaged over the ranks: a
        gradient of a parameter gathered for the step reduce-scattered into
        this rank's slice (on the ``wire`` dtype, as ``dist``'s reduction
        sends it; a slice without a sum where ``axis`` is not one ``dist``
        sums over) and summed over ``dist``'s other reduce axes but the
        parameter's own shard axes, its shard put back; every other
        gradient through ``dist.grad_reduce_stream``; then ``dist._mean``,
        the one division by the world. Returns the pairs in their order."""
        pairs = list(pairs)
        if wire is None:
            wire = dist._policy_wire()
        held = self._held or {}
        list(dist.grad_reduce_stream(
            [(p, g) for p, g in pairs if id(p) not in held], wire=wire))
        for p, g in pairs:
            if id(p) not in held:
                continue
            own = dist._shard_axes(p)
            eff = wire if wire is not None else g.data.dtype
            send = g.data if g.data.dtype == eff else g.data.to(eff)
            if self.axis in dist.communicator.reduce_axes and \
                    self.axis not in own:
                part = self.comm.reduce_scatter(send, self._dim(p))
            else:
                part = self.local(send, self._dim(p))
            part = dist.all_reduce(part, exclude=own + (self.axis,))
            g.data = dist._wire_cast_back(part, g.data.dtype, wire)
            p.data = held[id(p)][1]
        return dist._mean(pairs)


class MeshStep:
    """What a model compiled with ``mesh=`` or ``fsdp_axis=`` trains
    through: the ``reducer`` (a ``DistOpt`` over the mesh's data group: the
    model's own, or one around its plain optimizer, ``own_reducer``) and
    its communicator, and the :class:`ShardedLayout` under FSDP (or
    None)."""

    def __init__(self, reducer, layout=None, own_reducer=False):
        self.reducer = reducer
        self.comm = reducer.communicator
        self.layout = layout
        self.own_reducer = own_reducer
        self.world = self.comm.effective_world_size()
        self.rank = self.comm.rank()


_ACTIVE: list = []


@contextlib.contextmanager
def step_scope(step):
    """Marks the code within as one rank's share of ``step``'s train step
    (a :class:`MeshStep`); ``None`` is a no-op."""
    if step is None:
        yield
        return
    _ACTIVE.append(step)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_step():
    """The innermost :func:`step_scope`'s :class:`MeshStep`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def active_layout():
    """The active step's :class:`ShardedLayout`, or None."""
    step = active_step()
    return step.layout if step is not None else None


def active_reducer():
    """The ``DistOpt`` the active step made around a plain optimizer, or
    None: a plain (or guarded plain) optimizer averages its gradients
    through it; a ``DistOpt`` reduces them itself."""
    step = active_step()
    return step.reducer if step is not None and step.own_reducer else None
