"""Model: the user-facing layer tree with training, eval, states,
checkpoints and the serving entry point.

Counterpart of the single-device subset of ``singa_tpu/model.py``:
:meth:`Model.compile` (``model.py:300-487``), ``set_optimizer``,
``__call__`` (``:1353-1387``: train mode runs ``train_one_batch``, eval
mode runs ``forward``), the precision policy's training companion (a
16-bit compute policy wraps the optimizer in
``resilience.GuardedOptimizer``, ``:221-284``), ``eval`` / ``train``,
``get_states`` /
``set_states``, ``save_states`` / ``load_states`` in the same zip format
(a ``tensor_dict.npz`` plus a ``states_attr.json``, with the optimizer's
states as ``optimizer/<name>`` entries, a guard's as ``optimizer/guard/...``
and ``optimizer/guard-shadow/...``, ``:1605-1770``), and
:meth:`Model.compile_serving`. :func:`load_numpy_states` carries weights,
BN running statistics and optimizer states across from a dict of numpy
arrays, such as the JAX package's ``get_states`` turned to numpy or its
``save_states`` zip.

Graph mode (``compile(use_graph=True)`` or :meth:`Model.graph`) is the
JAX package's jitted train step (``model.py:855-1050``) as CUDA graphs:
each train-mode call dispatches on its inputs' signature (shape, dtype,
strides; the value of a non-tensor argument) to a
:class:`~.graph.StepGraph`, which runs the signature's first call
eagerly, captures forward, backward, guard and update at the second and
replays from then on. The signatures share one memory pool, a 9th one
warns, and every graph is dropped when what it baked in changes: the
optimizer, a re-compile (a policy change rebinds the masters), a flip
between train and eval, a load that makes a new optimizer state. Eval
runs eagerly, as the JAX package's single-device eval does
(``model.py:1355-1390``).

Data-parallel training: ``set_optimizer``/``compile`` take an
``opt.DistOpt`` (or a guard around one). Each rank is a process that
calls the model on its own shard of the batch; the train step runs inside
``parallel.communicator.collective_context`` (sync-BN reads it), and of
its outputs a floating one whose leading dimension is not the batch's (the
loss) comes back as the mean over the ranks, as the JAX step averages
its replicated outputs (``model.py:698-708``), while the logits stay the
rank's own. In graph mode the collectives are captured with the step,
which needs NCCL: a CUDA step over a gloo process group raises.

The train mesh and ZeRO/FSDP (``compile(mesh=..., fsdp_axis=...)``,
``singa_tpu/model.py:300-355, 712-780``; ``parallel/gspmd.py``): the step
runs through a ``gspmd.MeshStep``, so a plain optimizer's gradients are
averaged over the data ranks too (through a ``DistOpt`` the step makes
around it) and a dropout mask is the global batch's. With ``fsdp_axis``
(``True`` is ``"data"``; a ``DistOpt(zero=True)`` implies its axis) the
trainable parameters and their optimizer states are shards between
steps (``gspmd.ShardedLayout``): the step gathers the parameters, and
reduce-scatters and updates the shards; an eval-mode call gathers and
releases them. Then :meth:`get_states` gives full tensors and is
collective (every rank calls it, as reading a sharded ``jax.Array``
gathers); :meth:`save_states` writes the full arrays (rank 0 writes, the
others wait), so the archive of a ZeRO run has a replicated run's names,
shapes and dtypes; :meth:`load_states` cuts them onto the current mesh,
of any data degree; :meth:`compile_serving` gathers the parameters once
(serving stays replicated; a later train call shards them again). Over
NCCL the gathers and scatters are captured with the step.

Tensor and sequence parallelism (``singa_tpu/model.py:781-823, 82-123``):
a ``DistOpt`` whose communicator has a mesh (``parallel.mesh.make_mesh``;
or the process-wide one of ``communicator.set_mesh``, which the
``DistOpt`` then takes) runs every train and eval call inside the mesh's
axis context (``collective_context(*axes)``, ``batch_shard_axes``), so the
tensor-parallel layers, the vocab-parallel CE head, ring/Ulysses
attention and the MoE FFN reach their collectives (``compile(mesh=)``'s
mesh too). With a ``model`` or ``expert`` axis above 1, :meth:`compile`
leaves on each rank its block of every parameter whose announced spec
divides the axis (``Tensor.spec``: the tensor-parallel weights over
``model``, the expert banks over ``expert``; a ``gspmd.ShardedLayout``
per axis, the one slicing code ZeRO uses), and the optimizer states
that mirror them follow; ZeRO/FSDP then cuts each of those blocks along
its first whole dimension that the data degree divides.
``get_states``/``save_states`` gather those shards (collective: every
rank calls), so the archive has the dense model's names and shapes, and
:func:`load_numpy_states` cuts full arrays to this rank's shard. With
``input_specs`` (e.g. ``[P("data", "seq"), P("data", "seq")]``) every
rank is called with the global batch and takes its block along each
sharded dimension (the rank's coordinates on those axes); of the
outputs, a floating one that leads with the batch comes back global
(gathered per ``output_specs``, else along the batch axes) and every
other (the loss) is averaged over the reduce axes. Without
``input_specs`` the per-rank batches of a ``DistOpt`` stay as they are.
The gradients are summed over the ``DistOpt``'s ``reduce_axes``
(``("data", "seq")`` for sequence parallelism, ``("data", "expert")``
for experts), each but over its own shard axes: a tensor-parallel shard's
on its own, a parameter replicated over ``model`` alike on the model
ranks through the f/g pairs, an expert bank's over the batch axes but
``expert`` (its tokens came through the all-to-all).
"""

from __future__ import annotations

import io
import json
import time
import warnings
import zipfile

import numpy as np

import torch

from .autograd_base import CTX, register_param
from .graph import StepGraph, resources, signature
from .layer import Layer
from .tensor import Tensor, dtype_name

TENSOR_DICT_FILENAME = "tensor_dict.npz"
STATES_ATTR_FILENAME = "states_attr.json"


def load_numpy_states(model, states, strict=True):
    """Copy ``{state name: numpy array}`` into ``model``'s live state
    tensors, each cast to the live tensor's dtype (a ZeRO/FSDP or
    tensor-parallel shard takes this rank's slice). ``optimizer/<name>``
    entries go to the model's optimizer (``set_states``; a guard takes its
    ``guard/`` and ``guard-shadow/`` ones) when it has one; ``aux/`` and
    ``quant-scale/`` entries are not model states and are skipped. With
    ``strict`` (the default) every model state must be present. A model
    whose layers have not run yet has no states: run it once
    (``compile_serving`` does) before loading. Returns the model state
    names loaded."""
    from .parallel.gspmd import cuts_of, local_part
    mine = model._live_states()
    if not mine:
        raise RuntimeError(
            f"{type(model).__name__} has no states yet: its layers "
            "initialize on their first call -- build the serving engine "
            "(compile_serving) or run one forward before loading states")
    loaded, opt_states = [], {}
    for k, v in states.items():
        if k.startswith("optimizer/"):
            opt_states[k[len("optimizer/"):]] = v
            continue
        if k.startswith(("aux/", "quant-scale/")):
            continue
        if k in mine:
            t, arr = mine[k], np.asarray(v)
            want = t.sharding[1] if t.sharding else t.shape
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"state {k!r}: shape {arr.shape} does not "
                                 f"match the model's {tuple(want)}")
            t.copy_from_numpy(local_part(arr, cuts_of(t)))
            loaded.append(k)
    if strict:
        missing = sorted(set(mine) - set(loaded))
        if missing:
            raise KeyError(f"states missing for {len(missing)} model "
                           f"tensors, e.g. {missing[:5]}")
    opt = getattr(model, "optimizer", None)
    if opt_states and opt is not None:
        before = set(opt.state_tensor_dict()) if opt.device is not None \
            else None
        opt.set_states(opt_states)
        if set(opt.state_tensor_dict()) != before:
            # a captured step does not update a state born after it
            model.drop_graphs()
    return loaded


class Model(Layer):
    """Base user model."""

    TENSOR_DICT_FILENAME = "/" + TENSOR_DICT_FILENAME
    STATES_ATTR_FILENAME = "/" + STATES_ATTR_FILENAME

    def __init__(self):
        super().__init__()
        self._train = False
        self.dev = None
        self._policy = None
        self.graph_mode = False
        self.sequential = False
        self.optimizer = None
        self._graphs = {}             # input signature -> StepGraph
        self._graph_resources = None  # what the graphs share (graph.py)
        self._gspmd_mesh = None       # compile(mesh=)
        self._fsdp_axis = None        # compile(fsdp_axis=)
        self._layout = None           # gspmd.ShardedLayout under FSDP
        self._mesh_step = None        # gspmd.MeshStep of the train step
        self._spec_layouts = []       # gspmd.ShardedLayouts, model/expert
        self._step_count = 0          # train calls (time profiling)
        # per-input layouts over the mesh (e.g. [P("data", "seq")] * 2)
        self.input_specs = None
        # per-output layouts; None derives them from the input specs
        self.output_specs = None

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def train_one_batch(self, *args, **kwargs):
        raise NotImplementedError

    def train(self, mode=True):
        if bool(mode) != bool(self._train):
            self.drop_graphs()
        self._train = mode
        CTX.training = mode

    def eval(self):
        self.train(False)

    def graph(self, mode=True, sequential=False):
        """Run train-mode calls in graph mode (``mode``) or eagerly
        (``singa_tpu/model.py:293-297``); ``sequential`` is recorded for
        parity."""
        if not mode:
            self.drop_graphs()
        self.graph_mode = bool(mode)
        self.sequential = sequential

    def drop_graphs(self):
        """Forget every captured step: the next train-mode call of each
        signature runs eagerly, the one after captures anew."""
        self._graphs = {}

    def graph_stats(self):
        """``{signature: {"n_captures", "n_replays"}}`` of the captured
        train steps."""
        return {k: g.stats() for k, g in self._graphs.items()}

    def _migrate_masters(self, new_policy):
        """A re-compile across a param-dtype change (``bfloat16`` ->
        ``bf16_mixed``, or back): cast the trainable parameters, and the
        optimizer aux that mirrors them (``<param>:<kind>``), to the new
        master dtype, in place of the old tensors' data. Other state (BN
        running statistics, the guard's) keeps its dtype."""
        pd = new_policy.param_dtype if new_policy is not None else None
        if pd is None:
            return

        def adapt(t):
            if t.data.is_floating_point() and t.dtype != pd:
                param = t.data.requires_grad
                t.data = t.data.detach().to(pd)
                if param:
                    register_param(t)

        for t in self._live_states().values():
            if t.requires_grad:
                adapt(t)
        if self.optimizer is not None and self.optimizer.device is not None:
            for k, t in self.optimizer.state_tensor_dict().items():
                if ":" in k.rsplit("/", 1)[-1]:
                    adapt(t)

    def _policy_companion(self, optimizer):
        """Pair a 16-bit policy with dynamic loss scaling: wrap a plain
        optimizer in ``resilience.GuardedOptimizer`` (never one that is
        guarded already), and undo that wrap (never a user's) when the
        policy stops wanting scaling or changes, so that a new policy
        starts at its own default scale."""
        pol = self._policy
        wants = pol is not None and pol.wants_loss_scaling
        mark = vars(optimizer).get("_policy_companion_wrap") \
            if optimizer is not None else None
        if mark is not None and (not wants or mark != pol):
            optimizer = optimizer.inner
        if wants and optimizer is not None and \
                not hasattr(optimizer, "dynamic_loss_scale"):
            from .resilience import GuardedOptimizer
            optimizer = GuardedOptimizer.for_policy(optimizer, pol)
            optimizer._policy_companion_wrap = pol
        return optimizer

    def set_optimizer(self, optimizer):
        """Train with ``optimizer``, wrapped for loss scaling when the
        model's policy asks for it; bound to the model's device once the
        model has one (``compile``). A guard is handed the model, whose BN
        running statistics it shadows."""
        optimizer = self._policy_companion(optimizer)
        self.drop_graphs()
        self.optimizer = optimizer
        if optimizer is not None and self.dev is not None:
            optimizer.bind(self.dev)
        if hasattr(optimizer, "bind_model"):
            optimizer.bind_model(self)
        if optimizer is not None:
            for lay in self._spec_layouts:
                lay.adopt(optimizer, lay.comm)
        self._mesh_step = None
        if self._meshed() and optimizer is not None and \
                self.dev is not None:
            self._mesh_step = self._build_mesh_step()

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False, policy=None, mesh=None, fsdp_axis=None):
        """Initialise every layer with one forward of ``inputs`` (a list
        of Tensors, no gradients, BN in inference), name the states (so
        the optimizer's aux states are ``<state name>:<kind>``), bind the
        optimizer to the inputs' device, and enter train or eval mode.

        ``use_graph`` turns graph mode on or off (:meth:`graph`; the
        module docstring), ``sequential`` is recorded for parity.
        ``policy`` is a precision policy or its name (``"bf16_mixed"``,
        ``"float16_mixed"``, ``"bfloat16"``): f32 masters (for the mixed
        ones), 16-bit convolutions and products, f32 outputs, and for
        training the optimizer wrapped in ``resilience.GuardedOptimizer``
        (dynamic loss scaling from the policy's ``default_loss_scale``)
        unless the policy opts out (``loss_scaling=False``). A re-compile
        under another policy casts the masters to its param dtype.

        ``mesh`` (a ``DeviceMesh`` from ``parallel.gspmd.train_mesh``) and
        ``fsdp_axis`` (``True`` is ``"data"``; a ``DistOpt(zero=True)``
        implies its axis) train through the mesh and ZeRO/FSDP (module
        docstring); with ``fsdp_axis`` and no ``mesh`` the mesh is the
        ``DistOpt``'s, else one over every rank. An axis the mesh lacks
        raises ``gspmd.ShardingDecline``. A re-compile gathers a sharded
        model first (collective)."""
        from . import mixed_precision as mp
        assert len(inputs) > 0
        pol = mp.resolve(policy)
        self._unshard()
        self._gspmd_mesh = self._fsdp_axis = None
        self.drop_graphs()
        if pol != self._policy:
            self._migrate_masters(pol)
        self._policy = pol
        if self.optimizer is not None:
            # the policy's companion wraps (or unwraps) the optimizer
            self.set_optimizer(self.optimizer)
        self.dev = inputs[0].device
        self.graph(use_graph, sequential)
        prev = CTX.training
        CTX.training = False
        try:
            with torch.no_grad(), mp.policy_scope(pol):
                self.forward(*inputs)
        finally:
            CTX.training = prev
        for name, t in self._live_states().items():
            t.name = t.name or name
        if self.optimizer is not None:
            self.optimizer.bind(self.dev)
        dist = self._dist_opt()
        if fsdp_axis is True:
            fsdp_axis = "data"
        if fsdp_axis is None and dist is not None and dist.zero:
            fsdp_axis = dist.axis_name
        self._gspmd_mesh, self._fsdp_axis = mesh, fsdp_axis
        self._shard_spec_axes()
        self._mesh_step = None
        if self._meshed() and self.optimizer is not None:
            self._mesh_step = self._build_mesh_step()
        self.train(is_train)

    def __call__(self, *args, **kwargs):
        """Train mode: one ``train_one_batch`` (forward, loss, backward,
        update), in graph mode through the signature's
        :class:`~.graph.StepGraph`. Eval mode: ``forward`` without
        gradients. Under a policy the floating outputs come back in its
        output dtype."""
        from . import mixed_precision as mp
        if self._train:
            if kwargs:
                raise TypeError(
                    "train-mode model calls take positional arguments "
                    f"only; got keyword arguments {sorted(kwargs)}")
            if hasattr(self.optimizer, "materialize_shadows"):
                # a guard's shadows hold the BN statistics before the
                # forward moves them
                self.optimizer.materialize_shadows()
            if self.graph_mode:
                return self._timed(lambda: self._step_graph(args)(*args))
            return self._timed(lambda: self._train_step(*args))
        prev = CTX.training
        CTX.training = False
        try:
            with torch.no_grad(), mp.policy_scope(self._policy), \
                    self._gathered(), self._mesh_scope():
                local = self._local_inputs(args)
                out = self.forward(*local, **kwargs)
                if self.input_specs and self._axis_mesh() is not None:
                    out = self._global_outputs(
                        out, self._dist_opt().communicator, local)
        finally:
            CTX.training = prev
        return out if self._policy is None else self._cast_outputs(out)

    def _timed(self, run):
        """``run()``; at device verbosity 1 and past the device's
        ``skip_iteration`` train calls, its time goes to the device's
        profile as ``train_one_batch`` (``singa_tpu/model.py:1068-1075``):
        CUDA events around the call on the card (then a wait for its end),
        the host clock on the CPU."""
        dev = self.dev
        self._step_count += 1
        if dev is None or dev.verbosity <= 0 or \
                self._step_count <= dev.skip_iteration:
            return run()
        if dev.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = run()
            seconds = time.perf_counter() - t0
        dev._record_time("train_one_batch", seconds)
        return out

    def _dist_opt(self):
        """The model's ``DistOpt``, bare or inside a guard, or None."""
        from .opt import DistOpt
        opt = self.optimizer
        if not isinstance(opt, DistOpt):
            opt = getattr(opt, "inner", None)
        return opt if isinstance(opt, DistOpt) else None

    # -- the train mesh and ZeRO/FSDP (parallel/gspmd.py) --------------------
    def _meshed(self):
        return self._gspmd_mesh is not None or self._fsdp_axis is not None

    def _build_mesh_step(self):
        """The :class:`~.parallel.gspmd.MeshStep` of the compiled mesh and
        optimizer: the ``DistOpt`` (the model's, or one around its plain
        optimizer) over the mesh's data group and, under FSDP, the model's
        parameters sharded and the optimizer's mirroring states with them
        (the layout made at the first call, kept after)."""
        from .opt import DistOpt
        from .parallel import gspmd
        from .parallel.communicator import initialized
        from .parallel.mesh import axis_sizes, make_mesh
        dist = self._dist_opt()
        mesh = self._gspmd_mesh
        if mesh is None:
            mesh = dist.communicator.mesh if dist is not None and \
                dist.communicator.mesh is not None else \
                make_mesh() if initialized() else None
        sizes = axis_sizes(mesh if mesh is not None else {})
        axis = dist.axis_name if dist is not None else gspmd.DATA_AXIS
        if axis not in sizes:
            raise gspmd.ShardingDecline(
                f"train mesh {sizes} has no batch axis {axis!r}: build it "
                "with parallel.gspmd.train_mesh")
        own = dist is None
        reducer = DistOpt(gspmd.base_optimizer(self.optimizer),
                          axis_name=axis) if own else dist
        reducer.communicator.mesh = mesh
        if self._fsdp_axis is not None:
            if self._layout is None:
                self._layout = gspmd.ShardedLayout(
                    reducer.communicator, sizes,
                    self._fsdp_axis).shard(self.get_params())
            self._layout.adopt(self.optimizer, reducer.communicator)
        return gspmd.MeshStep(reducer, self._layout, own_reducer=own)

    def _unshard(self):
        """A sharded model's parameters and optimizer states back to full
        tensors (collective); the next train call shards them again (a
        tensor-parallel model: the next compile)."""
        if self._layout is not None:
            self._layout.unshard()
            self._layout = None
            self._mesh_step = None
            self.drop_graphs()
        if self._spec_layouts:
            for lay in reversed(self._spec_layouts):
                lay.unshard()
            self._spec_layouts = []
            self.drop_graphs()

    # -- tensor and sequence parallelism over a mesh ----------------------------
    def _axis_mesh(self):
        """The mesh the model trains over: ``compile(mesh=)``'s, else its
        ``DistOpt``'s communicator's, else the process-wide one
        (``communicator.set_mesh``), which the communicator then takes, as
        the JAX package's step does; None without a ``DistOpt`` or a
        mesh."""
        from .parallel.communicator import process_mesh
        if self._gspmd_mesh is not None:
            return self._gspmd_mesh
        dist = self._dist_opt()
        if dist is None:
            return None
        if dist.communicator.mesh is None and process_mesh() is not None:
            dist.communicator.mesh = process_mesh()
        return dist.communicator.mesh

    def _shard_spec_axes(self):
        """Under a mesh whose ``model`` or ``expert`` axis is above 1, leave
        on this rank its block of every parameter whose announced spec
        divides the axis (a ``gspmd.ShardedLayout`` per axis, ``by_spec``),
        and make the optimizer's mirroring states follow. ZeRO/FSDP cuts on
        top of these (``_build_mesh_step``)."""
        from .parallel import gspmd
        from .parallel.communicator import Communicator
        from .parallel.mesh import axis_sizes
        axes = self._axis_mesh()
        if axes is None:
            return
        sizes = axis_sizes(axes)
        for axis in gspmd.SPEC_AXES:
            if sizes[axis] <= 1:
                continue
            lay = gspmd.ShardedLayout(
                Communicator(axis_name=axis, mesh=axes), sizes, axis,
                by_spec=True).shard(self.get_params())
            if not lay.params:      # nothing announces this axis
                continue
            self._spec_layouts.append(lay)
            if self.optimizer is not None:
                lay.adopt(self.optimizer, lay.comm)

    def _sharded(self):
        """Whether some state is cut (ZeRO/FSDP, or a model/expert
        axis)."""
        return self._layout is not None or bool(self._spec_layouts)

    def _mesh_scope(self):
        """The axis context of the model's mesh (every axis; the batch
        axes from ``input_specs``), a no-op without one."""
        import contextlib
        from .parallel.communicator import (batch_shard_axes,
                                            collective_context)
        mesh = self._axis_mesh()
        stack = contextlib.ExitStack()
        if mesh is not None:
            stack.enter_context(collective_context(
                *mesh.mesh_dim_names, mesh=mesh))
            stack.enter_context(batch_shard_axes(self._batch_axes()))
        return stack

    def _batch_axes(self):
        spec = self.input_specs[0] if self.input_specs else None
        if spec and spec[0] is not None:
            return spec[0]
        dist = self._dist_opt()
        return dist.axis_name if dist is not None else "data"

    def _axes_block(self, t, dim, axes, mesh):
        """This rank's block of torch tensor ``t`` along ``dim`` sharded
        over ``axes`` (a name or a tuple, row-major over the mesh)."""
        from .parallel.gspmd import _local
        from .parallel.mesh import axis_rank, axis_sizes
        sizes = axis_sizes(mesh)
        index, world = 0, 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            index = index * sizes[a] + axis_rank(mesh, a)
            world *= sizes[a]
        if t.shape[dim] % world:
            raise ValueError(
                f"input dimension {dim} of {tuple(t.shape)} does not "
                f"divide over the {world} ranks of {axes}")
        return _local(t, dim, index, world)

    def _local_inputs(self, args):
        """Each Tensor argument cut to this rank's block per
        ``input_specs`` (the arguments as they are without them)."""
        mesh = self._axis_mesh()
        if not self.input_specs or mesh is None:
            return args
        out, specs = [], list(self.input_specs)
        for i, a in enumerate(args):
            if isinstance(a, Tensor) and i < len(specs) and specs[i]:
                data = a.data
                for dim, axes in enumerate(specs[i]):
                    if axes is not None:
                        data = self._axes_block(data, dim, axes, mesh)
                a = Tensor(data=data, device=a.device,
                           requires_grad=a.requires_grad)
            out.append(a)
        return tuple(out)

    def _global_outputs(self, out, comm, args):
        """The JAX package's output layouts under ``input_specs``
        (``_resolve_leaf_specs``): each floating Tensor leaf gathered along
        its spec's sharded dimensions (``output_specs``, else the batch
        axes for one that leads with the batch of the rank's ``args``),
        the rest (the loss) averaged over the reduce axes."""
        from .parallel import ops as collective
        from .parallel.gspmd import P
        batch = next((a.shape[0] for a in args
                      if isinstance(a, Tensor) and a.ndim), None)
        leaves, rebuild = _flatten_tensors(out)
        specs = list(self.output_specs) if self.output_specs is not None \
            else [P(self._batch_axes()) if t.ndim and t.shape[0] == batch
                  else P() for t in leaves]
        done = []
        for t, spec in zip(leaves, specs):
            if not t.data.is_floating_point():
                done.append(t)
                continue
            data = t.data
            if tuple(spec) == ():
                if comm.effective_world_size() > 1:
                    data = comm.all_reduce(data.clone()) / \
                        comm.effective_world_size()
            else:
                for dim, axes in enumerate(spec):
                    if axes is None:
                        continue
                    for a in reversed(axes if isinstance(axes, tuple)
                                      else (axes,)):
                        data = collective.gather(data, a, dim)
            done.append(t if data is t.data else
                        Tensor(data=data, device=t.device))
        return rebuild(done)

    def _gathered(self):
        import contextlib
        return self._layout.gathered() if self._layout is not None \
            else contextlib.nullcontext()

    def _live_states(self):
        """The live state Tensors by name (a shard under FSDP)."""
        return super().get_states()

    def get_states(self):
        """Every state Tensor by name. Under ZeRO/FSDP or tensor
        parallelism a sharded one comes back as a new Tensor holding its
        full value (collective)."""
        from .parallel.gspmd import full_tensor
        states = self._live_states()
        if not self._sharded():
            return states
        return {k: full_tensor(t) if t.sharding else t
                for k, t in states.items()}

    def _state_tensors(self):
        """The live model and optimizer state Tensors, each once (what a
        rank holds between steps)."""
        seen = {}
        for t in self._live_states().values():
            seen.setdefault(id(t), t)
        if self.optimizer is not None and self.optimizer.device is not None:
            for t in self.optimizer.state_tensors():
                seen.setdefault(id(t), t)
        return list(seen.values())

    def _step_communicator(self):
        if self._mesh_step is not None:
            return self._mesh_step.comm
        dist = self._dist_opt()
        return dist.communicator if dist is not None else None

    def _train_step(self, *args):
        from . import mixed_precision as mp
        from .parallel.communicator import collective_context
        from .parallel.gspmd import step_scope
        if self._meshed() and self._mesh_step is None:
            # sharded again after compile_serving gathered the model
            self._mesh_step = self._build_mesh_step()
        comm = self._step_communicator()
        with self._mesh_scope():
            args = self._local_inputs(args)
            with mp.policy_scope(self._policy), collective_context(comm), \
                    step_scope(self._mesh_step), self._gathered():
                out = self.train_one_batch(*args)
            with torch.no_grad():
                if self._policy is not None:
                    out = self._cast_outputs(out)
                if self.input_specs and self._axis_mesh() is not None:
                    out = self._global_outputs(out, comm, args)
                elif comm is not None and comm.effective_world_size() > 1:
                    batch = next(a.shape[0] for a in args
                                 if isinstance(a, Tensor) and a.ndim)
                    out = self._mean_over_ranks(out, comm, batch)
        return out

    def _mean_over_ranks(self, out, comm, batch):
        """Each floating Tensor of ``out`` whose leading dimension is not
        ``batch`` averaged over the ranks; the rest as it is."""
        if isinstance(out, (tuple, list)):
            return type(out)(self._mean_over_ranks(o, comm, batch)
                             for o in out)
        if isinstance(out, Tensor) and out.data.is_floating_point() and \
                (out.ndim == 0 or out.shape[0] != batch):
            total = comm.all_reduce(out.data.clone())
            return Tensor(data=total / comm.effective_world_size(),
                          device=out.device)
        return out

    def _step_graph(self, args):
        """The :class:`~.graph.StepGraph` of ``args``' signature, made on
        its first call."""
        key = signature(args)
        g = self._graphs.get(key)
        if g is None:
            dev = self.dev or next(
                (a.device for a in args if isinstance(a, Tensor)), None)
            comm = self._step_communicator()
            backend = comm.backend if comm is not None else None
            if dev.is_cuda and backend not in (None, "nccl"):
                raise RuntimeError(
                    f"graph mode over a {backend} process group: its "
                    "collectives cannot be captured in a CUDA graph; "
                    "train over NCCL, or compile with use_graph=False")
            if self._graph_resources is None:
                self._graph_resources = resources(dev)
            g = self._graphs[key] = StepGraph(
                self._train_step, dev, self._graph_resources)
            if len(self._graphs) == 9:
                warnings.warn(
                    "9th distinct input signature captured for this model; "
                    "each costs a capture and keeps its static buffers and "
                    "graph. Pass per-step-varying values as Tensors, not "
                    "python scalars, and pad short batches.", stacklevel=3)
        return g

    def _cast_outputs(self, out):
        """The policy's boundary cast of a Tensor, or of each Tensor of a
        tuple or list."""
        if isinstance(out, (tuple, list)):
            return type(out)(self._cast_outputs(o) for o in out)
        if isinstance(out, Tensor):
            data = self._policy.cast_output(out.data)
            if data is not out.data:
                return Tensor(data=data, device=out.device)
        return out

    def compile_serving(self, policy=None, **kw):
        """Build this model's inference engine (``serving.build_engine``).
        A model with a ``decode_adapter`` (the Transformer LM) gets a
        continuous-batching :class:`~.serving.ServingEngine` on its own
        device (``slots``, ``max_len``, ``prefill_len``,
        ``prefill_batch``, ``kv_layout`` ``"ring"`` or ``"paged"``,
        ``kv_block_size``, ``kv_blocks``, ``speculative_k``,
        ``use_graph``); any other model a fixed-width
        :class:`~.serving.BatchServingEngine` (pass ``input_shape=`` per
        sample, ``batch=`` width, optionally ``device=``). ``policy`` is a
        precision policy or its name (``"bf16_mixed"``), by default the
        one this model was compiled with. The engine is returned
        unstarted: call ``.start()`` or drive
        ``step()``/``run_until_idle()``."""
        from . import mixed_precision as mp
        from .serving import build_engine
        pol = mp.resolve(policy) if policy is not None else self._policy
        self._unshard()        # serving is replicated: gather once
        return build_engine(self, policy=pol, **kw)

    def save_states(self, fpath, aux_states={}):  # noqa: B006 (parity)
        """Zip of the states, the optimizer's states (``optimizer/<name>``)
        and ``aux_states`` (``aux/<name>``) as ``.npz`` plus an attribute
        JSON. bf16 is stored as f32 (numpy has no bf16); the JSON records
        the true dtype. Under ZeRO/FSDP it is collective: every rank
        gathers the full arrays, rank 0 writes, the others wait for it."""
        attr, arrays = {}, {}
        for k, v in self.get_states().items():
            arrays[k] = v.to_numpy()
            attr[k] = {"shape": list(v.shape), "dtype": dtype_name(v.dtype)}
        if self._policy is not None:
            attr["meta/precision_policy"] = self._policy.describe()
        if self.optimizer is not None:
            for k, v in self.optimizer.get_states().items():
                arr = np.asarray(v)
                arrays[f"optimizer/{k}"] = arr
                attr[f"optimizer/{k}"] = {"shape": list(arr.shape),
                                          "dtype": str(arr.dtype),
                                          "optimizer": True}
        for k, v in aux_states.items():
            t = v if isinstance(v, Tensor) else None
            arr = t.to_numpy() if t is not None else np.asarray(v)
            arrays[f"aux/{k}"] = arr
            attr[f"aux/{k}"] = {"shape": list(arr.shape),
                                "dtype": dtype_name(t.dtype) if t is not None
                                else str(arr.dtype), "aux": True}
        sharded = self._sharded()
        if not sharded or _global_rank() == 0:
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            with zipfile.ZipFile(fpath, "w") as zf:
                zf.writestr(TENSOR_DICT_FILENAME, buf.getvalue())
                zf.writestr(STATES_ATTR_FILENAME, json.dumps(attr))
        if sharded:
            _barrier()

    def load_states(self, fpath):
        """Restore states, and the optimizer's states when the model has
        an optimizer, from a ``save_states`` zip written by either
        package; returns the aux states as numpy arrays. Int8-quantized
        archives are refused (quantization is not ported yet). A sharded
        model takes this rank's slice of each sharded state, whatever the
        data degree of the run that saved it."""
        with zipfile.ZipFile(fpath, "r") as zf:
            attr = json.loads(zf.read(STATES_ATTR_FILENAME))
            data = np.load(io.BytesIO(zf.read(TENSOR_DICT_FILENAME)))
            arrays = {k: data[k] for k in data.files}
        if any(isinstance(a, dict) and "quant" in a for a in attr.values()):
            raise NotImplementedError(
                "this archive holds int8-quantized weights; quantized "
                "policies are not ported yet (ROADMAP)")
        load_numpy_states(self, arrays)
        return {k[len("aux/"):]: v for k, v in arrays.items()
                if k.startswith("aux/")}


def _global_rank():
    from .parallel.communicator import initialized
    return torch.distributed.get_rank() if initialized() else 0


def _barrier():
    from .parallel.communicator import initialized
    if initialized():
        torch.distributed.barrier()


def _flatten_tensors(out):
    """The Tensor leaves of ``out`` (a Tensor, or a tuple or list of
    them and other values) and the function that puts leaves back."""
    if isinstance(out, Tensor):
        return [out], lambda leaves: leaves[0]
    if isinstance(out, (tuple, list)):
        idx = [i for i, o in enumerate(out) if isinstance(o, Tensor)]

        def rebuild(leaves):
            items = list(out)
            for i, t in zip(idx, leaves):
                items[i] = t
            return type(out)(items)
        return [out[i] for i in idx], rebuild
    return [], lambda leaves: out
