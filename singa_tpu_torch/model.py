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
"""

from __future__ import annotations

import io
import json
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
    tensors, each cast to the live tensor's dtype. ``optimizer/<name>``
    entries go to the model's optimizer (``set_states``; a guard takes its
    ``guard/`` and ``guard-shadow/`` ones) when it has one; ``aux/`` and
    ``quant-scale/`` entries are not model states and are skipped. With
    ``strict`` (the default) every model state must be present. A model
    whose layers have not run yet has no states: run it once
    (``compile_serving`` does) before loading. Returns the model state
    names loaded."""
    mine = model.get_states()
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
            arr = np.asarray(v)
            if tuple(arr.shape) != tuple(mine[k].shape):
                raise ValueError(f"state {k!r}: shape {arr.shape} does not "
                                 f"match the model's {mine[k].shape}")
            mine[k].copy_from_numpy(arr)
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

        for t in self.get_states().values():
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

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False, policy=None):
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
        under another policy casts the masters to its param dtype."""
        from . import mixed_precision as mp
        assert len(inputs) > 0
        pol = mp.resolve(policy)
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
        for name, t in self.get_states().items():
            t.name = t.name or name
        if self.optimizer is not None:
            self.optimizer.bind(self.dev)
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
                return self._step_graph(args)(*args)
            return self._train_step(*args)
        prev = CTX.training
        CTX.training = False
        try:
            with torch.no_grad(), mp.policy_scope(self._policy):
                out = self.forward(*args, **kwargs)
        finally:
            CTX.training = prev
        return out if self._policy is None else self._cast_outputs(out)

    def _train_step(self, *args):
        from . import mixed_precision as mp
        with mp.policy_scope(self._policy):
            out = self.train_one_batch(*args)
        if self._policy is None:
            return out
        with torch.no_grad():
            return self._cast_outputs(out)

    def _step_graph(self, args):
        """The :class:`~.graph.StepGraph` of ``args``' signature, made on
        its first call."""
        key = signature(args)
        g = self._graphs.get(key)
        if g is None:
            dev = self.dev or next(
                (a.device for a in args if isinstance(a, Tensor)), None)
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
        """Build this model's inference engine (``serving.build_engine``):
        a fixed-width :class:`~.serving.BatchServingEngine` for a
        stateless model (pass ``input_shape=`` per sample, ``batch=``
        width, optionally ``device=``). ``policy`` is a precision policy
        or its name (``"bf16_mixed"``). The engine is returned unstarted:
        call ``.start()`` or drive ``step()``/``run_until_idle()``."""
        from . import mixed_precision as mp
        from .serving import build_engine
        pol = mp.resolve(policy) if policy is not None else self._policy
        return build_engine(self, policy=pol, **kw)

    def save_states(self, fpath, aux_states={}):  # noqa: B006 (parity)
        """Zip of the states, the optimizer's states (``optimizer/<name>``)
        and ``aux_states`` (``aux/<name>``) as ``.npz`` plus an attribute
        JSON. bf16 is stored as f32 (numpy has no bf16); the JSON records
        the true dtype."""
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
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with zipfile.ZipFile(fpath, "w") as zf:
            zf.writestr(TENSOR_DICT_FILENAME, buf.getvalue())
            zf.writestr(STATES_ATTR_FILENAME, json.dumps(attr))

    def load_states(self, fpath):
        """Restore states, and the optimizer's states when the model has
        an optimizer, from a ``save_states`` zip written by either
        package; returns the aux states as numpy arrays. Int8-quantized
        archives are refused (quantization is not ported yet)."""
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
