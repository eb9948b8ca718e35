"""Model: the user-facing layer tree with training, eval, states,
checkpoints and the serving entry point.

Counterpart of the single-device subset of ``singa_tpu/model.py``:
:meth:`Model.compile` (``model.py:300-487``), ``set_optimizer``,
``__call__`` (``:1353-1387``: train mode runs ``train_one_batch``, eval
mode runs ``forward``), ``eval`` / ``train``, ``get_states`` /
``set_states``, ``save_states`` / ``load_states`` in the same zip format
(a ``tensor_dict.npz`` plus a ``states_attr.json``, with the optimizer's
states as ``optimizer/<name>`` entries, ``:1605-1770``), and
:meth:`Model.compile_serving`. :func:`load_numpy_states` carries weights
and BN running statistics across from a dict of numpy arrays, such as the
JAX package's ``get_states`` turned to numpy or its ``save_states`` zip.

The JAX package jits the train step (``use_graph=True``). The port runs
it eagerly whatever ``use_graph`` says; capturing the step in a CUDA graph
is a later performance change (ROADMAP).
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

import torch

from .autograd_base import CTX
from .layer import Layer
from .tensor import Tensor, dtype_name

TENSOR_DICT_FILENAME = "tensor_dict.npz"
STATES_ATTR_FILENAME = "states_attr.json"


def load_numpy_states(model, states, strict=True):
    """Copy ``{state name: numpy array}`` into ``model``'s live state
    tensors, each cast to the live tensor's dtype. ``optimizer/``,
    ``aux/`` and ``quant-scale/`` entries are not model states and are
    skipped. With ``strict`` (the default) every model state must be
    present. A model whose layers have not run yet has no states: run it
    once (``compile_serving`` does) before loading. Returns the names
    loaded."""
    mine = model.get_states()
    if not mine:
        raise RuntimeError(
            f"{type(model).__name__} has no states yet: its layers "
            "initialize on their first call -- build the serving engine "
            "(compile_serving) or run one forward before loading states")
    loaded = []
    for k, v in states.items():
        if k.startswith(("optimizer/", "aux/", "quant-scale/")):
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

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def train_one_batch(self, *args, **kwargs):
        raise NotImplementedError

    def train(self, mode=True):
        self._train = mode
        CTX.training = mode

    def eval(self):
        self.train(False)

    def set_optimizer(self, optimizer):
        """Train with ``optimizer``; bound to the model's device once the
        model has one (``compile``)."""
        self.optimizer = optimizer
        if optimizer is not None and self.dev is not None:
            optimizer.bind(self.dev)

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False, policy=None):
        """Initialise every layer with one forward of ``inputs`` (a list
        of Tensors, no gradients, BN in inference), name the states (so
        the optimizer's aux states are ``<state name>:<kind>``), bind the
        optimizer to the inputs' device, and enter train or eval mode.

        ``use_graph`` and ``sequential`` are accepted for parity and
        recorded: the port runs the step eagerly either way (capturing it
        in a CUDA graph is a later performance change, ROADMAP).
        ``policy`` is a precision policy or its name; a 16-bit compute
        policy with ``is_train=True`` raises: the JAX package pairs it with
        dynamic loss scaling (``resilience.GuardedOptimizer``), which is
        not ported yet (ROADMAP)."""
        from . import mixed_precision as mp
        assert len(inputs) > 0
        pol = mp.resolve(policy)
        if is_train and pol is not None and \
                pol.compute_dtype in (torch.bfloat16, torch.float16):
            raise NotImplementedError(
                f"training under policy {pol.name!r} is not ported yet "
                "(ROADMAP: bf16_mixed training with "
                "resilience.GuardedOptimizer's dynamic loss scaling is the "
                "next slice); train in float32")
        self._policy = pol
        self.dev = inputs[0].device
        self.graph_mode = use_graph
        self.sequential = sequential
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
        update). Eval mode: ``forward`` without gradients."""
        from . import mixed_precision as mp
        if self._train:
            if kwargs:
                raise TypeError(
                    "train-mode model calls take positional arguments "
                    f"only; got keyword arguments {sorted(kwargs)}")
            with mp.policy_scope(self._policy):
                return self.train_one_batch(*args)
        prev = CTX.training
        CTX.training = False
        try:
            with torch.no_grad(), mp.policy_scope(self._policy):
                out = self.forward(*args, **kwargs)
        finally:
            CTX.training = prev
        if self._policy is not None and isinstance(out, Tensor):
            out = Tensor(data=self._policy.cast_output(out.data),
                         device=out.device)
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
        opt_states = {k[len("optimizer/"):]: v for k, v in arrays.items()
                      if k.startswith("optimizer/")}
        if self.optimizer is not None and opt_states:
            self.optimizer.set_states(opt_states)
        return {k[len("aux/"):]: v for k, v in arrays.items()
                if k.startswith("aux/")}
