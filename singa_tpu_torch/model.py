"""Model: the user-facing layer tree with eval/train, states, checkpoints
and the serving entry point.

Counterpart of the serving subset of ``singa_tpu/model.py``: ``eval`` /
``train``, ``get_states`` / ``set_states``, ``save_states`` /
``load_states`` in the same zip format (a ``tensor_dict.npz`` plus a
``states_attr.json``, ``singa_tpu/model.py:1605-1710``), and
:meth:`Model.compile_serving`. :func:`load_numpy_states` carries weights
and BN running statistics across from a dict of numpy arrays, such as the
JAX package's ``get_states`` turned to numpy or its ``save_states`` zip.

``compile`` and the train step arrive with the training slice of the port.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

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

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def train_one_batch(self, *args, **kwargs):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP: slice A, ResNet-50 "
            "training with kernel K1)")

    def train(self, mode=True):
        self._train = mode
        CTX.training = mode

    def eval(self):
        self.train(False)

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
        """Zip of the states as ``.npz`` plus an attribute JSON. bf16 is
        stored as f32 (numpy has no bf16); the JSON records the true
        dtype."""
        attr, arrays = {}, {}
        for k, v in self.get_states().items():
            arrays[k] = v.to_numpy()
            attr[k] = {"shape": list(v.shape), "dtype": dtype_name(v.dtype)}
        if self._policy is not None:
            attr["meta/precision_policy"] = self._policy.describe()
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
        """Restore states from a ``save_states`` zip written by either
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
