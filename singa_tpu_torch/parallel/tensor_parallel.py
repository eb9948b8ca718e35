"""Tensor-parallel layers, single-device form.

Counterpart of ``singa_tpu/parallel/tensor_parallel.py``:
:class:`ColumnParallelLinear` (``:29``), :class:`RowParallelLinear`
(``:83``), :class:`VocabParallelEmbedding` (``:153``) and :class:`TPMLP`
(``:187``), with the same constructor arguments, initialisation and state
names (``W``, ``b``), so a Transformer LM's weights carry across between
the packages. Outside a mesh the JAX layers degrade to plain layers with
full-shape weights; that is the only form here. Parameters follow the
input's dtype (``:46-49``), as ``layer.Linear``'s do.

A sharded layer (a weight narrower than the layer's full width, as a
mesh's shard would be) raises ``NotImplementedError``: meshes and the
collectives of the Megatron layout are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from .. import autograd
from ..layer import Layer, _param
from ..tensor import Tensor


def _refuse_sharded(layer, sharded):
    if sharded:
        raise NotImplementedError(
            f"{type(layer).__name__} over the {layer.axis_name!r} mesh axis "
            "is sharded; tensor parallelism is not ported yet (ROADMAP.md)")


class ColumnParallelLinear(Layer):
    """y = x @ W + b, W of shape (in_features, out_features)."""

    def __init__(self, out_features, bias=True, gather_output=False,
                 axis_name="model"):
        super().__init__()
        self.out_features = out_features
        self.bias = bias
        self.gather_output = gather_output
        self.axis_name = axis_name

    def initialize(self, x):
        in_features = x.shape[-1]
        self.W = _param((in_features, self.out_features), x.device,
                        dtype=x.dtype)
        std = math.sqrt(2.0 / (in_features + self.out_features))
        self.W.gaussian(0.0, std)
        if self.bias:
            self.b = _param((self.out_features,), x.device, dtype=x.dtype)

    def _sharded(self):
        return self.W.shape[-1] < self.out_features

    def forward(self, x):
        _refuse_sharded(self, self._sharded())
        y = autograd.matmul(x, self.W)
        if self.bias:
            y = autograd.add_bias(y, self.b, axis=0)
        return y

    def _own_params(self):
        p = {"W": self.W}
        if self.bias:
            p["b"] = self.b
        return p


class RowParallelLinear(Layer):
    """y = x @ W + b, W of shape (in_features, out_features)."""

    def __init__(self, out_features, bias=True, axis_name="model"):
        super().__init__()
        self.out_features = out_features
        self.bias = bias
        self.axis_name = axis_name

    def initialize(self, x):
        in_features = x.shape[-1]
        self.in_features = in_features
        self.W = _param((in_features, self.out_features), x.device,
                        dtype=x.dtype)
        std = math.sqrt(2.0 / (in_features + self.out_features))
        self.W.gaussian(0.0, std)
        if self.bias:
            self.b = _param((self.out_features,), x.device, dtype=x.dtype)

    def forward(self, x):
        _refuse_sharded(self, self.W.shape[0] < self.in_features)
        y = autograd.matmul(x, self.W)
        if self.bias:
            y = autograd.add_bias(y, self.b, axis=0)
        return y

    def _own_params(self):
        p = {"W": self.W}
        if self.bias:
            p["b"] = self.b
        return p


class VocabParallelEmbedding(Layer):
    """Token embedding with one full-shape ``W`` (input_dim, output_dim),
    N(0, 0.02). A lookup is the JAX package's masked lookup
    (``_MaskedLookup``, ``:126-150``): an id outside ``[0, input_dim)``
    gives a row of zeros, and no policy cast applies."""

    def __init__(self, input_dim, output_dim, axis_name="model"):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.axis_name = axis_name

    def initialize(self, x):
        self.W = _param((self.input_dim, self.output_dim), x.device)
        self.W.gaussian(0.0, 0.02)

    def _sharded(self):
        return self.W.shape[0] < self.input_dim

    def forward(self, x):
        _refuse_sharded(self, self._sharded())
        ids = x.data.detach().long()
        rows = self.W.shape[0]
        hit = (ids >= 0) & (ids < rows)
        y = torch.nn.functional.embedding(ids.clamp(0, rows - 1), self.W.data)
        return Tensor(data=torch.where(hit[..., None], y, 0.0),
                      device=x.device)

    def _own_params(self):
        return {"W": self.W}


class TPMLP(Layer):
    """Column -> activation -> Row two-layer MLP."""

    def __init__(self, hidden_features, out_features, activation="relu",
                 axis_name="model"):
        super().__init__()
        self.up = ColumnParallelLinear(hidden_features, axis_name=axis_name)
        self.down = RowParallelLinear(out_features, axis_name=axis_name)
        self.activation = activation

    def forward(self, x):
        h = self.up(x)
        h = getattr(autograd, self.activation)(h)
        return self.down(h)
