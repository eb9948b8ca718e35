"""Tensor (model) parallel layers: Megatron-style column and row splits.

Counterpart of ``singa_tpu/parallel/tensor_parallel.py:29-201``:
:class:`ColumnParallelLinear` (with ``gather_output``),
:class:`RowParallelLinear`, :class:`VocabParallelEmbedding` (through
:class:`_MaskedLookup`) and :class:`TPMLP`, with the same constructor
arguments, initialisation and state names (``W``, ``b``), so a
Transformer LM's weights carry across between the packages. Parameters
follow the input's dtype (``:46-49``), as ``layer.Linear``'s do.

Each layer makes its weights at full size and announces their layout on
the parameter (``Tensor.spec``, from ``parallel.gspmd``'s one sharding
vocabulary). A model trained over a mesh whose ``model`` axis is above
1 (``Model.compile`` under a ``DistOpt`` over such a mesh) then holds,
on each rank, its slice of every weight whose announced dimension
divides the axis (``gspmd.fit_state_spec``; an indivisible one, such as
a vocab of 31 over ``model=2``, stays replicated). A layer sees which
form it holds (a weight narrower than its full width) and, with the
``model`` axis active, runs the collectives of ``parallel/ops.py``:
one all-reduce per column -> row pair in the forward, one per column
layer's input in the backward. A full-width weight, or an inactive axis,
is the plain layer: the same code computes the full matmul.
"""

from __future__ import annotations

import math

import torch

from .. import autograd
from ..layer import Layer, _param
from ..tensor import Tensor
from . import ops as collective
from .communicator import active_axis, axis_index
from .gspmd import col_bias_spec, col_spec, row_spec, vocab_spec


class ColumnParallelLinear(Layer):
    """y_local = x @ W[:, shard] + b[shard]: the output features sharded
    over ``axis_name``. Feed its output into a :class:`RowParallelLinear`
    or set ``gather_output=True`` for the full feature dim."""

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
        self.W.spec = col_spec(self.axis_name)
        if self.bias:
            self.b = _param((self.out_features,), x.device, dtype=x.dtype)
            self.b.spec = col_bias_spec(self.axis_name)

    def _sharded(self):
        """A weight narrower than the layer: this rank's column shard."""
        return self.W.shape[-1] < self.out_features

    def forward(self, x):
        if self._sharded():
            # Megatron "f": identity forward, all-reduce backward, since
            # each shard produces only its slice's part of dx
            x = collective.copy_to_parallel(x, self.axis_name)
        y = autograd.matmul(x, self.W)
        if self.bias:
            y = autograd.add_bias(y, self.b, axis=0)
        if self.gather_output and self._sharded():
            y = collective.all_gather(y, self.axis_name, concat_axis=-1)
        return y

    def _own_params(self):
        p = {"W": self.W}
        if self.bias:
            p["b"] = self.b
        return p


class RowParallelLinear(Layer):
    """y = psum(x_local @ W[shard, :]) + b: the input features sharded,
    the bias replicated. Takes the sharded activations a
    :class:`ColumnParallelLinear` made; its one all-reduce completes the
    full matmul."""

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
        self.W.spec = row_spec(self.axis_name)
        if self.bias:
            self.b = _param((self.out_features,), x.device, dtype=x.dtype)

    def _sharded(self):
        return self.W.shape[0] < self.in_features

    def forward(self, x):
        y = autograd.matmul(x, self.W)
        if self._sharded():
            y = collective.all_reduce(y, self.axis_name)
        if self.bias:
            y = autograd.add_bias(y, self.b, axis=0)
        return y

    def _own_params(self):
        p = {"W": self.W}
        if self.bias:
            p["b"] = self.b
        return p


class _MaskedLookup:
    """The rank-local part of an embedding lookup: the rows of this
    rank's vocab shard for ids in its range, zeros elsewhere (an id
    outside ``[0, full_rows)`` is a row of zeros on every rank). The
    enclosing all-reduce completes the lookup; the gradient reaches only
    the local rows."""

    def __init__(self, axis_name, full_rows):
        self.axis_name = axis_name
        self.full_rows = full_rows

    def __call__(self, x, W):
        ids = x.data.detach().long()
        rows = W.shape[0]
        if rows < self.full_rows and active_axis(self.axis_name):
            ids = ids - axis_index(self.axis_name) * rows
        hit = (ids >= 0) & (ids < rows)
        y = torch.nn.functional.embedding(ids.clamp(0, rows - 1), W.data)
        return Tensor(data=torch.where(hit[..., None], y, 0.0),
                      device=x.device)


class VocabParallelEmbedding(Layer):
    """Token embedding with the vocab rows sharded over ``axis_name``
    (Megatron's VocabParallelEmbedding): each rank stores V/tp rows and a
    lookup is a masked local take and one all-reduce. One full-shape
    ``W`` (input_dim, output_dim), N(0, 0.02), outside a mesh, and no
    policy cast applies."""

    def __init__(self, input_dim, output_dim, axis_name="model"):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.axis_name = axis_name

    def initialize(self, x):
        self.W = _param((self.input_dim, self.output_dim), x.device)
        self.W.gaussian(0.0, 0.02)
        self.W.spec = vocab_spec(self.axis_name)

    def _sharded(self):
        return self.W.shape[0] < self.input_dim

    def forward(self, x):
        y = _MaskedLookup(self.axis_name, self.input_dim)(x, self.W)
        if self._sharded():
            y = collective.all_reduce(y, self.axis_name)
        return y

    def _own_params(self):
        return {"W": self.W}


class TPMLP(Layer):
    """Column -> activation -> Row two-layer MLP: one all-reduce."""

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
