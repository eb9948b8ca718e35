"""Mixture-of-Experts FFN with expert parallelism (GShard-style).

Counterpart of ``singa_tpu/parallel/moe.py:33-113`` (:class:`_MoEFFN`)
and ``:116-170`` (:class:`MoEFFN`). The expert weights shard over the
mesh's ``expert`` axis (a rank holds E/ep experts), the tokens over the
batch-like axes, and two all-to-alls over ``expert`` carry each token to
its expert's rank and back (``parallel/ops.py``'s ``all_to_all``, the
tiled exchange of ``lax.all_to_all``). Outside an active ``expert`` axis
the same code computes the dense MoE on one device.

The routing is the JAX package's, step for step: f32 softmax gates; k
rounds of argmax (ties to the lowest expert), each pick's queue position
``cumsum(hot) - hot + count`` in its expert, kept while below the
capacity C = max(1, ceil(k T cf / E)) of the rank's T tokens, ``count``
growing by the kept picks only; a top-1 pick weighs its raw gate
(Switch), top-k >= 2 divides each kept gate by the sum of every picked
gate, dropped picks included, plus 1e-9; a token with every pick dropped
gets a zero output (the block adds its residual). The load-balance aux
loss is ``E * sum(mean_t gates * mean_t first-pick one-hot)``, both means
global over the active batch axes (``ops.pmean_axes``).

The JAX package dispatches and combines with one-hot einsums over (T, E,
C) tensors. Here both go by index, which computes the same function
without those tensors: each kept (token, pick) is copied into its
(expert, slot) row of an (E C, D) buffer (``index_copy``, one per round;
a dropped pick into a spare row, so that no shape depends on the data),
the experts run as batched products (``torch.bmm``) on the (E, C, D)
buffer, and each token gathers its k rows back and sums them with their
weights. The dispatch is a copy; the combine sums at most k terms, where
the einsum also adds zeros, so the two may differ by an ulp.

Precision: the router and its softmax are f32 for any input of 32 bits
or fewer (f64 for an f64 one); the expert products follow the compute
dtype (the input's, or the active policy's through
``mixed_precision.cast_compute``), as every other matmul of the port
does; the combine sums in the router's dtype and rounds once to that
dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..autograd_base import Operator
from ..layer import Layer, _param
from ..mixed_precision import cast_compute
from . import ops as collective
from .communicator import active_axis, axis_size
from .gspmd import expert_spec

__all__ = ["MoEFFN", "capacity"]


def capacity(n_tokens, n_experts, top_k, capacity_factor):
    """Slots per expert for ``n_tokens`` tokens: max(1, ceil(k T cf / E))."""
    return max(1, math.ceil(top_k * n_tokens * capacity_factor / n_experts))


def route(gates, top_k, cap):
    """The JAX package's top-k loop on (T, E) gates, by index: for each
    round the picked expert (T,), whether the pick was kept (T,), and its
    slot in the (E C) buffer (T,; meaningful where kept); the first
    round's picks give the aux loss's one-hot."""
    T, E = gates.shape
    masked = gates.detach()
    count = torch.zeros(E, dtype=torch.int64, device=gates.device)
    rounds = []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=1)
        hot = F.one_hot(idx, E)
        # the running count of each expert over the tokens, scanned along
        # the innermost dimension of the (E, T) transpose: a scan along
        # the outer dimension of (T, E) walks the T tokens one by one
        # (2.9 ms at T = 8192 on the H100, against the forward's 5.5)
        pos = torch.cumsum(hot.t().contiguous(), 1).t() - hot + count
        pos = pos.gather(1, idx[:, None])[:, 0]
        keep = pos < cap
        count = count + (hot * keep[:, None]).sum(0)
        rounds.append((idx, keep, idx * cap + pos))
        masked = masked * (1 - hot).to(masked.dtype)
    return rounds


class _MoEFFN(Operator):
    """(T, D) tokens -> (T, D) expert-mixed output and the scalar aux
    loss. Differentiated by torch autograd through the index copies, the
    products and the all-to-alls' own backward."""

    def __init__(self, n_experts, top_k, capacity_factor, axis_name,
                 batch_axes):
        super().__init__()
        self.E = n_experts
        self.k = top_k
        self.cf = capacity_factor
        self.axis_name = axis_name
        self.batch_axes = tuple(batch_axes)

    def forward(self, x, wg, w1, b1, w2, b2):
        T, D = x.shape
        E, k = self.E, self.k
        C = capacity(T, E, k, self.cf)
        # the router in f32, or wider for a wider input
        acc = torch.promote_types(x.dtype, torch.float32)
        gates = torch.softmax(x.to(acc) @ wg.to(acc), dim=-1)
        rounds = route(gates, k, C)

        # dispatch: each kept pick's token into its (expert, slot) row, a
        # dropped one into the spare row E*C (shapes stay static: a CUDA
        # graph captures the step)
        ein = x.new_zeros(E * C + 1, D)
        for _idx, keep, slot in rounds:
            ein = ein.index_copy(0, torch.where(keep, slot, E * C), x)
        ein = ein[:E * C].view(E, C, D)

        ep = self._expert_degree(w1)
        if ep > 1:
            ein = collective.all_to_all(ein, self.axis_name, 0, 1)
        xe, w1c, b1c, w2c, b2c = cast_compute(ein, w1, b1, w2, b2)
        h = F.gelu(torch.bmm(xe, w1c) + b1c[:, None, :], approximate="tanh")
        out = torch.bmm(h, w2c) + b2c[:, None, :]
        if ep > 1:
            out = collective.all_to_all(out, self.axis_name, 1, 0)

        # combine: each token's k rows back, weighed by its gates (a top-1
        # pick by the raw gate, top-k by the gates over all picks' sum);
        # a dropped pick reads the zero row E*C with weight 0
        picked = [gates.gather(1, idx[:, None])[:, 0]
                  for idx, _keep, _slot in rounds]
        denom = sum(picked) + 1e-9 if k > 1 else None
        weights = torch.stack(
            [torch.where(keep, g if denom is None else g / denom, 0.0)
             for g, (_idx, keep, _slot) in zip(picked, rounds)], 1)
        slots = torch.stack([torch.where(keep, slot, E * C)
                             for _idx, keep, slot in rounds], 1)
        rows = torch.cat([out.reshape(E * C, D), out.new_zeros(1, D)])
        wc = weights.to(rows.dtype).to(acc)
        y = (rows[slots].to(acc) * wc[..., None]).sum(1).to(rows.dtype)

        # load-balance aux: E * sum_e mean_t(gate_e) * mean_t(pick1_e),
        # each mean global over the active batch axes
        first = F.one_hot(rounds[0][0], E).to(acc)
        gmean = collective.pmean_axes(gates.mean(0), self.batch_axes)
        with torch.no_grad():
            mmean = collective.PMeanAxes(self.batch_axes).forward(
                first.mean(0))
        aux = E * torch.sum(gmean * mmean)
        return y, aux.to(x.dtype)

    def _expert_degree(self, w1):
        """The ``expert`` axis's degree when it is active: the experts
        then shard over it and ``w1`` holds this rank's E/ep of them."""
        if not self.axis_name or not active_axis(self.axis_name):
            return 1
        ep = axis_size(self.axis_name)
        if self.E % ep != 0:
            raise ValueError(
                f"n_experts={self.E} must divide by the '{self.axis_name}' "
                f"mesh degree {ep}")
        if ep > 1 and w1.shape[0] != self.E // ep:
            raise ValueError(
                f"the '{self.axis_name}' axis is active at degree {ep} but "
                f"the expert bank holds {w1.shape[0]} of {self.E} experts: "
                "train the model under a DistOpt over that mesh "
                "(Model.compile shards the banks)")
        return ep


class MoEFFN(Layer):
    """Drop-in FFN block whose experts shard over the mesh ``expert``
    axis. ``forward`` returns the mixed output; the load-balance aux loss
    of the call is ``self.aux_loss``, a Tensor valid inside the same
    ``train_one_batch`` (add ``alpha * aux_loss`` to the loss there).
    ``n_experts`` must divide by the expert-axis degree; with no active
    mesh the same layer computes the dense MoE on one device."""

    def __init__(self, n_experts, d_ff, top_k=2, capacity_factor=1.25,
                 axis_name="expert", batch_axes=("data", "expert", "seq")):
        super().__init__()
        if top_k > n_experts:
            raise ValueError(
                f"top_k={top_k} cannot exceed n_experts={n_experts}")
        self.n_experts = n_experts
        self.d_ff = d_ff
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name
        self.batch_axes = batch_axes
        self.aux_loss = None

    def initialize(self, x):
        D, F_, E = x.shape[-1], self.d_ff, self.n_experts
        dev = x.device
        # the router stays f32; the experts follow the input's dtype
        self.wg = _param((D, E), dev)
        self.wg.gaussian(0.0, math.sqrt(1.0 / D))
        self.w1 = _param((E, D, F_), dev, dtype=x.dtype)
        self.w1.gaussian(0.0, math.sqrt(2.0 / (D + F_)))
        self.b1 = _param((E, F_), dev, dtype=x.dtype)
        self.w2 = _param((E, F_, D), dev, dtype=x.dtype)
        self.w2.gaussian(0.0, math.sqrt(2.0 / (D + F_)))
        self.b2 = _param((E, D), dev, dtype=x.dtype)
        if self.axis_name:
            for t in (self.w1, self.b1, self.w2, self.b2):
                t.spec = expert_spec(self.axis_name)

    def forward(self, x):
        from .. import autograd
        shape = x.shape
        if len(shape) > 2:
            x = autograd.reshape(x, (-1, shape[-1]))
        y, aux = _MoEFFN(self.n_experts, self.top_k, self.capacity_factor,
                         self.axis_name, self.batch_axes)(
            x, self.wg, self.w1, self.b1, self.w2, self.b2)
        self.aux_loss = aux
        if len(shape) > 2:
            y = autograd.reshape(y, shape)
        return y

    def _own_params(self):
        return {"wg": self.wg, "w1": self.w1, "b1": self.b1,
                "w2": self.w2, "b2": self.b2}
