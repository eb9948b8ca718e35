"""Collectives over a mesh axis as differentiable ops with explicit
transposes.

Counterpart of ``singa_tpu/parallel/ops.py:30-176``. Each op runs over
the process group of one axis of the active mesh
(``communicator.collective_context(*axes)``, ``DeviceMesh.get_group``)
and is the identity when the axis is not active (a world of one). Every
op pins its own backward, the JAX package's transpose (Megatron's f/g
pairs):

    AllReduce        fwd psum           bwd identity        ("g")
    CopyToParallel   fwd identity       bwd psum            ("f")
    AllGather        fwd gather         bwd take-own-shard
    ReduceScatter    fwd psum_scatter   bwd all_gather
    PMean            fwd pmean          bwd / axis size
    PMeanAxes        fwd pmean          bwd pmean           (axis tuple)
    AllToAll         fwd all_to_all     bwd the reverse exchange
    Shift            fwd ring shift +k  bwd ring shift -k (ring attention)

They are ``autograd_base.Operator``s over Tensors, as the JAX ones are;
the functional forms (:func:`all_reduce` ... :func:`ring_shift`) take a
Tensor or a torch tensor and return the same kind. The raw collectives
(:func:`psum`, :func:`pmax`, ...) take torch tensors and are what the
ops, the vocab-parallel CE head and ring/Ulysses attention call.

The all-gather and reduce-scatter are ``communicator.gather_over`` and
``scatter_sum_over``, which ``Communicator`` runs too. ``counts`` holds
the collectives started here, by kind (host calls: a CUDA graph's replay
runs what its capture counted): the layers' traffic over mesh axes, while
a ``Communicator``'s own ``counts`` hold the gradient sums and output
averages of its ``DistOpt``; ``host_staged`` the calls here that went
through host memory. Gloo takes all-reduce, all-gather and
reduce-scatter on CUDA tensors, but its all-to-all and point-to-point
sends are taken here only on CPU tensors: under gloo a CUDA tensor of
those two kinds is copied to the host, exchanged and copied back,
explicitly, and counted in ``host_staged``. NCCL never stages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..autograd_base import Operator, _OperatorFunction
from ..tensor import Tensor
from .communicator import (active_axis, axes_group_of, axis_group,
                           axis_index, axis_size, gather_over,
                           scatter_sum_over)

__all__ = ["AllReduce", "CopyToParallel", "AllGather", "ReduceScatter",
           "PMean", "PMeanAxes", "AllToAll", "Shift", "all_reduce",
           "copy_to_parallel", "all_gather", "reduce_scatter", "pmean",
           "pmean_axes", "all_to_all", "ring_shift", "psum", "pmax",
           "gather", "psum_scatter",
           "exchange", "shift", "counts", "host_staged", "reset_counts"]

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "send_recv")
# collectives started over a mesh axis, by kind
counts = dict.fromkeys(KINDS, 0)
# of those, the ones copied through host memory (gloo and CUDA tensors)
host_staged = dict.fromkeys(KINDS, 0)


def reset_counts():
    for d in (counts, host_staged):
        for k in d:
            d[k] = 0


def _live(axis_name):
    """An active axis of more than one rank (over one rank every
    collective is the identity)."""
    return active_axis(axis_name) and axis_size(axis_name) > 1


def _stages(x, group):
    """Whether an all-to-all or a send of ``x`` over ``group`` goes
    through host memory: a CUDA tensor on a gloo group."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


# -- the raw collectives (torch tensors) ----------------------------------------

def psum(x, axes, op=None):
    """The sum (or ``op``) of ``x`` over the ranks of ``axes``, a mesh
    axis's name or a tuple of names (one all-reduce over the group that
    spans their active ones): a new tensor; ``x`` itself when they span
    one rank."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if _ranks(axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM,
                    group=axes_group_of(axes))
    counts["all_reduce"] += 1
    return out


def _ranks(axes):
    """The ranks the active axes among ``axes`` span together."""
    n = 1
    for a in axes:
        n *= axis_size(a)
    return n


def pmax(x, axis_name):
    """The elementwise max of ``x`` over ``axis_name``'s ranks."""
    return psum(x, axis_name, dist.ReduceOp.MAX)


def gather(x, axis_name, dim=-1):
    """The ranks' ``x`` concatenated along ``dim`` in axis order (JAX's
    tiled ``all_gather``)."""
    if not _live(axis_name):
        return x
    out = gather_over(x, axis_group(axis_name), dim)
    counts["all_gather"] += 1
    return out


def psum_scatter(x, axis_name, dim=-1):
    """This rank's slice along ``dim`` of the sum of the ranks' ``x``
    (JAX's tiled ``psum_scatter``)."""
    if not _live(axis_name):
        return x
    out = scatter_sum_over(x, axis_group(axis_name), dim)
    counts["reduce_scatter"] += 1
    return out


def exchange(x, axis_name, split, concat):
    """JAX's tiled ``all_to_all``: ``x`` split along ``split`` into one
    chunk per rank of the axis, chunk j sent to rank j, and the chunks
    received concatenated along ``concat`` in rank order."""
    if not _live(axis_name):
        return x
    n = axis_size(axis_name)
    group = axis_group(axis_name)
    send = torch.stack(x.chunk(n, dim=split % x.dim()), 0).contiguous()
    staged = _stages(send, group)
    wire = send.cpu() if staged else send
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    counts["all_to_all"] += 1
    if staged:
        host_staged["all_to_all"] += 1
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat % x.dim())


def shift(x, axis_name, offset=1):
    """Every rank's ``x`` sent to the rank ``offset`` further along the
    axis's ring, and the one from ``offset`` back received (JAX's
    ``ppermute`` with ``perm = [(i, (i + offset) % n)]``): one send and
    one receive (``batch_isend_irecv``)."""
    if not _live(axis_name):
        return x
    n = axis_size(axis_name)
    if offset % n == 0:
        return x
    group = axis_group(axis_name)
    idx = axis_index(axis_name)
    src = x.contiguous()
    staged = _stages(src, group)
    wire = src.cpu() if staged else src
    recv = torch.empty_like(wire)
    to = dist.get_global_rank(group, (idx + offset) % n)
    frm = dist.get_global_rank(group, (idx - offset) % n)
    ops = [dist.P2POp(dist.isend, wire, to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    counts["send_recv"] += 1
    if staged:
        host_staged["send_recv"] += 1
        recv = recv.to(x.device)
    return recv


# -- the differentiable ops (Tensors) --------------------------------------------

class AllReduce(Operator):
    """psum over a mesh axis. Backward is identity: the summed output's
    cotangent is replicated already."""

    def __init__(self, axis_name="data"):
        super().__init__()
        self.axis_name = axis_name

    def forward(self, x):
        return psum(x, self.axis_name)

    def backward(self, dy):
        return dy


class CopyToParallel(Operator):
    """Identity forward into a model-parallel region; backward sums the
    partial input gradients the shards produce (Megatron's ``f``)."""

    def __init__(self, axis_name="model"):
        super().__init__()
        self.axis_name = axis_name

    def forward(self, x):
        return x.view_as(x)

    def backward(self, dy):
        return psum(dy, self.axis_name)


class AllGather(Operator):
    """Concatenate the shards along ``concat_axis``; backward hands each
    shard the slice of the cotangent it contributed."""

    def __init__(self, axis_name="model", concat_axis=-1):
        super().__init__()
        self.axis_name = axis_name
        self.concat_axis = concat_axis

    def forward(self, x):
        self._local = x.shape[self.concat_axis % x.dim()]
        return gather(x, self.axis_name, self.concat_axis)

    def backward(self, dy):
        if not active_axis(self.axis_name):
            return dy
        start = axis_index(self.axis_name) * self._local
        return dy.narrow(self.concat_axis % dy.dim(), start,
                         self._local).contiguous()


class ReduceScatter(Operator):
    """psum + scatter along ``scatter_axis``; backward all-gathers."""

    def __init__(self, axis_name="model", scatter_axis=-1):
        super().__init__()
        self.axis_name = axis_name
        self.scatter_axis = scatter_axis

    def forward(self, x):
        return psum_scatter(x, self.axis_name, self.scatter_axis)

    def backward(self, dy):
        return gather(dy, self.axis_name, self.scatter_axis)


class PMean(Operator):
    """pmean over a mesh axis (metric averaging)."""

    def __init__(self, axis_name="data"):
        super().__init__()
        self.axis_name = axis_name

    def forward(self, x):
        if not active_axis(self.axis_name):
            return x
        return psum(x, self.axis_name) / axis_size(self.axis_name)

    def backward(self, dy):
        return dy / axis_size(self.axis_name)


class PMeanAxes(Operator):
    """pmean over a tuple of mesh axes (the batch axes of an average that
    must be global, as the MoE aux loss's token means are). Backward is
    the JAX package's transpose of ``lax.pmean``: the pmean of the
    cotangent over the same axes."""

    def __init__(self, axes=("data",)):
        super().__init__()
        self.axes = tuple(axes)

    def _mean(self, x):
        n = _ranks(self.axes)
        return x if n == 1 else psum(x, self.axes) / n

    def forward(self, x):
        return self._mean(x)

    def backward(self, dy):
        return self._mean(dy)


class AllToAll(Operator):
    """Tiled all-to-all over a mesh axis (split ``split_axis`` across the
    axis peers, concatenate what each sends back along ``concat_axis``).
    Backward is the reverse exchange."""

    def __init__(self, axis_name="expert", split_axis=0, concat_axis=1):
        super().__init__()
        self.axis_name = axis_name
        self.split_axis = split_axis
        self.concat_axis = concat_axis

    def forward(self, x):
        return exchange(x, self.axis_name, self.split_axis,
                        self.concat_axis)

    def backward(self, dy):
        return exchange(dy, self.axis_name, self.concat_axis,
                        self.split_axis)


class Shift(Operator):
    """Ring shift by ``offset`` over a mesh axis (``lax.ppermute``);
    backward shifts the cotangent back by ``offset``."""

    def __init__(self, axis_name="seq", offset=1):
        super().__init__()
        self.axis_name = axis_name
        self.offset = offset

    def forward(self, x):
        return shift(x, self.axis_name, self.offset)

    def backward(self, dy):
        return shift(dy, self.axis_name, -self.offset)


def _apply(op, x):
    """``op`` on a Tensor (a Tensor back), or on a torch tensor through
    the same custom gradient (a torch tensor back)."""
    if isinstance(x, Tensor):
        return op(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _OperatorFunction.apply(op, x)
    return op.forward(x)


def all_reduce(x, axis_name="data"):
    return _apply(AllReduce(axis_name), x)


def copy_to_parallel(x, axis_name="model"):
    return _apply(CopyToParallel(axis_name), x)


def all_gather(x, axis_name="model", concat_axis=-1):
    return _apply(AllGather(axis_name, concat_axis), x)


def reduce_scatter(x, axis_name="model", scatter_axis=-1):
    return _apply(ReduceScatter(axis_name, scatter_axis), x)


def pmean(x, axis_name="data"):
    return _apply(PMean(axis_name), x)


def pmean_axes(x, axes=("data",)):
    return _apply(PMeanAxes(axes), x)


def all_to_all(x, axis_name="expert", split_axis=0, concat_axis=1):
    return _apply(AllToAll(axis_name, split_axis, concat_axis), x)


def ring_shift(x, axis_name="seq", offset=1):
    return _apply(Shift(axis_name, offset), x)
