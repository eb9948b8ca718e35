"""Memory-lean loss: the LM head fused with softmax cross entropy.

Counterpart of ``singa_tpu/ops/losses.py:37-190``. :func:`fused_ce_head`
is the LM head matmul and the softmax cross entropy in one chunked
computation, so the (tokens, vocab) logits are never materialised: the
forward scans vocab chunks with an online logsumexp, the backward rescans
and rebuilds each chunk's probabilities from the saved (O(tokens))
logsumexp. The columns that pad the last chunk get a -1e30 bias (zero
weights), so they never reach the logsumexp. The loss is the mean over the
N tokens.

Plain PyTorch (``torch.matmul``): the JAX package computes it outside any
Pallas kernel, in XLA.

The vocab-parallel form (``axis_name``, with that mesh axis active and W,
b this rank's column shard): ids stay global and a rank's vocab offset is
its coordinate on the axis times its local V; each rank runs the chunked
scan over its shard, then one ``pmax`` of m and one ``psum`` each of l
(rescaled to the global max) and of the target logit (exactly one rank
holds it) merge the ranks' online-softmax states, all O(N), never O(V).
The backward ``psum``s dh (h is replicated over the axis; each rank made
its slice's part); dW and db stay the rank's own.
"""

from __future__ import annotations

import torch

from ..parallel import ops as collective
from ..parallel.communicator import active_axis, axis_index
from ..tensor import Tensor

_NEG = -1e30


def _chunk(W, b, ci, chunk):
    """Columns ``[ci*chunk, (ci+1)*chunk)`` of the f32 head, the last chunk
    padded with zero weights and a -1e30 bias."""
    V = W.shape[1]
    lo, hi = ci * chunk, min((ci + 1) * chunk, V)
    Wk, bk = W[:, lo:hi], b[lo:hi]
    pad = chunk - (hi - lo)
    if pad:
        Wk = torch.nn.functional.pad(Wk, (0, pad))
        bk = torch.nn.functional.pad(bk, (0, pad), value=_NEG)
    return Wk, bk


def _offset(axis_name, W):
    """(sharded?, this rank's first vocab column)."""
    if not axis_name or not active_axis(axis_name):
        return False, 0
    return True, axis_index(axis_name) * W.shape[1]


def _fwd(h, W, b, ids, chunk, axis_name=None):
    """(mean loss, lse) of the N rows of ``h`` (N, D) against ``ids``."""
    sharded, offset = _offset(axis_name, W)
    hf, Wf, bf = h.float(), W.float(), b.float()
    idi = ids.long() - offset
    V = W.shape[1]
    n = (V + chunk - 1) // chunk
    N = hf.shape[0]
    owned = (idi >= 0) & (idi < V)
    m = torch.full((N,), _NEG, dtype=torch.float32, device=h.device)
    l = torch.zeros(N, dtype=torch.float32, device=h.device)
    tgt = torch.zeros(N, dtype=torch.float32, device=h.device)
    for ci in range(n):
        Wk, bk = _chunk(Wf, bf, ci, chunk)
        logits = hf @ Wk + bk                        # (N, chunk)
        m_new = torch.maximum(m, logits.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        loc = idi - ci * chunk
        hit = (loc >= 0) & (loc < chunk) & owned
        got = torch.gather(logits, 1, loc.clamp(0, chunk - 1)[:, None])[:, 0]
        tgt = tgt + torch.where(hit, got, 0.0)
        m = m_new
    if sharded:
        m_all = collective.pmax(m, axis_name)
        l = collective.psum(l * torch.exp(m - m_all), axis_name)
        tgt = collective.psum(tgt, axis_name)
        m = m_all
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return torch.mean(lse - tgt), lse


def _bwd(h, W, b, ids, lse, g, chunk, axis_name=None):
    """(dh, dW, db) of the mean loss, in the inputs' dtypes."""
    sharded, offset = _offset(axis_name, W)
    hf, Wf, bf = h.float(), W.float(), b.float()
    idi = ids.long() - offset
    D, V = W.shape
    n = (V + chunk - 1) // chunk
    N = hf.shape[0]
    gN = (g / N).float()
    owned = (idi >= 0) & (idi < V)
    cols = torch.arange(chunk, device=h.device)
    dh = torch.zeros_like(hf)
    dWs, dbs = [], []
    for ci in range(n):
        Wk, bk = _chunk(Wf, bf, ci, chunk)
        logits = hf @ Wk + bk
        p = torch.exp(logits - lse[:, None])          # chunk of softmax
        loc = idi - ci * chunk
        hit = (loc >= 0) & (loc < chunk) & owned
        onehot = ((cols[None, :] == loc[:, None]) & hit[:, None]).float()
        dlog = (p - onehot) * gN
        dh = dh + dlog @ Wk.T
        dWs.append(hf.T @ dlog)
        dbs.append(dlog.sum(0))
    if sharded:
        dh = collective.psum(dh, axis_name)
    dW = torch.cat(dWs, 1)[:, :V]
    db = torch.cat(dbs)[:V]
    return dh.to(h.dtype), dW.to(W.dtype), db.to(b.dtype)


class _FusedCE(torch.autograd.Function):
    """The custom gradient of :func:`fused_ce_head`; ids get none."""

    @staticmethod
    def forward(ctx, h, W, b, ids, chunk, axis_name):
        loss, lse = _fwd(h, W, b, ids, chunk, axis_name)
        ctx.save_for_backward(h, W, b, ids, lse)
        ctx.chunk, ctx.axis_name = chunk, axis_name
        return loss

    @staticmethod
    def backward(ctx, g):
        h, W, b, ids, lse = ctx.saved_tensors
        dh, dW, db = _bwd(h, W, b, ids, lse, g, ctx.chunk, ctx.axis_name)
        return dh, dW, db, None, None, None


def fused_ce_head(h, W, b, ids, chunk=8192, axis_name=None):
    """Mean cross entropy of ``softmax(h @ W + b)`` against ``ids``, over
    torch tensors: h (N, D), W (D, V), b (V,), ids (N,) integer or
    float-encoded. Peak memory is O(N chunk), not O(N V). With
    ``axis_name`` an active mesh axis, W and b are this rank's vocab
    shard and ids stay global (module docstring)."""
    return _FusedCE.apply(h, W, b, ids.detach(), int(chunk), axis_name)


def fused_softmax_cross_entropy(hidden, W, b, ids, chunk=8192,
                                axis_name=None):
    """Tensor API: ``hidden`` (..., D) and ``ids`` (...) are flattened to
    tokens; returns the scalar mean loss. ``axis_name`` turns on the
    vocab-parallel reduction when W's columns are sharded over that
    active mesh axis."""
    h = hidden.data
    flat = h.reshape(-1, h.shape[-1])
    return Tensor(data=fused_ce_head(flat, W.data, b.data,
                                     ids.data.reshape(-1), chunk,
                                     axis_name),
                  device=hidden.device)
