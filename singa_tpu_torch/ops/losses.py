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
Pallas kernel, in XLA. The vocab-parallel form (``axis_name``: the head's
columns sharded over a mesh axis) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

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


def _fwd(h, W, b, ids, chunk):
    """(mean loss, lse) of the N rows of ``h`` (N, D) against ``ids``."""
    hf, Wf, bf = h.float(), W.float(), b.float()
    idi = ids.long()
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
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return torch.mean(lse - tgt), lse


def _bwd(h, W, b, ids, lse, g, chunk):
    """(dh, dW, db) of the mean loss, in the inputs' dtypes."""
    hf, Wf, bf = h.float(), W.float(), b.float()
    idi = ids.long()
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
    dW = torch.cat(dWs, 1)[:, :V]
    db = torch.cat(dbs)[:V]
    return dh.to(h.dtype), dW.to(W.dtype), db.to(b.dtype)


class _FusedCE(torch.autograd.Function):
    """The custom gradient of :func:`fused_ce_head`; ids get none."""

    @staticmethod
    def forward(ctx, h, W, b, ids, chunk):
        loss, lse = _fwd(h, W, b, ids, chunk)
        ctx.save_for_backward(h, W, b, ids, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        h, W, b, ids, lse = ctx.saved_tensors
        dh, dW, db = _bwd(h, W, b, ids, lse, g, ctx.chunk)
        return dh, dW, db, None, None


def fused_ce_head(h, W, b, ids, chunk=8192):
    """Mean cross entropy of ``softmax(h @ W + b)`` against ``ids``, over
    torch tensors: h (N, D), W (D, V), b (V,), ids (N,) integer or
    float-encoded. Peak memory is O(N chunk), not O(N V)."""
    return _FusedCE.apply(h, W, b, ids.detach(), int(chunk))


def fused_softmax_cross_entropy(hidden, W, b, ids, chunk=8192,
                                axis_name=None):
    """Tensor API: ``hidden`` (..., D) and ``ids`` (...) are flattened to
    tokens; returns the scalar mean loss. ``axis_name`` (the vocab-
    parallel reduction over a mesh axis) is not ported yet."""
    if axis_name is not None:
        raise NotImplementedError(
            f"the vocab-parallel fused CE head over {axis_name!r} needs a "
            "device mesh and is not ported yet (ROADMAP.md)")
    h = hidden.data
    flat = h.reshape(-1, h.shape[-1])
    return Tensor(data=fused_ce_head(flat, W.data, b.data,
                                     ids.data.reshape(-1), chunk),
                  device=hidden.device)
