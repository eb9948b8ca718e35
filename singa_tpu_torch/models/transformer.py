"""Decoder-only Transformer LM: pre-norm GPT-style blocks over the
hand-written flash-attention kernels K3/K4.

Counterpart of ``singa_tpu/models/transformer.py:33-247`` on one device:
``_Positions``, :class:`MultiHeadAttention` (three separate q/k/v
projections, so the state names match), :class:`TransformerBlock` (dense
GELU FFN), :class:`TransformerLM` (``forward``, ``train_one_batch`` with
both loss paths, ``compute_dtype``) and :func:`create_model`. Every
attention call goes through ``ops.attention.attention``: kernel K3 forward
and K4 backward on the card.

``train_one_batch(ids, targets)`` takes float tensors of token ids and
target ids, both (B, S). The full-logits loss builds a (B*S, V) f32
one-hot, as the JAX package does; ``fused_head_chunk`` trains through the
chunked fused CE head (``ops/losses.py``), which never materialises the
logits.

Not ported yet, each raising ``NotImplementedError`` naming ROADMAP.md:
``remat`` (rematerialised blocks), ``moe`` (expert-parallel FFN),
``seq_axis`` (ring/Ulysses sequence parallelism), and ``generate`` /
``decode_adapter`` (KV-cache decoding and LM serving). ``tp`` is accepted
for parity: on one device the tensor-parallel layers are plain layers.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import autograd, layer, model
from ..ops.attention import attention
from ..parallel import tensor_parallel as tp_mod
from ..tensor import Tensor


def _not_ported(what):
    return NotImplementedError(
        f"TransformerLM {what} is not ported yet (ROADMAP.md)")


class _Positions:
    """Float position ids ``arange(S)`` broadcast to the (B, S) ids."""

    def __call__(self, ids):
        B, S = ids.shape[0], ids.shape[1]
        pos = torch.arange(S, dtype=torch.float32,
                           device=ids.data.device)
        return Tensor(data=pos[None, :].expand(B, S), device=ids.device)


class MultiHeadAttention(layer.Layer):
    """Fused-attention MHA: q/k/v projections, the head split to (B, H,
    S, D), flash attention, the head merge and the output projection."""

    def __init__(self, d_model, n_heads, causal=True, tp=True,
                 seq_axis=None, axis_name="model", seq_mode="ring"):
        super().__init__()
        assert d_model % n_heads == 0
        self.d_model = d_model
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.causal = causal
        self.seq_axis = seq_axis
        self.seq_mode = seq_mode
        self.q_proj = tp_mod.ColumnParallelLinear(d_model,
                                                  axis_name=axis_name)
        self.k_proj = tp_mod.ColumnParallelLinear(d_model,
                                                  axis_name=axis_name)
        self.v_proj = tp_mod.ColumnParallelLinear(d_model,
                                                  axis_name=axis_name)
        self.proj = tp_mod.RowParallelLinear(d_model, axis_name=axis_name)

    def forward(self, x):
        B, S = x.shape[0], x.shape[1]
        q = self.q_proj(x)                      # (B, S, d)
        k = self.k_proj(x)
        v = self.v_proj(x)
        d = q.shape[-1]
        h = d // self.head_dim

        def split_heads(t):
            t = autograd.reshape(t, (B, S, h, self.head_dim))
            return autograd.transpose(t, (0, 2, 1, 3))  # (B, H, S, D)

        out = attention(split_heads(q), split_heads(k), split_heads(v),
                        causal=self.causal, seq_axis=self.seq_axis,
                        seq_mode=self.seq_mode)
        out = autograd.transpose(out, (0, 2, 1, 3))
        out = autograd.reshape(out, (B, S, d))
        return self.proj(out)


class TransformerBlock(layer.Layer):
    def __init__(self, d_model, n_heads, d_ff=None, causal=True, tp=True,
                 seq_axis=None, moe=None, moe_top_k=None,
                 moe_capacity_factor=1.25, seq_mode="ring"):
        super().__init__()
        if moe:
            raise _not_ported("moe (the expert-parallel FFN)")
        d_ff = d_ff or 4 * d_model
        self.ln1 = layer.LayerNorm()
        self.attn = MultiHeadAttention(d_model, n_heads, causal, tp,
                                       seq_axis, seq_mode=seq_mode)
        self.ln2 = layer.LayerNorm()
        self.mlp = tp_mod.TPMLP(d_ff, d_model, activation="gelu")

    def forward(self, x):
        x = autograd.add(x, self.attn(self.ln1(x)))
        return autograd.add(x, self.mlp(self.ln2(x)))


class TransformerLM(model.Model):
    """GPT-style language model with next-token loss.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): cast the summed
    embeddings to this dtype, so every downstream layer initialises its
    parameters in it and the transformer stack (attention included) runs
    in it; the embedding tables stay f32, norm statistics are f32, and
    both loss paths upcast to f32 before the softmax."""

    def __init__(self, vocab_size, d_model=128, n_heads=4, n_layers=2,
                 max_len=1024, causal=True, tp=True, seq_axis=None,
                 remat=False, moe=None, moe_aux_weight=0.01,
                 moe_top_k=None, moe_capacity_factor=1.25,
                 seq_mode="ring", fused_head_chunk=None,
                 compute_dtype=None):
        super().__init__()
        if remat:
            raise _not_ported("remat (rematerialised blocks)")
        if moe:
            raise _not_ported("moe (the expert-parallel FFN)")
        if seq_axis is not None:
            raise _not_ported(f"seq_axis={seq_axis!r} (ring and Ulysses "
                              "sequence parallelism)")
        self.compute_dtype = compute_dtype
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.remat = remat
        self.moe = moe
        self.moe_aux_weight = moe_aux_weight
        self.fused_head_chunk = fused_head_chunk
        self.tok_emb = tp_mod.VocabParallelEmbedding(vocab_size, d_model)
        self.pos_emb = layer.Embedding(max_len, d_model)
        self._pos = _Positions()
        self.blocks = [TransformerBlock(d_model, n_heads, causal=causal,
                                        tp=tp, seq_mode=seq_mode)
                       for _ in range(n_layers)]
        self.ln_f = layer.LayerNorm()
        self.head = tp_mod.ColumnParallelLinear(vocab_size,
                                                gather_output=True)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def _hidden(self, ids):
        pos = self._pos(ids)
        x = autograd.add(self.tok_emb(ids), self.pos_emb(pos))
        if self.compute_dtype is not None:
            x = autograd.astype(x, self.compute_dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    def forward(self, ids):
        return self.head(self._hidden(ids))     # (B, S, vocab)

    def train_one_batch(self, ids, targets):
        if self.fused_head_chunk:
            # the loss straight from the hidden states: the (B, S, V)
            # logits are never materialised in the training step
            from ..ops.losses import fused_softmax_cross_entropy
            h = self._hidden(ids)
            # parameters only, no forward of the head
            self.head.ensure_initialized(h)
            loss = fused_softmax_cross_entropy(
                h, self.head.W, self.head.b, targets, self.fused_head_chunk)
            out = loss
        else:
            logits = self.forward(ids)
            if self.compute_dtype is not None:
                # softmax over a large vocab needs f32 range
                logits = autograd.astype(logits, np.float32)
            B, S, V = logits.shape
            flat = autograd.reshape(logits, (B * S, V))
            onehot = autograd.onehot(-1, targets, self.vocab_size)
            oh_flat = autograd.reshape(onehot, (B * S, V))
            loss = autograd.softmax_cross_entropy(flat, oh_flat)
            out = logits
        self.optimizer(loss)
        return out, loss

    def generate(self, *args, **kwargs):
        raise _not_ported("generate (KV-cache decoding)")

    def decode_adapter(self, *args, **kwargs):
        raise _not_ported("decode_adapter (LM serving, slice D)")


def create_model(vocab_size=256, **kwargs):
    return TransformerLM(vocab_size, **kwargs)


__all__ = ["TransformerLM", "TransformerBlock", "MultiHeadAttention",
           "create_model"]
