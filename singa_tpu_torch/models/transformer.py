"""Decoder-only Transformer LM: pre-norm GPT-style blocks over the
hand-written flash-attention kernels K3/K4.

Counterpart of ``singa_tpu/models/transformer.py:33-487``: ``_Positions``,
:class:`MultiHeadAttention` (three separate q/k/v projections, so the
state names match), :class:`TransformerBlock` (dense GELU FFN, or with
``moe`` the Mixture-of-Experts FFN of ``parallel/moe.py``),
:class:`TransformerLM` (``forward``, ``train_one_batch`` with both loss
paths and the MoE aux losses, ``compute_dtype``, ``remat``, ``generate``)
and :func:`create_model`. Every attention call goes through
``ops.attention.attention``: kernel K3 forward and K4 backward on the
card.

``train_one_batch(ids, targets)`` takes float tensors of token ids and
target ids, both (B, S) ((B, S/n) per rank under sequence parallelism).
The full-logits loss builds a (B*S, V) f32 one-hot, as the JAX package
does; ``fused_head_chunk`` trains through the chunked fused CE head
(``ops/losses.py``), which never materialises the logits.

Parallelism follows the mesh the model trains over (``Model.compile``
under a ``DistOpt`` whose communicator has a mesh): ``tp`` layers
(``parallel/tensor_parallel.py``) hold their shard of each weight and run
Megatron's collectives when the ``model`` axis is above 1, the vocab ends
included (with ``fused_head_chunk`` the CE loss reduces across vocab
shards online); ``seq_axis`` (``'seq'``) switches attention to ring or
Ulysses sequence parallelism (``seq_mode``) and the positions to global
ones, with the caller setting ``Model.input_specs = [P('data', 'seq'),
...]``; ``moe`` experts shard over the ``expert`` axis, the tokens over
``input_specs = [P(('data', 'expert')), ...]``. ``remat`` rematerialises
each block in the backward (``autograd.checkpoint``: K3 runs twice per
block per step; the loss adds the MoE aux losses of the forward, read
before the backward).

:meth:`TransformerLM.generate` decodes with a static KV cache on one
device, from the live weights (a sharded model's gathered): one causal
prefill, then one token a step, attention as plain einsum/softmax as in
the JAX package (``:405-433``), which runs no Pallas kernel there; a MoE
block decodes through the same MoE op with the expert axis inactive and
a drop-free capacity (cf = E, ``:374-392``).

:meth:`TransformerLM.decode_adapter` is the serving engine's half of the
model (``singa_tpu/models/transformer.py:488-912``): :class:`_LMServeAdapter`
holds the fixed-shape prefill and decode programs over the ring cache and
the paged block pool (``serving/kv_cache.py``) that
``Model.compile_serving`` captures into CUDA graphs. Its sharded
(``sharding_specs``, ``greedy_*``) and quantized programs are not ported
yet and raise ``NotImplementedError`` naming ROADMAP.md (slice D2).
"""

from __future__ import annotations

import math

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
    """Float global position ids of a (B, S) block of tokens: ``arange(S)``,
    plus ``rank_on_seq * S`` under an active sequence-parallel axis."""

    def __init__(self, seq_axis=None):
        self.seq_axis = seq_axis

    def __call__(self, ids):
        from ..parallel.communicator import active_axis, axis_index
        B, S = ids.shape[0], ids.shape[1]
        off = 0
        if self.seq_axis and active_axis(self.seq_axis):
            off = axis_index(self.seq_axis) * S
        pos = torch.arange(off, off + S, dtype=torch.float32,
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
        """``moe``: the number of experts; the dense FFN is then a
        :class:`~..parallel.moe.MoEFFN` over the mesh ``expert`` axis
        (``self.mlp.aux_loss`` is valid inside the same
        ``train_one_batch``). ``moe_top_k`` defaults to ``min(2, moe)``."""
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.ln1 = layer.LayerNorm()
        self.attn = MultiHeadAttention(d_model, n_heads, causal, tp,
                                       seq_axis, seq_mode=seq_mode)
        self.ln2 = layer.LayerNorm()
        if moe:
            from ..parallel.moe import MoEFFN
            top_k = moe_top_k if moe_top_k is not None else min(2, moe)
            self.mlp = MoEFFN(moe, d_ff, top_k=top_k,
                              capacity_factor=moe_capacity_factor)
        else:
            self.mlp = tp_mod.TPMLP(d_ff, d_model, activation="gelu")

    def forward(self, x):
        x = autograd.add(x, self.attn(self.ln1(x)))
        return autograd.add(x, self.mlp(self.ln2(x)))


class TransformerLM(model.Model):
    """GPT-style language model with next-token loss.

    ``moe``: experts per block (the MoE FFN over the ``expert`` mesh axis);
    the blocks' load-balance aux losses join the training loss scaled by
    ``moe_aux_weight``. ``moe_top_k`` defaults to ``min(2, moe)``.

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
        self.compute_dtype = compute_dtype
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.remat = remat
        self.moe = moe
        self.moe_aux_weight = moe_aux_weight
        self.fused_head_chunk = fused_head_chunk
        self.tok_emb = tp_mod.VocabParallelEmbedding(vocab_size, d_model)
        self.pos_emb = layer.Embedding(max_len, d_model)
        self._pos = _Positions(seq_axis)
        self.blocks = [TransformerBlock(
            d_model, n_heads, causal=causal, tp=tp, seq_axis=seq_axis,
            moe=moe, moe_top_k=moe_top_k,
            moe_capacity_factor=moe_capacity_factor, seq_mode=seq_mode)
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
            x = autograd.checkpoint(blk, x) if self.remat else blk(x)
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
            # the layer's own sharded check turns the cross-shard
            # reduction on
            ax = self.head.axis_name if self.head._sharded() else None
            loss = fused_softmax_cross_entropy(
                h, self.head.W, self.head.b, targets, self.fused_head_chunk,
                axis_name=ax)
            out = None
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
        if self.moe:
            for blk in self.blocks:
                aux = blk.mlp.aux_loss
                if aux.dtype != torch.float32:
                    aux = autograd.astype(aux, np.float32)
                loss = autograd.add(loss, autograd.mul(
                    aux, float(self.moe_aux_weight)))
        self.optimizer(loss)
        # the fused head has no logits: the total loss (with the MoE aux)
        # fills the output slot, so both outputs are what the step took
        return (loss if out is None else out), loss

    def generate(self, ids, max_new_tokens, temperature=1.0, top_k=None,
                 seed=0):
        """Autoregressive decoding with a static KV cache
        (``singa_tpu/models/transformer.py:329-482``): one causal prefill
        of the prompt fills a (B, H, L, D) cache per layer, then each step
        embeds one token and attends against the cache. ``ids``: a Tensor
        or array (B, S0) of prompt ids. ``temperature=0`` is greedy argmax;
        otherwise softmax sampling with optional ``top_k`` from a
        ``torch.Generator`` seeded with ``seed``. Returns a numpy (B, S0 +
        max_new_tokens) int32 array. Reads the live weights on every call
        (a sharded model's are gathered: every rank calls it). Causal
        models only; the prompt and the new tokens must fit ``max_len``."""
        return _decode(self, ids, max_new_tokens, temperature, top_k, seed)

    def decode_adapter(self, policy=None):
        """The serving engine's entry point (``Model.compile_serving``
        routes a model with this method to ``serving.ServingEngine``): an
        :class:`_LMServeAdapter` over this model's weights as they are
        now."""
        return _LMServeAdapter(self, policy=policy)


def _decode_weights(m):
    """The weights the decode needs, each the full tensor (a shard
    gathered) in f32: the JAX package's decode promotes its f32
    activations against bf16 weights, so upcasting the weights once is
    the same arithmetic."""
    from ..parallel.gspmd import full_data

    def w(t):
        return full_data(t).detach().float()

    blocks = []
    for blk in m.blocks:
        at, mlp = blk.attn, blk.mlp
        p = dict(ln1_s=w(blk.ln1.scale), ln1_b=w(blk.ln1.bias),
                 wq=w(at.q_proj.W), bq=w(at.q_proj.b),
                 wk=w(at.k_proj.W), bk=w(at.k_proj.b),
                 wv=w(at.v_proj.W), bv=w(at.v_proj.b),
                 wo=w(at.proj.W), bo=w(at.proj.b),
                 ln2_s=w(blk.ln2.scale), ln2_b=w(blk.ln2.bias))
        if hasattr(mlp, "up"):
            p.update(w_up=w(mlp.up.W), b_up=w(mlp.up.b),
                     w_dn=w(mlp.down.W), b_dn=w(mlp.down.b))
        else:
            # every expert, gathered; "wg" marks the MoE path below
            p.update({k: w(getattr(mlp, k))
                      for k in ("wg", "w1", "b1", "w2", "b2")})
        blocks.append(p)
    return dict(tok=w(m.tok_emb.W), pos=w(m.pos_emb.W),
                lnf_s=w(m.ln_f.scale), lnf_b=w(m.ln_f.bias),
                head_w=w(m.head.W), head_b=w(m.head.b), blocks=blocks)


def _ln(x, s, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * s + b


def _split_heads(t, n_heads):
    B, S, D = t.shape
    return t.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _merge_heads(t):
    B, H, S, hd = t.shape
    return t.transpose(1, 2).reshape(B, S, H * hd)


@torch.no_grad()
def _decode(m, ids, max_new_tokens, temperature=1.0, top_k=None, seed=0,
            on_token=None):
    """:meth:`TransformerLM.generate`'s tokens. ``on_token(logits)``,
    when given, is called after each token is drawn with the (B, V)
    logits it was drawn from (the prefill's first); nothing else keeps
    them."""
    from .decode import sample_logits_torch
    if not m.blocks[0].attn.causal:
        raise NotImplementedError(
            "generate() requires a causal model; this TransformerLM was "
            "built with causal=False")
    arr = ids.data if isinstance(ids, Tensor) else torch.as_tensor(
        np.asarray(ids))
    prompt_np = np.asarray(arr.detach().cpu().numpy()
                           if isinstance(arr, torch.Tensor) else arr
                           ).astype(np.int32)
    if max_new_tokens <= 0:
        return prompt_np
    P = _decode_weights(m)
    dev = P["tok"].device
    prompt = torch.as_tensor(prompt_np, dtype=torch.long, device=dev)
    B, S0 = prompt.shape
    n_heads = m.blocks[0].attn.n_heads
    hd = m.d_model // n_heads
    L = S0 + max_new_tokens
    if L > P["pos"].shape[0]:
        raise ValueError(f"prompt+new tokens ({L}) exceeds max_len "
                         f"{P['pos'].shape[0]}")
    scale = 1.0 / math.sqrt(hd)
    gen = None
    if temperature != 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    moe_op = None
    if m.moe:
        # the training MoE op with the expert axis inactive (the gathered
        # weights hold every expert) and drop-free capacity: cf = E makes
        # C = k T, so none of a step's few tokens is dropped
        from ..parallel.moe import _MoEFFN
        mlp0 = m.blocks[0].mlp
        moe_op = _MoEFFN(mlp0.n_experts, mlp0.top_k,
                         float(mlp0.n_experts), None, ())

    def mlp(p, h2):
        if "wg" in p:
            y, _aux = moe_op.forward(h2.reshape(-1, h2.shape[-1]), p["wg"],
                                     p["w1"], p["b1"], p["w2"], p["b2"])
            return y.reshape(h2.shape)
        up = torch.nn.functional.gelu(h2 @ p["w_up"] + p["b_up"],
                                      approximate="tanh")
        return up @ p["w_dn"] + p["b_dn"]

    def qkv(p, h):
        return [_split_heads(h @ p[f"w{c}"] + p[f"b{c}"], n_heads)
                for c in "qkv"]

    def attend(p, x, q, kc, vc, mask):
        s = torch.einsum("bhqd,bhkd->bhqk", q, kc) * scale
        att = torch.softmax(torch.where(mask, s, float("-inf")), -1)
        o = _merge_heads(torch.einsum("bhqk,bhkd->bhqd", att, vc))
        x = x + (o @ p["wo"] + p["bo"])
        return x + mlp(p, _ln(x, p["ln2_s"], p["ln2_b"]))

    def logits_of(x):
        hN = _ln(x, P["lnf_s"], P["lnf_b"])
        return hN[:, -1] @ P["head_w"] + P["head_b"]

    x = P["tok"][prompt] + P["pos"][torch.arange(S0, device=dev)][None]
    causal = torch.ones(S0, S0, dtype=torch.bool, device=dev).tril()
    caches = []
    for p in P["blocks"]:
        q, k, v = qkv(p, _ln(x, p["ln1_s"], p["ln1_b"]))
        x = attend(p, x, q, k, v, causal)
        kc = torch.zeros(B, n_heads, L, hd, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :S0] = k
        vc[:, :, :S0] = v
        caches.append((kc, vc))

    def draw(x):
        logits = logits_of(x)
        tok = sample_logits_torch(logits, temperature, top_k, gen)
        if on_token is not None:
            on_token(logits)
        return tok

    toks = [draw(x)]
    for pos in range(S0, L - 1):
        x = P["tok"][toks[-1]][:, None] + P["pos"][pos][None, None]
        valid = torch.arange(L, device=dev) <= pos
        for p, (kc, vc) in zip(P["blocks"], caches):
            q, k, v = qkv(p, _ln(x, p["ln1_s"], p["ln1_b"]))
            kc[:, :, pos:pos + 1] = k
            vc[:, :, pos:pos + 1] = v
            x = attend(p, x, q, kc, vc, valid)
        toks.append(draw(x))
    new = torch.stack(toks, 1).to(torch.int32).cpu().numpy()
    return np.concatenate([prompt_np, new], axis=1)


def _ln_serve(x, s, b, eps=1e-5):
    """The serve programs' LayerNorm (``singa_tpu/models/transformer.py:
    310-316``): statistics and the affine in f32, the result cast back to
    ``x``'s dtype (bf16 under a bf16 policy)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * s + b).to(x.dtype)


class _LMServeAdapter:
    """Ring-cache and paged prefill/decode programs: the TransformerLM half
    of the ``serving.ServingEngine`` contract
    (``singa_tpu/models/transformer.py:488-903``).

    Each program is a function of the weights ``P`` (:meth:`params`), the
    KV state (a list of one level per block, updated in place) and fixed
    shape device tensors, and returns f32 logits:

    - ``prefill_fn``: ``(P, cache, tokens (B, S), lengths, slot_ids,
      valid) -> (B, V)``: one causal forward of a padded prompt batch,
      each prompt's k/v rows written into its slot of the ring
      (``valid=False`` rows are batch padding, written to the spare slot);
    - ``decode_fn``: ``(P, cache, tokens (W,), positions (W,), active)
      -> (W, V)``: one token for every slot, its k/v written at ``pos %
      max_len``, attention over the ring;
    - ``paged_prefill_fn``: ``(P, pool, tables (B, n_pages), tokens (B,
      S) suffix tokens, starts (B,) prefix-hit lengths, lengths, valid)
      -> (B, V)``;
    - ``paged_decode_fn``: ``(P, pool, tables (W, n_pages), tokens (W,
      K), positions (W,), counts (W,)) -> (W, K, V)``: ``K > 1`` scores a
      speculative draft in one tick, ``logits[:, i]`` the next-token
      distribution after token ``i``.

    A freed slot needs no cleaning: its rows sit at ring indices the
    position mask reaches only after the next occupant has overwritten
    them, and a rejected draft's rows lie past ``pos``, which the paged
    mask never admits.

    Precision follows the JAX adapter: the block weights and the cache are
    in the compute dtype (the policy's, else the model's
    ``compute_dtype``, else f32); the embeddings, the LayerNorm parameters
    and the head stay f32; LayerNorm computes in f32; the attention softmax
    and the logits are f32. A MoE block runs ``parallel/moe.py``'s op
    with the expert axis inactive and drop-free capacity (cf = E), its
    experts in the wider of the compute dtype and their own."""

    supports_weight_quant = False
    supports_cache_quant = False
    supports_paged = True

    def __init__(self, m, policy=None):
        self.m = m
        self.policy = policy
        at = m.blocks[0].attn
        if not at.causal:
            raise NotImplementedError(
                "serving needs a causal model; this TransformerLM was "
                "built with causal=False")
        self.n_heads = at.n_heads
        self.head_dim = m.d_model // self.n_heads
        self.scale = 1.0 / math.sqrt(self.head_dim)
        self.vocab_size = m.vocab_size
        self.device = m.tok_emb.W.device

    def _compute_dtype(self):
        if self.policy is not None and \
                self.policy.compute_dtype is not None:
            return self.policy.compute_dtype
        return self.m.compute_dtype or torch.float32

    def params(self):
        """A copy of the model's weights (a sharded one's gathered), as the
        programs read them; the engine serves the weights of its build."""
        from ..parallel.gspmd import full_data
        cdt = self._compute_dtype()

        def w(t, dtype=torch.float32):
            return full_data(t).detach().to(dtype, copy=True)

        blocks = []
        for blk in self.m.blocks:
            at, mlp = blk.attn, blk.mlp
            p = dict(ln1_s=w(blk.ln1.scale), ln1_b=w(blk.ln1.bias),
                     ln2_s=w(blk.ln2.scale), ln2_b=w(blk.ln2.bias))
            for name, lin in (("q", at.q_proj), ("k", at.k_proj),
                              ("v", at.v_proj), ("o", at.proj)):
                p[f"w{name}"] = w(lin.W, cdt)
                p[f"b{name}"] = w(lin.b, cdt)
            if hasattr(mlp, "up"):
                p.update(w_up=w(mlp.up.W, cdt), b_up=w(mlp.up.b, cdt),
                         w_dn=w(mlp.down.W, cdt), b_dn=w(mlp.down.b, cdt))
            else:
                # the JAX adapter hands the expert banks over uncast, so
                # its products promote to the wider dtype; the router f32
                et = torch.promote_types(cdt, mlp.w1.dtype)
                p["wg"] = w(mlp.wg)
                p.update({k: w(getattr(mlp, k), et)
                          for k in ("w1", "b1", "w2", "b2")})
            blocks.append(p)
        return dict(tok=w(self.m.tok_emb.W), pos=w(self.m.pos_emb.W),
                    lnf_s=w(self.m.ln_f.scale), lnf_b=w(self.m.ln_f.bias),
                    head_w=w(self.m.head.W), head_b=w(self.m.head.b),
                    blocks=blocks)

    def validate(self, prefill_len, max_len):
        """A prompt longer than the positional table would fail the first
        prefill; fail here, typed."""
        table = int(self.m.pos_emb.input_dim)
        if int(prefill_len) > table:
            raise ValueError(
                f"prefill_len {prefill_len} exceeds this model's "
                f"positional-embedding table ({table} rows): rebuild "
                f"the model with max_len >= {prefill_len} or lower "
                "prefill_len")

    def init_cache(self, slots, max_len):
        from ..serving import kv_cache
        return [kv_cache.init_cache(slots, self.n_heads, max_len,
                                    self.head_dim, self._compute_dtype(),
                                    self.device.torch_device)
                for _ in self.m.blocks]

    def init_pool(self, n_blocks, block_size):
        from ..serving import kv_cache
        return [kv_cache.init_pool(n_blocks, self.n_heads, block_size,
                                   self.head_dim, self._compute_dtype(),
                                   self.device.torch_device)
                for _ in self.m.blocks]

    def _block(self):
        """The one block body every program shares (LN, QKV, attend,
        out-projection, LN, MLP); ``attend(q, k, v, level) -> merged
        output`` is the part that differs, and writes the level."""
        n_heads = self.n_heads
        moe_op = None
        if self.m.moe:
            from ..parallel.moe import _MoEFFN
            mlp0 = self.m.blocks[0].mlp
            moe_op = _MoEFFN(mlp0.n_experts, mlp0.top_k,
                             float(mlp0.n_experts), None, ())

        def mlp(p, h2):
            if "wg" in p:
                x2 = h2.reshape(-1, h2.shape[-1]).to(p["w1"].dtype)
                y, _aux = moe_op.forward(x2, p["wg"], p["w1"], p["b1"],
                                         p["w2"], p["b2"])
                return y.reshape(h2.shape).to(h2.dtype)
            up = torch.nn.functional.gelu(h2 @ p["w_up"] + p["b_up"],
                                          approximate="tanh")
            return up @ p["w_dn"] + p["b_dn"]

        def block(p, x, level, attend):
            h = _ln_serve(x, p["ln1_s"], p["ln1_b"])
            q, k, v = [_split_heads(h @ p[f"w{c}"] + p[f"b{c}"], n_heads)
                       for c in "qkv"]
            o = attend(q, k, v, level)
            x = x + (o.to(x.dtype) @ p["wo"] + p["bo"])
            return x + mlp(p, _ln_serve(x, p["ln2_s"], p["ln2_b"]))

        return block

    def _run(self, P, levels, x, attend):
        """Every block over ``x``, then the final LayerNorm."""
        block = self._block()
        for p, level in zip(P["blocks"], levels):
            x = block(p, x, level, attend)
        return _ln_serve(x, P["lnf_s"], P["lnf_b"])

    @staticmethod
    def _head(P, h):
        return h.float() @ P["head_w"] + P["head_b"]

    def prefill_fn(self):
        from ..serving import kv_cache
        scale, cdt = self.scale, self._compute_dtype()

        def fn(P, cache, tokens, lengths, slot_ids, valid):
            B, S = tokens.shape
            x = (P["tok"][tokens.long()] + P["pos"][:S][None]).to(cdt)
            q_pos = torch.arange(S, device=x.device)[None].expand(B, S)

            def attend(q, k, v, level):
                # the prompt's rows go in first and the queries attend them
                # in the ring, at their positions: the JAX program's causal
                # softmax over the fresh rows (rows past the prompt are
                # masked), in the paged programs' shapes
                for b in range(B):
                    kv_cache.write_prompt(level, slot_ids[b], k[b], v[b],
                                          valid[b])
                rows = torch.where(valid, slot_ids.long(),
                                   level["k"].shape[0] - 1)
                return _merge_heads(kv_cache.attend_positions(
                    q, level["k"][rows], level["v"][rows], q_pos, scale))

            hN = self._run(P, cache, x, attend)
            last = (lengths.long() - 1).clamp(min=0)
            return self._head(P, hN[torch.arange(B, device=x.device),
                                    last])

        return fn

    def decode_fn(self):
        from ..serving import kv_cache
        scale, cdt = self.scale, self._compute_dtype()

        def fn(P, cache, tokens, positions, active):
            positions = positions.long()
            # past the learned table a sequence holds its last embedding
            # (the ring is sliding-window attention by then)
            pos_ids = positions.clamp(max=P["pos"].shape[0] - 1)
            x = (P["tok"][tokens.long()]
                 + P["pos"][pos_ids])[:, None, :].to(cdt)

            def attend(q, k, v, level):
                kv_cache.write_token(level, k[:, :, 0], v[:, :, 0],
                                     positions)
                return _merge_heads(kv_cache.attend(q, level, positions,
                                                    scale))

            return self._head(P, self._run(P, cache, x, attend)[:, 0])

        return fn

    def _paged_core(self):
        """The one paged pass both paged programs share: ``(R, Q)`` tokens
        at absolute positions ``pos_abs``, each layer's fresh k/v written
        through the block tables (``wmask`` drops padding), position-exact
        attention; returns the final-LN hidden states. Chunked prefill and
        the K-token verify are the same math at different (R, Q)."""
        from ..serving import kv_cache
        scale, cdt = self.scale, self._compute_dtype()

        def core(P, pool, tables, tokens, pos_abs, wmask):
            pos_ids = pos_abs.clamp(max=P["pos"].shape[0] - 1)
            x = (P["tok"][tokens.long()] + P["pos"][pos_ids]).to(cdt)

            def attend(q, k, v, level):
                kv_cache.write_rows(level, tables, k, v, pos_abs, wmask)
                return _merge_heads(kv_cache.attend_pages(
                    q, level, tables, pos_abs, scale))

            return self._run(P, pool, x, attend)

        return core

    def paged_prefill_fn(self):
        core = self._paged_core()

        def fn(P, pool, tables, tokens, starts, lengths, valid):
            B, S = tokens.shape
            ar = torch.arange(S, device=tokens.device)
            pos_abs = starts.long()[:, None] + ar[None, :]
            wmask = (ar[None, :] < lengths.long()[:, None]) & valid[:, None]
            hN = core(P, pool, tables, tokens, pos_abs, wmask)
            last = (lengths.long() - 1).clamp(min=0)
            return self._head(P, hN[torch.arange(B, device=hN.device),
                                    last])

        return fn

    def paged_decode_fn(self):
        core = self._paged_core()

        def fn(P, pool, tables, tokens, positions, counts):
            W, K = tokens.shape
            ar = torch.arange(K, device=tokens.device)
            pos_abs = positions.long()[:, None] + ar[None, :]
            wmask = ar[None, :] < counts.long()[:, None]
            return self._head(P, core(P, pool, tables, tokens, pos_abs,
                                      wmask))

        return fn

    def sharding_specs(self, *args, **kwargs):
        raise _not_ported("sharded serving (ROADMAP.md: slice D2, the "
                          "serving half of parallel/gspmd.py)")

    def greedy_prefill_fn(self):
        return self.sharding_specs()

    greedy_decode_fn = greedy_paged_prefill_fn = greedy_paged_decode_fn = \
        greedy_prefill_fn


def create_model(vocab_size=256, **kwargs):
    return TransformerLM(vocab_size, **kwargs)


__all__ = ["TransformerLM", "TransformerBlock", "MultiHeadAttention",
           "create_model"]
