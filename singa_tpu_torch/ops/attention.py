"""Flash attention: kernels K3 (forward) and K4 (backward) of the port.

Counterpart of ``singa_tpu/ops/attention.py``: the scan-path plain versions
``_block_scan_attention`` / ``_scan_flash_fwd`` / ``_scan_flash_bwd``
(``:39-171``), :func:`flash_attention` with its custom gradient
(``:589-631``), the ``_FlashAttention`` tape op (``:737-749``) and the
functional :func:`attention` (``:808-835``).

:func:`flash_attention` is a ``torch.autograd.Function``, as the JAX one is
a ``jax.custom_vjp``: its forward runs :func:`flash_fwd` and saves ``(q, k,
v, out, lse)``; its backward runs :func:`flash_bwd`, which computes
``delta = rowsum(dO * O)`` as one f32 PyTorch reduction (as
``_pallas_flash_bwd`` does, ``:541-544``) and launches K4's two kernels.
The S x S score matrix is never materialised in either direction.

Dispatch. A CPU tensor goes to the plain version; a CUDA tensor goes to
the hand-written kernels in ``csrc/flash_attention.cu`` (built at first use
by :mod:`..cuda_build`) or raises. There is no divisibility gate: the JAX
package's declines to the scan path (``_use_pallas``, ``:288-309``) are
Mosaic tiling limits, and the CUDA kernels mask ragged tiles themselves.
The module flag :data:`USE_PLAIN`, read on every call, sends CUDA tensors
to the plain version instead, so a caller can hold the kernels against it
on the card; nothing of the port sets it. ``launches`` counts the kernel
launches by kernel.

The kernels take contiguous (B, H, S, D) tensors, all f32 or all bf16, with
1 <= D <= 256; the wrappers make their inputs contiguous, which is free for
the Transformer LM (its head split, ``autograd.transpose``, already copies
q, k and v into that layout, one copy of each per call) and a copy of each
otherwise. What runs depends on the dtype, behind the same wrappers and
launch counters: f32 inputs reach ``flash_*_kernel``, f32 FMAs on the
CUDA cores; bf16 inputs reach ``flash_*_mma_kernel``, ``mma.sync``
products on the tensor cores with f32 sums, where P and dS are rounded to
bf16 before their products and l (so lse) is summed from the f32 p. The
plain versions compute in f32 for both dtypes and round only their
outputs.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..mixed_precision import cast_compute
from ..tensor import Tensor

_NEG_INF = -1e30

# send CUDA tensors to the plain version too (for comparisons on the card)
USE_PLAIN = False

# kernel launches, by kernel (only where a CUDA kernel runs)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def reset_counts():
    """Zero the launch counters."""
    for k in launches:
        launches[k] = 0


# -- plain PyTorch versions ----------------------------------------------------

def _block_scan_attention(q, k, v, causal, scale, block_k, q_offset=0,
                          k_offset=0, zero_masked=False):
    """Online-softmax attention, scanning over key blocks (f32 inputs).

    q: (B, H, Sq, D), k/v: (B, H, Sk, D). Returns the accumulators
    ``(out, m, l)``. ``q_offset``/``k_offset`` are global position offsets
    for causal masking. ``zero_masked`` zeroes the probability of every
    masked entry, as the Pallas kernel does under a position delta (a
    fully masked row then has ``l = 0``); the scan path of the JAX package
    does not, and neither does this one without it."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_k = min(block_k, Sk)
    nblocks = (Sk + block_k - 1) // block_k
    pad = nblocks * block_k - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    out = torch.zeros(B, H, Sq, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, Sq, dtype=torch.float32, device=dev)
    for blk in range(nblocks):
        kblk = k[:, :, blk * block_k:(blk + 1) * block_k]
        vblk = v[:, :, blk * block_k:(blk + 1) * block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kblk) * scale
        k_pos = k_offset + blk * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos[None, :] < (Sk + k_offset)).expand(Sq, block_k)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if zero_masked:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        out = out * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    vblk)
        m = m_new
    return out, m, l


def _scan_flash_fwd(q, k, v, causal, scale, block_k=512, pos_delta=None):
    """Plain version of K3: ``(out, lse)`` with ``out`` in q's dtype and
    ``lse = m + log(l)`` the f32 log-sum-exp of each query row. With
    ``pos_delta`` the causal mask uses ``q_pos + pos_delta`` and masked
    entries get p = 0, as in the Pallas kernel (``:365-369``)."""
    delta = 0 if pos_delta is None else int(pos_delta)
    out, m, l = _block_scan_attention(
        q.float(), k.float(), v.float(), causal, scale, block_k,
        q_offset=delta, zero_masked=pos_delta is not None)
    ls = torch.clamp(l, min=1e-30)
    lse = m + torch.log(ls)
    return (out / ls[..., None]).to(q.dtype), lse


def _scan_flash_bwd(q, k, v, out, lse, g, causal, scale, block_k=512):
    """Plain version of K4, the blocked flash backward:

        delta = rowsum(dO * O)
        P     = exp(S - lse)           (block recompute)
        dV    = P^T dO
        dS    = P * (dO V^T - delta) * scale
        dQ    = dS K ;  dK = dS^T Q

    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_k = min(block_k, Sk)
    nblocks = (Sk + block_k - 1) // block_k
    pad = nblocks * block_k - Sk
    kp, vp = k.float(), v.float()
    if pad:
        kp = F.pad(kp, (0, 0, 0, pad))
        vp = F.pad(vp, (0, 0, 0, pad))
    qf = q.float()
    gf = g.float()
    delta = (gf * out.float()).sum(-1)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for blk in range(nblocks):
        kblk = kp[:, :, blk * block_k:(blk + 1) * block_k]
        vblk = vp[:, :, blk * block_k:(blk + 1) * block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk) * scale
        k_pos = blk * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos[None, :] < Sk).expand(Sq, block_k)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vblk)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kblk)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, gf))
    dk = torch.cat(dks, 2)[:, :, :Sk]
    dv = torch.cat(dvs, 2)[:, :, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels ----------------------------------------------------------

_SIGNATURES = {
    # name: (C function, pointer args, int args after the scale); the
    # dtype code comes first, then the pointers, the shape (bh, Sq, Sk, D),
    # the scale, the ints and the stream
    "flash_fwd": ("singa_flash_fwd", 5, 3),
    "flash_bwd_dq": ("singa_flash_bwd_dq", 7, 1),
    "flash_bwd_dkv": ("singa_flash_bwd_dkv", 8, 1),
}


def _function(kind):
    from .. import cuda_build
    name, n_ptr, n_int = _SIGNATURES[kind]
    fn = getattr(cuda_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + \
            [ctypes.c_int] * 4 + [ctypes.c_float] + \
            [ctypes.c_int] * n_int + [ctypes.c_void_p]
    return fn


def _run(kind, args, dev):
    err = _function(kind)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    launches[kind] += 1


def _use_kernel(*tensors):
    """True for CUDA tensors (unless :data:`USE_PLAIN`), False for CPU
    tensors; raises for any other device or for mixed devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"attention inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {dev}")
    return not USE_PLAIN


def _checked(q, k, v, *rest):
    """q, k, v (and ``rest``) contiguous, checked for the kernels: one
    dtype of f32/bf16, (B, H, S, D) with k and v alike, 1 <= D <= 256."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"attention takes q (B, H, Sq, D) and k, v (B, H, "
                         f"Sk, D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    D = q.shape[3]
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the flash-attention kernels take head dim 1 to "
                         f"{MAX_HEAD_DIM}, got {D}")
    ts = (q, k, v) + rest
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"the flash-attention kernels take f32 or bf16 "
                        f"inputs of one dtype, got {[t.dtype for t in ts]}")
    if min(q.shape[0] * q.shape[1], q.shape[2], k.shape[2]) == 0:
        raise ValueError("attention over an empty batch or sequence")
    return tuple(t.contiguous() for t in ts)


def flash_fwd(q, k, v, causal, scale, pos_delta=None, block_k=512):
    """K3: ``(out, lse)`` for (B, H, S, D) q, k, v. ``pos_delta`` (an
    int) shifts the query positions of the causal mask (ring attention):
    no k tile is then pruned and a fully masked row comes out 0, with lse
    -1e30. ``block_k`` sets only the plain version's scan block. The CUDA
    kernel on the card, the plain version on the CPU."""
    if not _use_kernel(q, k, v):
        return _scan_flash_fwd(q, k, v, causal, scale, block_k, pos_delta)
    q, k, v = _checked(q, k, v)
    B, H, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _run("flash_fwd",
         (_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
          out.data_ptr(), lse.data_ptr(), B * H, Sq, k.shape[2], D,
          float(scale), int(bool(causal)), int(pos_delta is not None),
          int(pos_delta or 0)), q.device)
    return out, lse


def flash_bwd_dq(q, k, v, g, lse, delta, causal, scale):
    """K4's dQ kernel: ``dq`` from the saved ``lse`` and ``delta =
    rowsum(dO * O)`` (both f32, (B, H, Sq)). CUDA tensors only."""
    _require_cuda(q, k, v, g, lse, delta)
    q, k, v, g = _checked(q, k, v, g)
    B, H, Sq, D = q.shape
    dq = torch.empty_like(q)
    _run("flash_bwd_dq",
         (_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
          g.data_ptr(), _f32c(lse).data_ptr(), _f32c(delta).data_ptr(),
          dq.data_ptr(), B * H, Sq, k.shape[2], D, float(scale),
          int(bool(causal))), q.device)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale):
    """K4's dK/dV kernel: ``(dk, dv)``. CUDA tensors only."""
    _require_cuda(q, k, v, g, lse, delta)
    q, k, v, g = _checked(q, k, v, g)
    B, H, Sq, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run("flash_bwd_dkv",
         (_KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
          g.data_ptr(), _f32c(lse).data_ptr(), _f32c(delta).data_ptr(),
          dk.data_ptr(), dv.data_ptr(), B * H, Sq, k.shape[2], D,
          float(scale), int(bool(causal))), q.device)
    return dk, dv


def _require_cuda(q, *tensors):
    """K4's inputs on one CUDA device, and its row statistics (the last
    two) one value per query row."""
    ts = (q,) + tensors
    if any(t.device.type != "cuda" for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError("the K4 kernels take tensors on one CUDA device; "
                         "flash_bwd runs the plain version on the CPU")
    rows = q.shape[0] * q.shape[1] * q.shape[2] if q.dim() == 4 else -1
    if any(t.numel() != rows for t in tensors[-2:]):
        raise ValueError(f"lse and delta take one value per query row "
                         f"({rows}), got {[t.numel() for t in tensors[-2:]]}")


def _f32c(t):
    return t.to(torch.float32).contiguous()


def flash_bwd(q, k, v, out, lse, g, causal, scale, block_k=512):
    """K4: ``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the
    output cotangent ``g``. On the card, ``delta = rowsum(dO * O)`` is one
    f32 reduction here, then the dQ and the dK/dV kernels run; on the CPU
    the plain version."""
    if not _use_kernel(q, k, v, out, lse, g):
        return _scan_flash_bwd(q, k, v, out, lse, g, causal, scale, block_k)
    g = g.to(q.dtype)
    delta = (g.float() * out.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The custom gradient of :func:`flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k):
        out, lse = flash_fwd(q, k, v, causal, scale, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.block_k = causal, scale, block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g, ctx.causal, ctx.scale,
                               ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_k=512):
    """Fused multi-head attention: softmax(q k^T scale [+ causal mask]) v
    over torch tensors q/k/v of shape (batch, heads, seq, head_dim). The
    backward recomputes per-block probabilities from the saved lse, so
    train-mode memory is O(S D). ``block_k`` sets only the plain version's
    scan block."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, bool(causal), float(scale), int(block_k))


class _FlashAttention:
    """Tape-op counterpart (``:737-749``): q, k, v Tensors in the compute
    dtype of the active policy; the kernels' online-softmax statistics are
    f32 regardless."""

    def __init__(self, causal=False, scale=None):
        self.causal = causal
        self.scale = scale

    def __call__(self, q, k, v):
        qa, ka, va = cast_compute(q.data, k.data, v.data)
        return Tensor(data=flash_attention(qa, ka, va, self.causal,
                                           self.scale), device=q.device)


def attention(q, k, v, causal=False, scale=None, seq_axis=None,
              seq_mode="ring"):
    """Functional API over :class:`_FlashAttention`. Sequence-parallel
    attention (``seq_axis``: ring or Ulysses over a mesh axis) needs a
    device mesh, which the port does not have yet."""
    if seq_mode not in ("ring", "ulysses", "alltoall", "all_to_all"):
        raise ValueError(f"unknown seq_mode {seq_mode!r} "
                         "(expected 'ring' or 'ulysses')")
    if seq_axis is not None:
        raise NotImplementedError(
            f"sequence-parallel attention over {seq_axis!r} ({seq_mode}) "
            "needs a device mesh and is not ported yet (ROADMAP.md: ring "
            "and Ulysses attention)")
    return _FlashAttention(causal, scale)(q, k, v)
