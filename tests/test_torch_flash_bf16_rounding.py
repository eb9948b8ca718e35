"""The rounding rule of the bf16 flash-attention kernels K3/K4
(``singa_tpu_torch/csrc/flash_attention.cu``, ``flash_*_mma_kernel``),
checked on the CPU.

On the tensor cores (``mma.sync`` m16n8k16, bf16 in, f32 sums) the
products of two bf16 inputs are exact in f32 and every sum is f32, so S =
Q K^T and dP = dO V^T are the f32 values. Only two operands are rounded
to bf16 before a product: P (for P V and P^T dO) and dS (for dS K and
dS^T Q). The row sum l, and so lse, is summed from the f32 p before it is
rounded. The JAX kernels compute every product in f32, ``jnp.dot(p,
vblk)`` included.

This file writes that arithmetic out in plain PyTorch (``_tc_fwd``,
``_tc_bwd``: the forward over key tiles of the kernel's width, with its
online softmax) and holds it, on the same numpy inputs in bf16:

- against the JAX package's Pallas kernels ``_pallas_flash_fwd`` /
  ``_pallas_flash_bwd`` in interpret mode (``FORCE_PALLAS_INTERPRET``
  set and restored), at the bf16 tolerance of
  ``tests/test_torch_flash_attention.py`` (rtol/atol 2e-2); lse, an f32
  value, at 1e-4 x max(1, max|lse|);
- against the port's plain versions ``_scan_flash_fwd`` /
  ``_scan_flash_bwd`` at the gate ``chip_smoke.py`` holds the kernels to
  on the card: 2e-2 x max(1, max|ref|) for out, dq, dk, dv and 1e-4 x
  max(1, max|lse|) for lse;
- against the same plain versions at the per-element gate beside it:
  each value of out, dq, dk, dv within 0.025 of its own size plus its
  row's rms.

Cases: causal and not, a length that leaves a ragged last key tile (72,
100), head dims 16 and 100, a multi-tile causal case and a position
delta (forward only, as the kernels take it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu.ops import attention_mod as JA

from singa_tpu_torch.ops import attention as TA

TOL = 2e-2          # bf16: tests/test_torch_flash_attention.py, chip_smoke.py
LSE_TOL = 1e-4      # lse in either dtype (chip_smoke.py FLASH_TOL f32)
ELEM_TOL = 0.025    # per element, bf16 (chip_smoke.py FLASH_ELEM_TOL)
NEG = -1e30


def _bf16(x):
    """x rounded to bf16 (nearest even), as f32."""
    return x.to(torch.bfloat16).float()


def _key_tile(D):
    """Keys per k tile of the bf16 forward kernel (``Tc<DMAX>::BN``)."""
    return 32 if D > 128 else 64


def _tc_fwd(q, k, v, causal, scale, pos_delta=None):
    """K3 on the tensor cores: S in f32 from bf16 inputs, online softmax
    over key tiles, l from the f32 p, P rounded to bf16 for P V; out in
    bf16, lse in f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    bn = _key_tile(D)
    q_pos = torch.arange(Sq)[:, None] + (pos_delta or 0)
    m = torch.full((B, H, Sq), NEG)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Sk, bn):
        kb, vb = kf[:, :, k0:k0 + bn], vf[:, :, k0:k0 + bn]
        k_pos = k0 + torch.arange(kb.shape[2])[None, :]
        ok = k_pos <= q_pos if causal else \
            torch.ones(Sq, kb.shape[2], dtype=torch.bool)
        s = torch.where(ok, qf @ kb.transpose(-1, -2) * scale, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _bf16(p) @ vb
        m = m_new
    ls = l.clamp(min=1e-30)
    return (acc / ls[..., None]).to(torch.bfloat16), m + torch.log(ls)


def _tc_bwd(q, k, v, out, lse, g, causal, scale):
    """K4 on the tensor cores: P and dS in f32, each rounded to bf16 before
    dS K, dS^T Q and P^T dO; dq, dk, dv in bf16."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    Sq, Sk = q.shape[2], k.shape[2]
    delta = (gf * out.float()).sum(-1)
    ok = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] \
        if causal else torch.ones(Sq, Sk, dtype=torch.bool)
    p = torch.where(ok, torch.exp(qf @ kf.transpose(-1, -2) * scale
                                  - lse[..., None]), 0.0)
    dp = gf @ vf.transpose(-1, -2)
    ds = _bf16(p * (dp - delta[..., None]) * scale)
    p = _bf16(p)
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ gf)
    return tuple(t.to(torch.bfloat16) for t in grads)


def _inputs(B, H, Sq, Sk, D, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, S, D).astype(np.float32)
            for S in (Sq, Sk, Sk, Sq)]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


def _t(x):
    """A JAX array as a torch tensor of its dtype (bf16 or f32)."""
    a = np.array(jnp.asarray(x, jnp.float32))
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _gate(got, want, tol, what):
    """|got - want| <= tol x max(1, max|want|) over the live rows (an lse
    of a fully masked row is -1e30 on both sides)."""
    got, want = got.float(), want.float()
    live = want > -1e29
    assert bool((got[~live] <= -1e29).all()), what
    got, want = got[live], want[live]
    ref = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * ref, f"{what}: {err} > {tol} x {ref}"


def _gate_each(got, want, what):
    """|got - want| <= ELEM_TOL x (|want| + rms of the row of want, at
    least 1/64 of its slice's), each value (chip_smoke.py's per-element
    gate)."""
    got, want = got.float(), want.float()
    sq = want.pow(2)
    rms = torch.maximum(sq.mean(-1, keepdim=True),
                        sq.mean((-2, -1), keepdim=True) / 64 ** 2).sqrt()
    err = ((got - want).abs() / (want.abs() + rms).clamp_min(1e-30)).max()
    assert err.item() <= ELEM_TOL, f"{what}: {err.item()} > {ELEM_TOL}"


class _Interpret:
    """FORCE_PALLAS_INTERPRET on for the block, restored after."""

    def __enter__(self):
        self.prev = JA.FORCE_PALLAS_INTERPRET
        JA.FORCE_PALLAS_INTERPRET = True

    def __exit__(self, *exc):
        JA.FORCE_PALLAS_INTERPRET = self.prev


# (Sq, Sk, D, causal, pos_delta, Pallas block): the Pallas kernels need
# blocks that divide the lengths; the tensor-core kernels take 64-key tiles
CASES = [
    (64, 64, 16, False, None, 64),
    (64, 64, 16, True, None, 64),
    (72, 72, 16, False, None, 72),      # ragged last key tile
    (72, 72, 16, True, None, 72),
    (100, 100, 100, False, None, 100),  # D = 100, ragged
    (100, 100, 100, True, None, 100),
    (192, 192, 16, True, None, 64),     # three key tiles, online softmax
    (96, 96, 32, True, -40, 32),        # position delta: rows fully masked
    (96, 96, 32, True, 24, 32),
]
IDS = [f"Sq{c[0]}-D{c[2]}-causal{int(c[3])}-delta{c[4]}" for c in CASES]


@pytest.mark.parametrize("Sq,Sk,D,causal,pos_delta,block", CASES, ids=IDS)
def test_rounding_rule_matches_the_pallas_kernels(Sq, Sk, D, causal,
                                                  pos_delta, block):
    jx, tx = _inputs(1, 2, Sq, Sk, D, seed=Sq + D)
    scale = 1.0 / np.sqrt(D)
    with _Interpret():
        jo, jl = JA._pallas_flash_fwd(*jx[:3], causal, scale, block_q=block,
                                      block_k=block, pos_delta=pos_delta)
        jg = None if pos_delta is not None else JA._pallas_flash_bwd(
            *jx[:3], jo, jl, jx[3], causal, scale, block_q=block,
            block_k=block)
    out, lse = _tc_fwd(*tx[:3], causal, scale, pos_delta)
    np.testing.assert_allclose(out.float().numpy(), _t(jo).float().numpy(),
                               rtol=TOL, atol=TOL, err_msg="out")
    _gate(lse, _t(jl), LSE_TOL, "lse")
    if jg is None:
        return
    grads = _tc_bwd(*tx[:3], _t(jo), _t(jl), tx[3], causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jg):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), _t(b).float().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("Sq,Sk,D,causal,pos_delta,block", CASES, ids=IDS)
def test_rounding_rule_is_within_the_card_gate_of_the_plain_version(
        Sq, Sk, D, causal, pos_delta, block):
    _, tx = _inputs(2, 2, Sq, Sk, D, seed=Sq + D + 1)
    scale = 1.0 / np.sqrt(D)
    out, lse = _tc_fwd(*tx[:3], causal, scale, pos_delta)
    ro, rl = TA._scan_flash_fwd(*tx[:3], causal, scale, pos_delta=pos_delta)
    assert out.dtype == ro.dtype == torch.bfloat16
    _gate(out, ro, TOL, "out")
    _gate(lse, rl, LSE_TOL, "lse")
    if pos_delta is not None:
        return
    grads = _tc_bwd(*tx[:3], out, lse, tx[3], causal, scale)
    want = TA._scan_flash_bwd(*tx[:3], out, lse, tx[3], causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _gate(a, b, TOL, name)


@pytest.mark.parametrize("Sq,Sk,D,causal,pos_delta,block", CASES, ids=IDS)
def test_rounding_rule_is_within_the_per_element_card_gate(
        Sq, Sk, D, causal, pos_delta, block):
    """The same against the per-element gate, which holds each row of out,
    dq, dk and dv to its own size."""
    _, tx = _inputs(2, 2, Sq, Sk, D, seed=Sq + D + 1)
    scale = 1.0 / np.sqrt(D)
    out, lse = _tc_fwd(*tx[:3], causal, scale, pos_delta)
    ro, _ = TA._scan_flash_fwd(*tx[:3], causal, scale, pos_delta=pos_delta)
    _gate_each(out, ro, "out")
    if pos_delta is not None:
        return
    grads = _tc_bwd(*tx[:3], out, lse, tx[3], causal, scale)
    want = TA._scan_flash_bwd(*tx[:3], out, lse, tx[3], causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _gate_each(a, b, name)
