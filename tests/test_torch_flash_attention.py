"""The port's flash attention (``singa_tpu_torch/ops/attention.py``, kernels
K3/K4) held against the JAX package's on the same numpy inputs.

On the CPU the port's wrappers run the plain versions of K3 and K4 (the
scan-path forward and backward); they are held against:

- the Pallas kernels ``_flash_fwd_kernel``, ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel`` run in interpret mode
  (``FORCE_PALLAS_INTERPRET = True``, set and restored as
  ``tests/test_attention.py`` does), through ``flash_attention`` and
  ``jax.vjp`` of it, and directly at a multi-block tiling with causal
  pruning and with a position delta;
- the JAX scan path (the flag left False, as on any backend that is not a
  TPU) at a ragged length, S = 72 with ``block_k = 32``, so the last block
  is padded.

Tolerances: f32 rtol/atol 1e-5 (the sums run in another order: XLA's dots
against PyTorch's einsum, and the Pallas kernel accumulates per block
where the scan accumulates per ``block_k``); bf16 2e-2, since both sides
compute in f32 and round the result to bf16 once, so a value that lands
on either side of a rounding boundary differs by one bf16 step (2^-8
relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singa_tpu.ops import attention_mod as JA

from singa_tpu_torch import device as tdevice
from singa_tpu_torch.ops import attention as TA
from singa_tpu_torch.tensor import Tensor

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, H, Sq, Sk, D, dtype, seed=0):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, S, D).astype(np.float32)
            for S in (Sq, Sk, Sk, Sq)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = [jnp.asarray(a).astype(jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


class _Interpret:
    """FORCE_PALLAS_INTERPRET on for the block, restored after."""

    def __enter__(self):
        self.prev = JA.FORCE_PALLAS_INTERPRET
        JA.FORCE_PALLAS_INTERPRET = True

    def __exit__(self, *exc):
        JA.FORCE_PALLAS_INTERPRET = self.prev


def _port_fwd_bwd(tx, causal, block_k=512):
    q, k, v, g = [t.clone().requires_grad_(i < 3) for i, t in enumerate(tx)]
    out = TA.flash_attention(q, k, v, causal, None, block_k)
    out.backward(g)
    return out, q.grad, k.grad, v.grad


def _jax_fwd_bwd(jx, causal, block_k=512):
    q, k, v, g = jx
    out, vjp = jax.vjp(
        lambda a, b, c: JA.flash_attention(a, b, c, causal, None, block_k),
        q, k, v)
    return (out,) + tuple(vjp(g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 128])
def test_plain_version_matches_the_pallas_kernels(S, causal, dtype):
    """Forward and gradients against ``flash_attention`` whose forward and
    backward run the Pallas kernels in interpret mode."""
    jx, tx = _inputs(2, 2, S, S, 16, dtype)
    with _Interpret():
        assert JA._pallas_blocks(jx[0], jx[1]) is not None
        want = _jax_fwd_bwd(jx, causal)
    got = _port_fwd_bwd(tx, causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == tx[0].dtype
        _close(a, b, dtype, f"{name} S={S} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_a_multiblock_pallas_tiling(causal):
    """(out, lse) and (dq, dk, dv) against ``_pallas_flash_fwd`` /
    ``_pallas_flash_bwd`` at 32 x 32 blocks of a 128-long sequence: four
    q and k blocks, the causal grid pruned above the diagonal."""
    jx, tx = _inputs(1, 2, 128, 128, 32, "float32", seed=3)
    scale = 1.0 / np.sqrt(32)
    with _Interpret():
        jo, jl = JA._pallas_flash_fwd(*jx[:3], causal, scale, block_q=32,
                                      block_k=32)
        jg = JA._pallas_flash_bwd(*jx[:3], jo, jl, jx[3], causal, scale,
                                  block_q=32, block_k=32)
    to, tl = TA.flash_fwd(*tx[:3], causal, scale)
    tg = TA.flash_bwd(*tx[:3], to, tl, tx[3], causal, scale)
    _close(to, jo, "float32", "out")
    _close(tl, jl, "float32", "lse")
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        _close(a, b, "float32", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_the_ragged_scan_path(causal, dtype):
    """S = 72 with ``block_k = 32``: the JAX package's scan path pads the
    last key block, and so does the plain version."""
    jx, tx = _inputs(2, 2, 72, 72, 16, dtype, seed=1)
    assert JA._pallas_blocks(jx[0], jx[1]) is None     # the scan path
    want = _jax_fwd_bwd(jx, causal, block_k=32)
    got = _port_fwd_bwd(tx, causal, block_k=32)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, dtype, f"{name} causal={causal}")


@pytest.mark.parametrize("delta", [-40, 0, 24])
def test_pos_delta_matches_the_pallas_kernel(delta):
    """K3's position delta (ring attention): the causal mask on ``q_pos +
    delta``, no pruning, and p = 0 on masked entries, so a fully masked
    row (delta -40: the first 40 rows) comes out 0 with lse -1e30."""
    jx, tx = _inputs(1, 2, 64, 64, 16, "float32", seed=2)
    scale = 1.0 / 4.0
    with _Interpret():
        jo, jl = JA._pallas_flash_fwd(*jx[:3], True, scale, block_q=32,
                                      block_k=32, pos_delta=delta)
    to, tl = TA.flash_fwd(*tx[:3], True, scale, pos_delta=delta)
    _close(to, jo, "float32", "out")
    _close(tl, jl, "float32", "lse")
    if delta < 0:
        assert torch.all(to[:, :, :-delta] == 0)
        assert torch.all(tl[:, :, :-delta] <= -1e29)


def test_function_gradients_are_the_plain_backward():
    """The autograd Function's gradients are exactly what the plain
    backward gives for the saved (q, k, v, out, lse)."""
    _, tx = _inputs(2, 3, 40, 40, 8, "float32", seed=4)
    out, dq, dk, dv = _port_fwd_bwd(tx, True)
    o2, lse = TA.flash_fwd(*tx[:3], True, 1.0 / np.sqrt(8))
    want = TA._scan_flash_bwd(*tx[:3], o2, lse, tx[3], True,
                              1.0 / np.sqrt(8))
    assert torch.equal(out, o2)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    calls = []
    real_fwd, real_bwd = TA._scan_flash_fwd, TA._scan_flash_bwd
    monkeypatch.setattr(TA, "_scan_flash_fwd",
                        lambda *a, **k: calls.append("fwd") or
                        real_fwd(*a, **k))
    monkeypatch.setattr(TA, "_scan_flash_bwd",
                        lambda *a, **k: calls.append("bwd") or
                        real_bwd(*a, **k))
    before = dict(TA.launches)
    _, tx = _inputs(1, 1, 16, 16, 8, "float32")
    _port_fwd_bwd(tx, True)
    assert calls == ["fwd", "bwd"]
    assert TA.launches == before


def test_a_tensor_on_another_device_raises():
    q = torch.empty(1, 1, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="no attention kernel"):
        TA.flash_fwd(q, q, q, True, 1.0)


@pytest.mark.parametrize("D,dtype,err", [
    (512, torch.float32, ValueError), (0, torch.float32, ValueError),
    (64, torch.float16, TypeError)])
def test_the_kernel_checks_refuse_what_the_kernels_do_not_take(D, dtype,
                                                               err):
    """What a CUDA tensor meets before the launch (the checks are device
    independent): head dim 1-256, f32 or bf16."""
    q = torch.zeros(1, 2, 8, D, dtype=dtype)
    with pytest.raises(err):
        TA._checked(q, q, q)


def test_the_k4_wrappers_take_only_cuda_tensors():
    """``flash_bwd_dq`` / ``flash_bwd_dkv`` launch a kernel on the
    pointers they are given, so a CPU tensor is refused before any
    launch (``flash_bwd`` is what dispatches a CPU tensor to the plain
    version)."""
    q = torch.zeros(1, 2, 8, 4)
    rows = torch.zeros(1, 2, 8)
    for fn in (TA.flash_bwd_dq, TA.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, rows, rows, True, 0.5)


def test_attention_refuses_sequence_parallelism():
    """Sequence-parallel attention is ported (ring and Ulysses over an
    active mesh axis: ``tests/test_torch_mesh_ops.py``). With no active
    axis ``seq_axis`` is plain flash attention, as in the JAX package
    (``attention`` outside ``shard_map``): both modes equal the JAX
    package's call within the f32 bound; an unknown ``seq_mode`` is
    still refused."""
    dev = tdevice.create_cpu_device()
    rng = np.random.RandomState(5)
    arrays = [rng.randn(1, 2, 8, 4).astype(np.float32) for _ in range(3)]
    ts = [Tensor(data=a, device=dev) for a in arrays]
    from singa_tpu import device as jdevice
    from singa_tpu import tensor as jtensor
    jdev = jdevice.create_cpu_device()
    js = [jtensor.Tensor(data=a, device=jdev, requires_grad=False)
          for a in arrays]
    for mode in ("ring", "ulysses"):
        got = TA.attention(*ts, causal=True, seq_axis="seq", seq_mode=mode)
        want = JA.attention(*js, causal=True, seq_axis="seq", seq_mode=mode)
        _close(got.data, want.data, "float32", mode)
    with pytest.raises(ValueError, match="seq_mode"):
        TA.attention(ts[0], ts[1], ts[2], seq_mode="spiral")
    out = TA.attention(*ts, causal=True)
    assert out.shape == (1, 2, 8, 4)
