"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K2 (``ops/fused_epilogue.py``), K1, K5, K6, K7
(``ops/fused_optim.py``) and K3, K4 (``ops/attention.py``).

Marked ``cuda``: the kernels have no CPU mode, so each case skips with a
reason where ``torch.cuda.is_available()`` is false. This file imports
only torch and the port, so it runs on a GPU machine without JAX
(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

The kernels multiply and add without contraction (``__fmul_rn`` /
``__fadd_rn`` and the other ``_rn`` intrinsics), so each result is
bitwise-equal to its plain version: K2 in f32 and, rounded once from the
same f32 value, in bf16; the optimizer updates for every parameter and
state type they take. The flash-attention kernels sum in another order
than the plain version's matmuls, so they are held within a tolerance:
1e-4 of the largest reference value in f32, 2e-2 in bf16 (both round one
f32 result to bf16, so a value may land one bf16 step away).
"""

import pytest
import torch

from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import attention as tat
from singa_tpu_torch.ops import fused_optim as tfo


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("residual", [False, True])
def test_cuda_kernel_matches_plain_version(layout, dtype, residual):
    _need_card()
    torch.manual_seed(0)
    shape = (3, 7, 5, 9) if layout == "NCHW" else (3, 5, 9, 7)
    c = shape[1] if layout == "NCHW" else shape[-1]
    x = torch.randn(shape, device="cuda").to(dtype)
    r = torch.randn(shape, device="cuda").to(dtype) if residual else None
    s = torch.rand(c, device="cuda") + 0.5
    b = torch.randn(c, device="cuda")
    before = dict(tfe.launches)
    if residual:
        got = tfe.scale_shift_add_relu(x, s, b, r, layout=layout)
        want = tfe.scale_shift_add_relu_reference(x, s, b, r, layout)
    else:
        got = tfe.scale_shift_relu(x, s, b, layout=layout)
        want = tfe.scale_shift_relu_reference(x, s, b, layout)
    torch.cuda.synchronize()
    key = tfe.variant(layout, residual)
    assert tfe.launches[key] == before[key] + 1
    assert torch.equal(got, want)



# -- K1, K5, K6, K7 -----------------------------------------------------------

_KW = {"sgd": dict(momentum=0.9, dampening=0.1, weight_decay=1e-5),
       "sgd_nesterov": dict(momentum=0.9, weight_decay=1e-5,
                            nesterov=True),
       "adam": dict(beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                    weight_decay=1e-4),
       "rmsprop": dict(rho=0.9, epsilon=1e-8, weight_decay=1e-4),
       "adagrad": dict(epsilon=1e-8, weight_decay=1e-4)}


def _optim_case(kind, shape, p_dtype, s_dtype, gen):
    """([p, g, *states], their clones for the plain version, the device
    scalars, the keyword arguments) for one update of ``kind``. g is f32:
    the wrapper casts it to p's type."""
    def rand(positive=False):
        t = torch.randn(shape, generator=gen, device="cuda")
        return t.abs() if positive else t
    p, g = rand().to(p_dtype), rand()
    if kind == "adam":
        states = [rand().to(s_dtype), rand(positive=True).to(s_dtype)]
    else:
        states = [rand(positive=kind in ("rmsprop", "adagrad"))
                  .to(s_dtype)]
    scalars = (torch.tensor(0.05, device="cuda"),)
    if kind == "adam":
        scalars += (torch.tensor(1 - 0.9 ** 3, device="cuda"),
                    torch.tensor(1 - 0.999 ** 3, device="cuda"))
    mine = [p, g] + states
    return mine, [t.clone() for t in mine], scalars, _KW[kind]


_WRAPPERS = {"sgd": "sgd_momentum_update", "sgd_nesterov":
             "sgd_momentum_update", "adam": "adam_update",
             "rmsprop": "rmsprop_update", "adagrad": "adagrad_update"}


def _call(fn, tensors, scalars, kw):
    p, g, *states = tensors
    return fn(p, g, *states, *scalars, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_WRAPPERS))
@pytest.mark.parametrize("p_dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float16)])
@pytest.mark.parametrize("shape", [(512, 512, 3, 3), (64,), (4099,),
                                   (3, 3, 3, 5)], ids=str)
def test_optimizer_kernel_matches_plain_version(kind, p_dtype, s_dtype,
                                                shape):
    """Bitwise against the plain version on the same inputs; each written
    tensor's version goes up; one launch is counted."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    mine, plain, scalars, kw = _optim_case(kind, shape, p_dtype, s_dtype,
                                           gen)
    name = _WRAPPERS[kind]
    versions = [t._version for t in mine]
    key = kind.split("_")[0]
    before = tfo.launches[key]
    out = _call(getattr(tfo, name), mine, scalars, kw)
    _call(getattr(tfo, name + "_reference"), plain, scalars, kw)
    torch.cuda.synchronize()
    assert tfo.launches[key] == before + 1
    written = [mine[0]] + mine[2:]
    assert all(a is b for a, b in zip(out, written))
    for t, v in zip(written, [versions[0]] + versions[2:]):
        assert t._version > v
    for got, want in zip(written, [plain[0]] + plain[2:]):
        assert torch.equal(got, want), (got.float() - want.float()).abs() \
            .max()


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    _need_card()
    for name in set(_WRAPPERS.values()):
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"{_name}: a CUDA tensor reached the "
                                 "plain version")
        monkeypatch.setattr(tfo, name + "_reference", refuse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for kind in sorted(_WRAPPERS):
        mine, _, scalars, kw = _optim_case(kind, (1000,), torch.float32,
                                           torch.float32, gen)
        _call(getattr(tfo, _WRAPPERS[kind]), mine, scalars, kw)
    torch.cuda.synchronize()


# -- K3, K4 -------------------------------------------------------------------

def _attn_inputs(B, H, Sq, Sk, D, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
            for S in (Sq, Sk, Sk, Sq)]


def _near(got, want, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,D", [(128, 128, 64), (72, 72, 16),
                                     (100, 100, 100), (40, 130, 130),
                                     (130, 40, 32), (64, 64, 256)], ids=str)
def test_flash_kernels_match_plain_version(Sq, Sk, D, causal, dtype):
    """K3's (out, lse) and K4's (dq, dk, dv) against the plain versions;
    one launch of each kernel is counted."""
    _need_card()
    q, k, v, g = _attn_inputs(2, 3, Sq, Sk, D, dtype)
    scale = D ** -0.5
    before = dict(tat.launches)
    out, lse = tat.flash_fwd(q, k, v, causal, scale)
    dq, dk, dv = tat.flash_bwd(q, k, v, out, lse, g, causal, scale)
    ro, rl = tat._scan_flash_fwd(q, k, v, causal, scale)
    rq, rk, rv = tat._scan_flash_bwd(q, k, v, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    assert {n: tat.launches[n] - before[n] for n in before} == \
        {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for got, want in ((out, ro), (dq, rq), (dk, rk), (dv, rv)):
        _near(got, want, dtype)
    _near(lse, rl, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [-40, 0, 24])
def test_flash_fwd_pos_delta_matches_plain_version(delta):
    _need_card()
    q, k, v, _ = _attn_inputs(1, 2, 96, 96, 32, torch.float32, seed=1)
    out, lse = tat.flash_fwd(q, k, v, True, 0.2, pos_delta=delta)
    ro, rl = tat._scan_flash_fwd(q, k, v, True, 0.2, pos_delta=delta)
    torch.cuda.synchronize()
    _near(out, ro, torch.float32)
    _near(lse, rl, torch.float32)


@pytest.mark.cuda
def test_flash_kernels_refuse_a_head_dim_above_256():
    _need_card()
    q = torch.zeros(1, 1, 8, 512, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tat.flash_fwd(q, q, q, True, 1.0)


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_attention(monkeypatch):
    _need_card()

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(tat, "_scan_flash_fwd", refuse)
    monkeypatch.setattr(tat, "_scan_flash_bwd", refuse)
    q, k, v, g = [t.requires_grad_(i < 3) for i, t in enumerate(
        _attn_inputs(1, 2, 64, 64, 32, torch.float32))]
    tat.flash_attention(q, k, v, True).backward(g)
    torch.cuda.synchronize()
    assert q.grad is not None and k.grad is not None and v.grad is not None
