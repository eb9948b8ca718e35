"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K2 (``ops/fused_epilogue.py``), K1, K5, K6, K7 and their
multi-tensor launches (``ops/fused_optim.py``) and K3, K4
(``ops/attention.py``).

Marked ``cuda``: the kernels have no CPU mode, so each case skips with a
reason where ``torch.cuda.is_available()`` is false. This file imports
only torch and the port, so it runs on a GPU machine without JAX
(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

The kernels multiply and add without contraction (``__fmul_rn`` /
``__fadd_rn`` and the other ``_rn`` intrinsics), so each result is
bitwise-equal to its plain version: K2 in f32 and, rounded once from the
same f32 value, in bf16; the optimizer updates for every parameter and
state type they take, per tensor and multi-tensor (over ResNet-50's 161
parameter shapes and over a set that crosses a chunk boundary), and the
multi-tensor ones with a guarded step's skip flag: ok = 1 bitwise with no
flag, ok = 0 writing nothing. The flash-attention kernels sum in another order
than the plain version's matmuls, so they are held within a tolerance:
1e-4 of the largest reference value in f32, 2e-2 in bf16 (both round one
f32 result to bf16, so a value may land one bf16 step away), and each
value within 1e-5 (f32) or 0.025 (bf16) of its own size plus its row's
rms (chip_smoke.py's per-element gate).
"""

import math

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


# -- K1 and K5 multi-tensor launches -----------------------------------------

def _resnet50_shapes():
    """The 161 parameter shapes of ResNet-50 with 10 classes: 53 convs
    (OIHW), 53 BN scales and biases, the fc weight and bias."""
    shapes = [(64, 3, 7, 7), (64,), (64,)]
    cin = 64
    for width, blocks in zip((64, 128, 256, 512), (3, 4, 6, 3)):
        for b in range(blocks):
            shapes += [(width, cin, 1, 1), (width,), (width,),
                       (width, width, 3, 3), (width,), (width,),
                       (4 * width, width, 1, 1), (4 * width,), (4 * width,)]
            if b == 0:
                shapes += [(4 * width, cin, 1, 1), (4 * width,),
                           (4 * width,)]
            cin = 4 * width
    return shapes + [(2048, 10), (10,)]


_MULTI_SETS = {
    "resnet50": _resnet50_shapes,
    # 180 entries: past both chunk capacities, with ragged and tiny ones
    "chunk_boundary": lambda: [(4099,), (64,), (1,), (3, 3, 3, 5)] * 45,
}
_MULTI_KW = {"sgd": dict(momentum=0.9, dampening=0.1),
             "sgd_nesterov": dict(momentum=0.9, nesterov=True),
             "adam": dict(beta_1=0.9, beta_2=0.999, epsilon=1e-8)}


def _multi_entries(kind, shapes, p_dtype, s_dtype, gen):
    """Entries ``(p, g, *states, lr, weight_decay)`` with two lr tensors
    and three weight decays in turn, and their clones."""
    lrs = [torch.tensor(0.05, device="cuda"),
           torch.tensor(0.01, device="cuda")]
    wds = [1e-5, 0.0, 1e-3]
    mine = []
    for i, shape in enumerate(shapes):
        def rand(positive=False):
            t = torch.randn(shape, generator=gen, device="cuda")
            return t.abs() if positive else t
        states = [rand().to(s_dtype)]
        if kind == "adam":
            states.append(rand(positive=True).to(s_dtype))
        mine.append((rand().to(p_dtype), rand(), *states, lrs[i % 2],
                     wds[i % 3]))
    plain = [tuple(t.clone() if isinstance(t, torch.Tensor) and t.dim()
                   else t for t in e) for e in mine]
    return mine, plain


def _run_multi(kind, entries, plain=False):
    suffix = "_reference" if plain else ""
    if kind == "adam":
        bc = (torch.tensor(1 - 0.9 ** 3, device="cuda"),
              torch.tensor(1 - 0.999 ** 3, device="cuda"))
        getattr(tfo, "adam_update_multi" + suffix)(entries, *bc,
                                                   **_MULTI_KW[kind])
    else:
        getattr(tfo, "sgd_momentum_update_multi" + suffix)(
            entries, **_MULTI_KW[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_MULTI_KW))
@pytest.mark.parametrize("shapes", sorted(_MULTI_SETS))
@pytest.mark.parametrize("p_dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_multi_kernel_matches_the_loop_of_plain_versions(kind, shapes,
                                                         p_dtype, s_dtype):
    """Bitwise against the plain version of each entry; each written
    tensor's version goes up; one launch per chunk and none per tensor."""
    _need_card()
    import math
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    mine, plain = _multi_entries(kind, _MULTI_SETS[shapes](), p_dtype,
                                 s_dtype, gen)
    written = [(e[0],) + e[2:-2] for e in mine]
    versions = [[t._version for t in w] for w in written]
    key = "adam_multi" if kind == "adam" else "sgd_multi"
    before = dict(tfo.launches)
    _run_multi(kind, mine)
    _run_multi(kind, plain, plain=True)
    torch.cuda.synchronize()
    chunks = math.ceil(len(mine) / tfo.MULTI_CAPACITY[key])
    assert {k: tfo.launches[k] - before[k] for k in before} == \
        {**{k: 0 for k in before}, key: chunks}
    for w, vs, want in zip(written, versions, plain):
        assert all(t._version > v for t, v in zip(w, vs))
        for got, ref in zip(w, (want[0],) + want[2:-2]):
            assert torch.equal(got, ref), \
                (got.float() - ref.float()).abs().max()


@pytest.mark.cuda
def test_a_cuda_multi_update_never_reaches_a_per_tensor_path(monkeypatch):
    _need_card()
    for name in ("sgd_momentum_update", "adam_update",
                 "sgd_momentum_update_reference", "adam_update_reference"):
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"a CUDA multi update reached {_name}")
        monkeypatch.setattr(tfo, name, refuse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for kind in sorted(_MULTI_KW):
        mine, _ = _multi_entries(kind, [(1000,), (7,)], torch.float32,
                                 torch.float32, gen)
        _run_multi(kind, mine)
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


# -- K3, K4 in bf16: the tensor-core kernels ----------------------------------

# per element, beside _near: |got - want| <= c (|want| + rms of the row of
# want, at least 1/64 of its (batch, head) slice's), as chip_smoke.py's
# FLASH_ELEM_TOL; _near scales by the largest value of the tensor, so
# alone it lets a row of small values go wrong
_ELEM_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.025}


def _near_each(got, want, dtype):
    got, want = got.float(), want.float()
    sq = want.pow(2)
    rms = torch.maximum(sq.mean(-1, keepdim=True),
                        sq.mean((-2, -1), keepdim=True) / 64 ** 2).sqrt()
    err = ((got - want).abs() / (want.abs() + rms).clamp_min(1e-30)).max()
    assert err.item() <= _ELEM_TOL[dtype], err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,D", [(128, 128, 64), (72, 72, 16),
                                     (100, 100, 100), (40, 130, 130),
                                     (130, 40, 32), (64, 64, 256)], ids=str)
def test_flash_kernels_match_plain_version_per_element(Sq, Sk, D, causal,
                                                       dtype):
    """K3's out and K4's (dq, dk, dv) against the plain versions, each
    value within _ELEM_TOL of its own size and its row's."""
    _need_card()
    q, k, v, g = _attn_inputs(2, 3, Sq, Sk, D, dtype)
    scale = D ** -0.5
    out, lse = tat.flash_fwd(q, k, v, causal, scale)
    grads = tat.flash_bwd(q, k, v, out, lse, g, causal, scale)
    ro, _ = tat._scan_flash_fwd(q, k, v, causal, scale)
    want = tat._scan_flash_bwd(q, k, v, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    for a, b in zip((out,) + tuple(grads), (ro,) + tuple(want)):
        _near_each(a, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [-40, 0, 24])
def test_flash_fwd_bf16_pos_delta_matches_plain_version(delta):
    """The bf16 forward (tensor cores) under a position delta: -40 masks
    the first 40 rows fully (out 0, lse -1e30 on both sides)."""
    _need_card()
    q, k, v, _ = _attn_inputs(1, 2, 96, 96, 32, torch.bfloat16, seed=1)
    out, lse = tat.flash_fwd(q, k, v, True, 0.2, pos_delta=delta)
    ro, rl = tat._scan_flash_fwd(q, k, v, True, 0.2, pos_delta=delta)
    torch.cuda.synchronize()
    _near(out, ro, torch.bfloat16)
    _near_each(out, ro, torch.bfloat16)
    _near(lse, rl, torch.float32)
    if delta < 0:
        assert torch.all(out[:, :, :-delta] == 0)
        assert torch.all(lse[:, :, :-delta] <= -1e29)


# -- K3, K4 in f32: the edges of the CUDA-core kernels ------------------------

def _flash_all(q, k, v, g, causal, scale):
    """(out, lse, dq, dk, dv) through the kernels, and through the plain
    versions on the same inputs."""
    out, lse = tat.flash_fwd(q, k, v, causal, scale)
    got = (out, lse) + tuple(tat.flash_bwd(q, k, v, out, lse, g, causal,
                                           scale))
    ro, rl = tat._scan_flash_fwd(q, k, v, causal, scale)
    want = (ro, rl) + tuple(tat._scan_flash_bwd(q, k, v, out, lse, g,
                                                causal, scale))
    torch.cuda.synchronize()
    return got, want


def _held(got, want):
    """Both gates on out, dq, dk, dv; the f32 gate on lse."""
    for i, (a, b) in enumerate(zip(got, want)):
        _near(a, b, torch.float32)
        if i != 1:
            _near_each(a, b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk,D", [(64, 64, 1), (72, 72, 3),
                                     (40, 40, 250), (200, 70, 64),
                                     (1000, 1000, 64)], ids=str)
def test_flash_f32_edges_match_plain_version(Sq, Sk, D, causal):
    """The f32 kernels where D % 4 != 0 (the 4-byte load path, D = 1 and
    3), where most head columns of the bucket are zero padding (D = 250),
    where Sq > Sk, and at a long ragged length (1000 = 15 x 64 + 40)."""
    _need_card()
    q, k, v, g = _attn_inputs(1, 2, Sq, Sk, D, torch.float32, seed=3)
    _held(*_flash_all(q, k, v, g, causal, D ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 100])
def test_flash_f32_misaligned_views_match_plain_version(D):
    """q, k, v and dO as views at a storage offset of one float: no row
    is 16-byte aligned, so the kernels take their 4-byte load path."""
    _need_card()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
        buf[1:].copy_(t.flatten())
        return buf[1:].view(t.shape)
    q, k, v, g = [shifted(t) for t in
                  _attn_inputs(2, 2, 96, 96, D, torch.float32, seed=4)]
    assert all(t.data_ptr() % 16 for t in (q, k, v, g))
    _held(*_flash_all(q, k, v, g, True, D ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_are_deterministic(dtype):
    """Two calls on the same inputs give bitwise-equal outputs: each
    output tile is written by one block, with no atomics."""
    _need_card()
    q, k, v, g = _attn_inputs(2, 4, 300, 300, 64, dtype, seed=5)
    first, _ = _flash_all(q, k, v, g, True, 0.125)
    second, _ = _flash_all(q, k, v, g, True, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


_KERNEL_NAMES = {
    torch.bfloat16: ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                     "flash_bwd_dkv_mma_kernel"),
    torch.float32: ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_kernel")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_wrapper_runs_the_kernel_of_its_dtype(dtype):
    """By the kernels' names in the profiler: a bf16 call of flash_fwd,
    flash_bwd_dq and flash_bwd_dkv runs the tensor-core kernel, an f32
    call the CUDA-core one, and nothing else of the other dtype."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    q, k, v, g = _attn_inputs(1, 2, 128, 128, 64, dtype)
    out, lse = tat.flash_fwd(q, k, v, True, 0.125)
    delta = (g.float() * out.float()).sum(-1)
    calls = (lambda: tat.flash_fwd(q, k, v, True, 0.125),
             lambda: tat.flash_bwd_dq(q, k, v, g, lse, delta, True, 0.125),
             lambda: tat.flash_bwd_dkv(q, k, v, g, lse, delta, True, 0.125))
    other = _KERNEL_NAMES[torch.float32 if dtype == torch.bfloat16
                          else torch.bfloat16]
    for fn, want in zip(calls, _KERNEL_NAMES[dtype]):
        torch.cuda.synchronize()
        for _ in range(3):  # a session may record no device event at all
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        ours = [n for n in names if "flash_" in n]
        assert len(ours) == 1 and want + "<" in ours[0], (want, names)
        assert not any(o + "<" in n for o in other for n in names), names


# -- K6 and K7 multi-tensor launches -----------------------------------------

_SCALED_KW = {"rmsprop": dict(rho=0.9, epsilon=1e-8),
              "adagrad": dict(epsilon=1e-8)}


def _scaled_entries(shapes, p_dtype, s_dtype, gen, misaligned=False):
    """Entries ``(p, g, state, lr, weight_decay)`` of a K6/K7 update with
    two lr tensors and three weight decays in turn, the state positive,
    and their clones. ``misaligned``: p, g and the state of every other
    entry are views one element into a larger buffer, so their pointers
    miss the 4-wide vector alignment and those entries take the scalar
    path inside the same launch."""
    lrs = [torch.tensor(0.05, device="cuda"),
           torch.tensor(0.01, device="cuda")]
    wds = [1e-5, 0.0, 1e-3]
    mine = []
    for i, shape in enumerate(shapes):
        shift = 1 if misaligned and i % 2 else 0

        def rand(dtype, positive=False):
            n = math.prod(shape)
            t = torch.randn(n + shift, generator=gen, device="cuda")
            t = (t.abs() if positive else t).to(dtype)
            return t[shift:].view(shape)
        mine.append((rand(p_dtype), rand(torch.float32),
                     rand(s_dtype, positive=True), lrs[i % 2], wds[i % 3]))
    plain = [tuple(t.clone() if isinstance(t, torch.Tensor) and t.dim()
                   else t for t in e) for e in mine]
    return mine, plain


def _check_scaled_multi(kind, mine, plain):
    """One multi update of ``kind`` against the loop of plain versions:
    bitwise, every written tensor's version up, one launch per chunk and
    none of another kernel."""
    written = [(e[0], e[2]) for e in mine]
    versions = [[t._version for t in w] for w in written]
    key = f"{kind}_multi"
    before = dict(tfo.launches)
    getattr(tfo, f"{kind}_update_multi")(mine, **_SCALED_KW[kind])
    getattr(tfo, f"{kind}_update_multi_reference")(plain,
                                                   **_SCALED_KW[kind])
    torch.cuda.synchronize()
    chunks = math.ceil(len(mine) / tfo.MULTI_CAPACITY[key])
    assert {k: tfo.launches[k] - before[k] for k in before} == \
        {**{k: 0 for k in before}, key: chunks}
    for w, vs, want in zip(written, versions, plain):
        assert all(t._version > v for t, v in zip(w, vs))
        for got, ref in zip(w, (want[0], want[2])):
            assert torch.equal(got, ref), \
                (got.float() - ref.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_SCALED_KW))
@pytest.mark.parametrize("shapes", sorted(_MULTI_SETS))
@pytest.mark.parametrize("p_dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_scaled_multi_kernel_matches_the_loop_of_plain_versions(
        kind, shapes, p_dtype, s_dtype):
    """K6 and K7 multi-tensor: bitwise against the plain version of each
    entry over the 161 ResNet-50 shapes and a chunk-crossing set; each
    written tensor's version goes up; one launch per chunk."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    _check_scaled_multi(kind, *_scaled_entries(
        _MULTI_SETS[shapes](), p_dtype, s_dtype, gen))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_SCALED_KW))
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_scaled_multi_kernel_on_misaligned_views(kind, p_dtype):
    """Every other entry a view one element into its buffer (the 4-wide
    path off for it, on for its neighbours, in one launch): still bitwise
    with the loop of plain versions."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    mine, plain = _scaled_entries(_MULTI_SETS["chunk_boundary"](), p_dtype,
                                  torch.float32, gen, misaligned=True)
    assert mine[1][2].data_ptr() % 16 and not mine[0][2].data_ptr() % 16
    _check_scaled_multi(kind, mine, plain)


@pytest.mark.cuda
def test_a_cuda_scaled_multi_update_never_reaches_a_per_tensor_path(
        monkeypatch):
    _need_card()
    for name in ("rmsprop_update", "adagrad_update",
                 "rmsprop_update_reference", "adagrad_update_reference"):
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"a CUDA multi update reached {_name}")
        monkeypatch.setattr(tfo, name, refuse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for kind in sorted(_SCALED_KW):
        mine, _ = _scaled_entries([(1000,), (7,)], torch.float32,
                                  torch.float32, gen)
        before = tfo.launches[f"{kind}_multi"]
        getattr(tfo, f"{kind}_update_multi")(mine, **_SCALED_KW[kind])
        assert tfo.launches[f"{kind}_multi"] == before + 1
    torch.cuda.synchronize()


# -- the skip flag of the multi-tensor launches (K1, K5, K6, K7) -------------

_FLAG_KINDS = ("sgd", "sgd_nesterov", "adam", "rmsprop", "adagrad")


def _flag_case(kind, shapes, p_dtype, s_dtype, gen):
    if kind in _SCALED_KW:
        return _scaled_entries(shapes, p_dtype, s_dtype, gen)
    return _multi_entries(kind, shapes, p_dtype, s_dtype, gen)


def _flag_update(kind, entries, plain=False, **ok):
    if kind in _SCALED_KW:
        getattr(tfo, f"{kind}_update_multi"
                + ("_reference" if plain else ""))(
            entries, **_SCALED_KW[kind], **ok)
    elif kind == "adam":
        bc = (torch.tensor(1 - 0.9 ** 3, device="cuda"),
              torch.tensor(1 - 0.999 ** 3, device="cuda"))
        getattr(tfo, "adam_update_multi" + ("_reference" if plain else ""))(
            entries, *bc, **_MULTI_KW[kind], **ok)
    else:
        getattr(tfo, "sgd_momentum_update_multi"
                + ("_reference" if plain else ""))(
            entries, **_MULTI_KW[kind], **ok)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _FLAG_KINDS)
@pytest.mark.parametrize("shapes", sorted(_MULTI_SETS))
@pytest.mark.parametrize("p_dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_multi_kernel_skip_flag(kind, shapes, p_dtype, s_dtype):
    """ok = 1: bitwise with the launch without a flag and with the plain
    version given the flag; ok = 0: every parameter and state byte for
    byte as before. Every launch counts, skipped or not, and bumps the
    versions of what it may have written."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    base, _ = _flag_case(kind, _MULTI_SETS[shapes](), p_dtype, s_dtype,
                         gen)
    n = 2 if kind == "adam" else 1

    def clone():
        return [tuple(t.clone() if isinstance(t, torch.Tensor) and t.dim()
                      else t for t in e) for e in base]
    bare, one, zero, plain = clone(), clone(), clone(), clone()
    ok1 = torch.ones((), device="cuda")
    ok0 = torch.zeros((), device="cuda")
    versions = [t._version for e in zero for t in (e[0], *e[2:2 + n])]
    key = "adam_multi" if kind == "adam" else \
        f"{kind}_multi" if kind in _SCALED_KW else "sgd_multi"
    before = dict(tfo.launches)
    _flag_update(kind, bare)
    _flag_update(kind, one, ok=ok1)
    _flag_update(kind, zero, ok=ok0)
    _flag_update(kind, plain, plain=True, ok=ok1)
    torch.cuda.synchronize()
    chunks = math.ceil(len(base) / tfo.MULTI_CAPACITY[key])
    assert {k: tfo.launches[k] - before[k] for k in before} == \
        {**{k: 0 for k in before}, key: 3 * chunks}
    for e1, e2, e3, e4, e0 in zip(bare, one, zero, plain, base):
        for i in (0, *range(2, 2 + n)):
            assert torch.equal(e1[i], e2[i]) and torch.equal(e2[i], e4[i])
            assert torch.equal(e3[i], e0[i])
    assert all(t._version > v for t, v in zip(
        [t for e in zero for t in (e[0], *e[2:2 + n])], versions))


@pytest.mark.cuda
def test_a_guarded_step_on_the_card_skips_a_poisoned_batch():
    """A small conv net under ``bf16_mixed`` on the card: a poisoned batch
    leaves every parameter, momentum, the step counter and the BN
    statistics bitwise as they were, through K1's multi-tensor launch with
    the flag (one launch per step, none per tensor), and halves the loss
    scale."""
    _need_card()
    import numpy as np
    from singa_tpu_torch import device, layer, model, opt, tensor

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(8, 3, padding=1)
            self.bn = layer.BatchNorm2d()
            self.relu = layer.ReLU()
            self.flat = layer.Flatten()
            self.fc = layer.Linear(4)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss

    dev = device.create_cuda_gpu(0)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3, 6, 6).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)]
    m = Net()
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9, fused=True))
    m.compile([tensor.Tensor(data=x, device=dev)], is_train=True,
              policy="bf16_mixed")

    def states():
        d = {k: t.data.clone() for k, t in m.get_states().items()}
        d.update({k: t.data.clone() for k, t in
                  m.optimizer.state_tensor_dict().items()})
        return d
    for _ in range(2):
        m(tensor.Tensor(data=x, device=dev), tensor.Tensor(data=y,
                                                           device=dev))
    before = states()
    bad = x.copy()
    bad.flat[0] = np.nan
    tfo.reset_counts()
    m(tensor.Tensor(data=bad, device=dev), tensor.Tensor(data=y, device=dev))
    assert tfo.launches == {**{k: 0 for k in tfo.launches}, "sgd_multi": 1}
    after = states()
    moved = [k for k in before if not k.startswith(("loss_scale", "guard/"))
             and not torch.equal(before[k], after[k])]
    assert not moved, moved
    stats = m.optimizer.stats()
    assert stats["skipped_total"] == 1 and stats["loss_scale"] == 0.5
