"""Kernel K2 of the port (``singa_tpu_torch/ops/fused_epilogue.py``) held
against the JAX package's Pallas kernel run in interpret mode.

On the CPU the port's wrappers run the kernel's plain PyTorch version, so
these tests pin that version (which ``chip_smoke.py`` then holds the CUDA
kernel against, bitwise in f32, on the card) to the JAX kernel on the same
numpy inputs. Tolerance: atol 1e-6 in f32; one bf16 ulp (relative 2^-7)
in bf16, where the two frameworks round at different places.

Also here: ``fold_bn`` parity, the peephole's decline rules, and the
wrapper's argument checks. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from singa_tpu.ops import fused_epilogue as jfe
from singa_tpu.ops import fused_optim

from singa_tpu_torch import autograd, layer
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.tensor import Tensor

# the shapes of tests/test_fused_kernels.py's epilogue cases
PLAIN = [("NCHW", (2, 5, 7, 7)), ("NHWC", (2, 7, 7, 5)),
         ("NCHW", (1, 3, 16, 16))]
RESIDUAL = [("NCHW", (2, 5, 7, 7)), ("NHWC", (2, 7, 7, 5))]
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _interpret_kernels():
    prev = fused_optim.FORCE_PALLAS_INTERPRET
    fused_optim.FORCE_PALLAS_INTERPRET = True
    try:
        yield
    finally:
        fused_optim.FORCE_PALLAS_INTERPRET = prev


@pytest.fixture(autouse=True)
def _port_inference_mode():
    prev = CTX.training
    CTX.training = False
    yield
    CTX.training = prev


def _case(layout, shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    c = shape[1] if layout == "NCHW" else shape[-1]
    sc = (rng.rand(c) + 0.5).astype(np.float32)
    sh = rng.randn(c).astype(np.float32)
    return x, r, sc, sh


def _run_both(layout, x, r, sc, sh, dtype, residual):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    tsc, tsh = torch.from_numpy(sc), torch.from_numpy(sh)
    if residual:
        want = jfe.scale_shift_add_relu(jx, sc, sh, jnp.asarray(r, jdt),
                                        layout=layout)
        got = tfe.scale_shift_add_relu(tx, tsc, tsh,
                                       torch.from_numpy(r).to(tdt),
                                       layout=layout)
    else:
        want = jfe.scale_shift_relu(jx, sc, sh, layout=layout)
        got = tfe.scale_shift_relu(tx, tsc, tsh, layout=layout)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("layout,shape", PLAIN)
def test_scale_shift_relu_matches_jax_kernel(layout, shape):
    want, got = _run_both(layout, *_case(layout, shape, 0), "f32", False)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout,shape", RESIDUAL)
def test_scale_shift_add_relu_matches_jax_kernel(layout, shape):
    want, got = _run_both(layout, *_case(layout, shape, 2), "f32", True)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("layout,shape", RESIDUAL)
def test_bf16_within_one_ulp_of_jax_kernel(layout, shape, residual):
    want, got = _run_both(layout, *_case(layout, shape, 5), "bf16",
                          residual)
    assert np.all(np.abs(got - want) <= np.abs(want) * BF16_ULP)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(9)
    c = 64
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    rmean = rng.randn(c).astype(np.float32)
    rvar = (rng.rand(c) + 0.1).astype(np.float32)
    js, jb = jfe.fold_bn(scale, bias, rmean, rvar, 1e-5)
    ts, tb = tfe.fold_bn(*(torch.from_numpy(a) for a in
                           (scale, bias, rmean, rvar)), 1e-5)
    assert ts.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


# -- the peephole ------------------------------------------------------------

def _tagged_bn_output(seed=0):
    """A lazy, tagged inference-BN output over a (2, 4, 8, 8) input with
    non-trivial running statistics."""
    dev = tdevice.create_cpu_device()
    rng = np.random.RandomState(seed)
    x = Tensor(data=rng.randn(2, 4, 8, 8).astype(np.float32), device=dev)
    bn = layer.BatchNorm2d()
    bn.ensure_initialized(x)
    bn.running_mean.copy_from_numpy(rng.randn(4).astype(np.float32))
    bn.running_var.copy_from_numpy((rng.rand(4) + 0.5).astype(np.float32))
    return bn(x), dev


def _plain_relu(t):
    return torch.relu(t.data).numpy()


def test_fused_relu_matches_plain_bn_relu():
    y, _ = _tagged_bn_output()
    want = _plain_relu(y)
    y2, _ = _tagged_bn_output()
    with tfe.enabled_scope(True):
        tfe.reset_counts()
        got = autograd.relu(y2)
    assert tfe.fused_tails == 1
    np.testing.assert_allclose(got.data.numpy(), want, atol=1e-6)


def test_fold_is_kept_until_the_bn_states_change():
    """The folded (s, b) of a BN layer is reused from one forward to the
    next, and refolded once a state tensor is rewritten in place (as
    ``load_states`` does)."""
    dev = tdevice.create_cpu_device()
    rng = np.random.RandomState(4)
    x = Tensor(data=rng.randn(2, 4, 8, 8).astype(np.float32), device=dev)
    bn = layer.BatchNorm2d()
    bn.ensure_initialized(x)
    with tfe.enabled_scope(True):
        autograd.relu(bn(x))
        first = bn.running_var._fold_cache[2]
        autograd.relu(bn(x))
        assert bn.running_var._fold_cache[2] is first
        bn.running_var.copy_from_numpy(
            (rng.rand(4) + 0.5).astype(np.float32))
        bn.bias.copy_from_numpy(rng.randn(4).astype(np.float32))
        got = autograd.relu(bn(x)).data.numpy()
    assert bn.running_var._fold_cache[2] is not first
    np.testing.assert_allclose(got, _plain_relu(bn(x)), atol=1e-6)


def test_declines_when_disabled():
    y, _ = _tagged_bn_output()
    assert not tfe.enabled()
    assert tfe.try_relu_epilogue(y) is None
    np.testing.assert_array_equal(autograd.relu(y).data.numpy(),
                                  _plain_relu(y))


def test_declines_in_training():
    """A frozen-stats BN still backprops through scale/bias while
    training, so the peephole declines there."""
    y, _ = _tagged_bn_output()
    CTX.training = True
    with tfe.enabled_scope(True):
        assert tfe.try_relu_epilogue(y) is None


def test_declines_broadcasting_residual():
    y, dev = _tagged_bn_output()
    r = Tensor(data=np.ones((1, 4, 1, 1), np.float32), device=dev)
    s = autograd.add(y, r)
    assert getattr(s, "_bn_add_epilogue", None) is not None
    with tfe.enabled_scope(True):
        assert tfe.try_relu_epilogue(s) is None
        out = autograd.relu(s)
    np.testing.assert_allclose(out.data.numpy(),
                               np.maximum(y.data.numpy() + 1.0, 0),
                               atol=1e-6)


def test_residual_tail_fuses_without_running_bn_or_add():
    from singa_tpu_torch.ops import batchnorm as tbn
    y, dev = _tagged_bn_output()
    rng = np.random.RandomState(3)
    r = Tensor(data=rng.randn(2, 4, 8, 8).astype(np.float32), device=dev)
    s = autograd.add(y, r)
    runs0, adds0 = tbn.normalise_runs, autograd.add_runs
    with tfe.enabled_scope(True):
        got = autograd.relu(s)
    assert (tbn.normalise_runs, autograd.add_runs) == (runs0, adds0)
    want = np.maximum(y.data.numpy() + r.data.numpy(), 0)
    np.testing.assert_allclose(got.data.numpy(), want, atol=1e-5)


# -- the wrapper -------------------------------------------------------------

def _args(layout="NCHW", shape=(2, 4, 3, 3)):
    c = shape[1] if layout == "NCHW" else shape[-1]
    return torch.randn(shape), torch.ones(c), torch.zeros(c)


def test_checks_contiguity_in_the_kernel_layout():
    x, s, b = _args()
    with pytest.raises(ValueError, match="contiguous"):
        tfe._check(x.to(memory_format=torch.channels_last), s, b, "NCHW",
                   None)
    nhwc = x.permute(0, 2, 3, 1)        # a view, not channel-minor memory
    with pytest.raises(ValueError, match="contiguous"):
        tfe._check(nhwc, torch.ones(4), torch.zeros(4), "NHWC", None)
    assert tfe._check(nhwc.contiguous(), torch.ones(4), torch.zeros(4),
                      "NHWC", None) == 4


@pytest.mark.parametrize("bad", ["dtype", "scale", "residual", "ndim"])
def test_checks_refuse_what_the_kernel_does_not_take(bad):
    x, s, b = _args()
    r = None
    if bad == "dtype":
        x = x.double()
    elif bad == "scale":
        s = torch.ones(5)
    elif bad == "residual":
        r = torch.randn(1, 4, 1, 1)
    else:
        x = x[0]
    with pytest.raises((ValueError, TypeError)):
        tfe._check(x, s, b, "NCHW", r)


def test_no_fallback_off_the_cpu():
    """Only a CPU tensor may take the plain version; any other device
    goes to the kernel or raises."""
    x = torch.empty((1, 2, 2, 2), device="meta")
    with pytest.raises(RuntimeError, match="no epilogue kernel"):
        tfe.scale_shift_relu(x, torch.ones(2, device="meta"),
                             torch.zeros(2, device="meta"))
