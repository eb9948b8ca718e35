"""The port's ``space_to_depth`` stem (``singa_tpu_torch/ops/conv.py``),
held against its own plain 7x7/s2 conv and against the JAX package's
stem (``singa_tpu/ops/conv.py:113-168``; the port of
``tests/test_layout.py:207-300``).

The stem conv is the same function of the same OIHW weights as the plain
stride-2 conv, computed as one stride-1 conv of the space-to-depth'd input
with a re-indexed kernel. Only the summation order differs, so outputs and
gradients (of ``x`` and of ``W``) are held within 1e-4 (rtol and atol) in
NCHW and NHWC, against the port's plain conv and against the JAX
package's s2d conv. A small s2d ResNet (BasicBlock [1, 1, 1, 1], 224
px, b2) trains 3 steps of ``SGD(lr=0.1, momentum=0.9, fused=True)`` in step
with the JAX one from the same numpy-seeded start: losses within rtol
1e-3 / atol 1e-4, states within 5e-3 of their norm, momenta within 5e-2,
the bounds and the reason of ``test_torch_resnet_training.py`` (the JAX
side runs its plain optimizer chain: its interpret-mode kernel takes
about 10 s per step on one core over this model's 4.9M parameters).
Against the port's own conv7 ResNet the s2d one's losses agree within
rtol 1e-4 / atol 1e-5, as the JAX package holds its two stems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu.ops import conv as jconv
from singa_tpu.ops import fused_optim as jfo

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import resnet as tresnet
from singa_tpu_torch.ops import conv as tconv

TOL = 1e-4
STEPS = 3
SGD_KW = dict(lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True)
RTOL, ATOL = 1e-3, 1e-4
STATE_TOL, MOMENTUM_TOL = 5e-3, 5e-2


@pytest.fixture(autouse=True)
def _port_eval_after():
    yield
    TCTX.training = False


def _port_conv(x, W, handle, w_out):
    """Output, d(sum(out * w_out))/dx and /dW of the port's conv."""
    dev = tdevice.create_cpu_device()
    xa = torch.from_numpy(x).requires_grad_(True)
    Wa = torch.from_numpy(W).requires_grad_(True)
    out = tconv.conv2d(handle, ttensor.Tensor(data=xa, device=dev),
                       ttensor.Tensor(data=Wa, device=dev)).data
    gx, gW = torch.autograd.grad((out * torch.from_numpy(w_out)).sum(),
                                 [xa, Wa])
    return out.detach().numpy(), gx.numpy(), gW.numpy()


def _jax_conv(x, W, handle, w_out):
    op = jconv._Conv2d(handle)

    def f(xx, ww):
        return jnp.sum(op.forward(xx, ww) * w_out)
    out = np.asarray(op.forward(jnp.asarray(x), jnp.asarray(W)))
    gx, gW = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(W))
    return out, np.asarray(gx), np.asarray(gW)


CASES = {   # (N, C, H, O, K): the ResNet stem, a 3x3 and a 5x5 one
    "7x7": (2, 3, 16, 8, 7),
    "3x3": (1, 2, 8, 3, 3),
    "5x5": (2, 3, 12, 4, 5),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stem_conv_equals_conv7_and_jax_with_gradients(case, layout):
    n, c, h, o, k = CASES[case]
    rng = np.random.RandomState(0)
    x = rng.randn(n, c, h, h).astype(np.float32)
    W = rng.randn(o, c, k, k).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    pad = (k - 1) // 2
    plain = tconv.ConvHandle(x, k, 2, pad, c, o, layout=layout)
    s2d = tconv.ConvHandle(x, k, 2, pad, c, o, layout=layout,
                           space_to_depth=True)
    ref_out = _port_conv(x, W, plain, np.ones((1,), np.float32))[0]
    w_out = rng.randn(*ref_out.shape).astype(np.float32)
    want = _port_conv(x, W, plain, w_out)
    got = _port_conv(x, W, s2d, w_out)
    jh = jconv.ConvHandle(x, k, 2, pad, c, o, layout=layout,
                          space_to_depth=True)
    jax_s2d = _jax_conv(x, W, jh, w_out)
    for what, g, w, j in zip(("output", "dx", "dW"), got, want, jax_s2d):
        assert g.shape == w.shape == j.shape, what
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} vs conv7")
        np.testing.assert_allclose(g, j, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} vs the JAX s2d conv")
    # the gather table lives on the handle, on the device it ran on
    assert list(s2d._s2d_index) == [torch.device("cpu")]


def test_stem_conv_with_bias():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    W = rng.randn(4, 3, 7, 7).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    dev = tdevice.create_cpu_device()
    outs = [tconv.conv2d(tconv.ConvHandle(x, 7, 2, 3, 3, 4,
                                          space_to_depth=s2d),
                         ttensor.Tensor(data=x, device=dev),
                         ttensor.Tensor(data=W, device=dev),
                         ttensor.Tensor(data=b, device=dev)).to_numpy()
            for s2d in (False, True)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pkg", [tconv, jconv], ids=["port", "jax"])
def test_invalid_geometry_rejected(pkg):
    """The same ``ValueError`` naming ``space_to_depth`` in both
    packages."""
    x = np.zeros((1, 3, 16, 16), np.float32)
    msgs = []
    for args, xx in (((7, 1, 3, 3, 8), x),                # stride 1
                     ((4, 2, 1, 3, 8), x),                # even K
                     ((7, 2, 2, 3, 8), x),                # pad != (K-1)/2
                     ((7, 2, 3, 3, 8),
                      np.zeros((1, 3, 15, 16), np.float32))):   # odd H
        with pytest.raises(ValueError, match="space_to_depth") as e:
            pkg.ConvHandle(xx, *args, space_to_depth=True)
        msgs.append(str(e.value))
    with pytest.raises(ValueError, match="space_to_depth"):
        pkg.ConvHandle(x, 7, 2, 3, 3, 8, group=3, space_to_depth=True)
    assert len(set(msgs)) == 1


def _seeded(names_shapes, seed=11):
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in names_shapes:
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 \
                else shape[0]
            v = rng.randn(*shape) * np.sqrt(1.0 / fan_in)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = rng.randn(*shape) * 0.2
        out[k] = v.astype(np.float32)
    return out


def _close(got, want, tol, what):
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    assert err <= tol * float(np.linalg.norm(want)) + 1e-7, \
        f"{what}: |got - want| = {err:.3g}, |want| = " \
        f"{float(np.linalg.norm(want)):.3g}"


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 224, 224).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)]
    return x, y


def _port_resnet_run(layout, stem, init, steps=STEPS):
    x, y = _batch()
    dev = tdevice.create_cpu_device()
    m = tresnet.ResNet(tresnet.BasicBlock, [1, 1, 1, 1], layout=layout,
                       stem=stem)
    m.set_optimizer(topt.SGD(**SGD_KW))
    tx = ttensor.Tensor(data=x, device=dev)
    ty = ttensor.Tensor(data=y, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    if init is None:
        init = _seeded(sorted((k, tuple(v.shape))
                              for k, v in m.get_states().items()))
    load_numpy_states(m, init)
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(steps)]
    return m, losses, init


def test_s2d_resnet_trains_in_step_with_jax(monkeypatch):
    layout = "NCHW"
    x, y = _batch()
    # the JAX weights come from the numpy seed: skip its own draws
    monkeypatch.setattr(jtensor.Tensor, "gaussian",
                        lambda self, mean=0.0, std=1.0: self)
    prev = jfo.FORCE_PALLAS_INTERPRET
    jfo.FORCE_PALLAS_INTERPRET = False
    try:
        jdev = jdevice.create_cpu_device()
        jm = jresnet.ResNet(jresnet.BasicBlock, [1, 1, 1, 1], layout=layout,
                            stem="space_to_depth")
        jm.set_optimizer(jopt.SGD(**SGD_KW))
        jx = jtensor.Tensor(data=x, device=jdev, requires_grad=False)
        jy = jtensor.Tensor(data=y, device=jdev, requires_grad=False)
        jm.compile([jx], is_train=True, use_graph=True)
        live = jm.get_states()
        init = _seeded(sorted((k, tuple(v.shape)) for k, v in live.items()))
        for k, v in init.items():
            live[k].copy_from_numpy(v)
        want = [float(np.asarray(jm(jx, jy)[1].data))
                for _ in range(STEPS)]
        jstates = {k: np.asarray(v.data) for k, v in
                   jm.get_states().items()}
        jopt_states = {k: np.asarray(v) for k, v in
                       jm.optimizer.get_states().items()}
    finally:
        jfo.FORCE_PALLAS_INTERPRET = prev
    m, losses, _ = _port_resnet_run(layout, "space_to_depth", init)
    assert m.conv1.handle.space_to_depth
    assert tuple(m.conv1.W.shape) == (64, 3, 7, 7)      # OIHW, as conv7
    np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
    mine = {k: v.to_numpy() for k, v in m.get_states().items()}
    assert sorted(mine) == sorted(jstates)
    for k, w in jstates.items():
        _close(mine[k], w, STATE_TOL, k)
    ostates = m.optimizer.get_states()
    assert sorted(ostates) == sorted(jopt_states)
    for k, w in jopt_states.items():
        _close(np.asarray(ostates[k]), w, MOMENTUM_TOL, k)
    _, conv7, _ = _port_resnet_run(layout, "conv7", init)
    np.testing.assert_allclose(losses, conv7, rtol=1e-4, atol=1e-5)
