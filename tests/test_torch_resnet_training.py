"""The port's training slice as a whole, held against the JAX package.

A ResNet(Bottleneck, [1, 1, 1, 1]) built in ``singa_tpu`` and one built in
``singa_tpu_torch`` get the same weights and BN running statistics (made
with numpy from a seed), carried across by ``load_numpy_states``, and the
same fixed batch of 2 images at 224 px with one-hot labels. Each package
runs 3 steps of ``SGD(lr=0.1, momentum=0.9, weight_decay=1e-5,
fused=True)``: the JAX package compiled (``use_graph=True``) with its
Pallas kernel in interpret mode, the port eagerly on the CPU, where the
kernel's plain version stands in. Both run f32 end to end.

Tolerance: the per-step losses within rtol 1e-3 / atol 1e-4; each
parameter and running statistic after the steps within 5e-3 of its norm,
each momentum within 5e-2 of its norm (``|got - want| <= tol * |want|``,
Frobenius norms). The two packages sum the convolutions in different
orders (XLA's CPU convolution against oneDNN's), and this problem
amplifies last-bit differences: a batch of 2 through 17 batch-statistic
BNs, three steps at lr 0.1. Measured: the port against the JAX package
reaches 6e-4 (states) and 9e-3 (momenta); the port against itself with
only oneDNN's convolution switched off reaches the same, so the bounds are
about 5x what rounding alone gives. The pieces are held tighter on their
own: the update arithmetic against the JAX kernel in
``test_torch_fused_optim.py``, the BN variance and the max-pool gradient
below.
"""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu.ops import fused_optim as jfo

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import resnet as tresnet
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import fused_optim as tfo

BATCH = 2
SHAPE = (3, 224, 224)
STEPS = 3
SGD_KW = dict(lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True)
RTOL, ATOL = 1e-3, 1e-4          # losses
STATE_TOL, MOMENTUM_TOL = 5e-3, 5e-2

_JAX = {}


def _states_from_seed(names_shapes, seed=11):
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


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, *SHAPE).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, BATCH)]
    return x, y


def _close(got, want, tol, what):
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    assert err <= tol * float(np.linalg.norm(want)) + 1e-7, \
        f"{what}: |got - want| = {err:.3g}, |want| = " \
        f"{float(np.linalg.norm(want)):.3g}"


def _jax_model(layout, x):
    dev = jdevice.create_cpu_device()
    m = jresnet.ResNet(jresnet.Bottleneck, [1, 1, 1, 1], layout=layout)
    m.set_optimizer(jopt.SGD(**SGD_KW))
    tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
    m.compile([tx], is_train=True, use_graph=True)
    return m, dev


def _jax_run(layout, tmp_path_factory):
    """Losses of steps 1..4, states and optimizer states after step 3, and
    a save_states zip of step 3; built once per layout."""
    if layout in _JAX:
        return _JAX[layout]
    x, y = _batch()
    prev = jfo.FORCE_PALLAS_INTERPRET
    jfo.FORCE_PALLAS_INTERPRET = True
    try:
        m, dev = _jax_model(layout, x)
        live = m.get_states()
        init = _states_from_seed(sorted((k, tuple(v.shape))
                                        for k, v in live.items()))
        for k, v in init.items():
            live[k].copy_from_numpy(v)
        tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
        ty = jtensor.Tensor(data=y, device=dev, requires_grad=False)
        losses = []
        for _ in range(STEPS):
            losses.append(float(np.asarray(m(tx, ty)[1].data)))
        states = {k: np.asarray(v.data) for k, v in m.get_states().items()}
        ostates = {k: np.asarray(v) for k, v in
                   m.optimizer.get_states().items()}
        zpath = tmp_path_factory.mktemp("jax-train") / f"{layout}.zip"
        m.save_states(str(zpath))
        losses.append(float(np.asarray(m(tx, ty)[1].data)))
    finally:
        jfo.FORCE_PALLAS_INTERPRET = prev
    _JAX[layout] = dict(model=m, dev=dev, init=init, losses=losses,
                        states=states, ostates=ostates, zip=zpath)
    return _JAX[layout]


def _port_model(layout, x, optimizer=None):
    dev = tdevice.create_cpu_device()
    m = tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1], layout=layout)
    m.set_optimizer(optimizer or topt.SGD(**SGD_KW))
    m.compile([ttensor.Tensor(data=x, device=dev)], is_train=True,
              use_graph=True)
    return m, dev


def _port_steps(m, dev, n):
    x, y = _batch()
    tx = ttensor.Tensor(data=x, device=dev)
    ty = ttensor.Tensor(data=y, device=dev)
    return [float(m(tx, ty)[1].data.detach()) for _ in range(n)]


@pytest.fixture(autouse=True)
def _port_eval_after():
    yield
    TCTX.training = False


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_three_sgd_steps_match_jax(layout, tmp_path_factory):
    ref = _jax_run(layout, tmp_path_factory)
    x, _ = _batch()
    m, dev = _port_model(layout, x)
    load_numpy_states(m, ref["init"])
    tfo.reset_counts()
    losses = _port_steps(m, dev, STEPS)
    # on the CPU the plain version stands in: no kernel launched
    assert sum(tfo.launches.values()) == 0
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref["losses"][:STEPS], rtol=RTOL,
                               atol=ATOL)
    mine = {k: v.to_numpy() for k, v in m.get_states().items()}
    assert sorted(mine) == sorted(ref["states"])
    for k, want in ref["states"].items():
        _close(mine[k], want, STATE_TOL, k)
    ostates = m.optimizer.get_states()
    assert sorted(ostates) == sorted(ref["ostates"])
    assert float(ostates["step_counter"]) == STEPS
    for k, want in ref["ostates"].items():
        _close(np.asarray(ostates[k]), want, MOMENTUM_TOL, k)


def test_jax_checkpoint_resumes_in_the_port(tmp_path_factory):
    """A JAX-written zip (optimizer entries included) resumes in the port
    with the same next-step loss."""
    ref = _jax_run("NCHW", tmp_path_factory)
    x, _ = _batch()
    m, dev = _port_model("NCHW", x)
    m.load_states(str(ref["zip"]))
    assert float(m.optimizer.get_states()["step_counter"]) == STEPS
    (loss,) = _port_steps(m, dev, 1)
    np.testing.assert_allclose(loss, ref["losses"][STEPS], rtol=RTOL,
                               atol=ATOL)


def test_port_checkpoint_resumes_in_jax(tmp_path_factory, tmp_path):
    """A port-written zip resumes in the JAX package with the same
    next-step loss as the port's own next step."""
    ref = _jax_run("NCHW", tmp_path_factory)
    x, y = _batch()
    m, dev = _port_model("NCHW", x)
    load_numpy_states(m, ref["init"])
    _port_steps(m, dev, STEPS)
    path = tmp_path / "port.zip"
    m.save_states(str(path))
    (want,) = _port_steps(m, dev, 1)

    jm, jdev = ref["model"], ref["dev"]
    prev = jfo.FORCE_PALLAS_INTERPRET
    jfo.FORCE_PALLAS_INTERPRET = True
    try:
        jm.load_states(str(path))
        assert float(np.asarray(jm.optimizer.step_counter.data)) == STEPS
        jm.train()
        _, loss = jm(jtensor.Tensor(data=x, device=jdev,
                                    requires_grad=False),
                     jtensor.Tensor(data=y, device=jdev,
                                    requires_grad=False))
    finally:
        jfo.FORCE_PALLAS_INTERPRET = prev
    np.testing.assert_allclose(float(np.asarray(loss.data)), want,
                               rtol=RTOL, atol=ATOL)


def test_fused_and_plain_sgd_train_alike():
    """``fused=True`` (the kernel's plain version on the CPU) and the
    optimizer's own plain chain give the same states, bitwise."""
    x, _ = _batch()
    runs = []
    for fused in (True, False):
        kw = dict(SGD_KW, fused=fused)
        m, dev = _port_model("NCHW", x, topt.SGD(**kw))
        load_numpy_states(m, _states_from_seed(sorted(
            (k, tuple(v.shape)) for k, v in m.get_states().items())))
        _port_steps(m, dev, 2)
        runs.append({**{k: v.to_numpy() for k, v in m.get_states().items()},
                     **m.optimizer.get_states()})
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)


def test_fused_step_invalidates_the_serving_bn_fold():
    """Serve (the BN folds are cached), train one fused step, serve again:
    the logits follow the trained BN scale and bias, as the unfused
    path's do."""
    x, y = _batch()
    m, dev = _port_model("NCHW", x)
    load_numpy_states(m, _states_from_seed(sorted(
        (k, tuple(v.shape)) for k, v in m.get_states().items())))

    def serve(fused):
        m.eval()
        with tfe.enabled_scope(fused):
            out = m(ttensor.Tensor(data=x, device=dev)).to_numpy()
        m.train()
        return out

    before = serve(True)
    _port_steps(m, dev, 1)
    after, plain = serve(True), serve(False)
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_allclose(after, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_training_bn_uses_biased_variance(layout):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 5, 6, 7).astype(np.float32) * 2 + 1
    if layout == "NHWC":
        x_in = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    else:
        x_in = x
    from singa_tpu_torch.ops.layout import use_layout
    dev = tdevice.create_cpu_device()
    bn = tlayer.BatchNorm2d()
    with use_layout(layout):
        bn(ttensor.Tensor(data=x_in, device=dev))    # initialise (eval)
        TCTX.training = True
        out = bn(ttensor.Tensor(data=x_in, device=dev)).to_numpy()
    mean = x.mean(axis=(0, 2, 3))
    var = ((x - mean[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.running_mean.to_numpy(), 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.to_numpy(), 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
    norm = (x - mean[None, :, None, None]) / np.sqrt(
        var[None, :, None, None] + 1e-5)
    if layout == "NHWC":
        norm = norm.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, norm, rtol=1e-4, atol=1e-5)
    assert not hasattr(out, "_bn_epilogue")


def test_max_pool_gradient_goes_to_the_same_tied_element_as_jax():
    """After the stem ReLU a 3x3/s2 max-pool window holds many tied
    zeros: the gradient must reach the same element in both packages."""
    import jax
    from singa_tpu.ops import pooling as jpool
    from singa_tpu_torch.ops import pooling as tpool
    rng = np.random.RandomState(1)
    x = np.maximum(rng.randn(2, 3, 12, 12), 0).astype(np.float32)
    x[0, 0, :4, :4] = 0.0          # whole windows of ties
    x[1, 2, 5:8, 5:8] = 0.7        # a window of equal positive values
    w = rng.randn(2, 3, 6, 6).astype(np.float32)
    jh = jpool.PoolingHandle(x, 3, 2, 1, True)
    _, vjp = jax.vjp(jpool._Pooling2d(jh).forward, x)
    (want,) = vjp(w)
    xt = torch.tensor(x, requires_grad=True)
    th = tpool.PoolingHandle(x, 3, 2, 1, True)
    y = tpool.pooling_2d(th, ttensor.Tensor(
        data=xt, device=tdevice.create_cpu_device())).data
    (got,) = torch.autograd.grad(y, xt, torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_training_and_dist_options_name_the_roadmap():
    """``bf16_mixed`` training is ported: compiling under it wraps the
    optimizer in the port's ``GuardedOptimizer`` (dynamic loss scaling
    from 1.0), and an f32 re-compile takes the wrap off. The DistOpt
    options still name ROADMAP slice B."""
    from singa_tpu_torch.resilience import GuardedOptimizer
    x, y = _batch()
    dev = tdevice.create_cpu_device()
    m = tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1])
    sgd = topt.SGD(**SGD_KW)
    m.set_optimizer(sgd)
    m.compile([ttensor.Tensor(data=x, device=dev)], is_train=True,
              policy="bf16_mixed")
    assert isinstance(m.optimizer, GuardedOptimizer)
    assert m.optimizer.inner is sgd and m.optimizer.dynamic_loss_scale
    assert m.optimizer.stats()["loss_scale"] == 1.0
    m.compile([ttensor.Tensor(data=x, device=dev)], is_train=True)
    assert m.optimizer is sgd
    with pytest.raises(NotImplementedError, match="slice B"):
        m(ttensor.Tensor(data=x, device=dev),
          ttensor.Tensor(data=y, device=dev), "half")
    with pytest.raises(NotImplementedError, match="slice B"):
        topt.DistOpt(topt.SGD())


@pytest.mark.parametrize("targets", ["one_hot", "ids"])
def test_losses_and_their_gradients_match_jax(targets):
    """softmax_cross_entropy (one-hot rows or class ids) and
    cross_entropy (probabilities) against the JAX ops, values and input
    gradients, f32 (rtol 1e-6)."""
    import jax
    from singa_tpu import autograd as jag
    from singa_tpu_torch import autograd as tag
    rng = np.random.RandomState(8)
    x = rng.randn(5, 10).astype(np.float32)
    ids = rng.randint(0, 10, 5)
    t = np.eye(10, dtype=np.float32)[ids] if targets == "one_hot" \
        else ids.astype(np.int32)
    want, jgrad = jax.value_and_grad(
        lambda a: jag.SoftMaxCrossEntropy().forward(a, t))(x)
    xt = torch.tensor(x, requires_grad=True)
    dev = tdevice.create_cpu_device()
    got = tag.softmax_cross_entropy(ttensor.Tensor(data=xt, device=dev),
                                    ttensor.Tensor(data=t, device=dev)).data
    (grad,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    onehot = np.eye(10, dtype=np.float32)[ids]
    want_ce = jag.CrossEntropy().forward(probs, onehot)
    got_ce = tag.cross_entropy(ttensor.Tensor(data=probs, device=dev),
                               ttensor.Tensor(data=onehot, device=dev))
    np.testing.assert_allclose(float(got_ce.data), float(want_ce),
                               rtol=1e-6)


def test_params_are_leaves_that_refills_keep():
    """get_params is the trainable subset of get_states; each parameter is
    a torch leaf that requires grad, and load_numpy_states / copy_from
    refill that same leaf in place."""
    x, _ = _batch()
    m, _ = _port_model("NCHW", x)
    states, params = m.get_states(), m.get_params()
    assert set(params) == {k for k in states
                           if not k.rsplit(".", 1)[-1].startswith("running")}
    assert len(params) == 53
    leaves = {k: t.data for k, t in params.items()}
    assert all(v.is_leaf and v.requires_grad for v in leaves.values())
    load_numpy_states(m, _states_from_seed(sorted(
        (k, tuple(v.shape)) for k, v in states.items())))
    w = params["ResNet.fc.W"]
    w.copy_from(np.zeros(tuple(w.shape), np.float32))
    assert all(params[k].data is v for k, v in leaves.items())
    assert all(v.is_leaf and v.requires_grad for v in leaves.values())
    assert float(w.data.detach().abs().sum()) == 0.0
