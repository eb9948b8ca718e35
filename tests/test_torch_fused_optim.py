"""Kernels K1, K5, K6 and K7 of the port (``singa_tpu_torch/ops/
fused_optim.py``) and the optimizers that drive them (``opt.py``), held
against the JAX package on the CPU.

Each plain version (``*_reference``, what the wrapper runs for a CPU
tensor and what the CUDA kernel is held to bitwise on the card) is held
against the Pallas kernel body of ``singa_tpu/ops/fused_optim.py``, run in
interpret mode (``FORCE_PALLAS_INTERPRET``, as
``tests/test_fused_kernels.py`` does), on the same numpy inputs.

Tolerance: 2 ULP of the output's largest magnitude (``|got - want| <= 2 *
2**-23 * max(|want|, 1)``), not bitwise: XLA's CPU backend contracts each
multiply-add of the kernel body into one fused multiply-add (checked: the
interpret-mode momentum equals an FMA of ``0.9 * m + g`` everywhere and
the two-rounding sum in a quarter of the elements), while the port rounds
the product and the sum separately, as the CUDA kernel does on purpose.
Measured worst case over these shapes and settings: 0.98 of that unit.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.ops import fused_optim as jfo

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import fused_optim as tfo

SHAPES = [(1024,), (64, 64), (7,), (13, 10), (4099,), (3, 3, 3, 5)]
ULPS = 2


@pytest.fixture(autouse=True)
def _interpret_kernels():
    prev = jfo.FORCE_PALLAS_INTERPRET
    jfo.FORCE_PALLAS_INTERPRET = True
    try:
        yield
    finally:
        jfo.FORCE_PALLAS_INTERPRET = prev
        TCTX.training = False


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, what=""):
    want = np.asarray(want)
    tol = ULPS * 2.0 ** -23 * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("wd,nesterov,dampening", [
    (0.0, False, 0.0), (1e-4, False, 0.0), (1e-4, True, 0.0),
    (0.0, True, 0.0), (1e-4, False, 0.1), (0.0, False, 0.5)])
def test_sgd_matches_the_pallas_kernel(shape, wd, nesterov, dampening):
    i = SHAPES.index(shape)
    p, g, m = _rand(shape, i), _rand(shape, i + 50), _rand(shape, i + 100)
    pj, mj = jfo.sgd_momentum_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.float32(0.1),
        momentum=0.9, dampening=dampening, weight_decay=wd,
        nesterov=nesterov)
    pt, gt, mt = torch.tensor(p), torch.tensor(g), torch.tensor(m)
    out = tfo.sgd_momentum_update(pt, gt, mt, torch.tensor(0.1),
                                  momentum=0.9, dampening=dampening,
                                  weight_decay=wd, nesterov=nesterov)
    assert out[0] is pt and out[1] is mt            # updated in place
    _close(pt.numpy(), pj, "p")
    _close(mt.numpy(), mj, "m")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_adam_matches_the_pallas_kernel(shape):
    i = SHAPES.index(shape)
    p, g = _rand(shape, i), _rand(shape, i + 1)
    m, v = _rand(shape, i + 2), np.abs(_rand(shape, i + 3))
    bc1, bc2 = np.float32(1 - 0.9 ** 4), np.float32(1 - 0.999 ** 4)
    want = jfo.adam_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.float32(0.01), jnp.float32(bc1), jnp.float32(bc2), beta_1=0.9,
        beta_2=0.999, epsilon=1e-8, weight_decay=1e-4)
    ts = [torch.tensor(a) for a in (p, g, m, v)]
    out = tfo.adam_update(*ts, torch.tensor(0.01), torch.tensor(bc1),
                          torch.tensor(bc2), beta_1=0.9, beta_2=0.999,
                          epsilon=1e-8, weight_decay=1e-4)
    assert out[0] is ts[0] and out[1] is ts[2] and out[2] is ts[3]
    for got, w, what in zip(out, want, "pmv"):
        _close(got.numpy(), w, what)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rmsprop_matches_the_pallas_kernel(shape):
    i = SHAPES.index(shape)
    p, g, r = _rand(shape, i), _rand(shape, i + 1), \
        np.abs(_rand(shape, i + 2))
    want = jfo.rmsprop_update(jnp.asarray(p), jnp.asarray(g),
                              jnp.asarray(r), jnp.float32(0.05), rho=0.9,
                              epsilon=1e-8, weight_decay=1e-4)
    ts = [torch.tensor(a) for a in (p, g, r)]
    out = tfo.rmsprop_update(ts[0], ts[1], ts[2], torch.tensor(0.05),
                             rho=0.9, epsilon=1e-8, weight_decay=1e-4)
    assert out[0] is ts[0] and out[1] is ts[2]
    _close(ts[0].numpy(), want[0], "p")
    _close(ts[2].numpy(), want[1], "rms")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_adagrad_matches_the_pallas_kernel(shape):
    i = SHAPES.index(shape)
    p, g, h = _rand(shape, i), _rand(shape, i + 1), \
        np.abs(_rand(shape, i + 2))
    want = jfo.adagrad_update(jnp.asarray(p), jnp.asarray(g),
                              jnp.asarray(h), jnp.float32(0.1),
                              epsilon=1e-8, weight_decay=0.0)
    ts = [torch.tensor(a) for a in (p, g, h)]
    tfo.adagrad_update(ts[0], ts[1], ts[2], torch.tensor(0.1),
                       epsilon=1e-8, weight_decay=0.0)
    _close(ts[0].numpy(), want[0], "p")
    _close(ts[2].numpy(), want[1], "history")


def test_16_bit_state_rounds_before_it_is_read_back():
    """RMSProp with a bf16 mean square: the step reads the STORED (bf16)
    state, as the JAX kernel does."""
    p, g = _rand((257,), 0), _rand((257,), 1)
    r = np.abs(_rand((257,), 2))
    want = jfo.rmsprop_update(jnp.asarray(p), jnp.asarray(g),
                              jnp.asarray(r, jnp.bfloat16),
                              jnp.float32(0.05), rho=0.9, epsilon=1e-8)
    pt = torch.tensor(p)
    rt = torch.tensor(r).to(torch.bfloat16)
    tfo.rmsprop_update(pt, torch.tensor(g), rt, 0.05, rho=0.9,
                       epsilon=1e-8)
    np.testing.assert_array_equal(rt.float().numpy(),
                                  np.asarray(want[1], np.float32))
    _close(pt.numpy(), want[0], "p")


def test_gradient_of_another_dtype_is_cast_to_the_param_dtype():
    p, g, m = _rand((33,), 0), _rand((33,), 1), _rand((33,), 2)
    a = [torch.tensor(p), torch.tensor(m)]
    b = [torch.tensor(p), torch.tensor(m)]
    tfo.sgd_momentum_update(a[0], torch.tensor(g).to(torch.bfloat16), a[1],
                            0.1, momentum=0.9)
    tfo.sgd_momentum_update(b[0], torch.tensor(g).to(torch.bfloat16)
                            .float(), b[1], 0.1, momentum=0.9)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# wrapper dispatch: the CPU takes the plain version; a launch bumps versions
# ---------------------------------------------------------------------------

def test_a_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def no_kernel(kind):
        raise AssertionError(f"the {kind} kernel was asked for a CPU tensor")
    monkeypatch.setattr(tfo, "_function", no_kernel)
    tfo.reset_counts()
    p, g, m = (torch.tensor(_rand((8,), i)) for i in range(3))
    tfo.sgd_momentum_update(p, g, m, 0.1, momentum=0.9)
    tfo.adam_update(p, g, m, m.abs(), 0.1, 0.1, 0.001, beta_1=0.9,
                    beta_2=0.999, epsilon=1e-8)
    tfo.rmsprop_update(p, g, m.abs(), 0.1, rho=0.9, epsilon=1e-8)
    tfo.adagrad_update(p, g, m.abs(), 0.1, epsilon=1e-8)
    assert sum(tfo.launches.values()) == 0


def test_a_launch_bumps_the_version_of_every_written_tensor(monkeypatch):
    """The kernel writes through raw pointers. Stand in for it with a
    function that does the same (ctypes.memmove of the plain version's
    result) and check that the wrapper counts the launch, bumps p's and
    m's versions, and so invalidates a cached serving BN fold of p."""
    def fake_sgd(p_dt, s_dt, p_ptr, g_ptr, m_ptr, lr_ptr, n, mom, omd, wd,
                 nesterov, stream):
        ctypes.memmove(p_ptr, want_p.data_ptr(), n * 4)
        ctypes.memmove(m_ptr, want_m.data_ptr(), n * 4)
        return 0

    monkeypatch.setattr(tfo, "_device_kind", lambda p: "cuda")
    monkeypatch.setattr(tfo, "_function", lambda kind: fake_sgd)
    monkeypatch.setattr(tfo, "_stream", lambda dev: None)
    dev = tdevice.create_cpu_device()
    scale = ttensor.Tensor(data=np.ones(16, np.float32) * 1.5, device=dev)
    bias = ttensor.Tensor(data=np.zeros(16, np.float32), device=dev)
    rmean = ttensor.Tensor(data=np.zeros(16, np.float32), device=dev)
    rvar = ttensor.Tensor(data=np.ones(16, np.float32), device=dev)
    s_before, _ = tfe._folded(scale, bias, rmean, rvar, 1e-5)
    g, m = torch.tensor(_rand((16,), 1)), torch.tensor(_rand((16,), 2))
    want_p, want_m = scale.data.clone(), m.clone()
    tfo.sgd_momentum_update_reference(want_p, g, want_m, 0.1, momentum=0.9)
    versions = (scale.data._version, m._version)
    tfo.reset_counts()
    out = tfo.sgd_momentum_update(scale.data, g, m, 0.1, momentum=0.9)
    assert out[0] is scale.data and out[1] is m
    assert tfo.launches["sgd"] == 1
    assert scale.data._version > versions[0] and m._version > versions[1]
    assert torch.equal(scale.data, want_p) and torch.equal(m, want_m)
    s_after, _ = tfe._folded(scale, bias, rmean, rvar, 1e-5)
    assert not torch.equal(s_after, s_before)
    torch.testing.assert_close(
        s_after, want_p / torch.sqrt(torch.tensor(1.0 + 1e-5)))


# ---------------------------------------------------------------------------
# the optimizers: a small model in both packages
# ---------------------------------------------------------------------------

def _mlp(pkg_layer, pkg_model):
    class MLP(pkg_model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg_layer.Linear(32)
            self.relu = pkg_layer.ReLU()
            self.fc2 = pkg_layer.Linear(3)
            self.loss_fn = pkg_layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss
    return MLP()


def _data(seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(16, 6).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    return xs, ys


def _init_states(names_shapes):
    rng = np.random.RandomState(4)
    return {k: (rng.randn(*s) * 0.3).astype(np.float32)
            for k, s in names_shapes}


def _train_port(optimizer, steps=5):
    dev = tdevice.create_cpu_device()
    m = _mlp(tlayer, tmodel)
    m.set_optimizer(optimizer)
    xs, ys = _data()
    tx = ttensor.Tensor(data=xs, device=dev)
    ty = ttensor.Tensor(data=ys, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    tmodel.load_numpy_states(m, _init_states(
        sorted((k, tuple(v.shape)) for k, v in m.get_states().items())))
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(steps)]
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    states.update(m.optimizer.get_states())
    return losses, states


def _train_jax(optimizer, steps=5):
    dev = jdevice.create_cpu_device()
    m = _mlp(jlayer, jmodel)
    m.set_optimizer(optimizer)
    xs, ys = _data()
    tx = jtensor.Tensor(data=xs, device=dev, requires_grad=False)
    ty = jtensor.Tensor(data=ys, device=dev, requires_grad=False)
    m.compile([tx], is_train=True, use_graph=True)
    live = m.get_states()
    for k, v in _init_states(sorted((k, tuple(v.shape))
                                    for k, v in live.items())).items():
        live[k].copy_from_numpy(v)
    losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(steps)]
    states = {k: np.asarray(v.data) for k, v in m.get_states().items()}
    states.update({k: np.asarray(v)
                   for k, v in m.optimizer.get_states().items()})
    return losses, states


OPTIMIZERS = {
    "sgd": lambda pkg, fused: pkg.SGD(lr=0.1, momentum=0.9,
                                      weight_decay=1e-4, fused=fused),
    "sgd_nesterov": lambda pkg, fused: pkg.SGD(
        lr=0.1, momentum=0.9, nesterov=True, fused=fused),
    "adam": lambda pkg, fused: pkg.Adam(lr=0.01, weight_decay=1e-4,
                                        fused=fused),
    "rmsprop": lambda pkg, fused: pkg.RMSProp(lr=0.05, rho=0.9,
                                              weight_decay=1e-4,
                                              fused=fused),
    "adagrad": lambda pkg, fused: pkg.AdaGrad(lr=0.1, fused=fused),
}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_fused_optimizer_matches_jax_and_its_own_plain_chain(kind):
    """5 steps of a 2-layer MLP: the port's fused optimizer against the
    JAX package's (rtol 1e-5 / atol 1e-6: only the matmul summation order
    and XLA's FMA contraction differ), and bitwise against the port's own
    unfused chain, which the CUDA kernel is held to on the card."""
    make = OPTIMIZERS[kind]
    want_losses, want = _train_jax(make(jopt, True))
    losses, got = _train_port(make(topt, True))
    _, plain = _train_port(make(topt, False))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    assert sorted(got) == sorted(want) == sorted(plain)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tfo, name)

    def spy(p, *args, **kwargs):
        calls.append((p, args))
        return real(p, *args, **kwargs)
    monkeypatch.setattr(tfo, name, spy)
    return calls


def _fused_param_names(calls, m):
    by_id = {id(t.data): k for k, t in m.get_states().items()}
    return sorted(by_id[id(p)] for p, _ in calls)


@pytest.mark.parametrize("decline", ["regularizer", "constraint",
                                     "not_fused"])
def test_decline_rules(monkeypatch, decline):
    """A regularizer or a constraint on a param keeps THAT param on the
    plain chain; ``fused=False`` keeps every param there."""
    calls = _spy(monkeypatch, "sgd_momentum_update")
    o = topt.SGD(lr=0.1, momentum=0.9, fused=decline != "not_fused")
    if decline == "regularizer":
        o.register("MLP.fc1.W", regularizer=topt.Regularizer("l2", 1e-3))
    elif decline == "constraint":
        o.register("MLP.fc1.W", constraint=topt.Constraint("l2", 0.5))
    dev = tdevice.create_cpu_device()
    m = _mlp(tlayer, tmodel)
    m.set_optimizer(o)
    xs, ys = _data()
    tx = ttensor.Tensor(data=xs, device=dev)
    m.compile([tx], is_train=True)
    m(tx, ttensor.Tensor(data=ys, device=dev))
    names = _fused_param_names(calls, m)
    if decline == "not_fused":
        assert names == []
    else:
        assert names == ["MLP.fc1.b", "MLP.fc2.W", "MLP.fc2.b"]


def test_non_float_params_and_amsgrad_decline(monkeypatch):
    assert not topt.SGD(momentum=0.9, fused=True)._fused_ok(
        "w", torch.zeros(3, dtype=torch.int32))
    assert topt.SGD(momentum=0.9, fused=True)._fused_ok(
        "w", torch.zeros(3, dtype=torch.bfloat16))
    calls = _spy(monkeypatch, "adam_update")
    _train_port(topt.Adam(lr=0.01, amsgrad=True, fused=True), steps=2)
    assert calls == []


def test_lr_schedule_is_a_device_scalar_read_by_the_kernel(monkeypatch):
    """An ExponentialDecay schedule: each step's lr is a 0-d f32 tensor on
    the params' device (what the kernel reads through a pointer), equal to
    the JAX schedule, computed once per step; fused and unfused training
    under it agree bitwise and match the JAX package."""
    calls = _spy(monkeypatch, "sgd_momentum_update")

    def sched():
        return dict(lr=topt.ExponentialDecay(0.2, decay_steps=2,
                                             decay_rate=0.5), momentum=0.9)
    losses, got = _train_port(topt.SGD(**sched(), fused=True), steps=6)
    lrs = sorted({float(args[2]) for _, args in calls}, reverse=True)
    for _, args in calls:
        lr = args[2]
        assert isinstance(lr, torch.Tensor) and lr.dim() == 0
        assert lr.dtype == torch.float32 and lr.device.type == "cpu"
    jsched = jopt.ExponentialDecay(0.2, decay_steps=2, decay_rate=0.5)
    want_lrs = [float(np.asarray(jsched(jnp.float32(s)))) for s in range(6)]
    np.testing.assert_allclose(lrs, sorted(set(want_lrs), reverse=True),
                               rtol=2 ** -22)
    assert len(calls) == 6 * 4
    _, plain = _train_port(topt.SGD(**sched()), steps=6)
    want_losses, want = _train_jax(jopt.SGD(
        lr=jopt.ExponentialDecay(0.2, decay_steps=2, decay_rate=0.5),
        momentum=0.9, fused=True), steps=6)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    for k in want:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_optimizer_states_round_trip():
    o = topt.Adam(lr=0.01, fused=True)
    _, states = _train_port(o, steps=2)
    saved = o.get_states()
    assert float(saved["step_counter"]) == 2.0
    assert float(saved["loss_scale"]) == 1.0
    assert sorted(k.rsplit(":", 1)[-1] for k in saved
                  if ":" in k) == ["m"] * 4 + ["v"] * 4
    fresh = topt.Adam(lr=0.01, fused=True)
    assert float(fresh.get_states()["step_counter"]) == 0.0
    with pytest.raises(RuntimeError, match="bind"):
        fresh.set_states(saved)
    fresh.bind(tdevice.create_cpu_device())
    fresh.set_states(saved)
    again = fresh.get_states()
    for k, v in saved.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_backward_gradients_match_jax_and_take_a_seed():
    """``autograd_base.backward`` / ``gradients`` of the MLP's loss: the
    same parameters, the last layer's first as in the JAX tape walk, the
    same gradients, and a ``dy`` seed scales them."""
    from singa_tpu import autograd_base as jab
    from singa_tpu.autograd_base import CTX as JCTX
    from singa_tpu_torch import autograd_base as tab
    xs, ys = _data()
    jdev = jdevice.create_cpu_device()
    jm = _mlp(jlayer, jmodel)
    jm.set_optimizer(jopt.SGD(lr=0.1))
    jx = jtensor.Tensor(data=xs, device=jdev, requires_grad=False)
    jy = jtensor.Tensor(data=ys, device=jdev, requires_grad=False)
    jm.compile([jx], is_train=True)
    init = _init_states(sorted((k, tuple(v.shape))
                               for k, v in jm.get_states().items()))
    for k, v in init.items():
        jm.get_states()[k].copy_from_numpy(v)
    JCTX.training = True
    try:
        jloss = jm.loss_fn(jm.forward(jx), jy)
        want = [(p.name, np.asarray(g.data)) for p, g in
                jab.backward(jloss)]
    finally:
        JCTX.training = False

    dev = tdevice.create_cpu_device()
    m = _mlp(tlayer, tmodel)
    tx, ty = ttensor.Tensor(data=xs, device=dev), \
        ttensor.Tensor(data=ys, device=dev)
    m.compile([tx], is_train=True)
    tmodel.load_numpy_states(m, init)
    loss = m.loss_fn(m.forward(tx), ty)
    got = [(p.name, g.to_numpy()) for p, g in tab.backward(loss)]
    order = [k for k, _ in got]
    assert sorted(order) == sorted(k for k, _ in want)
    assert {k.split(".")[1] for k in order[:2]} == {"fc2"}
    for k, b in want:
        np.testing.assert_allclose(dict(got)[k], b, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    loss = m.loss_fn(m.forward(tx), ty)
    seeded = tab.gradients(loss, dy=2.0)
    for p, g in seeded.items():
        np.testing.assert_allclose(g.to_numpy(), 2 * dict(got)[p.name],
                                   rtol=1e-6, err_msg=p.name)
        assert p.grad is g
