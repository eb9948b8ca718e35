"""The port's CNN zoo (MLP, the LeNet-style CNN, AlexNet, Xception) and
``Dropout``, held against the JAX package on the CPU.

Each model is built in both packages; weights and BN statistics are made
with numpy from a seed and carried across by ``load_numpy_states``, the
batch too. Training runs ``SGD(lr=0.02, momentum=0.9, weight_decay=1e-5,
fused=True)`` for 3 steps at batch 2 in each package: the JAX package
compiled (``use_graph=True``), the port in graph mode on the CPU, where
the kernel's plain version stands in. The JAX side runs its Pallas kernel
in interpret mode (``FORCE_PALLAS_INTERPRET``) for the MLP, the CNN and
the Xception blocks. For AlexNet it runs its plain optimizer chain (the
fused step declines off the TPU): the interpret-mode kernel takes about
115 s per step on one core over AlexNet's 58M parameters, and the
kernel's arithmetic against its plain version is held in
``test_torch_fused_optim.py``. AlexNet's two ``Dropout`` layers are set
to ratio 0 in both packages for the comparison (the two packages draw
from different generators).

Tolerance, as the ResNet training file holds it and for the same reason
(the packages sum convolutions and products in different orders, and a
batch of 2 with batch-statistic BNs amplifies last-bit differences):
losses within rtol 1e-3 / atol 1e-4; each parameter and running
statistic within 5e-3 of its norm, each momentum within 5e-2 of its norm.
The whole Xception (299 px, b1) is held in eval against the JAX package
through K2's plain version: logits within 1e-4 (rtol and atol), where
only the BN fold's rounding and the summation order differ. The pure-bf16
path (``-p bfloat16``: the input cast to bf16, parameters follow it) is
held at rtol 5e-2 on the losses, the bound ``tests/test_models.py``
holds the JAX package's own bf16 CNN to against its f32 run.
"""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import alexnet as jalexnet
from singa_tpu.models import cnn as jcnn
from singa_tpu.models import mlp as jmlp
from singa_tpu.models import xceptionnet as jxception
from singa_tpu.ops import fused_optim as jfo

from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import alexnet as talexnet
from singa_tpu_torch.models import cnn as tcnn
from singa_tpu_torch.models import mlp as tmlp
from singa_tpu_torch.models import xceptionnet as txception
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import fused_optim as tfo

BATCH = 2
STEPS = 3
SGD_KW = dict(lr=0.02, momentum=0.9, weight_decay=1e-5, fused=True)
RTOL, ATOL = 1e-3, 1e-4          # losses
STATE_TOL, MOMENTUM_TOL = 5e-3, 5e-2
LOGIT_TOL = 1e-4
BF16_RTOL = 5e-2
# K2 tails of one Xception eval forward (the peephole's calls): frozen
# BN -> ReLU at the stem (2), inside the blocks (1 + 1 + 1, 8 x 2, 1) and
# at the exit (2); BN + skip -> ReLU at the entry of blocks 2-12
XCEPTION_TAILS = {"affine_relu": 24, "affine_add_relu": 11}


@pytest.fixture(autouse=True)
def _port_eval_after():
    yield
    TCTX.training = False


@pytest.fixture(autouse=True)
def _no_jax_weight_draws(monkeypatch):
    """Every JAX model here gets its weights from the numpy seed, so its
    own N(0, std) draws (20 s of threefry on one core for AlexNet) are
    skipped: the parameters keep their zeros until the seed's copy."""
    monkeypatch.setattr(jtensor.Tensor, "gaussian",
                        lambda self, mean=0.0, std=1.0: self)


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


def _close(got, want, tol, what):
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    assert err <= tol * float(np.linalg.norm(want)) + 1e-7, \
        f"{what}: |got - want| = {err:.3g}, |want| = " \
        f"{float(np.linalg.norm(want)):.3g}"


def _batch(shape, seed=5, classes=10):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, *shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, BATCH)]
    return x, y


def _jax_train(model, x, y, steps=STEPS, interpret=True, bf16=False):
    """Losses of ``steps`` fused-SGD steps of a JAX ``model`` from seeded
    states, the states and optimizer states after, and the start."""
    prev = jfo.FORCE_PALLAS_INTERPRET
    jfo.FORCE_PALLAS_INTERPRET = interpret
    try:
        dev = jdevice.create_cpu_device()
        model.set_optimizer(jopt.SGD(**SGD_KW))
        tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
        if bf16:
            import jax.numpy as jnp
            tx = tx.as_type(jnp.bfloat16)
        ty = jtensor.Tensor(data=y, device=dev, requires_grad=False)
        model.compile([tx], is_train=True, use_graph=True)
        live = model.get_states()
        init = _states_from_seed(sorted((k, tuple(v.shape))
                                        for k, v in live.items()))
        for k, v in init.items():
            live[k].copy_from_numpy(v)
        losses = [float(np.asarray(model(tx, ty)[1].data, np.float32))
                  for _ in range(steps)]
        states = {k: np.asarray(v.data, np.float32)
                  for k, v in model.get_states().items()}
        ostates = {k: np.asarray(v, np.float32)
                   for k, v in model.optimizer.get_states().items()}
    finally:
        jfo.FORCE_PALLAS_INTERPRET = prev
    return dict(init=init, losses=losses, states=states, ostates=ostates)


def _port_train(model, x, y, init, steps=STEPS, bf16=False):
    dev = tdevice.create_cpu_device()
    model.set_optimizer(topt.SGD(**SGD_KW))
    tx = ttensor.Tensor(data=x, device=dev)
    if bf16:
        tx = tx.as_type("bfloat16")
    ty = ttensor.Tensor(data=y, device=dev)
    model.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(model, init)
    tfo.reset_counts()
    losses = [float(model(tx, ty)[1].data.detach().float())
              for _ in range(steps)]
    assert sum(tfo.launches.values()) == 0    # the plain version on the CPU
    return losses


def _held(model, ref, losses, steps=STEPS):
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref["losses"], rtol=RTOL, atol=ATOL)
    mine = {k: v.to_numpy() for k, v in model.get_states().items()}
    assert sorted(mine) == sorted(ref["states"])
    for k, want in ref["states"].items():
        _close(mine[k], want, STATE_TOL, k)
    ostates = model.optimizer.get_states()
    assert sorted(ostates) == sorted(ref["ostates"])
    assert float(ostates["step_counter"]) == steps
    for k, want in ref["ostates"].items():
        _close(np.asarray(ostates[k]), want, MOMENTUM_TOL, k)


def _no_dropout(m):
    m.dropout1.ratio = 0.0
    m.dropout2.ratio = 0.0
    return m


ZOO = {
    "mlp": (lambda: jmlp.create_model(data_size=784),
            lambda: tmlp.create_model(data_size=784), (784,), True),
    "cnn": (jcnn.create_model, tcnn.create_model, (1, 28, 28), True),
    "alexnet": (lambda: _no_dropout(jalexnet.create_model(num_channels=3)),
                lambda: _no_dropout(talexnet.create_model(num_channels=3)),
                (3, 224, 224), False),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_three_sgd_steps_match_jax(name):
    jmake, tmake, shape, interpret = ZOO[name]
    x, y = _batch(shape)
    ref = _jax_train(jmake(), x, y, interpret=interpret)
    m = tmake()
    losses = _port_train(m, x, y, ref["init"])
    _held(m, ref, losses)
    assert m.graph_stats() and all(
        s["n_captures"] == 1 for s in m.graph_stats().values())


# -- Xception -------------------------------------------------------------

def _block_net(pkg_layer, pkg_model, block_cls, **kw):
    class BlockNet(pkg_model.Model):
        def __init__(self):
            super().__init__()
            self.block = block_cls(8, 2, **kw)
            self.flatten = pkg_layer.Flatten()
            self.fc = pkg_layer.Linear(3)
            self.loss_fn = pkg_layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.flatten(self.block(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss
    return BlockNet()


BLOCKS = {   # in channels, Block keywords
    "identity_skip": (8, dict(strides=1)),
    "identity_skip_grow_last": (8, dict(strides=1, grow_first=False)),
    "conv_skip_channels": (4, dict(strides=1)),
    "conv_skip_stride2": (8, dict(strides=2, grow_first=False)),
    "conv_skip_stride2_no_start_relu": (
        4, dict(strides=2, start_with_relu=False)),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_xception_block_step_matches_jax(case):
    """A narrow ``Block`` (out_filters 8, reps 2): forward, backward and
    one step; the skip conv + BN exists exactly where the shape
    changes."""
    cin, kw = BLOCKS[case]
    x, y = _batch((cin, 8, 8), classes=3)
    ref = _jax_train(_block_net(jlayer, jmodel, jxception.Block, **kw),
                     x, y, steps=1)
    m = _block_net(tlayer, tmodel, txception.Block, **kw)
    losses = _port_train(m, x, y, ref["init"], steps=1)
    _held(m, ref, losses, steps=1)
    assert (m.block.skip is not None) == (cin != 8 or kw["strides"] != 1)


def test_whole_xception_eval_matches_jax_through_k2():
    """Xception at 299 px, b1, eval: the port's forward with the epilogue
    on (K2's plain version on the CPU) against the JAX package's, and the
    peephole's K2a (BN -> ReLU) and K2c (BN + skip -> ReLU) calls
    pinned."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 3, 299, 299).astype(np.float32)
    jdev = jdevice.create_cpu_device()
    jm = jxception.create_model()
    jx = jtensor.Tensor(data=x, device=jdev, requires_grad=False)
    jm.compile([jx], is_train=False, use_graph=False)
    live = jm.get_states()
    init = _states_from_seed(sorted((k, tuple(v.shape))
                                    for k, v in live.items()), seed=4)
    for k, v in init.items():
        live[k].copy_from_numpy(v)
    ref = np.asarray(jm(jx).data)

    dev = tdevice.create_cpu_device()
    m = txception.create_model()
    tx = ttensor.Tensor(data=x, device=dev)
    m.compile([tx], is_train=False)
    assert sorted(m.get_states()) == sorted(init)
    load_numpy_states(m, init)
    calls = {"affine_relu": 0, "affine_add_relu": 0}
    relu, add_relu = tfe.scale_shift_relu, tfe.scale_shift_add_relu

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped
    mp = pytest.MonkeyPatch()
    mp.setattr(tfe, "scale_shift_relu", count("affine_relu", relu))
    mp.setattr(tfe, "scale_shift_add_relu",
               count("affine_add_relu", add_relu))
    try:
        with tfe.enabled_scope(True):
            got = m(tx).to_numpy()
    finally:
        mp.undo()
    assert calls == XCEPTION_TAILS
    assert got.shape == (1, 10) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with tfe.enabled_scope(False):
        plain = m(tx).to_numpy()
    np.testing.assert_allclose(got, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_separable_conv_names_and_checkpoint_cross(tmp_path):
    """``<name>.depthwise.W`` / ``<name>.pointwise.W``: a JAX
    ``save_states`` zip of a SeparableConv2d model loads in the port with
    the same output, and the port's zip loads in JAX."""
    class Sep:
        def __init__(self, pkg_layer, pkg_model):
            class Net(pkg_model.Model):
                def __init__(self):
                    super().__init__()
                    self.conv = pkg_layer.SeparableConv2d(6, 3, padding=1,
                                                          bias=True)

                def forward(self, x):
                    return self.conv(x)
            self.net = Net()
    x = np.random.RandomState(0).randn(2, 4, 5, 5).astype(np.float32)
    jdev, dev = jdevice.create_cpu_device(), tdevice.create_cpu_device()
    jm, m = Sep(jlayer, jmodel).net, Sep(tlayer, tmodel).net
    jx = jtensor.Tensor(data=x, device=jdev, requires_grad=False)
    tx = ttensor.Tensor(data=x, device=dev)
    jm.compile([jx], is_train=False, use_graph=False)
    m.compile([tx], is_train=False)
    names = sorted(m.get_states())
    assert names == sorted(jm.get_states()) == [
        "Net.conv.depthwise.W", "Net.conv.depthwise.b",
        "Net.conv.pointwise.W", "Net.conv.pointwise.b"]
    assert tuple(m.get_states()["Net.conv.depthwise.W"].shape) == \
        (4, 1, 3, 3)
    path = tmp_path / "jax.zip"
    init = _states_from_seed([(k, tuple(v.shape)) for k, v in
                              sorted(jm.get_states().items())])
    for k, v in init.items():
        jm.get_states()[k].copy_from_numpy(v)
    jm.save_states(str(path))
    m.load_states(str(path))
    want = np.asarray(jm(jx).data)
    np.testing.assert_allclose(m(tx).to_numpy(), want, rtol=1e-5,
                               atol=1e-5)
    back = tmp_path / "port.zip"
    jm2 = Sep(jlayer, jmodel).net
    jm2.compile([jx], is_train=False, use_graph=False)
    m.save_states(str(back))
    jm2.load_states(str(back))
    np.testing.assert_allclose(np.asarray(jm2(jx).data), want, rtol=1e-5,
                               atol=1e-5)


# -- Dropout --------------------------------------------------------------

def _dropout_in(shape, seed=0, training=True):
    dev = tdevice.create_cpu_device()
    dev.SetRandSeed(seed)
    x = ttensor.Tensor(data=np.random.RandomState(1).randn(*shape)
                       .astype(np.float32) + 3.0, device=dev)
    TCTX.training = training
    return dev, x


def test_dropout_is_the_identity_in_eval_and_at_ratio_0():
    _, x = _dropout_in((4, 5), training=False)
    assert tautograd.dropout(x, 0.5) is x
    assert tlayer.Dropout(0.5)(x).data is x.data
    _, x = _dropout_in((4, 5))
    assert tautograd.dropout(x, 0.0) is x


def test_dropout_mask_from_the_device_seed():
    """The same device seed draws the same mask; torch's global generator
    is not read (reseeding it changes nothing)."""
    _, x = _dropout_in((64, 64), seed=7)
    torch.manual_seed(0)
    a = tautograd.dropout(x, 0.3).to_numpy()
    _, x = _dropout_in((64, 64), seed=7)
    torch.manual_seed(1)
    b = tautograd.dropout(x, 0.3).to_numpy()
    np.testing.assert_array_equal(a, b)
    _, x = _dropout_in((64, 64), seed=8)
    assert not np.array_equal(a, tautograd.dropout(x, 0.3).to_numpy())


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_dropout_keep_share_scaling_and_gradient(ratio):
    n = 100_000
    _, x = _dropout_in((n,), seed=3)
    xa = x.data.clone().requires_grad_(True)
    x.data = xa
    y = tautograd.dropout(x, ratio)
    keep = 1.0 - ratio
    kept = (y.data != 0).detach().numpy()
    sigma = np.sqrt(n * keep * ratio)
    assert abs(kept.sum() - n * keep) <= 4 * sigma, (kept.sum(), n * keep)
    xs = xa.detach().numpy()
    np.testing.assert_allclose(y.data.detach().numpy()[kept],
                               (xs / np.float32(keep))[kept], rtol=1e-6)
    (g,) = torch.autograd.grad(y.data.sum(), [xa])
    np.testing.assert_allclose(g.numpy(), kept / np.float32(keep),
                               rtol=1e-6)


class _DropNet:
    """Linear -> Dropout -> ReLU -> Dropout -> Linear in the port, the
    shape of AlexNet's classifier at a small width."""

    def __new__(cls):
        class DropNet(tmodel.Model):
            def __init__(self):
                super().__init__()
                self.fc1 = tlayer.Linear(32)
                self.drop1 = tlayer.Dropout(0.5)
                self.relu = tlayer.ReLU()
                self.drop2 = tlayer.Dropout(0.3)
                self.fc2 = tlayer.Linear(10)
                self.loss_fn = tlayer.SoftMaxCrossEntropy()

            def forward(self, x):
                return self.fc2(self.drop2(self.relu(self.drop1(
                    self.fc1(x)))))

            def train_one_batch(self, x, y):
                out = self.forward(x)
                loss = self.loss_fn(out, y)
                self.optimizer(loss)
                return out, loss
        return DropNet()


def test_dropout_trains_alike_in_graph_and_eager(monkeypatch):
    """Graph mode (on the CPU: the same books, the step run where the card
    would replay) and eager, dropout on, the same device seed: the same
    masks, losses and states bitwise, and each step draws a new mask."""
    x, y = _batch((48,))
    masks = []
    real = tautograd.dropout

    def spy(t, ratio=0.5):
        out = real(t, ratio)
        masks.append((out.data != 0).detach().clone())
        return out
    monkeypatch.setattr(tautograd, "dropout", spy)
    runs = []
    for graph in (True, False):
        dev = tdevice.create_cpu_device()
        dev.SetRandSeed(5)
        m = _DropNet()
        m.set_optimizer(topt.SGD(**SGD_KW))
        tx = ttensor.Tensor(data=x, device=dev)
        ty = ttensor.Tensor(data=y, device=dev)
        m.compile([tx], is_train=True, use_graph=graph)
        load_numpy_states(m, _states_from_seed(sorted(
            (k, tuple(v.shape)) for k, v in m.get_states().items())))
        del masks[:]
        losses = [float(m(tx, ty)[1].data.detach()) for _ in range(4)]
        runs.append((list(masks), losses, {k: v.to_numpy() for k, v in
                                           m.get_states().items()}))
    (gm, gl, gs), (em, el, es) = runs
    assert len(gm) == len(em) == 8          # two Dropouts a step
    for a, b in zip(gm, em):
        assert torch.equal(a, b)
    assert all(not torch.equal(gm[i], gm[i + 2]) for i in range(6))
    assert gl == el
    for k in gs:
        np.testing.assert_array_equal(gs[k], es[k], err_msg=k)


# -- pure bf16 -------------------------------------------------------------

def test_pure_bf16_cnn_tracks_jax():
    """``-p bfloat16``: the input cast to bf16, conv and linear parameters
    follow it (BN's stay f32), no policy; 5 steps: the port's losses
    within rtol 5e-2 of the JAX package's under the same cast, and lower
    at the end than at the start (at b2 on one batch the loss of both
    packages rises at step 3 before it falls)."""
    x, y = _batch((1, 28, 28))
    ref = _jax_train(jcnn.create_model(), x, y, steps=5, bf16=True)
    m = tcnn.create_model()
    losses = _port_train(m, x, y, ref["init"], steps=5, bf16=True)
    assert m.conv1.W.dtype == torch.bfloat16
    assert m.optimizer.get_states() and all(
        t.dtype == torch.bfloat16 for k, t in
        m.optimizer.state_tensor_dict().items() if ":momentum" in k)
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, ref["losses"], rtol=BF16_RTOL)
