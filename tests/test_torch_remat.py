"""The port's rematerialisation (``autograd.checkpoint``,
``TransformerLM(remat=True)``) held against its own stored-activation
run and against the JAX package (``tests/test_transformer.py::TestRemat``).

The LM of ``TestRemat`` (vocab 23, d_model 16, 2 heads, 2 layers,
max_len 32, B4 S10, ``SGD(lr=0.1)``) from numpy-seeded weights, 3
graphed steps: with ``remat=True`` its losses and states equal the run
without, bitwise (the recompute runs the same CPU ops on the same
values), and the JAX package's remat run within rtol 1e-5 (losses) and
1e-5 of each state's norm (the order of f32 sums, as
``tests/test_torch_transformer.py``). Each block's attention runs once
more per step (the backward reruns the block). The JAX package's rules
hold: the first call runs un-checkpointed (the parameters materialise),
a block with BatchNorm's running statistics raises ``ValueError``, a
block must return one Tensor.

A block with ``layer.Dropout`` (rate 0.5), rematerialised, gives the
un-rematerialised block's output and gradients bitwise from the same
device-generator seed: the recompute reads the forward's recorded masks
(as the JAX package hands its recompute the forward's key) and draws
nothing, so the generator ends where the plain run's does.
"""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtransformer

from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer as ttransformer
from singa_tpu_torch.ops import attention as TA

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

VOCAB, STEPS = 23, 3
KW = dict(d_model=16, n_heads=2, n_layers=2, max_len=32, tp=False)
LOSS_RTOL, STATE_TOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    TCTX.training = False


def _data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (4, 10)).astype(np.float32)
    return ids, np.roll(ids, -1, 1)


def _seeded(states, seed=13):
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in sorted((k, tuple(v.shape)) for k, v in states.items()):
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            v = rng.randn(*shape) * np.sqrt(1.0 / shape[0])
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.randn(*shape) * 0.1
        out[k] = v.astype(np.float32)
    return out


def _port_run(remat, init=None):
    dev = tdevice.create_cpu_device()
    ids, tgt = _data()
    tx = ttensor.Tensor(data=ids, device=dev)
    ty = ttensor.Tensor(data=tgt, device=dev)
    m = ttransformer.TransformerLM(VOCAB, remat=remat, **KW)
    m.set_optimizer(topt.SGD(lr=0.1))
    m.compile([tx], is_train=True, use_graph=True)
    init = init or _seeded(m.get_states())
    load_numpy_states(m, init)
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(STEPS)]
    return losses, m, init


@pytest.fixture(scope="module")
def runs():
    base, mb, init = _port_run(False)
    rem, mr, _ = _port_run(True, init)
    return dict(base=base, rem=rem, mb=mb, mr=mr, init=init)


def test_remat_equals_the_stored_activation_run(runs):
    assert runs["rem"] == runs["base"]
    assert runs["rem"][-1] < runs["rem"][0]
    sb, sr = runs["mb"].get_states(), runs["mr"].get_states()
    for k in sb:
        assert torch.equal(sr[k].data, sb[k].data), k


def test_remat_matches_the_jax_packages_remat_run(runs):
    dev = jdevice.create_cpu_device()
    ids, tgt = _data()
    tx = jtensor.Tensor(data=ids, device=dev, requires_grad=False)
    ty = jtensor.Tensor(data=tgt, device=dev, requires_grad=False)
    m = jtransformer.TransformerLM(VOCAB, remat=True, **KW)
    m.set_optimizer(jopt.SGD(lr=0.1))
    m.compile([tx], is_train=True, use_graph=True)
    live = m.get_states()
    for k, v in runs["init"].items():
        live[k].copy_from_numpy(v)
    losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
    np.testing.assert_allclose(runs["rem"], losses, rtol=LOSS_RTOL)
    for k, v in m.get_states().items():
        want = np.asarray(v.data)
        got = runs["mr"].get_states()[k].to_numpy()
        assert np.linalg.norm(got - want) <= \
            STATE_TOL * np.linalg.norm(want) + 1e-7, k


def test_the_backward_reruns_each_block(monkeypatch):
    """K3 (here its plain version) runs once per block in a step without
    remat, twice with it: the recompute of each block."""
    calls = []
    plain = TA._scan_flash_fwd

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(TA, "_scan_flash_fwd", counted)
    for remat, per_step in ((False, 2), (True, 4)):
        _, m, _ = _port_run(remat)
        dev = m.dev
        ids, tgt = _data()
        calls.clear()
        m(ttensor.Tensor(data=ids, device=dev),
          ttensor.Tensor(data=tgt, device=dev))
        assert len(calls) == per_step, (remat, len(calls))


class _BNBlock(tlayer.Layer):
    def __init__(self):
        super().__init__()
        self.c = tlayer.Conv2d(4, 3, padding=1)
        self.bn = tlayer.BatchNorm2d()

    def forward(self, x):
        return self.bn(self.c(x))


class _TwoOut(tlayer.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tlayer.Linear(4)

    def forward(self, x):
        y = self.fc(x)
        return y, y


def test_checkpoint_keeps_the_jax_packages_rules():
    dev = tdevice.create_cpu_device()
    rng = np.random.RandomState(0)
    x = ttensor.Tensor(data=rng.randn(2, 3, 8, 8).astype(np.float32),
                       device=dev)
    b = _BNBlock()
    b(x)
    TCTX.training = True
    with pytest.raises(ValueError, match="running stat"):
        tag.checkpoint(b, x)
    x2 = ttensor.Tensor(data=rng.randn(2, 5).astype(np.float32), device=dev)
    two = _TwoOut()
    assert isinstance(tag.checkpoint(two, x2), tuple)   # first call: plain
    with pytest.raises(TypeError, match="single-Tensor"):
        tag.checkpoint(two, x2)
    with pytest.raises(TypeError, match="Layer"):
        tag.checkpoint(lambda t: t, x2)


class _DropBlock(tlayer.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tlayer.Linear(32)
        self.drop = tlayer.Dropout(0.5)
        self.fc2 = tlayer.Linear(8)

    def forward(self, x):
        return self.fc2(self.drop(tag.relu(self.fc1(x))))


def _drop_run(remat, init):
    dev = tdevice.create_cpu_device()
    x = ttensor.Tensor(data=np.random.RandomState(1).randn(6, 16).astype(
        np.float32), device=dev)
    blk = _DropBlock()
    blk(x)                                   # materialise (eval: no drop)
    for k, t in blk.get_params().items():
        t.copy_from_numpy(init[k])
    dev.SetRandSeed(21)
    TCTX.training = True
    leaf = x.data.clone().requires_grad_()
    xin = ttensor.Tensor(data=leaf, device=dev)
    y = tag.checkpoint(blk, xin) if remat else blk(xin)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    params = list(blk.get_params().values())
    grads = torch.autograd.grad(y.data, [leaf] + [p.data for p in params],
                                g)
    TCTX.training = False
    plain = blk(xin).data
    return y.data.detach(), grads, dev.generator.get_state(), plain


def test_a_rematerialised_dropout_block_keeps_its_masks():
    blk = _DropBlock()
    blk(ttensor.Tensor(data=np.zeros((6, 16), np.float32),
                       device=tdevice.create_cpu_device()))
    init = _seeded(blk.get_params(), seed=3)
    y0, g0, s0, plain = _drop_run(False, init)
    y1, g1, s1, _ = _drop_run(True, init)
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert torch.equal(s0, s1)
    # the masks really drop: training differs from the eval forward
    assert not torch.equal(y0, plain)
