"""Graph mode on the card (``singa_tpu_torch/graph.py``): a captured train
step replays bitwise against the eager one (fused SGD, and fused Adam on
a decaying lr, whose lr and bias corrections move inside the replay), a
capture error raises in place of running eagerly, and the device's
generator advances at every replay.

Marked ``cuda``: CUDA graphs exist only on the card, so each case skips
with a reason where ``torch.cuda.is_available()`` is false. This file
imports only torch and the port, so it runs on a GPU machine without JAX
(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda_graphs.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import device, layer, model, opt, tensor
from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.graph import StepGraph


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")


@pytest.fixture
def deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev
    CTX.training = False


class ConvBN(model.Model):
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


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 3, 6, 6).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)])
            for _ in range(n)]


def _states(m):
    d = {k: t.data.detach().clone() for k, t in m.get_states().items()}
    d.update({f"optimizer/{k}": t.data.clone()
              for k, t in m.optimizer.state_tensor_dict().items()})
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "bf16_mixed"])
def test_a_captured_step_replays_bitwise_with_eager(deterministic, policy):
    """6 steps of fused SGD (K1's multi-tensor launch inside the graph;
    under bf16_mixed with the guard, step 4 poisoned) in graph mode and
    eagerly from the same start: losses and every state bitwise, one
    capture, five replays."""
    _need_card()
    dev = device.create_cuda_gpu(0)
    batches = _batches(6)
    runs = []
    start = None
    for use_graph in (True, False):
        m = ConvBN()
        m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9, fused=True))
        m.compile([tensor.Tensor(data=batches[0][0], device=dev)],
                  is_train=True, use_graph=use_graph, policy=policy)
        if start is None:
            start = {k: v.to_numpy().copy()
                     for k, v in m.get_states().items()}
        model.load_numpy_states(m, start)
        losses = []
        for i, (x, y) in enumerate(batches, 1):
            if policy and i == 4:
                x = x.copy()
                x.flat[0] = np.nan
            _, loss = m(tensor.Tensor(data=x, device=dev),
                        tensor.Tensor(data=y, device=dev))
            losses.append(loss.data.detach())
        runs.append((m, torch.stack(losses), _states(m)))
    (m, losses, states), (_, e_losses, e_states) = runs
    assert torch.equal(losses.isnan(), e_losses.isnan())
    assert torch.equal(losses.nan_to_num(), e_losses.nan_to_num())
    assert sorted(states) == sorted(e_states)
    for k in states:
        assert torch.equal(states[k], e_states[k]), k
    assert list(m.graph_stats().values()) == [
        {"n_captures": 1, "n_replays": 5}]
    if policy:
        assert m.optimizer.stats()["skipped_total"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "bf16_mixed"])
def test_a_captured_adam_step_on_an_lr_schedule_replays_bitwise(
        deterministic, policy):
    """6 steps of fused Adam (K5's multi-tensor launch inside the graph)
    on an exponentially decaying lr, in graph mode and eagerly from the
    same start: the lr and Adam's bias corrections move inside the
    replayed step, so the losses, the lr read after each step and every
    state agree bitwise; under bf16_mixed with the guard, step 4
    poisoned."""
    _need_card()
    dev = device.create_cuda_gpu(0)
    batches = _batches(6, seed=1)
    runs = []
    start = None
    for use_graph in (True, False):
        m = ConvBN()
        m.set_optimizer(opt.Adam(
            lr=opt.ExponentialDecay(0.01, decay_steps=1, decay_rate=0.5),
            fused=True))
        m.compile([tensor.Tensor(data=batches[0][0], device=dev)],
                  is_train=True, use_graph=use_graph, policy=policy)
        if start is None:
            start = {k: v.to_numpy().copy()
                     for k, v in m.get_states().items()}
        model.load_numpy_states(m, start)
        losses, lrs = [], []
        for i, (x, y) in enumerate(batches, 1):
            if policy and i == 4:
                x = x.copy()
                x.flat[0] = np.nan
            _, loss = m(tensor.Tensor(data=x, device=dev),
                        tensor.Tensor(data=y, device=dev))
            losses.append(loss.data.detach())
            lrs.append(m.optimizer.lr_value.clone())
        runs.append((m, torch.stack(losses), torch.stack(lrs), _states(m)))
    (m, losses, lrs, states), (_, e_losses, e_lrs, e_states) = runs
    assert torch.equal(losses.isnan(), e_losses.isnan())
    assert torch.equal(losses.nan_to_num(), e_losses.nan_to_num())
    assert torch.equal(lrs, e_lrs)
    assert len(set(lrs.tolist())) == (5 if policy else 6)
    assert sorted(states) == sorted(e_states)
    for k in states:
        assert torch.equal(states[k], e_states[k]), k
    assert list(m.graph_stats().values()) == [
        {"n_captures": 1, "n_replays": 5}]
    if policy:
        assert m.optimizer.stats()["skipped_total"] == 1


@pytest.mark.cuda
def test_the_device_generator_advances_at_every_replay():
    """A step that draws from the device's generator: each replay draws
    anew, the numbers eager calls draw from the same seed, and the
    generator's offset moves on the host."""
    _need_card()
    dev = device.create_cuda_gpu(0)

    def fn(x):
        return (x + torch.rand(x.shape, generator=dev.generator,
                               device=x.device),)
    g = StepGraph(fn, dev)
    x = torch.zeros(4096, device="cuda")
    dev.SetRandSeed(3)
    got = []
    for _ in range(5):
        got.append(g(x)[0])
        if len(got) == 3:
            offset = dev.generator.get_offset()
    assert dev.generator.get_offset() > offset
    assert g.stats() == {"n_captures": 1, "n_replays": 4}
    dev.SetRandSeed(3)
    want = [torch.rand(4096, generator=dev.generator, device="cuda")
            for _ in range(5)]
    assert len({tuple(t[:8].tolist()) for t in got}) == 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_capture_error_raises_and_nothing_runs_eagerly():
    """A step that reads a value back to the host cannot be captured: the
    call raises, no replay or eager run stands in for it, and the
    generators and the memory pool the capture used are usable again."""
    _need_card()
    dev = device.create_cuda_gpu(0)
    calls = []

    def fn(x):
        calls.append(len(calls))
        y = x * 2
        if len(calls) == 2:
            float(y.sum())          # a host sync, illegal while capturing
        return (y,)
    g = StepGraph(fn, dev)
    pool = g.pool
    x = torch.ones(16, device="cuda")
    (first,) = g(x)
    with pytest.raises(RuntimeError):
        g(x)
    assert calls == [0, 1]
    assert g.stats() == {"n_captures": 0, "n_replays": 0}
    torch.cuda.synchronize()
    assert first.tolist() == [2.0] * 16
    # the generators the failed capture registered draw eagerly again,
    # and the pool takes a capture again
    torch.rand(4, generator=dev.generator, device="cuda")
    torch.rand(4, device="cuda")
    (again,) = g(x)
    assert g.pool != pool
    assert again.tolist() == [2.0] * 16
    assert g.stats() == {"n_captures": 1, "n_replays": 1}


@pytest.mark.cuda
def test_a_dropped_model_is_not_freed_inside_a_capture(deterministic):
    """A model and its captured steps hold each other, so a dropped model's
    CUDA graphs wait for the cyclic collector; freeing one inside another
    model's capture would invalidate that capture. A captured model is
    dropped just before another one captures a step that runs the
    collector: the capture holds and replays."""
    import gc

    class Collecting(ConvBN):
        def train_one_batch(self, x, y):
            gc.collect()        # where the collector may run on its own
            return super().train_one_batch(x, y)

    _need_card()
    dev = device.create_cuda_gpu(0)
    (x, y), = _batches(1)
    tx, ty = tensor.Tensor(data=x, device=dev), \
        tensor.Tensor(data=y, device=dev)

    def compiled(cls):
        m = cls()
        m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9, fused=True))
        m.compile([tx], is_train=True, use_graph=True)
        return m

    dropped, m = compiled(ConvBN), compiled(Collecting)
    for _ in range(2):
        dropped(tx, ty)         # eager, then captured
    m(tx, ty)                   # eager: the next call captures
    collecting = gc.isenabled()
    gc.disable()                # nothing frees the dropped one before
    try:
        del dropped             # only a cycle holds its graph now
        m(tx, ty)
        m(tx, ty)
    finally:
        if collecting:
            gc.enable()
    assert list(m.graph_stats().values()) == [
        {"n_captures": 1, "n_replays": 2}]
