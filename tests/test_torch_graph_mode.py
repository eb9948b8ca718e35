"""Graph mode in the port (``Model.compile(use_graph=True)``,
``singa_tpu_torch/graph.py``) on the CPU, where a ``StepGraph`` keeps the
books of a CUDA graph (signature cache, static buffers, the eager first
call, clone-out, invalidation) and runs the step on its static buffers
where the card would replay.

- Graph mode against eager mode in the port, bitwise, over 4 steps on a
  new batch each step: a ResNet(Bottleneck, [1, 1, 1, 1]) at 224 px,
  batch 2, f32 with fused SGD and with fused Adam, and under
  ``bf16_mixed`` with the guard and step 3 poisoned; the small LM of
  ``test_torch_transformer.py`` (fused SGD, the fused CE head).
- The graphed port against the JAX package's compiled step is
  ``test_torch_graph_jax.py``, a file of its own because the JAX
  package's compiles take most of its time.
- What replay needs and the CPU can check: from step 2 on every state
  keeps its storage and no state appears after step 1; outputs are
  clones, not the static buffers; one entry per input signature, each
  captured once, a warning at the 9th; ``set_optimizer``, a re-compile
  under another policy, ``eval()``/``train()`` and a load that makes a
  new optimizer state drop the graphs, a load into existing states does
  not.
- The graphed ``BatchServingEngine`` serves the new weights after
  ``load_states``, as an engine built after the load does.
"""

import numpy as np
import pytest
import torch


from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.graph import StepGraph
from singa_tpu_torch.models import resnet as tresnet
from singa_tpu_torch.models import transformer as ttransformer

STEPS = 4
POISON_STEP = 3
IMG = (3, 224, 224)
BATCH = 2
LM = dict(vocab=64, d_model=32, layers=2, heads=2, batch=2, seq=32)


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    TCTX.training = False


def _seeded(names_shapes, seed=11):
    """numpy weights for every state: fan-in-scaled W, BN scale and
    running variance around 1, the rest small."""
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
            v = rng.randn(*shape) * 0.1
        out[k] = v.astype(np.float32)
    return out


def _resnet_batches(n, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, *IMG).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.randint(0, 10, BATCH)])
            for _ in range(n)]


def _lm_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, LM["vocab"], (LM["batch"], LM["seq"])) \
            .astype(np.float32)
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


def _lm_kw():
    return dict(d_model=LM["d_model"], n_heads=LM["heads"],
                n_layers=LM["layers"], max_len=LM["seq"], tp=False,
                fused_head_chunk=16)


def _port(net, optimizer, use_graph, policy=None):
    """A port model on the CPU with the seeded states."""
    dev = tdevice.create_cpu_device()
    if net == "lm":
        m = ttransformer.TransformerLM(LM["vocab"], **_lm_kw())
        x = _lm_batches(1)[0][0]
    else:
        m = tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1])
        x = _resnet_batches(1)[0][0]
    m.set_optimizer(optimizer)
    m.compile([ttensor.Tensor(data=x, device=dev)], is_train=True,
              use_graph=use_graph, policy=policy)
    tmodel.load_numpy_states(m, _seeded(sorted(
        (k, tuple(v.shape)) for k, v in m.get_states().items())))
    return m, dev


def _states(m):
    """Copies of every model and optimizer state, by name."""
    d = {k: v.data.detach().clone() for k, v in m.get_states().items()}
    d.update({f"optimizer/{k}": v.data.clone()
              for k, v in m.optimizer.state_tensor_dict().items()})
    return d


def _storages(m):
    d = {k: v.data.untyped_storage().data_ptr()
         for k, v in m.get_states().items()}
    d.update({f"optimizer/{k}": v.data.untyped_storage().data_ptr()
              for k, v in m.optimizer.state_tensor_dict().items()})
    return d


def _run(m, dev, batches, poison_at=None):
    """One train call per batch; the outputs and the states after each
    call, and each state's storage after each call."""
    outs, states, ptrs = [], [], []
    for i, (x, y) in enumerate(batches, 1):
        if i == poison_at:
            x = x.copy()
            x.flat[0] = np.nan
        out, loss = m(ttensor.Tensor(data=x, device=dev),
                      ttensor.Tensor(data=y, device=dev))
        outs.append((out, loss))
        states.append(_states(m))
        ptrs.append(_storages(m))
    return outs, states, ptrs


CASES = {
    "resnet-sgd": ("resnet", lambda: topt.SGD(
        lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True), None),
    "resnet-adam": ("resnet", lambda: topt.Adam(lr=1e-3, fused=True), None),
    "resnet-bf16-guarded": ("resnet", lambda: topt.SGD(
        lr=0.002, momentum=0.9, weight_decay=1e-4, fused=True),
        "bf16_mixed"),
    "lm-sgd": ("lm", lambda: topt.SGD(lr=0.1, momentum=0.9, fused=True),
               None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_mode_is_bitwise_eager_mode(case):
    """4 steps in graph mode and eagerly from the same start on the same
    batches: the outputs, losses and every state bitwise after each step;
    under bf16_mixed step 3 is poisoned and changes no state but the
    guard's. From step 2 on every state keeps its storage, and no state
    appears after step 1. Each output is a clone: step 2's loss is
    unchanged after step 3, and no output shares storage with a static
    buffer."""
    net, make, policy = CASES[case]
    batches = _resnet_batches(STEPS) if net == "resnet" \
        else _lm_batches(STEPS)
    poison = POISON_STEP if policy else None
    runs = {}
    for use_graph in (True, False):
        m, dev = _port(net, make(), use_graph, policy)
        runs[use_graph] = (m,) + _run(m, dev, batches, poison)
    m, outs, states, ptrs = runs[True]
    _, e_outs, e_states, _ = runs[False]
    for i in range(STEPS):
        for got, want in zip(outs[i], e_outs[i]):
            torch.testing.assert_close(got.data, want.data.detach(),
                                       rtol=0, atol=0, equal_nan=True)
        assert sorted(states[i]) == sorted(e_states[i])
        for k in states[i]:
            torch.testing.assert_close(states[i][k], e_states[i][k],
                                       rtol=0, atol=0, equal_nan=True,
                                       msg=f"step {i + 1}: {k}")
    (g,) = m._graphs.values()
    assert g.stats() == {"n_captures": 1, "n_replays": STEPS - 1}
    # the preconditions of a replay
    assert sorted(states[0]) == sorted(states[-1])
    for later in ptrs[2:]:
        assert later == ptrs[1]
    loss2 = outs[1][1].data.clone()
    m(*[ttensor.Tensor(data=a, device=dev) for a in batches[0]])
    torch.testing.assert_close(outs[1][1].data, loss2, rtol=0, atol=0)
    static = {t.untyped_storage().data_ptr() for t in g._outs}
    for out in outs[1:]:
        for t in out:
            assert t.data.untyped_storage().data_ptr() not in static
    if policy:
        before, after = states[POISON_STEP - 2], states[POISON_STEP - 1]
        moved = [k for k in before if not k.startswith(
            ("optimizer/loss_scale", "optimizer/guard/"))
            and not torch.equal(before[k], after[k])]
        assert not moved, moved
        stats = m.optimizer.stats()
        assert stats["skipped_total"] == 1 and stats["loss_scale"] == 0.5


class _ConvBN(tmodel.Model):
    def __init__(self):
        super().__init__()
        self.conv = tlayer.Conv2d(4, 3, padding=1)
        self.bn = tlayer.BatchNorm2d()
        self.relu = tlayer.ReLU()
        self.flat = tlayer.Flatten()
        self.fc = tlayer.Linear(3)
        self.loss_fn = tlayer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self.optimizer(loss)
        return out, loss


def _convbn(optimizer=None, policy=None):
    dev = tdevice.create_cpu_device()
    dev.SetRandSeed(7)
    m = _ConvBN()
    m.set_optimizer(optimizer or topt.SGD(lr=0.05, momentum=0.9,
                                          fused=True))
    m.compile([ttensor.Tensor(data=np.zeros((4, 2, 5, 5), np.float32),
                              device=dev)],
              is_train=True, use_graph=True, policy=policy)
    return m, dev


def _step(m, dev, n=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2, 5, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return m(ttensor.Tensor(data=x, device=dev),
             ttensor.Tensor(data=y, device=dev))


def _captures(m):
    return sorted(s["n_captures"] for s in m.graph_stats().values())


def test_each_input_signature_is_captured_once_and_the_ninth_warns():
    """A short last batch is a second signature: each is captured once,
    however often it runs. A 9th signature warns."""
    m, dev = _convbn()
    for _ in range(3):
        _step(m, dev, 4)
        _step(m, dev, 3)
    assert len(m.graph_stats()) == 2
    assert [s for s in m.graph_stats().values()] == [
        {"n_captures": 1, "n_replays": 2}] * 2
    for n in range(5, 11):
        _step(m, dev, n)
    assert len(m.graph_stats()) == 8
    with pytest.warns(UserWarning, match="9th distinct input signature"):
        _step(m, dev, 1)
    assert len(m.graph_stats()) == 9


def test_what_the_graphs_baked_in_drops_them():
    """``set_optimizer``, a re-compile under another policy,
    ``eval()``/``train()`` and a load that makes a new optimizer state
    drop the graphs; the next two calls capture anew. A load into
    existing states keeps them."""
    m, dev = _convbn()
    for _ in range(2):
        _step(m, dev)
    assert _captures(m) == [1]

    def recaptured():
        assert m.graph_stats() == {}
        _step(m, dev)
        _step(m, dev)
        return _captures(m) == [1]

    states = {f"optimizer/{k}": v for k, v in
              m.optimizer.get_states().items()}
    states.update({k: v.to_numpy().copy()
                   for k, v in m.get_states().items()})
    tmodel.load_numpy_states(m, states)
    assert _captures(m) == [1]
    m.set_optimizer(topt.SGD(lr=0.05, momentum=0.9, fused=True))
    assert recaptured()
    m.eval()
    m.train()
    assert recaptured()
    m.train()                          # no flip: the graphs stay
    assert _captures(m) == [1]
    m.compile([ttensor.Tensor(data=np.zeros((4, 2, 5, 5), np.float32),
                              device=dev)], is_train=True, use_graph=True,
              policy="bf16_mixed")
    assert recaptured()
    fresh = topt.SGD(lr=0.05, momentum=0.9, fused=True)
    m.set_optimizer(fresh)
    _step(m, dev)
    _step(m, dev)
    new = {"optimizer/ConvBN.extra:momentum": np.zeros(3, np.float32)}
    tmodel.load_numpy_states(m, new, strict=False)
    assert m.graph_stats() == {}
    m.graph(False)
    _step(m, dev)
    assert m.graph_stats() == {}


def test_the_lr_schedule_and_adam_bias_corrections_move_in_the_graph():
    """The lr and Adam's bias corrections are recomputed by every step,
    captured or not (``Optimizer._per_step``): a host read of the lr after
    a step sees the next step's value, as eagerly."""
    sched = topt.ExponentialDecay(0.1, decay_steps=1, decay_rate=0.5)
    runs = {}
    for use_graph in (True, False):
        m, dev = _convbn(topt.Adam(lr=sched, fused=True))
        m.graph(use_graph)
        lrs = []
        for _ in range(4):
            _step(m, dev)
            lrs.append(float(m.optimizer.lr_value))
        runs[use_graph] = (lrs, _states(m))
    assert runs[True][0] == runs[False][0]
    np.testing.assert_allclose(runs[True][0], [0.05, 0.025, 0.0125,
                                               0.00625], rtol=1e-6)
    for k, v in runs[True][1].items():
        torch.testing.assert_close(v, runs[False][1][k], rtol=0, atol=0)


def test_a_step_graph_keeps_its_books_on_the_cpu():
    """The StepGraph alone: call 1 eager on the caller's tensors, call 2
    the capture on static buffers, then replays; clones out."""
    seen = []

    def fn(x):
        seen.append(x.data_ptr())
        return (x * 2,)
    g = StepGraph(fn, tdevice.create_cpu_device())
    a = torch.ones(3)
    (out,) = g(a)
    assert seen == [a.data_ptr()] and g.stats() == {"n_captures": 0,
                                                    "n_replays": 0}
    (out2,) = g(a + 1)
    (out3,) = g(a + 2)
    assert len(set(seen[1:])) == 1 and seen[1] != a.data_ptr()
    assert g.stats() == {"n_captures": 1, "n_replays": 2}
    assert out2.tolist() == [4.0] * 3 and out3.tolist() == [6.0] * 3


def test_the_graphed_engine_serves_weights_loaded_after_it_was_built(
        tmp_path):
    """A ResNet engine (graph mode, batch 2) built, then the model's
    states loaded from a zip of other weights: the next ticks serve the
    new weights, bitwise with an engine built after the load, and the
    engine captures anew."""
    from singa_tpu_torch.observability.metrics import Registry
    dev = tdevice.create_cpu_device()
    m = tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1])
    m.eval()

    def engine():
        return m.compile_serving(input_shape=IMG, batch=BATCH, device=dev,
                                 registry=Registry())

    def serve(eng, xs):
        futs = [eng.submit(x) for x in xs]
        eng.run_until_idle()
        return np.stack([f.result() for f in futs])

    eng = engine()
    names = sorted((k, tuple(v.shape)) for k, v in m.get_states().items())
    tmodel.load_numpy_states(m, _seeded(names, seed=2))
    path = tmp_path / "other.zip"
    m.save_states(str(path))
    tmodel.load_numpy_states(m, _seeded(names, seed=1))
    xs = _resnet_batches(1)[0][0]
    # the load moved the states: eager, a fresh capture, a replay
    before = [serve(eng, xs) for _ in range(3)]
    assert eng.graph_stats() == {"n_captures": 1, "n_replays": 2}
    for b in before[1:]:
        np.testing.assert_array_equal(b, before[0])
    m.load_states(str(path))
    got = [serve(eng, xs) for _ in range(3)]
    assert eng.graph_stats() == {"n_captures": 1, "n_replays": 2}
    want = serve(engine(), xs)
    assert not np.allclose(got[0], before[0])
    for g in got:
        np.testing.assert_array_equal(g, want)
