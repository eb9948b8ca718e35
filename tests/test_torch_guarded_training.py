"""``bf16_mixed`` training in the port -- ``Model.compile(policy=
"bf16_mixed", is_train=True)`` with the optimizer wrapped in
``singa_tpu_torch.resilience.GuardedOptimizer`` -- held against the JAX
package on the CPU, where each optimizer kernel's plain version stands in.

- The policy's contract, as ``tests/test_mixed_precision.py:153-359``
  pins it for the JAX package: f32 masters and optimizer states, f32
  outputs, the guard wrapped by default (never twice, not under float32,
  also after ``set_optimizer``, taken off by a ``loss_scaling=False``
  re-compile, re-made with its own scale on a policy change), masters
  migrated by a re-compile across a param dtype.
- Training against the JAX package on the same numpy weights and batches
  (the JAX side compiled, ``use_graph=True``, with its plain optimizer
  chain), 3 steps, of the ConvBN net here and of a ResNet(Bottleneck,
  [1, 1, 1, 1]) in ``test_torch_guarded_resnet.py``. Both compute the
  convolutions and products in bf16 from f32 masters and round each op's
  result to bf16, at other places inside (oneDNN against XLA's CPU
  convolution). The first logits are held within ``LOGIT_TOL`` of the
  largest |logit| (measured: ConvBN
  3.5e-3; ResNet 6.0e-3 against the JAX package's op-by-op forward, which
  rounds where the port does, and 1.3e-2 against its compiled step, which
  drops some bf16 round trips and itself differs from the op-by-op
  forward by 6.7e-3), the losses within ``LOSS_RTOL`` (measured 9.8e-4 /
  2.2e-3), every parameter and running statistic within ``STATE_TOL`` of
  its norm (``|got - want| <= tol * |want|``; measured 5.6e-3 / 2.4e-3).
  The momenta (the gradients' running sum) are held per net to
  ``MOMENTUM_TOL`` of their norm, floored at ``MOMENTUM_FLOOR`` of the
  net's largest momentum (a conv bias feeding a training BN has a zero
  gradient in exact arithmetic: its momentum is rounding noise in both
  packages). bf16 gradients through batch-statistic BNs are that far from
  reproducible: the port against itself, with the input moved by 1e-6 of
  its size, moves the ResNet's gradients by 20-29% per tensor (f32: 0.1%).
  Measured: ConvBN 5.3e-2, ResNet 0.42.
- The guard against ``tests/test_resilience.py:122-240`` without the
  trainer: a poisoned batch is a bitwise no-op on every state (the BN
  shadows restore the running statistics), the loss scale backs off and
  grows back every ``growth_interval`` good steps, and the loss scale,
  the streaks and ``skipped_total`` equal the JAX package's step by step,
  ``last_grad_norm`` within ``LOSS_RTOL``.
- The skip flag of the multi-tensor wrappers and their plain versions;
  checkpoints with the guard's keys both ways; the Transformer LM under
  the policy; ``examples/train_cnn.py -p bf16_mixed``.
"""

import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import mixed_precision as jmp
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu.models import transformer as jtransformer
from singa_tpu.ops import attention_mod as JA
from singa_tpu.resilience import GuardedOptimizer as JGuard

from singa_tpu_torch import autograd_base as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import mixed_precision as tmp
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.models import resnet as tresnet
from singa_tpu_torch.models import transformer as ttransformer
from singa_tpu_torch.ops import fused_optim as tfo
from singa_tpu_torch.resilience import GuardedOptimizer

LOGIT_TOL, LOSS_RTOL, STATE_TOL = 1e-2, 1e-2, 1e-2
# momenta after the steps, per net, against max(|want|, MOMENTUM_FLOOR x
# the net's largest momentum norm)
MOMENTUM_TOL = {"convbn": 0.15, "resnet": 0.6}
MOMENTUM_FLOOR = 5e-2
# the guard's counters, read back per step
COUNTERS = ("loss_scale", "bad_streak", "good_streak", "skipped_total")

_JAX = {}


@pytest.fixture(autouse=True)
def _train_mode_off():
    yield
    TCTX.training = False


# ---------------------------------------------------------------------------
# models, data and weights, the same in both packages
# ---------------------------------------------------------------------------

def _mlp(L, M):
    class MLP(M.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = L.Linear(16)
            self.relu = L.ReLU()
            self.fc2 = L.Linear(4)
            self.loss_fn = L.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss
    return MLP()


def _convbn(L, M):
    class ConvBN(M.Model):
        def __init__(self):
            super().__init__()
            self.conv = L.Conv2d(8, 3, padding=1)
            self.bn = L.BatchNorm2d()
            self.relu = L.ReLU()
            self.flat = L.Flatten()
            self.fc = L.Linear(4)
            self.loss_fn = L.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss
    return ConvBN()


def _resnet(L, M):
    pkg = jresnet if L is jlayer else tresnet
    return pkg.ResNet(pkg.Bottleneck, [1, 1, 1, 1])


NETS = {  # model maker, input shape, classes
    "mlp": (_mlp, (16, 8), 4),
    "convbn": (_convbn, (8, 3, 6, 6), 4),
    "resnet": (_resnet, (2, 3, 224, 224), 10),
}
# the SGD learning rate of each net's comparison: the ResNet's loss
# diverges from these weights at 0.05
LR = {"mlp": 0.05, "convbn": 0.05, "resnet": 0.002}


def _batches(net, n, seed=0):
    _, shape, classes = NETS[net]
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape).astype(np.float32),
             np.eye(classes, dtype=np.float32)[
                 rng.randint(0, classes, shape[0])]) for _ in range(n)]


def _seeded(model, seed=11):
    """numpy weights for every state: fan-in-scaled W, BN scale and
    running variance around 1, the rest small."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, t in sorted(model.get_states().items()):
        shape = tuple(t.shape)
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


class _Jax:
    """The JAX side: a model compiled with ``use_graph=True``."""
    layer, model = jlayer, jmodel

    def __init__(self):
        self.dev = jdevice.create_cpu_device()

    def t(self, a):
        return jtensor.Tensor(data=a, device=self.dev, requires_grad=False)

    def load(self, m, states):
        live = m.get_states()
        for k, v in states.items():
            live[k].copy_from_numpy(v)

    def step(self, m, x, y):
        out, loss = m(self.t(x), self.t(y))
        return np.asarray(out.data, np.float32), float(np.asarray(loss.data))

    def states(self, m):
        d = {k: np.asarray(v.data, np.float32)
             for k, v in m.get_states().items()}
        d.update({f"optimizer/{k}": np.asarray(v)
                  for k, v in m.optimizer.get_states().items()})
        return d

    def stats(self, m):
        return m.optimizer.stats() if hasattr(m.optimizer, "stats") else {}


class _Port(_Jax):
    layer, model = tlayer, tmodel

    def __init__(self):
        self.dev = tdevice.create_cpu_device()

    def t(self, a):
        return ttensor.Tensor(data=a, device=self.dev)

    def load(self, m, states):
        tmodel.load_numpy_states(m, states)

    def step(self, m, x, y):
        out, loss = m(self.t(x), self.t(y))
        return out.to_numpy(), float(loss.data.detach())

    def states(self, m):
        # copies: on the CPU to_numpy shares the live tensors' memory
        d = {k: v.to_numpy().copy() for k, v in m.get_states().items()}
        d.update({f"optimizer/{k}": np.array(v)
                  for k, v in m.optimizer.get_states().items()})
        return d


def _build(side, net, optimizer, policy="bf16_mixed", seed=11):
    make, shape, _ = NETS[net]
    m = make(side.layer, side.model)
    m.set_optimizer(optimizer)
    x = np.zeros(shape, np.float32)
    if isinstance(side, _Port):
        m.compile([side.t(x)], is_train=True, policy=policy)
    else:
        m.compile([side.t(x)], is_train=True, use_graph=True, policy=policy)
    side.load(m, _seeded(m, seed))
    return m


def _sgd(pkg, fused=True, lr=0.05):
    # the JAX side takes its plain chain: a guarded compiled step over
    # its fused interpret-mode kernel does not trace in the reference
    return pkg.SGD(lr=lr, momentum=0.9, weight_decay=1e-4,
                   fused=fused and pkg is topt)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    err = float(np.linalg.norm(got - want))
    assert err <= tol * float(np.linalg.norm(want)) + 1e-7, \
        f"{what}: |got - want| = {err:.3g}, |want| = " \
        f"{float(np.linalg.norm(want)):.3g}"


# ---------------------------------------------------------------------------
# the policy's contract, on the port
# ---------------------------------------------------------------------------

def test_policy_presets_and_equality():
    p = tmp.Policy("bf16_mixed")
    assert p.is_mixed and p.wants_loss_scaling
    assert p.default_loss_scale == jmp.Policy("bf16_mixed") \
        .default_loss_scale == 1.0
    f16 = tmp.Policy("float16_mixed")
    assert f16.default_loss_scale == jmp.Policy("float16_mixed") \
        .default_loss_scale == 2.0 ** 15
    f32 = tmp.Policy("float32")
    assert not f32.is_mixed and not f32.wants_loss_scaling
    pure = tmp.Policy("bf16")
    assert not pure.is_mixed and pure.wants_loss_scaling
    assert tmp.resolve("bf16_mixed") == p and hash(tmp.resolve(
        "bf16_mixed")) == hash(p)
    assert p != tmp.Policy("bf16_mixed", loss_scaling=False)
    assert not tmp.Policy("bf16_mixed", loss_scaling=False) \
        .wants_loss_scaling
    x32 = torch.ones(4)
    with tmp.policy_scope("bf16_mixed"):
        assert tmp.cast_compute(x32).dtype == torch.bfloat16
    assert tmp.accum_f32(x32.bfloat16()).dtype == torch.float32
    assert tmp.accum_f32(x32.half()).dtype == torch.float32
    assert tmp.accum_f32(x32) is x32


def test_masters_states_and_outputs_stay_f32_and_compute_is_bf16():
    side = _Port()
    m = _build(side, "convbn", _sgd(topt))
    assert isinstance(m.optimizer, GuardedOptimizer)
    (x, y), = _batches("convbn", 1)
    for _ in range(3):
        out, loss = m(side.t(x), side.t(y))
        assert out.dtype == loss.dtype == torch.float32
    for k, t in m.get_states().items():
        assert t.dtype == torch.float32, k
    for k, t in m.optimizer.state_tensor_dict().items():
        assert t.dtype == torch.float32, k
    assert "guard-shadow/ConvBN.bn.running_mean" in m.optimizer.get_states()
    m.eval()
    assert m(side.t(x)).dtype == torch.float32
    # the gradient of an f32 master through a bf16 compute cast comes
    # back in f32 (torch's cast backward, as the JAX transpose)
    m.train()
    TCTX.training = True
    with tmp.policy_scope(m._policy):
        logits = m.forward(side.t(x))
        assert logits.dtype == torch.bfloat16
        loss = m.loss_fn(logits, side.t(y))
    assert loss.dtype == torch.float32
    for p, g in tag.backward(loss):
        assert p.dtype == g.dtype == torch.float32, p.name
    # bf16 compute really ran: the f32 run from the same start differs
    f32 = _build(side, "convbn", _sgd(topt), policy=None)
    assert side.step(f32, x, y)[1] != side.step(
        _build(side, "convbn", _sgd(topt)), x, y)[1]


def test_the_guard_is_the_default_companion_and_never_doubled():
    side = _Port()
    m = _build(side, "mlp", _sgd(topt))
    assert isinstance(m.optimizer, GuardedOptimizer)
    assert m.optimizer.dynamic_loss_scale
    assert not isinstance(m.optimizer.inner, GuardedOptimizer)
    user = GuardedOptimizer(_sgd(topt), init_scale=8.0)
    m2 = _build(side, "mlp", user)
    assert m2.optimizer is user and m2.optimizer.stats()["loss_scale"] == 8
    for policy in ("float32", None):
        m3 = _build(side, "mlp", _sgd(topt), policy=policy)
        assert not isinstance(m3.optimizer, GuardedOptimizer)


def test_set_optimizer_after_compile_still_gets_loss_scaling():
    side = _Port()
    (x, y), = _batches("mlp", 1)
    m = _mlp(tlayer, tmodel)
    m.compile([side.t(x)], is_train=True, policy="bf16_mixed")
    m.set_optimizer(topt.SGD(lr=0.3, momentum=0.9))
    assert isinstance(m.optimizer, GuardedOptimizer)
    losses = [side.step(m, x, y)[1] for _ in range(10)]
    assert losses[-1] < losses[0], losses


def test_loss_scaling_opt_out_unwraps_only_the_companion():
    side = _Port()
    (x, y), = _batches("mlp", 1)
    m = _build(side, "mlp", _sgd(topt))
    inner = m.optimizer.inner
    m.compile([side.t(x)], is_train=True,
              policy=tmp.Policy("bf16_mixed", loss_scaling=False))
    assert m.optimizer is inner
    assert np.isfinite(side.step(m, x, y)[1])
    user = GuardedOptimizer(_sgd(topt))
    m2 = _build(side, "mlp", user,
                policy=tmp.Policy("bf16_mixed", loss_scaling=False))
    assert m2.optimizer is user


def test_a_policy_change_rederives_the_companion_scale():
    side = _Port()
    (x, _), = _batches("mlp", 1)
    m = _build(side, "mlp", _sgd(topt))
    assert m.optimizer.stats()["loss_scale"] == 1.0
    m.optimizer.loss_scale.data.fill_(4.0)
    m.compile([side.t(x)], is_train=True, policy="bf16_mixed")
    assert m.optimizer.stats()["loss_scale"] == 4.0     # same policy
    m.compile([side.t(x)], is_train=True, policy="float16_mixed")
    assert m.optimizer.stats()["loss_scale"] == 2.0 ** 15


@pytest.mark.parametrize("steps_first", [3, 0])
def test_a_recompile_across_param_dtype_migrates_masters(steps_first):
    side = _Port()
    (x, y), = _batches("mlp", 1)
    m = _build(side, "mlp", _sgd(topt), policy="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in m.get_states().values())
    for _ in range(steps_first):
        side.step(m, x, y)
    m.compile([side.t(x)], is_train=True, policy="bf16_mixed")
    for k, t in m.get_states().items():
        assert t.dtype == torch.float32, k
    for k, t in m.optimizer.state_tensor_dict().items():
        if ":" in k:
            assert t.dtype == torch.float32, k
    losses = [side.step(m, x, y)[1] for _ in range(8)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_float16_mixed_starts_at_2_15_and_trains():
    side = _Port()
    (x, y), = _batches("mlp", 1)
    m = _build(side, "mlp", _sgd(topt), policy="float16_mixed")
    assert m.optimizer.stats()["loss_scale"] == 2.0 ** 15
    losses = [side.step(m, x, y)[1] for _ in range(5)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert m.optimizer.stats()["skipped_total"] == 0
    assert all(t.dtype == torch.float32 for t in m.get_states().values())


# ---------------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------------

def _jax_guarded(net, steps, poison_at=None, **guard_kw):
    """The JAX package's guarded run, once per setting: outputs, losses,
    stats and states after each step, and the first step's logits of an
    eager forward (``eager``)."""
    key = (net, steps, poison_at, tuple(sorted(guard_kw.items())))
    if key not in _JAX:
        side = _Jax()
        opt = _sgd(jopt, lr=LR[net])
        m = _build(side, net, JGuard(opt, **guard_kw) if guard_kw else opt)
        eager = _jax_eager_logits(side, m, *_batches(net, 1)[0])
        side.load(m, _seeded(m))    # the eager forward moved the BN stats
        _JAX[key] = _run(side, m, net, steps, poison_at)
        _JAX[key]["eager"] = eager
    return _JAX[key]


def _jax_eager_logits(side, m, x, y):
    """The JAX package's training-mode logits op by op: every op rounds
    its result to bf16, as the port's do. The compiled step's XLA program
    drops some f32 -> bf16 -> f32 round trips; on the ResNet its first
    logits differ from these by 6.7e-3 of the largest."""
    from singa_tpu.autograd_base import CTX as JCTX
    prev, JCTX.training = JCTX.training, True
    try:
        with jmp.policy_scope(m._policy):
            return np.asarray(m.forward(side.t(x)).data, np.float32)
    finally:
        JCTX.training = prev


def _run(side, m, net, steps, poison_at=None):
    rec = {"outs": [], "losses": [], "stats": [], "states": []}
    for i, (x, y) in enumerate(_batches(net, steps), 1):
        if i == poison_at:
            x = x.copy()
            x.flat[0] = np.nan
        out, loss = side.step(m, x, y)
        rec["outs"].append(out)
        rec["losses"].append(loss)
        rec["stats"].append(side.stats(m))
        rec["states"].append(side.states(m))
    rec["model"], rec["side"] = m, side
    return rec


def test_bf16_mixed_training_matches_jax():
    """The ConvBN net (the ResNet: ``test_torch_guarded_resnet.py``)."""
    check_training_matches_jax("convbn")


def check_training_matches_jax(net):
    """3 steps: the first logits against the JAX package's, op by op
    (ResNet) or compiled (ConvBN, where the two agree), then the losses,
    the states and the guard's counters against its compiled run."""
    steps = 3
    want = _jax_guarded(net, steps)
    side = _Port()
    tfo.reset_counts()
    got = _run(side, _build(side, net, _sgd(topt, lr=LR[net])), net, steps)
    assert sum(tfo.launches.values()) == 0
    first = want["eager"] if net == "resnet" else want["outs"][0]
    scale = float(np.abs(first).max())
    err = float(np.abs(got["outs"][0] - first).max())
    assert err <= LOGIT_TOL * scale, (err, scale)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    mine, ref = got["states"][-1], want["states"][-1]
    assert sorted(mine) == sorted(ref)
    floor = MOMENTUM_FLOOR * max(float(np.linalg.norm(v))
                                 for k, v in ref.items() if ":" in k)
    for k, v in ref.items():
        if ":" in k:
            err = float(np.linalg.norm(mine[k] - v))
            assert err <= MOMENTUM_TOL[net] * max(
                float(np.linalg.norm(v)), floor), (k, err)
        else:
            _close(mine[k], v, STATE_TOL, k)
    for a, b in zip(got["stats"], want["stats"]):
        assert {k: a[k] for k in COUNTERS} == {k: b[k] for k in COUNTERS}


GUARD_KW = dict(init_scale=1024.0, growth_interval=2)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_a_poisoned_batch_is_a_noop_and_the_scale_moves_as_in_jax(fused):
    """Steps 1-6 of the ConvBN net, step 3 poisoned: step 3 changes no
    parameter, momentum, step counter, BN statistic or shadow; the scale
    doubles after steps 2 and 5 (growth_interval 2), halves at step 3;
    training goes on after."""
    want = _jax_guarded("convbn", 6, poison_at=3, **GUARD_KW)
    side = _Port()
    m = _build(side, "convbn", GuardedOptimizer(_sgd(topt, fused),
                                                **GUARD_KW))
    got = _run(side, m, "convbn", 6, poison_at=3)
    scales = [s["loss_scale"] for s in got["stats"]]
    assert scales == [1024.0, 2048.0, 1024.0, 1024.0, 2048.0, 2048.0]
    for a, b in zip(got["stats"], want["stats"]):
        assert {k: a[k] for k in COUNTERS} == {k: b[k] for k in COUNTERS}
        if np.isfinite(b["grad_norm"]):
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=LOSS_RTOL)
        else:
            assert not np.isfinite(a["grad_norm"])
    assert got["stats"][2]["skipped_total"] == 1
    before, after = got["states"][1], got["states"][2]
    moved = [k for k in before if k.split("/")[-1] not in
             ("loss_scale", "bad_streak", "good_streak", "skipped_total",
              "last_grad_norm") and not np.array_equal(before[k], after[k])]
    assert not moved, moved
    assert any("guard-shadow/" in k for k in before)
    assert any(not np.array_equal(got["states"][3][k], after[k])
               for k in after if "running_mean" in k)
    for k, v in got["states"][-1].items():
        assert np.all(np.isfinite(v)), k
    # five updates at lr 0.05, each from bf16 gradients: measured 1.1e-2
    _close(got["states"][-1]["ConvBN.conv.W"],
           want["states"][-1]["ConvBN.conv.W"], 3 * STATE_TOL, "conv.W")


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_a_bad_first_step_leaves_fresh_states_at_zero(kind, fused):
    """A poisoned first step: the aux states born in it stay at their zero
    init, the step counter at 0, the parameters as loaded."""
    side = _Port()
    inner = topt.SGD(lr=0.05, momentum=0.9, fused=fused) if kind == "sgd" \
        else topt.Adam(lr=1e-3, fused=fused)
    if not fused:
        inner.register("ConvBN.fc.W", regularizer=topt.Regularizer("l2",
                                                                  1e-3))
    m = _build(side, "convbn", inner)
    start = {k: v.to_numpy().copy() for k, v in m.get_states().items()}
    got = _run(side, m, "convbn", 1, poison_at=1)
    states = got["states"][0]
    for k, v in start.items():
        np.testing.assert_array_equal(states[k], v, err_msg=k)
    aux = [k for k in states if ":" in k]
    assert aux and all(not states[k].any() for k in aux), aux
    assert states["optimizer/step_counter"] == 0
    assert got["stats"][0]["skipped_total"] == 1


def test_the_guard_over_a_regularized_parameter_masks_it_too():
    """fc.W is regularized, so ``Optimizer.apply`` updates it alone (the
    plain chain) beside the multi-tensor call: a poisoned step leaves it
    and its momentum as they were."""
    side = _Port()
    inner = _sgd(topt)
    inner.register("ConvBN.fc.W", regularizer=topt.Regularizer("l2", 1e-3))
    m = _build(side, "convbn", inner)
    got = _run(side, m, "convbn", 3, poison_at=3)
    for k in ("ConvBN.fc.W", "optimizer/ConvBN.fc.W:momentum",
              "ConvBN.conv.W", "optimizer/ConvBN.conv.W:momentum"):
        np.testing.assert_array_equal(got["states"][2][k],
                                      got["states"][1][k], err_msg=k)
        assert not np.array_equal(got["states"][1][k], got["states"][0][k])


# ---------------------------------------------------------------------------
# the skip flag of the multi-tensor updates
# ---------------------------------------------------------------------------

MULTI = {
    "sgd": (1, lambda f, e, **k: f["sgd_momentum_update"](
        e, momentum=0.9, dampening=0.1, **k)),
    "adam": (2, lambda f, e, **k: f["adam_update"](
        e, torch.tensor(0.1), torch.tensor(0.01), beta_1=0.9, beta_2=0.999,
        epsilon=1e-8, **k)),
    "rmsprop": (1, lambda f, e, **k: f["rmsprop_update"](
        e, rho=0.9, epsilon=1e-8, **k)),
    "adagrad": (1, lambda f, e, **k: f["adagrad_update"](
        e, epsilon=1e-8, **k)),
}


def _multi_entries(n_states, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate([(4099,), (64,), (1,), (3, 3, 3, 5)] * 3):
        def t(pos=False):
            a = rng.randn(*shape).astype(np.float32)
            return torch.tensor(np.abs(a) if pos else a)
        out.append((t(), t(), *[t(pos=True) for _ in range(n_states)],
                    torch.tensor(0.01 * (1 + i % 2)), [0.0, 1e-4][i % 2]))
    return out


def _written(e, n_states):
    return (e[0], *e[2:2 + n_states])


@pytest.mark.parametrize("kind", sorted(MULTI))
@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
def test_the_multi_update_skips_on_the_flag(kind, plain):
    """ok = 1 is bitwise the update without a flag, ok = 0 writes
    nothing, for the wrapper (on the CPU: each entry through the
    per-tensor wrapper, then masked) and for its plain version."""
    n, call = MULTI[kind]
    fns = {name: getattr(tfo, f"{name}_multi" + ("_reference" if plain
                                                  else ""))
           for name in ("sgd_momentum_update", "adam_update",
                        "rmsprop_update", "adagrad_update")}
    base = _multi_entries(n)

    def clone():
        return [tuple(t.clone() if isinstance(t, torch.Tensor) and t.dim()
                      else t for t in e) for e in base]
    none, one, zero = clone(), clone(), clone()
    call(fns, none)
    call(fns, one, ok=torch.tensor(1.0))
    call(fns, zero, ok=torch.tensor(0.0))
    for a, b, c, e in zip(none, one, zero, base):
        for x, y, z, w in zip(_written(a, n), _written(b, n),
                              _written(c, n), _written(e, n)):
            assert torch.equal(x, y)
            assert torch.equal(z, w)
        assert not torch.equal(a[0], e[0])
    assert sum(tfo.launches.values()) == 0


def test_the_cpu_path_still_calls_each_per_tensor_wrapper(monkeypatch):
    calls = []
    real = tfo.sgd_momentum_update

    def spy(p, *a, **kw):
        calls.append(p)
        return real(p, *a, **kw)
    monkeypatch.setattr(tfo, "sgd_momentum_update", spy)
    entries = _multi_entries(1)
    tfo.sgd_momentum_update_multi(entries, momentum=0.9,
                                  ok=torch.tensor(0.0))
    assert [id(p) for p in calls] == [id(e[0]) for e in entries]


# ---------------------------------------------------------------------------
# checkpoints with the guard's keys, both ways
# ---------------------------------------------------------------------------

def test_a_jax_guarded_checkpoint_resumes_in_the_port(tmp_path):
    """Steps 1-4 in JAX (step 2 poisoned: the scale backed off, one skip),
    saved; the port loads it and takes step 5, as JAX does."""
    side = _Jax()
    jm = _build(side, "convbn", JGuard(_sgd(jopt), **GUARD_KW))
    _run(side, jm, "convbn", 4, poison_at=2)
    path = tmp_path / "jax.zip"
    jm.save_states(str(path))
    x, y = _batches("convbn", 5)[-1]
    _, want = side.step(jm, x, y)
    want_stats = jm.optimizer.stats()

    port = _Port()
    m = _build(port, "convbn", GuardedOptimizer(_sgd(topt), **GUARD_KW))
    m.load_states(str(path))
    states = m.optimizer.get_states()
    assert states["guard/skipped_total"] == 1
    assert "guard-shadow/ConvBN.bn.running_var" in states
    _, got = port.step(m, x, y)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert {k: m.optimizer.stats()[k] for k in COUNTERS} == \
        {k: want_stats[k] for k in COUNTERS}


def test_a_port_guarded_checkpoint_resumes_in_jax(tmp_path):
    port = _Port()
    m = _build(port, "convbn", GuardedOptimizer(_sgd(topt), **GUARD_KW))
    _run(port, m, "convbn", 4, poison_at=2)
    path = tmp_path / "port.zip"
    m.save_states(str(path))
    x, y = _batches("convbn", 5)[-1]
    _, want = port.step(m, x, y)
    want_stats = m.optimizer.stats()

    side = _Jax()
    jm = _build(side, "convbn", JGuard(_sgd(jopt), **GUARD_KW))
    jm.load_states(str(path))
    assert jm.optimizer.stats()["skipped_total"] == 1
    _, got = side.step(jm, x, y)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert {k: jm.optimizer.stats()[k] for k in COUNTERS} == \
        {k: want_stats[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# the Transformer LM under the policy
# ---------------------------------------------------------------------------

LM = dict(d_model=32, n_heads=2, n_layers=2, max_len=32, tp=False,
          fused_head_chunk=24)


def test_the_lm_under_bf16_mixed_matches_jax():
    """A small TransformerLM (vocab 64, B2 S32), 2 guarded SGD steps in
    each package, attention through K3/K4's plain versions here and the
    Pallas kernels in interpret mode there: losses within LOSS_RTOL
    (measured 1.4e-4), parameters within STATE_TOL (5.9e-4). The momenta
    are not held: the k-projection biases have a zero gradient in exact
    arithmetic (softmax ignores a shift common to a row), so theirs are
    rounding noise."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (2, 32)).astype(np.float32)
    tgt = np.roll(ids, -1, axis=1)
    runs = []
    prev = JA.FORCE_PALLAS_INTERPRET
    JA.FORCE_PALLAS_INTERPRET = True
    try:
        for side, pkg, opt in ((_Jax(), jtransformer, jopt),
                               (_Port(), ttransformer, topt)):
            m = pkg.TransformerLM(64, **LM)
            m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
            kw = {} if pkg is ttransformer else dict(use_graph=True)
            m.compile([side.t(ids)], is_train=True, policy="bf16_mixed",
                      **kw)
            side.load(m, _seeded(m, 5))
            losses = [side.step(m, ids, tgt)[1] for _ in range(2)]
            runs.append((losses, side.states(m), type(m.optimizer)))
    finally:
        JA.FORCE_PALLAS_INTERPRET = prev
    (want, ref, jt), (got, mine, tt) = runs
    assert jt is JGuard and tt is GuardedOptimizer
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for k, v in ref.items():
        if not k.startswith("optimizer/"):
            _close(mine[k], v, STATE_TOL, k)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_train_cnn_example_trains_under_bf16_mixed(monkeypatch, capsys,
                                                   tmp_path):
    """``train_cnn.py resnet cifar10 -p bf16_mixed`` on CIFAR-10 files
    written in the pickle wire format (ResNet(Bottleneck, [1, 1, 1, 1]))."""
    script = Path(__file__).resolve().parents[1] / "singa_tpu_torch" / \
        "examples" / "train_cnn.py"
    spec = importlib.util.spec_from_file_location("port_train_cnn_bf16",
                                                  script)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(tresnet, "create_model", lambda **kw: tresnet.ResNet(
        tresnet.Bottleneck, [1, 1, 1, 1], **kw))
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (4, 3072))
                         .astype(np.uint8),
                         "labels": rng.randint(0, 10, 4).tolist()}, f)
    model = example.main(["resnet", "cifar10", "--data-dir", str(tmp_path),
                          "--cpu", "--bs", "2", "--max-batches", "2",
                          "--epochs", "1", "-p", "bf16_mixed",
                          "--fused-optim"])
    out = capsys.readouterr().out
    assert "Training loss" in out and "Evaluation accuracy" in out
    assert isinstance(model.optimizer, GuardedOptimizer)
    assert model._policy.name == "bf16_mixed"
    stats = model.optimizer.stats()
    assert float(model.optimizer.get_states()["step_counter"]) == 2 - \
        stats["skipped_total"]
    for k, t in model.get_states().items():
        assert t.dtype == torch.float32, k
    # -p bfloat16 (the pure-bf16 input cast) is ported now; the guarded
    # resilient driver is not
    assert example._refuse(example.build_parser().parse_args(
        ["resnet", "-p", "bfloat16", "--cpu"])) is None
    with pytest.raises(SystemExit, match="ROADMAP"):
        example.main(["resnet", "-p", "bf16_mixed", "--resilient", "--cpu"])
