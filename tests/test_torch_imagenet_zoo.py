"""The port's ImageNet zoo (VGG, SqueezeNet, MobileNetV2, DenseNet,
ShuffleNetV2) held against the JAX package on the CPU.

Each model is built in both packages at ``tests/test_models.py``'s small
configurations (VGG-11-BN 32 px, SqueezeNet 1.1 64 px, MobileNetV2 0.25,
ShuffleNetV2 0.5, a DenseNet of two blocks of two layers, growth 8, 16
stem features), batch 2. Weights and BN statistics are made with numpy
from a seed and carried across by ``load_numpy_states``, the batch too.
Training runs ``SGD(lr=0.02, momentum=0.9, weight_decay=1e-5,
fused=True)`` for 3 steps: the port in graph mode on the CPU (the
kernel's plain version standing in), the JAX package compiled on its
plain optimizer chain (its fused step declines off the TPU; its own
compiled zoo test is ``@pytest.mark.slow`` in ``tests/test_models.py``).
The ``Dropout`` layers are set to ratio 0 in both packages (they draw from
different generators). Bounds are ``tests/test_torch_cnn_zoo.py``'s:
losses within rtol 1e-3 / atol 1e-4, states within 5e-3 of each norm,
momenta within 5e-2.

MobileNetV2 0.25 and ShuffleNetV2 0.5 are held step by step, one file
each (``tests/test_torch_imagenet_zoo_mobilenet.py``,
``tests/test_torch_imagenet_zoo_shufflenet.py``; :func:`stepwise_case`;
their eval and archives in ``tests/test_torch_imagenet_zoo_eval.py``),
at 64 px and ``SGD(lr=2e-3, ...)``: each of the 3 port steps starts from
the JAX package's states and momenta after the step before, against the
JAX package run op by op (``use_graph=False``), under the same bounds. At
batch 2 their training is chaotic: a last-bit difference grows into a
different trajectory within 2 steps. At 32 px their last feature maps are
1x1, so their last BNs normalise over two values: from the same states
the port against itself, with the input scaled by 1 + 1e-6, moves
ShuffleNetV2's stem weights by 2.5% of their norm in one step, and at lr
0.02 the first update is as large as the weights it moves (MobileNetV2's
second loss moves from 0.278 to 0.372 under that perturbation; the JAX
package's is 0.394). At 64 px free runs still part at the second step,
the JAX package from itself too: its compiled steps give MobileNetV2 (lr
2e-3) the losses 1.998, 1.768, 1.504 and its op-by-op steps 1.998, 1.729,
1.626; its compiled step and its op-by-op step from the same states differ
by 4% in the stem's weights. From the same states one port step and one
op-by-op JAX step agree within 4e-5 of every state's norm. The biases of
the BNs that no ReLU follows (MobileNetV2's ``project_bn``,
ShuffleNetV2's ``bn2``, ``b1_bn1`` and ``b2_bn2``) have a gradient of
exactly 0: their outputs reach the loss only through a conv and a
training-mode BN, which removes a per-channel shift. Their momenta are
rounding noise (norms near 1e-5) and are held absolutely, within 1e-6 of
the norm of all the model's momenta.

Eval: the trained port model's logits through K2's plain version (the
epilogue enabled) against the JAX package's forward on the same states
within 1e-4, with one fused tail per BN -> ReLU pair of the model, and the
archives of each package loading in the other to the same logits.
"""

import re

import numpy as np
import pytest

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import densenet as jdensenet
from singa_tpu.models import mobilenet as jmobilenet
from singa_tpu.models import shufflenet as jshufflenet
from singa_tpu.models import squeezenet as jsqueezenet
from singa_tpu.models import vgg as jvgg

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import densenet as tdensenet
from singa_tpu_torch.models import mobilenet as tmobilenet
from singa_tpu_torch.models import shufflenet as tshufflenet
from singa_tpu_torch.models import squeezenet as tsqueezenet
from singa_tpu_torch.models import vgg as tvgg
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import fused_optim as tfo

from test_torch_cnn_zoo import (ATOL, MOMENTUM_TOL, RTOL, SGD_KW,
                                STATE_TOL, STEPS, _close, _states_from_seed)

LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _port_eval_after():
    yield
    TCTX.training = False


@pytest.fixture(autouse=True)
def _no_jax_weight_draws(monkeypatch):
    """The JAX models get their weights from the numpy seed: their own
    draws are skipped."""
    monkeypatch.setattr(jtensor.Tensor, "gaussian",
                        lambda self, mean=0.0, std=1.0: self)


def _no_dropout(m):
    for name in ("drop1", "drop2", "dropout"):
        if hasattr(m, name):
            getattr(m, name).ratio = 0.0
    return m


def _tiny_densenet(pkg):
    return pkg.create_model(block_config=(2, 2), growth_rate=8,
                            num_init_features=16)


# name: (JAX factory, port factory, input px, K2 tails per eval forward,
# SGD lr, the BN biases of gradient 0 or None; the stepwise file holds the
# models that have them)
ZOO = {
    "vgg11bn": (lambda: jvgg.create_model(depth=11, batch_norm=True),
                lambda: tvgg.create_model(depth=11, batch_norm=True), 32, 8,
                0.02, None),
    "squeezenet11": (lambda: jsqueezenet.create_model(version="1.1"),
                     lambda: tsqueezenet.create_model(version="1.1"), 64, 0,
                     0.02, None),
    "densenet_tiny": (lambda: _tiny_densenet(jdensenet),
                      lambda: _tiny_densenet(tdensenet), 32, 11, 0.02, None),
    "mobilenetv2": (lambda: jmobilenet.create_model(width_mult=0.25),
                    lambda: tmobilenet.create_model(width_mult=0.25), 64, 0,
                    2e-3, r"project_bn\.bias:"),
    "shufflenetv2": (lambda: jshufflenet.create_model(width="0.5"),
                     lambda: tshufflenet.create_model(width="0.5"), 64, 37,
                     2e-3, r"(\.bn2|b1_bn1|b2_bn2)\.bias:"),
}
FREE = ["densenet_tiny", "squeezenet11", "vgg11bn"]


def _batch(size, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, size, size).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)]
    return x, y


def _jax_eval(jm, x, states):
    jx = jtensor.Tensor(data=x, device=jdevice.create_cpu_device(),
                        requires_grad=False)
    jm.compile([jx], is_train=False, use_graph=False)
    live = jm.get_states()
    for k, v in states.items():
        live[k].copy_from_numpy(v)
    return np.asarray(jm(jx).data)


def _port_eval(m, x):
    """Eval logits with the epilogue on (K2's plain version on the CPU)
    and the fused tails it ran."""
    m.eval()
    tx = ttensor.Tensor(data=x, device=tdevice.create_cpu_device())
    tfe.fused_tails = 0
    with tfe.enabled_scope(True):
        out = m(tx).to_numpy()
    return out, tfe.fused_tails


def _jax_train(model, x, y, lr, use_graph=True):
    """``STEPS`` SGD steps of the JAX ``model`` (compiled, or op by op
    without ``use_graph``; its plain optimizer chain) from seeded states:
    the start, and after each step its loss, the states and the optimizer
    states."""
    dev = jdevice.create_cpu_device()
    model.set_optimizer(jopt.SGD(**{**SGD_KW, "lr": lr}))
    tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
    ty = jtensor.Tensor(data=y, device=dev, requires_grad=False)
    model.compile([tx], is_train=True, use_graph=use_graph)
    live = model.get_states()
    init = _states_from_seed(sorted((k, tuple(v.shape))
                                    for k, v in live.items()))
    for k, v in init.items():
        live[k].copy_from_numpy(v)
    after = []
    for _ in range(STEPS):
        loss = float(np.asarray(model(tx, ty)[1].data, np.float32))
        after.append(dict(
            loss=loss,
            states={k: np.asarray(v.data, np.float32)
                    for k, v in model.get_states().items()},
            ostates={k: np.asarray(v, np.float32) for k, v in
                     model.optimizer.get_states().items()}))
    return init, after


def _port_model(tmake, x, lr):
    m = _no_dropout(tmake())
    m.set_optimizer(topt.SGD(**{**SGD_KW, "lr": lr}))
    m.compile([ttensor.Tensor(data=x, device=tdevice.create_cpu_device())],
              is_train=True, use_graph=True)
    return m


def _step(m, x, y):
    dev = m.dev
    return float(m(ttensor.Tensor(data=x, device=dev),
                   ttensor.Tensor(data=y, device=dev))[1].data.detach())


def _held(m, loss, ref, step, zero_grad):
    """The port after ``step`` steps against the JAX package's record of
    that step."""
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref["loss"], rtol=RTOL, atol=ATOL)
    mine = {k: v.to_numpy() for k, v in m.get_states().items()}
    assert sorted(mine) == sorted(ref["states"])
    for k, want in ref["states"].items():
        _close(mine[k], want, STATE_TOL, k)
    ostates = m.optimizer.get_states()
    assert sorted(ostates) == sorted(ref["ostates"])
    assert float(ostates["step_counter"]) == step
    scale = np.sqrt(sum(float(np.sum(np.square(v)))
                        for k, v in ref["ostates"].items() if ":" in k))
    for k, want in ref["ostates"].items():
        got = np.asarray(ostates[k])
        if zero_grad and re.search(zero_grad, k):
            assert np.linalg.norm(got - want) <= 1e-6 * scale, k
        else:
            _close(got, want, MOMENTUM_TOL, k)


def _eval_and_archives(name, m, x, tmp_path):
    """The trained port model's eval logits through K2's plain version
    against the JAX package's forward on the same states, which it loads
    from the port's archive (optimizer states too); and the JAX package's
    archive loading in a fresh port model to the same logits."""
    jmake, tmake, _, tails, _, _ = ZOO[name]
    got, fused = _port_eval(m, x)
    assert fused == tails
    path = tmp_path / "port.zip"
    m.save_states(str(path))
    jm = _no_dropout(jmake())
    jx = jtensor.Tensor(data=x, device=jdevice.create_cpu_device(),
                        requires_grad=False)
    jm.compile([jx], is_train=False, use_graph=False)
    jm.load_states(str(path))
    want = np.asarray(jm(jx).data)
    assert got.shape == (2, 10) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    back = tmp_path / "jax.zip"
    jm.save_states(str(back))
    m2 = _no_dropout(tmake())
    m2.compile([ttensor.Tensor(data=x, device=tdevice.create_cpu_device())],
               is_train=False)
    m2.load_states(str(back))
    np.testing.assert_array_equal(_port_eval(m2, x)[0], got)


@pytest.mark.parametrize("name", FREE)
def test_three_sgd_steps_and_eval_match_jax(name, tmp_path):
    """Three free steps in each package from the same start."""
    jmake, tmake, size, _, lr, zero_grad = ZOO[name]
    x, y = _batch(size)
    init, after = _jax_train(_no_dropout(jmake()), x, y, lr)
    m = _port_model(tmake, x, lr)
    load_numpy_states(m, init)
    tfo.reset_counts()
    losses = [_step(m, x, y) for _ in range(STEPS)]
    assert sum(tfo.launches.values()) == 0    # the plain version on the CPU
    np.testing.assert_allclose(losses, [a["loss"] for a in after],
                               rtol=RTOL, atol=ATOL)
    _held(m, losses[-1], after[-1], STEPS, zero_grad)
    assert [s["n_captures"] for s in m.graph_stats().values()] == [1]
    _eval_and_archives(name, m, x, tmp_path)


def stepwise_case(name):
    """The step-by-step comparison of ``name`` (module docstring)."""
    jmake, tmake, size, _, lr, zero_grad = ZOO[name]
    x, y = _batch(size)
    init, after = _jax_train(_no_dropout(jmake()), x, y, lr,
                             use_graph=False)
    m = _port_model(tmake, x, lr)
    load_numpy_states(m, init)
    tfo.reset_counts()
    for i, ref in enumerate(after):
        if i:
            prev = after[i - 1]
            load_numpy_states(m, {**prev["states"], **{
                f"optimizer/{k}": v for k, v in prev["ostates"].items()}})
        _held(m, _step(m, x, y), ref, i + 1, zero_grad)
    assert sum(tfo.launches.values()) == 0    # the plain version on the CPU
    assert [s["n_captures"] for s in m.graph_stats().values()] == [1]


def trained_eval_case(name, tmp_path):
    """``name`` trained one graphed step in the port alone from the seeded
    start (at 32 px: eval reads the running statistics, so the small maps
    do not matter), then :func:`_eval_and_archives`: the eval and the
    archives need no JAX training run."""
    _, tmake, _, _, lr, _ = ZOO[name]
    x, y = _batch(32)
    m = _port_model(tmake, x, lr)
    load_numpy_states(m, _states_from_seed(sorted(
        (k, tuple(v.shape)) for k, v in m.get_states().items())))
    assert np.isfinite(_step(m, x, y))
    _eval_and_archives(name, m, x, tmp_path)
