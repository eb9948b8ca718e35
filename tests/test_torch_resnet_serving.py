"""The port's serving slice as a whole, held against the JAX package.

A ResNet built in ``singa_tpu`` and one built in ``singa_tpu_torch`` get
the same weights and BN running statistics (made with numpy from a seed,
random enough that the BN fold is not trivial), carried across by
``singa_tpu_torch.model.load_numpy_states`` -- from a dict and from a
``save_states`` zip written by the JAX package. Both serve 3 requests at
batch 2 (so one tick is partial) through ``compile_serving``: the JAX
package under ``fused_epilogue.enabled_scope(True)`` with its Pallas
kernel in interpret mode, the port with its epilogue enabled on the CPU
(where the kernel's plain version stands in).

Tolerance: rtol 1e-4, atol 1e-4 on logits of order 1. Both run f32 end to
end; they differ only in conv summation order and in the BN fold's
rounding.
"""

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu.ops import fused_epilogue as jfe
from singa_tpu.ops import fused_optim

from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import resnet as tresnet
from singa_tpu_torch.ops import batchnorm as tbn
from singa_tpu_torch.ops import fused_epilogue as tfe

BATCH = 2
N_REQUESTS = 3
SHAPE = (3, 224, 224)
RTOL = ATOL = 1e-4

_JAX_CACHE = {}


def _states_from_seed(names_shapes, seed):
    """numpy weights for every state: scaled-normal conv/fc weights and
    non-trivial BN scale, bias and running statistics."""
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
        else:           # bias, running_mean, fc b
            v = rng.randn(*shape) * 0.2
        out[k] = v.astype(np.float32)
    return out


def _inputs(seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(N_REQUESTS)]


def _block(kind, pkg):
    return getattr(pkg, "Bottleneck" if kind == "bottleneck"
                   else "BasicBlock")


def _jax_reference(kind, layout, tmp_path_factory):
    """JAX logits (3, 10), the numpy states and a save_states zip; built
    once per (block, layout)."""
    key = (kind, layout)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    dev = jdevice.create_cpu_device()
    m = jresnet.ResNet(_block(kind, jresnet), [1, 1, 1, 1], layout=layout)
    tx = jtensor.Tensor(data=np.zeros((BATCH,) + SHAPE, np.float32),
                        device=dev, requires_grad=False)
    m.compile([tx], is_train=False, use_graph=True)
    m.eval()
    live = m.get_states()
    states = _states_from_seed(
        sorted((k, tuple(v.shape)) for k, v in live.items()), seed=11)
    for k, v in states.items():
        live[k].copy_from_numpy(v)
    zpath = tmp_path_factory.mktemp("ckpt") / f"{kind}-{layout}.zip"
    m.save_states(str(zpath))
    prev = fused_optim.FORCE_PALLAS_INTERPRET
    fused_optim.FORCE_PALLAS_INTERPRET = True
    try:
        with jfe.enabled_scope(True):
            eng = m.compile_serving(input_shape=SHAPE, batch=BATCH)
            futs = [eng.submit(x) for x in _inputs()]
            eng.run_until_idle()
            logits = np.stack([np.asarray(f.result()) for f in futs])
    finally:
        fused_optim.FORCE_PALLAS_INTERPRET = prev
    _JAX_CACHE[key] = (logits, states, zpath)
    return _JAX_CACHE[key]


def _port_engine(kind, layout):
    dev = tdevice.create_cpu_device()
    m = tresnet.ResNet(_block(kind, tresnet), [1, 1, 1, 1], layout=layout)
    m.eval()
    eng = m.compile_serving(input_shape=SHAPE, batch=BATCH, device=dev)
    return m, eng


def _serve(eng):
    futs = [eng.submit(x) for x in _inputs()]
    ticks = eng.run_until_idle()
    return np.stack([f.result() for f in futs]), ticks


@pytest.mark.parametrize("kind,layout,carry", [
    ("bottleneck", "NCHW", "dict"),
    ("bottleneck", "NCHW", "zip"),
    ("bottleneck", "NHWC", "dict"),
    ("basic", "NCHW", "dict"),
    ("basic", "NHWC", "zip"),
])
def test_logits_match_jax_engine(kind, layout, carry, tmp_path_factory):
    ref, states, zpath = _jax_reference(kind, layout, tmp_path_factory)
    m, eng = _port_engine(kind, layout)
    if carry == "dict":
        load_numpy_states(m, states)
    else:
        m.load_states(str(zpath))
    with tfe.enabled_scope(True):
        got, ticks = _serve(eng)
    assert ticks == 2                       # one full tick, one partial
    assert got.shape == ref.shape == (N_REQUESTS, 10)
    assert np.all(np.isfinite(got))
    assert np.abs(ref).max() > 0.1          # not a degenerate comparison
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_every_tail_fuses_and_bypassed_ops_never_run(layout,
                                                     tmp_path_factory):
    """Bottleneck [1,1,1,1]: 1 stem tail + 3 tails in each of 4 blocks =
    13 fused tails per forward. The only BN that still normalises is
    each block's downsample BN (4 per forward: it is the residual
    input), and no plain add runs."""
    _, states, _ = _jax_reference("bottleneck", layout, tmp_path_factory)
    m, eng = _port_engine("bottleneck", layout)
    load_numpy_states(m, states)
    with tfe.enabled_scope(True):
        tfe.reset_counts()
        tbn.normalise_runs = 0
        tautograd.add_runs = 0
        _, ticks = _serve(eng)
        assert tfe.fused_tails == 13 * ticks
        assert tbn.normalise_runs == 4 * ticks
        assert tautograd.add_runs == 0
        # on the CPU the plain version stands in: no kernel launched
        assert sum(tfe.launches.values()) == 0


def test_disabled_epilogue_runs_plain_ops_to_the_same_logits(
        tmp_path_factory):
    ref, states, _ = _jax_reference("bottleneck", "NCHW", tmp_path_factory)
    m, eng = _port_engine("bottleneck", "NCHW")
    load_numpy_states(m, states)
    assert not tfe.enabled()
    tfe.reset_counts()
    tbn.normalise_runs = 0
    tautograd.add_runs = 0
    got, ticks = _serve(eng)
    assert tfe.fused_tails == 0
    assert tbn.normalise_runs == 17 * ticks      # 13 tails + 4 downsample
    assert tautograd.add_runs == 4 * ticks
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_state_names_match_jax(tmp_path_factory):
    _, states, _ = _jax_reference("bottleneck", "NCHW", tmp_path_factory)
    m, _ = _port_engine("bottleneck", "NCHW")
    mine = m.get_states()
    assert sorted(mine) == sorted(states)
    for k, v in states.items():
        assert tuple(mine[k].shape) == v.shape, k


def test_load_numpy_states_is_strict():
    m, _ = _port_engine("basic", "NCHW")
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    states.pop(sorted(states)[0])
    with pytest.raises(KeyError):
        load_numpy_states(m, states)
    fresh = tresnet.ResNet(tresnet.BasicBlock, [1, 1, 1, 1])
    with pytest.raises(RuntimeError, match="no states yet"):
        load_numpy_states(fresh, states)


def test_port_save_load_round_trip(tmp_path):
    m, eng = _port_engine("basic", "NCHW")
    names = sorted((k, tuple(v.shape)) for k, v in m.get_states().items())
    load_numpy_states(m, _states_from_seed(names, seed=3))
    want, _ = _serve(eng)
    path = tmp_path / "port.zip"
    m.save_states(str(path))
    m2, eng2 = _port_engine("basic", "NCHW")
    m2.load_states(str(path))
    got, _ = _serve(eng2)
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_stem_and_training_bn_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1],
                       stem="space_to_depth")
    m, eng = _port_engine("basic", "NCHW")
    dev = tdevice.create_cpu_device()
    from singa_tpu_torch.tensor import Tensor
    m.train()
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            m.forward(Tensor(data=torch.zeros((1,) + SHAPE), device=dev))
    finally:
        m.eval()
