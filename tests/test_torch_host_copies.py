"""A host snapshot taken from the port holds still, as the JAX package's
does.

On the CPU a tensor's ``.numpy()`` is a view of its storage, so a host
array taken from a CPU tensor changed under the caller at the next
in-place write (an optimizer step, ``+=``, ``copy_from_numpy``). The JAX
package's host arrays are copies (``singa_tpu/tensor.py:149-150,
603-632``). Each case takes a snapshot through one entry point, moves
the source (a train step or an in-place write), and holds the snapshot
equal to a deep copy taken at the same moment, in both packages:
``Optimizer.get_states``, ``to_host_tree(Model.get_states())``,
``Tensor.to_numpy`` and ``GuardedOptimizer.get_states``.
"""

import copy

import numpy as np
import pytest

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import mlp as jmlp
from singa_tpu.resilience import GuardedOptimizer as JGuard

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.models import mlp as tmlp
from singa_tpu_torch.resilience import GuardedOptimizer as TGuard

PKGS = {"jax": (jdevice, jopt, jtensor, jmlp, JGuard),
        "port": (tdevice, topt, ttensor, tmlp, TGuard)}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    return x, y


def _trained(pkg, guarded=False):
    """An MLP (6 -> 5 -> 3) after one SGD step (momentum 0.9) on the CPU,
    and a function that runs one more step."""
    device, opt, tensor, mlp, guard = PKGS[pkg]
    dev = device.create_cpu_device()
    x, y = _batch()
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.Tensor(data=y, device=dev)
    m = mlp.create_model(data_size=6, perceptron_size=5, num_classes=3)
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    m.set_optimizer(guard(sgd) if guarded else sgd)
    m.compile([tx], is_train=True, use_graph=False)

    def step():
        m(tx, ty)
    step()
    return m, step


def _moved(snapshot, want):
    """The keys whose array in ``snapshot`` no longer equals ``want``'s."""
    assert sorted(snapshot) == sorted(want)
    return sorted(k for k in want
                  if not np.array_equal(np.asarray(snapshot[k]),
                                        np.asarray(want[k])))


def _assert_held(pkg, take, guarded=False):
    m, step = _trained(pkg, guarded)
    snap = take(m)
    want = copy.deepcopy({k: np.array(v) for k, v in snap.items()})
    before = {k: np.array(v) for k, v in take(m).items()}
    step()
    after = take(m)
    # the step moved the source, and the snapshot stayed as it was
    assert _moved(after, before), f"{pkg}: the step moved nothing"
    assert not _moved(snap, want), \
        f"{pkg}: a later step changed {_moved(snap, want)}"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_optimizer_states_snapshot_holds_across_a_step(pkg):
    _assert_held(pkg, lambda m: m.optimizer.get_states())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_host_tree_of_model_states_holds_across_a_step(pkg):
    """The port's ``to_host_tree`` takes the Tensors of
    ``Model.get_states()``; the JAX package's takes their arrays."""
    tensor = PKGS[pkg][2]
    if pkg == "jax":
        _assert_held(pkg, lambda m: tensor.to_host_tree(
            {k: v.data for k, v in m.get_states().items()}))
    else:
        _assert_held(pkg, lambda m: tensor.to_host_tree(m.get_states()))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_guarded_optimizer_states_snapshot_holds_across_a_step(pkg):
    _assert_held(pkg, lambda m: m.optimizer.get_states(), guarded=True)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("write", ["iadd", "copy_from_numpy"])
def test_to_numpy_holds_across_an_in_place_write(pkg, write):
    device, _opt, tensor, _mlp, _guard = PKGS[pkg]
    t = tensor.Tensor(data=np.arange(6, dtype=np.float32).reshape(2, 3),
                      device=device.create_cpu_device())
    # the JAX Tensor has no ``to_numpy`` method, and its
    # ``to_host_array`` takes an array
    arrays = [t.numpy(), tensor.to_numpy(t), tensor.to_host_array(t.data)]
    if pkg == "port":
        arrays += [t.to_numpy(), tensor.to_host_array(t)]
    if write == "iadd":
        t += 1
    else:
        t.copy_from_numpy(np.full((2, 3), 7, np.float32))
    assert not np.array_equal(t.numpy(), np.arange(6).reshape(2, 3))
    for a in arrays:
        np.testing.assert_array_equal(
            a, np.arange(6, dtype=np.float32).reshape(2, 3))
