"""Sync-BN: the port's batch-statistic BN under a ``DistOpt`` over four
gloo ranks, held against the port's single-device full-batch step and
against the JAX package's sync-BN over a four-device CPU mesh.

``tests/test_parallel.py::TestSyncBatchNorm``'s model (conv 3->4, BN,
linear 4) and batch (16 x 3 x 8 x 8), ``SGD(lr=0.1)``, 4 steps in graph
mode, weights and BN statistics made from a numpy seed and carried into
both packages. The ranks (``tests/torch_dist_ranks.py``, ``sync_bn``
case) start once for the module, each on its quarter of the batch: the
moments are averaged over the ranks, and the backward goes through the
all-reduce, so the sharded step is the full-batch step. Bounds: the JAX
test's own rtol 1e-4 (atol 1e-6 on the statistics) against the full
batch, 1e-5 against the JAX package's sharded run; and the same steps
with every state and the batch in f64, where the order of the sums no
longer hides an error of the reduction, within 1e-12 of the f64 full
batch.
"""

import numpy as np
import pytest

import jax

from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.parallel import mesh as jmesh

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states

import torch_dist_ranks as ranks

WORLD = 4
STEPS = 4
F64_RTOL = 1e-12


class BNModel(jmodel.Model):
    def __init__(self):
        super().__init__()
        self.conv = jlayer.Conv2d(4, 3, padding=1)
        self.bn = jlayer.BatchNorm2d()
        self.flat = jlayer.Flatten()
        self.fc = jlayer.Linear(4)
        self.loss_fn = jlayer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc(self.flat(self.bn(self.conv(x))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self.optimizer(loss)
        return out, loss


def _data():
    rng = np.random.RandomState(3)
    x = rng.randn(16, 3, 8, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]
    return x, y


def _seeded(names_shapes, seed=9):
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in names_shapes:
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            v = rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[1:]
                                                          if len(shape) == 4
                                                          else shape[:1]))
        elif leaf in ("scale", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.randn(*shape) * 0.2
        out[k] = v.astype(np.float32)
    return out


def _jax_run():
    """The JAX package's sync-BN over the mesh: losses, states, and the
    seeded start."""
    x, y = _data()
    dev = jdevice.create_cpu_device()
    m = BNModel()
    d = jopt.DistOpt(jopt.SGD(lr=0.1))
    d.communicator.mesh = jmesh.make_mesh(jax.devices("cpu")[:WORLD],
                                          jmesh.MeshConfig())
    m.set_optimizer(d)
    tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
    ty = jtensor.Tensor(data=y, device=dev, requires_grad=False)
    m.compile([tx], is_train=True, use_graph=True)
    live = m.get_states()
    init = _seeded(sorted((k, tuple(v.shape)) for k, v in live.items()))
    for k, v in init.items():
        live[k].copy_from_numpy(v)
    losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
    states = {k: np.asarray(v.data, np.float32)
              for k, v in m.get_states().items()}
    return init, np.asarray(losses), states


def _full_batch(init, dtype=np.float32):
    """The port on one device over the whole batch."""
    x, y = _data()
    dev = tdevice.create_cpu_device()
    m = ranks.bn_model()
    m.set_optimizer(topt.SGD(lr=0.1))
    tx, ty = ttensor.Tensor(data=x, device=dev), \
        ttensor.Tensor(data=y, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(m, init)
    if dtype == np.float64:
        ranks.as_float64(m)
        tx, ty = ttensor.Tensor(data=x.astype(dtype), device=dev), \
            ttensor.Tensor(data=y.astype(dtype), device=dev)
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(STEPS)]
    TCTX.training = False
    return np.asarray(losses), {k: v.to_numpy()
                                for k, v in m.get_states().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init, jlosses, jstates = _jax_run()
    x, y = _data()
    inputs = {"x": x, "y": y}
    inputs.update({f"init/{k}": v for k, v in init.items()})
    outs, _ = ranks.launch("sync_bn", WORLD, inputs,
                           tmp_path_factory.mktemp("sync_bn"))
    return dict(init=init, jax=(jlosses, jstates), ranks=outs,
                full=_full_batch(init),
                full64=_full_batch(init, np.float64))


def _states(out, prefix="bn"):
    return {k.split("/state/")[1]: v for k, v in out.items()
            if k.startswith(f"{prefix}/state/")}


def test_replicas_agree_and_see_the_mean_loss(runs):
    outs = runs["ranks"]
    for o in outs:
        assert bool(o["agree"])
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        for k, v in _states(o).items():
            np.testing.assert_array_equal(v, _states(outs[0])[k], k)


def test_sharded_step_is_the_full_batch_step(runs):
    """``test_dp_bn_matches_single_device``'s bounds: the losses, the BN
    running statistics and, through the all-reduce's backward, every
    parameter."""
    got = runs["ranks"][0]
    want_losses, want = runs["full"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
    states = _states(got)
    assert sorted(states) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(states[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # the statistics moved from the seeded start: they are the batch's
    assert not np.allclose(states["BNModel.bn.running_mean"],
                           runs["init"]["BNModel.bn.running_mean"])


def test_sharded_step_is_the_full_batch_step_in_float64(runs):
    """In f64 the only difference, the order of the sums, is far below
    any error of the reduction: losses and every state within
    ``F64_RTOL`` (measured 5.6e-16 / 1.7e-16 of each tensor's max)."""
    want_losses, want = runs["full64"]
    for o in runs["ranks"]:
        np.testing.assert_allclose(o["f64/losses"], want_losses,
                                   rtol=F64_RTOL)
        states = _states(o, "f64")
        assert sorted(states) == sorted(want)
        for k, v in want.items():
            assert states[k].dtype == np.float64, k
            np.testing.assert_allclose(states[k], v, rtol=F64_RTOL,
                                       atol=F64_RTOL * np.abs(v).max(),
                                       err_msg=k)


def test_sharded_step_matches_the_jax_sync_bn(runs):
    got = runs["ranks"][0]
    want_losses, want = runs["jax"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    states = _states(got)
    for k, v in want.items():
        np.testing.assert_allclose(states[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_moments_outside_a_data_parallel_step_are_local():
    """Outside a ``DistOpt`` step (no collective context) BN takes the
    moments of its own batch, as on one device."""
    import torch
    from singa_tpu_torch.ops.batchnorm import batch_moments
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    mean, var = batch_moments(x, (0, 2, 3))
    torch.testing.assert_close(mean, x.mean(dim=(0, 2, 3)))
    torch.testing.assert_close(var, x.var(dim=(0, 2, 3), unbiased=False))
