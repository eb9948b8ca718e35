"""Expert parallelism in the port: ``MeshConfig(expert=...)``, the MoE FFN's
all-to-alls over ``torch.distributed`` and ``DistOpt``'s per-parameter
reduce, held against the JAX package's expert-parallel run and against
the dense run (``tests/test_moe.py::TestExpertParallel`` and
``TestShardedEvalEP``).

Gloo ranks of ``tests/torch_dist_ranks.py`` (``moe`` case; one launch at
two ranks, one at four) train ``moe_net``, the port's
``tests/test_moe.py::MoENet`` (x (16, 8) -> ``MoEFFN(4, 16, top_k=2,
capacity_factor=8.0)`` -> mean-square loss plus 0.01 of the aux loss,
``SGD(lr=0.1)``, 4 steps), from numpy-seeded weights under a ``DistOpt``
over ``("data", "expert")`` with every rank given the global batch
(``input_specs = [P(("data", "expert"))] * 2``): ``expert=2`` at two
ranks, ``expert=4`` and ``expert=2`` beside ``data=2`` at four, the
latter also under ``DistOpt(zero=True)`` (ZeRO/FSDP over ``data`` on top
of the expert cut, the sum over ``("data", "expert", "seq")``) and with
``compile(fsdp_axis="expert")`` (the router cut over ``expert``, the
banks left as they are). The JAX
package trains the same net from the same weights over the same mesh of
CPU devices; the port also trains it dense on one process. The capacity
spares every token, so a rank's capacity (from its own tokens) drops
what the dense run's does: nothing.

Bounds: losses within rtol 1e-5 and every gathered state within 1e-5 of
its norm, of the JAX run and of the dense run (the JAX suite holds its
own run at rtol 2e-4, states 2e-3). The expert banks' gradients are
summed over ``data`` only and divided by the whole batch-shard count: a
sum over ``expert`` or a division by the data degree alone would move
the states by whole percents. A rank holds E/ep experts, an eval call
stays sharded (the expert bank is still the rank's block) and its output
equals the dense eval's; a step runs three all-to-alls (two forward, one
backward: the input takes no gradient); 3 experts over an expert axis of
2 or 4 raise as in JAX. Under ``bf16_mixed`` at ``expert=2`` an infinite
gradient of rank 1's expert bank alone skips the step on both ranks.
"""

import numpy as np
import pytest

import torch_dist_ranks as ranks
import torch_lm_mesh as H
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

LOSS_RTOL = 1e-5
STATE_TOL = 1e-5
RUNS = [(w, n) for w in sorted(ranks.MOE_RUNS) for n in ranks.MOE_RUNS[w]]
_REF = {}


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 8).astype(np.float32),
            rng.randn(16, 8).astype(np.float32))


def _seeded():
    """The net's states by name from a numpy seed."""
    from singa_tpu_torch import device, tensor
    m = ranks.moe_net()
    m(tensor.Tensor(data=_data()[0], device=device.create_cpu_device()))
    rng = np.random.RandomState(3)
    return {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in sorted(m.get_states().items())}


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    x, y = _data()
    inputs = {"x": x, "y": y,
              **{f"init/{k}": v for k, v in _seeded().items()}}
    out = {}
    for world in sorted(ranks.MOE_RUNS):
        work = tmp_path_factory.mktemp(f"moe{world}")
        out[world], _ = ranks.launch("moe", world, inputs, work)
    return out


def dense_run():
    """The port's net on one process, no mesh: losses, states, eval."""
    if "dense" in _REF:
        return _REF["dense"]
    from singa_tpu_torch import device, opt, tensor
    from singa_tpu_torch.model import load_numpy_states
    dev = device.create_cpu_device()
    x, y = _data()
    tx, ty = tensor.Tensor(data=x, device=dev), tensor.Tensor(data=y,
                                                              device=dev)
    m = ranks.moe_net()
    m.set_optimizer(opt.SGD(lr=0.1))
    m.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(m, _seeded())
    losses = [float(m(tx, ty)[1].data.detach())
              for _ in range(ranks.MOE_STEPS)]
    states = {k: np.array(v.to_numpy()) for k, v in m.get_states().items()}
    m.eval()
    _REF["dense"] = dict(losses=np.asarray(losses), states=states,
                         eval=np.array(m(tx).to_numpy()))
    return _REF["dense"]


def jax_run(world, name):
    """``tests/test_moe.py::TestExpertParallel._train`` over the first
    ``world`` CPU devices with ``MOE_RUNS[world][name]``'s degrees, from
    the seeded weights."""
    key = (world, name)
    if key in _REF:
        return _REF[key]
    import jax
    from jax.sharding import PartitionSpec as JP
    from singa_tpu import autograd, device, layer, model, opt, tensor
    from singa_tpu.parallel import mesh as mesh_mod, moe
    from singa_tpu.parallel.communicator import set_mesh
    dev = device.create_cpu_device()

    class MoENet(model.Model):
        def __init__(self):
            super().__init__()
            self.ffn = moe.MoEFFN(4, 16, top_k=2, capacity_factor=8.0)
            self.loss_fn = layer.MeanSquareError()

        def forward(self, x):
            return self.ffn(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            loss = autograd.add(loss, autograd.mul(
                self.ffn.aux_loss, tensor.Tensor(
                    data=np.asarray(0.01, np.float32), device=dev,
                    requires_grad=False)))
            self.optimizer(loss)
            return out, loss

    x, y = _data()
    tx = tensor.Tensor(data=x, device=dev, requires_grad=False)
    ty = tensor.Tensor(data=y, device=dev, requires_grad=False)
    degrees = {k: v for k, v in ranks.MOE_RUNS[world][name].items()
               if k not in ("zero", "fsdp")}
    mesh = mesh_mod.make_mesh(jax.devices("cpu")[:world],
                              mesh_mod.MeshConfig(**degrees))
    set_mesh(mesh)
    try:
        m = MoENet()
        d = opt.DistOpt(opt.SGD(lr=0.1), reduce_axes=("data", "expert"))
        d.communicator.mesh = mesh
        m.set_optimizer(d)
        m.input_specs = [JP(("data", "expert")), JP(("data", "expert"))]
        m.compile([tx], is_train=True, use_graph=True)
        live = m.get_states()
        for k, v in _seeded().items():
            live[k].copy_from_numpy(v)
        losses = [float(np.asarray(m(tx, ty)[1].data))
                  for _ in range(ranks.MOE_STEPS)]
        states = {k: np.asarray(jax.device_get(v.data))
                  for k, v in m.get_states().items()}
    finally:
        set_mesh(None)
    _REF[key] = dict(losses=np.asarray(losses), states=states)
    return _REF[key]


@pytest.mark.parametrize("world,name", RUNS)
def test_ep_run_matches_jax_and_dense(ranked, world, name):
    ref, dense = jax_run(world, name), dense_run()
    np.testing.assert_allclose(ref["losses"], dense["losses"], rtol=2e-4)
    for out in ranked[world]:
        got = out[f"{name}/losses"]
        np.testing.assert_allclose(got, ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, dense["losses"], rtol=LOSS_RTOL)
        assert got[-1] < got[0]
        for k, v in ref["states"].items():
            H.close(out[f"{name}/state/{k}"], v, STATE_TOL, k)
            H.close(out[f"{name}/state/{k}"], dense["states"][k],
                    STATE_TOL, k)


@pytest.mark.parametrize("world,name", RUNS)
def test_banks_shard_and_eval_stays_sharded(ranked, world, name):
    """A rank holds E/ep experts in training and in eval (under ZeRO also
    half of each expert's rows, its first whole dimension; FSDP over
    ``expert`` leaves the banks, cut over it already, and halves the
    router), and the sharded eval equals the dense one
    (``TestShardedEvalEP``'s bounds)."""
    run = ranks.MOE_RUNS[world][name]
    ep = run["expert"]
    local = [4 // ep, 8 // 2 if run.get("zero") else 8, 16]
    router = [8 // 2 if run.get("zero") or run.get("fsdp") else 8, 4]
    dense = dense_run()
    for out in ranked[world]:
        np.testing.assert_array_equal(out[f"{name}/local/w1"], local)
        np.testing.assert_array_equal(out[f"{name}/local/wg"], router)
        np.testing.assert_array_equal(out[f"{name}/eval_local/w1"], local)
        np.testing.assert_allclose(out[f"{name}/eval"], dense["eval"],
                                   rtol=2e-4, atol=1e-5)


def test_guard_skips_an_expert_overflow_on_every_rank(ranked):
    """``bf16_mixed`` at ``expert=2``: an infinite expert gradient on rank
    1 alone skips the step on both ranks (the guard's norm sums the expert
    blocks over ``expert``), after a clean step that moved the states."""
    for out in ranked[2]:
        moved = out["guard/moved"]
        assert moved[0] > 0 and moved[1] == 0, moved
        np.testing.assert_array_equal(out["guard/skipped_total"], [0, 1])
        scale = out["guard/loss_scale"]
        assert scale[1] == scale[0] / 2, scale


@pytest.mark.parametrize("world", sorted(ranks.MOE_RUNS))
def test_all_to_alls_per_step_and_indivisible_experts(ranked, world):
    for out in ranked[world]:
        for name in ranks.MOE_RUNS[world]:
            np.testing.assert_array_equal(out[f"{name}/all_to_all"],
                                          [3] * ranks.MOE_STEPS)
        assert f"n_experts=3 must divide by the 'expert' mesh degree " \
            f"{world}" in str(out["indivisible"])
