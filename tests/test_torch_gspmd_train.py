"""The port's train mesh and ZeRO/FSDP (``parallel/gspmd.py``,
``Model.compile(mesh=, fsdp_axis=)``, ``DistOpt(zero=True)``) against the
JAX package's GSPMD train step (``tests/test_gspmd_train.py``).

In this process: the spec functions and the train mesh's degrees case by
case against the JAX package's, the typed declines of the specialised
drivers under ``zero=True``, and the serving half's refusal.

The ranks are processes of ``tests/torch_dist_ranks.py`` (``gspmd``
case), started twice for the module over gloo: two ranks, then four (which
restore the two-rank ZeRO archive). Each trains the MLP of
``tests/test_gspmd_train.py`` (8 -> 16 -> 4) on its ``datasets.partition``
of the 16-row batch, weights from a numpy seed, three graphed steps of
``SGD(lr=0.1, momentum=0.9)`` under five spellings: a ``DistOpt`` without a
mesh (plain data parallelism), ``compile(mesh=train_mesh())`` with that
``DistOpt`` and with a plain ``SGD``, ``DistOpt(zero=True)``, and
``compile(fsdp_axis="data")`` with a plain ``SGD``.

Bounds: against the JAX package's GSPMD and FSDP steps over four CPU
devices, losses within rtol 1e-5 and every state within 1e-5 of its
largest magnitude (``tests/test_torch_dist_opt.py``'s bound: XLA sums in
another order; measured: losses equal, states 1.2e-7). Among the port's
spellings: bitwise, at two ranks and at four (measured:
gloo's reduce-scatter sums a shard as its all-reduce does; the update is
elementwise). The guard's gradient norm under FSDP: within rtol 1e-6 of
the unsharded guard's (the shards' squared norms are summed, then
all-reduced: another order; measured 1 ulp); its verdicts, loss scale,
streaks and the states bitwise. The f64 net with dropout and sync-BN at
two ranks under ``compile(mesh=)``: within 1e-9 of one rank on the whole
batch (measured 1.2e-16, the losses equal).
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

import jax

from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.parallel import gspmd as jgspmd
from singa_tpu.parallel import mesh as jmesh
from singa_tpu.parallel.communicator import set_mesh

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.parallel import gspmd

import torch_dist_ranks as ranks

STATE_TOL = 1e-5
NORM_RTOL = 1e-6
F64_TOL = 1e-9
MLP_SHAPES = {"MLP.fc1.W": (8, 16), "MLP.fc1.b": (16,),
              "MLP.fc2.W": (16, 4), "MLP.fc2.b": (4,)}


def _seeded(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * (np.sqrt(1.0 / s[0]) if k.endswith(".W")
                                 else 0.2)).astype(np.float32)
            for k, s in shapes.items()}


def _xy():
    """``tests/test_gspmd_train.py::make_xy``."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]
    return x, y


def _drop_data():
    rng = np.random.RandomState(3)
    x = rng.randn(8, 3, 4, 4).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)]
    init = _seeded({"DropBN.conv.W": (4, 3, 3, 3), "DropBN.conv.b": (4,),
                    "DropBN.bn.scale": (4,), "DropBN.bn.bias": (4,),
                    "DropBN.bn.running_mean": (4,),
                    "DropBN.fc.W": (64, 4), "DropBN.fc.b": (4,)}, 4)
    init["DropBN.bn.running_var"] = rng.uniform(0.5, 2.0, 4).astype(
        np.float32)
    return x, y, init


def _inputs():
    x, y = _xy()
    inputs = {"x": x, "y": y}
    inputs.update({f"init/{k}": v
                   for k, v in _seeded(MLP_SHAPES, 11).items()})
    guard_shapes = {"MLP.linear1.W": (8, 16), "MLP.linear1.b": (16,),
                    "MLP.linear2.W": (16, 4), "MLP.linear2.b": (4,)}
    inputs.update({f"ginit/{k}": v
                   for k, v in _seeded(guard_shapes, 2).items()})
    rng = np.random.RandomState(5)
    for step in range(ranks.GUARD_STEPS):
        gx = rng.randn(16, 8).astype(np.float32)
        if step == ranks.POISONED:
            gx[9, 3] = np.nan           # rank 1's half: rows 8-15
        inputs[f"gx{step}"] = gx
        inputs[f"gy{step}"] = np.eye(4, dtype=np.float32)[
            rng.randint(0, 4, 16)]
    dx, dy, dinit = _drop_data()
    inputs.update({"dx": dx, "dy": dy})
    inputs.update({f"dinit/{k}": v for k, v in dinit.items()})
    return inputs


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """``{world: (rank outputs, work directory)}`` for 2 and 4 ranks."""
    inputs = _inputs()
    work2 = tmp_path_factory.mktemp("gspmd2")
    outs2, _ = ranks.launch("gspmd", 2, dict(inputs, workdir=str(work2)),
                            work2)
    work4 = tmp_path_factory.mktemp("gspmd4")
    outs4, _ = ranks.launch("gspmd", 4, dict(
        inputs, workdir=str(work4), archive=str(work2 / "zero.zip")), work4)
    TCTX.training = False
    return {2: (outs2, work2), 4: (outs4, work4)}


def _states(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/state/")
            or k.startswith(prefix + "/opt/")}


def _bitwise(got, want, what):
    assert sorted(got) == sorted(want) and want, what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


# -- in this process: the spec vocabulary, the train mesh, the declines ------

@pytest.fixture(scope="module")
def jax_meshes():
    devs = jax.devices("cpu")
    return {"dp4": jmesh.make_mesh(devs[:4], jmesh.MeshConfig()),
            "dp4_tp2": jmesh.make_mesh(devs[:8], jmesh.MeshConfig(model=2)),
            "dp1": jmesh.make_mesh(devs[:1], jmesh.MeshConfig())}


SPEC_CASES = [
    (None, (8, 4)), (None, (6,)), (None, ()), (None, (3, 5)),
    (None, (6, 8)), (None, (10,)), (None, (64, 3, 3, 3)),
    ((), (8, 4)), (("model",), (8, 8)), (("model",), (6, 8)),
    ((None, "model"), (8, 6)), ((None, "model"), (8, 16)),
    (("model", None), (31, 8)), (("expert",), (4, 8)),
    ((("model", "expert"),), (8, 4)), (("data",), (8,))]


@pytest.mark.parametrize("mesh_name", ["dp4", "dp4_tp2", "dp1"])
def test_specs_match_the_jax_package(jax_meshes, mesh_name):
    """``fit_state_spec`` and ``fsdp_state_spec`` case by case, on the
    JAX mesh and on its axis table."""
    msh = jax_meshes[mesh_name]
    sizes = dict(msh.shape)
    for spec, shape in SPEC_CASES:
        jspec = None if spec is None else jax.sharding.PartitionSpec(*spec)
        tspec = None if spec is None else gspmd.P(*spec)
        assert tuple(gspmd.fit_state_spec(tspec, shape, sizes)) == tuple(
            jgspmd.fit_state_spec(jspec, shape, msh)), (spec, shape)
        for axis in ("data", "model", "pipe"):
            want = jgspmd.fsdp_state_spec(jspec, shape, msh, axis=axis)
            got = gspmd.fsdp_state_spec(tspec, shape, sizes, axis=axis)
            assert tuple(got) == tuple(want), (spec, shape, axis)
    with pytest.raises(jgspmd.ShardingDecline):
        jgspmd.fsdp_state_spec(None, (8,), msh, axis="nonexistent")
    with pytest.raises(gspmd.ShardingDecline):
        gspmd.fsdp_state_spec(None, (8,), sizes, axis="nonexistent")


def test_vocabulary_matches_the_jax_package():
    for name in ("replicated_spec", "col_spec", "col_bias_spec", "row_spec",
                 "vocab_spec", "expert_spec", "batch_spec"):
        assert tuple(getattr(gspmd, name)()) == tuple(
            getattr(jgspmd, name)()), name
    assert tuple(gspmd.batch_spec(rank=3)) == tuple(jgspmd.batch_spec(rank=3))
    assert (gspmd.BATCH_AXIS, gspmd.MODEL_AXIS, gspmd.DATA_AXIS) == (
        jgspmd.BATCH_AXIS, jgspmd.MODEL_AXIS, jgspmd.DATA_AXIS)


def test_fsdp_dim_at_degree_one_is_where_any_degree_shards():
    """At degree 1 the layout shards the dimension the spec would name at
    any degree, so one card runs the gathers and scatters of D ranks."""
    one = {"data": 1}
    assert gspmd.fsdp_dim(None, (8, 4), one) == 0
    assert gspmd.fsdp_dim(gspmd.P("model"), (8, 4), {"data": 1,
                                                      "model": 2}) == 1
    assert gspmd.fsdp_dim(None, (), one) is None
    assert gspmd.fsdp_dim(None, (6,), {"data": 4}) is None
    assert gspmd.fsdp_dim(None, (6, 8), {"data": 4}) == 1


TRAIN_MESH_CASES = [(8, dict(data=2, model=2, stage=2)),
                    (8, dict(data=2, model=1)), (8, dict(model=2)),
                    (4, dict(data=4, model=2)), (4, dict(model=0)),
                    (4, dict(model=3)), (4, dict()), (4, dict(data=4)),
                    (2, dict(stage=2)), (4, dict(data=3))]


@pytest.mark.parametrize("n,kw", TRAIN_MESH_CASES,
                         ids=[f"{n}-{kw}" for n, kw in TRAIN_MESH_CASES])
def test_train_mesh_degrees_match_the_jax_package(n, kw):
    """``train_degrees`` decides as ``gspmd.train_mesh`` does on ``n``
    devices: the same degrees and device count, or both decline."""
    devs = jax.devices("cpu")[:n]
    try:
        msh = jgspmd.train_mesh(devs, **kw)
    except jgspmd.ShardingDecline:
        with pytest.raises(gspmd.ShardingDecline):
            gspmd.train_degrees(n, **kw)
        return
    got = gspmd.train_degrees(n, **kw)
    assert got == {a: msh.shape[a] for a in ("data", "model", "pipe")}
    assert got["data"] * got["model"] * got["pipe"] == msh.devices.size


@pytest.mark.parametrize("driver", ["backward_and_update_half",
                                    "backward_and_partial_update",
                                    "backward_and_sparse_update"])
def test_zero_declines_the_specialised_drivers(driver):
    """``tests/test_gspmd_train.py::TestZeroDriverDeclines``."""
    d = topt.DistOpt(topt.SGD(lr=0.1), zero=True)
    with pytest.raises(gspmd.ShardingDecline, match="zero=True"):
        getattr(d, driver)(None)
    plain = topt.DistOpt(topt.SGD(lr=0.1))
    with pytest.raises(Exception) as e:
        getattr(plain, driver)(None)
    assert not isinstance(e.value, gspmd.ShardingDecline)


def test_the_serving_half_names_the_roadmap():
    for name in ("serving_mesh", "serving_partitioner", "lm_param_specs",
                 "ring_cache_specs", "pool_specs", "serving_arg_specs"):
        with pytest.raises(NotImplementedError, match="slice D"):
            getattr(gspmd, name)()
    with pytest.raises(NotImplementedError, match="slice D"):
        gspmd.Partitioner(None)


def test_zero_outside_its_models_step_declines():
    """The plain driver of ``DistOpt(zero=True)`` outside the train step
    of the model it was compiled with would keep replicated states."""
    d = topt.DistOpt(topt.SGD(lr=0.1), zero=True)
    with pytest.raises(gspmd.ShardingDecline, match="zero=True"):
        d.reduced_mean([])


# -- the ranks ---------------------------------------------------------------

class MLP(jmodel.Model):
    """``tests/test_gspmd_train.py::MLP``."""

    def __init__(self):
        super().__init__()
        self.fc1 = jlayer.Linear(16)
        self.relu = jlayer.ReLU()
        self.fc2 = jlayer.Linear(4)
        self.loss_fn = jlayer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self.optimizer(loss)
        return out, loss


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's GSPMD step (``zero=False``) and FSDP step
    (``zero=True``) over four CPU devices: losses and states."""
    msh = jmesh.make_mesh(jax.devices("cpu")[:4], jmesh.MeshConfig())
    set_mesh(msh)
    out = {}
    try:
        for zero in (False, True):
            dev = jdevice.create_cpu_device()
            x, y = _xy()
            tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
            ty = jtensor.Tensor(data=y, device=dev, requires_grad=False)
            m = MLP()
            d = jopt.DistOpt(jopt.SGD(lr=0.1, momentum=0.9), world_size=4,
                             zero=zero)
            d.communicator.mesh = msh
            m.set_optimizer(d)
            m.compile([tx], is_train=True, use_graph=True, mesh=msh)
            live = m.get_states()
            for k, v in _seeded(MLP_SHAPES, 11).items():
                live[k].copy_from_numpy(v)
            losses = [float(np.asarray(m(tx, ty)[1].data))
                      for _ in range(ranks.GSPMD_STEPS)]
            states = {f"state/{k}": np.asarray(v.data, np.float32)
                      for k, v in m.get_states().items()}
            states.update({f"opt/{k}": np.asarray(v, np.float32)
                           for k, v in d.get_states().items()})
            out[zero] = (np.asarray(losses), states)
    finally:
        set_mesh(None)
        jmodel.CTX.training = False
    return out


@pytest.mark.parametrize("kind,zero", [("mesh_dist", False),
                                       ("mesh_plain", False),
                                       ("zero", True), ("fsdp_plain", True)])
def test_four_ranks_match_the_jax_gspmd_and_fsdp_steps(ranked, jax_runs,
                                                       kind, zero):
    outs, _ = ranked[4]
    want_losses, want = jax_runs[zero]
    for o in outs:                       # the loss is the mean over ranks
        np.testing.assert_array_equal(o[f"{kind}/losses"],
                                      outs[0][f"{kind}/losses"])
    np.testing.assert_allclose(outs[0][f"{kind}/losses"], want_losses,
                               rtol=STATE_TOL)
    got = _states(outs[0], kind)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= STATE_TOL * np.abs(w).max(), k


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ranks.GSPMD_RUNS[1:])
def test_each_spelling_is_bitwise_the_plain_dist_opt(ranked, world, kind):
    """``compile(mesh=)`` (with a ``DistOpt`` or a plain ``SGD``) and
    ZeRO/FSDP (``zero=True``, ``fsdp_axis="data"``) against the plain
    ``DistOpt``: losses, states and momenta bitwise, on every rank."""
    outs, _ = ranked[world]
    for o in outs:
        np.testing.assert_array_equal(o[f"{kind}/losses"], o["dist/losses"])
        _bitwise(_states(o, kind), _states(o, "dist"), kind)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_holds_a_world_th_of_the_state_bytes(ranked, world):
    """``TestFsdp``: a rank's state bytes (parameters, momenta, step
    counter, loss scale) against their full size, > 0.8 x the world; a
    replicated run holds all of them."""
    outs, _ = ranked[world]
    for o in outs:
        for kind in ("zero", "fsdp_plain"):
            per_rank, full = o[f"{kind}/bytes"]
            assert full / per_rank > 0.8 * world, (kind, per_rank, full)
        per_rank, full = o["dist/bytes"]
        assert per_rank == full


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_per_step_by_kind(ranked, world):
    """A replicated step: one all-reduce per gradient (4) and the mean
    loss's; a ZeRO step: a gather and a scatter per parameter (every
    MLP tensor divides by 2 and 4) and only the mean loss's all-reduce."""
    outs, _ = ranked[world]
    kinds = list(ranks.GSPMD_RUNS)
    for o in outs:
        for kind in kinds:
            got = dict(zip(("all_reduce", "all_gather", "reduce_scatter",
                            "broadcast"), o[f"{kind}/collectives"].tolist()))
            if kind in ("zero", "fsdp_plain"):
                assert got == {"all_reduce": 1, "all_gather": 4,
                               "reduce_scatter": 4, "broadcast": 0}, kind
            else:
                assert got == {"all_reduce": 5, "all_gather": 0,
                               "reduce_scatter": 0, "broadcast": 0}, kind


@pytest.mark.parametrize("world", [2, 4])
def test_communicator_gathers_and_scatters_along_dims_0_and_1(ranked,
                                                              world):
    outs, _ = ranked[world]
    a = sum(np.arange(6.0 * world).reshape(2 * world, 3) + r
            for r in range(world))
    b = sum(np.arange(6.0 * world).reshape(3, 2 * world) + 10.0 * r
            for r in range(world))
    c = [np.arange(6.0).reshape(2, 3) + 100.0 * r for r in range(world)]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["comm/reduce_scatter0"],
                                      a[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["comm/reduce_scatter1"],
                                      b[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["comm/all_gather0"],
                                      np.concatenate(c, 0))
        np.testing.assert_array_equal(o["comm/all_gather1"],
                                      np.concatenate(c, 1))
        # all_reduce, all_gather, reduce_scatter, broadcast: one a call
        np.testing.assert_array_equal(o["comm/counts"], [0, 2, 2, 0])


@pytest.mark.parametrize("world", [2, 4])
def test_train_mesh_declines_in_the_ranks(ranked, world):
    """``stage`` > 1 and a subset of the ranks are declined; ``model=2``
    builds the data x model mesh over every rank, in the JAX package's
    axis order (its training: ``tests/test_torch_lm_tp_fsdp.py``)."""
    outs, _ = ranked[world]
    for o in outs:
        assert str(o["decline/model"]) == ""
        assert o["mesh/model"].tolist() == [str(("data", "model")),
                                            str((world // 2, 2))]
        assert str(o["decline/stage"]).startswith("NotImplementedError")
        assert "slice E" in str(o["decline/stage"])
        assert str(o["decline/subset"]).startswith("ShardingDecline")


def _archive(path):
    with zipfile.ZipFile(path) as zf:
        attr = json.loads(zf.read("states_attr.json"))
        with np.load(io.BytesIO(zf.read("tensor_dict.npz"))) as z:
            arrays = {k: z[k] for k in z.files}
    return attr, arrays


def test_a_zero_archive_is_a_replicated_runs(ranked):
    """Two ranks: the ZeRO run's archive (rank 0 wrote it) holds exactly
    the names, shapes, dtypes and values of the replicated run's."""
    _, work = ranked[2]
    attr, arrays = _archive(work / "zero.zip")
    for r in range(2):
        rattr, rarrays = _archive(work / f"rep{r}.zip")
        assert attr == rattr
        _bitwise(arrays, rarrays, f"rep{r}.zip")


@pytest.mark.parametrize("world", [2, 4])
def test_a_zero_archive_restores_into_ranks(ranked, world):
    """Into a ZeRO model of 2 ranks and of 4: every state gathered back
    equals the saved run's."""
    outs, _ = ranked[world]
    want = _states(ranked[2][0][0], "zero")
    for o in outs:
        _bitwise(_states(o, f"restored{world}"), want, f"restored{world}")
        per_rank, full = o[f"restored{world}/bytes"]
        assert full / per_rank > 0.8 * world


def test_a_zero_archive_restores_into_one_port_model_and_the_jax_package(
        ranked):
    _, work = ranked[2]
    _, arrays = _archive(work / "zero.zip")
    # one port model, no process group
    dev = tdevice.create_cpu_device()
    m = ranks.gspmd_mlp()
    m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    x, _y = _xy()
    m.compile([ttensor.Tensor(data=x, device=dev)], is_train=True)
    m.load_states(str(work / "zero.zip"))
    got = {k: v.to_numpy() for k, v in m.get_states().items()}
    got.update({f"optimizer/{k}": v
                for k, v in m.optimizer.get_states().items()})
    _bitwise(got, arrays, "port")
    TCTX.training = False
    # the JAX package
    jdev = jdevice.create_cpu_device()
    jm = MLP()
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jm.compile([jtensor.Tensor(data=x, device=jdev, requires_grad=False)],
               is_train=True)
    jm.load_states(str(work / "zero.zip"))
    jgot = {k: np.asarray(v.data) for k, v in jm.get_states().items()}
    jgot.update({f"optimizer/{k}": np.asarray(v)
                 for k, v in jm.optimizer.get_states().items()})
    _bitwise(jgot, arrays, "jax")
    jmodel.CTX.training = False


def test_bf16_mixed_fsdp_guard_matches_the_unsharded_guard(ranked):
    """``GuardedOptimizer(DistOpt(zero=True))`` under ``bf16_mixed``
    against ``GuardedOptimizer(DistOpt())``, 5 steps, rank 1's half of
    step ``POISONED`` holding a NaN: the same verdicts, loss scale and
    streaks on both ranks, the norm within ``NORM_RTOL``, the poisoned
    step a no-op on both ranks, the states bitwise and sharded."""
    outs, _ = ranked[2]
    for o in outs:
        for step in range(ranks.GUARD_STEPS):
            for k in ("loss_scale", "bad_streak", "good_streak",
                      "skipped_total"):
                assert o[f"guard_zero/{k}{step}"] == \
                    o[f"guard_rep/{k}{step}"] == \
                    outs[0][f"guard_zero/{k}{step}"], (k, step)
            norm, ref = o[f"guard_zero/grad_norm{step}"], \
                o[f"guard_rep/grad_norm{step}"]
            if step == ranks.POISONED:
                assert np.isnan(norm) and np.isnan(ref)
            else:
                np.testing.assert_allclose(norm, ref, rtol=NORM_RTOL)
                np.testing.assert_array_equal(
                    o[f"guard_zero/loss{step}"], o[f"guard_rep/loss{step}"])
        assert int(o[f"guard_zero/skipped_total{ranks.GUARD_STEPS - 1}"]) \
            == 1
        before, after = _states(o, "guard_zero/before"), \
            _states(o, "guard_zero/after")
        for k in before:
            if k.startswith("opt/guard/") or k == "opt/loss_scale":
                continue
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        _bitwise(_states(o, "guard_zero/final"),
                 _states(o, "guard_rep/final"), "guard")
        per_rank, full = o["guard_zero/final/bytes"]
        assert full / per_rank > 1.6


def test_f64_dropout_and_sync_bn_equal_one_rank_on_the_whole_batch(ranked):
    """Two ranks under ``compile(mesh=)`` draw the global batch's dropout
    mask and keep their rows, and sync-BN's moments are the global
    batch's: in f64 they equal one rank's whole-batch run within
    ``F64_TOL``, masks included."""
    import torch
    outs, _ = ranked[2]
    x, y, init = _drop_data()
    dev = tdevice.create_cpu_device()
    dev.SetRandSeed(ranks.DROP_SEED)
    m = ranks.as_float64(ranks._compiled(
        ranks.drop_bn_model(), dev, x, topt.SGD(lr=0.1, momentum=0.9),
        init))
    tx = ttensor.Tensor(data=torch.from_numpy(x).double(), device=dev)
    ty = ttensor.Tensor(data=torch.from_numpy(y).double(), device=dev)
    losses = [float(m(tx, ty)[1].data.detach())
              for _ in range(ranks.DROP_STEPS)]
    ref = {}
    ranks._states(m, "one", ref)
    TCTX.training = False
    for o in outs:
        np.testing.assert_allclose(o["drop64/losses"], losses, rtol=F64_TOL,
                                   atol=0)
        got = _states(o, "drop64")
        want = _states(ref, "one")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= F64_TOL * max(
                1.0, np.abs(w).max()), k
