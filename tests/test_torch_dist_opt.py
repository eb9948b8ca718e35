"""The port's ``DistOpt`` over four gloo ranks against the JAX package's
``DistOpt`` over a four-device CPU mesh.

The ranks are processes of ``tests/torch_dist_ranks.py``, started once
for the module (``dist_opt`` case, a 120 s deadline for all of them).
Each takes its ``datasets.partition`` of the 64-row batch of
``tests/test_parallel.py::TestDistOptions`` and trains that test's MLP
(8 -> 16 -> 4) with ``DistOpt(SGD(lr=0.1, momentum=0.9))`` in graph mode,
weights made from a numpy seed and carried into both packages. The JAX
side runs the same global batch through its compiled ``shard_map`` step
over ``jax.devices("cpu")[:4]``.

Tolerances (measured maxima in ``CHANGES.md``): ``plain`` and
``partialUpdate`` losses within rtol 1e-5 and every state within 1e-5 of
its largest magnitude; ``half`` and ``fp16`` losses within rtol 1e-3 of
JAX's and within the JAX test's own rtol 0.05 of the single-device f32
run; ``sparseTopK`` (0.3) and ``sparseThreshold`` (1e-3) the same kept
entries on every rank at step 1, where both packages see the same inputs
(a mask is discrete, and later a gradient within rounding of the
threshold may flip), and losses within rtol 1e-4.
"""

import numpy as np
import pytest

import jax

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import mlp as jmlp
from singa_tpu.parallel import mesh as jmesh

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import mlp as tmlp

import torch_dist_ranks as ranks

WORLD = 4


def _data():
    rng = np.random.RandomState(2)
    x = rng.randn(64, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)]
    return x, y


def _init():
    rng = np.random.RandomState(11)
    shapes = {"MLP.linear1.W": (8, 16), "MLP.linear1.b": (16,),
              "MLP.linear2.W": (16, 4), "MLP.linear2.b": (4,)}
    return {k: (rng.randn(*s) * (np.sqrt(1.0 / s[0]) if k.endswith("W")
                                 else 0.2)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    x, y = _data()
    inputs = {"x": x, "y": y}
    inputs.update({f"init/{k}": v for k, v in _init().items()})
    outs, _ = ranks.launch("dist_opt", WORLD, inputs,
                           tmp_path_factory.mktemp("dist_opt"))
    TCTX.training = False
    return outs


def _jax_run(option, spars, steps):
    """Losses, states (device 0's replica) and each device's kept entries
    at step 1 of the JAX ``DistOpt`` over the four-device mesh."""
    x, y = _data()
    dev = jdevice.create_cpu_device()
    m = jmlp.create_model(data_size=8, perceptron_size=16, num_classes=4)
    d = jopt.DistOpt(jopt.SGD(lr=0.1, momentum=0.9))
    d.communicator.mesh = jmesh.make_mesh(jax.devices("cpu")[:WORLD],
                                          jmesh.MeshConfig())
    m.set_optimizer(d)
    tx = jtensor.Tensor(data=x, device=dev, requires_grad=False)
    ty = jtensor.Tensor(data=y, device=dev, requires_grad=False)
    m.compile([tx], is_train=True, use_graph=True)
    live = m.get_states()
    for k, v in _init().items():
        live[k].copy_from_numpy(v)
    losses, kept = [], {}
    for step in range(steps):
        losses.append(float(np.asarray(m(tx, ty, option, spars)[1].data)))
        if step == 0:
            for k, res in d._residuals.items():
                shards = sorted(res.data.addressable_shards,
                                key=lambda s: s.device.id)
                kept[k] = [np.asarray(s.data) == 0 for s in shards]
    states = {k: np.asarray(v.data, np.float32)
              for k, v in m.get_states().items()}
    return np.asarray(losses), states, kept


def _single_device_losses(steps=6):
    x, y = _data()
    dev = tdevice.create_cpu_device()
    m = tmlp.create_model(data_size=8, perceptron_size=16, num_classes=4)
    m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    tx, ty = ttensor.Tensor(data=x, device=dev), \
        ttensor.Tensor(data=y, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(m, _init())
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(steps)]
    TCTX.training = False
    return np.asarray(losses)


@pytest.mark.parametrize("option", sorted(ranks.OPTIONS))
def test_option_matches_the_jax_dist_opt(ranked, option):
    spars, steps = ranks.OPTIONS[option]
    want_losses, want_states, want_kept = _jax_run(option, spars, steps)
    losses = [o[f"{option}/losses"] for o in ranked]
    assert len(losses[0]) == steps and np.all(np.isfinite(losses[0]))
    for other in losses[1:]:           # the loss is the mean over ranks
        np.testing.assert_array_equal(other, losses[0])
    if option in ("plain", "partialUpdate"):
        np.testing.assert_allclose(losses[0], want_losses, rtol=1e-5)
        for k, want in want_states.items():
            got = ranked[0][f"{option}/state/{k}"]
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
    elif option in ("half", "fp16"):
        np.testing.assert_allclose(losses[0], want_losses, rtol=1e-3)
        np.testing.assert_allclose(losses[0], _single_device_losses(steps),
                                   rtol=0.05)
    else:
        np.testing.assert_allclose(losses[0], want_losses, rtol=1e-4)
        assert sorted(want_kept) == sorted(
            k.split("/kept1/")[1] for k in ranked[0]
            if k.startswith(f"{option}/kept1/"))
        for k, per_device in want_kept.items():
            for r in range(WORLD):
                np.testing.assert_array_equal(
                    ranked[r][f"{option}/kept1/{k}"], per_device[r],
                    err_msg=f"rank {r} {k}")
    # replicas stay equal, except under partialUpdate, whose unselected
    # parameters take each rank's local gradient (reference opt.py:922-992)
    agree = [o[f"{option}/agree"] for o in ranked]
    if option == "partialUpdate":
        assert not agree[0][-1]
    else:
        assert all(a.all() for a in agree)


def test_static_rotation_reduces_only_its_partition(ranked):
    """``test_partial_update_static_rotation_saves_comm``: one graph per
    rotation value; a static rotation's step starts at most
    ``fallback // n + 1`` collectives, the traced fallback one per
    gradient."""
    for o in ranked:
        assert int(o["rot/n_graphs"]) == WORLD
        losses = o["rot/losses"]
        assert losses[-1] < losses[0] * 0.9, losses
        fallback, static = int(o["rot/fallback"]), int(o["rot/static"])
        assert fallback >= 4, fallback
        assert static <= max(1, fallback // WORLD + 1), (static, fallback)


def test_alternating_options_keep_one_graph_each(ranked):
    """``test_static_arg_cache_switches_options``."""
    for o in ranked:
        assert int(o["cache/n_graphs"]) == 2
        assert np.all(np.isfinite(o["cache/losses"]))


def test_communicator_primitives_and_mesh(ranked):
    for r, o in enumerate(ranked):
        assert int(o["comm/rank"]) == r and int(o["comm/world"]) == WORLD
        np.testing.assert_array_equal(
            o["comm/all_gather"],
            np.repeat(np.arange(WORLD, dtype=np.float32), 2).reshape(-1, 2))
        full = sum(np.arange(2.0 * WORLD) + s for s in range(WORLD))
        np.testing.assert_array_equal(o["comm/reduce_scatter"],
                                      full[2 * r:2 * r + 2])
        # one reduce_scatter_tensor / all_gather_into_tensor a call, along
        # dimension 0 and 1 (counted by kind: all_reduce, all_gather,
        # reduce_scatter, broadcast)
        a = sum(np.arange(6.0 * WORLD).reshape(2 * WORLD, 3) + s
                for s in range(WORLD))
        b = sum(np.arange(6.0 * WORLD).reshape(3, 2 * WORLD) + 10.0 * s
                for s in range(WORLD))
        c = [np.arange(6.0).reshape(2, 3) + 100.0 * s for s in range(WORLD)]
        np.testing.assert_array_equal(o["comm/reduce_scatter0"],
                                      a[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["comm/reduce_scatter1"],
                                      b[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["comm/all_gather0"],
                                      np.concatenate(c, 0))
        np.testing.assert_array_equal(o["comm/all_gather1"],
                                      np.concatenate(c, 1))
        np.testing.assert_array_equal(o["comm/counts"], [0, 2, 2, 0])
        np.testing.assert_array_equal(o["comm/broadcast"], np.ones(3))
        total = sum(s + 1 for s in range(WORLD))
        np.testing.assert_array_equal(o["comm/all_reduce_grad"],
                                      np.full(2, total))
        np.testing.assert_array_equal(o["comm/all_reduce_grad_grad"],
                                      np.full(2, total))
        assert int(o["mesh/size"]) == WORLD
        np.testing.assert_array_equal(o["mesh/all_reduce"],
                                      np.full(2, WORLD))
        # the model and expert axes are ported: each a group of its own
        # over every rank, in the JAX rank layout
        assert o["mesh/model"].tolist() == [str(("data", "model")),
                                            str((1, WORLD))]
        assert o["mesh/expert"].tolist() == [str(("data", "expert")),
                                             str((1, WORLD))]
        np.testing.assert_array_equal(o["mesh/expert_group"],
                                      [WORLD, r, r])
        assert not bool(o["fingerprint/differs"])
        # DistOpt's world is the group's; a world that disagrees raises
        np.testing.assert_array_equal(o["comm/dist_world"], [WORLD, r])
        assert "disagrees" in str(o["comm/wrong_world"])


def test_outside_a_process_group_the_communicator_is_the_identity():
    import torch
    from singa_tpu_torch.parallel import communicator as C
    comm = C.Communicator()
    t = torch.arange(3.0)
    assert comm.all_reduce(t) is t and comm.effective_world_size() == 1
    assert comm.all_gather(t) is t and comm.rank() == 0
    gathered, agree = C.replica_fingerprint([t], comm)
    assert gathered.shape == (1, 2) and bool(agree)
    d = topt.DistOpt(topt.SGD())
    assert d.world_size == 1 and d.global_rank == 0
    assert topt.DistOpt(topt.SGD(), world_size=1).world_size == 1
    with pytest.raises(ValueError, match="disagrees"):
        topt.DistOpt(topt.SGD(), world_size=4)
    assert C.rescale_batch({"world": 4, "global_batch": 64}, 2) == (16, 32)


def test_what_is_not_ported_names_the_roadmap():
    """Ported since: ZeRO/FSDP (``tests/test_torch_gspmd_train.py``) and
    ``reduce_axes`` beyond ``data`` (the LM over a ``seq`` axis,
    ``tests/test_torch_lm_sp.py``): here the JAX package's communicator of
    the same axes, outside any mesh a world of one in both."""
    assert topt.DistOpt(topt.SGD(), zero=True).zero
    axes = ("data", "expert", "seq")
    d = topt.DistOpt(topt.SGD(), reduce_axes=axes)
    jd = jopt.DistOpt(jopt.SGD(), reduce_axes=axes)
    assert d.communicator.reduce_axes == jd.communicator.reduce_axes == axes
    assert d.communicator.effective_world_size() == \
        jd.communicator.effective_world_size() == 1
    with pytest.raises(ValueError):
        topt.DistOpt(topt.SGD(), bucket_mb=-1)
    with pytest.raises(ValueError, match="float16"):
        topt.DistOpt(topt.SGD()).backward_and_update_half(None,
                                                          dtype="int8")


class TestStreamSemantics:
    """``grad_reduce_stream``'s bookkeeping outside a process group (the
    sum is the identity there), as ``tests/test_grad_bucketing.py::
    TestStreamSemantics`` holds the JAX package's."""

    @staticmethod
    def _pairs(shapes, dtypes=None):
        import torch
        out = []
        for i, shape in enumerate(shapes):
            dt = (dtypes or {}).get(i, torch.float32)
            p = ttensor.Tensor(shape=shape, dtype=dt,
                               device=tdevice.create_cpu_device(),
                               name=f"p{i}")
            g = ttensor.Tensor(data=torch.full(shape, float(i + 1),
                                               dtype=dt), device=p.device)
            out.append((p, g))
        return out

    def test_values_and_order_preserved(self):
        d = topt.DistOpt(topt.SGD(lr=0.1), bucket_mb=0.0001)
        pairs = self._pairs([(100,), (50, 3), (7,), (4000,)])
        before = [g.data.clone() for _p, g in pairs]
        got = list(d.grad_reduce_stream(iter(pairs)))
        assert [p.name for p, _g in got] == ["p0", "p1", "p2", "p3"]
        for (_p, g), b in zip(got, before):
            assert g.data.shape == b.shape and bool((g.data == b).all())

    def test_mixed_dtypes_never_share_a_bucket(self):
        import torch
        d = topt.DistOpt(topt.SGD(lr=0.1), bucket_mb=64)
        pairs = self._pairs([(64,), (64,), (64,)], {1: torch.bfloat16})
        got = {p.name: g.data for p, g in d.grad_reduce_stream(pairs)}
        assert got["p1"].dtype == torch.bfloat16
        assert got["p0"].dtype == got["p2"].dtype == torch.float32
        assert bool((got["p1"].float() == 2.0).all())

    def test_wire_cast_back_rule(self):
        """An f32 gradient cast to the wire comes back f32; one already in
        the wire dtype keeps it."""
        import torch
        d = topt.DistOpt(topt.SGD(lr=0.1), bucket_mb=64)
        pairs = self._pairs([(64,), (64,)], {1: torch.bfloat16})
        got = {p.name: g.data for p, g in
               d.grad_reduce_stream(pairs, wire=torch.bfloat16)}
        assert got["p0"].dtype == torch.float32
        assert got["p1"].dtype == torch.bfloat16

    def test_specialised_drivers_warn_once_when_bucketing_is_set(self):
        import warnings
        d = topt.DistOpt(topt.SGD(lr=0.1), bucket_mb=4)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            d._warn_driver_skips_bucketing("backward_and_update_half")
            d._warn_driver_skips_bucketing("backward_and_update_half")
        assert len(rec) == 1 and "backward_and_update_half" in str(
            rec[0].message)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            topt.DistOpt(topt.SGD(lr=0.1))._warn_driver_skips_bucketing(
                "backward_and_update_half")
        assert not rec

    def test_half_wire_defaults_follow_the_policy(self):
        import torch
        from singa_tpu_torch import mixed_precision as mp
        assert topt.DistOpt._half_wire_defaults(None, False) == \
            ("bfloat16", False)
        assert topt.DistOpt._half_wire_defaults("float16", False) == \
            ("float16", False)
        with mp.policy_scope("float16_mixed"):
            assert topt.DistOpt._half_wire_defaults(None, False) == \
                ("float16", True)
        with mp.policy_scope("bf16_mixed"):
            assert topt.DistOpt._half_wire_defaults(None, False) == \
                (torch.bfloat16, False)
        assert mp.Policy("float32").comm_dtype is None
        assert mp.Policy("bf16_mixed").comm_dtype == torch.bfloat16

    def test_reduced_mean_divides_once_by_the_world(self):
        """``reduced_mean`` (the plain and the guarded drivers' one
        reduction) returns the sum over the ranks divided by the world,
        once: here the sum is the identity and the world is made 4."""
        import torch
        d = topt.DistOpt(topt.SGD(lr=0.1), bucket_mb=64)
        d.communicator.effective_world_size = lambda exclude=(): 4
        pairs = self._pairs([(8,), (3, 2)])
        got = d.reduced_mean(iter(pairs), wire=torch.bfloat16)
        assert [p.name for p, _g in got] == ["p0", "p1"]
        for i, (_p, g) in enumerate(got):
            assert g.data.dtype == torch.float32
            assert bool((g.data == (i + 1) / 4).all())
