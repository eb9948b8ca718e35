"""The guard over a ``DistOpt``, and bucketed gradient reduction, at two
gloo ranks.

The ranks (``tests/torch_dist_ranks.py``, ``guard`` case) start once for
the module:

- ``tests/test_grad_bucketing.py``'s MLP (8 -> 64 -> 64 -> 4), 4 steps of
  ``DistOpt(SGD(lr=0.1, momentum=0.9))`` on each rank's half of 16 rows,
  per-gradient (streaming) and with every bucketing and overlap setting of
  ``TestParity``, in f32 and under ``bf16_mixed`` (the bf16 wire): every
  state bitwise equal to the streaming run's. Two ranks sum a + b, which
  does not depend on where an element sits in a bucket; the bucketed
  runs start fewer collectives.
- ``GuardedOptimizer(DistOpt(SGD(lr=0.1, momentum=0.9)), init_scale=16,
  growth_interval=2)`` under ``bf16_mixed``, 5 steps on fresh batches,
  rank 1's half of step 2's batch holding a NaN: both ranks skip it, their
  states bitwise unchanged by it, and after each step the loss scale, the
  streaks and ``skipped_total`` equal the JAX package's guarded
  ``DistOpt`` over a two-device CPU mesh on the same global batches. The
  gradient math is held too: the loss and the unscaled gradient norm of
  every good step, and the final parameters and momenta, within
  ``tests/test_torch_guarded_training.py``'s bf16_mixed bounds of the JAX
  run (a missing or doubled division by the world moves the norm by
  50-100%), and bitwise equal to the unguarded ``DistOpt`` under
  ``bf16_mixed`` without loss scaling on the good steps alone (the same
  reduction and wire; the guard's scales are powers of two, so scaling
  and unscaling are exact).
"""

import numpy as np
import pytest

import jax

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import mlp as jmlp
from singa_tpu.parallel import mesh as jmesh
from singa_tpu.resilience import GuardedOptimizer as JGuard

import torch_dist_ranks as ranks

WORLD = 2
STATS = ("loss_scale", "bad_streak", "good_streak", "skipped_total")
# the guarded run against the JAX package's under bf16_mixed, 5 steps:
# both round each op's result to bf16, at other places inside, as
# tests/test_torch_guarded_training.py has it (its LOSS_RTOL and
# STATE_TOL); measured: losses 7.5e-4, the gradient norm 1.1e-3, states
# and momenta 5.8e-3 of each tensor's max. A missing or doubled division
# by the world moves the norm and the momenta by 50-100%.
GUARD_LOSS_RTOL = 1e-2
GUARD_NORM_RTOL = 1e-2
GUARD_STATE_TOL = 1e-2


def _seeded(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * (np.sqrt(1.0 / s[0]) if k.endswith(".W")
                                 else 0.2)).astype(np.float32)
            for k, s in shapes.items()}


def _inputs():
    rng = np.random.RandomState(0)
    inputs = {"bx": rng.randn(16, 8).astype(np.float32),
              "by": np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]}
    bucket_shapes = {"MLP.fc1.W": (8, 64), "MLP.fc1.b": (64,),
                     "MLP.fc2.W": (64, 64), "MLP.fc2.b": (64,),
                     "MLP.fc3.W": (64, 4), "MLP.fc3.b": (4,)}
    inputs.update({f"binit/{k}": v
                   for k, v in _seeded(bucket_shapes, 1).items()})
    guard_shapes = {"MLP.linear1.W": (8, 16), "MLP.linear1.b": (16,),
                    "MLP.linear2.W": (16, 4), "MLP.linear2.b": (4,)}
    inputs.update({f"ginit/{k}": v
                   for k, v in _seeded(guard_shapes, 2).items()})
    for step in range(ranks.GUARD_STEPS):
        x = rng.randn(16, 8).astype(np.float32)
        if step == ranks.POISONED:
            x[9, 3] = np.nan            # rank 1's half: rows 8-15
        inputs[f"gx{step}"] = x
        inputs[f"gy{step}"] = np.eye(4, dtype=np.float32)[
            rng.randint(0, 4, 16)]
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    outs, _ = ranks.launch("guard", WORLD, inputs,
                           tmp_path_factory.mktemp("dist_guard"))
    return inputs, outs


def _states(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/state/")
            or k.startswith(prefix + "/opt/")}


@pytest.mark.parametrize("name", sorted(ranks.BUCKETINGS))
def test_bucketed_matches_streaming_bitwise(runs, name):
    _, outs = runs
    for o in outs:
        ref, got = _states(o, "stream"), _states(o, name)
        assert sorted(ref) == sorted(got) and ref
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # a step: one collective per gradient (6) when streaming, one for all
    # six in a 4 MiB bucket, and one for the mean loss
    streaming = int(outs[0]["stream/collectives"])
    assert streaming == 4 * (6 + 1)
    n = int(outs[0][f"{name}/collectives"])
    if ranks.BUCKETINGS[name].get("bucket_mb") == 4:
        assert n == 4 * (1 + 1)
    elif ranks.BUCKETINGS[name].get("bucket_mb"):
        assert n < streaming
    else:
        assert n == streaming


def test_bucketed_bf16_wire_matches_streaming_bitwise(runs):
    """Under ``bf16_mixed`` (the guard the policy wraps, the bf16 wire):
    the per-gradient cast-back rule holds in buckets too."""
    _, outs = runs
    for o in outs:
        ref, got = _states(o, "stream_bf16"), _states(o, "bucket4_bf16")
        assert sorted(ref) == sorted(got)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert not all(np.array_equal(v, _states(o, "stream")[k])
                       for k, v in ref.items()
                       if k in _states(o, "stream"))


def _jax_guarded(inputs):
    """Stats and the loss after each step of the JAX package's guarded
    ``DistOpt`` over a two-device mesh, and its final parameters and
    momenta."""
    dev = jdevice.create_cpu_device()
    m = jmlp.create_model(data_size=8, perceptron_size=16, num_classes=4)
    d = jopt.DistOpt(jopt.SGD(lr=0.1, momentum=0.9))
    d.communicator.mesh = jmesh.make_mesh(jax.devices("cpu")[:WORLD],
                                          jmesh.MeshConfig())
    guard = JGuard(d, init_scale=2.0 ** 4, growth_interval=2)
    m.set_optimizer(guard)

    def batch(step):
        return (jtensor.Tensor(data=inputs[f"gx{step}"], device=dev,
                               requires_grad=False),
                jtensor.Tensor(data=inputs[f"gy{step}"], device=dev,
                               requires_grad=False))

    m.compile([batch(0)[0]], is_train=True, use_graph=True,
              policy="bf16_mixed")
    live = m.get_states()
    for k, v in inputs.items():
        if k.startswith("ginit/"):
            live[k[len("ginit/"):]].copy_from_numpy(v)
    stats, losses = [], []
    for step in range(ranks.GUARD_STEPS):
        _, loss = m(*batch(step))
        losses.append(float(np.asarray(loss.data)))
        stats.append(guard.stats())
    states = {f"state/{k}": np.asarray(v.data, np.float32)
              for k, v in m.get_states().items()}
    states.update({f"opt/{k}": np.asarray(v, np.float32)
                   for k, v in guard.get_states().items()
                   if k.endswith(":momentum")})
    return stats, np.asarray(losses), states


def test_guard_skips_a_step_poisoned_on_one_rank_on_every_rank(runs):
    inputs, outs = runs
    want, want_losses, want_states = _jax_guarded(inputs)
    good = [s for s in range(ranks.GUARD_STEPS) if s != ranks.POISONED]
    for o in outs:
        for step in range(ranks.GUARD_STEPS):
            for k in STATS:
                assert float(o[f"guard/{k}{step}"]) == want[step][k], \
                    (step, k, float(o[f"guard/{k}{step}"]), want[step][k])
        # the gradient math: the mean over the ranks on the bf16 wire,
        # unscaled, as the JAX guarded DistOpt has it
        np.testing.assert_allclose(
            [float(o[f"guard/loss{s}"]) for s in good], want_losses[good],
            rtol=GUARD_LOSS_RTOL)
        np.testing.assert_allclose(
            [float(o[f"guard/grad_norm{s}"]) for s in good],
            [want[s]["grad_norm"] for s in good], rtol=GUARD_NORM_RTOL)
        got = _states(o, "guard/final")
        assert sorted(k for k in got if not k.startswith("opt/guard")
                      and (k.startswith("state/") or k.endswith(
                          ":momentum"))) == sorted(want_states)
        for k, w in want_states.items():
            assert np.abs(got[k] - w).max() <= \
                GUARD_STATE_TOL * np.abs(w).max(), \
                (k, np.abs(got[k] - w).max(), np.abs(w).max())
        # and bitwise the unguarded DistOpt's on the good steps: the same
        # reduction, wire and average, the scale a power of two
        plain = _states(o, "unguarded/final")
        for k in want_states:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        assert int(o[f"guard/skipped_total{ranks.POISONED}"]) == 1
        assert not np.isfinite(float(o[f"guard/loss{ranks.POISONED}"]))
        before = {k[len("guard/before/"):]: v for k, v in o.items()
                  if k.startswith("guard/before/")}
        after = _states(o, "guard/after")
        assert before
        for k, v in before.items():
            np.testing.assert_array_equal(after[f"state/{k}"], v,
                                          err_msg=k)
        assert bool(o["guard/agree"])
    assert want[ranks.POISONED]["skipped_total"] == 1
