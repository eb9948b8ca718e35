"""Tensor parallelism under ZeRO/FSDP in the port: ``gspmd.train_mesh(data=2,
model=2)`` with ``compile(mesh=..., fsdp_axis="data")`` or
``DistOpt(zero=True)``, held against the same tensor-parallel run without
FSDP, the JAX package's tensor-parallel run and the JAX package's
``fsdp_state_spec`` layouts (``tests/test_gspmd_train.py::
TestFsdpStateSpec``).

Four gloo ranks of ``tests/torch_dist_ranks.py`` (``lm_fsdp`` case, one
launch) train the LM of ``tests/torch_lm_mesh.py`` at vocab 32 (its ends
shard over ``model``) on the 2 x 2 train mesh, every rank given the global
batch and taking its rows by its ``data`` coordinate, 8 steps of
``SGD(lr=0.3, momentum=0.9)`` from numpy-seeded weights: the TP run, then
FSDP over ``data`` on top of it in both spellings. FSDP only moves where
the bytes live: losses within rtol 1e-5 and every gathered state and
momentum within 1e-5 of its norm of the TP run and of the JAX package's
TP run (``MeshConfig(model=2)`` over the CPU devices). What a rank holds
is the JAX package's layout: each parameter and momentum cut along its
announced ``model`` dimension and then along the first dimension still
whole that 2 divides, over ``data`` (``fsdp_state_spec`` on the JAX
layer's own spec); the TP run's states are cut by the fitted spec alone.
An FSDP rank holds under 0.6 of the TP rank's state bytes. FSDP over
``model`` (the weights replicated over it cut there, their gradients
taking this rank's slice with no sum over it) trains the same run; the
tensor-parallel weights, cut over ``model`` already, stay as they are.
Under ``bf16_mixed`` with FSDP over ``data``, an infinite gradient of a
weight cut over both axes on one rank alone skips the step on all four.
"""

import numpy as np
import pytest

import torch_dist_ranks as ranks
import torch_lm_mesh as H
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

LOSS_RTOL = 1e-5
STATE_TOL = 1e-5
BYTES_SHARE = 0.6


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    work = tmp_path_factory.mktemp("lm-tp-fsdp")
    inputs = H.inputs(["tp_v32"], work)
    outs, _ = ranks.launch("lm_fsdp", 4, inputs, work)
    return outs


@pytest.mark.parametrize("name", ranks.TP_FSDP_RUNS)
def test_run_matches_the_tp_run_and_jax(ranked, name):
    ref = H.jax_run("tp_v32")
    for out in ranked:
        got = out[f"{name}/losses"]
        np.testing.assert_allclose(got, ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, out["tp/losses"], rtol=LOSS_RTOL)
        for k, v in ref["states"].items():
            H.close(out[f"{name}/state/{k}"], v, STATE_TOL, k)
            H.close(out[f"{name}/state/{k}"], out[f"tp/state/{k}"],
                    STATE_TOL, k)
        for k, v in ref["ostates"].items():
            H.close(out[f"{name}/opt/{k}"], v, STATE_TOL, k)


@pytest.mark.parametrize("name", ranks.TP_FSDP_RUNS)
def test_each_rank_holds_the_jax_layout(ranked, name):
    import jax
    from singa_tpu.parallel import gspmd as jgspmd
    msh = jgspmd.train_mesh(jax.devices("cpu")[:4], data=2, model=2)
    model = H.jax_run("tp_v32")["model"]
    for k, t in model.get_states().items():
        spec = getattr(t, "spec", None)
        shape = tuple(t.shape)
        fitted = jgspmd.fit_state_spec(spec, shape, msh)
        if name == "tp" or (name == "tp_fsdp_model" and "model" in fitted):
            want = fitted
        else:
            want = jgspmd.fsdp_state_spec(
                spec, shape, msh,
                axis="model" if name == "tp_fsdp_model" else "data")
        local = list(shape)
        for dim, axes in enumerate(want):
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                if a is not None:
                    local[dim] //= msh.shape[a]
        for out in ranked:
            np.testing.assert_array_equal(out[f"{name}/local/{k}"], local,
                                          err_msg=f"{name} {k} {want}")


def test_fsdp_holds_a_share_of_the_tp_runs_bytes(ranked):
    for out in ranked:
        for name in ("tp_fsdp", "tp_zero"):
            assert int(out[f"{name}/bytes"]) <= \
                BYTES_SHARE * int(out["tp/bytes"])


def test_guard_skips_a_two_axis_overflow_on_every_rank(ranked):
    """``bf16_mixed`` on the 2 x 2 mesh with FSDP over ``data``: an
    infinite gradient of a weight cut over ``model`` and ``data`` on rank 1
    alone skips the step on all four ranks (the guard sums that block's
    squares over both axes), after a clean step that moved the states."""
    for out in ranked:
        assert int(out["guard/cut_over_both"]) > 0
        moved = out["guard/moved"]
        assert moved[0] > 0 and moved[1] == 0, moved
        np.testing.assert_array_equal(out["guard/skipped_total"], [0, 1])
        scale = out["guard/loss_scale"]
        assert scale[1] == scale[0] / 2, scale
