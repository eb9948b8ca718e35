"""The port's Transformer LM under sequence parallelism, held against the
JAX package (``tests/test_transformer.py::TestTransformerLM::
test_sp_matches_dp``, ``test_sp_ulysses_matches_dp``, ``test_tp_plus_sp``).

Gloo ranks of ``tests/torch_dist_ranks.py`` (``lm_mesh`` case; two
launches for the module) train the LM of ``tests/test_transformer.py``
(vocab 31, d_model 32, 2 heads, 2 layers, B8 S16, ``SGD(lr=0.3,
momentum=0.9)``, 8 steps) from numpy-seeded weights under a
``DistOpt(reduce_axes=("data", "seq"))``, each rank called with the
global batch and ``input_specs = [P("data", "seq")] * 2`` (it takes its
8-token half): ring attention over ``MeshConfig(seq=2)`` (two ranks), Ulysses
attention over the same mesh, and ring attention with tensor parallelism
over ``MeshConfig(model=2, seq=2)`` (four ranks; rank r at the JAX
device r's coordinates), its blocks rematerialised (``remat=True``).
The JAX package trains each from the same weights over the same mesh of
CPU devices (the ``tp_sp`` run without remat, which changes no value:
the JAX package's remat of a ring block fails in its backward); the
port also trains the model dense, on one process with no mesh (with
remat where the mesh run has it).

Bounds: losses within rtol 1e-5 of the JAX run and of the dense run,
every gathered state and momentum within 1e-5 of its norm (plus 1e-7
absolute, the key biases' noise; ``tests/test_torch_lm_tp.py``). Measured:
losses 2e-7, states 4e-7; the JAX suite holds these meshes to its dense
run at rtol 5e-3.
"""

import numpy as np
import pytest

from singa_tpu_torch.parallel import ops as tops

import torch_dist_ranks as ranks
import torch_lm_mesh as H
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

RUNS2 = ["sp_ring", "sp_ulysses"]
RUNS4 = ["tp_sp"]
LOSS_RTOL = 1e-5
STATE_TOL = 1e-5


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    out = {}
    for world, runs in ((2, RUNS2), (4, RUNS4)):
        work = tmp_path_factory.mktemp(f"lm-sp{world}")
        outs, _ = ranks.launch("lm_mesh", world, H.inputs(runs, work), work)
        out.update({name: outs for name in runs})
    return out


@pytest.mark.parametrize("name", RUNS2 + RUNS4)
def test_sp_run_matches_jax_and_dense(ranked, name):
    ref, dense = H.jax_run(name), H.dense_run(name)
    for out in ranked[name]:
        np.testing.assert_allclose(out[f"{name}/losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[f"{name}/losses"], dense["losses"],
                                   rtol=LOSS_RTOL)
        assert out[f"{name}/losses"][-1] < out[f"{name}/losses"][0]
        for k, v in ref["states"].items():
            H.close(out[f"{name}/state/{k}"], v, STATE_TOL, k)
            H.close(out[f"{name}/state/{k}"], dense["states"][k],
                    STATE_TOL, k)
        for k, v in ref["ostates"].items():
            H.close(out[f"{name}/opt/{k}"], v, STATE_TOL, k)


def test_collectives_per_step(ranked):
    """Per step and rank: ring attention moves k and v one hop in each of
    the two blocks' forwards and back in their backwards (8 exchanges at
    two ranks of the ring), Ulysses exchanges q, k, v and the output each
    way (16 all-to-alls); the logits come back global through one gather
    over ``seq``; with ``model=2`` the blocks' 12 all-reduces join. Under
    remat (``tp_sp``) the backward reruns each block's forward up to its
    attention output's all-reduce (torch's checkpoint stops once it has
    what the backward saved), so each block's two sends and that one
    all-reduce come again. None is staged through host memory on the
    CPU."""
    kinds = list(tops.KINDS)
    want = {"sp_ring": {"all_gather": 1, "send_recv": 8},
            "sp_ulysses": {"all_gather": 1, "all_to_all": 16},
            "tp_sp": {"all_reduce": 12 + 2, "all_gather": 1,
                      "send_recv": 8 + 4}}
    for name, w in want.items():
        for out in ranked[name]:
            got = dict(zip(kinds, out[f"{name}/collectives"].tolist()))
            assert got == {k: w.get(k, 0) for k in kinds}, (name, got)


def test_tp_sp_shards_the_heads(ranked):
    for out in ranked["tp_sp"]:
        assert tuple(out["tp_sp/local/q"]) == (32, 16)
        assert tuple(out["tp_sp/local/head"]) == (32, 31)


def test_example_under_torchrun_matches_one_process(tmp_path, capsys):
    """``singa_tpu_torch/examples/train_transformer.py --sp 2`` under
    torchrun's variables (two gloo ranks on the CPU, ring attention) trains
    as one process does: losses within rtol 1e-5, the states within 1e-5
    of their norm, and the same greedy tokens after training."""
    losses, m, printed = H.example_one_process(capsys)
    outs, logs = H.example_ranks("--sp", tmp_path)
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_RTOL)
        for k, v in states.items():
            H.close(out[f"example/state/{k}"], v, STATE_TOL, k)
    assert "'seq': 2" in logs[0] and "(gloo)" in logs[0]
    gen = [line for line in printed.splitlines() if "generated" in line]
    assert gen and gen[0] in logs[0]
