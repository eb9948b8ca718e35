"""The port's Transformer LM under tensor parallelism, held against the JAX
package (``tests/test_transformer.py::TestTransformerLM::test_tp_matches_dp``
and ``TestVocabParallel``).

Two gloo ranks of ``tests/torch_dist_ranks.py`` (``lm_mesh`` case, one
launch for the module) each train the LM of ``tests/test_transformer.py``
(d_model 32, 2 heads, 2 layers, B8 S16, ``SGD(lr=0.3, momentum=0.9)``, 8
steps) from numpy-seeded weights under a ``DistOpt`` over
``MeshConfig(model=2)``, on the global batch: vocab 31, whose embedding
and head cannot shard over two ranks and stay replicated; vocab 32, whose
vocab ends shard (embedding rows, head columns); vocab 32 through the
vocab-parallel fused CE head (``fused_head_chunk=8``). The JAX package
trains the same model from the same weights over the same mesh of two CPU
devices; the port also trains it dense, on one process with no mesh.

Bounds, the same for each run: losses within rtol 1e-5 of the JAX run and
of the dense run, every gathered state and momentum within 1e-5 of its
norm (plus 1e-7 absolute: the key projections' bias gradients are
mathematically 0 and numerically 1e-8 noise). Measured: losses 2e-7,
states 7e-7. The JAX suite holds a mesh run to its dense run at rtol
5e-3 (the fused head at 1e-3, vocab 32 at 2e-4); the port's runs agree
more closely because both packages sum in f32 over the same shards. Then
the archive of the sharded fused-head run has the JAX package's names and
shapes, restores into a fresh TP model with the next step's loss
bitwise, and greedy ``generate`` after the sharded training equals the
argmax of the model's own forward and the JAX package's ``generate`` from
the same (gathered) weights.
"""

import io
import json
import zipfile

import numpy as np
import pytest

from singa_tpu_torch.parallel import ops as tops

import torch_dist_ranks as ranks
import torch_lm_mesh as H
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

RUNS = ["tp", "tp_v32", "tp_v32_fused"]
LOSS_RTOL = 1e-5
STATE_TOL = 1e-5


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    work = tmp_path_factory.mktemp("lm-tp")
    outs, _ = ranks.launch("lm_mesh", 2, H.inputs(RUNS, work), work)
    return outs, work


@pytest.mark.parametrize("name", RUNS)
def test_tp_run_matches_jax_and_dense(ranked, name):
    outs, _ = ranked
    ref, dense = H.jax_run(name), H.dense_run(name)
    for out in outs:
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


def test_vocab_32_shards_and_vocab_31_replicates(ranked):
    """What a rank holds: the q projection's columns halve in every run;
    the embedding's rows and the head's columns halve at vocab 32 and stay
    whole at 31 (``gspmd.fit_state_spec``), as the JAX package's fitted
    specs say (``TestVocabParallel::test_indivisible_vocab_replicates``)."""
    outs, _ = ranked
    for out in outs:
        for name in RUNS:
            assert tuple(out[f"{name}/local/q"]) == (32, 16)
        assert tuple(out["tp/local/tok"]) == (31, 32)
        assert tuple(out["tp/local/head"]) == (32, 31)
        for name in ("tp_v32", "tp_v32_fused"):
            assert tuple(out[f"{name}/local/tok"]) == (16, 32)
            assert tuple(out[f"{name}/local/head"]) == (32, 16)


def test_collectives_per_step(ranked):
    """Megatron's count, per step: each block all-reduces twice forward
    (attention output, MLP down) and four times backward (the inputs of
    q, k, v and MLP up), 12 for two blocks; a sharded embedding adds one
    forward, the gathered head one all-gather forward and one all-reduce
    backward, and the fused head replaces the gather with its pmax and two
    psums forward and one psum backward."""
    outs, _ = ranked
    kinds = list(tops.KINDS)
    want = {"tp": {"all_reduce": 12},
            "tp_v32": {"all_reduce": 14, "all_gather": 1},
            "tp_v32_fused": {"all_reduce": 17}}
    for out in outs:
        for name, w in want.items():
            got = dict(zip(kinds, out[f"{name}/collectives"].tolist()))
            assert got == {k: w.get(k, 0) for k in kinds}, (name, got)


def _archive(path):
    with zipfile.ZipFile(path) as zf:
        attr = json.loads(zf.read("states_attr.json"))
        data = np.load(io.BytesIO(zf.read("tensor_dict.npz")))
        return attr, {k: data[k] for k in data.files}


def test_archive_of_a_tp_run_is_the_jax_packages_and_restores(
        ranked, tmp_path):
    """``save_states`` gathers the shards: the archive holds the JAX
    package's names and full shapes (its ``save_states`` of the same
    sharded run), and a fresh TP model that loads it takes the next step
    to the same loss, bitwise, as the run that wrote it."""
    outs, work = ranked
    ref = H.jax_run("tp_v32_fused")
    jpath = tmp_path / "jax.zip"
    ref["model"].save_states(str(jpath))
    tattr, tarr = _archive(work / "tp.zip")
    jattr, jarr = _archive(jpath)
    assert sorted(tarr) == sorted(jarr)
    assert {k: v.shape for k, v in tarr.items()} == \
        {k: v.shape for k, v in jarr.items()}
    assert tarr["TransformerLM.head.W"].shape == (32, 32)
    for out in outs:
        assert float(out["tp_v32_fused/restored_loss"]) == \
            float(out["tp_v32_fused/next_loss"])


def test_generate_after_sharded_training(ranked):
    """Greedy decoding reads the gathered weights: four new tokens equal
    the argmax of the model's own (sharded) forward, re-run per token, and
    the JAX package's ``generate`` from the same weights."""
    from singa_tpu import device as jdevice
    from singa_tpu import tensor as jtensor
    from singa_tpu.models import transformer as jtransformer
    outs, work = ranked
    gen = outs[0]["tp_v32_fused/generated"]
    assert gen.shape == (8, 20)
    for out in outs:
        np.testing.assert_array_equal(out["tp_v32_fused/generated"], gen)
        np.testing.assert_array_equal(out["tp_v32_fused/reforward"],
                                      gen[:, -4:])
    _, arrays = _archive(work / "tp.zip")
    dev = jdevice.create_cpu_device()
    m = jtransformer.TransformerLM(32, tp=False, fused_head_chunk=8,
                                   **ranks.LM_KW)
    ids, _ = H.lm_data(32)
    m(jtensor.Tensor(data=ids, device=dev, requires_grad=False))
    for k, t in m.get_states().items():
        t.copy_from_numpy(arrays[k])
    np.testing.assert_array_equal(
        m.generate(ids, max_new_tokens=4, temperature=0), gen)


def test_example_under_torchrun_matches_one_process(tmp_path, capsys):
    """``singa_tpu_torch/examples/train_transformer.py --tp 2`` under
    torchrun's variables (two gloo ranks on the CPU) trains as one process
    does (the same weights from the device seed, the same batch): losses
    within rtol 1e-5, the gathered states within 1e-5 of their norm, and
    the same greedy tokens after training."""
    losses, m, printed = H.example_one_process(capsys)
    outs, logs = H.example_ranks("--tp", tmp_path)
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_RTOL)
        for k, v in states.items():
            H.close(out[f"example/state/{k}"], v, STATE_TOL, k)
    assert "'model': 2" in logs[0] and "(gloo)" in logs[0]
    gen = [line for line in printed.splitlines() if "generated" in line]
    assert gen and gen[0] in logs[0]
