"""The port's Mixture-of-Experts Transformer LM (``TransformerLM(moe=...)``)
held against the JAX package (``tests/test_moe.py::TestMoETransformer``,
``tests/test_transformer.py::TestBF16Compute`` and
``test_moe_greedy_matches_naive_reforward``).

On one process: the LM of ``tests/test_moe.py`` (vocab 31, d_model 16, 2
heads, 2 blocks of 4 experts, top-2, capacity factor 1.25, B4 S10) from
numpy-seeded weights, 3 graphed steps of ``SGD(lr=0.3, momentum=0.9)``
with the full-logits loss, with the fused head (``fused_head_chunk=8``:
the total loss, MoE aux included, fills the output slot), with
``remat=True`` (bitwise the plain run: the loss takes the forward's aux
losses, whose gradient reaches the routers through the checkpoint), with
``compute_dtype=bfloat16`` (router f32, experts bf16) and under
``bf16_mixed`` (f32 masters and router, bf16 expert products, the
guard). f32 runs: losses within rtol 1e-5 of the JAX package's and
every state within 1e-5 of its norm; bf16 runs: losses within rtol 1e-2
(the JAX package runs its ``bf16_mixed`` experts in f32: its einsums
promote a bf16 activation against an f32 master). Greedy ``generate``
after training equals the JAX package's from the same weights and, with
a capacity that drops nothing, the argmax of the model's own forward
re-run per token.

On two gloo ranks (``tests/torch_dist_ranks.py``'s ``lm_mesh`` case, one
launch): the MoE LM (d_model 16, 4 experts, drop-free capacity) over
``MeshConfig(expert=2)``, each rank holding two experts, 8 steps with the
full logits and with the fused head, against the JAX package's run of the
same mesh and the dense run (losses rtol 1e-5, states 1e-5 of their
norm); the fused run's archive has the dense model's names and shapes,
restores into a fresh expert-parallel model whose sharded eval equals
the dense eval and whose next loss is the writer's, bitwise, and greedy
``generate`` from it equals the argmax of its own forward and the JAX
package's ``generate``.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtransformer

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer as ttransformer

import torch_dist_ranks as ranks
import torch_lm_mesh as H
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

VOCAB, STEPS = 31, 3
KW = dict(d_model=16, n_heads=2, n_layers=2, max_len=32, tp=False, moe=4)
LOSS_RTOL, STATE_TOL = 1e-5, 1e-5
BF16_LOSS_RTOL = 1e-2
EP_RUNS = ["moe_ep2", "moe_ep2_fused"]
# name -> the settings a run adds
RUNS = {"plain": {}, "fused": dict(fused_head_chunk=8),
        "bf16": dict(compute_dtype="bfloat16"),
        "bf16_mixed": dict(policy="bf16_mixed")}
_JAX = {}


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    TCTX.training = False


def _data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (4, 10)).astype(np.float32)
    return ids, np.roll(ids, -1, 1)


def _seeded(**kw):
    return H.seeded(VOCAB, seed=5, **dict(KW, **kw))


def _split(run):
    """``(model settings, compile policy)`` of a ``RUNS`` entry."""
    cfg = dict(run)
    return cfg, cfg.pop("policy", None)


def port_run(run, remat=False, **kw):
    cfg, policy = _split(run)
    if cfg.get("compute_dtype"):
        cfg["compute_dtype"] = torch.bfloat16
    dev = tdevice.create_cpu_device()
    ids, tgt = _data()
    tx = ttensor.Tensor(data=ids, device=dev)
    ty = ttensor.Tensor(data=tgt, device=dev)
    m = ttransformer.TransformerLM(VOCAB, remat=remat, **dict(KW, **kw),
                                   **cfg)
    m.set_optimizer(topt.SGD(lr=0.3, momentum=0.9))
    m.compile([tx], is_train=True, use_graph=True, policy=policy)
    load_numpy_states(m, _seeded(**kw))
    outs = [m(tx, ty) for _ in range(STEPS)]
    return m, [float(loss.data.detach()) for _, loss in outs], outs


def jax_run(name):
    if name in _JAX:
        return _JAX[name]
    import jax.numpy as jnp
    cfg, policy = _split(RUNS[name])
    if cfg.get("compute_dtype"):
        cfg["compute_dtype"] = jnp.bfloat16
    dev = jdevice.create_cpu_device()
    ids, tgt = _data()
    tx = jtensor.Tensor(data=ids, device=dev, requires_grad=False)
    ty = jtensor.Tensor(data=tgt, device=dev, requires_grad=False)
    m = jtransformer.TransformerLM(VOCAB, **KW, **cfg)
    m.set_optimizer(jopt.SGD(lr=0.3, momentum=0.9))
    m.compile([tx], is_train=True, use_graph=True, policy=policy)
    live = m.get_states()
    for k, v in _seeded().items():
        live[k].copy_from_numpy(v)
    losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
    states = {k: np.asarray(v.data, np.float32)
              for k, v in m.get_states().items()}
    _JAX[name] = dict(losses=np.asarray(losses), states=states, model=m)
    return _JAX[name]


@pytest.mark.parametrize("name", ["plain", "fused"])
def test_moe_lm_matches_the_jax_package(name):
    m, losses, outs = port_run(RUNS[name])
    ref = jax_run(name)
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    assert sorted(states) == sorted(ref["states"])
    for k, v in ref["states"].items():
        H.close(states[k], v, STATE_TOL, k)
    if name == "fused":
        # the output slot holds the total loss, aux terms included
        for pred, loss in outs:
            assert float(pred.data.detach()) == float(loss.data.detach())
    assert m.blocks[0].mlp.w1.shape == (4, 16, 64)


def test_remat_is_the_plain_run_bitwise():
    """Under remat the loss takes each block's ``aux_loss`` of the forward,
    and the loss built from it trains the routers through the checkpoint:
    the run equals the plain one bitwise (states and losses)."""
    m, losses, _ = port_run(RUNS["plain"], remat=True)
    plain, plain_losses, _ = port_run(RUNS["plain"])
    assert losses == plain_losses
    got = {k: v.to_numpy() for k, v in m.get_states().items()}
    for k, v in plain.get_states().items():
        np.testing.assert_array_equal(got[k], v.to_numpy(), err_msg=k)
    np.testing.assert_allclose(losses, jax_run("plain")["losses"],
                               rtol=LOSS_RTOL)
    before = _seeded()["TransformerLM.blocks.0.mlp.wg"]
    assert np.abs(got["TransformerLM.blocks.0.mlp.wg"] - before).max() > 0


@pytest.mark.parametrize("name", ["bf16", "bf16_mixed"])
def test_bf16_router_stays_f32(name):
    m, losses, _ = port_run(RUNS[name])
    ref = jax_run(name)
    np.testing.assert_allclose(losses, ref["losses"], rtol=BF16_LOSS_RTOL)
    assert losses[-1] < losses[0]
    mlp = m.blocks[0].mlp
    assert mlp.wg.dtype == torch.float32
    want = torch.bfloat16 if name == "bf16" else torch.float32
    assert mlp.w1.dtype == want
    jmlp = ref["model"].blocks[0].mlp
    assert str(jmlp.wg.data.dtype) == "float32"
    assert str(jmlp.w1.data.dtype) == str(want).replace("torch.", "")


def test_greedy_generate_matches_jax_and_the_reforward():
    """With a capacity that drops nothing (cf 8) greedy decoding equals the
    argmax of the model's own forward re-run per token; and it equals the
    JAX package's ``generate`` from the same trained weights."""
    m, _, _ = port_run(RUNS["plain"], moe_capacity_factor=8.0)
    ids = _data()[0]
    prompt = ids[:, :5]
    out = m.generate(prompt, 6, temperature=0)
    assert out.shape == (4, 11)
    m.eval()
    dev = tdevice.create_cpu_device()
    cur = prompt.copy()
    for _ in range(6):
        logits = m(ttensor.Tensor(data=cur.astype(np.float32),
                                  device=dev)).data
        nxt = torch.argmax(logits[:, -1], -1).numpy()
        cur = np.concatenate([cur, nxt[:, None].astype(cur.dtype)], 1)
    np.testing.assert_array_equal(out, cur.astype(out.dtype))
    jm = jtransformer.TransformerLM(VOCAB, moe_capacity_factor=8.0, **KW)
    jm(jtensor.Tensor(data=ids, device=jdevice.create_cpu_device(),
                      requires_grad=False))
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    for k, t in jm.get_states().items():
        t.copy_from_numpy(states[k])
    np.testing.assert_array_equal(jm.generate(prompt, 6, temperature=0),
                                  out)


# -- expert parallelism at two gloo ranks ------------------------------------

@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    work = tmp_path_factory.mktemp("lm-moe")
    outs, _ = ranks.launch("lm_mesh", 2, H.inputs(EP_RUNS, work), work)
    return outs, work


@pytest.mark.parametrize("name", EP_RUNS)
def test_ep_lm_matches_jax_and_dense(ranked, name):
    outs, _ = ranked
    ref, dense = H.jax_run(name), H.dense_run(name)
    for out in outs:
        got = out[f"{name}/losses"]
        np.testing.assert_allclose(got, ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, dense["losses"], rtol=LOSS_RTOL)
        assert got[-1] < got[0]
        for k, v in ref["states"].items():
            H.close(out[f"{name}/state/{k}"], v, STATE_TOL, k)
            H.close(out[f"{name}/state/{k}"], dense["states"][k],
                    STATE_TOL, k)
        for k, v in ref["ostates"].items():
            H.close(out[f"{name}/opt/{k}"], v, STATE_TOL, k)


def _archive(path):
    with zipfile.ZipFile(path) as zf:
        attr = json.loads(zf.read("states_attr.json"))
        data = np.load(io.BytesIO(zf.read("tensor_dict.npz")))
        return attr, {k: data[k] for k in data.files}


def test_ep_archive_is_dense_and_restores_into_sharded_eval(ranked):
    """The archive of the expert-parallel run holds the dense model's
    names and full shapes (every expert); a fresh expert-parallel model
    that loads it holds two experts a rank, evaluates sharded to the
    dense run's logits (rtol 1e-4 of the largest) and takes the next
    step to the writer's loss, bitwise."""
    outs, work = ranked
    name = "moe_ep2_fused"
    dense = H.dense_run(name)
    _, arrays = _archive(work / "moe.zip")
    assert {k: v.shape for k, v in arrays.items()
            if not k.startswith("optimizer/")} == \
        {k: v.shape for k, v in dense["states"].items()}
    assert arrays["TransformerLM.blocks.0.mlp.w1"].shape == (4, 16, 64)
    ids, _ = H.lm_data(VOCAB)
    want = dense["model"](ttensor.Tensor(
        data=ids, device=tdevice.create_cpu_device())).to_numpy()
    for out in outs:
        np.testing.assert_array_equal(out[f"{name}/restored_local/w1"],
                                      [2, 16, 64])
        got = out[f"{name}/restored_eval"]
        assert float(np.abs(got - want).max()) <= \
            1e-4 * float(np.abs(want).max())
        assert float(out[f"{name}/restored_loss"]) == \
            float(out[f"{name}/next_loss"])


def test_generate_after_ep_training(ranked):
    outs, work = ranked
    name = "moe_ep2_fused"
    gen = outs[0][f"{name}/generated"]
    for out in outs:
        np.testing.assert_array_equal(out[f"{name}/generated"], gen)
        np.testing.assert_array_equal(out[f"{name}/reforward"],
                                      gen[:, -4:])
    _, arrays = _archive(work / "moe.zip")
    cfg = dict(ranks.LM_RUNS[name])
    m = jtransformer.TransformerLM(
        VOCAB, tp=False, moe=4, moe_capacity_factor=4.0,
        fused_head_chunk=8, **dict(ranks.LM_KW, d_model=cfg["d_model"]))
    ids, _ = H.lm_data(VOCAB)
    m(jtensor.Tensor(data=ids, device=jdevice.create_cpu_device(),
                     requires_grad=False))
    for k, t in m.get_states().items():
        t.copy_from_numpy(arrays[k])
    np.testing.assert_array_equal(
        m.generate(ids, max_new_tokens=4, temperature=0), gen)
