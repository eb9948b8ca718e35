"""The port's decoding (``models/decode.py``, ``TransformerLM.generate``)
held against the JAX package (``singa_tpu/models/decode.py``,
``tests/test_transformer.py::TestGeneration`` and ``TestBF16Compute``).

The sampling helpers: ``apply_top_k``, ``sample_logits`` and
``ngram_propose`` are the JAX package's numpy code, so they give equal
results; ``sample_logits_torch`` is greedy exactly as ``sample_logits_jax``
(ties to the lowest id), keeps its draws within the top k, and is
reproducible from its generator's seed. A sampled (non-greedy) token is
not the JAX package's: the generators differ (ROADMAP.md Queue 3).

``generate``: an LM (vocab 31, d_model 32, 2 heads, 2 layers, max_len
64) with numpy-seeded weights, the same in both packages, trained 3 SGD
steps, decodes greedily from 2 prompts of 5 tokens: the tokens equal the
JAX package's ``generate`` and the port's own full forward re-run per
token (``tests/test_transformer.py::test_greedy_matches_naive_refoward``),
and each step's logits are within 1e-5 of the largest of that forward's
last-position logits (f32; the cache's sums run in another order than
flash attention's). Under ``compute_dtype=bfloat16`` both packages decode
in f32 from the bf16 weights, and the tokens are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models import decode as jdecode
from singa_tpu.models import transformer as jtransformer

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import decode as tdecode
from singa_tpu_torch.models import transformer as ttransformer

import torch_lm_mesh as H
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

VOCAB = 31
KW = dict(d_model=32, n_heads=2, n_layers=2, max_len=64)
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    TCTX.training = False


def test_numpy_helpers_are_the_jax_packages():
    rng = np.random.RandomState(0)
    for _ in range(5):
        logits = rng.randn(3, 17)
        for k in (None, 0, 1, 4, 17, 30):
            np.testing.assert_array_equal(tdecode.apply_top_k(logits, k),
                                          jdecode.apply_top_k(logits, k))
        row = logits[0]
        for temp, k in ((0, None), (0.7, None), (1.3, 3)):
            assert tdecode.sample_logits(
                row, temp, k, np.random.RandomState(5)) == \
                jdecode.sample_logits(row, temp, k,
                                      np.random.RandomState(5))
    for hist in ([1, 2, 3, 1, 2], [4, 4, 4, 4], [7], [1, 2, 1, 2, 1, 2, 3]):
        for k in (0, 1, 3):
            assert tdecode.ngram_propose(hist, k) == \
                jdecode.ngram_propose(hist, k)


def test_greedy_twin_matches_jax_ties_to_the_lowest_id():
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 3, 11).astype(np.float32)
    logits[0, 0, [2, 7]] = 9.0          # a tie: the lower id wins
    logits[1, 2, :] = 0.0               # all tied: id 0
    got = tdecode.sample_logits_torch(torch.from_numpy(logits), 0, None)
    want = jdecode.sample_logits_jax(jnp.asarray(logits), 0, None,
                                     jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == 2 and int(got[1, 2]) == 0


def test_sampling_twin_respects_top_k_and_its_seed():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.5, -1.0]] * 4000)
    gen = torch.Generator().manual_seed(3)
    ids = tdecode.sample_logits_torch(logits, 0.8, 2, gen)
    assert set(ids.tolist()) == {1, 3}
    # the top-2 softmax at temperature 0.8: p(1) = 1 / (1 + e^{-0.625})
    p1 = 1.0 / (1.0 + np.exp(-0.5 / 0.8))
    assert abs(float((ids == 1).float().mean()) - p1) < 0.03
    again = tdecode.sample_logits_torch(
        logits, 0.8, 2, torch.Generator().manual_seed(3))
    assert torch.equal(ids, again)
    other = tdecode.sample_logits_torch(
        logits, 0.8, 2, torch.Generator().manual_seed(4))
    assert not torch.equal(ids, other)
    one = tdecode.sample_logits_torch(logits[:3], 0.8, 1,
                                      torch.Generator().manual_seed(9))
    assert one.tolist() == [1, 1, 1]


def _data():
    ids, tgt = H.lm_data(VOCAB, B=2, S=8)
    return ids, tgt


def _port(compute_dtype=None, steps=3, **kw):
    dev = tdevice.create_cpu_device()
    ids, tgt = _data()
    tx = ttensor.Tensor(data=ids, device=dev)
    ty = ttensor.Tensor(data=tgt, device=dev)
    m = ttransformer.TransformerLM(VOCAB, tp=False,
                                   compute_dtype=compute_dtype, **KW, **kw)
    m.set_optimizer(topt.SGD(lr=0.3))
    m.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(m, H.seeded(VOCAB))
    for _ in range(steps):
        m(tx, ty)
    m.eval()
    return m, dev, ids


def _jax_from(port_model, compute_dtype=None):
    """The JAX package's LM holding the port model's weights."""
    dev = jdevice.create_cpu_device()
    ids, _ = _data()
    m = jtransformer.TransformerLM(VOCAB, tp=False,
                                   compute_dtype=compute_dtype, **KW)
    m(jtensor.Tensor(data=ids, device=dev, requires_grad=False))
    states = {k: v.data.detach().float().numpy()
              for k, v in port_model.get_states().items()}
    for k, t in m.get_states().items():
        t.copy_from_numpy(states[k])
    return m


@pytest.fixture(scope="module")
def trained():
    return _port()


def test_greedy_matches_jax_and_the_full_reforward(trained):
    m, dev, ids = trained
    prompt, T = ids[:, :5], 6
    logits = []
    out = ttransformer._decode(m, prompt, T, temperature=0,
                               on_token=logits.append)
    assert len(logits) == T
    assert out.shape == (2, 5 + T) and out.dtype == np.int32
    np.testing.assert_array_equal(m.generate(prompt, T, temperature=0), out)
    np.testing.assert_array_equal(
        _jax_from(m).generate(prompt, T, temperature=0), out)
    cur = prompt.copy()
    for step in range(T):
        full = m(ttensor.Tensor(data=cur.astype(np.float32),
                                device=dev)).to_numpy()[:, -1]
        scale = float(np.abs(full).max())
        assert float(np.abs(logits[step].numpy() - full).max()) <= \
            LOGIT_TOL * scale
        nxt = full.argmax(-1).astype(np.float32)
        cur = np.concatenate([cur, nxt[:, None]], 1)
    np.testing.assert_array_equal(out, cur.astype(np.int64))


def test_sampling_runs_and_respects_top_k(trained):
    m, _, ids = trained
    out = m.generate(ids[:, :4], 5, temperature=0.8, top_k=3, seed=1)
    assert out.shape == (2, 9)
    assert (out >= 0).all() and (out < VOCAB).all()
    np.testing.assert_array_equal(
        out, m.generate(ids[:, :4], 5, temperature=0.8, top_k=3, seed=1))
    assert not np.array_equal(
        out, m.generate(ids[:, :4], 5, temperature=0.8, top_k=3, seed=2))
    np.testing.assert_array_equal(
        m.generate(ids[:, :4], 5, temperature=0.8, top_k=1, seed=3),
        m.generate(ids[:, :4], 5, temperature=0))


def test_edge_cases(trained):
    m, _, ids = trained
    np.testing.assert_array_equal(m.generate(ids[:, :4], 0),
                                  ids[:, :4].astype(np.int64))
    m2 = ttransformer.TransformerLM(VOCAB, d_model=16, n_heads=2,
                                    n_layers=1, max_len=16, causal=False)
    with pytest.raises(NotImplementedError, match="causal"):
        m2.generate(ids[:, :4], 2)
    # past max_len: the JAX package asserts, the port raises ValueError
    with pytest.raises(ValueError, match="max_len"):
        m.generate(ids[:, :4], 61, temperature=0)
    jm = _jax_from(m)
    with pytest.raises(AssertionError, match="max_len"):
        jm.generate(ids[:, :4], 61, temperature=0)


def test_generate_reads_the_live_weights():
    """After a further train step the next greedy token is the new
    forward's argmax (the JAX package's cache is invalidated by a step;
    the port reads the weights on every call)."""
    m, dev, ids = _port(steps=1)
    before = m.generate(ids[:, :6], 1, temperature=0)
    m.train()
    tx = ttensor.Tensor(data=ids, device=dev)
    ty = ttensor.Tensor(data=np.roll(ids, -1, 1), device=dev)
    for _ in range(3):
        m(tx, ty)
    m.eval()
    after = m.generate(ids[:, :6], 1, temperature=0)
    want = m(ttensor.Tensor(data=ids[:, :6], device=dev)
             ).to_numpy()[:, -1].argmax(-1)
    np.testing.assert_array_equal(after[:, -1], want)
    assert before.shape == after.shape


def test_bf16_compute_decodes_like_the_jax_package():
    m, _, ids = _port(compute_dtype=torch.bfloat16)
    assert m.blocks[0].attn.q_proj.W.dtype == torch.bfloat16
    assert m.tok_emb.W.dtype == torch.float32
    out = m.generate(ids[:, :5], 6, temperature=0)
    np.testing.assert_array_equal(
        _jax_from(m, jnp.bfloat16).generate(ids[:, :5], 6, temperature=0),
        out)


@pytest.mark.parametrize("chunk", [None, 16], ids=["dense-head", "fused"])
def test_bf16_compute_trains(chunk):
    """``tests/test_transformer.py::TestBF16Compute``: the stack's
    parameters follow the bf16 compute dtype, the embeddings stay f32, and
    8 steps lower the loss on both loss paths."""
    dev = tdevice.create_cpu_device()
    dev.SetRandSeed(5)
    ids, tgt = H.lm_data(VOCAB)
    tx = ttensor.Tensor(data=ids, device=dev)
    ty = ttensor.Tensor(data=tgt, device=dev)
    m = ttransformer.TransformerLM(VOCAB, tp=False, fused_head_chunk=chunk,
                                   compute_dtype=torch.bfloat16, **KW)
    m.set_optimizer(topt.SGD(lr=0.3, momentum=0.9))
    m.compile([tx], is_train=True, use_graph=True)
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(8)]
    assert losses[-1] < losses[0]
    assert m.blocks[0].attn.q_proj.W.dtype == torch.bfloat16
    assert m.blocks[0].mlp.up.W.dtype == torch.bfloat16
    assert m.tok_emb.W.dtype == torch.float32
    if chunk:
        assert m.head.W.dtype == torch.bfloat16
