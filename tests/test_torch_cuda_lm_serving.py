"""LM serving on the card: the ``ServingEngine``'s two programs captured
into CUDA graphs and replayed, held bit for bit against the same engine
run eagerly (``use_graph=False``), and each program captured once across
refills, prefix hits and speculative ticks.

Marked ``cuda``: each case skips with a reason where
``torch.cuda.is_available()`` is false. This file imports only torch and
the port, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_lm_serving.py -m cuda -q

A tiny LM (vocab 19, d_model 16, 2 heads, 2 layers) with numpy-seeded
weights serves the same requests through a graphed and an eager engine:
every tick's logits (prefill and decode) are equal bitwise, and so are the
tokens.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import device, tensor
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer
from singa_tpu_torch.observability.metrics import Registry

VOCAB = 19


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serve programs are captured "
                    "into CUDA graphs only there")


def _lm(dev, seed=0):
    m = transformer.TransformerLM(VOCAB, d_model=16, n_heads=2, n_layers=2,
                                  max_len=64, tp=False)
    m.eval()
    m(tensor.Tensor(data=np.zeros((1, 4), np.float32), device=dev))
    rng = np.random.RandomState(seed)
    load_numpy_states(m, {
        k: (rng.randn(*t.shape) * 0.3).astype(np.float32)
        for k, t in sorted(m.get_states().items())})
    return m


def _serve(m, use_graph, **kw):
    eng = m.compile_serving(registry=Registry(), use_graph=use_graph, **kw)
    logits = []
    eng._on_logits = lambda kind, out, rows: logits.append(
        (kind, np.array(out)))
    rng = np.random.RandomState(3)
    base = rng.randint(0, VOCAB, (8,))
    prompts = [base if i % 2 == 0 else
               rng.randint(0, VOCAB, (int(rng.randint(1, 9)),))
               for i in range(7)]
    futs = [eng.submit(p, max_new_tokens=int(rng.randint(2, 12)),
                       temperature=0.0) for p in prompts]
    eng.run_until_idle()
    return eng, [f.result(timeout=30)["tokens"] for f in futs], logits


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [
    {}, {"kv_layout": "paged", "kv_block_size": 4, "speculative_k": 4}],
    ids=["ring", "paged_speculative"])
def test_graphed_equals_eager_bitwise_one_capture(layout):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    m = _lm(device.create_cuda_gpu(0))
    kw = dict(slots=2, max_len=48, prefill_len=8, prefill_batch=1, **layout)
    g_eng, g_tok, g_logits = _serve(m, True, **kw)
    e_eng, e_tok, e_logits = _serve(m, False, **kw)
    assert g_tok == e_tok
    assert len(g_logits) == len(e_logits) > 7
    for (gk, g), (ek, e) in zip(g_logits, e_logits):
        assert gk == ek and np.array_equal(g, e), gk
    info = g_eng.compiled_step_info()
    assert info["n_traces"] == 1 and info["prefill_n_traces"] == 1, info
    assert g_eng._cache[0]["k"].is_cuda
    # every call after the first replayed its capture
    assert g_eng._decode.n_replays == g_eng._decode.n_calls - 1 > 5
    assert g_eng._prefill.n_replays == g_eng._prefill.n_calls - 1 > 3
