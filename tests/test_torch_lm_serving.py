"""The port's LM serving (``singa_tpu_torch/serving/engine.py``'s
``ServingEngine`` over ``TransformerLM.decode_adapter``) against the JAX
package's, on the CPU.

The JAX serving tests' tiny LM (vocab 19, d_model 16, 2 heads, 2 layers,
positional table 64) is built in both packages with the same weights,
drawn with numpy from one seed and loaded into each. Held:

- the adapters' four programs on the same weights, caches and inputs:
  logits within 1e-5 of the largest |logit|, every cache level within
  1e-6 of its largest |value| (f32 sums and LayerNorm in another order);
- the engines token for token, greedy: the ring with continuous refill
  and the ring wrapping, the paged layout (and the port's paged KV rows
  bitwise against its ring rows), a prefix hit, a divergent prompt,
  speculative decoding (against plain greedy and against the JAX
  engine) with an EOS inside a draft, the MoE LM; sampled requests with
  the request ids of both packages aligned (each request draws from
  ``RandomState(seed + id)``); ``bf16_mixed`` logits within 5e-2 of the
  largest |logit| of the JAX engine's, tick by tick while the two
  histories agree;
- the typed refusals and declines of ``tests/test_serving.py`` and
  ``tests/test_paged_serving.py``, the options not ported yet raising
  ``NotImplementedError`` naming ROADMAP.md, drain, and the fixed-shape
  contract: each program sees one input signature across refills, prefix
  hits and speculative ticks and is built once.

On the CPU each program runs through the same books as on the card (its
first call builds it, later calls run it on static input buffers); the
card's captured replays are ``tests/test_torch_cuda_lm_serving.py``.
Each JAX engine is compiled once per module and shared by the tests.
"""

import itertools
import time
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtransformer
from singa_tpu.observability import metrics as jmetrics
from singa_tpu.serving import scheduler as jscheduler

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.graph import signature
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer as ttransformer
from singa_tpu_torch.observability.metrics import Registry
from singa_tpu_torch.serving import (BlockPoolExhausted, EngineDraining,
                                     QueueFull, RequestTimeout, ServingError,
                                     engine as tengine)
from singa_tpu_torch.serving import scheduler as tscheduler

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

VOCAB, D_MODEL, HEADS, LAYERS, TABLE = 19, 16, 2, 2, 64
LOGIT_TOL, CACHE_TOL, BF16_TOL = 1e-5, 1e-6, 5e-2
PAGED = dict(kv_layout="paged", kv_block_size=4)


def _pair(seed, **kw):
    """A port and a JAX ``TransformerLM`` of the tiny settings (and
    ``kw``) with the same numpy-seeded weights."""
    ids = np.zeros((1, 4), np.float32)
    settings = dict(d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
                    max_len=TABLE, tp=False, **kw)
    tm = ttransformer.TransformerLM(VOCAB, **settings)
    jm = jtransformer.TransformerLM(VOCAB, **settings)
    tm.eval()
    jm.eval()
    tm(ttensor.Tensor(data=ids, device=tdevice.create_cpu_device()))
    jm(jtensor.Tensor(data=ids, device=jdevice.create_cpu_device(),
                      requires_grad=False))
    rng = np.random.RandomState(seed)
    init = {}
    for k, t in sorted(tm.get_states().items()):
        shape = tuple(t.shape)
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            v = rng.randn(*shape) * np.sqrt(1.0 / shape[0])
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.randn(*shape) * 0.1
        init[k] = v.astype(np.float32)
    load_numpy_states(tm, init)
    for k, t in jm.get_states().items():
        t.copy_from_numpy(init[k])
    return tm, jm


@pytest.fixture(scope="module")
def lm():
    return _pair(0)


@pytest.fixture(scope="module")
def moe_lm():
    return _pair(1, moe=2)


@pytest.fixture(scope="module")
def jax_engine():
    """``get(jm, key, **kw)``: the JAX engine of ``key``, compiled once per
    module."""
    built = {}

    def get(jm, key, **kw):
        if key not in built:
            built[key] = jm.compile_serving(
                registry=jmetrics.MetricsRegistry(), **kw)
        return built[key]
    return get


def _port(tm, **kw):
    reg = Registry()
    return tm.compile_serving(registry=reg, **kw), reg


def _run(eng, prompts, n_new, **kw):
    futs = [eng.submit(p, max_new_tokens=n, **kw)
            for p, n in zip(prompts, n_new)]
    eng.run_until_idle()
    out = [f.result(timeout=5)["tokens"] for f in futs]
    assert all(f.deliveries == 1 for f in futs)
    return out


def _prompts(seed, n, lo=1, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (int(rng.randint(lo, hi + 1)),))
            for _ in range(n)]


def _one_trace(eng):
    info = eng.compiled_step_info()
    assert info["n_traces"] == 1 and info["prefill_n_traces"] == 1, info


# -- the adapters' programs --------------------------------------------------

def _program_inputs(kind, rng):
    """Inputs of one program call, as numpy: padding rows, a wrapped ring
    position, a prefix-hit start, a draft row and an inactive row."""
    i = np.int32
    if kind == "prefill":       # tokens, lengths, slot_ids, valid
        return [rng.randint(0, VOCAB, (3, 8)).astype(i),
                np.array([5, 8, 2], i), np.array([2, 1, 0], i),
                np.array([True, False, True])]
    if kind == "decode":        # tokens, positions, active
        return [rng.randint(0, VOCAB, (3,)).astype(i),
                np.array([3, 20, 7], i), np.array([True, True, False])]
    tables = np.stack([rng.permutation(10)[:4] for _ in range(3)]
                      ).astype(i)
    if kind == "paged_prefill":  # tables, tokens, starts, lengths, valid
        return [tables, rng.randint(0, VOCAB, (3, 8)).astype(i),
                np.array([0, 4, 0], i), np.array([5, 3, 8], i),
                np.array([True, True, False])]
    # paged_decode: tables, tokens, positions, counts
    return [tables, rng.randint(0, VOCAB, (3, 3)).astype(i),
            np.array([2, 9, 5], i), np.array([1, 3, 2], i)]


@pytest.mark.parametrize("kind", ["prefill", "decode", "paged_prefill",
                                  "paged_decode"])
def test_adapter_programs_match_jax(lm, kind):
    tm, jm = lm
    ta, ja = tm.decode_adapter(), jm.decode_adapter()
    rng = np.random.RandomState(5)
    H, D = HEADS, D_MODEL // HEADS
    rows = (3, H, 16, D) if kind in ("prefill", "decode") else (10, H, 4, D)
    start = [{p: rng.randn(*rows).astype(np.float32) for p in "kv"}
             for _ in range(LAYERS)]
    jcache = [{p: jnp.asarray(v) for p, v in lv.items()} for lv in start]
    tcache = [{p: torch.from_numpy(np.concatenate(
        [v, np.zeros((1,) + rows[1:], np.float32)])) for p, v in lv.items()}
        for lv in start]
    args = _program_inputs(kind, rng)
    jcache, want = getattr(ja, f"{kind}_fn")()(
        ja.params(), jcache, *[jnp.asarray(a) for a in args])
    with torch.inference_mode():
        got = getattr(ta, f"{kind}_fn")()(
            ta.params(), tcache,
            *[torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a)
              for a in args])
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * scale
    for tl, jl in zip(tcache, jcache):
        for p in "kv":
            w = np.asarray(jl[p])
            err = float(np.abs(tl[p][:rows[0]].numpy() - w).max())
            assert err <= CACHE_TOL * float(np.abs(w).max()), (p, err)


# -- the engines, token for token -------------------------------------------

def test_ring_refill_and_wraparound_match_jax(lm, jax_engine):
    """Seven prompts through two slots (at least five mid-batch refills),
    a ring of 16 rows that most sequences outgrow (sliding-window
    attention after the wrap)."""
    tm, jm = lm
    kw = dict(slots=2, max_len=16, prefill_len=8, prefill_batch=2)
    prompts = _prompts(0, 7)
    n_new = [4, 20, 9, 14, 2, 17, 11]
    assert max(len(p) + n for p, n in zip(prompts, n_new)) > 16
    eng, _ = _port(tm, **kw)
    got = _run(eng, prompts, n_new, temperature=0.0)
    want = _run(jax_engine(jm, "ring16", **kw), prompts, n_new,
                temperature=0.0)
    assert got == want
    _one_trace(eng)
    assert eng.active_slots() == 0


def test_paged_matches_ring_and_jax(lm, jax_engine):
    tm, jm = lm
    kw = dict(slots=2, max_len=32, prefill_len=8)
    prompts, n_new = _prompts(3, 5), [6, 3, 10, 6, 8]
    ring, _ = _port(tm, **kw)
    paged, _ = _port(tm, **kw, **PAGED)
    got = _run(paged, prompts, n_new, temperature=0.0)
    assert got == _run(ring, prompts, n_new, temperature=0.0)
    assert got == _run(jax_engine(jm, "paged", **kw, **PAGED), prompts,
                       n_new, temperature=0.0)
    _one_trace(paged)


def test_paged_rows_bitwise_equal_ring_rows(lm):
    """One request through each layout: both store position p at logical
    index p, and the paged prefill's softmax only adds exact zeros."""
    tm, _ = lm
    kw = dict(slots=2, max_len=32, prefill_len=8)
    prompt = _prompts(1, 1, 6, 6)
    ring, _ = _port(tm, **kw)
    paged, _ = _port(tm, **kw, **PAGED)
    assert _run(ring, prompt, [4], temperature=0.0) == \
        _run(paged, prompt, [4], temperature=0.0)
    n_written = 6 + 4 - 1        # the last token is never written
    for rl, pl in zip(ring._cache, paged._cache):
        for part in ("k", "v"):
            ring_rows = rl[part][0, :, :n_written].numpy()
            # the one request drew blocks 0, 1, 2 from the free list
            logical = np.concatenate([pl[part][b].numpy() for b in range(3)],
                                     axis=1)[:, :n_written]
            assert np.array_equal(ring_rows, logical), part


def test_prefix_hit_is_identical_and_counted(lm, jax_engine):
    tm, jm = lm
    kw = dict(slots=2, max_len=32, prefill_len=8)
    eng, reg = _port(tm, **kw, **PAGED)
    prompt = _prompts(2, 1, 8, 8)
    first = _run(eng, prompt, [6], temperature=0.0)
    assert reg.get("prefix_cache_hits_total").total() == 0
    assert _run(eng, prompt, [6], temperature=0.0) == first
    assert reg.get("prefix_cache_hits_total").total() == 1
    # 8 tokens in blocks of 4, one token short: one block shared
    assert reg.get("prefix_cache_tokens_total").total() == 4
    assert reg.get("serve_prefill_tokens_total").total() == 8 + 4
    assert first == _run(jax_engine(jm, "paged", **kw, **PAGED), prompt, [6],
                         temperature=0.0)


def test_divergent_prompt_reuses_no_wrong_prefix(lm, jax_engine):
    tm, jm = lm
    kw = dict(slots=2, max_len=32, prefill_len=8, **PAGED)
    eng, reg = _port(tm, **kw)
    rng = np.random.RandomState(4)
    a = rng.randint(0, VOCAB, (8,))
    b = np.concatenate([a[:4], rng.randint(0, VOCAB, (4,))])
    _run(eng, [a], [6], temperature=0.0)
    got = _run(eng, [b], [6], temperature=0.0)
    assert reg.get("prefix_cache_tokens_total").total() == 4
    fresh, _ = _port(tm, **kw)
    assert got == _run(fresh, [b], [6], temperature=0.0)
    assert got == _run(jax_engine(jm, "paged", **kw), [b], [6],
                       temperature=0.0)


def test_speculative_is_plain_greedy_and_jax(lm, jax_engine):
    tm, jm = lm
    kw = dict(slots=2, max_len=48, prefill_len=8, **PAGED)
    prompts = _prompts(11, 6) + [np.array([3, 3, 3, 3, 3, 3])]
    n_new = [10] * len(prompts)
    plain, _ = _port(tm, **kw)
    spec, reg = _port(tm, speculative_k=4, **kw)
    got = _run(spec, prompts, n_new, temperature=0.0)
    assert got == _run(plain, prompts, n_new, temperature=0.0)
    assert got == _run(jax_engine(jm, "spec", speculative_k=4, **kw),
                       prompts, n_new, temperature=0.0)
    proposed = reg.get("speculative_proposed_total").total()
    accepted = reg.get("speculative_accepted_total").total()
    assert proposed > 0 and 0 < accepted <= proposed
    assert abs(reg.get("speculative_accepted_ratio").value()
               - accepted / proposed) < 1e-12
    # accepted drafts: fewer decode ticks than tokens they produced
    assert reg.get("serve_decode_steps_total").total() < \
        reg.get("serve_tokens_total").total() \
        - reg.get("serve_prefill_total").total()
    _one_trace(spec)


def test_eos_inside_a_draft_stops_exactly(lm, jax_engine):
    tm, jm = lm
    kw = dict(slots=1, max_len=48, prefill_len=8, **PAGED)
    prompt = [3, 3, 3, 3, 3]
    plain, _ = _port(tm, **kw)
    ref = _run(plain, [prompt], [12], temperature=0.0)[0]
    eos = ref[min(2, len(ref) - 1)]
    ref_eos = _run(plain, [prompt], [12], temperature=0.0, eos_id=eos)[0]
    assert ref_eos[-1] == eos and len(ref_eos) <= 3
    spec, reg = _port(tm, speculative_k=4, **kw)
    assert _run(spec, [prompt], [12], temperature=0.0, eos_id=eos)[0] == \
        ref_eos
    assert reg.get("speculative_proposed_total").total() > 0
    je = jax_engine(jm, "spec", speculative_k=4, **dict(kw, slots=2))
    assert _run(je, [prompt], [12], temperature=0.0, eos_id=eos)[0] == \
        ref_eos


def _aligned_ids():
    """Both packages' request counters set to one fresh start."""
    start = max(next(jscheduler.Request._ids),
                next(tscheduler.Request._ids)) + 1000
    jscheduler.Request._ids = itertools.count(start)
    tscheduler.Request._ids = itertools.count(start)
    return start


def test_sampled_requests_match_jax_with_aligned_ids(lm, jax_engine):
    tm, jm = lm
    kw = dict(slots=2, max_len=32, prefill_len=8)
    prompts, n_new = _prompts(6, 4), [8, 5, 7, 6]
    sample = dict(temperature=0.8, top_k=7, seed=123)
    eng, _ = _port(tm, **kw)
    start = _aligned_ids()
    got = _run(eng, prompts, n_new, **sample)
    tscheduler.Request._ids = itertools.count(start + 500)
    jscheduler.Request._ids = itertools.count(start)
    want = _run(jax_engine(jm, "ring", **kw), prompts, n_new, **sample)
    assert got == want
    # a speculative engine decodes a sampled request one token a tick,
    # with the same draws
    spec, reg = _port(tm, speculative_k=4, **kw, **PAGED)
    tscheduler.Request._ids = itertools.count(start)
    assert _run(spec, prompts, n_new, **sample) == got
    assert reg.get("speculative_proposed_total").total() == 0
    jscheduler.Request._ids = itertools.count(start + 1000)
    tscheduler.Request._ids = itertools.count(start + 1000)


def test_bf16_mixed_logits_near_jax(lm, jax_engine):
    """Under ``bf16_mixed`` the block weights and the cache are bf16 and
    the logits f32 in both packages, which round at other points: each
    tick's logits within ``BF16_TOL`` of the JAX engine's, for every tick
    before the greedy histories first part."""
    tm, jm = lm
    kw = dict(slots=2, max_len=32, prefill_len=8, policy="bf16_mixed")
    eng, _ = _port(tm, **kw)
    assert eng._cache[0]["k"].dtype == torch.bfloat16
    got = []
    eng._on_logits = lambda kind, out, rows: got.append(np.array(out))
    je = jax_engine(jm, "bf16", **kw)
    want = []
    for name in ("_prefill", "_decode"):
        fn = getattr(je, name)

        def record(*a, fn=fn):
            cache, out = fn(*a)
            want.append(np.asarray(out))
            return cache, out
        setattr(je, name, record)
    try:
        prompts, n_new = _prompts(8, 2, 4, 8), [6, 6]
        t_tok = _run(eng, prompts, n_new, temperature=0.0)
        j_tok = _run(je, prompts, n_new, temperature=0.0)
    finally:
        for name in ("_prefill", "_decode"):
            delattr(je, name)
    assert len(got) == len(want) >= 6
    same = next((i for i in range(6) if t_tok[0][:i + 1] != j_tok[0][:i + 1]
                 or t_tok[1][:i + 1] != j_tok[1][:i + 1]), 6)
    assert same >= 2, (t_tok, j_tok)
    # tick 0 is the prefill of both prompts, tick i + 1 decodes token i + 1
    for t in range(same):
        scale = float(np.abs(want[t]).max())
        assert float(np.abs(got[t] - want[t]).max()) <= BF16_TOL * scale, t
    info = eng.compiled_step_info()
    assert info["policy"]["name"] == "bf16_mixed" and info["n_traces"] == 1


def test_moe_lm_on_the_ring_matches_jax(moe_lm, jax_engine):
    tm, jm = moe_lm
    kw = dict(slots=2, max_len=32, prefill_len=8, prefill_batch=2)
    prompts, n_new = _prompts(9, 5), [6, 8, 4, 7, 5]
    eng, _ = _port(tm, **kw)
    got = _run(eng, prompts, n_new, temperature=0.0)
    assert got == _run(jax_engine(jm, "moe", **kw), prompts, n_new,
                       temperature=0.0)
    _one_trace(eng)


def test_graphed_books_and_eager_give_the_same_logits(lm):
    """``use_graph=False`` runs each program eagerly; the default runs it
    through the capture's books (static buffers): the same logits, bit
    for bit, on every tick."""
    tm, _ = lm
    kw = dict(slots=2, max_len=32, prefill_len=8, speculative_k=3, **PAGED)
    logs = []
    for use_graph in (True, False):
        eng, _ = _port(tm, use_graph=use_graph, **kw)
        seen = []
        eng._on_logits = lambda kind, out, rows, seen=seen: \
            seen.append(np.array(out))
        _run(eng, _prompts(12, 4) + [[3, 3, 3, 3]], [6, 9, 5, 7, 8],
             temperature=0.0)
        _one_trace(eng)
        logs.append(seen)
    assert len(logs[0]) == len(logs[1])
    for a, b in zip(*logs):
        assert np.array_equal(a, b)


# -- refusals, declines, drain ---------------------------------------------

def test_submit_refusals_are_typed(lm):
    tm, jm = lm
    eng, reg = _port(tm, slots=2, max_len=32, prefill_len=4)
    with pytest.raises(ServingError, match="prefill_len"):
        eng.submit(np.arange(9), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ServingError, match="vocab|\\[0, 19\\)"):
        eng.submit([1, VOCAB], max_new_tokens=2)
    assert reg.get("serve_requests_total").value(status="rejected") == 2
    with pytest.raises(ValueError, match="positional-embedding"):
        _pair(0, )[0].compile_serving(slots=2, max_len=128, prefill_len=65)
    # eos stops generation early
    first = _run(eng, [[1, 2]], [20], temperature=0.0)[0][0]
    assert _run(eng, [[1, 2]], [20], temperature=0.0, eos_id=first) == \
        [[first]]


def test_timeout_zero_and_queue_full(lm):
    tm, _ = lm
    eng, reg = _port(tm, slots=1, max_len=32, prefill_len=4,
                     queue_capacity=2)
    fut = eng.submit([1], max_new_tokens=2, timeout=0)
    eng.run_until_idle()
    with pytest.raises(RequestTimeout):
        fut.result(timeout=5)
    assert fut.deliveries == 1
    eng.submit([1], max_new_tokens=2)
    eng.submit([1], max_new_tokens=2)
    with pytest.raises(QueueFull):
        eng.submit([1], max_new_tokens=2)
    eng.run_until_idle()
    late = eng.submit([1], max_new_tokens=2, timeout=0.001)
    time.sleep(0.05)
    eng.run_until_idle()
    with pytest.raises(RequestTimeout):
        late.result(timeout=5)
    assert reg.get("serve_requests_total").value(status="timed_out") == 2


def test_inflight_deadline_raises_request_timeout(lm):
    tm, _ = lm
    eng, _ = _port(tm, slots=1, max_len=32, prefill_len=4)
    fut = eng.submit([1, 2], max_new_tokens=10_000, timeout=0.2)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30 and not fut.done():
        eng.step()
    with pytest.raises(RequestTimeout, match="mid-generation"):
        fut.result(timeout=5)
    assert fut.deliveries == 1 and eng.active_slots() == 0


def test_pool_refusals_at_submit(lm):
    tm, _ = lm
    eng, _ = _port(tm, slots=2, max_len=32, prefill_len=8, kv_blocks=2,
                   **PAGED)
    with pytest.raises(BlockPoolExhausted, match="NEVER"):
        eng.submit([1, 2, 3], max_new_tokens=20)
    eng, _ = _port(tm, slots=2, max_len=16, prefill_len=8, **PAGED)
    with pytest.raises(ServingError, match="max_len"):
        eng.submit([1, 2, 3, 4], max_new_tokens=14)


def test_transient_exhaustion_backpressures_never_evicts(lm):
    tm, _ = lm
    kw = dict(slots=2, max_len=32, prefill_len=8)
    eng, reg = _port(tm, kv_blocks=3, **kw, **PAGED)
    ring, _ = _port(tm, **kw)
    prompts = _prompts(2, 2, 5, 6)
    refs = _run(ring, prompts, [6, 6], temperature=0.0)
    futs = [eng.submit(p, max_new_tokens=6, temperature=0.0)
            for p in prompts]
    eng.step()
    # the second request waits for the first one's blocks
    assert eng.active_slots() == 1 and len(eng.queue) == 1
    eng.run_until_idle()
    assert [f.result(timeout=5)["tokens"] for f in futs] == refs
    assert reg.get("serve_requests_total").value(status="completed") == 2


def test_deadline_sweep_reaches_behind_a_blocked_head():
    q = tscheduler.RequestQueue(8, registry=Registry())
    head = tscheduler.Request([1, 2, 3])
    behind = tscheduler.Request([4, 5], timeout=0)
    q.put(head)
    q.put(behind)
    assert q.pop_batch(2, now=head.submitted_at + 1,
                       admit=lambda r: False) == []
    with pytest.raises(RequestTimeout):
        behind.future.result(timeout=0)
    assert len(q) == 1 and q.pop_batch(1)[0] is head


def test_cached_prefixes_are_evicted_lru(lm):
    tm, _ = lm
    eng, reg = _port(tm, slots=1, max_len=32, prefill_len=8, kv_blocks=3,
                     **PAGED)
    for p in _prompts(3, 4, 6, 6):
        assert len(_run(eng, [p], [4], temperature=0.0)[0]) == 4
    info = eng.compiled_step_info()
    assert info["n_traces"] == 1 and info["kv_blocks_in_use"] == 0
    assert info["kv_blocks_cached"] == 1
    assert reg.get("kv_blocks_in_use").value() == 0
    assert reg.get("kv_blocks_total").value() == 3


def test_layout_declines_and_unknown_options(lm):
    tm, _ = lm
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng, _ = _port(tm, slots=2, max_len=32, prefill_len=8,
                       speculative_k=4)
    assert any("speculative" in str(x.message) for x in w)
    info = eng.compiled_step_info()
    assert info["speculative_k"] == 0
    assert info["speculative_declined"] == "requires_paged_layout"
    with pytest.raises(ValueError, match="kv_layout"):
        _port(tm, slots=2, max_len=32, prefill_len=8, kv_layout="circular")
    with pytest.raises(TypeError, match="prefil_len"):
        tm.compile_serving(slots=2, prefil_len=8)
    with pytest.raises(TypeError, match="batch"):
        tm.compile_serving(batch=16)


@pytest.mark.parametrize("option", sorted(tengine._NOT_PORTED)
                         + ["pool_role", "quantized policy", "drain handoff",
                            "snapshot_slot", "inject_snapshot",
                            "set_transfer", "sharding_specs"])
def test_options_not_ported_name_the_roadmap(lm, option):
    tm, _ = lm
    kw = dict(slots=2, max_len=32, prefill_len=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if option in tengine._NOT_PORTED:
            tm.compile_serving(**{option: 1}, **kw)
        elif option == "pool_role":
            tm.compile_serving(pool_role="prefill", **kw)
        elif option == "quantized policy":
            tm.compile_serving(policy="int8_weight_only", **kw)
        elif option == "drain handoff":
            _port(tm, **kw)[0].drain(1.0, handoff=lambda *a: True)
        elif option == "snapshot_slot":
            _port(tm, **kw)[0].snapshot_slot(0)
        elif option == "inject_snapshot":
            _port(tm, **kw)[0].inject_snapshot({}, b"")
        elif option == "set_transfer":
            _port(tm, **kw)[0].set_transfer(None)
        else:
            tm.decode_adapter().sharding_specs()


def test_drain_finishes_everything_then_refuses(lm):
    tm, _ = lm
    eng, _ = _port(tm, slots=2, max_len=48, prefill_len=8)
    eng.start()
    try:
        futs = [eng.submit([1, 2], max_new_tokens=10, seed=i)
                for i in range(5)]
        assert eng.drain(timeout=60) is True
        assert eng.draining
        for f in futs:
            assert len(f.result(timeout=5)["tokens"]) == 10
            assert f.deliveries == 1
        with pytest.raises(EngineDraining):
            eng.submit([1], max_new_tokens=1)
    finally:
        eng.stop()


def test_stop_fails_queued_and_inflight_once(lm):
    tm, _ = lm
    eng, reg = _port(tm, slots=1, max_len=32, prefill_len=4)
    a = eng.submit([1, 2], max_new_tokens=8)
    b = eng.submit([3], max_new_tokens=8)
    eng.step()
    assert eng.active_slots() == 1
    assert eng.stop() == 1
    for f in (a, b):
        with pytest.raises(EngineDraining):
            f.result(timeout=1)
        assert f.deliveries == 1
    assert reg.get("serve_requests_total").value(status="failed") == 2


@pytest.mark.parametrize("layout", ["ring", "paged_speculative"])
def test_one_input_signature_and_one_build_per_program(lm, layout):
    """Refills of mixed lengths, repeated prompts (prefix hits) and
    speculative ticks: every call of a program has the same signature,
    and each program is built once."""
    tm, _ = lm
    extra = dict(speculative_k=4, **PAGED) if layout != "ring" else {}
    eng, reg = _port(tm, slots=2, max_len=48, prefill_len=8,
                     prefill_batch=1, **extra)
    seen = {"prefill": set(), "decode": set()}
    progs = {name: getattr(eng, f"_{name}") for name in seen}
    for name, prog in progs.items():
        def record(*args, prog=prog, name=name):
            seen[name].add(signature(args))
            return prog(*args)
        setattr(eng, f"_{name}", record)
    rng = np.random.RandomState(0)
    base = rng.randint(0, VOCAB, (8,))
    prompts = [base if i % 2 == 0 else
               rng.randint(0, VOCAB, (int(rng.randint(1, 8)),))
               for i in range(8)]
    _run(eng, prompts, [int(rng.randint(2, 7)) for _ in prompts],
         temperature=0.0)
    for name, prog in progs.items():
        setattr(eng, f"_{name}", prog)
    assert len(seen["prefill"]) == 1 and len(seen["decode"]) == 1
    _one_trace(eng)
    if layout != "ring":
        assert reg.get("prefix_cache_hits_total").total() >= 1
        assert reg.get("speculative_proposed_total").total() > 0
