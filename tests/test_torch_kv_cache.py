"""The port's KV caches (``singa_tpu_torch/serving/kv_cache.py``) against
the JAX package's (``singa_tpu/serving/kv_cache.py``) on the same numpy
inputs.

The device functions: every write is bitwise (the port's in-place writes
against the JAX functions' new arrays, over the real slots and blocks: the
port's spare slot or block, where it writes what the JAX package drops,
is left out), ``write_prompt(valid=False)`` leaves every real slot as it
was and ``write_rows`` drops masked rows; ``ring_positions`` is equal,
the negative "never written" entries included; ``attend`` and
``attend_pages`` agree within 1e-6 (f32 sums in another order). The host
half: a seeded sequence of admissions, releases and prefix matches, with
LRU evictions and refusals, gives the same block ids, refcounts, prefix
hits and gauges in both ``BlockManager``s; the chained prefix keys and
their digests are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu.serving import kv_cache as J
from singa_tpu.serving.scheduler import BlockPoolExhausted as JExhausted

from singa_tpu_torch.serving import kv_cache as T
from singa_tpu_torch.serving.scheduler import BlockPoolExhausted

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

ATT_TOL = 1e-6


def _level_pair(level_np, spare_rows):
    """The same level in both packages; the port's with its spare row."""
    jl = {k: jnp.asarray(v) for k, v in level_np.items()}
    tl = {k: torch.from_numpy(np.concatenate(
        [v, np.zeros((spare_rows,) + v.shape[1:], v.dtype)]))
        for k, v in level_np.items()}
    return jl, tl


def _same(tl, jl):
    for part in ("k", "v"):
        want = np.asarray(jl[part])
        got = tl[part][:want.shape[0]].numpy()
        assert np.array_equal(got, want), part


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= ATT_TOL * max(1.0, float(np.abs(want).max())), \
        f"{what}: {err}"


def test_init_shapes_keep_one_spare_row():
    ring = T.init_cache(3, 2, 8, 4)
    pool = T.init_pool(5, 2, 4, 4)
    assert ring["k"].shape == (4, 2, 8, 4)
    assert pool["v"].shape == (6, 2, 4, 4)
    assert np.array_equal(ring["k"][:3].numpy(),
                          np.asarray(J.init_cache(3, 2, 8, 4)["k"]))


def test_ring_positions_and_mask_match_negative_entries_included():
    pos = np.array([0, 2, 5, 9, 3, 17], np.int32)
    for L in (1, 4, 7):
        want = np.asarray(J.ring_positions(jnp.asarray(pos), L))
        got = T.ring_positions(torch.from_numpy(pos), L).numpy()
        assert (want < 0).any() or L == 1
        assert np.array_equal(got, want)
        assert np.array_equal(
            T.ring_mask(torch.from_numpy(pos), L).numpy(),
            np.asarray(J.ring_mask(jnp.asarray(pos), L)))


def test_write_token_and_attend_through_the_wrap():
    """``tests/test_serving.py::TestRingCache::test_wraparound_vs_
    reference``'s walk: ten tokens through a ring of four, the level
    bitwise and the attention within ``ATT_TOL`` after every token (full
    causal while it fits, sliding window after)."""
    rng = np.random.RandomState(0)
    W, H, L, D = 2, 2, 4, 3
    jl, tl = _level_pair({k: np.zeros((W, H, L, D), np.float32)
                          for k in ("k", "v")}, 1)
    scale = 1.0 / np.sqrt(D)
    for pos in range(10):
        ks = rng.randn(W, H, D).astype(np.float32)
        vs = rng.randn(W, H, D).astype(np.float32)
        p = np.array([pos, max(0, pos - 3)], np.int32)
        jl = J.write_token(jl, jnp.asarray(ks), jnp.asarray(vs),
                           jnp.asarray(p))
        out = T.write_token(tl, torch.from_numpy(ks), torch.from_numpy(vs),
                            torch.from_numpy(p))
        assert out is tl
        _same(tl, jl)
        q = rng.randn(W, H, 1, D).astype(np.float32)
        _close(T.attend(torch.from_numpy(q), tl, torch.from_numpy(p),
                        scale).numpy(),
               J.attend(jnp.asarray(q), jl, jnp.asarray(p), scale),
               f"attend at {pos}")


@pytest.mark.parametrize("valid", [False, True])
def test_write_prompt_respects_the_valid_flag(valid):
    rng = np.random.RandomState(1)
    W, H, L, D, S = 3, 2, 8, 4, 5
    start = {k: rng.randn(W, H, L, D).astype(np.float32) for k in "kv"}
    jl, tl = _level_pair(start, 1)
    rows = rng.randn(H, S, D).astype(np.float32)
    jl = J.write_prompt(jl, 1, jnp.asarray(rows), jnp.asarray(rows * 2),
                        jnp.asarray(valid))
    T.write_prompt(tl, torch.tensor(1), torch.from_numpy(rows),
                   torch.from_numpy(rows * 2), torch.tensor(valid))
    _same(tl, jl)
    if not valid:
        assert np.array_equal(tl["k"][:W].numpy(), start["k"])
    else:
        assert np.array_equal(tl["v"][1, :, :S].numpy(), rows * 2)


def test_write_rows_drops_masked_rows_and_attend_pages():
    rng = np.random.RandomState(2)
    N, H, bs, D, R, Q, P = 9, 2, 4, 3, 3, 5, 4
    start = {k: rng.randn(N, H, bs, D).astype(np.float32) for k in "kv"}
    jl, tl = _level_pair(start, 1)
    tables = np.stack([rng.permutation(N)[:P] for _ in range(R)]
                      ).astype(np.int32)
    # rows 0 and 1 at distinct pages; row 2's table repeats row 1's, its
    # rows all masked (what the engine sends for an inactive slot)
    tables[2] = tables[1]
    pos = np.stack([np.arange(Q) + s for s in (0, 6, 6)]).astype(np.int32)
    wmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0] * 5], bool)
    k_new = rng.randn(R, H, Q, D).astype(np.float32)
    v_new = rng.randn(R, H, Q, D).astype(np.float32)
    jl = J.write_rows(jl, jnp.asarray(tables), jnp.asarray(k_new),
                      jnp.asarray(v_new), jnp.asarray(pos),
                      jnp.asarray(wmask))
    T.write_rows(tl, torch.from_numpy(tables), torch.from_numpy(k_new),
                 torch.from_numpy(v_new), torch.from_numpy(pos),
                 torch.from_numpy(wmask))
    _same(tl, jl)
    # the dropped rows changed nothing of the real blocks
    written = {(int(tables[r, pos[r, q] // bs]), int(pos[r, q] % bs))
               for r in range(R) for q in range(Q) if wmask[r, q]}
    for b in range(N):
        for o in range(bs):
            if (b, o) not in written:
                assert np.array_equal(tl["k"][b, :, o].numpy(),
                                      start["k"][b, :, o])
    gk, gv = T.gather_pages(tl, torch.from_numpy(tables))
    wk, wv = J.gather_pages(jl, jnp.asarray(tables))
    assert np.array_equal(gk.numpy(), np.asarray(wk))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    q = rng.randn(R, H, Q, D).astype(np.float32)
    _close(T.attend_pages(torch.from_numpy(q), tl, torch.from_numpy(tables),
                          torch.from_numpy(pos), 0.5).numpy(),
           J.attend_pages(jnp.asarray(q), jl, jnp.asarray(tables),
                          jnp.asarray(pos), 0.5), "attend_pages")


def test_chain_keys_prefix_key_and_affinity_hash():
    rng = np.random.RandomState(3)
    for n in (1, 3, 4, 9, 16, 17):
        prompt = rng.randint(0, 50, (n,)).tolist()
        for bs in (1, 4, 5):
            assert T.chain_keys(prompt, bs) == J.chain_keys(prompt, bs)
            key = T.prefix_chain_key(prompt, bs)
            assert key == J.prefix_chain_key(prompt, bs)
            assert T.affinity_hash(key, "r1") == J.affinity_hash(key, "r1")


def _mgr_state(m):
    return (list(m._ref), m.blocks_live(), m.blocks_cached(),
            m.blocks_free(), sorted(m._cache.values()))


def test_block_manager_seeded_sequence_matches():
    """200 seeded operations on a 12-block pool of 4-token blocks: admits
    of prompts drawn from a few shared stems (prefix hits, refusals when
    the pool is short, LRU eviction of cached blocks), releases in a
    random order and prefix matches; after each, the same outcome and
    the same books."""
    rng = np.random.RandomState(4)
    tm, jm = T.BlockManager(12, 4), J.BlockManager(12, 4)
    stems = [rng.randint(0, 9, (12,)).tolist() for _ in range(3)]
    live = []
    evicted = refused = hits = 0
    for _ in range(200):
        op = rng.randint(3)
        stem = stems[rng.randint(len(stems))]
        prompt = stem[:rng.randint(1, 13)] + \
            rng.randint(0, 9, (rng.randint(0, 4),)).tolist()
        if op == 0 or not live:
            total = len(prompt) + int(rng.randint(1, 8))
            shared, _ = tm.match_prefix(prompt)
            short = tm.n_for(total) - len(shared) > tm.blocks_free()
            try:
                a = tm.admit(prompt, total)
            except BlockPoolExhausted:
                with pytest.raises(JExhausted):
                    jm.admit(prompt, total)
                refused += 1
                continue
            b = jm.admit(prompt, total)
            assert (a.blocks, a.shared_tokens, a.prompt_blocks) == \
                (b.blocks, b.shared_tokens, b.prompt_blocks)
            hits += a.shared_tokens > 0
            evicted += short        # the free list ran dry: LRU reclaim
            live.append((prompt, a, b))
        elif op == 1:
            prompt, a, b = live.pop(rng.randint(len(live)))
            tm.release(a, prompt)
            jm.release(b, prompt)
        else:
            assert tm.match_prefix(prompt) == jm.match_prefix(prompt)
            assert tm.can_admit(prompt, len(prompt) + 3) == \
                jm.can_admit(prompt, len(prompt) + 3)
        assert _mgr_state(tm) == _mgr_state(jm)
    assert refused and hits and evicted


def test_match_prefix_is_capped_one_token_short():
    for mgr in (T.BlockManager(8, 4), J.BlockManager(8, 4)):
        prompt = list(range(8))
        mgr.release(mgr.admit(prompt, 8), prompt)
        ids, n = mgr.match_prefix(prompt)
        assert (len(ids), n) == (1, 4)


def test_quantized_levels_and_the_spill_tier_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_cache(2, 1, 4, 2, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_pool(2, 1, 4, 2, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.HostSpillTier(1 << 20)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.BlockManager(4, 2).attach_spill(None, None, None)
