"""Fixed-shape KV caches: ring buffers and the paged block pool.

Counterpart of ``singa_tpu/serving/kv_cache.py``. The serving engine's two
programs keep one shape forever (each is captured once into a CUDA graph),
so the attention cache cannot grow with the sequence. Two layouts:

**Ring** (the default): each slot owns a ring of ``length`` key/value rows
per layer; token ``t`` writes ring index ``t % length`` and the decode
attention masks each index by the token position it holds::

    t_j = p - ((p - j) mod length)       # newest token position at j
    valid(j) = t_j >= 0                  # j was ever written

(``mod`` is the floor modulo, ``torch.remainder``: ``t_j`` is negative
for an index never written). Semantically the ring is sliding-window
attention over the last ``length`` tokens, and full causal attention while
the sequence fits.

**Paged** (``kv_layout="paged"``): one pool of ``(n_blocks, n_heads,
block_size, head_dim)`` blocks per layer and a host-side block table per
slot mapping logical block ``position // block_size`` to a pool block.
:class:`BlockManager` owns allocation, refcounts and the prefix cache
(identical prompt prefixes share refcounted blocks; a hit skips their
prefill); exhaustion is a typed admission refusal, and only unreferenced
cached prefixes are ever reclaimed (LRU). The device math is
position-exact (a query attends every cached position ``<=`` its own), so
the rows of a freed sequence or a rejected speculative draft are
unreachable until overwritten.

The device functions update a level IN PLACE and return it: the engine's
programs are CUDA graphs, which write their state in place where the JAX
package donates it. Where the JAX package drops a write (``write_rows``
scatters masked rows out of bounds with ``mode="drop"``,
``write_prompt(valid=False)`` keeps the old level with a ``where``), a
write here goes to a spare row instead: a ring level holds one spare slot
after its ``n_slots`` and a pool one spare block after its ``n_blocks``.
The spare is written to, never in a table and never attended, and is no
part of the KV state the engine reports. No shape or index depends on the
data, so every write captures.

Float caches only: the int8 levels (``k_scale``/``v_scale``) need the
quantization code, which is not ported yet (ROADMAP.md, slice D2).
Host-RAM spill of evicted prefix blocks (:class:`HostSpillTier`,
``BlockManager.attach_spill``) needs ``integrity.py``'s frames and raises
likewise.
"""

from __future__ import annotations

import hashlib

import torch

from .scheduler import BlockPoolExhausted


# ---------------------------------------------------------------------------
# chained prefix content keys
# ---------------------------------------------------------------------------

def chain_keys(prompt, block_size):
    """Chained content keys for each full block of ``prompt``: key ``b``
    covers block ``b``'s tokens and everything before it, so a key match
    guarantees the whole preceding context matches."""
    bs = int(block_size)
    keys, prev = [], ()
    for b in range(len(prompt) // bs):
        prev = (prev, tuple(int(t) for t in prompt[b*bs:(b+1)*bs]))
        keys.append(prev)
    return keys


def prefix_chain_key(prompt, block_size):
    """The chained key of ``prompt``'s longest cacheable full-block prefix,
    capped one token short of the whole prompt; ``None`` for a prompt too
    short to share one block."""
    cap = (len(prompt) - 1) // int(block_size)
    if cap <= 0:
        return None
    return chain_keys(prompt, block_size)[cap - 1]


def affinity_hash(key, salt=""):
    """Stable 64-bit digest of a chain key (sha1 of its repr; python's
    ``hash()`` is randomised per process)."""
    h = hashlib.sha1((repr(key) + "\x00" + str(salt)).encode()).digest()
    return int.from_bytes(h[:8], "big")


# ---------------------------------------------------------------------------
# ring cache: device math
# ---------------------------------------------------------------------------

def _float_level(dtype):
    if not torch.empty(0, dtype=dtype).is_floating_point():
        raise NotImplementedError(
            f"a {dtype} KV cache needs the quantization code, which is not "
            "ported yet (ROADMAP.md: slice D2, quantized serving)")


def init_cache(n_slots, n_heads, length, head_dim, dtype=torch.float32,
               device=None):
    """One layer's ring cache: zeroed ``{"k","v"}`` of shape ``(n_slots +
    1, n_heads, length, head_dim)``; slot ``n_slots`` is the spare."""
    _float_level(dtype)
    shape = (int(n_slots) + 1, int(n_heads), int(length), int(head_dim))
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ring_positions(pos, length):
    """For newest-written position ``pos`` (``(W,)``), the token position
    held at each ring index: ``(W, length)`` int64; negative entries mean
    "never written"."""
    j = torch.arange(length, device=pos.device)
    pos = pos.long()[:, None]
    return pos - torch.remainder(pos - j[None, :], length)


def ring_mask(pos, length):
    """``(W, length)`` bool: ring entries holding a real token."""
    return ring_positions(pos, length) >= 0


def write_token(level, k_new, v_new, pos):
    """Write one new token per slot at its ring index ``pos % L``.
    ``k_new``/``v_new``: ``(W, H, D)``; ``pos``: ``(W,)``. Every slot is
    written (a dead slot is never attended, and its next occupant's
    prefill overwrites every row the mask can reach)."""
    L = level["k"].shape[2]
    W = k_new.shape[0]
    rows = torch.arange(W, device=k_new.device)
    idx = torch.remainder(pos.long(), L)
    level["k"][rows, :, idx] = k_new.to(level["k"].dtype)
    level["v"][rows, :, idx] = v_new.to(level["v"].dtype)
    return level


def write_prompt(level, slot, k_rows, v_rows, valid):
    """Write one prompt's rows into one slot from ring index 0.
    ``k_rows``/``v_rows``: ``(H, S, D)``, ``S <= L``; ``slot`` and
    ``valid``: 0-d tensors on the level's device. An invalid row (prefill
    batch padding) is written to the spare slot, so the real slots keep
    what they held."""
    spare = level["k"].shape[0] - 1
    S = k_rows.shape[1]
    row = torch.where(valid, slot.long(), spare).reshape(1)
    level["k"][:, :, :S].index_copy_(0, row,
                                     k_rows[None].to(level["k"].dtype))
    level["v"][:, :, :S].index_copy_(0, row,
                                     v_rows[None].to(level["v"].dtype))
    return level


def attend(q, level, pos, scale):
    """Ring attention for one decode tick. ``q``: ``(W, H, 1, D)`` (its
    k/v already written); ``pos``: ``(W,)``. Softmax in f32 whatever the
    cache dtype, the result cast back to ``q.dtype``: ``(W, H, 1, D)``."""
    W = q.shape[0]
    L = level["k"].shape[2]
    k, v = level["k"][:W], level["v"][:W]
    s = torch.einsum("whqd,whld->whql", q.float(), k.float()) * scale
    mask = ring_mask(pos, L)[:, None, None, :]
    s = torch.where(mask, s, float("-inf"))
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("whql,whld->whqd", a, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# paged block pool: device math
# ---------------------------------------------------------------------------

def init_pool(n_blocks, n_heads, block_size, head_dim, dtype=torch.float32,
              device=None):
    """One layer's block pool: zeroed ``{"k","v"}`` of shape ``(n_blocks +
    1, n_heads, block_size, head_dim)``; block ``n_blocks`` is the
    spare."""
    _float_level(dtype)
    shape = (int(n_blocks) + 1, int(n_heads), int(block_size),
             int(head_dim))
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_rows(level, tables, k_new, v_new, pos, wmask):
    """Write token rows into their block-table-mapped pool rows.
    ``tables``: ``(R, n_pages)`` pool block ids; ``k_new``/``v_new``:
    ``(R, H, Q, D)``; ``pos``: ``(R, Q)`` absolute positions; ``wmask``:
    ``(R, Q)`` bool. A masked row (batch padding, an inactive slot, draft
    padding) goes to the spare block. One indexed write per tensor."""
    N = level["k"].shape[0] - 1
    bs = level["k"].shape[2]
    pos = pos.long()
    # a masked row's page may lie past the table: clamp, it is dropped
    page = torch.gather(tables.long(), 1,
                        (pos // bs).clamp(0, tables.shape[1] - 1))
    page = torch.where(wmask, page, N).reshape(-1)
    off = torch.remainder(pos, bs).reshape(-1)
    R, H, Q, D = k_new.shape

    def flat(a):
        return a.permute(0, 2, 1, 3).reshape(R * Q, H, D)
    level["k"][page, :, off] = flat(k_new).to(level["k"].dtype)
    level["v"][page, :, off] = flat(v_new).to(level["v"].dtype)
    return level


def gather_pages(level, tables):
    """Each row's logical KV view from its block table: ``(R, n_pages)`` ->
    ``k, v`` of ``(R, H, n_pages * block_size, D)``, logical index ==
    token position. Unallocated table entries gather rows the caller's
    position mask never admits."""
    t = tables.long()
    k, v = level["k"][t], level["v"][t]          # (R, P, H, bs, D)
    R, P, H, bs, D = k.shape
    k = k.permute(0, 2, 1, 3, 4).reshape(R, H, P * bs, D)
    v = v.permute(0, 2, 1, 3, 4).reshape(R, H, P * bs, D)
    return k, v


def attend_positions(q, k, v, q_pos, scale):
    """Position-exact causal attention over logical KV rows: each query of
    ``q`` ``(R, H, Q, D)`` at position ``q_pos`` ``(R, Q)`` attends every
    row ``l <= q_pos`` of ``k``/``v`` ``(R, H, L, D)`` (row index ==
    token position). Softmax in f32, the result cast back to ``q.dtype``:
    ``(R, H, Q, D)``. The paged programs and the ring's prefill share it,
    so a sequence's rows come out of both layouts bit for bit alike."""
    L = k.shape[2]
    s = torch.einsum("rhqd,rhld->rhql", q.float(), k.float()) * scale
    mask = torch.arange(L, device=q.device)[None, None, None, :] \
        <= q_pos.long()[:, None, :, None]
    s = torch.where(mask, s, float("-inf"))
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("rhql,rhld->rhqd", a, v.float())
    return out.to(q.dtype)


def attend_pages(q, level, tables, q_pos, scale):
    """Paged causal attention: each query attends every cached position
    ``<=`` its own through its row's block table. ``q``: ``(R, H, Q, D)``;
    ``q_pos``: ``(R, Q)``; returns ``(R, H, Q, D)`` in ``q.dtype``."""
    kf, vf = gather_pages(level, tables)
    return attend_positions(q, kf, vf, q_pos, scale)


# ---------------------------------------------------------------------------
# host-RAM spill tier (not ported)
# ---------------------------------------------------------------------------

def _spill_not_ported():
    return NotImplementedError(
        "the host-RAM spill tier of evicted prefix blocks needs "
        "integrity.py's CRC frames, which are not ported yet (ROADMAP.md: "
        "slice D2)")


class HostSpillTier:
    """Byte-budgeted host-RAM tier for evicted cached-prefix blocks: not
    ported yet (ROADMAP.md, slice D2)."""

    def __init__(self, budget_bytes):
        raise _spill_not_ported()


# ---------------------------------------------------------------------------
# paged block pool: host-side manager
# ---------------------------------------------------------------------------

class SlotAlloc:
    """One admitted sequence's block reservation: the pool block ids
    covering its ``prompt + max_new_tokens`` span (shared prefix blocks
    first), how many prompt tokens the prefix hit covers
    (``shared_tokens``; prefill skips them), and how many leading blocks
    hold full prompt content (``prompt_blocks``; cacheable on release)."""

    __slots__ = ("blocks", "shared_tokens", "prompt_blocks")

    def __init__(self, blocks, shared_tokens, prompt_blocks):
        self.blocks = list(blocks)
        self.shared_tokens = int(shared_tokens)
        self.prompt_blocks = int(prompt_blocks)


class BlockManager:
    """Host-side block accounting for one engine's pool (the loop thread's
    alone). Block states: free (on the free list), live (refcount > 0,
    never reclaimed), cached (refcount 0, registered in the prefix cache
    under its chained content key: reclaimable, LRU)."""

    def __init__(self, n_blocks, block_size):
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._ref = [0] * self.n_blocks
        self._key = [None] * self.n_blocks      # prefix-cache key or None
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._cache = {}                        # chained key -> block id
        self._lru = {}                          # block id -> stamp
        self._tick = 0

    def attach_spill(self, tier, reader, writer, on_spill=None,
                     on_restore=None):
        raise _spill_not_ported()

    def blocks_live(self):
        return sum(1 for r in self._ref if r > 0)

    def blocks_cached(self):
        return sum(1 for i, r in enumerate(self._ref)
                   if r == 0 and self._key[i] is not None)

    def blocks_free(self):
        return len(self._free)

    def n_for(self, n_tokens):
        """Blocks covering ``n_tokens`` positions."""
        return -(-int(n_tokens) // self.block_size)

    def match_prefix(self, prompt):
        """Longest cached full-block prefix of ``prompt``, capped one token
        short of the whole prompt (its last token is always prefilled, so
        its logits exist): ``(block_ids, n_tokens)``, no reference
        taken."""
        cap = (len(prompt) - 1) // self.block_size
        ids = []
        for key in chain_keys(prompt, self.block_size)[:cap]:
            bid = self._cache.get(key)
            if bid is None:
                break
            ids.append(bid)
        return ids, len(ids) * self.block_size

    def _reclaimable(self, shared):
        """Free plus cached blocks, but those of ``shared`` (about to be
        live for the same admission)."""
        keep = set(shared)
        cached = sum(1 for i, r in enumerate(self._ref)
                     if r == 0 and self._key[i] is not None
                     and i not in keep)
        return len(self._free) + cached

    def can_admit(self, prompt, total_tokens):
        """Whether :meth:`admit` would succeed now."""
        shared, _ = self.match_prefix(prompt)
        need = self.n_for(total_tokens) - len(shared)
        return need <= self._reclaimable(shared)

    def admit(self, prompt, total_tokens):
        """Reserve every block the sequence can touch (positions ``[0,
        total_tokens)``): the shared prefix blocks re-referenced first,
        the rest from the free list, reclaiming LRU cached blocks when it
        runs dry. Raises :class:`BlockPoolExhausted` when that would need
        a live block."""
        shared, shared_tokens = self.match_prefix(prompt)
        need = self.n_for(total_tokens) - len(shared)
        if need > self._reclaimable(shared):
            raise BlockPoolExhausted(
                f"block pool exhausted: need {need} free blocks for a "
                f"{total_tokens}-token reservation ({len(shared)} "
                f"shared), have {len(self._free)} free + "
                f"{self.blocks_cached()} reclaimable cached "
                f"({self.blocks_live()} live blocks are never evicted; "
                f"pool is {self.n_blocks} x {self.block_size} tokens)")
        self._tick += 1
        for bid in shared:
            self._ref[bid] += 1
            self._lru[bid] = self._tick
        fresh = [self._take_free() for _ in range(need)]
        return SlotAlloc(shared + fresh, shared_tokens,
                         len(prompt) // self.block_size)

    def _take_free(self):
        if not self._free:
            self._evict_lru()
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def _evict_lru(self):
        """Reclaim the least-recently-used cached block (refcount 0)."""
        victim = min(
            (i for i in range(self.n_blocks)
             if self._ref[i] == 0 and self._key[i] is not None),
            key=lambda i: self._lru.get(i, 0))
        del self._cache[self._key[victim]]
        self._key[victim] = None
        self._lru.pop(victim, None)
        self._free.append(victim)

    def release(self, alloc, prompt):
        """Drop a finished or failed sequence's references. Its full
        prompt blocks enter the prefix cache (refcount 0, reclaimable);
        the partial tail and generated blocks free at once."""
        keys = chain_keys(prompt, self.block_size)
        self._tick += 1
        for i, bid in enumerate(alloc.blocks):
            self._ref[bid] -= 1
            if i < alloc.prompt_blocks and self._key[bid] is None \
                    and keys[i] not in self._cache:
                self._key[bid] = keys[i]
                self._cache[keys[i]] = bid
                self._lru[bid] = self._tick
            if self._ref[bid] == 0 and self._key[bid] is None:
                self._free.append(bid)


__all__ = ["init_cache", "ring_positions", "ring_mask", "write_token",
           "write_prompt", "attend", "init_pool", "write_rows",
           "gather_pages", "attend_positions", "attend_pages", "SlotAlloc",
           "BlockManager", "HostSpillTier", "chain_keys",
           "prefix_chain_key", "affinity_hash"]
