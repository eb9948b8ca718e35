"""The one token-sampling path every decode surface shares.

The port's own copy of ``singa_tpu/models/decode.py``:
:func:`apply_top_k`, :func:`sample_logits` (host side, numpy) and
:func:`ngram_propose` as they are there, and :func:`sample_logits_torch`,
the twin of ``sample_logits_jax`` (``:64-80``) over torch tensors, which
``TransformerLM.generate`` calls once per decoded token.

``temperature == 0`` is greedy argmax in every form, ties broken toward
the lowest id, so greedy host and device decoding agree exactly.
Otherwise the torch form draws from an explicit ``torch.Generator``, so
its sampled tokens are reproducible from a seed but are not the JAX
package's (another generator).
"""

from __future__ import annotations

import numpy as np


def apply_top_k(logits, top_k):
    """Mask everything below the k-th largest logit to -inf (numpy,
    last axis). ``top_k`` of None/0 or >= vocab is a no-op."""
    logits = np.asarray(logits, np.float64)
    k = int(top_k or 0)
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = np.sort(logits, axis=-1)[..., -k][..., None]
    return np.where(logits < kth, -np.inf, logits)


def sample_logits(logits, temperature=1.0, top_k=None, rng=None):
    """Sample ONE token id from a 1-D logits vector (host side).

    ``temperature == 0`` -> greedy argmax (``rng`` unused). Otherwise
    softmax sampling at ``temperature`` over the ``top_k`` largest
    logits (None/0 = full vocab), drawing from ``rng`` (a
    ``numpy.random.RandomState``; a fresh seed-0 state when omitted)."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if temperature == 0:
        return int(np.argmax(logits))
    lg = apply_top_k(logits / float(temperature), top_k)
    lg = lg - np.max(lg)
    p = np.exp(lg)
    p = p / p.sum()
    if rng is None:
        rng = np.random.RandomState(0)
    return int(rng.choice(len(p), p=p))


def sample_logits_torch(logits, temperature, top_k, generator=None):
    """Device twin of :func:`sample_logits` over the LAST axis of the
    torch tensor ``logits`` (any leading batch dims): int64 ids.
    ``temperature == 0`` is argmax (the first of tied maxima); otherwise
    the softmax of ``logits / temperature`` over its ``top_k`` largest
    entries is sampled with ``generator`` (a ``torch.Generator`` on the
    logits' device)."""
    import torch
    if temperature == 0:
        return torch.argmax(logits, -1)
    lg = logits.float() / float(temperature)
    if top_k and int(top_k) < lg.shape[-1]:
        kth = torch.topk(lg, int(top_k), -1).values[..., -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    p = torch.softmax(lg, -1)
    flat = p.reshape(-1, p.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return ids.reshape(p.shape[:-1])


def ngram_propose(history, k, n=2):
    """Self-drafting n-gram proposer for speculative decoding: up to
    ``k`` draft tokens guessed from the sequence's own history (prompt
    + generated so far), zero model calls.

    Finds the most recent earlier occurrence of the trailing ``n``-gram
    and proposes its continuation; pads by repeating the last proposed
    (or last history) token. Draft quality moves only the speculative
    accept rate, never the output."""
    k = int(k)
    if k <= 0:
        return []
    h = [int(t) for t in history]
    out = []
    if len(h) > n:
        tail = tuple(h[-n:])
        for i in range(len(h) - n - 1, -1, -1):
            if tuple(h[i:i + n]) == tail:
                out = h[i + n:i + n + k]
                break
    while len(out) < k:
        out.append(out[-1] if out else h[-1])
    return out[:k]


__all__ = ["apply_top_k", "sample_logits", "sample_logits_torch",
           "ngram_propose"]
