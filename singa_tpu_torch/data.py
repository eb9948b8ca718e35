"""In-memory batch iteration with a stateless, checkpointable shuffle.

Counterpart of ``singa_tpu/data.py:49-58`` (:func:`epoch_permutation`)
and ``:617-740`` (:class:`NumpyBatchIter`). An epoch's sample order is a
pure function of ``(seed, epoch)`` -- the same numpy generator as the JAX
package, so both packages draw the same order for a seed -- and an
iterator's state is just ``{epoch, position}``: ``state_dict()`` /
``load_state_dict()`` resume the exact sample stream. The image-list
reader (:class:`ImageBatchIter` raises), the device prefetcher and the
fault-isolating wrappers of the JAX package's pipeline are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import warnings

import numpy as np


def epoch_permutation(seed, epoch, n):
    """The sample order of epoch ``epoch``: a pure function of
    ``(seed, epoch)``, derived on demand, never stored."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(epoch)])
    return np.random.Generator(np.random.PCG64(ss)).permutation(int(n))


def _check_state_source(it, state):
    """A state saved over another dataset size cannot resume the same
    stream (warn); a different seed can, by adopting the saved one."""
    n = state.get("num_samples")
    if n is not None and int(n) != int(it.num_samples):
        warnings.warn(
            f"data state was saved over {n} samples but this iterator "
            f"holds {it.num_samples}; the resumed stream will NOT "
            "match the saved one (did the dataset change?)",
            stacklevel=3)
    seed = state.get("seed")
    if seed is not None and int(seed) != int(it.seed):
        warnings.warn(
            f"data state carries seed {seed} but this iterator was "
            f"built with seed {it.seed}; adopting the SAVED seed so "
            "the resumed stream matches the checkpoint", stacklevel=3)
        it.seed = int(seed)


class NumpyBatchIter:
    """Batches over in-memory arrays with a stateless epoch shuffle.

    ``batch_size`` is the per-rank batch; with ``world > 1`` epoch ``e``'s
    global order ``epoch_permutation(seed, e, n)`` is consumed
    ``batch_size * world`` samples per step, rank ``r`` reading the
    ``r``-th slice of each global batch. The state counts GLOBAL samples,
    so it resumes any rank or world size at the same point.

    ``pad_last=True`` (implies ``drop_last=False``) pads the ragged last
    batch to ``batch_size`` and yields ``(x, y, mask)`` for every batch.
    ``last_batch_ids`` holds the dataset indices of the latest batch.
    """

    def __init__(self, x, y, batch_size, shuffle=True, drop_last=True,
                 seed=0, pad_last=False, rank=0, world=1):
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_last = bool(pad_last)
        self.drop_last = False if pad_last else drop_last
        self.seed = int(seed)
        self.rank = int(rank)
        self.world = max(1, int(world))
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {rank} outside world {world}")
        if self.world > 1 and not self.drop_last and not self.pad_last:
            raise ValueError(
                "NumpyBatchIter with world > 1 and drop_last=False "
                "requires pad_last=True (the ragged last global batch "
                "would yield rank-divergent, possibly empty, slices)")
        self._epoch = 0
        self._position = 0      # GLOBAL samples consumed this epoch
        self.last_batch_ids = None

    @property
    def num_samples(self):
        return len(self.x)

    @property
    def global_batch(self):
        return self.batch_size * self.world

    @property
    def num_batches(self):
        n = len(self.x) // self.global_batch
        if not self.drop_last and len(self.x) % self.global_batch:
            n += 1
        return n

    def _epoch_samples(self):
        n = len(self.x)
        if self.drop_last:
            return (n // self.global_batch) * self.global_batch
        return n

    def state_dict(self):
        return {"kind": "NumpyBatchIter", "epoch": int(self._epoch),
                "position": int(self._position), "seed": self.seed,
                "num_samples": int(len(self.x))}

    def load_state_dict(self, state):
        _check_state_source(self, state)
        self._epoch = int(state.get("epoch", 0))
        self._position = int(state.get("position", 0))
        self.last_batch_ids = None

    def __iter__(self):
        n = len(self.x)
        end = self._epoch_samples()
        if end <= 0:
            return
        if self._position >= end:
            # the previous epoch was fully consumed: wrap
            self._epoch += 1
            self._position = 0
        epoch = self._epoch
        idx = epoch_permutation(self.seed, epoch, n) if self.shuffle \
            else np.arange(n)
        while self._position < end and self._epoch == epoch:
            pos = self._position
            take = min(self.global_batch, end - pos)
            lo = pos + self.rank * self.batch_size
            hi = min(pos + (self.rank + 1) * self.batch_size, pos + take)
            sel = idx[lo:hi] if lo < pos + take else idx[:0]
            # the position advances before the batch is handed out, so a
            # state taken after the caller's step counts it exactly once
            self._position = pos + take
            self.last_batch_ids = np.asarray(sel, np.int64)
            bx, by = self.x[sel], self.y[sel]
            if self.pad_last:
                mask = np.zeros(self.batch_size, np.float32)
                mask[:len(sel)] = 1.0
                if len(sel) < self.batch_size:
                    pad = self.batch_size - len(sel)
                    bx = np.concatenate(
                        [bx, np.zeros((pad,) + bx.shape[1:], bx.dtype)])
                    by = np.concatenate(
                        [by, np.zeros((pad,) + by.shape[1:], by.dtype)])
                yield bx, by, mask
            else:
                yield bx, by


class ImageBatchIter:
    """The image-list reader (``singa_tpu/data.py:107``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "data.ImageBatchIter is not ported yet (ROADMAP.md: Queue 1 "
            "item 2)")
