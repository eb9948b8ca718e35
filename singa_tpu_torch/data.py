"""The data pipeline: checkpointable, deterministic, fault-isolating.

Counterpart of ``singa_tpu/data.py``. :class:`ImageBatchIter` streams
(images, labels) batches from an image-list file through a worker (a
thread, or a forked process) and a bounded queue, so that decoding and
augmentation overlap the step; :class:`NumpyBatchIter` batches in-memory
arrays; :class:`RetryingIterator` retries a failing source;
:class:`DevicePrefetcher` keeps the next batches' host-to-device copies in
flight (on the card: pinned staging buffers, copies on a side CUDA
stream, one event per batch that the consumer's stream waits on).

Every iterator here keeps the JAX package's state protocol::

    state = it.state_dict()        # a small JSON-able dict
    it2.load_state_dict(state)     # resume the exact sample stream

An epoch's sample order is a pure function of ``(seed, epoch)``
(:func:`epoch_permutation`, the same numpy generator as the JAX package,
so both packages draw the same order for a seed), so a state is just
counters (``{epoch, position, ...}``). ``state_dict()`` counts the
batches the consumer has taken, never the batches still in a queue: a
batch prefetched but not consumed is replayed after a restore, not
dropped. The host outputs (batches, ``ids``, states, quarantine records)
are the JAX package's, bit for bit, for the same list file and seed.

Left out: ``ImageBatchIter(faults=...)`` takes a
``resilience.faults.FaultPlan``, which is ROADMAP.md slice E; a non-None
``faults`` raises.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import tempfile
import time
import types
import warnings
from collections import deque
from queue import Empty, Full, Queue as _TQueue
from threading import Thread

import numpy as np

from .observability import metrics as _obs_metrics

# The process worker is forked, as the JAX package's is: the transform
# may be any callable (a lambda, a closure), which a spawned or
# forkserver child could not receive. The child touches only the list
# file, numpy, PIL (through the transform) and the queue; nothing of
# torch or CUDA. ``ImageBatchIter.start`` freezes the collector around
# the fork, so that the child never collects, and frees, an object it
# inherited (a CUDA tensor or graph freed in a forked child fails).
_FORK = multiprocessing.get_context("fork")


def _quarantine_counter():
    return _obs_metrics.default_registry().counter(
        "data_quarantined_total",
        "corrupt samples skipped and attributed by the pipeline")


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


def can_load_state(obj):
    """True when ``obj`` can load a saved data state. A delegating
    wrapper (a :class:`DevicePrefetcher` around a plain generator has the
    method but nothing to apply it to) answers through its own
    ``can_load_state()`` for the source inside."""
    probe = getattr(obj, "can_load_state", None)
    if callable(probe):
        return bool(probe())
    return callable(getattr(obj, "load_state_dict", None))


def raise_retried_failure(failed):
    """The closed-generator-after-retry rule: a ``StopIteration`` right
    after a retried error on a source that cannot be rebuilt is the
    closed generator, not the end of the data, so the original failure is
    raised again instead of the stream ending early. A no-op when no
    retried failure is pending."""
    if failed is not None:
        raise failed from None


class DataWorkerKilled(BaseException):
    """Raised by a transform to kill the prefetch worker abruptly: no
    error record, no goodbye, so the consumer's attribution of a dead
    worker is what runs. A BaseException, so that the worker's skip and
    error handlers do not take it."""


class DataSampleError(RuntimeError):
    """A pipeline failure attributed to a named sample: ``sample`` is the
    ``{epoch, index, path, error}`` record of the sample at fault, when
    known, and ``quarantined`` every sample skipped so far."""

    def __init__(self, message, sample=None, quarantined=None):
        super().__init__(message)
        self.sample = sample
        self.quarantined = list(quarantined or [])


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
    """Iterate over (images, labels) batches from an image list file.

    ``img_list_file``: each line is ``<relative path><delimiter><label>``.
    ``image_transform``: path -> list of augmented images (numpy arrays or
    PIL images; several augmentations multiply the batch). A batch is
    ``(np.stack(images) as float32, labels as int32)``;
    ``last_batch_ids`` holds the list indices of its samples.

    Shuffling is the stateless :func:`epoch_permutation` of ``(seed,
    epoch)``; ``state_dict()``/``load_state_dict()`` resume the exact
    stream from the last batch consumed (batches still in the queue are
    decoded again after a restart: replayed, never dropped).

    Fault isolation: a sample whose decode or transform raises is
    skipped, counted, and recorded in ``quarantined`` (epoch, list index,
    path, error), up to ``skip_budget`` skips in all; past it the
    iterator raises :class:`DataSampleError` naming the sample (the
    default budget of 0 fails at the first bad sample). A worker that
    dies outright is reported with the sample it was decoding: thread
    mode shares it in memory, process mode writes it to a file before
    each decode, which the parent reads after the death.

    ``use_process=False`` (the default) prefetches on a daemon thread (PIL
    and numpy release the GIL for the heavy work); ``use_process=True``
    forks a worker process (see ``_FORK``). ``faults`` (a
    ``resilience.faults.FaultPlan`` in the JAX package) is not ported:
    anything but None raises.
    """

    def __init__(self, img_list_file, batch_size, image_transform,
                 shuffle=True, delimiter=" ", image_folder=None,
                 capacity=10, use_process=False, seed=0,
                 skip_budget=0, faults=None):
        if faults is not None:
            raise NotImplementedError(
                "ImageBatchIter(faults=...) takes a resilience.faults."
                "FaultPlan, which is not ported yet (ROADMAP.md: Queue 1 "
                "item 5, slice E)")
        self.img_list_file = img_list_file
        self.use_process = use_process
        self.capacity = capacity
        self.queue = _FORK.Queue(capacity) if use_process \
            else _TQueue(capacity)
        self.batch_size = batch_size
        self.image_transform = image_transform
        self.shuffle = shuffle
        self.delimiter = delimiter
        self.image_folder = image_folder or ""
        self.seed = int(seed)
        self.skip_budget = int(skip_budget)
        self.stop = False
        self.p = None
        # the consumed state: it moves only when __next__ hands a batch out
        self._epoch = 0
        self._position = 0
        self.skip_count = 0
        self.quarantined = []
        self.last_batch_ids = None
        # the sample being decoded now (thread mode), or the file the
        # process worker writes it to before each decode
        self._current_sample = None
        self._attr_path = None
        self._gen_id = 0
        with open(img_list_file, "r") as fd:
            self.num_samples = sum(1 for line in fd if line.strip())

    # -- state protocol ----------------------------------------------------
    def state_dict(self):
        """The consumed stream's state. ``seed`` and ``num_samples`` ride
        along to check a resume against."""
        return {"kind": "ImageBatchIter", "epoch": int(self._epoch),
                "position": int(self._position), "seed": self.seed,
                "num_samples": int(self.num_samples),
                "skip_count": int(self.skip_count),
                "quarantined": [dict(q) for q in self.quarantined]}

    def load_state_dict(self, state):
        """Move to ``state``; a running worker is ended, and the next
        fetch starts one from the loaded offset."""
        if self.p is not None:
            self.end()
        _check_state_source(self, state)
        self._epoch = int(state.get("epoch", 0))
        self._position = int(state.get("position", 0))
        self.skip_count = int(state.get("skip_count", 0))
        self.quarantined = [dict(q)
                            for q in state.get("quarantined", [])]
        self.last_batch_ids = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.stop = False
        # a fresh queue and generation per worker: a batch that a dying
        # worker put during end()'s drain never reaches a restarted
        # iterator (and a stale record is dropped by __next__)
        self._gen_id += 1
        self.queue = _FORK.Queue(self.capacity) if self.use_process \
            else _TQueue(self.capacity)
        start_state = (self._epoch, self._position, self.skip_count)
        if self.use_process:
            self._remove_attr_file()
            self._attr_path = os.path.join(
                tempfile.gettempdir(),
                f"singa-data-attr-{os.getpid()}-{id(self)}-"
                f"{self._gen_id}.json")
            self.p = _FORK.Process(target=self.run,
                                   args=(self._gen_id, start_state,
                                         self._attr_path))
        else:
            self.p = Thread(target=self.run,
                            args=(self._gen_id, start_state))
        self.p.daemon = True
        if self.use_process:
            import gc
            gc.freeze()
            try:
                self.p.start()
            finally:
                gc.unfreeze()
        else:
            self.p.start()

    def _remove_attr_file(self):
        if self._attr_path is not None:
            try:
                os.remove(self._attr_path)
            except OSError:
                pass
            self._attr_path = None

    def _worker_death_error(self):
        sample = self._current_sample
        if sample is None and self._attr_path is not None:
            try:
                with open(self._attr_path) as f:
                    sample = json.load(f)
            except (OSError, ValueError):
                pass
        if sample is not None:
            return DataSampleError(
                f"ImageBatchIter worker died while decoding sample "
                f"{sample.get('path')!r} (epoch {sample.get('epoch')}, "
                f"list index {sample.get('index')})", sample=sample,
                quarantined=self.quarantined)
        return DataSampleError(
            "ImageBatchIter worker died (bad image path or malformed "
            "list line?)", quarantined=self.quarantined)

    def __next__(self):
        assert self.p is not None, "call start() before next()"
        while True:
            try:
                item = self.queue.get(timeout=1.0)
            except Empty:
                if not self.p.is_alive():
                    raise self._worker_death_error() from None
                continue
            if not isinstance(item, dict) or \
                    item.get("gen") != self._gen_id:
                continue                    # a stale worker's
            kind = item.get("kind")
            if kind == "error":
                # the worker named its own failure (skip budget spent,
                # unreadable list): take its books and raise
                self.skip_count = int(item.get("skip_count",
                                               self.skip_count))
                for q in item.get("quarantined", []):
                    self.quarantined.append(dict(q))
                raise DataSampleError(item.get("message", "data worker "
                                                          "failure"),
                                      sample=item.get("sample"),
                                      quarantined=self.quarantined)
            if kind != "batch":
                continue                    # the clean-stop sentinel
            # the state counts this batch once the caller has it
            self._epoch = int(item["epoch"])
            self._position = int(item["position"])
            self.skip_count = int(item["skip_count"])
            if item["skipped"]:
                self.quarantined.extend(item["skipped"])
                _quarantine_counter().inc(len(item["skipped"]))
                first = item["skipped"][0]
                warnings.warn(
                    f"ImageBatchIter: skipped {len(item['skipped'])} "
                    f"corrupt sample(s) (first: {first.get('path')!r}, "
                    f"{first.get('error')}); {self.skip_count}/"
                    f"{self.skip_budget} of the skip budget used",
                    stacklevel=2)
            self.last_batch_ids = np.asarray(item["ids"], np.int64)
            return item["batch"]

    next = __next__

    def __iter__(self):
        if self.p is None:
            self.start()
        return self

    def end(self):
        if self.p is None:
            return
        self.stop = True
        if self.use_process:
            self.p.terminate()
            self.p.join(timeout=5.0)    # reap: no zombie left
        else:
            # drain while joining: a worker blocked in a put frees up,
            # sees the stop flag and exits; the join is what makes sure
            # no worker outlives end()
            deadline = time.monotonic() + 5.0
            while self.p.is_alive() and time.monotonic() < deadline:
                try:
                    self.queue.get_nowait()
                except Empty:
                    pass
                self.p.join(timeout=0.05)
            if self.p.is_alive():
                warnings.warn(
                    "ImageBatchIter worker did not exit within the "
                    "end() grace (a transform hung?); its queue is "
                    "abandoned", stacklevel=2)
        self.p = None
        self._remove_attr_file()

    # -- worker ------------------------------------------------------------
    def _put(self, item):
        """A bounded put that gives up when stopped; False if it did."""
        while not self.stop:
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def run(self, gen=0, start_state=None, attr_path=None):
        epoch, pos, skip_count = start_state or (0, 0, 0)
        try:
            with open(self.img_list_file, "r") as fd:
                samples = [line.strip().split(self.delimiter, 1)
                           for line in fd if line.strip()]
        except OSError as e:
            self._put({"kind": "error", "gen": gen,
                       "skip_count": skip_count, "quarantined": [],
                       "message": f"cannot read image list "
                                  f"{self.img_list_file!r}: {e}"})
            return
        n = len(samples)
        pending_skips = []   # skip records waiting for a batch to ride on
        while not self.stop:
            order = epoch_permutation(self.seed, epoch, n) \
                if self.shuffle else np.arange(n)
            while pos < n and not self.stop:
                images, labels, ids = [], [], []
                skips = pending_skips
                pending_skips = []
                while len(images) < self.batch_size and pos < n:
                    i = int(order[pos])
                    path, label = samples[i]
                    full = os.path.join(self.image_folder, path)
                    self._current_sample = {"epoch": epoch, "index": i,
                                            "path": full}
                    if attr_path is not None:
                        # written before the decode, so that an abrupt
                        # death leaves the sample's name behind; an
                        # unwritable directory falls back to the plain
                        # death message
                        try:
                            with open(attr_path, "w") as f:
                                json.dump(self._current_sample, f)
                        except OSError:
                            attr_path = None
                    pos += 1
                    try:
                        augmented = self.image_transform(full)
                        for img in augmented:
                            images.append(np.asarray(img, np.float32))
                            labels.append(int(float(label)))
                            ids.append(i)
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except DataWorkerKilled:
                        return      # abrupt death: no record, no goodbye
                    except Exception as e:
                        skip_count += 1
                        rec = {"epoch": int(epoch), "index": i,
                               "path": full,
                               "error": f"{type(e).__name__}: {e}"}
                        skips.append(rec)
                        if skip_count > self.skip_budget:
                            self._put({
                                "kind": "error", "gen": gen,
                                "sample": rec, "quarantined": skips,
                                "skip_count": skip_count,
                                "message":
                                    f"data skip budget exhausted: "
                                    f"{skip_count} corrupt sample(s) "
                                    f"with a budget of "
                                    f"{self.skip_budget} (last: "
                                    f"{full!r}, {rec['error']}) — "
                                    "the dataset needs attention, not "
                                    "more skipping"})
                            return
                if not images:
                    # the epoch's whole tail was corrupt: its records
                    # ride on the next real batch (each carries its own
                    # epoch and index)
                    pending_skips = skips
                    break
                batch = (np.stack(images), np.asarray(labels, np.int32))
                if not self._put({"kind": "batch", "gen": gen,
                                  "epoch": int(epoch),
                                  "position": int(pos),
                                  "skipped": skips,
                                  "skip_count": int(skip_count),
                                  "ids": ids, "batch": batch}):
                    break
            if self.stop:
                break
            epoch += 1
            pos = 0
        # the clean-stop sentinel, if there is room (generation tags make
        # a missed one harmless)
        try:
            self.queue.put_nowait({"kind": "end", "gen": gen})
        except Full:
            pass


def backoff_delay(attempt, base, cap, jitter, rng):
    """The retry delay every resilient component shares:
    ``min(cap, base * 2**attempt)`` stretched by up to ``jitter`` drawn
    from the caller's seeded RNG."""
    return min(cap, base * (2.0 ** attempt)) * (1.0 + jitter * rng.random())


class RetryingIterator:
    """Retry a failing data source with exponential backoff and jitter:
    a flaky file system or a dying worker costs a delayed batch, not the
    job.

    ``source`` is an iterable or a zero-argument factory of fresh
    iterators. With a factory a failure rebuilds the source, and a
    rebuilt source that keeps the state protocol is moved to the state of
    the last delivered batch: the stream goes on where the dead one
    stopped, nothing replayed and nothing skipped. ``StopIteration``
    passes through (the end of the data is not a failure) except right
    after a retried error on a source that is not a factory
    (:func:`raise_retried_failure`). A factory-backed iterator can be
    iterated again: ``iter()`` on an exhausted one builds a fresh epoch.

        for batch in RetryingIterator(lambda: ImageBatchIter(...)):
            ...
    """

    def __init__(self, source, max_retries=3, backoff_base=0.1,
                 backoff_cap=5.0, jitter=0.25, seed=0, sleep=None):
        self._source = source
        self._factory = source if callable(source) else None
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.jitter = float(jitter)
        self.attempts = 0           # every fetch attempt, retries included
        self.retries = 0            # failed attempts that were retried
        self.rebuilds = 0           # factory rebuilds after a failure
        self._rng = random.Random(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self._it = None
        self._src_obj = None
        self._last_state = None     # the state as of the last delivered batch
        self._pending_state = None  # an explicit load, applied at (re)build
        self._exhausted = False

    def _iterator(self):
        if self._it is None:
            src = self._factory() if self._factory is not None \
                else self._source
            self._src_obj = src
            state = self._pending_state if self._pending_state is not None \
                else self._last_state
            if state is not None and hasattr(src, "load_state_dict"):
                src.load_state_dict(state)
            self._pending_state = None
            self._it = iter(src)
        return self._it

    def __iter__(self):
        # a factory source starts a fresh iterator per epoch; a plain
        # iterable keeps its exhaustion
        if self._factory is not None and self._exhausted:
            self._it = None
            self._exhausted = False
        return self

    def counters(self) -> dict:
        """``attempts`` (every fetch attempt, retries included),
        ``retries`` (attempts that failed and were retried), ``rebuilds``
        (factory rebuilds)."""
        return {"attempts": self.attempts, "retries": self.retries,
                "rebuilds": self.rebuilds}

    # -- state protocol ----------------------------------------------------
    def state_dict(self):
        """The source's state as of the last delivered batch (a batch
        lost to a failure in flight was never delivered, so a resume
        makes it again); None when the source keeps no state."""
        if self._last_state is not None:
            return dict(self._last_state)
        src = self._src_obj if self._src_obj is not None \
            else (None if self._factory is not None else self._source)
        sd = getattr(src, "state_dict", None)
        return sd() if callable(sd) else None

    def can_load_state(self):
        """A factory source is trusted (the state goes to whatever it
        builds); a plain source answers for itself."""
        if self._factory is not None:
            return True
        return can_load_state(self._source)

    def load_state_dict(self, state):
        self._pending_state = dict(state)
        self._last_state = dict(state)
        self._exhausted = False
        self._it = None        # applied when the source is (re)built

    def __next__(self):
        attempt = 0
        failed = None
        while True:
            try:
                self.attempts += 1
                item = next(self._iterator())
            except StopIteration:
                raise_retried_failure(failed)
                self._exhausted = True
                raise
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if attempt >= self.max_retries:
                    raise
                self._sleep(backoff_delay(attempt, self.backoff_base,
                                          self.backoff_cap, self.jitter,
                                          self._rng))
                self.retries += 1
                _obs_metrics.default_registry().counter(
                    "data_retries_total",
                    "transient data-source failures retried").inc()
                attempt += 1
                if self._factory is not None:
                    self._it = None     # rebuild a (likely dead) source
                    self.rebuilds += 1
                    _obs_metrics.default_registry().counter(
                        "data_rebuilds_total",
                        "factory data sources rebuilt after failure"
                    ).inc()
                else:
                    failed = e
            else:
                sd = getattr(self._src_obj, "state_dict", None)
                if callable(sd):
                    self._last_state = sd()
                return item

    next = __next__


class _Slot:
    """One pinned staging buffer per batch field, and the event recorded
    after the copies out of them."""

    def __init__(self):
        self.buffers = []
        self.event = None


class DevicePrefetcher:
    """Keep the next batches' host-to-device copies in flight while the
    current batch computes.

    Wraps any iterator of numpy-array tuples and yields tuples of Tensors
    on ``device``, ``depth`` batches ahead. On the card each batch is
    written into a pinned host buffer (a ring of ``depth + 2`` slots) and
    copied with ``non_blocking=True`` on a side ``torch.cuda.Stream``,
    followed by a ``torch.cuda.Event``. At hand-out the consumer's current
    stream waits on that event (the host does not) and each tensor is
    recorded on that stream (``record_stream``), so the caching allocator
    does not reuse its memory while the step still reads it. A slot's
    buffers are refilled only after the event of their last copy has
    completed. On the CPU a batch is staged by a plain copy to the
    device.

    State protocol: ``state_dict()`` is the inner iterator's state as of
    the last batch this prefetcher yielded, never of a batch merely
    staged, so a resume replays the staged window instead of dropping it,
    and a consumed batch is never yielded twice.

    ``background=True`` stages on a worker thread (:meth:`_iter_background`).

        for tx, ty in DevicePrefetcher(batches, dev):
            out, loss = model(tx, ty)
    """

    def __init__(self, iterator, device, depth=2, background=False):
        from .tensor import Tensor
        self._Tensor = Tensor
        self.iterator = iterator       # iterated again per epoch
        self.device = device
        self.depth = max(1, int(depth))
        self.background = bool(background)
        self._consumed_state = None
        self._stream = None
        self._slots = [_Slot() for _ in range(self.depth + 2)]
        self._next_slot = 0

    @property
    def copy_stream(self):
        """The side CUDA stream the copies run on; None on the CPU and
        before the first batch is staged."""
        return self._stream

    # -- state protocol ----------------------------------------------------
    def state_dict(self):
        if self._consumed_state is not None:
            return dict(self._consumed_state)
        sd = getattr(self.iterator, "state_dict", None)
        return sd() if callable(sd) else None

    def can_load_state(self):
        """Loadable when the inner iterator is (:func:`can_load_state`)."""
        return can_load_state(self.iterator)

    def load_state_dict(self, state):
        ld = getattr(self.iterator, "load_state_dict", None)
        if ld is None:
            raise TypeError(
                "DevicePrefetcher's inner iterator does not implement "
                "the state protocol (no load_state_dict)")
        ld(state)
        self._consumed_state = dict(state)

    # -- staging -----------------------------------------------------------
    def _stage(self, batch):
        """Start the copies of one batch; :meth:`_hand_out` finishes it."""
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        arrays = [np.asarray(a) for a in batch]
        if not self.device.is_cuda:
            return tuple(self._Tensor(data=a, device=self.device,
                                      requires_grad=False) for a in arrays)
        import torch
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device.torch_device)
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()      # its last copies have finished
        while len(slot.buffers) < len(arrays):
            slot.buffers.append(None)
        out = []
        with torch.cuda.stream(self._stream):
            for i, a in enumerate(arrays):
                dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
                buf = slot.buffers[i]
                if buf is None or tuple(buf.shape) != a.shape or \
                        buf.dtype != dtype:
                    buf = torch.empty(a.shape, dtype=dtype,
                                      pin_memory=True)
                    slot.buffers[i] = buf
                buf.numpy()[...] = a
                out.append(buf.to(self.device.torch_device,
                                  non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return tuple(out), event

    def _hand_out(self, staged):
        """The Tensors of a staged batch, ready for the consumer's
        current stream."""
        if not self.device.is_cuda:
            return staged
        import torch
        tensors, event = staged
        stream = torch.cuda.current_stream(self.device.torch_device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
        return tuple(self._Tensor(data=t, device=self.device,
                                  requires_grad=False) for t in tensors)

    def _source(self):
        src = iter(self.iterator)
        if isinstance(self.iterator, types.GeneratorType):
            # an exhausted generator yields nothing: a second epoch over
            # one is an error (a live iterator such as ImageBatchIter
            # returns itself from __iter__ but keeps producing, so only
            # generators are flagged)
            if getattr(self, "_consumed_oneshot", False):
                raise RuntimeError(
                    "DevicePrefetcher wrapped a generator that is "
                    "already exhausted; pass a re-iterable (e.g. "
                    "NumpyBatchIter) for multi-epoch use")
            self._consumed_oneshot = True
        return src

    def __iter__(self):
        if self.background:
            yield from self._iter_background()
            return
        src = self._source()
        sd = getattr(self.iterator, "state_dict", None)
        pending = deque()   # (staged batch, inner state after it)

        def emit():
            staged, st = pending.popleft()
            if st is not None:
                self._consumed_state = st
            return self._hand_out(staged)

        for batch in src:
            pending.append((self._stage(batch),
                            sd() if callable(sd) else None))
            if len(pending) >= self.depth:
                yield emit()
        while pending:
            yield emit()

    def _iter_background(self):
        """Staging on a worker thread: while step N computes, the worker
        pulls batch N+1 from the source and starts its copies, so the
        consumer waits on neither. The state is snapshotted per staged
        batch on the worker (the only thread that drives the source) and
        becomes ``state_dict()``'s answer when that batch is handed out,
        as in the synchronous path. A source failure is raised at the
        hand-out; leaving the generator (break, GC) stops and joins the
        worker."""
        import queue as _queue
        import threading

        src = self._source()
        sd = getattr(self.iterator, "state_dict", None)
        q = _queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def _put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in src:
                    staged = self._stage(batch)
                    st = sd() if callable(sd) else None
                    if not _put(("item", (staged, st))):
                        return
            except BaseException as e:  # noqa: BLE001 -- raised at get
                _put(("error", e))
                return
            _put(("end", None))

        t = threading.Thread(target=worker, daemon=True,
                             name="singa-prefetch")
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "end":
                    break
                if kind == "error":
                    raise payload
                staged, st = payload
                if st is not None:
                    self._consumed_state = st
                yield self._hand_out(staged)
        finally:
            stop.set()
            try:                # free a worker blocked on a full queue
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            t.join(timeout=5)
