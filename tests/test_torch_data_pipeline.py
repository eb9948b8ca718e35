"""The port's data pipeline against the JAX package's, on the host.

``singa_tpu_torch.data`` (``ImageBatchIter``, ``RetryingIterator``,
``DevicePrefetcher``, ``backoff_delay``, ``can_load_state``) and
``singa_tpu_torch.image_tool`` hold the JAX package's behaviour bit for
bit: the same list file, transform and seed give the same images, labels,
``ids``, ``state_dict()`` after every batch, quarantine records and
errors. The dataset is the fixture of ``tests/test_data_resume.py:28-48``
(``.npy`` "images" whose value is the sample's index). Nothing here waits
on the wall clock: a worker's death is seen by the iterator's own poll.
"""

import random
import warnings

import numpy as np
import pytest
from PIL import Image

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

from singa_tpu import data as jdata
from singa_tpu import device as jdevice
from singa_tpu import image_tool as jtool

from singa_tpu_torch import data as tdata
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import image_tool as ttool

PKGS = {"jax": jdata, "port": tdata}


def npy_dataset(root, n=12):
    """``n`` .npy samples of 2x2 holding their index, and a list file
    with labels ``i % 3``."""
    root.mkdir(exist_ok=True)
    for i in range(n):
        np.save(root / f"s{i}.npy", np.full((2, 2), i, np.float32))
    lst = root / "list.txt"
    lst.write_text("".join(f"s{i}.npy {i % 3}\n" for i in range(n)))
    return str(lst), str(root)


def npy_transform(path):
    return [np.load(path)]


@pytest.fixture
def dataset(tmp_path):
    return npy_dataset(tmp_path / "samples")


def make(pkg, dataset, batch_size=4, transform=npy_transform, **kw):
    lst, root = dataset
    return PKGS[pkg].ImageBatchIter(lst, batch_size, transform,
                                    image_folder=root, **kw)


def stream(it, n):
    """``n`` batches of a started iterator: (images, labels, ids, state)
    after each."""
    out = []
    for _ in range(n):
        x, y = next(it)
        out.append((x, y, it.last_batch_ids, it.state_dict()))
    return out


def same_stream(a, b):
    assert len(a) == len(b)
    for (xa, ya, ia, sa), (xb, yb, ib, sb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(ia, ib)
        assert sa == sb


def run(pkg, dataset, n, **kw):
    it = make(pkg, dataset, **kw)
    it.start()
    try:
        return stream(it, n)
    finally:
        it.end()


def test_two_shuffled_epochs_bitwise(dataset):
    want = run("jax", dataset, 6, seed=3)
    got = run("port", dataset, 6, seed=3)
    same_stream(got, want)
    assert [s["epoch"] for *_, s in got] == [0, 0, 0, 1, 1, 1]
    # an epoch is a permutation, and the two epochs differ
    ids = [np.concatenate([b[2] for b in got[e:e + 3]]) for e in (0, 3)]
    assert sorted(ids[0]) == list(range(12))
    assert not np.array_equal(ids[0], ids[1])


def test_process_mode_matches_thread_mode(dataset):
    want = run("port", dataset, 4, seed=5)
    got = run("port", dataset, 4, seed=5, use_process=True)
    same_stream(got, want)


def test_mid_epoch_resume_bitwise(dataset):
    """Two batches consumed (more may sit in the queue), the state taken,
    the worker ended; a fresh iterator loaded from that state goes on
    with the third batch, in both packages."""
    out = {}
    for pkg in PKGS:
        it = make(pkg, dataset, seed=4, capacity=8)
        it.start()
        first = stream(it, 2)
        state = it.state_dict()
        it.end()
        res = make(pkg, dataset, seed=4)
        res.load_state_dict(state)
        res.start()
        out[pkg] = (first + stream(res, 2), state)
        res.end()
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["position"] == 8
    same_stream(out["port"][0], out["jax"][0])
    same_stream(out["port"][0], run("port", dataset, 4, seed=4))


def corrupt(dataset, i):
    """Overwrite sample ``i`` with bytes that are not a .npy file."""
    with open(f"{dataset[1]}/s{i}.npy", "wb") as f:
        f.write(b"not an array")


def test_quarantine_records_under_a_skip_budget(dataset):
    corrupt(dataset, 2)
    corrupt(dataset, 7)
    out = {}
    for pkg in PKGS:
        it = make(pkg, dataset, shuffle=False, skip_budget=3)
        it.start()
        with pytest.warns(UserWarning, match="skipped 1 corrupt"):
            got = stream(it, 3)
        it.end()
        out[pkg] = (got, it.quarantined, it.skip_count)
    same_stream(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert [q["index"] for q in out["port"][1]] == [2, 7]
    assert out["port"][2] == out["jax"][2] == 2
    assert sum(len(b[1]) for b in out["port"][0]) == 10


def test_exhausted_skip_budget_names_the_sample(dataset):
    corrupt(dataset, 1)
    corrupt(dataset, 3)
    errors = {}
    for pkg in PKGS:
        it = make(pkg, dataset, shuffle=False, skip_budget=1)
        it.start()
        with pytest.raises(PKGS[pkg].DataSampleError,
                           match="skip budget exhausted") as e:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for _ in range(4):
                    next(it)
        it.end()
        errors[pkg] = e.value
    assert str(errors["port"]) == str(errors["jax"])
    assert errors["port"].sample == errors["jax"].sample
    assert errors["port"].quarantined == errors["jax"].quarantined
    assert "s3.npy" in errors["port"].sample["path"]


@pytest.mark.parametrize("use_process", [False, True],
                         ids=["thread", "process"])
def test_worker_death_names_the_sample(dataset, use_process):
    """A transform that kills the worker at sample 3: the iterator names
    that sample (thread mode from memory, process mode from the file the
    worker wrote before the decode), as the JAX package's does."""
    messages = {}
    for pkg, mod in PKGS.items():
        def killer(path, mod=mod):
            if path.endswith("s3.npy"):
                raise mod.DataWorkerKilled()
            return [np.load(path)]
        it = make(pkg, dataset, batch_size=2, transform=killer,
                  shuffle=False, use_process=use_process)
        it.start()
        with pytest.raises(mod.DataSampleError,
                           match="died while decoding") as e:
            for _ in range(3):
                next(it)
        it.end()
        assert it._attr_path is None and it.p is None
        messages[pkg] = (str(e.value), e.value.sample)
    assert messages["port"] == messages["jax"]
    assert "s3.npy" in messages["port"][0]


def test_faults_and_missing_list_raise(dataset, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make("port", dataset, faults=object())
    lst, root = dataset
    it = tdata.ImageBatchIter(lst, 4, npy_transform, image_folder=root)
    it.img_list_file = str(tmp_path / "missing.txt")
    it.start()
    with pytest.raises(tdata.DataSampleError, match="cannot read"):
        next(it)
    it.end()


class FlakySource:
    """A NumpyBatchIter-like source of 16 rows in batches of 4 whose
    fetches listed in ``fail_at`` raise once each."""

    def __init__(self, mod, fail_at=(1, 2)):
        x = np.arange(32, dtype=np.float32).reshape(16, 2)
        self.inner = mod.NumpyBatchIter(x, np.arange(16), 4, seed=2)
        self.fail_at = set(fail_at)
        self.fetches = 0
        self._it = None

    def __iter__(self):
        self._it = iter(self.inner)
        return self

    def __next__(self):
        self.fetches += 1
        if self.fetches in self.fail_at:
            self.fail_at.discard(self.fetches)
            raise OSError(f"flaky read {self.fetches}")
        return next(self._it)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)


def test_retrying_iterator_counters_delays_and_state():
    out = {}
    for pkg, mod in PKGS.items():
        delays = []
        built = []

        def factory(mod=mod, built=built):
            fail_at = [(1,), (2,)][len(built)] if len(built) < 2 else ()
            built.append(FlakySource(mod, fail_at=fail_at))
            return built[-1]
        ri = mod.RetryingIterator(factory, backoff_base=0.5, seed=7,
                                  sleep=delays.append)
        batches, states = [], []
        for b in ri:
            batches.append(b)
            states.append(ri.state_dict())
        again = mod.RetryingIterator(FlakySource(mod, fail_at=()),
                                     sleep=delays.append)
        again.load_state_dict(states[1])
        out[pkg] = (batches, states, ri.counters(), delays,
                    ri.can_load_state(), next(iter(again)))
    (bp, sp, cp, dp, lp, ap), (bj, sj, cj, dj, lj, aj) = \
        out["port"], out["jax"]
    assert sp == sj and cp == cj and dp == dj and lp == lj
    assert cp == {"attempts": 7, "retries": 2, "rebuilds": 2}
    for a, b in zip(bp + [ap], bj + [aj]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(ap[0], bp[2][0])


def test_retrying_iterator_raises_the_retried_failure():
    """A plain generator that raised is closed: its retry ends the
    stream, and the original failure is raised, not a short epoch."""
    for mod in PKGS.values():
        def gen():
            yield 1
            raise ValueError("decode exploded")
        ri = mod.RetryingIterator(gen(), sleep=lambda s: None)
        assert next(ri) == 1
        with pytest.raises(ValueError, match="decode exploded"):
            next(ri)
        assert ri.counters() == {"attempts": 3, "retries": 1,
                                 "rebuilds": 0}


def test_backoff_delay_and_can_load_state():
    for attempt in range(6):
        for base, cap, jitter in ((0.1, 5.0, 0.25), (1.0, 3.0, 0.0)):
            ra, rb = random.Random(attempt), random.Random(attempt)
            assert tdata.backoff_delay(attempt, base, cap, jitter, ra) == \
                jdata.backoff_delay(attempt, base, cap, jitter, rb)
    x = np.zeros((8, 2), np.float32)
    y = np.zeros(8, np.float32)
    for mod, dev in ((jdata, jdevice.create_cpu_device()),
                     (tdata, tdevice.create_cpu_device())):
        src = mod.NumpyBatchIter(x, y, 4)
        gen = (b for b in [])
        got = [mod.can_load_state(o) for o in (
            src, mod.DevicePrefetcher(src, dev),
            mod.RetryingIterator(lambda: src), gen,
            mod.DevicePrefetcher(gen, dev), mod.RetryingIterator(gen))]
        assert got == [True, True, True, False, False, False]
    with pytest.raises(ValueError, match="boom"):
        tdata.raise_retried_failure(ValueError("boom"))
    tdata.raise_retried_failure(None)


PREFETCH = {"jax": (jdata, jdevice), "port": (tdata, tdevice)}


def prefetched(pkg, background, depth=3, state=None, take=None):
    """Batches (as numpy) and the state after each, from a
    DevicePrefetcher over a 16-row NumpyBatchIter on the CPU."""
    mod, device = PREFETCH[pkg]
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    y = np.arange(16, dtype=np.float32)
    pf = mod.DevicePrefetcher(mod.NumpyBatchIter(x, y, 4, shuffle=False),
                              device.create_cpu_device(), depth=depth,
                              background=background)
    if state is not None:
        pf.load_state_dict(state)
    g = iter(pf)
    out, inner = [], []
    for b in g:
        out.append([t.numpy() for t in b])
        inner.append(pf.iterator.state_dict()["position"])
        out[-1].append(pf.state_dict())
        if take is not None and len(out) == take:
            g.close()
            break
    return out, inner


@pytest.mark.parametrize("background", [False, True],
                         ids=["sync", "background"])
def test_device_prefetcher_on_the_cpu(background):
    """The yielded batches, and the state as of the last batch yielded
    (the inner iterator runs ahead), as the JAX package's; a resume from
    that state replays the staged window: no gap, no repeat."""
    got, inner = prefetched("port", background)
    want, _ = prefetched("jax", background)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    assert [b[2]["position"] for b in got] == [4, 8, 12, 16]
    if not background:
        assert inner[0] == 12           # three batches staged ahead
    head, _ = prefetched("port", background, take=2)
    rest, _ = prefetched("port", background, state=head[-1][2])
    np.testing.assert_array_equal(
        np.concatenate([b[0] for b in head + rest]),
        np.arange(64, dtype=np.float32).reshape(16, 4))
    t = next(iter(tdata.DevicePrefetcher(
        [(np.ones(3, np.float32),)], tdevice.create_cpu_device())))[0]
    assert t.device.torch_device.type == "cpu"


def test_device_prefetcher_refuses_an_exhausted_generator():
    dev = tdevice.create_cpu_device()
    for background in (False, True):
        pf = tdata.DevicePrefetcher(
            (b for b in [(np.ones(2, np.float32),)]), dev,
            background=background)
        assert len(list(pf)) == 1
        with pytest.raises(RuntimeError, match="already exhausted"):
            list(pf)


def seeded_image(seed, w=48, h=36):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


CHAINS = {
    "crop_flip": lambda t: t.random_crop((24, 24)).flip(),
    "resize_crop5": lambda t: t.resize_by_range((30, 40)).crop5(
        (16, 16), num_case=3),
    "crop8": lambda t: t.crop8((20, 20), num_case=4),
    "crop3": lambda t: t.resize_by_hw_range(((30, 40), (50, 60))).crop3(
        (18, 18), num_case=2),
    "photometric": lambda t: t.color_cast(offset=15).enhance(0.3)
    .flip_down(),
    "rotate_resize": lambda t: t.rotate_by_range((-20, 20))
    .random_crop_resize((16, 16)).resize_by_list([12, 20], num_case=2),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_image_tool_chain_with_seeded_random(chain):
    """The same seeded ``random`` gives the same augmented pixels."""
    out = {}
    for name, mod in (("jax", jtool), ("port", ttool)):
        random.seed(11)
        tool = mod.ImageTool().set([seeded_image(1), seeded_image(2, 40,
                                                                  52)])
        out[name] = [np.asarray(im) for im in CHAINS[chain](tool).get()]
    assert len(out["port"]) == len(out["jax"]) > 0
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


def test_image_tool_functions(tmp_path):
    img = seeded_image(3)
    path = tmp_path / "im.png"
    img.save(path)
    for mod in (jtool, ttool):
        assert mod.load_img(str(path)).mode == "RGB"
        assert mod.load_img(str(path), grayscale=True).mode == "L"
    cases = [
        lambda m: m.crop(img, (8, 8), "right_top"),
        lambda m: m.crop_and_resize(img, (8, 6), "middle"),
        lambda m: m.crop_and_resize(img, (6, 8), "right"),
        lambda m: m.resize(img, 10), lambda m: m.scale(img, 20),
        lambda m: m.resize_by_hw(img, (6, 8)),
        lambda m: m.flip(img), lambda m: m.flip_down(img),
        lambda m: m.color_cast(img, 30), lambda m: m.enhance(img, 0.4),
    ]
    for case in cases:
        random.seed(5)
        a = np.asarray(case(ttool))
        random.seed(5)
        np.testing.assert_array_equal(a, np.asarray(case(jtool)))
    random.seed(2)
    a = ttool.get_list_sample(range(10), 4)
    random.seed(2)
    assert a == jtool.get_list_sample(range(10), 4)
    with pytest.raises(ValueError, match="larger than image"):
        ttool.crop(img, (100, 8), "center")
