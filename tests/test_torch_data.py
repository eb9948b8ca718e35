"""The port's data path (``singa_tpu_torch/data.py``, ``datasets.py``,
``metric.py``) against the JAX package's on the same inputs.

Sample orders and loaded arrays must be equal; the numpy transforms
(``normalize_cifar``, ``augment_crop_flip``) must be equal for one seed;
``resize_batch`` (bilinear, torch against ``jax.image.resize``) within
1e-5 on values of order 1. The CIFAR-10 files are written by the test into
``tmp_path`` in the two wire formats the loaders read (the real files are
not in the repository).
"""

import pickle

import numpy as np
import pytest

from singa_tpu import data as jdata
from singa_tpu import datasets as jds
from singa_tpu import metric as jmetric

from singa_tpu_torch import data as tdata
from singa_tpu_torch import datasets as tds
from singa_tpu_torch import metric as tmetric


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 1000), (123456789, 37),
                                    (2 ** 33 + 5, 64)])
def test_epoch_permutation_equals_jax(seed, n):
    for epoch in range(3):
        np.testing.assert_array_equal(
            tdata.epoch_permutation(seed, epoch, n),
            jdata.epoch_permutation(seed, epoch, n))


def _epochs(it, n_epochs):
    out = []
    for _ in range(n_epochs):
        for batch in it:
            out.append(tuple(np.asarray(b) for b in batch))
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=False),
    dict(batch_size=3, drop_last=False),
    dict(batch_size=3, pad_last=True),
    dict(batch_size=2, world=2, rank=1, seed=9),
    dict(batch_size=2, world=3, rank=2, pad_last=True, seed=4),
], ids=str)
def test_numpy_batch_iter_equals_jax(kw):
    x = np.arange(23 * 2, dtype=np.float32).reshape(23, 2)
    y = np.arange(23, dtype=np.int32)
    mine = tdata.NumpyBatchIter(x, y, **kw)
    ref = jdata.NumpyBatchIter(x, y, **kw)
    got, want = _epochs(mine, 2), _epochs(ref, 2)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert mine.state_dict() == ref.state_dict()
    np.testing.assert_array_equal(mine.last_batch_ids, ref.last_batch_ids)


def test_numpy_batch_iter_resumes_the_same_stream():
    x = np.arange(40, dtype=np.float32)[:, None]
    y = np.arange(40, dtype=np.int32)
    full = [b[1] for b in _epochs(tdata.NumpyBatchIter(x, y, 5, seed=3), 2)]
    it = tdata.NumpyBatchIter(x, y, 5, seed=3)
    head = []
    for i, (_, by) in enumerate(it):
        head.append(by)
        if i == 2:
            break
    state = it.state_dict()
    resumed = tdata.NumpyBatchIter(x, y, 5, seed=3)
    resumed.load_state_dict(state)
    tail = [b[1] for b in _epochs(resumed, 2)]
    for a, b in zip(head + tail, full):
        np.testing.assert_array_equal(a, b)


def _cifar_records(seed, n=7):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 3072)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.int64))


@pytest.mark.parametrize("fmt", ["pickle", "binary"])
def test_cifar10_files_load_the_same(tmp_path, fmt):
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    if fmt == "pickle":
        d = tmp_path / "cifar-10-batches-py"
        d.mkdir()
        for i, name in enumerate(names):
            data, labels = _cifar_records(i)
            with open(d / name, "wb") as f:
                pickle.dump({"data": data, "labels": labels.tolist(),
                             "batch_label": name}, f)
    else:
        d = tmp_path / "cifar-10-batches-bin"
        d.mkdir()
        for i, name in enumerate(names):
            data, labels = _cifar_records(i)
            recs = np.concatenate([labels[:, None].astype(np.uint8), data],
                                  axis=1)
            recs.tofile(d / f"{name}.bin")
    got = tds.load("cifar10", str(tmp_path))
    want = jds.load("cifar10", str(tmp_path))
    assert got[0].shape == (35, 3, 32, 32) and got[2].shape == (7, 3, 32, 32)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][:7], _cifar_records(0)[1])


def test_missing_cifar10_names_where_to_put_it(tmp_path):
    with pytest.raises(tds.DatasetNotFoundError) as mine:
        tds.load("cifar10", str(tmp_path))
    with pytest.raises(jds.DatasetNotFoundError) as ref:
        jds.load("cifar10", str(tmp_path))
    assert str(mine.value) == str(ref.value)
    assert "performs no downloads" in str(mine.value)
    # MNIST is ported now: its missing files are named as the JAX
    # package names them
    with pytest.raises(tds.DatasetNotFoundError) as mine:
        tds.load("mnist", str(tmp_path))
    with pytest.raises(jds.DatasetNotFoundError) as ref:
        jds.load("mnist", str(tmp_path))
    assert str(mine.value) == str(ref.value)


def test_normalize_and_augment_match_for_a_seed():
    x = np.random.RandomState(0).randint(0, 256, (6, 3, 32, 32)) \
        .astype(np.uint8)
    a, b = tds.normalize_cifar(x, x[:2])
    ja, jb = jds.normalize_cifar(x, x[:2])
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    got = tds.augment_crop_flip(a, rng=np.random.RandomState(5))
    want = jds.augment_crop_flip(ja, rng=np.random.RandomState(5))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, a)


@pytest.mark.parametrize("size", [224, 16])
def test_resize_batch_matches_jax(size):
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    got = tds.resize_batch(x, size, as_numpy=True)
    want = np.asarray(jds.resize_batch(x, size, as_numpy=True))
    assert got.shape == want.shape == (2, 3, size, size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("top_k", [1, 3])
def test_accuracy_matches_jax(top_k):
    rng = np.random.RandomState(2)
    pred = rng.randn(16, 10).astype(np.float32)
    ids = rng.randint(0, 10, 16)
    for target in (ids, np.eye(10, dtype=np.float32)[ids]):
        got = tmetric.Accuracy(top_k).evaluate(pred, target)
        want = jmetric.Accuracy(top_k).evaluate(pred, target)
        assert got == want
    assert tmetric.accuracy(pred, ids) == jmetric.accuracy(pred, ids)
