"""The port's CIFAR-100 and MNIST loaders (``singa_tpu_torch/datasets.py``)
against the JAX package's (``singa_tpu/datasets.py:107-175, 228``).

The files are written by the test into ``tmp_path`` in the standard wire
formats: the ``cifar-100-python/{train,test}`` pickles (fine and coarse
labels) and the four MNIST IDX files, plain and gzipped. Both packages
read them; the arrays must be equal bitwise, with the same dtypes and
shapes. A file with a wrong magic number raises the same ``ValueError``
in both, and a missing dataset the same ``DatasetNotFoundError`` message.
"""

import gzip
import pickle
import struct

import numpy as np
import pytest

from singa_tpu import datasets as jds

from singa_tpu_torch import datasets as tds


def _write_cifar100(root, n_train=6, n_test=3, seed=0):
    d = root / "cifar-100-python"
    d.mkdir()
    rng = np.random.RandomState(seed)
    for name, n in (("train", n_train), ("test", n_test)):
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072))
                         .astype(np.uint8),
                         "fine_labels": rng.randint(0, 100, n).tolist(),
                         "coarse_labels": rng.randint(0, 20, n).tolist()},
                        f)


def _idx(magic, dims, payload):
    return struct.pack(f">{1 + len(dims)}i", magic, *dims) + \
        payload.tobytes()


def _write_mnist(root, gz, n_train=5, n_test=4, seed=1, sub=""):
    d = root / sub if sub else root
    d.mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    files = {}
    for split, n in (("train", n_train), ("t10k", n_test)):
        files[f"{split}-images-idx3-ubyte"] = _idx(
            2051, (n, 28, 28), rng.randint(0, 256, (n, 28, 28))
            .astype(np.uint8))
        files[f"{split}-labels-idx1-ubyte"] = _idx(
            2049, (n,), rng.randint(0, 10, n).astype(np.uint8))
    for name, blob in files.items():
        if gz:
            with gzip.open(d / (name + ".gz"), "wb") as f:
                f.write(blob)
        else:
            (d / name).write_bytes(blob)
    return files


def _same(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("label_mode", ["fine", "coarse"])
def test_cifar100_reads_as_jax(tmp_path, label_mode):
    _write_cifar100(tmp_path)
    got = tds.load_cifar100(str(tmp_path), label_mode)
    want = jds.load_cifar100(str(tmp_path), label_mode)
    _same(got, want)
    assert got[0].shape == (6, 3, 32, 32) and got[0].dtype == np.uint8
    assert got[1].dtype == np.int32
    assert got[1].max() < (100 if label_mode == "fine" else 20)


def test_load_dispatch_reads_cifar100_as_jax(tmp_path):
    _write_cifar100(tmp_path)
    _same(tds.load("cifar100", str(tmp_path)),
          jds.load("cifar100", str(tmp_path)))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("sub", ["", "mnist"], ids=["root", "subdir"])
def test_mnist_reads_as_jax(tmp_path, gz, sub):
    _write_mnist(tmp_path, gz, sub=sub)
    got = tds.load("mnist", str(tmp_path))
    want = jds.load("mnist", str(tmp_path))
    _same(got, want)
    assert got[0].shape == (5, 1, 28, 28) and got[2].shape == (4, 1, 28,
                                                               28)
    assert got[1].dtype == np.int32 and got[1].shape == (5,)


@pytest.mark.parametrize("bad", ["images", "labels"])
def test_mnist_bad_magic_raises_as_jax(tmp_path, bad):
    files = _write_mnist(tmp_path, gz=False)
    name = f"train-{bad}-idx{3 if bad == 'images' else 1}-ubyte"
    blob = bytearray(files[name])
    blob[3] ^= 0x01                         # 2051 -> 2050, 2049 -> 2048
    (tmp_path / name).write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="bad idx magic") as mine:
        tds.load_mnist(str(tmp_path))
    with pytest.raises(ValueError, match="bad idx magic") as ref:
        jds.load_mnist(str(tmp_path))
    assert str(mine.value) == str(ref.value)


def test_mnist_count_mismatch_raises_as_jax(tmp_path):
    _write_mnist(tmp_path, gz=True)
    blob = _idx(2049, (3,), np.zeros(3, np.uint8))
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError, match="count mismatch") as mine:
        tds.load_mnist(str(tmp_path))
    with pytest.raises(ValueError, match="count mismatch") as ref:
        jds.load_mnist(str(tmp_path))
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("name", ["cifar100", "mnist"])
def test_missing_files_name_where_to_put_them(tmp_path, name):
    with pytest.raises(tds.DatasetNotFoundError) as mine:
        tds.load(name, str(tmp_path))
    with pytest.raises(jds.DatasetNotFoundError) as ref:
        jds.load(name, str(tmp_path))
    assert str(mine.value) == str(ref.value)
    assert "performs no downloads" in str(mine.value)


def test_unknown_dataset_raises_as_jax():
    with pytest.raises(ValueError) as mine:
        tds.load("imagenet")
    with pytest.raises(ValueError) as ref:
        jds.load("imagenet")
    assert str(mine.value) == str(ref.value)
