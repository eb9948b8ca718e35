"""Dataset ingestion (CIFAR-10, CIFAR-100, MNIST) and batched host-side
transforms.

Counterpart of ``singa_tpu/datasets.py:37-235``: the CIFAR-10 python
pickle batches (``cifar-10-batches-py/data_batch_N``) and binary records
(``cifar-10-batches-bin/data_batch_N.bin``), the CIFAR-100 pickles
(``cifar-100-python/{train,test}``, fine or coarse labels) and the MNIST
IDX files (plain or ``.gz``) parsed into uint8 NCHW arrays and int32
labels, :func:`normalize_cifar`, :func:`augment_crop_flip` (the same numpy
draws as the JAX package, so a seed gives the same batch),
:func:`resize_batch` (bilinear, on a torch device) and :func:`partition`
(a rank's shard for data parallelism). Nothing is downloaded:
the files are read from ``dir_path`` or from ``data/`` (or the root) of
this checkout, and :class:`DatasetNotFoundError` says where to put them.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SEARCH_ROOTS = [os.path.join(_REPO_ROOT, "data"), _REPO_ROOT]

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


class DatasetNotFoundError(FileNotFoundError):
    """Raised with placement instructions when the files are absent."""


def _resolve(dir_path, candidates, what, hint):
    roots = [dir_path] if dir_path else _SEARCH_ROOTS
    for root in roots:
        for cand in candidates:
            p = os.path.join(root, cand)
            if os.path.exists(p):
                return p
    raise DatasetNotFoundError(
        f"{what} not found under {roots}. Place the standard files there "
        f"(e.g. {hint}); this environment performs no downloads.")


def _load_cifar_pickle(path, label_key="labels"):
    with open(path, "rb") as fd:
        blob = pickle.load(fd, encoding="latin1")
    images = blob["data"].astype(np.uint8).reshape(-1, 3, 32, 32)
    labels = np.asarray(blob[label_key], dtype=np.int32)
    return images, labels


def _load_cifar_bin(path):
    """Records of [label][3072 pixel bytes]."""
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    images = raw[:, 1:].reshape(-1, 3, 32, 32)
    return images, labels


def load_cifar10(dir_path=None, num_batches=5):
    """Returns (train_x, train_y, val_x, val_y); images uint8 NCHW, labels
    int32. Reads the pickle batches, else the binary records."""
    try:
        first = _resolve(dir_path,
                         ["cifar-10-batches-py/data_batch_1",
                          "data_batch_1"],
                         "CIFAR-10 (python format)", "data_batch_1")
        loader, suffix = _load_cifar_pickle, ""
    except DatasetNotFoundError:
        first = _resolve(dir_path,
                         ["cifar-10-batches-bin/data_batch_1.bin",
                          "data_batch_1.bin"],
                         "CIFAR-10", "cifar-10-batches-py/data_batch_1")
        loader, suffix = _load_cifar_bin, ".bin"
    base = os.path.dirname(first)
    xs, ys = [], []
    for i in range(1, num_batches + 1):
        x, y = loader(os.path.join(base, f"data_batch_{i}{suffix}"))
        xs.append(x)
        ys.append(y)
    vx, vy = loader(os.path.join(base, f"test_batch{suffix}"))
    return np.concatenate(xs), np.concatenate(ys), vx, vy


def load_cifar100(dir_path=None, label_mode="fine"):
    """Returns (train_x, train_y, val_x, val_y) from the python-format
    ``cifar-100-python/{train,test}`` pickles; ``label_mode`` picks the
    fine (100) or coarse (20) labels."""
    key = "fine_labels" if label_mode == "fine" else "coarse_labels"
    train = _resolve(dir_path, ["cifar-100-python/train", "train"],
                     "CIFAR-100 (python format)", "cifar-100-python/train")
    tx, ty = _load_cifar_pickle(train, key)
    vx, vy = _load_cifar_pickle(
        os.path.join(os.path.dirname(train), "test"), key)
    return tx, ty, vx, vy


def _open_maybe_gz(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


def _read_idx(path, magic, header_ints):
    """The uint8 payload of an IDX file and its header fields after the
    magic; raises on a wrong magic number."""
    with _open_maybe_gz(path) as f:
        data = f.read()
    fields = struct.unpack(f">{header_ints}i", data[:4 * header_ints])
    if fields[0] != magic:
        raise ValueError(f"{path}: bad idx magic {fields[0]:#x}, "
                         f"expected {magic:#x}")
    arr = np.frombuffer(data, np.uint8, offset=4 * header_ints)
    return arr, fields[1:]


def load_mnist(dir_path=None):
    """Returns (train_x, train_y, val_x, val_y); images uint8
    (N, 1, 28, 28). Reads the standard IDX files, gzipped or plain."""
    def find(stem):
        return _resolve(dir_path, [stem + ".gz", stem,
                                   os.path.join("mnist", stem + ".gz"),
                                   os.path.join("mnist", stem)],
                        f"MNIST ({stem})", stem + ".gz")

    out = []
    for stem_x, stem_y in [("train-images-idx3-ubyte",
                            "train-labels-idx1-ubyte"),
                           ("t10k-images-idx3-ubyte",
                            "t10k-labels-idx1-ubyte")]:
        xs, (n, rows, cols) = _read_idx(find(stem_x), 2051, 4)
        ys, (ny,) = _read_idx(find(stem_y), 2049, 2)
        if n != ny:
            raise ValueError(f"MNIST image/label count mismatch {n}/{ny}")
        out += [xs.reshape(n, 1, rows, cols), ys.astype(np.int32)]
    return tuple(out)


def normalize_cifar(*arrays, mean=CIFAR10_MEAN, std=CIFAR10_STD):
    """uint8/float NCHW -> per-channel standardized float32."""
    out = []
    for a in arrays:
        a = np.asarray(a, np.float32) / 255.0
        a = (a - mean[None, :, None, None]) / std[None, :, None, None]
        out.append(a)
    return out[0] if len(out) == 1 else tuple(out)


def augment_crop_flip(x, pad=4, rng=None):
    """Random shift-crop + horizontal flip over the whole batch at once.
    x: float32 NCHW; returns a new array."""
    rng = rng or np.random
    n, c, h, w = x.shape
    xpad = np.pad(x, [(0, 0), (0, 0), (pad, pad), (pad, pad)], "symmetric")
    dy = rng.randint(0, 2 * pad + 1, n)
    dx = rng.randint(0, 2 * pad + 1, n)
    rows = dy[:, None] + np.arange(h)[None, :]           # (n, h)
    cols = dx[:, None] + np.arange(w)[None, :]           # (n, w)
    out = xpad[np.arange(n)[:, None, None, None],
               np.arange(c)[None, :, None, None],
               rows[:, None, :, None],
               cols[:, None, None, :]]
    flip = rng.randint(0, 2, n).astype(bool)
    out[flip] = out[flip, :, :, ::-1]
    return out


def resize_batch(x, image_size, as_numpy=False, device="cpu"):
    """Bilinear resize of an NCHW batch to ``image_size`` square, in one
    op on ``device`` (a ``torch.device``, its name, or a port
    :class:`~.device.Device`); antialiased when it shrinks, as
    ``jax.image.resize`` is. Returns a float32 torch tensor on ``device``,
    or a numpy array with ``as_numpy``."""
    import torch
    import torch.nn.functional as F
    if x.shape[2] == image_size and x.shape[3] == image_size:
        return np.asarray(x, np.float32) if as_numpy else \
            torch.as_tensor(np.asarray(x, np.float32),
                            device=getattr(device, "torch_device", device))
    t = torch.as_tensor(np.asarray(x, np.float32),
                        device=getattr(device, "torch_device", device))
    out = F.interpolate(t, size=(image_size, image_size), mode="bilinear",
                        align_corners=False,
                        antialias=image_size < max(x.shape[2], x.shape[3]))
    return out.cpu().numpy() if as_numpy else out


def partition(global_rank, world_size, *arrays):
    """Contiguous equal shards of each array for data parallelism
    (reference ``train_cnn.py:58-72``)."""
    out = []
    for a in arrays:
        per = a.shape[0] // world_size
        out.append(a[global_rank * per:(global_rank + 1) * per])
    return tuple(out)


def load(name, dir_path=None):
    """Dispatch by dataset name: ``'cifar10'``, ``'cifar100'`` or
    ``'mnist'``."""
    table = {"cifar10": load_cifar10, "cifar100": load_cifar100,
             "mnist": load_mnist}
    if name not in table:
        raise ValueError(f"unknown dataset '{name}' "
                         f"(expected one of {sorted(table)})")
    return table[name](dir_path)
