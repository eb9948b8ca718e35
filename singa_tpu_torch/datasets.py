"""CIFAR-10 ingestion and batched host-side transforms.

Counterpart of ``singa_tpu/datasets.py:37-235`` for CIFAR-10: the python
pickle batches (``cifar-10-batches-py/data_batch_N``) and the binary
records (``cifar-10-batches-bin/data_batch_N.bin``) parsed into uint8 NCHW
arrays, :func:`normalize_cifar`, :func:`augment_crop_flip` (the same numpy
draws as the JAX package, so a seed gives the same batch) and
:func:`resize_batch` (bilinear, on a torch device). Nothing is downloaded:
the files are read from ``dir_path`` or from ``data/`` (or the root) of
this checkout, and :class:`DatasetNotFoundError` says where to put them.
CIFAR-100 and MNIST are not ported yet (ROADMAP).
"""

from __future__ import annotations

import os
import pickle

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


def load(name, dir_path=None):
    """Dispatch by dataset name: ``'cifar10'``."""
    if name == "cifar10":
        return load_cifar10(dir_path)
    if name in ("cifar100", "mnist"):
        raise NotImplementedError(
            f"the {name} loader is not ported yet (ROADMAP); use cifar10")
    raise ValueError(f"unknown dataset '{name}' (expected 'cifar10')")
