"""Parameter initializers.

Counterpart of ``singa_tpu/initializer.py``: the fourteen fillers, with
the JAX package's fan rules (``:16-30``: a matrix's fans are its two
dimensions, a conv kernel's are its channels times its receptive field)
and its scales. Each refills a :class:`~.tensor.Tensor` in place from an
explicit ``torch.Generator``: the one passed as ``generator``, else the
tensor's device generator (seeded with ``Device.SetRandSeed``). The JAX
package draws from ``jax.random``, so the two packages give different
numbers for one seed; tests hold the fillers by their moments and by one
seed giving one draw, and tests that compare the packages make weights
with numpy and carry them across.
"""

from __future__ import annotations

import numpy as np
import torch

from .tensor import Tensor


def _compute_fans(shape):
    """(fan_in, fan_out) of a weight of ``shape``."""
    shape = tuple(shape)
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) in (3, 4, 5):
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = int(np.sqrt(np.prod(shape)))
    return float(fan_in), float(fan_out)


def _random_fill(t: Tensor, mode, scale, distribution, generator):
    fan_in, fan_out = _compute_fans(t.shape)
    n = {"fan_in": fan_in, "fan_out": fan_out,
         "fan_avg": (fan_in + fan_out) / 2.0}[mode]
    s = scale / max(1.0, n)
    if distribution == "normal":
        return t.gaussian(0.0, float(np.sqrt(s)), generator=generator)
    limit = float(np.sqrt(3.0 * s))
    return t.uniform(-limit, limit, generator=generator)


def eye(t: Tensor):
    """The identity matrix (ones on the main diagonal)."""
    if len(t.shape) != 2:
        raise ValueError(f"eye initializer needs a matrix, got {t.shape}")
    t.copy_data(torch.eye(*t.shape, device=t.device.torch_device))
    return t


def orthogonal(t: Tensor, generator=None):
    """A random orthogonal matrix: Q of the QR of an N(0, 1) draw, its
    columns' signs fixed by R's diagonal."""
    if len(t.shape) != 2:
        raise ValueError(f"orthogonal initializer needs a matrix, got "
                         f"{t.shape}")
    g = generator if generator is not None else t.device.generator
    a = torch.randn(t.shape, generator=g, dtype=torch.float32,
                    device=t.device.torch_device)
    rows, cols = t.shape
    q, r = torch.linalg.qr(a if rows >= cols else a.T)
    q = q * torch.sign(torch.diagonal(r))
    t.copy_data(q if rows >= cols else q.T)
    return t


def lecun_uniform(t: Tensor, generator=None):
    return _random_fill(t, "fan_in", 1.0, "uniform", generator)


def lecun_normal(t: Tensor, generator=None):
    return _random_fill(t, "fan_in", 1.0, "normal", generator)


def glorot_uniform(t: Tensor, generator=None):
    return _random_fill(t, "fan_avg", 1.0, "uniform", generator)


def glorot_normal(t: Tensor, generator=None):
    return _random_fill(t, "fan_avg", 1.0, "normal", generator)


def he_uniform(t: Tensor, generator=None):
    return _random_fill(t, "fan_in", 2.0, "uniform", generator)


def he_normal(t: Tensor, generator=None):
    return _random_fill(t, "fan_in", 2.0, "normal", generator)


# ---- the reference's older fillers (initializer.py:gaussian/xavier/...) ----

def _fans_avg(fan_in, fan_out):
    if fan_in * fan_out == 0:
        return max(fan_in, fan_out), 2
    return fan_in + fan_out, 1


def uniform(t: Tensor, fan_in=0, fan_out=0, generator=None):
    """U(-limit, limit), ``limit = sqrt(3 avg / (fan_in + fan_out))``
    (one fan given: ``avg`` 2 over that fan)."""
    x, avg = _fans_avg(fan_in, fan_out)
    limit = float(np.sqrt(3.0 * avg / max(1, x)))
    return t.uniform(-limit, limit, generator=generator)


def gaussian(t: Tensor, fan_in=0, fan_out=0, generator=None):
    """N(0, sqrt(avg / (fan_in + fan_out))), as :func:`uniform`."""
    x, avg = _fans_avg(fan_in, fan_out)
    std = float(np.sqrt(avg / max(1, x)))
    return t.gaussian(0.0, std, generator=generator)


def xavier(t: Tensor, generator=None):
    return glorot_uniform(t, generator)


def glorot(t: Tensor, generator=None):
    return glorot_normal(t, generator)


def msra(t: Tensor, generator=None):
    return he_normal(t, generator)
