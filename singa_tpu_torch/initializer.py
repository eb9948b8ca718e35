"""Parameter initializers: the filler ``layer.Conv2d`` and ``layer.Linear``
use.

Counterpart of ``singa_tpu/initializer.py`` (its ``gaussian``). The filler
refills a :class:`~.tensor.Tensor` in place from an explicit
``torch.Generator``: the one passed in, else the tensor's device generator
(seeded with ``Device.SetRandSeed``). The JAX package draws from
``jax.random``, so the two packages give different numbers for one seed;
tests that compare them make weights with numpy and carry them across.
The other fillers come with the layers that use them.
"""

from __future__ import annotations

from .tensor import Tensor


def gaussian(t: Tensor, mean=0.0, std=1.0, generator=None):
    """Refill ``t`` from N(mean, std)."""
    return t.gaussian(mean, std, generator=generator)
