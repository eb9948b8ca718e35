"""Training resilience: :class:`GuardedOptimizer` (skip-bad-step guard
with dynamic loss scaling), the counterpart of ``singa_tpu/resilience/
guards.py``. The rest of the JAX package's ``resilience`` (the resilient
trainer, fault plans, cluster health) is not ported yet (ROADMAP, slice
E)."""

from .guards import GuardedOptimizer  # noqa: F401
