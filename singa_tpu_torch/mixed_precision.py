"""Precision policy: 16-bit compute against f32 master parameters.

Counterpart of ``singa_tpu/mixed_precision.py`` (the float presets). A
:class:`Policy` names three dtypes: ``param_dtype`` (the masters),
``compute_dtype`` (what conv/matmul/bias operands are cast to) and
``output_dtype`` (what floating outputs are cast back to at the model's
boundary, in training and in serving). BatchNorm statistics, the BN fold of
the fused epilogue and the loss reductions stay f32 under every policy
(``ops/batchnorm.py``, ``ops/fused_epilogue.py``, ``autograd.py``, through
:func:`accum_f32`).

A policy with 16-bit compute trains with dynamic loss scaling by default
(:attr:`Policy.wants_loss_scaling`): ``Model.compile(policy=...,
is_train=True)`` wraps the optimizer in
:class:`~.resilience.GuardedOptimizer`, which starts at
:attr:`Policy.default_loss_scale`. ``loss_scaling=False`` opts out. Its
data-parallel gradients cross the wire in that 16-bit dtype
(:attr:`Policy.comm_dtype`, read by ``opt.DistOpt``).

The quantized presets of the JAX package (``int8_weight_only``,
``fp8_serving``, ``fp8_mixed``, ``int8_qat``) are not part of this slice
of the port; naming one raises (ROADMAP, "left out of slice A'").
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch

__all__ = ["Policy", "resolve", "active_policy", "policy_scope",
           "cast_compute", "compute_dtype", "param_dtype", "accum_f32"]

_NAMED = {
    "float32": ("float32", "float32", "float32"),
    "bf16_mixed": ("float32", "bfloat16", "float32"),
    "float16_mixed": ("float32", "float16", "float32"),
    "bfloat16": ("bfloat16", "bfloat16", "bfloat16"),
}
_QUANT_NAMES = ("int8_weight_only", "fp8_serving", "fp8_mixed", "int8_qat",
                "int8", "fp8")
_LOW_BITS = (torch.bfloat16, torch.float16)
_ALIASES = {"fp32": "float32", "f32": "float32",
            "bf16": "bfloat16", "mixed_bf16": "bf16_mixed",
            "fp16_mixed": "float16_mixed", "f16_mixed": "float16_mixed"}


def _dt(x):
    if x is None or isinstance(x, torch.dtype):
        return x
    return getattr(torch, str(x).replace("torch.", ""))


class Policy:
    """One precision contract (see module doc). ``loss_scaling``
    overrides whether training pairs it with dynamic loss scaling (on for
    a 16-bit compute dtype, off for float32)."""

    def __init__(self, name="bf16_mixed", *, param_dtype=None,
                 compute_dtype=None, output_dtype=None, loss_scaling=None):
        key = _ALIASES.get(str(name).lower(), str(name).lower())
        if key in _QUANT_NAMES:
            raise NotImplementedError(
                f"quantized policy {name!r} is not ported yet (ROADMAP: "
                "quantized policies are left out of the serving slice)")
        if key not in _NAMED:
            raise ValueError(
                f"unknown precision policy {name!r}; expected one of "
                f"{sorted(_NAMED)} (or aliases {sorted(_ALIASES)})")
        self.name = key
        p, c, o = _NAMED[key]
        self.param_dtype = _dt(param_dtype if param_dtype is not None
                               else p)
        self.compute_dtype = _dt(compute_dtype if compute_dtype is not None
                                 else c)
        self.output_dtype = _dt(output_dtype if output_dtype is not None
                                else o)
        self._loss_scaling = loss_scaling

    @property
    def is_mixed(self):
        """True when compute happens below the masters' precision."""
        return self.compute_dtype != self.param_dtype

    @property
    def comm_dtype(self):
        """Wire dtype of the gradient collectives under this policy (None:
        the gradients' own dtype): a 16-bit compute dtype makes the wire
        16-bit too, since the values were computed at that precision."""
        return self.compute_dtype if self.compute_dtype in _LOW_BITS \
            else None

    @property
    def wants_loss_scaling(self):
        if self._loss_scaling is not None:
            return bool(self._loss_scaling)
        return self.compute_dtype in _LOW_BITS

    @property
    def default_loss_scale(self):
        """The dynamic loss scale training starts at: 2^15 for float16
        compute (its narrow exponent underflows small gradients), 1.0 for
        bfloat16 (f32's exponent range)."""
        return 2.0 ** 15 if self.compute_dtype == torch.float16 else 1.0

    def describe(self):
        return {"name": self.name,
                "param_dtype": str(self.param_dtype).replace("torch.", ""),
                "compute_dtype": str(self.compute_dtype).replace("torch.",
                                                                 ""),
                "output_dtype": str(self.output_dtype).replace("torch.",
                                                               "")}

    def __repr__(self):
        d = self.describe()
        return (f"Policy({self.name!r}: params={d['param_dtype']}, "
                f"compute={d['compute_dtype']}, out={d['output_dtype']})")

    def __eq__(self, other):
        # loss scaling is part of the contract: a recompile that only
        # flips the opt-out is a policy change
        return isinstance(other, Policy) and \
            self.describe() == other.describe() and \
            self.wants_loss_scaling == other.wants_loss_scaling

    def __hash__(self):
        return hash(tuple(sorted(self.describe().items()))
                    + (self.wants_loss_scaling,))

    def cast_output(self, x):
        """Boundary cast of one floating output tensor."""
        if self.output_dtype is None or not isinstance(x, torch.Tensor):
            return x
        if x.is_floating_point() and x.dtype != self.output_dtype:
            return x.to(self.output_dtype)
        return x


def resolve(policy):
    """str | dict (a ``describe()`` stamp) | Policy | None -> Policy | None."""
    if policy is None or isinstance(policy, Policy):
        return policy
    kw = {}
    if isinstance(policy, dict):
        doc = policy
        policy = doc.get("name")
        kw = {f: doc[f] for f in ("param_dtype", "compute_dtype",
                                  "output_dtype") if doc.get(f)}
    return Policy(policy, **kw)


_stack: ContextVar[tuple] = ContextVar("singa_tpu_torch_precision_policy",
                                       default=())


def active_policy():
    """Innermost active Policy, or None (none, or an fp32 escape)."""
    s = _stack.get()
    return s[-1] if s else None


@contextlib.contextmanager
def policy_scope(policy):
    """Activate a policy for the ops run within; ``None`` is a no-op."""
    if policy is None:
        yield
        return
    token = _stack.set(_stack.get() + (resolve(policy),))
    try:
        yield
    finally:
        _stack.reset(token)


def compute_dtype():
    p = active_policy()
    return p.compute_dtype if p is not None else None


def cast_compute(*arrays):
    """Cast floating operands to the active compute dtype; ``None`` and
    non-float tensors pass through. One value in, one value out."""
    ct = compute_dtype()
    if ct is None:
        return arrays[0] if len(arrays) == 1 else arrays
    out = tuple(a.to(ct) if isinstance(a, torch.Tensor)
                and a.is_floating_point() and a.dtype != ct else a
                for a in arrays)
    return out[0] if len(out) == 1 else out


def accum_f32(x):
    """``x`` in f32 when it is 16-bit floating point (before a reduction
    that 16 bits would spoil), else ``x`` itself."""
    return x.float() if x.dtype in _LOW_BITS else x


def param_dtype(dtype=None):
    """Dtype a new floating parameter is created in: the active policy's
    master dtype, else the requested one."""
    p = active_policy()
    if p is None or p.param_dtype is None:
        return dtype
    if dtype is not None and not dtype.is_floating_point:
        return dtype
    return p.param_dtype
