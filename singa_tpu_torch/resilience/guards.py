"""Skip-bad-step guard with dynamic loss scaling.

Counterpart of ``singa_tpu/resilience/guards.py:59-390``
(:class:`GuardedOptimizer`), with the same state names and the same
arithmetic. It wraps a plain optimizer and replaces its training step
(``optimizer(loss)`` / ``backward_and_update``) with a guarded one that
runs on the card and reads nothing back to the host:

- the backward is seeded with the optimizer's ``loss_scale``, so every
  gradient comes out multiplied by it (an underflow shield for 16-bit
  compute); each gradient is unscaled in f32 and one global squared norm
  is taken (``torch._foreach_mul_`` / ``torch._foreach_norm``: stock
  PyTorch, as the JAX package computes it with plain ``jnp``);
- the step is bad when the loss or that norm is not finite (or exceeds
  ``max_loss`` / ``max_grad_norm``); the verdict ``ok`` is a 0-d tensor on
  the device;
- the optimizer updates with ``ok`` (``Optimizer.update_params``): the
  multi-tensor kernels K1/K5/K6/K7 read it through a pointer and skip, a
  parameter that ``Optimizer.apply`` updates alone is put back from a
  snapshot, and the step counter advances by ``ok``; a bad step is a
  no-op on every parameter and optimizer state;
- model state that the forward updated in place (the BN running
  statistics) is restored on a bad step from a shadow that holds its value
  as of the last good step, then the shadow is refreshed (one flat buffer
  per dtype, so four launches in place of two per statistic);
- the loss scale backs off on a bad step and grows after
  ``growth_interval`` good ones, clipped to ``[min_scale, max_scale]``;
  the streaks, ``skipped_total`` and ``last_grad_norm`` are 0-d device
  tensors, saved with the optimizer's states (``guard/...``,
  ``guard-shadow/...``).

Over a ``DistOpt`` (``singa_tpu/resilience/guards.py:273-345``) the
scaled gradients are averaged over the ranks by ``DistOpt.reduced_mean``
(on the policy's wire) and then unscaled in f32; the
loss verdict is summed over the ranks, so a NaN on one rank skips the step
on every rank. Its half, partial and sparse drivers pass through
unguarded, as in the JAX package. In the train step of a model compiled
with a mesh (``parallel.gspmd``) a plain inner optimizer's gradients are
averaged the same way, through the step's ``DistOpt``. A parameter cut
over mesh axes (ZeRO/FSDP, a tensor-parallel ``model`` or an
expert-parallel ``expert`` layout) has its gradient as this rank's block:
the global squared norm is the whole gradients' plus, per set of cut
axes, the blocks' summed over those axes' ranks, so every rank reaches
the same verdict.

The host reads them only in :meth:`GuardedOptimizer.stats`,
:meth:`~GuardedOptimizer.bad_streak_value` and the checkpoint routes.
Not ported yet: ``record_metrics`` (``observability``, ROADMAP slice E).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import autograd_base
from ..opt import DistOpt
from ..tensor import Tensor

_SHADOW = "guard-shadow/"
_OWN = ("guard/bad_streak", "guard/good_streak", "guard/skipped_total",
        "guard/last_grad_norm")


class GuardedOptimizer:
    """Skip-bad-steps wrapper around an optimizer (module docstring).
    ``dynamic_loss_scale=False`` pins the scale; the skip and the streaks
    still run. Every other attribute is the wrapped optimizer's."""

    def __init__(self, optimizer, *, dynamic_loss_scale=True,
                 init_scale=1.0, growth_factor=2.0, backoff_factor=0.5,
                 growth_interval=2000, min_scale=2.0 ** -14,
                 max_scale=2.0 ** 24, max_loss=None, max_grad_norm=None):
        self.inner = optimizer
        self.dynamic_loss_scale = bool(dynamic_loss_scale)
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.max_loss = max_loss
        self.max_grad_norm = max_grad_norm
        self._own = None         # state name -> 0-d Tensor, made at bind
        self._model = None
        self._shadows = {}       # model-state name -> shadow Tensor
        self._flat = None        # [(live Tensors, flat shadow buffer)]
        if optimizer.device is not None:
            self.bind(optimizer.device)

    @classmethod
    def for_policy(cls, optimizer, policy):
        """The companion ``Model.compile`` gives a plain optimizer under a
        16-bit policy: dynamic loss scaling from the policy's
        ``default_loss_scale`` (2^15 for float16, 1.0 for bfloat16)."""
        return cls(optimizer, dynamic_loss_scale=True,
                   init_scale=policy.default_loss_scale)

    # -- plumbing ------------------------------------------------------------
    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def bind(self, device):
        """Bind the wrapped optimizer to ``device`` and make the guard's
        scalars there; the loss scale starts at ``init_scale``."""
        self.inner.bind(device)
        if self._own is None:
            self._own = {k: Tensor(shape=(), device=device, name=k)
                         for k in _OWN}
            self.inner.loss_scale.data.fill_(self.init_scale)
        return self

    def bind_model(self, model):
        """Called by ``Model.set_optimizer``: the guard shadows the model
        state the optimizer never sees (BN running statistics)."""
        self._model = model
        self._flat = None

    def _shadowable_states(self):
        if self._model is None:
            return
        opt_ids = {id(t) for t in self.inner.state_tensors()}
        for name, t in self._model._live_states().items():
            # trainable params are masked through their update; the rest
            # is state the forward mutates
            if not t.requires_grad and id(t) not in opt_ids:
                yield name, t

    def materialize_shadows(self):
        """Make the shadows from the current values (a shadow restored
        from a checkpoint keeps its value), once; ``Model.__call__`` runs
        this before each training forward."""
        if self._flat is not None or self._model is None:
            return
        groups = {}
        for name, t in self._shadowable_states():
            groups.setdefault(t.dtype, []).append((name, t))
        self._flat = []
        for members in groups.values():
            flat = torch.cat([
                (self._shadows[n].data if n in self._shadows else t.data)
                .reshape(-1).to(t.dtype) for n, t in members])
            at = 0
            for n, t in members:
                view = flat[at:at + t.data.numel()].view(t.shape)
                at += t.data.numel()
                self._shadows[n] = Tensor(data=view, device=t.device,
                                          name=_SHADOW + n)
            self._flat.append(([t for _, t in members], flat))

    # -- states --------------------------------------------------------------
    def _own_state(self):
        if self._own is None:
            raise RuntimeError(
                "the guard's states need the optimizer's device: bind it "
                "first (Model.compile / set_optimizer, or bind(device))")
        return self._own

    def state_tensors(self):
        return self.inner.state_tensors() + \
            list(self._own_state().values()) + list(self._shadows.values())

    def state_tensor_dict(self):
        d = self.inner.state_tensor_dict()
        d.update(self._own_state())
        d.update({_SHADOW + k: v for k, v in self._shadows.items()})
        return d

    def get_states(self):
        """The wrapped optimizer's states, the guard's scalars
        (``guard/...``) and the shadows (``guard-shadow/<state>``), as
        host arrays."""
        states = self.inner.get_states()     # shards gathered
        if self._own is None:             # nothing has run yet
            states["loss_scale"] = np.float32(self.init_scale)
            states.update({k: np.zeros((), np.float32) for k in _OWN})
            return states
        states.update({k: v.to_numpy() for k, v in self._own.items()})
        states.update({_SHADOW + k: v.to_numpy()
                       for k, v in self._shadows.items()})
        return states

    def set_states(self, states):
        own = self._own_state()
        rest = {}
        for k, v in states.items():
            if k in own:
                own[k].copy_from_numpy(np.asarray(v, np.float32))
            elif k.startswith(_SHADOW):
                self._set_shadow(k[len(_SHADOW):], np.asarray(v))
            else:
                rest[k] = v
        self.inner.set_states(rest)

    def restore_state_tensor(self, name, array):
        self.set_states({name: array})

    def _set_shadow(self, name, array):
        sh = self._shadows.get(name)
        if sh is None:
            self._shadows[name] = Tensor(data=array, device=self.device,
                                         name=_SHADOW + name)
        else:
            sh.copy_from_numpy(array)

    # -- host reads -----------------------------------------------------------
    def bad_streak_value(self) -> int:
        """Consecutive bad (skipped) steps: one scalar read back."""
        return int(float(self._own_state()["guard/bad_streak"].data))

    def stats(self) -> dict:
        own = self._own_state()
        return {
            "loss_scale": float(self.inner.loss_scale.data),
            "bad_streak": int(float(own["guard/bad_streak"].data)),
            "good_streak": int(float(own["guard/good_streak"].data)),
            "skipped_total": int(float(own["guard/skipped_total"].data)),
            "grad_norm": float(own["guard/last_grad_norm"].data),
        }

    def reset_streaks(self, extra_backoff=False):
        """Zero the streaks (after a rollback to a checkpoint); optionally
        back the loss scale off once more."""
        own = self._own_state()
        with torch.no_grad():
            own["guard/bad_streak"].data.zero_()
            own["guard/good_streak"].data.zero_()
            if extra_backoff and self.dynamic_loss_scale:
                ls = self.inner.loss_scale.data
                ls.copy_(torch.clamp(ls * self.backoff_factor,
                                     min=self.min_scale))

    # -- the guarded step -----------------------------------------------------
    def __call__(self, loss):
        self.backward_and_update(loss)

    def backward_and_update(self, loss):
        from ..parallel.gspmd import active_reducer
        if self._own is None:
            self.bind(loss.device)
        dist = self.inner if isinstance(self.inner, DistOpt) else None
        base = self.inner if dist is None else dist.opt
        scale = base.loss_scale.data
        loss_arr = loss.data
        pairs = autograd_base.backward(
            loss, dy=scale.expand(loss_arr.shape).to(loss_arr.dtype))
        if dist is None:
            dist = active_reducer()      # a plain optimizer under a mesh
        if dist is not None:
            pairs = dist.reduced_mean(pairs)
        pairs = list(pairs)
        with torch.no_grad():
            ok = self._loss_ok(loss_arr.detach())
            if dist is not None:
                # a bad loss on one rank skips the step on every rank
                ok = dist.all_reduce((~ok).float()) == 0
            ok, norm_sq = self._unscale(pairs, scale, ok)
            okf = ok.to(torch.float32)
            base.update_params(pairs, ok=okf)
            base.step(okf)
            self._restore_shadows(ok)
            self._bookkeeping(ok, okf, norm_sq, scale)

    def _loss_ok(self, loss_arr):
        """The loss half of the verdict: finite (and within ``max_loss``)."""
        loss32 = loss_arr.float()
        ok = torch.isfinite(loss32).all()
        if self.max_loss is not None:
            ok = ok & ~(loss32 > self.max_loss).any()
        return ok

    def _unscale(self, pairs, scale, ok):
        """Unscale every gradient in f32 (cast back to its parameter's
        dtype) and return the step's verdict (``ok``, the loss's, and a
        finite global norm within ``max_grad_norm``) and the global squared
        norm."""
        g32 = [g.data.float() for _, g in pairs]
        norm_sq = torch.zeros((), dtype=torch.float32, device=scale.device)
        if g32:
            torch._foreach_mul_(g32, torch.reciprocal(scale))
            norm_sq = self._norm_sq(pairs, g32, norm_sq)
        for (p, g), a in zip(pairs, g32):
            g.data = a if a.dtype == p.dtype else a.to(p.dtype)
        ok = ok & torch.isfinite(norm_sq)
        if self.max_grad_norm is not None:
            ok = ok & (norm_sq <= float(self.max_grad_norm) ** 2)
        return ok, norm_sq

    @staticmethod
    def _norm_sq(pairs, g32, zero):
        """The global squared norm of the unscaled gradients ``g32``. A
        gradient of a parameter cut over mesh axes (``gspmd.cuts_of``:
        ZeRO/FSDP's axis, a tensor-parallel layout's ``model``, an expert
        layout's ``expert``) is this rank's block of it, so the squares of
        the gradients cut over the same axes are summed over those axes'
        ranks (one all-reduce per set of axes, in the same order on every
        rank) and added to the whole gradients' own: every rank reaches the
        same verdict."""
        from ..parallel.communicator import Communicator
        from ..parallel.gspmd import cuts_of

        def sq(ts):
            return torch.sum(torch.stack(torch._foreach_norm(ts)).square()) \
                if ts else zero
        by_axes = {}
        for (p, _), a in zip(pairs, g32):
            cuts = cuts_of(p)
            axes = tuple(sorted({lay.axis for lay, _ in cuts}))
            by_axes.setdefault(axes, (cuts[0][0] if cuts else None, []))[
                1].append(a)
        total = sq(by_axes.pop((), (None, []))[1])
        for axes in sorted(by_axes):
            lay, ts = by_axes[axes]
            comm = lay.comm if axes == (lay.axis,) else Communicator(
                axis_name=lay.axis, mesh=lay.comm.mesh, reduce_axes=axes)
            total = total + comm.all_reduce(sq(ts).clone())
        return total

    def _restore_shadows(self, ok):
        """Forward-mutated state: its last good value on a bad step; the
        shadows follow the live values. Nothing before the shadows are
        made (``Model.__call__`` makes them ahead of the forward)."""
        for live, flat in self._flat or ():
            now = torch.cat([t.data.reshape(-1) for t in live])
            kept = torch.where(ok, now, flat)
            torch._foreach_copy_([t.data for t in live], [
                piece.view(t.shape) for piece, t in zip(
                    kept.split([t.data.numel() for t in live]), live)])
            flat.copy_(kept)

    def _bookkeeping(self, ok, okf, norm_sq, scale):
        """The streaks, ``skipped_total``, ``last_grad_norm`` and the loss
        scale, on the device: the streaks move on a bad step too."""
        own = self._own
        bad = own["guard/bad_streak"].data
        good = own["guard/good_streak"].data
        zero = torch.zeros_like(bad)
        good_next = good + 1.0
        bad.copy_(torch.where(ok, zero, bad + 1.0))
        own["guard/skipped_total"].data.add_(1.0 - okf)
        own["guard/last_grad_norm"].data.copy_(torch.sqrt(norm_sq))
        if self.dynamic_loss_scale:
            grown = torch.where(
                torch.remainder(good_next, float(self.growth_interval))
                == 0.0, scale * self.growth_factor, scale)
            new_scale = torch.where(ok, grown, scale * self.backoff_factor)
            scale.copy_(torch.clamp(new_scale, self.min_scale,
                                    self.max_scale))
        good.copy_(torch.where(ok, good_next, zero))
