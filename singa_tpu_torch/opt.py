"""Optimizers.

Counterpart of ``singa_tpu/opt.py:30-492``: the tensor-resident learning
rate schedules (``DecayScheduler``, ``Constant``, ``ExponentialDecay``),
``Regularizer`` and ``Constraint``, the ``Optimizer`` base with its step
counter, loss scale and per-parameter aux states, and ``SGD``,
``RMSProp``, ``AdaGrad`` and ``Adam`` with the same update math.

The learning rate is a 0-d f32 tensor on the parameters' device, computed
from the step counter (a device tensor too) once per step. The fused
kernels read it through a pointer, so a schedule costs no host sync and no
rebuild. Every update runs in place on the parameter and its states under
``torch.no_grad()``, so a parameter stays the same leaf tensor from step
to step.

``fused=True`` routes each eligible parameter's update through
``ops.fused_optim`` (kernels K1, K5, K6, K7): the CUDA kernel on the card,
its plain version on the CPU. A parameter with a regularizer or a
constraint, or one that is not floating point, declines to the plain
chain below, per parameter, as the JAX package does. Unlike the JAX
package there is no size gate (``MIN_FUSED_ELEMS``): on the card every
eligible parameter goes to the kernel. A training step
(:meth:`Optimizer.backward_and_update`) gathers the eligible parameters of
``SGD`` (with momentum), ``Adam`` (without amsgrad), ``RMSProp`` and
``AdaGrad`` into one multi-tensor call (``sgd_momentum_update_multi``,
``adam_update_multi``, ``rmsprop_update_multi``,
``adagrad_update_multi``: a few launches for the whole model), and sends
every other parameter through :meth:`Optimizer.apply`, which updates one
parameter and keeps the per-tensor kernels.

The loss scale is a 0-d f32 device state, 1.0 unless a
``resilience.GuardedOptimizer`` drives the optimizer (dynamic loss
scaling, the default companion of a 16-bit compute policy such as
``bf16_mixed``): the guard seeds the backward with it and rewrites it on
the card each step. A guarded step hands :meth:`Optimizer.update_params`
and :meth:`Optimizer.step` its verdict ``ok`` (a 0-d device tensor), and a
bad step is a no-op on every parameter, state and the step counter, with
no host sync: the multi-tensor kernels skip on the flag, a parameter that
:meth:`Optimizer.apply` updates alone is put back from a snapshot.
``DistOpt`` raises until data-parallel training is ported (ROADMAP, slice
B).
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd_base
from . import graph
from .tensor import Tensor


class DecayScheduler:
    """lr(step) as a device tensor."""

    def __init__(self, init_value):
        self.init_value = init_value

    def __call__(self, step):
        raise NotImplementedError

    def get_states(self):
        return {"init_value": self.init_value}

    def set_states(self, states):
        if "init_value" in states:
            self.init_value = float(states["init_value"])


def _step_data(step):
    return step.data if isinstance(step, Tensor) else step


class Constant(DecayScheduler):
    def __call__(self, step):
        s = _step_data(step)
        return torch.full((), float(self.init_value), dtype=torch.float32,
                          device=s.device)


class ExponentialDecay(DecayScheduler):
    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step):
        e = _step_data(step).float() / self.decay_steps
        if self.staircase:
            e = torch.floor(e)
        return torch.pow(self.decay_rate, e) * self.init_value


def _grad_data(grad):
    return grad.data if isinstance(grad, Tensor) else grad


def _grad_as(grad, p):
    """The gradient in ``p``'s dtype, as :meth:`Optimizer.apply` casts it
    (without the cost of a ``to`` call when it already is)."""
    g = _grad_data(grad)
    return g if g.dtype == p.dtype else g.to(p.dtype)


class Regularizer:
    """Parameter-gradient regularizer: L2 is ``grad + c * value``, L1
    ``grad + c * sign(value)``."""

    def __init__(self, type="l2", coefficient=0.0):  # noqa: A002 (parity)
        self.type = type.lower()
        if self.type not in ("l1", "l2", "notset"):
            raise ValueError(f"unknown regularizer type {type!r}")
        self.coefficient = coefficient

    def apply(self, value, grad):
        if self.type == "l2":
            return grad + value * self.coefficient
        if self.type == "l1":
            return grad + torch.sign(value) * self.coefficient
        return grad


class Constraint:
    """Parameter-gradient constraint: clip the gradient's L2 norm to a
    threshold (``"l2"``) or its values to +-threshold (``"value"``)."""

    def __init__(self, type="l2", threshold=1.0):  # noqa: A002 (parity)
        self.type = type.lower()
        if self.type not in ("l2", "value", "notset"):
            raise ValueError(f"unknown constraint type {type!r}")
        self.threshold = threshold

    def apply(self, value, grad):
        if self.type == "l2":
            norm = torch.sqrt(torch.sum(grad.float() ** 2))
            scale = torch.clamp(self.threshold / (norm + 1e-12), max=1.0)
            return grad * scale.to(grad.dtype)
        if self.type == "value":
            return torch.clamp(grad, -self.threshold, self.threshold)
        return grad


class Optimizer:
    """Base optimizer. ``step_counter``, ``loss_scale`` and the aux states
    (named ``<param>:<kind>``) are Tensors on the parameters' device, made
    when a model binds the optimizer to its device (``Model.compile`` /
    ``set_optimizer``) or on the first update."""

    def __init__(self, lr):
        self.lr = lr if isinstance(lr, DecayScheduler) else Constant(lr)
        self.step_counter = None
        self.loss_scale = None
        self.device = None
        self._aux = {}                # name -> Tensor, made per param
        self.regularizer = None       # global default
        self.constraint = None        # global default
        self._regularizers = {}       # per-param overrides
        self._constraints = {}
        self._lr_multipliers = {}
        self._step_cache = {}         # per-step device scalars
        self._touched = None          # in _apply_masked: aux -> its before

    # -- device binding ---------------------------------------------------
    def bind(self, device):
        """Make the step counter and loss scale on ``device`` (a
        :class:`~.device.Device`). A second call with another device
        raises: the states live on one device."""
        if self.device is not None:
            if device.torch_device != self.device.torch_device:
                raise ValueError(
                    f"optimizer already bound to {self.device.torch_device}"
                    f", not {device.torch_device}")
            return self
        self.device = device
        self.step_counter = Tensor(shape=(), device=device,
                                   name="step_counter")
        self.loss_scale = Tensor(shape=(), device=device, name="loss_scale")
        self.loss_scale.data.fill_(1.0)
        return self

    def _bound(self, p):
        if self.device is None:
            self.bind(p.device)
        return self

    def register(self, name, regularizer=None, constraint=None,
                 lr_multiplier=None):
        """Attach a per-param regularizer/constraint/lr multiplier."""
        if regularizer is not None:
            self._regularizers[name] = regularizer
        if constraint is not None:
            self._constraints[name] = constraint
        if lr_multiplier is not None:
            self._lr_multipliers[name] = float(lr_multiplier)

    def apply_regularizer_constraint(self, name, value, grad):
        """Regularizer first, then constraint."""
        reg = self._regularizers.get(name, self.regularizer)
        if reg is not None:
            grad = reg.apply(value, grad)
        con = self._constraints.get(name, self.constraint)
        if con is not None:
            grad = con.apply(value, grad)
        return grad

    def _per_step(self, key, fn):
        """``fn()`` once per step: cached until the step counter moves,
        or a graph-mode step is captured or replayed (``graph.epoch()``: a
        replay moves the counter on the device and not its version)."""
        version = (self.step_counter.data._version, graph.epoch())
        hit = self._step_cache.get(key)
        if hit is None or hit[0] is not self.step_counter.data or \
                hit[1] != version:
            hit = (self.step_counter.data, version, fn())
            self._step_cache[key] = hit
        return hit[2]

    @property
    def lr_value(self):
        """The learning rate of this step: a 0-d f32 tensor on the
        device."""
        return self._per_step("lr", lambda: self.lr(self.step_counter)
                              .to(torch.float32).reshape(()))

    def _scaled_lr(self, name):
        mult = self._lr_multipliers.get(name)
        return self.lr_value * mult if mult is not None else self.lr_value

    def _fused_ok(self, name, p):
        """Whether this param's update takes the fused kernel: ``fused=
        True``, no regularizer or constraint applies to it (their math is
        composed here and would be dropped), and it is floating point. No
        size gate."""
        if not getattr(self, "fused", False):
            return False
        if self._regularizers.get(name, self.regularizer) is not None:
            return False
        if self._constraints.get(name, self.constraint) is not None:
            return False
        return p.dtype.is_floating_point

    def should_apply_weight_decay(self, name):
        return True

    # -- train driving ----------------------------------------------------
    def __call__(self, loss):
        self.backward_and_update(loss)

    def backward_and_update(self, loss):
        self.update_params(autograd_base.backward(loss))
        self.step()

    def update_params(self, pairs, ok=None):
        """Update each parameter in place from its ``(param, grad)`` pair
        (what ``autograd_base.backward`` yields): the ones that take a
        multi-tensor kernel (:meth:`_multi_entry`) together in one call,
        every other one through :meth:`apply`, with the same state names
        and the same results. The step counter does not move. ``ok``, a
        guarded step's verdict (a 0-d device tensor, or None): where it
        is 0 nothing changes, and a state born in this call stays zero."""
        entries = []
        for p, g in pairs:
            name = p.name or f"param/{id(p)}"
            entry = self._multi_entry(name, p, g)
            if entry is None:
                if ok is None:
                    self.apply(name, p, g)
                else:
                    self._apply_masked(name, p, g, ok)
            else:
                entries.append(entry)
        if entries:
            with torch.no_grad():
                self._update_multi(entries, ok)

    def _apply_masked(self, name, p, g, ok):
        """:meth:`apply`, then ``torch.where(ok, new, old)`` on the
        parameter and on every aux state the update asked for
        (:meth:`_get_aux` notes each one's value before)."""
        old_p = p.data.clone()
        self._touched = {}
        try:
            self.apply(name, p, g)
            touched = self._touched
        finally:
            self._touched = None
        keep = ok != 0
        with torch.no_grad():
            p.data.copy_(torch.where(keep, p.data, old_p))
            for t, old in touched.values():
                t.data.copy_(torch.where(keep, t.data, old))

    def step(self, ok=None):
        """Advance the step counter by 1, or by a guarded step's ``ok``
        (1 or 0, on the device)."""
        with torch.no_grad():
            self.step_counter.data.add_(1.0 if ok is None else ok)

    def apply(self, param_name, param_value, param_grad):
        """Update ``param_value`` in place from ``param_grad``, alone (the
        fused optimizers through their per-tensor kernels)."""
        self._bound(param_value)
        with torch.no_grad():
            self._update(param_name, param_value,
                         _grad_data(param_grad).to(param_value.dtype))

    def _update(self, name, p, grad):
        raise NotImplementedError

    def _multi_entry(self, name, p, grad):
        """The entry of ``name``'s update in the step's multi-tensor call,
        or None where :meth:`apply` updates it alone (the base class: every
        parameter)."""
        return None

    def _update_multi(self, entries, ok=None):
        raise NotImplementedError

    # -- state ------------------------------------------------------------
    def _get_aux(self, key, like):
        t = self._aux.get(key)
        if t is None:
            t = Tensor(shape=like.shape, device=like.device,
                       dtype=like.dtype, name=key)
            self._aux[key] = t
        if self._touched is not None and key not in self._touched:
            self._touched[key] = (t, t.data.clone())
        return t

    def state_tensors(self):
        """Every live state Tensor: the step counter, the loss scale and
        the aux states."""
        return [self.step_counter, self.loss_scale] + list(self._aux.values())

    def restore_state_tensor(self, name, array):
        """Set one state from a host array (see :meth:`set_states`)."""
        self.set_states({name: array})

    def state_tensor_dict(self):
        """name -> live state Tensor."""
        d = {"step_counter": self.step_counter,
             "loss_scale": self.loss_scale}
        d.update(self._aux)
        return d

    def get_states(self):
        """name -> host array: ``step_counter``, ``loss_scale`` and every
        aux state (what ``save_states`` writes as ``optimizer/<name>``)."""
        if self.device is None:           # nothing has run yet
            return {"step_counter": np.zeros((), np.float32),
                    "loss_scale": np.ones((), np.float32)}
        return {k: v.to_numpy() for k, v in self.state_tensor_dict().items()}

    def set_states(self, states):
        """Restore from ``get_states`` output (host arrays) into a bound
        optimizer. A live aux state keeps its dtype; a new one takes the
        array's."""
        if self.device is None:
            raise RuntimeError(
                "set_states needs the optimizer's device: bind it first "
                "(Model.compile / set_optimizer, or bind(device))")
        for k, v in states.items():
            if k in ("step_counter", "loss_scale"):
                getattr(self, k).copy_from_numpy(
                    np.asarray(v, np.float32).reshape(()))
            elif k in self._aux:
                self._aux[k].copy_from_numpy(np.asarray(v))
            else:
                self._aux[k] = Tensor(data=np.asarray(v), device=self.device,
                                      name=k)


class SGD(Optimizer):
    """SGD with momentum, dampening, nesterov and weight decay.
    ``fused=True`` sends each eligible momentum update through kernel K1,
    a training step's all in one multi-tensor call (a momentum-less SGD
    has no state to fuse with)."""

    def __init__(self, lr=0.1, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, fused=False):
        super().__init__(lr)
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.fused = bool(fused)
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum>0 and dampening=0")

    def _weight_decay(self, name):
        return self.weight_decay \
            if self.weight_decay != 0 and \
            self.should_apply_weight_decay(name) else 0.0

    def _multi_entry(self, name, p, grad):
        if self.momentum == 0 or not self._fused_ok(name, p):
            return None
        self._bound(p)
        return (p.data, _grad_as(grad, p),
                self._get_aux(f"{name}:momentum", p).data,
                self._scaled_lr(name), self._weight_decay(name))

    def _update_multi(self, entries, ok=None):
        from .ops import fused_optim
        fused_optim.sgd_momentum_update_multi(
            entries, momentum=self.momentum, dampening=self.dampening,
            nesterov=self.nesterov, ok=ok)

    def _update(self, name, p, grad):
        wd = self._weight_decay(name)
        if self.momentum != 0 and self._fused_ok(name, p):
            from .ops import fused_optim
            buf = self._get_aux(f"{name}:momentum", p)
            fused_optim.sgd_momentum_update(
                p.data, grad, buf.data, self._scaled_lr(name),
                momentum=self.momentum, dampening=self.dampening,
                weight_decay=wd, nesterov=self.nesterov)
            return
        if wd:
            grad = grad + p.data * wd
        grad = self.apply_regularizer_constraint(name, p.data, grad)
        if self.momentum != 0:
            buf = self._get_aux(f"{name}:momentum", p)
            buf.data.copy_((buf.data * self.momentum
                            + grad * (1 - self.dampening)).to(buf.dtype))
            grad = grad + buf.data * self.momentum if self.nesterov \
                else buf.data
        # the update math runs in f32 for low-precision params (the lr is
        # f32) and is stored back in the param's dtype
        p.data.copy_((p.data - self._scaled_lr(name) * grad).to(p.dtype))


class RMSProp(Optimizer):
    """RMSProp. ``fused=True``: kernel K6 for each eligible param, a
    training step's all in one multi-tensor call. The weight decay applies
    to every param, as in the JAX package."""

    def __init__(self, lr=0.1, rho=0.9, epsilon=1e-8, weight_decay=0.0,
                 fused=False):
        super().__init__(lr)
        self.rho = rho
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.fused = bool(fused)

    def _multi_entry(self, name, p, grad):
        if not self._fused_ok(name, p):
            return None
        self._bound(p)
        return (p.data, _grad_as(grad, p),
                self._get_aux(f"{name}:rms", p).data,
                self._scaled_lr(name), self.weight_decay)

    def _update_multi(self, entries, ok=None):
        from .ops import fused_optim
        fused_optim.rmsprop_update_multi(entries, rho=self.rho,
                                         epsilon=self.epsilon, ok=ok)

    def _update(self, name, p, grad):
        if self._fused_ok(name, p):
            from .ops import fused_optim
            rms = self._get_aux(f"{name}:rms", p)
            fused_optim.rmsprop_update(
                p.data, grad, rms.data, self._scaled_lr(name), rho=self.rho,
                epsilon=self.epsilon, weight_decay=self.weight_decay)
            return
        if self.weight_decay != 0:
            grad = grad + p.data * self.weight_decay
        grad = self.apply_regularizer_constraint(name, p.data, grad)
        rms = self._get_aux(f"{name}:rms", p)
        rms.data.copy_((rms.data * self.rho
                        + grad * (1 - self.rho) * grad).to(rms.dtype))
        p.data.copy_((p.data - self._scaled_lr(name) * grad
                      / torch.sqrt(rms.data + self.epsilon)).to(p.dtype))


class AdaGrad(Optimizer):
    """AdaGrad. ``fused=True``: kernel K7 for each eligible param, a
    training step's all in one multi-tensor call. The weight decay applies
    to every param, as in the JAX package."""

    def __init__(self, lr=0.1, epsilon=1e-8, weight_decay=0.0,
                 fused=False):
        super().__init__(lr)
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.fused = bool(fused)

    def _multi_entry(self, name, p, grad):
        if not self._fused_ok(name, p):
            return None
        self._bound(p)
        return (p.data, _grad_as(grad, p),
                self._get_aux(f"{name}:history", p).data,
                self._scaled_lr(name), self.weight_decay)

    def _update_multi(self, entries, ok=None):
        from .ops import fused_optim
        fused_optim.adagrad_update_multi(entries, epsilon=self.epsilon,
                                         ok=ok)

    def _update(self, name, p, grad):
        if self._fused_ok(name, p):
            from .ops import fused_optim
            hist = self._get_aux(f"{name}:history", p)
            fused_optim.adagrad_update(
                p.data, grad, hist.data, self._scaled_lr(name),
                epsilon=self.epsilon, weight_decay=self.weight_decay)
            return
        if self.weight_decay != 0:
            grad = grad + p.data * self.weight_decay
        grad = self.apply_regularizer_constraint(name, p.data, grad)
        hist = self._get_aux(f"{name}:history", p)
        hist.data.copy_((hist.data + grad * grad).to(hist.dtype))
        p.data.copy_((p.data - self._scaled_lr(name) * grad
                      / torch.sqrt(hist.data + self.epsilon)).to(p.dtype))


class Adam(Optimizer):
    """Adam (with amsgrad). ``fused=True``: kernel K5 for each eligible
    param, a training step's all in one multi-tensor call; amsgrad keeps
    the plain path (its running max is a fourth state the kernel does not
    carry)."""

    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0, amsgrad=False, fused=False):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.amsgrad = amsgrad
        self.fused = bool(fused)

    def _bias_corrections(self):
        """``1 - beta**t`` for t = step + 1, as device scalars, once per
        step."""
        def make():
            t = self.step_counter.data + 1.0
            return (1 - torch.pow(self.beta_1, t),
                    1 - torch.pow(self.beta_2, t))
        return self._per_step("bias_corrections", make)

    def _multi_entry(self, name, p, grad):
        if self.amsgrad or not self._fused_ok(name, p):
            return None
        self._bound(p)
        return (p.data, _grad_as(grad, p), self._get_aux(f"{name}:m", p).data,
                self._get_aux(f"{name}:v", p).data, self._scaled_lr(name),
                self.weight_decay)

    def _update_multi(self, entries, ok=None):
        from .ops import fused_optim
        bc1, bc2 = self._bias_corrections()
        fused_optim.adam_update_multi(
            entries, bc1, bc2, beta_1=self.beta_1, beta_2=self.beta_2,
            epsilon=self.epsilon, ok=ok)

    def _update(self, name, p, grad):
        bc1, bc2 = self._bias_corrections()
        if not self.amsgrad and self._fused_ok(name, p):
            from .ops import fused_optim
            m = self._get_aux(f"{name}:m", p)
            v = self._get_aux(f"{name}:v", p)
            fused_optim.adam_update(
                p.data, grad, m.data, v.data, self._scaled_lr(name), bc1,
                bc2, beta_1=self.beta_1, beta_2=self.beta_2,
                epsilon=self.epsilon, weight_decay=self.weight_decay)
            return
        if self.weight_decay != 0:
            grad = grad + p.data * self.weight_decay
        grad = self.apply_regularizer_constraint(name, p.data, grad)
        m = self._get_aux(f"{name}:m", p)
        v = self._get_aux(f"{name}:v", p)
        m.data.copy_((m.data * self.beta_1
                      + grad * (1 - self.beta_1)).to(m.dtype))
        v.data.copy_((v.data * self.beta_2
                      + grad * (1 - self.beta_2) * grad).to(v.dtype))
        mhat = m.data / bc1
        if self.amsgrad:
            vmax = self._get_aux(f"{name}:vmax", p)
            vmax.data.copy_(torch.maximum(vmax.data, v.data))
            vhat = vmax.data / bc2
        else:
            vhat = v.data / bc2
        p.data.copy_((p.data - self._scaled_lr(name) * mhat
                      / (torch.sqrt(vhat) + self.epsilon)).to(p.dtype))


class DistOpt:
    """Data-parallel optimizer: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistOpt (data-parallel training) is not ported yet (ROADMAP: "
            "slice B, torch.distributed); train on one device with a plain "
            "optimizer")
