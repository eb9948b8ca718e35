"""Optimizers.

Counterpart of ``singa_tpu/opt.py:30-962``: the tensor-resident learning
rate schedules (``DecayScheduler``, ``Constant``, ``ExponentialDecay``),
``Regularizer`` and ``Constraint``, the ``Optimizer`` base with its step
counter, loss scale and per-parameter aux states, and ``SGD``,
``RMSProp``, ``AdaGrad`` and ``Adam`` with the same update math, and
``DistOpt``.

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

:class:`DistOpt` wraps any of them for data-parallel training over
``torch.distributed`` (NCCL on the card, gloo on the CPU): each rank's
gradients are summed over the ranks, averaged, and handed to the wrapped
optimizer's :meth:`Optimizer.update_params`, so the fused step stays one
multi-tensor call.

Under ZeRO/FSDP (``DistOpt(zero=True)`` or ``Model.compile(fsdp_axis=)``,
``parallel.gspmd``), and for a tensor- or expert-parallel model, an
optimizer's ``layouts`` are the model's ``ShardedLayout`` objects: the states
that mirror a sharded parameter (``<param>:<kind>``) are this rank's
block of it, made from the block that the update hands them, and
:meth:`Optimizer.get_states` /
:meth:`Optimizer.set_states` gather and cut them (collectively), so their
names, shapes and host arrays are those of a replicated run;
:meth:`Optimizer.state_tensor_dict` gives the live shards.
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
        self.layouts = []             # parallel.gspmd.ShardedLayouts

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
        """Backward, update, step. In the train step of a model compiled
        with a mesh the gradients are averaged over the data ranks first
        (``parallel.gspmd.active_reducer``)."""
        from .parallel.gspmd import active_reducer
        pairs = autograd_base.backward(loss)
        reducer = active_reducer()
        if reducer is not None:
            pairs = reducer.reduced_mean(pairs)
        self.update_params(pairs)
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
            t.sharding = like.sharding    # a shard's state is a shard
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
        aux state (what ``save_states`` writes as ``optimizer/<name>``), a
        shard gathered into its full array (collective)."""
        if self.device is None:           # nothing has run yet
            return {"step_counter": np.zeros((), np.float32),
                    "loss_scale": np.ones((), np.float32)}
        return {k: self._host(v)
                for k, v in self.state_tensor_dict().items()}

    def _host(self, t):
        if t.sharding is not None:
            from .parallel.gspmd import full_tensor
            t = full_tensor(t)
        return t.to_numpy()

    def set_states(self, states):
        """Restore from ``get_states`` output (host arrays) into a bound
        optimizer. A live aux state keeps its dtype; a new one takes the
        array's. Under a ``layout`` the state of a sharded parameter takes
        this rank's block of the array."""
        from .parallel.gspmd import cuts_of, local_part
        if self.device is None:
            raise RuntimeError(
                "set_states needs the optimizer's device: bind it first "
                "(Model.compile / set_optimizer, or bind(device))")
        for k, v in states.items():
            arr = np.asarray(v)
            if k in ("step_counter", "loss_scale"):
                getattr(self, k).copy_from_numpy(
                    arr.astype(np.float32).reshape(()))
                continue
            t = self._aux.get(k)
            if t is not None:
                cuts = cuts_of(t)
            else:                   # a new state mirrors its parameter's cuts
                param = next((lay.named[k.rpartition(":")[0]]
                              for lay in self.layouts
                              if k.rpartition(":")[0] in lay.named), None)
                cuts = cuts_of(param) if param is not None else ()
            part = local_part(arr, cuts)
            if t is not None:
                t.copy_from_numpy(part)
                continue
            t = self._aux[k] = Tensor(data=part, device=self.device, name=k)
            if cuts:
                t.sharding = (cuts, arr.shape)


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
    """Data-parallel optimizer: the gradients summed over the ranks of the
    ``data`` axis and averaged before the wrapped optimizer updates
    (reference ``opt.py:686-1094``, ``src/io/communicator.cc``; the JAX
    package's ``opt.py:494-962``).

    Each rank is a process with its own shard of the global batch and a
    replica of the parameters; ``communicator`` (``parallel.communicator.
    Communicator``) sums over the process group that
    ``parallel.communicator.init_process`` joined, and outside one it is
    the identity (a world of 1), so single-device scripts run unchanged.
    Every driver hands its reduced ``(param, grad)`` pairs to the wrapped
    optimizer's :meth:`Optimizer.update_params`, so a fused step stays one
    multi-tensor launch per chunk (K1-multi, K5-multi), then advances the
    step counter.

    ``bucket_mb`` (MiB of wire bytes; 0 or None: one collective per
    gradient) concatenates the gradients into buckets, one per wire dtype
    that fills to the target, and reduces each with one collective.
    ``overlap`` (default) starts every collective of the step before
    waiting for any, so a bucket's concatenation runs while the previous
    bucket is on the wire; ``overlap=False`` is the no-overlap baseline:
    each collective is waited for before the next starts. The backward
    returns every gradient at once (one ``torch.autograd.grad``), so in
    neither mode does a collective overlap the backward (ROADMAP.md, Queue
    1b).

    ``zero=True`` is ZeRO/FSDP: the optimizer-side spelling of
    ``Model.compile(fsdp_axis=axis_name)`` (``parallel.gspmd``), which the
    model takes from it. Its plain driver then reduce-scatters each
    sharded parameter's gradient into this rank's shard
    (:meth:`reduced_mean`), the update runs on the shards, and its half,
    partial and sparse drivers raise ``gspmd.ShardingDecline`` (they keep
    replicated states); outside such a model's train step the plain
    driver raises too.

    ``reduce_axes`` (e.g. ``("data", "expert", "seq")``) are the mesh axes
    gradients are summed over (``Communicator(reduce_axes=)``): every axis
    that splits the batch. A parameter sharded over an axis (its
    ``Tensor.spec``: ``expert`` for an expert bank, ``model`` for a
    tensor-parallel shard) holds distinct values on that axis's ranks, so
    its gradient's sum skips the axis (``_shard_axes``, per parameter, in
    every driver; buckets group gradients by the axes they skip). The
    average still divides by the full batch-shard count over every reduce
    axis: an expert's gradient already holds its peers' tokens through the
    all-to-all's transpose. ``nccl_id``, ``buffSize`` and a driver's
    ``threshold``
    are accepted for parity and ignored; ``world_size`` is the process
    group's (an explicit value that disagrees raises).
    """

    def __init__(self, opt=None, nccl_id=None, local_rank=None,
                 world_size=None, buffSize=None, axis_name="data",
                 reduce_axes=None, bucket_mb=None, overlap=True,
                 zero=False):
        from .parallel.communicator import Communicator
        self.opt = opt if opt is not None else SGD()
        self.communicator = Communicator(axis_name=axis_name,
                                         world_size=world_size,
                                         reduce_axes=reduce_axes)
        self.local_rank = local_rank if local_rank is not None \
            else self.communicator.local_rank
        self.axis_name = axis_name
        self.bucket_mb = float(bucket_mb) if bucket_mb else 0.0
        if self.bucket_mb < 0:
            raise ValueError(f"bucket_mb must be >= 0, got {bucket_mb!r}")
        self.overlap = bool(overlap)
        self.zero = bool(zero)
        # sparsification error-feedback residuals, per parameter name
        self._residuals = {}
        self._bucket_warned = set()

    @property
    def world_size(self):
        return self.communicator.world_size

    @property
    def global_rank(self):
        return self.communicator.global_rank

    # -- the wrapped optimizer's surface ---------------------------------
    @property
    def step_counter(self):
        return self.opt.step_counter

    @property
    def loss_scale(self):
        return self.opt.loss_scale

    @property
    def device(self):
        return self.opt.device

    def bind(self, device):
        self.opt.bind(device)
        return self

    def state_tensors(self):
        return self.opt.state_tensors() + list(self._residuals.values())

    def state_tensor_dict(self):
        d = self.opt.state_tensor_dict()
        d.update({f"residual/{k}": v for k, v in self._residuals.items()})
        return d

    def restore_state_tensor(self, name, array):
        self.set_states({name: array})

    def get_states(self):
        states = self.opt.get_states()
        states.update({f"residual/{k}": v.to_numpy()
                       for k, v in self._residuals.items()})
        return states

    def set_states(self, states):
        self.opt.set_states({k: v for k, v in states.items()
                             if not k.startswith("residual/")})
        for k, v in states.items():
            if not k.startswith("residual/"):
                continue
            name = k[len("residual/"):]
            if name in self._residuals:
                self._residuals[name].copy_from_numpy(np.asarray(v))
            else:
                self._residuals[name] = Tensor(
                    data=np.asarray(v), device=self.opt.device, name=k)

    def step(self, ok=None):
        self.opt.step(ok)

    def __call__(self, loss):
        self.backward_and_update(loss)

    # -- collectives ------------------------------------------------------
    @staticmethod
    def _shard_axes(p):
        """The mesh axes ``p`` is sharded over (its ``Tensor.spec``), sorted:
        per-shard gradients on those axes are distinct values, not replicas,
        so their sum skips those axes (``singa_tpu/opt.py:620-635``)."""
        spec = getattr(p, "spec", None)
        axes = set()
        for entry in spec or ():
            if isinstance(entry, (tuple, list)):
                axes.update(entry)
            elif entry is not None:
                axes.add(entry)
        return tuple(sorted(axes))

    def all_reduce(self, arr, exclude=(), async_op=False):
        return self.communicator.all_reduce(arr, exclude=exclude,
                                            async_op=async_op)

    def all_reduce_wire(self, arr, exclude=(), wire=None):
        """All-reduce on the policy's (or an explicit) 16-bit wire,
        returning f32 when a cast happened; without a wire (no policy, or
        the gradient already in the wire dtype) it reduces as it is."""
        if wire is None:
            wire = self._policy_wire()
        if wire is not None and arr.dtype != wire:
            return self.all_reduce(arr.to(wire), exclude=exclude).float()
        return self.all_reduce(arr, exclude=exclude)

    @staticmethod
    def _policy_wire():
        """The wire dtype of the active precision policy (``Model``'s train
        step enters the model's), or None."""
        from .mixed_precision import active_policy
        pol = active_policy()
        return pol.comm_dtype if pol is not None else None

    def _mean(self, pairs):
        """Divide each summed gradient by the world, in place (one
        ``_foreach_div_``): the one place the sum over the ranks becomes
        their average. Returns ``pairs``."""
        if pairs:
            with torch.no_grad():
                torch._foreach_div_(
                    [g.data for _p, g in pairs],
                    float(self.communicator.effective_world_size()))
        return pairs

    def reduced_mean(self, pairs, wire=None):
        """Backward's ``(param, grad)`` pairs averaged over the ranks:
        :meth:`grad_reduce_stream` (bucketing, overlap, ``wire``), then
        :meth:`_mean`. The plain and the guarded drivers both reduce
        through here. In the train step of a model sharded by ZeRO/FSDP
        the sharded parameters' gradients are reduce-scattered into their
        shards instead (``gspmd.ShardedLayout.reduce_mean``)."""
        from .parallel.gspmd import ShardingDecline, active_layout
        layout = active_layout()
        if layout is not None:
            return layout.reduce_mean(pairs, self, wire)
        if self.zero:
            raise ShardingDecline(
                "DistOpt(zero=True) reduces inside the train step of the "
                "model it was compiled with (Model.compile, which shards "
                "the model's states); outside one the states would stay "
                "replicated")
        return self._mean(list(self.grad_reduce_stream(pairs, wire=wire)))

    def _decline_zero(self, driver):
        """ZeRO/FSDP under a specialised driver is refused, not warned:
        these drivers keep their own per-gradient reduction and replicated
        optimizer states, so a sharded step would silently not be one. The
        plain driver (``model(x, y)``) runs it."""
        from .parallel.gspmd import ShardingDecline, active_layout
        if not self.zero and active_layout() is None:
            return
        raise ShardingDecline(
            f"DistOpt(zero=True) (or compile(fsdp_axis=)) cannot run the "
            f"{driver} driver: it keeps replicated optimizer states and "
            "per-gradient collectives, so the requested ZeRO sharding "
            "would silently not happen. Use the plain driver or construct "
            "the DistOpt without zero=True")

    def _update(self, pairs):
        """Update through the wrapped optimizer with the averaged
        gradients, advance the step counter."""
        self.opt.update_params(pairs)
        self.opt.step()

    # -- bucketed gradient reduction --------------------------------------
    @staticmethod
    def _wire_cast_back(arr, orig_dtype, wire):
        """A gradient cast to a 16-bit wire comes back f32; one already in
        the wire dtype (or reduced without a wire) keeps its dtype."""
        if wire is not None and orig_dtype != wire:
            return arr.float()
        return arr

    def _buckets(self, pairs, wire):
        """``((skipped axes, wire dtype), members)`` in the order their
        collectives start: each gradient alone without ``bucket_mb``; else
        a bucket per key as soon as its bytes reach the target, the partly
        filled ones at the end in the order they were opened. Gradients
        that skip different axes never share a collective."""
        if not self.bucket_mb:
            for p, g in pairs:
                yield (self._shard_axes(p), wire if wire is not None
                       else g.data.dtype), [(p, g)]
            return
        target = int(self.bucket_mb * (1 << 20))
        buckets = {}          # (skipped axes, wire dtype) -> [members, bytes]
        for p, g in pairs:
            eff = wire if wire is not None else g.data.dtype
            key = (self._shard_axes(p), eff)
            slot = buckets.setdefault(key, [[], 0])
            slot[0].append((p, g))
            slot[1] += g.data.numel() * eff.itemsize
            if slot[1] >= target:
                yield key, buckets.pop(key)[0]
        for key, (items, _n) in buckets.items():
            yield key, items

    def _flush_bucket(self, key, items):
        """Start one bucket's collective (``async_op=True``) over the reduce
        axes but the bucket's skipped ones: its members' gradients cast to
        the key's wire dtype and concatenated (a lone member is reduced as
        it is). Returns each member with its view of the reduced buffer, to
        be read after :meth:`Communicator.wait`."""
        exclude, eff = key
        casts = [g.data if g.data.dtype == eff else g.data.to(eff)
                 for _p, g in items]
        if len(items) == 1:
            buf = casts[0].contiguous()
            self.all_reduce(buf, exclude=exclude, async_op=True)
            return [(items[0][0], items[0][1], buf)]
        buf = torch.cat([c.reshape(-1) for c in casts])
        self.all_reduce(buf, exclude=exclude, async_op=True)
        out, off = [], 0
        for (p, g), c in zip(items, casts):
            out.append((p, g, buf[off:off + c.numel()].view(c.shape)))
            off += c.numel()
        return out

    def grad_reduce_stream(self, pairs, wire=None):
        """Backward's ``(param, grad)`` pairs with each ``grad.data``
        SUMMED over the ranks (the average is the caller's): the one
        reduction the plain and the guarded drivers share, so the
        bucketing, overlap and wire-cast rules cannot differ between them.
        ``wire`` defaults to the active policy's; a gradient cast to it
        comes back f32, bucketed or not (:meth:`all_reduce_wire`'s rule),
        so bucketed and per-gradient reduction give the same numbers."""
        if wire is None:
            wire = self._policy_wire()
        started = []
        for key, items in self._buckets(pairs, wire):
            started += self._flush_bucket(key, items)
            if not self.overlap:
                self.communicator.wait()
        self.communicator.wait()
        for p, g, red in started:
            g.data = self._wire_cast_back(red, g.data.dtype, wire)
            yield p, g

    def _warn_driver_skips_bucketing(self, driver):
        """The half, partial and sparse drivers reduce per gradient: a
        ``bucket_mb``/``overlap`` setting has no effect there, so say so,
        once per driver."""
        if (not self.bucket_mb and self.overlap) or \
                driver in self._bucket_warned:
            return
        self._bucket_warned.add(driver)
        import warnings
        warnings.warn(
            f"DistOpt(bucket_mb={self.bucket_mb}, overlap={self.overlap}) "
            f"has no effect on {driver}: only the plain and guarded "
            "drivers ride grad_reduce_stream; this driver streams "
            "per-gradient collectives", stacklevel=3)

    # -- training drivers -------------------------------------------------
    def backward_and_update(self, loss, threshold=2097152):
        """Sum every gradient over the ranks (:meth:`grad_reduce_stream`:
        per gradient, or in buckets; on the policy's 16-bit wire under a
        16-bit compute policy), average, update (reference
        ``opt.py:826-865``)."""
        self._update(self.reduced_mean(autograd_base.backward(loss)))

    @classmethod
    def _half_wire_defaults(cls, dtype, clipping):
        """An explicit ``dtype`` keeps the caller's choices; None takes the
        active policy's wire (else bfloat16), and a policy's fp16 wire
        turns clipping on (fp16 overflows above 65504 and this driver runs
        unguarded)."""
        if dtype is not None:
            return dtype, clipping
        wire_pol = cls._policy_wire()
        if wire_pol == torch.float16:
            return "float16", True
        return wire_pol or "bfloat16", clipping

    def backward_and_update_half(self, loss, threshold=2097152,
                                 clipping=False, clip_value=2.5,
                                 dtype=None):
        """Reduced-precision communication: each gradient (clipped to
        ``+-clip_value`` with ``clipping``) cast to ``dtype`` --
        ``"bfloat16"`` or ``"float16"`` -- summed on that wire and cast
        back to f32 (reference ``synchHalf``,
        ``src/io/communicator.cc:262-299``)."""
        self._decline_zero("backward_and_update_half")
        self._warn_driver_skips_bucketing("backward_and_update_half")
        dtype, clipping = self._half_wire_defaults(dtype, clipping)
        wire = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                torch.bfloat16: torch.bfloat16,
                torch.float16: torch.float16}.get(dtype)
        if wire is None:
            raise ValueError(
                f"dtype must be 'bfloat16' or 'float16', got {dtype!r}")
        pairs = []
        for p, g in autograd_base.backward(loss):
            grad = g.data
            if clipping:
                grad = torch.clamp(grad, -clip_value, clip_value)
            g.data = self.all_reduce(grad.to(wire),
                                     exclude=self._shard_axes(p)).float()
            pairs.append((p, g))
        self._update(self._mean(pairs))

    def backward_and_partial_update(self, loss, threshold=2097152,
                                    rotation=None):
        """Partial synchronisation (reference ``opt.py:922-992``): each
        step only the parameters ``i`` with ``i % world == rotation`` take
        the averaged gradient, the rest their local one.

        A static ``rotation`` (a python int, normally ``step % world``)
        runs collectives for its partition only, one graph per value in
        graph mode. ``rotation=None`` selects on the device step counter
        (``(step + i) % world == 0``): one graph that keeps rotating, but
        every gradient is reduced and only the update is masked."""
        self._decline_zero("backward_and_partial_update")
        self._warn_driver_skips_bucketing("backward_and_partial_update")
        n = max(1, self.communicator.effective_world_size())
        pairs = list(autograd_base.backward(loss))
        if rotation is not None:
            rot = int(rotation) % n
            chosen = [(p, g) for i, (p, g) in enumerate(pairs)
                      if i % n == rot]
            for p, g in chosen:
                g.data = self.all_reduce(g.data,
                                         exclude=self._shard_axes(p))
            self._mean(chosen)
        else:
            step = self.opt.step_counter.data
            for i, (p, g) in enumerate(pairs):
                summed = self.all_reduce(g.data.clone(),
                                         exclude=self._shard_axes(p))
                sel = torch.remainder(step + i, n) == 0
                g.data = torch.where(sel, summed / n, g.data)
        self.opt.update_params(pairs)
        self.opt.step()

    def backward_and_sparse_update(self, loss, spars=0.05, topK=False,
                                   corr=True):
        """Gradient sparsification with error feedback (reference
        ``opt.py:994+``, ``Communicator::sparsification``): each gradient
        plus its residual keeps the entries with ``|g| >= spars``
        (``topK=False``) or its ``spars`` share of largest ``|g|``
        (``torch.topk``; the entries tied with the k-th are kept too), the
        rest becomes the next residual (``corr``), and the kept entries
        are summed over the ranks as a dense tensor and averaged."""
        self._decline_zero("backward_and_sparse_update")
        self._warn_driver_skips_bucketing("backward_and_sparse_update")
        pairs = []
        for p, g in autograd_base.backward(loss):
            name = p.name or f"param/{id(p)}"
            grad = g.data
            if corr:
                res = self._residuals.get(name)
                if res is None:
                    res = self._residuals[name] = Tensor(
                        shape=p.shape, device=p.device,
                        name=f"residual/{name}")
                grad = grad + res.data
            absg = grad.abs()
            if topK:
                k = max(1, int(spars * grad.numel()))
                thresh = torch.topk(absg.reshape(-1), k).values[-1]
                mask = absg >= thresh
            else:
                mask = absg >= spars
            sparse = torch.where(mask, grad, 0.0)
            if corr:
                res.data.copy_(grad - sparse)
            g.data = self.all_reduce(sparse, exclude=self._shard_axes(p))
            pairs.append((p, g))
        self._update(self._mean(pairs))
