"""Fused optimizer updates: one pass over each parameter, in place --
kernels K1 (SGD momentum), K5 (Adam), K6 (RMSProp) and K7 (AdaGrad) of the
port.

Counterpart of ``singa_tpu/ops/fused_optim.py``. Each update reads the
gradient, the parameter and its state once and writes the parameter and
the state once, in place:

- :func:`sgd_momentum_update` -- momentum, dampening, weight decay,
  nesterov (K1);
- :func:`adam_update` -- Adam without amsgrad; the caller passes the bias
  corrections ``1 - beta**t`` (K5);
- :func:`rmsprop_update` -- the new mean square is stored, then read back
  for the step (K6);
- :func:`adagrad_update` -- the new history is stored, then read back
  (K7).

Each wrapper takes the JAX signature and returns the updated ``(p, m[,
v])``, which are the tensors passed in, updated in place. ``lr`` (and
Adam's bias corrections) may be 0-d f32 tensors on the parameter's device,
as the optimizers pass them, so a learning-rate schedule costs no host
sync; a Python number is placed on the device first.

Each has a plain PyTorch version beside it (``*_reference``), one rounded
elementwise op at a time in the reference's order. A wrapper uses the
plain version only for a tensor on the CPU. A CUDA tensor always goes to
the hand-written kernel in ``csrc/fused_optim.cu`` (built at first use by
:mod:`..cuda_build`) or raises: no fallback and no size gate (the JAX
package's ``MIN_FUSED_ELEMS`` is a TPU launch-cost gate and is not carried
over). ``launches`` counts kernel launches by kernel.

The kernel writes through raw pointers, which PyTorch's version counter
does not see. Each launch therefore bumps the version of every tensor it
wrote (``torch.autograd.graph.increment_version``): the serving path keeps
each BN's folded ``(s, b)`` until a BN state's version moves
(``ops/fused_epilogue.py``), and a fused step that updates a BN scale must
invalidate that fold.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches, by kernel (only where the CUDA kernel runs)
launches = {"sgd": 0, "adam": 0, "rmsprop": 0, "adagrad": 0}

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_counts():
    """Zero the launch counters."""
    for k in launches:
        launches[k] = 0


def _scalar(x, like):
    """A 0-d f32 tensor on ``like``'s device: ``x`` itself when it already
    is one, else ``x`` placed there."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 0 and x.dtype == torch.float32 and \
                x.device == like.device:
            return x
        return x.reshape(()).to(device=like.device, dtype=torch.float32)
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


# -- plain PyTorch versions --------------------------------------------------
# Each runs the reference's arithmetic one rounded f32 op at a time (no
# op fuses a multiply into an add), in the order of the Pallas kernel
# body, then stores into p and the state in place.

def _grad32(p32, g, p_dtype, weight_decay):
    """The gradient cast to p's dtype (as opt.py does), in f32, plus the
    weight-decay term."""
    g32 = g.to(p_dtype).float()
    return g32 + p32 * weight_decay if weight_decay else g32


@torch.no_grad()
def sgd_momentum_update_reference(p, g, m, lr, *, momentum, dampening=0.0,
                                  weight_decay=0.0, nesterov=False):
    """Plain version of :func:`sgd_momentum_update`."""
    lr = _scalar(lr, p)
    p32 = p.float()
    g32 = _grad32(p32, g, p.dtype, weight_decay)
    m_new = m.float() * momentum + g32 * (1.0 - dampening)
    upd = g32 + m_new * momentum if nesterov else m_new
    p.copy_((p32 - lr * upd).to(p.dtype))
    m.copy_(m_new.to(m.dtype))
    return p, m


@torch.no_grad()
def adam_update_reference(p, g, m, v, lr, bias_corr1, bias_corr2, *, beta_1,
                          beta_2, epsilon, weight_decay=0.0):
    """Plain version of :func:`adam_update`."""
    lr, bc1, bc2 = (_scalar(s, p) for s in (lr, bias_corr1, bias_corr2))
    p32 = p.float()
    g32 = _grad32(p32, g, p.dtype, weight_decay)
    m_new = m.float() * beta_1 + g32 * (1.0 - beta_1)
    v_new = v.float() * beta_2 + g32 * (1.0 - beta_2) * g32
    mhat = m_new / bc1
    vhat = v_new / bc2
    p.copy_((p32 - lr * mhat / (torch.sqrt(vhat) + epsilon)).to(p.dtype))
    m.copy_(m_new.to(m.dtype))
    v.copy_(v_new.to(v.dtype))
    return p, m, v


@torch.no_grad()
def rmsprop_update_reference(p, g, r, lr, *, rho, epsilon, weight_decay=0.0):
    """Plain version of :func:`rmsprop_update`: the new mean square is
    stored in r's dtype and the stored value is read back for the step."""
    lr = _scalar(lr, p)
    p32 = p.float()
    g32 = _grad32(p32, g, p.dtype, weight_decay)
    r.copy_((r.float() * rho + g32 * (1.0 - rho) * g32).to(r.dtype))
    p.copy_((p32 - lr * g32 / torch.sqrt(r.float() + epsilon)).to(p.dtype))
    return p, r


@torch.no_grad()
def adagrad_update_reference(p, g, h, lr, *, epsilon, weight_decay=0.0):
    """Plain version of :func:`adagrad_update`: the new history is stored
    in h's dtype and the stored value is read back for the step."""
    lr = _scalar(lr, p)
    p32 = p.float()
    g32 = _grad32(p32, g, p.dtype, weight_decay)
    h.copy_((h.float() + g32 * g32).to(h.dtype))
    p.copy_((p32 - lr * g32 / torch.sqrt(h.float() + epsilon)).to(p.dtype))
    return p, h


# -- the CUDA kernels --------------------------------------------------------

_SIGNATURES = {
    # name: (C function, pointer args after the two dtype codes, float args)
    "sgd": ("singa_sgd_update", 4, 3),
    "adam": ("singa_adam_update", 7, 6),
    "rmsprop": ("singa_rmsprop_update", 4, 4),
    "adagrad": ("singa_adagrad_update", 4, 2),
}


def _function(kind):
    from .. import cuda_build
    name, n_ptr, n_float = _SIGNATURES[kind]
    fn = getattr(cuda_build.load("fused_optim"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] + \
            [ctypes.c_float] * n_float + \
            ([ctypes.c_int] if kind == "sgd" else []) + [ctypes.c_void_p]
    return fn


def _check(p, g, states):
    if p.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the optimizer kernels take f32, bf16 or f16 "
                        f"parameters, got {p.dtype}")
    sdt = states[0].dtype
    for name, t in [("g", g)] + [(f"state {i}", s)
                                 for i, s in enumerate(states)]:
        if tuple(t.shape) != tuple(p.shape) or t.device != p.device or \
                not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous tensor of p's shape "
                f"{tuple(p.shape)} on {p.device}; got {tuple(t.shape)} "
                f"on {t.device}")
    if not p.is_contiguous():
        raise ValueError(f"p must be contiguous; got strides {p.stride()}")
    if sdt not in _KERNEL_DTYPES or any(s.dtype != sdt for s in states):
        raise TypeError(f"the optimizer states must share one of f32, bf16 "
                        f"or f16; got {[s.dtype for s in states]}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _run(kind, args, written):
    """Launch kernel ``kind`` with ``args`` on the current stream, raise on
    a CUDA error, count the launch, and bump the version of every tensor
    in ``written``: the kernel stores through raw pointers, which the
    version counter does not see."""
    err = _function(kind)(*args, _stream(written[0].device))
    if err != 0:
        raise RuntimeError(f"fused {kind} kernel launch failed: CUDA error "
                           f"{err}")
    launches[kind] += 1
    for t in written:
        torch.autograd.graph.increment_version(t)


def _prepare(p, g, states, scalars):
    """The contiguous gradient in p's dtype (opt.py casts it first), and
    the device scalars, checked for the kernel."""
    g = g.to(p.dtype).contiguous()
    scalars = [_scalar(s, p) for s in scalars]
    _check(p, g, states)
    return g, scalars


def _device_kind(p):
    if p.device.type == "cpu":
        return "cpu"
    if p.device.type != "cuda":
        raise RuntimeError(f"no optimizer kernel for device {p.device}")
    return "cuda"


def sgd_momentum_update(p, g, m, lr, *, momentum, dampening=0.0,
                        weight_decay=0.0, nesterov=False):
    """Fused ``opt.SGD`` momentum update of ``p`` and its momentum ``m``,
    in place; returns ``(p, m)``. The CUDA kernel K1 on the card, the
    plain version on the CPU."""
    if _device_kind(p) == "cpu":
        return sgd_momentum_update_reference(
            p, g, m, lr, momentum=momentum, dampening=dampening,
            weight_decay=weight_decay, nesterov=nesterov)
    g, (lr,) = _prepare(p, g, [m], [lr])
    if p.numel():
        _run("sgd",
             (_KERNEL_DTYPES[p.dtype], _KERNEL_DTYPES[m.dtype],
              p.data_ptr(), g.data_ptr(), m.data_ptr(), lr.data_ptr(),
              p.numel(), float(momentum), float(1.0 - dampening),
              float(weight_decay), int(bool(nesterov))), (p, m))
    return p, m


def adam_update(p, g, m, v, lr, bias_corr1, bias_corr2, *, beta_1, beta_2,
                epsilon, weight_decay=0.0):
    """Fused ``opt.Adam`` update (no amsgrad) of ``p`` and its moments
    ``m``, ``v``, in place; returns ``(p, m, v)``. ``bias_corr1/2`` are
    ``1 - beta**t``, computed by the caller."""
    if _device_kind(p) == "cpu":
        return adam_update_reference(
            p, g, m, v, lr, bias_corr1, bias_corr2, beta_1=beta_1,
            beta_2=beta_2, epsilon=epsilon, weight_decay=weight_decay)
    g, (lr, bc1, bc2) = _prepare(p, g, [m, v], [lr, bias_corr1, bias_corr2])
    if p.numel():
        _run("adam",
             (_KERNEL_DTYPES[p.dtype], _KERNEL_DTYPES[m.dtype],
              p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
              lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), p.numel(),
              float(beta_1), float(1.0 - beta_1), float(beta_2),
              float(1.0 - beta_2), float(epsilon), float(weight_decay)),
             (p, m, v))
    return p, m, v


def rmsprop_update(p, g, r, lr, *, rho, epsilon, weight_decay=0.0):
    """Fused ``opt.RMSProp`` update of ``p`` and its mean square ``r``, in
    place; returns ``(p, r)``."""
    if _device_kind(p) == "cpu":
        return rmsprop_update_reference(p, g, r, lr, rho=rho,
                                        epsilon=epsilon,
                                        weight_decay=weight_decay)
    g, (lr,) = _prepare(p, g, [r], [lr])
    if p.numel():
        _run("rmsprop",
             (_KERNEL_DTYPES[p.dtype], _KERNEL_DTYPES[r.dtype],
              p.data_ptr(), g.data_ptr(), r.data_ptr(), lr.data_ptr(),
              p.numel(), float(rho), float(1.0 - rho), float(epsilon),
              float(weight_decay)), (p, r))
    return p, r


def adagrad_update(p, g, h, lr, *, epsilon, weight_decay=0.0):
    """Fused ``opt.AdaGrad`` update of ``p`` and its history ``h``, in
    place; returns ``(p, h)``."""
    if _device_kind(p) == "cpu":
        return adagrad_update_reference(p, g, h, lr, epsilon=epsilon,
                                        weight_decay=weight_decay)
    g, (lr,) = _prepare(p, g, [h], [lr])
    if p.numel():
        _run("adagrad",
             (_KERNEL_DTYPES[p.dtype], _KERNEL_DTYPES[h.dtype],
              p.data_ptr(), g.data_ptr(), h.data_ptr(), lr.data_ptr(),
              p.numel(), float(epsilon), float(weight_decay)), (p, h))
    return p, h
