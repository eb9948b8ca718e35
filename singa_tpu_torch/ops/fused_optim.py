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
  (K7);
- :func:`sgd_momentum_update_multi`, :func:`adam_update_multi`,
  :func:`rmsprop_update_multi`, :func:`adagrad_update_multi` -- K1, K5,
  K6 and K7 over many parameters at once, each with its own lr and
  weight decay: on the card one launch per chunk of up to
  ``MULTI_CAPACITY`` tensors (the table travels as the kernel's
  parameter), so a whole ResNet-50 step is 2 (K1, K6, K7) or 3 (K5)
  launches in place of 161. ``opt.SGD/Adam/RMSProp/AdaGrad(fused=True)``
  update a step's eligible parameters this way; ``Optimizer.apply`` keeps
  the per-tensor wrappers.

The multi-tensor wrappers and their plain versions take ``ok``, a guarded
step's verdict (``resilience.GuardedOptimizer``): a 0-d f32 tensor on the
parameters' device, 1 on a good step and 0 on a bad one, or None. Where it
is 0 the update writes nothing: the kernel's blocks read the flag through
its pointer and return, and the plain and CPU paths put every tensor they
wrote back, ``torch.where(ok, new, old)`` as the reference masks a step.
The host never reads the flag. The per-tensor wrappers take no flag.

Each per-tensor wrapper takes the JAX signature and returns the updated
``(p, m[, v])``, which are the tensors passed in, updated in place. ``lr`` (and
Adam's bias corrections) may be 0-d f32 tensors on the parameter's device,
as the optimizers pass them, so a learning-rate schedule costs no host
sync; a Python number is placed on the device first.

Each has a plain PyTorch version beside it (``*_reference``), one rounded
elementwise op at a time in the reference's order. A wrapper uses the
plain version only for a tensor on the CPU. A CUDA tensor always goes to
the hand-written kernel in ``csrc/fused_optim.cu`` (built at first use by
:mod:`..cuda_build`) or raises: no fallback and no size gate (the JAX
package's ``MIN_FUSED_ELEMS`` is a TPU launch-cost gate and is not carried
over). ``launches`` counts kernel launches by kernel: ``"sgd"``,
``"adam"``, ``"rmsprop"`` and ``"adagrad"`` per-tensor launches, the same
names with ``"_multi"`` multi-tensor ones. On the CPU a multi-tensor
wrapper calls the per-tensor wrapper of this module for each entry
(looked up when called), so it counts no launch either.

The kernel writes through raw pointers, which PyTorch's version counter
does not see. Each launch therefore bumps the version of every tensor it
wrote (``torch.autograd.graph.increment_version``): the serving path keeps
each BN's folded ``(s, b)`` until a BN state's version moves
(``ops/fused_epilogue.py``), and a fused step that updates a BN scale must
invalidate that fold.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# kernel launches, by kernel (only where the CUDA kernel runs)
launches = {"sgd": 0, "adam": 0, "rmsprop": 0, "adagrad": 0,
            "sgd_multi": 0, "adam_multi": 0, "rmsprop_multi": 0,
            "adagrad_multi": 0}

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

_VP, _INT, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)


class _SgdEntry(ctypes.Structure):
    """``SingaSgdEntry`` of ``csrc/fused_optim.cu``: one tensor of a
    multi-tensor K1, K6 or K7 launch (``m`` its one state)."""
    _fields_ = [("p", _VP), ("g", _VP), ("m", _VP), ("lr", _VP),
                ("n", _LL), ("weight_decay", _F)]


class _AdamEntry(ctypes.Structure):
    """``SingaAdamEntry``: one tensor of a multi-tensor K5 launch."""
    _fields_ = [("p", _VP), ("g", _VP), ("m", _VP), ("v", _VP),
                ("lr", _VP), ("n", _LL), ("weight_decay", _F)]


# a chunk's table is built as a numpy array of these structs: one
# conversion of a list of tuples, cheaper than filling a ctypes array
_ENTRIES = {"sgd_multi": _SgdEntry, "adam_multi": _AdamEntry,
            "rmsprop_multi": _SgdEntry, "adagrad_multi": _SgdEntry}
_ROWS = {kind: np.dtype(entry) for kind, entry in _ENTRIES.items()}

# entries per multi-tensor launch: as many as fit the kernel's 4 KB
# parameter table (SGD_MULTI_MAX for the one-state kernels, ADAM_MULTI_MAX
# in the source, checked against the library when it loads)
MULTI_CAPACITY = {"sgd_multi": 83, "adam_multi": 70, "rmsprop_multi": 83,
                  "adagrad_multi": 83}
# the kind code singa_optim_multi_capacity takes for each
_CAPACITY_CODE = {"sgd_multi": 0, "adam_multi": 1, "rmsprop_multi": 2,
                  "adagrad_multi": 3}

_SIGNATURES = {
    # name: (C function, argument types after the two dtype codes)
    "sgd": ("singa_sgd_update", [_VP] * 4 + [_LL] + [_F] * 3 + [_INT, _VP]),
    "adam": ("singa_adam_update", [_VP] * 7 + [_LL] + [_F] * 6 + [_VP]),
    "rmsprop": ("singa_rmsprop_update", [_VP] * 4 + [_LL] + [_F] * 4 + [_VP]),
    "adagrad": ("singa_adagrad_update", [_VP] * 4 + [_LL] + [_F] * 2
                + [_VP]),
    # the multi-tensor ones end with the skip flag's pointer and the stream
    "sgd_multi": ("singa_sgd_update_multi", [
        ctypes.POINTER(_SgdEntry), _INT, _F, _F, _INT, _VP, _VP]),
    "adam_multi": ("singa_adam_update_multi", [
        ctypes.POINTER(_AdamEntry), _INT, _VP, _VP] + [_F] * 5
        + [_VP, _VP]),
    "rmsprop_multi": ("singa_rmsprop_update_multi", [
        ctypes.POINTER(_SgdEntry), _INT] + [_F] * 3 + [_VP, _VP]),
    "adagrad_multi": ("singa_adagrad_update_multi", [
        ctypes.POINTER(_SgdEntry), _INT, _F, _VP, _VP]),
}


def _function(kind):
    from .. import cuda_build
    name, argtypes = _SIGNATURES[kind]
    lib = cuda_build.load("fused_optim")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        if kind in MULTI_CAPACITY:
            cap = lib.singa_optim_multi_capacity(_CAPACITY_CODE[kind])
            if cap != MULTI_CAPACITY[kind]:
                raise RuntimeError(
                    f"{name} takes {cap} entries per launch, the wrapper "
                    f"{MULTI_CAPACITY[kind]}: csrc/fused_optim.cu and "
                    "ops/fused_optim.py disagree")
        fn.restype = ctypes.c_int
        fn.argtypes = [_INT, _INT] + argtypes
    return fn


def _check(p, g, states):
    """Raise unless the kernels take ``p``, ``g`` (in p's dtype) and the
    states: f32, bf16 or f16, contiguous, of p's shape, on p's device, the
    states of one dtype. Kept to cheap attribute reads: the multi-tensor
    wrappers run it for every parameter of every step."""
    if p.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the optimizer kernels take f32, bf16 or f16 "
                        f"parameters, got {p.dtype}")
    if not p.is_contiguous():
        raise ValueError(f"p must be contiguous; got strides {p.stride()}")
    shape, dev = p.shape, p.get_device()
    sdt = states[0].dtype
    for i, t in enumerate((g, *states)):
        if t.shape != shape or t.get_device() != dev or \
                not t.is_contiguous():
            name = f"state {i - 1}" if i else "g"
            raise ValueError(
                f"{name} must be a contiguous tensor of p's shape "
                f"{tuple(shape)} on {p.device}; got {tuple(t.shape)} "
                f"on {t.device}")
        if i and t.dtype != sdt:
            sdt = None
    if sdt not in _KERNEL_DTYPES:
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


# -- multi-tensor updates: K1, K5, K6, K7 over many parameters in few launches

@torch.no_grad()
def _masked(entries, n_states, ok, update):
    """``update()``, then, where ``ok`` is 0, every parameter and state of
    ``entries`` put back as it was (``torch.where(ok, new, old)``); just
    ``update()`` when ``ok`` is None."""
    if ok is None:
        update()
        return
    written = [t for e in entries for t in (e[0], *e[2:2 + n_states])]
    old = [t.clone() for t in written]
    update()
    keep = _scalar(ok, written[0]) != 0
    for t, was in zip(written, old):
        t.copy_(torch.where(keep, t, was))


def sgd_momentum_update_multi_reference(entries, *, momentum, dampening=0.0,
                                        nesterov=False, ok=None):
    """Plain version of :func:`sgd_momentum_update_multi`: the plain
    per-tensor update of each entry in turn, masked by ``ok``."""
    def update():
        for p, g, m, lr, wd in entries:
            sgd_momentum_update_reference(
                p, g, m, lr, momentum=momentum, dampening=dampening,
                weight_decay=wd, nesterov=nesterov)
    _masked(entries, 1, ok, update)


def adam_update_multi_reference(entries, bias_corr1, bias_corr2, *, beta_1,
                                beta_2, epsilon, ok=None):
    """Plain version of :func:`adam_update_multi`."""
    def update():
        for p, g, m, v, lr, wd in entries:
            adam_update_reference(p, g, m, v, lr, bias_corr1, bias_corr2,
                                  beta_1=beta_1, beta_2=beta_2,
                                  epsilon=epsilon, weight_decay=wd)
    _masked(entries, 2, ok, update)


def rmsprop_update_multi_reference(entries, *, rho, epsilon, ok=None):
    """Plain version of :func:`rmsprop_update_multi`."""
    def update():
        for p, g, r, lr, wd in entries:
            rmsprop_update_reference(p, g, r, lr, rho=rho, epsilon=epsilon,
                                     weight_decay=wd)
    _masked(entries, 1, ok, update)


def adagrad_update_multi_reference(entries, *, epsilon, ok=None):
    """Plain version of :func:`adagrad_update_multi`."""
    def update():
        for p, g, h, lr, wd in entries:
            adagrad_update_reference(p, g, h, lr, epsilon=epsilon,
                                     weight_decay=wd)
    _masked(entries, 1, ok, update)


def _on_cpu(entries):
    """Whether the entries lie on the CPU; raises unless all of them lie
    on the first one's device."""
    dev = entries[0][0].device
    for e in entries:
        if e[0].device != dev:
            raise ValueError(f"one multi-tensor update takes parameters on "
                             f"one device; got {dev} and {e[0].device}")
    return _device_kind(entries[0][0]) == "cpu"


def _run_multi(kind, entries, n_states, args, ok=None):
    """Launch multi-tensor kernel ``kind`` over ``entries`` (``(p, g,
    *states, lr, weight_decay)`` each): every entry checked as the
    per-tensor wrappers check it, grouped by (p, state) dtype pair, each
    group in chunks of ``MULTI_CAPACITY[kind]``, one launch per chunk
    with ``args`` and the skip flag ``ok`` (a pointer, or null) between
    the table and the stream. Counts each launch and bumps the version of
    every tensor it may have written: a launch that the flag skips counts
    as one that wrote, since the host does not know which it was."""
    groups, lrs = {}, {}
    for e in entries:
        p, g, states, lr = e[0], e[1], e[2:2 + n_states], e[-2]
        if g.dtype != p.dtype:
            g = g.to(p.dtype)
        if not g.is_contiguous():
            g = g.contiguous()
        _check(p, g, states)
        n = p.numel()
        if not n:
            continue
        lr_t = lrs.get(id(lr))
        if lr_t is None:
            lr_t = lrs[id(lr)] = _scalar(lr, p)
        groups.setdefault((p.dtype, states[0].dtype), []).append(
            (p, g, states, lr_t, n, float(e[-1])))
    if not groups:
        return
    fn = _function(kind)
    stream = _stream(entries[0][0].device)
    ok_t = None if ok is None else _scalar(ok, entries[0][0])
    ok_ptr = None if ok_t is None else ok_t.data_ptr()
    cap, entry = MULTI_CAPACITY[kind], ctypes.POINTER(_ENTRIES[kind])
    for (p_dtype, s_dtype), group in groups.items():
        for i in range(0, len(group), cap):
            chunk = group[i:i + cap]
            rows = np.array([
                (p.data_ptr(), g.data_ptr(), *[s.data_ptr() for s in states],
                 lr.data_ptr(), n, wd)
                for p, g, states, lr, n, wd in chunk], dtype=_ROWS[kind])
            err = fn(_KERNEL_DTYPES[p_dtype], _KERNEL_DTYPES[s_dtype],
                     rows.ctypes.data_as(entry), len(chunk), *args, ok_ptr,
                     stream)
            if err != 0:
                raise RuntimeError(f"fused {kind} kernel launch failed: CUDA "
                                   f"error {err}")
            launches[kind] += 1
            torch.autograd.graph.increment_version(
                [t for p, _, states, _, _, _ in chunk for t in (p, *states)])


def sgd_momentum_update_multi(entries, *, momentum, dampening=0.0,
                              nesterov=False, ok=None):
    """Fused ``opt.SGD`` momentum update of many parameters, in place.
    ``entries`` holds one ``(p, g, m, lr, weight_decay)`` per parameter:
    the parameter, its gradient, its momentum, its own learning rate (a
    0-d f32 tensor on its device, or a number) and its own weight decay;
    the other hyperparameters are shared. On the card, kernel K1's
    multi-tensor launch: one per chunk of ``MULTI_CAPACITY["sgd_multi"]``
    entries of one (p, m) dtype pair, bitwise-equal to one
    :func:`sgd_momentum_update` per entry. On the CPU,
    :func:`sgd_momentum_update` for each entry. ``ok``: the skip flag
    (module doc)."""
    if not entries:
        return
    if _on_cpu(entries):
        def update():
            for p, g, m, lr, wd in entries:
                sgd_momentum_update(p, g, m, lr, momentum=momentum,
                                    dampening=dampening, weight_decay=wd,
                                    nesterov=nesterov)
        _masked(entries, 1, ok, update)
        return
    _run_multi("sgd_multi", entries, 1,
               (float(momentum), float(1.0 - dampening),
                int(bool(nesterov))), ok)


def adam_update_multi(entries, bias_corr1, bias_corr2, *, beta_1, beta_2,
                      epsilon, ok=None):
    """Fused ``opt.Adam`` update (no amsgrad) of many parameters, in
    place. ``entries`` holds one ``(p, g, m, v, lr, weight_decay)`` per
    parameter; ``bias_corr1/2`` (``1 - beta**t``) and the betas are
    shared. On the card, kernel K5's multi-tensor launch, one per chunk of
    ``MULTI_CAPACITY["adam_multi"]`` entries of one dtype pair; on the CPU,
    :func:`adam_update` for each entry. ``ok``: the skip flag."""
    if not entries:
        return
    if _on_cpu(entries):
        def update():
            for p, g, m, v, lr, wd in entries:
                adam_update(p, g, m, v, lr, bias_corr1, bias_corr2,
                            beta_1=beta_1, beta_2=beta_2, epsilon=epsilon,
                            weight_decay=wd)
        _masked(entries, 2, ok, update)
        return
    like = entries[0][0]
    bc1, bc2 = _scalar(bias_corr1, like), _scalar(bias_corr2, like)
    _run_multi("adam_multi", entries, 2,
               (bc1.data_ptr(), bc2.data_ptr(), float(beta_1),
                float(1.0 - beta_1), float(beta_2), float(1.0 - beta_2),
                float(epsilon)), ok)


def rmsprop_update_multi(entries, *, rho, epsilon, ok=None):
    """Fused ``opt.RMSProp`` update of many parameters, in place.
    ``entries`` holds one ``(p, g, r, lr, weight_decay)`` per parameter,
    ``r`` its mean square; rho and epsilon are shared. On the card, kernel
    K6's multi-tensor launch, one per chunk of
    ``MULTI_CAPACITY["rmsprop_multi"]`` entries of one dtype pair,
    bitwise-equal to one :func:`rmsprop_update` per entry; on the CPU,
    :func:`rmsprop_update` for each entry. ``ok``: the skip flag."""
    if not entries:
        return
    if _on_cpu(entries):
        def update():
            for p, g, r, lr, wd in entries:
                rmsprop_update(p, g, r, lr, rho=rho, epsilon=epsilon,
                               weight_decay=wd)
        _masked(entries, 1, ok, update)
        return
    _run_multi("rmsprop_multi", entries, 1,
               (float(rho), float(1.0 - rho), float(epsilon)), ok)


def adagrad_update_multi(entries, *, epsilon, ok=None):
    """Fused ``opt.AdaGrad`` update of many parameters, in place.
    ``entries`` holds one ``(p, g, h, lr, weight_decay)`` per parameter,
    ``h`` its history. On the card, kernel K7's multi-tensor launch, one
    per chunk of ``MULTI_CAPACITY["adagrad_multi"]`` entries of one dtype
    pair; on the CPU, :func:`adagrad_update` for each entry. ``ok``: the
    skip flag."""
    if not entries:
        return
    if _on_cpu(entries):
        def update():
            for p, g, h, lr, wd in entries:
                adagrad_update(p, g, h, lr, epsilon=epsilon, weight_decay=wd)
        _masked(entries, 1, ok, update)
        return
    _run_multi("adagrad_multi", entries, 1, (float(epsilon),), ok)
