"""The multi-tensor launches of kernels K1 and K5
(``singa_tpu_torch/ops/fused_optim.py``: ``sgd_momentum_update_multi``,
``adam_update_multi``) and the optimizer step that drives them
(``opt.SGD/Adam(fused=True)``), on the CPU.

- On the CPU a multi-tensor wrapper runs the per-tensor wrapper, and so
  the plain version, for each entry: held bitwise against a loop of the
  plain versions, and within 2 ULP of the JAX package's Pallas kernels run
  tensor by tensor in interpret mode (XLA's CPU backend contracts their
  multiply-adds into FMAs; see ``test_torch_fused_optim.py``).
- The card's path, with ``_device_kind`` patched to ``"cuda"`` and the C
  function replaced by a fake that reads the table it is given and runs
  the plain version through views of the table's pointers (as the kernel
  writes through them): the table's pointers, sizes, lr pointers and
  weight decays, the chunks and dtype groups, one launch counted per
  chunk, the version of every written tensor, a cached BN fold.
- The optimizer through ``Model.compile`` / ``model(x, y)``: one
  multi-tensor call per step for the eligible parameters, a regularized
  parameter on the plain chain, a parameter with an lr multiplier in the
  table with its own lr; bitwise equal to ``fused=False`` and within the
  JAX package's tolerance (rtol 1e-5 / atol 1e-6, as
  ``test_torch_fused_optim.py`` states).

The kernels themselves are held bitwise against the loop of plain versions
on the card (``test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from singa_tpu import opt as jopt
from singa_tpu.ops import fused_optim as jfo

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import fused_optim as tfo

# the small MLP, its data and start, and the JAX side of its training
from test_torch_fused_optim import (OPTIMIZERS as _ALL_OPTIMIZERS,
                                    _data, _init_states, _mlp, _train_jax)

SHAPES = [(0,), (1,), (3,), (64,), (4099,), (13, 10)]
ULPS = 2
SGD_KW = {"sgd": dict(momentum=0.9),
          "sgd_nesterov": dict(momentum=0.9, nesterov=True),
          "sgd_dampening": dict(momentum=0.8, dampening=0.1)}
ADAM_KW = dict(beta_1=0.9, beta_2=0.999, epsilon=1e-8)
BIAS_CORR = (np.float32(1 - 0.9 ** 4), np.float32(1 - 0.999 ** 4))
TORCH_DTYPES = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


@pytest.fixture(autouse=True)
def _interpret_kernels():
    prev = jfo.FORCE_PALLAS_INTERPRET
    jfo.FORCE_PALLAS_INTERPRET = True
    tfo.reset_counts()
    try:
        yield
    finally:
        jfo.FORCE_PALLAS_INTERPRET = prev
        TCTX.training = False


def _rand(shape, seed, positive=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) if positive else a


def _entries(kind, shapes, p_dtype=torch.float32, s_dtype=torch.float32,
             seed=0):
    """One entry per shape, ``(p, g, m[, v], lr, weight_decay)``: the lr
    alternates between two 0-d tensors and a Python number, the weight
    decay between 0 and two values; g is f32 (the wrapper casts it)."""
    lrs = [torch.tensor(0.05), torch.tensor(0.01), 0.2]
    wds = [0.0, 1e-4, 3e-2]
    n_states = 2 if kind == "adam" else 1
    out = []
    for i, shape in enumerate(shapes):
        s = seed + 10 * i
        p = torch.tensor(_rand(shape, s)).to(p_dtype)
        g = torch.tensor(_rand(shape, s + 1))
        states = [torch.tensor(_rand(shape, s + 2 + j, positive=j == 1))
                  .to(s_dtype) for j in range(n_states)]
        out.append((p, g, *states, lrs[i % 3], wds[i % 3]))
    return out


def _clone(entries):
    return [tuple(t.clone() if isinstance(t, torch.Tensor) and t.dim()
                  else t for t in e) for e in entries]


def _written(e):
    return (e[0],) + tuple(e[2:-2])


def _multi(kind, entries):
    if kind == "adam":
        tfo.adam_update_multi(entries, *map(torch.tensor, BIAS_CORR),
                              **ADAM_KW)
    else:
        tfo.sgd_momentum_update_multi(entries, **SGD_KW[kind])


def _multi_reference(kind, entries):
    if kind == "adam":
        tfo.adam_update_multi_reference(entries, *map(torch.tensor,
                                                      BIAS_CORR), **ADAM_KW)
    else:
        tfo.sgd_momentum_update_multi_reference(entries, **SGD_KW[kind])


# ---------------------------------------------------------------------------
# the CPU path: the per-tensor plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sgd", "sgd_nesterov", "sgd_dampening",
                                  "adam"])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16_param_f32_state"])
def test_multi_on_the_cpu_equals_the_loop_of_plain_versions(kind, p_dtype):
    mine = _entries(kind, SHAPES * 2, p_dtype=p_dtype)
    plain = _clone(mine)
    versions = [[t._version for t in _written(e)] for e in mine]
    _multi(kind, mine)
    _multi_reference(kind, plain)
    for e, want, vs in zip(mine, plain, versions):
        for got, w in zip(_written(e), _written(want)):
            assert got.dtype == w.dtype and torch.equal(got, w)
        if e[0].numel():
            assert all(t._version > v for t, v in zip(_written(e), vs))
    assert sum(tfo.launches.values()) == 0


def test_the_cpu_path_calls_the_per_tensor_wrapper_for_each_entry(
        monkeypatch):
    """Looked up when called, so a spy on ``sgd_momentum_update`` sees
    every entry with its own lr and weight decay."""
    calls = []
    real = tfo.sgd_momentum_update

    def spy(p, g, m, lr, **kw):
        calls.append((p, lr, kw["weight_decay"]))
        return real(p, g, m, lr, **kw)
    monkeypatch.setattr(tfo, "sgd_momentum_update", spy)
    entries = _entries("sgd", SHAPES)
    tfo.sgd_momentum_update_multi(entries, momentum=0.9)
    assert [(id(p), id(lr), wd) for p, lr, wd in calls] == \
        [(id(e[0]), id(e[3]), e[4]) for e in entries]


def test_entries_on_two_devices_raise():
    entries = _entries("sgd", [(4,)])
    meta = tuple(t.to("meta") if isinstance(t, torch.Tensor) and t.dim()
                 else t for t in entries[0])
    with pytest.raises(ValueError, match="one device"):
        tfo.sgd_momentum_update_multi(entries + [meta], momentum=0.9)


@pytest.mark.parametrize("kind", ["sgd", "sgd_nesterov", "sgd_dampening",
                                  "adam"])
def test_multi_matches_the_pallas_kernels_tensor_by_tensor(kind):
    entries = _entries(kind, SHAPES[1:], seed=5)
    want = []
    for e in entries:
        lr = float(e[-2])
        arrays = [jnp.asarray(t.numpy()) for t in e[:-2]]
        if kind == "adam":
            want.append(jfo.adam_update(
                *arrays, jnp.float32(lr), jnp.float32(BIAS_CORR[0]),
                jnp.float32(BIAS_CORR[1]), weight_decay=e[-1], **ADAM_KW))
        else:
            want.append(jfo.sgd_momentum_update(
                *arrays, jnp.float32(lr), weight_decay=e[-1],
                **SGD_KW[kind]))
    _multi(kind, entries)
    for e, w in zip(entries, want):
        for got, ref in zip(_written(e), w):
            ref = np.asarray(ref)
            tol = ULPS * 2.0 ** -23 * max(float(np.abs(ref).max()), 1.0)
            err = float(np.abs(got.numpy() - ref).max())
            assert err <= tol, (kind, tuple(got.shape), err, tol)


# ---------------------------------------------------------------------------
# the card's path, with a fake C function
# ---------------------------------------------------------------------------

def _view(ptr, n, dtype):
    """A 1-D tensor over ``n`` elements at address ``ptr``."""
    size = n * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_uint8 * size).from_address(ptr),
                            dtype=dtype)


def _skipped(ok):
    """Whether the skip flag at address ``ok`` (None: no flag) holds 0,
    as each block of the kernel reads it."""
    return ok is not None and float(_view(ok, 1, torch.float32)[0]) == 0.0


class FakeKernels:
    """Stands in for ``singa_sgd_update_multi`` / ``singa_adam_update_
    multi``: records each call's table and, unless the skip flag holds 0,
    runs the plain version over views of the table's pointers, as the
    kernel writes through them."""

    def __init__(self):
        self.calls = []

    def function(self, kind):
        return {"sgd_multi": self.sgd, "adam_multi": self.adam}[kind]

    def sgd(self, p_dt, s_dt, table, count, momentum, omd, nesterov, ok,
            stream):
        pt, st = TORCH_DTYPES[p_dt], TORCH_DTYPES[s_dt]
        rows = [(e.p, e.g, e.m, e.lr, e.n, e.weight_decay)
                for e in table[:count]]
        self.calls.append(("sgd_multi", (p_dt, s_dt), rows))
        if _skipped(ok):
            return 0
        for p, g, m, lr, n, wd in rows:
            tfo.sgd_momentum_update_reference(
                _view(p, n, pt), _view(g, n, pt), _view(m, n, st),
                _view(lr, 1, torch.float32).reshape(()), momentum=momentum,
                dampening=1.0 - omd, weight_decay=wd,
                nesterov=bool(nesterov))
        return 0

    def adam(self, p_dt, s_dt, table, count, bc1, bc2, b1, omb1, b2, omb2,
             eps, ok, stream):
        pt, st = TORCH_DTYPES[p_dt], TORCH_DTYPES[s_dt]
        rows = [(e.p, e.g, e.m, e.v, e.lr, e.n, e.weight_decay)
                for e in table[:count]]
        self.calls.append(("adam_multi", (p_dt, s_dt), rows))
        if _skipped(ok):
            return 0
        bc = [_view(b, 1, torch.float32).reshape(()) for b in (bc1, bc2)]
        for p, g, m, v, lr, n, wd in rows:
            tfo.adam_update_reference(
                _view(p, n, pt), _view(g, n, pt), _view(m, n, st),
                _view(v, n, st), _view(lr, 1, torch.float32).reshape(()),
                *bc, beta_1=b1, beta_2=b2, epsilon=eps, weight_decay=wd)
        return 0


@pytest.fixture
def fake(monkeypatch):
    kernels = FakeKernels()
    monkeypatch.setattr(tfo, "_device_kind", lambda p: "cuda")
    monkeypatch.setattr(tfo, "_function", kernels.function)
    monkeypatch.setattr(tfo, "_stream", lambda dev: None)
    return kernels


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_the_table_its_chunks_and_the_launch_count(fake, kind):
    """161 entries (ResNet-50's count of parameter tensors, at small
    sizes) with two zero-size ones: one launch per chunk of
    MULTI_CAPACITY, each table holding the entries' pointers, sizes, lr
    pointers and weight decays in order; results bitwise equal to the
    loop of plain versions; every written tensor's version bumped."""
    shapes = [(1 + (7 * i) % 70,) for i in range(159)] + [(0,), (0,)]
    mine = _entries(kind, shapes)
    plain = _clone(mine)
    versions = [[t._version for t in _written(e)] for e in mine]
    _multi(kind, mine)
    _multi_reference(kind, plain)
    key = f"{kind}_multi"
    cap = tfo.MULTI_CAPACITY[key]
    live = [e for e in mine if e[0].numel()]
    chunks = math.ceil(len(live) / cap)
    assert chunks == (2 if kind == "sgd" else 3)
    assert tfo.launches == {**{k: 0 for k in tfo.launches}, key: chunks}
    assert [c[0] for c in fake.calls] == [key] * chunks
    assert [len(c[2]) for c in fake.calls] == \
        [min(cap, len(live) - i * cap) for i in range(chunks)]
    rows = [r for c in fake.calls for r in c[2]]
    lr_ptrs = set()
    for e, r in zip(live, rows):
        tensors = e[:-2]
        assert r[:len(tensors)] == tuple(t.data_ptr() for t in tensors)
        assert r[-2] == e[0].numel()
        assert r[-1] == pytest.approx(e[-1], rel=1e-7)
        lr = e[-2]
        if isinstance(lr, torch.Tensor):
            assert r[len(tensors)] == lr.data_ptr()
        lr_ptrs.add(r[len(tensors)])
    assert len(lr_ptrs) == 3           # two lr tensors and one number
    for e, want, vs in zip(mine, plain, versions):
        for got, w in zip(_written(e), _written(want)):
            assert torch.equal(got, w)
        if e[0].numel():
            assert all(t._version > v for t, v in zip(_written(e), vs))
        else:
            assert [t._version for t in _written(e)] == vs


def test_one_group_per_dtype_pair(fake):
    """f32 and bf16-param/f32-state entries in one call: one launch per
    (p, state) dtype pair, the gradient cast to each parameter's type."""
    mine = _entries("sgd", SHAPES[1:], torch.bfloat16) + \
        _entries("sgd", SHAPES[1:], seed=3)
    plain = _clone(mine)
    tfo.sgd_momentum_update_multi(mine, momentum=0.9, nesterov=True)
    tfo.sgd_momentum_update_multi_reference(plain, momentum=0.9,
                                            nesterov=True)
    assert [c[1] for c in fake.calls] == [(1, 0), (0, 0)]
    assert tfo.launches["sgd_multi"] == 2
    for e, want in zip(mine, plain):
        for got, w in zip(_written(e), _written(want)):
            assert torch.equal(got, w)


def test_the_wrapper_describes_the_kernel_source():
    """The entry structs and the entries per launch are the ones
    ``csrc/fused_optim.cu`` declares (the library is checked against the
    capacities again when it loads on the card)."""
    src = (Path(tfo.__file__).resolve().parents[1] / "csrc"
           / "fused_optim.cu").read_text()
    for key, macro, struct, entry in (
            ("sgd_multi", "SGD_MULTI_MAX", "SingaSgdEntry", tfo._SgdEntry),
            ("adam_multi", "ADAM_MULTI_MAX", "SingaAdamEntry",
             tfo._AdamEntry)):
        cap = re.search(rf"#define {macro} (\d+)", src)
        assert int(cap.group(1)) == tfo.MULTI_CAPACITY[key]
        body = re.search(rf"struct {struct} {{(.*?)}};", src, re.S).group(1)
        fields = re.findall(r"(\w+);", body)
        assert fields == [f for f, _ in entry._fields_]


def test_a_failed_launch_and_a_bad_entry_raise(fake, monkeypatch):
    entries = _entries("sgd", [(8,), (5,)])
    bad = list(entries)
    bad[1] = (bad[1][0], torch.zeros(4)) + bad[1][2:]
    with pytest.raises(ValueError, match="shape"):
        tfo.sgd_momentum_update_multi(bad, momentum=0.9)
    monkeypatch.setattr(tfo, "_function", lambda kind: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfo.sgd_momentum_update_multi(entries, momentum=0.9)
    assert tfo.launches["sgd_multi"] == 0
    ints = (torch.zeros(3, dtype=torch.int32),) * 3 + (0.1, 0.0)
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        tfo.sgd_momentum_update_multi([ints], momentum=0.9)


def test_a_multi_launch_invalidates_a_cached_bn_fold(fake):
    dev = tdevice.create_cpu_device()
    scale = ttensor.Tensor(data=np.ones(16, np.float32) * 1.5, device=dev)
    bias = ttensor.Tensor(data=np.zeros(16, np.float32), device=dev)
    rmean = ttensor.Tensor(data=np.zeros(16, np.float32), device=dev)
    rvar = ttensor.Tensor(data=np.ones(16, np.float32), device=dev)
    s_before, _ = tfe._folded(scale, bias, rmean, rvar, 1e-5)
    g = torch.tensor(_rand((16,), 1))
    m, v = torch.tensor(_rand((16,), 2)), torch.tensor(_rand((16,), 3, True))
    want = scale.data.clone()
    tfo.adam_update_reference(want, g, m.clone(), v.clone(), 0.1,
                              *BIAS_CORR, **ADAM_KW)
    tfo.adam_update_multi([(scale.data, g, m, v, 0.1, 0.0)], *BIAS_CORR,
                          **ADAM_KW)
    assert tfo.launches["adam_multi"] == 1
    assert torch.equal(scale.data, want)
    s_after, _ = tfe._folded(scale, bias, rmean, rvar, 1e-5)
    torch.testing.assert_close(
        s_after, want / torch.sqrt(torch.tensor(1.0 + 1e-5)))


# ---------------------------------------------------------------------------
# the optimizer step on a small model
# ---------------------------------------------------------------------------

OPTIMIZERS = {k: _ALL_OPTIMIZERS[k] for k in ("sgd", "adam")}


def _register(o, pkg):
    """A regularizer on fc1.W (that param keeps the plain chain) and an
    lr multiplier on fc2.b (it rides the table with its own lr)."""
    o.register("MLP.fc1.W", regularizer=pkg.Regularizer("l2", 1e-3))
    o.register("MLP.fc2.b", lr_multiplier=0.5)
    return o


def _train_port(optimizer, steps=5):
    dev = tdevice.create_cpu_device()
    m = _mlp(tlayer, tmodel)
    m.set_optimizer(optimizer)
    xs, ys = _data()
    tx = ttensor.Tensor(data=xs, device=dev)
    ty = ttensor.Tensor(data=ys, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    tmodel.load_numpy_states(m, _init_states(
        sorted((k, tuple(v.shape)) for k, v in m.get_states().items())))
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(steps)]
    states = {k: v.to_numpy() for k, v in m.get_states().items()}
    states.update(m.optimizer.get_states())
    return losses, states, m


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_a_fused_step_is_one_multi_call(fake, kind):
    """5 steps through the card's path (fake kernel): one multi-tensor
    launch per step over the three eligible parameters, none per tensor;
    the regularized fc1.W stays off the table, fc2.b rides it with its own
    lr pointer; the result equals ``fused=False`` bitwise."""
    make = OPTIMIZERS[kind]
    _, got, m = _train_port(_register(make(topt, True), topt))
    key = f"{kind}_multi"
    assert tfo.launches == {**{k: 0 for k in tfo.launches}, key: 5}
    by_ptr = {t.data.data_ptr(): k for k, t in m.get_states().items()}
    for _, _, rows in fake.calls:
        assert sorted(by_ptr[r[0]] for r in rows) == \
            ["MLP.fc1.b", "MLP.fc2.W", "MLP.fc2.b"]
        lr_col = 3 if kind == "sgd" else 4
        lr_of = {by_ptr[r[0]]: r[lr_col] for r in rows}
        assert lr_of["MLP.fc2.b"] != lr_of["MLP.fc1.b"] == \
            lr_of["MLP.fc2.W"]
    _, plain, _ = _train_port(_register(make(topt, False), topt))
    assert sorted(got) == sorted(plain)
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_fused_step_matches_jax_and_the_plain_chain(kind):
    """The real CPU path with the same registrations in both packages:
    bitwise equal to the port's ``fused=False`` chain, and within rtol
    1e-5 / atol 1e-6 of the JAX package's fused optimizer."""
    make = OPTIMIZERS[kind]
    want_losses, want = _train_jax(_register(make(jopt, True), jopt))
    losses, got, _ = _train_port(_register(make(topt, True), topt))
    _, plain, _ = _train_port(_register(make(topt, False), topt))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    assert sorted(got) == sorted(want) == sorted(plain)
    for k in want:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_update_params_and_apply_agree():
    """``update_params`` (one multi call for the eligible parameters) and
    a loop of ``apply`` (per tensor) give the same parameters and states,
    under the same state names."""
    dev = tdevice.create_cpu_device()
    results = []
    for how in ("update_params", "apply"):
        o = topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4, fused=True)
        o.bind(dev)
        params = {f"w{i}": ttensor.Tensor(data=_rand(s, i), device=dev,
                                          name=f"w{i}")
                  for i, s in enumerate(SHAPES[1:])}
        pairs = [(p, ttensor.Tensor(data=_rand(p.shape, 50 + i),
                                    device=dev))
                 for i, p in enumerate(params.values())]
        for _ in range(2):
            if how == "update_params":
                o.update_params(pairs)
            else:
                for p, g in pairs:
                    o.apply(p.name, p, g)
            o.step()
        states = {k: v.to_numpy() for k, v in params.items()}
        states.update(o.get_states())
        results.append(states)
    assert sorted(results[0]) == sorted(results[1])
    for k in results[0]:
        np.testing.assert_array_equal(results[0][k], results[1][k],
                                      err_msg=k)
