"""The multi-tensor launches of kernels K6 (RMSProp) and K7 (AdaGrad)
(``singa_tpu_torch/ops/fused_optim.py``: ``rmsprop_update_multi``,
``adagrad_update_multi``) and the optimizer step that drives them
(``opt.RMSProp/AdaGrad(fused=True)``), on the CPU.

- On the CPU a multi-tensor wrapper runs the per-tensor wrapper, and so
  the plain version, for each entry: held bitwise against a loop of the
  plain versions, and within 2 ULP of the JAX package's Pallas kernels run
  tensor by tensor in interpret mode (XLA's CPU backend contracts their
  multiply-adds into FMAs; see ``test_torch_fused_optim.py``).
- The card's path, with ``_device_kind`` patched to ``"cuda"`` and the C
  function replaced by a fake that reads the table it is given and runs
  the plain version through views of the table's pointers: the table's
  pointers, sizes, lr pointers and weight decays, 2 chunks for 161
  entries, one launch counted per chunk, the version of every written
  tensor, a cached BN fold, a failed launch; the capacity the wrapper
  asks the library for, for each of the four multi-tensor kinds.
- The optimizer through ``Model.compile`` / ``model(x, y)``: one
  multi-tensor call per step, a regularized parameter off the table, a
  parameter with an lr multiplier on it with its own lr; bitwise equal to
  ``fused=False`` and within rtol 1e-5 / atol 1e-6 of the JAX package.

The kernels themselves are held bitwise against the loop of plain versions
on the card (``test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import math
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from singa_tpu import opt as jopt
from singa_tpu.ops import fused_optim as jfo

from singa_tpu_torch import cuda_build
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.ops import fused_epilogue as tfe
from singa_tpu_torch.ops import fused_optim as tfo

# the small MLP of test_torch_fused_optim.py, trained in both packages
from test_torch_fused_optim import OPTIMIZERS as _ALL_OPTIMIZERS, _train_jax
from test_torch_fused_optim_multi import (SHAPES, TORCH_DTYPES, ULPS,
                                          _clone, _register, _skipped,
                                          _train_port, _view, _written)

KINDS = ["rmsprop", "adagrad"]
KW = {"rmsprop": dict(rho=0.9, epsilon=1e-8), "adagrad": dict(epsilon=1e-8)}
WDS = {"no_wd": [0.0], "wd": [0.0, 1e-4, 3e-2]}


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


def _entries(shapes, p_dtype=torch.float32, s_dtype=torch.float32, seed=0,
             wds=WDS["wd"]):
    """One ``(p, g, state, lr, weight_decay)`` per shape: the lr alternates
    between two 0-d tensors and a Python number, the weight decay runs
    through ``wds``; the state is positive (a mean square or a history),
    g is f32 (the wrapper casts it)."""
    lrs = [torch.tensor(0.05), torch.tensor(0.01), 0.2]
    out = []
    for i, shape in enumerate(shapes):
        s = seed + 10 * i
        out.append((torch.tensor(_rand(shape, s)).to(p_dtype),
                    torch.tensor(_rand(shape, s + 1)),
                    torch.tensor(_rand(shape, s + 2, positive=True))
                    .to(s_dtype), lrs[i % 3], wds[i % len(wds)]))
    return out


def _multi(kind, entries):
    getattr(tfo, f"{kind}_update_multi")(entries, **KW[kind])


def _multi_reference(kind, entries):
    getattr(tfo, f"{kind}_update_multi_reference")(entries, **KW[kind])


# ---------------------------------------------------------------------------
# the CPU path: the per-tensor plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16_param_f32_state"])
@pytest.mark.parametrize("wd", sorted(WDS))
def test_multi_on_the_cpu_equals_the_loop_of_plain_versions(kind, p_dtype,
                                                           wd):
    mine = _entries(SHAPES * 2, p_dtype=p_dtype, wds=WDS[wd])
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


@pytest.mark.parametrize("kind", KINDS)
def test_a_16_bit_state_rounds_as_in_the_loop(kind):
    """A bf16 state: the multi update stores it and reads the stored
    value back, entry by entry, as the plain loop does."""
    mine = _entries(SHAPES, s_dtype=torch.bfloat16, seed=2)
    plain = _clone(mine)
    _multi(kind, mine)
    _multi_reference(kind, plain)
    for e, want in zip(mine, plain):
        assert e[2].dtype == torch.bfloat16
        for got, w in zip(_written(e), _written(want)):
            assert torch.equal(got, w)


@pytest.mark.parametrize("kind", KINDS)
def test_the_cpu_path_calls_the_per_tensor_wrapper_for_each_entry(
        monkeypatch, kind):
    """Looked up when called, so a spy on ``rmsprop_update`` /
    ``adagrad_update`` sees every entry with its own lr and weight
    decay."""
    calls = []
    name = f"{kind}_update"
    real = getattr(tfo, name)

    def spy(p, g, s, lr, **kw):
        calls.append((p, lr, kw["weight_decay"]))
        return real(p, g, s, lr, **kw)
    monkeypatch.setattr(tfo, name, spy)
    entries = _entries(SHAPES)
    _multi(kind, entries)
    assert [(id(p), id(lr), wd) for p, lr, wd in calls] == \
        [(id(e[0]), id(e[3]), e[4]) for e in entries]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("wd", sorted(WDS))
def test_multi_matches_the_pallas_kernels_tensor_by_tensor(kind, wd):
    entries = _entries(SHAPES[1:], seed=5, wds=WDS[wd])
    want = []
    for p, g, s, lr, w in entries:
        arrays = [jnp.asarray(t.numpy()) for t in (p, g, s)]
        want.append(getattr(jfo, f"{kind}_update")(
            *arrays, jnp.float32(float(lr)), weight_decay=w, **KW[kind]))
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

class FakeKernels:
    """Stands in for ``singa_rmsprop_update_multi`` /
    ``singa_adagrad_update_multi``: records each call's table and, unless
    the skip flag holds 0, runs the plain version over views of the
    table's pointers, as the kernel writes through them."""

    def __init__(self):
        self.calls = []

    def function(self, kind):
        return {"rmsprop_multi": self.rmsprop,
                "adagrad_multi": self.adagrad}[kind]

    def _run(self, kind, p_dt, s_dt, table, count, ok, update):
        pt, st = TORCH_DTYPES[p_dt], TORCH_DTYPES[s_dt]
        rows = [(e.p, e.g, e.m, e.lr, e.n, e.weight_decay)
                for e in table[:count]]
        self.calls.append((kind, (p_dt, s_dt), rows))
        if _skipped(ok):
            return 0
        for p, g, s, lr, n, wd in rows:
            update(_view(p, n, pt), _view(g, n, pt), _view(s, n, st),
                   _view(lr, 1, torch.float32).reshape(()), wd)
        return 0

    def rmsprop(self, p_dt, s_dt, table, count, rho, one_minus_rho, eps, ok,
                stream):
        assert one_minus_rho == np.float32(1.0 - rho)
        return self._run("rmsprop_multi", p_dt, s_dt, table, count, ok,
                         lambda p, g, s, lr, wd:
                         tfo.rmsprop_update_reference(
                             p, g, s, lr, rho=rho, epsilon=eps,
                             weight_decay=wd))

    def adagrad(self, p_dt, s_dt, table, count, eps, ok, stream):
        return self._run("adagrad_multi", p_dt, s_dt, table, count, ok,
                         lambda p, g, s, lr, wd:
                         tfo.adagrad_update_reference(
                             p, g, s, lr, epsilon=eps, weight_decay=wd))


@pytest.fixture
def fake(monkeypatch):
    kernels = FakeKernels()
    monkeypatch.setattr(tfo, "_device_kind", lambda p: "cuda")
    monkeypatch.setattr(tfo, "_function", kernels.function)
    monkeypatch.setattr(tfo, "_stream", lambda dev: None)
    return kernels


@pytest.mark.parametrize("kind", KINDS)
def test_the_table_its_chunks_and_the_launch_count(fake, kind):
    """161 entries (ResNet-50's count of parameter tensors, at small
    sizes) with two zero-size ones: 2 launches at capacity 83, each table
    holding the entries' pointers, sizes, lr pointers and weight decays in
    order; results bitwise equal to the loop of plain versions; every
    written tensor's version bumped."""
    shapes = [(1 + (7 * i) % 70,) for i in range(159)] + [(0,), (0,)]
    mine = _entries(shapes)
    plain = _clone(mine)
    versions = [[t._version for t in _written(e)] for e in mine]
    _multi(kind, mine)
    _multi_reference(kind, plain)
    key = f"{kind}_multi"
    cap = tfo.MULTI_CAPACITY[key]
    live = [e for e in mine if e[0].numel()]
    chunks = math.ceil(len(live) / cap)
    assert cap == 83 and chunks == 2
    assert tfo.launches == {**{k: 0 for k in tfo.launches}, key: chunks}
    assert [c[0] for c in fake.calls] == [key] * chunks
    assert [len(c[2]) for c in fake.calls] == [83, len(live) - 83]
    rows = [r for c in fake.calls for r in c[2]]
    lr_ptrs = set()
    for e, r in zip(live, rows):
        assert r[:3] == tuple(t.data_ptr() for t in e[:3])
        assert r[4] == e[0].numel()
        assert r[5] == pytest.approx(e[4], rel=1e-7)
        if isinstance(e[3], torch.Tensor):
            assert r[3] == e[3].data_ptr()
        lr_ptrs.add(r[3])
    assert len(lr_ptrs) == 3           # two lr tensors and one number
    for e, want, vs in zip(mine, plain, versions):
        for got, w in zip(_written(e), _written(want)):
            assert torch.equal(got, w)
        if e[0].numel():
            assert all(t._version > v for t, v in zip(_written(e), vs))
        else:
            assert [t._version for t in _written(e)] == vs


@pytest.mark.parametrize("kind", KINDS)
def test_one_group_per_dtype_pair(fake, kind):
    """f32 and bf16-param/f32-state entries in one call: one launch per
    (p, state) dtype pair, the gradient cast to each parameter's type."""
    mine = _entries(SHAPES[1:], torch.bfloat16) + _entries(SHAPES[1:],
                                                            seed=3)
    plain = _clone(mine)
    _multi(kind, mine)
    _multi_reference(kind, plain)
    assert [c[1] for c in fake.calls] == [(1, 0), (0, 0)]
    assert tfo.launches[f"{kind}_multi"] == 2
    for e, want in zip(mine, plain):
        for got, w in zip(_written(e), _written(want)):
            assert torch.equal(got, w)


def _source():
    return (Path(tfo.__file__).resolve().parents[1] / "csrc"
            / "fused_optim.cu").read_text()


def _source_capacities():
    """``{kind code: entries}`` as ``singa_optim_multi_capacity`` of the
    CUDA source returns them."""
    src = _source()
    macros = {m: int(v) for m, v in
              re.findall(r"#define (\w+_MULTI_MAX) (\d+)", src)}
    body = re.search(r"int singa_optim_multi_capacity\(int kind\) \{(.*?)\n\}",
                     src, re.S).group(1)
    return {int(code): macros[m] for code, m in
            re.findall(r"case (\d+): return (\w+);", body)}


def test_the_wrapper_capacities_equal_the_source_for_every_kind():
    """Each multi-tensor kind asks the library for its own capacity, by
    its own code, and the wrapper's ``MULTI_CAPACITY`` is what the source
    returns for that code: K6 and K7 share K1's one-state table."""
    caps = _source_capacities()
    assert sorted(tfo._CAPACITY_CODE) == sorted(tfo.MULTI_CAPACITY)
    assert sorted(tfo._CAPACITY_CODE.values()) == sorted(caps) == \
        [0, 1, 2, 3]
    for kind, code in tfo._CAPACITY_CODE.items():
        assert caps[code] == tfo.MULTI_CAPACITY[kind], kind
    assert tfo.MULTI_CAPACITY["rmsprop_multi"] == \
        tfo.MULTI_CAPACITY["adagrad_multi"] == \
        tfo.MULTI_CAPACITY["sgd_multi"] == 83
    assert tfo._ENTRIES["rmsprop_multi"] is tfo._ENTRIES["adagrad_multi"] \
        is tfo._SgdEntry
    for kind in ("rmsprop_multi", "adagrad_multi"):
        name = tfo._SIGNATURES[kind][0]
        assert re.search(rf'extern "C" int {name}\(int p_dtype, int s_dtype,'
                         r'\s+const SingaSgdEntry\* entries', _source())


class _FakeLibrary:
    """A loaded library as ``_function`` sees it: the C functions, and a
    ``singa_optim_multi_capacity`` that answers as the source does."""

    def __init__(self, caps):
        self.asked = []

        def capacity(code):
            self.asked.append(code)
            return caps.get(code, 0)
        self.singa_optim_multi_capacity = capacity
        for name, _ in tfo._SIGNATURES.values():
            setattr(self, name, types.SimpleNamespace(argtypes=None,
                                                      restype=None))


@pytest.mark.parametrize("kind", sorted(tfo.MULTI_CAPACITY))
def test_the_library_is_asked_for_the_capacity_of_each_kind(monkeypatch,
                                                            kind):
    lib = _FakeLibrary(_source_capacities())
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    fn = tfo._function(kind)
    assert lib.asked == [tfo._CAPACITY_CODE[kind]]
    assert fn is getattr(lib, tfo._SIGNATURES[kind][0])
    assert fn.argtypes[:3] == [tfo._INT, tfo._INT,
                               tfo._SIGNATURES[kind][1][0]]
    # a library that disagrees with the wrapper is refused
    wrong = _FakeLibrary({c: n + 1 for c, n in _source_capacities().items()})
    monkeypatch.setattr(cuda_build, "load", lambda name: wrong)
    with pytest.raises(RuntimeError, match="disagree"):
        tfo._function(kind)


@pytest.mark.parametrize("kind", KINDS)
def test_a_failed_launch_and_a_bad_entry_raise(fake, monkeypatch, kind):
    entries = _entries([(8,), (5,)])
    bad = list(entries)
    bad[1] = (bad[1][0], torch.zeros(4)) + bad[1][2:]
    with pytest.raises(ValueError, match="shape"):
        _multi(kind, bad)
    monkeypatch.setattr(tfo, "_function", lambda k: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _multi(kind, entries)
    assert tfo.launches[f"{kind}_multi"] == 0
    ints = (torch.zeros(3, dtype=torch.int32),) * 3 + (0.1, 0.0)
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        _multi(kind, [ints])


@pytest.mark.parametrize("kind", KINDS)
def test_a_multi_launch_invalidates_a_cached_bn_fold(fake, kind):
    dev = tdevice.create_cpu_device()
    scale = ttensor.Tensor(data=np.ones(16, np.float32) * 1.5, device=dev)
    bias = ttensor.Tensor(data=np.zeros(16, np.float32), device=dev)
    rmean = ttensor.Tensor(data=np.zeros(16, np.float32), device=dev)
    rvar = ttensor.Tensor(data=np.ones(16, np.float32), device=dev)
    s_before, _ = tfe._folded(scale, bias, rmean, rvar, 1e-5)
    g = torch.tensor(_rand((16,), 1))
    s = torch.tensor(_rand((16,), 2, positive=True))
    want = scale.data.clone()
    _multi_reference(kind, [(want, g, s.clone(), 0.1, 0.0)])
    _multi(kind, [(scale.data, g, s, 0.1, 0.0)])
    assert tfo.launches[f"{kind}_multi"] == 1
    assert torch.equal(scale.data, want)
    s_after, _ = tfe._folded(scale, bias, rmean, rvar, 1e-5)
    assert not torch.equal(s_after, s_before)
    torch.testing.assert_close(
        s_after, want / torch.sqrt(torch.tensor(1.0 + 1e-5)))


# ---------------------------------------------------------------------------
# the optimizer step on a small model
# ---------------------------------------------------------------------------

OPTIMIZERS = {k: _ALL_OPTIMIZERS[k] for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
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
    wd = m.optimizer.weight_decay
    for _, _, rows in fake.calls:
        assert sorted(by_ptr[r[0]] for r in rows) == \
            ["MLP.fc1.b", "MLP.fc2.W", "MLP.fc2.b"]
        lr_of = {by_ptr[r[0]]: r[3] for r in rows}
        assert lr_of["MLP.fc2.b"] != lr_of["MLP.fc1.b"] == \
            lr_of["MLP.fc2.W"]
        assert all(r[5] == np.float32(wd) for r in rows)
    _, plain, _ = _train_port(_register(make(topt, False), topt))
    assert sorted(got) == sorted(plain)
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
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


@pytest.mark.parametrize("kind", KINDS)
def test_update_params_and_apply_agree(monkeypatch, kind):
    """``update_params`` (one multi call for the eligible parameters) and
    a loop of ``apply`` (per tensor) give the same parameters and states,
    under the same state names."""
    calls = []
    real = getattr(tfo, f"{kind}_update_multi")

    def spy(entries, **kw):
        calls.append(len(entries))
        return real(entries, **kw)
    monkeypatch.setattr(tfo, f"{kind}_update_multi", spy)
    dev = tdevice.create_cpu_device()
    results = []
    for how in ("update_params", "apply"):
        o = OPTIMIZERS[kind](topt, True)
        o.weight_decay = 1e-4
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
    assert calls == [len(SHAPES) - 1] * 2
    assert sorted(results[0]) == sorted(results[1])
    state = "rms" if kind == "rmsprop" else "history"
    assert sorted(k for k in results[0] if ":" in k) == \
        sorted(f"w{i}:{state}" for i in range(len(SHAPES) - 1))
    for k in results[0]:
        np.testing.assert_array_equal(results[0][k], results[1][k],
                                      err_msg=k)
