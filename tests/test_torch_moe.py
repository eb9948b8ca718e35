"""The port's Mixture-of-Experts FFN (``singa_tpu_torch/parallel/moe.py``)
held against the JAX package's (``singa_tpu/parallel/moe.py``) on one
device, the cases of ``tests/test_moe.py::TestDenseMoE``.

Each case draws its tokens, weights and cotangents from a numpy seed, runs
the port's ``MoEFFN`` layer in training mode (torch autograd) and the JAX
package's ``_MoEFFN.forward`` under ``jax.vjp``, and holds the output, the
aux loss and the gradient of every parameter and of the input within
1e-5 of the largest reference value: top-1 (Switch: the raw gate) and
top-2 (the gates over the sum of every pick's) with capacity to spare,
capacities that drop tokens (a dropped pick's gate still takes a
gradient through top-2's denominator; a token whose every pick dropped
gets a zero row), top-3, and the aux loss of ``test_aux_loss_scalar``.
The port dispatches and combines by index where the JAX package
multiplies one-hot (T, E, C) tensors: the same function, up to the order
of f32 sums (measured: 4.2e-7 of the largest value at most).

Under ``compute_dtype=bfloat16`` (a bf16 input) and the ``bf16_mixed``
policy the router and its softmax stay f32 and the experts run in bf16
(``tests/test_transformer.py::TestBF16Compute``): held against the f32
function within 2e-2. Each JAX run is one jit of the function and its
vjp.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singa_tpu.parallel import moe as jmoe

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import mixed_precision as tmp
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.parallel import gspmd
from singa_tpu_torch.parallel import moe as tmoe

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

TOL = 1e-5
BF16_TOL = 2e-2
NAMES = ("wg", "w1", "b1", "w2", "b2")
# name -> (T, D, E, F, top_k, capacity_factor): tests/test_moe.py's
# TestDenseMoE shapes, then a dropping top-2 and a top-3
CASES = {
    "top1": (12, 8, 4, 16, 1, 8.0),
    "top2": (6, 8, 4, 16, 2, 8.0),
    "drop_top1": (16, 4, 2, 8, 1, 2.0 / 16.0),
    "drop_top2": (24, 8, 4, 16, 2, 0.5),
    "top3": (24, 8, 4, 16, 3, 0.75),
    "aux": (8, 4, 4, 8, 2, 1.25),
}
DEV = tdevice.create_cpu_device()


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    TCTX.training = False


def _arrays(T, D, E, F, seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(T, D).astype(np.float32),
            "wg": (rng.randn(D, E) * 0.5).astype(np.float32),
            "w1": (rng.randn(E, D, F) * math.sqrt(2.0 / (D + F))
                   ).astype(np.float32),
            "b1": (rng.randn(E, F) * 0.1).astype(np.float32),
            "w2": (rng.randn(E, F, D) * math.sqrt(2.0 / (D + F))
                   ).astype(np.float32),
            "b2": (rng.randn(E, D) * 0.1).astype(np.float32),
            "gy": rng.randn(T, D).astype(np.float32),
            "ga": np.float32(rng.uniform(0.5, 1.5))}


def _jax(a, E, k, cf):
    op = jmoe._MoEFFN(E, k, cf, None, ())

    @jax.jit
    def run(ins, cts):
        out, vjp = jax.vjp(lambda *t: op.forward(*t), *ins)
        return out, vjp(cts)

    (y, aux), grads = run([jnp.asarray(a[n]) for n in ("x",) + NAMES],
                          (jnp.asarray(a["gy"]), jnp.asarray(a["ga"])))
    return np.asarray(y), float(aux), dict(zip(("x",) + NAMES,
                                               map(np.asarray, grads)))


def _port(a, E, F, k, cf, dtype=torch.float32, policy=None):
    """The port's layer on ``a``: output, aux loss, gradients (f32), the
    layer."""
    TCTX.training = True
    ffn = tmoe.MoEFFN(E, F, top_k=k, capacity_factor=cf)
    x = ttensor.Tensor(data=torch.from_numpy(a["x"]).to(dtype),
                       device=DEV, requires_grad=True, stores_grad=True)
    x.data.requires_grad_(True)
    with tmp.policy_scope(policy):
        ffn.ensure_initialized(x)
        for n in NAMES:
            getattr(ffn, n).copy_from_numpy(a[n])
        y = ffn(x)
    leaves = [x.data] + [getattr(ffn, n).data for n in NAMES]
    grads = torch.autograd.grad(
        [y.data, ffn.aux_loss.data], leaves,
        [torch.from_numpy(a["gy"]).to(y.dtype),
         torch.tensor(a["ga"]).to(ffn.aux_loss.dtype)])
    return (y.data.detach().float().numpy(),
            float(ffn.aux_loss.data.detach().float()),
            {n: g.float().numpy() for n, g in zip(("x",) + NAMES, grads)},
            ffn, y)


def _held(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: {err:.3g} against {scale:.3g}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_jax_package(case):
    T, D, E, F, k, cf = CASES[case]
    a = _arrays(T, D, E, F, seed=sorted(CASES).index(case))
    y, aux, grads, _, _ = _port(a, E, F, k, cf)
    jy, jaux, jgrads = _jax(a, E, k, cf)
    assert y.shape == (T, D) and np.isfinite(aux)
    _held(y, jy, TOL, f"{case} output")
    _held(aux, jaux, TOL, f"{case} aux")
    for n in ("x",) + NAMES:
        _held(grads[n], jgrads[n], TOL, f"{case} d{n}")


def test_capacity_drops_tokens_and_dropped_picks_keep_gate_gradients():
    """Under ``drop_top2`` some tokens lose every pick (zero rows) and
    some keep one of two: the kept pick weighs its gate over both gates'
    sum, so the dropped pick's gate still has a gradient (the router's
    ``wg`` gradient is held to JAX's above)."""
    T, D, E, F, k, cf = CASES["drop_top2"]
    a = _arrays(T, D, E, F, seed=sorted(CASES).index("drop_top2"))
    y, _, _, _, _ = _port(a, E, F, k, cf)
    gates = torch.softmax(torch.from_numpy(a["x"] @ a["wg"]), -1)
    C = tmoe.capacity(T, E, k, cf)
    rounds = tmoe.route(gates, k, C)
    kept = torch.stack([keep for _i, keep, _s in rounds], 1)
    none = ~kept.any(1)
    some = kept.any(1) & ~kept.all(1)
    assert bool(none.any()) and bool(some.any())
    np.testing.assert_array_equal(y[none.numpy()], 0.0)
    assert np.abs(y[some.numpy()]).sum(1).min() > 0.0
    counts = sum(torch.bincount(i[keep], minlength=E)
                 for i, keep, _s in rounds)
    assert int(counts.max()) <= C


def test_router_stays_f32_and_experts_follow_bf16():
    """A bf16 input (``compute_dtype=bfloat16``): the router is f32, the
    expert banks and the output bf16; the ``bf16_mixed`` policy: f32
    masters, bf16 products and output. Both within 2e-2 of the f32 JAX
    function."""
    T, D, E, F, k, cf = CASES["top2"]
    a = _arrays(T, D, E, F, seed=7)
    jy, jaux, _ = _jax(a, E, k, cf)
    _, _, _, ffn, y = _port(a, E, F, k, cf, dtype=torch.bfloat16)
    assert ffn.wg.dtype == torch.float32
    assert ffn.w1.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    _held(y.data.detach().float().numpy(), jy, BF16_TOL, "bf16 output")
    _, aux, _, ffn, y = _port(a, E, F, k, cf,
                              policy=tmp.resolve("bf16_mixed"))
    assert ffn.wg.dtype == ffn.w1.dtype == torch.float32
    assert y.dtype == torch.bfloat16
    _held(y.data.detach().float().numpy(), jy, BF16_TOL,
          "bf16_mixed output")
    _held(aux, jaux, BF16_TOL, "bf16_mixed aux")


def test_names_shapes_and_specs_are_the_jax_layers():
    """The state names and shapes of ``singa_tpu/parallel/moe.py:141-158``
    (the router (D, E), the banks (E, D, F), (E, F), (E, F, D), (E, D));
    each expert bank announces ``gspmd.expert_spec``, the router none;
    ``top_k`` above the expert count raises as in JAX."""
    tl = tmoe.MoEFFN(4, 16, top_k=2)
    tl(ttensor.Tensor(data=np.zeros((4, 8), np.float32), device=DEV))
    assert {k: tuple(v.shape) for k, v in tl.get_states().items()} == {
        "MoEFFN.wg": (8, 4), "MoEFFN.w1": (4, 8, 16), "MoEFFN.b1": (4, 16),
        "MoEFFN.w2": (4, 16, 8), "MoEFFN.b2": (4, 8)}
    for n in ("w1", "b1", "w2", "b2"):
        assert getattr(tl, n).spec == gspmd.expert_spec("expert")
    assert getattr(tl.wg, "spec", None) is None
    with pytest.raises(ValueError, match="top_k"):
        tmoe.MoEFFN(2, 8, top_k=3)
    with pytest.raises(ValueError, match="top_k"):
        jmoe.MoEFFN(2, 8, top_k=3)
