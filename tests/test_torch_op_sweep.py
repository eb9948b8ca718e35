"""Every public function of ``singa_tpu.autograd`` against its counterpart
in the port, forward and backward, on the CPU.

Each case runs one call through both packages on the same inputs (numpy,
from a seed): the JAX package's under ``jax.vjp``, the port's under torch
autograd, each given the same seeded cotangent. Forward values within
rtol 1e-5 / atol 1e-6 in f32, the dtype's name equal; gradients within
1e-5 (rtol and atol); a bf16 tier within rtol 1e-2. Rows sit at the points
where the two frameworks' gradient rules part: ``abs`` at 0, ``clip`` and
``hardsigmoid`` at both bounds, ties of ``max``/``min``/``reduce_max`` and
of ``ranking_loss``'s margin, ``elu``/``selu``/``leakyrelu`` at 0, ±x.5
for ``round``/``rounde``, negative indices for ``gather`` and
``scatter_elements`` on each axis, each ``pad`` mode, ``upsample`` on each
axis and ``depth_to_space`` in DCR and CRD. ``relu`` is held away from 0:
there the port keeps torch's gradient 0 (the JAX package's ``maximum(x,
0)`` gives 0.5; ``singa_tpu_torch/autograd.py`` says why).

A completeness guard lists the JAX module's public functions at run time
and fails when one has neither a case here nor an entry of ``EXCLUDED``,
each of which names its ROADMAP slice and raises in the port.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu.autograd_base import CTX as JCTX
from singa_tpu.autograd_base import Operator as JOperator
from singa_tpu.tensor import Tensor as JTensor

from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.autograd_base import Operator as TOperator
from singa_tpu_torch.tensor import Tensor as TTensor, dtype_name

JDEV = jdevice.create_cpu_device()
TDEV = tdevice.create_cpu_device()
RNG = np.random.RandomState(3)
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5
BF16_RTOL = 1e-2

# public functions of singa_tpu.autograd the port does not have yet
EXCLUDED = {
    "rnn_op": "ops/rnn.py (ROADMAP.md: slice E, with char_rnn)",
}
# held by a test of their own below (checkpoint: tests/test_torch_remat.py)
DEDICATED = {"backward", "gradients", "infer_dependency", "is_training",
             "set_training", "axis_helper", "back_broadcast",
             "ctensor2numpy", "checkpoint"}


class _Pkg:
    """What a case needs of one package: its autograd module, a constant
    Tensor maker and its training flag."""

    def __init__(self, ag, make, ctx, bf16):
        self.ag, self.make, self.ctx, self.bf16 = ag, make, ctx, bf16

    def T(self, arr):
        return self.make(np.asarray(arr))


JAXP = _Pkg(jag, lambda a: JTensor(data=a, device=JDEV, requires_grad=False),
            JCTX, jnp.bfloat16)
PORT = _Pkg(tag, lambda a: TTensor(data=a, device=TDEV), TCTX,
            torch.bfloat16)


def r(*shape, lo=-1.5, hi=1.5):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def f32(*vals):
    return np.array(vals, np.float32)


def b01(*shape):
    return (RNG.rand(*shape) > 0.5).astype(np.float32)


def _in_training(fn):
    def run(P, *xs):
        prev = P.ctx.training
        P.ctx.training = True
        try:
            return fn(P, *xs)
        finally:
            P.ctx.training = prev
    return run


x35, y35, x235 = r(3, 5), r(3, 5), r(2, 3, 5)
xp = r(3, 5, lo=0.2, hi=1.8)
x_in = r(3, 5, lo=-0.9, hi=0.9)
x_gt1 = r(3, 5, lo=1.1, hi=2.5)
half = f32(-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.3, -0.7)
ties = np.array([[1.0, 1.0, -0.5], [0.2, 0.7, 0.7]], np.float32)
ids4 = f32(0, 3, 5, 2)
img = r(2, 4, 5, 6)
conv_x = r(2, 2, 5, 5)
bn_mean, bn_var = r(4), r(4, lo=0.5, hi=2.0)


def _conv(P, x, W, b=None, **kw):
    h = P.ag.ConvHandle(x, kw.pop("k", (3, 3)), kw.pop("stride", 1),
                        kw.pop("padding", 1), x.shape[1], W.shape[0],
                        b is not None, **kw)
    return P.ag.conv2d(h, x, W, b)


def _bn(P, x, scale, bias, rm, rv):
    h = P.ag.BatchNormHandle(0.9, x, 1e-5)
    return P.ag.batchnorm_2d(h, x, scale, bias, P.T(rm), P.T(rv))


def _pool(P, x, **kw):
    h = P.ag.PoolingHandle(x, **kw)
    return P.ag.pooling_2d(h, x)


# (id, callable over (package, *Tensors), inputs, differentiated inputs or
# None for every floating one). The function a case holds is the id's part
# before "@".
CASES = [
    # ---- unary math ----
    ("abs", lambda P, x: P.ag.abs(x), [x35], None),
    ("abs@0", lambda P, x: P.ag.abs(x), [f32(-1.5, 0.0, 0.7, 0.0)], None),
    ("acos", lambda P, x: P.ag.acos(x), [x_in], None),
    ("acosh", lambda P, x: P.ag.acosh(x), [x_gt1], None),
    ("asin", lambda P, x: P.ag.asin(x), [x_in], None),
    ("asinh", lambda P, x: P.ag.asinh(x), [x35], None),
    ("atan", lambda P, x: P.ag.atan(x), [x35], None),
    ("atanh", lambda P, x: P.ag.atanh(x), [x_in], None),
    ("ceil", lambda P, x: P.ag.ceil(x), [x35], None),
    ("cos", lambda P, x: P.ag.cos(x), [x35], None),
    ("cosh", lambda P, x: P.ag.cosh(x), [x35], None),
    ("erf", lambda P, x: P.ag.erf(x), [x35], None),
    ("exp", lambda P, x: P.ag.exp(x), [x35], None),
    ("floor", lambda P, x: P.ag.floor(x), [x35], None),
    ("identity", lambda P, x: P.ag.identity(x), [x235], None),
    ("log", lambda P, x: P.ag.log(x), [xp], None),
    ("negative", lambda P, x: P.ag.negative(x), [x35], None),
    ("reciprocal", lambda P, x: P.ag.reciprocal(x), [xp], None),
    ("round@half", lambda P, x: P.ag.round(x), [half], None),
    ("rounde@half", lambda P, x: P.ag.rounde(x), [half], None),
    ("sign@0", lambda P, x: P.ag.sign(x), [f32(-2.0, 0.0, 3.0)], None),
    ("sin", lambda P, x: P.ag.sin(x), [x35], None),
    ("sinh", lambda P, x: P.ag.sinh(x), [x35], None),
    ("sqrt", lambda P, x: P.ag.sqrt(x), [xp], None),
    ("tan", lambda P, x: P.ag.tan(x), [x_in], None),
    ("tanh", lambda P, x: P.ag.tanh(x), [x35], None),
    # ---- activations ----
    ("relu", lambda P, x: P.ag.relu(x), [r(3, 5, lo=0.05) * np.sign(
        RNG.randn(3, 5)).astype(np.float32)], None),
    ("leakyrelu@0", lambda P, x: P.ag.leakyrelu(x, 0.1),
     [f32(-1.0, 0.0, 0.5)], None),
    ("elu@0", lambda P, x: P.ag.elu(x, 1.5), [f32(-1.0, 0.0, 0.5)], None),
    ("elu", lambda P, x: P.ag.elu(x), [x35], None),
    ("selu@0", lambda P, x: P.ag.selu(x), [f32(-1.0, 0.0, 0.5)], None),
    ("sigmoid", lambda P, x: P.ag.sigmoid(x), [x35], None),
    ("softplus", lambda P, x: P.ag.softplus(x), [r(3, 5, lo=-30, hi=30)],
     None),
    ("softsign@0", lambda P, x: P.ag.softsign(x), [f32(-1.0, 0.0, 2.0)],
     None),
    ("hardsigmoid@bounds", lambda P, x: P.ag.hardsigmoid(x),
     [f32(-2.5, 2.5, -3.0, 3.0, 0.4)], None),
    ("prelu", lambda P, x, s: P.ag.prelu(x, s),
     [x35, np.full((3, 5), 0.3, np.float32)], None),
    ("softmax", lambda P, x: P.ag.softmax(x), [x235], None),
    ("softmax@-1", lambda P, x: P.ag.softmax(x, -1), [x35], None),
    ("gelu", lambda P, x: P.ag.gelu(x), [x35], None),
    ("lrn", lambda P, x: P.ag.lrn(x, 3, 0.1, 0.75, 1.0), [r(2, 5, 2, 2)],
     None),
    ("lrn@even", lambda P, x: P.ag.lrn(x, 4, 0.2, 0.5, 2.0), [r(2, 6, 2, 3)],
     None),
    # ---- binary ----
    ("add", lambda P, a, b: P.ag.add(a, b), [x35, y35], None),
    ("add@bcast", lambda P, a, b: P.ag.add(a, b), [x235, r(5)], None),
    ("sub", lambda P, a, b: P.ag.sub(a, b), [x35, y35], None),
    ("mul", lambda P, a, b: P.ag.mul(a, b), [x35, y35], None),
    ("mul@bcast", lambda P, a, b: P.ag.mul(a, b), [x235, r(3, 1)], None),
    ("div", lambda P, a, b: P.ag.div(a, b), [x35, xp], None),
    ("pow", lambda P, a, b: P.ag.pow(a, b), [xp, y35], None),
    ("add_bias", lambda P, x, b: P.ag.add_bias(x, b, 0), [x35, r(5)], None),
    ("add_bias@1", lambda P, x, b: P.ag.add_bias(x, b, 1), [x235, r(3)],
     None),
    ("matmul", lambda P, a, b: P.ag.matmul(a, b), [r(4, 6), r(6, 3)], None),
    ("matmul@batched", lambda P, a, b: P.ag.matmul(a, b),
     [r(2, 4, 6), r(2, 6, 3)], None),
    ("gemm", lambda P, a, b, c: P.ag.gemm(a, b, c, 0.5, 2.0, 1, 1),
     [r(6, 4), r(3, 6), r(4, 3)], None),
    ("gemm@noC", lambda P, a, b: P.ag.gemm(a, b, None, 1.5),
     [r(4, 6), r(6, 3)], None),
    # ---- n-ary elementwise ----
    ("sum", lambda P, a, b, c: P.ag.sum(a, b, c), [x35, y35, xp], None),
    ("add_all", lambda P, a, b: P.ag.add_all(a, b), [x35, y35], None),
    ("mean", lambda P, a, b, c: P.ag.mean(a, b, c), [x35, y35, xp], None),
    ("max@ties", lambda P, a, b: P.ag.max(a, b), [ties, ties.T.copy().T],
     None),
    ("max", lambda P, a, b, c: P.ag.max(a, b, c), [x35, y35, xp], None),
    ("min@ties", lambda P, a, b: P.ag.min(a, b),
     [ties, np.array([[1.0, 0.0, -0.5], [0.2, 0.9, 0.1]], np.float32)],
     None),
    ("where", lambda P, c, a, b: P.ag.where(c, a, b), [b01(3, 5), x35, y35],
     (1, 2)),
    ("clip@bounds", lambda P, x: P.ag.clip(x, -0.5, 0.8),
     [f32(-0.5, 0.8, 0.1, -1.0, 1.2)], None),
    ("clip@relu6", lambda P, x: P.ag.clip(x, 0.0, 6.0),
     [f32(0.0, 6.0, 3.0, -1.0, 7.0)], None),
    ("clip@lo_only", lambda P, x: P.ag.clip(x, 0.0), [f32(0.0, -1.0, 2.0)],
     None),
    ("clip@hi_only", lambda P, x: P.ag.clip(x, None, 1.0),
     [f32(1.0, -1.0, 2.0)], None),
    # ---- comparisons and logic ----
    ("equal", lambda P, a, b: P.ag.equal(a, b), [b01(3, 5), b01(3, 5)], ()),
    ("less", lambda P, a, b: P.ag.less(a, b), [x35, y35], ()),
    ("greater", lambda P, a, b: P.ag.greater(a, b), [x35, y35], ()),
    ("_and", lambda P, a, b: P.ag._and(a, b), [b01(3, 5), b01(3, 5)], ()),
    ("_or", lambda P, a, b: P.ag._or(a, b), [b01(3, 5), b01(3, 5)], ()),
    ("_xor", lambda P, a, b: P.ag._xor(a, b), [b01(3, 5), b01(3, 5)], ()),
    ("_not", lambda P, a: P.ag._not(a), [b01(3, 5)], ()),
    # ---- reductions ----
    ("reduce_sum", lambda P, x: P.ag.reduce_sum(x, [0, 2], 0), [x235],
     None),
    ("reduce_sum@keep", lambda P, x: P.ag.reduce_sum(x, [1]), [x235], None),
    ("reduce_sum@all", lambda P, x: P.ag.reduce_sum(x), [x235], None),
    ("reduce_mean", lambda P, x: P.ag.reduce_mean(x, [2, 3], 0), [img],
     None),
    ("reduce_max@ties", lambda P, x: P.ag.reduce_max(x, [1], 0), [ties],
     None),
    ("reduce_max@all", lambda P, x: P.ag.reduce_max(x, None, 1), [x235],
     None),
    ("reduce_prod", lambda P, x: P.ag.reduce_prod(x, [1], 0),
     [r(2, 3, 2, lo=0.4, hi=1.6)], None),
    ("reduce_prod@zero", lambda P, x: P.ag.reduce_prod(x, [0, 1], 1),
     [f32(2.0, 0.0, 3.0, -1.5).reshape(2, 2)], None),
    # ---- shape ----
    ("reshape", lambda P, x: P.ag.reshape(x, (5, 6)), [x235], None),
    ("flatten", lambda P, x: P.ag.flatten(x, 2), [x235], None),
    ("flatten@0", lambda P, x: P.ag.flatten(x, 0), [x235], None),
    ("transpose", lambda P, x: P.ag.transpose(x, (2, 0, 1)), [x235], None),
    ("transpose@none", lambda P, x: P.ag.transpose(x), [x235], None),
    ("squeeze", lambda P, x: P.ag.squeeze(x, [0, 2]), [r(1, 3, 1, 5)],
     None),
    ("squeeze@all", lambda P, x: P.ag.squeeze(x), [r(1, 3, 1, 5)], None),
    ("unsqueeze", lambda P, x: P.ag.unsqueeze(x, [0, 3]), [x35], None),
    ("cat", lambda P, a, b: P.ag.cat([a, b], 1), [x35, y35], None),
    ("split@parts", lambda P, x: P.ag.split(x, 0, [2, 1, 3]), [r(6, 4)],
     None),
    ("split@equal", lambda P, x: P.ag.split(x, 1, num_output=2),
     [r(2, 6, 3)], None),
    ("slice", lambda P, x: P.ag.slice(x, [1, 0], [3, 4], [0, 1], [1, 2]),
     [x35], None),
    ("slice@negstep", lambda P, x: P.ag.slice(x, [-1], [0], [1], [-2]),
     [x35], None),
    ("make_slice", lambda P, x: P.ag.make_slice(x, 1, 2), [x35], None),
    ("gather@1", lambda P, x: P.ag.gather(x, 1, [0, 3, 3]), [x35], None),
    ("gather@neg0", lambda P, x: P.ag.gather(x, 0, [-1, 0, -3]), [x35],
     None),
    ("gather@neg_last", lambda P, x, i: P.ag.gather(x, -1, i),
     [x235, np.array([[-1, 2], [0, -5]], np.float32)], (0,)),
    ("scatter_elements@0", lambda P, x, i, u: P.ag.scatter_elements(
        x, i, u, 0), [r(3, 3), f32(1, 0, 2, -3, 2, 1).reshape(2, 3),
                      r(2, 3)], (0, 2)),
    ("scatter_elements@neg1", lambda P, x, i, u: P.ag.scatter_elements(
        x, i, u, 1), [r(3, 4), f32(-1, 0, 2, 1, -4, 3).reshape(3, 2),
                      r(3, 2)], (0, 2)),
    ("tile", lambda P, x: P.ag.tile(x, [2, 3]), [x35], None),
    ("tile@short", lambda P, x: P.ag.tile(x, 2), [x235], None),
    ("tile@long", lambda P, x: P.ag.tile(x, [2, 1, 2]), [x35], None),
    ("expand", lambda P, x: P.ag.expand(x, (4, 3, 5)), [x35], None),
    ("expand@ones", lambda P, x: P.ag.expand(x, (2, 1, 5)), [r(3, 1)],
     None),
    ("pad@constant", lambda P, x: P.ag.pad(x, "constant", [1, 0, 0, 2],
                                           0.5), [x35], None),
    ("pad@reflect", lambda P, x: P.ag.pad(x, "reflect", [2, 1, 0, 3]),
     [r(4, 5)], None),
    ("pad@edge", lambda P, x: P.ag.pad(x, "edge", [0, 2, 1, 3, 0, 1]),
     [x235], None),
    ("upsample@every_axis",
     lambda P, x: P.ag.upsample(x, "nearest", [2, 3, 1, 2]),
     [r(2, 2, 2, 3)], None),
    ("depth_to_space@DCR", lambda P, x: P.ag.depth_to_space(x, 2),
     [r(2, 8, 2, 3)], None),
    ("depth_to_space@CRD", lambda P, x: P.ag.depth_to_space(x, 2, "CRD"),
     [r(2, 8, 2, 3)], None),
    ("space_to_depth", lambda P, x: P.ag.space_to_depth(x, 2),
     [r(2, 3, 4, 6)], None),
    # ---- indexing and generation ----
    ("onehot", lambda P, i: P.ag.onehot(-1, i, 6), [f32(0, 3, 7, -1)], ()),
    ("onehot@0", lambda P, i: P.ag.onehot(0, i, 4, (0.5, 2.0)),
     [f32(0, 3, 1)], ()),
    ("embedding", lambda P, i, W: P.ag.embedding(i, W), [ids4, r(6, 4)],
     (1,)),
    ("cossim", lambda P, a, b: P.ag.cossim(a, b), [x35, y35], None),
    ("shape", lambda P, x: P.ag.shape(x), [x235], ()),
    ("constant_of_shape", lambda P, s: P.ag.constant_of_shape(s, 2.5),
     [np.array([2, 3], np.int64)], ()),
    ("nonzero", lambda P, x: P.ag.nonzero(x),
     [f32(1.0, 0.0, 0.0, 2.0, 0.0, -1.0).reshape(2, 3)], ()),
    ("cast@int32", lambda P, x: P.ag.cast(x, np.int32), [f32(1.7, -2.3)],
     ()),
    ("cast@int64", lambda P, x: P.ag.cast(x, np.int64), [f32(1.7, -2.3)],
     ()),
    ("cast@float64", lambda P, x: P.ag.cast(x, np.float64), [x35], ()),
    ("cast@bf16", lambda P, x: P.ag.cast(x, P.bf16), [x35], ()),
    ("astype@bf16", lambda P, x: P.ag.astype(x, P.bf16), [x235], None),
    ("astype@float64", lambda P, x: P.ag.astype(x, np.float64), [x35],
     None),
    ("dropout@eval", lambda P, x: P.ag.dropout(x, 0.5), [x35], None),
    # ---- losses ----
    ("cross_entropy", lambda P, p, y: P.ag.cross_entropy(p, y),
     [np.abs(r(4, 5)) + 0.1, np.eye(5, dtype=np.float32)[[0, 2, 1, 4]]],
     (0,)),
    ("softmax_cross_entropy", lambda P, x, y: P.ag.softmax_cross_entropy(
        x, y), [r(4, 5), np.eye(5, dtype=np.float32)[[0, 2, 1, 4]]], (0,)),
    ("softmax_cross_entropy@ids", lambda P, x, y:
     P.ag.softmax_cross_entropy(x, y), [r(4, 5), f32(0, 2, 1, 4)], (0,)),
    ("mse_loss", lambda P, a, b: P.ag.mse_loss(a, b), [x35, y35], (0,)),
    ("binary_cross_entropy", lambda P, p, y: P.ag.binary_cross_entropy(
        p, y), [RNG.uniform(0.05, 0.95, (4, 3)).astype(np.float32),
                b01(4, 3)], (0,)),
    ("ranking_loss@margin", lambda P, p, n: P.ag.ranking_loss(p, n, 0.25),
     [f32(0.75, 0.9, -0.2, 1.2), f32(0.5, 0.1, 0.4, 1.0)], None),
    ("layernorm", lambda P, x, s, b: P.ag.layernorm(x, s, b),
     [x35, np.abs(r(5)) + 0.5, r(5)], None),
    # ---- conv, BN and pooling (the JAX module re-exports them) ----
    ("conv2d", lambda P, x, W, b: _conv(P, x, W, b),
     [conv_x, r(4, 2, 3, 3), r(4)], None),
    ("conv2d@group_stride_same", lambda P, x, W: _conv(
        P, x, W, stride=2, padding=0, group=2, pad_mode="SAME"),
     [r(2, 4, 7, 6), r(4, 2, 3, 3)], None),
    ("conv2d@dilation_asym", lambda P, x, W: _conv(
        P, x, W, padding=((2, 1), (0, 2)), dilation=2),
     [conv_x, r(3, 2, 3, 3)], None),
    ("batchnorm_2d@eval", lambda P, x, s, b: _bn(
        P, x, s, b, bn_mean, bn_var),
     [img, r(4, lo=0.5, hi=1.5), r(4)], None),
    ("batchnorm_2d@train", _in_training(lambda P, x, s, b: _bn(
        P, x, s, b, np.zeros(4, np.float32), np.ones(4, np.float32))),
     [img, r(4, lo=0.5, hi=1.5), r(4)], None),
    ("pooling_2d@max", lambda P, x: _pool(P, x, kernel_size=3, stride=2,
                                          padding=1), [img], None),
    ("pooling_2d@avg", lambda P, x: _pool(P, x, kernel_size=2, stride=2,
                                          is_max=False), [img], None),
    ("pooling_2d@avg_valid", lambda P, x: _pool(
        P, x, kernel_size=3, stride=1, padding=1, is_max=False,
        count_include_pad=False), [img], None),
    ("globalaveragepool", lambda P, x: P.ag.globalaveragepool(x), [img],
     None),
    ("globalaveragepool@last", lambda P, x: P.ag.globalaveragepool(
        x, "channels_last"), [img], None),
]


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _diff(ins, diff):
    if diff is None:
        return tuple(i for i, a in enumerate(ins) if _floating(a))
    return tuple(diff)


def _cotangent(shape, seed):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _host(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _jax_run(fn, ins, diff):
    arrs = [jnp.asarray(a) for a in ins]

    def f(*d):
        full = list(arrs)
        for i, v in zip(diff, d):
            full[i] = v
        out = fn(JAXP, *[JAXP.make(a) for a in full])
        return tuple(o.data for o in out) if isinstance(out, tuple) \
            else out.data
    if not diff:
        out = f()
        outs = out if isinstance(out, tuple) else (out,)
        return [(_host(o), str(o.dtype)) for o in outs], []
    out, vjp = jax.vjp(f, *[arrs[i] for i in diff])
    outs = out if isinstance(out, tuple) else (out,)
    cots = tuple(jnp.asarray(_cotangent(o.shape, 7 + k), o.dtype)
                 for k, o in enumerate(outs))
    grads = vjp(cots if isinstance(out, tuple) else cots[0])
    return ([(_host(o), str(o.dtype)) for o in outs],
            [_host(g) for g in grads])


def _port_run(fn, ins, diff):
    ts = [torch.from_numpy(np.array(a)) for a in ins]
    for i in diff:
        ts[i].requires_grad_(True)
    out = fn(PORT, *[TTensor(data=t, device=TDEV) for t in ts])
    outs = out if isinstance(out, tuple) else (out,)
    host = [(o.to_numpy(), dtype_name(o.dtype)) for o in outs]
    if not diff:
        return host, []
    cots = [torch.from_numpy(_cotangent(o.shape, 7 + k)).to(o.dtype)
            for k, o in enumerate(outs)]
    grads = torch.autograd.grad([o.data for o in outs],
                                [ts[i] for i in diff], grad_outputs=cots,
                                allow_unused=True)
    return host, [np.zeros(ts[i].shape, np.float32) if g is None else
                  g.float().numpy() for i, g in zip(diff, grads)]


@pytest.fixture(autouse=True)
def _eval_mode():
    prev = TCTX.training, JCTX.training
    TCTX.training = JCTX.training = False
    yield
    TCTX.training, JCTX.training = prev


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_gradient_match_jax(case):
    name, fn, ins, diff = case
    diff = _diff(ins, diff)
    want, want_g = _jax_run(fn, ins, diff)
    got, got_g = _port_run(fn, ins, diff)
    assert len(got) == len(want)
    for (g, gd), (w, wd) in zip(got, want):
        assert gd == wd, f"{name}: dtype {gd}, the JAX package's {wd}"
        assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{name}: gradient of input "
                                   f"{diff[i]}")


def test_edge_gradients_are_the_jax_packages():
    """The rows above where the frameworks part, spelled out: ``abs`` at 0
    is 1, ``clip`` at either bound 0.5, a tie of ``max`` 0.5 each."""
    x = torch.tensor([0.0, 0.0, 6.0], requires_grad=True)
    t = TTensor(data=x, device=TDEV)
    (g,) = torch.autograd.grad(tag.abs(t).data.sum(), [x])
    assert g.tolist() == [1.0, 1.0, 1.0]
    (g,) = torch.autograd.grad(tag.clip(t, 0.0, 6.0).data.sum(), [x])
    assert g.tolist() == [0.5, 0.5, 0.5]
    (g,) = torch.autograd.grad(tag.max(t, TTensor(
        data=torch.zeros(3), device=TDEV)).data.sum(), [x])
    assert g.tolist() == [0.5, 0.5, 1.0]


def test_lrn_is_local_response_norm():
    """``lrn``'s alpha / size and window convention is
    ``F.local_response_norm``'s, for odd and even sizes."""
    x = torch.from_numpy(r(2, 7, 3, 3))
    for size in (3, 4, 5):
        got = tag.lrn(TTensor(data=x, device=TDEV), size, 0.3, 0.75,
                      2.0).data
        want = F.local_response_norm(x, size, alpha=0.3, beta=0.75, k=2.0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


BF16_CASES = ["add", "mul", "matmul", "tanh", "relu", "softmax", "sigmoid",
              "exp", "abs", "clip@bounds", "reduce_mean", "reduce_max@ties",
              "cat", "transpose", "gelu", "layernorm", "conv2d",
              "pooling_2d@max", "upsample@every_axis", "split@equal"]


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_forward_matches_jax(name):
    _, fn, ins, _ = next(c for c in CASES if c[0] == name)
    j = fn(JAXP, *[JAXP.make(jnp.asarray(np.asarray(a), jnp.bfloat16))
                   for a in ins])
    t = fn(PORT, *[TTensor(data=_bf16(a), device=TDEV) for a in ins])
    js = j if isinstance(j, tuple) else (j,)
    ts = t if isinstance(t, tuple) else (t,)
    for a, b in zip(ts, js):
        assert dtype_name(a.dtype) == str(b.dtype), name
        np.testing.assert_allclose(a.to_numpy(), _host(b.data),
                                   rtol=BF16_RTOL, atol=BF16_RTOL,
                                   err_msg=name)


def _public(mod):
    return {n for n, o in vars(mod).items() if inspect.isfunction(o) and
            (not n.startswith("_") or n in ("_and", "_or", "_xor",
                                            "_not"))}


def test_every_public_function_has_a_case_or_an_exclusion():
    public = _public(jag)
    cased = {c[0].split("@")[0] for c in CASES}
    missing = sorted(public - cased - DEDICATED - set(EXCLUDED))
    assert not missing, f"public JAX autograd functions with no case: " \
                        f"{missing}"
    assert not (set(EXCLUDED) - public), "stale exclusion"
    for n in sorted(public - set(EXCLUDED)):
        assert callable(getattr(tag, n, None)), f"the port lacks {n}"
    for n, where in EXCLUDED.items():
        assert "ROADMAP" in where
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(tag, n)(None, None)


def test_training_property_and_set_training():
    for flag in (True, False):
        tag.training = flag
        assert TCTX.training is flag and tag.is_training() is flag
        tag.set_training(not flag)
        assert tag.training is (not flag)


def test_axis_helper_back_broadcast_and_ctensor2numpy():
    for y, x in (((2, 3, 4), (4,)), ((2, 3, 4), (3, 1)),
                 ((2, 3, 4), (1, 3, 4)), ((5,), (5,))):
        assert tag.axis_helper(y, x) == jag.axis_helper(y, x)
        g = r(*y)
        want = np.asarray(jag.back_broadcast(y, x, jnp.asarray(g)))
        got = tag.back_broadcast(y, x, TTensor(data=g, device=TDEV))
        np.testing.assert_allclose(got.to_numpy(), want, rtol=1e-6)
        assert got.shape == x
    a = r(2, 3)
    out = tag.ctensor2numpy(TTensor(data=a, device=TDEV))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, a)


def _two_layer(ag, make, x, y, W1, W2):
    h = ag.relu(ag.matmul(x, W1))
    return ag.softmax_cross_entropy(ag.matmul(h, W2), make(y))


def test_backward_and_gradients_match_jax():
    """:func:`backward` yields every parameter's gradient in the JAX
    tape's order; :func:`gradients` gives them as a dict."""
    x, y = r(4, 6), np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    w1, w2 = r(6, 5), r(5, 3)
    JCTX.training = True
    jw = [JTensor(data=w, device=JDEV, requires_grad=True, stores_grad=True,
                  name=n) for w, n in ((w1, "W1"), (w2, "W2"))]
    jloss = _two_layer(jag, JAXP.make, JAXP.make(x), y, *jw)
    want = [(p.name, np.asarray(g.data)) for p, g in jag.backward(jloss)]
    from singa_tpu_torch.autograd_base import register_param
    tw = []
    for w, n in ((w1, "W1"), (w2, "W2")):
        t = TTensor(data=w, device=TDEV, requires_grad=True,
                    stores_grad=True, name=n)
        register_param(t)
        tw.append(t)
    TCTX.training = True
    tloss = _two_layer(tag, PORT.make, PORT.T(x), y, *tw)
    got = [(p.name, g.to_numpy()) for p, g in tag.backward(tloss)]
    assert [n for n, _ in got] == [n for n, _ in want] == ["W2", "W1"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)
    tloss = _two_layer(tag, PORT.make, PORT.T(x), y, *tw)
    grads = tag.gradients(tloss)
    assert set(grads) == set(tw)
    np.testing.assert_allclose(grads[tw[1]].to_numpy(), want[0][1],
                               rtol=GRAD_TOL, atol=GRAD_TOL)


class _Cube(TOperator):
    def forward(self, x):
        return x * x * x


class _JCube(JOperator):
    def forward(self, x):
        return x * x * x


class _StraightThrough(TOperator):
    """round() forward, identity gradient: a custom backward."""

    def forward(self, x):
        return torch.round(x)

    def backward(self, dy):
        return dy


def test_operator_default_and_custom_backward():
    """An Operator without a backward of its own is differentiated by
    torch autograd and its ``backward`` is the vjp of the JAX package's;
    one with a custom ``backward`` has it honoured through a
    ``torch.autograd.Function``."""
    x = r(3, 4)
    dy = r(3, 4)
    JCTX.training = TCTX.training = True
    jop = _JCube()
    jop(JTensor(data=x, device=JDEV, requires_grad=True))
    want = np.asarray(jop.backward(jnp.asarray(dy)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    op = _Cube()
    out = op(TTensor(data=xt, device=TDEV))
    np.testing.assert_allclose(op.backward(torch.from_numpy(dy)).numpy(),
                               want, rtol=1e-6)
    (g,) = torch.autograd.grad(out.data, [xt], torch.from_numpy(dy))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
    st = _StraightThrough()
    out = st(TTensor(data=xt, device=TDEV))
    np.testing.assert_array_equal(out.to_numpy(), np.round(x))
    (g,) = torch.autograd.grad(out.data, [xt], torch.from_numpy(dy))
    np.testing.assert_array_equal(g.numpy(), dy)
    assert out.creator is st and st.src[0][3]


def test_infer_dependency_counts_like_jax():
    """Consumer edges per upstream op, on the same little graph: ``y =
    x ** 3``, ``z = y * y * x`` (through Operators)."""
    class TMul(TOperator):
        def forward(self, a, b):
            return a * b

    class JMul(JOperator):
        def forward(self, a, b):
            return a * b

    JCTX.training = TCTX.training = True
    jx = JTensor(data=r(2, 2), device=JDEV, requires_grad=True)
    jy = _JCube()(jx)
    jz = JMul()(JMul()(jy, jy), jx)
    want = sorted(jag.infer_dependency(jz.creator).values())
    tx = TTensor(data=torch.from_numpy(r(2, 2)).requires_grad_(True),
                 device=TDEV)
    ty = _Cube()(tx)
    tz = TMul()(TMul()(ty, ty), tx)
    got = sorted(tag.infer_dependency(tz.creator).values())
    assert got == want == [0, 1, 2, 2]


def test_data_dependent_ops_refuse_inside_a_step():
    """``nonzero``, ``shape`` and ``constant_of_shape`` read the device
    back to the host: inside a graph-mode step they raise, never sync."""
    from singa_tpu_torch.graph import StepGraph
    x = PORT.T(f32(1.0, 0.0, 2.0))
    for fn in (tag.nonzero, tag.shape,
               lambda t: tag.constant_of_shape(PORT.T(np.array([2, 2])))):
        step = StepGraph(fn, TDEV)
        with pytest.raises(RuntimeError, match="captured step"):
            step(x)
        assert fn(x).shape     # outside a step they run


def test_op_classes_and_left_out_pieces_raise_naming_the_roadmap():
    """The JAX module's CamelCase op classes wait for the ``sonnx`` slice:
    each raises ``NotImplementedError`` naming ROADMAP.md (and ``hasattr``
    is False); so do ``ops.resize`` and ``data.ImageBatchIter``'s
    ``faults=`` (a fault plan)."""
    from singa_tpu_torch import data as tdata
    from singa_tpu_torch.ops import resize as tresize
    ported = {"Operator", "Dummy", "GlobalAveragePool"}
    classes = sorted(n for n, o in vars(jag).items() if inspect.isclass(o)
                     and issubclass(o, JOperator) and not n.startswith("_"))
    assert len(classes) > 90
    for n in classes:
        if n in ported:
            assert inspect.isclass(getattr(tag, n)), n
            continue
        assert not hasattr(tag, n), n
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(tag, n)
    for make in (lambda: tresize.resize(None, (2, 2)),
                 lambda: tresize.ResizeHandle(None),
                 lambda: tdata.ImageBatchIter("list.txt", 2, None,
                                              faults=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make()
