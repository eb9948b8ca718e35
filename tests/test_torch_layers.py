"""The port's layers of this slice against the JAX package's, on the CPU.

Each layer is built in both packages inside a one-layer ``Model``
(``Net.body``), NCHW and NHWC where the JAX layer takes both
(``ops.layout.use_layout``). The state names must agree; the weights are
made with numpy from a seed and set in both; the eval forward must agree
within rtol 1e-5 / atol 1e-5, and the gradients of every parameter for a
seeded cotangent (each package's own ``autograd.backward``) within
1e-5 of each gradient's largest entry. A layer with parameters saves a
``save_states`` archive in each package that loads in the other to the
same forward. The layers not ported yet raise naming ROADMAP.md.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu.autograd_base import CTX as JCTX
from singa_tpu.ops import layout as jlayout
from singa_tpu.tensor import Tensor as JTensor

from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.ops import layout as tlayout
from singa_tpu_torch.tensor import Tensor as TTensor

JDEV = jdevice.create_cpu_device()
TDEV = tdevice.create_cpu_device()
TOL = 1e-5


def _net(pkg_model, body, call):
    class Net(pkg_model.Model):
        def __init__(self):
            super().__init__()
            self.body = body

        def forward(self, *xs):
            return call(self.body, xs)
    return Net()


def _plain(layer, xs):
    return layer(*xs)


def _listed(layer, xs):
    return layer(list(xs))


def _seeded(states, seed=4):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
            for k, v in sorted(states.items())}


def _rand(shape, seed, lo=-1.5, hi=1.5):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


# id: (layer name, constructor args, keywords, inputs, call, layouts)
CASES = {
    "gemm": ("Gemm", (5,), {}, [(3, 4)], _plain, ("NCHW",)),
    "gemm_transA": ("Gemm", (5,), dict(alpha=0.5, beta=2.0, transA=True,
                                       transB=False),
                    [(4, 3)], _plain, ("NCHW",)),
    "gemm_nobias": ("Gemm", (2,), dict(bias=False), [(3, 4)], _plain,
                    ("NCHW",)),
    "conv_transpose": ("ConvTranspose2d", (6, 3),
                       dict(stride=2, padding=1, output_padding=1),
                       [(2, 4, 5, 6)], _plain, ("NCHW", "NHWC")),
    "conv_transpose_groups_dilation_asym": (
        "ConvTranspose2d", (4, (3, 2)),
        dict(stride=(2, 1), padding=((1, 0), (2, 1)), dilation=2, group=2),
        [(2, 4, 5, 4)], _plain, ("NCHW", "NHWC")),
    "conv_transpose_output_padding_past_stride": (
        "ConvTranspose2d", (3, 3), dict(output_padding=(1, 2)),
        [(1, 2, 4, 4)], _plain, ("NCHW", "NHWC")),
    "maxpool1d": ("MaxPool1d", (3, 2, 1), {}, [(2, 3, 1, 9)], _plain,
                  ("NCHW",)),
    "maxpool1d_nhwc": ("MaxPool1d", (3,), {}, [(2, 1, 9, 3)], _plain,
                       ("NHWC",)),
    "avgpool1d": ("AvgPool1d", (2,), {}, [(2, 3, 1, 8)], _plain,
                  ("NCHW",)),
    "sigmoid": ("Sigmoid", (), {}, [(3, 5)], _plain, ("NCHW",)),
    "tanh": ("Tanh", (), {}, [(3, 5)], _plain, ("NCHW",)),
    "softmax": ("SoftMax", (), {}, [(2, 4, 3)], _plain, ("NCHW",)),
    "softmax_last": ("SoftMax", (-1,), {}, [(3, 5)], _plain, ("NCHW",)),
    "mse": ("MeanSquareError", (), {}, [(4, 3), (4, 3)], _plain,
            ("NCHW",)),
    "lrn": ("LRN", (3, 1e-2, 0.75, 2.0), {}, [(2, 6, 3, 3)], _plain,
            ("NCHW",)),
    "cat": ("Cat", (1,), {}, [(2, 3, 4), (2, 5, 4)], _listed, ("NCHW",)),
    "reshape": ("Reshape", ((6, -1),), {}, [(2, 3, 4)], _plain,
                ("NCHW",)),
}


def _inputs(shapes, seed=1):
    return [_rand(s, seed + i) for i, s in enumerate(shapes)]


def _build(name, args, kw, xs, call, layout):
    jl = getattr(jlayer, name)(*args, **kw)
    tl = getattr(tlayer, name)(*args, **kw)
    jm, tm = _net(jmodel, jl, call), _net(tmodel, tl, call)
    jx = [JTensor(data=x, device=JDEV, requires_grad=False) for x in xs]
    tx = [TTensor(data=x, device=TDEV) for x in xs]
    with jlayout.use_layout(layout), tlayout.use_layout(layout):
        jm.compile(jx, is_train=False, use_graph=False)
        tm.compile(tx, is_train=False)
    return jm, tm, jx, tx


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    JCTX.training = TCTX.training = False


def _grads(pkg_ag, ctx, model, xs, make_dy):
    ctx.training = True
    try:
        y = model.forward(*xs)
        dy = make_dy(y)
        names = {id(t): k for k, t in model.get_params().items()}
        return {names[id(p)]: np.asarray(g.data, np.float32)
                if pkg_ag is jag else g.to_numpy()
                for p, g in pkg_ag.backward(y, dy)}
    finally:
        ctx.training = False


CASE_IDS = [f"{k}-{lo}" for k, v in CASES.items() for lo in v[-1]]


@pytest.mark.parametrize("case", CASE_IDS)
def test_layer_matches_jax(case):
    key, layout = case.rsplit("-", 1)
    name, args, kw, shapes, call, _ = CASES[key]
    xs = _inputs(shapes)
    if layout == "NHWC" and len(shapes[0]) == 4 and name != "MaxPool1d":
        xs = [np.ascontiguousarray(x.transpose(0, 2, 3, 1)) for x in xs]
    jm, tm, jx, tx = _build(name, args, kw, xs, call, layout)
    jstates, tstates = jm.get_states(), tm.get_states()
    assert sorted(tstates) == sorted(jstates)
    for k in jstates:
        assert tuple(tstates[k].shape) == tuple(jstates[k].shape), k
    init = _seeded(jstates)
    for k, v in init.items():
        jstates[k].copy_from_numpy(v)
        tstates[k].copy_from_numpy(v)
    want = np.asarray(jm(*jx).data)
    got = tm(*tx).to_numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if not init:
        return
    dy = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    jg = _grads(jag, JCTX, jm, jx,
                lambda y: JTensor(data=dy, device=JDEV, requires_grad=False))
    tg = _grads(tag, TCTX, tm, tx, lambda y: torch.from_numpy(dy))
    assert sorted(tg) == sorted(jg) == sorted(init)
    for k, w in jg.items():
        np.testing.assert_allclose(tg[k], w, rtol=TOL,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=k)


def test_loss_layers_match_jax():
    x = _rand((4, 3), 1, 0.05, 0.95)
    t = (np.random.RandomState(2).rand(4, 3) > 0.5).astype(np.float32)
    for name in ("BinaryCrossEntropy", "MeanSquareError", "CrossEntropy"):
        want = getattr(jlayer, name)()(
            JTensor(data=x, device=JDEV, requires_grad=False),
            JTensor(data=t, device=JDEV, requires_grad=False))
        got = getattr(tlayer, name)()(TTensor(data=x, device=TDEV),
                                      TTensor(data=t, device=TDEV))
        np.testing.assert_allclose(got.to_numpy(), np.asarray(want.data),
                                   rtol=TOL, err_msg=name)


def test_reshape_layer_takes_a_shape_per_call():
    x = _rand((2, 3, 4), 3)
    got = tlayer.Reshape()(TTensor(data=x, device=TDEV), (4, 6))
    want = jlayer.Reshape()(JTensor(data=x, device=JDEV), (4, 6))
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.data))


def _head(pkg_layer, pkg_model):
    return _net(pkg_model, pkg_layer.FusedCEHead(17, chunk=8), _plain)


def test_fused_ce_head_matches_jax():
    """``FusedCEHead`` (vocab 17 in chunks of 8): loss and the gradients
    of W and b."""
    h = _rand((2, 5, 8), 5)
    ids = np.random.RandomState(6).randint(0, 17, (2, 5)).astype(np.float32)
    jm, tm = _head(jlayer, jmodel), _head(tlayer, tmodel)
    jx = [JTensor(data=h, device=JDEV, requires_grad=False),
          JTensor(data=ids, device=JDEV, requires_grad=False)]
    tx = [TTensor(data=h, device=TDEV), TTensor(data=ids, device=TDEV)]
    jm.compile(jx, is_train=False, use_graph=False)
    tm.compile(tx, is_train=False)
    assert sorted(tm.get_states()) == sorted(jm.get_states()) == \
        ["Net.body.W", "Net.body.b"]
    init = _seeded(jm.get_states())
    for k, v in init.items():
        jm.get_states()[k].copy_from_numpy(v)
        tm.get_states()[k].copy_from_numpy(v)
    np.testing.assert_allclose(tm(*tx).to_numpy(), np.asarray(jm(*jx).data),
                               rtol=TOL, atol=TOL)
    jg = _grads(jag, JCTX, jm, jx, lambda y: None)
    tg = _grads(tag, TCTX, tm, tx, lambda y: None)
    for k, w in jg.items():
        np.testing.assert_allclose(tg[k], w, rtol=TOL,
                                   atol=TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("key", ["gemm", "conv_transpose",
                                 "conv_transpose_groups_dilation_asym"])
def test_checkpoints_cross_both_ways(tmp_path, key):
    name, args, kw, shapes, call, _ = CASES[key]
    xs = _inputs(shapes)
    jm, tm, jx, tx = _build(name, args, kw, xs, call, "NCHW")
    init = _seeded(jm.get_states(), seed=8)
    for k, v in init.items():
        jm.get_states()[k].copy_from_numpy(v)
    path = tmp_path / "jax.zip"
    jm.save_states(str(path))
    tm.load_states(str(path))
    want = np.asarray(jm(*jx).data)
    np.testing.assert_allclose(tm(*tx).to_numpy(), want, rtol=TOL, atol=TOL)
    back = tmp_path / "port.zip"
    tm.save_states(str(back))
    jm2, _, _, _ = _build(name, args, kw, xs, call, "NCHW")
    jm2.load_states(str(back))
    np.testing.assert_allclose(np.asarray(jm2(*jx).data), want, rtol=TOL,
                               atol=TOL)


def test_set_params_and_device_check():
    jm, tm, jx, tx = _build("Gemm", (3,), {}, _inputs([(2, 4)]), _plain,
                            "NCHW")
    params = {k: np.full(tuple(v.shape), 0.5, np.float32)
              for k, v in tm.get_params().items()}
    tm.set_params(params)
    jm.set_params(params)
    np.testing.assert_allclose(tm(*tx).to_numpy(), np.asarray(jm(*jx).data),
                               rtol=TOL)
    assert tm.device_check(3, tx[0]) is TDEV and tm.device_check(1) is None


@pytest.mark.parametrize("name", ["RNN", "LSTM", "CudnnRNN",
                                  "FusedCEHeadStage"])
def test_layers_not_ported_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(tlayer, name)(8, 8)
