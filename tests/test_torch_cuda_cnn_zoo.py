"""The rest of ``train_cnn.py``'s paths on the card: K1-multi on bf16
parameters and momenta (``-p bfloat16``) against its plain version, a
captured AlexNet step with dropout against the eager one, and the
``space_to_depth`` stem conv against the plain 7x7/s2 conv.

Marked ``cuda``: the kernels and CUDA graphs have no CPU mode, so each
case skips with a reason where ``torch.cuda.is_available()`` is false.
This file imports only torch and the port, so it runs on a GPU machine
without JAX (``--noconftest`` skips ``tests/conftest.py``, which sets up
JAX):

    python -m pytest --noconftest tests/test_torch_cuda_cnn_zoo.py -m cuda -q

K1-multi rounds once from the same f32 values as its plain version, so
the two agree bitwise on bf16 tensors too. Graph against eager is bitwise
with cuDNN deterministic and the device generator seeded the same (the
capture registers it, so each replay draws the mask the eager step
draws). The stem conv sums in another order than the plain conv: f32
within 1e-4 and bf16 within 2e-2 of the largest output (and of the
largest gradient), TF32 off.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import autograd, device, model, opt, tensor
from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.graph import StepGraph
from singa_tpu_torch.models import alexnet
from singa_tpu_torch.ops import conv as tconv
from singa_tpu_torch.ops import fused_optim as tfo

S2D_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and CUDA graphs have "
                    "no CPU mode")


@pytest.fixture
def deterministic():
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev
    CTX.training = False


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
def test_k1_multi_on_bf16_parameters_and_momenta(nesterov):
    """One multi-tensor call over a step's worth of mixed tensors (bf16
    weights and momenta as ``-p bfloat16`` makes them, f32 BN scales and
    biases), against the plain multi-tensor version on clones: every
    parameter and momentum bitwise, one launch per dtype pair."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(64, 3, 7, 7), (256, 64, 1, 1), (512, 512, 3, 3), (2048, 10),
              (10,), (4099,), (1,)]
    entries = []
    for i, s in enumerate(shapes * 2):
        dt = torch.bfloat16 if i < len(shapes) else torch.float32

        def r(scale=1.0):
            return (torch.randn(s, generator=gen, device="cuda")
                    * scale).to(dt)
        entries.append((r(), r(1e-2), r(1e-3),
                        torch.tensor(0.05, device="cuda"), 1e-5 * (i % 3)))
    clones = [(p.clone(), g.clone(), m.clone(), lr, wd)
              for p, g, m, lr, wd in entries]
    tfo.reset_counts()
    tfo.sgd_momentum_update_multi(entries, momentum=0.9, nesterov=nesterov)
    assert tfo.launches["sgd_multi"] == 2
    before = [p.clone() for p, *_ in clones]
    tfo.sgd_momentum_update_multi_reference(clones, momentum=0.9,
                                            nesterov=nesterov)
    for (p, _, m, _, _), (cp, _, cm, _, _) in zip(entries, clones):
        assert torch.equal(p, cp) and torch.equal(m, cm)
        assert p.dtype == m.dtype
    # the update moved the bf16 weights (not a no-op on both sides)
    assert not torch.equal(entries[2][0], before[2])


@pytest.mark.cuda
def test_a_captured_alexnet_step_with_dropout_replays_bitwise(
        deterministic):
    """AlexNet (224 px, b4, both dropouts at 0.5) trained 5 steps of fused
    SGD in graph mode and eagerly from the same start and the same device
    seed: losses and every state bitwise, one capture, four replays; a
    captured dropout draws a new mask at every replay, each the mask the
    eager call draws."""
    _need_card()
    dev = device.create_cuda_gpu(0)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 224, 224).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)]
    runs, start = [], None
    for use_graph in (True, False):
        m = alexnet.create_model(num_channels=3)
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9, weight_decay=1e-5,
                                fused=True))
        tx = tensor.Tensor(data=x, device=dev)
        ty = tensor.Tensor(data=y, device=dev)
        m.compile([tx], is_train=True, use_graph=use_graph)
        if start is None:
            start = {k: v.to_numpy().copy()
                     for k, v in m.get_states().items()}
        model.load_numpy_states(m, start)
        dev.SetRandSeed(7)
        losses = torch.stack([m(tx, ty)[1].data.detach()
                              for _ in range(5)])
        states = {k: v.data.detach().clone()
                  for k, v in m.get_states().items()}
        states.update({f"optimizer/{k}": v.data.clone() for k, v in
                       m.optimizer.state_tensor_dict().items()})
        runs.append((m, losses, states))
    (m, losses, states), (_, e_losses, e_states) = runs
    assert torch.equal(losses, e_losses)
    assert sorted(states) == sorted(e_states)
    for k in states:
        assert torch.equal(states[k], e_states[k]), k
    assert list(m.graph_stats().values()) == [
        {"n_captures": 1, "n_replays": 4}]

    xs = tensor.Tensor(data=torch.ones(1 << 14, device="cuda"), device=dev)

    def drop(t):
        CTX.training = True
        try:
            return autograd.dropout(t, 0.5)
        finally:
            CTX.training = False
    dev.SetRandSeed(3)
    step = StepGraph(drop, dev)
    graphed = [step(xs).data for _ in range(4)]
    dev.SetRandSeed(3)
    eager = [drop(xs).data for _ in range(4)]
    assert step.stats() == {"n_captures": 1, "n_replays": 3}
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    assert not torch.equal(graphed[2], graphed[3])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_space_to_depth_stem_conv_against_conv7(deterministic, layout,
                                                dtype):
    """The ResNet stem (3 -> 64 channels, 7x7/s2, b8 at 224 px): output
    and the gradients of x and W of the s2d form against the plain conv
    on the same OIHW weights."""
    _need_card()
    dev = device.create_cuda_gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 3, 224, 224, generator=gen, device="cuda")
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    W = torch.randn(64, 3, 7, 7, generator=gen, device="cuda") / 12.0
    outs = {}
    for s2d in (False, True):
        h = tconv.ConvHandle(x.shape, 7, 2, 3, 3, 64, bias=False,
                             layout=layout, space_to_depth=s2d)
        xa = x.to(dtype).requires_grad_(True)
        Wa = W.to(dtype).requires_grad_(True)
        y = tconv.conv2d(h, tensor.Tensor(data=xa, device=dev),
                         tensor.Tensor(data=Wa, device=dev)).data
        w = torch.linspace(-1, 1, y.numel(), device="cuda").reshape(
            y.shape).to(dtype)
        gx, gW = torch.autograd.grad((y * w).float().sum(), [xa, Wa])
        outs[s2d] = [y.float(), gx.float(), gW.float()]
        assert y.dtype == dtype
    for what, a, b in zip(("y", "dx", "dW"), outs[True], outs[False]):
        assert a.shape == b.shape, what
        scale = float(b.abs().max())
        assert scale > 0
        err = float((a - b).abs().max())
        assert err <= S2D_TOL[dtype] * scale, (what, err, scale)
