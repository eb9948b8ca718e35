"""The MoE slice on the card: the MoE FFN's forward and gradients on the
card against the CPU, and one step of the MoE Transformer LM (K3/K4 at
every attention call, K1-multi for the fused SGD) on the card against
the same step on the CPU.

Marked ``cuda``: each case skips with a reason where
``torch.cuda.is_available()`` is false. This file imports only torch and
the port, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_moe.py -m cuda -q

Bounds (TF32 off on both): the layer's output and every gradient within
1e-5 of the largest CPU value (f32 products of length 64 and 256 in
another order); the LM step's loss within rtol 1e-5 and every parameter
after the step within 1e-4 of its norm (the flash kernels sum in their
own order, ``chip_smoke.py``'s f32 gates). The seeded router's gates lie
far enough apart that both sides route every token alike, which the
layer case checks.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import device, opt, tensor
from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer
from singa_tpu_torch.ops import attention as at
from singa_tpu_torch.ops import fused_optim as fo
from singa_tpu_torch.parallel import moe

TOL = 1e-5
PARAM_TOL = 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention and optimizer "
                    "kernels of the MoE LM's step have no CPU mode")


@pytest.fixture
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    CTX.training = False


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,cf", [(1, 8.0), (2, 8.0), (2, 0.5)])
def test_layer_on_the_card_matches_the_cpu(top_k, cf, no_tf32):
    _need_card()
    rng = np.random.RandomState(top_k)
    T, D, E, F = 512, 64, 4, 256
    arrays = [rng.randn(T, D), rng.randn(D, E) / np.sqrt(D),
              rng.randn(E, D, F) * 0.1, rng.randn(E, F) * 0.1,
              rng.randn(E, F, D) * 0.1, rng.randn(E, D) * 0.1]
    gy = torch.tensor(rng.randn(T, D), dtype=torch.float32)
    op = moe._MoEFFN(E, top_k, cf, None, ())
    got, want = [], []
    for dev, out in (("cuda", got), ("cpu", want)):
        args = [torch.tensor(a, dtype=torch.float32, device=dev,
                             requires_grad=True) for a in arrays]
        y, aux = op.forward(*args)
        grads = torch.autograd.grad([y, aux], args,
                                    [gy.to(dev), torch.ones((), device=dev)])
        out += [t.detach().cpu() for t in (y, aux) + grads]
        C = moe.capacity(T, E, top_k, cf)
        gates = torch.softmax(args[0] @ args[1], -1)
        out.append([(i.cpu(), k.cpu())
                    for i, k, _ in moe.route(gates.detach(), top_k, C)])
    for (gi, gk), (wi, wk) in zip(got.pop(), want.pop()):
        assert torch.equal(gi, wi) and torch.equal(gk, wk)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= TOL * scale


@pytest.mark.cuda
def test_a_moe_lm_step_on_the_card_matches_the_cpu(no_tf32):
    _need_card()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 48, (2, 32)).astype(np.float32)
    tgt = np.roll(ids, -1, 1)
    kw = dict(d_model=32, n_heads=2, n_layers=2, max_len=32, tp=False,
              moe=4, fused_head_chunk=16)
    runs = {}
    for name, dev in (("cuda", device.create_cuda_gpu(0)),
                      ("cpu", device.create_cpu_device())):
        m = transformer.TransformerLM(48, **kw)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
        tx = tensor.Tensor(data=ids, device=dev)
        m.compile([tx], is_train=True, use_graph=False)
        if "init" not in runs:
            init = np.random.RandomState(1)
            runs["init"] = {k: (init.randn(*v.shape) * 0.1).astype(
                np.float32) for k, v in sorted(m.get_states().items())}
        load_numpy_states(m, runs["init"])
        at.reset_counts()
        fo.reset_counts()
        _, loss = m(tx, tensor.Tensor(data=tgt, device=dev))
        runs[name] = (float(loss.data.detach()),
                      {k: v.to_numpy() for k, v in m.get_states().items()},
                      dict(at.launches), dict(fo.launches))
    loss, states, flash, optim = runs["cuda"]
    want_loss, want_states, _, _ = runs["cpu"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for k, v in want_states.items():
        err = float(np.linalg.norm(states[k] - v))
        assert err <= PARAM_TOL * float(np.linalg.norm(v)) + 1e-7, k
    assert flash["flash_fwd"] == 2 and flash["flash_bwd_dq"] == 2
    assert optim["sgd_multi"] >= 1
