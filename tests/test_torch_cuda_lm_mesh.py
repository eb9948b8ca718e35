"""The LM-on-a-mesh slice on the card: a ring hop reaches K3 with its
position delta, rematerialisation keeps a dropout's masks inside a CUDA
graph, the LM's remat step equals the plain one, and ``generate`` on the
card decodes as on the CPU.

Marked ``cuda``: each case skips with a reason where
``torch.cuda.is_available()`` is false. This file imports only torch and
the port, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_lm_mesh.py -m cuda -q

Bounds: a ring hop's out and lse within 1e-4 of the plain version's
largest magnitude (``chip_smoke.py``'s f32 flash gate); remat and the
dropout net bitwise (the recompute runs the same kernels on the same
values; cuDNN is not involved); the decode's logits on the card within
1e-4 of the largest CPU logit (TF32 off on both).
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import autograd, device, layer, model, opt, tensor
from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer
from singa_tpu_torch.ops import attention as at

TOL = 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernels have no "
                    "CPU mode")


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
@pytest.mark.parametrize("hop", [-1, 0, 1])
def test_a_ring_hop_reaches_k3_with_its_delta(hop, no_tf32):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(2, 4, 128, 64, generator=gen, device="cuda")
               for _ in range(3))
    delta, scale = hop * 128, 0.125
    at.reset_counts()
    out, lse = at._RingPartials.apply(q, k, v, delta, True, scale, 512)
    assert at.pos_delta_launches["flash_fwd"] == 1
    ro, rl = at._scan_flash_fwd(q, k, v, True, scale, pos_delta=delta)
    assert float((out - ro).abs().max()) <= TOL * max(
        1.0, float(ro.abs().max()))
    live = rl > -1e29
    assert bool((lse[~live] <= -1e29).all())
    if bool(live.any()):
        assert float((lse[live] - rl[live]).abs().max()) <= TOL * float(
            rl[live].abs().max())


class _DropNet(model.Model):
    def __init__(self, remat):
        super().__init__()
        self.remat = remat
        self.block = _Block()
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        return autograd.checkpoint(self.block, x) if self.remat \
            else self.block(x)

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self.optimizer(loss)
        return out, loss


class _Block(layer.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = layer.Linear(128)
        self.drop = layer.Dropout(0.5)
        self.fc2 = layer.Linear(10)

    def forward(self, x):
        return self.fc2(self.drop(autograd.relu(self.fc1(x))))


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graphed"])
def test_remat_keeps_the_dropout_masks(graph, no_tf32):
    """4 steps of a net whose block drops units, rematerialised against
    not, from the same weights and device-generator seed: losses and
    parameters bitwise, eagerly and inside a captured step."""
    _need_card()
    dev = device.create_cuda_gpu(0)
    rng = np.random.default_rng(0)
    x = tensor.Tensor(data=rng.standard_normal((32, 64), dtype=np.float32),
                      device=dev)
    y = tensor.Tensor(data=np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, 32)], device=dev)
    init, runs = None, []
    for remat in (False, True):
        m = _DropNet(remat)
        m.set_optimizer(opt.SGD(lr=0.1))
        m.compile([x], is_train=True, use_graph=graph)
        init = init or {k: np.random.default_rng(1).standard_normal(
            tuple(t.shape)).astype(np.float32) * 0.1
            for k, t in m.get_states().items()}
        load_numpy_states(m, init)
        dev.SetRandSeed(7)
        losses = torch.stack([m(x, y)[1].data.detach().clone()
                              for _ in range(4)])
        runs.append((losses, {k: t.data.detach().clone()
                              for k, t in m.get_params().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def _lm(dev, ids, remat=False, use_graph=True):
    m = transformer.TransformerLM(64, d_model=64, n_heads=4, n_layers=2,
                                  max_len=128, tp=False, remat=remat)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    m.compile([tensor.Tensor(data=ids, device=dev)], is_train=True,
              use_graph=use_graph)
    rng = np.random.default_rng(2)
    load_numpy_states(m, {k: (rng.standard_normal(tuple(t.shape)) * (
        0.02 if k.endswith("emb.W") else 1 / np.sqrt(t.shape[0])
        if k.endswith(".W") else 0.02)).astype(np.float32) + (
        1.0 if k.endswith("scale") else 0.0)
        for k, t in m.get_states().items()})
    return m


@pytest.mark.cuda
def test_the_lm_remat_step_equals_the_plain_one(no_tf32):
    _need_card()
    dev = device.create_cuda_gpu(0)
    ids = np.random.default_rng(3).integers(0, 64, (2, 128)).astype(
        np.float32)
    tx = tensor.Tensor(data=ids, device=dev)
    ty = tensor.Tensor(data=np.roll(ids, -1, 1), device=dev)
    runs = []
    for remat in (False, True):
        m = _lm(dev, ids, remat)
        at.reset_counts()
        losses = [float(m(tx, ty)[1].data.detach()) for _ in range(3)]
        runs.append((losses, dict(at.launches), {
            k: t.data.detach().clone() for k, t in m.get_params().items()}))
    (l0, c0, p0), (l1, c1, p1) = runs
    assert l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    # eager call and capture: K3 runs once more per block with remat
    assert c1["flash_fwd"] == 2 * c0["flash_fwd"] == 8
    assert c1["flash_bwd_dq"] == c0["flash_bwd_dq"] == 4


@pytest.mark.cuda
def test_generate_on_the_card_decodes_as_on_the_cpu(no_tf32):
    _need_card()
    ids = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(
        np.float32)
    got = {}
    for name, dev in (("cuda", device.create_cuda_gpu(0)),
                      ("cpu", device.create_cpu_device())):
        m = _lm(dev, ids, use_graph=False)
        m.eval()
        logits = []
        tokens = transformer._decode(m, ids, 8, temperature=0,
                                     on_token=logits.append)
        got[name] = tokens, logits
    scale = max(float(t.abs().max()) for t in got["cpu"][1])
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        assert float((a.cpu() - b).abs().max()) <= TOL * scale
    assert got["cuda"][0].shape == (2, 24)
