"""``DistOpt`` over NCCL on the card, at world 1: the sum of one rank
divided by 1.0, so each step is bitwise the step of the optimizer it
wraps (fused SGD, K1's multi-tensor launch; under ``bf16_mixed`` the
guard, step 4 poisoned), per gradient and in 25 MiB buckets, eagerly and
with the collectives captured in the CUDA graph. Under ``bf16_mixed`` the
``DistOpt`` sums on the policy's bf16 wire, so the run it is held
against has each gradient rounded through bf16 as it leaves the
backward.

Marked ``cuda``: NCCL runs only on the card, so each case skips with a
reason where ``torch.cuda.is_available()`` is false. This file imports
only torch and the port, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_dist.py -m cuda -q
"""

import contextlib

import numpy as np
import pytest
import torch

from singa_tpu_torch import autograd_base, device, layer, model, opt, tensor
from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.parallel import communicator


class ConvBN(model.Model):
    def __init__(self):
        super().__init__()
        self.conv = layer.Conv2d(8, 3, padding=1)
        self.bn = layer.BatchNorm2d()
        self.relu = layer.ReLU()
        self.flat = layer.Flatten()
        self.fc = layer.Linear(4)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self.optimizer(loss)
        return out, loss


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """A world-1 NCCL process group on ``cuda:0``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    dev = device.create_cuda_gpu(0)
    communicator.init_process(
        communicator.NcclIdHolder(
            file=str(tmp_path_factory.mktemp("nccl") / "store")),
        0, 1, device=dev, timeout_s=60)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield dev
    torch.backends.cudnn.deterministic = prev
    CTX.training = False
    torch.distributed.destroy_process_group()


@contextlib.contextmanager
def _bf16_wire():
    """Every gradient ``autograd_base.backward`` yields rounded through
    bf16 to f32: the plain version of a one-rank sum on the bf16 wire."""
    real = autograd_base.backward

    def backward(y, dy=None):
        for p, g in real(y, dy):
            g.data = g.data.to(torch.bfloat16).float()
            yield p, g
    autograd_base.backward = backward
    try:
        yield
    finally:
        autograd_base.backward = real


def _run(dev, optimizer, use_graph, policy, steps=6, poisoned=4):
    rng = np.random.RandomState(0)
    batches = [(rng.randn(8, 3, 6, 6).astype(np.float32),
                np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)])
               for _ in range(steps)]
    if policy is not None:
        batches[poisoned][0][1, 0, 2, 2] = np.nan
    dev.SetRandSeed(3)
    m = ConvBN()
    m.set_optimizer(optimizer)
    m.compile([tensor.Tensor(data=batches[0][0], device=dev)],
              is_train=True, use_graph=use_graph, policy=policy)
    losses = [m(tensor.Tensor(data=x, device=dev),
                tensor.Tensor(data=y, device=dev))[1].data.clone()
              for x, y in batches]
    states = {k: t.data.detach().clone() for k, t in m.get_states().items()}
    states.update({f"optimizer/{k}": t.data.clone()
                   for k, t in m.optimizer.state_tensor_dict().items()})
    return m, torch.stack(losses), states


@pytest.mark.cuda
@pytest.mark.parametrize("use_graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("bucket_mb", [0, 25])
@pytest.mark.parametrize("policy", [None, "bf16_mixed"])
def test_world_one_is_bitwise_the_wrapped_optimizer(nccl, use_graph,
                                                    bucket_mb, policy):
    def sgd():
        return opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True)
    dist = opt.DistOpt(sgd(), bucket_mb=bucket_mb)
    m, losses, states = _run(nccl, dist, use_graph, policy)
    with _bf16_wire() if policy else contextlib.nullcontext():
        _, want_losses, want = _run(nccl, sgd(), use_graph, policy)
    # the poisoned step's loss is NaN in both
    assert torch.equal(losses.nan_to_num(), want_losses.nan_to_num())
    assert sorted(states) == sorted(want)
    for k, v in want.items():
        assert torch.equal(states[k], v), k
    # host calls: one per gradient (6) or one bucket, and the guard's
    # verdict; in graph mode at the eager first step and the capture only
    per_step = (1 if bucket_mb else 6) + (policy is not None)
    assert dist.communicator.n_collectives == per_step * (
        2 if use_graph else 6)
    if use_graph:
        assert all(s["n_captures"] == 1
                   for s in m.graph_stats().values())


@pytest.mark.cuda
@pytest.mark.parametrize("use_graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("spelling", ["zero", "fsdp_axis"])
@pytest.mark.parametrize("policy", [None, "bf16_mixed"])
def test_world_one_fsdp_is_bitwise_the_wrapped_optimizer(nccl, use_graph,
                                                         spelling, policy):
    """ZeRO/FSDP at world 1 (``DistOpt(zero=True)``, or a plain SGD under
    ``compile(fsdp_axis="data")``): each parameter gathered and its
    gradient scattered by one-rank NCCL collectives, eagerly and captured
    in the CUDA graph, bitwise the wrapped optimizer's step."""
    from singa_tpu_torch.parallel import gspmd

    def sgd():
        return opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True)
    real_compile = model.Model.compile

    def fsdp_compile(self, inputs, **kw):
        real_compile(self, inputs, mesh=gspmd.train_mesh(data=1),
                     fsdp_axis="data", **kw)
    optimizer = opt.DistOpt(sgd(), zero=True) if spelling == "zero" \
        else sgd()
    if spelling == "fsdp_axis":
        model.Model.compile = fsdp_compile
    try:
        m, losses, states = _run(nccl, optimizer, use_graph, policy)
    finally:
        model.Model.compile = real_compile
    with _bf16_wire() if policy else contextlib.nullcontext():
        _, want_losses, want = _run(nccl, sgd(), use_graph, policy)
    assert torch.equal(losses.nan_to_num(), want_losses.nan_to_num())
    assert sorted(states) == sorted(want)
    for k, v in want.items():
        assert torch.equal(states[k], v), k
    # a gather and a scatter per parameter (6), the guard's 2 all-reduces;
    # in graph mode at the eager first step and the capture only; and the
    # gathers of get_states in _run
    comm = m._step_communicator()
    calls = 2 if use_graph else 6
    assert comm.counts == {"all_reduce": 2 * (policy is not None) * calls,
                           "all_gather": 6 * calls + 6,
                           "reduce_scatter": 6 * calls, "broadcast": 0}
