"""The breadth of the port's API on the card: every public function of
``singa_tpu_torch.autograd`` forward and backward on CUDA tensors against
the same call on CPU tensors (``chip_smoke.py``'s op sweep, phase 19),
each output and gradient within 1e-5 of its largest value, TF32 off.

Marked ``cuda``: it skips with a reason where ``torch.cuda.is_available()``
is false. It imports only torch, the port and ``chip_smoke.py``, so it runs
on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_zoo.py -m cuda -q
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from singa_tpu_torch import device  # noqa: E402


@pytest.mark.cuda
def test_op_sweep_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = chip_smoke.op_sweep(device.create_cuda_gpu(0))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert len(worst) == len(chip_smoke.op_cases())
    assert max(worst.values()) <= chip_smoke.OP_TOL
