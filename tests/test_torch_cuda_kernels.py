"""Kernel K2's CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: the kernel has no CPU mode, so each case skips with a
reason where ``torch.cuda.is_available()`` is false. This file imports
only torch and the port, so it runs on a GPU machine without JAX
(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

The kernel multiplies and adds without contraction (``__fmul_rn`` /
``__fadd_rn``), so its result is bitwise-equal to the plain version in
f32 and, rounded once from the same f32 value, in bf16.
"""

import pytest
import torch

from singa_tpu_torch.ops import fused_epilogue as tfe


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("residual", [False, True])
def test_cuda_kernel_matches_plain_version(layout, dtype, residual):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.manual_seed(0)
    shape = (3, 7, 5, 9) if layout == "NCHW" else (3, 5, 9, 7)
    c = shape[1] if layout == "NCHW" else shape[-1]
    x = torch.randn(shape, device="cuda").to(dtype)
    r = torch.randn(shape, device="cuda").to(dtype) if residual else None
    s = torch.rand(c, device="cuda") + 0.5
    b = torch.randn(c, device="cuda")
    before = dict(tfe.launches)
    if residual:
        got = tfe.scale_shift_add_relu(x, s, b, r, layout=layout)
        want = tfe.scale_shift_add_relu_reference(x, s, b, r, layout)
    else:
        got = tfe.scale_shift_relu(x, s, b, layout=layout)
        want = tfe.scale_shift_relu_reference(x, s, b, layout)
    torch.cuda.synchronize()
    key = tfe.variant(layout, residual)
    assert tfe.launches[key] == before[key] + 1
    assert torch.equal(got, want)
