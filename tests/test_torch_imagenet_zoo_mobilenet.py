"""MobileNetV2 0.25 of the port's ImageNet zoo held against the JAX package on
the CPU, step by step: each of 3 graphed port steps from the JAX
package's states after the step before (its eval and archives:
``tests/test_torch_imagenet_zoo_eval.py``). The setting, and why step by
step: ``tests/test_torch_imagenet_zoo.py``.
"""

import pytest

from singa_tpu import tensor as jtensor

from singa_tpu_torch.autograd_base import CTX as TCTX

from test_torch_imagenet_zoo import stepwise_case


@pytest.fixture(autouse=True)
def _port_eval_after():
    yield
    TCTX.training = False


@pytest.fixture(autouse=True)
def _no_jax_weight_draws(monkeypatch):
    monkeypatch.setattr(jtensor.Tensor, "gaussian",
                        lambda self, mean=0.0, std=1.0: self)


def test_each_sgd_step_matches_jax():
    stepwise_case("mobilenetv2")
