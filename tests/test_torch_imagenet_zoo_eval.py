"""MobileNetV2 0.25 and ShuffleNetV2 0.5 of the port's ImageNet zoo,
trained one graphed step in the port, evaluated through K2's plain version
against the JAX package on the same states, and their archives loaded in
the other package (``tests/test_torch_imagenet_zoo.py``'s
``_eval_and_archives``). Their training is held step by step in
``tests/test_torch_imagenet_zoo_{mobilenet,shufflenet}.py``.
"""

import pytest

from singa_tpu import tensor as jtensor

from singa_tpu_torch.autograd_base import CTX as TCTX

from test_torch_imagenet_zoo import trained_eval_case


@pytest.fixture(autouse=True)
def _port_eval_after():
    yield
    TCTX.training = False


@pytest.fixture(autouse=True)
def _no_jax_weight_draws(monkeypatch):
    monkeypatch.setattr(jtensor.Tensor, "gaussian",
                        lambda self, mean=0.0, std=1.0: self)


@pytest.mark.parametrize("name", ["mobilenetv2", "shufflenetv2"])
def test_trained_eval_and_archives_match_jax(name, tmp_path):
    trained_eval_case(name, tmp_path)
