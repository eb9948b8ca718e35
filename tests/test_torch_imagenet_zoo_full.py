"""The full-width ImageNet zoo of the port on the CPU: K2's tails per eval
forward.

``chip_smoke.py`` phase 19 holds the card's K2 launches per replayed
serving tick to these counts: one fused tail per frozen-BN -> ReLU pair
(VGG-16-BN 13; DenseNet-121 121: 58 dense layers x 2, 3 transitions, the
stem and the final BN; ShuffleNetV2 1.0 37: 3 down units x 3, 13 units x
2, the stem and the head; SqueezeNet 1.1 has no BN and MobileNetV2's BNs
meet ``clip``, so none). Each model runs one eval forward at a small
input (32 px; 64 for SqueezeNet), batch 1, with the epilogue enabled
(K2's plain version on the CPU). The state names of these factories are
the JAX package's, as the small configurations in
``tests/test_torch_imagenet_zoo*.py`` hold them (the same code).
"""

import numpy as np
import pytest

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.models import densenet as tdensenet
from singa_tpu_torch.models import mobilenet as tmobilenet
from singa_tpu_torch.models import shufflenet as tshufflenet
from singa_tpu_torch.models import squeezenet as tsqueezenet
from singa_tpu_torch.models import vgg as tvgg
from singa_tpu_torch.ops import fused_epilogue as tfe


FULL = {   # name: (port factory, input px, K2 tails per eval forward)
    "vgg16bn": (lambda: tvgg.create_model(depth=16, batch_norm=True), 32,
                13),
    "squeezenet11": (lambda: tsqueezenet.create_model(version="1.1"), 64,
                     0),
    "mobilenetv2": (lambda: tmobilenet.create_model(width_mult=1.0), 32,
                    0),
    "densenet121": (lambda: tdensenet.create_model(depth=121), 32, 121),
    "shufflenetv2_1.0": (lambda: tshufflenet.create_model(width="1.0"), 32,
                         37),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_tails_per_forward(name):
    """The K2 tails of one eval forward of the full-width model, the
    counts ``chip_smoke.py`` phase 19 holds the card's launches to."""
    make, size, tails = FULL[name]
    m = make()
    x = np.random.RandomState(1).randn(1, 3, size, size).astype(np.float32)
    m.compile([ttensor.Tensor(data=x, device=tdevice.create_cpu_device())],
              is_train=False)
    m.eval()
    tfe.fused_tails = 0
    with tfe.enabled_scope(True):
        out = m(ttensor.Tensor(data=x, device=tdevice.create_cpu_device())
                ).to_numpy()
    fused = tfe.fused_tails
    assert out.shape == (1, 10) and np.isfinite(out).all()
    assert fused == tails
