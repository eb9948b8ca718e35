"""DenseNet on the port's layer API.

Counterpart of ``singa_tpu/models/densenet.py``: DenseNet-121/169/201/161
(``CFGS``; ``block_config``, ``growth_rate`` and ``num_init_features``
override them), pre-activation dense layers (BN -> ReLU -> 1x1 conv ->
BN -> ReLU -> 3x3 conv) whose output ``layer.Cat`` joins to their input,
transitions (BN -> ReLU -> 1x1 conv -> 2x2 ``AvgPool2d``), the global pool
as ``autograd.reduce_mean``, and the same state names. In serving every
BN -> ReLU pair is one K2 tail: 121 a forward for DenseNet-121 (58 dense
layers x 2, 3 transitions, the stem and the final BN).
"""

from .. import autograd, layer, model
from . import TrainStepMixin

CFGS = {
    121: (32, (6, 12, 24, 16)),
    169: (32, (6, 12, 32, 32)),
    201: (32, (6, 12, 48, 32)),
    161: (48, (6, 12, 36, 24)),
}


class DenseLayer(layer.Layer):
    """BN-ReLU-Conv1x1(bn_size*growth) -> BN-ReLU-Conv3x3(growth)."""

    def __init__(self, growth_rate, bn_size=4):
        super().__init__()
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.conv1 = layer.Conv2d(bn_size * growth_rate, 1, bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu2 = layer.ReLU()
        self.conv2 = layer.Conv2d(growth_rate, 3, padding=1, bias=False)
        self.cat = layer.Cat(axis=1)

    def forward(self, x):
        y = self.conv1(self.relu1(self.bn1(x)))
        y = self.conv2(self.relu2(self.bn2(y)))
        return self.cat([x, y])


class Transition(layer.Layer):

    def __init__(self, out_channels):
        super().__init__()
        self.bn = layer.BatchNorm2d()
        self.relu = layer.ReLU()
        self.conv = layer.Conv2d(out_channels, 1, bias=False)
        self.pool = layer.AvgPool2d(2, 2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(model.Model, TrainStepMixin):

    def __init__(self, depth=121, num_classes=10, num_channels=3,
                 num_init_features=None, bn_size=4, block_config=None,
                 growth_rate=None):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        growth, block_cfg = CFGS[depth]
        if block_config is not None:
            block_cfg = block_config
        if growth_rate is not None:
            growth = growth_rate
        if num_init_features is None:
            num_init_features = 96 if depth == 161 else 64
        self.conv0 = layer.Conv2d(num_init_features, 7, stride=2,
                                  padding=3, bias=False)
        self.bn0 = layer.BatchNorm2d()
        self.relu0 = layer.ReLU()
        self.pool0 = layer.MaxPool2d(3, 2, 1)
        blocks = []
        ch = num_init_features
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                blocks.append(DenseLayer(growth, bn_size))
                ch += growth
            if i != len(block_cfg) - 1:
                ch = ch // 2
                blocks.append(Transition(ch))
        self.blocks = blocks
        self.bn_final = layer.BatchNorm2d()
        self.relu_final = layer.ReLU()
        self.fc = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        x = self.pool0(self.relu0(self.bn0(self.conv0(x))))
        for b in self.blocks:
            x = b(x)
        x = self.relu_final(self.bn_final(x))
        x = autograd.reduce_mean(x, axes=[2, 3], keepdims=0)
        return self.fc(x)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                    rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, depth=121, **kwargs):
    return DenseNet(depth=depth, **kwargs)


__all__ = ["DenseNet", "DenseLayer", "Transition", "create_model"]
