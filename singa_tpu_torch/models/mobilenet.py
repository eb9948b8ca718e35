"""MobileNetV2 on the port's layer API.

Counterpart of ``singa_tpu/models/mobilenet.py``: inverted residual
blocks (1x1 expand, 3x3 depthwise ``Conv2d(group=channels)``, 1x1
projection, each with a ``BatchNorm2d``), ReLU6 as ``autograd.clip(x, 0,
6)`` (so no BN meets a ReLU and no K2 tail runs), channels rounded to a
multiple of 8 under ``width_mult``, the global pool as
``autograd.reduce_mean``, and the same state names.
"""

from .. import autograd, layer, model
from . import TrainStepMixin


class ReLU6(layer.Layer):

    def forward(self, x):
        return autograd.clip(x, 0.0, 6.0)


class ConvBNReLU(layer.Layer):

    def __init__(self, planes, kernel_size=3, stride=1, group=1):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv = layer.Conv2d(planes, kernel_size, stride=stride,
                                 padding=pad, group=group, bias=False)
        self.bn = layer.BatchNorm2d()
        self.relu = ReLU6()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InvertedResidual(layer.Layer):

    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        seq = []
        if expand_ratio != 1:
            seq.append(ConvBNReLU(hidden, kernel_size=1))
        seq.append(ConvBNReLU(hidden, stride=stride, group=hidden))
        self.seq = seq
        self.project = layer.Conv2d(oup, 1, bias=False)
        self.project_bn = layer.BatchNorm2d()
        self.add = layer.Add()

    def forward(self, x):
        y = x
        for s in self.seq:
            y = s(y)
        y = self.project_bn(self.project(y))
        return self.add(y, x) if self.use_res else y


# (expand_ratio t, out channels c, repeats n, first stride s)
INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class MobileNetV2(model.Model, TrainStepMixin):

    def __init__(self, num_classes=10, num_channels=3, width_mult=1.0):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4

        def c(ch):  # round channels to a multiple of 8 (hardware-friendly)
            ch = int(ch * width_mult)
            return max(8, (ch + 4) // 8 * 8)

        self.stem = ConvBNReLU(c(32), stride=2)
        blocks = []
        inp = c(32)
        for t, ch, n, s in INVERTED_RESIDUAL_CFG:
            for i in range(n):
                blocks.append(InvertedResidual(inp, c(ch),
                                               s if i == 0 else 1, t))
                inp = c(ch)
        self.blocks = blocks
        self.head = ConvBNReLU(max(1280, c(1280)), kernel_size=1)
        self.dropout = layer.Dropout(0.2)
        self.fc = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = self.head(x)
        x = autograd.reduce_mean(x, axes=[2, 3], keepdims=0)
        return self.fc(self.dropout(x))

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                    rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, **kwargs):
    return MobileNetV2(**kwargs)


__all__ = ["MobileNetV2", "InvertedResidual", "ReLU6", "create_model"]
