"""ShuffleNetV2 on the port's layer API.

Counterpart of ``singa_tpu/models/shufflenet.py``: widths 0.5/1.0/1.5/2.0
(``CFGS``), stride-1 units (the channels split in half by
``autograd.split``, one half through 1x1 -> depthwise 3x3 -> 1x1 with BNs,
``layer.Cat`` of the two, a channel shuffle) and stride-2 units (both
branches transformed), the global pool as ``autograd.reduce_mean``, and
the same state names. In serving each BN -> ReLU pair is one K2 tail: 37
a forward at width 1.0 (3 down units x 3, 13 units x 2, the stem and the
head).
"""

from .. import autograd, layer, model
from . import TrainStepMixin

# width multiplier -> (stage repeats, stage out-channels, final conv)
CFGS = {
    "0.5": ((4, 8, 4), (48, 96, 192), 1024),
    "1.0": ((4, 8, 4), (116, 232, 464), 1024),
    "1.5": ((4, 8, 4), (176, 352, 704), 1024),
    "2.0": ((4, 8, 4), (244, 488, 976), 2048),
}


def channel_shuffle(x, groups=2):
    b, c, h, w = x.shape
    x = autograd.reshape(x, (b, groups, c // groups, h, w))
    x = autograd.transpose(x, (0, 2, 1, 3, 4))
    return autograd.reshape(x, (b, c, h, w))


class ShuffleUnit(layer.Layer):
    """Stride-1 unit: split channels in half, transform one branch,
    concat, shuffle."""

    def __init__(self, channels):
        super().__init__()
        half = channels // 2
        self.conv1 = layer.Conv2d(half, 1, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.dwconv = layer.Conv2d(half, 3, padding=1, group=half,
                                   bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.conv3 = layer.Conv2d(half, 1, bias=False)
        self.bn3 = layer.BatchNorm2d()
        self.relu3 = layer.ReLU()
        self.cat = layer.Cat(axis=1)

    def forward(self, x):
        x1, x2 = autograd.split(x, 1, num_output=2)
        y = self.relu1(self.bn1(self.conv1(x2)))
        y = self.bn2(self.dwconv(y))
        y = self.relu3(self.bn3(self.conv3(y)))
        return channel_shuffle(self.cat([x1, y]))


class ShuffleDownUnit(layer.Layer):
    """Stride-2 unit: both branches transform, spatial size halves,
    channels grow to ``out_channels``."""

    def __init__(self, out_channels):
        super().__init__()
        half = out_channels // 2
        # branch 1 (shortcut): dw3x3 s2 + 1x1
        self.b1_dw = None  # depthwise needs in_channels; deferred
        self.half = half
        self.b1_bn1 = layer.BatchNorm2d()
        self.b1_conv = layer.Conv2d(half, 1, bias=False)
        self.b1_bn2 = layer.BatchNorm2d()
        self.b1_relu = layer.ReLU()
        # branch 2: 1x1 + dw3x3 s2 + 1x1
        self.b2_conv1 = layer.Conv2d(half, 1, bias=False)
        self.b2_bn1 = layer.BatchNorm2d()
        self.b2_relu1 = layer.ReLU()
        self.b2_dw = layer.Conv2d(half, 3, stride=2, padding=1,
                                  group=half, bias=False)
        self.b2_bn2 = layer.BatchNorm2d()
        self.b2_conv3 = layer.Conv2d(half, 1, bias=False)
        self.b2_bn3 = layer.BatchNorm2d()
        self.b2_relu3 = layer.ReLU()
        self.cat = layer.Cat(axis=1)

    def initialize(self, x):
        inp = x.shape[1]
        self.b1_dw = layer.Conv2d(inp, 3, stride=2, padding=1, group=inp,
                                  bias=False)

    def forward(self, x):
        s = self.b1_relu(self.b1_bn2(self.b1_conv(
            self.b1_bn1(self.b1_dw(x)))))
        y = self.b2_relu1(self.b2_bn1(self.b2_conv1(x)))
        y = self.b2_bn2(self.b2_dw(y))
        y = self.b2_relu3(self.b2_bn3(self.b2_conv3(y)))
        return channel_shuffle(self.cat([s, y]))


class ShuffleNetV2(model.Model, TrainStepMixin):

    def __init__(self, width="1.0", num_classes=10, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        repeats, channels, final_ch = CFGS[str(width)]
        self.stem_conv = layer.Conv2d(24, 3, stride=2, padding=1,
                                      bias=False)
        self.stem_bn = layer.BatchNorm2d()
        self.stem_relu = layer.ReLU()
        self.stem_pool = layer.MaxPool2d(3, 2, 1)
        blocks = []
        for n, ch in zip(repeats, channels):
            blocks.append(ShuffleDownUnit(ch))
            for _ in range(n - 1):
                blocks.append(ShuffleUnit(ch))
        self.blocks = blocks
        self.head_conv = layer.Conv2d(final_ch, 1, bias=False)
        self.head_bn = layer.BatchNorm2d()
        self.head_relu = layer.ReLU()
        self.fc = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        x = self.stem_pool(self.stem_relu(self.stem_bn(self.stem_conv(x))))
        for b in self.blocks:
            x = b(x)
        x = self.head_relu(self.head_bn(self.head_conv(x)))
        x = autograd.reduce_mean(x, axes=[2, 3], keepdims=0)
        return self.fc(x)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                    rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, width="1.0", **kwargs):
    return ShuffleNetV2(width=width, **kwargs)


__all__ = ["ShuffleNetV2", "ShuffleUnit", "ShuffleDownUnit",
           "create_model", "channel_shuffle"]
