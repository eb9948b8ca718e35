"""Xception on the port's layer API.

Counterpart of ``singa_tpu/models/xceptionnet.py`` (``Block`` ``:8-69``,
``Xception`` ``:71-135``): 299 px input, widths 32...2048, the entry flow
(blocks 1-3), 8 middle-flow blocks of 728 and the exit flow, each block a
run of ReLU -> ``SeparableConv2d`` -> BN with a 1x1 skip conv + BN where
the shape changes, and a 10x10 max-pool as the global pool. A ``Block``
builds its layers at its first call from the input's channels, under the
JAX package's names (``block1.seq.0.depthwise.W``, ``block1.skipbn.scale``),
so weights cross between the packages.
"""

from .. import layer, model
from . import TrainStepMixin


class Block(layer.Layer):

    def __init__(self, out_filters, reps, strides=1,
                 padding=0, start_with_relu=True, grow_first=True):
        super().__init__()
        self.out_filters = out_filters
        self.reps = reps
        self.strides = strides
        self.padding = padding
        self.start_with_relu = start_with_relu
        self.grow_first = grow_first
        self.skip = None
        self.skipbn = None
        self._need_skip = None

    def initialize(self, x):
        in_filters = x.shape[1]
        self._need_skip = (self.out_filters != in_filters
                           or self.strides != 1)
        if self._need_skip:
            self.skip = layer.Conv2d(self.out_filters, 1,
                                     stride=self.strides, bias=False)
            self.skipbn = layer.BatchNorm2d()
        seq = []
        filters = in_filters
        if self.grow_first:
            seq.append(layer.ReLU())
            seq.append(layer.SeparableConv2d(self.out_filters, 3,
                                             stride=1, padding=1,
                                             bias=False))
            seq.append(layer.BatchNorm2d())
            filters = self.out_filters
        for _ in range(self.reps - 1):
            seq.append(layer.ReLU())
            seq.append(layer.SeparableConv2d(filters, 3, stride=1,
                                             padding=1, bias=False))
            seq.append(layer.BatchNorm2d())
        if not self.grow_first:
            seq.append(layer.ReLU())
            seq.append(layer.SeparableConv2d(self.out_filters, 3,
                                             stride=1, padding=1,
                                             bias=False))
            seq.append(layer.BatchNorm2d())
        if not self.start_with_relu:
            seq = seq[1:]
        else:
            seq[0] = layer.ReLU()
        if self.strides != 1:
            seq.append(layer.MaxPool2d(3, self.strides, self.padding + 1))
        self.seq = seq
        self.add = layer.Add()

    def forward(self, x):
        y = x
        for s in self.seq:
            y = s(y)
        if self._need_skip:
            skip = self.skipbn(self.skip(x))
        else:
            skip = x
        return self.add(y, skip)


class Xception(model.Model, TrainStepMixin):
    """Xception V1 at 299 px."""

    def __init__(self, num_classes=10, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 299
        self.dimension = 4

        self.conv1 = layer.Conv2d(32, 3, stride=2, padding=0, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.conv2 = layer.Conv2d(64, 3, stride=1, padding=1, bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu2 = layer.ReLU()

        self.block1 = Block(128, 2, 2, padding=0, start_with_relu=False)
        self.block2 = Block(256, 2, 2, padding=0)
        self.block3 = Block(728, 2, 2, padding=0)
        self.block4 = Block(728, 3, 1)
        self.block5 = Block(728, 3, 1)
        self.block6 = Block(728, 3, 1)
        self.block7 = Block(728, 3, 1)
        self.block8 = Block(728, 3, 1)
        self.block9 = Block(728, 3, 1)
        self.block10 = Block(728, 3, 1)
        self.block11 = Block(728, 3, 1)
        self.block12 = Block(1024, 2, 2, grow_first=False)

        self.conv3 = layer.SeparableConv2d(1536, 3, stride=1, padding=1)
        self.bn3 = layer.BatchNorm2d()
        self.relu3 = layer.ReLU()
        self.conv4 = layer.SeparableConv2d(2048, 3, stride=1, padding=1)
        self.bn4 = layer.BatchNorm2d()
        self.relu4 = layer.ReLU()
        self.globalpooling = layer.MaxPool2d(10, 1)
        self.flatten = layer.Flatten()
        self.fc = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def features(self, x):
        y = self.relu1(self.bn1(self.conv1(x)))
        y = self.relu2(self.bn2(self.conv2(y)))
        for i in range(1, 13):
            y = getattr(self, f"block{i}")(y)
        y = self.relu3(self.bn3(self.conv3(y)))
        y = self.relu4(self.bn4(self.conv4(y)))
        return y

    def logits(self, features):
        return self.fc(self.flatten(self.globalpooling(features)))

    def forward(self, x):
        return self.logits(self.features(x))

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                        rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, **kwargs):
    return Xception(**kwargs)


__all__ = ["Xception", "Block", "create_model"]
