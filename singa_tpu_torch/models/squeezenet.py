"""SqueezeNet 1.0 / 1.1 on the port's layer API.

Counterpart of ``singa_tpu/models/squeezenet.py``: ``Fire`` modules (a
1x1 squeeze conv, then 1x1 and 3x3 expand convs joined on the channels by
``layer.Cat``), a 1x1 classifier conv after a ``Dropout`` (0.5), and the
global pool as ``autograd.reduce_mean`` over the spatial axes; no BN, so
no K2 tail. The same state names.
"""

from .. import autograd, layer, model
from . import TrainStepMixin


class Fire(layer.Layer):

    def __init__(self, squeeze_planes, expand1x1_planes, expand3x3_planes):
        super().__init__()
        self.squeeze = layer.Conv2d(squeeze_planes, 1)
        self.squeeze_relu = layer.ReLU()
        self.expand1x1 = layer.Conv2d(expand1x1_planes, 1)
        self.expand1x1_relu = layer.ReLU()
        self.expand3x3 = layer.Conv2d(expand3x3_planes, 3, padding=1)
        self.expand3x3_relu = layer.ReLU()
        self.cat = layer.Cat(axis=1)

    def forward(self, x):
        x = self.squeeze_relu(self.squeeze(x))
        return self.cat([self.expand1x1_relu(self.expand1x1(x)),
                         self.expand3x3_relu(self.expand3x3(x))])


class SqueezeNet(model.Model, TrainStepMixin):

    def __init__(self, version="1.1", num_classes=10, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        if version == "1.0":
            self.stem = [layer.Conv2d(96, 7, stride=2), layer.ReLU(),
                         layer.MaxPool2d(3, 2)]
            self.blocks = [
                Fire(16, 64, 64), Fire(16, 64, 64), Fire(32, 128, 128),
                layer.MaxPool2d(3, 2),
                Fire(32, 128, 128), Fire(48, 192, 192),
                Fire(48, 192, 192), Fire(64, 256, 256),
                layer.MaxPool2d(3, 2),
                Fire(64, 256, 256),
            ]
        elif version == "1.1":
            self.stem = [layer.Conv2d(64, 3, stride=2), layer.ReLU(),
                         layer.MaxPool2d(3, 2)]
            self.blocks = [
                Fire(16, 64, 64), Fire(16, 64, 64),
                layer.MaxPool2d(3, 2),
                Fire(32, 128, 128), Fire(32, 128, 128),
                layer.MaxPool2d(3, 2),
                Fire(48, 192, 192), Fire(48, 192, 192),
                Fire(64, 256, 256), Fire(64, 256, 256),
            ]
        else:
            raise ValueError(f"unknown SqueezeNet version {version!r}")
        self.dropout = layer.Dropout(0.5)
        self.final_conv = layer.Conv2d(num_classes, 1)
        self.final_relu = layer.ReLU()
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        for f in self.stem:
            x = f(x)
        for b in self.blocks:
            x = b(x)
        x = self.final_relu(self.final_conv(self.dropout(x)))
        # global average pool over the remaining spatial extent
        return autograd.reduce_mean(x, axes=[2, 3], keepdims=0)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                    rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, version="1.1", **kwargs):
    return SqueezeNet(version=version, **kwargs)


__all__ = ["SqueezeNet", "Fire", "create_model"]
