"""VGG on the port's layer API.

Counterpart of ``singa_tpu/models/vgg.py``: VGG-11/13/16/19 (``CFGS``),
3x3 convs with an optional ``BatchNorm2d`` after each (``batch_norm``),
2x2 max-pools, FC 4096 -> 4096 -> classes with a ``Dropout`` (0.5) after
each of the first two, 224 px, and the same state names.
"""

from .. import layer, model
from . import TrainStepMixin

CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
         512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(model.Model, TrainStepMixin):

    def __init__(self, depth=16, num_classes=10, num_channels=3,
                 batch_norm=False):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        feats = []
        for v in CFGS[depth]:
            if v == "M":
                feats.append(layer.MaxPool2d(2, 2))
            else:
                feats.append(layer.Conv2d(v, 3, padding=1,
                                          bias=not batch_norm))
                if batch_norm:
                    feats.append(layer.BatchNorm2d())
                feats.append(layer.ReLU())
        self.features = feats
        self.flatten = layer.Flatten()
        self.fc1 = layer.Linear(4096)
        self.relu1 = layer.ReLU()
        self.drop1 = layer.Dropout(0.5)
        self.fc2 = layer.Linear(4096)
        self.relu2 = layer.ReLU()
        self.drop2 = layer.Dropout(0.5)
        self.fc3 = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        for f in self.features:
            x = f(x)
        x = self.flatten(x)
        x = self.drop1(self.relu1(self.fc1(x)))
        x = self.drop2(self.relu2(self.fc2(x)))
        return self.fc3(x)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                    rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, depth=16, batch_norm=False, **kwargs):
    return VGG(depth=depth, batch_norm=batch_norm, **kwargs)


__all__ = ["VGG", "create_model"]
