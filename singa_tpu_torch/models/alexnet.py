"""AlexNet on the port's layer API.

Counterpart of ``singa_tpu/models/alexnet.py``: five convs at 224 px
(11x11/s4 first), three 2x2 max-pools and a 3x3/s2 average pool, then
FC 9216 -> 4096 -> 4096 -> classes with a ``Dropout`` (ratio 0.5) before
each of the first two, and the same state names.
"""

from .. import layer, model
from . import TrainStepMixin


class AlexNet(model.Model, TrainStepMixin):

    def __init__(self, num_classes=10, num_channels=1):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        self.conv1 = layer.Conv2d(64, 11, stride=4, padding=2)
        self.conv2 = layer.Conv2d(192, 5, padding=2)
        self.conv3 = layer.Conv2d(384, 3, padding=1)
        self.conv4 = layer.Conv2d(256, 3, padding=1)
        self.conv5 = layer.Conv2d(256, 3, padding=1)
        self.linear1 = layer.Linear(4096)
        self.linear2 = layer.Linear(4096)
        self.linear3 = layer.Linear(num_classes)
        self.pooling1 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling2 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling3 = layer.MaxPool2d(2, 2, padding=0)
        self.avg_pooling1 = layer.AvgPool2d(3, 2, padding=0)
        self.relu1 = layer.ReLU()
        self.relu2 = layer.ReLU()
        self.relu3 = layer.ReLU()
        self.relu4 = layer.ReLU()
        self.relu5 = layer.ReLU()
        self.relu6 = layer.ReLU()
        self.relu7 = layer.ReLU()
        self.flatten = layer.Flatten()
        self.dropout1 = layer.Dropout()
        self.dropout2 = layer.Dropout()
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        y = self.pooling1(self.relu1(self.conv1(x)))
        y = self.pooling2(self.relu2(self.conv2(y)))
        y = self.relu3(self.conv3(y))
        y = self.relu4(self.conv4(y))
        y = self.avg_pooling1(self.relu5(self.conv5(y)))
        y = self.flatten(y)
        y = self.dropout1(y)
        y = self.relu6(self.linear1(y))
        y = self.dropout2(y)
        y = self.relu7(self.linear2(y))
        return self.linear3(y)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                        rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


__all__ = ["AlexNet", "create_model"]
