"""LeNet-style CNN for 28x28 inputs on the port's layer API.

Counterpart of ``singa_tpu/models/cnn.py``: two 5x5 convs with a fused
ReLU (``Conv2d(activation="RELU")``), each followed by a 2x2 max-pool,
then Linear(500) -> ReLU -> Linear, with the same state names.
"""

from .. import layer, model
from . import TrainStepMixin


class CNN(model.Model, TrainStepMixin):

    def __init__(self, num_classes=10, num_channels=1):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 28
        self.dimension = 4
        self.conv1 = layer.Conv2d(20, 5, padding=0, activation="RELU")
        self.conv2 = layer.Conv2d(50, 5, padding=0, activation="RELU")
        self.linear1 = layer.Linear(500)
        self.linear2 = layer.Linear(num_classes)
        self.pooling1 = layer.MaxPool2d(2, 2, padding=0)
        self.pooling2 = layer.MaxPool2d(2, 2, padding=0)
        self.relu = layer.ReLU()
        self.flatten = layer.Flatten()
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        y = self.conv1(x)
        y = self.pooling1(y)
        y = self.conv2(y)
        y = self.pooling2(y)
        y = self.flatten(y)
        y = self.linear1(y)
        y = self.relu(y)
        return self.linear2(y)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                        rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, **kwargs):
    return CNN(**kwargs)


__all__ = ["CNN", "create_model"]
