"""MLP on the port's layer API.

Counterpart of ``singa_tpu/models/mlp.py``: Linear -> ReLU -> Linear with
the same state names (``MLP.linear1.W``), trained by softmax cross
entropy. It takes flattened inputs of ``data_size`` features.
"""

from .. import layer, model
from . import TrainStepMixin


class MLP(model.Model, TrainStepMixin):

    def __init__(self, data_size=10, perceptron_size=100, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.dimension = 2
        self.relu = layer.ReLU()
        self.linear1 = layer.Linear(perceptron_size)
        self.linear2 = layer.Linear(num_classes)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, inputs):
        y = self.linear1(inputs)
        y = self.relu(y)
        return self.linear2(y)

    def train_one_batch(self, x, y, dist_option="plain", spars=None,
                        rotation=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        self._apply_optimizer(loss, dist_option, spars, rotation)
        return out, loss


def create_model(pretrained=False, **kwargs):
    return MLP(**kwargs)


__all__ = ["MLP", "create_model"]
