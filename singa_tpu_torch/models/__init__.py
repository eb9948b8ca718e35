"""Model zoo of the port (counterpart of ``singa_tpu/models``): the MLP,
the LeNet-style CNN, AlexNet, the ResNet family, Xception, the ImageNet
CNNs VGG, SqueezeNet, MobileNetV2, DenseNet and ShuffleNetV2, and the
Transformer LM. GAN, RBM, char-RNN and the QA bot are not ported yet
(ROADMAP.md, slice E).

:class:`TrainStepMixin` is the shared ``dist_option`` dispatch of
``train_one_batch`` (``singa_tpu/models/__init__.py:12-44``): ``"plain"``
steps the optimizer; ``"half"``, ``"fp16"``, ``"partialUpdate"``,
``"sparseTopK"`` and ``"sparseThreshold"`` run the ``opt.DistOpt``
drivers, and run as ``"plain"`` under an optimizer that is not a
``DistOpt``, as in the JAX package.
"""


class TrainStepMixin:
    """Shared dist-option dispatch for ``train_one_batch`` (reference
    ``examples/cnn/model/cnn.py:52-70``)."""

    def _apply_optimizer(self, loss, dist_option="plain", spars=None,
                         rotation=None):
        if dist_option == "plain" or not hasattr(
                self.optimizer, "backward_and_update_half"):
            self.optimizer(loss)
        elif dist_option == "half":
            self.optimizer.backward_and_update_half(loss)
        elif dist_option == "fp16":
            # the IEEE-fp16 wire (reference synchHalf) with its clip
            self.optimizer.backward_and_update_half(
                loss, clipping=True, dtype="float16")
        elif dist_option == "partialUpdate":
            self.optimizer.backward_and_partial_update(
                loss, rotation=rotation)
        elif dist_option == "sparseTopK":
            self.optimizer.backward_and_sparse_update(
                loss, topK=True, spars=spars)
        elif dist_option == "sparseThreshold":
            self.optimizer.backward_and_sparse_update(
                loss, topK=False, spars=spars)
        else:
            raise ValueError(f"unknown dist_option {dist_option!r}")


from . import (mlp, cnn, alexnet, resnet, xceptionnet,  # noqa: F401,E402
               transformer, vgg, squeezenet, mobilenet, densenet,
               shufflenet)
