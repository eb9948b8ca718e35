"""Model zoo of the port (counterpart of ``singa_tpu/models``): the MLP,
the LeNet-style CNN, AlexNet, the ResNet family, Xception and the
Transformer LM.

:class:`TrainStepMixin` is the shared ``dist_option`` dispatch of
``train_one_batch`` (``singa_tpu/models/__init__.py:12-44``). Only
``"plain"`` runs here: the other options are data-parallel drivers of
``DistOpt``, which is not ported yet.
"""


class TrainStepMixin:
    """Shared dist-option dispatch for ``train_one_batch``."""

    def _apply_optimizer(self, loss, dist_option="plain", spars=None,
                         rotation=None):
        if dist_option == "plain":
            self.optimizer(loss)
        elif dist_option in ("half", "fp16", "partialUpdate", "sparseTopK",
                             "sparseThreshold"):
            raise NotImplementedError(
                f"dist_option {dist_option!r} is a DistOpt driver; "
                "data-parallel training is not ported yet (ROADMAP: slice "
                "B)")
        else:
            raise ValueError(f"unknown dist_option {dist_option!r}")


from . import (mlp, cnn, alexnet, resnet, xceptionnet,  # noqa: F401,E402
               transformer)
