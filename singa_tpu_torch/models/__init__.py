"""Model zoo of the port (counterpart of ``singa_tpu/models``): the ResNet
family in this slice."""

from . import resnet  # noqa: F401
