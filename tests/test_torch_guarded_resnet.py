"""``bf16_mixed`` training of a ResNet(Bottleneck, [1, 1, 1, 1]) at 224 px,
batch 2, in the port against the JAX package on the same numpy weights
and batch, 3 guarded SGD steps (lr 0.002). The setup, the tolerances and
their reasons are ``test_torch_guarded_training.py``'s; the ResNet has a
file of its own because the JAX package's compile of it takes most of a
minute on one core."""

from test_torch_guarded_training import (  # noqa: F401 (the fixture)
    _train_mode_off, check_training_matches_jax)


def test_bf16_mixed_resnet_training_matches_jax():
    check_training_matches_jax("resnet")
