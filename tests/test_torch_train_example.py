"""The port's training entry point, ``singa_tpu_torch/examples/
train_cnn.py``, run on the CPU (``--cpu``) at a small size: ResNet
(Bottleneck, [1, 1, 1, 1]) in place of ResNet-50, batch 2, on synthetic
data and on CIFAR-10 files the test writes in the pickle wire format."""

import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest

from singa_tpu_torch.autograd_base import CTX
from singa_tpu_torch.models import resnet as tresnet

SCRIPT = Path(__file__).resolve().parents[1] / "singa_tpu_torch" / \
    "examples" / "train_cnn.py"


@pytest.fixture
def example(monkeypatch):
    spec = importlib.util.spec_from_file_location("port_train_cnn", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(tresnet, "create_model", lambda **kw: tresnet.ResNet(
        tresnet.Bottleneck, [1, 1, 1, 1], **kw))
    yield mod
    CTX.training = False


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_synthetic_training_runs(example, capsys, layout):
    model = example.main(["resnet", "synthetic", "--cpu", "--bs", "2",
                          "--iters", "2", "--epochs", "1", "--fused-optim",
                          "--layout", layout])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert "Training loss" in out and "Evaluation accuracy" in out
    assert model.optimizer.fused
    assert float(model.optimizer.get_states()["step_counter"]) == 2


def test_cifar10_training_runs(example, capsys, tmp_path):
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (4, 3072))
                         .astype(np.uint8),
                         "labels": rng.randint(0, 10, 4).tolist()}, f)
    model = example.main(["resnet", "cifar10", "--data-dir", str(tmp_path),
                          "--cpu", "--bs", "2", "--max-batches", "2",
                          "--epochs", "1"])
    out = capsys.readouterr().out
    assert "Training loss" in out and "Evaluation accuracy" in out
    assert float(model.optimizer.get_states()["step_counter"]) == 2


@pytest.mark.parametrize("argv", [["cnn"], ["resnet", "mnist"],
                                  ["resnet", "-p", "bf16_mixed"],
                                  ["resnet", "--dist"],
                                  ["resnet", "--mesh", "2x1"],
                                  ["resnet", "--resilient"]], ids=str)
def test_what_is_not_ported_names_the_roadmap(example, argv):
    """Each case is refused naming ROADMAP.md, except ``-p bf16_mixed``,
    which is ported now: ``_refuse`` lets it through (its training run is
    ``test_bf16_mixed_cifar10_training_runs``)."""
    if argv == ["resnet", "-p", "bf16_mixed"]:
        assert example._refuse(example.build_parser().parse_args(
            argv + ["--cpu"])) is None
        return
    with pytest.raises(SystemExit, match="ROADMAP"):
        example.main(argv + ["--cpu"])
