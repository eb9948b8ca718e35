"""The port's ``singa_tpu_torch/examples/train_cnn.py`` across the JAX
example's single-device surface, on the CPU (``--cpu``, one epoch, the
smallest batch): every model, CIFAR-100 and MNIST files the test writes,
``--npz``, ``-p bfloat16`` and the ``space_to_depth`` stem; its parser
accepts every model, dataset, precision, stem and layout the JAX
example's accepts, and it refuses exactly the distributed, resilient and
telemetry flags, each naming ROADMAP.md.
"""

import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu_torch.autograd_base import CTX

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "singa_tpu_torch" / "examples" / "train_cnn.py"
JAX_SCRIPT = ROOT / "examples" / "train_cnn.py"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def example():
    yield _load(SCRIPT, "port_train_cnn_zoo")
    CTX.training = False


def _run(example, capsys, argv):
    model = example.main(argv + ["--cpu", "--epochs", "1"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert "Training loss" in out and "Evaluation accuracy" in out
    losses = [float(line.split("=")[1].split(",")[0]) for line in
              out.splitlines() if line.startswith("Training loss")]
    assert len(losses) == 1 and np.isfinite(losses[0])
    return model, out


def _write_mnist(root, n_train=4, n_test=2):
    import struct
    rng = np.random.RandomState(0)
    for split, n in (("train", n_train), ("t10k", n_test)):
        (root / f"{split}-images-idx3-ubyte").write_bytes(
            struct.pack(">4i", 2051, n, 28, 28)
            + rng.randint(0, 256, (n, 28, 28)).astype(np.uint8).tobytes())
        (root / f"{split}-labels-idx1-ubyte").write_bytes(
            struct.pack(">2i", 2049, n)
            + rng.randint(0, 10, n).astype(np.uint8).tobytes())


def _write_cifar100(root, n=4):
    d = root / "cifar-100-python"
    d.mkdir()
    rng = np.random.RandomState(1)
    for name in ("train", "test"):
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072))
                         .astype(np.uint8),
                         "fine_labels": rng.randint(0, 100, n).tolist(),
                         "coarse_labels": rng.randint(0, 20, n).tolist()},
                        f)


def test_cnn_on_mnist(example, capsys, tmp_path):
    _write_mnist(tmp_path)
    model, out = _run(example, capsys, ["cnn", "mnist", "--data-dir",
                                        str(tmp_path), "--bs", "2",
                                        "--fused-optim"])
    assert type(model).__name__ == "CNN"
    assert float(model.optimizer.get_states()["step_counter"]) == 2
    assert "1 capture(s), 1 replays on cpu" in out


def test_mlp_on_cifar100(example, capsys, tmp_path):
    _write_cifar100(tmp_path)
    model, _ = _run(example, capsys, ["mlp", "cifar100", "--data-dir",
                                      str(tmp_path), "--bs", "2"])
    assert tuple(model.linear1.W.shape) == (3072, 100)
    assert tuple(model.linear2.W.shape) == (100, 100)   # 100 classes


@pytest.mark.parametrize("name,cls,size", [
    ("alexnet", "AlexNet", 224), ("xceptionnet", "Xception", 299)])
def test_synthetic_at_the_models_size(example, capsys, name, cls, size):
    model, out = _run(example, capsys, [name, "synthetic", "--bs", "1",
                                        "--iters", "2", "--fused-optim"])
    assert type(model).__name__ == cls and model.input_size == size
    assert float(model.optimizer.get_states()["step_counter"]) == 2


def test_resnet_space_to_depth_pure_bf16(example, capsys):
    model, _ = _run(example, capsys, [
        "resnet", "synthetic", "--bs", "1", "--iters", "2", "--stem",
        "space_to_depth", "-p", "bfloat16", "--fused-optim"])
    assert model.conv1.handle.space_to_depth
    assert model._policy is None
    assert model.conv1.W.dtype == torch.bfloat16     # follows the input
    assert model.bn1.scale.dtype == torch.float32


def test_npz_and_layout_auto(example, capsys, tmp_path):
    rng = np.random.RandomState(2)
    path = tmp_path / "d.npz"
    np.savez(path, x=rng.randn(10, 1, 28, 28).astype(np.float32),
             y=rng.randint(0, 3, 10))
    model, out = _run(example, capsys, ["cnn", "--npz", str(path), "--bs",
                                        "3", "--layout", "auto"])
    assert tuple(model.linear2.W.shape) == (500, 3)  # classes from y
    assert float(model.optimizer.get_states()["step_counter"]) == 3


def test_parser_accepts_what_the_jax_example_accepts(example):
    mine, ref = example.build_parser(), _load(JAX_SCRIPT,
                                              "jax_train_cnn").build_parser()

    def choices(ap):
        return {a.dest: set(a.choices) for a in ap._actions if a.choices}
    assert choices(mine) == choices(ref)
    assert {a.dest for a in mine._actions} == {a.dest for a in ref._actions}
    assert mine.get_default("model") == ref.get_default("model") == "cnn"


REFUSED = [["--dist"], ["--mesh", "2x1"], ["--fsdp"], ["--bucket-mb", "4"],
           ["--no-overlap"], ["--resilient"], ["--ckpt-dir", "c"],
           ["--save-every", "5"], ["--profile-every", "2"],
           ["--anomaly-factor", "3"], ["--telemetry", "t"]]


@pytest.mark.parametrize("flag", REFUSED, ids=lambda f: f[0])
def test_refused_flags_name_the_roadmap(example, flag):
    """Each flag is refused naming ROADMAP.md, except the data-parallel
    ones ported since (``--dist``, ``--bucket-mb``, ``--no-overlap``,
    ``--mesh DxM``, ``--fsdp``), which ``_refuse`` lets through (their
    runs are ``tests/test_torch_dist_example.py``, ``--mesh 2x2`` among
    them); one process cannot tile a 2 x 2 mesh, which declines naming
    the devices it has."""
    if flag[0] in ("--dist", "--bucket-mb", "--no-overlap", "--mesh",
                   "--fsdp"):
        assert example._refuse(example.build_parser().parse_args(
            ["cnn"] + flag + ["--cpu"])) is None
        if flag[0] != "--mesh":
            return
        assert example._refuse(example.build_parser().parse_args(
            ["cnn", "--mesh", "2x2", "--cpu"])) is None
        from singa_tpu_torch.parallel.gspmd import ShardingDecline
        with pytest.raises(ShardingDecline, match="cannot tile the 1"):
            example.main(["cnn", "--mesh", "2x2", "--cpu"])
        return
    with pytest.raises(SystemExit, match="ROADMAP.md") as e:
        example.main(["cnn"] + flag + ["--cpu"])
    assert "slice E" in str(e.value) and flag[0] in str(e.value)
