"""The port's ``examples/train_mlp.py`` and ``examples/benchmark.py`` on
the CPU at a tiny size, called in-process through ``main(argv)``. Each
ends with the kind of output ``tests/test_examples.py`` expects of the
JAX examples: per-epoch loss lines, and the ``Throughput`` line.

The benchmark runs ResNet-18 at 224 px: the ResNets end in a 7x7 average
pool, which the port refuses on a smaller final map (torch raises), where
the JAX package's pool returns an empty one."""

import importlib.util
from pathlib import Path

import numpy as np

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

EXAMPLES = Path(__file__).resolve().parents[1] / "singa_tpu_torch" / \
    "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_mlp(capsys):
    history = _example("train_mlp").main(["--cpu", "--epochs", "2",
                                          "--bs", "32"])
    out = capsys.readouterr().out
    assert "loss" in out.lower(), out[-500:]
    assert out.count("epoch ") == 2
    (l0, a0), (l1, a1) = history
    assert np.isfinite([l0, l1]).all() and l1 < l0 and a1 > 0.8


def test_benchmark(capsys):
    res = _example("benchmark").main(
        ["--cpu", "--bs", "2", "--iters", "2", "--warmup", "1",
         "--depth", "18", "--size", "224"])
    out = capsys.readouterr().out
    assert "Throughput" in out, out[-500:]
    assert res["throughput"] > 0 and res["iter_s"] > 0
