"""The port stands alone: no module of ``singa_tpu_torch`` imports JAX or
the JAX package, and its default device is the card or an error -- never
a silent CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "singa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "singa_tpu")


def _forbidden(name):
    return name is not None and any(
        name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.level == 0 and \
                _forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import singa_tpu_torch, singa_tpu_torch.cuda_build\n"
        "from singa_tpu_torch.models import resnet\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'singa_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda_or_raises(monkeypatch):
    from singa_tpu_torch import device
    monkeypatch.setattr(device, "_default_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.get_default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.create_cuda_gpu()
    # and a tensor made without a device does not land on the CPU
    from singa_tpu_torch.tensor import Tensor
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tensor(shape=(2,))


def test_cpu_only_when_asked():
    from singa_tpu_torch import device
    dev = device.create_cpu_device()
    assert dev.torch_device.type == "cpu"
    if torch.cuda.is_available():
        assert device.get_default_device().torch_device.type == "cuda"
