"""``singa_tpu_torch/examples/train_cnn.py --dist`` on the CPU.

``train_cnn.py mlp --npz ... --dist --cpu --max-batches 2`` runs at
world 2 through ``torchrun``'s variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``: two processes of
``tests/torch_dist_ranks.py``, ``example`` case, started once for the
module, gloo) and at world 1 without them. Each rank trains on its half of
every global batch of 16; both see the same (mean) losses and keep
bitwise-equal replicas, only rank 0 prints, and the run matches the
world-1 run within rtol 1e-5 (the mean of two half-batch means against
the full batch's mean differs by rounding only). ``--mesh 2x1 --fsdp``
(a plain SGD, no ``--dist``) runs the same two ranks through the train
mesh and ZeRO/FSDP: bitwise the ``--dist`` run (two ranks sum a + b
exactly, and the update is elementwise). ``--mesh 2x2 --fsdp`` at four
ranks: the two model ranks of each data coordinate train replicas on the
same rows (the MLP announces no tensor-parallel spec), bitwise the
``--dist`` run too.
"""

import numpy as np
import pytest

import torch_dist_ranks as ranks

ARGV = ["mlp", "--dist", "--cpu", "--max-batches", "2", "--epochs", "1",
        "--bs", "16", "--fused-optim"]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    rng = np.random.RandomState(0)
    path = tmp_path_factory.mktemp("data") / "tiny.npz"
    np.savez(path, x=rng.randn(80, 1, 8, 8).astype(np.float32),
             y=rng.randint(0, 10, 80).astype(np.int32))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, npz):
    inputs = {"argv": np.asarray(ARGV + ["--npz", str(npz)])}
    two = ranks.launch("example", 2, inputs,
                       tmp_path_factory.mktemp("example2"),
                       torchrun_env=True)
    one = ranks.launch("example", 1, inputs,
                       tmp_path_factory.mktemp("example1"))
    return two, one


def _states(out):
    return {k: v for k, v in out.items() if k.startswith("example/")}


def test_two_ranks_through_torchrun_variables(runs):
    (outs, logs), ((one,), _) = runs
    assert len(outs[0]["losses"]) == 2
    np.testing.assert_array_equal(outs[1]["losses"], outs[0]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], one["losses"], rtol=1e-5)
    assert float(outs[0]["example/opt/step_counter"]) == 2
    for k, v in _states(outs[0]).items():
        np.testing.assert_array_equal(_states(outs[1])[k], v, err_msg=k)
        np.testing.assert_allclose(v, one[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert "data-parallel world 2" in logs[0]
    assert "Training loss" in logs[0] and "Evaluation accuracy" in logs[0]
    assert "Training loss" not in logs[1] and "device:" not in logs[1]


def test_one_rank_without_torchrun(runs):
    _, ((one,), (log,)) = runs
    assert "data-parallel world 1" in log and "Evaluation accuracy" in log
    assert float(one["example/opt/step_counter"]) == 2
    assert np.all(np.isfinite(one["losses"]))


def test_two_ranks_under_the_mesh_and_fsdp(runs, tmp_path_factory, npz):
    argv = [a for a in ARGV if a != "--dist"] + [
        "--mesh", "2x1", "--fsdp", "--npz", str(npz)]
    outs, logs = ranks.launch("example", 2, {"argv": np.asarray(argv)},
                              tmp_path_factory.mktemp("example_fsdp"),
                              torchrun_env=True)
    (dist, _), _ = runs
    for o in outs:
        np.testing.assert_array_equal(o["losses"], dist[0]["losses"])
        want = _states(dist[0])
        assert sorted(_states(o)) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(_states(o)[k], v, err_msg=k)
    assert "GSPMD train mesh=data2xmodel1 fsdp=data" in logs[0]
    assert "Evaluation accuracy" in logs[0] and "Training loss" not in logs[1]


def test_four_ranks_under_a_2x2_mesh(runs, tmp_path_factory, npz):
    argv = [a for a in ARGV if a != "--dist"] + [
        "--mesh", "2x2", "--fsdp", "--npz", str(npz)]
    outs, logs = ranks.launch("example", 4, {"argv": np.asarray(argv)},
                              tmp_path_factory.mktemp("example_2x2"),
                              torchrun_env=True)
    (dist, _), _ = runs
    want = _states(dist[0])
    for o in outs:
        np.testing.assert_array_equal(o["losses"], dist[0]["losses"])
        assert sorted(_states(o)) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(_states(o)[k], v, err_msg=k)
    assert "GSPMD train mesh=data2xmodel2 fsdp=data" in logs[0]
