"""Rank processes of the port's data-parallel CPU tests.

:func:`launch` starts ``world`` processes of this file at once. Each joins
one gloo process group through a file store in the work directory
(``parallel.communicator.init_process``, 60 s timeout), runs
``CASES[case]`` as its rank on the numpy arrays the test wrote to
``inputs.npz`` and writes what it measured to ``rank<r>.npz``; its output
goes to ``rank<r>.log``. The processes are waited for with one deadline,
and a rank that fails or hangs fails the launch (every rank is killed).
This file imports neither JAX nor the JAX package, so a rank starts in
about two seconds; the tests hold the results against the JAX package in
their own process.

    python tests/torch_dist_ranks.py CASE RANK WORLD WORKDIR
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

# dist_option -> (spars, steps), as tests/test_parallel.py::TestDistOptions
OPTIONS = {"plain": (None, 6), "half": (None, 6), "fp16": (None, 6),
           "partialUpdate": (None, 10), "sparseTopK": (0.3, 10),
           "sparseThreshold": (1e-3, 10)}
# DistOpt settings held bitwise against the streaming reduction
BUCKETINGS = {"bucket4": {"bucket_mb": 4}, "bucket_tiny": {"bucket_mb": 0.001},
              "no_overlap": {"overlap": False},
              "bucket4_no_overlap": {"bucket_mb": 4, "overlap": False}}
GUARD_STEPS = 5
POISONED = 2          # the step whose batch holds a NaN on rank 1
# the MLP of tests/test_gspmd_train.py under each spelling: a DistOpt
# without a mesh, compile(mesh=) with a DistOpt and with a plain SGD,
# DistOpt(zero=True), compile(fsdp_axis="data") with a plain SGD
GSPMD_RUNS = ("dist", "mesh_dist", "mesh_plain", "zero", "fsdp_plain")
GSPMD_STEPS = 3
DROP_STEPS = 3
DROP_SEED = 5         # every rank's device generator (the dropout masks)
# the Transformer LM on a mesh: tests/test_transformer.py's shapes
LM_KW = dict(d_model=32, n_heads=2, n_layers=2, max_len=64)
LM_STEPS = 8
# name -> the mesh (MeshConfig degrees) and the model's settings; the
# tp_sp mesh takes four ranks, the others two, and rematerialises its
# blocks (the recompute replays the ring's sends and the TP all-reduces)
LM_RUNS = {
    "tp": dict(model=2, vocab=31),
    "sp_ring": dict(seq=2, vocab=31, seq_axis="seq", seq_mode="ring"),
    "sp_ulysses": dict(seq=2, vocab=31, seq_axis="seq", seq_mode="ulysses"),
    "tp_v32": dict(model=2, vocab=32),
    "tp_v32_fused": dict(model=2, vocab=32, fused_head_chunk=8),
    "tp_sp": dict(model=2, seq=2, vocab=31, seq_axis="seq",
                  seq_mode="ring", remat=True),
    # the MoE LM (tests/test_moe.py's: 4 experts) on an expert mesh; the
    # capacity is drop-free (cf = E) so that a rank's capacity, from its
    # local tokens, drops what the dense run's drops: nothing
    "moe_ep2": dict(expert=2, vocab=31, moe=4, moe_capacity_factor=4.0,
                    d_model=16),
    "moe_ep2_fused": dict(expert=2, vocab=31, moe=4,
                          moe_capacity_factor=4.0, d_model=16,
                          fused_head_chunk=8),
}
# the runs whose archive is restored into a fresh model of the mesh:
# name -> the archive's file name
ARCHIVE_RUNS = {"tp_v32_fused": "tp.zip", "moe_ep2_fused": "moe.zip"}
# the MoE net of tests/test_moe.py::MoENet on expert meshes, by world:
# name -> the mesh's degrees; "zero" adds ZeRO/FSDP over data on top of the
# expert cut, its DistOpt summing over ("data", "expert", "seq") (seq of
# degree 1: an expert bank's FSDP shard then sums over no axis at all);
# "fsdp" shards over that axis instead (compile(fsdp_axis=)): over
# "expert" the router is cut and the banks, cut over it already, are not
MOE_RUNS = {2: {"ep2": dict(expert=2)},
            4: {"ep4": dict(expert=4), "ep2_dp2": dict(expert=2),
                "ep2_dp2_zero": dict(expert=2, zero=True),
                "ep2_dp2_fsdp_expert": dict(expert=2, fsdp="expert")}}
MOE_STEPS = 4
# tensor parallelism under ZeRO/FSDP: train_mesh(data=2, model=2), the TP
# LM of vocab 32 (its ends shard) without FSDP, with compile(fsdp_axis=)
# and with DistOpt(zero=True), and with FSDP over "model" (the weights
# replicated over it cut there, their gradients no sum over it)
TP_FSDP_RUNS = ("tp", "tp_fsdp", "tp_zero", "tp_fsdp_model")
TP_FSDP_STEPS = LM_STEPS
# the mesh whose rank layout is read, by world
MESH_LAYOUTS = {2: dict(model=2), 4: dict(seq=2, model=2)}
# the collectives of parallel/ops.py: name -> (op, its arguments)
MESH_OPS = {"all_reduce": ("AllReduce", ()),
            "copy_to_parallel": ("CopyToParallel", ()),
            "all_gather": ("AllGather", (-1,)),
            "reduce_scatter": ("ReduceScatter", (-1,)),
            "pmean": ("PMean", ()),
            "all_to_all": ("AllToAll", (0, 1))}


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(case, world, inputs, workdir, torchrun_env=False,
           timeout=TIMEOUT_S):
    """Run ``case`` on ``world`` ranks; returns each rank's arrays (a dict
    per rank) and its log. ``torchrun_env`` hands the ranks ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` as
    ``torchrun`` does, in place of the file store."""
    workdir = str(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        renv = env if not torchrun_env else dict(
            env, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
            MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(world), workdir], env=renv, stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT))
    import time
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    texts = [open(os.path.join(workdir, f"rank{r}.log")).read()
             for r in range(world)]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(
            f"{case}: rank(s) {bad} failed or hung (exit codes "
            f"{[p.returncode for p in procs]}, deadline {timeout} s):\n"
            + "\n".join(f"--- rank {r} ---\n{texts[r][-3000:]}"
                        for r in bad))
    outs = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs, texts


# -- models -------------------------------------------------------------------

def bn_model():
    """The port's counterpart of ``tests/test_parallel.py::BNModel``."""
    from singa_tpu_torch import layer, model

    class BNModel(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(4, 3, padding=1)
            self.bn = layer.BatchNorm2d()
            self.flat = layer.Flatten()
            self.fc = layer.Linear(4)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.flat(self.bn(self.conv(x))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss

    return BNModel()


def mlp3():
    """The port's counterpart of ``tests/test_grad_bucketing.py::MLP``."""
    from singa_tpu_torch import layer, model

    class MLP(model.Model):
        def __init__(self, hidden=64, classes=4):
            super().__init__()
            self.fc1 = layer.Linear(hidden)
            self.r1 = layer.ReLU()
            self.fc2 = layer.Linear(hidden)
            self.r2 = layer.ReLU()
            self.fc3 = layer.Linear(classes)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc3(self.r2(self.fc2(self.r1(self.fc1(x)))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss

    return MLP()


def gspmd_mlp():
    """The port's counterpart of ``tests/test_gspmd_train.py::MLP``."""
    from singa_tpu_torch import layer, model

    class MLP(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(4)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss

    return MLP()


def moe_net(n_experts=4, d_ff=16, top_k=2, capacity_factor=8.0):
    """The port's counterpart of ``tests/test_moe.py::MoENet``: x ->
    ``MoEFFN`` -> mean-square loss against targets, plus 0.01 of the aux
    loss."""
    from singa_tpu_torch import autograd, layer, model
    from singa_tpu_torch.parallel import moe

    class MoENet(model.Model):
        def __init__(self):
            super().__init__()
            self.ffn = moe.MoEFFN(n_experts, d_ff, top_k=top_k,
                                  capacity_factor=capacity_factor)
            self.loss_fn = layer.MeanSquareError()

        def forward(self, x):
            return self.ffn(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            loss = autograd.add(loss, autograd.mul(self.ffn.aux_loss, 0.01))
            self.optimizer(loss)
            return out, loss

    return MoENet()


def drop_bn_model():
    """A small net with a ``BatchNorm2d`` and a ``layer.Dropout`` (the CNN
    and the MLP have neither)."""
    from singa_tpu_torch import layer, model

    class DropBN(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(4, 3, padding=1)
            self.bn = layer.BatchNorm2d()
            self.relu = layer.ReLU()
            self.flat = layer.Flatten()
            self.drop = layer.Dropout(0.5)
            self.fc = layer.Linear(4)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.drop(self.flat(self.relu(self.bn(
                self.conv(x))))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss

    return DropBN()


# -- helpers ------------------------------------------------------------------

def _init(inputs, prefix):
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def _compiled(model, dev, x, optimizer, init=None, policy=None, **kw):
    from singa_tpu_torch import tensor
    from singa_tpu_torch.model import load_numpy_states
    model.set_optimizer(optimizer)
    model.compile([tensor.Tensor(data=x, device=dev)], is_train=True,
                  use_graph=True, policy=policy, **kw)
    if init is not None:
        load_numpy_states(model, init)
    return model


def _states(model, prefix, out):
    """Copies (``to_numpy`` of a CPU tensor shares its memory) of the
    model's and its optimizer's states."""
    for k, v in model.get_states().items():
        out[f"{prefix}/state/{k}"] = np.array(v.to_numpy())
    for k, v in model.optimizer.get_states().items():
        out[f"{prefix}/opt/{k}"] = np.array(v)


def as_float64(model):
    """Every state of the compiled ``model`` in f64, the parameters still
    parameters: a run free of f32 summation-order noise (a batch split
    over ranks sums in another order than the whole batch)."""
    from singa_tpu_torch.autograd_base import register_param
    for t in model.get_states().values():
        param = getattr(t.data, "_singa_param", None) is not None
        t.data = t.data.detach().double()
        if param:
            register_param(t)
    return model


def comm_primitives(rank, world, comm, out):
    """Reduce-scatter and all-gather along dimensions 0 and 1 (one
    collective a call, counted by kind) and the broadcast."""
    import torch
    before = dict(comm.counts)
    a = torch.arange(6.0 * world).reshape(2 * world, 3) + rank
    out["comm/reduce_scatter0"] = comm.reduce_scatter(a, 0).numpy()
    b = torch.arange(6.0 * world).reshape(3, 2 * world) + 10.0 * rank
    out["comm/reduce_scatter1"] = comm.reduce_scatter(b, 1).numpy()
    c = torch.arange(6.0).reshape(2, 3) + 100.0 * rank
    out["comm/all_gather0"] = comm.all_gather(c, 0).numpy()
    out["comm/all_gather1"] = comm.all_gather(c, 1).numpy()
    out["comm/counts"] = np.asarray([comm.counts[k] - before[k]
                                     for k in comm.KINDS])


def _agree(model, comm):
    from singa_tpu_torch.parallel.communicator import replica_fingerprint
    _, agree = replica_fingerprint(list(model.get_states().values()), comm)
    return bool(agree)


# -- cases --------------------------------------------------------------------

def case_dist_opt(rank, world, dev, inputs):
    """The MLP of ``TestDistOptions`` under each option, the static
    rotation's collective counts, the graph cache, the communicator's
    primitives and the mesh."""
    import torch
    from singa_tpu_torch import datasets, opt, tensor
    from singa_tpu_torch.models import mlp
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.parallel import mesh as M
    xs, ys = datasets.partition(rank, world, inputs["x"], inputs["y"])
    tx = tensor.Tensor(data=xs, device=dev)
    ty = tensor.Tensor(data=ys, device=dev)
    init = _init(inputs, "init/")

    def model(optimizer):
        return _compiled(mlp.create_model(data_size=8, perceptron_size=16,
                                          num_classes=4),
                         dev, xs, optimizer, init)

    out = {}
    for option, (spars, steps) in OPTIONS.items():
        d = opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9))
        m = model(d)
        losses, agree = [], []
        for step in range(steps):
            _, loss = m(tx, ty, option, spars)
            losses.append(float(loss.data.detach()))
            agree.append(_agree(m, d.communicator))
            if step == 0:
                for k, res in d._residuals.items():
                    out[f"{option}/kept1/{k}"] = res.to_numpy() == 0
        out[f"{option}/losses"] = np.asarray(losses)
        out[f"{option}/agree"] = np.asarray(agree)
        _states(m, option, out)

    # static rotation: one graph per value, collectives for its partition
    d = opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9))
    m = model(d)
    n = d.communicator.effective_world_size()
    out["rot/losses"] = np.asarray([
        float(m(tx, ty, "partialUpdate", None, step % n)[1].data.detach())
        for step in range(2 * n)])
    out["rot/n_graphs"] = np.asarray(len(m._graphs))
    c0 = d.communicator.n_collectives
    m(tx, ty, "partialUpdate", None, 0)
    c1 = d.communicator.n_collectives
    m(tx, ty, "partialUpdate", None)
    out["rot/static"] = np.asarray(c1 - c0)
    out["rot/fallback"] = np.asarray(d.communicator.n_collectives - c1)

    # alternating options hit one graph each
    m = model(opt.DistOpt(opt.SGD(lr=0.05)))
    out["cache/losses"] = np.asarray([
        float(m(tx, ty, option, None)[1].data.detach())
        for option in ["plain", "half", "plain", "half"]])
    out["cache/n_graphs"] = np.asarray(len(m._graphs))

    # the communicator's primitives, and one over the mesh's group
    comm = C.Communicator()
    out["comm/rank"] = np.asarray(comm.rank())
    out["comm/world"] = np.asarray(comm.effective_world_size())
    d = opt.DistOpt(opt.SGD(), world_size=world)
    out["comm/dist_world"] = np.asarray([d.world_size, d.global_rank])
    try:
        opt.DistOpt(opt.SGD(), world_size=world + 1)
        out["comm/wrong_world"] = np.asarray("")
    except ValueError as e:
        out["comm/wrong_world"] = np.asarray(str(e))
    comm_primitives(rank, world, comm, out)
    out["comm/all_gather"] = comm.all_gather(
        torch.full((1, 2), float(rank)), axis=0).numpy()
    out["comm/reduce_scatter"] = comm.reduce_scatter(
        torch.arange(2.0 * world) + rank).numpy()
    out["comm/broadcast"] = comm.broadcast(
        torch.full((3,), float(rank)), root=1).numpy()
    grad_in = torch.full((2,), float(rank + 1), requires_grad=True)
    summed = comm.all_reduce_grad(grad_in)
    (g,) = torch.autograd.grad(summed, grad_in,
                               torch.full((2,), float(rank + 1)))
    out["comm/all_reduce_grad"] = summed.detach().numpy()
    out["comm/all_reduce_grad_grad"] = g.numpy()
    mesh = M.make_mesh()
    out["mesh/size"] = np.asarray(mesh.size())
    out["mesh/all_reduce"] = C.Communicator(mesh=mesh).all_reduce(
        torch.ones(2)).numpy()
    tp_mesh = M.make_mesh(config=M.MeshConfig(model=world))
    out["mesh/model"] = np.asarray([str(tp_mesh.mesh_dim_names),
                                    str(tuple(tp_mesh.mesh.shape))])
    import torch.distributed as dist
    ep_mesh = M.make_mesh(config=M.MeshConfig(expert=world))
    out["mesh/expert"] = np.asarray([str(ep_mesh.mesh_dim_names),
                                     str(tuple(ep_mesh.mesh.shape))])
    group = ep_mesh.get_group("expert")
    out["mesh/expert_group"] = np.asarray(
        [dist.get_world_size(group), dist.get_rank(group),
         M.axis_rank(ep_mesh, "expert")])
    out["fingerprint/differs"] = np.asarray(bool(C.replica_fingerprint(
        [torch.full((3,), float(rank))], comm)[1]))
    return out


def case_sync_bn(rank, world, dev, inputs):
    """``BNModel`` under ``DistOpt(SGD(lr=0.1))``, 4 steps on the rank's
    shard: losses, parameters and BN running statistics."""
    from singa_tpu_torch import datasets, opt, tensor
    xs, ys = datasets.partition(rank, world, inputs["x"], inputs["y"])
    d = opt.DistOpt(opt.SGD(lr=0.1))
    m = _compiled(bn_model(), dev, xs, d, _init(inputs, "init/"))
    tx = tensor.Tensor(data=xs, device=dev)
    ty = tensor.Tensor(data=ys, device=dev)
    out = {"losses": np.asarray([float(m(tx, ty)[1].data.detach())
                                 for _ in range(4)])}
    out["agree"] = np.asarray(_agree(m, d.communicator))
    _states(m, "bn", out)
    # the same steps in f64
    m = as_float64(_compiled(bn_model(), dev, xs, opt.DistOpt(
        opt.SGD(lr=0.1)), _init(inputs, "init/")))
    tx = tensor.Tensor(data=xs.astype(np.float64), device=dev)
    ty = tensor.Tensor(data=ys.astype(np.float64), device=dev)
    out["f64/losses"] = np.asarray([float(m(tx, ty)[1].data.detach())
                                    for _ in range(4)])
    _states(m, "f64", out)
    return out


def case_guard(rank, world, dev, inputs):
    """Bucketed against streaming reduction (f32 and the ``bf16_mixed``
    wire), then the guard over a ``DistOpt`` with rank 1's shard of step
    ``POISONED`` holding a NaN."""
    from singa_tpu_torch import datasets, opt, tensor
    from singa_tpu_torch.resilience import GuardedOptimizer
    out = {}
    xs, ys = datasets.partition(rank, world, inputs["bx"], inputs["by"])
    tx = tensor.Tensor(data=xs, device=dev)
    ty = tensor.Tensor(data=ys, device=dev)
    init = _init(inputs, "binit/")
    runs = [("stream", {}, None)] + \
        [(k, kw, None) for k, kw in BUCKETINGS.items()] + \
        [("stream_bf16", {}, "bf16_mixed"),
         ("bucket4_bf16", {"bucket_mb": 4}, "bf16_mixed")]
    for name, kw, policy in runs:
        d = opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9), **kw)
        m = _compiled(mlp3(), dev, xs, d, init, policy)
        for _ in range(4):
            m(tx, ty)
        out[f"{name}/collectives"] = np.asarray(
            d.communicator.n_collectives)
        _states(m, name, out)

    from singa_tpu_torch.models import mlp
    guard = GuardedOptimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9)),
                             init_scale=2.0 ** 4, growth_interval=2)
    m = _compiled(mlp.create_model(data_size=8, perceptron_size=16,
                                   num_classes=4),
                  dev, datasets.partition(rank, world, inputs["gx0"])[0],
                  guard, _init(inputs, "ginit/"), "bf16_mixed")
    for step in range(GUARD_STEPS):
        xs, ys = datasets.partition(rank, world, inputs[f"gx{step}"],
                                    inputs[f"gy{step}"])
        before = {k: np.array(v.to_numpy())
                  for k, v in m.get_states().items()}
        _, loss = m(tensor.Tensor(data=xs, device=dev),
                    tensor.Tensor(data=ys, device=dev))
        out[f"guard/loss{step}"] = np.asarray(float(loss.data.detach()))
        stats = guard.stats()
        for k in ("loss_scale", "bad_streak", "good_streak",
                  "skipped_total", "grad_norm"):
            out[f"guard/{k}{step}"] = np.asarray(stats[k])
        if step == POISONED:
            for k, v in before.items():
                out[f"guard/before/{k}"] = v
            _states(m, "guard/after", out)
    _states(m, "guard/final", out)
    out["guard/agree"] = np.asarray(_agree(m, guard.communicator))

    # the same good steps through the unguarded driver (bf16_mixed without
    # loss scaling): the guard's scales are powers of two, so its
    # reduction on the bf16 wire, average and unscale give the same bits
    from singa_tpu_torch.mixed_precision import Policy
    m = _compiled(mlp.create_model(data_size=8, perceptron_size=16,
                                   num_classes=4),
                  dev, datasets.partition(rank, world, inputs["gx0"])[0],
                  opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9)),
                  _init(inputs, "ginit/"),
                  Policy("bf16_mixed", loss_scaling=False))
    for step in range(GUARD_STEPS):
        if step != POISONED:
            xs, ys = datasets.partition(rank, world, inputs[f"gx{step}"],
                                        inputs[f"gy{step}"])
            m(tensor.Tensor(data=xs, device=dev),
              tensor.Tensor(data=ys, device=dev))
    _states(m, "unguarded/final", out)
    return out


def _gspmd_mlp_run(kind, dev, xs, ys, init):
    """``GSPMD_STEPS`` graphed steps of ``gspmd_mlp`` with ``SGD(lr=0.1,
    momentum=0.9)`` under spelling ``kind`` (``GSPMD_RUNS``). Returns the
    model, its losses and the collectives of its last step by kind."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.parallel import gspmd
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    optimizer = opt.DistOpt(sgd, zero=kind == "zero") \
        if kind in ("dist", "mesh_dist", "zero") else sgd
    kw = {}
    if kind in ("mesh_dist", "mesh_plain", "fsdp_plain"):
        kw["mesh"] = gspmd.train_mesh()
    if kind == "fsdp_plain":
        kw["fsdp_axis"] = "data"
    m = _compiled(gspmd_mlp(), dev, xs, optimizer, init, **kw)
    tx = tensor.Tensor(data=xs, device=dev)
    ty = tensor.Tensor(data=ys, device=dev)
    losses = []
    for _ in range(GSPMD_STEPS):
        comm = m._step_communicator()
        before = dict(comm.counts)
        losses.append(float(m(tx, ty)[1].data.detach()))
    per_step = [comm.counts[k] - before[k] for k in comm.KINDS]
    return m, losses, per_step


def _mesh_states(model, prefix, out):
    """:func:`_states` and the bytes a rank holds of the model's and its
    optimizer's states, against their full size."""
    from singa_tpu_torch.parallel.gspmd import Partitioner
    _states(model, prefix, out)
    live = model._state_tensors()
    out[f"{prefix}/bytes"] = np.asarray([
        Partitioner.per_device_bytes(live), Partitioner.global_bytes(live)])


def case_gspmd(rank, world, dev, inputs):
    """The train mesh and ZeRO/FSDP: the MLP under each spelling, the
    communicator's primitives, the train mesh's declines; at two ranks the
    archives of a replicated and a ZeRO run and the ZeRO one restored,
    the guard over ``DistOpt(zero=True)`` under ``bf16_mixed`` against the
    guard over a ``DistOpt`` (rank 1's half of step ``POISONED`` holding a
    NaN), and ``drop_bn_model`` in f64 under ``compile(mesh=)``; given an
    ``archive``, that archive restored into a ZeRO model of this world."""
    import torch
    from singa_tpu_torch import datasets, opt, tensor
    from singa_tpu_torch.models import mlp
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.parallel import gspmd
    from singa_tpu_torch.resilience import GuardedOptimizer
    work = str(inputs["workdir"])
    xs, ys = datasets.partition(rank, world, inputs["x"], inputs["y"])
    init = _init(inputs, "init/")
    out = {}
    models = {}
    for kind in GSPMD_RUNS:
        m, losses, per_step = _gspmd_mlp_run(kind, dev, xs, ys, init)
        out[f"{kind}/losses"] = np.asarray(losses)
        out[f"{kind}/collectives"] = np.asarray(per_step)
        _mesh_states(m, kind, out)
        models[kind] = m

    comm_primitives(rank, world, C.Communicator(), out)
    for name, kw in (("model", {"model": 2}), ("stage", {"stage": 2}),
                     ("subset", {"data": 1})):
        try:
            msh = gspmd.train_mesh(**kw)
            out[f"decline/{name}"] = np.asarray("")
            out[f"mesh/{name}"] = np.asarray(
                [str(msh.mesh_dim_names), str(tuple(msh.mesh.shape))])
        except (NotImplementedError, gspmd.ShardingDecline) as e:
            out[f"decline/{name}"] = np.asarray(f"{type(e).__name__}: {e}")

    def zero_model():
        return _compiled(gspmd_mlp(), dev, xs, opt.DistOpt(
            opt.SGD(lr=0.1, momentum=0.9), zero=True))

    if "archive" in inputs:
        m = zero_model()
        m.load_states(str(inputs["archive"]))
        _mesh_states(m, f"restored{world}", out)
    if world != 2:
        return out

    models["dist"].save_states(os.path.join(work, f"rep{rank}.zip"))
    models["zero"].save_states(os.path.join(work, "zero.zip"))
    m = zero_model()
    m.load_states(os.path.join(work, "zero.zip"))
    _mesh_states(m, "restored2", out)

    for name, zero in (("guard_rep", False), ("guard_zero", True)):
        guard = GuardedOptimizer(
            opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9), zero=zero),
            init_scale=2.0 ** 4, growth_interval=2)
        m = _compiled(mlp.create_model(data_size=8, perceptron_size=16,
                                       num_classes=4),
                      dev, datasets.partition(rank, world,
                                              inputs["gx0"])[0],
                      guard, _init(inputs, "ginit/"), "bf16_mixed")
        for step in range(GUARD_STEPS):
            gx, gy = datasets.partition(rank, world, inputs[f"gx{step}"],
                                        inputs[f"gy{step}"])
            _, loss = m(tensor.Tensor(data=gx, device=dev),
                        tensor.Tensor(data=gy, device=dev))
            out[f"{name}/loss{step}"] = np.asarray(float(loss.data.detach()))
            stats = guard.stats()
            for k in ("loss_scale", "bad_streak", "good_streak",
                      "skipped_total", "grad_norm"):
                out[f"{name}/{k}{step}"] = np.asarray(stats[k])
            if step == POISONED - 1:
                _states(m, f"{name}/before", out)
            if step == POISONED:
                _states(m, f"{name}/after", out)
        _mesh_states(m, f"{name}/final", out)

    dev.SetRandSeed(DROP_SEED)
    dx, dy = datasets.partition(rank, world, inputs["dx"], inputs["dy"])
    m = as_float64(_compiled(drop_bn_model(), dev, dx, opt.SGD(
        lr=0.1, momentum=0.9), _init(inputs, "dinit/"),
        mesh=gspmd.train_mesh()))
    tx = tensor.Tensor(data=torch.from_numpy(dx).double(), device=dev)
    ty = tensor.Tensor(data=torch.from_numpy(dy).double(), device=dev)
    out["drop64/losses"] = np.asarray([float(m(tx, ty)[1].data.detach())
                                       for _ in range(DROP_STEPS)])
    _states(m, "drop64", out)
    return out


def case_example(rank, world, dev, inputs):
    """``main`` of the example ``inputs["script"]`` (``train_cnn`` by
    default) with ``inputs["argv"]``, each training loss it returned
    recorded (``Model.__call__`` wrapped), and the model's states
    (gathered, under ``--fsdp`` or a model axis, before ``main`` leaves
    the process group)."""
    import runpy
    import torch.distributed
    from singa_tpu_torch import model as model_mod
    script = str(inputs["script"]) if "script" in inputs else "train_cnn"
    example = runpy.run_path(
        os.path.join(ROOT, "singa_tpu_torch", "examples", f"{script}.py"),
        run_name=script)
    losses, seen, out = [], [], {}
    call = model_mod.Model.__call__
    destroy = torch.distributed.destroy_process_group

    def recorded(self, *a, **kw):
        seen[:] = [self]
        result = call(self, *a, **kw)
        if self._train:
            losses.append(float(result[1].data.detach()))
        return result

    def destroy_after_states(*a, **kw):
        _states(seen[0], "example", out)
        destroy(*a, **kw)

    model_mod.Model.__call__ = recorded
    torch.distributed.destroy_process_group = destroy_after_states
    m = example["main"]([str(a) for a in inputs["argv"]])
    if not out:
        _states(m, "example", out)
    out["losses"] = np.asarray(losses)
    return out


def _lm_model(vocab, **kw):
    from singa_tpu_torch.models import transformer
    return transformer.TransformerLM(vocab, **dict(LM_KW, **kw))


def init_prefix(run):
    """The prefix of an ``LM_RUNS`` entry's seeded weights in the
    inputs: by vocab, and apart for a MoE model (other states)."""
    return f"init{run['vocab']}{'moe' if run.get('moe') else ''}/"


def _lm_compiled(dev, inputs, run):
    """A ``TransformerLM`` of ``run`` (an ``LM_RUNS`` entry) under a
    ``DistOpt(SGD(lr=0.3, momentum=0.9))`` over its mesh, compiled on the
    global batch, with the numpy seed's weights."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.parallel import mesh as M
    from singa_tpu_torch.parallel.communicator import set_mesh
    from singa_tpu_torch.parallel.gspmd import P
    cfg = dict(run)
    vocab = cfg.pop("vocab")
    degrees = {a: cfg.pop(a) for a in ("model", "seq", "expert")
               if a in cfg}
    seq = "seq_axis" in cfg
    ep = "expert" in degrees
    m = _lm_model(vocab, tp=True, **cfg)
    d = opt.DistOpt(opt.SGD(lr=0.3, momentum=0.9),
                    reduce_axes=("data", "seq") if seq else
                    ("data", "expert") if ep else None)
    mesh = M.make_mesh(config=M.MeshConfig(**degrees))
    d.communicator.mesh = mesh
    set_mesh(mesh)
    m.set_optimizer(d)
    if seq:
        m.input_specs = [P("data", "seq"), P("data", "seq")]
        m.output_specs = [P("data", "seq"), P()]
    if ep:
        m.input_specs = [P(("data", "expert")), P(("data", "expert"))]
    tx = tensor.Tensor(data=inputs[f"ids{vocab}"], device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(m, _init(inputs, init_prefix(run)))
    return m, tx, tensor.Tensor(data=inputs[f"tgt{vocab}"], device=dev)


def case_lm_mesh(rank, world, dev, inputs):
    """The LM of ``tests/test_transformer.py`` on the mesh of each
    ``LM_RUNS`` entry named in ``inputs["runs"]``: ``LM_STEPS`` steps'
    losses, the gathered states,
    the collectives of a step and the shapes a rank holds; after the
    ``tp_v32_fused`` run its archive restored into a fresh TP model,
    greedy ``generate`` from it beside the argmax of its own forward, and
    its next loss."""
    import torch
    from singa_tpu_torch.parallel import ops as collective
    from singa_tpu_torch.parallel.communicator import set_mesh
    from singa_tpu_torch.tensor import Tensor
    work = str(inputs["workdir"])
    out = {}
    for name in inputs["runs"].tolist():
        run = LM_RUNS[name]
        m, tx, ty = _lm_compiled(dev, inputs, run)
        losses = []
        for step in range(LM_STEPS):
            collective.reset_counts()
            losses.append(float(m(tx, ty)[1].data.detach()))
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/collectives"] = np.asarray(
            [collective.counts[k] for k in collective.KINDS])
        out[f"{name}/local/head"] = np.asarray(m.head.W.shape)
        out[f"{name}/local/tok"] = np.asarray(m.tok_emb.W.shape)
        out[f"{name}/local/q"] = np.asarray(
            m.blocks[0].attn.q_proj.W.shape)
        _states(m, name, out)
        if name not in ARCHIVE_RUNS:
            continue
        zpath = os.path.join(work, ARCHIVE_RUNS[name])
        m.save_states(zpath)
        out[f"{name}/next_loss"] = np.asarray(
            float(m(tx, ty)[1].data.detach()))
        m2, _, _ = _lm_compiled(dev, inputs, run)
        m2.load_states(zpath)
        gen = m2.generate(tx, max_new_tokens=4, temperature=0)
        out[f"{name}/generated"] = gen
        m2.eval()
        out[f"{name}/restored_eval"] = np.array(m2(tx).data)
        out[f"{name}/restored_local/w1" if run.get("moe") else
            f"{name}/restored_local/q"] = np.asarray(
            m2.blocks[0].mlp.w1.shape if run.get("moe") else
            m2.blocks[0].attn.q_proj.W.shape)
        cur = gen[:, :-4]
        want = []
        for _ in range(4):
            logits = m2(Tensor(data=cur.astype(np.float32), device=dev)).data
            nxt = torch.argmax(logits[:, -1], -1).numpy()
            want.append(nxt)
            cur = np.concatenate([cur, nxt[:, None].astype(cur.dtype)], 1)
        out[f"{name}/reforward"] = np.stack(want, 1)
        m2.train()
        out[f"{name}/restored_loss"] = np.asarray(
            float(m2(tx, ty)[1].data.detach()))
    set_mesh(None)
    return out


def case_mesh_ops(rank, world, dev, inputs):
    """The six collectives of ``parallel/ops.py`` over a ``model`` axis of
    every rank: forward and backward on this rank's slice of the inputs,
    the backward also through torch autograd; the rank's coordinates on a
    ``MESH_LAYOUTS`` mesh; then ring and Ulysses attention on this rank's sequence block, outputs and gradients, and
    Ulysses with indivisible heads (it falls back to ring)."""
    import warnings
    import torch
    from singa_tpu_torch.ops import attention as A
    from singa_tpu_torch.parallel import mesh as M
    from singa_tpu_torch.parallel import ops as collective
    from singa_tpu_torch.parallel.communicator import collective_context
    from singa_tpu_torch.tensor import Tensor
    out = {}
    mesh = M.make_mesh(config=M.MeshConfig(model=world))
    with collective_context("model", mesh=mesh):
        for name, (cls, args) in MESH_OPS.items():
            x = torch.from_numpy(inputs[f"op/{name}/x"][rank])
            dy = torch.from_numpy(inputs[f"op/{name}/dy"][rank])
            op = getattr(collective, cls)("model", *args)
            out[f"{name}/y"] = op.forward(x).numpy()
            out[f"{name}/dx"] = op.backward(dy).numpy()
            xt = Tensor(data=x.clone().requires_grad_(), device=dev)
            y = getattr(collective, cls)("model", *args)(xt)
            (g,) = torch.autograd.grad(y.data, xt.data, dy)
            out[f"{name}/dx_autograd"] = g.numpy()
        collective.reset_counts()
        t = torch.arange(6.0).reshape(2, 3) + rank
        out["shift"] = collective.ring_shift(t, "model").numpy()
        out["shift_counts"] = np.asarray(
            [collective.counts[k] for k in collective.KINDS])
    lmesh = M.make_mesh(config=M.MeshConfig(**MESH_LAYOUTS[world]))
    names = list(lmesh.mesh_dim_names)
    out["coords/names"] = np.asarray(names)
    out["coords/values"] = np.asarray([M.axis_rank(lmesh, a) for a in names])
    smesh = M.make_mesh(config=M.MeshConfig(seq=world))
    for case in ("ring_causal", "ring_full", "ulysses_causal",
                 "ulysses_full", "ulysses_h2"):
        mode, how = case.split("_")
        q, k, v, g = (torch.from_numpy(inputs[f"attn/{how == 'h2'}/{n}"])
                      for n in "qkvg")
        S = q.shape[2] // world
        blk = [t[:, :, rank * S:(rank + 1) * S].clone().requires_grad_()
               for t in (q, k, v)]
        causal = how != "full"
        with collective_context("seq", mesh=smesh), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            A.reset_counts()
            o = A.attention(*(Tensor(data=t, device=dev) for t in blk),
                            causal=causal, seq_axis="seq", seq_mode=mode)
            grads = torch.autograd.grad(
                o.data, blk, g[:, :, rank * S:(rank + 1) * S])
        out[f"{case}/out"] = o.data.detach().numpy()
        for n, gr in zip("qkv", grads):
            out[f"{case}/d{n}"] = gr.numpy()
        out[f"{case}/warned"] = np.asarray(
            any("falling back to ring" in str(w.message) for w in caught))
    return out


def case_moe(rank, world, dev, inputs):
    """``moe_net`` on each ``MOE_RUNS[world]`` mesh, as
    ``tests/test_moe.py::TestExpertParallel`` trains it: a ``DistOpt``
    over ``("data", "expert")``, every rank given the global batch and
    taking its block over both axes; the losses, the all-to-alls of a
    step, the expert bank a rank holds, the gathered states, then an eval
    forward that stays sharded; and the error of 3 experts over the
    expert axis."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.parallel import mesh as M
    from singa_tpu_torch.parallel import ops as collective
    from singa_tpu_torch.parallel.communicator import set_mesh
    from singa_tpu_torch.parallel.gspmd import P
    out = {}
    tx = tensor.Tensor(data=inputs["x"], device=dev)
    ty = tensor.Tensor(data=inputs["y"], device=dev)

    def on_mesh(m, degrees, policy=None):
        degrees = dict(degrees)
        zero = degrees.pop("zero", False)
        fsdp = degrees.pop("fsdp", None)
        d = opt.DistOpt(opt.SGD(lr=0.1), zero=zero,
                        reduce_axes=("data", "expert", "seq") if zero else
                        ("data", "expert"))
        mesh = M.make_mesh(config=M.MeshConfig(**degrees))
        d.communicator.mesh = mesh
        set_mesh(mesh)
        m.set_optimizer(d)
        m.input_specs = [P(("data", "expert")), P(("data", "expert"))]
        m.compile([tx], is_train=True, use_graph=True, fsdp_axis=fsdp,
                  policy=policy)
        return m

    for name, degrees in MOE_RUNS[world].items():
        m = on_mesh(moe_net(), degrees)
        load_numpy_states(m, _init(inputs, "init/"))
        losses, a2a = [], []
        for _ in range(MOE_STEPS):
            collective.reset_counts()
            losses.append(float(m(tx, ty)[1].data.detach()))
            a2a.append(collective.counts["all_to_all"])
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/all_to_all"] = np.asarray(a2a)
        out[f"{name}/local/w1"] = np.asarray(m.ffn.w1.shape)
        out[f"{name}/local/wg"] = np.asarray(m.ffn.wg.shape)
        _states(m, name, out)
        m.eval()
        out[f"{name}/eval"] = np.array(m(tx).to_numpy())
        out[f"{name}/eval_local/w1"] = np.asarray(m.ffn.w1.shape)
        set_mesh(None)
    if world == 2:
        m = on_mesh(moe_net(), dict(expert=2), policy="bf16_mixed")
        load_numpy_states(m, _init(inputs, "init/"))
        # the expert bank w1, cut over "expert"
        _guard_skip(m, m.ffn.w1, rank, tx, ty, out, "guard")
        set_mesh(None)
    m = on_mesh(moe_net(n_experts=3, top_k=1), dict(expert=world))
    try:
        m(tx, ty)
        out["indivisible"] = np.asarray("")
    except ValueError as e:
        out["indivisible"] = np.asarray(str(e))
    set_mesh(None)
    return out


def _guard_skip(m, param, rank, tx, ty, out, prefix):
    """Under ``bf16_mixed``: a clean step, then a step whose ``param`` has
    an infinite gradient on rank 1 alone (after the reduction, so only
    that rank's block of the global norm sees it). The guard's global norm
    sums each cut gradient's blocks over its cut axes: every rank skips
    the step. Out: how far the states moved at each step, the loss scale
    and ``skipped_total`` after each."""
    dist = m.optimizer.inner
    reduce = dist.reduced_mean
    poison = []

    def reduced_mean(pairs, *args, **kw):
        pairs = list(reduce(pairs, *args, **kw))
        if poison and rank == 1:
            for p, g in pairs:
                if p is param:
                    g.data.fill_(float("inf"))
        return pairs

    dist.reduced_mean = reduced_mean
    before = {k: np.array(v.to_numpy()) for k, v in m.get_states().items()}
    moved, scales, skipped = [], [], []
    for step in range(2):
        poison[:] = [True] * step
        m(tx, ty)
        after = {k: np.array(v.to_numpy())
                 for k, v in m.get_states().items()}
        moved.append(max(float(np.abs(after[k] - v).max())
                         for k, v in before.items()))
        stats = m.optimizer.stats()
        scales.append(stats["loss_scale"])
        skipped.append(stats["skipped_total"])
        before = after
    out[f"{prefix}/moved"] = np.asarray(moved)
    out[f"{prefix}/loss_scale"] = np.asarray(scales)
    out[f"{prefix}/skipped_total"] = np.asarray(skipped)


def case_lm_fsdp(rank, world, dev, inputs):
    """The TP LM (vocab 32) on ``train_mesh(data=2, model=2)``, every rank
    given the global batch (``input_specs`` over ``data``), under each
    ``TP_FSDP_RUNS`` spelling: the losses, the gathered states, the shape
    of every state a rank holds and its state bytes."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.parallel import gspmd
    from singa_tpu_torch.parallel.gspmd import P
    out = {}
    tx = tensor.Tensor(data=inputs["ids32"], device=dev)
    ty = tensor.Tensor(data=inputs["tgt32"], device=dev)
    for name in TP_FSDP_RUNS:
        m = _lm_model(32, tp=True)
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.3, momentum=0.9),
                                    zero=name == "tp_zero"))
        m.input_specs = [P("data"), P("data")]
        m.compile([tx], is_train=True, use_graph=True,
                  mesh=gspmd.train_mesh(data=2, model=2),
                  fsdp_axis={"tp_fsdp": "data",
                             "tp_fsdp_model": "model"}.get(name))
        load_numpy_states(m, _init(inputs, "init32/"))
        out[f"{name}/losses"] = np.asarray(
            [float(m(tx, ty)[1].data.detach())
             for _ in range(TP_FSDP_STEPS)])
        for k, t in m._live_states().items():
            out[f"{name}/local/{k}"] = np.asarray(t.shape)
        out[f"{name}/bytes"] = np.asarray(
            gspmd.Partitioner.per_device_bytes(m._state_tensors()))
        _states(m, name, out)
    # the guard over both cut axes: a weight cut over "model" and then
    # over "data" by FSDP, its gradient poisoned on rank 1 alone
    m = _lm_model(32, tp=True)
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.3, momentum=0.9)))
    m.input_specs = [P("data"), P("data")]
    m.compile([tx], is_train=True, use_graph=True,
              mesh=gspmd.train_mesh(data=2, model=2), fsdp_axis="data",
              policy="bf16_mixed")
    load_numpy_states(m, _init(inputs, "init32/"))
    both = [p for p in m.get_params().values()
            if {lay.axis for lay, _ in gspmd.cuts_of(p)} ==
            {"data", "model"}]
    out["guard/cut_over_both"] = np.asarray(len(both))
    _guard_skip(m, both[0], rank, tx, ty, out, "guard")
    return out


CASES = {"dist_opt": case_dist_opt, "sync_bn": case_sync_bn,
         "guard": case_guard, "example": case_example,
         "gspmd": case_gspmd, "lm_mesh": case_lm_mesh,
         "mesh_ops": case_mesh_ops, "moe": case_moe,
         "lm_fsdp": case_lm_fsdp}


def main(argv):
    case, rank, world, workdir = argv[1], int(argv[2]), int(argv[3]), \
        argv[4]
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from singa_tpu_torch import device
    from singa_tpu_torch.parallel import communicator
    dev = device.create_cpu_device()
    joined = case != "example"
    if joined:
        communicator.init_process(
            communicator.NcclIdHolder(file=os.path.join(workdir, "store")),
            rank, world, device=dev, timeout_s=60)
    try:
        with np.load(os.path.join(workdir, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        out = CASES[case](rank, world, dev, inputs)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
    # the outputs are written and the process group is destroyed: leave
    # without the interpreter's teardown, in which a finished gloo rank
    # has been seen to abort ("terminate called without an active
    # exception", exit -6); a failure inside main still exits with 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
