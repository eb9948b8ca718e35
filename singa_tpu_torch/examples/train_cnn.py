#!/usr/bin/env python3
"""Train a CNN-family model with the PyTorch/CUDA port, on synthetic data,
CIFAR-10/100 or MNIST.

    python3 singa_tpu_torch/examples/train_cnn.py
        [cnn|alexnet|resnet|xceptionnet|mlp]
        [cifar10|cifar100|mnist|synthetic] [--data-dir DIR]
        [--npz path.npz] [--bs 64] [--epochs 10] [--lr 0.05]
        [-p float32|bfloat16|bf16_mixed] [--layout auto|NCHW|NHWC]
        [--stem conv7|space_to_depth] [--fused-optim] [--cpu]
        [--dist] [--dist-option plain|half|fp16|partialUpdate|
                  sparseTopK|sparseThreshold] [--spars 0.05]
        [--bucket-mb 0] [--no-overlap] [--mesh Dx1] [--fsdp]

    torchrun --nproc_per_node N singa_tpu_torch/examples/train_cnn.py ...
        --dist | --mesh Nx1 [--fsdp] | --fsdp

The single-device behaviour of ``examples/train_cnn.py``: the same models
(``cnn`` by default), datasets and normalisation (CIFAR standardised per
channel and augmented by batched crop/flip, MNIST scaled to [0, 1]),
``--npz`` (arrays ``x`` and ``y``, the last tenth held out), the same
synthetic shapes (``--iters`` batches of N(0, 1) images, seed 0: 1x28x28
for ``cnn`` and ``mlp``, 3x224 for ``alexnet`` and ``resnet``, 3x299 for
``xceptionnet``; ``mlp`` takes them flattened), the same SGD settings
(``lr``, momentum 0.9, weight decay 1e-5, ``fused=--fused-optim``, which
sends the update through the optimizer kernel: K1's multi-tensor launch)
and the same epoch loop (shuffle, training loss and accuracy, then
evaluation accuracy per epoch). The train step is compiled in graph mode
(``use_graph=True``): on the card each step after the first two replays a
CUDA graph. It runs on the card unless ``--cpu`` is given. Datasets are
read from ``--data-dir`` (or ``data/`` of this checkout); nothing is
downloaded.

Precision: ``-p bf16_mixed`` compiles the model under the mixed-precision
policy (f32 master weights, bf16 convolutions and products, dynamic loss
scaling through ``resilience.GuardedOptimizer``); ``-p bfloat16`` is the
JAX example's pure-bf16 path: the input is cast to bf16, the conv and
linear parameters follow its dtype, and no policy is set. ``--stem``
picks ResNet's 7x7/s2 stem conv or its exact space-to-depth form.
``--layout auto`` runs the JAX package's measured A/B winner there; no
such A/B exists on this card, so it runs NCHW, the default.

Data parallelism: ``--dist`` trains through ``opt.DistOpt`` (gradients
summed over the ranks, ``--bucket-mb`` MiB buckets, ``--no-overlap`` the
no-overlap baseline, ``--dist-option`` picks the driver, ``--spars`` the
sparse drivers' share or threshold). Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) each
rank joins the process group (NCCL on the card ``cuda:LOCAL_RANK``, gloo
with ``--cpu``), takes its ``datasets.partition`` of each global batch
(``--bs`` stays the global batch) and only rank 0 prints; the training
and evaluation accuracies are summed over the ranks. Without those
variables ``--dist`` runs a world of 1.

The train mesh and ZeRO/FSDP (``parallel.gspmd``): ``--mesh DxM`` compiles
the model with ``mesh=gspmd.train_mesh(data=D, model=M)`` (D x M the ranks
of the ``torchrun`` world; a plain SGD's gradients are averaged over the D
data ranks as well; the CNNs announce no tensor-parallel spec, so the M
model ranks of a data coordinate train replicas on the same rows),
``--fsdp`` with ``fsdp_axis="data"`` (the parameters and momenta held as
shards, gathered for each step; without ``--mesh`` the mesh is every
rank). Without ``torchrun``'s variables they run a world of 1 and no mesh
is built.

Refused, each naming ROADMAP.md: ``--bucket-mb auto`` (it reads the JAX
package's measured A/B winner); ``--resilient``, ``--ckpt-dir``,
``--save-every``, ``--profile-every``, ``--anomaly-factor`` (the
fault-tolerant driver, slice E) and ``--telemetry`` (observability, slice
E). ``--verbosity`` only shapes the JAX package's per-op timing, which
the port does not record; it is accepted and does nothing here.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

MODELS = ("cnn", "alexnet", "resnet", "xceptionnet", "mlp")
DATASETS = ("cifar10", "cifar100", "mnist", "synthetic")
SYNTHETIC = {"cnn": (1, 28), "mlp": (1, 28), "alexnet": (3, 224),
             "resnet": (3, 224), "xceptionnet": (3, 299)}
# flags refused with the part of ROADMAP.md that would port them
REFUSED = {
    "resilient": "--resilient", "ckpt_dir": "--ckpt-dir",
    "save_every": "--save-every", "profile_every": "--profile-every",
    "anomaly_factor": "--anomaly-factor", "telemetry": "--telemetry"}
OBSERVABILITY = ("telemetry",)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="cnn", choices=MODELS)
    ap.add_argument("data", nargs="?", default="synthetic",
                    choices=DATASETS)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--npz", default=None,
                    help="npz with arrays x, y (overrides the data arg)")
    ap.add_argument("--bs", "-b", type=int, default=64)
    ap.add_argument("--epochs", "-m", type=int, default=10)
    ap.add_argument("--iters", type=int, default=20,
                    help="synthetic batches per epoch")
    ap.add_argument("--max-batches", type=int, default=0,
                    help="cap the train batches per epoch (0: all)")
    ap.add_argument("--lr", "-l", type=float, default=0.05)
    ap.add_argument("-p", "--precision", default="float32",
                    choices=["float32", "bfloat16", "bf16_mixed"],
                    help="bf16_mixed: f32 masters, bf16 compute, dynamic "
                         "loss scaling; bfloat16: the pure-bf16 input "
                         "cast, parameters follow the input dtype")
    ap.add_argument("--fused-optim", action="store_true",
                    help="update the parameters through the optimizer "
                         "kernel (K1's multi-tensor launch)")
    ap.add_argument("--layout", default="NCHW",
                    choices=["auto", "NCHW", "NHWC"],
                    help="resnet's conv-trunk activation layout")
    ap.add_argument("--stem", default="conv7",
                    choices=["conv7", "space_to_depth"],
                    help="resnet stem: the 7x7/s2 conv or its exact "
                         "space-to-depth reformulation")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--verbosity", "-v", type=int, default=0)
    ap.add_argument("--dist-option", default="plain")
    ap.add_argument("--spars", type=float, default=0.05)
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train mesh of D data by M model ranks: "
                         "Model.compile(mesh=gspmd.train_mesh(data=D, "
                         "model=M))")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO/FSDP over the data ranks: "
                         "Model.compile(fsdp_axis='data')")
    ap.add_argument("--bucket-mb", default="0",
                    help="with --dist: gradient bucket size target in MiB "
                         "(DistOpt bucket_mb; 0: one collective per "
                         "gradient)")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--telemetry", default=None, metavar="DIR")
    ap.add_argument("--resilient", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=None)
    ap.add_argument("--profile-every", type=int, default=None)
    ap.add_argument("--anomaly-factor", type=float, default=None)
    return ap


def mesh_degrees(spec):
    """``(D, M)`` of ``--mesh DxM``."""
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {spec}: expected DxM, e.g. 4x1") from None
    return d, m


def _refuse(args):
    """The flags this example does not take yet, each naming ROADMAP.md;
    None when every flag given is ported."""
    if args.bucket_mb == "auto":
        return "--bucket-mb auto: it reads the JAX package's measured " \
            "bucket A/B (bench.py), which the port has not measured " \
            "(ROADMAP.md: slice B); give a size in MiB"
    given = [k for k in REFUSED
             if getattr(args, k) not in (None, False)]
    if not given:
        return None
    k = given[0]
    if k in OBSERVABILITY:
        why = "run telemetry is not ported yet (ROADMAP.md: slice E, " \
            "observability)"
    else:
        why = "the fault-tolerant driver is not ported yet (ROADMAP.md: " \
            "slice E, resilience)"
    return f"{REFUSED[k]}: {why}"


def load_data(args):
    """(train_x, train_y, val_x, val_y, num_classes, augment) as the JAX
    example makes them."""
    from singa_tpu_torch import datasets
    if args.npz:
        blob = np.load(args.npz)
        x, y = blob["x"].astype(np.float32), blob["y"].astype(np.int32)
        n_val = max(1, len(x) // 10)
        return (x[:-n_val], y[:-n_val], x[-n_val:], y[-n_val:],
                int(y.max()) + 1, False)
    if args.data == "synthetic":
        chans, size = SYNTHETIC[args.model]
        rng = np.random.RandomState(0)
        n = args.bs * args.iters
        train_x = rng.randn(n, chans, size, size).astype(np.float32)
        train_y = rng.randint(0, 10, n).astype(np.int32)
        return train_x, train_y, train_x[:args.bs], train_y[:args.bs], \
            10, False
    train_x, train_y, val_x, val_y = datasets.load(args.data, args.data_dir)
    if args.data.startswith("cifar"):
        train_x, val_x = datasets.normalize_cifar(train_x, val_x)
        return train_x, train_y, val_x, val_y, \
            100 if args.data == "cifar100" else 10, not args.no_augment
    return (np.asarray(train_x, np.float32) / 255.0, train_y,
            np.asarray(val_x, np.float32) / 255.0, val_y, 10, False)


def main(argv=None):
    args = build_parser().parse_args(argv)
    refused = _refuse(args)
    if refused:
        raise SystemExit(refused)

    from singa_tpu_torch import device
    from singa_tpu_torch.parallel import communicator, gspmd

    bucket_mb = float(args.bucket_mb)
    # torchrun's variables; without them --dist, --mesh and --fsdp run a
    # world of 1
    launched = (args.dist or args.mesh or args.fsdp) and \
        "WORLD_SIZE" in os.environ
    rank = int(os.environ["RANK"]) if launched else 0
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    if args.mesh:       # degrees that cannot tile the world decline here
        gspmd.train_degrees(world, *mesh_degrees(args.mesh))
    dev = device.create_cpu_device() if args.cpu \
        else device.create_cuda_gpu(int(os.environ.get("LOCAL_RANK", 0))
                                    if launched else 0)
    if launched:
        communicator.init_process(communicator.NcclIdHolder(), rank, world,
                                  device=dev)
    try:
        return train(args, dev, rank, world, bucket_mb)
    finally:
        if launched:
            import torch.distributed
            torch.distributed.destroy_process_group()


def train(args, dev, rank, world, bucket_mb):
    """The epoch loop of ``main`` as rank ``rank`` of ``world``."""
    import torch
    from singa_tpu_torch import datasets, metric, models, opt, tensor
    from singa_tpu_torch.parallel import communicator, gspmd

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    dev.SetRandSeed(0)
    say(f"device: {dev.torch_device}" + (
        f", data-parallel world {world}"
        if args.dist or args.mesh or args.fsdp else ""))

    train_x, train_y, val_x, val_y, num_classes, augment = load_data(args)
    factory = getattr(models, args.model)
    if args.model == "mlp":
        train_x = train_x.reshape(len(train_x), -1)
        val_x = val_x.reshape(len(val_x), -1)
        model = factory.create_model(data_size=train_x.shape[1],
                                     num_classes=num_classes)
        augment = False
    else:
        kw = {}
        if args.model == "resnet":
            layout = args.layout
            if layout == "auto":
                layout = "NCHW"
                say("conv layout: NCHW (no layout A/B measured on this "
                    "card)")
            kw = {"layout": layout, "stem": args.stem}
        model = factory.create_model(num_channels=train_x.shape[1],
                                     num_classes=num_classes, **kw)
    sgd = opt.SGD(lr=args.lr, momentum=0.9, weight_decay=1e-5,
                  fused=args.fused_optim)
    model.set_optimizer(opt.DistOpt(sgd, bucket_mb=bucket_mb,
                                    overlap=not args.no_overlap)
                        if args.dist else sgd)
    if not args.dist and (bucket_mb or args.no_overlap):
        say("note: --bucket-mb/--no-overlap shape the gradient collectives "
            "and need --dist; ignored on a single replica")

    # the model ranks of a data coordinate (innermost in the mesh) take
    # the same rows
    width = mesh_degrees(args.mesh)[1] if args.mesh else 1

    def shard(*arrays):
        return datasets.partition(rank // width, world // width, *arrays)

    input_size = getattr(model, "input_size", None)
    need_resize = (getattr(model, "dimension", 4) == 4
                   and input_size is not None
                   and train_x.shape[-1] != input_size)

    def stage(x):
        if need_resize:
            t = tensor.Tensor(data=datasets.resize_batch(
                x, input_size, device=dev), device=dev)
        else:
            t = tensor.Tensor(data=np.ascontiguousarray(x, np.float32),
                              device=dev)
        # pure bf16: the parameters follow the input's dtype
        return t.as_type("bfloat16") if args.precision == "bfloat16" \
            else t

    mesh = None
    if args.mesh or args.fsdp:
        data = mesh_degrees(args.mesh)[0] if args.mesh else -1
        if communicator.initialized():    # else a world of 1, no mesh
            mesh = gspmd.train_mesh(data=data, model=width)
        say(f"GSPMD train mesh=data{world // width}xmodel{width}"
            + (" fsdp=data" if args.fsdp else ""))
    model.compile([stage(shard(train_x[:args.bs])[0])], is_train=True,
                  use_graph=True,
                  policy="bf16_mixed" if args.precision == "bf16_mixed"
                  else None, mesh=mesh,
                  fsdp_axis="data" if args.fsdp else None)

    eye = np.eye(num_classes, dtype=np.float32)
    acc = metric.Accuracy()
    n_train = len(train_x) // args.bs
    if n_train == 0:
        sys.exit(f"dataset too small: {len(train_x)} train samples < batch "
                 f"size {args.bs}")
    if args.max_batches:
        n_train = min(n_train, args.max_batches)
    n_val = len(val_x) // args.bs or 1

    dist_args = (args.dist_option, args.spars) \
        if args.dist and args.dist_option != "plain" else ()

    comm = communicator.Communicator()     # the identity at world 1

    def over_ranks(values):
        """The mean of ``values`` over every rank's values (each rank
        holds the same count)."""
        total = np.array([np.sum(values), len(values)], np.float64)
        total = comm.all_reduce(torch.tensor(
            total, device=dev.torch_device)).cpu().numpy()
        return total[0] / total[1]

    rng = np.random.RandomState(1)
    for epoch in range(args.epochs):
        say(f"Starting Epoch {epoch}:")
        idx = rng.permutation(len(train_x))
        t0, losses, accs = time.time(), [], []
        model.train()
        for b in range(n_train):
            sel = idx[b * args.bs:(b + 1) * args.bs]
            bx = train_x[sel]
            if augment:
                bx = datasets.augment_crop_flip(bx, rng=rng)
            bx, by = shard(bx, train_y[sel])
            out, loss = model(stage(bx), tensor.Tensor(
                data=eye[by], device=dev), *dist_args)
            losses.append(float(loss.data.detach()))
            accs.append(acc.evaluate(out, by))
        say(f"Training loss = {np.mean(losses):.6f}, "
            f"training accuracy = {over_ranks(accs):.6f}")
        say(graph_line(model, dev))
        model.eval()
        vaccs = []
        for b in range(n_val):
            bx, by = shard(val_x[b * args.bs:(b + 1) * args.bs],
                           val_y[b * args.bs:(b + 1) * args.bs])
            vaccs.append(acc.evaluate(model(stage(bx)), by))
        say(f"Evaluation accuracy = {over_ranks(vaccs):.6f}, "
            f"Elapsed Time = {time.time() - t0:.3f}s")
    return model


def graph_line(model, dev):
    """Whether the train step was captured in a CUDA graph (graph mode on
    the card; on the CPU the step runs on its static buffers), with this
    epoch's captures and replays (eval drops the graphs)."""
    stats = model.graph_stats().values()
    captures = sum(s["n_captures"] for s in stats)
    replays = sum(s["n_replays"] for s in stats)
    captured = "yes" if dev.is_cuda and captures else "no"
    return (f"train step captured in a CUDA graph: {captured} ({captures} "
            f"capture(s), {replays} replays on {dev.torch_device})")


if __name__ == "__main__":
    main()
