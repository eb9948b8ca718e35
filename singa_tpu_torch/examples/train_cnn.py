#!/usr/bin/env python3
"""Train ResNet-50 with the PyTorch/CUDA port, on synthetic data or
CIFAR-10.

    python3 singa_tpu_torch/examples/train_cnn.py resnet synthetic --fused-optim
    python3 singa_tpu_torch/examples/train_cnn.py resnet cifar10 --data-dir DIR

The ``resnet`` / ``synthetic|cifar10`` subset of ``examples/train_cnn.py``
with the same SGD settings (``lr``, momentum 0.9, weight decay 1e-5,
``fused=--fused-optim``, which sends every update through kernel K1),
the same epoch loop (shuffle, batched crop/flip augmentation for CIFAR-10,
training loss and accuracy, then evaluation accuracy per epoch) and the
same synthetic data (``--iters`` batches of N(0, 1) images at 224 px,
seed 0). It runs on the card unless ``--cpu`` is given. CIFAR-10 is read
from ``--data-dir`` (or ``data/`` of this checkout); nothing is
downloaded. ``--layout auto`` of the JAX example reads a TPU A/B result,
so the default here is NCHW.

Not ported yet, each refused with a pointer to ROADMAP.md: the other
models, ``-p bf16_mixed`` / ``bfloat16``, ``--dist`` / ``--mesh``
(data-parallel training) and ``--resilient``.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="resnet")
    ap.add_argument("data", nargs="?", default="synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--bs", "-b", type=int, default=64)
    ap.add_argument("--epochs", "-m", type=int, default=10)
    ap.add_argument("--iters", type=int, default=20,
                    help="synthetic batches per epoch")
    ap.add_argument("--max-batches", type=int, default=0,
                    help="cap the train batches per epoch (0: all)")
    ap.add_argument("--lr", "-l", type=float, default=0.05)
    ap.add_argument("-p", "--precision", default="float32")
    ap.add_argument("--fused-optim", action="store_true",
                    help="update every parameter through kernel K1")
    ap.add_argument("--layout", default="NCHW", choices=("NCHW", "NHWC"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--resilient", action="store_true")
    return ap


def _refuse(args):
    """What this example does not do yet, each naming ROADMAP.md."""
    if args.model != "resnet":
        return f"model {args.model!r} is not ported yet (ROADMAP.md); " \
            "use resnet"
    if args.data not in ("synthetic", "cifar10"):
        return f"dataset {args.data!r} is not ported yet (ROADMAP.md); " \
            "use synthetic or cifar10"
    if args.precision != "float32":
        return f"-p {args.precision} training is not ported yet " \
            "(ROADMAP.md: bf16_mixed with dynamic loss scaling is the next " \
            "slice); use -p float32"
    if args.dist or args.mesh:
        return "--dist/--mesh: data-parallel training is not ported yet " \
            "(ROADMAP.md: slice B)"
    if args.resilient:
        return "--resilient: the fault-tolerant driver is not ported yet " \
            "(ROADMAP.md)"
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    refused = _refuse(args)
    if refused:
        raise SystemExit(refused)

    from singa_tpu_torch import datasets, device, metric, opt, tensor
    from singa_tpu_torch.models import resnet

    dev = device.create_cpu_device() if args.cpu \
        else device.create_cuda_gpu(0)
    dev.SetRandSeed(0)
    print(f"device: {dev.torch_device}", flush=True)

    num_classes, augment = 10, False
    if args.data == "synthetic":
        rng = np.random.RandomState(0)
        n = args.bs * args.iters
        train_x = rng.randn(n, 3, 224, 224).astype(np.float32)
        train_y = rng.randint(0, 10, n).astype(np.int32)
        val_x, val_y = train_x[:args.bs], train_y[:args.bs]
    else:
        train_x, train_y, val_x, val_y = datasets.load(args.data,
                                                       args.data_dir)
        train_x, val_x = datasets.normalize_cifar(train_x, val_x)
        augment = not args.no_augment

    model = resnet.create_model(num_channels=train_x.shape[1],
                                num_classes=num_classes, layout=args.layout)
    model.set_optimizer(opt.SGD(lr=args.lr, momentum=0.9,
                                weight_decay=1e-5, fused=args.fused_optim))
    need_resize = train_x.shape[-1] != model.input_size

    def stage(x):
        if need_resize:
            return tensor.Tensor(data=datasets.resize_batch(
                x, model.input_size, device=dev), device=dev)
        return tensor.Tensor(data=np.ascontiguousarray(x, np.float32),
                             device=dev)

    model.compile([stage(train_x[:args.bs])], is_train=True, use_graph=True)

    eye = np.eye(num_classes, dtype=np.float32)
    acc = metric.Accuracy()
    n_train = len(train_x) // args.bs
    if n_train == 0:
        sys.exit(f"dataset too small: {len(train_x)} train samples < batch "
                 f"size {args.bs}")
    if args.max_batches:
        n_train = min(n_train, args.max_batches)
    n_val = len(val_x) // args.bs or 1

    rng = np.random.RandomState(1)
    for epoch in range(args.epochs):
        print(f"Starting Epoch {epoch}:", flush=True)
        idx = rng.permutation(len(train_x))
        t0, losses, accs = time.time(), [], []
        model.train()
        for b in range(n_train):
            sel = idx[b * args.bs:(b + 1) * args.bs]
            bx = train_x[sel]
            if augment:
                bx = datasets.augment_crop_flip(bx, rng=rng)
            out, loss = model(stage(bx), tensor.Tensor(
                data=eye[train_y[sel]], device=dev))
            losses.append(float(loss.data.detach()))
            accs.append(acc.evaluate(out, train_y[sel]))
        print(f"Training loss = {np.mean(losses):.6f}, "
              f"training accuracy = {np.mean(accs):.6f}", flush=True)
        model.eval()
        vaccs = []
        for b in range(n_val):
            bx = val_x[b * args.bs:(b + 1) * args.bs]
            by = val_y[b * args.bs:(b + 1) * args.bs]
            vaccs.append(acc.evaluate(model(stage(bx)), by))
        print(f"Evaluation accuracy = {np.mean(vaccs):.6f}, "
              f"Elapsed Time = {time.time() - t0:.3f}s", flush=True)
    return model


if __name__ == "__main__":
    main()
