#!/usr/bin/env python3
"""Train the MLP on a synthetic two-class dataset with the PyTorch/CUDA
port.

    python3 singa_tpu_torch/examples/train_mlp.py [--bs 64] [--epochs 5]
        [--lr 0.05] [--cpu]

The behaviour of ``examples/train_mlp.py``: 1024 points drawn uniformly
from [-1, 1]^2 (numpy seed 0), labelled by the side of the line
y = 5x + 1 they fall on, the port's ``models.mlp`` with 2 classes,
``SGD(lr, momentum=0.9)``, the step compiled in graph mode, and per epoch
a shuffled pass printing the mean loss and accuracy. It runs on the card
unless ``--cpu`` is given.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap


def main(argv=None):
    """Train; returns the mean loss and accuracy of each epoch."""
    args = build_parser().parse_args(argv)
    from singa_tpu_torch import device, metric, opt, tensor
    from singa_tpu_torch.models import mlp

    # points above/below the line y = 5x + 1
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (1024, 2)).astype(np.float32)
    y = (x[:, 1] > 5 * x[:, 0] + 1).astype(np.int64)

    dev = device.create_cpu_device() if args.cpu \
        else device.create_cuda_gpu()
    model = mlp.create_model(data_size=2, num_classes=2)
    model.set_optimizer(opt.SGD(lr=args.lr, momentum=0.9))
    tx = tensor.Tensor(data=x[:args.bs], device=dev, requires_grad=False)
    model.compile([tx], is_train=True, use_graph=True)

    acc = metric.Accuracy()
    eye = np.eye(2, dtype=np.float32)
    history = []
    for epoch in range(args.epochs):
        idx = rng.permutation(len(x))
        losses, accs = [], []
        for b in range(len(x) // args.bs):
            sel = idx[b * args.bs:(b + 1) * args.bs]
            bx = tensor.Tensor(data=x[sel], device=dev,
                               requires_grad=False)
            by = tensor.Tensor(data=eye[y[sel]], device=dev,
                               requires_grad=False)
            out, loss = model(bx, by)
            losses.append(float(loss.data.detach()))
            accs.append(acc.evaluate(out, y[sel]))
        history.append((float(np.mean(losses)), float(np.mean(accs))))
        print(f"epoch {epoch}: loss {history[-1][0]:.4f} "
              f"acc {history[-1][1]:.4f}", flush=True)
    return history


if __name__ == "__main__":
    main()
