#!/usr/bin/env python3
"""ResNet training throughput on synthetic data with the PyTorch/CUDA port.

    python3 singa_tpu_torch/examples/benchmark.py [--bs 32] [--iters 100]
        [--warmup 8] [--depth 50] [--size 224] [-p float32|bfloat16]
        [--dist] [--verbosity 0] [--layout NCHW|NHWC]
        [--stem conv7|space_to_depth] [--cpu]

The measurement of ``examples/benchmark.py``: ResNet-``depth`` (1000
classes) on one fixed N(0, 1) batch (numpy seed 0), ``SGD(lr=0.1,
momentum=0.9, weight_decay=1e-5)`` through the multi-tensor optimizer
kernel (K1-multi, ``fused=True``), the step compiled in graph mode (on
the card each step after the second replays a CUDA graph). At least one
warm-up step runs untimed; the timed steps end at
``utils.force_completion`` of the last loss, and ``throughput = iters *
batch * world / seconds``. ``-p bfloat16`` casts the batch to bf16 (the
parameters follow it). ``--dist`` trains through ``opt.DistOpt``; under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/
``MASTER_PORT``) each rank joins the process group (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--cpu``), else the world is 1.
``--verbosity 1`` records whole-step times, printed at the end. It runs
on the card unless ``--cpu`` is given. It prints figures and writes
nothing.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--depth", type=int, default=50,
                    choices=[18, 34, 50, 101, 152])
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("-p", "--precision", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--verbosity", "-v", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--layout", default="NCHW", choices=["NCHW", "NHWC"])
    ap.add_argument("--stem", default="conv7",
                    choices=["conv7", "space_to_depth"])
    return ap


def main(argv=None):
    """Run the benchmark; returns ``{"throughput", "total_s",
    "iter_s"}``."""
    args = build_parser().parse_args(argv)
    from singa_tpu_torch import device
    from singa_tpu_torch.parallel import communicator

    launched = args.dist and "WORLD_SIZE" in os.environ
    rank = int(os.environ["RANK"]) if launched else 0
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    dev = device.create_cpu_device() if args.cpu \
        else device.create_cuda_gpu(int(os.environ.get("LOCAL_RANK", 0))
                                    if launched else 0)
    if launched:
        communicator.init_process(communicator.NcclIdHolder(), rank, world,
                                  device=dev)
    try:
        return run(args, dev, world)
    finally:
        if launched:
            import torch.distributed
            torch.distributed.destroy_process_group()


def run(args, dev, world):
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.models import resnet
    from singa_tpu_torch.utils import force_completion

    dev.SetRandSeed(0)
    dev.SetVerbosity(args.verbosity)
    dev.SetSkipIteration(5)

    m = resnet.create_model(depth=args.depth, num_classes=1000,
                            num_channels=3, layout=args.layout,
                            stem=args.stem)
    sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True)
    m.set_optimizer(opt.DistOpt(sgd) if args.dist else sgd)

    rng = np.random.RandomState(0)
    x = rng.randn(args.bs, 3, args.size, args.size).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, args.bs)]
    tx = tensor.Tensor(data=x, device=dev, requires_grad=False)
    if args.precision == "bfloat16":
        tx = tx.as_type("bfloat16")
    ty = tensor.Tensor(data=y, device=dev, requires_grad=False)

    m.compile([tx], is_train=True, use_graph=True)

    # at least one untimed step: the eager first call and the capture
    # must not land inside the timed region
    for _ in range(max(1, args.warmup)):
        out, loss = m(tx, ty)
    force_completion(loss)

    start = time.perf_counter()
    for _ in range(args.iters):
        out, loss = m(tx, ty)
    force_completion(loss)
    end = time.perf_counter()

    titer = (end - start) / args.iters
    throughput = args.iters * args.bs * world / (end - start)
    print(f"\nThroughput = {throughput:.2f} per second", flush=True)
    print(f"TotalTime={end - start:.4f}", flush=True)
    print(f"Total={titer:.6f}", flush=True)
    dev.PrintTimeProfiling()
    return {"throughput": throughput, "total_s": end - start,
            "iter_s": titer}


if __name__ == "__main__":
    main()
