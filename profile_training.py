#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    python3 profile_training.py [--steps 3] [--warmup 3]

Builds chip_smoke.py's training setup (ResNet-50, 224 px, batch 32, f32,
TF32 off, NCHW, weights and BN statistics from the same numpy seed, one
fixed synthetic batch, ``SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)``)
and, for the fused (kernel K1) and the unfused optimizer in turns (fused,
unfused, unfused, fused), with cuDNN deterministic as in chip_smoke.py's
comparison and again without it, prints one JSON line per run of
``--steps`` steps under ``torch.profiler`` (CPU + CUDA activities), after
``--warmup`` untraced steps:

- wall ms per step (host clock, the steps end in a synchronize), device
  busy ms per step (the sum of kernel times) and the device's idle share;
- device ms per step by kind of kernel, from the kernel's name: cuDNN
  convolutions (forward, data and weight gradients), the matrix products
  of the fc layer, reductions (the BN batch moments and the sums of their
  backward), elementwise passes (BN normalisation, ReLU, residual add,
  and their backward; the unfused optimizer chain), pooling, K1, the rest;
- the kernels that take the most device time.

Everything also goes to ``chiprun_out/profile_training.json``. Imports
nothing of JAX or ``singa_tpu``; exits nonzero without a CUDA device.
"""

import argparse
import json
import os
import sys
import time

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))

# kind of kernel -> substrings of its name (first match wins, in order)
KINDS = (
    ("k1", ("sgd_kernel",)),
    ("conv", ("conv", "xmma", "implicit", "wgrad", "dgrad", "cudnn",
              "winograd", "fft", "precomputed")),
    ("matmul", ("gemm", "cutlass", "gemv")),
    ("pool", ("pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def traced_steps(model, tx, ty, steps):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model(tx, ty)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, kinds = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        k = kernels.setdefault(evt.name[:90], [0, 0.0])
        k[0] += 1
        k[1] += ms
        kind = kinds.setdefault(kind_of(evt.name), [0, 0.0])
        kind[0] += 1
        kind[1] += ms
    return wall, kernels, kinds


def run(model, tx, ty, start, fused, deterministic, steps, warmup):
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import fused_optim as fo
    torch.backends.cudnn.deterministic = deterministic
    load_numpy_states(model, start)
    model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5,
                                fused=fused))
    model.train()
    for _ in range(warmup):
        model(tx, ty)
    fo.reset_counts()
    wall, kernels, kinds = traced_steps(model, tx, ty, steps)
    busy = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    rec = {"trace": "train", "fused": fused, "deterministic": deterministic,
           "steps": steps, "batch": chip_smoke.BATCH,
           "wall_ms_per_step": wall * 1e3 / steps,
           "img_per_s": chip_smoke.BATCH * steps / wall,
           "device_busy_ms_per_step": busy / steps,
           "device_idle_share": 1.0 - busy / (wall * 1e3),
           "device_ops_per_step": sum(v[0] for v in kernels.values())
           / steps,
           "k1_launches_per_step": fo.launches["sgd"] / steps,
           "device_ms_per_step_by_kind": {
               k: v[1] / steps for k, v in sorted(kinds.items())},
           "launches_per_step_by_kind": {
               k: v[0] / steps for k, v in sorted(kinds.items())},
           "top_device_ms_per_step": [
               {"name": n, "calls_per_step": c / steps,
                "ms_per_step": ms / steps} for n, (c, ms) in top]}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    from singa_tpu_torch import cuda_build, device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    cuda_build.build()
    dev = device.create_cuda_gpu(0)
    (model, _), tx, ty, start = chip_smoke.train_models(dev)
    recs = []
    for deterministic in (True, False):
        for fused in (True, False, False, True):
            recs.append(run(model, tx, ty, start, fused, deterministic,
                            args.steps, args.warmup))
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_training.json"), "w") as f:
        json.dump({"card": card, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
