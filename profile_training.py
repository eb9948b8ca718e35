#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    python3 profile_training.py [--model resnet50|lm] [--steps 3] [--warmup 3]

``--model resnet50`` (the default) builds chip_smoke.py's ResNet training
setup (ResNet-50, 224 px, batch 32, f32,
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

``--model lm`` builds chip_smoke.py's Transformer LM training setup
(``bench.py``'s ``LM_SHAPE``: d_model 512, 8 heads, 6 layers, seq 1024,
vocab 32000; batch 8, ``fused_head_chunk=8192``, weights from the same
numpy seed, ``SGD(lr=0.1, momentum=0.9, fused=True)``) and traces it with
the flash-attention kernels K3/K4 and with their plain versions
(``ops.attention.USE_PLAIN``) in turns (kernels, plain, plain, kernels),
then under ``compute_dtype=bfloat16`` with the kernels. Its kinds are K3,
K4, K1, matrix products (cuBLAS: projections, FFN, the fused CE head's
chunks), elementwise passes, reductions (LayerNorm statistics, the CE
head's row sums, bias gradients), the embedding gathers and their
backward, and the rest.

Everything also goes to ``chiprun_out/profile_training.json`` (or
``profile_training_lm.json``). Imports nothing of JAX or ``singa_tpu``;
exits nonzero without a CUDA device.
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


# the LM has no convolutions: cuBLAS's kernels (some named xmma) are
# matrix products
LM_KINDS = (
    ("k3", ("flash_fwd_kernel",)),
    ("k4", ("flash_bwd_",)),
    ("k1", ("sgd_kernel",)),
    ("matmul", ("gemm", "cutlass", "gemv", "xmma", "sm90_", "nvjet")),
    ("embedding", ("embedding", "index", "scatter", "gather")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name, kinds=KINDS):
    low = name.lower()
    for kind, keys in kinds:
        if any(k in low for k in keys):
            return kind
    return "other"


def traced_steps(model, tx, ty, steps, kinds_table=KINDS):
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
        kind = kinds.setdefault(kind_of(evt.name, kinds_table), [0, 0.0])
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
    rec = {"trace": "train", "fused": fused, "deterministic": deterministic,
           "steps": steps, "batch": chip_smoke.BATCH,
           "k1_launches_per_step": fo.launches["sgd"] / steps}
    rec.update(summary(wall, kernels, kinds, steps, chip_smoke.BATCH,
                       "img_per_s"))
    print(json.dumps(rec), flush=True)
    return rec


def summary(wall, kernels, kinds, steps, per_step, rate):
    """Per-step wall, ``rate`` (``per_step`` items a step over the wall),
    device busy, idle share, ops and ms by kind, the top kernels."""
    busy = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    return {"wall_ms_per_step": wall * 1e3 / steps,
            rate: per_step * steps / wall,
            "device_busy_ms_per_step": busy / steps,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_ops_per_step": sum(v[0] for v in kernels.values())
            / steps,
            "device_ms_per_step_by_kind": {
                k: v[1] / steps for k, v in sorted(kinds.items())},
            "launches_per_step_by_kind": {
                k: v[0] / steps for k, v in sorted(kinds.items())},
            "top_device_ms_per_step": [
                {"name": n, "calls_per_step": c / steps,
                 "ms_per_step": ms / steps} for n, (c, ms) in top]}


def run_lm(model, tx, ty, start, plain, steps, warmup):
    """``steps`` traced LM steps after ``warmup`` untraced ones, with the
    flash kernels or (``plain``) their plain versions."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import attention as at
    load_numpy_states(model, start)
    model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    model.train()
    at.USE_PLAIN = plain
    try:
        for _ in range(warmup):
            model(tx, ty)
        at.reset_counts()
        wall, kernels, kinds = traced_steps(model, tx, ty, steps, LM_KINDS)
        launches = dict(at.launches)
    finally:
        at.USE_PLAIN = False
    model.eval()
    tokens = chip_smoke.LM["batch"] * chip_smoke.LM["seq"]
    rec = {"trace": "train_lm", "plain_attention": plain,
           "compute_dtype": str(model.compute_dtype), "steps": steps,
           "batch": chip_smoke.LM["batch"], "seq": chip_smoke.LM["seq"],
           "flash_launches_per_step": {k: v / steps
                                       for k, v in launches.items()}}
    rec.update(summary(wall, kernels, kinds, steps, tokens, "tokens_per_s"))
    print(json.dumps(rec), flush=True)
    return rec


def main_lm(dev, steps, warmup):
    import torch
    tx, ty = chip_smoke.lm_data(dev)
    model = chip_smoke.lm_model(dev, tx)
    start = chip_smoke.lm_states(model, chip_smoke.SEED + 4)
    recs = [run_lm(model, tx, ty, start, plain, steps, warmup)
            for plain in (False, True, True, False)]
    del model
    torch.cuda.empty_cache()
    bf16 = chip_smoke.lm_model(dev, tx, torch.bfloat16)
    recs.append(run_lm(bf16, tx, ty, start, False, steps, warmup))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("resnet50", "lm"),
                    default="resnet50")
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
    if args.model == "lm":
        recs = main_lm(dev, args.steps, args.warmup)
        name = "profile_training_lm.json"
    else:
        (model, _), tx, ty, start = chip_smoke.train_models(dev)
        recs = []
        for deterministic in (True, False):
            for fused in (True, False, False, True):
                recs.append(run(model, tx, ty, start, fused, deterministic,
                                args.steps, args.warmup))
        name = "profile_training.json"
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({"card": card, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
