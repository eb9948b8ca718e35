#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    python3 profile_training.py [--model resnet50|lm] [--steps 3] [--warmup 3]
                                [--optimizer sgd|rmsprop|adagrad]
                                [--policy float32|bf16_mixed] [--graph]
                                [--layout NCHW|NHWC]
                                [--stem conv7|space_to_depth]

``--model resnet50`` (the default) builds chip_smoke.py's ResNet training
setup (ResNet-50, 224 px, batch 32, f32, TF32 off, NCHW, weights and BN
statistics from the same numpy seed, one fixed synthetic batch,
``SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)``) and, for the fused
(kernel K1's multi-tensor launch) and the unfused optimizer in turns
(fused, unfused, unfused, fused), with cuDNN deterministic as in
chip_smoke.py's comparison and again without it, prints one JSON line per
run of ``--steps`` steps under ``torch.profiler`` (CPU + CUDA activities),
after ``--warmup`` untraced steps. ``--optimizer rmsprop`` or ``adagrad``
trains the same model with ``RMSProp(lr=1e-3)`` or ``AdaGrad(lr=1e-2)``
(chip_smoke.py's phase 8) and traces the fused step through the
multi-tensor K6 or K7 launch and through the per-tensor kernel (the
earlier design) in turns (multi, per-tensor, per-tensor, multi), cuDNN
deterministic. ``--policy bf16_mixed`` compiles the same model under that
policy (bf16 convolutions and products, f32 masters, the optimizer wrapped
in ``resilience.GuardedOptimizer``), as chip_smoke.py's bf16_mixed phase
does, and traces the same turns. Each line holds:

- wall ms per step (host clock, the steps end in a synchronize), device
  busy ms per step (the sum of kernel times) and the device's idle share;
- device ms per step by kind of kernel, from the kernel's name: cuDNN
  convolutions (forward, data and weight gradients), the matrix products
  of the fc layer, reductions (the BN batch moments and the sums of their
  backward), elementwise passes (BN normalisation, ReLU, residual add,
  and their backward; the unfused optimizer chain; in bf16 the casts),
  pooling, the layout transposes cuDNN adds around bf16 convolutions of
  NCHW tensors, PyTorch's multi-tensor ``_foreach`` passes (the guard's
  unscale and norm), K1, K6/K7, the rest;
- the kernels that take the most device time, overall and in each kind.

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

``--graph`` traces the step in graph mode (``Model.graph()``: the warm-up
steps run the eager call and the capture, the traced ones are CUDA-graph
replays) beside the eager step, in turns (graph, eager, eager, graph):
the ResNet with the fused SGD, cuDNN deterministic, under ``--policy``;
the LM through K3/K4 in f32, then under ``compute_dtype=bfloat16``.
Every record's launches per step of the port's kernels are counted by
kernel name in its trace, beside the host counts of the same steps (0
for replays, which move no host counter).

Everything also goes to ``chiprun_out/profile_training.json`` (or
``profile_training_lm.json``; ``_<policy>``, ``_nhwc``, ``_s2d`` and
``_graph`` before ``.json`` with those options). Imports nothing of JAX or ``singa_tpu``;
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
    ("k1", ("sgd_kernel", "sgd_multi_kernel")),
    ("k6_k7", ("scaled_kernel", "scaled_multi_kernel")),
    ("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("foreach", ("multi_tensor_apply",)),
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
    ("k3", ("flash_fwd_kernel", "flash_fwd_mma_kernel")),
    ("k4", ("flash_bwd_",)),
    ("k1", ("sgd_kernel", "sgd_multi_kernel")),
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
    kernels, kinds, ports = {}, {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        port = chip_smoke.port_kernel(evt.name)
        if port is not None:
            ports[port] = ports.get(port, 0) + 1
        ms = evt.time_range.elapsed_us() / 1e3
        name = kind_of(evt.name, kinds_table)
        k = kernels.setdefault(evt.name[:90], [0, 0.0, name])
        k[0] += 1
        k[1] += ms
        kind = kinds.setdefault(name, [0, 0.0])
        kind[0] += 1
        kind[1] += ms
    return wall, kernels, kinds, ports


# the optimizers of the ResNet traces, by --optimizer: fused or not
OPTIMIZERS = {
    "sgd": lambda opt, fused: opt.SGD(lr=0.1, momentum=0.9,
                                      weight_decay=1e-5, fused=fused),
    "rmsprop": lambda opt, fused: opt.RMSProp(lr=1e-3, fused=fused),
    "adagrad": lambda opt, fused: opt.AdaGrad(lr=1e-2, fused=fused),
}


def run(model, tx, ty, start, optimizer, update, deterministic, steps,
        warmup, graph=False):
    """``steps`` traced ResNet steps of ``optimizer`` after ``warmup``
    untraced ones; ``update`` is ``"fused"`` (the multi-tensor launch),
    ``"unfused"`` or ``"per_tensor"`` (the fused per-tensor kernel);
    ``graph``: in graph mode (the warm-up captures, the trace replays)."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import fused_optim as fo
    torch.backends.cudnn.deterministic = deterministic
    load_numpy_states(model, start)
    o = OPTIMIZERS[optimizer](opt, update != "unfused")
    model.set_optimizer(chip_smoke.per_tensor(o) if update == "per_tensor"
                        else o)
    model.graph(graph)
    model.train()
    launches, host, (wall, kernels, kinds) = warm_and_trace(
        model, tx, ty, steps, warmup, graph, fo.launches)
    rec = {"trace": "train", "optimizer": optimizer, "update": update,
           "policy": model._policy.name if model._policy else "float32",
           "deterministic": deterministic, "graph": graph, "steps": steps,
           "batch": chip_smoke.BATCH,
           "launches_per_step": launches,
           "host_optimizer_launches_per_step": host}
    rec.update(summary(wall, kernels, kinds, steps, chip_smoke.BATCH,
                       "img_per_s"))
    print(json.dumps(rec), flush=True)
    return rec


def warm_and_trace(model, tx, ty, steps, warmup, graph, counter,
                   kinds_table=KINDS):
    """``warmup`` untraced steps, then ``steps`` traced ones
    (:func:`traced_steps`). Returns the launches per step of the port's
    kernels in the trace, counted by kernel name
    (``chip_smoke.port_kernel``), those of the launch-counter dict
    ``counter`` in the same steps (a replay moves no host counter: in
    graph mode they must be 0), and the trace."""
    for _ in range(warmup):
        model(tx, ty)
    for k in counter:
        counter[k] = 0
    wall, kernels, kinds, ports = traced_steps(model, tx, ty, steps,
                                               kinds_table)
    host = {k: v / steps for k, v in counter.items() if v}
    chip_smoke.check(not (graph and host), "replayed steps counted "
                     f"launches {counter} on the host")
    return ({k: v / steps for k, v in ports.items()}, host,
            (wall, kernels, kinds))


def summary(wall, kernels, kinds, steps, per_step, rate):
    """Per-step wall, ``rate`` (``per_step`` items a step over the wall),
    device busy, idle share, ops and ms by kind, the top kernels."""
    busy = sum(v[1] for v in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    top = ranked[:15]
    by_kind = {}
    for n, (c, ms, kind) in ranked:
        rows = by_kind.setdefault(kind, [])
        if len(rows) < 5:
            rows.append({"name": n, "calls_per_step": c / steps,
                         "ms_per_step": ms / steps})
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
                 "ms_per_step": ms / steps} for n, (c, ms, _) in top],
            "top_device_ms_per_step_by_kind": by_kind}


def run_lm(model, tx, ty, start, plain, steps, warmup, graph=False):
    """``steps`` traced LM steps after ``warmup`` untraced ones, with the
    flash kernels or (``plain``) their plain versions; ``graph``: in graph
    mode."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import attention as at
    load_numpy_states(model, start)
    model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    model.graph(graph)
    model.train()
    at.USE_PLAIN = plain
    try:
        launches, host, (wall, kernels, kinds) = warm_and_trace(
            model, tx, ty, steps, warmup, graph, at.launches, LM_KINDS)
    finally:
        at.USE_PLAIN = False
    model.eval()
    tokens = chip_smoke.LM["batch"] * chip_smoke.LM["seq"]
    rec = {"trace": "train_lm", "plain_attention": plain, "graph": graph,
           "compute_dtype": str(model.compute_dtype), "steps": steps,
           "batch": chip_smoke.LM["batch"], "seq": chip_smoke.LM["seq"],
           "launches_per_step": launches,
           "host_flash_launches_per_step": host}
    rec.update(summary(wall, kernels, kinds, steps, tokens, "tokens_per_s"))
    print(json.dumps(rec), flush=True)
    return rec


def main_lm(dev, steps, warmup, graph=False):
    import torch
    tx, ty = chip_smoke.lm_data(dev)
    model = chip_smoke.lm_model(dev, tx)
    start = chip_smoke.lm_states(model, chip_smoke.SEED + 4)
    if graph:
        turns = [(False, g) for g in (True, False, False, True)]
    else:
        turns = [(p, False) for p in (False, True, True, False)]
    recs = [run_lm(model, tx, ty, start, plain, steps, warmup, g)
            for plain, g in turns]
    del model
    torch.cuda.empty_cache()
    bf16 = chip_smoke.lm_model(dev, tx, torch.bfloat16)
    recs += [run_lm(bf16, tx, ty, start, False, steps, warmup, g)
             for g in ((True, False) if graph else (False,))]
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("resnet50", "lm"),
                    default="resnet50")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--optimizer", choices=sorted(OPTIMIZERS),
                    default="sgd")
    ap.add_argument("--policy", choices=("float32", "bf16_mixed"),
                    default="float32",
                    help="the ResNet's precision policy")
    ap.add_argument("--layout", choices=("NCHW", "NHWC"), default="NCHW",
                    help="the ResNet's conv-trunk layout")
    ap.add_argument("--stem", choices=("conv7", "space_to_depth"),
                    default="conv7", help="the ResNet's stem conv")
    ap.add_argument("--graph", action="store_true",
                    help="trace graph-mode steps (CUDA-graph replays) "
                    "beside eager ones")
    args = ap.parse_args(argv)
    if args.graph and args.warmup < 2:
        ap.error("--graph needs --warmup 2 or more: the eager call and "
                 "the capture")
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
        recs = main_lm(dev, args.steps, args.warmup, args.graph)
        name = "profile_training_lm.json"
    else:
        (model, _), tx, ty, start = chip_smoke.train_models(
            dev, layout=args.layout, stem=args.stem)
        if args.policy != "float32":
            model.compile([tx], is_train=True, policy=args.policy)
        if args.graph:
            turns = [(True, "fused", g) for g in (True, False, False, True)]
            name = "profile_training.json"
        elif args.optimizer == "sgd":
            turns = [(d, u, False) for d in (True, False)
                     for u in ("fused", "unfused", "unfused", "fused")]
            name = "profile_training.json"
        else:
            turns = [(True, u, False) for u in ("fused", "per_tensor",
                                                "per_tensor", "fused")]
            name = f"profile_training_{args.optimizer}.json"
        if args.policy != "float32":
            name = name.replace(".json", f"_{args.policy}.json")
        if args.layout != "NCHW":
            name = name.replace(".json", f"_{args.layout.lower()}.json")
        if args.stem != "conv7":
            name = name.replace(".json", "_s2d.json")
        recs = [run(model, tx, ty, start, args.optimizer, u, d, args.steps,
                    args.warmup, g) for d, u, g in turns]
    if args.graph:
        name = name.replace(".json", "_graph.json")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({"card": card, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
