#!/usr/bin/env python3
"""Where a serving tick of the PyTorch/CUDA port spends its time, on one
NVIDIA card.

    python3 profile_serving.py [--policy float32 bf16_mixed]
                               [--layout NCHW|NHWC] [--ticks 4] [--turns 10]
                               [--graph]

Builds chip_smoke.py's ResNet-50 (224 px, batch 32, weights and BN
statistics from the same numpy seed) and prints one JSON line for each of
these measurements:

- ``host_us_per_call``: host time to enqueue one call of each piece of a
  BN+ReLU tail (the kernel K2 wrappers, the BN fold, the plain inference
  BN, ReLU, add) on a small tensor, averaged over 2,000 calls;
- ``forward`` records: one ResNet-50 batch-32 forward of the unfused and
  the fused (K2) path in turns (unfused, fused, fused, unfused), each
  ``--turns`` forwards after 3 warm-up ones, with the median host time to
  enqueue the forward and the median time to its logits on the host (a
  synchronising copy). Enqueue close to the total means the host, not the
  card, sets the pace;
- ``trace`` records: for each path, ``--ticks`` serving ticks through the
  eager engine (``use_graph=False``) under ``torch.profiler`` (CPU + CUDA
  activities): wall ms per tick, device-busy ms per tick (sum of kernel
  times), the device's idle share, kernel launches per tick, and the
  kernels that take the most device time. With ``--graph`` each path is
  also traced through the engine's default, a CUDA graph replayed per
  tick (``"graph": true``), beside its eager trace. K2's launches per
  tick are counted by kernel name in the trace, beside the host count
  (a replay moves no host counter: a graphed trace's must be 0).

Everything also goes to ``chiprun_out/profile_serving-<layout>.json``
(``-<layout>-graph.json`` with ``--graph``).
Imports nothing of JAX or ``singa_tpu``; exits nonzero without a CUDA
device.
"""

import argparse
import json
import os
import sys
import time

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))


def host_us_per_call(dev, n=2000):
    """Host microseconds to enqueue each piece of one tail."""
    import torch
    from singa_tpu_torch.ops import batchnorm as bn
    from singa_tpu_torch.ops import fused_epilogue as fe
    d = dev.torch_device
    g = torch.Generator(device=d)
    g.manual_seed(chip_smoke.SEED)
    x = torch.randn((2, 64, 8, 8), generator=g, device=d)
    r = torch.randn((2, 64, 8, 8), generator=g, device=d)
    s = torch.rand(64, generator=g, device=d) + .5
    b = torch.randn(64, generator=g, device=d)
    pieces = {
        "k2_plain": lambda: fe.scale_shift_relu(x, s, b),
        "k2_residual": lambda: fe.scale_shift_add_relu(x, s, b, r),
        "fold_bn": lambda: fe.fold_bn(s, b, b, s, 1e-5),
        "bn_inference": lambda: bn.batchnorm_inference(
            x, s, b, b, s, 1e-5, (1, 64, 1, 1)),
        "relu": lambda: torch.relu(x),
        "add": lambda: x + r,
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    rec = {"host_us_per_call": out}
    print(json.dumps(rec), flush=True)
    return rec


def forward_turns(model, dev, policy, turns):
    """Unfused, fused, fused, unfused: ``turns`` timed forwards each."""
    import numpy as np
    import torch
    from singa_tpu_torch import mixed_precision as mp
    from singa_tpu_torch.autograd_base import CTX
    from singa_tpu_torch.ops import fused_epilogue as fe
    from singa_tpu_torch.tensor import Tensor
    g = torch.Generator(device=dev.torch_device)
    g.manual_seed(chip_smoke.SEED)
    x = torch.randn((chip_smoke.BATCH,) + chip_smoke.SHAPE, generator=g,
                    device=dev.torch_device)
    pol = mp.resolve(policy)
    recs = []
    CTX.training = False
    for fused in (False, True, True, False):
        enq, tot = [], []
        with fe.enabled_scope(fused), torch.inference_mode(), \
                mp.policy_scope(pol):
            for i in range(turns + 3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model.forward(Tensor(data=x, device=dev))
                t1 = time.perf_counter()
                out.data.float().cpu()
                t2 = time.perf_counter()
                if i >= 3:
                    enq.append((t1 - t0) * 1e3)
                    tot.append((t2 - t0) * 1e3)
        rec = {"forward": policy or "float32", "fused": fused,
               "enqueue_ms_median": float(np.median(enq)),
               "total_ms_median": float(np.median(tot)),
               "total_ms": tot}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def trace_ticks(model, dev, policy, fused, ticks, batch, graph=False):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch.observability.metrics import Registry
    from singa_tpu_torch.ops import fused_epilogue as fe
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    inputs = [rng.standard_normal(chip_smoke.SHAPE, dtype=np.float32)
              for _ in range(batch * ticks)]
    with fe.enabled_scope(fused):
        # the constructor's forward warms this path (and captures it, for
        # a graph)
        eng = model.compile_serving(input_shape=chip_smoke.SHAPE,
                                    batch=batch, device=dev, policy=policy,
                                    queue_capacity=len(inputs),
                                    registry=Registry(), use_graph=graph)
        torch.cuda.synchronize()
        replays = eng.graph_stats()["n_replays"]
        fe.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            futs = [eng.submit(x) for x in inputs]
            eng.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        host = sum(fe.launches.values())
    chip_smoke.check(all(f.done() for f in futs), "a future did not resolve")
    kernels = {}
    n_kernels = launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        launches += chip_smoke.port_kernel(evt.name) is not None
        name = evt.name[:90]
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    replays = eng.graph_stats()["n_replays"] - replays
    chip_smoke.check(replays == (ticks if graph else 0) and
                     not (graph and host),
                     f"{replays} of {ticks} ticks replayed; K2 launches "
                     f"{host} on the host (a replay moves none)")
    rec = {"trace": policy or "float32", "fused": fused, "graph": graph,
           "ticks": ticks, "batch": batch,
           "wall_ms_per_tick": wall * 1e3 / ticks,
           "device_busy_ms_per_tick": busy_ms / ticks,
           "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "device_ops_per_tick": n_kernels / ticks,
           "k2_launches_per_tick": launches / ticks,
           "host_k2_launches_per_tick": host / ticks,
           "img_per_s": batch * ticks / wall,
           "top_device_ms_per_tick": [
               {"name": n, "calls_per_tick": c / ticks,
                "ms_per_tick": ms / ticks} for n, (c, ms) in top]}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--policy", nargs="+",
                    default=["float32", "bf16_mixed"],
                    choices=("float32", "bf16_mixed"))
    ap.add_argument("--layout", default="NCHW", choices=("NCHW", "NHWC"))
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--graph", action="store_true",
                    help="also trace each path's ticks replayed from a "
                    "CUDA graph")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from singa_tpu_torch import cuda_build, device
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import resnet
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    cuda_build.build()
    dev = device.create_cuda_gpu(0)
    model = resnet.resnet50(num_classes=10, layout=args.layout)
    model.eval()
    model.compile_serving(input_shape=chip_smoke.SHAPE,
                          batch=chip_smoke.BATCH, device=dev)
    load_numpy_states(model, chip_smoke.seeded_states(model,
                                                      chip_smoke.SEED))
    recs = [host_us_per_call(dev)]
    for name in args.policy:
        policy = None if name == "float32" else name
        recs += forward_turns(model, dev, policy, args.turns)
        recs += [trace_ticks(model, dev, policy, fused, args.ticks,
                             chip_smoke.BATCH, graph)
                 for fused in (False, True)
                 for graph in ((False, True) if args.graph else (False,))]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = f"profile_serving-{args.layout}" + ("-graph" if args.graph
                                                else "")
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"card": card, "layout": args.layout, "records": recs},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
