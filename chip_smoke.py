#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``singa_tpu_torch``) on one NVIDIA
card.

    python3 chip_smoke.py

It imports nothing of JAX or ``singa_tpu``, and runs these phases; any
failure exits nonzero:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the serving path, from ``singa_tpu_torch/
   csrc``, one ``nvcc`` per source, all started together;
3. kernels: each variant of kernel K2 (plain/residual x NCHW/NHWC) in f32
   and bf16 at ResNet-50 batch-32 shapes (the stem, 32x64x112x112, and the
   layer1 residual tail, 32x256x56x56), held bitwise against its plain
   PyTorch version on the same inputs and timed with CUDA events beside
   the plain version and the HBM-bytes bound;
4. serve: ResNet-50 (224 px, widths 64..2048, 10 classes, weights and
   non-trivial BN running statistics from a numpy seed) through
   ``Model.compile_serving(batch=32)`` -> ``BatchServingEngine``, 96
   requests with the epilogue enabled, held against the port's own
   unfused path on the card (epilogue off, TF32 off for both); then again
   under ``policy="bf16_mixed"``, and a 32-request NHWC run. Each run
   checks that every future resolved and that K2 launched 49 times per
   forward, with the launch counts zeroed just before the run and read
   just after.

Its last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. The full record also
goes to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SHAPE = (3, 224, 224)
BATCH = 32
N_REQUESTS = 96
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM data sheet, f32 outside tensor cores
TAILS_PER_FORWARD = {"affine_relu": 33, "affine_add_relu": 16}
# logits of the fused path against the unfused path, as a fraction of the
# largest |logit|: f32 differs only in the BN fold's rounding; bf16 rounds
# each tail once where the unfused path rounds the BN output and the sum
# separately, and 49 tails compound that
REL_TOL = {"float32": 1e-4, "bf16_mixed": 5e-2}
# the Pallas kernel body each variant replaces
REPLACES = {
    "affine_relu_nchw": "singa_tpu/ops/fused_epilogue.py:86",
    "affine_relu_nhwc": "singa_tpu/ops/fused_epilogue.py:80",
    "affine_add_relu_nchw": "singa_tpu/ops/fused_epilogue.py:101",
    "affine_add_relu_nhwc": "singa_tpu/ops/fused_epilogue.py:93",
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n, c, itemsize, residual):
    """Least time for one call: each input read once, the output written
    once, over the HBM rate; or its f32 operations over the f32 rate."""
    nbytes = n * itemsize * (3 if residual else 2) + 2 * c * 4
    ops = n * (4 if residual else 3)        # mul, add, (add,) max
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev):
    """Every K2 variant in f32 and bf16 at main-path shapes, against its
    plain version; returns one record per case."""
    import torch
    from singa_tpu_torch.ops import fused_epilogue as fe
    g = torch.Generator(device=dev.torch_device)
    g.manual_seed(SEED)
    cases = []
    for layout in ("NCHW", "NHWC"):
        for residual in (False, True):
            nchw = (BATCH, 256, 56, 56) if residual else (BATCH, 64, 112, 112)
            shape = nchw if layout == "NCHW" else \
                (nchw[0], nchw[2], nchw[3], nchw[1])
            c = nchw[1]
            for dtype in (torch.float32, torch.bfloat16):
                def rand(*s):
                    return torch.randn(s, generator=g,
                                       device=dev.torch_device)
                x = rand(*shape).to(dtype)
                r = rand(*shape).to(dtype) if residual else None
                s = torch.rand(c, generator=g, device=dev.torch_device) + .5
                b = rand(c)
                if residual:
                    def kern():
                        return fe.scale_shift_add_relu(x, s, b, r, layout)

                    def plain():
                        return fe.scale_shift_add_relu_reference(
                            x, s, b, r, layout)
                else:
                    def kern():
                        return fe.scale_shift_relu(x, s, b, layout)

                    def plain():
                        return fe.scale_shift_relu_reference(x, s, b,
                                                             layout)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                name = fe.variant(layout, residual)
                check(torch.equal(got, want),
                      f"{name} {dtype}: kernel differs from its plain "
                      f"version (max abs err {err})")
                bms, by = bound(x.numel(), c, x.element_size(), residual)
                rec = {"name": name, "dtype": str(dtype).split(".")[-1],
                       "shape": list(shape), "max_abs_err": err,
                       "ms": time_ms(kern), "plain_ms": time_ms(plain),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": None}
                cases.append(rec)
                print(f"kernel {name} {rec['dtype']} {tuple(shape)}: "
                      f"kernel_ms={rec['ms']:.4f} plain_ms="
                      f"{rec['plain_ms']:.4f} bound_ms={bms:.4f} ({by}, "
                      f"{HBM_BYTES_PER_S / 1e12} TB/s H100 SXM data-sheet "
                      f"rate) library_ms=null (no single PyTorch call "
                      f"computes BN fold + add + ReLU) bitwise=True",
                      flush=True)
                del x, r
    return cases


def seeded_states(model, seed):
    """numpy weights for every state of ``model``: fan-in-scaled normal
    conv/fc weights and non-trivial BN scale, bias and running stats."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in sorted(model.get_states().items()):
        shape = tuple(t.shape)
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 \
                else shape[0]
            v = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(np.sqrt(1.0 / fan_in))
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 2.0, shape)
        else:
            v = rng.standard_normal(shape) * 0.2
        out[k] = np.asarray(v, np.float32)
    return out


def serve(model, dev, inputs, policy, fused, batch=BATCH):
    """Serve ``inputs`` through a fresh engine; returns (logits, engine,
    seconds, launch counts of the run, fused tails of the run). The
    engine's constructor runs one forward of the same path, which warms
    cuDNN and the allocator before the timed run."""
    import numpy as np
    from singa_tpu_torch.observability.metrics import Registry
    from singa_tpu_torch.ops import fused_epilogue as fe
    with fe.enabled_scope(fused):
        eng = model.compile_serving(input_shape=SHAPE, batch=batch,
                                    device=dev, policy=policy,
                                    queue_capacity=len(inputs),
                                    registry=Registry())
        fe.reset_counts()
        t0 = time.perf_counter()
        futs = [eng.submit(x) for x in inputs]
        eng.run_until_idle()
        seconds = time.perf_counter() - t0
        launches, tails = dict(fe.launches), fe.fused_tails
    check(all(f.done() for f in futs), "a future did not resolve")
    logits = np.stack([f.result() for f in futs])
    return logits, eng, seconds, launches, tails


def serve_phase(dev, layout, policy, n_requests, seed=SEED, batch=BATCH):
    """One main-path run: the unfused reference, then the fused path,
    on the same weights and inputs. Returns its record."""
    import numpy as np
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import resnet
    model = resnet.resnet50(num_classes=10, layout=layout)
    model.eval()
    model.compile_serving(input_shape=SHAPE, batch=batch, device=dev)
    load_numpy_states(model, seeded_states(model, seed))
    rng = np.random.default_rng(seed + 1)
    inputs = [rng.standard_normal(SHAPE, dtype=np.float32)
              for _ in range(n_requests)]
    ref, ref_eng, ref_s, ref_launches, _ = serve(model, dev, inputs,
                                                 policy, False, batch)
    check(sum(ref_launches.values()) == 0,
          f"the unfused run launched K2: {ref_launches}")
    got, eng, s, launches, tails = serve(model, dev, inputs, policy, True,
                                         batch)
    ticks = -(-n_requests // batch)
    check(eng.ticks == ticks, f"{eng.ticks} ticks, expected {ticks}")
    check(got.shape == (n_requests, 10) and np.isfinite(got).all(),
          f"logits of shape {got.shape}, or not finite")
    check(tails == 49 * ticks, f"{tails} fused tails, expected 49 x "
          f"{ticks}")
    lo = layout.lower()
    for kind, per in TAILS_PER_FORWARD.items():
        n = launches[f"{kind}_{lo}"]
        check(n == per * ticks, f"{kind}_{lo}: {n} launches, expected "
              f"{per} x {ticks}")
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    pname = policy or "float32"
    check(scale > 0 and err <= REL_TOL[pname] * scale,
          f"{layout} {pname}: fused logits differ from the unfused path by "
          f"{err} (max |logit| {scale}, tolerance {REL_TOL[pname]} x)")
    ts, tt = eng.tick_stats(), eng.ttft_stats()
    rec = {"layout": layout, "policy": pname, "requests": n_requests,
           "batch": batch, "ticks": ticks, "launches": launches,
           "fused_tails": tails, "max_abs_err_vs_unfused": err,
           "max_abs_logit": scale, "img_per_s": n_requests / s,
           "unfused_img_per_s": n_requests / ref_s,
           "tick_p50_ms": ts["p50_s"] * 1e3, "tick_p99_ms": ts["p99_s"] * 1e3,
           "ttft_p50_ms": tt["p50_s"] * 1e3, "ttft_p99_ms": tt["p99_s"] * 1e3,
           "unfused_tick_p50_ms": ref_eng.tick_stats()["p50_s"] * 1e3,
           "top1_agreement": float((got.argmax(1) == ref.argmax(1)).mean())}
    print(f"serve resnet50 {layout} {pname} b{batch} x{n_requests}: "
          f"img/s={rec['img_per_s']:.1f} (unfused {rec['unfused_img_per_s']:.1f}) "
          f"tick p50={rec['tick_p50_ms']:.2f} ms p99={rec['tick_p99_ms']:.2f} ms "
          f"TTFT p50={rec['ttft_p50_ms']:.2f} ms p99={rec['ttft_p99_ms']:.2f} ms "
          f"K2 launches={launches} max_abs_err={err:.3g} "
          f"(max |logit| {scale:.3g})", flush=True)
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from singa_tpu_torch import cuda_build, device
    except ImportError as e:
        print(f"chip_smoke: the singa_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build_s = cuda_build.build(verbose=True)
    print(f"build: {build_s} ({time.perf_counter() - t0:.2f} s wall)",
          flush=True)

    dev = device.create_cuda_gpu(0)
    cases = kernel_phase(dev)
    runs = [serve_phase(dev, "NCHW", None, N_REQUESTS),
            serve_phase(dev, "NCHW", "bf16_mixed", N_REQUESTS),
            serve_phase(dev, "NHWC", None, BATCH)]

    # one line per kernel: its f32 case at main-path shapes, launches from
    # the f32 run of its layout
    kernels = []
    for c in cases:
        if c["dtype"] != "float32":
            continue
        layout = c["name"].rsplit("_", 1)[-1].upper()
        run = next(r for r in runs
                   if r["layout"] == layout and r["policy"] == "float32")
        kernels.append({
            "name": c["name"], "route": "cuda",
            "source": "singa_tpu_torch/csrc/fused_epilogue.cu",
            "replaces": REPLACES[c["name"]],
            "launches": run["launches"][c["name"]],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None})
    kind = torch.cuda.get_device_name(0)
    record = {"card": card, "torch": torch.__version__, "build_s": build_s,
              "kernel_cases": cases, "serve_runs": runs,
              "kernels": kernels}
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
