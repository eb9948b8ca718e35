#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``singa_tpu_torch``) on one NVIDIA
card.

    python3 chip_smoke.py

It imports nothing of JAX or ``singa_tpu``, and runs these phases; any
failure exits nonzero:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, from ``singa_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
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
   just after;
5. kernels (optimizers): K1 (weight decay 1e-5, and again with nesterov),
   K5, K6 and K7 at the largest ResNet-50 parameter (512x512x3x3) and a
   64-element BN vector, each held bitwise against its plain version on
   cloned inputs, with the version of every written tensor checked to go
   up, and timed per call (CUDA events: what a caller pays, host work
   included), on the device alone (``torch.profiler``, over copies that
   exceed the L2 cache) and, for K1 and K5, beside
   ``torch.optim.SGD/Adam(fused=True).step()`` on the same tensor; then
   each timed over a whole ResNet-50 update (its 161 parameter tensors)
   in the same four ways;
6. train: ResNet-50, 224 px, batch 32, f32, TF32 off, NCHW, weights and BN
   statistics from a numpy seed and one fixed synthetic batch, through
   ``Model.compile(is_train=True)`` and ``model(x, y)`` with ``SGD(lr=0.1,
   momentum=0.9, weight_decay=1e-5)``: once with ``fused=True`` (kernel
   K1, 161 launches per step) and once with ``fused=False`` from the same
   start, cuDNN deterministic, every parameter, momentum and running
   statistic held bitwise after the steps; img/s and step p50/p99 from
   CUDA events, the loss per step (finite, falling), peak device memory;
7. eval after training: the fused-trained model (which served once
   before training, so its BN folds were cached) serves one batch through
   K2 (49 launches) and through the unfused path, and their logits agree;
   then K1 updates only the BN scales and biases (106 launches, no
   forward, so no running statistic moves) and the two paths must still
   agree: a fold that K1's in-place writes did not invalidate would not;
8. train (other optimizers): 3 steps each of ``Adam``, ``RMSProp`` and
   ``AdaGrad``, fused against unfused from the same start, held bitwise,
   161 launches of K5, K6 or K7 per step;
9. kernels (flash attention): K3 (``flash_fwd``) and K4's two kernels
   (``flash_bwd_dq``, ``flash_bwd_dkv``) against their plain versions, in
   f32 and bf16, causal and not, at the LM's shape B8 H8 S1024 D64, at a
   ragged S=1000 D=32 and with a position delta, within the stated
   tolerance (TF32 off); each timed at the main-path shape (causal) with
   CUDA events, on the device alone (``torch.profiler``), beside its plain
   version, its bound and ``scaled_dot_product_attention`` (forward, and
   its backward through autograd: a yardstick the port never calls); a
   CUDA tensor with D=512 must raise;
10. LM eval: ``TransformerLM`` at ``bench.py``'s ``LM_SHAPE`` (d_model 512,
   8 heads, 6 layers, seq 1024, vocab 32000), batch 8, weights from a
   numpy seed: one eval forward through K3 (6 launches) and one with
   ``ops.attention.USE_PLAIN`` (none), logits held within the stated
   tolerance, in f32 and under ``compute_dtype=bfloat16``;
11. LM training: the same model with ``fused_head_chunk=8192`` and
   ``SGD(lr=0.1, momentum=0.9, fused=True)``, 8 steps through K3, K4 and
   K1 (6, 6, 6 and 102 launches per step), then the same 8 steps from the
   same start with the plain attention; the loss falls, the parameters of
   the two runs agree within the stated tolerance; tokens/s, step p50/p99
   and peak device memory; then 3 steps under ``compute_dtype=bfloat16``.

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
L2_FLUSH_BYTES = 2 * 50 * 2**20  # twice the H100's 50 MB L2
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
    "sgd": "singa_tpu/ops/fused_optim.py:155",
    "adam": "singa_tpu/ops/fused_optim.py:206",
    "rmsprop": "singa_tpu/ops/fused_optim.py:263",
    "adagrad": "singa_tpu/ops/fused_optim.py:316",
    "flash_fwd": "singa_tpu/ops/attention.py:324",
    "flash_bwd_dq": "singa_tpu/ops/attention.py:388",
    "flash_bwd_dkv": "singa_tpu/ops/attention.py:424",
}
TRAIN_STEPS = 12            # the fused and the unfused SGD run each
TIMED_FROM = 2              # steps before this one warm cuDNN and the pool
OTHER_STEPS = 3
PARAMS_PER_STEP = 161       # ResNet-50: 53 convs, 53 BNs x 2, fc W and b
BF16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16
# the Transformer LM of bench.py's LM leg (LM_SHAPE, n_heads=8, batch 8)
LM = dict(vocab=32000, d_model=512, heads=8, layers=6, seq=1024, batch=8)
LM_STEPS = 8                # the kernel run and the plain run each
LM_TIMED_FROM = 2
LM_BF16_STEPS = 3
LM_PARAMS_PER_STEP = 102    # 16 per block x 6, 2 embeddings, ln_f x 2, head
# kernel against plain version, as a fraction of the largest reference
# value: f32 sums run in another order than the plain version's matmuls;
# bf16 results are rounded once from f32 on both sides, so a value may
# land one bf16 step (2^-8) away
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# LM logits, kernel attention against the plain one, as a fraction of the
# largest |logit|: f32 differs only in attention's summation order; under
# bf16 a one-step difference in an attention output propagates through
# six bf16 layers
LM_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# parameters after LM_STEPS of SGD, kernel run against plain run, per
# tensor |a - b| / |b| (Frobenius): the f32 attention differences above,
# carried through 8 steps of lr 0.1 with momentum
LM_PARAM_TOL = 1e-3
FLASH_KERNEL_NAME = {"flash_fwd": "flash_fwd_kernel",
                     "flash_bwd_dq": "flash_bwd_dq_kernel",
                     "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
# the optimizer settings of each kernel's phases: (the wrapper, its
# keyword arguments, the number of states, bytes moved per f32 element,
# f32 operations per element)
KERNEL_NAME = {"sgd": "sgd_kernel", "sgd_nesterov": "sgd_kernel",
               "adam": "adam_kernel", "rmsprop": "scaled_kernel",
               "adagrad": "scaled_kernel"}
OPTIM_CASES = {
    "sgd": ("sgd_momentum_update",
            dict(momentum=0.9, weight_decay=1e-5), 1, 20, 7),
    "sgd_nesterov": ("sgd_momentum_update",
                     dict(momentum=0.9, weight_decay=1e-5, nesterov=True),
                     1, 20, 9),
    "adam": ("adam_update", dict(beta_1=0.9, beta_2=0.999, epsilon=1e-8),
             2, 28, 14),
    "rmsprop": ("rmsprop_update", dict(rho=0.9, epsilon=1e-8), 1, 20, 8),
    "adagrad": ("adagrad_update", dict(epsilon=1e-8), 1, 20, 6),
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


def device_ms(fn, match, iters=20, attempts=3):
    """Mean device time per call of ``fn``: the durations of the kernels
    whose name contains ``match``, from ``torch.profiler``, over ``iters``
    calls after a warm-up one. Host time between launches is not in it.
    A profiler session that records no device event at all (seen now and
    then on the card's machine) is repeated, up to ``attempts`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and match in e.name]
        if us:
            return sum(us) / 1e3 / iters
        print(f"profiler session {attempt + 1} saw no {match} kernel",
              flush=True)
    raise SmokeFailure(f"the profiler saw no {match} kernel in {attempts} "
                       "sessions")


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


def optim_args(kind, shapes, gen, dev):
    """Fresh (p, g, *states) per shape for one optimizer kernel, and the
    device scalars it takes (lr, and Adam's bias corrections)."""
    import torch
    _, _, n_states, _, _ = OPTIM_CASES[kind]
    positive = kind in ("rmsprop", "adagrad")
    tensors = []
    for shape in shapes:
        def rand(pos=False):
            t = torch.randn(shape, generator=gen, device=dev.torch_device)
            return t.abs() if pos else t
        states = [rand(pos=positive or i == 1) for i in range(n_states)]
        tensors.append([rand(), rand() * 0.1] + states)
    scalars = [torch.tensor(0.01, device=dev.torch_device)]
    if kind == "adam":
        scalars += [torch.tensor(1 - 0.9 ** 3, device=dev.torch_device),
                    torch.tensor(1 - 0.999 ** 3, device=dev.torch_device)]
    return tensors, scalars


def optim_update(kind, tensors, scalars, plain=False):
    from singa_tpu_torch.ops import fused_optim as fo
    name, kw, _, _, _ = OPTIM_CASES[kind]
    fn = getattr(fo, name + ("_reference" if plain else ""))
    for p, g, *states in tensors:
        fn(p, g, *states, *scalars, **kw)


def optim_bound(kind, n):
    _, _, _, nbytes, ops = OPTIM_CASES[kind]
    t_bytes = n * nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_step(kind, tensors):
    """``torch.optim``'s fused step over the same tensors: the yardstick
    for K1 and K5 (None for K6/K7: torch adds eps outside the square
    root, so no PyTorch call computes their function). torch also starts
    SGD's momentum at g on its first step; the timing runs later steps."""
    import torch
    params = [t[0].clone().requires_grad_(True) for t in tensors]
    for p, t in zip(params, tensors):
        p.grad = t[1].clone()
    if kind == "sgd":
        opt = torch.optim.SGD(params, lr=0.01, momentum=0.9,
                              weight_decay=1e-5, fused=True)
    elif kind == "adam":
        opt = torch.optim.Adam(params, lr=0.01, fused=True)
    else:
        return None
    return opt.step


def optim_kernel_phase(dev, param_shapes):
    """Each optimizer kernel against its plain version, bitwise, at the
    largest ResNet-50 parameter and a BN vector; versions checked; then
    timed over one whole ResNet-50 update. Returns (cases, per-kernel
    step timings)."""
    import torch
    gen = torch.Generator(device=dev.torch_device)
    gen.manual_seed(SEED)
    cases = []
    for kind in OPTIM_CASES:
        for shape in ((512, 512, 3, 3), (64,)):
            (mine,), scalars = optim_args(kind, [shape], gen, dev)
            plain = [t.clone() for t in mine]
            written = [mine[0]] + mine[2:]
            versions = [t._version for t in written]
            optim_update(kind, [mine], scalars)
            optim_update(kind, [plain], scalars, plain=True)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(written, [plain[0]] + plain[2:]))
            check(all(torch.equal(a, b) for a, b in
                      zip(written, [plain[0]] + plain[2:])),
                  f"{kind} {shape}: kernel differs from its plain version "
                  f"(max abs err {err})")
            check(all(t._version > v for t, v in zip(written, versions)),
                  f"{kind} {shape}: a written tensor kept its version")
            n = mine[0].numel()
            bms, by = optim_bound(kind, n)
            def kern():
                optim_update(kind, [mine], scalars)
            # device time over a ring of copies that together exceed the
            # 50 MB L2 twice, so each launch finds its tensors in HBM, as
            # a whole-model update does
            per_set = sum(t.numel() * t.element_size() for t in mine)
            ring = [[t.clone() for t in mine]
                    for _ in range(min(8, -(-L2_FLUSH_BYTES // per_set)))]
            turn = iter(range(1 << 30))

            def kern_cold():
                optim_update(kind, [ring[next(turn) % len(ring)]],
                             scalars)
            lib = library_step(kind, [mine])
            if lib is not None:
                lib()               # past torch's first-step momentum init
            rec = {"name": kind, "shape": list(shape), "max_abs_err": err,
                   "ms": time_ms(kern),
                   "device_ms": device_ms(kern_cold, KERNEL_NAME[kind]),
                   "plain_ms": time_ms(lambda: optim_update(
                       kind, [plain], scalars, plain=True)),
                   "bound_ms": bms, "bound_by": by,
                   "library_ms": time_ms(lib) if lib else None}
            cases.append(rec)
            del ring
            lib_s = f"{rec['library_ms']:.4f}" if lib else "null"
            print(f"kernel {kind} {shape}: kernel_ms={rec['ms']:.4f} "
                  f"(device {rec['device_ms']:.4f}) plain_ms="
                  f"{rec['plain_ms']:.4f} bound_ms={bms:.5f} ({by}) "
                  f"library_ms={lib_s} bitwise=True versions bumped",
                  flush=True)
    steps = {}
    for kind in OPTIM_CASES:
        tensors, scalars = optim_args(kind, param_shapes, gen, dev)
        plain = [[t.clone() for t in ts] for ts in tensors]
        n = sum(ts[0].numel() for ts in tensors)
        bms, by = optim_bound(kind, n)
        lib = library_step(kind, tensors)
        if lib is not None:
            lib()                   # past torch's first-step momentum init
        def step():
            optim_update(kind, tensors, scalars)
        rec = {"name": kind, "tensors": len(tensors), "elements": n,
               "ms": time_ms(step, iters=10),
               "device_ms": device_ms(step, KERNEL_NAME[kind], iters=5),
               "plain_ms": time_ms(lambda: optim_update(
                   kind, plain, scalars, plain=True), iters=10),
               "bound_ms": bms, "bound_by": by,
               "library_ms": time_ms(lib, iters=10) if lib else None}
        steps[kind] = rec
        lib_s = f"{rec['library_ms']:.4f}" if lib else "null"
        print(f"step {kind} over {len(tensors)} ResNet-50 tensors ({n} "
              f"elements): kernel_ms={rec['ms']:.4f} (device "
              f"{rec['device_ms']:.4f}) plain_ms="
              f"{rec['plain_ms']:.4f} bound_ms={bms:.4f} ({by}) "
              f"library_ms={lib_s}", flush=True)
        del tensors, plain
    return cases, steps


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


def train_models(dev, seed=SEED):
    """Two ResNet-50s (NCHW, 10 classes) from the same numpy-seeded start,
    compiled for training on one fixed synthetic batch of 32; returns
    them, the batch Tensors and the start."""
    import numpy as np
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import resnet
    from singa_tpu_torch.tensor import Tensor
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((BATCH,) + SHAPE, dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]
    tx, ty = Tensor(data=x, device=dev), Tensor(data=y, device=dev)
    models = []
    for _ in range(2):
        m = resnet.resnet50(num_classes=10)
        m.compile([tx], is_train=True)
        models.append(m)
    start = seeded_states(models[0], seed)
    return models, tx, ty, start


def train_run(model, optimizer, start, tx, ty, steps, kernel):
    """``steps`` train steps from ``start`` with ``optimizer``; the launch
    counts are zeroed just before and read just after. Returns the loss
    per step, the step times (CUDA events, one sync at the end), the
    launches of ``kernel`` and of the other optimizer kernels."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import fused_optim as fo
    load_numpy_states(model, start)
    model.set_optimizer(optimizer)
    model.train()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    losses = []
    torch.cuda.synchronize()
    fo.reset_counts()
    for begin, end in events:
        begin.record()
        _, loss = model(tx, ty)
        end.record()
        losses.append(loss.data.detach())
    counts = dict(fo.launches)
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    times = [b.elapsed_time(e) for b, e in events]
    mine = counts.pop(kernel, 0)
    return losses, times, mine, sum(counts.values())


def held_equal(a, b, what):
    """Every state of model a (and of its optimizer) equals b's bitwise."""
    import torch
    sa, sb = a.get_states(), b.get_states()
    sa.update(a.optimizer.state_tensor_dict())
    sb.update(b.optimizer.state_tensor_dict())
    check(sorted(sa) == sorted(sb), f"{what}: state names differ")
    diff = {k: (sa[k].data.float() - sb[k].data.float()).abs().max().item()
            for k in sa if not torch.equal(sa[k].data, sb[k].data)}
    check(not diff, f"{what}: fused and unfused runs differ in "
          f"{len(diff)} of {len(sa)} states, e.g. "
          f"{sorted(diff.items(), key=lambda kv: -kv[1])[:3]}")
    return len(sa)


def train_phase(dev, models, tx, ty, start):
    """ResNet-50 b32 f32 SGD: fused (K1) against unfused, same start."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    fused, plain = models
    runs = {}
    for name, m in (("fused", fused), ("unfused", plain)):
        torch.cuda.reset_peak_memory_stats()
        sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5,
                      fused=name == "fused")
        losses, times, k1, other = train_run(m, sgd, start, tx, ty,
                                             TRAIN_STEPS, "sgd")
        runs[name] = {"losses": losses, "step_ms": times, "k1": k1,
                      "other_kernel_launches": other,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    f = runs["fused"]
    check(f["k1"] == PARAMS_PER_STEP * TRAIN_STEPS and
          f["other_kernel_launches"] == 0,
          f"fused run: {f['k1']} K1 launches (expected "
          f"{PARAMS_PER_STEP} x {TRAIN_STEPS}), "
          f"{f['other_kernel_launches']} others")
    check(runs["unfused"]["k1"] + runs["unfused"]["other_kernel_launches"]
          == 0, "the unfused run launched an optimizer kernel")
    check(all(np.isfinite(f["losses"])), f"loss not finite: {f['losses']}")
    check(f["losses"][-1] < f["losses"][0],
          f"loss did not fall on the fixed batch: {f['losses']}")
    n_states = held_equal(fused, plain, "SGD")
    rec = {"steps": TRAIN_STEPS, "batch": BATCH, "states_held": n_states,
           "k1_launches": f["k1"], "k1_launches_per_step":
           f["k1"] / TRAIN_STEPS, "losses": f["losses"],
           "unfused_losses": runs["unfused"]["losses"]}
    for name, r in runs.items():
        t = np.asarray(r["step_ms"][TIMED_FROM:])
        pre = "" if name == "fused" else "unfused_"
        rec.update({f"{pre}img_per_s": BATCH * len(t) / (t.sum() / 1e3),
                    f"{pre}step_p50_ms": float(np.percentile(t, 50)),
                    f"{pre}step_p99_ms": float(np.percentile(t, 99)),
                    f"{pre}step_ms": r["step_ms"],
                    f"{pre}peak_device_bytes": r["peak_bytes"]})
    print(f"train resnet50 NCHW f32 b{BATCH} SGD x{TRAIN_STEPS} (timed from "
          f"step {TIMED_FROM}): img/s={rec['img_per_s']:.1f} (unfused "
          f"{rec['unfused_img_per_s']:.1f}) step p50="
          f"{rec['step_p50_ms']:.2f} ms p99={rec['step_p99_ms']:.2f} ms "
          f"(unfused p50 {rec['unfused_step_p50_ms']:.2f} ms) K1 launches="
          f"{f['k1']} ({rec['k1_launches_per_step']:.0f}/step) peak="
          f"{rec['peak_device_bytes'] / 2**30:.2f} GiB; fused == unfused "
          f"bitwise over {n_states} states", flush=True)
    print("train losses: " + " ".join(f"{v:.6f}" for v in f["losses"]),
          flush=True)
    return rec


def eval_after_training(dev, model, inputs):
    """Serve the fused-trained model through K2 and through the unfused
    path; logits must agree (a stale BN fold would not)."""
    import numpy as np
    model.eval()
    ref, _, _, ref_launches, _ = serve(model, dev, inputs, None, False)
    got, _, _, launches, tails = serve(model, dev, inputs, None, True)
    check(sum(ref_launches.values()) == 0, "the unfused serve launched K2")
    for kind, per in TAILS_PER_FORWARD.items():
        n = launches[f"{kind}_nchw"]
        check(n == per, f"{kind}_nchw: {n} launches after training, "
              f"expected {per}")
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    check(np.isfinite(got).all() and scale > 0 and
          err <= REL_TOL["float32"] * scale,
          f"after training, K2 logits differ from the unfused path by {err}"
          f" (max |logit| {scale}): a stale BN fold?")
    print(f"eval after training: 49 K2 launches, max_abs_err={err:.3g} "
          f"(max |logit| {scale:.3g})", flush=True)
    rec = {"launches": launches, "max_abs_err_vs_unfused": err,
           "max_abs_logit": scale}

    # one more fused update of the BN scales and biases alone, with no
    # forward: the running statistics keep their versions, so only K1's
    # in-place writes can invalidate the folds the serve above cached
    import torch
    from singa_tpu_torch.ops import fused_optim as fo
    gen = torch.Generator(device=dev.torch_device)
    gen.manual_seed(SEED)
    bn = {k: t for k, t in model.get_params().items()
          if k.rsplit(".", 1)[-1] in ("scale", "bias")}
    fo.reset_counts()
    for k, t in bn.items():
        model.optimizer.apply(k, t, torch.randn(
            t.shape, generator=gen, device=dev.torch_device) * 0.5)
    n_bn = fo.launches["sgd"]
    check(n_bn == len(bn) == 106, f"{n_bn} K1 launches for {len(bn)} BN "
          "scales and biases, expected 106")
    ref2, _, _, _, _ = serve(model, dev, inputs, None, False)
    got2, _, _, _, _ = serve(model, dev, inputs, None, True)
    moved = float(np.abs(ref2 - ref).max())
    err2 = float(np.abs(got2 - ref2).max())
    scale2 = float(np.abs(ref2).max())
    check(moved > REL_TOL["float32"] * scale2 and
          err2 <= REL_TOL["float32"] * scale2,
          f"after a BN-only K1 update the unfused logits moved by {moved}; "
          f"K2 logits differ from them by {err2} (max |logit| {scale2}): "
          "a stale BN fold?")
    print(f"eval after a BN-only K1 update ({n_bn} launches): logits moved "
          f"by {moved:.3g}, K2 against unfused max_abs_err={err2:.3g}",
          flush=True)
    rec.update({"bn_only_k1_launches": n_bn, "bn_only_moved": moved,
                "bn_only_max_abs_err_vs_unfused": err2})
    return rec


def other_optimizers_phase(models, tx, ty, start):
    """Adam (K5), RMSProp (K6), AdaGrad (K7): 3 steps fused against
    unfused from the same start."""
    import numpy as np
    from singa_tpu_torch import opt
    makers = {"adam": lambda f: opt.Adam(lr=1e-3, fused=f),
              "rmsprop": lambda f: opt.RMSProp(lr=1e-3, fused=f),
              "adagrad": lambda f: opt.AdaGrad(lr=1e-2, fused=f)}
    out = {}
    for kind, make in makers.items():
        res = {}
        for m, fused in zip(models, (True, False)):
            res[fused] = train_run(m, make(fused), start, tx, ty,
                                   OTHER_STEPS, kind)
        losses, times, n, other = res[True]
        check(n == PARAMS_PER_STEP * OTHER_STEPS and other == 0,
              f"{kind}: {n} launches (expected {PARAMS_PER_STEP} x "
              f"{OTHER_STEPS}), {other} of other kernels")
        check(res[False][2] + res[False][3] == 0,
              f"{kind}: the unfused run launched a kernel")
        check(all(np.isfinite(losses)), f"{kind}: loss not finite")
        n_states = held_equal(models[0], models[1], kind)
        out[kind] = {"launches": n, "losses": losses, "step_ms": times,
                     "states_held": n_states}
        print(f"train resnet50 {kind} x{OTHER_STEPS}: {n} launches, losses "
              + " ".join(f"{v:.6f}" for v in losses)
              + f"; fused == unfused bitwise over {n_states} states",
              flush=True)
    return out


def flash_pairs(B, H, Sq, Sk, causal):
    """Unmasked (q, k) pairs: all of them, or k <= q (top-left aligned)."""
    if not causal:
        return B * H * Sq * Sk
    rows = sum(min(i + 1, Sk) for i in range(Sq))
    return B * H * rows


def flash_bound(kind, q, k, causal):
    """Least time of one call: each input read once and each output
    written once over the HBM rate, or its flops over the f32 (f32 inputs)
    or bf16 (bf16 inputs: their products are exact in f32, as on the
    tensor cores) peak; the larger."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    it = q.element_size()
    pairs = flash_pairs(B, H, Sq, Sk, causal)
    qb, kb, rows = B * H * Sq * D * it, B * H * Sk * D * it, B * H * Sq * 4
    if kind == "flash_fwd":
        flops, nbytes = 4 * D * pairs, 2 * qb + 2 * kb + rows
    elif kind == "flash_bwd_dq":
        flops, nbytes = 6 * D * pairs, 3 * qb + 2 * kb + 2 * rows
    else:
        flops, nbytes = 8 * D * pairs, 2 * qb + 4 * kb + 2 * rows
    peak = F32_FLOPS_PER_S if it == 4 else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_case(dev, B, H, Sq, Sk, D, dtype, causal, pos_delta=None, seed=0):
    """K3 and K4 against their plain versions on the same inputs; returns
    the record and the inputs."""
    import torch
    from singa_tpu_torch.ops import attention as at
    gen = torch.Generator(device=dev.torch_device)
    gen.manual_seed(seed)
    q, k, v, g = [torch.randn(B, H, S, D, generator=gen,
                              device=dev.torch_device).to(dtype)
                  for S in (Sq, Sk, Sk, Sq)]
    scale = D ** -0.5
    out, lse = at.flash_fwd(q, k, v, causal, scale, pos_delta=pos_delta)
    ro, rl = at._scan_flash_fwd(q, k, v, causal, scale, pos_delta=pos_delta)
    got = {"out": (out, ro), "lse": (lse, rl)}
    if pos_delta is None:
        grads = at.flash_bwd(q, k, v, out, lse, g, causal, scale)
        want = at._scan_flash_bwd(q, k, v, out, lse, g, causal, scale)
        got.update(zip(("dq", "dk", "dv"), zip(grads, want)))
    torch.cuda.synchronize()
    check(all(a.dtype == b.dtype for a, b in got.values()),
          "flash: a kernel output's dtype differs from the plain version's")
    name = str(dtype).split(".")[-1]
    tol = FLASH_TOL[name]
    errs = {}
    for what, (a, b) in got.items():
        t = tol if what != "lse" else FLASH_TOL["float32"]
        a, b = a.float(), b.float()
        if what == "lse":
            # a fully masked row (pos_delta) has lse -1e30 on both sides;
            # the tolerance is taken over the other rows
            live = b > -1e29
            check(bool((a[~live] <= -1e29).all()),
                  "flash: a fully masked row has a finite lse")
            a, b = a[live], b[live]
        ref = max(1.0, b.abs().max().item()) if b.numel() else 1.0
        err = (a - b).abs().max().item() if b.numel() else 0.0
        errs[what] = err
        check(a.shape == b.shape and torch.isfinite(a).all().item()
              and err <= t * ref,
              f"flash B{B} H{H} Sq{Sq} Sk{Sk} D{D} {name} causal={causal} "
              f"pos_delta={pos_delta}: {what} differs from the plain "
              f"version by {err} (tolerance {t} x {ref})")
    rec = {"shape": [B, H, Sq, Sk, D], "dtype": name, "causal": causal,
           "pos_delta": pos_delta, "max_abs_err": errs, "tolerance": tol}
    print(f"kernel flash B{B} H{H} Sq{Sq} Sk{Sk} D{D} {name} causal={causal}"
          f" pos_delta={pos_delta}: max_abs_err "
          + " ".join(f"{w}={e:.3g}" for w, e in errs.items())
          + f" (tolerance {tol} x max(1, max|ref|))", flush=True)
    return rec, (q, k, v, g, out, lse, scale)


def flash_timings(dtype, inputs, causal):
    """Per-call ms of K3, K4-dQ and K4-dKV (CUDA events and device time),
    the plain versions, the bounds and SDPA's forward and backward."""
    import torch
    import torch.nn.functional as F
    from singa_tpu_torch.ops import attention as at
    q, k, v, g, out, lse, scale = inputs
    delta = (g.float() * out.float()).sum(-1)
    calls = {
        "flash_fwd": lambda: at.flash_fwd(q, k, v, causal, scale),
        "flash_bwd_dq": lambda: at.flash_bwd_dq(q, k, v, g, lse, delta,
                                                causal, scale),
        "flash_bwd_dkv": lambda: at.flash_bwd_dkv(q, k, v, g, lse, delta,
                                                  causal, scale)}
    plain_fwd = time_ms(lambda: at._scan_flash_fwd(q, k, v, causal, scale),
                        iters=5, warmup=1)
    plain_bwd = time_ms(lambda: at._scan_flash_bwd(q, k, v, out, lse, g,
                                                   causal, scale),
                        iters=5, warmup=1)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                             scale=scale)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale))
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), g, retain_graph=True))
    recs = {}
    name = str(dtype).split(".")[-1]
    for kind, fn in calls.items():
        bms, by = flash_bound(kind, q, k, causal)
        fwd = kind == "flash_fwd"
        recs[kind] = {"dtype": name, "shape": list(q.shape), "causal": causal,
                      "ms": time_ms(fn),
                      "device_ms": device_ms(fn, FLASH_KERNEL_NAME[kind]),
                      "plain_ms": plain_fwd if fwd else plain_bwd,
                      "plain_note": None if fwd else
                      "the whole plain backward (dq, dk and dv)",
                      "bound_ms": bms, "bound_by": by,
                      "library_ms": lib_fwd if fwd else lib_bwd,
                      "library": "scaled_dot_product_attention forward"
                      if fwd else "scaled_dot_product_attention backward "
                      "through autograd (dq, dk and dv)"}
        r = recs[kind]
        print(f"kernel {kind} {name} {tuple(q.shape)} causal={causal}: "
              f"kernel_ms={r['ms']:.4f} (device {r['device_ms']:.4f}) "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={bms:.4f} ({by}) "
              f"library_ms={r['library_ms']:.4f} ({r['library']})",
              flush=True)
    return recs


def flash_kernel_phase(dev):
    """K3/K4 against their plain versions in every case, timed at the
    main-path shape; a head dim above 256 must raise."""
    import torch
    from singa_tpu_torch.ops import attention as at
    B, H, S = LM["batch"], LM["heads"], LM["seq"]
    D = LM["d_model"] // LM["heads"]
    cases, timings = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            rec, inputs = flash_case(dev, B, H, S, S, D, dtype, causal)
            cases.append(rec)
            if causal:
                timings[rec["dtype"]] = flash_timings(dtype, inputs, causal)
            del inputs
        cases.append(flash_case(dev, 2, 4, 1000, 1000, 32, dtype, True,
                                seed=1)[0])
    cases.append(flash_case(dev, B, H, S, S, D, torch.float32, True,
                            pos_delta=-300, seed=2)[0])
    big = torch.zeros(1, 1, 8, 512, device=dev.torch_device)
    try:
        at.flash_fwd(big, big, big, True, 1.0)
    except ValueError as e:
        print(f"kernel flash D=512 on the card: raised ValueError ({e})",
              flush=True)
    else:
        raise SmokeFailure("flash_fwd took a head dim of 512")
    return cases, timings


def lm_states(model, seed):
    """numpy weights for every state of an LM: fan-in-scaled normal
    projections, N(0, 0.02) embeddings, LayerNorm scales near 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in sorted(model.get_states().items()):
        shape = tuple(t.shape)
        leaf = k.rsplit(".", 1)[-1]
        if k.endswith("emb.W"):
            v = rng.standard_normal(shape) * 0.02
        elif leaf == "W":
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[0])
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.standard_normal(shape) * 0.02
        out[k] = np.asarray(v, np.float32)
    return out


def lm_model(dev, tx, compute_dtype=None, train=True):
    from singa_tpu_torch.models import transformer
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=LM["layers"], max_len=LM["seq"], tp=False,
        fused_head_chunk=8192, compute_dtype=compute_dtype)
    m.compile([tx], is_train=train, use_graph=True)
    return m


def lm_data(dev, seed=SEED):
    """Token ids uniform over the vocab from a numpy seed (bench.py's
    data), targets shifted by one; as float Tensors on the card."""
    import numpy as np
    from singa_tpu_torch.tensor import Tensor
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, LM["vocab"], (LM["batch"], LM["seq"])) \
        .astype(np.float32)
    tgt = np.roll(ids, -1, 1)
    return Tensor(data=ids, device=dev), Tensor(data=tgt, device=dev)


def flash_counts():
    from singa_tpu_torch.ops import attention as at
    return dict(at.launches)


def lm_eval_phase(dev, tx, start):
    """One eval forward through K3 and one with the plain attention, in f32
    and under compute_dtype=bfloat16; logits within LM_LOGIT_TOL."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import attention as at
    out = {}
    for name, cdt in (("float32", None), ("bfloat16", torch.bfloat16)):
        m = lm_model(dev, tx, cdt, train=False)
        load_numpy_states(m, start)
        m.eval()
        at.reset_counts()
        got = m(tx).data
        torch.cuda.synchronize()
        k_counts = flash_counts()
        at.USE_PLAIN = True
        try:
            at.reset_counts()
            want = m(tx).data
            torch.cuda.synchronize()
            p_counts = flash_counts()
        finally:
            at.USE_PLAIN = False
        check(k_counts == {"flash_fwd": LM["layers"], "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0},
              f"LM eval {name}: flash launches {k_counts}, expected "
              f"{LM['layers']} of flash_fwd")
        check(sum(p_counts.values()) == 0,
              f"LM eval {name}: the plain run launched {p_counts}")
        shape = (LM["batch"], LM["seq"], LM["vocab"])
        check(tuple(got.shape) == shape and torch.isfinite(got).all().item(),
              f"LM eval {name}: logits {tuple(got.shape)} or not finite")
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        check(scale > 0 and err <= LM_LOGIT_TOL[name] * scale,
              f"LM eval {name}: logits through K3 differ from the plain "
              f"attention by {err} (max |logit| {scale}, tolerance "
              f"{LM_LOGIT_TOL[name]} x)")
        out[name] = {"launches": k_counts, "max_abs_err": err,
                     "max_abs_logit": scale,
                     "tolerance": LM_LOGIT_TOL[name]}
        print(f"LM eval {name} B{LM['batch']} S{LM['seq']}: K3 launches="
              f"{k_counts['flash_fwd']} (plain run 0), logits max_abs_err="
              f"{err:.3g} (max |logit| {scale:.3g}, tolerance "
              f"{LM_LOGIT_TOL[name]} x)", flush=True)
        del m, got, want
        torch.cuda.empty_cache()
    return out


def lm_train_run(model, start, tx, ty, steps):
    """``steps`` SGD steps from ``start`` with a fresh fused optimizer; the
    launch counts are zeroed just before and read just after. Returns the
    losses, the step times (CUDA events), the launches and the peak
    device memory."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.ops import fused_optim as fo
    load_numpy_states(model, start)
    model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    model.train()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at.reset_counts()
    fo.reset_counts()
    for begin, end in events:
        begin.record()
        _, loss = model(tx, ty)
        end.record()
        losses.append(loss.data.detach())
    counts = dict(flash_counts(), sgd=fo.launches["sgd"],
                  other_optim=sum(v for k, v in fo.launches.items()
                                  if k != "sgd"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    model.eval()
    return ([float(v) for v in losses],
            [b.elapsed_time(e) for b, e in events], counts, peak)


def lm_train_phase(dev, tx, ty, start):
    """LM_STEPS f32 steps through K3/K4/K1, the same steps with the plain
    attention, then LM_BF16_STEPS under compute_dtype=bfloat16."""
    import numpy as np
    import torch
    from singa_tpu_torch.ops import attention as at
    m = lm_model(dev, tx)
    losses, times, counts, peak = lm_train_run(m, start, tx, ty, LM_STEPS)
    mine = {k: v.data.detach().clone() for k, v in m.get_params().items()}
    at.USE_PLAIN = True
    try:
        p_losses, p_times, p_counts, p_peak = lm_train_run(
            m, start, tx, ty, LM_STEPS)
    finally:
        at.USE_PLAIN = False
    per_step = {"flash_fwd": LM["layers"], "flash_bwd_dq": LM["layers"],
                "flash_bwd_dkv": LM["layers"], "sgd": LM_PARAMS_PER_STEP,
                "other_optim": 0}
    want = {k: v * LM_STEPS for k, v in per_step.items()}
    check(counts == want, f"LM train: launches {counts}, expected {want}")
    check(p_counts["flash_fwd"] + p_counts["flash_bwd_dq"]
          + p_counts["flash_bwd_dkv"] == 0,
          f"LM train: the plain run launched {p_counts}")
    check(len(mine) == LM_PARAMS_PER_STEP,
          f"the LM has {len(mine)} parameter tensors")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"LM train: loss not finite or not falling: {losses}")
    rel = {}
    for k, v in m.get_params().items():
        b = v.data.detach().float()
        rel[k] = ((mine[k].float() - b).norm() / b.norm()).item()
    worst = max(rel, key=rel.get)
    check(rel[worst] <= LM_PARAM_TOL,
          f"LM train: parameters after {LM_STEPS} steps differ between the "
          f"kernel and the plain run by {rel[worst]} (relative, {worst}; "
          f"tolerance {LM_PARAM_TOL})")
    toks = LM["batch"] * LM["seq"]
    t = np.asarray(times[LM_TIMED_FROM:])
    pt = np.asarray(p_times[LM_TIMED_FROM:])
    rec = {"steps": LM_STEPS, "batch": LM["batch"], "seq": LM["seq"],
           "losses": losses, "plain_losses": p_losses,
           "launches": counts, "launches_per_step":
           {k: v / LM_STEPS for k, v in counts.items()},
           "max_param_rel_diff": rel[worst], "max_param_rel_diff_at": worst,
           "param_tolerance": LM_PARAM_TOL,
           "tokens_per_s": toks * len(t) / (t.sum() / 1e3),
           "step_p50_ms": float(np.percentile(t, 50)),
           "step_p99_ms": float(np.percentile(t, 99)), "step_ms": times,
           "peak_device_bytes": peak,
           "plain_tokens_per_s": toks * len(pt) / (pt.sum() / 1e3),
           "plain_step_p50_ms": float(np.percentile(pt, 50)),
           "plain_peak_device_bytes": p_peak}
    print(f"train LM f32 B{LM['batch']} S{LM['seq']} SGD x{LM_STEPS} (timed "
          f"from step {LM_TIMED_FROM}): tokens/s={rec['tokens_per_s']:.0f} "
          f"(plain attention {rec['plain_tokens_per_s']:.0f}) step p50="
          f"{rec['step_p50_ms']:.2f} ms p99={rec['step_p99_ms']:.2f} ms "
          f"(plain p50 {rec['plain_step_p50_ms']:.2f} ms) peak="
          f"{peak / 2**30:.2f} GiB (plain {p_peak / 2**30:.2f} GiB) "
          f"launches/step={rec['launches_per_step']} max param rel diff "
          f"vs plain={rel[worst]:.3g} ({worst}; tolerance {LM_PARAM_TOL})",
          flush=True)
    print("train LM losses: " + " ".join(f"{v:.6f}" for v in losses)
          + " | plain: " + " ".join(f"{v:.6f}" for v in p_losses),
          flush=True)
    del m, mine
    torch.cuda.empty_cache()

    mb = lm_model(dev, tx, torch.bfloat16)
    b_losses, b_times, b_counts, b_peak = lm_train_run(mb, start, tx, ty,
                                                       LM_BF16_STEPS)
    want_b = {k: v * LM_BF16_STEPS for k, v in per_step.items()}
    check(b_counts == want_b,
          f"LM train bf16: launches {b_counts}, expected {want_b}")
    check(all(np.isfinite(b_losses)) and b_losses[-1] < b_losses[0],
          f"LM train bf16: loss not finite or not falling: {b_losses}")
    rec["bf16"] = {"steps": LM_BF16_STEPS, "losses": b_losses,
                   "step_ms": b_times, "launches": b_counts,
                   "peak_device_bytes": b_peak}
    print(f"train LM bf16 x{LM_BF16_STEPS}: losses "
          + " ".join(f"{v:.6f}" for v in b_losses)
          + " step ms " + " ".join(f"{v:.1f}" for v in b_times)
          + f" launches={b_counts} peak={b_peak / 2**30:.2f} GiB",
          flush=True)
    del mb
    torch.cuda.empty_cache()
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

    import numpy as np
    models, tx, ty, start = train_models(dev)
    shapes = [tuple(t.shape) for t in models[0].get_params().values()]
    check(len(shapes) == PARAMS_PER_STEP,
          f"ResNet-50 has {len(shapes)} parameter tensors")
    optim_cases, optim_steps = optim_kernel_phase(dev, shapes)
    # serve once before training: the BN folds are cached now, and K1's
    # in-place writes must invalidate them
    rng = np.random.default_rng(SEED + 3)
    eval_inputs = [rng.standard_normal(SHAPE, dtype=np.float32)
                   for _ in range(BATCH)]
    models[0].eval()
    serve(models[0], dev, eval_inputs, None, True)
    torch.backends.cudnn.deterministic = True
    train = train_phase(dev, models, tx, ty, start)
    evaluated = eval_after_training(dev, models[0], eval_inputs)
    others = other_optimizers_phase(models, tx, ty, start)
    torch.backends.cudnn.deterministic = False
    del models, tx, ty, start
    torch.cuda.empty_cache()

    flash_cases, flash_times = flash_kernel_phase(dev)
    lm_tx, lm_ty = lm_data(dev)
    lm_start = lm_states(lm_model(dev, lm_tx, train=False), SEED + 4)
    lm_eval = lm_eval_phase(dev, lm_tx, lm_start)
    lm_train = lm_train_phase(dev, lm_tx, lm_ty, lm_start)

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
    launches = {"sgd": train["k1_launches"],
                **{k: v["launches"] for k, v in others.items()}}
    for kind, n in launches.items():
        step = optim_steps[kind]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": "singa_tpu_torch/csrc/fused_optim.cu",
            "replaces": REPLACES[kind], "launches": n,
            "max_abs_err": max(c["max_abs_err"] for c in optim_cases
                               if c["name"].split("_")[0] == kind),
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": step["library_ms"]})
    # K3/K4: the f32 causal timings at the LM's shape, launches from the
    # f32 LM training run, the largest error over every case
    outputs = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
               "flash_bwd_dkv": ("dk", "dv")}
    for kname, t in flash_times["float32"].items():
        errs = [c["max_abs_err"][w] for c in flash_cases
                for w in outputs[kname] if w in c["max_abs_err"]]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "singa_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES[kname],
            "launches": lm_train["launches"][kname],
            "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kind = torch.cuda.get_device_name(0)
    record = {"card": card, "torch": torch.__version__, "build_s": build_s,
              "kernel_cases": cases, "serve_runs": runs,
              "optim_kernel_cases": optim_cases,
              "optim_steps": optim_steps, "train": train,
              "eval_after_training": evaluated, "train_other": others,
              "flash_cases": flash_cases, "flash_timings": flash_times,
              "lm_eval": lm_eval, "lm_train": lm_train,
              "kernels": kernels}
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    # every phase ran on the one card it was given
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
