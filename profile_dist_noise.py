#!/usr/bin/env python3
"""How far two data-parallel ranks' ResNet-50 lies from one rank's whole
batch, beside how far two equivalent whole-batch runs lie apart, on one
NVIDIA card.

    python3 profile_dist_noise.py [--steps 3] [--out FILE.json]

chip_smoke.py's phase 17 (b) setup: ResNet-50 (224 px, 10 classes) from
the training phases' numpy-seeded start, one synthetic batch of 32,
``SGD(lr=1e-3, momentum=0.9, weight_decay=1e-5)``, cuDNN deterministic,
TF32 off, eager. For f32 (the fused SGD) and for f64 (every state and the
batch cast, the plain SGD) it runs ``--steps`` steps three times on one
rank -- the batch as it is, the batch with its halves swapped, the batch
as it is again -- and once as two processes of this script joined over
gloo on the one card, each on its half (``DistOpt``, sync-BN). It prints,
for each dtype and step, the largest distance of a state and of a
momentum from the whole-batch run (``|got - want| / |want|``, Frobenius
norms) for the two ranks, the swapped batch and the repeat, with the
count beyond tests/test_torch_resnet_training.py's bounds (5e-3 for a
state, 5e-2 for a momentum), the tensors farthest apart, and the losses.
``--out`` writes every distance as JSON. It needs the card, and exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BOUNDS = {"state": 5e-3, "momentum": 5e-2}
RANKS = 2


def _setup():
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def _run(dev, x, y, start, dtype, steps, dist):
    """``steps`` eager steps of a fresh ResNet-50 from ``start``; the
    losses and every state (f64 host arrays) after each step."""
    import torch
    import chip_smoke as cs
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import resnet
    from singa_tpu_torch.tensor import Tensor
    tx = Tensor(data=x.to(dtype), device=dev)
    ty = Tensor(data=y.to(dtype), device=dev)
    m = resnet.resnet50(num_classes=10)
    sgd = cs.dist_sgd(opt, fused=dtype == torch.float32)
    m.set_optimizer(opt.DistOpt(sgd) if dist else sgd)
    m.compile([tx], is_train=True, use_graph=False)
    load_numpy_states(m, start)
    if dtype == torch.float64:
        cs.as_float64(m)
    m.train()
    losses, snaps = [], []
    for _ in range(steps):
        _, loss = m(tx, ty)
        losses.append(float(loss.data.detach()))
        snaps.append({k: v.double().cpu().numpy()
                      for k, v in cs.live_states(m).items()})
    return losses, snaps


def rank_main(rank, work, steps):
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from singa_tpu_torch import datasets, device
    from singa_tpu_torch.parallel import communicator as C
    _setup()
    dev = device.create_cuda_gpu(0)
    C.init_process(C.NcclIdHolder(file=os.path.join(work, "store")), rank,
                   RANKS, device=dev, backend="gloo", timeout_s=300)
    try:
        with np.load(os.path.join(work, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        start = {k[len("start/"):]: v for k, v in inputs.items()
                 if k.startswith("start/")}
        bx, by = datasets.partition(rank, RANKS, inputs["x"], inputs["y"])
        out = {}
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).split(".")[-1]
            losses, snaps = _run(dev, torch.from_numpy(bx),
                                 torch.from_numpy(by), start, dtype, steps,
                                 True)
            out[f"{tag}/losses"] = np.asarray(losses)
            for i, snap in enumerate(snaps):
                for k, v in snap.items():
                    out[f"{tag}/{i}/{k}"] = v
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _rel(a, b):
    import numpy as np
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_dist_noise: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from singa_tpu_torch import cuda_build, device
    print(f"card: {cs.card_line()}", flush=True)
    _setup()
    cuda_build.build()
    dev = device.create_cuda_gpu(0)
    models, tx, ty, start = cs.train_models(dev)
    del models
    x, y = tx.data, ty.data
    half = x.shape[0] // 2
    order = torch.arange(x.shape[0], device=x.device)
    swap = torch.cat([order[half:], order[:half]])
    runs = {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[-1]
        for name, o in (("whole", order), ("swapped", swap),
                        ("again", order)):
            runs[(tag, name)] = _run(dev, x[o], y[o], start, dtype,
                                     args.steps, False)
    work = tempfile.mkdtemp(prefix="profile_dist_noise_")
    try:
        np.savez(os.path.join(work, "inputs.npz"), x=x.cpu().numpy(),
                 y=y.cpu().numpy(),
                 **{f"start/{k}": v for k, v in start.items()})
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             work, str(args.steps)],
            stdout=open(os.path.join(work, f"rank{r}.log"), "w"),
            stderr=subprocess.STDOUT) for r in range(RANKS)]
        try:
            for p in procs:
                p.wait(timeout=max(0.0, 600 - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            for r in range(RANKS):
                print(open(os.path.join(work, f"rank{r}.log")).read()[-3000:],
                      file=sys.stderr)
            return 1
        ranks = []
        for r in range(RANKS):
            with np.load(os.path.join(work, f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report = {"card": cs.card_line(), "steps": args.steps}
    for tag in ("float32", "float64"):
        r0 = ranks[0]
        equal = all(np.array_equal(r0[k], ranks[1][k])
                    for k in r0 if k.startswith(tag))
        losses = {"whole": runs[(tag, "whole")][0],
                  "ranks": r0[f"{tag}/losses"].tolist(),
                  "swapped": runs[(tag, "swapped")][0],
                  "again": runs[(tag, "again")][0]}
        report[tag] = {"losses": losses, "ranks_bitwise_equal": equal}
        print(f"{tag}: the ranks bitwise equal: {equal}; losses "
              + json.dumps(losses), flush=True)
        for i in range(args.steps):
            want = runs[(tag, "whole")][1][i]
            per = {}
            for k, w in want.items():
                per[k] = {"ranks": _rel(r0[f"{tag}/{i}/{k}"], w),
                          "swapped": _rel(runs[(tag, "swapped")][1][i][k], w),
                          "again": _rel(runs[(tag, "again")][1][i][k], w)}
            report[tag][f"step{i + 1}"] = per
            for what in ("ranks", "swapped", "again"):
                line = []
                for kind in ("state", "momentum"):
                    vals = [v[what] for k, v in per.items()
                            if (kind == "momentum") == k.endswith(
                                ":momentum")
                            and not (kind == "state"
                                     and k.startswith("optimizer/"))]
                    line.append(f"{kind} max {max(vals):.3g}, "
                                f"{sum(v > BOUNDS[kind] for v in vals)} of "
                                f"{len(vals)} beyond {BOUNDS[kind]}")
                print(f"  step {i + 1} {what:8s}: " + "; ".join(line),
                      flush=True)
            far = sorted(per.items(), key=lambda kv: -kv[1]["ranks"])[:3]
            print("    farthest (ranks): " + ", ".join(
                f"{k} {v['ranks']:.3g}" for k, v in far), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3], int(sys.argv[4])))
    sys.exit(main())
