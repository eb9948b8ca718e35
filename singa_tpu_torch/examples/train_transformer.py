#!/usr/bin/env python3
"""Train the Transformer LM with the PyTorch/CUDA port on synthetic tokens.

    python3 singa_tpu_torch/examples/train_transformer.py --seq 1024 \\
        --d-model 512 --heads 8 --layers 6 --vocab 32000 \\
        --fused-head-chunk 8192 --fused-optim

The single-device subset of ``examples/train_transformer.py``: the same
model arguments, the same synthetic data (token ids uniform over the
vocab from numpy seed 0, targets the ids shifted by one), ``SGD(lr=0.1,
momentum=0.9)`` (``--fused-optim`` sends every update through kernel K1),
one warm-up step, then ``--steps`` steps with the loss every 5 and the
tokens/s at the end. Every attention call runs the flash-attention
kernels K3 (forward) and K4 (backward). It runs on the card unless
``--cpu`` is given.

Not ported yet, each refused with a pointer to ROADMAP.md: ``--tp``,
``--sp`` and ``--ep`` above 1 (tensor, sequence and expert parallelism
need a device mesh), ``--moe`` and ``--generate`` (KV-cache decoding).
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
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--moe", type=int, default=0)
    ap.add_argument("--fused-head-chunk", type=int, default=0,
                    help="train through the chunked fused CE head: the "
                         "(B, S, V) logits are never materialised")
    ap.add_argument("--generate", type=int, default=0)
    ap.add_argument("--bf16", action="store_true",
                    help="compute_dtype=bfloat16 for the transformer stack; "
                         "embeddings and the loss softmax stay f32")
    ap.add_argument("--fused-optim", action="store_true",
                    help="update every parameter through kernel K1")
    ap.add_argument("--cpu", action="store_true")
    return ap


def _refuse(args):
    """What this example does not do yet, each naming ROADMAP.md."""
    for flag, n in (("--tp", args.tp), ("--sp", args.sp), ("--ep", args.ep)):
        if n > 1:
            return f"{flag} {n}: tensor, sequence and expert parallelism " \
                "need a device mesh and are not ported yet (ROADMAP.md)"
    if args.moe:
        return "--moe: the expert-parallel FFN is not ported yet (ROADMAP.md)"
    if args.generate:
        return "--generate: KV-cache decoding is not ported yet " \
            "(ROADMAP.md: LM serving, slice D)"
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    refused = _refuse(args)
    if refused:
        raise SystemExit(refused)

    import torch
    from singa_tpu_torch import device, opt, tensor
    from singa_tpu_torch.examples.train_cnn import graph_line
    from singa_tpu_torch.models import transformer

    dev = device.create_cpu_device() if args.cpu \
        else device.create_cuda_gpu(0)
    dev.SetRandSeed(0)
    print(f"device: {dev.torch_device}", flush=True)

    rng = np.random.RandomState(0)
    ids = rng.randint(0, args.vocab, (args.bs, args.seq)).astype(np.float32)
    tgt = np.roll(ids, -1, axis=1)
    tx = tensor.Tensor(data=ids, device=dev)
    ty = tensor.Tensor(data=tgt, device=dev)

    model = transformer.TransformerLM(
        args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, max_len=args.seq, tp=False,
        fused_head_chunk=args.fused_head_chunk or None,
        compute_dtype=torch.bfloat16 if args.bf16 else None)
    model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9,
                                fused=args.fused_optim))
    model.compile([tx], is_train=True, use_graph=True)

    model(tx, ty)  # warm-up
    if dev.is_cuda:
        torch.cuda.synchronize()
    t0 = time.time()
    for step in range(args.steps):
        _, loss = model(tx, ty)
        if step % 5 == 0:
            print(f"step {step}: loss {float(loss.data.detach()):.4f}",
                  flush=True)
    if dev.is_cuda:
        torch.cuda.synchronize()
    toks = args.bs * args.seq * args.steps / (time.time() - t0)
    print(f"throughput {toks:.0f} tokens/s", flush=True)
    print(graph_line(model, dev), flush=True)
    return model


if __name__ == "__main__":
    main()
