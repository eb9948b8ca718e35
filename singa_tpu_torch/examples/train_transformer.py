#!/usr/bin/env python3
"""Train the Transformer LM with the PyTorch/CUDA port on synthetic tokens.

    python3 singa_tpu_torch/examples/train_transformer.py --seq 1024 \\
        --d-model 512 --heads 8 --layers 6 --vocab 32000 \\
        --fused-head-chunk 8192 --fused-optim
    torchrun --nproc_per_node 2 singa_tpu_torch/examples/train_transformer.py \\
        --tp 2 [--sp 2] [--generate 16]
    torchrun --nproc_per_node 2 \\
        singa_tpu_torch/examples/train_transformer.py --moe 8 --ep 2

The counterpart of ``examples/train_transformer.py``: the same model
arguments, the same synthetic data (token ids uniform over the vocab from
numpy seed 0, targets the ids shifted by one), ``SGD(lr=0.1,
momentum=0.9)`` (``--fused-optim`` sends every update through kernel K1),
one warm-up step, then ``--steps`` steps with the loss every 5 and the
tokens/s at the end, and with ``--generate N`` N tokens decoded greedily
from the first row after training. Every attention call runs the
flash-attention kernels K3 (forward) and K4 (backward); a ring hop runs
K3 with a position delta. ``--moe N`` replaces each block's FFN by N
experts (``parallel/moe.py``, top-2, capacity factor 1.25), whose
load-balance losses join the loss. It runs on the card unless ``--cpu``
is given.

Under ``torchrun`` (world = tp x sp x ep x data) each rank joins the process
group: over NCCL on the card ``cuda:LOCAL_RANK`` when every rank has a
card of its own, else over gloo, the ranks taking the cards in turn
(NCCL refuses two ranks on one device), and over gloo with ``--cpu``.
Gloo runs eagerly: a CUDA graph cannot capture its collectives. The mesh is
``MeshConfig(model=tp, seq=sp, expert=ep)``, the optimizer a ``DistOpt``
with ``reduce_axes=("data", "expert", "seq")``, and every rank is called
with the global batch: ``input_specs`` shard it over ``data`` (with
``--ep`` over ``("data", "expert")``: expert peers hold distinct tokens)
and its tokens over ``seq``, as the JAX example's step does. Without
``torchrun`` the example runs one process, with no mesh.
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


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from singa_tpu_torch import device
    from singa_tpu_torch.parallel import communicator

    # torchrun's variables; without them one process, no mesh
    launched = "WORLD_SIZE" in os.environ
    rank = int(os.environ["RANK"]) if launched else 0
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    need = args.tp * args.sp * args.ep
    if need > world:
        raise SystemExit(
            f"--tp {args.tp} --sp {args.sp} --ep {args.ep} takes {need} "
            f"ranks or more, this run has {world}: launch it with torchrun "
            f"--nproc_per_node {need}")
    # NCCL takes one rank per card: ranks that share a card join over gloo
    cards = torch.cuda.device_count()
    backend = "gloo" if args.cpu or world > cards else "nccl"
    if args.cpu:
        dev = device.create_cpu_device()
    else:
        local = int(os.environ.get("LOCAL_RANK", 0)) if launched else 0
        dev = device.create_cuda_gpu(local % max(cards, 1))
    if launched:
        communicator.init_process(communicator.NcclIdHolder(), rank, world,
                                  device=dev, backend=backend)
    try:
        return train(args, dev, rank, world if launched else None)
    finally:
        if launched:
            torch.distributed.destroy_process_group()


def train(args, dev, rank, world):
    """The training loop of ``main`` as rank ``rank`` of ``world`` (None:
    one process, no mesh)."""
    import torch
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.examples.train_cnn import graph_line
    from singa_tpu_torch.models import transformer

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    dev.SetRandSeed(0)
    say(f"device: {dev.torch_device}")

    rng = np.random.RandomState(0)
    ids = rng.randint(0, args.vocab, (args.bs, args.seq)).astype(np.float32)
    tgt = np.roll(ids, -1, axis=1)
    tx = tensor.Tensor(data=ids, device=dev)
    ty = tensor.Tensor(data=tgt, device=dev)

    model = transformer.TransformerLM(
        args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, max_len=args.seq + args.generate,
        tp=args.tp > 1, seq_axis="seq" if args.sp > 1 else None,
        moe=args.moe or None,
        fused_head_chunk=args.fused_head_chunk or None,
        compute_dtype=torch.bfloat16 if args.bf16 else None)
    sgd = opt.SGD(lr=0.1, momentum=0.9, fused=args.fused_optim)
    use_graph = True
    if world is None:
        model.set_optimizer(sgd)
    else:
        from singa_tpu_torch.parallel import mesh as mesh_mod
        from singa_tpu_torch.parallel.communicator import set_mesh
        from singa_tpu_torch.parallel.gspmd import P
        dist = opt.DistOpt(sgd, reduce_axes=("data", "expert", "seq"))
        msh = mesh_mod.make_mesh(config=mesh_mod.MeshConfig(
            model=args.tp, seq=args.sp, expert=args.ep))
        say(f"mesh: {mesh_mod.axis_sizes(msh)} over {world} ranks "
            f"({torch.distributed.get_backend()})")
        dist.communicator.mesh = msh
        set_mesh(msh)
        model.set_optimizer(dist)
        # every rank takes the global batch; its rows shard over every
        # batch-like axis in use (data, and expert: expert peers hold
        # distinct tokens), its tokens over seq
        batch_ax = ("data", "expert") if args.ep > 1 else "data"
        spec = P(batch_ax, "seq") if args.sp > 1 else P(batch_ax)
        model.input_specs = [spec, spec]
        if args.sp > 1 or args.ep > 1:
            model.output_specs = [spec, P()]
        # a CUDA graph cannot capture gloo's collectives
        use_graph = not (dev.is_cuda and
                         torch.distributed.get_backend() == "gloo")
    model.compile([tx], is_train=True, use_graph=use_graph)

    model(tx, ty)  # warm-up
    if dev.is_cuda:
        torch.cuda.synchronize()
    t0 = time.time()
    for step in range(args.steps):
        _, loss = model(tx, ty)
        if step % 5 == 0:
            say(f"step {step}: loss {float(loss.data.detach()):.4f}")
    if dev.is_cuda:
        torch.cuda.synchronize()
    toks = args.bs * args.seq * args.steps / (time.time() - t0)
    say(f"throughput {toks:.0f} tokens/s")
    say(graph_line(model, dev))
    if args.generate:
        out = model.generate(ids[:1], max_new_tokens=args.generate,
                             temperature=0)    # first row only
        say("generated:", out[0, -args.generate:].tolist())
    return model


if __name__ == "__main__":
    main()
