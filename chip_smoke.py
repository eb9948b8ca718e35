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
   PyTorch version on the same inputs and timed with CUDA events and on
   the device alone (``torch.profiler``) beside the plain version and the
   HBM-bytes bound;
4. serve: ResNet-50 (224 px, widths 64..2048, 10 classes, weights and
   non-trivial BN running statistics from a numpy seed) through
   ``Model.compile_serving(batch=32)`` -> ``BatchServingEngine``, 96
   requests with the epilogue enabled, held against the port's own
   unfused path on the card (epilogue off, TF32 off for both); then again
   under ``policy="bf16_mixed"``, and a 32-request NHWC run. The engine
   replays a CUDA graph per tick (its default), which moves no host
   counter: each run is served twice, timed, then counted (the counts
   zeroed just before it, the run under ``torch.profiler``, K2's
   launches counted by kernel name in its trace, the host counts 0),
   the two runs' logits bitwise; each run checks that every future
   resolved, that every tick of the counted run was a replay and that
   K2 launched 49 times per replay;
5. kernels (optimizers): K1 (weight decay 1e-5, and again with nesterov),
   K5, K6 and K7 at the largest ResNet-50 parameter (512x512x3x3) and a
   64-element BN vector, each held bitwise against its plain version on
   cloned inputs, with the version of every written tensor checked to go
   up, and timed per call (CUDA events: what a caller pays, host work
   included), on the device alone (``torch.profiler``, over copies that
   exceed the L2 cache) and, for K1 and K5, beside
   ``torch.optim.SGD/Adam(fused=True).step()`` on the same tensor; then
   each timed over a whole ResNet-50 update (its 161 parameter tensors,
   one launch each) in the same four ways and on the host clock; then
   the multi-tensor launches of K1 (and with nesterov), K5, K6 and K7
   over the 161 shapes (both chunk capacities crossed), with two lr
   tensors and three weight decays in turn, in f32 and with bf16
   parameters and f32 state, held bitwise against the loop of plain
   versions, versions and launches (one per chunk, none per tensor)
   checked, and each whole update timed the same five ways beside the
   per-tensor loop (K6 and K7 have no ``torch.optim`` yardstick: it adds
   eps outside the square root); then the same multi-tensor launches with
   a guarded step's skip flag over the 161 shapes and a set that crosses
   both chunk capacities: with ok = 1 bitwise with the call without a
   flag and with the plain version, with ok = 0 every byte unchanged,
   each whole update timed with ok = 1 and ok = 0;
6. train: ResNet-50, 224 px, batch 32, f32, TF32 off, NCHW, weights and BN
   statistics from a numpy seed and one fixed synthetic batch, through
   ``Model.compile(is_train=True)`` and ``model(x, y)`` with ``SGD(lr=0.1,
   momentum=0.9, weight_decay=1e-5)``: once with ``fused=True`` (K1's
   multi-tensor launch, 2 per step, no per-tensor K1), once with
   ``fused=False`` and once with ``fused=True`` through the per-tensor K1
   (161 launches per step, the earlier design) from the same start, cuDNN
   deterministic, every parameter, momentum and running statistic of the
   three held bitwise after the steps; img/s, step p50/p99 (CUDA events)
   and the host time of each step's update (host clock) for the three,
   the loss per step (finite, falling), peak device memory;
7. eval after training: the fused-trained model (which served once
   before training, so its BN folds were cached) serves one batch through
   K2 (49 launches) and through the unfused path, and their logits agree;
   then ``Optimizer.apply`` updates only the BN scales and biases through
   the per-tensor K1 (106 launches, no forward, so no running statistic
   moves) and the two paths must still agree: a fold that K1's in-place
   writes did not invalidate would not;
8. train (other optimizers): 3 steps each of ``Adam``, ``RMSProp`` and
   ``AdaGrad``, fused, unfused and through the per-tensor kernel (the
   earlier design, 161 launches per step) from the same start, the three
   held bitwise: K5's multi-tensor launch (3 per step), K6's or K7's (2
   per step), none per tensor; after each, the BN-only update of phase 7
   through its per-tensor kernel (106 launches);
8b. train (bf16_mixed): the same ResNet-50, weights and batch through
   ``Model.compile(policy="bf16_mixed")``, the optimizer wrapped in
   ``resilience.GuardedOptimizer``, 12 SGD steps fused (K1's multi-tensor
   launch with the skip flag) and unfused, step 6 on a batch holding a
   NaN: (a) the two runs' parameters, momenta, BN statistics and guard
   states bitwise after the steps; (b) step 6 a bitwise no-op on every
   parameter, momentum, the step counter and every BN statistic, the loss
   scale halved, one skip, the later losses finite and moving; (c) the
   first loss within 2% of the f32 phase's, and the trained states served
   under the policy within the serving gate of their f32 serve; (d) one
   guarded step makes no more synchronizing calls
   (``torch.cuda.set_sync_debug_mode("warn")``) than one f32 step; step
   p50/p99, img/s, peak memory and the update's host time beside the f32
   phase's p50; then 2 guarded steps each of Adam, RMSProp and AdaGrad
   (their flagged launches, 3 / 2 / 2 per step);
8c. graph train: the same ResNet-50 and batch in graph mode
   (``Model.compile(use_graph=True)``: the first step eager, the second
   captured in a CUDA graph and replayed, the rest replays) and eagerly,
   12 fused-SGD steps each from the same start, in f32 and under
   bf16_mixed (step 6 poisoned), cuDNN deterministic: the losses and every
   state bitwise, the poisoned step (a replay) a bitwise no-op, the loss
   scale and skips step by step as eager's, one capture, K1's launches
   counted on the host at the eager step and the capture only, no
   synchronizing call in a replayed step; step p50/p99 and img/s of both
   in 5 alternating rounds of 6 steps, peak memory, and the idle share,
   busy time and ops of 3 traced steps of each, whose trace must count
   K1's 2 multi-tensor launches per step by kernel name (none on the
   host for the replays); then under bf16_mixed 8 guarded steps of Adam
   on an exponentially decaying lr, graph against eager with step 6
   poisoned: the same gates, the lr after each step bitwise too, K5's 3
   multi-tensor launches per replayed step counted in the trace;
8d. graph serve: ResNet-50 b32 through the graphed engine and the eager
   one (``use_graph=False``), f32 and bf16_mixed: logits bitwise, 49 K2
   launches per replay counted in the trace (phase 4's counted run);
   after a load of other weights the graphed engine serves them (bitwise
   with eager), capturing anew; tick p50/p99 and img/s in 5 alternating
   rounds of 96 requests, and the device memory each engine holds;
9. kernels (flash attention): the built library's SASS (``cuobjdump``)
   holds HMMA (tensor-core) instructions in each bf16 kernel (one at
   least of each of the three) and in no f32 one; each f32 kernel
   instance's registers, local memory (none may spill) and shared memory
   (``cudaFuncGetAttributes``); K3 (``flash_fwd``) and K4's two kernels
   (``flash_bwd_dq``, ``flash_bwd_dkv``) against their plain versions, in
   f32 (CUDA cores) and bf16 (tensor cores), causal and not, at the LM's
   shape B8 H8 S1024 D64, at a ragged S=1000 D=32, at S=333 D=30 (the
   narrow load path of each dtype) and with a position
   delta, within the stated tolerances (TF32 off): one scaled by the
   largest reference value, one per element (each value against its own
   size and its row's); each timed at the
   main-path shape (causal) with CUDA events, on the device alone
   (``torch.profiler``, by its kernel's name), with its achieved TFLOP/s
   and share of the bound, beside its plain version, its bound and
   ``scaled_dot_product_attention`` (forward, and its backward through
   autograd: a yardstick the port never calls), timed as the device time
   of the kernels each launches, which name its backend; in f32 SDPA's
   backward and K4 are timed in alternation over 5 rounds (median and
   spread; K4's library_ms is SDPA's median); a CUDA tensor with D=512
   must raise;
10. LM eval: ``TransformerLM`` at ``bench.py``'s ``LM_SHAPE`` (d_model 512,
   8 heads, 6 layers, seq 1024, vocab 32000), batch 8, weights from a
   numpy seed: one eval forward through K3 (6 launches) and one with
   ``ops.attention.USE_PLAIN`` (none), logits held within the stated
   tolerance, in f32 and under ``compute_dtype=bfloat16``;
11. LM training: the same model with ``fused_head_chunk=8192`` and
   ``SGD(lr=0.1, momentum=0.9, fused=True)``, 8 steps through K3, K4 and
   K1's multi-tensor launch (6, 6, 6 and 2 launches per step), then the
   same 8 steps from the same start with the plain attention; the loss
   falls, the parameters of the two runs agree within the stated
   tolerance; tokens/s, step p50/p99, the update's host time and peak
   device memory; then 6 steps under ``compute_dtype=bfloat16``, with the
   multi-tensor update and again with the per-tensor one (102 launches
   per step), their parameters within the same tolerance, step p50/p99
   and update host time of each, then the same bf16 steps with the plain
   attention: the final loss and the loss decrease through K3/K4 within
   2% of it, and each parameter tensor's update within 20% of its own
   (these LM phases run eagerly, ``use_graph=False``);
12. graph train LM: the same LM in graph mode (K3, K4 and K1's
   multi-tensor launch inside the captured step) against eager, 6 fused
   steps each from the same start, in f32 and bf16: two eager f32 runs
   made, and if they agree bitwise the graphed one must too (else the
   LM's f32 gates); one capture, the kernels counted on the host at the
   eager step and the capture only, no synchronizing call in a replayed
   step; step p50/p99 and tokens/s of both in 5 alternating rounds of 3
   steps, peak memory and traced idle shares, the trace of 3 replayed
   steps counting K3's and K4's 6 launches each and K1's 2 per step.

Rows of kernels that a graph replays (K2, K1-multi with and without the
flag, K5-multi with the flag, K3/K4) carry ``replays`` and
``launches_per_replay`` beside ``launches``, both from the trace of a
replayed run (K1, K5, K3 and K4 with ``replayed_launches``, the count in
that trace; K2's ``launches`` are its count). Its last lines are the ``{"kernels": [...]}`` record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``. In
that record ``ms`` and ``plain_ms`` are CUDA-event times of one call,
host work included; a flash kernel's ``library_ms`` is the device time
of the kernels that ``scaled_dot_product_attention`` launches (its call
time with host work is ``library_call_ms`` in the full record), and an
optimizer's the CUDA-event time of ``torch.optim``'s step. The full
record also goes to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import re
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
    "sgd_multi": "singa_tpu/ops/fused_optim.py:155",
    "adam_multi": "singa_tpu/ops/fused_optim.py:206",
    "rmsprop": "singa_tpu/ops/fused_optim.py:263",
    "adagrad": "singa_tpu/ops/fused_optim.py:316",
    "rmsprop_multi": "singa_tpu/ops/fused_optim.py:263",
    "adagrad_multi": "singa_tpu/ops/fused_optim.py:316",
    "flash_fwd": "singa_tpu/ops/attention.py:324",
    "flash_bwd_dq": "singa_tpu/ops/attention.py:388",
    "flash_bwd_dkv": "singa_tpu/ops/attention.py:424",
    "flash_fwd_bf16": "singa_tpu/ops/attention.py:324",
    "flash_bwd_dq_bf16": "singa_tpu/ops/attention.py:388",
    "flash_bwd_dkv_bf16": "singa_tpu/ops/attention.py:424",
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
LM_BF16_STEPS = 6
LM_PARAMS_PER_STEP = 102    # 16 per block x 6, 2 embeddings, ln_f x 2, head
# kernel against plain version, as a fraction of the largest reference
# value: f32 sums run in another order than the plain version's matmuls;
# bf16 results are rounded once from f32 on both sides, so a value may
# land one bf16 step (2^-8) away, and the tensor-core kernels round P and
# dS to bf16 before their products, which moves a value by up to about
# 2^-9 of the largest one
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a second gate beside FLASH_TOL, per element: |a - b| <= c (|b| + rms(b)),
# the rms over each row of the reference (one query's out or dq, one
# key's dk or dv; elem_err). FLASH_TOL scales by the largest value of the
# whole tensor, which at the LM shape is about the size of a typical value
# (row or key 0 holds the largest), so a tile of small rows left at zero
# could pass it; this one holds each row to its own size. The rms of a
# (batch, head) slice would not: row or key 0 dominates it too. A row's
# rms is taken as at least 1/64 of its slice's: a row that cancels to
# nothing (causal dq of row 0: dS = P (dP - delta) with P = 1 and delta =
# dP) holds f32 noise that differs between the two sides. c is set from
# the readings of sound runs; flash_gate_check.py shows that planted
# faults fail it
FLASH_ELEM_TOL = {"float32": 1e-5, "bfloat16": 0.025}
# LM logits, kernel attention against the plain one, as a fraction of the
# largest |logit|: f32 differs only in attention's summation order; under
# bf16 a one-step difference in an attention output propagates through
# six bf16 layers
LM_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# parameters after LM_STEPS of SGD, kernel run against plain run, per
# tensor |a - b| / |b| (Frobenius): the f32 attention differences above,
# carried through 8 steps of lr 0.1 with momentum
LM_PARAM_TOL = 1e-3
# final loss of the bf16 LM run through K3/K4 against the run with the
# plain attention, relative: both round to bf16 at other places (P and dS
# on the tensor cores, the outputs only in the plain version)
LM_BF16_LOSS_TOL = 0.02
# the loss hardly tells attention's faults apart (on uniform random tokens
# it falls by fitting the head), so each parameter tensor's update over
# the bf16 run is held to the plain-attention run's too, per tensor
# |upd - upd_plain| / |upd_plain|: set from the readings of sound runs
LM_BF16_UPDATE_TOL = 0.2
# a tensor the plain run leaves (almost) unchanged has no update to be
# held to: the k-projection biases, whose gradient is 0 in exact
# arithmetic (softmax ignores a shift common to a row's scores), take
# only rounding noise. Its difference is read against this fraction of
# the tensor's norm instead
LM_BF16_UPDATE_FLOOR = 1e-3
# rounds of SDPA's f32 backward against K4 f32, in alternation
YARDSTICK_ROUNDS = 5
# the kernel each wrapper launches, by input dtype: f32 on the CUDA cores,
# bf16 on the tensor cores
FLASH_KERNEL_NAME = {
    "float32": {"flash_fwd": "flash_fwd_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel"},
    "bfloat16": {"flash_fwd": "flash_fwd_mma_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_mma_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_mma_kernel"}}
# the optimizer settings of each kernel's phases: (the wrapper, its
# keyword arguments, the number of states, bytes moved per f32 element,
# f32 operations per element)
KERNEL_NAME = {"sgd": "sgd_kernel", "sgd_nesterov": "sgd_kernel",
               "adam": "adam_kernel", "rmsprop": "scaled_kernel",
               "adagrad": "scaled_kernel", "sgd_multi": "sgd_multi_kernel",
               "sgd_multi_nesterov": "sgd_multi_kernel",
               "adam_multi": "adam_multi_kernel",
               "rmsprop_multi": "scaled_multi_kernel",
               "adagrad_multi": "scaled_multi_kernel"}
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
# the multi-tensor launches of K1, K5, K6 and K7: the per-tensor case
# whose tensors, scalars, bytes and operations they share, the wrapper,
# and its shared keyword arguments (lr and weight decay are per entry)
MULTI_CASES = {
    "sgd_multi": ("sgd", "sgd_momentum_update_multi", dict(momentum=0.9)),
    "sgd_multi_nesterov": ("sgd_nesterov", "sgd_momentum_update_multi",
                           dict(momentum=0.9, nesterov=True)),
    "adam_multi": ("adam", "adam_update_multi",
                   dict(beta_1=0.9, beta_2=0.999, epsilon=1e-8)),
    "rmsprop_multi": ("rmsprop", "rmsprop_update_multi",
                      dict(rho=0.9, epsilon=1e-8)),
    "adagrad_multi": ("adagrad", "adagrad_update_multi",
                      dict(epsilon=1e-8)),
}
# the multi-tensor kernels' skip flag: the set of shapes that crosses both
# chunk capacities beside ResNet-50's 161 (tests/test_torch_cuda_kernels.py)
CHUNK_SET = [(4099,), (64,), (1,), (3, 3, 3, 5)] * 45
# ResNet-50 training under bf16_mixed (GuardedOptimizer): the fused and the
# unfused SGD run BF16_STEPS steps each, step POISON_STEP's batch holding a
# NaN; then BF16_OTHER_STEPS guarded steps each of Adam, RMSProp, AdaGrad
BF16_STEPS = 12
POISON_STEP = 6
BF16_OTHER_STEPS = 2
# the first bf16_mixed step's loss against the f32 phase's on the same
# weights and batch, relative: bf16 convolutions round each output to 8
# bits of mantissa, which moves a loss near ln(10) by well under 1%
BF16_LOSS_TOL = 0.02
# graph mode (CUDA graphs): graphed and eager ResNet-50 steps of each policy
# from the same start (step POISON_STEP poisoned under bf16_mixed), then
# GRAPH_ROUNDS alternating timing rounds of GRAPH_ROUND_STEPS steps each
# (LM_GRAPH_ROUND_STEPS for the LM; one round of N_REQUESTS for serving),
# and GRAPH_TRACED steps of each under the profiler
GRAPH_STEPS = 12
GRAPH_ROUNDS = 5
GRAPH_ROUND_STEPS = 6
GRAPH_TRACED = 3
GRAPH_ADAM_STEPS = 8
LM_GRAPH_STEPS = 6
LM_GRAPH_ROUND_STEPS = 3
# why an optimizer case has no PyTorch call timed beside it
# a port kernel's name in a profiler trace: ``<name>_kernel<template
# arguments>``, in an anonymous namespace; the launch-counter keys that
# the name (the ``_mma`` of the bf16 flash kernels dropped) may be
PORT_KERNEL = re.compile(r"(\w+)_kernel<([^>]*)>")
# a counting profiler session starts with this many launches of a kernel
# that nothing else runs (``torch.cuda._sleep``'s ``spin_kernel``, left
# out of every count and time): after the training phases the trace of a
# session lost its first 2-3 device records, even after 50 ms of idle
# time, and a count must not lose any
PROFILE_PAD = 16
PORT_KEYS = ("sgd", "adam", "sgd_multi", "adam_multi", "flash_fwd",
             "flash_bwd_dq", "flash_bwd_dkv")
NO_LIBRARY = {"sgd_nesterov": "torch.optim is timed in the sgd case",
              "rmsprop": "torch.optim adds eps outside the square root",
              "adagrad": "torch.optim adds eps outside the square root"}



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


def device_kernels(fn, match="", iters=20, attempts=5, launches=None):
    """Device ms per call of ``fn``, by kernel name, for the kernels whose
    name contains ``match`` (every kernel by default), from
    ``torch.profiler`` over ``iters`` calls after a warm-up one. Host time
    between launches is not in it. A profiler session that records no such
    kernel, or other than ``launches`` of them per call where the caller
    knows that count (sessions with no device event, or with some of a
    call's kernels missing, are seen now and then on the card's machine),
    is repeated, up to ``attempts`` sessions."""
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
        ms, seen = {}, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and match in e.name:
                ms[e.name] = ms.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / iters
                seen += 1
        if ms and (launches is None or seen == launches * iters):
            return ms
        print(f"profiler session {attempt + 1} saw {seen} {match} kernels"
              + ("" if launches is None else
                 f", expected {launches} x {iters}"), flush=True)
    raise SmokeFailure(f"the profiler saw no complete session of {match} "
                       f"kernels in {attempts} sessions")


def device_ms(fn, match, iters=20, attempts=5, launches=None):
    """Mean device time per call of ``fn`` in the kernels whose name
    contains ``match`` (:func:`device_kernels`)."""
    return sum(device_kernels(fn, match, iters, attempts,
                              launches).values())


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
                # x alone exceeds the 50 MB L2 in f32 and bf16: each call
                # finds its input in HBM
                dms = device_ms(kern, "affine_relu_kernel", launches=1)
                rec = {"name": name, "dtype": str(dtype).split(".")[-1],
                       "shape": list(shape), "max_abs_err": err,
                       "ms": time_ms(kern), "device_ms": dms,
                       "device_share_of_bound": bms / dms,
                       "plain_ms": time_ms(plain),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": None}
                cases.append(rec)
                print(f"kernel {name} {rec['dtype']} {tuple(shape)}: "
                      f"kernel_ms={rec['ms']:.4f} (device {dms:.4f}, "
                      f"{bms / dms:.3f} of the bound) plain_ms="
                      f"{rec['plain_ms']:.4f} bound_ms={bms:.4f} ({by}, "
                      f"{HBM_BYTES_PER_S / 1e12} TB/s H100 SXM data-sheet "
                      f"rate) library_ms=null (no single PyTorch call "
                      f"computes BN fold + add + ReLU) bitwise=True",
                      flush=True)
                del x, r
    return cases


def optim_args(kind, shapes, gen, dev, p_dtype=None):
    """Fresh (p, g, *states) per shape for one optimizer kernel (p in
    ``p_dtype`` when given, the rest f32), and the device scalars it takes
    (lr, and Adam's bias corrections)."""
    import torch
    _, _, n_states, _, _ = OPTIM_CASES[kind]
    positive = kind in ("rmsprop", "adagrad")
    tensors = []
    for shape in shapes:
        def rand(pos=False):
            t = torch.randn(shape, generator=gen, device=dev.torch_device)
            return t.abs() if pos else t
        states = [rand(pos=positive or i == 1) for i in range(n_states)]
        p = rand()
        tensors.append([p if p_dtype is None else p.to(p_dtype),
                        rand() * 0.1] + states)
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


def multi_entries(mkind, tensors, scalars, mixed):
    """Entries ``(p, g, *states, lr, weight_decay)`` of multi-tensor case
    ``mkind`` over ``tensors``: as the optimizer sends them on the main
    path (one lr, the per-tensor case's weight decay everywhere), or
    ``mixed``: two lr tensors and three weight decays in turn."""
    base = MULTI_CASES[mkind][0]
    lr = scalars[0]
    if not mixed:
        wd = OPTIM_CASES[base][1].get("weight_decay", 0.0)
        return [(*t, lr, wd) for t in tensors]
    lrs, wds = [lr, lr * 2], [1e-5, 0.0, 1e-3]
    return [(*t, lrs[i % 2], wds[i % 3]) for i, t in enumerate(tensors)]


def multi_update(mkind, entries, scalars, plain=False, ok=None):
    """One multi-tensor update (``plain``: its plain version, a loop of
    the per-tensor plain versions), with the skip flag ``ok`` when it is
    given."""
    from singa_tpu_torch.ops import fused_optim as fo
    _, name, kw = MULTI_CASES[mkind]
    fn = getattr(fo, name + ("_reference" if plain else ""))
    if ok is not None:
        kw = dict(kw, ok=ok)
    if mkind == "adam_multi":
        fn(entries, *scalars[1:], **kw)
    else:
        fn(entries, **kw)


def clone_entries(entries):
    import torch
    return [tuple(t.clone() if isinstance(t, torch.Tensor) and t.dim()
                  else t for t in e) for e in entries]


def host_ms(fn, iters=10, warmup=2):
    """Mean time per call of ``fn`` on the host clock with no sync inside:
    what the calling thread spends, the enqueueing of the launches
    included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


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
                   "device_ms": device_ms(kern_cold, KERNEL_NAME[kind],
                                          launches=1),
                   "plain_ms": time_ms(lambda: optim_update(
                       kind, [plain], scalars, plain=True)),
                   "bound_ms": bms, "bound_by": by,
                   "library_ms": time_ms(lib) if lib else None}
            cases.append(rec)
            del ring
            lib_s = f"{rec['library_ms']:.4f}" if lib else \
                f"null ({NO_LIBRARY[kind]})"
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
               "ms": time_ms(step, iters=10), "host_ms": host_ms(step),
               "device_ms": device_ms(step, KERNEL_NAME[kind], iters=5,
                                      launches=len(tensors)),
               "plain_ms": time_ms(lambda: optim_update(
                   kind, plain, scalars, plain=True), iters=10),
               "bound_ms": bms, "bound_by": by,
               "library_ms": time_ms(lib, iters=10) if lib else None}
        steps[kind] = rec
        lib_s = f"{rec['library_ms']:.4f}" if lib else \
            f"null ({NO_LIBRARY[kind]})"
        print(f"step {kind} over {len(tensors)} ResNet-50 tensors ({n} "
              f"elements, one launch each): kernel_ms={rec['ms']:.4f} "
              f"(host {rec['host_ms']:.4f}, device "
              f"{rec['device_ms']:.4f}) plain_ms="
              f"{rec['plain_ms']:.4f} bound_ms={bms:.4f} ({by}) "
              f"library_ms={lib_s}", flush=True)
        del tensors, plain
    multi_cases, multi_steps = multi_phase(dev, param_shapes, gen, steps)
    flag_cases, flag_steps = flag_phase(dev, param_shapes, gen, steps)
    return cases + multi_cases + flag_cases, \
        {**steps, **multi_steps, **flag_steps}


def flag_phase(dev, param_shapes, gen, per_tensor):
    """The multi-tensor launches of K1 (and with nesterov), K5, K6 and K7
    with a guarded step's skip flag, over the 161 ResNet-50 shapes and
    :data:`CHUNK_SET`, two lr tensors and three weight decays in turn:
    with ok = 1 bitwise with the same call without a flag and with the
    plain version given the flag, with ok = 0 every byte of every
    parameter and state unchanged; every launch counted and every written
    tensor's version bumped, skipped or not. Then each whole ResNet-50
    update timed with ok = 1 and ok = 0 (CUDA events and device time)
    beside the plain version with the flag."""
    import torch
    from singa_tpu_torch.ops import fused_optim as fo
    ok1 = torch.ones((), device=dev.torch_device)
    ok0 = torch.zeros((), device=dev.torch_device)
    cases, steps = [], {}
    for mkind, (base, _, _) in MULTI_CASES.items():
        key = mkind.replace("_nesterov", "")
        n_states = OPTIM_CASES[base][2]
        for set_name, shapes in (("resnet50", param_shapes),
                                 ("chunk_boundary", CHUNK_SET)):
            tensors, scalars = optim_args(base, shapes, gen, dev)
            start = multi_entries(mkind, tensors, scalars, mixed=True)
            bare, one, zero, plain = (clone_entries(start)
                                      for _ in range(4))

            def written(entries):
                return [t for e in entries for t in (e[0],
                                                     *e[2:2 + n_states])]
            versions = [t._version for t in written(zero)]
            fo.reset_counts()
            multi_update(mkind, bare, scalars)
            multi_update(mkind, one, scalars, ok=ok1)
            multi_update(mkind, zero, scalars, ok=ok0)
            counts = dict(fo.launches)
            multi_update(mkind, plain, scalars, plain=True, ok=ok1)
            torch.cuda.synchronize()
            chunks = multi_chunks(key, len(shapes))
            check(counts == {**{k: 0 for k in counts}, key: 3 * chunks},
                  f"{mkind} {set_name} with the flag: launches {counts}, "
                  f"expected 3 x {chunks} of {key}")
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(written(one), written(plain)))
            check(all(torch.equal(a, b) and torch.equal(b, c) for a, b, c
                      in zip(written(bare), written(one), written(plain))),
                  f"{mkind} {set_name}: ok = 1 differs from the launch "
                  f"without a flag or from the plain version (max abs err "
                  f"{err})")
            check(all(torch.equal(a, b) for a, b in
                      zip(written(zero), written(start))),
                  f"{mkind} {set_name}: ok = 0 wrote")
            check(all(t._version > v for t, v in zip(written(zero),
                                                      versions)),
                  f"{mkind} {set_name}: a skipped launch kept a version")
            cases.append({"name": mkind, "flag": True, "shapes": set_name,
                          "tensors": len(shapes), "launches": 3 * chunks,
                          "max_abs_err": err})
            print(f"kernel {mkind} with the skip flag over {len(shapes)} "
                  f"{set_name} tensors: ok=1 bitwise with no flag and with "
                  f"the plain version, ok=0 wrote nothing, {chunks} "
                  f"launches each, versions bumped", flush=True)
            del tensors, start, bare, one, zero, plain
        tensors, scalars = optim_args(base, param_shapes, gen, dev)
        entries = multi_entries(mkind, tensors, scalars, mixed=False)
        plain = clone_entries(entries)
        chunks = multi_chunks(key, len(param_shapes))
        rec = {"name": mkind, "flag": True, "tensors": len(tensors),
               "launches_per_update": chunks}
        for label, ok in (("ok1", ok1), ("ok0", ok0)):
            def step(ok=ok):
                multi_update(mkind, entries, scalars, ok=ok)
            rec[f"ms_{label}"] = time_ms(step, iters=10)
            rec[f"host_ms_{label}"] = host_ms(step)
            rec[f"device_ms_{label}"] = device_ms(
                step, KERNEL_NAME[mkind], iters=5, launches=chunks)
        rec["plain_ms"] = time_ms(lambda: multi_update(
            mkind, plain, scalars, plain=True, ok=ok1), iters=10)
        pt = per_tensor[base]
        rec.update({"bound_ms": pt["bound_ms"], "bound_by": pt["bound_by"],
                    "library_ms": pt["library_ms"]})
        steps[f"{mkind}_flag"] = rec
        print(f"step {mkind} with the skip flag over {len(tensors)} "
              f"ResNet-50 tensors ({chunks} launches): ok=1 kernel_ms="
              f"{rec['ms_ok1']:.4f} (host {rec['host_ms_ok1']:.4f}, device "
              f"{rec['device_ms_ok1']:.4f}); ok=0 kernel_ms="
              f"{rec['ms_ok0']:.4f} (host {rec['host_ms_ok0']:.4f}, device "
              f"{rec['device_ms_ok0']:.4f}); plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})",
              flush=True)
        del tensors, entries, plain
    return cases, steps


def multi_phase(dev, param_shapes, gen, per_tensor):
    """The multi-tensor launches of K1, K5, K6 and K7 over the 161 ResNet-50
    parameter shapes (both chunk capacities crossed): bitwise against the
    loop of plain versions with mixed per-tensor lr and weight decay, in
    f32 and with bf16 parameters and f32 state, every written tensor's
    version checked, one launch per chunk and none per tensor; then each
    whole update timed as the optimizer sends it (one lr, one weight
    decay), four ways, beside ``torch.optim``'s fused step (K1, K5) and
    the per-tensor loop of the same run (``per_tensor``)."""
    import torch
    from singa_tpu_torch.ops import fused_optim as fo
    cases, steps = [], {}
    for mkind, (base, _, _) in MULTI_CASES.items():
        key = mkind.replace("_nesterov", "")
        chunks = multi_chunks(key, len(param_shapes))
        for p_dtype in (torch.float32, torch.bfloat16):
            tensors, scalars = optim_args(base, param_shapes, gen, dev,
                                          p_dtype)
            mine = multi_entries(mkind, tensors, scalars, mixed=True)
            plain = clone_entries(mine)
            written = [(e[0],) + e[2:-2] for e in mine]
            want = [(e[0],) + e[2:-2] for e in plain]
            versions = [[t._version for t in w] for w in written]
            fo.reset_counts()
            multi_update(mkind, mine, scalars)
            counts = dict(fo.launches)
            multi_update(mkind, plain, scalars, plain=True)
            torch.cuda.synchronize()
            name = str(p_dtype).split(".")[-1]
            check(counts == {**{k: 0 for k in counts}, key: chunks},
                  f"{mkind} {name}: launches {counts}, expected {chunks} "
                  f"of {key}")
            pairs = [(a, b) for w, r in zip(written, want)
                     for a, b in zip(w, r)]
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in pairs)
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"{mkind} {name}: kernel differs from the loop of plain "
                  f"versions (max abs err {err})")
            check(all(t._version > v for w, vs in zip(written, versions)
                      for t, v in zip(w, vs)),
                  f"{mkind} {name}: a written tensor kept its version")
            cases.append({"name": mkind, "param_dtype": name,
                          "tensors": len(mine), "launches": chunks,
                          "max_abs_err": err})
            print(f"kernel {mkind} params {name} states float32 over "
                  f"{len(mine)} ResNet-50 tensors, two lr tensors, weight "
                  f"decays 1e-5/0/1e-3: {chunks} launches, bitwise with "
                  f"the loop of plain versions, versions bumped",
                  flush=True)
            del tensors, mine, plain, written, want, pairs
        tensors, scalars = optim_args(base, param_shapes, gen, dev)
        entries = multi_entries(mkind, tensors, scalars, mixed=False)
        plain = clone_entries(entries)
        n = sum(t[0].numel() for t in tensors)
        bms, by = optim_bound(base, n)
        lib = library_step(base, tensors)
        if lib is not None:
            lib()                   # past torch's first-step momentum init

        def step():
            multi_update(mkind, entries, scalars)
        rec = {"name": mkind, "tensors": len(tensors), "elements": n,
               "launches_per_update": chunks,
               "ms": time_ms(step, iters=10), "host_ms": host_ms(step),
               "device_ms": device_ms(step, KERNEL_NAME[mkind], iters=5,
                                      launches=chunks),
               "plain_ms": time_ms(lambda: multi_update(
                   mkind, plain, scalars, plain=True), iters=10),
               "bound_ms": bms, "bound_by": by,
               "library_ms": time_ms(lib, iters=10) if lib else None,
               "per_tensor_ms": per_tensor[base]["ms"],
               "per_tensor_host_ms": per_tensor[base]["host_ms"]}
        steps[mkind] = rec
        lib_s = f"{rec['library_ms']:.4f}" if lib else \
            f"null ({NO_LIBRARY[base]})"
        print(f"step {mkind} over {len(tensors)} ResNet-50 tensors ({n} "
              f"elements, {chunks} launches): kernel_ms={rec['ms']:.4f} "
              f"(host {rec['host_ms']:.4f}, device "
              f"{rec['device_ms']:.4f}) plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={bms:.4f} ({by}) library_ms={lib_s}; the "
              f"per-tensor loop of this run: kernel_ms="
              f"{rec['per_tensor_ms']:.4f} (host "
              f"{rec['per_tensor_host_ms']:.4f})", flush=True)
        del tensors, entries, plain
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


def serve_requests(eng, inputs):
    """Submit ``inputs`` to ``eng`` and run it until idle; returns the
    stacked results."""
    import numpy as np
    futs = [eng.submit(x) for x in inputs]
    eng.run_until_idle()
    check(all(f.done() for f in futs), "a future did not resolve")
    return np.stack([f.result() for f in futs])


def serve(model, dev, inputs, policy, fused, batch=BATCH, use_graph=True,
          registry=None, attempts=5):
    """Serve ``inputs`` through a fresh engine, twice. The engine's
    constructor runs one forward of the same path, which warms cuDNN and
    the allocator, and (``use_graph``, the engine's default) captures the
    next in a CUDA graph: every tick is then a replay. The first run is
    timed (``seconds``, and the engine's ``tick`` and ``ttft`` quantiles
    just after it). The second is the counted run: its logits must equal
    the first's bitwise, and it runs under ``torch.profiler``
    (:func:`profiled`), K2's launches counted by kernel name in its trace,
    49 per tick with the epilogue on (``TAILS_PER_FORWARD``, in the
    model's layout), none with it off. A replay moves no host counter, so
    a graphed engine's host counts must stay 0 and every tick of the run
    be a replay; an eager engine's host counts must equal the trace's.
    Returns a dict of the logits, the engine, ``seconds``, the trace's K2
    ``launches`` by variant, the fused ``tails`` (one K2 launch each), the
    ``replays`` of the counted run, ``tick`` and ``ttft``."""
    import numpy as np
    from singa_tpu_torch.observability.metrics import Registry
    from singa_tpu_torch.ops import fused_epilogue as fe
    ticks = -(-len(inputs) // batch)
    lo = getattr(model, "layout", "NCHW").lower()
    want = {f"{k}_{lo}": per * ticks for k, per in TAILS_PER_FORWARD.items()
            } if fused else {}
    with fe.enabled_scope(fused):
        eng = model.compile_serving(input_shape=SHAPE, batch=batch,
                                    device=dev, policy=policy,
                                    queue_capacity=len(inputs),
                                    registry=registry or Registry(),
                                    use_graph=use_graph)
        t0 = time.perf_counter()
        timed = serve_requests(eng, inputs)
        seconds = time.perf_counter() - t0
        stats = {"tick": eng.tick_stats(), "ttft": eng.ttft_stats()}

        def counted():
            before = eng.graph_stats()["n_replays"]
            out = serve_requests(eng, inputs)
            return out, eng.graph_stats()["n_replays"] - before
        (logits, replays), counts, host, _, _ = profiled(
            counted, attempts, want, f"serve {lo} {policy or 'float32'} "
            f"fused={fused} graph={use_graph}")
        host_tails = fe.fused_tails
    check(np.array_equal(logits, timed), "the counted run's logits differ "
          "from the timed run's")
    if use_graph:
        check(replays == ticks and not host and host_tails == 0,
              f"graphed engine: {ticks} ticks, {replays} replays, host "
              f"counts {host} and {host_tails} fused tails in the counted "
              "run (a replay moves none)")
    else:
        check(host == counts and host_tails == sum(host.values()),
              f"eager engine: host counts {host} and {host_tails} fused "
              f"tails, the trace counted {counts}")
    launches = {k: counts.get(k, 0) for k in fe.launches}
    return {"logits": logits, "engine": eng, "seconds": seconds,
            "launches": launches, "tails": sum(launches.values()),
            "replays": replays, **stats}


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
    r = serve(model, dev, inputs, policy, False, batch)
    ref, ref_launches = r["logits"], r["launches"]
    check(sum(ref_launches.values()) == 0,
          f"the unfused run launched K2: {ref_launches}")
    f = serve(model, dev, inputs, policy, True, batch)
    got, eng, launches, tails = f["logits"], f["engine"], f["launches"], \
        f["tails"]
    ticks = -(-n_requests // batch)
    check(eng.ticks == 2 * ticks, f"{eng.ticks} ticks, expected {ticks} "
          "in each of the two runs")
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
    ts, tt = f["tick"], f["ttft"]
    rec = {"layout": layout, "policy": pname, "requests": n_requests,
           "batch": batch, "ticks": ticks, "launches": launches,
           "replays": f["replays"], "launches_per_replay":
           {k: v / f["replays"] for k, v in launches.items()},
           "fused_tails": tails, "max_abs_err_vs_unfused": err,
           "max_abs_logit": scale, "img_per_s": n_requests / f["seconds"],
           "unfused_img_per_s": n_requests / r["seconds"],
           "tick_p50_ms": ts["p50_s"] * 1e3, "tick_p99_ms": ts["p99_s"] * 1e3,
           "ttft_p50_ms": tt["p50_s"] * 1e3, "ttft_p99_ms": tt["p99_s"] * 1e3,
           "unfused_tick_p50_ms": r["tick"]["p50_s"] * 1e3,
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


def timed_updates(optimizer):
    """Time each parameter update of ``optimizer``'s training steps on the
    host clock: ``update_params`` runs after the backward (its pairs are
    taken first) and is timed alone, with no sync, so the time is the
    host work of the update and the enqueueing of its launches. Returns
    the list the times (ms) go to."""
    real = optimizer.update_params
    times = []

    def update_params(pairs, ok=None):
        pairs = list(pairs)
        t0 = time.perf_counter()
        real(pairs, ok)
        times.append((time.perf_counter() - t0) * 1e3)
    optimizer.update_params = update_params
    return times


def per_tensor(optimizer):
    """``optimizer`` (``fused=True``) with the earlier design of its fused
    step, for comparison within one run: every parameter through
    ``Optimizer.apply``, one per-tensor launch each."""
    def update_params(pairs, ok=None):
        for p, g in pairs:
            name = p.name or f"param/{id(p)}"
            if ok is None:
                optimizer.apply(name, p, g)
            else:
                optimizer._apply_masked(name, p, g, ok)
    optimizer.update_params = update_params
    return optimizer


def train_run(model, optimizer, start, tx, ty, steps, kernel):
    """``steps`` train steps from ``start`` with ``optimizer``; the launch
    counts are zeroed just before and read just after. Returns the loss
    per step, the step times (CUDA events, one sync at the end), the
    launches of ``kernel`` and of the other optimizer kernels, and the
    host time of each step's update (ms)."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import fused_optim as fo
    load_numpy_states(model, start)
    model.set_optimizer(optimizer)
    update_ms = timed_updates(optimizer)
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
    return losses, times, mine, sum(counts.values()), update_ms


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


def multi_chunks(key, n_params):
    """Launches of multi-tensor kernel ``key`` per step over
    ``n_params`` parameters of one dtype pair."""
    from singa_tpu_torch.ops import fused_optim as fo
    return -(-n_params // fo.MULTI_CAPACITY[key])


def train_phase(dev, models, tx, ty, start):
    """ResNet-50 b32 f32 SGD: fused (K1's multi-tensor launch) against
    unfused, same start."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    fused, plain = models
    runs = {}
    for name, m in (("fused", fused), ("unfused", plain),
                    ("per_tensor", plain)):
        torch.cuda.reset_peak_memory_stats()
        sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5,
                      fused=name != "unfused")
        if name == "per_tensor":
            # the unfused run is held first: this run overwrites its model
            n_states = held_equal(fused, plain, "SGD")
            sgd = per_tensor(sgd)
        losses, times, k1, other, update_ms = train_run(
            m, sgd, start, tx, ty, TRAIN_STEPS,
            "sgd" if name == "per_tensor" else "sgd_multi")
        runs[name] = {"losses": losses, "step_ms": times, "k1": k1,
                      "other_kernel_launches": other,
                      "update_host_ms": update_ms,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    f = runs["fused"]
    per_step = multi_chunks("sgd_multi", PARAMS_PER_STEP)
    check(per_step <= 4 and f["k1"] == per_step * TRAIN_STEPS and
          f["other_kernel_launches"] == 0,
          f"fused run: {f['k1']} K1 multi-tensor launches (expected "
          f"{per_step} x {TRAIN_STEPS}), {f['other_kernel_launches']} "
          "others (per-tensor K1 included)")
    check(runs["unfused"]["k1"] + runs["unfused"]["other_kernel_launches"]
          == 0, "the unfused run launched an optimizer kernel")
    pt = runs["per_tensor"]
    check(pt["k1"] == PARAMS_PER_STEP * TRAIN_STEPS and
          pt["other_kernel_launches"] == 0,
          f"per-tensor run: {pt['k1']} per-tensor K1 launches (expected "
          f"{PARAMS_PER_STEP} x {TRAIN_STEPS}), "
          f"{pt['other_kernel_launches']} others")
    check(all(np.isfinite(f["losses"])), f"loss not finite: {f['losses']}")
    check(f["losses"][-1] < f["losses"][0],
          f"loss did not fall on the fixed batch: {f['losses']}")
    held_equal(fused, plain, "SGD multi-tensor against per-tensor")
    rec = {"steps": TRAIN_STEPS, "batch": BATCH, "states_held": n_states,
           "k1_launches": f["k1"], "k1_launches_per_step":
           f["k1"] / TRAIN_STEPS, "losses": f["losses"],
           "unfused_losses": runs["unfused"]["losses"]}
    for name, r in runs.items():
        t = np.asarray(r["step_ms"][TIMED_FROM:])
        u = np.asarray(r["update_host_ms"][TIMED_FROM:])
        pre = "" if name == "fused" else f"{name}_"
        rec.update({f"{pre}img_per_s": BATCH * len(t) / (t.sum() / 1e3),
                    f"{pre}step_p50_ms": float(np.percentile(t, 50)),
                    f"{pre}step_p99_ms": float(np.percentile(t, 99)),
                    f"{pre}step_ms": r["step_ms"],
                    f"{pre}update_host_p50_ms": float(np.percentile(u, 50)),
                    f"{pre}update_host_ms": r["update_host_ms"],
                    f"{pre}peak_device_bytes": r["peak_bytes"]})
    print(f"train resnet50 NCHW f32 b{BATCH} SGD x{TRAIN_STEPS} (timed from "
          f"step {TIMED_FROM}): img/s={rec['img_per_s']:.1f} (unfused "
          f"{rec['unfused_img_per_s']:.1f}) step p50="
          f"{rec['step_p50_ms']:.2f} ms p99={rec['step_p99_ms']:.2f} ms "
          f"(unfused p50 {rec['unfused_step_p50_ms']:.2f} ms, per-tensor K1 "
          f"p50 {rec['per_tensor_step_p50_ms']:.2f} ms) update host "
          f"p50={rec['update_host_p50_ms']:.3f} ms (unfused "
          f"{rec['unfused_update_host_p50_ms']:.3f} ms, per-tensor K1 "
          f"{rec['per_tensor_update_host_p50_ms']:.3f} ms) K1 multi-tensor "
          f"launches={f['k1']} ({rec['k1_launches_per_step']:.0f}/step, "
          f"no per-tensor K1) peak="
          f"{rec['peak_device_bytes'] / 2**30:.2f} GiB; fused == unfused "
          f"== per-tensor K1 bitwise over {n_states} states", flush=True)
    print("train losses: " + " ".join(f"{v:.6f}" for v in f["losses"]),
          flush=True)
    return rec


def eval_after_training(dev, model, inputs):
    """Serve the fused-trained model through K2 and through the unfused
    path; logits must agree (a stale BN fold would not). Then a BN-only
    per-tensor K1 update (:func:`bn_only_update`)."""
    import numpy as np
    model.eval()
    r = serve(model, dev, inputs, None, False)
    ref, ref_launches = r["logits"], r["launches"]
    f = serve(model, dev, inputs, None, True)
    got, launches = f["logits"], f["launches"]
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
    bn = bn_only_update(dev, model, inputs, "sgd", ref)
    rec.update({"bn_only_k1_launches": bn["launches"],
                "bn_only_moved": bn["moved"],
                "bn_only_max_abs_err_vs_unfused": bn["max_abs_err"]})
    return rec


def bn_only_update(dev, model, inputs, kernel, ref):
    """One more fused update of the BN scales and biases alone, through
    ``Optimizer.apply`` (the per-parameter API: per-tensor kernel
    ``kernel``, 106 launches) with no forward. The running statistics keep
    their versions, so only the kernel's in-place writes can invalidate
    the BN folds the serving path cached; the served logits (``ref``
    before) must move and K2's must still agree with the unfused path's.
    The model's fused serve must have run since its last update."""
    import numpy as np
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
    counts = dict(fo.launches)
    n_bn = counts.pop(kernel)
    check(n_bn == len(bn) == 106 and sum(counts.values()) == 0,
          f"{n_bn} {kernel} launches for {len(bn)} BN scales and biases, "
          f"expected 106, and others {counts}")
    ref2 = serve(model, dev, inputs, None, False)["logits"]
    got2 = serve(model, dev, inputs, None, True)["logits"]
    moved = float(np.abs(ref2 - ref).max())
    err2 = float(np.abs(got2 - ref2).max())
    scale2 = float(np.abs(ref2).max())
    check(moved > REL_TOL["float32"] * scale2 and
          err2 <= REL_TOL["float32"] * scale2,
          f"after a BN-only {kernel} update the unfused logits moved by "
          f"{moved}; K2 logits differ from them by {err2} (max |logit| "
          f"{scale2}): a stale BN fold?")
    print(f"eval after a BN-only per-tensor {kernel} update through "
          f"Optimizer.apply ({n_bn} launches): logits moved by {moved:.3g}, "
          f"K2 against unfused max_abs_err={err2:.3g}", flush=True)
    return {"launches": n_bn, "moved": moved, "max_abs_err": err2}


def other_optimizers_phase(dev, models, tx, ty, start, inputs):
    """Adam, RMSProp and AdaGrad (the multi-tensor launches of K5, K6 and
    K7): 3 steps each fused, unfused and through the per-tensor kernel
    (the earlier design) from the same start, the three held bitwise;
    after each, a BN-only per-tensor update through ``Optimizer.apply``
    (:func:`bn_only_update`)."""
    import numpy as np
    from singa_tpu_torch import opt
    makers = {"adam": lambda f: opt.Adam(lr=1e-3, fused=f),
              "rmsprop": lambda f: opt.RMSProp(lr=1e-3, fused=f),
              "adagrad": lambda f: opt.AdaGrad(lr=1e-2, fused=f)}
    fused, plain = models
    out = {}

    def ms(v):
        return " ".join(f"{x:.3f}" for x in v)
    for kind, make in makers.items():
        key = f"{kind}_multi"
        per_step = multi_chunks(key, PARAMS_PER_STEP)
        res = {}
        for name, m in (("fused", fused), ("unfused", plain),
                        ("per_tensor", plain)):
            optimizer = make(name != "unfused")
            if name == "per_tensor":
                # the unfused run is held first: this run overwrites its
                # model
                n_states = held_equal(fused, plain, kind)
                optimizer = per_tensor(optimizer)
            res[name] = train_run(m, optimizer, start, tx, ty, OTHER_STEPS,
                                  kind if name == "per_tensor" else key)
        losses, times, n, other, update_ms = res["fused"]
        check(per_step <= 4 and n == per_step * OTHER_STEPS and other == 0,
              f"{kind}: {n} {key} launches (expected {per_step} x "
              f"{OTHER_STEPS}), {other} of other kernels (per-tensor "
              f"{kind} included)")
        check(res["unfused"][2] + res["unfused"][3] == 0,
              f"{kind}: the unfused run launched a kernel")
        pt = res["per_tensor"]
        check(pt[2] == PARAMS_PER_STEP * OTHER_STEPS and pt[3] == 0,
              f"{kind} per-tensor run: {pt[2]} {kind} launches (expected "
              f"{PARAMS_PER_STEP} x {OTHER_STEPS}), {pt[3]} others")
        check(all(np.isfinite(losses)), f"{kind}: loss not finite")
        held_equal(fused, plain, f"{kind} multi-tensor against per-tensor")
        out[kind] = {"kernel": key, "launches": n,
                     "launches_per_step": per_step, "losses": losses,
                     "step_ms": times, "update_host_ms": update_ms,
                     "unfused_update_host_ms": res["unfused"][4],
                     "per_tensor_step_ms": pt[1],
                     "per_tensor_update_host_ms": pt[4],
                     "states_held": n_states}
        print(f"train resnet50 {kind} x{OTHER_STEPS}: {n} {key} launches "
              f"({per_step}/step, no per-tensor {kind}), update host ms "
              f"{ms(update_ms)} (unfused {ms(res['unfused'][4])}, "
              f"per-tensor {ms(pt[4])}), step ms {ms(times)} (per-tensor "
              f"{ms(pt[1])}), losses "
              + " ".join(f"{v:.6f}" for v in losses)
              + f"; fused == unfused == per-tensor {kind} bitwise over "
              f"{n_states} states", flush=True)
        fused.eval()
        ref = serve(fused, dev, inputs, None, False)["logits"]
        serve(fused, dev, inputs, None, True)
        out[f"{kind}_bn_only"] = bn_only_update(dev, fused, inputs, kind,
                                                ref)
    return out


def sync_warnings(fn):
    """The synchronizing CUDA calls ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (its warning
    "called a synchronizing CUDA operation"; the mode's one-time notice
    that it is a prototype is not one): the place (file:line) of each."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{w.filename}:{w.lineno}" for w in seen
            if "called a synchronizing" in str(w.message)]


def live_states(model):
    """Copies of every state of ``model`` and of its optimizer (a guard's
    scalars and shadows included), by name."""
    d = {k: t.data.detach().clone() for k, t in model.get_states().items()}
    d.update({f"optimizer/{k}": t.data.clone()
              for k, t in model.optimizer.state_tensor_dict().items()})
    return d


def guarded_run(model, optimizer, start, tx, bad_tx, ty):
    """``BF16_STEPS`` guarded steps of ``model`` (compiled under
    ``bf16_mixed``) with ``optimizer`` from ``start``, step ``POISON_STEP``
    on ``bad_tx``; the launch counts are zeroed just before and read just
    after. Returns the losses, step times (CUDA events), launches, the
    update's host ms per step, the loss scale and skipped count after
    each step, and copies of every state after steps ``POISON_STEP - 1``
    and ``POISON_STEP``."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import fused_optim as fo
    load_numpy_states(model, start)
    model.set_optimizer(optimizer)
    update_ms = timed_updates(optimizer)
    guard = model.optimizer
    guard_ms = timed_guard(guard)
    model.train()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(BF16_STEPS)]
    losses, scales, skipped, snaps = [], [], [], {}
    own = guard.state_tensor_dict()
    torch.cuda.synchronize()
    fo.reset_counts()
    for i, (begin, end) in enumerate(events, 1):
        begin.record()
        _, loss = model(bad_tx if i == POISON_STEP else tx, ty)
        end.record()
        losses.append(loss.data.detach())
        scales.append(own["loss_scale"].data.clone())
        skipped.append(own["guard/skipped_total"].data.clone())
        if i in (POISON_STEP - 1, POISON_STEP):
            snaps[i] = live_states(model)
    counts = dict(fo.launches)
    torch.cuda.synchronize()
    return {"losses": [float(v) for v in losses],
            "step_ms": [b.elapsed_time(e) for b, e in events],
            "launches": counts, "update_host_ms": update_ms,
            "guard_host_ms": guard_ms,
            "loss_scale": [float(v) for v in scales],
            "skipped_total": [float(v) for v in skipped],
            "snapshots": snaps}


def timed_guard(guard):
    """Time the guard's own host work in each step (host clock, no
    sync): the unscale and norm, the BN shadows and the bookkeeping, the
    optimizer update not included. Returns the list the times (ms, one per
    step) go to."""
    times = []
    for name in ("_unscale", "_restore_shadows", "_bookkeeping"):
        real = getattr(guard, name)

        def timed(*args, _real=real, _first=name == "_unscale"):
            t0 = time.perf_counter()
            out = _real(*args)
            ms = (time.perf_counter() - t0) * 1e3
            if _first:
                times.append(ms)
            else:
                times[-1] += ms
            return out
        setattr(guard, name, timed)
    return times


def bf16_train_phase(dev, models, tx, ty, start, f32, inputs):
    """ResNet-50 b32 under ``Model.compile(policy="bf16_mixed")`` (the
    optimizer wrapped in ``resilience.GuardedOptimizer``), from the f32
    phase's weights and batch, step ``POISON_STEP`` on a batch holding a
    NaN: fused (K1's multi-tensor launch with the skip flag) and unfused,
    cuDNN deterministic. Gates: (a) the two runs' states bitwise after
    the steps; (b) the poisoned step a bitwise no-op on every parameter,
    momentum, the step counter and every BN statistic, the loss scale
    halved, ``skipped_total`` 1, the later losses finite and moving; (c)
    the first loss within ``BF16_LOSS_TOL`` of the f32 phase's, and the
    trained states served under the policy within the serving gate of
    their f32 serve; (d) one guarded step makes no more synchronizing
    calls than one f32 step. Then ``BF16_OTHER_STEPS`` guarded steps of
    Adam, RMSProp and AdaGrad through their flagged launches."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.resilience import GuardedOptimizer
    from singa_tpu_torch.tensor import Tensor
    fused, plain = models
    # (d), the f32 side: one step of the f32 phase's fused SGD
    fused.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5,
                                fused=True))
    fused.train()
    fused(tx, ty)               # the optimizer's states are made here
    f32_syncs = sync_warnings(lambda: fused(tx, ty))
    bad = tx.data.clone()
    bad.view(-1)[0] = float("nan")
    bad_tx = Tensor(data=bad, device=dev)
    runs = {}
    for name, m in (("fused", fused), ("unfused", plain)):
        m.compile([tx], is_train=True, policy="bf16_mixed")
        torch.cuda.reset_peak_memory_stats()
        sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5,
                      fused=name == "fused")
        runs[name] = guarded_run(m, sgd, start, tx, bad_tx, ty)
        runs[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        check(isinstance(m.optimizer, GuardedOptimizer),
              f"{name}: compile(policy='bf16_mixed') did not wrap the "
              "optimizer in GuardedOptimizer")
    f, u = runs["fused"], runs["unfused"]
    per_step = multi_chunks("sgd_multi", PARAMS_PER_STEP)
    k1 = f["launches"].pop("sgd_multi", 0)
    check(k1 == per_step * BF16_STEPS and not any(f["launches"].values()),
          f"bf16_mixed fused run: {k1} K1 multi-tensor launches (expected "
          f"{per_step} x {BF16_STEPS}), others {f['launches']}")
    check(not any(u["launches"].values()),
          f"bf16_mixed unfused run launched {u['launches']}")
    # (a)
    n_states = held_equal(fused, plain, "bf16_mixed SGD")
    # (b)
    for name, r in runs.items():
        before, after = r["snapshots"][POISON_STEP - 1], \
            r["snapshots"][POISON_STEP]
        skip = ("optimizer/loss_scale", "optimizer/guard/bad_streak",
                "optimizer/guard/good_streak", "optimizer/guard/skipped_total",
                "optimizer/guard/last_grad_norm")
        moved = [k for k in before if k not in skip
                 and not torch.equal(before[k], after[k])]
        check(not moved, f"{name}: the poisoned step {POISON_STEP} moved "
              f"{len(moved)} states, e.g. {moved[:3]}")
        check(any(k.startswith("optimizer/guard-shadow/") for k in before)
              and "optimizer/step_counter" in before,
              f"{name}: no BN shadows or step counter among the states")
        i = POISON_STEP - 1
        check(r["loss_scale"][i] == r["loss_scale"][i - 1] / 2 and
              r["skipped_total"][-1] == 1 and r["skipped_total"][i] == 1,
              f"{name}: loss scale {r['loss_scale']}, skipped "
              f"{r['skipped_total']}: expected a halving at step "
              f"{POISON_STEP} and one skip")
        later = r["losses"][POISON_STEP:]
        check(all(np.isfinite(later)) and len(set(later)) > 1,
              f"{name}: losses after the poisoned step {later}")
        check(not np.isfinite(r["losses"][i]),
              f"{name}: the poisoned step's loss {r['losses'][i]} is finite")
        del r["snapshots"]
    # (c)
    first, f32_first = f["losses"][0], f32["losses"][0]
    check(abs(first - f32_first) <= BF16_LOSS_TOL * abs(f32_first),
          f"bf16_mixed first loss {first} against f32 {f32_first}")
    fused.eval()
    got = serve(fused, dev, inputs, "bf16_mixed", True)["logits"]
    ref = serve(fused, dev, inputs, "float32", True)["logits"]
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    check(np.isfinite(got).all() and err <= REL_TOL["bf16_mixed"] * scale,
          f"bf16_mixed-trained states served under the policy differ from "
          f"their f32 serve by {err} (max |logit| {scale})")
    # (d), the guarded side: one more step of the fused run
    fused.train()
    guarded_syncs = sync_warnings(lambda: fused(tx, ty))
    check(len(guarded_syncs) <= len(f32_syncs),
          f"a guarded step made {len(guarded_syncs)} synchronizing calls "
          f"({guarded_syncs}), an f32 step {len(f32_syncs)} ({f32_syncs})")
    rec = {"steps": BF16_STEPS, "batch": BATCH, "poison_step": POISON_STEP,
           "states_held": n_states, "k1_launches": k1,
           "k1_launches_per_step": k1 / BF16_STEPS, "losses": f["losses"],
           "unfused_losses": u["losses"], "loss_scale": f["loss_scale"],
           "skipped_total": f["skipped_total"], "f32_first_loss": f32_first,
           "eval_max_abs_err_vs_f32": err, "eval_max_abs_logit": scale,
           "sync_warnings": guarded_syncs, "f32_sync_warnings": f32_syncs,
           "f32_step_p50_ms": f32["step_p50_ms"]}
    for name, r in runs.items():
        t = np.asarray(r["step_ms"][TIMED_FROM:])
        h = np.asarray(r["update_host_ms"][TIMED_FROM:])
        g = np.asarray(r["guard_host_ms"][TIMED_FROM:])
        pre = "" if name == "fused" else f"{name}_"
        rec.update({f"{pre}img_per_s": BATCH * len(t) / (t.sum() / 1e3),
                    f"{pre}step_p50_ms": float(np.percentile(t, 50)),
                    f"{pre}step_p99_ms": float(np.percentile(t, 99)),
                    f"{pre}step_ms": r["step_ms"],
                    f"{pre}update_host_p50_ms": float(np.percentile(h, 50)),
                    f"{pre}update_host_ms": r["update_host_ms"],
                    f"{pre}guard_host_p50_ms": float(np.percentile(g, 50)),
                    f"{pre}guard_host_ms": r["guard_host_ms"],
                    f"{pre}peak_device_bytes": r["peak_bytes"]})
    print(f"train resnet50 NCHW bf16_mixed b{BATCH} SGD x{BF16_STEPS} (step "
          f"{POISON_STEP} poisoned, timed from step {TIMED_FROM}): img/s="
          f"{rec['img_per_s']:.1f} step p50={rec['step_p50_ms']:.2f} ms "
          f"p99={rec['step_p99_ms']:.2f} ms (f32 p50 "
          f"{rec['f32_step_p50_ms']:.2f} ms; unfused p50 "
          f"{rec['unfused_step_p50_ms']:.2f} ms) update host p50="
          f"{rec['update_host_p50_ms']:.3f} ms (unfused "
          f"{rec['unfused_update_host_p50_ms']:.3f} ms) guard host p50="
          f"{rec['guard_host_p50_ms']:.3f} ms peak="
          f"{rec['peak_device_bytes'] / 2**30:.2f} GiB; K1 multi-tensor "
          f"launches with the flag={k1}; fused == unfused bitwise over "
          f"{n_states} states; step {POISON_STEP} a no-op, loss scale "
          f"{f['loss_scale'][POISON_STEP - 2]} -> "
          f"{f['loss_scale'][POISON_STEP - 1]}, skipped "
          f"{f['skipped_total'][-1]:.0f}; first loss {first:.6f} (f32 "
          f"{f32_first:.6f}); served under the policy against f32 "
          f"max_abs_err={err:.3g} (max |logit| {scale:.3g}); synchronizing "
          f"calls per step {len(guarded_syncs)} {guarded_syncs} (f32 "
          f"{len(f32_syncs)} {f32_syncs})", flush=True)
    print("bf16_mixed losses: " + " ".join(f"{v:.6f}" for v in f["losses"]),
          flush=True)
    rec["other"] = bf16_other_optimizers(fused, tx, ty, start)
    return rec


def bf16_other_optimizers(model, tx, ty, start):
    """``BF16_OTHER_STEPS`` guarded steps each of Adam, RMSProp and AdaGrad
    on the bf16_mixed model: their multi-tensor launches with the skip
    flag (3, 2, 2 per step), finite losses, no skip."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import fused_optim as fo
    makers = {"adam": lambda: opt.Adam(lr=1e-3, fused=True),
              "rmsprop": lambda: opt.RMSProp(lr=1e-3, fused=True),
              "adagrad": lambda: opt.AdaGrad(lr=1e-2, fused=True)}
    out = {}
    for kind, make in makers.items():
        load_numpy_states(model, start)
        model.set_optimizer(make())
        model.train()
        torch.cuda.synchronize()
        fo.reset_counts()
        losses = [model(tx, ty)[1].data.detach()
                  for _ in range(BF16_OTHER_STEPS)]
        counts = dict(fo.launches)
        torch.cuda.synchronize()
        key = f"{kind}_multi"
        n = counts.pop(key, 0)
        per_step = multi_chunks(key, PARAMS_PER_STEP)
        losses = [float(v) for v in losses]
        stats = model.optimizer.stats()
        check(n == per_step * BF16_OTHER_STEPS and not any(counts.values())
              and np.isfinite(losses).all() and stats["skipped_total"] == 0,
              f"bf16_mixed {kind}: {n} {key} launches (expected {per_step} "
              f"x {BF16_OTHER_STEPS}), others {counts}, losses {losses}, "
              f"{stats}")
        out[kind] = {"kernel": key, "launches": n, "losses": losses}
        print(f"train resnet50 bf16_mixed {kind} x{BF16_OTHER_STEPS}: {n} "
              f"{key} launches with the skip flag, losses "
              + " ".join(f"{v:.6f}" for v in losses), flush=True)
    return out


def timed_steps(model, tx, ty, steps):
    """CUDA-event ms of each of ``steps`` train calls (one sync at the
    end)."""
    import torch
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for begin, end in events:
        begin.record()
        model(tx, ty)
        end.record()
    torch.cuda.synchronize()
    return [b.elapsed_time(e) for b, e in events]


def port_kernel(name):
    """The launch-counter key (``launches`` of ``ops/fused_epilogue.py``,
    ``ops/fused_optim.py`` or ``ops/attention.py``) of the port's kernel
    that a profiler trace names ``name``, or None for any other kernel."""
    m = PORT_KERNEL.search(name)
    if m is None:
        return None
    base = m.group(1).removesuffix("_mma")
    args = [a.strip() for a in m.group(2).split(",")]
    if base == "affine_relu":           # <traits, NHWC, RES>
        kind = "affine_add_relu" if args[-1] == "true" else "affine_relu"
        return f"{kind}_{'nhwc' if args[-2] == 'true' else 'nchw'}"
    if base in ("scaled", "scaled_multi"):      # <P, S, ADAGRAD>
        kind = "adagrad" if args[-1] == "true" else "rmsprop"
        return kind + base[len("scaled"):]
    return base if base in PORT_KEYS else None


def zero_counts():
    """Zero the host launch counters of every kernel family."""
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.ops import fused_epilogue as fe
    from singa_tpu_torch.ops import fused_optim as fo
    for mod in (at, fe, fo):
        mod.reset_counts()


def host_launches():
    """The nonzero host launch counts of every kernel family, by key."""
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.ops import fused_epilogue as fe
    from singa_tpu_torch.ops import fused_optim as fo
    return {k: v for mod in (at, fe, fo) for k, v in mod.launches.items()
            if v}


def profiled(fn, attempts, want, what):
    """``fn()`` under ``torch.profiler`` (CPU + CUDA activities), the host
    counts zeroed just before it, ending in a synchronize, after
    ``PROFILE_PAD`` launches of a padding kernel. The port's kernels are
    counted by name in the trace (:func:`port_kernel`): a
    CUDA graph's replay launches its kernels on the device and moves no
    host counter, and the trace holds them like any other. A session
    whose count is not ``want`` (a trace that misses some of a run's
    kernels is seen now and then on the card's machine) is run again, up
    to ``attempts`` sessions, then fails. Returns ``fn``'s result, the
    trace's counts, the host counts, the device events (ms, count) and
    the wall ms of the session."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(attempts):
        zero_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        host = host_launches()
        counts, busy, ops = {}, 0.0, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA \
                    or "spin_kernel" in e.name:
                continue
            busy += e.time_range.elapsed_us() / 1e3
            ops += 1
            key = port_kernel(e.name)
            if key is not None:
                counts[key] = counts.get(key, 0) + 1
        if counts == want:
            return out, counts, host, (busy, ops), wall
        print(f"profiler session {attempt + 1} of {what} counted the "
              f"port's kernels {counts}, expected {want}", flush=True)
    raise SmokeFailure(f"{what}: no profiler session in {attempts} counted "
                       f"the port's kernels {want}")


def traced(fn, calls, per_call, what, attempts=5):
    """``calls`` calls of ``fn`` under ``torch.profiler`` after one
    untraced call (:func:`profiled`): wall ms per call on the host clock,
    device busy ms per call (the sum of the kernels, copies and fills the
    trace holds), device ops per call, the device's idle share, 1 - busy /
    wall, and the launches of the port's kernels counted in the trace,
    which must be ``per_call`` (``{key: n}``) times ``calls``, beside the
    host counts of the same calls."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
    want = {k: n * calls for k, n in per_call.items() if n}
    _, counts, host, (busy, ops), wall = profiled(run, attempts, want,
                                                  what)
    return {"wall_ms": wall / calls, "busy_ms": busy / calls,
            "ops": ops / calls, "idle_share": 1.0 - busy / wall,
            "calls": calls, "launches": counts, "host_launches": host}


def alternating_rounds(runs, rounds, steps):
    """``rounds`` rounds of ``steps`` timed calls of each ``{name: fn}``
    (``fn(steps)`` returns the ms of each call), in turns whose order
    flips every round. Returns ``{name: [ms, ...]}``."""
    names = list(runs)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n] += runs[n](steps)
    return times


def quantiles(ms):
    import numpy as np
    t = np.asarray(ms)
    return {"p50_ms": float(np.percentile(t, 50)),
            "p99_ms": float(np.percentile(t, 99)), "n": len(ms)}


def graph_sgd(opt):
    return opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5, fused=True)


def graph_adam(opt):
    """Adam on a decaying lr: the lr and the bias corrections move every
    step, inside the captured step too."""
    return opt.Adam(lr=opt.ExponentialDecay(1e-3, decay_steps=1,
                                            decay_rate=0.9), fused=True)


def graph_run(model, start, tx, ty, bad_tx, steps, optimizer=graph_sgd):
    """``steps`` fused steps of ``model`` (graph mode as compiled) from
    ``start`` with ``optimizer(opt)``, step ``POISON_STEP`` on ``bad_tx``
    unless it is None; the launch counts are zeroed just before and read
    just after, the peak memory reset just before. Returns the losses,
    the lr, and the loss scale and ``skipped_total`` after each step (a
    guard's; None without), copies of every state around the poisoned
    step, the launches, and the peak device bytes, also above what was
    allocated at the start (both models' states and the other phases'
    leftovers are in the peak)."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    load_numpy_states(model, start)
    model.set_optimizer(optimizer(opt))
    model.train()
    own = model.optimizer.state_tensor_dict()
    guarded = "guard/skipped_total" in own
    losses, lrs, scales, skipped, snaps = [], [], [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    for i in range(1, steps + 1):
        poisoned = bad_tx is not None and i == POISON_STEP
        _, loss = model(bad_tx if poisoned else tx, ty)
        losses.append(loss.data.detach())
        lrs.append(model.optimizer.lr_value.clone())
        if guarded:
            scales.append(own["loss_scale"].data.clone())
            skipped.append(own["guard/skipped_total"].data.clone())
        if bad_tx is not None and i in (POISON_STEP - 1, POISON_STEP):
            snaps[i] = live_states(model)
    counts = host_launches()
    torch.cuda.synchronize()
    return {"losses": [float(v) for v in losses],
            "lr": [float(v) for v in lrs],
            "loss_scale": [float(v) for v in scales] if guarded else None,
            "skipped_total": [float(v) for v in skipped] if guarded
            else None,
            "snapshots": snaps, "launches": counts,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated()
            - base}


def graph_gates(what, g_model, e_model, g, e, key, per_step, steps,
                poisoned):
    """The gates of a graphed run ``g`` against the eager run ``e`` of
    ``steps`` steps: one signature captured once; the host counted
    ``per_step`` launches of multi-tensor kernel ``key`` at the eager call
    and at the capture only (a replay counts none), the eager run at every
    step; the losses, the lr after each step and every state bitwise;
    with ``poisoned``, the poisoned step (a replay) a bitwise no-op on
    every state but the guard's scalars, and the loss scale and
    ``skipped_total`` step by step as eager's. Returns the states held."""
    import numpy as np
    import torch
    stats = list(g_model.graph_stats().values())
    check(stats == [{"n_captures": 1, "n_replays": steps - 1}],
          f"{what}: {stats} after {steps} steps, expected one signature "
          "captured once")
    check(g["launches"] == {key: 2 * per_step} and
          e["launches"] == {key: per_step * steps},
          f"{what}: host-counted launches {g['launches']} (expected "
          f"{per_step} {key} at the eager call and {per_step} at the "
          f"capture), eager {e['launches']}")
    check(np.array_equal(g["losses"], e["losses"], equal_nan=True) and
          g["lr"] == e["lr"],
          f"{what}: losses {g['losses']} and lr {g['lr']} differ from "
          f"eager's {e['losses']}, {e['lr']}")
    n_states = held_equal(g_model, e_model, what)
    if poisoned:
        before, after = g["snapshots"][POISON_STEP - 1], \
            g["snapshots"][POISON_STEP]
        moved = [k for k in before if not k.startswith(
            ("optimizer/loss_scale", "optimizer/guard/"))
            and not torch.equal(before[k], after[k])]
        check(not moved, f"{what}: the poisoned step {POISON_STEP} (a "
              f"replay) moved {len(moved)} states, e.g. {moved[:3]}")
        check(g["loss_scale"] == e["loss_scale"] and
              g["skipped_total"] == e["skipped_total"] and
              g["skipped_total"][-1] == 1,
              f"{what}: loss scale {g['loss_scale']}, skipped "
              f"{g['skipped_total']}; eager {e['loss_scale']}, "
              f"{e['skipped_total']}")
    for r in (g, e):
        del r["snapshots"]
    return n_states


def replay_counts(what, trace, key):
    """The launches of ``key`` that the trace of traced replayed calls
    counted (``traced``, which held them to their expected count), after
    checking that the replays moved no host counter and that the eager
    calls' host counts equal their trace's."""
    g, e = trace["graph"], trace["eager"]
    check(not g["host_launches"] and e["host_launches"] == e["launches"],
          f"{what}: traced replays counted {g['host_launches']} on the "
          f"host (a replay moves none); eager host {e['host_launches']}, "
          f"trace {e['launches']}")
    return {"replayed_launches": g["launches"][key], "replays": g["calls"],
            "launches_per_replay": g["launches"][key] / g["calls"]}


def graph_train_phase(dev, models, tx, ty, start):
    """ResNet-50 b32 in graph mode (``Model.compile(use_graph=True)``: call
    1 eager, call 2 captured in a CUDA graph, replays after) against the
    eager step, from the same start, in f32 and under bf16_mixed (step
    ``POISON_STEP`` on a batch holding a NaN), cuDNN deterministic, with
    the fused SGD (:func:`graph_gates`); then, under bf16_mixed, the same
    with Adam on a decaying lr (:func:`graph_adam`, K5's multi-tensor
    launch with the skip flag). No synchronizing call in a replayed step.
    The launches of a replayed step are counted by name in the trace of
    ``GRAPH_TRACED`` replays (:func:`traced`): K1's (K5's) multi-tensor
    launches per step, and none on the host. Readings: step p50/p99 and
    img/s of graph and eager in ``GRAPH_ROUNDS`` alternating rounds, peak
    memory of the gated runs, and the device's idle share, busy time and
    ops of the traced steps."""
    from singa_tpu_torch.tensor import Tensor
    g_model, e_model = models
    bad = tx.data.clone()
    bad.view(-1)[0] = float("nan")
    bad_tx = Tensor(data=bad, device=dev)
    per_step = multi_chunks("sgd_multi", PARAMS_PER_STEP)
    out = {}
    for policy in (None, "bf16_mixed"):
        pname = policy or "float32"
        poison = bad_tx if policy else None
        g_model.compile([tx], is_train=True, use_graph=True, policy=policy)
        e_model.compile([tx], is_train=True, use_graph=False,
                        policy=policy)
        g = graph_run(g_model, start, tx, ty, poison, GRAPH_STEPS)
        e = graph_run(e_model, start, tx, ty, poison, GRAPH_STEPS)
        n_states = graph_gates(f"graph {pname}", g_model, e_model, g, e,
                               "sgd_multi", per_step, GRAPH_STEPS, policy)
        syncs = sync_warnings(lambda: g_model(tx, ty))
        check(not syncs, f"graph {pname}: a replayed step made "
              f"{len(syncs)} synchronizing calls: {syncs}")
        e_syncs = sync_warnings(lambda: e_model(tx, ty))
        times = alternating_rounds(
            {"graph": lambda n: timed_steps(g_model, tx, ty, n),
             "eager": lambda n: timed_steps(e_model, tx, ty, n)},
            GRAPH_ROUNDS, GRAPH_ROUND_STEPS)
        want = {"sgd_multi": per_step}
        trace = {name: traced(lambda m=m: m(tx, ty), GRAPH_TRACED, want,
                              f"graph {pname} {name} steps")
                 for name, m in (("graph", g_model), ("eager", e_model))}
        replayed = replay_counts(f"graph {pname}", trace, "sgd_multi")
        stats = list(g_model.graph_stats().values())
        check(len(stats) == 1 and stats[0]["n_captures"] == 1,
              f"graph {pname}: {stats} after the timed rounds")
        rec = {"policy": pname, "steps": GRAPH_STEPS, "batch": BATCH,
               "states_held": n_states, "losses": g["losses"],
               "loss_scale": g["loss_scale"],
               "skipped_total": g["skipped_total"],
               "sgd_multi": replayed,
               "replays_total": stats[0]["n_replays"],
               "host_launches": g["launches"],
               "sync_warnings_per_replay": syncs,
               "eager_sync_warnings": e_syncs}
        for name, r in (("graph", g), ("eager", e)):
            q = quantiles(times[name])
            rec[name] = {"step_p50_ms": q["p50_ms"],
                         "step_p99_ms": q["p99_ms"],
                         "steps_timed": q["n"], "step_ms": times[name],
                         "img_per_s": BATCH * len(times[name])
                         / (sum(times[name]) / 1e3),
                         "peak_device_bytes": r["peak_bytes"],
                         "peak_above_start_bytes":
                         r["peak_above_start_bytes"],
                         "traced": trace[name]}
        out[pname] = rec
        gr, er = rec["graph"], rec["eager"]
        print(f"graph train resnet50 NCHW {pname} b{BATCH}: step p50 "
              f"{gr['step_p50_ms']:.2f} ms p99 {gr['step_p99_ms']:.2f} ms "
              f"img/s {gr['img_per_s']:.1f} against eager p50 "
              f"{er['step_p50_ms']:.2f} ms p99 {er['step_p99_ms']:.2f} ms "
              f"img/s {er['img_per_s']:.1f} ({GRAPH_ROUNDS} alternating "
              f"rounds of {GRAPH_ROUND_STEPS}); peak "
              f"{gr['peak_device_bytes'] / 2**30:.2f} GiB, "
              f"{gr['peak_above_start_bytes'] / 2**30:.2f} above the start "
              f"(eager {er['peak_device_bytes'] / 2**30:.2f}, "
              f"{er['peak_above_start_bytes'] / 2**30:.2f}); traced: idle "
              f"{gr['traced']['idle_share']:.3f} busy "
              f"{gr['traced']['busy_ms']:.2f} ms ops "
              f"{gr['traced']['ops']:.0f} wall "
              f"{gr['traced']['wall_ms']:.2f} ms (eager idle "
              f"{er['traced']['idle_share']:.3f} busy "
              f"{er['traced']['busy_ms']:.2f} ms ops "
              f"{er['traced']['ops']:.0f} wall "
              f"{er['traced']['wall_ms']:.2f} ms); graph == eager bitwise "
              f"over {n_states} states and {GRAPH_STEPS} losses"
              + (f", step {POISON_STEP} a no-op under replay, skipped "
                 f"{g['skipped_total'][-1]:.0f}" if policy else "")
              + f"; 1 capture, {rec['replays_total']} replays; K1 "
              f"multi-tensor launches counted in the trace of "
              f"{replayed['replays']} replays: "
              f"{replayed['replayed_launches']}, none on the host; "
              f"synchronizing calls per replayed step {len(syncs)} (eager "
              f"{len(e_syncs)})", flush=True)
    out["adam_bf16_mixed"] = graph_adam_leg(models, tx, ty, start, bad_tx)
    return out


def graph_adam_leg(models, tx, ty, start, bad_tx):
    """bf16_mixed guarded Adam on a decaying lr (:func:`graph_adam`), graph
    against eager over ``GRAPH_ADAM_STEPS`` steps, step ``POISON_STEP``
    poisoned (:func:`graph_gates`: the lr too, step by step, bitwise),
    then ``GRAPH_TRACED`` replays traced: K5's multi-tensor launches per
    step, none on the host. The models are compiled under bf16_mixed."""
    g_model, e_model = models
    per_step = multi_chunks("adam_multi", PARAMS_PER_STEP)
    g = graph_run(g_model, start, tx, ty, bad_tx, GRAPH_ADAM_STEPS,
                  graph_adam)
    e = graph_run(e_model, start, tx, ty, bad_tx, GRAPH_ADAM_STEPS,
                  graph_adam)
    what = "graph bf16_mixed adam"
    n_states = graph_gates(what, g_model, e_model, g, e, "adam_multi",
                           per_step, GRAPH_ADAM_STEPS, True)
    syncs = sync_warnings(lambda: g_model(tx, ty))
    check(not syncs, f"{what}: a replayed step made {len(syncs)} "
          f"synchronizing calls: {syncs}")
    want = {"adam_multi": per_step}
    trace = {name: traced(lambda m=m: m(tx, ty), GRAPH_TRACED, want,
                          f"{what} {name} steps")
             for name, m in (("graph", g_model), ("eager", e_model))}
    replayed = replay_counts(what, trace, "adam_multi")
    rec = {"steps": GRAPH_ADAM_STEPS, "states_held": n_states,
           "losses": g["losses"], "lr": g["lr"],
           "loss_scale": g["loss_scale"],
           "skipped_total": g["skipped_total"], "adam_multi": replayed,
           "host_launches": g["launches"],
           "sync_warnings_per_replay": syncs,
           "traced": {n: trace[n] for n in trace}}
    print(f"{what} b{BATCH}: graph == eager bitwise over {n_states} states,"
          f" {GRAPH_ADAM_STEPS} losses and lr "
          + " ".join(f"{v:.6g}" for v in g["lr"])
          + f"; step {POISON_STEP} a no-op under replay, skipped "
          f"{g['skipped_total'][-1]:.0f}; K5 multi-tensor launches counted "
          f"in the trace of {replayed['replays']} replays: "
          f"{replayed['replayed_launches']}, none on the host; losses "
          + " ".join(f"{v:.6f}" for v in g["losses"]), flush=True)
    return rec


def graph_serve_phase(dev, seed=SEED):
    """ResNet-50 b32 serving in f32 and under bf16_mixed: the graphed
    ``BatchServingEngine`` (the default) and the eager one
    (``use_graph=False``) from the same weights on the same requests.
    Gates: the two engines' logits bitwise; K2 launched 49 times per
    replay, counted in the trace of the replayed run (:func:`serve`);
    after ``load_numpy_states`` of other weights the graphed engine serves
    them, bitwise with the eager engine, recapturing once. Readings: tick
    p50/p99 and img/s of each in ``GRAPH_ROUNDS`` alternating rounds (the
    tick quantiles over every tick of the engine: the rounds, and
    :func:`serve`'s timed and counted runs), the device memory each engine
    holds."""
    import numpy as np
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import resnet
    from singa_tpu_torch.observability.metrics import Registry
    model = resnet.resnet50(num_classes=10)
    model.eval()
    model.compile_serving(input_shape=SHAPE, batch=BATCH, device=dev,
                          use_graph=False)
    load_numpy_states(model, seeded_states(model, seed))
    other = seeded_states(model, seed + 7)
    start = seeded_states(model, seed)
    rng = np.random.default_rng(seed + 1)
    inputs = [rng.standard_normal(SHAPE, dtype=np.float32)
              for _ in range(N_REQUESTS)]
    ticks = -(-N_REQUESTS // BATCH)
    per_replay = sum(TAILS_PER_FORWARD.values())
    out = {}
    for policy in (None, "bf16_mixed"):
        pname = policy or "float32"
        load_numpy_states(model, start)
        engines, logits, held, replayed = {}, {}, {}, {}
        for name in ("graph", "eager"):
            torch.cuda.synchronize()
            before = (torch.cuda.memory_allocated(),
                      torch.cuda.memory_reserved())
            r = serve(model, dev, inputs, policy, True,
                      use_graph=name == "graph", registry=Registry())
            torch.cuda.synchronize()
            held[name] = {
                "allocated_bytes": torch.cuda.memory_allocated() - before[0],
                "reserved_bytes": torch.cuda.memory_reserved() - before[1]}
            check(r["tails"] == per_replay * ticks, f"serve graph {pname} "
                  f"{name}: {r['launches']} K2 launches in the trace, "
                  f"expected {per_replay} x {ticks}")
            engines[name], logits[name] = r["engine"], r["logits"]
            replayed[name] = {"launches": r["launches"],
                              "replays": r["replays"]}
        diff = float(np.abs(logits["graph"] - logits["eager"]).max())
        check(np.array_equal(logits["graph"], logits["eager"]),
              f"serve graph {pname}: the graphed engine's logits differ "
              f"from the eager engine's by {diff}")

        walls = {n: 0.0 for n in engines}

        def serve_round(name):
            def run(rounds):
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    serve_requests(engines[name], inputs)
                    walls[name] += time.perf_counter() - t0
                return []
            return run
        alternating_rounds({n: serve_round(n) for n in engines},
                           GRAPH_ROUNDS, 1)
        rec = {"policy": pname, "batch": BATCH, "requests": N_REQUESTS,
               "ticks_per_round": ticks, "rounds": GRAPH_ROUNDS,
               "k2_launches_per_replay":
               sum(replayed["graph"]["launches"].values())
               / replayed["graph"]["replays"],
               "counted_run": replayed}
        for name, eng in engines.items():
            ts = eng.tick_stats()
            rec[name] = {"tick_p50_ms": ts["p50_s"] * 1e3,
                         "tick_p99_ms": ts["p99_s"] * 1e3,
                         "ticks": ts["count"],
                         "img_per_s": N_REQUESTS * GRAPH_ROUNDS
                         / walls[name],
                         "held_device_bytes": held[name],
                         "graph": eng.graph_stats()}
        # other weights after the engines were built: the graphed engine
        # forwards eagerly once, captures anew and serves them
        load_numpy_states(model, other)
        eng = engines["graph"]
        caps = eng.graph_stats()
        after = {name: serve_requests(engines[name], inputs)
                 for name in ("graph", "eager")}
        moved = float(np.abs(after["graph"] - logits["graph"]).max())
        check(np.array_equal(after["graph"], after["eager"]) and moved > 0,
              f"serve graph {pname}: after the load the graphed engine's "
              f"logits differ from the eager engine's by "
              f"{float(np.abs(after['graph'] - after['eager']).max())} "
              f"(moved {moved} from the old weights')")
        now = eng.graph_stats()
        check(now == {"n_captures": 1, "n_replays": ticks - 1},
              f"serve graph {pname}: after the load {now} (before {caps}),"
              f" expected a fresh graph: {ticks} ticks, 1 capture")
        rec["after_load"] = {"moved": moved, "graph": now}
        out[pname] = rec
        g, e = rec["graph"], rec["eager"]
        print(f"graph serve resnet50 NCHW {pname} b{BATCH}: tick p50 "
              f"{g['tick_p50_ms']:.2f} ms p99 {g['tick_p99_ms']:.2f} ms "
              f"img/s {g['img_per_s']:.1f}; eager p50 "
              f"{e['tick_p50_ms']:.2f} ms p99 {e['tick_p99_ms']:.2f} ms "
              f"img/s {e['img_per_s']:.1f} ({GRAPH_ROUNDS} alternating "
              f"rounds of {ticks} ticks); K2 launches counted in the trace "
              f"of {replayed['graph']['replays']} replays: "
              f"{replayed['graph']['launches']}; device memory held: graph "
              f"{g['held_device_bytes']['reserved_bytes'] / 2**20:.0f} MiB "
              f"reserved, eager "
              f"{e['held_device_bytes']['reserved_bytes'] / 2**20:.0f} MiB;"
              f" logits bitwise; after a load of other weights the graphed "
              f"engine serves them bitwise with eager (moved {moved:.3g}), "
              f"{now}", flush=True)
        del engines, eng
        torch.cuda.empty_cache()
    return out


def lm_graph_run(model, start, tx, ty, steps):
    """``steps`` fused-SGD steps of the LM ``model`` (graph mode as
    compiled) from ``start``; the launch counts zeroed and the peak memory
    reset just before. Returns the losses, launches, peak device bytes
    (also above the start's) and copies of the parameters after."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    load_numpy_states(model, start)
    model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    losses = [model(tx, ty)[1].data.detach() for _ in range(steps)]
    launches = host_launches()
    torch.cuda.synchronize()
    return {"losses": [float(v) for v in losses], "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated()
            - base,
            "params": {k: v.data.detach().clone()
                       for k, v in model.get_params().items()}}


def graph_lm_phase(dev, tx, ty, start):
    """The LM at ``LM_SHAPE`` in graph mode (K3/K4 and K1's multi-tensor
    launch inside the captured step) against eager, ``LM_GRAPH_STEPS`` f32
    fused-SGD steps from the same start. The eager run is made twice: if
    the two agree bitwise, the graphed run must too; else it is held to
    the LM's gates (loss finite and falling, each parameter within
    ``LM_PARAM_TOL``). One capture; the host counts the kernels at the
    eager call and at the capture only, and the trace of
    ``GRAPH_TRACED`` replays counts K3's, K4's and K1's multi-tensor
    launches per step (:func:`traced`). Readings: step p50/p99 of graph
    and eager in ``GRAPH_ROUNDS`` alternating rounds, in f32 and under
    ``compute_dtype=bfloat16``, peak memory and traced idle shares."""
    import numpy as np
    import torch
    per_step = {"flash_fwd": LM["layers"], "flash_bwd_dq": LM["layers"],
                "flash_bwd_dkv": LM["layers"],
                "sgd_multi": multi_chunks("sgd_multi", LM_PARAMS_PER_STEP)}
    out = {}
    for dname, cdt in (("float32", None), ("bfloat16", torch.bfloat16)):
        g_model = lm_model(dev, tx, cdt, use_graph=True)
        e_model = lm_model(dev, tx, cdt)
        runs = {name: lm_graph_run(m, start, tx, ty, LM_GRAPH_STEPS)
                for name, m in (("graph", g_model), ("eager", e_model),
                                ("eager_again", e_model))}
        stats = list(g_model.graph_stats().values())
        check(stats == [{"n_captures": 1,
                         "n_replays": LM_GRAPH_STEPS - 1}],
              f"graph LM {dname}: {stats}")
        got = runs["graph"]["launches"]
        want = {k: 2 * v for k, v in per_step.items()}
        check(got == want,
              f"graph LM {dname}: host-counted launches {got}, expected "
              f"{want} (the eager call and the capture)")
        g, e, e2 = runs["graph"], runs["eager"], runs["eager_again"]
        eager_bitwise = e["losses"] == e2["losses"] and all(
            torch.equal(e["params"][k], e2["params"][k]) for k in e["params"])
        rel = {k: ((g["params"][k].float() - v.float()).norm()
                   / v.float().norm()).item()
               for k, v in e["params"].items()}
        worst = max(rel, key=rel.get)
        if dname == "float32":
            if eager_bitwise:
                check(g["losses"] == e["losses"] and rel[worst] == 0.0,
                      f"graph LM f32: two eager runs agree bitwise, the "
                      f"graphed one differs (losses {g['losses']} against "
                      f"{e['losses']}, {worst} by {rel[worst]})")
            else:
                check(all(np.isfinite(g["losses"])) and
                      g["losses"][-1] < g["losses"][0] and
                      rel[worst] <= LM_PARAM_TOL,
                      f"graph LM f32: losses {g['losses']}, {worst} differs "
                      f"from eager by {rel[worst]} (tolerance "
                      f"{LM_PARAM_TOL})")
        else:
            check(all(np.isfinite(g["losses"])) and
                  g["losses"][-1] < g["losses"][0],
                  f"graph LM bf16: losses {g['losses']}")
        syncs = sync_warnings(lambda: g_model(tx, ty))
        check(not syncs, f"graph LM {dname}: a replayed step made "
              f"{len(syncs)} synchronizing calls: {syncs}")
        times = alternating_rounds(
            {"graph": lambda n: timed_steps(g_model, tx, ty, n),
             "eager": lambda n: timed_steps(e_model, tx, ty, n)},
            GRAPH_ROUNDS, LM_GRAPH_ROUND_STEPS)
        trace = {name: traced(lambda m=m: m(tx, ty), GRAPH_TRACED,
                              per_step, f"graph LM {dname} {name} steps")
                 for name, m in (("graph", g_model), ("eager", e_model))}
        replayed = {k: replay_counts(f"graph LM {dname}", trace, k)
                    for k in per_step}
        stats = list(g_model.graph_stats().values())
        toks = LM["batch"] * LM["seq"]
        rec = {"compute_dtype": dname, "steps": LM_GRAPH_STEPS,
               "losses": g["losses"], "eager_losses": e["losses"],
               "eager_runs_bitwise": eager_bitwise,
               "max_param_rel_diff_vs_eager": rel[worst],
               "max_param_rel_diff_at": worst,
               "replayed": replayed,
               "replays_total": stats[0]["n_replays"],
               "host_launches": got, "sync_warnings_per_replay": syncs}
        for name, r in (("graph", g), ("eager", e)):
            q = quantiles(times[name])
            rec[name] = {"step_p50_ms": q["p50_ms"],
                         "step_p99_ms": q["p99_ms"], "steps_timed": q["n"],
                         "step_ms": times[name],
                         "tokens_per_s": toks * len(times[name])
                         / (sum(times[name]) / 1e3),
                         "peak_device_bytes": r["peak_bytes"],
                         "peak_above_start_bytes":
                         r["peak_above_start_bytes"],
                         "traced": trace[name]}
        out[dname] = rec
        gr, er = rec["graph"], rec["eager"]
        print(f"graph train LM {dname} B{LM['batch']} S{LM['seq']}: step "
              f"p50 {gr['step_p50_ms']:.2f} ms p99 {gr['step_p99_ms']:.2f}"
              f" ms tokens/s {gr['tokens_per_s']:.0f} against eager p50 "
              f"{er['step_p50_ms']:.2f} ms p99 {er['step_p99_ms']:.2f} ms "
              f"tokens/s {er['tokens_per_s']:.0f} ({GRAPH_ROUNDS} "
              f"alternating rounds of {LM_GRAPH_ROUND_STEPS}); peak "
              f"{gr['peak_device_bytes'] / 2**30:.2f} GiB, "
              f"{gr['peak_above_start_bytes'] / 2**30:.2f} above the start "
              f"(eager {er['peak_device_bytes'] / 2**30:.2f}, "
              f"{er['peak_above_start_bytes'] / 2**30:.2f}); traced idle "
              f"{gr['traced']['idle_share']:.3f} busy "
              f"{gr['traced']['busy_ms']:.2f} ms ops "
              f"{gr['traced']['ops']:.0f} (eager idle "
              f"{er['traced']['idle_share']:.3f} busy "
              f"{er['traced']['busy_ms']:.2f} ms ops "
              f"{er['traced']['ops']:.0f}); two eager runs bitwise: "
              f"{eager_bitwise}, graph against eager max param rel diff "
              f"{rel[worst]:.3g}; losses "
              + " ".join(f"{v:.6f}" for v in g["losses"])
              + f"; 1 capture, {rec['replays_total']} replays; launches "
              f"counted in the trace of {GRAPH_TRACED} replays "
              f"{trace['graph']['launches']}, none on the host",
              flush=True)
        del g_model, e_model, runs
        torch.cuda.empty_cache()
    return out


def flash_pairs(B, H, Sq, Sk, causal):
    """Unmasked (q, k) pairs: all of them, or k <= q (top-left aligned)."""
    if not causal:
        return B * H * Sq * Sk
    rows = sum(min(i + 1, Sk) for i in range(Sq))
    return B * H * rows


def flash_work(kind, q, k, causal):
    """(flops, bytes) of one call: 4·D (K3), 6·D (dQ) or 8·D (dK/dV)
    flops per unmasked (q, k) pair; each input read once and each output
    written once."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    it = q.element_size()
    pairs = flash_pairs(B, H, Sq, Sk, causal)
    qb, kb, rows = B * H * Sq * D * it, B * H * Sk * D * it, B * H * Sq * 4
    if kind == "flash_fwd":
        return 4 * D * pairs, 2 * qb + 2 * kb + rows
    if kind == "flash_bwd_dq":
        return 6 * D * pairs, 3 * qb + 2 * kb + 2 * rows
    return 8 * D * pairs, 2 * qb + 4 * kb + 2 * rows


def flash_bound(kind, q, k, causal):
    """Least time of one call: its bytes over the HBM rate, or its flops
    over the f32 (f32 inputs) or bf16 (bf16 inputs: their products are
    exact in f32, as on the tensor cores) peak; the larger."""
    flops, nbytes = flash_work(kind, q, k, causal)
    peak = F32_FLOPS_PER_S if q.element_size() == 4 else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def elem_err(a, b):
    """The per-element reading of FLASH_ELEM_TOL: the largest |a - b| /
    (|b| + rms(b)), the rms over each row of ``b`` (its head dim), at
    least 1/64 of the rms of the row's (batch, head) slice."""
    import torch
    a, b = a.float(), b.float()
    sq = b.pow(2)
    rms = torch.maximum(sq.mean(dim=-1, keepdim=True),
                        sq.mean(dim=(-2, -1), keepdim=True) / 64 ** 2).sqrt()
    return ((a - b).abs() / (b.abs() + rms).clamp_min(1e-30)).max().item()


def flash_run(dev, B, H, Sq, Sk, D, dtype, causal, pos_delta=None, seed=0):
    """K3 and K4 and their plain versions on the same inputs; returns
    ``{output: (kernel's, plain)}`` and the inputs."""
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
    return got, (q, k, v, g, out, lse, scale)


def flash_readings(got, name):
    """Each output's readings for both gates, and what fails them as
    ``(gate, message)``: ``max_abs_err`` against FLASH_TOL x max(1,
    max|ref|) (lse always at the f32 limit, over the rows not fully
    masked), ``elem_err`` against FLASH_ELEM_TOL (out, dq, dk, dv)."""
    import torch
    errs, elem, failed = {}, {}, []
    for what, (a, b) in got.items():
        t = FLASH_TOL[name] if what != "lse" else FLASH_TOL["float32"]
        if a.dtype != b.dtype or a.shape != b.shape:
            failed.append(("FLASH_TOL", f"{what}: {a.dtype} {tuple(a.shape)}"
                           f" against {b.dtype} {tuple(b.shape)}"))
            continue
        if what != "lse":
            elem[what] = elem_err(a, b)
            if not elem[what] <= FLASH_ELEM_TOL[name]:
                failed.append(("FLASH_ELEM_TOL", f"{what}: per-element "
                               f"reading {elem[what]:.4g} (tolerance "
                               f"{FLASH_ELEM_TOL[name]})"))
        a, b = a.float(), b.float()
        if what == "lse":
            # a fully masked row (pos_delta) has lse -1e30 on both sides;
            # the tolerance is taken over the other rows
            live = b > -1e29
            if not bool((a[~live] <= -1e29).all()):
                failed.append(("FLASH_TOL",
                               "lse: a fully masked row has a finite lse"))
            a, b = a[live], b[live]
        ref = max(1.0, b.abs().max().item()) if b.numel() else 1.0
        errs[what] = (a - b).abs().max().item() if b.numel() else 0.0
        if not (torch.isfinite(a).all().item() and errs[what] <= t * ref):
            failed.append(("FLASH_TOL", f"{what}: max_abs_err {errs[what]} "
                           f"(tolerance {t} x {ref})"))
    return errs, elem, failed


def flash_case(dev, B, H, Sq, Sk, D, dtype, causal, pos_delta=None, seed=0):
    """K3 and K4 against their plain versions on the same inputs, at both
    gates; returns the record and the inputs."""
    name = str(dtype).split(".")[-1]
    got, inputs = flash_run(dev, B, H, Sq, Sk, D, dtype, causal, pos_delta,
                            seed)
    errs, elem, failed = flash_readings(got, name)
    check(not failed, f"flash B{B} H{H} Sq{Sq} Sk{Sk} D{D} {name} "
          f"causal={causal} pos_delta={pos_delta} differs from the plain "
          f"version: " + "; ".join(m for _, m in failed))
    tol = FLASH_TOL[name]
    rec = {"shape": [B, H, Sq, Sk, D], "dtype": name, "causal": causal,
           "pos_delta": pos_delta, "max_abs_err": errs, "tolerance": tol,
           "elem_err": elem, "elem_tolerance": FLASH_ELEM_TOL[name]}
    print(f"kernel flash B{B} H{H} Sq{Sq} Sk{Sk} D{D} {name} causal={causal}"
          f" pos_delta={pos_delta}: max_abs_err "
          + " ".join(f"{w}={e:.3g}" for w, e in errs.items())
          + f" (tolerance {tol} x max(1, max|ref|)); per element "
          + " ".join(f"{w}={e:.3g}" for w, e in elem.items())
          + f" (tolerance {FLASH_ELEM_TOL[name]})", flush=True)
    return rec, inputs


def flash_timings(dtype, inputs, causal):
    """Per-call ms of K3, K4-dQ and K4-dKV (CUDA events and device time),
    the plain versions, the bounds and SDPA's forward and backward: the
    device time of the kernels of each, with the backend they belong to
    named by those kernels, and the time of the call with its host work."""
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

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              scale=scale)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (ql, kl, vl), g,
                                   retain_graph=True)
    name = str(dtype).split(".")[-1]
    lib = {}
    for what, fn in (("forward", lib_fwd), ("backward", lib_bwd)):
        per_kernel = device_kernels(fn)
        kernels = sorted(per_kernel, key=per_kernel.get, reverse=True)
        dms = sum(per_kernel.values())
        lib[what] = {"ms": dms, "call_ms": time_ms(fn), "kernels": kernels}
        print(f"library {name} scaled_dot_product_attention {what}: "
              f"{dms:.4f} ms on the device ({lib[what]['call_ms']:.4f} ms "
              f"per call with its host work); kernels: "
              + "; ".join(n[:90] for n in kernels), flush=True)
    if name == "float32":
        lib["backward"]["rounds"] = yardstick_rounds(lib_bwd, calls)
        lib["backward"]["ms"] = lib["backward"]["rounds"]["sdpa_median"]
    recs = {}
    for kind, fn in calls.items():
        bms, by = flash_bound(kind, q, k, causal)
        flops, _ = flash_work(kind, q, k, causal)
        fwd = kind == "flash_fwd"
        lw = lib["forward" if fwd else "backward"]
        recs[kind] = {"dtype": name, "shape": list(q.shape), "causal": causal,
                      "ms": time_ms(fn),
                      "device_ms": device_ms(fn,
                                             FLASH_KERNEL_NAME[name][kind]),
                      "kernel": FLASH_KERNEL_NAME[name][kind],
                      "plain_ms": plain_fwd if fwd else plain_bwd,
                      "plain_note": None if fwd else
                      "the whole plain backward (dq, dk and dv)",
                      "bound_ms": bms, "bound_by": by,
                      "library_ms": lw["ms"],
                      "library_call_ms": lw["call_ms"],
                      "library_kernels": lw["kernels"],
                      "library": "scaled_dot_product_attention forward"
                      if fwd else "scaled_dot_product_attention backward "
                      "through autograd (dq, dk and dv)",
                      "library_note": "device time of the library call's "
                      "kernels (torch.profiler); library_call_ms adds its "
                      "host work"}
        r = recs[kind]
        r["tflops"] = flops / (r["device_ms"] * 1e-3) / 1e12
        r["bound_share"] = bms / r["device_ms"]
        print(f"kernel {kind} {name} {tuple(q.shape)} causal={causal}: "
              f"kernel_ms={r['ms']:.4f} (device {r['device_ms']:.4f}, "
              f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the "
              f"bound) plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={bms:.4f} ({by}) library_ms={r['library_ms']:.4f} "
              f"({r['library']}, device)", flush=True)
    return recs


def yardstick_rounds(lib_bwd, calls, rounds=YARDSTICK_ROUNDS):
    """SDPA's backward and K4 (dQ + dK/dV), device time of their kernels,
    in alternation over ``rounds`` rounds (SDPA first in even rounds, K4
    first in odd ones): each one's readings, median and spread."""
    import statistics
    sdpa, k4 = [], []

    def k4_ms():
        return (device_ms(calls["flash_bwd_dq"],
                          FLASH_KERNEL_NAME["float32"]["flash_bwd_dq"])
                + device_ms(calls["flash_bwd_dkv"],
                            FLASH_KERNEL_NAME["float32"]["flash_bwd_dkv"]))
    for r in range(rounds):
        for which in (("sdpa", "k4") if r % 2 == 0 else ("k4", "sdpa")):
            if which == "sdpa":
                sdpa.append(sum(device_kernels(lib_bwd).values()))
            else:
                k4.append(k4_ms())
    out = {"sdpa": sdpa, "k4": k4,
           "sdpa_median": statistics.median(sdpa),
           "k4_median": statistics.median(k4),
           "sdpa_spread": max(sdpa) - min(sdpa),
           "k4_spread": max(k4) - min(k4)}
    print(f"yardstick float32 backward over {rounds} alternating rounds, "
          f"device ms: SDPA median {out['sdpa_median']:.4f} spread "
          f"{out['sdpa_spread']:.4f} ({' '.join(f'{x:.4f}' for x in sdpa)});"
          f" K4 (dQ + dK/dV) median {out['k4_median']:.4f} spread "
          f"{out['k4_spread']:.4f} ({' '.join(f'{x:.4f}' for x in k4)}); "
          f"K4 / SDPA {out['k4_median'] / out['sdpa_median']:.3f}",
          flush=True)
    return out


def flash_hmma_counts():
    """HMMA (tensor-core) instructions of each flash-attention kernel in
    the built library, by kernel and head-dim bucket, from ``cuobjdump
    --dump-sass``: every bf16 kernel must have them, no f32 kernel any."""
    import re
    from singa_tpu_torch import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [tool, "--dump-sass",
         str(cuda_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"\d(flash_\w+?_kernel)I\S*?Li(\d+)E", line)
            fn = f"{m.group(1)}<{m.group(2)}>" if m else None
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    for want in FLASH_KERNEL_NAME["bfloat16"].values():
        check(any(n.startswith(want + "<") for n in counts),
              f"the flash library has no {want}: {sorted(counts)}")
    for name, n in counts.items():
        check((n > 0) == ("_mma_" in name),
              f"{name} has {n} HMMA instructions")
    print("sass HMMA instructions per flash kernel: "
          + " ".join(f"{k}={v}" for k, v in sorted(counts.items())),
          flush=True)
    return counts


def flash_f32_resources():
    """Registers and local memory per thread (``cudaFuncGetAttributes``)
    and dynamic shared memory per block of each f32 flash kernel instance
    (K3, K4-dQ, K4-dKV at DMAX 64, 128, 256); local memory means spills,
    and none may have it."""
    import ctypes
    from singa_tpu_torch import cuda_build
    fn = cuda_build.load("flash_attention").singa_flash_f32_resources
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    res = {}
    for which, kind in enumerate(FLASH_KERNEL_NAME["float32"].values()):
        for dmax in (64, 128, 256):
            out = (ctypes.c_int * 3)()
            err = fn(which, dmax, out)
            check(err == 0, f"cudaFuncGetAttributes of {kind}<{dmax}>: "
                  f"CUDA error {err}")
            res[f"{kind}<{dmax}>"] = {"registers": out[0],
                                      "local_bytes": out[1],
                                      "smem_bytes": out[2]}
    print("f32 flash kernels (registers / local bytes / dynamic shared "
          "bytes): " + " ".join(f"{n}={r['registers']}/{r['local_bytes']}/"
                                f"{r['smem_bytes']}"
                                for n, r in res.items()), flush=True)
    spilled = [n for n, r in res.items() if r["local_bytes"]]
    check(not spilled, f"f32 flash kernels with local memory: {spilled}")
    return res


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
        cases.append(flash_case(dev, 2, 4, 333, 333, 30, dtype, True,
                                seed=3)[0])
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(flash_case(dev, B, H, S, S, D, dtype, True,
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


def lm_model(dev, tx, compute_dtype=None, train=True, use_graph=False):
    """The LM at ``LM_SHAPE``; eager unless ``use_graph`` (the phases
    that count launches per step run it eagerly)."""
    from singa_tpu_torch.models import transformer
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=LM["layers"], max_len=LM["seq"], tp=False,
        fused_head_chunk=8192, compute_dtype=compute_dtype)
    m.compile([tx], is_train=train, use_graph=use_graph)
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


def lm_train_run(model, start, tx, ty, steps, per_tensor_update=False):
    """``steps`` SGD steps from ``start`` with a fresh fused optimizer; the
    launch counts are zeroed just before and read just after. Returns the
    losses, the step times (CUDA events), the launches, the peak device
    memory and the host time of each step's update (ms).
    ``per_tensor_update``: the earlier design (:func:`per_tensor`)."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.ops import fused_optim as fo
    load_numpy_states(model, start)
    sgd = opt.SGD(lr=0.1, momentum=0.9, fused=True)
    if per_tensor_update:
        per_tensor(sgd)
    model.set_optimizer(sgd)
    update_ms = timed_updates(sgd)
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
    counts = dict(flash_counts(), sgd_multi=fo.launches["sgd_multi"],
                  sgd=fo.launches["sgd"],
                  other_optim=sum(v for k, v in fo.launches.items()
                                  if k not in ("sgd_multi", "sgd")))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    model.eval()
    return ([float(v) for v in losses],
            [b.elapsed_time(e) for b, e in events], counts, peak, update_ms)


def lm_bf16_readings(losses, plain_losses, after, plain, start):
    """A bf16 LM run through K3/K4 against the same steps with the plain
    attention: the final loss and the loss decrease, relative, within
    LM_BF16_LOSS_TOL; for each parameter tensor, the update over the run
    (``after`` against ``start``, the plain run's: ``plain``; both
    ``{name: tensor}``), |upd - upd_plain| / max(|upd_plain|,
    LM_BF16_UPDATE_FLOOR x |start|), within LM_BF16_UPDATE_TOL. Returns
    the readings and the gates they fail."""
    import numpy as np
    import torch
    upd, size = {}, {}
    for k, p in plain.items():
        s0 = torch.as_tensor(start[k], device=p.device).to(p.dtype).float()
        mine, ref = after[k].float() - s0, p.float() - s0
        size[k] = (ref.norm() / s0.norm()).item()
        upd[k] = ((mine - ref).norm() / max(
            ref.norm().item(), LM_BF16_UPDATE_FLOOR * s0.norm().item())
        ).item()
    worst = max(upd, key=upd.get)
    dec, p_dec = losses[0] - losses[-1], plain_losses[0] - plain_losses[-1]
    r = {"final_loss_rel": abs(losses[-1] - plain_losses[-1])
         / abs(plain_losses[-1]),
         "decrease": dec, "plain_decrease": p_dec,
         "decrease_rel": abs(dec - p_dec) / abs(p_dec),
         "update_rel": upd, "update_size": size,
         "update_rel_max": upd[worst],
         "update_rel_at": worst}
    failed = []
    for what in ("final_loss_rel", "decrease_rel"):
        if not (np.isfinite(r[what]) and r[what] <= LM_BF16_LOSS_TOL):
            failed.append(f"{what} {r[what]:.4g} (tolerance "
                          f"{LM_BF16_LOSS_TOL}; losses {losses} against "
                          f"{plain_losses})")
    bad = sorted(k for k, e in upd.items() if not e <= LM_BF16_UPDATE_TOL)
    if bad:
        failed.append(f"parameter updates differ by more than "
                      f"{LM_BF16_UPDATE_TOL} (relative) in {len(bad)} "
                      f"tensors: " + ", ".join(f"{k}={upd[k]:.3g}"
                                               for k in bad[:8]))
    return r, failed


def lm_train_phase(dev, tx, ty, start):
    """LM_STEPS f32 steps through K3/K4/K1, the same steps with the plain
    attention, then LM_BF16_STEPS under compute_dtype=bfloat16."""
    import numpy as np
    import torch
    from singa_tpu_torch.ops import attention as at
    m = lm_model(dev, tx)
    losses, times, counts, peak, upd = lm_train_run(m, start, tx, ty,
                                                    LM_STEPS)
    mine = {k: v.data.detach().clone() for k, v in m.get_params().items()}
    at.USE_PLAIN = True
    try:
        p_losses, p_times, p_counts, p_peak, _ = lm_train_run(
            m, start, tx, ty, LM_STEPS)
    finally:
        at.USE_PLAIN = False
    per_step = {"flash_fwd": LM["layers"], "flash_bwd_dq": LM["layers"],
                "flash_bwd_dkv": LM["layers"],
                "sgd_multi": multi_chunks("sgd_multi", LM_PARAMS_PER_STEP),
                "sgd": 0, "other_optim": 0}
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
           "update_host_p50_ms": float(np.percentile(
               upd[LM_TIMED_FROM:], 50)), "update_host_ms": upd,
           "peak_device_bytes": peak,
           "plain_tokens_per_s": toks * len(pt) / (pt.sum() / 1e3),
           "plain_step_p50_ms": float(np.percentile(pt, 50)),
           "plain_peak_device_bytes": p_peak}
    print(f"train LM f32 B{LM['batch']} S{LM['seq']} SGD x{LM_STEPS} (timed "
          f"from step {LM_TIMED_FROM}): tokens/s={rec['tokens_per_s']:.0f} "
          f"(plain attention {rec['plain_tokens_per_s']:.0f}) step p50="
          f"{rec['step_p50_ms']:.2f} ms p99={rec['step_p99_ms']:.2f} ms "
          f"(plain p50 {rec['plain_step_p50_ms']:.2f} ms) update host p50="
          f"{rec['update_host_p50_ms']:.3f} ms peak="
          f"{peak / 2**30:.2f} GiB (plain {p_peak / 2**30:.2f} GiB) "
          f"launches/step={rec['launches_per_step']} max param rel diff "
          f"vs plain={rel[worst]:.3g} ({worst}; tolerance {LM_PARAM_TOL})",
          flush=True)
    print("train LM losses: " + " ".join(f"{v:.6f}" for v in losses)
          + " | plain: " + " ".join(f"{v:.6f}" for v in p_losses),
          flush=True)
    del m, mine
    torch.cuda.empty_cache()

    # bf16: the multi-tensor update, then the earlier per-tensor one from
    # the same start on the same model
    mb = lm_model(dev, tx, torch.bfloat16)
    bf = {}
    for name, per in (("multi", False), ("per_tensor", True)):
        b_losses, b_times, b_counts, b_peak, b_upd = lm_train_run(
            mb, start, tx, ty, LM_BF16_STEPS, per_tensor_update=per)
        want_b = {k: v * LM_BF16_STEPS for k, v in per_step.items()}
        if per:
            want_b.update(sgd_multi=0, sgd=LM_PARAMS_PER_STEP * LM_BF16_STEPS)
        check(b_counts == want_b, f"LM train bf16 {name}: launches "
              f"{b_counts}, expected {want_b}")
        check(all(np.isfinite(b_losses)) and b_losses[-1] < b_losses[0],
              f"LM train bf16 {name}: loss not finite or not falling: "
              f"{b_losses}")
        bt = np.asarray(b_times[LM_TIMED_FROM:])
        bf[name] = {"steps": LM_BF16_STEPS, "losses": b_losses,
                    "step_ms": b_times, "launches": b_counts,
                    "step_p50_ms": float(np.percentile(bt, 50)),
                    "step_p99_ms": float(np.percentile(bt, 99)),
                    "tokens_per_s": toks * len(bt) / (bt.sum() / 1e3),
                    "update_host_ms": b_upd, "update_host_p50_ms":
                    float(np.percentile(b_upd[LM_TIMED_FROM:], 50)),
                    "peak_device_bytes": b_peak}
        if not per:
            after = {k: v.data.detach().clone()
                     for k, v in mb.get_params().items()}
        print(f"train LM bf16 {name} update x{LM_BF16_STEPS} (timed from "
              f"step {LM_TIMED_FROM}): step p50="
              f"{bf[name]['step_p50_ms']:.2f} ms p99="
              f"{bf[name]['step_p99_ms']:.2f} ms tokens/s="
              f"{bf[name]['tokens_per_s']:.0f} update host p50="
              f"{bf[name]['update_host_p50_ms']:.3f} ms; losses "
              + " ".join(f"{v:.6f}" for v in b_losses)
              + " step ms " + " ".join(f"{v:.1f}" for v in b_times)
              + f" launches={b_counts} peak={b_peak / 2**30:.2f} GiB",
              flush=True)
    brel = max(((after[k].float() - v.data.detach().float()).norm()
                / v.data.detach().float().norm()).item()
               for k, v in mb.get_params().items())
    check(brel <= LM_PARAM_TOL,
          f"LM train bf16: the multi-tensor and the per-tensor update differ "
          f"by {brel} (relative) after {LM_BF16_STEPS} steps")
    # the same bf16 steps with the plain attention: the run through the
    # tensor-core K3/K4 is held to it by lm_bf16_readings
    at.USE_PLAIN = True
    try:
        pb_losses, pb_times, pb_counts, _, _ = lm_train_run(
            mb, start, tx, ty, LM_BF16_STEPS)
    finally:
        at.USE_PLAIN = False
    check(pb_counts["flash_fwd"] + pb_counts["flash_bwd_dq"]
          + pb_counts["flash_bwd_dkv"] == 0,
          f"LM train bf16: the plain run launched {pb_counts}")
    against, failed = lm_bf16_readings(
        bf["multi"]["losses"], pb_losses, after,
        {k: v.data.detach() for k, v in mb.get_params().items()}, start)
    check(not failed, "LM train bf16 through K3/K4 against the plain "
          "attention: " + "; ".join(failed))
    pbt = np.asarray(pb_times[LM_TIMED_FROM:])
    rec["bf16"] = dict(bf["multi"], per_tensor=bf["per_tensor"],
                       max_param_rel_diff_vs_per_tensor=brel,
                       plain_losses=pb_losses, plain_step_ms=pb_times,
                       plain_step_p50_ms=float(np.percentile(pbt, 50)),
                       against_plain=against,
                       loss_tolerance=LM_BF16_LOSS_TOL,
                       update_tolerance=LM_BF16_UPDATE_TOL)
    print(f"train LM bf16: multi-tensor against per-tensor update, max "
          f"param rel diff {brel:.3g}", flush=True)
    print("train LM bf16 losses, K3/K4: "
          + " ".join(f"{v:.6f}" for v in bf["multi"]["losses"])
          + " | plain attention: " + " ".join(f"{v:.6f}" for v in pb_losses)
          + f" | final loss rel diff {against['final_loss_rel']:.3g}, "
          f"loss decrease rel diff {against['decrease_rel']:.3g} (tolerance "
          f"{LM_BF16_LOSS_TOL}); parameter updates rel diff max "
          f"{against['update_rel_max']:.3g} ({against['update_rel_at']}; "
          f"tolerance {LM_BF16_UPDATE_TOL}); plain step p50 "
          f"{rec['bf16']['plain_step_p50_ms']:.2f} ms", flush=True)
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
    others = other_optimizers_phase(dev, models, tx, ty, start,
                                    eval_inputs)
    bf16 = bf16_train_phase(dev, models, tx, ty, start, train, eval_inputs)
    graph_train = graph_train_phase(dev, models, tx, ty, start)
    del models, tx, ty, start
    torch.cuda.empty_cache()
    graph_serve = graph_serve_phase(dev)
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    flash_hmma = flash_hmma_counts()
    flash_res = flash_f32_resources()
    flash_cases, flash_times = flash_kernel_phase(dev)
    lm_tx, lm_ty = lm_data(dev)
    lm_start = lm_states(lm_model(dev, lm_tx, train=False), SEED + 4)
    lm_eval = lm_eval_phase(dev, lm_tx, lm_start)
    lm_train = lm_train_phase(dev, lm_tx, lm_ty, lm_start)
    graph_lm = graph_lm_phase(dev, lm_tx, lm_ty, lm_start)

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
            "launches_per_replay": run["launches_per_replay"][c["name"]],
            "replays": run["replays"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None})
    # launches of each optimizer kernel on the path that drives it: the
    # fused training steps (the multi-tensor kernels), the BN-only
    # Optimizer.apply loops (the per-tensor ones)
    launches = {"sgd": evaluated["bn_only_k1_launches"],
                "sgd_multi": train["k1_launches"]}
    for kind in ("adam", "rmsprop", "adagrad"):
        launches[kind] = others[f"{kind}_bn_only"]["launches"]
        launches[f"{kind}_multi"] = others[kind]["launches"]
    # the graphed steps: the multi-tensor launches counted in the trace of
    # replayed steps (K1 in f32; K1 and K5 under bf16_mixed, with the flag)
    replayed = {"sgd_multi": graph_train["float32"]["sgd_multi"],
                "sgd_multi_flag": graph_train["bf16_mixed"]["sgd_multi"],
                "adam_multi_flag":
                graph_train["adam_bf16_mixed"]["adam_multi"]}
    for kind, n in launches.items():
        step = optim_steps[kind]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": "singa_tpu_torch/csrc/fused_optim.cu",
            "replaces": REPLACES[kind], "launches": n,
            **replayed.get(kind, {}),
            "max_abs_err": max(c["max_abs_err"] for c in optim_cases
                               if c["name"].replace("_nesterov", "")
                               == kind and not c.get("flag")),
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": step["library_ms"]})
    # the same multi-tensor kernels with a guarded step's skip flag:
    # launches from the bf16_mixed runs, ms with ok = 1 (ms_ok0: skipped)
    flagged = {"sgd_multi": bf16["k1_launches"]}
    flagged.update({f"{k}_multi": v["launches"]
                    for k, v in bf16["other"].items()})
    for kind, n in flagged.items():
        step = optim_steps[f"{kind}_flag"]
        kernels.append({
            "name": f"{kind}_flag", "route": "cuda",
            "source": "singa_tpu_torch/csrc/fused_optim.cu",
            "replaces": REPLACES[kind], "launches": n,
            **replayed.get(f"{kind}_flag", {}),
            "max_abs_err": max(c["max_abs_err"] for c in optim_cases
                               if c.get("flag") and
                               c["name"].replace("_nesterov", "") == kind),
            "ms": step["ms_ok1"], "ms_ok0": step["ms_ok0"],
            "device_ms_ok1": step["device_ms_ok1"],
            "device_ms_ok0": step["device_ms_ok0"],
            "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"],
            "library_ms": step["library_ms"]})
    # K3/K4: the causal timings at the LM's shape, in f32 (launches from the
    # f32 LM training run) and in bf16 (from the bf16 run with the
    # multi-tensor update), the largest error over every case of the dtype;
    # ms is CUDA-event time, library_ms SDPA's device time (device_ms, the
    # kernel's own device time, is in flash_timings of the full record)
    outputs = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
               "flash_bwd_dkv": ("dk", "dv")}
    for dname, suffix, run in (("float32", "", lm_train),
                               ("bfloat16", "_bf16", lm_train["bf16"])):
        g = graph_lm[dname]
        for kname, t in flash_times[dname].items():
            errs = [c["max_abs_err"][w] for c in flash_cases
                    if c["dtype"] == dname
                    for w in outputs[kname] if w in c["max_abs_err"]]
            kernels.append({
                "name": kname + suffix, "route": "cuda",
                "source": "singa_tpu_torch/csrc/flash_attention.cu",
                "replaces": REPLACES[kname + suffix],
                "launches": run["launches"][kname],
                **g["replayed"][kname],
                "max_abs_err": max(errs), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kind = torch.cuda.get_device_name(0)
    record = {"card": card, "torch": torch.__version__, "build_s": build_s,
              "kernel_cases": cases, "serve_runs": runs,
              "optim_kernel_cases": optim_cases,
              "optim_steps": optim_steps, "train": train,
              "eval_after_training": evaluated, "train_other": others,
              "train_bf16_mixed": bf16,
              "flash_cases": flash_cases, "flash_timings": flash_times,
              "flash_sass_hmma": flash_hmma,
              "flash_f32_resources": flash_res,
              "lm_eval": lm_eval, "lm_train": lm_train,
              "graph_train": graph_train, "graph_serve": graph_serve,
              "graph_lm": graph_lm, "kernels": kernels}
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
