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
   steps counting K3's and K4's 6 launches each and K1's 2 per step;
13. zoo train (after phase 8d, cuDNN deterministic): the other models of
   ``train_cnn.py``, graphed as the example compiles them: Xception (3x299,
   b32), AlexNet (3x224, b32, dropout on), the CNN (1x28x28, b64) and the
   MLP (784, b64), weights from a numpy seed, ``SGD(lr=0.01,
   momentum=0.9, weight_decay=1e-5)``, 6 steps on one fixed batch, f32
   and bf16_mixed: eager fused twice (run to run), eager unfused and
   graphed, the device generator seeded the same for each (dropout):
   fused against unfused and graph against eager bitwise where run to run
   is, else within 4x the run-to-run difference; one capture; K1-multi's
   launches per step on the host and in the trace of 3 replays; no
   synchronizing call in a replay; a captured dropout bitwise with the
   eager one, two replays drawing different masks; step p50/p99 and img/s
   of graph and eager in 3 alternating rounds of 4 steps, peak memory
   above the start and the idle share of the traced replays;
14. pure bf16 train: ``train_cnn.py -p bfloat16`` (the input cast to
   bf16, no policy) on ResNet-50 (3x224) and Xception (3x299) at b32,
   lr 1e-3: K1-multi on the bf16 parameters and momenta held bitwise
   against the plain multi-tensor version on clones of the same tensors
   at each of 12 eager steps, graph against eager as in phase 13, the
   losses finite and falling, the same readings;
15. xception serve: Xception (299 px) b32 through ``compile_serving`` ->
   ``BatchServingEngine``, 96 requests, f32 and bf16_mixed, K2 against
   the unfused path under phase 4's gates, 24 K2a and 11 K2c launches per
   replayed tick counted in the trace; tick p50/p99 and img/s;
16. s2d stem: the ResNet-50 stem conv (b32) in its ``space_to_depth``
   form against the plain 7x7/s2 conv on the same weights, NCHW and
   NHWC (f32 within 1e-4, bf16 within 2e-2, times max |y|), both timed;
   then ResNet-50 b32 with each stem, NCHW and NHWC, f32 and bf16_mixed,
   12 graphed fused-SGD steps each from the same start (one capture, the
   first losses agreeing), the two stems timed in 3 alternating rounds of
   4 steps: step p50/p99, img/s, peak memory above the start;
17. dist: (a) ResNet-50 b32 through ``opt.DistOpt`` (the SGD of phase 6,
   fused) over NCCL at world 1 on the card, graphed (the collectives
   captured with the step), 6 steps from the training phases' start,
   cuDNN deterministic, in nine cases, each bitwise (losses and every
   state) with the same graphed steps through its plain version: per
   gradient and in 25 MiB buckets against the plain SGD; under
   bf16_mixed (the guard over the DistOpt, step 6 poisoned, a no-op under
   replay), per gradient and bucketed, against the guarded SGD with each
   gradient rounded through bf16 (the wire's plain version); ``half``
   against SGD fed ``g.to(bfloat16).float()``; ``partialUpdate`` with
   rotation 0 and traced against the plain SGD; ``sparseTopK`` (0.05)
   and ``sparseThreshold`` (1e-3) against the same error-feedback
   sparsification in plain PyTorch (the top-k cut from a sort), the
   residuals included; one capture and K1-multi's launches at the eager
   call and the capture only; the collectives each step starts (host
   calls), and for the per-gradient and bucketed cases the NCCL kernels
   and K1-multi's launches in the trace of 3 replays and the step p50
   against the plain SGD's in 5 alternating rounds; (b) two processes of
   this script (``--dist-rank``) on the one card joined over gloo (NCCL
   refuses two ranks on one device), eager, each on its half of every
   batch: the CNN (b64) under all six options, the replicas' fingerprints
   bitwise equal after every step (under partialUpdate unequal after the
   first, by design) and the losses equal on the ranks; graph mode over
   gloo refused; ResNet-50 b32 (16 a rank, sync-BN, lr 1e-3) 3 steps,
   the ranks bitwise equal; in f32 the first loss and every state after
   the first step within ``tests/test_torch_resnet_training.py``'s
   bounds of one rank's whole-batch run here (f32 summation-order noise
   grows past them over later steps), and the same 3 steps with every
   state and the batch in f64, each loss and state within 1e-9 of the
   f64 whole-batch run's;
18. fsdp: (a) ResNet-50 b32 (the SGD of phase 6, fused) under the train
   mesh and ZeRO/FSDP over NCCL at world 1 on the card, graphed (the
   gathers and scatters captured with the step), 3 steps from the
   training phases' start, cuDNN deterministic, in four cases: f32 and
   bf16_mixed, each under ``compile(mesh=train_mesh(data=1),
   fsdp_axis="data")`` with the plain SGD and under
   ``DistOpt(zero=True)``; each bitwise (losses, every state and momentum)
   with the plain graphed step (under bf16_mixed the guarded SGD with each
   gradient rounded through bf16, the wire's plain version); one capture,
   K1-multi's launches at the eager call and the capture only; the
   collectives each step starts by kind (a gather and a scatter per
   parameter); for the first spelling of each precision the NCCL kernels
   and K1-multi's launches in the trace of 3 replays and the step p50/p99
   against the plain step's in 5 alternating rounds; in f32 the bytes a
   rank holds of its states and on the card between steps and at the
   peak, FSDP and plain, graphed and eager; (b) two processes of this
   script (``--zero-rank``) on the one card over gloo, eager, each on its
   half of every batch: the CNN (b64, 3 steps) and ResNet-50 (b32, 16 a
   rank, lr 1e-3, 2 steps) under ``DistOpt(zero=True)`` bitwise (losses,
   every state and momentum, gathered) with the plain ``DistOpt``, a
   rank's state bytes at most 0.55 of a replicated rank's; the ZeRO
   ResNet-50's archive (``save_states``: rank 0 writes) equal to a
   replicated rank's, restored into a fresh ZeRO model on both ranks
   bitwise.
19. imagenet zoo (cuDNN deterministic, TF32 off): every public function
   of the port's ``autograd`` (the tape helpers and the two that raise
   aside), forward and backward on CUDA tensors against the same call on
   CPU tensors, ConvTranspose NCHW and NHWC among them, each output and
   gradient within 1e-5 of its largest value; then VGG-16-BN, SqueezeNet
   1.1, MobileNetV2 1.0, DenseNet-121 and ShuffleNetV2 1.0 at full width
   (224 px, b32, 10 classes, weights and BN statistics from a numpy
   seed): 6 steps each of ``SGD(lr=0.01, momentum=0.9,
   weight_decay=1e-5)`` on one fixed batch, f32, held as phase 13 holds
   its models (fused against unfused and graph against eager, one capture,
   K1-multi's launches per replay in the trace, losses finite; step
   p50/p99 and img/s of graph and eager in 2 alternating rounds of 3
   steps, peak memory above the start); then 32 requests each through
   ``compile_serving(batch=32)``, f32 and bf16_mixed, under phase 4's
   gates against the unfused path, K2's launches per replayed tick
   counted in the trace and held to one per frozen-BN -> ReLU pair (13,
   0, 0, 121, 37), tick p50/p99, img/s and K2's share of the traced
   tick's device time.
20. image files (cuDNN deterministic, TF32 off): 256 seeded RGB JPEGs
   of 256 px, 10 classes and a list file in a temporary directory;
   ``data.ImageBatchIter`` (a thread worker, shuffled, seed 0, a random
   224 crop and flip by ``image_tool.ImageTool`` from the stdlib
   ``random`` seeded per file) through ``data.DevicePrefetcher(depth=2)``
   (pinned buffers, copies on a side stream, an event per batch) feeds 6
   graphed ``SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)`` steps of
   ResNet-50 (224 px, b32, f32, weights from a numpy seed). Gates: the
   losses and every state bitwise with the same model fed the very numpy
   batches the iterator yielded, as Tensors made directly (K1-multi: 2
   host launches at the eager call and 2 at the capture); a resume from
   the state after step 3 yields batches 4-6 bitwise; a forked worker
   (``use_process=True``) yields the thread worker's batches; in a
   ``torch.profiler`` trace of 4 pipeline-fed replays every batch copy
   runs on a stream other than the step's and reads pinned memory, and
   K1-multi launches 2 per replay (none on the host). Readings: the
   iterator's images/s on the host alone (thread and forked worker), step
   p50 fed by the pipeline against fed directly (device ms from one
   step's end to the next, 2 alternating rounds of 8 steps), the idle
   share of the traced replays, and ``singa_tpu_torch/examples/
   benchmark.py``'s throughput at b32 (ResNet-50, 1000 classes, 10
   timed steps);
21. lm mesh (the LM at ``LM_SHAPE`` from seeded weights): (a) 6 graphed
   fused-SGD steps with ``remat=True`` against the same steps without, f32
   and ``compute_dtype=bfloat16``: losses and states bitwise, else the
   LM's gates (phase 12's rule, the reason printed); K3 12 and K4 6
   launches per replay against 6 and 6 (a trace of replays); a net whose
   rematerialised block drops units (``layer.Dropout``) bitwise with the
   plain net, eager and graphed; readings: step p50/p99 in alternating
   rounds, peak memory above the start. (b) ``compile(policy=
   "bf16_mixed")`` with the guarded fused SGD, graphed, 6 steps, the last
   poisoned through the guard's loss scale, set to NaN (an LM's token
   ids carry no NaN), and a bitwise no-op under replay; the first loss within 1e-2 of
   the f32 run's; readings: step p50 against f32, peak memory. (c)
   greedy ``generate`` of 64 tokens from 512-token prompts (b8): each
   step's logits within the LM eval tolerance of the full forward's
   (through K3) at the last position, the tokens its argmax up to each
   row's first step whose top-2 margin is under that tolerance;
   readings: prefill ms, per-token ms p50, tokens/s. The K3 ring reading:
   one ring hop at (8, 8, 512, 64) f32 with ``pos_delta`` 0 and -512
   against its plain version, timed beside its bound over the unmasked
   pairs and SDPA with the equivalent boolean mask. (d) two processes of
   this script (``--lm-rank``) over gloo on the one card, eager, 3 steps
   each of ``tp=2``, ``sp=2`` ring, ``sp=2`` Ulysses and ``tp=2`` with
   the vocab-parallel fused head (``fused_head_chunk=8192``), each held
   against the rank's own dense run of the same batch from the same
   weights: losses within rtol 1e-5, the gathered parameters and the
   momenta within 1e-5 of their norms (a momentum under 1e-2 of the
   largest one's norm, as the key biases' whose gradient is zero up to
   rounding, against that share of the largest); at every step and rank
   K3 2 launches with ``pos_delta`` per attention call (ring) or 1 on the
   full sequence (Ulysses, tp). Its negative control: the ring run again
   with every hop's position delta off by S_local (a causal leak), which
   that gate must refuse. Readings by kind: collectives per step and
   those staged through host memory (gloo takes CUDA tensors for
   all-to-all and sends only through the host).
22. "moe": the Mixture-of-Experts LM, ``LM_SHAPE`` with ``MOE`` (8
   experts of d_ff 2048, top-2, capacity factor 1.25), from seeded
   weights. (a) One MoE layer at T = 8192 tokens on the card against the
   same op in float64 on the CPU, at capacity factors 1.25 and
   ``MOE_DROP_CF`` (which drops at least half the picks): a token whose
   top-3 gates lie ``MOE_MARGIN`` apart that picks other experts fails;
   the card keeps exactly what the capacity rule keeps of its own picks;
   those tokens are held within ``MOE_TOL`` of the largest |y| but the
   ones whose keeps a near tie ahead of them moved; the tokens excluded,
   the picks dropped. (b) 3 graphed f32 steps at ``MOE_DROP_CF`` against
   eager; 6 graphed fused-SGD steps
   against 6 eager, f32 and ``compute_dtype=bfloat16``: bitwise, else the
   LM's gates; routers f32; per replay K3 6, K4 6, K1-multi one launch
   per chunk of each dtype's parameters (a trace of replays, none on the
   host); readings: step p50/p99 in alternating rounds beside the dense
   LM's graphed step, busy ms and idle share of a replay, one MoE layer's
   forward and backward device ms by kind (the experts' ``bmm``,
   dispatch/combine, the router: ``torch.profiler``'s device time per
   ATen op), peak memory above the start. (c) ``remat=True`` bitwise
   with (b)'s f32 run, K3 12 per replay; ``bf16_mixed`` with the guard,
   the routers f32, the poisoned last step a no-op (phase 21 (b)'s
   rule). (d) greedy ``generate`` of 64 tokens after 512, held as phase
   21 (c) against full forwards at the decode's drop-free capacity. (e)
   two processes of this script (``--moe-rank``) over gloo, ``expert=2``
   over ``("data", "expert")``, depth cut to 2 blocks, drop-free
   capacity, 3 eager steps, each held against the rank's dense run of
   the same batch at phase 21 (d)'s bounds; 4 all-to-alls a block and
   step, each staged through host memory. (f) four processes
   (``--tp-fsdp-rank``), ``train_mesh(data=2, model=2)``, the dense LM
   cut to 2 blocks, 3 eager steps with ``fsdp_axis="data"`` against the
   same TP run without FSDP at the same bounds; a rank's state bytes
   against the TP run's, at most ``TP_FSDP_SHARE`` of them.

23. "lm serve": the Transformer LM at ``LM_SHAPE`` (seeded weights)
   served through ``Model.compile_serving(slots=16, max_len=1024,
   prefill_len=512, prefill_batch=4)`` -> ``ServingEngine``, 64 seeded
   requests (prompts of 16-512 tokens, 32-128 new tokens; 48 greedy, 16
   sampled at temperature 0.8 and top-k 50; 16 of the greedy prompts
   share a 256-token prefix), all queued before the engine starts. (a)
   The ring, f32, each program captured into a CUDA graph: every future
   resolves once; each program captured once; every greedy token
   teacher-forced against the uncached eval forward (through K3) on its
   own history, the forward's argmax or within ``SERVE_TOL`` of the
   largest |logit| of its position (near ties counted), and each
   request's first-token logits within that of the forward's; a trace of
   ``SERVE_TRACED_TICKS`` decode ticks holds one ``cudaGraphLaunch`` per
   tick (every tick after a program's first replays it). (b) The same
   requests (the same request ids, so the same draws) through an engine
   with ``use_graph=False``: every tick's logits bitwise those of (a).
   (c) The paged layout (16-token blocks, the default 1024-block pool)
   with ``speculative_k=4``: (a)'s gates; the prefix hits and tokens of
   each prefill batch are those the shared prefix implies (each sharer
   admitted after another was released shares its 16 blocks); all
   blocks free of references after the drain. (d) ``bf16_mixed`` on the
   ring, teacher-forced against the f32 forward within
   ``SERVE_TOL["bf16_mixed"]``. (e) The MoE LM of phase 22 (8 experts,
   top-2, drop-free capacity in the engine and the forward) on the ring,
   16 greedy requests, teacher-forced. The serving path runs none of the
   port's kernels (the JAX serving path reaches no Pallas kernel), which
   the host counters confirm. Readings, printed beside the card's name
   and power limit: TTFT p50/p99, decode tick p50/p99, generated tokens
   per second, prefill tick, the (16, 32000) logits copy, a traced decode
   tick's busy ms, idle share and top device kinds, peak memory, and
   ``TransformerLM.generate``'s ms per token on the same weights, with a
   traced decode step of it (wall, busy, device ops).

Rows of kernels that a graph replays (K2, K1-multi with and without the
flag, K5-multi with the flag, K3/K4) carry ``replays`` and
``launches_per_replay`` beside ``launches``, both from the trace of a
replayed run (K1, K5, K3 and K4 with ``replayed_launches``, the count in
that trace; K2's ``launches`` are its count). K1-multi's row and K2's
NCHW rows also carry ``other_paths_launches_per_replay``: the launches
per replayed step of each phase-13/14 model and per replayed Xception
tick, the launches per replayed step of phase 17's DistOpt runs
and of phase 18's FSDP steps, per replayed step and serving tick of
each phase-19 model, and per replayed step fed from image files (phase
20); K3's and K4's rows the launches per replayed LM step with remat
(phase 21 (a)), per replayed MoE step (phase 22 (b), K1-multi f32
and bf16) and per replayed MoE step with remat (phase 22 (c)). K3's f32
row carries its ring launches per step and
rank (phase 21 (d)), and a ``flash_fwd_ring`` row holds the K3 ring
reading.
Its last lines are the ``{"kernels": [...]}`` record, the
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
# phase 21, the LM on a mesh
LM_MESH_STEPS = 6           # (a) remat and (b) bf16_mixed, graphed
LM_MESH_ROUNDS = 2          # alternating timing rounds of (a) and (b)
LM_MESH_TRACED = 2          # replays traced for the launches per replay
LM_MIXED_LOSS_RTOL = 1e-2   # tests/test_torch_guarded_training.py's LM
GEN_PROMPT, GEN_NEW = 512, 64
LM_RANK_STEPS = 3
# each mesh run against the rank's dense run of the same global batch:
# losses within this rtol, every parameter and momentum within
# LM_RANK_STATE_TOL of its norm (the CPU bounds of
# tests/test_torch_lm_{tp,sp}.py). A key bias's gradient is zero up to
# rounding (softmax is invariant to a constant added to one query's
# scores), so a momentum whose norm is under LM_RANK_FLOOR of the largest
# momentum's is held against that share of the largest instead (the
# gate's three worst tensors of each kind are in the record)
LM_RANK_LOSS_RTOL = 1e-5
LM_RANK_STATE_TOL = 1e-5
LM_RANK_FLOOR = 1e-2
# the gate's negative control: this run again with every ring hop's
# position delta off by S_local (a causal leak), which the gate must fail
LM_RANK_PLANTED = "sp_ring"
# phase 21 (d): name -> the mesh's degrees and the model's settings
LM_RANK_RUNS = {
    "tp": dict(model=2),
    "sp_ring": dict(seq=2, seq_axis="seq", seq_mode="ring"),
    "sp_ulysses": dict(seq=2, seq_axis="seq", seq_mode="ulysses"),
    "tp_fused": dict(model=2, fused_head_chunk=8192),
}
RING_SHAPE = (8, 8, 512, 64)        # one ring hop of the LM at sp=2
RING_DELTAS = (0, -512)
# phase 22, the MoE LM: LM_SHAPE with docs/distributed.md's MoEFFN (8
# experts of d_ff 2048 = 4 d_model, top-2, capacity factor 1.25)
MOE = dict(moe=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_STEPS = 6               # graphed steps (and the eager run held to them)
MOE_ROUNDS = 2              # alternating timing rounds, MoE and dense
MOE_TRACED = 2              # replays traced for the launches per replay
# (a) the layer at T = B S tokens on the card against float64 on the CPU,
# as a fraction of the largest |y|: f32 products of length 512 and 2048
# (TF32 off); a token whose top-(k+1) gates lie within MOE_MARGIN of each
# other may route otherwise in f32 and is not held
MOE_TOL = 1e-4
MOE_MARGIN = 1e-5
# a capacity factor that drops picks: E C = k T / 2 slots for k T picks,
# so at least half drop ((a), and (b)'s graphed steps at this capacity)
MOE_DROP_CF = 0.5
MOE_DROP_STEPS = 3
# (e) expert parallelism: two ranks over ("data", "expert"), drop-free
# capacity (cf = E, so a rank's capacity from its own tokens drops what
# the dense run's drops: nothing), the LM cut to MOE_RANK_LAYERS blocks
MOE_RANK_LAYERS = 2
MOE_RANK_STEPS = 3
# (f) tensor parallelism with FSDP: four ranks, train_mesh(data=2,
# model=2), the dense LM cut to MOE_RANK_LAYERS blocks
TP_FSDP_RANKS = 4
# the most of the TP run's state bytes a rank may hold under FSDP over a
# data degree of 2: half, and a little for the few tensors no dimension
# of which the degree divides
TP_FSDP_SHARE = 0.55
# the rest of train_cnn.py: model -> (one input's shape, batch)
ZOO = {"xceptionnet": ((3, 299, 299), 32), "alexnet": ((3, 224, 224), 32),
       "cnn": ((1, 28, 28), 64), "mlp": ((784,), 64)}
ZOO_LR = 0.01
ZOO_STEPS = 6
ZOO_ROUNDS = 3
ZOO_ROUND_STEPS = 4
ZOO_SEED = 5                # the device generator's seed (dropout) per run
# where the convolutions' backward is not bitwise run to run, fused and
# graph runs are held within this many times the run-to-run difference
DETERMINISM_FACTOR = 4
# phase 19: the full-width ImageNet zoo (name: models module, factory
# keywords, K2 tails per forward: one per frozen-BN -> ReLU pair, as
# tests/test_torch_imagenet_zoo_full.py pins them)
IMAGENET_ZOO = {
    "vgg16bn": ("vgg", {"depth": 16, "batch_norm": True}, 13),
    "squeezenet11": ("squeezenet", {"version": "1.1"}, 0),
    "mobilenetv2": ("mobilenet", {"width_mult": 1.0}, 0),
    "densenet121": ("densenet", {"depth": 121}, 121),
    "shufflenetv2": ("shufflenet", {"width": "1.0"}, 37),
}
IMAGENET_STEPS = 6
IMAGENET_ROUNDS = 2
IMAGENET_ROUND_STEPS = 3
IMAGENET_REQUESTS = 32
OP_TOL = 1e-5               # the op sweep, card against CPU, x max |y|
PURE_BF16_STEPS = 12
# the seeded ResNet-50's loss climbs over its first steps at ZOO_LR, in
# f32 as in bf16; at 1e-3 it falls
PURE_BF16_LR = 1e-3
XCEPTION_SHAPE = (3, 299, 299)
# K2 tails of one Xception forward (tests/test_torch_cnn_zoo.py pins them)
XCEPTION_TAILS = {"affine_relu": 24, "affine_add_relu": 11}
S2D_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
S2D_STEPS = 12
S2D_ROUNDS = 3
S2D_ROUND_STEPS = 4
# data parallelism: ResNet-50 b32 through DistOpt over NCCL at world 1,
# graphed, DIST_STEPS steps per case (step POISON_STEP poisoned under
# bf16_mixed) against the same steps without it; the sparse drivers'
# share and threshold; the buckets' size target
DIST_STEPS = 6
DIST_SPARS = {"sparseTopK": 0.05, "sparseThreshold": 1e-3}
DIST_BUCKET_MB = 25
# then DIST_RANKS gloo ranks on the one card (NCCL refuses two ranks on
# one device), eager: the CNN, one input's shape, global batch and steps,
# under each option; ResNet-50's global batch and steps, with sync-BN
DIST_RANKS = 2
DIST_OPTIONS = ("plain", "half", "fp16", "partialUpdate", "sparseTopK",
                "sparseThreshold")
DIST_CNN = ((1, 28, 28), 64, 3)
DIST_RESNET = (32, 3)
# the gloo ranks' SGD learning rate: at 0.1 the seeded ResNet-50's loss
# climbs 3.0 -> 22 -> 67 over its first steps, and two ranks' and one
# rank's runs drift apart by 0.2-0.9% of the loss there (b32 on the
# card); at 1e-3 it falls (PURE_BF16_LR)
DIST_LR = 1e-3
DIST_RANK_TIMEOUT_S = 300
# two ranks' ResNet-50 against one rank's whole batch. A half batch sums
# its convolutions and moments in another order, and the seeded ResNet-50
# amplifies that in f32: two whole-batch runs that differ only in the
# order of the batch's rows are 1.7% of a norm apart in BN momenta after
# one step and up to 95% after three (b32, H100). So the f32 run is held
# to tests/test_torch_resnet_training.py's bounds (the loss; each
# parameter and running statistic, each momentum: |got - want| <= tol
# |want|, Frobenius norms) after its first step, and the same
# DIST_RESNET steps run again with every state and the batch in f64
# (plain SGD), where the two agree to 1.7e-13 (H100): every loss and
# state of that run is held within DIST_F64_TOL
DIST_LOSS_RTOL, DIST_LOSS_ATOL = 1e-3, 1e-4
DIST_STATE_TOL, DIST_MOMENTUM_TOL = 5e-3, 5e-2
DIST_F64_TOL = 1e-9
# the train mesh and ZeRO/FSDP: ResNet-50 b32 under compile(mesh=
# train_mesh(data=1), fsdp_axis="data") with the plain SGD and under
# DistOpt(zero=True), over NCCL at world 1, graphed, ZERO_STEPS steps per
# case, f32 and bf16_mixed, against the plain graphed step; then
# DIST_RANKS gloo ranks: the CNN (shape, global batch, steps) and
# ResNet-50 (global batch, steps) under DistOpt(zero=True) against the
# plain DistOpt, a rank's state bytes at most ZERO_BYTES_SHARE of a
# replicated rank's
ZERO_STEPS = 3
ZERO_CASES = {"fsdp_axis": (None, "fsdp_axis"), "zero": (None, "zero"),
              "fsdp_axis_bf16_mixed": ("bf16_mixed", "fsdp_axis"),
              "zero_bf16_mixed": ("bf16_mixed", "zero")}
ZERO_CNN = ((1, 28, 28), 64, 3)
ZERO_RESNET = (32, 2)
ZERO_BYTES_SHARE = 0.55
# why an optimizer case has no PyTorch call timed beside it
# a port kernel's name in a profiler trace: ``<name>_kernel<template
# arguments>``, in an anonymous namespace; the launch-counter keys that
# the name (the ``_mma`` of the bf16 flash kernels dropped) may be
# the device ms by port kernel, the busy and the wall ms of the last
# session that profiled() accepted
# phase 20: image files -> card
IMAGE_FILES = 256
IMAGE_SIDE = 256
IMAGE_CROP = 224
IMAGE_CLASSES = 10
IMAGE_SEED = 0
IMAGE_STEPS = 6
IMAGE_RESUME_AT = 3
IMAGE_PREFETCH_DEPTH = 2
IMAGE_QUEUE = 4             # the iterator's queue of decoded batches
IMAGE_ROUNDS = 2
IMAGE_ROUND_STEPS = 8
IMAGE_TRACED = 4
IMAGE_BENCH_ITERS = 10
LAST_PROFILE = {}
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
          registry=None, attempts=5, shape=SHAPE, tails=TAILS_PER_FORWARD):
    """Serve ``inputs`` through a fresh engine, twice. The engine's
    constructor runs one forward of the same path, which warms cuDNN and
    the allocator, and (``use_graph``, the engine's default) captures the
    next in a CUDA graph: every tick is then a replay. The first run is
    timed (``seconds``, and the engine's ``tick`` and ``ttft`` quantiles
    just after it). The second is the counted run: its logits must equal
    the first's bitwise, and it runs under ``torch.profiler``
    (:func:`profiled`), K2's launches counted by kernel name in its trace,
    49 per tick with the epilogue on (``tails``: ResNet-50's
    ``TAILS_PER_FORWARD`` by default, in the model's layout), none with it
    off; ``shape`` is one request's. A replay moves no host counter, so
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
    want = {f"{k}_{lo}": per * ticks for k, per in tails.items()
            } if fused else {}
    with fe.enabled_scope(fused):
        eng = model.compile_serving(input_shape=shape, batch=batch,
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
        (logits, replays), counts, host, _, _, _ = profiled(
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


def train_models(dev, seed=SEED, **kw):
    """Two ResNet-50s (NCHW, 10 classes; ``kw`` such as ``layout`` and
    ``stem`` go to ``resnet50``) from the same numpy-seeded start,
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
        m = resnet.resnet50(num_classes=10, **kw)
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


def same_bits(a, b):
    """``a`` and ``b`` hold the same bits (a NaN equals the same NaN)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def held_equal(a, b, what, nan_ok=()):
    """Every state of model a (and of its optimizer) equals b's bitwise;
    the states named in ``nan_ok`` may hold the same NaN on both sides
    (``same_bits``), every other state must be equal as numbers."""
    import torch
    sa, sb = a.get_states(), b.get_states()
    sa.update(a.optimizer.state_tensor_dict())
    sb.update(b.optimizer.state_tensor_dict())
    check(sorted(sa) == sorted(sb), f"{what}: state names differ")
    same = {k: same_bits if k in nan_ok else torch.equal for k in sa}
    diff = {k: (sa[k].data.float() - sb[k].data.float()).abs().max().item()
            for k in sa if not same[k](sa[k].data, sb[k].data)}
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
    sync): the loss check, the unscale and norm, the BN shadows and the
    bookkeeping, the optimizer update not included. Returns the list the
    times (ms, one per step) go to."""
    times = []
    for name in ("_loss_ok", "_unscale", "_restore_shadows",
                 "_bookkeeping"):
        real = getattr(guard, name)

        def timed(*args, _real=real, _first=name == "_loss_ok"):
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
    trace's counts, the host counts, the device events (ms, count), the
    wall ms of the session and the device kernels whose name holds
    "nccl" (NCCL's collectives), counted."""
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
        counts, busy, ops, nccl, kernel_ms = {}, 0.0, 0, 0, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA \
                    or "spin_kernel" in e.name:
                continue
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            ops += 1
            nccl += "nccl" in e.name.lower()
            key = port_kernel(e.name)
            if key is not None:
                counts[key] = counts.get(key, 0) + 1
                kernel_ms[key] = kernel_ms.get(key, 0.0) + ms
        if counts == want:
            LAST_PROFILE.update(kernel_ms=kernel_ms, busy_ms=busy,
                                wall_ms=wall)
            return out, counts, host, (busy, ops), wall, nccl
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
    host counts of the same calls, and NCCL's kernels in the trace."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
    want = {k: n * calls for k, n in per_call.items() if n}
    _, counts, host, (busy, ops), wall, nccl = profiled(run, attempts,
                                                        want, what)
    return {"wall_ms": wall / calls, "busy_ms": busy / calls,
            "ops": ops / calls, "idle_share": 1.0 - busy / wall,
            "calls": calls, "launches": counts, "host_launches": host,
            "nccl_launches": nccl}


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


def lm_model(dev, tx, compute_dtype=None, train=True, use_graph=False,
             policy=None, **kw):
    """The LM at ``LM_SHAPE``; eager unless ``use_graph`` (the phases
    that count launches per step run it eagerly); ``kw`` overrides the
    model's settings (``remat``, ``fused_head_chunk``, ``tp``,
    ``seq_axis``, ``seq_mode``)."""
    from singa_tpu_torch.models import transformer
    settings = dict(max_len=LM["seq"], tp=False, fused_head_chunk=8192,
                    compute_dtype=compute_dtype)
    settings.update(kw)
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=LM["layers"], **settings)
    m.compile([tx], is_train=train, use_graph=use_graph, policy=policy)
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


# -- the rest of train_cnn.py: the CNN zoo, pure bf16, the s2d stem --------

def zoo_data(dev, shape, batch, seed=SEED + 10, dtype=None):
    """One fixed synthetic batch: N(0, 1) inputs of ``(batch,) + shape``
    (cast to ``dtype`` when given, as ``-p bfloat16`` casts) and one-hot
    labels of 10 classes."""
    import numpy as np
    from singa_tpu_torch.tensor import Tensor
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch,) + tuple(shape), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    tx = Tensor(data=x, device=dev)
    if dtype is not None:
        tx = tx.as_type(dtype)
    return tx, Tensor(data=y, device=dev)


def zoo_model(name, tx, use_graph, policy=None):
    """A model of ``train_cnn.py``'s zoo (10 classes) as the example makes
    it, compiled for training on ``tx``."""
    from singa_tpu_torch import models
    from singa_tpu_torch.models import resnet
    if name == "resnet50":
        m = resnet.resnet50(num_classes=10)
    elif name == "mlp":
        m = models.mlp.create_model(data_size=tx.shape[1], num_classes=10)
    else:
        m = getattr(models, name).create_model(num_channels=tx.shape[1],
                                               num_classes=10)
    m.compile([tx], is_train=True, use_graph=use_graph, policy=policy)
    return m


def zoo_sgd(opt, fused=True, lr=ZOO_LR):
    return opt.SGD(lr=lr, momentum=0.9, weight_decay=1e-5, fused=fused)


def zoo_run(model, dev, start, tx, ty, steps, fused=True, lr=ZOO_LR):
    """:func:`graph_run` of ``steps`` steps of :func:`zoo_sgd`, the device
    generator seeded with ``ZOO_SEED`` just before (dropout draws from
    it), with copies of every state and optimizer state after
    (``states``)."""
    dev.SetRandSeed(ZOO_SEED)
    r = graph_run(model, start, tx, ty, None, steps,
                  lambda opt: zoo_sgd(opt, fused, lr))
    r["states"] = live_states(model)
    return r


def states_diff(a, b, what):
    """The largest absolute difference between two runs' states (copies
    by name, :func:`live_states`), 0.0 when every one is bitwise equal."""
    import torch
    check(sorted(a) == sorted(b), f"{what}: state names differ")
    worst = 0.0
    for k in a:
        if not torch.equal(a[k], b[k]):
            worst = max(worst, (a[k].float() - b[k].float()).abs()
                        .max().item())
    return worst


def per_step_chunks(model):
    """K1-multi launches per step of ``model``'s fused SGD: its
    parameters grouped by dtype, each group in chunks."""
    groups = {}
    for t in model.get_params().values():
        groups[t.dtype] = groups.get(t.dtype, 0) + 1
    return sum(multi_chunks("sgd_multi", n) for n in groups.values()), {
        str(k).replace("torch.", ""): n for k, n in groups.items()}


def zoo_readings(what, g_model, e_model, tx, ty, batch, per_step, g, e,
                 rounds=ZOO_ROUNDS, steps=ZOO_ROUND_STEPS):
    """The readings every zoo-like phase reports: no synchronizing call in
    a replayed step; step p50/p99 and img/s of graph and eager in
    ``rounds`` alternating rounds of ``steps``; the trace of
    ``GRAPH_TRACED`` replays (K1-multi ``per_step`` a step, none on the
    host) and of as many eager steps, with their idle shares."""
    syncs = sync_warnings(lambda: g_model(tx, ty))
    check(not syncs, f"{what}: a replayed step made {len(syncs)} "
          f"synchronizing calls: {syncs}")
    times = alternating_rounds(
        {"graph": lambda n: timed_steps(g_model, tx, ty, n),
         "eager": lambda n: timed_steps(e_model, tx, ty, n)},
        rounds, steps)
    want = {"sgd_multi": per_step}
    trace = {name: traced(lambda m=m: m(tx, ty), GRAPH_TRACED, want,
                          f"{what} {name} steps")
             for name, m in (("graph", g_model), ("eager", e_model))}
    replayed = replay_counts(what, trace, "sgd_multi")
    rec = {"sgd_multi": replayed, "sync_warnings_per_replay": syncs}
    for name, r in (("graph", g), ("eager", e)):
        q = quantiles(times[name])
        rec[name] = {"step_p50_ms": q["p50_ms"], "step_p99_ms": q["p99_ms"],
                     "steps_timed": q["n"], "step_ms": times[name],
                     "img_per_s": batch * len(times[name])
                     / (sum(times[name]) / 1e3),
                     "peak_device_bytes": r["peak_bytes"],
                     "peak_above_start_bytes": r["peak_above_start_bytes"],
                     "traced": trace[name]}
    return rec


def zoo_line(what, rec):
    gr, er = rec["graph"], rec["eager"]
    return (f"{what}: step p50 {gr['step_p50_ms']:.3f} ms p99 "
            f"{gr['step_p99_ms']:.3f} ms img/s {gr['img_per_s']:.1f} against "
            f"eager p50 {er['step_p50_ms']:.3f} ms p99 "
            f"{er['step_p99_ms']:.3f} ms img/s {er['img_per_s']:.1f}; peak "
            f"above the start {gr['peak_above_start_bytes'] / 2**30:.2f} GiB"
            f" (eager {er['peak_above_start_bytes'] / 2**30:.2f}); traced "
            f"replay: idle {gr['traced']['idle_share']:.3f} busy "
            f"{gr['traced']['busy_ms']:.3f} ms ops "
            f"{gr['traced']['ops']:.0f} (eager idle "
            f"{er['traced']['idle_share']:.3f}); K1-multi launches in the "
            f"trace of {rec['sgd_multi']['replays']} replays: "
            f"{rec['sgd_multi']['replayed_launches']}, none on the host")


def zoo_gates(what, g_model, g, e, per_step, steps, bound):
    """One signature captured once; the host counted ``per_step`` K1-multi
    launches at the eager call and the capture only, eager at every step;
    graph against eager within ``bound`` (0: bitwise, losses too)."""
    stats = list(g_model.graph_stats().values())
    check(stats == [{"n_captures": 1, "n_replays": steps - 1}],
          f"{what}: {stats} after {steps} steps, expected one signature "
          "captured once")
    check(g["launches"] == {"sgd_multi": 2 * per_step} and
          e["launches"] == {"sgd_multi": per_step * steps},
          f"{what}: host-counted launches {g['launches']} (expected "
          f"{per_step} sgd_multi at the eager call and {per_step} at the "
          f"capture), eager {e['launches']}")
    diff = states_diff(g["states"], e["states"], what)
    check(diff <= bound and (bound > 0 or g["losses"] == e["losses"]),
          f"{what}: graph against eager differs by {diff} (allowed "
          f"{bound}); losses {g['losses']} against {e['losses']}")
    return diff


def dropout_replays(dev):
    """A captured dropout (``autograd.dropout`` at ratio 0.5 in training,
    through ``graph.StepGraph``) against the same calls eagerly from the
    same device seed: each call's mask bitwise equal, and the masks of
    two replays different. Returns the share kept by each call."""
    import torch
    from singa_tpu_torch import autograd
    from singa_tpu_torch.autograd_base import CTX
    from singa_tpu_torch.graph import StepGraph
    from singa_tpu_torch.tensor import Tensor
    x = Tensor(data=torch.ones(1 << 16, device=dev.torch_device),
               device=dev)

    def fn(t):
        prev = CTX.training
        CTX.training = True
        try:
            return autograd.dropout(t, 0.5)
        finally:
            CTX.training = prev
    dev.SetRandSeed(ZOO_SEED)
    step = StepGraph(fn, dev)
    graphed = [step(x).data for _ in range(4)]
    dev.SetRandSeed(ZOO_SEED)
    eager = [fn(x).data for _ in range(4)]
    check(step.stats() == {"n_captures": 1, "n_replays": 3},
          f"dropout graph: {step.stats()}")
    check(all(torch.equal(a, b) for a, b in zip(graphed, eager)),
          "dropout graph: a replay's mask differs from the eager call's "
          "with the same seed")
    check(not torch.equal(graphed[2], graphed[3]) and
          not torch.equal(graphed[1], graphed[2]),
          "dropout graph: two replays drew the same mask")
    return [float((t != 0).float().mean()) for t in graphed]


def zoo_train_phase(dev):
    """``train_cnn.py``'s other models trained by fused SGD on the card
    (``ZOO``: Xception 3x299 b32, AlexNet 3x224 b32 with dropout on, CNN
    1x28x28 b64, MLP 784 b64), in f32 and under bf16_mixed, each from a
    numpy-seeded start on one fixed batch, cuDNN deterministic: eager
    unfused, eager fused twice (run to run: the difference the
    convolutions' backward leaves, 0 when it is deterministic), and graphed
    (``use_graph=True``, as the example compiles) with the device
    generator seeded the same. Gates: fused against unfused and graph
    against eager bitwise when run to run is, else within
    ``DETERMINISM_FACTOR`` times the run-to-run difference; one capture;
    K1-multi's launches per step on the host (eager, capture) and in the
    trace of replays; no synchronizing call in a replay; captured dropout
    against eager (:func:`dropout_replays`). Readings of
    :func:`zoo_readings`."""
    import torch
    out = {"dropout_keep_share": dropout_replays(dev)}
    for name, (shape, batch) in ZOO.items():
        tx, ty = zoo_data(dev, shape, batch)
        g_model = zoo_model(name, tx, True)
        e_model = zoo_model(name, tx, False)
        start = seeded_states(g_model, SEED + 11)
        per_step, groups = per_step_chunks(g_model)
        for policy in (None, "bf16_mixed"):
            pname = policy or "float32"
            what = f"zoo {name} {pname} b{batch}"
            if policy:
                g_model.compile([tx], is_train=True, use_graph=True,
                                policy=policy)
                e_model.compile([tx], is_train=True, use_graph=False,
                                policy=policy)
            # the eager model's last run is the fused one: the timed
            # rounds and the trace run its optimizer
            u = zoo_run(e_model, dev, start, tx, ty, ZOO_STEPS, fused=False)
            e2 = zoo_run(e_model, dev, start, tx, ty, ZOO_STEPS)
            e = zoo_run(e_model, dev, start, tx, ty, ZOO_STEPS)
            g = zoo_run(g_model, dev, start, tx, ty, ZOO_STEPS)
            run_to_run = states_diff(e["states"], e2["states"],
                                     f"{what} run to run")
            bound = DETERMINISM_FACTOR * run_to_run
            fu = states_diff(e["states"], u["states"], what)
            check(not u["launches"] and fu <= bound and
                  (bound > 0 or u["losses"] == e["losses"]),
                  f"{what}: fused against unfused differs by {fu} "
                  f"(allowed {bound}); unfused launched {u['launches']}")
            ge = zoo_gates(what, g_model, g, e, per_step, ZOO_STEPS, bound)
            check(all(map(lambda v: v == v and abs(v) < float("inf"),
                          g["losses"])), f"{what}: losses {g['losses']}")
            rec = {"batch": batch, "shape": list(shape), "steps": ZOO_STEPS,
                   "params": groups, "k1_multi_per_step": per_step,
                   "losses": g["losses"], "run_to_run_max_abs": run_to_run,
                   "fused_vs_unfused_max_abs": fu,
                   "graph_vs_eager_max_abs": ge, "allowed": bound,
                   "states_held": len(g["states"]),
                   "host_launches": g["launches"]}
            rec.update(zoo_readings(what, g_model, e_model, tx, ty, batch,
                                    per_step, g, e))
            out[f"{name}_{pname}"] = rec
            held = "bitwise" if bound == 0 else f"within {bound:.3g}"
            print(zoo_line(f"zoo train {name} {pname} b{batch}", rec)
                  + f"; fused == unfused and graph == eager {held} over "
                  f"{rec['states_held']} states (run to run "
                  f"{run_to_run:.3g}); losses "
                  + " ".join(f"{v:.5f}" for v in g["losses"]), flush=True)
        del g_model, e_model, e, e2, u, g
        torch.cuda.empty_cache()
    return out


def held_to_plain_multi(records):
    """Route the fused SGD's multi-tensor call through a check: the
    entries are cloned, the kernel runs, the plain multi-tensor version
    (``sgd_momentum_update_multi_reference``) runs on the clones, and the
    parameters and momenta of the two are compared bitwise; each call's
    count of tensors that differ goes to ``records``. Returns the function
    that puts the call back."""
    import torch
    from singa_tpu_torch.ops import fused_optim as fo
    real = fo.sgd_momentum_update_multi

    def checked(entries, **kw):
        clones = [(p.clone(), g.clone(), m.clone(), lr, wd)
                  for p, g, m, lr, wd in entries]
        real(entries, **kw)
        fo.sgd_momentum_update_multi_reference(clones, **kw)
        differ = sum(not (torch.equal(p, cp) and torch.equal(m, cm))
                     for (p, _, m, _, _), (cp, _, cm, _, _)
                     in zip(entries, clones))
        records.append({"tensors": len(entries), "differ": differ,
                        "dtypes": sorted({f"{e[0].dtype}/{e[2].dtype}"
                                          for e in entries})})
    fo.sgd_momentum_update_multi = checked
    return lambda: setattr(fo, "sgd_momentum_update_multi", real)


def pure_bf16_phase(dev):
    """``train_cnn.py -p bfloat16`` on the card: ResNet-50 (3x224) and
    Xception (3x299) at b32, the input cast to bf16 and no policy, so the
    convolutions' and products' parameters are bf16 (BN's stay f32) and
    K1-multi updates bf16 parameters and momenta; ``SGD(lr=PURE_BF16_LR,
    momentum=0.9, weight_decay=1e-5)``; cuDNN deterministic.
    Eager fused twice (run to run), with every multi-tensor call held
    bitwise against the plain multi-tensor version on clones of the same
    bf16 tensors (:func:`held_to_plain_multi`), then graphed: graph
    against eager bitwise (or within ``DETERMINISM_FACTOR`` times the run
    to run difference), one capture, the losses finite and lower at the
    last of ``PURE_BF16_STEPS`` steps than at the first; readings of
    :func:`zoo_readings`."""
    import torch
    out = {}
    for name, shape in (("resnet50", SHAPE), ("xceptionnet",
                                              XCEPTION_SHAPE)):
        what = f"pure bf16 {name} b{BATCH}"
        tx, ty = zoo_data(dev, shape, BATCH, seed=SEED + 12,
                          dtype="bfloat16")
        g_model = zoo_model(name, tx, True)
        e_model = zoo_model(name, tx, False)
        start = seeded_states(g_model, SEED + 11)
        per_step, groups = per_step_chunks(g_model)
        check(set(groups) == {"bfloat16", "float32"},
              f"{what}: parameter dtypes {groups}")
        checks = []
        restore = held_to_plain_multi(checks)
        try:
            e = zoo_run(e_model, dev, start, tx, ty, PURE_BF16_STEPS,
                        lr=PURE_BF16_LR)
        finally:
            restore()
        bad = [c for c in checks if c["differ"]]
        check(len(checks) == PURE_BF16_STEPS and not bad and
              any("bfloat16/torch.bfloat16" in d for c in checks
                  for d in c["dtypes"]),
              f"{what}: K1-multi against its plain version: {bad or checks}")
        e2 = zoo_run(e_model, dev, start, tx, ty, PURE_BF16_STEPS,
                     lr=PURE_BF16_LR)
        g = zoo_run(g_model, dev, start, tx, ty, PURE_BF16_STEPS,
                    lr=PURE_BF16_LR)
        run_to_run = states_diff(e["states"], e2["states"],
                                 f"{what} run to run")
        bound = DETERMINISM_FACTOR * run_to_run
        ge = zoo_gates(what, g_model, g, e, per_step, PURE_BF16_STEPS, bound)
        losses = g["losses"]
        check(all(v == v and abs(v) < float("inf") for v in losses) and
              losses[-1] < losses[0], f"{what}: losses {losses}")
        rec = {"batch": BATCH, "shape": list(shape),
               "steps": PURE_BF16_STEPS, "params": groups,
               "k1_multi_per_step": per_step, "losses": losses,
               "plain_multi_checks": len(checks),
               "plain_multi_tensors": checks[0]["tensors"],
               "plain_multi_dtypes": checks[0]["dtypes"],
               "run_to_run_max_abs": run_to_run,
               "graph_vs_eager_max_abs": ge, "allowed": bound,
               "host_launches": g["launches"]}
        rec.update(zoo_readings(what, g_model, e_model, tx, ty, BATCH,
                                per_step, g, e))
        out[name] = rec
        held = "bitwise" if bound == 0 else f"within {bound:.3g}"
        print(zoo_line(f"pure bf16 train {name} b{BATCH}", rec)
              + f"; K1-multi bitwise with its plain version on the bf16 "
              f"tensors in {len(checks)} steps ({checks[0]['tensors']} "
              f"tensors, {checks[0]['dtypes']}); graph == eager {held} "
              f"(run to run {run_to_run:.3g}); losses "
              + " ".join(f"{v:.4f}" for v in losses), flush=True)
        del g_model, e_model, e, e2, g
        torch.cuda.empty_cache()
    return out


def xception_serve_phase(dev, seed=SEED):
    """Xception (299 px, 10 classes, weights and BN statistics from a
    numpy seed) through ``compile_serving(batch=32)`` ->
    ``BatchServingEngine`` (graphed ticks), ``N_REQUESTS`` requests, f32
    and bf16_mixed: the logits through K2 against the unfused path
    (``REL_TOL`` x max |logit|); K2a and K2c counted per replayed tick in
    the trace, ``XCEPTION_TAILS`` each (the peephole count the CPU test
    pins), none unfused; tick p50/p99 and img/s of both."""
    import numpy as np
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import xceptionnet
    model = xceptionnet.create_model(num_classes=10)
    model.eval()
    model.compile_serving(input_shape=XCEPTION_SHAPE, batch=BATCH,
                          device=dev, use_graph=False)
    load_numpy_states(model, seeded_states(model, seed + 13))
    rng = np.random.default_rng(seed + 14)
    inputs = [rng.standard_normal(XCEPTION_SHAPE, dtype=np.float32)
              for _ in range(N_REQUESTS)]
    ticks = -(-N_REQUESTS // BATCH)
    kw = dict(shape=XCEPTION_SHAPE, tails=XCEPTION_TAILS)
    out = {}
    for policy in (None, "bf16_mixed"):
        pname = policy or "float32"
        r = serve(model, dev, inputs, policy, False, **kw)
        check(sum(r["launches"].values()) == 0,
              f"xception serve {pname}: the unfused run launched K2: "
              f"{r['launches']}")
        f = serve(model, dev, inputs, policy, True, **kw)
        got, ref = f["logits"], r["logits"]
        check(got.shape == (N_REQUESTS, 10) and np.isfinite(got).all(),
              f"xception serve {pname}: logits {got.shape}, or not finite")
        for kind, per in XCEPTION_TAILS.items():
            n = f["launches"][f"{kind}_nchw"]
            check(n == per * ticks, f"xception serve {pname}: {kind} "
                  f"{n} launches in the trace, expected {per} x {ticks}")
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        check(scale > 0 and err <= REL_TOL[pname] * scale,
              f"xception serve {pname}: K2 logits differ from the unfused "
              f"path by {err} (max |logit| {scale}, tolerance "
              f"{REL_TOL[pname]} x)")
        ts = f["tick"]
        rec = {"policy": pname, "requests": N_REQUESTS, "batch": BATCH,
               "ticks": ticks, "launches": f["launches"],
               "replays": f["replays"],
               "launches_per_replay": {k: v / f["replays"] for k, v in
                                       f["launches"].items() if v},
               "max_abs_err_vs_unfused": err, "max_abs_logit": scale,
               "img_per_s": N_REQUESTS / f["seconds"],
               "unfused_img_per_s": N_REQUESTS / r["seconds"],
               "tick_p50_ms": ts["p50_s"] * 1e3,
               "tick_p99_ms": ts["p99_s"] * 1e3,
               "unfused_tick_p50_ms": r["tick"]["p50_s"] * 1e3,
               "top1_agreement": float((got.argmax(1) == ref.argmax(1))
                                       .mean())}
        out[pname] = rec
        print(f"xception serve NCHW {pname} b{BATCH} x{N_REQUESTS}: tick "
              f"p50 {rec['tick_p50_ms']:.2f} ms p99 "
              f"{rec['tick_p99_ms']:.2f} ms img/s {rec['img_per_s']:.1f} "
              f"(unfused p50 {rec['unfused_tick_p50_ms']:.2f} ms, img/s "
              f"{rec['unfused_img_per_s']:.1f}); K2 launches counted in the "
              f"trace of {f['replays']} replays: {rec['launches_per_replay']}"
              f" per tick; max_abs_err {err:.3g} (max |logit| {scale:.3g})",
              flush=True)
        del r, f
    del model
    torch.cuda.empty_cache()
    return out


def s2d_stem_conv(dev):
    """The ResNet-50 stem conv at b32 (3x224 -> 64 channels, 7x7/s2) in
    its ``space_to_depth`` form against the plain conv on the same OIHW
    weights on the card, NCHW and NHWC, f32 and bf16: the largest
    difference within ``S2D_TOL`` x max |y|, and each timed (CUDA
    events)."""
    import numpy as np
    import torch
    from singa_tpu_torch.ops import conv as tconv
    from singa_tpu_torch.tensor import Tensor
    rng = np.random.default_rng(SEED + 15)
    x = torch.from_numpy(rng.standard_normal((BATCH,) + SHAPE,
                                             dtype=np.float32)).cuda()
    W = torch.from_numpy(rng.standard_normal((64, 3, 7, 7),
                                             dtype=np.float32)
                         * np.float32(np.sqrt(1.0 / 147))).cuda()
    out = {}
    for layout in ("NCHW", "NHWC"):
        xin = x if layout == "NCHW" else x.permute(0, 2, 3, 1).contiguous()
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            tx = Tensor(data=xin.to(dt), device=dev)
            tW = Tensor(data=W.to(dt), device=dev)
            ys = {}
            ms = {}
            for stem, s2d in (("conv7", False), ("space_to_depth", True)):
                h = tconv.ConvHandle(xin.shape, 7, 2, 3, 3, 64, bias=False,
                                     layout=layout, space_to_depth=s2d)
                with torch.no_grad():
                    ys[stem] = tconv.conv2d(h, tx, tW).data.float()
                    ms[stem] = time_ms(lambda h=h: tconv.conv2d(h, tx, tW))
            scale = float(ys["conv7"].abs().max())
            err = float((ys["space_to_depth"] - ys["conv7"]).abs().max())
            check(err <= S2D_TOL[dname] * scale,
                  f"s2d stem {layout} {dname}: differs from conv7 by {err} "
                  f"(max |y| {scale}, tolerance {S2D_TOL[dname]} x)")
            out[f"{layout}_{dname}"] = {"max_abs_err": err,
                                        "max_abs_y": scale,
                                        "conv7_ms": ms["conv7"],
                                        "s2d_ms": ms["space_to_depth"]}
            print(f"s2d stem conv {layout} {dname} b{BATCH}: max_abs_err "
                  f"{err:.3g} (max |y| {scale:.3g}); s2d {ms['space_to_depth']:.4f}"
                  f" ms against conv7 {ms['conv7']:.4f} ms", flush=True)
    return out


def s2d_phase(dev):
    """The ``space_to_depth`` stem on the card: the stem conv against
    conv7 (:func:`s2d_stem_conv`), then ResNet-50 b32 with each stem,
    NCHW and NHWC, f32 and bf16_mixed: ``S2D_STEPS`` graphed fused-SGD
    steps of each from the same numpy-seeded start (one capture,
    K1-multi's host launches at the eager call and the capture only, the
    losses finite, the first loss of the two stems within ``S2D_TOL``,
    relative), then the two timed in ``S2D_ROUNDS`` alternating rounds of
    ``S2D_ROUND_STEPS`` within the process: step p50/p99 and img/s of
    each, peak memory above the start."""
    import torch
    from singa_tpu_torch.models import resnet
    out = {"stem_conv": s2d_stem_conv(dev)}
    tx, ty = zoo_data(dev, SHAPE, BATCH, seed=SEED + 2)
    per_step = multi_chunks("sgd_multi", PARAMS_PER_STEP)
    for layout in ("NCHW", "NHWC"):
        models = {}
        for stem in ("space_to_depth", "conv7"):
            m = resnet.resnet50(num_classes=10, layout=layout, stem=stem)
            m.compile([tx], is_train=True, use_graph=True)
            models[stem] = m
        start = seeded_states(models["conv7"], SEED)
        for policy in (None, "bf16_mixed"):
            pname = policy or "float32"
            what = f"s2d train resnet50 {layout} {pname} b{BATCH}"
            runs = {}
            for stem, m in models.items():
                if policy:
                    m.compile([tx], is_train=True, use_graph=True,
                              policy=policy)
                r = graph_run(m, start, tx, ty, None, S2D_STEPS)
                stats = list(m.graph_stats().values())
                check(stats == [{"n_captures": 1,
                                 "n_replays": S2D_STEPS - 1}] and
                      r["launches"] == {"sgd_multi": 2 * per_step} and
                      all(v == v and abs(v) < float("inf")
                          for v in r["losses"]),
                      f"{what} {stem}: {stats}, host launches "
                      f"{r['launches']}, losses {r['losses']}")
                runs[stem] = r
            a, b = runs["space_to_depth"]["losses"][0], \
                runs["conv7"]["losses"][0]
            tol = S2D_TOL["float32" if policy is None else "bfloat16"]
            check(abs(a - b) <= tol * abs(b) + tol,
                  f"{what}: first loss {a} (s2d) against {b} (conv7)")
            times = alternating_rounds(
                {stem: lambda n, m=m: timed_steps(m, tx, ty, n)
                 for stem, m in models.items()}, S2D_ROUNDS,
                S2D_ROUND_STEPS)
            rec = {}
            for stem, r in runs.items():
                q = quantiles(times[stem])
                rec[stem] = {"step_p50_ms": q["p50_ms"],
                             "step_p99_ms": q["p99_ms"],
                             "steps_timed": q["n"], "step_ms": times[stem],
                             "img_per_s": BATCH * len(times[stem])
                             / (sum(times[stem]) / 1e3),
                             "losses": r["losses"],
                             "peak_above_start_bytes":
                             r["peak_above_start_bytes"]}
            out[f"{layout}_{pname}"] = rec
            s, c = rec["space_to_depth"], rec["conv7"]
            print(f"{what}: s2d step p50 {s['step_p50_ms']:.2f} ms p99 "
                  f"{s['step_p99_ms']:.2f} ms img/s {s['img_per_s']:.1f} "
                  f"against conv7 p50 {c['step_p50_ms']:.2f} ms p99 "
                  f"{c['step_p99_ms']:.2f} ms img/s {c['img_per_s']:.1f} "
                  f"({S2D_ROUNDS} alternating rounds of {S2D_ROUND_STEPS}); "
                  f"peak above the start s2d "
                  f"{s['peak_above_start_bytes'] / 2**30:.2f} GiB, conv7 "
                  f"{c['peak_above_start_bytes'] / 2**30:.2f}; first loss "
                  f"{a:.5f} against {b:.5f}; last {s['losses'][-1]:.5f} "
                  f"against {c['losses'][-1]:.5f}", flush=True)
        del models
        torch.cuda.empty_cache()
    return out


def plain_driver(option, spars=None):
    """The plain PyTorch version, at world 1, of the ``DistOpt`` driver
    that ``option`` runs: :func:`graph_sgd` whose update first takes each
    gradient as the driver hands it to the sum of one rank -- rounded
    through bf16 (``"half"``), or plus its residual and sparsified
    (``"sparseTopK"``: the ``spars`` share of largest |g|, the cut found
    by a sort; ``"sparseThreshold"``: |g| >= ``spars``) with the rest kept
    as the residual (``residual/<name>`` states) -- and as it is for
    ``"plain"`` and ``"partialUpdate"`` (a world of one is every
    partition)."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.tensor import Tensor

    class Plain(opt.SGD):
        def __init__(self):
            super().__init__(lr=0.1, momentum=0.9, weight_decay=1e-5,
                             fused=True)
            self.residuals = {}

        def update_params(self, pairs, ok=None):
            pairs = list(pairs)
            with torch.no_grad():
                for p, g in pairs:
                    if option == "half":
                        g.data = g.data.to(torch.bfloat16).float()
                    elif option in DIST_SPARS:
                        res = self.residuals.get(p.name)
                        if res is None:
                            res = self.residuals[p.name] = Tensor(
                                shape=p.shape, device=p.device)
                        acc = g.data + res.data
                        mag = acc.abs()
                        cut = spars
                        if option == "sparseTopK":
                            k = max(1, int(spars * mag.numel()))
                            cut = mag.reshape(-1).sort(
                                descending=True).values[k - 1]
                        kept = torch.where(mag >= cut, acc, 0.0)
                        res.data.copy_(acc - kept)
                        g.data = kept
            super().update_params(pairs, ok)

        def state_tensor_dict(self):
            d = super().state_tensor_dict()
            d.update({f"residual/{k}": v
                      for k, v in self.residuals.items()})
            return d
    return Plain()


class wire_rounded:
    """The plain version of a ``DistOpt``'s bf16 wire at world 1 (what the
    guard over a ``DistOpt`` reduces under bf16_mixed): within it, every
    gradient ``autograd_base.backward`` yields comes back rounded through
    bf16 to f32, before the guard unscales it."""

    def __enter__(self):
        import torch
        from singa_tpu_torch import autograd_base
        self.real = real = autograd_base.backward

        def backward(y, dy=None):
            for p, g in real(y, dy):
                g.data = g.data.to(torch.bfloat16).float()
                yield p, g
        autograd_base.backward = backward

    def __exit__(self, *exc):
        from singa_tpu_torch import autograd_base
        autograd_base.backward = self.real


def dist_sgd(opt, fused=True):
    """The gloo ranks' SGD: :func:`graph_sgd`'s at ``DIST_LR``."""
    return opt.SGD(lr=DIST_LR, momentum=0.9, weight_decay=1e-5,
                   fused=fused)


def as_float64(model):
    """Every state of the compiled ``model`` in f64, the parameters still
    parameters (the f64 witness of phase 17 (b))."""
    from singa_tpu_torch.autograd_base import register_param
    for t in model.get_states().values():
        param = getattr(t.data, "_singa_param", None) is not None
        t.data = t.data.detach().double()
        if param:
            register_param(t)
    return model


def resnet_steps(model, optimizer, start, tx, ty, steps, dtype):
    """``steps`` eager train calls of ResNet-50 ``model`` with
    ``optimizer`` from ``start``, every state cast to ``dtype``, on
    ``tx``/``ty`` (in ``dtype``). Returns the losses, whether the replicas'
    fingerprints agreed after each step (over a ``DistOpt``), and every
    state as f64 host arrays: after the first step for f32, after the
    last for f64 (the steps the phase holds)."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.opt import DistOpt
    from singa_tpu_torch.parallel import communicator as C
    model.set_optimizer(optimizer)
    model.compile([tx], is_train=True, use_graph=False)
    load_numpy_states(model, start)
    if dtype == torch.float64:
        as_float64(model)
    model.train()
    held = 1 if dtype == torch.float32 else steps
    losses, agree, states = [], [], None
    for i in range(1, steps + 1):
        _, loss = model(tx, ty)
        losses.append(float(loss.data.detach()))
        if isinstance(optimizer, DistOpt):
            agree.append(bool(C.replica_fingerprint(
                list(model.get_states().values()),
                optimizer.communicator)[1]))
        if i == held:
            states = {k: v.double().cpu().numpy()
                      for k, v in live_states(model).items()}
    return {"losses": losses, "agree": agree, "states": states}


def dist_run(model, optimizer, start, tx, ty, args=(), bad_tx=None,
             steps=None):
    """``steps`` (``DIST_STEPS``) train calls ``model(x, ty, *args)`` from
    ``start`` with ``optimizer``, step ``POISON_STEP`` on ``bad_tx`` unless
    it is None;
    the launch counts zeroed just before and read just after. Returns the
    losses, copies of every state around the poisoned step and the
    launches."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    load_numpy_states(model, start)
    model.set_optimizer(optimizer)
    model.train()
    losses, snaps = [], {}
    zero_counts()
    for i in range(1, (steps or DIST_STEPS) + 1):
        poisoned = bad_tx is not None and i == POISON_STEP
        _, loss = model(bad_tx if poisoned else tx, ty, *args)
        losses.append(loss.data.detach())
        if bad_tx is not None and i in (POISON_STEP - 1, POISON_STEP):
            snaps[i] = live_states(model)
    counts = host_launches()
    torch.cuda.synchronize()
    return {"losses": [float(v) for v in losses], "snapshots": snaps,
            "launches": counts}


# phase 17 (a): case -> (policy, DistOpt keyword arguments, the train
# call's extra arguments, the plain version it is held against)
DIST_CASES = {
    "plain": (None, {}, (), "plain"),
    "bucketed": (None, {"bucket_mb": DIST_BUCKET_MB}, (), "plain"),
    "bf16_mixed": ("bf16_mixed", {}, (), "wire"),
    "bf16_mixed_bucketed": ("bf16_mixed", {"bucket_mb": DIST_BUCKET_MB},
                            (), "wire"),
    "half": (None, {}, ("half",), "half"),
    "partialUpdate_rotation0": (None, {}, ("partialUpdate", None, 0),
                                "plain"),
    "partialUpdate_traced": (None, {}, ("partialUpdate",), "plain"),
    "sparseTopK": (None, {}, ("sparseTopK", DIST_SPARS["sparseTopK"]),
                   "sparseTopK"),
    "sparseThreshold": (None, {}, ("sparseThreshold",
                                   DIST_SPARS["sparseThreshold"]),
                        "sparseThreshold"),
}


def dist_nccl_phase(dev, models, tx, ty, start):
    """Phase 17 (a): ResNet-50 b32 through ``DistOpt(SGD(lr=0.1,
    momentum=0.9, weight_decay=1e-5, fused=True))`` over NCCL at world 1,
    in graph mode (call 1 eager, call 2 captured with its collectives,
    replays after), against the same graphed steps through the plain
    version of each case (:data:`DIST_CASES`, :func:`plain_driver`,
    :func:`wire_rounded`) from the same start, cuDNN deterministic: the
    losses and every state bitwise, one capture, K1-multi's launches on
    the host at the eager call and the capture only, under bf16_mixed the
    poisoned step (a replay) a bitwise no-op. Readings: the collectives
    started per step (host calls), and for the per-gradient and the
    bucketed reduction the NCCL kernels and K1-multi's launches in the
    trace of ``GRAPH_TRACED`` replays and the step p50 against the plain
    step's in ``GRAPH_ROUNDS`` alternating rounds. Runs inside
    :func:`nccl_world1`."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.tensor import Tensor
    g_model, e_model = models
    bad = tx.data.clone()
    bad.view(-1)[0] = float("nan")
    bad_tx = Tensor(data=bad, device=dev)
    per_step = multi_chunks("sgd_multi", PARAMS_PER_STEP)
    out = {"backend": torch.distributed.get_backend(), "world": 1}
    for name, (policy, kw, args, ref) in DIST_CASES.items():
        what = f"dist nccl {name}"
        poison = bad_tx if policy else None
        for m in models:
            m.compile([tx], is_train=True, use_graph=True,
                      policy=policy)
        dist = opt.DistOpt(graph_sgd(opt), **kw)
        d = dist_run(g_model, dist, start, tx, ty, args, poison)
        collectives = dist.communicator.n_collectives
        spars = DIST_SPARS.get(ref)
        plain = graph_sgd(opt) if ref in ("plain", "wire") \
            else plain_driver(ref, spars)
        if ref == "wire":
            with wire_rounded():
                p = dist_run(e_model, plain, start, tx, ty, args,
                             poison)
        else:
            p = dist_run(e_model, plain, start, tx, ty, args, poison)
        stats = list(g_model.graph_stats().values())
        check(stats == [{"n_captures": 1,
                         "n_replays": DIST_STEPS - 1}],
              f"{what}: {stats} after {DIST_STEPS} steps, expected "
              "one signature captured once")
        check(np.array_equal(d["losses"], p["losses"], equal_nan=True),
              f"{what}: losses {d['losses']} against the plain "
              f"version's {p['losses']}")
        check(d["launches"] == p["launches"] ==
              {"sgd_multi": 2 * per_step},
              f"{what}: host-counted launches {d['launches']} "
              f"(plain {p['launches']}), expected {per_step} sgd_multi "
              "at the eager call and at the capture")
        # the poisoned last step leaves a NaN norm on both sides
        n_states = held_equal(
            g_model, e_model, what,
            nan_ok=("guard/last_grad_norm",) if policy else ())
        if policy:
            before, after = d["snapshots"][POISON_STEP - 1], \
                d["snapshots"][POISON_STEP]
            moved = [k for k in before if not k.startswith(
                ("optimizer/loss_scale", "optimizer/guard/"))
                and not torch.equal(before[k], after[k])]
            check(not moved and "optimizer/guard/skipped_total"
                  in after and float(
                      after["optimizer/guard/skipped_total"]) == 1,
                  f"{what}: the poisoned step {POISON_STEP} (a replay) "
                  f"moved {len(moved)} states, e.g. {moved[:3]}")
        rec = {"policy": policy or "float32", "args": list(args),
               "plain_version": ref, "losses": d["losses"],
               "states_held": n_states,
               "collectives_per_step": collectives / 2,
               "host_launches": d["launches"]}
        if name in ("plain", "bucketed"):
            times = alternating_rounds(
                {"dist": lambda n: timed_steps(g_model, tx, ty, n),
                 "plain": lambda n: timed_steps(e_model, tx, ty, n)},
                GRAPH_ROUNDS, GRAPH_ROUND_STEPS)
            trace = traced(lambda: g_model(tx, ty), GRAPH_TRACED,
                           {"sgd_multi": per_step}, f"{what} replays")
            check(not trace["host_launches"],
                  f"{what}: traced replays counted "
                  f"{trace['host_launches']} on the host")
            rec.update({
                "dist_step": quantiles(times["dist"]),
                "plain_step": quantiles(times["plain"]),
                "traced": trace,
                "sgd_multi_per_replay":
                trace["launches"]["sgd_multi"] / GRAPH_TRACED,
                "nccl_kernels_per_replay":
                trace["nccl_launches"] / GRAPH_TRACED})
        out[name] = rec
        line = (f"dist nccl world 1 resnet50 b{BATCH} {name} "
                f"({rec['policy']}): {DIST_STEPS} graphed steps bitwise "
                f"with the plain version ({ref}) over {n_states} "
                f"states and the losses, 1 capture; "
                f"{collectives / 2:g} collectives per step on the host")
        if policy:
            line += f"; step {POISON_STEP} a no-op under replay"
        if "traced" in rec:
            line += (
                f"; step p50 {rec['dist_step']['p50_ms']:.2f} ms p99 "
                f"{rec['dist_step']['p99_ms']:.2f} against the plain "
                f"step's {rec['plain_step']['p50_ms']:.2f} / "
                f"{rec['plain_step']['p99_ms']:.2f} ({GRAPH_ROUNDS} "
                f"alternating rounds of {GRAPH_ROUND_STEPS}); in the "
                f"trace of {GRAPH_TRACED} replays: "
                f"{rec['nccl_kernels_per_replay']:g} NCCL kernels and "
                f"{rec['sgd_multi_per_replay']:g} sgd_multi launches "
                "per replay, none on the host; idle "
                f"{rec['traced']['idle_share']:.3f}")
        print(line, flush=True)
    return out


class nccl_world1:
    """A NCCL process group of one rank on ``dev``'s card (a file store in
    a temporary directory) for phases 17 (a) and 18 (a), left and removed
    on the way out."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import tempfile
        from singa_tpu_torch.parallel import communicator
        self.store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
        communicator.init_process(
            communicator.NcclIdHolder(file=os.path.join(self.store,
                                                        "store")),
            0, 1, device=self.dev, timeout_s=120)
        return self

    def __exit__(self, *exc):
        import shutil
        import torch
        torch.distributed.destroy_process_group()
        shutil.rmtree(self.store, ignore_errors=True)


def run_ranks(flag, work, what, ranks=DIST_RANKS):
    """``ranks`` processes of this script (``flag R ranks work``) on the
    one card, waited for with one deadline (``DIST_RANK_TIMEOUT_S``; a
    rank still running then is killed); each must exit 0. Returns each
    rank's ``work/rank<r>.npz`` arrays."""
    import numpy as np
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag,
         str(r), str(ranks), work],
        stdout=open(os.path.join(work, f"rank{r}.log"), "w"),
        stderr=subprocess.STDOUT) for r in range(ranks)]
    try:
        for p in procs:
            p.wait(timeout=max(0.0, DIST_RANK_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [open(os.path.join(work, f"rank{r}.log")).read()
            for r in range(ranks)]
    codes = [p.returncode for p in procs]
    check(codes == [0] * ranks,
          f"{what}: rank exit codes {codes} (deadline "
          f"{DIST_RANK_TIMEOUT_S} s):\n" + "\n".join(
              f"--- rank {r} ---\n{log[-4000:]}"
              for r, log in enumerate(logs)))
    outs = []
    for r in range(ranks):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def norm_close(got, want, tol):
    """|got - want| <= tol |want| (Frobenius norms) and the ratio."""
    import numpy as np
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    ref = float(np.linalg.norm(want))
    return err <= tol * ref + 1e-7, err / max(ref, 1e-30)


def dist_gloo_phase(dev, models, tx, ty, start):
    """Phase 17 (b): ``DIST_RANKS`` processes of this script on the one
    card (:func:`dist_rank_main`), joined over gloo (NCCL refuses two
    ranks on one device), eager, each on its ``datasets.partition`` of the
    batch: the CNN under each option and ResNet-50 with sync-BN
    (:func:`dist_sgd`). Gates:
    every rank exits 0 within ``DIST_RANK_TIMEOUT_S``; the ranks see the
    same (mean) losses; ``replica_fingerprint`` agrees bitwise after every
    step (under partialUpdate it must not after the first: its unselected
    parameters take each rank's own gradient, reference
    ``opt.py:922-992``); graph mode over gloo raises; ResNet-50's states
    bitwise equal on the ranks; in f32 rank 0's first loss and every state
    after the first step within the bounds of one rank's whole-batch run
    here (``DIST_LOSS_*``, ``DIST_STATE_TOL``, ``DIST_MOMENTUM_TOL``); in
    f64 its losses and every state after ``DIST_RESNET``'s steps within
    ``DIST_F64_TOL`` of the f64 whole-batch run's."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.models import resnet
    from singa_tpu_torch.tensor import Tensor
    e_model = models[1]
    rsteps = DIST_RESNET[1]
    ref = resnet_steps(e_model, dist_sgd(opt), start, tx, ty, rsteps,
                       torch.float32)
    ref64 = resnet_steps(
        resnet.resnet50(num_classes=10), dist_sgd(opt, fused=False), start,
        Tensor(data=tx.data.double(), device=dev),
        Tensor(data=ty.data.double(), device=dev), rsteps, torch.float64)
    work = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        np.savez(os.path.join(work, "inputs.npz"),
                 x=tx.data.cpu().numpy(), y=ty.data.cpu().numpy(),
                 **{f"start/{k}": v for k, v in start.items()})
        t0 = time.perf_counter()
        outs = run_ranks("--dist-rank", work, "dist gloo")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    o0 = outs[0]
    check(all(str(o["backend"]) == "gloo" for o in outs),
          f"dist gloo: backends {[str(o['backend']) for o in outs]}")
    rec = {"backend": "gloo", "ranks": DIST_RANKS, "seconds": seconds,
           "cnn": {}}
    for option in DIST_OPTIONS:
        losses = o0[f"cnn/{option}/losses"]
        agree = [o[f"cnn/{option}/agree"] for o in outs]
        check(np.all(np.isfinite(losses)) and all(
            np.array_equal(o[f"cnn/{option}/losses"], losses)
            for o in outs),
              f"dist gloo cnn {option}: losses "
              f"{[o[f'cnn/{option}/losses'].tolist() for o in outs]}")
        if option == "partialUpdate":
            check(not any(a[1:].any() for a in agree),
                  f"dist gloo cnn partialUpdate: replicas agree after "
                  f"the first step ({[a.tolist() for a in agree]}): no "
                  "rank's own gradient was applied")
        else:
            check(all(a.all() for a in agree),
                  f"dist gloo cnn {option}: replica fingerprints "
                  f"disagree after steps {[a.tolist() for a in agree]}")
        launches = [int(o[f"cnn/{option}/sgd_multi"]) for o in outs]
        check(all(n >= DIST_CNN[2] for n in launches),
              f"dist gloo cnn {option}: sgd_multi launches {launches}")
        rec["cnn"][option] = {"losses": losses.tolist(),
                              "agree": [a.tolist() for a in agree],
                              "sgd_multi_launches": launches}
    refused = str(o0["graph_refused"])
    check("gloo" in refused and "CUDA graph" in refused,
          f"dist gloo: use_graph=True over gloo did not raise ({refused!r})")
    for tag in ("resnet", "resnet64"):
        check(all(np.array_equal(o[f"{tag}/losses"], o0[f"{tag}/losses"])
                  and bool(o[f"{tag}/agree"].all()) for o in outs),
              f"dist gloo {tag}: the ranks' losses or fingerprints differ: "
              + str([(o[f"{tag}/losses"].tolist(),
                      o[f"{tag}/agree"].tolist()) for o in outs]))
    losses, losses64 = o0["resnet/losses"], o0["resnet64/losses"]
    check(abs(losses[0] - ref["losses"][0]) <= DIST_LOSS_ATOL
          + DIST_LOSS_RTOL * abs(ref["losses"][0]),
          f"dist gloo resnet50: first loss {losses[0]} against one rank's "
          f"whole batch {ref['losses'][0]}")
    check(np.allclose(losses64, ref64["losses"], rtol=DIST_F64_TOL, atol=0),
          f"dist gloo resnet50 f64: losses {losses64.tolist()} against one "
          f"rank's whole batch {ref64['losses']}")
    worst = {"state": 0.0, "momentum": 0.0}
    worst64 = 0.0
    for tag, want in (("resnet", ref["states"]),
                      ("resnet64", ref64["states"])):
        for k, w in want.items():
            got = o0[f"{tag}/state/{k}"]
            for o in outs[1:]:
                check(np.array_equal(o[f"{tag}/state/{k}"], got),
                      f"dist gloo {tag}: {k} differs between the ranks")
            if tag == "resnet64":
                ok, ratio = norm_close(got, w, DIST_F64_TOL)
                check(ok, f"dist gloo resnet50 f64: {k} is {ratio:.3g} of "
                      f"its norm away from one rank's whole-batch run "
                      f"after {rsteps} steps, above {DIST_F64_TOL}")
                worst64 = max(worst64, ratio)
                continue
            kind = "momentum" if k.endswith(":momentum") else "state"
            tol = DIST_MOMENTUM_TOL if kind == "momentum" \
                else DIST_STATE_TOL
            ok, ratio = norm_close(got, w, tol)
            check(ok, f"dist gloo resnet50: {k} is {ratio:.3g} of its norm "
                  f"away from one rank's whole-batch run after the first "
                  f"step, above {tol}")
            worst[kind] = max(worst[kind], ratio)
    rec.update({"graph_refused": refused, "resnet_losses": losses.tolist(),
                "resnet_whole_batch_losses": ref["losses"],
                "resnet_step1_worst_rel_diff": worst,
                "resnet_f64_losses": losses64.tolist(),
                "resnet_f64_whole_batch_losses": ref64["losses"],
                "resnet_f64_worst_rel_diff": worst64,
                "resnet_states_held": {"f32_step1": len(ref["states"]),
                                       "f64": len(ref64["states"])},
                "resnet_sgd_multi_launches": [
                    int(o["resnet/sgd_multi"]) for o in outs]})
    print(f"dist backend=\"gloo\" {DIST_RANKS} ranks on one card: cnn "
          f"b{DIST_CNN[1]} x{DIST_CNN[2]} under "
          f"{', '.join(DIST_OPTIONS)}: equal losses on the ranks, replica "
          f"fingerprints bitwise equal after every step (partialUpdate: "
          f"unequal, as designed); use_graph=True refused; resnet50 "
          f"b{DIST_RESNET[0]} ({DIST_RESNET[0] // DIST_RANKS} a rank, "
          f"sync-BN) x{DIST_RESNET[1]}: losses "
          + " ".join(f"{v:.6f}" for v in losses)
          + " against one rank's whole batch "
          + " ".join(f"{v:.6f}" for v in ref["losses"])
          + f" (held: the first), states after the first step within "
          f"{worst['state']:.3g} (momenta {worst['momentum']:.3g}) of their "
          f"norms (bounds {DIST_STATE_TOL} / {DIST_MOMENTUM_TOL}); in f64 "
          f"losses " + " ".join(f"{v:.12f}" for v in losses64)
          + f" and every state after {DIST_RESNET[1]} steps within "
          f"{worst64:.3g} (bound {DIST_F64_TOL}); {seconds:.1f} s",
          flush=True)
    return rec


def dist_rank_main(rank, world, work):
    """One rank of phase 17 (b): joins the gloo group on ``cuda:0``, then
    trains the CNN under each option and ResNet-50 on its shard, and
    writes what it saw to ``work/rank<rank>.npz``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from singa_tpu_torch import datasets, device, opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import cnn, resnet
    from singa_tpu_torch.ops import fused_optim as fo
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.tensor import Tensor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = device.create_cuda_gpu(0)
    C.init_process(C.NcclIdHolder(file=os.path.join(work, "store")), rank,
                   world, device=dev, backend="gloo",
                   timeout_s=DIST_RANK_TIMEOUT_S)
    try:
        with np.load(os.path.join(work, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        out = {"backend": np.asarray(torch.distributed.get_backend())}
        shape, batch, steps = DIST_CNN
        rng = np.random.default_rng(SEED + 20)
        x = rng.standard_normal((batch,) + shape, dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
        xs, ys = datasets.partition(rank, world, x, y)
        tx, ty = Tensor(data=xs, device=dev), Tensor(data=ys, device=dev)
        cnn_start = None
        for option in DIST_OPTIONS:
            m = cnn.create_model()
            d = opt.DistOpt(opt.SGD(lr=ZOO_LR, momentum=0.9,
                                    weight_decay=1e-5, fused=True))
            m.set_optimizer(d)
            m.compile([tx], is_train=True, use_graph=False)
            cnn_start = cnn_start or seeded_states(m, SEED + 21)
            load_numpy_states(m, cnn_start)
            fo.reset_counts()
            losses, agree = [], []
            for _ in range(steps):
                _, loss = m(tx, ty, option, DIST_SPARS.get(option))
                losses.append(float(loss.data.detach()))
                agree.append(bool(C.replica_fingerprint(
                    list(m.get_states().values()), d.communicator)[1]))
            out[f"cnn/{option}/losses"] = np.asarray(losses)
            out[f"cnn/{option}/agree"] = np.asarray(agree)
            out[f"cnn/{option}/sgd_multi"] = np.asarray(
                fo.launches["sgd_multi"])
        m.compile([tx], is_train=True, use_graph=True)
        try:
            m(tx, ty)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
        out["graph_refused"] = np.asarray(refused)

        rbatch, rsteps = DIST_RESNET
        bx, by = datasets.partition(rank, world, inputs["x"][:rbatch],
                                    inputs["y"][:rbatch])
        start = {k[len("start/"):]: v for k, v in inputs.items()
                 if k.startswith("start/")}
        for tag, dtype in (("resnet", torch.float32),
                           ("resnet64", torch.float64)):
            rx = Tensor(data=torch.from_numpy(bx).to(dtype), device=dev)
            ry = Tensor(data=torch.from_numpy(by).to(dtype), device=dev)
            m = resnet.resnet50(num_classes=10)
            d = opt.DistOpt(dist_sgd(opt, fused=dtype == torch.float32))
            fo.reset_counts()
            run = resnet_steps(m, d, start, rx, ry, rsteps, dtype)
            out[f"{tag}/losses"] = np.asarray(run["losses"])
            out[f"{tag}/agree"] = np.asarray(run["agree"])
            out[f"{tag}/sgd_multi"] = np.asarray(fo.launches["sgd_multi"])
            for k, v in run["states"].items():
                out[f"{tag}/state/{k}"] = v
            del m, d, run
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def zero_run(model, start, tx, ty, steps):
    """``steps`` train calls of ``model`` (compiled with its optimizer)
    from ``start``; the launch counts zeroed just before and read just
    after, the peak memory reset just before. Returns the losses, the
    launches, the collectives the host started by kind, the bytes the
    model's and its optimizer's states take on this rank and in full, and
    the bytes allocated on the card after the steps and at their peak."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.parallel.gspmd import Partitioner
    load_numpy_states(model, start)
    model.train()
    comm = model._step_communicator()
    before = dict(comm.counts) if comm is not None else {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [model(tx, ty)[1].data.detach() for _ in range(steps)]
    counts = host_launches()
    torch.cuda.synchronize()
    live = model._state_tensors()
    return {"losses": [float(v) for v in losses], "launches": counts,
            "collectives": {k: comm.counts[k] - before[k]
                            for k in comm.KINDS} if comm is not None
            else {},
            "state_bytes": Partitioner.per_device_bytes(live),
            "state_full_bytes": Partitioner.global_bytes(live),
            "allocated_bytes": torch.cuda.memory_allocated(),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def zero_model(model, tx, policy, spelling, use_graph=True):
    """``model`` compiled under ZeRO/FSDP at world 1 by ``spelling``:
    ``"fsdp_axis"`` is ``compile(mesh=train_mesh(data=1),
    fsdp_axis="data")`` with :func:`graph_sgd`, ``"zero"`` a
    ``DistOpt(graph_sgd, zero=True)``."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.parallel import gspmd
    if spelling == "zero":
        model.set_optimizer(opt.DistOpt(graph_sgd(opt), zero=True))
        model.compile([tx], is_train=True, use_graph=use_graph,
                      policy=policy)
    else:
        model.set_optimizer(graph_sgd(opt))
        model.compile([tx], is_train=True, use_graph=use_graph,
                      policy=policy, mesh=gspmd.train_mesh(data=1),
                      fsdp_axis="data")
    return model


def zero_nccl_phase(dev, models, tx, ty, start):
    """Phase 18 (a): ResNet-50 b32 under ZeRO/FSDP over NCCL at world 1
    (:data:`ZERO_CASES`, :func:`zero_model`), graphed (call 1 eager, call
    2 captured with its gathers and scatters, replays after), against the
    plain graphed step from the same start, cuDNN deterministic: the
    losses and every state bitwise (gathered), one capture, K1-multi's
    launches on the host at the eager call and the capture only, a gather
    and a scatter per parameter each step. Readings: the collectives per
    step by kind; for the ``fsdp_axis`` cases the NCCL kernels and
    K1-multi's launches in the trace of ``GRAPH_TRACED`` replays and the
    step p50/p99 against the plain step's in ``GRAPH_ROUNDS`` alternating
    rounds; in f32 the bytes of the states and on the card between steps
    and at the peak, FSDP and plain, graphed and eager. Runs inside
    :func:`nccl_world1`."""
    import gc
    import torch
    from singa_tpu_torch import opt
    g_model, e_model = models
    per_step = multi_chunks("sgd_multi", PARAMS_PER_STEP)
    out = {"backend": torch.distributed.get_backend(), "world": 1}
    for name, (policy, spelling) in ZERO_CASES.items():
        what = f"fsdp nccl {name}"
        zero_model(g_model, tx, policy, spelling)
        e_model.set_optimizer(graph_sgd(opt))
        e_model.compile([tx], is_train=True, use_graph=True, policy=policy)
        g = zero_run(g_model, start, tx, ty, ZERO_STEPS)
        if policy:
            with wire_rounded():
                e = zero_run(e_model, start, tx, ty, ZERO_STEPS)
        else:
            e = zero_run(e_model, start, tx, ty, ZERO_STEPS)
        stats = list(g_model.graph_stats().values())
        check(stats == [{"n_captures": 1, "n_replays": ZERO_STEPS - 1}],
              f"{what}: {stats} after {ZERO_STEPS} steps, expected one "
              "signature captured once")
        check(g["losses"] == e["losses"],
              f"{what}: losses {g['losses']} against the plain step's "
              f"{e['losses']}")
        check(g["launches"] == e["launches"] ==
              {"sgd_multi": 2 * per_step},
              f"{what}: host-counted launches {g['launches']} (plain "
              f"{e['launches']}), expected {per_step} sgd_multi at the "
              "eager call and at the capture")
        n_states = held_equal(g_model, e_model, what)
        # the host runs the step twice: the eager call and the capture
        coll = {k: v / 2 for k, v in g["collectives"].items()}
        check(coll["all_gather"] == coll["reduce_scatter"] ==
              PARAMS_PER_STEP and coll["all_reduce"] <= 2,
              f"{what}: collectives per step {coll}, expected a gather and "
              f"a scatter for each of the {PARAMS_PER_STEP} parameters")
        rec = {"policy": policy or "float32", "spelling": spelling,
               "losses": g["losses"], "states_held": n_states,
               "collectives_per_step": coll,
               "state_bytes": g["state_bytes"],
               "state_full_bytes": g["state_full_bytes"]}
        line = (f"fsdp nccl world 1 resnet50 b{BATCH} {name}: {ZERO_STEPS} "
                f"graphed steps bitwise with the plain step over {n_states} "
                f"states and the losses, 1 capture; per step "
                f"{coll['all_gather']:g} gathers, {coll['reduce_scatter']:g}"
                f" scatters, {coll['all_reduce']:g} all-reduces on the host")
        if spelling == "fsdp_axis":
            times = alternating_rounds(
                {"fsdp": lambda n: timed_steps(g_model, tx, ty, n),
                 "plain": lambda n: timed_steps(e_model, tx, ty, n)},
                GRAPH_ROUNDS, GRAPH_ROUND_STEPS)
            trace = traced(lambda: g_model(tx, ty), GRAPH_TRACED,
                           {"sgd_multi": per_step}, f"{what} replays")
            check(not trace["host_launches"],
                  f"{what}: traced replays counted "
                  f"{trace['host_launches']} on the host")
            rec.update({
                "fsdp_step": quantiles(times["fsdp"]),
                "plain_step": quantiles(times["plain"]), "traced": trace,
                "sgd_multi_per_replay":
                trace["launches"]["sgd_multi"] / GRAPH_TRACED,
                "nccl_kernels_per_replay":
                trace["nccl_launches"] / GRAPH_TRACED})
            line += (
                f"; step p50 {rec['fsdp_step']['p50_ms']:.2f} ms p99 "
                f"{rec['fsdp_step']['p99_ms']:.2f} against the plain "
                f"step's {rec['plain_step']['p50_ms']:.2f} / "
                f"{rec['plain_step']['p99_ms']:.2f} ({GRAPH_ROUNDS} "
                f"alternating rounds of {GRAPH_ROUND_STEPS}); in the trace "
                f"of {GRAPH_TRACED} replays: "
                f"{rec['nccl_kernels_per_replay']:g} NCCL kernels and "
                f"{rec['sgd_multi_per_replay']:g} sgd_multi launches per "
                f"replay, none on the host; idle "
                f"{rec['traced']['idle_share']:.3f}")
        if name == "fsdp_axis":
            memory = {}
            for label, graphed, fsdp in (("fsdp_graphed", True, True),
                                         ("fsdp_eager", False, True),
                                         ("plain_graphed", True, False),
                                         ("plain_eager", False, False)):
                m = g_model if fsdp else e_model
                if fsdp:
                    zero_model(m, tx, None, spelling, use_graph=graphed)
                else:
                    m.set_optimizer(graph_sgd(opt))
                    m.compile([tx], is_train=True, use_graph=graphed)
                gc.collect()
                torch.cuda.empty_cache()
                r = zero_run(m, start, tx, ty, ZERO_STEPS)
                memory[label] = {k: r[k] for k in (
                    "state_bytes", "allocated_bytes", "peak_bytes")}
            rec["memory"] = memory
            line += "; bytes (states / on the card between steps / peak): " \
                + ", ".join(f"{k} {v['state_bytes']} / "
                            f"{v['allocated_bytes']} / {v['peak_bytes']}"
                            for k, v in memory.items())
        out[name] = rec
        print(line, flush=True)
    return out


def zero_gloo_phase(dev, tx, ty, start):
    """Phase 18 (b): ``DIST_RANKS`` processes of this script on the one
    card (:func:`zero_rank_main`), over gloo, eager, each on its half of
    every batch: the CNN and ResNet-50 under ``DistOpt(zero=True)`` against
    the plain ``DistOpt``. Gates: every rank exits 0; on each rank the
    losses and every state (gathered) bitwise; a rank's state bytes at
    most ``ZERO_BYTES_SHARE`` of a replicated rank's; the ZeRO ResNet-50's
    archive equal (names, shapes, dtypes, values) to a replicated rank's,
    and restored into a fresh ZeRO model bitwise on both ranks."""
    import shutil
    import tempfile
    import numpy as np
    work = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    try:
        np.savez(os.path.join(work, "inputs.npz"),
                 x=tx.data.cpu().numpy(), y=ty.data.cpu().numpy(),
                 **{f"start/{k}": v for k, v in start.items()})
        t0 = time.perf_counter()
        outs = run_ranks("--zero-rank", work, "fsdp gloo")
        seconds = time.perf_counter() - t0
        archives = [load_archive(os.path.join(work, f))
                    for f in ("zero.zip", "rep0.zip", "rep1.zip")]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = {"backend": "gloo", "ranks": DIST_RANKS, "seconds": seconds}
    for tag in ("cnn", "resnet"):
        for r, o in enumerate(outs):
            check(bool(o[f"{tag}/bitwise"]) and np.array_equal(
                o[f"{tag}/zero_losses"], o[f"{tag}/plain_losses"]),
                f"fsdp gloo {tag} rank {r}: ZeRO against the plain DistOpt: "
                f"losses {o[f'{tag}/zero_losses'].tolist()} / "
                f"{o[f'{tag}/plain_losses'].tolist()}, states differing: "
                f"{str(o[f'{tag}/differing'])}")
            share = float(o[f"{tag}/zero_bytes"]) / float(
                o[f"{tag}/plain_bytes"])
            check(share <= ZERO_BYTES_SHARE,
                  f"fsdp gloo {tag} rank {r}: the rank holds {share:.3f} of "
                  f"a replicated rank's state bytes, above "
                  f"{ZERO_BYTES_SHARE}")
        rec[tag] = {"losses": outs[0][f"{tag}/zero_losses"].tolist(),
                    "state_bytes": [int(o[f"{tag}/zero_bytes"])
                                    for o in outs],
                    "replicated_state_bytes": int(
                        outs[0][f"{tag}/plain_bytes"]),
                    "share": float(outs[0][f"{tag}/zero_bytes"])
                    / float(outs[0][f"{tag}/plain_bytes"])}
    zero, rep0, rep1 = archives
    for name, rep in (("rep0", rep0), ("rep1", rep1)):
        check(zero[0] == rep[0] and sorted(zero[1]) == sorted(rep[1]) and
              all(np.array_equal(zero[1][k], rep[1][k]) for k in zero[1]),
              f"fsdp gloo: the ZeRO archive differs from {name}.zip")
    check(all(bool(o["resnet/restored"]) for o in outs),
          "fsdp gloo: the ZeRO archive restored into a ZeRO model differs "
          "from the saved run: " + str([str(o["resnet/restored_differing"])
                                        for o in outs]))
    rec["archive_arrays"] = len(zero[1])
    print(f"fsdp backend=\"gloo\" {DIST_RANKS} ranks on one card, ZeRO "
          f"(DistOpt(zero=True)) bitwise with the plain DistOpt: cnn "
          f"b{ZERO_CNN[1]} x{ZERO_CNN[2]}, a rank's state bytes "
          f"{rec['cnn']['share']:.3f} of a replicated rank's; resnet50 "
          f"b{ZERO_RESNET[0]} ({ZERO_RESNET[0] // DIST_RANKS} a rank) "
          f"x{ZERO_RESNET[1]}, losses "
          + " ".join(f"{v:.6f}" for v in rec["resnet"]["losses"])
          + f", state bytes {rec['resnet']['state_bytes']} of "
          f"{rec['resnet']['replicated_state_bytes']} "
          f"({rec['resnet']['share']:.3f}); the archive "
          f"({len(zero[1])} arrays) a replicated rank's, restored bitwise "
          f"on both ranks; {seconds:.1f} s", flush=True)
    return rec


def load_archive(path):
    """``(attributes, arrays)`` of a ``save_states`` archive."""
    import io
    import zipfile
    import numpy as np
    with zipfile.ZipFile(path) as zf:
        attr = json.loads(zf.read("states_attr.json"))
        with np.load(io.BytesIO(zf.read("tensor_dict.npz"))) as z:
            return attr, {k: z[k] for k in z.files}


def gathered_states(model):
    """Host copies of every state of ``model`` and of its optimizer, a
    shard gathered (collective), by name."""
    import numpy as np
    d = {k: np.array(v.to_numpy()) for k, v in model.get_states().items()}
    d.update({f"optimizer/{k}": np.array(v)
              for k, v in model.optimizer.get_states().items()})
    return d


def differing(a, b):
    """The names whose arrays differ between ``a`` and ``b``."""
    import numpy as np
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return [k for k in a if not np.array_equal(a[k], b[k])]


def zero_rank_main(rank, world, work):
    """One rank of phase 18 (b): joins the gloo group on ``cuda:0``, then
    trains the CNN and ResNet-50 on its shard of each batch under the
    plain ``DistOpt`` and under ``DistOpt(zero=True)``, compares them
    here, writes the archives of ResNet-50 (a replicated rank's
    ``rep<rank>.zip``, the ZeRO run's ``zero.zip``), restores the ZeRO one,
    and writes what it saw to ``work/rank<rank>.npz``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from singa_tpu_torch import datasets, device, opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import cnn, resnet
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.parallel.gspmd import Partitioner
    from singa_tpu_torch.tensor import Tensor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = device.create_cuda_gpu(0)
    C.init_process(C.NcclIdHolder(file=os.path.join(work, "store")), rank,
                   world, device=dev, backend="gloo",
                   timeout_s=DIST_RANK_TIMEOUT_S)
    try:
        with np.load(os.path.join(work, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        out = {}
        shape, batch, cnn_steps = ZERO_CNN
        rng = np.random.default_rng(SEED + 22)
        x = rng.standard_normal((batch,) + shape, dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
        cnn_x = datasets.partition(rank, world, x, y)
        rbatch, rsteps = ZERO_RESNET
        res_x = datasets.partition(rank, world, inputs["x"][:rbatch],
                                   inputs["y"][:rbatch])
        res_start = {k[len("start/"):]: v for k, v in inputs.items()
                     if k.startswith("start/")}
        for tag, factory, (bx, by), steps, sgd in (
                ("cnn", cnn.create_model, cnn_x, cnn_steps,
                 lambda: opt.SGD(lr=ZOO_LR, momentum=0.9, weight_decay=1e-5,
                                 fused=True)),
                ("resnet", lambda: resnet.resnet50(num_classes=10), res_x,
                 rsteps, lambda: dist_sgd(opt))):
            tx, ty = Tensor(data=bx, device=dev), Tensor(data=by, device=dev)
            start = res_start if tag == "resnet" else None
            runs = {}
            for zero in (False, True):
                m = factory()
                m.set_optimizer(opt.DistOpt(sgd(), zero=zero))
                m.compile([tx], is_train=True, use_graph=False)
                start = start or seeded_states(m, SEED + 23)
                load_numpy_states(m, start)
                losses = [float(m(tx, ty)[1].data.detach())
                          for _ in range(steps)]
                label = "zero" if zero else "plain"
                out[f"{tag}/{label}_losses"] = np.asarray(losses)
                out[f"{tag}/{label}_bytes"] = np.asarray(
                    Partitioner.per_device_bytes(m._state_tensors()))
                runs[label] = gathered_states(m)
                if tag == "resnet":
                    m.save_states(os.path.join(
                        work, "zero.zip" if zero else f"rep{rank}.zip"))
                del m
            diff = differing(runs["zero"], runs["plain"])
            out[f"{tag}/bitwise"] = np.asarray(not diff)
            out[f"{tag}/differing"] = np.asarray(", ".join(diff[:5]))
        m = resnet.resnet50(num_classes=10)
        m.set_optimizer(opt.DistOpt(dist_sgd(opt), zero=True))
        m.compile([Tensor(data=res_x[0], device=dev)], is_train=True)
        m.load_states(os.path.join(work, "zero.zip"))
        diff = differing(gathered_states(m), runs["zero"])
        out["resnet/restored"] = np.asarray(not diff)
        out["resnet/restored_differing"] = np.asarray(", ".join(diff[:5]))
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


# -- phase 19: the ImageNet zoo and the breadth of the API --------------------

def op_cases():
    """``(name, call, inputs, differentiated inputs)`` for every public
    function of the port's ``autograd`` (``OP_UNSWEPT`` aside):
    ``call(autograd, *Tensors)`` on numpy ``inputs`` made from a seed; the
    differentiated inputs are the floating ones unless given. ``name``'s
    part before "@" is the function held."""
    import numpy as np
    rng = np.random.default_rng(SEED + 30)

    def r(*shape, lo=-1.5, hi=1.5):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def f32(*v):
        return np.array(v, np.float32)

    def b01(*shape):
        return (rng.random(shape) > 0.5).astype(np.float32)

    def conv(ag, x, W, b=None, **kw):
        h = ag.ConvHandle(x, kw.pop("k", (3, 3)), kw.pop("stride", 1),
                          kw.pop("padding", 1), x.shape[kw.get("ch", 1)],
                          W.shape[0], b is not None,
                          **{k: v for k, v in kw.items() if k != "ch"})
        return ag.conv2d(h, x, W, b)

    def tconv(ag, x, W, b, layout, **kw):
        ch = 3 if layout == "NHWC" else 1
        h = ag.ConvTransposeHandle(x, (3, 3), kw.pop("stride", 2),
                                   kw.pop("padding", 1), x.shape[ch],
                                   W.shape[1] * kw.get("group", 1), True,
                                   layout=layout, **kw)
        return ag.conv_transpose2d(h, x, W, b)

    def bn(ag, x, s, b, rm, rv, train):
        from singa_tpu_torch.autograd_base import CTX
        h = ag.BatchNormHandle(0.9, x, 1e-5)
        prev, CTX.training = CTX.training, train
        try:
            from singa_tpu_torch.tensor import Tensor
            return ag.batchnorm_2d(h, x, s, b,
                                   Tensor(data=rm.data.clone(),
                                          device=rm.device),
                                   Tensor(data=rv.data.clone(),
                                          device=rv.device))
        finally:
            CTX.training = prev

    def pool(ag, x, **kw):
        return ag.pooling_2d(ag.PoolingHandle(x, **kw), x)

    x35, y35, x235 = r(3, 5), r(3, 5), r(2, 3, 5)
    xp, x_in, x_gt1 = r(3, 5, lo=0.2, hi=1.8), r(3, 5, lo=-0.9, hi=0.9), \
        r(3, 5, lo=1.1, hi=2.5)
    img = r(4, 8, 14, 14)
    ties = np.array([[1.0, 1.0, -0.5], [0.2, 0.7, 0.7]], np.float32)
    onehot5 = np.eye(5, dtype=np.float32)[[0, 2, 1, 4]]
    unary = ["abs", "acos", "acosh", "asin", "asinh", "atan", "atanh",
             "ceil", "cos", "cosh", "erf", "exp", "floor", "identity", "log",
             "negative", "reciprocal", "round", "rounde", "sign", "sin",
             "sinh", "sqrt", "tan", "tanh", "relu", "sigmoid", "softplus",
             "softsign", "gelu", "hardsigmoid", "leakyrelu", "elu", "selu"]
    domain = {"acos": x_in, "asin": x_in, "atanh": x_in, "acosh": x_gt1,
              "log": xp, "sqrt": xp, "reciprocal": xp, "tan": x_in}
    cases = [(n, lambda ag, x, n=n: getattr(ag, n)(x), [domain.get(n, x35)],
              None) for n in unary]
    cases += [
        ("abs@0", lambda ag, x: ag.abs(x), [f32(-1.0, 0.0, 0.5)], None),
        ("clip@bounds", lambda ag, x: ag.clip(x, 0.0, 6.0),
         [f32(0.0, 6.0, 3.0, -1.0, 7.0)], None),
        ("prelu", lambda ag, x, s: ag.prelu(x, s), [x35, r(3, 5)], None),
        ("softmax", lambda ag, x: ag.softmax(x), [x235], None),
        ("lrn", lambda ag, x: ag.lrn(x, 5, 1e-2, 0.75, 2.0), [img], None),
        ("add", lambda ag, a, b: ag.add(a, b), [x235, r(5)], None),
        ("sub", lambda ag, a, b: ag.sub(a, b), [x35, y35], None),
        ("mul", lambda ag, a, b: ag.mul(a, b), [x235, r(3, 1)], None),
        ("div", lambda ag, a, b: ag.div(a, b), [x35, xp], None),
        ("pow", lambda ag, a, b: ag.pow(a, b), [xp, y35], None),
        ("add_bias", lambda ag, x, b: ag.add_bias(x, b, 1), [x235, r(3)],
         None),
        ("matmul", lambda ag, a, b: ag.matmul(a, b), [r(2, 64, 96),
                                                      r(2, 96, 48)], None),
        ("gemm", lambda ag, a, b, c: ag.gemm(a, b, c, 0.5, 2.0, 1, 1),
         [r(96, 64), r(48, 96), r(64, 48)], None),
        ("sum", lambda ag, a, b, c: ag.sum(a, b, c), [x35, y35, xp], None),
        ("add_all", lambda ag, a, b: ag.add_all(a, b), [x35, y35], None),
        ("mean", lambda ag, a, b: ag.mean(a, b), [x35, y35], None),
        ("max@ties", lambda ag, a, b: ag.max(a, b), [ties, ties.copy()],
         None),
        ("min", lambda ag, a, b: ag.min(a, b), [x35, y35], None),
        ("where", lambda ag, c, a, b: ag.where(c, a, b),
         [b01(3, 5), x35, y35], (1, 2)),
        ("equal", lambda ag, a, b: ag.equal(a, b), [b01(3, 5), b01(3, 5)],
         ()),
        ("less", lambda ag, a, b: ag.less(a, b), [x35, y35], ()),
        ("greater", lambda ag, a, b: ag.greater(a, b), [x35, y35], ()),
        ("_and", lambda ag, a, b: ag._and(a, b), [b01(3, 5), b01(3, 5)], ()),
        ("_or", lambda ag, a, b: ag._or(a, b), [b01(3, 5), b01(3, 5)], ()),
        ("_xor", lambda ag, a, b: ag._xor(a, b), [b01(3, 5), b01(3, 5)], ()),
        ("_not", lambda ag, a: ag._not(a), [b01(3, 5)], ()),
        ("reduce_sum", lambda ag, x: ag.reduce_sum(x, [0, 2], 0), [x235],
         None),
        ("reduce_mean", lambda ag, x: ag.reduce_mean(x, [2, 3], 0), [img],
         None),
        ("reduce_max@ties", lambda ag, x: ag.reduce_max(x, [1], 0), [ties],
         None),
        ("reduce_prod", lambda ag, x: ag.reduce_prod(x, [1], 0),
         [r(2, 3, 2, lo=0.4, hi=1.6)], None),
        ("reshape", lambda ag, x: ag.reshape(x, (5, 6)), [x235], None),
        ("flatten", lambda ag, x: ag.flatten(x, 1), [img], None),
        ("transpose", lambda ag, x: ag.transpose(x, (0, 2, 3, 1)), [img],
         None),
        ("squeeze", lambda ag, x: ag.squeeze(x, [0, 2]), [r(1, 3, 1, 5)],
         None),
        ("unsqueeze", lambda ag, x: ag.unsqueeze(x, [0, 3]), [x35], None),
        ("cat", lambda ag, a, b: ag.cat([a, b], 1), [img, img[:, :3]],
         None),
        ("split", lambda ag, x: ag.split(x, 1, num_output=2), [img], None),
        ("slice", lambda ag, x: ag.slice(x, [-1, 0], [0, 4], [0, 1],
                                         [-2, 2]), [x35], None),
        ("make_slice", lambda ag, x: ag.make_slice(x, 1, 2), [x35], None),
        ("gather", lambda ag, x: ag.gather(x, -1, [-1, 0, 2]), [x235],
         None),
        ("scatter_elements", lambda ag, x, i, u: ag.scatter_elements(
            x, i, u, 1), [r(3, 4), f32(-1, 0, 2, 1, -4, 3).reshape(3, 2),
                          r(3, 2)], (0, 2)),
        ("tile", lambda ag, x: ag.tile(x, [2, 1, 2]), [x35], None),
        ("expand", lambda ag, x: ag.expand(x, (4, 3, 5)), [x35], None),
        ("pad@constant", lambda ag, x: ag.pad(x, "constant",
                                              [1, 0, 0, 2], 0.5), [x35],
         None),
        ("pad@reflect", lambda ag, x: ag.pad(x, "reflect", [2, 1, 0, 3]),
         [r(4, 5)], None),
        ("pad@edge", lambda ag, x: ag.pad(x, "edge", [0, 2, 1, 3, 0, 1]),
         [x235], None),
        ("upsample", lambda ag, x: ag.upsample(x, "nearest", [1, 2, 2, 3]),
         [r(2, 3, 4, 5)], None),
        ("depth_to_space@DCR", lambda ag, x: ag.depth_to_space(x, 2),
         [r(2, 8, 3, 4)], None),
        ("depth_to_space@CRD", lambda ag, x: ag.depth_to_space(x, 2, "CRD"),
         [r(2, 8, 3, 4)], None),
        ("space_to_depth", lambda ag, x: ag.space_to_depth(x, 2),
         [r(2, 3, 4, 6)], None),
        ("onehot", lambda ag, i: ag.onehot(-1, i, 6), [f32(0, 3, 7, -1)],
         ()),
        ("embedding", lambda ag, i, W: ag.embedding(i, W),
         [f32(0, 3, 5, 2), r(6, 4)], (1,)),
        ("cossim", lambda ag, a, b: ag.cossim(a, b), [x35, y35], None),
        ("shape", lambda ag, x: ag.shape(x), [x235], ()),
        ("constant_of_shape", lambda ag, s: ag.constant_of_shape(s, 2.5),
         [np.array([2, 3], np.int64)], ()),
        ("nonzero", lambda ag, x: ag.nonzero(x),
         [f32(1, 0, 0, 2, 0, -1).reshape(2, 3)], ()),
        ("cast", lambda ag, x: ag.cast(x, np.int64), [f32(1.7, -2.3)], ()),
        ("astype", lambda ag, x: ag.astype(x, "bfloat16"), [x235], None),
        ("dropout", lambda ag, x: ag.dropout(x, 0.5), [x35], None),
        ("cross_entropy", lambda ag, p, y: ag.cross_entropy(p, y),
         [np.abs(r(4, 5)) + 0.1, onehot5], (0,)),
        ("softmax_cross_entropy", lambda ag, x, y:
         ag.softmax_cross_entropy(x, y), [r(4, 5), onehot5], (0,)),
        ("mse_loss", lambda ag, a, b: ag.mse_loss(a, b), [x35, y35], (0,)),
        ("binary_cross_entropy", lambda ag, p, y:
         ag.binary_cross_entropy(p, y), [r(4, 3, lo=0.05, hi=0.95),
                                         b01(4, 3)], (0,)),
        ("ranking_loss", lambda ag, p, n: ag.ranking_loss(p, n, 0.25),
         [f32(0.75, 0.9, -0.2, 1.2), f32(0.5, 0.1, 0.4, 1.0)], None),
        ("layernorm", lambda ag, x, s, b: ag.layernorm(x, s, b),
         [r(8, 64), r(64, lo=0.5, hi=1.5), r(64)], None),
        ("conv2d@NCHW", lambda ag, x, W, b: conv(ag, x, W, b),
         [img, r(16, 8, 3, 3), r(16)], None),
        ("conv2d@NHWC_group_stride", lambda ag, x, W: conv(
            ag, x, W, stride=2, group=2, layout="NHWC", ch=3),
         [r(4, 14, 14, 8), r(16, 4, 3, 3)], None),
        ("conv_transpose2d@NCHW", lambda ag, x, W, b: tconv(
            ag, x, W, b, "NCHW", output_padding=1),
         [img, r(8, 6, 3, 3), r(6)], None),
        ("conv_transpose2d@NHWC_group_dilation", lambda ag, x, W, b: tconv(
            ag, x, W, b, "NHWC", group=2, dilation=2, stride=1),
         [r(4, 14, 14, 8), r(8, 3, 3, 3), r(6)], None),
        ("batchnorm_2d@eval", lambda ag, x, s, b, m, v: bn(
            ag, x, s, b, m, v, False),
         [img, r(8, lo=0.5, hi=1.5), r(8), r(8), r(8, lo=0.5, hi=2.0)],
         (0, 1, 2)),
        ("batchnorm_2d@train", lambda ag, x, s, b, m, v: bn(
            ag, x, s, b, m, v, True),
         [img, r(8, lo=0.5, hi=1.5), r(8), r(8), r(8, lo=0.5, hi=2.0)],
         (0, 1, 2)),
        ("pooling_2d@max", lambda ag, x: pool(ag, x, kernel_size=3,
                                              stride=2, padding=1), [img],
         None),
        ("pooling_2d@avg", lambda ag, x: pool(ag, x, kernel_size=2,
                                              is_max=False), [img], None),
        ("globalaveragepool", lambda ag, x: ag.globalaveragepool(x), [img],
         None),
    ]
    return cases


# public functions of the port's autograd that the op sweep does not
# drive: the tape helpers (the training phases drive them) and the two
# that raise until their slices come
OP_UNSWEPT = {"backward", "gradients", "infer_dependency", "is_training",
              "set_training", "axis_helper", "back_broadcast",
              "ctensor2numpy", "checkpoint", "rnn_op"}


def op_run(fn, arrays, diff, dev):
    """``fn`` on Tensors of ``arrays`` on ``dev``: the outputs and the
    gradients of the differentiated inputs for a seeded cotangent (f32
    host copies)."""
    import numpy as np
    import torch
    from singa_tpu_torch import autograd
    from singa_tpu_torch.tensor import Tensor
    ts = [torch.from_numpy(np.array(a)).to(dev.torch_device)
          for a in arrays]
    for i in diff:
        ts[i].requires_grad_(True)
    out = fn(autograd, *[Tensor(data=t, device=dev) for t in ts])
    outs = out if isinstance(out, tuple) else (out,)
    host = [o.data.detach().float().cpu().numpy() for o in outs]
    grads = []
    if diff:
        cots = [torch.from_numpy(np.random.default_rng(7 + k).standard_normal(
            o.shape).astype(np.float32)).to(dev.torch_device, o.dtype)
            for k, o in enumerate(outs)]
        got = torch.autograd.grad([o.data for o in outs],
                                  [ts[i] for i in diff], cots,
                                  allow_unused=True)
        grads = [np.zeros(ts[i].shape, np.float32) if g is None else
                 g.float().cpu().numpy() for i, g in zip(diff, got)]
    return host, grads


def op_sweep(dev, tol=OP_TOL):
    """Every case of :func:`op_cases` on the card against the same call on
    the CPU, forward and backward, each output and gradient within ``tol``
    of its largest entry (TF32 off); and every public function of the
    port's ``autograd`` driven by a case or in ``OP_UNSWEPT``. Returns the
    cases' largest relative errors."""
    import inspect
    import numpy as np
    from singa_tpu_torch import autograd
    from singa_tpu_torch import device as device_mod
    from singa_tpu_torch.autograd_base import CTX
    cpu = device_mod.create_cpu_device()
    cases = op_cases()
    public = {n for n, o in vars(autograd).items() if inspect.isfunction(o)
              and (not n.startswith("_") or n in ("_and", "_or", "_xor",
                                                  "_not"))}
    missing = public - {c[0].split("@")[0] for c in cases} - OP_UNSWEPT
    check(not missing, f"ops: public autograd functions with no case on "
          f"the card: {sorted(missing)}")
    worst = {}
    prev, CTX.training = CTX.training, False    # dropout: the identity
    try:
        for name, fn, arrays, diff in cases:
            if diff is None:
                diff = tuple(i for i, a in enumerate(arrays)
                             if np.asarray(a).dtype.kind == "f")
            want = op_run(fn, arrays, diff, cpu)
            got = op_run(fn, arrays, diff, dev)
            err = 0.0
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                check(g.shape == w.shape, f"ops {name}: shape {g.shape} on "
                      f"the card, {w.shape} on the CPU")
                scale = max(float(np.abs(w).max()) if w.size else 0.0,
                            1e-30)
                e = float(np.abs(g - w).max()) / scale if w.size else 0.0
                check(e <= tol, f"ops {name}: the card differs from the CPU "
                      f"by {e:.3g} of the largest value (tolerance {tol})")
                err = max(err, e)
            worst[name] = err
    finally:
        CTX.training = prev
    print(f"ops: {len(cases)} cases over {len(public - OP_UNSWEPT)} autograd "
          f"functions, forward and backward on the card against the CPU, "
          f"largest relative error {max(worst.values()):.3g} "
          f"(tolerance {tol})", flush=True)
    return worst


def imagenet_model(name, tx, use_graph):
    """A full-width model of the ImageNet zoo (10 classes), compiled for
    training on ``tx``."""
    from singa_tpu_torch import models
    pkg, kw, _ = IMAGENET_ZOO[name]
    m = getattr(models, pkg).create_model(num_classes=10, **kw)
    m.compile([tx], is_train=True, use_graph=use_graph)
    return m


def imagenet_train(dev, name, tx, ty):
    """The zoo phases' runs (:func:`zoo_train_phase`) of one ImageNet
    model: eager unfused, eager fused twice (run to run), graphed; the
    gates of phase 13; the readings of :func:`zoo_readings`."""
    g_model = imagenet_model(name, tx, True)
    e_model = imagenet_model(name, tx, False)
    start = seeded_states(g_model, SEED + 31)
    per_step, groups = per_step_chunks(g_model)
    what = f"imagenet {name} float32 b{BATCH}"
    u = zoo_run(e_model, dev, start, tx, ty, IMAGENET_STEPS, fused=False)
    e2 = zoo_run(e_model, dev, start, tx, ty, IMAGENET_STEPS)
    e = zoo_run(e_model, dev, start, tx, ty, IMAGENET_STEPS)
    g = zoo_run(g_model, dev, start, tx, ty, IMAGENET_STEPS)
    run_to_run = states_diff(e["states"], e2["states"], f"{what} run to run")
    allowed = DETERMINISM_FACTOR * run_to_run
    fu = states_diff(e["states"], u["states"], what)
    check(not u["launches"] and fu <= allowed and
          (allowed > 0 or u["losses"] == e["losses"]),
          f"{what}: fused against unfused differs by {fu} (allowed "
          f"{allowed}); unfused launched {u['launches']}")
    ge = zoo_gates(what, g_model, g, e, per_step, IMAGENET_STEPS, allowed)
    check(all(v == v and abs(v) < float("inf") for v in g["losses"]),
          f"{what}: losses {g['losses']}")
    rec = {"batch": BATCH, "shape": list(SHAPE), "steps": IMAGENET_STEPS,
           "params": groups, "k1_multi_per_step": per_step,
           "losses": g["losses"], "run_to_run_max_abs": run_to_run,
           "fused_vs_unfused_max_abs": fu, "graph_vs_eager_max_abs": ge,
           "allowed": allowed, "states_held": len(g["states"]),
           "host_launches": g["launches"]}
    rec.update(zoo_readings(what, g_model, e_model, tx, ty, BATCH, per_step,
                            g, e, rounds=IMAGENET_ROUNDS,
                            steps=IMAGENET_ROUND_STEPS))
    held = "bitwise" if allowed == 0 else f"within {allowed:.3g}"
    print(zoo_line(f"imagenet train {name} f32 b{BATCH}", rec)
          + f"; fused == unfused and graph == eager {held} over "
          f"{rec['states_held']} states (run to run {run_to_run:.3g}); "
          "losses " + " ".join(f"{v:.5f}" for v in g["losses"]),
          flush=True)
    return rec, g_model


def imagenet_serve(dev, name, model):
    """``IMAGENET_REQUESTS`` requests through ``compile_serving(batch=32)``
    (graphed ticks) in f32 and bf16_mixed, fused against unfused under
    phase 4's gates, K2's launches per replayed tick counted in the trace
    and held to the model's tails; tick p50/p99, img/s and K2's share of
    the traced tick's device time."""
    import numpy as np
    from singa_tpu_torch.model import load_numpy_states
    tails = IMAGENET_ZOO[name][2]
    want = {"affine_relu": tails} if tails else {}
    model.eval()
    load_numpy_states(model, seeded_states(model, SEED + 32))
    rng = np.random.default_rng(SEED + 33)
    inputs = [rng.standard_normal(SHAPE, dtype=np.float32)
              for _ in range(IMAGENET_REQUESTS)]
    ticks = -(-IMAGENET_REQUESTS // BATCH)
    out = {}
    for policy in (None, "bf16_mixed"):
        pname = policy or "float32"
        r = serve(model, dev, inputs, policy, False, tails=want)
        check(sum(r["launches"].values()) == 0,
              f"imagenet serve {name} {pname}: the unfused run launched "
              f"K2: {r['launches']}")
        f = serve(model, dev, inputs, policy, True, tails=want)
        trace = LAST_PROFILE.copy()
        got, ref = f["logits"], r["logits"]
        check(got.shape == (IMAGENET_REQUESTS, 10) and
              np.isfinite(got).all(), f"imagenet serve {name} {pname}: "
              f"logits {got.shape}, or not finite")
        n = f["launches"]["affine_relu_nchw"]
        check(n == tails * ticks and sum(f["launches"].values()) == n,
              f"imagenet serve {name} {pname}: K2 launches {f['launches']} "
              f"in the trace, expected {tails} affine_relu x {ticks}")
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        check(scale > 0 and err <= REL_TOL[pname] * scale,
              f"imagenet serve {name} {pname}: K2 logits differ from the "
              f"unfused path by {err} (max |logit| {scale}, tolerance "
              f"{REL_TOL[pname]} x)")
        k2_ms = sum(v for k, v in trace["kernel_ms"].items()
                    if k.startswith("affine"))
        rec = {"policy": pname, "requests": IMAGENET_REQUESTS,
               "batch": BATCH, "ticks": ticks, "launches": f["launches"],
               "replays": f["replays"],
               "launches_per_replay": {k: v / f["replays"] for k, v in
                                       f["launches"].items() if v},
               "max_abs_err_vs_unfused": err, "max_abs_logit": scale,
               "img_per_s": IMAGENET_REQUESTS / f["seconds"],
               "unfused_img_per_s": IMAGENET_REQUESTS / r["seconds"],
               "tick_p50_ms": f["tick"]["p50_s"] * 1e3,
               "tick_p99_ms": f["tick"]["p99_s"] * 1e3,
               "unfused_tick_p50_ms": r["tick"]["p50_s"] * 1e3,
               "traced_busy_ms_per_tick": trace["busy_ms"] / f["replays"],
               "traced_k2_ms_per_tick": k2_ms / f["replays"],
               "k2_share_of_busy": k2_ms / trace["busy_ms"]
               if trace["busy_ms"] else 0.0}
        out[pname] = rec
        print(f"imagenet serve {name} NCHW {pname} b{BATCH} "
              f"x{IMAGENET_REQUESTS}: tick p50 {rec['tick_p50_ms']:.2f} ms "
              f"p99 {rec['tick_p99_ms']:.2f} ms img/s {rec['img_per_s']:.1f}"
              f" (unfused p50 {rec['unfused_tick_p50_ms']:.2f} ms); traced "
              f"tick busy {rec['traced_busy_ms_per_tick']:.3f} ms, K2 "
              f"{rec['traced_k2_ms_per_tick']:.3f} ms "
              f"({rec['k2_share_of_busy']:.3f}); K2 launches per tick "
              f"{rec['launches_per_replay']}; max_abs_err {err:.3g} (max "
              f"|logit| {scale:.3g})", flush=True)
        del r, f
    return out


def imagenet_zoo_phase(dev):
    """Phase 19: the op sweep on the card (:func:`op_sweep`), then each
    full-width model of ``IMAGENET_ZOO`` trained (:func:`imagenet_train`)
    and served (:func:`imagenet_serve`) at 224 px, b32, cuDNN
    deterministic."""
    import torch
    t0 = time.perf_counter()
    out = {"ops_max_rel_err": op_sweep(dev)}
    tx, ty = zoo_data(dev, SHAPE, BATCH, seed=SEED + 34)
    for name in IMAGENET_ZOO:
        t1 = time.perf_counter()
        rec, model = imagenet_train(dev, name, tx, ty)
        rec["serve"] = imagenet_serve(dev, name, model)
        rec["seconds"] = time.perf_counter() - t1
        out[name] = rec
        del model
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"imagenet zoo phase: {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 20: image files -> card --------------------------------------------

def write_image_dataset(root):
    """``IMAGE_FILES`` RGB JPEG files of ``IMAGE_SIDE`` px square (seeded
    numpy pixels, PIL's encoder) and a list file ``<name> <label>`` of
    ``IMAGE_CLASSES`` labels in ``root``; returns the list file's
    path."""
    import numpy as np
    from PIL import Image
    n, side, classes = IMAGE_FILES, IMAGE_SIDE, IMAGE_CLASSES
    rng = np.random.default_rng(SEED)
    lines = []
    for i in range(n):
        # smooth colour fields plus noise: JPEG-like content, not white
        # noise, so decode costs what a photo's would
        base = rng.integers(0, 256, (side // 16, side // 16, 3), np.uint8)
        img = Image.fromarray(base).resize((side, side), Image.BILINEAR)
        arr = np.asarray(img, np.int16) + rng.integers(
            -12, 13, (side, side, 3), np.int16)
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"img{i:04d}.jpg"), quality=90)
        lines.append(f"img{i:04d}.jpg {int(rng.integers(0, classes))}\n")
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def image_transform(path):
    """Decode, a random ``IMAGE_CROP`` crop and a random horizontal flip
    (``image_tool.ImageTool``), scaled to [-1, 1], CHW float32. The
    stdlib ``random`` that ImageTool draws from is seeded from the file's
    name, so an image's augmentation is the same in a thread worker, a
    forked worker and a resumed iterator."""
    import random
    import numpy as np
    from singa_tpu_torch import image_tool
    random.seed(f"{IMAGE_SEED}/{os.path.basename(path)}")
    tool = image_tool.ImageTool().load(path)
    tool.random_crop((IMAGE_CROP, IMAGE_CROP)).flip()
    return [np.asarray(im, np.float32).transpose(2, 0, 1) / 127.5 - 1.0
            for im in tool.get()]


class Recorder:
    """An iterator over ``inner``'s batches that keeps a copy of each
    (images, labels, ids) and passes the state protocol through."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = []

    def __iter__(self):
        iter(self.inner)
        return self

    def __next__(self):
        x, y = next(self.inner)
        self.batches.append((x.copy(), y.copy(),
                             self.inner.last_batch_ids.copy()))
        return x, y

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)


def tracking(batches, pf, states):
    """``batches`` (a DevicePrefetcher's iterator), appending
    ``pf.state_dict()`` as each batch is handed out."""
    for b in batches:
        states.append(pf.state_dict())
        yield b


def piped_steps(model, dev, list_path, n):
    """The device ms of ``n`` steps of ``model`` fed by a fresh
    iterator through ``DevicePrefetcher`` (:func:`fed_steps`); the
    worker is ended after."""
    from singa_tpu_torch.data import DevicePrefetcher
    it = image_iter(list_path)
    g = iter(DevicePrefetcher(it, dev, depth=IMAGE_PREFETCH_DEPTH))
    try:
        return fed_steps(model, g, n)[1]
    finally:
        g.close()
        it.end()


def image_files_line(out, card):
    p, d, t = out["pipeline"], out["direct"], out["traced"]
    return (f"image files ({card}): {out['files']} JPEGs "
            f"{out['side']}px -> ResNet-50 b{out['batch']} f32 graphed; "
            f"host alone {out['host_img_per_s_thread']:.1f} img/s "
            f"(thread), {out['host_img_per_s_process']:.1f} (process); "
            f"step p50 {p['step_p50_ms']:.3f} ms fed by the pipeline "
            f"({p['img_per_s']:.1f} img/s) against "
            f"{d['step_p50_ms']:.3f} ms fed directly "
            f"({d['img_per_s']:.1f} img/s); traced replays: idle "
            f"{t['idle_share']:.3f}, busy {t['busy_ms']:.3f} ms, wall "
            f"{t['wall_ms']:.3f} ms, K1-multi {t['sgd_multi_per_replay']:g}"
            f" per replay, batch copies on streams {t['copy_streams']} "
            f"(step stream {t['step_stream']}), {t['copy_names']}; "
            f"benchmark.py b{out['batch']}: "
            f"{out['benchmark_example']['throughput']:.2f} img/s; "
            f"gates: {out['states_held']} states and {IMAGE_STEPS} losses "
            f"bitwise, {out['resumed_batches_held']} resumed batches, "
            f"{out['process_batches_held']} process-mode batches; "
            f"{out['seconds']:.1f} s")


def image_iter(list_path, use_process=False):
    """The phase's iterator over the list file (batches of ``BATCH``)."""
    from singa_tpu_torch.data import ImageBatchIter
    return ImageBatchIter(list_path, BATCH, image_transform, shuffle=True,
                          image_folder=os.path.dirname(list_path),
                          seed=IMAGE_SEED, use_process=use_process,
                          capacity=IMAGE_QUEUE)


def host_batches(list_path, n, use_process=False):
    """``n`` batches of a fresh iterator, and images/s of the host alone
    (decode and augment; the first batch, which starts the worker, is
    left out of the rate)."""
    it = image_iter(list_path, use_process)
    it.start()
    try:
        out = [next(it)]
        ids = [it.last_batch_ids.copy()]
        t0 = time.perf_counter()
        for _ in range(n - 1):
            out.append(next(it))
            ids.append(it.last_batch_ids.copy())
        rate = (n - 1) * BATCH / (time.perf_counter() - t0)
    finally:
        it.end()
    return [(x, y, i) for (x, y), i in zip(out, ids)], rate


def image_model(dev, start=None):
    """ResNet-50 (10 classes) compiled for graphed training on a zero
    batch, with the fused SGD of the training phases, from ``start``
    (numpy states) when given."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import resnet
    from singa_tpu_torch.tensor import Tensor
    m = resnet.resnet50(num_classes=IMAGE_CLASSES)
    m.compile([Tensor(data=torch.zeros((BATCH,) + SHAPE,
                                       device=dev.torch_device),
                      device=dev)], is_train=True, use_graph=True)
    if start is not None:
        load_numpy_states(m, start)
    m.set_optimizer(graph_sgd(opt))
    m.train()
    return m


def fed_steps(model, batches, steps):
    """``steps`` train calls on ``batches`` (tuples of Tensors, or an
    iterator of them); returns the losses (device tensors), the batches
    as fed, and the device ms of each step from the end of the one
    before (CUDA events: the step and any wait for its data)."""
    import torch
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    ends[0].record()
    for i, (tx, ty) in zip(range(steps), batches):
        _, loss = model(tx, ty)
        ends[i + 1].record()
        losses.append(loss.data.detach())
    torch.cuda.synchronize()
    check(len(losses) == steps, f"fed {len(losses)} of {steps} batches")
    return losses, [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]


def direct(dev, recorded):
    """The recorded numpy batches as Tensors made one at a time, as a
    training loop without the pipeline makes them."""
    from singa_tpu_torch.tensor import Tensor
    for x, y, _ in recorded:
        yield Tensor(data=x, device=dev), Tensor(data=y, device=dev)


def copy_streams(trace_path, what):
    """From a ``torch.profiler`` chrome trace whose window opens at the
    first ``spin_kernel`` (one marker launched on the current stream
    before each step; the padding before it is fills): the step's stream
    (the markers'), each batch copy to the card in the window (host to
    device, the image and label batch sizes) with its stream and whether
    it read pinned memory, the device's busy ms (kernels and copies) and
    wall ms over the window, and the port's kernels by counter key."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    marks = [e for e in spans if "spin_kernel" in e["name"]]
    streams = {e["args"]["stream"] for e in marks}
    check(len(streams) == 1, f"{what}: the step markers ran on streams "
          f"{sorted(streams)}, expected one")
    start = min(e["ts"] for e in marks)
    work = [e for e in spans if e["ts"] >= start
            and "spin_kernel" not in e["name"]]
    image_bytes = BATCH * 3 * IMAGE_CROP * IMAGE_CROP * 4
    copies = [{"bytes": e["args"].get("bytes"), "stream":
               e["args"]["stream"], "name": e["name"]}
              for e in work if e["cat"] == "gpu_memcpy"
              and "HtoD" in e["name"]
              and e["args"].get("bytes") in (image_bytes, BATCH * 4)]
    busy = sum(e["dur"] for e in work) / 1e3
    wall = (max(e["ts"] + e["dur"] for e in work) - start) / 1e3
    kernels = {}
    for e in work:
        key = port_kernel(e["name"]) if e["cat"] == "kernel" else None
        if key is not None:
            kernels[key] = kernels.get(key, 0) + 1
    return streams.pop(), copies, busy, wall, kernels


def traced_pipeline(dev, model, list_path, steps, what, attempts=5):
    """``steps`` pipeline-fed replays under ``torch.profiler``, the host
    counts zeroed just before: gate 4 on its chrome trace (every batch
    copy on a stream other than the step's, from pinned memory),
    K1-multi's launches counted in the trace (2 per replayed step, none
    on the host), and the device's idle share over the replays. The
    session opens with ``PROFILE_PAD`` fills on the current stream and on
    the copies' side stream (a session late in a run has been seen to
    lose its first device records of a stream), then each step is a
    marker spin on the current stream, the pull of its batch (which
    starts the copies of a later one) and the step."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch.data import DevicePrefetcher
    pad = torch.zeros(1, device=dev.torch_device)
    for attempt in range(attempts):
        it = image_iter(list_path)
        pf = DevicePrefetcher(it, dev, depth=IMAGE_PREFETCH_DEPTH)
        g = iter(pf)
        try:
            model(*next(g))             # the worker and the ring warm
            torch.cuda.synchronize()
            zero_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for stream in (torch.cuda.current_stream(),
                               pf.copy_stream):
                    with torch.cuda.stream(stream):
                        for _ in range(PROFILE_PAD):
                            pad.fill_(0)
                torch.cuda.synchronize()
                for _ in range(steps):
                    torch.cuda._sleep(10)
                    model(*next(g))
                torch.cuda.synchronize()
            host = host_launches()
        finally:
            g.close()
            it.end()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            stream, copies, busy, wall, kernels = copy_streams(path, what)
        want = {"sgd_multi": 2 * steps}
        if kernels == want and len(copies) == 2 * steps:
            break
        print(f"profiler session {attempt + 1} of {what}: kernels "
              f"{kernels}, {len(copies)} batch copies, expected {want} "
              f"and {2 * steps}", flush=True)
    else:
        raise SmokeFailure(f"{what}: no complete profiler session in "
                           f"{attempts}")
    bad = [c for c in copies if c["stream"] == stream
           or "Pinned" not in c["name"]]
    check(not bad, f"{what}: batch copies on the step's stream {stream} "
          f"or from pageable memory: {bad[:3]}")
    check(not host, f"{what}: replays counted {host} on the host")
    return {"step_stream": stream, "copy_streams":
            sorted({c["stream"] for c in copies}),
            "copies": len(copies), "copy_names":
            sorted({c["name"] for c in copies}),
            "busy_ms": busy / steps, "wall_ms": wall / steps,
            "idle_share": 1.0 - busy / wall,
            "sgd_multi_per_replay": kernels["sgd_multi"] / steps,
            "replays": steps}


def bench_example(args):
    """``singa_tpu_torch/examples/benchmark.py``'s ``main(args)``, run in
    this process; returns its result."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "port_benchmark_example",
        os.path.join(HERE, "singa_tpu_torch", "examples", "benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(args)


def image_files_phase(dev):
    """Phase 20: training ResNet-50 from image files on disk. A seeded
    dataset (``IMAGE_FILES`` JPEGs of ``IMAGE_SIDE`` px, ``IMAGE_CLASSES``
    classes, a list file) in a temporary directory; ``ImageBatchIter``
    (thread worker, shuffled, seed ``IMAGE_SEED``, ``image_transform``)
    through ``DevicePrefetcher(depth=IMAGE_PREFETCH_DEPTH)`` feeds
    ``IMAGE_STEPS`` graphed fused-SGD steps of ResNet-50 (224 px, b32,
    f32; the caller sets TF32 off and cuDNN deterministic). Gates: (1)
    the losses and every final state bitwise equal to the same model fed
    the very numpy batches the iterator yielded, as Tensors made
    directly; K1-multi's host launches those of the eager call and the
    capture; (2) an iterator and prefetcher resumed from the state after
    step ``IMAGE_RESUME_AT`` yield the later batches bitwise; (3) a
    forked worker (``use_process=True``) yields the thread worker's
    batches; (4) in a trace of pipeline-fed replays each batch copy runs
    on a stream other than the step's and reads pinned memory.
    Readings: the iterator's images/s on the host alone (thread and
    process workers), step p50 fed by the pipeline and directly, the idle
    share of the traced replays, K1-multi per replay, and
    ``examples/benchmark.py``'s throughput at b32."""
    import tempfile
    import numpy as np
    import torch
    from singa_tpu_torch.data import DevicePrefetcher
    from singa_tpu_torch.model import load_numpy_states
    t0 = time.perf_counter()
    out = {"files": IMAGE_FILES, "side": IMAGE_SIDE, "crop": IMAGE_CROP,
           "batch": BATCH, "steps": IMAGE_STEPS}
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        list_path = write_image_dataset(root)
        out["write_s"] = time.perf_counter() - t1
        n_host = IMAGE_FILES // BATCH
        thread_batches, out["host_img_per_s_thread"] = host_batches(
            list_path, n_host)
        proc_batches, out["host_img_per_s_process"] = host_batches(
            list_path, n_host, use_process=True)
        # gate 3: the forked worker's batches are the thread worker's
        for i, (a, b) in enumerate(zip(thread_batches, proc_batches)):
            check(all(np.array_equal(u, v) for u, v in zip(a, b)) and
                  a[0].dtype == b[0].dtype,
                  f"image files: process-mode batch {i} differs from the "
                  "thread worker's")
        out["process_batches_held"] = len(proc_batches)

        piped = image_model(dev)
        start = seeded_states(piped, SEED + 40)
        load_numpy_states(piped, start)
        fed = image_model(dev, start)

        # gate 1: pipeline-fed against directly fed, bitwise
        rec = Recorder(image_iter(list_path))
        pf = DevicePrefetcher(rec, dev, depth=IMAGE_PREFETCH_DEPTH)
        states = []
        zero_counts()
        g = iter(pf)
        losses, _ = fed_steps(piped, tracking(g, pf, states), IMAGE_STEPS)
        host = host_launches()
        g.close()
        rec.inner.end()
        recorded = rec.batches[:IMAGE_STEPS]
        check(host == {"sgd_multi": 4},
              f"image files: host launches {host}, expected 2 sgd_multi "
              "at the eager call and 2 at the capture")
        d_losses, _ = fed_steps(fed, direct(dev, recorded), IMAGE_STEPS)
        piped_l = [float(v) for v in losses]
        fed_l = [float(v) for v in d_losses]
        check(piped_l == fed_l and all(np.isfinite(piped_l)),
              f"image files: pipeline-fed losses {piped_l} against "
              f"directly fed {fed_l}")
        out["states_held"] = held_equal(piped, fed, "image files")
        out["losses"] = piped_l
        stats = list(piped.graph_stats().values())
        check(stats == [{"n_captures": 1, "n_replays": IMAGE_STEPS - 1}],
              f"image files: graph {stats}")
        check(states[IMAGE_RESUME_AT - 1]["position"]
              == IMAGE_RESUME_AT * BATCH,
              f"image files: state after step {IMAGE_RESUME_AT} is "
              f"{states[IMAGE_RESUME_AT - 1]}")

        # gate 2: a resume from the state after step IMAGE_RESUME_AT
        it = image_iter(list_path)
        res = DevicePrefetcher(it, dev, depth=IMAGE_PREFETCH_DEPTH)
        res.load_state_dict(states[IMAGE_RESUME_AT - 1])
        g = iter(res)
        try:
            for i in range(IMAGE_RESUME_AT, IMAGE_STEPS):
                tx, ty = next(g)
                x, y, _ = recorded[i]
                check(np.array_equal(tx.data.cpu().numpy(), x) and
                      np.array_equal(ty.data.cpu().numpy(), y),
                      f"image files: resumed batch {i + 1} differs")
        finally:
            g.close()
            it.end()
        out["resumed_batches_held"] = IMAGE_STEPS - IMAGE_RESUME_AT

        # timing: pipeline-fed against directly fed, alternating rounds
        feeds = {"pipeline": lambda n: piped_steps(piped, dev, list_path,
                                                   n),
                 "direct": lambda n: fed_steps(
                     fed, direct(dev, thread_batches[:n]), n)[1]}
        times = alternating_rounds(feeds, IMAGE_ROUNDS, IMAGE_ROUND_STEPS)
        for name, ms in times.items():
            q = quantiles(ms)
            out[name] = {"step_p50_ms": q["p50_ms"],
                         "step_p99_ms": q["p99_ms"], "steps_timed": q["n"],
                         "step_ms": ms,
                         "img_per_s": BATCH * len(ms) / (sum(ms) / 1e3)}
        # gate 4 and the idle share, in a trace of pipeline-fed replays
        out["traced"] = traced_pipeline(dev, piped, list_path,
                                        IMAGE_TRACED, "image files traced")
        del piped, fed
        torch.cuda.empty_cache()
    out["benchmark_example"] = bench_example(
        ["--bs", str(BATCH), "--iters", str(IMAGE_BENCH_ITERS),
         "--warmup", "3"])
    out["seconds"] = time.perf_counter() - t0
    print(image_files_line(out, card_line()), flush=True)
    return out


# -- phase 21: the LM on a mesh ------------------------------------------------

class DropRematNet:
    """A two-layer net whose hidden layer drops half its units, inside a
    block that ``autograd.checkpoint`` rematerialises (``remat``) or not:
    the masks of a rematerialised block must be the forward's."""

    @staticmethod
    def make(remat):
        from singa_tpu_torch import autograd, layer, model

        class Block(layer.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = layer.Linear(512)
                self.drop = layer.Dropout(0.5)
                self.fc2 = layer.Linear(10)

            def forward(self, x):
                return self.fc2(self.drop(autograd.relu(self.fc1(x))))

        class Net(model.Model):
            def __init__(self):
                super().__init__()
                self.block = Block()
                self.loss_fn = layer.SoftMaxCrossEntropy()

            def forward(self, x):
                return autograd.checkpoint(self.block, x) if remat \
                    else self.block(x)

            def train_one_batch(self, x, y):
                out = self.forward(x)
                loss = self.loss_fn(out, y)
                self.optimizer(loss)
                return out, loss

        return Net()


def dropout_remat_check(dev):
    """The dropout net rematerialised against not, eager and graphed, 4
    steps each from the same weights and device-generator seed: losses
    and parameters bitwise."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.tensor import Tensor
    rng = np.random.default_rng(SEED + 40)
    x = Tensor(data=rng.standard_normal((64, 256), dtype=np.float32),
               device=dev)
    y = Tensor(data=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)],
               device=dev)
    start = None
    out = {}
    for graph in (False, True):
        runs = {}
        for remat in (False, True):
            m = DropRematNet.make(remat)
            m.set_optimizer(opt.SGD(lr=0.1))
            m.compile([x], is_train=True, use_graph=graph)
            start = start or seeded_states(m, SEED + 41)
            load_numpy_states(m, start)
            dev.SetRandSeed(SEED + 42)
            losses = [m(x, y)[1].data.detach().clone() for _ in range(4)]
            runs[remat] = (torch.stack(losses), {
                k: v.data.detach().clone()
                for k, v in m.get_params().items()})
        same = torch.equal(runs[False][0], runs[True][0]) and all(
            torch.equal(runs[False][1][k], runs[True][1][k])
            for k in runs[False][1])
        what = "graphed" if graph else "eager"
        check(same, f"remat dropout {what}: the rematerialised net's "
              f"losses {runs[True][0].tolist()} or parameters differ from "
              f"the plain net's {runs[False][0].tolist()}")
        out[what] = {"bitwise": same,
                     "losses": runs[True][0].tolist()}
    return out


def lm_remat_phase(dev, tx, ty, start):
    """Phase 21 (a): ``LM_MESH_STEPS`` graphed fused-SGD steps of the LM
    with ``remat=True`` against the same steps without, f32 and
    ``compute_dtype=bfloat16``, from ``start``: losses and states bitwise,
    else the LM's gates (phase 12's rule, the reason printed); in a trace
    of replays K3 launches twice per block (12 a step), K4 once. Readings:
    step p50/p99 in alternating rounds and peak memory above the start.
    Returns the records and the f32 graphed model without remat (phase
    21 (b) times against it)."""
    import numpy as np
    import torch
    layers = LM["layers"]
    sgd = multi_chunks("sgd_multi", LM_PARAMS_PER_STEP)
    out = {"dropout": dropout_remat_check(dev)}
    keep = None
    for dname, cdt in (("float32", None), ("bfloat16", torch.bfloat16)):
        models = {"plain": lm_model(dev, tx, cdt, use_graph=True),
                  "remat": lm_model(dev, tx, cdt, use_graph=True,
                                    remat=True)}
        runs = {n: lm_graph_run(m, start, tx, ty, LM_MESH_STEPS)
                for n, m in models.items()}
        p, r = runs["plain"], runs["remat"]
        rel = {k: ((r["params"][k].float() - v.float()).norm()
                   / v.float().norm()).item()
               for k, v in p["params"].items()}
        worst = max(rel, key=rel.get)
        bitwise = r["losses"] == p["losses"] and rel[worst] == 0.0
        reason = "bitwise" if bitwise else (
            f"not bitwise: losses {r['losses']} against {p['losses']}, "
            f"{worst} by {rel[worst]:.3g}; held to the LM's gates")
        if not bitwise:
            print(f"remat LM {dname}: {reason}", flush=True)
            check(all(np.isfinite(r["losses"])) and
                  r["losses"][-1] < r["losses"][0] and
                  rel[worst] <= LM_PARAM_TOL,
                  f"remat LM {dname}: {reason} (tolerance {LM_PARAM_TOL})")
        for name, m in models.items():
            stats = list(m.graph_stats().values())
            check(stats == [{"n_captures": 1,
                             "n_replays": LM_MESH_STEPS - 1}],
                  f"remat LM {dname} {name}: {stats}")
        per_step = {"plain": {"flash_fwd": layers, "flash_bwd_dq": layers,
                              "flash_bwd_dkv": layers, "sgd_multi": sgd},
                    "remat": {"flash_fwd": 2 * layers,
                              "flash_bwd_dq": layers,
                              "flash_bwd_dkv": layers, "sgd_multi": sgd}}
        trace = {n: traced(lambda m=m: m(tx, ty), LM_MESH_TRACED,
                           per_step[n], f"remat LM {dname} {n} replays")
                 for n, m in models.items()}
        for n in models:
            check(not trace[n]["host_launches"],
                  f"remat LM {dname} {n}: replays counted "
                  f"{trace[n]['host_launches']} on the host")
        times = alternating_rounds(
            {n: (lambda k, m=m: timed_steps(m, tx, ty, k))
             for n, m in models.items()},
            LM_MESH_ROUNDS, LM_GRAPH_ROUND_STEPS)
        rec = {"compute_dtype": dname, "steps": LM_MESH_STEPS,
               "bitwise": bitwise, "reason": reason,
               "max_param_rel_diff": rel, "max_param_rel_diff_at": worst, "losses": r["losses"], "plain_losses": p["losses"]}
        for n in models:
            q = quantiles(times[n])
            rec[n] = {"step_p50_ms": q["p50_ms"], "step_p99_ms": q["p99_ms"],
                      "step_ms": times[n],
                      "peak_above_start_bytes":
                      runs[n]["peak_above_start_bytes"],
                      "launches_per_replay": {
                          k: v / LM_MESH_TRACED
                          for k, v in trace[n]["launches"].items()},
                      "traced": trace[n]}
        out[dname] = rec
        pr, rr = rec["plain"], rec["remat"]
        print(f"remat LM {dname} B{LM['batch']} S{LM['seq']}: {reason}; "
              f"step p50 {rr['step_p50_ms']:.2f} ms p99 "
              f"{rr['step_p99_ms']:.2f} against {pr['step_p50_ms']:.2f} / "
              f"{pr['step_p99_ms']:.2f} without remat ({LM_MESH_ROUNDS} "
              f"alternating rounds of {LM_GRAPH_ROUND_STEPS}); peak above "
              f"the start {rr['peak_above_start_bytes'] / 2**30:.2f} GiB "
              f"against {pr['peak_above_start_bytes'] / 2**30:.2f}; per "
              f"replay K3 {rr['launches_per_replay']['flash_fwd']:.0f} "
              f"against {pr['launches_per_replay']['flash_fwd']:.0f}, K4 "
              f"{rr['launches_per_replay']['flash_bwd_dq']:.0f} against "
              f"{pr['launches_per_replay']['flash_bwd_dq']:.0f}", flush=True)
        if dname == "float32":
            keep = (models["plain"], p["losses"][0])
        del models, runs
        torch.cuda.empty_cache()
    print(f"remat dropout net: eager and graphed bitwise with the plain "
          f"net ({out['dropout']})", flush=True)
    return out, keep


def lm_mixed_phase(dev, tx, ty, start, f32_model, f32_first_loss,
                   what="bf16_mixed LM", **kw):
    """Phase 21 (b) (and 22 (c) with the MoE settings ``kw``, labelled
    ``what``): the LM compiled with ``policy="bf16_mixed"`` (the
    fused SGD inside the guard), graphed, ``LM_MESH_STEPS`` steps from
    ``start``, the last one poisoned: an LM's inputs are token ids, which
    no NaN reaches (an id out of range is a zero row), so the guard's
    loss scale (the backward's seed) is set to NaN just before it, and
    every gradient is NaN. Gates: the first loss within
    ``LM_MIXED_LOSS_RTOL`` of the f32 run's; one capture; the poisoned
    replay changes no state (bitwise) and counts one skip. Readings: step
    p50 against the f32 graphed step (alternating rounds) and peak
    memory."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    m = lm_model(dev, tx, use_graph=True, policy="bf16_mixed", **kw)
    load_numpy_states(m, start)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    guard = m.optimizer
    check(hasattr(guard, "dynamic_loss_scale"),
          f"{what}: the optimizer is {type(guard).__name__}, not "
          "the guard")
    m.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = []
    for step in range(1, LM_MESH_STEPS + 1):
        if step == LM_MESH_STEPS:
            before = live_states(m)
            skipped = guard.stats()["skipped_total"]
            scale = guard.inner.loss_scale.data.clone()
            guard.inner.loss_scale.data.fill_(float("nan"))
        losses.append(float(m(tx, ty)[1].data.detach()))
    peak = torch.cuda.max_memory_allocated() - base
    after = live_states(m)
    moved = [k for k in before if not k.startswith(
        ("optimizer/loss_scale", "optimizer/guard/"))
        and not torch.equal(before[k], after[k])]
    stats = guard.stats()
    check(not moved and stats["skipped_total"] == skipped + 1,
          f"{what}: the poisoned replay moved {moved[:5]} or "
          f"skipped {stats['skipped_total'] - skipped} steps")
    guard.inner.loss_scale.data.copy_(scale)
    graphs = list(m.graph_stats().values())
    check(graphs == [{"n_captures": 1, "n_replays": LM_MESH_STEPS - 1}],
          f"{what}: {graphs}")
    rel = abs(losses[0] - f32_first_loss) / abs(f32_first_loss)
    check(rel <= LM_MIXED_LOSS_RTOL,
          f"{what}: first loss {losses[0]} against the f32 run's "
          f"{f32_first_loss} (rtol {LM_MIXED_LOSS_RTOL})")
    times = alternating_rounds(
        {"bf16_mixed": lambda k: timed_steps(m, tx, ty, k),
         "float32": lambda k: timed_steps(f32_model, tx, ty, k)},
        LM_MESH_ROUNDS, LM_GRAPH_ROUND_STEPS)
    q, qf = quantiles(times["bf16_mixed"]), quantiles(times["float32"])
    rec = {"losses": losses, "first_loss_rel_diff_vs_f32": rel,
           "poisoned_step": LM_MESH_STEPS, "skipped_total":
           stats["skipped_total"], "step_p50_ms": q["p50_ms"],
           "f32_step_p50_ms": qf["p50_ms"], "step_ms": times["bf16_mixed"],
           "peak_above_start_bytes": peak}
    if kw.get("moe"):
        check(all(b.mlp.wg.dtype == torch.float32 for b in m.blocks),
              f"{what}: a router is not f32")
    print(f"{what} B{LM['batch']} S{LM['seq']}: first loss "
          f"{losses[0]:.6f} (f32 {f32_first_loss:.6f}, rel {rel:.3g}); "
          f"step {LM_MESH_STEPS} poisoned: no state moved, 1 skip; step "
          f"p50 {q['p50_ms']:.2f} ms against f32 {qf['p50_ms']:.2f} ms; "
          f"peak above the start {peak / 2**30:.2f} GiB", flush=True)
    del m
    torch.cuda.empty_cache()
    return rec


def lm_generate_phase(dev, tx, start, what="generate", **kw):
    """Phase 21 (c) (and 22 (d) with the MoE settings ``kw``, labelled
    ``what``): greedy ``generate`` of ``GEN_NEW`` tokens from the
    first ``GEN_PROMPT`` tokens of the b8 batch, f32. At each step the
    decode's logits must be within ``LM_LOGIT_TOL`` of the full forward's
    (through K3) at the last position, and its token the forward's argmax
    up to the first step whose top-2 margin is under that tolerance. A
    MoE decode runs a drop-free capacity (cf = E), so the full forwards
    it is held to run at that capacity too (the JAX package's rule: the
    two agree wherever the forward drops nothing). Readings: prefill ms,
    per-token ms p50, tokens/s."""
    import numpy as np
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.tensor import Tensor
    m = lm_model(dev, tx, train=False, **kw)
    load_numpy_states(m, start)
    m.eval()
    if m.moe:
        for blk in m.blocks:
            blk.mlp.capacity_factor = float(blk.mlp.n_experts)
    prompt = tx.data[:, :GEN_PROMPT].cpu().numpy().astype(np.int32)
    marks = [torch.cuda.Event(enable_timing=True)]
    logits = []

    def mark(step_logits):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        logits.append(step_logits)
    transformer._decode(m, prompt, 4, temperature=0)     # warm-up
    torch.cuda.synchronize()
    marks[0].record()
    tokens = transformer._decode(m, prompt, GEN_NEW, temperature=0,
                                 on_token=mark)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    tol = LM_LOGIT_TOL["float32"]
    worst = 0.0
    # per row: the first step whose top-2 margin is under the tolerance
    diverged = [None] * LM["batch"]
    at.reset_counts()
    for i in range(GEN_NEW):
        cur = tokens[:, :GEN_PROMPT + i]
        full = m(Tensor(data=cur.astype(np.float32), device=dev)).data[:, -1]
        scale = full.abs().max().item()
        err = (logits[i] - full).abs().max().item()
        worst = max(worst, err / scale)
        check(err <= tol * scale,
              f"{what}: step {i} logits differ from the full forward's by "
              f"{err} (max |logit| {scale}, tolerance {tol} x)")
        top2 = torch.topk(full, 2, -1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        want = torch.argmax(full, -1).cpu().numpy()
        for b in range(LM["batch"]):
            if diverged[b] is None and margins[b] < tol * scale:
                diverged[b] = i
            if diverged[b] is None:
                check(tokens[b, GEN_PROMPT + i] == want[b],
                      f"{what}: row {b} step {i} token "
                      f"{tokens[b, GEN_PROMPT + i]} against the forward's "
                      f"argmax {want[b]} (top-2 margin {margins[b]})")
    k3 = at.launches["flash_fwd"]
    check(k3 == GEN_NEW * LM["layers"],
          f"{what}: the full forwards launched K3 {k3} times")
    total = sum(ms)
    rec = {"prompt": GEN_PROMPT, "new": GEN_NEW, "batch": LM["batch"],
           "prefill_ms": ms[0], "token_ms": ms[1:],
           "token_p50_ms": quantiles(ms[1:])["p50_ms"],
           "tokens_per_s": LM["batch"] * GEN_NEW / (total / 1e3),
           "max_logit_rel_err": worst, "tolerance": tol,
           "first_step_under_margin_by_row": diverged}
    print(f"{what} B{LM['batch']} prompt {GEN_PROMPT} + {GEN_NEW} greedy: "
          f"prefill {rec['prefill_ms']:.2f} ms, per token p50 "
          f"{rec['token_p50_ms']:.3f} ms, {rec['tokens_per_s']:.0f} "
          f"tokens/s; logits within {worst:.3g} x max |logit| of the full "
          f"forward (tolerance {tol}); tokens the forward's argmax up to "
          f"each row's first step whose top-2 margin is under the "
          f"tolerance: {diverged} (None: none)", flush=True)
    del m, logits
    torch.cuda.empty_cache()
    return rec


def ring_reading(dev):
    """The K3 ring reading: one ring hop of the LM at sp=2 (``RING_SHAPE``
    f32) with ``pos_delta`` 0 and -512 against its plain version at the
    flash gates, timed (CUDA events, device), its bound over the unmasked
    pairs (4 D flops each; bytes when none is unmasked), and SDPA's
    device time on the same shapes with the equivalent boolean mask."""
    import torch
    import torch.nn.functional as F
    from singa_tpu_torch.ops import attention as at
    B, H, S, D = RING_SHAPE
    recs = []
    for delta in RING_DELTAS:
        rec, (q, k, v, _g, _o, _l, scale) = flash_case(
            dev, B, H, S, S, D, torch.float32, True, pos_delta=delta,
            seed=SEED + 50)
        i = torch.arange(S, device=q.device)
        mask = i[None, :] <= i[:, None] + delta
        pairs = B * H * int(mask.sum())
        flops = 4 * D * pairs
        nbytes = 4 * B * H * S * D * 4 + B * H * S * 4
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update({
            "delta": delta, "unmasked_pairs": pairs,
            "ms": time_ms(lambda: at.flash_fwd(q, k, v, True, scale,
                                               pos_delta=delta)),
            "device_ms": device_ms(
                lambda: at.flash_fwd(q, k, v, True, scale, pos_delta=delta),
                FLASH_KERNEL_NAME["float32"]["flash_fwd"]),
            "plain_ms": time_ms(lambda: at._scan_flash_fwd(
                q, k, v, True, scale, pos_delta=delta), iters=5, warmup=1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), ""),
            "library": "scaled_dot_product_attention with the boolean mask "
            "(device time)"})
        recs.append(rec)
        print(f"kernel flash_fwd ring hop {RING_SHAPE} f32 pos_delta={delta}:"
              f" {pairs} unmasked pairs, kernel_ms={rec['ms']:.4f} (device "
              f"{rec['device_ms']:.4f}) plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
              f"library_ms={rec['library_ms']:.4f} (SDPA, boolean mask)",
              flush=True)
    return recs


def lm_rank_phase(dev, tx, ty, start):
    """Phase 21 (d): ``DIST_RANKS`` processes of this script
    (:func:`lm_rank_main`) on the one card over gloo, eager, each
    ``LM_RANK_STEPS`` steps of the LM on the global batch under each mesh
    of ``LM_RANK_RUNS``, each held by the rank against its own dense run
    of the same batch from ``start`` (one process, no mesh): losses within
    ``LM_RANK_LOSS_RTOL``, the gathered parameters and momenta within
    ``LM_RANK_STATE_TOL`` (:func:`_state_rel`). K3 at every step and rank:
    2 launches with ``pos_delta`` per attention call (ring), 1 on the full
    sequence (Ulysses, tp). The ``LM_RANK_PLANTED`` run again with its
    ring hops' delta off by S_local must fail that gate. Readings by kind:
    collectives per step and the host-staged ones."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        np.savez(os.path.join(work, "inputs.npz"),
                 ids=tx.data.cpu().numpy(), tgt=ty.data.cpu().numpy(),
                 **{f"start/{k}": v for k, v in start.items()})
        t0 = time.perf_counter()
        outs = run_ranks("--lm-rank", work, "lm mesh gloo")
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    layers = LM["layers"]
    want_k3 = {"tp": (layers, layers, 0), "tp_fused": (layers, layers, 0),
               "sp_ring": (2 * layers, 0, 2 * layers),
               "sp_ulysses": (layers, layers, 0)}
    rec = {"backend": "gloo", "ranks": DIST_RANKS, "seconds": seconds,
           "steps": LM_RANK_STEPS, "loss_rtol": LM_RANK_LOSS_RTOL,
           "state_tolerance": LM_RANK_STATE_TOL, "floor": LM_RANK_FLOOR}

    def held(o, name):
        losses, dense = o[f"{name}/losses"], o[f"{name}/dense_losses"]
        rel = np.abs(losses - dense) / np.abs(dense)
        worst = {kind: float(o[f"{name}/max_{kind}_rel"])
                 for kind in ("param", "momentum")}
        ok = bool(np.all(rel <= LM_RANK_LOSS_RTOL)) and \
            max(worst.values()) <= LM_RANK_STATE_TOL
        return ok, {
            "losses": losses.tolist(), "dense_losses": dense.tolist(),
            "max_loss_rel": float(rel.max()),
            "max_param_rel": worst["param"],
            "max_param_at": str(o[f"{name}/max_param_at"]),
            "max_momentum_rel": worst["momentum"],
            "max_momentum_at": str(o[f"{name}/max_momentum_at"]),
            "top_params": o[f"{name}/top_param"].tolist(),
            "top_momenta": o[f"{name}/top_momentum"].tolist()}

    for name in LM_RANK_RUNS:
        runs = []
        for r, o in enumerate(outs):
            ok, run = held(o, name)
            check(ok, f"lm mesh {name} rank {r}: losses {run['losses']} "
                  f"against the dense {run['dense_losses']} (rtol "
                  f"{LM_RANK_LOSS_RTOL}), a parameter "
                  f"{run['max_param_rel']:.3g} off ({run['max_param_at']})"
                  f", a momentum {run['max_momentum_rel']:.3g} off ("
                  f"{run['max_momentum_at']}; tolerance "
                  f"{LM_RANK_STATE_TOL})")
            k3 = [tuple(int(v) for v in step)
                  for step in o[f"{name}/k3_per_step"]]
            check(all(step == want_k3[name] for step in k3),
                  f"lm mesh {name} rank {r}: K3, K4-dQ and K3-with-"
                  f"pos_delta launches at each step {k3}, expected "
                  f"{want_k3[name]} at every step")
            run.update({
                "k3_k4dq_ring_per_step": [list(step) for step in k3],
                "ring_launches": sum(step[2] for step in k3),
                "collectives_per_step": dict(zip(
                    o["kinds"].tolist(),
                    o[f"{name}/collectives"].tolist())),
                "host_staged_per_step": dict(zip(
                    o["kinds"].tolist(), o[f"{name}/staged"].tolist())),
                "grad_all_reduces_per_step": int(o[f"{name}/grad_reduces"]),
                "step_ms": o[f"{name}/step_ms"].tolist()})
            runs.append(run)
        rec[name] = runs
        r0 = runs[0]
        print(f"lm mesh {name} over gloo on the card, 2 ranks, "
              f"{LM_RANK_STEPS} eager steps: losses "
              + " ".join(f"{v:.5f}" for v in r0["losses"])
              + f" (dense {' '.join(f'{v:.5f}' for v in r0['dense_losses'])}"
              f", rel {max(r['max_loss_rel'] for r in runs):.3g}); "
              f"parameters within "
              f"{max(r['max_param_rel'] for r in runs):.3g}, momenta "
              f"within {max(r['max_momentum_rel'] for r in runs):.3g} "
              f"(tolerance {LM_RANK_STATE_TOL}); K3/K4-dQ/ring launches at "
              f"each step {r0['k3_k4dq_ring_per_step']}; collectives per "
              f"step {r0['collectives_per_step']}, host-staged "
              f"{r0['host_staged_per_step']}, gradient all-reduces "
              f"{r0['grad_all_reduces_per_step']}; step ms "
              + " ".join(f"{v:.1f}" for v in r0["step_ms"]), flush=True)
    planted = []
    for r, o in enumerate(outs):
        ok, run = held(o, "planted")
        check(not ok, f"lm mesh: the {LM_RANK_PLANTED} run with its ring "
              f"delta off by S_local passed the gate on rank {r} (losses "
              f"rel {run['max_loss_rel']:.3g}, parameters "
              f"{run['max_param_rel']:.3g}, momenta "
              f"{run['max_momentum_rel']:.3g})")
        planted.append(run)
    rec["planted"] = {"run": LM_RANK_PLANTED,
                      "fault": "ring pos_delta + S_local", "ranks": planted}
    p0 = planted[0]
    print(f"lm mesh gate's negative control ({LM_RANK_PLANTED}, ring delta "
          f"off by S_local): loss rel {p0['max_loss_rel']:.3g}, parameters "
          f"{p0['max_param_rel']:.3g}, momenta {p0['max_momentum_rel']:.3g}"
          f" off the dense run: refused", flush=True)
    print(f"lm mesh ranks: {seconds:.1f} s", flush=True)
    return rec


def _state_rel(got, want, floor=0.0):
    """Per tensor ``|got - want| / max(|want|, floor * max |want|)``
    (Frobenius) over ``want``'s names: the three largest, each with its
    name and whether the floor set its denominator, the largest first."""
    import numpy as np
    norms = {k: float(np.linalg.norm(np.asarray(v, np.float64)))
             for k, v in want.items()}
    low = floor * max(norms.values())
    rel = {k: float(np.linalg.norm(np.asarray(got[k], np.float64)
                                   - np.asarray(want[k], np.float64)))
           / max(norms[k], low, 1e-30) for k in want}
    return [(rel[k], k, norms[k] < low)
            for k in sorted(rel, key=rel.get, reverse=True)[:3]]


def _momenta(optimizer):
    """The optimizer's momentum buffers by name, host arrays (a shard
    gathered)."""
    return {k: v for k, v in optimizer.get_states().items()
            if k.endswith(":momentum")}


def _dense_lm(dev, tx, ty, start, chunk):
    """``LM_RANK_STEPS`` eager fused-SGD steps of the LM on one process
    (no mesh): its losses, final parameters and momenta (host arrays)."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import transformer
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=LM["layers"], max_len=LM["seq"], tp=False,
        fused_head_chunk=chunk)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, fused=True))
    m.compile([tx], is_train=True, use_graph=False)
    load_numpy_states(m, start)
    losses = [float(m(tx, ty)[1].data.detach())
              for _ in range(LM_RANK_STEPS)]
    params = {k: v.data.detach().cpu().numpy()
              for k, v in m.get_params().items()}
    momenta = _momenta(m.optimizer)
    del m
    torch.cuda.empty_cache()
    return losses, params, momenta


def _mesh_lm(name, cfg, dev, tx, ty, start, dense, out):
    """``LM_RANK_STEPS`` eager steps of the LM on the mesh of ``cfg`` (an
    ``LM_RANK_RUNS`` entry) from ``start``; what the rank saw goes into
    ``out`` under ``name/``, against ``dense`` (:func:`_dense_lm`)."""
    import numpy as np
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.parallel import mesh as M
    from singa_tpu_torch.parallel import ops as collective
    from singa_tpu_torch.parallel.gspmd import P
    cfg = dict(cfg)
    degrees = {a: cfg.pop(a) for a in ("model", "seq") if a in cfg}
    cfg.pop("fused_head_chunk", None)
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=LM["layers"], max_len=LM["seq"], tp=True,
        fused_head_chunk=LM_RANK_RUNS[name].get("fused_head_chunk"), **cfg)
    d = opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9, fused=True),
                    reduce_axes=("data", "seq"))
    mesh = M.make_mesh(config=M.MeshConfig(**degrees))
    d.communicator.mesh = mesh
    m.set_optimizer(d)
    if "seq_axis" in cfg:
        m.input_specs = [P("data", "seq"), P("data", "seq")]
        m.output_specs = [P("data", "seq"), P()]
    m.compile([tx], is_train=True, use_graph=False)
    load_numpy_states(m, start)
    losses, k3, times = [], [], []
    for _ in range(LM_RANK_STEPS):
        collective.reset_counts()
        at.reset_counts()
        before = d.communicator.counts["all_reduce"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(m(tx, ty)[1].data.detach()))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        k3.append([at.launches["flash_fwd"], at.launches["flash_bwd_dq"],
                   at.pos_delta_launches["flash_fwd"]])
        grad_reduces = d.communicator.counts["all_reduce"] - before
    d_losses, d_params, d_momenta = dense
    params = {k: v.data.detach().cpu().numpy()
              for k, v in m.get_states().items()}
    momenta = _momenta(m.optimizer)
    check(sorted(momenta) == sorted(d_momenta),
          f"lm mesh {name}: momentum names {sorted(momenta)[:4]}... "
          f"against the dense run's {sorted(d_momenta)[:4]}...")
    out[f"{name}/losses"] = np.asarray(losses)
    out[f"{name}/dense_losses"] = np.asarray(d_losses)
    out[f"{name}/k3_per_step"] = np.asarray(k3)
    out[f"{name}/collectives"] = np.asarray(
        [collective.counts[k] for k in collective.KINDS])
    out[f"{name}/staged"] = np.asarray(
        [collective.host_staged[k] for k in collective.KINDS])
    out[f"{name}/grad_reduces"] = np.asarray(grad_reduces)
    out[f"{name}/step_ms"] = np.asarray(times)
    for kind, got, want, floor in (("param", params, d_params, 0.0),
                                   ("momentum", momenta, d_momenta,
                                    LM_RANK_FLOOR)):
        top = _state_rel(got, want, floor)
        out[f"{name}/max_{kind}_rel"] = np.asarray(top[0][0])
        out[f"{name}/max_{kind}_at"] = np.asarray(top[0][1])
        out[f"{name}/top_{kind}"] = np.asarray(
            [f"{k} {r:.3g}" + (" (floor)" if f else "") for r, k, f in top])
    del m, d
    torch.cuda.empty_cache()


def lm_rank_main(rank, world, work):
    """One rank of phase 21 (d): joins the gloo group on ``cuda:0``, runs
    the dense LM, then the LM on each mesh of ``LM_RANK_RUNS`` and the
    planted fault's run, and writes what it saw to
    ``work/rank<rank>.npz``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from singa_tpu_torch import device
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.parallel import ops as collective
    from singa_tpu_torch.tensor import Tensor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device.create_cuda_gpu(0)
    C.init_process(C.NcclIdHolder(file=os.path.join(work, "store")), rank,
                   world, device=dev, backend="gloo",
                   timeout_s=DIST_RANK_TIMEOUT_S)
    try:
        with np.load(os.path.join(work, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        start = {k[len("start/"):]: v for k, v in inputs.items()
                 if k.startswith("start/")}
        tx = Tensor(data=inputs["ids"], device=dev)
        ty = Tensor(data=inputs["tgt"], device=dev)
        dense = {c: _dense_lm(dev, tx, ty, start, c) for c in
                 {r.get("fused_head_chunk") for r in LM_RANK_RUNS.values()}}
        out = {"kinds": np.asarray(collective.KINDS)}
        for name, cfg in LM_RANK_RUNS.items():
            _mesh_lm(name, cfg, dev, tx, ty, start,
                     dense[cfg.get("fused_head_chunk")], out)
        # the negative control: every ring hop's delta off by S_local
        hop = at._RingPartials.apply

        def planted(qf, kr, vr, delta, *rest):
            return hop(qf, kr, vr, delta + qf.shape[2], *rest)
        cfg = LM_RANK_RUNS[LM_RANK_PLANTED]
        got = {}
        at._RingPartials.apply = planted
        try:
            _mesh_lm(LM_RANK_PLANTED, cfg, dev, tx, ty, start,
                     dense[cfg.get("fused_head_chunk")], got)
        finally:
            del at._RingPartials.apply
        out.update({"planted/" + k.split("/", 1)[1]: v
                    for k, v in got.items()})
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def lm_mesh_phase(dev):
    """Phase 21, "lm mesh": (a) remat, (b) the ``bf16_mixed`` LM, (c)
    generate, the K3 ring reading, (d) two ranks on the card. Returns the
    phase's record."""
    import torch
    t0 = time.perf_counter()
    tx, ty = lm_data(dev)
    start = lm_states(lm_model(dev, tx, train=False), SEED + 4)
    torch.backends.cudnn.deterministic = True
    remat, (f32_model, f32_first) = lm_remat_phase(dev, tx, ty, start)
    mixed = lm_mixed_phase(dev, tx, ty, start, f32_model, f32_first)
    del f32_model
    torch.cuda.empty_cache()
    generate = lm_generate_phase(dev, tx, start)
    ring = ring_reading(dev)
    ranks = lm_rank_phase(dev, tx, ty, start)
    torch.backends.cudnn.deterministic = False
    seconds = time.perf_counter() - t0
    print(f"lm mesh phase: {seconds:.1f} s", flush=True)
    return {"remat": remat, "bf16_mixed": mixed, "generate": generate,
            "ring": ring, "ranks": ranks, "seconds": seconds}


def sgd_launches(model):
    """K1-multi launches per step over ``model``'s parameters: the
    multi-tensor update takes one launch per chunk of each dtype's
    parameters."""
    from collections import Counter
    groups = Counter(p.dtype for p in model.get_params().values())
    return sum(multi_chunks("sgd_multi", n) for n in groups.values())


def moe_model(dev, tx, compute_dtype=None, **kw):
    """The MoE LM at ``LM_SHAPE`` with ``MOE``'s experts (:func:`lm_model`;
    ``kw`` as there)."""
    return lm_model(dev, tx, compute_dtype, **dict(MOE, **kw))


def queue_keeps(picks, E, C):
    """The capacity rule on the experts ``picks`` (one (T,) int array per
    round), in numpy: a pick is kept while its queue position in its
    expert, the expert's kept picks of earlier rounds plus its picks by
    earlier tokens of this round, is below ``C``. Returns one (T,) bool
    array per round."""
    import numpy as np
    count = np.zeros(E, np.int64)
    keeps = []
    for idx in picks:
        hot = np.eye(E, dtype=np.int64)[idx]
        pos = (np.cumsum(hot, 0) - hot + count)[np.arange(len(idx)), idx]
        keep = pos < C
        count += (hot * keep[:, None]).sum(0)
        keeps.append(keep)
    return keeps


def moe_layer_check(dev):
    """Phase 22 (a): one ``MoEFFN`` at the step's shape (T = B S tokens,
    D = d_model, ``MOE``'s experts), from numpy-seeded weights, forward on
    the card (f32) against the same op in float64 on the CPU, at ``MOE``'s
    capacity factor and at ``MOE_DROP_CF``, which must drop picks. Gates:
    every token whose top-(k+1) gates lie ``MOE_MARGIN`` or more apart
    picks the same experts on both sides; the card keeps exactly the picks
    that the capacity rule keeps of its own picks (:func:`queue_keeps`);
    every token with no near tie is held within ``MOE_TOL`` of the largest
    |y|, but one whose keeps differ, which a near tie's other pick ahead
    of it in its expert's queue explains; the aux loss within
    ``MOE_TOL``. Readings: the tokens excluded (near ties, routed
    otherwise, kept otherwise), the picks dropped, the forward's ms on the
    card. Returns a record per capacity factor."""
    import numpy as np
    import torch
    from singa_tpu_torch.parallel import moe
    T, D = LM["batch"] * LM["seq"], LM["d_model"]
    E, k = MOE["moe"], MOE["moe_top_k"]
    F = 4 * D
    rng = np.random.default_rng(SEED + 22)
    arrays = [rng.standard_normal((T, D)),
              rng.standard_normal((D, E)) / np.sqrt(D),
              rng.standard_normal((E, D, F)) * np.sqrt(2.0 / (D + F)),
              rng.standard_normal((E, F)) * 0.02,
              rng.standard_normal((E, F, D)) * np.sqrt(2.0 / (D + F)),
              rng.standard_normal((E, D)) * 0.02]
    card = [torch.tensor(a, dtype=torch.float32, device=dev.torch_device)
            for a in arrays]
    cpu = [torch.tensor(a, dtype=torch.float64) for a in arrays]
    with torch.no_grad():
        gates = torch.softmax(card[0] @ card[1], -1)
        wgates = torch.softmax(cpu[0] @ cpu[1], -1)
    top = torch.topk(wgates, k + 1, -1).values
    near = ((top[:, :-1] - top[:, 1:]).min(-1).values < MOE_MARGIN).numpy()
    out = {}
    for cf in (MOE["moe_capacity_factor"], MOE_DROP_CF):
        op = moe._MoEFFN(E, k, cf, None, ())
        C = moe.capacity(T, E, k, cf)
        with torch.no_grad():
            y, aux = op.forward(*card)
            want, want_aux = op.forward(*cpu)
            ms = time_ms(lambda: op.forward(*card))
            got_r = [(i.cpu().numpy(), kp.cpu().numpy())
                     for i, kp, _ in moe.route(gates, k, C)]
            want_r = [(i.numpy(), kp.numpy())
                      for i, kp, _ in moe.route(wgates, k, C)]
        routed = np.zeros(T, bool)
        kept = np.zeros(T, bool)
        for (gi, gk), (wi, wk) in zip(got_r, want_r):
            routed |= gi != wi
            kept |= gk != wk
        check(not (routed & ~near).any(),
              f"moe layer cf {cf}: {int((routed & ~near).sum())} tokens "
              "with no near tie pick other experts on the card than in "
              "float64")
        rule = queue_keeps([gi for gi, _ in got_r], E, C)
        check(all((gk == r).all() for (_, gk), r in zip(got_r, rule)),
              f"moe layer cf {cf}: the card keeps other picks than the "
              "capacity rule keeps of its own picks")
        dropped = int(sum((~wk).sum() for _, wk in want_r))
        card_dropped = int(sum((~gk).sum() for _, gk in got_r))
        least = max(0, T * k - E * C)
        check(dropped >= least and card_dropped >= least,
              f"moe layer cf {cf}: dropped {dropped} picks in float64, "
              f"{card_dropped} on the card, of {T * k} picks for {E * C} "
              f"slots (at least {least})")
        if cf == MOE_DROP_CF:
            check(dropped > 0 and card_dropped > 0,
                  f"moe layer cf {cf}: no pick dropped")
        held = ~near & ~kept
        ref = want.numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(y.cpu().double().numpy()[held]
                           - ref[held]).max())
        check(err <= MOE_TOL * scale,
              f"moe layer cf {cf}: {err} off float64 (max |y| {scale}, "
              f"tolerance {MOE_TOL} x) over the {int(held.sum())} held "
              "tokens")
        aux_rel = abs(float(aux) - float(want_aux)) / abs(float(want_aux))
        check(aux_rel <= MOE_TOL, f"moe layer cf {cf}: aux {float(aux)} "
              f"against {float(want_aux)} in float64")
        out[str(cf)] = {
            "tokens": T, "experts": E, "top_k": k, "capacity_factor": cf,
            "capacity": C, "max_abs_err": err, "max_abs_ref": scale,
            "tolerance": MOE_TOL, "aux_rel_err": aux_rel,
            "near_ties": int(near.sum()), "routed_otherwise":
            int(routed.sum()), "kept_otherwise": int(kept.sum()),
            "held_tokens": int(held.sum()), "picks_dropped": dropped,
            "picks_dropped_card": card_dropped, "picks": T * k,
            "forward_ms": ms}
        print(f"moe layer T{T} D{D} E{E} F{F} top-{k} cf {cf} (C {C}) on "
              f"the card against float64 on the CPU: max err {err:.3g} of "
              f"max |y| {scale:.3g} (tolerance {MOE_TOL} x), aux rel "
              f"{aux_rel:.3g}; tokens excluded {T - int(held.sum())} (near "
              f"ties {int(near.sum())}, routed otherwise "
              f"{int(routed.sum())}, kept otherwise {int(kept.sum())}); "
              f"picks dropped {dropped} of {T * k} ({card_dropped} on the "
              f"card); forward {ms:.3f} ms", flush=True)
    return out


MOE_OP_KINDS = {
    "experts_bmm": ("aten::bmm",),
    "experts_other": ("aten::gelu", "aten::gelu_backward", "aten::add",
                      "aten::sum"),
    "dispatch_combine": ("aten::index_copy", "aten::index",
                         "aten::index_put_", "aten::_index_put_impl_",
                         "aten::index_select", "aten::index_fill_",
                         "aten::index_add_", "aten::index_fill",
                         "aten::cat", "aten::mul", "aten::slice_backward",
                         "aten::where", "aten::copy_", "aten::fill_",
                         "aten::zero_"),
    "router": ("aten::mm", "aten::_softmax", "aten::_softmax_backward_data",
               "aten::argmax", "aten::cumsum", "aten::one_hot",
               "aten::gather", "aten::scatter", "aten::scatter_add_",
               "aten::lt", "aten::sub", "aten::rsub", "aten::mean",
               "aten::div", "aten::eq", "aten::stack"),
}


def moe_kinds(dev, dtype):
    """Device ms of one MoE layer's forward and backward at the step's
    shape by kind (``MOE_OP_KINDS``: the experts' ``bmm``, their bias and
    GELU, dispatch and combine, the router), from the device time
    ``torch.profiler`` gives each ATen op of an eager call; ops of no kind
    go to ``other``. None where the profiler saw no device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch.parallel import moe
    T, D = LM["batch"] * LM["seq"], LM["d_model"]
    E, k, cf = MOE["moe"], MOE["moe_top_k"], MOE["moe_capacity_factor"]
    rng = np.random.default_rng(SEED + 23)
    shapes = [(T, D), (D, E), (E, D, 4 * D), (E, 4 * D), (E, 4 * D, D),
              (E, D)]
    args = [torch.tensor(rng.standard_normal(s) * 0.05,
                         device=dev.torch_device,
                         dtype=torch.float32 if i == 1 else dtype,
                         requires_grad=True) for i, s in enumerate(shapes)]
    op = moe._MoEFFN(E, k, cf, None, ())

    def step():
        y, aux = op.forward(*args)
        torch.autograd.grad([y.float().sum(), aux], args)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_op = {}
    for evt in prof.key_averages():
        if not evt.key.startswith("aten::"):
            continue        # a kernel's own entry: its op holds its time
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us:
            by_op[evt.key] = by_op.get(evt.key, 0.0) + us / 1e3
    if not by_op:
        return None
    kinds = dict.fromkeys(list(MOE_OP_KINDS) + ["other"], 0.0)
    for key, ms in by_op.items():
        kind = next((n for n, ops in MOE_OP_KINDS.items() if key in ops),
                    "other")
        kinds[kind] += ms
    kinds["total"] = sum(by_op.values())
    kinds["by_op"] = by_op
    return kinds


def graph_verdict(g, e, what):
    """A graphed LM run ``g`` against the eager run ``e`` of
    :func:`lm_graph_run`: bitwise, else held to the LM's gates (losses
    finite and falling, each parameter within ``LM_PARAM_TOL`` of its
    norm; phase 12's rule, the reason printed). Returns whether bitwise,
    the reason, the parameter furthest off and its relative distance."""
    import numpy as np
    rel = {k: ((g["params"][k].float() - v.float()).norm()
               / v.float().norm()).item()
           for k, v in e["params"].items()}
    worst = max(rel, key=rel.get)
    bitwise = g["losses"] == e["losses"] and rel[worst] == 0.0
    reason = "bitwise" if bitwise else (
        f"not bitwise: losses {g['losses']} against {e['losses']}, "
        f"{worst} by {rel[worst]:.3g}; held to the LM's gates")
    if not bitwise:
        print(f"{what}: {reason}", flush=True)
        check(all(np.isfinite(g["losses"])) and
              g["losses"][-1] < g["losses"][0] and
              rel[worst] <= LM_PARAM_TOL,
              f"{what}: {reason} (tolerance {LM_PARAM_TOL})")
    return bitwise, reason, worst, rel[worst]


def moe_drop_graph(dev, tx, ty, start):
    """Phase 22 (b) at a capacity that drops: ``MOE_DROP_STEPS`` graphed
    f32 fused-SGD steps of the MoE LM at ``MOE_DROP_CF`` against the same
    steps eager (:func:`graph_verdict`), one capture. Every block drops at
    least k T - E C of its k T picks a step (E C slots), so the spare row
    of the dispatch, the zero weight in the combine and the gradient of a
    dropped pick's gate through the top-k denominator run in the capture
    and its replays."""
    import torch
    from singa_tpu_torch.parallel import moe
    T, E, k = LM["batch"] * LM["seq"], MOE["moe"], MOE["moe_top_k"]
    C = moe.capacity(T, E, k, MOE_DROP_CF)
    least = T * k - E * C
    check(least > 0, f"moe LM cf {MOE_DROP_CF}: {E * C} slots for "
          f"{T * k} picks drop nothing")
    runs = {}
    for name, graph in (("graph", True), ("eager", False)):
        m = moe_model(dev, tx, use_graph=graph,
                      moe_capacity_factor=MOE_DROP_CF)
        runs[name] = lm_graph_run(m, start, tx, ty, MOE_DROP_STEPS)
        if graph:
            stats = list(m.graph_stats().values())
            check(stats == [{"n_captures": 1,
                             "n_replays": MOE_DROP_STEPS - 1}],
                  f"moe LM cf {MOE_DROP_CF}: {stats}")
        del m
        torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    bitwise, reason, worst, rel = graph_verdict(
        g, e, f"moe LM cf {MOE_DROP_CF}")
    print(f"moe LM f32 cf {MOE_DROP_CF} (C {C}: each block drops at least "
          f"{least} of {T * k} picks a step): {MOE_DROP_STEPS} graphed "
          f"steps against eager {reason}; losses "
          + " ".join(f"{v:.5f}" for v in g["losses"]), flush=True)
    return {"capacity_factor": MOE_DROP_CF, "capacity": C,
            "least_dropped_per_block": least, "picks_per_block": T * k,
            "steps": MOE_DROP_STEPS, "bitwise": bitwise, "reason": reason,
            "max_param_rel_diff": rel, "max_param_rel_diff_at": worst,
            "losses": g["losses"], "eager_losses": e["losses"]}


def moe_graph_phase(dev, tx, ty, start, dense_start):
    """Phase 22 (b): ``MOE_STEPS`` graphed fused-SGD steps of the MoE LM
    against the same steps eager, f32 and ``compute_dtype=bfloat16``, from
    ``start``: losses and states bitwise, else the LM's gates (phase 12's
    rule, the reason printed); the routers f32; in a trace of replays K3
    6, K4 6 and K1-multi 2 launches, none counted on the host. Readings:
    step p50/p99 in alternating rounds beside the dense LM's graphed step
    (from ``dense_start``), the device busy ms and idle share of a replay,
    device ms of the MoE layer by kind (:func:`moe_kinds`), peak memory
    above the start. Returns the records and the f32 graphed model."""
    import numpy as np
    import torch
    layers = LM["layers"]
    out, keep = {"dropping": moe_drop_graph(dev, tx, ty, start)}, None
    for dname, cdt in (("float32", None), ("bfloat16", torch.bfloat16)):
        models = {"graph": moe_model(dev, tx, cdt, use_graph=True),
                  "eager": moe_model(dev, tx, cdt, use_graph=False)}
        n_params = len(models["graph"].get_params())
        runs = {n: lm_graph_run(m, start, tx, ty, MOE_STEPS)
                for n, m in models.items()}
        g, e = runs["graph"], runs["eager"]
        bitwise, reason, worst, rel = graph_verdict(g, e,
                                                    f"moe LM {dname}")
        m = models["graph"]
        stats = list(m.graph_stats().values())
        check(stats == [{"n_captures": 1, "n_replays": MOE_STEPS - 1}],
              f"moe LM {dname}: {stats}")
        routers = {str(b.mlp.wg.dtype) for b in m.blocks}
        banks = {str(b.mlp.w1.dtype) for b in m.blocks}
        check(routers == {"torch.float32"},
              f"moe LM {dname}: routers {routers}")
        per_step = {"flash_fwd": layers, "flash_bwd_dq": layers,
                    "flash_bwd_dkv": layers, "sgd_multi": sgd_launches(m)}
        trace = traced(lambda: m(tx, ty), MOE_TRACED, per_step,
                       f"moe LM {dname} replays")
        check(not trace["host_launches"],
              f"moe LM {dname}: replays counted {trace['host_launches']} "
              "on the host")
        dense = lm_model(dev, tx, cdt, use_graph=True)
        lm_graph_run(dense, dense_start, tx, ty, 2)
        times = alternating_rounds(
            {"moe": lambda k: timed_steps(m, tx, ty, k),
             "dense": lambda k: timed_steps(dense, tx, ty, k)},
            MOE_ROUNDS, LM_GRAPH_ROUND_STEPS)
        del dense
        torch.cuda.empty_cache()
        kinds = moe_kinds(dev, cdt or torch.float32)
        q, qd = quantiles(times["moe"]), quantiles(times["dense"])
        rec = {"compute_dtype": dname, "steps": MOE_STEPS,
               "bitwise": bitwise, "reason": reason,
               "max_param_rel_diff": rel, "max_param_rel_diff_at": worst,
               "losses": g["losses"], "eager_losses": e["losses"],
               "router_dtypes": sorted(routers),
               "expert_bank_dtypes": sorted(banks), "params": n_params,
               "step_p50_ms": q["p50_ms"], "step_p99_ms": q["p99_ms"],
               "dense_step_p50_ms": qd["p50_ms"],
               "dense_step_p99_ms": qd["p99_ms"], "step_ms": times["moe"],
               "dense_step_ms": times["dense"],
               "peak_above_start_bytes": g["peak_above_start_bytes"],
               "launches_per_replay": {
                   k: v / MOE_TRACED for k, v in trace["launches"].items()},
               "traced": trace, "layer_device_ms_by_kind": kinds}
        out[dname] = rec
        kind_text = "not measured (no device time in the profile)" \
            if kinds is None else ", ".join(
                f"{k} {v:.3f}" for k, v in kinds.items() if k != "by_op")
        print(f"moe LM {dname} B{LM['batch']} S{LM['seq']} E{MOE['moe']} "
              f"top-{MOE['moe_top_k']}: graph against eager {reason}; "
              f"routers {sorted(routers)}, banks {sorted(banks)}; step p50 "
              f"{q['p50_ms']:.2f} ms p99 {q['p99_ms']:.2f} against the "
              f"dense LM's {qd['p50_ms']:.2f} / {qd['p99_ms']:.2f} "
              f"({MOE_ROUNDS} alternating rounds of "
              f"{LM_GRAPH_ROUND_STEPS}); replay busy "
              f"{trace['busy_ms']:.2f} ms, idle {trace['idle_share']:.3f}; "
              f"per replay {rec['launches_per_replay']}; peak above the "
              f"start {g['peak_above_start_bytes'] / 2**30:.2f} GiB; one "
              f"layer's forward and backward, device ms by kind: "
              f"{kind_text}", flush=True)
        if dname == "float32":
            keep = (m, g)
        del models, runs
        torch.cuda.empty_cache()
    return out, keep


def moe_remat(dev, tx, ty, start, plain):
    """Phase 22 (c), remat: the MoE LM with ``remat=True``, graphed, f32,
    ``MOE_STEPS`` steps from ``start``, bitwise with the plain graphed run
    ``plain`` (phase 22 (b)'s losses and parameters); in a trace of
    replays K3 launches twice per block, K4 once."""
    import torch
    layers = LM["layers"]
    m = moe_model(dev, tx, use_graph=True, remat=True)
    run = lm_graph_run(m, start, tx, ty, MOE_STEPS)
    rel = {k: ((run["params"][k].float() - v.float()).norm()
               / v.float().norm()).item()
           for k, v in plain["params"].items()}
    worst = max(rel, key=rel.get)
    check(run["losses"] == plain["losses"] and rel[worst] == 0.0,
          f"moe LM remat: losses {run['losses']} against the plain run's "
          f"{plain['losses']}, {worst} by {rel[worst]:.3g} (bitwise "
          "expected)")
    trace = traced(lambda: m(tx, ty), MOE_TRACED, {
        "flash_fwd": 2 * layers, "flash_bwd_dq": layers,
        "flash_bwd_dkv": layers, "sgd_multi": sgd_launches(m)},
        "moe LM remat replays")
    rec = {"bitwise": True, "losses": run["losses"],
           "peak_above_start_bytes": run["peak_above_start_bytes"],
           "launches_per_replay": {
               k: v / MOE_TRACED for k, v in trace["launches"].items()},
           "traced": trace}
    print(f"moe LM remat f32: bitwise with the plain graphed run; per "
          f"replay {rec['launches_per_replay']}; peak above the start "
          f"{run['peak_above_start_bytes'] / 2**30:.2f} GiB", flush=True)
    del m
    torch.cuda.empty_cache()
    return rec


def moe_rank_phase(dev, start):
    """Phase 22 (e): ``DIST_RANKS`` processes of this script
    (:func:`moe_rank_main`) on the one card over gloo, eager, each
    ``MOE_RANK_STEPS`` steps of the MoE LM (cut to ``MOE_RANK_LAYERS``
    blocks, drop-free capacity) on the global batch over ``MeshConfig(
    expert=2)``, held by the rank against its own dense run of the same
    batch from the same weights (phase 21 (d)'s rule): losses within
    ``LM_RANK_LOSS_RTOL``, parameters and momenta within
    ``LM_RANK_STATE_TOL`` of their norms. Per step and rank: 4 all-to-alls
    a block, each staged through host memory (gloo), one K3 a block."""
    import shutil
    import tempfile
    import numpy as np
    work = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        tx, ty = lm_data(dev)
        np.savez(os.path.join(work, "inputs.npz"),
                 ids=tx.data.cpu().numpy(), tgt=ty.data.cpu().numpy(),
                 **{f"start/{k}": v for k, v in start.items()})
        t0 = time.perf_counter()
        outs = run_ranks("--moe-rank", work, "moe ep gloo")
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    layers = MOE_RANK_LAYERS
    runs = []
    for r, o in enumerate(outs):
        losses, dense = o["ep/losses"], o["ep/dense_losses"]
        rel = float((np.abs(losses - dense) / np.abs(dense)).max())
        worst = {kind: float(o[f"ep/max_{kind}_rel"])
                 for kind in ("param", "momentum")}
        check(rel <= LM_RANK_LOSS_RTOL and
              max(worst.values()) <= LM_RANK_STATE_TOL,
              f"moe ep rank {r}: losses {losses.tolist()} against the dense "
              f"{dense.tolist()} (rtol {LM_RANK_LOSS_RTOL}), parameters "
              f"{worst['param']:.3g}, momenta {worst['momentum']:.3g} off "
              f"(tolerance {LM_RANK_STATE_TOL}; {o['ep/top_param']}, "
              f"{o['ep/top_momentum']})")
        a2a = o["ep/all_to_all"].tolist()
        staged = o["ep/staged_all_to_all"].tolist()
        k3 = o["ep/k3"].tolist()
        check(a2a == [4 * layers] * MOE_RANK_STEPS and staged == a2a,
              f"moe ep rank {r}: all-to-alls per step {a2a}, staged "
              f"{staged}, expected {4 * layers} each, all staged")
        check(k3 == [layers] * MOE_RANK_STEPS,
              f"moe ep rank {r}: K3 per step {k3}")
        check(o["ep/local_w1"].tolist() ==
              [MOE["moe"] // 2, LM["d_model"], 4 * LM["d_model"]],
              f"moe ep rank {r}: expert bank {o['ep/local_w1'].tolist()}")
        runs.append({"losses": losses.tolist(),
                     "dense_losses": dense.tolist(), "max_loss_rel": rel,
                     "max_param_rel": worst["param"],
                     "max_momentum_rel": worst["momentum"],
                     "top_params": o["ep/top_param"].tolist(),
                     "top_momenta": o["ep/top_momentum"].tolist(),
                     "all_to_all_per_step": a2a,
                     "host_staged_per_step": staged, "k3_per_step": k3,
                     "local_w1": o["ep/local_w1"].tolist(),
                     "step_ms": o["ep/step_ms"].tolist()})
    r0 = runs[0]
    print(f"moe ep=2 over gloo on the card, {DIST_RANKS} ranks, depth cut "
          f"to {layers} blocks, drop-free capacity, {MOE_RANK_STEPS} eager "
          f"steps: losses " + " ".join(f"{v:.5f}" for v in r0["losses"])
          + f" (dense {' '.join(f'{v:.5f}' for v in r0['dense_losses'])}, "
          f"rel {max(r['max_loss_rel'] for r in runs):.3g}); parameters "
          f"within {max(r['max_param_rel'] for r in runs):.3g}, momenta "
          f"within {max(r['max_momentum_rel'] for r in runs):.3g} "
          f"(tolerance {LM_RANK_STATE_TOL}); all-to-alls per step "
          f"{r0['all_to_all_per_step']}, host-staged "
          f"{r0['host_staged_per_step']}; a rank's bank {r0['local_w1']}; "
          f"step ms " + " ".join(f"{v:.1f}" for v in r0["step_ms"])
          + f"; {seconds:.1f} s", flush=True)
    return {"backend": "gloo", "ranks": DIST_RANKS, "layers": layers,
            "steps": MOE_RANK_STEPS, "seconds": seconds, "runs": runs}


def _moe_rank_lm(dev, tx, ty, start, ep):
    """``MOE_RANK_STEPS`` eager fused-SGD steps of the MoE LM of phase 22
    (e) (``MOE_RANK_LAYERS`` blocks, cf = E), on one process (``ep``
    False) or over ``MeshConfig(expert=2)``: losses, per-step all-to-alls,
    host-staged ones and K3 launches, step ms, parameters, momenta, the
    bank a rank holds."""
    import torch
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.ops import attention as at
    from singa_tpu_torch.parallel import mesh as M
    from singa_tpu_torch.parallel import ops as collective
    from singa_tpu_torch.parallel.gspmd import P
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=MOE_RANK_LAYERS, max_len=LM["seq"], tp=False,
        fused_head_chunk=8192, moe=MOE["moe"], moe_top_k=MOE["moe_top_k"],
        moe_capacity_factor=float(MOE["moe"]))
    sgd = opt.SGD(lr=0.1, momentum=0.9, fused=True)
    if ep:
        d = opt.DistOpt(sgd, reduce_axes=("data", "expert"))
        d.communicator.mesh = M.make_mesh(config=M.MeshConfig(expert=2))
        m.set_optimizer(d)
        m.input_specs = [P(("data", "expert")), P(("data", "expert"))]
    else:
        m.set_optimizer(sgd)
    m.compile([tx], is_train=True, use_graph=False)
    load_numpy_states(m, start)
    rec = {"losses": [], "all_to_all": [], "staged": [], "k3": [],
           "step_ms": []}
    for _ in range(MOE_RANK_STEPS):
        collective.reset_counts()
        at.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["losses"].append(float(m(tx, ty)[1].data.detach()))
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["all_to_all"].append(collective.counts["all_to_all"])
        rec["staged"].append(collective.host_staged["all_to_all"])
        rec["k3"].append(at.launches["flash_fwd"])
    rec["params"] = {k: v.data.detach().cpu().numpy()
                     for k, v in m.get_states().items()}
    rec["momenta"] = _momenta(m.optimizer)
    rec["local_w1"] = list(m.blocks[0].mlp.w1.shape)
    del m
    torch.cuda.empty_cache()
    return rec


def moe_rank_main(rank, world, work):
    """One rank of phase 22 (e): joins the gloo group on ``cuda:0``, runs
    the dense MoE LM and the expert-parallel one, writes what it saw to
    ``work/rank<rank>.npz``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from singa_tpu_torch import device
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.tensor import Tensor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device.create_cuda_gpu(0)
    C.init_process(C.NcclIdHolder(file=os.path.join(work, "store")), rank,
                   world, device=dev, backend="gloo",
                   timeout_s=DIST_RANK_TIMEOUT_S)
    try:
        with np.load(os.path.join(work, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        start = {k[len("start/"):]: v for k, v in inputs.items()
                 if k.startswith("start/")}
        tx = Tensor(data=inputs["ids"], device=dev)
        ty = Tensor(data=inputs["tgt"], device=dev)
        dense = _moe_rank_lm(dev, tx, ty, start, ep=False)
        ep = _moe_rank_lm(dev, tx, ty, start, ep=True)
        out = {"ep/losses": np.asarray(ep["losses"]),
               "ep/dense_losses": np.asarray(dense["losses"]),
               "ep/all_to_all": np.asarray(ep["all_to_all"]),
               "ep/staged_all_to_all": np.asarray(ep["staged"]),
               "ep/k3": np.asarray(ep["k3"]),
               "ep/step_ms": np.asarray(ep["step_ms"]),
               "ep/local_w1": np.asarray(ep["local_w1"])}
        for kind, floor in (("param", 0.0), ("momentum", LM_RANK_FLOOR)):
            top = _state_rel(ep[kind + "s" if kind == "param" else
                                "momenta"],
                             dense[kind + "s" if kind == "param" else
                                   "momenta"], floor)
            out[f"ep/max_{kind}_rel"] = np.asarray(top[0][0])
            out[f"ep/top_{kind}"] = np.asarray(
                [f"{k} {r:.3g}" + (" (floor)" if f else "")
                 for r, k, f in top])
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def tp_fsdp_phase(dev, start):
    """Phase 22 (f): ``TP_FSDP_RANKS`` processes of this script
    (:func:`tp_fsdp_rank_main`) on the one card over gloo, eager, each
    ``MOE_RANK_STEPS`` steps of the dense LM (cut to ``MOE_RANK_LAYERS``
    blocks) on ``train_mesh(data=2, model=2)`` with ``fsdp_axis="data"``,
    held against the same tensor-parallel run without FSDP (losses
    ``LM_RANK_LOSS_RTOL``, parameters and momenta ``LM_RANK_STATE_TOL`` of
    their norms). Reading: a rank's state bytes against the TP run's."""
    import shutil
    import tempfile
    import numpy as np
    work = tempfile.mkdtemp(prefix="chip_smoke_tpfsdp_")
    try:
        tx, ty = lm_data(dev)
        np.savez(os.path.join(work, "inputs.npz"),
                 ids=tx.data.cpu().numpy(), tgt=ty.data.cpu().numpy(),
                 **{f"start/{k}": v for k, v in start.items()})
        t0 = time.perf_counter()
        outs = run_ranks("--tp-fsdp-rank", work, "tp fsdp gloo",
                         ranks=TP_FSDP_RANKS)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    runs = []
    for r, o in enumerate(outs):
        losses, tp = o["fsdp/losses"], o["tp/losses"]
        rel = float((np.abs(losses - tp) / np.abs(tp)).max())
        worst = {kind: float(o[f"fsdp/max_{kind}_rel"])
                 for kind in ("param", "momentum")}
        check(rel <= LM_RANK_LOSS_RTOL and
              max(worst.values()) <= LM_RANK_STATE_TOL,
              f"tp fsdp rank {r}: losses {losses.tolist()} against the TP "
              f"run's {tp.tolist()} (rtol {LM_RANK_LOSS_RTOL}), parameters "
              f"{worst['param']:.3g}, momenta {worst['momentum']:.3g} off "
              f"(tolerance {LM_RANK_STATE_TOL})")
        share = float(o["fsdp/bytes"]) / float(o["tp/bytes"])
        check(share <= TP_FSDP_SHARE, f"tp fsdp rank {r}: holds "
              f"{share:.3f} of the TP run's state bytes (at most "
              f"{TP_FSDP_SHARE})")
        runs.append({"losses": losses.tolist(), "tp_losses": tp.tolist(),
                     "max_loss_rel": rel, "max_param_rel": worst["param"],
                     "max_momentum_rel": worst["momentum"],
                     "top_params": o["fsdp/top_param"].tolist(),
                     "top_momenta": o["fsdp/top_momentum"].tolist(),
                     "state_bytes": int(o["fsdp/bytes"]),
                     "tp_state_bytes": int(o["tp/bytes"]),
                     "bytes_share": share,
                     "step_ms": o["fsdp/step_ms"].tolist(),
                     "tp_step_ms": o["tp/step_ms"].tolist()})
    r0 = runs[0]
    print(f"tp fsdp: train_mesh(data=2, model=2) over gloo on the card, "
          f"{TP_FSDP_RANKS} ranks, depth cut to {MOE_RANK_LAYERS} blocks, "
          f"{MOE_RANK_STEPS} eager steps: losses "
          + " ".join(f"{v:.5f}" for v in r0["losses"])
          + " (TP without FSDP "
          + " ".join(f"{v:.5f}" for v in r0["tp_losses"])
          + f", rel {max(r['max_loss_rel'] for r in runs):.3g}); parameters "
          f"within {max(r['max_param_rel'] for r in runs):.3g}, momenta "
          f"within {max(r['max_momentum_rel'] for r in runs):.3g}; a rank "
          f"holds {r0['state_bytes']} state bytes against the TP run's "
          f"{r0['tp_state_bytes']} ({r0['bytes_share']:.3f}); step ms "
          + " ".join(f"{v:.1f}" for v in r0["step_ms"]) + " (TP "
          + " ".join(f"{v:.1f}" for v in r0["tp_step_ms"])
          + f"); {seconds:.1f} s", flush=True)
    return {"backend": "gloo", "ranks": TP_FSDP_RANKS,
            "layers": MOE_RANK_LAYERS, "steps": MOE_RANK_STEPS,
            "seconds": seconds, "runs": runs}


def tp_fsdp_rank_main(rank, world, work):
    """One rank of phase 22 (f): the TP LM on ``train_mesh(data=2,
    model=2)`` without and with ``fsdp_axis="data"``, every rank given the
    global batch (``input_specs`` over ``data``)."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from singa_tpu_torch import device, opt
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.parallel import communicator as C
    from singa_tpu_torch.parallel import gspmd
    from singa_tpu_torch.parallel.gspmd import P
    from singa_tpu_torch.tensor import Tensor
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device.create_cuda_gpu(0)
    C.init_process(C.NcclIdHolder(file=os.path.join(work, "store")), rank,
                   world, device=dev, backend="gloo",
                   timeout_s=DIST_RANK_TIMEOUT_S)
    try:
        with np.load(os.path.join(work, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        start = {k[len("start/"):]: v for k, v in inputs.items()
                 if k.startswith("start/")}
        tx = Tensor(data=inputs["ids"], device=dev)
        ty = Tensor(data=inputs["tgt"], device=dev)
        got = {}
        for name, fsdp in (("tp", None), ("fsdp", "data")):
            m = transformer.TransformerLM(
                LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
                n_layers=MOE_RANK_LAYERS, max_len=LM["seq"], tp=True,
                fused_head_chunk=8192)
            m.set_optimizer(opt.DistOpt(
                opt.SGD(lr=0.1, momentum=0.9, fused=True)))
            m.input_specs = [P("data"), P("data")]
            m.compile([tx], is_train=True, use_graph=False,
                      mesh=gspmd.train_mesh(data=2, model=2),
                      fsdp_axis=fsdp)
            load_numpy_states(m, start)
            losses, times = [], []
            for _ in range(MOE_RANK_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(m(tx, ty)[1].data.detach()))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            got[name] = {
                "losses": losses, "step_ms": times,
                "bytes": gspmd.Partitioner.per_device_bytes(
                    m._state_tensors()),
                "params": {k: v.data.detach().cpu().numpy()
                           for k, v in m.get_states().items()},
                "momenta": _momenta(m.optimizer)}
            del m
            torch.cuda.empty_cache()
        out = {}
        for name, rec in got.items():
            out[f"{name}/losses"] = np.asarray(rec["losses"])
            out[f"{name}/step_ms"] = np.asarray(rec["step_ms"])
            out[f"{name}/bytes"] = np.asarray(rec["bytes"])
        for kind, key, floor in (("param", "params", 0.0),
                                 ("momentum", "momenta", LM_RANK_FLOOR)):
            top = _state_rel(got["fsdp"][key], got["tp"][key], floor)
            out[f"fsdp/max_{kind}_rel"] = np.asarray(top[0][0])
            out[f"fsdp/top_{kind}"] = np.asarray(
                [f"{k} {r:.3g}" + (" (floor)" if f else "")
                 for r, k, f in top])
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def moe_phase(dev):
    """Phase 22, "moe": (a) the MoE layer against float64, (b) the MoE LM
    graphed against eager, f32 and bf16, (c) remat and ``bf16_mixed``,
    (d) generate, (e) expert parallelism over two ranks, (f) tensor
    parallelism with FSDP over four. Returns the phase's record."""
    import torch
    t0 = time.perf_counter()
    tx, ty = lm_data(dev)
    start = lm_states(moe_model(dev, tx, train=False), SEED + 22)
    dense_start = lm_states(lm_model(dev, tx, train=False), SEED + 4)
    torch.backends.cudnn.deterministic = True
    layer = moe_layer_check(dev)
    graphed, (f32_model, plain) = moe_graph_phase(dev, tx, ty, start,
                                                  dense_start)
    remat = moe_remat(dev, tx, ty, start, plain)
    mixed = lm_mixed_phase(dev, tx, ty, start, f32_model, plain["losses"][0],
                           what="bf16_mixed moe LM", **MOE)
    del f32_model, plain
    torch.cuda.empty_cache()
    generate = lm_generate_phase(dev, tx, start, what="moe generate", **MOE)
    rank_start = lm_states(transformer_lm(dev, tx, moe=True), SEED + 24)
    ep = moe_rank_phase(dev, rank_start)
    fsdp = tp_fsdp_phase(dev, lm_states(transformer_lm(dev, tx), SEED + 25))
    torch.backends.cudnn.deterministic = False
    seconds = time.perf_counter() - t0
    print(f"moe phase: {seconds:.1f} s", flush=True)
    return {"layer": layer, "graph": graphed, "remat": remat,
            "bf16_mixed": mixed, "generate": generate, "ep": ep,
            "tp_fsdp": fsdp, "seconds": seconds}


# phase 23: the LM served through the continuous-batching ServingEngine
SERVE = dict(slots=16, max_len=1024, prefill_len=512, prefill_batch=4)
SERVE_BLOCK = 16            # paged: 16-token blocks, the default pool
SERVE_REQUESTS = 64         # 48 greedy, 16 sampled
SERVE_SAMPLED = 16
SERVE_SHARERS = 16          # greedy prompts that share SERVE_PREFIX tokens
SERVE_PREFIX = 256
SERVE_PROMPT = (16, 512)
SERVE_NEW = (32, 128)
SERVE_SAMPLE = dict(temperature=0.8, top_k=50)
SERVE_SPEC_K = 4
SERVE_MOE_REQUESTS = 16
SERVE_TRACED_TICKS = 8
SERVE_GEN = (16, 256, 64)   # generate: batch, prompt, new tokens
# a served token against the uncached eval forward on the same history, as
# a fraction of the largest |logit| of its position: f32 differs only in
# the order of sums (plain attention against K3); bf16_mixed rounds the
# stack to bf16 and is held to the f32 forward
SERVE_TOL = {"float32": 1e-4, "bf16_mixed": 5e-2}
SERVE_KINDS = (
    ("matmul", ("gemm", "cutlass", "gemv", "xmma", "sm90_", "nvjet")),
    ("softmax", ("softmax",)),
    ("index", ("index", "scatter", "gather", "embedding")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("memcpy", "memset")),
)


def serve_traffic(seed=SEED + 23):
    """The phase's 64 requests in submission order: ``{"prompt", "new",
    "sample", "shared"}``; the kinds shuffled from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    V = LM["vocab"]
    prefix = rng.integers(0, V, SERVE_PREFIX)
    kinds = (["sampled"] * SERVE_SAMPLED + ["shared"] * SERVE_SHARERS
             + ["greedy"] * (SERVE_REQUESTS - SERVE_SAMPLED
                             - SERVE_SHARERS))
    out = []
    for kind in rng.permutation(kinds):
        if kind == "shared":
            tail = rng.integers(0, V, int(rng.integers(
                1, SERVE_PROMPT[1] - SERVE_PREFIX + 1)))
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, V, int(rng.integers(
                SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)))
        out.append({"prompt": prompt.astype(np.int32),
                    "new": int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1)),
                    "sample": dict(SERVE_SAMPLE) if kind == "sampled"
                    else {"temperature": 0.0},
                    "shared": kind == "shared"})
    return out


def serve_run(eng, traffic, id_start, background):
    """Every request of ``traffic`` queued (request ids from
    ``id_start``), then served: by the engine's loop thread
    (``background``) or by synchronous ticks. Returns the tokens, the
    digest of every tick's logits, each request's first-token logits, the
    event log (prefill batches with the prefix counters' deltas, and
    releases), the prefill tick ms and the wall seconds of the run."""
    import hashlib
    import itertools
    import numpy as np
    from singa_tpu_torch.serving import scheduler
    log = {"digests": [], "first": {}, "events": [], "prefill_ms": []}
    paged = eng.kv_layout == "paged"
    count = [0, 0]

    def on_logits(kind, out, rows):
        log["digests"].append(hashlib.sha1(out.tobytes()).hexdigest())
        if kind == "prefill":
            for b, req in enumerate(rows):
                log["first"][req.id - id_start] = np.array(out[b])
            hits = (eng._prefix_hits.total(), eng._prefix_tokens.total()) \
                if paged else (0, 0)
            log["events"].append(("prefill", [r.id - id_start for r in rows],
                                  hits[0] - count[0], hits[1] - count[1]))
            count[:] = hits
    finish = eng._finish_slot

    def on_finish(i, status="completed"):
        log["events"].append(("release", eng._slots[i]["req"].id - id_start))
        return finish(i, status)
    prefill = eng._run_prefill

    def timed_prefill(batch, free):
        t0 = time.perf_counter()
        prefill(batch, free)
        log["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
    eng._on_logits = on_logits
    eng._finish_slot = on_finish
    eng._run_prefill = timed_prefill
    scheduler.Request._ids = itertools.count(id_start)
    futs = [eng.submit(r["prompt"], max_new_tokens=r["new"], seed=SEED,
                       **r["sample"]) for r in traffic]
    t0 = time.perf_counter()
    if background:
        eng.start()
        results = [f.result(timeout=600) for f in futs]
        check(eng.drain(timeout=60), "the engine did not drain")
        eng.stop()
    else:
        eng.run_until_idle()
        results = [f.result(timeout=5) for f in futs]
    wall = time.perf_counter() - t0
    check(all(f.deliveries == 1 for f in futs),
          "a future was fulfilled more than once")
    check(all(len(r["tokens"]) == t["new"]
              for r, t in zip(results, traffic)),
          "a request did not get its max_new_tokens")
    eng._on_logits = None
    del eng._finish_slot, eng._run_prefill
    log.update(tokens=[r["tokens"] for r in results], wall_s=wall,
               ttft=eng.ttft_stats(), tick=eng.tick_stats())
    return log


def teacher_forced(m, dev, traffic, log, indices, tol, what):
    """Each request of ``indices``: the uncached eval forward of the
    model (through K3) over its prompt and its served tokens; each served
    token must be the forward's argmax at its position, or within ``tol``
    of that position's largest |logit| (a near tie, counted), and the
    first-token logits within ``tol`` of the forward's. Returns the near
    ties and the worst first-token error (x max |logit|)."""
    import numpy as np
    import torch
    from singa_tpu_torch.tensor import Tensor
    near, worst = 0, 0.0
    for i in indices:
        prompt, toks = traffic[i]["prompt"], log["tokens"][i]
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        with torch.no_grad():
            ref = m(Tensor(data=seq[None].astype(np.float32), device=dev)
                    ).data[0, len(prompt) - 1:].float()
        scale = ref.abs().max(-1).values
        got = torch.as_tensor(toks, device=ref.device)
        gap = ref.max(-1).values - ref.gather(1, got[:, None])[:, 0]
        bad = (gap > tol * scale).nonzero()
        check(len(bad) == 0,
              f"{what}: request {i} token {bad[:1].tolist()} is "
              f"{gap.max().item()} under the forward's largest logit "
              f"(tolerance {tol} x max |logit|)")
        near += int((gap > 0).sum().item())
        first = torch.as_tensor(log["first"][i], device=ref.device)
        err = ((first - ref[0]).abs().max() / scale[0]).item()
        check(err <= tol, f"{what}: request {i}'s first-token logits are "
              f"{err} x max |logit| off the forward's (tolerance {tol})")
        worst = max(worst, err)
    return near, worst


def traced_decode(m, traffic, what, attempts=3, **kw):
    """An engine of the leg's settings (``kw``) with 16 greedy requests in
    flight and none queued, then ``SERVE_TRACED_TICKS`` decode ticks under
    ``torch.profiler`` (each tick one replay of the decode program, no
    admission): the trace must hold one ``cudaGraphLaunch`` per tick.
    Readings per tick: wall ms, device busy ms, idle share, device ops,
    host kernel launches, device ms by kind; and the copy of the decode
    program's logits to pinned host memory, timed with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch.observability.metrics import Registry
    eng = m.compile_serving(registry=Registry(), **SERVE, **kw)
    greedy = [r for r in traffic if r["sample"]["temperature"] == 0]
    for r in greedy[:eng.slots]:
        eng.submit(r["prompt"], max_new_tokens=SERVE_NEW[1])
    while len(eng.queue) or eng.active_slots() < eng.slots:
        eng.step()
    eng.step()
    n = SERVE_TRACED_TICKS
    for attempt in range(attempts):
        replays = eng._decode.n_replays
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        check(eng._decode.n_replays - replays == n,
              f"{what}: {eng._decode.n_replays - replays} of {n} traced "
              "ticks replayed the decode program")
        graphs = launches = ops = 0
        busy, kinds = 0.0, {}
        for e in prof.events():
            graphs += e.name == "cudaGraphLaunch"
            launches += e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                   "cudaLaunchKernelExC")
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            ops += 1
            low = e.name.lower()
            kind = next((k for k, keys in SERVE_KINDS
                         if any(x in low for x in keys)), "other")
            kinds[kind] = kinds.get(kind, 0.0) + ms / n
        if graphs == n and ops:
            break
        print(f"{what}: profiler session {attempt + 1} held {graphs} graph "
              f"launches and {ops} device ops for {n} ticks", flush=True)
    check(graphs == n, f"{what}: the trace of {n} decode ticks holds "
          f"{graphs} cudaGraphLaunch")
    out = eng._decode._outs[0]
    buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    copy_ms = time_ms(lambda: buf.copy_(out, non_blocking=True))
    eng.stop()
    top = sorted(kinds.items(), key=lambda kv: -kv[1])
    return {"ticks": n, "wall_ms": wall / n, "busy_ms": busy / n,
            "idle_share": 1.0 - busy / wall, "device_ops": ops / n,
            "graph_launches": graphs / n, "host_kernel_launches": launches / n,
            "kinds_ms": dict(top), "logits_copy_ms": copy_ms,
            "logits_shape": list(out.shape)}


def serve_leg(m, dev, traffic, what, id_start, tol, policy=None, **kw):
    """One engine over ``traffic``, served by its loop thread, its gates
    and readings; returns the record and the engine (stopped)."""
    import torch
    from singa_tpu_torch.observability.metrics import Registry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = m.compile_serving(registry=Registry(), queue_capacity=128,
                            policy=policy, **SERVE, **kw)
    zero_counts()
    log = serve_run(eng, traffic, id_start, background=True)
    host = host_launches()
    check(not host, f"{what}: the serving path launched the port's "
          f"kernels {host}")
    info = eng.compiled_step_info()
    check(info["n_traces"] == 1 and info["prefill_n_traces"] == 1,
          f"{what}: {info['n_traces']} decode and "
          f"{info['prefill_n_traces']} prefill captures")
    check(eng._decode.n_replays == eng._decode.n_calls - 1 and
          eng._prefill.n_replays == eng._prefill.n_calls - 1,
          f"{what}: a call after a program's first did not replay it")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    greedy = [i for i, r in enumerate(traffic)
              if r["sample"]["temperature"] == 0]
    near, worst = teacher_forced(m, dev, traffic, log, greedy, tol, what)
    generated = sum(len(t) for t in log["tokens"])
    rec = {"requests": len(traffic), "generated_tokens": generated,
           "wall_s": log["wall_s"], "tokens_per_s": generated / log["wall_s"],
           "ttft_p50_s": log["ttft"]["p50_s"],
           "ttft_p99_s": log["ttft"]["p99_s"],
           "decode_tick_p50_ms": log["tick"]["p50_s"] * 1e3,
           "decode_tick_p99_ms": log["tick"]["p99_s"] * 1e3,
           "decode_ticks": log["tick"]["count"],
           "prefill_ticks": len(log["prefill_ms"]),
           "prefill_tick_p50_ms": quantiles(log["prefill_ms"])["p50_ms"],
           "teacher_forced_requests": len(greedy), "near_ties": near,
           "first_logits_max_rel_err": worst, "tolerance": tol,
           "peak_mib_above_start": peak, "compiled": info}
    return rec, eng, log


def serve_line(what, rec, card):
    print(f"{what} [{card}]: {rec['requests']} requests, "
          f"{rec['generated_tokens']} tokens in {rec['wall_s']:.3f} s "
          f"({rec['tokens_per_s']:.0f} tokens/s); TTFT p50 "
          f"{rec['ttft_p50_s'] * 1e3:.2f} ms p99 "
          f"{rec['ttft_p99_s'] * 1e3:.2f} ms; decode tick p50 "
          f"{rec['decode_tick_p50_ms']:.3f} ms p99 "
          f"{rec['decode_tick_p99_ms']:.3f} ms over "
          f"{rec['decode_ticks']} ticks; prefill tick p50 "
          f"{rec['prefill_tick_p50_ms']:.2f} ms over "
          f"{rec['prefill_ticks']}; peak {rec['peak_mib_above_start']:.0f} "
          f"MiB; {rec['teacher_forced_requests']} greedy requests "
          f"teacher-forced, {rec['near_ties']} near ties, first-token "
          f"logits within {rec['first_logits_max_rel_err']:.3g} x max "
          f"|logit| (tolerance {rec['tolerance']})", flush=True)


def expected_prefix_hits(traffic, events):
    """Per prefill batch, the prefix hits the shared prefix implies: each
    sharer admitted after another sharer was released (its 16 prefix
    blocks then sit in the cache, live or recently used)."""
    released, out = False, []
    for ev in events:
        if ev[0] == "release":
            released = released or traffic[ev[1]]["shared"]
        else:
            out.append(sum(released and traffic[i]["shared"]
                           for i in ev[1]))
    return out


def generate_ms(m, dev, traced_steps=16):
    """``TransformerLM.generate``'s greedy ms per token on the same
    weights (``SERVE_GEN``: batch, prompt, new tokens), p50 over the
    steps after the prefill, CUDA events; and one decode step's wall ms,
    device busy ms and device ops, from the difference of two traced
    decodes ``traced_steps`` tokens apart."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from singa_tpu_torch.models import transformer
    B, S0, n = SERVE_GEN
    prompt = np.random.default_rng(SEED + 24).integers(
        0, LM["vocab"], (B, S0)).astype(np.int32)
    marks = [torch.cuda.Event(enable_timing=True)]

    def mark(_logits):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    transformer._decode(m, prompt, 4, temperature=0)
    torch.cuda.synchronize()
    marks[0].record()
    transformer._decode(m, prompt, n, temperature=0, on_token=mark)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def traced(new):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            transformer._decode(m, prompt, new, temperature=0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return wall, sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3, \
            len(dev_ev)
    (w1, b1, o1), (w2, b2, o2) = traced(2), traced(2 + traced_steps)
    step = {"wall_ms": (w2 - w1) / traced_steps,
            "busy_ms": (b2 - b1) / traced_steps,
            "device_ops": (o2 - o1) / traced_steps}
    step["idle_share"] = 1.0 - step["busy_ms"] / step["wall_ms"]
    return {"batch": B, "prompt": S0, "new": n, "prefill_ms": ms[0],
            "token_p50_ms": quantiles(ms[1:])["p50_ms"],
            "traced_step": step}


def lm_serve_phase(dev):
    """Phase 23, "lm serve": the LM served through the ServingEngine, (a)
    the ring graphed, (b) eager against (a) bitwise, (c) paged with
    speculative decoding, (d) bf16_mixed, (e) the MoE LM. Returns the
    phase's record."""
    import torch
    from singa_tpu_torch.model import load_numpy_states
    from singa_tpu_torch.observability.metrics import Registry
    t0 = time.perf_counter()
    card = card_line()
    tx, _ = lm_data(dev)
    m = lm_model(dev, tx, train=False)
    load_numpy_states(m, lm_states(m, SEED + 23))
    m.eval()
    traffic = serve_traffic()
    rec = {}
    ring, eng, graphed = serve_leg(m, dev, traffic, "lm serve ring",
                                   10_000, SERVE_TOL["float32"])
    del eng
    ring["traced_decode"] = traced_decode(m, traffic, "lm serve ring")
    rec["ring"] = ring
    serve_line("lm serve (a) ring f32 graphed", ring, card)
    t = ring["traced_decode"]
    print(f"lm serve (a) traced decode tick [{card}]: wall "
          f"{t['wall_ms']:.3f} ms, busy {t['busy_ms']:.3f} ms, idle share "
          f"{t['idle_share']:.3f}, {t['device_ops']:.0f} device ops, "
          f"{t['graph_launches']:.0f} graph launch, "
          f"{t['host_kernel_launches']:.0f} host kernel launches; by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in t["kinds_ms"].items())
          + f" ms; the {tuple(t['logits_shape'])} f32 logits copy to "
          f"pinned host memory {t['logits_copy_ms']:.4f} ms", flush=True)

    # (b) the same requests and ids through eager ticks: bitwise
    eager = m.compile_serving(use_graph=False, queue_capacity=128,
                              registry=Registry(), **SERVE)
    elog = serve_run(eager, traffic, 10_000, background=False)
    same = elog["digests"] == graphed["digests"]
    check(same and elog["tokens"] == graphed["tokens"],
          f"lm serve (b): eager ticks' logits differ from the graphed "
          f"ones ({len(elog['digests'])} against "
          f"{len(graphed['digests'])} ticks)")
    rec["eager_bitwise"] = {"ticks": len(elog["digests"]), "equal": same}
    print(f"lm serve (b) eager against graphed [{card}]: "
          f"{len(elog['digests'])} ticks, logits bitwise equal", flush=True)
    del eager
    torch.cuda.empty_cache()

    # (c) paged, speculative
    paged, eng, plog = serve_leg(
        m, dev, traffic, "lm serve paged", 20_000, SERVE_TOL["float32"],
        kv_layout="paged", kv_block_size=SERVE_BLOCK,
        speculative_k=SERVE_SPEC_K)
    want = expected_prefix_hits(traffic, plog["events"])
    got = [ev[2] for ev in plog["events"] if ev[0] == "prefill"]
    tokens = [ev[3] for ev in plog["events"] if ev[0] == "prefill"]
    check(got == want and tokens == [SERVE_PREFIX * n for n in want],
          f"lm serve (c): prefix hits per prefill batch {got}, tokens "
          f"{tokens}; the shared prefix implies {want}")
    check(sum(want) >= 1, "lm serve (c): no sharer was admitted after "
          "another was released (the traffic does not test the cache)")
    check(eng._mgr.blocks_live() == 0 and
          eng._reg.get("kv_blocks_in_use").value() == 0,
          "lm serve (c): blocks still referenced after the drain")
    paged["prefix_hits"] = sum(want)
    paged["prefix_tokens"] = SERVE_PREFIX * sum(want)
    paged["speculative_accepted_ratio"] = \
        eng._reg.get("speculative_accepted_ratio").value()
    paged["speculative_proposed"] = \
        eng._reg.get("speculative_proposed_total").total()
    del eng
    torch.cuda.empty_cache()
    paged["traced_decode"] = traced_decode(
        m, traffic, "lm serve paged", kv_layout="paged",
        kv_block_size=SERVE_BLOCK, speculative_k=SERVE_SPEC_K)
    rec["paged_speculative"] = paged
    serve_line("lm serve (c) paged speculative_k=4", paged, card)
    print(f"lm serve (c): prefix hits {paged['prefix_hits']} "
          f"({paged['prefix_tokens']} tokens), speculative accepted ratio "
          f"{paged['speculative_accepted_ratio']:.4f} of "
          f"{paged['speculative_proposed']} drafts; traced decode tick busy "
          f"{paged['traced_decode']['busy_ms']:.3f} ms, idle share "
          f"{paged['traced_decode']['idle_share']:.3f}", flush=True)

    # (d) bf16_mixed on the ring, held to the f32 forward
    mixed, eng, _ = serve_leg(m, dev, traffic, "lm serve bf16_mixed",
                              30_000, SERVE_TOL["bf16_mixed"],
                              policy="bf16_mixed")
    check(eng._cache[0]["k"].dtype == torch.bfloat16,
          "lm serve (d): the cache is not bf16")
    rec["bf16_mixed"] = mixed
    del eng
    serve_line("lm serve (d) ring bf16_mixed", mixed, card)
    rec["generate"] = generate_ms(m, dev)
    print(f"lm serve: TransformerLM.generate B{SERVE_GEN[0]} prompt "
          f"{SERVE_GEN[1]} + {SERVE_GEN[2]} [{card}]: prefill "
          f"{rec['generate']['prefill_ms']:.2f} ms, per token p50 "
          f"{rec['generate']['token_p50_ms']:.3f} ms; a traced decode "
          f"step: wall {rec['generate']['traced_step']['wall_ms']:.3f} ms, "
          f"busy {rec['generate']['traced_step']['busy_ms']:.3f} ms, "
          f"{rec['generate']['traced_step']['device_ops']:.0f} device ops, "
          f"idle share {rec['generate']['traced_step']['idle_share']:.3f}",
          flush=True)
    del m
    torch.cuda.empty_cache()

    # (e) the MoE LM, drop-free in the engine and in the forward
    mm = moe_model(dev, tx, train=False)
    load_numpy_states(mm, lm_states(mm, SEED + 22))
    mm.eval()
    for blk in mm.blocks:
        blk.mlp.capacity_factor = float(blk.mlp.n_experts)
    greedy = [r for r in traffic if r["sample"]["temperature"] == 0]
    moe, eng, _ = serve_leg(mm, dev, greedy[:SERVE_MOE_REQUESTS],
                            "lm serve moe", 40_000, SERVE_TOL["float32"])
    rec["moe"] = moe
    del eng, mm
    torch.cuda.empty_cache()
    serve_line("lm serve (e) MoE ring", moe, card)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    print(f"lm serve phase: {rec['seconds']:.1f} s", flush=True)
    return rec


def transformer_lm(dev, tx, moe=False):
    """An eval LM of ``MOE_RANK_LAYERS`` blocks at ``LM_SHAPE``'s width
    (with ``MOE``'s experts when ``moe``), for the rank legs' seeded
    weights (its state names and shapes)."""
    from singa_tpu_torch.models import transformer
    m = transformer.TransformerLM(
        LM["vocab"], d_model=LM["d_model"], n_heads=LM["heads"],
        n_layers=MOE_RANK_LAYERS, max_len=LM["seq"], tp=False,
        fused_head_chunk=8192, **(MOE if moe else {}))
    m.compile([tx], is_train=False)
    return m


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
    zoo = zoo_train_phase(dev)
    pure_bf16 = pure_bf16_phase(dev)
    xception_serve = xception_serve_phase(dev)
    s2d = s2d_phase(dev)
    imagenet = imagenet_zoo_phase(dev)
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
    del lm_tx, lm_ty, lm_start
    torch.cuda.empty_cache()

    # data parallelism and ZeRO/FSDP, from the training phases' start and
    # batch
    torch.backends.cudnn.deterministic = True
    models, tx, ty, start = train_models(dev)
    with nccl_world1(dev):
        dist_nccl = dist_nccl_phase(dev, models, tx, ty, start)
        fsdp_nccl = zero_nccl_phase(dev, models, tx, ty, start)
    dist = {"nccl": dist_nccl,
            "gloo": dist_gloo_phase(dev, models, tx, ty, start)}
    del models
    torch.cuda.empty_cache()
    fsdp = {"nccl": fsdp_nccl, "gloo": zero_gloo_phase(dev, tx, ty, start)}
    del tx, ty, start
    torch.cuda.empty_cache()
    # training from image files on disk (phase 20)
    image_files = image_files_phase(dev)
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    # the LM on a mesh (phase 21)
    lm_mesh = lm_mesh_phase(dev)
    torch.cuda.empty_cache()
    # the MoE LM, expert parallelism, TP with FSDP (phase 22)
    moe = moe_phase(dev)
    torch.cuda.empty_cache()
    # the LM served by the continuous-batching engine (phase 23)
    lm_serve = lm_serve_phase(dev)

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
    # the launches per replay on the paths of train_cnn.py's other models:
    # K1-multi per zoo and pure-bf16 step, K2 per Xception tick
    per_replay = {"sgd_multi": {
        **{k: v["sgd_multi"]["launches_per_replay"] for k, v in zoo.items()
           if isinstance(v, dict)},
        **{f"{k}_bfloat16": v["sgd_multi"]["launches_per_replay"]
           for k, v in pure_bf16.items()}}}
    for pname, rec in xception_serve.items():
        for key, n in rec["launches_per_replay"].items():
            per_replay.setdefault(key, {})[f"xceptionnet_{pname}"] = n
    for case in ("plain", "bucketed"):
        per_replay["sgd_multi"][f"resnet50_dist_nccl_{case}"] = \
            dist["nccl"][case]["sgd_multi_per_replay"]
    # the ImageNet zoo (phase 19): K1-multi per replayed step, K2 per
    # replayed serving tick
    for name in IMAGENET_ZOO:
        rec = imagenet[name]
        per_replay["sgd_multi"][f"{name}_imagenet"] = \
            rec["sgd_multi"]["launches_per_replay"]
        for pname, srec in rec["serve"].items():
            for key, n in srec["launches_per_replay"].items():
                per_replay.setdefault(key, {})[f"{name}_{pname}"] = n
    # the FSDP step (phase 18 (a)): K1-multi per replay, f32 and flagged
    for case, key in (("fsdp_axis", "sgd_multi"),
                      ("fsdp_axis_bf16_mixed", "sgd_multi_flag")):
        per_replay.setdefault(key, {})[f"resnet50_fsdp_nccl_{case}"] = \
            fsdp["nccl"][case]["sgd_multi_per_replay"]
    # the step fed from image files (phase 20): K1-multi per replay
    per_replay["sgd_multi"]["resnet50_image_files"] = \
        image_files["traced"]["sgd_multi_per_replay"]
    # the LM with remat (phase 21 (a)): K3 twice per block, K4 once
    for dname, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        got = lm_mesh["remat"][dname]["remat"]["launches_per_replay"]
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            per_replay.setdefault(kname + suffix, {})["lm_remat"] = \
                got[kname]
    # the MoE LM (phase 22 (b), (c)): K3/K4 once per block and K1-multi
    # per replayed step, f32 and bf16; K3 twice per block with remat
    for dname, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        got = moe["graph"][dname]["launches_per_replay"]
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            per_replay.setdefault(kname + suffix, {})["lm_moe"] = \
                got[kname]
        per_replay.setdefault("sgd_multi", {})[f"lm_moe_{dname}"] = \
            got["sgd_multi"]
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        per_replay[kname]["lm_moe_remat"] = \
            moe["remat"]["launches_per_replay"][kname]
    # the ring path (phase 21 (d)): K3 with pos_delta on each hop
    ring_runs = lm_mesh["ranks"]["sp_ring"]
    ring_per_step = ring_runs[0]["k3_k4dq_ring_per_step"][0][2]
    for row in kernels:
        if row["name"] == "flash_fwd":
            row["ring_launches_per_step_and_rank"] = ring_per_step
    readings = lm_mesh["ring"]
    hop = readings[0]
    kernels.append({
        "name": "flash_fwd_ring", "route": "cuda",
        "source": "singa_tpu_torch/csrc/flash_attention.cu",
        "replaces": REPLACES["flash_fwd"],
        "launches": ring_runs[0]["ring_launches"],
        "launches_note": "K3 launches with pos_delta on rank 0, counted "
        "over every step of the sp=2 ring run of phase 21 (d)",
        "max_abs_err": max(max(r["max_abs_err"].values())
                           for r in readings),
        "ms": hop["ms"], "plain_ms": hop["plain_ms"],
        "bound_ms": hop["bound_ms"], "bound_by": hop["bound_by"],
        "library_ms": hop["library_ms"],
        "readings": [{k: r[k] for k in (
            "delta", "shape", "unmasked_pairs", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for r in readings]})
    for row in kernels:
        if row["name"] in per_replay:
            row["other_paths_launches_per_replay"] = per_replay[row["name"]]
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
              "graph_lm": graph_lm, "zoo_train": zoo,
              "pure_bf16_train": pure_bf16,
              "xception_serve": xception_serve, "s2d": s2d,
              "imagenet_zoo": imagenet,
              "dist": dist, "fsdp": fsdp, "image_files": image_files,
              "lm_mesh": lm_mesh, "moe": moe, "lm_serve": lm_serve,
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
    if len(sys.argv) == 5 and sys.argv[1] == "--dist-rank":
        sys.exit(dist_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--zero-rank":
        sys.exit(zero_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--lm-rank":
        sys.exit(lm_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--moe-rank":
        sys.exit(moe_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-fsdp-rank":
        sys.exit(tp_fsdp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4]))
    sys.exit(main())
