#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card (compute capability 9.0) and ``nvcc``.
Phases, each of which fails the run (non-zero exit) when it fails:

1. device: CUDA with capability (9, 0); prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: every CUDA source of ``repro_torch.kernels.csrc`` with ``nvcc``
   (one process per source, all at once); prints seconds and ptxas' report;
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes, with its time, the plain version's, the least time the
   card could take (``bound_ms``) and, where one PyTorch call computes the
   same function, that call's time (``library_ms``, a yardstick the port
   never calls): the flash forward (bf16 with a head dim that is a
   multiple of 8 on its tensor-core route, f32 on its f32-FMA route: each
   case prints its route and, on the tensor cores, the bf16 terms of P;
   ptxas' registers and spills of every ``flash_fwd_kernel_tc`` instance;
   a row at phase 15's shard shape, Sq 512 against Sk 1024;
   every bf16 case held to the forward's rel L2 limit; at the DiT's and
   qwen3-8b's shapes readings with P in 1 and 2 terms and the 1-term
   control, which must miss that limit while the kernel's 3 terms meet
   it), the flash backward's dq and dkv
   kernels (against ``ref.attention_bwd``; the same routes, each case
   printing its route and the bf16 terms of P and dS; ptxas' registers
   and spills of every ``flash_bwd_dq_kernel_tc`` and
   ``flash_bwd_dkv_kernel_tc`` instance; every case held to the
   backward's rel L2 limit over dq and over (dk, dv) and run twice,
   bitwise equal; at the DiT's and qwen3-8b's shapes readings with P and
   dS in 1, 2 and 3 terms, where the 1-term control must miss that limit
   while the kernels' 2 terms meet it), DDIM at the fine and coarse
   steps' shapes, the fused residual (the corrector's shapes with
   ``batch_dims`` 0, 1 and 2, a batch of 4, slices of 6993 f32 and of 7
   bf16 elements) and the fused update without the residual
   (``parareal_update``: the serving shape, a ragged one and a batch of
   blocks, each in f32 and bf16; the wall time of its first call), each
   run twice (bitwise equal) and on unaligned copies of its operands (the
   kernels' scalar path: the same bits), each with its device launches a
   call (must be 1) and device µs a launch from one ``torch.profiler``
   window and its host µs a call (enqueue time), and each slice of a
   (4, 2, 64, 64, 4) batch of the residual run alone (the same bits); the
   forward's causal grouped-query form at qwen3-8b's prefill shape, a
   ragged right-aligned causal case and the sliding-window form at
   hymba-1.5b's shape; the
   WKV kernel at rwkv6-1.6b's prefill shape, at its training shape with
   checkpoints, at T = 1, a ragged T and with w over the model's whole
   clip (two runs bitwise equal, every bf16 case held by rel L2, the
   plain scan without ``u`` as the control that must miss it; ptxas'
   registers and spills, grid and blocks per SM of every WKV kernel);
   the backward's causal GQA form at qwen3-8b's training shape, its
   sliding-window form at hymba-1.5b's and a ragged causal f32 case; the
   WKV backward at rwkv6-1.6b's training shape, at T = 7, with w over the
   whole clip and T = 300 in f32 (two runs bitwise equal); hymba-1.5b's
   selective scan (f32, din 1600, 16 states) at its prefill shape (4 x
   2048 from the zero state), at T = 1 and a ragged T from a nonzero
   state (two runs bitwise equal, y and the final state held by rel L2;
   the plain scan with D dropped, and with the state zeroed at T = 1, as
   controls that must miss it; the bound counts its exponentials at the
   SFUs' rate; its geometry, ptxas' registers and spills per instance,
   and at each shape one device launch a call, device µs a launch and
   host µs a call); the scan's forward with checkpoints at hymba's
   training shape (2 x 2048), timed in turns with the forward without
   them (y and h_T bitwise equal), and its backward (T cut into segments:
   the replay of each, the walk back, and the sum) against
   ``ref.selective_scan_bwd`` at the kernel's segment count at
   that shape, at a ragged T from a nonzero state with a gradient on the
   final state and with xs and dy off a 16-byte boundary (two runs
   bitwise equal, each gradient held by rel L2, the twin fed dy a step
   late as the control that must miss it on every gradient; the bound
   counts one pass of exponentials; its geometry, the build's knobs,
   ptxas' registers and spills per instance, three device launches a
   call, each with its own device time, and the sum's bound);
4. sampling: the full-width, full-depth ``srds-dit-sd2`` DiT (28 layers,
   d 1152, 16 heads of 72, bf16) with weights drawn from a numpy seed
   (every leaf nonzero) and loaded through ``load_jax_params``; DDIM on
   ``ddpm_linear`` with N=25, B=5, K=2 per-sample.  ``sample_sequential``,
   then ``srds_sample`` at ``max_iters=B`` (the main path: launch counts
   reset just before and read just after), held against the sequential
   sample, then ``srds_sample`` with an early-exit ``tol``.  Launch counts
   must equal what the loop implies;
5. DDPM and ParaDiGMS on the same DiT, weights and schedule: the ``ddpm``
   solver with frozen noise from ``DDPM_SEED`` (N=25, B=5, K=2):
   ``sample_sequential``, then ``srds_sample`` at ``max_iters=B`` (launch
   counts reset just before and read just after: flash 28 per eval, DDIM
   never, the residual once per refined block) held against it within
   ``SRDS_VS_SEQ_REL_L2``, with the same run from another noise seed as the
   control that must miss it, and the native noise drawn twice for one
   interval bitwise equal; then ParaDiGMS (window 25, K=1, DDIM) at a
   tolerance near 0 (launch counts likewise: one DiT eval, so 28 flash
   launches on the tensor-core route, and one DDIM launch a sweep) held
   against ``sample_sequential`` of the same latent within the same limit,
   with one sweep (``max_iters=1``) as the control; a reading of
   ParaDiGMS at ``tol=1e-3``; and the headline line: the sequential
   sampler's, SRDS's early-exit and ParaDiGMS's wall seconds, each with
   its iterations and serial evals;
6. serving: the same DiT behind ``repro_torch.serve``: a
   ``DiffusionSamplingEngine`` (N=25, B=5, 2 slots, default ``ExactPrefix``
   truncation, ``norm='l1_mean'``) driven by ``AsyncServeLoop`` on a
   ``MonotonicClock`` under FIFO, over a ``bursty_trace`` of 6 requests in
   2 bursts of 3 (two at ``tol=0``, four at a loose ``tol``); launch counts
   reset just before and read just after.  Each ``tol=0`` sample against
   ``sample_sequential`` from the same noise; each request's iterations and
   evals against its standalone ``srds_sample(truncate=True)``; launch
   counts against the engine's refinement record; one ``_host_fetch`` per
   refinement plus one per completion, and no other host sync (PyTorch's
   sync debug mode); per-request latency and the run's wall time.  Then
   the two ``tol=0`` requests again with ``norm='l2_mean'``: the
   ``parareal_update`` kernel once per refined block, the residual kernel
   never, and samples equal to the first run's;
7. training: the same DiT and weights through ``launch.train.build``:
   the gradient of one ``diffusion_loss`` at batch 2 through the kernels
   against the plain attention's, whole and over the q, k and v
   projections alone; ``train_loop`` for 5 AdamW steps at
   batch 8 (launch counts reset just before and read just after: flash
   forward, dq and dkv 28 x 5 each), each step's wall time, loss, grad
   norm and peak memory; the loss on a held-out probe batch (one the loop
   does not train on, with fixed t and eps) lower after the steps than
   before; the loop's last checkpoint (about 7 GB, in a temporary
   directory, deleted after) restored and compared bitwise with the live
   parameters and moments.  Two controls show that the gradient check can
   fail: with the attention gradients zeroed, and with the backward's
   ``delta`` term dropped, both readings must miss their limit.  Last,
   a reading (no check) of the probe loss over 5 steps at the launcher's
   default learning rate, which is why this phase trains at a tenth of it;
8. LM serving: ``qwen3-8b`` at full width and depth (36 layers, d 4096,
   32/8 heads of 128, 8.19 B parameters in bf16) with random weights
   drawn on the card from a seeded CUDA generator, behind
   ``repro_torch.serve.ServingEngine(batch_size=4)``: 4 requests with
   prompts of 2048, 1536, 1024 and 512 random token ids and 32, 32, 16
   and 16 new tokens (launch counts reset just before and read just
   after: the causal GQA flash forward 36 times in prefill, never in a
   decode step); prefill wall time, decode ms per step, tokens/s, peak
   memory.  Checks: the prefill's last logits through the kernels against
   the plain attention's (relative L2), decode step 1 against
   ``forward_train`` over the prompts plus the first tokens, and a control
   that must miss the first check (the same prefill with
   ``causal=False``);
9. the same for ``rwkv6-1.6b`` (24 layers, d 2048, 1.60 B parameters):
   the WKV kernel 24 times per prefill and per decode step.  Its random
   bf16 model amplifies any change of rounding, so every layer's WKV
   launch in one bf16 prefill is first held against the plain scan on
   that layer's inputs, and checks 1-3 then run the same weights in f32;
   the first check also holds the final WKV states, and the control
   (decode step 1 with the carried WKV state dropped) must miss the
   second;
10. LM training: ``qwen3-8b`` at its published widths with 8 of its 36
   layers (2.79 B parameters, bf16, drawn on the card), built by
   ``launch.train.build``'s own calls with the depth cut; 5 AdamW steps
   through ``train_loop`` at batch 2 x 2048 from ``LMStream`` (launch
   counts reset just before and read just after: the flash forward, dq
   and dkv 8 times a step), each step's wall time, loss, peak memory and
   launches, and a ``torch.profiler`` reading of one step.  Checks: the
   flash backward on each layer's own inputs, captured from a gradient of
   the training batch, against the plain backward; every parameter's
   gradient at batch 1 x 2048 through the kernels against the plain
   attention's (whole, and over the q/k/v projections alone), with two
   broken backwards that must miss the limit (without the causal mask;
   reading KV head ``bh % BKV``); the mean loss over the 5 batches it
   trained on falls by more than ``FIT_MARGIN``, and the same loop from
   the same weights with the update reversed (the control) must not; the
   held-out batch's loss is a reading;
11. the same for ``rwkv6-1.6b`` whole through ``launch.train.build``: the
   WKV forward and backward 24 times a step.  The WKV backward on each
   layer's own inputs at T 2048 against ``ref.rwkv6_wkv_bwd``; after the
   steps, the gradient check on the trained weights in f32 at batch 1 x
   256 (the random bf16 model amplifies rounding, phase 9) over their
   first 4 layers (over all 24 the random model's gradient is chaotic in
   f32 too: a reading), whole and over the decay LoRA leaves alone, with
   the backward's ``dd`` dropped as the control.  Its loop must lower the
   mean loss over the 5 batches it trained on by more than ``FIT_MARGIN``,
   and the same loop from the same weights with the update reversed (the
   control) must not; the held-out batch's loss is a reading (ROADMAP
   C11: training on these batches raises it);
12. LM serving: ``hymba-1.5b`` at full width and depth (32 layers, d
   1600, 25/5 heads of 64, every layer sliding-window at 1024 beside a
   selective SSM of 1600 x 16, 1.39 B parameters in bf16) drawn on the
   card from a seeded CUDA generator, serving phases 8-9's 4 requests
   (prompt ids drawn below its vocabulary of 32001) through
   ``ServingEngine(batch_size=4)``: launch counts reset just before and
   read just after, held exactly (the window flash forward 32 times per
   prefill, all on the tensor-core route, never in a decode step; the
   selective scan 32 times per prefill and per decode step); prefill
   wall time, decode ms per step, tokens/s, peak memory and a profile of
   one prefill and one decode step.  Every scan launch of one bf16
   prefill and the decode step after it held against the plain twin on
   that layer's own inputs; then, on the same weights in f32, the
   prefill's last logits and final SSM states through the kernels against
   the plain path, decode step 1 against ``forward_train`` over the
   prompts plus the first tokens, and a control that must miss the first
   check (the same prefill with ``window=None``);
13. LM training: ``hymba-1.5b`` whole (32 layers, bf16, drawn on the
   card) through ``launch.train.build``, 5 AdamW steps through
   ``train_loop`` at batch 2 x 2048 from ``LMStream``, as phases 10-11
   (launch counts reset just before and read just after, exactly 32 a
   step of: the window flash forward, on the tensor-core route, dq and
   dkv in their window form, the scan's forward, every one writing
   checkpoints, its backward and the backward's sum).  Checks: one
   gradient of the training batch with every layer's window dq/dkv
   against the plain backward on its own inputs, and the scan backward of
   the first, a middle and the last layer against
   ``ref.selective_scan_bwd`` on theirs at the kernel's segment count;
   the loss over the trained batches falls by more than ``FIT_MARGIN``
   while the reversed update's does not; on the trained weights in f32
   at batch 1 x ``HYMBA_GRAD_SEQ`` (past the window) a reading of the
   whole gradient over all 32 layers through the kernels against the
   plain path's (it depends on the trajectory there), and the check over
   the first ``HYMBA_GRAD_LAYERS``, whole and over the dt and q/k/v
   leaves, with the scan's ``ddt`` dropped and the flash backward without
   its window as controls; a profile of one step (no C10 windows: on an
   H100 their profiler took 291 s);
14. the SRDS drivers on ``torch.distributed`` and the serving tables: an
   NCCL group of one rank from a ``file://`` store in a temporary
   directory (NCCL's version printed), phase 4's DiT rebuilt from its
   seed, and ``make_sharded_sampler`` over ``make_srds_mesh(1)`` at phase
   4's early-exit tolerance (N=25, B=5, K=2; launch counts reset just
   before and read just after): its iterations equal ``srds_sample``'s,
   its launch counts too (B1, B2, B3), from the counters and from the
   profiler's device records (``profiling.window_launches``; where a
   window lost records, ROADMAP C12, each kernel's records within that
   loss of its count), and its
   sample is within ``SHARDED_REL_L2`` of ``srds_sample``'s, with the
   input moved by ``DRIVER_PERTURB`` as the control that must miss it;
   the two samplers' wall seconds in turns; then
   ``make_pipelined_sampler`` at one rank (one block of 25 steps, every
   superstep one model call on the fine and coarse pair: B2, B3 and B4 25
   times) against ``sample_sequential`` within ``SRDS_VS_SEQ_REL_L2``, the
   moved input as control; the group torn down.  Then
   ``table9_batched`` and ``table10_slo`` on the toy, on the card and on
   the CPU: every table10 row equal, and every table9 request at a
   tolerance of at least ``ROUNDOFF_FREE_TOL`` stopping at the same
   iteration (the others stop inside the toy's f32 residual floor: their
   differences are printed, ROADMAP C20); last ``table10_wallclock`` with
   the DiT at full width and ``HERD_LAYERS`` (14) of its 28 blocks (since
   PR 30; 28 before) at its cut size (``DIT_CUT``): served wall seconds
   per request, p50 and p95 by policy, and its four gates (on the
   herd's virtual-clock replay).

15. the model-parallel DiT (``models.dit.make_denoiser(shard_axis=
   "model")``: the rows split over ``model``, every layer's K/V gathered
   into the flash forward) on phase 4's DiT: (a) on an NCCL group of one
   rank, mesh ``make_srds_mesh(1, 1, 1)``, ``srds_sample`` with the bound
   denoiser and ``make_sharded_sampler(..., data_axis="data")`` at phase
   14's tolerance, each bitwise equal to the plain ``srds_sample`` with
   its launch counts (B1, B2, B3) and the all-gathers counted, the input
   moved by one ulp as the control that must differ; ``SHARD_SERVED``
   requests through the engine over ``mesh``, ``axis`` and ``data_axis``
   bitwise equal to the plain engine at its ``FixedBudget`` fallback; the
   profiler's records of the port's kernels within the window's lost
   records of the counters' launches on both paths, and of the activity
   only the mesh path has: NCCL, one record an all-gather;
   (d) the compressed data-parallel step at world size 1 on phase 7's
   state and batch: with a zero carry ``|mean - g| <= scale / 2`` and the
   carry ``g - mean`` exactly (a carry shifted by one quantum the control),
   then one ``make_dp_train_step_compressed`` step, its loss the plain
   loss's, its gradients the ones computed beside it within
   ``DP_GRAD_REL_L2``, its parameters AdamW's update by the mean its
   collective returned bitwise (the negated mean the control), B3 and B5
   once a layer; the group torn down; (b) the row-sharded
   body at full width in f32: shard r of m in ``SHARD_SPLITS`` fed the
   unsharded forward's own K/V through its ``kv_gather`` hook, its local
   K/V and its output rows within ``SHARD_REL_L2`` of the full forward's,
   with its positions left unshifted as the control that must miss it;
   (c) in bf16, the flash forward at the shard shape (Sq 512, Sk 1024,
   D 72, the tensor-core route) on each layer's own inputs of a shard
   forward against its plain version within ``SHARD_FLASH_REL_L2``; the
   phase's seconds.
16. the tensor-, sequence- and data-parallel language models at one NCCL
   rank, a ``(data 1, model 1)`` mesh with ``ParallelCtx(mesh=...)``:
   (a) full-width, full-depth ``qwen3-8b`` serving phase 8's 4 requests
   through ``ServingEngine`` on the flash-decoding cache, in turns with
   the plain engine on the same parameters (plain, mesh, mesh, plain):
   tokens and the last step's logits bitwise, launch counts equal, the
   collectives a prefill and a decode step issue, one decode step of each
   under the profiler (the same launches counted, each step's records of
   the port's kernels its launches short of them by no more than the
   records its window lost, C12; the kernel names only the mesh step runs
   listed), and the plain prefill
   with the unembedding one ulp up as the control that must miss the
   bitwise check; (b) ``qwen3-8b`` at 8 of 36 layers trained 2 steps at 2 x 2048
   through ``launch.train.build_on_mesh`` (``sp``, ZeRO-1) and through
   the plain step from the same seed: each step's loss and grad norm
   bitwise, every parameter and moment after each step bitwise (exact
   integer digests of their bits), launch counts equal; (c) the same for
   ``rwkv6-1.6b`` and ``hymba-1.5b`` cut to 4 layers at full width (one
   step each), which puts B6 and the scan on the path; (d) the kernels at
   the shard shapes one rank of ``model`` 2 or 16 gets, each against its
   twin within phase 3's limits, with ms, the bound and SDPA's time for
   the flash rows (``shard_kernel_rows``; rows ``<kernel>_model<m>`` in
   the kernels line, their launches the phase's world-1 path's); the
   phase's seconds.

17. the MoE models at one NCCL rank, a ``(data 1, model 1)`` mesh:
   (a) ``kimi-k2-1t-a32b`` at 1 of its 61 layers and (b) ``arctic-480b``
   at 2 of its 35, full width with every expert (384 and 128), drawn on
   the card, serving phase 8's 4 requests through ``ServingEngine`` plain
   and with ``use_ep`` on the mesh (the same parameters): tokens equal,
   the prefill's top-k ids equal, the flash forward once a layer a
   prefill on the tensor-core route, 3 all-to-alls a layer a call on the
   EP path and none on the plain one, the host syncs of one decode step
   (sync debug mode), peak memory, each MoE layer's device time in the
   prefill and a decode step beside its bound (the grouped FLOPs at the
   bf16 peak or the used experts' weight bytes at the HBM rate), and the
   first MoE layer's output on its own prefill inputs against the f32
   loop over experts, which routes on its own (every token's chosen
   experts equal the program's), within ``MOE_LAYER_REL`` (largest
   per-token rel L2) with one token's top expert swapped as the control
   that must miss;
   (c) ``arctic-480b`` at 1 layer with ``MOE_TRAIN_EXPERTS`` of its 128
   experts trained ``MOE_TRAIN_STEPS`` steps at 2 x 2048 through
   ``launch.train.build_on_mesh`` (``use_ep``, ``sp``, ZeRO-1) and through
   the plain step from the same seed: the loss, aux and grad norm of each
   step and every parameter after it bitwise, the plain step with the
   router's gradient zeroed as the control that must miss; launch counts
   equal;
18. the rest of the zoo: (a) ``qwen3-14b`` and ``qwen1.5-32b`` at full
   width and depth serving phase 8's requests with phase 8's checks
   (qwen1.5-32b's on the first request: its weights and cache fill the
   card); (b) ``stablelm-3b`` (32 layers), (c) ``hubert-xlarge`` (48,
   non-causal, frame features from ``AudioStream``) and (d)
   ``phi-3-vision-4.2b`` (16 of 32 layers, ``VLMStream``) trained with
   phase 10's checks (the broken backward flips the causal mask; for the
   vision model the loss counting the image positions is a further
   control), and phi-3-vision at full depth prefilling 576 image positions
   and text and decoding 16 steps (decode step 1 against
   ``forward_train``, the prefill without its image embeddings the
   control); (e) the TimeConditioned ``qwen3-8b`` (4 of 36 layers, full
   width, bf16) as the SRDS denoiser on latents of 2 x 256 x 4096:
   ``srds_sample`` at ``max_iters = B`` against ``sample_sequential``
   within ``SRDS_VS_SEQ_REL_L2``, the moved input as the control; (f) the
   flash kernels at the zoo's shapes (``ZOO_ROWS``: D 112 GQA, D 128 MHA,
   D 80 and 96 with the backward, hubert's non-causal D 80, the
   TimeConditioned non-causal GQA), each against its twin within phase
   3's limits with ms, the bound and SDPA's time; rows
   ``flash_attention_<row>_{fwd,bwd_dq,bwd_dkv}`` in the kernels line.
   Phases 17 and 18 print their seconds.
19. the tuning seam (``repro_torch.kernels.tuning``): each family's
   resolved config and source at the main paths' shapes (the sweep's
   cases); each family launched once at a candidate the heuristics do not
   give (``TUNING_CANDIDATES``, pinned through ``KernelTuner(overrides=
   ...)``) and held to its plain version within phase 3's limits: the
   elementwise kernels on other threads, clusters and spans (outputs
   bitwise, sums to 1e-5), the flash forward and backward from the
   3-stage builds phase 2 made (rel L2 1e-4 and 1e-3 at the DiT's shape),
   the WKV backward's dv sum on 64 threads (every gradient bitwise the
   default's), the scan forward and backward on other channels, ring
   depth and segments (within SCAN_REL_L2 and SCAN_BWD_REL_L2); for the
   elementwise and scan kernels the profiler's record of each launch
   (grid and block) equals the geometry the tuner gave; then the sweep's
   card mode on its launch knobs (``autotune_kernels.sweep(launch_only=
   True)``: no ``nvcc``, the schema and round-trip checks) and table14's
   rows on the card, ``parity_ok`` for every family.  No build happens in
   the phase (``_build.build_log`` unchanged); it prints its seconds.  A
   committed ``tuning_tables/sm90.json`` is built in phase 2 (its
   variants), printed here with each of its keys' cases timed under it
   and under the shipped constants in turns (and held to the plain
   version), and phases 4-18 run under it (phase 4's counts hold).

Phases 4-8, 10, 12, 13, 14 and 15 also hold the flash kernels' launches on their
main paths, forward and backward, to their tensor-core route
(``ops.route_counts``: every attention there is bf16 with head dim 64,
72 or 128; the backward runs in phases 7, 10 and 13).  Each kernel's
launch and build geometry there comes from the tuning seam's process
tuner: the committed table where it names the key, else the shipped
constants.  Phases 10 and 11
end with ROADMAP C10's reading: the busy share of ``BUSY_STEPS`` (2)
``train_loop`` steps as the launcher
runs them (``log_every=10``, pinned non-blocking batch copies) and as it
ran before (``log_every=1``, pageable copies), each under the profiler
and PyTorch's sync debug mode (the parameters are put back after).

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""
import collections
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound's rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # f32: no tensor cores
SEED = 0
N_STEPS, BLOCKS, SAMPLES = 25, 5, 2
EARLY_TOL = 1e-2
# phase 5: the ddpm solver's native frozen-noise seed; ParaDiGMS's
# tolerance for the run held against the sequential sample (near 0: its
# mean-square test never passes, so every sweep slides one point and the
# last lands on the sequential solve) and its reading's
DDPM_SEED = 21
PD_EXACT_TOL, PD_READ_TOL = 1e-9, 1e-3
# srds at max_iters=B vs sequential: exact in exact arithmetic; here bf16
# weights and activations (2^-8 relative per rounding) in GEMMs whose shape,
# and so cuBLAS's kernel and summation order, depend on the batch (10
# latents per fine step, 2 per sequential step) perturb every eval.  An
# H100 run measured 1.05e-5; the limit keeps a margin of about 100x.
SRDS_VS_SEQ_REL_L2 = 1e-3
# phase 6: the serving engine's slots, and a bursty trace whose tiers
# draw (tol=0, tol=0, loose | loose, loose, loose) from this seed (checked)
SERVE_SLOTS, SERVE_PERIOD, SERVE_TRACE_SEED = 2, 1.0, 75
# the loose tier's tol, between the residuals of refinements 2 and 3 in
# phase 4's early-exit delta history (an H100 run read 0.159 and 0.0093
# there, and 0.153-0.164 and 0.0092-0.0093 for the served requests), so
# its requests stop at refinement 3, a factor 3 or more from any residual
LOOSE_TOL = 5e-2
# phase 14: the sharded driver on one NCCL rank runs srds_sample's blocks
# in the same batches, so its sample is within this rel L2 of
# srds_sample's; the control moves the input by DRIVER_PERTURB x N(0, 1)
SHARDED_REL_L2 = 1e-6
DRIVER_PERTURB = 1e-2
# phase 14: table9's requests at tolerances below this stop inside the
# toy's f32 residual floor (~2e-5 at N=64), where the card's rounding and
# the CPU's may decide a count differently (ROADMAP C20); the rest must
# stop at the same iteration on both
ROUNDOFF_FREE_TOL = 1e-3
# phase 15: the model-parallel DiT.  (b) shard r of m of the row-sharded
# forward, fed the full forward's K/V, against the full forward's rows in
# f32 (and its local K/V against theirs); the control leaves its positions
# unshifted.  (c) the flash forward at the shard shape (Sq = S/2 against
# Sk = S, bf16, the tensor-core route) on each layer's own inputs
# against its plain version, the limit of phase 3's bf16 cases
SHARD_SPLITS = (2, 4)
# phase 14's served herd: the DiT at full width and this many of its 28
# blocks.  The herd's gate runs on a virtual-clock replay beside the
# wall-clock one since PR 30, which took the herd from ~150 to 208 s at 28
# (an H100 run) and a whole run to 1109 s of the 1200
HERD_LAYERS = 14
SHARD_REL_L2 = 1e-5
SHARD_FLASH_REL_L2 = 1e-4
SHARD_SERVED = 2           # (a): requests served through the mesh engine
# (d): the compressed step's gradients against the same loss's gradients
# taken beside it (the same kernels on the same inputs; the limit allows
# for a backward that sums in another order from one call to the next)
DP_GRAD_REL_L2 = 1e-5
# the port's kernels by device name: DDIM (B2), the update and residual
# (B1), the flash forward (B3), the update alone (B4)
PORT_KERNEL_NAMES = ("ddim_fused_kernel", "parareal_resid_cluster_kernel",
                     "flash_fwd_kernel", "parareal_update_cluster_kernel")
# PyTorch's sync debug mode's warning for a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
# the l2_mean run against the l1_mean run, tol=0 requests: the norm
# changes nothing that is computed, so bitwise is expected
SERVE_L2_VS_L1_REL = 1e-6
TRAIN_BATCH, TRAIN_STEPS, GRAD_BATCH = 8, 5, 2
# a tenth of the launcher's default (LAUNCHER_LR): the random-weight DiT
# (adaLN gates open in all 28 layers) is far rougher than the adaLN-zero
# init, and Adam's first steps move every weight by about the step's lr.
# Phase 7 ends with a reading of the held-out probe at LAUNCHER_LR: on an
# H100 it went from 2.044 down to 0.569 after 3 steps, then up to 2.282
# after 5; at TRAIN_LR it fell to 1.623.
TRAIN_LR, LAUNCHER_LR = 3e-5, 3e-4
# the whole gradient at batch 2, full depth, bf16, through the kernels vs
# through the plain attention: the same math rounded to bf16 at other
# places.  An H100 run measured 1.55e-3, and 1.75e-3 over the q, k and v
# projections' leaves alone.  The first limit, 5e-2, let a backward
# without its delta term through (1.10e-2; 0.148 over q/k/v) and barely
# caught one with the attention gradients zeroed (5.88e-2; 1.0 over
# q/k/v): most of the gradient does not flow through attention.  This
# limit, for both readings, is 3x the measured values and half the delta
# control's; the run's controls must miss it in both.
KERNEL_VS_PLAIN_GRAD_REL_L2 = 5e-3
# dq/dk/dv in bf16 against the plain backward: the kernel rounds once from
# f32, the plain version at other places, so they differ by about one bf16
# ulp (2^-7 relative at most; an H100 run measured 1.95e-3 absolute)
BWD_BF16_ATOL, BWD_BF16_RTOL = 4e-3, 1e-2
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the forward's causal, window and GQA forms against the plain version,
# (atol, rtol) and a rel L2 limit over the whole output, by dtype.  In bf16
# the kernel rounds its f32 result once, the plain version too, after
# summing in another order: an H100 run measured 3.9e-3 max abs error
# (one ulp for |o| in [0.5, 1)) in both bf16 cases.  Typical |o| at S 2048
# is only 0.04-0.05, so the rel L2 over all outputs is what catches a small
# bias in late rows: the same run read 3.66e-5 and 3.59e-5 (bf16) and
# 7.1e-7 (f32); the limits are about 3x those
MASKED_TOL = {"bfloat16": (8e-3, 1e-2), "float32": (2e-5, 2e-5)}
MASKED_REL_L2 = {"bfloat16": 1e-4, "float32": 2e-6}
# the backward's masked and grouped forms against the plain backward, rel
# L2 over dq, or over dk and dv: each side sums in f32 in its own order
# and rounds once, so in bf16 few elements differ, by one ulp
BWD_MASKED_REL_L2 = {"bfloat16": 1e-3, "float32": 1e-5}
# the WKV backward against its plain version, rel L2 per gradient: the
# same f32 recurrence summed in another order (dr, dk, dv then rounded
# once to r's dtype)
WKV_BWD_REL_L2 = {"bfloat16": 1e-2, "float32": 1e-4}
# phases 8-9: 4 requests for ServingEngine(batch_size=4), token ids below
# both vocabularies (rwkv6's 65,536), the same requests for both models;
# phase 12 serves the same prompt lengths and budgets with ids below
# hymba-1.5b's vocabulary
LM_PROMPTS, LM_NEW, LM_TOKEN_IDS = (2048, 1536, 1024, 512), (32, 32, 16,
                                                            16), 65536
# (kernels vs plain prefill, teacher-forced decode) rel L2 limits.  qwen3-8b
# in bf16: an H100 run measured 1.52e-2 and 1.49e-2 (one bf16 ulp in the
# attention outputs, or other cuBLAS kernels for 4 rows, carried through 36
# layers of random weights), and 0.891 for the causal=False control: the
# limit is about 3x the readings and 1/18 of the control.  rwkv6-1.6b's
# random-weight bf16 model amplifies any change of rounding: an H100 run
# read 0.466 kernels vs plain on its served prefill, while on each layer's
# own inputs 2e-4 of the WKV outputs differed from the plain scan's, nearly
# all by one ulp; the plain path against itself with half of layer 0's WKV
# output moved one ulp read 0.712 (layer 23: 3.0e-3).  So its checks run
# the same weights in f32: that run measured 2.37e-4 (logits), 1.78e-4
# (final WKV states) and 3.77e-5 (teacher forcing), and 1.35 for the
# dropped-state control: the limit is 4x the largest reading.
LM_LIMITS = {"qwen3-8b": (5e-2, 5e-2), "rwkv6-1.6b": (1e-3, 1e-3),
             "qwen3-14b": (5e-2, 5e-2), "qwen1.5-32b": (5e-2, 5e-2)}
# phase 18 (a): the served depth (None: the whole model).  qwen1.5-32b at
# all 64 layers (70.4 GB of bf16 weights, a 10.9 GB cache at 4 x 2080
# positions) ran out of memory in the prefill's MLP on an H100 (77.25 GiB
# allocated by PyTorch of the 79.18 GiB, an 856 MiB f32 SiLU wanted);
# each layer is 1.14 GiB of weights and cache, so it serves 62; its checks
# run on the first request (LM_CHECK_ROWS)
LM_SERVE_LAYERS = {"qwen3-14b": None, "qwen1.5-32b": 62}
LM_CHECK_ROWS = {"qwen3-14b": None, "qwen1.5-32b": 1}
# phase 12: hymba-1.5b's (kernels vs plain prefill, teacher-forced
# decode) rel L2 limits, in f32 on the served weights (ROADMAP Rules: a
# random bf16 model amplifies rounding).  An H100 run read 2.12e-4 (last
# logits), 1.77e-4 (final SSM states) and 8.2e-6 (teacher forcing), and
# 1.11 for the window=None control: over all 32 layers the random model
# is not chaotic in f32, so no depth cut; the limit is about 5x the
# largest reading, as rwkv6-1.6b's
HYMBA_LIMITS = (1e-3, 1e-3)
# phases 10-11: LM training at batch 2 x 2048 for 5 AdamW steps,
# qwen3-8b at its published widths with 8 of its 36 layers (2.79 B
# parameters: 33.5 GB of weights, gradients and f32 moments; all 36 would
# need 98 GB), rwkv6-1.6b whole (None).  The lr (the schedule's 5 warm-up
# steps rise to half of it): qwen3-8b at the launcher's default; rwkv6-
# 1.6b at a third of it.  Its random-weight model is chaotic (phase 9):
# scripts/torch_lm_probe_sweep.py reads its held-out loss flat over 5
# steps at lr 3e-5 to 6e-4 and rising above (PERF.md); both gates read
# the trained batches (FIT_MARGIN)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 2048, 5
LM_TRAIN_LR = {"qwen3-8b": 3e-4, "rwkv6-1.6b": 1e-4, "hymba-1.5b": 3e-4,
               "stablelm-3b": 3e-4, "hubert-xlarge": 3e-4,
               "phi-3-vision-4.2b": 3e-4}
# phase 18 trains stablelm-3b (32 layers) and hubert-xlarge (48) whole,
# phi-3-vision-4.2b at 16 of its 32 layers; the depth is given so that the
# optimizer state comes after the gradient check (the plain attention's
# f32 intermediates of every layer at 1 x 2048 beside 22 GB of moments
# would not fit)
LM_TRAIN_LAYERS = {"qwen3-8b": 8, "rwkv6-1.6b": None, "hymba-1.5b": None,
                   "stablelm-3b": 32, "hubert-xlarge": 48,
                   "phi-3-vision-4.2b": 16}
# phases 10-11's gate (check 3): the loop must lower the mean loss over the
# 5 batches it trains on by more than FIT_MARGIN, and the same loop from
# the same weights with the update reversed must not (check 5).  A
# held-out batch cannot tell them apart (ROADMAP C11): each training batch
# holds progressions over its own ranges of token ids, so training raises
# a held-out batch's loss as it lowers its own.  On an H100, scripts/
# torch_lm_probe_sweep.py --trained read, for rwkv6-1.6b, a fall of
# 0.095-0.122 over 6 model seeds with the WKV kernels of row and column
# blocks, 0.081-0.121 with the ones before them and 0.110 with the plain scan
# (seed 0), and a rise of 0.084-0.106 with the update reversed; for
# qwen3-8b (8 layers, lr 3e-4, seeds 0-5), a fall of 1.340-1.378 and a
# rise of 1.348-1.386 reversed; for hymba-1.5b (32 layers, seed 0, batch
# 0 alone) a fall of 0.581, 0.606 and 0.438 at lr 1e-4, 3e-4 and 1e-3 and
# a rise of 0.568, 0.605 and 0.485 reversed, and phase 13 (lr 3e-4) a fall
# of 0.689 over its 5 batches, 0.703 up reversed.  Each margin is about a
# third of the smallest fall.  Phase 18's first H100 run (lr 3e-4) read a
# fall of 0.680 for stablelm-3b, 0.390 for hubert-xlarge and 1.444 for
# phi-3-vision-4.2b (16 layers), and rises of 0.715, 28.2 and 1.457
# reversed
FIT_MARGIN = {"qwen3-8b": 0.45, "rwkv6-1.6b": 0.03, "hymba-1.5b": 0.2,
              "stablelm-3b": 0.2, "hubert-xlarge": 0.13,
              "phi-3-vision-4.2b": 0.45}
# the archs whose training phase ends with the C10 busy-share windows
BUSY_ARCHS = ("qwen3-8b", "rwkv6-1.6b")
# phase 3's B1/B2/B4 and scan readings: the calls of one profiler window
# (launches per call, device time per launch) and the calls timed for the
# host's enqueue time.  Launches are counted both as the host's launch
# calls and as the card's records of them, and each must equal the
# expected count (profiling.window_launches leads each window with
# LEAD_LAUNCHES kernels of its own: from the WKV cases of this phase on,
# the profiler kept no record of a window's first 1-4 launches)
LAUNCH_WINDOW_CALLS, HOST_CALLS = 20, 200
# phases 10-11: the steps of each busy-share window (ROADMAP C10); 10
# (one launcher log interval) until phase 14 came: at 10 steps an H100 run
# spent 218 s in rwkv6-1.6b's two windows (the profiler's many small ops)
# and the whole run 937 s of its 1200; 5 until phases 17-18 came, when an
# H100 run of the whole script took 1127 s of the 1200
BUSY_STEPS = 2
# the gradient checks: qwen3-8b in bf16 at batch 1 x 2048 (the plain
# attention's (B, H, S, S) f32 intermediates for 8 layers), rwkv6-1.6b in
# f32 at batch 1 x 256 (the plain scan's autograd is a Python loop) on its
# trained weights' first 4 layers.  Rel L2 limits, whole and over
# QKV_LEAVES / DECAY_LEAVES alone, whose gradient flows only through the
# kernel under check.  qwen3-8b: an H100 run read 1.52e-2 and 1.56e-2
# (bf16 roundings at other places, through 8 layers of random weights),
# its controls inf and 2.9e3: the limit is about 3x the readings.
# rwkv6-1.6b: its random model's gradient explodes with depth (norm 15 at
# 1 layer, 83 at 4, 3.5e3 at 24), and so does any change of summation
# order: at init, f32, kernels vs plain read 9.2e-7 at 1 layer, 1.3e-5 at
# 4 and 7.7e-2 at 24 (0.91 after the 5 steps), so the check cuts the depth
LM_GRAD_BATCH, LM_GRAD_SEQ_F32, LM_GRAD_LAYERS_F32 = 1, 256, 4
LM_GRAD_REL_L2 = {"qwen3-8b": 5e-2, "rwkv6-1.6b": 1e-3, "hymba-1.5b": 1e-3,
                  "stablelm-3b": 5e-2, "hubert-xlarge": 5e-2,
                  "phi-3-vision-4.2b": 5e-2}
QKV_LEAVES = (".attn.wq", ".attn.wk", ".attn.wv")
DECAY_LEAVES = (".tmix.w_base", ".tmix.A_w", ".tmix.B_w")
# phase 13: hymba-1.5b's gradient check, f32 on the trained weights at
# batch 1 x HYMBA_GRAD_SEQ (past the window, so the window forms run; the
# plain attention keeps (H, S, S) f32 intermediates and the plain scan a
# graph of every step) over its first HYMBA_GRAD_LAYERS layers; its part:
# the leaves whose gradient flows only through the scan's dt (ddt) and
# the attention's q, k, v (the window backward).  Over all 32 layers the
# reading depends on the trajectory, as rwkv6-1.6b's does: two H100 runs
# whose backward summed in another order (blocks of 64 and 32 channels)
# trained to weights reading 4.79e-5 and 9.18e-4, so the check cuts the
# depth; over the first 4 layers a run read 1.35e-5, the ddt-dropped and
# window-dropped controls 0.397 and 1.77e-2 (LM_GRAD_REL_L2 1e-3)
HYMBA_GRAD_SEQ, HYMBA_GRAD_LAYERS = 1088, 4
DT_LEAVES = (".ssm.w_dt", ".ssm.b_dt")
# phase 13's check of the scan backward on the layers' own inputs: the
# plain backward is a Python loop of ~30 launches a step (about a second a
# layer at 2 x 2048), so the first, a middle and the last layer
HYMBA_SCAN_CHECK_LAYERS = (0, 16, 31)
# the scan's counters: the forward, and the backward's three launches (the
# replay of its segments, the walk back and the sum)
SCAN_KERNELS = ("selective_scan", "selective_scan_bwd_replay",
                "selective_scan_bwd", "selective_scan_bwd_sum")
# the flash forward's launches by route on each main path (check_tc_route)
ROUTES_BY_PATH = {}
# the selective scan against its plain twin (phase 3 and phase 12's
# layer check), f32: the same recurrence with the sum over the states in
# another order; (atol, rtol) and a rel L2 limit over y and over h_T.  An
# H100 run read 8.1e-8 to 8.4e-8 in phase 3 and at most 1.75e-7 on the
# served model's layers (max abs err 1.1e-5 at T 2048), its controls 0.63
# (D dropped) and 0.75 (h0 zeroed): the limit is about 6x the readings
SCAN_TOL, SCAN_REL_L2 = 1e-4, 1e-6
# the scan's backward kernel against ref.selective_scan_bwd (phase 3 and
# phase 13's layer check), f32, rel L2 per gradient: dB, dC and ddt sum
# 1,600 channels, da and dD every step, in other orders than the twin's.
# An H100 run read at most 1.2e-6 (da, which sums 2 x 2048 steps) in
# phase 3 and 1.1e-6 on the trained model's layers, its control (dy a
# step late) 1.4 and more: the limit is about 8x the readings
SCAN_BWD_REL_L2 = 1e-5
# phase 17: the MoE models.  Served at full width with every expert, the
# depth cut to what one card holds (kimi-k2 at 1 layer is 38.8 GB of bf16
# weights, 2 layers 73.0; arctic at 2 layers 55.4 GB); trained at 1 layer
# with MOE_TRAIN_EXPERTS of arctic's 128 experts (2.35 B parameters, 28 GB
# with f32 moments, twice: the plain and the EP model one after the other)
MOE_SERVE_LAYERS = {"kimi-k2-1t-a32b": 1, "arctic-480b": 2}
MOE_TRAIN_EXPERTS, MOE_TRAIN_STEPS = 16, 2
# the MoE layer in bf16 (its grouped FFN's outputs rounded to bf16 at
# each product, the combine in bf16) against the f32 loop over experts
# on the same inputs and routing: the largest per-token relative L2 over
# the prefill's 8192 tokens; one token's top expert swapped moves that
# token by about its routing weight (0.1 or more)
MOE_LAYER_REL = 5e-2
# phase 18 (d): phi-3-vision's served prefill (2 rows: the 576 image
# positions, then text) and its greedy decode steps
VLM_PROMPT, VLM_DECODE = 2048, 16
# phase 18 (e): the TimeConditioned qwen3-8b's depth and its latents
TC_LAYERS, TC_LATENTS = 4, (2, 256, 4096)
# phase 18 (f): the flash kernels at the zoo's shapes: (row, batch, q
# heads, KV heads, S, D, causal, with the backward, the path whose
# launches the row reports)
ZOO_ROWS = (
    ("causal_gqa_d112", 4, 64, 8, 2048, 112, True, False,
     "serve_kimi-k2-1t-a32b"),
    ("causal_mha_d128", 4, 40, 40, 2048, 128, True, False,
     "serve_qwen1.5-32b"),
    ("causal_d80", 2, 32, 32, 2048, 80, True, True, "train_stablelm-3b"),
    ("causal_d96", 2, 32, 32, 2048, 96, True, True,
     "train_phi-3-vision-4.2b"),
    ("noncausal_d80", 2, 16, 16, 2048, 80, False, True,
     "train_hubert-xlarge"),
    ("noncausal_gqa_d128", 2, 32, 8, 256, 128, False, False, "tc_srds"))
# a device kernel's name without its namespace and parameters, as the
# profiler records it: "void (anonymous namespace)::k<4, 4>(...)" -> k<4, 4>
# phase 19: a candidate a family that the heuristics do not give, launch
# knobs but the flash rings (build knobs: phase 2 builds those libraries,
# so the phase runs no nvcc)
TUNING_CANDIDATES = {
    "elementwise": {"ddim_threads": 128, "resid_threads": 256,
                    "resid_max_cluster": 4, "resid_slice_per_block": 1024},
    "flash": {"fwd_stages": 3, "bwd_stages": 3},
    "rwkv6": {"dv_sum_threads": 64},
    "selective_scan": {"channels": 32, "stages": 2, "bwd_channels": 16,
                       "segment_chunks": 1}}
KERNEL_NAME = re.compile(r"(\w+(?:<[^>]*>)?)[(]")
# the SFUs' rate for expf's ex2 (16 a clock an SM on compute capability
# 9.0, CUDA C++ Programming Guide, arithmetic instruction throughput) at
# the clock of the f32 peak above (67e12 / (132 SMs x 128 lanes x 2))
SFU_PER_S = 132 * 16 * 1.98e9
# the WKV kernel's final state against the plain scan's on one layer's
# inputs: the same f32 recurrence summed in another order (an H100 run
# measured at most 3.5e-8 over the 24 layers)
WKV_STATE_REL_L2 = 1e-5
# the bf16 WKV forward's out against the plain scan's, rel L2: both sum in
# f32 in their own order and round once, so a few outputs differ by one
# bf16 ulp.  H100 runs of the redesigned kernel (scripts/torch_wkv_bench.py
# and phase 3) read 1.7e-5 to 2.1e-5 at T 2048, 5.3e-6 with w over the
# whole clip and 5.1e-5 at T 1 (where the old kernel read the same): the
# limit is about 3x the largest; the plain scan without u reads far above
WKV_REL_L2 = 1.5e-4


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_case(label, got, want, atol, rtol, timing):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    print(f"  {label}: max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) "
          f"kernel_ms={timing['ms']:.4f} plain_ms={timing['plain_ms']:.4f} "
          f"bound_ms={timing['bound_ms']:.4f} ({timing['bound_by']}) "
          f"library_ms={timing['library_ms']}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max_abs_err {err})")
    return dict(case=label, max_abs_err=err, atol=atol, rtol=rtol, **timing)


def backward_cases(torch, ref, randn, cases):
    """The flash backward's dq and dkv kernels against ``ref.attention_bwd``
    at the training shape (batch 8 x 16 heads), the coarse batch, CIFAR
    width in f32 and ragged Sq/Sk.  ``plain_ms`` and ``library_ms`` time a
    whole backward: the plain version and SDPA's backward (the yardstick)
    compute dq, dk and dv together.  Every case is also held by rel L2
    over dq and over (dk, dv) (``BWD_MASKED_REL_L2``), each kernel is run
    twice and held bitwise equal, and at the training shape the term
    control runs (``bwd_terms_control``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    for bh, sq, sk, d, dtype in [(128, 1024, 1024, 72, "bfloat16"),
                                 (32, 1024, 1024, 72, "bfloat16"),
                                 (24, 64, 64, 64, "float32"),
                                 (32, 100, 77, 72, "bfloat16")]:
        tdt = getattr(torch, dtype)
        q, k, v, do = (randn((1, bh, s, d), tdt) for s in (sq, sk, sk, sq))
        q3, k3, v3, do3 = (x[0] for x in (q, k, v, do))
        o3, lse = fa.flash_attention_fwd(q3, k3, v3)
        delta = (do3.float() * o3.float()).sum(dim=-1)
        scale = d ** -0.5

        def dq_fn():
            return (fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta,
                                              scale),)

        def dkv_fn():
            return fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                              scale)

        def plain():
            return ref.attention_bwd(q, k, v, o3[None], lse[None], do,
                                     causal=False)

        want = plain()
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg)
        reps = 10 if sq >= 1024 else 100
        plain_ms = time_ms(plain, max(reps // 5, 2))
        library_ms = time_ms(lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), do, retain_graph=True), reps)
        reads = nbytes(q, k, v, do, lse, delta)
        atol, rtol = ((BWD_BF16_ATOL, BWD_BF16_RTOL) if dtype == "bfloat16"
                      else (1e-4, 1e-4))
        for name, fn, ref_out, flops in (
                ("flash_attention_bwd_dq", dq_fn, want[:1], 6.0),
                ("flash_attention_bwd_dkv", dkv_fn, want[1:], 8.0)):
            got = fn()
            b_ms, b_by = bound(reads + nbytes(*got),
                               flops * bh * sq * sk * d, dtype)
            timing = dict(ms=time_ms(fn, reps), plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms)
            rel = bwd_rel_l2(torch, fn, got, ref_out, name)
            cases[name].append(check_case(
                f"{name} {dtype} BH={bh} Sq={sq} Sk={sk} D={d} "
                f"({route_label(fa, tdt, d, backward=True)}; rel L2 "
                f"{rel:.3e}, limit {BWD_MASKED_REL_L2[dtype]}; two runs "
                f"bitwise)",
                torch.cat([g.reshape(-1) for g in got]),
                torch.cat([w.reshape(-1) for w in ref_out]), atol, rtol,
                timing))
        if bh == 128:
            bwd_terms_control(torch, fa, (q3, k3, v3, o3, lse, do3), want,
                              dict(causal=False))


def bwd_rel_l2(torch, fn, got, want, label) -> float:
    """Rel L2 of a backward kernel's outputs (dq, or dk and dv) against the
    plain backward's, held to ``BWD_MASKED_REL_L2``; a second run of ``fn``
    must give the same bits (one owner per output tile, no atomics)."""
    dtype = str(got[0].dtype).replace("torch.", "")
    rel = rel_l2(got, [w.reshape(g.shape) for g, w in zip(got, want)])
    if not rel <= BWD_MASKED_REL_L2[dtype]:
        raise AssertionError(f"{label}: rel L2 {rel} against the plain "
                             f"backward")
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, fn())):
        raise AssertionError(f"{label}: two runs differ")
    return rel


def bwd_terms_control(torch, fa, args, want, mask):
    """The tensor-core dq and dkv kernels with P and dS in 1, 2 and 3 bf16
    terms against the plain backward (rel L2 over dq and over (dk, dv)),
    each count timed (dq and dkv together): the 1-term control must miss
    ``BWD_MASKED_REL_L2`` on both while the kernels' count meets it (run
    at the DiT's and qwen3-8b's shapes)."""
    limit = BWD_MASKED_REL_L2["bfloat16"]
    rel, ms = {}, {}
    for terms in (1, 2, 3):
        dq, dk, dv = fa.flash_attention_bwd_terms(*args, terms, **mask)
        rel[terms] = (rel_l2([dq], [want[0].reshape(dq.shape)]),
                      rel_l2([dk, dv], [want[1].reshape(dk.shape),
                                        want[2].reshape(dv.shape)]))
        ms[terms] = time_ms(lambda: fa.flash_attention_bwd_terms(
            *args, terms, **mask), 10)
    print("    P and dS in bf16 terms, rel L2 of dq / (dk, dv) vs plain "
          "(dq + dkv ms): " + ", ".join(
              f"{t} term{'s' if t > 1 else ''} {a:.3e} / {b:.3e} "
              f"({ms[t]:.4f})" for t, (a, b) in rel.items())
          + f" (limit {limit}; 1 term is the control that must miss it)",
          flush=True)
    if not (min(rel[1]) > limit >= max(rel[fa.BWD_TC_TERMS])):
        raise AssertionError(f"backward terms control: 1 term {rel[1]} must "
                             f"miss {limit} and {fa.BWD_TC_TERMS} terms "
                             f"{rel[fa.BWD_TC_TERMS]} meet it")


def check_tc_route(ops, counts, label, path=None):
    """The flash kernels' launches of a main path (``counts``, read just
    after it), forward and the backward's dq and dkv, all went through the
    tensor-core kernels: every attention of the DiT, qwen3-8b and
    hymba-1.5b is bf16 with a head dim that is a multiple of 8.  Keeps the route counts of
    ``path`` for the kernels' JSON line and returns them."""
    routes = ops.route_counts()
    if path is not None:
        ROUTES_BY_PATH[path] = routes
    for name in ("flash_attention_fwd",) + BWD_KERNELS:
        if (routes[f"{name}_simt"] != 0
                or routes[f"{name}_tc"] != counts[name]):
            raise AssertionError(f"{label}: the {name} bf16 launches did "
                                 f"not all take the tensor-core route: "
                                 f"{routes}, {counts[name]} launches")
    return routes


def ptxas_readings(log: str, kernel: str):
    """``[(instance, registers, spill stores, spill loads)]`` of ``kernel``
    from nvcc's ``-Xptxas -v`` report (mangled names: the template
    arguments are read from ``ILi<n>E``)."""
    import re
    out, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            if kernel not in name:
                current = None
            else:               # integer template arguments, else the dtype
                current = (",".join(re.findall(r"L[ib](\d+)E", name))
                           or ("bf16" if "bfloat16" in name else "f32"))
            spills = None
            continue
        if current is None:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found:
            spills = (int(found.group(1)), int(found.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and spills is not None:
            out.append((current, int(regs.group(1)), *spills))
            current = None
    return out


def _bits(t):
    """A tensor's raw bits, for a bitwise comparison (-0.0 != 0.0)."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def rel_l2(got, want) -> float:
    """Relative L2 distance of two lists of tensors, taken as one vector."""
    import math
    import torch
    num = sum(torch.sum(torch.square(a.float() - b.float()))
              for a, b in zip(got, want))
    den = sum(torch.sum(torch.square(b.float())) for b in want)
    return math.sqrt((num / den).item())


def gradient_check(torch, ops, model, images):
    """The whole gradient of one ``diffusion_loss`` at batch ``GRAD_BATCH``
    through the kernels against the plain attention's, and two controls
    that the check must catch: the attention gradients zeroed, and the
    backward run without its ``delta = rowsum(dO * O)`` term.  The same
    holds over the q, k and v projections' leaves alone, whose gradient
    flows only through attention."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import diffusion_loss
    names, params = zip(*model.named_parameters())
    qkv = [i for i, n in enumerate(names)
           if n.endswith((".attn.wq", ".attn.wk", ".attn.wv"))]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t = 999.0 * torch.rand((GRAD_BATCH,), generator=g, device="cuda")
    small = {"images": images[:GRAD_BATCH]}
    eps = torch.randn(small["images"].shape, generator=g, device="cuda")

    def grads(use_kernel):
        loss, _ = diffusion_loss(model, small, t=t, eps=eps,
                                 use_kernel=use_kernel)
        return loss.item(), torch.autograd.grad(loss, params)

    def zeroed(q, k, v, o, lse, do, **_):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def no_delta(q, k, v, o, lse, do, *, scale=None, **_):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        zero = torch.zeros_like(lse)
        return (fa.flash_attention_bwd_dq(q, k, v, do, lse, zero, scale),
                *fa.flash_attention_bwd_dkv(q, k, v, do, lse, zero, scale))

    def distances(got):
        return (rel_l2(got, gp),
                rel_l2([got[i] for i in qkv], [gp[i] for i in qkv]))

    def control(bwd):
        kernel_bwd = ops.flash_attention_bwd
        ops.flash_attention_bwd = bwd
        try:
            return distances(grads(None)[1])
        finally:
            ops.flash_attention_bwd = kernel_bwd

    lp, gp = grads(False)
    lk, gk = grads(None)
    (rel, rel_qkv), loss_line = distances(gk), f"loss {lk:.6f} vs {lp:.6f}"
    del gk
    controls = {"attention gradients zeroed": control(zeroed),
                "delta dropped": control(no_delta)}
    del gp
    torch.cuda.empty_cache()
    print(f"  gradient at batch {GRAD_BATCH}, kernels vs plain attention: "
          f"rel L2 {rel:.3e}, q/k/v projections alone {rel_qkv:.3e} (limit "
          f"{KERNEL_VS_PLAIN_GRAD_REL_L2}), {loss_line}", flush=True)
    for name, (r, r_qkv) in controls.items():
        print(f"  control, {name}: rel L2 {r:.3e}, q/k/v projections "
              f"alone {r_qkv:.3e}, both must miss the limit", flush=True)
    if not max(rel, rel_qkv) <= KERNEL_VS_PLAIN_GRAD_REL_L2:
        raise AssertionError(f"kernel and plain gradients differ: rel L2 "
                             f"{rel}, over q/k/v {rel_qkv}")
    for name, (r, r_qkv) in controls.items():
        if not min(r, r_qkv) > KERNEL_VS_PLAIN_GRAD_REL_L2:
            raise AssertionError(f"the gradient check does not catch a "
                                 f"backward with the {name}: rel L2 {r}, "
                                 f"over q/k/v {r_qkv}")


def train_phase(torch, ops, cfg, tree):
    """Phase 7; returns the launch counts of the ``train_loop`` run."""
    import math
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.data import DataConfig, fold_in, make_stream
    from repro_torch.launch import train as launch
    from repro_torch.runtime import LoopConfig, train_loop
    from repro_torch.train import diffusion_loss

    t0 = time.perf_counter()
    cfg, model, opt_state, step, _ = launch.build(
        cfg.name, lr=TRAIN_LR, total_steps=TRAIN_STEPS, params=tree,
        device="cuda")
    stream = make_stream(cfg, DataConfig(seed=SEED,
                                         global_batch=TRAIN_BATCH),
                         device="cuda")
    print(f"[7/15] training {cfg.name} through launch.train.build "
          f"({time.perf_counter() - t0:.1f} s), batch {TRAIN_BATCH}, "
          f"{stream.size}x{stream.size}x{stream.channels} images", flush=True)
    loop_seed = SEED + 1

    gradient_check(torch, ops, model, stream.batch(0)["images"])

    # the probe: a batch the loop does not train on (it takes batches
    # 0 .. TRAIN_STEPS - 1), with fixed t and eps
    probe = {"images": stream.batch(TRAIN_STEPS)["images"]}
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    probe_t = 999.0 * torch.rand((TRAIN_BATCH,), generator=g, device="cuda")
    probe_eps = torch.randn(probe["images"].shape, generator=g,
                            device="cuda")

    def probe_loss(m):
        with torch.no_grad():
            return diffusion_loss(m, probe, t=probe_t,
                                  eps=probe_eps)[0].item()

    before = probe_loss(model)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = Checkpointer(ckdir, keep=1)
        rows = []

        def timed_step(*args, **kw):
            torch.cuda.reset_peak_memory_stats()
            out = step(*args, **kw)
            torch.cuda.synchronize()       # the step's wall time ends here
            rows.append({"peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            return out

        def log(i, m):
            rows[-1].update(m)
            print(f"  step {i}: wall {m['step_time_s']:.3f} s, loss "
                  f"{m['loss']:.5f}, grad_norm {m['grad_norm']:.4f}, lr "
                  f"{m['lr']:.3e}, peak memory {rows[-1]['peak_gb']:.2f} GB",
                  flush=True)

        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, opt_state, _ = train_loop(
            timed_step, model, opt_state, stream, loop_seed, ckpt,
            LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                       log_every=1), metrics_cb=log)
        loop_s = time.perf_counter() - t1
        counts = ops.launch_counts()
        routes = check_tc_route(ops, counts, "DiT train_loop", "train_loop")
        print(f"  train_loop ({TRAIN_STEPS} steps, main path): "
              f"{loop_s:.3f} s, launches {counts}, flash kernels by route "
              f"{routes}", flush=True)
        want = cfg.num_layers * TRAIN_STEPS
        for name in ("flash_attention_fwd",) + BWD_KERNELS:
            if counts[name] != want:
                raise AssertionError(f"{name}: {counts[name]} launches in "
                                     f"train_loop, expected {want}")
        losses = [r["loss"] for r in rows]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train losses not finite: {losses}")
        after = probe_loss(model)
        print(f"  held-out probe loss (batch {TRAIN_STEPS}, fixed t and "
              f"eps) {before:.6f} -> {after:.6f} at lr {TRAIN_LR}",
              flush=True)
        if not after < before:
            raise AssertionError("the probe loss did not fall")

        # the loop's last checkpoint against the live state, bitwise
        save_s = loop_s - sum(r["step_time_s"] for r in rows)
        size = sum(os.path.getsize(os.path.join(root, f))
                   for root, _, files in os.walk(ckdir) for f in files)
        live = {"params": dict(model.named_parameters()), "opt": opt_state}
        template = {"params": {n: torch.empty_like(p)
                               for n, p in live["params"].items()},
                    "opt": {"m": {n: torch.empty_like(x)
                                  for n, x in opt_state["m"].items()},
                            "v": {n: torch.empty_like(x)
                                  for n, x in opt_state["v"].items()},
                            "step": torch.empty_like(opt_state["step"])}}
        t2 = time.perf_counter()
        _, saved_step, _ = ckpt.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t2
        ckpt.close()
        same = all(torch.equal(_bits(a), _bits(b)) for (_, a), (_, b) in
                   zip(flatten(template), flatten(live)))
        print(f"  checkpoint step {saved_step}: {size / 1e9:.3f} GB, save "
              f"(the loop's last, async + wait) {save_s:.1f} s, restore "
              f"{restore_s:.1f} s, bitwise equal to the live state: {same}",
              flush=True)
        if saved_step != TRAIN_STEPS or not same:
            raise AssertionError("the checkpoint does not restore the live "
                                 "state bitwise")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del model, opt_state, live, template
    torch.cuda.empty_cache()

    # a reading: the same steps at the launcher's default learning rate
    _, model, opt_state, step, _ = launch.build(
        cfg.name, lr=LAUNCHER_LR, total_steps=TRAIN_STEPS, params=tree,
        device="cuda")
    readings = [probe_loss(model)]
    for s in range(TRAIN_STEPS):
        model, opt_state, _ = step(model, opt_state, stream.batch(s),
                                   torch.Generator(device="cuda")
                                   .manual_seed(fold_in(loop_seed, s)))
        readings.append(probe_loss(model))
    print(f"  reading: held-out probe loss after 0..{TRAIN_STEPS} steps at "
          f"the launcher's lr {LAUNCHER_LR}: "
          + " ".join(f"{x:.6f}" for x in readings), flush=True)
    del model, opt_state
    torch.cuda.empty_cache()
    return counts


def serve_phase(torch, ops, C, model_fn, sched, solver, layers):
    """Phase 6; returns the launch counts of the l1_mean run and of the
    l2_mean run."""
    import warnings
    import numpy as np
    from repro_torch import serve
    from repro_torch.serve import diffusion as sd
    B, S = C.resolve_blocks(N_STEPS, BLOCKS)
    shape = (64, 64, 4)
    tiers = [serve.Tier(tol=0.0, weight=1.0),
             serve.Tier(tol=LOOSE_TOL, weight=2.0)]
    trace = serve.bursty_trace(2, 3, period=SERVE_PERIOD, tiers=tiers,
                               seed=SERVE_TRACE_SEED)
    if [r.tol for r in trace] != [0.0, 0.0] + [LOOSE_TOL] * 4:
        raise AssertionError(f"unexpected tiers {[r.tol for r in trace]}")
    print(f"[6/15] serving: {len(trace)} requests in 2 bursts "
          f"{SERVE_PERIOD} s apart (tols {[r.tol for r in trace]}), "
          f"{SERVE_SLOTS} slots, N={N_STEPS}, B={B}, AsyncServeLoop on a "
          f"MonotonicClock, FIFO", flush=True)
    real_fetch = sd._host_fetch
    fetches = []

    def hidden_syncs(fn):
        """Run ``fn`` under PyTorch's sync debug mode; returns its result
        and the synchronizing calls it made (the mode does not see every
        kind, e.g. none inside the ctypes-bound kernels' C code)."""
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out, [str(w.message) for w in caught
                     if SYNC_WARNING in str(w.message)]

    # a control: the detector must see a plain .item()
    _, control = hidden_syncs(lambda: torch.ones(1, device="cuda").item())
    if len(control) != 1:
        raise AssertionError(f"the sync detector missed an .item(): "
                             f"{control}")

    def counted_fetch(f):
        fetches.append(tuple(f.host.shape))
        return real_fetch(f)

    def drive(label, norm, reqs, path):
        eng = serve.DiffusionSamplingEngine(
            model_fn, shape, solver, num_steps=N_STEPS,
            batch_size=SERVE_SLOTS, num_blocks=B, norm=norm,
            clock=serve.MonotonicClock(), device="cuda")
        loop = serve.AsyncServeLoop(eng, serve.FIFO(), max_inflight=2)
        fetches.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        sd._host_fetch = counted_fetch
        t0 = time.perf_counter()
        try:
            rep, hidden = hidden_syncs(lambda: loop.run(reqs))
        finally:
            sd._host_fetch = real_fetch
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        routes = check_tc_route(ops, counts, label, path)
        frontiers = eng.refine_frontiers
        ddim = eng.init_sweeps * B + sum(S + B - f for f in frontiers)
        blocks = sum(B - f for f in frontiers)
        resid = ("parareal_update_residual" if norm == "l1_mean"
                 else "parareal_update")
        want = dict.fromkeys(counts, 0)
        want.update({"flash_attention_fwd": layers * ddim,
                     "ddim_fused": ddim, resid: blocks})
        st = eng.stats()
        print(f"  {label}: wall {wall:.3f} s, {len(frontiers)} refinements "
              f"(frontiers {frontiers}), {eng.init_sweeps} init sweeps, "
              f"launches {counts} (flash kernels by route {routes}); host "
              f"fetches {len(fetches)} "
              f"({len(frontiers)} refinements + {len(rep.responses)} "
              f"completions), other host syncs {len(hidden)}; physical "
              f"evals {st['physical_evals']}, effective "
              f"{st['effective_evals']}", flush=True)
        if counts != want:
            raise AssertionError(f"{label}: launch counts {counts} != {want} "
                                 f"from the refinement record")
        if min(counts[k] for k in ("flash_attention_fwd", "ddim_fused",
                                   resid)) == 0:
            raise AssertionError(f"{label}: a kernel never ran: {counts}")
        if len(fetches) != len(frontiers) + len(rep.responses):
            raise AssertionError(f"{label}: {len(fetches)} host fetches, "
                                 f"expected one per refinement and one per "
                                 f"completion")
        if hidden:
            raise AssertionError(f"{label}: hidden host syncs: {hidden[:3]}")
        if rep.rejected or rep.preempted or \
                sorted(rep.responses) != list(range(len(reqs))):
            raise AssertionError(f"{label}: not every request completed")
        return rep, counts, wall

    rep, l1_counts, wall = drive("l1_mean run (main path)", "l1_mean", trace,
                                 "serve")
    for rid, req in enumerate(trace):
        r = rep.responses[rid]
        x0 = serve.default_noise(req.seed, shape, torch.float32, "cuda")
        cfg = C.SRDSConfig(num_blocks=B, tol=req.tol, truncate=True)
        alone = C.srds_sample(model_fn, sched, solver, x0[None], cfg)
        it = int(alone.iterations)
        evals = C.srds_stats(sched, solver, cfg, it).total_evals
        sample = torch.from_numpy(r.sample).cuda()
        if sample.shape != shape or not bool(torch.isfinite(sample).all()):
            raise AssertionError(f"request {rid}: bad sample")
        rel_alone = ((sample - alone.sample[0]).norm()
                     / alone.sample[0].norm()).item()
        line = (f"  request {rid} (seed {req.seed}, tol {req.tol}, arrival "
                f"{req.arrival_time:.1f} s): iterations {r.iterations} "
                f"(standalone {it}), evals {r.model_evals} (standalone "
                f"{evals}), latency {r.latency:.3f} s, delta history "
                f"{[float(f'{d:.4g}') for d in r.delta_history]}, rel L2 to "
                f"standalone {rel_alone:.3e}")
        if req.tol == 0.0:
            seq = C.sample_sequential(model_fn, sched, solver, x0[None])[0]
            rel = ((sample - seq).norm() / seq.norm()).item()
            line += f", to sequential {rel:.3e} (limit {SRDS_VS_SEQ_REL_L2})"
            if not rel <= SRDS_VS_SEQ_REL_L2:
                raise AssertionError(f"request {rid}: differs from the "
                                     f"sequential sample: rel L2 {rel}")
        print(line, flush=True)
        if (r.iterations, r.model_evals) != (it, evals):
            raise AssertionError(f"request {rid}: iterations/evals differ "
                                 f"from its standalone run")
    lats = sorted(r.latency for r in rep.responses.values())
    print(f"  latency p50 {rep.latency_p50:.3f} s, max {lats[-1]:.3f} s, "
          f"makespan {rep.makespan:.3f} s, wall {wall:.3f} s", flush=True)

    exact = [dict(vars(r), arrival_time=0.0) for r in trace[:2]]
    rep2, l2_counts, _ = drive("l2_mean run, the tol=0 requests", "l2_mean",
                               [serve.SampleRequest(**r) for r in exact],
                               "serve_l2_mean")
    for rid in range(2):
        a = rep2.responses[rid].sample
        b = rep.responses[rid].sample
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        print(f"  request {rid}: l2_mean vs l1_mean sample rel L2 {rel:.3e}, "
              f"bitwise equal {bool(np.array_equal(a, b))}", flush=True)
        if not rel <= SERVE_L2_VS_L1_REL:
            raise AssertionError(f"request {rid}: the l2_mean run's sample "
                                 f"differs from the l1_mean run's: {rel}")
    return l1_counts, l2_counts


def profile_reading(torch, label, fn):
    """One call of ``fn`` after a warm-up, under ``torch.profiler``: wall
    ms (host clock, profiler cost included), device ms summed over
    kernels, the busy share, and device ms by group (a reading)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.profiling import by_group, device_ms_by_name
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = by_group(device_ms_by_name(prof))
    dev = sum(groups.values())
    print(f"  profile, {label}: wall {wall:.3f} ms, device {dev:.3f} ms, "
          f"busy share {dev / wall:.3f}; " + ", ".join(
              f"{g} {ms:.3f} ms ({ms / dev:.2f})" for g, ms in
              sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)


def lm_requests(np, vocab=LM_TOKEN_IDS):
    """The LM phases' traffic: 4 prompts of random token ids below
    ``vocab`` (phases 8-9: below both of their vocabularies; phase 12:
    below hymba-1.5b's), from the seed, and their generation budgets."""
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, vocab, n), m)
            for n, m in zip(LM_PROMPTS, LM_NEW)]


def ulp_distance(torch, a, b):
    """Elementwise distance between two bf16 tensors in units in the last
    place (the bit patterns mapped to ordered integers; -0 and +0 are 0)."""
    def key(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (key(a) - key(b)).abs()


def wkv_layer_check(torch, ops, tf, cfg, model, batch):
    """Every WKV launch of one bf16 prefill held against the plain scan on
    the same inputs (each layer's own r, k, v, decay and state): out within
    2e-2 + 2e-2 |x| and the final state to WKV_STATE_REL_L2 (rel L2, f32);
    the outputs' distance in bf16 ulps is a reading."""
    kernel_wkv, errs = ops.rwkv6_wkv, []

    def both(r, k, v, w, u, state=None, *, use_kernel=None):
        out, s_t = kernel_wkv(r, k, v, w, u, state)
        out_r, s_r = kernel_wkv(r, k, v, w, u, state, use_kernel=False)
        if not torch.allclose(out.float(), out_r.float(), atol=2e-2,
                              rtol=2e-2):
            raise AssertionError("rwkv6_wkv differs from the plain scan on "
                                 "a layer's inputs")
        ulps = ulp_distance(torch, out, out_r)
        far = (ulps > 1) & (out_r.float().abs() > 0)
        errs.append(((out.float() - out_r.float()).abs().max().item(),
                     rel_l2([s_t], [s_r]), ulps.max().item(),
                     out_r.float().abs()[far].max().item() if far.any()
                     else 0.0, (ulps > 0).float().mean().item(),
                     (ulps > 1).float().mean().item(),
                     out_r.float().abs().mean().item()))
        return out, s_t

    ops.rwkv6_wkv = both
    try:
        tf.prefill(cfg, model, batch)
    finally:
        ops.rwkv6_wkv = kernel_wkv
    out_err, state_rel, ulp_max, far_x = (max(e[i] for e in errs)
                                          for i in range(4))
    off1, off2, mean_x = (sum(e[i] for e in errs) / len(errs)
                          for i in (4, 5, 6))
    print(f"  1a. the WKV kernel on each of the {len(errs)} layers' own "
          f"inputs (bf16) vs the plain scan: out max abs err {out_err:.3e} "
          f"(within 2e-2 + 2e-2 |x|; mean |x| {mean_x:.3e}); out in bf16 "
          f"ulps: {off1:.2e} of the elements differ, {off2:.2e} by more "
          f"than 1 ulp (at most {ulp_max} ulps, where |x| <= {far_x:.3e}); "
          f"final state rel L2 at most {state_rel:.3e} (limit "
          f"{WKV_STATE_REL_L2})", flush=True)
    if len(errs) != cfg.num_layers or not state_rel <= WKV_STATE_REL_L2:
        raise AssertionError(f"rwkv6_wkv's state differs from the plain "
                             f"scan's on the model's inputs: {state_rel}")


def nudged_prefill(torch, ops, tf, cfg, model, batch, layer):
    """The plain prefill with one layer's WKV output changed by rounding
    alone: a seeded random half of its nonzero elements moved one bf16 ulp
    away from zero.  The kernel takes no part: this shows how far the
    model carries a change of one ulp in one layer."""
    plain_wkv, calls = ops.rwkv6_wkv, []
    gen = torch.Generator(device=batch["tokens"].device).manual_seed(SEED)

    def nudged(r, k, v, w, u, state=None, *, use_kernel=None):
        out, s_t = plain_wkv(r, k, v, w, u, state, use_kernel=False)
        if len(calls) == layer:
            up = (torch.rand(out.shape, generator=gen, device=out.device)
                  < 0.5) & (out != 0)
            out = (out.view(torch.int16) + up.to(torch.int16)).view(
                out.dtype)
        calls.append(layer)
        return out, s_t

    ops.rwkv6_wkv = nudged
    try:
        logits, _ = tf.prefill(cfg, model, batch, use_kernel=False)
    finally:
        ops.rwkv6_wkv = plain_wkv
    return logits


def serve_lm(torch, ops, cfg, model, reqs, arch, return_outs=False):
    """The LM phases' main path: ``reqs`` through
    ``ServingEngine(batch_size=len(reqs))``, launch counts reset just
    before and read just after, each prefill and decode call timed with
    its launches.  Checks every generation's length and ids and that every
    flash forward took the tensor-core route; prints the wall, prefill
    and decode times, tokens/s and peak memory.  Returns the run's launch
    counts and its calls (kind, seconds, launches), and with
    ``return_outs`` the generations."""
    from repro_torch.serve import Request, ServingEngine
    engine = ServingEngine(cfg, model, batch_size=len(reqs),
                           max_seq=max(LM_PROMPTS) + max(LM_NEW))
    calls = []

    def timed(kind, fn):
        def run(*args):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            calls.append((kind, time.perf_counter() - t,
                          {k: after[k] - before[k] for k in after}))
            return out
        return run

    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate([Request(prompt=p, max_new_tokens=m)
                            for p, m in reqs])
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    routes = check_tc_route(ops, counts, f"{arch} served", f"serve_{arch}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prefill_s = calls[0][1]
    decode_s = [c[1] for c in calls[1:]]
    n_tok = sum(len(o) for o in outs)
    print(f"  served (main path): wall {wall:.3f} s, prefill "
          f"{prefill_s:.3f} s, decode {1e3 * sum(decode_s) / len(decode_s):.2f}"
          f" ms per step over {len(decode_s)} steps (min "
          f"{1e3 * min(decode_s):.2f}), {n_tok} tokens, "
          f"{n_tok / wall:.1f} tokens/s, peak memory {peak:.2f} GB; launches "
          f"{counts}, flash kernels by route {routes}", flush=True)
    if [len(o) for o in outs] != [m for _, m in reqs] or not all(
            0 <= x < cfg.vocab_size for o in outs for x in o):
        raise AssertionError(f"{arch}: bad generations {outs}")
    return (counts, calls, outs) if return_outs else (counts, calls)


def check_launches(arch, counts, calls, per_call):
    """The served run's launch counts, exactly: ``per_call`` maps a kernel
    to its launches (per prefill, per decode step); every other count is
    0, in the run and in each call."""
    steps = len(calls) - 1
    want = dict.fromkeys(counts, 0)
    want.update({k: pre + dec * steps for k, (pre, dec) in per_call.items()})
    bad = [c for c in calls if any(
        c[2][k] != per_call.get(k, (0, 0))[c[0] == "decode"]
        for k in c[2])]
    if counts != want or bad:
        raise AssertionError(f"{arch}: launch counts {counts} != {want} "
                             f"(per prefill and decode step: {per_call}); "
                             f"calls off it: {bad[:2]}")


def lm_phase(torch, ops, step, arch, limits, check_rows=None):
    """Phases 8, 9 and 18 (a): ``arch`` at full width and depth with random
    weights from a seeded CUDA generator, serving 4 requests through
    ``repro_torch.serve.ServingEngine``; then the checks, on the first
    ``check_rows`` requests' rows (all by default).  Returns the launch
    counts of the served run."""
    import dataclasses
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.models.rwkv6 import RWKVState

    cfg = get_arch(arch)
    if LM_SERVE_LAYERS.get(arch):
        cfg = dataclasses.replace(cfg, num_layers=LM_SERVE_LAYERS[arch])
    t0 = time.perf_counter()
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    torch.cuda.synchronize()
    kernel = "rwkv6_wkv" if cfg.block == "rwkv6" else "flash_attention_fwd"
    print(f"[{step}/15] {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, "
          f"{tf.param_count(model) / 1e9:.3f} B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; serving {len(LM_PROMPTS)} "
          f"requests (prompts {LM_PROMPTS}, max_new_tokens {LM_NEW})",
          flush=True)
    reqs = lm_requests(np)
    counts, calls = serve_lm(torch, ops, cfg, model, reqs, arch)
    print(f"  launches per call: prefill {calls[0][2][kernel]}, decode "
          f"{sorted(set(c[2][kernel] for c in calls[1:]))} ({kernel})",
          flush=True)
    per_decode = cfg.num_layers if kernel == "rwkv6_wkv" else 0
    check_launches(arch, counts, calls, {kernel: (cfg.num_layers,
                                                  per_decode)})

    # a reading and the checks, on the engine's left-padded batch
    plen = max(LM_PROMPTS)
    toks = torch.zeros((len(reqs), plen), dtype=torch.long)
    for i, (p, _) in enumerate(reqs):
        toks[i, plen - len(p):] = torch.from_numpy(p)
    batch = {"tokens": toks[:check_rows].cuda()}
    if check_rows:
        print(f"  the checks below run on the first {check_rows} "
              f"request(s) (memory: the served model and its cache fill "
              f"the card)", flush=True)
    out = {}

    def prefill():
        out["logits"], out["cache"] = tf.prefill(cfg, model, batch)

    profile_reading(torch, f"prefill ({len(reqs)} x {plen} tokens)",
                    prefill)
    cache = out["cache"]
    if cfg.block == "attn_mlp":
        cache = tuple(F.pad(c, (0, 0, 0, 0, 0, 1)) for c in cache)
    first = {"tokens": out.pop("logits").argmax(-1)[:, None]}
    profile_reading(torch, f"decode step (batch {len(reqs)})",
                    lambda: tf.decode_step(cfg, model, first, cache, plen))
    del out, cache
    lim_plain, lim_tf = limits
    if cfg.block == "rwkv6":
        wkv_layer_check(torch, ops, tf, cfg, model, batch)
        # the served bf16 model amplifies rounding: readings, no limit.
        # The witnesses move one layer's WKV output by rounding alone, on
        # the plain path, and read what the kernel's path reads.
        logits, _ = tf.prefill(cfg, model, batch)
        plain, _ = tf.prefill(cfg, model, batch, use_kernel=False)
        first, last = (rel_l2([nudged_prefill(torch, ops, tf, cfg, model,
                                              batch, i)], [plain])
                       for i in (0, cfg.num_layers - 1))
        print(f"  reading, bf16 (the served dtype): prefill last logits, "
              f"kernels vs plain, rel L2 {rel_l2([logits], [plain]):.3e}; "
              f"witnesses, plain vs plain with a random half of one "
              f"layer's WKV output one bf16 ulp further from zero: layer 0 "
              f"{first:.3e}, layer {cfg.num_layers - 1} {last:.3e}; checks "
              f"1-3 run the same model in f32", flush=True)
        model.float()
    logits, cache = tf.prefill(cfg, model, batch)
    plain, plain_cache = tf.prefill(cfg, model, batch, use_kernel=False)
    rel = rel_l2([logits], [plain])
    line = (f"  1. prefill last logits ({next(model.parameters()).dtype}), "
            f"kernels vs plain: rel L2 {rel:.3e} (limit {lim_plain})")
    if cfg.block == "rwkv6":
        rel_s = rel_l2([cache.wkv], [plain_cache.wkv])
        line += f"; final WKV states rel L2 {rel_s:.3e} (same limit)"
        rel = max(rel, rel_s)
    print(line, flush=True)
    if not rel <= lim_plain:
        raise AssertionError(f"{arch}: kernels and plain prefill differ: "
                             f"{rel}")
    del plain_cache
    tok = logits[:, :cfg.vocab_size].argmax(dim=-1)
    if cfg.block == "attn_mlp":
        cache = tuple(F.pad(c, (0, 0, 0, 0, 0, 1)) for c in cache)
        dropped = None
    else:
        dropped = RWKVState(cache.x_tmix.clone(), torch.zeros_like(
            cache.wkv), cache.x_cmix.clone())
    step1, _ = tf.decode_step(cfg, model, {"tokens": tok[:, None]}, cache,
                              plen)
    full = tf.forward_train(cfg, model, {"tokens": torch.cat(
        [batch["tokens"], tok[:, None]], dim=1)})[:, -1]
    rel_tf = rel_l2([step1], [full])
    print(f"  2. teacher forcing: decode step 1 vs forward_train over prompt "
          f"+ first token: rel L2 {rel_tf:.3e} (limit {lim_tf}), argmax "
          f"equal {bool(torch.equal(step1.argmax(-1), full.argmax(-1)))}",
          flush=True)
    if not rel_tf <= lim_tf:
        raise AssertionError(f"{arch}: decode and the full forward differ: "
                             f"{rel_tf}")
    if dropped is None:
        wrong, _ = tf.prefill(dataclasses.replace(cfg, causal=False), model,
                              batch)
        rel_c, what, lim = rel_l2([wrong], [plain]), "check 1", lim_plain
        ctl = "prefill with causal=False"
    else:
        wrong, _ = tf.decode_step(cfg, model, {"tokens": tok[:, None]},
                                  dropped, plen)
        rel_c, what, lim = rel_l2([wrong], [full]), "check 2", lim_tf
        ctl = "decode step 1 with the carried WKV state dropped"
    print(f"  3. control, {ctl}: rel L2 {rel_c:.3e}, must miss {what}'s "
          f"limit {lim}", flush=True)
    if not rel_c > lim:
        raise AssertionError(f"{arch}: {what} does not catch the control "
                             f"({ctl}): {rel_c}")
    return counts


def scan_layer_check(torch, ops, tf, cfg, model, batch):
    """Every selective-scan launch of one prefill and of the decode step
    after it held against the plain twin on the same inputs (each layer's
    own xs, dt, B, C and state): y and h_T within SCAN_REL_L2 (rel L2);
    the largest absolute difference is a reading."""
    kernel_scan, errs = ops.selective_scan, []

    def both(*args, use_kernel=None):
        y, h_t = kernel_scan(*args)
        y_r, h_r = kernel_scan(*args, use_kernel=False)
        errs.append((args[0].shape[1], rel_l2([y], [y_r]),
                     rel_l2([h_t], [h_r]),
                     (y - y_r).abs().max().item()))
        return y, h_t

    ops.selective_scan = both
    try:
        logits, cache = tf.prefill(cfg, model, batch)
        tf.decode_step(cfg, model, {"tokens": logits.argmax(-1)[:, None]},
                       cache, batch["tokens"].shape[1])
    finally:
        ops.selective_scan = kernel_scan
    worst = {t: tuple(max(e[i] for e in errs if e[0] == t)
                      for i in (1, 2, 3)) for t in sorted({e[0] for e in errs})}
    print(f"  1a. the selective scan on each of the {len(errs)} launches' "
          f"own inputs (one prefill, one decode step) vs the plain twin: "
          + "; ".join(f"T {t}: y rel L2 at most {ry:.3e}, h_T {rh:.3e}, y "
                      f"max abs err {ea:.3e}"
                      for t, (ry, rh, ea) in worst.items())
          + f" (limit {SCAN_REL_L2})", flush=True)
    if len(errs) != 2 * cfg.num_layers or not max(
            max(w[:2]) for w in worst.values()) <= SCAN_REL_L2:
        raise AssertionError(f"selective_scan differs from the plain twin "
                             f"on the model's inputs: {worst}")


def hymba_phase(torch, ops, step):
    """Phase 12: hymba-1.5b at full width and depth with random bf16
    weights from a seeded CUDA generator, serving 4 requests through
    ``repro_torch.serve.ServingEngine``; then the checks.  Returns the
    launch counts of the served run."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    arch = "hymba-1.5b"
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    torch.cuda.synchronize()
    print(f"[{step}/15] {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, window {cfg.window}, SSM {cfg.ssm_d_inner}"
          f" x {cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{tf.param_count(model) / 1e9:.3f} B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; serving {len(LM_PROMPTS)} "
          f"requests (prompts {LM_PROMPTS}, max_new_tokens {LM_NEW}, ids "
          f"below {cfg.vocab_size})", flush=True)
    reqs = lm_requests(np, cfg.vocab_size)
    counts, calls = serve_lm(torch, ops, cfg, model, reqs, arch)
    kernels = ("flash_attention_fwd", "selective_scan")
    print("  launches per call: prefill " + ", ".join(
        f"{k} {calls[0][2][k]}" for k in kernels) + "; decode " + ", ".join(
        f"{k} {sorted(set(c[2][k] for c in calls[1:]))}" for k in kernels),
        flush=True)
    layers = cfg.num_layers
    check_launches(arch, counts, calls, {"flash_attention_fwd": (layers, 0),
                                         "selective_scan": (layers, layers)})

    # a reading and the checks, on the engine's left-padded batch
    plen = max(LM_PROMPTS)
    toks = torch.zeros((len(reqs), plen), dtype=torch.long)
    for i, (p, _) in enumerate(reqs):
        toks[i, plen - len(p):] = torch.from_numpy(p)
    batch = {"tokens": toks.cuda()}
    out = {}

    def prefill():
        out["logits"], out["cache"] = tf.prefill(cfg, model, batch)

    profile_reading(torch, f"prefill ({len(reqs)} x {plen} tokens)",
                    prefill)
    first = {"tokens": out.pop("logits").argmax(-1)[:, None]}
    cache = out.pop("cache")
    profile_reading(torch, f"decode step (batch {len(reqs)})",
                    lambda: tf.decode_step(cfg, model, first, cache, plen))
    del cache
    scan_layer_check(torch, ops, tf, cfg, model, batch)

    # checks 1-3 in f32 on the same weights (a random bf16 model amplifies
    # any change of rounding, ROADMAP Rules)
    model.float()
    lim_plain, lim_tf = HYMBA_LIMITS
    logits, cache = tf.prefill(cfg, model, batch)
    plain, plain_cache = tf.prefill(cfg, model, batch, use_kernel=False)
    rel, rel_s = rel_l2([logits], [plain]), rel_l2([cache.ssm_h],
                                                   [plain_cache.ssm_h])
    print(f"  1. prefill last logits (f32), kernels vs plain: rel L2 "
          f"{rel:.3e}; final SSM states rel L2 {rel_s:.3e} (limit "
          f"{lim_plain} for both)", flush=True)
    if not max(rel, rel_s) <= lim_plain:
        raise AssertionError(f"{arch}: kernels and plain prefill differ: "
                             f"{rel}, {rel_s}")
    del plain_cache
    tok = logits[:, :cfg.vocab_size].argmax(dim=-1)
    step1, _ = tf.decode_step(cfg, model, {"tokens": tok[:, None]}, cache,
                              plen)
    full = tf.forward_train(cfg, model, {"tokens": torch.cat(
        [batch["tokens"], tok[:, None]], dim=1)})[:, -1]
    rel_tf = rel_l2([step1], [full])
    print(f"  2. teacher forcing: decode step 1 vs forward_train over prompt "
          f"+ first token: rel L2 {rel_tf:.3e} (limit {lim_tf}), argmax "
          f"equal {bool(torch.equal(step1.argmax(-1), full.argmax(-1)))}",
          flush=True)
    if not rel_tf <= lim_tf:
        raise AssertionError(f"{arch}: decode and the full forward differ: "
                             f"{rel_tf}")
    del cache, full
    wrong, _ = tf.prefill(dataclasses.replace(cfg, window=None), model,
                          batch)
    rel_c = rel_l2([wrong], [plain])
    print(f"  3. control, prefill with window=None (full causal attention): "
          f"rel L2 {rel_c:.3e}, must miss check 1's limit {lim_plain}",
          flush=True)
    if not rel_c > lim_plain:
        raise AssertionError(f"{arch}: check 1 does not catch the control "
                             f"(window=None): {rel_c}")
    return counts


class NoCheckpoints:
    """A checkpointer for ``train_loop`` that keeps nothing.  The LM phases
    do not write their states (28 GB of parameters and moments for
    qwen3-8b's 8 layers); phase 7 holds the DiT's checkpoint bitwise and
    ``tests/test_torch_lm_train.py`` an LM restart-resume."""

    def latest_step(self):
        return None

    def save(self, *args, **kwargs):
        pass

    save_async = save

    def wait(self):
        pass


def busy_windows(torch, step, model, opt_state, stream, label):
    """ROADMAP C10's reading: ``train_loop`` over ``BUSY_STEPS`` steps as
    the launcher runs it (``log_every=LOG_EVERY``, the stream's pinned,
    non-blocking copies), and as it ran before the repair (``log_every=1``,
    plain copies from pageable memory), each under ``torch.profiler`` and
    PyTorch's sync debug mode: wall s, device s summed over kernels, the
    busy share and the synchronizing calls the mode saw.  The parameters
    are put back after (the phase's later checks read the trained ones)."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import pipeline
    from repro_torch.launch.train import LOG_EVERY
    from repro_torch.runtime import LoopConfig, train_loop
    from repro_torch.runtime.profiling import device_ms_by_name
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    real_copy = pipeline.host_to_device
    shares = {}
    for when, log_every, copy in (
            ("before the repair (log_every=1, pageable copies)", 1,
             lambda t, device: t.to(device)),
            (f"the launcher's (log_every={LOG_EVERY}, pinned copies)",
             LOG_EVERY, real_copy)):
        pipeline.host_to_device = copy
        torch.cuda.synchronize()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    train_loop(step, model, opt_state, stream, SEED + 3,
                               NoCheckpoints(),
                               LoopConfig(total_steps=BUSY_STEPS,
                                          ckpt_every=BUSY_STEPS,
                                          log_every=log_every),
                               metrics_cb=lambda i, m: None)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
            pipeline.host_to_device = real_copy
        dev = sum(device_ms_by_name(prof).values()) / 1e3
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
        shares[when] = dev / wall
        print(f"  C10 window, {label}, {BUSY_STEPS} steps {when}: wall "
              f"{wall:.3f} s, device {dev:.3f} s, busy share "
              f"{dev / wall:.3f}, synchronizing calls seen {syncs} "
              f"({syncs / BUSY_STEPS:.1f} a step)", flush=True)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return shares


def permuted_heads_bwd(real_bwd, torch):
    """A broken flash backward for a control: query head ``i`` read against
    KV head ``i % BKV`` in place of ``i // group`` (without groups, where
    that is the right head: against the next head).  The heads are
    permuted around the kernel, which then computes exactly that
    function."""
    def bwd(q, k, v, o, lse, do, **mask):
        bh, bkv = q.shape[0], k.shape[0]
        group = bh // bkv
        pos = torch.arange(bh, device=q.device)
        perm = pos // group + (pos % group) * bkv if group > 1 \
            else (pos + 1) % bh
        dq, dk, dv = real_bwd(q[perm], k, v, o[perm], lse[perm], do[perm],
                              **mask)
        out = torch.empty_like(dq)
        out[perm] = dq
        return out, dk, dv
    return bwd


def grad_readings(torch, ops, cfg, model, batch, part, controls):
    """The whole gradient of one ``lm_loss`` through the kernels against the
    plain path's (``use_kernel=False``), and over the leaves whose names
    end in ``part`` alone, as rel L2; then the same with each control's
    broken backward patched into ``ops``.  Returns ``(readings, loss
    line)``: ``{name: (whole, part)}`` with ``"kernels"`` first.
    ``controls`` maps a name to ``(attr, broken)``: the ``ops`` function
    to replace and its broken version, or ``("cfg", other)``: the loss of
    another config on the kernels' path."""
    from repro_torch.train import lm_loss
    names, params = zip(*model.named_parameters())
    sel = [i for i, n in enumerate(names) if n.endswith(part)]

    def grads(use_kernel, loss_cfg=cfg):
        loss, _ = lm_loss(loss_cfg, model, batch, use_kernel=use_kernel)
        return loss.item(), torch.autograd.grad(loss, params)

    def distances(got):
        return (rel_l2(got, gp),
                rel_l2([got[i] for i in sel], [gp[i] for i in sel]))

    lp, gp = grads(False)
    lk, gk = grads(None)
    readings = {"kernels": distances(gk)}
    del gk
    for name, (attr, broken) in controls.items():
        if attr == "cfg":            # another loss on the kernels' path
            readings[name] = distances(grads(None, broken)[1])
            continue
        real = getattr(ops, attr)
        setattr(ops, attr, broken)
        try:
            readings[name] = distances(grads(None)[1])
        finally:
            setattr(ops, attr, real)
    del gp
    torch.cuda.empty_cache()
    return readings, f"loss {lk:.6f} vs {lp:.6f}"


def check_grad_readings(readings, limit, part, arch):
    rel, rel_part = readings.pop("kernels")
    print(f"  gradient, kernels vs plain path: rel L2 {rel:.3e}, over "
          f"{part} alone {rel_part:.3e} (limit {limit})", flush=True)
    for name, (r, r_part) in readings.items():
        print(f"  control, {name}: rel L2 {r:.3e}, over {part} alone "
              f"{r_part:.3e}, both must miss the limit", flush=True)
    if not max(rel, rel_part) <= limit:
        raise AssertionError(f"{arch}: kernel and plain gradients differ: "
                             f"rel L2 {rel}, over {part} {rel_part}")
    for name, (r, r_part) in readings.items():
        # a control misses unless both readings are within the limit (a
        # broken backward may give inf or nan)
        if r <= limit or r_part <= limit:
            raise AssertionError(f"{arch}: the gradient check does not "
                                 f"catch the control ({name}): {r}, "
                                 f"{r_part}")


def lm_train_phase(torch, ops, step_no, arch):
    """Phases 10 and 11: ``arch`` trained for ``LM_TRAIN_STEPS`` AdamW steps
    at batch ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ`` through the kernels in
    both directions; the checks before and after.  Returns the launch
    counts of the ``train_loop`` run (the main path)."""
    import dataclasses
    import math
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.kernels import ref
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.runtime import LoopConfig, train_loop
    from repro_torch.train import lm_loss, make_train_step

    t0 = time.perf_counter()
    layers = LM_TRAIN_LAYERS[arch]
    lr = LM_TRAIN_LR[arch]

    def cut_model():
        # launch.build's own calls, with the depth cut (the launcher has
        # no depth flag); the optimizer state comes after the checks
        return tf.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), device="cuda", trainable=True)

    def cut_step(model, lr):
        return init_opt_state(dict(model.named_parameters())), \
            make_train_step(cfg, AdamWConfig(lr=lr, schedule=warmup_cosine(
                lr, max(10, LM_TRAIN_STEPS // 10), LM_TRAIN_STEPS)),
                loss_kind="lm")

    if layers is None:
        cfg, model, opt_state, step, _ = launch.build(
            arch, lr=lr, total_steps=LM_TRAIN_STEPS, device="cuda")
    else:
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        model = cut_model()
        opt_state = step = None
    stream = make_stream(cfg, DataConfig(seed=SEED,
                                         global_batch=LM_TRAIN_BATCH,
                                         seq_len=LM_TRAIN_SEQ),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = tf.param_count(model)
    print(f"[{step_no}/15] training {arch}: {cfg.num_layers} of "
          f"{get_arch(arch).num_layers} layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({cfg.dtype}, drawn on the card; "
          f"{time.perf_counter() - t0:.1f} s), batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ} from {type(stream).__name__}, lr "
          f"{LM_TRAIN_LR[arch]}", flush=True)
    bwd_name = "rwkv6_wkv_bwd" if cfg.block == "rwkv6" else \
        "flash_attention_bwd_dkv"
    errs = []

    # 1. the backward kernel on each layer's own inputs, captured from one
    # gradient of the training batch, against its plain version
    if cfg.block == "hymba":
        batch0 = stream.batch(0)
        hymba_layer_checks(torch, ops, ref, cfg, model, batch0)
    elif cfg.block == "rwkv6":
        real_wkv_bwd = ops.rwkv6_wkv_bwd

        def checked(r, k, v, w, u, ckpt, dout, ds_t=None, **tuner):
            got = real_wkv_bwd(r, k, v, w, u, ckpt, dout, ds_t, **tuner)
            want = ref.rwkv6_wkv_bwd(r, k, v, w, u, ckpt[:, :, 0], dout,
                                     ds_t)
            errs.append([rel_l2([g], [x]) for g, x in zip(got, want)])
            return got

        attr = "rwkv6_wkv_bwd"
        limit = WKV_BWD_REL_L2["bfloat16"]
        what = "dr/dk/dv/dw/du/ds0"
    else:
        real_bwd = ops.flash_attention_bwd

        def checked(q, k, v, o, lse, do, tuner=None, **mask):
            got = real_bwd(q, k, v, o, lse, do, tuner=tuner, **mask)
            want = ref.attention_bwd(q[None], k[None], v[None], o[None],
                                     lse[None], do[None], **mask)
            errs.append([rel_l2([g], [x[0]]) for g, x in zip(got, want)])
            return got

        attr = "flash_attention_bwd"
        limit = BWD_MASKED_REL_L2["bfloat16"]
        what = "dq/dk/dv"
    if cfg.block != "hymba":
        real = getattr(ops, attr)
        setattr(ops, attr, checked)
        try:
            batch0 = stream.batch(0)
            loss, _ = lm_loss(cfg, model, batch0)
            torch.autograd.grad(loss, list(model.parameters()))
        finally:
            setattr(ops, attr, real)
        worst = [max(e[i] for e in errs) for i in range(len(errs[0]))]
        print(f"  1. {bwd_name.replace('_dkv', '')} on each of the "
              f"{len(errs)} layers' own inputs (batch {LM_TRAIN_BATCH} x "
              f"{LM_TRAIN_SEQ}, bf16) vs the plain backward: rel L2 {what} "
              f"at most " + "/".join(f"{x:.2e}" for x in worst)
              + f" (limit {limit})", flush=True)
        if len(errs) != cfg.num_layers or not max(worst) <= limit:
            raise AssertionError(f"{arch}: the backward kernel differs from "
                                 f"its plain version on the model's inputs: "
                                 f"{worst}")
        del loss
        torch.cuda.empty_cache()

    # 2. (the attention+MLP models, bf16) every parameter's gradient
    # through the kernels against the plain attention's, with two broken
    # backwards (the causal mask flipped; KV heads read wrong) and, for the
    # vision stub, the loss counting the image positions
    if cfg.block not in ("rwkv6", "hymba"):
        small = {k: v[:LM_GRAD_BATCH] for k, v in batch0.items()}
        real_bwd = ops.flash_attention_bwd
        flip = "without" if cfg.causal else "with"
        controls = {
            f"backward {flip} the causal mask": (
                "flash_attention_bwd",
                lambda *a, **m: real_bwd(*a, **dict(
                    m, causal=not m["causal"]))),
            "backward reading the wrong KV head": (
                "flash_attention_bwd",
                permuted_heads_bwd(real_bwd, torch))}
        if cfg.frontend == "vision":
            controls["the loss counting the image positions"] = (
                "cfg", dataclasses.replace(cfg, num_prefix_embeds=0))
        readings, line = grad_readings(
            torch, ops, cfg, model, small, QKV_LEAVES, controls)
        print(f"  2. gradient at batch {LM_GRAD_BATCH} x {LM_TRAIN_SEQ} "
              f"(bf16), {line}", flush=True)
        check_grad_readings(readings, LM_GRAD_REL_L2[arch],
                            "the q/k/v projections", arch)
        opt_state, step = cut_step(model, lr)

    # the main path: train_loop over LM_TRAIN_STEPS batches; the probe is
    # a batch the loop does not train on
    probe = stream.batch(LM_TRAIN_STEPS)

    def probe_loss():
        with torch.no_grad():
            return lm_loss(cfg, model, probe)[0].item()

    before = probe_loss()
    fit_before = fit_loss(torch, cfg, model, stream)
    kernels = {"rwkv6": ("rwkv6_wkv", "rwkv6_wkv_bwd"),
               "hymba": ("flash_attention_fwd",) + BWD_KERNELS + SCAN_KERNELS
               }.get(cfg.block, ("flash_attention_fwd",) + BWD_KERNELS)
    rows = []

    def timed_step(*args, **kw):
        start = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = step(*args, **kw)
        torch.cuda.synchronize()       # the step's wall time ends here
        end = ops.launch_counts()
        rows.append({"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {k: end[k] - start[k] for k in kernels}})
        return out

    def log(i, m):
        rows[-1].update(m)
        print(f"  step {i}: wall {m['step_time_s']:.3f} s, loss "
              f"{m['loss']:.5f}, grad_norm {m['grad_norm']:.4f}, lr "
              f"{m['lr']:.3e}, peak memory {rows[-1]['peak_gb']:.2f} GB, "
              f"launches {rows[-1]['launches']}", flush=True)

    from repro_torch.kernels import selective_scan as scan
    ops.reset_launch_counts()
    scan.selective_scan.checkpoint_launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model, opt_state, _ = train_loop(
        timed_step, model, opt_state, stream, SEED + 1, NoCheckpoints(),
        LoopConfig(total_steps=LM_TRAIN_STEPS, ckpt_every=LM_TRAIN_STEPS,
                   log_every=1), metrics_cb=log)
    loop_s = time.perf_counter() - t1
    counts = ops.launch_counts()
    ckpt_launches = scan.selective_scan.checkpoint_launches
    routes = check_tc_route(ops, counts, f"{arch} train_loop",
                            f"train_{arch}")
    print(f"  train_loop ({LM_TRAIN_STEPS} steps, main path): {loop_s:.3f} "
          f"s, launches {counts} (checkpointing scan forwards "
          f"{ckpt_launches}), flash kernels by route {routes}", flush=True)
    want = dict.fromkeys(counts, 0)
    want.update(dict.fromkeys(kernels, cfg.num_layers * LM_TRAIN_STEPS))
    if counts != want or ckpt_launches != want["selective_scan"]:
        raise AssertionError(f"{arch}: launch counts {counts} != {want} "
                             f"(checkpointing scan forwards "
                             f"{ckpt_launches})")
    losses = [r["loss"] for r in rows]
    if len(losses) != LM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch}: train losses not finite: {losses}")
    after = probe_loss()
    fit_after = fit_loss(torch, cfg, model, stream)
    margin = FIT_MARGIN[arch]
    print(f"  reading: held-out probe loss (batch {LM_TRAIN_STEPS} of the "
          f"stream) {before:.6f} -> {after:.6f} (no check: ROADMAP C11)",
          flush=True)
    print(f"  3. loss over the {LM_TRAIN_STEPS} trained batches "
          f"{fit_before:.6f} -> {fit_after:.6f} (must fall by more than "
          f"{margin})", flush=True)
    if not fit_after < fit_before - margin:
        raise AssertionError(f"{arch}: the loss over the trained batches "
                             f"did not fall by {margin}")
    profile_reading(torch, f"train step ({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ})",
                    lambda: step(model, opt_state, batch0))
    if arch in BUSY_ARCHS:
        # hymba's two windows took 148 and 143 s (the profiler's 10 steps
        # of many small ops), a quarter of the run's time limit; its busy
        # share is the step profile's above, and so are phase 18's
        busy_windows(torch, step, model, opt_state, stream, arch)
    del opt_state, step
    torch.cuda.empty_cache()

    # 4. (rwkv6-1.6b) the end-to-end gradient check with the same weights
    # in f32 at a short sequence, with a broken WKV backward.  Over all 24
    # layers the random model's gradient is itself chaotic (a reading, no
    # limit); the check takes the trained weights' first LM_GRAD_LAYERS_F32
    if cfg.block == "rwkv6":
        model.float()
        small = {k: v[:1, :LM_GRAD_SEQ_F32] for k, v in batch0.items()}
        readings, line = grad_readings(torch, ops, cfg, model, small,
                                       DECAY_LEAVES, {})
        rel, rel_part = readings["kernels"]
        print(f"  4a. reading, all {cfg.num_layers} layers at batch 1 x "
              f"{LM_GRAD_SEQ_F32} (f32 weights), {line}: gradient, kernels "
              f"vs plain path, rel L2 {rel:.3e}, over the decay leaves "
              f"alone {rel_part:.3e}", flush=True)
        cut = dataclasses.replace(cfg, num_layers=LM_GRAD_LAYERS_F32,
                                  dtype="float32")
        sub = tf.TransformerLM(cut, device="cuda", trainable=True)
        with torch.no_grad():
            trained = dict(model.named_parameters())
            for name, p in sub.named_parameters():
                p.copy_(trained[name])
        del model, trained
        real_wkv_bwd = ops.rwkv6_wkv_bwd

        def no_dd(*args, **tuner):
            dr, dk, dv, dw, du, ds0 = real_wkv_bwd(*args, **tuner)
            return dr, dk, dv, torch.zeros_like(dw), du, ds0

        readings, line = grad_readings(
            torch, ops, cut, sub, small, DECAY_LEAVES,
            {"backward with dd dropped": ("rwkv6_wkv_bwd", no_dd)})
        print(f"  4. gradient of the first {LM_GRAD_LAYERS_F32} trained "
              f"layers at batch 1 x {LM_GRAD_SEQ_F32} (f32 weights), {line}",
              flush=True)
        check_grad_readings(readings, LM_GRAD_REL_L2[arch],
                            "the decay leaves", arch)
        model = sub
    elif cfg.block == "hymba":
        hymba_grad_check(torch, ops, cfg, model, batch0)
    del model
    torch.cuda.empty_cache()

    # 5. the control of check 3: the same loop from the same weights with
    # the update reversed must not lower the loss over the trained batches
    # by the margin
    if layers is None:
        cfg, model, opt_state, step, _ = launch.build(
            arch, lr=-lr, total_steps=LM_TRAIN_STEPS, device="cuda")
    else:
        model = cut_model()
        opt_state, step = cut_step(model, -lr)
    ctl_before = fit_loss(torch, cfg, model, stream)
    model, _, _ = train_loop(
        step, model, opt_state, stream, SEED + 1, NoCheckpoints(),
        LoopConfig(total_steps=LM_TRAIN_STEPS, ckpt_every=LM_TRAIN_STEPS,
                   log_every=LM_TRAIN_STEPS))
    ctl_after = fit_loss(torch, cfg, model, stream)
    print(f"  5. control of check 3, the update reversed (lr {-lr}): loss "
          f"over the trained batches {ctl_before:.6f} -> {ctl_after:.6f} "
          f"(must not fall by {margin})", flush=True)
    if not abs(ctl_before - fit_before) <= 1e-3:
        raise AssertionError(f"{arch}: the control did not start from the "
                             f"trained loop's weights ({ctl_before} against "
                             f"{fit_before})")
    if ctl_after < ctl_before - margin:
        raise AssertionError(f"{arch}: check 3's control passed it")
    del model, opt_state, step
    torch.cuda.empty_cache()
    return counts


def hymba_layer_checks(torch, ops, ref, cfg, model, batch):
    """Phase 13's check 1: one gradient of the training batch (bf16, batch
    2 x 2048) with every layer's window dq/dkv launch held against the
    plain backward on its own inputs (rel L2 over dq and over (dk, dv),
    ``BWD_MASKED_REL_L2``), and the scan backward of the layers in
    ``HYMBA_SCAN_CHECK_LAYERS`` against ``ref.selective_scan_bwd`` on its
    own inputs (from the forward's first checkpoint, the layer's h0), each
    gradient within ``SCAN_BWD_REL_L2``."""
    from repro_torch.train import lm_loss
    real_bwd, real_scan_bwd = ops.flash_attention_bwd, ops.selective_scan_bwd
    flash_errs, scan_errs, calls = [], {}, []

    def flash_checked(q, k, v, o, lse, do, tuner=None, **mask):
        got = real_bwd(q, k, v, o, lse, do, tuner=tuner, **mask)
        want = ref.attention_bwd(q[None], k[None], v[None], o[None],
                                 lse[None], do[None], **mask)
        flash_errs.append((rel_l2(got[:1], [want[0][0]]),
                           rel_l2(got[1:], [w[0] for w in want[1:]]),
                           mask.get("window")))
        return got

    def scan_checked(xs, dt, bb, cc, a, d, ckpt, dy, dh_t=None, **tuner):
        got = real_scan_bwd(xs, dt, bb, cc, a, d, ckpt, dy, dh_t, **tuner)
        layer = cfg.num_layers - 1 - len(calls)     # the backward's order
        calls.append(layer)
        if layer in HYMBA_SCAN_CHECK_LAYERS:
            from repro_torch.kernels import selective_scan as scan
            want = ref.selective_scan_bwd(
                xs, dt, bb, cc, a, d, ckpt[:, 0], dy, dh_t,
                segments=scan.bwd_geometry(*xs.shape, a.shape[-1]).segments)
            scan_errs[layer] = [rel_l2([g], [w]) for g, w in zip(got, want)]
        return got

    ops.flash_attention_bwd, ops.selective_scan_bwd = flash_checked, \
        scan_checked
    try:
        loss, _ = lm_loss(cfg, model, batch)
        torch.autograd.grad(loss, list(model.parameters()))
    finally:
        ops.flash_attention_bwd, ops.selective_scan_bwd = real_bwd, \
            real_scan_bwd
    del loss
    torch.cuda.empty_cache()
    lim = BWD_MASKED_REL_L2["bfloat16"]
    worst = (max(e[0] for e in flash_errs), max(e[1] for e in flash_errs))
    windows = sorted({e[2] for e in flash_errs}, key=str)
    print(f"  1a. flash backward (window {windows}) on each of the "
          f"{len(flash_errs)} layers' own inputs (batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ}, bf16) vs the plain backward: rel L2 dq at most "
          f"{worst[0]:.2e}, (dk, dv) {worst[1]:.2e} (limit {lim})",
          flush=True)
    print(f"  1b. scan backward on layers {sorted(scan_errs)} of "
          f"{len(calls)} (the plain backward is a Python loop) vs "
          f"ref.selective_scan_bwd on their own inputs: rel L2 "
          "dx/ddt/db/dc/da/dD/dh0 " + "; ".join(
              f"layer {k}: " + "/".join(f"{x:.1e}" for x in v)
              for k, v in sorted(scan_errs.items()))
          + f" (limit {SCAN_BWD_REL_L2})", flush=True)
    if (len(flash_errs) != cfg.num_layers or windows != [cfg.window]
            or not max(worst) <= lim):
        raise AssertionError(f"hymba: the window flash backward differs from "
                             f"the plain one on the model's inputs: {worst}, "
                             f"windows {windows}")
    if (len(calls) != cfg.num_layers
            or sorted(scan_errs) != list(HYMBA_SCAN_CHECK_LAYERS)
            or not max(max(v) for v in scan_errs.values())
            <= SCAN_BWD_REL_L2):
        raise AssertionError(f"hymba: the scan backward differs from the "
                             f"twin on the model's inputs: {scan_errs}")


def hymba_grad_check(torch, ops, cfg, model, batch):
    """Phase 13's check 4: the trained weights in f32 at batch 1 x
    ``HYMBA_GRAD_SEQ`` (past the window): a reading of the whole gradient
    through the kernels against the plain path's over all layers, then the
    check over the first ``HYMBA_GRAD_LAYERS`` layers, whole and over the
    dt and q/k/v leaves, with two broken backwards as controls: the scan's
    ``ddt`` dropped, and the flash backward without its window."""
    import dataclasses
    from repro_torch.models import transformer as tf
    model.float()
    small = {k: v[:1, :HYMBA_GRAD_SEQ] for k, v in batch.items()}
    part = DT_LEAVES + QKV_LEAVES
    readings, line = grad_readings(torch, ops, cfg, model, small, part, {})
    rel, rel_part = readings["kernels"]
    print(f"  4a. reading, all {cfg.num_layers} layers at batch 1 x "
          f"{HYMBA_GRAD_SEQ} (f32 weights), {line}: gradient, kernels vs "
          f"plain path, rel L2 {rel:.3e}, over the dt and q/k/v leaves "
          f"{rel_part:.3e}", flush=True)
    cut = dataclasses.replace(cfg, num_layers=HYMBA_GRAD_LAYERS,
                              dtype="float32")
    sub = tf.TransformerLM(cut, device="cuda", trainable=True)
    with torch.no_grad():
        trained = dict(model.named_parameters())
        for name, p in sub.named_parameters():
            p.copy_(trained[name])
    del model, trained
    torch.cuda.empty_cache()
    real_scan_bwd, real_bwd = ops.selective_scan_bwd, ops.flash_attention_bwd

    def no_ddt(*args, **tuner):
        g = list(real_scan_bwd(*args, **tuner))
        g[1] = torch.zeros_like(g[1])
        return tuple(g)

    readings, line = grad_readings(
        torch, ops, cut, sub, small, part, {
            "scan backward with ddt dropped": ("selective_scan_bwd", no_ddt),
            "flash backward without the window": (
                "flash_attention_bwd",
                lambda *a, **m: real_bwd(*a, **dict(m, window=None)))})
    print(f"  4. gradient of the first {HYMBA_GRAD_LAYERS} trained layers at "
          f"batch 1 x {HYMBA_GRAD_SEQ} (f32 weights), {line}", flush=True)
    check_grad_readings(readings, LM_GRAD_REL_L2["hymba-1.5b"],
                        "the dt and q/k/v leaves", "hymba-1.5b")


def fit_loss(torch, cfg, model, stream) -> float:
    """The mean LM loss over the batches phases 10-11's loops train on."""
    from repro_torch.train import lm_loss
    with torch.no_grad():
        return sum(lm_loss(cfg, model, stream.batch(i))[0].item()
                   for i in range(LM_TRAIN_STEPS)) / LM_TRAIN_STEPS


def masked_flash_cases(torch, ops, ref, randn, cases):
    """The forward's causal, sliding-window and grouped-query forms against
    the plain version: qwen3-8b's prefill (batch 4 x 32 query heads over 8
    KV heads, S 2048, D 128, bf16, causal), a ragged right-aligned causal
    case in f32 (Sq 100, Sk 1000, group 4) and hymba-1.5b's attention (25
    query over 5 KV heads, S 2048, D 64, bf16, causal, window 1024).  The
    bound counts the live (q, k) pairs only; ``library_ms`` is SDPA on K/V
    repeated to the query heads beforehand (``is_causal`` for the square
    causal case, the boolean keep-mask otherwise)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    for b, hq, hkv, sq, sk, d, dtype, window in [
            (4, 32, 8, 2048, 2048, 128, "bfloat16", None),
            (2, 8, 2, 100, 1000, 64, "float32", None),
            (4, 25, 5, 2048, 2048, 64, "bfloat16", 1024)]:
        tdt = getattr(torch, dtype)
        q = randn((b, hq, sq, d), tdt)
        k, v = randn((b, hkv, sk, d), tdt), randn((b, hkv, sk, d), tdt)
        mask = dict(causal=True, window=window)
        got = ops.attention(q, k, v, **mask)
        want, _ = ref.attention(q, k, v, **mask)
        keep = ref._keep(sq, sk, True, window, q.device)   # live pairs
        flops = 4.0 * b * hq * int(keep.sum()) * d
        b_ms, b_by = bound(nbytes(q, k, v, got) + 4 * b * hq * sq, flops,
                           dtype)
        kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        sdpa = (dict(is_causal=True) if sq == sk and window is None
                else dict(attn_mask=keep))
        reps = 10 if sq >= 1024 else 100
        timing = dict(
            ms=time_ms(lambda: ops.attention(q, k, v, **mask), reps),
            plain_ms=time_ms(lambda: ops.attention(q, k, v, **mask,
                                                   use_kernel=False), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, kx, vx, **sdpa), reps))
        atol, rtol = MASKED_TOL[dtype]
        rel, rel_lim = rel_l2([got], [want]), MASKED_REL_L2[dtype]
        form = "causal" + (f" window={window}" if window else "")
        cases["flash_attention_fwd_window" if window
              else "flash_attention_fwd_causal_gqa"].append(check_case(
            f"flash_attention_fwd {form} {dtype} BH={b * hq} "
            f"BKV={b * hkv} Sq={sq} Sk={sk} D={d} ({route_label(fa, tdt, d)}"
            f"; rel L2 {rel:.3e}, limit {rel_lim})", got, want, atol, rtol,
            timing))
        if not rel <= rel_lim:
            raise AssertionError(f"flash_attention_fwd {form}: rel L2 {rel} "
                                 f"against the plain version")
        if d == 128 and window is None:
            terms_control(torch, fa, q, k, v, want, dict(causal=True),
                          rel_lim)


def route_label(fa, dtype, d, backward=False) -> str:
    """The forward's (or the backward's) route for ``dtype`` and head dim
    ``d``, and its term count on the tensor-core route."""
    route = (fa.bwd_route if backward else fa.fwd_route)(dtype, d)
    terms = (f"P and dS in {fa.BWD_TC_TERMS}" if backward
             else f"P in {fa.TC_TERMS}")
    return (f"route tc, {terms} bf16 terms" if route == "tc"
            else "route simt (f32 FMA)")


def terms_control(torch, fa, q, k, v, want, mask, limit):
    """The tensor-core kernel with P in 1 and 2 bf16 terms against the
    plain version (rel L2 of o) and timed, beside its own count's
    readings: the 1-term control must miss ``limit`` while the kernel's
    count meets it (run at the DiT's and qwen3-8b's shapes)."""
    b, hq, sq, d = q.shape
    qkv = (q.reshape(b * hq, sq, d), k.reshape(-1, *k.shape[2:]),
           v.reshape(-1, *v.shape[2:]))
    rel, ms = {}, {}
    for terms in (1, 2, fa.TC_TERMS):
        o, _ = fa.flash_attention_fwd_terms(*qkv, terms, **mask)
        rel[terms] = rel_l2([o.view(want.shape)], [want])
        ms[terms] = time_ms(lambda: fa.flash_attention_fwd_terms(
            *qkv, terms, **mask), 20)
    print(f"    P in bf16 terms, rel L2 of o vs plain (kernel ms): "
          + ", ".join(f"{t} term{'s' if t > 1 else ''} {r:.3e} "
                      f"({ms[t]:.4f})" for t, r in rel.items())
          + f" (limit {limit}; 1 term is the control that must miss it)",
          flush=True)
    if not rel[1] > limit >= rel[fa.TC_TERMS]:
        raise AssertionError(f"terms control: 1 term {rel[1]} must miss "
                             f"{limit} and {fa.TC_TERMS} terms "
                             f"{rel[fa.TC_TERMS]} meet it")


def wkv_inputs(torch, randn, b, h, t, dk, dv, dtype, zero, clip):
    """r, k, v (``dtype``), w, u and the state (f32) for the WKV cases.
    ``clip``: w uniform over the model's whole clip [-8, 4] (decays from
    0.9997 down to exp(-e^4), about 1.9e-24); else w ~ N(-1, 0.5)."""
    tdt = getattr(torch, dtype)
    r, k, v = (randn((b, h, t, d)).mul(0.5).to(tdt) for d in (dk, dk, dv))
    if clip:
        w = torch.special.ndtr(randn((b, h, t, dk))) * 12.0 - 8.0
    else:
        w = (randn((b, h, t, dk)) * 0.5 - 1.0).clamp(-8.0, 4.0)
    u = randn((h, dk)) * 0.3
    s0 = (torch.zeros((b, h, dk, dv), device=r.device) if zero
          else randn((b, h, dk, dv)) * 0.2)
    return r, k, v, w, u, s0


def wkv_cases(torch, ops, ref, randn, cases):
    """The WKV kernel against the plain scan: rwkv6-1.6b's prefill (batch
    4 x 32 heads, T 2048, Dk = Dv = 64, r/k/v bf16, w/u/state f32, from the
    zero state), its training shape (batch 2, with the checkpoints the
    train path asks for: the first equal to the initial state, a middle one
    against the plain scan's state there), a decode step (T 1), a ragged T
    (7), w spread over the model's whole clip, and an f32 case; each run
    twice and held bitwise equal, every bf16 case also by rel L2 of out
    (``WKV_REL_L2``; at the prefill shape the plain scan without the bonus
    term ``u`` is the control that must miss it), and head dims that are no
    multiple of 8 (Dk 12, Dv 20: the wrapper pads them).  The bound counts
    the flops the function needs on the f32 units: 5 per state element per
    step (r.S and decay * S + k v^T) and 3 Dk + 2 Dv per step for the bonus
    term v (r.(u*k)); PyTorch has no single call for it (``library_ms``
    null)."""
    from repro_torch.kernels import rwkv6_scan
    for b, h, t, dk, dv, dtype, zero, ckpt, clip in [
            (4, 32, 2048, 64, 64, "bfloat16", True, False, False),
            (2, 32, 2048, 64, 64, "bfloat16", True, True, False),
            (4, 32, 1, 64, 64, "bfloat16", False, False, False),
            (4, 32, 7, 64, 64, "bfloat16", False, False, False),
            (2, 4, 300, 64, 64, "bfloat16", False, False, True),
            (2, 4, 300, 64, 64, "float32", False, False, False),
            (1, 3, 37, 12, 20, "float32", False, True, False)]:
        r, k, v, w, u, s0 = wkv_inputs(torch, randn, b, h, t, dk, dv, dtype,
                                       zero, clip)

        def kernel():
            return rwkv6_scan.rwkv6_wkv(r, k, v, w, u, s0, checkpoints=ckpt)

        out, s_t, cks = kernel()
        again = kernel()
        out_r, s_r = ops.rwkv6_wkv(r, k, v, w, u, s0, use_kernel=False)
        if not all(torch.equal(_bits(a), _bits(c))
                   for a, c in zip((out, s_t), again[:2])):
            raise AssertionError("rwkv6_wkv: two runs differ")
        s_err = (s_t - s_r).abs().max().item()
        if not torch.allclose(s_t, s_r, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"rwkv6_wkv: the final state differs from "
                                 f"the plain scan's by {s_err}")
        notes = [f"state max err {s_err:.3e}, limit 1e-4"]
        if dtype == "bfloat16":
            rel = rel_l2([out], [out_r])
            notes.append(f"rel L2 {rel:.3e}, limit {WKV_REL_L2}")
            if not rel <= WKV_REL_L2:
                raise AssertionError(f"rwkv6_wkv {dtype} B={b} T={t}: rel "
                                     f"L2 {rel} against the plain scan")
        if ckpt:
            mid = cks.shape[2] // 2
            _, s_mid = ref.rwkv6_wkv(*(x[:, :, :mid * rwkv6_scan.chunk()]
                                       for x in (r, k, v, w)), u, s0)
            ck_rel = rel_l2([cks[:, :, mid]], [s_mid])
            notes.append(f"{cks.shape[2]} checkpoints, the first bitwise "
                         f"s0, #{mid} rel L2 {ck_rel:.3e} (limit "
                         f"{WKV_STATE_REL_L2})")
            if not (torch.equal(cks[:, :, 0], s0)
                    and ck_rel <= WKV_STATE_REL_L2):
                raise AssertionError(f"rwkv6_wkv: checkpoints differ from "
                                     f"the plain scan's states ({ck_rel})")
        b_ms, b_by = bound(
            nbytes(r, k, v, w, u, s0, out, s_t, *((cks,) if ckpt else ())),
            b * h * t * (5.0 * dk * dv + 3.0 * dk + 2.0 * dv), "float32")
        timing = dict(
            ms=time_ms(kernel, 20 if t >= 1024 else 200),
            plain_ms=time_ms(lambda: ops.rwkv6_wkv(r, k, v, w, u, s0,
                                                   use_kernel=False), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        cases["rwkv6_wkv"].append(check_case(
            f"rwkv6_wkv {dtype} B={b} H={h} T={t} D={dk}"
            + (f" Dv={dv}" if dv != dk else "")
            + (" w over [-8, 4]" if clip else "")
            + (" with checkpoints" if ckpt else "")
            + f" ({'; '.join(notes)}; two runs bitwise)", out, out_r, tol,
            tol, timing))
        if b == 4 and t >= 1024:
            no_u, _ = ref.rwkv6_wkv(r, k, v, w, torch.zeros_like(u), s0)
            ctl = rel_l2([no_u], [out_r])
            print(f"    control, the plain scan without u: rel L2 {ctl:.3e} "
                  f"(must miss {WKV_REL_L2})", flush=True)
            if not ctl > WKV_REL_L2:
                raise AssertionError(f"WKV control: rel L2 {ctl} meets the "
                                     f"limit {WKV_REL_L2}")


def wkv_readings(torch):
    """ptxas' registers and spills of every WKV kernel instance (printed
    only when this run built the library) and each kernel's launch: grid,
    threads and shared bytes a block, blocks an SM."""
    from repro_torch.kernels import _build, rwkv6_scan
    log = _build.build_log.get("rwkv6_wkv")
    for kernel in ("wkv_fwd_colgroup_kernel", "wkv_bwd_rowgroup_kernel",
                   "wkv_bwd_dv_sum_kernel"):
        readings = ptxas_readings(log, kernel) if log else []
        print(f"  ptxas, {kernel}<dtype>: " + ("; ".join(
            f"<{inst}> {regs} registers, spills {st}/{ld} bytes "
            f"(stores/loads)" for inst, regs, st, ld in readings)
            if readings else "not rebuilt in this run"), flush=True)
    for label, bwd, bh in (("forward at the prefill shape", False, 128),
                           ("forward at the training shape", False, 64),
                           ("backward at the training shape", True, 64)):
        info = rwkv6_scan.launch_info(bwd, torch.bfloat16, bh)
        print(f"  WKV {label} (bf16, BH {bh}): grid {info['grid']} of "
              f"{info['threads']} threads, {info['shared_bytes']} shared "
              f"bytes a block, {info['blocks_per_sm']} blocks an SM"
              + (f"; then wkv_bwd_dv_sum_kernel, grid "
                 f"{-(-bh * 2048 * 64 // 4 // 256)} of 256 threads"
                 if bwd else ""), flush=True)


def masked_backward_cases(torch, ref, randn, cases):
    """The flash backward's causal, sliding-window and grouped-query forms
    against ``ref.attention_bwd``: qwen3-8b's training shape (batch 2 x 32
    query heads over 8 KV heads, S 2048, D 128, bf16, causal), hymba-1.5b's
    (2 x 25 query over 5 KV heads, S 2048, D 64, bf16, causal, window
    1024) and a ragged right-aligned causal case in f32 (Sq 100, Sk 1000,
    group 4).  dk and dv come back in the KV heads' layout, the group
    summed in f32 in the kernel and in the plain version.  The bound
    counts the live (q, k) pairs only; ``plain_ms`` and ``library_ms``
    time a whole backward (dq, dk and dv together): ``library_ms`` is
    SDPA's backward on K/V repeated to the query heads beforehand
    (``is_causal`` for the square causal case, the boolean keep-mask
    otherwise), whose dk and dv stay per query head."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    for b, hq, hkv, sq, sk, d, dtype, window in [
            (2, 32, 8, 2048, 2048, 128, "bfloat16", None),
            (2, 25, 5, 2048, 2048, 64, "bfloat16", 1024),
            (2, 8, 2, 100, 1000, 64, "float32", None)]:
        tdt = getattr(torch, dtype)
        q, do = (randn((b, hq, sq, d), tdt) for _ in range(2))
        k, v = (randn((b, hkv, sk, d), tdt) for _ in range(2))
        q3, do3 = (x.reshape(b * hq, sq, d) for x in (q, do))
        k3, v3 = (x.reshape(b * hkv, sk, d) for x in (k, v))
        mask = dict(causal=True, window=window)
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, **mask)
        delta = (do3.float() * o3.float()).sum(dim=-1)
        scale = d ** -0.5

        def dq_fn():
            return (fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta,
                                              scale, **mask),)

        def dkv_fn():
            return fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                              scale, **mask)

        def plain():
            return ref.attention_bwd(q, k, v, o3.view(q.shape),
                                     lse.view(b, hq, sq), do, **mask)

        want = plain()
        keep = ref._keep(sq, sk, True, window, q.device)
        live = int(keep.sum())
        kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, kx, vx))
        sdpa = F.scaled_dot_product_attention(
            qg, kg, vg, **(dict(is_causal=True) if sq == sk and window is None
                           else dict(attn_mask=keep)))
        reps = 5 if sq >= 1024 else 50
        plain_ms = time_ms(plain, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), do, retain_graph=True), reps)
        reads = nbytes(q, k, v, do, lse, delta)
        atol, rtol = ((BWD_BF16_ATOL, BWD_BF16_RTOL) if dtype == "bfloat16"
                      else (1e-4, 1e-4))
        form = "causal" + (f" window={window}" if window else "")
        for name, fn, ref_out, flops in (
                ("flash_attention_bwd_dq", dq_fn, want[:1], 6.0),
                ("flash_attention_bwd_dkv", dkv_fn, want[1:], 8.0)):
            got = fn()
            b_ms, b_by = bound(reads + nbytes(*got),
                               flops * b * hq * live * d, dtype)
            timing = dict(ms=time_ms(fn, reps), plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms)
            rel = bwd_rel_l2(torch, fn, got, ref_out, f"{name} {form}")
            key = name + ("_window" if window else "_causal_gqa")
            cases[key].append(check_case(
                f"{name} {form} {dtype} BH={b * hq} BKV={b * hkv} Sq={sq} "
                f"Sk={sk} D={d} ({route_label(fa, tdt, d, backward=True)}; "
                f"rel L2 {rel:.3e}, limit {BWD_MASKED_REL_L2[dtype]}; two "
                f"runs bitwise)",
                torch.cat([g.reshape(-1) for g in got]),
                torch.cat([w.reshape(-1) for w in ref_out]), atol, rtol,
                timing))
        if d == 128 and window is None:
            bwd_terms_control(torch, fa, (q3, k3, v3, o3, lse, do3),
                              [want[0].reshape(q3.shape),
                               want[1].reshape(k3.shape),
                               want[2].reshape(v3.shape)], mask)
        del qg, kg, vg, sdpa, want
        torch.cuda.empty_cache()


def wkv_backward_cases(torch, ref, randn, cases):
    """The WKV backward kernel against ``ref.rwkv6_wkv_bwd`` from the
    forward's checkpoints: rwkv6-1.6b's training shape (batch 2 x 32
    heads, T 2048, Dk = Dv = 64, r/k/v bf16, w/u/state f32, from the zero
    state), a ragged T (7), w spread over the model's whole clip and T 300
    in f32, with upstream gradients on out and on the final state; each run
    twice and held bitwise equal; then B.H 3 and T 37 (no multiple of the
    row groups or of ``chunk()``) in f32, at head dim 64 and at Dk 12, Dv
    20 (padded by the wrapper).
    Every gradient is held by relative L2 over the tensor (the kernel and
    the plain scan sum in other orders; ``dw`` sums a row of G * S that
    can cancel, so an elementwise tolerance would be meaningless there).
    The bound counts 12 flops per state element per step (the recomputed
    state, S dout, G v, G^T k, rowsum(G * S), the G update) plus 15 Dk +
    2 Dv per step, on the f32 units; PyTorch has no single call for it
    (``library_ms`` null)."""
    from repro_torch.kernels import rwkv6_scan
    for b, h, t, dk, dv, dtype, clip in [
            (2, 32, 2048, 64, 64, "bfloat16", False),
            (2, 32, 7, 64, 64, "bfloat16", False),
            (2, 4, 300, 64, 64, "bfloat16", True),
            (2, 4, 300, 64, 64, "float32", False),
            (1, 3, 37, 64, 64, "float32", False),
            (1, 3, 37, 12, 20, "float32", False)]:
        tdt = getattr(torch, dtype)
        r, k, v, w, u, s0 = wkv_inputs(torch, randn, b, h, t, dk, dv, dtype,
                                       t >= 1024, clip)
        dout = randn((b, h, t, dv)).to(tdt)
        ds_t = randn((b, h, dk, dv)) * 0.1
        _, _, ckpt = rwkv6_scan.rwkv6_wkv(r, k, v, w, u, s0,
                                          checkpoints=True)

        def kernel():
            return rwkv6_scan.rwkv6_wkv_bwd(r, k, v, w, u, ckpt, dout, ds_t)

        def plain():
            return ref.rwkv6_wkv_bwd(r, k, v, w, u, s0, dout, ds_t)

        got, again, want = kernel(), kernel(), plain()
        if not all(torch.equal(_bits(a), _bits(c))
                   for a, c in zip(got, again)):
            raise AssertionError("rwkv6_wkv_bwd: two runs differ")
        rels = [rel_l2([g], [x]) for g, x in zip(got, want)]
        lim = WKV_BWD_REL_L2[dtype]
        b_ms, b_by = bound(
            nbytes(r, k, v, w, u, ckpt, dout, ds_t, *got),
            b * h * t * (12.0 * dk * dv + 15.0 * dk + 2.0 * dv), "float32")
        timing = dict(ms=time_ms(kernel, 5 if t >= 1024 else 100),
                      plain_ms=time_ms(plain, 1), bound_ms=b_ms,
                      bound_by=b_by, library_ms=None)
        flat = [torch.cat([x.float().reshape(-1) for x in xs])
                for xs in (got, want)]
        scale = max(x.float().abs().max().item() for x in want)
        cases["rwkv6_wkv_bwd"].append(check_case(
            f"rwkv6_wkv_bwd {dtype} B={b} H={h} T={t} D={dk}"
            + (f" Dv={dv}" if dv != dk else "")
            + (" w over [-8, 4]" if clip else "") + " (rel L2 "
            f"dr/dk/dv/dw/du/ds0 " + "/".join(f"{x:.1e}" for x in rels)
            + f", limit {lim}; two runs bitwise)", *flat,
            2e-2 * scale, 2e-2, timing))
        if not max(rels) <= lim:
            raise AssertionError(f"rwkv6_wkv_bwd: rel L2 {rels} against "
                                 f"the plain backward")


def scan_inputs(torch, randn, b, t, din, n, zero_h0):
    """The selective scan's operands at the model's scales: ``xs`` the
    second half of a (B, T, 2 din) tensor (the model's strided view), dt
    = softplus(N(-2, 1)) (``b_dt`` -2), B and C ~ N(0, 1), a = -(1 .. n)
    on every row (``A_log``'s init), D = 1, h0 zero or ~ N(0, 0.25)."""
    xs = randn((b, t, 2 * din))[..., din:]
    dt = torch.nn.functional.softplus(randn((b, t)) - 2.0)
    a = -torch.linspace(1.0, float(n), n, device=xs.device).expand(
        din, n).contiguous()
    h0 = (torch.zeros((b, din, n), device=xs.device) if zero_h0
          else randn((b, din, n)) * 0.5)
    return [xs, dt, randn((b, t, n)), randn((b, t, n)), a,
            torch.ones(din, device=xs.device), h0]


def scan_bound(b, t, din, n, nbytes_):
    """The least time of one scan: the larger of its bytes over HBM's rate
    and its operations, the exponentials on the SFUs (``SFU_PER_S``) or
    the f32 work (6 flops a state element and step: a dt, (dt x) b, the
    FMA of the update, h c and the sum; 2 a channel and step for D x) on
    the f32 units, whichever takes longer."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    elems = float(b) * t * din * n
    t_ops = max(elems / SFU_PER_S,
                (6.0 * elems + 2.0 * b * t * din) / PEAK_FLOPS["float32"]
                ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_cases(torch, ops, randn, cases, launches=1):
    """Hymba's selective scan against its plain twin at the model's width
    (din 1600, n 16, f32): the prefill shape (batch 4 x T 2048, from the
    zero state), a decode step (T 1) and a ragged T (37: no multiple of
    the kernel's 32-step chunks), both from a nonzero state; each run
    twice and held bitwise equal, y and h_T within SCAN_TOL and SCAN_REL_L2
    (rel L2).  Controls that must miss SCAN_REL_L2: the plain scan with D
    dropped at the prefill shape, with h0 zeroed at T 1.  Each shape is
    read by :func:`launch_readings`: each call must make ``launches``
    device launches (None: read only).  Prints the geometry
    and, when this run built the library, ptxas' registers and spills per
    kernel instance.  PyTorch has no single call for the scan
    (``library_ms`` null)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as scan
    geo = scan.geometry(4, 1600, 16)
    if scan.kernel_chunk() != scan.CHUNK:
        raise AssertionError(f"selective_scan: the kernel stages "
                             f"{scan.kernel_chunk()} steps a chunk, the "
                             f"wrapper {scan.CHUNK}")
    print(f"  selective scan at hymba-1.5b's width: grid {geo.grid} of "
          f"{geo.threads} threads, {geo.states} states a lane, {geo.lanes} "
          f"lanes a channel, {geo.channels} channels a block, "
          f"{scan.CHUNK} steps a chunk in {scan.STAGES} stages (T 1: direct "
          f"loads, no producer warp)", flush=True)
    log = _build.build_log.get("selective_scan")
    for kernel in ("selective_scan_fwd_kernel", "selective_scan_step_kernel"):
        readings = ptxas_readings(log, kernel) if log else []
        print(f"  ptxas, {kernel}<states a lane, lanes a channel>: " + (
            "; ".join(f"<{inst}> {regs} registers, spills {st}/{ld} bytes "
                      f"(stores/loads)" for inst, regs, st, ld in readings)
            if readings else "not rebuilt in this run"), flush=True)
    for b, t, din, n, zero_h0 in [(4, 2048, 1600, 16, True),
                                  (4, 1, 1600, 16, False),
                                  (4, 37, 1600, 16, False)]:
        x = scan_inputs(torch, randn, b, t, din, n, zero_h0)

        def kernel():
            return ops.selective_scan(*x)

        y, h_t = kernel()
        again = kernel()
        y_r, h_r = ops.selective_scan(*x, use_kernel=False)
        if not all(torch.equal(a, c) for a, c in zip((y, h_t), again)):
            raise AssertionError("selective_scan: two runs differ")
        rel = max(rel_l2([y], [y_r]), rel_l2([h_t], [h_r]))
        b_ms, b_by = scan_bound(b, t, din, n, nbytes(*x, y, h_t))
        timing = dict(ms=time_ms(kernel, 20 if t >= 1024 else 200),
                      plain_ms=time_ms(lambda: ops.selective_scan(
                          *x, use_kernel=False), 2),
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
        label = (f"selective_scan f32 B={b} T={t} din={din} n={n} "
                 f"({'zero' if zero_h0 else 'nonzero'} h0; y and h_T rel "
                 f"L2 {rel:.3e}, limit {SCAN_REL_L2}; two runs bitwise)")
        case = check_case(label, torch.cat([y.flatten(), h_t.flatten()]),
                          torch.cat([y_r.flatten(), h_r.flatten()]),
                          SCAN_TOL, SCAN_TOL, timing)
        case.update(launch_readings(torch, kernel))
        print_readings(f"selective_scan T={t}", timing, case, launches)
        cases["selective_scan"].append(case)
        if not rel <= SCAN_REL_L2:
            raise AssertionError(f"selective_scan B={b} T={t}: rel L2 {rel} "
                                 f"against the plain twin")
        if zero_h0 or t == 1:
            ctl = x[:5] + [torch.zeros_like(x[5]), x[6]] if zero_h0 \
                else x[:6] + [torch.zeros_like(x[6])]
            y_c, _ = ops.selective_scan(*ctl, use_kernel=False)
            rel_c = rel_l2([y_c], [y_r])
            print(f"    control, the plain scan with "
                  f"{'D dropped' if zero_h0 else 'h0 zeroed'}: y rel L2 "
                  f"{rel_c:.3e} (must miss {SCAN_REL_L2})", flush=True)
            if not rel_c > SCAN_REL_L2:
                raise AssertionError(f"scan control: rel L2 {rel_c} meets "
                                     f"the limit {SCAN_REL_L2}")


def scan_bwd_bound(b, t, din, n, nbytes_):
    """The least time of one scan backward from the checkpoints: the larger
    of its bytes (each input and output once) over HBM's rate and its
    operations, one pass of the decays' exponentials on the SFUs
    (``SFU_PER_S``: the states replayed from the checkpoints) or 16 f32
    operations a state element and step (the replay's 2; G, db, dc, the
    sum G b, e h, ddt's and da's terms and the carry g: 11; the sums over
    channels 3) on the f32 units, whichever takes longer."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    elems = float(b) * t * din * n
    t_ops = max(elems / SFU_PER_S,
                16.0 * elems / PEAK_FLOPS["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_backward_cases(torch, ref, randn, cases):
    """hymba-1.5b's scan backward (``selective_scan_bwd``: the backward
    kernel and its sum) against ``ref.selective_scan_bwd`` at the model's
    width (din 1600, n 16, f32): the training shape (batch 2 x T 2048 from
    the zero state, no gradient on the final state, as in training), a
    ragged T (37) from a nonzero state with a gradient on the final state,
    and T 300 with xs and dy one float off a 16-byte boundary (their
    4-byte copy route).  Each from the forward's checkpoints, run twice
    and held bitwise equal, every gradient within SCAN_BWD_REL_L2 (rel L2);
    the control, the twin fed dy a step late, must miss it on every
    gradient.  Each case is read by :func:`launch_readings` (three device
    launches a call: the replay, the walk back and the sum, each with its
    own device time).  Before them the forward at
    the training shape with and without its checkpoints, timed in turns
    (the checkpointing case joins the scan's cases).  Prints ptxas'
    registers and spills of the backward's instances.  No single PyTorch
    call computes the backward (``library_ms`` null)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as scan
    geo = scan.bwd_geometry(2, 2048, 1600, 16)
    smem = scan._lib().selective_scan_bwd_smem(geo.states, geo.lanes,
                                               geo.channels)
    knobs = scan.kernel_knobs()
    want_knobs = {"sub": scan.SUB, "max_threads": scan.BWD_MAX_THREADS,
                  "min_blocks": scan.BWD_MIN_BLOCKS,
                  "replay_min_blocks": scan.BWD_REPLAY_MIN_BLOCKS}
    print(f"  scan backward at hymba-1.5b's training shape: grid "
          f"{geo.grid} of {geo.threads} + 32 threads, {geo.segments} "
          f"segments of {geo.segment_steps} steps, {scan.CHUNK}-step "
          f"chunks in {scan.BWD_STAGES} stages, states recomputed "
          f"{scan.SUB} steps at a time, {scan.bwd_smem_bytes(geo)} B of "
          f"shared memory a block of the walk back (the kernel's own count "
          f"{smem}), {scan.bwd_smem_bytes(geo, replay=True)} of the "
          f"replay; the build's knobs {knobs}",
          flush=True)
    if scan.bwd_smem_bytes(geo) != smem or knobs != want_knobs:
        raise AssertionError("selective_scan_bwd: the wrapper's and the "
                             "kernel's shared memory or knobs differ: "
                             f"{knobs} against {want_knobs}")
    log = _build.build_log.get("selective_scan")
    for kernel in ("selective_scan_bwd_replay_kernel",
                   "selective_scan_bwd_kernel", "selective_scan_fwd_kernel"):
        readings = ptxas_readings(log, kernel) if log else []
        print(f"  ptxas, {kernel}<states a lane, lanes a channel"
              + (", checkpoints" if "fwd" in kernel else "") + ">: " + (
                  "; ".join(f"<{inst}> {regs} registers, spills {st}/{ld} "
                            f"bytes (stores/loads)"
                            for inst, regs, st, ld in readings)
                  if readings else "not rebuilt in this run"), flush=True)

    # the forward with and without checkpoints at the training shape
    x = scan_inputs(torch, randn, 2, 2048, 1600, 16, True)

    def fwd_ckpt():
        return scan.selective_scan(*x, checkpoints=True)

    def fwd_plain_kernel():
        return scan.selective_scan(*x)

    y, h_t, ckpt = fwd_ckpt()
    y0, h0_, _ = fwd_plain_kernel()
    if not (torch.equal(y, y0) and torch.equal(h_t, h0_)
            and torch.equal(ckpt[:, -1], h_t)):
        raise AssertionError("selective_scan: the checkpointing forward "
                             "changed y or h_T, or its last checkpoint is "
                             "not h_T")
    turns = [time_ms(f, 20) for f in (fwd_plain_kernel, fwd_ckpt, fwd_ckpt,
                                      fwd_plain_kernel)]
    y_r, h_r = ref.selective_scan(*x)
    rel = max(rel_l2([y], [y_r]), rel_l2([h_t], [h_r]))
    b_ms, b_by = scan_bound(2, 2048, 1600, 16, nbytes(*x, y, h_t, ckpt))
    timing = dict(ms=(turns[1] + turns[2]) / 2,
                  plain_ms=time_ms(lambda: ref.selective_scan(*x), 1),
                  bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"    forward at B 2 x T 2048, in turns (without, with, with, "
          f"without checkpoints): " + ", ".join(f"{t:.4f}" for t in turns)
          + " ms", flush=True)
    cases["selective_scan"].append(check_case(
        f"selective_scan f32 B=2 T=2048 din=1600 n=16 with checkpoints "
        f"({tuple(ckpt.shape)}; y and h_T rel L2 {rel:.3e}, limit "
        f"{SCAN_REL_L2}; y and h_T bitwise those without)",
        torch.cat([y.flatten(), h_t.flatten()]),
        torch.cat([y_r.flatten(), h_r.flatten()]), SCAN_TOL, SCAN_TOL,
        timing))
    if not rel <= SCAN_REL_L2:
        raise AssertionError(f"checkpointing selective_scan: rel L2 {rel}")
    del x, y, h_t, ckpt, y0, y_r

    names = ("dx", "ddt", "db", "dc", "da", "dD", "dh0")
    for b, t, zero_h0, with_dh, unaligned in [
            (2, 2048, True, False, False), (2, 37, False, True, False),
            (2, 300, False, True, True)]:
        x = scan_inputs(torch, randn, b, t, 1600, 16, zero_h0)
        dy = randn((b, t, 1600))
        if unaligned:
            x[0], dy = unaligned_copy(torch, x[0]), unaligned_copy(torch, dy)
        dh_t = randn((b, 1600, 16)) if with_dh else None
        _, _, ckpt = scan.selective_scan(*x, checkpoints=True)
        segments = scan.bwd_geometry(b, t, 1600, 16).segments

        def kernel():
            return scan.selective_scan_bwd(*x[:6], ckpt, dy, dh_t)

        def plain():
            return ref.selective_scan_bwd(*x, dy, dh_t, segments=segments)

        got, again, want = kernel(), kernel(), plain()
        if not all(torch.equal(_bits(u), _bits(v))
                   for u, v in zip(got, again)):
            raise AssertionError("selective_scan_bwd: two runs differ")
        rels = [rel_l2([g], [w]) for g, w in zip(got, want)]
        late = torch.cat([torch.zeros_like(dy[:, :1]), dy[:, :-1]], dim=1)
        ctl = ref.selective_scan_bwd(*x, late, dh_t, segments=segments)
        rels_c = [rel_l2([g], [w]) for g, w in zip(got, ctl)]
        b_ms, b_by = scan_bwd_bound(
            b, t, 1600, 16, nbytes(*x[:6], ckpt, dy, *got)
            + (nbytes(dh_t) if with_dh else 0))
        timing = dict(ms=time_ms(kernel, 20 if t >= 1024 else 200),
                      plain_ms=time_ms(plain, 1), bound_ms=b_ms,
                      bound_by=b_by, library_ms=None)
        label = (f"selective_scan_bwd f32 B={b} T={t} din=1600 n=16 "
                 f"({segments} segments, "
                 f"{'zero' if zero_h0 else 'nonzero'} h0, "
                 f"{'with' if with_dh else 'no'} dh_T"
                 + (", xs and dy unaligned" if unaligned else "")
                 + "; rel L2 " + "/".join(names) + " " + "/".join(
                     f"{r:.1e}" for r in rels) + f", limit {SCAN_BWD_REL_L2};"
                 f" two runs bitwise)")
        flat = [torch.cat([v.reshape(-1) for v in vs]) for vs in (got, want)]
        case = check_case(label, *flat, 1e-3 * flat[1].abs().max().item(),
                          1e-3, timing)
        case.update(launch_readings(torch, kernel))
        print_readings(f"selective_scan_bwd T={t}", timing, case, 3)
        sum_geo = scan.bwd_geometry(b, t, 1600, 16)
        sum_bytes = 4 * (b * sum_geo.grid[0] * t * 33 + b * t * 33
                         + (b * sum_geo.segments + 1) * 1600 * 17)
        case["sum_bound_ms"] = sum_bytes / HBM_BYTES_PER_S * 1e3
        print(f"    device us a launch by kernel: " + ", ".join(
            f"{KERNEL_NAME.search(k).group(1)} {us:.2f}"
            for k, us in sorted(case["device_us_by_kernel"].items()))
              + f"; the sum's bound {case['sum_bound_ms'] * 1e3:.2f} us "
              f"({sum_bytes / 1e6:.1f} MB: the partials read, dB, dC and "
              f"ddt written, da's and dD's partials read and written)",
              flush=True)
        print(f"    control, the twin fed dy a step late: rel L2 "
              + "/".join(f"{r:.1e}" for r in rels_c)
              + f" (each must miss {SCAN_BWD_REL_L2})", flush=True)
        cases["selective_scan_bwd"].append(case)
        if not max(rels) <= SCAN_BWD_REL_L2:
            raise AssertionError(f"selective_scan_bwd B={b} T={t}: rel L2 "
                                 f"{rels} against the plain twin")
        if not min(rels_c) > SCAN_BWD_REL_L2:
            raise AssertionError(f"selective_scan_bwd control: rel L2 "
                                 f"{rels_c} meets {SCAN_BWD_REL_L2}")


def launch_readings(torch, fn) -> dict:
    """Phase 3's readings of one B1/B2/B4 or scan case, from one
    ``torch.profiler`` window of ``LAUNCH_WINDOW_CALLS`` calls
    (``profiling.window_launches``): the launches per call, counted as the
    host's calls that start a device activity (kernels, copies, fills),
    the device activities the profiler recorded per call beside them, the
    lead's records lost and the places of the calls' launches with none, and
    device microseconds per recorded activity; and the host's
    microseconds per call, as the time to enqueue ``HOST_CALLS`` calls
    with no synchronise among them."""
    from repro_torch.runtime.profiling import LEAD_LAUNCHES, window_launches
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    got = window_launches(fn, LAUNCH_WINDOW_CALLS)
    by_name = got["device"]
    recorded = sum(n for n, _ in by_name.values())
    device_us = sum(us for _, us in by_name.values())
    return dict(launches_per_call=got["api"] / LAUNCH_WINDOW_CALLS,
                recorded_per_call=recorded / LAUNCH_WINDOW_CALLS,
                device_us_by_kernel={k: us / c for k, (c, us)
                                     in by_name.items() if c},
                lead_lost=(got["lead_lost"], LEAD_LAUNCHES),
                missing=got["missing"],
                device_us_per_launch=device_us / recorded if recorded
                else None, host_us_per_call=host_us,
                device_kernels=sorted(by_name))


def print_readings(label, timing, reading, launches):
    """Print one B1/B2/B4 or scan case's readings; with ``launches`` set,
    fail unless each call made exactly that many device launches."""
    per_call = reading["launches_per_call"]
    dev_us = reading["device_us_per_launch"]
    loop_us = timing["ms"] * 1e3
    bound_by = ("host-bound: the card runs "
                f"{dev_us * per_call:.2f} us of it" if dev_us is not None
                and reading["host_us_per_call"] > dev_us * per_call
                else "device-bound")
    dev_txt = f"{dev_us:.2f}" if dev_us is not None else "none traced"
    print(f"    {label}: loop {timing['ms']:.4f} ms a call ({bound_by}); "
          f"device {dev_txt} us a launch, {per_call:g} device launches a "
          f"call ({reading['recorded_per_call']:g} recorded on the card: "
          f"{', '.join(k[:60] for k in reading['device_kernels'])}); "
          f"host {reading['host_us_per_call']:.2f} us a call (enqueue), "
          f"loop {loop_us:.2f} us; the window's lead lost "
          "%d of its %d records" % reading["lead_lost"], flush=True)
    if launches is not None and not (
            per_call == launches == reading["recorded_per_call"]):
        raise AssertionError(f"{label}: {per_call} device launches a call "
                             f"({reading['recorded_per_call']} recorded on "
                             f"the card; no record of the launches at "
                             f"{reading['missing']}), not {launches}")


def unaligned_copy(torch, t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary: the elementwise kernels take their scalar path."""
    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return u.view(t.shape).copy_(t)


def elementwise_cases(torch, ops, ref, randn, cases, launches=1):
    """Phase 3's B2 (``ddim_fused``), B1 (``parareal_update_residual``)
    and B4 (``parareal_update``) cases: each held against its plain
    version (DDIM within 2e-5 in f32, the update bitwise, a residual at
    atol 0 and rtol 1e-5), run twice (bitwise equal), timed with CUDA
    events and read by :func:`launch_readings`; B1's per-slice residuals
    of a (4, 2, 64, 64, 4) batch against the slices run alone.  ``launches``: the
    device launches a call must make (None reads them only, as
    scripts/torch_elementwise_bench.py does for another checkout's
    kernels, which also skips the check that the kernels' scalar path,
    taken for unaligned operands, gives the 16-byte path's bits)."""
    dev = torch.device("cuda")
    # DDIM: the fine step's 10 folded latents (the main path's shape, first)
    # and the coarse step's 2, per-row coefficients
    print("  ddim_fused and parareal_update_residual (B2, B1):", flush=True)
    for shape in [(BLOCKS * SAMPLES, 64, 64, 4), (SAMPLES, 64, 64, 4)]:
        x, e = randn(shape), randn(shape)
        a = torch.linspace(0.05, 0.6, shape[0], device=dev)
        b = a + 0.3
        got = ops.ddim_fused(x, e, a, b)
        if not torch.equal(_bits(ops.ddim_fused(x, e, a, b)), _bits(got)):
            raise AssertionError("ddim_fused: two runs differ")
        b_ms, b_by = bound(nbytes(x, e, got, a, b), 10.0 * x.numel(),
                           "float32")
        timing = dict(ms=time_ms(lambda: ops.ddim_fused(x, e, a, b), 500),
                      plain_ms=time_ms(lambda: ops.ddim_fused(
                          x, e, a, b, use_kernel=False), 200),
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
        label = f"ddim_fused float32 {shape} per-row"
        cases["ddim_fused"].append(dict(check_case(
            f"{label} (two runs bitwise)", got, ref.ddim_fused(x, e, a, b),
            2e-5, 2e-5, timing), **launch_readings(
                torch, lambda: ops.ddim_fused(x, e, a, b))))
        print_readings(label, timing, cases["ddim_fused"][-1], launches)
        if launches is not None:
            xu, eu = (unaligned_copy(torch, t) for t in (x, e))
            if not torch.equal(_bits(ops.ddim_fused(xu, eu, a, b)),
                               _bits(got)):
                raise AssertionError("ddim_fused: the scalar path (unaligned "
                                     "operands) differs from the 16-byte "
                                     "path")

    # fused update + residual: one corrector block (K=2 latents) per
    # sample, plus the scalar and per-(block, sample) reductions; a batch of
    # 4; ragged slices (6993 elements: the scalar path, a cluster of 2; 7
    # elements in bf16: 3000 clusters of one block)
    for nd, shape, dtype in [(1, (SAMPLES, 64, 64, 4), "float32"),
                             (0, (SAMPLES, 64, 64, 4), "float32"),
                             (2, (BLOCKS, SAMPLES, 64, 64, 4), "float32"),
                             (1, (4, SAMPLES, 64, 64, 4), "float32"),
                             (1, (3, 999, 7), "float32"),
                             (2, (3, 1000, 7), "bfloat16")]:
        tdt = getattr(torch, dtype)
        y, c, p, o = (randn(shape, tdt) for _ in range(4))
        out, resid = ops.parareal_update_residual(y, c, p, o, batch_dims=nd)
        again = ops.parareal_update_residual(y, c, p, o, batch_dims=nd)
        out_r, resid_r = ref.parareal_update_residual(y, c, p, o,
                                                      batch_dims=nd)
        if not torch.equal(_bits(out), _bits(out_r)):
            raise AssertionError("parareal_update_residual: the update is "
                                 "not bitwise equal to its plain version")
        if not (torch.equal(_bits(again[0]), _bits(out))
                and torch.equal(_bits(again[1]), _bits(resid))):
            raise AssertionError("parareal_update_residual: two runs differ")
        if launches is not None:
            yu, cu, pu, ou = (unaligned_copy(torch, t) for t in (y, c, p, o))
            su = ops.parareal_update_residual(yu, cu, pu, ou, batch_dims=nd)
            if not (torch.equal(_bits(su[0]), _bits(out))
                    and torch.equal(_bits(su[1]), _bits(resid))):
                raise AssertionError("parareal_update_residual: the scalar "
                                     "path (unaligned operands) differs "
                                     "from the 16-byte path")
        b_ms, b_by = bound(nbytes(y, c, p, o, out, resid),
                           5.0 * y.numel(), "float32")
        timing = dict(
            ms=time_ms(lambda: ops.parareal_update_residual(
                y, c, p, o, batch_dims=nd), 500),
            plain_ms=time_ms(lambda: ops.parareal_update_residual(
                y, c, p, o, batch_dims=nd, use_kernel=False), 200),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        label = f"parareal_update_residual {dtype} {shape} batch_dims={nd}"
        cases["parareal_update_residual"].append(dict(check_case(
            f"{label} (out bitwise, two runs bitwise)", resid, resid_r,
            0.0, 1e-5, timing), **launch_readings(
                torch, lambda: ops.parareal_update_residual(
                    y, c, p, o, batch_dims=nd))))
        print_readings(label, timing, cases["parareal_update_residual"][-1],
                       launches)

    # a slice's results do not depend on the batch around it
    y, c, p, o = (randn((4, SAMPLES, 64, 64, 4)) for _ in range(4))
    out, resid = ops.parareal_update_residual(y, c, p, o, batch_dims=1)
    for k in range(y.shape[0]):
        s = slice(k, k + 1)
        out_k, resid_k = ops.parareal_update_residual(
            y[s], c[s], p[s], o[s], batch_dims=1)
        if not (torch.equal(_bits(out_k), _bits(out[s]))
                and torch.equal(_bits(resid_k), _bits(resid[s]))):
            raise AssertionError(f"parareal_update_residual: slice {k} "
                                 f"alone differs from slice {k} of the batch")
    print(f"  parareal_update_residual: each slice of a "
          f"{tuple(y.shape)} batch (batch_dims=1) run alone: out and "
          f"residual bitwise equal", flush=True)

    # the update without the residual (B4): one corrector block of the
    # serving engine's 2 slots (the l2_mean run's shape, first), a ragged
    # size and a batch of blocks, each in f32 and bf16; the first call is
    # timed alone (a reading: the occupancy query and the geometry of a new
    # configuration, no compiler)
    print("  parareal_update (B4):", flush=True)
    first_ms = None
    for shape, dtype in [((SAMPLES, 64, 64, 4), "float32"),
                         ((SAMPLES, 64, 64, 4), "bfloat16"),
                         ((3, 1000, 7), "float32"),
                         ((3, 1000, 7), "bfloat16"),
                         ((BLOCKS, SAMPLES, 64, 64, 4), "float32"),
                         ((BLOCKS, SAMPLES, 64, 64, 4), "bfloat16")]:
        tdt = getattr(torch, dtype)
        y, c, p = (randn(shape, tdt) for _ in range(3))
        if first_ms is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.parareal_update(y, c, p)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            print(f"    reading: the first parareal_update call here, "
                  f"{dtype} {shape}: {first_ms:.3f} ms of wall time",
                  flush=True)
        out, resid = ops.parareal_update(y, c, p)
        again = ops.parareal_update(y, c, p)
        out_r, resid_r = ref.parareal_update(y, c, p)
        if not torch.equal(_bits(out), _bits(out_r)):
            raise AssertionError("parareal_update: the update is not bitwise "
                                 "equal to its plain version")
        if not (torch.equal(_bits(again[0]), _bits(out))
                and torch.equal(_bits(again[1]), _bits(resid))):
            raise AssertionError("parareal_update: two runs differ")
        if launches is not None:
            su = ops.parareal_update(*(unaligned_copy(torch, t)
                                       for t in (y, c, p)))
            if not (torch.equal(_bits(su[0]), _bits(out))
                    and torch.equal(_bits(su[1]), _bits(resid))):
                raise AssertionError("parareal_update: the scalar path "
                                     "(unaligned operands) differs from the "
                                     "16-byte path")
        b_ms, b_by = bound(nbytes(y, c, p, out, resid), 5.0 * y.numel(),
                           "float32")
        timing = dict(
            ms=time_ms(lambda: ops.parareal_update(y, c, p), 500),
            plain_ms=time_ms(lambda: ops.parareal_update(
                y, c, p, use_kernel=False), 200),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        label = f"parareal_update {dtype} {shape}"
        cases["parareal_update"].append(dict(check_case(
            f"{label} (out bitwise, two runs bitwise)", resid, resid_r, 0.0,
            1e-5, timing), first_call_ms=first_ms, **launch_readings(
                torch, lambda: ops.parareal_update(y, c, p))))
        print_readings(label, timing, cases["parareal_update"][-1], launches)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        with torch.cuda.device(dev):
            pass
    guard_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    print(f"  reading: host cost of a torch.cuda.device guard {guard_us:.2f} "
          f"us a call (the CUDA wrappers enter it only for a tensor on "
          f"another card than the current one)", flush=True)


def kernel_phase(torch, ops, ref):
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    for source, kernel in (("flash_attention_fwd", "flash_fwd_kernel_tc"),
                           ("flash_attention_bwd", "flash_bwd_dq_kernel_tc"),
                           ("flash_attention_bwd",
                            "flash_bwd_dkv_kernel_tc")):
        log = _build.build_log.get(source)
        readings = ptxas_readings(log, kernel) if log else []
        print(f"  ptxas, {kernel}<head dim padded to 16, terms> (registers "
              f"at entry; the consumer warpgroups raise theirs with "
              f"setmaxnreg, to 240 in the forward, 232 in dq and dkv): "
              + ("; ".join(
                  f"<{inst}> {regs} registers, spills {st}/{ld} bytes "
                  f"(stores/loads)" for inst, regs, st, ld in readings)
                  if readings else "not rebuilt in this run"), flush=True)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [],
             "flash_attention_bwd_dkv": [], "ddim_fused": [],
             "parareal_update_residual": [], "parareal_update": [],
             "flash_attention_fwd_causal_gqa": [], "rwkv6_wkv": [],
             "flash_attention_bwd_dq_causal_gqa": [],
             "flash_attention_bwd_dkv_causal_gqa": [], "rwkv6_wkv_bwd": [],
             "flash_attention_fwd_window": [], "selective_scan": [],
             "flash_attention_bwd_dq_window": [],
             "flash_attention_bwd_dkv_window": [], "selective_scan_bwd": [],
             "flash_attention_fwd_shard": []}
    # flash forward: SD-v2 fine and coarse batches (10 and 2 latents x 16
    # heads, S 1024, D 72) in bf16, CIFAR-width f32, and ragged Sq/Sk
    for bh, sq, sk, d, dtype in [(160, 1024, 1024, 72, "bfloat16"),
                                 (32, 1024, 1024, 72, "bfloat16"),
                                 (24, 64, 64, 64, "float32"),
                                 (32, 100, 77, 72, "bfloat16")]:
        tdt = getattr(torch, dtype)
        q, k, v = (randn((1, bh, s, d), tdt) for s in (sq, sk, sk))
        got = ops.attention(q, k, v, causal=False)
        want, _ = ref.attention(q, k, v, causal=False)
        reps = 20 if sq >= 1024 else 200
        flops = 4.0 * bh * sq * sk * d
        b_ms, b_by = bound(nbytes(q, k, v, got) + 4 * bh * sq, flops, dtype)
        timing = dict(
            ms=time_ms(lambda: ops.attention(q, k, v, causal=False), reps),
            plain_ms=time_ms(lambda: ops.attention(q, k, v, causal=False,
                                                   use_kernel=False),
                             max(reps // 10, 2)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v), reps))
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        rel, rel_lim = rel_l2([got], [want]), MASKED_REL_L2[dtype]
        cases["flash_attention_fwd"].append(check_case(
            f"flash_attention_fwd {dtype} BH={bh} Sq={sq} Sk={sk} D={d} "
            f"({route_label(fa, tdt, d)}; rel L2 {rel:.3e}, limit "
            f"{rel_lim})", got, want, tol, tol, timing))
        if not rel <= rel_lim:
            raise AssertionError(f"flash_attention_fwd {dtype} BH={bh}: rel "
                                 f"L2 {rel} against the plain version")
        if bh == 160:
            terms_control(torch, fa, q, k, v, want, dict(causal=False),
                          rel_lim)

    shard_flash_case(torch, ops, ref, randn, cases)
    masked_flash_cases(torch, ops, ref, randn, cases)
    backward_cases(torch, ref, randn, cases)
    masked_backward_cases(torch, ref, randn, cases)

    elementwise_cases(torch, ops, ref, randn, cases)

    wkv_readings(torch)
    wkv_cases(torch, ops, ref, randn, cases)
    wkv_backward_cases(torch, ref, randn, cases)
    scan_cases(torch, ops, randn, cases)
    scan_backward_cases(torch, ref, randn, cases)
    return cases


def shard_flash_case(torch, ops, ref, randn, cases):
    """Phase 3's row of the flash forward at the patch-sharded DiT's shape
    (phase 15): one of two row shards of the SD-v2 DiT's 2 latents x 16
    heads, Sq 512 queries against all Sk 1024 keys, D 72, bf16 (the
    tensor-core route), held to the bf16 cases' rel L2 limit."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    bh, sq, sk, d, dtype = 32, 512, 1024, 72, "bfloat16"
    tdt = getattr(torch, dtype)
    q, k, v = (randn((1, bh, s, d), tdt) for s in (sq, sk, sk))
    got = ops.attention(q, k, v, causal=False)
    want, _ = ref.attention(q, k, v, causal=False)
    b_ms, b_by = bound(nbytes(q, k, v, got) + 4 * bh * sq,
                       4.0 * bh * sq * sk * d, dtype)
    timing = dict(
        ms=time_ms(lambda: ops.attention(q, k, v, causal=False), 50),
        plain_ms=time_ms(lambda: ops.attention(q, k, v, causal=False,
                                               use_kernel=False), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           50))
    rel = rel_l2([got], [want])
    # the call's device time beside its host time, and the unsharded
    # coarse batch's (BH 32, Sq = Sk = 1024) in the same process
    for label, qq in (("shard", q), ("Sq = Sk", randn((1, bh, sk, d), tdt))):
        print_readings(f"flash forward at {label} BH={bh} Sq={qq.shape[2]} "
                       f"Sk={sk}", dict(ms=time_ms(lambda: ops.attention(
                           qq, k, v, causal=False), 50)),
                       launch_readings(torch, lambda: ops.attention(
                           qq, k, v, causal=False)), None)
    cases["flash_attention_fwd_shard"].append(check_case(
        f"flash_attention_fwd {dtype} BH={bh} Sq={sq} Sk={sk} D={d}, the "
        f"row shard's shape ({route_label(fa, tdt, d)}; rel L2 {rel:.3e}, "
        f"limit {SHARD_FLASH_REL_L2})", got, want, 2e-2, 2e-2, timing))
    if not rel <= SHARD_FLASH_REL_L2:
        raise AssertionError(f"flash_attention_fwd at Sq {sq}, Sk {sk}: rel "
                             f"L2 {rel} against the plain version")


def dit_setup(torch):
    """Phases 4-6's model and inputs: the full-width ``srds-dit-sd2`` DiT
    from seeded random weights, its denoiser, the ``ddpm_linear`` schedule
    of ``N_STEPS``, the DDIM solver, the blocks ``B`` of ``S`` steps,
    ``x_init`` from ``SEED`` and the main path's ``SRDSConfig`` (``fixed``:
    ``max_iters=B``).  Returns them, with ``cfg``, the JAX-layout ``tree``
    and the seconds the model took to build, as a namespace."""
    import types

    import numpy as np
    import repro_torch.core as C
    from repro_torch.configs import get_arch
    from repro_torch.models import dit

    cfg = get_arch("srds-dit-sd2")
    t0 = time.perf_counter()
    tree = dit.random_jax_tree(cfg, seed=SEED)
    model = dit.load_jax_params(cfg, tree, device="cuda")
    build_s = time.perf_counter() - t0
    B, S = C.resolve_blocks(N_STEPS, BLOCKS)
    x_init = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (SAMPLES, 64, 64, 4)).astype(np.float32)).cuda()
    fixed = C.SRDSConfig(num_blocks=B, max_iters=B, fixed_iters=True,
                         per_sample=True, tol=0.0)
    return types.SimpleNamespace(
        cfg=cfg, tree=tree, model=model, build_s=build_s,
        model_fn=dit.make_denoiser(model),
        sched=C.make_schedule("ddpm_linear", N_STEPS),
        solver=C.SolverConfig("ddim"), B=B, S=S, x_init=x_init, fixed=fixed)


def ddpm_paradigms_phase(torch, C, run, setup, layers, head):
    """Phase 5: the ``ddpm`` solver through SRDS and the ParaDiGMS
    baseline on phase 4's DiT, schedule and latents (see the module
    docstring).  ``run`` is phase 4's runner (launch counts reset just
    before, read just after, the tensor-core route checked); ``head``
    holds phase 4's sequential and early-exit readings for the headline.
    Returns the launch counts of the DDPM-SRDS and ParaDiGMS runs."""
    from repro_torch.core.solvers import frozen_noise

    s = setup
    n, B, S = N_STEPS, s.B, s.S

    def expect(counts, evals, ddim, resid, label):
        want = dict(dict.fromkeys(counts, 0),
                    flash_attention_fwd=layers * evals, ddim_fused=ddim,
                    parareal_update_residual=resid)
        if counts != want:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{want}")

    print(f"[5/15] ddpm with frozen noise (seed {DDPM_SEED}) and ParaDiGMS "
          f"on srds-dit-sd2, N={n}", flush=True)
    # the native noise is a pure function of (seed, interval id)
    iid = 3 * (n + 1) + 4
    draws = [frozen_noise(DDPM_SEED, i, tuple(s.x_init.shape),
                          torch.float32, s.x_init.device)
             for i in (iid, iid, iid + 1)]
    if not torch.equal(_bits(draws[0]), _bits(draws[1])) \
            or torch.equal(draws[0], draws[2]):
        raise AssertionError("the native ddpm noise is not a pure function "
                             "of (seed, interval id)")
    print(f"  native noise: interval {iid} drawn twice bitwise equal, "
          f"interval {iid + 1} differs", flush=True)

    ddpm = C.SolverConfig("ddpm", noise_seed=DDPM_SEED)
    seq, counts, _ = run("ddpm sample_sequential", lambda: C.sample_sequential(
        s.model_fn, s.sched, ddpm, s.x_init))
    expect(counts, n, 0, 0, "ddpm sample_sequential")
    res, ddpm_counts, _ = run(
        "ddpm srds_sample max_iters=B",
        lambda: C.srds_sample(s.model_fn, s.sched, ddpm, s.x_init, s.fixed),
        "ddpm_srds")
    p = int(res.iterations.max())
    expect(ddpm_counts, B + p * (S + B), 0, p * B, "ddpm srds_sample")
    if res.sample.shape != s.x_init.shape or not bool(
            torch.isfinite(res.sample).all()):
        raise AssertionError("ddpm srds sample is not finite or has the "
                             "wrong shape")
    rel = rel_l2([res.sample], [seq])
    other = C.SolverConfig("ddpm", noise_seed=DDPM_SEED + 1)
    ctrl, _, _ = run("control: ddpm srds_sample from another noise seed",
                     lambda: C.srds_sample(s.model_fn, s.sched, other,
                                           s.x_init, s.fixed))
    rel_ctrl = rel_l2([ctrl.sample], [seq])
    print(f"  ddpm srds vs sequential: rel L2 {rel:.3e} (limit "
          f"{SRDS_VS_SEQ_REL_L2}); control (noise seed {DDPM_SEED + 1}) "
          f"{rel_ctrl:.3e}, must miss it; iterations "
          f"{res.iterations.tolist()}", flush=True)
    if not rel <= SRDS_VS_SEQ_REL_L2:
        raise AssertionError(f"ddpm srds at max_iters=B differs from the "
                             f"sequential ddpm sample: rel L2 {rel}")
    if not rel_ctrl > SRDS_VS_SEQ_REL_L2:
        raise AssertionError(f"the ddpm control met the limit: rel L2 "
                             f"{rel_ctrl}")

    # ParaDiGMS: the window is the whole grid, one latent
    x1 = s.x_init[:1]
    seq1, counts, wall_seq1 = run("sample_sequential K=1",
                                  lambda: C.sample_sequential(
                                      s.model_fn, s.sched, s.solver, x1))
    expect(counts, n, n, 0, "sample_sequential K=1")

    def paradigms(tol, max_iters=10_000):
        return C.paradigms_sample(s.model_fn, s.sched, s.solver, x1,
                                  C.ParaDiGMSConfig(window=n, tol=tol,
                                                    max_iters=max_iters))

    pd, pd_counts, _ = run(f"paradigms tol={PD_EXACT_TOL}",
                           lambda: paradigms(PD_EXACT_TOL), "paradigms")
    expect(pd_counts, pd.iterations, pd.iterations, 0, "paradigms")
    rel_pd = rel_l2([pd.sample], [seq1])
    one, counts, _ = run("control: paradigms max_iters=1",
                         lambda: paradigms(PD_EXACT_TOL, 1))
    expect(counts, 1, 1, 0, "paradigms max_iters=1")
    rel_one = rel_l2([one.sample], [seq1])
    print(f"  paradigms vs sequential: rel L2 {rel_pd:.3e} (limit "
          f"{SRDS_VS_SEQ_REL_L2}), {pd.iterations} sweeps, "
          f"{pd.total_evals} evals; control (one sweep) {rel_one:.3e}, "
          f"must miss it", flush=True)
    if not bool(torch.isfinite(pd.sample).all()) \
            or not rel_pd <= SRDS_VS_SEQ_REL_L2:
        raise AssertionError(f"paradigms differs from the sequential "
                             f"sample: rel L2 {rel_pd}")
    if not rel_one > SRDS_VS_SEQ_REL_L2:
        raise AssertionError(f"the paradigms control met the limit: rel "
                             f"L2 {rel_one}")
    pr, counts, wall_pd = run(f"paradigms tol={PD_READ_TOL}",
                              lambda: paradigms(PD_READ_TOL))
    expect(counts, pr.iterations, pr.iterations, 0, "paradigms reading")
    st = C.paradigms_stats(pr, s.solver)
    rel_pr = rel_l2([pr.sample], [seq1])
    print(f"  paradigms tol={PD_READ_TOL}: {pr.iterations} sweeps, serial "
          f"evals {st.serial_evals}, total evals {st.total_evals}, wall "
          f"{wall_pd:.3f} s, rel L2 vs sequential {rel_pr:.3e}", flush=True)
    print(f"  headline (N={n}): sequential {head['seq_wall']:.3f} s (K=2, "
          f"{n} serial evals; K=1 {wall_seq1:.3f} s); srds tol={EARLY_TOL} "
          f"{head['srds_wall']:.3f} s (K=2, iterations "
          f"{head['srds_iters']}, serial evals {head['srds_serial']}); "
          f"paradigms tol={PD_READ_TOL} {wall_pd:.3f} s (K=1, "
          f"{pr.iterations} sweeps, serial evals {st.serial_evals})",
          flush=True)
    return ddpm_counts, pd_counts


def timed(torch, fn):
    """``fn()``'s result and its wall seconds, the card synchronized at
    both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def port_kernel_records(by_name: dict) -> dict:
    """The port's kernels' device launches in a ``window_launches``
    reading, by kernel (B1, B2, B3 and B4)."""
    out = {}
    for name, (count, _) in by_name.items():
        for k in PORT_KERNEL_NAMES:
            if k in name:
                out[k] = out.get(k, 0) + count
    return out


def record_kind(name: str) -> str:
    """A device record's kind, by its name: ``"Memcpy"``, ``"Memset"`` or
    ``"kernel"``."""
    return next((k for k in ("Memcpy", "Memset") if name.startswith(k)),
                "kernel")


def api_kind(name: str) -> str:
    """The kind of device activity a host launch call starts (a
    ``profiling.LAUNCH_APIS`` name), as :func:`record_kind` names it."""
    return next((k for k in ("Memcpy", "Memset") if k in name), "kernel")


def drivers_phase(torch, ops, C, step, path_counts):
    """Phase 14, part 1: the block-sharded and the wavefront drivers on an
    NCCL group of one rank (module docstring).  Adds the two runs' launch
    counts to ``path_counts``."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.pipelined import (make_pipelined_sampler,
                                            make_sharded_sampler)
    from repro_torch.launch.mesh import init_process_group, make_srds_mesh
    from repro_torch.runtime.profiling import window_launches

    s = dit_setup(torch)
    n, B, S, layers = N_STEPS, s.B, s.S, s.cfg.num_layers
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    early = C.SRDSConfig(num_blocks=B, per_sample=True, tol=EARLY_TOL)
    pert = s.x_init + DRIVER_PERTURB * torch.from_numpy(
        np.random.default_rng(SEED + 1).standard_normal(
            tuple(s.x_init.shape)).astype(np.float32)).cuda()
    print(f"[{step}/15] the SRDS drivers on torch.distributed: NCCL "
          f"{nccl}, one rank, srds-dit-sd2 (N={n}, B={B}, K={SAMPLES}, "
          f"tol={EARLY_TOL}), DiT built in {s.build_s:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as store:
        init_process_group(store, 0, 1, device_type="cuda")
        try:
            mesh = make_srds_mesh(1)
            print(f"  process group: backend {dist.get_backend()}, world "
                  f"size {dist.get_world_size()}; mesh "
                  f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}",
                  flush=True)
            sharded = make_sharded_sampler(mesh, "time", s.model_fn, s.sched,
                                           s.solver, early)

            def single(x):
                return C.srds_sample(s.model_fn, s.sched, s.solver, x, early)

            # the main path: counts reset just before, read just after
            ops.reset_launch_counts()
            res, wall = timed(torch, lambda: sharded(s.x_init))
            counts = ops.launch_counts()
            check_tc_route(ops, counts, "sharded driver", "sharded_srds")
            ops.reset_launch_counts()
            ref, ref_wall = timed(torch, lambda: single(s.x_init))
            ref_counts = ops.launch_counts()
            p = int(res.iterations.max())
            want = dict(dict.fromkeys(counts, 0),
                        flash_attention_fwd=layers * (B + p * (S + B)),
                        ddim_fused=B + p * (S + B),
                        parareal_update_residual=p * B)
            print(f"  sharded driver: wall {wall:.3f} s, iterations "
                  f"{res.iterations.tolist()}, launches {counts}; "
                  f"srds_sample: wall {ref_wall:.3f} s, iterations "
                  f"{ref.iterations.tolist()}, launches {ref_counts}",
                  flush=True)
            if counts != want or ref_counts != want:
                raise AssertionError(f"sharded driver launches {counts}, "
                                     f"srds_sample {ref_counts}, want {want}")
            if not torch.equal(res.iterations, ref.iterations):
                raise AssertionError(f"sharded driver iterations "
                                     f"{res.iterations.tolist()} != "
                                     f"{ref.iterations.tolist()}")
            rel = rel_l2([res.sample], [ref.sample])
            ctrl, _ = timed(torch, lambda: sharded(pert))
            rel_ctrl = rel_l2([ctrl.sample], [ref.sample])
            print(f"  sharded vs srds_sample: rel L2 {rel:.3e} (limit "
                  f"{SHARDED_REL_L2}); control (input moved by "
                  f"{DRIVER_PERTURB} x N(0, 1)) {rel_ctrl:.3e}, must miss "
                  f"it", flush=True)
            if not (bool(torch.isfinite(res.sample).all())
                    and rel <= SHARDED_REL_L2):
                raise AssertionError(f"the sharded driver differs from "
                                     f"srds_sample: rel L2 {rel}")
            if not rel_ctrl > SHARDED_REL_L2:
                raise AssertionError(f"the sharded driver's control met the "
                                     f"limit: rel L2 {rel_ctrl}")
            # device launches of the port's kernels, from the profiler
            recs = {name: window_launches(lambda f=f: f(s.x_init), 1)
                    for name, f in (("srds_sample", single),
                                    ("sharded", sharded))}
            kern = {k: port_kernel_records(v["device"])
                    for k, v in recs.items()}
            other = sorted(k[:48] for k in recs["sharded"]["device"]
                           if k not in recs["srds_sample"]["device"])
            print(f"  device launches of the port's kernels (profiler): "
                  f"srds_sample {kern['srds_sample']}, sharded "
                  f"{kern['sharded']}; lead lost "
                  f"{recs['sharded']['lead_lost']}, missing "
                  f"{len(recs['sharded']['missing'])}; activities only the "
                  f"sharded run has: {other}", flush=True)
            lost = {k: v["lead_lost"] + len(v["missing"])
                    for k, v in recs.items()}
            if not any(lost.values()):
                if kern["sharded"] != kern["srds_sample"]:
                    raise AssertionError(f"device launches differ: {kern}")
            else:
                # late in a long process the profiler keeps no record of
                # some launches (ROADMAP C12): each record is then at most
                # the counter's count, short of it by no more than the
                # launches the window lost
                names = dict(zip(PORT_KERNEL_NAMES, (
                    "ddim_fused", "parareal_update_residual",
                    "flash_attention_fwd", "parareal_update")))
                for run_name, rec in kern.items():
                    for kernel, got in rec.items():
                        counted = counts[names[kernel]]
                        if not counted - lost[run_name] <= got <= counted:
                            raise AssertionError(
                                f"{run_name}: {got} device records of "
                                f"{kernel}, {counted} launches counted, "
                                f"{lost[run_name]} records lost (C12)")
                print(f"  the profiler lost records (C12): {lost}; each "
                      f"kernel's records within the loss of its count",
                      flush=True)
            # wall seconds in turns: single, sharded, sharded, single
            walls = {"srds_sample": [], "sharded": []}
            for name in ("srds_sample", "sharded", "sharded", "srds_sample"):
                f = single if name == "srds_sample" else sharded
                walls[name].append(timed(torch, lambda: f(s.x_init))[1])
            print(f"  wall seconds in turns at tol={EARLY_TOL}: srds_sample "
                  f"{walls['srds_sample']}, sharded {walls['sharded']}",
                  flush=True)
            path_counts["sharded_srds"] = counts

            # the wavefront at one rank: one block, B=1, S=N
            wf = make_pipelined_sampler(mesh, "time", s.model_fn, s.sched,
                                        s.solver, C.SRDSConfig(tol=0.0))
            ops.reset_launch_counts()
            (wres, steps, evals), wf_wall = timed(torch,
                                                  lambda: wf(s.x_init))
            wf_counts = ops.launch_counts()
            check_tc_route(ops, wf_counts, "wavefront", "wavefront")
            seq, seq_wall = timed(torch, lambda: C.sample_sequential(
                s.model_fn, s.sched, s.solver, s.x_init))
            wrel = rel_l2([wres.sample], [seq])
            (wctrl, _, _), _ = timed(torch, lambda: wf(pert))
            wrel_ctrl = rel_l2([wctrl.sample], [seq])
            wwant = dict(dict.fromkeys(wf_counts, 0),
                         flash_attention_fwd=layers * n, ddim_fused=n,
                         parareal_update=n)
            print(f"  wavefront (one rank, B=1): wall {wf_wall:.3f} s "
                  f"(sample_sequential {seq_wall:.3f} s), {steps} "
                  f"supersteps, {evals} physical evals, launches "
                  f"{wf_counts}; vs sample_sequential rel L2 {wrel:.3e} "
                  f"(limit {SRDS_VS_SEQ_REL_L2}), control {wrel_ctrl:.3e}, "
                  f"must miss it", flush=True)
            if wf_counts != wwant or (steps, evals) != (n + 3, 2 * n):
                raise AssertionError(f"wavefront launches {wf_counts} (want "
                                     f"{wwant}), {steps} supersteps, "
                                     f"{evals} evals")
            if not wrel <= SRDS_VS_SEQ_REL_L2 < wrel_ctrl:
                raise AssertionError(f"wavefront vs sequential rel L2 "
                                     f"{wrel}, control {wrel_ctrl}")
            walls = {"wavefront": [], "sample_sequential": []}
            for name in ("wavefront", "sample_sequential",
                         "sample_sequential", "wavefront"):
                walls[name].append(timed(torch, (lambda: wf(s.x_init))
                                         if name == "wavefront" else
                                         (lambda: C.sample_sequential(
                                             s.model_fn, s.sched, s.solver,
                                             s.x_init)))[1])
            print(f"  wall seconds in turns: wavefront {walls['wavefront']}"
                  f", sample_sequential {walls['sample_sequential']}",
                  flush=True)
            path_counts["wavefront"] = wf_counts
        finally:
            dist.destroy_process_group()


def serving_tables_phase(torch):
    """Phase 14, part 2: ``table9_batched`` and ``table10_slo`` on the card
    against the same emitters on the CPU (ROADMAP C20), then
    ``table10_wallclock`` served by the full DiT."""
    from repro_torch.benchmarks import (table9_batched, table10_slo,
                                        table10_wallclock)
    print("  table9_batched and table10_slo on the card and on the CPU:",
          flush=True)
    t9 = {d: table9_batched.main(device=d) for d in ("cuda", "cpu")}
    for card, cpu in zip(t9["cuda"], t9["cpu"]):
        tols = card["request_tols"]
        exact = [i for i, t in enumerate(tols) if t >= ROUNDOFF_FREE_TOL]
        diff = [(i, tols[i], card["request_iters"][i],
                 cpu["request_iters"][i]) for i in range(len(tols))
                if card["request_iters"][i] != cpu["request_iters"][i]]
        print(f"    table9 batch {card['batch']}: requests whose "
              f"iterations differ (index, tol, card, cpu): {diff}",
              flush=True)
        if any(i in exact for i, _, _, _ in diff):
            raise AssertionError(f"table9 batch {card['batch']}: a request "
                                 f"at tol >= {ROUNDOFF_FREE_TOL} stopped at "
                                 f"another iteration on the card: {diff}")
        if not diff and card != cpu:
            raise AssertionError(f"table9 rows differ: {card} != {cpu}")
    t10 = {d: table10_slo.main(device=d) for d in ("cuda", "cpu")}
    if t10["cuda"] != t10["cpu"]:
        raise AssertionError(f"table10_slo rows differ on the card: "
                             f"{t10['cuda']} != {t10['cpu']}")
    print("    table10_slo: every row equal to the CPU's", flush=True)
    t0 = time.perf_counter()
    rows = table10_wallclock.main(device="cuda", arch="srds-dit-sd2",
                                  layers=HERD_LAYERS)
    cut = table10_wallclock.DIT_CUT
    print(f"  table10_wallclock --arch srds-dit-sd2 --layers {HERD_LAYERS} "
          f"({cut['n_heavy']} "
          f"heavies, {cut['n_light']} lights, loads {cut['loads']} of "
          f"{cut['sweep_requests']}): {time.perf_counter() - t0:.1f} s, "
          f"the four gates held", flush=True)
    for r in rows:
        if r["trace"] == "calibration":
            print(f"    calibration: {r['sec_per_eval'] * 1e3:.3f} ms a "
                  f"physical eval, warm herd {r['makespan_s']:.3f} s (cold "
                  f"{r['makespan_cold_s']:.3f} s), {r['physical_evals']} "
                  f"evals", flush=True)
        elif "latency_p50_ms" in r:
            light = (f", light tier p95 {r['light_p95_ms'] / 1e3:.3f} s"
                     if "light_p95_ms" in r else "")
            print(f"    served wall seconds per request, {r['trace']} "
                  f"{r['policy']}: p50 {r['latency_p50_ms'] / 1e3:.3f}, "
                  f"p95 {r['latency_p95_ms'] / 1e3:.3f}{light}; "
                  f"attainment {r['slo_attainment']:.2f}, goodput "
                  f"{r['goodput_rps']:.3f} rps, makespan "
                  f"{r['makespan_s']:.3f} s", flush=True)
        else:
            print(f"    overlap A/B: sync {r['makespan_sync_s']:.3f} s, "
                  f"async {r['makespan_async_s']:.3f} s", flush=True)


def _served(torch, C, fn, s, **kw):
    """Phase 15 (a): ``SHARD_SERVED`` requests of phase 4's latents' shape
    through a ``DiffusionSamplingEngine`` on ``fn`` (N, B and tol of phase
    14), their responses in rid order."""
    from repro_torch.benchmarks.common import host_noise
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    eng = DiffusionSamplingEngine(
        fn, tuple(s.x_init.shape[1:]), s.solver, num_steps=N_STEPS,
        batch_size=SAMPLES, num_blocks=s.B, noise_fn=host_noise, **kw)
    rids = [eng.submit(SampleRequest(seed=SEED + i, tol=EARLY_TOL))
            for i in range(SHARD_SERVED)]
    out = eng.drain()
    return [out[r] for r in rids]


def _bitwise(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _capture_kv(dit, model, x, t):
    """Each layer's ``(k, v)`` of ``model``'s unsharded forward, and the
    forward's output."""
    kv = []
    real = dit.attention_full

    def capture(*a, **kw):
        out = real(*a, **kw)
        kv.append(out[1])
        return out

    dit.attention_full = capture
    try:
        out = model(x, t)
    finally:
        dit.attention_full = real
    return kv, out


def _shard_forward(model, x, t, r, m, kv, rank_pos, local=None):
    """Rows ``r`` of ``m`` of ``x`` through the row-sharded forward at
    position rank ``rank_pos``, its ``kv_gather`` handing back the full
    forward's own K/V (``kv``); ``local`` collects the rel L2 of each
    layer's local K/V against the full K/V's rows."""
    rows = x.shape[1] // m
    n = (rows // model.cfg.patch_size) * (x.shape[2] // model.cfg.patch_size)
    calls = []

    def hook(a):
        layer, which = divmod(len(calls), 2)
        calls.append(a)
        full = kv[layer][which]
        if local is not None:
            mine = full[:, r * n:(r + 1) * n]
            local.append((rel_l2([a], [mine]), bool((a == mine).all())))
        return full

    return model(x[:, r * rows:(r + 1) * rows], t, shard_rank=rank_pos,
                 kv_gather=hook)


def gather_readings(torch, mesh):
    """Phase 15 (a): the cost of one K/V gather at the fine batch's shape
    (10 latents x 1024 positions x 16 heads x 72, bf16) over the mesh's
    ``model`` dim: host microseconds a call (enqueue) and device
    microseconds a call (CUDA events over a loop), beside the copy into
    the dim-0-leading layout alone."""
    from repro_torch.parallel.collectives import all_gather_dim
    group = mesh.get_group("model")
    k = torch.randn((10, 1024, 16, 72), device="cuda").to(torch.bfloat16)
    reps = 200
    for label, fn in (("all_gather_dim", lambda: all_gather_dim(k, 1, group)),
                      ("movedim copy", lambda: k.movedim(1, 0).contiguous())):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        dev_ms = time_ms(fn, reps)
        print(f"  {label} of a {tuple(k.shape)} bf16 K: host {host_us:.1f} "
              f"us a call (enqueue), loop {dev_ms * 1e3:.1f} us a call "
              f"(CUDA events)", flush=True)


def model_parallel_phase(torch, ops, C, step, path_counts):
    """Phase 15: the model-parallel DiT and the mesh-sharded engine at one
    NCCL rank, the row-sharded body at full width, the flash forward at
    the shard shape, and the compressed data-parallel step at world size
    1 (module docstring).  Adds the main paths' launch counts to
    ``path_counts``."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.core.window import FixedBudget
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import init_process_group, make_srds_mesh
    from repro_torch.models import dit
    from repro_torch.parallel import collectives
    from repro_torch.runtime.profiling import window_launches

    t_start = time.perf_counter()
    s = dit_setup(torch)
    layers, B, S = s.cfg.num_layers, s.B, s.S
    early = C.SRDSConfig(num_blocks=B, per_sample=True, tol=EARLY_TOL)
    nudged = torch.nextafter(s.x_init, torch.full_like(s.x_init, np.inf))
    print(f"[{step}/15] the model-parallel DiT: srds-dit-sd2 (N={N_STEPS}, "
          f"B={B}, K={SAMPLES}, tol={EARLY_TOL}), DiT built in "
          f"{s.build_s:.1f} s", flush=True)

    # ---- (a) at one NCCL rank the mesh path is the plain path, bitwise
    with tempfile.TemporaryDirectory() as store:
        init_process_group(store, 0, 1, device_type="cuda")
        try:
            mesh = make_srds_mesh(1, 1, 1)
            den = dit.make_denoiser(s.model, shard_axis="model", mesh=mesh)
            ops.reset_launch_counts()
            ref_res, ref_wall = timed(torch, lambda: C.srds_sample(
                s.model_fn, s.sched, s.solver, s.x_init, early))
            ref_counts = ops.launch_counts()
            runs = {}
            for name, fn in (
                    ("mp_srds", lambda: C.srds_sample(
                        den, s.sched, s.solver, s.x_init, early)),
                    ("mp_sharded", lambda: make_sharded_sampler(
                        mesh, "time", den, s.sched, s.solver, early,
                        data_axis="data")(s.x_init))):
                g0 = collectives.all_gather_dim.calls
                ops.reset_launch_counts()
                res, wall = timed(torch, fn)
                counts = ops.launch_counts()
                check_tc_route(ops, counts, name, name)
                runs[name] = (res, wall, counts,
                              collectives.all_gather_dim.calls - g0)
            p = int(ref_res.iterations.max())
            want = dict(dict.fromkeys(ref_counts, 0),
                        flash_attention_fwd=layers * (B + p * (S + B)),
                        ddim_fused=B + p * (S + B),
                        parareal_update_residual=p * B)
            ctrl = C.srds_sample(den, s.sched, s.solver, nudged, early)
            for name, (res, wall, counts, gathers) in runs.items():
                same = _bitwise(torch, (res.sample, res.iterations),
                                (ref_res.sample, ref_res.iterations))
                print(f"  {name}: wall {wall:.3f} s (srds_sample "
                      f"{ref_wall:.3f} s), iterations "
                      f"{res.iterations.tolist()}, launches {counts}, "
                      f"all-gathers {gathers}; bitwise equal to the plain "
                      f"srds_sample: {same}", flush=True)
                if counts != want or ref_counts != want:
                    raise AssertionError(f"{name}: launches {counts}, plain "
                                         f"{ref_counts}, want {want}")
                if not same:
                    raise AssertionError(f"{name}: not bitwise equal to the "
                                         f"plain srds_sample")
                path_counts[name] = counts
            ctrl_same = torch.equal(ctrl.sample, ref_res.sample)
            print(f"  control (input moved by one ulp) bitwise equal: "
                  f"{ctrl_same}, must not be", flush=True)
            if ctrl_same:
                raise AssertionError("the bitwise check's control passed")
            # the engine over mesh, axis and data_axis against the plain
            # engine at its FixedBudget fallback
            g0 = collectives.all_gather_dim.calls
            ops.reset_launch_counts()
            served, serve_wall = timed(torch, lambda: _served(
                torch, C, den, s, mesh=mesh, axis="time", data_axis="data"))
            serve_counts = ops.launch_counts()
            serve_gathers = collectives.all_gather_dim.calls - g0
            check_tc_route(ops, serve_counts, "mp_serve", "mp_serve")
            plain, plain_wall = timed(torch, lambda: _served(
                torch, C, s.model_fn, s, window=FixedBudget()))
            same = all(a.iterations == b.iterations
                       and np.array_equal(a.sample, b.sample)
                       and np.array_equal(a.delta_history, b.delta_history)
                       for a, b in zip(served, plain))
            print(f"  served {SHARD_SERVED} requests (mesh, axis, "
                  f"data_axis): wall {serve_wall:.3f} s (plain engine "
                  f"{plain_wall:.3f} s), iterations "
                  f"{[r.iterations for r in served]}, launches "
                  f"{serve_counts}, all-gathers {serve_gathers}; bitwise "
                  f"equal to the plain engine: {same}", flush=True)
            if not same or min(serve_counts[k] for k in (
                    "flash_attention_fwd", "ddim_fused",
                    "parareal_update_residual")) == 0:
                raise AssertionError("the mesh engine differs from the "
                                     "plain engine, or skipped a kernel")
            path_counts["mp_serve"] = serve_counts
            # wall seconds in turns: plain, mesh, mesh, plain
            walls = {"plain": [], "mp": []}
            for name in ("plain", "mp", "mp", "plain"):
                fn = s.model_fn if name == "plain" else den
                walls[name].append(timed(torch, lambda: C.srds_sample(
                    fn, s.sched, s.solver, s.x_init, early))[1])
            print(f"  srds_sample wall seconds in turns: plain "
                  f"{walls['plain']}, mesh {walls['mp']}", flush=True)
            gather_readings(torch, mesh)
            # the device activity beside the port's kernels, from the
            # profiler: one srds_sample each way
            recs = {name: window_launches(fn, 1) for name, fn in (
                ("plain", lambda: C.srds_sample(s.model_fn, s.sched,
                                                s.solver, s.x_init, early)),
                ("mp", lambda: C.srds_sample(den, s.sched, s.solver,
                                             s.x_init, early)))}
            extra = {k[:60]: v[0] for k, v in recs["mp"]["device"].items()
                     if k not in recs["plain"]["device"]}
            kern = {k: port_kernel_records(v["device"])
                    for k, v in recs.items()}
            lost = {k: v["lead_lost"] + len(v["missing"])
                    for k, v in recs.items()}
            gathers = runs["mp_srds"][3]
            print(f"  device records (profiler): port kernels plain "
                  f"{kern['plain']}, mp {kern['mp']}; only the mp run has "
                  f"{extra} (its all-gathers counted {gathers}); records "
                  f"lost (lead and missing, C12) {lost}", flush=True)
            # each run's records of the port's kernels are the counters'
            # launches, short of them by no more than the records the
            # window lost; the mp run's only other activity is its NCCL
            # all-gathers, one record a gather
            for run_name, rec in kern.items():
                for kernel, counter in zip(PORT_KERNEL_NAMES, (
                        "ddim_fused", "parareal_update_residual",
                        "flash_attention_fwd", "parareal_update")):
                    got, counted = rec.get(kernel, 0), want.get(counter, 0)
                    if not counted - lost[run_name] <= got <= counted:
                        raise AssertionError(
                            f"{run_name}: {got} device records of {kernel}, "
                            f"{counted} launches counted, {lost[run_name]} "
                            f"records lost (C12)")
            nccl = sum(v for k, v in extra.items() if "nccl" in k.lower())
            # a copy, fill or kernel the mp run alone recorded is one the
            # plain window launched too where that window lost the record
            # of a call of its kind (ROADMAP C27: a pageable copy at the
            # start of srds_sample, its record lost in the plain window's
            # lead and kept in the mp window's)
            unrecorded = collections.Counter(
                api_kind(a) for a in recs["plain"]["missing_api"])
            other = {k: n for k, n in extra.items() if "nccl" not in k.lower()}
            unexplained = {k: n for k, n in other.items()
                           if n > unrecorded[record_kind(k)]}
            print(f"  the plain window's calls with no record, by kind: "
                  f"{dict(unrecorded)}; the mp run's other records "
                  f"{other}, unexplained {unexplained}", flush=True)
            if not (not unexplained
                    and gathers - lost["mp"] <= nccl <= gathers):
                raise AssertionError(f"the mp run's extra device activity "
                                     f"{extra}, {gathers} all-gathers "
                                     f"counted, {lost['mp']} records lost")

            # ---- (d) the compressed step at world size 1
            dp_phase(torch, ops, C, s, mesh, path_counts)
        finally:
            dist.destroy_process_group()

    # ---- (b) the row-sharded body at full width, f32, on the full K/V
    t = torch.tensor([300.0, 800.0], device="cuda")
    cfg32 = dataclasses.replace(s.cfg, dtype="float32")
    model32 = dit.load_jax_params(cfg32, s.tree, device="cuda")
    with torch.no_grad():
        kv, full = _capture_kv(dit, model32, s.x_init, t)
        worst, ctrl_best, locals_ = 0.0, float("inf"), []
        for m in SHARD_SPLITS:
            rows = s.x_init.shape[1] // m
            for r in range(m):
                got = _shard_forward(model32, s.x_init, t, r, m, kv, r,
                                     locals_)
                want = full[:, r * rows:(r + 1) * rows]
                worst = max(worst, rel_l2([got], [want]))
                if r:
                    ctrl = _shard_forward(model32, s.x_init, t, r, m, kv, 0)
                    ctrl_best = min(ctrl_best, rel_l2([ctrl], [want]))
    local_worst = max(v for v, _ in locals_)
    print(f"  row shards r of m in {SHARD_SPLITS} at full width (f32, fed "
          f"the full forward's K/V): output rows rel L2 <= {worst:.3e} "
          f"(limit {SHARD_REL_L2}), local K/V rel L2 <= {local_worst:.3e} "
          f"({sum(b for _, b in locals_)} of {len(locals_)} bitwise); "
          f"control (positions unshifted) >= {ctrl_best:.3e}, must miss "
          f"it", flush=True)
    if not (worst <= SHARD_REL_L2 and local_worst <= SHARD_REL_L2
            < ctrl_best):
        raise AssertionError(f"row-sharded body: rel L2 {worst}, local K/V "
                             f"{local_worst}, control {ctrl_best}")
    del model32, kv, full
    torch.cuda.empty_cache()

    # ---- (c) B3 at the shard shape on each layer's own inputs, bf16
    real_attention = ops.attention
    inputs = []

    def capture(q, k, v, **kw):
        inputs.append((q.detach().clone(), k.detach().clone(),
                       v.detach().clone()))
        return real_attention(q, k, v, **kw)

    with torch.no_grad():
        kv, _ = _capture_kv(dit, s.model, s.x_init, t)
        ops.attention = capture
        try:
            ops.reset_launch_counts()
            _shard_forward(s.model, s.x_init, t, 1, 2, kv, 1)
            counts = ops.launch_counts()
        finally:
            ops.attention = real_attention
    check_tc_route(ops, counts, "shard body", "shard_body")
    if counts["flash_attention_fwd"] != layers:
        raise AssertionError(f"shard body: {counts}")
    path_counts["shard_body"] = counts
    rels = []
    for q, k, v in inputs:
        got = ops.attention(q, k, v, causal=False)
        want, _ = ref.attention(q, k, v, causal=False)
        rels.append(rel_l2([got], [want]))
    print(f"  flash forward at the shard shape {tuple(inputs[0][0].shape)} "
          f"x {tuple(inputs[0][1].shape)} (bf16, tc) on each of {layers} "
          f"layers' inputs: rel L2 {min(rels):.3e} to {max(rels):.3e} "
          f"(limit {SHARD_FLASH_REL_L2}); launches in the shard body "
          f"{counts}", flush=True)
    if not max(rels) <= SHARD_FLASH_REL_L2:
        raise AssertionError(f"flash forward at the shard shape: rel L2 "
                             f"{max(rels)}")
    del s, kv, inputs
    torch.cuda.empty_cache()
    print(f"  phase 15: {time.perf_counter() - t_start:.1f} s", flush=True)


def dp_phase(torch, ops, C, s, mesh, path_counts):
    """Phase 15 (d): the compressed data-parallel step at world size 1 on
    phase 7's state (``launch.build`` from the same tree) and batch, with
    a zero carry: the mean is the gradient rounded to its quantum
    (``|mean - g| <= scale / 2`` elementwise) and the carry is ``g -
    mean``; a carry shifted by one quantum, the control, fails that.  Then
    one step through ``make_dp_train_step_compressed``: its loss the plain
    loss, its gradients the ones above, its parameters AdamW's update by
    the mean its collective returned, bitwise (the negated mean, the
    control, is not)."""
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.launch import train as launch
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.parallel import collectives
    from repro_torch.train import (diffusion_loss, init_error_feedback,
                                   make_dp_train_step_compressed)
    from repro_torch.train.steps import layer_scale_groups

    cfg, model, opt_state, _, _ = launch.build(
        s.cfg.name, lr=TRAIN_LR, total_steps=TRAIN_STEPS, params=s.tree,
        device="cuda")
    stream = make_stream(cfg, DataConfig(seed=SEED, global_batch=TRAIN_BATCH),
                         device="cuda")
    batch = stream.batch(0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    t = 999.0 * torch.rand((TRAIN_BATCH,), generator=g, device="cuda")
    eps = torch.randn(batch["images"].shape, generator=g, device="cuda")
    params = dict(model.named_parameters())
    loss, _ = diffusion_loss(model, batch, t=t, eps=eps)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    groups = layer_scale_groups(params)
    zero = init_error_feedback(model)
    mean, carry = collectives.compressed_psum_mean(
        grads, mesh.get_group("data"), zero, scale_groups=groups)
    scale = {}
    for k, gk in grads.items():
        sk = float(gk.float().abs().max()) / 127.0
        scale[groups[k]] = max(scale.get(groups[k], 0.0), sk)
    worst = max(float((mean[k] - gk.float()).abs().max())
                / scale[groups[k]] for k, gk in grads.items())
    exact = all(torch.equal(carry[k], gk.float() - mean[k])
                for k, gk in grads.items())
    shifted = any(torch.equal(carry[k] + scale[groups[k]],
                              gk.float() - mean[k])
                  for k, gk in grads.items())
    print(f"  compressed mean at world size 1 ({len(grads)} tensors, "
          f"{len(scale)} scales): max |mean - g| / scale {worst:.6f} "
          f"(limit 0.5, and 1e-5 of it for f32 rounding), carry == g - "
          f"mean: {exact}; control (carry shifted by one quantum) equal: "
          f"{shifted}, must not be", flush=True)
    if not (worst <= 0.5 * (1 + 1e-5) and exact and not shifted):
        raise AssertionError(f"compressed mean: |mean - g| / scale {worst}, "
                             f"carry exact {exact}, control {shifted}")
    del mean, carry
    # the step, its collective's operands and result kept
    real, seen = collectives.compressed_psum_mean, {}

    def kept(grads_in, group, ef_in, **kw):
        out = real(grads_in, group, ef_in, **kw)
        seen.update(grads=grads_in, mean=out[0])
        return out

    collectives.compressed_psum_mean = kept
    try:
        opt_cfg = AdamWConfig(lr=TRAIN_LR)
        step = make_dp_train_step_compressed(cfg, opt_cfg, mesh,
                                             axis="data")
    finally:
        collectives.compressed_psum_mean = real
    before = {k: p.detach().clone() for k, p in params.items()}
    opt_before = {"m": {k: v.clone() for k, v in opt_state["m"].items()},
                  "v": {k: v.clone() for k, v in opt_state["v"].items()},
                  "step": opt_state["step"].clone()}
    ops.reset_launch_counts()
    (_, _, ef, metrics), wall = timed(torch, lambda: step(
        model, opt_state, zero, batch, t=t, eps=eps))
    counts = ops.launch_counts()
    check_tc_route(ops, counts, "dp_compressed", "dp_compressed")
    grad_rel = rel_l2([seen["grads"][k] for k in grads],
                      list(grads.values()))
    del grads, seen["grads"]

    def applied(mean):
        """Whether the step's parameters are AdamW's update of the ones
        before it by ``mean``, bitwise."""
        ref_p = {k: v.clone() for k, v in before.items()}
        ref_opt = {"m": {k: v.clone() for k, v in opt_before["m"].items()},
                   "v": {k: v.clone() for k, v in opt_before["v"].items()},
                   "step": opt_before["step"].clone()}
        adamw_update(ref_p, mean, ref_opt, opt_cfg)
        return all(torch.equal(params[k], ref_p[k]) for k in params)

    same = applied(seen["mean"])
    negated = applied({k: -v for k, v in seen["mean"].items()})
    print(f"  compressed step: wall {wall:.3f} s, loss "
          f"{float(metrics['loss']):.6f} (the plain loss on the same draws "
          f"{float(loss.detach()):.6f}), its gradients against the ones "
          f"above rel L2 {grad_rel:.3e} (limit {DP_GRAD_REL_L2}), its "
          f"parameters AdamW's update by its mean bitwise: {same}; control "
          f"(the negated mean) bitwise: {negated}, must not be; launches "
          f"{counts}", flush=True)
    if not (float(metrics["loss"]) == float(loss.detach())
            and grad_rel <= DP_GRAD_REL_L2 and same and not negated
            and all(counts[k] == cfg.num_layers for k in
                    ("flash_attention_fwd",) + BWD_KERNELS)):
        raise AssertionError(f"compressed step: loss {metrics['loss']} vs "
                             f"{loss}, gradients rel L2 {grad_rel}, update "
                             f"applied {same}, control {negated}, launches "
                             f"{counts}")
    path_counts["dp_compressed"] = counts
    del model, opt_state, ef, before, opt_before, seen
    torch.cuda.empty_cache()


# phase 16: the tensor- and data-parallel language models at one NCCL rank
LMP_TRAIN_LAYERS = {"qwen3-8b": 8, "rwkv6-1.6b": 4, "hymba-1.5b": 4}
LMP_SERVE_LAYERS = {"qwen3-8b": None, "rwkv6-1.6b": 4, "hymba-1.5b": 4}
LMP_STEPS = {"qwen3-8b": 2, "rwkv6-1.6b": 1, "hymba-1.5b": 1}
DIGEST_CHUNK = 1 << 24


def digest(torch, t) -> int:
    """An exact integer digest of a tensor's bits: the sum of its words
    (as signed ints) weighted by their position mod a prime, in chunks."""
    w = t.detach().contiguous().view(-1)
    w = w.view(torch.int16 if w.element_size() == 2 else torch.int32)
    total = 0
    for start in range(0, w.numel(), DIGEST_CHUNK):
        part = w[start:start + DIGEST_CHUNK].long()
        idx = torch.arange(start, start + part.numel(), device=part.device)
        total += int((part * (idx % 1000003 + 1)).sum())
    return total


def state_digests(torch, model, opt):
    return {"params": {n: digest(torch, p)
                       for n, p in model.named_parameters()},
            "m": {n: digest(torch, t) for n, t in opt["m"].items()},
            "v": {n: digest(torch, t) for n, t in opt["v"].items()}}


def lmp_serve(torch, ops, tf, cfg, model, mesh, reqs, label):
    """Phase 16 (a)/(c): ``reqs`` through the plain engine and through
    ``ServingEngine(parallel=...)`` on the world-1 mesh (the same
    parameters), in turns: tokens and the last step's logits bitwise,
    launch counts equal, the collectives a prefill and a decode step
    issue, walls, and one decode step of each under
    ``profiling.window_launches``: the same launches counted, the port's
    kernels' records within the window's lost records of them, and the
    kernel names only the sharded step runs.  The one-ulp control: the plain prefill
    with the unembedding moved by one ulp misses the sharded prefill's
    logits.
    Returns the sharded run's launch counts."""
    import copy
    import numpy as np
    from repro_torch.parallel import collectives as coll
    from repro_torch.runtime.profiling import window_launches
    from repro_torch.serve import Request, ServingEngine
    plain = copy.copy(model)
    plain.parallel, plain.specs = tf.LOCAL, None
    max_seq = max(len(p) for p, _ in reqs) + max(m for _, m in reqs)
    runs = {}

    def serve(m, key):
        eng = ServingEngine(cfg, m, batch_size=len(reqs), max_seq=max_seq)
        seen = {"calls": []}
        dec, pre = eng._decode, eng._prefill

        def prefill(*a):
            c0 = sum(coll.CALLS.values())
            out = pre(*a)
            seen["calls"].append(("prefill", sum(coll.CALLS.values()) - c0))
            return out

        def decode(*a):
            c0 = sum(coll.CALLS.values())
            out = dec(*a)
            seen["calls"].append(("decode", sum(coll.CALLS.values()) - c0))
            seen["logits"] = out[0]
            return out

        eng._prefill, eng._decode = prefill, decode
        ops.reset_launch_counts()
        outs, wall = timed(torch, lambda: eng.generate(
            [Request(prompt=p, max_new_tokens=n) for p, n in reqs]))
        runs.setdefault(key, []).append(dict(
            outs=outs, wall=wall, counts=ops.launch_counts(),
            logits=seen["logits"], calls=seen["calls"]))

    for key in ("plain", "mesh", "mesh", "plain"):
        serve(plain if key == "plain" else model, key)
    p, m = runs["plain"][0], runs["mesh"][0]
    same = p["outs"] == m["outs"] and torch.equal(p["logits"], m["logits"])
    pre = [c for k, c in m["calls"] if k == "prefill"]
    dec = sorted(set(c for k, c in m["calls"] if k == "decode"))
    walls = [r["wall"] for k in ("plain", "mesh") for r in runs[k]]
    print(f"  {label} served: tokens and last logits bitwise the plain "
          f"engine's: {same}; launches {m['counts']} (plain "
          f"{p['counts']}); collectives a prefill {pre}, a decode step "
          f"{dec}; wall in turns plain/mesh/mesh/plain "
          f"{walls[0]:.3f}/{walls[2]:.3f}/{walls[3]:.3f}/{walls[1]:.3f} s",
          flush=True)
    if not same or m["counts"] != p["counts"]:
        raise AssertionError(f"{label}: the world-1 mesh engine is not the "
                             f"plain engine (tokens/logits {same}, launches "
                             f"{m['counts']} vs {p['counts']})")
    # one decode step of each under the profiler
    plen = max(len(q) for q, _ in reqs)
    toks = torch.zeros((len(reqs), plen), dtype=torch.long)
    for i, (q, _) in enumerate(reqs):
        toks[i, plen - len(q):] = torch.from_numpy(q)
    batch = {"tokens": toks.cuda()}
    names, lost, counted = {}, {}, {}
    for key, mm in (("plain", plain), ("mesh", model)):
        logits, cache = tf.prefill(cfg, mm, batch, cache_len=plen + 1)
        tok = {"tokens": logits.argmax(-1)[:, None]}
        ops.reset_launch_counts()
        rec = window_launches(lambda: tf.decode_step(cfg, mm, tok, cache,
                                                     plen), 1)
        counted[key] = {k: n for k, n in ops.launch_counts().items() if n}
        names[key] = rec["device"]
        lost[key] = rec["lead_lost"] + len(rec["missing"])
        if key == "mesh":
            mesh_logits = logits
    port = {k: {n: c for n, (c, _) in v.items() if "flash" in n
                or "scan" in n or "wkv" in n} for k, v in names.items()}
    extra = sorted(set(names["mesh"]) - set(names["plain"]))
    print(f"  {label}, one decode step: launches counted plain "
          f"{counted['plain']}, mesh {counted['mesh']}; the port's kernels' "
          f"device records plain {port['plain']}, mesh {port['mesh']}, "
          f"records lost (lead and missing, C12) {lost}; kernels only the "
          f"mesh step runs: "
          + ", ".join(f"{KERNEL_NAME.search(n).group(1) if KERNEL_NAME.search(n) else n[:60]} x{names['mesh'][n][0]}"
                      for n in extra), flush=True)
    # the two steps count the same launches, and each step's records of
    # the port's kernels are its launches short of them by no more than
    # the records its window lost
    if counted["plain"] != counted["mesh"] or any(
            not sum(counted[k].values()) - lost[k]
            <= sum(port[k].values()) <= sum(counted[k].values())
            for k in counted):
        raise AssertionError(f"{label}: the decode steps' kernel launches "
                             f"differ")
    w = plain["unembed"]["w"]
    keep = w.detach().clone()
    with torch.no_grad():
        w.copy_(torch.nextafter(w, torch.full_like(w, np.inf)))
        ctrl, _ = tf.prefill(cfg, plain, batch)
        w.copy_(keep)
    hit = torch.equal(ctrl, mesh_logits)
    print(f"  control, the plain prefill with the unembedding one ulp up, "
          f"bitwise the mesh prefill's logits: {hit}, must not be",
          flush=True)
    if hit:
        raise AssertionError(f"{label}: the bitwise check's control passed")
    return m["counts"]


def lmp_train(torch, ops, arch, mesh, stream_batch):
    """Phase 16 (b)/(c): ``LMP_STEPS[arch]`` steps of the plain step and of
    ``launch.train.build_on_mesh``'s (``sp``, ZeRO-1) at the world-1 mesh,
    one after the other from seed 0: the loss and grad norm of every step
    and a digest of every parameter and moment after each, bitwise (the
    moments after a step carry its clipped gradient), launch counts
    equal.  Returns the sharded run's launch counts."""
    from repro_torch.launch.train import build_on_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.parallel import collectives as coll
    from repro_torch.train import make_train_step
    layers, steps = LMP_TRAIN_LAYERS[arch], LMP_STEPS[arch]
    out = {}
    for key in ("plain", "mesh"):
        t0 = time.perf_counter()
        if key == "mesh":
            cfg, model, opt, step, _ = build_on_mesh(
                arch, mesh, total_steps=100, layers=layers, device="cuda")
        else:
            import dataclasses
            from repro_torch.configs import get_arch
            cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
            model = tf.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda",
                                   trainable=True)
            opt = init_opt_state(dict(model.named_parameters()))
            step = make_train_step(cfg, AdamWConfig(
                lr=3e-4, schedule=warmup_cosine(3e-4, 10, 100)),
                loss_kind="lm")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        c0 = sum(coll.CALLS.values())
        metrics, digests, walls = [], [], []
        for i in range(steps):
            b = stream_batch(cfg, i)
            (model, opt, m), wall = timed(torch, lambda: step(model, opt, b))
            walls.append(wall)
            metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
            digests.append(state_digests(torch, model, opt))
        out[key] = dict(metrics=metrics, digests=digests, walls=walls,
                        counts=ops.launch_counts(), build_s=build_s,
                        calls=(sum(coll.CALLS.values()) - c0) / steps)
        del model, opt, step
        torch.cuda.empty_cache()
    p, m = out["plain"], out["mesh"]
    same_m = all(torch.equal(a, b) for x, y in zip(p["metrics"], m["metrics"])
                 for a, b in zip(x, y))
    same_d = p["digests"] == m["digests"]
    print(f"  {arch} trained ({layers} layers, {steps} step(s) at "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}): loss/grad norm "
          + ", ".join(f"{float(a):.6f}/{float(b):.6f}" for a, b in
                      m["metrics"])
          + f" bitwise the plain step's: {same_m}; every parameter and "
          f"moment after each step bitwise (digests): {same_d}; launches "
          f"{m['counts']} (plain {p['counts']}); collectives a step "
          f"{m['calls']:.0f}; step walls plain "
          + "/".join(f"{w:.3f}" for w in p["walls"]) + " s, mesh "
          + "/".join(f"{w:.3f}" for w in m["walls"])
          + f" s; built in {p['build_s']:.1f}/{m['build_s']:.1f} s",
          flush=True)
    if not (same_m and same_d and m["counts"] == p["counts"]):
        raise AssertionError(f"{arch}: the world-1 sharded step is not the "
                             f"plain step")
    return m["counts"]


def shard_kernel_rows(torch, ops, ref, rows):
    """Phase 16 (d): the kernels at the shapes one rank of a ``model`` 2
    or 16 mesh hands them, each against its twin within phase 3's limits,
    with ms, plain ms, the bound and (flash rows) SDPA's time: B3's causal
    GQA form at qwen3-8b's local heads (batch 4, S 2048, D 128), its
    window form at hymba-1.5b's (m 16: 2 local of 32/8 padded heads, one
    KV head; m 2: 13 local of 26/13, K/V repeated to them), WKV at 16 and
    2 heads, the scan at d_inner 800 and 100 (B 4, T 2048), and at m 2
    the backward's dq/dkv at qwen3's training heads and the scan backward
    at d_inner 800 (B 2)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan
    from repro_torch.kernels import selective_scan as scan
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def flash(name, m, b, hq, hkv, d, window):
        tdt = torch.bfloat16
        q = randn((b, hq, 2048, d), tdt)
        k, v = randn((b, hkv, 2048, d), tdt), randn((b, hkv, 2048, d), tdt)
        mask = dict(causal=True, window=window)
        got = ops.attention(q, k, v, **mask)
        want, _ = ref.attention(q, k, v, **mask)
        keep = ref._keep(2048, 2048, True, window, q.device)
        b_ms, b_by = bound(nbytes(q, k, v, got) + 4 * b * hq * 2048,
                           4.0 * b * hq * int(keep.sum()) * d, "bfloat16")
        kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        sdpa = dict(is_causal=True) if window is None else dict(
            attn_mask=keep)
        timing = dict(ms=time_ms(lambda: ops.attention(q, k, v, **mask), 10),
                      plain_ms=time_ms(lambda: ops.attention(
                          q, k, v, **mask, use_kernel=False), 2),
                      bound_ms=b_ms, bound_by=b_by,
                      library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                          q, kx, vx, **sdpa), 10))
        rel, lim = rel_l2([got], [want]), MASKED_REL_L2["bfloat16"]
        rows.append(dict(name=name, model=m, **check_case(
            f"{name} (model {m}) bf16 BH={b * hq} BKV={b * hkv} S=2048 D={d}"
            f" ({route_label(fa, tdt, d)}; rel L2 {rel:.3e}, limit {lim})",
            got, want, *MASKED_TOL["bfloat16"], timing)))
        if not rel <= lim:
            raise AssertionError(f"{name} at model {m}: rel L2 {rel}")

    flash("flash_attention_fwd_causal_gqa", 2, 4, 16, 4, 128, None)
    flash("flash_attention_fwd_causal_gqa", 16, 4, 2, 1, 128, None)
    flash("flash_attention_fwd_window", 16, 4, 2, 1, 64, 1024)
    flash("flash_attention_fwd_window", 2, 4, 13, 13, 64, 1024)
    for m, h in ((16, 2), (2, 16)):
        r, k, v, w, u, s0 = wkv_inputs(torch, randn, 4, h, 2048, 64, 64,
                                       "bfloat16", True, False)
        got, s_t, _ = rwkv6_scan.rwkv6_wkv(r, k, v, w, u, s0)
        want, s_r = ref.rwkv6_wkv(r, k, v, w, u, s0)
        rel = rel_l2([got], [want])
        b_ms, b_by = bound(nbytes(r, k, v, w, u, s0, got, s_t),
                           4 * h * 2048 * (5.0 * 64 * 64 + 5 * 64),
                           "float32")
        timing = dict(ms=time_ms(lambda: rwkv6_scan.rwkv6_wkv(
            r, k, v, w, u, s0), 20), plain_ms=time_ms(
            lambda: ref.rwkv6_wkv(r, k, v, w, u, s0), 1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        rows.append(dict(name="rwkv6_wkv", model=m, **check_case(
            f"rwkv6_wkv (model {m}) bf16 B=4 H={h} T=2048 D=64 (rel L2 "
            f"{rel:.3e}, limit {WKV_REL_L2})", got, want, 2e-2, 2e-2,
            timing)))
        if not rel <= WKV_REL_L2:
            raise AssertionError(f"rwkv6_wkv at model {m}: rel L2 {rel}")
    for m, din in ((2, 800), (16, 100)):
        x = scan_inputs(torch, randn, 4, 2048, din, 16, True)
        y, h_t, _ = scan.selective_scan(*x)
        y_r, h_r = ref.selective_scan(*x)
        rel = max(rel_l2([y], [y_r]), rel_l2([h_t], [h_r]))
        b_ms, b_by = scan_bound(4, 2048, din, 16, nbytes(*x, y, h_t))
        timing = dict(ms=time_ms(lambda: scan.selective_scan(*x), 20),
                      plain_ms=time_ms(lambda: ref.selective_scan(*x), 1),
                      bound_ms=b_ms, bound_by=b_by, library_ms=None)
        rows.append(dict(name="selective_scan", model=m, **check_case(
            f"selective_scan (model {m}) f32 B=4 T=2048 din={din} n=16 "
            f"(grid {scan.geometry(4, din, 16).grid}; rel L2 {rel:.3e}, "
            f"limit {SCAN_REL_L2})",
            torch.cat([y.flatten(), h_t.flatten()]),
            torch.cat([y_r.flatten(), h_r.flatten()]), SCAN_TOL, SCAN_TOL,
            timing)))
        if not rel <= SCAN_REL_L2:
            raise AssertionError(f"selective_scan at model {m}: rel L2 {rel}")
    # model 2 only: the backward at qwen3's training heads and the scan's
    b, hq, hkv, d = 2, 16, 4, 128
    tdt = torch.bfloat16
    q, do = (randn((b, hq, 2048, d), tdt) for _ in range(2))
    k, v = (randn((b, hkv, 2048, d), tdt) for _ in range(2))
    q3, do3 = (x.reshape(b * hq, 2048, d) for x in (q, do))
    k3, v3 = (x.reshape(b * hkv, 2048, d) for x in (k, v))
    o3, lse = fa.flash_attention_fwd(q3, k3, v3, causal=True)
    delta = (do3.float() * o3.float()).sum(dim=-1)
    want = ref.attention_bwd(q, k, v, o3.view(q.shape), lse.view(b, hq, 2048),
                             do, causal=True)
    live = 2048 * 2049 // 2
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, kx, vx))
    sd = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    library_ms = time_ms(lambda: torch.autograd.grad(
        sd, (qg, kg, vg), do, retain_graph=True), 5)
    plain_ms = time_ms(lambda: ref.attention_bwd(
        q, k, v, o3.view(q.shape), lse.view(b, hq, 2048), do, causal=True), 2)
    for name, fn, ref_out, flops in (
            ("flash_attention_bwd_dq_causal_gqa", lambda: (
                fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta,
                                          d ** -0.5, causal=True),),
             want[:1], 6.0),
            ("flash_attention_bwd_dkv_causal_gqa", lambda: (
                fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                           d ** -0.5, causal=True)),
             want[1:], 8.0)):
        got = fn()
        b_ms, b_by = bound(nbytes(q, k, v, do, lse, delta) + nbytes(*got),
                           flops * b * hq * live * d, "bfloat16")
        rel = bwd_rel_l2(torch, fn, got, ref_out, f"{name} model 2")
        timing = dict(ms=time_ms(fn, 5), plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=library_ms)
        rows.append(dict(name=name, model=2, **check_case(
            f"{name} (model 2) bf16 BH={b * hq} BKV={b * hkv} S=2048 D={d} "
            f"(rel L2 {rel:.3e}, limit {BWD_MASKED_REL_L2['bfloat16']})",
            torch.cat([x.reshape(-1) for x in got]),
            torch.cat([x.reshape(-1) for x in ref_out]), BWD_BF16_ATOL,
            BWD_BF16_RTOL, timing)))
    del qg, kg, vg, sd, want
    x = scan_inputs(torch, randn, 2, 2048, 800, 16, True)
    dy = randn((2, 2048, 800))
    _, _, ckpt = scan.selective_scan(*x, checkpoints=True)
    segments = scan.bwd_geometry(2, 2048, 800, 16).segments
    got = scan.selective_scan_bwd(*x[:6], ckpt, dy, None)
    want = ref.selective_scan_bwd(*x, dy, None, segments=segments)
    rel = max(rel_l2([a], [c]) for a, c in zip(got, want))
    b_ms, b_by = scan_bwd_bound(2, 2048, 800, 16, nbytes(*x[:6], ckpt, dy,
                                                         *got))
    timing = dict(ms=time_ms(lambda: scan.selective_scan_bwd(
        *x[:6], ckpt, dy, None), 20), plain_ms=time_ms(
        lambda: ref.selective_scan_bwd(*x, dy, None, segments=segments), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    flat = [torch.cat([t.reshape(-1) for t in ts]) for ts in (got, want)]
    rows.append(dict(name="selective_scan_bwd", model=2, **check_case(
        f"selective_scan_bwd (model 2) f32 B=2 T=2048 din=800 n=16 "
        f"({segments} segments; rel L2 {rel:.3e}, limit {SCAN_BWD_REL_L2})",
        *flat, 1e-3 * flat[1].abs().max().item(), 1e-3, timing)))
    if not rel <= SCAN_BWD_REL_L2:
        raise AssertionError(f"selective_scan_bwd at model 2: rel L2 {rel}")


def lm_parallel_phase(torch, ops, step):
    """Phase 16: the tensor-, sequence- and data-parallel language models
    at one NCCL rank (module docstring).  Returns ``(path counts, kernel
    rows)``."""
    import dataclasses
    import tempfile
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import init_process_group, make_test_mesh
    from repro_torch.models import transformer as tf

    t_start = time.perf_counter()
    print(f"[{step}/16] the tensor- and data-parallel LMs at one NCCL rank, "
          f"mesh (data 1, model 1)", flush=True)
    counts = {}
    with tempfile.TemporaryDirectory() as store:
        init_process_group(store, 0, 1, device_type="cuda")
        try:
            mesh = make_test_mesh((1, 1), device_type="cuda")
            ctx = tf.ParallelCtx(mesh=mesh)

            def stream_batch(cfg, i):
                return make_stream(cfg, DataConfig(
                    global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ),
                    device="cuda", mesh=mesh).batch(i)

            for arch in ("qwen3-8b", "rwkv6-1.6b", "hymba-1.5b"):
                cfg = get_arch(arch)
                if LMP_SERVE_LAYERS[arch]:
                    cfg = dataclasses.replace(
                        cfg, num_layers=LMP_SERVE_LAYERS[arch])
                t0 = time.perf_counter()
                model = tf.init_params(cfg, torch.Generator(
                    device="cuda").manual_seed(SEED), device="cuda",
                    parallel=ctx)
                torch.cuda.synchronize()
                print(f"  {arch}: {cfg.num_layers} layers at full width "
                      f"drawn on the card in {time.perf_counter() - t0:.1f}"
                      f" s", flush=True)
                reqs = lm_requests(np, min(LM_TOKEN_IDS, cfg.vocab_size))
                counts[f"serve_{arch}"] = lmp_serve(torch, ops, tf, cfg,
                                                    model, mesh, reqs, arch)
                del model
                torch.cuda.empty_cache()
                counts[f"train_{arch}"] = lmp_train(torch, ops, arch, mesh,
                                                    stream_batch)
                torch.cuda.empty_cache()
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    rows = []
    shard_kernel_rows(torch, ops, ref, rows)
    torch.cuda.empty_cache()
    print(f"  phase {step}: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return counts, rows


# --------------------------------------------------------------------------
# phases 17-18: the rest of the LM zoo
# --------------------------------------------------------------------------

def moe_reference_f32(torch, p, x, top_k, act, swap=None):
    """The MoE layer in f32 as a loop over its experts (a plain yardstick,
    its routing its own: the router's softmax, the top k, the weights
    renormalised over them; each expert's weights cast to f32 in turn,
    its tokens gathered on the host's count): x (T, d).  ``swap`` (token,
    expert): that token's top expert replaced, the control.  Returns
    ``(out (T, d), top_i (T, k))``."""
    import torch.nn.functional as F
    xf = x.float()
    probs = torch.softmax(xf @ p["router"].float(), dim=-1)
    top_v, top_i = torch.topk(probs, top_k, dim=-1)
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    if swap is not None:
        t, e = swap
        top_i = top_i.clone()
        top_i[t, 0] = e
    out = torch.zeros_like(xf)
    for e in torch.unique(top_i).tolist():
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        xs = xf[tok]
        if act == "swiglu":
            h = F.silu(xs @ p["w_gate"][e].float()) * (xs @ p["w_up"][e]
                                                       .float())
        else:
            h = F.gelu(xs @ p["w_up"][e].float(), approximate="tanh")
        out.index_add_(0, tok, (h @ p["w_down"][e].float())
                       * top_v[tok, slot][:, None])
    return out, top_i


def per_token_rel(torch, got, want) -> float:
    """The largest per-token relative L2 error over the rows."""
    num = (got.float() - want.float()).norm(dim=-1)
    return (num / want.float().norm(dim=-1).clamp(min=1e-30)).max().item()


def moe_layer_bound(cfg, x_rows, top_i):
    """The least time of one MoE layer's grouped FFN (its three grouped
    matmuls and the combine) on this run's routing: the FLOPs of its
    assignments at the bf16 peak, or the bytes of the experts it reads
    (each used expert's three matrices) plus the rows in and out at the
    HBM rate, whichever is larger."""
    import torch
    d, f = cfg.d_model, cfg.moe_d_ff
    a = top_i.numel()
    used = int(torch.unique(top_i).numel())
    mats = 3 if cfg.act == "swiglu" else 2
    flops = 2.0 * a * d * f * mats
    byts = used * mats * d * f * 2 + 2 * x_rows * d * 2 + a * 4
    return bound(byts, flops, "bfloat16") + (used,)


def moe_serve(torch, ops, arch, mesh):
    """Phase 17 (a)/(b): ``arch`` at ``MOE_SERVE_LAYERS[arch]`` layers,
    full width, every expert, serving phase 8's requests through
    ``ServingEngine`` plain and with ``use_ep`` on the world-1 mesh (the
    same parameters).  Returns the plain run's launch counts."""
    import dataclasses
    import warnings
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import collectives as coll
    cfg = dataclasses.replace(get_arch(arch),
                              num_layers=MOE_SERVE_LAYERS[arch])
    t0 = time.perf_counter()
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    ctx = tf.ParallelCtx(mesh=mesh, use_ep=True)
    ep_model = tf.TransformerLM(cfg, device="meta", parallel=ctx)
    ep_model.load_state_dict(model.state_dict(), assign=True)
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.num_layers} of {get_arch(arch).num_layers} "
          f"layers, d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads of {cfg.resolved_head_dim}, {cfg.moe_experts} experts "
          f"(top {cfg.moe_top_k}, d_ff {cfg.moe_d_ff}, dense residual "
          f"{cfg.moe_dense_residual}), {tf.param_count(model) / 1e9:.3f} B "
          f"params drawn on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    reqs = lm_requests(np, min(LM_TOKEN_IDS, cfg.vocab_size))
    # a warm-up prefill: the first grouped matmuls of the process load
    # their kernels (an H100 run read 487 ms for kimi's first MoE layer,
    # 137 ms warm)
    tf.prefill(cfg, model, {"tokens": torch.zeros((1, 64), dtype=torch.long,
                                                  device="cuda")})
    routes, layer_io, timings = [], [], []
    real_route, real_apply = moe.route, tf._apply_moe

    def recording_route(router_w, x_flat, top_k):
        out = real_route(router_w, x_flat, top_k)
        routes.append(out[1])
        return out

    def timed_apply(cfg_, p, h, parallel, tp):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_apply(cfg_, p, h, parallel, tp)
        end.record()
        timings.append((start, end, h.shape[0] * h.shape[1]))
        if len(layer_io) < 1:
            layer_io.append((p, h.detach().clone(), out[0].detach().clone()))
        return out

    results = {}
    for key, m in (("plain", model), ("ep", ep_model)):
        routes.clear()
        layer_io.clear()
        timings.clear()
        moe.route, tf._apply_moe = recording_route, timed_apply
        coll.reset_calls()
        try:
            counts, calls, outs = serve_lm(torch, ops, cfg, m, reqs,
                                           f"{arch} {key}", return_outs=True)
        finally:
            moe.route, tf._apply_moe = real_route, real_apply
        torch.cuda.synchronize()
        per_call = [s.elapsed_time(e) for s, e, _ in timings]
        results[key] = dict(counts=counts, outs=outs, top_i=routes[0],
                            a2a=coll.CALLS["all_to_all"], calls=calls,
                            moe_ms=per_call, io=layer_io[0],
                            rows=[r for _, _, r in timings],
                            peak=torch.cuda.max_memory_allocated() / 1e9)
        check_launches(f"{arch} {key}", counts, calls,
                       {"flash_attention_fwd": (cfg.num_layers, 0)})
    p_, e_ = results["plain"], results["ep"]
    steps = len(p_["calls"]) - 1
    same_top = torch.equal(p_["top_i"], e_["top_i"])
    print(f"  tokens plain vs use_ep (world-1 mesh) equal: "
          f"{p_['outs'] == e_['outs']}; the prefill's top-{cfg.moe_top_k} "
          f"ids equal: {same_top}; all-to-alls: plain {p_['a2a']}, use_ep "
          f"{e_['a2a']} (3 a layer a call: {3 * cfg.num_layers} x "
          f"{steps + 1}); peak memory plain {p_['peak']:.2f} GB, use_ep "
          f"{e_['peak']:.2f} GB", flush=True)
    if p_["outs"] != e_["outs"] or not same_top or p_["a2a"] != 0 \
            or e_["a2a"] != 3 * cfg.num_layers * (steps + 1):
        raise AssertionError(f"{arch}: the use_ep engine is not the plain "
                             f"engine")
    # each MoE layer's device time against its bound, prefill and decode
    n = cfg.num_layers
    for key in ("plain", "ep"):
        r = results[key]
        pre, dec = r["moe_ms"][:n], r["moe_ms"][n:2 * n]
        b_pre = moe_layer_bound(cfg, r["rows"][0], r["top_i"])
        print(f"  MoE layer device ms ({key}): prefill "
              + "/".join(f"{x:.3f}" for x in pre)
              + f" (bound {b_pre[0]:.3f} ms by {b_pre[1]}, {b_pre[2]} "
              f"experts used), decode step 1 "
              + "/".join(f"{x:.3f}" for x in dec), flush=True)
    # host syncs of one decode step (sync debug mode), both paths
    plen = max(LM_PROMPTS)
    toks = torch.zeros((len(reqs), plen), dtype=torch.long)
    for i, (pr, _) in enumerate(reqs):
        toks[i, plen - len(pr):] = torch.from_numpy(pr)
    batch = {"tokens": toks.cuda()}
    syncs = {}
    for key, m in (("plain", model), ("ep", ep_model)):
        logits, cache = tf.prefill(cfg, m, batch, cache_len=plen + 1)
        tok = logits[:, :cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tf.decode_step(cfg, m, {"tokens": tok}, cache, plen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[key] = sum(SYNC_WARNING in str(w.message) for w in caught)
        del cache, logits
    print(f"  host syncs of one decode step (sync debug mode): plain "
          f"{syncs['plain']}, use_ep {syncs['ep']}", flush=True)
    for key, m in (("plain", model), ("ep", ep_model)):
        profile_reading(torch, f"{key} prefill ({len(reqs)} x {plen} "
                        f"tokens)", lambda: tf.prefill(cfg, m, batch))
    # the first MoE layer's output on its own prefill inputs against the
    # f32 loop over experts; one token's top expert swapped must miss
    p, h, out = p_["io"]
    x = h.reshape(-1, cfg.d_model)
    want, ref_i = moe_reference_f32(torch, p, x, cfg.moe_top_k, cfg.act)
    got = out.reshape(-1, cfg.d_model)
    rel = per_token_rel(torch, got, want)
    # the program's chosen experts (the plain prefill's, layer 0) against
    # the yardstick's, as sets: tokens whose sets differ
    id_diff = int((p_["top_i"].sort(dim=-1).values
                   != ref_i.sort(dim=-1).values).any(dim=-1).sum())
    other = next(e for e in range(cfg.moe_experts) if e not in ref_i[0])
    ctrl, _ = moe_reference_f32(torch, p, x, cfg.moe_top_k, cfg.act,
                                swap=(0, other))
    rel_c = per_token_rel(torch, got, ctrl)
    print(f"  MoE layer 0 on its prefill inputs ({x.shape[0]} tokens, bf16)"
          f" vs the f32 loop over experts with its own routing: tokens "
          f"whose top-{cfg.moe_top_k} experts differ {id_diff}; largest "
          f"per-token rel L2 {rel:.3e} (limit {MOE_LAYER_REL}); control, "
          f"token 0's top expert swapped: {rel_c:.3e}, must miss it",
          flush=True)
    if id_diff or not rel <= MOE_LAYER_REL or not rel_c > MOE_LAYER_REL:
        raise AssertionError(f"{arch}: the MoE layer check failed ({id_diff}"
                             f" tokens routed otherwise, {rel}, control "
                             f"{rel_c})")
    del model, ep_model, results, p_, e_, p, h, out, want, got, ctrl
    torch.cuda.empty_cache()
    return counts


def moe_train(torch, ops, mesh):
    """Phase 17 (c): arctic-480b at 1 layer with ``MOE_TRAIN_EXPERTS`` of
    its 128 experts (widths kept), ``MOE_TRAIN_STEPS`` steps at 2 x 2048
    through ``launch.train.build_on_mesh`` (``use_ep``, ``sp``, ZeRO-1, on
    the world-1 mesh) and through the plain step from the same seed: the
    loss, aux and grad norm of each step and every parameter after each
    bitwise (ROADMAP C24), and the flash launches equal; the control, the
    plain step with the router's gradient zeroed, must miss the same
    check.  Returns the mesh run's launch counts."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.launch.train import build_on_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.train import make_train_step
    arch, lr = "arctic-480b", 3e-4
    cfg = dataclasses.replace(get_arch(arch), num_layers=1,
                              moe_experts=MOE_TRAIN_EXPERTS)
    stream = make_stream(cfg, DataConfig(seed=SEED,
                                         global_batch=LM_TRAIN_BATCH,
                                         seq_len=LM_TRAIN_SEQ),
                         device="cuda")
    out = {}
    for key in ("plain", "mesh", "control"):
        if key == "mesh":
            _, model, opt, step, _ = build_on_mesh(
                arch, mesh, lr=lr, total_steps=100, layers=1,
                experts=MOE_TRAIN_EXPERTS, device="cuda")
        else:
            model = tf.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0), device="cuda",
                                   trainable=True)
            opt = init_opt_state(dict(model.named_parameters()))
            step = make_train_step(cfg, AdamWConfig(
                lr=lr, schedule=warmup_cosine(lr, 10, 100)), loss_kind="lm")
            if key == "control":
                model.blocks[0]["moe"]["router"].register_hook(
                    torch.zeros_like)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        metrics, params, walls = [], [], []
        for i in range(MOE_TRAIN_STEPS):
            b = stream.batch(i)
            (model, opt, m), wall = timed(torch, lambda: step(model, opt, b))
            walls.append(wall)
            metrics.append([m[k].item() for k in ("loss", "aux",
                                                  "grad_norm")])
            params.append({n: p.detach().clone() for n, p in
                           model.named_parameters()})
        out[key] = dict(metrics=metrics, params=params, walls=walls,
                        counts=ops.launch_counts(),
                        peak=torch.cuda.max_memory_allocated() / 1e9,
                        n=tf.param_count(model))
        del model, opt, step
        torch.cuda.empty_cache()
    p, m, c = out["plain"], out["mesh"], out["control"]

    def bitwise(a):
        return a["metrics"] == p["metrics"] and all(
            torch.equal(x[k], y[k]) for x, y in zip(a["params"], p["params"])
            for k in x)

    def apart(a):
        return max(max((x[k].float() - y[k].float()).abs().max().item()
                       for k in x) for x, y in zip(a["params"], p["params"]))

    same, same_c = bitwise(m), bitwise(c)
    print(f"  arctic-480b trained (1 layer, {MOE_TRAIN_EXPERTS} of 128 "
          f"experts, {p['n'] / 1e9:.3f} B params, {MOE_TRAIN_STEPS} steps "
          f"at {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}): loss/aux/grad norm mesh "
          + ", ".join("/".join(f"{x:.6f}" for x in r) for r in m["metrics"])
          + ", plain " + ", ".join("/".join(f"{x:.6f}" for x in r)
                                   for r in p["metrics"])
          + f"; metrics and every parameter bitwise: {same} (largest "
          f"difference {apart(m):.3e}); control, the router's gradient "
          f"zeroed: bitwise {same_c} (largest difference {apart(c):.3e}), "
          f"must not be; launches mesh {m['counts']}, plain {p['counts']}; "
          f"step walls plain " + "/".join(f"{w:.3f}" for w in p["walls"])
          + " s, mesh " + "/".join(f"{w:.3f}" for w in m["walls"])
          + f" s; peak memory {p['peak']:.2f}/{m['peak']:.2f} GB",
          flush=True)
    if m["counts"] != p["counts"] or not same or same_c:
        raise AssertionError("arctic-480b: the world-1 EP step is not the "
                             "plain step bitwise, or its control passed")
    return m["counts"]


def moe_phase(torch, ops, step):
    """Phase 17: the MoE models at one NCCL rank (module docstring).
    Returns the launch counts by path."""
    import tempfile
    from repro_torch.launch.mesh import init_process_group, make_test_mesh
    t_start = time.perf_counter()
    print(f"[{step}/18] the MoE models: kimi-k2-1t-a32b and arctic-480b "
          f"served plain and with use_ep at one NCCL rank, arctic-480b "
          f"trained", flush=True)
    counts = {}
    with tempfile.TemporaryDirectory() as store:
        init_process_group(store, 0, 1, device_type="cuda")
        try:
            mesh = make_test_mesh((1, 1), device_type="cuda")
            for arch in ("kimi-k2-1t-a32b", "arctic-480b"):
                counts[f"serve_{arch}"] = moe_serve(torch, ops, arch, mesh)
            counts["train_arctic-480b"] = moe_train(torch, ops, mesh)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    print(f"  phase {step}: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return counts


def vlm_serve(torch, ops):
    """Phase 18 (d), serving: phi-3-vision-4.2b at full depth, a prefill of
    ``VLM_PROMPT`` positions whose first 576 hold image embeddings, then
    ``VLM_DECODE`` greedy decode steps (launch counts: the flash forward
    once a layer in the prefill, never in a decode step); decode step 1
    against ``forward_train`` over the prompt and the first token (phase
    8's check 2), and the prefill without its image embeddings as the
    control that must miss it.  Returns the launch counts."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = get_arch("phi-3-vision-4.2b")
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 18)
    b, s, npx = 2, VLM_PROMPT, cfg.num_prefix_embeds
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device="cuda"),
             "image_embeds": 0.2 * torch.randn((b, npx, cfg.d_model),
                                               generator=g, device="cuda")}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(cfg, model, batch, cache_len=s + VLM_DECODE)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    after_prefill = ops.launch_counts()
    first = logits[:, :cfg.vocab_size].argmax(-1)
    tok = first
    t1 = time.perf_counter()
    for i in range(VLM_DECODE):
        logits, cache = tf.decode_step(cfg, model, {"tokens": tok[:, None]},
                                       cache, s + i)
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        if i == 0:
            step1 = logits
    torch.cuda.synchronize()
    dec_s = (time.perf_counter() - t1) / VLM_DECODE
    counts = ops.launch_counts()
    check_tc_route(ops, counts, "phi-3-vision served", "serve_phi3v")
    if after_prefill["flash_attention_fwd"] != cfg.num_layers or \
            counts != after_prefill or not bool(torch.isfinite(
                logits).all()):
        raise AssertionError(f"phi-3-vision: launches {after_prefill} then "
                             f"{counts}, or logits not finite")
    del cache
    full = tf.forward_train(cfg, model, dict(batch, tokens=torch.cat(
        [batch["tokens"], first[:, None]], dim=1)))[:, -1]
    rel = rel_l2([step1], [full])
    lim = LM_LIMITS["qwen3-8b"][1]
    wrong, _ = tf.prefill(cfg, model, {"tokens": batch["tokens"]})
    ref_last, _ = tf.prefill(cfg, model, batch)
    rel_c = rel_l2([wrong], [ref_last])
    print(f"  phi-3-vision-4.2b: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{tf.param_count(model) / 1e9:.3f} B params; prefill {b} x {s} "
          f"({npx} image positions) {pre_s:.3f} s, decode {1e3 * dec_s:.2f} "
          f"ms a step over {VLM_DECODE}; launches {counts}; decode step 1 "
          f"vs forward_train over the prompt and the first token: rel L2 "
          f"{rel:.3e} (limit {lim}); control, the prefill without its "
          f"image embeddings: rel L2 {rel_c:.3e}, must miss it", flush=True)
    if not rel <= lim or not rel_c > lim:
        raise AssertionError(f"phi-3-vision: decode vs forward {rel}, "
                             f"control {rel_c}")
    del model
    torch.cuda.empty_cache()
    return counts


def tc_phase(torch, ops, C):
    """Phase 18 (e): the TimeConditioned ``qwen3-8b`` at ``TC_LAYERS`` of
    its 36 layers, full width, bf16, as an SRDS denoiser on latents of
    ``TC_LATENTS``: ``srds_sample`` at ``max_iters = B`` against
    ``sample_sequential`` within ``SRDS_VS_SEQ_REL_L2``, the input moved by
    ``DRIVER_PERTURB`` as the control; launch counts of the SRDS run (the
    non-causal GQA flash forward once a layer an eval, on the tensor-core
    route).  Returns them."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import dit
    cfg = dataclasses.replace(get_arch("qwen3-8b"), num_layers=TC_LAYERS)
    model = dit.init_time_conditioned(cfg, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    fn = dit.make_time_conditioned_denoiser(model)
    sched = C.make_schedule("ddpm_linear", N_STEPS)
    solver = C.SolverConfig("ddim")
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    x0 = torch.randn(TC_LATENTS, generator=g, device="cuda")
    fixed = C.SRDSConfig(num_blocks=BLOCKS, max_iters=BLOCKS,
                         fixed_iters=True, per_sample=True, tol=0.0)
    seq, seq_s = timed(torch, lambda: C.sample_sequential(fn, sched, solver,
                                                          x0))
    ops.reset_launch_counts()
    res, srds_s = timed(torch, lambda: C.srds_sample(fn, sched, solver, x0,
                                                     fixed))
    counts = ops.launch_counts()
    routes = check_tc_route(ops, counts, "TimeConditioned srds_sample",
                            "tc_srds")
    moved = C.srds_sample(fn, sched, solver, x0 + DRIVER_PERTURB * torch.randn(
        x0.shape, generator=g, device="cuda"), fixed)
    rel = rel_l2([res.sample], [seq])
    rel_c = rel_l2([moved.sample], [seq])
    evals = counts["flash_attention_fwd"] // cfg.num_layers
    print(f"  TimeConditioned qwen3-8b ({cfg.num_layers} of 36 layers, d "
          f"{cfg.d_model}, bf16), latents {tuple(x0.shape)}: srds_sample "
          f"(N={N_STEPS}, B={BLOCKS}, max_iters=B) {srds_s:.3f} s vs "
          f"sample_sequential {seq_s:.3f} s, rel L2 {rel:.3e} (limit "
          f"{SRDS_VS_SEQ_REL_L2}); control, the input moved by "
          f"{DRIVER_PERTURB} x N(0, 1): {rel_c:.3e}, must miss it; launches "
          f"{counts} ({evals} evals), routes {routes}", flush=True)
    if not rel <= SRDS_VS_SEQ_REL_L2 or not rel_c > SRDS_VS_SEQ_REL_L2 \
            or not bool(torch.isfinite(res.sample).all()) \
            or counts["flash_attention_fwd"] % cfg.num_layers:
        raise AssertionError(f"TimeConditioned: srds vs sequential {rel}, "
                             f"control {rel_c}, launches {counts}")
    del model, fn
    torch.cuda.empty_cache()
    return counts


def zoo_kernel_rows(torch, ops, ref):
    """Phase 18 (f): the flash kernels at the zoo's shapes, each against
    its twin within phase 3's limits, with ms, plain ms, the bound and
    SDPA's time (autograd through SDPA for the backward rows).  Returns
    the rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = []

    def randn(shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    for name, b, hq, hkv, s, d, causal, bwd, path in ZOO_ROWS:
        q, do = randn((b, hq, s, d)), randn((b, hq, s, d))
        k, v = randn((b, hkv, s, d)), randn((b, hkv, s, d))
        mask = dict(causal=causal)
        live = s * (s + 1) // 2 if causal else s * s
        kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        got = ops.attention(q, k, v, **mask)
        want, _ = ref.attention(q, k, v, **mask)
        b_ms, b_by = bound(nbytes(q, k, v, got) + 4 * b * hq * s,
                           4.0 * b * hq * live * d, "bfloat16")
        timing = dict(ms=time_ms(lambda: ops.attention(q, k, v, **mask), 10),
                      plain_ms=time_ms(lambda: ops.attention(
                          q, k, v, **mask, use_kernel=False), 2),
                      bound_ms=b_ms, bound_by=b_by,
                      library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                          q, kx, vx, is_causal=causal), 10))
        rel, lim = rel_l2([got], [want]), MASKED_REL_L2["bfloat16"]
        label = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                 f"{'causal' if causal else 'non-causal'}")
        rows.append(dict(name=f"{name}_fwd", path=path, counter=
                         "flash_attention_fwd", **check_case(
                             f"flash_attention_fwd {name} bf16 {label} "
                             f"({route_label(fa, torch.bfloat16, d)}; rel L2 "
                             f"{rel:.3e}, limit {lim})", got, want,
                             *MASKED_TOL["bfloat16"], timing)))
        if not rel <= lim:
            raise AssertionError(f"{name}: forward rel L2 {rel}")
        if not bwd:
            continue
        q3, do3 = (x.reshape(b * hq, s, d) for x in (q, do))
        k3, v3 = (x.reshape(b * hkv, s, d) for x in (k, v))
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, **mask)
        delta = (do3.float() * o3.float()).sum(dim=-1)
        want = ref.attention_bwd(q, k, v, o3.view(q.shape),
                                 lse.view(b, hq, s), do, **mask)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, kx, vx))
        sd = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        library_ms = time_ms(lambda: torch.autograd.grad(
            sd, (qg, kg, vg), do, retain_graph=True), 5)
        plain_ms = time_ms(lambda: ref.attention_bwd(
            q, k, v, o3.view(q.shape), lse.view(b, hq, s), do, **mask), 2)
        for part, fn, ref_out, flops, counter in (
                ("dq", lambda: (fa.flash_attention_bwd_dq(
                    q3, k3, v3, do3, lse, delta, d ** -0.5, **mask),),
                 want[:1], 6.0, "flash_attention_bwd_dq"),
                ("dkv", lambda: fa.flash_attention_bwd_dkv(
                    q3, k3, v3, do3, lse, delta, d ** -0.5, **mask),
                 want[1:], 8.0, "flash_attention_bwd_dkv")):
            got = fn()
            b_ms, b_by = bound(nbytes(q, k, v, do, lse, delta)
                               + nbytes(*got), flops * b * hq * live * d,
                               "bfloat16")
            rel = bwd_rel_l2(torch, fn, got, ref_out, f"{name} {part}")
            timing = dict(ms=time_ms(fn, 5), plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms)
            rows.append(dict(name=f"{name}_bwd_{part}", path=path,
                             counter=counter, **check_case(
                                 f"flash_attention_bwd_{part} {name} bf16 "
                                 f"{label} (rel L2 {rel:.3e}, limit "
                                 f"{BWD_MASKED_REL_L2['bfloat16']})",
                                 torch.cat([x.reshape(-1) for x in got]),
                                 torch.cat([x.reshape(-1) for x in ref_out]),
                                 BWD_BF16_ATOL, BWD_BF16_RTOL, timing)))
        del qg, kg, vg, sd, want
        torch.cuda.empty_cache()
    return rows


def zoo_phase(torch, ops, C, step):
    """Phase 18: the dense zoo served, the dense, audio and vision models
    trained, the vision model served, the TimeConditioned backbone and the
    kernel rows (module docstring).  Returns ``(counts by path, rows)``."""
    t_start = time.perf_counter()
    print(f"[{step}/18] the dense zoo, the audio and vision stubs, the "
          f"TimeConditioned backbone", flush=True)
    counts = {}
    for arch in ("qwen3-14b", "qwen1.5-32b"):
        counts[f"serve_{arch}"] = lm_phase(torch, ops, step, arch,
                                           LM_LIMITS[arch],
                                           LM_CHECK_ROWS[arch])
        torch.cuda.empty_cache()
    for arch in ("stablelm-3b", "hubert-xlarge", "phi-3-vision-4.2b"):
        counts[f"train_{arch}"] = lm_train_phase(torch, ops, step, arch)
        torch.cuda.empty_cache()
    counts["serve_phi-3-vision-4.2b"] = vlm_serve(torch, ops)
    counts["tc_srds"] = tc_phase(torch, ops, C)
    from repro_torch.kernels import ref
    rows = zoo_kernel_rows(torch, ops, ref)
    torch.cuda.empty_cache()
    print(f"  phase {step}: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return counts, rows


def tuning_builds():
    """The ``(source, defines)`` builds phase 19's flash candidate needs,
    for phase 2's ``build_all``."""
    from repro_torch.kernels import tuning
    params = dict(tuning.resolve("flash", backend="cpu").params,
                  **TUNING_CANDIDATES["flash"])
    return [(src, tuning.defines("flash", params, src))
            for src in ("flash_attention_fwd", "flash_attention_bwd")]


def launch_dims(torch, fn, kernel: str, calls: int = 20) -> set:
    """The ``(grid, block)`` of every launch of ``kernel`` the profiler
    recorded over ``calls`` calls of ``fn`` (CUPTI's record of the launch,
    from the exported trace).  Each window starts as
    ``profiling.window_launches``' does, with ``LEAD_LAUNCHES`` sleep
    kernels, a synchronize and a pause: late in a long process the
    profiler keeps no record of a window's first launches (ROADMAP C12).
    Up to three windows, until one holds a record of the kernel."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.profiling import (LAUNCH_EDGE_PAUSE_S,
                                               LEAD_CYCLES, LEAD_LAUNCHES)
    pattern = re.compile(rf"\b{kernel}\b")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(LAUNCH_EDGE_PAUSE_S)
            for _ in range(LEAD_LAUNCHES):
                torch.cuda._sleep(LEAD_CYCLES)
            torch.cuda.synchronize()
            time.sleep(LAUNCH_EDGE_PAUSE_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(LAUNCH_EDGE_PAUSE_S)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        got = {(tuple(e["args"]["grid"]), tuple(e["args"]["block"]))
               for e in events if e.get("cat") == "kernel"
               and pattern.search(e.get("name", ""))
               and "grid" in e.get("args", {})}
        if got:
            return got
    return set()


def tuning_phase(torch, ops, ref, step):
    """Phase 19 (module docstring): the tuning seam on the card."""
    import numpy as np
    from repro_torch.benchmarks import autotune_kernels, table14_kernels
    from repro_torch.kernels import _build, elementwise, tuning
    from repro_torch.kernels import selective_scan as scan
    t0 = time.perf_counter()
    builds = len(_build.build_log)
    dev = torch.device("cuda")
    table = tuning.get_tuner().table("sm90")
    print(f"[{step}] the tuning seam: committed sm90 table: "
          + (f"{len(table['entries'])} entries, {table.get('provenance')}"
             if table else "none (every key on the shipped constants)"),
          flush=True)
    for case in autotune_kernels.CASES:
        cfg = tuning.config(case.family, None, dev, case.dtype,
                            autotune_kernels.tuning_shape(case))
        print(f"  {case.family}, {case.label}: {cfg.source} "
              f"{dict(cfg.params)} (key {cfg.key})", flush=True)
        if cfg.source != "table":
            continue
        # the table's config against the shipped constants, in one process
        work = autotune_kernels._work(case, case.shape, dev)
        heuristic = tuning.KernelTuner(tables={"sm90": {
            "version": tuning.TABLE_SCHEMA_VERSION, "backend": "sm90",
            "entries": []}})
        err, ok = work.check(work.run(None), dict(cfg.params))
        tuned, shipped = autotune_kernels._in_turns(
            work.run, [None, heuristic], autotune_kernels._reps(case),
            autotune_kernels.RUNS)
        print(f"    the table's config {np.median(tuned):.2f} us a call "
              f"(runs {[round(x, 2) for x in tuned]}), the shipped "
              f"constants' {np.median(shipped):.2f} "
              f"({[round(x, 2) for x in shipped]}); max abs err {err:.3g}",
              flush=True)
        if not ok:
            raise AssertionError(f"{case.label}: the table's config misses "
                                 f"the plain version")
        del work
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def pinned(family):
        return autotune_kernels._tuner("sm90", family,
                                       TUNING_CANDIDATES[family])

    def dims_match(fn, kernel, want):
        got = launch_dims(torch, fn, kernel)
        print(f"  {kernel}: the profiler's launches (grid, block) {got}, "
              f"the tuner's {want}", flush=True)
        if not got or any(d[:len(w)] != w for grid_block in got
                          for d, w in zip(grid_block, want)):
            raise AssertionError(f"{kernel}: launched with {got}, not the "
                                 f"candidate's {want}")

    # (a) elementwise: the DiT's latents
    tuner = pinned("elementwise")
    shape = (2, 64, 64, 4)
    y, cur, prev, old = (randn(*shape) for _ in range(4))
    out, resid = ops.parareal_update_residual(y, cur, prev, old,
                                              batch_dims=1, tuner=tuner)
    want, want_r = ref.parareal_update_residual(y, cur, prev, old,
                                                batch_dims=1)
    rel = float(((resid - want_r).abs() / want_r.abs()).max())
    geo = elementwise.launch_geometry("parareal_update_residual", shape,
                                      torch.float32, tuner=tuner,
                                      device=dev, batch_dims=1)["geometry"]
    print(f"  elementwise candidate {TUNING_CANDIDATES['elementwise']}: "
          f"residual geometry {geo}, output bitwise "
          f"{torch.equal(out, want)}, sums rel {rel:.2e}", flush=True)
    if not (torch.equal(out, want) and rel <= 1e-5):
        raise AssertionError("the elementwise candidate misses the plain "
                             "version")
    dims_match(lambda: ops.parareal_update_residual(
        y, cur, prev, old, batch_dims=1, tuner=tuner),
        "parareal_resid_cluster_kernel",
        ((geo["cluster"] * shape[0],), (geo["threads"],)))
    a = torch.linspace(0.5, 0.9, shape[0], device=dev)
    got = ops.ddim_fused(y, cur, a, a, tuner=tuner)
    if not torch.equal(got, ref.ddim_fused(y, cur, a, a)):
        raise AssertionError("the DDIM candidate misses the plain version")
    dgeo = elementwise.launch_geometry("ddim_fused", shape, torch.float32,
                                       tuner=tuner, device=dev,
                                       per_row=True)["geometry"]
    dims_match(lambda: ops.ddim_fused(y, cur, a, a, tuner=tuner),
               "ddim_fused_kernel", ((dgeo["blocks"],), (dgeo["threads"],)))
    out, resid = ops.parareal_update(y, cur, prev, tuner=tuner)
    want, want_r = ref.parareal_update(y, cur, prev)
    if not (torch.equal(out, want)
            and abs(float(resid) - float(want_r)) <= 1e-5 * abs(
                float(want_r))):
        raise AssertionError("the update candidate misses the plain version")

    # (b) flash: the DiT's shape, from phase 2's 3-stage builds
    tuner = pinned("flash")
    q, k, v = (randn(10, 16, 1024, 72, dtype=torch.bfloat16)
               for _ in range(3))
    do = randn(10, 16, 1024, 72, dtype=torch.bfloat16)
    for t_ in (q, k, v):
        t_.requires_grad_(True)
    before = ops.route_counts()
    o = ops.attention(q, k, v, causal=False, tuner=tuner)
    grads = torch.autograd.grad(o, (q, k, v), do)
    after = ops.route_counts()
    o_ref, lse = ref.attention(q.detach(), k.detach(), v.detach(),
                               causal=False)
    want = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o_ref, lse,
                             do, causal=False)
    fwd_rel = rel_l2([o.detach()], [o_ref])
    bwd_rel = max(rel_l2(grads[:1], want[:1]), rel_l2(grads[1:], want[1:]))
    from repro_torch.kernels import flash_attention as fa
    fa_geo = fa.launch_geometry(1024, 1024, 72, torch.bfloat16, tuner=tuner,
                                device=dev)
    loaded = all((src, d) in _build._libs for src, d in (
        ("flash_attention_fwd", fa_geo["fwd_defines"]),
        ("flash_attention_bwd", fa_geo["bwd_defines"])))
    print(f"  flash candidate {TUNING_CANDIDATES['flash']}: builds "
          f"{fa_geo['fwd_defines']} {fa_geo['bwd_defines']} loaded "
          f"{loaded}; rel L2 forward {fwd_rel:.3e} (limit "
          f"{MASKED_REL_L2['bfloat16']}), backward {bwd_rel:.3e} (limit "
          f"{BWD_MASKED_REL_L2['bfloat16']}); tc launches "
          f"{after['flash_attention_fwd_tc'] - before['flash_attention_fwd_tc']}"
          f"/{after['flash_attention_bwd_dq_tc'] - before['flash_attention_bwd_dq_tc']}"
          f"/{after['flash_attention_bwd_dkv_tc'] - before['flash_attention_bwd_dkv_tc']}",
          flush=True)
    if not (loaded and fwd_rel <= MASKED_REL_L2["bfloat16"]
            and bwd_rel <= BWD_MASKED_REL_L2["bfloat16"]
            and fa_geo["fwd_defines"] and fa_geo["bwd_defines"]):
        raise AssertionError("the flash candidate misses the plain version "
                             "or did not run its own builds")
    del q, k, v, do, o, grads, o_ref, want

    # (c) WKV: rwkv6-1.6b's training shape, the dv sum on 64 threads
    tuner = pinned("rwkv6")
    b, h, t, d = 2, 32, 2048, 64
    r, kk, vv = (randn(b, h, t, d, dtype=torch.bfloat16) for _ in range(3))
    w = randn(b, h, t, d) * 0.5
    u, s0 = randn(h, d) * 0.3, randn(b, h, d, d) * 0.2
    xs = [x.requires_grad_(True) for x in (r, kk, vv, w, u, s0)]
    dout = randn(b, h, t, d, dtype=torch.bfloat16)

    def wkv_grads(tn):
        out, _ = ops.rwkv6_wkv(*xs, tuner=tn)
        return torch.autograd.grad(out, xs, dout)

    same = all(torch.equal(x1, x2) for x1, x2 in zip(wkv_grads(tuner),
                                                     wkv_grads(None)))
    print(f"  rwkv6 candidate {TUNING_CANDIDATES['rwkv6']}: gradients "
          f"bitwise the default's {same}", flush=True)
    if not same:
        raise AssertionError("the WKV candidate's gradients differ from the "
                             "default's")
    del xs, r, kk, vv, w, u, s0, dout

    # (d) the scan: hymba's training shape
    tuner = pinned("selective_scan")
    b, t, din, n = 2, 2048, 1600, 16
    x_ = (randn(b, t, din), torch.nn.functional.softplus(randn(b, t) - 1.0),
          randn(b, t, n), randn(b, t, n), -torch.exp(randn(din, n) * 0.5),
          randn(din), randn(b, din, n) * 0.5)
    sgeo = scan.launch_geometry(b, t, din, n, tuner=tuner, device=dev)
    y_, h_t, ckpt = scan.selective_scan(*x_, checkpoints=True, tuner=tuner)
    fwd_rel = rel_l2([y_, h_t], list(ref.selective_scan(*x_)))
    dy = randn(b, t, din)
    grads = scan.selective_scan_bwd(*x_[:6], ckpt, dy, None, tuner=tuner)
    want = ref.selective_scan_bwd(*x_, dy, None,
                                  segments=sgeo["bwd"].segments)
    bwd_rel = max(rel_l2([g_], [w_]) for g_, w_ in zip(grads, want))
    print(f"  selective_scan candidate {TUNING_CANDIDATES['selective_scan']}"
          f": forward {sgeo['fwd']}, {sgeo['stages']} stages, rel L2 "
          f"{fwd_rel:.3e} (limit {SCAN_REL_L2}); backward {sgeo['bwd']}, "
          f"rel L2 {bwd_rel:.3e} (limit {SCAN_BWD_REL_L2})", flush=True)
    if not (fwd_rel <= SCAN_REL_L2 and bwd_rel <= SCAN_BWD_REL_L2):
        raise AssertionError("the scan candidate misses the plain version")
    fg, bg = sgeo["fwd"], sgeo["bwd"]
    dims_match(lambda: ops.selective_scan(*x_, tuner=tuner),
               "selective_scan_fwd_kernel", (fg.grid, (fg.threads + 32,)))
    dims_match(lambda: scan.selective_scan_bwd(*x_[:6], ckpt, dy, None,
                                               tuner=tuner),
               "selective_scan_bwd_kernel", (bg.grid, (bg.threads + 32,)))
    del x_, y_, h_t, ckpt, dy, grads, want
    torch.cuda.empty_cache()

    # (e) the sweep's card mode on its launch knobs, (f) table14
    payload = autotune_kernels.sweep(
        dev, launch_only=True, log=lambda m: print(m, flush=True),
        cases=[c for c in autotune_kernels.CASES if any(
            k in tuning.LAUNCH_PARAMS[c.family] for k in c.knobs)])
    print(f"  launch-only sweep: {len(payload['entries'])} entries beat the "
          f"heuristics by more than their spread (schema and round trip "
          f"checked): {payload['entries']}", flush=True)
    rows = table14_kernels.run_rows(dev)
    for row in rows:
        print(f"  {row['name']}: parity_ok {row['parity_ok']}, max abs diff "
              f"{row['max_abs_diff']:.3g} (tol {row['tol']}), "
              f"{row['config_source']} {row['config_params']}", flush=True)
    if not all(row["parity_ok"] for row in rows) or len(rows) != len(
            tuning.KERNELS):
        raise AssertionError("table14: a family lost parity on the card")
    if len(_build.build_log) != builds:
        raise AssertionError(f"phase {step} built a kernel: "
                             f"{sorted(_build.build_log)[builds:]}")
    print(f"  phase {step}: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability (9, 0), found {cap}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/15] device: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import tuning
    variants = sorted(set(tuning.table_variants()) | set(tuning_builds()))
    secs = _build.build_all(extra=variants)
    print(f"[2/15] build: {len(_build.sources())} CUDA source(s) and "
          f"{len(variants)} variant(s) (the committed table's and phase "
          f"19's candidates: {variants}) in {secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        print(f"  nvcc {name}.cu:\n" + "\n".join(
            "    " + line for line in log.strip().splitlines()))

    # ---- 3. kernels against their plain versions -------------------------
    print("[3/15] kernels vs plain versions (times on this card)",
          flush=True)
    cases = kernel_phase(torch, ops, ref)

    # ---- 4. sampling -----------------------------------------------------
    import repro_torch.core as C
    from repro_torch.models import dit

    setup = dit_setup(torch)
    cfg, tree, model, model_fn = setup.cfg, setup.tree, setup.model, \
        setup.model_fn
    sched, solver, x_init = setup.sched, setup.solver, setup.x_init
    B, S, fixed, build_s = setup.B, setup.S, setup.fixed, setup.build_s
    print(f"[4/15] srds-dit-sd2: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}x{cfg.resolved_head_dim} heads, {cfg.dtype}, "
          f"{dit.param_count(model) / 1e6:.1f} M params, built in "
          f"{build_s:.1f} s", flush=True)
    layers = cfg.num_layers

    def run(label, fn, path=None):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        routes = check_tc_route(ops, counts, label, path)
        print(f"  {label}: wall {wall:.3f} s, launches {counts}, flash "
              f"forward by route {routes}", flush=True)
        return out, counts, wall

    def expect(counts, ddim, resid):
        want = dict(dict.fromkeys(counts, 0),
                    flash_attention_fwd=layers * ddim, ddim_fused=ddim,
                    parareal_update_residual=resid)
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")

    seq, counts, seq_wall = run("sample_sequential",
                                lambda: C.sample_sequential(
                                    model_fn, sched, solver, x_init))
    expect(counts, N_STEPS, 0)

    res, main_counts, _ = run("srds_sample max_iters=B (main path)",
                              lambda: C.srds_sample(model_fn, sched, solver,
                                                    x_init, fixed),
                              "srds_sample")
    p = int(res.iterations.max())
    expect(main_counts, B + p * (S + B), p * B)
    if min(n for k, n in main_counts.items()
           if k not in BWD_KERNELS + SCAN_KERNELS + (
               "parareal_update", "rwkv6_wkv", "rwkv6_wkv_bwd")) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{main_counts}")
    sample = res.sample
    if sample.shape != x_init.shape or not bool(torch.isfinite(
            sample).all()):
        raise AssertionError("srds sample is not finite or has the wrong "
                             "shape")
    rel = ((sample - seq).norm() / seq.norm()).item()
    mean_abs = (sample - seq).abs().mean().item()
    st = C.srds_stats(sched, solver, fixed, p)
    print(f"  srds vs sequential: rel L2 {rel:.3e} (limit "
          f"{SRDS_VS_SEQ_REL_L2}), mean |diff| {mean_abs:.3e}, "
          f"mean |seq| {seq.abs().mean().item():.3e}; iterations "
          f"{res.iterations.tolist()}, serial evals {st.serial_evals}, "
          f"total evals {st.total_evals}", flush=True)
    if not rel <= SRDS_VS_SEQ_REL_L2:
        raise AssertionError(f"srds at max_iters=B differs from the "
                             f"sequential sample: rel L2 {rel}")

    early = C.SRDSConfig(num_blocks=B, per_sample=True, tol=EARLY_TOL)
    res2, counts, early_wall = run(f"srds_sample tol={EARLY_TOL}",
                          lambda: C.srds_sample(model_fn, sched, solver,
                                                x_init, early))
    p2 = int(res2.iterations.max())
    expect(counts, B + p2 * (S + B), p2 * B)
    st2 = C.srds_stats(sched, solver, early, p2)
    hist = res2.delta_history[:p2].tolist()
    print(f"  early exit: iterations {res2.iterations.tolist()}, serial "
          f"evals {st2.serial_evals}, total evals {st2.total_evals}, "
          f"delta history {hist}", flush=True)
    if not bool(torch.isfinite(res2.sample).all()):
        raise AssertionError("early-exit srds sample is not finite")

    # ---- 5. ddpm and ParaDiGMS -------------------------------------------
    ddpm_counts, pd_counts = ddpm_paradigms_phase(
        torch, C, run, setup, layers,
        dict(seq_wall=seq_wall, srds_wall=early_wall,
             srds_iters=res2.iterations.tolist(),
             srds_serial=st2.serial_evals))
    del setup

    # ---- 6. serving ------------------------------------------------------
    serve_counts, serve_l2_counts = serve_phase(torch, ops, C, model_fn,
                                                sched, solver, layers)
    del model, model_fn
    torch.cuda.empty_cache()

    # ---- 7. training -----------------------------------------------------
    train_counts = train_phase(torch, ops, cfg, tree)
    del tree
    torch.cuda.empty_cache()

    # ---- 8-9. LM serving -------------------------------------------------
    lm_counts = {}
    for step, arch in ((8, "qwen3-8b"), (9, "rwkv6-1.6b")):
        lm_counts[arch] = lm_phase(torch, ops, step, arch, LM_LIMITS[arch])
        torch.cuda.empty_cache()

    # ---- 10-11. LM training -----------------------------------------------
    lm_train_counts = {}
    for step, arch in ((10, "qwen3-8b"), (11, "rwkv6-1.6b")):
        lm_train_counts[arch] = lm_train_phase(torch, ops, step, arch)
        torch.cuda.empty_cache()

    # ---- 12. hymba serving -------------------------------------------------
    lm_counts["hymba-1.5b"] = hymba_phase(torch, ops, 12)
    torch.cuda.empty_cache()

    # ---- 13. hymba training -------------------------------------------------
    lm_train_counts["hymba-1.5b"] = lm_train_phase(torch, ops, 13,
                                                   "hymba-1.5b")
    torch.cuda.empty_cache()

    # ---- 14. the drivers on torch.distributed, the serving tables ---------
    t14 = time.perf_counter()
    driver_counts = {}
    drivers_phase(torch, ops, C, 14, driver_counts)
    torch.cuda.empty_cache()
    serving_tables_phase(torch)
    torch.cuda.empty_cache()
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # ---- 15. the model-parallel DiT, the mesh engine, the DP step --------
    model_parallel_phase(torch, ops, C, 15, driver_counts)
    torch.cuda.empty_cache()

    # ---- 16. the tensor- and data-parallel language models ---------------
    lmp_counts, lmp_rows = lm_parallel_phase(torch, ops, 16)
    torch.cuda.empty_cache()

    # ---- 17. the MoE models ----------------------------------------------
    zoo_counts = moe_phase(torch, ops, 17)
    torch.cuda.empty_cache()

    # ---- 18. the dense zoo, the stub frontends, TimeConditioned -----------
    counts18, zoo_rows = zoo_phase(torch, ops, C, 18)
    zoo_counts.update(counts18)
    torch.cuda.empty_cache()

    # ---- 19. the tuning seam ----------------------------------------------
    tuning_phase(torch, ops, ref, 19)

    sources = {"flash_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:85"),
        "flash_attention_bwd_dq": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:453"),
        "flash_attention_bwd_dkv": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:494"),
        "ddim_fused": ("cuda", "src/repro_torch/kernels/csrc/elementwise.cu",
                       "src/repro/kernels/elementwise.py:34"),
        "parareal_update_residual": (
            "cuda", "src/repro_torch/kernels/csrc/elementwise.cu",
            "src/repro/kernels/elementwise.py:63"),
        "parareal_update": ("cuda",
                            "src/repro_torch/kernels/csrc/elementwise.cu",
                            "src/repro/kernels/elementwise.py:110"),
        "flash_attention_fwd_causal_gqa": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "src/repro/kernels/flash_attention.py:85"),
        "rwkv6_wkv": ("cuda", "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                      "src/repro/kernels/rwkv6_scan.py:37"),
        "flash_attention_bwd_dq_causal_gqa": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:453"),
        "flash_attention_bwd_dkv_causal_gqa": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:494"),
        "rwkv6_wkv_bwd": ("cuda", "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                          "src/repro/kernels/ops.py:199"),
        "flash_attention_fwd_window": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "src/repro/kernels/flash_attention.py:85"),
        "selective_scan": (
            "cuda", "src/repro_torch/kernels/csrc/selective_scan.cu",
            "src/repro/models/hymba.py:55"),
        "flash_attention_bwd_dq_window": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:453"),
        "flash_attention_bwd_dkv_window": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:494"),
        "selective_scan_bwd": (
            "cuda", "src/repro_torch/kernels/csrc/selective_scan.cu",
            "src/repro/models/hymba.py:55"),
        "flash_attention_fwd_shard": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "src/repro/kernels/flash_attention.py:85")}
    # a kernel's launches are those of its path: DiT training for the
    # backward, the l2_mean serving run for parareal_update, the served
    # qwen3-8b requests for the causal GQA forward (the same wrapper and
    # counter as the DiT's forward), the served rwkv6-1.6b requests for
    # WKV, qwen3-8b training for the backward's causal GQA form (the same
    # wrappers and counters as the DiT's backward), rwkv6-1.6b training
    # for the WKV backward, the served hymba-1.5b requests for the window
    # forward and the selective scan, hymba-1.5b training for the window
    # backward and the scan's backward, phase 15's row-sharded body for
    # the forward at the shard shape (Sq = S/2, Sk = S), DiT serving for
    # the rest
    path_of = dict.fromkeys(BWD_KERNELS, "train_loop")
    path_of["parareal_update"] = "serve_l2_mean"
    path_of["flash_attention_fwd_causal_gqa"] = "serve_qwen3-8b"
    path_of["rwkv6_wkv"] = "serve_rwkv6-1.6b"
    path_of.update(dict.fromkeys((k + "_causal_gqa" for k in BWD_KERNELS),
                                 "train_qwen3-8b"))
    path_of["rwkv6_wkv_bwd"] = "train_rwkv6-1.6b"
    path_of.update(dict.fromkeys(("flash_attention_fwd_window",
                                  "selective_scan"), "serve_hymba-1.5b"))
    path_of.update(dict.fromkeys((k + "_window" for k in BWD_KERNELS),
                                 "train_hymba-1.5b"))
    path_of["selective_scan_bwd"] = "train_hymba-1.5b"
    path_of["flash_attention_fwd_shard"] = "shard_body"
    kernels = []
    for name, (route, source, replaces) in sources.items():
        first = cases[name][0]            # the main path's shape
        counter = name.replace("_causal_gqa", "").replace(
            "_window", "").replace("_shard", "")
        by_path = {"srds_sample": main_counts[counter],
                   "ddpm_srds": ddpm_counts[counter],
                   "paradigms": pd_counts[counter],
                   "serve": serve_counts[counter],
                   "serve_l2_mean": serve_l2_counts[counter],
                   "train_loop": train_counts[counter],
                   **{f"serve_{a}": c[counter]
                      for a, c in lm_counts.items()},
                   **{f"train_{a}": c[counter]
                      for a, c in lm_train_counts.items()},
                   **{k: c[counter] for k, c in driver_counts.items()}}
        extra = ({"tc_launches_by_path": {
            k: r[f"{counter}_tc"] for k, r in ROUTES_BY_PATH.items()}}
            if counter in ("flash_attention_fwd",) + BWD_KERNELS else {})
        if name == "selective_scan_bwd":    # its replay and its sum
            for k in ("replay", "sum"):
                extra[f"{k}_launches"] = lm_train_counts["hymba-1.5b"][
                    f"selective_scan_bwd_{k}"]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=by_path[path_of.get(name, "serve")],
            launches_by_path=by_path, **extra,
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], cases=cases[name]))
    # phase 16's rows: each kernel at a shard shape of model 2 or 16; its
    # launches are its counter's on the phase's world-1 path that runs it
    lmp_path = {"flash_attention_fwd_causal_gqa": ("serve_qwen3-8b",
                                                   "flash_attention_fwd"),
                "flash_attention_fwd_window": ("serve_hymba-1.5b",
                                               "flash_attention_fwd"),
                "rwkv6_wkv": ("serve_rwkv6-1.6b", "rwkv6_wkv"),
                "selective_scan": ("serve_hymba-1.5b", "selective_scan"),
                "flash_attention_bwd_dq_causal_gqa": (
                    "train_qwen3-8b", "flash_attention_bwd_dq"),
                "flash_attention_bwd_dkv_causal_gqa": (
                    "train_qwen3-8b", "flash_attention_bwd_dkv"),
                "selective_scan_bwd": ("train_hymba-1.5b",
                                       "selective_scan_bwd")}
    for row in lmp_rows:
        route, source, replaces = sources[row["name"]]
        path, counter = lmp_path[row["name"]]
        launches = lmp_counts[path][counter]
        if launches == 0:
            raise AssertionError(f"{row['name']} never ran on phase 16's "
                                 f"{path}")
        kernels.append(dict(
            name=f"{row['name']}_model{row['model']}", route=route,
            source=source, replaces=replaces, launches=launches,
            launches_path=f"phase16_{path}",
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            cases=[row]))
    # phase 18's rows: each flash kernel at a zoo shape; its launches are
    # its counter's on the phase 17 or 18 path whose shape it is
    for row in zoo_rows:
        route, source, replaces = sources[row["counter"]]
        launches = zoo_counts[row["path"]][row["counter"]]
        if launches == 0:
            raise AssertionError(f"{row['name']} never ran on {row['path']}")
        kernels.append(dict(
            name=f"flash_attention_{row['name']}", route=route,
            source=source, replaces=replaces, launches=launches,
            launches_path=row["path"], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], cases=[row]))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
