#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card (compute capability 9.0), ``nvcc`` and ``triton``.
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
   while the kernels' 2 terms meet it), DDIM, the fused residual and
   the fused update without it (``parareal_update``: f32 at the serving
   shape, bf16, ragged; two runs bitwise equal); the forward's causal
   grouped-query form at qwen3-8b's prefill shape, a ragged right-aligned
   causal case and the sliding-window form at hymba-1.5b's shape; the
   WKV kernel at rwkv6-1.6b's prefill shape, at T = 1 and a ragged T (two
   runs bitwise equal); the backward's causal GQA form at qwen3-8b's
   training shape, its sliding-window form at hymba-1.5b's and a ragged
   causal f32 case; the WKV backward at rwkv6-1.6b's training shape, at
   T = 7 and T = 300 in f32 (two runs bitwise equal);
4. sampling: the full-width, full-depth ``srds-dit-sd2`` DiT (28 layers,
   d 1152, 16 heads of 72, bf16) with weights drawn from a numpy seed
   (every leaf nonzero) and loaded through ``load_jax_params``; DDIM on
   ``ddpm_linear`` with N=25, B=5, K=2 per-sample.  ``sample_sequential``,
   then ``srds_sample`` at ``max_iters=B`` (the main path: launch counts
   reset just before and read just after), held against the sequential
   sample, then ``srds_sample`` with an early-exit ``tol``.  Launch counts
   must equal what the loop implies;
5. serving: the same DiT behind ``repro_torch.serve``: a
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
6. training: the same DiT and weights through ``launch.train.build``:
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
7. LM serving: ``qwen3-8b`` at full width and depth (36 layers, d 4096,
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
8. the same for ``rwkv6-1.6b`` (24 layers, d 2048, 1.60 B parameters):
   the WKV kernel 24 times per prefill and per decode step.  Its random
   bf16 model amplifies any change of rounding, so every layer's WKV
   launch in one bf16 prefill is first held against the plain scan on
   that layer's inputs, and checks 1-3 then run the same weights in f32;
   the first check also holds the final WKV states, and the control
   (decode step 1 with the carried WKV state dropped) must miss the
   second;
9. LM training: ``qwen3-8b`` at its published widths with 8 of its 36
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
   reading KV head ``bh % BKV``); the loss on a held-out batch falls;
10. the same for ``rwkv6-1.6b`` whole through ``launch.train.build``: the
   WKV forward and backward 24 times a step.  The WKV backward on each
   layer's own inputs at T 2048 against ``ref.rwkv6_wkv_bwd``; after the
   steps, the gradient check on the trained weights in f32 at batch 1 x
   256 (the random bf16 model amplifies rounding, phase 8) over their
   first 4 layers (over all 24 the random model's gradient is chaotic in
   f32 too: a reading), whole and over the decay LoRA leaves alone, with
   the backward's ``dd`` dropped as the control.

Phases 4-7 and 9 also hold the flash kernels' launches on their main
paths, forward and backward, to their tensor-core route
(``ops.route_counts``: every attention there is bf16 with head dim 72 or
128; the backward runs in phases 6 and 9).  Phases 9 and 10 end with ROADMAP
C10's reading: the busy share of 10 ``train_loop`` steps as the launcher
runs them (``log_every=10``, pinned non-blocking batch copies) and as it
ran before (``log_every=1``, pageable copies), each under the profiler
and PyTorch's sync debug mode (the parameters are put back after).

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import os
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
# srds at max_iters=B vs sequential: exact in exact arithmetic; here bf16
# weights and activations (2^-8 relative per rounding) in GEMMs whose shape,
# and so cuBLAS's kernel and summation order, depend on the batch (10
# latents per fine step, 2 per sequential step) perturb every eval.  An
# H100 run measured 1.05e-5; the limit keeps a margin of about 100x.
SRDS_VS_SEQ_REL_L2 = 1e-3
# phase 5: the serving engine's slots, and a bursty trace whose tiers
# draw (tol=0, tol=0, loose | loose, loose, loose) from this seed (checked)
SERVE_SLOTS, SERVE_PERIOD, SERVE_TRACE_SEED = 2, 1.0, 75
# the loose tier's tol, between the residuals of refinements 2 and 3 in
# phase 4's early-exit delta history (an H100 run read 0.159 and 0.0093
# there, and 0.153-0.164 and 0.0092-0.0093 for the served requests), so
# its requests stop at refinement 3, a factor 3 or more from any residual
LOOSE_TOL = 5e-2
# PyTorch's sync debug mode's warning for a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
# the l2_mean run against the l1_mean run, tol=0 requests: the norm
# changes nothing that is computed, so bitwise is expected
SERVE_L2_VS_L1_REL = 1e-6
TRAIN_BATCH, TRAIN_STEPS, GRAD_BATCH = 8, 5, 2
# a tenth of the launcher's default (LAUNCHER_LR): the random-weight DiT
# (adaLN gates open in all 28 layers) is far rougher than the adaLN-zero
# init, and Adam's first steps move every weight by about the step's lr.
# Phase 5 ends with a reading of the held-out probe at LAUNCHER_LR: on an
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
# phases 7-8: 4 requests for ServingEngine(batch_size=4), token ids below
# both vocabularies (rwkv6's 65,536), the same requests for both models
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
LM_LIMITS = {"qwen3-8b": (5e-2, 5e-2), "rwkv6-1.6b": (1e-3, 1e-3)}
# phases 9-10: LM training at batch 2 x 2048 for 5 AdamW steps,
# qwen3-8b at its published widths with 8 of its 36 layers (2.79 B
# parameters: 33.5 GB of weights, gradients and f32 moments; all 36 would
# need 98 GB), rwkv6-1.6b whole (None).  The lr (the schedule's 5 warm-up
# steps rise to half of it): qwen3-8b at the launcher's default; rwkv6-
# 1.6b at a third of it.  Its random-weight model is chaotic (phase 8): a
# step re-randomizes its logits, and scripts/torch_lm_probe_sweep.py reads
# its held-out loss flat over 5 steps at lr 3e-5 to 6e-4 and rising above
# (PERF.md); at 1e-4 the probe falls step by step, at 3e-4 it rose
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 2048, 5
LM_TRAIN_LR = {"qwen3-8b": 3e-4, "rwkv6-1.6b": 1e-4}
LM_TRAIN_LAYERS = {"qwen3-8b": 8, "rwkv6-1.6b": None}
# phases 9-10: the steps of each busy-share window (ROADMAP C10), one
# launcher log interval
BUSY_STEPS = 10
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
LM_GRAD_REL_L2 = {"qwen3-8b": 5e-2, "rwkv6-1.6b": 1e-3}
QKV_LEAVES = (".attn.wq", ".attn.wk", ".attn.wv")
DECAY_LEAVES = (".tmix.w_base", ".tmix.A_w", ".tmix.B_w")
# the flash forward's launches by route on each main path (check_tc_route)
ROUTES_BY_PATH = {}
# the WKV kernel's final state against the plain scan's on one layer's
# inputs: the same f32 recurrence summed in another order (an H100 run
# measured at most 3.5e-8 over the 24 layers)
WKV_STATE_REL_L2 = 1e-5


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
    tensor-core kernels: every attention of the DiT and of qwen3-8b is bf16
    with a head dim that is a multiple of 8.  Keeps the route counts of
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
            current = (",".join(re.findall(r"Li(\d+)E", name))
                       if kernel in name else None)
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
    """Phase 6; returns the launch counts of the ``train_loop`` run."""
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
    print(f"[6/10] training {cfg.name} through launch.train.build "
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
    """Phase 5; returns the launch counts of the l1_mean run and of the
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
    print(f"[5/10] serving: {len(trace)} requests in 2 bursts "
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


def lm_requests(np):
    """The LM phases' traffic: 4 prompts of random token ids (below both
    vocabularies, from the seed) and their generation budgets."""
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, LM_TOKEN_IDS, n), m)
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


def lm_phase(torch, ops, step, arch, limits):
    """Phases 7 and 8: ``arch`` at full width and depth with random
    weights from a seeded CUDA generator, serving 4 requests through
    ``repro_torch.serve.ServingEngine``; then the checks.  Returns the
    launch counts of the served run."""
    import dataclasses
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.models.rwkv6 import RWKVState
    from repro_torch.serve import Request, ServingEngine

    cfg = get_arch(arch)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    torch.cuda.synchronize()
    kernel = "rwkv6_wkv" if cfg.block == "rwkv6" else "flash_attention_fwd"
    print(f"[{step}/10] {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, "
          f"{tf.param_count(model) / 1e9:.3f} B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; serving {len(LM_PROMPTS)} "
          f"requests (prompts {LM_PROMPTS}, max_new_tokens {LM_NEW})",
          flush=True)
    reqs = lm_requests(np)
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
    print(f"  launches per call: prefill {calls[0][2][kernel]}, decode "
          f"{sorted(set(c[2][kernel] for c in calls[1:]))} ({kernel})",
          flush=True)
    if [len(o) for o in outs] != list(LM_NEW) or not all(
            0 <= x < cfg.vocab_size for o in outs for x in o):
        raise AssertionError(f"{arch}: bad generations {outs}")
    per_decode = cfg.num_layers if kernel == "rwkv6_wkv" else 0
    want = dict.fromkeys(counts, 0)
    want[kernel] = cfg.num_layers + per_decode * len(decode_s)
    if counts != want or calls[0][2][kernel] != cfg.num_layers or any(
            c[2][kernel] != per_decode for c in calls[1:]):
        raise AssertionError(f"{arch}: launch counts {counts} != {want} "
                             f"({cfg.num_layers} per prefill, {per_decode} "
                             f"per decode step)")

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


class NoCheckpoints:
    """A checkpointer for ``train_loop`` that keeps nothing.  The LM phases
    do not write their states (28 GB of parameters and moments for
    qwen3-8b's 8 layers); phase 6 holds the DiT's checkpoint bitwise and
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
    KV head ``i % BKV`` in place of ``i // group``.  The heads are permuted
    around the kernel, which then computes exactly that function."""
    def bwd(q, k, v, o, lse, do, **mask):
        bh, bkv = q.shape[0], k.shape[0]
        group = bh // bkv
        pos = torch.arange(bh, device=q.device)
        perm = pos // group + (pos % group) * bkv
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
    to replace and its broken version."""
    from repro_torch.train import lm_loss
    names, params = zip(*model.named_parameters())
    sel = [i for i, n in enumerate(names) if n.endswith(part)]

    def grads(use_kernel):
        loss, _ = lm_loss(cfg, model, batch, use_kernel=use_kernel)
        return loss.item(), torch.autograd.grad(loss, params)

    def distances(got):
        return (rel_l2(got, gp),
                rel_l2([got[i] for i in sel], [gp[i] for i in sel]))

    lp, gp = grads(False)
    lk, gk = grads(None)
    readings = {"kernels": distances(gk)}
    del gk
    for name, (attr, broken) in controls.items():
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
        if not min(r, r_part) > limit:
            raise AssertionError(f"{arch}: the gradient check does not "
                                 f"catch the control ({name}): {r}, "
                                 f"{r_part}")


def lm_train_phase(torch, ops, step_no, arch):
    """Phases 9 and 10: ``arch`` trained for ``LM_TRAIN_STEPS`` AdamW steps
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
    if layers is None:
        cfg, model, opt_state, step, _ = launch.build(
            arch, lr=LM_TRAIN_LR[arch], total_steps=LM_TRAIN_STEPS,
            device="cuda")
    else:
        # launch.build's own calls, with the depth cut (the launcher has
        # no depth flag); the optimizer state comes after the checks
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        model = tf.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda",
                               trainable=True)
        opt_state = step = None
    stream = make_stream(cfg, DataConfig(seed=SEED,
                                         global_batch=LM_TRAIN_BATCH,
                                         seq_len=LM_TRAIN_SEQ),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = tf.param_count(model)
    print(f"[{step_no}/10] training {arch}: {cfg.num_layers} of "
          f"{get_arch(arch).num_layers} layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({cfg.dtype}, drawn on the card; "
          f"{time.perf_counter() - t0:.1f} s), batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ} tokens from LMStream, lr {LM_TRAIN_LR[arch]}",
          flush=True)
    bwd_name = "rwkv6_wkv_bwd" if cfg.block == "rwkv6" else \
        "flash_attention_bwd_dkv"
    errs = []

    # 1. the backward kernel on each layer's own inputs, captured from one
    # gradient of the training batch, against its plain version
    if cfg.block == "rwkv6":
        real_wkv_bwd = ops.rwkv6_wkv_bwd

        def checked(r, k, v, w, u, ckpt, dout, ds_t=None):
            got = real_wkv_bwd(r, k, v, w, u, ckpt, dout, ds_t)
            want = ref.rwkv6_wkv_bwd(r, k, v, w, u, ckpt[:, :, 0], dout,
                                     ds_t)
            errs.append([rel_l2([g], [x]) for g, x in zip(got, want)])
            return got

        attr = "rwkv6_wkv_bwd"
        limit = WKV_BWD_REL_L2["bfloat16"]
        what = "dr/dk/dv/dw/du/ds0"
    else:
        real_bwd = ops.flash_attention_bwd

        def checked(q, k, v, o, lse, do, **mask):
            got = real_bwd(q, k, v, o, lse, do, **mask)
            want = ref.attention_bwd(q[None], k[None], v[None], o[None],
                                     lse[None], do[None], **mask)
            errs.append([rel_l2([g], [x[0]]) for g, x in zip(got, want)])
            return got

        attr = "flash_attention_bwd"
        limit = BWD_MASKED_REL_L2["bfloat16"]
        what = "dq/dk/dv"
    real = getattr(ops, attr)
    setattr(ops, attr, checked)
    try:
        batch0 = stream.batch(0)
        loss, _ = lm_loss(cfg, model, batch0)
        torch.autograd.grad(loss, list(model.parameters()))
    finally:
        setattr(ops, attr, real)
    worst = [max(e[i] for e in errs) for i in range(len(errs[0]))]
    print(f"  1. {bwd_name.replace('_dkv', '')} on each of the {len(errs)} "
          f"layers' own inputs (batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, "
          f"bf16) vs the plain backward: rel L2 {what} at most "
          + "/".join(f"{x:.2e}" for x in worst) + f" (limit {limit})",
          flush=True)
    if len(errs) != cfg.num_layers or not max(worst) <= limit:
        raise AssertionError(f"{arch}: the backward kernel differs from its "
                             f"plain version on the model's inputs: {worst}")
    del loss
    torch.cuda.empty_cache()

    # 2. (qwen3-8b, bf16) every parameter's gradient through the kernels
    # against the plain attention's, with two broken backwards
    if cfg.block != "rwkv6":
        small = {k: v[:LM_GRAD_BATCH] for k, v in batch0.items()}
        real_bwd = ops.flash_attention_bwd
        readings, line = grad_readings(
            torch, ops, cfg, model, small, QKV_LEAVES, {
                "backward without the causal mask": (
                    "flash_attention_bwd",
                    lambda *a, **m: real_bwd(*a, **dict(m, causal=False))),
                "backward reading KV head bh % BKV": (
                    "flash_attention_bwd",
                    permuted_heads_bwd(real_bwd, torch))})
        print(f"  2. gradient at batch {LM_GRAD_BATCH} x {LM_TRAIN_SEQ} "
              f"(bf16), {line}", flush=True)
        check_grad_readings(readings, LM_GRAD_REL_L2[arch],
                            "the q/k/v projections", arch)
        opt_state = init_opt_state(dict(model.named_parameters()))
        lr = LM_TRAIN_LR[arch]
        step = make_train_step(cfg, AdamWConfig(
            lr=lr, schedule=warmup_cosine(lr, max(10, LM_TRAIN_STEPS // 10),
                                          LM_TRAIN_STEPS)), loss_kind="lm")

    # the main path: train_loop over LM_TRAIN_STEPS batches; the probe is
    # a batch the loop does not train on
    probe = stream.batch(LM_TRAIN_STEPS)

    def probe_loss():
        with torch.no_grad():
            return lm_loss(cfg, model, probe)[0].item()

    before = probe_loss()
    kernels = ((("rwkv6_wkv", "rwkv6_wkv_bwd") if cfg.block == "rwkv6"
                else ("flash_attention_fwd",) + BWD_KERNELS))
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

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model, opt_state, _ = train_loop(
        timed_step, model, opt_state, stream, SEED + 1, NoCheckpoints(),
        LoopConfig(total_steps=LM_TRAIN_STEPS, ckpt_every=LM_TRAIN_STEPS,
                   log_every=1), metrics_cb=log)
    loop_s = time.perf_counter() - t1
    counts = ops.launch_counts()
    routes = check_tc_route(ops, counts, f"{arch} train_loop",
                            f"train_{arch}")
    print(f"  train_loop ({LM_TRAIN_STEPS} steps, main path): {loop_s:.3f} "
          f"s, launches {counts}, flash kernels by route {routes}",
          flush=True)
    want = dict.fromkeys(counts, 0)
    want.update(dict.fromkeys(kernels, cfg.num_layers * LM_TRAIN_STEPS))
    if counts != want:
        raise AssertionError(f"{arch}: launch counts {counts} != {want}")
    losses = [r["loss"] for r in rows]
    if len(losses) != LM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch}: train losses not finite: {losses}")
    after = probe_loss()
    print(f"  3. held-out probe loss (batch {LM_TRAIN_STEPS} of the stream) "
          f"{before:.6f} -> {after:.6f}", flush=True)
    if not after < before:
        raise AssertionError(f"{arch}: the probe loss did not fall")
    profile_reading(torch, f"train step ({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ})",
                    lambda: step(model, opt_state, batch0))
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

        def no_dd(*args):
            dr, dk, dv, dw, du, ds0 = real_wkv_bwd(*args)
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
    del model
    torch.cuda.empty_cache()
    return counts


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
        cases["flash_attention_fwd_causal_gqa"].append(check_case(
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


def wkv_cases(torch, ops, randn, cases):
    """The WKV kernel against the plain scan: rwkv6-1.6b's prefill (batch
    4 x 32 heads, T 2048, Dk = Dv = 64, r/k/v bf16, w/u/state f32, from the
    zero state), a decode step (T 1), a ragged T (7) and an f32 case, each
    run twice and held bitwise equal.  The bound counts the flops the
    function needs on the f32 units: 5 per state element per step (r.S and
    decay * S + k v^T) and 3 Dk + 2 Dv per step for the bonus term
    v (r.(u*k)); PyTorch has no single call for it (``library_ms`` null)."""
    for b, h, t, dk, dtype, zero in [(4, 32, 2048, 64, "bfloat16", True),
                                     (4, 32, 1, 64, "bfloat16", False),
                                     (4, 32, 7, 64, "bfloat16", False),
                                     (2, 4, 300, 64, "float32", False)]:
        tdt = getattr(torch, dtype)
        r, k, v = (randn((b, h, t, dk)).mul(0.5).to(tdt) for _ in range(3))
        w = (randn((b, h, t, dk)) * 0.5 - 1.0).clamp(-8.0, 4.0)
        u = randn((h, dk)) * 0.3
        s0 = (torch.zeros((b, h, dk, dk), device=r.device) if zero
              else randn((b, h, dk, dk)) * 0.2)
        out, s_t = ops.rwkv6_wkv(r, k, v, w, u, s0)
        again = ops.rwkv6_wkv(r, k, v, w, u, s0)
        out_r, s_r = ops.rwkv6_wkv(r, k, v, w, u, s0, use_kernel=False)
        if not (torch.equal(_bits(again[0]), _bits(out))
                and torch.equal(_bits(again[1]), _bits(s_t))):
            raise AssertionError("rwkv6_wkv: two runs differ")
        s_err = (s_t - s_r).abs().max().item()
        if not torch.allclose(s_t, s_r, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"rwkv6_wkv: the final state differs from "
                                 f"the plain scan's by {s_err}")
        b_ms, b_by = bound(nbytes(r, k, v, w, u, s0, out, s_t),
                           b * h * t * (5.0 * dk * dk + 5.0 * dk),
                           "float32")
        timing = dict(
            ms=time_ms(lambda: ops.rwkv6_wkv(r, k, v, w, u, s0),
                       20 if t >= 1024 else 200),
            plain_ms=time_ms(lambda: ops.rwkv6_wkv(r, k, v, w, u, s0,
                                                   use_kernel=False), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        cases["rwkv6_wkv"].append(check_case(
            f"rwkv6_wkv {dtype} B={b} H={h} T={t} D={dk} (state max err "
            f"{s_err:.3e}, limit 1e-4; two runs bitwise)", out, out_r, tol,
            tol, timing))


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
            cases[name + "_causal_gqa"].append(check_case(
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
    state), a ragged T (7) and T 300 in f32, with upstream gradients on
    out and on the final state; each run twice and held bitwise equal.
    Every gradient is held by relative L2 over the tensor (the kernel and
    the plain scan sum in other orders; ``dw`` sums a row of G * S that
    can cancel, so an elementwise tolerance would be meaningless there).
    The bound counts 12 flops per state element per step (the recomputed
    state, S dout, G v, G^T k, rowsum(G * S), the G update) plus 15 Dk +
    2 Dv per step, on the f32 units; PyTorch has no single call for it
    (``library_ms`` null)."""
    from repro_torch.kernels import rwkv6_scan
    for b, h, t, dk, dtype in [(2, 32, 2048, 64, "bfloat16"),
                               (2, 32, 7, 64, "bfloat16"),
                               (2, 4, 300, 64, "float32")]:
        tdt = getattr(torch, dtype)
        r, k, v = (randn((b, h, t, dk)).mul(0.5).to(tdt) for _ in range(3))
        w = (randn((b, h, t, dk)) * 0.5 - 1.0).clamp(-8.0, 4.0)
        u = randn((h, dk)) * 0.3
        s0 = (torch.zeros((b, h, dk, dk), device=r.device) if t >= 1024
              else randn((b, h, dk, dk)) * 0.2)
        dout = randn((b, h, t, dk)).to(tdt)
        ds_t = randn((b, h, dk, dk)) * 0.1
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
            b * h * t * (12.0 * dk * dk + 17.0 * dk), "float32")
        timing = dict(ms=time_ms(kernel, 5 if t >= 1024 else 100),
                      plain_ms=time_ms(plain, 1), bound_ms=b_ms,
                      bound_by=b_by, library_ms=None)
        flat = [torch.cat([x.float().reshape(-1) for x in xs])
                for xs in (got, want)]
        scale = max(x.float().abs().max().item() for x in want)
        cases["rwkv6_wkv_bwd"].append(check_case(
            f"rwkv6_wkv_bwd {dtype} B={b} H={h} T={t} D={dk} (rel L2 "
            f"dr/dk/dv/dw/du/ds0 " + "/".join(f"{x:.1e}" for x in rels)
            + f", limit {lim}; two runs bitwise)", *flat,
            2e-2 * scale, 2e-2, timing))
        if not max(rels) <= lim:
            raise AssertionError(f"rwkv6_wkv_bwd: rel L2 {rels} against "
                                 f"the plain backward")


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
             "flash_attention_bwd_dkv_causal_gqa": [], "rwkv6_wkv_bwd": []}
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

    masked_flash_cases(torch, ops, ref, randn, cases)
    backward_cases(torch, ref, randn, cases)
    masked_backward_cases(torch, ref, randn, cases)

    # DDIM: the fine step's 10 folded latents, per-row coefficients
    x, e = randn((BLOCKS * SAMPLES, 64, 64, 4)), randn((BLOCKS * SAMPLES,
                                                         64, 64, 4))
    a = torch.linspace(0.05, 0.6, x.shape[0], device=dev)
    b = a + 0.3
    got = ops.ddim_fused(x, e, a, b)
    b_ms, b_by = bound(nbytes(x, e, got, a, b), 10.0 * x.numel(), "float32")
    timing = dict(ms=time_ms(lambda: ops.ddim_fused(x, e, a, b), 500),
                  plain_ms=time_ms(lambda: ops.ddim_fused(
                      x, e, a, b, use_kernel=False), 200),
                  bound_ms=b_ms, bound_by=b_by, library_ms=None)
    cases["ddim_fused"].append(check_case(
        f"ddim_fused float32 {tuple(x.shape)} per-row", got,
        ref.ddim_fused(x, e, a, b), 2e-5, 2e-5, timing))

    # fused update + residual: one corrector block (K=2 latents) per
    # sample, plus the scalar and per-(block, sample) reductions
    for nd, shape in [(1, (SAMPLES, 64, 64, 4)), (0, (SAMPLES, 64, 64, 4)),
                      (2, (BLOCKS, SAMPLES, 64, 64, 4))]:
        y, c, p, o = (randn(shape) for _ in range(4))
        out, resid = ops.parareal_update_residual(y, c, p, o, batch_dims=nd)
        out_r, resid_r = ref.parareal_update_residual(y, c, p, o,
                                                      batch_dims=nd)
        if not torch.equal(out, out_r):
            raise AssertionError("parareal_update_residual: the update is "
                                 "not bitwise equal to its plain version")
        b_ms, b_by = bound(nbytes(y, c, p, o, out, resid),
                           5.0 * y.numel(), "float32")
        timing = dict(
            ms=time_ms(lambda: ops.parareal_update_residual(
                y, c, p, o, batch_dims=nd), 500),
            plain_ms=time_ms(lambda: ops.parareal_update_residual(
                y, c, p, o, batch_dims=nd, use_kernel=False), 200),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        cases["parareal_update_residual"].append(check_case(
            f"parareal_update_residual float32 {shape} batch_dims={nd}",
            resid, resid_r, 0.0, 1e-5, timing))

    # fused update without the residual (B4): one corrector block of the
    # serving engine's 2 slots in f32, the same in bf16, and a ragged size
    for shape, dtype in [((SAMPLES, 64, 64, 4), "float32"),
                         ((SAMPLES, 64, 64, 4), "bfloat16"),
                         ((3, 1000, 7), "float32")]:
        tdt = getattr(torch, dtype)
        y, c, p = (randn(shape, tdt) for _ in range(3))
        out, resid = ops.parareal_update(y, c, p)
        again = ops.parareal_update(y, c, p)
        out_r, resid_r = ref.parareal_update(y, c, p)
        if not torch.equal(out, out_r):
            raise AssertionError("parareal_update: the update is not bitwise "
                                 "equal to its plain version")
        if not (torch.equal(_bits(again[0]), _bits(out))
                and torch.equal(_bits(again[1]), _bits(resid))):
            raise AssertionError("parareal_update: two runs differ")
        b_ms, b_by = bound(nbytes(y, c, p, out, resid), 5.0 * y.numel(),
                           "float32")
        timing = dict(
            ms=time_ms(lambda: ops.parareal_update(y, c, p), 500),
            plain_ms=time_ms(lambda: ops.parareal_update(
                y, c, p, use_kernel=False), 200),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        cases["parareal_update"].append(check_case(
            f"parareal_update {dtype} {shape} (out bitwise, two runs "
            f"bitwise)", resid, resid_r, 0.0, 1e-5, timing))

    wkv_cases(torch, ops, randn, cases)
    wkv_backward_cases(torch, ref, randn, cases)
    return cases


def main() -> int:
    import numpy as np
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
    print(f"[1/10] device: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build, ops, ref
    secs = _build.build_all()
    print(f"[2/10] build: {len(_build.sources())} CUDA source(s) in "
          f"{secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        print(f"  nvcc {name}.cu:\n" + "\n".join(
            "    " + line for line in log.strip().splitlines()))

    # ---- 3. kernels against their plain versions -------------------------
    print("[3/10] kernels vs plain versions (times on this card)",
          flush=True)
    cases = kernel_phase(torch, ops, ref)

    # ---- 4. sampling -----------------------------------------------------
    import repro_torch.core as C
    from repro_torch.configs import get_arch
    from repro_torch.models import dit

    cfg = get_arch("srds-dit-sd2")
    t0 = time.perf_counter()
    tree = dit.random_jax_tree(cfg, seed=SEED)
    model = dit.load_jax_params(cfg, tree, device="cuda")
    print(f"[4/10] srds-dit-sd2: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}x{cfg.resolved_head_dim} heads, {cfg.dtype}, "
          f"{dit.param_count(model) / 1e6:.1f} M params, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    model_fn = dit.make_denoiser(model)
    sched = C.make_schedule("ddpm_linear", N_STEPS)
    solver = C.SolverConfig("ddim")
    B, S = C.resolve_blocks(N_STEPS, BLOCKS)
    x_init = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (SAMPLES, 64, 64, 4)).astype(np.float32)).cuda()
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
        want = {"flash_attention_fwd": layers * ddim,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "ddim_fused": ddim, "parareal_update_residual": resid,
                "parareal_update": 0, "rwkv6_wkv": 0, "rwkv6_wkv_bwd": 0}
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")

    seq, counts, _ = run("sample_sequential", lambda: C.sample_sequential(
        model_fn, sched, solver, x_init))
    expect(counts, N_STEPS, 0)

    fixed = C.SRDSConfig(num_blocks=B, max_iters=B, fixed_iters=True,
                         per_sample=True, tol=0.0)
    res, main_counts, _ = run("srds_sample max_iters=B (main path)",
                              lambda: C.srds_sample(model_fn, sched, solver,
                                                    x_init, fixed),
                              "srds_sample")
    p = int(res.iterations.max())
    expect(main_counts, B + p * (S + B), p * B)
    if min(n for k, n in main_counts.items()
           if k not in BWD_KERNELS + ("parareal_update", "rwkv6_wkv",
                                      "rwkv6_wkv_bwd")) == 0:
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
    res2, counts, _ = run(f"srds_sample tol={EARLY_TOL}",
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

    # ---- 5. serving ------------------------------------------------------
    serve_counts, serve_l2_counts = serve_phase(torch, ops, C, model_fn,
                                                sched, solver, layers)
    del model, model_fn
    torch.cuda.empty_cache()

    # ---- 6. training -----------------------------------------------------
    train_counts = train_phase(torch, ops, cfg, tree)
    del tree
    torch.cuda.empty_cache()

    # ---- 7-8. LM serving -------------------------------------------------
    lm_counts = {}
    for step, arch in ((7, "qwen3-8b"), (8, "rwkv6-1.6b")):
        lm_counts[arch] = lm_phase(torch, ops, step, arch, LM_LIMITS[arch])
        torch.cuda.empty_cache()

    # ---- 9-10. LM training -----------------------------------------------
    lm_train_counts = {}
    for step, arch in ((9, "qwen3-8b"), (10, "rwkv6-1.6b")):
        lm_train_counts[arch] = lm_train_phase(torch, ops, step, arch)
        torch.cuda.empty_cache()

    sources = {"flash_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:85"),
        "flash_attention_bwd_dq": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:453"),
        "flash_attention_bwd_dkv": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:494"),
        "ddim_fused": ("triton", "src/repro_torch/kernels/elementwise.py",
                       "src/repro/kernels/elementwise.py:34"),
        "parareal_update_residual": (
            "triton", "src/repro_torch/kernels/elementwise.py",
            "src/repro/kernels/elementwise.py:63"),
        "parareal_update": ("triton", "src/repro_torch/kernels/elementwise.py",
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
                          "src/repro/kernels/ops.py:199")}
    # a kernel's launches are those of its path: DiT training for the
    # backward, the l2_mean serving run for parareal_update, the served
    # qwen3-8b requests for the causal GQA forward (the same wrapper and
    # counter as the DiT's forward), the served rwkv6-1.6b requests for
    # WKV, qwen3-8b training for the backward's causal GQA form (the same
    # wrappers and counters as the DiT's backward), rwkv6-1.6b training
    # for the WKV backward, DiT serving for the rest
    path_of = dict.fromkeys(BWD_KERNELS, "train_loop")
    path_of["parareal_update"] = "serve_l2_mean"
    path_of["flash_attention_fwd_causal_gqa"] = "serve_qwen3-8b"
    path_of["rwkv6_wkv"] = "serve_rwkv6-1.6b"
    path_of.update(dict.fromkeys((k + "_causal_gqa" for k in BWD_KERNELS),
                                 "train_qwen3-8b"))
    path_of["rwkv6_wkv_bwd"] = "train_rwkv6-1.6b"
    kernels = []
    for name, (route, source, replaces) in sources.items():
        first = cases[name][0]            # the main path's shape
        counter = name.replace("_causal_gqa", "")
        by_path = {"srds_sample": main_counts[counter],
                   "serve": serve_counts[counter],
                   "serve_l2_mean": serve_l2_counts[counter],
                   "train_loop": train_counts[counter],
                   **{f"serve_{a}": c[counter]
                      for a, c in lm_counts.items()},
                   **{f"train_{a}": c[counter]
                      for a, c in lm_train_counts.items()}}
        extra = ({"tc_launches_by_path": {
            k: r[f"{counter}_tc"] for k, r in ROUTES_BY_PATH.items()}}
            if counter in ("flash_attention_fwd",) + BWD_KERNELS else {})
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=by_path[path_of.get(name, "serve")],
            launches_by_path=by_path, **extra,
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], cases=cases[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
