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
   never calls): the flash forward, the flash backward's dq and dkv
   kernels (against ``ref.attention_bwd``), DDIM, the fused residual and
   the fused update without it (``parareal_update``: f32 at the serving
   shape, bf16, ragged; two runs bitwise equal);
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
   default learning rate, which is why this phase trains at a tenth of it.

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
    compute dq, dk and dv together."""
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
            cases[name].append(check_case(
                f"{name} {dtype} BH={bh} Sq={sq} Sk={sk} D={d}",
                torch.cat([g.reshape(-1) for g in got]),
                torch.cat([w.reshape(-1) for w in ref_out]), atol, rtol,
                timing))


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
    print(f"[6/6] training {cfg.name} through launch.train.build "
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
        print(f"  train_loop ({TRAIN_STEPS} steps, main path): "
              f"{loop_s:.3f} s, launches {counts}", flush=True)
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
    print(f"[5/6] serving: {len(trace)} requests in 2 bursts "
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

    def drive(label, norm, reqs):
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
              f"launches {counts}; host fetches {len(fetches)} "
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

    rep, l1_counts, wall = drive("l1_mean run (main path)", "l1_mean", trace)
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
                               [serve.SampleRequest(**r) for r in exact])
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


def kernel_phase(torch, ops, ref):
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [],
             "flash_attention_bwd_dkv": [], "ddim_fused": [],
             "parareal_update_residual": [], "parareal_update": []}
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
        cases["flash_attention_fwd"].append(check_case(
            f"flash_attention_fwd {dtype} BH={bh} Sq={sq} Sk={sk} D={d}",
            got, want, tol, tol, timing))

    backward_cases(torch, ref, randn, cases)

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
    print(f"[1/6] device: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build, ops, ref
    secs = _build.build_all()
    print(f"[2/6] build: {len(_build.sources())} CUDA source(s) in "
          f"{secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        print(f"  nvcc {name}.cu:\n" + "\n".join(
            "    " + line for line in log.strip().splitlines()))

    # ---- 3. kernels against their plain versions -------------------------
    print("[3/6] kernels vs plain versions (times on this card)", flush=True)
    cases = kernel_phase(torch, ops, ref)

    # ---- 4. sampling -----------------------------------------------------
    import repro_torch.core as C
    from repro_torch.configs import get_arch
    from repro_torch.models import dit

    cfg = get_arch("srds-dit-sd2")
    t0 = time.perf_counter()
    tree = dit.random_jax_tree(cfg, seed=SEED)
    model = dit.load_jax_params(cfg, tree, device="cuda")
    print(f"[4/6] srds-dit-sd2: {cfg.num_layers} layers, d {cfg.d_model}, "
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

    def run(label, fn):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        print(f"  {label}: wall {wall:.3f} s, launches {counts}", flush=True)
        return out, counts, wall

    def expect(counts, ddim, resid):
        want = {"flash_attention_fwd": layers * ddim,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "ddim_fused": ddim, "parareal_update_residual": resid,
                "parareal_update": 0}
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")

    seq, counts, _ = run("sample_sequential", lambda: C.sample_sequential(
        model_fn, sched, solver, x_init))
    expect(counts, N_STEPS, 0)

    fixed = C.SRDSConfig(num_blocks=B, max_iters=B, fixed_iters=True,
                         per_sample=True, tol=0.0)
    res, main_counts, _ = run("srds_sample max_iters=B (main path)",
                              lambda: C.srds_sample(model_fn, sched, solver,
                                                    x_init, fixed))
    p = int(res.iterations.max())
    expect(main_counts, B + p * (S + B), p * B)
    if min(n for k, n in main_counts.items()
           if k not in BWD_KERNELS + ("parareal_update",)) == 0:
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
                            "src/repro/kernels/elementwise.py:110")}
    # a kernel's launches are those of its path: training for the
    # backward, the l2_mean serving run for parareal_update, serving (this
    # slice's main path) for the rest
    path_of = dict.fromkeys(BWD_KERNELS, "train_loop")
    path_of["parareal_update"] = "serve_l2_mean"
    kernels = []
    for name, (route, source, replaces) in sources.items():
        first = cases[name][0]            # the main path's shape
        by_path = {"srds_sample": main_counts[name],
                   "serve": serve_counts[name],
                   "serve_l2_mean": serve_l2_counts[name],
                   "train_loop": train_counts[name]}
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=by_path[path_of.get(name, "serve")],
            launches_by_path=by_path,
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
