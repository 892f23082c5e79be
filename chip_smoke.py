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
   path's shapes, with its time, the plain version's, the least time the
   card could take (``bound_ms``) and, where one PyTorch call computes the
   same function, that call's time (``library_ms``, a yardstick the port
   never calls);
4. end to end: the full-width, full-depth ``srds-dit-sd2`` DiT (28 layers,
   d 1152, 16 heads of 72, bf16) with weights drawn from a numpy seed
   (every leaf nonzero) and loaded through ``load_jax_params``; DDIM on
   ``ddpm_linear`` with N=25, B=5, K=2 per-sample.  ``sample_sequential``,
   then ``srds_sample`` at ``max_iters=B`` (the main path: launch counts
   reset just before and read just after), held against the sequential
   sample, then ``srds_sample`` with an early-exit ``tol``.  Launch counts
   must equal what the loop implies.

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


def kernel_phase(torch, ops, ref):
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = {"flash_attention_fwd": [], "ddim_fused": [],
             "parareal_update_residual": []}
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
    print(f"[1/4] device: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build, ops, ref
    secs = _build.build_all()
    print(f"[2/4] build: {len(_build.sources())} CUDA source(s) in "
          f"{secs:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        print(f"  nvcc {name}.cu:\n" + "\n".join(
            "    " + line for line in log.strip().splitlines()))

    # ---- 3. kernels against their plain versions -------------------------
    print("[3/4] kernels vs plain versions (times on this card)", flush=True)
    cases = kernel_phase(torch, ops, ref)

    # ---- 4. end to end ---------------------------------------------------
    import repro_torch.core as C
    from repro_torch.configs import get_arch
    from repro_torch.models import dit

    cfg = get_arch("srds-dit-sd2")
    t0 = time.perf_counter()
    model = dit.load_jax_params(cfg, dit.random_jax_tree(cfg, seed=SEED),
                                device="cuda")
    print(f"[4/4] srds-dit-sd2: {cfg.num_layers} layers, d {cfg.d_model}, "
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
        want = {"flash_attention_fwd": layers * ddim, "ddim_fused": ddim,
                "parareal_update_residual": resid}
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
    if min(main_counts.values()) == 0:
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

    sources = {"flash_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:85"),
        "ddim_fused": ("triton", "src/repro_torch/kernels/elementwise.py",
                       "src/repro/kernels/elementwise.py:34"),
        "parareal_update_residual": (
            "triton", "src/repro_torch/kernels/elementwise.py",
            "src/repro/kernels/elementwise.py:63")}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        first = cases[name][0]            # the main path's shape
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=main_counts[name],
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
