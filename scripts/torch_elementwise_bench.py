#!/usr/bin/env python3
"""The DDIM step and the fused updates, with and without the residual,
alone on the card: phase 3's B2, B1 and B4 cases of ``chip_smoke.py``,
without the rest of the run.

    python3 scripts/torch_elementwise_bench.py [--src DIR] [--end-to-end]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``;
another checkout's, such as its parent commit's unpacked by ``git
archive``, to compare two versions in one call: parent, change, change,
parent) and runs ``chip_smoke.py``'s ``elementwise_cases``: the same
cases, inputs and limits as phase 3, each held against its plain version
and run twice (bitwise equal), timed with CUDA events over 500 calls, with
the device launches per call and device microseconds per launch from one
``torch.profiler`` window and the host's enqueue microseconds per call.
A case that misses its limit raises, as in phase 3.  For a tree whose
three kernels are all CUDA C++ it also holds each call to one device
launch and the scalar path to the 16-byte path's bits, then reads where a
call's host time goes (``host_breakdown``); an older tree's kernels are
only read.

``--end-to-end`` first runs phases 4 and 6's paths through ``--src``'s
package, before any kernel reading, so that both sides of a comparison
start alike: ``chip_smoke.dit_setup``'s model, inputs and settings (the
full-width ``srds-dit-sd2`` DiT), ``sample_sequential`` and
``srds_sample`` at ``max_iters=B`` (``E2E_RUNS`` timed runs each after a
warm-up of every kernel they run, host clock around synchronised work),
then ``chip_smoke.serve_phase`` (the served trace, its checks and its
makespan).  Needs one CUDA card.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_REPS = 2000
E2E_RUNS = 5


def host_breakdown(torch, ops, elementwise) -> None:
    """Where a call's host time goes: microseconds a call of each piece of
    the wrappers' work, each piece repeated HOST_REPS times with no
    synchronise among them (the C calls launch their kernels)."""
    import ctypes
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device="cuda").manual_seed(0)
    x, e, p, o = (torch.randn((10, 64, 64, 4), generator=g, device=dev)
                  for _ in range(4))
    a = torch.linspace(0.05, 0.6, 10, device=dev)
    b = a + 0.3
    out = torch.empty_like(x)
    resid = torch.empty(10, device=dev)
    lib = elementwise._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_vec, blocks = elementwise.ddim_geometry(x.numel(), x[0].numel(), True,
                                              4, True)
    ddim_args = (x.data_ptr(), e.data_ptr(), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), x.numel(), n_vec, x[0].numel(), 1, blocks,
                 0, stream)
    cluster, per_block, threads, _ = elementwise.resid_geometry(
        x[0].numel(), 4, True)
    resid_args = (x.data_ptr(), e.data_ptr(), p.data_ptr(), o.data_ptr(),
                  out.data_ptr(), resid.data_ptr(), x[0].numel(), per_block,
                  10, cluster, threads, 1, 0, stream)
    resid0 = torch.empty((), device=dev)
    b4_cluster, b4_per_block, b4_threads, _ = elementwise.resid_geometry(
        x.numel(), 4, True)
    update_args = (x.data_ptr(), e.data_ptr(), p.data_ptr(), out.data_ptr(),
                   resid0.data_ptr(), x.numel(), b4_per_block, b4_cluster,
                   b4_threads, 1, 0, stream)
    pieces = {
        "ops.ddim_fused (whole call)": lambda: ops.ddim_fused(x, e, a, b),
        "elementwise.ddim_fused": lambda: elementwise.ddim_fused(x, e, a, b),
        "ops.parareal_update_residual (whole call, batch_dims=1)":
            lambda: ops.parareal_update_residual(x, e, p, o, batch_dims=1),
        "ops.parareal_update (whole call)":
            lambda: ops.parareal_update(x, e, p),
        "C parareal_update through ctypes (cluster launch included)":
            lambda: lib.parareal_update(*update_args),
        "C ddim_fused through ctypes (launch included)":
            lambda: lib.ddim_fused(*ddim_args),
        "C parareal_update_residual through ctypes (cluster launch "
        "included)": lambda: lib.parareal_update_residual(*resid_args),
        "ctypes call of one argument (cuda_error_string)":
            lambda: lib.cuda_error_string(0),
        "torch.empty of the output": lambda: torch.empty(
            x.shape, dtype=x.dtype, device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "elementwise._check of two operands":
            lambda: elementwise._check("ddim_fused", x, e),
        "ctypes.c_int(0) and byref": lambda: ctypes.byref(ctypes.c_int(0)),
    }
    for label, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        us = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
        print(f"  host: {label}: {us:.2f} us", flush=True)


def end_to_end(torch, cs) -> None:
    """Phases 4 and 6's wall times for this ``--src``: see the module
    docstring."""
    import repro_torch.core as C
    from repro_torch.kernels import ops
    d = cs.dit_setup(torch)
    # every kernel of the timed paths runs once first, so that a tree whose
    # B4 is a Triton kernel pays its JIT outside the timed runs
    ops.parareal_update(d.x_init, d.x_init, d.x_init)
    torch.cuda.synchronize()
    paths = {"sample_sequential": lambda: C.sample_sequential(
                 d.model_fn, d.sched, d.solver, d.x_init),
             "srds_sample max_iters=B": lambda: C.srds_sample(
                 d.model_fn, d.sched, d.solver, d.x_init, d.fixed)}
    for label, fn in paths.items():
        fn()
        walls = []
        for _ in range(E2E_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"  end to end, {label}: wall " + ", ".join(
            f"{w:.3f}" for w in walls) + " s", flush=True)
    cs.serve_phase(torch, ops, C, d.model_fn, d.sched, d.solver,
                   d.cfg.num_layers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--end-to-end", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    sys.path.insert(0, os.path.abspath(args.src))   # ahead of it
    import torch
    if not torch.cuda.is_available():
        print("torch_elementwise_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, elementwise, ops, ref

    print(f"{cs.smi_line()}; torch {torch.__version__}; src {args.src}",
          flush=True)
    print(f"  build: {_build.build_all():.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if args.end_to_end:     # first, so that both sides start alike
        end_to_end(torch, cs)
    ported = hasattr(elementwise, "ddim_geometry") and not hasattr(
        elementwise, "_triton_kernels")
    cases = {"ddim_fused": [], "parareal_update_residual": [],
             "parareal_update": []}
    cs.elementwise_cases(torch, ops, ref, randn, cases,
                         launches=1 if ported else None)
    if ported:
        host_breakdown(torch, ops, elementwise)
    return 0


if __name__ == "__main__":
    sys.exit(main())
