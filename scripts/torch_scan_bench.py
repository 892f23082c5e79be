#!/usr/bin/env python3
"""Hymba's selective scan alone on the card: phase 3's scan checks of
``chip_smoke.py``, then a reading of the kernel's inner step loop unrolled.

    python3 scripts/torch_scan_bench.py [--unroll 1 2 4 8]

Runs ``chip_smoke.py``'s ``scan_cases`` (the same shapes, inputs, limits
and controls as phase 3, each held against the plain twin, run twice and
timed with CUDA events), then builds ``csrc/selective_scan.cu`` once for
each ``--unroll`` factor with ``#pragma unroll <u>`` on its step loop
(nvcc with the port's flags, into a temporary directory) and times each
build at hymba-1.5b's prefill (4 x 2048) and decode (T 1) shapes, in the
order 1, 2, .., 2, 1 in one process, each checked bitwise against the
port's own kernel.  Prints ptxas' registers per build.  Needs one CUDA
card and ``nvcc``.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP = "    for (int t = 0; t < steps; ++t) {\n      const float dtt"


def build(tmp, source, unroll, _build):
    """Starts nvcc on ``source`` with the step loop unrolled ``unroll``
    times; returns (library path, process)."""
    if LOOP not in source:
        raise RuntimeError("the scan's step loop is not where this script "
                           "looks for it")
    path = os.path.join(tmp, f"scan_u{unroll}.cu")
    with open(path, "w") as f:
        f.write(source.replace(LOOP, f"#pragma unroll {unroll}\n" + LOOP))
    lib = os.path.join(tmp, f"libscan_u{unroll}.so")
    return lib, subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unroll", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import selective_scan as scan

    print(f"{cs.smi_line()}; torch {torch.__version__}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cs.scan_cases(torch, ops, randn, {"selective_scan": []})
    with open(os.path.join(ROOT, "src/repro_torch/kernels/csrc/"
                                 "selective_scan.cu")) as f:
        source = f.read()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        started = {u: build(tmp, source, u, _build) for u in args.unroll}
        for u, (path, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc, unroll {u}:\n{log}")
            regs = sorted({line.split("Used ")[1].split(",")[0]
                           for line in log.splitlines() if "Used " in line})
            print(f"  unroll {u}: ptxas {regs} (per lanes-a-channel "
                  f"instance)", flush=True)
            lib = ctypes.CDLL(path)
            fn = lib.selective_scan_fwd
            fn.argtypes = list(scan._SIGNATURE["selective_scan_fwd"][0])
            fn.restype = ctypes.c_int
            libs[u] = fn
        for b, t, din, n in ((4, 2048, 1600, 16), (4, 1, 1600, 16)):
            x = cs.scan_inputs(torch, randn, b, t, din, n, False)
            want = scan.selective_scan(*x)
            lanes, _, _ = scan.geometry(b, din, n)

            def run(u):
                y = torch.empty((b, t, din), device="cuda")
                h_t = torch.empty((b, din, n), device="cuda")
                xs = x[0]
                code = libs[u](xs.data_ptr(), xs.stride(0), xs.stride(1),
                               *(v.data_ptr() for v in x[1:]),
                               y.data_ptr(), h_t.data_ptr(), b, t, din, n,
                               lanes, torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f"unroll {u}: CUDA error {code}")
                return y, h_t

            times = {u: [] for u in libs}
            for u in list(libs) + list(libs)[::-1]:
                got = run(u)
                if not all(torch.equal(a, c) for a, c in zip(got, want)):
                    raise AssertionError(f"unroll {u} differs from the "
                                         f"port's kernel")
                times[u].append(cs.time_ms(lambda: run(u),
                                           50 if t > 1 else 500))
            for u, ms in times.items():
                print(f"  T {t}: unroll {u}: " + ", ".join(
                    f"{m:.4f}" for m in ms) + " ms (bitwise equal to the "
                    "port's kernel)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
