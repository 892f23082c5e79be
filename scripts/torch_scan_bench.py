#!/usr/bin/env python3
"""Hymba's selective scan alone on the card: phase 3's scan checks of
``chip_smoke.py``, then a sweep over the kernel's geometry knobs.

    python3 scripts/torch_scan_bench.py [--states 2 4 8]
        [--channels 8 16 32 64] [--stages 2 4] [--against FILE ...]
    python3 scripts/torch_scan_bench.py --backward [--bwd-channels 16 32 64]

Runs ``chip_smoke.py``'s ``scan_cases`` (the same shapes, inputs, limits,
controls and launch readings as phase 3), then, in one process:

- the port's library (``_build``), and ``csrc/selective_scan.cu`` built
  with ``-DSCAN_SWEEP_INSTANCES`` (the sweep's (states, lanes) pairs that
  the port does not compile), nvcc with the port's flags into a temporary
  directory; ptxas' registers and spills per instance of each;
- each geometry of the sweep (states a lane x channels a block x stages,
  ``selective_scan.geometry``'s knobs; the kernel has no cluster) through
  the sweep's build, and the default geometry through the port's library
  as it is and with every operand on the 4-byte ``cp.async`` route: each
  held within ``SCAN_REL_L2`` of the plain twin at hymba-1.5b's width (din
  1600, n 16) at B 4 x T 2048 (prefill), T 37 and T 1 (decode), and at
  B 1 x T 2048 and T 1, then timed with CUDA events, in the order of the
  list and again in reverse, and at T 37 and T 1 read by
  ``chip_smoke.launch_readings`` (device launches a call, device µs a
  launch, host µs a call), then a breakdown of a decode call's host time;
- ``--against FILE ...``: other sources with the C interface of the
  earlier kernel with a lane per (channel, state)
  (``selective_scan_fwd(..., n, lanes, stream)``, run with its 16 lanes a
  channel) or of this one (run at the default geometry), built the same
  way and timed in the same turns.

``--backward`` runs ``chip_smoke.py``'s ``scan_backward_cases`` instead
(phase 3's backward cases: the checkpointing forward timed in turns with
the plain one, the backward's limits, controls and launch readings), then
times the backward (the kernel and its sum) with blocks of each of
``--bwd-channels`` channels at hymba-1.5b's width from the zero state at
B 2, 1 and 4 x T 2048, in the order of the list and again in reverse,
each held within ``SCAN_BWD_REL_L2`` of ``ref.selective_scan_bwd`` on
every gradient.

Needs one CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_REPS = 2000
# (B, T, din, n): the served batch's prefill, a ragged T and a decode
# step, then batch 1
SHAPES = ((4, 2048, 1600, 16), (4, 37, 1600, 16), (4, 1, 1600, 16),
          (1, 2048, 1600, 16), (1, 1, 1600, 16))
REPS = {2048: 50, 37: 200, 1: 500}


def start_build(tmp, source, tag, defines, _build):
    """nvcc on ``source`` with ``-D`` ``defines``, into ``tmp``; returns
    (library path, process)."""
    lib = os.path.join(tmp, f"libscan_{tag}.so")
    inc = str(_build.CSRC)                      # sm90_tc.cuh
    return lib, subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", inc,
         *(f"-D{d}" for d in defines), "-o", lib, source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(tag, path, proc, cs):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc, {tag}:\n{log}")
    print_ptxas(tag, log, cs)
    return ctypes.CDLL(path)


def print_ptxas(tag, log, cs):
    readings = cs.ptxas_readings(log, "selective_scan_fwd_kernel")
    print(f"  ptxas, {tag}: " + "; ".join(
        f"<{inst}> {regs} registers, spills {st}/{ld}"
        for inst, regs, st, ld in readings), flush=True)


def host_breakdown(torch, ops, scan, _build, x) -> None:
    """Where a decode call's host time goes: microseconds a call of each
    piece of the wrapper's work, each repeated HOST_REPS times with no
    synchronise among them (the C calls launch their kernel)."""
    xs, dt, bb, cc, a, d, h0 = x
    b, t, din = xs.shape
    n = a.shape[-1]
    y = torch.empty((b, t, din), device=xs.device)
    h_t = torch.empty((b, din, n), device=xs.device)
    geo = scan.geometry(b, din, n)
    lib = scan._lib()
    bits = scan.route((xs.data_ptr() % 16, dt.data_ptr() % 16,
                       (bb.data_ptr() | cc.data_ptr()) % 16), b, t, din, n,
                      geo.states * geo.lanes, xs.stride(0), xs.stride(1))
    args = (xs.data_ptr(), xs.stride(0), xs.stride(1), dt.data_ptr(),
            bb.data_ptr(), cc.data_ptr(), a.data_ptr(), d.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), b, t, din, n,
            geo.states, geo.lanes, geo.channels, scan.STAGES, bits,
            _build.stream(xs.device))
    pieces = {
        "ops.selective_scan (whole call)": lambda: ops.selective_scan(*x),
        "selective_scan.selective_scan": lambda: scan.selective_scan(*x),
        "selective_scan.launch (route, call)": lambda: scan.launch(
            lib, *x, y, h_t, geo),
        "C selective_scan_fwd through ctypes (launch included)":
            lambda: lib.selective_scan_fwd(*args),
        "selective_scan._check": lambda: scan._check(*x),
        "six .contiguous() of contiguous operands": lambda: [
            v.contiguous() for v in x[1:]],
        "two torch.empty (y, h_T)": lambda: (
            torch.empty((b, t, din), dtype=torch.float32, device=xs.device),
            torch.empty((b, din, n), dtype=torch.float32,
                        device=xs.device)),
        "geometry (cached)": lambda: scan.geometry(b, din, n),
    }
    for label, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        us = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
        print(f"  host, T {t}: {label}: {us:.2f} us", flush=True)


def backward_sweep(torch, cs, randn, scan, ref, channels):
    """The backward with blocks of each of ``channels`` channels at B 2, 1
    and 4 x T 2048 (din 1600, n 16), each held to ``SCAN_BWD_REL_L2`` of
    the twin on every gradient, timed in turns (the list, then reversed)."""
    for b in (2, 1, 4):
        x = cs.scan_inputs(torch, randn, b, 2048, 1600, 16, True)
        dy = randn((b, 2048, 1600))
        _, _, ckpt = scan.selective_scan(*x, checkpoints=True)
        want = ref.selective_scan_bwd(*x, dy)
        times = {c: [] for c in channels}
        for c in channels:
            got = scan.selective_scan_bwd(*x[:6], ckpt, dy, channels=c)
            rels = [cs.rel_l2([g], [w]) for g, w in zip(got, want)]
            if not max(rels) <= cs.SCAN_BWD_REL_L2:
                raise AssertionError(f"backward, {c} channels a block, B "
                                     f"{b}: rel L2 {rels}")
        for c in channels + channels[::-1]:
            times[c].append(cs.time_ms(lambda: scan.selective_scan_bwd(
                *x[:6], ckpt, dy, channels=c), 20))
        for c in channels:
            geo = scan.geometry(b, 1600, 16, channels=c)
            print(f"  backward B {b} T 2048: {c} channels a block (grid "
                  f"{geo.grid}, {scan.bwd_smem_bytes(geo)} B shared): "
                  + ", ".join(f"{m:.4f}" for m in times[c]) + " ms",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--channels", type=int, nargs="+",
                    default=[8, 16, 32, 64])
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--against", nargs="+", default=[],
                    help="other selective_scan.cu sources to time beside")
    ap.add_argument("--backward", action="store_true",
                    help="phase 3's backward cases and a sweep of the "
                         "backward's channels a block")
    ap.add_argument("--bwd-channels", type=int, nargs="+",
                    default=[16, 32, 64])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_bench: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import selective_scan as scan

    print(f"{cs.smi_line()}; torch {torch.__version__}", flush=True)
    print(f"  build: {_build.build_all():.1f} s", flush=True)
    if "selective_scan" in _build.build_log:
        print_ptxas("the port's library", _build.build_log["selective_scan"],
                    cs)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if args.backward:
        from repro_torch.kernels import ref
        cs.scan_backward_cases(torch, ref, randn, {"selective_scan": [],
                                                   "selective_scan_bwd": []})
        backward_sweep(torch, cs, randn, scan, ref, args.bwd_channels)
        return 0
    cs.scan_cases(torch, ops, randn, {"selective_scan": []})

    port = scan._lib()
    source = str(_build.CSRC / "selective_scan.cu")
    with tempfile.TemporaryDirectory() as tmp:
        sweep_tag = "SCAN_SWEEP_INSTANCES"
        started = {sweep_tag: start_build(tmp, source, "sweep", [sweep_tag],
                                          _build)}
        for i, path in enumerate(args.against):
            started[path] = start_build(tmp, os.path.abspath(path),
                                        f"against{i}", [], _build)
        built = {tag: finish_build(tag, *started[tag], cs) for tag in started}
        for lib in built.values():
            for fn, (argtypes, restype) in scan._SIGNATURE.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = restype
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
        sweep = built[sweep_tag]

        def geo_of(x, *knobs):          # the launch at x's batch
            return scan.geometry(x[0].shape[0], 1600, 16, *knobs)

        # (label, runner(x, y, h_t)) in the order they are timed
        runs, seen = [], set()
        for s in args.states:
            for c in args.channels:
                for st in args.stages:
                    geo = scan.geometry(4, 1600, 16, s, c)
                    if geo.threads > scan.MAX_THREADS or (geo, st) in seen:
                        continue
                    seen.add((geo, st))
                    label = (f"{geo.states} states a lane, {geo.channels} "
                             f"channels a block, {st} stages")
                    runs.append((label, lambda x, y, h, s=s, c=c, st=st:
                                 scan.launch(sweep, *x, y, h,
                                             geo_of(x, s, c), st)))
        runs.append(("the port's library, default geometry", lambda x, y, h:
                     scan.launch(port, *x, y, h, geo_of(x))))
        runs.append(("default geometry, all operands by 4-byte cp.async",
                     lambda x, y, h: scan.launch(port, *x, y, h, geo_of(x),
                                                 bits=0)))
        for path in args.against:
            old = built[path]
            if hasattr(old, "selective_scan_chunk"):
                runs.append((f"{path}, default geometry", lambda x, y, h,
                             old=old: scan.launch(old, *x, y, h, geo_of(x))))
                continue
            fn = old.selective_scan_fwd     # the earlier kernel's interface
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong] + [ctypes.c_void_p] * 8 + \
                [ctypes.c_int] * 5 + [ctypes.c_void_p]

            def lane_per_state(x, y, h, old=old, path=path):
                xs = x[0]
                code = old.selective_scan_fwd(
                    xs.data_ptr(), xs.stride(0), xs.stride(1),
                    *(v.data_ptr() for v in x[1:]), y.data_ptr(),
                    h.data_ptr(), xs.shape[0], xs.shape[1], xs.shape[2],
                    x[4].shape[-1], 16,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(old, code, path)
            runs.append((f"{path} (a lane per (channel, state), 16 lanes "
                         f"a channel)", lane_per_state))

        for b, t, din, n in SHAPES:
            x = cs.scan_inputs(torch, randn, b, t, din, n, t == 2048)
            want = ops.selective_scan(*x, use_kernel=False)
            y = torch.empty((b, t, din), device="cuda")
            h_t = torch.empty((b, din, n), device="cuda")
            times = {label: [] for label, _ in runs}
            rels, readings = {}, {}
            for label, run in runs:
                run(x, y, h_t)
                torch.cuda.synchronize()
                rels[label] = max(cs.rel_l2([y], [want[0]]),
                                  cs.rel_l2([h_t], [want[1]]))
                if not rels[label] <= cs.SCAN_REL_L2:
                    raise AssertionError(f"{label}, T {t}: rel L2 "
                                         f"{rels[label]} against the twin")
            for label, run in runs + runs[::-1]:
                times[label].append(cs.time_ms(lambda: run(x, y, h_t),
                                               REPS[t]))
            if t < 64:      # one chunk: read on the device
                for label, run in runs:
                    readings[label] = cs.launch_readings(
                        torch, lambda: run(x, y, h_t))
            for label, _ in runs:
                r = readings.get(label)
                dev = r and r["device_us_per_launch"]
                extra = (f"; device {dev:.2f} us a launch" if dev
                         else "; device: none traced") + (
                    f", {r['launches_per_call']:g} launches a call, host "
                    f"{r['host_us_per_call']:.2f} us a call") if r else ""
                print(f"  B {b} T {t}: {label}: " + ", ".join(
                    f"{m:.4f}" for m in times[label]) + f" ms (rel L2 "
                    f"{rels[label]:.3e}{extra})", flush=True)
            if (b, t) == (4, 1):
                host_breakdown(torch, ops, scan, _build, x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
