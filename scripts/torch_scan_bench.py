#!/usr/bin/env python3
"""Hymba's selective scan alone on the card: phase 3's scan checks of
``chip_smoke.py``, then a sweep over the kernel's geometry knobs.

    python3 scripts/torch_scan_bench.py [--states 2 4 8]
        [--channels 8 16 32 64] [--stages 2 4] [--against FILE ...]
    python3 scripts/torch_scan_bench.py --backward [--bwd-channels 16 32]
        [--segment-chunks 4 8 16 32] [--against FILE ...]

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
the plain one, the backward's limits, controls, launch readings and
device time by kernel), then builds ``csrc/selective_scan.cu`` again with
other values of its compile-time knobs (``BWD_BUILDS``: steps a
sub-chunk, compute threads a block, blocks an SM of the register cap;
ptxas' registers and spills of each) and times the backward (the kernel
and its sum) at hymba-1.5b's width from the zero state at
``BWD_SHAPES`` (B 2, 1 and 4 x T 2048, B 2 x T 37 and 300): the port's
library with blocks of each of ``--bwd-channels`` channels and segments
of each of ``--segment-chunks`` chunks at least
(``selective_scan.bwd_geometry``'s knobs), each build at the default
geometry (the wide build at 64 channels a block), and ``--against FILE
...``: earlier sources with the C interface of the first backward (no
segments, ``selective_scan_bwd(..., states, lanes, channels, route,
stream)``, run with blocks of 32 channels), in the order of the list and
again in reverse, each held first within ``SCAN_BWD_REL_L2`` of
``ref.selective_scan_bwd`` at its own segment count on every gradient.

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


def print_ptxas(tag, log, cs, kernel="selective_scan_fwd_kernel"):
    readings = cs.ptxas_readings(log, kernel)
    print(f"  ptxas, {tag}, {kernel}: " + "; ".join(
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


# the backward's shapes (B, T) at din 1600, n 16: the training shape, then
# batch 1 and 4, then phase 3's short T (one chunk, and five)
BWD_SHAPES = ((2, 2048), (1, 2048), (4, 2048), (2, 37), (2, 300))
# the backward's other builds: tag -> -D defines (SCAN_BWD_SUB, steps a
# sub-chunk; SCAN_BWD_MAX_CONSUMERS, a block's compute threads;
# SCAN_BWD_MIN_BLOCKS, blocks an SM the registers are capped for)
BWD_BUILDS = {
    "sub 8, 2 blocks an SM": ["SCAN_BWD_MIN_BLOCKS=2"],
    "sub 4, 3 blocks an SM": ["SCAN_BWD_SUB=4", "SCAN_BWD_MIN_BLOCKS=3"],
    "replay 3 blocks an SM": ["SCAN_BWD_REPLAY_MIN_BLOCKS=3"],
    "wide: 256 threads, 1 block an SM": [
        "SCAN_BWD_MAX_CONSUMERS=256", "SCAN_BWD_MIN_BLOCKS=1",
        "SCAN_BWD_REPLAY_MIN_BLOCKS=1"],
}


def first_backward(torch, _build, scan, lib, x, ckpt, dy, channels=32):
    """The first backward's two launches (no segments) from ``lib``, a
    build of an earlier source with its C interface."""
    xs = x[0]
    b, t, din = xs.shape
    n = x[4].shape[-1]
    f32 = dict(dtype=torch.float32, device=xs.device)
    blocks = -(-din // channels)
    dx = torch.empty((b, t, din), **f32)
    dd_part, da_part = torch.empty((b, din), **f32), \
        torch.empty((b, din, n), **f32)
    dh0 = torch.empty((b, din, n), **f32)
    partial = torch.empty((b, blocks, t, 33), **f32)
    ddt, dbb, dcc = (torch.empty(s, **f32) for s in ((b, t), (b, t, n),
                                                     (b, t, n)))
    da, dd = torch.empty((din, n), **f32), torch.empty((din,), **f32)
    ptrs = [v.data_ptr() % scan.ALIGN for v in (xs, x[1], x[2], x[3], dy)]
    bits = scan.bwd_route((ptrs[0], ptrs[1], ptrs[2] | ptrs[3], ptrs[4]), b,
                          t, din, n, 16, xs.stride(0), xs.stride(1))
    _build.call(lib, "selective_scan_bwd", xs.device, xs.data_ptr(),
                xs.stride(0), xs.stride(1), *(v.data_ptr() for v in x[1:6]),
                ckpt.data_ptr(), dy.data_ptr(), None, dx.data_ptr(),
                dd_part.data_ptr(), da_part.data_ptr(), dh0.data_ptr(),
                partial.data_ptr(), b, t, din, n, 4, 4, channels, bits)
    _build.call(lib, "selective_scan_bwd_sum", xs.device, partial.data_ptr(),
                da_part.data_ptr(), dd_part.data_ptr(), ddt.data_ptr(),
                dbb.data_ptr(), dcc.data_ptr(), da.data_ptr(), dd.data_ptr(),
                b, t, din, n, 16, blocks)
    return dx, ddt, dbb, dcc, da, dd, dh0


def backward_sweep(torch, cs, randn, scan, ref, _build, args):
    """The backward's builds and geometries at ``BWD_SHAPES`` (din 1600, n
    16), each held to ``SCAN_BWD_REL_L2`` of the twin at its segment count
    on every gradient, timed in turns (the list, then reversed)."""
    source = str(_build.CSRC / "selective_scan.cu")
    with tempfile.TemporaryDirectory() as tmp:
        started = {tag: start_build(tmp, source, f"bwd{i}", defines, _build)
                   for i, (tag, defines) in enumerate(BWD_BUILDS.items())}
        for i, path in enumerate(args.against):
            started[path] = start_build(tmp, os.path.abspath(path),
                                        f"against{i}", [], _build)
        built = {}
        for tag, (path, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc, {tag}:\n{log}")
            for kernel in ("selective_scan_bwd_replay_kernel",
                           "selective_scan_bwd_kernel"):
                print_ptxas(tag, log, cs, kernel)
            lib = ctypes.CDLL(path)
            sigs = dict(scan._SIGNATURE) if tag in BWD_BUILDS else {
                "selective_scan_bwd": ((ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_longlong)
                                       + (ctypes.c_void_p,) * 13
                                       + (ctypes.c_int,) * 8
                                       + (ctypes.c_void_p,), ctypes.c_int),
                "selective_scan_bwd_sum": ((ctypes.c_void_p,) * 8
                                           + (ctypes.c_int,) * 6
                                           + (ctypes.c_void_p,),
                                           ctypes.c_int)}
            for fn, (argtypes, restype) in sigs.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = restype
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            built[tag] = lib

        def port_run(c, sc):
            return (lambda x, ck, dy: scan.selective_scan_bwd(
                *x[:6], ck, dy, geo=scan.bwd_geometry(
                    *x[0].shape, 16, c, sc))), \
                lambda b, t: scan.bwd_geometry(b, t, 1600, 16, c, sc)

        # (label, run(x, ckpt, dy), geometry(batch) or None, sub)
        runs = []
        for c in args.bwd_channels:
            for sc in args.segment_chunks:
                run, geo = port_run(c, sc)
                runs.append((f"the port's library, {c} channels a block, "
                             f"segments of {sc} chunks at least", run, geo,
                             scan.SUB))
        for tag, lib in built.items():
            if tag not in BWD_BUILDS:
                runs.append((f"{tag} (first backward, 32 channels a block)",
                             lambda x, ck, dy, lib=lib: first_backward(
                                 torch, _build, scan, lib, x, ck, dy), None,
                             None))
                continue
            sub = lib.selective_scan_bwd_knobs(0)
            wide = lib.selective_scan_bwd_knobs(1)
            c = 64 if wide > scan.BWD_MAX_THREADS else \
                scan.BWD_CHANNELS_PER_BLOCK

            def geo_of(b, t, c=c, wide=wide):
                return scan.bwd_geometry(b, t, 1600, 16, c,
                                         scan.SEGMENT_CHUNKS, wide)
            runs.append((f"{tag}, {c} channels a block",
                         lambda x, ck, dy, lib=lib, g=geo_of:
                         scan.selective_scan_bwd(
                             *x[:6], ck, dy, geo=g(*x[0].shape[:2]),
                             lib=lib), geo_of, sub))

        for b, t in BWD_SHAPES:
            x = cs.scan_inputs(torch, randn, b, t, 1600, 16, True)
            dy = randn((b, t, 1600))
            _, _, ckpt = scan.selective_scan(*x, checkpoints=True)
            wants = {}
            for label, run, geo_of, _ in runs:
                segs = geo_of(b, t).segments if geo_of else 1
                if segs not in wants:
                    wants[segs] = ref.selective_scan_bwd(*x, dy,
                                                         segments=segs)
                got = run(x, ckpt, dy)
                rels = [cs.rel_l2([g], [w]) for g, w in zip(got, wants[segs])]
                if not max(rels) <= cs.SCAN_BWD_REL_L2:
                    raise AssertionError(f"backward, {label}, B {b}: rel L2 "
                                         f"{rels}")
            del wants
            times = {label: [] for label, *_ in runs}
            for label, run, *_ in runs + runs[::-1]:
                times[label].append(cs.time_ms(lambda: run(x, ckpt, dy),
                                               20 if t >= 1024 else 100))
            for label, _, geo_of, sub in runs:
                geo = geo_of(b, t) if geo_of else None
                shape = (f"grid {geo.grid}, "
                         f"{geo.threads} + 32 threads, "
                         f"{scan.bwd_smem_bytes(geo, sub)} B shared"
                         if geo else f"grid (50, {b}), 160 threads")
                print(f"  backward B {b} T {t}: {label} ({shape}): "
                      + ", ".join(f"{m:.4f}" for m in times[label]) + " ms",
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
                    default=[16, 32])
    ap.add_argument("--segment-chunks", type=int, nargs="+",
                    default=[4, 8, 16, 32])
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
        backward_sweep(torch, cs, randn, scan, ref, _build, args)
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
