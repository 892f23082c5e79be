#!/usr/bin/env python3
"""How far ``torch.profiler``'s device timestamps stray from its host
timestamps, and how often a window of DDIM calls loses launches at its
edges, with and without ``profiling.device_launches``' pause.

    python3 scripts/torch_profiler_edges.py [--windows N]
    python3 scripts/torch_profiler_edges.py --scan-late

Runs ``--windows`` profiler windows of 20 ``ddim_fused`` calls on the
fine step's shape (10, 64, 64, 4) with no pause: for each window whose 20
launch calls and 20 kernels were all traced, the least (kernel start - its
launch call's start), pairing the k-th call with the k-th kernel (a
negative value means the device's timestamps read early); and the windows
that traced fewer kernels than calls.  Then as many windows through
``device_launches`` (its pause at both ends), counting those not of 20
launches.

``--scan-late`` instead reads which launches of a window of selective-scan
calls (hymba-1.5b's decode shape, and its prefill shape) have no device
record, pairing each host launch call with the kernel record of the same
CUPTI correlation id in the profiler's raw (Kineto) events, beside the
count ``prof.events()`` keeps; windows with a fill kernel launched before
or after the calls, and a DDIM window, as comparisons; and
``profiling.window_launches``' counts of the same calls.  It reads them in
a fresh process and again after each group of ``chip_smoke.py`` phase 3's
cases, in that phase's order.  Needs one CUDA card.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20


def raw_window(torch, fn, calls, lead=None, trail=None) -> dict:
    """One profiler window of ``calls`` calls of ``fn``, with
    ``profiling.window_launches``' pauses, and ``lead`` / ``trail`` run
    before / after the calls inside it: the host's launch calls, the raw
    kernel records, those ``prof.events()`` keeps, the places (in launch
    order) of the launches with no record of their correlation id, and
    the names of records with no launch."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import profiling
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(profiling.LAUNCH_EDGE_PAUSE_S)
        if lead:
            lead()
        for _ in range(calls):
            fn()
        if trail:
            trail()
        torch.cuda.synchronize()
        time.sleep(profiling.LAUNCH_EDGE_PAUSE_S)
    raw = prof.profiler.kineto_results.events()
    launches = sorted((e.start_ns(), e.correlation_id()) for e in raw
                      if e.device_type() == DeviceType.CPU
                      and e.name().startswith(profiling.LAUNCH_APIS))
    kernels = [(e.correlation_id(), e.name()) for e in raw
               if e.device_type() == DeviceType.CUDA
               and e.name() not in profiling.NOT_KERNELS]
    have = {c for c, _ in kernels}
    called = {c for _, c in launches}
    kept = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in profiling.NOT_KERNELS)
    return dict(api=len(launches), raw=len(kernels), kept=kept,
                missing=[i for i, (_, c) in enumerate(launches)
                         if c not in have],
                unlaunched=[n[:40] for c, n in kernels if c not in called])


def scan_late() -> int:
    """``--scan-late``: see the module's docstring."""
    from collections import defaultdict
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.runtime import profiling
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    print(f"build {_build.build_all():.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    dec = cs.scan_inputs(torch, randn, 4, 1, 1600, 16, False)
    pre = cs.scan_inputs(torch, randn, 4, 2048, 1600, 16, True)
    x, e = randn((10, 64, 64, 4)), randn((10, 64, 64, 4))
    a = torch.linspace(0.05, 0.6, 10, device="cuda")
    z = torch.empty(1, device="cuda")
    windows = {
        "scan T 1": (lambda: ops.selective_scan(*dec), None, None),
        "scan T 1, a fill after": (lambda: ops.selective_scan(*dec), None,
                                   z.zero_),
        "scan T 1, a fill before": (lambda: ops.selective_scan(*dec),
                                    z.zero_, None),
        "scan T 2048": (lambda: ops.selective_scan(*pre), None, None),
        "ddim": (lambda: ops.ddim_fused(x, e, a, a + 0.3), None, None),
    }

    def report(stage):
        for label, (fn, lead, trail) in windows.items():
            fn()
            for _ in range(3 if label == "scan T 1" else 1):
                print(f"  {stage}: {label}: "
                      f"{raw_window(torch, fn, CALLS, lead, trail)}",
                      flush=True)
            if lead is None and trail is None:
                got = profiling.window_launches(fn, CALLS)
                print(f"  {stage}: {label}, window_launches: api "
                      f"{got['api']}, recorded "
                      f"{sum(k for k, _ in got['device'].values())}",
                      flush=True)

    cases = defaultdict(list)
    report("fresh")
    cs.elementwise_cases(torch, ops, ref, randn, cases)
    report("after the B1/B2/B4 cases")
    cs.wkv_readings(torch)
    cs.wkv_cases(torch, ops, ref, randn, cases)
    cs.wkv_backward_cases(torch, ref, randn, cases)
    report("after the WKV cases")
    cs.masked_flash_cases(torch, ops, ref, randn, cases)
    cs.backward_cases(torch, ref, randn, cases)
    cs.masked_backward_cases(torch, ref, randn, cases)
    report("after the flash cases")
    cs.scan_cases(torch, ops, randn, cases, launches=None)
    report("after the scan cases")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=500)
    ap.add_argument("--scan-late", action="store_true")
    args = ap.parse_args()
    if args.scan_late:
        return scan_late()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.runtime import profiling
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    x, e = (torch.randn((10, 64, 64, 4), generator=g, device="cuda")
            for _ in range(2))
    a = torch.linspace(0.05, 0.6, 10, device="cuda")
    b = a + 0.3

    def fn():
        return ops.ddim_fused(x, e, a, b)

    fn()
    offsets, short = [], []
    for i in range(args.windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        evs = prof.events()
        kernels = sorted(ev.time_range.start for ev in evs
                         if ev.device_type == DeviceType.CUDA
                         and ev.name not in profiling.NOT_KERNELS)
        calls = sorted(ev.time_range.start for ev in evs
                       if ev.device_type == DeviceType.CPU
                       and ev.name.startswith("cu") and "Launch" in ev.name)
        if len(kernels) == len(calls) == CALLS:
            offsets.append(min(k - c for k, c in zip(kernels, calls)))
        else:
            short.append((i, len(kernels), len(calls)))
    offsets.sort()

    def q(f):
        return offsets[min(len(offsets) - 1, int(f * len(offsets)))]

    print(f"no pause: {args.windows} windows, {len(short)} short "
          f"(window, kernels, launch calls): {short[:8]}")
    print(f"  least (kernel start - launch call start), us: min "
          f"{offsets[0]:.1f}, p1 {q(.01):.1f}, p10 {q(.1):.1f}, p50 "
          f"{q(.5):.1f}, p90 {q(.9):.1f}, max {offsets[-1]:.1f}")
    bad = [got for got in (profiling.device_launches(fn, CALLS)
                           for _ in range(args.windows))
           if sum(n for n, _ in got.values()) != CALLS]
    print(f"pause {profiling.LAUNCH_EDGE_PAUSE_S} s: {args.windows} windows, "
          f"{len(bad)} short {bad[:4]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
