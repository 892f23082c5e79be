#!/usr/bin/env python3
"""How far ``torch.profiler``'s device timestamps stray from its host
timestamps, and how often a window of DDIM calls loses launches at its
edges, with and without ``profiling.device_launches``' pause.

    python3 scripts/torch_profiler_edges.py [--windows N]
    python3 scripts/torch_profiler_edges.py --scan-late
    python3 scripts/torch_profiler_edges.py --scan-bwd-late [--repeats N]
                                            [--lead N]

Runs ``--windows`` profiler windows of 20 ``ddim_fused`` calls on the
fine step's shape (10, 64, 64, 4) with no pause: for each window whose 20
launch calls and 20 kernels were all traced, the least (kernel start - its
launch call's start), pairing the k-th call with the k-th kernel (a
negative value means the device's timestamps read early); and the windows
that traced fewer kernels than calls.  Then as many windows through
``device_launches`` (its pause at both ends), counting those not of 20
launches.

``--scan-bwd-late`` runs phase 3's cases up to the scan's forward, then
``chip_smoke.scan_backward_cases`` ``--repeats`` times, then ten times as
many bare windows of the backward at the training shape, and logs every
``profiling.window_launches`` window of them: the lead's launches with no
device record, and the places of the calls' launches with none.  It
prints every window that lacks a record of the calls' launches, and by
case the windows, those short, and how many lead records each lost;
``--lead`` sets ``profiling.LEAD_LAUNCHES`` for the run.

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


def scan_bwd_late(repeats: int, lead: int) -> int:
    """``--scan-bwd-late``: see the module's docstring."""
    from collections import defaultdict
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.runtime import profiling
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    print(f"build {_build.build_all():.1f} s", flush=True)
    if lead is not None:
        profiling.LEAD_LAUNCHES = lead
    print(f"lead launches a window: {profiling.LEAD_LAUNCHES}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    log, failed = [], []
    window = profiling.window_launches

    def logged(fn, calls, pause_s=profiling.LAUNCH_EDGE_PAUSE_S):
        got = window(fn, calls, pause_s)
        log.append(dict(label="?", api=got["api"], lead_lost=got["lead_lost"],
                        missing=got["missing"]))
        return got

    profiling.window_launches = logged
    check = cs.print_readings

    def print_readings(label, timing, reading, launches):
        log[-1]["label"] = label
        try:
            check(label, timing, reading, launches)
        except AssertionError as err:
            failed.append(str(err))

    cs.print_readings = print_readings
    cases = defaultdict(list)
    cs.masked_flash_cases(torch, ops, ref, randn, cases)
    cs.backward_cases(torch, ref, randn, cases)
    cs.masked_backward_cases(torch, ref, randn, cases)
    cs.elementwise_cases(torch, ops, ref, randn, cases)
    cs.wkv_readings(torch)
    cs.wkv_cases(torch, ops, ref, randn, cases)
    cs.wkv_backward_cases(torch, ref, randn, cases)
    cs.scan_cases(torch, ops, randn, cases)
    for r in range(repeats):
        print(f"scan_backward_cases, round {r}", flush=True)
        cs.scan_backward_cases(torch, ref, randn, defaultdict(list))
    x = cs.scan_inputs(torch, randn, 2, 2048, 1600, 16, True)
    dy = randn((2, 2048, 1600))
    _, _, ckpt = scan.selective_scan(*x, checkpoints=True)

    def bwd():
        return scan.selective_scan_bwd(*x[:6], ckpt, dy, None)

    bwd()
    for _ in range(repeats * 10):
        logged(bwd, cs.LAUNCH_WINDOW_CALLS)
        log[-1]["label"] = "bare T=2048"
    for w in log:
        if w["missing"]:
            print(f"  short window: {w}", flush=True)
    by = defaultdict(lambda: [0, 0, defaultdict(int)])
    for w in log:
        by[w["label"]][0] += 1
        by[w["label"]][1] += bool(w["missing"])
        by[w["label"]][2][w["lead_lost"]] += 1
    print(f"windows by case (all, short, {{lead records lost of "
          f"{profiling.LEAD_LAUNCHES}: windows}}): " + "; ".join(
              f"{k}: {n}, {s}, {dict(lost)}" for k, (n, s, lost)
              in by.items()), flush=True)
    print(f"checks failed: {len(failed)} {failed}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=500)
    ap.add_argument("--scan-late", action="store_true")
    ap.add_argument("--scan-bwd-late", action="store_true")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--lead", type=int, default=None)
    args = ap.parse_args()
    if args.scan_late:
        return scan_late()
    if args.scan_bwd_late:
        return scan_bwd_late(args.repeats, args.lead)
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
