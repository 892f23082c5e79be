#!/usr/bin/env python3
"""How far ``torch.profiler``'s device timestamps stray from its host
timestamps, and how often a window of DDIM calls loses launches at its
edges, with and without ``profiling.device_launches``' pause.

    python3 scripts/torch_profiler_edges.py [--windows N]

Runs ``--windows`` profiler windows of 20 ``ddim_fused`` calls on the
fine step's shape (10, 64, 64, 4) with no pause: for each window whose 20
launch calls and 20 kernels were all traced, the least (kernel start - its
launch call's start), pairing the k-th call with the k-th kernel (a
negative value means the device's timestamps read early); and the windows
that traced fewer kernels than calls.  Then as many windows through
``device_launches`` (its pause at both ends), counting those not of 20
launches.  Needs one CUDA card.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=500)
    args = ap.parse_args()
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
