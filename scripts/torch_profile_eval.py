#!/usr/bin/env python3
"""Where one DiT eval's device time goes, for the PyTorch port on a GPU.

    python3 scripts/torch_profile_eval.py [--batch 10 2] [--reps 3]

Builds ``srds-dit-sd2`` at full width and depth with random weights (as
``chip_smoke.py`` does), warms it, then runs ``--reps`` evals per batch
size under ``torch.profiler`` and prints, per eval: the wall time (host
clock around synchronized work), the device time summed over kernels, the
device's busy share of the wall time, and the device time by kernel group
(the port's flash kernel, GEMMs, the rest) and by kernel name.  Batch 10
is SRDS's fine step (B=5 blocks x K=2 samples), batch 2 its coarse step
and the sequential sampler's step.  Needs one CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


# CUPTI reports a stall of the launch queue as an event of its own; it is
# not a kernel and its time overlaps the kernels'
_NOT_KERNELS = ("Command Buffer Full",)


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention_fwd (port)"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "gemm (cuBLAS)"
    return "other (elementwise, norms, copies)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[10, 2])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import dit

    if not torch.cuda.is_available():
        print("torch_profile_eval: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    cfg = get_arch("srds-dit-sd2")
    model = dit.load_jax_params(cfg, dit.random_jax_tree(cfg, seed=0),
                                device="cuda")
    fn = dit.make_denoiser(model)
    rng = np.random.default_rng(0)
    for batch in args.batch:
        x = torch.from_numpy(rng.standard_normal(
            (batch, 64, 64, 4)).astype(np.float32)).cuda()
        t = torch.full((batch,), 500.0, device="cuda")
        fn(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn(x, t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps
        by_name = defaultdict(float)
        for evt in prof.key_averages():
            # device-side events only: a CPU op's device time repeats the
            # time of the kernels it launched
            if evt.device_type != DeviceType.CUDA or evt.key in _NOT_KERNELS:
                continue
            by_name[evt.key] += evt.self_device_time_total / 1e3 / args.reps
        dev_ms = sum(by_name.values())
        print(f"batch {batch}: wall {wall_ms:.3f} ms per eval, device "
              f"{dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f}")
        groups = defaultdict(float)
        for name, ms in by_name.items():
            groups[_group(name)] += ms
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {g}: {ms:.3f} ms ({ms / max(dev_ms, 1e-9):.3f})")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:8.3f} ms  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
