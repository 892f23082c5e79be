#!/usr/bin/env python3
"""The WKV kernels alone on the card: phase 3's WKV checks and times of
``chip_smoke.py``, without the rest of the run.

    python3 scripts/torch_wkv_bench.py [--src DIR]

Builds ``csrc/rwkv6_wkv.cu`` of the port under ``--src`` (default: this
checkout's ``src``; another checkout's, such as its parent commit's
unpacked by ``git archive``, to compare two versions in one call) and runs
``chip_smoke.py``'s ``wkv_readings`` (ptxas' registers and spills, grid
and blocks per SM; skipped for a wrapper without ``launch_info``),
``wkv_cases`` and ``wkv_backward_cases``: the same cases, inputs, limits
and controls as phase 3, each held against the plain scan and run twice
(bitwise equal), each timed with CUDA events.  A case that misses its
limit raises, as in phase 3.  Needs one CUDA card.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # puts ROOT/src on the path
    sys.path.insert(0, os.path.abspath(args.src))   # ahead of it
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops, ref, rwkv6_scan

    print(f"{cs.smi_line()}; torch {torch.__version__}; src {args.src}",
          flush=True)
    print(f"  chunk() = {rwkv6_scan.chunk()}", flush=True)   # builds
    if hasattr(rwkv6_scan, "launch_info"):
        cs.wkv_readings(torch)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cases = {"rwkv6_wkv": [], "rwkv6_wkv_bwd": []}
    cs.wkv_cases(torch, ops, ref, randn, cases)
    cs.wkv_backward_cases(torch, ref, randn, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
