"""Sweep driver (counterpart of ``repro.launch.dryrun_all``): every (arch x
shape x mesh) dry-run cell, each in its own subprocess (crash-safe,
parallel).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all --mesh pod1 --jobs 3
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from repro_torch.configs import get_arch, shape_cells
from repro_torch.launch.dryrun import DEFAULT_OUT

ASSIGNED = ["stablelm-3b", "qwen1.5-32b", "qwen3-8b", "qwen3-14b",
            "phi-3-vision-4.2b", "rwkv6-1.6b", "hymba-1.5b", "arctic-480b",
            "kimi-k2-1t-a32b", "hubert-xlarge"]
DIT = ["srds-dit-cifar", "srds-dit-lsun", "srds-dit-sd2"]
# the optimized profile (``--opt``)
OPT_OVERRIDES = ("remat_policy=nothing", "moe_fixed_capacity=True")


def all_cells(meshes):
    cells = []
    for a in ASSIGNED:
        cfg = get_arch(a)
        for s in shape_cells(cfg):
            for m in meshes:
                cells.append((a, s.name, m))
    for a in DIT:
        for m in meshes:
            cells.append((a, "sample", m))
    return cells


def run_one(arch, shape, mesh, out_dir, timeout, extra_args=()):
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if os.path.exists(path):
        return (arch, shape, mesh, "cached", 0.0)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out_dir, *extra_args]
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
        status = "ok" if r.returncode == 0 else "FAIL"
        if status == "FAIL":
            with open(path.replace(".json", ".err"), "w") as f:
                f.write(r.stdout[-4000:] + "\n--- stderr ---\n"
                        + r.stderr[-8000:])
    except subprocess.TimeoutExpired:
        status = "TIMEOUT"
    return (arch, shape, mesh, status, time.time() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--opt", action="store_true",
                    help="the optimized profile: remat_policy=nothing, "
                         "moe_fixed_capacity=True")
    args = ap.parse_args(argv)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    cells = all_cells(meshes)
    print(f"{len(cells)} cells, {args.jobs} workers")
    extra = []
    if args.opt:
        for o in OPT_OVERRIDES:
            extra += ["--override", o]
    results = []
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        futs = {pool.submit(run_one, a, s, m, args.out, args.timeout,
                            tuple(extra)): (a, s, m)
                for a, s, m in cells}
        for fut in as_completed(futs):
            a, s, m, status, dt = fut.result()
            print(f"[{status:7s}] {a} x {s} x {m}  ({dt:.0f}s)", flush=True)
            results.append((a, s, m, status))
    bad = [r for r in results if r[3] not in ("ok", "cached")]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells passed")
    for r in bad:
        print("FAILED:", r)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
