"""The roofline table of the dry run's cells (counterpart of the JAX
package's ``benchmarks/roofline.py``): one row per JSON file that
:mod:`repro_torch.launch.dryrun` (or JAX's dry run: the keys are the same)
wrote, and the tally of dominant terms.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline \
      [--dir experiments/dryrun_torch] [--md F]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

# repro_torch.launch.dryrun's default output directory
DEFAULT_OUT = "experiments/dryrun_torch"


def load_cells(d: str):
    cells = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def fmt_row(c) -> str:
    r = c["roofline"]
    mem = c.get("memory_analysis", {})
    peak = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
    uf = r.get("useful_fraction")
    return ("| {arch} | {shape} | {mesh} | {c:.4f} | {m:.4f} | {x:.4f} | "
            "{dom} | {uf} | {peak:.1f} |").format(
        arch=c["arch"], shape=c["shape"], mesh=c["mesh"],
        c=r["compute_s"], m=r["memory_s"], x=r["collective_s"],
        dom=r["dominant"].replace("_s", ""),
        uf=f"{uf:.2f}" if uf else "-",
        peak=peak / 2 ** 30)


def table(cells) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "dominant | useful_frac | peak_GiB/dev |")
    sep = "|" + "---|" * 9
    return "\n".join([hdr, sep] + [fmt_row(c) for c in cells])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--md", default=None, help="write markdown table here")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    out = table(cells)
    print(out)
    doms = {}
    for c in cells:
        doms[c["roofline"]["dominant"]] = doms.get(c["roofline"]["dominant"],
                                                   0) + 1
    print(f"\n# {len(cells)} cells; dominant-term counts: {doms}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
