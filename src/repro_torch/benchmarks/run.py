"""Run every paper-table emitter the port has (counterpart of
``benchmarks/run.py``), printing ``name,us_per_call,derived`` CSV lines.
A table that fails prints a ``FAILED`` row and the run goes on; the exit
code is non-zero if any table failed.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
"""
import sys
import time

from . import (prop4_blocksize, table1_pixel, table2_sd, table3_pipelined,
               table4_paradigms, table5_solvers, table6_devices,
               table8_tolerance, table9_batched, table10_slo,
               table10_wallclock, table11_truncation, table12_window,
               table13_accel)
from .common import parser, resolve_device

TABLES = [
    ("table1 (pixel diffusion, N=1024)", table1_pixel.main),
    ("table2 (SD-like latent, vanilla SRDS)", table2_sd.main),
    ("table3 (pipelined SRDS)", table3_pipelined.main),
    ("table4 (vs ParaDiGMS)", table4_paradigms.main),
    ("table5 (other solvers)", table5_solvers.main),
    ("table6 (device scaling)", table6_devices.main),
    ("table8 (tolerance ablation)", table8_tolerance.main),
    ("table9 (batched serving)", table9_batched.main),
    ("table10 (SLO scheduling)", table10_slo.main),
    ("table10w (wall-clock SLO scheduling)", table10_wallclock.main),
    ("table11 (prefix truncation)", table11_truncation.main),
    ("table12 (residual windows)", table12_window.main),
    ("table13 (acceleration)", table13_accel.main),
    ("prop4 (block-size optimum)", prop4_blocksize.main),
]


def main(device="cuda") -> int:
    """Every table's ``main`` on ``device``; returns the number that
    failed."""
    device = resolve_device(device)
    print("name,us_per_call,derived")
    failed = 0
    for title, fn in TABLES:
        print(f"# --- {title} ---", flush=True)
        t0 = time.time()
        try:
            fn(device=device)
        except Exception as e:  # keep the suite going; report the failure
            failed += 1
            print(f"{title},-1,FAILED:{type(e).__name__}:{e}", flush=True)
        print(f"# {title} done in {time.time() - t0:.0f}s", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main(device=resolve_device(
        parser(__doc__).parse_args().device)) else 0)
