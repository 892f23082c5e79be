"""Table 8 (Appendix F): tolerance ablation — iterations and effective
serial evals against tau; KID is replaced by the error against the
sequential solve (counterpart of ``benchmarks/table8_tolerance.py``).
The small DiT's weights are drawn from a numpy seed.

    PYTHONPATH=src python -m repro_torch.benchmarks.table8_tolerance \\
        [--device cpu]
"""
from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import (emit, parser, resolve_device, run_pair, small_dit,
                     toy_array)

N = 1024
BLOCKS = 32
TAUS = (1e-2, 1e-3, 1e-4)


def rows(model_fn, x0, n: int = N, blocks: int = BLOCKS, taus=TAUS,
         repeats: int = 3):
    sched = make_schedule("ddpm_linear", n)
    out = []
    for tau in taus:
        r = run_pair(model_fn, sched, SolverConfig("ddim"), x0,
                     SRDSConfig(tol=tau, num_blocks=blocks),
                     repeats=repeats)
        name = f"table8/tau{tau:g}"
        emit(name, r["t_srds"] * 1e6,
             f"iters={r['iters']};eff_serial={r['eff_serial']};"
             f"total={r['total']};err_vs_seq={r['err']:.2e}")
        out.append(dict(name=name, n=n, tau=tau, iters=r["iters"],
                        eff_serial=r["eff_serial"], total=r["total"],
                        err=r["err"], t_srds_s=r["t_srds"]))
    return out


def main(device="cuda"):
    device = resolve_device(device)
    model_fn, _, _ = small_dit(layers=1, d=32, img=16, seed=5,
                               device=device)
    return rows(model_fn, toy_array("x0_table8", device))


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
