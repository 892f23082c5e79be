"""Paper Prop 4 (Appendix B): block-size sweep — the per-iteration cost
N/B + B is least near B = sqrt(N); measured iterations included
(counterpart of ``benchmarks/prop4_blocksize.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.prop4_blocksize \\
        [--device cpu]
"""
from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import (emit, parser, resolve_device, run_pair, toy_array,
                     toy_denoiser)

N = 256
BLOCKS = (4, 8, 16, 32, 64)


def rows(model_fn, x0, n: int = N, blocks=BLOCKS, repeats: int = 3):
    sched = make_schedule("ddpm_linear", n)
    out = []
    for b in blocks:
        r = run_pair(model_fn, sched, SolverConfig("ddim"), x0,
                     SRDSConfig(tol=1e-3, num_blocks=b), repeats=repeats)
        name = f"prop4/B{b}"
        emit(name, r["t_srds"] * 1e6,
             f"iters={r['iters']};eff_serial={r['eff_serial']};"
             f"per_iter={n//b + b};err={r['err']:.1e}")
        out.append(dict(name=name, n=n, blocks=b, iters=r["iters"],
                        eff_serial=r["eff_serial"], total=r["total"],
                        per_iter=n // b + b, err=r["err"],
                        t_srds_s=r["t_srds"]))
    return out


def main(device="cuda"):
    device = resolve_device(device)
    return rows(toy_denoiser(device), toy_array("x0_prop4", device))


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
