"""Table 4: SRDS against ParaDiGMS at thresholds 1e-3/1e-2/1e-1 — the
Picard sweeps (ParaDiGMS's effective serial evals) and wall seconds on
one device (counterpart of ``benchmarks/table4_paradigms.py``).  As in
the JAX row, ``srds_eff`` and ``srds_proj`` price the wavefront-pipelined
sampler; ``srds_eff_vanilla`` is the single-program sampler's.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4_paradigms \\
        [--device cpu]
"""
from repro_torch.core import (ParaDiGMSConfig, SolverConfig, SRDSConfig,
                              make_schedule, paradigms_sample)

from .common import (emit, parser, resolve_device, run_pair, timeit,
                     toy_array, toy_denoiser)

CASES = [(961, 31), (196, 14), (25, 5)]      # (N, SRDS blocks)
PD_TOLS = (1e-3, 1e-2, 1e-1)
MAX_WINDOW = 64


def rows(model_fn, x0, cases=tuple(CASES), tols=PD_TOLS, repeats: int = 3):
    """One row per ``(N, B)``: SRDS's counts and ParaDiGMS's sweeps and
    total evals at each tolerance (window ``min(N, 64)``)."""
    out = []
    for n, b in cases:
        sched = make_schedule("ddpm_linear", n)
        solver = SolverConfig("ddim")
        r = run_pair(model_fn, sched, solver, x0,
                     SRDSConfig(tol=1e-3, num_blocks=b), repeats=repeats)
        pd = {}
        for tol in tols:
            def fn(tol=tol):
                return paradigms_sample(
                    model_fn, sched, solver, x0,
                    ParaDiGMSConfig(window=min(n, MAX_WINDOW), tol=tol))
            t = timeit(fn, repeats=repeats, device=x0.device)
            res = fn()
            pd[tol] = (res.iterations, res.total_evals, t)
        name = f"table4/ddim{n}"
        emit(name, r["t_srds"] * 1e6,
             f"srds_iters={r['iters']};srds_eff={r['eff_serial_pipelined']};"
             f"srds_proj={r['proj_speedup_pipelined']:.2f}x;"
             f"srds_eff_vanilla={r['eff_serial']};"
             + ";".join(f"paradigms@{k:g}:eff={v[0]},proj={n/max(v[0],1):.2f}x"
                        for k, v in pd.items()))
        out.append(dict(name=name, n=n, blocks=b, srds_iters=r["iters"],
                        srds_eff_serial=r["eff_serial"],
                        srds_total=r["total"],
                        srds_eff_pipelined=r["eff_serial_pipelined"],
                        srds_proj_pipelined=r["proj_speedup_pipelined"],
                        t_srds_s=r["t_srds"],
                        paradigms={k: dict(iterations=v[0], total_evals=v[1],
                                           t_s=v[2]) for k, v in pd.items()}))
    return out


def main(device="cuda"):
    device = resolve_device(device)
    return rows(toy_denoiser(device), toy_array("x0_table4", device))


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
