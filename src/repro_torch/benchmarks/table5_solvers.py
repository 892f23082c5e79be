"""Table 5: SRDS with other off-the-shelf solvers — DDPM with frozen
noise, DPM-Solver-2, DDIM (counterpart of
``benchmarks/table5_solvers.py``).  DDPM's noise is the port's native
frozen noise from ``NOISE_SEED`` (JAX's comes from ``PRNGKey(9)``, which
torch cannot draw; the CPU test hands it over through ``noise_fn``).
As in the JAX row, ``proj_speedup`` is the wavefront-pipelined sampler's
projection; ``proj_speedup_vanilla`` the single-program sampler's.

    PYTHONPATH=src python -m repro_torch.benchmarks.table5_solvers \\
        [--device cpu]
"""
from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import (emit, parser, resolve_device, run_pair, toy_array,
                     toy_denoiser)

CASES = [("ddpm", 961), ("ddpm", 196), ("dpm2", 196), ("dpm2", 25),
         ("ddim", 196), ("ddim", 25)]
NOISE_SEED = 9


def rows(model_fn, x0, cases=tuple(CASES), noise_seed=NOISE_SEED,
         noise_fn=None, repeats: int = 3):
    out = []
    for name, n in cases:
        sched = make_schedule("ddpm_linear", n)
        solver = SolverConfig(name, noise_seed=noise_seed, noise_fn=noise_fn)
        r = run_pair(model_fn, sched, solver, x0, SRDSConfig(tol=1e-3),
                     repeats=repeats)
        row = f"table5/{name}{n}"
        emit(row, r["t_srds"] * 1e6,
             f"seq_evals={r['seq_evals']};eff_serial={r['eff_serial']};"
             f"iters={r['iters']};err={r['err']:.1e};"
             f"proj_speedup={r['proj_speedup_pipelined']:.2f}x;"
             f"proj_speedup_vanilla={r['proj_speedup']:.2f}x")
        out.append(dict(name=row, n=n, solver=name, seq_evals=r["seq_evals"],
                        eff_serial=r["eff_serial"], total=r["total"],
                        eff_serial_pipelined=r["eff_serial_pipelined"],
                        proj_speedup_pipelined=r["proj_speedup_pipelined"],
                        iters=r["iters"], err=r["err"], t_srds_s=r["t_srds"],
                        t_seq_s=r["t_seq"]))
    return out


def main(device="cuda"):
    device = resolve_device(device)
    return rows(toy_denoiser(device), toy_array("x0_table5", device))


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
