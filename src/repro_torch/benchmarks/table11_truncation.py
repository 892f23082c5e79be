"""Table 11: converged-prefix truncation — physical model evals per
sample, truncated vs untruncated, on the pinned N=100 config (counterpart
of ``benchmarks/table11_truncation.py``).

The deterministic counts (``iterations``, ``evals_*``, ``serial_*``)
come from the engine's own accounting and must equal the JAX package's
(``check_counts``); ``t_*`` are wall-clock medians on the device run.  The
truncated run is asserted equivalent (same iteration count, samples to
1e-4) before anything is reported; ``bit_identical`` is measured.

    PYTHONPATH=src python -m repro_torch.benchmarks.table11_truncation \\
        [--device cpu] [--out BENCH_torch.json]

Writes a fresh artifact (``schema: 1``); table12 and table13 append to it.
"""
import json

import torch

from repro_torch.core import (SolverConfig, SRDSConfig, iteration_cost,
                              make_schedule, predicted_evals, srds_sample,
                              srds_stats, truncated_evals)

from .common import emit, meta, parser, resolve_device, timeit, toy_array, \
    toy_denoiser

# the pinned config: N=100 -> B=10 blocks of S=10 fine steps, the 16-dim
# toy denoiser, ddim
N = 100
DIM = 16
SEED = 0
TOLS = [0.0, 1e-5, 1e-3]     # exactness budget + two early-exit points


def run_rows(n: int = N, tols=tuple(TOLS), device="cuda", repeats: int = 3):
    device = resolve_device(device)
    model_fn = toy_denoiser(device)
    x0 = toy_array("x0_table11", device)
    sched = make_schedule("ddpm_linear", n)
    solver = SolverConfig("ddim")
    cost = iteration_cost(n, None, 1)
    rows = []
    for tol in tols:
        cfg_u = SRDSConfig(tol=tol)
        cfg_t = SRDSConfig(tol=tol, truncate=True)

        def samp_u(c=cfg_u):
            return srds_sample(model_fn, sched, solver, x0, c)

        def samp_t(c=cfg_t):
            return srds_sample(model_fn, sched, solver, x0, c)

        res_u, res_t = samp_u(), samp_t()
        assert int(res_u.iterations) == int(res_t.iterations), (
            f"truncated run diverged at tol={tol}: iters "
            f"{int(res_t.iterations)} vs {int(res_u.iterations)}")
        max_diff = float((res_u.sample - res_t.sample).abs().max())
        # f32 matmul-denoiser roundoff over ~100 steps; a truncation bug
        # is O(1)
        assert max_diff < 1e-4, f"tol={tol}: truncated drifted {max_diff}"
        bit_identical = bool(torch.equal(res_u.sample, res_t.sample))
        k = int(res_u.iterations)
        ev_u = predicted_evals(cost, k)
        ev_t = truncated_evals(cost, k)
        t_u = timeit(samp_u, repeats=repeats, device=device)
        t_t = timeit(samp_t, repeats=repeats, device=device)
        st_u = srds_stats(sched, solver, cfg_u, k)
        st_t = srds_stats(sched, solver, cfg_t, k)
        name = f"table11/n{n}_tol{tol:g}"
        saving = 100.0 * (1.0 - ev_t / ev_u)
        emit(name, t_t * 1e6,
             f"iters={k};evals={ev_t}vs{ev_u};saving={saving:.1f}%;"
             f"wallclock={t_t:.4f}s_vs_{t_u:.4f}s;bit_identical={bit_identical}")
        rows.append(dict(
            name=name, n=n, tol=tol, iterations=k,
            evals_untruncated=ev_u, evals_truncated=ev_t,
            evals_saving_pct=saving,
            serial_untruncated=st_u.serial_evals,
            serial_truncated=st_t.serial_evals,
            t_untruncated_s=t_u, t_truncated_s=t_t,
            wallclock_saving_pct=100.0 * (1.0 - t_t / t_u),
            bit_identical=bit_identical, max_abs_diff=max_diff))
    return rows


def main(out: str = None, n: int = N, device="cuda"):
    device = resolve_device(device)
    rows = run_rows(n=n, device=device)
    # the acceptance bar: >= 25% fewer physical evals on the pinned
    # exactness-budget row (tol=0 runs to the cap)
    head = rows[0]
    assert head["evals_saving_pct"] >= 25.0, head
    payload = {"schema": 1,
               "meta": dict(meta(device), pinned={
                   "n": n, "dim": DIM, "seed": SEED, "tols": list(TOLS)}),
               "rows": rows}
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {out}")
    return payload


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here")
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    main(out=args.out, n=args.n, device=resolve_device(args.device))
