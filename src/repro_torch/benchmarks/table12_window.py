"""Table 12: the residual-driven sliding window — evals per sample and
error against the serial solve for ``window_tol`` sweeps, against the
exact ``ExactPrefix`` frontier, at N=100 and N=1000 (counterpart of
``benchmarks/table12_window.py``).

Per row: ``evals_window`` (the realized window schedule priced by
``windowed_evals``), ``evals_exact_prefix`` (``truncated_evals``) and
``evals_flat`` (no truncation), all deterministic, and
``max_err_window`` against the exact engine's ``max_err_exact``, asserted
bounded.  The ``ExactPrefix`` policy run is first asserted identical to
the ``truncate=True`` engine (``bit_identical_exact``).

    PYTHONPATH=src python -m repro_torch.benchmarks.table12_window \\
        [--device cpu] [--out BENCH_torch.json]
"""
import torch

from repro_torch.core import (ExactPrefix, ResidualWindow, SolverConfig,
                              SRDSConfig, iteration_cost, make_schedule,
                              predicted_evals, sample_sequential,
                              srds_sample, truncated_evals, windowed_evals)

from .common import (emit, merge_out, parser, resolve_device, timeit,
                     toy_array, toy_denoiser)

# pinned configs: N=100 -> B=10 x S=10; N=1000 -> B=25 x S=40, capped at
# 8 refinements
CONFIGS = [dict(n=100, max_iters=None), dict(n=1000, max_iters=8)]
DIM = 16
SEED = 0
TOL = 1e-4                        # convergence tolerance of every run
WINDOW_TOLS = [1e-2, 1e-3, 1e-4]  # the approximation knob sweep


def run_rows(n: int, max_iters=None, window_tols=tuple(WINDOW_TOLS),
             device="cuda", repeats: int = 3):
    device = resolve_device(device)
    model_fn = toy_denoiser(device)
    x0 = toy_array("x0_table12", device)
    sched = make_schedule("ddpm_linear", n)
    solver = SolverConfig("ddim")
    cost = iteration_cost(n, None, 1)
    ref = sample_sequential(model_fn, sched, solver, x0)

    def sample_with(cfg):
        return lambda c=cfg: srds_sample(model_fn, sched, solver, x0, c)

    # the exact side: the truncate engine vs the ExactPrefix policy
    res_t = sample_with(SRDSConfig(tol=TOL, max_iters=max_iters,
                                   truncate=True))()
    res_e = sample_with(SRDSConfig(tol=TOL, max_iters=max_iters,
                                   window=ExactPrefix()))()
    bit_identical_exact = (
        torch.equal(res_t.sample, res_e.sample)
        and int(res_t.iterations) == int(res_e.iterations)
        and torch.equal(res_t.delta_history, res_e.delta_history))
    assert bit_identical_exact, (
        f"ExactPrefix policy diverged from the truncate=True engine at "
        f"n={n}: iters {int(res_e.iterations)} vs {int(res_t.iterations)}")
    k_exact = int(res_t.iterations)
    ev_flat = predicted_evals(cost, k_exact)
    ev_exact = truncated_evals(cost, k_exact)
    err_exact = float((res_t.sample - ref).abs().max())

    rows = []
    for wt in window_tols:
        samp_w = sample_with(SRDSConfig(tol=TOL, max_iters=max_iters,
                                        window=ResidualWindow(wt)))
        res_w = samp_w()
        k = int(res_w.iterations)
        ev_w = int(windowed_evals(cost, res_w.window_history.cpu().numpy()))
        err_w = float((res_w.sample - ref).abs().max())
        # the approximation contract: drift bounded by the knob plus the
        # convergence-tolerance floor; a window bug is O(1)
        bound = 20.0 * (wt + TOL) + 10.0 * err_exact
        assert err_w <= bound, (
            f"n={n} window_tol={wt}: trajectory error {err_w} exceeds "
            f"bound {bound}")
        t_w = timeit(samp_w, repeats=repeats, device=device)
        name = f"table12/n{n}_wtol{wt:g}"
        saving = 100.0 * (1.0 - ev_w / ev_exact)
        emit(name, t_w * 1e6,
             f"iters={k};evals={ev_w}vs{ev_exact}exact/{ev_flat}flat;"
             f"saving_vs_exact={saving:.1f}%;err={err_w:.2e};"
             f"bit_identical_exact={bit_identical_exact}")
        rows.append(dict(
            name=name, n=n, tol=TOL, window_tol=wt, iterations=k,
            evals_flat=ev_flat, evals_exact_prefix=ev_exact,
            evals_window=ev_w, evals_saving_pct=saving,
            max_err_exact=err_exact, max_err_window=err_w, err_bound=bound,
            bit_identical_exact=bit_identical_exact, t_window_s=t_w))
    # the tentpole claim: the window at window_tol=1e-3 does strictly
    # fewer evals per sample than the provable exact prefix
    for r in rows:
        if r["window_tol"] == 1e-3:
            assert r["evals_window"] < r["evals_exact_prefix"], r
    return rows


def main(out: str = None, configs=None, device="cuda"):
    device = resolve_device(device)
    rows = []
    for cfg in (configs if configs is not None else CONFIGS):
        rows.extend(run_rows(device=device, **cfg))
    return merge_out(out, rows, "pinned_window",
                     {"configs": CONFIGS, "dim": DIM, "seed": SEED,
                      "tol": TOL, "window_tols": WINDOW_TOLS}, device)


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--out", default=None,
                    help="JSON artifact to append rows into")
    ap.add_argument("--n", type=int, default=None,
                    help="run a single grid size instead of the pinned set")
    args = ap.parse_args()
    cfgs = None
    if args.n is not None:
        cfgs = [c for c in CONFIGS if c["n"] == args.n] \
            or [dict(n=args.n, max_iters=8)]
    main(out=args.out, configs=cfgs, device=resolve_device(args.device))
