"""Table 13: Anderson fixed-point acceleration — Parareal iterations to
tolerance, plain against ``AndersonAccel``, at equal tolerance on the
pinned slowly-converging N=100 config (counterpart of
``benchmarks/table13_accel.py``).

The toy is the JAX emitter's time-varying linear model with per-dim
oscillating contraction rates; its parameters (``w``, ``ph``, ``a``) come
from ``toy_inputs.npz``.  Both arms run untruncated.  Asserted before
anything is reported: ``accel=NoAccel()`` is bit-identical to the default
engine, the accelerated run never takes more iterations than plain, and
its error against the serial solve stays within ``err_bound``.  The
headline (>= 25% fewer iterations on the first row) is recorded as
``headline_met`` and gated by ``check_counts``: the JAX package itself
misses it on this tree (ROADMAP C5), so it does not stop the emitter.

    PYTHONPATH=src python -m repro_torch.benchmarks.table13_accel \\
        [--device cpu] [--out BENCH_torch.json]
"""
import numpy as np
import torch

from repro_torch.core import (AndersonAccel, NoAccel, SolverConfig,
                              SRDSConfig, iteration_cost, make_schedule,
                              predicted_evals, sample_sequential,
                              srds_sample)

from .common import (emit, merge_out, parser, resolve_device, timeit,
                     toy_array)

# the pinned config: N=100 -> B=10 x S=10, cosine schedule, ddim, the
# 16-dim slow toy, f32 (the counts are knife-edge sensitive to precision)
N = 100
DIM = 16
AMP, FREQ = 2.0, 2.0
SEED = 1
DEPTH, WARMUP = 5, 2
# (tol, err-bound multiple): loose headline tolerance + a tight one
TOLS = [(3.0, 5.0), (0.1, 1.0)]
HEADLINE_SAVING_PCT = 25.0


def slow_model(device="cuda"):
    """The JAX emitter's ``slow_model()`` (AMP, FREQ, DIM pinned): x (M,
    16), t (M,)."""
    device = resolve_device(device)
    w, ph, a = (toy_array(k, device) for k in ("slow_w", "slow_ph",
                                                "slow_a"))

    def model_fn(x, t):
        return (a * torch.sin(w * t[:, None] * 0.06 + ph) * x).to(
            torch.float32)

    return model_fn


def run_rows(n: int = N, tols=tuple(TOLS), device="cuda", repeats: int = 3):
    device = resolve_device(device)
    model_fn = slow_model(device)
    sched = make_schedule("cosine", n).astype(np.float32)
    solver = SolverConfig("ddim")
    x0 = toy_array("x0_table13", device).reshape(1, DIM)
    cost = iteration_cost(n, None, 1)
    ref = sample_sequential(model_fn, sched, solver, x0)
    acc = AndersonAccel(depth=DEPTH, warmup=WARMUP)

    def sample_with(cfg):
        return lambda c=cfg: srds_sample(model_fn, sched, solver, x0, c)

    # NoAccel bit-identity: the seam's default must not perturb the engine
    head_tol = tols[0][0]
    res_d = sample_with(SRDSConfig(tol=head_tol))()
    res_0 = sample_with(SRDSConfig(tol=head_tol, accel=NoAccel()))()
    bit_identical = (
        torch.equal(res_d.sample, res_0.sample)
        and int(res_d.iterations) == int(res_0.iterations)
        and torch.equal(res_d.delta_history, res_0.delta_history))
    assert bit_identical, (
        f"NoAccel diverged from the default engine at n={n}: iters "
        f"{int(res_0.iterations)} vs {int(res_d.iterations)}")

    rows = []
    for tol, mult in tols:
        samp_p = sample_with(SRDSConfig(tol=tol))
        samp_a = sample_with(SRDSConfig(tol=tol, accel=acc))
        res_p, res_a = samp_p(), samp_a()
        ip, ia = int(res_p.iterations), int(res_a.iterations)
        assert ia <= ip, (
            f"n={n} tol={tol}: acceleration cost iterations ({ia} > {ip})")
        err_p = float((res_p.sample - ref).abs().max())
        err_a = float((res_a.sample - ref).abs().max())
        bound = mult * tol
        assert err_a <= bound, (
            f"n={n} tol={tol}: accelerated error {err_a} exceeds "
            f"bound {bound}")
        ev_p = predicted_evals(cost, ip)
        ev_a = predicted_evals(cost, ia)
        t_p = timeit(samp_p, repeats=repeats, device=device)
        t_a = timeit(samp_a, repeats=repeats, device=device)
        name = f"table13/n{n}_tol{tol:g}"
        saving = 100.0 * (1.0 - ia / ip)
        emit(name, t_a * 1e6,
             f"iters={ia}vs{ip}plain;saving={saving:.1f}%;"
             f"evals={ev_a}vs{ev_p};err={err_a:.2e}vs{err_p:.2e}plain;"
             f"bit_identical={bit_identical}")
        rows.append(dict(
            name=name, n=n, tol=tol,
            accel=f"anderson(depth={DEPTH},warmup={WARMUP})",
            iters_plain=ip, iters_accel=ia, iters_saving_pct=saving,
            evals_plain=ev_p, evals_accel=ev_a,
            max_err_plain=err_p, max_err_accel=err_a, err_bound=bound,
            bit_identical=bit_identical, t_plain_s=t_p, t_accel_s=t_a))
    # the tentpole claim, on the first (headline) row
    rows[0]["headline_met"] = rows[0]["iters_saving_pct"] >= \
        HEADLINE_SAVING_PCT
    if not rows[0]["headline_met"]:
        print(f"# {rows[0]['name']}: {rows[0]['iters_saving_pct']:.1f}% "
              f"fewer iterations, under the {HEADLINE_SAVING_PCT:g}% "
              f"headline (check_counts decides)", flush=True)
    return rows


def main(out: str = None, n: int = N, device="cuda"):
    device = resolve_device(device)
    rows = run_rows(n=n, device=device)
    return merge_out(out, rows, "pinned_accel",
                     {"n": n, "dim": DIM, "seed": SEED, "amp": AMP,
                      "freq": FREQ, "schedule": "cosine",
                      "depth": DEPTH, "warmup": WARMUP,
                      "tols": [t for t, _ in TOLS]}, device)


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--out", default=None,
                    help="JSON artifact to append rows into")
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    main(out=args.out, n=args.n, device=resolve_device(args.device))
