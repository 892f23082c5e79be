"""Table 10: SLO scheduling — latency percentiles, SLO attainment and
goodput of the arrival-aware sampling service under FIFO, EDF and
cost-model admission (counterpart of ``benchmarks/table10_slo.py``).

A seeded arrival trace (Poisson steady load and a bursty herd) of two
tiers — 96% loose-tolerance, tight-SLO requests and 4% tight-tolerance,
loose-SLO ones — is replayed through ``repro_torch.serve.simulate`` on
the engine's virtual clock (physical model evals x ``sec_per_eval``), so
every number is reproducible.  FIFO's head-of-line blocking inflates p95;
EDF's deadline order dodges it (the emitter asserts it on Poisson), and
the cost model also sheds hopeless requests under overload.  Noise as in
``table9_batched``: the card's rows equal the CPU's.

    PYTHONPATH=src python -m repro_torch.benchmarks.table10_slo \\
        [--device cpu]
"""
import torch

from repro_torch.core import SolverConfig
from repro_torch.serve import (EDF, FIFO, CostAware, DiffusionSamplingEngine,
                               Tier, bursty_trace, poisson_trace, simulate)

from .common import emit, host_noise, parser, resolve_device, toy_denoiser

N = 64                    # grid -> B=8 blocks of S=8 fine steps
BATCH = 2
SEC_PER_EVAL = 1e-5
TIERS = [Tier(tol=1e-2, slo_ms=25, iters_hint=2, weight=0.96),
         Tier(tol=1e-6, slo_ms=400, iters_hint=8, weight=0.04)]


def make_traces(n_requests: int, rate: float):
    """Both trace shapes, pinned to seed 0."""
    return {
        "poisson": poisson_trace(n_requests, rate, TIERS, seed=0),
        "burst": bursty_trace(max(n_requests // 20, 1), 20, period=0.08,
                              tiers=TIERS, seed=0, jitter=0.005),
    }


def main(n_requests: int = 100, rate: float = 380.0, device="cuda",
         noise_fn=host_noise, dtype=torch.float32):
    device = resolve_device(device)
    model_fn = toy_denoiser(device, dtype)
    eng = DiffusionSamplingEngine(model_fn, (16,), SolverConfig("ddim"),
                                  num_steps=N, batch_size=BATCH,
                                  sec_per_eval=SEC_PER_EVAL, device=device,
                                  noise_fn=noise_fn, dtype=dtype)
    rows = []
    p95 = {}
    for tname, trace in make_traces(n_requests, rate).items():
        for policy in (FIFO(), EDF(), CostAware(slack=1.0)):
            rep = simulate(eng, trace, policy)
            row = dict(trace=tname, policy=policy.name,
                       completed=len(rep.responses),
                       rejected=len(rep.rejected),
                       latency_p50_ms=rep.latency_p50 * 1e3,
                       latency_p95_ms=rep.latency_p95 * 1e3,
                       latency_p99_ms=rep.latency_p99 * 1e3,
                       slo_attainment=rep.slo_attainment,
                       goodput_rps=rep.goodput_rps,
                       makespan_s=rep.makespan,
                       physical_evals=rep.physical_evals,
                       effective_evals=rep.effective_evals)
            rows.append(row)
            p95[(tname, policy.name)] = rep.latency_p95
            emit(f"table10/{tname}/{policy.name}",
                 rep.latency_p95 * 1e3,
                 f"p50={row['latency_p50_ms']:.1f}ms;"
                 f"p95={row['latency_p95_ms']:.1f}ms;"
                 f"p99={row['latency_p99_ms']:.1f}ms;"
                 f"slo_att={rep.slo_attainment:.2f};"
                 f"goodput={rep.goodput_rps:.1f}rps;"
                 f"rejected={len(rep.rejected)}")
    # the latency claim, checked where it is measured
    assert p95[("poisson", "edf")] < p95[("poisson", "fifo")], \
        "EDF must beat FIFO on p95 latency on the pinned Poisson trace"
    return rows


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
