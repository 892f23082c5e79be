"""SLO-aware diffusion sampling service on the PyTorch port, end to end
(``examples/serve_diffusion_slo.py``'s flow through ``repro_torch``):

  1. build a :class:`DiffusionSamplingEngine` (micro-batched SRDS with
     per-slot convergence gating and slot recycling),
  2. generate a seeded Poisson arrival trace of two traffic tiers (a
     majority of loose-tolerance/tight-SLO requests, a minority of
     tight-tolerance/loose-SLO ones),
  3. replay it under FIFO, EDF and cost-model admission with
     :func:`repro_torch.serve.simulate` on the engine's deterministic
     virtual clock, and compare latency percentiles, SLO attainment and
     goodput,
  4. replay a thundering-herd burst where the cost model starts shedding
     provably-hopeless requests.

  PYTHONPATH=src python examples/torch_serve_diffusion_slo.py [--device cpu]

It runs on the CUDA card (the DDIM and residual kernels) unless
``--device cpu`` is given (their plain PyTorch twins).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import SolverConfig  # noqa: E402
from repro_torch.models.dit import resolve_device  # noqa: E402
from repro_torch.serve import (EDF, FIFO, CostAware,  # noqa: E402
                               DiffusionSamplingEngine, SampleRequest, Tier,
                               bursty_trace, poisson_trace, simulate)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a small two-layer denoiser; any (x, t) -> eps callable works
    w1, w2 = (torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (16, 16)).astype(np.float32) * 0.4).to(device) for seed in (0, 1))

    def model_fn(x, t):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        h = torch.tanh(x @ w1) * (0.4 + 3e-4 * t.reshape(-1, 1))
        return torch.tanh(h @ w2 + x * 0.1)

    engine = DiffusionSamplingEngine(model_fn, (16,), SolverConfig("ddim"),
                                     num_steps=64, batch_size=2,
                                     sec_per_eval=1e-5, device=device)

    # simple FIFO drain still works request-by-request (no SLOs involved)
    rid = engine.submit(SampleRequest(seed=0, tol=1e-3))
    out = engine.drain()
    print(f"single request: {out[rid].iterations} SRDS iterations, "
          f"{out[rid].model_evals} model evals\n")
    reports = {}

    tiers = [Tier(tol=1e-2, slo_ms=25, iters_hint=2, weight=0.96),
             Tier(tol=1e-6, slo_ms=400, iters_hint=8, weight=0.04)]

    print("=== Poisson arrivals, 380 req/s, 100 requests ===")
    trace = poisson_trace(100, rate=380.0, tiers=tiers, seed=0)
    for policy in (FIFO(), EDF(), CostAware()):
        rep = simulate(engine, trace, policy)
        reports[("poisson", policy.name)] = rep
        print(f"  {policy.name:5s}: p50={rep.latency_p50 * 1e3:6.1f}ms "
              f"p95={rep.latency_p95 * 1e3:6.1f}ms "
              f"slo_att={rep.slo_attainment:.2f} "
              f"goodput={rep.goodput_rps:6.1f}rps "
              f"rejected={len(rep.rejected)}")

    print("\n=== Thundering herd: 2 bursts of 20 ===")
    herd = bursty_trace(2, 20, period=0.08, tiers=tiers, seed=0, jitter=0.005)
    for policy in (FIFO(), EDF(), CostAware()):
        rep = simulate(engine, herd, policy)
        reports[("herd", policy.name)] = rep
        print(f"  {policy.name:5s}: p95={rep.latency_p95 * 1e3:6.1f}ms "
              f"slo_att={rep.slo_attainment:.2f} "
              f"goodput={rep.goodput_rps:6.1f}rps "
              f"rejected={len(rep.rejected)}")

    print("\nengine stats():")
    for k, v in engine.stats().items():
        print(f"  {k}: {v}")
    return dict(single=out[rid], reports=reports,
                traces={"poisson": trace, "herd": herd})


if __name__ == "__main__":
    main()
