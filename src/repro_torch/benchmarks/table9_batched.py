"""Table 9: batched serving — effective model evals per sample against
batch size, per-slot convergence gating and slot recycling against
lockstep whole-batch gating (counterpart of
``benchmarks/table9_batched.py``).

A fixed queue of 24 mixed-tolerance requests is drained by
``repro_torch.serve.DiffusionSamplingEngine`` at batch 1, 2, 4 and 8.
Lockstep gating makes every sample of a batch pay for the slowest:
``K * max_k(iters_k)`` refinements a batch against ``sum_k(iters_k)``;
the engine's effective evals are also prefix-truncated.  Both are in the
paper's unit, model evals per sample (DDIM: one eval a step); a row
also lists each request's tolerance and iterations.  Each
request's noise comes from a CPU generator seeded with its seed
(``common.host_noise``), so the card's counts equal the CPU's.

    PYTHONPATH=src python -m repro_torch.benchmarks.table9_batched \\
        [--device cpu]
"""
import torch

from repro_torch.core import SolverConfig
from repro_torch.serve import DiffusionSamplingEngine, SampleRequest

from .common import emit, host_noise, parser, resolve_device, toy_denoiser

N = 64           # grid size -> B=8 blocks of S=8 fine steps
TOLS = [1e-2, 1e-3, 1e-4, 1e-5, 3e-3, 1e-4, 1e-2, 1e-5]
REQUESTS = 24


def make_queue(requests: int = REQUESTS):
    return [SampleRequest(seed=i, tol=TOLS[i % len(TOLS)])
            for i in range(requests)]


def main(requests: int = REQUESTS, batch_sizes=(1, 2, 4, 8), device="cuda",
         noise_fn=host_noise, dtype=torch.float32):
    device = resolve_device(device)
    rows = []
    model_fn = toy_denoiser(device, dtype)
    for k in batch_sizes:
        eng = DiffusionSamplingEngine(model_fn, (16,), SolverConfig("ddim"),
                                      num_steps=N, batch_size=k,
                                      device=device, noise_fn=noise_fn,
                                      dtype=dtype)
        reqs = make_queue(requests)
        rids = [eng.submit(r) for r in reqs]
        out = eng.drain()
        st = eng.stats()
        b, s = 8, 8
        e = 1  # ddim
        iters = [out[r].iterations for r in rids]
        # lockstep whole-batch gating: requests grouped in arrival order,
        # every sample in a batch refines until the slowest one converges
        lockstep = sum(len(grp) * (b + max(grp) * (b * s + b)) * e
                       for grp in (iters[i:i + k]
                                   for i in range(0, len(iters), k)))
        eff = st["effective_evals_per_sample"]
        lock_per = lockstep / len(reqs)
        emit(f"table9/batch{k}", eff,
             f"evals_per_sample={eff:.1f};lockstep={lock_per:.1f};"
             f"saving={100 * (1 - eff / lock_per):.1f}%;"
             f"physical={st['physical_evals_per_sample']:.1f};"
             f"iters_min={min(iters)};iters_max={max(iters)}")
        rows.append(dict(batch=k, evals_per_sample=eff,
                         lockstep_evals_per_sample=lock_per,
                         saving_pct=100 * (1 - eff / lock_per),
                         physical_per_sample=st["physical_evals_per_sample"],
                         iters_min=min(iters), iters_max=max(iters),
                         request_tols=[r.tol for r in reqs],
                         request_iters=iters))
    return rows


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
