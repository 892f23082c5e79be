"""Sampling comparison driver for the PyTorch port: sequential vs vanilla
SRDS vs distributed (block-parallel and wavefront-pipelined) SRDS, plus
the SRDS-native straggler mitigation, the per-sample batch and the
serving engine (``examples/srds_sampling.py``'s flow through
``repro_torch``).

  PYTHONPATH=src python examples/torch_srds_sampling.py [--device cpu]

JAX's example re-executes itself with 8 fake XLA devices.  Here the
distributed samplers (``make_sharded_sampler``, ``make_pipelined_sampler``)
run over 8 gloo CPU ranks started by
``repro_torch.launch.mesh.spawn_ranks(..., device_type="cpu")``, in f64:
NCCL takes one rank a card, so one card cannot host 8.  The
single-process samplers and the serving engine run on the CUDA card
(the DDIM, residual and update kernels, which take f32: the toy runs in
f32 there) unless ``--device cpu`` is given (f64, as JAX's).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (DiffusionSchedule, SolverConfig,  # noqa: E402
                              SRDSConfig, iteration_cost, make_schedule,
                              predicted_evals, sample_sequential,
                              srds_sample, truncated_evals)
from repro_torch.models.dit import resolve_device  # noqa: E402

N = 64
RANKS = 8
DIM = 24
TOLS = [1e-2, 1e-3, 1e-4, 1e-5]


def toy(device, dtype):
    """The JAX example's denoiser (``tanh(x @ w) * (0.4 + 3e-4 t)``, w a
    24 x 24 draw scaled by 0.35), its schedule at N, the DDIM solver, x0
    (2 samples) and the per-sample batch (4), all drawn by numpy."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (DIM, DIM)) * 0.35).to(device=device, dtype=dtype)

    def model_fn(x, t):
        t = torch.as_tensor(t, dtype=dtype, device=x.device)
        return torch.tanh(x @ w) * (0.4 + 3e-4 * t.reshape(-1, 1))

    s = make_schedule("ddpm_linear", N)
    sched = DiffusionSchedule(np.asarray(s.ab, np.float64),
                              np.asarray(s.t_model, np.float64), s.kind)
    x0, xb = (torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).to(device=device, dtype=dtype)
        for seed, shape in ((1, (2, DIM)), (2, (4, DIM))))
    return model_fn, sched, SolverConfig("ddim"), x0, xb


def _mean_abs(a, b) -> float:
    return float((a - b).abs().mean())


def ranks(rank, world):
    """One of the 8 gloo ranks: the block-parallel, wavefront, straggler
    and per-sample sharded samplers over a (time 8) mesh, in f64; numpy
    results on every rank."""
    from repro_torch.core.pipelined import (make_pipelined_sampler,
                                            make_sharded_sampler)
    from repro_torch.launch.mesh import make_srds_mesh
    mesh = make_srds_mesh(world, device_type="cpu")
    model_fn, sched, solver, x0, xb = toy("cpu", torch.float64)
    out = {}
    res = make_sharded_sampler(mesh, "time", model_fn, sched, solver,
                               SRDSConfig(tol=1e-5, num_blocks=RANKS))(x0)
    out["block"] = (int(res.iterations), res.sample.numpy())
    res, steps, evals = make_pipelined_sampler(
        mesh, "time", model_fn, sched, solver, SRDSConfig(tol=1e-5))(x0)
    out["wave"] = (int(res.iterations), int(steps), int(evals),
                   res.sample.numpy())

    def strag(p):
        m = torch.zeros((RANKS,), dtype=torch.bool)
        m[3] = True
        return m if p % 2 == 1 else torch.zeros((RANKS,), dtype=torch.bool)

    res = make_sharded_sampler(
        mesh, "time", model_fn, sched, solver,
        SRDSConfig(tol=1e-5, num_blocks=RANKS, max_iters=20),
        straggler_fn=strag)(x0)
    out["strag"] = (int(res.iterations), res.sample.numpy())
    res = make_sharded_sampler(
        mesh, "time", model_fn, sched, solver,
        SRDSConfig(per_sample=True, num_blocks=RANKS))(
            xb, torch.tensor(TOLS, dtype=torch.float32))
    out["batched"] = (res.iterations.tolist(), res.sample.numpy())
    return out


def main(argv=None):
    from repro_torch.launch.mesh import spawn_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    model_fn, sched, solver, x0, xb = toy(device, dtype)
    out = {}

    ref = sample_sequential(model_fn, sched, solver, x0)
    print(f"sequential: {N} serial evals")
    res = srds_sample(model_fn, sched, solver, x0, SRDSConfig(tol=1e-5))
    out["vanilla"] = (int(res.iterations), _mean_abs(res.sample, ref))
    print(f"vanilla SRDS:     iters={out['vanilla'][0]} "
          f"err={out['vanilla'][1]:.2e}")

    res_t = srds_sample(model_fn, sched, solver, x0,
                        SRDSConfig(tol=1e-5, truncate=True))
    cost = iteration_cost(N, None, 1)
    k = int(res_t.iterations)
    out["truncated"] = (k, bool(torch.equal(res_t.sample, res.sample)),
                        truncated_evals(cost, k), predicted_evals(cost, k))
    print(f"truncated SRDS:   iters={k} bit-identical="
          f"{out['truncated'][1]} evals={out['truncated'][2]} vs "
          f"{out['truncated'][3]} untruncated (converged-prefix "
          f"truncation)")

    # the distributed samplers on 8 gloo CPU ranks, in f64
    dist = spawn_ranks(ranks, RANKS, device_type="cpu")[0]
    fn64, sched64, _, x064, xb64 = toy("cpu", torch.float64)
    ref64 = sample_sequential(fn64, sched64, solver, x064)
    it, sample = dist["block"]
    out["block"] = (it, _mean_abs(torch.from_numpy(sample), ref64))
    print(f"block-parallel:   iters={it} err={out['block'][1]:.2e}  "
          f"({RANKS} gloo ranks)")
    it, steps, evals, sample = dist["wave"]
    out["wave"] = (it, steps, evals,
                   _mean_abs(torch.from_numpy(sample), ref64))
    print(f"wavefront:        iters={it} supersteps={steps} "
          f"physical_evals={evals} err={out['wave'][3]:.2e}  "
          f"(vs {N} sequential evals; retired ranks skip theirs)")
    it, sample = dist["strag"]
    out["strag"] = (it, _mean_abs(torch.from_numpy(sample), ref64))
    print(f"with stragglers:  iters={it} err={out['strag'][1]:.2e}  "
          f"(block 3 stale every other refinement — still exact)")

    # --- batched: per-sample convergence gating (mixed-tolerance batch) ---
    tols = torch.tensor(TOLS, dtype=torch.float32, device=device)
    res = srds_sample(model_fn, sched, solver, xb,
                      SRDSConfig(per_sample=True), tol=tols)
    out["per_sample"] = res.iterations.tolist()
    print(f"per-sample SRDS:  iters={out['per_sample']} for tol="
          f"{TOLS} (each sample stops at its own tolerance)")
    res64 = srds_sample(fn64, sched64, solver, xb64,
                        SRDSConfig(per_sample=True),
                        tol=torch.tensor(TOLS, dtype=torch.float32))
    iters, sample = dist["batched"]
    out["batched"] = (iters, bool(np.array_equal(sample,
                                                 res64.sample.numpy())))
    print(f"sharded batched:  iters={iters} (bit-identical to the "
          f"single-program batched run: {out['batched'][1]})")

    # --- the serving layer: micro-batching + slot recycling over a queue ---
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    eng = DiffusionSamplingEngine(model_fn, (DIM,), solver, num_steps=N,
                                  batch_size=4, dtype=dtype, device=device)
    reqs = [SampleRequest(seed=i, tol=TOLS[i % 4]) for i in range(12)]
    rids = [eng.submit(r) for r in reqs]
    served = eng.drain()
    st = eng.stats()
    iters = [served[r].iterations for r in rids]
    lock = sum(len(g) * (8 + max(g) * 72) for g in
               (iters[i:i + 4] for i in range(0, len(iters), 4)))
    out["serving"] = (len(served), st["effective_evals_per_sample"],
                      lock / len(reqs))
    print(f"serving engine:   {len(reqs)} mixed-tol requests, batch 4 -> "
          f"{st['effective_evals_per_sample']:.0f} evals/sample "
          f"(lockstep gating would pay {lock / len(reqs):.0f})")
    return out


if __name__ == "__main__":
    main()
