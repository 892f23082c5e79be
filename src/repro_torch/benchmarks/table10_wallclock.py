"""Table 10w: wall-clock SLO scheduling — the real-time twin of
``table10_slo``, replayed through :class:`repro_torch.serve.AsyncServeLoop`
on a :class:`~repro_torch.serve.MonotonicClock` engine (counterpart of
``benchmarks/table10_wallclock.py``).

* a **calibration** pass replays the pinned herd under FIFO twice, cold
  (first calls, allocator warm-up) and warm; the warm one gives
  ``sec_per_eval`` (wall seconds per physical model eval), which the
  CostAware cost model prices admission with;
* the **pinned herd** (every request at t=0, the tight-tolerance heavies
  submitted ahead of the loose-tolerance majority) under FIFO, EDF and
  CostAware, with the light tier's p95: FIFO buries the herd behind the
  heavies, EDF and CostAware serve the tight-SLO majority first;
* the same herd with ``max_inflight=1`` (no overlap of a refinement with
  the previous one's residual fetch), reported beside the pipelined run;
* a **Poisson load sweep** at fractions of the calibrated capacity.

The gate is JAX's, on the pinned herd, on ordering only: EDF's and
CostAware's light-tier p95 below FIFO's, EDF's SLO attainment no more
than 0.05 below FIFO's, CostAware's goodput at least 0.9 of FIFO's.  It
binds two readings of the herd:

* always, the herd replayed through the same ``AsyncServeLoop`` on a
  :class:`~repro_torch.serve.VirtualClock` engine priced at the
  calibrated ``sec_per_eval`` (the same SLOs, time charged as physical
  evals; the ``*_virtual`` fields), whose numbers are functions of the
  port's schedule and counts: the CPU run's gate, where a host shared
  with other work moves the wall clock (a 3-way herd of ~0.3-0.7 s read
  EDF's p95 above FIFO's, and CostAware's goodput 0.74 of FIFO's, with
  all eight cores busy);
* on a CUDA device, also the wall-clock herd itself (``light_p95_ms``,
  ``slo_attainment``, ``goodput_rps``), as JAX's gate reads it.

By default the model is the JAX emitter's 16-dim toy.  ``--arch
srds-dit-sd2`` serves the same herd with the paper's DiT at full width
and depth (28 layers, d 1152, bf16, 64x64x4 latents, weights drawn from
``--seed`` by numpy): the grid (N=64, B=8), the two tiers, the SLO rules
and the gates are the toy's, the counts are cut (``DIT_CUT``): 2 heavies
and 4 lights in the herd, not 6 and 18 (a herd request takes seconds on
the card, not milliseconds), and the sweep one load (1.5) of 4 requests,
not three of 36.  ``--layers`` serves the DiT at that many of its 28
blocks (full width). Request noise as in ``table9_batched``.

    PYTHONPATH=src python -m repro_torch.benchmarks.table10_wallclock \\
        [--device cpu] [--arch srds-dit-sd2 [--layers L]] \
        [--out BENCH_serve.json]
"""
import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import SolverConfig
from repro_torch.serve import (EDF, FIFO, AsyncServeLoop, CostAware,
                               DiffusionSamplingEngine, MonotonicClock,
                               SampleRequest, Tier, VirtualClock,
                               poisson_trace)

from .common import (emit, host_noise, meta, parser, resolve_device,
                     smi_line, toy_denoiser)

N = 64                    # grid -> B=8 blocks of S=8 fine steps
BATCH = 2
# heavies submitted first make FIFO's head-of-line blocking a structural
# multiple of the light drain time; the gated percentile is the light
# tier's, so the mix never moves it onto a heavy
N_HEAVY = 6
N_LIGHT = 18
LIGHT = dict(tol=1e-2, iters_hint=2)
HEAVY = dict(tol=1e-6, iters_hint=8)
LOADS = (0.6, 1.5, 3.0)
SWEEP_REQUESTS = 36
# the full DiT's counts (module docstring)
DIT_CUT = dict(n_heavy=2, n_light=4, loads=(1.5,), sweep_requests=4)


def herd_trace(light_slo_ms=None, heavy_slo_ms=None, n_heavy=N_HEAVY,
               n_light=N_LIGHT):
    """The pinned herd: everyone arrives at t=0, heavies submitted first,
    so FIFO's admission order is the head-of-line worst case while EDF's
    deadline order is shortest-job-first."""
    reqs = [SampleRequest(seed=1000 + i, arrival_time=0.0,
                          slo_ms=heavy_slo_ms, **HEAVY)
            for i in range(n_heavy)]
    reqs += [SampleRequest(seed=i, arrival_time=0.0,
                           slo_ms=light_slo_ms, **LIGHT)
             for i in range(n_light)]
    return reqs


def dit_model(arch: str, seed: int, device, layers: Optional[int] = None):
    """``(model_fn, sample_shape)``: ``arch`` at full width and at its
    depth (or its first ``layers`` blocks), its weights drawn from
    ``seed`` by numpy."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dit
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = dit.load_jax_params(cfg, dit.random_jax_tree(cfg, seed=seed),
                                device=device)
    return dit.make_denoiser(model), (64, 64, cfg.in_channels)


def main(loads=None, sweep_requests=None, device="cuda", arch=None,
         seed: int = 0, noise_fn=host_noise, dtype=torch.float32,
         layers: Optional[int] = None):
    device = resolve_device(device)
    cut = DIT_CUT if arch is not None else dict(
        n_heavy=N_HEAVY, n_light=N_LIGHT, loads=LOADS,
        sweep_requests=SWEEP_REQUESTS)
    n_heavy, n_light = cut["n_heavy"], cut["n_light"]
    loads = cut["loads"] if loads is None else loads
    sweep_requests = cut["sweep_requests"] if sweep_requests is None \
        else sweep_requests
    if arch is None:
        model_fn, shape = toy_denoiser(device, dtype), (16,)
    else:
        model_fn, shape = dit_model(arch, seed, device, layers)
        if device.type == "cuda":
            print(f"# {arch} on {smi_line()}, torch {torch.__version__}",
                  flush=True)
    def engine(clock):
        return DiffusionSamplingEngine(model_fn, shape, SolverConfig("ddim"),
                                       num_steps=N, batch_size=BATCH,
                                       clock=clock, device=device,
                                       noise_fn=noise_fn, dtype=dtype)

    eng = engine(MonotonicClock())
    rows = []

    def herd(light_slo_ms=None, heavy_slo_ms=None):
        return herd_trace(light_slo_ms, heavy_slo_ms, n_heavy, n_light)

    # ---- calibration: a cold pass runs every call the measured runs will
    # make, then a warm pass measures wall seconds per physical eval; SLOs
    # play no role under FIFO, so they are left unset here
    cold = AsyncServeLoop(eng, FIFO()).run(herd())
    assert len(cold.responses) == n_heavy + n_light
    warm = AsyncServeLoop(eng, FIFO()).run(herd())
    assert len(warm.responses) == n_heavy + n_light
    sec_per_eval = warm.makespan / max(warm.physical_evals, 1)
    eng.sec_per_eval = sec_per_eval          # wall-calibrated cost model
    per_req_s = warm.makespan / len(warm.responses)
    capacity_rps = 1.0 / per_req_s
    rows.append(dict(trace="calibration", policy="fifo",
                     sec_per_eval=sec_per_eval,
                     capacity_rps=capacity_rps,
                     makespan_s=warm.makespan,
                     makespan_cold_s=cold.makespan,
                     physical_evals=warm.physical_evals,
                     physical_evals_cold=cold.physical_evals))
    emit("table10w/calibration", sec_per_eval * 1e6,
         f"capacity={capacity_rps:.0f}rps;makespan={warm.makespan:.3f}s;"
         f"phys_evals={warm.physical_evals}")

    # SLOs off the warm herd's drain time: the light SLO inside the
    # herd's makespan (admission order decides who makes it), the heavy
    # one well outside it
    light_slo_ms = 0.7 * warm.makespan * 1e3
    heavy_slo_ms = 3.0 * warm.makespan * 1e3

    def measure(tname, trace, policy):
        rep = AsyncServeLoop(eng, policy).run(trace)
        row = dict(trace=tname, policy=policy.name,
                   completed=len(rep.responses),
                   rejected=len(rep.rejected),
                   preempted=len(rep.preempted),
                   latency_p50_ms=rep.latency_p50 * 1e3,
                   latency_p95_ms=rep.latency_p95 * 1e3,
                   latency_p99_ms=rep.latency_p99 * 1e3,
                   slo_attainment=rep.slo_attainment,
                   goodput_rps=rep.goodput_rps,
                   makespan_s=rep.makespan,
                   physical_evals=rep.physical_evals,
                   wall_clock=True)
        rows.append(row)
        emit(f"table10w/{tname}/{policy.name}", rep.latency_p95 * 1e3,
             f"p50={row['latency_p50_ms']:.1f}ms;"
             f"p95={row['latency_p95_ms']:.1f}ms;"
             f"slo_att={rep.slo_attainment:.2f};"
             f"goodput={rep.goodput_rps:.1f}rps;"
             f"rejected={len(rep.rejected)}")
        return rep

    def light_p95(rep):
        # rids go in submission order, heavies first, so the n_heavy
        # smallest rids of a run are the heavies
        all_rids = sorted(set(rep.responses) | set(rep.rejected)
                          | set(rep.preempted))
        heavy_rids = set(all_rids[:n_heavy])
        lights = [r.latency for rid, r in rep.responses.items()
                  if rid not in heavy_rids]
        return float(np.percentile(lights, 95)) if lights else math.inf

    # ---- the pinned herd on the wall clock (readings), and the gated leg:
    # the same herd through the same loop on a virtual clock priced at the
    # calibrated sec_per_eval, whose latencies are the schedule's counts
    trace = herd(light_slo_ms, heavy_slo_ms)
    virtual = engine(VirtualClock())
    virtual.sec_per_eval = sec_per_eval
    wall, replay = {}, {}       # the gate's readings: p95 s, att, goodput
    for policy, twin in ((FIFO(), FIFO()), (EDF(), EDF()),
                         (CostAware(slack=1.0), CostAware(slack=1.0))):
        rep = measure("herd", trace, policy)
        wall[policy.name] = (light_p95(rep), rep.slo_attainment,
                             rep.goodput_rps)
        rows[-1]["light_p95_ms"] = wall[policy.name][0] * 1e3
        vrep = AsyncServeLoop(virtual, twin).run(trace)
        replay[twin.name] = (light_p95(vrep), vrep.slo_attainment,
                             vrep.goodput_rps)
        rows[-1].update(light_p95_virtual_ms=replay[twin.name][0] * 1e3,
                        slo_attainment_virtual=replay[twin.name][1],
                        goodput_virtual_rps=replay[twin.name][2],
                        physical_evals_virtual=vrep.physical_evals)

    # ---- overlap A/B: the herd with max_inflight=1 (the synchronous
    # stepping discipline); reported, not gated
    sync_rep = AsyncServeLoop(eng, FIFO(), max_inflight=1).run(trace)
    rows.append(dict(trace="herd_overlap_ab", policy="fifo",
                     makespan_async_s=rows[1]["makespan_s"],
                     makespan_sync_s=sync_rep.makespan,
                     overlap_speedup=sync_rep.makespan
                     / max(rows[1]["makespan_s"], 1e-12)))
    emit("table10w/herd_overlap_ab", sync_rep.makespan * 1e6,
         f"sync={sync_rep.makespan:.3f}s;async={rows[1]['makespan_s']:.3f}s;"
         f"ratio={rows[-1]['overlap_speedup']:.2f}x")

    # ---- Poisson latency-vs-load sweep
    tiers = [Tier(slo_ms=light_slo_ms, weight=0.96, **LIGHT),
             Tier(slo_ms=heavy_slo_ms, weight=0.04, **HEAVY)]
    for load in loads:
        trace = poisson_trace(sweep_requests, load * capacity_rps, tiers,
                              seed=0)
        for policy in (FIFO(), EDF(), CostAware(slack=1.0)):
            measure(f"poisson_load{load:g}", trace, policy)

    # the gate: ordering and attainment on the pinned herd, where
    # head-of-line blocking is structural; no absolute seconds.  The
    # virtual replay binds every run, the wall clock a run on the card
    gate(replay, "virtual-clock replay of the")
    if device.type == "cuda":
        gate(wall, "wall-clock")
    return rows


def gate(readings, which: str) -> None:
    """JAX's four assertions, its messages and its 0.05 band, on
    ``readings`` (``{policy name: (light-tier p95 s, SLO attainment,
    goodput rps)}``) of the ``which`` pinned herd."""
    p95 = {k: v[0] for k, v in readings.items()}
    att = {k: v[1] for k, v in readings.items()}
    gput = {k: v[2] for k, v in readings.items()}
    assert p95["edf"] < p95["fifo"], \
        f"EDF light-tier p95 ({p95['edf']:.3f}s) must beat FIFO" \
        f" ({p95['fifo']:.3f}s) on the pinned {which} herd"
    assert p95["cost"] < p95["fifo"], \
        f"CostAware light-tier p95 ({p95['cost']:.3f}s) must beat FIFO" \
        f" ({p95['fifo']:.3f}s) on the pinned {which} herd"
    band = 0.05               # generous: wall attainment jitters per-run
    assert att["edf"] >= att["fifo"] - band, \
        f"EDF attainment {att['edf']:.2f} fell below FIFO {att['fifo']:.2f}"
    # CostAware sheds predicted-hopeless requests: its invariant is
    # SLO-met throughput
    assert gput["cost"] >= 0.9 * gput["fifo"], \
        f"CostAware goodput {gput['cost']:.1f}rps fell >10% below FIFO" \
        f" {gput['fifo']:.1f}rps"


def write_artifact(rows, out, device, arch=None):
    """Add the table under ``table10_wallclock`` to ``out`` (merging with
    an existing file from the virtual legs)."""
    payload = {}
    if os.path.exists(out):
        with open(out) as f:
            payload = json.load(f)
    payload.setdefault("meta", {}).update(meta(device))
    payload["meta"]["table10_wallclock_arch"] = arch or "toy"
    payload["table10_wallclock"] = rows
    with open(out, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"wrote {out}")


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--arch", default=None, choices=("srds-dit-sd2",),
                    help="the paper's latent DiT at full size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the DiT at this many of its blocks")
    ap.add_argument("--out", default="BENCH_serve.json")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    write_artifact(main(device=dev, arch=args.arch, seed=args.seed,
                        layers=args.layers), args.out, dev, args.arch)
