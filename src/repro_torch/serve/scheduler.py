"""Arrival-aware SLO scheduling for the diffusion sampling service
(counterpart of ``repro_torch.serve.scheduler``).

This module owns *policy*; :class:`repro_torch.serve.diffusion.
DiffusionSamplingEngine` owns *mechanism* (slots, micro-batches, the
virtual clock).  :func:`simulate` is a discrete-event driver: it replays
an arrival trace through a real engine, advancing the engine's
deterministic virtual clock (physical model evals x ``sec_per_eval``), so
every latency/SLO number is bit-reproducible — no wall-clock, no threads,
entirely host-stepped.

Three admission policies ship:

* :class:`FIFO` — arrival order (the pre-scheduler behaviour, now explicit);
* :class:`EDF` — earliest absolute deadline first; with deadlines
  proportional to expected service this approximates shortest-job-first
  and dodges FIFO's head-of-line blocking (lower p95 latency on mixed
  queues);
* :class:`CostAware` — EDF order plus admission control and (optionally)
  preemption driven by the engine's own per-iteration eval accounting
  (:func:`repro_torch.core.engine.iteration_cost` via
  ``engine.predict_completion``): requests whose *optimistic* predicted
  completion already misses their deadline are rejected up front instead
  of burning slots, and — with ``preempt=True`` — running requests whose
  deadline has already passed are evicted when a still-feasible request
  is waiting.

Guarantees / non-guarantees (mirroring the serving layer's):

* every *completed* request's sample is bit-exact vs the single-request
  ``srds_sample`` — policies only reorder/deny admission, they never touch
  a running lane's math (eviction frees a lane; frozen-lane masking keeps
  batch-mates untouched);
* ``simulate`` on a fixed trace + policy + engine config is
  bit-deterministic across runs (trace generators use seeded
  ``numpy.random.Generator`` streams; the event loop has no ties broken by
  id/hash order);
* the cost model now sees *cross-group device contention*: busy
  micro-batches step round-robin on the one device, so
  ``predict_completion`` charges every other currently-busy group one
  step at its current frontier cost per refinement round the request
  needs.  Within those terms it stays *optimistic* (the frontier is
  assumed to advance every refinement, contending groups are priced at
  today's only-shrinking step cost and assumed not to grow, and the
  iteration estimate is the most optimistic of the engine's learned
  per-tier :class:`~repro_torch.serve.diffusion.IterationEMA` estimate and the
  caller's ``iters_hint``): CostAware rejection sheds requests that
  would miss their SLO under the currently visible load.  It does NOT
  guarantee admitted requests meet their deadlines, and "never
  over-rejects" is relative to the estimates — an unusually easy request
  in a hard tier can beat the iteration estimate, and a contending group
  can drain earlier than charged.

Adding a policy: subclass :class:`Policy` and implement ``select(now,
queue, engine)`` returning the index of the queue entry to admit next
(``None`` to hold everything back this round); optionally override
``reject`` (admission control) and ``preempt_victims`` (eviction).  The
driver guarantees ``select`` is only consulted when the chosen request's
compatibility group has a free slot, and re-consults after every
admission, so policies never need to model slot state themselves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.diffusion import (DiffusionSamplingEngine,
                                         SampleRequest, SampleResponse)

__all__ = ["Policy", "FIFO", "EDF", "CostAware", "Tier", "poisson_trace",
           "bursty_trace", "SimReport", "simulate", "build_report"]


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------

class Policy:
    """Admission-policy interface (see module docstring for the contract)."""

    name = "policy"

    def select(self, now: float, queue: List[Tuple[int, SampleRequest]],
               engine: DiffusionSamplingEngine) -> Optional[int]:
        """Index into ``queue`` of the entry to admit next, or None."""
        raise NotImplementedError

    def reject(self, now: float, rid: int, req: SampleRequest,
               engine: DiffusionSamplingEngine) -> bool:
        """Admission control: True drops the request unserved."""
        return False

    def preempt_victims(self, now: float,
                        running: List[Tuple[int, SampleRequest]],
                        queue: List[Tuple[int, SampleRequest]],
                        engine: DiffusionSamplingEngine) -> List[int]:
        """rids of running requests to evict before this admission round."""
        return []


class FIFO(Policy):
    """Admit in arrival order (ties broken by submission order, which the
    queue already encodes)."""

    name = "fifo"

    def select(self, now, queue, engine):
        if not queue:
            return None
        return min(range(len(queue)),
                   key=lambda i: (queue[i][1].arrival_time, i))


class EDF(Policy):
    """Earliest absolute deadline first; deadline-free requests sort last
    (deadline = +inf), among themselves by arrival.  Deadlines resolve
    through ``engine.request_deadline`` so the policy is clock-agnostic:
    virtual deadlines on a virtual-clock engine, ``deadline_wall`` on a
    wall-clock one."""

    name = "edf"

    def select(self, now, queue, engine):
        if not queue:
            return None
        return min(range(len(queue)),
                   key=lambda i: (engine.request_deadline(queue[i][1]),
                                  queue[i][1].arrival_time, i))


class CostAware(EDF):
    """EDF ordering + cost-model admission control (+ optional preemption).

    ``slack`` scales the predicted service time before comparing against
    the deadline (slack > 1 rejects more aggressively; the default 1.0
    rejects only provably-hopeless requests under the optimistic model).
    """

    name = "cost"

    def __init__(self, slack: float = 1.0, preempt: bool = False):
        self.slack = slack
        self.preempt = preempt

    def reject(self, now, rid, req, engine):
        deadline = engine.request_deadline(req)
        if not math.isfinite(deadline):
            return False
        predicted = engine.predict_completion(req, now)
        return now + self.slack * (predicted - now) > deadline

    def preempt_victims(self, now, running, queue, engine):
        if not self.preempt or not queue:
            return []
        # a feasible waiting request starved of slots in ITS compatibility
        # group justifies evicting a same-group runner whose deadline is
        # already unrecoverably past; runners in other groups (or in groups
        # with free slots) are left to finish late-but-complete, and at most
        # one runner is evicted per starved waiter — never more slots than
        # the waiters need
        starved: dict = {}
        for _, req in queue:
            # same slack-scaled feasibility test reject() applies, so we
            # never evict a runner for a waiter this round then rejects
            predicted = engine.predict_completion(req, now)
            if (engine.free_slots(req) == 0
                    and now + self.slack * (predicted - now)
                    <= engine.request_deadline(req)):
                key = engine.compat_key(req)
                starved[key] = starved.get(key, 0) + 1
        victims = []
        for rid, req in running:
            key = engine.compat_key(req)
            if now > engine.request_deadline(req) and starved.get(key, 0) > 0:
                victims.append(rid)
                starved[key] -= 1
        return victims


# --------------------------------------------------------------------------
# synthetic arrival traces
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tier:
    """A quality/latency class of traffic: requests in a tier share a
    tolerance, an SLO, and (for the cost model) an expected iteration
    count — mirroring how a deployment would publish per-tier SLOs."""
    tol: float
    slo_ms: Optional[float] = None
    iters_hint: Optional[int] = None
    weight: float = 1.0


def _draw_tiers(rng: np.random.Generator, tiers: Sequence[Tier],
                n: int) -> List[Tier]:
    w = np.asarray([t.weight for t in tiers], np.float64)
    idx = rng.choice(len(tiers), size=n, p=w / w.sum())
    return [tiers[i] for i in idx]


def _mk_request(i: int, t: float, tier: Tier, seed0: int) -> SampleRequest:
    return SampleRequest(seed=seed0 + i, tol=tier.tol, arrival_time=float(t),
                         slo_ms=tier.slo_ms, iters_hint=tier.iters_hint)


def poisson_trace(n: int, rate: float, tiers: Sequence[Tier],
                  seed: int = 0, start: float = 0.0,
                  seed0: int = 0) -> List[SampleRequest]:
    """``n`` arrivals of a Poisson process with ``rate`` req/s, tiers drawn
    by weight.  Deterministic for a fixed ``seed`` (PCG64 stream)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    times = start + np.cumsum(gaps)
    drawn = _draw_tiers(rng, tiers, n)
    return [_mk_request(i, times[i], drawn[i], seed0) for i in range(n)]


def bursty_trace(n_bursts: int, burst_size: int, period: float,
                 tiers: Sequence[Tier], seed: int = 0, jitter: float = 0.0,
                 start: float = 0.0, seed0: int = 0) -> List[SampleRequest]:
    """``n_bursts`` bursts of ``burst_size`` near-simultaneous arrivals,
    ``period`` seconds apart (uniform jitter inside the burst) — the
    thundering-herd shape that separates EDF from FIFO."""
    rng = np.random.default_rng(seed)
    out: List[SampleRequest] = []
    i = 0
    for b in range(n_bursts):
        t0 = start + b * period
        offs = np.sort(rng.uniform(0.0, jitter, size=burst_size)) \
            if jitter > 0 else np.zeros(burst_size)
        for tier, off in zip(_draw_tiers(rng, tiers, burst_size), offs):
            out.append(_mk_request(i, t0 + off, tier, seed0))
            i += 1
    return out


# --------------------------------------------------------------------------
# the discrete-event driver
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SimReport:
    """Outcome of one trace replay.  ``responses`` holds completed requests
    only; rejected/preempted rids are listed separately.  Percentiles are
    over completed-request latencies, in the replaying engine's clock
    seconds — deterministic virtual ones out of :func:`simulate`, real
    wall ones out of :class:`repro_torch.serve.async_loop.AsyncServeLoop`."""
    policy: str
    responses: Dict[int, SampleResponse]
    rejected: List[int]
    preempted: List[int]
    latency_p50: float
    latency_p95: float
    latency_p99: float
    slo_attainment: float     # met / all submitted (rejected+preempted miss)
    goodput_rps: float        # SLO-met completions per virtual second
    makespan: float           # virtual seconds from first arrival to idle
    effective_evals: int
    physical_evals: int


def simulate(engine: DiffusionSamplingEngine, trace: Sequence[SampleRequest],
             policy: Optional[Policy] = None,
             sec_per_eval: Optional[float] = None) -> SimReport:
    """Replay ``trace`` through ``engine`` under ``policy`` (default FIFO).

    The event loop alternates admission rounds and engine steps: requests
    become visible at their ``arrival_time`` on the engine's virtual clock;
    between steps the policy may reject waiting requests, evict running
    ones, and picks who takes each free slot.  When the engine is idle and
    nothing has arrived, the clock jumps to the next arrival.  Resets the
    engine's metrics first so back-to-back runs on one warm engine are
    independent and bit-deterministic.

    **Determinism guarantee:** ``simulate()`` is a host-stepped
    discrete-event replay on the engine's deterministic
    :class:`~repro_torch.serve.clock.VirtualClock` — time advances only by
    charged eval cost and arrival jumps, so a fixed (trace, policy,
    engine config) reproduces byte-identical samples, latencies and
    percentiles on every run.  It uses the engine's *synchronous* step
    (dispatch + resolve fused) and is entirely unaffected by the
    asynchronous wall-clock serving loop
    (:class:`repro_torch.serve.async_loop.AsyncServeLoop`), which lives
    beside it, not under it.  An engine built on any non-virtual clock is
    refused here — wall-clock evidence belongs to the async loop.
    """
    if engine._clock.is_wall:
        raise ValueError(
            "simulate() is the bit-deterministic discrete-event driver and "
            "requires a VirtualClock engine; wall-clock serving goes "
            "through repro_torch.serve.async_loop.AsyncServeLoop")
    policy = policy if policy is not None else FIFO()
    saved_spe = engine.sec_per_eval
    if sec_per_eval is not None:
        engine.sec_per_eval = sec_per_eval
    try:
        return _simulate(engine, trace, policy)
    finally:
        # a what-if calibration override must not leak into later runs
        engine.sec_per_eval = saved_spe


def _simulate(engine: DiffusionSamplingEngine,
              trace: Sequence[SampleRequest], policy: Policy) -> SimReport:
    engine.reset_metrics()

    pending = sorted(trace, key=lambda r: r.arrival_time)
    pending = [(engine.submit(r), r) for r in pending]
    submitted = [rid for rid, _ in pending]
    engine.pull_queue()       # simulate owns admission, not drain()
    first_arrival = pending[0][1].arrival_time if pending else 0.0
    engine.advance_clock(first_arrival)

    waiting: List[Tuple[int, SampleRequest]] = []
    responses: Dict[int, SampleResponse] = {}
    rejected: List[int] = []
    preempted: List[int] = []
    running: Dict[int, SampleRequest] = {}

    def arrivals(now: float):
        while pending and pending[0][1].arrival_time <= now:
            waiting.append(pending.pop(0))

    while pending or waiting or engine.busy():
        now = engine.clock
        arrivals(now)
        if not waiting and not engine.busy():
            # idle: jump to the next arrival
            engine.advance_clock(pending[0][1].arrival_time)
            continue

        # ---- preemption round (policy-driven) ----
        victims = policy.preempt_victims(now, sorted(running.items()),
                                         waiting, engine)
        for rid in victims:
            engine.evict(rid)
            preempted.append(rid)
            del running[rid]

        # ---- admission control + slot filling ----
        keep: List[Tuple[int, SampleRequest]] = []
        for rid, req in waiting:
            if policy.reject(now, rid, req, engine):
                rejected.append(rid)
            else:
                keep.append((rid, req))
        waiting[:] = keep
        while True:
            admissible = [i for i, (rid, req) in enumerate(waiting)
                          if engine.free_slots(req) > 0]
            if not admissible:
                break
            sub = [waiting[i] for i in admissible]
            j = policy.select(now, sub, engine)
            if j is None:
                break
            rid, req = waiting.pop(admissible[j])
            engine.admit(rid, req)
            running[rid] = req

        if waiting and not engine.busy():
            if pending:
                # the policy is holding back (legal — e.g. waiting to
                # co-batch); jump to the next arrival that may unblock it
                engine.advance_clock(pending[0][1].arrival_time)
                continue
            # nothing running, nothing admitted, nothing left to arrive: a
            # select() that holds requests back forever would hang the clock
            raise RuntimeError(
                f"policy {policy.name!r} admitted nothing on an idle engine")

        # ---- one engine step (advances the clock) ----
        for rid, resp in engine.step_once():
            responses[rid] = resp
            running.pop(rid, None)

    return build_report(policy, responses, rejected, preempted, submitted,
                        engine, first_arrival)


def build_report(policy: Policy, responses: Dict[int, SampleResponse],
                 rejected: List[int], preempted: List[int],
                 submitted: List[int], engine: DiffusionSamplingEngine,
                 first_arrival: float) -> SimReport:
    """Assemble a :class:`SimReport` from one finished trace replay —
    shared by the synchronous :func:`simulate` and the asynchronous
    :class:`repro_torch.serve.async_loop.AsyncServeLoop`, so virtual and
    wall-clock runs report through one schema."""
    lats = [r.latency for r in responses.values()]
    p50, p95, p99 = (np.percentile(lats, [50, 95, 99]) if lats
                     else (0.0, 0.0, 0.0))
    met = sum(1 for r in responses.values() if r.slo_met)
    makespan = max(engine.clock - first_arrival, 0.0)
    return SimReport(
        policy=policy.name,
        responses=responses,
        rejected=rejected,
        preempted=preempted,
        latency_p50=float(p50),
        latency_p95=float(p95),
        latency_p99=float(p99),
        slo_attainment=met / max(len(submitted), 1),
        goodput_rps=met / makespan if makespan > 0 else 0.0,
        makespan=makespan,
        effective_evals=engine.effective_evals,
        physical_evals=engine.physical_evals)
