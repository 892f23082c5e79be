"""The real-time asynchronous serving loop: host scheduling overlapped
with device compute (counterpart of ``repro.serve.async_loop``).

:func:`repro_torch.serve.scheduler.simulate` is the synchronous
discrete-event driver: each refinement is dispatched and its residual
fetched at once, so the device idles while the host runs admission,
eviction and bookkeeping.  :class:`AsyncServeLoop` pipelines the
engine's split hot loop
(:meth:`~repro_torch.serve.diffusion.DiffusionSamplingEngine.step_dispatch`
/ :meth:`~repro_torch.serve.diffusion.DiffusionSamplingEngine.step_resolve`):

1. run the admission round (policy rejection, preemption, slot filling);
2. **dispatch** the next refinement: its kernels are enqueued on the
   CUDA stream and the call returns at once;
3. **resolve** the *oldest* unresolved refinement: the host waits for
   that one residual copy while the card already runs the refinement
   dispatched in (2).

One host thread, no locks, and still one host sync per refinement:
dispatch makes none, resolve exactly the residual fetch.  When a fetch
shows a lane converged, the next refinement was already dispatched with
that lane active: wasted device work (charged physically, never
effectively) that is never observable, because the lane's sample is cut
from the resolved step's own snapshot.  On a virtual clock the loop
reproduces ``simulate()``'s samples and iteration counts exactly.

The loop is clock-agnostic (:mod:`repro_torch.serve.clock`): on a
:class:`~repro_torch.serve.clock.VirtualClock` it is a deterministic
harness for the pipelined path; on a
:class:`~repro_torch.serve.clock.MonotonicClock` it is the real-time
serving loop (arrivals appear as wall time passes, idle waits sleep,
latencies are real seconds, wall deadlines drive EDF, CostAware
rejection and eviction).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.diffusion import (DiffusionSamplingEngine,
                                         SampleRequest, SampleResponse)
from repro_torch.serve.scheduler import FIFO, Policy, SimReport, build_report

__all__ = ["AsyncServeLoop"]


class AsyncServeLoop:
    """Pipelined serving driver over one engine and one admission policy.

    The policy interface is exactly :class:`repro_torch.serve.scheduler.
    Policy` — FIFO/EDF/CostAware (and any user policy) run unmodified in
    both the synchronous simulator and this loop; only the stepping
    discipline differs.  ``max_inflight`` bounds the dispatched-but-
    unresolved refinements per micro-batch (2 = dispatch the next step
    while the previous fetch is in flight; 1 degenerates to the
    synchronous discipline, useful for A/B-ing the overlap itself).
    """

    def __init__(self, engine: DiffusionSamplingEngine,
                 policy: Optional[Policy] = None, max_inflight: int = 2):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.engine = engine
        self.policy = policy if policy is not None else FIFO()
        self.max_inflight = max_inflight

    def run(self, trace: Sequence[SampleRequest]) -> SimReport:
        """Serve ``trace`` to completion; returns the same
        :class:`~repro_torch.serve.scheduler.SimReport` shape ``simulate()``
        produces, with latencies in the engine clock's seconds (real
        ones under a wall clock).

        Requests become visible at their ``arrival_time`` on the
        engine's clock — under a wall clock that means genuinely waiting
        for them (an idle loop sleeps to the next arrival; a loaded one
        discovers them as refinements resolve).  Between refinements the
        policy may reject waiting requests (e.g. a ``deadline_wall``
        already hopeless at admission — evaluated lazily when the policy
        selects them for a free slot, see the inline note) and evict
        running ones whose wall deadline passed mid-refinement.  Engine
        metrics are reset first,
        so back-to-back runs on one warm engine are independent.
        """
        engine, policy = self.engine, self.policy
        engine.reset_metrics()

        pending: List[Tuple[int, SampleRequest]] = \
            [(engine.submit(r), r)
             for r in sorted(trace, key=lambda r: r.arrival_time)]
        submitted = [rid for rid, _ in pending]
        engine.pull_queue()       # the loop owns admission, not drain()
        first_arrival = pending[0][1].arrival_time if pending else 0.0
        engine.advance_clock(first_arrival)

        waiting: List[Tuple[int, SampleRequest]] = []
        responses: Dict[int, SampleResponse] = {}
        rejected: List[int] = []
        preempted: List[int] = []
        running: Dict[int, SampleRequest] = {}
        outstanding: Deque = deque()      # unresolved tokens, oldest first

        def arrivals(now: float) -> None:
            while pending and pending[0][1].arrival_time <= now:
                waiting.append(pending.pop(0))

        while pending or waiting or engine.busy() or outstanding:
            now = engine.clock
            arrivals(now)

            # ---- preemption round (policy-driven; wall-deadline eviction
            # fires here, between refinements, even mid-pipeline: the
            # evicted lane's still-in-flight refinement resolves as
            # speculative waste) ----
            victims = policy.preempt_victims(now, sorted(running.items()),
                                             waiting, engine)
            for rid in victims:
                engine.evict(rid)
                preempted.append(rid)
                del running[rid]

            # ---- admission control + slot filling ----
            # Rejection is evaluated lazily, at selection time, rather
            # than scanning the whole waiting set every round the way
            # simulate() does.  The shedding decisions are the same ones
            # (a request is only ever served through admission, and a
            # hopeless request is at least as hopeless when its slot
            # finally opens), but the cost-model work (CostAware's
            # predict_completion per waiter) runs O(admissions) instead of
            # O(rounds x waiters) — on a wall clock that host time is real
            # and would otherwise sit on the pipelined critical path.
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
                if policy.reject(now, rid, req, engine):
                    rejected.append(rid)
                    continue
                engine.admit(rid, req)
                running[rid] = req

            # ---- the overlap: dispatch the next refinement BEFORE
            # blocking on the previous one's residual fetch ----
            tok = engine.step_dispatch(max_inflight=self.max_inflight)
            if tok is not None:
                outstanding.append(tok)
            if outstanding and (tok is None or len(outstanding) > 1):
                # the device is (or just started) computing the younger
                # step(s); this fetch runs concurrently with them
                for rid, resp in engine.step_resolve(outstanding.popleft()):
                    responses[rid] = resp
                    running.pop(rid, None)
                continue
            if tok is not None:
                continue          # pipeline still filling — keep priming

            # nothing dispatched, nothing to resolve
            if waiting:
                if pending:
                    # the policy is holding back (legal — e.g. waiting to
                    # co-batch); wait for the arrival that may unblock it
                    engine.advance_clock(pending[0][1].arrival_time)
                    continue
                raise RuntimeError(
                    f"policy {policy.name!r} admitted nothing on an idle "
                    f"engine")
            if pending:
                # idle: wait (really sleep, on a wall clock) to the next
                # arrival
                engine.advance_clock(pending[0][1].arrival_time)

        return build_report(policy, responses, rejected, preempted,
                            submitted, engine, first_arrival)
