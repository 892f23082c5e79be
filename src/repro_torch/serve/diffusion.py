"""Batched diffusion sampling service over the batch-aware SRDS engine
(counterpart of ``repro.serve.diffusion``).

Callers ``submit`` sampling requests carrying their own ``(tol,
num_steps, seed)`` and, for SLO-aware serving, an ``arrival_time`` and a
``deadline``/``slo_ms``.  The engine packs requests that agree on
``(num_steps, schedule, sample shape, solver)`` into micro-batches of
``batch_size`` slots and drives the Parareal refinement one iteration at
a time across each batch.  Convergence is gated per slot, so a converged
sample frees its slot for the next queued request at once.

Each refinement runs the engine's shared
:func:`repro_torch.core.engine.suffix_refinement` on the group's
quantized frontier (:mod:`repro_torch.core.window`): ``ExactPrefix`` (the
default, ``truncate=True``) skips the provably bitwise-frozen prefix;
``ResidualWindow`` also skips blocks whose residual passed
``window_tol`` (approximate, opt-in).  The step functions are cached per
frontier, and ``truncate_quantum`` bounds that cache and decides the
*physical* evals billed: ``stats()`` and the cost model read them.

Host traffic, on a CUDA device: :meth:`DiffusionSamplingEngine.
step_dispatch` enqueues a refinement and starts a non-blocking copy of its
``(K,)`` residual vector (``(K+B,)`` with the per-block residuals under
``ResidualWindow``) into pinned host memory, recording a CUDA event;
:meth:`DiffusionSamplingEngine.step_resolve` waits on that event through
:func:`_host_fetch`, the service's one device-to-host seam.  It is
called once per refinement plus once per completed request (that lane's
final state, copied on a side stream after the step's event).  Nothing
else in a step reads the device, so the next refinement can be enqueued
before the previous one's residual arrives
(:class:`repro_torch.serve.async_loop.AsyncServeLoop`).

Time rides a pluggable clock (:mod:`repro_torch.serve.clock`): the
default :class:`~repro_torch.serve.clock.VirtualClock` charges physical
evals times ``sec_per_eval``; a :class:`~repro_torch.serve.clock.
MonotonicClock` stamps real time.  Admission policies live in
:mod:`repro_torch.serve.scheduler`.

Guarantees, as in the JAX package: each returned sample equals the
single-request SRDS result for its ``(tol, num_steps, seed, solver,
schedule)``; converged and empty lanes are frozen with ``torch.where``, so
batch-mates never perturb a lane.  Bitwise for elementwise denoisers;
matmul denoisers agree to roundoff, because the group frontier and the
slot count set the fine solves' GEMM shapes.  ``ResidualWindow`` and an
accelerating ``accel`` trade exactness for evals or iterations.

Request noise comes from ``noise_fn(seed, shape, dtype, device)``; the
default draws from a ``torch.Generator`` seeded with the request's seed
(not the JAX package's ``PRNGKey`` stream, which torch cannot reproduce).
The stochastic ``ddpm`` solver needs ``allow_inexact=True``: its frozen
noise is drawn per interval for the whole micro-batch, so a lane's
realization depends on its batch (same distribution, not the
single-request run's bits).

Over a ``torch.distributed`` mesh (SPMD: every rank builds the same
engine and submits the same requests), the fine solves of a refinement
split over the mesh's dims: its blocks over ``axis``, its K lanes over
``data_axis``, and a model-parallel denoiser's sample dims over its own
(``parallel.sharding.denoiser_spec``; the body runs ``shard_eval``, the
DiT's rows with their K/V gathered), rejoined by one all-gather a split
dim a refinement.  The coarse sweep and the corrector run on the whole
arrays, through the denoiser bound to the mesh.  The engine's state is
whole on every rank, so admission, slots, gating and the one host read a
refinement are those of one device.  Truncating policies fall back to
``FixedBudget`` when ``axis`` is set (the split needs every block).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.accel import resolve_accel
from repro_torch.core.denoiser import as_denoiser, check_driver_dims
from repro_torch.core.engine import (IterationCost, blockwise_norm,
                                     coarse_init_sweep, convergence_norm,
                                     fold_fine, fold_fine_fn,
                                     iteration_cost,
                                     predicted_evals, prefix_frontier,
                                     resolve_blocks, resolve_fused,
                                     suffix_refinement, truncated_evals)
from repro_torch.core.schedules import make_schedule
from repro_torch.core.solvers import ModelFn, SolverConfig, solve, solver_names
from repro_torch.core.window import FixedBudget, resolve_policy
from repro_torch.parallel.collectives import check_backend
from repro_torch.parallel.sharding import (denoiser_spec, gather_spec,
                                          mesh_shape, microbatch_spec,
                                          slice_spec)
from repro_torch.serve.clock import Clock, VirtualClock
from repro_torch.transfer import host_to_device

__all__ = ["SampleRequest", "SampleResponse", "CompletionRecord",
           "DiffusionSamplingEngine", "IterationEMA", "default_noise"]


def hot_loop(fn):
    """Marks a function of the serving hot loop, where every device read
    goes through :func:`_host_fetch` (reprolint's RL003 checks the bodies
    of functions so marked)."""
    return fn


class _Fetch(NamedTuple):
    """A device-to-host copy in flight: the host buffer and, on a CUDA
    device, the event recorded after the copy was enqueued."""
    host: torch.Tensor
    done: Optional[torch.cuda.Event]


def _start_fetch(x: torch.Tensor, stream=None, after=None) -> _Fetch:
    """Enqueue a copy of ``x`` to the host without waiting for it: into
    pinned memory, non-blocking, on ``stream`` (default: the current one)
    after the event ``after``.  A CPU tensor is copied at once."""
    if not x.is_cuda:
        return _Fetch(x.detach().clone(), None)
    stream = torch.cuda.current_stream(x.device) if stream is None \
        else stream
    if after is not None:
        stream.wait_event(after)
    with torch.cuda.stream(stream):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return _Fetch(host, done)


def _host_fetch(fetch: _Fetch) -> np.ndarray:
    """The single device->host transfer point of the serving hot loop.

    The resolve step calls it exactly once per refinement (the batched
    residual vector) plus once per *completed* request (that lane's final
    state only).  It waits on the copy's event and on nothing else.
    Tests monkeypatch it to count syncs.
    """
    if fetch.done is not None:
        fetch.done.synchronize()
    return fetch.host.numpy()


def default_noise(seed: int, shape: Tuple[int, ...], dtype,
                  device) -> torch.Tensor:
    """A request's ``x_init ~ N(0, I)``, from a generator on ``device``
    seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


class IterationEMA:
    """Online per-tier expected-iterations predictor: an exponential
    moving average of observed refinement counts keyed by ``(compat_key,
    tol)``, feeding :meth:`DiffusionSamplingEngine.predict_completion`."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._mean: Dict[tuple, float] = {}

    def observe(self, key: tuple, iterations: int) -> None:
        prev = self._mean.get(key)
        self._mean[key] = float(iterations) if prev is None \
            else prev + self.alpha * (float(iterations) - prev)

    def predict(self, key: tuple) -> Optional[float]:
        return self._mean.get(key)

    def reset(self) -> None:
        self._mean.clear()


@dataclasses.dataclass
class SampleRequest:
    """One sampling job: draw x_init from ``seed`` and run SRDS to the
    requester's tolerance on a ``num_steps`` grid.  ``deadline`` is
    absolute on the virtual clock, ``deadline_wall`` on a wall clock,
    ``slo_ms`` relative to arrival on either; none means best effort.
    ``solver``/``schedule``/``shape`` override the engine defaults and
    join the compatibility key.  ``iters_hint`` feeds the cost model."""
    seed: int
    tol: float = 1e-3
    num_steps: Optional[int] = None
    arrival_time: float = 0.0
    slo_ms: Optional[float] = None
    deadline: Optional[float] = None
    deadline_wall: Optional[float] = None
    solver: Optional[SolverConfig] = None
    schedule: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None
    iters_hint: Optional[int] = None

    def absolute_deadline(self, wall: bool = False) -> float:
        """The deadline in one clock regime: ``deadline_wall`` when
        ``wall``, else ``deadline``; both fall back to ``slo_ms`` past
        arrival, then +inf."""
        absolute = self.deadline_wall if wall else self.deadline
        if absolute is not None:
            return float(absolute)
        if self.slo_ms is not None:
            return self.arrival_time + self.slo_ms / 1e3
        return math.inf


@dataclasses.dataclass
class SampleResponse:
    sample: Optional[np.ndarray]         # None only for status="preempted"
    iterations: int
    final_delta: float
    delta_history: np.ndarray            # (iterations,) f32
    model_evals: int                     # effective evals charged to this job
    status: str = "ok"                   # "ok" | "preempted"
    arrival_time: float = 0.0
    finish_time: float = 0.0
    latency: float = 0.0                 # finish - arrival (clock seconds)
    deadline: float = math.inf
    slo_met: bool = True


@dataclasses.dataclass(frozen=True)
class CompletionRecord:
    """Host-side latency ledger entry (one per finished/preempted request)."""
    rid: int
    arrival_time: float
    finish_time: float
    deadline: float
    latency: float
    slo_met: bool
    status: str


def _solver_fp(solver: SolverConfig):
    """Hashable fingerprint of a SolverConfig: ``ddpm`` requests with
    another ``eta`` or noise source never share a micro-batch."""
    return (solver.name, solver.eta, solver.use_fused_kernel,
            solver.noise_seed, solver.noise_fn)


class _Slot:
    __slots__ = ("rid", "req", "iters", "history", "evals")

    def __init__(self, rid: int, req: SampleRequest):
        self.rid = rid
        self.req = req
        self.iters = 0
        self.history: List[float] = []
        self.evals = 0       # realized charge (residual-window billing)


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unresolved refinement of a micro-batch: the
    residual copy in flight, the post-step final-block snapshot (a
    completed lane's sample is cut from it), and the dispatch-time lane
    census ``(slot, rid, effective evals)`` — a lane that completed or was
    evicted before resolve is skipped (its refinement here was
    speculative, charged physically but never effectively)."""
    batch: "_MicroBatch"
    fetch: _Fetch                        # (K,) or (K+B,) residuals
    snap: torch.Tensor                   # (K, *shape) final tails
    lanes: List[Tuple[int, int, int]]
    windowed: bool
    lo: int                              # window lower bound at dispatch
    phys: int                            # physical evals (incl. lane inits)
    init_eff: int                        # effective evals of lane inits
    epoch: int                           # batch.window_epoch at dispatch


class _MicroBatch:
    """State of one compatibility group's K-slot batch: the device
    tensors and per-slot bookkeeping; the engine owns admission and step
    order."""

    def __init__(self, engine: "DiffusionSamplingEngine", n: int,
                 schedule: str, shape: Tuple[int, ...], solver: SolverConfig):
        self.engine = engine
        self.n = n
        self.schedule = schedule
        self.shape = shape
        self.solver = solver
        (self.init_fn, self.step_for, self.B, self.S) = \
            engine._build_program(n, schedule, shape, solver)
        self.cost: IterationCost = iteration_cost(n, engine.num_blocks,
                                                  solver.evals_per_step)
        self.max_iters = engine.max_iters if engine.max_iters is not None \
            else self.B
        # step functions are cached per quantized frontier; the quantum
        # bounds the cache at about 4 per group
        self.trunc_q = engine.truncate_quantum \
            if engine.truncate_quantum is not None else max(1, self.B // 4)
        self.policy = engine.window
        # residual-window group state: the window's lower bound, reset to
        # 0 when a fresh lane is admitted
        self.lo = 0
        self.inflight = 0
        self.window_epoch = 0
        K = engine.batch_size
        dev, dt = engine.device, engine.dtype
        self.x_init = torch.zeros((K,) + shape, dtype=dt, device=dev)
        self.x_tail = torch.zeros((self.B, K) + shape, dtype=dt, device=dev)
        self.prev_coarse = torch.zeros_like(self.x_tail)
        self.astate = engine.accel.init_state(
            torch.stack([self.x_tail, self.x_tail]), self.max_iters,
            batched=True) if engine.accel.accelerates else None
        self.active = np.zeros((K,), bool)
        self.slots: List[Optional[_Slot]] = [None] * K
        self.newly: List[int] = []

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def busy(self) -> bool:
        return any(s is not None for s in self.slots)

    def admit(self, rid: int, req: SampleRequest) -> int:
        """Place a request into a free slot (init happens at the next
        step).  Writing the lane in place is safe: every step that read
        ``x_init`` before was enqueued earlier on the same stream."""
        eng = self.engine
        for k, s in enumerate(self.slots):
            if s is None:
                self.x_init[k] = eng.noise_fn(req.seed, self.shape,
                                              eng.dtype, eng.device)
                self.slots[k] = _Slot(rid, req)
                self.active[k] = True
                self.newly.append(k)
                # a fresh lane's blocks are all unconverged: re-open the
                # shared window; the epoch keeps an in-flight step's
                # resolve from advancing the reset window
                self.lo = 0
                self.window_epoch += 1
                return k
        raise RuntimeError("admit() called with no free slot")

    def evict(self, rid: int) -> Tuple[SampleRequest, SampleResponse]:
        """Preempt a running request: free its slot, discard its lane."""
        for k, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                self.slots[k] = None
                self.active[k] = False
                uninitialized = k in self.newly
                if uninitialized:
                    self.newly.remove(k)
                return s.req, SampleResponse(
                    sample=None, iterations=s.iters,
                    final_delta=s.history[-1] if s.history else float("inf"),
                    delta_history=np.asarray(s.history, np.float32),
                    model_evals=0 if uninitialized
                    else self._slot_evals(s),
                    status="preempted")
        raise KeyError(f"request {rid} is not running in this batch")

    def _lane_evals(self, iters: int) -> int:
        """Per-lane charge for ``iters`` refinements in the engine's mode."""
        return truncated_evals(self.cost, iters) if self.engine.truncate \
            else predicted_evals(self.cost, iters)

    def _slot_evals(self, s: _Slot) -> int:
        """Residual-window lanes bill their realized schedule; exact
        policies the per-lane ideal one."""
        if self.policy.needs_block_residuals:
            return s.evals
        return self._lane_evals(s.iters)

    def _refine_evals_at(self, frontier: int) -> int:
        return self.cost.refine_evals_at(frontier) if self.engine.truncate \
            else self.cost.refine_evals

    def _static_frontier(self) -> int:
        """The min bitwise-frozen prefix over active lanes."""
        fr = [prefix_frontier(s.iters) for k, s in enumerate(self.slots)
              if s is not None and self.active[k]]
        return min(fr) if fr else 0

    def _frontier(self) -> int:
        """Group frontier snapped down to the truncation quantum (less
        truncation than provable, always sound)."""
        minf = (self._static_frontier() // self.trunc_q) * self.trunc_q
        return min(minf, self.B - 1)

    def _window_frontier(self) -> Tuple[int, int]:
        """``(lo, minf)``: the effective window bound (the policy's,
        floored at the provable frontier, capped at B-1) and its quantized
        floor, where the step's suffix starts; ``[minf, lo)`` is masked."""
        lo = min(max(self.lo, self._static_frontier()), self.B - 1)
        minf = min((lo // self.trunc_q) * self.trunc_q, self.B - 1)
        return lo, minf

    def step_evals(self) -> int:
        """Physical evals of this batch's next refinement."""
        if self.policy.needs_block_residuals:
            _, minf = self._window_frontier()
        else:
            minf = self._frontier() if self.engine.truncate else 0
        return self.engine.batch_size * self._refine_evals_at(minf)

    @hot_loop
    def dispatch(self) -> _InFlight:
        """Enqueue one lockstep refinement (pending lane inits included)
        with no device->host sync; the token carries the residual copy in
        flight and the post-step final-block snapshot.  A lane that
        converged on the still unresolved previous refinement gets one
        speculative refinement here, never observable: its sample is cut
        from the previous step's snapshot."""
        eng = self.engine
        K = eng.batch_size
        init_eff = phys = 0
        if self.newly:
            m = np.zeros((K,), bool)
            m[self.newly] = True
            new_mask = host_to_device(m, eng.device)
            self.x_tail, self.prev_coarse = self.init_fn(
                self.x_init, self.x_tail, self.prev_coarse, new_mask)
            if self.astate is not None:
                # a recycled slot's mixing history belongs to its previous
                # tenant
                self.astate = eng.accel.reset_lanes(self.astate, new_mask)
            init_eff = len(self.newly) * self.cost.init_evals
            phys += K * self.cost.init_evals
            for k in self.newly:
                self.slots[k].evals = self.cost.init_evals
            self.newly = []
            eng.init_sweeps += 1

        amask = host_to_device(self.active, eng.device)
        carry = (self.astate,) if self.astate is not None else ()
        if self.policy.needs_block_residuals:
            lo, minf = self._window_frontier()
            out = self.step_for.windowed(minf)(
                self.x_init, self.x_tail, self.prev_coarse, amask, lo,
                *carry)
            per_lane = self.cost.refine_evals_window(lo)
            lanes = [(k, s.rid, per_lane)
                     for k, s in enumerate(self.slots)
                     if s is not None and self.active[k]]
            phys += K * self.cost.refine_evals_window(minf)
            windowed = True
        else:
            minf = self._frontier() if eng.truncate else 0
            lo = minf
            out = self.step_for(minf)(self.x_init, self.x_tail,
                                      self.prev_coarse, amask, *carry)
            # effective: each lane at its own frontier; physical: K lanes
            # at the group frontier
            lanes = [(k, s.rid,
                      self._refine_evals_at(prefix_frontier(s.iters)))
                     for k, s in enumerate(self.slots)
                     if s is not None and self.active[k]]
            phys += K * self._refine_evals_at(minf)
            windowed = False
        self.x_tail, self.prev_coarse, fetch = out[:3]
        if self.astate is not None:
            self.astate = out[3]
        eng.refine_frontiers.append(minf)
        self.inflight += 1
        return _InFlight(batch=self, fetch=_start_fetch(fetch),
                         snap=self.x_tail[-1], lanes=lanes,
                         windowed=windowed, lo=lo, phys=phys,
                         init_eff=init_eff, epoch=self.window_epoch)

    @hot_loop
    def resolve(self, tok: _InFlight):
        """Land a dispatched refinement: wait for its residual copy,
        update lane bookkeeping, finalize converged slots.  Returns
        ``(completions, effective_evals, physical_evals)``."""
        K = self.engine.batch_size
        self.inflight -= 1
        fetched = _host_fetch(tok.fetch)     # the one per-refinement sync
        delta_np = fetched[:K]
        if tok.windowed and tok.epoch == self.window_epoch:
            # advance the shared window from the lane-max residuals; an
            # admission since dispatch re-opened it, and its reset wins
            self.lo = max(self.lo, int(self.policy.advance(
                tok.lo, fetched[K:], self.B)))

        eff = tok.init_eff
        completed: List[Tuple[int, SampleRequest, SampleResponse]] = []
        for k, rid, lane_eff in tok.lanes:
            slot = self.slots[k]
            if slot is None or slot.rid != rid:
                continue          # speculative: physical, never effective
            eff += lane_eff
            if tok.windowed:
                slot.evals += lane_eff
            slot.iters += 1
            slot.history.append(float(delta_np[k]))
            # f32 compare, matching the engine's still_refining gate
            if (delta_np[k] < np.float32(slot.req.tol)
                    or slot.iters >= self.max_iters):
                sample = _host_fetch(_start_fetch(
                    tok.snap[k], stream=self.engine.fetch_stream,
                    after=tok.fetch.done))
                completed.append((slot.rid, slot.req, SampleResponse(
                    sample=sample, iterations=slot.iters,
                    final_delta=slot.history[-1],
                    delta_history=np.asarray(slot.history, np.float32),
                    model_evals=self._slot_evals(slot))))
                self.slots[k] = None
                self.active[k] = False
        return completed, eff, tok.phys


class DiffusionSamplingEngine:
    """Micro-batching SRDS sampling service with per-slot convergence
    gating (see the module docstring; the arguments are those of
    ``repro.serve.diffusion.DiffusionSamplingEngine``).

    Args:
      model_fn: eps-predictor ``(x (M, ...), t (M,)) -> eps``.
      sample_shape / solver / schedule / num_steps: request defaults.
      batch_size: K, the slots of each micro-batch.
      num_blocks / max_iters / norm: SRDS knobs, as in ``SRDSConfig``.
      mesh / axis / data_axis: a ``DeviceMesh`` and the names of its
        dims that split the fine solves' blocks (``axis``; ``num_blocks``
        must divide) and the slot batch (``data_axis``; ``batch_size``
        must divide).  A model-parallel denoiser is bound to ``mesh``
        (without one it needs a bound mesh) and splits its own dims.
      allow_inexact: the opt-in for the stochastic ``ddpm`` solver,
        whose batch-shaped frozen noise gives distribution-level, not
        lane-exact, results.
      sec_per_eval: virtual seconds per physical eval, and the cost
        model's per-eval price on either clock.
      dtype: the latents' dtype; the schedule runs in it too.
      truncate / window / truncate_quantum: the frontier policy and the
        frontier quantum (None: B // 4).
      use_fused: the fused update kernels (None: on for a CUDA device).
      ema_alpha: the :class:`IterationEMA` rate.
      clock: ``None`` -> a :class:`VirtualClock`.
      accel: an :class:`repro_torch.core.accel.Accelerator`; a truncating
        policy needs a ``prefix_exact`` one (``TriangularAccel``).
      device: where the latents live (default ``"cuda"``).
      noise_fn: ``(seed, shape, dtype, device) -> x_init`` on ``device``
        (default :func:`default_noise`).
    """

    def __init__(self, model_fn: ModelFn, sample_shape: Tuple[int, ...],
                 solver: SolverConfig = SolverConfig("ddim"),
                 schedule: str = "ddpm_linear", num_steps: int = 64,
                 batch_size: int = 4, num_blocks: Optional[int] = None,
                 max_iters: Optional[int] = None, norm: str = "l1_mean",
                 mesh=None, axis: Optional[str] = None,
                 data_axis: Optional[str] = None,
                 allow_inexact: bool = False, sec_per_eval: float = 1e-6,
                 dtype=torch.float32, truncate: bool = True,
                 truncate_quantum: Optional[int] = None,
                 use_fused: Optional[bool] = None, ema_alpha: float = 0.3,
                 window=None, clock: Optional[Clock] = None, accel=None,
                 device="cuda",
                 noise_fn: Optional[Callable] = None):
        self.model_fn = model_fn
        # a model-parallel denoiser is bound to the engine's mesh: the
        # coarse sweep and the corrector evaluate it standalone
        den = as_denoiser(model_fn)
        if den.is_model_parallel:
            if mesh is not None:
                den.check_mesh(mesh)
                if den.mesh is None:
                    den = den.bind(mesh)
            elif den.mesh is None:
                raise ValueError(
                    "model-parallel denoiser needs a mesh: pass mesh= to "
                    "the engine or bind one with Denoiser.bind(mesh)")
        self.denoiser = den
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.sample_shape = tuple(sample_shape)
        self.solver = solver
        self.schedule = schedule
        self.num_steps = num_steps
        self.batch_size = batch_size
        self.num_blocks = num_blocks
        self.max_iters = max_iters
        self.norm = norm
        self.allow_inexact = allow_inexact
        self.sec_per_eval = sec_per_eval
        self.dtype = dtype
        self.device = torch.device(device)
        self.noise_fn = noise_fn if noise_fn is not None else default_noise
        pol = resolve_policy(window, truncate)
        if axis is not None and pol.truncates:
            # the block split slices the full block dim
            pol = FixedBudget()
        self.window = pol
        self.truncate = pol.truncates
        self.truncate_quantum = truncate_quantum
        self.accel = resolve_accel(accel)
        if self.accel.accelerates and pol.truncates \
                and not self.accel.prefix_exact:
            # the pairing rule of run_parareal
            raise ValueError(
                f"{type(self.accel).__name__} does not preserve the "
                f"serial-prefix invariant that the engine's truncating "
                f"frontier policy ({type(pol).__name__}) relies on; use "
                f"TriangularAccel, or build the engine with truncate=False "
                f"/ window=FixedBudget().")
        self.use_fused = resolve_fused(
            use_fused, torch.empty(0, device=self.device))
        if axis is not None or data_axis is not None:
            if mesh is None:
                raise ValueError("axis and data_axis require a mesh")
            # unbound names raise
            denoiser_spec(data_axis, den, mesh=mesh)
            if axis is not None:
                microbatch_spec(axis, mesh=mesh)
            check_driver_dims(mesh, den, axis, data_axis)
        if data_axis is not None:
            d = mesh_shape(mesh)[data_axis]
            if batch_size % d != 0:
                raise ValueError(f"batch_size={batch_size} not divisible by "
                                 f"data axis size {d}")
        if mesh is not None:
            check_backend(mesh.get_group(mesh.mesh_dim_names[0]),
                          torch.empty(0, device=self.device))
        # completed lanes' samples are copied on their own stream, so the
        # copy does not queue behind a refinement dispatched after them
        self.fetch_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.iters_ema = IterationEMA(alpha=ema_alpha)
        self._queue: List[Tuple[int, SampleRequest]] = []
        self._next_rid = 0
        self._programs: Dict[tuple, Tuple[Callable, Callable, int, int]] = {}
        self._batches: Dict[tuple, _MicroBatch] = {}
        self._rr = 0
        self._first_arrival: Optional[float] = None
        self.effective_evals = 0
        self.physical_evals = 0
        self.requests_served = 0
        # the refinement record: the suffix start of every dispatched
        # refinement and the count of coarse-init sweeps (what a run
        # launched, speculative refinements included)
        self.refine_frontiers: List[int] = []
        self.init_sweeps = 0
        self._clock = clock if clock is not None else VirtualClock()
        self.records: List[CompletionRecord] = []

    # ------------------------------------------------------------------ API

    @property
    def clock(self) -> float:
        """Current engine time in seconds (virtual or wall)."""
        return self._clock.now()

    def request_deadline(self, req: SampleRequest) -> float:
        """``req``'s absolute deadline in this engine's clock regime."""
        return req.absolute_deadline(wall=self._clock.is_wall)

    def _resolve(self, req: SampleRequest):
        """(num_steps, schedule, shape, solver) with engine defaults filled."""
        n = req.num_steps if req.num_steps is not None else self.num_steps
        schedule = req.schedule if req.schedule is not None else self.schedule
        shape = tuple(req.shape) if req.shape is not None \
            else self.sample_shape
        solver = req.solver if req.solver is not None else self.solver
        return n, schedule, shape, solver

    def compat_key(self, req: SampleRequest) -> tuple:
        """Requests agreeing on (num_steps, schedule, shape, solver) share
        one micro-batch group."""
        n, schedule, shape, solver = self._resolve(req)
        return (n, schedule, shape, _solver_fp(solver))

    def submit(self, req: SampleRequest) -> int:
        """Enqueue a request; returns its id.  Unservable grids, unknown
        solvers or schedules, and ``ddpm`` without ``allow_inexact`` are
        rejected here."""
        n, schedule, shape, solver = self._resolve(req)
        resolve_blocks(n, self.num_blocks)   # raises on an unservable grid
        if solver.name not in solver_names():
            raise ValueError(f"unknown solver {solver.name!r}; "
                             f"have {solver_names()}")
        make_schedule(schedule, n)           # raises on an unknown family
        if solver.name == "ddpm" and not self.allow_inexact:
            raise ValueError(
                "stochastic 'ddpm' solver draws batch-shaped noise, so "
                "per-request lane-exactness vs the single-request run is "
                "NOT guaranteed under micro-batching; construct the engine "
                "with allow_inexact=True to accept distribution-level "
                "(not bitwise) results.")
        rid = self._next_rid
        self._next_rid += 1
        self._first_arrival = req.arrival_time \
            if self._first_arrival is None \
            else min(self._first_arrival, req.arrival_time)
        self._queue.append((rid, req))
        return rid

    def drain(self) -> Dict[int, SampleResponse]:
        """Run every queued request to convergence (FIFO admission as
        slots recycle, busy batches round-robin); returns rid -> response."""
        results: Dict[int, SampleResponse] = {}
        queue = self.pull_queue()
        while queue or self.busy():
            remaining: List[Tuple[int, SampleRequest]] = []
            for rid, req in queue:
                if req.arrival_time <= self.clock and self.free_slots(req) > 0:
                    self.admit(rid, req)
                else:
                    remaining.append((rid, req))
            queue = remaining
            if self.busy():
                for rid, resp in self.step_once():
                    results[rid] = resp
            elif queue:
                self.advance_clock(min(r.arrival_time for _, r in queue))
        return results

    def stats(self) -> Dict[str, float]:
        served = max(self.requests_served, 1)
        lats = [r.latency for r in self.records if r.status == "ok"]
        with_slo = [r for r in self.records if math.isfinite(r.deadline)]
        met = sum(1 for r in self.records if r.status == "ok" and r.slo_met)
        p50, p95, p99 = (np.percentile(lats, [50, 95, 99])
                         if lats else (0.0, 0.0, 0.0))
        start = self._first_arrival if self._first_arrival is not None \
            else min((r.arrival_time for r in self.records), default=0.0)
        span = self.clock - start
        return {
            "requests_served": self.requests_served,
            "effective_evals": self.effective_evals,
            "physical_evals": self.physical_evals,
            "effective_evals_per_sample": self.effective_evals / served,
            "physical_evals_per_sample": self.physical_evals / served,
            "latency_p50": float(p50),
            "latency_p95": float(p95),
            "latency_p99": float(p99),
            "slo_attainment": (sum(1 for r in with_slo
                                   if r.status == "ok" and r.slo_met)
                               / len(with_slo)) if with_slo else 1.0,
            "goodput_rps": met / span if span > 0 else 0.0,
            "virtual_time": self.clock,
        }

    def reset_metrics(self) -> None:
        """Zero the clock, eval counters, refinement record and latency
        ledger; the step functions stay cached."""
        if self.busy() or self._queue:
            raise RuntimeError("reset_metrics() with requests in flight")
        self._next_rid = 0
        self._rr = 0
        self._first_arrival = None
        self._batches = {}
        self.effective_evals = 0
        self.physical_evals = 0
        self.requests_served = 0
        self.refine_frontiers = []
        self.init_sweeps = 0
        self._clock.reset()
        self.records = []
        self.iters_ema.reset()

    # ------------------------------------------------- scheduling primitives

    def pull_queue(self) -> List[Tuple[int, SampleRequest]]:
        """Take ownership of the submitted-but-unadmitted queue."""
        q, self._queue = self._queue, []
        return q

    def _batch_for(self, req: SampleRequest) -> _MicroBatch:
        key = self.compat_key(req)
        if key not in self._batches:
            n, schedule, shape, solver = self._resolve(req)
            self._batches[key] = _MicroBatch(self, n, schedule, shape, solver)
        return self._batches[key]

    def free_slots(self, req: SampleRequest) -> int:
        """Free slots in ``req``'s group (an unseen group is all free and
        is not instantiated)."""
        b = self._batches.get(self.compat_key(req))
        return self.batch_size if b is None else b.free_slots()

    def admit(self, rid: int, req: SampleRequest) -> None:
        """Place a validated request into its group's batch (a free slot
        must exist); the clock catches up to its arrival."""
        self.advance_clock(req.arrival_time)
        self._batch_for(req).admit(rid, req)

    def busy(self) -> bool:
        return any(b.busy() for b in self._batches.values())

    @hot_loop
    def step_once(self) -> List[Tuple[int, SampleResponse]]:
        """One synchronous refinement on the next busy micro-batch:
        dispatch and resolve back to back."""
        tok = self.step_dispatch()
        if tok is None:
            return []
        return self.step_resolve(tok)

    def step_dispatch(self, max_inflight: int = 2) -> Optional[_InFlight]:
        """Dispatch one refinement on the next busy micro-batch
        (round-robin) with fewer than ``max_inflight`` unresolved steps;
        ``None`` when nothing is dispatchable.  No host sync.  Tokens
        resolve in dispatch order."""
        batches = list(self._batches.values())
        for off in range(len(batches)):
            b = batches[(self._rr + off) % len(batches)]
            if b.busy() and b.inflight < max_inflight:
                self._rr = (self._rr + off + 1) % len(batches)
                return b.dispatch()
        return None

    @hot_loop
    def step_resolve(self, tok: _InFlight) -> List[Tuple[int,
                                                         SampleResponse]]:
        """Land a dispatched refinement (its one host sync), account its
        evals, charge the clock and finalize completions."""
        completed, eff, phys = tok.batch.resolve(tok)
        self.effective_evals += eff
        self.physical_evals += phys
        self._clock.charge(phys * self.sec_per_eval)
        return [(rid, self._finalize(rid, req, resp))
                for rid, req, resp in completed]

    def evict(self, rid: int) -> SampleResponse:
        """Preempt a running request (recorded as status="preempted")."""
        for b in self._batches.values():
            try:
                req, resp = b.evict(rid)
            except KeyError:
                continue
            return self._finalize(rid, req, resp)
        raise KeyError(f"request {rid} is not running")

    def advance_clock(self, until: float) -> None:
        """Idle forward: a virtual clock warps, a wall clock sleeps."""
        self._clock.wait_until(until)

    def predict_iterations(self, req: SampleRequest) -> float:
        """The most optimistic of the per-tier EMA and ``iters_hint``;
        worst-case ``max_iters`` when neither exists."""
        n, _, _, _ = self._resolve(req)
        B, _ = resolve_blocks(n, self.num_blocks)
        cap = self.max_iters if self.max_iters is not None else B
        cands = [self.iters_ema.predict((self.compat_key(req),
                                         float(req.tol)))]
        if req.iters_hint is not None:
            cands.append(float(req.iters_hint))
        cands = [c for c in cands if c is not None]
        est = min(cands) if cands else float(cap)
        return min(float(est), float(cap))

    def predict_completion(self, req: SampleRequest,
                           now: Optional[float] = None) -> float:
        """Cost-model completion estimate if ``req`` were admitted now:
        the policy's eval pricing times the K-lane width for
        :meth:`predict_iterations` refinements, plus one step of every
        other busy group per refinement round (they share the device)."""
        now = self.clock if now is None else now
        n, _, _, solver = self._resolve(req)
        cost = iteration_cost(n, self.num_blocks, solver.evals_per_step)
        iters = self.predict_iterations(req)
        evals = self.batch_size * self.window.predict_evals(cost, iters)
        key = self.compat_key(req)
        rounds = int(math.ceil(iters))
        contention = rounds * sum(
            b.step_evals() for bkey, b in self._batches.items()
            if bkey != key and b.busy())
        return now + (evals + contention) * self.sec_per_eval

    def _finalize(self, rid: int, req: SampleRequest,
                  resp: SampleResponse) -> SampleResponse:
        """Stamp clock latency/SLO fields and ledger the outcome."""
        resp.arrival_time = req.arrival_time
        resp.finish_time = self.clock
        resp.latency = resp.finish_time - req.arrival_time
        resp.deadline = self.request_deadline(req)
        resp.slo_met = resp.status == "ok" \
            and resp.finish_time <= resp.deadline
        if resp.status == "ok":
            self.requests_served += 1
            self.iters_ema.observe((self.compat_key(req), float(req.tol)),
                                   resp.iterations)
        self.records.append(CompletionRecord(
            rid=rid, arrival_time=resp.arrival_time,
            finish_time=resp.finish_time, deadline=resp.deadline,
            latency=resp.latency, slo_met=resp.slo_met, status=resp.status))
        return resp

    # -------------------------------------------------------- step functions

    def _build_program(self, n: int, schedule: str, shape: Tuple[int, ...],
                       solver: SolverConfig):
        """(init_fn, step_for, B, S) for one compatibility group (cached).

        ``step_for(minf)`` is the one-refinement function whose fine
        solves and corrector sweep cover the block suffix ``[minf, B)``,
        cached per quantized frontier (``step_for.cache``);
        ``step_for.windowed(minf)`` the residual-window one.
        """
        key = (n, schedule, shape, _solver_fp(solver))
        if key in self._programs:
            return self._programs[key]
        B, S = resolve_blocks(n, self.num_blocks)
        # the schedule runs in the engine's dtype, as srds_sample's would
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        sched = make_schedule(schedule, n).astype(np_dtype)
        starts = np.arange(B, dtype=np.int64) * S
        den, norm = self.denoiser, self.norm
        use_fused, accel = self.use_fused, self.accel

        def G(x, i0):
            return solve(den, sched, solver, x, i0, 1, S)

        fine = self._make_fine(sched, solver, starts, B, S)

        def init_fn(x_init, x_tail, prev_coarse, new_mask):
            """Coarse init of the whole slot batch; only the new lanes
            take it (occupied lanes keep their refined trajectories)."""
            tail0 = coarse_init_sweep(G, x_init, starts)
            m = new_mask.reshape((1,) + new_mask.shape + (1,) * len(shape))
            return (torch.where(m, tail0, x_tail),
                    torch.where(m, tail0, prev_coarse))

        def refine(x_init, x_tail, prev_coarse, active, minf, lo=None):
            """One refinement over all K slots on the suffix [minf, B)
            (blocks [minf, lo) masked), inactive slots frozen."""
            heads = torch.cat([x_init[None], x_tail[:-1]], dim=0)[minf:]
            out = suffix_refinement(
                G, fine(heads), x_init, x_tail, prev_coarse, starts, minf,
                use_fused=use_fused, norm=norm, batched=True, window_lo=lo)
            m = active.reshape((1,) + active.shape
                               + (1,) * (x_tail.dim() - 2))
            new_tail = torch.where(m, out[0], x_tail)
            cur_all = torch.where(m, out[1], prev_coarse)
            return m, new_tail, cur_all, out[2:]

        def mixed(x_tail, prev_coarse, active, m, new_tail, cur_all, live,
                  astate):
            """The accelerator's mix of the committed iterate, per lane
            and live-masked; inactive lanes re-frozen bitwise."""
            z_mix, astate = accel.apply(
                astate, torch.stack([x_tail, prev_coarse]),
                torch.stack([new_tail, cur_all]), live=live, batched=True)
            return (torch.where(m, z_mix[0], x_tail),
                    torch.where(m, z_mix[1], prev_coarse), astate)

        step_cache: Dict[int, Callable] = {}
        step_win_cache: Dict[int, Callable] = {}

        def make_step(minf: int):
            def step_fn(x_init, x_tail, prev_coarse, active, *carry):
                """Returns ``(new_tail, cur_all, delta[, astate])``;
                inactive lanes' residuals read +inf."""
                m, new_tail, cur_all, (delta,) = refine(
                    x_init, x_tail, prev_coarse, active, minf)
                if carry:
                    live = (torch.arange(B, device=x_tail.device) >= minf) \
                        if minf else None
                    new_tail, cur_all, astate = mixed(
                        x_tail, prev_coarse, active, m, new_tail, cur_all,
                        live, carry[0])
                    # the gate must see what was committed
                    delta = convergence_norm(new_tail[-1] - x_tail[-1],
                                             norm, batched=True)
                    carry = (astate,)
                delta = torch.where(active, delta, math.inf)
                return (new_tail, cur_all, delta) + carry
            return step_fn

        def make_step_windowed(minf: int):
            def step_fn(x_init, x_tail, prev_coarse, active, lo, *carry):
                """Returns ``(new_tail, cur_all, cat([delta, br_g])[,
                astate])``: the (B,) lane-max block residual rides the one
                fetch.  The window advances only past blocks every active
                lane passed."""
                m, new_tail, cur_all, (delta, br) = refine(
                    x_init, x_tail, prev_coarse, active, minf, lo)
                if carry:
                    live = torch.arange(B, device=x_tail.device) >= lo
                    new_tail, cur_all, astate = mixed(
                        x_tail, prev_coarse, active, m, new_tail, cur_all,
                        live, carry[0])
                    # full-width post-mix block residuals (frozen: 0)
                    br = blockwise_norm(new_tail - x_tail, norm,
                                        batched=True)
                    delta = br[-1]
                    carry = (astate,)
                delta = torch.where(active, delta, math.inf)
                br_g = torch.where(active[None, :], br, 0.0).amax(dim=1)
                if br_g.shape[0] < B:
                    br_g = torch.cat([br_g.new_zeros(B - br_g.shape[0]),
                                      br_g])
                return (new_tail, cur_all,
                        torch.cat([delta, br_g])) + carry
            return step_fn

        def step_for(minf: int) -> Callable:
            if minf not in step_cache:
                step_cache[minf] = make_step(minf)
            return step_cache[minf]

        def step_windowed(minf: int) -> Callable:
            if minf not in step_win_cache:
                step_win_cache[minf] = make_step_windowed(minf)
            return step_win_cache[minf]

        step_for.cache = step_cache
        step_for.windowed = step_windowed
        step_windowed.cache = step_win_cache
        self._programs[key] = (init_fn, step_for, B, S)
        return self._programs[key]

    def _make_fine(self, sched, solver: SolverConfig, starts: np.ndarray,
                   B: int, S: int) -> Callable:
        """The fine solves of a refinement's block heads ``(b, K,
        *shape)``: one batch on one device, or this rank's blocks
        (``axis``), lanes (``data_axis``) and a model-parallel denoiser's
        sample dims (its ``shard_eval``) of them, rejoined by one
        all-gather a split dim."""
        den, mesh = self.denoiser, self.mesh

        if mesh is None or (self.axis is None and self.data_axis is None
                            and not den.is_model_parallel):
            def F(x, i0):     # standalone: self-wraps if model-parallel
                return solve(den, sched, solver, x, i0, S, 1)
            return fold_fine_fn(F, starts)

        spec = denoiser_spec(self.data_axis, den, mesh=mesh)
        ev = den.shard_eval(mesh)
        if self.axis is not None:
            d = mesh_shape(mesh)[self.axis]
            if B % d != 0:
                raise ValueError(f"num_blocks={B} not divisible by axis "
                                 f"size {d}")
            spec = (self.axis,) + spec[1:]
            b_local = B // d
            me = mesh.get_local_rank(self.axis)
            my_starts = starts[me * b_local:(me + 1) * b_local]

        def F(x, i0):
            return solve(ev, sched, solver, x, i0, S, 1)

        def fine(x_heads, p=None, y_prev=None):
            # the block split runs on every block (no truncation there);
            # otherwise the heads may be a truncated suffix
            st = my_starts if self.axis is not None \
                else starts[B - x_heads.shape[0]:]
            y = fold_fine(F, slice_spec(x_heads, spec, mesh), st)
            return gather_spec(y, spec, mesh)

        return fine
