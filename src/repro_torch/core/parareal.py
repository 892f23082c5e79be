"""SRDS: Parareal-based self-refining diffusion sampler (paper Algorithm 1),
single device (counterpart of ``repro.core.parareal``).

The fine solves of all B blocks run as one batch: the blocks fold into
the model's batch dimension (the paper's §3.4 "batched inference").  All
Parareal math lives in :mod:`repro_torch.core.engine`.
"""
from __future__ import annotations

import numpy as np
import torch

from .denoiser import as_denoiser
from .engine import (SRDSConfig, SRDSResult, fold_fine_fn, iteration_cost,
                     resolve_blocks, result_from_state, run_parareal)
from .schedules import DiffusionSchedule
from .sequential import SampleStats
from .solvers import ModelFn, SolverConfig, solve

__all__ = ["SRDSConfig", "SRDSResult", "resolve_blocks", "srds_sample",
           "srds_stats"]


def srds_sample(model_fn: ModelFn, sched: DiffusionSchedule,
                solver: SolverConfig, x_init: torch.Tensor,
                cfg: SRDSConfig = SRDSConfig(),
                return_trajectory: bool = False, tol=None) -> SRDSResult:
    """Algorithm 1.  ``x_init ~ N(0, I)`` of shape ``(K, *sample_shape)``.

    With ``cfg.per_sample`` convergence is gated per sample (results equal
    K independent calls) and ``iterations``/``final_delta``/
    ``delta_history`` gain a K axis.  ``tol`` overrides ``cfg.tol``; per
    sample it may be a ``(K,)`` tensor.  ``cfg.truncate`` fine-solves only
    the non-frozen suffix ``[prefix_frontier(p), B)`` at refinement p
    (bitwise equal for elementwise models); ``cfg.window`` takes any
    frontier policy, and under ``ResidualWindow`` the result's
    ``window_history`` holds each refinement's window bound (its realized
    cost is ``windowed_evals``).  ``cfg.accel`` mixes the refinement fixed
    point (fewer iterations, zero extra evals).
    """
    if cfg.block_sharding is not None:
        # JAX's is a GSPMD sharding constraint inside one program, read
        # only by its dryrun; torch has no counterpart within a process
        raise NotImplementedError(
            "cfg.block_sharding (a sharding constraint inside one program) "
            "has no torch counterpart: shard the blocks over ranks with "
            "repro_torch.core.pipelined.make_sharded_sampler (ROADMAP A10), "
            "as repro_torch.launch.dryrun's sample cell does")
    if x_init.dim() < 2:
        raise ValueError(f"x_init must be (K, *sample_shape); got shape "
                         f"{tuple(x_init.shape)}")
    B, S = resolve_blocks(sched.num_steps, cfg.num_blocks)
    max_iters = cfg.max_iters if cfg.max_iters is not None else B
    starts = np.arange(B, dtype=np.int64) * S
    den = as_denoiser(model_fn)

    def G(x, i0):  # coarse: one solver step across a whole block
        return solve(den, sched, solver, x, i0, 1, S)

    def F(x, i0):  # fine: S solver steps of stride 1, per-row starts
        return solve(den, sched, solver, x, i0, S, 1)

    out = run_parareal(G, fold_fine_fn(F, starts), x_init, starts,
                       tol=cfg.tol if tol is None else tol,
                       max_iters=max_iters, norm=cfg.norm,
                       use_fused_update=cfg.use_fused_update,
                       fixed_iters=cfg.fixed_iters, batched=cfg.per_sample,
                       truncate=cfg.truncate, window=cfg.window,
                       accel=cfg.accel)
    traj = None
    if return_trajectory:
        traj = torch.cat([x_init[None], out.x_tail], dim=0)
    return result_from_state(out, trajectory=traj)


def srds_stats(sched: DiffusionSchedule, solver: SolverConfig,
               cfg: SRDSConfig, iterations: int,
               pipelined: bool = False) -> SampleStats:
    """Paper-style eval accounting: init B sequential coarse steps, then
    per refinement S fine steps (parallel across blocks) and the
    sequential sweep.  ``pipelined`` prices the wavefront
    (:func:`repro_torch.core.pipelined.make_pipelined_sampler`), which
    hides the sweep behind the fine evals: one superstep is one batched
    eval, so ``B + k * (S + 1)`` (paper Table 3).  Truncated runs
    (``cfg.truncate`` or a truncating ``cfg.window``) fine-solve and sweep
    only ``[static_frontier(p), B)``: total evals follow the policy's
    ``predict_evals`` and the serial sweep shortens with the frontier."""
    from .window import resolve_policy
    B, S = resolve_blocks(sched.num_steps, cfg.num_blocks)
    e = solver.evals_per_step
    k = int(iterations)
    cost = iteration_cost(sched.num_steps, cfg.num_blocks, e)
    pol = resolve_policy(cfg.window, cfg.truncate)
    if pipelined:
        serial = e * (B + k * (S + 1))
    elif pol.truncates:
        serial = e * (B + sum(S + B - pol.static_frontier(p, B)
                              for p in range(k)))
    else:
        serial = e * (B + k * (S + B))
    return SampleStats(serial_evals=serial,
                       total_evals=pol.predict_evals(cost, k), iterations=k)
