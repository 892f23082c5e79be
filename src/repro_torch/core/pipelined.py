"""Distributed SRDS on ``torch.distributed``: the block-sharded and the
wavefront-pipelined samplers (counterpart of ``repro.core.pipelined``).

Both are SPMD: every rank of a mesh calls the sampler on the same
``x_init`` and gets the same result.  A JAX ``shard_map`` program becomes
one process per rank; its collectives become NCCL (CUDA tensors) or gloo
(CPU tensors) calls on the mesh dim's process group.  A tensor on the
wrong backend's device raises: the drivers never switch backend, and
never fall back to the single-program path.

:func:`make_sharded_sampler`
    Algorithmically :func:`repro_torch.core.parareal.srds_sample`: both
    drive :func:`repro_torch.core.engine.run_parareal`, but each rank
    fine-solves its own ``B / d`` blocks of the ``time`` dim in one
    batched model call per fine step, and one ``all_gather_into_tensor``
    per refinement joins them; the coarse sweep runs redundantly on every
    rank.  Truncated suffixes are redistributed over the ranks, straggler
    masks substitute stale fine results, and ``data_axis`` splits the K
    sample lanes over the ``data`` dim.
:func:`make_pipelined_sampler`
    The paper's wavefront (Fig. 4) at model-eval granularity: one block a
    rank; at superstep ``s`` rank ``i`` runs fine sub-step ``(s - i) mod
    S`` of refinement ``(s - i) // S + 1`` and the coarse step in the
    same model call; boundary values go to the right neighbour by
    ``batch_isend_irecv``.  Its schedule is host integers (superstep,
    rank), so every rank knows without communication which ranks send,
    receive, retire or report a residual; the only host read is the done
    flag, once per refinement of the last block.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.transfer import host_to_device

from .accel import resolve_accel
from .denoiser import as_denoiser
from .engine import (RefineState, SRDSConfig, SRDSResult, convergence_norm,
                     fold_fine, parareal_update, resolve_blocks,
                     resolve_fused, result_from_state, run_parareal)
from .schedules import DiffusionSchedule
from .solvers import ModelFn, SolverConfig, solve, solver_step
from .window import ExactPrefix, resolve_policy

__all__ = ["BACKENDS", "make_sharded_sampler", "make_pipelined_sampler",
           "srds_sharded_local", "srds_pipelined_local"]

# the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
StragglerFn = Callable[[int], object]


def _check_backend(group, x: torch.Tensor) -> None:
    """``x`` must live where ``group``'s backend works: NCCL for a CUDA
    tensor, gloo for a CPU one."""
    want = BACKENDS.get(x.device.type)
    have = str(dist.get_backend(group))
    if want is None or (have != want
                        and f"{x.device.type}:{want}" not in have):
        raise ValueError(f"a {x.device.type} tensor needs a {want} process "
                         f"group; this group runs {have}")


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The rank-ordered concatenation of every rank's ``t`` on dim 0."""
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def srds_sharded_local(model_fn: ModelFn, sched: DiffusionSchedule,
                       solver: SolverConfig, x_init: torch.Tensor, group,
                       cfg: SRDSConfig,
                       straggler_fn: Optional[StragglerFn] = None,
                       tol=None) -> RefineState:
    """One rank's part of the block-sharded sampler (counterpart of
    ``srds_sharded_local``): ``group`` holds the ranks of the ``time``
    dim; ``x_init (K, ...)`` is the same on all of them.

    ``straggler_fn(p) -> (B,) bool`` marks blocks whose fresh fine solve
    is dropped at refinement ``p`` (0-indexed; the last refinement's
    result is reused, from ``p = 1`` on).  ``tol`` overrides ``cfg.tol``:
    a scalar, or with ``cfg.per_sample`` a ``(K,)`` tensor.
    """
    n = sched.num_steps
    d = dist.get_world_size(group)
    me = dist.get_rank(group)
    den = as_denoiser(model_fn)
    b_total, s_steps = resolve_blocks(n, cfg.num_blocks)
    if b_total % d != 0:
        raise ValueError(f"num_blocks={b_total} not divisible by axis size "
                         f"{d}")
    if resolve_policy(cfg.window, cfg.truncate).truncates \
            and straggler_fn is not None:
        raise ValueError("truncate is incompatible with straggler_fn (stale "
                         "fine results are indexed on the full block axis)")
    b_local = b_total // d
    max_iters = cfg.max_iters if cfg.max_iters is not None else b_total
    all_starts = np.arange(b_total, dtype=np.int64) * s_steps
    mine = slice(me * b_local, (me + 1) * b_local)

    def G(x, i0):
        return solve(den, sched, solver, x, i0, 1, s_steps)

    def F(x, i0):
        return solve(den, sched, solver, x, i0, s_steps, 1)

    def fine_fn(x_heads, p, y_prev):
        live = x_heads.shape[0]
        if live == b_total:
            # every block: this rank's B/d in one batch, one all_gather
            y = _all_gather(fold_fine(F, x_heads[mine], all_starts[mine]),
                            group)
            if straggler_fn is not None and p > 0:
                mask = straggler_fn(p)
                mask = mask.to(y.device, torch.bool) \
                    if isinstance(mask, torch.Tensor) \
                    else host_to_device(np.asarray(mask, bool), y.device)
                y = torch.where(mask.reshape((-1,) + (1,) * (y.dim() - 1)),
                                y_prev, y)
            return y
        # a truncated suffix: chunks of ceil(live / d) blocks, padded with
        # copies of the last head so every rank's chunk has one shape; a
        # rank whose chunk starts past the suffix runs no model call
        m = -(-live // d)
        pad = d * m - live
        heads, st = x_heads, all_starts[b_total - live:]
        if pad:
            heads = torch.cat([heads, heads[-1:].expand(
                (pad,) + tuple(heads.shape[1:]))], dim=0)
            st = np.concatenate([st, np.repeat(st[-1:], pad)])
        start = me * m
        if start < live:
            y_local = fold_fine(F, heads[start:start + m],
                                st[start:start + m])
        else:
            y_local = x_heads.new_zeros((m,) + tuple(x_heads.shape[1:]))
        return _all_gather(y_local, group)[:live]

    return run_parareal(G, fine_fn, x_init, all_starts,
                        tol=cfg.tol if tol is None else tol,
                        max_iters=max_iters, norm=cfg.norm,
                        use_fused_update=cfg.use_fused_update,
                        fixed_iters=cfg.fixed_iters,
                        carry_fine_results=straggler_fn is not None,
                        batched=cfg.per_sample, truncate=cfg.truncate,
                        window=cfg.window, accel=cfg.accel)


def _gather_lanes(res: SRDSResult, group) -> SRDSResult:
    """Join the data ranks' lanes in rank order: the sample and the
    per-lane fields on their lane axis (the histories' is the last)."""
    def lanes(t, axis):
        if t is None:
            return None
        if axis == 0:
            return _all_gather(t, group)
        return _all_gather(t.transpose(0, 1), group).transpose(0, 1)

    return SRDSResult(sample=lanes(res.sample, 0),
                      iterations=lanes(res.iterations, 0),
                      final_delta=lanes(res.final_delta, 0),
                      delta_history=lanes(res.delta_history, 1),
                      window_history=lanes(res.window_history, 1))


def make_sharded_sampler(mesh, axis: str, model_fn: ModelFn,
                         sched: DiffusionSchedule, solver: SolverConfig,
                         cfg: SRDSConfig,
                         straggler_fn: Optional[StragglerFn] = None,
                         data_axis: Optional[str] = None):
    """The block-sharded SPMD sampler over ``mesh``'s ``axis`` dim (a
    ``torch.distributed.device_mesh.DeviceMesh``, e.g.
    :func:`repro_torch.launch.mesh.make_srds_mesh`'s):
    ``sample(x_init, tol=None) -> SRDSResult`` on every rank.

    ``tol`` overrides ``cfg.tol`` at call time (a scalar, or with
    ``cfg.per_sample`` a ``(K,)`` tensor).  ``data_axis`` splits the K
    lanes over a second dim in contiguous chunks (data rank ``r`` runs
    lanes ``[r * K / D, (r + 1) * K / D)``, as JAX's ``P(data_axis)``);
    lanes are independent, so only the result is gathered.  It needs
    ``cfg.per_sample`` (joint gating couples the lanes) and a K divisible
    by the dim's size.
    """
    if data_axis is not None and not cfg.per_sample:
        raise ValueError("data_axis shards the sample batch, which is only "
                         "exact under per-sample gating — set "
                         "SRDSConfig.per_sample=True")
    group = mesh.get_group(axis)
    data_group = mesh.get_group(data_axis) if data_axis is not None else None
    d_data = mesh.size(mesh.mesh_dim_names.index(data_axis)) \
        if data_axis is not None else 1

    def sample(x_init: torch.Tensor, tol=None) -> SRDSResult:
        _check_backend(group, x_init)
        tolv = torch.as_tensor(cfg.tol if tol is None else tol,
                               dtype=torch.float32, device=x_init.device)
        if data_axis is None:
            return result_from_state(srds_sharded_local(
                model_fn, sched, solver, x_init, group, cfg, straggler_fn,
                tol=tolv))
        k = x_init.shape[0]
        if k % d_data != 0:
            raise ValueError(f"sample batch K={k} not divisible by data "
                             f"axis size {d_data}")
        if tolv.dim() == 0:
            tolv = tolv.expand(k)
        kl, r = k // d_data, mesh.get_local_rank(data_axis)
        lanes = slice(r * kl, (r + 1) * kl)
        res = result_from_state(srds_sharded_local(
            model_fn, sched, solver, x_init[lanes], group, cfg, straggler_fn,
            tol=tolv[lanes]))
        return _gather_lanes(res, data_group)

    return sample


def _host_flag(t: torch.Tensor) -> bool:
    """The wavefront's one host read a refinement of the last block: is
    every sample converged?"""
    return bool(t)


def _ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Rank ``i``'s ``t`` arrives at rank ``i + 1`` (mod d); on a ring of
    one rank, a copy of its own."""
    d = dist.get_world_size(group)
    if d == 1:
        return t.clone()
    me = dist.get_rank(group)
    recv = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      dist.get_global_rank(group, (me + 1) % d), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - 1) % d), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def srds_pipelined_local(model_fn: ModelFn, sched: DiffusionSchedule,
                         solver: SolverConfig, x_init: torch.Tensor, group,
                         cfg: SRDSConfig
                         ) -> Tuple[SRDSResult, int, int]:
    """One rank's part of the wavefront (counterpart of
    ``srds_pipelined_local``); ``group`` holds the ``time`` dim's ranks,
    one block each.  Returns ``(result, supersteps, physical_evals)``, the
    same on every rank.

    Every working superstep makes one model call on the ``(fine, coarse)``
    pair, ``2K`` rows.  Rank ``i`` retires after
    ``policy.retire_at(i, d, max_iters)`` refinements (the window policy,
    :class:`ExactPrefix` unless ``cfg.window`` says otherwise;
    ``FixedBudget`` turns retirement off): block ``i + 1`` is then exact,
    so its model calls stop; ranks ahead of the ramp skip theirs too.
    ``physical_evals`` counts the evals that ran.  With
    ``cfg.per_sample`` the last rank gates each sample on its own and the
    loop ends when all have converged.
    """
    n = sched.num_steps
    d = dist.get_world_size(group)
    me = dist.get_rank(group)
    den = as_denoiser(model_fn)
    if n % d != 0:
        raise ValueError(f"N={n} must be divisible by device count {d}")
    if resolve_accel(cfg.accel).accelerates:
        raise ValueError("the wavefront pipeline does not support "
                         "accelerating Accelerators (per-block state is "
                         "distributed with no central iterate history); "
                         "use srds_sample or the sharded driver, or pass "
                         "accel=None")
    s_steps = n // d
    evals_per_step = solver.evals_per_step
    max_iters = cfg.max_iters if cfg.max_iters is not None else d
    policy = cfg.window if cfg.window is not None else ExactPrefix()
    max_supersteps = max_iters * s_steps + d + 2
    per = cfg.per_sample
    use_fused = resolve_fused(cfg.use_fused_update, x_init)
    dev, k = x_init.device, x_init.shape[0]
    tol = torch.as_tensor(cfg.tol, dtype=torch.float32, device=dev)
    block_i0 = me * s_steps
    retire_at = int(policy.retire_at(me, d, max_iters))

    def schedule(s: int, rank: int):
        """``(active, j, p, is_init, is_last)`` of ``rank`` at superstep
        ``s``: host integers every rank can compute."""
        rel = s - rank
        if rel < 0:
            return False, 0, 0, False, False
        j, p = rel % s_steps, rel // s_steps + 1
        return True, j, p, j == 0 and p == 1, j == s_steps - 1

    def batched_eval(z, j, x_coarse):
        """One model call advancing the fine slot and the coarse slot."""
        i0 = np.repeat(np.asarray([block_i0 + j, block_i0], np.int64), k)
        i1 = np.repeat(np.asarray([block_i0 + j + 1, block_i0 + s_steps],
                                  np.int64), k)
        out = solver_step(den, sched, solver, torch.cat([z, x_coarse]),
                          i0, i1)
        return out[:k], out[k:]

    def lane_mask(mask, t):
        return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))

    kd = (k,) if per else ()
    z, x_new = x_init, x_init
    prev_coarse = torch.zeros_like(x_init)
    out_last = torch.zeros_like(x_init)
    delta = torch.full(kd, float("inf"), dtype=torch.float32, device=dev)
    history = torch.full((max_iters,) + kd, float("inf"),
                         dtype=torch.float32, device=dev)
    p_done = torch.zeros(kd, dtype=torch.int32, device=dev)
    conv = torch.zeros(kd, dtype=torch.bool, device=dev)
    my_evals, s = 0, 0
    while s < max_supersteps:
        active, j, p, is_init, is_last = schedule(s, me)
        send_val = out_last
        if active:
            retired = p - 1 >= retire_at
            if retired:
                # the boundary is final: every consumer sees the old value
                z_out, coarse_out, out_block = z, prev_coarse, out_last
            else:
                z_in = x_new if j == 0 else z
                z_out, coarse_out = batched_eval(z_in, j, x_new)
                my_evals += 2 * evals_per_step
                # init: coarse_out = G(x_i^0); last: the corrector update
                out_block = parareal_update(
                    z_out, coarse_out, coarse_out if is_init else prev_coarse,
                    use_fused)
            send_val = out_block if is_last else (
                coarse_out if is_init else out_last)
            over = p > max_iters
            new_out_last = out_last
            if is_last and not over:
                # samples converged on the last rank stay frozen
                new_out_last = torch.where(lane_mask(conv, out_block),
                                           out_last, out_block)
                if not retired:
                    p_done = torch.where(conv, p_done,
                                         torch.full_like(p_done, p))
            elif is_init:
                new_out_last = coarse_out
            if me == d - 1 and is_last and not over:
                resid = convergence_norm(out_block - out_last, cfg.norm,
                                         batched=per)
                live = ~conv
                delta = torch.where(live, resid, delta)
                idx = min(max(p - 1, 0), max_iters - 1)
                history[idx] = torch.where(live, resid, history[idx])
                conv = delta < tol
            if is_init or is_last:
                prev_coarse = coarse_out
            z, out_last = z_out, new_out_last
        # the last rank's residual (and the done flag) at its refinements
        _, _, tail_p, _, tail_last = schedule(s, d - 1)
        check = tail_last and tail_p <= max_iters
        if check:
            flag = conv.all().to(torch.float32) if me == d - 1 \
                else torch.zeros((), dtype=torch.float32, device=dev)
            dist.all_reduce(flag, group=group)
        # the ring: the left neighbour's boundary, taken where it sent one
        recv = _ring_shift(send_val, group)
        _, _, _, left_init, left_last = schedule(s, me - 1)
        if me == 0:
            x_new = x_init                       # x_0 is the fixed IC
        elif left_init or left_last:
            x_new = recv
        s += 1
        if check and _host_flag(flag > 0):
            break

    tail = dist.get_global_rank(group, d - 1)
    for t in (out_last, p_done, delta, history):
        dist.broadcast(t, src=tail, group=group)
    evals = torch.tensor(my_evals, dtype=torch.int64, device=dev)
    dist.all_reduce(evals, group=group)
    return (SRDSResult(sample=out_last, iterations=p_done,
                       final_delta=delta, delta_history=history),
            s, int(evals))


def make_pipelined_sampler(mesh, axis: str, model_fn: ModelFn,
                           sched: DiffusionSchedule, solver: SolverConfig,
                           cfg: SRDSConfig):
    """The wavefront SPMD sampler over ``mesh``'s ``axis`` dim (one block a
    rank): ``sample(x_init) -> (SRDSResult, supersteps, physical_evals)``
    on every rank."""
    group = mesh.get_group(axis)

    def sample(x_init: torch.Tensor):
        _check_backend(group, x_init)
        return srds_pipelined_local(model_fn, sched, solver, x_init, group,
                                    cfg)

    return sample
