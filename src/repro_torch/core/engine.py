# reprolint: disable-file=RL002  # this module is the port's Parareal engine;
# RL002's owner list names only the JAX package's engine path.
"""The Parareal engine — the port's single home of SRDS's refinement math
(counterpart of ``repro.core.engine``).

  * the coarse initialization sweep (Alg 1, lines 1-4),
  * the predictor-corrector update ``y + G_cur - G_prev`` (line 11),
  * the sequential corrector sweep with its in-sweep residual (9-12),
  * converged-prefix truncation and residual windows (through the
    :mod:`repro_torch.core.window` policies) and fixed-point acceleration
    (through :mod:`repro_torch.core.accel`),
  * joint or per-sample convergence gating, and ``SRDSResult`` assembly.

JAX's ``vmap`` over blocks becomes the B blocks folded into the model's
batch (:func:`fold_fine_fn`); ``lax.scan``, ``lax.cond`` and
``while_loop`` become Python loops, so a truncated refinement's suffix
shape is simply the loop's frontier.  The early-exit gate reads one
boolean from the device per refinement — the loop's only host sync.
Block sharding and straggler reuse (ROADMAP A10) raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SRDSConfig:
    """Knobs for the SRDS sampler (see ``repro.core.engine.SRDSConfig``).

    num_blocks: B (None -> a divisor of N near sqrt(N)).  tol: τ on the
    final sample's change between refinements.  max_iters: cap (None ->
    B).  norm: 'l1_mean' (paper), 'l2_mean' or 'linf'.  use_fused_update:
    the fused update kernels; None = on for CUDA tensors.  per_sample:
    gate convergence per sample over x_init's leading axis.  truncate:
    converged-prefix truncation (shorthand for ``window=ExactPrefix()``).
    window: a :class:`repro_torch.core.window.FrontierPolicy`.
    fixed_iters: run exactly max_iters refinements.  accel: a
    :class:`repro_torch.core.accel.Accelerator` (None: no mixing).
    """

    num_blocks: Optional[int] = None
    tol: float = 1e-3
    max_iters: Optional[int] = None
    norm: str = "l1_mean"
    use_fused_update: Optional[bool] = None
    per_sample: bool = False
    truncate: bool = False
    window: Optional[object] = None
    block_sharding: Optional[object] = None
    fixed_iters: bool = False
    accel: Optional[object] = None


class SRDSResult(NamedTuple):
    """Per-sample fields are scalar / (max_iters,) under joint gating and
    gain a trailing K axis under per-sample gating."""
    sample: torch.Tensor
    iterations: torch.Tensor       # int32 () or (K,)
    final_delta: torch.Tensor      # f32 () or (K,)
    delta_history: torch.Tensor    # f32 (max_iters,[ K]), +inf past iterations
    trajectory: Optional[torch.Tensor] = None   # (B+1, ...) on request
    window_history: Optional[torch.Tensor] = None  # int32 (max_iters,[ K]):
    # the window lower bound each refinement ran with, -1 past iterations;
    # residual-window policies only


def _leading_axes_norm(diff: torch.Tensor, kind: str,
                       lead: int) -> torch.Tensor:
    """Reduce every axis past the first ``lead``; each preserved slice is
    one row of a ``(slices, n)`` view, so its norm does not depend on how
    many slices ride along (``lead=0`` is a full reduction)."""
    shape = diff.shape[:lead]
    rows = diff.float().reshape(math.prod(shape), -1)
    if kind == "l1_mean":
        out = rows.abs().mean(dim=1)
    elif kind == "l2_mean":
        out = torch.sqrt((rows * rows).mean(dim=1))
    elif kind == "linf":
        out = rows.abs().amax(dim=1)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.reshape(shape)


def convergence_norm(diff: torch.Tensor, kind: str,
                     batched: bool = False) -> torch.Tensor:
    """The convergence residual: a scalar, or per sample ``(K,)``."""
    return _leading_axes_norm(diff, kind, 1 if batched else 0)


def blockwise_norm(diff: torch.Tensor, kind: str,
                   batched: bool = False) -> torch.Tensor:
    """Per-block residual norms: ``(B, ...) -> (B,)``, or ``(B, K, ...) ->
    (B, K)`` with ``batched`` — the same norm kinds as the gate's, the
    feed of residual-window policies."""
    return _leading_axes_norm(diff, kind, 2 if batched else 1)


def still_refining(delta: torch.Tensor, tol) -> torch.Tensor:
    """Convergence gate: keep iterating while the residual is >= τ."""
    return delta >= tol


def resolve_blocks(n_steps: int, num_blocks: Optional[int]) -> Tuple[int, int]:
    """Pick (B, S) with B*S == N: an explicit B must divide N; None snaps
    ceil(sqrt(N)) to the nearest nontrivial divisor (prime N raises)."""
    if num_blocks is not None:
        if not 1 <= num_blocks <= n_steps or n_steps % num_blocks != 0:
            raise ValueError(
                f"num_blocks={num_blocks} does not divide N={n_steps}: SRDS "
                f"blocks are uniform (B*S == N). Pick a divisor of N or pass "
                f"num_blocks=None to auto-select one.")
        return num_blocks, n_steps // num_blocks
    target = max(1, int(round(math.sqrt(n_steps))))
    divs = [d for d in range(2, n_steps) if n_steps % d == 0]
    if not divs:
        raise ValueError(
            f"N={n_steps} has no nontrivial divisor (prime): every block "
            f"split degenerates to the serial solve. Choose a composite "
            f"number of steps, or pass num_blocks={n_steps} or 1 explicitly "
            f"to accept a degenerate split.")
    num_blocks = min(divs, key=lambda d: abs(d - target))
    return num_blocks, n_steps // num_blocks


class IterationCost(NamedTuple):
    """Per-lane model-eval cost of one SRDS run: the B-step coarse init and
    one untruncated refinement (B*S fine + B coarse), in model evals; the
    decomposition prices truncated refinements too."""
    init_evals: int
    refine_evals: int
    num_blocks: int = 0
    fine_steps: int = 0
    evals_per_step: int = 1

    def refine_evals_window(self, lo: int, hi: Optional[int] = None) -> int:
        """Evals of one refinement restricted to blocks ``[lo, hi)``
        (``hi=None``: B); the final block never retires, so the window
        floors at one live block."""
        if not self.num_blocks:
            return self.refine_evals
        hi = self.num_blocks if hi is None else min(int(hi), self.num_blocks)
        live = hi - min(int(lo), hi - 1)
        return live * (self.fine_steps + 1) * self.evals_per_step

    def refine_evals_at(self, frontier: int) -> int:
        """Suffix shorthand: ``refine_evals_window(frontier, B)``."""
        return self.refine_evals_window(frontier)


def iteration_cost(num_steps: int, num_blocks: Optional[int] = None,
                   evals_per_step: int = 1) -> IterationCost:
    B, S = resolve_blocks(num_steps, num_blocks)
    return IterationCost(init_evals=B * evals_per_step,
                         refine_evals=(B * S + B) * evals_per_step,
                         num_blocks=B, fine_steps=S,
                         evals_per_step=evals_per_step)


def predicted_evals(cost: IterationCost, iterations: Union[int, float]):
    """Total per-lane evals of an untruncated run of ``iterations``."""
    return cost.init_evals + iterations * cost.refine_evals


def prefix_frontier(completed: int) -> int:
    """The provably bitwise-frozen prefix after ``completed`` refinements:
    block i is exact after i refinements, bitwise stable one refinement
    later (its first value mixes a coarse term of the init sweep with one
    of the corrector sweep), so the frontier lags by one."""
    return max(int(completed) - 1, 0)


def truncated_evals(cost: IterationCost, iterations: Union[int, float]):
    """Total per-lane evals of a prefix-truncated run: refinement p costs
    ``refine_evals_at(prefix_frontier(p))``; a float ``iterations`` charges
    its fraction at the next refinement's rate."""
    k = int(iterations)
    total = cost.init_evals + sum(cost.refine_evals_at(prefix_frontier(p))
                                  for p in range(k))
    frac = float(iterations) - k
    if frac > 0.0:
        return total + frac * cost.refine_evals_at(prefix_frontier(k))
    return total


def windowed_evals(cost: IterationCost, lo_schedule):
    """Total per-lane evals of a run whose refinement p executed
    ``[lo_schedule[p], B)`` (e.g. ``SRDSResult.window_history``); entries
    ``< 0`` never ran.  A ``(max_iters, K)`` history gives ``(K,)``."""
    los = np.asarray(lo_schedule)
    if los.ndim == 2:
        return np.asarray([windowed_evals(cost, los[:, s])
                           for s in range(los.shape[1])])
    total = cost.init_evals
    for lo in los:
        lo = int(lo)
        if lo >= 0:
            total += cost.refine_evals_window(lo)
    return total


def resolve_fused(flag: Optional[bool], x: torch.Tensor) -> bool:
    """A ``use_fused_*`` tri-state: an explicit bool wins; None means on
    for CUDA tensors (the kernel launches or raises), off on the CPU."""
    if flag is None:
        from repro_torch.kernels import ops as kops
        return kops.fused_default(x)
    return bool(flag)


def parareal_update(y, g_cur, g_prev, use_fused: bool = False):
    """Predictor-corrector update (Alg 1, line 11): ``y + G_cur - G_prev``;
    fused, through the ``parareal_update`` kernel (its L1 sum unused)."""
    if use_fused:
        from repro_torch.kernels import ops as kops
        return kops.parareal_update(y, g_cur, g_prev)[0]
    return y + g_cur - g_prev


GFn = Callable[[torch.Tensor, int], torch.Tensor]


def coarse_init_sweep(G: GFn, x_init: torch.Tensor,
                      starts: np.ndarray) -> torch.Tensor:
    """``[x_1^0, ..., x_B^0]`` with ``x_{i+1}^0 = G(x_i^0)`` — which
    doubles as prev_coarse at init."""
    out, x = [], x_init
    for i0 in starts:
        x = G(x, int(i0))
        out.append(x)
    return torch.stack(out)


def corrector_sweep(G: GFn, x_init: torch.Tensor, y: torch.Tensor,
                    prev_coarse: torch.Tensor, starts: np.ndarray, *,
                    use_fused: bool = False,
                    residual_from: Optional[torch.Tensor] = None,
                    batched: bool = False,
                    frozen: Optional[torch.Tensor] = None):
    """Sequential coarse sweep + predictor-corrector (Alg 1, lines 9-12).

    Returns ``(new_tail, cur_all)``.  With ``residual_from`` (the previous
    trajectory tail) each block's raw L1 sum ``sum|x_new - x_old|`` is
    taken in the same pass as the update — from the fused kernel's
    partials when ``use_fused``, a plain per-block reduction otherwise —
    and a third output holds them, ``(B,)`` or ``(B, K)`` with ``batched``.
    ``frozen`` (bool ``(B,)`` or ``(B, K)``; needs ``residual_from``) is
    the residual-window mask: a frozen block keeps ``residual_from[i]``
    and ``prev_coarse[i]``, reports 0, and hands the old value on to the
    next block, as a sweep starting past it would.
    """
    if frozen is not None and residual_from is None:
        raise ValueError("frozen blocks need residual_from (the previous "
                         "trajectory tail) to hold their old values")
    if use_fused and residual_from is not None:
        from repro_torch.kernels import ops as kops
    x = x_init
    tail, curs, resids = [], [], []
    for i, i0 in enumerate(starts):
        cur = G(x, int(i0))
        if residual_from is None:
            x = parareal_update(y[i], cur, prev_coarse[i], use_fused)
        else:
            if use_fused:
                x, r = kops.parareal_update_residual(
                    y[i], cur, prev_coarse[i], residual_from[i],
                    batch_dims=1 if batched else 0)
            else:
                x = y[i] + cur - prev_coarse[i]
                d = (x - residual_from[i]).float()
                r = (d.abs().sum(dim=tuple(range(1, d.dim()))) if batched
                     else d.abs().sum())
            if frozen is not None:
                fz = frozen[i]
                m = fz.reshape(fz.shape + (1,) * (x.dim() - fz.dim()))
                x = torch.where(m, residual_from[i], x)
                cur = torch.where(m, prev_coarse[i], cur)
                r = torch.where(fz, torch.zeros_like(r), r)
            resids.append(r)
        tail.append(x)
        curs.append(cur)
    if residual_from is None:
        return torch.stack(tail), torch.stack(curs)
    return torch.stack(tail), torch.stack(curs), torch.stack(resids)


def suffix_refinement(G: GFn, y: torch.Tensor, x_init: torch.Tensor,
                      x_tail: torch.Tensor, prev_coarse: torch.Tensor,
                      starts: np.ndarray, frontier: int = 0, *,
                      use_fused: bool = False, norm: str = "l1_mean",
                      batched: bool = False, window_lo=None,
                      block_resids: bool = False):
    """One predictor-corrector refinement truncated to ``[frontier, B)``,
    shared by :func:`run_parareal` and the serving engine's step functions.

    ``y`` holds the fine solves of the suffix heads.  Returns ``(new_tail,
    cur_all, resid)``, resid the final block's convergence residual in
    ``norm`` (scalar, or ``(K,)`` with ``batched``) before any caller-side
    freezing.  With the fused path and ``l1_mean`` it comes from the
    update kernel's partials, with no second pass over the tensor.
    ``window_lo`` (an int or an int tensor, () or ``(K,)``) freezes suffix
    blocks with absolute index ``< window_lo`` inside the sweep and
    implies ``block_resids``, which appends the suffix's per-block
    residual norms ``(B - frontier,[ K])``, frozen blocks reporting 0.
    """
    f = int(frontier)
    windowed = window_lo is not None
    block_resids = block_resids or windowed
    fused_resid = use_fused and norm == "l1_mean"
    # the sweep resumes from the last frozen boundary: the prefix's
    # recomputation is a bitwise fixed point
    x_carry = x_init if f == 0 else x_tail[f - 1]
    old_sfx, prev_sfx, st = x_tail[f:], prev_coarse[f:], starts[f:]
    n_per = x_init[0].numel() if batched else x_init.numel()
    block_resid = None
    if windowed:
        idx = f + torch.arange(old_sfx.shape[0], device=x_init.device)
        lo_dims = window_lo.dim() if isinstance(window_lo,
                                                torch.Tensor) else 0
        fz = idx.reshape(idx.shape + (1,) * lo_dims) < window_lo
        new_sfx, cur_sfx, r_all = corrector_sweep(
            G, x_carry, y, prev_sfx, st, use_fused=use_fused,
            residual_from=old_sfx, batched=batched, frozen=fz)
        if norm == "l1_mean":
            block_resid = (r_all / float(n_per)).float()
        else:
            # frozen blocks hold their old value, so their norm is 0
            block_resid = blockwise_norm(new_sfx - old_sfx, norm,
                                         batched=batched)
        resid = block_resid[-1]
    elif fused_resid or block_resids:
        new_sfx, cur_sfx, r_all = corrector_sweep(
            G, x_carry, y, prev_sfx, st, use_fused=use_fused,
            residual_from=old_sfx, batched=batched)
        if norm == "l1_mean":
            block_resid = (r_all / float(n_per)).float()
        else:
            block_resid = blockwise_norm(new_sfx - old_sfx, norm,
                                         batched=batched)
        resid = block_resid[-1]
    else:
        new_sfx, cur_sfx = corrector_sweep(G, x_carry, y, prev_sfx, st,
                                           use_fused=use_fused)
        resid = None
    if f:
        new_tail = torch.cat([x_tail[:f], new_sfx], dim=0)
        cur_all = torch.cat([prev_coarse[:f], cur_sfx], dim=0)
    else:
        new_tail, cur_all = new_sfx, cur_sfx
    if resid is None:
        resid = convergence_norm(new_tail[-1] - x_tail[-1], norm,
                                 batched=batched)
    if block_resids:
        return new_tail, cur_all, resid, block_resid
    return new_tail, cur_all, resid


class RefineState(NamedTuple):
    """Carry of the refinement loop.  Under per-sample gating ``delta``,
    ``iters``, ``active`` and ``window_lo`` are ``(K,)`` and the histories
    ``(max_iters, K)``; otherwise they are the scalar joint carries.  The
    window fields are None unless the policy needs block residuals, and
    ``accel`` None unless the accelerator mixes."""
    p: int                       # refinements run (host int)
    x_tail: torch.Tensor         # (B, ...) running trajectory x_1..x_B
    prev_coarse: torch.Tensor    # (B, ...) G(x_i^{p-1}) per block
    delta: torch.Tensor
    history: torch.Tensor
    iters: torch.Tensor
    active: torch.Tensor
    block_resid: Optional[torch.Tensor] = None   # f32 (B,[ K])
    window_lo: Optional[torch.Tensor] = None     # int32 () or (K,)
    lo_hist: Optional[torch.Tensor] = None       # int32 (max_iters,[ K])
    accel: Optional[object] = None               # accel.AccelState


FineFn = Callable[[torch.Tensor], torch.Tensor]


def fold_fine_fn(F: Callable, starts: np.ndarray) -> FineFn:
    """The single-device :data:`FineFn` (counterpart of ``vmap_fine_fn``):
    the block heads ``(b, K, ...)`` — all B, or a truncated suffix — fold
    into one ``(b*K, ...)`` batch with per-row start indices, so one model
    call per fine step serves every block.  ``F(x, i0)`` is the fine
    solve for per-row ``i0``."""
    starts = np.asarray(starts, np.int64)

    def fine_fn(x_heads):
        b, k = x_heads.shape[0], x_heads.shape[1]
        rows = x_heads.reshape((b * k,) + x_heads.shape[2:])
        return F(rows, np.repeat(starts[-b:], k)).reshape(x_heads.shape)

    return fine_fn


def _batch_mask(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Broadcast a (K,) sample mask against a (B, K, ...) tensor."""
    return mask.reshape((1,) + mask.shape + (1,) * (t.dim() - 2))


def run_parareal(G: GFn, fine_fn: FineFn, x_init: torch.Tensor,
                 starts: np.ndarray, *, tol, max_iters: int,
                 norm: str = "l1_mean",
                 use_fused_update: Optional[bool] = None,
                 fixed_iters: bool = False, batched: bool = False,
                 carry_fine_results: bool = False, truncate: bool = False,
                 window=None, accel=None, constrain=None) -> RefineState:
    """The Parareal refinement loop (Alg 1 minus the fine solves).

    ``fine_fn(x_heads) -> y`` computes the fine solves of the block heads
    (``[x_0, ..., x_{B-1}]``, or under truncation the suffix from the
    frontier).  ``tol`` is a float or, with ``batched``, a per-sample
    ``(K,)`` tensor.  ``batched`` gates convergence per sample over
    x_init's leading axis: converged samples freeze (``torch.where``), so
    each equals its own independent run; the loop ends when every sample
    has converged or at ``max_iters``.  With ``fixed_iters`` exactly
    ``max_iters`` refinements run and nothing freezes.

    ``window`` (a :class:`~repro_torch.core.window.FrontierPolicy`;
    ``truncate`` is shorthand for ``ExactPrefix``) sets refinement p's
    suffix to ``policy.static_frontier(p, B)``; a residual policy also
    freezes blocks below its carried ``window_lo`` by masking.  ``accel``
    mixes the joint iterate after each refinement's gate masking, with the
    live-window mask, and the residual is recomputed from the mixed state.
    The early-exit check before each refinement but the first is the
    loop's one host read.
    """
    from .accel import resolve_accel
    from .window import resolve_policy
    policy = resolve_policy(window, truncate)
    acc = resolve_accel(accel)
    accel_on = acc.accelerates
    if accel_on and carry_fine_results:
        raise ValueError("an accelerating Accelerator is incompatible with "
                         "straggler reuse (carry_fine_results): stale fine "
                         "results are not iterates of the mixed sequence.")
    if accel_on and policy.truncates and not acc.prefix_exact:
        # truncating policies freeze blocks on the provable serial-prefix
        # schedule, a theorem about the plain iteration that joint mixing
        # invalidates
        raise ValueError(
            f"{type(acc).__name__} does not preserve the serial-prefix "
            f"invariant that truncating frontier policies "
            f"({type(policy).__name__}) rely on; use TriangularAccel "
            f"(prefix-exact mixing), or disable truncation "
            f"(truncate=False / window=FixedBudget()).")
    truncate = policy.truncates
    windowed = truncate and policy.needs_block_residuals
    if truncate and constrain is not None:
        raise ValueError("truncate is incompatible with a block-sharding "
                         "constraint (the sharded path keeps full-width "
                         "trajectory tensors); drop one of the two.")
    if truncate and carry_fine_results:
        raise ValueError("truncate is incompatible with straggler reuse "
                         "(carry_fine_results): stale fine results are "
                         "indexed on the full block axis.")
    if carry_fine_results or constrain is not None:
        raise NotImplementedError("straggler reuse and block-sharding "
                                  "constraints are not ported yet "
                                  "(ROADMAP A10)")
    use_fused = resolve_fused(use_fused_update, x_init)
    gate = batched and not fixed_iters
    B = len(starts)
    dev = x_init.device
    kd = (x_init.shape[0],) if batched else ()
    tol = torch.as_tensor(tol, dtype=torch.float32, device=dev)

    x_tail = coarse_init_sweep(G, x_init, starts)
    if windowed:
        br0 = torch.full((B,) + kd, math.inf, dtype=torch.float32,
                         device=dev)
        lo0 = torch.zeros(kd, dtype=torch.int32, device=dev)
        loh0 = torch.full((max_iters,) + kd, -1, dtype=torch.int32,
                          device=dev)
    else:
        br0 = lo0 = loh0 = None
    astate0 = acc.init_state(torch.stack([x_tail, x_tail]), max_iters,
                             batched=batched) if accel_on else None
    state = RefineState(
        0, x_tail, x_tail,
        torch.full(kd, math.inf, dtype=torch.float32, device=dev),
        torch.full((max_iters,) + kd, math.inf, dtype=torch.float32,
                   device=dev),
        torch.zeros(kd, dtype=torch.int32, device=dev),
        torch.ones(kd, dtype=torch.bool, device=dev), br0, lo0, loh0,
        astate0)

    def gated(c: RefineState, resid):
        """The gate's bookkeeping after one refinement."""
        history = c.history
        if gate:
            delta = torch.where(c.active, resid, c.delta)
            history[c.p] = torch.where(c.active, resid, history[c.p])
            iters = c.iters + c.active.to(torch.int32)
        else:
            delta = resid
            history[c.p] = resid
            iters = c.iters + 1
        return delta, history, iters, c.active & still_refining(delta, tol)

    def mix(c: RefineState, new_tail, cur_all, live):
        """Accelerate the committed iterate; re-freeze converged lanes."""
        z_mix, astate = acc.apply(
            c.accel, torch.stack([c.x_tail, c.prev_coarse]),
            torch.stack([new_tail, cur_all]), live=live, batched=batched)
        new_tail, cur_all = z_mix[0], z_mix[1]
        if gate:
            m = _batch_mask(c.active, new_tail)
            new_tail = torch.where(m, new_tail, c.x_tail)
            cur_all = torch.where(m, cur_all, c.prev_coarse)
        return new_tail, cur_all, astate

    def heads_from(c: RefineState, f: int) -> torch.Tensor:
        return torch.cat([x_init[None], c.x_tail[:-1]], dim=0)[f:]

    def body(c: RefineState, f: int) -> RefineState:
        """One refinement on the static suffix ``[f, B)``."""
        y = fine_fn(heads_from(c, f))                      # Alg 1, lines 7-8
        new_tail, cur_all, resid = suffix_refinement(
            G, y, x_init, c.x_tail, c.prev_coarse, starts, f,
            use_fused=use_fused, norm=norm, batched=batched)
        if gate:
            # converged samples freeze, bit-identical to an independent
            # run that stopped at their convergence iteration
            m = _batch_mask(c.active, new_tail)
            new_tail = torch.where(m, new_tail, c.x_tail)
            cur_all = torch.where(m, cur_all, c.prev_coarse)
        astate = c.accel
        if accel_on:
            live = torch.arange(B, device=dev) >= f if f else None
            new_tail, cur_all, astate = mix(c, new_tail, cur_all, live)
            resid = convergence_norm(new_tail[-1] - c.x_tail[-1], norm,
                                     batched=batched)
        delta, history, iters, active = gated(c, resid)
        return RefineState(c.p + 1, new_tail, cur_all, delta, history,
                           iters, active, c.block_resid, c.window_lo,
                           c.lo_hist, astate)

    def body_windowed(c: RefineState, f: int) -> RefineState:
        """One residual-window refinement: the static suffix ``[f, B)``,
        with blocks ``[f, lo)`` the policy advanced past frozen by
        masking inside the sweep."""
        lo_eff = torch.clamp(c.window_lo, min=f)
        y = fine_fn(heads_from(c, f))
        new_tail, cur_all, resid, br_sfx = suffix_refinement(
            G, y, x_init, c.x_tail, c.prev_coarse, starts, f,
            use_fused=use_fused, norm=norm, batched=batched,
            window_lo=lo_eff)
        if gate:
            m = _batch_mask(c.active, new_tail)
            new_tail = torch.where(m, new_tail, c.x_tail)
            cur_all = torch.where(m, cur_all, c.prev_coarse)
        astate = c.accel
        if accel_on:
            # frozen blocks stay bitwise through mixing; the residuals are
            # recomputed from the committed state (frozen blocks: 0)
            idx = torch.arange(B, device=dev)
            live = idx.reshape((B,) + (1,) * lo_eff.dim()) >= lo_eff
            new_tail, cur_all, astate = mix(c, new_tail, cur_all, live)
            br = blockwise_norm(new_tail - c.x_tail, norm, batched=batched)
            resid = br[-1]
        elif f:
            # the statically skipped prefix is bitwise frozen: residual 0
            br = torch.cat([torch.zeros((f,) + br_sfx.shape[1:],
                                        dtype=br_sfx.dtype, device=dev),
                            br_sfx], dim=0)
        else:
            br = br_sfx
        delta, history, iters, active = gated(c, resid)
        new_lo = policy.advance(lo_eff, br, B)
        lo_hist = c.lo_hist
        if gate:
            # converged samples' window state freezes with them
            br = torch.where(c.active[None], br, c.block_resid)
            new_lo = torch.where(c.active, new_lo, c.window_lo)
            lo_hist[c.p] = torch.where(c.active, lo_eff, lo_hist[c.p])
        else:
            lo_hist[c.p] = lo_eff
        return RefineState(c.p + 1, new_tail, cur_all, delta, history,
                           iters, active, br, new_lo, lo_hist, astate)

    loop_body = body_windowed if windowed else body
    for p in range(max_iters):
        # every sample is active before the first refinement: no sync there
        if p and not fixed_iters and not bool(state.active.any()):
            break
        state = loop_body(state, policy.static_frontier(p, B))
    return state


def result_from_state(state: RefineState,
                      trajectory: Optional[torch.Tensor] = None) -> SRDSResult:
    return SRDSResult(sample=state.x_tail[-1], iterations=state.iters,
                      final_delta=state.delta, delta_history=state.history,
                      trajectory=trajectory, window_history=state.lo_hist)
