# reprolint: disable-file=RL002  # this module is the port's Parareal engine;
# RL002's owner list names only the JAX package's engine path.
"""The Parareal engine — the port's single home of SRDS's refinement math
(counterpart of ``repro.core.engine``, untruncated path).

  * the coarse initialization sweep (Alg 1, lines 1-4),
  * the predictor-corrector update ``y + G_cur - G_prev`` (line 11),
  * the sequential corrector sweep with its in-sweep residual (9-12),
  * joint or per-sample convergence gating, and ``SRDSResult`` assembly.

JAX's ``vmap`` over blocks becomes the B blocks folded into the model's
batch (:func:`fold_fine_fn`); ``lax.scan`` and ``while_loop`` become
Python loops.  The early-exit gate reads one boolean from the device per
refinement — the loop's only host sync.  Not ported yet, and raising
``NotImplementedError``: converged-prefix truncation and residual windows
(ROADMAP A5), fixed-point acceleration (A7), block sharding and straggler
reuse (A10).
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
    the fused update + residual kernel; None = on for CUDA tensors.
    per_sample: gate convergence per sample over x_init's leading axis.
    fixed_iters: run exactly max_iters refinements.
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
    one untruncated refinement (B*S fine + B coarse), in model evals."""
    init_evals: int
    refine_evals: int
    num_blocks: int = 0
    fine_steps: int = 0
    evals_per_step: int = 1


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


def resolve_fused(flag: Optional[bool], x: torch.Tensor) -> bool:
    """A ``use_fused_*`` tri-state: an explicit bool wins; None means on
    for CUDA tensors (the kernel launches or raises), off on the CPU."""
    if flag is None:
        from repro_torch.kernels import ops as kops
        return kops.fused_default(x)
    return bool(flag)


def parareal_update(y, g_cur, g_prev, use_fused: bool = False):
    """Predictor-corrector update (Alg 1, line 11): ``y + G_cur - G_prev``."""
    if use_fused:
        raise NotImplementedError(
            "the fused parareal_update kernel (no residual) is not ported yet "
            "(ROADMAP B4); the fused path covers norm='l1_mean', other norms "
            "need use_fused_update=False until then")
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
                    batched: bool = False):
    """Sequential coarse sweep + predictor-corrector (Alg 1, lines 9-12).

    Returns ``(new_tail, cur_all)``.  With ``residual_from`` (the previous
    trajectory tail) each block's raw L1 sum ``sum|x_new - x_old|`` is
    taken in the same pass as the update — from the fused kernel's
    partials when ``use_fused``, a plain per-block reduction otherwise —
    and a third output holds them, ``(B,)`` or ``(B, K)`` with ``batched``.
    """
    if use_fused and residual_from is not None:
        from repro_torch.kernels import ops as kops
    x = x_init
    tail, curs, resids = [], [], []
    for i, i0 in enumerate(starts):
        cur = G(x, int(i0))
        if residual_from is None:
            x = parareal_update(y[i], cur, prev_coarse[i], use_fused)
        elif use_fused:
            x, r = kops.parareal_update_residual(
                y[i], cur, prev_coarse[i], residual_from[i],
                batch_dims=1 if batched else 0)
            resids.append(r)
        else:
            x = y[i] + cur - prev_coarse[i]
            d = (x - residual_from[i]).float()
            resids.append(d.abs().sum(dim=tuple(range(1, d.dim())))
                          if batched else d.abs().sum())
        tail.append(x)
        curs.append(cur)
    if residual_from is None:
        return torch.stack(tail), torch.stack(curs)
    return torch.stack(tail), torch.stack(curs), torch.stack(resids)


def suffix_refinement(G: GFn, y: torch.Tensor, x_init: torch.Tensor,
                      x_tail: torch.Tensor, prev_coarse: torch.Tensor,
                      starts: np.ndarray, frontier: int = 0, *,
                      use_fused: bool = False, norm: str = "l1_mean",
                      batched: bool = False):
    """One predictor-corrector refinement over all B blocks (the
    untruncated case, ``frontier=0``).  Returns ``(new_tail, cur_all,
    resid)``, resid the final block's convergence residual in ``norm``.
    With the fused path and ``l1_mean`` it comes from the update kernel's
    partials, with no second pass over the tensor."""
    if frontier:
        raise NotImplementedError("truncated refinement (frontier > 0) is "
                                  "not ported yet (ROADMAP A5)")
    if use_fused and norm == "l1_mean":
        new_tail, cur_all, r_all = corrector_sweep(
            G, x_init, y, prev_coarse, starts, use_fused=True,
            residual_from=x_tail, batched=batched)
        n_per = x_init[0].numel() if batched else x_init.numel()
        return new_tail, cur_all, (r_all[-1] / float(n_per)).float()
    new_tail, cur_all = corrector_sweep(G, x_init, y, prev_coarse, starts,
                                        use_fused=use_fused)
    resid = convergence_norm(new_tail[-1] - x_tail[-1], norm, batched=batched)
    return new_tail, cur_all, resid


class RefineState(NamedTuple):
    """Carry of the refinement loop.  Under per-sample gating ``delta``,
    ``iters`` and ``active`` are ``(K,)`` and ``history`` is
    ``(max_iters, K)``; otherwise they are the scalar joint carries."""
    p: int                       # refinements run (host int)
    x_tail: torch.Tensor         # (B, ...) running trajectory x_1..x_B
    prev_coarse: torch.Tensor    # (B, ...) G(x_i^{p-1}) per block
    delta: torch.Tensor
    history: torch.Tensor
    iters: torch.Tensor
    active: torch.Tensor


FineFn = Callable[[torch.Tensor], torch.Tensor]


def fold_fine_fn(F: Callable, starts: np.ndarray) -> FineFn:
    """The single-device :data:`FineFn` (counterpart of ``vmap_fine_fn``):
    the B block heads ``(B, K, ...)`` fold into one ``(B*K, ...)`` batch
    with per-row start indices, so one model call per fine step serves
    every block.  ``F(x, i0)`` is the fine solve for per-row ``i0``."""
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
                 window=None, accel=None) -> RefineState:
    """The Parareal refinement loop (Alg 1 minus the fine solves).

    ``fine_fn(x_heads) -> y`` computes the fine solves of the block heads
    ``[x_0, ..., x_{B-1}]``.  ``tol`` is a float or, with
    ``batched``, a per-sample ``(K,)`` tensor.  ``batched`` gates
    convergence per sample over x_init's leading axis: converged samples
    freeze (``torch.where``), so each equals its own independent run; the
    loop ends when every sample has converged or at ``max_iters``.  With
    ``fixed_iters`` exactly ``max_iters`` refinements run and nothing
    freezes.  The early-exit check is the loop's one host sync per
    refinement.
    """
    if truncate or window is not None:
        raise NotImplementedError("converged-prefix truncation and frontier "
                                  "windows are not ported yet (ROADMAP A5)")
    if accel is not None:
        raise NotImplementedError("fixed-point acceleration is not ported "
                                  "yet (ROADMAP A7)")
    if carry_fine_results:
        raise NotImplementedError("straggler reuse is not ported yet "
                                  "(ROADMAP A10)")
    use_fused = resolve_fused(use_fused_update, x_init)
    gate = batched and not fixed_iters
    dev = x_init.device
    kd = (x_init.shape[0],) if batched else ()
    tol = torch.as_tensor(tol, dtype=torch.float32, device=dev)

    x_tail = coarse_init_sweep(G, x_init, starts)
    state = RefineState(
        0, x_tail, x_tail,
        torch.full(kd, math.inf, dtype=torch.float32, device=dev),
        torch.full((max_iters,) + kd, math.inf, dtype=torch.float32,
                   device=dev),
        torch.zeros(kd, dtype=torch.int32, device=dev),
        torch.ones(kd, dtype=torch.bool, device=dev))

    def body(c: RefineState) -> RefineState:
        heads = torch.cat([x_init[None], c.x_tail[:-1]], dim=0)
        y = fine_fn(heads)                                 # Alg 1, lines 7-8
        new_tail, cur_all, resid = suffix_refinement(
            G, y, x_init, c.x_tail, c.prev_coarse, starts, 0,
            use_fused=use_fused, norm=norm, batched=batched)
        history = c.history
        if gate:
            # converged samples freeze, bit-identical to an independent
            # run that stopped at their convergence iteration
            m = _batch_mask(c.active, new_tail)
            new_tail = torch.where(m, new_tail, c.x_tail)
            cur_all = torch.where(m, cur_all, c.prev_coarse)
            delta = torch.where(c.active, resid, c.delta)
            history[c.p] = torch.where(c.active, resid, history[c.p])
            iters = c.iters + c.active.to(torch.int32)
        else:
            delta = resid
            history[c.p] = resid
            iters = c.iters + 1
        active = c.active & still_refining(delta, tol)
        return RefineState(c.p + 1, new_tail, cur_all, delta, history,
                           iters, active)

    for p in range(max_iters):
        # every sample is active before the first refinement: no sync there
        if p and not fixed_iters and not bool(state.active.any()):
            break
        state = body(state)
    return state


def result_from_state(state: RefineState,
                      trajectory: Optional[torch.Tensor] = None) -> SRDSResult:
    return SRDSResult(sample=state.x_tail[-1], iterations=state.iters,
                      final_delta=state.delta, delta_history=state.history,
                      trajectory=trajectory)
