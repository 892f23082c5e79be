"""Frontier/window control for Parareal refinement (counterpart of
``repro.core.window``): the one home of sliding-window policy.

A policy decides the active refinement window ``[lo, B)`` over the B
Parareal blocks: blocks below ``lo`` are frozen (their fine solves and
corrector updates are skipped or masked to no-ops); the final block
carries the convergence residual and never retires.

``ExactPrefix``
    ``lo = prefix_frontier(p) = max(p - 1, 0)``, the provably
    bitwise-frozen prefix: results equal the untruncated engine's (bitwise
    for elementwise-deterministic models).  ``truncate=True`` resolves to it.
``ResidualWindow``
    ParaDiGMS-style: ``lo`` also advances past every leading block whose
    last per-block residual is ``<= window_tol``.  Approximate and opt-in;
    floored at the provable frontier, never retreating.
``FixedBudget``
    No truncation: every refinement computes all B blocks.

The engine (:func:`repro_torch.core.engine.run_parareal`) sizes each
refinement's suffix with :meth:`FrontierPolicy.static_frontier` and, for a
residual policy, masks blocks ``[static, lo)`` with ``lo`` advanced by
:meth:`FrontierPolicy.advance`; the serving engine skips them physically.
:meth:`FrontierPolicy.predict_evals` prices a run for billing and
admission (``ResidualWindow`` charges the ``ExactPrefix`` schedule, an
upper bound on its realized cost).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FrontierPolicy", "ExactPrefix", "ResidualWindow", "FixedBudget",
           "resolve_policy"]


def _xp(a):
    """torch for tensors (the engine's loop carry), numpy for host arrays
    (the serving loop's fetched residuals): one ``advance`` for both."""
    return torch if isinstance(a, torch.Tensor) else np


@dataclasses.dataclass(frozen=True)
class FrontierPolicy:
    """The window-control seam every SRDS driver consumes.

    ``truncates``: refinements run on a shrinking window at all.
    ``exact``: results equal the untruncated engine's.
    ``needs_block_residuals``: drivers must feed per-block residual norms
    to :meth:`advance`.
    """

    name = "policy"
    truncates = False
    exact = True
    needs_block_residuals = False

    def static_frontier(self, p: int, num_blocks: int) -> int:
        """Data-independent floor of the window's lower bound at
        refinement ``p`` (0-indexed): the suffix ``[static_frontier(p), B)``
        is the largest block range refinement ``p`` can need."""
        return 0

    def advance(self, lo, block_resid, num_blocks: int):
        """Next window lower bound from the current ``lo`` and the
        refinement's per-block residuals ``(B, ...)`` (trailing axes such
        as a per-sample K ride along, so ``lo`` may be per sample).
        Monotone and capped at ``B - 1``; works on tensors and numpy."""
        return lo

    def retire_at(self, block_idx, num_blocks: int, max_iters: int):
        """Wavefront rule: the completed refinements after which the
        device owning ``block_idx`` stops evaluating (the tail never
        retires early)."""
        return max_iters

    def predict_evals(self, cost, iterations):
        """Per-lane model evals of an ``iterations``-refinement run under
        this policy's predicted window schedule (``cost`` is an
        :class:`repro_torch.core.engine.IterationCost`)."""
        from .engine import predicted_evals
        return predicted_evals(cost, iterations)


@dataclasses.dataclass(frozen=True)
class ExactPrefix(FrontierPolicy):
    """The provable bitwise-frozen prefix, ``lo = max(p - 1, 0)`` (see
    :func:`repro_torch.core.engine.prefix_frontier` for the lag)."""

    name = "exact_prefix"
    truncates = True
    exact = True
    needs_block_residuals = False

    def static_frontier(self, p: int, num_blocks: int) -> int:
        from .engine import prefix_frontier
        return min(prefix_frontier(p), num_blocks - 1)

    def advance(self, lo, block_resid, num_blocks: int):
        return lo

    def retire_at(self, block_idx, num_blocks: int, max_iters: int):
        # block i+1 is exact after i+1 refinements; the tail keeps going
        if _xp(block_idx) is torch:
            return torch.where(block_idx == num_blocks - 1, max_iters,
                               (block_idx + 1).clamp(max=max_iters))
        return np.where(block_idx == num_blocks - 1, max_iters,
                        np.minimum(block_idx + 1, max_iters))

    def predict_evals(self, cost, iterations):
        from .engine import truncated_evals
        return truncated_evals(cost, iterations)


@dataclasses.dataclass(frozen=True)
class ResidualWindow(FrontierPolicy):
    """Residual-driven sliding window (approximate, opt-in): ``lo``
    advances past every leading block whose last residual (in the
    convergence gate's norm) is ``<= window_tol``; ``window_tol`` is the
    error knob."""

    window_tol: float = 1e-3

    name = "residual_window"
    truncates = True
    exact = False
    needs_block_residuals = True

    def static_frontier(self, p: int, num_blocks: int) -> int:
        from .engine import prefix_frontier
        return min(prefix_frontier(p), num_blocks - 1)

    def advance(self, lo, block_resid, num_blocks: int):
        """``lo`` plus the length of the contiguous run of blocks at or
        past ``lo`` whose residual passed ``window_tol``, capped at
        ``B - 1``; blocks below ``lo`` count as passed."""
        b = num_blocks
        if _xp(block_resid) is torch:
            idx = torch.arange(b, device=block_resid.device).reshape(
                (b,) + (1,) * (block_resid.dim() - 1))
            under = (idx < lo) | (block_resid <= self.window_tol)
            run = torch.cumprod(under.to(torch.int32), dim=0)
            return run.sum(dim=0, dtype=torch.int32).clamp(max=b - 1)
        idx = np.arange(b).reshape((b,) + (1,) * (block_resid.ndim - 1))
        under = np.logical_or(idx < lo, block_resid <= self.window_tol)
        run = np.cumprod(under.astype(np.int32), axis=0)
        return np.minimum(np.sum(run, axis=0, dtype=np.int32),
                          b - 1).astype(np.int32)

    def retire_at(self, block_idx, num_blocks: int, max_iters: int):
        # per-block residuals live on no single wavefront device
        return ExactPrefix().retire_at(block_idx, num_blocks, max_iters)

    def predict_evals(self, cost, iterations):
        from .engine import truncated_evals
        return truncated_evals(cost, iterations)


@dataclasses.dataclass(frozen=True)
class FixedBudget(FrontierPolicy):
    """No truncation: every refinement computes all B blocks."""

    name = "fixed_budget"
    truncates = False
    exact = True
    needs_block_residuals = False


def resolve_policy(window, truncate: bool) -> FrontierPolicy:
    """An explicit ``window`` wins; otherwise ``truncate=True`` means
    :class:`ExactPrefix` and ``False`` :class:`FixedBudget`."""
    if window is not None:
        if not isinstance(window, FrontierPolicy):
            raise TypeError(f"window must be a FrontierPolicy, got "
                            f"{type(window).__name__}")
        return window
    return ExactPrefix() if truncate else FixedBudget()
