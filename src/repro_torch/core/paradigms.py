"""ParaDiGMS baseline (Shih et al. 2023): Picard iteration over a sliding
window (counterpart of ``repro.core.paradigms``).

The SRDS paper's main baseline (Tables 4 and 6), in its deterministic-ODE
form:

  * the whole ``(N+1, *x_init.shape)`` trajectory stays resident — the
    O(N) memory the SRDS paper criticizes;
  * each Picard sweep steps every point of the active window in one batch
    (the window folds into the model's batch as ``(w*K, ...)`` rows with
    per-row grid indices: one model call, one DDIM launch a sweep), then
    reconciles with a prefix sum along the window;
  * a per-step mean-square tolerance decides how far the converged prefix
    slides.

JAX's ``lax.while_loop`` is a Python loop that reads the device once a
sweep (the stride).  JAX steps all ``w`` window points and drops the
results of those past ``N``; the port steps only the valid ones, which
gives the same trajectory and the same counts (evals count valid points
in both) and keeps each interval's frozen ``ddpm`` noise one draw of
``(K, ...)`` rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .denoiser import as_denoiser
from .schedules import DiffusionSchedule
from .sequential import SampleStats
from .solvers import ModelFn, SolverConfig, solver_step

__all__ = ["ParaDiGMSConfig", "ParaDiGMSResult", "paradigms_sample",
           "paradigms_stats"]


@dataclasses.dataclass(frozen=True)
class ParaDiGMSConfig:
    window: int = 64
    tol: float = 1e-3          # per-step mean-square tolerance (their τ)
    max_iters: int = 10_000


class ParaDiGMSResult(NamedTuple):
    sample: torch.Tensor
    iterations: int             # Picard sweeps == effective serial evals
    total_evals: int


def paradigms_sample(model_fn: ModelFn, sched: DiffusionSchedule,
                     solver: SolverConfig, x_init: torch.Tensor,
                     cfg: ParaDiGMSConfig = ParaDiGMSConfig()
                     ) -> ParaDiGMSResult:
    """Picard sweeps over a window of ``min(cfg.window, N)`` grid points
    from the first unconverged one, ``x_init`` of shape ``(K,
    *sample_shape)``.  A sweep's stride is the count of leading window
    points whose new value moved by less than ``tol`` in mean square (at
    least 1), so the loop ends after at most N sweeps."""
    if x_init.dim() < 2:
        raise ValueError(f"x_init must be (K, *sample_shape); got shape "
                         f"{tuple(x_init.shape)}")
    n = sched.num_steps
    w = min(cfg.window, n)
    k = x_init.shape[0]
    den = as_denoiser(model_fn)
    xs = x_init.unsqueeze(0).expand((n + 1,) + x_init.shape).clone()
    tol2 = cfg.tol * cfg.tol
    lo = iters = total = 0
    while lo < n and iters < cfg.max_iters:
        v = min(w, n - lo)                       # valid window points
        xw = xs[lo:lo + v]                       # (v, K, ...)
        idx = np.repeat(np.arange(lo, lo + v, dtype=np.int64), k)
        rows = xw.reshape((v * k,) + x_init.shape[1:])
        stepped = solver_step(den, sched, solver, rows, idx,
                              idx + 1).reshape(xw.shape)
        # prefix-sum reconciliation: x_{t+1} = x_lo + sum_{s<=t} drift_s
        new_vals = xs[lo][None] + torch.cumsum(stepped - xw, dim=0)
        err = torch.square(new_vals - xs[lo + 1:lo + 1 + v]).reshape(
            v, -1).mean(dim=1)
        # the converged prefix: leading window points under tolerance
        stride = int(torch.cumprod((err < tol2).to(torch.int32),
                                   dim=0).sum())
        xs[lo + 1:lo + 1 + v] = new_vals
        lo += max(stride, 1)
        iters += 1
        total += v * solver.evals_per_step
    return ParaDiGMSResult(sample=xs[n], iterations=iters,
                           total_evals=total)


def paradigms_stats(res: ParaDiGMSResult, solver: SolverConfig) -> SampleStats:
    return SampleStats(serial_evals=int(res.iterations) * solver.evals_per_step,
                       total_evals=int(res.total_evals),
                       iterations=int(res.iterations))
