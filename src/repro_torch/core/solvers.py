"""ODE solvers defined between arbitrary grid indices (counterpart of
``repro.core.solvers``).

A solver *step* propagates ``x`` from grid index ``i0`` to ``i1``; a
*solve* chains ``n_steps`` steps of a fixed ``stride``.  Block-by-block
fine solves (stride 1) compose to exactly the sequential solve; one step
of stride S is the coarse solver G on the same schedule.

Indices are host-side and per row: ``i0`` is an int or an int array of
shape ``(M,)`` over x's leading axis, because SRDS folds its B blocks into
the batch and every block sits at its own grid point.  The model is
called as ``model_fn(x, t)`` with ``t`` of shape ``(M,)``.

Evals per step: ddim/euler = 1, heun/dpm2 = 2.  ``ddpm`` (frozen-noise
ancestral sampling) needs a counter-based noise generator and waits for
ROADMAP A3; it raises until then.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .schedules import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_SOLVERS = {}


def register_solver(name: str, evals_per_step: int):
    def deco(fn):
        _SOLVERS[name] = (fn, evals_per_step)
        return fn

    return deco


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    name: str = "ddim"
    # Route the DDIM update through the fused kernel.  None = on for CUDA
    # tensors (the kernel launches or raises), plain arithmetic on the CPU;
    # True on the CPU runs the kernel's plain version; False is plain.
    use_fused_kernel: Optional[bool] = None

    @property
    def evals_per_step(self) -> int:
        return _SOLVERS[self.name][1]


def _rows(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row coefficient (M,) broadcast over x's trailing axes."""
    return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))


def _ddim_update(x, eps, a, b):
    """Deterministic DDIM map from signal level a -> b given eps."""
    a, b = _rows(a, x), _rows(b, x)
    x0 = (x - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)
    return torch.sqrt(b) * x0 + torch.sqrt(1.0 - b) * eps


@register_solver("ddim", evals_per_step=1)
def ddim_step(model_fn: ModelFn, sched: DiffusionSchedule, cfg: SolverConfig,
              x: torch.Tensor, i0, i1) -> torch.Tensor:
    a, t0 = sched.gather(i0, x.device)
    b, _ = sched.gather(i1, x.device)
    eps = model_fn(x, t0)
    from .engine import resolve_fused
    if resolve_fused(cfg.use_fused_kernel, x):
        from repro_torch.kernels import ops as kops
        return kops.ddim_fused(x, eps, a, b)
    return _ddim_update(x, eps, a, b)


# Euler on the probability-flow ODE in VE-rescaled space coincides with DDIM.
@register_solver("euler", evals_per_step=1)
def euler_step(model_fn, sched, cfg, x, i0, i1):
    return ddim_step(model_fn, sched, cfg, x, i0, i1)


@register_solver("heun", evals_per_step=2)
def heun_step(model_fn: ModelFn, sched: DiffusionSchedule, cfg: SolverConfig,
              x: torch.Tensor, i0, i1) -> torch.Tensor:
    """Heun (trapezoid) in VE sigma-space: 2nd-order, 2 evals."""
    a, t0 = sched.gather(i0, x.device)
    b, t1 = sched.gather(i1, x.device)
    a, b = _rows(a, x), _rows(b, x)
    s0 = torch.sqrt((1.0 - a) / a)
    s1 = torch.sqrt((1.0 - b) / b)
    xhat = x / torch.sqrt(a)
    eps0 = model_fn(x, t0)
    x1_pred = torch.sqrt(b) * (xhat + (s1 - s0) * eps0)
    eps1 = model_fn(x1_pred, t1)
    return torch.sqrt(b) * (xhat + (s1 - s0) * 0.5 * (eps0 + eps1))


@register_solver("dpm2", evals_per_step=2)
def dpm2_step(model_fn: ModelFn, sched: DiffusionSchedule, cfg: SolverConfig,
              x: torch.Tensor, i0, i1) -> torch.Tensor:
    """DPM-Solver-2 (midpoint in log-SNR λ-space)."""
    a, t0 = sched.gather(i0, x.device)
    b, t1 = sched.gather(i1, x.device)
    lam0 = 0.5 * (torch.log(a) - torch.log1p(-a))
    lam1 = 0.5 * (torch.log(b) - torch.log1p(-b))
    h = lam1 - lam0
    a_mid = torch.sigmoid(2.0 * (lam0 + 0.5 * h))
    t_mid = 0.5 * (t0 + t1)
    eps0 = model_fn(x, t0)
    a, b, h, a_mid = (_rows(c, x) for c in (a, b, h, a_mid))
    x_mid = (torch.sqrt(a_mid / a) * x
             - torch.sqrt(1.0 - a_mid) * torch.expm1(0.5 * h) * eps0)
    eps_mid = model_fn(x_mid, t_mid)
    return (torch.sqrt(b / a) * x
            - torch.sqrt(1.0 - b) * torch.expm1(h) * eps_mid)


@register_solver("ddpm", evals_per_step=1)
def ddpm_step(model_fn, sched, cfg, x, i0, i1):
    raise NotImplementedError(
        "the ddpm solver's frozen noise (jax.random.fold_in per interval in "
        "the JAX package) is not ported yet (ROADMAP A3)")


def solver_step(model_fn: ModelFn, sched: DiffusionSchedule, cfg: SolverConfig,
                x: torch.Tensor, i0, i1) -> torch.Tensor:
    step_fn, _ = _SOLVERS[cfg.name]
    rows = (x.shape[0],)
    i0 = np.broadcast_to(np.asarray(i0, np.int64), rows)
    i1 = np.broadcast_to(np.asarray(i1, np.int64), rows)
    return step_fn(model_fn, sched, cfg, x, i0, i1)


def solve(model_fn: ModelFn, sched: DiffusionSchedule, cfg: SolverConfig,
          x: torch.Tensor, i_start, n_steps: int, stride: int) -> torch.Tensor:
    """``n_steps`` solver steps of ``stride`` grid intervals each, starting
    at ``i_start`` (an int, or per row an int array ``(M,)``)."""
    i_start = np.asarray(i_start, np.int64)
    for k in range(n_steps):
        i0 = i_start + k * stride
        x = solver_step(model_fn, sched, cfg, x, i0, i0 + stride)
    return x


def solver_names():
    return sorted(_SOLVERS)
