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

Evals per step: ddim/euler/ddpm = 1, heun/dpm2 = 2.  ``ddpm`` is
ancestral sampling with *frozen* noise: each grid interval ``(i0, i1)``
draws its noise from ``noise_fn(id, shape, dtype, device)`` or, natively,
from a generator seeded by ``(noise_seed, id)``, with JAX's interval id
``i0 * (N + 1) + i1``.  So the fine, coarse and sequential solves see one
realization per interval, whatever batch a row rides in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

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
    eta: float = 0.0          # the ddpm solver's stochasticity (0 -> 1)
    # the ddpm solver's frozen noise: a native seed, or ``noise_fn(id,
    # shape, dtype, device) -> Tensor`` per interval id (wins when set)
    noise_seed: Optional[int] = None
    noise_fn: Optional[Callable] = None
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


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints."""
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def frozen_noise(seed: int, interval_id: int, shape, dtype,
                 device) -> torch.Tensor:
    """The native frozen noise of one interval: ``N(0, I)`` of ``shape``
    from a generator on ``device`` whose seed is a pure function of
    ``(seed, interval_id)``, so a draw never depends on call order."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix64((int(seed) << 32) ^ int(interval_id)))
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


def interval_noise(cfg: SolverConfig, num_steps: int, i0: np.ndarray,
                   i1: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The frozen noise of each row of ``x`` (rows at intervals ``(i0,
    i1)``, host int arrays ``(M,)``).  Each distinct interval id is drawn
    once, of shape ``(rows with that id, *x.shape[1:])`` — one block's or
    one sequential step's ``(K, ...)`` in JAX — and handed to its rows in
    row order.  Rows of one id may lie in several runs; no host read."""
    ids = i0 * (num_steps + 1) + i1
    cut = np.flatnonzero(ids[1:] != ids[:-1]) + 1
    starts = np.concatenate([[0], cut])
    stops = np.concatenate([cut, [ids.shape[0]]])
    uniq, n_rows = np.unique(ids, return_counts=True)
    counts = dict(zip(uniq.tolist(), n_rows.tolist()))
    draws: Dict[int, List] = {}
    parts = []
    shape = tuple(x.shape[1:])
    for lo, hi in zip(starts, stops):
        iid = int(ids[lo])
        if iid not in draws:
            n = counts[iid]
            if cfg.noise_fn is not None:
                d = cfg.noise_fn(iid, (n,) + shape, x.dtype, x.device)
            else:
                d = frozen_noise(cfg.noise_seed, iid, (n,) + shape, x.dtype,
                                 x.device)
            draws[iid] = [d, 0]
        d, off = draws[iid]
        parts.append(d[off:off + hi - lo])
        draws[iid][1] = off + hi - lo
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@register_solver("ddpm", evals_per_step=1)
def ddpm_step(model_fn: ModelFn, sched: DiffusionSchedule, cfg: SolverConfig,
              x: torch.Tensor, i0, i1) -> torch.Tensor:
    """η=1 stochastic DDIM (== DDPM ancestral) with frozen noise: the
    interval's noise is a function of its id, so the solve is an IVP with
    known forcing and Parareal's exactness holds unchanged.  Plain
    arithmetic: no Pallas kernel computes it in JAX either."""
    if cfg.noise_fn is None and cfg.noise_seed is None:
        raise ValueError("ddpm solver requires SolverConfig.noise_seed or "
                         "SolverConfig.noise_fn")
    a, t0 = sched.gather(i0, x.device)
    b, _ = sched.gather(i1, x.device)
    eps = model_fn(x, t0)
    eta = cfg.eta if cfg.eta > 0 else 1.0
    a, b = _rows(a, x), _rows(b, x)
    sigma = eta * torch.sqrt(torch.clamp((1 - b) / (1 - a), min=0)
                             * torch.clamp(1 - a / b, min=0))
    x0 = (x - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)
    mean = (torch.sqrt(b) * x0
            + torch.sqrt(torch.clamp(1.0 - b - sigma ** 2, min=0)) * eps)
    noise = interval_noise(cfg, sched.num_steps, i0, i1, x)
    return mean + sigma * noise


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
