"""Sequential N-step reference sampler (counterpart of
``repro.core.sequential``): SRDS must reproduce its output (Prop 1)."""
from __future__ import annotations

import dataclasses

import torch

from .schedules import DiffusionSchedule
from .solvers import ModelFn, SolverConfig, solve


@dataclasses.dataclass(frozen=True)
class SampleStats:
    """Eval accounting in the paper's units: ``serial_evals`` on the
    critical path (parallel evals count once), ``total_evals`` all."""

    serial_evals: int
    total_evals: int
    iterations: int = 0


def sample_sequential(model_fn: ModelFn, sched: DiffusionSchedule,
                      cfg: SolverConfig, x_init: torch.Tensor) -> torch.Tensor:
    """The plain N-step solve: x_N = F(...F(F(x_0)))."""
    return solve(model_fn, sched, cfg, x_init, 0, sched.num_steps, 1)


def sequential_stats(sched: DiffusionSchedule,
                     cfg: SolverConfig) -> SampleStats:
    n = sched.num_steps * cfg.evals_per_step
    return SampleStats(serial_evals=n, total_evals=n)
