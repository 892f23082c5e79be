"""SRDS core for PyTorch: schedules, solvers, the Parareal engine, frontier
policies, fixed-point acceleration and the samplers (counterpart of
``repro.core``, single device)."""
from .accel import (AccelState, Accelerator, AndersonAccel, NoAccel,
                    TriangularAccel, resolve_accel)
from .denoiser import Denoiser, as_denoiser
from .engine import (IterationCost, SRDSConfig, SRDSResult, iteration_cost,
                     predicted_evals, prefix_frontier, resolve_blocks,
                     run_parareal, truncated_evals, windowed_evals)
from .parareal import srds_sample, srds_stats
from .schedules import DiffusionSchedule, make_schedule
from .sequential import SampleStats, sample_sequential, sequential_stats
from .solvers import SolverConfig, solve, solver_names
from .window import (ExactPrefix, FixedBudget, FrontierPolicy,
                     ResidualWindow, resolve_policy)

__all__ = ["AccelState", "Accelerator", "AndersonAccel", "NoAccel",
           "TriangularAccel", "resolve_accel", "Denoiser", "as_denoiser",
           "IterationCost", "SRDSConfig", "SRDSResult", "iteration_cost",
           "predicted_evals", "prefix_frontier", "resolve_blocks",
           "run_parareal", "truncated_evals", "windowed_evals",
           "srds_sample", "srds_stats", "DiffusionSchedule", "make_schedule",
           "SampleStats", "sample_sequential", "sequential_stats",
           "SolverConfig", "solve", "solver_names", "ExactPrefix",
           "FixedBudget", "FrontierPolicy", "ResidualWindow",
           "resolve_policy"]
