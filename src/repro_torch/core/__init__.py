"""SRDS core for PyTorch: schedules, solvers, the Parareal engine and the
samplers (counterpart of ``repro.core``, single-device untruncated path)."""
from .denoiser import Denoiser, as_denoiser
from .engine import (IterationCost, SRDSConfig, SRDSResult, iteration_cost,
                     predicted_evals, resolve_blocks, run_parareal)
from .parareal import srds_sample, srds_stats
from .schedules import DiffusionSchedule, make_schedule
from .sequential import SampleStats, sample_sequential, sequential_stats
from .solvers import SolverConfig, solve, solver_names

__all__ = ["Denoiser", "as_denoiser", "IterationCost", "SRDSConfig",
           "SRDSResult", "iteration_cost", "predicted_evals",
           "resolve_blocks", "run_parareal", "srds_sample", "srds_stats",
           "DiffusionSchedule", "make_schedule", "SampleStats",
           "sample_sequential", "sequential_stats", "SolverConfig", "solve",
           "solver_names"]
