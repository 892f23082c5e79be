"""The diffusion sampling service (counterpart of ``repro.serve``'s
diffusion path): the micro-batched engine, clocks, admission policies,
the discrete-event simulator and the asynchronous serving loop."""
from .async_loop import AsyncServeLoop
from .clock import Clock, MonotonicClock, VirtualClock
from .diffusion import (CompletionRecord, DiffusionSamplingEngine,
                        IterationEMA, SampleRequest, SampleResponse,
                        default_noise)
from .scheduler import (EDF, FIFO, CostAware, Policy, SimReport, Tier,
                        build_report, bursty_trace, poisson_trace, simulate)

__all__ = ["AsyncServeLoop", "Clock", "MonotonicClock", "VirtualClock",
           "CompletionRecord", "DiffusionSamplingEngine", "IterationEMA",
           "SampleRequest", "SampleResponse", "default_noise", "EDF", "FIFO",
           "CostAware", "Policy", "SimReport", "Tier", "build_report",
           "bursty_trace", "poisson_trace", "simulate"]
