"""Serving (counterpart of ``repro.serve``): the diffusion sampling
service (the micro-batched engine, clocks, admission policies, the
discrete-event simulator and the asynchronous serving loop) and the
greedy LM engine."""
from .async_loop import AsyncServeLoop
from .clock import Clock, MonotonicClock, VirtualClock
from .diffusion import (CompletionRecord, DiffusionSamplingEngine,
                        IterationEMA, SampleRequest, SampleResponse,
                        default_noise)
from .engine import Request, ServingEngine, make_decode_fn, make_prefill_fn
from .scheduler import (EDF, FIFO, CostAware, Policy, SimReport, Tier,
                        build_report, bursty_trace, poisson_trace, simulate)

__all__ = ["AsyncServeLoop", "Clock", "MonotonicClock", "VirtualClock",
           "CompletionRecord", "DiffusionSamplingEngine", "IterationEMA",
           "SampleRequest", "SampleResponse", "default_noise", "EDF", "FIFO",
           "CostAware", "Policy", "SimReport", "Tier", "build_report",
           "bursty_trace", "poisson_trace", "simulate", "Request",
           "ServingEngine", "make_decode_fn", "make_prefill_fn"]
