"""Fault-tolerant training loop (counterpart of ``repro.runtime``)."""
from .fault_tolerance import (PREEMPTED_EXIT_CODE, LoopConfig, Preempted,
                              PreemptionSignal, train_loop)

__all__ = ["PREEMPTED_EXIT_CODE", "LoopConfig", "Preempted",
           "PreemptionSignal", "train_loop"]
