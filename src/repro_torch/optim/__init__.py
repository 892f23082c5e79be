"""Optimizer (counterpart of ``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_update, clip_by_global_norm,
                    global_norm, init_opt_state, warmup_cosine)

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "global_norm", "init_opt_state", "warmup_cosine"]
