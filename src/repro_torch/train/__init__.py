"""Losses and train steps (counterpart of ``repro.train``)."""
from .losses import diffusion_loss, lm_loss
from .steps import (init_error_feedback, make_dp_train_step_compressed,
                    make_train_step)

__all__ = ["diffusion_loss", "init_error_feedback", "lm_loss",
           "make_dp_train_step_compressed", "make_train_step"]
