"""Losses and train steps (counterpart of ``repro.train``)."""
from .losses import diffusion_loss, lm_loss
from .steps import make_train_step

__all__ = ["diffusion_loss", "lm_loss", "make_train_step"]
