"""Atomic, async checkpointing (counterpart of ``repro.checkpoint``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
