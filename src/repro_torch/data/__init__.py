"""Deterministic synthetic data (counterpart of ``repro.data``)."""
from .pipeline import (DataConfig, ImageStream, LMStream, fold_in,
                       image_formula, make_stream, token_formula)

__all__ = ["DataConfig", "ImageStream", "LMStream", "fold_in",
           "image_formula", "make_stream", "token_formula"]
