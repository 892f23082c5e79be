"""Deterministic synthetic data (counterpart of ``repro.data``)."""
from .pipeline import DataConfig, ImageStream, fold_in, image_formula, make_stream

__all__ = ["DataConfig", "ImageStream", "fold_in", "image_formula",
           "make_stream"]
