"""Deterministic synthetic data (counterpart of ``repro.data``)."""
from .pipeline import (AudioStream, DataConfig, ImageStream, LMStream,
                       VLMStream, audio_formula, fold_in, image_formula,
                       make_stream, token_formula)

__all__ = ["AudioStream", "DataConfig", "ImageStream", "LMStream",
           "VLMStream", "audio_formula", "fold_in", "image_formula",
           "make_stream", "token_formula"]
