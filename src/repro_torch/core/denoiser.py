"""The model-eval seam (single-device subset of ``repro.core.denoiser``).

Every sampler evaluates the backbone through a :class:`Denoiser`.  On one
device it is exactly its ``fn``: ``den(x, t) == fn(x, t)`` with ``x`` of
shape ``(M, ...)`` and per-row times ``t`` of shape ``(M,)`` (SRDS folds
its blocks into the batch, so rows sit at different times).  The
model-parallel modes (``shard_fn``, specs, meshes) wait for ROADMAP A10(b).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["Denoiser", "as_denoiser"]


@dataclasses.dataclass(frozen=True)
class Denoiser:
    fn: Callable                        # (x (M, ...), t (M,)) -> eps

    def __call__(self, x, t):
        return self.fn(x, t)


def as_denoiser(fn) -> Denoiser:
    """Adapt a plain ``model_fn(x, t)`` (identity for a Denoiser)."""
    return fn if isinstance(fn, Denoiser) else Denoiser(fn=fn)
