"""Noise schedules on the reversed grid (counterpart of
``repro.core.schedules``).

Grid convention: index ``i = 0`` is pure Gaussian noise, ``i = N`` the
clean sample.  Schedules are built in numpy exactly as the JAX package
builds them, so ``ab`` and ``t_model`` agree bit for bit; the host keeps
that numpy copy, and :meth:`DiffusionSchedule.gather` hands the solvers
per-row device tensors for a host-side index array, cached per index
pattern, so a sampling loop needs no ``.item()`` and no per-step copy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

_SCHEDULES = {}


def register_schedule(name):
    def deco(fn):
        _SCHEDULES[name] = fn
        return fn

    return deco


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Discretized schedule on the reversed grid.

    ab:       (N+1,) numpy — ᾱ per grid point, ab[0] ≈ 0 (noise).
    t_model:  (N+1,) numpy — the denoiser's conditioning time per point.
    kind:     schedule family name.
    """

    ab: np.ndarray
    t_model: np.ndarray
    kind: str = "ddpm_linear"
    _tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def num_steps(self) -> int:
        return int(self.ab.shape[0]) - 1

    def astype(self, dtype) -> "DiffusionSchedule":
        return DiffusionSchedule(self.ab.astype(dtype),
                                 self.t_model.astype(dtype), self.kind)

    def gather(self, idx: np.ndarray, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """``(alpha_bar, t_model)`` at the host-side grid indices ``idx``
        (shape ``(M,)``, one per row of the batch) as device tensors in the
        schedule's dtype.  The first call per index pattern and device
        copies to the device; later calls reuse that copy."""
        idx = np.asarray(idx, dtype=np.int64)
        key = (idx.tobytes(), idx.shape, str(device))
        hit = self._tables.get(key)
        if hit is None:
            hit = (host_to_device(self.ab[idx], device),
                   host_to_device(self.t_model[idx], device))
            self._tables[key] = hit
        return hit


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` that does not wait for the
    device: on a CUDA device the copy goes through pinned memory,
    non-blocking and ordered on the current stream (a copy from pageable
    memory would wait for the stream to drain, a hidden host sync)."""
    t = torch.from_numpy(np.array(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _ddpm_alpha_bar(t_train: int, beta_start: float,
                    beta_end: float) -> np.ndarray:
    betas = np.linspace(beta_start, beta_end, t_train, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def _cosine_alpha_bar(t_train: int, s: float = 0.008) -> np.ndarray:
    ts = np.arange(t_train + 1, dtype=np.float64) / t_train
    f = np.cos((ts + s) / (1 + s) * np.pi / 2) ** 2
    ab = f[1:] / f[0]
    return np.clip(ab, 1e-5, 0.999999)


def _trad_steps(num_steps: int, t_train: int) -> np.ndarray:
    """Traditional timesteps, highest noise first: i=0 -> t_train-1."""
    return np.round(np.linspace(t_train - 1, 0,
                                num_steps + 1)).astype(np.int64)


@register_schedule("ddpm_linear")
def ddpm_linear(num_steps: int, t_train: int = 1000, beta_start: float = 1e-4,
                beta_end: float = 0.02) -> DiffusionSchedule:
    """DDPM linear-β schedule subsampled to ``num_steps`` grid intervals."""
    t_trad = _trad_steps(num_steps, t_train)
    ab = _ddpm_alpha_bar(t_train, beta_start, beta_end)[t_trad]
    return DiffusionSchedule(ab.astype(np.float32),
                             t_trad.astype(np.float32), "ddpm_linear")


@register_schedule("cosine")
def cosine(num_steps: int, t_train: int = 1000) -> DiffusionSchedule:
    t_trad = _trad_steps(num_steps, t_train)
    ab = _cosine_alpha_bar(t_train)[t_trad]
    return DiffusionSchedule(ab.astype(np.float32),
                             t_trad.astype(np.float32), "cosine")


@register_schedule("karras")
def karras(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
           rho: float = 7.0) -> DiffusionSchedule:
    """Karras et al. (2022) σ-grid as ᾱ via VP<->VE: ab = 1/(1+σ²)."""
    steps = np.arange(num_steps + 1, dtype=np.float64) / num_steps
    sig = (sigma_max ** (1 / rho) + steps * (sigma_min ** (1 / rho)
                                             - sigma_max ** (1 / rho))) ** rho
    sig[-1] = sigma_min  # keep strictly positive so VE transform stays finite
    ab = 1.0 / (1.0 + sig ** 2)
    return DiffusionSchedule(ab.astype(np.float32), sig.astype(np.float32),
                             "karras")


def make_schedule(kind: str, num_steps: int, **kw) -> DiffusionSchedule:
    if kind not in _SCHEDULES:
        raise ValueError(f"unknown schedule {kind!r}; have "
                         f"{sorted(_SCHEDULES)}")
    return _SCHEDULES[kind](num_steps, **kw)
