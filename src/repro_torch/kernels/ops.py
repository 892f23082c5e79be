"""Public kernel entry points, dispatched by the tensor's device.

Counterpart of ``repro.kernels.ops``.  The rule is the same for every op:

* a CUDA tensor launches the hand-written kernel, or raises — there is no
  fallback to the plain version on the card;
* a CPU tensor runs the kernel's plain PyTorch version in
  :mod:`repro_torch.kernels.ref` (the CPU tests' path);
* ``use_kernel=False`` is the explicit plain path on any device
  (``chip_smoke.py``'s yardstick; the main path never passes it).

Each kernel wrapper carries a ``launches`` counter
(``flash_attention_fwd.launches``, ``ddim_fused.launches``,
``parareal_update_residual.launches``) that :func:`launch_counts` reads
and :func:`reset_launch_counts` zeroes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import elementwise, ref
from .flash_attention import flash_attention_fwd

_COUNTED = {"flash_attention_fwd": flash_attention_fwd,
            "ddim_fused": elementwise.ddim_fused,
            "parareal_update_residual": elementwise.parareal_update_residual}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


def fused_default(x: torch.Tensor) -> bool:
    """Whether the fused elementwise kernels are on by default for ``x``:
    on a CUDA tensor they always are (the kernel launches or raises); on
    the CPU the samplers keep their plain tensor arithmetic."""
    return x.is_cuda


def _kernel(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    return x.is_cuda and use_kernel is not False


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    if not _kernel(q, use_kernel):
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)[0]
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o, _ = flash_attention_fwd(q.reshape(b * hq, sq, d),
                               k.reshape(b * hkv, sk, d),
                               v.reshape(b * hkv, sk, d),
                               causal=causal, window=window, scale=scale)
    return o.reshape(b, hq, sq, d)


def ddim_fused(x: torch.Tensor, eps: torch.Tensor, a, b, *,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fused DDIM update; ``a``/``b`` of shape () or per row ``(M,)``."""
    if not _kernel(x, use_kernel):
        return ref.ddim_fused(x, eps, a, b)
    f32 = dict(dtype=torch.float32, device=x.device)
    return elementwise.ddim_fused(x, eps, torch.as_tensor(a, **f32),
                                  torch.as_tensor(b, **f32))


def parareal_update_residual(y: torch.Tensor, cur: torch.Tensor,
                             prev: torch.Tensor, old: torch.Tensor, *,
                             batch_dims: int = 0,
                             use_kernel: Optional[bool] = None):
    """``(y + cur - prev, sum|out - old|)`` in one pass; the residual keeps
    the ``batch_dims`` leading axes (0: scalar, 1: ``(K,)``, 2: ``(B, K)``)."""
    if not _kernel(y, use_kernel):
        return ref.parareal_update_residual(y, cur, prev, old,
                                            batch_dims=batch_dims)
    return elementwise.parareal_update_residual(y, cur, prev, old,
                                                batch_dims=batch_dims)
