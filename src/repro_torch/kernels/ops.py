"""Public kernel entry points, dispatched by the tensor's device.

Counterpart of ``repro.kernels.ops``.  The rule is the same for every op:

* a CUDA tensor launches the hand-written kernel, or raises — there is no
  fallback to the plain version on the card;
* a CPU tensor runs the kernel's plain PyTorch version in
  :mod:`repro_torch.kernels.ref` (the CPU tests' path);
* ``use_kernel=False`` is the explicit plain path on any device
  (``chip_smoke.py``'s yardstick; the main path never passes it).

Each kernel wrapper carries a ``launches`` counter
(``flash_attention_fwd.launches``, ``flash_attention_bwd_dq.launches``,
``flash_attention_bwd_dkv.launches``, ``ddim_fused.launches``,
``parareal_update_residual.launches``, ``parareal_update.launches``)
that :func:`launch_counts` reads and :func:`reset_launch_counts` zeroes.

:func:`attention` is differentiable: it runs through
:class:`FlashAttention`, the counterpart of ``repro.kernels.ops._flash``
(a ``jax.custom_vjp``), whose backward is the flash backward kernels on a
CUDA tensor and their plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import elementwise, ref
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_fwd)

_COUNTED = {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "ddim_fused": elementwise.ddim_fused,
            "parareal_update_residual": elementwise.parareal_update_residual,
            "parareal_update": elementwise.parareal_update}


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


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> contiguous (B*H, S, D), the kernels' layout."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]).contiguous()


class FlashAttention(torch.autograd.Function):
    """Attention with the flash kernels' forward and backward.

    Inputs ``(B, Hq, Sq, D)`` x ``(B, Hkv, Sk, D)``.  The forward keeps
    ``(q, k, v, o, lse)``; the backward recomputes P from ``lse``.  On a
    CUDA tensor both directions launch the kernels (forms the kernels do
    not take raise ``NotImplementedError``); on a CPU tensor they run
    :func:`ref.attention` and :func:`ref.attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.mask = dict(causal=causal, window=window, scale=scale)
        if q.is_cuda:
            q3, k3, v3 = _heads(q), _heads(k), _heads(v)
            o3, lse = flash_attention_fwd(q3, k3, v3, **ctx.mask)
            ctx.save_for_backward(q3, k3, v3, o3, lse)
            ctx.shapes = q.shape, k.shape
            return o3.view(q.shape)
        o, lse = ref.attention(q, k, v, **ctx.mask)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                             _heads(do.to(q.dtype)),
                                             **ctx.mask)
            q_shape, k_shape = ctx.shapes
            grads = dq.view(q_shape), dk.view(k_shape), dv.view(k_shape)
        else:
            grads = ref.attention_bwd(q, k, v, o, lse, do.to(q.dtype),
                                      **ctx.mask)
        return (*grads, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) -> (B, Hq, Sq, D), differentiable
    through :class:`FlashAttention`; ``use_kernel=False`` is the plain
    :func:`ref.attention`, differentiated by autograd."""
    if use_kernel is False:
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)[0]
    return FlashAttention.apply(q, k, v, causal, window, scale)


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


# the B4 kernel's own definition: RL002 exempts the JAX package's
# kernels directory, not the port's
# reprolint: disable=RL002
def parareal_update(y: torch.Tensor, cur: torch.Tensor, prev: torch.Tensor,
                    *, use_kernel: Optional[bool] = None):
    """``(y + cur - prev, sum|cur - prev|)`` in one pass; the sum is f32."""
    if not _kernel(y, use_kernel):
        return ref.parareal_update(y, cur, prev)
    return elementwise.parareal_update(y, cur, prev)
