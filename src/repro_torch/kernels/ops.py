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
``parareal_update_residual.launches``, ``parareal_update.launches``,
``rwkv6_wkv.launches``, ``rwkv6_wkv_bwd.launches``) that
:func:`launch_counts` reads and :func:`reset_launch_counts` zeroes.  The
flash forward and the backward's dq and dkv kernels also count their
launches by route, the tensor-core kernel (bf16, head dim a multiple of
8) or the f32-FMA one (:func:`route_counts`).

:func:`attention` and :func:`rwkv6_wkv` are differentiable: they run
through :class:`FlashAttention` and :class:`RWKV6WKV`, the counterparts of
``repro.kernels.ops._flash`` and ``_wkv`` (``jax.custom_vjp``s), whose
backward is a kernel on a CUDA tensor and its plain version on a CPU
tensor.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import elementwise, ref, rwkv6_scan
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_fwd)
from .rwkv6_scan import rwkv6_wkv_bwd

_COUNTED = {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "ddim_fused": elementwise.ddim_fused,
            "parareal_update_residual": elementwise.parareal_update_residual,
            "parareal_update": elementwise.parareal_update,
            "rwkv6_wkv": rwkv6_scan.rwkv6_wkv,
            "rwkv6_wkv_bwd": rwkv6_wkv_bwd}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


_ROUTED = {"flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


def route_counts() -> Dict[str, int]:
    """The flash kernels' launches by route: ``<name>_tc`` (tensor cores)
    and ``<name>_simt`` (f32 FMA units) for the forward
    (``flash_attention_fwd``) and the backward's ``flash_attention_bwd_dq``
    and ``flash_attention_bwd_dkv``; each pair sums to that name's
    ``launch_counts()`` entry."""
    return {f"{name}_{route}": n for name, fn in _ROUTED.items()
            for route, n in fn.route_launches.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
    for fn in _ROUTED.values():
        for route in fn.route_launches:
            fn.route_launches[route] = 0


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
    CUDA tensor both directions launch the kernels, in every mask and
    group; on a CPU tensor they run :func:`ref.attention` and
    :func:`ref.attention_bwd`."""

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


class RWKV6WKV(torch.autograd.Function):
    """The WKV recurrence with the kernels' forward and backward.

    On a CUDA tensor the forward launches the WKV kernel, writing its
    state checkpoints only when an input needs a gradient, and the
    backward launches the WKV backward kernel; on a CPU tensor they run
    :func:`ref.rwkv6_wkv` and :func:`ref.rwkv6_wkv_bwd`.  Both outputs,
    ``out`` and the final state, take a gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        if r.is_cuda:
            out, s_t, ckpt = rwkv6_scan.rwkv6_wkv(
                r, k, v, w, u, state,
                checkpoints=any(ctx.needs_input_grad))
            ctx.save_for_backward(r, k, v, w, u, ckpt)
        else:
            out, s_t = ref.rwkv6_wkv(r, k, v, w, u, state)
            ctx.save_for_backward(r, k, v, w, u, state)
        return out, s_t

    @staticmethod
    def backward(ctx, dout, ds_t):
        r, k, v, w, u, saved = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(v)
        bwd = rwkv6_wkv_bwd if r.is_cuda else ref.rwkv6_wkv_bwd
        return bwd(r, k, v, w, u, saved, dout, ds_t)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None, *,
              use_kernel: Optional[bool] = None):
    """r, k, w: (B, H, T, Dk); v: (B, H, T, Dv); u: (H, Dk); state:
    (B, H, Dk, Dv) f32, zeros when None.  Returns ``(out (B, H, T, Dv) in
    v's dtype, final state f32)``, differentiable through
    :class:`RWKV6WKV`; ``use_kernel=False`` is the plain
    :func:`ref.rwkv6_wkv`, differentiated by autograd.  The JAX wrapper's
    TPU tuning knobs (``chunk``, ``tuner``, ``plat``) have no counterpart:
    the kernel streams all T steps in one block per batch x head."""
    if state is None:
        b, h, _, dk = r.shape
        state = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                            device=r.device)
    if use_kernel is False:
        return ref.rwkv6_wkv(r, k, v, w, u, state)
    return RWKV6WKV.apply(r, k, v, w, u, state)


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
