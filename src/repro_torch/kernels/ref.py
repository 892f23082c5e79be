"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

Each function defines the semantics its CUDA/Triton kernel reproduces.
The ops layer runs them for CPU tensors; ``chip_smoke.py`` holds every
kernel against them on the card.  Where the JAX oracle and the JAX kernel
disagree (the residual's rounding), the twin follows the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None):
    """Multi-head attention with optional causal / sliding-window masking.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA).
    Query positions are right-aligned (``q_pos = i + Sk - Sq``); ``window``
    keeps keys j with ``q_pos - window < j <= q_pos``.  Returns
    ``(o, lse)``: o (B, Hq, Sq, D) in q's dtype and the per-row
    logsumexp (B, Hq, Sq) in f32, all math in f32.  Masked scores are
    ``NEG_INF`` as in the flash kernel, so a row with no live key returns
    o = 0 and lse = NEG_INF (the JAX oracle's -inf softmax gives NaN there).
    """
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o.to(q.dtype), lse


def _rows(c, x: torch.Tensor) -> torch.Tensor:
    """A coefficient of shape () or (M,) as f32, broadcastable over x."""
    c = torch.as_tensor(c, dtype=torch.float32, device=x.device)
    return c.reshape(c.shape + (1,) * (x.ndim - c.ndim))


def ddim_fused(x: torch.Tensor, eps: torch.Tensor, a, b) -> torch.Tensor:
    """x' = sqrt(b) * (x - sqrt(1-a) eps) / sqrt(a) + sqrt(1-b) eps, in f32.

    ``a``/``b`` are the signal levels, each of shape () or per row
    ``(M,)`` over x's leading axis (B blocks folded into the batch give
    every row its own pair)."""
    a, b = _rows(a, x), _rows(b, x)
    xf, ef = x.float(), eps.float()
    x0 = (xf - torch.sqrt(1.0 - a) * ef) / torch.sqrt(a)
    return (torch.sqrt(b) * x0 + torch.sqrt(1.0 - b) * ef).to(x.dtype)


def parareal_update_residual(y: torch.Tensor, cur: torch.Tensor,
                             prev: torch.Tensor, old: torch.Tensor, *,
                             batch_dims: int = 0):
    """out = y + cur - prev, rounded once from f32 to y's dtype, and the
    f32 L1 sum |out - old| taken on the unrounded f32 value.

    ``batch_dims`` leading axes are preserved by the reduction: 0 -> a
    scalar, 1 -> per sample ``(K,)``, 2 -> per block and sample ``(B, K)``.
    Each slice is reduced on its own row of a ``(slices, n)`` view, so a
    slice's sum does not depend on how many slices ride along.
    """
    nd = int(batch_dims)
    if not 0 <= nd <= y.ndim:
        raise ValueError(f"batch_dims={nd} out of range for ndim={y.ndim}")
    outf = y.float() + cur.float() - prev.float()
    lead = y.shape[:nd]
    diff = (outf - old.float()).abs().reshape(math.prod(lead), -1)
    return outf.to(y.dtype), diff.sum(dim=1).reshape(lead)
