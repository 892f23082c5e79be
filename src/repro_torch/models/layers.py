"""Model layers the DiT uses (counterpart of ``repro.models.layers``):
RMSNorm, non-causal full attention without rotary embeddings, the GELU
MLP and the sinusoidal time embedding.  Weights are plain tensors in the
JAX layout ``(d_in, d_out)``, applied as ``x @ w``.  Layer norm, rotary
and causal attention, decode attention and SwiGLU wait for the LLM zoo
(ROADMAP A11).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def apply_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype; ``scale=None`` is unit."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        xf = xf * scale.float()
    return xf.to(x.dtype)


def attention_full(p, x: torch.Tensor, *, num_heads: int, num_kv_heads: int,
                   head_dim: int,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Non-causal full-sequence attention without rotary embeddings,
    x: (B, S, d) -> (B, S, d), through
    :func:`repro_torch.kernels.ops.attention` (the flash kernels, forward
    and backward, on CUDA).  ``p`` maps ``wq``/``wk``/``wv``/``wo`` to
    weights."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, num_kv_heads, head_dim)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = kops.attention(qt, kt, vt, causal=False, use_kernel=use_kernel)
    return o.transpose(1, 2).reshape(b, s, num_heads * head_dim) @ p["wo"]


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP; ``jax.nn.gelu`` is the tanh approximation, run in f32."""
    h = F.gelu((x @ p["w_up"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]


def sinusoidal_time_embed(t: torch.Tensor, dim: int,
                          max_period: float = 10_000.0) -> torch.Tensor:
    """t: (B,) -> (B, dim), cos half first, then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
