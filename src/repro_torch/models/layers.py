"""Model layers (counterpart of ``repro.models.layers``): RMSNorm and
LayerNorm, the half-split rotary embedding, attention (GQA, qk-norm,
biases, causal and sliding-window masks) for full sequences and for one
decode token, the SwiGLU and GELU MLPs, embeddings and the sinusoidal
time embedding.  Weights are plain tensors in the JAX layout
``(d_in, d_out)``, applied as ``x @ w``; a parameter group ``p`` is any
mapping from the JAX leaf names to tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def apply_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               eps: float = 1e-6, *, kind: str = "rmsnorm",
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm or LayerNorm (``kind``) in f32, cast back to x's dtype;
    ``scale=None`` is unit, ``bias`` is LayerNorm's shift."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    if scale is not None:
        xf = xf * scale.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  The half-split form:
    the two halves of the head dim rotate as one complex pair, as in
    JAX (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def project_qkv(p, x: torch.Tensor, num_heads: int, num_kv_heads: int,
                head_dim: int, positions: Optional[torch.Tensor],
                theta: Optional[float], qk_norm: bool = False):
    """(q (B,S,Hq,D), k (B,S,Hkv,D), v): projections with optional biases;
    with ``qk_norm`` RMSNorm over the head dim runs before rope."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = apply_norm(q, p["q_norm"]["scale"])
        k = apply_norm(k, p["k_norm"]["scale"])
    if theta is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def attention_full(p, x: torch.Tensor, *, num_heads: int, num_kv_heads: int,
                   head_dim: int, causal: bool = True,
                   window: Optional[int] = None,
                   theta: Optional[float] = 10_000.0, qk_norm: bool = False,
                   positions: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None):
    """Full-sequence attention (training, prefill, the DiT), x: (B, S, d).
    Runs through :func:`repro_torch.kernels.ops.attention` (the flash
    kernels on CUDA).  Returns ``(out (B, S, d), (k, v))`` with k after
    qk-norm and rope, each (B, S, Hkv, D): the decode cache's layout."""
    b, s, _ = x.shape
    if positions is None and theta is not None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = project_qkv(p, x, num_heads, num_kv_heads, head_dim, positions,
                          theta, qk_norm)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = kops.attention(qt, kt, vt, causal=causal, window=window,
                       use_kernel=use_kernel)
    o = o.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return o @ p["wo"], (k, v)


def attention_decode(p, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, num_heads: int,
                     num_kv_heads: int, head_dim: int,
                     window: Optional[int] = None,
                     theta: Optional[float] = 10_000.0,
                     qk_norm: bool = False):
    """One decode token, x: (B, 1, d), against caches (B, S_max, Hkv, D) at
    position ``pos``: writes this token's K/V into the caches at ``pos``
    (in place, where JAX returns updated copies) and attends over every
    cache entry up to it with a masked f32 softmax, the plain matvec-bound
    path of the JAX package (which has no kernel here).  Returns
    ``(out (B, 1, d), k_cache, v_cache)``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                                  positions, theta, qk_norm)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    s_max = k_cache.shape[1]
    group = num_heads // num_kv_heads
    qf = q.float().reshape(b, 1, num_kv_heads, group, head_dim)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qf,
                          k_cache.float()) / math.sqrt(head_dim)
    kpos = torch.arange(s_max, device=x.device)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (kpos > pos - window)
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", probs, v_cache.float())
    o = o.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    return o @ p["wo"], k_cache, v_cache


def apply_mlp(p, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU (SiLU of the gate in f32, cast, times ``x @ w_up``) or GELU
    (``jax.nn.gelu``'s tanh form, in f32)."""
    if act == "swiglu":
        h = F.silu((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    else:
        h = F.gelu((x @ p["w_up"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return (x @ p["w"]).float()


def sinusoidal_time_embed(t: torch.Tensor, dim: int,
                          max_period: float = 10_000.0) -> torch.Tensor:
    """t: (B,) -> (B, dim), cos half first, then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
