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
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

# rows an MLP runs at once where no gradient is recorded (apply_mlp)
MLP_CHUNK_ROWS = 2048


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


def select_kv(t: torch.Tensor, share) -> torch.Tensor:
    """The K (or V) heads ``(B, S, H, D)`` a rank's q heads read, by its
    :class:`repro_torch.parallel.tensor_parallel.HeadShare`: its own block
    where the heads are split, a contiguous run of the replicated heads,
    or (``kv_index``) the replicated heads repeated to its q heads."""
    if share.kv_split:
        return t
    if share.kv_index is None:
        return t.narrow(2, share.kv_start, share.kv_heads)
    idx = torch.tensor(share.kv_index, dtype=torch.long, device=t.device)
    return t.index_select(2, idx)


def attention_full(p, x: torch.Tensor, *, head_dim: int,
                   num_heads: Optional[int] = None,
                   num_kv_heads: Optional[int] = None,
                   causal: bool = True,
                   window: Optional[int] = None,
                   theta: Optional[float] = 10_000.0, qk_norm: bool = False,
                   positions: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None,
                   kv_gather: Optional[Callable] = None,
                   chunk_kv: Optional[int] = None, share=None):
    """Full-sequence attention (training, prefill, the DiT), x: (B, S, d).
    Runs through :func:`repro_torch.kernels.ops.attention` (the flash
    kernels on CUDA).  Returns ``(out (B, S, d), (k, v))`` with k after
    qk-norm and rope, each (B, S, Hkv, D): the decode cache's layout.

    ``kv_gather``: the sequence-parallel hook of JAX's ``attention_full``.
    Where ``x`` is this rank's rows of the sequence, it gathers the
    projected K and V along the sequence dim (``(B, S_local, Hkv, D) ->
    (B, S, Hkv, D)``), so the ``S_local`` queries attend to every key (the
    DiT's patch rows: the flash forward at ``Sq = S_local``, ``Sk = S``).
    Positions are the caller's: global ones for rope, or ``theta=None``.
    The returned (k, v) are the gathered ones, as JAX's.

    ``share``: a tensor-parallel rank's heads (a
    :class:`repro_torch.parallel.tensor_parallel.HeadShare`, in place of
    ``num_heads``/``num_kv_heads``): ``p`` holds the rank's q columns and
    ``wo`` rows, and its K/V columns or all of them; the kernel sees the
    rank's q heads and the K/V heads they read (:func:`select_kv`);
    ``out`` is the rank's partial sum (the caller sums it over ``model``)
    and ``(k, v)`` are the projected heads (the rank's, or all).

    ``chunk_kv``: where the flash kernel does not run (a CPU tensor or
    ``use_kernel=False``), JAX's plain chunked attention
    (:func:`repro_torch.kernels.ref.attention_chunked`, ``chunk_kv``
    keys a tile)."""
    b, s, _ = x.shape
    if share is not None:
        num_heads = share.hq_l
        num_kv_heads = share.kv_heads if share.kv_split else share.hkv
    if positions is None and theta is not None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = project_qkv(p, x, num_heads, num_kv_heads, head_dim, positions,
                          theta, qk_norm)
    if kv_gather is not None:
        k, v = kv_gather(k), kv_gather(v)
    ka, va = (k, v) if share is None else (select_kv(k, share),
                                           select_kv(v, share))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, ka, va))
    if chunk_kv is not None and not (x.is_cuda and use_kernel is not False):
        o = kref.attention_chunked(qt, kt, vt, causal=causal, window=window,
                                   chunk=chunk_kv)
    else:
        o = kops.attention(qt, kt, vt, causal=causal, window=window,
                           use_kernel=use_kernel)
    o = o.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return o @ p["wo"], (k, v)


def decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, valid: torch.Tensor,
                    head_dim: int):
    """One token's attention over a part of the cache: q (B, 1, Hq, D)
    against ``(B, C, Hkv, D)`` where ``valid`` (C,) holds, with the plain
    decode's masked f32 softmax.  Returns ``(o (B, 1, Hkv, G, D) f32,
    normalized by this part's softmax, lse (B, 1, Hkv, G))``; a part with
    no valid slot gives lse -inf (the caller zeroes its o)."""
    b, _, hq, _ = q.shape
    hkv = k_cache.shape[2]
    qf = q.float().reshape(b, 1, hkv, hq // hkv, head_dim)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qf,
                          k_cache.float()) / math.sqrt(head_dim)
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", probs, v_cache.float())
    lse = torch.logsumexp(logits, dim=-1).permute(0, 3, 1, 2)
    return o, lse


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


def _mlp_rows(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    else:
        h = F.gelu((x @ p["w_up"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]


def apply_mlp(p, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU (SiLU of the gate in f32, cast, times ``x @ w_up``) or GELU
    (``jax.nn.gelu``'s tanh form, in f32).  Where no gradient is recorded
    and ``x`` has more than :data:`MLP_CHUNK_ROWS` rows, the same per-row
    math runs over chunks of that many rows into one output, so the
    ``(rows, d_ff)`` temporaries of a long prefill are a chunk's."""
    ws = [p[k] for k in ("w_gate", "w_up", "w_down") if k in p]
    rows = x.numel() // x.shape[-1]
    if rows <= MLP_CHUNK_ROWS or (torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *ws])):
        return _mlp_rows(p, x, act)
    flat = x.reshape(rows, x.shape[-1])
    w_down = p["w_down"]
    out = flat.new_empty((rows, w_down.shape[-1]),
                         dtype=torch.result_type(flat, w_down))
    for lo in range(0, rows, MLP_CHUNK_ROWS):
        out[lo:lo + MLP_CHUNK_ROWS] = _mlp_rows(
            p, flat[lo:lo + MLP_CHUNK_ROWS], act)
    return out.reshape(*x.shape[:-1], w_down.shape[-1])


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
