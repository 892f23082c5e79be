"""Hymba block (counterpart of ``repro.models.hymba``): attention and a
diagonal selective SSM side by side in every layer, each output normed and
the two averaged.  Every layer is sliding-window; the SSM carries the
global context.

The SSM's recurrence runs through
:func:`repro_torch.kernels.ops.selective_scan` (the CUDA kernel on the
card, its plain twin on the CPU), in prefill, in every decode step and in
training, where ``SelectiveScan`` differentiates it (the scan's backward
kernel on the card, ``ref.selective_scan_bwd`` on the CPU); its
projections (``x @ w_in``, then ``dt``, ``B`` and ``C`` from ``xs``) are
plain products outside it, as JAX computes them outside its
``jax.lax.scan``.  Dtypes follow the JAX lines: ``xs`` is cast to f32
before the scan, ``w_dt``, ``b_dt``, ``w_B``, ``w_C``, ``A_log`` and ``D``
are f32, and the gate is ``ys.to(x.dtype) * silu(z in f32).to(x.dtype)``.
The full-sequence attention is the flash forward in its causal
sliding-window form (and, for a gradient, dq and dkv in that form); decode
attends over the ring with a plain masked
softmax, as JAX does (``hymba.py:117-128``).

Decode state per layer, :class:`HymbaCache`: the SSM state and a ring KV
cache of ``window`` slots, slot ``pos % window`` holding position ``pos``,
with ``ring_pos`` the position in each slot (-1 empty).  The port updates
it in place (JAX returns an updated copy).

Tensor parallel (``tp`` with a group): the SSM's ``d_inner`` channels are
split over ``model``: ``w_in`` holds the rank's columns of both halves,
``[z_r | xs_r]``; ``w_dt``, ``w_B``, ``w_C``, ``A_log``, ``D`` its rows
and ``w_out`` its rows; the products ``xs @ w_dt``, ``@ w_B`` and
``@ w_C`` are summed over ``model`` (one all-reduce, both ways: each
rank's scan reads them) before ``softplus`` and the scan, which runs on
the rank's channels.  The attention and SSM outputs are summed (one
collective for both) before their norms.  Decode keeps the ring split
over ``model`` by slots (rank ``r`` holds slots ``[r W/m, (r+1) W/m)``,
``ring_pos`` whole on every rank): the caller's ``attend`` does the
flash-decoding attention.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .layers import attention_full, project_qkv


class HymbaCache(NamedTuple):
    ssm_h: torch.Tensor      # (B, d_inner, n) f32
    k_ring: torch.Tensor     # (B, W, Hkv, Dh)
    v_ring: torch.Tensor     # (B, W, Hkv, Dh)
    ring_pos: torch.Tensor   # (W,) int32, the position in each slot (-1 empty)


def ssm_forward(p, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                use_kernel: Optional[bool] = None, tp=None):
    """x: (B, S, d).  Returns ``(out (B, S, d), h_fin (B, d_inner, n))``;
    ``h0`` is zeros when None.  With ``tp``, ``out`` is the rank's partial
    sum and ``h_fin`` its channels."""
    zx = x @ p["w_in"]
    z, xs = zx.chunk(2, dim=-1)
    xs = xs.float()          # in f32 models a strided view, read in place
    if tp is None or tp.group is None:
        dt = F.softplus(xs @ p["w_dt"] + p["b_dt"])[..., 0]        # (B, S)
        bb, cc = xs @ p["w_B"], xs @ p["w_C"]                    # (B, S, n)
    else:
        dt, bb, cc = tp.reduce_both(xs @ p["w_dt"], xs @ p["w_B"],
                                    xs @ p["w_C"])
        dt = F.softplus(dt + p["b_dt"])[..., 0]
    ys, h_fin = kops.selective_scan(xs, dt, bb, cc, -torch.exp(p["A_log"]),
                                    p["D"], h0, use_kernel=use_kernel)
    ys = ys.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return ys @ p["w_out"], h_fin


def _leave_both(tp, a: torch.Tensor, b: torch.Tensor):
    """Two partial sums summed over ``model`` in one collective."""
    if tp is None or tp.group is None:
        return a, b
    return tp.leave_parts(a, b)


def hymba_mix_full(p, x: torch.Tensor, attn_kwargs: dict, norm_fn: Callable,
                   h0: Optional[torch.Tensor] = None, *,
                   use_kernel: Optional[bool] = None, tp=None):
    """The parallel attention + SSM mixer over a full sequence (training,
    prefill); ``p`` holds ``attn``, ``ssm``, ``n_attn`` and ``n_ssm``.
    Returns ``(fused, (k, v), h_fin)``; with ``tp`` ``x`` is the entered
    (gathered) input, ``fused`` is whole (under ``sp`` the rank's part of
    the sequence), ``h_fin`` the rank's channels."""
    attn_out, kv = attention_full(p["attn"], x, **attn_kwargs,
                                  use_kernel=use_kernel)
    ssm_out, h_fin = ssm_forward(p["ssm"], x, h0, use_kernel=use_kernel,
                                 tp=tp)
    attn_out, ssm_out = _leave_both(tp, attn_out, ssm_out)
    fused = 0.5 * (norm_fn(p["n_attn"], attn_out)
                   + norm_fn(p["n_ssm"], ssm_out))
    return fused, kv, h_fin


def ring_update(cache: HymbaCache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: int, window: int) -> HymbaCache:
    """Writes one token's K/V (B, 1, Hkv, D) and its position into slot
    ``pos % window``, in place."""
    slot = pos % window
    cache.k_ring[:, slot] = k_new[:, 0].to(cache.k_ring.dtype)
    cache.v_ring[:, slot] = v_new[:, 0].to(cache.v_ring.dtype)
    cache.ring_pos[slot] = pos
    return cache


def hymba_mix_decode(p, x: torch.Tensor, cache: HymbaCache, pos: int, *,
                     num_heads: int = 0, num_kv_heads: int = 0,
                     head_dim: int = 0, window: int, theta: float = None,
                     norm_fn: Callable, use_kernel: Optional[bool] = None,
                     tp=None, attend: Optional[Callable] = None):
    """One decode token, x: (B, 1, d), at position ``pos``: the ring's
    masked f32 softmax and one step of the scan.  Updates ``cache`` in
    place and returns ``(fused, cache)``.

    With ``tp`` (a group) the cache is the rank's part (its ring slots,
    its SSM channels, ``ring_pos`` whole) and ``attend(p_attn, x, k_ring,
    v_ring, valid, slot)`` returns the rank's partial attention output
    over its slots (``slot``: the local slot this rank writes, or
    None)."""
    if tp is not None and tp.group is not None:
        w_l = cache.k_ring.shape[1]
        slot = pos % window
        owner, local = divmod(slot, w_l)
        rp = cache.ring_pos
        rp[slot] = pos
        mine = rp.narrow(0, tp.r * w_l, w_l)
        valid = (mine >= 0) & (mine <= pos) & (mine > pos - window)
        attn_out = attend(p["attn"], x, cache.k_ring, cache.v_ring, valid,
                          local if owner == tp.r else None)
        ssm_out, h_fin = ssm_forward(p["ssm"], x, cache.ssm_h,
                                     use_kernel=use_kernel, tp=tp)
        cache.ssm_h.copy_(h_fin)
        attn_out, ssm_out = _leave_both(tp, attn_out, ssm_out)
        fused = 0.5 * (norm_fn(p["n_attn"], attn_out)
                       + norm_fn(p["n_ssm"], ssm_out))
        return fused, cache
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = project_qkv(p["attn"], x, num_heads, num_kv_heads,
                                  head_dim, positions, theta)
    ring_update(cache, k_new, v_new, pos, window)
    group = num_heads // num_kv_heads
    qf = q.float().reshape(b, 1, num_kv_heads, group, head_dim)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qf,
                          cache.k_ring.float()) / math.sqrt(head_dim)
    rp = cache.ring_pos
    valid = (rp >= 0) & (rp <= pos) & (rp > pos - window)
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", probs, cache.v_ring.float())
    attn_out = o.reshape(b, 1, num_heads * head_dim).to(x.dtype) \
        @ p["attn"]["wo"]
    ssm_out, h_fin = ssm_forward(p["ssm"], x, cache.ssm_h,
                                 use_kernel=use_kernel)
    cache.ssm_h.copy_(h_fin)
    fused = 0.5 * (norm_fn(p["n_attn"], attn_out)
                   + norm_fn(p["n_ssm"], ssm_out))
    return fused, cache


def init_hymba_cache(batch: int, d_inner: int, n_state: int, window: int,
                     num_kv_heads: int, head_dim: int,
                     dtype=torch.bfloat16, device=None) -> HymbaCache:
    ring = (batch, window, num_kv_heads, head_dim)
    return HymbaCache(
        ssm_h=torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                          device=device),
        k_ring=torch.zeros(ring, dtype=dtype, device=device),
        v_ring=torch.zeros(ring, dtype=dtype, device=device),
        ring_pos=torch.full((window,), -1, dtype=torch.int32, device=device))
