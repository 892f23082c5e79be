"""RWKV6 "Finch" block (counterpart of ``repro.models.rwkv6``):
data-dependent token shift, the WKV recurrence with a data-dependent
per-channel decay, and the squared-ReLU channel mix.

The WKV recurrence runs through :func:`repro_torch.kernels.ops.rwkv6_wkv`
(the CUDA kernel on the card, its plain twin on the CPU), in prefill, in
every decode step and in training, where its ``RWKV6WKV`` Function's
backward is the WKV backward kernel; the decay logits' clamp is
differentiated by autograd, as JAX differentiates its ``jnp.clip``.
Dtypes follow the JAX lines: the token-shift and projections run in the
model dtype, the decay LoRA in f32 (``w_base``, ``u`` and the state are
f32), the group norm and the gates in f32, cast back before the next
product.

State per layer: ``(x_tmix (B, d), wkv (B, H, dk, dk) f32, x_cmix (B, d))``.

Tensor parallel (``tp``, a :class:`repro_torch.parallel.tensor_parallel.
TensorParallel` with a group): ``wr``, ``wk``, ``wv``, ``wg`` and the
channel mix's ``wk_c``, ``wr_c`` are the rank's columns, ``wo`` and
``wv_c`` its rows; the token shift, the mixes and the decay LoRA run on
the whole, replicated ``d``, and the WKV kernel on the rank's heads with
its rows of ``u`` and ``gn_scale`` (its ``state.wkv`` is its heads').  The
channel mix's gate is the rank's ``d`` columns while ``k @ wv_c`` is a
sum over ranks: that sum is reduce-scattered onto the same columns, the
product gathered back over ``d`` (and, under ``sp``, cut to the rank's
part of the sequence) before the residual.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

LORA_R = 32


class RWKVState(NamedTuple):
    x_tmix: torch.Tensor    # (B, d)
    wkv: torch.Tensor       # (B, H, dk, dk) f32
    x_cmix: torch.Tensor    # (B, d)


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); x_prev: (B, d) carried from the previous segment."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int,
                eps: float = 1e-5) -> torch.Tensor:
    b, s, d = x.shape
    xf = x.float().reshape(b, s, h, d // h)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(b, s, d) * scale).to(x.dtype)


def time_mix(p, x: torch.Tensor, state: RWKVState, head_dim: int, *,
             use_kernel: Optional[bool] = None, tp=None):
    """x: (B, S, d).  Returns ``(out, x[:, -1], final WKV state)``; with
    ``tp``, ``out`` is the rank's partial sum."""
    b, s, d = x.shape
    h = p["wr"].shape[1] // head_dim
    xx = _shift(x, state.x_tmix) - x
    base = x + xx * p["mu_base"]
    z = torch.tanh(base @ p["A_mix"]).reshape(b, s, 5, LORA_R)
    mixes = p["mu_rkvwg"][None, None] + torch.einsum(
        "bsfr,frd->bsfd", z, p["B_mix"].to(z.dtype)).to(x.dtype)
    xr, xk, xv, xw, xg = (x + xx * mixes[:, :, i] for i in range(5))

    def heads(t):
        return t.reshape(b, s, h, head_dim).transpose(1, 2)

    r, k, v = heads(xr @ p["wr"]), heads(xk @ p["wk"]), heads(xv @ p["wv"])
    g = xg @ p["wg"]
    w_logit = p["w_base"] + torch.tanh(
        xw.float() @ p["A_w"].float()) @ p["B_w"].float()
    # clamp for numerical sanity of exp(-exp(w))
    w_logit = torch.clamp(w_logit, -8.0, 4.0)
    u, gn_scale = p["u"], p["gn_scale"]
    if tp is not None:
        w_logit, u, gn_scale = (tp.part(w_logit, -1), tp.part(u, 0),
                                tp.part(gn_scale, 0))
    w_logit = heads(w_logit)

    wkv, s_fin = kops.rwkv6_wkv(r, k, v, w_logit, u, state.wkv,
                                use_kernel=use_kernel)
    wkv = wkv.transpose(1, 2).reshape(b, s, h * head_dim)
    out = _group_norm(wkv, gn_scale, h)
    out = out * F.silu(g.float()).to(out.dtype)
    return out @ p["wo"], x[:, -1], s_fin


def channel_mix(p, x: torch.Tensor, state: RWKVState, *, tp=None):
    """Returns ``(out, x[:, -1])``; with ``tp``, ``out`` is whole (under
    ``sp`` the rank's part of the sequence)."""
    from repro_torch.parallel import collectives as coll
    xx = _shift(x, state.x_cmix) - x
    xk = x + xx * p["mu_ck"]
    xr = x + xx * p["mu_cr"]
    kk = torch.square(F.relu((xk @ p["wk_c"]).float())).to(x.dtype)
    gate = torch.sigmoid((xr @ p["wr_c"]).float()).to(x.dtype)
    if tp is None or tp.group is None:
        return gate * (kk @ p["wv_c"]), x[:, -1]
    kv = coll.scatter_seq(kk @ p["wv_c"], -1, tp.group)
    out = coll.gather_split(gate * kv, -1, tp.group)
    if tp.sp:
        out = coll.split(out, 1, tp.group)
    return out, x[:, -1]


def rwkv_block(p, x: torch.Tensor, state: RWKVState, head_dim: int,
               norm_fn: Callable, *, use_kernel: Optional[bool] = None,
               tp=None):
    """The pre-norm RWKV6 block.  Returns ``(x_out, new_state)``; with
    ``tp``, the state's ``x_tmix``/``x_cmix`` are whole, its ``wkv`` the
    rank's heads."""
    def enter(t):
        return t if tp is None else tp.enter(t)

    h1, xt, wkv = time_mix(p["tmix"], enter(norm_fn(p["ln1"], x)), state,
                           head_dim, use_kernel=use_kernel, tp=tp)
    x = x + (h1 if tp is None else tp.leave(h1))
    h2, xc = channel_mix(p["cmix"], enter(norm_fn(p["ln2"], x)), state,
                         tp=tp)
    return x + h2, RWKVState(x_tmix=xt, wkv=wkv, x_cmix=xc)


def init_rwkv_state(batch: int, d_model: int, head_dim: int,
                    dtype=torch.bfloat16, device=None) -> RWKVState:
    h = d_model // head_dim
    return RWKVState(
        x_tmix=torch.zeros((batch, d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32,
                        device=device),
        x_cmix=torch.zeros((batch, d_model), dtype=dtype, device=device))
