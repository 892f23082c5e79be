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
    keep = _keep(sq, sk, causal, window, q.device)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o.to(q.dtype), lse


def _keep(sq: int, sk: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(Sq, Sk) bool mask, query positions right-aligned to the keys."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None):
    """Gradients of :func:`attention` by the flash kernels' formula.

    Shapes as :func:`attention`; ``o`` and ``lse`` are its outputs and
    ``do`` the gradient of ``o``.  P is recomputed from ``lse``
    (``p = exp(s * scale - lse)``), ``delta = rowsum(dO * O)`` and
    ``ds = p * (dp - delta) * scale``; all math in f32.  Returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v, with dk and dv summed
    over each GQA group."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    b, hkv, sk = k.shape[0], k.shape[1], k.shape[2]
    group = hq // hkv
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    keep = _keep(sq, sk, causal, window, q.device)
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if group > 1:
        dk = dk.reshape(b, hkv, group, sk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None):
    """RWKV6 'WKV': linear attention with a data-dependent decay, the
    sequential f32 scan (twin of ``repro.kernels.ref.rwkv6_wkv``).

    r, k, w: (B, H, T, Dk); v: (B, H, T, Dv); u: (H, Dk) bonus; state:
    (B, H, Dk, Dv) f32 (zeros when None).  ``w`` are decay logits:
    ``decay_t = exp(-exp(w_t))`` per channel, and

        out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
        S_t   = diag(decay_t) S_{t-1} + k_t v_t^T

    Returns ``(out (B, H, T, Dv) in v's dtype, final state f32)``.
    """
    bsz, h, t, dk = r.shape
    dv = v.shape[-1]
    s = (torch.zeros((bsz, h, dk, dv), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        a = kf[:, :, i, :, None] * vf[:, :, i, None, :]      # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, i], s + uf * a))
        s = torch.exp(-torch.exp(wf[:, :, i]))[..., None] * s + a
    return torch.stack(outs, dim=2).to(v.dtype), s


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: Optional[torch.Tensor], dout: torch.Tensor,
                  ds_t: Optional[torch.Tensor] = None):
    """Gradients of :func:`rwkv6_wkv` by the backward kernel's formula, a
    plain reverse scan in f32: the states are recomputed forward from
    ``s0`` (zeros when None), then walked back from ``G = ds_t`` (zeros
    when None), with ``c_t = v_t . dout_t`` and ``S_{t-1}`` the state
    before step t:

        dr_t = S_{t-1} dout_t + (u*k_t) c_t
        dk_t = G v_t + (u*r_t) c_t
        dv_t = G^T k_t + (r_t . (u*k_t)) dout_t
        dw_t = -rowsum(G * S_{t-1}) * decay_t * exp(w_t)
        du  += r_t * k_t c_t               (summed over the batch too)
        G    = diag(decay_t) G + r_t dout_t^T,   ds0 = G at the end.

    Returns ``(dr, dk, dv, dw, du, ds0)``: dr, dk, dv in r's dtype; dw
    (B, H, T, Dk), du (H, Dk) and ds0 (B, H, Dk, Dv) in f32."""
    bsz, h, t, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()[None]                                     # (1, H, Dk)
    ew = torch.exp(wf)
    decay = torch.exp(-ew)
    s = (torch.zeros((bsz, h, dk, dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    states = []                                    # S_{t-1} of each step
    for i in range(t):
        states.append(s)
        s = decay[:, :, i, :, None] * s + (kf[:, :, i, :, None]
                                           * vf[:, :, i, None, :])
    g = (torch.zeros_like(s) if ds_t is None else ds_t.float())
    dr, dk_, dv_, dw = (torch.empty_like(x) for x in (rf, kf, vf, wf))
    du = torch.zeros((bsz, h, dk), dtype=torch.float32, device=r.device)
    for i in reversed(range(t)):
        s_prev, d_i, r_i, k_i, v_i = (states[i], df[:, :, i], rf[:, :, i],
                                      kf[:, :, i], vf[:, :, i])
        c = (v_i * d_i).sum(dim=-1, keepdim=True)            # (B, H, 1)
        b_t = (r_i * uf * k_i).sum(dim=-1, keepdim=True)
        dr[:, :, i] = (torch.einsum("bhkv,bhv->bhk", s_prev, d_i)
                       + uf * k_i * c)
        dk_[:, :, i] = torch.einsum("bhkv,bhv->bhk", g, v_i) + uf * r_i * c
        dv_[:, :, i] = torch.einsum("bhkv,bhk->bhv", g, k_i) + b_t * d_i
        dw[:, :, i] = (-(g * s_prev).sum(dim=-1) * decay[:, :, i]
                       * ew[:, :, i])
        du = du + r_i * k_i * c
        g = decay[:, :, i, :, None] * g + r_i[..., None] * d_i[..., None, :]
    return (dr.to(r.dtype), dk_.to(k.dtype), dv_.to(v.dtype), dw,
            du.sum(dim=0), g)


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


# the B4 kernel's own definition: RL002 exempts the JAX package's
# kernels directory, not the port's
# reprolint: disable=RL002
def parareal_update(y: torch.Tensor, cur: torch.Tensor,
                    prev: torch.Tensor):
    """out = y + cur - prev, rounded once from f32 to y's dtype like the
    kernel, and the f32 L1 sum |cur - prev| (the correction's size).

    The JAX oracle computes ``out`` in the input dtype, rounding twice in
    bf16 (ROADMAP C6); in f32 the two agree bitwise.
    """
    cf, pf = cur.float(), prev.float()
    return (y.float() + cf - pf).to(y.dtype), (cf - pf).abs().sum()


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
