"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

Each function defines the semantics its CUDA kernel reproduces.
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


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      chunk: int = 512) -> torch.Tensor:
    """The plain flash-style attention of ``repro.kernels.ref.
    attention_chunked``: an online softmax over tiles of ``chunk`` keys
    (the last padded and masked), f32 throughout, so the largest
    intermediate is ``(B, H, Sq, chunk)``.  Same shapes and masks as
    :func:`attention`; returns o in q's dtype (a row with no live key
    gives 0).  JAX's ``attention_full`` runs it when given ``chunk_kv``
    and the kernel does not run."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else float(d) ** -0.5
    c = min(chunk, sk)
    n_chunks = -(-sk // c)
    pad = n_chunks * c - sk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if group > 1:
        kp = kp.repeat_interleave(group, dim=1)
        vp = vp.repeat_interleave(group, dim=1)
    qf = q.float()
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        k_c = kp[:, :, idx * c:(idx + 1) * c].float()
        v_c = vp[:, :, idx * c:(idx + 1) * c].float()
        s_ = torch.einsum("bhqd,bhkd->bhqk", qf, k_c) * scale
        kpos = idx * c + torch.arange(c, device=q.device)
        keep = (kpos < sk)[None, :]
        if causal:
            keep = keep & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            keep = keep & (kpos[None, :] > qpos[:, None] - window)
        s_ = torch.where(keep, s_, NEG_INF)
        m_new = torch.maximum(m, s_.amax(dim=-1))
        p = torch.where(keep, torch.exp(s_ - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    v_c)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).to(q.dtype)


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


def selective_scan(xs: torch.Tensor, dt: torch.Tensor, bb: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor):
    """Hymba's diagonal selective scan, the sequential f32 recurrence of
    ``repro.models.hymba._ssm_scan`` without its projections.

    xs: (B, T, din); dt: (B, T); bb, cc: (B, T, n); a = -exp(A_log):
    (din, n); d: (din,); h0: (B, din, n); all taken in f32.  Per step, in
    JAX's order:

        h   = exp(a * dt_t) * h + (dt_t * x_t)[:, :, None] * b_t[:, None, :]
        y_t = sum_n h * c_t + d * x_t

    Returns ``(y (B, T, din) f32, h_T (B, din, n) f32)``."""
    xf, dtf, bf, cf = (t.float() for t in (xs, dt, bb, cc))
    af, df = a.float(), d.float()
    h = h0.float()
    ys = []
    for i in range(xf.shape[1]):
        x_t, dt_t = xf[:, i], dtf[:, i, None]                   # (B,din),(B,1)
        decay = torch.exp(af[None] * dt_t[:, :, None])           # (B,din,n)
        h = decay * h + (dt_t * x_t)[:, :, None] * bf[:, i, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, i]) + df * x_t)
    return torch.stack(ys, dim=1), h


def _segment_carries(af, dtf, cf, dyf, g_t, bounds):
    """The gradient ``g`` at the end of each segment of ``bounds`` ((t0,
    t1) step ranges, in order), from the carries over the segments after
    it: ``g_in(last) = g_t`` and ``g_in(s) = P(s+1) g_in(s+1) +
    g_loc(s+1)``, folded from the last segment down, where a segment's
    ``g_loc`` and ``P`` come from a walk of its steps from the last with a
    zero carry, ``g_loc <- e_t (g_loc + dy_t c_t)``, ``P <- P e_t`` (the
    kernel sums the same terms from the first step, ``P <- P e_t``,
    ``g_loc <- g_loc + P dy_t c_t``)."""
    carries = [g_t]
    for t0, t1 in reversed(bounds[1:]):
        g_loc, prod = torch.zeros_like(g_t), torch.ones_like(g_t)
        for i in reversed(range(t0, t1)):
            decay = torch.exp(af[None] * dtf[:, i, None, None])
            g_loc = decay * (g_loc + dyf[:, i, :, None] * cf[:, i, None, :])
            prod = prod * decay
        carries.append(prod * carries[-1] + g_loc)
    return carries[::-1]


def selective_scan_bwd(xs: torch.Tensor, dt: torch.Tensor, bb: torch.Tensor,
                       cc: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       h0: torch.Tensor, dy: torch.Tensor,
                       dh_t: Optional[torch.Tensor] = None, *,
                       ckpt_every: int = 64, segments: int = 1):
    """Gradients of :func:`selective_scan` by the backward kernel's
    formula, a plain reverse scan in f32, in the kernel's chunked order:
    the state at the start of every ``ckpt_every`` steps (the kernel's
    chunk) is kept from one forward pass (the forward kernel's
    checkpoints), and each chunk of that many steps, from
    the last, replays its states forward from its checkpoint and then
    walks back through them; no decay is ever divided out.  With
    ``e_t = exp(a dt_t)``, ``h_t`` the state after step t (``h_{t-1}``
    before it), ``g_T = dh_T`` (zeros when None) and

        G_t   = g_t + dy_t[:, None] c_t[None, :]      (din, n) per row
        dc_t  = sum_d dy_t[d] h_t[d, :]
        dD    = sum_{b,t} dy_t x_t
        dx_t  = D dy_t + dt_t sum_n G_t b_t
        db_t  = sum_d G_t dt_t x_t
        ddt_t = sum_{d,n} G_t (x_t b_t + a e_t h_{t-1})
        da    = sum_{b,t} G_t dt_t e_t h_{t-1}
        g_{t-1} = e_t G_t,        dh0 = g_0.

    ``segments``: the kernel's cut of T into segments of whole chunks,
    ``ceil(chunks / segments)`` chunks each (the last may hold fewer, and
    fewer segments may remain).  The recurrence of g is linear and
    diagonal in the state, and needs only dt, c and dy: unrolled over a
    segment of steps t0..t1 it is ``g_{t0-1} = P g_{t1} + g_loc`` with
    ``P = prod_t e_t`` and ``g_loc`` the walk of the segment from a zero
    carry.  So each segment but the first is first walked alone for its
    ``P`` and ``g_loc``; the carries into the segments follow in a fixed
    order from the last, ``g_in(last) = dh_T``, ``g_in(s) = P(s+1)
    g_in(s+1) + g_loc(s+1)`` (:func:`_segment_carries`); then each
    segment, from the last, runs the chunked walk above from its carry
    (its own g at its start is not carried on: the next segment starts
    from its ``g_in``), and dh0 is the first segment's.  ``segments=1``
    is the single walk, bit for bit.

    Shapes as :func:`selective_scan`; ``dy``: (B, T, din).  Returns
    ``(dxs, ddt, dbb, dcc, da, dd, dh0)`` in f32, with the shapes of
    ``xs, dt, bb, cc, a, d, h0``."""
    xf, dtf, bf, cf, dyf = (t.float() for t in (xs, dt, bb, cc, dy))
    af, df = a.float(), d.float()
    t_len = xf.shape[1]
    h = h0.float()
    ckpts = []
    for i in range(t_len):
        if i % ckpt_every == 0:
            ckpts.append(h)
        h = (torch.exp(af[None] * dtf[:, i, None, None]) * h
             + (dtf[:, i, None] * xf[:, i])[:, :, None] * bf[:, i, None, :])
    g_t = torch.zeros_like(h) if dh_t is None else dh_t.float()
    per = -(-len(ckpts) // max(1, segments))        # chunks a segment
    firsts = range(0, len(ckpts), per)              # each one's first chunk
    bounds = [(k * ckpt_every, min((k + per) * ckpt_every, t_len))
              for k in firsts]
    carries = _segment_carries(af, dtf, cf, dyf, g_t, bounds)
    dx, ddt, db, dc = (torch.empty_like(v) for v in (xf, dtf, bf, cf))
    da = torch.zeros_like(af)
    for first, g in reversed(list(zip(firsts, carries))):
        for k in reversed(range(first, min(first + per, len(ckpts)))):
            t0, t1 = k * ckpt_every, min((k + 1) * ckpt_every, t_len)
            hs = [ckpts[k]]                          # h_{t0-1} .. h_{t1-1}
            for i in range(t0, t1):
                decay = torch.exp(af[None] * dtf[:, i, None, None])
                hs.append(decay * hs[-1] + (dtf[:, i, None] * xf[:, i])
                          [:, :, None] * bf[:, i, None, :])
            for i in reversed(range(t0, t1)):
                h_prev, h_i = hs[i - t0], hs[i - t0 + 1]
                dt_i, x_i, b_i, dy_i = dtf[:, i], xf[:, i], bf[:, i], \
                    dyf[:, i]
                decay = torch.exp(af[None] * dt_i[:, None, None])
                gg = g + dy_i[:, :, None] * cf[:, i, None, :]      # G_t
                dc[:, i] = torch.einsum("bd,bdn->bn", dy_i, h_i)
                dx[:, i] = df * dy_i + dt_i[:, None] * torch.einsum(
                    "bdn,bn->bd", gg, b_i)
                db[:, i] = torch.einsum("bdn,bd->bn", gg,
                                        dt_i[:, None] * x_i)
                ehp = decay * h_prev
                ddt[:, i] = (gg * (x_i[:, :, None] * b_i[:, None, :]
                                   + af[None] * ehp)).sum(dim=(1, 2))
                da = da + (gg * dt_i[:, None, None] * ehp).sum(dim=0)
                g = decay * gg
    dd = (dyf * xf).sum(dim=(0, 1))
    return dx, ddt, db, dc, da, dd, g


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
