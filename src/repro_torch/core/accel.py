"""Fixed-point acceleration for Parareal refinement (counterpart of
``repro.core.accel``): the one home of Anderson/triangular mixing math.

SRDS's refinement is a fixed-point iteration ``z_{p+1} = T(z_p)`` over
the joint state ``z = stack([x_tail, prev_coarse])``.  An
:class:`Accelerator` extrapolates over the iterate history the loop
already carries, at zero extra model evals:

``NoAccel``
    The default: no mixing, no loop carry (``RefineState.accel`` stays
    ``None``); bit-exact.
``AndersonAccel(depth=m)``
    Type-II Anderson mixing over the last ``m`` iterate/residual
    differences, per sample, through regularized ``m x m`` normal
    equations in f32.  Approximate and opt-in: the fixed point is the
    same, the iterates are not.
``TriangularAccel``
    Prefix-exact: only the not-yet-exact ``x_tail`` suffix mixes
    (blocks ``<= count + 1`` and all of ``prev_coarse`` commit the raw
    iterate), so it composes with ``ExactPrefix`` truncation.

Where the JAX package ``vmap``s one lane's mixing over the sample axis,
this module folds the lanes into a leading axis and writes every
reduction per lane (a lane's sums run over its own row), so each lane's
gamma is the one a single-lane run computes.  The normal equations are
solved with ``torch.linalg.solve_ex``, which does not read its status
back to the host.  Wherever a driver freezes content (truncated prefix,
window-masked blocks, gate-masked lanes) ``z_new == z_prev``, so ``f = 0``
and the ``live`` mask keeps the committed value bitwise ``z_prev``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = ["AccelState", "Accelerator", "NoAccel", "AndersonAccel",
           "TriangularAccel", "resolve_accel"]


class AccelState(NamedTuple):
    """Loop carry of an accelerating :class:`Accelerator` (the layout of
    ``repro.core.accel.AccelState``): ``z`` is ``(2, B, [K,] ...)`` and the
    rings hold its last ``m`` differences, newest last."""
    dz: torch.Tensor      # (m, 2, B, [K,] ...) iterate-difference ring
    df: torch.Tensor      # (m, 2, B, [K,] ...) residual-difference ring
    z_last: torch.Tensor  # (2, B, [K,] ...) previous apply's input iterate
    f_last: torch.Tensor  # (2, B, [K,] ...) previous apply's residual
    count: torch.Tensor   # int32 () or (K,): mixing steps applied so far


def _lanes(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-lane ``(L,)`` or ``(L, X)`` tensor reshaped to broadcast
    against an ``ndim``-dimensional lane-first tensor."""
    return t.reshape(t.shape + (1,) * (ndim - t.dim()))


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """The fixed-point-acceleration seam.  ``accelerates``: whether
    :meth:`apply` mixes at all (an accelerating subclass defines
    ``_mix(s, z_prev, z_new, f, dz_u, df_u)``).  ``exact``: results equal
    the unaccelerated engine's.  ``prefix_exact``: mixing preserves the
    serial-prefix invariant that truncating frontier policies rely on."""

    name = "accel"
    accelerates = False
    exact = True
    prefix_exact = True

    def history_depth(self, max_iters: int) -> int:
        return 0

    def init_state(self, z: torch.Tensor, max_iters: int,
                   batched: bool = False) -> Optional[AccelState]:
        """Fresh carry for a joint iterate shaped like ``z``; ``None``
        when not accelerating."""
        if not self.accelerates:
            return None
        m = self.history_depth(max_iters)
        ring = torch.zeros((m,) + z.shape, dtype=z.dtype, device=z.device)
        kd = (z.shape[2],) if batched else ()
        count = torch.zeros(kd, dtype=torch.int32, device=z.device)
        return AccelState(ring, ring.clone(), torch.zeros_like(z),
                          torch.zeros_like(z), count)

    def reset_lanes(self, state: Optional[AccelState],
                    new_mask: torch.Tensor) -> Optional[AccelState]:
        """Zero the history of newly (re)admitted lanes; ``new_mask`` is
        bool ``(K,)`` over the sample axis."""
        if state is None:
            return None
        ring_m = new_mask.reshape((1, 1, 1) + new_mask.shape
                                  + (1,) * (state.dz.dim() - 4))
        z_m = new_mask.reshape((1, 1) + new_mask.shape
                               + (1,) * (state.z_last.dim() - 3))
        return AccelState(state.dz.masked_fill(ring_m, 0),
                          state.df.masked_fill(ring_m, 0),
                          state.z_last.masked_fill(z_m, 0),
                          state.f_last.masked_fill(z_m, 0),
                          state.count.masked_fill(new_mask, 0))

    def apply(self, state: Optional[AccelState], z_prev: torch.Tensor,
              z_new: torch.Tensor, *, live=None, batched: bool = False):
        """One mixing step: ``(z_mixed, new_state)`` from the
        pre-refinement iterate ``z_prev`` and the refinement's output
        ``z_new``.  ``live`` (bool ``(B,)``, or ``(B, K)`` per sample)
        limits mixing to the active window.  With ``batched`` the sample
        axis sits at position 2 of ``z`` and each sample mixes alone."""
        if not self.accelerates:
            return z_new, state
        if batched:
            k = z_prev.shape[2]
            lane = AccelState(state.dz.movedim(3, 0), state.df.movedim(3, 0),
                              state.z_last.movedim(2, 0),
                              state.f_last.movedim(2, 0), state.count)
            lv = None if live is None else (
                live.t() if live.dim() == 2 else live.expand(k, -1))
            z_mix, s = self._apply_lanes(lane, z_prev.movedim(2, 0),
                                         z_new.movedim(2, 0), lv)
            return z_mix.movedim(0, 2), AccelState(
                s.dz.movedim(0, 3), s.df.movedim(0, 3),
                s.z_last.movedim(0, 2), s.f_last.movedim(0, 2), s.count)
        lane = AccelState(state.dz[None], state.df[None], state.z_last[None],
                          state.f_last[None], state.count.reshape(1))
        z_mix, s = self._apply_lanes(lane, z_prev[None], z_new[None],
                                     None if live is None else live[None])
        return z_mix[0], AccelState(s.dz[0], s.df[0], s.z_last[0],
                                    s.f_last[0], s.count[0])

    def _apply_lanes(self, s: AccelState, z_prev: torch.Tensor,
                     z_new: torch.Tensor, live):
        """:meth:`apply` with the L lanes leading every tensor: ``z`` is
        ``(L, 2, B, ...)``, the rings ``(L, m, 2, B, ...)``, ``count``
        ``(L,)`` and ``live`` ``(L, B)``."""
        nd = z_prev.dim()
        f = z_new - z_prev
        lm = None
        if live is not None:
            lm = live.reshape(live.shape[:1] + (1,) + live.shape[1:]
                              + (1,) * (nd - 3))
            f = torch.where(lm, f, torch.zeros_like(f))
        m = s.dz.shape[1]
        # the first apply has no (z_last, f_last) pair: the rings stay zero
        push = _lanes(s.count >= 1, nd + 1)
        dz = torch.where(push, torch.cat([s.dz[:, 1:],
                                          (z_prev - s.z_last)[:, None]], 1),
                         s.dz)
        df = torch.where(push, torch.cat([s.df[:, 1:],
                                          (f - s.f_last)[:, None]], 1), s.df)
        # columns valid so far, newest last
        ar = torch.arange(m, device=z_prev.device)
        valid = ar >= m - torch.clamp(s.count, max=m)[:, None]
        valid = _lanes(valid.to(f.dtype), nd + 1)
        dz_u, df_u = dz * valid, df * valid
        if lm is not None:
            dz_u = torch.where(lm[:, None], dz_u, torch.zeros_like(dz_u))
            df_u = torch.where(lm[:, None], df_u, torch.zeros_like(df_u))
        # protected entries commit the raw iterate and stay out of the
        # secant system
        pm = self._protect_mask(s, z_prev)
        f_mix = f
        if pm is not None:
            f_mix = torch.where(pm, f, torch.zeros_like(f))
            dz_u = torch.where(pm[:, None], dz_u, torch.zeros_like(dz_u))
            df_u = torch.where(pm[:, None], df_u, torch.zeros_like(df_u))
        z_mixed = self._mix(s, z_prev, z_new, f_mix, dz_u, df_u)
        if pm is not None:
            z_mixed = torch.where(pm, z_mixed, z_new)
        if lm is not None:
            z_mixed = torch.where(lm, z_mixed, z_prev)
        return z_mixed, AccelState(dz, df, z_prev, f, s.count + 1)

    def _protect_mask(self, s: AccelState, z_prev: torch.Tensor):
        """Optional bool mask over the lane-first iterate: True where
        mixing may apply.  ``None`` mixes everywhere."""
        return None

    def _solve_gamma(self, f: torch.Tensor, df_u: torch.Tensor,
                     reg: float) -> torch.Tensor:
        """Type-II AA coefficients ``(L, m)``: per lane, the regularized
        normal equations ``(Gm + lam I) gamma = <df_i, f>`` in f32 over
        unit-normalized columns (zero columns give gamma = 0)."""
        lanes, m = df_u.shape[:2]
        cols = df_u.reshape(lanes, m, -1).float()
        nrm = torch.sqrt((cols * cols).sum(-1, keepdim=True))
        scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        colsn = cols / scale
        gm = (colsn[:, :, None, :] * colsn[:, None, :, :]).sum(-1)
        rhs = (colsn * f.reshape(lanes, 1, -1).float()).sum(-1)
        lam = reg * (gm.diagonal(dim1=-2, dim2=-1).sum(-1) / m) + 1e-30
        eye = torch.eye(m, dtype=torch.float32, device=f.device)
        gamma, _ = torch.linalg.solve_ex(gm + lam[:, None, None] * eye, rhs)
        return gamma / scale[..., 0]


@dataclasses.dataclass(frozen=True)
class NoAccel(Accelerator):
    """No mixing and no loop carry (the default everywhere)."""

    name = "no_accel"
    accelerates = False
    exact = True


@dataclasses.dataclass(frozen=True)
class AndersonAccel(Accelerator):
    """Sliding-window type-II Anderson mixing.  ``depth``: history window
    ``m``.  ``warmup``: refinements that commit the raw iterate first
    (the rings keep recording).  ``reg``: Tikhonov term relative to
    ``trace(G)/m``.  ``damping``: the AA beta (1.0 undamped)."""

    depth: int = 2
    warmup: int = 3
    reg: float = 1e-8
    damping: float = 1.0

    name = "anderson"
    accelerates = True
    exact = False
    prefix_exact = False

    def history_depth(self, max_iters: int) -> int:
        return max(1, min(int(self.depth), int(max_iters)))

    def _mix(self, s, z_prev, z_new, f, dz_u, df_u):
        gamma = self._solve_gamma(f, df_u, self.reg)
        beta = float(self.damping)
        hist = (dz_u + beta * df_u).float()
        corr = beta * f.float() - (_lanes(gamma, hist.dim()) * hist).sum(1)
        mixed = z_prev + corr.to(z_prev.dtype)
        return torch.where(_lanes(s.count < self.warmup, z_prev.dim()),
                           z_new, mixed)


@dataclasses.dataclass(frozen=True)
class TriangularAccel(AndersonAccel):
    """Prefix-exact triangular Anderson mixing (ParaTAA-inspired): the
    ``x_tail`` blocks ``<= count + 1`` and the whole ``prev_coarse``
    component commit the raw iterate, so the protected prefix stays the
    serial solve's and a capped run returns the serial result."""

    name = "triangular"
    accelerates = True
    exact = False
    prefix_exact = True

    def _protect_mask(self, s, z_prev):
        nd = z_prev.dim()
        b = z_prev.shape[2]
        dev = z_prev.device
        idx = torch.arange(b, dtype=torch.int32, device=dev).reshape(
            (1, 1, b) + (1,) * (nd - 3))
        comp = torch.arange(2, dtype=torch.int32, device=dev).reshape(
            (1, 2) + (1,) * (nd - 2))
        return (comp == 0) & (idx > _lanes(s.count, nd) + 1)


def resolve_accel(accel) -> Accelerator:
    """``None`` means :class:`NoAccel`; anything else must be an
    :class:`Accelerator`."""
    if accel is None:
        return NoAccel()
    if not isinstance(accel, Accelerator):
        raise TypeError(f"accel must be an Accelerator, got "
                        f"{type(accel).__name__}")
    return accel
