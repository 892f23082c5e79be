"""Fused elementwise Triton kernels for the sampler's inner loop.

Counterparts of ``repro.kernels.elementwise``'s ``_ddim_kernel`` and
``_parareal_resid_kernel``.  Both are one memory-bound pass over flat
contiguous tensors: masked loads cover the ragged tail, so the TPU's
``(rows, 128)`` padding is not needed.  Bound: bytes (each input read
once, the output written once); at the DiT's latents one pass moves a few
MB, under a microsecond of HBM time, so launch latency dominates.

Triton is imported inside the launching functions only, so the module
imports on machines without it; the wrappers take CUDA tensors (the ops
layer sends CPU tensors to :mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import math
import os
from typing import Dict

import torch

from ._build import BUILD_DIR

DDIM_BLOCK = 1024        # elements per program
RESID_BLOCK = 1024       # elements per residual tile (one partial each)
PARTIALS_BLOCK = 128     # partials summed per step of the fixed-order sum
PARTIALS_NUM_WARPS = 1
NUM_WARPS = 4
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_kernels: Dict[str, object] = {}


def _triton_kernels():
    """JIT-define the kernels on first use (needs the ``triton`` package)."""
    if _kernels:
        return _kernels
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def ddim_kernel(x_ptr, e_ptr, a_ptr, b_ptr, o_ptr, n_total, n_row,
                    coef_stride, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_total
        row = (offs // n_row) * coef_stride
        a = tl.load(a_ptr + row, mask=mask, other=1.0)
        b = tl.load(b_ptr + row, mask=mask, other=1.0)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        e = tl.load(e_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x0 = (x - tl.sqrt(1.0 - a) * e) / tl.sqrt(a)
        out = tl.sqrt(b) * x0 + tl.sqrt(1.0 - b) * e
        tl.store(o_ptr + offs, out.to(o_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def resid_kernel(y_ptr, c_ptr, p_ptr, x_ptr, o_ptr, part_ptr, n_slice,
                     tiles, BLOCK: tl.constexpr):
        # program (t, s): tile t of slice s; tiles never straddle slices
        t = tl.program_id(0)
        s = tl.program_id(1)
        offs = t * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_slice
        base = s.to(tl.int64) * n_slice
        y = tl.load(y_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        c = tl.load(c_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(p_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        xo = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        out = y + c - p
        tl.store(o_ptr + base + offs, out.to(o_ptr.dtype.element_ty),
                 mask=mask)
        d = tl.where(mask, tl.abs(out - xo), 0.0)
        tl.store(part_ptr + s.to(tl.int64) * tiles + t, tl.sum(d, axis=0))

    @triton.jit
    def sum_partials_kernel(part_ptr, out_ptr, tiles, BLOCK: tl.constexpr):
        # one program per slice, walking its partials in a fixed order
        s = tl.program_id(0)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for t0 in range(0, tiles, BLOCK):
            offs = t0 + tl.arange(0, BLOCK)
            acc += tl.load(part_ptr + s.to(tl.int64) * tiles + offs,
                           mask=offs < tiles, other=0.0)
        tl.store(out_ptr + s, tl.sum(acc, axis=0))

    _kernels.update(ddim=ddim_kernel, resid=resid_kernel,
                    sum_partials=sum_partials_kernel)
    return _kernels


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches a Triton kernel: CUDA tensors only")
    for t in ts:
        if t.device != dev or t.dtype != ts[0].dtype or t.shape != ts[0].shape:
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             f"shape")
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {ts[0].dtype} not supported")


def ddim_fused(x: torch.Tensor, eps: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """``sqrt(b)*(x - sqrt(1-a) eps)/sqrt(a) + sqrt(1-b) eps`` in f32.

    ``a``/``b`` are f32 CUDA tensors of shape () or per row ``(M,)`` over
    x's leading axis.  Counts each launch in ``ddim_fused.launches``.
    """
    _check("ddim_fused", x, eps)
    m = x.shape[0] if x.dim() else 1
    per_row = a.dim() == 1
    if a.shape != b.shape or a.dim() > 1 or (per_row and a.shape[0] != m):
        raise ValueError(f"coefficients must be () or ({m},), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    x, eps = x.contiguous(), eps.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    kern = _triton_kernels()["ddim"]
    with torch.cuda.device(x.device):
        kern[(math.ceil(n / DDIM_BLOCK),)](
            x, eps, a, b, out, n, max(n // m, 1), 1 if per_row else 0,
            BLOCK=DDIM_BLOCK, num_warps=NUM_WARPS)
    ddim_fused.launches += 1
    return out


ddim_fused.launches = 0


def parareal_update_residual(y: torch.Tensor, cur: torch.Tensor,
                             prev: torch.Tensor, old: torch.Tensor, *,
                             batch_dims: int = 0):
    """``out = y + cur - prev`` (rounded once from f32) and the f32 L1 sum
    ``|out - old|`` per slice of the ``batch_dims`` preserved leading axes.

    The update kernel writes one f32 partial per tile, tiles never
    straddling two slices; a second small kernel sums each slice's
    partials in a fixed order.  No float atomics, so a slice's residual is
    bitwise the same whatever other slices ride in the batch.  Counts each
    call in ``parareal_update_residual.launches``.
    """
    _check("parareal_update_residual", y, cur, prev, old)
    nd = int(batch_dims)
    if not 0 <= nd <= y.dim():
        raise ValueError(f"batch_dims={nd} out of range for ndim={y.dim()}")
    lead = y.shape[:nd]
    slices = math.prod(lead)
    y, cur, prev, old = (t.contiguous() for t in (y, cur, prev, old))
    out = torch.empty_like(y)
    n_slice = y.numel() // slices if slices else 0
    if n_slice == 0:
        return out, torch.zeros(lead, dtype=torch.float32, device=y.device)
    resid = torch.empty(slices, dtype=torch.float32, device=y.device)
    tiles = math.ceil(n_slice / RESID_BLOCK)
    partials = torch.empty((slices, tiles), dtype=torch.float32,
                           device=y.device)
    ks = _triton_kernels()
    with torch.cuda.device(y.device):
        ks["resid"][(tiles, slices)](y, cur, prev, old, out, partials,
                                     n_slice, tiles, BLOCK=RESID_BLOCK,
                                     num_warps=NUM_WARPS)
        ks["sum_partials"][(slices,)](partials, resid, tiles,
                                      BLOCK=PARTIALS_BLOCK,
                                      num_warps=PARTIALS_NUM_WARPS)
    parareal_update_residual.launches += 1
    return out, resid.reshape(lead)


parareal_update_residual.launches = 0
