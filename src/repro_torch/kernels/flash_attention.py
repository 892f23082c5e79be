"""Flash attention forward and backward: the CUDA C++ kernels' wrappers.

Counterparts of ``repro.kernels.flash_attention.flash_attention_fwd``
(``_fwd_kernel``, in ``csrc/flash_attention_fwd.cu``) and
``flash_attention_bwd`` (``_dq_kernel`` and ``_dkv_kernel``, in
``csrc/flash_attention_bwd.cu``).  The forward takes every form of the
JAX kernel: non-causal (the DiT), causal and sliding-window masks with
right-aligned query positions, and grouped-query attention (the language
models).  So does the backward: the DiT trains through its non-causal
form, the language models through its causal GQA form.  ``dk`` and ``dv``
come back in the KV heads' layout, the group summed in f32 inside the
kernel (JAX sums per-query-head partials in its wrapper).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SIGNATURE = {"flash_attention_fwd":
                  ((_P,) * 5 + (_I,) * 7 + (_F, _I, _P), _I)}
_BWD_SIGNATURE = {
    "flash_attention_bwd_dq": ((_P,) * 7 + (_I,) * 7 + (_F, _I, _P), _I),
    "flash_attention_bwd_dkv": ((_P,) * 8 + (_I,) * 7 + (_F, _I, _P), _I)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
HEAD_DIM_MULTIPLE = 4


def _check(q, k, v, what: str) -> tuple:
    """Raise on what the kernels do not take; returns ``(head dim,
    group)``, the number of query heads per KV head."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected (BH, S, D) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"{bh} query heads do not group over "
                         f"{k.shape[0]} KV heads")
    if k.shape[2] != d:
        raise ValueError(f"head dims differ: q {d}, k {k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 operands of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % HEAD_DIM_MULTIPLE or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of "
                         f"{HEAD_DIM_MULTIPLE} and at most {MAX_HEAD_DIM}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what} launches the CUDA kernel: all operands "
                         f"must be on one CUDA device")
    if k.shape[1] == 0 and q.shape[1] > 0:
        raise ValueError("flash attention needs at least one key")
    return d, bh // k.shape[0]


def _check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int or None, "
                         f"got {window}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """q: (BH, Sq, D); k, v: (BKV, Sk, D) with BH a multiple of BKV
    (query head ``i`` reads KV head ``i // (BH // BKV)``), all on one CUDA
    device.  ``causal`` and ``window`` mask as :func:`ref.attention`, with
    query positions right-aligned to the keys.

    Returns ``(o (BH, Sq, D) in q's dtype, lse (BH, Sq) f32)``.  Launches
    the kernel once and counts it in ``flash_attention_fwd.launches``.
    """
    d, group = _check(q, k, v, "flash attention")
    _check_window(window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, sq, _ = q.shape
    sk = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    lib = _build.load("flash_attention_fwd", _FWD_SIGNATURE)
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, sk, d, group, int(causal),
            window or 0, scale, _DTYPES[q.dtype], _stream(q.device))
    _build.check(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """Gradients of flash attention: ``(dq (BH, Sq, D), dk, dv (BKV, Sk,
    D))``, in q's dtype, with ``causal`` and ``window`` as the forward
    took them.

    q, o, do: (BH, Sq, D); k, v: (BKV, Sk, D) with BH a multiple of BKV;
    lse: the forward's (BH, Sq) f32 logsumexp; all on one CUDA device.
    ``delta = rowsum(dO * O)`` is a plain f32 reduction here, outside the
    kernels, as the JAX version computes it outside its Pallas calls.
    Launches the dq kernel and the dkv kernel once each, counted in
    ``flash_attention_bwd_dq.launches`` and
    ``flash_attention_bwd_dkv.launches``.
    """
    d, _ = _check(q, k, v, "flash attention backward")
    _check_window(window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if do.dtype != q.dtype:
        raise TypeError(f"do is {do.dtype}, q is {q.dtype}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 of shape {tuple(q.shape[:2])}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if not all(t.device == q.device for t in (o, lse, do)):
        raise ValueError("flash attention backward: all operands must be on "
                         "one CUDA device")
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse = lse.contiguous()
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    delta = (do.float() * o.float()).sum(dim=-1)
    mask = dict(causal=causal, window=window)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, **mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, **mask)
    return dq, dk, dv


def _launch(fn: str, args, q: torch.Tensor, k: torch.Tensor, scale: float,
            causal: bool, window: Optional[int]) -> None:
    bh, sq, d = q.shape
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURE)
    with torch.cuda.device(q.device):
        code = getattr(lib, fn)(*(t.data_ptr() for t in args), bh, sq,
                                k.shape[1], d, bh // k.shape[0], int(causal),
                                window or 0, scale, _DTYPES[q.dtype],
                                _stream(q.device))
    _build.check(lib, code, fn)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float, *,
                           causal: bool = False,
                           window: Optional[int] = None):
    """dq (BH, Sq, D) from contiguous, checked operands: one launch of the
    dq kernel, counted in ``flash_attention_bwd_dq.launches``."""
    bh, sq, _ = q.shape
    dq = torch.empty_like(q)
    if bh and sq:
        _launch("flash_attention_bwd_dq", (q, k, v, do, lse, delta, dq), q, k,
                scale, causal, window)
        flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float, *,
                            causal: bool = False,
                            window: Optional[int] = None):
    """(dk, dv), each (BKV, Sk, D) with the GQA group summed, from
    contiguous, checked operands: one launch of the dkv kernel, counted
    in ``flash_attention_bwd_dkv.launches``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[0] and k.shape[1]:     # with Sq == 0 the kernel stores zeros
        _launch("flash_attention_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                q, k, scale, causal, window)
        flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0
