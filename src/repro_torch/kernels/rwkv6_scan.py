"""RWKV6 WKV recurrence, forward: the CUDA C++ kernel's wrapper.

Counterpart of ``repro.kernels.rwkv6_scan.rwkv6_wkv_pallas`` (TPU body
``_wkv_kernel``), in ``csrc/rwkv6_wkv.cu``: one block per batch x head
carries the f32 (Dk, Dv) state across all T steps, one thread per state
column.  Like the JAX kernel it is the sequential recurrence (the
chunked-parallel form's decay ratios overflow f32).  The backward is not
ported: language-model training (ROADMAP B5's slice) brings it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = {"rwkv6_wkv_fwd": ((_P,) * 8 + (_I,) * 6 + (_P,), _I)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DK = 64
MAX_DV = 128


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k, w must share a (B, H, T, Dk) shape, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if v.shape != (b, h, t, dv) or u.shape != (h, dk) or \
            s0.shape != (b, h, dk, dv):
        raise ValueError(f"v {tuple(v.shape)}, u {tuple(u.shape)} or state "
                         f"{tuple(s0.shape)} do not fit r {tuple(r.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must be float32 or bfloat16 of one dtype, "
                        f"got {r.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= dk <= MAX_DK or not 1 <= dv <= MAX_DV or t < 1:
        raise ValueError(f"the kernel takes 1 <= Dk <= {MAX_DK}, "
                         f"1 <= Dv <= {MAX_DV} and T >= 1, got Dk {dk}, "
                         f"Dv {dv}, T {t}")
    if not (r.is_cuda and all(x.device == r.device
                              for x in (k, v, w, u, s0))):
        raise ValueError("rwkv6_wkv launches the CUDA kernel: all operands "
                         "must be on one CUDA device")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, w: (B, H, T, Dk); v: (B, H, T, Dv); u: (H, Dk); s0:
    (B, H, Dk, Dv), all on one CUDA device.  r, k and v share a dtype
    (f32 or bf16); w, u and s0 are taken in f32 (the model's decay logits,
    bonus and state are f32).

    Returns ``(out (B, H, T, Dv) in v's dtype, final state f32)``.
    Launches the kernel once and counts it in ``rwkv6_wkv.launches``.
    """
    _check(r, k, v, w, u, s0)
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w, u, s0 = (x.float().contiguous() for x in (w, u, s0))
    out = torch.empty_like(v)
    s_t = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    if b == 0:
        return out, s_t
    lib = _build.load("rwkv6_wkv", _SIGNATURE)
    with torch.cuda.device(r.device):
        code = lib.rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_t.data_ptr(),
            b * h, t, h, dk, dv, _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_wkv")
    rwkv6_wkv.launches += 1
    return out, s_t


rwkv6_wkv.launches = 0
