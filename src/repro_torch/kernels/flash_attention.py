"""Flash attention forward: the CUDA C++ kernel's wrapper.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``
(``_fwd_kernel``).  The kernel (``csrc/flash_attention_fwd.cu``) takes the
non-causal, ``window=None``, one-KV-head-per-query-head form the DiT runs;
the causal, sliding-window and GQA forms raise ``NotImplementedError``
until the LLM zoo needs them (ROADMAP B3).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {"flash_attention_fwd":
              ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
HEAD_DIM_MULTIPLE = 4


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """q: (BH, Sq, D); k, v: (BKV, Sk, D), all on one CUDA device.

    Returns ``(o (BH, Sq, D) in q's dtype, lse (BH, Sq) f32)``.  Launches
    the kernel once and counts it in ``flash_attention_fwd.launches``.
    """
    if causal or window is not None:
        raise NotImplementedError("causal / sliding-window flash attention is "
                                  "not ported yet (ROADMAP B3)")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected (BH, S, D) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, d = q.shape
    if k.shape[0] != bh:
        raise NotImplementedError("grouped-query flash attention is not "
                                  "ported yet (ROADMAP B3)")
    if k.shape[2] != d:
        raise ValueError(f"head dims differ: q {d}, k {k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 operands "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % HEAD_DIM_MULTIPLE or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of "
                         f"{HEAD_DIM_MULTIPLE} and at most {MAX_HEAD_DIM}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd launches the CUDA kernel: "
                         "all operands must be on one CUDA device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sk = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    if sk == 0:
        raise ValueError("flash attention needs at least one key")
    lib = _build.load("flash_attention_fwd", _SIGNATURE)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, sk, d, scale, _DTYPES[q.dtype], stream)
    _build.check(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
