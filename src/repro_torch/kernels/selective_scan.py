"""Hymba's selective scan, forward: the CUDA C++ kernel's wrapper.

The kernel (``csrc/selective_scan.cu``) replaces no Pallas kernel: the
JAX model runs the recurrence as a ``jax.lax.scan`` inside
``repro.models.hymba._ssm_scan``, one device loop under XLA, which eager
PyTorch could only run as a Python loop of small launches.  A lane owns
one (channel, state) element of the f32 state and carries it through all
T steps; a channel's lanes sum y_t by warp shuffles, and a block stages
32 steps of the row's dt, B and C and of its channels' x in shared memory
(see the source).  One launch a call, T = 1 (a decode step) included;
two runs are bitwise equal.

The launch geometry is computed here (:func:`geometry`), so the CPU tests
reach it.  ``xs`` is read in place through its batch and time strides
(the model's ``xs`` is the second half of the ``x @ w_in`` product, a
strided view); its channel stride must be 1, or it is copied.  The other
operands are made contiguous.  No gradient: a training path needs the
scan's backward kernel (ROADMAP A11(a), training half).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

THREADS = 256            # a block (the kernel's kThreads)
MIN_LANES = 4            # lanes a channel at the least: at most 64 channels
MAX_STATE = 32           # a channel's lanes lie in one warp

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {"selective_scan_fwd": ((_P, _L, _L) + (_P,) * 8 + (_I,) * 5
                                     + (_P,), _I),
              "selective_scan_threads": ((), _I)}


def _lib() -> ctypes.CDLL:
    return _build.load("selective_scan", _SIGNATURE)


def geometry(batch: int, din: int, n: int) -> Tuple[int, int, tuple]:
    """``(lanes a channel, channels a block, grid)`` of the launch for
    state size ``n``: lanes the power of two >= n (at least
    :data:`MIN_LANES`), ``THREADS // lanes`` channels a block, grid
    ``(ceil(din / channels), batch)``."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the selective scan takes 1 <= n <= {MAX_STATE}, "
                         f"got {n}")
    lanes = MIN_LANES
    while lanes < n:
        lanes *= 2
    channels = THREADS // lanes
    return lanes, channels, (-(-din // channels), batch)


def _check(xs, dt, bb, cc, a, d, h0) -> None:
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, T, din), got {tuple(xs.shape)}")
    b, t, din = xs.shape
    n = a.shape[-1]
    want = {"dt": (b, t), "bb": (b, t, n), "cc": (b, t, n), "a": (din, n),
            "d": (din,), "h0": (b, din, n)}
    for name, x in (("dt", dt), ("bb", bb), ("cc", cc), ("a", a), ("d", d),
                    ("h0", h0)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} {tuple(x.shape)} does not fit xs "
                             f"{tuple(xs.shape)}: want {want[name]}")
    ts = (xs, dt, bb, cc, a, d, h0)
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError("the selective scan takes f32 operands, got "
                        + ", ".join(str(x.dtype) for x in ts))
    if not (xs.is_cuda and all(x.device == xs.device for x in ts)):
        raise ValueError("selective_scan launches the CUDA kernel: all "
                         "operands must be on one CUDA device")
    if t < 1 or b < 1 or din < 1:
        raise ValueError(f"empty scan: B {b}, T {t}, din {din}")


def selective_scan(xs: torch.Tensor, dt: torch.Tensor, bb: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor):
    """xs: (B, T, din); dt: (B, T); bb, cc: (B, T, n); a: (din, n); d:
    (din,); h0: (B, din, n); all f32 on one CUDA device.  Returns ``(y
    (B, T, din), h_T (B, din, n))``, both f32, with the semantics of
    :func:`repro_torch.kernels.ref.selective_scan`.  Launches the kernel
    once and counts it in ``selective_scan.launches``."""
    _check(xs, dt, bb, cc, a, d, h0)
    b, t, din = xs.shape
    n = a.shape[-1]
    lanes, _, _ = geometry(b, din, n)
    if xs.stride(-1) != 1:
        xs = xs.contiguous()
    dt, bb, cc, a, d, h0 = (x.contiguous() for x in (dt, bb, cc, a, d, h0))
    y = torch.empty((b, t, din), dtype=torch.float32, device=xs.device)
    h_t = torch.empty((b, din, n), dtype=torch.float32, device=xs.device)
    lib = _lib()
    with torch.cuda.device(xs.device):
        code = lib.selective_scan_fwd(
            xs.data_ptr(), xs.stride(0), xs.stride(1), dt.data_ptr(),
            bb.data_ptr(), cc.data_ptr(), a.data_ptr(), d.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), b, t, din, n, lanes,
            torch.cuda.current_stream(xs.device).cuda_stream)
    _build.check(lib, code, "selective_scan")
    selective_scan.launches += 1
    return y, h_t


selective_scan.launches = 0


def kernel_threads() -> int:
    """The kernel's block size as compiled (must equal :data:`THREADS`).
    Needs the card."""
    return _lib().selective_scan_threads()
