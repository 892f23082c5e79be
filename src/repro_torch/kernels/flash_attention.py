"""Flash attention forward and backward: the CUDA C++ kernels' wrappers.

Counterparts of ``repro.kernels.flash_attention.flash_attention_fwd``
(``_fwd_kernel``, in ``csrc/flash_attention_fwd.cu``) and
``flash_attention_bwd`` (``_dq_kernel`` and ``_dkv_kernel``, in
``csrc/flash_attention_bwd.cu``).  Each direction has two routes: bf16
with a head dim that is a multiple of 8 runs on the tensor cores (wgmma
fed by a TMA ring, P, and in the backward dS, written as bf16 terms so
the products keep f32 precision); f32 and other bf16 head dims run on the
f32 FMA units.  Both take every form of the JAX kernels: non-causal (the
DiT), causal and sliding-window masks with right-aligned query positions,
and grouped-query attention (the language models).  ``dk`` and ``dv``
come back in the KV heads' layout, the group summed in f32 inside the
kernel (JAX sums per-query-head partials in its wrapper).

The tensor-core kernels' ring (keys or rows a tile and stages) are build
knobs of the tuning seam (:mod:`repro_torch.kernels.tuning`, family
``flash``, keyed by the dtype and ``(Sq, Sk, D)``): a call loads the
library built with its config's defines (:func:`launch_geometry` shows
the routing without launching).
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Optional

import torch

from . import _build, tuning

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SIGNATURE = {
    "flash_attention_fwd": ((_P,) * 5 + (_I,) * 7 + (_F, _I, _P), _I),
    "flash_attention_fwd_terms": ((_P,) * 5 + (_I,) * 7 + (_F, _I, _P), _I),
    "flash_attention_fwd_route": ((_I, _I), _I)}
ROUTES = {1: "tc", 0: "simt"}      # each direction's kernels, by C route code


def _tc_terms(source: str, constant: str) -> int:
    """A term count of a tensor-core kernel, read from ``csrc/<source>.cu``
    (no build needed)."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {constant} = (\d+);",
                         src).group(1))


TC_TERMS = _tc_terms("flash_attention_fwd", "kTcTerms")        # P, forward
BWD_TC_TERMS = _tc_terms("flash_attention_bwd", "kBwdTerms")   # P and dS

_BWD_SIGNATURE = {
    "flash_attention_bwd_dq": ((_P,) * 7 + (_I,) * 7 + (_F, _I, _P), _I),
    "flash_attention_bwd_dkv": ((_P,) * 8 + (_I,) * 7 + (_F, _I, _P), _I),
    "flash_attention_bwd_terms": ((_P,) * 9 + (_I,) * 7 + (_F, _I, _P), _I),
    "flash_attention_bwd_route": ((_I, _I), _I)}
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


def _defines(tuner, q, sk: int, source: str) -> tuple:
    """The ``-D`` defines of ``source`` that ``tuner`` resolves for a call
    on ``q`` (BH, Sq, D) against ``sk`` keys."""
    cfg = tuning.config("flash", tuner, q.device, q.dtype,
                        (q.shape[1], sk, q.shape[2]))
    return tuning.defines("flash", cfg.params, source)


def launch_geometry(sq: int, sk: int, d: int, dtype: torch.dtype, *,
                    tuner: Optional[tuning.KernelTuner] = None,
                    device="cpu") -> dict:
    """What the flash kernels would build and launch for Sq queries, Sk
    keys and head dim ``d`` of ``dtype`` on ``device``, resolved through
    ``tuner`` (the process tuner when None), without launching:
    ``config`` and each source's ``defines`` (``fwd_defines``,
    ``bwd_defines``: its library's build)."""
    cfg = tuning.config("flash", tuner, torch.device(device), dtype,
                        (sq, sk, d))
    return dict(config=cfg,
                fwd_defines=tuning.defines("flash", cfg.params,
                                           "flash_attention_fwd"),
                bwd_defines=tuning.defines("flash", cfg.params,
                                           "flash_attention_bwd"))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it, starting on a 16-byte boundary (TMA's)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_args(q, k, v, causal, window, scale):
    """Checked, contiguous operands and the outputs of one forward."""
    d, group = _check(q, k, v, "flash attention")
    _check_window(window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return q, k, v, o, lse, group, scale


def _fwd_launch(fn, q, k, v, o, lse, group, causal, window, scale, mode,
                tc, defines=()):
    """One launch of C function ``fn`` of the build with ``defines``;
    ``mode`` is its dtype code or, for the terms entry point, the term
    count; ``tc``: the tensor-core route."""
    bh, sq, d = q.shape
    if tc:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = _build.load("flash_attention_fwd", _FWD_SIGNATURE, defines)
    with torch.cuda.device(q.device):
        code = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, k.shape[1], d, group, int(causal),
            window or 0, scale, mode, _stream(q.device))
    _build.check(lib, code, fn)


def fwd_route(dtype: torch.dtype, d: int, defines: tuple = ()) -> str:
    """The kernel :func:`flash_attention_fwd` launches for ``dtype`` and
    head dim ``d``: ``"tc"`` (tensor cores: bf16, ``d % 8 == 0``) or
    ``"simt"`` (f32 FMA units), as the C entry point (of the build with
    ``defines``) decides."""
    lib = _build.load("flash_attention_fwd", _FWD_SIGNATURE, defines)
    return ROUTES[lib.flash_attention_fwd_route(_DTYPES[dtype], d)]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        tuner: Optional[tuning.KernelTuner] = None):
    """q: (BH, Sq, D); k, v: (BKV, Sk, D) with BH a multiple of BKV
    (query head ``i`` reads KV head ``i // (BH // BKV)``), all on one CUDA
    device.  ``causal`` and ``window`` mask as :func:`ref.attention`, with
    query positions right-aligned to the keys.

    Returns ``(o (BH, Sq, D) in q's dtype, lse (BH, Sq) f32)``.  Launches
    one kernel of the build ``tuner`` resolves, counted in
    ``flash_attention_fwd.launches`` and by its route (:func:`fwd_route`)
    in ``flash_attention_fwd.route_launches``.
    """
    q, k, v, o, lse, group, scale = _fwd_args(q, k, v, causal, window,
                                              scale)
    if q.shape[0] == 0 or q.shape[1] == 0:
        return o, lse
    defines = _defines(tuner, q, k.shape[1], "flash_attention_fwd")
    route = fwd_route(q.dtype, q.shape[2], defines)
    _fwd_launch("flash_attention_fwd", q, k, v, o, lse, group, causal,
                window, scale, _DTYPES[q.dtype], route == "tc", defines)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.route_launches[route] += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(ROUTES.values(), 0)


def flash_attention_fwd_terms(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, terms: int, *,
                              causal: bool = False,
                              window: Optional[int] = None,
                              scale: Optional[float] = None):
    """The tensor-core kernel with P written as ``terms`` bf16 terms, for
    bf16 operands with a head dim that is a multiple of 8: :data:`TC_TERMS`
    is :func:`flash_attention_fwd`'s; 1 and 2 exist for head dims 65-80 and
    113-128 only, as controls of the numerics (P rounded once to bf16 must
    miss the forward's limits).  No model's path calls it."""
    if q.dtype != torch.bfloat16 or q.shape[-1] % 8:
        raise ValueError("the tensor-core kernel takes bf16 operands with a "
                         "head dim that is a multiple of 8")
    q, k, v, o, lse, group, scale = _fwd_args(q, k, v, causal, window,
                                              scale)
    if q.shape[0] and q.shape[1]:
        _fwd_launch("flash_attention_fwd_terms", q, k, v, o, lse, group,
                    causal, window, scale, int(terms), True)
    return o, lse


def _bwd_args(q, k, v, o, lse, do, window, scale):
    """Checked, contiguous operands of one backward, its scale and
    ``delta = rowsum(dO * O)`` (f32)."""
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
    return q, k, v, do, lse, delta, scale


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        tuner: Optional[tuning.KernelTuner] = None):
    """Gradients of flash attention: ``(dq (BH, Sq, D), dk, dv (BKV, Sk,
    D))``, in q's dtype, with ``causal`` and ``window`` as the forward
    took them, from the build ``tuner`` resolves.

    q, o, do: (BH, Sq, D); k, v: (BKV, Sk, D) with BH a multiple of BKV;
    lse: the forward's (BH, Sq) f32 logsumexp; all on one CUDA device.
    ``delta = rowsum(dO * O)`` is a plain f32 reduction here, outside the
    kernels, as the JAX version computes it outside its Pallas calls.
    Launches the dq kernel and the dkv kernel once each, counted in
    ``flash_attention_bwd_dq.launches`` and
    ``flash_attention_bwd_dkv.launches`` and by their route
    (:func:`bwd_route`) in their ``route_launches``.
    """
    q, k, v, do, lse, delta, scale = _bwd_args(q, k, v, o, lse, do, window,
                                               scale)
    mask = dict(causal=causal, window=window, tuner=tuner)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, **mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, **mask)
    return dq, dk, dv


def bwd_route(dtype: torch.dtype, d: int, defines: tuple = ()) -> str:
    """The kernels :func:`flash_attention_bwd` launches for ``dtype`` and
    head dim ``d``: ``"tc"`` (tensor cores: bf16, ``d % 8 == 0``) or
    ``"simt"`` (f32 FMA units), as the C entry points (of the build with
    ``defines``) decide."""
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURE, defines)
    return ROUTES[lib.flash_attention_bwd_route(_DTYPES[dtype], d)]


def _launch(fn: str, args, q: torch.Tensor, k: torch.Tensor, scale: float,
            causal: bool, window: Optional[int], mode: int,
            tc: bool, defines: tuple = ()) -> None:
    """One call of C function ``fn`` of the build with ``defines`` on
    ``args`` (tensors); ``mode`` is its dtype code or, for the terms entry
    point, the term count; ``tc``: the tensor-core route, whose TMA maps
    need 16-byte aligned operands."""
    bh, sq, d = q.shape
    if tc:
        args = [_aligned(t) if i < 6 else t for i, t in enumerate(args)]
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURE, defines)
    with torch.cuda.device(q.device):
        code = getattr(lib, fn)(*(t.data_ptr() for t in args), bh, sq,
                                k.shape[1], d, bh // k.shape[0], int(causal),
                                window or 0, scale, mode, _stream(q.device))
    _build.check(lib, code, fn)


def _count(wrapper, route: str) -> None:
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float, *,
                           causal: bool = False,
                           window: Optional[int] = None,
                           tuner: Optional[tuning.KernelTuner] = None):
    """dq (BH, Sq, D) from contiguous, checked operands: one launch of the
    dq kernel of the build ``tuner`` resolves, counted in
    ``flash_attention_bwd_dq.launches`` and by route."""
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    if bh and sq:
        defines = _defines(tuner, q, k.shape[1], "flash_attention_bwd")
        route = bwd_route(q.dtype, d, defines)
        _launch("flash_attention_bwd_dq", (q, k, v, do, lse, delta, dq), q, k,
                scale, causal, window, _DTYPES[q.dtype], route == "tc",
                defines)
        _count(flash_attention_bwd_dq, route)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float, *,
                            causal: bool = False,
                            window: Optional[int] = None,
                            tuner: Optional[tuning.KernelTuner] = None):
    """(dk, dv), each (BKV, Sk, D) with the GQA group summed, from
    contiguous, checked operands: one launch of the dkv kernel of the
    build ``tuner`` resolves, counted in
    ``flash_attention_bwd_dkv.launches`` and by route."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[0] and k.shape[1]:     # with Sq == 0 the kernel stores zeros
        defines = _defines(tuner, q, k.shape[1], "flash_attention_bwd")
        route = bwd_route(q.dtype, q.shape[2], defines)
        _launch("flash_attention_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                q, k, scale, causal, window, _DTYPES[q.dtype], route == "tc",
                defines)
        _count(flash_attention_bwd_dkv, route)
    return dk, dv


for _wrapper in (flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.route_launches = dict.fromkeys(ROUTES.values(), 0)


def flash_attention_bwd_terms(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              terms: int, *, causal: bool = False,
                              window: Optional[int] = None,
                              scale: Optional[float] = None):
    """The tensor-core dq and dkv kernels with P and dS written as
    ``terms`` bf16 terms, for bf16 operands with a head dim that is a
    multiple of 8: :data:`BWD_TC_TERMS` is :func:`flash_attention_bwd`'s;
    1 and 3 exist for head dims 65-80 and 113-128 only, as controls of the
    numerics (P and dS rounded once to bf16 must miss the backward's
    limit).  Returns ``(dq, dk, dv)`` as :func:`flash_attention_bwd`; no
    model's path calls it, and it counts no launch."""
    if q.dtype != torch.bfloat16 or q.shape[-1] % 8:
        raise ValueError("the tensor-core kernels take bf16 operands with a "
                         "head dim that is a multiple of 8")
    q, k, v, do, lse, delta, scale = _bwd_args(q, k, v, o, lse, do, window,
                                               scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.shape[0] and q.shape[1] and k.shape[1]:
        _launch("flash_attention_bwd_terms",
                (q, k, v, do, lse, delta, dq, dk, dv), q, k, scale, causal,
                window, int(terms), True)
    return dq, dk, dv
