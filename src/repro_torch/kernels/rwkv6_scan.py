"""RWKV6 WKV recurrence, forward and backward: the CUDA C++ kernels'
wrappers.

The forward is the counterpart of
``repro.kernels.rwkv6_scan.rwkv6_wkv_pallas`` (TPU body ``_wkv_kernel``),
in ``csrc/rwkv6_wkv.cu``: the f32 (Dk, Dv) state of a batch x head is
split by columns over blocks of 32 columns, each of which carries its
columns across all T steps.  Like the JAX kernel it is the sequential
recurrence (the chunked-parallel form's decay ratios overflow f32).  For a
gradient it also writes the state at the start of every chunk of
:func:`chunk` steps.

The backward has no Pallas counterpart: JAX differentiates its oracle
(``repro.kernels.ops._wkv_bwd``).  Its kernel, in the same source, splits
the state by rows over 4 blocks of 16 rows per batch x head and walks back
chunk by chunk, recomputing each chunk's states from the forward's
checkpoint; each row block writes its part of ``dv`` as f32, and a second
kernel sums the 4 parts in a fixed order and rounds ``dv`` once.  ``du``
comes out as per-(batch, head) partials that
:func:`rwkv6_wkv_bwd` sums over the batch in a fixed order, so two runs
are bitwise equal.

The geometry's knobs resolve through the tuning seam
(:mod:`repro_torch.kernels.tuning`, family ``rwkv6``, keyed by the dtype
and ``(T, Dk)``): the dv sum's block (``dv_sum_threads``, a launch
parameter) and the forward's columns and the backward's rows a block
(``fwd_cols``, ``bwd_rows``, build parameters whose layouts take 32 and
16 only); :func:`launch_geometry` shows the routing without launching.

The kernels take head dims that are multiples of 8 (rows of 16 bytes or
more, for their bulk copies) and 16-byte aligned operands: the wrappers
pad other head dims with zeros and slice the results back, which changes
no value (a zero row or column of r, k, v and the state stays zero).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, tuning

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = {"rwkv6_wkv_fwd": ((_P,) * 9 + (_I,) * 6 + (_P,), _I),
              "rwkv6_wkv_bwd": ((_P,) * 15 + (_I,) * 7 + (_P,), _I),
              "rwkv6_wkv_chunk": ((), _I),
              "rwkv6_wkv_launch_info": ((_I,) * 4 + (ctypes.POINTER(_I),),
                                        _I)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DK = 64
MAX_DV = 128
MAX_DV_BWD = 64          # the backward's row blocks hold whole rows
_MULTIPLE = 8            # the kernels' head dims: multiples of 8
_ROWS = 64               # the state's rows, padded (the kernels' kRows)


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


def _lib(defines: tuple = ()):
    return _build.load("rwkv6_wkv", _SIGNATURE, defines)


def launch_geometry(b: int, h: int, t: int, dk: int, dv: int,
                    dtype: torch.dtype, *,
                    tuner: Optional[tuning.KernelTuner] = None,
                    device="cpu") -> dict:
    """What :func:`rwkv6_wkv` and :func:`rwkv6_wkv_bwd` would launch for
    r (B, H, T, Dk) and v (..., Dv) of ``dtype`` on ``device``, resolved
    through ``tuner`` (the process tuner when None), without launching:
    ``config``, the library's ``defines``, the forward's grid, the
    backward's grid (its row groups) and the dv sum's block and grid."""
    cfg = tuning.config("rwkv6", tuner, torch.device(device), dtype, (t, dk))
    p = cfg.params
    pv = _padded(dv)
    quads = b * h * t * pv // 4
    threads = p["dv_sum_threads"]
    return dict(config=cfg,
                defines=tuning.defines("rwkv6", p, "rwkv6_wkv"),
                fwd_grid=(b * h, -(-pv // p["fwd_cols"])),
                bwd_grid=(b * h, _ROWS // p["bwd_rows"]),
                dv_sum=dict(threads=threads, blocks=-(-quads // threads)))


def _padded(n: int) -> int:
    return -(-n // _MULTIPLE) * _MULTIPLE


def _aligned(x: torch.Tensor, *_sizes: int) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (the bulk copies' rule)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _pad(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` zero-padded at the end of its last ``len(sizes)`` dims to
    ``sizes``, contiguous and 16-byte aligned."""
    pads = []
    for dim, size in zip(reversed(range(x.dim())), reversed(sizes)):
        pads += [0, size - x.shape[dim]]
    return _aligned(torch.nn.functional.pad(x, pads))


def _cut(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """Undo :func:`_pad`: the leading ``sizes`` of the last dims."""
    index = (...,) + tuple(slice(0, n) for n in sizes)
    return x[index].contiguous()


def launch_info(backward: bool, dtype: torch.dtype, bh: int,
                dv: int = 64) -> dict:
    """How the forward (or backward) kernel is launched for ``bh`` batch x
    heads and value dim ``dv``: grid, threads and shared bytes a block,
    and the blocks an SM can hold (CUDA's occupancy calculator; for the
    backward, of its first pass).  Needs the card."""
    info = (ctypes.c_int * 5)()
    lib = _lib()
    code = lib.rwkv6_wkv_launch_info(int(backward), _DTYPES[dtype], bh,
                                     _padded(dv), info)
    _build.check(lib, code, "rwkv6_wkv_launch_info")
    return dict(grid=(info[0], info[1]), threads=info[2],
                shared_bytes=info[3], blocks_per_sm=info[4])


def chunk() -> int:
    """Steps between two of the forward's state checkpoints (the
    kernel's ``kChunk``)."""
    return _lib().rwkv6_wkv_chunk()


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
              checkpoints: bool = False,
              tuner: Optional[tuning.KernelTuner] = None):
    """r, k, w: (B, H, T, Dk); v: (B, H, T, Dv); u: (H, Dk); s0:
    (B, H, Dk, Dv), all on one CUDA device.  r, k and v share a dtype
    (f32 or bf16); w, u and s0 are taken in f32 (the model's decay logits,
    bonus and state are f32).

    Returns ``(out (B, H, T, Dv) in v's dtype, final state f32, ckpt)``:
    with ``checkpoints``, ``ckpt`` is the f32 state at the start of every
    chunk, (B, H, ceil(T / chunk()), Dk, Dv), for :func:`rwkv6_wkv_bwd`;
    otherwise None.  Launches the kernel once and counts it in
    ``rwkv6_wkv.launches``.
    """
    _check(r, k, v, w, u, s0)
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if b == 0:
        return (torch.empty_like(v), torch.empty(
            (b, h, dk, dv), dtype=torch.float32, device=r.device), None)
    pk, pv = _padded(dk), _padded(dv)
    padded = (pk, pv) != (dk, dv)
    prep = _pad if padded else _aligned
    r, k, w = (prep(x, pk) for x in (r, k, w.float()))
    v, u, s0 = prep(v, pv), prep(u.float(), pk), prep(s0.float(), pk, pv)
    out = torch.empty_like(v)
    s_t = torch.empty((b, h, pk, pv), dtype=torch.float32, device=r.device)
    ckpt = None
    cfg = tuning.config("rwkv6", tuner, r.device, r.dtype, (t, dk))
    lib = _lib(tuning.defines("rwkv6", cfg.params, "rwkv6_wkv"))
    if checkpoints:
        n_chunks = -(-t // lib.rwkv6_wkv_chunk())
        ckpt = torch.empty((b, h, n_chunks, pk, pv), dtype=torch.float32,
                           device=r.device)
    with torch.cuda.device(r.device):
        code = lib.rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_t.data_ptr(),
            ckpt.data_ptr() if ckpt is not None else None,
            b * h, t, h, pk, pv, _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_wkv")
    rwkv6_wkv.launches += 1
    if not padded:
        return out, s_t, ckpt
    return (_cut(out, dv), _cut(s_t, dk, dv),
            None if ckpt is None else _cut(ckpt, dk, dv))


rwkv6_wkv.launches = 0


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                  dout: torch.Tensor, ds_t: Optional[torch.Tensor] = None, *,
                  tuner: Optional[tuning.KernelTuner] = None):
    """Gradients of :func:`rwkv6_wkv` from the forward's inputs, its
    checkpoints ``ckpt``, the gradient of ``out`` and (optionally, zero
    when None) of the final state.  Returns ``(dr, dk, dv, dw, du, ds0)``:
    dr, dk, dv in r's dtype; dw (B, H, T, Dk), du (H, Dk) and ds0
    (B, H, Dk, Dv) in f32.  Launches the kernel once (with the dv sum on
    ``tuner``'s block) and counts it in ``rwkv6_wkv_bwd.launches``."""
    if ckpt.dim() != 5:
        raise ValueError(f"ckpt must be the forward's (B, H, chunks, Dk, "
                         f"Dv) checkpoints, got {tuple(ckpt.shape)}")
    _check(r, k, v, w, u, ckpt[:, :, 0])
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if dv > MAX_DV_BWD:
        raise ValueError(f"the backward takes Dv <= {MAX_DV_BWD}, got {dv}")
    cfg = tuning.config("rwkv6", tuner, r.device, r.dtype, (t, dk))
    lib = _lib(tuning.defines("rwkv6", cfg.params, "rwkv6_wkv"))
    n_chunks = -(-t // lib.rwkv6_wkv_chunk())
    if ckpt.shape[2] != n_chunks or ckpt.dtype != torch.float32:
        raise ValueError(f"ckpt must be the forward's f32 checkpoints "
                         f"{(b, h, n_chunks, dk, dv)}, got {ckpt.dtype} "
                         f"{tuple(ckpt.shape)}")
    if dout.shape != v.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must have v's shape "
                         f"{tuple(v.shape)}")
    if ds_t is not None and ds_t.shape != (b, h, dk, dv):
        raise ValueError(f"ds_t {tuple(ds_t.shape)} must be "
                         f"{(b, h, dk, dv)}")
    if not all(x.device == r.device for x in (dout,) +
               ((ds_t,) if ds_t is not None else ())):
        raise ValueError("rwkv6_wkv_bwd: all operands must be on one CUDA "
                         "device")
    pk, pv = _padded(dk), _padded(dv)
    padded = (pk, pv) != (dk, dv)
    prep = _pad if padded else _aligned
    r, k, w = (prep(x, pk) for x in (r, k, w.float()))
    v, dout = prep(v, pv), prep(dout.to(r.dtype), pv)
    u, ckpt = prep(u.float(), pk), prep(ckpt.float(), pk, pv)
    if ds_t is not None:
        ds_t = prep(ds_t.float(), pk, pv)
    dr, dk_, dv_ = torch.empty_like(r), torch.empty_like(k), \
        torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=r.device)
    dw = torch.empty((b, h, t, pk), **f32)
    du_part = torch.empty((b, h, pk), **f32)
    ds0 = torch.empty((b, h, pk, pv), **f32)
    dv_part = torch.empty((b * h, _ROWS // cfg.params["bwd_rows"], t, pv),
                          **f32)
    with torch.cuda.device(r.device):
        code = lib.rwkv6_wkv_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), dout.data_ptr(),
            ds_t.data_ptr() if ds_t is not None else None, dr.data_ptr(),
            dk_.data_ptr(), dv_.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), ds0.data_ptr(), dv_part.data_ptr(), b * h, t,
            h, pk, pv, cfg.params["dv_sum_threads"], _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, code, "rwkv6_wkv_bwd")
    rwkv6_wkv_bwd.launches += 1
    du = du_part.sum(dim=0)
    if not padded:
        return dr, dk_, dv_, dw, du, ds0
    return (_cut(dr, dk), _cut(dk_, dk), _cut(dv_, dv), _cut(dw, dk),
            _cut(du, dk), _cut(ds0, dk, dv))


rwkv6_wkv_bwd.launches = 0
