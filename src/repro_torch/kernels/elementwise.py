"""Fused elementwise kernels for the sampler's inner loop.

:func:`ddim_fused` replaces ``repro.kernels.elementwise.ddim_fused_pallas``
(TPU body ``_ddim_kernel``), :func:`parareal_update_residual` replaces
``parareal_update_residual_pallas`` (``_parareal_resid_kernel``) and
:func:`parareal_update` replaces ``parareal_update_pallas``
(``_parareal_kernel``).  All three are CUDA C++ for ``sm_90a`` in
``csrc/elementwise.cu``, one launch per call behind a ``ctypes`` binding.

Each is one pass over flat contiguous tensors, bound by bytes (each input
read once, the output written once): at the DiT's latents one call moves
0.2-2 MB, under a microsecond of HBM time, so in practice the launch and
the host's work per call bound it.  The kernels' design answers that: one
launch (a residual is reduced inside a thread-block cluster through
distributed shared memory, with no second pass, no scratch tensor and no
float atomics), 16-byte accesses where the operands allow, and a host path
that checks, allocates the outputs and calls the C function, nothing more.
The launch geometry is computed here (:func:`ddim_geometry`,
:func:`resid_geometry`) from the knobs that the tuning seam resolves for
the call (:mod:`repro_torch.kernels.tuning`, family ``elementwise``, keyed
by the dtype and the DDIM call's or the residual slice's element count;
:func:`launch_geometry` shows the routing without launching), so the CPU
tests reach it.

Sums are taken in a fixed order, so two runs are bitwise equal and a
slice's residual does not depend on the other slices in the batch.  The
CUDA library is built inside the launching functions only, so the module
imports on machines without ``nvcc``; the wrappers take CUDA tensors (the
ops layer sends CPU tensors to :mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build, tuning

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
VECTOR_BYTES = 16        # one thread access of the CUDA kernels
# The heuristic tier's knobs (tuning family "elementwise"): the DDIM grid
# gives each vector a thread in blocks of DDIM_THREADS; a residual block
# has up to RESID_THREADS threads, one 16-byte group each at the
# corrector's shapes (the loads of a thread's groups would otherwise wait
# for each other); a slice's cluster (B4: the whole tensor's) has one block
# per RESID_SLICE_PER_BLOCK elements, up to RESID_MAX_CLUSTER (at most the
# portable 8)
DDIM_THREADS = tuning.default("elementwise", "ddim_threads")
RESID_THREADS = tuning.default("elementwise", "resid_threads")
RESID_MAX_CLUSTER = tuning.default("elementwise", "resid_max_cluster")
RESID_SLICE_PER_BLOCK = tuning.default("elementwise",
                                       "resid_slice_per_block")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {"ddim_fused": ((_P,) * 5 + (_L,) * 3 + (_I,) * 4 + (_P,), _I),
              "parareal_update_residual": ((_P,) * 6 + (_L,) * 2 + (_I,) * 5
                                           + (_P,), _I),
              "parareal_update": ((_P,) * 5 + (_L,) * 2 + (_I,) * 4 + (_P,),
                                  _I),
              "parareal_resid_max_clusters": ((_I,) * 5
                                              + (ctypes.POINTER(_I),), _I)}
_max_clusters: Dict[tuple, int] = {}


def _lib() -> ctypes.CDLL:
    return _build.load("elementwise", _SIGNATURE)


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches a GPU kernel: CUDA tensors only")
    for t in ts:
        if t.device != dev or t.dtype != ts[0].dtype or t.shape != ts[0].shape:
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             f"shape")
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {ts[0].dtype} not supported")


def vector_width(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in one 16-byte access."""
    return VECTOR_BYTES // _ITEMSIZE[dtype]


def _aligned(*ts: torch.Tensor) -> bool:
    ptrs = 0
    for t in ts:
        ptrs |= t.data_ptr()
    return ptrs % VECTOR_BYTES == 0


@functools.lru_cache(maxsize=256)
def ddim_geometry(n: int, n_row: int, per_row: bool, vec: int,
                  aligned: bool,
                  threads: int = DDIM_THREADS) -> Tuple[int, int]:
    """``(n_vec, blocks)`` of a DDIM launch over ``n`` elements: the
    16-byte vectors the kernel takes first (0 unless the operands are
    ``aligned`` and, with per-row coefficients, a row's ``n_row`` elements
    are a multiple of ``vec``), and the grid of ``threads``-thread blocks
    (the tuner's ``ddim_threads``) that gives each vector, and each element
    after them, a thread of its own."""
    fits = aligned and (not per_row or n_row % vec == 0)
    n_vec = n // vec if fits else 0
    work = n_vec + (n - n_vec * vec)
    return n_vec, max(1, math.ceil(work / threads))


@functools.lru_cache(maxsize=256)
def resid_geometry(n_slice: int, vec: int, aligned: bool,
                   max_threads: int = RESID_THREADS,
                   max_cluster: int = RESID_MAX_CLUSTER,
                   slice_per_block: int = RESID_SLICE_PER_BLOCK
                   ) -> Tuple[int, int, int, bool]:
    """``(cluster, per_block, threads, vector)`` of a residual launch: the
    blocks of a slice's cluster (one per ``slice_per_block`` elements, at
    most ``max_cluster``), the groups of ``vec`` elements (one 16-byte
    access each) that each block owns, the threads of a block (whole
    warps, at most ``max_threads``), and whether the kernel takes its
    16-byte path (the operands ``aligned`` and ``n_slice`` a multiple of
    ``vec``).  The knobs are the tuner's ``resid_threads``,
    ``resid_max_cluster`` and ``resid_slice_per_block`` for the slice's
    length.  The first three follow from the slice's length (and the
    dtype's ``vec``) alone, so a slice is reduced in the same order
    whatever else rides in the batch; the two paths keep that order."""
    cluster = min(max_cluster,
                  max(1, math.ceil(n_slice / slice_per_block)))
    per_block = math.ceil(math.ceil(n_slice / vec) / cluster)
    threads = min(max_threads, 32 * max(1, math.ceil(per_block / 32)))
    return cluster, per_block, threads, aligned and n_slice % vec == 0


def _resid_knobs(params) -> Tuple[int, int, int]:
    return (params["resid_threads"], params["resid_max_cluster"],
            params["resid_slice_per_block"])


def launch_geometry(op: str, shape, dtype: torch.dtype, *,
                    tuner: Optional[tuning.KernelTuner] = None,
                    device="cpu", batch_dims: int = 0,
                    per_row: bool = False, aligned: bool = True) -> dict:
    """What a call of ``op`` (``"ddim_fused"``, ``"parareal_update_residual"``
    or ``"parareal_update"``) on a tensor of ``shape`` and ``dtype`` on
    ``device`` would launch, resolved through ``tuner`` (the process
    tuner when None), without launching: ``config`` (the
    :class:`~repro_torch.kernels.tuning.KernelConfig`) and ``geometry``
    (:func:`ddim_geometry`'s ``(n_vec, blocks)`` and ``threads``, or
    :func:`resid_geometry`'s four values)."""
    n = math.prod(shape)
    vec = vector_width(dtype)
    if op == "ddim_fused":
        cfg = tuning.config("elementwise", tuner, torch.device(device), dtype,
                            (n,))
        m = shape[0] if len(shape) else 1
        threads = cfg.params["ddim_threads"]
        n_vec, blocks = ddim_geometry(n, max(n // m, 1), per_row, vec,
                                      aligned, threads)
        return dict(config=cfg, geometry=dict(n_vec=n_vec, blocks=blocks,
                                              threads=threads))
    if op not in ("parareal_update_residual", "parareal_update"):
        raise ValueError(f"unknown elementwise op {op!r}")
    slices = math.prod(shape[:batch_dims]) if op != "parareal_update" else 1
    n_slice = n // slices if slices else 0
    cfg = tuning.config("elementwise", tuner, torch.device(device), dtype,
                        (n_slice,))
    cluster, per_block, threads, vector = resid_geometry(
        n_slice, vec, aligned, *_resid_knobs(cfg.params))
    return dict(config=cfg, geometry=dict(cluster=cluster,
                                          per_block=per_block,
                                          threads=threads, vector=vector))


def ddim_fused(x: torch.Tensor, eps: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, *,
               tuner: Optional[tuning.KernelTuner] = None) -> torch.Tensor:
    """``sqrt(b)*(x - sqrt(1-a) eps)/sqrt(a) + sqrt(1-b) eps`` in f32,
    rounded once to x's dtype (f32, bf16 or f16).

    ``a``/``b`` are tensors of shape () or per row ``(M,)`` over x's
    leading axis, taken in f32, contiguous, on x's device (such tensors
    pass as they are).  One launch of ``ddim_fused_kernel`` on the
    geometry ``tuner`` resolves (:func:`launch_geometry`), counted in
    ``ddim_fused.launches``.
    """
    _check("ddim_fused", x, eps)
    m = x.shape[0] if x.dim() else 1
    per_row = a.dim() == 1
    if a.shape != b.shape or a.dim() > 1 or (per_row and a.shape[0] != m):
        raise ValueError(f"coefficients must be () or ({m},), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    dev = x.device
    a, b = (c if c.dtype == torch.float32 and c.device == dev
            and c.is_contiguous()
            else c.to(device=dev, dtype=torch.float32).contiguous()
            for c in (a, b))
    x, eps = x.contiguous(), eps.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    n = x.numel()
    if n == 0:
        return out
    n_row = max(n // m, 1)
    threads = tuning.config("elementwise", tuner, dev, x.dtype,
                            (n,)).params["ddim_threads"]
    n_vec, blocks = ddim_geometry(n, n_row, per_row, vector_width(x.dtype),
                                  _aligned(x, eps, out), threads)
    _build.call(_lib(), "ddim_fused", dev, x.data_ptr(), eps.data_ptr(),
          a.data_ptr(), b.data_ptr(), out.data_ptr(), n, n_vec, n_row,
          1 if per_row else 0, blocks, threads, _DTYPES[x.dtype])
    ddim_fused.launches += 1
    return out


ddim_fused.launches = 0


def _check_cluster_fits(lib, fn: str, dev: torch.device, dtype: int,
                        vector: bool, cluster: int, threads: int) -> None:
    """Raise unless the card holds at least one such cluster of ``fn``'s
    kernel (``parareal_update`` or ``parareal_update_residual``) at once
    (CUDA's occupancy calculator, asked once per configuration)."""
    update_only = fn == "parareal_update"
    key = (dev.index, update_only, dtype, vector, cluster, threads)
    got = _max_clusters.get(key)
    if got is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = lib.parareal_resid_max_clusters(
                update_only, dtype, vector, cluster, threads,
                ctypes.byref(out))
        _build.check(lib, code, "parareal_resid_max_clusters")
        got = _max_clusters[key] = out.value
    if got == 0:
        raise RuntimeError(f"{fn}: no cluster of {cluster} blocks of "
                           f"{threads} threads fits on {dev}")


def parareal_update_residual(y: torch.Tensor, cur: torch.Tensor,
                             prev: torch.Tensor, old: torch.Tensor, *,
                             batch_dims: int = 0,
                             tuner: Optional[tuning.KernelTuner] = None):
    """``out = y + cur - prev`` (rounded once from f32) and the f32 L1 sum
    ``|out - old|`` per slice of the ``batch_dims`` preserved leading axes.

    One launch of ``parareal_resid_cluster_kernel``: each slice is one
    thread-block cluster (:func:`resid_geometry`), whose blocks write the
    update and reduce their spans; rank 0 sums the blocks' partials from
    their shared memory in rank order.  No float atomics, so two runs are
    bitwise equal and a slice's residual is the same whatever other slices
    ride in the batch.  The knobs are ``tuner``'s for the slice's length.
    Counts each call in ``parareal_update_residual.launches``.
    """
    _check("parareal_update_residual", y, cur, prev, old)
    nd = int(batch_dims)
    if not 0 <= nd <= y.dim():
        raise ValueError(f"batch_dims={nd} out of range for ndim={y.dim()}")
    lead = y.shape[:nd]
    slices = lead.numel()
    dev = y.device
    y, cur = y.contiguous(), cur.contiguous()
    prev, old = prev.contiguous(), old.contiguous()
    out = torch.empty(y.shape, dtype=y.dtype, device=dev)
    n_slice = y.numel() // slices if slices else 0
    if n_slice == 0:
        return out, torch.zeros(lead, dtype=torch.float32, device=dev)
    resid = torch.empty(lead, dtype=torch.float32, device=dev)
    cfg = tuning.config("elementwise", tuner, dev, y.dtype, (n_slice,))
    cluster, per_block, threads, vector = resid_geometry(
        n_slice, vector_width(y.dtype), _aligned(y, cur, prev, old, out),
        *_resid_knobs(cfg.params))
    dtype = _DTYPES[y.dtype]
    lib = _lib()
    _check_cluster_fits(lib, "parareal_update_residual", dev, dtype, vector,
                        cluster, threads)
    _build.call(lib, "parareal_update_residual", dev, y.data_ptr(),
          cur.data_ptr(), prev.data_ptr(), old.data_ptr(), out.data_ptr(),
          resid.data_ptr(), n_slice, per_block, slices, cluster, threads,
          vector, dtype)
    parareal_update_residual.launches += 1
    return out, resid


parareal_update_residual.launches = 0


# the B4 kernel's own definition: RL002 exempts the JAX package's
# kernels directory, not the port's
# reprolint: disable=RL002
def parareal_update(y: torch.Tensor, cur: torch.Tensor, prev: torch.Tensor,
                    *, tuner: Optional[tuning.KernelTuner] = None):
    """``out = y + cur - prev`` (rounded once from f32) and the f32 L1 sum
    ``|cur - prev|`` over the whole tensor, as a 0-d tensor.

    One launch of ``parareal_update_cluster_kernel``: the whole tensor is
    one slice of :func:`parareal_update_residual`'s scheme (one
    thread-block cluster, :func:`resid_geometry` of its length), whose
    blocks write the update and reduce their spans; rank 0 sums the blocks'
    partials from their shared memory in rank order.  No float atomics, so
    two runs are bitwise equal.  Counts each call in
    ``parareal_update.launches``.
    """
    _check("parareal_update", y, cur, prev)
    dev = y.device
    y, cur, prev = y.contiguous(), cur.contiguous(), prev.contiguous()
    out = torch.empty(y.shape, dtype=y.dtype, device=dev)
    n = y.numel()
    if n == 0:
        return out, torch.zeros((), dtype=torch.float32, device=dev)
    resid = torch.empty((), dtype=torch.float32, device=dev)
    cfg = tuning.config("elementwise", tuner, dev, y.dtype, (n,))
    cluster, per_block, threads, vector = resid_geometry(
        n, vector_width(y.dtype), _aligned(y, cur, prev, out),
        *_resid_knobs(cfg.params))
    dtype = _DTYPES[y.dtype]
    lib = _lib()
    _check_cluster_fits(lib, "parareal_update", dev, dtype, vector, cluster,
                        threads)
    _build.call(lib, "parareal_update", dev, y.data_ptr(), cur.data_ptr(),
          prev.data_ptr(), out.data_ptr(), resid.data_ptr(), n, per_block,
          cluster, threads, vector, dtype)
    parareal_update.launches += 1
    return out, resid


parareal_update.launches = 0
