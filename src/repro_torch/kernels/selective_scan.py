"""Hymba's selective scan, forward: the CUDA C++ kernel's wrapper.

The kernel (``csrc/selective_scan.cu``) replaces no Pallas kernel: the
JAX model runs the recurrence as a ``jax.lax.scan`` inside
``repro.models.hymba._ssm_scan``, one device loop under XLA, which eager
PyTorch could only run as a Python loop of small launches.  A lane owns
:data:`STATES_PER_LANE` states of one channel and carries them through
all T steps in registers; a channel's lanes sum y by a transpose-reduce
over groups of steps, and a block stages :data:`CHUNK` steps of the row's
dt, B and C and of its channels' x in a ring of :data:`STAGES` stages,
filled by a producer warp: dt, B and C by bulk copies and x by 16-byte
copies where the operands are 16-byte aligned, by 4-byte copies where
not (:func:`route`; see the source).  A decode step (T = 1) launches a
kernel of its own (``selective_scan_step_kernel``, same geometry): no
producer warp and no staging, each lane's operands loaded from global
memory.  One launch a call; two runs are bitwise equal.

The launch geometry is computed here (:func:`geometry`), so the CPU tests
reach it; its knobs resolve through the tuning seam
(:mod:`repro_torch.kernels.tuning`, family ``selective_scan``, keyed by
``(T, din, n)``): launch parameters (the forward's channels a block and
ring depth, the backward's channels a block and its cut of T) and build
parameters (the backward's sub-chunk, compute threads and register caps,
``-D`` defines of the source).  The named constants below are the
heuristic tier's values; :func:`launch_geometry` shows the routing
without launching.  ``xs`` is read in place through its batch and time strides (the
model's ``xs`` is the second half of the ``x @ w_in`` product, a strided
view); its channel stride must be 1, or it is copied.  The other operands
are made contiguous.  The host path checks, allocates ``y`` and ``h_T``
and calls the C function on the current stream's raw handle
(``_build.call``), nothing more: at T = 1 the call is host-bound.

For a gradient the forward also writes the f32 state at the start of every
chunk and the final one (``checkpoints=True``, an instance of its own, so
the served forward is unchanged), and :func:`selective_scan_bwd` launches
the backward kernel on :func:`bwd_geometry`: T cut into segments of whole
chunks, the segments of a (channel block, batch row) the ranks of a
thread-block cluster.  Each rank replays its segment's chunks from their
checkpoints, keeps the state at the start of every :data:`SUB` steps in a
scratch (:func:`bwd_starts_shape`) and sums the product of its decays and
its local carry; the ranks fold the later ones' through distributed shared
memory into their own carry, and each then walks the chunks of its segment
from the last, recomputing each sub-chunk's states from its start, and
writes per-block partials of the sums over channels (dB, dC, ddt) and
per-row and -segment partials of da and dD, which
:func:`selective_scan_bwd_sum` (a second launch) adds in a fixed order, so
two runs are bitwise equal.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build, tuning

STATES_PER_LANE = 4      # a lane's states (n padded to a power of two)
# a block's channels, at most MAX_THREADS / lanes: at hymba's width and
# the served batch 4 (B 4 x T 2048) blocks of 64 read faster than of 16 or
# 32 on an H100 (PERF.md, scripts/torch_scan_bench.py)
CHANNELS_PER_BLOCK = tuning.default("selective_scan", "channels")
CHUNK = 64               # steps staged a time (the kernel's kChunk)
STAGES = tuning.default("selective_scan", "stages")   # kMaxStages, the most
MAX_STATE = 32           # a channel's lanes lie in one warp
MAX_THREADS = 256        # a block's compute threads (kMaxConsumers)
# (states a lane, lanes a channel) pairs the library is compiled for: the
# ones geometry() takes for n 1-32 (scripts/torch_scan_bench.py builds
# its sweep's others into a library of its own)
INSTANCES = ((1, 1), (2, 1), (4, 1), (4, 2), (4, 4), (4, 8))
# route bits (the kernel's kBulkDt, kBulkBC, kVecX): dt, and B and C, by
# cp.async.bulk; x by 16-byte cp.async; an operand without its bit by
# 4-byte cp.async
BULK_DT, BULK_BC, VEC_X = 1, 2, 4
ALIGN = 16               # the copies' addresses and sizes
# the backward: steps a sub-chunk (SCAN_BWD_SUB; a lane recomputes their
# states into registers), the staging ring's depth (kBwdStages), dy's route
# bit (kVecDy: 16-byte cp.async), a block's compute threads
# (SCAN_BWD_MAX_CONSUMERS) and the blocks an SM the walk's and the replay's
# registers are capped for (SCAN_BWD_MIN_BLOCKS, SCAN_BWD_REPLAY_MIN_BLOCKS),
# its channels a block, and the cut of T into segments: SEGMENT_CHUNKS
# chunks a segment at least, at most MAX_SEGMENTS segments.  At hymba's
# width and training shape (B 2 x T 2048) on an H100, in one process:
# segments of 2 chunks (16 of them) read 0.363 ms against 0.381 for 1,
# 0.390 for 4 and 0.379 for 6; 8 steps a sub-chunk capped for 3 blocks an
# SM (128 registers, 24 bytes of spill loads) against 0.396 uncapped (152
# registers, 2 blocks) and 0.45 for 4 steps; blocks of 32 channels against
# 0.40 for 64; the replay's cap for 3 blocks within noise of 4 (PERF.md,
# scripts/torch_scan_bench.py --backward)
SUB = tuning.default("selective_scan", "bwd_sub")
BWD_STAGES = 2
VEC_DY = 8
BWD_MAX_THREADS = tuning.default("selective_scan", "bwd_max_threads")
BWD_MIN_BLOCKS = tuning.default("selective_scan", "bwd_min_blocks")
BWD_REPLAY_MIN_BLOCKS = tuning.default("selective_scan",
                                       "bwd_replay_min_blocks")
BWD_CHANNELS_PER_BLOCK = tuning.default("selective_scan", "bwd_channels")
SEGMENT_CHUNKS = tuning.default("selective_scan", "segment_chunks")
MAX_SEGMENTS = tuning.default("selective_scan", "max_segments")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {"selective_scan_fwd": ((_P, _L, _L) + (_P,) * 8 + (_I,) * 9
                                     + (_P,), _I),
              "selective_scan_fwd_ckpt": ((_P, _L, _L) + (_P,) * 9
                                          + (_I,) * 9 + (_P,), _I),
              "selective_scan_bwd_replay": ((_P, _L, _L) + (_P,) * 8
                                            + (_I,) * 10 + (_P,), _I),
              "selective_scan_bwd": ((_P, _L, _L) + (_P,) * 14 + (_I,) * 10
                                     + (_P,), _I),
              "selective_scan_bwd_sum": ((_P,) * 8 + (_I,) * 7 + (_P,), _I),
              "selective_scan_bwd_smem": ((_I,) * 3, _I),
              "selective_scan_bwd_knobs": ((_I,), _I),
              "selective_scan_chunk": ((), _I)}


class Geometry(NamedTuple):
    states: int          # a lane's states (R)
    lanes: int           # a channel's lanes (L); states * lanes >= n
    channels: int        # a block's channels (C)
    threads: int         # channels * lanes (and a producer warp, T > 1)
    grid: tuple          # (ceil(din / channels), batch)


class BwdGeometry(NamedTuple):
    states: int          # a lane's states (R)
    lanes: int           # a channel's lanes (L)
    channels: int        # a block's channels (C)
    segments: int        # segments of T (S)
    segment_steps: int   # steps a segment, a whole number of chunks
    threads: int         # channels * lanes, and a producer warp on top
    grid: tuple          # (ceil(din / channels), batch, segments)


def _lib(defines: tuple = ()) -> ctypes.CDLL:
    return _build.load("selective_scan", _SIGNATURE, defines)


def _config(tuner, device, t: int, din: int, n: int):
    return tuning.config("selective_scan", tuner, device, torch.float32,
                         (t, din, n))


@functools.lru_cache(maxsize=256)
def geometry(batch: int, din: int, n: int, states: int = STATES_PER_LANE,
             channels: int = CHANNELS_PER_BLOCK) -> Geometry:
    """The launch for state size ``n``: n padded to the power of two NP,
    ``min(states, NP)`` states a lane, ``NP / states`` lanes a channel
    (lanes of one warp, ``32 / lanes`` apart), ``channels`` channels a
    block (at least a warp's worth, at most ``MAX_THREADS`` threads), grid
    ``(ceil(din / channels), batch)``, and a producer warp beside the
    ``threads`` when T > 1.  Lane ``q`` of
    warp ``w`` of block ``(bx, by)`` owns channel ``bx * channels + w * (32
    // lanes) + q % (32 // lanes)`` of batch row ``by`` and, in register
    ``r``, state ``q // (32 // lanes) * states + r``; channels past din and
    states past n are idle."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the selective scan takes 1 <= n <= {MAX_STATE}, "
                         f"got {n}")
    padded = 1 << (n - 1).bit_length()
    states = min(states, padded)
    lanes = padded // states
    channels = max(min(channels, MAX_THREADS // lanes), 32 // lanes)
    return Geometry(states, lanes, channels, channels * lanes,
                    (-(-din // channels), batch))


@functools.lru_cache(maxsize=256)
def route(misaligned: tuple, batch: int, t: int, din: int, n: int,
          padded: int, sxb: int, sxt: int) -> int:
    """The route bits of a launch: dt, and B and C, by ``cp.async.bulk``
    where every chunk of them starts on a 16-byte boundary and spans a
    multiple of 16 bytes; x by 16-byte ``cp.async`` where every row of
    a block's channels does; the others by 4-byte ``cp.async`` (a bulk
    copy whose start is not aligned never lands).  ``misaligned``: the
    data pointers of (xs, dt, bb | cc) modulo 16.  dt needs T % 4 == 0; B
    and C need T n % 4 == 0 and n a power of two (the stage's rows are
    ``padded`` wide); x needs din, and its strides, multiples of 4 (a
    stride of a length-1 axis is never used)."""
    px, pd, pbc = misaligned
    bits = 0
    if pd == 0 and t % 4 == 0:
        bits |= BULK_DT
    if pbc == 0 and (t * n) % 4 == 0 and n == padded:
        bits |= BULK_BC
    if (px == 0 and din % 4 == 0 and (sxb % 4 == 0 or batch == 1)
            and (sxt % 4 == 0 or t == 1)):
        bits |= VEC_X
    return bits


def checkpoint_shape(batch: int, t: int, din: int, n: int) -> tuple:
    """The forward's checkpoints for the backward: the f32 state at the
    start of every chunk of :data:`CHUNK` steps and the final one,
    ``(B, ceil(T / CHUNK) + 1, din, n)``."""
    return (batch, -(-t // CHUNK) + 1, din, n)


@functools.lru_cache(maxsize=256)
def bwd_geometry(batch: int, t: int, din: int, n: int,
                 channels: int = BWD_CHANNELS_PER_BLOCK,
                 segment_chunks: int = SEGMENT_CHUNKS,
                 max_threads: int = BWD_MAX_THREADS,
                 max_segments: int = MAX_SEGMENTS) -> BwdGeometry:
    """The backward's launch: lanes and states as :func:`geometry`'s, at
    most ``max_threads`` compute threads a block (the build's
    SCAN_BWD_MAX_CONSUMERS), and T cut into
    segments of whole chunks of :data:`CHUNK` steps, so that each starts on
    one of the forward's checkpoints: ``min(max_segments, ceil(chunks /
    segment_chunks))`` segments asked, ``ceil(chunks / asked)`` chunks
    each (the last may hold fewer), ``ceil(chunks / that)`` segments
    (``ref.selective_scan_bwd``'s cut for the same count).  Block ``(bx,
    by, z)`` of both launches walks segment z of batch row by for
    :func:`geometry`'s channels and states of block bx."""
    lanes = geometry(1, 1, n).lanes
    geo = geometry(batch, din, n, channels=min(channels,
                                               max_threads // lanes))
    chunks = -(-t // CHUNK)
    asked = min(max_segments, -(-chunks // max(1, segment_chunks)))
    per = -(-chunks // asked)
    segments = -(-chunks // per)
    return BwdGeometry(geo.states, geo.lanes, geo.channels, segments,
                       per * CHUNK, geo.threads,
                       (geo.grid[0], batch, segments))


def _bwd_geometry(p, batch: int, t: int, din: int, n: int) -> BwdGeometry:
    return bwd_geometry(batch, t, din, n, p["bwd_channels"],
                        p["segment_chunks"], p["bwd_max_threads"],
                        p["max_segments"])


def launch_geometry(batch: int, t: int, din: int, n: int, *,
                    tuner: Optional[tuning.KernelTuner] = None,
                    device="cpu") -> dict:
    """What :func:`selective_scan` and :func:`selective_scan_bwd` would
    launch for xs (B, T, din) and n states on ``device``, resolved through
    ``tuner`` (the process tuner when None), without launching:
    ``config``, the library's ``defines``, the forward's
    :class:`Geometry` and ring ``stages``, the backward's
    :class:`BwdGeometry` and its ``sub``-step sub-chunks."""
    cfg = _config(tuner, torch.device(device), t, din, n)
    p = cfg.params
    return dict(config=cfg,
                defines=tuning.defines("selective_scan", p,
                                       "selective_scan"),
                fwd=geometry(batch, din, n, channels=p["channels"]),
                stages=p["stages"],
                bwd=_bwd_geometry(p, batch, t, din, n), sub=p["bwd_sub"])


def partial_shape(batch: int, t: int, din: int, n: int,
                  channels: int = BWD_CHANNELS_PER_BLOCK) -> tuple:
    """The backward's per-block partials of the sums over channels: ``(B,
    blocks, T, 2 NP + 1)``, a step's dB and dC over the padded states
    (NP) and ddt, for each of the ``ceil(din / channels)`` channel blocks
    of a batch row (each segment writes its own steps)."""
    geo = bwd_geometry(batch, t, din, n, channels)
    return (batch, geo.grid[0], t, 2 * geo.states * geo.lanes + 1)


def bwd_smem_bytes(geo, sub: int = SUB, replay: bool = False) -> int:
    """The backward's dynamic shared memory a block: :data:`BWD_STAGES`
    stages of x and dy (CHUNK x channels), B and C (CHUNK x NP) and dt
    (CHUNK); and, for the walk back (not the ``replay``), the warps' sums
    of two sub-chunks, (2, warps, sub, 2 NP + 1)."""
    np_ = geo.states * geo.lanes
    stage = 2 * CHUNK * geo.channels + 2 * CHUNK * np_ + CHUNK
    sums = 0 if replay else 2 * (geo.threads // 32) * sub * (2 * np_ + 1)
    return 4 * (BWD_STAGES * stage + sums)


def bwd_starts_shape(geo, sub: int = SUB) -> tuple:
    """The backward's scratch of start states: each block's lanes' state
    at the start of every ``sub`` steps of its segment, written by the
    replay (the first launch) and read back by the walk (the second),
    ``(B, segments, blocks, segment_steps / sub, threads, states)``."""
    return (geo.grid[1], geo.segments, geo.grid[0],
            geo.segment_steps // sub, geo.threads, geo.states)


def bwd_route(misaligned: tuple, batch: int, t: int, din: int, n: int,
              padded: int, sxb: int, sxt: int) -> int:
    """The backward's route bits: :func:`route`'s for (xs, dt, bb | cc),
    the first three of ``misaligned``, and :data:`VEC_DY` for dy (its
    pointer modulo 16, the fourth) where it is 16-byte aligned and din a
    multiple of 4 (dy is contiguous)."""
    bits = route(misaligned[:3], batch, t, din, n, padded, sxb, sxt)
    if misaligned[3] == 0 and din % 4 == 0:
        bits |= VEC_DY
    return bits


def _check(xs, dt, bb, cc, a, d, h0) -> None:
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, T, din), got {tuple(xs.shape)}")
    b, t, din = xs.shape
    n = a.shape[-1]
    if (dt.shape != (b, t) or bb.shape != (b, t, n) or cc.shape != (b, t, n)
            or a.shape != (din, n) or d.shape != (din,)
            or h0.shape != (b, din, n)):
        want = {"dt": (b, t), "bb": (b, t, n), "cc": (b, t, n),
                "a": (din, n), "d": (din,), "h0": (b, din, n)}
        for name, x in (("dt", dt), ("bb", bb), ("cc", cc), ("a", a),
                        ("d", d), ("h0", h0)):
            if tuple(x.shape) != want[name]:
                raise ValueError(f"{name} {tuple(x.shape)} does not fit xs "
                                 f"{tuple(xs.shape)}: want {want[name]}")
    ts = (xs, dt, bb, cc, a, d, h0)
    f32 = torch.float32
    if not (xs.dtype == f32 and dt.dtype == f32 and bb.dtype == f32
            and cc.dtype == f32 and a.dtype == f32 and d.dtype == f32
            and h0.dtype == f32):
        raise TypeError("the selective scan takes f32 operands, got "
                        + ", ".join(str(x.dtype) for x in ts))
    dev = xs.get_device()
    if not (xs.is_cuda and dt.get_device() == dev and bb.get_device() == dev
            and cc.get_device() == dev and a.get_device() == dev
            and d.get_device() == dev and h0.get_device() == dev):
        raise ValueError("selective_scan launches the CUDA kernel: all "
                         "operands must be on one CUDA device")
    if t < 1 or b < 1 or din < 1:
        raise ValueError(f"empty scan: B {b}, T {t}, din {din}")


def launch(lib, xs, dt, bb, cc, a, d, h0, y, h_t, geo: Geometry,
           stages: int = STAGES, bits: Optional[int] = None,
           ckpt: Optional[torch.Tensor] = None) -> None:
    """One launch of ``lib``'s ``selective_scan_fwd`` (this source's or a
    build of it with other knobs) into ``y`` and ``h_t`` with geometry
    ``geo``, or of ``selective_scan_fwd_ckpt`` when ``ckpt`` (of
    :func:`checkpoint_shape`) is given; ``bits`` defaults to :func:`route`
    of the operands."""
    b, t, din = xs.shape
    n = a.shape[-1]
    sxb, sxt = xs.stride(0), xs.stride(1)
    px, pd, pb, pc = xs.data_ptr(), dt.data_ptr(), bb.data_ptr(), \
        cc.data_ptr()
    if bits is None:
        bits = route((px % ALIGN, pd % ALIGN, (pb | pc) % ALIGN), b, t, din,
                     n, geo.states * geo.lanes, sxb, sxt)
    outs = (y.data_ptr(), h_t.data_ptr())
    if ckpt is None:
        fn = "selective_scan_fwd"
    else:
        fn, outs = "selective_scan_fwd_ckpt", outs + (ckpt.data_ptr(),)
    _build.call(lib, fn, xs.device, px, sxb, sxt, pd, pb, pc, a.data_ptr(),
                d.data_ptr(), h0.data_ptr(), *outs, b, t, din, n, geo.states,
                geo.lanes, geo.channels, stages, bits)


def selective_scan(xs: torch.Tensor, dt: torch.Tensor, bb: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor, *, checkpoints: bool = False,
                   tuner: Optional[tuning.KernelTuner] = None):
    """xs: (B, T, din); dt: (B, T); bb, cc: (B, T, n); a: (din, n); d:
    (din,); h0: (B, din, n); all f32 on one CUDA device.  Returns ``(y
    (B, T, din), h_T (B, din, n), ckpt)``, y and h_T f32 with the semantics
    of :func:`repro_torch.kernels.ref.selective_scan`; with
    ``checkpoints``, ``ckpt`` is the f32 state at the start of every chunk
    and the final one (:func:`checkpoint_shape`) for
    :func:`selective_scan_bwd`, otherwise None.  Launches the kernel once
    on ``tuner``'s geometry and counts it in ``selective_scan.launches``
    (and, with checkpoints, in ``selective_scan.checkpoint_launches``)."""
    _check(xs, dt, bb, cc, a, d, h0)
    b, t, din = xs.shape
    n = a.shape[-1]
    p = _config(tuner, xs.device, t, din, n).params
    geo = geometry(b, din, n, channels=p["channels"])
    if xs.stride(-1) != 1:
        xs = xs.contiguous()
    dt, bb, cc = dt.contiguous(), bb.contiguous(), cc.contiguous()
    a, d, h0 = a.contiguous(), d.contiguous(), h0.contiguous()
    dev = xs.device
    y = torch.empty((b, t, din), dtype=torch.float32, device=dev)
    h_t = torch.empty((b, din, n), dtype=torch.float32, device=dev)
    ckpt = (torch.empty(checkpoint_shape(b, t, din, n), dtype=torch.float32,
                        device=dev) if checkpoints else None)
    launch(_lib(tuning.defines("selective_scan", p, "selective_scan")), xs,
           dt, bb, cc, a, d, h0, y, h_t, geo, stages=p["stages"], ckpt=ckpt)
    selective_scan.launches += 1
    if checkpoints:
        selective_scan.checkpoint_launches += 1
    return y, h_t, ckpt


selective_scan.launches = 0
selective_scan.checkpoint_launches = 0


def selective_scan_bwd(xs: torch.Tensor, dt: torch.Tensor,
                       bb: torch.Tensor, cc: torch.Tensor, a: torch.Tensor,
                       d: torch.Tensor, ckpt: torch.Tensor, dy: torch.Tensor,
                       dh_t: Optional[torch.Tensor] = None, *,
                       geo: Optional[BwdGeometry] = None,
                       lib: Optional[ctypes.CDLL] = None,
                       tuner: Optional[tuning.KernelTuner] = None):
    """Gradients of :func:`selective_scan` from its inputs, its checkpoints
    ``ckpt``, the gradient ``dy`` of y (B, T, din) and (optionally, zeros
    when None) ``dh_t`` of the final state, all f32 on one CUDA device:
    ``(dxs, ddt, dbb, dcc, da, dd, dh0)`` in f32 with the shapes of ``xs,
    dt, bb, cc, a, d`` and h0, the semantics of
    :func:`repro_torch.kernels.ref.selective_scan_bwd` at
    :func:`bwd_geometry`'s segment count.  Launches on that geometry the
    replay (:func:`selective_scan_bwd_replay`), the walk back (counted in
    ``selective_scan_bwd.launches``), then :func:`selective_scan_bwd_sum`:
    three launches a call, on ``tuner``'s geometry and build.  ``geo``
    (another :func:`bwd_geometry`) and ``lib`` (a build of this source
    with other knobs) are the bench's sweep."""
    b, t, din = xs.shape
    n = a.shape[-1]
    if ckpt.shape != checkpoint_shape(b, t, din, n) or \
            ckpt.dtype != torch.float32:
        raise ValueError(f"ckpt must be the forward's f32 checkpoints "
                         f"{checkpoint_shape(b, t, din, n)}, got "
                         f"{ckpt.dtype} {tuple(ckpt.shape)}")
    _check(xs, dt, bb, cc, a, d, ckpt[:, 0])
    if dy.shape != (b, t, din) or dy.dtype != torch.float32 or \
            dy.device != xs.device:
        raise ValueError(f"dy must be f32 {(b, t, din)} on {xs.device}, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if dh_t is not None and (dh_t.shape != (b, din, n)
                             or dh_t.dtype != torch.float32
                             or dh_t.device != xs.device):
        raise ValueError(f"dh_t must be f32 {(b, din, n)} on {xs.device}, "
                         f"got {dh_t.dtype} {tuple(dh_t.shape)}")
    p = _config(tuner, xs.device, t, din, n).params
    if geo is None:
        geo = _bwd_geometry(p, b, t, din, n)
    if xs.stride(-1) != 1:
        xs = xs.contiguous()
    dt, bb, cc, a, d = (v.contiguous() for v in (dt, bb, cc, a, d))
    ckpt, dy = ckpt.contiguous(), dy.contiguous()
    if dh_t is not None:
        dh_t = dh_t.contiguous()
    if lib is None:
        lib = _lib(tuning.defines("selective_scan", p, "selective_scan"))
        sub = p["bwd_sub"]
    else:
        sub = lib.selective_scan_bwd_knobs(0)
    sxb, sxt = xs.stride(0), xs.stride(1)
    ptrs = [v.data_ptr() for v in (xs, dt, bb, cc, dy)]
    bits = bwd_route((ptrs[0] % ALIGN, ptrs[1] % ALIGN,
                      (ptrs[2] | ptrs[3]) % ALIGN, ptrs[4] % ALIGN), b, t,
                     din, n, geo.states * geo.lanes, sxb, sxt)
    starts, carries = selective_scan_bwd_replay(xs, dt, bb, cc, a, ckpt, dy,
                                                geo, bits, sub, lib)
    f32 = dict(dtype=torch.float32, device=xs.device)
    dx = torch.empty((b, t, din), **f32)
    dd_part = torch.empty((b, geo.segments, din), **f32)
    da_part = torch.empty((b, geo.segments, din, n), **f32)
    dh0 = torch.empty((b, din, n), **f32)
    partial = torch.empty((b, geo.grid[0], t,
                           2 * geo.states * geo.lanes + 1), **f32)
    _build.call(lib, "selective_scan_bwd", xs.device, ptrs[0], sxb, sxt,
                ptrs[1], ptrs[2], ptrs[3], a.data_ptr(), d.data_ptr(),
                ptrs[4], dh_t.data_ptr() if dh_t is not None else None,
                starts.data_ptr(), carries.data_ptr(), dx.data_ptr(),
                dd_part.data_ptr(), da_part.data_ptr(), dh0.data_ptr(),
                partial.data_ptr(), b, t, din, n, geo.states, geo.lanes,
                geo.channels, geo.segment_steps // CHUNK, geo.segments, bits)
    selective_scan_bwd.launches += 1
    ddt, dbb, dcc, da, dd = selective_scan_bwd_sum(partial, da_part, dd_part,
                                                   n, lib)
    return dx, ddt, dbb, dcc, da, dd, dh0


selective_scan_bwd.launches = 0


def selective_scan_bwd_replay(xs, dt, bb, cc, a, ckpt, dy, geo: BwdGeometry,
                              bits: int, sub: int = SUB,
                              lib: Optional[ctypes.CDLL] = None):
    """The backward's first launch, for :func:`selective_scan_bwd` (its
    operands already checked and contiguous, ``bits`` of
    :func:`bwd_route`): each segment replayed from its checkpoints into
    ``starts`` (:func:`bwd_starts_shape`), and its decay product and local
    carry into ``carries`` (2, B, segments, din, n), both returned.
    Counted in ``selective_scan_bwd_replay.launches``."""
    b, t, din = xs.shape
    n = a.shape[-1]
    f32 = dict(dtype=torch.float32, device=xs.device)
    starts = torch.empty(bwd_starts_shape(geo, sub), **f32)
    carries = torch.empty((2, b, geo.segments, din, n), **f32)
    _build.call(_lib() if lib is None else lib, "selective_scan_bwd_replay",
                xs.device, xs.data_ptr(), xs.stride(0), xs.stride(1),
                dt.data_ptr(), bb.data_ptr(), cc.data_ptr(), a.data_ptr(),
                ckpt.data_ptr(), dy.data_ptr(), starts.data_ptr(),
                carries.data_ptr(), b, t, din, n, geo.states, geo.lanes,
                geo.channels, geo.segment_steps // CHUNK, geo.segments, bits)
    selective_scan_bwd_replay.launches += 1
    return starts, carries


selective_scan_bwd_replay.launches = 0


def selective_scan_bwd_sum(partial: torch.Tensor, da_part: torch.Tensor,
                           dd_part: torch.Tensor, n: int,
                           lib: Optional[ctypes.CDLL] = None):
    """The backward's second launch: ``partial`` (B, blocks, T, 2 NP + 1)
    added over the channel blocks in block order into ``ddt`` (B, T),
    ``dbb`` and ``dcc`` (B, T, n); ``da_part`` (B, segments, din, n) and
    ``dd_part`` (B, segments, din) over the batch rows and segments, in
    row order, into ``da`` and ``dd``.  Counted in
    ``selective_scan_bwd_sum.launches``."""
    b, blocks, t, width = partial.shape
    segments, din = dd_part.shape[1:]
    f32 = dict(dtype=torch.float32, device=partial.device)
    ddt = torch.empty((b, t), **f32)
    dbb = torch.empty((b, t, n), **f32)
    dcc = torch.empty((b, t, n), **f32)
    da = torch.empty((din, n), **f32)
    dd = torch.empty((din,), **f32)
    _build.call(_lib() if lib is None else lib, "selective_scan_bwd_sum",
                partial.device, partial.data_ptr(), da_part.data_ptr(),
                dd_part.data_ptr(), ddt.data_ptr(), dbb.data_ptr(),
                dcc.data_ptr(), da.data_ptr(), dd.data_ptr(), b, t, din, n,
                (width - 1) // 2, blocks, segments)
    selective_scan_bwd_sum.launches += 1
    return ddt, dbb, dcc, da, dd


selective_scan_bwd_sum.launches = 0


def kernel_knobs() -> dict:
    """The backward's compile-time knobs as built: steps a sub-chunk,
    compute threads a block and blocks an SM of the walk's and the
    replay's register caps (must equal :data:`SUB`,
    :data:`BWD_MAX_THREADS`, :data:`BWD_MIN_BLOCKS` and
    :data:`BWD_REPLAY_MIN_BLOCKS` in the port's build).  Needs the
    card."""
    lib = _lib()
    return {"sub": lib.selective_scan_bwd_knobs(0),
            "max_threads": lib.selective_scan_bwd_knobs(1),
            "min_blocks": lib.selective_scan_bwd_knobs(2),
            "replay_min_blocks": lib.selective_scan_bwd_knobs(3)}


def kernel_chunk() -> int:
    """The kernel's steps a chunk as compiled (must equal :data:`CHUNK`).
    Needs the card."""
    return _lib().selective_scan_chunk()
