"""Hymba's selective-scan kernel, the parts the CPU reaches: its launch
geometry, the route of each operand's copies, the ``ctypes`` binding
against the source, and a numpy model of the kernel's arithmetic (states
a lane, the lanes' transpose-reduce over groups of steps, a ragged group
run with dt = 0) against the plain twin.

The twin itself is held against JAX's ``_ssm_scan`` in
tests/test_torch_hymba.py, and the CUDA kernel against the twin on the
card in tests/test_torch_cuda.py and ``chip_smoke.py``.  Tolerance: the
model sums the states in the kernel's order, the twin in its own, both in
f32, so y and h_T agree to 1e-5.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import selective_scan as scan

MODEL_TOL = 1e-5


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def _owners(batch, din, n, geo):
    """For every (batch row, channel, state) the (block, thread, register)
    triples that own it, by the kernel's mapping: lane ``q`` of warp ``w``
    of block ``(bx, by)`` holds channel ``bx * C + w * (32 / L) + q % (32 /
    L)`` and, in register ``r``, state ``q // (32 / L) * R + r``; the count
    of owners of each."""
    gx, gy = geo.grid
    bx, by, i, r = np.meshgrid(np.arange(gx), np.arange(gy),
                               np.arange(geo.threads),
                               np.arange(geo.states), indexing="ij")
    w, q, spread = i // 32, i % 32, 32 // geo.lanes
    ch = bx * geo.channels + w * spread + q % spread
    s = q // spread * geo.states + r
    live = (ch < din) & (s < n)
    count = np.zeros((batch, din, n), np.int64)
    np.add.at(count, (by[live], ch[live], s[live]), 1)
    return count


@pytest.mark.parametrize("din", [33, 40, 1600])
@pytest.mark.parametrize("n", [1, 3, 5, 8, 16, 17, 32])
def test_scan_geometry_gives_every_state_one_owner(n, din):
    """Every (batch, channel, state) has exactly one (block, lane,
    register slot); a channel's lanes lie in one warp;
    the block is whole warps within the kernel's limit, and the pair
    (states, lanes) is one the library is compiled for."""
    batch = 2
    geo = scan.geometry(batch, din, n)
    assert (_owners(batch, din, n, geo) == 1).all()
    assert geo.states * geo.lanes >= n > geo.states * geo.lanes // 2
    assert 32 % geo.lanes == 0          # a channel never straddles warps
    spread = 32 // geo.lanes
    for ch in range(min(din, geo.channels)):    # block 0's channels
        lanes = [w * 32 + q for w in range(geo.threads // 32)
                 for q in range(32) if w * spread + q % spread == ch]
        assert len(lanes) == geo.lanes and lanes[-1] // 32 == lanes[0] // 32
    assert geo.threads % 32 == 0 and geo.threads <= scan.MAX_THREADS
    assert geo.channels % 4 == 0        # x rows start on 16 bytes
    assert (geo.states, geo.lanes) in scan.INSTANCES
    assert geo.grid == (-(-din // geo.channels), batch)


def test_scan_geometry_at_hymba_width():
    """hymba-1.5b (din 1600, n 16) at batch 4: 4 states a lane, 4 lanes
    a channel, blocks of ``CHANNELS_PER_BLOCK`` channels; the bench's
    sweep knobs (states a lane, channels a block) give every state one
    owner too."""
    geo = scan.geometry(4, 1600, 16)
    c = scan.CHANNELS_PER_BLOCK
    assert geo == scan.Geometry(4, 4, c, 4 * c, (-(-1600 // c), 4))
    for states in (2, 4, 8):
        for channels in (8, 16, 32, 64):
            g = scan.geometry(4, 1600, 16, states, channels)
            if g.threads <= scan.MAX_THREADS:
                assert (_owners(4, 1600, 16, g) == 1).all()
    with pytest.raises(ValueError, match="n <= 32"):
        scan.geometry(1, 8, 33)


def test_scan_instances_are_the_ones_geometry_takes():
    """The library compiles exactly the (states, lanes) pairs that the
    default geometry takes for n 1-32; the sweep's others are built only
    under ``SCAN_SWEEP_INSTANCES``, and the ring holds ``STAGES``."""
    taken = {(g.states, g.lanes) for g in
             (scan.geometry(1, 64, n) for n in range(1, scan.MAX_STATE + 1))}
    assert taken == set(scan.INSTANCES)
    src = (_build.CSRC / "selective_scan.cu").read_text()
    body = src[src.index("switch (states * 100 + lanes)"):]
    always, _, sweep = body.partition("#ifdef SCAN_SWEEP_INSTANCES")
    compiled = set(re.findall(r"launch<(\d+), (\d+)>", always))
    assert compiled == {(str(r), str(ln)) for r, ln in scan.INSTANCES}
    assert "#endif" in sweep and re.search(r"launch<\d+, \d+>", sweep)
    assert f"constexpr int kMaxStages = {scan.STAGES};" in src


@pytest.mark.parametrize("case", [
    # (pointer offsets xs, dt, bb|cc; B, T, din, n, sxb, sxt) -> bits
    ((0, 0, 0), 4, 2048, 1600, 16, 2048 * 3200, 3200,
     scan.BULK_DT | scan.BULK_BC | scan.VEC_X),     # the model's prefill
    ((0, 0, 0), 4, 1, 1600, 16, 3200, 3200,
     scan.BULK_BC | scan.VEC_X),                     # a decode step
    ((4, 0, 0), 4, 1, 1600, 16, 1600, 1600,
     scan.BULK_BC),                                   # xs one float off
    ((0, 0, 0), 1, 70, 33, 5, 70 * 33, 33, 0),        # din 33, n 5
    ((0, 0, 8), 2, 36, 40, 8, 36 * 40, 40,
     scan.BULK_DT | scan.VEC_X),                     # bb 8 bytes off
    ((0, 0, 0), 3, 37, 100, 8, 37 * 200, 200,
     scan.BULK_BC | scan.VEC_X),                     # T 37: dt ragged
    ((0, 0, 0), 3, 37, 100, 5, 37 * 200, 200,
     scan.VEC_X),                                    # n 5: B, C padded
    ((0, 0, 0), 2, 36, 64, 17, 36 * 64, 66, scan.BULK_DT),   # n 17, sxt 66
])
def test_scan_route_takes_bulk_copies_only_where_aligned(case):
    """dt, B and C go by ``cp.async.bulk`` and x by 16-byte copies only
    if every chunk (row) of them starts on 16 bytes and spans a multiple
    of 16 bytes (a bulk copy whose start is not aligned never lands); the
    others by 4-byte copies."""
    mis, b, t, din, n, sxb, sxt, want = case
    padded = 1 << (n - 1).bit_length()
    assert scan.route(mis, b, t, din, n, padded, sxb, sxt) == want


# --------------------------------------------------------------------------
# the binding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["selective_scan_fwd", "selective_scan_chunk",
                                "selective_scan_fwd_ckpt",
                                "selective_scan_bwd_replay",
                                "selective_scan_bwd",
                                "selective_scan_bwd_sum",
                                "selective_scan_bwd_smem",
                                "selective_scan_bwd_knobs"])
def test_scan_signatures_match_the_source(fn):
    """Every C function the ``ctypes`` binding declares is an ``extern
    "C"`` function of ``csrc/selective_scan.cu`` with as many parameters
    as the binding's argument types (the stream included); the source
    compiles every (states, lanes) pair of ``INSTANCES`` and its chunk and
    block limit are the wrapper's."""
    assert sorted(scan._SIGNATURE) == [
        "selective_scan_bwd", "selective_scan_bwd_knobs",
        "selective_scan_bwd_replay", "selective_scan_bwd_smem",
        "selective_scan_bwd_sum", "selective_scan_chunk",
        "selective_scan_fwd", "selective_scan_fwd_ckpt"]
    src = (_build.CSRC / "selective_scan.cu").read_text()
    found = re.findall(r'extern "C" int ' + fn + r'\(\s*([^)]*)\)', src)
    assert len(found) == 1, fn
    argtypes, _ = scan._SIGNATURE[fn]
    params = [p for p in found[0].split(",") if p.strip()]
    assert len(params) == len(argtypes)
    for r, lanes in scan.INSTANCES:
        assert f"launch<{r}, {lanes}>(p, st)" in src
    assert f"constexpr int kChunk = {scan.CHUNK};" in src
    assert f"constexpr int kMaxConsumers = {scan.MAX_THREADS};" in src
    bits = dict(kBulkDt=scan.BULK_DT, kBulkBC=scan.BULK_BC,
                kVecX=scan.VEC_X)
    assert ("constexpr int " + ", ".join(f"{k} = {v}" for k, v in
                                         bits.items()) + ";") in src


def test_scan_backward_constants_match_the_source():
    """The backward's knobs are the kernel's: the sub-chunk, the block's
    compute threads and the blocks an SM of the walk's and the replay's
    register caps (the build's defaults of its macros), the ring depth and
    dy's route bit; it is compiled for every (states, lanes) pair of
    ``INSTANCES`` and no other, for both of its launches."""
    src = (_build.CSRC / "selective_scan.cu").read_text()
    assert f"#define SCAN_BWD_SUB {scan.SUB}\n" in src
    assert f"#define SCAN_BWD_MAX_CONSUMERS {scan.BWD_MAX_THREADS}\n" in src
    assert f"#define SCAN_BWD_MIN_BLOCKS {scan.BWD_MIN_BLOCKS}\n" in src
    assert (f"#define SCAN_BWD_REPLAY_MIN_BLOCKS "
            f"{scan.BWD_REPLAY_MIN_BLOCKS}\n") in src
    assert f"constexpr int kBwdStages = {scan.BWD_STAGES};" in src
    assert f"constexpr int kVecDy = {scan.VEC_DY};" in src
    assert scan.CHUNK % scan.SUB == 0
    assert scan.MAX_SEGMENTS >= 1 and scan.SEGMENT_CHUNKS >= 1
    assert "selective_scan_bwd_replay_kernel<R, L><<<" in src
    assert "selective_scan_bwd_kernel<R, L><<<" in src
    assert scan.BWD_MAX_THREADS % 32 == 0
    assert scan.BWD_MAX_THREADS <= scan.MAX_THREADS
    body = src[src.index('static int bwd('):]
    body = body[:body.index("default:")]
    assert set(re.findall(r"launch_bwd<(\d+), (\d+)>", body)) == {
        (str(r), str(ln)) for r, ln in scan.INSTANCES}


@pytest.mark.parametrize("b,t,din,n", [(2, 2048, 1600, 16), (4, 1, 1600, 16),
                                       (1, 37, 33, 5), (3, 64, 40, 8),
                                       (2, 65, 64, 32), (1, 130, 8, 1)])
def test_scan_checkpoint_and_partial_shapes(b, t, din, n):
    """The forward's checkpoints hold the state at the start of each chunk
    and the final one; the backward's partials hold, for each channel
    block of a batch row and each step, dB and dC over the padded states
    and ddt; its scratch holds each lane's state at the start of every
    ``SUB`` steps of its segment; its shared memory fits a block (227 KB)
    at every state size, and at hymba's width ``BWD_MIN_BLOCKS`` blocks
    fit an SM (228 KB, 1 KB of it kept for each block), as the register
    cap assumes."""
    chunks = -(-t // scan.CHUNK)
    assert scan.checkpoint_shape(b, t, din, n) == (b, chunks + 1, din, n)
    geo = scan.bwd_geometry(b, t, din, n)
    np_ = geo.states * geo.lanes
    assert scan.partial_shape(b, t, din, n) == (b, geo.grid[0], t,
                                                2 * np_ + 1)
    smem = scan.bwd_smem_bytes(geo)
    warps = geo.threads // 32
    stages = scan.BWD_STAGES * (2 * scan.CHUNK * geo.channels
                                + 2 * scan.CHUNK * np_ + scan.CHUNK)
    assert smem == 4 * (stages + 2 * warps * scan.SUB * (2 * np_ + 1))
    assert scan.bwd_smem_bytes(geo, replay=True) == 4 * stages
    assert smem <= 232448 and smem % 16 == 0
    starts = scan.bwd_starts_shape(geo)
    assert starts == (b, geo.segments, geo.grid[0],
                      geo.segment_steps // scan.SUB, geo.threads,
                      geo.states)
    # every sub-chunk of every segment has its start (a ragged last
    # segment leaves some unused)
    assert starts[1] * starts[3] * scan.SUB >= t
    if (din, n) == (1600, 16):
        assert scan.BWD_MIN_BLOCKS * (smem + 1024) <= 233472
        assert scan.BWD_REPLAY_MIN_BLOCKS * (4 * stages + 1024) <= 233472
    assert scan.partial_shape(b, t, din, n, 16)[1] == -(-din // max(
        16, 32 // geo.lanes))


def _bwd_owners(batch, t, din, n, geo):
    """For every (batch row, channel, state, step) the count of (block,
    thread, register) triples whose walk covers it: lanes and registers as
    :func:`_owners`, and block ``(bx, by, z)`` the steps of segment z,
    ``[z * segment_steps, min(T, (z + 1) * segment_steps))``."""
    gx, gy, gz = geo.grid
    count = np.zeros((batch, din, n, t), np.int64)
    flat = scan.Geometry(geo.states, geo.lanes, geo.channels, geo.threads,
                         (gx, gy))
    per_row = _owners(batch, din, n, flat)       # (batch, din, n)
    for z in range(gz):
        lo, hi = z * geo.segment_steps, min(t, (z + 1) * geo.segment_steps)
        count[..., lo:hi] += per_row[..., None]
    return count


@pytest.mark.parametrize("t", [1, 37, 64, 65, 300, 1088, 2048, 4160])
@pytest.mark.parametrize("n", [1, 3, 5, 8, 16, 17, 32])
def test_scan_bwd_geometry_gives_every_state_and_step_one_owner(n, t):
    """The backward's launches: every (batch, channel, state, step) has
    exactly one (block, lane, register), every segment starts on a
    checkpoint (a whole number of chunks) and none is empty, at most
    ``MAX_SEGMENTS`` of them; the twin's cut for the same count is the
    kernel's; a block is whole warps within the build's limit, of a
    (states, lanes) pair the library compiles."""
    batch, din = 2, 40
    geo = scan.bwd_geometry(batch, t, din, n)
    assert (_bwd_owners(batch, t, din, n, geo) == 1).all()
    chunks = -(-t // scan.CHUNK)
    assert geo.segment_steps % scan.CHUNK == 0
    assert 1 <= geo.segments <= scan.MAX_SEGMENTS
    assert (geo.segments - 1) * geo.segment_steps < t
    assert geo.segment_steps == -(-chunks // geo.segments) * scan.CHUNK
    assert geo.segments == geo.grid[2]
    assert geo.threads % 32 == 0 and geo.threads <= scan.BWD_MAX_THREADS
    assert (geo.states, geo.lanes) in scan.INSTANCES
    assert geo.grid[:2] == (-(-din // geo.channels), batch)


def test_scan_bwd_geometry_at_hymba_width():
    """hymba-1.5b's training shape (B 2 x T 2048, din 1600, n 16): 32
    chunks in 16 segments of ``SEGMENT_CHUNKS`` (2) chunks, blocks of 32
    channels; a short T gives one segment (T 37 is one chunk); T 300 (5
    chunks) three, the last of one chunk; T 1088 (17 chunks) nine; longer
    T keeps ``MAX_SEGMENTS`` (32) segments of more chunks; the knobs of
    the bench's sweep give every state and step one owner too."""
    geo = scan.bwd_geometry(2, 2048, 1600, 16)
    c = scan.BWD_CHANNELS_PER_BLOCK
    assert (scan.SEGMENT_CHUNKS, scan.MAX_SEGMENTS) == (2, 32)
    assert geo == scan.BwdGeometry(4, 4, c, 16, 128, 4 * c,
                                   (-(-1600 // c), 2, 16))
    assert scan.bwd_geometry(2, 37, 1600, 16)[3:5] == (1, 64)
    assert scan.bwd_geometry(2, 300, 1600, 16)[3:5] == (3, 128)
    assert scan.bwd_geometry(1, 1088, 1600, 16)[3:5] == (9, 128)
    assert scan.bwd_geometry(1, 8192, 1600, 16)[3:5] == (32, 256)
    for sc in (1, 4, 8, 16, 32):
        for c, threads in ((16, 128), (32, 128), (64, 256)):
            g = scan.bwd_geometry(1, 2048, 64, 16, c, sc, threads)
            assert g.threads <= threads
            assert (_bwd_owners(1, 2048, 64, 16, g) == 1).all()


def test_scan_checkpoints_hold_the_twins_chunk_states():
    """A model of the forward's checkpoints on the twin (the state after
    every ``CHUNK`` steps, the first h0, the last h_T) replays, chunk by
    chunk from each, the states of the whole scan: what the backward
    kernel and ``ref.selective_scan_bwd`` rely on (states equal bitwise:
    the same f32 operations from the same bits)."""
    rng = np.random.default_rng(3)
    b, t, din, n = 2, 2 * scan.CHUNK + 5, 6, 5
    f = np.float32
    xs = torch.from_numpy(rng.standard_normal((b, t, din)).astype(f))
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((b, t)) - 1.0)).astype(f))
    bb, cc = (torch.from_numpy(rng.standard_normal((b, t, n)).astype(f))
              for _ in range(2))
    a = torch.from_numpy((-np.exp(0.5 * rng.standard_normal((din, n))))
                         .astype(f))
    d = torch.from_numpy(rng.standard_normal(din).astype(f))
    h0 = torch.from_numpy((0.5 * rng.standard_normal((b, din, n))).astype(f))
    ckpt = [h0]
    for k in range(0, t, scan.CHUNK):
        end = min(k + scan.CHUNK, t)
        ckpt.append(ref.selective_scan(xs[:, k:end], dt[:, k:end],
                                       bb[:, k:end], cc[:, k:end], a, d,
                                       ckpt[-1])[1])
    assert len(ckpt) == scan.checkpoint_shape(b, t, din, n)[1]
    _, h_t = ref.selective_scan(xs, dt, bb, cc, a, d, h0)
    assert torch.equal(ckpt[-1], h_t)


@pytest.mark.parametrize("case", [
    # (pointer offsets xs, dt, bb|cc, dy; B, T, din, n, sxb, sxt) -> bits
    ((0, 0, 0, 0), 2, 2048, 1600, 16, 2048 * 3200, 3200,
     scan.BULK_DT | scan.BULK_BC | scan.VEC_X | scan.VEC_DY),  # training
    ((4, 0, 0, 4), 2, 40, 64, 16, 40 * 64, 64,
     scan.BULK_DT | scan.BULK_BC),                  # xs and dy one float off
    ((0, 0, 0, 0), 1, 70, 33, 5, 70 * 33, 33, 0),   # din 33: 4-byte rows
])
def test_scan_backward_route(case):
    """The backward's copies: the forward's route for xs, dt, B and C, and
    dy by 16-byte copies only where it and its rows are 16-byte aligned."""
    mis, b, t, din, n, sxb, sxt, want = case
    padded = 1 << (n - 1).bit_length()
    assert scan.bwd_route(mis, b, t, din, n, padded, sxb, sxt) == want


def test_scan_bwd_refuses_bad_operands_before_the_build(monkeypatch):
    """The backward's wrapper checks the checkpoints' and gradients' shapes
    before it loads (or builds) the library."""
    def no_build():
        raise AssertionError("the library was loaded before the checks")

    monkeypatch.setattr(scan, "_lib", no_build)
    x = [torch.zeros(s) for s in ((2, 3, 8), (2, 3), (2, 3, 4), (2, 3, 4),
                                  (8, 4), (8,))]
    ckpt = torch.zeros(scan.checkpoint_shape(2, 3, 8, 4))
    dy = torch.zeros(2, 3, 8)
    before = scan.selective_scan_bwd.launches
    with pytest.raises(ValueError, match="checkpoints"):
        scan.selective_scan_bwd(*x, ckpt[:, :1], dy)
    with pytest.raises(ValueError, match="CUDA"):
        scan.selective_scan_bwd(*x, ckpt, dy)
    assert scan.selective_scan_bwd.launches == before


def test_scan_refuses_cpu_tensors_before_the_build(monkeypatch):
    """The wrapper checks shapes, dtypes and devices before it loads (or
    builds) the library: CPU operands raise, and never run the twin."""
    def no_build():
        raise AssertionError("the library was loaded before the checks")

    monkeypatch.setattr(scan, "_lib", no_build)
    x = [torch.zeros(s) for s in ((2, 3, 8), (2, 3), (2, 3, 4), (2, 3, 4),
                                  (8, 4), (8,), (2, 8, 4))]
    before = scan.selective_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        scan.selective_scan(*x)
    with pytest.raises(ValueError, match="h0"):
        scan.selective_scan(*x[:6], torch.zeros(2, 8, 3))
    with pytest.raises(TypeError, match="f32"):
        scan.selective_scan(x[0].double(), *x[1:])
    assert scan.selective_scan.launches == before


# --------------------------------------------------------------------------
# the kernel's arithmetic, modelled in f32
# --------------------------------------------------------------------------

def _transpose_sum(p, lanes):
    """The kernel's transpose-reduce: ``p[..., l, j]`` is lane l's part of
    step j's sum (j < lanes); returns ``[..., l]``, lane l's total of step
    l, summed pairwise as the shuffle rounds do."""
    idx = np.arange(lanes)
    o = lanes // 2
    while o:
        hi = (idx & o).astype(bool)[:, None]

        def half(v, hi=hi, o=o):        # the upper half where l & o
            return np.where(hi, v[..., o:2 * o], v[..., :o])

        p = half(p) + half(p[..., idx ^ o, :])     # kept + received
        o //= 2
    return p[..., 0]


def _kernel_model(xs, dt, bb, cc, a, d, h0, geo):
    """The kernel's f32 arithmetic over (B, din): a lane's R states in
    registers, ``h = fma(decay, h, (dt x) b)`` and its partial
    ``fma(h, c, acc)`` over its states in order, the transpose-reduce over
    groups of L steps, y = sum + D x; a ragged last group runs its dead
    steps with dt = 0 (and zeros for x, B, C)."""
    b, t, din = xs.shape
    n = a.shape[1]
    r, lanes = geo.states, geo.lanes
    np_ = r * lanes
    f = np.float32
    pad = lambda v, axis: np.concatenate(      # noqa: E731
        [v, np.zeros(v.shape[:axis] + (np_ - n,) + v.shape[axis + 1:], f)],
        axis=axis)
    a_p, h = pad(a, 1), pad(h0, 2)
    b_p, c_p = pad(bb, 2), pad(cc, 2)
    steps = -(-t // lanes) * lanes
    grow = lambda v: np.concatenate(            # noqa: E731
        [v, np.zeros((b, steps - t) + v.shape[2:], f)], axis=1)
    xs_, dt_, b_p, c_p = grow(xs), grow(dt[..., None])[..., 0], grow(b_p), \
        grow(c_p)
    y = np.zeros((b, steps, din), f)
    h = h.reshape(b, din, lanes, r)
    a_l = a_p.reshape(din, lanes, r)
    for g in range(0, steps, lanes):
        part = np.zeros((b, din, lanes, lanes), f)
        for j in range(lanes):
            dtt = dt_[:, g + j, None, None, None]
            dtx = dtt * xs_[:, g + j, :, None, None]
            bv = b_p[:, g + j].reshape(b, 1, lanes, r)
            cv = c_p[:, g + j].reshape(b, 1, lanes, r)
            decay = np.exp(a_l[None] * dtt).astype(f)
            acc = np.zeros((b, din, lanes), f)
            for k in range(r):
                h[..., k] = (decay[..., k].astype(np.float64)
                             * h[..., k] + (dtx[..., 0] * bv[..., k])
                             .astype(np.float64)).astype(f)
                acc = (h[..., k].astype(np.float64) * cv[..., k]
                       + acc).astype(f)
            part[..., j] = acc
        total = _transpose_sum(part, lanes)            # (b, din, lanes)
        y[:, g:g + lanes] = np.swapaxes(total, 1, 2) + d * xs_[:, g:g + lanes]
    return y[:, :t], h.reshape(b, din, np_)[..., :n]


@pytest.mark.parametrize("b,t,din,n", [(2, 9, 40, 16), (1, 37, 33, 5),
                                       (3, 1, 8, 32), (2, 23, 12, 17)])
def test_scan_kernel_model_matches_the_twin(b, t, din, n):
    """The kernel's order of operations (states a lane, the lanes'
    transpose-reduce over groups of L steps, dead steps of a ragged group
    at dt = 0) gives the twin's y and h_T within 1e-5, from a nonzero
    state; the dead steps leave h exactly as it was."""
    rng = np.random.default_rng(din + t + n)
    f = np.float32
    xs = rng.standard_normal((b, t, din)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, t)) - 1.0)).astype(f)
    bb, cc = (rng.standard_normal((b, t, n)).astype(f) for _ in range(2))
    a = (-np.exp(0.5 * rng.standard_normal((din, n)))).astype(f)
    d = rng.standard_normal(din).astype(f)
    h0 = (0.5 * rng.standard_normal((b, din, n))).astype(f)
    geo = scan.geometry(b, din, n)
    y, h_t = _kernel_model(xs, dt, bb, cc, a, d, h0, geo)
    want_y, want_h = ref.selective_scan(*(torch.from_numpy(v) for v in
                                          (xs, dt, bb, cc, a, d, h0)))
    np.testing.assert_allclose(y, want_y.numpy(), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    np.testing.assert_allclose(h_t, want_h.numpy(), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    # steps with dt = 0 (x, B and C random) leave h and the earlier y
    # bitwise as they were: what a ragged group's dead steps rely on
    grow = lambda v, fill: np.concatenate(      # noqa: E731
        [v, fill(v.shape[:1] + (3,) + v.shape[2:])], axis=1)
    rand = lambda shape: rng.standard_normal(shape).astype(f)  # noqa: E731
    zeros = lambda shape: np.zeros(shape, f)                    # noqa: E731
    y_z, h_z = _kernel_model(grow(xs, rand), grow(dt, zeros), grow(bb, rand),
                             grow(cc, rand), a, d, h0, geo)
    assert np.array_equal(h_z, h_t) and np.array_equal(y_z[:, :t], y)


def test_scan_transpose_sum_gives_each_lane_one_step():
    """After the rounds lane l holds the total over the L lanes of step
    l; a control with the rounds' halves swapped gives other sums."""
    rng = np.random.default_rng(0)
    for lanes in (1, 2, 4, 8):
        p = rng.standard_normal((3, lanes, lanes)).astype(np.float32)
        got = _transpose_sum(p, lanes)
        np.testing.assert_allclose(got, p.sum(axis=1), atol=1e-6,
                                   rtol=1e-6)
    p = rng.standard_normal((3, 4, 4)).astype(np.float32)
    assert not np.allclose(_transpose_sum(p[..., ::-1], 4), p.sum(axis=1))
