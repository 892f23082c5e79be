"""The kernels' tuning seam: one home for every launch and build knob.

Counterpart of ``repro.kernels.tuning``.  Every knob of the port's
hand-written kernels resolves through a three-tier lookup keyed by
``(backend, kernel, dtype, shape bucket)``:

1. **overrides**: a caller (a test, the sweep, a study) pins parameters
   through ``KernelTuner(overrides=...)`` or ``resolve(...,
   overrides=...)``;
2. **committed tables**: ``tuning_tables/<backend>.json``, which only the
   measured sweep (``repro_torch.benchmarks.autotune_kernels
   --write-table``) on the card writes;
3. **heuristics**: the constants the kernels shipped with, for any key the
   table does not name.  With no table the port launches and builds
   exactly what it did before the seam.

The backend is the tensor's: ``"sm90"`` for a CUDA tensor on a card of
compute capability (9, 0), ``"cpu"`` otherwise (:func:`backend_of`); no
global is probed.  A parameter is of one of two kinds.  A *launch*
parameter is passed to the C function at launch; a *build* parameter is a
``-D`` define of the kernel's source (:func:`defines`), so a config that
moves one loads a library built for it (``_build.load(...,
defines=...)``).  Limits of a kernel's layout (``MAX_DK``,
``MAX_HEAD_DIM``, ``VECTOR_BYTES``, ``ALIGN``, ``MAX_STATE``, the compiled
``INSTANCES``, ...) are not knobs and stay named constants in the
wrappers.

========================= ============================== ==================
kernel                    parameters (launch / build)    tuning shape
========================= ============================== ==================
``elementwise`` (B1, B2,  launch: ``ddim_threads``,      ``(n,)``: the DDIM
B4)                       ``resid_threads``,             call's elements, a
                          ``resid_max_cluster``,         residual's slice;
                          ``resid_slice_per_block``      bucket: next pow2
``flash`` (B3, B5)        build: ``fwd_block_n``,        ``(sq, sk, d)``
                          ``fwd_stages``,
                          ``bwd_block_n``, ``bwd_stages``
``rwkv6`` (B6, forward    launch: ``dv_sum_threads``;    ``(t, dk)``
and backward)             build: ``fwd_cols``,
                          ``bwd_rows``
``selective_scan``        launch: ``channels``,          ``(t, din, n)``
(forward; the backward's  ``stages``, ``bwd_channels``,
replay, walk and sum)     ``segment_chunks``,
                          ``max_segments``; build:
                          ``bwd_sub``, ``bwd_max_threads``,
                          ``bwd_min_blocks``,
                          ``bwd_replay_min_blocks``
========================= ============================== ==================

Buckets round each dimension up to a power of two (``elementwise`` its
element count), so a few entries cover a continuum of shapes; a key the
table does not name falls back to the heuristic tier.  A malformed table
raises :class:`TuningTableError` at its first lookup: a table ignored in
silence is how a tuned deployment runs default sizes.  Every value is
checked against the range its kernel allows (:data:`LIMITS`); the build
parameters' ranges are the ``static_assert``s of their sources.
"""
from __future__ import annotations

import dataclasses
import json
import os
import types
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "KernelConfig", "KernelTuner", "TuningTableError", "TABLE_SCHEMA_VERSION",
    "TABLE_DIR", "KERNELS", "BACKENDS", "LAUNCH_PARAMS", "BUILD_PARAMS",
    "LIMITS", "bucket_for", "next_pow2", "get_tuner", "set_tuner",
    "resolve", "pick_chunk", "sample_tile_rows", "validate_table",
    "backend_of", "defines", "default", "table_variants", "config",
]

TABLE_SCHEMA_VERSION = 1
TABLE_DIR = os.path.join(os.path.dirname(__file__), "tuning_tables")
KERNELS = ("elementwise", "flash", "rwkv6", "selective_scan")
BACKENDS = ("sm90", "cpu")

# launch parameters, passed to the C functions at launch
LAUNCH_PARAMS: Dict[str, Tuple[str, ...]] = {
    "elementwise": ("ddim_threads", "resid_threads", "resid_max_cluster",
                    "resid_slice_per_block"),
    "flash": (),
    "rwkv6": ("dv_sum_threads",),
    "selective_scan": ("channels", "stages", "bwd_channels",
                       "segment_chunks", "max_segments"),
}
# build parameters: param -> (csrc source, macro of that source)
BUILD_PARAMS: Dict[str, Dict[str, Tuple[str, str]]] = {
    "elementwise": {},
    "flash": {"fwd_block_n": ("flash_attention_fwd", "FLASH_FWD_BLOCK_N"),
              "fwd_stages": ("flash_attention_fwd", "FLASH_FWD_STAGES"),
              "bwd_block_n": ("flash_attention_bwd", "FLASH_BWD_BLOCK_N"),
              "bwd_stages": ("flash_attention_bwd", "FLASH_BWD_STAGES")},
    "rwkv6": {"fwd_cols": ("rwkv6_wkv", "WKV_FWD_COLS"),
              "bwd_rows": ("rwkv6_wkv", "WKV_BWD_ROWS")},
    "selective_scan": {
        "bwd_sub": ("selective_scan", "SCAN_BWD_SUB"),
        "bwd_max_threads": ("selective_scan", "SCAN_BWD_MAX_CONSUMERS"),
        "bwd_min_blocks": ("selective_scan", "SCAN_BWD_MIN_BLOCKS"),
        "bwd_replay_min_blocks": ("selective_scan",
                                  "SCAN_BWD_REPLAY_MIN_BLOCKS")},
}

# The heuristic tier: the constants each kernel shipped with (the sources'
# macro defaults for the build parameters), one row for every backend: the
# "cpu" backend never launches a kernel, so the CPU tests see the card's
# geometry.  The measurements behind them are in the wrappers' comments.
_DEFAULTS: Dict[str, Dict[str, int]] = {
    "elementwise": {"ddim_threads": 256, "resid_threads": 1024,
                    "resid_max_cluster": 8, "resid_slice_per_block": 4096},
    "flash": {"fwd_block_n": 64, "fwd_stages": 2, "bwd_block_n": 64,
              "bwd_stages": 2},
    "rwkv6": {"dv_sum_threads": 256, "fwd_cols": 32, "bwd_rows": 16},
    "selective_scan": {"channels": 64, "stages": 4, "bwd_channels": 32,
                       "segment_chunks": 2, "max_segments": 32,
                       "bwd_sub": 8, "bwd_max_threads": 128,
                       "bwd_min_blocks": 3, "bwd_replay_min_blocks": 4},
}

# param -> the values its kernel takes: (lowest, highest, step).  Threads
# are whole warps; the cluster is at most the portable 8; the flash ring's
# tile is the wgmma N of its layout (64) and its depth what fits the
# shared memory at head dim 128; the WKV kernels' layouts are fixed to
# their thread maps; the scan's ring holds at most 4 stages, its
# sub-chunks divide a 64-step chunk, its backward block at most 256
# compute threads.
LIMITS: Dict[str, Tuple[int, int, int]] = {
    "ddim_threads": (32, 256, 32), "resid_threads": (32, 1024, 32),
    "resid_max_cluster": (1, 8, 1), "resid_slice_per_block": (32, 1 << 20, 1),
    "fwd_block_n": (64, 64, 1), "fwd_stages": (2, 4, 1),
    "bwd_block_n": (64, 64, 1), "bwd_stages": (2, 3, 1),
    "dv_sum_threads": (32, 256, 32), "fwd_cols": (32, 32, 1),
    "bwd_rows": (16, 16, 1),
    "channels": (4, 256, 4), "stages": (1, 4, 1), "bwd_channels": (4, 256, 4),
    "segment_chunks": (1, 1 << 16, 1), "max_segments": (1, 1 << 16, 1),
    "bwd_sub": (1, 64, 1), "bwd_max_threads": (32, 256, 32),
    "bwd_min_blocks": (1, 16, 1), "bwd_replay_min_blocks": (1, 16, 1),
}
_SUB_DIVIDES = 64        # bwd_sub divides the scan's 64-step chunk


class TuningTableError(ValueError):
    """A tuning table failed validation: raised loudly, never skipped."""


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """A resolved configuration.

    ``source``: ``"override"`` (an explicit parameter won), ``"table"`` (a
    committed entry matched the whole key) or ``"heuristic"``.  ``key``:
    the ``(backend, kernel, dtype, bucket)`` lookup that produced it.
    ``params`` holds every parameter of the family, launch and build.
    """
    kernel: str
    params: Mapping[str, int]
    source: str
    key: Tuple[str, str, str, Tuple[int, ...]]


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (>= 1)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def bucket_for(kernel: str, shape: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """The bucket of a tuning shape: ``elementwise`` on its element count,
    the others per dimension; ``None`` is the empty bucket."""
    if shape is None:
        return ()
    dims = [int(d) for d in shape]
    if kernel == "elementwise":
        total = 1
        for d in dims:
            total *= max(1, d)
        return (next_pow2(total),)
    return tuple(next_pow2(d) for d in dims)


def _largest_divisor(n: int, cap: int) -> int:
    for c in range(min(int(cap), int(n)), 0, -1):
        if n % c == 0:
            return c
    return 1


def pick_chunk(t: int, cap: int = 32) -> int:
    """Largest divisor of ``t`` not exceeding ``cap`` (JAX's chunked WKV
    grid; kept for parity of the seam's helpers)."""
    return _largest_divisor(t, cap)


def sample_tile_rows(rows: int, cap: int) -> int:
    """Largest divisor of ``rows`` not exceeding ``cap`` (JAX's
    elementwise tiles; kept for parity of the seam's helpers)."""
    return _largest_divisor(rows, cap)


def _param_error(kernel: str, name: str, value) -> Optional[str]:
    """Why ``name=value`` is no parameter of ``kernel``, or None."""
    if name not in _DEFAULTS[kernel]:
        return (f"unknown parameter {name!r} of {kernel} (known: "
                f"{sorted(_DEFAULTS[kernel])})")
    if not isinstance(value, int) or isinstance(value, bool):
        return f"{name} must be an int, got {value!r}"
    lo, hi, step = LIMITS[name]
    if not (lo <= value <= hi and (value - lo) % step == 0):
        return (f"{name}={value} outside what the kernel takes "
                f"({lo}..{hi} in steps of {step})")
    if name == "bwd_sub" and _SUB_DIVIDES % value:
        return f"bwd_sub={value} does not divide {_SUB_DIVIDES}"
    return None


def validate_table(obj, path: str = "<table>") -> dict:
    """Validate a tuning-table payload; returns it or raises loudly."""
    def bad(msg):
        raise TuningTableError(f"tuning table {path}: {msg}")

    if not isinstance(obj, dict):
        bad(f"top level must be an object, got {type(obj).__name__}")
    if obj.get("version") != TABLE_SCHEMA_VERSION:
        bad(f"version must be {TABLE_SCHEMA_VERSION}, "
            f"got {obj.get('version')!r} (refresh the table with "
            f"repro_torch.benchmarks.autotune_kernels)")
    if not isinstance(obj.get("backend"), str):
        bad("missing/non-string 'backend'")
    entries = obj.get("entries")
    if not isinstance(entries, list):
        bad("'entries' must be a list")
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            bad(f"{where} must be an object")
        if e.get("kernel") not in KERNELS:
            bad(f"{where}: unknown kernel {e.get('kernel')!r} "
                f"(known: {KERNELS})")
        if not isinstance(e.get("dtype"), str):
            bad(f"{where}: missing/non-string 'dtype'")
        bucket = e.get("bucket")
        if not isinstance(bucket, list) or not all(
                isinstance(b, int) and not isinstance(b, bool) and b > 0
                for b in bucket):
            bad(f"{where}: 'bucket' must be a list of positive ints")
        params = e.get("params")
        if not isinstance(params, dict) or not params or not all(
                isinstance(k, str) and isinstance(v, int)
                and not isinstance(v, bool) and v > 0
                for k, v in params.items()):
            bad(f"{where}: 'params' must be a non-empty "
                f"{{name: positive int}} object")
        for name, value in params.items():
            why = _param_error(e["kernel"], name, value)
            if why:
                bad(f"{where}: {why}")
    return obj


def _dtype_name(dtype) -> str:
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


_BACKENDS: Dict[int, str] = {}


def backend_of(device) -> str:
    """The tuning backend of a tensor or device: ``"sm90"`` for CUDA on a
    capability (9, 0) card, ``"cpu"`` otherwise (asked once a card)."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    got = _BACKENDS.get(index)
    if got is None:
        cap = torch.cuda.get_device_capability(index)
        got = _BACKENDS[index] = "sm90" if tuple(cap) == (9, 0) else "cpu"
    return got


def default(kernel: str, name: str) -> int:
    """The heuristic tier's value of one parameter (the kernel's shipped
    constant; the source's macro default for a build parameter)."""
    return _DEFAULTS[kernel][name]


def defines(kernel: str, params: Mapping[str, int],
            source: str) -> Tuple[str, ...]:
    """The ``-D`` defines of ``source`` for ``params``: each build
    parameter of that source whose value is not the source's own default,
    sorted.  The heuristic config gives ``()``, the source's plain build."""
    out = []
    for name, (src, macro) in BUILD_PARAMS[kernel].items():
        if src == source and name in params and \
                params[name] != _DEFAULTS[kernel][name]:
            out.append(f"{macro}={int(params[name])}")
    return tuple(sorted(out))


class KernelTuner:
    """Resolves kernel parameters from overrides > tables > heuristics.

    Args:
      table_dir: directory of per-backend ``<backend>.json`` tables
        (default: the committed ``tuning_tables/``).  A missing file is
        an empty table; a malformed one raises :class:`TuningTableError`
        at the first resolve for that backend.
      tables: ``{backend: payload}`` tables (validated here), in place of
        ``table_dir``'s files for those backends: the tests' and the
        sweep's in-memory path.
      overrides: ``{kernel: {param: int}}`` pinned on top of whatever the
        table or heuristic tier resolves (checked against :data:`LIMITS`).

    A tuner is not changed after it is built: the wrappers cache its
    resolutions by key (:func:`config`).
    """

    def __init__(self, table_dir: Optional[str] = None,
                 tables: Optional[Mapping[str, dict]] = None,
                 overrides: Optional[Mapping[str, Mapping[str, int]]] = None):
        self.table_dir = TABLE_DIR if table_dir is None else table_dir
        self.overrides = {k: dict(v) for k, v in (overrides or {}).items()}
        for kernel, pinned in self.overrides.items():
            _check_overrides(kernel, pinned)
        self._tables: Dict[str, Optional[dict]] = {}
        for backend, payload in (tables or {}).items():
            self._tables[backend] = validate_table(
                payload, f"<tables[{backend!r}]>")

    def table(self, backend: str) -> Optional[dict]:
        """The validated table of ``backend``, or None when it has none."""
        if backend not in self._tables:
            path = os.path.join(self.table_dir, f"{backend}.json")
            if not os.path.exists(path):
                self._tables[backend] = None
            else:
                try:
                    with open(path) as f:
                        payload = json.load(f)
                except (OSError, json.JSONDecodeError) as e:
                    raise TuningTableError(
                        f"tuning table {path}: unreadable/invalid JSON "
                        f"({e})") from e
                self._tables[backend] = validate_table(payload, path)
        return self._tables[backend]

    def _lookup(self, backend: str, kernel: str, dtype: str,
                bucket: Tuple[int, ...]) -> Optional[Dict[str, int]]:
        table = self.table(backend)
        if table is None:
            return None
        for e in table["entries"]:
            if (e["kernel"] == kernel and e["dtype"] == dtype
                    and tuple(e["bucket"]) == bucket):
                return dict(e["params"])
        return None

    def resolve(self, kernel: str, *, backend: str, dtype=None,
                shape: Optional[Sequence[int]] = None,
                overrides: Optional[Mapping[str, int]] = None) -> KernelConfig:
        """Resolve ``kernel``'s parameters on ``backend`` (of
        :func:`backend_of`) for ``dtype`` and tuning ``shape`` (see the
        module docstring), bucketed before lookup.  An unknown key falls
        back to the heuristics; overrides (the instance's, then the
        call's) always win and mark the config ``source="override"``."""
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r} (known: {KERNELS})")
        if not isinstance(backend, str):
            raise ValueError("backend must be named: pass "
                             "backend=tuning.backend_of(tensor)")
        dt = _dtype_name(dtype)
        bucket = bucket_for(kernel, shape)
        params = dict(_DEFAULTS[kernel])
        source = "heuristic"
        from_table = self._lookup(backend, kernel, dt, bucket)
        if from_table is not None:
            params.update(from_table)
            source = "table"
        pinned = dict(self.overrides.get(kernel) or {})
        if overrides:
            _check_overrides(kernel, overrides)
            pinned.update(overrides)
        if pinned:
            params.update(pinned)
            source = "override"
        return KernelConfig(kernel=kernel,
                            params=types.MappingProxyType(params),
                            source=source, key=(backend, kernel, dt, bucket))


def _check_overrides(kernel: str, pinned: Mapping[str, int]) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"overrides for unknown kernel {kernel!r} "
                         f"(known: {KERNELS})")
    for name, value in pinned.items():
        why = _param_error(kernel, name, value)
        if why:
            raise ValueError(f"override of {kernel}: {why}")


_DEFAULT_TUNER: Optional[KernelTuner] = None


def get_tuner() -> KernelTuner:
    """The process-default tuner (committed tables + heuristics)."""
    global _DEFAULT_TUNER
    if _DEFAULT_TUNER is None:
        _DEFAULT_TUNER = KernelTuner()
    return _DEFAULT_TUNER


def set_tuner(tuner: Optional[KernelTuner]) -> None:
    """Install (or with ``None`` reset) the process-default tuner."""
    global _DEFAULT_TUNER
    _DEFAULT_TUNER = tuner


def resolve(kernel: str, **kwargs) -> KernelConfig:
    """``get_tuner().resolve(...)`` convenience."""
    return get_tuner().resolve(kernel, **kwargs)


_CONFIGS: Dict[tuple, KernelConfig] = {}


def config(kernel: str, tuner: Optional[KernelTuner], device, dtype,
           shape: Tuple[int, ...]) -> KernelConfig:
    """The wrappers' lookup: ``kernel``'s config for a launch on
    ``device`` at ``dtype`` and tuning ``shape`` through ``tuner`` (the
    process tuner when None), cached by the raw key so that a call adds
    one dict lookup."""
    t = get_tuner() if tuner is None else tuner
    key = (t, kernel, device, dtype, shape)
    got = _CONFIGS.get(key)
    if got is None:
        if len(_CONFIGS) > 4096:
            _CONFIGS.clear()
        got = _CONFIGS[key] = t.resolve(kernel, backend=backend_of(device),
                                        dtype=dtype, shape=shape)
    return got


def table_variants(backend: str = "sm90",
                   tuner: Optional[KernelTuner] = None):
    """The ``(source, defines)`` builds the table of ``backend`` names
    (its entries' build parameters), for ``_build.build_all`` to build
    before any timed work.  Empty without a table."""
    t = get_tuner() if tuner is None else tuner
    table = t.table(backend)
    out = set()
    for e in (table or {}).get("entries", ()):
        params = dict(_DEFAULTS[e["kernel"]], **e["params"])
        for name, (source, _) in BUILD_PARAMS[e["kernel"]].items():
            d = defines(e["kernel"], params, source)
            if d:
                out.add((source, d))
    return sorted(out)
