"""Builds the CUDA C++ kernels with ``nvcc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions (pointers, ints, floats
and a stream) and becomes its own ``lib<name>-<hash>.so`` for ``sm_90a``
in :data:`BUILD_DIR` (listed in ``.gitignore``), keyed by a hash of the
source and of every header in ``csrc/`` (``*.cuh``, which the sources
include), so an edited kernel or header is rebuilt.  Nothing is built at import: the
first launch builds what it needs, and :func:`build_all` builds every
source in parallel (one ``nvcc`` per file, all started together).

The C functions return ``cudaGetLastError()`` after the launch;
:func:`check` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) is never silent.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build_out"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # nvcc's stderr (ptxas -v) per source


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source on the machine with the card")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    os.replace(tmp, _target(name))      # atomic: concurrent builders agree


def build_all() -> float:
    """Build every kernel source, all ``nvcc`` runs in parallel; returns
    the wall seconds (0 when everything was already built)."""
    t0 = time.perf_counter()
    procs = {name: _start(name) for name in sources()}
    for name, proc in procs.items():
        _finish(name, proc)
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use),
    with ``signatures = {fn: (argtypes, restype)}`` applied.  Every source
    also exports ``const char* cuda_error_string(int)``."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
