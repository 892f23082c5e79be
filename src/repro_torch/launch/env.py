"""Runtime platform configuration: the CUDA runtime's environment knobs in
one place, applied BEFORE CUDA initializes in the process.

Counterpart of ``repro.launch.env``.  :func:`configure_platform` is the
launch-time front door for the knobs a deployment (or an emitter) would
otherwise set by hand:

* ``platform``: ``"gpu"`` merges :data:`CUDA_PERF_ENV`, the port's
  performance preset; ``"cpu"`` hides the cards (``CUDA_VISIBLE_DEVICES``
  empty), JAX's pinned CPU backend.  The port's entry points pick their
  device by ``--device``; the emitters' parser routes it through here.
* ``alloc_conf``: ``{key: value}`` merged **key by key** into
  ``PYTORCH_CUDA_ALLOC_CONF`` (``key:value,key:value``): ours win on a
  conflict, every other key is kept, as JAX merges ``XLA_FLAGS``.
* ``allocator``: ``"native"`` (PyTorch's caching allocator) or
  ``"cudaMallocAsync"`` (the driver's pool), the alloc conf's
  ``backend``; ``"uncached"`` allocates and frees on demand
  (``PYTORCH_NO_CUDA_MEMORY_CACHING=1``), JAX's ``platform`` allocator.
* ``mem_fraction``: the per-process cap on the card's memory
  (``torch.cuda.set_per_process_memory_fraction``, applied last).
* ``log_level``: ``TORCH_CPP_LOG_LEVEL``, from JAX's 0-4 scale.

Like JAX's, it refuses once CUDA is initialized (``torch.cuda.
is_initialized()``): the allocator reads its configuration once, when the
first card memory is taken, so a late call would be a silent no-op.

JAX's knobs and their counterparts (:data:`GPU_PERF_FLAGS` and
:data:`GPU_RUNTIME_ENV` of ``repro.launch.env``):

================================================ ========================
JAX                                              the port
================================================ ========================
``--xla_gpu_enable_triton_softmax_fusion``       none: no compiler fuses
``--xla_gpu_triton_gemm_any``                    eager ops; the port's
``--xla_gpu_enable_latency_hiding_scheduler``    kernels are hand-written
                                                 and its GEMMs cuBLAS's
``--xla_gpu_enable_async_collectives``           none: NCCL collectives
                                                 of ``torch.distributed``
                                                 run on their own stream
``--xla_gpu_enable_highest_priority_async_stream`` ``TORCH_NCCL_HIGH_PRIORITY=1``
``XLA_PYTHON_CLIENT_PREALLOCATE``                none: the caching
                                                 allocator grows on demand
``XLA_PYTHON_CLIENT_MEM_FRACTION``               ``mem_fraction``
``XLA_PYTHON_CLIENT_ALLOCATOR``                  ``allocator``
``TF_CPP_MIN_LOG_LEVEL``                         ``log_level``
================================================ ========================
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

__all__ = ["CUDA_PERF_ENV", "CUDA_RUNTIME_ENV", "ALLOCATORS",
           "configure_platform", "merge_alloc_conf"]

# the "gpu" preset: NCCL's streams at high priority, so a collective is
# not queued behind the compute kernels of the step it overlaps
CUDA_PERF_ENV = {"TORCH_NCCL_HIGH_PRIORITY": "1"}

# configure_platform's kwargs -> the environment variables they set
CUDA_RUNTIME_ENV = {
    "alloc_conf": "PYTORCH_CUDA_ALLOC_CONF",
    "uncached": "PYTORCH_NO_CUDA_MEMORY_CACHING",
    "log_level": "TORCH_CPP_LOG_LEVEL",
    "platform": "CUDA_VISIBLE_DEVICES",
}
ALLOCATORS = ("native", "cudaMallocAsync", "uncached")
_LOG_LEVELS = ("INFO", "WARNING", "ERROR", "FATAL", "FATAL")


def _parse_alloc_conf(raw: str) -> dict:
    out = {}
    for item in raw.split(","):
        item = item.strip()
        if item:
            key, _, value = item.partition(":")
            out[key.strip()] = value.strip()
    return out


def merge_alloc_conf(new: Mapping[str, object]) -> str:
    """Merge ``new`` into ``PYTORCH_CUDA_ALLOC_CONF``, replacing same-key
    entries and keeping every other (order: survivors first, ours last);
    returns and sets the merged value."""
    ours = {k: str(v) for k, v in new.items()}
    kept = {k: v for k, v in _parse_alloc_conf(
        os.environ.get(CUDA_RUNTIME_ENV["alloc_conf"], "")).items()
        if k not in ours}
    merged = ",".join(f"{k}:{v}" for k, v in {**kept, **ours}.items())
    os.environ[CUDA_RUNTIME_ENV["alloc_conf"]] = merged
    return merged


def configure_platform(platform: Optional[str] = None, *,
                       alloc_conf: Optional[Mapping[str, object]] = None,
                       allocator: Optional[str] = None,
                       mem_fraction: Optional[float] = None,
                       log_level: Optional[int] = None) -> dict:
    """Configure the CUDA runtime for ``platform`` (``"gpu"``, ``"cpu"``
    or None: leave the device choice alone) before CUDA initializes.

    Only what is passed is applied: ``configure_platform("gpu")`` alone
    never overrides a deployment's own allocator settings.  Returns what
    was applied (``platform``, ``env``, ``alloc_conf``, ``mem_fraction``)
    for a benchmark's metadata.  Raises ``RuntimeError`` once CUDA is
    initialized, and ``ValueError`` on an unknown platform or allocator,
    or a fraction outside (0, 1].
    """
    if platform is not None and platform not in ("cpu", "gpu"):
        raise ValueError(f"platform must be cpu|gpu, got {platform!r}")
    if allocator is not None and allocator not in ALLOCATORS:
        raise ValueError(f"allocator must be one of {ALLOCATORS}, got "
                         f"{allocator!r}")
    if mem_fraction is not None and not 0.0 < mem_fraction <= 1.0:
        raise ValueError(f"mem_fraction must be in (0, 1], got "
                         f"{mem_fraction}")
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "configure_platform() after CUDA initialized: the allocator "
            "reads its configuration once, so this call would silently not "
            "apply; call it before any work on the card")
    env = {}
    if platform == "gpu":
        env.update(CUDA_PERF_ENV)
    elif platform == "cpu":
        env[CUDA_RUNTIME_ENV["platform"]] = ""
    if allocator == "uncached":
        env[CUDA_RUNTIME_ENV["uncached"]] = "1"
    if log_level is not None:
        env[CUDA_RUNTIME_ENV["log_level"]] = _LOG_LEVELS[
            min(max(int(log_level), 0), 4)]
    os.environ.update(env)
    conf = dict(alloc_conf or {})
    if allocator in ("native", "cudaMallocAsync"):
        conf["backend"] = allocator
    merged = merge_alloc_conf(conf) if conf else os.environ.get(
        CUDA_RUNTIME_ENV["alloc_conf"], "")
    if mem_fraction is not None:
        if platform == "cpu" or not torch.cuda.is_available():
            raise ValueError("mem_fraction caps a card's memory: no card "
                             "is visible")
        torch.cuda.set_per_process_memory_fraction(float(mem_fraction))
    return {"platform": platform, "env": env, "alloc_conf": merged,
            "mem_fraction": mem_fraction}
