"""Where device time goes: kernel names grouped by what they compute.

``torch.profiler`` reports each kernel by its mangled name.  ``kernel_group``
maps a name to the port's kernel that launched it (the flash backward's
masked and grouped forms share the dq and dkv kernels' names), to cuBLAS,
or to the rest (elementwise, norms, copies); ``device_ms_by_name`` sums a
profile's device time per kernel name.  The port's only use is reading: nothing on a
model's path calls this module.
"""
from __future__ import annotations

from collections import defaultdict

# CUPTI reports a stall of the launch queue as an event of its own; it is
# not a kernel and its time overlaps the kernels'
NOT_KERNELS = ("Command Buffer Full",)

# (substring of the lower-cased kernel name, group), first match wins
_PORT_KERNELS = (
    ("flash_fwd_kernel", "flash_attention_fwd (port)"),
    ("flash_bwd_dq_kernel", "flash_attention_bwd dq (port)"),
    ("flash_bwd_dkv_kernel", "flash_attention_bwd dkv (port)"),
    ("wkv_fwd_kernel", "rwkv6_wkv (port)"),
    ("wkv_bwd_kernel", "rwkv6_wkv_bwd (port)"),
)
_GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "sm90_")
GEMM = "gemm (cuBLAS)"
OTHER = "other (elementwise, norms, copies)"


def kernel_group(name: str) -> str:
    """The group of a device kernel, by its name."""
    low = name.lower()
    for mark, group in _PORT_KERNELS:
        if mark in low:
            return group
    if any(mark in low for mark in _GEMM_MARKS):
        return GEMM
    return OTHER


def device_ms_by_name(prof, reps: int = 1) -> dict:
    """{kernel name: device ms per run} of a finished ``torch.profiler``
    profile that ran its work ``reps`` times.  Device-side events only: a
    CPU op's device time repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    by_name = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or evt.key in NOT_KERNELS:
            continue
        by_name[evt.key] += evt.self_device_time_total / 1e3 / reps
    return dict(by_name)


def by_group(by_name: dict) -> dict:
    """Sum ``{kernel name: ms}`` into ``{group: ms}``."""
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[kernel_group(name)] += ms
    return dict(groups)
