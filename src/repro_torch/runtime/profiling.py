"""Where device time goes: kernel names grouped by what they compute.

``torch.profiler`` reports each kernel by its mangled name.  ``kernel_group``
maps a name to the port's kernel that launched it (the flash backward's
masked and grouped forms share the dq and dkv kernels' names), to cuBLAS,
or to the rest (elementwise, norms, copies); ``device_ms_by_name`` sums a
profile's device time per kernel name; ``window_launches`` and
``device_launches`` count the launches of a function's calls.  The port's
only use is reading:
nothing on a model's path calls this module.
"""
from __future__ import annotations

from collections import defaultdict

# CUPTI reports a stall of the launch queue as an event of its own; it is
# not a kernel and its time overlaps the kernels'
NOT_KERNELS = ("Command Buffer Full",)
# the CUDA runtime and driver calls that start a device activity (a
# kernel, a copy or a fill), by the start of their names
LAUNCH_APIS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
               "cudaMemset", "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")
# seconds the host waits at each end of a launch-counting window
# (device_launches).  On an H100 the device's timestamps read up to about
# 0.5 ms early in a window (scripts/torch_profiler_edges.py), and a window
# without the pause lost launches now and then
LAUNCH_EDGE_PAUSE_S = 0.02
# the kernels a launch-counting window starts with on a card, and the clock
# cycles of each (window_launches).  On an H100, late in a long process the
# profiler kept no record of a window's first 1-4 launches, more the later
# (scripts/torch_profiler_edges.py --scan-bwd-late; ROADMAP C12)
LEAD_LAUNCHES = 8
LEAD_CYCLES = 1000

# (substring of the lower-cased kernel name, group), first match wins
_PORT_KERNELS = (
    ("flash_fwd_kernel", "flash_attention_fwd (port)"),
    ("flash_bwd_dq_kernel", "flash_attention_bwd dq (port)"),
    ("flash_bwd_dkv_kernel", "flash_attention_bwd dkv (port)"),
    # the WKV forward (wkv_fwd_colgroup_kernel), and the backward's two
    # passes (wkv_bwd_rowgroup_kernel, wkv_bwd_dv_sum_kernel)
    ("wkv_fwd_", "rwkv6_wkv (port)"),
    ("wkv_bwd_", "rwkv6_wkv_bwd (port)"),
    ("ddim_fused_kernel", "ddim_fused (port)"),
    ("parareal_resid_cluster_kernel", "parareal_update_residual (port)"),
    ("parareal_update_cluster_kernel", "parareal_update (port)"),
    # the scan's backward and its sum (selective_scan_bwd_kernel,
    # selective_scan_bwd_sum_kernel), before the forward's mark; the
    # staged forward (selective_scan_fwd_kernel, with or without
    # checkpoints) and the decode step's (selective_scan_step_kernel)
    ("selective_scan_bwd", "selective_scan_bwd (port)"),
    ("selective_scan_", "selective_scan (port)"),
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


def window_launches(fn, calls: int, pause_s: float = LAUNCH_EDGE_PAUSE_S
                    ) -> dict:
    """``calls`` calls of ``fn`` under one ``torch.profiler`` window:
    ``{"device": {kernel name: [launches, device µs]}, "api": n,
    "lead_lost": k, "missing": [i, ...], "missing_api": [name, ...]}``, the
    device activities (kernels, copies, fills) the profiler recorded and
    the host's calls that start one (``LAUNCH_APIS``), the lead's launches
    with no record, and the places (in launch order) and the host calls'
    names of the calls' launches with no record.  The
    card is idle and the host waits ``pause_s`` seconds at both ends of the
    window.  On a card the window starts with ``LEAD_LAUNCHES`` lead kernels
    (``torch.cuda._sleep``), a synchronize and another pause; their calls
    (the window's first) and records (by CUPTI's correlation id) are left
    out of ``device`` and ``api``: on an H100, from some point of a long
    process on, the profiler kept no record of the first launches of every
    window, one to four of them, whatever they launched
    (``scripts/torch_profiler_edges.py --scan-late`` and
    ``--scan-bwd-late``; ROADMAP C12), and the lead takes that loss."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lead = LEAD_LAUNCHES if torch.cuda.is_available() else 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pause_s)
        if lead:
            for _ in range(lead):
                torch.cuda._sleep(LEAD_CYCLES)
            torch.cuda.synchronize()
            time.sleep(pause_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pause_s)
    raw = prof.profiler.kineto_results.events()
    calls = [(c, name) for _, c, name in sorted(
        (e.start_ns(), e.correlation_id(), e.name()) for e in raw
        if e.device_type() == DeviceType.CPU
        and e.name().startswith(LAUNCH_APIS))]
    launches = [c for c, _ in calls]
    skip = set(launches[:lead])
    records = [e for e in raw if e.device_type() == DeviceType.CUDA
               and e.name() not in NOT_KERNELS]
    recorded = {e.correlation_id() for e in records}
    device = {}
    for e in records:
        if e.correlation_id() not in skip:
            count, us = device.get(e.name(), (0, 0.0))
            device[e.name()] = [count + 1,
                                us + (e.end_ns() - e.start_ns()) / 1e3]
    missing = [i for i, c in enumerate(launches[len(skip):])
               if c not in recorded]
    return {"device": device, "api": len(launches) - len(skip),
            "lead_lost": len(skip - recorded), "missing": missing,
            "missing_api": [calls[len(skip) + i][1] for i in missing]}


def device_launches(fn, calls: int, pause_s: float = LAUNCH_EDGE_PAUSE_S
                    ) -> dict:
    """{kernel name: [launches, device µs]} of ``calls`` calls of ``fn``
    under one ``torch.profiler`` window (:func:`window_launches`' device
    activities)."""
    return window_launches(fn, calls, pause_s)["device"]


def by_group(by_name: dict) -> dict:
    """Sum ``{kernel name: ms}`` into ``{group: ms}``."""
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[kernel_group(name)] += ms
    return dict(groups)
