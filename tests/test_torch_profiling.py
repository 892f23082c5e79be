"""The profile readings' grouping of device kernels by name
(``repro_torch.runtime.profiling``)."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.runtime import profiling


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 4>"
     "(Params)", "flash_attention_fwd (port)"),
    ("flash_bwd_dq_kernel<float>", "flash_attention_bwd dq (port)"),
    ("flash_bwd_dkv_kernel<__nv_bfloat16>", "flash_attention_bwd dkv (port)"),
    ("void (anonymous namespace)::wkv_fwd_kernel<__nv_bfloat16, 64>(...)",
     "rwkv6_wkv (port)"),
    ("void (anonymous namespace)::wkv_bwd_kernel<float, 64>(...)",
     "rwkv6_wkv_bwd (port)"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", profiling.GEMM),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", profiling.GEMM),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     profiling.OTHER),
])
def test_kernel_group(name, group):
    assert profiling.kernel_group(name) == group


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::wkv_fwd_colgroup_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, float const*, __nv_bfloat16*, float*, "
     "float*, int, int, int, int)", "rwkv6_wkv (port)"),
    ("void (anonymous namespace)::wkv_bwd_rowgroup_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, float const*, __nv_bfloat16 const*, "
     "float const*, __nv_bfloat16*, __nv_bfloat16*, float*, float*, float*, "
     "float*, int, int, int, int)", "rwkv6_wkv_bwd (port)"),
    ("void (anonymous namespace)::wkv_bwd_dv_sum_kernel<float>(float const*, "
     "float*, int, int, unsigned long)", "rwkv6_wkv_bwd (port)"),
])
def test_kernel_group_wkv(name, group):
    """The WKV forward and both passes of its backward (the row-group
    kernel and the dv sum) land in the WKV groups, not under "other"."""
    assert profiling.kernel_group(name) == group


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::selective_scan_fwd_kernel<4, 4, true>("
     "...)", "selective_scan (port)"),
    ("void (anonymous namespace)::selective_scan_bwd_kernel<4, 4>(float "
     "const*, long long, long long, ...)", "selective_scan_bwd (port)"),
    ("(anonymous namespace)::selective_scan_bwd_sum_kernel(float const*, "
     "float const*, float const*, float*, float*, float*, float*, float*, "
     "int, int, int, int, int, int)", "selective_scan_bwd (port)"),
])
def test_kernel_group_selective_scan_backward(name, group):
    """The scan's checkpointing forward lands in the forward's group; the
    backward and its sum in the backward's, not under the forward's or
    "other"."""
    assert profiling.kernel_group(name) == group


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::ddim_fused_kernel<float>(float const*, "
     "float const*, float const*, float const*, float*, long long, "
     "long long, long long, int)", "ddim_fused (port)"),
    ("void (anonymous namespace)::ddim_fused_kernel<__nv_bfloat16>(...)",
     "ddim_fused (port)"),
    ("void (anonymous namespace)::parareal_resid_cluster_kernel<float, "
     "true>(float const*, float const*, float const*, float const*, float*, "
     "float*, long long, long long)", "parareal_update_residual (port)"),
    ("void (anonymous namespace)::parareal_resid_cluster_kernel<__half, "
     "false>(...)", "parareal_update_residual (port)"),
    ("void (anonymous namespace)::parareal_update_cluster_kernel<float, "
     "true>(float const*, float const*, float const*, float*, float*, "
     "long long, long long)", "parareal_update (port)"),
    ("void (anonymous namespace)::parareal_update_cluster_kernel<"
     "__nv_bfloat16, false>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float*, long long, long long)",
     "parareal_update (port)"),
    # library kernels whose names hold the words update_kernel or
    # sum_partials_kernel stay where they were: elementwise work, or cuBLAS
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "update_kernel_functor>", profiling.OTHER),
    ("sm90_xmma_gemm_sum_partials_kernel_bf16", profiling.GEMM),
])
def test_kernel_group_elementwise(name, group):
    """The DDIM, residual and update CUDA kernels (B2, B1, B4) have
    groups of their own; none of their names holds a cuBLAS mark, so the
    order in which the marks are tried does not decide their group."""
    assert profiling.kernel_group(name) == group
    if group.endswith("(port)"):
        assert not any(m in name.lower() for m in profiling._GEMM_MARKS)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::tc::flash_fwd_kernel_tc<128, 3>"
    "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
    "float*, int, int, int, int, int, int, int, float)",
    "void (anonymous namespace)::flash_fwd_kernel_tc<cute::"
    "SM90_64x64x16_F32BF16BF16_SS<(cute::GMMA::Major)0, "
    "(cute::GMMA::Major)0>, cutlass::bfloat16_t, cute::SM90_TMA_LOAD>"
    "(cute::TmaDescriptor)"])
def test_kernel_group_tensor_core_forward(name):
    """The tensor-core flash forward keeps the ``flash_fwd_kernel`` prefix:
    a name templated on CuTe's SM90 atoms, which carries the GEMM marks
    ``cutlass`` and ``SM90_``, still lands in the flash group."""
    assert profiling.kernel_group(name) == "flash_attention_fwd (port)"


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::selective_scan_fwd_kernel<16>(float "
    "const*, long long, long long, float const*, float const*, float "
    "const*, float const*, float const*, float const*, float*, float*, "
    "int, int, int)",
    "void (anonymous namespace)::selective_scan_fwd_kernel<4>(...)",
    "void (anonymous namespace)::selective_scan_step_kernel<4, 4>(...)"])
def test_kernel_group_selective_scan(name):
    """Hymba's selective scan (any lanes a channel, the staged kernel and
    the decode step's) has a group of its own, apart from the elementwise
    work around it."""
    assert profiling.kernel_group(name) == "selective_scan (port)"


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::tc::flash_bwd_dq_kernel_tc<128, 2>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int, int, "
     "(anonymous namespace)::Mask, float, float)",
     "flash_attention_bwd dq (port)"),
    ("void (anonymous namespace)::tc::flash_bwd_dkv_kernel_tc<80, 2>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, "
     "int, int, int, (anonymous namespace)::Mask, float, float)",
     "flash_attention_bwd dkv (port)"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel_tc<cute::"
     "SM90_64x32x16_F32BF16BF16_RS<(cute::GMMA::Major)0, "
     "(cute::GMMA::Major)1>, cutlass::bfloat16_t, cute::SM90_TMA_LOAD>"
     "(cute::TmaDescriptor)", "flash_attention_bwd dkv (port)"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel_tc<cutlass::"
     "gemm::GemmShape<64, 64, 16>, cute::SM90_64x64x16_F32BF16BF16_SS>()",
     "flash_attention_bwd dq (port)"),
])
def test_kernel_group_tensor_core_backward(name, group):
    """The tensor-core dq and dkv kernels keep their ``flash_bwd_dq_kernel``
    and ``flash_bwd_dkv_kernel`` prefixes: their names, and names templated
    on CUTLASS or CuTe types (GEMM marks ``gemm``, ``cutlass``, ``SM90_``),
    land in the flash groups, not in cuBLAS's."""
    assert profiling.kernel_group(name) == group


def test_profile_script_groups_through_the_port():
    """``scripts/torch_profile_eval.py`` groups kernels by
    ``profiling.kernel_group``, so it knows the WKV kernels too."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_profile_eval.py"
    spec = importlib.util.spec_from_file_location("torch_profile_eval", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert not hasattr(script, "_group")
    by_name = {"void (anonymous namespace)::wkv_bwd_kernel<float, 64>()": 2.0,
               "flash_bwd_dkv_kernel_tc<128, 2>": 1.0, "nvjet_a": 0.5}
    assert script._by_group(by_name) == profiling.by_group(by_name) == {
        "rwkv6_wkv_bwd (port)": 2.0, "flash_attention_bwd dkv (port)": 1.0,
        profiling.GEMM: 0.5}


def test_device_ms_by_group_sums_names_and_skips_host_events():
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (x @ x).sum()
    # a CPU-only profile has no device kernel
    assert profiling.device_ms_by_name(prof) == {}
    groups = profiling.by_group({"flash_fwd_kernel<float>": 1.5,
                                 "nvjet_a": 2.0, "nvjet_b": 0.25,
                                 "copy_kernel": 0.5})
    assert groups == {"flash_attention_fwd (port)": 1.5,
                      profiling.GEMM: 2.25, profiling.OTHER: 0.5}


def test_device_launches_pauses_at_both_ends_and_counts_calls(monkeypatch):
    """``device_launches`` calls ``fn`` the given number of times inside
    one window, waits ``pause_s`` at each end with the card synchronised
    around the calls, and reads device activity only: a CPU-only function
    launches nothing."""
    import time
    syncs, calls = [], []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: syncs.append(len(calls)))
    x = torch.ones(64, 64)
    t0 = time.perf_counter()
    got = profiling.device_launches(lambda: calls.append((x @ x).sum()), 7,
                                    pause_s=0.05)
    assert time.perf_counter() - t0 >= 0.1
    assert got == {}
    assert len(calls) == 7 and syncs == [0, 7]


def test_window_launches_counts_host_launch_calls(monkeypatch):
    """``window_launches`` returns the device activities and the host's
    launch calls of one window: CPU work launches nothing on either side;
    the host's count takes the runtime's and the driver's calls that start
    a kernel, a copy or a fill, and no other call."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    x = torch.ones(16, 16)
    got = profiling.window_launches(lambda: (x @ x).sum(), 3, pause_s=0.0)
    assert got == {"device": {}, "api": 0, "lead_lost": 0, "missing": []}
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch"):
        assert name.startswith(profiling.LAUNCH_APIS), name
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventRecord", "cudaGetDevice", "aten::mm"):
        assert not name.startswith(profiling.LAUNCH_APIS), name


def test_window_launches_leads_with_a_kernel_of_its_own(monkeypatch):
    """On a card the window starts with ``LEAD_LAUNCHES`` launches of
    ``torch.cuda._sleep`` and a synchronize before the calls (the profiler
    may keep no record of a window's first launches), and leaves them out
    of both counts; without a card there is no lead launch."""
    order = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: order.append("sync"))
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: order.append(("lead", cycles)))
    x = torch.ones(8, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = profiling.window_launches(lambda: order.append("call"), 3,
                                    pause_s=0.0)
    lead = [("lead", profiling.LEAD_CYCLES)] * profiling.LEAD_LAUNCHES
    assert profiling.LEAD_LAUNCHES >= 4
    first = order.index("call")
    assert order[:first] == ["sync", *lead, "sync"]
    assert [v for v in order[first:] if v != "sync"] == ["call"] * 3
    assert got == {"device": {}, "api": 0, "lead_lost": 0, "missing": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    order.clear()
    profiling.window_launches(lambda: order.append(1), 2, pause_s=0.0)
    assert [v for v in order if v != "sync"] == [1, 1]
