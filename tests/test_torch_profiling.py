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
