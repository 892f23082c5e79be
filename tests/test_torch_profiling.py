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
