"""The port's CUDA/Triton kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: f32 attention 2e-5 (the kernel sums in another order); bf16
attention outputs may differ by one bf16 ulp of values of order 1 (2e-2);
the fused residual update rounds the same f32 values once, so its output
is bitwise equal and its sums agree to 1e-5 relative.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

F32_TOL = 2e-5
BF16_TOL = 2e-2
SUM_RTOL = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, H, Sq, Sk, D): SD-v2's head dim 72, CIFAR's 64, ragged Sq and Sk
ATTN_CASES = [(1, 2, 64, 64, 64), (2, 2, 48, 48, 72), (1, 3, 40, 77, 72),
              (1, 2, 33, 50, 64), (2, 16, 1024, 1024, 72)]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels are built "
                    "with nvcc/Triton for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    b, h, sq, sk, d = case
    q, k, v = (torch.from_numpy(_rand(i, (b, h, s, d))).to(cuda,
                                                           DTYPES[dtype])
               for i, s in enumerate((sq, sk, sk)))
    before = ops.launch_counts()["flash_attention_fwd"]
    o = ops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == before + 1
    o_ref, _ = ref.attention(q, k, v, causal=False)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_kernel_lse_on_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q, k, v = (torch.from_numpy(_rand(i, (6, 70, 72))).to(cuda)
               for i in range(3))
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = ref.attention(q[None], k[None], v[None], causal=False)
    torch.testing.assert_close(o, o_ref[0], atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(lse, lse_ref[0], atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch_dims", [0, 1, 2])
def test_elementwise_kernels_match_plain_on_card(cuda, batch_dims, dtype):
    shape = (5, 2, 64, 64, 4)
    y, c, p, o = (torch.from_numpy(_rand(i, shape)).to(cuda, DTYPES[dtype])
                  for i in range(4))
    out, resid = ops.parareal_update_residual(y, c, p, o,
                                              batch_dims=batch_dims)
    out_r, resid_r = ref.parareal_update_residual(y, c, p, o,
                                                  batch_dims=batch_dims)
    torch.testing.assert_close(out, out_r, atol=0, rtol=0)
    torch.testing.assert_close(resid, resid_r, atol=0, rtol=SUM_RTOL)
    a = torch.linspace(0.05, 0.6, shape[0], device=cuda)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(ops.ddim_fused(y, c, a, a + 0.3).float(),
                               ref.ddim_fused(y, c, a, a + 0.3).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_residual_kernel_slices_independent_of_batch_on_card(cuda):
    shape = (4, 2, 64, 64, 4)
    y, c, p, o = (torch.from_numpy(_rand(i, shape)).to(cuda)
                  for i in range(4))
    _, batch = ops.parareal_update_residual(y, c, p, o, batch_dims=1)
    for k in range(shape[0]):
        s = slice(k, k + 1)
        _, alone = ops.parareal_update_residual(y[s], c[s], p[s], o[s],
                                                batch_dims=1)
        assert alone.item() == batch[k].item()
