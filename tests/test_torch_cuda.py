"""The port's CUDA/Triton kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: f32 attention 2e-5 (the kernel sums in another order); bf16
attention outputs may differ by one bf16 ulp of values of order 1 (2e-2);
the backward's gradients sum over a whole sequence (up to 1,024 terms per
element), so f32 gradients agree to 1e-4; the bf16 kernels and the plain
backward each round f32 values once, so they differ by at most about one
bf16 ulp (atol 4e-3, rtol 1e-2), while autograd through the plain bf16
attention rounds at more places (2e-2); the fused residual update rounds
the same f32 values once,
so its output is bitwise equal and its sums agree to 1e-5 relative; so
does the update without the residual (``parareal_update``).  SRDS on a
small f32 DiT with ``norm='l2_mean'``: the fused and plain updates add the
same f32 values in the same order, so their samples agree to 1e-5 (the
rest of the solve is shared), and the sample at the iteration cap equals
the sequential one to 1e-4.  The serving engine on the card makes one
host fetch per refinement plus one per completion and no other host sync
(PyTorch's sync debug mode), and its samples equal ``simulate()``'s.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

F32_TOL = 2e-5
BF16_TOL = 2e-2
GRAD_F32_TOL = 1e-4
GRAD_BF16_ATOL, GRAD_BF16_RTOL = 4e-3, 1e-2
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


def _qkv(cuda, case, dtype, grad=False):
    b, h, sq, sk, d = case
    return [torch.from_numpy(_rand(i, (b, h, s, d))).to(cuda, DTYPES[dtype])
            .requires_grad_(grad) for i, s in enumerate((sq, sk, sk))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_bwd_kernels_match_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    b, h, sq, sk, d = case
    q, k, v = _qkv(cuda, case, dtype)
    do = torch.from_numpy(_rand(9, (b, h, sq, d))).to(cuda, DTYPES[dtype])
    q3, k3, v3, do3 = (t.reshape(b * h, *t.shape[2:]) for t in (q, k, v, do))
    o3, lse = flash_attention_fwd(q3, k3, v3)
    before = ops.launch_counts()
    dq, dk, dv = flash_attention_bwd(q3, k3, v3, o3, lse, do3)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    want = ref.attention_bwd(q, k, v, o3.view(q.shape), lse.view(b, h, sq),
                             do, causal=False)
    atol, rtol = ((GRAD_BF16_ATOL, GRAD_BF16_RTOL) if dtype == "bfloat16"
                  else (GRAD_F32_TOL, GRAD_F32_TOL))
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.view(w.shape).float(), w.float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_grads_on_card_equal_plain_path(cuda, dtype):
    """A loss through ``ops.attention`` on the card gets gradients for q,
    k and v (through the backward kernels) equal to the plain path's."""
    case = (2, 3, 100, 77, 72)
    q, k, v = _qkv(cuda, case, dtype, grad=True)
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.attention(q, k, v, causal=False)
                              .float().sin().sum(), (q, k, v))
    assert ops.launch_counts()["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    want = torch.autograd.grad(ops.attention(q, k, v, causal=False,
                                             use_kernel=False)
                               .float().sin().sum(), (q, k, v))
    tol = BF16_TOL if dtype == "bfloat16" else GRAD_F32_TOL
    for g, w in zip(got, want):
        assert g is not None and bool(torch.isfinite(g).all())
        assert g.abs().max() > 0
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_bwd_is_bitwise_deterministic_on_card(cuda):
    q, k, v = _qkv(cuda, (2, 16, 1024, 1024, 72), "bfloat16", grad=True)
    runs = [torch.autograd.grad(ops.attention(q, k, v, causal=False)
                                .float().square().sum(), (q, k, v))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_refuses_unported_forms_on_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    x = torch.ones(2, 16, 8, device=cuda)
    lse = torch.zeros(2, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="B5"):
        flash_attention_bwd(x, x, x, x, lse, x, causal=True)
    with pytest.raises(NotImplementedError, match="B5"):
        flash_attention_bwd(torch.ones(4, 16, 8, device=cuda), x, x,
                            torch.ones(4, 16, 8, device=cuda),
                            torch.zeros(4, 16, device=cuda),
                            torch.ones(4, 16, 8, device=cuda))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 4), (5, 2, 64, 64, 4),
                                   (3, 1000, 7)], ids=str)
def test_parareal_update_kernel_matches_plain_on_card(cuda, shape, dtype):
    y, c, p = (torch.from_numpy(_rand(i, shape)).to(cuda, DTYPES[dtype])
               for i in range(3))
    before = ops.launch_counts()["parareal_update"]
    out, resid = ops.parareal_update(y, c, p)
    torch.cuda.synchronize()
    assert ops.launch_counts()["parareal_update"] == before + 1
    out_r, resid_r = ref.parareal_update(y, c, p)
    torch.testing.assert_close(out, out_r, atol=0, rtol=0)
    torch.testing.assert_close(resid, resid_r, atol=0, rtol=SUM_RTOL)
    out2, resid2 = ops.parareal_update(y, c, p)
    assert torch.equal(out2, out) and torch.equal(resid2, resid)


def _small_dit_fn(cuda):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import dit
    cfg = ArchConfig(name="dit-small", num_layers=2, d_model=144,
                     num_heads=2, num_kv_heads=2, d_ff=288, patch_size=2,
                     in_channels=4, dtype="float32")
    model = dit.load_jax_params(cfg, dit.random_jax_tree(cfg, seed=0),
                                device=cuda)
    return dit.make_denoiser(model)


@pytest.mark.cuda
def test_srds_l2_mean_on_card_small_dit(cuda):
    import repro_torch.core as C
    fn = _small_dit_fn(cuda)
    sched = C.make_schedule("ddpm_linear", 16)
    x0 = torch.from_numpy(_rand(5, (2, 16, 16, 4))).to(cuda)
    cfg = dict(num_blocks=4, tol=0.0, norm="l2_mean", per_sample=True,
               truncate=True)
    ops.reset_launch_counts()
    res = C.srds_sample(fn, sched, C.SolverConfig("ddim"), x0,
                        C.SRDSConfig(**cfg))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # truncated refinements 0..3 cover 4, 4, 3 and 2 blocks
    assert counts["parareal_update"] == 4 + 4 + 3 + 2
    assert counts["parareal_update_residual"] == 0
    plain = C.srds_sample(fn, sched, C.SolverConfig("ddim"), x0,
                          C.SRDSConfig(use_fused_update=False, **cfg))
    torch.testing.assert_close(res.sample, plain.sample, atol=1e-5,
                               rtol=1e-5)
    seq = C.sample_sequential(fn, sched, C.SolverConfig("ddim"), x0)
    torch.testing.assert_close(res.sample, seq, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_serving_engine_one_sync_per_refinement_on_card(cuda, monkeypatch):
    import warnings
    from repro_torch import serve
    from repro_torch.core import SolverConfig
    from repro_torch.serve import diffusion as sd
    scale = torch.linspace(0.5, 1.5, 8, device=cuda)

    def model(x, t):
        return torch.tanh(x * scale) * (0.5 + 0.001 * t[:, None])

    fetches = []
    real = sd._host_fetch

    def counted(f):
        fetches.append(f)
        return real(f)

    def engine():
        return serve.DiffusionSamplingEngine(
            model, (8,), SolverConfig("ddim"), num_steps=36, batch_size=2,
            device=cuda)

    trace = serve.poisson_trace(
        6, rate=300.0, tiers=[serve.Tier(tol=1e-2), serve.Tier(tol=1e-5)],
        seed=0)
    sync = serve.simulate(engine(), trace)
    eng = engine()
    monkeypatch.setattr(sd, "_host_fetch", counted)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rep = serve.AsyncServeLoop(eng, serve.FIFO()).run(trace)
            n_run = len(caught)
            torch.ones(1, device=cuda).item()    # a control the mode sees
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hidden = [i for i, w in enumerate(caught)
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert hidden == [n_run]
    assert len(fetches) == len(eng.refine_frontiers) + len(rep.responses)
    assert sorted(rep.responses) == sorted(sync.responses)
    for rid, r in sync.responses.items():
        assert rep.responses[rid].iterations == r.iterations
        assert np.array_equal(rep.responses[rid].sample, r.sample)
