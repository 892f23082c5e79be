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
The causal, sliding-window and grouped-query forward takes the same
tolerances as the non-causal one; the WKV kernel's are in its test.  In
bf16 with a head dim that is a multiple of 8 the forward runs on the
tensor cores (every ATTN_CASES and MASKED_CASES shape, by its route count),
with P as three bf16 terms: within 1e-4 rel L2 of the plain version at a
causal GQA shape and at the DiT's, where P rounded once to bf16 misses
that limit.  So does the backward (dq and dkv), with P and dS as two bf16
terms: dq and (dk, dv) within 1e-3 rel L2 of the plain backward
(chip_smoke's ``BWD_MASKED_REL_L2``), where P and dS rounded once to bf16
miss it; each output tile has one owner, so two runs are bitwise equal.
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
    """Every mask and group form is ported; what the backward still
    refuses is a head dim over 128, mixed dtypes and operands off the
    card."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    x = torch.ones(2, 16, 8, device=cuda)
    lse = torch.zeros(2, 16, device=cuda)
    wide = torch.ones(2, 16, 136, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(wide, wide, wide, wide, lse, wide, causal=True)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_bwd(x, x.bfloat16(), x, x, lse, x, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x.cpu(), x, x, lse, x, window=4)


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


# (B, Hq, Hkv, Sq, Sk, D, mask): causal GQA at qwen3's head dim 128, ragged
# right-aligned queries (Sq < Sk), rows with no live key (Sq > Sk, causal),
# and hymba's sliding window (group 5, D 64)
MASKED_CASES = [(2, 8, 2, 200, 200, 128, dict(causal=True)),
                (2, 8, 2, 100, 1000, 64, dict(causal=True)),
                (1, 4, 4, 80, 50, 64, dict(causal=True)),
                (1, 10, 2, 300, 300, 64, dict(causal=True, window=100)),
                (1, 4, 1, 70, 260, 72, dict(causal=False, window=64))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", MASKED_CASES, ids=str)
def test_flash_kernel_masks_and_groups_match_plain_on_card(cuda, case,
                                                           dtype):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    b, hq, hkv, sq, sk, d, mask = case
    q, k, v = (torch.from_numpy(_rand(i, (b, h, s, d))).to(cuda,
                                                          DTYPES[dtype])
               for i, (h, s) in enumerate(((hq, sq), (hkv, sk), (hkv, sk))))
    before = ops.launch_counts()["flash_attention_fwd"]
    o = ops.attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == before + 1
    o_ref, lse_ref = ref.attention(q, k, v, **mask)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    _, lse = flash_attention_fwd(q.reshape(b * hq, sq, d),
                                 k.reshape(b * hkv, sk, d),
                                 v.reshape(b * hkv, sk, d), **mask)
    torch.testing.assert_close(lse, lse_ref.reshape(b * hq, sq),
                               atol=F32_TOL, rtol=F32_TOL)


# the tensor-core forward (bf16, head dim a multiple of 8): every shape of
# ATTN_CASES (non-causal) and of MASKED_CASES
TC_CASES = ([(b, h, h, sq, sk, d, dict(causal=False))
             for b, h, sq, sk, d in ATTN_CASES] + MASKED_CASES)
# P written as bf16 terms, at a causal GQA shape with qwen3-8b's head dim
# and a non-causal one with the DiT's (72, padded to 80 in the kernel): rel
# L2 of o against the plain version, the forward's limit in bf16
# (chip_smoke.MASKED_REL_L2); P rounded once to bf16 (one term) reads about
# 2e-3 and must miss it
TERMS_CASES = [(1, 8, 2, 512, 512, 128, dict(causal=True)),
               (1, 16, 16, 1024, 1024, 72, dict(causal=False))]
TERMS_REL_L2 = 1e-4


def _tc_qkv(cuda, case):
    b, hq, hkv, sq, sk, d, _ = case
    return [torch.from_numpy(_rand(i, (b, h, s, d))).to(cuda, torch.bfloat16)
            for i, (h, s) in enumerate(((hq, sq), (hkv, sk), (hkv, sk)))]


def _fwd3(q, k, v, fn, *args, **mask):
    """A forward kernel on (B, H, S, D) operands through the (BH, S, D)
    wrappers; returns o as (B, H, S, D) and lse as (B, H, S)."""
    b, h, sq, d = q.shape
    o, lse = fn(q.reshape(b * h, sq, d), k.reshape(-1, *k.shape[2:]),
                v.reshape(-1, *v.shape[2:]), *args, **mask)
    return o.view(q.shape), lse.view(b, h, sq)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_flash_tc_kernel_matches_plain_on_card(cuda, case):
    """bf16 with a head dim that is a multiple of 8 launches the tensor-core
    kernel (its route count, not the f32-FMA one's); o within the bf16
    tolerance, lse within the f32 one."""
    from repro_torch.kernels import flash_attention as fa
    mask = case[-1]
    q, k, v = _tc_qkv(cuda, case)
    assert fa.fwd_route(q.dtype, q.shape[-1]) == "tc"
    before = ops.route_counts()
    o, lse = _fwd3(q, k, v, fa.flash_attention_fwd, **mask)
    torch.cuda.synchronize()
    after = ops.route_counts()
    assert after["flash_attention_fwd_tc"] == \
        before["flash_attention_fwd_tc"] + 1
    assert after["flash_attention_fwd_simt"] == \
        before["flash_attention_fwd_simt"]
    o_ref, lse_ref = ref.attention(q, k, v, **mask)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
    torch.testing.assert_close(lse, lse_ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 36), ("float32", 64)])
def test_flash_simt_route_on_card(cuda, dtype, d):
    """f32, and bf16 with a head dim that is not a multiple of 8 (TMA needs
    16-byte rows), take the f32-FMA kernel."""
    from repro_torch.kernels import flash_attention as fa
    case = (1, 4, 2, 70, 90, d, dict(causal=True))
    q, k, v = (t.to(DTYPES[dtype]) for t in _tc_qkv(cuda, case))
    assert fa.fwd_route(q.dtype, d) == "simt"
    before = ops.route_counts()
    o, lse = _fwd3(q, k, v, fa.flash_attention_fwd, causal=True)
    torch.cuda.synchronize()
    after = ops.route_counts()
    assert after["flash_attention_fwd_simt"] == \
        before["flash_attention_fwd_simt"] + 1
    assert after["flash_attention_fwd_tc"] == before["flash_attention_fwd_tc"]
    o_ref, lse_ref = ref.attention(q, k, v, causal=True)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_flash_tc_kernel_is_bitwise_deterministic_on_card(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _tc_qkv(cuda, (2, 16, 16, 1024, 1024, 72, {}))
    runs = [_fwd3(q, k, v, fa.flash_attention_fwd) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TERMS_CASES, ids=str)
def test_flash_tc_terms_control_on_card(cuda, case):
    """The kernel's bf16 terms of P meet the forward's rel L2 limit; P
    rounded once to bf16 misses it (the control), and the terms' entry
    point at the kernel's count is the main one bitwise."""
    from repro_torch.kernels import flash_attention as fa
    mask = case[-1]
    q, k, v = _tc_qkv(cuda, case)
    o_ref, _ = ref.attention(q, k, v, **mask)
    rel = {}
    for terms in (1, fa.TC_TERMS):
        o, _ = _fwd3(q, k, v, fa.flash_attention_fwd_terms, terms, **mask)
        rel[terms] = ((o.float() - o_ref.float()).norm()
                      / o_ref.float().norm()).item()
    assert torch.equal(o, _fwd3(q, k, v, fa.flash_attention_fwd, **mask)[0])
    assert rel[fa.TC_TERMS] <= TERMS_REL_L2 < rel[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 72), ("bfloat16", 36),
                                     ("float32", 64)])
def test_flash_fwd_refuses_no_keys_on_card(cuda, dtype, d):
    """Sk == 0 with Sq > 0 is refused before any launch on either route
    (the plain version has no such form either); Sq == 0 returns empty
    outputs without a launch."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((2, 5, d), device=cuda, dtype=DTYPES[dtype])
    kv = torch.zeros((2, 0, d), device=cuda, dtype=DTYPES[dtype])
    before = ops.route_counts()
    with pytest.raises(ValueError, match="at least one key"):
        fa.flash_attention_fwd(q, kv, kv)
    o, lse = fa.flash_attention_fwd(q[:, :0], kv, kv)
    assert o.shape == (2, 0, d) and lse.shape == (2, 0)
    assert ops.route_counts() == before

# (B, H, T, Dk, Dv): one decode token, a ragged T, rwkv6-1.6b's head dim
WKV_CASES = [(4, 32, 1, 64, 64), (2, 3, 7, 64, 64), (2, 4, 300, 64, 64),
             (1, 2, 40, 16, 16), (1, 1, 33, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_kernel_matches_plain_on_card(cuda, case, dtype):
    """r, k, v in ``dtype``, w, u and the state f32, as the model feeds
    them.  The kernel and the plain scan compute the same f32 recurrence
    in another order: the f32 state agrees to 1e-4 over up to 300 steps,
    out to 1e-4 in f32 and one bf16 ulp (2e-2) in bf16; two runs are
    bitwise equal (one owner per state column, no atomics)."""
    b, h, t, dk, dv = case
    r, k = (torch.from_numpy(_rand(i, (b, h, t, dk)) * 0.5).to(
        cuda, DTYPES[dtype]) for i in range(2))
    v = torch.from_numpy(_rand(2, (b, h, t, dv)) * 0.5).to(cuda,
                                                          DTYPES[dtype])
    w = torch.from_numpy(_rand(3, (b, h, t, dk)) * 0.5 - 1.0).to(cuda)
    u = torch.from_numpy(_rand(4, (h, dk)) * 0.3).to(cuda)
    s0 = torch.from_numpy(_rand(5, (b, h, dk, dv)) * 0.2).to(cuda)
    before = ops.launch_counts()["rwkv6_wkv"]
    out, s_t = ops.rwkv6_wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rwkv6_wkv"] == before + 1
    assert out.dtype == v.dtype and s_t.dtype == torch.float32
    out_r, s_r = ops.rwkv6_wkv(r, k, v, w, u, s0, use_kernel=False)
    tol = BF16_TOL if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(out.float(), out_r.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(s_t, s_r, atol=1e-4, rtol=1e-4)
    out2, s_t2 = ops.rwkv6_wkv(r, k, v, w, u, s0)
    assert torch.equal(out2, out) and torch.equal(s_t2, s_t)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_reduced_lm_served_on_card_equals_cpu(cuda, arch):
    """The reduced LM (f32) served through the kernels on the card gives
    the CPU run's tokens (the plain twins), on a ragged batch."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServingEngine
    cfg = get_arch(arch).reduced()
    model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 256, n), max_new_tokens=m)
            for n, m in ((12, 5), (7, 3), (4, 6))]
    want = ServingEngine(cfg, model, batch_size=3, max_seq=64).generate(reqs)
    ops.reset_launch_counts()
    got = ServingEngine(cfg, model.to(cuda), batch_size=3,
                        max_seq=64).generate(reqs)
    assert got == want
    counts = ops.launch_counts()
    kernel = "rwkv6_wkv" if cfg.block == "rwkv6" else "flash_attention_fwd"
    calls = 6 if kernel == "rwkv6_wkv" else 1    # prefill + 5 decode steps
    assert counts[kernel] == cfg.num_layers * calls
    assert sum(counts.values()) == counts[kernel]


# the backward's masked and grouped forms, on MASKED_CASES' shapes plus
# qwen3-8b's group 4 at head dim 128 with Sq > 2 tiles
MASKED_BWD_CASES = MASKED_CASES + [(1, 8, 2, 320, 320, 128,
                                    dict(causal=True))]


def _masked_qkv(cuda, case, dtype, grad=False):
    b, hq, hkv, sq, sk, d, _ = case
    return [torch.from_numpy(_rand(i, (b, h, s, d))).to(cuda, DTYPES[dtype])
            .requires_grad_(grad)
            for i, (h, s) in enumerate(((hq, sq), (hkv, sk), (hkv, sk)))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", MASKED_BWD_CASES, ids=str)
def test_flash_bwd_masks_and_groups_match_plain_on_card(cuda, case, dtype):
    """The dq and dkv kernels in their causal, sliding-window and GQA forms
    against ``ref.attention_bwd``: dk and dv in the KV heads' layout, the
    group summed once in f32 on both sides."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    b, hq, hkv, sq, sk, d, mask = case
    q, k, v = _masked_qkv(cuda, case, dtype)
    do = torch.from_numpy(_rand(9, (b, hq, sq, d))).to(cuda, DTYPES[dtype])
    q3, do3 = (t.reshape(b * hq, sq, d) for t in (q, do))
    k3, v3 = (t.reshape(b * hkv, sk, d) for t in (k, v))
    o3, lse = flash_attention_fwd(q3, k3, v3, **mask)
    before = ops.launch_counts()
    dq, dk, dv = flash_attention_bwd(q3, k3, v3, o3, lse, do3, **mask)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    assert dk.shape == k3.shape and dv.shape == v3.shape
    want = ref.attention_bwd(q, k, v, o3.view(q.shape),
                             lse.view(b, hq, sq), do, **mask)
    atol, rtol = ((GRAD_BF16_ATOL, GRAD_BF16_RTOL) if dtype == "bfloat16"
                  else (GRAD_F32_TOL, GRAD_F32_TOL))
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.view(w.shape).float(), w.float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_flash_bwd_gqa_is_bitwise_deterministic_on_card(cuda):
    q, k, v = _masked_qkv(cuda, MASKED_BWD_CASES[-1], "bfloat16", grad=True)
    runs = [torch.autograd.grad(ops.attention(q, k, v, causal=True)
                                .float().square().sum(), (q, k, v))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _wkv_inputs(cuda, case, dtype, grad=False):
    b, h, t, dk, dv = case
    r, k = (torch.from_numpy(_rand(i, (b, h, t, dk)) * 0.5).to(
        cuda, DTYPES[dtype]) for i in range(2))
    v = torch.from_numpy(_rand(2, (b, h, t, dv)) * 0.5).to(cuda,
                                                          DTYPES[dtype])
    w = torch.from_numpy(_rand(3, (b, h, t, dk)) * 0.5 - 1.0).to(cuda)
    u = torch.from_numpy(_rand(4, (h, dk)) * 0.3).to(cuda)
    s0 = torch.from_numpy(_rand(5, (b, h, dk, dv)) * 0.2).to(cuda)
    return [x.requires_grad_(grad) for x in (r, k, v, w, u, s0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_bwd_kernel_matches_plain_on_card(cuda, case, dtype):
    """``RWKV6WKV``'s backward (the WKV backward kernel, from the forward's
    checkpoints) against ``ref.rwkv6_wkv_bwd`` on the same upstream
    gradients of out and of the final state.  Both are f32 recurrences
    summed in other orders: dw, du and ds0 (f32) agree to 1e-4 relative
    to the largest element, dr, dk, dv to that in f32 and one bf16 ulp in
    bf16; two runs are bitwise equal."""
    x = _wkv_inputs(cuda, case, dtype, grad=True)
    dout = torch.from_numpy(_rand(7, tuple(x[2].shape))).to(cuda,
                                                           DTYPES[dtype])
    ds_t = torch.from_numpy(_rand(8, tuple(x[5].shape))).to(cuda)
    before = ops.launch_counts()

    def grads():
        out, s_t = ops.rwkv6_wkv(*x)
        return torch.autograd.grad((out, s_t), x, (dout, ds_t))

    got = grads()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["rwkv6_wkv_bwd"] == before["rwkv6_wkv_bwd"] + 1
    assert after["rwkv6_wkv"] == before["rwkv6_wkv"] + 1
    want = ref.rwkv6_wkv_bwd(*(t.detach() for t in x), dout, ds_t)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == x[i].dtype and g.shape == x[i].shape
        scale = w.float().abs().max().item()
        tol = (BF16_TOL * max(scale, 1.0)
               if g.dtype == torch.bfloat16 else 1e-4 * max(scale, 1.0))
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
    again = grads()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wkv_forward_checkpoints_on_card(cuda):
    """The forward's checkpoints are the states at the chunk starts (the
    first is s0), and writing them changes no output."""
    from repro_torch.kernels import rwkv6_scan
    r, k, v, w, u, s0 = _wkv_inputs(cuda, (2, 3, 70, 64, 64), "float32")
    out, s_t, ckpt = rwkv6_scan.rwkv6_wkv(r, k, v, w, u, s0,
                                          checkpoints=True)
    out2, s_t2, none = rwkv6_scan.rwkv6_wkv(r, k, v, w, u, s0)
    assert none is None and torch.equal(out, out2) and torch.equal(s_t, s_t2)
    c = rwkv6_scan.chunk()
    assert ckpt.shape == (2, 3, -(-70 // c), 64, 64)
    assert torch.equal(ckpt[:, :, 0], s0)
    for i in range(1, ckpt.shape[2]):
        _, s_i = ref.rwkv6_wkv(*(x[:, :, :i * c] for x in (r, k, v, w)), u,
                               s0)
        torch.testing.assert_close(ckpt[:, :, i], s_i, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_reduced_lm_grads_on_card_equal_plain_path(cuda, arch):
    """``lm_loss`` on the reduced LM (f32) through the kernels on the card
    (the causal GQA flash backward, or the WKV backward) against the plain
    path's: every parameter's gradient within 1e-4 relative L2, and the
    backward kernels launched once per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.train import lm_loss
    cfg = get_arch(arch).reduced()
    model = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda, trainable=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 70))).to(cuda)
    batch = {"tokens": toks, "labels": toks}
    params = list(model.parameters())
    ops.reset_launch_counts()
    got = torch.autograd.grad(lm_loss(cfg, model, batch)[0], params)
    counts = ops.launch_counts()
    want = torch.autograd.grad(lm_loss(cfg, model, batch,
                                       use_kernel=False)[0], params)
    bwd = ("rwkv6_wkv_bwd" if cfg.block == "rwkv6"
           else "flash_attention_bwd_dkv")
    assert counts[bwd] == cfg.num_layers
    for g, w in zip(got, want):
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-4


# the tensor-core backward (bf16, head dim a multiple of 8): rel L2 of dq
# and of (dk, dv) against the plain backward, chip_smoke.BWD_MASKED_REL_L2
TC_BWD_REL_L2 = 1e-3
# (B, Hq, Hkv, Sq, Sk, D, mask): Sq past two tiles with group 4 at qwen3's
# head dim (a head's rows start off a 16-byte boundary: Sq % 4 == 2), a
# ragged window with group 4, ragged non-causal at the DiT's head dim, the
# smallest head dim
TC_BWD_CASES = [(1, 8, 2, 330, 330, 128, dict(causal=True)),
                (2, 4, 1, 200, 333, 64, dict(causal=True, window=50)),
                (1, 4, 4, 77, 100, 72, dict(causal=False)),
                (1, 2, 2, 64, 64, 16, dict(causal=False))]
# P and dS in bf16 terms at a causal GQA shape with qwen3-8b's head dim and
# a non-causal one with the DiT's (72, padded to 80): one term reads about
# 2.6e-3 and must miss TC_BWD_REL_L2
BWD_TERMS_CASES = [(1, 8, 2, 512, 512, 128, dict(causal=True)),
                   (1, 16, 16, 1024, 1024, 72, dict(causal=False))]


def _bwd_inputs(cuda, case, dtype="bfloat16"):
    """(B, H, S, D) q, k, v, dO; their (BH, S, D) views; the forward's o and
    lse; and the plain backward's (dq, dk, dv) in the kernels' layout."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    b, hq, hkv, sq, sk, d, mask = case
    q, k, v = _masked_qkv(cuda, case, dtype)
    do = torch.from_numpy(_rand(9, (b, hq, sq, d))).to(cuda, DTYPES[dtype])
    q3, do3 = (t.reshape(b * hq, sq, d) for t in (q, do))
    k3, v3 = (t.reshape(b * hkv, sk, d) for t in (k, v))
    o3, lse = flash_attention_fwd(q3, k3, v3, **mask)
    want = ref.attention_bwd(q, k, v, o3.view(q.shape), lse.view(b, hq, sq),
                             do, **mask)
    want = [w.reshape(x.shape) for w, x in zip(want, (q3, k3, v3))]
    return (q3, k3, v3, o3, lse, do3), want


def _rel(got, want):
    num = sum(float((g.float() - w.float()).square().sum())
              for g, w in zip(got, want))
    return (num / sum(float(w.float().square().sum()) for w in want)) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_BWD_CASES, ids=str)
def test_flash_bwd_tc_kernels_rel_l2_on_card(cuda, case):
    """bf16 with a head dim that is a multiple of 8 launches the tensor-core
    dq and dkv kernels (their route counts), within TC_BWD_REL_L2 of the
    plain backward over dq and over (dk, dv)."""
    from repro_torch.kernels import flash_attention as fa
    args, want = _bwd_inputs(cuda, case)
    assert fa.bwd_route(torch.bfloat16, case[5]) == "tc"
    before = ops.route_counts()
    dq, dk, dv = fa.flash_attention_bwd(*args, **case[-1])
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[f"{name}_tc"] == before[f"{name}_tc"] + 1
        assert after[f"{name}_simt"] == before[f"{name}_simt"]
    assert _rel([dq], want[:1]) <= TC_BWD_REL_L2
    assert _rel([dk, dv], want[1:]) <= TC_BWD_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 36), ("float32", 64)])
def test_flash_bwd_simt_route_on_card(cuda, dtype, d):
    """f32, and bf16 with a head dim that is not a multiple of 8, take the
    f32-FMA dq and dkv kernels (their route counts)."""
    from repro_torch.kernels import flash_attention as fa
    case = (1, 4, 2, 70, 90, d, dict(causal=True))
    args, want = _bwd_inputs(cuda, case, dtype)
    assert fa.bwd_route(DTYPES[dtype], d) == "simt"
    before = ops.route_counts()
    got = fa.flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[f"{name}_simt"] == before[f"{name}_simt"] + 1
        assert after[f"{name}_tc"] == before[f"{name}_tc"]
    limit = TC_BWD_REL_L2 if dtype == "bfloat16" else GRAD_F32_TOL
    assert _rel(got[:1], want[:1]) <= limit
    assert _rel(got[1:], want[1:]) <= limit


@pytest.mark.cuda
def test_flash_bwd_tc_is_bitwise_deterministic_on_card(cuda):
    """Two tensor-core backwards of one input (group 4, head dim 128: the
    dkv kernel's two-pass form with its promoted sums) give the same bits:
    each output tile has one owner and sums in a fixed order."""
    from repro_torch.kernels import flash_attention as fa
    args, _ = _bwd_inputs(cuda, TC_BWD_CASES[0])
    first = fa.flash_attention_bwd(*args, causal=True)
    second = fa.flash_attention_bwd(*args, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_TERMS_CASES, ids=str)
def test_flash_bwd_tc_terms_control_on_card(cuda, case):
    """The kernels' bf16 terms of P and dS meet TC_BWD_REL_L2 over dq and
    over (dk, dv); P and dS rounded once to bf16 miss it on both (the
    control), and the terms' entry point at the kernels' count is the main
    one bitwise."""
    from repro_torch.kernels import flash_attention as fa
    args, want = _bwd_inputs(cuda, case)
    rel = {}
    for terms in (1, fa.BWD_TC_TERMS):
        got = fa.flash_attention_bwd_terms(*args, terms, **case[-1])
        rel[terms] = (_rel(got[:1], want[:1]), _rel(got[1:], want[1:]))
    main = fa.flash_attention_bwd(*args, **case[-1])
    assert all(torch.equal(a, b) for a, b in zip(got, main))
    assert max(rel[fa.BWD_TC_TERMS]) <= TC_BWD_REL_L2 < min(rel[1]), rel
