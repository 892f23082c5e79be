"""The port's CUDA kernels against their plain versions, on the card.

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
does the update without the residual (``parareal_update``).  The DDIM,
residual and update kernels also run bitwise equal twice and on their
scalar path (unaligned operands) as on their 16-byte path; f16 DDIM outputs may
differ by two f16 ulps (2e-3).  SRDS on a
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
Hymba's selective scan (f32) agrees with its plain twin to 1e-4 (the sum
over the states in another order) and runs bitwise equal twice, and on
its 4-byte copy route as on its bulk route; the twin with D dropped
misses that limit, and a call makes one device launch.  Its backward
kernel agrees with ``ref.selective_scan_bwd`` to 1e-4 relative L2 per
gradient (the sums over channels, steps and states in other orders) and
runs bitwise equal twice; the forward's checkpoints are the twin's states
to 1e-4 and change neither y nor h_T; a CUDA operand that needs a gradient
runs the backward kernel, never the plain scan.  The block-sharded SRDS
driver on an NCCL group of one rank runs the single program's blocks in
the same batches, so it stops at the same iterations with the same
kernel launches and its sample is within 1e-6 rel L2 of ``srds_sample``'s;
the wavefront at one rank (B=1) equals the sequential sample to 1e-4.  A
CUDA tensor on a gloo group, or a CPU one on NCCL, raises.
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
F16_TOL = 2e-3        # two f16 ulps of values of order 1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, H, Sq, Sk, D): SD-v2's head dim 72, CIFAR's 64, ragged Sq and Sk,
# and the patch-sharded SD-v2 DiT's row shard (Sq = S/2 against Sk = S)
ATTN_CASES = [(1, 2, 64, 64, 64), (2, 2, 48, 48, 72), (1, 3, 40, 77, 72),
              (1, 2, 33, 50, 64), (2, 16, 1024, 1024, 72),
              (2, 16, 512, 1024, 72)]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels are built "
                    "with nvcc for sm_90a)")
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


EW_DTYPES = {"float32": (torch.float32, F32_TOL),
             "bfloat16": (torch.bfloat16, BF16_TOL),
             "float16": (torch.float16, F16_TOL)}


def _unaligned(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary: the CUDA elementwise kernels take their scalar path."""
    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return u.view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("dtype", sorted(EW_DTYPES))
@pytest.mark.parametrize("shape", [(10, 64, 64, 4), (3, 1001), (5, 3, 7)],
                         ids=str)
def test_ddim_kernel_dtypes_and_coefficients_on_card(cuda, shape, dtype,
                                                     per_row):
    """B2 in f32, bf16 and f16, with one (a, b) or one per row, at the fine
    step's shape and at lengths that are no multiple of the 16-byte vector
    (a ragged tail, rows not of whole vectors): within the stated tolerance
    of the plain version, two runs bitwise equal, and the scalar path
    (unaligned operands) bitwise equal to the 16-byte path."""
    tdt, tol = EW_DTYPES[dtype]
    x, e = (torch.from_numpy(_rand(i, shape)).to(cuda, tdt) for i in (0, 1))
    a = torch.linspace(0.05, 0.6, shape[0], device=cuda)
    if not per_row:
        a = a[1]
    b = a + 0.3
    out = ops.ddim_fused(x, e, a, b)
    assert out.dtype == tdt and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.ddim_fused(x, e, a, b).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(ops.ddim_fused(x, e, a, b), out)
    assert torch.equal(ops.ddim_fused(_unaligned(x), _unaligned(e), a, b),
                       out)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["strided", "broadcast", "float64"])
def test_ddim_kernel_takes_any_coefficient_layout_on_card(cuda, form):
    """Per-row coefficients that are not dense f32 on the card (a strided
    view of a table, a 0-d value expanded to every row, f64) give the same
    bits as dense f32 copies of them."""
    shape = (10, 64, 64, 4)
    x, e = (torch.from_numpy(_rand(i, shape)).to(cuda) for i in (0, 1))
    table = torch.linspace(0.05, 0.9, 2 * shape[0], device=cuda)
    a, b = {"strided": (table[::2], table[1::2]),
            "broadcast": (torch.tensor(0.4, device=cuda).expand(shape[0]),
                          torch.tensor(0.7, device=cuda).expand(shape[0])),
            "float64": (table[:shape[0]].double(),
                        table[shape[0]:].double())}[form]
    dense = [c.float().contiguous() for c in (a, b)]
    out = ops.ddim_fused(x, e, a, b)
    assert torch.equal(out, ops.ddim_fused(x, e, *dense))
    torch.testing.assert_close(out, ref.ddim_fused(x, e, *dense),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(EW_DTYPES))
@pytest.mark.parametrize("batch_dims,shape", [
    (1, (2, 64, 64, 4)), (2, (5, 2, 64, 64, 4)), (0, (3, 1000, 7)),
    (1, (3, 999, 7)), (2, (3, 1000, 7)), (1, (4, 2, 64, 64, 4))], ids=str)
def test_residual_kernel_ragged_and_repeated_on_card(cuda, batch_dims, shape,
                                                     dtype):
    """B1 at the corrector's shapes and at ragged ones (slices of 6993 and
    of 7 elements: the scalar path): the update bitwise equal to the plain
    version, the residual within 1e-5 relative, two runs bitwise equal,
    and the scalar path (unaligned operands) bitwise equal to the 16-byte
    path, residual included (it keeps the summation order)."""
    tdt = EW_DTYPES[dtype][0]
    y, c, p, o = (torch.from_numpy(_rand(i, shape)).to(cuda, tdt)
                  for i in range(4))
    out, resid = ops.parareal_update_residual(y, c, p, o,
                                              batch_dims=batch_dims)
    out_r, resid_r = ref.parareal_update_residual(y, c, p, o,
                                                  batch_dims=batch_dims)
    torch.testing.assert_close(out, out_r, atol=0, rtol=0)
    torch.testing.assert_close(resid, resid_r, atol=0, rtol=SUM_RTOL)
    for args in ((y, c, p, o), tuple(map(_unaligned, (y, c, p, o)))):
        out2, resid2 = ops.parareal_update_residual(*args,
                                                    batch_dims=batch_dims)
        assert torch.equal(out2, out) and torch.equal(resid2, resid)


@pytest.mark.cuda
def test_elementwise_kernels_one_launch_per_call_on_card(cuda):
    """Each B1 or B2 call makes one device launch (kernels, copies and
    fills all count), read from one torch.profiler window
    (``profiling.device_launches``): a window that traced no device launch
    fails."""
    from repro_torch.runtime.profiling import device_launches
    y, c, p, o = (torch.from_numpy(_rand(i, (5, 2, 64, 64, 4))).to(cuda)
                  for i in range(4))
    a = torch.linspace(0.05, 0.6, 5, device=cuda)
    b = a + 0.3
    calls = {"ddim_fused": lambda: ops.ddim_fused(y, c, a, b),
             "parareal_update_residual": lambda: ops.parareal_update_residual(
                 y, c, p, o, batch_dims=2)}
    for name, fn in calls.items():
        fn()
        before = ops.launch_counts()[name]
        device = device_launches(fn, 10)
        assert ops.launch_counts()[name] - before == 10
        assert sum(n for n, _ in device.values()) == 10, (name, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 4), (5, 2, 64, 64, 4),
                                   (3, 1000, 7)], ids=str)
def test_parareal_update_kernel_matches_plain_on_card(cuda, shape, dtype):
    """B4: the update bitwise equal to the plain version, the sum within
    1e-5 relative, two runs and the scalar path (unaligned operands)
    bitwise equal, and one device launch a call (``profiling.
    device_launches``)."""
    from repro_torch.runtime.profiling import device_launches
    y, c, p = (torch.from_numpy(_rand(i, shape)).to(cuda, DTYPES[dtype])
               for i in range(3))
    before = ops.launch_counts()["parareal_update"]
    out, resid = ops.parareal_update(y, c, p)
    torch.cuda.synchronize()
    assert ops.launch_counts()["parareal_update"] == before + 1
    out_r, resid_r = ref.parareal_update(y, c, p)
    torch.testing.assert_close(out, out_r, atol=0, rtol=0)
    torch.testing.assert_close(resid, resid_r, atol=0, rtol=SUM_RTOL)
    for args in ((y, c, p), tuple(map(_unaligned, (y, c, p)))):
        out2, resid2 = ops.parareal_update(*args)
        assert torch.equal(out2, out) and torch.equal(resid2, resid)
    device = device_launches(lambda: ops.parareal_update(y, c, p), 10)
    assert sum(n for n, _ in device.values()) == 10, device
    assert all("parareal_update_cluster_kernel" in k for k in device), device


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

# (B, H, T, Dk, Dv[, "clip"]): one decode token, a ragged T, rwkv6-1.6b's
# head dim, smaller head dims; w over the model's whole clip [-8, 4]
# (decays down to exp(-e^4), about 1.9e-24); B*H 3 (no multiple of the
# kernels' column or row groups) with T 37 (no multiple of chunk()); head
# dims that are no multiple of 8 (the wrappers pad them)
WKV_CASES = [(4, 32, 1, 64, 64), (2, 3, 7, 64, 64), (2, 4, 300, 64, 64),
             (1, 2, 40, 16, 16), (1, 1, 33, 8, 8),
             (2, 4, 300, 64, 64, "clip"), (1, 3, 37, 64, 64),
             (1, 3, 37, 12, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_kernel_matches_plain_on_card(cuda, case, dtype):
    """r, k, v in ``dtype``, w, u and the state f32, as the model feeds
    them.  The kernel and the plain scan compute the same f32 recurrence
    in another order: the f32 state agrees to 1e-4 over up to 300 steps,
    out to 1e-4 in f32 and one bf16 ulp (2e-2) in bf16; two runs are
    bitwise equal (one owner per state column, no atomics)."""
    r, k, v, w, u, s0 = _wkv_inputs(cuda, case, dtype)
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
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b", "hymba-1.5b"])
def test_reduced_lm_served_on_card_equals_cpu(cuda, arch):
    """The reduced LM (f32) served through the kernels on the card gives
    the CPU run's tokens (the plain twins), on a ragged batch; hymba runs
    the window flash forward once a layer in prefill and the selective
    scan once a layer in prefill and in every decode step."""
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
    layers = cfg.num_layers                 # prefill + 5 decode steps
    want = {"attn_mlp": {"flash_attention_fwd": layers},
            "rwkv6": {"rwkv6_wkv": 6 * layers},
            "hymba": {"flash_attention_fwd": layers,
                      "selective_scan": 6 * layers}}[cfg.block]
    assert counts == dict(dict.fromkeys(counts, 0), **want)


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
    b, h, t, dk, dv = case[:5]
    r, k = (torch.from_numpy(_rand(i, (b, h, t, dk)) * 0.5).to(
        cuda, DTYPES[dtype]) for i in range(2))
    v = torch.from_numpy(_rand(2, (b, h, t, dv)) * 0.5).to(cuda,
                                                          DTYPES[dtype])
    if case[5:] == ("clip",):
        w = torch.from_numpy(np.random.default_rng(3).uniform(
            -8.0, 4.0, (b, h, t, dk)).astype(np.float32)).to(cuda)
    else:
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
def test_wkv_bitwise_repeat_at_training_shape_on_card(cuda):
    """At rwkv6-1.6b's training shape (2 x 32 heads, T 2048, head dim 64,
    bf16) the forward with checkpoints and the backward give the same bits
    twice: every sum has one owner and a fixed order, no atomics."""
    from repro_torch.kernels import rwkv6_scan
    r, k, v, w, u, s0 = _wkv_inputs(cuda, (2, 32, 2048, 64, 64), "bfloat16")
    dout = torch.from_numpy(_rand(7, tuple(v.shape))).to(cuda,
                                                         torch.bfloat16)
    ds_t = torch.from_numpy(_rand(8, tuple(s0.shape))).to(cuda)
    runs = []
    for _ in range(2):
        out, s_t, ckpt = rwkv6_scan.rwkv6_wkv(r, k, v, w, u, s0,
                                              checkpoints=True)
        grads = rwkv6_scan.rwkv6_wkv_bwd(r, k, v, w, u, ckpt, dout, ds_t)
        runs.append((out, s_t, ckpt) + tuple(grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b.view(torch.int32))


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
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b", "hymba-1.5b"])
def test_reduced_lm_grads_on_card_equal_plain_path(cuda, arch):
    """``lm_loss`` on the reduced LM (f32) through the kernels on the card
    (the causal GQA flash backward, the WKV backward, or hymba's window
    flash backward and the scan's backward) against the plain
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
    bwds = {"rwkv6": ("rwkv6_wkv_bwd",),
            "hymba": ("flash_attention_bwd_dkv", "selective_scan_bwd")}.get(
                cfg.block, ("flash_attention_bwd_dkv",))
    assert all(counts[bwd] == cfg.num_layers for bwd in bwds), counts
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


def _toy_fn(device):
    w = torch.from_numpy(_rand(31, (16, 16)) * 0.4).to(device)

    def fn(x, t):
        return torch.tanh(x @ w) * (0.4 + 3e-4 * t[:, None])

    return fn


@pytest.mark.cuda
def test_ddpm_native_noise_deterministic_on_card(cuda):
    """The native frozen noise on the card is a pure function of (seed,
    interval id): drawn in either order, after other draws, it gives the
    same bits; so a DDPM-SRDS run at its cap equals the sequential solve,
    and a second run repeats the first bitwise."""
    import repro_torch.core as C
    from repro_torch.core.solvers import frozen_noise
    shape = (3, 64, 64, 4)
    a1 = frozen_noise(5, 17, shape, torch.float32, cuda)
    b1 = frozen_noise(5, 18, shape, torch.float32, cuda)
    b2 = frozen_noise(5, 18, shape, torch.float32, cuda)
    a2 = frozen_noise(5, 17, shape, torch.float32, cuda)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, b1)
    fn = _toy_fn(cuda)
    sched = C.make_schedule("ddpm_linear", 16)
    solver = C.SolverConfig("ddpm", noise_seed=3)
    x0 = torch.from_numpy(_rand(6, (2, 16))).to(cuda)
    cfg = C.SRDSConfig(num_blocks=4, tol=0.0)
    res = C.srds_sample(fn, sched, solver, x0, cfg)
    again = C.srds_sample(fn, sched, solver, x0, cfg)
    seq = C.sample_sequential(fn, sched, solver, x0)
    assert torch.equal(res.sample, again.sample)
    torch.testing.assert_close(res.sample, seq, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_paradigms_one_ddim_launch_per_sweep_on_card(cuda):
    """A toy ParaDiGMS run steps its whole window in one batch: one DDIM
    kernel launch a sweep, and the sample matches the CPU run's."""
    import repro_torch.core as C
    fn = _toy_fn(cuda)
    sched = C.make_schedule("ddpm_linear", 40)
    x0 = torch.from_numpy(_rand(7, (2, 16)))
    cfg = C.ParaDiGMSConfig(window=16, tol=1e-3)
    ops.reset_launch_counts()
    res = C.paradigms_sample(fn, sched, C.SolverConfig("ddim"), x0.to(cuda),
                             cfg)
    counts = ops.launch_counts()
    assert counts["ddim_fused"] == res.iterations > 1
    cpu = C.paradigms_sample(_toy_fn("cpu"), sched, C.SolverConfig("ddim"),
                             x0, cfg)
    assert (res.iterations, res.total_evals) == (cpu.iterations,
                                                 cpu.total_evals)
    torch.testing.assert_close(res.sample.cpu(), cpu.sample, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_default_solver_never_takes_plain_path_on_card(cuda, monkeypatch):
    """With ``use_fused_kernel=None`` a CUDA tensor's DDIM step launches the
    kernel: the plain update is never called, in the sequential solve, in
    SRDS and in ParaDiGMS."""
    import repro_torch.core as C
    from repro_torch.core import solvers

    def plain(*args):
        raise AssertionError("the plain DDIM update ran on a CUDA tensor")

    monkeypatch.setattr(solvers, "_ddim_update", plain)
    fn = _toy_fn(cuda)
    sched = C.make_schedule("ddpm_linear", 16)
    solver = C.SolverConfig("ddim")
    x0 = torch.from_numpy(_rand(8, (2, 16))).to(cuda)
    ops.reset_launch_counts()
    C.sample_sequential(fn, sched, solver, x0)
    assert ops.launch_counts()["ddim_fused"] == 16
    C.srds_sample(fn, sched, solver, x0, C.SRDSConfig(num_blocks=4))
    pd = C.paradigms_sample(fn, sched, solver, x0, C.ParaDiGMSConfig())
    assert ops.launch_counts()["ddim_fused"] > 16 + pd.iterations


# (B, T, din, n, xs): hymba's state size 16 with a ragged din (no
# multiple of the 32 channels a block), a decode token, the reduced
# model's 8 states, a long T over many staged chunks, n 5 (states past n
# hold zero; B and C by 4-byte copies), xs as the second half of a (B, T,
# 2 din) tensor (True: the model's strided view), n 17 and n 32 (8 lanes a
# channel), and xs one float off a 16-byte boundary ("unaligned": x by
# 4-byte copies)
SCAN_CASES = [(2, 9, 40, 16, False), (4, 1, 1600, 16, False),
              (3, 37, 100, 8, True), (2, 300, 64, 16, True),
              (1, 70, 33, 5, False), (2, 33, 1600, 16, True),
              (2, 45, 40, 17, False), (2, 72, 96, 32, True),
              (2, 40, 64, 16, "unaligned")]


def _scan_inputs(cuda, case, grad=False):
    b, t, din, n, strided = case
    rng = np.random.default_rng(din + t)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda)

    zx = rand(b, t, 2 * din)
    if strided == "unaligned":
        flat = torch.empty(b * t * din + 1, device=cuda)[1:]
        xs = flat.view(b, t, din).copy_(zx[..., din:])
    else:
        xs = zx[..., din:] if strided else zx[..., din:].contiguous()
    dt = torch.nn.functional.softplus(rand(b, t) - 1.0)
    a = -torch.exp(rand(din, n, scale=0.5))
    ins = [xs, dt, rand(b, t, n), rand(b, t, n), a, rand(din),
           rand(b, din, n, scale=0.5)]
    return [x.requires_grad_(grad) if grad and i == 0 else x
            for i, x in enumerate(ins)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_selective_scan_kernel_matches_plain_on_card(cuda, case):
    """The selective scan against ``ref.selective_scan`` from a nonzero
    state: the same f32 recurrence, the state sum over n taken in another
    order, so y and h_T agree to 1e-4; one launch a call; two runs bitwise
    equal (one owner per output, no atomics)."""
    from repro_torch.kernels import selective_scan as scan
    assert scan.kernel_chunk() == scan.CHUNK
    x = _scan_inputs(cuda, case)
    before = ops.launch_counts()["selective_scan"]
    y, h_t = ops.selective_scan(*x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["selective_scan"] == before + 1
    y_r, h_r = ops.selective_scan(*x, use_kernel=False)
    assert ops.launch_counts()["selective_scan"] == before + 1
    torch.testing.assert_close(y, y_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h_t, h_r, atol=1e-4, rtol=1e-4)
    y2, h_t2 = ops.selective_scan(*x)
    assert torch.equal(y2, y) and torch.equal(h_t2, h_t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SCAN_CASES[3], SCAN_CASES[7]], ids=str)
def test_selective_scan_routes_agree_bitwise_on_card(cuda, case):
    """Operands that are all 16-byte aligned go by bulk (dt, B, C) and
    16-byte (x) copies; the same launch with every operand forced onto the
    4-byte cp.async route stages the same values, so y and h_T are bitwise
    equal."""
    from repro_torch.kernels import selective_scan as scan
    x = _scan_inputs(cuda, case)
    b, t, din = x[0].shape
    n = x[4].shape[-1]
    geo = scan.geometry(b, din, n)
    outs = []
    for bits in (None, 0):
        y = torch.empty((b, t, din), device=cuda)
        h_t = torch.empty((b, din, n), device=cuda)
        scan.launch(scan._lib(), *x, y, h_t, geo, bits=bits)
        outs.append((y, h_t))
    torch.cuda.synchronize()
    p = [v.data_ptr() for v in x[:4]]
    assert scan.route((p[0] % 16, p[1] % 16, (p[2] | p[3]) % 16), b, t, din,
                      n, geo.states * geo.lanes, x[0].stride(0),
                      x[0].stride(1)) == (scan.BULK_DT | scan.BULK_BC
                                          | scan.VEC_X)
    assert all(torch.equal(u, v) for u, v in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SCAN_CASES[1], SCAN_CASES[5]], ids=str)
def test_selective_scan_one_device_launch_a_call_on_card(cuda, case):
    """A call makes one device launch and nothing else on the card (no
    copy, no fill): the host's launch calls over a profiler window of
    calls, and the card's records of them (``profiling.window_launches``),
    of the staged kernel or, at T 1, of the decode step's."""
    from repro_torch.runtime.profiling import window_launches
    x = _scan_inputs(cuda, case)
    calls = 5
    got = window_launches(lambda: ops.selective_scan(*x), calls)
    assert got["api"] == calls, got
    assert sum(k for k, _ in got["device"].values()) == calls, got
    kernel = ("selective_scan_step_kernel" if x[0].shape[1] == 1
              else "selective_scan_fwd_kernel")
    assert all(kernel in k for k in got["device"]), got


@pytest.mark.cuda
def test_selective_scan_kernel_control_on_card(cuda):
    """The comparison can fail: the plain scan with D dropped misses the
    1e-4 limit the kernel meets."""
    x = _scan_inputs(cuda, SCAN_CASES[0])
    y, _ = ops.selective_scan(*x)
    no_d, _ = ops.selective_scan(*x[:5], torch.zeros_like(x[5]), x[6],
                                 use_kernel=False)
    assert not torch.allclose(y, no_d, atol=1e-4, rtol=1e-4)


# the scan's backward kernel against ref.selective_scan_bwd: relative L2
# per gradient (dB, dC and ddt sum 1,600 channels, da and dD every step,
# each in another order than the twin's)
SCAN_BWD_REL_L2 = 1e-4


def _scan_grads(cuda, case, seed=1):
    """The scan's operands (``_scan_inputs``), the forward's checkpoints,
    and upstream gradients of y and of the final state."""
    from repro_torch.kernels import selective_scan as scan
    x = _scan_inputs(cuda, case)
    b, t, din = x[0].shape
    n = x[4].shape[-1]
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.standard_normal((b, t, din)).astype(
        np.float32)).to(cuda)
    dh_t = torch.from_numpy(rng.standard_normal((b, din, n)).astype(
        np.float32)).to(cuda)
    _, _, ckpt = scan.selective_scan(*x, checkpoints=True)
    return x, ckpt, dy, dh_t


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES + [(1, 1100, 40, 16, True)],
                         ids=str)
def test_selective_scan_bwd_kernel_matches_twin_on_card(cuda, case):
    """The backward kernel from the forward's checkpoints, with gradients
    on y and on the final state, against ``ref.selective_scan_bwd`` from
    h0 at the kernel's segment count (T 1100: 3 segments):
    every gradient within SCAN_BWD_REL_L2; one launch each of the replay,
    the walk back and the sum a call; two runs bitwise equal."""
    from repro_torch.kernels import selective_scan as scan
    x, ckpt, dy, dh_t = _scan_grads(cuda, case)
    segments = scan.bwd_geometry(*case[:4]).segments
    before = ops.launch_counts()
    got = scan.selective_scan_bwd(*x[:6], ckpt, dy, dh_t)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["selective_scan_bwd"] == before["selective_scan_bwd"] + 1
    assert (after["selective_scan_bwd_replay"]
            == before["selective_scan_bwd_replay"] + 1)
    assert (after["selective_scan_bwd_sum"]
            == before["selective_scan_bwd_sum"] + 1)
    want = ref.selective_scan_bwd(*x, dy, dh_t, segments=segments)
    for name, g, w in zip(("dx", "ddt", "db", "dc", "da", "dd", "dh0"), got,
                          want):
        assert g.shape == w.shape, name
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= SCAN_BWD_REL_L2, (name, rel)
    again = scan.selective_scan_bwd(*x[:6], ckpt, dy, dh_t)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
def test_selective_scan_bwd_kernel_control_on_card(cuda):
    """The comparison can fail: the twin without the final state's
    gradient misses the limit on dh0, ddt and da."""
    from repro_torch.kernels import selective_scan as scan
    x, ckpt, dy, dh_t = _scan_grads(cuda, SCAN_CASES[0])
    got = scan.selective_scan_bwd(*x[:6], ckpt, dy, dh_t)
    wrong = ref.selective_scan_bwd(*x, dy, None)
    for i in (1, 4, 6):
        rel = ((got[i] - wrong[i]).norm() / wrong[i].norm()).item()
        assert rel > SCAN_BWD_REL_L2, i


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SCAN_CASES[3], SCAN_CASES[6]], ids=str)
def test_selective_scan_forward_checkpoints_on_card(cuda, case):
    """With checkpoints the forward writes the state at the start of every
    chunk (the twin's state there, to 1e-4) and the final one (h_T's
    bits), and y and h_T are bitwise those of the call without."""
    from repro_torch.kernels import selective_scan as scan
    x = _scan_inputs(cuda, case)
    b, t, din = x[0].shape
    n = x[4].shape[-1]
    y, h_t, ckpt = scan.selective_scan(*x, checkpoints=True)
    y2, h_t2, none = scan.selective_scan(*x)
    assert none is None and ckpt.shape == scan.checkpoint_shape(b, t, din, n)
    assert torch.equal(y, y2) and torch.equal(h_t, h_t2)
    assert torch.equal(ckpt[:, -1], h_t) and torch.equal(ckpt[:, 0], x[6])
    for k in range(1, ckpt.shape[1] - 1):
        _, h_k = ref.selective_scan(x[0][:, :k * scan.CHUNK],
                                    x[1][:, :k * scan.CHUNK],
                                    x[2][:, :k * scan.CHUNK],
                                    x[3][:, :k * scan.CHUNK], *x[4:])
        torch.testing.assert_close(ckpt[:, k], h_k, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_selective_scan_gradient_runs_the_backward_kernel_on_card(
        cuda, monkeypatch):
    """A CUDA operand that needs a gradient runs ``SelectiveScan``: one
    checkpointing forward and, for ``backward``, one backward kernel and
    one sum; the plain scan never runs.  The gradients equal autograd of
    the plain scan within SCAN_BWD_REL_L2."""
    from repro_torch.kernels import selective_scan as scan
    x = [v.detach().clone().requires_grad_(i != 6)
         for i, v in enumerate(_scan_inputs(cuda, SCAN_CASES[0]))]
    y_w, h_w = ops.selective_scan(*x, use_kernel=False)
    dy = torch.ones_like(y_w)
    want = torch.autograd.grad((y_w * dy).sum() + h_w.sum(), x[:6])

    def plain(*args):
        raise AssertionError("the plain scan ran on a CUDA tensor")

    monkeypatch.setattr(ref, "selective_scan", plain)
    monkeypatch.setattr(ref, "selective_scan_bwd", plain)
    before = ops.launch_counts()
    ckpts = scan.selective_scan.checkpoint_launches
    y, h_t = ops.selective_scan(*x)
    assert y.grad_fn is not None and h_t.grad_fn is not None
    got = torch.autograd.grad((y * dy).sum() + h_t.sum(), x[:6])
    after = ops.launch_counts()
    assert scan.selective_scan.checkpoint_launches == ckpts + 1
    for k in ("selective_scan", "selective_scan_bwd",
              "selective_scan_bwd_sum"):
        assert after[k] == before[k] + 1, k
    for g, w in zip(got, want):
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= SCAN_BWD_REL_L2


@pytest.mark.cuda
def test_hymba_mix_full_has_grad_fn_on_card(cuda):
    """The reduced hymba's mixer on the card with trainable parameters:
    its output and final SSM state carry a ``grad_fn`` (the window flash
    forward and the scan both differentiable), and a backward launches the
    window dq/dkv kernels and the scan's backward once each."""
    from repro_torch.configs import get_arch
    from repro_torch.models import hymba
    from repro_torch.models import transformer as tf
    cfg = get_arch("hymba-1.5b").reduced()
    model = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda, trainable=True)
    p = model.blocks[0]
    x = torch.from_numpy(_rand(3, (2, 70, cfg.d_model))).to(cuda)
    kw = dict(tf._attn_kwargs(cfg), causal=True)
    ops.reset_launch_counts()
    fused, _, h_fin = hymba.hymba_mix_full(p, x, kw, tf._norm(cfg))
    assert fused.grad_fn is not None and h_fin.grad_fn is not None
    torch.autograd.grad(fused.float().square().sum() + h_fin.sum(),
                        list(p.parameters()), allow_unused=True)
    counts = ops.launch_counts()
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "selective_scan",
              "selective_scan_bwd", "selective_scan_bwd_sum"):
        assert counts[k] == 1, (k, counts)


@pytest.fixture
def process_group(cuda, tmp_path):
    """Start a default process group of one rank: ``process_group(
    device_type)`` (NCCL for ``"cuda"``, gloo for ``"cpu"``); it is
    destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    def start(device_type):
        init_process_group(str(tmp_path), 0, 1, device_type=device_type)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_driver_on_nccl_world1_equals_srds_sample_on_card(
        cuda, process_group):
    import repro_torch.core as C
    from repro_torch.core.pipelined import (make_pipelined_sampler,
                                            make_sharded_sampler)
    from repro_torch.launch.mesh import make_srds_mesh
    process_group("cuda")
    mesh = make_srds_mesh(1)
    fn = _small_dit_fn(cuda)
    sched, solver = C.make_schedule("ddpm_linear", 16), C.SolverConfig("ddim")
    x0 = torch.from_numpy(_rand(5, (2, 16, 16, 4))).to(cuda)
    cfg = C.SRDSConfig(num_blocks=4, tol=1e-3, per_sample=True)
    runs = {}
    for name, samp in (("single", lambda x: C.srds_sample(fn, sched, solver,
                                                          x, cfg)),
                       ("sharded", make_sharded_sampler(
                           mesh, "time", fn, sched, solver, cfg))):
        ops.reset_launch_counts()
        runs[name] = (samp(x0), ops.launch_counts())
    (single, c1), (sharded, c2) = runs["single"], runs["sharded"]
    assert torch.equal(sharded.iterations, single.iterations)
    assert c2 == c1 and c2["flash_attention_fwd"] > 0
    rel = ((sharded.sample - single.sample).norm()
           / single.sample.norm()).item()
    assert rel <= 1e-6, rel
    res, steps, evals = make_pipelined_sampler(
        mesh, "time", fn, sched, solver, C.SRDSConfig(tol=0.0))(x0)
    seq = C.sample_sequential(fn, sched, solver, x0)
    torch.testing.assert_close(res.sample, seq, atol=1e-4, rtol=1e-4)
    assert (steps, evals) == (16 + 1 + 2, 2 * 16)    # + the ramp slack


@pytest.mark.cuda
@pytest.mark.parametrize("backend_device", ["cpu", "cuda"])
def test_drivers_refuse_a_tensor_the_backend_cannot_take_on_card(
        cuda, process_group, backend_device):
    """A CUDA tensor never runs on gloo and a CPU tensor never on NCCL:
    the drivers raise instead of switching backend or path."""
    import repro_torch.core as C
    from repro_torch.core.pipelined import (make_pipelined_sampler,
                                            make_sharded_sampler)
    from repro_torch.launch.mesh import make_srds_mesh
    process_group(backend_device)
    mesh = make_srds_mesh(1, device_type=backend_device)
    other = "cpu" if backend_device == "cuda" else "cuda"
    x0 = torch.zeros((1, 4), device=other)
    sched, solver = C.make_schedule("ddpm_linear", 8), C.SolverConfig("ddim")

    def model(x, t):
        return x
    for samp in (make_sharded_sampler(mesh, "time", model, sched, solver,
                                      C.SRDSConfig(num_blocks=2)),
                 make_pipelined_sampler(mesh, "time", model, sched, solver,
                                        C.SRDSConfig())):
        with pytest.raises(ValueError, match="process group"):
            samp(x0)


# --------------------------------------------------------------------------
# the rest of the LM zoo: the grouped matmul and the new head dims
# --------------------------------------------------------------------------

def _grouped_operands(cuda, dtype, rows=200, d=64, f=48, groups=(40, 0, 100,
                                                                  30)):
    x = torch.from_numpy(_rand(1, (rows, d))).to(cuda, dtype)
    w = torch.from_numpy(_rand(2, (len(groups), d, f))).to(cuda, dtype)
    return x, w, torch.tensor(groups, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grouped_matmul_route_on_card(cuda, dtype):
    """``models.moe.ragged_dot`` on the card: bf16 and f32 take
    ``torch._grouped_mm`` (``moe.GROUPED_MM_DTYPES``); each against the
    loop over groups in f32 on the same operands (bf16 within its rounding
    of the output), an empty group, the rows past the last group exactly 0
    forward and in the gradient; in bf16 at a zoo-like width (d 1024,
    f 512) no host sync (PyTorch's sync debug mode).  On an H100 (torch
    2.11) the library's f32 call synchronized at every width, and its
    bf16 call at d 64 x f 48 with rows past the last group (ROADMAP
    C23)."""
    import warnings
    from repro_torch.models import moe
    x, w, gs = _grouped_operands(cuda, DTYPES[dtype])
    x.requires_grad_(True)
    w.requires_grad_(True)
    got = moe.ragged_dot(x, w, gs)
    want = moe.ragged_dot_ref(x.detach().float(), w.detach().float(), gs)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    torch.testing.assert_close(got.float(), want, atol=tol * 8, rtol=tol)
    assert torch.equal(got[170:], torch.zeros_like(got[170:]))
    up = torch.ones_like(got)
    dx, dw = torch.autograd.grad(got, (x, w), up)
    assert torch.equal(dx[170:], torch.zeros_like(dx[170:]))
    assert torch.equal(dw[1], torch.zeros_like(dw[1]))
    if dtype == "bfloat16":
        x, w, gs = _grouped_operands(cuda, DTYPES[dtype], rows=256, d=1024,
                                     f=512, groups=(60, 0, 100, 70))
        moe.ragged_dot(x, w, gs)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.no_grad():
                    moe.ragged_dot(x, w, gs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(c.message) for c in caught
                 if "called a synchronizing CUDA operation"
                 in str(c.message)]
        assert not syncs, syncs


# the zoo's head dims on the tensor-core routes: kimi-k2's D 112 with group
# 8, phi-3-vision's D 96, hubert's non-causal D 80, and the
# TimeConditioned qwen3 backbone's non-causal GQA at D 128
ZOO_CASES = [(1, 16, 2, 256, 256, 112, dict(causal=True)),
             (1, 8, 8, 256, 256, 96, dict(causal=True)),
             (1, 8, 8, 300, 300, 80, dict(causal=False)),
             (1, 8, 2, 256, 256, 128, dict(causal=False))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZOO_CASES, ids=str)
def test_flash_fwd_and_bwd_at_zoo_head_dims_on_card(cuda, case):
    """B3 and B5 at the zoo's head dims, bf16, on their tensor-core
    routes (by route count): o and lse against the plain forward, dq, dk
    and dv against ``ref.attention_bwd`` (rel L2 within the forward's
    1e-4 and the backward's 1e-3)."""
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, sq, sk, d, mask = case
    q, k, v = _masked_qkv(cuda, case, "bfloat16")
    do = torch.from_numpy(_rand(9, (b, hq, sq, d))).to(cuda, torch.bfloat16)
    assert fa.fwd_route(q.dtype, d) == fa.bwd_route(q.dtype, d) == "tc"
    q3, do3 = (t.reshape(b * hq, sq, d) for t in (q, do))
    k3, v3 = (t.reshape(b * hkv, sk, d) for t in (k, v))
    before = ops.route_counts()
    o3, lse = fa.flash_attention_fwd(q3, k3, v3, **mask)
    dq, dk, dv = fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3, **mask)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert after[f"{name}_tc"] == before[f"{name}_tc"] + 1, name
    o_ref, lse_ref = ref.attention(q, k, v, **mask)

    def rel(got, want):
        got = torch.cat([g.float().reshape(-1) for g in got])
        want = torch.cat([w.float().reshape(-1) for w in want])
        return ((got - want).norm() / want.norm()).item()

    assert rel([o3], [o_ref]) <= 1e-4
    torch.testing.assert_close(lse.view(b, hq, sq), lse_ref, atol=F32_TOL,
                               rtol=F32_TOL)
    want = ref.attention_bwd(q, k, v, o3.view(q.shape), lse.view(b, hq, sq),
                             do, **mask)
    assert rel([dq], want[:1]) <= 1e-3
    assert rel([dk, dv], want[1:]) <= 1e-3


# ---- the tuning seam: a non-default candidate of each family -------------
# Each family launched on a config the heuristic tier does not give, pinned
# through KernelTuner(overrides=...), held to its plain version within the
# default's tolerance; launch_geometry shows what the call was given.

def _candidate(kernel, params):
    from repro_torch.kernels import tuning
    return tuning.KernelTuner(tables={"sm90": {
        "version": tuning.TABLE_SCHEMA_VERSION, "backend": "sm90",
        "entries": []}}, overrides={kernel: params})


ELEMENTWISE_CANDIDATE = {"ddim_threads": 128, "resid_threads": 256,
                         "resid_max_cluster": 4,
                         "resid_slice_per_block": 1024}


@pytest.mark.cuda
def test_elementwise_launch_candidate_on_card(cuda):
    """DDIM, the residual and the update on threads, clusters and spans
    the heuristics do not give: outputs bitwise the plain version's (one
    rounding of the same f32 values), sums within SUM_RTOL."""
    from repro_torch.kernels import elementwise as ew
    tuner = _candidate("elementwise", ELEMENTWISE_CANDIDATE)
    shape = (2, 64, 64, 4)
    y, cur, prev, old = (torch.from_numpy(_rand(i, shape)).to(cuda)
                         for i in range(4))
    geo = ew.launch_geometry("parareal_update_residual", shape,
                             torch.float32, tuner=tuner, device=cuda,
                             batch_dims=1)
    assert geo["config"].source == "override"
    assert geo["geometry"]["cluster"] == 4 and \
        geo["geometry"]["threads"] <= 256
    out, resid = ops.parareal_update_residual(y, cur, prev, old,
                                              batch_dims=1, tuner=tuner)
    want, want_r = ref.parareal_update_residual(y, cur, prev, old,
                                                batch_dims=1)
    assert torch.equal(out, want)
    torch.testing.assert_close(resid, want_r, rtol=SUM_RTOL, atol=0)
    out, resid = ops.parareal_update(y, cur, prev, tuner=tuner)
    want, want_r = ref.parareal_update(y, cur, prev)
    assert torch.equal(out, want)
    torch.testing.assert_close(resid, want_r, rtol=SUM_RTOL, atol=0)
    assert ew.launch_geometry("ddim_fused", shape, torch.float32,
                              tuner=tuner)["geometry"]["threads"] == 128
    got = ops.ddim_fused(y, cur, 0.9, 0.5, tuner=tuner)
    torch.testing.assert_close(got, ref.ddim_fused(y, cur, 0.9, 0.5),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_flash_build_candidate_on_card(cuda):
    """The tensor-core forward and backward built with 3-stage rings (a
    library of their own, ``-DFLASH_*_STAGES=3``) at a causal GQA bf16
    shape: within the default's rel L2 limits (1e-4 forward, 1e-3
    backward) of the plain version."""
    from repro_torch.kernels import _build, flash_attention as fa
    tuner = _candidate("flash", {"fwd_stages": 3, "bwd_stages": 3})
    case = MASKED_CASES[0]
    b, hq, hkv, sq, sk, d, mask = case
    geo = fa.launch_geometry(sq, sk, d, torch.bfloat16, tuner=tuner,
                             device=cuda)
    assert geo["fwd_defines"] == ("FLASH_FWD_STAGES=3",)
    assert geo["bwd_defines"] == ("FLASH_BWD_STAGES=3",)
    q, k, v = (t.requires_grad_(True)
               for t in _masked_qkv(cuda, case, "bfloat16"))
    do = torch.from_numpy(_rand(9, (b, hq, sq, d))).to(cuda, torch.bfloat16)
    o = ops.attention(q, k, v, tuner=tuner, **mask)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert ("flash_attention_fwd", geo["fwd_defines"]) in _build._libs
    assert ("flash_attention_bwd", geo["bwd_defines"]) in _build._libs
    o_ref, lse_ref = ref.attention(q.detach(), k.detach(), v.detach(),
                                   **mask)
    want = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                             lse_ref, do, **mask)

    def rel(g, w):
        g = torch.cat([x.float().reshape(-1) for x in g])
        w = torch.cat([x.float().reshape(-1) for x in w])
        return ((g - w).norm() / w.norm()).item()

    assert rel([o.detach()], [o_ref]) <= 1e-4
    assert rel(got[:1], want[:1]) <= 1e-3
    assert rel(got[1:], want[1:]) <= 1e-3


@pytest.mark.cuda
def test_wkv_launch_candidate_on_card(cuda):
    """The WKV backward's dv sum on blocks of 64 threads: the same sums in
    the same order, so every gradient is bitwise the default's."""
    tuner = _candidate("rwkv6", {"dv_sum_threads": 64})
    x = _wkv_inputs(cuda, WKV_CASES[2], "bfloat16", grad=True)
    dout = torch.from_numpy(_rand(7, tuple(x[2].shape))).to(
        cuda, torch.bfloat16)

    def grads(t):
        out, s_t = ops.rwkv6_wkv(*x, tuner=t)
        return torch.autograd.grad(out, x, dout)

    got, base = grads(tuner), grads(None)
    assert all(torch.equal(a, b) for a, b in zip(got, base))


@pytest.mark.cuda
def test_wkv_illegal_build_value_fails_at_build(cuda):
    """A build knob outside what the layout takes fails in nvcc (the
    source's static_assert), never at launch."""
    from repro_torch.kernels import _build, rwkv6_scan
    with pytest.raises(RuntimeError, match="WKV_FWD_COLS"):
        _build.load("rwkv6_wkv", rwkv6_scan._SIGNATURE,
                    ("WKV_FWD_COLS=16",))


@pytest.mark.cuda
def test_scan_candidate_on_card(cuda):
    """The scan forward on 32 channels a block in a 2-stage ring, and its
    backward on 16 channels a block, segments of 1 chunk (at most 8) and
    4-step sub-chunks (a build of its own): y and h_T within 1e-4 of the
    twin, every gradient within SCAN_BWD_REL_L2 of the twin at the
    backward's segment count."""
    from repro_torch.kernels import selective_scan as scan
    tuner = _candidate("selective_scan", {
        "channels": 32, "stages": 2, "bwd_channels": 16,
        "segment_chunks": 1, "max_segments": 8, "bwd_sub": 4})
    case = (2, 600, 200, 16, False)
    b, t, din, n, _ = case
    geo = scan.launch_geometry(b, t, din, n, tuner=tuner, device=cuda)
    assert geo["fwd"].channels == 32 and geo["stages"] == 2
    assert geo["bwd"].channels == 16 and geo["bwd"].segments == 5
    assert geo["defines"] == ("SCAN_BWD_SUB=4",)
    x = _scan_inputs(cuda, case)
    y, h_t, ckpt = scan.selective_scan(*x, checkpoints=True, tuner=tuner)
    y_ref, h_ref = ref.selective_scan(*x)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h_t, h_ref, atol=1e-4, rtol=1e-4)
    rng = np.random.default_rng(3)
    dy = torch.from_numpy(rng.standard_normal((b, t, din)).astype(
        np.float32)).to(cuda)
    got = scan.selective_scan_bwd(*x[:6], ckpt, dy, None, tuner=tuner)
    want = ref.selective_scan_bwd(*x, dy, None,
                                  segments=geo["bwd"].segments)
    for g, w in zip(got, want):
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= SCAN_BWD_REL_L2, rel
