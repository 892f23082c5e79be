"""The port's kernels and their plain versions against the JAX package.

The same numpy inputs go through the JAX oracle (``repro.kernels.ref``),
the JAX Pallas kernel in interpret mode (TPU family, as the JAX package's
own tests run it on the CPU) and the port's plain version, which is what
``repro_torch.kernels.ops`` runs for CPU tensors.  The CUDA/Triton
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances: f32 results agree to 2e-5 (summation order differs between
frameworks); bf16 outputs are compared after each side rounds to bf16, so
they may differ by one bf16 ulp of values of order 1 (2e-2); residual sums
are f32 over the same f32 values, relative 1e-5.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro_torch.kernels import ops, ref

F32_TOL = 2e-5
BF16_TOL = 2e-2
SUM_RTOL = 1e-5
RAGGED_TILE = 32          # JAX flash tile for the ragged-tile cases
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

# (B, H, Sq, Sk, D): SD-v2's head dim 72, CIFAR's 64, ragged Sk
ATTN_CASES = [(1, 2, 64, 64, 64), (2, 2, 48, 48, 72), (1, 3, 40, 77, 72),
              (1, 2, 33, 50, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_twin_matches_jax_kernel_and_oracle(case, dtype):
    b, h, sq, sk, d = case
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(_rand(i, (b, h, s, d)), dtype)
        for i, s in enumerate((sq, sk, sk)))
    o, lse = ref.attention(qt, kt, vt, causal=False)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert lse.shape == (b, h, sq)
    jo, jlse = jflash(qj.reshape(b * h, sq, d), kj.reshape(b * h, sk, d),
                      vj.reshape(b * h, sk, d), causal=False,
                      block_q=RAGGED_TILE, block_k=RAGGED_TILE,
                      interpret=True)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(o), _np(jo).reshape(o.shape),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(jlse).reshape(lse.shape),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(_np(o), _np(jref.attention(qj, kj, vj,
                                                          causal=False)),
                               atol=tol, rtol=tol)
    # the CPU dispatch is the twin, with or without use_kernel
    torch.testing.assert_close(ops.attention(qt, kt, vt, causal=False), o,
                               atol=0, rtol=0)
    torch.testing.assert_close(ops.attention(qt, kt, vt, causal=False,
                                             use_kernel=False), o,
                               atol=0, rtol=0)


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=5),
                                  dict(causal=False, window=7)], ids=str)
def test_attention_twin_full_signature(mask):
    """Causal, sliding-window and GQA masks, right-aligned queries
    (Sq < Sk), against the JAX oracle in f32."""
    b, hq, hkv, sq, sk, d = 2, 4, 2, 24, 40, 16
    qt, qj = _both(_rand(0, (b, hq, sq, d)), "float32")
    kt, kj = _both(_rand(1, (b, hkv, sk, d)), "float32")
    vt, vj = _both(_rand(2, (b, hkv, sk, d)), "float32")
    o, _ = ref.attention(qt, kt, vt, **mask)
    want = jref.attention(qj, kj, vj, **mask)
    np.testing.assert_allclose(_np(o), _np(want), atol=F32_TOL, rtol=F32_TOL)


# --------------------------------------------------------------------------
# fused DDIM update
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7,), (3, 129), (2, 8, 8, 4)], ids=str)
def test_ddim_fused_twin_matches_jax(shape, dtype):
    xt, xj = _both(_rand(0, shape), dtype)
    et, ej = _both(_rand(1, shape), dtype)
    a, b = np.float32(0.31), np.float32(0.47)
    out = ref.ddim_fused(xt, et, a, b)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(out), _np(jref.ddim_fused(xj, ej, a, b)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(out), _np(jops.ddim_fused(xj, ej, a, b, use_kernel=True)),
        atol=tol, rtol=tol)
    torch.testing.assert_close(ops.ddim_fused(xt, et, a, b), out,
                               atol=0, rtol=0)


def test_ddim_fused_per_row_coefficients():
    """Per-row ``(a, b)``: each row equals the scalar form at its own pair
    (the B blocks folded into the batch sit at different grid points)."""
    m = 5
    xt, xj = _both(_rand(0, (m, 3, 4)), "float32")
    et, ej = _both(_rand(1, (m, 3, 4)), "float32")
    a = np.linspace(0.05, 0.6, m).astype(np.float32)
    b = np.linspace(0.2, 0.9, m).astype(np.float32)
    out = ops.ddim_fused(xt, et, torch.from_numpy(a), torch.from_numpy(b))
    for r in range(m):
        np.testing.assert_allclose(
            _np(out[r]), _np(jops.ddim_fused(xj[r], ej[r], a[r], b[r],
                                             use_kernel=True)),
            atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(out[r], ref.ddim_fused(xt[r], et[r], a[r],
                                                          b[r]),
                                   atol=0, rtol=0)


# --------------------------------------------------------------------------
# fused predictor-corrector update + L1 residual
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch_dims,shape", [(0, (33, 5)), (0, (2, 3, 7)),
                                              (1, (3, 129)), (1, (2, 8, 8, 4)),
                                              (2, (3, 2, 7)),
                                              (2, (2, 2, 4, 4, 4))], ids=str)
def test_parareal_update_residual_twin_matches_jax(batch_dims, shape, dtype):
    (yt, yj), (ct, cj), (pt, pj), (ot, oj) = (
        _both(_rand(i, shape), dtype) for i in range(4))
    out, resid = ref.parareal_update_residual(yt, ct, pt, ot,
                                              batch_dims=batch_dims)
    assert out.dtype == yt.dtype and resid.dtype == torch.float32
    assert resid.shape == shape[:batch_dims]
    jout, jres = jops.parareal_update_residual(yj, cj, pj, oj,
                                               batch_dims=batch_dims,
                                               use_kernel=True)
    # the twin rounds once from f32 like the JAX kernel: bitwise-equal out
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_allclose(_np(resid), _np(jres), rtol=SUM_RTOL)
    # the JAX oracle rounds the update twice in bf16 (ROADMAP C3)
    rout, rres = jref.parareal_update_residual(yj, cj, pj, oj,
                                               batch_dims=batch_dims)
    tol = BF16_TOL * 4 if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(out), _np(rout), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(resid), _np(rres), rtol=SUM_RTOL)
    o2, r2 = ops.parareal_update_residual(yt, ct, pt, ot,
                                          batch_dims=batch_dims)
    torch.testing.assert_close(o2, out, atol=0, rtol=0)
    torch.testing.assert_close(r2, resid, atol=0, rtol=0)


def test_parareal_residual_slices_independent_of_batch():
    """A slice's residual is bitwise the same alone or in a K-batch."""
    shape = (4, 3, 50)
    y, c, p, o = (torch.from_numpy(_rand(i, shape)) for i in range(4))
    _, batch = ops.parareal_update_residual(y, c, p, o, batch_dims=1)
    for k in range(shape[0]):
        _, alone = ops.parareal_update_residual(y[k:k + 1], c[k:k + 1],
                                                p[k:k + 1], o[k:k + 1],
                                                batch_dims=1)
        assert alone.item() == batch[k].item()


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.ones(4, 8)
    ops.ddim_fused(x, x, 0.5, 0.6)
    ops.parareal_update_residual(x, x, x, x)
    ops.attention(x[None, None], x[None, None], x[None, None], causal=False)
    assert ops.launch_counts() == {"flash_attention_fwd": 0, "ddim_fused": 0,
                                   "parareal_update_residual": 0}


def test_kernel_wrappers_refuse_cpu_tensors_and_unported_forms():
    from repro_torch.kernels import elementwise
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    x = torch.ones(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        elementwise.ddim_fused(x, x, torch.tensor(0.5), torch.tensor(0.6))
    with pytest.raises(ValueError, match="CUDA"):
        elementwise.parareal_update_residual(x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x)
    with pytest.raises(NotImplementedError, match="B3"):
        flash_attention_fwd(x, x, x, causal=True)
    with pytest.raises(NotImplementedError, match="B3"):
        flash_attention_fwd(torch.ones(4, 16, 8), x, x)


def test_build_targets_sources_by_hash(monkeypatch):
    """Every CUDA source builds to its own library keyed by the source's
    hash, inside the package's ignored build directory; without nvcc the
    build raises instead of falling back."""
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention_fwd"]
    target = _build._target("flash_attention_fwd")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libflash_attention_fwd-")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
