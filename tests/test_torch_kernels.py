"""The port's kernels and their plain versions against the JAX package.

The same numpy inputs go through the JAX oracle (``repro.kernels.ref``),
the JAX Pallas kernel in interpret mode (TPU family, as the JAX package's
own tests run it on the CPU) and the port's plain version, which is what
``repro_torch.kernels.ops`` runs for CPU tensors.  The CUDA/Triton
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances: f32 results agree to 2e-5 (summation order differs between
frameworks), f32 gradients to 5e-5 (the JAX package's own gradient test's
limit: they sum one more product); bf16 outputs are compared after each
side rounds to bf16, so they may differ by one bf16 ulp of values of order
1 (2e-2); residual sums are f32 over the same f32 values, relative 1e-5.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bwd as jflash_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro_torch.kernels import ops, ref

F32_TOL = 2e-5
GRAD_F32_TOL = 5e-5
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_bwd_twin_matches_jax_kernels_and_grad(case, dtype):
    """``ref.attention_bwd`` against JAX's ``flash_attention_bwd`` (the
    ``_dq_kernel``/``_dkv_kernel`` bodies, interpreted) fed the same o and
    lse, and against ``jax.vjp`` through the JAX oracle."""
    b, h, sq, sk, d = case
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (
        _both(_rand(i, (b, h, s, d)), dtype)
        for i, s in enumerate((sq, sk, sk, sq)))
    o, lse = ref.attention(qt, kt, vt, causal=False)
    grads = ref.attention_bwd(qt, kt, vt, o, lse, dot, causal=False)
    assert [g.dtype for g in grads] == [qt.dtype] * 3
    q3, k3, v3, do3 = (x.reshape(b * h, -1, d) for x in (qj, kj, vj, doj))
    tiles = dict(causal=False, block_q=RAGGED_TILE, block_k=RAGGED_TILE,
                 interpret=True)
    jo, jlse = jflash(q3, k3, v3, **tiles)
    want_kernel = jflash_bwd(q3, k3, v3, jo, jlse, do3, **tiles)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention(q, k, v, causal=False),
                     qj, kj, vj)
    want_grad = vjp(doj)
    tol = BF16_TOL if dtype == "bfloat16" else GRAD_F32_TOL
    for got, wk, wg in zip(grads, want_kernel, want_grad):
        np.testing.assert_allclose(_np(got), _np(wk).reshape(got.shape),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(got), _np(wg), atol=tol, rtol=tol)


# (B, Hq, Hkv, Sq, Sk, D, mask): causal, ragged causal (Sq < Sk, group
# 2), sliding window with group 4 and group 5, a window without the causal
# mask (group 4, Sq > Sk)
MASKED_BWD_CASES = [(1, 2, 2, 64, 64, 32, dict(causal=True)),
                    (1, 4, 2, 40, 96, 32, dict(causal=True)),
                    (1, 8, 2, 64, 64, 16, dict(causal=True, window=20)),
                    (1, 5, 1, 48, 48, 16, dict(causal=True, window=24)),
                    (1, 4, 1, 50, 33, 16, dict(causal=False, window=16))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MASKED_BWD_CASES, ids=str)
def test_attention_bwd_twin_masks_and_groups_match_jax_kernels(case, dtype):
    """``ref.attention_bwd`` in its causal, sliding-window and GQA forms
    against JAX's ``flash_attention_bwd`` (``_dq_kernel``/``_dkv_kernel``
    interpreted, fed JAX's own o and lse) plus the group sum of
    ``repro.kernels.ops._flash_bwd``.  JAX rounds each query head's dk/dv
    partial to the input dtype before that sum, the port rounds the f32
    sum once: in bf16 the two differ by up to one bf16 ulp per partial,
    so bf16 dk/dv are held within ``group`` x 2e-2."""
    b, hq, hkv, sq, sk, d, mask = case
    group = hq // hkv
    (qt, qj), (dot, doj) = (_both(_rand(i, (b, hq, sq, d)), dtype)
                            for i in (0, 3))
    (kt, kj), (vt, vj) = (_both(_rand(i, (b, hkv, sk, d)), dtype)
                          for i in (1, 2))
    o, lse = ref.attention(qt, kt, vt, **mask)
    grads = ref.attention_bwd(qt, kt, vt, o, lse, dot, **mask)
    assert [tuple(g.shape) for g in grads] == [tuple(x.shape)
                                               for x in (qt, kt, vt)]
    q3, do3 = (x.reshape(b * hq, sq, d) for x in (qj, doj))
    k3, v3 = (x.reshape(b * hkv, sk, d) for x in (kj, vj))
    tiles = dict(block_q=RAGGED_TILE, block_k=RAGGED_TILE, interpret=True,
                 **mask)
    jo, jlse = jflash(q3, k3, v3, **tiles)
    jdq, jdk, jdv = jflash_bwd(q3, k3, v3, jo, jlse, do3, **tiles)
    jdk, jdv = (np.asarray(jnp.asarray(x, jnp.float32)).reshape(
        b * hkv, group, sk, d).sum(axis=1) for x in (jdk, jdv))
    tol = BF16_TOL if dtype == "bfloat16" else GRAD_F32_TOL
    for got, want, t in ((grads[0], _np(jdq), tol), (grads[1], jdk,
                                                      tol * group),
                         (grads[2], jdv, tol * group)):
        np.testing.assert_allclose(_np(got), want.reshape(got.shape),
                                   atol=t, rtol=t)


@pytest.mark.parametrize("mask", [dict(causal=False), dict(causal=True),
                                  dict(causal=True, window=5)], ids=str)
@pytest.mark.parametrize("case", ATTN_CASES[1:3] + [(2, 4, 24, 40, 16)],
                         ids=str)
def test_attention_function_grads_match_jax_grad(case, mask):
    """``torch.autograd.grad`` through the port's ``ops.attention`` (the
    ``FlashAttention`` Function, plain on the CPU) against ``jax.grad``
    through ``repro.kernels.ops.attention(use_kernel=True)`` (the custom
    VJP over the interpreted flash kernels), sin-sum loss, f32.  The last
    case is GQA (4 query heads over 2 KV heads)."""
    b, h, sq, sk, d = case
    hkv = 2 if h == 4 else h
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(_rand(i, (b, hh, s, d)), "float32")
        for i, (hh, s) in enumerate(((h, sq), (hkv, sk), (hkv, sk))))
    qkv = [x.requires_grad_() for x in (qt, kt, vt)]
    got = torch.autograd.grad(ops.attention(*qkv, **mask).sin().sum(), qkv)
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jops.attention(
        q, k, v, use_kernel=True, **mask))), (0, 1, 2))(qj, kj, vj)
    for g, w, name in zip(got, want, "qkv"):
        assert g.abs().max() > 0, name
        np.testing.assert_allclose(_np(g), _np(w), atol=GRAD_F32_TOL,
                                   rtol=GRAD_F32_TOL, err_msg=f"d{name}")


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


def _tc_forward_model(q, k, v, terms, *, causal, window=None, tile=64):
    """The tensor-core forward's arithmetic in plain PyTorch (bf16
    operands): S in f32 from the exact bf16 products, scaled to log2 units
    and masked with NEG_INF, the online (m, l, acc) over 64-key tiles with
    p in f32 and l summed from it, P written as ``terms`` bf16 terms
    (hi = bf16(p), mid = bf16(p - hi), ...) each multiplied by V and summed
    in f32, o = acc / l rounded to bf16."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[2]
    group = hq // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    c = (1.0 / np.sqrt(d)) * np.log2(np.e)
    keep = ref._keep(sq, sk, causal, window, q.device)
    m = torch.full((*q.shape[:3], 1), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, sk, tile):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kf[:, :, k0:k0 + tile]) * np.float32(c)
        s = torch.where(keep[:, k0:k0 + tile], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == ref.NEG_INF, 0.0, m_new)
        p = torch.exp2(s - base)
        l = l * torch.exp2(m - m_new) + p.sum(-1, keepdim=True)
        acc = acc * torch.exp2(m - m_new)
        rest = p
        for _ in range(terms):
            term = rest.bfloat16().float()
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", term,
                                     vf[:, :, k0:k0 + tile])
            rest = rest - term
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).bfloat16()


# (B, Hq, Hkv, Sq, Sk, D, mask): causal GQA at qwen3-8b's head dim, the
# DiT's non-causal head dim 72
TC_MODEL_CASES = [(1, 4, 2, 256, 256, 128, dict(causal=True)),
                  (1, 4, 4, 256, 256, 72, dict(causal=False))]
TC_REL_L2 = 1e-4          # chip_smoke.MASKED_REL_L2["bfloat16"]


@pytest.mark.parametrize("case", TC_MODEL_CASES, ids=str)
def test_tc_forward_numerics_model_against_jax_oracle(case):
    """The premise of the tensor-core forward, on the CPU: with P as the
    kernel's ``TC_TERMS`` bf16 terms, o (bf16) is within 1e-4 rel L2 of
    the JAX oracle's on the same bf16 inputs; with P rounded once to bf16
    it misses that limit (the CPU half of chip_smoke's phase-3 control)."""
    from repro_torch.kernels.flash_attention import TC_TERMS
    b, hq, hkv, sq, sk, d, mask = case
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(_rand(i, (b, h, s, d)), "bfloat16")
        for i, (h, s) in enumerate(((hq, sq), (hkv, sk), (hkv, sk))))
    want = _np(jref.attention(qj, kj, vj, **mask))
    rel = {}
    for terms in (1, TC_TERMS):
        got = _np(_tc_forward_model(qt, kt, vt, terms, **mask))
        rel[terms] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel[TC_TERMS] <= TC_REL_L2 < rel[1], rel


def _tc_backward_model(q, k, v, do, terms, *, causal, window=None):
    """The tensor-core backward's arithmetic in plain PyTorch (bf16
    operands): S and dP in f32 from the exact bf16 products, p = exp(s *
    scale - lse) in f32 (0 where masked), ds = p (dp - delta) scale, then
    P and dS each written as ``terms`` bf16 terms (hi = bf16(x), lo =
    bf16(x - hi), ...) whose products with dO, Q and K are summed in f32;
    dq, dk and dv (the group summed) rounded to bf16.  o and lse come from
    the f32 forward, so only the terms differ from exact arithmetic."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    b, hkv, sk = k.shape[0], k.shape[1], k.shape[2]
    group = hq // hkv
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o, lse = ref.attention(qf, kf, vf, causal=causal, window=window)
    kf = kf.repeat_interleave(group, dim=1)
    vf = vf.repeat_interleave(group, dim=1)
    scale = 1.0 / np.sqrt(d)
    keep = ref._keep(sq, sk, causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * o).sum(-1, keepdim=True)) * scale

    def in_terms(x):
        out, rest = torch.zeros_like(x), x
        for _ in range(terms):
            term = rest.bfloat16().float()
            out, rest = out + term, rest - term
        return out

    p, ds = in_terms(p), in_terms(ds)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, group, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(dim=2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


TC_BWD_REL_L2 = 1e-3      # chip_smoke.BWD_MASKED_REL_L2["bfloat16"]


@pytest.mark.parametrize("case", TC_MODEL_CASES, ids=str)
def test_tc_backward_numerics_model_against_jax_oracle(case):
    """The premise of the tensor-core backward, on the CPU: with P and dS
    as the kernels' ``BWD_TC_TERMS`` bf16 terms, dq and (dk, dv) (bf16)
    are within 1e-3 rel L2 of the JAX oracle's gradients on the same bf16
    inputs; with P and dS rounded once to bf16 both miss that limit (the
    CPU half of chip_smoke's phase-3 control)."""
    from repro_torch.kernels.flash_attention import BWD_TC_TERMS
    b, hq, hkv, sq, sk, d, mask = case
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (
        _both(_rand(i, (b, h, s, d)), "bfloat16")
        for i, (h, s) in enumerate(((hq, sq), (hkv, sk), (hkv, sk),
                                    (hq, sq))))
    f32 = [jnp.asarray(x, jnp.float32) for x in (qj, kj, vj, doj)]
    _, vjp = jax.vjp(lambda q, k, v: jref.attention(q, k, v, **mask),
                     *f32[:3])
    want = [_np(jnp.asarray(g, jnp.bfloat16)) for g in vjp(f32[3])]

    def rel(got, ref_):
        num = sum(float(np.sum((_np(g) - w) ** 2)) for g, w in zip(got, ref_))
        return np.sqrt(num / sum(float(np.sum(w ** 2)) for w in ref_))

    rels = {}
    for terms in (1, BWD_TC_TERMS):
        got = _tc_backward_model(qt, kt, vt, dot, terms, **mask)
        rels[terms] = (rel(got[:1], want[:1]), rel(got[1:], want[1:]))
    assert max(rels[BWD_TC_TERMS]) <= TC_BWD_REL_L2 < min(rels[1]), rels


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
# fused predictor-corrector update + L1 residual, and without it (B4)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7,), (3, 129), (2, 64, 64, 4),
                                   (5, 2, 8, 8, 4)], ids=str)
def test_parareal_update_twin_matches_jax_kernel(shape, dtype):
    """B4: ``out`` is bitwise the JAX kernel's (both round ``y + cur -
    prev`` once from f32) and the L1 sum of ``|cur - prev|`` agrees to
    1e-5 relative; in f32 the JAX oracle (which works in the input dtype)
    agrees as closely, in bf16 within two bf16 ulps (ROADMAP C6)."""
    (yt, yj), (ct, cj), (pt, pj) = (_both(_rand(i, shape), dtype)
                                    for i in range(3))
    out, resid = ref.parareal_update(yt, ct, pt)
    assert out.dtype == yt.dtype and out.shape == yt.shape
    assert resid.dtype == torch.float32 and resid.shape == ()
    jout, jres = jops.parareal_update(yj, cj, pj, use_kernel=True)
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_allclose(_np(resid), _np(jres), rtol=SUM_RTOL)
    rout, rres = jref.parareal_update(yj, cj, pj)
    if dtype == "float32":
        np.testing.assert_array_equal(_np(out), _np(rout))
        np.testing.assert_allclose(_np(resid), _np(rres), rtol=SUM_RTOL)
    else:
        np.testing.assert_allclose(_np(out), _np(rout), atol=BF16_TOL * 4,
                                   rtol=BF16_TOL * 4)
        # the oracle rounds each cur - prev to bf16 before it sums: every
        # term within 2^-9 relative, so the sum too
        np.testing.assert_allclose(_np(resid), _np(rres), rtol=2.0 ** -9)
    o2, r2 = ops.parareal_update(yt, ct, pt)
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


# --------------------------------------------------------------------------
# rwkv6 wkv
# --------------------------------------------------------------------------

# (B, H, T, Dk, Dv): tests/test_kernels.py's four shapes, one token, and
# rwkv6-1.6b's head dim
WKV_SHAPES = [(1, 1, 16, 8, 8), (2, 3, 40, 16, 16), (1, 2, 64, 32, 32),
              (1, 1, 7, 8, 8), (2, 3, 1, 16, 16), (1, 2, 20, 64, 64)]


def _wkv_inputs(shape, seed=0):
    b, h, t, dk, dv = shape
    return (_rand(seed, (b, h, t, dk)) * 0.5, _rand(seed + 1, (b, h, t, dk))
            * 0.5, _rand(seed + 2, (b, h, t, dv)) * 0.5,
            _rand(seed + 3, (b, h, t, dk)) * 0.5 - 1.0,
            _rand(seed + 4, (h, dk)) * 0.3,
            _rand(seed + 5, (b, h, dk, dv)) * 0.2)


@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_rwkv6_wkv_twin_matches_jax_kernel_and_oracle(shape):
    """The port's twin (``ops.rwkv6_wkv`` on CPU tensors) against JAX's
    ``ops.rwkv6_wkv(use_kernel=True)`` (the TPU-family Pallas kernel,
    interpreted) and the JAX oracle, from a nonzero state."""
    r, k, v, w, u, s0 = _wkv_inputs(shape)
    out, s_t = ops.rwkv6_wkv(*(torch.from_numpy(x)
                               for x in (r, k, v, w, u, s0)))
    assert out.dtype == torch.float32 and s_t.dtype == torch.float32
    j = [jnp.asarray(x, jnp.float32) for x in (r, k, v, w, u, s0)]
    for jout, js in (jops.rwkv6_wkv(*j, use_kernel=True), jref.rwkv6_wkv(*j)):
        np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(s_t), _np(js), atol=1e-5, rtol=1e-5)


def test_rwkv6_wkv_state_chaining_and_zero_state():
    """Two calls carrying the state equal one call over [T1 | T2], as in
    JAX; ``state=None`` is the zero state."""
    r, k, v, w, u, _ = (torch.from_numpy(x)
                        for x in _wkv_inputs((1, 2, 32, 8, 8)))
    full, s_full = ops.rwkv6_wkv(r, k, v, w, u)
    zero = torch.zeros(1, 2, 8, 8)
    torch.testing.assert_close(ops.rwkv6_wkv(r, k, v, w, u, zero)[0], full,
                               atol=0, rtol=0)
    o1, s1 = ops.rwkv6_wkv(*(x[:, :, :20] for x in (r, k, v, w)), u)
    o2, s2 = ops.rwkv6_wkv(*(x[:, :, 20:] for x in (r, k, v, w)), u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], dim=2), full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(s2, s_full, atol=1e-5, rtol=1e-5)
    j = [jnp.asarray(x.numpy(), jnp.float32) for x in (r, k, v, w, u)]
    jout, js = jops.rwkv6_wkv(*j, use_kernel=True)
    np.testing.assert_allclose(_np(full), _np(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(s_full), _np(js), atol=1e-5, rtol=1e-5)


def test_rwkv6_wkv_bf16_rkv_with_f32_decay():
    """The model's mix of dtypes: r, k, v in bf16, w, u and the state f32;
    out comes back in v's dtype, the state in f32.  Both sides compute in
    f32 from the same bf16 values and round out once."""
    r, k, v, w, u, s0 = _wkv_inputs((2, 2, 24, 16, 16), seed=7)
    (rt, rj), (kt, kj), (vt, vj) = (_both(x, "bfloat16") for x in (r, k, v))
    out, s_t = ops.rwkv6_wkv(rt, kt, vt, torch.from_numpy(w),
                             torch.from_numpy(u), torch.from_numpy(s0))
    assert out.dtype == torch.bfloat16 and s_t.dtype == torch.float32
    jout, js = jref.rwkv6_wkv(rj, kj, vj, jnp.asarray(w), jnp.asarray(u),
                              jnp.asarray(s0))
    assert jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(_np(s_t), _np(js), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_rwkv6_wkv_bwd_twin_matches_autograd_and_jax_vjp(shape):
    """``ref.rwkv6_wkv_bwd`` (the backward kernel's reverse scan) against
    autograd through the port's ``ref.rwkv6_wkv`` and ``jax.vjp`` of
    ``repro.kernels.ref.rwkv6_wkv`` (JAX's ``ops._wkv_bwd``), with
    upstream gradients on both out and the final state: every gradient,
    ``du`` (summed over the batch) and ``ds0`` included, to 1e-5 (f32,
    other summation orders)."""
    r, k, v, w, u, s0 = _wkv_inputs(shape)
    dout = _rand(11, (shape[0], shape[1], shape[2], shape[4]))
    ds_t = _rand(12, s0.shape)
    t = [torch.from_numpy(x) for x in (r, k, v, w, u, s0)]
    got = ref.rwkv6_wkv_bwd(*t, torch.from_numpy(dout),
                            torch.from_numpy(ds_t))
    assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in t]
    assert all(g.dtype == torch.float32 for g in got)
    leaves = [x.clone().requires_grad_() for x in t]
    out, s_t = ref.rwkv6_wkv(*leaves)
    want_t = torch.autograd.grad((out, s_t), leaves,
                                 (torch.from_numpy(dout),
                                  torch.from_numpy(ds_t)))
    _, vjp = jax.vjp(jref.rwkv6_wkv, *(jnp.asarray(x, jnp.float32)
                                       for x in (r, k, v, w, u, s0)))
    want_j = vjp((jnp.asarray(dout), jnp.asarray(ds_t)))
    for g, wt, wj in zip(got, want_t, want_j):
        np.testing.assert_allclose(_np(g), _np(wt), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(g), _np(wj), atol=1e-5, rtol=1e-5)


def test_rwkv6_wkv_bwd_twin_bf16_and_zero_upstream_state():
    """The model's dtypes (r, k, v bf16; w, u, state f32) and no gradient
    on the final state: dr, dk, dv come back in bf16, rounded once from
    the f32 values JAX's vjp computes."""
    r, k, v, w, u, s0 = _wkv_inputs((2, 2, 24, 16, 16), seed=7)
    (rt, rj), (kt, kj), (vt, vj) = (_both(x, "bfloat16") for x in (r, k, v))
    (dot, doj) = _both(_rand(13, v.shape), "bfloat16")
    got = ref.rwkv6_wkv_bwd(rt, kt, vt, torch.from_numpy(w),
                            torch.from_numpy(u), torch.from_numpy(s0), dot)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [
        torch.float32] * 3
    _, vjp = jax.vjp(lambda *a: jref.rwkv6_wkv(*a)[0], rj, kj, vj,
                     *(jnp.asarray(x) for x in (w, u, s0)))
    for g, wj in zip(got, vjp(doj)):
        tol = BF16_TOL if g.dtype == torch.bfloat16 else 1e-4
        np.testing.assert_allclose(_np(g), _np(wj), atol=tol, rtol=tol)


def test_rwkv6_wkv_op_carries_a_grad_fn_on_cpu():
    """``ops.rwkv6_wkv`` runs through ``RWKV6WKV`` (its gradient is the
    plain backward on the CPU); ``use_kernel=False`` is the plain scan
    under autograd."""
    t = [torch.from_numpy(x).requires_grad_()
         for x in _wkv_inputs((1, 2, 9, 8, 8))]
    out, s_t = ops.rwkv6_wkv(*t)
    assert type(out.grad_fn).__name__ == "RWKV6WKVBackward"
    assert out.grad_fn is s_t.grad_fn
    plain, _ = ops.rwkv6_wkv(*t, use_kernel=False)
    assert type(plain.grad_fn).__name__ != "RWKV6WKVBackward"
    got = torch.autograd.grad(out.square().sum() + s_t.sum(), t)
    want = torch.autograd.grad(plain.square().sum()
                               + ops.rwkv6_wkv(*t, use_kernel=False)[1]
                               .sum(), t)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert ops.rwkv6_wkv(*t)[0].grad_fn is None


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.ones(4, 8)
    ops.ddim_fused(x, x, 0.5, 0.6)
    ops.parareal_update_residual(x, x, x, x)
    ops.parareal_update(x, x, x)
    ops.attention(x[None, None], x[None, None], x[None, None], causal=False)
    q = x[None, None].requires_grad_()
    torch.autograd.grad(ops.attention(q, q, q, causal=False).sum(), q)
    r = x.reshape(1, 2, 2, 8).requires_grad_()
    torch.autograd.grad(ops.rwkv6_wkv(r, r, r, r, torch.ones(2, 8))[0]
                        .sum(), r)
    assert ops.launch_counts() == {"flash_attention_fwd": 0,
                                   "flash_attention_bwd_dq": 0,
                                   "flash_attention_bwd_dkv": 0,
                                   "ddim_fused": 0,
                                   "parareal_update_residual": 0,
                                   "parareal_update": 0,
                                   "rwkv6_wkv": 0,
                                   "rwkv6_wkv_bwd": 0}
    assert ops.route_counts() == {"flash_attention_fwd_tc": 0,
                                  "flash_attention_fwd_simt": 0,
                                  "flash_attention_bwd_dq_tc": 0,
                                  "flash_attention_bwd_dq_simt": 0,
                                  "flash_attention_bwd_dkv_tc": 0,
                                  "flash_attention_bwd_dkv_simt": 0}


def test_kernel_wrappers_refuse_cpu_tensors_and_unported_forms():
    from repro_torch.kernels import elementwise, rwkv6_scan
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_terms, flash_attention_fwd,
        flash_attention_fwd_terms)
    x = torch.ones(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        elementwise.ddim_fused(x, x, torch.tensor(0.5), torch.tensor(0.6))
    with pytest.raises(ValueError, match="CUDA"):
        elementwise.parareal_update_residual(x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        elementwise.parareal_update(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x)
    # the forward takes the causal, window and GQA forms: a CPU tensor is
    # all it refuses
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(torch.ones(4, 16, 8), x, x, window=4)
    with pytest.raises(ValueError, match="group"):
        flash_attention_fwd(torch.ones(3, 16, 8), x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_terms(x.bfloat16(), x.bfloat16(), x.bfloat16(),
                                  1, causal=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_fwd_terms(x, x, x, 3)
    lse2 = torch.zeros(2, 16)
    xb = x.bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_terms(xb, xb, xb, xb, lse2, xb, 1, causal=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_bwd_terms(x, x, x, x, lse2, x, 2)
    xd = torch.ones(2, 16, 12, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_bwd_terms(xd, xd, xd, xd, lse2, xd, 2)
    r = x.reshape(1, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan.rwkv6_wkv(r, r, r, r, torch.ones(2, 8),
                             torch.zeros(1, 2, 8, 8))
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, x, lse, x)
    # the backward takes every mask and group form too; what it refuses
    # is a head dim over 128, mixed dtypes and operands off the card
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(torch.ones(4, 16, 8), x, x, torch.ones(4, 16, 8),
                            torch.zeros(4, 16), torch.ones(4, 16, 8),
                            causal=True, window=4)
    wide = torch.ones(2, 16, 136)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(wide, wide, wide, wide, lse, wide, causal=True)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_bwd(x, x.bfloat16(), x, x, lse, x, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan.rwkv6_wkv_bwd(r, r, r, r, torch.ones(2, 8),
                                 torch.zeros(1, 2, 1, 8, 8), r)


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """Each source's library is keyed by its own text and by every header
    in csrc/ (the flash kernels include sm90_tc.cuh): editing the header
    changes both flash libraries' keys, so no stale library is loaded;
    editing one source changes only its own key."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("flash_attention_fwd", "flash_attention_bwd")
    before = {n: _build._target(n) for n in names}
    assert before == {n: _build._target(n) for n in names}
    header = csrc / "sm90_tc.cuh"
    assert all('#include "sm90_tc.cuh"' in (csrc / f"{n}.cu").read_text()
               for n in names)
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "flash_attention_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = {n: _build._target(n) for n in names}
    assert edited["flash_attention_bwd"] != after["flash_attention_bwd"]
    assert edited["flash_attention_fwd"] == after["flash_attention_fwd"]


def test_build_targets_sources_by_hash(monkeypatch):
    """Every CUDA source builds to its own library keyed by the source's
    hash, inside the package's ignored build directory; without nvcc the
    build raises instead of falling back."""
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention_bwd", "flash_attention_fwd",
                                "rwkv6_wkv"]
    target = _build._target("flash_attention_fwd")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libflash_attention_fwd-")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
