"""The port's MoE layer and MoE language models on one process against the
JAX package: routing (``models.moe.route`` against JAX's ``_route``),
the grouped matmul (``ragged_dot`` against a loop over groups and JAX's
``jax.lax.ragged_dot``), ``moe_local`` (output, aux and every gradient,
the router's included), and the reduced MoE models' ``forward_train``
(logits and aux), ``prefill``, ``decode_step`` and two train steps from
JAX's state.

Configs: reduced f32 ``arctic-480b`` (4 experts, top 2, the dense
residual MLP), a narrow kimi (16 experts, top 8), and variants without
the dense residual and with GELU.  The trees are JAX's init with every
leaf moved by a numpy draw, carried by ``load_jax_params``; JAX runs with
``use_kernel=False``.

Tolerances (f32 on both sides): ``REL_L2`` (1e-5) relative L2 for
outputs, logits and gradients (read: 1e-7 to 2e-6), the aux and losses
``RTOL`` (1e-5) relative, the train steps as
``tests/test_torch_lm_train.py`` holds them.  Top-k ids are equal.  The
control, which must miss: routing weights left unnormalised over the
chosen k.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import optim as topt
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train import lm_loss, make_train_step

REL_L2 = 1e-5
RTOL = 1e-5
UPDATE_REL_L2 = 1e-3
# name: (base arch, replaced fields)
VARIANTS = {
    "arctic": ("arctic-480b", {}),
    "kimi16x8": ("kimi-k2-1t-a32b", dict(moe_experts=16, moe_top_k=8)),
    "nodense": ("arctic-480b", dict(moe_dense_residual=False)),
    "gelu": ("arctic-480b", dict(act="gelu")),
}


def _cfgs(name):
    arch, kw = VARIANTS[name]
    return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


def _tree(name, seed=0):
    jcfg, _ = _cfgs(name)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)),
        jtf.init_params(jcfg, jax.random.PRNGKey(0)))


def _rel_l2(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _moe_params(name, seed=0):
    """Layer 0's MoE leaves: (JAX's, the port's with gradients)."""
    tree = _tree(name, seed)
    j = {k: jnp.asarray(v[0], jnp.float32)
         for k, v in tree["blocks"]["moe"].items()}
    t = {k: torch.from_numpy(np.array(v[0])).requires_grad_(True)
         for k, v in tree["blocks"]["moe"].items()}
    return j, t


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# routing, the grouped matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["arctic", "kimi16x8"])
def test_route_matches_jax(name):
    """Top-k ids equal, renormalised weights and the Switch aux close to
    JAX's ``_route``; rows of zeros (an EP chunk's padding: a uniform
    softmax, every probability tied) pick the lowest expert ids, as
    ``jax.lax.top_k`` does."""
    jcfg, cfg = _cfgs(name)
    jp, tp = _moe_params(name)
    x = _x(1, (24, 64))
    x[-3:] = 0.0
    jv, ji, jaux = jmoe._route(jp["router"], jnp.asarray(x), cfg.moe_top_k)
    tv, ti, taux = moe.route(tp["router"].detach(), torch.from_numpy(x),
                             cfg.moe_top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ti[-1].numpy(), np.arange(cfg.moe_top_k))
    assert _rel_l2(tv, jv) <= REL_L2
    assert float(taux) == pytest.approx(float(jaux), rel=RTOL)


def test_ragged_dot_matches_a_loop_and_jax():
    """The grouped matmul (``torch._grouped_mm`` here) against the loop
    over groups and ``jax.lax.ragged_dot``: empty groups, and rows past
    the last group exactly 0; gradients against the loop's."""
    x = _x(2, (20, 16))
    w = _x(3, (4, 16, 8))
    gs = np.array([5, 0, 9, 3])            # 17 of 20 rows
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    got = moe.ragged_dot(xt, wt, torch.from_numpy(gs))
    loop = moe.ragged_dot_ref(xt, wt, torch.from_numpy(gs))
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(gs, jnp.int32))
    assert _rel_l2(got, want) <= REL_L2
    assert torch.equal(got[17:], torch.zeros((3, 8)))
    up = torch.from_numpy(_x(4, (20, 8)))
    g1 = torch.autograd.grad(got, (xt, wt), up)
    g2 = torch.autograd.grad(loop, (xt, wt), up)
    for a, b in zip(g1, g2):
        assert _rel_l2(a, b.numpy()) <= REL_L2
    assert torch.equal(g1[1][1], torch.zeros((16, 8)))
    # rows that are not multiples of 16 bytes, or another dtype, raise
    with pytest.raises(ValueError, match="16 bytes"):
        moe.ragged_dot(torch.zeros((2, 6)), torch.zeros((1, 6, 8)),
                       torch.tensor([2]))
    with pytest.raises(ValueError, match="16 bytes"):
        moe.ragged_dot(torch.zeros((2, 8), dtype=torch.float64),
                       torch.zeros((1, 8, 8), dtype=torch.float64),
                       torch.tensor([2]))


# --------------------------------------------------------------------------
# moe_local
# --------------------------------------------------------------------------

def _moe_local_pair(name, unnormalised=False):
    """moe_local's output, aux and the gradients of ``sum(out * U) + aux``
    (x and every leaf) in JAX and in the port."""
    _, cfg = _cfgs(name)
    jp, tp = _moe_params(name)
    x = _x(5, (2, 9, 64))
    up = _x(6, (2, 9, 64))

    def jloss(p, xx):
        out, aux = jmoe.moe_local(p, xx, cfg.moe_top_k, cfg.act)
        return jnp.sum(out * up) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(jp,
                                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    real = moe.route
    if unnormalised:
        def route(router_w, x_flat, top_k):
            probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
            v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
            return v[:, :top_k], i[:, :top_k], real(router_w, x_flat,
                                                    top_k)[2]
        moe.route = route
    try:
        out, aux = moe.moe_local(tp, xt, cfg.moe_top_k, cfg.act)
    finally:
        moe.route = real
    names = sorted(tp)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(up)) + aux,
                                [xt] + [tp[k] for k in names])
    return (out, aux, dict(zip(["x"] + names, grads)),
            (jout, jaux, dict(jg[0], x=jg[1])))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_moe_local_matches_jax(name):
    """Output, aux, and the gradients of x, the router and every expert
    leaf against JAX's ``moe_local``."""
    out, aux, grads, (jout, jaux, jg) = _moe_local_pair(name)
    assert _rel_l2(out, jout) <= REL_L2
    assert aux.item() == pytest.approx(float(jaux), rel=RTOL)
    assert sorted(grads) == sorted(jg)
    for k, g in grads.items():
        assert _rel_l2(g, jg[k]) <= REL_L2, k


def test_unnormalised_weights_miss_jax():
    """The control: the top-k weights left as the softmax gives them
    misses JAX's output by far more than the limit."""
    out, _, _, (jout, _, _) = _moe_local_pair("arctic", unnormalised=True)
    assert _rel_l2(out, jout) > 100 * REL_L2


# --------------------------------------------------------------------------
# the MoE models
# --------------------------------------------------------------------------

def _tokens(seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_train_logits_and_aux_match_jax(name):
    jcfg, cfg = _cfgs(name)
    tree = _tree(name)
    toks = _tokens(0)
    jl, jaux, _ = jtf.forward_train(jcfg, jax.tree.map(jnp.asarray, tree),
                                    {"tokens": jnp.asarray(toks)},
                                    use_kernel=False)
    model = tf.load_jax_params(cfg, tree, device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        tl = tf.forward_train(cfg, model, batch)
        _, taux, _ = tf.forward_hidden(cfg, model, batch)
    assert _rel_l2(tl, jl) <= REL_L2
    assert float(taux) == pytest.approx(float(jaux), rel=RTOL)
    assert float(taux) > 0
    # the model's leaves: the experts, the router in f32, the dense MLP
    # only beside them
    p = model.blocks[0]
    assert "moe" in p and p["moe"]["router"].dtype == torch.float32
    assert ("mlp" in p) == cfg.moe_dense_residual
    assert ("w_gate" in p["moe"]) == (cfg.act == "swiglu")


@pytest.mark.parametrize("name", ["arctic", "kimi16x8"])
def test_prefill_and_decode_steps_match_jax(name):
    """The prefill's last logits and three greedy decode steps through
    the MoE blocks against JAX's."""
    jcfg, cfg = _cfgs(name)
    tree = _tree(name)
    jp = jax.tree.map(jnp.asarray, tree)
    toks = _tokens(1)
    jlog, jcache = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               use_kernel=False)
    jcache = tuple(jnp.pad(c, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
                   for c in jcache)
    model = tf.load_jax_params(cfg, tree, device="cpu")
    tlog, tcache = tf.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                              cache_len=toks.shape[1] + 3)
    assert _rel_l2(tlog, jlog) <= REL_L2
    for i in range(3):
        tok = np.array(jnp.argmax(jlog[:, :cfg.vocab_size], -1))
        assert np.array_equal(tlog[:, :cfg.vocab_size].argmax(-1).numpy(),
                              tok)
        jlog, jcache = jtf.decode_step(jcfg, jp,
                                       {"tokens": jnp.asarray(tok)[:, None]},
                                       jcache, jnp.int32(toks.shape[1] + i),
                                       use_kernel=False)
        tlog, tcache = tf.decode_step(cfg, model,
                                      {"tokens": torch.from_numpy(tok)[:, None]},
                                      tcache, toks.shape[1] + i)
        assert _rel_l2(tlog, jlog) <= REL_L2


def test_lm_loss_and_gradients_match_jax():
    """``lm_loss`` (CE plus ``AUX_COEF`` times the aux) and every
    parameter's gradient against ``jax.grad`` of JAX's."""
    jcfg, cfg = _cfgs("arctic")
    tree = _tree("arctic", seed=1)
    toks = _tokens(2)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    (jv, jm), jg = jax.value_and_grad(
        lambda p: jlosses.lm_loss(jcfg, p, jb, use_kernel=False),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    model = tf.load_jax_params(cfg, tree, device="cpu", trainable=True)
    t = torch.from_numpy(toks)
    loss, m = lm_loss(cfg, model, {"tokens": t, "labels": t})
    assert loss.item() == pytest.approx(float(jv), rel=RTOL)
    assert m["aux"].item() == pytest.approx(float(jm["aux"]), rel=RTOL)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    for name, path, layer in tf.jax_leaf_names(cfg):
        leaf = jg
        for part in path.split("/"):
            leaf = leaf[part]
        want = np.asarray(leaf if layer is None else leaf[layer])
        assert _rel_l2(grads[name], want) <= REL_L2, name


def test_two_train_steps_continue_jax_state():
    """Two AdamW steps of ``make_train_step`` on reduced arctic, each
    from JAX's state entering it: loss, aux and grad norm, and every
    parameter's update, against JAX's step."""
    jcfg, cfg = _cfgs("arctic")
    jo = jopt.AdamWConfig(lr=1e-3)
    jstep = jsteps.make_train_step(jcfg, jo, loss_kind="lm",
                                   use_kernel=False)
    params = jax.tree.map(jnp.asarray, _tree("arctic", seed=2))
    opt = jopt.init_opt_state(params)
    key = jax.random.PRNGKey(0)
    for i in range(2):
        toks = _tokens(10 + i)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        model = tf.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu", trainable=True)
        state = tf.load_jax_opt_state(model, jax.tree.map(np.asarray, opt))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        new_p, opt, jm = jstep(params, opt, jb, key)
        t = torch.from_numpy(toks)
        step = make_train_step(cfg, topt.AdamWConfig(lr=1e-3),
                               loss_kind="lm")
        model, state, m = step(model, state, {"tokens": t, "labels": t})
        for k in ("loss", "aux"):
            assert m[k].item() == pytest.approx(float(jm[k]), rel=RTOL)
        assert m["grad_norm"].item() == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        after = dict(model.named_parameters())
        for n, path, layer in tf.jax_leaf_names(cfg):
            a, b = new_p, params
            for part in path.split("/"):
                a, b = a[part], b[part]
            a, b = np.asarray(a), np.asarray(b)
            if layer is not None:
                a, b = a[layer], b[layer]
            assert _rel_l2((after[n] - before[n]).detach().numpy(), a - b) \
                <= UPDATE_REL_L2, n
        params = new_p
