"""The port's language-model serving path against the JAX package's.

qwen3-8b (dense, GQA, qk-norm, rope) and rwkv6-1.6b (RWKV6 blocks,
LayerNorm) at the JAX ``reduced()`` sizes (2 layers, d 64, head dim 16,
vocab 256, f32).  The parameters are JAX's ``init_params(cfg,
PRNGKey(0))``, carried into the port by ``load_jax_params``; inputs come
from a numpy seed.  JAX runs its plain path (``use_kernel=False``), or its
Pallas kernels in interpret mode where a test says so, always passed
explicitly: ``tests/test_serve.py`` sets ``repro.kernels.ops.FORCE_REF``
at import, and that setting leaks into later files on the same worker.

Tolerances: layer outputs and model logits agree to 1e-4 (f32 on both
sides, summation orders differ between frameworks over two layers and a
sequential scan); greedy tokens are equal, and every step's top-2 logit
gap is asserted to exceed the logit tolerance, so the equality is not
luck.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.configs import get_arch
from repro_torch.models import layers, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServingEngine

ARCHS = ["qwen3-8b", "rwkv6-1.6b"]
LOGIT_TOL = 1e-4
LAYER_TOL = 1e-4
# (prompt length, max_new_tokens): a ragged batch of three requests
RAGGED = [(12, 5), (7, 3), (4, 6)]


def _cfgs(arch):
    return jget_arch(arch).reduced(), get_arch(arch).reduced()


_PARAMS = {}


def _params(arch):
    """JAX's init at PRNGKey(0) for the reduced arch, and the port's LM
    carrying it (built once per arch)."""
    if arch not in _PARAMS:
        jcfg, tcfg = _cfgs(arch)
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        _PARAMS[arch] = jp, tf.load_jax_params(tcfg, tree, device="cpu")
    return _PARAMS[arch]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_for_field(arch):
    for jcfg, tcfg in ((jget_arch(arch), get_arch(arch)), _cfgs(arch)):
        j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        assert {k: j[k] for k in t} == t
        assert tcfg.padded_vocab(1) == jcfg.padded_vocab(1)
        for mp in (1, 16):
            assert tcfg.padded_heads(mp) == jcfg.padded_heads(mp)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "stablelm-3b", "qwen3-14b"])
def test_unported_zoo_names_raise_a11(arch):
    """The rest of the dense zoo is ported (it raised before): each config
    equals JAX's field for field, and its reduced model holds JAX's
    leaves, shapes and all."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jtree = jax.eval_shape(lambda: jtf.init_params(jcfg.reduced(),
                                                   jax.random.PRNGKey(0)))
    model = tf.TransformerLM(tcfg.reduced(), device="meta")
    for name, path, layer in tf.jax_leaf_names(tcfg.reduced()):
        leaf = jtree
        for part in path.split("/"):
            leaf = leaf[part]
        shape = leaf.shape if layer is None else leaf.shape[1:]
        assert tuple(model.get_parameter(name).shape) == tuple(shape), name


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaves_match_jax(arch, reduced):
    """Leaf names, shapes (with the stacked layer axis) and dtypes of the
    port's LM against JAX's ``init_params``; full size on the meta device
    against ``jax.eval_shape``."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): (tuple(x.shape),
                                                 str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(shapes)}
    model = tf.TransformerLM(tcfg, device="meta")
    params = dict(model.named_parameters())
    got = {}
    for name, path, layer in tf.jax_leaf_names(tcfg):
        p = params[name]
        shape = tuple(p.shape) if layer is None else \
            (tcfg.num_layers,) + tuple(p.shape)
        got[path] = (shape, str(p.dtype).replace("torch.", ""))
    assert got == want
    assert len(params) == len(tf.jax_leaf_names(tcfg))
    assert not any(p.requires_grad for p in params.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_jax_scales(arch):
    cfg = get_arch(arch).reduced()
    a = tf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    d = cfg.d_model
    assert abs(a["embed"]["table"].std().item() - 0.02) < 0.002
    assert abs(a["unembed"]["w"].std().item() * d ** 0.5 - 1.0) < 0.05
    assert torch.equal(a["ln_f"]["scale"], torch.ones(d))
    if cfg.block == "rwkv6":
        tm = a.blocks[0]["tmix"]
        assert torch.equal(tm["w_base"], torch.full((d,), -0.5))
        assert abs(tm["u"].std().item() - 0.3) < 0.05
        assert torch.count_nonzero(tm["mu_rkvwg"]) == 0
    else:
        assert abs(a.blocks[1]["attn"]["wq"].std().item() * d ** 0.5
                   - 1.0) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_load_jax_params_carries_every_leaf(arch):
    jp, model = _params(arch)
    params = dict(model.named_parameters())
    for name, path, layer in tf.jax_leaf_names(model.cfg):
        node = jp
        for part in path.split("/"):
            node = node[part]
        want = np.asarray(node) if layer is None else np.asarray(node)[layer]
        np.testing.assert_array_equal(params[name].numpy(), want)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    x, scale, bias = _rand(0, (2, 5, 64)) * 3 + 1, _rand(1, (64,)), \
        _rand(2, (64,))
    p = {"scale": jnp.asarray(scale)}
    if kind == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = jlayers.apply_norm(p, jnp.asarray(x), kind)
    got = layers.apply_norm(_t(x), _t(scale), kind=kind,
                            bias=_t(bias) if kind == "layernorm" else None)
    _close(got, want, 1e-5)


def test_apply_rope_is_the_half_split_form():
    x = _rand(0, (2, 6, 3, 16))
    pos = np.arange(40, 46, dtype=np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), 1e6)
    _close(got, want, 1e-5)
    # not interleaved pairs: dim 0 pairs with dim 8
    rot = layers.apply_rope(_t(x), torch.from_numpy(pos), 1e6)
    assert torch.allclose(rot[..., 0] ** 2 + rot[..., 8] ** 2,
                          _t(x)[..., 0] ** 2 + _t(x)[..., 8] ** 2, atol=1e-4)


def test_swiglu_mlp_matches_jax():
    _, model = _params("qwen3-8b")
    jp, _ = _params("qwen3-8b")
    x = _rand(3, (2, 5, 64))
    mlp = jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"])
    _close(layers.apply_mlp(model.blocks[0]["mlp"], _t(x)),
           jlayers.apply_mlp(mlp, jnp.asarray(x), "swiglu"), LAYER_TOL)


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["oracle",
                                                            "pallas"])
def test_attention_full_causal_gqa_rope_qknorm_matches_jax(jax_kernel):
    """qwen3's attention (4 query heads over 2 KV heads, qk-norm before
    rope, theta 1e6), causal, with K/V as the cache keeps them."""
    jp, model = _params("qwen3-8b")
    _, cfg = _cfgs("qwen3-8b")
    x = _rand(4, (2, 9, 64))
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, causal=True,
              theta=cfg.rope_theta, qk_norm=True)
    attn = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    want, (wk, wv) = jlayers.attention_full(attn, jnp.asarray(x), **kw,
                                            use_kernel=jax_kernel)
    got, (k, v) = layers.attention_full(model.blocks[1]["attn"], _t(x), **kw)
    _close(got, want, LAYER_TOL)
    _close(k, wk, LAYER_TOL)
    _close(v, wv, LAYER_TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_jax(window):
    jp, model = _params("qwen3-8b")
    _, cfg = _cfgs("qwen3-8b")
    kc, vc, x = _rand(5, (2, 12, 2, 16)), _rand(6, (2, 12, 2, 16)), \
        _rand(7, (2, 1, 64))
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, window=window,
              theta=cfg.rope_theta, qk_norm=True)
    attn = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    want, wk, wv = jlayers.attention_decode(attn, jnp.asarray(x),
                                            jnp.asarray(kc), jnp.asarray(vc),
                                            jnp.int32(7), **kw)
    tk, tv = _t(kc), _t(vc)
    got, k, v = layers.attention_decode(model.blocks[0]["attn"], _t(x), tk,
                                        tv, 7, **kw)
    assert k is tk and v is tv               # updated in place
    _close(got, want, LAYER_TOL)
    _close(k, wk, LAYER_TOL)
    _close(v, wv, LAYER_TOL)


# --------------------------------------------------------------------------
# RWKV6 block
# --------------------------------------------------------------------------

def _rwkv_state(seed, b=2):
    return (_rand(seed, (b, 64)), _rand(seed + 1, (b, 4, 16, 16), 0.3),
            _rand(seed + 2, (b, 64)))


@pytest.mark.parametrize("seq", [9, 1], ids=["full", "one_token"])
def test_rwkv_time_mix_channel_mix_and_block_match_jax(seq):
    jp, model = _params("rwkv6-1.6b")
    jblk = jax.tree.map(lambda a: a[1], jp["blocks"])
    tblk = model.blocks[1]
    x, st = _rand(8, (2, seq, 64)), _rwkv_state(9)
    jst = jrwkv.RWKVState(*(jnp.asarray(a) for a in st))
    tst = rwkv6.RWKVState(*(_t(a) for a in st))

    out, xt, s_fin = rwkv6.time_mix(tblk["tmix"], _t(x), tst, 16)
    jout, jxt, js = jrwkv.time_mix(jblk["tmix"], jnp.asarray(x), jst, 16,
                                   use_kernel=False)
    for g, w in ((out, jout), (xt, jxt), (s_fin, js)):
        _close(g, w, LAYER_TOL)
    out, xc = rwkv6.channel_mix(tblk["cmix"], _t(x), tst)
    jout, jxc = jrwkv.channel_mix(jblk["cmix"], jnp.asarray(x), jst)
    _close(out, jout, LAYER_TOL)
    _close(xc, jxc, LAYER_TOL)

    def tnorm(pn, v):
        return layers.apply_norm(v, pn["scale"], kind="layernorm",
                                 bias=pn["bias"])

    got, new = rwkv6.rwkv_block(tblk, _t(x), tst, 16, tnorm)
    want, jnew = jrwkv.rwkv_block(
        jblk, jnp.asarray(x), jst, 16,
        lambda pn, v: jlayers.apply_norm(pn, v, "layernorm"),
        use_kernel=False)
    _close(got, want, LAYER_TOL)
    for g, w in zip(new, jnew):
        _close(g, w, LAYER_TOL)


# --------------------------------------------------------------------------
# the backbone: forward, prefill, decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jax_kernel", [False, True], ids=["oracle",
                                                            "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_jax(arch, jax_kernel):
    jp, model = _params(arch)
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens(10, (2, 11))
    want, _, _ = jtf.forward_train(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   use_kernel=jax_kernel)
    got = tf.forward_train(tcfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 11, 256)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill (last logits and the cache), then four decode steps fed the
    same tokens, against JAX step for step."""
    jp, model = _params(arch)
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens(11, (3, 8))
    want, jcache = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               use_kernel=False)
    got, cache = tf.prefill(tcfg, model, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert len(cache) == len(jcache)
    for g, w in zip(cache, jcache):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, LAYER_TOL)
    if tcfg.block == "attn_mlp":                      # room for 4 tokens
        pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
        jcache = tuple(jnp.pad(c, pad) for c in jcache)
        cache = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 4))
                      for c in cache)
    for step, tok in enumerate(_tokens(12, (4, 3))):
        want, jcache = jtf.decode_step(
            jcfg, jp, {"tokens": jnp.asarray(tok[:, None])}, jcache,
            jnp.int32(8 + step), use_kernel=False)
        got, cache = tf.decode_step(
            tcfg, model, {"tokens": torch.from_numpy(tok[:, None])}, cache,
            8 + step)
        _close(got, want)
        for g, w in zip(cache, jcache):
            _close(g, w, LAYER_TOL)


def test_make_dense_cache_matches_jax():
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        want = jtf.make_dense_cache(jcfg, 3, 20)
        got = tf.make_dense_cache(tcfg, 3, 20, device="cpu")
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            assert torch.count_nonzero(g) == 0


# --------------------------------------------------------------------------
# the serving engine
# --------------------------------------------------------------------------

def _jax_greedy_logits(arch, prompts, max_new):
    """JAX's engine loop by hand, keeping each step's logits."""
    jp, _ = _params(arch)
    jcfg, _ = _cfgs(arch)
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    logits, cache = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                use_kernel=False)
    if jcfg.block == "attn_mlp":
        pad = ((0, 0), (0, 0), (0, max_new), (0, 0), (0, 0))
        cache = tuple(jnp.pad(c, pad) for c in cache)
    steps = [np.asarray(logits)]
    for step in range(1, max_new):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = jtf.decode_step(jcfg, jp, {"tokens": tok[:, None]},
                                        cache, jnp.int32(plen + step - 1),
                                        use_kernel=False)
        steps.append(np.asarray(logits))
    return steps


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_jax_on_a_ragged_batch(arch):
    jp, model = _params(arch)
    jcfg, tcfg = _cfgs(arch)
    prompts = [_tokens(20 + i, (n,)) for i, (n, _) in enumerate(RAGGED)]
    news = [m for _, m in RAGGED]
    jeng = jengine.ServingEngine(jcfg, jp, batch_size=3, max_seq=64,
                                 use_kernel=False)
    want = jeng.generate([jengine.Request(prompt=jnp.asarray(p),
                                          max_new_tokens=m)
                          for p, m in zip(prompts, news)])
    eng = ServingEngine(tcfg, model, batch_size=3, max_seq=64)
    got = eng.generate([Request(prompt=p, max_new_tokens=m)
                        for p, m in zip(prompts, news)])
    assert got == want
    assert [len(o) for o in got] == news
    # every greedy choice on the path has a margin over the logit tolerance
    for logits in _jax_greedy_logits(arch, prompts, max(news)):
        top2 = np.sort(logits[:, :jcfg.vocab_size], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 2 * LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_logits_match_jax_at_every_step(arch):
    _, model = _params(arch)
    _, tcfg = _cfgs(arch)
    prompts = [_tokens(20 + i, (n,)) for i, (n, _) in enumerate(RAGGED)]
    eng = ServingEngine(tcfg, model, batch_size=3, max_seq=64)
    seen = []

    def prefill(m, batch, cache_len=None):
        out = tf.prefill(tcfg, m, batch, cache_len=cache_len)
        seen.append(out[0].clone())
        return out

    def decode(m, token_batch, cache, pos):
        out = tf.decode_step(tcfg, m, token_batch, cache, pos)
        seen.append(out[0].clone())
        return out

    eng._prefill, eng._decode = prefill, decode
    eng.generate([Request(prompt=p, max_new_tokens=m)
                  for p, (_, m) in zip(prompts, RAGGED)])
    want = _jax_greedy_logits(arch, prompts, max(m for _, m in RAGGED))
    assert len(seen) == len(want)
    for got, w in zip(seen, want):
        _close(got, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_full_forward(arch):
    """The port's engine against its own full-sequence forward on the
    prompt plus the generation (the JAX package's
    ``test_engine_greedy_matches_full_forward``)."""
    _, model = _params(arch)
    _, cfg = _cfgs(arch)
    prompt = torch.from_numpy(_tokens(30, (12,))).long()
    gen = ServingEngine(cfg, model, batch_size=2, max_seq=64).generate(
        [Request(prompt=prompt, max_new_tokens=6)])[0]
    assert len(gen) == 6
    seq = prompt
    for i in range(2):
        logits = tf.forward_train(cfg, model, {"tokens": seq[None]})
        assert int(logits[0, -1, :cfg.vocab_size].argmax()) == gen[i]
        seq = torch.cat([seq, torch.tensor([gen[i]])])


def test_engine_refuses_what_does_not_fit():
    _, model = _params("qwen3-8b")
    _, cfg = _cfgs("qwen3-8b")
    eng = ServingEngine(cfg, model, batch_size=2, max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate([Request(prompt=[1] * 12, max_new_tokens=6)])
    with pytest.raises(ValueError, match="batch"):
        eng.generate([Request(prompt=[1], max_new_tokens=1)] * 3)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    # the audio and vision families train; an encoder-only model has no
    # decode step to serve
    hubert = get_arch("hubert-xlarge").reduced()
    assert callable(make_train_step(hubert, AdamWConfig(), loss_kind="lm"))
    enc = tf.TransformerLM(hubert, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tf.decode_step(hubert, enc, {"tokens": torch.zeros((1, 1),
                                                           dtype=torch.long)},
                       None, 0)
