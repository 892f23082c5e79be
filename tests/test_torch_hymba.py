"""The port's hymba-1.5b serving path against the JAX package's.

hymba-1.5b (attention and a selective SSM side by side in every layer,
sliding-window attention, a ring KV cache) at the JAX ``reduced()`` size
(2 layers, d 64, 4/2 heads of 16, SSM inner width 64 with 8 states,
vocab 256, f32), with the window cut to 5 on both sides (``WINDOW``) so
that every prompt here is longer than the window: JAX's own decode fails
after a prefill shorter than its window (ROADMAP C16), and the ring's roll
is then nonzero.  The parameters are JAX's ``init_params(cfg,
PRNGKey(0))`` carried into the port by ``load_jax_params``, with the SSM's
f32 leaves moved by a numpy draw (``_params``) so that ``b_dt``, ``D`` and
``A_log`` are not their constant inits; inputs come from a numpy seed.
JAX runs its plain path (``use_kernel=False``), or its Pallas kernels in
interpret mode where a test says so, always passed explicitly
(``tests/test_serve.py`` sets ``FORCE_REF`` at import).

Tolerances: the scan, layer outputs, caches and logits agree to 1e-4 (f32
on both sides, as ``tests/test_torch_llm.py``: summation orders differ
between frameworks over two layers and a sequential scan); greedy tokens
are equal, with every step's top-2 logit gap above twice the logit
tolerance, so the equality is not luck.  The C16 case holds the port's
decode after a short prefill against its own ``forward_train`` at the
same 1e-4.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import hymba as jhym
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import hymba
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServingEngine

ARCH = "hymba-1.5b"
WINDOW = 5
LOGIT_TOL = 1e-4
LAYER_TOL = 1e-4
# (prompt length, max_new_tokens): a ragged batch of three requests, the
# longest running 6 decode steps past the window
RAGGED = [(12, 5), (7, 3), (6, 7)]


def _cfgs(window=WINDOW):
    return (dataclasses.replace(jget_arch(ARCH).reduced(), window=window),
            dataclasses.replace(get_arch(ARCH).reduced(), window=window))


_PARAMS = {}


def _params():
    """JAX's init at PRNGKey(0) for the reduced arch, its f32 SSM leaves
    moved by a seeded numpy draw (b_dt around -1, D around 1, A_log and the
    B, C, dt projections perturbed), and the port's LM carrying it."""
    if not _PARAMS:
        jcfg, tcfg = _cfgs()
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        ssm = dict(jp["blocks"]["ssm"])
        for name, scale in (("b_dt", 0.5), ("D", 0.3), ("A_log", 0.2),
                            ("w_dt", 0.2)):
            leaf = np.asarray(ssm[name])
            ssm[name] = jnp.asarray(
                (leaf + scale * rng.standard_normal(leaf.shape)).astype(
                    np.float32))
        jp = dict(jp, blocks=dict(jp["blocks"], ssm=ssm))
        tree = jax.tree.map(np.asarray, jp)
        _PARAMS["p"] = jp, tf.load_jax_params(tcfg, tree, device="cpu")
    return _PARAMS["p"]


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


def _layer(jp, model, i):
    """Layer ``i``'s parameters: JAX's slice and the port's block."""
    return jax.tree.map(lambda a: a[i], jp["blocks"]), model.blocks[i]


def _tnorm(pn, v):
    return tf._norm(get_arch(ARCH).reduced())(pn, v)


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_match_jax_field_for_field(reduced):
    jcfg, tcfg = jget_arch(ARCH), get_arch(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert {k: j[k] for k in t} == t
    assert (t["block"], t["family"]) == ("hymba", "hybrid")
    assert tcfg.padded_vocab(1) == jcfg.padded_vocab(1)
    for mp in (1, 16):
        assert tcfg.padded_heads(mp) == jcfg.padded_heads(mp)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_params_leaves_match_jax(reduced):
    """Leaf names, shapes (with the stacked layer axis) and dtypes against
    JAX's ``init_params``; full size on the meta device against
    ``jax.eval_shape``."""
    jcfg, tcfg = jget_arch(ARCH), get_arch(ARCH)
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
    if not reduced:
        assert abs(tf.param_count(model) / tcfg.num_layers
                   - jcfg.param_count() / jcfg.num_layers) \
            < 0.05 * jcfg.param_count() / jcfg.num_layers


def test_init_params_draws_jax_rules():
    """The port's draw follows JAX's init rules: the SSM's constant leaves
    equal JAX's exactly, the normal draws have JAX's scales."""
    cfg = get_arch(ARCH).reduced()
    model = tf.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    jp = jtf.init_params(jget_arch(ARCH).reduced(), jax.random.PRNGKey(0))
    ssm = model.blocks[1]["ssm"]
    jssm = jax.tree.map(lambda a: np.asarray(a[1]), jp["blocks"]["ssm"])
    for name in ("b_dt", "D", "A_log"):
        np.testing.assert_allclose(ssm[name].numpy(), jssm[name], rtol=1e-7,
                                   atol=0)
    din = cfg.ssm_d_inner
    assert abs(ssm["w_B"].std().item() * din ** 0.5 - 1.0) < 0.15
    assert abs(ssm["w_in"].std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(model.blocks[0]["n_ssm"]["scale"],
                       torch.ones(cfg.d_model))


def test_load_jax_params_carries_every_leaf():
    jp, model = _params()
    params = dict(model.named_parameters())
    for name, path, layer in tf.jax_leaf_names(model.cfg):
        node = jp
        for part in path.split("/"):
            node = node[part]
        want = np.asarray(node) if layer is None else np.asarray(node)[layer]
        np.testing.assert_array_equal(params[name].numpy(), want)


# --------------------------------------------------------------------------
# the scan and the mixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [9, 1], ids=["full", "one_token"])
def test_selective_scan_twin_matches_jax_ssm_scan(seq):
    """``ref.selective_scan`` fed the projections of JAX's ``_ssm_scan``
    (computed by the port as ``ssm_forward`` does) against ``_ssm_scan``
    itself, from a nonzero state: y and the final state."""
    jp, model = _params()
    jssm, tblk = _layer(jp, model, 1)
    p, jp_ssm = tblk["ssm"], jssm["ssm"]
    xs, h0 = _rand(30, (2, seq, 64)), _rand(31, (2, 64, 8), 0.5)
    want_y, want_h = jhym._ssm_scan(jp_ssm, jnp.asarray(xs), jnp.asarray(h0))
    x = _t(xs)
    dt = torch.nn.functional.softplus(x @ p["w_dt"] + p["b_dt"])[..., 0]
    y, h_t = ref.selective_scan(x, dt, x @ p["w_B"], x @ p["w_C"],
                                -torch.exp(p["A_log"]), p["D"], _t(h0))
    assert y.shape == (2, seq, 64) and h_t.shape == (2, 64, 8)
    assert y.dtype == h_t.dtype == torch.float32
    _close(y, want_y, LAYER_TOL)
    _close(h_t, want_h, LAYER_TOL)


def test_selective_scan_dispatch_on_the_cpu_runs_the_twin():
    """A CPU tensor runs the plain twin (no launch counted), with zeros
    for a missing state; the twin is differentiable there."""
    rng = np.random.default_rng(40)
    xs, bb, cc = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((2, 5, 6), (2, 5, 3), (2, 5, 3)))
    dt = torch.rand(2, 5)
    a = -torch.rand(6, 3) - 0.1
    d = torch.randn(6)
    ops.reset_launch_counts()
    y, h_t = ops.selective_scan(xs, dt, bb, cc, a, d)
    want = ref.selective_scan(xs, dt, bb, cc, a, d, torch.zeros(2, 6, 3))
    assert torch.equal(y, want[0]) and torch.equal(h_t, want[1])
    assert ops.launch_counts()["selective_scan"] == 0
    xs.requires_grad_()
    (g,) = torch.autograd.grad(ops.selective_scan(xs, dt, bb, cc, a, d)[0]
                               .sum(), xs)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("seq", [9, 1], ids=["full", "one_token"])
def test_ssm_forward_matches_jax(seq):
    jp, model = _params()
    jblk, tblk = _layer(jp, model, 0)
    x, h0 = _rand(32, (2, seq, 64)), _rand(33, (2, 64, 8), 0.5)
    want, want_h = jhym.ssm_forward(jblk["ssm"], jnp.asarray(x),
                                    jnp.asarray(h0))
    got, h_t = hymba.ssm_forward(tblk["ssm"], _t(x), _t(h0))
    _close(got, want, LAYER_TOL)
    _close(h_t, want_h, LAYER_TOL)


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["oracle",
                                                            "pallas"])
def test_hymba_mix_full_matches_jax(jax_kernel):
    """The parallel mixer: the sliding-window attention (JAX's plain path
    or its Pallas kernel in interpret mode), the SSM from a nonzero state,
    the two norms; outputs, K/V and the SSM state."""
    jp, model = _params()
    jcfg, tcfg = _cfgs()
    jblk, tblk = _layer(jp, model, 1)
    x, h0 = _rand(34, (2, 11, 64)), _rand(35, (2, 64, 8), 0.5)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, causal=True,
              window=WINDOW, theta=jcfg.rope_theta, qk_norm=False)
    jparts = {k: jblk[k] for k in ("attn", "ssm", "n_attn", "n_ssm")}
    want, (wk, wv), want_h = jhym.hymba_mix_full(
        jparts, jnp.asarray(x), kw, "rmsnorm", h0=jnp.asarray(h0),
        use_kernel=jax_kernel)
    got, (k, v), h_t = hymba.hymba_mix_full(tblk, _t(x), kw, _tnorm,
                                            _t(h0))
    for g, w in ((got, want), (k, wk), (v, wv), (h_t, want_h)):
        _close(g, w, LAYER_TOL)


def test_hymba_mix_decode_and_ring_update_match_jax():
    """One decode token against a ring that has wrapped (positions 8-12
    in the 5 slots of window 5, at pos 13): the fused output and all four
    cache fields, updated in place."""
    jp, model = _params()
    jcfg, _ = _cfgs()
    jblk, tblk = _layer(jp, model, 0)
    pos = 13
    ring_pos = np.array([10, 11, 12, 8, 9], np.int32)
    cache = (_rand(36, (2, 64, 8), 0.5), _rand(37, (2, WINDOW, 2, 16)),
             _rand(38, (2, WINDOW, 2, 16)), ring_pos)
    x = _rand(39, (2, 1, 64))
    jparts = {k: jblk[k] for k in ("attn", "ssm", "n_attn", "n_ssm")}
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, window=WINDOW,
              theta=jcfg.rope_theta)
    want, jnew = jhym.hymba_mix_decode(
        jparts, jnp.asarray(x), jhym.HymbaCache(*map(jnp.asarray, cache)),
        jnp.int32(pos), norm_kind="rmsnorm", **kw)
    tc = hymba.HymbaCache(_t(cache[0]), _t(cache[1]), _t(cache[2]),
                          torch.from_numpy(ring_pos.copy()))
    got, new = hymba.hymba_mix_decode(tblk, _t(x), tc, pos, norm_fn=_tnorm,
                                      **kw)
    assert all(a is b for a, b in zip(new, tc))          # in place
    _close(got, want, LAYER_TOL)
    for g, w in zip(new, jnew):
        _close(g, w, LAYER_TOL)
    assert new.ring_pos.tolist() == [10, 11, 12, 13, 9]


# --------------------------------------------------------------------------
# the backbone: forward, prefill, decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jax_kernel", [False, True], ids=["oracle",
                                                            "pallas"])
def test_forward_train_logits_match_jax(jax_kernel):
    jp, model = _params()
    jcfg, tcfg = _cfgs()
    toks = _tokens(10, (2, 11))
    want, _, _ = jtf.forward_train(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   use_kernel=jax_kernel)
    got = tf.forward_train(tcfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 11, 256)
    _close(got, want)


@pytest.mark.parametrize("prompt", [8, 10], ids=["roll3", "roll0"])
def test_prefill_and_decode_steps_match_jax(prompt):
    """Prefill (last logits and the cache's four fields: SSM states, the
    K and V rings and ring_pos), then four decode steps fed the same
    tokens, past the ring's wrap, against JAX step for step."""
    jp, model = _params()
    jcfg, tcfg = _cfgs()
    toks = _tokens(11, (3, prompt))
    want, jcache = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               use_kernel=False)
    got, cache = tf.prefill(tcfg, model, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert isinstance(cache, hymba.HymbaCache) and len(jcache) == 4
    for g, w in zip(cache, jcache):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, LAYER_TOL)
    assert cache.ring_pos.dtype == torch.int32
    np.testing.assert_array_equal(cache.ring_pos.numpy(),
                                  np.asarray(jcache.ring_pos))
    for step, tok in enumerate(_tokens(12, (4, 3))):
        want, jcache = jtf.decode_step(
            jcfg, jp, {"tokens": jnp.asarray(tok[:, None])}, jcache,
            jnp.int32(prompt + step), use_kernel=False)
        got, cache = tf.decode_step(
            tcfg, model, {"tokens": torch.from_numpy(tok[:, None])}, cache,
            prompt + step)
        _close(got, want)
        for g, w in zip(cache, jcache):
            _close(g, w, LAYER_TOL)


def test_make_dense_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    want = jtf.make_dense_cache(jcfg, 3, 20)
    got = tf.make_dense_cache(tcfg, 3, 20, device="cpu")
    assert isinstance(got, hymba.HymbaCache)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each layer's ring is its own tensor: decode writes in place
    got.ring_pos[0, 0] = 7
    assert got.ring_pos[1, 0] == -1


def test_prefill_shorter_than_window_decodes_like_forward_train():
    """ROADMAP C16: a prompt shorter than the window (20 tokens, the
    reduced window 32), which JAX's decode cannot follow.  The port's ring
    has all 32 slots, ``ring_pos`` -1 in the 12 empty ones; each of four
    decode steps equals ``forward_train``'s last logits over the prompt
    and the tokens so far."""
    jp, _ = _params()
    _, tcfg = _cfgs(window=32)
    model = tf.load_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    toks = torch.from_numpy(_tokens(13, (2, 20))).long()
    logits, cache = tf.prefill(tcfg, model, {"tokens": toks})
    assert cache.k_ring.shape == (2, 2, 32, 2, 16)
    assert cache.ring_pos[0].tolist() == list(range(20)) + [-1] * 12
    _close(logits, tf.forward_train(tcfg, model, {"tokens": toks})[:, -1])
    seq = toks
    for step, tok in enumerate(_tokens(14, (4, 2))):
        tok = torch.from_numpy(tok).long()[:, None]
        got, cache = tf.decode_step(tcfg, model, {"tokens": tok}, cache,
                                    20 + step)
        seq = torch.cat([seq, tok], dim=1)
        _close(got, tf.forward_train(tcfg, model, {"tokens": seq})[:, -1])


# --------------------------------------------------------------------------
# the serving engine
# --------------------------------------------------------------------------

def _jax_greedy_logits(prompts, max_new):
    """JAX's engine loop by hand, keeping each step's logits."""
    jp, _ = _params()
    jcfg, _ = _cfgs()
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    logits, cache = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                use_kernel=False)
    steps = [np.asarray(logits)]
    for step in range(1, max_new):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = jtf.decode_step(jcfg, jp, {"tokens": tok[:, None]},
                                        cache, jnp.int32(plen + step - 1),
                                        use_kernel=False)
        steps.append(np.asarray(logits))
    return steps


def test_engine_tokens_equal_jax_on_a_ragged_batch():
    jp, model = _params()
    jcfg, tcfg = _cfgs()
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
    for logits in _jax_greedy_logits(prompts, max(news)):
        top2 = np.sort(logits[:, :jcfg.vocab_size], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 2 * LOGIT_TOL


def test_engine_logits_match_jax_at_every_step():
    _, model = _params()
    _, tcfg = _cfgs()
    prompts = [_tokens(20 + i, (n,)) for i, (n, _) in enumerate(RAGGED)]
    eng = ServingEngine(tcfg, model, batch_size=3, max_seq=64)
    seen = []

    def prefill(m, batch):
        out = tf.prefill(tcfg, m, batch)
        seen.append(out[0].clone())
        return out

    def decode(m, token_batch, cache, pos):
        out = tf.decode_step(tcfg, m, token_batch, cache, pos)
        seen.append(out[0].clone())
        return out

    eng._prefill, eng._decode = prefill, decode
    eng.generate([Request(prompt=p, max_new_tokens=m)
                  for p, (_, m) in zip(prompts, RAGGED)])
    want = _jax_greedy_logits(prompts, max(m for _, m in RAGGED))
    assert len(seen) == len(want)
    for got, w in zip(seen, want):
        _close(got, w)


def test_training_hymba_lm_step_builds():
    """The LM step builds for the full hymba-1.5b config
    (``tests/test_torch_hymba_train.py`` holds its loss, gradients and
    steps against JAX's)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    assert callable(make_train_step(get_arch(ARCH), AdamWConfig(),
                                    loss_kind="lm"))
