"""The rest of the LM zoo in the port against the JAX package: the
thirteen configs, the dense ``stablelm-3b`` (LayerNorm), ``qwen1.5-32b``
(QKV bias) and ``qwen3-14b`` (qk-norm, GQA), the audio stub
(``hubert-xlarge``: encoder-only, frame features, the masked-unit loss)
and the vision stub (``phi-3-vision-4.2b``: image embeddings over the
first positions, the prefix left out of the loss), their data streams,
and the TimeConditioned wrapper (any backbone as an SRDS denoiser).

Models are the JAX ``reduced()`` configs in f32, JAX's init with every
leaf moved by a numpy draw, carried by ``load_jax_params`` (or
``load_time_conditioned``); JAX runs with ``use_kernel=False``.

Tolerances (f32 on both sides): logits, eps and gradients within
``REL_L2`` (1e-5) relative L2 (read: 3e-7 to 2e-6), losses within
``RTOL`` (1e-5) relative; served tokens equal; the streams, given JAX's
draws, bitwise.  ``srds_sample`` over the TimeConditioned denoiser
against the port's own ``sample_sequential`` within JAX's 1e-3 (mean
absolute difference over the mean magnitude) in at most 4 iterations, as
``tests/test_srds_backbone_composition.py`` holds JAX's.  Controls that
must miss: the VLM loss counting the prefix positions, the audio loss
ignoring the mask, the sampler's input moved.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jdata
from repro.configs import arch_names as jarch_names
from repro.configs import get_arch as jget_arch
from repro.configs import shape_cells as jshape_cells
from repro.models import dit as jdit
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.train import losses as jlosses
from repro_torch import core as C
from repro_torch.configs import arch_names, get_arch, shape_cells
from repro_torch.data import AudioStream, DataConfig, VLMStream, make_stream
from repro_torch.models import dit as tdit
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServingEngine
from repro_torch.train import lm_loss

REL_L2 = 1e-5
RTOL = 1e-5
SRDS_REL = 1e-3
DENSE = ["stablelm-3b", "qwen1.5-32b", "qwen3-14b"]
RAGGED = [(12, 5), (7, 3), (4, 6)]
SEQ = 12


def _cfgs(arch):
    return jget_arch(arch).reduced(), get_arch(arch).reduced()


def _tree(arch, seed=0, init=None):
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    tree = (init or jtf.init_params)(jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)), tree)


def _j(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)


def _rel_l2(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _batches(arch, seed=0, b=2, s=SEQ):
    """(JAX's, the port's) training batch of the arch's family."""
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    toks = _tokens(seed, (b, s))
    j = {"labels": toks}
    if jcfg.frontend == "audio":
        j["features"] = rng.standard_normal((b, s, 64)).astype(np.float32)
        j["mask"] = rng.random((b, s)) < 0.3
    else:
        j["tokens"] = toks
    if jcfg.frontend == "vision":
        j["image_embeds"] = (rng.standard_normal(
            (b, jcfg.num_prefix_embeds, 64)) * 0.2).astype(np.float32)
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    for k in ("tokens", "labels"):
        if k in t:
            t[k] = t[k].long()
    return {k: jnp.asarray(v) for k, v in j.items()}, t


def _grads_vs_jax(arch, tree, jb, tb, cfg=None):
    """(port loss, JAX loss, worst gradient rel L2 over every leaf)."""
    jcfg, tcfg = _cfgs(arch)
    if cfg is not None:
        jcfg, tcfg = cfg
    (jv, _), jg = jax.value_and_grad(
        lambda p: jlosses.lm_loss(jcfg, p, jb, use_kernel=False),
        has_aux=True)(_j(tree))
    model = tf.load_jax_params(tcfg, tree, device="cpu", trainable=True)
    loss, _ = lm_loss(tcfg, model, tb)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    worst = 0.0
    for name, path, layer in tf.jax_leaf_names(tcfg):
        leaf = jg
        for part in path.split("/"):
            leaf = leaf[part]
        worst = max(worst, _rel_l2(grads[name], np.asarray(
            leaf if layer is None else leaf[layer])))
    return loss.item(), float(jv), worst


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_registry_has_every_jax_arch():
    assert arch_names() == jarch_names() and len(arch_names()) == 13
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch", sorted(jarch_names()))
def test_configs_and_counts_match_jax(arch):
    """Field for field (``source`` included), and JAX's derived counts:
    ``param_count``, ``active_param_count``, ``padded_heads`` at 1, 2 and
    16, ``padded_vocab``, ``shape_cells``; the same for ``reduced()``."""
    for jcfg, tcfg in ((jget_arch(arch), get_arch(arch)), _cfgs(arch)):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        for mp in (1, 2, 16):
            assert tcfg.padded_heads(mp) == jcfg.padded_heads(mp)
            assert tcfg.padded_vocab(mp) == jcfg.padded_vocab(mp)
        assert [dataclasses.asdict(s) for s in shape_cells(tcfg)] == \
            [dataclasses.asdict(s) for s in jshape_cells(jcfg)]
        assert tcfg.is_encoder_only == jcfg.is_encoder_only
        assert tcfg.supports_long_context == jcfg.supports_long_context


@pytest.mark.parametrize("arch", sorted(set(jarch_names()) - {
    "srds-dit-cifar", "srds-dit-lsun", "srds-dit-sd2"}))
def test_full_size_leaves_match_jax(arch):
    """Every leaf of the full config (meta device) against
    ``jax.eval_shape`` of JAX's ``init_params``: names, shapes, dtypes
    (no embedding table for the audio stub; the MoE experts)."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    jtree = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    model = tf.TransformerLM(tcfg, device="meta")
    names = tf.jax_leaf_names(tcfg)
    assert len(names) == sum(1 for _ in model.parameters())
    want_paths = {jax.tree_util.keystr(p).replace("']['", "/")[2:-2]
                  for p, _ in jax.tree_util.tree_leaves_with_path(jtree)}
    assert {path for _, path, _ in names} == want_paths
    for name, path, layer in names:
        leaf = jtree
        for part in path.split("/"):
            leaf = leaf[part]
        shape = leaf.shape if layer is None else leaf.shape[1:]
        p = model.get_parameter(name)
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), name


# --------------------------------------------------------------------------
# the dense configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_and_loss_match_jax(arch):
    """``forward_train``'s logits, ``lm_loss`` and every gradient."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(arch)
    jb, tb = _batches(arch)
    jl, _, _ = jtf.forward_train(jcfg, _j(tree), {"tokens": jb["tokens"]},
                                 use_kernel=False)
    model = tf.load_jax_params(tcfg, tree, device="cpu")
    with torch.no_grad():
        tl = tf.forward_train(tcfg, model, {"tokens": tb["tokens"]})
    assert _rel_l2(tl, jl) <= REL_L2
    got, want, worst = _grads_vs_jax(arch, tree, jb, tb)
    assert got == pytest.approx(want, rel=RTOL)
    assert worst <= REL_L2


@pytest.mark.parametrize("arch", DENSE)
def test_dense_engine_tokens_equal_jax(arch):
    """Greedy tokens of a ragged batch through ``ServingEngine`` equal
    JAX's engine."""
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(arch, seed=1)
    prompts = [_tokens(20 + i, (n,)) for i, (n, _) in enumerate(RAGGED)]
    news = [m for _, m in RAGGED]
    jeng = jengine.ServingEngine(jcfg, _j(tree), batch_size=3, max_seq=64,
                                 use_kernel=False)
    want = jeng.generate([jengine.Request(prompt=jnp.asarray(p),
                                          max_new_tokens=m)
                          for p, m in zip(prompts, news)])
    eng = ServingEngine(tcfg, tf.load_jax_params(tcfg, tree, device="cpu"),
                        batch_size=3, max_seq=64)
    got = eng.generate([Request(prompt=p, max_new_tokens=m)
                        for p, m in zip(prompts, news)])
    assert got == want and [len(o) for o in got] == news


# --------------------------------------------------------------------------
# the audio and vision stubs
# --------------------------------------------------------------------------

def test_hubert_masked_unit_loss_matches_jax():
    """The encoder-only model on frame features (no embedding table):
    the CE of the labels where the mask holds, and every gradient; the
    control (every position counted) misses."""
    arch = "hubert-xlarge"
    tree = _tree(arch)
    assert "embed" not in tree
    jb, tb = _batches(arch)
    got, want, worst = _grads_vs_jax(arch, tree, jb, tb)
    assert got == pytest.approx(want, rel=RTOL) and worst <= REL_L2
    _, tcfg = _cfgs(arch)
    model = tf.load_jax_params(tcfg, tree, device="cpu")
    nomask = {k: v for k, v in tb.items() if k != "mask"}
    ctrl, _ = lm_loss(tcfg, model, nomask)
    assert abs(ctrl.item() - want) / abs(want) > 100 * RTOL


def test_phi3_vision_prefix_loss_matches_jax():
    """The image embeddings over the first ``num_prefix_embeds``
    positions (the sequence keeps its length) and the causal CE without
    those positions, with every gradient; the control (the prefix
    positions counted) misses."""
    arch = "phi-3-vision-4.2b"
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.num_prefix_embeds == 4
    tree = _tree(arch)
    jb, tb = _batches(arch)
    jl, _, _ = jtf.forward_train(jcfg, _j(tree), jb, use_kernel=False)
    model = tf.load_jax_params(tcfg, tree, device="cpu")
    with torch.no_grad():
        tl = tf.forward_train(tcfg, model, tb)
    assert tl.shape[1] == SEQ and _rel_l2(tl, jl) <= REL_L2
    got, want, worst = _grads_vs_jax(arch, tree, jb, tb)
    assert got == pytest.approx(want, rel=RTOL) and worst <= REL_L2
    counted = dataclasses.replace(tcfg, num_prefix_embeds=0)
    ctrl, _ = lm_loss(counted, model, tb)
    assert abs(ctrl.item() - want) / abs(want) > 100 * RTOL


def _jax_lm_draws(seed, step, b, s, vocab):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    ks = jax.random.split(jax.random.fold_in(key, 0), 4)
    return (jax.random.randint(ks[0], (b, 1), 1, 8),
            jax.random.randint(ks[1], (b, 1), 0, vocab),
            jax.random.randint(ks[2], (b, s), 0, vocab),
            jax.random.bernoulli(ks[3], 0.15, (b, s)))


def _torch(draws):
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


def test_audio_and_vlm_streams_equal_jax_given_its_draws(monkeypatch):
    """``AudioStream`` and ``VLMStream``'s batches, their draws replaced
    by JAX's, equal JAX's streams' batches bit for bit (keys, dtypes,
    values); ``make_stream`` dispatches by frontend."""
    seed, step, b, s, vocab, d, p = 3, 5, 3, 10, 256, 8, 4
    dcfg = DataConfig(seed=seed, global_batch=b, seq_len=s)
    jd = jdata.DataConfig(seed=seed, global_batch=b, seq_len=s)
    # audio
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed ^ 0xA0D10), step), 0)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.normal(k1, (b, s, d)),
             jax.random.randint(k2, (b, s), 0, vocab),
             jax.random.bernoulli(k3, 0.3, (b, s)))
    monkeypatch.setattr(AudioStream, "draws", lambda self, i: _torch(draws))
    got = AudioStream(dcfg, d, vocab, "cpu").batch(step)
    want = jdata.AudioStream(jd, d, vocab).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == (np.int64 if k == "labels"
                                        else w.dtype)
        assert np.array_equal(got[k].numpy(), w), k
    # vision
    from repro_torch.data import LMStream
    lm = _torch(_jax_lm_draws(seed, step, b, s, vocab))
    img = jax.random.normal(jax.random.fold_in(
        jax.random.PRNGKey(seed ^ 0x1AB), step), (b, p, d))
    monkeypatch.setattr(LMStream, "draws", lambda self, i: lm)
    monkeypatch.setattr(VLMStream, "draws",
                        lambda self, i: torch.from_numpy(np.array(img)))
    got = VLMStream(dcfg, vocab, p, d, "cpu").batch(step)
    want = jdata.VLMStream(jd, vocab, p, d).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert isinstance(make_stream(get_arch("hubert-xlarge"), dcfg, "cpu"),
                      AudioStream)
    assert isinstance(make_stream(get_arch("phi-3-vision-4.2b"), dcfg,
                                  "cpu"), VLMStream)


# --------------------------------------------------------------------------
# TimeConditioned
# --------------------------------------------------------------------------

def _time_conditioned(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(arch, seed, init=jdit.init_time_conditioned)
    return jcfg, tcfg, tree, tdit.load_time_conditioned(tcfg, tree,
                                                        device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b", "hubert-xlarge"])
def test_time_conditioned_forward_matches_jax(arch):
    """eps of ``time_conditioned_forward`` (every block non-causal, the
    time embedding at every position, ``ln_f`` and ``eps_out``) against
    JAX's on the same latents and times."""
    jcfg, tcfg, tree, model = _time_conditioned(arch)
    x = np.random.default_rng(1).standard_normal((2, 12, 64)).astype(
        np.float32)
    t = np.array([5.0, 500.0], np.float32)
    want = jdit.time_conditioned_forward(jcfg, _j(tree), jnp.asarray(x),
                                         jnp.asarray(t), use_kernel=False)
    with torch.no_grad():
        got = tdit.time_conditioned_forward(tcfg, model, torch.from_numpy(x),
                                            torch.from_numpy(t))
    assert got.shape == x.shape and _rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b", "hubert-xlarge"])
def test_time_conditioned_backbone_is_an_srds_denoiser(arch):
    """``srds_sample`` over the TimeConditioned denoiser reaches the
    port's own ``sample_sequential`` within 1e-3 in at most 4 iterations
    (JAX's composition test), finite; the input moved by 1e-2 is the
    control that misses."""
    _, tcfg, _, model = _time_conditioned(arch)
    fn = tdit.make_time_conditioned_denoiser(model)
    sched = C.make_schedule("ddpm_linear", 16)
    solver = C.SolverConfig("ddim")
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    ref = C.sample_sequential(fn, sched, solver, x0)
    res = C.srds_sample(fn, sched, solver, x0, C.SRDSConfig(tol=0.0))
    scale = ref.abs().mean().item() + 1e-9
    rel = (res.sample - ref).abs().mean().item() / scale
    assert rel < SRDS_REL, rel
    assert int(res.iterations) <= 4
    assert bool(torch.isfinite(res.sample).all())
    moved = C.srds_sample(fn, sched, solver, x0 + 1e-2, C.SRDSConfig(tol=0.0))
    assert (moved.sample - ref).abs().mean().item() / scale > SRDS_REL


def test_hybrid_time_conditioned_is_finite_and_time_dependent():
    """hymba as a denoiser trunk: finite eps of the latents' shape, which
    moves with t."""
    jcfg, tcfg, tree, model = _time_conditioned("hymba-1.5b")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 64)).astype(np.float32))
    with torch.no_grad():
        a = tdit.time_conditioned_forward(tcfg, model, x,
                                          torch.tensor([5.0, 500.0]))
        b = tdit.time_conditioned_forward(tcfg, model, x,
                                          torch.tensor([900.0, 1.0]))
    assert a.shape == x.shape and bool(torch.isfinite(a).all())
    assert (a - b).abs().max().item() > 1e-6
