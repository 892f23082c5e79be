"""The port's language-model training path against the JAX package's, on
the CPU.

qwen3-8b (dense, GQA 4/2 heads, qk-norm, rope) and rwkv6-1.6b (RWKV6
blocks) at the JAX ``reduced()`` sizes (2 layers, d 64, head dim 16,
vocab 256, f32).  The parameters are JAX's ``init_params(cfg,
PRNGKey(0))`` with every leaf moved by a small numpy draw (the init's
zero token-shift mixes and unit norms would otherwise hide their
gradients' paths), carried into the port by ``load_jax_params``.  JAX runs
its plain path (``use_kernel=False``, passed explicitly:
``tests/test_serve.py`` sets ``repro.kernels.ops.FORCE_REF`` at import and
it leaks into later files on the same worker); JAX's own ``rwkv6_wkv``
with ``use_kernel=True`` calls the Pallas kernel directly and has no
gradient path, so whole-model JAX gradients are taken with
``use_kernel=False``.  The port runs its ``FlashAttention`` and
``RWKV6WKV`` Functions, whose CPU backward is ``ref.attention_bwd`` and
``ref.rwkv6_wkv_bwd``.

Tolerances (f32 on both sides):
* ``lm_loss`` and the chunked CE sums: relative 1e-5 (two frameworks' f32
  summation orders over two layers and a scan);
* gradients: relative L2 per leaf 1e-4 (the plain backward formulas
  against JAX's autodiff of its oracles: other summation orders), and the
  grad norm over all of them relative 1e-4 (rwkv6's read 1.4e-5);
* a whole train step from a carried JAX state: the update ``p_new -
  p_old`` per leaf within relative L2 1e-3 (Adam's ``m / sqrt(v)``
  amplifies the gradients' rounding where they are tiny, as in
  ``tests/test_torch_train.py``);
* the token formula fed JAX's draws: equal;
* checkpoints and restart-resume: bitwise.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.optim as jopt
from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtf
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import (DataConfig, LMStream, make_stream,
                              token_formula)
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tf
from repro_torch.runtime import (LoopConfig, Preempted, PreemptionSignal,
                                 train_loop)
from repro_torch.train import lm_loss, make_train_step
from repro_torch.train.losses import _chunked_ce

ARCHS = ["qwen3-8b", "rwkv6-1.6b"]
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-3
SEQ = 24


def _cfgs(arch):
    return jget_arch(arch).reduced(), get_arch(arch).reduced()


def _tree(arch, seed=0):
    """JAX's init for the reduced arch, every leaf moved by 0.05 x a
    standard normal draw from ``seed``: numpy f32 leaves."""
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)),
        jtf.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(seed, b=2, s=SEQ, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(toks).long()})


def _leaf(tree, path, layer):
    for part in path.split("/"):
        tree = tree[part]
    tree = np.asarray(tree, np.float32)
    return tree if layer is None else tree[layer]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _tree(arch)
    jbatch, tbatch = _batch(1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlosses.lm_loss(jcfg, p, jbatch, use_kernel=False),
        has_aux=True)(_jax_tree(tree))
    model = tf.load_jax_params(tcfg, tree, device="cpu", trainable=True)
    loss, metrics = lm_loss(tcfg, model, tbatch)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert metrics["ce"].item() == pytest.approx(float(jm["ce"]),
                                                 rel=LOSS_RTOL)
    assert metrics["tokens"].item() == float(jm["tokens"]) == 2 * (SEQ - 1)
    assert metrics["aux"].item() == float(jm["aux"]) == 0.0
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert len(grads) == len(tf.jax_leaf_names(tcfg))
    for name, path, layer in tf.jax_leaf_names(tcfg):
        want = _leaf(jgrads, path, layer)
        assert np.linalg.norm(want) > 0, name
        assert _rel_l2(grads[name].numpy(), want) <= GRAD_REL_L2, name


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_through_the_ops_functions(arch):
    """On the CPU the loss's attention and WKV run through the
    ``FlashAttention`` and ``RWKV6WKV`` Functions (their plain backward);
    ``use_kernel=False`` differentiates the plain forward by autograd: the
    same gradients."""
    _, tcfg = _cfgs(arch)
    model = tf.load_jax_params(tcfg, _tree(arch), device="cpu",
                               trainable=True)
    _, tbatch = _batch(2)
    params = list(model.parameters())
    got = torch.autograd.grad(lm_loss(tcfg, model, tbatch)[0], params)
    want = torch.autograd.grad(lm_loss(tcfg, model, tbatch,
                                       use_kernel=False)[0], params)
    for g, w in zip(got, want):
        assert _rel_l2(g.numpy(), w.numpy()) <= GRAD_REL_L2


@pytest.mark.parametrize("s", [2047, 1536, 700])
def test_chunked_ce_matches_jax(s):
    """JAX's chunk rule (2047 = 23 x 89 collapses to one chunk, 1536 and
    700 split in 3 and 1) and padded vocab columns masked: the same sums."""
    rng = np.random.default_rng(s)
    b, d, vpad, vreal = 2, 8, 256, 200
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, vpad)) * 0.5).astype(np.float32)
    labels = rng.integers(0, vreal, (b, s)).astype(np.int32)
    valid = rng.uniform(size=(b, s)) < 0.9
    jl, jn = jlosses._chunked_ce(jnp.asarray(x), jnp.asarray(labels),
                                 jnp.asarray(valid), jnp.asarray(w), vreal)
    tl, tn = _chunked_ce(torch.from_numpy(x), torch.from_numpy(labels),
                         torch.from_numpy(valid), torch.from_numpy(w), vreal)
    assert tl.dtype == tn.dtype == torch.float32
    assert tn.item() == float(jn) == valid.sum()
    assert tl.item() == pytest.approx(float(jl), rel=LOSS_RTOL)


def test_lm_loss_refuses_unported_objectives():
    """The masked-unit (encoder-only) and prefix (vision) objectives, which
    raised before, match JAX's ``lm_loss`` on qwen3-8b's reduced tree
    rewired as each: the non-causal model's CE at the mask's positions,
    and the causal CE without the positions below ``num_prefix_embeds``
    (the image embeddings spliced there); each trains."""
    jcfg0, tcfg0 = _cfgs("qwen3-8b")
    tree = _tree("qwen3-8b")
    jbatch, tbatch = _batch(0)
    mask = np.random.default_rng(4).random((2, SEQ)) < 0.3
    img = np.random.default_rng(5).standard_normal((2, 4, 64)).astype(
        np.float32) * 0.2
    for kw, extra in ((dict(causal=False, family="audio"), "mask"),
                      (dict(family="vlm", frontend="vision",
                            num_prefix_embeds=4), "image_embeds")):
        jcfg = dataclasses.replace(jcfg0, **kw)
        cfg = dataclasses.replace(tcfg0, **kw)
        value = mask if extra == "mask" else img
        jb = dict(jbatch, **{extra: jnp.asarray(value)})
        tb = dict(tbatch, **{extra: torch.from_numpy(value)})
        want, _ = jlosses.lm_loss(jcfg, jax.tree.map(jnp.asarray, tree), jb,
                                  use_kernel=False)
        got, _ = lm_loss(cfg, tf.load_jax_params(cfg, tree, device="cpu"),
                         tb)
        assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
        assert callable(make_train_step(cfg, topt.AdamWConfig(),
                                        loss_kind="lm"))
    with pytest.raises(ValueError, match="loss_kind"):
        make_train_step(tcfg0, topt.AdamWConfig(), loss_kind="diffusion")


# --------------------------------------------------------------------------
# parameters and optimizer state
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_flag_and_load_jax_opt_state(arch):
    _, tcfg = _cfgs(arch)
    tree = _tree(arch)
    frozen = tf.load_jax_params(tcfg, tree, device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    model = tf.load_jax_params(tcfg, tree, device="cpu", trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    jstate = {"m": tree, "v": jax.tree.map(np.abs, tree),
              "step": np.int32(4)}
    state = tf.load_jax_opt_state(model, jstate)
    fresh = topt.init_opt_state(dict(model.named_parameters()))
    assert list(state["m"]) == list(fresh["m"])
    assert int(state["step"]) == 4
    for name, path, layer in tf.jax_leaf_names(tcfg):
        np.testing.assert_array_equal(state["v"][name].numpy(),
                                      np.abs(_leaf(tree, path, layer)))
        assert state["m"][name].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_continues_jax_state(arch):
    jcfg, tcfg = _cfgs(arch)
    jopt_cfg = jopt.AdamWConfig(lr=1e-3, schedule=jopt.warmup_cosine(
        1e-3, 10, 100))
    topt_cfg = topt.AdamWConfig(lr=1e-3, schedule=topt.warmup_cosine(
        1e-3, 10, 100))
    jstep = jsteps.make_train_step(jcfg, jopt_cfg, loss_kind="lm",
                                   use_kernel=False)
    params = _jax_tree(_tree(arch, seed=2))
    (jb1, _), (jb2, tb2) = _batch(3), _batch(4)
    key = jax.random.PRNGKey(0)
    p1, o1, _ = jstep(params, jopt.init_opt_state(params), jb1, key)
    p2, _, jm = jstep(p1, o1, jb2, key)

    model = tf.load_jax_params(tcfg, _np_tree(p1), device="cpu",
                               trainable=True)
    state = tf.load_jax_opt_state(model, _np_tree(o1))
    assert int(state["step"]) == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(tcfg, topt_cfg, loss_kind="lm")
    model, state, metrics = step(model, state, tb2)
    assert int(state["step"]) == 2
    for k in ("loss", "ce"):
        assert metrics[k].item() == pytest.approx(float(jm[k]),
                                                  rel=LOSS_RTOL)
    assert metrics["grad_norm"].item() == pytest.approx(
        float(jm["grad_norm"]), rel=GRAD_REL_L2)
    after = dict(model.named_parameters())
    worst = max(_rel_l2((after[n] - before[n]).detach().numpy(),
                        _leaf(p2, path, layer) - _leaf(p1, path, layer))
                for n, path, layer in tf.jax_leaf_names(tcfg))
    assert worst <= UPDATE_REL_L2


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_token_formula_matches_jax_stream():
    seed, step, b, s, vocab = 3, 5, 3, 40, 256
    jstream = jdata.LMStream(jdata.DataConfig(seed=seed, global_batch=b,
                                              seq_len=s), vocab)
    want = np.asarray(jstream.batch(step)["tokens"])
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    ks = jax.random.split(jax.random.fold_in(key, 0), 4)
    draws = (jax.random.randint(ks[0], (b, 1), 1, 8),
             jax.random.randint(ks[1], (b, 1), 0, vocab),
             jax.random.randint(ks[2], (b, s), 0, vocab),
             jax.random.bernoulli(ks[3], 0.15, (b, s)))
    got = token_formula(*(torch.from_numpy(np.array(d)) for d in draws), s,
                        vocab)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_stream_serves_the_language_models(arch):
    _, tcfg = _cfgs(arch)
    stream = make_stream(tcfg, DataConfig(seed=1, global_batch=3,
                                          seq_len=33), device="cpu")
    assert isinstance(stream, LMStream) and stream.vocab == 256
    a, b, c = (stream.batch(s) for s in (3, 3, 4))
    assert a["tokens"].shape == (3, 33) and a["labels"] is a["tokens"]
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert 0 <= a["tokens"].min() and a["tokens"].max() < 256
    # mostly an affine progression: a token follows from its predecessor
    # by the row's step a in [1, 8) unless noise hit either of them
    steps = (a["tokens"][:, 1:] - a["tokens"][:, :-1]) % 256
    mode = torch.mode(steps, dim=1).values
    assert bool(((mode >= 1) & (mode < 8)).all())
    # the audio and vision stubs' streams (they raised before)
    from repro_torch.data import AudioStream, VLMStream
    audio = make_stream(dataclasses.replace(tcfg, family="audio",
                                            frontend="audio", causal=False),
                        DataConfig(global_batch=3, seq_len=33), device="cpu")
    vlm = make_stream(dataclasses.replace(tcfg, family="vlm",
                                          frontend="vision",
                                          num_prefix_embeds=4),
                      DataConfig(seed=1, global_batch=3, seq_len=33),
                      device="cpu")
    assert isinstance(audio, AudioStream) and isinstance(vlm, VLMStream)
    assert audio.batch(3)["features"].shape == (3, 33, 64)
    v = vlm.batch(3)
    assert torch.equal(v["tokens"], a["tokens"])
    assert v["image_embeds"].shape == (3, 4, 64)


# --------------------------------------------------------------------------
# launcher, checkpoints, restart-resume
# --------------------------------------------------------------------------

def test_launcher_main_trains_reduced_qwen3_on_cpu(capsys):
    """20 steps, logged at steps 10 and 20 (the launcher's ``log_every``
    of 10): the loss falls between them."""
    losses = tlaunch.main(["--arch", "qwen3-8b", "--reduced", "--device",
                           "cpu", "--steps", "20", "--seq", "64"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_reduced_lm_on_cpu(tmp_path, arch):
    """``launch.train.build`` gives a trainable LM and the LM step; the
    loss on a held-out batch (one the loop does not train on) falls."""
    cfg, model, opt_state, step, kind = tlaunch.build(
        arch, reduced=True, lr=1e-3, total_steps=20, device="cpu")
    assert kind == "lm" and cfg.num_layers == 2
    assert all(p.requires_grad for p in model.parameters())
    stream = make_stream(cfg, DataConfig(global_batch=4, seq_len=64),
                         device="cpu")
    probe = stream.batch(100)

    def probe_loss():
        with torch.no_grad():
            return lm_loss(cfg, model, probe)[0].item()

    before = probe_loss()
    losses = []
    train_loop(step, model, opt_state, stream, 1,
               Checkpointer(str(tmp_path)),
               LoopConfig(total_steps=8, ckpt_every=100, log_every=1),
               metrics_cb=lambda s, m: losses.append(m["loss"]))
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert probe_loss() < before


def _setup(tmp_path, name, arch, total=6):
    cfg, model, opt_state, step, _ = tlaunch.build(
        arch, reduced=True, lr=1e-3, total_steps=20, device="cpu")
    stream = make_stream(cfg, DataConfig(global_batch=2, seq_len=32),
                         device="cpu")
    return (step, model, opt_state, stream, 0,
            Checkpointer(str(tmp_path / name)),
            LoopConfig(total_steps=total, ckpt_every=2, log_every=100))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_restart_resume_bitwise_identical(tmp_path, arch):
    """Preempt an LM run mid-way; a fresh trainer restores the checkpoint
    (parameters and moments keyed by name) and ends bitwise equal to an
    uninterrupted run."""
    ref = train_loop(*_setup(tmp_path, "ref", arch))
    step, model, opt, stream, seed, ck, lc = _setup(tmp_path, "run", arch)
    sig = PreemptionSignal()

    def inject(s):
        if s == 3:
            sig.set()

    with pytest.raises(Preempted):
        train_loop(step, model, opt, stream, seed, ck, lc, preemption=sig,
                   fault_injector=inject)
    assert ck.latest_step() == 4
    step, model, opt, stream, seed, _, lc = _setup(tmp_path, "run", arch)
    fin, fin_opt, s_fin = train_loop(step, model, opt, stream, seed, ck, lc)
    assert s_fin == lc.total_steps
    for (_, a), (_, b) in zip(ref[0].named_parameters(),
                              fin.named_parameters()):
        assert torch.equal(a, b)
    for key in ("m", "v"):
        for name, a in ref[1][key].items():
            assert torch.equal(a, fin_opt[key][name])
