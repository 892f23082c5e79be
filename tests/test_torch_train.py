"""The port's training path against the JAX package's, on the CPU.

A small DiT (2 layers, 8x8x4 images, patch 2: 16 tokens) gets one
parameter tree, every leaf drawn nonzero from a numpy seed
(``random_jax_tree``); JAX runs it with its flash kernels (forward and
backward) interpreted, the port through ``load_jax_params`` and its
``FlashAttention`` Function.  Where JAX draws ``t`` and ``eps`` from a
key, the test redraws them exactly as ``repro.train.losses`` does and
passes them to the port.

Tolerances (f32 on both sides):
* loss and grad norm: relative 1e-5 (two frameworks' f32 summation
  orders over two layers);
* gradients: relative L2 per leaf 1e-4 (measured up to 1.8e-6; the loss
  agreed to 2.3e-7 relative);
* one AdamW update on the same inputs: 1e-6 absolute (f32 rounding of the
  same formula);
* a whole train step from a carried JAX state: the update ``p_new - p_old``
  per leaf within relative L2 1e-3 (measured up to 8.3e-6, against 1.8e-6
  for the gradients: Adam's ``m / sqrt(v)`` amplifies the gradients'
  rounding where they are tiny);
* the image formula fed JAX's draws: 1e-6 absolute;
* checkpoints and restart-resume: bitwise.
"""
import jax

jax.config.update("jax_enable_x64", True)

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.optim as jopt
from repro.configs.base import ArchConfig as JArch
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.data import DataConfig, ImageStream, image_formula, make_stream
from repro_torch.launch import train as tlaunch
from repro_torch.models import dit as tdit
from repro_torch.runtime import (LoopConfig, Preempted, PreemptionSignal,
                                 train_loop)
from repro_torch.train import diffusion_loss, lm_loss, make_train_step
from repro_torch.transfer import host_to_device

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ADAM_ATOL = 1e-6
UPDATE_REL_L2 = 1e-3
IMAGE_ATOL = 1e-6

JAX_ONLY = dict(family="dit", vocab_size=0, causal=False, act="gelu",
                norm="layernorm")
# head dims 72 (SD-v2's) and 48
WIDTHS = {"hd72": dict(d_model=72, num_heads=1, num_kv_heads=1, d_ff=144),
          "hd48": dict(d_model=96, num_heads=2, num_kv_heads=2, d_ff=192)}


def _cfgs(width="hd72"):
    kw = dict(name="dit-train-small", num_layers=2, patch_size=2,
              in_channels=4, dtype="float32", **WIDTHS[width])
    return JArch(**kw, **JAX_ONLY), TArch(**kw)


def _lm_cfg(family, **kw):
    """A tiny config of an LM family the port does not train yet."""
    return TArch(name=f"{family}-lm", num_layers=1, d_model=8, num_heads=1,
                 num_kv_heads=1, d_ff=8, vocab_size=16, family=family, **kw)


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _images(seed, b=3):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, 8, 8, 4)).astype(np.float32)


def _jax_draws(key, imgs):
    """``t`` and ``eps`` exactly as ``repro.train.losses.diffusion_loss``
    draws them from ``key``."""
    k_t, k_eps = jax.random.split(key)
    t = jax.random.uniform(k_t, (imgs.shape[0],), minval=0.0, maxval=999.0)
    eps = jax.random.normal(k_eps, imgs.shape, imgs.dtype)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


def _leaf(tree, path, layer):
    for part in path.split("/"):
        tree = tree[part]
    tree = np.asarray(tree, np.float32)
    return tree if layer is None else tree[layer]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# the diffusion loss and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_diffusion_loss_and_grads_match_jax(width):
    jcfg, tcfg = _cfgs(width)
    tree = tdit.random_jax_tree(tcfg, seed=0)
    imgs = _images(1)
    key = jax.random.PRNGKey(7)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlosses.diffusion_loss(jcfg, p, {"images": jnp.asarray(
            imgs)}, key, use_kernel=True), has_aux=True)(_jax_tree(tree))
    t, eps = _jax_draws(key, imgs)
    model = tdit.load_jax_params(tcfg, tree, device="cpu")
    loss, metrics = diffusion_loss(model, {"images": torch.from_numpy(imgs)},
                                   t=t, eps=eps)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert metrics["mse"].item() == loss.item()
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert len(grads) == len(tdit.jax_leaf_names(tcfg))
    for name, path, layer in tdit.jax_leaf_names(tcfg):
        want = _leaf(jgrads, path, layer)
        assert np.linalg.norm(want) > 0, name
        assert _rel_l2(grads[name].numpy(), want) <= GRAD_REL_L2, name


def test_diffusion_loss_draws_from_the_generator():
    _, tcfg = _cfgs()
    model = tdit.load_jax_params(tcfg, tdit.random_jax_tree(tcfg, seed=0),
                                 device="cpu")
    batch = {"images": torch.from_numpy(_images(2))}
    runs = [diffusion_loss(model, batch, torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert runs[0].item() == runs[1].item() != runs[2].item()
    with pytest.raises(ValueError, match="generator"):
        diffusion_loss(model, batch)
    # the LM loss's masked-unit (audio) form: an encoder-only model fed
    # frame features, the CE of the labels where the mask holds
    from repro_torch.models import transformer as tf
    cfg = _lm_cfg("audio", causal=False, frontend="audio")
    lm = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    mask = torch.tensor([[1, 0, 1, 1, 0], [0, 0, 1, 0, 1]], dtype=torch.bool)
    audio = {"features": torch.randn((2, 5, 8), generator=g),
             "labels": torch.randint(0, 16, (2, 5), generator=g),
             "mask": mask}
    loss, metrics = lm_loss(cfg, lm, audio)
    assert bool(torch.isfinite(loss)) and metrics["tokens"].item() == 5.0
    assert "embed" not in lm


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init_opt_state(params)
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        topt.adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert params["w"].abs().max().item() < 0.05
    assert int(state["step"]) == 200


def test_grad_clip():
    clipped, norm = topt.clip_by_global_norm({"a": torch.full((10,), 100.0)},
                                             1.0)
    assert abs(topt.global_norm(clipped).item() - 1.0) < 1e-5
    assert norm.item() > 100


def test_warmup_cosine_shape():
    sched = topt.warmup_cosine(1.0, 10, 100)
    assert sched(torch.tensor(5)).item() == pytest.approx(0.5)
    assert sched(torch.tensor(10)).item() == pytest.approx(1.0)
    assert sched(torch.tensor(100)).item() == pytest.approx(0.1, abs=1e-3)


def test_bf16_params_updated_via_fp32():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = topt.init_opt_state(params)
    assert state["m"]["w"].dtype == torch.float32
    topt.adamw_update(params, {"w": torch.ones(4, dtype=torch.bfloat16)},
                      state, topt.AdamWConfig(lr=0.1))
    assert params["w"].dtype == torch.bfloat16
    assert bool((params["w"] != 1).all())


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,)}
    p = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    g = {n: 3 * rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    m = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    v = {n: rng.uniform(0.1, 2.0, s).astype(np.float32)
         for n, s in shapes.items()}
    jcfg = jopt.AdamWConfig(lr=1e-2, schedule=jopt.warmup_cosine(1e-2, 4, 20))
    tcfg = topt.AdamWConfig(lr=1e-2, schedule=topt.warmup_cosine(1e-2, 4, 20))
    jp, jstate, jm = jopt.adamw_update(
        {n: jnp.asarray(x) for n, x in p.items()},
        {n: jnp.asarray(x) for n, x in g.items()},
        {"m": {n: jnp.asarray(x) for n, x in m.items()},
         "v": {n: jnp.asarray(x) for n, x in v.items()},
         "step": jnp.int32(5)}, jcfg)
    tp = {n: torch.from_numpy(x.copy()) for n, x in p.items()}
    tstate = {"m": {n: torch.from_numpy(x.copy()) for n, x in m.items()},
              "v": {n: torch.from_numpy(x.copy()) for n, x in v.items()},
              "step": torch.tensor(5, dtype=torch.int32)}
    _, tstate, tm = topt.adamw_update(
        tp, {n: torch.from_numpy(x) for n, x in g.items()}, tstate, tcfg)
    assert int(tstate["step"]) == int(jstate["step"]) == 6
    for key in ("grad_norm", "lr"):
        assert tm[key].item() == pytest.approx(float(jm[key]), abs=ADAM_ATOL)
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=ADAM_ATOL, rtol=0)
        for k in ("m", "v"):
            np.testing.assert_allclose(tstate[k][n].numpy(),
                                       np.asarray(jstate[k][n]),
                                       atol=ADAM_ATOL, rtol=0)


# --------------------------------------------------------------------------
# a whole train step from a carried JAX state
# --------------------------------------------------------------------------

def test_train_step_continues_jax_state():
    jcfg, tcfg = _cfgs("hd48")
    jopt_cfg = jopt.AdamWConfig(lr=1e-3, schedule=jopt.warmup_cosine(
        1e-3, 10, 100))
    topt_cfg = topt.AdamWConfig(lr=1e-3, schedule=topt.warmup_cosine(
        1e-3, 10, 100))
    jstep = jsteps.make_train_step(jcfg, jopt_cfg, loss_kind="diffusion",
                                   use_kernel=True)
    params = _jax_tree(tdit.random_jax_tree(tcfg, seed=2))
    batches = [_images(3), _images(4)]
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
    p1, o1, _ = jstep(params, jopt.init_opt_state(params),
                      {"images": jnp.asarray(batches[0])}, keys[0])
    p2, _, jm = jstep(p1, o1, {"images": jnp.asarray(batches[1])}, keys[1])

    model = tdit.load_jax_params(tcfg, _np_tree(p1), device="cpu")
    state = tdit.load_jax_opt_state(model, _np_tree(o1))
    assert int(state["step"]) == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t, eps = _jax_draws(keys[1], batches[1])
    step = make_train_step(tcfg, topt_cfg)
    model, state, metrics = step(model, state,
                                 {"images": torch.from_numpy(batches[1])},
                                 t=t, eps=eps)
    assert int(state["step"]) == 2
    for key in ("loss", "grad_norm"):
        assert metrics[key].item() == pytest.approx(float(jm[key]),
                                                    rel=LOSS_RTOL)
    after = dict(model.named_parameters())
    worst = 0.0
    for name, path, layer in tdit.jax_leaf_names(tcfg):
        want = _leaf(p2, path, layer) - _leaf(p1, path, layer)
        got = (after[name] - before[name]).detach().numpy()
        worst = max(worst, _rel_l2(got, want))
    assert worst <= UPDATE_REL_L2


def test_load_jax_opt_state_maps_every_leaf():
    _, tcfg = _cfgs()
    tree = tdit.random_jax_tree(tcfg, seed=0)
    model = tdit.load_jax_params(tcfg, tree, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    jstate = {"m": tree, "v": jax.tree.map(np.abs, tree), "step": np.int32(4)}
    state = tdit.load_jax_opt_state(model, jstate)
    fresh = topt.init_opt_state(dict(model.named_parameters()))
    assert state["m"].keys() == fresh["m"].keys()
    for name, path, layer in tdit.jax_leaf_names(tcfg):
        np.testing.assert_array_equal(state["v"][name].numpy(),
                                      np.abs(_leaf(tree, path, layer)))
        assert state["m"][name].dtype == torch.float32


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_image_formula_matches_jax_stream():
    seed, step, b = 3, 5, 2
    jstream = jdata.ImageStream(jdata.DataConfig(seed=seed, global_batch=b),
                                8, 4)
    want = np.asarray(jstream.batch(step)["images"])
    key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xD1F), step)
    ks = jax.random.split(jax.random.fold_in(key, 0), 5)
    u = jax.random.uniform
    draws = [u(ks[0], (b, 1, 1, 1)), u(ks[1], (b, 1, 1, 1)),
             u(ks[2], (b, 1, 1, 1), minval=0.05, maxval=0.3),
             u(ks[3], (b, 1, 1, 4), minval=-1, maxval=1),
             u(ks[4], (b, 1, 1, 4), minval=0.3, maxval=1.0)]
    got = image_formula(*(torch.from_numpy(np.array(d)) for d in draws), 8)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_ATOL, rtol=0)


def test_image_stream_deterministic_and_step_dependent():
    _, tcfg = _cfgs()
    stream = make_stream(tcfg, DataConfig(seed=1, global_batch=3),
                         device="cpu")
    assert isinstance(stream, ImageStream) and stream.size == 32
    a, b, c = (stream.batch(s)["images"] for s in (3, 3, 4))
    assert a.shape == (3, 32, 32, 4) and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.min() >= -1 and a.max() <= 1
    other = ImageStream(DataConfig(seed=2, global_batch=3), 32, 4, "cpu")
    assert not torch.equal(other.batch(3)["images"], a)
    # the audio stub's stream: frame features, labels and the loss mask
    from repro_torch.data import AudioStream
    audio = make_stream(_lm_cfg("audio", causal=False, frontend="audio"),
                        DataConfig(global_batch=2, seq_len=5), device="cpu")
    assert isinstance(audio, AudioStream)
    got = audio.batch(3)
    assert got["features"].shape == (2, 5, 8) and got["mask"].dtype == \
        torch.bool and got["labels"].max() < 16


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.randn(5, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_checkpoint_roundtrip_bitwise(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(10, t, {"note": "x"})
    restored, step, meta = ck.restore(_zeros_like(t))
    assert step == 10 and meta["note"] == "x"
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"].view(torch.int16),
                       t["b"]["c"].view(torch.int16))
    assert torch.equal(restored["a"], t["a"])
    assert restored["step"].item() == 7
    assert sorted(os.listdir(tmp_path / "step_10")) == ["host0.npz",
                                                        "manifest.json"]


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _tree())
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    ck.close()


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp dir (simulated mid-save preemption) is never visible."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_6.tmp"))
    assert ck.latest_step() == 5 and ck.all_steps() == [5]
    _, step, _ = ck.restore(_zeros_like(_tree()))
    assert step == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    bad = dict(_zeros_like(_tree()), a=torch.zeros(5, 5))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad)
    assert torch.count_nonzero(bad["b"]["c"]) == 0     # nothing copied
    with pytest.raises(ValueError, match="missing"):
        ck.restore({"a": torch.zeros(3, 4), "x": torch.zeros(1)})


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------

def _setup_training(tmp_path, name, total=8):
    _, tcfg = _cfgs()
    model = tdit.load_jax_params(tcfg, tdit.random_jax_tree(tcfg, seed=0),
                                 device="cpu")
    opt_state = topt.init_opt_state(dict(model.named_parameters()))
    step = make_train_step(tcfg, topt.AdamWConfig(lr=1e-3))
    stream = ImageStream(DataConfig(global_batch=2), 8, 4, device="cpu")
    return (step, model, opt_state, stream, 0,
            Checkpointer(str(tmp_path / name)),
            LoopConfig(total_steps=total, ckpt_every=3, log_every=100))


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_restart_resume_bitwise_identical(tmp_path):
    """Preempt mid-run; restart; final params == uninterrupted run."""
    ref_model = train_loop(*_setup_training(tmp_path, "ref"))[0]
    step, model, opt, stream, seed, ck, lc = _setup_training(tmp_path, "run")
    sig = PreemptionSignal()

    def inject(s):
        if s == 4:
            sig.set()   # flag raised while step 4 is in flight

    with pytest.raises(Preempted):
        train_loop(step, model, opt, stream, seed, ck, lc, preemption=sig,
                   fault_injector=inject)
    # the loop finishes the in-flight step, saves, then raises: saved at 5
    assert ck.latest_step() == 5
    # restart from fresh state: the loop restores and resumes
    step, model, opt, stream, seed, _, lc = _setup_training(tmp_path, "run")
    fin, _, s_fin = train_loop(step, model, opt, stream, seed, ck, lc)
    assert s_fin == lc.total_steps
    for a, b in zip(_params(ref_model), _params(fin)):
        assert torch.equal(a, b)


def test_transient_fault_retry(tmp_path):
    """A step that fails (flaky infra) is retried with the same batch and
    generator, and the run ends as a clean run does."""
    args = _setup_training(tmp_path, "flaky", total=5)
    fails = {"left": 2}

    def flaky(s):
        if s == 3 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("simulated transient interconnect failure")

    logged = []
    m1 = train_loop(*args, fault_injector=flaky,
                    metrics_cb=lambda s, m: logged.append((s, m)))[0]
    assert fails["left"] == 0
    assert [s for s, _ in logged] == [5]
    assert {"loss", "mse", "grad_norm", "lr", "step_time_s"} <= \
        logged[0][1].keys()
    m2 = train_loop(*_setup_training(tmp_path, "clean", total=5))[0]
    for a, b in zip(_params(m1), _params(m2)):
        assert torch.equal(a, b)


def test_permanent_fault_saves_state(tmp_path):
    args = _setup_training(tmp_path, "dead", total=6)

    def dead(s):
        if s == 4:
            raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError, match="permanent"):
        train_loop(*args, fault_injector=dead)
    ck = args[5]
    assert ck.latest_step() == 4    # state persisted before giving up
    with open(os.path.join(ck.dir, "step_4", "manifest.json")) as f:
        assert '"failed_step": 4' in f.read()


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------

def test_launcher_trains_reduced_dit_on_cpu(tmp_path):
    cfg, model, opt_state, step, kind = tlaunch.build(
        "srds-dit-sd2", reduced=True, lr=1e-3, total_steps=20, device="cpu")
    assert kind == "diffusion" and cfg.num_layers == 2
    stream = make_stream(cfg, DataConfig(global_batch=2), device="cpu")
    probe = stream.batch(0)
    g = torch.Generator().manual_seed(9)
    t = 999.0 * torch.rand(2, generator=g)
    eps = torch.randn(probe["images"].shape, generator=g)

    def probe_loss():
        with torch.no_grad():
            return diffusion_loss(model, probe, t=t, eps=eps)[0].item()

    before = probe_loss()
    losses = []
    train_loop(step, model, opt_state, stream, 1,
               Checkpointer(str(tmp_path)),
               LoopConfig(total_steps=8, ckpt_every=100, log_every=1),
               metrics_cb=lambda s, m: losses.append(m["loss"]))
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert probe_loss() < before


def test_launcher_main_runs_on_cpu(capsys):
    """Two steps log once, at the last step (the launcher logs every
    ``LOG_EVERY``-th step and the last)."""
    losses = tlaunch.main(["--arch", "srds-dit-sd2", "--reduced", "--device",
                           "cpu", "--steps", "2", "--batch", "2"])
    assert len(losses) == 1 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out


def test_launcher_logs_every_tenth_step_on_cpu(capsys):
    """The launcher passes JAX's ``log_every=10`` to ``train_loop`` (a
    logged step turns its metrics into host floats, a wait for the card):
    20 steps call the metrics callback at steps 10 and 20 only."""
    assert tlaunch.LOG_EVERY == 10
    losses = tlaunch.main(["--arch", "srds-dit-sd2", "--reduced", "--device",
                           "cpu", "--steps", "20", "--batch", "2"])
    out = capsys.readouterr().out
    assert re.findall(r"^step (\d+):", out, flags=re.M) == ["10", "20"]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["srds-dit-sd2", "qwen3-8b"])
def test_stream_batches_copy_through_pinned_memory(monkeypatch, arch):
    """``ImageStream.batch`` and ``LMStream.batch`` move every draw with
    ``host_to_device`` (pinned memory, non-blocking on a CUDA device: no
    wait for the card), and their batches are bitwise those of a plain
    copy of the same draws."""
    from repro_torch.data import pipeline
    cfg = get_arch(arch).reduced()
    stream = make_stream(cfg, DataConfig(global_batch=3, seq_len=40),
                         device="cpu")
    calls = []

    def counted(a, device):
        calls.append(tuple(a.shape))
        return host_to_device(a, device)

    monkeypatch.setattr(pipeline, "host_to_device", counted)
    for step in (0, 7):
        got = stream.batch(step)
        draws = stream.draws(step)
        if cfg.family == "dit":
            want = {"images": pipeline.image_formula(*draws, stream.size)}
        else:
            tokens = pipeline.token_formula(*draws, 40, cfg.vocab_size)
            want = {"tokens": tokens, "labels": tokens}
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype
            assert torch.equal(got[key], value)
    assert calls == [tuple(d.shape) for d in stream.draws(0)] * 2


def test_launcher_refuses_what_is_not_ported(monkeypatch):
    # every arch of the zoo builds (reduced here: the full stablelm-3b is
    # 2.8 B parameters); an unknown name raises as JAX's does
    cfg, model, _, _, kind = tlaunch.build("stablelm-3b", reduced=True,
                                           device="cpu")
    assert cfg.name == "stablelm-3b-reduced" and kind == "lm"
    assert "bias" in model["ln_f"]
    with pytest.raises(KeyError, match="unknown arch"):
        tlaunch.build("no-such-arch", device="cpu")
    # the pod meshes are ported (PR 28): a group of the wrong size names
    # the ranks the mesh needs
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tlaunch.build("srds-dit-sd2", mesh_kind="pod1", device="cpu")
    # the MoE block's step trains: its aux enters the loss
    from repro_torch.models import transformer as tf
    moe = _lm_cfg("moe", moe_experts=4, moe_top_k=2, moe_d_ff=8)
    step = make_train_step(moe, topt.AdamWConfig(), loss_kind="lm")
    lm = tf.init_params(moe, torch.Generator().manual_seed(0), device="cpu",
                        trainable=True)
    toks = torch.randint(0, 16, (2, 6), generator=torch.Generator(
    ).manual_seed(2))
    _, _, metrics = step(lm, topt.init_opt_state(dict(lm.named_parameters())),
                         {"tokens": toks, "labels": toks})
    assert metrics["aux"].item() > 0 and bool(torch.isfinite(
        metrics["loss"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.build("srds-dit-sd2", reduced=True)
