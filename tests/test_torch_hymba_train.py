"""The port's hymba-1.5b training path against the JAX package's, on the
CPU.

hymba-1.5b (attention and a selective SSM side by side in every layer) at
the JAX ``reduced()`` size (2 layers, d 64, 4/2 heads of 16, an SSM of
64 x 8, vocab 256, f32), with its window cut to 5 on both sides (as in
``tests/test_torch_hymba.py``) so that every sequence here is longer than
the window.  The parameters are JAX's ``init_params(cfg, PRNGKey(0))``
with every leaf moved by a small numpy draw (the init's constant ``b_dt``,
``D``, ``A_log`` and unit norms would otherwise hide their gradients'
paths), carried into the port by ``load_jax_params``; inputs come from a
numpy seed.  JAX runs its plain path (``use_kernel=False``, passed
explicitly: ``tests/test_serve.py`` sets ``FORCE_REF`` at import) and
differentiates its ``jax.lax.scan``; the port runs ``SelectiveScan``,
whose CPU backward is ``ref.selective_scan_bwd``.

Tolerances (f32 on both sides), each with the reading it was set from:
* the scan's backward twin against autograd of ``ref.selective_scan``:
  relative L2 1e-5 per gradient (read at most 4.1e-7: the same math, its
  sums in another order);
* ``ssm_forward``'s gradients against ``jax.grad``: relative L2 1e-4 per
  leaf (read at most 5.4e-7);
* ``lm_loss`` relative 1e-5, every parameter's gradient relative L2 1e-4
  (read at most 3.8e-6) and the grad norm relative 1e-4, as
  ``tests/test_torch_lm_train.py``'s;
* one AdamW step from a carried JAX state: the update ``p_new - p_old``
  per leaf within relative L2 1e-3 (Adam's ``m / sqrt(v)`` amplifies the
  gradients' rounding where they are tiny).
The controls (the twin without ``dh_T``; the backward with its ``ddt``
term dropped) must miss these limits.
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
from repro.models import hymba as jhym
from repro.models import transformer as jtf
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import optim as topt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, LMStream, make_stream
from repro_torch.kernels import ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import hymba
from repro_torch.models import transformer as tf
from repro_torch.runtime import LoopConfig, train_loop
from repro_torch.train import lm_loss, make_train_step

ARCH = "hymba-1.5b"
WINDOW = 5
SEQ = 24
TWIN_REL_L2 = 1e-5
SSM_REL_L2 = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-3
GRADS = ("dxs", "ddt", "dbb", "dcc", "da", "dd", "dh0")


def _cfgs():
    return (dataclasses.replace(jget_arch(ARCH).reduced(), window=WINDOW),
            dataclasses.replace(get_arch(ARCH).reduced(), window=WINDOW))


def _tree(seed=0):
    """JAX's init for the reduced arch, every leaf moved by 0.05 x a
    standard normal draw from ``seed`` (the SSM's b_dt, D and A_log by
    more, so that dt, the skip and the decays are not their constant
    inits): numpy f32 leaves."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)),
        jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    ssm = tree["blocks"]["ssm"]
    for name, scale in (("b_dt", 0.5), ("D", 0.3), ("A_log", 0.2)):
        ssm[name] = (ssm[name] + scale * rng.standard_normal(
            ssm[name].shape)).astype(np.float32)
    return tree


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


def _no_ddt(monkeypatch):
    """The control: the CPU backward with its ``ddt`` term dropped."""
    real = ref.selective_scan_bwd

    def broken(*args, **kw):
        g = list(real(*args, **kw))
        g[1] = torch.zeros_like(g[1])
        return tuple(g)

    monkeypatch.setattr(ref, "selective_scan_bwd", broken)


# --------------------------------------------------------------------------
# the scan's backward twin
# --------------------------------------------------------------------------

def _scan_operands(seed, b, t, din, n):
    """The scan's operands at the model's scales from a numpy seed (xs and
    B, C standard normal, dt softplus(N(-1, 1)), a = -exp(N(0, 0.25)), a
    nonzero h0), upstream gradients of y and of the final state, all
    f32."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(f))

    dt = torch.nn.functional.softplus(rand(b, t) - 1.0)
    ins = [rand(b, t, din), dt, rand(b, t, n), rand(b, t, n),
           -torch.exp(rand(din, n, scale=0.5)), rand(din),
           rand(b, din, n, scale=0.5)]
    return ins, rand(b, t, din), rand(b, din, n)


# (B, T, din, n): T no multiple of the 64-step chunk (37, 130), n 5 (no
# power of two), hymba's 16 states, one step, and T past two chunks
TWIN_CASES = [(2, 37, 6, 16), (1, 130, 4, 5), (2, 1, 3, 8), (2, 150, 5, 3)]


@pytest.mark.parametrize("case", TWIN_CASES, ids=str)
def test_scan_bwd_twin_matches_autograd(case):
    """``ref.selective_scan_bwd`` from a nonzero h0 with gradients on y and
    on the final state against autograd of ``ref.selective_scan``: all
    seven gradients within TWIN_REL_L2."""
    ins, dy, dh_t = _scan_operands(sum(case), *case)
    leaves = [v.clone().requires_grad_() for v in ins]
    y, h_t = ref.selective_scan(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (h_t * dh_t).sum(), leaves)
    got = ref.selective_scan_bwd(*ins, dy, dh_t)
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel_l2(g, w) <= TWIN_REL_L2, (name, _rel_l2(g, w))


@pytest.mark.parametrize("every", [1, 16, 64, 200])
def test_scan_bwd_twin_chunks_replay_the_same_bits(every):
    """The chunked order changes no bit: each chunk's states are replayed
    from its checkpoint by the forward's own operations (no decay divided
    out), so any chunk gives the same gradients as one chunk of all T; a
    missing ``dh_T`` counts as zeros."""
    ins, dy, _ = _scan_operands(7, 2, 130, 4, 5)
    want = ref.selective_scan_bwd(*ins, dy, torch.zeros(2, 4, 5),
                                  ckpt_every=130)
    got = ref.selective_scan_bwd(*ins, dy, None, ckpt_every=every)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# the segmented twin: T 37 in chunks of 8 steps (5 chunks, the last
# ragged) cut into 2 (3 + 2 chunks), 3 (2 + 2 + 1) or 8 asked (5 of one),
# short enough that the carries into the segments matter
SEG_CHUNK, SEG_CASE = 8, (2, 37, 6, 16)
SEG_REL_L2 = 1e-6


@pytest.mark.parametrize("segments", [2, 3, 8])
def test_scan_bwd_twin_segments_match_autograd_and_one_segment(segments):
    """``ref.selective_scan_bwd`` with T cut into segments (each walked
    alone from a zero carry for its decay product and local carry, the
    carries folded from the last segment) from a nonzero h0 with ``dh_T``
    at a ragged T: every gradient within TWIN_REL_L2 of autograd of
    ``ref.selective_scan`` and within SEG_REL_L2 of the single walk."""
    ins, dy, dh_t = _scan_operands(5, *SEG_CASE)
    leaves = [v.clone().requires_grad_() for v in ins]
    y, h_t = ref.selective_scan(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (h_t * dh_t).sum(), leaves)
    one = ref.selective_scan_bwd(*ins, dy, dh_t, ckpt_every=SEG_CHUNK)
    got = ref.selective_scan_bwd(*ins, dy, dh_t, ckpt_every=SEG_CHUNK,
                                 segments=segments)
    for name, g, w, o in zip(GRADS, got, want, one):
        assert _rel_l2(g, w) <= TWIN_REL_L2, (name, _rel_l2(g, w))
        assert _rel_l2(g, o) <= SEG_REL_L2, (name, _rel_l2(g, o))


def test_scan_bwd_twin_segments_control_drops_the_carry(monkeypatch):
    """The comparison can fail: with the carry into every segment but the
    last dropped (zeros), the segmented twin misses SEG_REL_L2 of the
    single walk on dx, ddt, dB, da and dh0 (dC and dD do not read g)."""
    ins, dy, dh_t = _scan_operands(5, *SEG_CASE)
    one = ref.selective_scan_bwd(*ins, dy, dh_t, ckpt_every=SEG_CHUNK)
    real = ref._segment_carries

    def dropped(*args):
        carries = real(*args)
        return [torch.zeros_like(c) for c in carries[:-1]] + carries[-1:]

    monkeypatch.setattr(ref, "_segment_carries", dropped)
    got = ref.selective_scan_bwd(*ins, dy, dh_t, ckpt_every=SEG_CHUNK,
                                 segments=3)
    for i in (0, 1, 2, 4, 6):
        assert _rel_l2(got[i], one[i]) > SEG_REL_L2, GRADS[i]


def test_scan_bwd_twin_control_misses():
    """The comparison can fail: the twin without the final state's
    gradient misses TWIN_REL_L2 on ddt, da and dh0."""
    ins, dy, dh_t = _scan_operands(11, *TWIN_CASES[0])
    leaves = [v.clone().requires_grad_() for v in ins]
    y, h_t = ref.selective_scan(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (h_t * dh_t).sum(), leaves)
    wrong = ref.selective_scan_bwd(*ins, dy, None)
    for i in (1, 4, 6):
        assert _rel_l2(wrong[i], want[i]) > TWIN_REL_L2, GRADS[i]


# --------------------------------------------------------------------------
# ssm_forward
# --------------------------------------------------------------------------

def _ssm(seed):
    """One layer's SSM leaves of the moved tree, JAX's and the port's
    (trainable), and x and h0 from ``seed``."""
    tree = _tree()
    jssm = {k: np.asarray(v[1]) for k, v in tree["blocks"]["ssm"].items()}
    tssm = {k: torch.from_numpy(v.copy()).requires_grad_()
            for k, v in jssm.items()}
    rng = np.random.default_rng(seed)
    _, tcfg = _cfgs()
    x = rng.standard_normal((2, 19, tcfg.d_model)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((2, tcfg.ssm_d_inner, tcfg.ssm_state))
          ).astype(np.float32)
    w = rng.standard_normal((2, 19, tcfg.d_model)).astype(np.float32)
    wh = rng.standard_normal(h0.shape).astype(np.float32)
    return jssm, tssm, x, h0, w, wh


def _ssm_grads(seed):
    """``jax.grad`` and the port's autograd of ``sum(out * w) + sum(h_fin
    * wh)`` with respect to x, h0 and every SSM leaf."""
    jssm, tssm, x, h0, w, wh = _ssm(seed)

    def jloss(p, x, h0):
        out, h_fin = jhym.ssm_forward(p, x, h0)
        return jnp.sum(out * w) + jnp.sum(h_fin * wh)

    jp = {k: jnp.asarray(v) for k, v in jssm.items()}
    jg, jgx, jgh = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), jnp.asarray(h0))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    out, h_fin = hymba.ssm_forward(tssm, tx, th)
    loss = (out * torch.from_numpy(w)).sum() + (h_fin
                                                * torch.from_numpy(wh)).sum()
    names = sorted(tssm)
    got = torch.autograd.grad(loss, [tssm[k] for k in names] + [tx, th])
    want = [np.asarray(jg[k]) for k in names] + [np.asarray(jgx),
                                                 np.asarray(jgh)]
    return dict(zip(names + ["x", "h0"], zip(got, want)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssm_forward_grads_match_jax(seed):
    """The port's ``ssm_forward`` (through ``SelectiveScan`` and its plain
    backward) against ``jax.grad`` of ``repro.models.hymba.ssm_forward``,
    from a nonzero state: x, h0 and every SSM leaf within SSM_REL_L2."""
    for name, (g, w) in _ssm_grads(seed).items():
        assert np.linalg.norm(w) > 0, name
        assert _rel_l2(g.numpy(), w) <= SSM_REL_L2, (name, _rel_l2(g, w))


def test_ssm_forward_grads_control_misses(monkeypatch):
    """With the scan's ``ddt`` dropped, the gradients of the dt projection
    (w_dt, b_dt) miss SSM_REL_L2."""
    _no_ddt(monkeypatch)
    got = _ssm_grads(0)
    for name in ("w_dt", "b_dt"):
        g, w = got[name]
        assert _rel_l2(g.numpy(), w) > SSM_REL_L2, name


# --------------------------------------------------------------------------
# the whole reduced model: loss, gradients, one AdamW step
# --------------------------------------------------------------------------

def _jax_loss_and_grads(tree, jbatch):
    jcfg, _ = _cfgs()
    return jax.value_and_grad(
        lambda p: jlosses.lm_loss(jcfg, p, jbatch, use_kernel=False),
        has_aux=True)(_jax_tree(tree))


def _port_grads(tree, tbatch):
    _, tcfg = _cfgs()
    model = tf.load_jax_params(tcfg, tree, device="cpu", trainable=True)
    loss, metrics = lm_loss(tcfg, model, tbatch)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    return loss, metrics, grads


def test_hymba_lm_loss_and_grads_match_jax():
    """``lm_loss`` and every parameter's gradient of the reduced hymba
    (window 5 < S 24) against ``jax.value_and_grad`` of JAX's ``lm_loss``:
    loss within LOSS_RTOL, each leaf within GRAD_REL_L2."""
    _, tcfg = _cfgs()
    tree = _tree()
    jbatch, tbatch = _batch(1)
    (jloss, jm), jgrads = _jax_loss_and_grads(tree, jbatch)
    loss, metrics, grads = _port_grads(tree, tbatch)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert metrics["tokens"].item() == float(jm["tokens"]) == 2 * (SEQ - 1)
    assert len(grads) == len(tf.jax_leaf_names(tcfg))
    for name, path, layer in tf.jax_leaf_names(tcfg):
        want = _leaf(jgrads, path, layer)
        assert np.linalg.norm(want) > 0, name
        assert _rel_l2(grads[name].numpy(), want) <= GRAD_REL_L2, name


def test_hymba_grads_control_misses(monkeypatch):
    """With the scan's ``ddt`` dropped the gradients of both layers' dt
    projections, and of the leaves before them, miss GRAD_REL_L2."""
    _, tcfg = _cfgs()
    tree = _tree()
    jbatch, tbatch = _batch(1)
    _, jgrads = _jax_loss_and_grads(tree, jbatch)
    _no_ddt(monkeypatch)
    _, _, grads = _port_grads(tree, tbatch)
    missed = {name for name, path, layer in tf.jax_leaf_names(tcfg)
              if _rel_l2(grads[name].numpy(), _leaf(jgrads, path, layer))
              > GRAD_REL_L2}
    for layer in range(tcfg.num_layers):
        for leaf in ("w_dt", "b_dt"):
            assert f"blocks.{layer}.ssm.{leaf}" in missed, sorted(missed)


def test_hymba_train_step_continues_jax_state():
    """One AdamW step of the port from JAX's state after one step against
    JAX's second step (``repro.train.steps.make_train_step``,
    ``use_kernel=False``): loss, grad norm and every leaf's update."""
    jcfg, tcfg = _cfgs()
    jopt_cfg = jopt.AdamWConfig(lr=1e-3, schedule=jopt.warmup_cosine(
        1e-3, 10, 100))
    topt_cfg = topt.AdamWConfig(lr=1e-3, schedule=topt.warmup_cosine(
        1e-3, 10, 100))
    jstep = jsteps.make_train_step(jcfg, jopt_cfg, loss_kind="lm",
                                   use_kernel=False)
    params = _jax_tree(_tree(seed=2))
    (jb1, _), (jb2, tb2) = _batch(3), _batch(4)
    key = jax.random.PRNGKey(0)
    p1, o1, _ = jstep(params, jopt.init_opt_state(params), jb1, key)
    p2, _, jm = jstep(p1, o1, jb2, key)

    model = tf.load_jax_params(tcfg, _np_tree(p1), device="cpu",
                               trainable=True)
    state = tf.load_jax_opt_state(model, _np_tree(o1))
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


def test_hymba_lm_loss_runs_selective_scan_function(monkeypatch):
    """On the CPU the loss's scan runs through ``SelectiveScan`` (its
    plain backward) in every layer, and ``use_kernel=False``
    differentiates the plain scan by autograd: the same gradients."""
    _, tcfg = _cfgs()
    model = tf.load_jax_params(tcfg, _tree(), device="cpu", trainable=True)
    _, tbatch = _batch(2)
    calls = []
    real = ref.selective_scan_bwd

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ref, "selective_scan_bwd", counted)
    params = list(model.parameters())
    got = torch.autograd.grad(lm_loss(tcfg, model, tbatch)[0], params)
    assert len(calls) == tcfg.num_layers
    want = torch.autograd.grad(lm_loss(tcfg, model, tbatch,
                                       use_kernel=False)[0], params)
    assert len(calls) == tcfg.num_layers
    for g, w in zip(got, want):
        assert _rel_l2(g.numpy(), w.numpy()) <= GRAD_REL_L2


# --------------------------------------------------------------------------
# data and launcher
# --------------------------------------------------------------------------

def test_make_stream_gives_hybrid_the_lm_stream():
    """hymba's stream is ``LMStream`` over its vocabulary: the same batches
    as an ``LMStream`` built directly."""
    _, tcfg = _cfgs()
    data = DataConfig(seed=4, global_batch=3, seq_len=33)
    stream = make_stream(tcfg, data, device="cpu")
    assert isinstance(stream, LMStream) and stream.vocab == tcfg.vocab_size
    direct = LMStream(data, tcfg.vocab_size, device="cpu")
    for s in (0, 5):
        assert torch.equal(stream.batch(s)["tokens"],
                           direct.batch(s)["tokens"])


def test_launcher_builds_hymba_and_takes_two_steps(tmp_path):
    """``launch.train.build`` gives the reduced hymba trainable with the LM
    step (``loss_kind`` "lm"); ``train_loop`` takes two steps on its stream
    with finite losses, every parameter moves, and the launcher's CLI runs
    it with ``--device cpu``."""
    cfg, model, opt_state, step, kind = tlaunch.build(
        ARCH, reduced=True, lr=1e-3, total_steps=20, device="cpu")
    assert kind == "lm" and cfg.family == "hybrid"
    assert all(p.requires_grad for p in model.parameters())
    stream = make_stream(cfg, DataConfig(global_batch=2, seq_len=40),
                         device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = []
    train_loop(step, model, opt_state, stream, 1,
               Checkpointer(str(tmp_path)),
               LoopConfig(total_steps=2, ckpt_every=100, log_every=1),
               metrics_cb=lambda s, m: losses.append(m["loss"]))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    losses = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "2", "--seq", "40", "--batch", "2"])
    assert len(losses) == 1 and np.isfinite(losses[0])
