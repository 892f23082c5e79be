"""Rematerialization of the port's LM train step (``remat=True``, JAX's
``jax.checkpoint`` of the layer body) on the CPU: each family (dense
``qwen3-8b``, MoE ``arctic-480b``, ``rwkv6-1.6b``, ``hymba-1.5b``; the
reduced f32 configs of ``tests/torch_lm_cases.py`` and
``tests/torch_moe_cases.py``) at ``remat_policy`` ``"dots"`` and
``"nothing"``.

* Within the port, bitwise: the loss and every gradient with remat are
  those without it, and so are a step of ``make_train_step`` and of
  ``make_dp_train_step_compressed(remat=True)`` on a gloo group of one
  rank, and two of ``launch.train.build(remat=True)``'s step; one block
  weight moved by one ulp (the control) misses.
* Across frameworks: the remat loss and gradients against JAX's
  ``jax.value_and_grad(lm_loss(..., remat=True))`` at the same policy,
  on JAX's init moved by a numpy draw and carried by
  ``load_jax_params``, within the LM training tests' f32 tolerances
  (loss 1e-5 relative, each gradient 1e-4 relative L2;
  ``tests/test_torch_lm_train.py``).
* That remat runs, and under which policy: a ``TorchDispatchMode``
  counts the backward's ``aten.mm`` calls.  Without remat the backward
  runs two a forward ``mm`` (the gradients of input and weight); under
  ``"dots"`` the same (no projection recomputed); under ``"nothing"``
  the blocks' forward ``mm`` calls on top, every one with torch's early
  stop of the recompute off, and with it on (the default) at most one a
  layer fewer (a layer's last projection, whose output no backward
  reads).  The kernels' plain twins (``ref.attention``,
  ``ref.rwkv6_wkv``, ``ref.selective_scan``) run 2L times a step under
  either policy and L without remat.
"""
import collections
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_lm_cases as lc
import torch_moe_cases as mc
from repro.models import transformer as jtf
from repro.train import losses as jlosses
from repro_torch.kernels import ref
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import (init_error_feedback, lm_loss,
                               make_dp_train_step_compressed,
                               make_train_step)
from test_torch_lm_parallel import jax_cfg as lm_jax_cfg
from test_torch_moe_parallel import jax_cfg as moe_jax_cfg

FAMILIES = ("qwen3-8b", mc.ARCH, "rwkv6-1.6b", "hymba-1.5b")
POLICIES = ("dots", "nothing")
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
# the plain twin of each family's kernels: 2L calls a step with remat
TWINS = {"qwen3-8b": ("attention",), mc.ARCH: ("attention",),
         "rwkv6-1.6b": ("rwkv6_wkv",),
         "hymba-1.5b": ("attention", "selective_scan")}
MM = torch.ops.aten.mm.default


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small ops: under
    pytest-xdist every worker's default pool (a thread a core) shares the
    host's cores, and this module took 218 s under six workers, 48 s
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    if name == mc.ARCH:
        return moe_jax_cfg(name), mc.cfg_of(name)
    return lm_jax_cfg(name), lc.cfg_of(name)


def _tree(name, seed=5):
    """JAX's init (model parallel 1) with every leaf moved by 0.05 x a
    numpy draw, in 32-bit mode: numpy f32 leaves."""
    jcfg, _ = _cfgs(name)
    rng = np.random.default_rng(seed)
    with jax.enable_x64(False):
        tree = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.asarray(x, np.float32) + 0.05
                        * rng.standard_normal(x.shape).astype(np.float32),
                        tree)


def _model(name, tree=None, policy="dots"):
    _, cfg = _cfgs(name)
    return cfg, tf.load_jax_params(cfg, _tree(name) if tree is None
                                   else tree, device="cpu", trainable=True,
                                   parallel=tf.ParallelCtx(
                                       remat_policy=policy))


def _batch(seed=1):
    t = torch.from_numpy(lc.tokens(seed=seed)).long()
    return {"tokens": t, "labels": t}


def _loss_and_grads(cfg, model, batch, remat, policy="dots"):
    params = list(model.parameters())
    loss, metrics = lm_loss(cfg, model, batch, remat=remat,
                            parallel=tf.ParallelCtx(remat_policy=policy))
    return loss, metrics, torch.autograd.grad(loss, params)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def _plain(name):
    """The no-remat loss, metrics and gradients of ``name`` (computed once
    for both policies' tests)."""
    cfg, model = _model(name)
    return _loss_and_grads(cfg, model, _batch(), False)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] += 1
        return func(*args, **(kwargs or {}))


# --------------------------------------------------------------------------
# within the port: bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_loss_and_grads_are_bitwise_the_plain_ones(name, policy):
    """The loss, the metrics and every parameter's gradient with remat
    equal those without it, bitwise; with one weight of the first block
    moved by one ulp (the control) the remat run misses them."""
    cfg, model = _model(name)
    batch = _batch()
    loss, metrics, grads = _plain(name)
    r_loss, r_metrics, r_grads = _loss_and_grads(cfg, model, batch, True,
                                                 policy)
    assert torch.equal(r_loss, loss)
    assert all(torch.equal(r_metrics[k], metrics[k]) for k in metrics)
    assert len(r_grads) == len(grads) and _same(r_grads, grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
    leaf = "ln1" if cfg.block == "rwkv6" else "attn"
    w = model.blocks[0][leaf]["scale" if leaf == "ln1" else "wq"]
    with torch.no_grad():
        w.copy_(torch.nextafter(w, torch.full_like(w, np.inf)))
    c_loss, _, c_grads = _loss_and_grads(cfg, model, batch, True, policy)
    assert not (torch.equal(c_loss, loss) and _same(c_grads, grads))


@functools.lru_cache(maxsize=None)
def _plain_step(name):
    """One plain ``make_train_step`` step of ``name`` from its tree."""
    return _train_step(name, False, "dots")


def _train_step(name, remat, policy):
    cfg, model = _model(name)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(lr=3e-3), loss_kind="lm",
                           parallel=tf.ParallelCtx(remat_policy=policy),
                           remat=remat)
    model, opt, m = step(model, opt, _batch())
    return list(model.parameters()), opt, m


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_train_steps_are_bitwise_the_plain_steps(name, policy):
    """An AdamW step of ``make_train_step(remat=True)`` under the policy's
    context equals the plain step from the same state: every parameter,
    moment and metric, bitwise."""
    p, o, m = _plain_step(name)
    rp, ro, rm = _train_step(name, True, policy)
    assert _same(rp, p)
    assert all(_same(ro[k].values(), o[k].values()) for k in ("m", "v"))
    assert m.keys() == rm.keys()
    assert all(torch.equal(torch.as_tensor(rm[k]), torch.as_tensor(m[k]))
               for k in m)


def test_build_remat_step_is_the_plain_step():
    """``launch.train.build(remat=True)`` (the default ``"dots"``) trains
    the reduced LM as ``build()`` does, bitwise over two steps."""
    from repro_torch.launch.train import build
    out = []
    for remat in (False, True):
        cfg, model, opt, step, kind = build("qwen3-8b", reduced=True,
                                            device="cpu", remat=remat)
        assert kind == "lm"
        for seed in (1, 2):
            t = torch.from_numpy(lc.tokens(seed=seed, s=24)).long()
            model, opt, m = step(model, opt, {"tokens": t, "labels": t})
        out.append((list(model.parameters()), m["loss"]))
    assert torch.equal(out[0][1], out[1][1]) and _same(out[0][0], out[1][0])


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    tmesh.init_process_group(str(tmp_path_factory.mktemp("store_remat")), 0,
                             1, device_type="cpu")
    try:
        yield tmesh.make_srds_mesh(1, 1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _dp_step(mesh, name, remat, policy):
    cfg, model = _model(name, policy=policy)
    opt = init_opt_state(dict(model.named_parameters()))
    ef = init_error_feedback(model)
    step = make_dp_train_step_compressed(
        cfg, AdamWConfig(lr=3e-3), mesh, "data", loss_kind="lm",
        remat=remat)
    model, opt, ef, m = step(model, opt, ef, _batch())
    return list(model.parameters()), opt, ef, m


@pytest.mark.distributed
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_compressed_dp_step_is_bitwise_the_plain_one(mesh1, name,
                                                           policy):
    """``make_dp_train_step_compressed(remat=True)`` on a gloo group of
    one rank (the int8 error-feedback mean issued), the policy the
    model's: a step bitwise the plain compressed step's parameters,
    moments, carry and metrics."""
    if name not in _DP_PLAIN:
        _DP_PLAIN[name] = _dp_step(mesh1, name, False, "dots")
    p, o, e, m = _DP_PLAIN[name]
    rp, ro, re_, rm = _dp_step(mesh1, name, True, policy)
    assert _same(rp, p) and _same(re_.values(), e.values())
    assert all(_same(ro[k].values(), o[k].values()) for k in ("m", "v"))
    assert all(torch.equal(rm[k], m[k]) for k in ("loss", "ce", "aux"))


# the plain compressed step of each family, on the module's mesh
_DP_PLAIN = {}


# --------------------------------------------------------------------------
# against JAX's remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_loss_and_grads_match_jax(name, policy):
    """The port's remat loss and every gradient against JAX's
    ``jax.value_and_grad`` of ``lm_loss(..., remat=True)`` with the same
    ``remat_policy`` (plain path, ``use_kernel=False``)."""
    jcfg, cfg = _cfgs(name)
    tree = _tree(name)
    batch = _batch()
    jb = {k: jax.numpy.asarray(v.numpy(), jax.numpy.int32)
          for k, v in batch.items()}
    jpar = jtf.ParallelCtx(remat_policy=policy)
    with jax.enable_x64(False):
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jlosses.lm_loss(jcfg, p, jb, parallel=jpar,
                                      remat=True, use_kernel=False),
            has_aux=True))(jax.tree.map(jax.numpy.asarray, tree))
    _, model = _model(name, tree)
    loss, metrics, grads = _loss_and_grads(cfg, model, batch, True, policy)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert metrics["aux"].item() == pytest.approx(float(jm["aux"]),
                                                  rel=LOSS_RTOL, abs=1e-7)
    grads = dict(zip(dict(model.named_parameters()), grads))
    for port_name, path, layer in tf.jax_leaf_names(cfg):
        want = jgrads
        for part in path.split("/"):
            want = want[part]
        want = np.asarray(want, np.float64)
        if layer is not None:
            want = want[layer]
        got = grads[port_name].double().numpy()
        scale = max(np.linalg.norm(want), 1e-30)
        assert np.linalg.norm(got - want) / scale <= GRAD_REL_L2, port_name


# --------------------------------------------------------------------------
# that remat runs, and under which policy
# --------------------------------------------------------------------------

def _block_mm(cfg, model, batch) -> int:
    """The ``aten.mm`` calls of one forward of the blocks."""
    count = _Counter()
    with count:
        tf.forward_hidden(cfg, model, batch)
    return count.calls[MM]


def _backward_mm(cfg, model, batch, remat, policy="dots", early=True):
    """``(forward mm, backward mm, the twins' calls)`` of one loss and
    gradient."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    fwd, bwd = _Counter(), _Counter()
    twins = collections.Counter()
    real = {n: getattr(ref, n) for n in ("attention", "rwkv6_wkv",
                                         "selective_scan")}

    def counted(n):
        def fn(*a, **k):
            twins[n] += 1
            return real[n](*a, **k)
        return fn

    for n in real:
        setattr(ref, n, counted(n))
    try:
        # the checkpoint reads the early stop when it runs the forward
        with set_checkpoint_early_stop(early), fwd:
            loss, _ = lm_loss(cfg, model, batch, remat=remat,
                              parallel=tf.ParallelCtx(remat_policy=policy))
        with bwd:
            torch.autograd.grad(loss, list(model.parameters()))
    finally:
        for n, fn in real.items():
            setattr(ref, n, fn)
    return fwd.calls[MM], bwd.calls[MM], twins


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_recomputes_what_its_policy_says(name):
    """Backward ``aten.mm`` calls: two a forward ``mm`` without remat and
    under ``"dots"``; under ``"nothing"`` the blocks' forward ``mm``
    calls on top (all of them without the early stop; with it, at most
    one a layer fewer).  The plain twins run 2L times a step under
    either policy, L times without remat."""
    cfg, model = _model(name)
    batch = _batch()
    blocks = _block_mm(cfg, model, batch)
    assert blocks >= 4 * cfg.num_layers
    n = cfg.num_layers
    fwd, plain, twins = _backward_mm(cfg, model, batch, False)
    assert plain == 2 * fwd and fwd > blocks
    assert twins == {t: n for t in TWINS[name]}
    f, b, twins = _backward_mm(cfg, model, batch, True, "dots")
    assert (f, b) == (fwd, plain)
    assert twins == {t: 2 * n for t in TWINS[name]}
    _, full, twins = _backward_mm(cfg, model, batch, True, "nothing",
                                  early=False)
    assert full - plain == blocks
    assert twins == {t: 2 * n for t in TWINS[name]}
    _, early, twins = _backward_mm(cfg, model, batch, True, "nothing")
    assert blocks - n <= early - plain <= blocks
    assert twins == {t: 2 * n for t in TWINS[name]}
