"""The port's MoE blocks with expert parallelism over ``data`` on CPU gloo
groups, against the JAX package's ``shard_map`` path on fake devices: the
MoE sharding rules, ``forward_train`` (logits and aux) with ``use_ep`` on
meshes (data 2, model 1) and (data 2, model 2) with ``sp`` off and on,
the non-EP path on a mesh, the served tokens, and two sharded ZeRO-1
steps.

The rank bodies live in ``tests/torch_moe_cases.py`` (no JAX there).  One
``spawn_ranks`` per world size: 2 ranks on (2, 1), 4 on (2, 2) (the
forward cases, the engine and the steps).  JAX's side runs once, in one
subprocess with 32 fake devices: its rule tables for the full
``arctic-480b`` and ``kimi-k2-1t-a32b`` on (2, 4) and (2, 16), and the
reduced models (f32, ``use_kernel=False``) from the same trees (JAX's
init, every leaf moved by a numpy draw).  The forward cases: capacity
1.25 (assignments dropped), 8.0 (none dropped: there the EP path also
equals ``moe_local``), ``moe_chunk`` 12 (the last of 3 chunks padded with
zero tokens) and ``moe_fixed_capacity``.

Tolerances: logits within ``REL_L2`` (1e-5) relative L2, the aux within
``AUX_RTOL`` (1e-5) relative; the steps as
``tests/test_torch_lm_parallel_train.py`` holds them (loss and grad norm
1e-5 relative, every parameter within 1e-2 learning rates where JAX's
first moment is well above zero, every moment 1e-3 of its leaf's
largest).  Controls, each of which must miss: slots counted per expert
(not per destination rank); the global Switch loss (the non-EP path's)
against JAX's EP aux on (2, 1); the experts' gradients summed over
``data`` against JAX's step.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from conftest import REPO
from repro_torch.launch import mesh as tmesh
from test_torch_lm_parallel import _held_to_jax, _port_specs, rel_l2
from test_torch_lm_parallel_train import (COND, LOSS_RTOL, MOMENT_RTOL,
                                          NORM_RTOL, UPDATE_LR)

pytestmark = pytest.mark.distributed

REL_L2 = 1e-5
AUX_RTOL = 1e-5
NAMES = (cases.ARCH, cases.NARROW)
MESHES = ((2, 1), (2, 2))

JAX_CODE = r"""
import pickle
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.launch.specs import param_specs
from repro.models import transformer as jtf
from repro.optim import AdamWConfig, init_opt_state
from repro.parallel.sharding import opt_state_shardings, param_shardings
from repro.serve.engine import Request, ServingEngine
from repro.train import make_train_step
from repro.train.steps import jit_train_step
import torch_moe_cases as C

assert len(jax.devices()) == 32
with open(sys.argv[1], "rb") as f:
    trees, jcfgs = pickle.load(f)
out = {}

def flat(tree):
    return {jax.tree_util.keystr(p): tuple(
        e if not isinstance(e, list) else tuple(e) for e in s.spec)
        for p, s in jax.tree_util.tree_leaves_with_path(tree)}

for arch in ("arctic-480b", "kimi-k2-1t-a32b"):
    cfg = get_arch(arch)
    for shape in ((2, 4), (2, 16)):
        mesh = make_mesh(shape, ("data", "model"))
        par = jtf.ParallelCtx(mesh=mesh, model_parallel=shape[1],
                              use_ep=True)
        ps = param_specs(cfg, par)
        opt = {"m": ps, "v": ps,
               "step": jax.ShapeDtypeStruct((), jnp.int32)}
        key = f"{arch}/{shape}"
        out[f"rules/param/{key}"] = flat(param_shardings(cfg, mesh, ps, par))
        out[f"rules/opt/{key}"] = flat(opt_state_shardings(cfg, mesh, opt,
                                                           par))

toks = jnp.asarray(C.tokens(), jnp.int32)

def forward(jcfg, params, par):
    fn = jax.jit(lambda p, b: jtf.forward_train(
        jcfg, p, b, parallel=par, use_kernel=False)[:2])
    lg, aux = fn(params, {"tokens": toks})
    return np.asarray(lg), float(aux)

for name, jcfg in jcfgs.items():
    params = jax.tree.map(jnp.asarray, trees[name])
    out[f"local/{name}"] = forward(jcfg, params, jtf.LOCAL)
    for shape in ((2, 1), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"))
        for case, kw in C.cases_of(name).items():
            for sp in ((False, True) if shape[1] > 1 else (False,)):
                par = jtf.ParallelCtx(mesh=mesh, model_parallel=shape[1],
                                      use_ep=True, sp=sp, **kw)
                out[f"fwd/{shape}/{name}/{case}/sp{int(sp)}"] = forward(
                    jcfg, params, par)
        if name == C.ARCH:
            out[f"fwd/{shape}/noep"] = forward(
                jcfg, params, jtf.ParallelCtx(mesh=mesh,
                                              model_parallel=shape[1]))
            par = jtf.ParallelCtx(mesh=mesh, model_parallel=shape[1],
                                  use_ep=True)
            eng = ServingEngine(jcfg, params, batch_size=C.B,
                                max_seq=max(C.PROMPTS) + max(C.NEW),
                                parallel=par, use_kernel=False)
            out[f"serve/{shape}"] = eng.generate(
                [Request(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=k)
                 for p, k in C.requests()])

cfg = jcfgs[C.ARCH]
mesh = make_mesh((2, 2), ("data", "model"))
par = jtf.ParallelCtx(mesh=mesh, batch_axes=("data",), use_ep=True, sp=True,
                      model_parallel=2)
params = jax.tree.map(jnp.asarray, trees[C.ARCH])
opt = init_opt_state(params)
step = make_train_step(cfg, AdamWConfig(lr=C.STEP_LR), parallel=par,
                       loss_kind="lm", use_kernel=False)
p_sh = param_shardings(cfg, mesh, params, par)
o_sh = opt_state_shardings(cfg, mesh, opt, par)
params = jax.device_put(params, p_sh)
opt = jax.device_put(opt, o_sh)
step = jit_train_step(step, in_shardings=(p_sh, o_sh, None, None),
                      out_shardings=(p_sh, o_sh, None))
runs = []
for t in C.step_batches():
    b = {"tokens": jnp.asarray(t, jnp.int32),
         "labels": jnp.asarray(t, jnp.int32)}
    params, opt, m = step(params, opt, b, jax.random.PRNGKey(0))
    runs.append(dict(loss=float(m["loss"]), aux=float(m["aux"]),
                     grad_norm=float(m["grad_norm"]),
                     params=jax.tree.map(np.asarray, params),
                     opt=jax.tree.map(np.asarray, opt)))
out["steps"] = runs
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX MOE PARALLEL OK")
"""


def jax_cfg(name):
    """JAX's config of ``cases.cfg_of(name)``."""
    import dataclasses
    from repro.configs import get_arch as jget_arch
    pc = cases.cfg_of(name)
    base = jget_arch("kimi-k2-1t-a32b" if name == cases.NARROW else name)
    return dataclasses.replace(
        base.reduced(), name=pc.name, moe_experts=pc.moe_experts,
        moe_top_k=pc.moe_top_k, moe_dense_residual=pc.moe_dense_residual,
        act=pc.act)


def jax_trees():
    """JAX's init of every config, every leaf moved by a numpy draw:
    numpy f32 leaves (the heads and vocabulary pad alike at model 1 and
    2).  The init runs in 32-bit mode whatever other test modules set, so
    the trees (and which assignments capacity 1.25 drops) do not depend
    on the order the modules run in."""
    import jax
    from repro.models import transformer as jtf
    rng = np.random.default_rng(3)
    out = {}
    for name in NAMES:
        with jax.enable_x64(False):
            tree = jtf.init_params(jax_cfg(name), jax.random.PRNGKey(5),
                                   jtf.ParallelCtx(model_parallel=2))
        out[name] = jax.tree.map(
            lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
                x.shape).astype(np.float32)), tree)
    return out


class _JaxRun:
    def __init__(self, tmp):
        self.trees = jax_trees()
        src, self.dst = str(tmp / "trees.pkl"), str(tmp / "jax_out.pkl")
        with open(src, "wb") as f:
            pickle.dump((self.trees, {n: jax_cfg(n) for n in NAMES}), f)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=32",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"),
                        os.path.join(REPO, "tests")]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_CODE, src, self.dst],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self.out = None

    def get(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"stdout={out}\nstderr={err}"
            with open(self.dst, "rb") as f:
                self.out = pickle.load(f)
        return self.out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    run = _JaxRun(tmp_path_factory.mktemp("jax_moe"))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.fixture(scope="module")
def ranks(jax_run):
    """Every rank's results by mesh: 2 ranks on (2, 1) (started while JAX
    runs), then 4 on (2, 2) (their steps start from JAX's states)."""
    out = {(2, 1): tmesh.spawn_ranks(cases.forward_serve, 2, jax_run.trees,
                                     (2, 1), device_type="cpu")}
    steps = [dict(params=r["params"], opt=r["opt"])
             for r in jax_run.get()["steps"]]
    out[(2, 2)] = tmesh.spawn_ranks(cases.world4, 4, jax_run.trees, steps,
                                    device_type="cpu")
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4), (2, 16)])
@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_rules_match_jax(jax_run, arch, shape):
    """Every leaf's spec of the full MoE config (experts over ``data``,
    their width over ``model``, the router replicated) equals JAX's
    ``param_shardings`` and ``opt_state_shardings`` (ZeRO-1: an expert's
    moments keep its parameter's spec); read from a meta-device model."""
    cfg, mesh, par, shapes, sh = _port_specs(arch, shape)
    out = jax_run.get()
    key = f"{arch}/{shape}"
    specs = sh.param_shardings(cfg, mesh, shapes, par)
    _held_to_jax(specs, out[f"rules/param/{key}"])
    opt = sh.opt_state_shardings(cfg, mesh, {"m": shapes, "v": shapes}, par)
    jopt = out[f"rules/opt/{key}"]
    for k in ("m", "v"):
        _held_to_jax(opt[k], {p[len(f"['{k}']"):]: s for p, s in
                              jopt.items() if p.startswith(f"['{k}']")})
    for name, spec in specs.items():
        if ".moe." in name and not name.endswith("router"):
            assert spec[0] == "data" and opt["m"][name] == spec, name


# --------------------------------------------------------------------------
# the EP forward, the engine
# --------------------------------------------------------------------------

FWD = [(shape, name, case, sp) for shape in MESHES for name in NAMES
       for case in cases.cases_of(name)
       for sp in ((False, True) if shape[1] > 1 else (False,))]


@pytest.mark.parametrize("shape,name,case,sp", FWD,
                         ids=[f"{s[0]}x{s[1]}-{n}-{c}-sp{int(p)}"
                              for s, n, c, p in FWD])
def test_ep_forward_matches_jax_shard_map(ranks, jax_run, shape, name, case,
                                          sp):
    """``forward_train``'s logits and aux with ``use_ep`` against JAX's
    ``shard_map`` path on the same mesh; every rank holds the same
    gathered logits; at capacity 8.0 both equal JAX's ``moe_local``
    model; at 1.25 assignments are dropped (the logits move from 8.0's)."""
    key = f"fwd/{name}/{case}/sp{int(sp)}"
    got = [r[key] for r in ranks[shape]]
    lg, aux = got[0]
    for other, other_aux in got[1:]:
        assert np.array_equal(other, lg) and other_aux == aux
    jl, jaux = jax_run.get()[f"fwd/{shape}/{name}/{case}/sp{int(sp)}"]
    assert rel_l2(lg, jl, 256) <= REL_L2
    assert _rel(aux, jaux) <= AUX_RTOL
    if case == "cap8":
        local, _ = jax_run.get()[f"local/{name}"]
        assert rel_l2(lg, local, 256) <= REL_L2
    if case == "cap1.25" and name == cases.ARCH:
        full, _ = ranks[shape][0][f"fwd/{name}/cap8/sp{int(sp)}"]
        assert rel_l2(lg, full, 256) > 100 * REL_L2


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "2x2"])
def test_non_ep_mesh_path_and_controls(ranks, jax_run, shape):
    """Without ``use_ep`` each rank gathers the experts and runs
    ``moe_local`` on its tokens with the global Switch loss: JAX's GSPMD
    logits and aux.  Controls that miss: that global aux against JAX's EP
    aux (a mean of the shards' chunk losses); slots counted per expert
    against JAX's EP logits at capacity 1.25.  One forward issues 3
    all-to-alls a layer (rows and expert ids out, rows back; one chunk)."""
    r = ranks[shape][0]
    jout = jax_run.get()
    lg, aux = r["fwd/noep"]
    jl, jaux = jout[f"fwd/{shape}/noep"]
    assert rel_l2(lg, jl, 256) <= REL_L2
    assert _rel(aux, jaux) <= AUX_RTOL
    _, ep_aux = jout[f"fwd/{shape}/{cases.ARCH}/cap1.25/sp0"]
    assert _rel(aux, ep_aux) > 100 * AUX_RTOL
    ctrl, _ = r["ctrl/per_expert_pos"]
    want, _ = jout[f"fwd/{shape}/{cases.ARCH}/cap1.25/sp0"]
    assert rel_l2(ctrl, want, 256) > 100 * REL_L2
    assert r["a2a_calls"] == 3 * cases.cfg_of(cases.ARCH).num_layers


@pytest.mark.parametrize("shape", MESHES, ids=["2x1", "2x2"])
def test_ep_engine_tokens_match_jax(ranks, jax_run, shape):
    """The served tokens with ``use_ep`` (the prefill and every decode
    step through the EP block, 2 rows a data rank) equal JAX's engine
    on the same mesh, on every rank."""
    want = jax_run.get()[f"serve/{shape}"]
    for r in ranks[shape]:
        assert r["serve"] == want


# --------------------------------------------------------------------------
# the sharded step
# --------------------------------------------------------------------------

def _leaves(cfg, tree):
    from repro_torch.models.transformer import jax_leaf_names
    out = {}
    for name, path, layer in jax_leaf_names(cfg):
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        out[name] = np.asarray(leaf if layer is None else leaf[layer])
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_ep_sharded_step_matches_jax(ranks, jax_run, i):
    """Step ``i`` on (data 2, model 2) with ``use_ep``, ``sp`` and ZeRO-1,
    from JAX's state entering it: the loss, the aux, the grad norm, every
    parameter after AdamW and every gathered moment against JAX's jitted
    step; all four ranks agree bitwise."""
    cfg = cases.cfg_of(cases.ARCH)
    want = jax_run.get()["steps"][i]
    runs = [r["train"]["steps"][i] for r in ranks[(2, 2)]]
    got = runs[0]
    for r in runs[1:]:
        assert r["loss"] == got["loss"]
        assert all(np.array_equal(r["params"][k], got["params"][k])
                   for k in got["params"])
    assert _rel(got["loss"], want["loss"]) <= LOSS_RTOL
    assert _rel(got["aux"], want["aux"]) <= AUX_RTOL
    assert _rel(got["grad_norm"], want["grad_norm"]) <= NORM_RTOL
    wp = _leaves(cfg, want["params"])
    wm = _leaves(cfg, want["opt"]["m"])
    for k in wp:
        diff = np.abs(got["params"][k] - wp[k]) / cases.STEP_LR
        m = np.abs(wm[k])
        well = m >= COND * max(float(m.max()), 1e-30)
        assert float(diff.max()) <= 2.1, (k, float(diff.max()))
        assert float(diff[well].max(initial=0.0)) <= UPDATE_LR, k
    for key in ("m", "v"):
        wm = _leaves(cfg, want["opt"][key])
        for k in wm:
            scale = max(float(np.abs(wm[k]).max()), 1e-30)
            err = float(np.abs(got["mom"][key][k] - wm[k]).max()) / scale
            assert err <= MOMENT_RTOL, (key, k, err)


def test_experts_summed_over_data_miss_jax(ranks, jax_run):
    """The control of risk 1: the experts' gradients summed over ``data``
    as well (each rank adding the other's experts') miss JAX's grad norm
    and its updated experts, which the step meets."""
    cfg = cases.cfg_of(cases.ARCH)
    want = jax_run.get()["steps"][0]
    c = ranks[(2, 2)][0]["train"]["ctrl/summed"]
    assert _rel(c["grad_norm"], want["grad_norm"]) > 100 * NORM_RTOL
    wp = _leaves(cfg, want["params"])
    name = "blocks.0.moe.w_up"
    assert float(np.abs(c["params"][name] - wp[name]).max()) \
        / cases.STEP_LR > 10 * UPDATE_LR


# --------------------------------------------------------------------------
# world size 1
# --------------------------------------------------------------------------

def test_world_size_one_ep_is_the_local_path(tmp_path):
    """On a gloo group of one rank, mesh (data 1, model 1), the EP path
    (``use_ep``, capacity 1.25: at one rank no assignment is dropped)
    gives the local path's logits and aux; ``use_ep`` without a mesh runs
    ``moe_local``."""
    import torch.distributed as dist
    from repro_torch.models import transformer as tf
    tree = jax_trees()[cases.ARCH]
    cfg = cases.cfg_of(cases.ARCH)
    toks = torch.from_numpy(cases.tokens()).long()
    with torch.no_grad():
        plain = tf.load_jax_params(cfg, tree, device="cpu")
        want = cases.logits_and_aux(cfg, plain, {"tokens": toks})
        nomesh = tf.load_jax_params(cfg, tree, device="cpu",
                                    parallel=tf.ParallelCtx(use_ep=True))
        got0 = cases.logits_and_aux(cfg, nomesh, {"tokens": toks})
    assert torch.equal(got0[0], want[0]) and got0[1] == want[1]
    tmesh.init_process_group(str(tmp_path), 0, 1, device_type="cpu")
    try:
        mesh = tmesh.make_test_mesh((1, 1), device_type="cpu")
        model = tf.load_jax_params(cfg, tree, device="cpu",
                                   parallel=tf.ParallelCtx(mesh=mesh,
                                                           use_ep=True))
        with torch.no_grad():
            got = cases.logits_and_aux(cfg, model, {"tokens": toks})
    finally:
        dist.destroy_process_group()
    assert rel_l2(got[0], want[0]) <= 1e-6
    assert _rel(float(got[1]), float(want[1])) <= 1e-6


def _world_one_steps(cfg, tree, ctx=None, zero_router_grad=False):
    """Two steps of ``cases.step_batches`` from ``tree``: plain, or on
    ``ctx``'s mesh with ZeRO-1; each step's loss, aux and grad norm and
    every parameter after it.  ``zero_router_grad``: every router's
    gradient replaced by zeros (the control)."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import zero1_slices
    on = {} if ctx is None else dict(parallel=ctx)
    model = tf.load_jax_params(cfg, tree, device="cpu", trainable=True, **on)
    kw = {} if ctx is None else dict(zero1=zero1_slices(model))
    opt = init_opt_state(dict(model.named_parameters()), **kw)
    step = make_train_step(cfg, AdamWConfig(lr=cases.STEP_LR),
                           loss_kind="lm", **on)
    if zero_router_grad:
        for p in model.blocks:
            p["moe"]["router"].register_hook(torch.zeros_like)
    out = []
    for toks in cases.step_batches():
        t = torch.from_numpy(toks).long()
        model, opt, m = step(model, opt, {"tokens": t, "labels": t})
        out.append(([m[k].item() for k in ("loss", "aux", "grad_norm")],
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()}))
    return out


def _bitwise(a, b) -> bool:
    return all(ma == mb and all(torch.equal(pa[n], pb[n]) for n in pa)
               for (ma, pa), (mb, pb) in zip(a, b))


def test_world_size_one_ep_step_is_the_plain_step_bitwise(tmp_path):
    """On a gloo group of one rank, two steps through the launcher's
    context (``mesh_ctx``: ``use_ep``, ``sp``, ZeRO-1) give the plain
    step's loss, aux, grad norm and every parameter bitwise: at one
    ``model`` rank the router and the experts read one entry, so the
    normed input's gradient adds its parts in the plain path's order
    (ROADMAP C24).  The control, the plain step with the routers'
    gradients zeroed, misses the same check."""
    import torch.distributed as dist
    from repro_torch.launch.train import mesh_ctx
    tree = jax_trees()[cases.ARCH]
    cfg = cases.cfg_of(cases.ARCH)
    plain = _world_one_steps(cfg, tree)
    ctrl = _world_one_steps(cfg, tree, zero_router_grad=True)
    tmesh.init_process_group(str(tmp_path), 0, 1, device_type="cpu")
    try:
        mesh = tmesh.make_test_mesh((1, 1), device_type="cpu")
        got = _world_one_steps(cfg, tree, mesh_ctx(mesh, cfg))
    finally:
        dist.destroy_process_group()
    assert _bitwise(got, plain)
    assert not _bitwise(ctrl, plain)
