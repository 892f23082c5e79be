"""The port's sharded language-model training on CPU gloo groups, against
the JAX package: the tensor-, sequence- and data-parallel step with
ZeRO-1 (``train.steps.make_train_step(parallel=)``), the per-rank data
slices (``data.pipeline``), the multi-process checkpoint
(``checkpoint.Checkpointer(mesh=)``) and the mesh launcher
(``launch.train.build_on_mesh``, ``launch.mesh.make_production_mesh``).

The rank bodies live in ``tests/torch_lm_cases.py``.  One ``spawn_ranks``
of 4 ranks on a (data 2, model 2) mesh runs 3 steps of each reduced f32
config (``sp=True``, ZeRO-1, JAX's launcher context), each started from
JAX's state entering it, then the port's own 3 steps with a checkpoint
after the second, the data slices and the launcher's cases; one of 2
ranks on (data 1, model 2) restores that checkpoint and takes the third
step, then each arch's first step plain and with ``remat=True`` at both
policies (bitwise the plain step).  JAX's side runs in one subprocess
with 4 fake devices: its step jitted on a (2, 2) mesh with
``param_shardings`` and ``opt_state_shardings`` (``repro.launch.train``'s
placement), f32, ``use_kernel=False``, and qwen3's first step with
``remat=True`` at each policy.

Tolerances (each step from JAX's state entering it): the loss within
``LOSS_RTOL`` (1e-5) relative, the grad norm within ``NORM_RTOL`` (1e-5),
every gathered moment within ``MOMENT_RTOL`` (1e-3) of its leaf's largest
magnitude, and every parameter after AdamW within ``UPDATE_LR`` (1e-2)
learning rates where JAX's first moment is at least ``COND`` (1e-3) of
its leaf's largest, and within 2.1 learning rates everywhere: AdamW
divides each moment element by the root of the second, so where both are
near zero (an element whose gradient is near ``eps``, 1e-8) an
f32-rounding difference of the summed gradient moves the update by up to
2 learning rates (read 1.09 lr at one rwkv6 element of the first step;
the moments hold those elements).  The restore is bitwise; the step after it equals the
uninterrupted run's within 1e-6 (two meshes sum in two orders; read
3e-8).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from conftest import REPO
from repro_torch.launch import mesh as tmesh
from test_torch_lm_parallel import jax_cfg

pytestmark = pytest.mark.distributed

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
UPDATE_LR = 1e-2
COND = 1e-3
MOMENT_RTOL = 1e-3

JAX_CODE = r"""
import pickle
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.compat import make_mesh
from repro.models import transformer as jtf
from repro.optim import AdamWConfig, init_opt_state
from repro.parallel.sharding import opt_state_shardings, param_shardings
from repro.train import make_train_step
from repro.train.steps import jit_train_step
import torch_lm_cases as C

assert len(jax.devices()) == 4
with open(sys.argv[1], "rb") as f:
    trees, jcfgs = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"))
par = jtf.ParallelCtx(mesh=mesh, batch_axes=("data",), sp=True,
                      model_parallel=2)
out = {}
for name, cfg in jcfgs.items():
    params = jax.tree.map(jnp.asarray, trees[name])
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
    for toks in C.step_batches():
        b = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(toks, jnp.int32)}
        params, opt, m = step(params, opt, b, jax.random.PRNGKey(0))
        runs.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         params=jax.tree.map(np.asarray, params),
                         opt=jax.tree.map(np.asarray, opt)))
    out[name] = runs
# the first step from the tree with remat at each policy
cfg = jcfgs[C.STEP_ARCH]
for policy in ("dots", "nothing"):
    rpar = jtf.ParallelCtx(mesh=mesh, batch_axes=("data",), sp=True,
                           model_parallel=2, remat_policy=policy)
    params = jax.tree.map(jnp.asarray, trees[C.STEP_ARCH])
    opt = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=C.STEP_LR), parallel=rpar,
                           remat=True, loss_kind="lm", use_kernel=False)
    p_sh = param_shardings(cfg, mesh, params, rpar)
    o_sh = opt_state_shardings(cfg, mesh, opt, rpar)
    step = jit_train_step(step, in_shardings=(p_sh, o_sh, None, None),
                          out_shardings=(p_sh, o_sh, None))
    toks = C.step_batches()[0]
    b = {"tokens": jnp.asarray(toks, jnp.int32),
         "labels": jnp.asarray(toks, jnp.int32)}
    params, opt, m = step(jax.device_put(params, p_sh),
                          jax.device_put(opt, o_sh), b,
                          jax.random.PRNGKey(0))
    out[f"remat/{policy}"] = dict(loss=float(m["loss"]),
                                  grad_norm=float(m["grad_norm"]),
                                  params=jax.tree.map(np.asarray, params),
                                  opt=jax.tree.map(np.asarray, opt))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX LM TRAIN OK")
"""


def jax_trees():
    import jax
    from repro.models import transformer as jtf
    rng = np.random.default_rng(2)
    out = {}
    for name in cases.STEP_ARCHS:
        tree = jtf.init_params(jax_cfg(name), jax.random.PRNGKey(4),
                               jtf.ParallelCtx(model_parallel=cases.M))
        out[name] = jax.tree.map(
            lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
                x.shape).astype(np.float32)), tree)
    return out


class _JaxRun:
    def __init__(self, tmp):
        self.trees = jax_trees()
        src, self.dst = str(tmp / "trees.pkl"), str(tmp / "jax_out.pkl")
        with open(src, "wb") as f:
            pickle.dump((self.trees, {n: jax_cfg(n)
                                      for n in cases.STEP_ARCHS}), f)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
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
    run = _JaxRun(tmp_path_factory.mktemp("jax_lm_train"))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lm_ckpt"))


@pytest.fixture(scope="module")
def world4(jax_run, ckpt_dir):
    return tmesh.spawn_ranks(cases.train4, 4, jax_run.trees, jax_run.get(),
                             ckpt_dir, device_type="cpu")


@pytest.fixture(scope="module")
def world2(jax_run, world4, ckpt_dir):
    return tmesh.spawn_ranks(cases.train2, 2, jax_run.trees, ckpt_dir,
                             device_type="cpu")


def _leaves(cfg, tree):
    """``{port name: numpy leaf}`` of a JAX-layout tree."""
    from repro_torch.models.transformer import jax_leaf_names
    out = {}
    for name, path, layer in jax_leaf_names(cfg):
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        out[name] = np.asarray(leaf if layer is None else leaf[layer])
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("i", [0, 1, 2])
@pytest.mark.parametrize("name", cases.STEP_ARCHS)
def test_sharded_step_matches_jax(world4, jax_run, name, i):
    """Step ``i`` on (data 2, model 2) with ``sp`` and ZeRO-1, from JAX's
    state entering it: the loss, the grad norm, every parameter after
    AdamW and every gathered moment against JAX's jitted GSPMD step; all
    four ranks agree bitwise."""
    cfg = cases.cfg_of(name)
    want = jax_run.get()[name][i]
    runs = [r[f"steps/{name}"][i] for r in world4]
    got = runs[0]
    for r in runs[1:]:
        assert r["loss"] == got["loss"]
        assert all(np.array_equal(r["params"][k], got["params"][k])
                   for k in got["params"])
    _close_to_jax(cfg, got, want)


def _close_to_jax(cfg, got, want):
    """A port step's loss, grad norm, parameters and gathered moments
    within the module's tolerances of JAX's."""
    assert _rel(got["loss"], want["loss"]) <= LOSS_RTOL
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


@pytest.mark.parametrize("name", cases.STEP_ARCHS)
def test_remat_sharded_step_is_the_plain_step(world2, jax_run, name):
    """The first step on (data 1, model 2) with ``sp`` and ZeRO-1 from
    JAX's tree, with ``remat`` at ``"dots"`` and ``"nothing"``: bitwise
    the plain step on both ranks (loss, grad norm, every parameter and
    moment), and for qwen3 within the module's tolerances of JAX's
    jitted ``remat=True`` step at the same policy."""
    cfg = cases.cfg_of(name)
    for r in world2:
        plain = r[f"remat/{name}/0/dots"]
        for policy in ("dots", "nothing"):
            got = r[f"remat/{name}/1/{policy}"]
            assert got["loss"] == plain["loss"]
            assert got["grad_norm"] == plain["grad_norm"]
            assert all(np.array_equal(got["params"][k], plain["params"][k])
                       for k in plain["params"])
            assert all(np.array_equal(got["mom"][a][k], plain["mom"][a][k])
                       for a in plain["mom"] for k in plain["mom"][a])
            if name == cases.STEP_ARCH:
                _close_to_jax(cfg, got, jax_run.get()[f"remat/{policy}"])


@pytest.mark.parametrize("name", cases.STEP_ARCHS)
def test_step_controls_miss(world4, jax_run, name):
    """The loss as the mean of the data ranks' own means with unequal
    valid counts misses the global ``sum / count`` the step uses, and a
    grad norm counting the leaves replicated over ``model`` once a rank
    misses JAX's grad norm, which the port's meets."""
    c = world4[0][f"ctrl/{name}"]
    assert _rel(c["loss_per_rank"], c["loss_global"]) > 10 * LOSS_RTOL
    jnorm = jax_run.get()[name][0]["grad_norm"]
    assert _rel(c["norm"], jnorm) <= NORM_RTOL
    assert _rel(c["norm_m_times"], jnorm) > 10 * NORM_RTOL


def test_data_slices_concatenate_to_the_one_host_batch(world4):
    """The data ranks' slices of ``LMStream.batch``, concatenated in
    their order, are the one-host batch bit for bit (the two model ranks
    of a data rank hold the same rows); a slice alone is not."""
    from repro_torch.data import DataConfig, make_stream
    whole = make_stream(cases.cfg_of(cases.STEP_ARCH),
                        DataConfig(global_batch=cases.B,
                                   seq_len=cases.STEP_SEQ),
                        device="cpu").batch(3)["tokens"].numpy()
    by_rank = {}
    for r in world4:
        d, rows = r["data"]
        if d in by_rank:
            assert np.array_equal(by_rank[d], rows)
        by_rank[d] = rows
    joined = np.concatenate([by_rank[d] for d in sorted(by_rank)])
    assert np.array_equal(joined, whole)
    assert by_rank[0].shape[0] == cases.B // 2
    assert not np.array_equal(by_rank[0], whole[cases.B // 2:])


def test_checkpoint_restores_on_another_mesh(world4, world2):
    """Saved on (data 2, model 2) as four ``host<k>.npz`` of whole leaves,
    restored on (data 1, model 2): every parameter and moment bitwise,
    and the third step from it equals the uninterrupted run's within
    1e-6 (the two meshes sum the gradient in two orders)."""
    sp, sm = world4[0]["saved"]
    for r in world2:
        assert r["step"] == 2
        rp, rm = r["restored"]
        assert all(np.array_equal(sp[k], rp[k]) for k in sp)
        assert all(np.array_equal(sm[a][k], rm[a][k]) for a in sm
                   for k in sm[a])
    up, _ = world4[0]["uninterrupted"]
    nxt, _ = world2[0]["next"]
    assert max(float(np.abs(up[k] - nxt[k]).max()) for k in up) <= 1e-6
    assert not all(np.array_equal(up[k], sp[k]) for k in up)


def test_checkpoint_layout(world4, ckpt_dir):
    """JAX's multi-process layout: one ``host<k>.npz`` a rank, the
    manifest's ``hosts`` the world size, no marks or temporary
    directories left."""
    import json
    d = os.path.join(ckpt_dir, "step_2")
    assert sorted(os.listdir(d)) == ["host0.npz", "host1.npz", "host2.npz",
                                     "host3.npz", "manifest.json"]
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["hosts"] == 4
    assert not [p for p in os.listdir(ckpt_dir) if p.endswith(".tmp")]


def test_production_mesh_and_pod_build_name_their_ranks(world4):
    """On 4 ranks ``make_production_mesh`` and ``build(mesh_kind="pod1")``
    raise a clear error naming the 256 ranks the mesh needs (no
    ``NotImplementedError``)."""
    for err in world4[0]["errors"]:
        assert err is not None and "needs 256 ranks" in err, err
        assert "default group has 4" in err


def test_mesh_ctx_is_jax_launchers(world4):
    """``build``'s mesh part takes JAX's launcher context: batch over
    ``("data",)`` (``("pod", "data")`` with a pod dim), ``sp``, the
    model-parallel degree the ``model`` dim's size, no expert
    parallelism, no FSDP."""
    from repro_torch.launch.mesh import production_shape
    assert world4[0]["ctx"] == dict(batch_axes=("data",), sp=True,
                                    model_parallel=2, use_ep=False,
                                    fsdp=False)
    assert production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    assert production_shape(False) == ((16, 16), ("data", "model"))


# --------------------------------------------------------------------------
# world size 1: the sharded step is the plain step, bitwise
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    import torch.distributed as dist
    tmesh.init_process_group(str(tmp_path_factory.mktemp("store11t")), 0,
                             1, device_type="cpu")
    try:
        yield tmesh.make_test_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", cases.STEP_ARCHS)
def test_world_one_step_equals_plain_bitwise(mesh11, name):
    """Two steps of the sharded step at a (1, 1) mesh (``sp``, ZeRO-1,
    every collective issued) equal the plain step's bitwise: the loss,
    the grad norm, every parameter and moment; the plain step from an
    embedding moved by one ulp (the control) does not reach the same loss
    and grad norm."""
    from repro_torch.launch.train import build_on_mesh
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.models import transformer as tf
    cfg, sharded, s_opt, _, _ = build_on_mesh(name, mesh11, reduced=True,
                                              device="cpu")
    with torch.no_grad():
        plain = tf.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu", trainable=True)
        ctrl = tf.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu", trainable=True)
        for a, b in zip(sharded.parameters(), plain.parameters()):
            assert a.shape == b.shape
            b.copy_(a)
            b.requires_grad_(True)
        for a, b in zip(plain.parameters(), ctrl.parameters()):
            b.copy_(a)
        w = ctrl["embed"]["table"]
        w.copy_(torch.nextafter(w, torch.full_like(w, np.inf)))
    opt_cfg = AdamWConfig(lr=3e-4, schedule=None)
    s_step = make_train_step(cfg, opt_cfg, loss_kind="lm",
                             parallel=sharded.parallel)
    p_step = make_train_step(cfg, opt_cfg, loss_kind="lm")
    p_opt = init_opt_state(dict(plain.named_parameters()))
    c_opt = init_opt_state(dict(ctrl.named_parameters()))
    for toks in cases.step_batches(2):
        t = torch.from_numpy(toks).long()
        b = {"tokens": t, "labels": t}
        _, s_opt, sm = s_step(sharded, s_opt, b)
        _, p_opt, pm = p_step(plain, p_opt, b)
        _, c_opt, cm = p_step(ctrl, c_opt, b)
        assert torch.equal(sm["loss"], pm["loss"])
        assert torch.equal(sm["grad_norm"], pm["grad_norm"])
    for (n, a), b, c in zip(sharded.named_parameters(), plain.parameters(),
                            ctrl.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(s_opt["m"][n], p_opt["m"][n]), n
        assert torch.equal(s_opt["v"][n], p_opt["v"][n]), n
    assert not (torch.equal(cm["loss"], pm["loss"])
                and torch.equal(cm["grad_norm"], pm["grad_norm"]))


def test_sharded_step_raises_for_remat_and_dit():
    """``make_train_step(remat=True)`` builds a step that trains: its
    third step's loss on a repeated batch is below its first; the
    sharded step trains the language models only."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = cases.cfg_of(cases.STEP_ARCH)
    step = make_train_step(cfg, AdamWConfig(lr=cases.STEP_LR),
                           loss_kind="lm", remat=True)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", trainable=True)
    opt = init_opt_state(dict(model.named_parameters()))
    t = torch.from_numpy(cases.step_batches(1)[0]).long()
    losses = []
    for _ in range(3):
        model, opt, m = step(model, opt, {"tokens": t, "labels": t})
        losses.append(float(m["loss"]))
    assert losses[2] < losses[0], losses
    with pytest.raises(ValueError, match="language models"):
        make_train_step(get_arch("srds-dit-cifar"), AdamWConfig(),
                        loss_kind="diffusion",
                        parallel=ParallelCtx(mesh=object()))
    assert dataclasses.is_dataclass(ParallelCtx)


def test_init_process_group_from_torchrun_environment(tmp_path):
    """Without a store directory ``init_process_group`` starts from
    torchrun's environment (``env://``: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``): one gloo rank on this host in a
    fresh process, its (1, 1) mesh built; without ``RANK`` it raises
    (the control)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch.mesh import init_process_group, "
            "make_test_mesh\n"
            "print(init_process_group(device_type='cpu'))\n"
            "print(tuple(make_test_mesh((1, 1), device_type='cpu')"
            ".mesh_dim_names))\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["gloo", "('data',", "'model')"]
    env.pop("RANK")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "RANK" in r.stderr
