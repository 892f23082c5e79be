"""FSDP execution of the port's language models (``ParallelCtx(fsdp=True)``)
on CPU gloo groups, against the plain sharded step, against the JAX
package, and the dry run's collectives against a real run.

One ``spawn_ranks`` of 4 ranks (``tests/torch_lm_cases.py::fsdp4``) runs,
on (data 2, model 2) and (data 4, model 1), the first step of each
reduced f32 config from JAX's tree with and without FSDP, with ``remat``
off and at ``"dots"``, the control step (the sharded gradients also
all-reduced over ``data``), the prefill and decode logits of both models,
and on (2, 2) the dry run's train cell on real tensors, whose collectives
it records at rank 0.  One JAX subprocess with 4 fake devices runs JAX's
jitted ``make_train_step`` with ``param_shardings(..., fsdp=True)`` on
both meshes; one port subprocess runs the dry run of the same cell on a
fake (2, 2) group.

Tolerances: the FSDP step against the plain sharded step within
``FSDP_RTOL`` (1e-6) relative (the loss and grad norm; every gathered
moment, and every parameter where its first moment is at least ``COND``
of its leaf's largest, against the leaf's largest magnitude; every
parameter within 2.1 learning rates): the two sum a leaf's gradient over
``data`` by a reduce-scatter and by an all-reduce, and its norm over
shards, so the last bits may move, and AdamW divides each first moment
by the root of the second, so where both are near zero a last-bit
difference of the summed gradient moves the update by up to two
learning rates (``tests/test_torch_lm_parallel_train.py``'s rule; read
2.9e-7 over all elements on one draw of the trees, 1.46e-6 at one
rwkv6 element on another, 7.4e-8 where well conditioned); against JAX
the tolerances of ``tests/test_torch_lm_parallel_train.py``.  The decode
logits within ``FSDP_RTOL`` of the plain model's (read: 0 on (4, 1), a
few f32 ulps on (2, 2), where a gathered weight is a new buffer under the
same CPU product).  At world size 1 the FSDP step is the plain step
bitwise.
"""
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
from test_torch_lm_parallel_train import COND, _close_to_jax, _rel, jax_trees

pytestmark = pytest.mark.distributed

FSDP_RTOL = 1e-6

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
out = {}
for shape in C.FSDP_MESHES:
    mesh = make_mesh(shape, ("data", "model"))
    par = jtf.ParallelCtx(mesh=mesh, batch_axes=("data",), sp=True,
                          model_parallel=shape[1], fsdp=True)
    for name, cfg in jcfgs.items():
        params = jax.tree.map(jnp.asarray, trees[name])
        opt = init_opt_state(params)
        step = make_train_step(cfg, AdamWConfig(lr=C.STEP_LR), parallel=par,
                               loss_kind="lm", use_kernel=False)
        p_sh = param_shardings(cfg, mesh, params, par, fsdp=True)
        o_sh = opt_state_shardings(cfg, mesh, opt, par)
        step = jit_train_step(step, in_shardings=(p_sh, o_sh, None, None),
                              out_shardings=(p_sh, o_sh, None))
        toks = C.step_batches()[0]
        b = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(toks, jnp.int32)}
        params, opt, m = step(jax.device_put(params, p_sh),
                              jax.device_put(opt, o_sh), b,
                              jax.random.PRNGKey(0))
        out[(shape, name)] = dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            params=jax.tree.map(np.asarray, params),
            opt=jax.tree.map(np.asarray, opt),
            shards={"/".join(str(getattr(k, "key", k)) for k in path):
                    tuple(s.shard_shape(x.shape))
                    for (path, s), x in zip(
                        jax.tree_util.tree_flatten_with_path(p_sh)[0],
                        jax.tree.leaves(params))})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX FSDP OK")
"""

DRYRUN_CODE = r"""
import pickle
import sys
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
import torch_lm_cases as C
cfg = C.cfg_of(C.STEP_ARCH)
cell = ShapeConfig("cell", C.COLL_SHAPE[1], C.COLL_SHAPE[0], "train")
out = {fsdp: dryrun.dry_run(cfg, "cell", cell, "2x2", {"fsdp": fsdp})
       for fsdp in (False, True)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("DRYRUN OK")
"""


def _env(devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


class _Sub:
    """A subprocess started at once and read on first use."""

    def __init__(self, code, args, dst, devices=None):
        self.dst = dst
        self.proc = subprocess.Popen([sys.executable, "-c", code, *args],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=_env(devices))
        self.out = None

    def get(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"stdout={out}\nstderr={err}"
            with open(self.dst, "rb") as f:
                self.out = pickle.load(f)
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the world-one steps' small ops (under
    pytest-xdist every worker's default pool shares the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    # drawn under x32: other modules on a worker turn x64 on process-wide
    import jax
    with jax.enable_x64(False):
        return jax_trees()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, trees):
    tmp = tmp_path_factory.mktemp("jax_fsdp")
    src = str(tmp / "trees.pkl")
    with open(src, "wb") as f:
        pickle.dump((trees, {n: jax_cfg(n) for n in cases.FSDP_ARCHS}), f)
    dst = str(tmp / "out.pkl")
    run = _Sub(JAX_CODE, [src, dst], dst, devices=4)
    yield run
    run.close()


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("dry_fsdp") / "out.pkl")
    run = _Sub(DRYRUN_CODE, [dst], dst)
    yield run
    run.close()


@pytest.fixture(scope="module")
def world4(trees, jax_run, dry):
    return tmesh.spawn_ranks(cases.fsdp4, 4, trees, device_type="cpu")[0]


def _state_close(got, want, rtol):
    assert _rel(got["loss"], want["loss"]) <= rtol
    assert _rel(got["grad_norm"], want["grad_norm"]) <= rtol
    for k, w in want["params"].items():
        scale = max(float(np.abs(w).max()), 1e-30)
        diff = np.abs(got["params"][k] - w)
        m = np.abs(want["mom"]["m"][k])
        well = m >= COND * max(float(m.max()), 1e-30)
        assert float(diff[well].max(initial=0.0)) <= rtol * scale, k
        assert float(diff.max()) <= 2.1 * cases.STEP_LR, k
    for a in ("m", "v"):
        for k, w in want["mom"][a].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(got["mom"][a][k] - w).max())
            assert err <= rtol * scale, (a, k, err / scale)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("shape", cases.FSDP_MESHES, ids=str)
@pytest.mark.parametrize("name", cases.FSDP_ARCHS)
def test_fsdp_step_is_the_sharded_step(world4, name, shape, remat):
    """The FSDP step (each rank its ``data`` shard, gathered a layer at a
    time, updated in place) against the plain sharded step (ZeRO-1) on
    the same mesh: the loss, the grad norm, every gathered parameter and
    moment within the module's tolerances; ``remat`` at ``"dots"`` the
    same."""
    _state_close(world4[(shape, name, remat, True)],
                 world4[(shape, name, remat, False)], FSDP_RTOL)


@pytest.mark.parametrize("shape", cases.FSDP_MESHES, ids=str)
@pytest.mark.parametrize("name", cases.FSDP_ARCHS)
def test_fsdp_step_matches_jax(world4, jax_run, name, shape):
    """The FSDP step against JAX's jitted step with ``fsdp=True``
    shardings on the same mesh, numpy tree and batch (the tolerances of
    ``test_torch_lm_parallel_train``); each FSDP leaf's local shape is
    JAX's shard shape of it."""
    want = jax_run.get()[(shape, name)]
    _close_to_jax(cases.cfg_of(name), world4[(shape, name, False, True)],
                  want)
    local = world4[("local", shape, name)]
    dims = world4[("dims", shape, name)]
    assert local and set(local) == set(dims)
    for n, got in local.items():
        keys = n.split(".")
        jkey = "/".join(k for k in keys if not k.isdigit())
        jshape = want["shards"][jkey]
        assert got == (jshape[1:] if keys[0] == "blocks" else jshape), n


@pytest.mark.parametrize("shape", cases.FSDP_MESHES, ids=str)
@pytest.mark.parametrize("name", cases.FSDP_ARCHS)
def test_fsdp_control_misses(world4, name, shape):
    """The control: an FSDP step that also all-reduces the sharded leaves'
    gradients over ``data`` (they come out of the gather's
    reduce-scatter summed already) misses the plain sharded step by far
    more than the tolerance."""
    ctrl = world4[(shape, name, "control")]
    plain = world4[(shape, name, False, False)]
    assert _rel(ctrl["grad_norm"], plain["grad_norm"]) > 1e3 * FSDP_RTOL
    assert not all(np.allclose(ctrl["params"][k], v, rtol=0, atol=0)
                   for k, v in plain["params"].items())


@pytest.mark.parametrize("shape", cases.FSDP_MESHES, ids=str)
@pytest.mark.parametrize("name", cases.FSDP_ARCHS)
def test_fsdp_prefill_and_decode(world4, name, shape):
    """An FSDP model's prefill and decode logits (flash-decoding cache on
    a model dim of 2) against the plain sharded model's on the rank's
    rows, within ``FSDP_RTOL`` of the largest logit."""
    got = world4[("decode", shape, name)]
    want = world4[("decode", shape, name, "plain")]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= FSDP_RTOL * float(
        np.abs(want).max())


@pytest.mark.parametrize("fsdp", [False, True])
def test_dryrun_collectives_equal_a_real_run(world4, dry, fsdp):
    """The dry run's collectives (count and bytes by JAX's kind) of the
    reduced qwen3-8b train cell on a fake (2, 2) group equal those the
    same cell records at rank 0 of the real gloo group; FSDP adds
    all-gathers and reduce-scatters and removes all-reduces."""
    want = world4[("collectives", fsdp)]
    got = dry.get()[fsdp]["collectives"]
    assert got == want
    if fsdp:
        plain = world4[("collectives", False)]
        assert want["all-gather"]["count"] > plain["all-gather"]["count"]
        assert want["reduce-scatter"]["count"] > \
            plain["reduce-scatter"]["count"]
        assert want["all-reduce"]["count"] < plain["all-reduce"]["count"]


@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    import torch.distributed as dist
    tmesh.init_process_group(str(tmp_path_factory.mktemp("store11f")), 0, 1,
                             device_type="cpu")
    try:
        yield tmesh.make_test_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", cases.FSDP_ARCHS)
def test_world_one_fsdp_is_the_plain_step_bitwise(mesh11, name, remat):
    """At a (1, 1) mesh the FSDP step (every gather and reduce-scatter
    issued, over one rank) is the plain sharded step bitwise: the loss,
    the grad norm, every parameter and moment after two steps."""
    from repro_torch.launch.train import build_on_mesh
    runs = []
    for fsdp in (False, True):
        cfg, model, opt, step, _ = build_on_mesh(
            name, mesh11, reduced=True, device="cpu", remat=remat,
            fsdp=fsdp)
        assert bool(model.fsdp_dims) == fsdp
        for toks in cases.step_batches(2):
            t = torch.from_numpy(toks).long()
            model, opt, m = step(model, opt, {"tokens": t, "labels": t})
        runs.append((m, [p.detach().clone() for p in model.parameters()],
                     [t.clone() for a in ("m", "v")
                      for t in opt[a].values()]))
    (pm, pp, po), (fm, fp, fo) = runs
    assert torch.equal(pm["loss"], fm["loss"])
    assert torch.equal(pm["grad_norm"], fm["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(pp, fp))
    assert all(torch.equal(a, b) for a, b in zip(po, fo))
