"""The port's model-parallel diffusion path on CPU gloo groups, against the
JAX package's and the port's own single process: the sharding-aware
``Denoiser`` seam (``repro_torch.core.denoiser``), the serving specs
(``parallel.sharding``), the DiT's row-sharded forward with its K/V
gathered into the attention, the three drivers on a (time, data, model)
mesh, the mesh-sharded serving engine, and the compressed data-parallel
step with its collectives (``parallel.collectives``).

The rank bodies live in ``tests/torch_dist_cases.py``.  One
``spawn_ranks`` per world size: 8 ranks for the (2, 2, 2) mesh (the
reduced DiT of table6's ``mesh_t2d2m2`` row, with a nonzero draw of its
weights, and JAX's f64 toy engine cases over the block and data dims),
2 for the compressed step on reduced qwen3-8b.  JAX's side runs once in
one subprocess with 8 fake XLA devices and hands back numpy arrays; the
requests' noise is JAX's draw, handed to the port's engine through
``noise_fn``.  The single-process cases run on a gloo group of one rank
in this process.

Tolerances: iterations and eval counts are equal everywhere.  The DiT's
samples (f32) agree with the port's single process within 5e-5 max abs
(JAX's own carve-out; read 0.0), and with JAX's within ``JAX_TOL``, set
from the readings: the random-weight DiT's DDIM samples reach |x| ~ 640,
where two frameworks' f32 rounding read 2.44e-4 to 3.05e-4.  Every rank
returns the same bits; at world size 1 the mesh path equals the plain
one bitwise.  The f64 toy's samples and residual histories equal the
port's unsharded engine bitwise, and JAX's residuals within 1e-6
relative (two frameworks' ``tanh``).  The compressed step runs each step
from JAX's state entering it: the loss and grad norm within 1e-6 and
1e-5 relative, each rank's carry within 1e-3 quanta (the group's scale
of each tensor) but for at most 1e-4 of the elements that round the
other way at .5, the new parameters within 1e-3 learning rates outside
those elements; a control taking the other rank's half of the batch and
one applying the negated mean each miss.
"""
import jax

jax.config.update("jax_enable_x64", True)

import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro_torch.core as T  # noqa: E402
import torch_dist_cases as cases  # noqa: E402
from conftest import REPO  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.parallel import (collectives, denoiser_spec,  # noqa: E402
                                  microbatch_spec)

pytestmark = pytest.mark.distributed

TOL = 5e-5
# the DiT's samples against JAX's: twice the largest max |diff| read
# (3.05e-4 at max |sample| 640, five f32 ulps there; 2.44e-4 to 3.05e-4
# over the six samplers and engines)
JAX_TOL = 6.1e-4
HIST_RTOL = 1e-6
# the compressed step from a carried JAX state: the loss and grad norm
# relative, the carries in quanta (the elements that round the other way
# at .5 counted apart, as a share of all), the parameters in units of the
# learning rate
# (read over 3 steps: loss 7.6e-8, grad norm 3.3e-7, carries 1.8e-4
# quanta, 0 to 3 flips of 213760 elements, parameters 3.0e-5 lr)
LOSS_RTOL, GRAD_NORM_RTOL = 1e-6, 1e-5
CARRY_QUANTA, FLIP_SHARE, UPDATE_LR = 1e-3, 1e-4, 1e-3

JAX_CODE = r"""
import dataclasses as dc
import pickle
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.compat import make_mesh
from repro.configs.base import get_arch
from repro.configs.srds_dit import dit_denoiser
from repro.core import SRDSConfig, SolverConfig, make_schedule, srds_sample
from repro.core.pipelined import make_sharded_sampler
from repro.launch.mesh import make_srds_mesh
from repro.optim import AdamWConfig, init_opt_state
from repro.parallel.collectives import compressed_psum_mean, lse_combine
from repro.serve.diffusion import DiffusionSamplingEngine, SampleRequest
from repro.train.steps import init_error_feedback, make_dp_train_step_compressed
import torch_dist_cases as cases

assert len(jax.devices()) == 8
with open(sys.argv[1], "rb") as f:
    qwen_tree = pickle.load(f)
out = {}
def res(r):
    return {k: np.asarray(getattr(r, k)) for k in
            ("sample", "iterations", "final_delta", "delta_history")}
def serve(den, reqs, shape, dtype, **kw):
    eng = DiffusionSamplingEngine(den, shape, dtype=dtype, **kw)
    rids = [eng.submit(SampleRequest(seed=s, tol=t)) for s, t in reqs]
    o = eng.drain()
    st = eng.stats()
    return dict(sample=np.stack([np.asarray(o[r].sample) for r in rids]),
                iterations=np.array([o[r].iterations for r in rids]),
                delta_history=[np.asarray(o[r].delta_history) for r in rids],
                model_evals=np.array([o[r].model_evals for r in rids]),
                physical_evals=st["physical_evals"],
                effective_evals=st["effective_evals"])

cfg = dc.replace(get_arch("srds-dit-cifar"), **cases.MP_DIT)
params = jax.tree.map(jnp.asarray, cases.mp_tree())
mesh = make_srds_mesh(2, 2, 2)
den = dit_denoiser(cfg, params, shard_axis="model", mesh=mesh,
                   use_kernel=False)
ref_fn = dit_denoiser(cfg, params, use_kernel=False)
sched = make_schedule("ddpm_linear", cases.MP_N)
solver = SolverConfig("ddim")
x0 = jnp.asarray(cases.mp_x0())
cfg_s = SRDSConfig(num_blocks=cases.MP_BLOCKS, per_sample=True)
out["single/srds"] = res(srds_sample(ref_fn, sched, solver, x0, cfg_s))
out["mp/srds"] = res(srds_sample(den, sched, solver, x0, cfg_s))
out["mp/sharded"] = res(make_sharded_sampler(
    mesh, "time", den, sched, solver, cfg_s, data_axis="data")(x0))
reqs = [(i, cases.MP_REQ_TOL) for i in range(4)]
kw = dict(solver=solver, num_steps=cases.MP_N, batch_size=cases.MP_K,
          num_blocks=cases.MP_BLOCKS)
out["engine/single"] = serve(ref_fn, reqs, cases.MP_SHAPE, jnp.float32, **kw)
out["engine/data"] = serve(den, reqs, cases.MP_SHAPE, jnp.float32,
                           mesh=mesh, data_axis="data", **kw)
out["engine/time_data"] = serve(den, reqs, cases.MP_SHAPE, jnp.float32,
                                mesh=mesh, axis="time", data_axis="data",
                                **kw)

with jax.enable_x64(True):
    scale = jnp.asarray(cases.TOY_SCALE)
    emodel = lambda x, t: jnp.tanh(x * scale) * (0.5 + 0.001 * t)
    toy = dict(solver=solver, num_steps=64, batch_size=2)
    mesh8 = make_mesh((8,), ("time",))
    mesh2 = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    mesh42 = make_mesh((4, 2), ("time", "data"))
    for n, name, mkw in ((5, "toy/plain5", {}), (6, "toy/plain6", {}),
                         (5, "toy/time", dict(mesh=mesh8, axis="time")),
                         (5, "toy/data", dict(mesh=mesh2, data_axis="data")),
                         (6, "toy/time_data", dict(mesh=mesh42, axis="time",
                                                   data_axis="data"))):
        out[name] = serve(emodel, cases.toy_requests(n), (6,), jnp.float64,
                          **toy, **mkw)

mesh2 = make_mesh((2,), ("data",), devices=jax.devices()[:2])
gs = [cases.dp_grads(r) for r in range(2)]
def psum_local(g, e):
    mean, carry = compressed_psum_mean({k: v[0] for k, v in g.items()},
                                       "data", {k: v[0] for k, v in e.items()})
    return mean, {k: v[None] for k, v in carry.items()}
psum = compat.shard_map(psum_local, mesh=mesh2, in_specs=(P("data"), P("data")),
                        out_specs=(P(), P("data")), check_vma=False)
G = {k: jnp.stack([gs[r][0][k] for r in range(2)]) for k in gs[0][0]}
for name in ("zero", "carry"):
    E = {k: jnp.stack([gs[r][1][k] * (name == "carry") for r in range(2)])
         for k in gs[0][1]}
    mean, carry = psum(G, E)
    out["psum/" + name] = (jax.tree.map(np.asarray, mean),
                           jax.tree.map(np.asarray, carry))
lses = [cases.lse_inputs(r) for r in range(2)]
lse = compat.shard_map(lambda o, l: lse_combine(o[0], l[0], "data"),
                       mesh=mesh2, in_specs=(P("data"), P("data")),
                       out_specs=P(), check_vma=False)
out["lse"] = np.asarray(lse(jnp.stack([o for o, _ in lses]),
                            jnp.stack([l for _, l in lses])))

jcfg = get_arch(cases.DP_ARCH).reduced()
params = jax.tree.map(jnp.asarray, qwen_tree)
opt = init_opt_state(params)
ef = init_error_feedback(params)
step = make_dp_train_step_compressed(jcfg, AdamWConfig(lr=cases.DP_LR), mesh2,
                                     use_kernel=False)
# each device's buffer of a tree the step returns under P(): the carry
# differs by rank, the rest is replicated
def per_rank(tree):
    def shard(a, r):
        if not hasattr(a, "addressable_shards"):
            return np.asarray(a)
        return np.asarray(sorted(a.addressable_shards,
                                 key=lambda s: s.device.id)[r].data)
    return [jax.tree.map(lambda a: shard(a, r), tree) for r in range(2)]
steps = []
for toks in cases.dp_batches():
    b = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    params, opt, ef, m = step(params, opt, ef, b, jax.random.PRNGKey(0))
    steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                      params=jax.tree.map(np.asarray, params),
                      opt=jax.tree.map(np.asarray, opt), ef=per_rank(ef)))
out["steps"] = steps
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX MODEL PARALLEL OK")
"""


def qwen_tree():
    """JAX's init of reduced qwen3-8b, every leaf moved by a numpy draw
    (as ``tests/test_torch_lm_train.py``): numpy f32 leaves."""
    jcfg = jget_arch(cases.DP_ARCH).reduced()
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32)),
        jtf.init_params(jcfg, jax.random.PRNGKey(0)))


def noise_tables():
    """JAX's engine draws (``normal(PRNGKey(seed), shape, dtype)``) for
    the DiT's f32 requests and the toy's f64 ones."""
    with jax.enable_x64(True):
        dit = {s: np.asarray(jax.random.normal(
            jax.random.PRNGKey(s), cases.MP_SHAPE, jnp.float32))
            for s in range(4)}
        toy = {s: np.asarray(jax.random.normal(
            jax.random.PRNGKey(s), (6,), jnp.float64)) for s in range(6)}
    return dit, toy


class _JaxRun:
    """JAX's side in a subprocess of 8 fake devices, started when the
    module's first test sets up and read when a test needs it."""

    def __init__(self, tmp):
        self.tree = qwen_tree()
        src, self.dst = str(tmp / "qwen.pkl"), str(tmp / "jax_out.pkl")
        with open(src, "wb") as f:
            pickle.dump(self.tree, f)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
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


@pytest.fixture(scope="module", autouse=True)
def jax_run(tmp_path_factory):
    run = _JaxRun(tmp_path_factory.mktemp("jax_mp"))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.fixture(scope="module")
def world8():
    dit, toy = noise_tables()
    return tmesh.spawn_ranks(cases.model_parallel, 8, dit, toy,
                             device_type="cpu")


@pytest.fixture(scope="module")
def world2(jax_run):
    return tmesh.spawn_ranks(cases.compressed, 2, jax_run.tree,
                             jax_run.get()["steps"], device_type="cpu")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo group of one rank in this process and its (1, 1, 1) mesh."""
    import torch.distributed as dist
    tmesh.init_process_group(str(tmp_path_factory.mktemp("store1")), 0, 1,
                             device_type="cpu")
    try:
        yield tmesh.make_srds_mesh(1, 1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _fn(x, t):
    return x * t


def _shard_fn(x, t, mesh):
    return x * t


def _den(axis="model", size=1, spec=None):
    spec = (None, axis) if spec is None else spec
    return T.Denoiser(fn=_fn, shard_fn=_shard_fn, in_spec=spec,
                      out_spec=spec, mesh_axes={axis: size})


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _small_dit():
    from repro_torch.models.dit import load_jax_params
    return load_jax_params(cases.mp_cfg(), cases.mp_tree(), device="cpu")


# --------------------------------------------------------------------------
# the seam on one process (tests/test_denoiser.py's cases)
# --------------------------------------------------------------------------

def test_as_denoiser_adapts_plain_fn_and_is_identity_on_denoisers():
    den = T.as_denoiser(_fn)
    assert isinstance(den, T.Denoiser) and not den.is_model_parallel
    assert T.as_denoiser(den) is den
    x = torch.arange(4.0)
    assert torch.equal(den(x, 2.0), _fn(x, 2.0))
    assert den.inner_eval() is _fn and den.shard_eval() is _fn


def test_denoiser_with_mesh_axes_requires_shard_fn():
    with pytest.raises(ValueError, match="needs a shard_fn"):
        T.Denoiser(fn=_fn, mesh_axes={"model": 2})


def test_standalone_model_parallel_call_requires_bound_mesh():
    with pytest.raises(ValueError, match="bound"):
        _den()(torch.ones((2, 2)), 0.5)
    for mode in ("inner_eval", "shard_eval"):
        with pytest.raises(ValueError, match="bound"):
            getattr(_den(), mode)()


def test_check_mesh_names_the_missing_axis(mesh1):
    mesh = tmesh.make_test_mesh((1,), ("time",), device_type="cpu")
    with pytest.raises(ValueError, match=r"mesh axis 'model'.*\('time',\)"):
        _den().check_mesh(mesh)


def test_check_mesh_enforces_min_size(mesh1):
    with pytest.raises(ValueError, match="size >= 2"):
        _den(size=2).check_mesh(mesh1)
    with pytest.raises(ValueError, match="size >= 2"):
        _den(size=2).bind(mesh1)       # binding validates too


def test_microbatch_spec_validates_axis_is_bound(mesh1):
    assert microbatch_spec("data", mesh=mesh1) == (None, "data")
    with pytest.raises(ValueError, match=r"'dp' is not bound.*'time', "
                                         r"'data', 'model'"):
        microbatch_spec("dp", mesh=mesh1)


def test_denoiser_spec_composes_data_and_model_axes(mesh1):
    den = _den()
    assert denoiser_spec("data", den, mesh=mesh1) == (None, "data", "model")
    assert denoiser_spec("data", _fn) == (None, "data")
    assert denoiser_spec("data") == (None, "data")
    assert denoiser_spec(None, den) == (None, None, "model")


def test_denoiser_spec_rejects_sample_batch_sharding_and_unbound_axes(
        mesh1):
    with pytest.raises(ValueError, match="owns that dim via data_axis"):
        denoiser_spec("data", _den(spec=("model",)))
    with pytest.raises(ValueError, match="mesh axis 'mp'"):
        denoiser_spec("data", _den(axis="mp"), mesh=mesh1)


def test_serving_engine_rejects_unbound_data_axis_and_meshless_mp(mesh1):
    from repro_torch.serve import DiffusionSamplingEngine
    with pytest.raises(ValueError, match="'dp' is not bound"):
        DiffusionSamplingEngine(_fn, (4,), num_steps=8, batch_size=1,
                                mesh=mesh1, data_axis="dp", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        DiffusionSamplingEngine(_den(), (2, 2), num_steps=8, batch_size=1,
                                device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        DiffusionSamplingEngine(_den(axis="data"), (2, 2), num_steps=8,
                                batch_size=1, mesh=mesh1, data_axis="data",
                                device="cpu")


def test_sharded_driver_rejects_mesh_missing_model_axis(mesh1):
    from repro_torch.core.pipelined import (make_pipelined_sampler,
                                            make_sharded_sampler)
    sched = T.make_schedule("ddpm_linear", 8)
    mesh = tmesh.make_test_mesh((1,), ("time",), device_type="cpu")
    for make in (make_sharded_sampler, make_pipelined_sampler):
        with pytest.raises(ValueError, match="mesh axis 'model'"):
            make(mesh, "time", _den(), sched, T.SolverConfig("ddim"),
                 T.SRDSConfig(num_blocks=4))


def test_backend_follows_the_device(mesh1):
    """A gloo group takes CPU tensors only: a CUDA tensor on it raises
    before any collective (on a card, the same check refuses a CPU tensor
    on NCCL)."""
    import types
    group = mesh1.get_group("model")
    collectives.check_backend(group, torch.zeros(1))
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="a cuda tensor needs a nccl "
                                         "process group; this group runs "
                                         "gloo"):
        collectives.check_backend(group, on_card)


# --------------------------------------------------------------------------
# world size 1: the mesh path is the plain path, bitwise
# --------------------------------------------------------------------------

def test_world_one_mesh_path_equals_plain_bitwise(mesh1):
    """At (1, 1, 1) every mode runs the plain path's operations on the
    plain path's shapes: the standalone, inner and shard evals,
    ``srds_sample``, the sharded driver and the engine (mesh, axis,
    data_axis) each equal the plain path bitwise; a one-ulp nudge of the
    input, the control, does not."""
    from repro_torch.configs.srds_dit import dit_denoiser
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    model = _small_dit()
    cfg = cases.mp_cfg()
    den = dit_denoiser(cfg, model, shard_axis="model", mesh=mesh1)
    plain = dit_denoiser(cfg, model)
    x = torch.from_numpy(cases.mp_x0())
    t = torch.linspace(10.0, 900.0, x.shape[0])
    want = plain(x, t)
    for got in (den(x, t), den.inner_eval(mesh1)(x, t),
                den.shard_eval(mesh1)(x, t)):
        assert torch.equal(got, want)
    nudged = torch.nextafter(x, torch.full_like(x, np.inf))
    assert not torch.equal(den(nudged, t), want)
    sched = T.make_schedule("ddpm_linear", cases.MP_N)
    solver = T.SolverConfig("ddim")
    cfg_s = T.SRDSConfig(num_blocks=cases.MP_BLOCKS, per_sample=True)
    ref = T.srds_sample(plain, sched, solver, x, cfg_s)
    for res in (T.srds_sample(den, sched, solver, x, cfg_s),
                make_sharded_sampler(mesh1, "time", den, sched, solver,
                                     cfg_s, data_axis="data")(x)):
        assert torch.equal(res.sample, ref.sample)
        assert torch.equal(res.iterations, ref.iterations)
    ctrl = T.srds_sample(den, sched, solver, nudged, cfg_s)
    assert not torch.equal(ctrl.sample, ref.sample)

    def serve(fn, **kw):
        eng = DiffusionSamplingEngine(
            fn, cases.MP_SHAPE, solver, num_steps=cases.MP_N, batch_size=2,
            num_blocks=cases.MP_BLOCKS, device="cpu", **kw)
        rids = [eng.submit(SampleRequest(seed=s, tol=cases.MP_REQ_TOL))
                for s in range(3)]
        out = eng.drain()
        return [out[r] for r in rids], eng.stats()

    for fixed, kw in ((False, dict(mesh=mesh1, data_axis="data")),
                      (True, dict(mesh=mesh1, axis="time",
                                  data_axis="data"))):
        want, wst = serve(plain, truncate=not fixed)
        got, gst = serve(den, **kw)
        assert gst["physical_evals"] == wst["physical_evals"]
        for a, b in zip(got, want):
            assert a.iterations == b.iterations
            assert np.array_equal(a.sample, b.sample)
            assert np.array_equal(a.delta_history, b.delta_history)


def test_compressed_mean_at_world_one(mesh1):
    """One rank: the mean is the gradient rounded to its quantum
    (``|mean - g| <= scale / 2``) and the carry is ``g - mean`` exactly; a
    carry shifted by one quantum, the control, is not."""
    g, _ = cases.dp_grads(0)
    g = {k: torch.from_numpy(v) for k, v in g.items()}
    zero = {k: torch.zeros_like(v) for k, v in g.items()}
    mean, carry = collectives.compressed_psum_mean(
        g, mesh1.get_group("data"), zero)
    for k in g:
        scale = float(g[k].abs().max()) / 127.0
        assert float((mean[k] - g[k]).abs().max()) <= scale / 2 * (1 + 1e-6)
        assert torch.equal(carry[k], g[k] - mean[k])
        assert not torch.equal(carry[k] + scale, g[k] - mean[k])


@pytest.mark.parametrize("m", [2, 4])
def test_dit_row_shard_matches_full_forward(m):
    """The row-sharded forward on one process: shard ``r`` of ``m`` fed
    the full forward's own K/V through its ``kv_gather`` hook computes the
    full forward's rows (f32, rel L2 1e-5), its local K/V are the full
    K/V's rows, and with its positions left unshifted (the control) it
    misses."""
    from repro_torch.models import dit
    model = _small_dit()
    x = torch.from_numpy(cases.mp_x0())[:2]
    t = torch.tensor([100.0, 700.0])
    kv = []
    real = dit.attention_full

    def capture(*a, **kw):
        out = real(*a, **kw)
        kv.append(out[1])
        return out

    dit.attention_full = capture
    try:
        with torch.no_grad():
            full = model(x, t)
    finally:
        dit.attention_full = real
    rows = x.shape[1] // m
    s_loc = (rows // model.cfg.patch_size) * (x.shape[2]
                                              // model.cfg.patch_size)
    for r in range(m):
        calls = []

        def hook(a):
            layer, which = divmod(len(calls), 2)
            want = kv[layer][which]
            calls.append(a)
            assert torch.allclose(a, want[:, r * s_loc:(r + 1) * s_loc],
                                  rtol=1e-5, atol=1e-6)
            return want

        part = x[:, r * rows:(r + 1) * rows]
        want = full[:, r * rows:(r + 1) * rows]
        with torch.no_grad():
            got = model(part, t, shard_rank=r, kv_gather=hook)
            calls.clear()
            ctrl = model(part, t, shard_rank=0, kv_gather=lambda a: (
                calls.append(a) or kv[(len(calls) - 1) // 2][
                    (len(calls) - 1) % 2]))
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-5, (r, rel)
        if r:
            assert float((ctrl - want).norm() / want.norm()) > 1e-5


def test_kv_gather_attention_matches_jax():
    """``attention_full`` with a ``kv_gather`` hook against JAX's on the
    same projections: the local queries against the whole sequence's K/V
    (f32, non-causal, no rope)."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    d, h, hd, s, m = 32, 2, 16, 16, 4
    p = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
        np.float32) for k, shape in (("wq", (d, h * hd)), ("wk", (d, h * hd)),
                                     ("wv", (d, h * hd)), ("wo", (h * hd, d)))}
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    kw = dict(num_heads=h, num_kv_heads=h, head_dim=hd, causal=False,
              theta=None)
    _, (k_full, v_full) = jlayers.attention_full(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), use_kernel=False, **kw)
    full = {0: np.asarray(k_full), 1: np.asarray(v_full)}
    for r in range(m):
        loc = x[:, r * s // m:(r + 1) * s // m]
        jcalls, tcalls = [], []

        def jhook(a):
            jcalls.append(a)
            return jnp.asarray(full[len(jcalls) - 1])

        def thook(a):
            tcalls.append(a)
            return torch.from_numpy(full[len(tcalls) - 1])

        jout, _ = jlayers.attention_full(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(loc), use_kernel=False,
                                         kv_gather=jhook, **kw)
        tout, (tk, _) = layers.attention_full(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(loc), kv_gather=thook, **kw)
        assert tk.shape[1] == s and tcalls[0].shape[1] == s // m
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# 8 ranks: the (2, 2, 2) mesh against JAX and the port's single process
# --------------------------------------------------------------------------

def _held(got, want, tol):
    """An SRDS result (or served batch): equal iterations, samples within
    ``tol`` max abs."""
    assert np.array_equal(np.asarray(got["iterations"]),
                          np.asarray(want["iterations"]))
    d = _maxdiff(got["sample"], want["sample"])
    assert d <= tol, (d, tol)
    return d


@pytest.mark.parametrize("path", ["single/srds", "mp/srds", "mp/sharded"])
def test_mesh_samplers_match_jax(world8, jax_run, path):
    """``srds_sample`` (bound standalone glue) and the sharded driver
    (``inner_eval`` on the mesh, ``data_axis``) against JAX's same
    samplers: iterations equal, samples within ``JAX_TOL``."""
    _held(world8[0][path], jax_run.get()[path], JAX_TOL)


@pytest.mark.parametrize("path", ["engine/single", "engine/data",
                                  "engine/time_data"])
def test_mesh_engine_matches_jax(world8, jax_run, path):
    """The engine over ``mesh`` + ``data_axis`` (the denoiser's rows over
    ``model``), and with ``axis`` too (``FixedBudget``): iterations,
    per-request and engine eval counts equal JAX's, samples within
    ``JAX_TOL``."""
    got, want = world8[0][path], jax_run.get()[path]
    _held(got, want, JAX_TOL)
    assert np.array_equal(got["model_evals"], want["model_evals"])
    assert (got["physical_evals"], got["effective_evals"]) == \
        (want["physical_evals"], want["effective_evals"])


@pytest.mark.parametrize("path,ref", [
    ("mp/srds", "single/srds"), ("mp/sharded", "single/srds"),
    ("engine/data", "engine/single"),
    ("engine/time_data", "engine/single_fixed")])
def test_mesh_matches_the_single_process(world8, path, ref):
    """The same mesh against the port's single process: iterations equal,
    samples within 5e-5 (the engine with ``axis`` against the unsharded
    engine without truncation, as it falls back to ``FixedBudget``)."""
    _held(world8[0][path], world8[0][ref], TOL)


def test_ranks_return_same_bits(world8):
    """Every rank's results are rank 0's, bit for bit; the mesh puts rank
    ``r`` at ``(r // 4, r // 2 % 2, r % 2)``."""
    assert [w["coords"] for w in world8] == [
        (r // 4, r // 2 % 2, r % 2) for r in range(8)]

    def same(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same(a[k], b[k])
                                                  for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b

    for w in world8[1:]:
        assert same({k: v for k, v in w.items() if k != "coords"},
                    {k: v for k, v in world8[0].items() if k != "coords"})


def test_standalone_glue_gathers_once_per_split_dim(world8):
    """``srds_sample`` on the bound denoiser: each model call gathers K
    and V in every layer and its output rows once: ``(B + p (S + B)) x
    (2 L + 1)`` gathers over ``model``."""
    res = world8[0]["mp/srds"]
    p = int(np.max(res["iterations"]))
    b, s = cases.MP_BLOCKS, cases.MP_N // cases.MP_BLOCKS
    calls = b + p * (s + b)
    assert world8[0]["mp/srds_gathers"] == \
        calls * (2 * cases.MP_DIT["num_layers"] + 1)


@pytest.mark.parametrize("case,plain", [("toy/time", "toy/plain5"),
                                        ("toy/data", "toy/plain5"),
                                        ("toy/time_data", "toy/plain6")])
def test_engine_block_and_data_axes_match_jax(world8, jax_run, case, plain):
    """JAX's block-axis engine cases on the f64 toy
    (``test_serving_engine_sharded_fine_solves``,
    ``_data_sharded_slot_batch``, ``_block_and_data_axes_compose``):
    iterations equal JAX's and its residual histories within 1e-6
    relative; samples and histories equal the port's unsharded engine
    bitwise."""
    got, want = world8[0][case], jax_run.get()[case]
    assert np.array_equal(got["iterations"], want["iterations"])
    for a, b in zip(got["delta_history"], want["delta_history"]):
        np.testing.assert_allclose(a, b, rtol=HIST_RTOL, atol=1e-12)
    ref = world8[0][plain]
    assert np.array_equal(got["iterations"], ref["iterations"])
    assert np.array_equal(got["sample"], ref["sample"])
    for a, b in zip(got["delta_history"], ref["delta_history"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case,match", [
    ("refused/rows", "not divisible by patch_size=2"),
    ("refused/batch", "batch_size=3 not divisible by data axis size 2"),
    ("refused/blocks", "num_blocks=1 not divisible by axis size 2"),
    ("refused/same_dim", "must be distinct"),
    ("refused/toy_blocks", "num_blocks=4 not divisible by axis size 8"),
    ("refused/toy_batch", "not divisible")])
def test_mesh_refusals(world8, case, match):
    assert world8[0][case] is not None and match in world8[0][case], \
        world8[0][case]


# --------------------------------------------------------------------------
# 2 ranks: the collectives and the compressed step against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zero", "carry"])
def test_compressed_psum_mean_matches_jax(world2, jax_run, name):
    """The same per-rank gradients and carries: the mean equals JAX's on
    every rank (same operations in f32), each rank's new carry equals
    JAX's shard of it."""
    jmean, jcarry = jax_run.get()[f"psum/{name}"]
    for r, w in enumerate(world2):
        mean, carry = w[f"psum/{name}"]
        for k in mean:
            np.testing.assert_allclose(mean[k], jmean[k], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(carry[k], jcarry[k][r], rtol=1e-6,
                                       atol=1e-7)


def test_lse_combine_matches_jax(world2, jax_run):
    want = jax_run.get()["lse"]
    for w in world2:
        np.testing.assert_allclose(w["lse"], want, rtol=1e-6, atol=1e-7)


def _step_readings(runs, jstep):
    """One compressed step of the port (``runs``: each rank's outcome of
    one run from JAX's state entering the step) against JAX's same step:
    the loss's and the grad norm's relative differences; per element of
    each rank's carry, its difference from JAX's in quanta (the group's
    scale of its tensor), split into elements that rounded the other way
    at .5 (one quantum apart, each carry half a quantum from zero) and
    the rest; and rank 0's new parameters' difference from JAX's in units
    of the learning rate outside the elements whose mean took a flipped
    rounding."""
    cfg = cases.dp_cfg()
    readings = dict(
        loss=abs(runs[0]["loss"] - jstep["loss"]) / abs(jstep["loss"]),
        grad_norm=abs(runs[0]["grad_norm"] - jstep["grad_norm"])
        / jstep["grad_norm"], carry=0.0, flips=0, elements=0, update=0.0)
    flipped = {}
    for r, run in enumerate(runs):
        want = cases.jax_leaves(cfg, jstep["ef"][r])
        for name, got in run["carry"].items():
            q = run["quanta"][name]
            d = np.abs(got.astype(np.float64) - want[name]) / q
            flip = ((np.abs(d - 1.0) <= CARRY_QUANTA)
                    & (np.abs(want[name]) / q >= 0.5 - CARRY_QUANTA))
            readings["carry"] = max(readings["carry"],
                                    float(np.max(d[~flip], initial=0.0)))
            readings["flips"] += int(flip.sum())
            readings["elements"] += d.size
            flipped[name] = flipped.get(name, False) | flip
    want = cases.jax_leaves(cfg, jstep["params"])
    for name, got in runs[0]["params"].items():
        d = np.abs(got.astype(np.float64) - want[name]) / cases.DP_LR
        readings["update"] = max(readings["update"], float(
            np.max(d[~flipped[name]], initial=0.0)))
    return readings


def _step_misses(readings):
    """The limits of :func:`_step_readings` a run misses."""
    limits = dict(loss=LOSS_RTOL, grad_norm=GRAD_NORM_RTOL,
                  carry=CARRY_QUANTA, update=UPDATE_LR)
    misses = [k for k, lim in limits.items() if not readings[k] <= lim]
    if readings["flips"] > FLIP_SHARE * readings["elements"]:
        misses.append("flips")
    return misses


@pytest.mark.parametrize("step", range(cases.DP_STEPS))
def test_compressed_step_tracks_jax(world2, jax_run, step):
    """Reduced qwen3-8b on 2 ranks, each compressed step started from
    JAX's state entering it (parameters, AdamW moments, each rank's
    carry): the averaged loss and the applied mean's grad norm as JAX's,
    each rank's carry within a small fraction of a quantum of JAX's but
    for a counted few elements rounded the other way at .5, and the new
    parameters as JAX's outside the elements those flips moved.  The
    controls, each rank taking the other rank's half of the batch and the
    update applying the negated mean, miss."""
    jstep = jax_run.get()["steps"][step]
    runs = {run: [w["steps"][step][run] for w in world2]
            for run in cases.DP_RUNS}
    for name, p in runs["step"][0]["params"].items():
        assert np.array_equal(p, runs["step"][1]["params"][name]), name
    got = _step_readings(runs["step"], jstep)
    assert not _step_misses(got), got
    for control in ("swapped", "negated"):
        ctrl = _step_readings(runs[control], jstep)
        assert _step_misses(ctrl), (control, ctrl)


def test_compressed_step_refuses_indivisible_batch(world2):
    assert "not divisible by axis 'data'" in world2[0]["refused/batch"]
