"""The port's distributed SRDS samplers (``repro_torch.core.pipelined``)
on CPU gloo groups, against the JAX package's samplers and the port's own
single-program ones.

The rank bodies live in ``tests/torch_dist_cases.py``.  One
``spawn_ranks`` per world size (2 and 4 for the block-sharded driver, 5
for the wavefront at N=25, B=5) runs every case of that size and hands
numpy results back; JAX's wavefront and sharded samplers run once for the
module in one subprocess with 5 fake XLA devices, as
``tests/test_distributed_srds.py`` runs them.  Everything is f64.

Tolerances: iterations, supersteps and physical evals are equal; samples
agree with JAX's within 1e-12 relative (ROADMAP C2: JAX's own sharded
driver is not bitwise equal to its single program), with the
sequential sample within 1e-10 where the run reaches ``max_iters``.
Within the port: every rank returns the same bits, and runs whose model is
elementwise (truncated suffixes, the data dim) equal the single program
bitwise.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
import torch_dist_cases as cases  # noqa: E402
from conftest import REPO, to_f64  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

pytestmark = pytest.mark.distributed

REL = 1e-12
EXACT = 1e-10

JAX_CODE = r"""
import json
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.compat import make_mesh
from repro.core import (DiffusionSchedule, FixedBudget, SolverConfig,
                        SRDSConfig, make_schedule)
from repro.core.pipelined import make_pipelined_sampler, make_sharded_sampler
import torch_dist_cases as cases

w = jnp.asarray(cases.weights())
def model_fn(x, t):
    return jnp.tanh(x @ w) * (0.5 + 0.001 * t)
def sched_of(n):
    s = make_schedule("ddpm_linear", n)
    return DiffusionSchedule(ab=s.ab.astype(jnp.float64),
                             t_model=s.t_model.astype(jnp.float64))
def res(r):
    return {k: np.asarray(getattr(r, k)).tolist() for k in
            ("sample", "iterations", "final_delta", "delta_history")}
solver = SolverConfig("ddim")
out = {}
mesh5 = make_mesh((5,), ("time",))
for case, kw in cases.WAVEFRONT.items():
    cfg = SRDSConfig(tol=kw["tol"], per_sample=kw.get("per_sample", False),
                     window=FixedBudget() if kw.get("fixed_budget") else None)
    r, steps, evals = make_pipelined_sampler(
        mesh5, "time", model_fn, sched_of(kw["n"]), solver, cfg)(
        jnp.asarray(cases.wavefront_x(case)))
    out["wf/" + case] = dict(res(r), supersteps=int(steps), evals=int(evals))
x = jnp.asarray(cases.x0())
for d in (2, 4):
    mesh = make_mesh((d,), ("time",), devices=jax.devices()[:d])
    r = make_sharded_sampler(mesh, "time", model_fn, sched_of(cases.N),
                             solver, SRDSConfig(tol=1e-4, num_blocks=8))(x)
    out["sharded%d" % d] = res(r)
# table3's wavefront toy at (25, 5)
w8 = jnp.asarray(np.random.default_rng(0).standard_normal((8, 8)) * 0.4)
r, steps, evals = make_pipelined_sampler(
    mesh5, "time", lambda x, t: jnp.tanh(x @ w8) * (0.4 + 3e-4 * t),
    sched_of(25), solver, SRDSConfig(tol=1e-4))(
    jnp.asarray(np.random.default_rng(1).standard_normal((1, 8))))
out["table3"] = dict(supersteps=int(steps), iters=int(r.iterations),
                     evals=int(evals))
print(json.dumps(out))
"""


class _JaxRun:
    """JAX's samplers in a subprocess of 5 fake devices, started when the
    module's first test sets up and read when a test needs it."""

    def __init__(self):
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=5",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"),
                        os.path.join(REPO, "tests")]))
        self.proc = subprocess.Popen([sys.executable, "-c", JAX_CODE],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env)
        self.out = None

    def get(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"stdout={out}\nstderr={err}"
            self.out = json.loads(out.strip().splitlines()[-1])
        return self.out


@pytest.fixture(scope="module", autouse=True)
def jax_run():
    run = _JaxRun()
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.fixture(scope="module")
def world2():
    return tmesh.spawn_ranks(cases.sharded, 2, False, device_type="cpu")


@pytest.fixture(scope="module")
def world4():
    return tmesh.spawn_ranks(cases.sharded, 4, True, device_type="cpu")


@pytest.fixture(scope="module")
def world5():
    return tmesh.spawn_ranks(cases.wavefront, 5, device_type="cpu")


def _world(request, w):
    return request.getfixturevalue(f"world{w}")


def _jmodel():
    w = jnp.asarray(cases.weights())
    return lambda x, t: jnp.tanh(x @ w) * (0.5 + 0.001 * t)


def _jsched(n):
    return to_f64(J.make_schedule("ddpm_linear", n))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _same(a, b):
    """Two results with the same bits."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def _results(rank_out):
    """A rank's results without its own readings (mesh coordinates, wall
    seconds, memory)."""
    return {k: v for k, v in rank_out.items()
            if k not in ("data/coords", "table3", "table6")}


def _history_close(got, want):
    """Residual histories: the same refinements run (the +inf pattern),
    each residual within f32 rounding, or within 1e-12 where the samples
    have converged to roundoff and the residual is its noise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-12)


# --------------------------------------------------------------------------
# wavefront pricing, and the table4 / table5 rows' pipelined fields
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,blocks,k,solver,truncate", [
    (25, 5, 1, "ddim", False), (25, 5, 3, "ddim", False),
    (64, 8, 2, "ddim", False), (100, None, 4, "heun", False),
    (961, 31, 2, "ddim", False), (196, 14, 5, "dpm2", True),
    (1024, 32, 0, "ddim", False)])
def test_srds_stats_pipelined_equals_jax(n, blocks, k, solver, truncate):
    """``serial = e * (B + k * (S + 1))`` beside the same total evals as
    JAX's ``srds_stats(pipelined=True)``."""
    jst = J.srds_stats(J.make_schedule("ddpm_linear", n),
                       J.SolverConfig(solver),
                       J.SRDSConfig(num_blocks=blocks, truncate=truncate), k,
                       pipelined=True)
    tst = T.srds_stats(T.make_schedule("ddpm_linear", n),
                       T.SolverConfig(solver),
                       T.SRDSConfig(num_blocks=blocks, truncate=truncate), k,
                       pipelined=True)
    assert dataclasses.astuple(tst) == (jst.serial_evals, jst.total_evals,
                                        jst.iterations)
    b, s = T.resolve_blocks(n, blocks)
    e = T.SolverConfig(solver).evals_per_step
    assert tst.serial_evals == e * (b + k * (s + 1))


@pytest.fixture
def x32():
    with jax.enable_x64(False):
        yield


def _jax_bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmarks import common as jcommon
    return jcommon


def test_table4_rows_carry_jax_pipelined_fields(x32, capsys):
    from repro_torch.benchmarks import common, table4_paradigms
    jcommon = _jax_bench()
    cases_ = [(25, 5), (36, 6)]
    got = table4_paradigms.rows(common.toy_denoiser("cpu"),
                                common.toy_array("x0_table4", "cpu"),
                                cases=cases_, tols=(1e-1,), repeats=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table4/")]
    x0 = jax.random.normal(jax.random.PRNGKey(2), (1, 16))
    for row, line, (n, b) in zip(got, lines, cases_):
        r = jcommon.run_pair(jcommon.toy_denoiser(),
                             J.make_schedule("ddpm_linear", n),
                             J.SolverConfig("ddim"), x0,
                             J.SRDSConfig(tol=1e-3, num_blocks=b))
        assert row["srds_eff_pipelined"] == r["eff_serial_pipelined"]
        assert row["srds_proj_pipelined"] == r["proj_speedup_pipelined"]
        assert (f"srds_eff={r['eff_serial_pipelined']};"
                f"srds_proj={r['proj_speedup_pipelined']:.2f}x;") in line
        assert "A10" not in line


def test_table5_rows_carry_jax_pipelined_fields(x32, capsys):
    from repro_torch.benchmarks import common, table5_solvers
    jcommon = _jax_bench()
    cases_ = [("dpm2", 16), ("ddim", 25)]
    got = table5_solvers.rows(common.toy_denoiser("cpu"),
                              common.toy_array("x0_table5", "cpu"),
                              cases=cases_, repeats=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table5/")]
    x0 = jax.random.normal(jax.random.PRNGKey(3), (1, 16))
    for row, line, (name, n) in zip(got, lines, cases_):
        r = jcommon.run_pair(jcommon.toy_denoiser(),
                             J.make_schedule("ddpm_linear", n),
                             J.SolverConfig(name), x0, J.SRDSConfig(tol=1e-3))
        assert row["eff_serial_pipelined"] == r["eff_serial_pipelined"]
        assert row["proj_speedup_pipelined"] == r["proj_speedup_pipelined"]
        assert f"proj_speedup={r['proj_speedup_pipelined']:.2f}x" in line
        assert "A10" not in line


# --------------------------------------------------------------------------
# straggler reuse in the engine (one process)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("per_sample", [False, True])
def test_engine_straggler_reuse_equals_jax(per_sample):
    """``run_parareal(carry_fine_results=True)`` hands the last fine
    results to ``fine_fn``, which reuses them for blocks 3 and 5 at odd
    refinements: iterations and residuals equal JAX's engine on the same
    fine function, samples within 1e-12; converged lanes keep their
    frozen results."""
    import torch
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    n, b = cases.N, 8
    s = n // b
    starts = np.arange(b) * s
    jsched, tsched = _jsched(n), cases.schedule(n)
    jsolver, tsolver = J.SolverConfig("ddim"), T.SolverConfig("ddim")
    jm = _jmodel()
    x = cases.xb() if per_sample else cases.x0()
    tol = cases.XB_TOLS if per_sample else 1e-6
    mask = np.zeros(b, bool)
    mask[[3, 5]] = True

    def jfine(heads, p, y_prev):
        y = jax.vmap(lambda h, i0: J.solve(jm, jsched, jsolver, h, i0, s, 1)
                     )(heads, jnp.asarray(starts))
        m = jnp.logical_and(jnp.asarray(mask), p % 2 == 1)
        return jnp.where(m.reshape((-1,) + (1,) * (y.ndim - 1)), y_prev, y)

    def tfine(heads, p, y_prev):
        y = teng.fold_fine_fn(lambda r, i0: T.solve(
            cases.matmul_model, tsched, tsolver, r, i0, s, 1), starts)(heads)
        if p % 2 == 1:
            m = torch.from_numpy(mask).reshape((-1,) + (1,) * (y.dim() - 1))
            y = torch.where(m, y_prev, y)
        return y

    jres = jeng.run_parareal(
        lambda h, i0: J.solve(jm, jsched, jsolver, h, i0, 1, s), jfine,
        jnp.asarray(x), jnp.asarray(starts), tol=jnp.asarray(tol),
        max_iters=24, carry_fine_results=True, batched=per_sample)
    tres = teng.run_parareal(
        lambda h, i0: T.solve(cases.matmul_model, tsched, tsolver, h, i0, 1,
                              s), tfine, torch.from_numpy(x), starts,
        tol=torch.from_numpy(np.asarray(tol)), max_iters=24,
        carry_fine_results=True, batched=per_sample)
    assert np.array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    assert _rel(tres.x_tail[-1].numpy(), jres.x_tail[-1]) < REL
    _history_close(tres.history.numpy(), jres.history)
    assert _rel(tres.y_prev.numpy(), jres.y_prev) < REL


# --------------------------------------------------------------------------
# the block-sharded driver at 2 and 4 gloo ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 4])
def test_sharded_ranks_return_the_same_bits(request, w):
    ranks = _world(request, w)
    for r in ranks[1:]:
        assert _same(_results(r), _results(ranks[0]))
        assert r["table6"]["iters"] == ranks[0]["table6"]["iters"]


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("blocks", [8, 16])
def test_sharded_exact_at_max_iters(request, w, blocks):
    """At ``tol=0`` the run reaches ``max_iters = B`` and equals the
    sequential sample (Prop 1), and the port's single program; 16 blocks
    put several on a rank."""
    out = _world(request, w)[0]
    res = out[f"sharded/tol0.0/b{blocks}"]
    assert int(res["iterations"]) == blocks
    assert np.max(np.abs(res["sample"] - out["seq"])) < EXACT
    single = out[f"single/tol0.0/b{blocks}"]
    assert _rel(res["sample"], single["sample"]) < REL


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_sharded_iteration_exact_against_jax(request, w, tol):
    """The port's sharded driver against JAX's ``srds_sample`` on the same
    weights and latents: iterations equal, samples within 1e-12."""
    out = _world(request, w)[0]
    x0 = jnp.asarray(cases.x0())
    for blocks in (8, 16):
        jres = J.srds_sample(_jmodel(), _jsched(cases.N),
                             J.SolverConfig("ddim"), x0,
                             J.SRDSConfig(tol=tol, num_blocks=blocks))
        res = out[f"sharded/tol{tol}/b{blocks}"]
        assert int(res["iterations"]) == int(jres.iterations)
        assert _rel(res["sample"], jres.sample) < REL
        _history_close(res["delta_history"], jres.delta_history)


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_equals_jax_sharded_sampler(request, jax_run, w):
    """The same run as JAX's ``make_sharded_sampler`` on ``w`` fake
    devices: iterations equal, samples within 1e-12."""
    res = _world(request, w)[0]["sharded/tol0.0001/b8"]
    jres = jax_run.get()[f"sharded{w}"]
    assert int(res["iterations"]) == jres["iterations"]
    assert _rel(res["sample"], jres["sample"]) < REL
    _history_close(res["delta_history"], jres["delta_history"])


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("tol", [0.0, 1e-4])
@pytest.mark.parametrize("blocks", [8, 16])
def test_sharded_truncated_equals_untruncated(request, w, tol, blocks):
    """The truncated suffix redistributed over the ranks (padded chunks,
    ranks past the suffix idle) gives the untruncated run's bits."""
    out = _world(request, w)[0]
    full = out[f"truncFalse/tol{tol}/b{blocks}"]
    trunc = out[f"truncTrue/tol{tol}/b{blocks}"]
    assert _same(trunc, full)
    if tol == 0.0:
        assert np.max(np.abs(trunc["sample"] - out["seq_elem"])) < EXACT


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_window_policies(request, w):
    """``window=ExactPrefix()`` is ``truncate=True``; the residual window
    stays close to the sequential sample at its tolerance."""
    out = _world(request, w)[0]
    assert _same(out["window/exact_prefix"], out["truncTrue/tol0.0001/b8"])
    assert np.max(np.abs(out["window/residual"]["sample"]
                         - out["seq_elem"])) < 5e-2


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_stragglers_keep_exactness(request, w):
    """Stale fine results for blocks 3 and 5 at odd refinements cost
    iterations, never the sample: at ``tol=0`` the run still equals the
    sequential sample."""
    out = _world(request, w)[0]
    strag = out["straggler/tol0.0"]
    assert int(strag["iterations"]) == 24
    assert np.max(np.abs(strag["sample"] - out["seq"])) < EXACT
    assert int(out["straggler/tol1e-06"]["iterations"]) >= \
        int(out["no_straggler/tol1e-06"]["iterations"])
    assert not _same(out["straggler/tol1e-06"]["delta_history"],
                     out["no_straggler/tol1e-06"]["delta_history"])


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_refusals(request, w):
    out = _world(request, w)[0]
    assert "straggler" in out["refused/trunc_straggler"]
    assert "straggler" in out["refused/accel_straggler"]
    assert "not divisible" in out["refused/indivisible"]


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_per_sample_equals_independent_runs(request, w):
    """A ``(K,)`` runtime tol: each lane stops at its own iteration, equal
    to its own single-lane run and to JAX's per-sample ``srds_sample``."""
    out = _world(request, w)[0]
    res = out["per_sample/sharded"]
    its = res["iterations"]
    assert its.shape == (4,) and res["delta_history"].shape == (8, 4)
    assert len(set(its.tolist())) > 1
    for i, lane in enumerate(out["per_sample/lanes"]):
        assert int(its[i]) == int(lane["iterations"])
        assert _rel(res["sample"][i], lane["sample"][0]) < REL
    jres = J.srds_sample(_jmodel(), _jsched(cases.N), J.SolverConfig("ddim"),
                         jnp.asarray(cases.xb()),
                         J.SRDSConfig(per_sample=True, num_blocks=8),
                         tol=jnp.asarray(cases.XB_TOLS))
    assert np.array_equal(its, np.asarray(jres.iterations))
    assert _rel(res["sample"], jres.sample) < REL


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_host_reads_no_more_than_single_program(request, w):
    out = _world(request, w)[0]
    assert 0 < out["reads/sharded"] <= out["reads/single"]


def test_data_axis_maps_lanes_as_jax(world4):
    """On a (2, 2, 1) mesh rank r sits at (time r // 2, data r % 2); data
    rank d runs lanes [2d, 2d + 2): the result equals the single
    program's per-sample run, lane for lane, with a vector or a scalar
    runtime tol, truncated or not."""
    assert [r["data/coords"] for r in world4] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    out = world4[0]
    assert _same(out["data/vector_tol"], out["data/single_vector"])
    assert _same(out["data/scalar_tol"], out["data/single_scalar"])
    assert _same(out["data/truncated"], out["data/single_vector"])
    assert len(set(out["data/vector_tol"]["iterations"].tolist())) > 1


def test_data_axis_refusals(world4):
    out = world4[0]
    assert "per_sample" in out["data/refused_joint"]
    assert "not divisible" in out["data/refused_k"]


def test_data_axis_equals_jax_per_sample(world4):
    scale = jnp.asarray(cases.SCALE)
    jres = J.srds_sample(lambda x, t: jnp.tanh(x * scale) * (0.5 + 0.001 * t),
                         _jsched(cases.N), J.SolverConfig("ddim"),
                         jnp.asarray(cases.xb()),
                         J.SRDSConfig(per_sample=True, num_blocks=8),
                         tol=jnp.asarray(cases.XB_TOLS))
    res = world4[0]["data/vector_tol"]
    assert np.array_equal(res["iterations"], np.asarray(jres.iterations))
    assert _rel(res["sample"], jres.sample) < REL


# --------------------------------------------------------------------------
# the wavefront at N=25, B=5 on 5 gloo ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(cases.WAVEFRONT))
def test_wavefront_counts_equal_jax(world5, jax_run, case):
    """Iterations, supersteps and physical evals equal JAX's
    ``make_pipelined_sampler`` on 5 fake devices; samples within 1e-12."""
    got = world5[0][f"wf/{case}"]
    want = jax_run.get()[f"wf/{case}"]
    assert np.array_equal(got["iterations"], want["iterations"])
    assert (got["supersteps"], got["evals"]) == (want["supersteps"],
                                                 want["evals"])
    assert _rel(got["sample"], want["sample"]) < REL
    _history_close(got["delta_history"], want["delta_history"])
    _history_close(got["final_delta"], want["final_delta"])


def test_wavefront_ranks_return_the_same_bits(world5):
    for r in world5[1:]:
        assert _same(_results(r), _results(world5[0]))


def test_wavefront_exact_and_superstep_model(world5):
    """At ``tol=0``: the sequential sample; supersteps within ``k*S + B +
    2``; retirement keeps physical evals under every rank evaluating at
    every superstep."""
    out = world5[0]
    res = out["wf/tol0"]
    k, s_steps, b = int(res["iterations"]), 25 // 5, 5
    assert np.max(np.abs(res["sample"] - out["seq/tol0"])) < EXACT
    assert res["supersteps"] <= k * s_steps + b + 2
    assert 0 < res["evals"] < res["supersteps"] * b * 2


def test_wavefront_early_convergence(world5):
    out = world5[0]
    res = out["wf/tol1e-4"]
    k = int(res["iterations"])
    assert k < 5
    assert k == int(out["single/tol1e-4"]["iterations"])
    assert np.mean(np.abs(res["sample"] - out["seq/tol1e-4"])) < 1e-3
    assert res["supersteps"] < 25


def test_wavefront_per_sample_done_flag(world5):
    """Per sample: the loop runs to the slowest lane; each lane stops at
    the single program's per-sample iteration and freezes there."""
    out = world5[0]
    res = out["wf/per_sample"]
    it = res["iterations"]
    assert it.shape == (2,) and res["delta_history"].shape == (5, 2)
    assert it.min() >= 1 and it.max() <= 5
    assert res["supersteps"] >= (int(it.max()) - 1) * 5 + 5
    for k in range(2):
        h = res["delta_history"][:, k]
        assert np.all(np.isfinite(h[:it[k]])) and np.all(np.isinf(h[it[k]:]))
    assert np.array_equal(it, out["single/per_sample"]["iterations"])
    assert np.mean(np.abs(res["sample"] - out["seq/per_sample"])) < 1e-3


def test_wavefront_short_blocks_respect_iteration_budget(world5):
    """S = 2: the superstep budget's ramp slack completes no uncounted
    refinement."""
    out = world5[0]
    res = out["wf/short_blocks"]
    k = int(res["iterations"])
    assert k <= 5
    assert float(res["final_delta"]) == float(res["delta_history"][k - 1])
    assert np.max(np.abs(res["sample"] - out["seq/short_blocks"])) < EXACT


def test_wavefront_retirement_against_fixed_budget(world5):
    """``FixedBudget`` turns retirement off: the same result and
    supersteps, strictly more physical evals."""
    out = world5[0]
    ret, fixed = out["wf/tol0"], out["wf/fixed_budget"]
    assert np.max(np.abs(ret["sample"] - fixed["sample"])) < 1e-12
    assert np.array_equal(ret["iterations"], fixed["iterations"])
    assert ret["supersteps"] == fixed["supersteps"]
    assert fixed["evals"] > ret["evals"]


def test_wavefront_reads_one_flag_per_refinement(world5):
    """The exit test reads the host once per refinement of the last
    block, not once per superstep."""
    for case in cases.WAVEFRONT:
        res = world5[0][f"wf/{case}"]
        assert res["flag_reads"] == int(np.max(res["iterations"])), case
        assert res["flag_reads"] < res["supersteps"]


def test_wavefront_refusals(world5):
    out = world5[0]
    assert "Accelerator" in out["refused/accel"]
    assert "divisible" in out["refused/n"]


def test_delta_history_contract_across_samplers(world5):
    """The sharded, single-program and wavefront samplers share the
    history contract: (max_iters,) f32, finite up to ``iterations``, +inf
    after, ``final_delta`` its last entry; the wavefront's residuals are
    the engine's."""
    out = world5[0]
    runs = [out["sharded/tol1e-4"], out["single/tol1e-4"],
            out["wf/tol1e-4"]]
    for res in runs:
        k, h = int(res["iterations"]), res["delta_history"]
        assert h.shape == (5,) and h.dtype == np.float32
        assert np.all(np.isfinite(h[:k])) and np.all(np.isinf(h[k:]))
        assert float(res["final_delta"]) == float(h[k - 1])
    assert _same(runs[0], runs[1]) or _rel(runs[0]["sample"],
                                           runs[1]["sample"]) < REL
    k = min(int(runs[2]["iterations"]), int(runs[1]["iterations"]))
    np.testing.assert_allclose(runs[2]["delta_history"][:k],
                               runs[1]["delta_history"][:k], rtol=1e-4,
                               atol=1e-9)


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    for fn in (tmesh.make_srds_mesh, tmesh.make_test_mesh,
               tmesh.init_process_group, tmesh.spawn_ranks):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda"
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.init_process_group("/nonexistent", 0, 1)


# --------------------------------------------------------------------------
# the emitters of Tables 3 and 6
# --------------------------------------------------------------------------

def test_table3_wavefront_leg_equals_jax(world5, jax_run):
    """table3's wavefront leg at (25, 5): supersteps, iterations and
    physical evals equal JAX's sampler on the same toy; the sample is the
    sequential one's; every rank reports its peak memory."""
    got = world5[0]["table3"]
    want = jax_run.get()["table3"]
    assert (got["supersteps"], got["iters"], got["evals"]) == \
        (want["supersteps"], want["iters"], want["evals"])
    assert got["err"] < 1e-3
    assert all(0 < r["table3"]["anon_gb"] <= r["table3"]["peak_rss_gb"]
               for r in world5)


def test_table3_rows(world5, monkeypatch, capsys):
    """A row joins the vanilla leg and the wavefront leg (JAX's fields
    plus ``wf_rss_gb``); a case too large for the host says why."""
    from repro_torch.benchmarks import common, table3_pipelined as t3
    leg = dict(world5[0]["table3"],
               **{k: sum(r["table3"][k] for r in world5)
                  for k in ("anon_gb", "peak_rss_gb")})
    monkeypatch.setattr(t3, "wavefront", lambda n, b: dict(leg))
    row, = t3.rows(common.toy_denoiser("cpu"),
                   common.toy_array("x0_table3", "cpu"), cases=((25, 5),),
                   repeats=1)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("table3/ddim25,")
    assert (f"seq_evals=25;vanilla_eff={row['vanilla_eff']};"
            f"pipelined_supersteps={leg['supersteps']};"
            f"pipelined_iters={leg['iters']};wf_evals={leg['evals']};") \
        in line
    assert row["eff_serial_pipelined"] == 5 + row["iters"] * (5 + 1)
    monkeypatch.undo()
    monkeypatch.setattr(t3, "available_gb", lambda: 4.0)
    skipped = t3.wavefront(961, 31)
    assert "31 ranks need" in skipped["skipped"]


@pytest.mark.parametrize("w", [2, 4])
def test_table6_rank_body_equals_single_program(request, w, x32):
    """table6's sampler at ``w`` ranks stops where JAX's and the port's
    single programs do on its toy (f32, JAX's weights)."""
    from repro_torch.benchmarks import common
    res = _world(request, w)[0]["table6"]
    assert res["backend"] == "gloo" and res["t"] > 0
    wt = common.toy_inputs()["table6_w"]
    x0 = common.toy_inputs()["x0_table6"]
    jw = jnp.asarray(wt)
    jres = J.srds_sample(lambda x, t: jnp.tanh(x @ jw) * (0.4 + 3e-4 * t),
                         J.make_schedule("ddpm_linear", 100),
                         J.SolverConfig("ddim"), jnp.asarray(x0),
                         J.SRDSConfig(tol=1e-4, num_blocks=20))
    assert res["iters"] == int(jres.iterations)


def test_table6_rows(capsys):
    """One rank of gloo through ``main``; the mesh row names A10(b)."""
    from repro_torch.benchmarks import table6_devices
    rows = table6_devices.main(device="cpu", worlds=(1,))
    assert [r["name"] for r in rows] == ["table6/devices1",
                                         "table6/mesh_t2d2m2"]
    assert rows[0]["backend"] == "gloo" and rows[0]["iterations"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "table6/mesh_t2d2m2,-1.0,A10(b)"
