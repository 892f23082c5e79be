"""The port's SRDS core against the JAX package, and its own guarantees.

Toy denoisers (the ``_model()`` of tests/test_core_srds.py and the
elementwise toy of tests/test_batched_srds.py) get their weights and
inputs from numpy, in f64 on both sides (JAX under x64, dtypes pinned).

Tolerances: iteration counts and eval accounting are integers and must be
equal; samples agree to 1e-10 (f64 roundoff over an N-step solve); the
residual history is f32 and agrees to 1e-5 relative, or 1e-12 absolute
where a residual is so small that the f64 roundoff of the two trajectories
it differences dominates it.  Within the port,
``srds_sample`` at ``max_iters=B`` equals ``sample_sequential`` to 1e-10
(Prop 1), and a per-sample K-batch of the elementwise toy equals K single
runs bitwise; so does a truncated run the untruncated one.  Window
histories and eval prices are integers and must be equal.  The
acceleration tests run the table13 bench toy in f32 on both sides (its
parameters handed over through numpy): iteration counts must be equal,
samples agree to 1e-4 of their scale (an f32 solve, with mixing
coefficients solved in f32 in two frameworks).  Per-block L1 sums are f32
sums and agree to 1e-6 relative.
"""
import jax

jax.config.update("jax_enable_x64", True)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from conftest import REPO
from repro.core.schedules import DiffusionSchedule as JSchedule

SAMPLE_TOL = 1e-10
HIST_RTOL = 1e-5
HIST_ATOL = 1e-12
TOLS = [1e-2, 1e-4, 1e-6, 1e-3, 1e-5]
W = (np.random.default_rng(0).standard_normal((8, 8)) * 0.3)
SCALE = np.linspace(0.5, 1.5, 8)


def _jax_f64(sched):
    return JSchedule(ab=jnp.asarray(sched.ab, jnp.float64),
                     t_model=jnp.asarray(sched.t_model, jnp.float64),
                     kind=sched.kind)


def _scheds(n, kind="ddpm_linear"):
    j = J.make_schedule(kind, n)
    t = T.make_schedule(kind, n)
    return _jax_f64(j), t.astype(np.float64)


def _jax_matmul(x, t):
    return jnp.tanh(x @ jnp.asarray(W)) * (0.5 + 0.001 * t)


def _torch_matmul(x, t):
    return torch.tanh(x @ torch.from_numpy(W)) * (0.5 + 0.001 * t[:, None])


def _torch_elementwise(x, t):
    return torch.tanh(x * torch.from_numpy(SCALE)) * (0.5 + 0.001 * t[:, None])


def _x0(k=3, seed=1):
    x = np.random.default_rng(seed).standard_normal((k, 8))
    return x * np.linspace(0.3, 2.5, k)[:, None]


@pytest.mark.parametrize("kind", ["ddpm_linear", "cosine", "karras"])
@pytest.mark.parametrize("n", [16, 25, 64])
def test_schedules_equal_jax_exactly(kind, n):
    j, t = J.make_schedule(kind, n), T.make_schedule(kind, n)
    np.testing.assert_array_equal(t.ab, np.asarray(j.ab))
    np.testing.assert_array_equal(t.t_model, np.asarray(j.t_model))
    assert t.num_steps == j.num_steps == n


@pytest.mark.parametrize("solver", ["ddim", "euler", "heun", "dpm2", "ddpm"])
@pytest.mark.parametrize("n", [16, 25, 36])
def test_srds_at_cap_equals_sequential(solver, n):
    """Prop 1 within the port: ``max_iters=B`` reproduces the serial solve
    (``ddpm`` with its native frozen noise, which other solvers ignore)."""
    _, sched = _scheds(n)
    cfg = T.SolverConfig(solver, noise_seed=5)
    x0 = torch.from_numpy(_x0())
    seq = T.sample_sequential(_torch_matmul, sched, cfg, x0)
    res = T.srds_sample(_torch_matmul, sched, cfg, x0, T.SRDSConfig(tol=0.0))
    torch.testing.assert_close(res.sample, seq, atol=SAMPLE_TOL, rtol=0)
    b, _ = T.resolve_blocks(n, None)
    assert int(res.iterations) == b


@pytest.mark.parametrize("solver", ["ddim", "heun", "dpm2"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_srds_matches_jax(solver, per_sample):
    """Iteration counts equal JAX's exactly; samples and residual history
    agree within the stated tolerances."""
    jsched, tsched = _scheds(64)
    x0 = _x0()
    tol = 1e-5
    jres = J.srds_sample(_jax_matmul, jsched, J.SolverConfig(solver),
                         jnp.asarray(x0, jnp.float64),
                         J.SRDSConfig(tol=tol, per_sample=per_sample))
    tres = T.srds_sample(_torch_matmul, tsched, T.SolverConfig(solver),
                         torch.from_numpy(x0),
                         T.SRDSConfig(tol=tol, per_sample=per_sample))
    hist = np.asarray(jres.delta_history)
    live = np.isfinite(hist)
    # the gate is decided away from any residual: no rounding can flip it
    assert np.all(np.abs(np.log(hist[live] / tol)) > 0.05)
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_TOL, rtol=0)
    np.testing.assert_allclose(tres.delta_history.numpy(), hist,
                               rtol=HIST_RTOL, atol=HIST_ATOL)
    np.testing.assert_allclose(tres.final_delta.numpy(),
                               np.asarray(jres.final_delta),
                               rtol=HIST_RTOL, atol=HIST_ATOL)


@pytest.mark.parametrize("norm", ["l1_mean", "l2_mean", "linf"])
def test_norms_and_fixed_iters_match_jax(norm):
    jsched, tsched = _scheds(36)
    x0 = _x0()
    cfg = dict(tol=1e-3, norm=norm, fixed_iters=True, max_iters=4)
    jres = J.srds_sample(_jax_matmul, jsched, J.SolverConfig("ddim"),
                         jnp.asarray(x0, jnp.float64), J.SRDSConfig(**cfg))
    tres = T.srds_sample(_torch_matmul, tsched, T.SolverConfig("ddim"),
                         torch.from_numpy(x0), T.SRDSConfig(**cfg))
    assert int(tres.iterations) == int(jres.iterations) == 4
    np.testing.assert_allclose(tres.delta_history.numpy(),
                               np.asarray(jres.delta_history),
                               rtol=HIST_RTOL, atol=HIST_ATOL)
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_TOL, rtol=0)


@pytest.mark.parametrize("solver", ["ddim", "heun"])
@pytest.mark.parametrize("use_fused", [None, True])
def test_batched_bit_identical_to_independent_runs(solver, use_fused):
    """Per-sample gating under a mixed-tol vector == K single runs, bit for
    bit (elementwise toy; ``use_fused=True`` runs the kernels' plain
    versions on the CPU)."""
    _, sched = _scheds(64)
    cfg = T.SolverConfig(solver, use_fused_kernel=use_fused)
    X = torch.from_numpy(_x0(len(TOLS)))
    res = T.srds_sample(_torch_elementwise, sched, cfg, X,
                        T.SRDSConfig(per_sample=True,
                                     use_fused_update=use_fused),
                        tol=torch.tensor(TOLS, dtype=torch.float32))
    assert res.iterations.shape == (len(TOLS),)
    assert res.delta_history.shape == (8, len(TOLS))
    assert len(set(res.iterations.tolist())) > 1
    for k, tol in enumerate(TOLS):
        ind = T.srds_sample(_torch_elementwise, sched, cfg, X[k:k + 1],
                            T.SRDSConfig(tol=tol, use_fused_update=use_fused))
        assert torch.equal(res.sample[k], ind.sample[0]), k
        assert int(res.iterations[k]) == int(ind.iterations), k
        assert res.final_delta[k].item() == ind.final_delta.item(), k
        assert torch.equal(res.delta_history[:, k], ind.delta_history), k


def test_batched_matmul_model_near_exact():
    _, sched = _scheds(64)
    X = torch.from_numpy(_x0(4))
    res = T.srds_sample(_torch_matmul, sched, T.SolverConfig("ddim"), X,
                        T.SRDSConfig(per_sample=True),
                        tol=torch.tensor(TOLS[:4], dtype=torch.float32))
    for k, tol in enumerate(TOLS[:4]):
        ind = T.srds_sample(_torch_matmul, sched, T.SolverConfig("ddim"),
                            X[k:k + 1], T.SRDSConfig(tol=tol))
        assert int(res.iterations[k]) == int(ind.iterations), k
        torch.testing.assert_close(res.sample[k], ind.sample[0],
                                   atol=1e-12, rtol=0)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("use_fused", [False, True])
def test_corrector_sweep_matches_jax(use_fused, batched):
    """The sweep with its in-sweep residual feed (fused: the kernel's plain
    version here, the Pallas kernel in interpret mode in JAX) on a toy
    elementwise G, f32 on both sides."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    B, K = 4, 3
    rng = np.random.default_rng(5)
    x0, y, prev, old = (rng.standard_normal(s).astype(np.float32)
                        for s in [(K, 6), (B, K, 6), (B, K, 6), (B, K, 6)])
    starts = np.arange(B) * 3

    def jG(x, i0):
        return x * 0.9 + 0.01 * i0.astype(jnp.float32)

    def tG(x, i0):
        return x * 0.9 + 0.01 * i0

    jt, jc, jr = jeng.corrector_sweep(
        jG, jnp.asarray(x0), jnp.asarray(y), jnp.asarray(prev),
        jnp.asarray(starts, jnp.int32), use_fused=use_fused,
        residual_from=jnp.asarray(old), batched=batched)
    tt, tc, tr = teng.corrector_sweep(
        tG, torch.from_numpy(x0), torch.from_numpy(y),
        torch.from_numpy(prev), starts, use_fused=use_fused,
        residual_from=torch.from_numpy(old), batched=batched)
    assert tr.shape == ((B, K) if batched else (B,))
    for t, j in [(tt, jt), (tc, jc), (tr, jr)]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_eval_accounting_matches_jax():
    for n, b in [(25, 5), (64, None), (36, 4)]:
        assert T.resolve_blocks(n, b) == J.resolve_blocks(n, b)
        assert tuple(T.iteration_cost(n, b, 2)) == \
            tuple(J.iteration_cost(n, b, 2))
        for solver in ("ddim", "heun"):
            for it in (0, 1, 3):
                t = T.srds_stats(T.make_schedule("ddpm_linear", n),
                                 T.SolverConfig(solver),
                                 T.SRDSConfig(num_blocks=b), it)
                j = J.srds_stats(J.make_schedule("ddpm_linear", n),
                                 J.SolverConfig(solver),
                                 J.SRDSConfig(num_blocks=b), it)
                assert (t.serial_evals, t.total_evals, t.iterations) == \
                    (j.serial_evals, j.total_evals, j.iterations)
    for solver in ("ddim", "dpm2"):
        t = T.sequential_stats(T.make_schedule("ddpm_linear", 25),
                               T.SolverConfig(solver))
        j = J.sequential_stats(J.make_schedule("ddpm_linear", 25),
                               J.SolverConfig(solver))
        assert (t.serial_evals, t.total_evals) == \
            (j.serial_evals, j.total_evals)
    assert T.solver_names() == J.solver_names()
    for n in (13, 37):
        with pytest.raises(ValueError, match="prime"):
            T.resolve_blocks(n, None)
    with pytest.raises(ValueError, match="does not divide"):
        T.resolve_blocks(100, 7)


def test_unported_paths_raise_naming_their_roadmap_item():
    """What is left unported raises and names its ROADMAP item: JAX's
    in-program block sharding, which has no torch counterpart, names the
    port's sharded driver (A10) and the dryrun (A12).  The serving
    engine's mesh options are ported (A10(b); on gloo ranks in
    ``tests/test_torch_model_parallel.py``): here they reach their own
    checks, a model-parallel denoiser without a mesh needs one, and no
    message of the port names A10(b).  Straggler reuse and wavefront
    pricing are ported (``tests/test_torch_pipelined.py``), and so is the
    ddpm solver (A3): it runs, in the samplers and behind the engine's
    ``allow_inexact``."""
    from repro_torch.core import engine as teng
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    _, sched = _scheds(16)
    x0 = torch.from_numpy(_x0())
    ddpm = T.SolverConfig("ddpm", noise_seed=0)
    seq = T.sample_sequential(_torch_matmul, sched, ddpm, x0)
    assert seq.shape == x0.shape and bool(torch.isfinite(seq).all())
    with pytest.raises(NotImplementedError,
                       match="make_sharded_sampler.*A10.*A12"):
        T.srds_sample(_torch_matmul, sched, T.SolverConfig("ddim"), x0,
                      T.SRDSConfig(block_sharding=object()))
    assert T.srds_stats(sched, T.SolverConfig("ddim"), T.SRDSConfig(), 2,
                        pipelined=True).serial_evals == 4 + 2 * (4 + 1)
    with pytest.raises(NotImplementedError, match="make_sharded_sampler"):
        teng.run_parareal(None, None, x0, np.arange(4) * 4, tol=0.0,
                          max_iters=4, constrain=lambda t: t)
    for kw in (dict(axis="time"), dict(data_axis="data")):
        with pytest.raises(ValueError, match="require a mesh"):
            DiffusionSamplingEngine(_torch_matmul, (8,), device="cpu", **kw)
    mp = T.Denoiser(fn=_torch_matmul, shard_fn=lambda x, t, mesh: x,
                    in_spec=(None, "model"), out_spec=(None, "model"),
                    mesh_axes={"model": 1})
    with pytest.raises(ValueError, match="needs a mesh"):
        DiffusionSamplingEngine(mp, (8,), device="cpu")
    src = os.path.join(REPO, "src", "repro_torch")
    for root, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert "A10(b)" not in fh.read(), f
    eng = DiffusionSamplingEngine(_torch_matmul, (8,), device="cpu",
                                  allow_inexact=True, num_steps=16,
                                  dtype=torch.float64)
    rid = eng.submit(SampleRequest(seed=0, solver=ddpm))
    assert np.isfinite(eng.drain()[rid].sample).all()


# --------------------------------------------------------------------------
# truncation, frontier windows and acceleration (ROADMAP A5, A7)
# --------------------------------------------------------------------------

def _elementwise_pair():
    scale = jnp.asarray(SCALE)

    def jmodel(x, t):
        return jnp.tanh(x * scale) * (0.5 + 0.001 * t)

    return jmodel, _torch_elementwise


def _t_policy(policy):
    """The port's twin of a JAX frontier policy or accelerator."""
    import dataclasses as dc
    import repro_torch.core.accel as taccel
    import repro_torch.core.window as twindow
    mod = twindow if isinstance(policy, J.FrontierPolicy) else taccel
    return getattr(mod, type(policy).__name__)(**dc.asdict(policy))


@pytest.mark.parametrize("solver", ["ddim", "heun"])
@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_truncated_bit_identical_to_untruncated(solver, tol):
    """Within the port, truncation changes no bit of the sample, the
    iteration count or the residual history (elementwise toy), and takes
    JAX's truncated run's iterations."""
    jmodel, tmodel = _elementwise_pair()
    jsched, tsched = _scheds(64)
    x0 = _x0()
    a = T.srds_sample(tmodel, tsched, T.SolverConfig(solver),
                      torch.from_numpy(x0), T.SRDSConfig(tol=tol))
    b = T.srds_sample(tmodel, tsched, T.SolverConfig(solver),
                      torch.from_numpy(x0), T.SRDSConfig(tol=tol,
                                                         truncate=True))
    assert torch.equal(a.sample, b.sample)
    assert int(a.iterations) == int(b.iterations)
    assert torch.equal(a.delta_history, b.delta_history)
    j = J.srds_sample(jmodel, jsched, J.SolverConfig(solver),
                      jnp.asarray(x0), J.SRDSConfig(tol=tol, truncate=True))
    assert int(b.iterations) == int(j.iterations)
    np.testing.assert_allclose(b.sample.numpy(), np.asarray(j.sample),
                               atol=SAMPLE_TOL, rtol=0)


@pytest.mark.parametrize("mode", ["per_sample", "fixed_iters"])
def test_truncated_gating_modes_bit_identical(mode):
    """Truncation composes with per-sample gating under a mixed-tol
    vector and with fixed-budget runs, bitwise within the port."""
    _, tmodel = _elementwise_pair()
    _, sched = _scheds(64)
    if mode == "per_sample":
        X = torch.from_numpy(_x0(len(TOLS)))
        kw, tol = dict(per_sample=True), torch.tensor(TOLS,
                                                      dtype=torch.float32)
    else:
        X = torch.from_numpy(_x0())
        kw, tol = dict(fixed_iters=True, max_iters=5), None
    a = T.srds_sample(tmodel, sched, T.SolverConfig("ddim"), X,
                      T.SRDSConfig(**kw), tol=tol)
    b = T.srds_sample(tmodel, sched, T.SolverConfig("ddim"), X,
                      T.SRDSConfig(truncate=True, **kw), tol=tol)
    assert torch.equal(a.sample, b.sample)
    assert torch.equal(a.iterations, b.iterations)
    assert torch.equal(a.delta_history, b.delta_history)


def test_truncated_to_cap_equals_sequential():
    _, tmodel = _elementwise_pair()
    _, sched = _scheds(36)
    x0 = torch.from_numpy(_x0())
    ref = T.sample_sequential(tmodel, sched, T.SolverConfig("ddim"), x0)
    res = T.srds_sample(tmodel, sched, T.SolverConfig("ddim"), x0,
                        T.SRDSConfig(tol=0.0, truncate=True))
    torch.testing.assert_close(res.sample, ref, atol=1e-12, rtol=0)


def test_truncated_and_windowed_accounting_matches_jax():
    """Frontier schedules, per-window prices, truncated and windowed
    totals and ``srds_stats`` under every policy: equal integers."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    assert [T.prefix_frontier(p) for p in range(7)] == \
        [jeng.prefix_frontier(p) for p in range(7)]
    for n, b, e in [(100, None, 1), (64, 8, 2), (36, 4, 1), (25, 5, 1)]:
        tc, jc = T.iteration_cost(n, b, e), J.iteration_cost(n, b, e)
        assert tuple(tc) == tuple(jc)
        for lo in range(tc.num_blocks + 2):
            assert tc.refine_evals_at(lo) == jc.refine_evals_at(lo)
            for hi in (None, 1, tc.num_blocks // 2, tc.num_blocks):
                assert tc.refine_evals_window(lo, hi) == \
                    jc.refine_evals_window(lo, hi)
        for it in (0, 1, 2, 3, 2.5, tc.num_blocks):
            assert T.truncated_evals(tc, it) == jeng.truncated_evals(jc, it)
        hist = np.array([[0, 0], [0, 0], [1, 2], [3, -1], [-1, -1]])
        assert np.array_equal(teng.windowed_evals(tc, hist),
                              jeng.windowed_evals(jc, hist))
        assert teng.windowed_evals(tc, hist[:, 0]) == \
            jeng.windowed_evals(jc, hist[:, 0])
        for pol in (None, J.ExactPrefix(), J.ResidualWindow(1e-3),
                    J.FixedBudget()):
            tpol = None if pol is None else _t_policy(pol)
            for solver in ("ddim", "heun"):
                for it in (0, 1, 3, 4):
                    t = T.srds_stats(T.make_schedule("ddpm_linear", n),
                                     T.SolverConfig(solver),
                                     T.SRDSConfig(num_blocks=b, window=tpol,
                                                  truncate=pol is None), it)
                    j = J.srds_stats(J.make_schedule("ddpm_linear", n),
                                     J.SolverConfig(solver),
                                     J.SRDSConfig(num_blocks=b, window=pol,
                                                  truncate=pol is None), it)
                    assert (t.serial_evals, t.total_evals) == \
                        (j.serial_evals, j.total_evals)


def test_frontier_policies_unit_semantics_match_jax():
    """resolve_policy, static frontiers, retire_at and ResidualWindow's
    advance on numpy and torch (scalar and per-sample bounds) against the
    JAX policies."""
    from repro_torch.core.window import resolve_policy
    assert isinstance(resolve_policy(None, True), T.ExactPrefix)
    assert isinstance(resolve_policy(None, False), T.FixedBudget)
    with pytest.raises(TypeError, match="FrontierPolicy"):
        resolve_policy("exact", False)
    for pol in (J.ExactPrefix(), J.ResidualWindow(1e-3), J.FixedBudget()):
        tpol = _t_policy(pol)
        assert (tpol.truncates, tpol.exact, tpol.needs_block_residuals) == \
            (pol.truncates, pol.exact, pol.needs_block_residuals)
        assert [tpol.static_frontier(p, 6) for p in range(9)] == \
            [pol.static_frontier(p, 6) for p in range(9)]
        for i in range(8):
            assert int(tpol.retire_at(i, 8, 5)) == \
                int(pol.retire_at(i, 8, 5))
            assert int(tpol.retire_at(torch.tensor(i), 8, 5)) == \
                int(pol.retire_at(i, 8, 5))
    jpol, tpol = J.ResidualWindow(1e-3), T.ResidualWindow(1e-3)
    r = np.asarray([1e-5, 1e-4, 5e-1, 1e-6, 1e-6, 1e-6], np.float32)
    rk = np.asarray([[1e-5, 1e-1], [1e-5, 1e-5], [1e-1, 1e-5]], np.float32)
    for lo in range(6):
        want = int(jpol.advance(lo, jnp.asarray(r), 6))
        assert int(tpol.advance(lo, r, 6)) == want
        assert int(tpol.advance(torch.tensor(lo), torch.from_numpy(r),
                                6)) == want
    for lo in ([0, 0], [0, 1], [2, 0]):
        want = np.asarray(jpol.advance(jnp.asarray(lo, jnp.int32),
                                       jnp.asarray(rk), 3))
        assert np.array_equal(tpol.advance(np.asarray(lo, np.int32), rk, 3),
                              want)
        got = tpol.advance(torch.tensor(lo, dtype=torch.int32),
                           torch.from_numpy(rk), 3)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("policy", ["exact_prefix", "residual_window",
                                    "fixed_budget"])
def test_window_policies_match_jax(policy, per_sample):
    """Each frontier policy, joint and per sample: the JAX run's
    iterations and window history, its realized eval bill, and its
    sample within 1e-10 (matmul toy)."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    pol = {"exact_prefix": J.ExactPrefix(),
           "residual_window": J.ResidualWindow(window_tol=1e-3),
           "fixed_budget": J.FixedBudget()}[policy]
    jsched, tsched = _scheds(64)
    x0 = _x0(len(TOLS))
    tol = 1e-5
    jres = J.srds_sample(_jax_matmul, jsched, J.SolverConfig("ddim"),
                         jnp.asarray(x0, jnp.float64),
                         J.SRDSConfig(tol=tol, per_sample=per_sample,
                                      window=pol))
    tres = T.srds_sample(_torch_matmul, tsched, T.SolverConfig("ddim"),
                         torch.from_numpy(x0),
                         T.SRDSConfig(tol=tol, per_sample=per_sample,
                                      window=_t_policy(pol)))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_TOL, rtol=0)
    np.testing.assert_allclose(tres.delta_history.numpy(),
                               np.asarray(jres.delta_history),
                               rtol=HIST_RTOL, atol=HIST_ATOL)
    if jres.window_history is None:
        assert tres.window_history is None
        return
    wh = np.asarray(jres.window_history)
    np.testing.assert_array_equal(tres.window_history.numpy(), wh)
    cost = T.iteration_cost(64)
    assert np.array_equal(teng.windowed_evals(cost, tres.window_history),
                          jeng.windowed_evals(J.iteration_cost(64), wh))


@pytest.mark.parametrize("batched", [False, True])
def test_corrector_sweep_frozen_and_blockwise_norm_match_jax(batched):
    """The residual-window mask inside the sweep (frozen blocks keep
    their old values and report 0) and the per-block norms."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    B, K = 4, 3
    rng = np.random.default_rng(7)
    x0, y, prev, old = (rng.standard_normal(s) for s in
                        [(K, 6), (B, K, 6), (B, K, 6), (B, K, 6)])
    frozen = (np.array([[1, 0, 1], [1, 1, 0], [0, 0, 0], [0, 1, 0]], bool)
              if batched else np.array([1, 1, 0, 0], bool))
    starts = np.arange(B) * 3

    def jG(x, i0):
        return x * 0.9 + 0.01 * i0.astype(jnp.float64)

    def tG(x, i0):
        return x * 0.9 + 0.01 * i0

    j = jeng.corrector_sweep(jG, jnp.asarray(x0), jnp.asarray(y),
                             jnp.asarray(prev), jnp.asarray(starts),
                             residual_from=jnp.asarray(old), batched=batched,
                             frozen=jnp.asarray(frozen))
    t = teng.corrector_sweep(tG, torch.from_numpy(x0), torch.from_numpy(y),
                             torch.from_numpy(prev), starts,
                             residual_from=torch.from_numpy(old),
                             batched=batched,
                             frozen=torch.from_numpy(frozen))
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    # the per-block L1 sums are f32 sums (in two summation orders)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-6)
    assert np.all(t[2].numpy()[frozen] == 0)
    for norm in ("l1_mean", "l2_mean", "linf"):
        np.testing.assert_allclose(
            teng.blockwise_norm(torch.from_numpy(y), norm,
                                batched=batched).numpy(),
            np.asarray(jeng.blockwise_norm(jnp.asarray(y), norm,
                                           batched=batched)), rtol=1e-6)
    with pytest.raises(ValueError, match="residual_from"):
        teng.corrector_sweep(tG, torch.from_numpy(x0), torch.from_numpy(y),
                             torch.from_numpy(prev), starts,
                             frozen=torch.from_numpy(frozen))


@pytest.mark.parametrize("norm", ["l2_mean", "linf"])
def test_fused_l2_and_linf_match_jax(norm):
    """``norm='l2_mean'``/``'linf'`` through the fused path: the sweep
    runs ``parareal_update`` (on the CPU its plain twin; the Pallas kernel
    in interpret mode in JAX).  The kernel computes in f32, so both sides
    run the matmul toy in f32: samples agree to 1e-5, residuals to 1e-4
    relative or 8 ulps of the sample's scale."""
    import dataclasses as dc
    jsched, tsched = _scheds(36)
    jsched = dc.replace(jsched, ab=jsched.ab.astype(jnp.float32),
                        t_model=jsched.t_model.astype(jnp.float32))
    tsched = tsched.astype(np.float32)
    x0 = _x0().astype(np.float32)
    w32 = W.astype(np.float32)

    def jm(x, t):
        return jnp.tanh(x @ jnp.asarray(w32)) * (0.5 + 0.001 * t)

    def tm(x, t):
        return torch.tanh(x @ torch.from_numpy(w32)) * (
            0.5 + 0.001 * t[:, None])

    cfg = dict(tol=1e-3, norm=norm, use_fused_update=True)
    jres = J.srds_sample(jm, jsched, J.SolverConfig("ddim"),
                         jnp.asarray(x0), J.SRDSConfig(**cfg))
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    tres = T.srds_sample(tm, tsched, T.SolverConfig("ddim"),
                         torch.from_numpy(x0), T.SRDSConfig(**cfg))
    assert ops.launch_counts()["parareal_update"] == 0    # CPU: the twin
    hist = np.asarray(jres.delta_history)
    live = np.isfinite(hist)
    assert np.all(np.abs(np.log(hist[live] / cfg["tol"])) > 0.05)
    assert int(tres.iterations) == int(jres.iterations)
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=1e-5, rtol=1e-5)
    # a converged residual differences f32 values of up to ~500: it is a
    # few of their ulps, so it is held to 8 ulps of the sample's scale
    ulp = np.spacing(np.float32(np.abs(np.asarray(jres.sample)).max()))
    np.testing.assert_allclose(tres.delta_history.numpy(), hist, rtol=1e-4,
                               atol=8 * ulp)
    plain = T.srds_sample(tm, tsched, T.SolverConfig("ddim"),
                          torch.from_numpy(x0),
                          T.SRDSConfig(**dict(cfg, use_fused_update=False)))
    # f32 in, f32 out: the twin's single rounding is the plain sum's
    assert torch.equal(plain.sample, tres.sample)


def _slow_toy():
    """The table13 bench toy (tests/test_accel.py's ``_slow_model``): a
    slowly converging time-varying linear model, f32 on both sides with
    JAX's parameters handed over through numpy."""
    import dataclasses as dc
    f32, dim = jnp.float32, 16
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    w = 2.0 * (1 + jax.random.uniform(k1, (dim,), f32))
    ph = 2 * jnp.pi * jax.random.uniform(k2, (dim,), f32)
    a = 2.0 * (0.5 + jax.random.uniform(k3, (dim,), f32))
    wt, pt, at = (torch.from_numpy(np.array(v)) for v in (w, ph, a))

    def jm(x, t):
        return (a * jnp.sin(w * t[..., None] * 0.06 + ph) * x).astype(f32)

    def tm(x, t):
        return (at * torch.sin(wt * t[:, None] * 0.06 + pt) * x).float()

    s = J.make_schedule("cosine", 100)
    js = dc.replace(s, ab=s.ab.astype(f32), t_model=s.t_model.astype(f32))
    ts = T.make_schedule("cosine", 100).astype(np.float32)
    return jm, tm, js, ts


# (tol, plain iterations, Anderson iterations), re-derived on the JAX
# package (ROADMAP C5: the plain run takes 7 at tol 3.0, not 8)
ACCEL_COUNTS = [(3.0, 7, 6), (1.0, 8, 7), (0.3, 9, 8)]


@pytest.mark.parametrize("tol,plain_iters,anderson_iters", ACCEL_COUNTS)
def test_accel_iteration_counts_match_jax(tol, plain_iters, anderson_iters):
    """On the bench toy (N=100, B=10, f32): plain, AndersonAccel and
    TriangularAccel under ExactPrefix take JAX's iteration counts, and
    NoAccel changes no bit.  Samples agree to 1e-4 relative (f32 solve,
    f32 mixing coefficients in two frameworks)."""
    jm, tm, js, ts = _slow_toy()
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 16),
                                    jnp.float32))
    runs = {"plain": (None, None, {}),
            "anderson": (J.AndersonAccel(depth=5, warmup=2),
                         T.AndersonAccel(depth=5, warmup=2), {}),
            "triangular": (J.TriangularAccel(depth=3, warmup=2),
                           T.TriangularAccel(depth=3, warmup=2),
                           dict(truncate=True))}
    got = {}
    for name, (ja, ta, kw) in runs.items():
        jr = J.srds_sample(jm, js, J.SolverConfig("ddim"), jnp.asarray(x0),
                           J.SRDSConfig(tol=tol, accel=ja, **kw))
        tr = T.srds_sample(tm, ts, T.SolverConfig("ddim"),
                           torch.from_numpy(x0),
                           T.SRDSConfig(tol=tol, accel=ta, **kw))
        assert int(tr.iterations) == int(jr.iterations), name
        scale = np.abs(np.asarray(jr.sample)).max()
        np.testing.assert_allclose(tr.sample.numpy(), np.asarray(jr.sample),
                                   atol=1e-4 * scale, rtol=0)
        got[name] = int(tr.iterations)
    assert (got["plain"], got["anderson"]) == (plain_iters, anderson_iters)
    noacc = T.srds_sample(tm, ts, T.SolverConfig("ddim"),
                          torch.from_numpy(x0),
                          T.SRDSConfig(tol=tol, accel=T.NoAccel()))
    plain = T.srds_sample(tm, ts, T.SolverConfig("ddim"),
                          torch.from_numpy(x0), T.SRDSConfig(tol=tol))
    assert torch.equal(noacc.sample, plain.sample)


def test_per_lane_mixing_equals_single_lane_runs():
    """Per-sample Anderson mixing solves each lane's normal equations on
    its own: a K-batch equals K single-lane runs bitwise, and takes the
    JAX run's per-lane iterations."""
    jm, tm, js, ts = _slow_toy()
    xb = np.array(jax.random.normal(jax.random.PRNGKey(2), (3, 16)),
                  np.float32)
    tols = np.asarray([3.0, 0.3, 1.0], np.float32)
    acc = dict(depth=3, warmup=2)
    jr = J.srds_sample(jm, js, J.SolverConfig("ddim"), jnp.asarray(xb),
                       J.SRDSConfig(per_sample=True,
                                    accel=J.AndersonAccel(**acc)),
                       tol=jnp.asarray(tols))
    tr = T.srds_sample(tm, ts, T.SolverConfig("ddim"), torch.from_numpy(xb),
                       T.SRDSConfig(per_sample=True,
                                    accel=T.AndersonAccel(**acc)),
                       tol=torch.from_numpy(tols))
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    assert len(set(tr.iterations.tolist())) > 1
    for k in range(3):
        one = T.srds_sample(tm, ts, T.SolverConfig("ddim"),
                            torch.from_numpy(xb[k:k + 1]),
                            T.SRDSConfig(tol=float(tols[k]),
                                         accel=T.AndersonAccel(**acc)))
        assert int(one.iterations) == int(tr.iterations[k]), k
        assert torch.equal(one.sample[0], tr.sample[k]), k


def test_accel_state_and_pairing_rules():
    """init_state shapes, reset_lanes, frozen blocks bitwise through a
    mix, and the pairing rules of JAX engine.py:688-714."""
    from repro_torch.core import engine as teng
    acc = T.AndersonAccel(depth=2, warmup=0)
    z = torch.randn(2, 4, 3, 5, dtype=torch.float64)
    st = acc.init_state(z, max_iters=6, batched=True)
    assert st.dz.shape == (2,) + z.shape and st.count.shape == (3,)
    assert T.NoAccel().init_state(z, 6) is None
    live = torch.tensor([False, True, True, True])
    for _ in range(3):
        z_new = z + 0.1 * torch.randn_like(z)
        z_new[0] = z[0]          # a frozen block's raw update is a no-op
        mixed, st = acc.apply(st, z, z_new, live=live, batched=True)
        assert torch.equal(mixed[:, 0], z[:, 0])
        z = mixed
    assert st.count.tolist() == [3, 3, 3]
    st = acc.reset_lanes(st, torch.tensor([True, False, False]))
    assert st.count.tolist() == [0, 3, 3]
    assert not st.dz[:, :, :, 0].any() and st.dz[:, :, :, 1].any()
    assert T.resolve_accel(None) == T.NoAccel()
    with pytest.raises(TypeError, match="Accelerator"):
        T.resolve_accel("anderson")
    _, sched = _scheds(16)
    x0 = torch.from_numpy(_x0())
    for cfg in (T.SRDSConfig(truncate=True, accel=T.AndersonAccel()),
                T.SRDSConfig(window=T.ResidualWindow(),
                             accel=T.AndersonAccel())):
        with pytest.raises(ValueError, match="serial-prefix"):
            T.srds_sample(_torch_matmul, sched, T.SolverConfig("ddim"), x0,
                          cfg)
    starts = np.arange(4) * 4
    with pytest.raises(ValueError, match="straggler"):
        teng.run_parareal(None, None, x0, starts, tol=0.0, max_iters=2,
                          carry_fine_results=True, accel=T.AndersonAccel())
    with pytest.raises(ValueError, match="carry_fine_results"):
        teng.run_parareal(None, None, x0, starts, tol=0.0, max_iters=2,
                          carry_fine_results=True, truncate=True)
    with pytest.raises(ValueError, match="block-sharding"):
        teng.run_parareal(None, None, x0, starts, tol=0.0, max_iters=2,
                          constrain=lambda t: t, truncate=True)
