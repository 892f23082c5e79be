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
runs bitwise.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
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


@pytest.mark.parametrize("solver", ["ddim", "euler", "heun", "dpm2"])
@pytest.mark.parametrize("n", [16, 25, 36])
def test_srds_at_cap_equals_sequential(solver, n):
    """Prop 1 within the port: ``max_iters=B`` reproduces the serial solve."""
    _, sched = _scheds(n)
    cfg = T.SolverConfig(solver)
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
    _, sched = _scheds(16)
    x0 = torch.from_numpy(_x0())
    with pytest.raises(NotImplementedError, match="A3"):
        T.sample_sequential(_torch_matmul, sched, T.SolverConfig("ddpm"), x0)
    for cfg, item in [(T.SRDSConfig(truncate=True), "A5"),
                      (T.SRDSConfig(window=object()), "A5"),
                      (T.SRDSConfig(accel=object()), "A7"),
                      (T.SRDSConfig(block_sharding=object()), "A10"),
                      (T.SRDSConfig(norm="l2_mean", use_fused_update=True),
                       "B4")]:
        with pytest.raises(NotImplementedError, match=item):
            T.srds_sample(_torch_matmul, sched, T.SolverConfig("ddim"), x0,
                          cfg)
