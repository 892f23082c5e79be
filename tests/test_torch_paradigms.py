"""The port's ParaDiGMS baseline against the JAX package.

The same numpy toy and inputs go through ``repro.core.paradigms_sample``
and ``repro_torch.core.paradigms_sample`` in f64 (JAX under x64).  The
sweep count (``iterations``) and ``total_evals`` are integers and must be
equal; the samples agree to 1e-10 (f64 roundoff over an N-step solve).
DDPM takes JAX's frozen noise through ``noise_fn``.  Within the port, a
tolerance of 0 slides one point a sweep and lands on the sequential
sample (1e-10), and the per-sweep stride reads the device once.
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
W = np.random.default_rng(0).standard_normal((8, 8)) * 0.3
KEY = jax.random.PRNGKey(4)


def _jmodel(x, t):
    return jnp.tanh(x @ jnp.asarray(W)) * (0.5 + 0.001 * t)


def _tmodel(x, t):
    return torch.tanh(x @ torch.from_numpy(W)) * (0.5 + 0.001 * t[:, None])


def _scheds(n):
    j = J.make_schedule("ddpm_linear", n)
    return (JSchedule(ab=jnp.asarray(j.ab, jnp.float64),
                      t_model=jnp.asarray(j.t_model, jnp.float64),
                      kind=j.kind),
            T.make_schedule("ddpm_linear", n).astype(np.float64))


def _x0(k=3, seed=1):
    x = np.random.default_rng(seed).standard_normal((k, 8))
    return x * np.linspace(0.3, 2.5, k)[:, None]


def _noise_fn(interval_id, shape, dtype, device):
    draw = jax.random.normal(jax.random.fold_in(KEY, interval_id), shape,
                             jnp.float64)
    return torch.from_numpy(np.array(draw)).to(dtype=dtype, device=device)


def _solvers(name):
    if name == "ddpm":
        return (J.SolverConfig("ddpm", noise_key=KEY),
                T.SolverConfig("ddpm", noise_fn=_noise_fn))
    return J.SolverConfig(name), T.SolverConfig(name)


@pytest.mark.parametrize("solver", ["ddim", "heun", "ddpm"])
@pytest.mark.parametrize("n,window,tol", [
    (25, 25, 1e-3), (40, 8, 1e-4), (16, 64, 1e-2), (30, 7, 0.0),
    (36, 12, 1e-1), (20, 1, 1e-3)])
def test_paradigms_matches_jax(solver, n, window, tol):
    jsched, tsched = _scheds(n)
    jcfg, tcfg = _solvers(solver)
    x0 = _x0()
    jres = J.paradigms_sample(_jmodel, jsched, jcfg, jnp.asarray(x0),
                              J.ParaDiGMSConfig(window=window, tol=tol))
    tres = T.paradigms_sample(_tmodel, tsched, tcfg, torch.from_numpy(x0),
                              T.ParaDiGMSConfig(window=window, tol=tol))
    assert tres.iterations == int(jres.iterations)
    assert tres.total_evals == int(jres.total_evals)
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_TOL, rtol=0)
    j, t = J.paradigms_stats(jres, jcfg), T.paradigms_stats(tres, tcfg)
    assert (t.serial_evals, t.total_evals, t.iterations) == \
        (j.serial_evals, j.total_evals, j.iterations)


@pytest.mark.parametrize("max_iters", [1, 3, 7])
def test_paradigms_iteration_cap_matches_jax(max_iters):
    jsched, tsched = _scheds(24)
    x0 = _x0()
    jres = J.paradigms_sample(_jmodel, jsched, J.SolverConfig("ddim"),
                              jnp.asarray(x0),
                              J.ParaDiGMSConfig(window=6, tol=1e-6,
                                                max_iters=max_iters))
    tres = T.paradigms_sample(_tmodel, tsched, T.SolverConfig("ddim"),
                              torch.from_numpy(x0),
                              T.ParaDiGMSConfig(window=6, tol=1e-6,
                                                max_iters=max_iters))
    assert (tres.iterations, tres.total_evals) == \
        (int(jres.iterations), int(jres.total_evals))
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_TOL, rtol=0)


def test_paradigms_at_zero_tol_equals_sequential_and_syncs_once_a_sweep(
        monkeypatch):
    _, tsched = _scheds(20)
    x0 = torch.from_numpy(_x0())
    seq = T.sample_sequential(_tmodel, tsched, T.SolverConfig("ddim"), x0)
    reads = []
    real = torch.Tensor.__int__

    def counted(self):
        reads.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__int__", counted)
    res = T.paradigms_sample(_tmodel, tsched, T.SolverConfig("ddim"), x0,
                             T.ParaDiGMSConfig(window=8, tol=0.0))
    monkeypatch.undo()
    assert res.iterations == 20 and len(reads) == res.iterations
    # window 8 over 20 points, one point a sweep: 8 * 13 + 7 + ... + 1
    assert res.total_evals == 8 * 13 + sum(range(1, 8))
    torch.testing.assert_close(res.sample, seq, atol=SAMPLE_TOL, rtol=0)


def test_paradigms_one_model_call_per_sweep_and_shape_checks():
    _, tsched = _scheds(16)
    calls = []

    def model(x, t):
        calls.append(x.shape[0])
        return _tmodel(x, t)

    x0 = torch.from_numpy(_x0(k=2))
    res = T.paradigms_sample(model, tsched, T.SolverConfig("ddim"), x0,
                             T.ParaDiGMSConfig(window=5, tol=1e-3))
    assert len(calls) == res.iterations
    # every sweep folds its valid window points and the K samples into rows
    assert calls[0] == 5 * 2 and all(c % 2 == 0 for c in calls)
    with pytest.raises(ValueError, match="K, \\*sample_shape"):
        T.paradigms_sample(_tmodel, tsched, T.SolverConfig("ddim"),
                           torch.zeros(8, dtype=torch.float64))
