"""The port's ``ddpm`` solver (frozen-noise ancestral sampling) against the
JAX package, and its own guarantees.

JAX folds the interval id ``i0 * (N + 1) + i1`` into its ``PRNGKey`` and
draws ``normal(key, x.shape)`` per interval; the port takes that draw
through ``SolverConfig.noise_fn`` (numpy in between), so both sides solve
the same IVP.  Toy denoisers and inputs come from numpy, in f64 on both
sides (JAX under x64).

Tolerances: iteration counts and eval accounting are integers and must be
equal; samples agree to 1e-10 (f64 roundoff over an N-step solve).
Within the port, ``srds_sample`` at ``max_iters=B`` with the native noise
equals ``sample_sequential`` to 1e-10 (Prop 1), and the native noise of
an interval is bitwise the same whatever else is drawn around it.
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
from repro_torch.core.solvers import frozen_noise, interval_noise

SAMPLE_TOL = 1e-10
W = np.random.default_rng(0).standard_normal((8, 8)) * 0.3
KEY = jax.random.PRNGKey(9)


def _jmodel(x, t):
    return jnp.tanh(x @ jnp.asarray(W)) * (0.5 + 0.001 * t)


def _tmodel(x, t):
    return torch.tanh(x @ torch.from_numpy(W)) * (0.5 + 0.001 * t[:, None])


def _scheds(n, kind="ddpm_linear"):
    j = J.make_schedule(kind, n)
    return (JSchedule(ab=jnp.asarray(j.ab, jnp.float64),
                      t_model=jnp.asarray(j.t_model, jnp.float64),
                      kind=j.kind),
            T.make_schedule(kind, n).astype(np.float64))


def _x0(k=3, seed=1):
    x = np.random.default_rng(seed).standard_normal((k, 8))
    return x * np.linspace(0.3, 2.5, k)[:, None]


def jax_noise(key=KEY):
    """JAX's frozen noise of an interval, handed over through numpy."""
    def noise_fn(interval_id, shape, dtype, device):
        draw = jax.random.normal(jax.random.fold_in(key, interval_id), shape,
                                 jnp.float64)
        return torch.from_numpy(np.array(draw)).to(dtype=dtype,
                                                   device=device)
    return noise_fn


def _pair(eta=0.0):
    return (J.SolverConfig("ddpm", eta=eta, noise_key=KEY),
            T.SolverConfig("ddpm", eta=eta, noise_fn=jax_noise()))


@pytest.mark.parametrize("kind", ["ddpm_linear", "cosine"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_sequential_ddpm_equals_jax_with_its_noise(kind, eta):
    jsched, tsched = _scheds(25, kind)
    jcfg, tcfg = _pair(eta)
    x0 = _x0()
    want = J.sample_sequential(_jmodel, jsched, jcfg, jnp.asarray(x0))
    got = T.sample_sequential(_tmodel, tsched, tcfg, torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_TOL, rtol=0)


@pytest.mark.parametrize("per_sample,truncate", [
    (False, False), (True, False), (False, True), (True, True)])
def test_ddpm_srds_counts_and_evals_equal_jax(per_sample, truncate):
    """Iteration counts, joint or per sample, truncated or not, and the
    eval accounting they price equal JAX's; samples to 1e-10."""
    jsched, tsched = _scheds(36)
    jcfg, tcfg = _pair()
    x0 = _x0()
    kw = dict(tol=1e-4, per_sample=per_sample, truncate=truncate)
    jres = J.srds_sample(_jmodel, jsched, jcfg, jnp.asarray(x0),
                         J.SRDSConfig(**kw))
    tres = T.srds_sample(_tmodel, tsched, tcfg, torch.from_numpy(x0),
                         T.SRDSConfig(**kw))
    iters = np.asarray(jres.iterations)
    np.testing.assert_array_equal(tres.iterations.numpy(), iters)
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_TOL, rtol=0)
    for k in np.atleast_1d(iters):
        j = J.srds_stats(jsched, jcfg, J.SRDSConfig(**kw), int(k))
        t = T.srds_stats(tsched, tcfg, T.SRDSConfig(**kw), int(k))
        assert (t.serial_evals, t.total_evals, t.iterations) == \
            (j.serial_evals, j.total_evals, j.iterations)


@pytest.mark.parametrize("n", [16, 25])
def test_ddpm_srds_at_cap_equals_jax_sequential(n):
    """With JAX's noise, the port's SRDS at ``max_iters=B`` equals JAX's
    sequential DDPM sample: Prop 1 across frameworks."""
    jsched, tsched = _scheds(n)
    jcfg, tcfg = _pair()
    x0 = _x0()
    want = J.sample_sequential(_jmodel, jsched, jcfg, jnp.asarray(x0))
    res = T.srds_sample(_tmodel, tsched, tcfg, torch.from_numpy(x0),
                        T.SRDSConfig(tol=0.0))
    np.testing.assert_allclose(res.sample.numpy(), np.asarray(want),
                               atol=SAMPLE_TOL, rtol=0)


def test_native_noise_is_a_pure_function_of_seed_and_interval():
    shape = (3, 4, 5)
    a = frozen_noise(7, 40, shape, torch.float64, "cpu")
    frozen_noise(7, 41, (9,), torch.float64, "cpu")
    torch.manual_seed(123)                    # the global generator: unused
    assert torch.equal(frozen_noise(7, 40, shape, torch.float64, "cpu"), a)
    assert not torch.equal(frozen_noise(8, 40, shape, torch.float64, "cpu"),
                           a)
    assert not torch.equal(frozen_noise(7, 41, shape, torch.float64, "cpu"),
                           a)
    # rows are grouped by interval id: each id draws once for its rows,
    # in row order, whatever other ids ride in the batch
    cfg = T.SolverConfig("ddpm", noise_seed=7)
    x = torch.zeros((7, 4, 5), dtype=torch.float64)
    i0 = np.array([0, 0, 3, 3, 3, 0, 5])
    i1 = i0 + 1
    got = interval_noise(cfg, 10, i0, i1, x)
    first = frozen_noise(7, 1, (3, 4, 5), torch.float64, "cpu")
    mid = frozen_noise(7, 3 * 11 + 4, (3, 4, 5), torch.float64, "cpu")
    last = frozen_noise(7, 5 * 11 + 6, (1, 4, 5), torch.float64, "cpu")
    assert torch.equal(got, torch.cat([first[:2], mid, first[2:], last]))


def test_ddpm_needs_a_noise_source():
    _, tsched = _scheds(16)
    with pytest.raises(ValueError, match="noise_seed or"):
        T.sample_sequential(_tmodel, tsched, T.SolverConfig("ddpm"),
                            torch.from_numpy(_x0()))


def test_served_ddpm_needs_allow_inexact_and_completes_with_it():
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    solver = T.SolverConfig("ddpm", noise_seed=4)
    strict = DiffusionSamplingEngine(_tmodel, (8,), device="cpu",
                                     dtype=torch.float64)
    with pytest.raises(ValueError, match="allow_inexact"):
        strict.submit(SampleRequest(seed=0, solver=solver))
    eng = DiffusionSamplingEngine(_tmodel, (8,), device="cpu",
                                  dtype=torch.float64, allow_inexact=True,
                                  batch_size=2, num_steps=16)
    rids = [eng.submit(SampleRequest(seed=s, solver=solver, tol=0.0))
            for s in (0, 1)]
    out = eng.drain()
    _, tsched = _scheds(16)
    for rid in rids:
        sample = out[rid].sample
        assert sample.shape == (8,) and np.isfinite(sample).all()
    # at tol=0 a lane runs to the cap, so it equals the sequential solve of
    # the batch it rode in (the noise is drawn for the whole micro-batch)
    x_init = torch.stack([eng.noise_fn(s, (8,), torch.float64, "cpu")
                          for s in (0, 1)])
    seq = T.sample_sequential(_tmodel, tsched, solver, x_init)
    for k, rid in enumerate(rids):
        np.testing.assert_allclose(out[rid].sample, seq[k].numpy(),
                                   atol=SAMPLE_TOL, rtol=0)


def test_ddpm_requests_of_other_seeds_do_not_share_a_batch():
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    eng = DiffusionSamplingEngine(_tmodel, (8,), device="cpu",
                                  allow_inexact=True)
    keys = {eng.compat_key(SampleRequest(seed=0, solver=T.SolverConfig(
        "ddpm", noise_seed=s, eta=e))) for s, e in ((1, 0.0), (2, 0.0),
                                                    (1, 0.5))}
    assert len(keys) == 3
