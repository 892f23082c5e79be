"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; multi-device tests spawn subprocesses with their own flags."""
import os
import subprocess
import sys

import pytest

# tests/test_reprolint.py (and the CI lint leg) must collect and run on a
# box with no JAX at all — the heavy imports are optional at conftest level
# and every JAX-dependent test module fails loudly on its own import.
try:
    import jax
    import jax.numpy as jnp
except ImportError:      # pragma: no cover - exercised on the lint-only leg
    jax = jnp = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the linter's seeded-violation corpus is data, not tests
collect_ignore = ["lint_fixtures"]


def pytest_configure(config):
    """CI tiers (see scripts/check.sh): ``--fast`` runs
    ``-m "not slow and not distributed"``; the full leg runs everything."""
    config.addinivalue_line(
        "markers", "slow: long-running test (excluded by check.sh --fast)")
    config.addinivalue_line(
        "markers", "distributed: spawns subprocesses with fake multi-device "
        "meshes (excluded by check.sh --fast)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (the PyTorch port's "
        "hand-written kernels); skips elsewhere")


def run_subprocess(code: str, devices: int = 8, timeout: int = 900, env_extra=None):
    """Run a python snippet with N fake devices; return CompletedProcess."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    if env_extra:
        env.update(env_extra)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="session")
def toy_model():
    """A smooth nonlinear eps-predictor for solver/SRDS math tests (f32)."""
    if jax is None:
        pytest.skip("jax not installed")
    key = jax.random.PRNGKey(0)
    w = jax.random.normal(key, (8, 8)) * 0.3

    def model_fn(x, t):
        return jnp.tanh(x @ w) * (0.5 + 0.001 * t)

    return model_fn


def to_f64(sched):
    from repro.core.schedules import DiffusionSchedule
    return DiffusionSchedule(ab=sched.ab.astype(jnp.float64),
                             t_model=sched.t_model.astype(jnp.float64),
                             kind=sched.kind)
