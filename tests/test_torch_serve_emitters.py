"""The port's serving emitters (``repro_torch.benchmarks.table9_batched``,
``table10_slo``, ``table10_wallclock``, ``serve_smoke``, ``run``) against
the JAX package's (``benchmarks/``).

Both sides run the toy in f64 (JAX under x64; the JAX emitters' engine
and toy swapped for f64 ones with the same f32 weights from
``toy_inputs.npz``), and each request's ``x_init`` is JAX's draw handed to
the port through ``noise_fn``, as ``tests/test_torch_serve.py`` does: in
f32 the toy's residual floor (~2e-5) decides the 1e-5 requests' counts
inside roundoff.  Every count and virtual-clock metric must be equal.
The wall-clock table is held to its own gates and to JAX's calibration
counts.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from conftest import REPO  # noqa: E402
from repro.serve import FIFO as JFIFO  # noqa: E402
from repro.serve import AsyncServeLoop as JLoop  # noqa: E402
from repro.serve import MonotonicClock as JClock  # noqa: E402
from repro.serve.diffusion import \
    DiffusionSamplingEngine as JEngine  # noqa: E402
from repro_torch.benchmarks import (common, run, serve_smoke,  # noqa: E402
                                    table9_batched, table10_slo,
                                    table10_wallclock)

if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import table9_batched as j9  # noqa: E402
from benchmarks import table10_slo as j10  # noqa: E402
from benchmarks import table10_wallclock as j10w  # noqa: E402


def _jmodel():
    w1, w2 = (jnp.asarray(common.toy_inputs()[k], jnp.float64)
              for k in ("toy_w1", "toy_w2"))

    def model_fn(x, t):
        h = jnp.tanh(x @ w1) * (0.4 + 3e-4 * t)
        return jnp.tanh(h @ w2 + x * 0.1)
    return model_fn


def jax_noise(seed, shape, dtype, device):
    """JAX's draw for a request, as the JAX engine makes it."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                   jnp.float64))
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.fixture
def jax_f64(monkeypatch):
    """The JAX emitters with an f64 engine and toy."""
    model = _jmodel()
    for mod in (j9, j10, j10w):
        monkeypatch.setattr(mod, "DiffusionSamplingEngine",
                            functools.partial(JEngine, dtype=jnp.float64))
        monkeypatch.setattr(mod, "toy_denoiser", lambda dim=16: model)
    return model


def test_table9_rows_equal_jax(jax_f64):
    want = j9.main(requests=12, batch_sizes=(1, 4))
    got = table9_batched.main(requests=12, batch_sizes=(1, 4), device="cpu",
                              noise_fn=jax_noise, dtype=torch.float64)
    assert [{k: r[k] for k in w} for r, w in zip(got, want)] == want
    assert [r["batch"] for r in got] == [1, 4]
    tols = [r.tol for r in j9.make_queue(12)]
    for r in got:
        assert r["request_tols"] == tols
        assert (min(r["request_iters"]), max(r["request_iters"])) == \
            (r["iters_min"], r["iters_max"])


def test_table10_slo_rows_equal_jax(jax_f64):
    """Every row of the 100-request traces, each policy: completions,
    rejections, latency percentiles, attainment, goodput, makespan."""
    want = j10.main(n_requests=100)
    got = table10_slo.main(n_requests=100, device="cpu", noise_fn=jax_noise,
                           dtype=torch.float64)
    assert [{k: r[k] for k in w} for r, w in zip(got, want)] == want
    assert [(r["trace"], r["policy"]) for r in got] == [
        (t, p) for t in ("poisson", "burst") for p in ("fifo", "edf", "cost")]


def test_table10_slo_keeps_jax_assert(jax_f64):
    """At 40 requests (``serve_smoke``'s size) JAX's own Poisson trace has
    EDF's p95 above FIFO's, and JAX's emitter fails its assert on this
    tree (ROADMAP C19); the port, fed the same draws, fails it too."""
    with pytest.raises(AssertionError, match="EDF must beat FIFO"):
        j10.main(n_requests=40)
    with pytest.raises(AssertionError, match="EDF must beat FIFO"):
        table10_slo.main(n_requests=40, device="cpu", noise_fn=jax_noise,
                         dtype=torch.float64)


def test_table10_wallclock_toy_herd(jax_f64, monkeypatch):
    """The toy herd: the four gates hold (the emitter asserts them), on
    the CPU on the virtual-clock replay alone (ROADMAP C28: the wall
    clock binds on the card), and the calibration's physical evals, cold
    and warm, equal JAX's."""
    eng = JEngine(jax_f64, (16,), j10w.SolverConfig("ddim"),
                  num_steps=j10w.N, batch_size=j10w.BATCH, clock=JClock(),
                  dtype=jnp.float64)
    cold = JLoop(eng, JFIFO()).run(j10w.herd_trace())
    warm = JLoop(eng, JFIFO()).run(j10w.herd_trace())
    gated, real = [], table10_wallclock.gate

    def recorded(readings, which):
        gated.append(which)
        real(readings, which)

    monkeypatch.setattr(table10_wallclock, "gate", recorded)
    rows = table10_wallclock.main(device="cpu", noise_fn=jax_noise,
                                  dtype=torch.float64)
    assert gated == ["virtual-clock replay of the"]
    cal = rows[0]
    assert cal["trace"] == "calibration"
    assert (cal["physical_evals_cold"], cal["physical_evals"]) == \
        (cold.physical_evals, warm.physical_evals)
    herd = [r for r in rows if r["trace"] == "herd"]
    assert [r["policy"] for r in herd] == ["fifo", "edf", "cost"]
    assert all(r["completed"] + r["rejected"] + r["preempted"] == 24
               for r in herd)
    assert [r["trace"] for r in rows[5:]] == [
        f"poisson_load{x:g}" for x in table10_wallclock.LOADS
        for _ in range(3)]


def test_table10_wallclock_gate_is_jaxs():
    """The gate both herds go through is JAX's: EDF's and CostAware's
    light-tier p95 below FIFO's, EDF's attainment within 0.05 of FIFO's,
    CostAware's goodput at least 0.9 of FIFO's, each failure with JAX's
    message; readings that meet all four pass."""
    ok = {"fifo": (2.0, 0.50, 1.00), "edf": (1.0, 0.46, 1.10),
          "cost": (1.5, 0.40, 0.90)}
    table10_wallclock.gate(ok, "wall-clock")
    for policy, i, value, msg in (
            ("edf", 0, 2.0, "EDF light-tier p95 (2.000s) must beat FIFO "
                            "(2.000s) on the pinned wall-clock herd"),
            ("cost", 0, 2.5, "CostAware light-tier p95"),
            ("edf", 1, 0.44, "EDF attainment 0.44 fell below FIFO 0.50"),
            ("cost", 2, 0.89, "CostAware goodput 0.9rps fell >10% below")):
        bad = dict(ok)
        bad[policy] = tuple(value if j == i else v
                            for j, v in enumerate(ok[policy]))
        with pytest.raises(AssertionError, match=re.escape(msg)):
            table10_wallclock.gate(bad, "wall-clock")


def test_table10_wallclock_dit_cut_is_stated():
    """The full DiT's herd keeps the grid, tiers and gates and cuts only
    the counts the docstring names."""
    cut = table10_wallclock.DIT_CUT
    assert (cut["n_heavy"], cut["n_light"]) == (2, 4)
    assert cut["loads"] == (1.5,) and cut["sweep_requests"] == 4
    doc = table10_wallclock.__doc__
    assert "2 heavies" in doc and "4 lights" in doc and "N=64, B=8" in doc
    herd = table10_wallclock.herd_trace(n_heavy=2, n_light=4)
    assert [r.tol for r in herd] == [1e-6] * 2 + [1e-2] * 4


def test_serve_smoke_writes_its_json(tmp_path):
    out = str(tmp_path / "BENCH_serve.json")
    serve_smoke.main(out, device="cpu")
    with open(out) as f:
        payload = json.load(f)
    assert payload["meta"]["torch_version"] == torch.__version__
    assert payload["meta"]["backend"] == "cpu"
    assert [r["batch"] for r in payload["table9_batched"]] == [1, 4]
    assert len(payload["table10_slo"]) == 6
    assert all(r["completed"] + r["rejected"] > 0
               for r in payload["table10_slo"])


def test_run_reaches_every_table(monkeypatch, capsys):
    """``run.TABLES`` holds every emitter's ``main``; ``run.main`` calls
    each on the device it was given, prints a FAILED row for a table that
    raises, goes on, and reports the failure."""
    import pkgutil

    import repro_torch.benchmarks as pkg
    emitters = {m.name for m in pkgutil.iter_modules(pkg.__path__)
                if m.name.startswith(("table", "prop"))}
    assert {fn.__module__.rsplit(".", 1)[-1] for _, fn in run.TABLES} == \
        emitters
    assert all(fn.__name__ == "main" for _, fn in run.TABLES)
    called = []

    def stub(title):
        def fn(device):
            called.append((title, device.type))
            if title.startswith("table6"):
                raise RuntimeError("boom")
        return fn

    tables = [(title, stub(title)) for title, _ in run.TABLES]
    monkeypatch.setattr(run, "TABLES", tables)
    assert run.main(device="cpu") == 1
    assert called == [(t, "cpu") for t, _ in tables]
    out = capsys.readouterr().out
    assert "table6 (device scaling),-1,FAILED:RuntimeError:boom" in out
    assert out.count("done in") == len(tables)
