"""The port's serving path (``repro_torch.serve``) against the JAX package.

The elementwise toy denoiser of tests/test_scheduler.py runs in f64 on
both sides (JAX under x64).  Each request's ``x_init`` is JAX's own draw
(``jax.random.normal(PRNGKey(seed))``), handed to the port through numpy
by the engine's ``noise_fn``; the port itself never imports JAX.

Tolerances: everything the engines count — iterations, physical and
effective evals, window schedules, completion order, rejections,
preemptions, and the virtual-clock latencies derived from them — must be
equal; samples agree to 1e-10 (f64 roundoff over the solve).  Within the
port, the asynchronous loop on a virtual clock and each request's
standalone ``srds_sample`` equal ``simulate`` bitwise (elementwise toy:
no result depends on batch width).  Accelerated runs solve their mixing
coefficients in f32 in two frameworks, so their samples agree to 1e-6.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as J
from repro.core import AndersonAccel as JAnderson
from repro.core import ResidualWindow as JResidualWindow
from repro.core import SolverConfig as JSolver
from repro.core import TriangularAccel as JTriangular
from repro_torch import serve as T
from repro_torch.core import (AndersonAccel, ResidualWindow, SolverConfig,
                              SRDSConfig, TriangularAccel, make_schedule,
                              srds_sample, srds_stats)
from repro_torch.serve import diffusion as serve_diffusion

SAMPLE_TOL = 1e-10
ACCEL_SAMPLE_TOL = 1e-6
SCALE = np.linspace(0.5, 1.5, 8)
TIERS = [dict(tol=1e-2, slo_ms=25, iters_hint=2, weight=0.9),
         dict(tol=1e-6, slo_ms=400, iters_hint=7, weight=0.1)]
POLICIES = ["FIFO", "EDF", "CostAware"]
MODES = {"exact_prefix": ({}, {}),
         "residual_window": (dict(window=JResidualWindow(window_tol=1e-3)),
                             dict(window=ResidualWindow(window_tol=1e-3))),
         "fixed_budget": (dict(truncate=False), dict(truncate=False))}


def _jax_model(x, t):
    return jnp.tanh(x * jnp.asarray(SCALE)) * (0.5 + 0.001 * t)


def _torch_model(x, t):
    t = t.reshape(t.shape + (1,) * (x.dim() - 1))
    return torch.tanh(x * torch.from_numpy(SCALE)) * (0.5 + 0.001 * t)


def jax_noise(seed, shape, dtype, device):
    """JAX's draw for a request, as the JAX engine makes it."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                   jnp.float64))
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _engines(jkw=None, tkw=None, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("sec_per_eval", 1e-5)
    je = J.DiffusionSamplingEngine(_jax_model, (8,), JSolver("ddim"),
                                   num_steps=64, dtype=jnp.float64,
                                   **kw, **(jkw or {}))
    te = T.DiffusionSamplingEngine(_torch_model, (8,), SolverConfig("ddim"),
                                   num_steps=64, dtype=torch.float64,
                                   device="cpu", noise_fn=jax_noise,
                                   **kw, **(tkw or {}))
    return je, te


def _traces(n=12, seed=0, second_group=True):
    jt = J.poisson_trace(n, rate=300.0, tiers=[J.Tier(**t) for t in TIERS],
                         seed=seed)
    tt = T.poisson_trace(n, rate=300.0, tiers=[T.Tier(**t) for t in TIERS],
                         seed=seed)
    if second_group:
        for r in jt[::3] + tt[::3]:
            r.num_steps = 36
    return jt, tt


def _assert_reports_equal(jr, tr, sample_tol=SAMPLE_TOL):
    assert sorted(tr.responses) == sorted(jr.responses)
    assert tr.rejected == jr.rejected
    assert tr.preempted == jr.preempted
    for rid, j in jr.responses.items():
        t = tr.responses[rid]
        assert t.iterations == j.iterations, rid
        assert t.model_evals == j.model_evals, rid
        assert (t.latency, t.finish_time, t.slo_met) == \
            (j.latency, j.finish_time, j.slo_met), rid
        np.testing.assert_allclose(t.sample, np.asarray(j.sample),
                                   atol=sample_tol, rtol=0)
    for f in ("latency_p50", "latency_p95", "latency_p99",
              "slo_attainment", "goodput_rps", "makespan",
              "effective_evals", "physical_evals"):
        assert getattr(tr, f) == getattr(jr, f), f


def _completion_order(engine):
    return [(r.rid, r.status, r.finish_time) for r in engine.records]


# --------------------------------------------------------------------------
# simulate() against the JAX package's
# --------------------------------------------------------------------------

def test_trace_generators_match_jax():
    jt, tt = _traces(20, seed=7, second_group=False)
    assert [(r.seed, r.arrival_time, r.tol, r.slo_ms) for r in tt] == \
        [(r.seed, r.arrival_time, r.tol, r.slo_ms) for r in jt]
    tiers = [dict(tol=1e-2), dict(tol=1e-5, slo_ms=50)]
    jb = J.bursty_trace(3, 5, period=0.5, tiers=[J.Tier(**t) for t in tiers],
                        seed=7, jitter=0.01)
    tb = T.bursty_trace(3, 5, period=0.5, tiers=[T.Tier(**t) for t in tiers],
                        seed=7, jitter=0.01)
    assert [(r.seed, r.arrival_time, r.tol) for r in tb] == \
        [(r.seed, r.arrival_time, r.tol) for r in jb]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_matches_jax(policy, mode):
    """Same trace (two compatibility groups), same policy: the same
    SimReport, completion order, stats and per-frontier step cache."""
    jkw, tkw = MODES[mode]
    je, te = _engines(jkw, tkw)
    jt, tt = _traces()
    jr = J.simulate(je, jt, getattr(J, policy)())
    tr = T.simulate(te, tt, getattr(T, policy)())
    _assert_reports_equal(jr, tr)
    assert _completion_order(te) == _completion_order(je)
    assert te.stats() == je.stats()
    # the step functions are cached per quantized frontier, as JAX's
    # compiled programs are
    from repro_torch.serve.diffusion import _solver_fp
    for key, (_, j_step, _, _) in je._programs.items():
        t_step = te._programs[key[:3] + (_solver_fp(SolverConfig("ddim")),)][1]
        assert sorted(t_step.cache) == sorted(j_step.cache)
        assert sorted(t_step.windowed.cache) == \
            sorted(j_step.windowed.cache)


def test_cost_aware_rejects_and_preempts_like_jax():
    """Admission control and mid-flight eviction decide alike: the same
    rejected and preempted requests, the survivors' samples equal."""
    reqs = [dict(seed=0, tol=1e-6, arrival_time=0.0, slo_ms=1.0),
            dict(seed=1, tol=1e-2, arrival_time=0.0, slo_ms=1000.0,
                 iters_hint=2)]
    je, te = _engines()
    jr = J.simulate(je, [J.SampleRequest(**r) for r in reqs], J.CostAware())
    tr = T.simulate(te, [T.SampleRequest(**r) for r in reqs], T.CostAware())
    assert tr.rejected == jr.rejected == [0]
    _assert_reports_equal(jr, tr)
    reqs = [dict(seed=0, tol=1e-6, arrival_time=0.0, slo_ms=3.0,
                 iters_hint=1),
            dict(seed=1, tol=1e-2, arrival_time=0.004, slo_ms=1000.0,
                 iters_hint=2)]
    je, te = _engines(batch_size=1)
    for preempt in (True, False):
        jr = J.simulate(je, [J.SampleRequest(**r) for r in reqs],
                        J.CostAware(preempt=preempt))
        tr = T.simulate(te, [T.SampleRequest(**r) for r in reqs],
                        T.CostAware(preempt=preempt))
        assert tr.preempted == jr.preempted == ([0] if preempt else [])
        _assert_reports_equal(jr, tr)
        assert _completion_order(te) == _completion_order(je)


@pytest.mark.parametrize("accel", ["anderson", "triangular"])
def test_accelerated_serving_matches_jax(accel):
    """Per-lane mixing in the serving engine: Anderson (untruncated, its
    pairing rule) and Triangular (under the default truncation) take the
    JAX engine's iteration counts."""
    if accel == "anderson":
        jkw = dict(accel=JAnderson(depth=2, warmup=1), truncate=False)
        tkw = dict(accel=AndersonAccel(depth=2, warmup=1), truncate=False)
    else:
        jkw = dict(accel=JTriangular(depth=2, warmup=1))
        tkw = dict(accel=TriangularAccel(depth=2, warmup=1))
    je, te = _engines(jkw, tkw, batch_size=3)
    jt, tt = _traces(9, seed=2, second_group=False)
    jr = J.simulate(je, jt, J.FIFO())
    tr = T.simulate(te, tt, T.FIFO())
    _assert_reports_equal(jr, tr, sample_tol=ACCEL_SAMPLE_TOL)


def test_engine_pairing_rule_and_submit_validation():
    with pytest.raises(ValueError, match="serial-prefix"):
        T.DiffusionSamplingEngine(_torch_model, (8,), device="cpu",
                                  accel=AndersonAccel())
    with pytest.raises(ValueError, match="serial-prefix"):
        T.DiffusionSamplingEngine(_torch_model, (8,), device="cpu",
                                  window=ResidualWindow(),
                                  accel=AndersonAccel())
    eng = T.DiffusionSamplingEngine(_torch_model, (8,), device="cpu")
    with pytest.raises(ValueError, match="allow_inexact"):
        eng.submit(T.SampleRequest(seed=0, solver=SolverConfig("ddpm")))
    inexact = T.DiffusionSamplingEngine(_torch_model, (8,), device="cpu",
                                        allow_inexact=True, num_steps=16)
    rid = inexact.submit(T.SampleRequest(
        seed=0, solver=SolverConfig("ddpm", noise_seed=3)))
    assert np.isfinite(inexact.drain()[rid].sample).all()
    with pytest.raises(ValueError, match="unknown solver"):
        eng.submit(T.SampleRequest(seed=0, solver=SolverConfig("nope")))
    with pytest.raises(ValueError):
        eng.submit(T.SampleRequest(seed=0, schedule="nope"))
    with pytest.raises(ValueError, match="prime"):
        eng.submit(T.SampleRequest(seed=0, num_steps=37))
    wall = T.DiffusionSamplingEngine(_torch_model, (8,), device="cpu",
                                     clock=T.MonotonicClock())
    with pytest.raises(ValueError, match="VirtualClock"):
        T.simulate(wall, [T.SampleRequest(seed=0)])


# --------------------------------------------------------------------------
# the port's own guarantees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("max_inflight", [1, 2])
@pytest.mark.parametrize("mode", ["exact_prefix", "residual_window",
                                  "triangular"])
def test_async_loop_on_virtual_clock_equals_simulate(mode, max_inflight):
    """The pipelined dispatch/resolve loop, on a virtual clock, returns
    ``simulate()``'s samples and iterations bit for bit (and, where the
    bill does not follow the realized window, the same bill)."""
    kw = {"exact_prefix": {},
          "residual_window": dict(window=ResidualWindow(window_tol=1e-3)),
          "triangular": dict(accel=TriangularAccel(depth=2, warmup=1))}[mode]
    _, eng = _engines(tkw=kw)
    _, trace = _traces(10, seed=3)
    sync = T.simulate(eng, trace, T.FIFO())
    rep = T.AsyncServeLoop(eng, T.FIFO(), max_inflight=max_inflight).run(
        trace)
    assert sorted(rep.responses) == sorted(sync.responses)
    for rid, r in sync.responses.items():
        a = rep.responses[rid]
        assert a.iterations == r.iterations
        if mode != "residual_window":
            assert a.model_evals == r.model_evals
        assert np.array_equal(a.sample, r.sample)
    # pipelining wastes work on speculative refinements, never less
    assert rep.physical_evals >= sync.physical_evals


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_async_loop_matches_jax(max_inflight):
    """The pipelined loop on a virtual clock reports what the JAX
    package's does: the same speculative refinements, evals and
    latencies."""
    je, te = _engines()
    jt, tt = _traces(10, seed=3)
    jr = J.AsyncServeLoop(je, J.EDF(), max_inflight=max_inflight).run(jt)
    tr = T.AsyncServeLoop(te, T.EDF(), max_inflight=max_inflight).run(tt)
    _assert_reports_equal(jr, tr)
    assert _completion_order(te) == _completion_order(je)


class _FetchCounter:
    """Counts calls of the engine's one device-to-host seam."""

    def __init__(self, real):
        self.real = real
        self.shapes = []

    def __call__(self, fetch):
        out = self.real(fetch)
        self.shapes.append(out.shape)
        return out


@pytest.mark.parametrize("driver", ["simulate", "async"])
@pytest.mark.parametrize("mode", ["exact_prefix", "residual_window"])
def test_one_host_fetch_per_refinement(monkeypatch, driver, mode):
    """Exactly one fetch per refinement (the (K,) residual, or (K+B,)
    with the block residuals piggybacked) plus one per completion (that
    lane's final state), counted against the engine's refinement record."""
    counter = _FetchCounter(serve_diffusion._host_fetch)
    monkeypatch.setattr(serve_diffusion, "_host_fetch", counter)
    kw = dict(window=ResidualWindow(window_tol=1e-3)) \
        if mode == "residual_window" else {}
    _, eng = _engines(tkw=kw)
    _, trace = _traces(8, seed=4, second_group=False)
    run = T.simulate if driver == "simulate" \
        else lambda e, tr, p: T.AsyncServeLoop(e, p).run(tr)
    rep = run(eng, trace, T.FIFO())
    width = eng.batch_size + (8 if mode == "residual_window" else 0)
    residual = [s for s in counter.shapes if s == (width,)]
    lane = [s for s in counter.shapes if s == (8,)]
    assert len(residual) + len(lane) == len(counter.shapes)
    assert len(residual) == len(eng.refine_frontiers) > 0
    assert len(lane) == len(rep.responses) == len(trace)
    assert eng.init_sweeps > 0


def test_serving_equals_standalone_srds_sample():
    """Each completed request equals the port's own single-request
    ``srds_sample(truncate=True)`` on the same ``noise_fn`` draw (the
    port's native generator noise), bitwise, with equal iterations and
    billed evals."""
    eng = T.DiffusionSamplingEngine(_torch_model, (8,), SolverConfig("ddim"),
                                    num_steps=64, batch_size=2,
                                    dtype=torch.float64, device="cpu")
    _, trace = _traces(7, seed=5, second_group=False)
    rep = T.simulate(eng, trace, T.FIFO())
    sched = make_schedule("ddpm_linear", 64).astype(np.float64)
    ordered = sorted(trace, key=lambda r: r.arrival_time)
    for rid, req in enumerate(ordered):
        x0 = T.default_noise(req.seed, (8,), torch.float64, "cpu")
        cfg = SRDSConfig(tol=req.tol, truncate=True)
        ind = srds_sample(_torch_model, sched, SolverConfig("ddim"),
                          x0[None], cfg)
        r = rep.responses[rid]
        assert np.array_equal(r.sample, ind.sample[0].numpy()), rid
        assert r.iterations == int(ind.iterations), rid
        st = srds_stats(sched, SolverConfig("ddim"), cfg, r.iterations)
        assert r.model_evals == st.total_evals, rid


def test_slot_recycling_and_frontier_cache_bound():
    """Converged slots take the next request at once, and the step cache
    holds at most about B / quantum frontiers."""
    _, eng = _engines(tkw=dict(truncate_quantum=2), batch_size=2)
    _, trace = _traces(8, seed=6, second_group=False)
    rep = T.simulate(eng, trace, T.FIFO())
    assert len(rep.responses) == 8
    (_, step_for, B, _), = eng._programs.values()
    assert set(step_for.cache) <= set(range(0, B, 2))
    # 8 requests through 2 slots: lanes were re-initialised in place
    assert eng.init_sweeps >= 4
