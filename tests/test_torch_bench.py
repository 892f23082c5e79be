"""The port's paper-table emitters (``repro_torch.benchmarks``) against the
JAX package's (``benchmarks/``) on the same inputs.

The JAX emitters run as their command lines run them, in JAX's default
32-bit mode (``jax.enable_x64(False)``: the other test modules turn x64
on for the whole process); the port's run in f32 on the CPU.  Every count
a row carries (iterations, Picard sweeps, serial and total evals) must be
equal; the sizes are cut (N of 16-100, not 961-1024) and the tolerances
kept away from f32 roundoff, where the two frameworks' rounding may take
different sides (ROADMAP C15).  ``toy_inputs.npz`` must equal a fresh
JAX draw bitwise.  ``check_counts`` is held to its rules on small
artifacts.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch.kernels import tuning
from repro_torch.benchmarks import (check_counts, common, prop4_blocksize,
                                    run, serve_smoke, table1_pixel,
                                    table2_sd, table3_pipelined,
                                    table4_paradigms, table5_solvers,
                                    table6_devices, table8_tolerance,
                                    table9_batched, table10_slo,
                                    table10_wallclock, table11_truncation,
                                    table12_window, table13_accel,
                                    table14_kernels)
from repro_torch.benchmarks import autotune_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import table11_truncation as j11  # noqa: E402
from benchmarks import table12_window as j12  # noqa: E402
from benchmarks import table13_accel as j13  # noqa: E402


@pytest.fixture
def x32():
    """JAX in its default 32-bit mode, as the emitters' command lines."""
    with jax.enable_x64(False):
        yield


def _counts(row, fields):
    return {f: row[f] for f in fields}


def test_toy_inputs_equal_a_fresh_jax_draw(x32):
    spec = importlib.util.spec_from_file_location(
        "torch_toy_inputs", os.path.join(REPO, "scripts",
                                         "torch_toy_inputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.jax_toy_inputs()
    committed = common.toy_inputs()
    assert sorted(fresh) == sorted(committed)
    for name, arr in fresh.items():
        assert committed[name].dtype == arr.dtype == np.float32, name
        assert np.array_equal(committed[name], arr), name


def test_table11_rows_equal_jax(x32):
    fields = ("iterations", "evals_untruncated", "evals_truncated",
              "serial_untruncated", "serial_truncated")
    tols = (0.0, 1e-3)
    want = j11.run_rows(n=36, tols=tols)
    got = table11_truncation.run_rows(n=36, tols=tols, device="cpu",
                                      repeats=1)
    assert [_counts(r, fields) for r in got] == \
        [_counts(r, fields) for r in want]
    assert [r["name"] for r in got] == [r["name"] for r in want]


def test_table11_pinned_exactness_row():
    """The pinned N=100 config at tol=0: 714 against 1110 evals/sample."""
    row, = table11_truncation.run_rows(tols=(0.0,), device="cpu",
                                       repeats=1)
    assert (row["iterations"], row["evals_truncated"],
            row["evals_untruncated"]) == (10, 714, 1110)


def test_table12_rows_equal_jax(x32):
    fields = ("iterations", "evals_flat", "evals_exact_prefix",
              "evals_window")
    wtols = (1e-2, 1e-3)
    want = j12.run_rows(n=100, window_tols=wtols)
    got = table12_window.run_rows(n=100, window_tols=wtols, device="cpu",
                                  repeats=1)
    assert [_counts(r, fields) for r in got] == \
        [_counts(r, fields) for r in want]


def test_table13_rows_equal_jax(x32):
    """The JAX emitter's ``run_rows`` asserts its 25% headline, which the
    JAX package itself misses on this tree (ROADMAP C5); its rows are
    rebuilt from its own model and settings."""
    n, tols = 100, ((3.0, 5.0), (0.1, 1.0))
    model_fn = j13.slow_model()
    sched = J.make_schedule("cosine", n)
    sched = dataclasses.replace(sched, ab=sched.ab.astype(jnp.float32),
                                t_model=sched.t_model.astype(jnp.float32))
    x0 = jax.random.normal(jax.random.PRNGKey(j13.SEED), (j13.DIM,),
                           jnp.float32)
    acc = J.AndersonAccel(depth=j13.DEPTH, warmup=j13.WARMUP)
    cost = J.iteration_cost(n, None, 1)
    want = []
    for tol, _ in tols:
        ip, ia = (int(jax.jit(lambda x, c=c: J.srds_sample(
            model_fn, sched, J.SolverConfig("ddim"), x, c))(x0).iterations)
            for c in (J.SRDSConfig(tol=tol), J.SRDSConfig(tol=tol, accel=acc)))
        want.append(dict(iters_plain=ip, iters_accel=ia,
                         evals_plain=J.predicted_evals(cost, ip),
                         evals_accel=J.predicted_evals(cost, ia)))
    got = table13_accel.run_rows(n=n, tols=tols, device="cpu", repeats=1)
    assert [_counts(r, want[0]) for r in got] == want
    assert got[0]["headline_met"] == (got[0]["iters_saving_pct"] >= 25.0)


def _jax_pair(model_fn, n, solver, x0, cfg):
    sched = J.make_schedule("ddpm_linear", n)
    r = jcommon.run_pair(model_fn, sched, solver, x0, cfg)
    return r["iters"], r["eff_serial"], r["total"]


def test_table4_rows_equal_jax(x32):
    cases, tols = [(25, 5), (36, 6)], (1e-3, 1e-1)
    model_fn = jcommon.toy_denoiser()
    x0 = jax.random.normal(jax.random.PRNGKey(2), (1, 16))
    got = table4_paradigms.rows(common.toy_denoiser("cpu"),
                                common.toy_array("x0_table4", "cpu"),
                                cases=cases, tols=tols, repeats=1)
    for row, (n, b) in zip(got, cases):
        assert (row["srds_iters"], row["srds_eff_serial"],
                row["srds_total"]) == _jax_pair(
            model_fn, n, J.SolverConfig("ddim"), x0,
            J.SRDSConfig(tol=1e-3, num_blocks=b))
        sched = J.make_schedule("ddpm_linear", n)
        for tol in tols:
            res = J.paradigms_sample(model_fn, sched, J.SolverConfig("ddim"),
                                     x0[0], J.ParaDiGMSConfig(
                                         window=min(n, 64), tol=tol))
            assert (row["paradigms"][tol]["iterations"],
                    row["paradigms"][tol]["total_evals"]) == \
                (int(res.iterations), int(res.total_evals))


def test_table5_rows_equal_jax(x32):
    """DDPM takes JAX's frozen noise of ``PRNGKey(9)`` through
    ``noise_fn``."""
    cases = [("ddpm", 25), ("dpm2", 16), ("ddim", 25)]
    key = jax.random.PRNGKey(9)

    def noise_fn(interval_id, shape, dtype, device):
        draw = jax.random.normal(jax.random.fold_in(key, interval_id), shape,
                                 jnp.float32)
        return torch.from_numpy(np.array(draw)).to(dtype=dtype,
                                                   device=device)

    model_fn = jcommon.toy_denoiser()
    x0 = jax.random.normal(jax.random.PRNGKey(3), (1, 16))
    got = table5_solvers.rows(common.toy_denoiser("cpu"),
                              common.toy_array("x0_table5", "cpu"),
                              cases=cases, noise_fn=noise_fn, repeats=1)
    for row, (name, n) in zip(got, cases):
        assert (row["iters"], row["eff_serial"], row["total"]) == _jax_pair(
            model_fn, n, J.SolverConfig(name, noise_key=key), x0,
            J.SRDSConfig(tol=1e-3))
        assert row["seq_evals"] == n * J.SolverConfig(name).evals_per_step


def test_prop4_rows_equal_jax(x32):
    n, blocks = 64, (4, 8, 16)
    model_fn = jcommon.toy_denoiser()
    x0 = jax.random.normal(jax.random.PRNGKey(5), (1, 16))
    got = prop4_blocksize.rows(common.toy_denoiser("cpu"),
                               common.toy_array("x0_prop4", "cpu"), n=n,
                               blocks=blocks, repeats=1)
    for row, b in zip(got, blocks):
        assert (row["iters"], row["eff_serial"], row["total"]) == _jax_pair(
            model_fn, n, J.SolverConfig("ddim"), x0,
            J.SRDSConfig(tol=1e-3, num_blocks=b))
        assert row["per_iter"] == n // b + b


@pytest.fixture(scope="module")
def small_dits():
    """One numpy-drawn DiT tree (every leaf nonzero) in both frameworks,
    at the JAX emitters' small widths, f32."""
    from repro.configs import get_arch as jget
    from repro.models.dit import dit_forward
    from repro_torch.configs import get_arch as tget
    from repro_torch.models import dit as tdit
    kw = dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=4,
              head_dim=8, d_ff=128, patch_size=4, dtype="float32")
    tcfg = dataclasses.replace(tget("srds-dit-cifar"), **kw)
    jcfg = dataclasses.replace(jget("srds-dit-cifar"), **kw)
    tree = tdit.random_jax_tree(tcfg, seed=2)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)

    def jfn(x, t):
        tb = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0],))
        return dit_forward(jcfg, jtree, x, tb, use_kernel=False)

    tfn = tdit.make_denoiser(tdit.load_jax_params(tcfg, tree, device="cpu"))
    x0 = np.random.default_rng(7).standard_normal(
        (1, 16, 16, 3)).astype(np.float32)
    return jfn, tfn, x0


def test_dit_emitter_rows_equal_jax(x32, small_dits):
    """table1's, table2's and table8's ``rows`` on one small DiT at cut
    N: the counts equal JAX's ``run_pair`` on the same weights."""
    jfn, tfn, x0 = small_dits
    jx0, tx0 = jnp.asarray(x0), torch.from_numpy(x0)
    fields = ("iters", "eff_serial", "total")
    row, = table1_pixel.rows([("cifar_scale", tfn, tx0)], n=32, blocks=8,
                             repeats=1)
    assert _counts(row, fields) == dict(zip(fields, _jax_pair(
        jfn, 32, J.SolverConfig("ddim"), jx0,
        J.SRDSConfig(tol=1e-3, num_blocks=8))))
    cases = [(25, None), (16, 1)]
    for row, (n, m) in zip(table2_sd.rows(tfn, tx0, cases=cases, repeats=1),
                           cases):
        assert _counts(row, fields) == dict(zip(fields, _jax_pair(
            jfn, n, J.SolverConfig("ddim"), jx0,
            J.SRDSConfig(tol=1e-3, max_iters=m))))
    for row, tau in zip(table8_tolerance.rows(tfn, tx0, n=32, blocks=8,
                                              taus=(1e-2,), repeats=1),
                        (1e-2,)):
        assert _counts(row, fields) == dict(zip(fields, _jax_pair(
            jfn, 32, J.SolverConfig("ddim"), jx0,
            J.SRDSConfig(tol=tau, num_blocks=8))))


def test_emitters_write_torch_artifacts(tmp_path, capsys):
    """table11 writes a fresh artifact, table12 appends to it; rows carry
    the JAX emitters' names and the CSV line its three fields."""
    out = str(tmp_path / "B.json")
    table11_truncation.main(out=out, n=36, device="cpu")
    rows = table12_window.run_rows(n=36, max_iters=None, window_tols=(1e-2,),
                                   device="cpu", repeats=1)
    common.merge_out(out, rows, "pinned_window", {"n": 36}, "cpu")
    with open(out) as f:
        payload = json.load(f)
    assert payload["schema"] == 1
    assert payload["meta"]["framework"] == "torch"
    assert payload["meta"]["backend"] == "cpu"
    assert payload["meta"]["torch_version"] == torch.__version__
    names = [r["name"] for r in payload["rows"]]
    assert names == ["table11/n36_tol0", "table11/n36_tol1e-05",
                     "table11/n36_tol0.001", "table12/n36_wtol0.01"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table1")]
    assert lines and all(len(ln.split(",")) == 3 for ln in lines)


def _artifact(rows):
    return {"schema": 1, "meta": {}, "rows": rows}


def test_check_counts_rules():
    base = _artifact([
        dict(name="table11/n100_tol0", iterations=10, evals_truncated=714,
             evals_untruncated=1110, evals_saving_pct=35.7,
             serial_truncated=174, t_truncated_s=1.0),
        dict(name="table13/n100_tol3", iters_plain=8, iters_accel=6,
             evals_plain=890, evals_accel=670, iters_saving_pct=25.0),
        dict(name="table6/mesh_t2d2m2", iterations=1),
        dict(name="table14/cpu/flash", parity_ok=True)])
    good = _artifact([
        dict(name="table11/n100_tol0", iterations=10, evals_truncated=714,
             evals_untruncated=1110, evals_saving_pct=99.0,
             serial_truncated=174, t_truncated_s=9.0),
        dict(name="table13/n100_tol3", iters_plain=7, iters_accel=6,
             evals_plain=780, evals_accel=670, iters_saving_pct=14.3,
             headline_met=False),
        dict(name="table6/mesh_t2d2m2", iterations=1, max_abs_diff=0.0,
             tol=5e-5, within_tol=True, t_mesh_s=9.0),
        dict(name="table14/sm90/flash", parity_ok=True, max_abs_diff=1e-6,
             tol=5e-5, config_source="table",
             config_params={"fwd_stages": 3})])
    failures, notes = check_counts.check(good, base)
    assert failures == []
    assert not any("table6" in n for n in notes)
    assert not any("table14" in n for n in notes)
    assert check_counts.SKIPPED == {}
    # table6's mesh row is gated: its iterations and its within_tol
    for change, want in ((dict(iterations=2), "iterations 2 != baseline 1"),
                         (dict(within_tol=False, max_abs_diff=1e-3),
                          "within_tol is false (max_abs_diff 0.001 > tol "
                          "5e-05)")):
        mesh = json.loads(json.dumps(good))
        mesh["rows"][2].update(change)
        failures, _ = check_counts.check(mesh, base)
        assert failures == [f"table6/mesh_t2d2m2: {want}"]
    assert any("C5" in n and "iters_plain 7" in n for n in notes)
    # an exact count that moved, a reference value the port missed, a
    # missing row: each fails
    bad = json.loads(json.dumps(good))
    bad["rows"][0]["evals_truncated"] = 715
    bad["rows"][1]["iters_plain"] = 8
    failures, _ = check_counts.check(bad, base)
    assert len(failures) == 2
    failures, _ = check_counts.check(_artifact(good["rows"][1:]), base)
    assert failures == ["table11/n100_tol0: row missing from current "
                        "artifact"]
    failures, _ = check_counts.check(_artifact(good["rows"][:3]), base)
    assert failures == ["table14/cpu/flash: no table14 row of the flash "
                        "family in the current artifact"]
    # a headline miss outside the known divergence fails
    base12 = _artifact([dict(name="table13/n100_tol0.1", iters_plain=10,
                             iters_accel=9)])
    cur12 = _artifact([dict(name="table13/n100_tol0.1", iters_plain=9,
                            iters_accel=9, evals_plain=1000,
                            iters_saving_pct=0.0, headline_met=False)])
    failures, _ = check_counts.check(cur12, base12)
    assert failures == ["table13/n100_tol0.1: headline iteration cut 0.0% "
                        "under 25%"]


def test_check_counts_cli_on_baseline(tmp_path):
    """The baseline checked against itself passes, with its skipped tables
    and the reference divergences' fields reported or failed by rule."""
    path = os.path.join(REPO, "benchmarks", "baselines",
                        "BENCH_core_baseline.json")
    with open(path) as f:
        base = json.load(f)
    cur = str(tmp_path / "cur.json")
    ported = [r for r in base["rows"]
              if r["name"].split("/")[0] not in check_counts.SKIPPED
              and r["name"] not in check_counts.REFERENCE]
    with open(cur, "w") as f:
        json.dump(_artifact(ported), f)
    assert check_counts.main(["--current", cur, "--baseline", path]) == 1
    keep = [r for r in base["rows"]
            if r["name"] in {p["name"] for p in ported}]
    only = str(tmp_path / "base.json")
    with open(only, "w") as f:
        json.dump(_artifact(keep), f)
    assert check_counts.main(["--current", cur, "--baseline", only]) == 0


@pytest.mark.parametrize("entry", [
    "common.toy_denoiser", "common.small_dit", "table13_accel.slow_model",
    "table11_truncation.run_rows", "table12_window.run_rows",
    "table13_accel.run_rows", "table1_pixel.main", "table2_sd.main",
    "table4_paradigms.main", "table5_solvers.main", "table8_tolerance.main",
    "table11_truncation.main", "table12_window.main", "table13_accel.main",
    "prop4_blocksize.main", "table3_pipelined.main", "table6_devices.main",
    "table9_batched.main", "table10_slo.main", "table10_wallclock.main",
    "serve_smoke.main", "run.main", "table14_kernels.main",
    "table14_kernels.run_rows"])
def test_emitter_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, every Python entry point of the emitters
    asks for the card, and raises where CUDA is not available (never a
    silent run on the CPU); ``device="cpu"`` is asked for explicitly, as
    the tests above do."""
    import inspect
    module, name = entry.split(".")
    fn = getattr(globals()[module], name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        fn() if name != "run_rows" or module != "table12_window" \
            else fn(n=36)


def test_table14_rows_on_cpu():
    """One row a family on the CPU: the plain path's parity, the
    heuristic provenance (the process tuner, no cpu table), JAX's row
    fields (the committed baseline's table14 rows) and the scan family
    the JAX package lacks."""
    rows = table14_kernels.run_rows(device="cpu")
    assert [r["kernel"] for r in rows] == list(tuning.KERNELS)
    with open(os.path.join(REPO, "benchmarks", "baselines",
                           "BENCH_core_baseline.json")) as f:
        jax_rows = [r for r in json.load(f)["rows"]
                    if r["name"].startswith("table14/")]
    assert {r["kernel"] for r in jax_rows} <= {r["kernel"] for r in rows}
    for r in rows:
        assert set(jax_rows[0]) <= set(r)
        assert r["name"] == f"table14/cpu/{r['kernel']}"
        assert r["parity_ok"] is True and r["max_abs_diff"] == 0.0
        assert r["config_source"] == "heuristic" and not r["compiled"]
        assert r["config_params"] == dict(tuning.resolve(
            r["kernel"], backend="cpu").params)


@pytest.mark.parametrize("change, want", [
    (dict(parity_ok=False), "parity_ok is False"),
    (dict(parity_ok=None), "parity_ok is None"),
    (dict(config_source="guess"), "config_source 'guess'"),
    (dict(config_params={}), "config_params missing/empty"),
])
def test_check_counts_gates_table14_rows(change, want):
    """table14 is gated on the current run alone: a row whose kernel lost
    parity, or whose provenance is missing or malformed, fails it."""
    rows = table14_kernels.run_rows(device="cpu")
    base = _artifact([dict(name="table14/cpu/flash", parity_ok=True)])
    assert check_counts.check(_artifact(rows), base) == ([], [])
    bad = json.loads(json.dumps(rows))
    bad[1].update(change)
    failures, _ = check_counts.check(_artifact(bad), base)
    assert len(failures) == 1 and want in failures[0], failures
    assert failures[0].startswith("table14/cpu/flash")


def test_autotune_smoke_is_structural():
    """``--smoke`` on the CPU: every candidate resolved through an
    override and run on the plain path, a payload of one candidate a key
    validated and round-tripped; the full sweep and a table write refuse
    the CPU."""
    payload = autotune_kernels.smoke(log=lambda *_: None)
    assert payload["backend"] == "cpu" and payload["entries"]
    tuning.validate_table(payload)
    keys = {(e["kernel"], tuple(e["bucket"])) for e in payload["entries"]}
    assert {k for k, _ in keys} == set(tuning.KERNELS)
    for knob in (k for c in autotune_kernels.CASES for k in c.knobs):
        lo, hi, step = tuning.LIMITS[knob]
        assert all(lo <= v <= hi and (v - lo) % step == 0
                   for v in autotune_kernels.candidates(knob)), knob
    assert autotune_kernels.main(["--smoke"]) == 0
    assert autotune_kernels.main([]) == 2
    assert autotune_kernels.main(["--smoke", "--write-table"]) == 2
    with pytest.raises(SystemExit, match="--smoke"):
        autotune_kernels.sweep("cpu")


def test_autotune_limits_are_phase_3s():
    """The sweep holds each candidate to the limits chip_smoke.py's phase
    3 holds the kernels to."""
    import chip_smoke as cs
    lim = autotune_kernels.LIMITS
    assert lim["flash_fwd"] == cs.MASKED_REL_L2["bfloat16"]
    assert lim["flash_bwd"] == cs.BWD_MASKED_REL_L2["bfloat16"]
    assert lim["wkv_bwd"] == cs.WKV_BWD_REL_L2["bfloat16"]
    assert (lim["scan_fwd"], lim["scan_bwd"]) == (cs.SCAN_REL_L2,
                                                  cs.SCAN_BWD_REL_L2)


def test_autotune_round_trip_refuses_a_wrong_table():
    """The round trip resolves each entry from the table tier; an entry
    its tuner would not resolve (a bucket no shape maps to) fails it."""
    good = {"version": 1, "backend": "sm90", "entries": [
        {"kernel": "rwkv6", "dtype": "bfloat16", "bucket": [2048, 64],
         "params": {"dv_sum_threads": 128}}]}
    autotune_kernels.round_trip(good)
    bad = json.loads(json.dumps(good))
    bad["entries"][0]["bucket"] = [2000, 64]
    with pytest.raises(AssertionError):
        autotune_kernels.round_trip(bad)
    bad["entries"][0]["params"] = {"dv_sum_threads": 100}
    with pytest.raises(tuning.TuningTableError):
        autotune_kernels.round_trip(bad)
