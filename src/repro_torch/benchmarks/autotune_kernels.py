"""The measured sweep of the kernels' knobs: writes the committed tuning
table (counterpart of ``benchmarks/autotune_kernels.py``).

For each key ``(family, dtype, bucket)`` at the main paths' shapes
(:data:`CASES`, PERF.md's kernel table) it walks each knob's candidate
grid (:func:`candidates`) from the heuristic config, one knob at a time:
a candidate replaces the config it is timed against only when every one
of its runs beats every one of that config's (CUDA events, the two in
turns).  Every candidate is first held to its kernel's plain version in
``kernels/ref.py`` within the limit ``chip_smoke.py`` phase 3 uses for
that kernel (:data:`LIMITS`).  The winner of a key is then timed in turns
with the heuristic config, and its entry goes into the payload (with its
tuned and default microseconds and their runs' spread) only when it beats
the heuristic by more than that spread; every other key stays on the
shipped constants.  The payload is validated and round-tripped through
``KernelTuner(tables=...)`` (each entry resolves with ``source ==
"table"`` and its parameters).  Build candidates (the flash rings, the
scan backward's sub-chunk and register caps) are ``-D`` builds of their
sources, compiled before any timing, all in parallel, one ``nvcc`` each.

Modes:

* the full sweep (default), on the card: ``--write-table`` writes
  ``src/repro_torch/kernels/tuning_tables/sm90.json`` with its provenance
  (the card and power limit as ``nvidia-smi`` gives them, ``--commit``,
  each entry's tuned and default µs and spread, the runs);
* ``--launch-only``: launch parameters only (no ``nvcc``), fewer and
  shorter runs, the schema and round-trip checks; ``chip_smoke.py``
  phase 19 runs it, and it writes nothing;
* ``--smoke``, on the CPU: the structural checks only (every candidate's
  geometry resolved through an override, the plain version's parity on
  small shapes, the schema and the round trip); it times nothing, and the
  full sweep refuses a CPU device, since times there would tune the
  plain versions.

    PYTHONPATH=src python -m repro_torch.benchmarks.autotune_kernels --smoke
    PYTHONPATH=src python -m repro_torch.benchmarks.autotune_kernels \\
        --write-table --commit "$(git rev-parse --short HEAD)"
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build, ops, ref, selective_scan, tuning

# phase 3's limits (chip_smoke.py): the elementwise outputs bitwise and
# their sums within SUM_RTOL; the flash forward's and backward's rel L2
# (MASKED_REL_L2, BWD_MASKED_REL_L2, bf16); the WKV backward's rel L2
# (WKV_BWD_REL_L2, bf16); the scan's (SCAN_REL_L2, SCAN_BWD_REL_L2)
LIMITS = {"sum_rtol": 1e-5, "flash_fwd": 1e-4, "flash_bwd": 1e-3,
          "wkv_bwd": 1e-2, "scan_fwd": 1e-6, "scan_bwd": 1e-5}
RUNS = 5                 # timed runs of a config, in turns with its rival
LAUNCH_ONLY_RUNS = 3


class Case(NamedTuple):
    """One key's workload: ``family``, a label, the op it times
    (``which``), its shape, dtype and the knobs it sweeps."""
    family: str
    label: str
    which: str
    shape: tuple
    dtype: torch.dtype
    knobs: tuple


# the main paths' shapes (PERF.md's kernel table): the DiT's latents
# (DDIM per row over 10 rows, the residual over 2 slices, the update), the
# flash forms of the DiT, qwen3-8b and hymba-1.5b (bf16, tensor cores),
# rwkv6-1.6b's training shape, hymba-1.5b's scan (prefill, training,
# decode step)
CASES = (
    Case("elementwise", "ddim (10,64,64,4) f32", "ddim", (10, 64, 64, 4),
         torch.float32, ("ddim_threads",)),
    Case("elementwise", "residual (2,64,64,4) f32, batch_dims 1", "resid",
         (2, 64, 64, 4), torch.float32,
         ("resid_threads", "resid_max_cluster", "resid_slice_per_block")),
    Case("elementwise", "update (2,64,64,4) f32", "update", (2, 64, 64, 4),
         torch.float32,
         ("resid_threads", "resid_max_cluster", "resid_slice_per_block")),
    Case("flash", "DiT BH 160 S 1024 D 72 bf16", "flash",
         (10, 16, 16, 1024, 1024, 72, False, None), torch.bfloat16,
         ("fwd_stages", "bwd_stages")),
    Case("flash", "qwen3-8b causal GQA BH 128/32 S 2048 D 128 bf16", "flash",
         (4, 32, 8, 2048, 2048, 128, True, None), torch.bfloat16,
         ("fwd_stages", "bwd_stages")),
    Case("flash", "hymba window 1024 BH 100/20 S 2048 D 64 bf16", "flash",
         (4, 25, 5, 2048, 2048, 64, True, 1024), torch.bfloat16,
         ("fwd_stages", "bwd_stages")),
    Case("rwkv6", "rwkv6-1.6b training B 2 H 32 T 2048 D 64 bf16", "wkv_bwd",
         (2, 32, 2048, 64, 64), torch.bfloat16, ("dv_sum_threads",)),
    Case("selective_scan", "hymba prefill B 4 T 2048 din 1600 n 16",
         "scan_fwd", (4, 2048, 1600, 16), torch.float32,
         ("channels", "stages")),
    Case("selective_scan", "hymba training B 2 T 2048 din 1600 n 16",
         "scan_bwd", (2, 2048, 1600, 16), torch.float32,
         ("bwd_channels", "segment_chunks", "max_segments", "bwd_sub",
          "bwd_max_threads", "bwd_min_blocks", "bwd_replay_min_blocks")),
    Case("selective_scan", "hymba decode B 4 T 1 din 1600 n 16", "scan_fwd",
         (4, 1, 1600, 16), torch.float32, ("channels",)),
)
# the same ops at small shapes, for --smoke on the CPU
SMOKE_SHAPES = {"ddim": (3, 8, 8, 4), "resid": (2, 4, 8, 4),
                "update": (2, 4, 8, 4),
                "flash": (1, 2, 1, 40, 40, 16, True, None),
                "wkv_bwd": (1, 2, 20, 8, 8), "scan_fwd": (2, 9, 12, 4),
                "scan_bwd": (1, 70, 8, 4)}

_GRID = {
    "ddim_threads": (64, 128, 256),
    "resid_threads": (256, 512, 1024),
    "resid_max_cluster": (2, 4, 8),
    "resid_slice_per_block": (1024, 2048, 4096, 8192),
    "fwd_stages": (2, 3, 4),
    "bwd_stages": (2, 3),
    "dv_sum_threads": (64, 128, 256),
    "channels": (32, 64, 128),
    "stages": (2, 3, 4),
    "bwd_channels": (16, 32, 64),
    "segment_chunks": (1, 2, 4),
    "max_segments": (16, 32),
    "bwd_sub": (4, 8, 16),
    "bwd_max_threads": (128, 256),
    "bwd_min_blocks": (2, 3, 4),
    "bwd_replay_min_blocks": (3, 4),
}


def candidates(knob: str) -> tuple:
    """The candidate values of one knob (each within ``tuning.LIMITS``)."""
    return _GRID[knob]


def _is_build(family: str, knob: str) -> bool:
    return knob in tuning.BUILD_PARAMS[family]


def _tuner(backend: str, family: str, params: dict) -> tuning.KernelTuner:
    """A tuner with no table whose ``family`` is pinned at ``params``."""
    empty = {"version": tuning.TABLE_SCHEMA_VERSION, "backend": backend,
             "entries": []}
    return tuning.KernelTuner(tables={backend: empty},
                              overrides={family: dict(params)})


def tuning_shape(case: Case, shape=None) -> tuple:
    """The shape the seam buckets the case on (the wrappers' key)."""
    s = case.shape if shape is None else shape
    if case.which == "ddim":
        return (math.prod(s),)
    if case.which == "resid":
        return (math.prod(s[1:]),)
    if case.which == "update":
        return (math.prod(s),)
    if case.which == "flash":
        return (s[3], s[4], s[5])
    if case.which == "wkv_bwd":
        return (s[2], s[3])
    return (s[1], s[2], s[3])


def _rel(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    num = sum(float(torch.sum((g.double() - w.double()) ** 2))
              for g, w in zip(got, want))
    den = sum(float(torch.sum(w.double() ** 2)) for w in want)
    return math.sqrt(num / max(den, 1e-300))


class _Work(NamedTuple):
    run: Callable          # run(tuner) -> outputs
    check: Callable        # check(outputs, params) -> (max_abs_err, ok)


def _work(case: Case, shape, device) -> _Work:
    """The case's operands on ``device`` (a numpy draw), its op through a
    tuner and its check against the plain version."""
    rng = np.random.default_rng(0)

    def rand(*s, scale=1.0, dtype=case.dtype):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(
            np.float32)).to(device=device, dtype=dtype)

    if case.which in ("ddim", "resid", "update"):
        y, cur, prev, old = (rand(*shape) for _ in range(4))
        if case.which == "ddim":
            a = torch.linspace(0.5, 0.9, shape[0], device=device)
            b = torch.linspace(0.6, 0.95, shape[0], device=device)
            want = ref.ddim_fused(y, cur, a, b)

            def run(t):
                return (ops.ddim_fused(y, cur, a, b, tuner=t),)

            def check(out, _):
                return (float((out[0] - want).abs().max()),
                        torch.equal(out[0], want))
            return _Work(run, check)
        if case.which == "resid":
            want = ref.parareal_update_residual(y, cur, prev, old,
                                                batch_dims=1)

            def run(t):
                return ops.parareal_update_residual(y, cur, prev, old,
                                                    batch_dims=1, tuner=t)
        else:
            want = ref.parareal_update(y, cur, prev)

            def run(t):
                return ops.parareal_update(y, cur, prev, tuner=t)

        def check(out, _):
            rel = float(((out[1] - want[1]).abs()
                         / want[1].abs().clamp_min(1e-30)).max())
            return (float((out[0] - want[0]).abs().max()),
                    torch.equal(out[0], want[0])
                    and rel <= LIMITS["sum_rtol"])
        return _Work(run, check)

    if case.which == "flash":
        b, hq, hkv, sq, sk, d, causal, window = shape
        q, k, v = rand(b, hq, sq, d), rand(b, hkv, sk, d), rand(b, hkv, sk, d)
        do = rand(b, hq, sq, d)
        q.requires_grad_(True)
        k.requires_grad_(True)
        v.requires_grad_(True)
        mask = dict(causal=causal, window=window)
        o_ref, lse = ref.attention(q.detach(), k.detach(), v.detach(), **mask)
        want = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o_ref,
                                 lse, do, **mask)

        def run(t):
            o = ops.attention(q, k, v, tuner=t, **mask)
            return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

        def check(out, _):
            fwd = _rel(out[:1], [o_ref])
            bwd = max(_rel(out[1:2], want[:1]), _rel(out[2:], want[1:]))
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(out, (o_ref, *want)))
            return err, fwd <= LIMITS["flash_fwd"] and \
                bwd <= LIMITS["flash_bwd"]
        return _Work(run, check)

    if case.which == "wkv_bwd":
        b, h, t_, dk, dv = shape
        r, k, v = (rand(b, h, t_, dk), rand(b, h, t_, dk), rand(b, h, t_, dv))
        w = rand(b, h, t_, dk, scale=0.5, dtype=torch.float32)
        u = rand(h, dk, scale=0.3, dtype=torch.float32)
        s0 = rand(b, h, dk, dv, scale=0.2, dtype=torch.float32)
        dout = rand(b, h, t_, dv)
        xs = [x.requires_grad_(True) for x in (r, k, v, w, u, s0)]
        want = ref.rwkv6_wkv_bwd(*(x.detach() for x in xs), dout, None)

        def run(t):
            out, _ = ops.rwkv6_wkv(*xs, tuner=t)
            return torch.autograd.grad(out, xs, dout)

        def check(out, _):
            rel = max(_rel([g], [w_]) for g, w_ in zip(out, want))
            err = max(float((g.float() - w_.float()).abs().max())
                      for g, w_ in zip(out, want))
            return err, rel <= LIMITS["wkv_bwd"]
        return _Work(run, check)

    b, t_, din, n = shape
    xs = rand(b, t_, din)
    dt = torch.nn.functional.softplus(rand(b, t_) - 1.0)
    a = -torch.exp(rand(din, n, scale=0.5))
    args = (xs, dt, rand(b, t_, n), rand(b, t_, n), a, rand(din),
            rand(b, din, n, scale=0.5))
    if case.which == "scan_fwd":
        want = ref.selective_scan(*args)

        def run(t):
            return ops.selective_scan(*args, tuner=t)

        def check(out, _):
            err = max(float((g - w_).abs().max()) for g, w_ in zip(out, want))
            return err, _rel(out, want) <= LIMITS["scan_fwd"]
        return _Work(run, check)

    dy = rand(b, t_, din)
    wants: Dict[int, tuple] = {}

    def run(t):
        if xs.is_cuda:
            _, _, ckpt = selective_scan.selective_scan(*args,
                                                       checkpoints=True,
                                                       tuner=t)
            return selective_scan.selective_scan_bwd(*args[:6], ckpt, dy,
                                                     None, tuner=t)
        return ref.selective_scan_bwd(*args, dy, None)

    def check(out, params):
        geo = selective_scan._bwd_geometry(params, b, t_, din, n)
        segments = geo.segments if xs.is_cuda else 1
        if segments not in wants:
            wants[segments] = ref.selective_scan_bwd(*args, dy, None,
                                                     segments=segments)
        want = wants[segments]
        err = max(float((g - w_).abs().max()) for g, w_ in zip(out, want))
        return err, max(_rel([g], [w_]) for g, w_ in zip(out, want)) \
            <= LIMITS["scan_bwd"]
    return _Work(run, check)


def _reps(case: Case) -> int:
    return {"ddim": 200, "resid": 200, "update": 200, "flash": 5,
            "wkv_bwd": 5, "scan_fwd": 20 if case.shape[1] > 1 else 200,
            "scan_bwd": 10}[case.which]


def _time_us(run: Callable, tuner, reps: int) -> float:
    """Microseconds a call of ``run(tuner)``, by CUDA events over ``reps``
    calls (the card synchronized before)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        run(tuner)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def _in_turns(run, tuners, reps: int, runs: int) -> List[List[float]]:
    """``runs`` timed runs of each tuner's config, in turns (a, b, b, a,
    a, b, ...), after a warm-up call each."""
    for t in tuners:
        run(t)
    out = [[] for _ in tuners]
    order = list(range(len(tuners)))
    for i in range(runs):
        for j in (order if i % 2 == 0 else order[::-1]):
            out[j].append(_time_us(run, tuners[j], reps))
    return out


def _beats(new: List[float], old: List[float]) -> bool:
    """Every run of ``new`` faster than every run of ``old``: a win by
    more than the runs' spread."""
    return max(new) < min(old)


def build_variants(cases=CASES) -> List[tuple]:
    """The ``(source, defines)`` builds the build candidates need."""
    out = set()
    for case in cases:
        base = dict(tuning.resolve(case.family, backend="cpu").params)
        for knob in case.knobs:
            if not _is_build(case.family, knob):
                continue
            for value in candidates(knob):
                params = dict(base, **{knob: value})
                source = tuning.BUILD_PARAMS[case.family][knob][0]
                d = tuning.defines(case.family, params, source)
                if d:
                    out.add((source, d))
    return sorted(out)


def sweep_key(case: Case, device, launch_only: bool = False,
              log=print) -> Optional[dict]:
    """Sweep one key on the card; returns its table entry (with
    ``tuned_us``, ``default_us``, ``spread_us`` and ``runs``) when the
    winner beats the heuristic by more than the spread, else None."""
    backend = tuning.backend_of(device)
    work = _work(case, case.shape, device)
    bucket = tuning.bucket_for(case.family, tuning_shape(case))
    default = dict(tuning.KernelTuner(tables={backend: {
        "version": tuning.TABLE_SCHEMA_VERSION, "backend": backend,
        "entries": []}}).resolve(case.family, backend=backend,
                                 dtype=case.dtype,
                                 shape=tuning_shape(case)).params)
    runs = LAUNCH_ONLY_RUNS if launch_only else RUNS
    reps = max(1, _reps(case) // (4 if launch_only else 1))
    best = dict(default)
    err, ok = work.check(work.run(_tuner(backend, case.family, best)), best)
    if not ok:
        raise AssertionError(f"{case.label}: the heuristic config misses "
                             f"its plain version (max abs err {err})")
    for knob in case.knobs:
        if launch_only and _is_build(case.family, knob):
            continue
        for value in candidates(knob):
            if value == best[knob]:
                continue
            params = dict(best, **{knob: value})
            tuner = _tuner(backend, case.family, params)
            err, ok = work.check(work.run(tuner), params)
            if not ok:
                raise AssertionError(
                    f"{case.label}: candidate {knob}={value} misses the "
                    f"plain version (max abs err {err})")
            new, old = _in_turns(work.run, [tuner, _tuner(
                backend, case.family, best)], reps, runs)
            log(f"  {case.label}: {knob}={value}: "
                f"{np.median(new):.2f} us against {np.median(old):.2f} "
                f"(max abs err {err:.3g})")
            if _beats(new, old):
                best = params
    if best == default:
        log(f"  {case.label}: the heuristic config stays")
        return None
    tuned, dflt = _in_turns(work.run, [_tuner(backend, case.family, best),
                                       _tuner(backend, case.family,
                                              default)], reps, runs)
    spread = max(max(tuned) - min(tuned), max(dflt) - min(dflt))
    changed = {k: v for k, v in best.items() if v != default[k]}
    log(f"  {case.label}: {changed}: {np.median(tuned):.2f} us against "
        f"the heuristic's {np.median(dflt):.2f} (spread {spread:.2f})")
    if not _beats(tuned, dflt):
        return None
    return {"kernel": case.family, "dtype": str(case.dtype).replace(
        "torch.", ""), "bucket": list(bucket), "params": changed,
        "tuned_us": round(float(np.median(tuned)), 3),
        "default_us": round(float(np.median(dflt)), 3),
        "spread_us": round(float(spread), 3), "runs": runs,
        "case": case.label}


def _merge(entries: List[dict]) -> List[dict]:
    """One entry a key: two cases of one key (the flash forward's and the
    backward's knobs are one family) merge their parameters."""
    by_key: Dict[tuple, dict] = {}
    for e in entries:
        key = (e["kernel"], e["dtype"], tuple(e["bucket"]))
        if key in by_key:
            by_key[key]["params"].update(e["params"])
            by_key[key]["case"] += "; " + e["case"]
        else:
            by_key[key] = e
    return list(by_key.values())


def round_trip(payload: dict) -> None:
    """Validate ``payload`` and resolve each of its entries through a
    tuner built on it: ``source == "table"`` with the entry's params."""
    tuning.validate_table(payload, "<autotune sweep>")
    backend = payload["backend"]
    tuner = tuning.KernelTuner(tables={backend: payload})
    for e in payload["entries"]:
        cfg = tuner.resolve(e["kernel"], backend=backend, dtype=e["dtype"],
                            shape=tuple(e["bucket"]))
        assert cfg.source == "table", cfg
        assert all(cfg.params[p] == v for p, v in e["params"].items()), cfg


def sweep(device="cuda", launch_only: bool = False, cases=CASES,
          commit: str = "", log=print) -> dict:
    """The sweep on the card; returns the validated, round-tripped
    payload."""
    from .common import smi_line
    device = torch.device(device)
    if device.type != "cuda":
        raise SystemExit("autotune_kernels: the sweep times kernels on the "
                         "card; on the CPU run --smoke")
    if not launch_only:
        secs = _build.build_all(extra=build_variants(cases))
        log(f"  built {len(build_variants(cases))} build candidate(s) and "
            f"the sources in {secs:.1f} s")
    entries = []
    for case in cases:
        e = sweep_key(case, device, launch_only, log)
        if e is not None:
            entries.append(e)
    payload = {
        "version": tuning.TABLE_SCHEMA_VERSION,
        "backend": tuning.backend_of(device),
        "comment": ("measured by repro_torch.benchmarks.autotune_kernels: "
                    "only entries that beat the heuristic config by more "
                    "than the spread of their runs"),
        "provenance": {"card": smi_line(), "commit": commit,
                       "torch": torch.__version__, "cuda": torch.version.cuda,
                       "runs": LAUNCH_ONLY_RUNS if launch_only else RUNS,
                       "launch_only": launch_only},
        "entries": _merge(entries)}
    round_trip(payload)
    return payload


def smoke(log=print) -> dict:
    """The structural checks on the CPU: each case at a small shape, every
    candidate's geometry resolved through an override (``launch_geometry``
    shows it), the op on that tuner against the plain version, then a
    payload of one candidate a key validated and round-tripped.  Times
    nothing."""
    device = torch.device("cpu")
    entries = []
    for case in CASES:
        shape = SMOKE_SHAPES[case.which]
        work = _work(case, shape, device)
        bucket = tuning.bucket_for(case.family, tuning_shape(case, shape))
        picked = {}
        for knob in case.knobs:
            for value in candidates(knob):
                tuner = _tuner("cpu", case.family, {knob: value})
                cfg = tuning.config(case.family, tuner, device, case.dtype,
                                    tuning_shape(case, shape))
                assert cfg.source == "override" and cfg.params[knob] == value
                err, ok = work.check(work.run(tuner), dict(cfg.params))
                assert ok, (case.label, knob, value, err)
                if value != tuning.default(case.family, knob):
                    picked.setdefault(knob, value)
        entries.append({"kernel": case.family,
                        "dtype": str(case.dtype).replace("torch.", ""),
                        "bucket": list(bucket), "params": picked,
                        "case": case.label})
        log(f"  smoke {case.label}: {len(case.knobs)} knob(s) checked")
    payload = {"version": tuning.TABLE_SCHEMA_VERSION, "backend": "cpu",
               "comment": "--smoke: structural checks only, nothing timed; "
                          "not a table to commit",
               "entries": _merge(entries)}
    round_trip(payload)
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="structural checks on the CPU; times nothing")
    ap.add_argument("--launch-only", action="store_true",
                    help="launch parameters only (no nvcc), shorter runs")
    ap.add_argument("--write-table", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="write the table (default: the committed "
                         "tuning_tables/<backend>.json)")
    ap.add_argument("--commit", default="",
                    help="the source's commit, for the provenance")
    args = ap.parse_args(argv)
    if args.smoke:
        payload = smoke()
    else:
        if not torch.cuda.is_available():
            print("autotune_kernels: the sweep needs the card (times on the "
                  "CPU would tune the plain versions); run --smoke here",
                  file=sys.stderr)
            return 2
        from repro_torch.launch.env import configure_platform
        configure_platform("gpu")
        payload = sweep("cuda", launch_only=args.launch_only,
                        commit=args.commit)
    print(json.dumps(payload, indent=2, sort_keys=True))
    if args.write_table is not None:
        if args.smoke or args.launch_only:
            print("autotune_kernels: --write-table needs the full sweep",
                  file=sys.stderr)
            return 2
        path = args.write_table or os.path.join(
            tuning.TABLE_DIR, f"{payload['backend']}.json")
        if not payload["entries"]:
            print(f"autotune_kernels: no entry beat the heuristics by more "
                  f"than its spread; {path} not written")
            return 0
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
