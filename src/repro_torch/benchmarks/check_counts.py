"""The port's gate on deterministic counts (counterpart of
``benchmarks/check_bench_core.py``).

Reads the port's table6/11/12/13 JSON artifact and the JAX package's
committed baseline (``benchmarks/baselines/BENCH_core_baseline.json``,
read only) and requires every count a baseline row carries —
``iterations``, ``evals_*``, ``serial_*`` and ``iters_*`` (not the
``*_pct`` ratios, not wall seconds) — to be exactly equal; a baseline row
missing from the artifact fails too, and so do a table13 headline row
that missed its >= 25% iteration cut and a row whose ``within_tol`` is
false (table6's ``mesh_t2d2m2``: the model-parallel DiT against the
single-process sampler, a verdict of the current run alone).  Rows of
tables the port has no emitter for yet are skipped with their ROADMAP
item (``SKIPPED``; none is left).

table14's kernel rows are gated on the current run alone, as JAX's
``check_bench_core`` gates them: every row's ``parity_ok`` must be true
and its tuning provenance present and well formed (``config_source`` one
of table/heuristic/override, ``config_params`` a non-empty object); a
baseline table14 row (JAX's, named by its backend) needs a current row of
its kernel family on any backend, since the card's rows are named
``table14/sm90/...``.

Known divergences, each named in ROADMAP §C, are reported and not
failed:

* reference divergences (``REFERENCE``): the JAX package on this tree
  (jax 0.9.0) no longer reproduces the baseline (jax 0.4.37) on these
  fields; the port is held to the JAX package's value instead;
* roundoff rows (``ROUNDOFF``): the count is decided by a residual inside
  f32 roundoff, where JAX's and PyTorch's rounding (their ``tanh`` and
  matmuls round differently) take different sides; the port's value is
  printed beside both references (``scripts/torch_roundoff_rows.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.check_counts \\
        --current BENCH_torch.json \\
        --baseline benchmarks/baselines/BENCH_core_baseline.json

Exit 0 when only known divergences remain, 1 on any other mismatch.
"""
import argparse
import json
import sys

SKIPPED = {}
# row -> (ROADMAP item, {field: the JAX package's value on this tree})
REFERENCE = {
    "table12/n100_wtol0.01": ("C14", {"evals_window": 384}),
    "table12/n100_wtol0.001": ("C14", {"evals_window": 428}),
    "table12/n100_wtol0.0001": ("C14", {"evals_window": 494}),
    "table12/n1000_wtol0.001": ("C14", {"evals_window": 3756,
                                        "iterations": 5}),
    "table12/n1000_wtol0.0001": ("C14", {"evals_window": 4289}),
    "table13/n100_tol3": ("C5", {"iters_plain": 7, "evals_plain": 780}),
    "table13/n100_tol0.1": ("C14", {"iters_plain": 9, "evals_plain": 1000}),
}
# row -> (ROADMAP item, fields decided inside f32 roundoff)
ROUNDOFF = {
    "table11/n100_tol1e-05": ("C15", ("iterations", "evals_truncated",
                                      "evals_untruncated",
                                      "serial_truncated",
                                      "serial_untruncated")),
    "table12/n1000_wtol0.001": ("C15", ("evals_window", "iterations")),
    "table12/n1000_wtol0.0001": ("C15", ("evals_window", "iterations")),
}
# a table13 headline row may miss its cut only where the JAX package does
HEADLINE_EXEMPT = {"table13/n100_tol3": "C5"}


def _counted(field: str) -> bool:
    return (field == "iterations"
            or field.startswith(("evals_", "serial_", "iters_"))
            and not field.endswith("_pct"))


def _table14(current: dict, baseline: dict):
    """table14's failures, from the current run alone (module docstring)."""
    failures = []
    rows = [r for r in current.get("rows", [])
            if r["name"].startswith("table14/")]
    families = {r["name"].split("/")[-1] for r in rows}
    for base in baseline.get("rows", []):
        if base["name"].startswith("table14/") and \
                base["name"].split("/")[-1] not in families:
            failures.append(f"{base['name']}: no table14 row of the "
                            f"{base['name'].split('/')[-1]} family in the "
                            f"current artifact")
    for r in rows:
        name = r["name"]
        if r.get("parity_ok") is not True:
            failures.append(f"{name}: parity_ok is {r.get('parity_ok')!r} "
                            f"(kernel against its plain version: "
                            f"max_abs_diff={r.get('max_abs_diff')}, "
                            f"tol={r.get('tol')})")
        if r.get("config_source") not in ("table", "heuristic", "override"):
            failures.append(f"{name}: config_source "
                            f"{r.get('config_source')!r} is not one of "
                            f"table/heuristic/override (tuning provenance "
                            f"lost)")
        params = r.get("config_params")
        if not isinstance(params, dict) or not params:
            failures.append(f"{name}: config_params missing/empty (tuning "
                            f"provenance lost)")
    return failures


def check(current: dict, baseline: dict):
    """``(failures, notes)``: lists of strings; the gate passes when
    ``failures`` is empty."""
    failures, notes = [], []
    cur_rows = {r["name"]: r for r in current.get("rows", [])}
    failures += _table14(current, baseline)
    for base in baseline.get("rows", []):
        name = base["name"]
        table = name.split("/")[0]
        if table == "table14":
            continue
        if table in SKIPPED:
            notes.append(f"{name}: skipped (no port emitter yet, ROADMAP "
                         f"{SKIPPED[table]})")
            continue
        cur = cur_rows.get(name)
        if cur is None:
            failures.append(f"{name}: row missing from current artifact")
            continue
        ref_item, ref_vals = REFERENCE.get(name, (None, {}))
        ro_item, ro_fields = ROUNDOFF.get(name, (None, ()))
        for field in sorted(f for f in base if _counted(f)):
            want, got = base[field], cur.get(field)
            if field in ro_fields:
                jax_now = ref_vals.get(field, want)
                if got != jax_now:
                    notes.append(
                        f"{name}: {field} {got}, the JAX package {jax_now}, "
                        f"baseline {want}: decided inside f32 roundoff "
                        f"(ROADMAP {ro_item})")
                continue
            if field in ref_vals:
                if got == ref_vals[field]:
                    if got != want:
                        notes.append(
                            f"{name}: {field} {got} equals the JAX package "
                            f"on this tree; baseline {want} (ROADMAP "
                            f"{ref_item})")
                    continue
                failures.append(f"{name}: {field} {got} != the JAX "
                                f"package's {ref_vals[field]} (baseline "
                                f"{want})")
                continue
            if got != want:
                failures.append(f"{name}: {field} {got} != baseline {want}")
        if cur.get("within_tol") is False:
            failures.append(f"{name}: within_tol is false (max_abs_diff "
                            f"{cur.get('max_abs_diff')} > tol "
                            f"{cur.get('tol')})")
        if cur.get("headline_met") is False:
            if name in HEADLINE_EXEMPT:
                notes.append(f"{name}: headline iteration cut "
                             f"{cur['iters_saving_pct']:.1f}% under 25%, as "
                             f"in the JAX package (ROADMAP "
                             f"{HEADLINE_EXEMPT[name]})")
            else:
                failures.append(f"{name}: headline iteration cut "
                                f"{cur['iters_saving_pct']:.1f}% under 25%")
    return failures, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--current", required=True)
    ap.add_argument("--baseline", required=True)
    args = ap.parse_args(argv)
    with open(args.current) as f:
        current = json.load(f)
    with open(args.baseline) as f:
        baseline = json.load(f)
    failures, notes = check(current, baseline)
    for msg in notes:
        print(f"  known: {msg}")
    if failures:
        print("port count gate FAILED:", file=sys.stderr)
        for msg in failures:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    print(f"port count gate OK ({len(baseline.get('rows', []))} baseline "
          f"rows, {len(notes)} known divergences reported)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
