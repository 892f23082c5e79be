"""The port's lint (``repro_torch.analysis``): RL003 and RL010 on small bad
fixtures and their good twins (written under ``tmp_path``), the port's
tree clean, the command line's exit codes, and the rule's knob set held
to the tuner's parameters.  No JAX, no card."""
import ast
import os
import sys
import textwrap

import pytest

from repro_torch.analysis import DEFAULT_PATHS, lint_paths, rule_table
from repro_torch.analysis import cli, rules
from repro_torch.kernels import tuning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(tmp_path, source, name="mod.py", where="src/repro_torch/serve"):
    d = tmp_path / where
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(textwrap.dedent(source))
    return lint_paths([str(d / name)], root=str(tmp_path))


RL003_BAD = """
import numpy as np
import torch


def hot_loop(fn):
    return fn


class Loop:
    @hot_loop
    def resolve(self, tok):
        resid = torch.stack(tok.parts)
        worst = resid.max().item()
        again = float(resid.sum())
        rows = resid.tolist()
        host = resid.cpu()
        arr = resid.numpy()
        also = np.asarray(torch.ones(3))
        torch.cuda.synchronize()
        return worst, again, rows, host, arr, also
"""

RL003_GOOD = """
import numpy as np
import torch


def hot_loop(fn):
    return fn


def _host_fetch(fetch):
    return fetch.host.numpy()


class Loop:
    @hot_loop
    def resolve(self, tok):
        fetched = _host_fetch(tok.fetch)
        worst = float(fetched.max())
        rows = fetched.tolist()
        ok = bool(fetched[0] < 1.0)
        hist = np.asarray(self.history, np.float32)
        return worst, rows, ok, hist

    def report(self, x):
        return x.item(), x.cpu(), torch.cuda.synchronize()
"""


def test_rl003_fires_on_every_sync_in_a_hot_loop(tmp_path):
    report = _lint(tmp_path, RL003_BAD)
    hits = [f for f in report.findings if f.code == "RL003"]
    said = " ".join(f.message for f in hits)
    for what in (".item()", "float()", ".tolist()", ".cpu()", ".numpy()",
                 "asarray()", "torch.cuda.synchronize()"):
        assert what in said, what
    assert len(hits) == 7


def test_rl003_silent_on_the_fetch_seam_and_outside_hot_loops(tmp_path):
    report = _lint(tmp_path, RL003_GOOD)
    assert report.clean, report.findings


RL010_BAD = """
from repro_torch.kernels import elementwise, selective_scan as scan


def setup(b, din, n, x):
    geo = scan.geometry(b, din, n, channels=32)
    bwd = scan.bwd_geometry(b, 2048, din, n, segment_chunks=4)
    res = elementwise.resid_geometry(4096, 4, True, max_threads=256)
    return geo, bwd, res
"""

RL010_GOOD = """
from repro_torch.kernels import ops, selective_scan as scan, tuning

CANDIDATE = {"channels": 32, "segment_chunks": 4}


def setup(b, din, n, x, params):
    tuner = tuning.KernelTuner(overrides={"selective_scan": CANDIDATE})
    geo = scan.geometry(b, din, n, channels=params["channels"])
    out = ops.selective_scan(*x, tuner=tuner)
    pinned = scan.geometry(b, din, n, channels=16)  # reprolint: disable=RL010
    return geo, out, pinned, dict(batch_dims=1)
"""


def test_rl010_fires_on_knob_literals_outside_the_kernels(tmp_path):
    report = _lint(tmp_path, RL010_BAD, where="scripts")
    assert sorted(f.message.split("`")[1] for f in report.findings) == [
        "channels", "max_threads", "segment_chunks"]
    assert {f.code for f in report.findings} == {"RL010"}


def test_rl010_silent_on_tuner_routed_twin(tmp_path):
    report = _lint(tmp_path, RL010_GOOD, where="scripts")
    assert report.clean, report.findings
    assert [f.code for f in report.suppressed] == ["RL010"]


def test_rl010_kernels_package_owns_its_literals(tmp_path):
    report = _lint(tmp_path, RL010_BAD, where="src/repro_torch/kernels")
    assert report.clean


def test_rl010_knobs_are_the_tuners_parameters():
    params = {name for kernel in tuning.KERNELS
              for name in tuning.resolve(kernel, backend="cpu").params}
    assert rules.RL010_KNOBS == params


def test_the_ports_tree_is_clean():
    """``python -m repro_torch.analysis`` on its default paths (the port's
    package, its tests and scripts, chip_smoke.py) finds nothing."""
    report = lint_paths(list(DEFAULT_PATHS), root=REPO)
    assert not report.errors, report.errors
    assert report.clean, [f.location() + " " + f.code
                          for f in report.findings]
    assert report.files_scanned > 100
    scanned = {p for p in (f.path for f in report.suppressed)}
    assert all(p.startswith(("src/repro_torch", "tests/", "scripts/",
                             "chip_smoke")) for p in scanned)


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "scripts" / "bad.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(RL010_BAD))
    assert cli.main([str(bad), "--root", str(tmp_path)]) == 1
    assert "RL010" in capsys.readouterr().out
    good = tmp_path / "scripts" / "good.py"
    good.write_text(textwrap.dedent(RL010_GOOD))
    assert cli.main([str(good), "--root", str(tmp_path)]) == 0
    assert cli.main([str(bad), "--root", str(tmp_path),
                     "--select", "RL003"]) == 0
    broken = tmp_path / "scripts" / "broken.py"
    broken.write_text("def (:\n")
    assert cli.main([str(broken), "--root", str(tmp_path)]) == 2
    assert cli.main(["--list-rules"]) == 0
    assert [c for c, _, _ in rule_table()] == ["RL003", "RL010"]
    assert cli.main(["--root", REPO]) == 0


def test_analysis_package_is_stdlib_only():
    """The lint imports neither torch nor numpy (it reads source), so it
    runs where only Python is installed."""
    pkg = os.path.join(REPO, "src", "repro_torch", "analysis")
    for name in os.listdir(pkg):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(pkg, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                root = mod.split(".")[0]
                assert root in sys.stdlib_module_names or \
                    mod.startswith("repro_torch.analysis") or \
                    root == "__future__", (name, mod)
