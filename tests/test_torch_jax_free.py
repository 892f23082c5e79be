"""The port imports no JAX and nothing of the JAX package.

A fresh interpreter installs an import hook that refuses ``jax``,
``jaxlib`` and every ``repro`` module, then imports every module of
``src/repro_torch`` (the kernels, the core, the model, training and the
serving path).  The card's machine has no JAX at all, so an import that
slipped in would only show there.
"""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

BLOCKER = """
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(len(sys.argv) - 1)
"""


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


@pytest.mark.slow
def test_port_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serve.diffusion" in mods
    assert "repro_torch.core.accel" in mods
    assert "repro_torch.core.paradigms" in mods
    assert "repro_torch.benchmarks.check_counts" in mods
    assert "repro_torch.benchmarks.table11_truncation" in mods
    for name in ("launch.specs", "launch.dryrun", "launch.dryrun_all",
                 "analysis.markers", "benchmarks.roofline"):
        assert f"repro_torch.{name}" in mods
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", BLOCKER, *mods],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == str(len(mods))


def _imported_roots(path: pathlib.Path):
    """The top-level names every ``import`` and ``from ... import`` of a
    file names, read from its AST (relative imports excluded)."""
    import ast
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_examples_import_no_jax_or_repro():
    """No ``examples/torch_*.py`` imports ``jax``, ``jaxlib`` or the JAX
    package (by an AST read of every import statement, at any depth);
    each imports ``repro_torch``.  The control: JAX's own
    ``examples/quickstart.py`` is caught."""
    files = sorted((REPO / "examples").glob("torch_*.py"))
    assert [f.name for f in files] == [
        "torch_quickstart.py", "torch_serve_diffusion_slo.py",
        "torch_serve_llm.py", "torch_srds_sampling.py",
        "torch_train_diffusion.py"]
    banned = {"jax", "jaxlib", "repro"}
    for f in files:
        roots = _imported_roots(f)
        assert not roots & banned, (f.name, roots & banned)
        assert "repro_torch" in roots, f.name
    assert _imported_roots(REPO / "examples" / "quickstart.py") & banned
