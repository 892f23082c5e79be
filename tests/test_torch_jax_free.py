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
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", BLOCKER, *mods],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == str(len(mods))
