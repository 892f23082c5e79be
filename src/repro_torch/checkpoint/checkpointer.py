"""Atomic, async checkpointing of nested dicts of tensors (no external
dependencies), the counterpart of ``repro.checkpoint.checkpointer``.

Layout, as in the JAX package:  <dir>/step_<N>/
                                    manifest.json  - leaf names, shapes,
                                                     dtypes, step, metadata
                                    host0.npz      - the leaf arrays
                                <dir>/LATEST       - pointer, written last

A tree is a nested ``Mapping`` of tensors; a leaf's name is its key path
joined by ``/`` (``params/blocks.0.attn.wq``, ``opt/m/...``), so the model's
and the optimizer's own names key the checkpoint.  Properties:

* atomic commit: the data goes to ``step_N.tmp``, then one rename and the
  ``LATEST`` pointer's replace; restore never sees a ``.tmp`` directory;
* async: :meth:`Checkpointer.save_async` copies every leaf to host memory
  at once (the step's state is then free to change) and writes it on a
  worker thread; :meth:`Checkpointer.wait` joins before the next save;
* ``keep`` newest steps survive, older ones are deleted after a commit;
* bf16 leaves are stored as their 16-bit pattern (npz has no bf16), so a
  round trip is bitwise;
* :meth:`Checkpointer.restore` copies into the template's own tensors, in
  place, by name, and raises on a missing leaf or a shape mismatch.

Multi-host layouts (one ``host<k>.npz`` per process) wait for the
multi-device port (ROADMAP A10(c)).
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

HOST_FILE = "host0.npz"


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def flatten(tree: Mapping, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every leaf of a nested mapping, in order."""
    out = []
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out += flatten(value, name + "/")
        else:
            out.append((name, value))
    return out


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_storable(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    # ---- save ------------------------------------------------------------

    def _write(self, step: int, snapshot, meta):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "leaves": [{"name": n, "shape": list(a.shape), "dtype": dt}
                       for n, a, dt in snapshot],
            "meta": meta or {},
            "hosts": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        np.savez(os.path.join(tmp, HOST_FILE),
                 **{_leaf_key(i): a for i, (_, a, _) in enumerate(snapshot)})
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    @staticmethod
    def _snapshot(tree: Mapping):
        return [(name, *_to_storable(t)) for name, t in flatten(tree)]

    def save(self, step: int, tree: Mapping, meta: Optional[dict] = None):
        self.wait()
        self._write(step, self._snapshot(tree), meta)

    def save_async(self, step: int, tree: Mapping,
                   meta: Optional[dict] = None):
        self.wait()
        snapshot = self._snapshot(tree)            # host copy, synchronous
        self._pending = self._pool.submit(self._write, step, snapshot, meta)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        self.wait()
        self._pool.shutdown()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---- restore -----------------------------------------------------------

    def all_steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(p) as f:
            return int(f.read().strip())

    @torch.no_grad()
    def restore(self, template: Mapping, step: Optional[int] = None):
        """Copy checkpoint ``step`` (default: the latest) into the tensors
        of ``template``, by leaf name.  Returns ``(template, step, meta)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        index: Dict[str, Tuple[int, dict]] = {
            leaf["name"]: (i, leaf) for i, leaf in enumerate(manifest["leaves"])}
        leaves = flatten(template)
        missing = [n for n, _ in leaves if n not in index]
        if missing or len(leaves) != len(index):
            raise ValueError(f"checkpoint step {step} has {len(index)} "
                             f"leaves, the template {len(leaves)}; missing: "
                             f"{missing[:5]}")
        for name, t in leaves:               # check all before any copy
            shape = tuple(index[name][1]["shape"])
            if shape != tuple(t.shape):
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{shape}, template {tuple(t.shape)}")
        with np.load(os.path.join(d, HOST_FILE)) as data:
            for name, t in leaves:
                i, leaf = index[name]
                t.copy_(_from_storable(data[_leaf_key(i)], leaf["dtype"]))
        return template, manifest["step"], manifest["meta"]
