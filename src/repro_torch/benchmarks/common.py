"""Shared pieces of the port's paper-table emitters (counterpart of
``benchmarks/common.py``): the CSV line, timing, the sequential/SRDS
pair, the toy denoiser and a small DiT.

The deterministic outputs — iterations, serial and total evals — are the
paper's hardware-independent units and must equal the JAX emitters' on
the same inputs; wall seconds are readings of the device they ran on.
The toy weights and every toy emitter's ``x0`` come from
``toy_inputs.npz`` beside this file: the JAX emitters draw them with
``jax.random``, which torch cannot reproduce, so they are committed (a
CPU test redraws them with JAX and holds the file to them bitwise).

Entry points run on the card unless ``--device cpu`` (on the command
line) or ``device="cpu"`` (in Python) is given:

    PYTHONPATH=src python -m repro_torch.benchmarks.table11_truncation \\
        --device cpu --out BENCH_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import functools
import json
import os
import platform
import subprocess
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import (sample_sequential, srds_sample, srds_stats)

ROWS = []
INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "toy_inputs.npz")


def emit(name: str, us_per_call: float, derived: str):
    line = f"{name},{us_per_call:.1f},{derived}"
    ROWS.append(line)
    print(line, flush=True)


@functools.lru_cache(maxsize=None)
def toy_inputs() -> Dict[str, np.ndarray]:
    """The JAX emitters' toy weights and inputs (f32 numpy arrays)."""
    with np.load(INPUTS) as f:
        return {k: f[k] for k in f.files}


def toy_array(name: str, device) -> torch.Tensor:
    return torch.from_numpy(toy_inputs()[name].copy()).to(device)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or on the CPU")
    return ap


def resolve_device(name) -> torch.device:
    """``name`` (a string or a device) as a device: raises when it is the
    card and CUDA is not available."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    return dev


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_noise(seed: int, shape, dtype, device) -> torch.Tensor:
    """A served request's ``x_init``: ``N(0, I)`` from a CPU generator
    seeded with ``seed``, copied to ``device``, so the card and the CPU
    serve the same latents (the serving emitters' ``noise_fn``)."""
    from repro_torch.transfer import host_to_device
    g = torch.Generator().manual_seed(int(seed))
    return host_to_device(torch.randn(shape, generator=g, dtype=dtype),
                          device)


def toy_denoiser(device="cuda", dtype=torch.float32):
    """The JAX emitters' smooth nonlinear eps model (``toy_denoiser()``:
    dim 16, seed 0): x (M, 16), t (M,); its f32 weights cast to
    ``dtype``."""
    device = resolve_device(device)
    w1, w2 = (toy_array(k, device).to(dtype) for k in ("toy_w1", "toy_w2"))

    def model_fn(x, t):
        h = torch.tanh(x @ w1) * (0.4 + 3e-4 * t[:, None])
        return torch.tanh(h @ w2 + x * 0.1)

    return model_fn


def small_dit(name: str = "srds-dit-cifar", layers: int = 2, d: int = 64,
              img: int = 16, seed: int = 0, device="cuda"):
    """A tiny-but-real DiT denoiser (attention + adaLN) at the JAX
    emitters' widths, f32, its weights drawn from ``seed`` by numpy
    (``dit.random_jax_tree``).  Returns ``(model_fn, cfg, img)``."""
    from repro_torch.models import dit
    device = resolve_device(device)
    cfg = dc.replace(get_arch(name), num_layers=layers, d_model=d,
                     num_heads=4, num_kv_heads=4, head_dim=d // 4,
                     d_ff=4 * d, patch_size=4, dtype="float32")
    model = dit.load_jax_params(cfg, dit.random_jax_tree(cfg, seed=seed),
                                device=device)
    return dit.make_denoiser(model), cfg, img


def timeit(fn: Callable, repeats: int = 3, *, device) -> float:
    """Median wall seconds of ``fn()`` after one warm-up call, the device
    synchronized before and after each call."""
    fn()
    ts = []
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def run_pair(model_fn, sched, solver, x0, srds_cfg, repeats: int = 3):
    """The sequential and SRDS samples of ``x0``, their median wall
    seconds and SRDS's eval accounting, vanilla and wavefront-pipelined
    (``eff_serial_pipelined``, ``proj_speedup_pipelined``)."""
    dev = x0.device

    def seq():
        return sample_sequential(model_fn, sched, solver, x0)

    def srd():
        return srds_sample(model_fn, sched, solver, x0, srds_cfg)

    t_seq = timeit(seq, repeats=repeats, device=dev)
    t_srds = timeit(srd, repeats=repeats, device=dev)
    res, ref = srd(), seq()
    err = float((res.sample - ref).abs().mean())
    iters = int(res.iterations)
    st = srds_stats(sched, solver, srds_cfg, iters)
    stp = srds_stats(sched, solver, srds_cfg, iters, pipelined=True)
    seq_evals = sched.num_steps * solver.evals_per_step
    return dict(t_seq=t_seq, t_srds=t_srds, err=err, iters=iters,
                eff_serial=st.serial_evals, total=st.total_evals,
                eff_serial_pipelined=stp.serial_evals, seq_evals=seq_evals,
                proj_speedup=seq_evals / max(st.serial_evals, 1),
                proj_speedup_pipelined=seq_evals / max(stp.serial_evals, 1))


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def meta(device) -> dict:
    """The run's provenance for an ``--out`` JSON."""
    m = {"framework": "torch", "torch_version": torch.__version__,
         "backend": torch.device(device).type,
         "python": platform.python_version()}
    if m["backend"] == "cuda":
        m["device"] = smi_line()
    return m


def merge_out(out: str, rows, meta_key: str, meta_val, device):
    """Append ``rows`` into the JSON artifact ``out`` (created if absent;
    same-name rows replaced), so table11-13 share one file."""
    payload = {"schema": 1, "meta": {}, "rows": []}
    if out and os.path.exists(out):
        with open(out) as f:
            payload = json.load(f)
    payload.setdefault("meta", {}).update(meta(device))
    payload["meta"][meta_key] = meta_val
    names = {r["name"] for r in rows}
    payload["rows"] = [r for r in payload.get("rows", [])
                       if r["name"] not in names] + list(rows)
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {out}")
    return payload
