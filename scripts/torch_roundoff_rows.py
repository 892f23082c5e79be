#!/usr/bin/env python
"""Why some paper-table counts differ between the JAX package and the port
on the same inputs (ROADMAP C15): print, for ``table11/n100_tol1e-05``,
the JAX emitter's and the port's residual history side by side (both in
f32, JAX in its default 32-bit mode as its emitter runs), the magnitude
of the sample, and the share of the toy denoiser's outputs, and of its
``tanh`` and matmul alone, that differ between the two frameworks on the
same f32 inputs.

    PYTHONPATH=src python scripts/torch_roundoff_rows.py

Needs JAX and PyTorch on the CPU; changes nothing.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    import repro.core as J
    import repro_torch.core as T
    from benchmarks.common import toy_denoiser
    from repro_torch.benchmarks import common

    tol = 1e-5
    with jax.enable_x64(False):
        model = toy_denoiser()
        x0 = jax.random.normal(jax.random.PRNGKey(0), (2, 16))
        res = jax.jit(lambda x: J.srds_sample(
            model, J.make_schedule("ddpm_linear", 100), J.SolverConfig("ddim"),
            x, J.SRDSConfig(tol=tol)))(x0)
        jhist = np.asarray(res.delta_history)
        scale = float(jnp.mean(jnp.abs(res.sample)))
        print(f"JAX:   iterations {int(res.iterations)}, mean |sample| "
              f"{scale:.3f}")
        x = np.random.default_rng(0).standard_normal((200, 16)).astype(
            np.float32) * 3
        w1 = common.toy_inputs()["toy_w1"]
        jm = np.asarray(jax.jit(model)(jnp.asarray(x), np.float32(500.0)))
        jmat = np.asarray(jax.jit(lambda a: a @ jnp.asarray(w1))(
            jnp.asarray(x)))
        jtanh = np.asarray(jax.jit(jnp.tanh)(jnp.asarray(x)))
    tres = T.srds_sample(common.toy_denoiser("cpu"),
                         T.make_schedule("ddpm_linear", 100),
                         T.SolverConfig("ddim"),
                         common.toy_array("x0_table11", "cpu"),
                         T.SRDSConfig(tol=tol))
    print(f"torch: iterations {int(tres.iterations)}")
    print("refinement  JAX residual  port residual  (tol 1e-5)")
    for p, (a, b) in enumerate(zip(jhist, tres.delta_history.numpy())):
        print(f"{p + 1:10d}  {a:12.4e}  {b:13.4e}")
    tx = torch.from_numpy(x)
    tm = common.toy_denoiser("cpu")(tx, torch.full((200,), 500.0)).numpy()
    tmat = (tx @ torch.from_numpy(w1)).numpy()
    print(f"outputs differing on the same f32 inputs: toy model "
          f"{np.mean(jm != tm):.3f}, tanh {np.mean(jtanh != torch.tanh(tx).numpy()):.3f}, "
          f"x @ w1 {np.mean(jmat != tmat):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
