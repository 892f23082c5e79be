#!/usr/bin/env python
"""Write ``src/repro_torch/benchmarks/toy_inputs.npz``: the toy weights and
inputs that the JAX package's paper-table emitters draw with
``jax.random``, for the port's emitters, which cannot import JAX.

    PYTHONPATH=src python scripts/torch_toy_inputs.py [--check]

The toy weights are read out of the JAX emitters' own model closures
(``benchmarks.common.toy_denoiser``, ``benchmarks.table13_accel.
slow_model``) or redrawn as ``benchmarks.table6_devices`` draws them in
its subprocess; each emitter's ``x0`` is redrawn with its key and shape.
Everything is drawn in JAX's default 32-bit mode, as the emitters run.
``--check`` compares the committed file instead of writing it (exit 1
on any difference); ``tests/test_torch_bench.py`` makes the same check.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "benchmarks",
                   "toy_inputs.npz")

# (array name, PRNGKey, shape) of each emitter's x0 (benchmarks/*.py)
X0 = [("x0_table11", 0, (2, 16)),          # table11_truncation.SEED
      ("x0_table12", 0, (2, 16)),          # table12_window.SEED
      ("x0_table13", 1, (16,)),            # table13_accel.SEED
      ("x0_prop4", 5, (1, 16)),
      ("x0_table4", 2, (1, 16)),
      ("x0_table5", 3, (1, 16)),
      ("x0_table1_img32", 7, (1, 32, 32, 3)),
      ("x0_table1_img16", 7, (1, 16, 16, 3)),
      ("x0_table2", 11, (1, 16, 16, 3)),
      ("x0_table8", 4, (1, 16, 16, 3)),
      ("x0_table3", 1, (1, 16)),
      ("x0_table6", 1, (1, 16))]          # table6_devices.CODE's x0


def _closure(fn) -> dict:
    return {name: cell.cell_contents
            for name, cell in zip(fn.__code__.co_freevars, fn.__closure__)}


def jax_toy_inputs() -> dict:
    """Every array, drawn by JAX as its emitters draw them."""
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from benchmarks.common import toy_denoiser
    from benchmarks.table13_accel import slow_model

    with jax.enable_x64(False):
        toy = _closure(toy_denoiser())
        slow = _closure(slow_model())
        out = {"toy_w1": toy["w1"], "toy_w2": toy["w2"],
               "slow_w": slow["w"], "slow_ph": slow["ph"],
               "slow_a": slow["a"]}
        # table6_devices.CODE's model weights
        out["table6_w"] = jax.random.normal(jax.random.PRNGKey(0),
                                            (16, 16)) * 0.4
        for name, key, shape in X0:
            out[name] = jax.random.normal(jax.random.PRNGKey(key), shape,
                                          jnp.float32)
        return {k: np.asarray(v) for k, v in out.items()}


def main() -> int:
    arrays = jax_toy_inputs()
    if "--check" in sys.argv[1:]:
        with np.load(OUT) as f:
            same = (sorted(f.files) == sorted(arrays) and all(
                f[k].dtype == v.dtype and np.array_equal(f[k], v)
                for k, v in arrays.items()))
        print("toy_inputs.npz " + ("matches" if same else "DIFFERS"))
        return 0 if same else 1
    np.savez(OUT, **arrays)
    print(f"wrote {OUT}: " + ", ".join(
        f"{k} {v.shape} {v.dtype}" for k, v in sorted(arrays.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
