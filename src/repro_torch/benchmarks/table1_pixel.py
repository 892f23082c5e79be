"""Table 1: pixel-diffusion benchmarks (LSUN/ImageNet/CIFAR scales), N=1024
DDIM, SRDS at tol 1e-3 with 32 blocks (counterpart of
``benchmarks/table1_pixel.py``).  FID is out of reach offline: the
approximation-free property is measured directly (SRDS against the
sequential solve on the same model) beside the paper's eval accounting.
The small DiTs' weights are drawn from numpy seeds (not JAX's), so the
counts are the port's own; the CPU test feeds ``rows`` JAX's weights.

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_pixel \\
        [--device cpu]
"""
from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import (emit, parser, resolve_device, run_pair, small_dit,
                     toy_array)

N = 1024
BLOCKS = 32
# (row, small_dit kwargs, x0 array): the JAX emitter's three scales
MODELS = [("lsun_scale", dict(layers=2, d=64, img=32, seed=0),
           "x0_table1_img32"),
          ("imagenet_scale", dict(layers=2, d=64, img=16, seed=1),
           "x0_table1_img16"),
          ("cifar_scale", dict(layers=1, d=32, img=16, seed=2),
           "x0_table1_img16")]


def rows(models, n: int = N, blocks: int = BLOCKS, repeats: int = 3):
    """``models``: ``[(row, model_fn, x0)]``."""
    sched = make_schedule("ddpm_linear", n)
    solver = SolverConfig("ddim")
    out = []
    for name, model_fn, x0 in models:
        r = run_pair(model_fn, sched, solver, x0,
                     SRDSConfig(tol=1e-3, num_blocks=blocks),
                     repeats=repeats)
        row = f"table1/{name}"
        emit(row, r["t_srds"] * 1e6,
             f"iters={r['iters']};eff_serial={r['eff_serial']};"
             f"total={r['total']};seq={r['seq_evals']};"
             f"err_vs_seq={r['err']:.2e};"
             f"eff_frac={r['eff_serial']/r['seq_evals']:.2f}")
        out.append(dict(name=row, n=n, iters=r["iters"],
                        eff_serial=r["eff_serial"], total=r["total"],
                        seq_evals=r["seq_evals"], err=r["err"],
                        t_srds_s=r["t_srds"], t_seq_s=r["t_seq"]))
    return out


def main(device="cuda"):
    device = resolve_device(device)
    return rows([(name, small_dit(device=device, **kw)[0],
                  toy_array(x0, device)) for name, kw, x0 in MODELS])


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
