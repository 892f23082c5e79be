"""Table 2: StableDiffusion-v2-like latent diffusion, DDIM 100/25, vanilla
SRDS with iteration budgets; the CLIP score is replaced by the error
against the sequential solve, beside wall seconds on one device
(counterpart of ``benchmarks/table2_sd.py``).

By default the model is the JAX emitter's small DiT (weights from a numpy
seed).  ``--arch srds-dit-sd2`` runs the paper's Table 2 model at full
width and depth (28 layers, d 1152, bf16, 64x64x4 latents) with weights
drawn from ``--seed`` by numpy and K=1: SRDS against the sequential
sampler in wall seconds on the card, each the median of ``--repeats``.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_sd \\
        [--device cpu] [--arch srds-dit-sd2 --repeats 3]
"""
import numpy as np
import torch

from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import (emit, parser, resolve_device, run_pair, small_dit,
                     smi_line, toy_array)

CASES = [(100, None), (25, 1), (25, 3)]     # (N, max_iters)


def rows(model_fn, x0, cases=tuple(CASES), repeats: int = 3):
    out = []
    for n, max_iter in cases:
        sched = make_schedule("ddpm_linear", n)
        cfg = SRDSConfig(tol=1e-3, max_iters=max_iter)
        r = run_pair(model_fn, sched, SolverConfig("ddim"), x0, cfg,
                     repeats=repeats)
        speed = r["t_seq"] / r["t_srds"]
        name = f"table2/ddim{n}_maxit{max_iter}"
        emit(name, r["t_srds"] * 1e6,
             f"iters={r['iters']};eff_serial={r['eff_serial']};"
             f"total={r['total']};err={r['err']:.2e};"
             f"t_seq={r['t_seq']:.4f}s;t_srds={r['t_srds']:.4f}s;"
             f"speedup={speed:.2f}x")
        out.append(dict(name=name, n=n, max_iters=max_iter, iters=r["iters"],
                        eff_serial=r["eff_serial"], total=r["total"],
                        err=r["err"], t_seq_s=r["t_seq"],
                        t_srds_s=r["t_srds"], speedup=speed))
    return out


def full_model(arch: str, seed: int, device):
    """``(model_fn, x0)``: ``arch`` at full width and depth, its weights
    and one 64x64x4 latent drawn from ``seed`` by numpy."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dit
    cfg = get_arch(arch)
    model = dit.load_jax_params(cfg, dit.random_jax_tree(cfg, seed=seed),
                                device=device)
    x0 = np.random.default_rng(seed).standard_normal(
        (1, 64, 64, cfg.in_channels)).astype(np.float32)
    return dit.make_denoiser(model), torch.from_numpy(x0).to(device)


def main(device="cuda", arch=None, seed: int = 0, repeats: int = 3):
    device = resolve_device(device)
    if arch is None:
        model_fn, _, _ = small_dit(layers=2, d=64, img=16, seed=3,
                                   device=device)
        x0 = toy_array("x0_table2", device)
    else:
        model_fn, x0 = full_model(arch, seed, device)
        if x0.is_cuda:
            print(f"# {arch} on {smi_line()}, torch {torch.__version__}",
                  flush=True)
    return rows(model_fn, x0, repeats=repeats)


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--arch", default=None, choices=("srds-dit-sd2",),
                    help="the paper's latent DiT at full size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    main(device=resolve_device(args.device), arch=args.arch, seed=args.seed,
         repeats=args.repeats)
