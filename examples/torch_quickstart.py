"""Quickstart for the PyTorch port: train a tiny DiT on synthetic images,
then sample with sequential DDIM vs SRDS and verify the
approximation-free property (``examples/quickstart.py``'s flow through
``repro_torch``).

  PYTHONPATH=src python examples/torch_quickstart.py [--steps 150] \
      [--device cpu]

It runs on the CUDA card (the flash attention, DDIM and residual
kernels) unless ``--device cpu`` is given (their plain PyTorch twins).
"""
import argparse
import dataclasses as dc
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (SolverConfig, SRDSConfig,  # noqa: E402
                              make_schedule, sample_sequential, srds_sample,
                              srds_stats)
from repro_torch.data import DataConfig, make_stream  # noqa: E402
from repro_torch.models.dit import (init_dit, make_denoiser,  # noqa: E402
                                    param_count, resolve_device)
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--n", type=int, default=100, help="denoising steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # tiny DiT on 16x16 synthetic images
    cfg = dc.replace(get_arch("srds-dit-cifar"), num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=4, head_dim=16, d_ff=256,
                     patch_size=4, dtype="float32")
    model = init_dit(cfg, torch.Generator().manual_seed(0), device=device)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(lr=2e-3), loss_kind="diffusion")
    stream = make_stream(cfg, DataConfig(global_batch=16, seq_len=0),
                         device=device)
    stream.size = 16
    gen = torch.Generator(device=device).manual_seed(0)
    print(f"training tiny DiT ({param_count(model):,} params)")
    first = None
    for s in range(args.steps):
        model, opt, m = step(model, opt, stream.batch(s), gen)
        if s == 0:
            first = float(m["loss"])
        if s % 30 == 0:
            print(f"  step {s}: mse={float(m['loss']):.4f}")
    last = float(m["loss"])
    assert last < first, "training should reduce the loss"

    # sample: sequential vs SRDS
    model_fn = make_denoiser(model)
    sched = make_schedule("ddpm_linear", args.n)
    solver = SolverConfig("ddim")
    x0 = torch.randn((4, 16, 16, 3), generator=torch.Generator()
                     .manual_seed(42)).to(device)
    ref = sample_sequential(model_fn, sched, solver, x0)
    scfg = SRDSConfig(tol=2e-3)
    res = srds_sample(model_fn, sched, solver, x0, scfg)
    iters = int(res.iterations)
    scale = float(ref.abs().mean())
    err = float((res.sample - ref).abs().mean()) / max(scale, 1e-9)
    st = srds_stats(sched, solver, scfg, iters)
    stp = srds_stats(sched, solver, scfg, iters, pipelined=True)
    print(f"\nsequential evals: {args.n}")
    print(f"SRDS: {iters} refinements, "
          f"eff-serial {st.serial_evals} (pipelined {stp.serial_evals}), "
          f"total {st.total_evals}")
    print(f"relative |SRDS - sequential| = {err:.2e}  "
          f"(== sequential up to the tolerance: approximation-free)")
    print(f"projected latency gain (pipelined): "
          f"{args.n / stp.serial_evals:.2f}x")
    return dict(first=first, last=last, iterations=iters, rel_err=err,
                serial_evals=st.serial_evals, total_evals=st.total_evals,
                pipelined_serial_evals=stp.serial_evals,
                sample=res.sample, ref=ref)


if __name__ == "__main__":
    main()
