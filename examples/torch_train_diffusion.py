"""End-to-end driver for the PyTorch port: train a DiT diffusion model
with the full production stack (data pipeline, AdamW, checkpoint and
restart, the fault-tolerant loop), then sample from it with SRDS
(``examples/train_diffusion.py``'s flow through ``repro_torch``).

Presets:
  --preset cpu   ~1M-param DiT, 300 steps   (default; minutes on a CPU)
  --preset full  the ~100M srds-dit-cifar, a few hundred steps (the same
                 code path, for the card)

  PYTHONPATH=src python examples/torch_train_diffusion.py --preset cpu \
      [--device cpu]

It runs on the CUDA card (the flash attention forward and backward, DDIM
and residual kernels) unless ``--device cpu`` is given (their plain
PyTorch twins).  The checkpoints go to ``--ckpt`` (a rerun resumes
from it), by default to a temporary directory deleted at exit.
"""
import argparse
import dataclasses as dc
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (SolverConfig, SRDSConfig,  # noqa: E402
                              make_schedule, sample_sequential, srds_sample)
from repro_torch.data import DataConfig, make_stream  # noqa: E402
from repro_torch.models.dit import (init_dit, make_denoiser,  # noqa: E402
                                    param_count, resolve_device)
from repro_torch.optim import (AdamWConfig, init_opt_state,  # noqa: E402
                               warmup_cosine)
from repro_torch.runtime import (LoopConfig, PreemptionSignal,  # noqa: E402
                                 train_loop)
from repro_torch.train import make_train_step  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu", choices=["cpu", "full"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt is not None:
        return run(args)
    with tempfile.TemporaryDirectory(prefix="srds_dit_ckpt_") as d:
        args.ckpt = d
        return run(args)


def run(args):
    device = resolve_device(args.device)
    base = get_arch("srds-dit-cifar")
    if args.preset == "cpu":
        cfg = dc.replace(base, num_layers=3, d_model=96, num_heads=4,
                         num_kv_heads=4, head_dim=24, d_ff=384, patch_size=4,
                         dtype="float32")
        steps = args.steps or 300
        batch = 16
    else:
        cfg = base   # 12L/768d ~100M params, the paper-scale benchmark model
        steps = args.steps or 300
        batch = 64

    model = init_dit(cfg, torch.Generator().manual_seed(0), device=device)
    print(f"DiT {cfg.name} [{args.preset}]: {param_count(model):,} params, "
          f"{steps} steps, batch {batch}")
    opt = init_opt_state(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=1e-3, schedule=warmup_cosine(1e-3, 30, steps))
    step = make_train_step(cfg, opt_cfg, loss_kind="diffusion")
    stream = make_stream(cfg, DataConfig(global_batch=batch, seq_len=0),
                         device=device)
    ck = Checkpointer(args.ckpt)
    hist = []

    def log(s, m):
        hist.append(m["loss"])
        print(f"  step {s}: mse={m['loss']:.4f} lr={m['lr']:.2e} "
              f"({m['step_time_s']:.2f}s/step)")

    try:
        model, opt, _ = train_loop(
            step, model, opt, stream, 0, ck,
            LoopConfig(total_steps=steps, ckpt_every=100, log_every=25),
            preemption=PreemptionSignal(install_sigterm=True),
            metrics_cb=log)
    finally:
        ck.close()
    print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f}")

    # SRDS sampling from the trained model
    model_fn = make_denoiser(model)
    size = 32
    sched = make_schedule("ddpm_linear", 100)
    x0 = torch.randn((2, size, size, 3), generator=torch.Generator()
                     .manual_seed(9)).to(device)
    ref = sample_sequential(model_fn, sched, SolverConfig("ddim"), x0)
    res = srds_sample(model_fn, sched, SolverConfig("ddim"), x0,
                      SRDSConfig(tol=1e-3))
    err = float((res.sample - ref).abs().mean())
    print(f"SRDS on the trained model: {int(res.iterations)} refinements, "
          f"err vs sequential {err:.2e}")
    print("sample stats:",
          f"min={float(res.sample.min()):.2f} "
          f"max={float(res.sample.max()):.2f}")
    return dict(losses=hist, iterations=int(res.iterations), err=err,
                sample=res.sample)


if __name__ == "__main__":
    main()
