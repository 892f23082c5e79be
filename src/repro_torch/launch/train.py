"""Training launcher: config -> model and optimizer state -> fault-tolerant
loop (counterpart of ``repro.launch.train``), for the DiT and the language
models the port has (``qwen3-8b``, ``rwkv6-1.6b``, ``hymba-1.5b``) on one
device (``--mesh local``).  The pod meshes wait for the multi-device port
(ROADMAP A10(c)).

    PYTHONPATH=src python -m repro_torch.launch.train --arch srds-dit-sd2 \\
        --steps 5 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --steps 5 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --steps 5 --batch 2 --seq 2048

run on the CUDA card; ``--device cpu`` (with ``--reduced``) runs on the
CPU.  The language models train through the kernels in both directions
(the JAX launcher builds its step with ``use_kernel=False``).  Without
``--ckpt`` the checkpoints go to a temporary directory that is deleted at
exit; at full width one checkpoint is about 7 GB for the DiT, 16 GB for
``rwkv6-1.6b`` and 14 GB for ``hymba-1.5b``.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_stream
from repro_torch.models import dit, transformer
from repro_torch.models.dit import resolve_device
from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
from repro_torch.runtime import LoopConfig, PreemptionSignal, train_loop
from repro_torch.train import make_train_step

# the JAX launcher's: a logged step turns every metric into a host float,
# which waits for the card, so the loop logs every 10th step (and the last)
LOG_EVERY = 10


def build(arch: str, *, mesh_kind: str = "local", reduced: bool = False,
          lr: float = 3e-4, total_steps: int = 100, device="cuda",
          params=None):
    """``(cfg, model, opt_state, step, loss_kind)`` for ``arch``.

    ``params``: a JAX-layout parameter tree (numpy leaves) to start from,
    loaded through the family's ``load_jax_params``; by default a fresh
    model from seed 0 (as the JAX launcher's ``PRNGKey(0)``): the DiT's
    ``init_dit`` draws on the CPU, the LM's ``init_params`` on ``device``
    with trainable parameters; ``loss_kind`` is ``"diffusion"`` or
    ``"lm"``."""
    if mesh_kind != "local":
        raise NotImplementedError(f"mesh {mesh_kind!r} waits for the "
                                  f"multi-device port (ROADMAP A10(c))")
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    device = resolve_device(device)
    if cfg.family == "dit":
        loss_kind = "diffusion"
        if params is not None:
            model = dit.load_jax_params(cfg, params, device=device)
        else:
            model = dit.init_dit(cfg, torch.Generator().manual_seed(0),
                                 device=device)
    else:
        loss_kind = "lm"
        if params is not None:
            model = transformer.load_jax_params(cfg, params, device=device,
                                                trainable=True)
        else:
            model = transformer.init_params(
                cfg, torch.Generator(device=device).manual_seed(0),
                device=device, trainable=True)
    opt_state = init_opt_state(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=lr, schedule=warmup_cosine(
        lr, max(10, total_steps // 10), total_steps))
    step = make_train_step(cfg, opt_cfg, loss_kind=loss_kind)
    return cfg, model, opt_state, step, loss_kind


def run(args, ckpt_dir: str):
    cfg, model, opt_state, step, _ = build(
        args.arch, mesh_kind=args.mesh, reduced=args.reduced, lr=args.lr,
        total_steps=args.steps, device=args.device)
    stream = make_stream(cfg, DataConfig(global_batch=args.batch,
                                         seq_len=args.seq),
                         device=args.device)
    ckpt = Checkpointer(ckpt_dir)
    losses = []

    def log(step_i, m):
        losses.append(m["loss"])
        print(f"step {step_i}: " + " ".join(f"{k}={v:.4g}"
                                            for k, v in m.items()),
              flush=True)

    try:
        train_loop(step, model, opt_state, stream, 1, ckpt,
                   LoopConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              log_every=LOG_EVERY),
                   preemption=PreemptionSignal(install_sigterm=True),
                   metrics_cb=log)
    finally:
        ckpt.close()
    if losses:
        print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
    return losses


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length of the LM data (the DiT's "
                         "images have their own size)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="local", choices=["local", "pod1", "pod2"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (resumes from it); default: "
                         "a temporary one, deleted at exit")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    if args.ckpt is not None:
        return run(args, args.ckpt)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
        return run(args, d)


if __name__ == "__main__":
    main()
