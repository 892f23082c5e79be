#!/usr/bin/env python3
"""How a language model's held-out loss moves over the first AdamW steps,
for the PyTorch port on a GPU: a reading that sizes ``chip_smoke.py``'s
LM training phases.

    python3 scripts/torch_lm_probe_sweep.py [--arch rwkv6-1.6b] \\
        [--lr 5e-5 1e-4 3e-4 1e-3] [--f32] [--probes 16]

For each learning rate it builds the arch as ``launch.train.build`` does
(seed-0 ``init_params`` on the card, trainable; ``--layers`` cuts the
depth, as phase 9 cuts qwen3-8b to 8), takes 5 AdamW steps on
``LMStream`` batches 0-4 (batch 2 x 2048, the launcher's warm-up
schedule) and prints, before and after every step, the mean loss over
``--probes`` held-out batches (5 onwards) and the loss on batch 5 alone
(the phase's probe).  ``--f32`` trains the same weights in f32.  Needs
one CUDA card; prints the card's name and power limit first.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[5e-5, 1e-4, 3e-4, 1e-3])
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, fold_in, make_stream
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.train import lm_loss, make_train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    cfg = get_arch(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    stream = make_stream(cfg, DataConfig(seed=0, global_batch=2,
                                         seq_len=2048), device="cuda")
    probes = [stream.batch(args.steps + i) for i in range(args.probes)]
    for lr in args.lr:
        model = tf.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda",
                               trainable=True)
        if args.f32:
            model.float()
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, AdamWConfig(lr=lr, schedule=warmup_cosine(
            lr, max(10, args.steps // 10), args.steps)), loss_kind="lm")

        def reading():
            with torch.no_grad():
                xs = [lm_loss(cfg, model, p)[0].item() for p in probes]
            return f"{sum(xs) / len(xs):.5f}/{xs[0]:.5f}"

        line = [reading()]
        for s in range(args.steps):
            gen = torch.Generator(device="cuda").manual_seed(fold_in(1, s))
            model, opt, _ = step(model, opt, stream.batch(s), gen)
            line.append(reading())
        print(f"{args.arch} ({cfg.num_layers} layers, "
              f"{'f32' if args.f32 else cfg.dtype}) lr {lr}: held-out mean "
              f"over {args.probes} batches / batch {args.steps} after 0.."
              f"{args.steps} steps: " + " ".join(line), flush=True)
        del model, opt, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
