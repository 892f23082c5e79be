#!/usr/bin/env python3
"""How a language model's held-out loss moves over the first AdamW steps,
for the PyTorch port on a GPU: a reading that sizes ``chip_smoke.py``'s
LM training phases and their held-out gates.

    python3 scripts/torch_lm_probe_sweep.py [--arch rwkv6-1.6b] \\
        [--layers N] [--lr 5e-5 1e-4 3e-4 1e-3] [--f32] [--probes 16] \\
        [--seeds 0 1 2] [--negate] [--trained] [--plain] [--src DIR]

For each model seed and learning rate it builds the arch as
``launch.train.build`` does (``init_params`` on the card from the seed,
trainable; ``--layers`` cuts the depth, as phase 10 cuts qwen3-8b to 8),
takes ``--steps`` AdamW steps on ``LMStream`` batches 0.. (batch 2 x
2048, the launcher's warm-up schedule) and prints, before and after every
step, the mean loss over ``--probes`` held-out batches (``--steps``
onwards) and the loss on the first of them alone (phase 11's probe).
``--trained`` reads the batches the steps train on (0..) instead.
``--f32`` trains the same weights in f32.  ``--negate`` also runs every
setting with the update reversed (the lr negated): the control that a
gate on the loss must fail.  ``--plain`` (rwkv6) runs the WKV
forward and backward as their plain versions (``ref.rwkv6_wkv``,
``ref.rwkv6_wkv_bwd``) on the card instead of the kernels: the same
training through another summation order (slow: about 10 s a step at 24
layers; take ``--probes 1``).  ``--src``
imports ``repro_torch`` from another checkout's ``src`` (say a parent
commit unpacked by ``git archive``), to read its kernels the same way.
Needs one CUDA card; prints the card's name and power limit first.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[5e-5, 1e-4, 3e-4, 1e-3])
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--negate", action="store_true")
    ap.add_argument("--trained", action="store_true")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--src", default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))

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
    if args.plain:
        from repro_torch.kernels import ops, ref, rwkv6_scan

        def plain_fwd(r, k, v, w, u, s0, *, checkpoints=False, tuner=None):
            out, s_t = ref.rwkv6_wkv(r, k, v, w, u, s0)
            return out, s_t, s0[:, :, None] if checkpoints else None

        def plain_bwd(r, k, v, w, u, ckpt, dout, ds_t=None, tuner=None):
            return ref.rwkv6_wkv_bwd(r, k, v, w, u, ckpt[:, :, 0], dout,
                                     ds_t)

        rwkv6_scan.rwkv6_wkv = plain_fwd
        ops.rwkv6_wkv_bwd = plain_bwd
    cfg = get_arch(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    stream = make_stream(cfg, DataConfig(seed=0, global_batch=2,
                                         seq_len=2048), device="cuda")
    first = 0 if args.trained else args.steps
    probes = [stream.batch(first + i) for i in range(args.probes)]
    runs = [(seed, lr, sign) for seed in args.seeds for lr in args.lr
            for sign in ((1, -1) if args.negate else (1,))]
    for seed, lr, sign in runs:
        model = tf.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(seed), device="cuda",
                               trainable=True)
        if args.f32:
            model.float()
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, AdamWConfig(
            lr=sign * lr, schedule=warmup_cosine(
                sign * lr, max(10, args.steps // 10), args.steps)),
            loss_kind="lm")

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
              f"{'f32' if args.f32 else cfg.dtype}"
              f"{', plain WKV' if args.plain else ''}) seed {seed} "
              f"lr {sign * lr}{' (the update reversed)' if sign < 0 else ''}"
              f": {'trained' if args.trained else 'held-out'} mean over "
              f"{args.probes} batches / batch {first} after 0.."
              f"{args.steps} steps: " + " ".join(line),
              flush=True)
        del model, opt, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
