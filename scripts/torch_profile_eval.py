#!/usr/bin/env python3
"""Where one DiT eval's, or one train step's, device time goes, for the
PyTorch port on a GPU.

    python3 scripts/torch_profile_eval.py [--batch 10 2] [--reps 3]
    python3 scripts/torch_profile_eval.py --train [--batch 8] [--reps 3]

Builds ``srds-dit-sd2`` at full width and depth with random weights (as
``chip_smoke.py`` does), warms it, then runs ``--reps`` evals per batch
size under ``torch.profiler`` and prints, per eval: the wall time (host
clock around synchronized work), the device time summed over kernels, the
device's busy share of the wall time, and the device time by kernel group
(the port's flash kernels, GEMMs, the rest) and by kernel name.  Batch 10
is SRDS's fine step (B=5 blocks x K=2 samples), batch 2 its coarse step
and the sequential sampler's step.

With ``--train`` it profiles full-width train steps instead (the model
built through ``launch.train.build``, batch 8 by default, the JAX
launcher's): the loss and its gradients under one profile, the AdamW
update under a second, so the optimizer's elementwise kernels are told
apart from the model's; it also prints the step's peak device memory.
Needs one CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _profiled(fn, reps: int):
    """Run ``fn`` ``reps`` times under the profiler: (wall ms per run,
    {kernel name: device ms per run}, device-side events only, read by
    ``repro_torch.runtime.profiling``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import profiling
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return wall_ms, profiling.device_ms_by_name(prof, reps)


def _report(groups, by_name, dev_ms):
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.3f} ms ({ms / max(dev_ms, 1e-9):.3f})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:8.3f} ms  {name[:100]}")


def _by_group(by_name):
    """Device ms by kernel group: the port's kernels (flash forward, dq,
    dkv, WKV forward and backward), cuBLAS, the rest
    (``repro_torch.runtime.profiling.kernel_group``)."""
    from repro_torch.runtime import profiling
    return profiling.by_group(by_name)


def evals(args, torch, cfg, tree) -> None:
    import numpy as np
    from repro_torch.models import dit
    fn = dit.make_denoiser(dit.load_jax_params(cfg, tree, device="cuda"))
    rng = np.random.default_rng(0)
    for batch in args.batch or [10, 2]:
        x = torch.from_numpy(rng.standard_normal(
            (batch, 64, 64, 4)).astype(np.float32)).cuda()
        t = torch.full((batch,), 500.0, device="cuda")
        fn(x, t)
        torch.cuda.synchronize()
        wall_ms, by_name = _profiled(lambda: fn(x, t), args.reps)
        dev_ms = sum(by_name.values())
        print(f"batch {batch}: wall {wall_ms:.3f} ms per eval, device "
              f"{dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f}")
        _report(_by_group(by_name), by_name, dev_ms)


def train_steps(args, torch, cfg, tree) -> None:
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.launch import train as launch
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train import diffusion_loss
    batch_size = (args.batch or [8])[0]
    cfg, model, opt_state, _, _ = launch.build(cfg.name, params=tree,
                                               device="cuda")
    batch = make_stream(cfg, DataConfig(global_batch=batch_size),
                        device="cuda").batch(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dict(model.named_parameters())
    opt_cfg = AdamWConfig()
    grads = {}

    def loss_and_grads():
        loss, _ = diffusion_loss(model, batch, gen)
        grads.update(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    def update():
        adamw_update(params, grads, opt_state, opt_cfg)

    loss_and_grads()                     # warm-up, and the peak's step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_and_grads()
    update()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_g, by_g = _profiled(loss_and_grads, args.reps)
    wall_u, by_u = _profiled(update, args.reps)
    dev_g, dev_u = sum(by_g.values()), sum(by_u.values())
    wall, dev = wall_g + wall_u, dev_g + dev_u
    print(f"train step, batch {batch_size}: wall {wall:.3f} ms (loss and "
          f"gradients {wall_g:.3f}, AdamW {wall_u:.3f}), device "
          f"{dev:.3f} ms, busy share {dev / wall:.3f}, peak memory "
          f"{peak_gb:.2f} GB")
    groups = _by_group(by_g)
    groups["optimizer (AdamW, elementwise)"] = dev_u
    _report(groups, {**by_g, **{f"[AdamW] {k}": v
                                for k, v in by_u.items()}}, dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="eval batch sizes (default 10 2), or the train "
                         "batch with --train (default 8)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of evals")
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import dit

    if not torch.cuda.is_available():
        print("torch_profile_eval: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    cfg = get_arch("srds-dit-sd2")
    tree = dit.random_jax_tree(cfg, seed=0)
    (train_steps if args.train else evals)(args, torch, cfg, tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
