"""Training launcher: config -> mesh -> sharded model and optimizer state
-> fault-tolerant loop (counterpart of ``repro.launch.train``), for the
DiT and every language model of the zoo (dense, MoE, RWKV6, hybrid, and
the audio and vision stubs): on one device (``--mesh local``), or, for
the language models, on JAX's production meshes (``--mesh pod1``: ``(data 16, model
16)``, 256 ranks; ``pod2``: ``(pod 2, data 16, model 16)``, 512) under
``torchrun``, one process a card:

    torchrun --nnodes 32 --nproc-per-node 8 --rdzv-backend c10d \
        --rdzv-endpoint HOST:PORT -m repro_torch.launch.train \
        --arch qwen3-8b --mesh pod1 --steps 100 --batch 256 --seq 2048

Every rank draws the whole model from seed 0 and keeps its parts
(``ParallelCtx(sp=True, model_parallel=16)``, ``use_ep`` for the MoE
archs, ZeRO-1 moments), takes its
rows of each batch, and checkpoints JAX's multi-process layout.  The
step is :func:`repro_torch.train.make_train_step`'s sharded one.
:func:`build_on_mesh` is the part after the mesh (the tests call it on
``make_test_mesh((2, 2))``).

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
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_stream
from repro_torch.models import dit, transformer
from repro_torch.models.dit import resolve_device
from repro_torch.models.transformer import ParallelCtx
from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
from repro_torch.parallel.sharding import mesh_shape
from repro_torch.runtime import LoopConfig, PreemptionSignal, train_loop
from repro_torch.train import make_train_step
from repro_torch.train.steps import train_state_specs, zero1_slices

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
    if mesh_kind not in ("local", "pod1", "pod2"):
        raise ValueError(f"unknown mesh {mesh_kind!r}")
    if mesh_kind != "local":
        from repro_torch.launch.mesh import make_production_mesh
        device = resolve_device(device)
        mesh = make_production_mesh(multi_pod=mesh_kind == "pod2",
                                    device_type=device.type)
        return build_on_mesh(arch, mesh, reduced=reduced, lr=lr,
                             total_steps=total_steps, device=device,
                             params=params)
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


def mesh_ctx(mesh, cfg=None) -> ParallelCtx:
    """JAX's launcher context on ``mesh``: batch over ``("pod", "data")``
    or ``("data",)``, ``sp=True``, the model-parallel degree the mesh's
    ``model`` dim (16 on the production meshes, as JAX's), and expert
    parallelism (``use_ep``) for an MoE ``cfg``."""
    names = tuple(mesh.mesh_dim_names)
    multi = "pod" in names
    return ParallelCtx(mesh=mesh,
                       batch_axes=("pod", "data") if multi else ("data",),
                       use_ep=cfg is not None and cfg.moe_experts > 0,
                       sp=True, model_parallel=mesh_shape(mesh)["model"])


def build_on_mesh(arch: str, mesh, *, reduced: bool = False,
                  lr: float = 3e-4, total_steps: int = 100, device="cuda",
                  params=None, layers: Optional[int] = None,
                  experts: Optional[int] = None):
    """:func:`build`'s part after the mesh, for a language model:
    ``(cfg, model, opt_state, step, "lm")`` with the model's and the
    moments' parts of this rank (:func:`mesh_ctx`'s context; every rank
    draws the whole model from seed 0, or takes ``params``, a JAX tree at
    that context's padding, and keeps its part).  ``layers`` cuts the
    depth and ``experts`` an MoE arch's expert count (a smoke test's)."""
    import dataclasses
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe_experts=experts)
    if cfg.family == "dit":
        raise ValueError("the mesh launcher trains the language models; "
                         "the DiT's data-parallel step is "
                         "make_dp_train_step_compressed")
    device = resolve_device(device)
    ctx = mesh_ctx(mesh, cfg)
    if params is not None:
        model = transformer.load_jax_params(cfg, params, device=device,
                                            trainable=True, parallel=ctx)
    else:
        model = transformer.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device, trainable=True, parallel=ctx)
    opt_state = init_opt_state(dict(model.named_parameters()),
                               zero1=zero1_slices(model))
    opt_cfg = AdamWConfig(lr=lr, schedule=warmup_cosine(
        lr, max(10, total_steps // 10), total_steps))
    step = make_train_step(cfg, opt_cfg, loss_kind="lm", parallel=ctx)
    return cfg, model, opt_state, step, "lm"


def run(args, ckpt_dir: str):
    if args.mesh != "local":
        from repro_torch.launch.mesh import init_process_group
        if not dist.is_initialized():
            init_process_group(device_type=resolve_device(args.device).type)
    cfg, model, opt_state, step, _ = build(
        args.arch, mesh_kind=args.mesh, reduced=args.reduced, lr=args.lr,
        total_steps=args.steps, device=args.device)
    ctx = getattr(model, "parallel", None)
    mesh = None if ctx is None else ctx.mesh
    stream = make_stream(cfg, DataConfig(global_batch=args.batch,
                                         seq_len=args.seq),
                         device=args.device, mesh=mesh,
                         batch_axes=ctx.batch_axes if mesh else ("data",))
    ckpt = Checkpointer(ckpt_dir, mesh=mesh,
                        shardings=train_state_specs(model) if mesh else None)
    losses = []
    first = mesh is None or dist.get_rank() == 0

    def log(step_i, m):
        losses.append(m["loss"])
        if first:
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
    if losses and first:
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
    if args.mesh != "local" and args.ckpt is None:
        ap.error("--mesh pod1/pod2 needs --ckpt, a directory every rank "
                 "sees")
    if args.ckpt is not None:
        return run(args, args.ckpt)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
        return run(args, d)


if __name__ == "__main__":
    main()
