"""Train-step factories: loss -> gradients -> clipped AdamW (counterpart
of ``repro.train.steps``), for the diffusion loss (the DiT) and the LM
loss (the language models).  The steps update the model and the optimizer
state in place; PyTorch runs them eagerly, so nothing is jitted or
donated.

``make_train_step``                 one device.
``make_dp_train_step_compressed``   data parallel over a mesh dim, the
                                    gradient mean sent as int8 with error
                                    feedback (``parallel.collectives``).

The GSPMD (tensor-, expert- and sequence-parallel) step of the JAX
module's launcher waits for ROADMAP A10(c)."""
from __future__ import annotations

import re
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from .losses import diffusion_loss, lm_loss


def _loss_fn(cfg: ArchConfig, loss_kind: str):
    """``loss_fn(model, batch, generator, t, eps) -> (loss, metrics)``."""
    if loss_kind not in ("diffusion", "lm"):
        raise ValueError(f"unknown loss_kind {loss_kind!r}")
    if (loss_kind == "diffusion") != (cfg.family == "dit"):
        raise ValueError(f"loss_kind {loss_kind!r} does not train a "
                         f"{cfg.family} arch")
    if loss_kind == "lm" and cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"training {cfg.family} archs (audio, "
                                  f"vision) waits for their blocks and "
                                  f"losses (ROADMAP A11)")

    def loss_fn(model, batch, generator, t, eps):
        if loss_kind == "lm":
            return lm_loss(cfg, model, batch)
        return diffusion_loss(model, batch, generator, t=t, eps=eps)

    return loss_fn


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    loss_kind: str = "diffusion"):
    """Returns ``step(model, opt_state, batch, generator=None, *, t=None,
    eps=None) -> (model, opt_state, metrics)``; ``t``/``eps`` pin the
    diffusion loss's draws (tests and yardsticks; the LM loss draws
    nothing).  Metrics stay device tensors."""
    loss_fn = _loss_fn(cfg, loss_kind)

    def step(model, opt_state, batch, generator=None, *, t=None, eps=None):
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch, generator, t, eps)
        # autograd.grad, not backward(): no .grad buffers survive a failed
        # attempt, so a retry starts clean
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state, opt_metrics = adamw_update(
            params, dict(zip(params, grads)), opt_state, opt_cfg)
        return model, opt_state, dict(metrics, loss=loss.detach(),
                                      **opt_metrics)

    return step


def init_error_feedback(model) -> Dict[str, torch.Tensor]:
    """The compressed step's carry: f32 zeros shaped like each parameter
    of ``model`` (an ``nn.Module`` or a dict of tensors)."""
    params = model if isinstance(model, dict) \
        else dict(model.named_parameters())
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def layer_scale_groups(params) -> Dict[str, str]:
    """``{name: key}`` with a layer's index dropped (``blocks.3.attn.wq``
    -> ``blocks.attn.wq``): the JAX tree's leaf of that parameter, which
    stacks it over the layers."""
    return {k: re.sub(r"^blocks\.\d+\.", "blocks.", k) for k in params}


def make_dp_train_step_compressed(cfg: ArchConfig, opt_cfg: AdamWConfig,
                                  mesh, axis: str = "data", *,
                                  loss_kind: str = "diffusion"):
    """The data-parallel step with int8 error-feedback gradient sync:
    ``step(model, opt_state, ef, batch, generator=None, *, t=None,
    eps=None) -> (model, opt_state, ef, metrics)``.

    SPMD over ``mesh``'s ``axis`` dim: every rank holds the same model and
    optimizer state and passes the same global batch (and pinned ``t``,
    ``eps``); each takes its contiguous ``1/n`` of dim 0, so the batch
    must divide.  The gradients (autograd through the port's kernels)
    meet in :func:`repro_torch.parallel.collectives.compressed_psum_mean`
    with the carry ``ef`` (:func:`init_error_feedback`), AdamW applies
    the mean, and the loss and metrics come back averaged over the dim.
    Each block parameter's layers share one scale, as JAX's leaf stacked
    over the layers does (:func:`layer_scale_groups`)."""
    from repro_torch.parallel.collectives import (check_backend,
                                                  compressed_psum_mean)
    from repro_torch.parallel.sharding import mesh_shape
    loss_fn = _loss_fn(cfg, loss_kind)
    group = mesh.get_group(axis)
    n = mesh_shape(mesh)[axis]
    me = mesh.get_local_rank(axis)

    def shard(x):
        if x is None:
            return None
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"axis {axis!r} (size {n})")
        c = x.shape[0] // n
        return x[me * c:(me + 1) * c]

    def step(model, opt_state, ef, batch, generator=None, *, t=None,
             eps=None):
        params = dict(model.named_parameters())
        check_backend(group, next(iter(params.values())))
        loss, metrics = loss_fn(model, {k: shard(v) for k, v in
                                        batch.items()},
                                generator, shard(t), shard(eps))
        grads = torch.autograd.grad(loss, list(params.values()))
        mean, ef = compressed_psum_mean(dict(zip(params, grads)), group, ef,
                                        scale_groups=layer_scale_groups(
                                            params))
        _, opt_state, opt_metrics = adamw_update(params, mean, opt_state,
                                                 opt_cfg)
        # the loss and metrics averaged over the dim, in one all_reduce
        names = sorted(metrics)
        vals = torch.stack([loss.detach().float()]
                           + [metrics[k].float() for k in names])
        dist.all_reduce(vals, group=group)
        vals = vals / float(n)
        out = dict(zip(names, vals[1:]), loss=vals[0])
        return model, opt_state, ef, dict(out, **opt_metrics)

    return step
