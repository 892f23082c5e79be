"""Train-step factories: loss -> gradients -> clipped AdamW (counterpart
of ``repro.train.steps``), for the diffusion loss (the DiT) and the LM
loss (the language models).  The steps update the model and the optimizer
state in place; PyTorch runs them eagerly, so nothing is jitted or
donated.

``make_train_step``                 one device, or with ``parallel`` (a
                                    ``ParallelCtx`` with a mesh) the
                                    language models' tensor-, sequence-
                                    and data-parallel step with ZeRO-1.
``make_dp_train_step_compressed``   data parallel over a mesh dim, the
                                    gradient mean sent as int8 with error
                                    feedback (``parallel.collectives``).

The sharded step is what GSPMD compiles for JAX's launcher, spelled out:
each rank's loss is its share of the global mean
(:func:`repro_torch.train.losses.lm_loss`), the gradients of the
parameters replicated over ``model`` whose use is per rank
(:func:`repro_torch.models.transformer.model_partial_grads`) are summed
over ``model``, every gradient is summed over each batch axis its
parameter is not split on (in f32, or in its own dtype with
``AdamWConfig.bf16_grad_sync``; the MoE experts, split over ``data``,
have their whole gradient on their owner through the all-to-all's
backward), the global norm counts each element once (the sums of squares
of leaves split over ``model`` summed over ``model``, of those split over
``data`` over ``data``, the replicated ones once), and AdamW updates each
rank's ZeRO-1 slice (:func:`zero1_slices`: ``opt_state_shardings``'s
``data`` dim, on leaves whose parameter is not already split there) and
gathers it over ``data``.  With ``fsdp`` (FSDP,
:mod:`repro_torch.models.transformer`) a leaf stored as its ``data``
shard has its gradient summed over ``data`` by the forward gather's
reduce-scatter, so the step sums it over the other batch axes only, its
norm counts each shard once (a leaf split over ``data``), and AdamW
updates the shard in place against moments of the same shape (no
ZeRO-1 slice, no gather after the update).  ``remat=True``
rematerializes each layer of the LM loss's forward in the backward under
the context's ``remat_policy`` (:mod:`repro_torch.models.transformer`;
JAX's ``jax.checkpoint`` of the layer body), in every step here; the
diffusion loss ignores it, as JAX's does.  The MoE, audio and vision families
train as the dense ones do (their losses:
:func:`repro_torch.train.losses.lm_loss`)."""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from .losses import AUX_COEF, diffusion_loss, lm_loss


def _loss_fn(cfg: ArchConfig, loss_kind: str, parallel=None,
             remat: bool = False, use_kernel: Optional[bool] = None):
    """``loss_fn(model, batch, generator, t, eps) -> (loss, metrics)``;
    the LM loss under ``parallel`` (the model's when None) and ``remat``
    (the diffusion loss ignores both); ``use_kernel=False`` the plain
    path."""
    if loss_kind not in ("diffusion", "lm"):
        raise ValueError(f"unknown loss_kind {loss_kind!r}")
    if (loss_kind == "diffusion") != (cfg.family == "dit"):
        raise ValueError(f"loss_kind {loss_kind!r} does not train a "
                         f"{cfg.family} arch")

    def loss_fn(model, batch, generator, t, eps):
        if loss_kind == "lm":
            return lm_loss(cfg, model, batch, parallel=parallel,
                           remat=remat, use_kernel=use_kernel)
        return diffusion_loss(model, batch, generator, t=t, eps=eps,
                              use_kernel=use_kernel)

    return loss_fn


class Zero1Slice:
    """A rank's ZeRO-1 slice of a parameter: ``1/n`` of ``dim`` over the
    mesh's ``axis``."""

    def __init__(self, dim: int, mesh, axis: str):
        self.dim, self.group = dim, mesh.get_group(axis)
        self.n = sharding.mesh_shape(mesh)[axis]
        self.i = mesh.get_local_rank(axis)

    def part(self, t: torch.Tensor) -> torch.Tensor:
        c = t.shape[self.dim] // self.n
        return t.narrow(self.dim, self.i * c, c)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return coll.all_gather_dim(t.contiguous(), self.dim, self.group)


def zero1_specs(model) -> Dict:
    """JAX's ``opt_state_shardings`` of ``model``'s moments."""
    ctx = model.parallel
    return sharding.opt_state_shardings(
        model.cfg, ctx.mesh, {"m": model.shapes, "v": model.shapes}, ctx)


def zero1_slices(model) -> Dict[str, Zero1Slice]:
    """``{name: Zero1Slice}`` for every parameter whose moments
    ``opt_state_shardings`` splits over ``data`` on a dim its parameter
    keeps whole."""
    ctx = model.parallel
    if ctx.mesh is None:
        return {}
    zspecs = zero1_specs(model)["m"]
    out = {}
    for name, spec in model.specs.items():
        for dim, (a, b) in enumerate(zip(zspecs[name], spec)):
            if a == ctx.data_axis and b is None:
                out[name] = Zero1Slice(dim, ctx.mesh, ctx.data_axis)
    return out


def train_state_specs(model) -> Dict[str, tuple]:
    """The checkpoint's specs of a train state ``{"params": ..., "opt":
    ...}`` (the train loop's leaf names)."""
    zs = zero1_specs(model)
    out = {f"params/{n}": s for n, s in model.specs.items()}
    for key in ("m", "v"):
        out.update({f"opt/{key}/{n}": s for n, s in zs[key].items()})
    out["opt/step"] = ()
    return out


def _sum_over(grads: Dict[str, torch.Tensor], names, group,
              keep_dtype: bool) -> None:
    """Sum ``grads[name]`` over ``group`` for each name, in place of the
    dict's entry: f32, or the gradient's dtype with ``keep_dtype``."""
    for name in names:
        g = grads[name]
        g = g.clone() if keep_dtype else g.float().clone()
        dist.all_reduce(g, group=group)
        coll.CALLS["all_reduce"] += 1
        grads[name] = g


def _split_on(spec, axis) -> bool:
    return any(a == axis or (isinstance(a, tuple) and axis in a)
               for a in spec)


def batch_summed(model, axis: str):
    """The parameters whose gradient the step sums over the batch axis
    ``axis``: every one not split over it (an expert's whole gradient is
    already on its owner)."""
    return [n for n, spec in model.specs.items()
            if not _split_on(spec, axis)]


def sharded_global_norm(model, grads: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
    """The global norm of a sharded gradient: each leaf's f32 sum of
    squares, those of leaves split over ``model`` summed over it, then
    those of leaves split over ``data`` (the experts) over it (one
    all-reduce each), added in the parameters' order as
    :func:`repro_torch.optim.global_norm` adds them."""
    ctx = model.parallel
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
    for axis in (ctx.model_axis, ctx.data_axis):
        split = [i for i, n in enumerate(grads)
                 if _split_on(model.specs[n], axis)]
        if split:
            v = torch.stack([sq[i] for i in split])
            dist.all_reduce(v, group=ctx.mesh.get_group(axis))
            coll.CALLS["all_reduce"] += 1
            for j, i in enumerate(split):
                sq[i] = v[j]
    return torch.sqrt(sum(sq))


def _sharded_lm_step(cfg: ArchConfig, opt_cfg: AdamWConfig, parallel,
                     remat: bool, use_kernel: Optional[bool]):
    from repro_torch.models.transformer import (model_partial_grads,
                                                same_layout)
    mesh = parallel.mesh

    def step(model, opt_state, batch, generator=None, *, t=None, eps=None):
        if not same_layout(model.parallel, parallel):
            raise ValueError("the model was built for another ParallelCtx")
        params = dict(model.named_parameters())
        loss, metrics = lm_loss(cfg, model, batch, parallel=parallel,
                                remat=remat, use_kernel=use_kernel)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        keep = opt_cfg.bf16_grad_sync
        _sum_over(grads, model_partial_grads(model),
                  mesh.get_group(parallel.model_axis), keep)
        for a in parallel.batch_axes:
            _sum_over(grads, batch_summed(model, a), mesh.get_group(a), keep)
        gnorm = sharded_global_norm(model, grads)
        _, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, gnorm=gnorm,
            zero1=zero1_slices(model))
        total = metrics["ce"] + AUX_COEF * metrics["aux"]
        return model, opt_state, dict(metrics, loss=total, **opt_metrics)

    return step


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    loss_kind: str = "diffusion", parallel=None,
                    remat: bool = False, use_kernel: Optional[bool] = None):
    """Returns ``step(model, opt_state, batch, generator=None, *, t=None,
    eps=None) -> (model, opt_state, metrics)``; ``t``/``eps`` pin the
    diffusion loss's draws (tests and yardsticks; the LM loss draws
    nothing).  Metrics stay device tensors.  ``parallel`` with a mesh:
    the sharded LM step (module docstring); ``batch`` is then the rank's
    part of the global batch (``data.make_stream(..., mesh=)``), the
    model and ``opt_state`` hold the rank's parts
    (``init_opt_state(params, zero1=zero1_slices(model))``), and the
    metrics are global.  ``parallel`` without a mesh: the context of the
    local LM loss (the model's when None; it may differ from the model's
    in ``remat_policy`` alone).  ``remat``: each layer of the LM loss
    rematerialized under ``parallel.remat_policy`` (the module
    docstring).  ``use_kernel=False``: the plain path (JAX's launcher
    and dry run build their steps so; a yardstick on the card)."""
    if parallel is not None and parallel.mesh is not None:
        if loss_kind != "lm":
            raise ValueError("the sharded step trains the language models; "
                             "the DiT's data-parallel step is "
                             "make_dp_train_step_compressed")
        _loss_fn(cfg, loss_kind)
        from repro_torch.models.transformer import check_ctx
        check_ctx(parallel)
        return _sharded_lm_step(cfg, opt_cfg, parallel, remat, use_kernel)
    loss_fn = _loss_fn(cfg, loss_kind, parallel, remat, use_kernel)

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
                                  loss_kind: str = "diffusion",
                                  remat: bool = False):
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
    over the layers does (:func:`layer_scale_groups`).  ``remat``: the LM
    loss's layers rematerialized under the model's ``remat_policy``, as
    JAX's step passes ``remat`` to its ``lm_loss``."""
    from repro_torch.parallel.collectives import (check_backend,
                                                  compressed_psum_mean)
    from repro_torch.parallel.sharding import mesh_shape
    loss_fn = _loss_fn(cfg, loss_kind, remat=remat)
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
