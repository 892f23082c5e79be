"""Loss functions (counterpart of ``repro.train.losses``): the language
models' cross-entropy, chunked as JAX chunks it (next-token for the
causal models, the vision stub's prefix positions left out; masked-unit
for the encoder-only audio model), plus ``AUX_COEF`` times the MoE
auxiliary loss, and the diffusion epsilon-prediction objective.

On a mesh (the model's ``ParallelCtx``) the cross-entropy runs on the
rank's vocabulary columns: the columns past the real vocabulary are
masked by their global index, the logsumexp is combined over ``model``
(``max + log(sum(exp(lse_r - max)))``, which at one rank is ``lse + 0``),
the gold logit comes from the column's owner (or by mask-sum with
``ce_masksum``) and is summed over ``model``, and the loss is ``sum nll /
sum valid`` over the batch axes: each rank's loss is its sum over the
global count, so the ranks' gradients add up to JAX's."""
from __future__ import annotations

from typing import Optional

import torch

import torch.distributed as dist

from repro_torch.models.transformer import forward_hidden, fsdp_view
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.tensor_parallel import TensorParallel

TRAIN_STEPS = 1000          # the training grid of t
AUX_COEF = 0.01             # the MoE auxiliary loss's weight
CE_CHUNK = 512
NEG_INF = -1e30             # a padded vocab column's logit


def linear_alpha_bar(device) -> torch.Tensor:
    """The linear-beta alpha-bar curve over the 1,000-step training grid."""
    betas = torch.linspace(1e-4, 0.02, TRAIN_STEPS, dtype=torch.float32,
                           device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def diffusion_loss(model, batch, generator: Optional[torch.Generator] = None,
                   *, t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None):
    """Epsilon-prediction MSE on the DiT: ``(loss, {"mse": loss})``.

    ``batch["images"]``: (B, H, W, C) in [-1, 1].  ``t`` is uniform over
    [0, 999) and ``eps`` standard normal, both drawn from ``generator``
    (on the images' device) unless given: the tests pass the JAX
    version's draws.  ``ab(t)`` is the linear-beta curve at ``int(t)``.
    ``use_kernel=False`` takes the plain attention (a yardstick).
    """
    imgs = batch["images"]
    if (t is None or eps is None) and generator is None:
        raise ValueError("diffusion_loss draws t and eps from a "
                         "torch.Generator: pass generator=, or t= and eps=")
    if t is None:
        t = 999.0 * torch.rand((imgs.shape[0],), generator=generator,
                               device=imgs.device, dtype=torch.float32)
    if eps is None:
        eps = torch.randn(imgs.shape, generator=generator,
                          device=imgs.device, dtype=imgs.dtype)
    ab = linear_alpha_bar(imgs.device)[t.long()][:, None, None, None]
    x_t = torch.sqrt(ab) * imgs + torch.sqrt(1 - ab) * eps
    pred = model(x_t, t, use_kernel=use_kernel)
    loss = torch.mean(torch.square(pred.float() - eps))
    return loss, {"mse": loss.detach()}


def _vocab_lse(lse: torch.Tensor, group) -> torch.Tensor:
    """The logsumexp over every rank's columns from each rank's own."""
    m = lse.detach().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    coll.CALLS["all_reduce"] += 1
    return m + torch.log(coll.reduce_from(torch.exp(lse - m), group))


def _chunked_ce(x: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                unembed_w: torch.Tensor, vocab_real: int,
                chunk: int = CE_CHUNK, *, tp=None, masksum: bool = False):
    """Cross-entropy summed over sequence chunks, the counterpart of
    ``repro.train.losses._chunked_ce``: ``(sum of the valid positions'
    NLL, number of valid positions)``, both f32 scalars.

    x: (B, S, d); labels: (B, S) int; valid: (B, S) bool.  The chunk count
    is JAX's (``S // chunk``, lowered until it divides S), and the chunks'
    sums are added in order, so the sums agree; each chunk's logits are
    computed in the model's dtype, then cast to f32, and the padded vocab
    columns are masked out of the logsumexp.  ``tp`` (a
    :class:`TensorParallel` with a group): ``unembed_w`` is the rank's
    columns (module docstring).  ``masksum``: the gold logit by JAX's
    mask-sum (``ce_masksum``).
    """
    b, s, _ = x.shape
    n_chunks = max(1, s // chunk)
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    group = None if tp is None else tp.group
    v_l = unembed_w.shape[1]
    lo = 0 if group is None else tp.r * v_l
    cols = lo + torch.arange(v_l, device=x.device)
    col_ok = cols < vocab_real
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        part = slice(c * cs, (c + 1) * cs)
        logits = (x[:, part] @ unembed_w).float()
        logits = torch.where(col_ok, logits, NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        lab = labels[:, part].long()
        if masksum:
            gold = torch.where(lab[..., None] == cols, logits, 0.0).sum(-1)
        elif group is None:
            gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        else:
            local = lab - lo
            ok = (local >= 0) & (local < v_l)
            gold = torch.where(ok, torch.gather(
                logits, -1, local.clamp(0, v_l - 1)[..., None])[..., 0], 0.0)
        if group is not None:
            lse = _vocab_lse(lse, group)
            gold = coll.reduce_from(gold, group)
        nll = torch.where(valid[:, part], lse - gold, 0.0)
        loss_sum = loss_sum + nll.sum()
        n_sum = n_sum + valid[:, part].sum(dtype=torch.float32)
    return loss_sum, n_sum


def _batch_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over the mesh's batch axes (no gradient)."""
    t = t.detach().clone()
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
        coll.CALLS["all_reduce"] += 1
    return t


def lm_loss(cfg, model, batch, *, parallel=None, remat: bool = False,
            use_kernel: Optional[bool] = None):
    """The LM loss (``repro.train.losses.lm_loss``): ``(loss, {"ce",
    "aux", "tokens"})``, ``loss = ce + AUX_COEF * aux``.

    Causal models: ``batch["tokens"]`` and ``batch["labels"]`` (B, S)
    ints; position i predicts ``labels[i + 1]``, every position valid but,
    for the vision stub, those below ``num_prefix_embeds`` (its
    ``image_embeds`` sit there), the mean over the valid ones.  The
    encoder-only audio model: ``batch["features"]`` (B, S, d), the CE of
    ``labels`` at the same positions where ``batch["mask"]`` (default
    every position).  ``aux``: the MoE auxiliary loss summed over the
    layers (0 without MoE).  ``use_kernel=False`` takes the plain
    attention, WKV and selective scan (a yardstick).

    On a mesh ``batch`` is this rank's part of the global batch, ``loss``
    is this rank's sum of NLL over the global count of valid positions
    plus ``AUX_COEF`` times the aux (JAX's ``pmean`` over the batch axes,
    whose gradient is the rank's share), so the ranks' gradients add up
    to JAX's; the metrics are global: ``ce`` the mean, ``aux`` JAX's,
    ``tokens`` the count."""
    ctx = model.parallel if parallel is None else parallel
    x, aux, _ = forward_hidden(cfg, model, batch, parallel=parallel,
                               remat=remat, use_kernel=use_kernel)
    tp = TensorParallel(cfg, ctx)
    x = tp.enter(x)
    labels = batch["labels"]
    b, s = labels.shape
    if cfg.causal:
        x_in, tgt = x[:, :-1], labels[:, 1:]
        pos = torch.arange(s - 1, device=x.device)
        valid = (pos >= (cfg.num_prefix_embeds if cfg.frontend == "vision"
                         else 0)).expand(b, s - 1)
    else:
        x_in, tgt = x, labels
        valid = batch["mask"] if "mask" in batch else torch.ones(
            (b, s), dtype=torch.bool, device=x.device)
    loss_sum, n = _chunked_ce(x_in, tgt, valid,
                              fsdp_view(model)["unembed"]["w"],
                              cfg.vocab_size, tp=tp, masksum=ctx.ce_masksum)
    if ctx.mesh is None:
        ce = loss_sum / torch.clamp(n, min=1.0)
        return ce + AUX_COEF * aux, {"ce": ce.detach(), "aux": aux.detach(),
                                     "tokens": n}
    n = _batch_sum(n, ctx.mesh, ctx.batch_axes)
    ce = loss_sum / torch.clamp(n, min=1.0)
    ce_all = _batch_sum(loss_sum, ctx.mesh, ctx.batch_axes) / torch.clamp(
        n, min=1.0)
    return ce + AUX_COEF * aux, {"ce": ce_all, "aux": aux.detach(),
                                 "tokens": n}
