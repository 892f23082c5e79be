"""Loss functions (counterpart of ``repro.train.losses``): next-token
cross-entropy for the causal language models, chunked as JAX chunks it,
and the diffusion epsilon-prediction objective.  The masked-unit (audio)
and prefix (VLM) forms of the LM loss wait for those archs (ROADMAP
A11)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import forward_hidden

TRAIN_STEPS = 1000          # the training grid of t
AUX_COEF = 0.01             # the MoE auxiliary loss's weight (no MoE yet)
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


def _chunked_ce(x: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                unembed_w: torch.Tensor, vocab_real: int,
                chunk: int = CE_CHUNK):
    """Cross-entropy summed over sequence chunks, the counterpart of
    ``repro.train.losses._chunked_ce``: ``(sum of the valid positions'
    NLL, number of valid positions)``, both f32 scalars.

    x: (B, S, d); labels: (B, S) int; valid: (B, S) bool.  The chunk count
    is JAX's (``S // chunk``, lowered until it divides S), and the chunks'
    sums are added in order, so the sums agree; each chunk's logits are
    computed in the model's dtype, then cast to f32, and the padded vocab
    columns are masked out of the logsumexp.
    """
    b, s, _ = x.shape
    n_chunks = max(1, s // chunk)
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    col_ok = torch.arange(unembed_w.shape[1], device=x.device) < vocab_real
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        part = slice(c * cs, (c + 1) * cs)
        logits = (x[:, part] @ unembed_w).float()
        logits = torch.where(col_ok, logits, NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, part, None].long())[..., 0]
        nll = torch.where(valid[:, part], lse - gold, 0.0)
        loss_sum = loss_sum + nll.sum()
        n_sum = n_sum + valid[:, part].sum(dtype=torch.float32)
    return loss_sum, n_sum


def lm_loss(cfg, model, batch, *, use_kernel: Optional[bool] = None):
    """Next-token cross-entropy of a causal LM (``repro.train.losses.
    lm_loss`` for causal archs): ``(loss, {"ce", "aux", "tokens"})``.

    ``batch["tokens"]`` and ``batch["labels"]``: (B, S) ints; position i
    predicts ``labels[i + 1]``, every position valid, the mean over them.
    ``aux`` is 0 (no MoE).  ``use_kernel=False`` takes the plain attention,
    WKV and selective scan (a yardstick)."""
    if not cfg.causal or cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"the masked-unit (audio) and prefix "
                                  f"(VLM) LM losses wait for those archs "
                                  f"(ROADMAP A11); {cfg.name} is "
                                  f"{cfg.family}")
    x, _ = forward_hidden(cfg, model, batch, use_kernel=use_kernel)
    labels = batch["labels"]
    b, s = labels.shape
    valid = torch.ones((b, s - 1), dtype=torch.bool, device=x.device)
    loss_sum, n = _chunked_ce(x[:, :-1], labels[:, 1:], valid,
                              model["unembed"]["w"], cfg.vocab_size)
    ce = loss_sum / torch.clamp(n, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ce + AUX_COEF * aux, {"ce": ce.detach(), "aux": aux,
                                 "tokens": n}
