"""Train-step factory: loss -> gradients -> clipped AdamW (counterpart of
``repro.train.steps``), for the diffusion loss (the DiT) and the LM loss
(the language models).  The step updates the model and the optimizer
state in place; PyTorch runs it eagerly, so nothing is jitted or donated.
The compressed-gradient data-parallel step waits for the multi-device
port (ROADMAP A10(b))."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from .losses import diffusion_loss, lm_loss


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    loss_kind: str = "diffusion"):
    """Returns ``step(model, opt_state, batch, generator=None, *, t=None,
    eps=None) -> (model, opt_state, metrics)``; ``t``/``eps`` pin the
    diffusion loss's draws (tests and yardsticks; the LM loss draws
    nothing).  Metrics stay device tensors."""
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

