"""Train-step factory: loss -> gradients -> clipped AdamW (counterpart of
``repro.train.steps``).  The step updates the model and the optimizer
state in place; PyTorch runs it eagerly, so nothing is jitted or donated.
The compressed-gradient data-parallel step waits for the multi-device
port (ROADMAP A10), the language-model step for the LLM zoo (A11)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from .losses import diffusion_loss


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    loss_kind: str = "diffusion"):
    """Returns ``step(model, opt_state, batch, generator=None, *, t=None,
    eps=None) -> (model, opt_state, metrics)``; ``t``/``eps`` pin the
    diffusion loss's draws (tests and yardsticks).  Metrics stay device
    tensors."""
    if loss_kind == "lm" or cfg.family != "dit":
        raise NotImplementedError("the language-model train step waits for "
                                  "the LLM zoo (ROADMAP A11)")
    if loss_kind != "diffusion":
        raise ValueError(f"unknown loss_kind {loss_kind!r}")

    def step(model, opt_state, batch, generator=None, *, t=None, eps=None):
        params = dict(model.named_parameters())
        loss, metrics = diffusion_loss(model, batch, generator, t=t,
                                       eps=eps)
        # autograd.grad, not backward(): no .grad buffers survive a failed
        # attempt, so a retry starts clean
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state, opt_metrics = adamw_update(
            params, dict(zip(params, grads)), opt_state, opt_cfg)
        return model, opt_state, dict(metrics, loss=loss.detach(),
                                      **opt_metrics)

    return step

