"""Loss functions (counterpart of ``repro.train.losses``): the diffusion
epsilon-prediction objective.  The language-model loss waits for the LLM
zoo (ROADMAP A11)."""
from __future__ import annotations

from typing import Optional

import torch

TRAIN_STEPS = 1000          # the training grid of t


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


def lm_loss(*args, **kwargs):
    raise NotImplementedError("the language-model loss (chunked CE) waits "
                              "for the LLM zoo (ROADMAP A11)")
