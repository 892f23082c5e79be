"""AdamW with f32 moments, global-norm clipping, decoupled weight decay.

Counterpart of ``repro.optim.adamw``, as plain functions over a dict of
parameters keyed by the model's own names (``dict(model.named_parameters())``).
The state is ``{"m": {name: f32}, "v": {name: f32}, "step": int32 ()}`` on
the parameters' device, so the checkpointer treats it like the parameters.
bf16 parameters are updated in f32 and cast back once; the moments stay
f32 (``torch.optim.AdamW`` would keep bf16 moments for bf16 parameters).

Unlike the JAX version, :func:`adamw_update` works in place: it
overwrites the parameters, ``m`` and ``v`` and returns the same objects,
which saves a second copy of the state (6.8 GB for the full-width
``srds-dit-sd2``).  Metrics are device tensors: nothing here waits for
the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import torch

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def init_opt_state(params: Params) -> Dict:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float):
    """``(grads * min(1, max_norm / norm) in f32, norm)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict,
                 cfg: AdamWConfig):
    """One clipped AdamW step, in place.  Returns ``(params, state,
    metrics)`` with ``metrics = {"grad_norm", "lr"}`` as device tensors.
    The clipped f32 gradient is formed one leaf at a time, as
    :func:`clip_by_global_norm` forms it."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    lr = (cfg.schedule(step) if cfg.schedule is not None
          else torch.tensor(cfg.lr, dtype=torch.float32, device=step.device))
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        pf = p.float()
        pf = pf - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(pf)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac=0.1):
    """Linear warm-up to ``base_lr``, then cosine decay to
    ``min_frac * base_lr`` at ``total``; a function of the step tensor."""
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return sched
