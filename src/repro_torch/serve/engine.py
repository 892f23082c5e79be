"""Greedy LM serving: prefill/decode step factories and a batched engine
(counterpart of ``repro.serve.engine``).

:class:`ServingEngine` pads a batch of requests on the left with token 0
(with no attention mask over the pads, as in the JAX engine), prefills
once through :func:`repro_torch.models.transformer.prefill` and then
decodes in lockstep, one batched :func:`decode_step` per token.  The step
functions are plain callables: PyTorch runs eagerly, so there is nothing
to compile and no cache donation (the port's decode updates the cache in
place).  One device-to-host fetch per step brings the batch's tokens to
the host.

Only a dense model's cache grows with the sequence and is padded after
prefill to the prompt plus the generation budget.  RWKV6 carries fixed-size
states, and Hymba its SSM states and a ring of ``window`` K/V slots
(:func:`repro_torch.models.transformer.prefill` builds it at its full size
whatever the prompt's length), so neither is padded, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (TransformerLM, decode_step,
                                            prefill)


def make_prefill_fn(cfg: ArchConfig, use_kernel: Optional[bool] = None):
    """``fn(model, batch) -> (last_logits, cache)``."""
    def fn(model, batch):
        return prefill(cfg, model, batch, use_kernel=use_kernel)
    return fn


def make_decode_fn(cfg: ArchConfig, use_kernel: Optional[bool] = None):
    """``fn(model, token_batch, cache, pos) -> (logits, cache)``."""
    def fn(model, token_batch, cache, pos):
        return decode_step(cfg, model, token_batch, cache, pos,
                           use_kernel=use_kernel)
    return fn


@dataclasses.dataclass
class Request:
    prompt: object               # (S,) token ids: a tensor, array or list
    max_new_tokens: int = 16
    out: Optional[List[int]] = None


class ServingEngine:
    """Minimal batched greedy-decoding engine.

    Requests are padded into a fixed batch; prefill builds the cache,
    sized for the longest prompt plus the largest generation budget
    (at most ``max_seq``); decode proceeds in lockstep and each request
    keeps its first ``max_new_tokens`` tokens.
    """

    def __init__(self, cfg: ArchConfig, model: TransformerLM,
                 batch_size: int, max_seq: int,
                 use_kernel: Optional[bool] = None):
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.device = model["embed"]["table"].device
        self._prefill = make_prefill_fn(cfg, use_kernel=use_kernel)
        self._decode = make_decode_fn(cfg, use_kernel=use_kernel)

    def generate(self, requests: List[Request]) -> List[List[int]]:
        if not 0 < len(requests) <= self.batch_size:
            raise ValueError(f"{len(requests)} requests for a batch of "
                             f"{self.batch_size}")
        prompts = [torch.as_tensor(r.prompt, dtype=torch.long).reshape(-1)
                   for r in requests]
        plen = max(p.shape[0] for p in prompts)
        max_new = max(r.max_new_tokens for r in requests)
        total = plen + max_new
        if total > self.max_seq:
            raise ValueError(f"prompt {plen} + {max_new} new tokens exceeds "
                             f"max_seq {self.max_seq}")
        toks = torch.zeros((self.batch_size, plen), dtype=torch.long)
        for i, p in enumerate(prompts):
            toks[i, plen - p.shape[0]:] = p
        last_logits, cache = self._prefill(
            self.model, {"tokens": toks.to(self.device)})
        if self.cfg.block == "attn_mlp":
            # the cache sized for prompt + generation budget
            pad = (0, 0, 0, 0, 0, total - plen)
            cache = tuple(F.pad(c, pad) for c in cache)
        vocab = self.cfg.vocab_size
        tok = last_logits[:, :vocab].argmax(dim=-1)
        outs = [[t] for t in tok.tolist()[:len(requests)]]
        for step in range(1, max_new):
            logits, cache = self._decode(self.model, {"tokens": tok[:, None]},
                                         cache, plen + step - 1)
            tok = logits[:, :vocab].argmax(dim=-1)
            host = tok.tolist()                  # the step's one fetch
            for i, r in enumerate(requests):
                if len(outs[i]) < r.max_new_tokens:
                    outs[i].append(host[i])
        return outs
