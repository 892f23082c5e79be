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
prefill to the prompt plus the generation budget (with a mesh the
prefill lays it out at that length).  RWKV6 carries fixed-size
states, and Hymba its SSM states and a ring of ``window`` K/V slots
(:func:`repro_torch.models.transformer.prefill` builds it at its full size
whatever the prompt's length), so neither is padded, as in JAX.

With ``parallel`` (the model's ``ParallelCtx``, a mesh) every rank calls
``generate`` with the same requests.  The batch is split over the batch
axes where they divide it (each rank prefills and decodes its rows; the
step's tokens are gathered over them before the one fetch), and the
cache is the rank's part of the flash-decoding layout
(:func:`repro_torch.parallel.sharding.cache_shardings`): a dense cache is
built by the prefill at the prompt plus the budget, rounded up to a
multiple of the ``model`` dim.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import _host_slice
from repro_torch.models.transformer import (LOCAL, ParallelCtx,
                                            TransformerLM, decode_step,
                                            prefill)
from repro_torch.parallel import sharding


def make_prefill_fn(cfg: ArchConfig, parallel: ParallelCtx = LOCAL,
                    use_kernel: Optional[bool] = None):
    """``fn(model, batch, cache_len=None) -> (last_logits, cache)``."""
    def fn(model, batch, cache_len=None):
        return prefill(cfg, model, batch, parallel=parallel,
                       use_kernel=use_kernel, cache_len=cache_len)
    return fn


def make_decode_fn(cfg: ArchConfig, parallel: ParallelCtx = LOCAL,
                   use_kernel: Optional[bool] = None):
    """``fn(model, token_batch, cache, pos) -> (logits, cache)``."""
    def fn(model, token_batch, cache, pos):
        return decode_step(cfg, model, token_batch, cache, pos,
                           parallel=parallel, use_kernel=use_kernel)
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
                 use_kernel: Optional[bool] = None,
                 parallel: Optional[ParallelCtx] = None):
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.parallel = model.parallel if parallel is None else parallel
        self.device = model["embed"]["table"].device
        self._prefill = make_prefill_fn(cfg, self.parallel,
                                        use_kernel=use_kernel)
        self._decode = make_decode_fn(cfg, self.parallel,
                                      use_kernel=use_kernel)

    def _rows(self):
        """This rank's rows of the batch and the spec that gathers the
        step's tokens (None without a mesh, or where the batch axes do not
        divide the batch)."""
        mesh = self.parallel.mesh
        if mesh is None:
            return slice(None), None
        axes = self.parallel.batch_axes
        spec = sharding.batch_shardings(
            mesh, {"t": torch.empty((self.batch_size,))}, axes)["t"]
        if spec[0] is None:
            return slice(None), None
        start, per = _host_slice(self.batch_size, mesh, axes)
        return slice(start, start + per), spec

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
        rows, spec = self._rows()
        mesh = self.parallel.mesh

        def tokens(t):
            # the whole batch's tokens from this rank's rows
            if spec is None:
                return t
            return sharding.full_tensor("tokens", t, spec, mesh)

        batch = {"tokens": toks[rows].to(self.device)}
        if mesh is None:
            last_logits, cache = self._prefill(self.model, batch)
            if self.cfg.block == "attn_mlp":
                # the cache sized for prompt + generation budget
                pad = (0, 0, 0, 0, 0, total - plen)
                cache = tuple(F.pad(c, pad) for c in cache)
        else:
            # the prefill lays the dense cache out at the budget, split
            last_logits, cache = self._prefill(self.model, batch, total)
        vocab = self.cfg.vocab_size
        tok = last_logits[:, :vocab].argmax(dim=-1)
        outs = [[t] for t in tokens(tok).tolist()[:len(requests)]]
        for step in range(1, max_new):
            logits, cache = self._decode(self.model, {"tokens": tok[:, None]},
                                         cache, plen + step - 1)
            tok = logits[:, :vocab].argmax(dim=-1)
            host = tokens(tok).tolist()          # the step's one fetch
            for i, r in enumerate(requests):
                if len(outs[i]) < r.max_new_tokens:
                    outs[i].append(host[i])
        return outs
