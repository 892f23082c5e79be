"""The language-model backbone (counterpart of
``repro.models.transformer``) for dense attention+MLP blocks
(``block="attn_mlp"``, no MoE) and RWKV6 blocks (``block="rwkv6"``).
Hymba and MoE blocks wait for ROADMAP A11.

:class:`TransformerLM` holds the parameters: one :class:`ParamTree` per
layer (JAX stacks them on a leading layer axis for ``jax.lax.scan``; the
port loops over layers), with the JAX tree's leaf names, shapes and
dtypes (norm scales, RWKV's ``w_base``/``u``/``gn_scale`` in f32, the rest
in the config's dtype).  The parameters are frozen unless the caller asks
for ``trainable=True`` (``repro_torch.launch.train`` does); the serving
functions run without autograd either way.

Modes, with the JAX semantics:
  * :func:`forward_hidden` / :func:`forward_train`: the full sequence,
    hidden states / f32 logits (there is no MoE, so no auxiliary loss);
  * :func:`prefill`: the full sequence, returns ``(last_logits, cache)``.
    It unembeds the last position only (JAX unembeds every position and
    keeps the last: the same per-position numbers, without a
    (B, S, vocab) f32 tensor that is 5 GB for qwen3-8b at batch 4 x 2048);
  * :func:`decode_step`: one token against the cache at ``pos``.  The port
    updates the cache in place (JAX returns an updated copy).

Caches: dense, ``(k, v)`` each ``(L, B, S, Hkv, D)`` with K after qk-norm
and rope; RWKV6, an :class:`RWKVState` of per-layer stacks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from .dit import resolve_device
from .layers import (apply_mlp, apply_norm, attention_decode, attention_full,
                     embed, unembed)
from .rwkv6 import LORA_R, RWKVState, init_rwkv_state, rwkv_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# a leaf: (path, shape, dtype, init); init is ("normal", std) or
# ("fill", value), the JAX init's distribution for that leaf
Leaf = Tuple[str, tuple, torch.dtype, tuple]


class ParamTree(nn.Module):
    """Parameters nested as in the JAX tree and read the same way,
    ``tree["attn"]["wq"]``; ``spec`` maps a name to ``(shape, dtype)`` or
    to a nested spec.  ``trainable`` sets every parameter's
    ``requires_grad``."""

    def __init__(self, spec: dict, device, trainable: bool = False):
        super().__init__()
        for name, leaf in spec.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf, device, trainable))
            else:
                shape, dtype = leaf
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(shape, dtype=dtype, device=device),
                    requires_grad=trainable))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _norm_leaves(name: str, d: int, kind: str) -> List[Leaf]:
    out = [(f"{name}/scale", (d,), torch.float32, ("fill", 1.0))]
    if kind == "layernorm":
        out.append((f"{name}/bias", (d,), torch.float32, ("fill", 0.0)))
    return out


def _leaves(cfg: ArchConfig) -> Tuple[List[Leaf], List[Leaf]]:
    """(top-level leaves, per-layer block leaves) of the JAX init
    (``repro.models.transformer.init_params`` at one model-parallel way):
    paths, shapes without the layer axis, dtypes and init rules."""
    if cfg.block not in ("attn_mlp", "rwkv6"):
        raise NotImplementedError(f"{cfg.block!r} blocks are not ported yet "
                                  f"(ROADMAP A11)")
    dt = _DTYPES[cfg.dtype]
    d, ff = cfg.d_model, cfg.d_ff
    vocab = cfg.padded_vocab(1)
    s_d, s_ff = d ** -0.5, ff ** -0.5
    top = [("embed/table", (vocab, d), dt, ("normal", 0.02)),
           ("unembed/w", (d, vocab), dt, ("normal", s_d))]
    top += _norm_leaves("ln_f", d, cfg.norm)
    blk = _norm_leaves("ln1", d, cfg.norm) + _norm_leaves("ln2", d, cfg.norm)
    if cfg.block == "rwkv6":
        hd = cfg.rwkv_head_dim
        zero, s_r = ("fill", 0.0), ("normal", LORA_R ** -0.5)
        blk += [("tmix/mu_base", (d,), dt, zero),
                ("tmix/mu_rkvwg", (5, d), dt, zero),
                ("tmix/A_mix", (d, 5 * LORA_R), dt, ("normal", s_d)),
                ("tmix/B_mix", (5, LORA_R, d), dt, s_r)]
        blk += [(f"tmix/{w}", (d, d), dt, ("normal", s_d))
                for w in ("wr", "wk", "wv", "wg", "wo")]
        blk += [("tmix/w_base", (d,), torch.float32, ("fill", -0.5)),
                ("tmix/A_w", (d, LORA_R), dt, ("normal", s_d)),
                ("tmix/B_w", (LORA_R, d), dt, s_r),
                ("tmix/u", (d // hd, hd), torch.float32, ("normal", 0.3)),
                ("tmix/gn_scale", (d,), torch.float32, ("fill", 1.0)),
                ("cmix/mu_ck", (d,), dt, zero),
                ("cmix/mu_cr", (d,), dt, zero),
                ("cmix/wk_c", (d, ff), dt, ("normal", s_d)),
                ("cmix/wv_c", (ff, d), dt, ("normal", s_ff)),
                ("cmix/wr_c", (d, d), dt, ("normal", s_d))]
        return top, blk
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.padded_heads(1)
    blk += [("attn/wq", (d, hq * hd), dt, ("normal", s_d)),
            ("attn/wk", (d, hkv * hd), dt, ("normal", s_d)),
            ("attn/wv", (d, hkv * hd), dt, ("normal", s_d)),
            ("attn/wo", (hq * hd, d), dt, ("normal", s_d))]
    if cfg.qkv_bias:
        blk += [(f"attn/b{x}", (n * hd,), dt, ("fill", 0.0))
                for x, n in (("q", hq), ("k", hkv), ("v", hkv))]
    if cfg.qk_norm:
        blk += _norm_leaves("attn/q_norm", hd, "rmsnorm")
        blk += _norm_leaves("attn/k_norm", hd, "rmsnorm")
    blk += [("mlp/w_up", (d, ff), dt, ("normal", s_d)),
            ("mlp/w_down", (ff, d), dt, ("normal", s_ff))]
    if cfg.act == "swiglu":
        blk.append(("mlp/w_gate", (d, ff), dt, ("normal", s_d)))
    return top, blk


def _nest(leaves: List[Leaf]) -> dict:
    spec: dict = {}
    for path, shape, dtype, _ in leaves:
        *parents, name = path.split("/")
        node = spec
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = (shape, dtype)
    return spec


class TransformerLM(ParamTree):
    """The LM's parameters: ``embed``, ``ln_f``, ``unembed`` and
    ``blocks`` (one :class:`ParamTree` per layer), frozen unless
    ``trainable``."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 trainable: bool = False):
        device = resolve_device(device)
        top, blk = _leaves(cfg)
        super().__init__(_nest(top), device, trainable)
        self.cfg = cfg
        self.blocks = nn.ModuleList(ParamTree(_nest(blk), device, trainable)
                                    for _ in range(cfg.num_layers))


def _param(model: TransformerLM, path: str, layer: Optional[int]):
    node = model if layer is None else model.blocks[layer]
    for part in path.split("/"):
        node = node[part]
    return node


def _targets(model: TransformerLM):
    """``(param, jax_path, layer, init)`` for every leaf of ``model``."""
    top, blk = _leaves(model.cfg)
    out = [(_param(model, p, None), p, None, init) for p, _, _, init in top]
    out += [(_param(model, p, i), f"blocks/{p}", i, init)
            for i in range(model.cfg.num_layers) for p, _, _, init in blk]
    return out


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", *, trainable: bool = False) -> TransformerLM:
    """A fresh LM with the JAX init's shapes, dtypes and scales (normal
    draws times 1/sqrt(fan_in), embeddings 0.02, unit norms, RWKV's
    ``w_base`` -0.5, ``u`` 0.3 and zero token-shift mixes).  Each leaf is
    drawn on ``device`` in its own dtype from ``generator`` (a generator
    of that device): qwen3-8b's 8.2 B parameters never pass through host
    memory."""
    model = TransformerLM(cfg, device=device, trainable=trainable)
    for param, _, _, (kind, value) in _targets(model):
        if kind == "normal":
            param.normal_(0.0, value, generator=generator)
        else:
            param.fill_(value)
    return model


def jax_leaf_names(cfg: ArchConfig):
    """``(name, jax_path, layer)`` of every parameter: ``name`` is the
    module's (``blocks.3.attn.wq``), ``jax_path`` the JAX tree's
    (``blocks/attn/wq``), ``layer`` the index on its stacked layer axis
    (None outside ``blocks``)."""
    top, blk = _leaves(cfg)
    out = [(p.replace("/", "."), p, None) for p, _, _, _ in top]
    out += [(f"blocks.{i}.{p.replace('/', '.')}", f"blocks/{p}", i)
            for i in range(cfg.num_layers) for p, _, _, _ in blk]
    return out


def _jax_values(model: TransformerLM, tree):
    """``(param, value)`` for every leaf of ``model``: ``value`` the JAX
    tree's f32 numpy leaf (a layer's slice of a stacked ``blocks`` leaf),
    checked against the parameter's shape."""
    stacked: Dict[str, np.ndarray] = {}
    for param, path, layer, _ in _targets(model):
        if path not in stacked:
            node = tree
            for part in path.split("/"):
                node = node[part]
            stacked[path] = np.asarray(node, np.float32)
        value = stacked[path] if layer is None else stacked[path][layer]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path} (layer {layer}): shape {value.shape} "
                             f"!= {tuple(param.shape)}")
        yield param, value


@torch.no_grad()
def load_jax_params(cfg: ArchConfig, tree, device="cuda", *,
                    trainable: bool = False) -> TransformerLM:
    """An LM holding the JAX parameter tree ``tree`` (numpy or array-like
    leaves of any float dtype; ``blocks`` leaves stacked on a leading
    ``num_layers`` axis, as ``jax.vmap`` over layers builds them)."""
    model = TransformerLM(cfg, device=device, trainable=trainable)
    for param, value in _jax_values(model, tree):
        param.copy_(torch.from_numpy(np.array(value)))   # a writable copy
    return model


def load_jax_opt_state(model: TransformerLM, jax_opt_state):
    """The port's optimizer state (``repro_torch.optim.init_opt_state``'s
    layout: f32 moments keyed by the model's parameter names, on its
    device) holding JAX's ``{"m", "v", "step"}`` (numpy leaves, ``blocks``
    stacked on the layer axis, split here into the port's per-layer
    trees), so a JAX train state continues in the port."""
    device = next(model.parameters()).device
    names = {id(p): n for n, p in model.named_parameters()}
    state = {}
    for key in ("m", "v"):
        loaded = {names[id(p)]: torch.from_numpy(np.array(value)).to(device)
                  for p, value in _jax_values(model, jax_opt_state[key])}
        state[key] = {n: loaded[n] for n, _ in model.named_parameters()}
    state["step"] = torch.tensor(int(np.asarray(jax_opt_state["step"])),
                                 dtype=torch.int32, device=device)
    return state


def param_count(model: TransformerLM) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())


# --------------------------------------------------------------------------
# forward modes
# --------------------------------------------------------------------------

def _norm(cfg: ArchConfig):
    def norm(pn, x):
        return apply_norm(x, pn["scale"], kind=cfg.norm,
                          bias=pn["bias"] if "bias" in pn else None)
    return norm


def _attn_kwargs(cfg: ArchConfig) -> dict:
    hq, hkv = cfg.padded_heads(1)
    return dict(num_heads=hq, num_kv_heads=hkv,
                head_dim=cfg.resolved_head_dim, window=cfg.window,
                theta=cfg.rope_theta, qk_norm=cfg.qk_norm)


def forward_hidden(cfg: ArchConfig, model: TransformerLM, batch, *,
                   use_kernel: Optional[bool] = None,
                   return_cache: bool = False):
    """The backbone up to the final norm: ``(x (B, S, d), cache|None)``,
    the cache being what :func:`prefill` returns."""
    norm = _norm(cfg)
    x = embed(model["embed"], batch["tokens"])
    caches = []
    if cfg.block == "rwkv6":
        state0 = init_rwkv_state(x.shape[0], cfg.d_model, cfg.rwkv_head_dim,
                                 x.dtype, x.device)
        for p in model.blocks:
            x, st = rwkv_block(p, x, state0, cfg.rwkv_head_dim, norm,
                               use_kernel=use_kernel)
            if return_cache:
                caches.append(st)
    else:
        kw = _attn_kwargs(cfg)
        for p in model.blocks:
            out, kv = attention_full(p["attn"], norm(p["ln1"], x),
                                     causal=cfg.causal, **kw,
                                     use_kernel=use_kernel)
            x = x + out
            x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
            if return_cache:
                caches.append(kv)
    x = norm(model["ln_f"], x)
    if not return_cache:
        return x, None
    stacked = tuple(torch.stack(parts) for parts in zip(*caches))
    return x, RWKVState(*stacked) if cfg.block == "rwkv6" else stacked


def forward_train(cfg: ArchConfig, model: TransformerLM, batch, *,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence logits ``(B, S, vocab)`` in f32."""
    x, _ = forward_hidden(cfg, model, batch, use_kernel=use_kernel)
    return unembed(model["unembed"], x)


def make_dense_cache(cfg: ArchConfig, batch: int, seq_len: int,
                     device="cuda"):
    """An empty decode cache: zero K/V ``(L, B, seq_len, Hkv, D)`` in bf16
    (JAX's default cache dtype), or RWKV6's zero state per layer."""
    device = resolve_device(device)
    n = cfg.num_layers
    if cfg.block == "rwkv6":
        st = init_rwkv_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                             _DTYPES[cfg.dtype], device)
        return RWKVState(*(t.expand((n,) + t.shape).clone() for t in st))
    _, hkv = cfg.padded_heads(1)
    shape = (n, batch, seq_len, hkv, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
            torch.zeros(shape, dtype=torch.bfloat16, device=device))


@torch.no_grad()
def prefill(cfg: ArchConfig, model: TransformerLM, batch, *,
            use_kernel: Optional[bool] = None):
    """The full sequence: ``(last_logits (B, vocab) f32, cache)``."""
    x, cache = forward_hidden(cfg, model, batch, use_kernel=use_kernel,
                              return_cache=True)
    return unembed(model["unembed"], x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, token_batch, cache,
                pos: int, *, use_kernel: Optional[bool] = None):
    """One token, ``token_batch["tokens"]`` (B, 1), at position ``pos``
    against ``cache``, which it updates in place.  Returns
    ``(logits (B, vocab) f32, cache)``."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    norm = _norm(cfg)
    x = embed(model["embed"], token_batch["tokens"])
    if cfg.block == "rwkv6":
        for layer, p in enumerate(model.blocks):
            st = RWKVState(*(c[layer] for c in cache))
            x, new = rwkv_block(p, x, st, cfg.rwkv_head_dim, norm,
                                use_kernel=use_kernel)
            for c, n in zip(cache, new):
                c[layer].copy_(n)
    else:
        kw = _attn_kwargs(cfg)
        k_c, v_c = cache
        for layer, p in enumerate(model.blocks):
            out, _, _ = attention_decode(p["attn"], norm(p["ln1"], x),
                                         k_c[layer], v_c[layer], pos, **kw)
            x = x + out
            x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    x = norm(model["ln_f"], x)
    return unembed(model["unembed"], x[:, -1]), cache
