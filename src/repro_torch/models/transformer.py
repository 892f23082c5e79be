"""The language-model backbone (counterpart of
``repro.models.transformer``) for dense attention+MLP blocks
(``block="attn_mlp"``), MoE blocks (``moe_experts > 0``: the experts in
place of the MLP, or beside it with ``moe_dense_residual``), RWKV6 blocks
(``block="rwkv6"``) and Hymba blocks (``block="hymba"``), with the audio
(frame features in place of the embedding) and vision (image embeddings
spliced over the first ``num_prefix_embeds`` positions) stub frontends
and encoder-only (``causal=False``) attention, on one device or tensor-,
sequence-, data- and expert-parallel over a ``(data, model)`` or
``(pod, data, model)`` mesh.

:class:`TransformerLM` holds the parameters: one :class:`ParamTree` per
layer (JAX stacks them on a leading layer axis for ``jax.lax.scan``; the
port loops over layers), with the JAX tree's leaf names, shapes and
dtypes (norm scales, RWKV's ``w_base``/``u``/``gn_scale``, Hymba's SSM
leaves but ``w_in``/``w_out`` and the MoE ``router`` in f32, the rest in
the config's dtype; no ``embed`` for the audio frontend).  The parameters
are frozen unless the caller asks for ``trainable=True``
(``repro_torch.launch.train`` does); the serving functions run without
autograd either way.

:class:`ParallelCtx` is JAX's, field for field.  Its ``model_parallel``
pads the heads and the vocabulary as JAX pads them (``padded_heads``,
``padded_vocab``), with or without a mesh.  With a ``mesh`` (a
``DeviceMesh`` of one process per rank, every rank calling the same
functions with the same global inputs), each rank holds its part of every
parameter by :func:`repro_torch.parallel.sharding.param_shardings`, and
:class:`repro_torch.parallel.tensor_parallel.TensorParallel` issues the
collectives GSPMD inserts in JAX: q/K/V, the MLP's ``d_ff``, RWKV's and
the SSM's channels and the vocabulary split over ``model``; row shards
summed over it; with ``sp`` the residual stream split along the sequence
between blocks, each mixer's and MLP's normed input gathered first.  The
math is the single device's: at one rank every collective returns its
input's bits.  MoE blocks on a mesh (JAX's ``_apply_moe``): with
``use_ep`` (JAX's launcher sets it for every MoE arch) each rank holds
``E / D`` experts and ``f / M`` of their width and runs
:func:`repro_torch.models.moe.moe_ep_local` on its tokens (under ``sp``
the sequence gathered first and the rank's slice of the output kept),
the aux a ``pmean`` over the batch axes (value the mean, gradient the
rank's share: :func:`repro_torch.parallel.collectives.mean_share`);
without it each rank gathers the experts over ``data`` and runs
:func:`moe_local` on its tokens, with the global Switch loss as JAX's
GSPMD computes it.  The router routes from an input whose gradient is
not summed over ``model`` (it is whole on every model rank).  ``fsdp``
in a forward raises, naming A12 (JAX's launcher never sets it;
:func:`repro_torch.parallel.sharding.param_shardings` takes it);
``remat`` and a ``remat_policy`` other than JAX's default raise, naming
A13.  ``scan_unroll`` is accepted and does nothing (it changes no result
in JAX, and the port has no scan).  ``attn_chunk_kv`` runs the plain
chunked attention (``ref.attention_chunked``) where the flash kernel does
not run, as JAX's ``attention_full`` does.

Modes, with the JAX semantics:
  * :func:`forward_hidden` / :func:`forward_train`: the full sequence,
    hidden states / f32 logits, and the MoE auxiliary loss summed over
    the layers (0 without MoE); with a mesh the logits are the rank's
    vocabulary columns.  ``batch`` holds ``tokens``, or ``features`` for
    the audio frontend, and for the vision frontend ``image_embeds``;
  * :func:`prefill`: the full sequence, returns ``(last_logits, cache)``.
    It unembeds the last position only (JAX unembeds every position and
    keeps the last: the same per-position numbers, without a
    (B, S, vocab) f32 tensor that is 5 GB for qwen3-8b at batch 4 x 2048);
  * :func:`decode_step`: one token against the cache at ``pos``.  The port
    updates the cache in place (JAX returns an updated copy).

Caches: dense, ``(k, v)`` each ``(L, B, S, Hkv, D)`` with K after qk-norm
and rope; RWKV6, an :class:`RWKVState` of per-layer stacks; Hymba, a
:class:`HymbaCache` of per-layer stacks (``ring_pos`` ``(L, W)``).  With a
mesh each rank holds its part by
:func:`repro_torch.parallel.sharding.cache_shardings` (flash-decoding):
K/V and the ring split along their sequence or slots over ``model`` with
every head, RWKV's WKV states on heads and its shift states on ``d``, the
SSM states on ``d_inner``; a decode step gathers the token's q, k and v
over heads, the slot's owner writes it, every rank attends over its
slots, and :func:`repro_torch.parallel.collectives.lse_combine` merges
the partials.

Hymba's prefill ring (ROADMAP C16).  :func:`prefill` always returns a ring
of ``window`` slots in :func:`init_hymba_cache`'s layout: position ``p`` of
the last ``min(S, window)`` in slot ``p % window``, ``ring_pos`` -1 in the
slots no position filled.  For S >= window that is JAX's ring (its roll by
``(S - window) % window``), and the tests hold it there.  For S < window
JAX builds ``window`` positions over ``S`` slots and its own
``decode_step`` fails on the shapes; the port decodes, and its tests hold
that case against its own :func:`forward_train`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.parallel.tensor_parallel import TensorParallel
from .dit import resolve_device
from .hymba import HymbaCache, hymba_mix_decode, hymba_mix_full, \
    init_hymba_cache
from .layers import (apply_mlp, apply_norm, attention_decode, attention_full,
                     decode_partials, embed, project_qkv, unembed)
from .moe import moe_ep_local, moe_local
from .rwkv6 import LORA_R, RWKVState, init_rwkv_state, rwkv_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float8_e4m3fn": torch.float8_e4m3fn}
# the norms between blocks: their scales see the residual stream, which is
# replicated over ``model`` (split along the sequence under ``sp``)
BLOCK_NORMS = ("ln1", "ln2", "ln_f", "n_attn", "n_ssm")
# a leaf: (path, shape, dtype, init); init is ("normal", std), ("fill",
# value) or ("log_linspace", n) (log(1 .. n), the same on every row), the
# JAX init's rule for that leaf
Leaf = Tuple[str, tuple, torch.dtype, tuple]


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """JAX's ``ParallelCtx`` (same fields and defaults; module docstring)."""
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    data_axis: str = "data"
    use_ep: bool = False
    sp: bool = False                 # sequence-parallel residual stream
    moe_capacity: float = 1.25
    moe_chunk: int = 8_192
    model_parallel: int = 1          # TP degree (head and vocab padding)
    # JAX: unroll the layer scan for cost analysis; no result changes, and
    # the port has no scan, so it does nothing here
    scan_unroll: bool = False
    attn_chunk_kv: Optional[int] = None   # plain chunked attention's tile
    ce_masksum: bool = False              # CE gold logit by mask-sum
    moe_fixed_capacity: bool = False
    remat_policy: str = "dots"            # dots | nothing
    bf16_grad_sync: bool = False          # the step's gradient sums in bf16
    fsdp: bool = False                    # large dense params on data
    kv_cache_dtype: str = "bfloat16"      # make_dense_cache's dtype


LOCAL = ParallelCtx()


def check_ctx(parallel: ParallelCtx, remat: bool = False) -> None:
    """Raise for the fields whose JAX user the port lacks."""
    if parallel.fsdp:
        raise NotImplementedError("FSDP execution (parameters gathered "
                                  "over data in the forward) waits for "
                                  "ROADMAP A12")
    if remat or parallel.remat_policy != "dots":
        raise NotImplementedError("rematerialization (remat=, "
                                  "remat_policy) is ROADMAP A13")
    if parallel.kv_cache_dtype not in KV_DTYPES:
        raise ValueError(f"kv_cache_dtype {parallel.kv_cache_dtype!r} not "
                         f"in {sorted(KV_DTYPES)}")


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


def _leaves(cfg: ArchConfig, mp: int = 1) -> Tuple[List[Leaf], List[Leaf]]:
    """(top-level leaves, per-layer block leaves) of the JAX init
    (``repro.models.transformer.init_params`` with ``ParallelCtx(
    model_parallel=mp)``): paths, global shapes without the layer axis,
    dtypes and init rules."""
    if cfg.block not in ("attn_mlp", "rwkv6", "hymba"):
        raise ValueError(f"unknown block {cfg.block!r}")
    dt = _DTYPES[cfg.dtype]
    d, ff = cfg.d_model, cfg.d_ff
    vocab = cfg.padded_vocab(mp)
    s_d, s_ff = d ** -0.5, ff ** -0.5
    # the audio stub feeds frame features: no embedding table
    top = [] if cfg.frontend == "audio" else [
        ("embed/table", (vocab, d), dt, ("normal", 0.02))]
    top.append(("unembed/w", (d, vocab), dt, ("normal", s_d)))
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
    hq, hkv = cfg.padded_heads(mp)
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
    if cfg.block == "hymba":
        din, n = cfg.ssm_d_inner or d, cfg.ssm_state
        f32, s_i = torch.float32, ("normal", din ** -0.5)
        blk += [("ssm/w_in", (d, 2 * din), dt, ("normal", s_d)),
                ("ssm/w_dt", (din, 1), f32, s_i),
                ("ssm/b_dt", (1,), f32, ("fill", -2.0)),
                ("ssm/w_B", (din, n), f32, s_i),
                ("ssm/w_C", (din, n), f32, s_i),
                ("ssm/A_log", (din, n), f32, ("log_linspace", n)),
                ("ssm/D", (din,), f32, ("fill", 1.0)),
                ("ssm/w_out", (din, d), dt, s_i)]
        blk += _norm_leaves("n_attn", d, cfg.norm)
        blk += _norm_leaves("n_ssm", d, cfg.norm)
    if cfg.moe_experts and cfg.block == "attn_mlp":
        e, mff = cfg.moe_experts, cfg.moe_d_ff
        blk += [("moe/router", (d, e), torch.float32, ("normal", s_d)),
                ("moe/w_up", (e, d, mff), dt, ("normal", s_d)),
                ("moe/w_down", (e, mff, d), dt, ("normal", mff ** -0.5))]
        if cfg.act == "swiglu":
            blk.append(("moe/w_gate", (e, d, mff), dt, ("normal", s_d)))
        if not cfg.moe_dense_residual:
            return top, blk
    blk += [("mlp/w_up", (d, ff), dt, ("normal", s_d)),
            ("mlp/w_down", (ff, d), dt, ("normal", s_ff))]
    if cfg.act == "swiglu":
        blk.append(("mlp/w_gate", (d, ff), dt, ("normal", s_d)))
    return top, blk


def global_shapes(cfg: ArchConfig, parallel: ParallelCtx = LOCAL
                  ) -> Dict[str, tuple]:
    """``{parameter name: global shape}`` in the model's order."""
    top, blk = _leaves(cfg, parallel.model_parallel)
    out = {p.replace("/", "."): shape for p, shape, _, _ in top}
    for i in range(cfg.num_layers):
        out.update({f"blocks.{i}.{p.replace('/', '.')}": shape
                    for p, shape, _, _ in blk})
    return out


def _local_shape(shape: tuple, spec, mesh) -> tuple:
    sizes = sharding.mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[dim] //= sizes[a]
    return tuple(out)


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
    ``trainable``.  With ``parallel.mesh`` each leaf is this rank's part
    (``specs``: :func:`sharding.param_shardings` over ``shapes``, the
    global shapes)."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 trainable: bool = False,
                 parallel: ParallelCtx = LOCAL):
        device = resolve_device(device) if str(device) != "meta" \
            else torch.device("meta")
        top, blk = _leaves(cfg, parallel.model_parallel)
        self_shapes = global_shapes(cfg, parallel)
        specs = (sharding.param_shardings(cfg, parallel.mesh, self_shapes,
                                          parallel)
                 if parallel.mesh is not None else None)

        def local(leaves, layer):
            if specs is None:
                return leaves
            out = []
            for path, shape, dt, init in leaves:
                name = path.replace("/", ".")
                if layer is not None:
                    name = f"blocks.{layer}.{name}"
                out.append((path, _local_shape(shape, specs[name],
                                               parallel.mesh), dt, init))
            return out

        super().__init__(_nest(local(top, None)), device, trainable)
        self.cfg = cfg
        self.parallel = parallel
        self.shapes = self_shapes
        self.specs = specs
        self.blocks = nn.ModuleList(
            ParamTree(_nest(local(blk, i)), device, trainable)
            for i in range(cfg.num_layers))


def _param(model: TransformerLM, path: str, layer: Optional[int]):
    node = model if layer is None else model.blocks[layer]
    for part in path.split("/"):
        node = node[part]
    return node


def _targets(model: TransformerLM):
    """``(param, jax_path, layer, init, name)`` for every leaf of
    ``model``."""
    top, blk = _leaves(model.cfg, model.parallel.model_parallel)
    out = [(_param(model, p, None), p, None, init, p.replace("/", "."))
           for p, _, _, init in top]
    out += [(_param(model, p, i), f"blocks/{p}", i, init,
             f"blocks.{i}.{p.replace('/', '.')}")
            for i in range(model.cfg.num_layers) for p, _, _, init in blk]
    return out


def _to_local(model: TransformerLM, name: str, full: torch.Tensor):
    if model.specs is None:
        return full
    return sharding.local_part(name, full, model.specs[name],
                               model.parallel.mesh)


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", *, trainable: bool = False,
                parallel: ParallelCtx = LOCAL) -> TransformerLM:
    """A fresh LM with the JAX init's shapes, dtypes and scales (normal
    draws times 1/sqrt(fan_in), embeddings 0.02, unit norms, RWKV's
    ``w_base`` -0.5, ``u`` 0.3 and zero token-shift mixes, Hymba's
    ``b_dt`` -2, ``D`` 1 and ``A_log`` log(1 .. n) on every row).  Each leaf is
    drawn on ``device`` in its own dtype from ``generator`` (a generator
    of that device): qwen3-8b's 8.2 B parameters never pass through host
    memory.  With a mesh every rank draws each whole leaf in turn, as
    JAX's launcher draws the whole model before placing it, and keeps its
    part."""
    model = TransformerLM(cfg, device=device, trainable=trainable,
                          parallel=parallel)
    for param, _, _, (kind, value), name in _targets(model):
        full = param if model.specs is None else torch.empty(
            model.shapes[name], dtype=param.dtype, device=param.device)
        if kind == "normal":
            full.normal_(0.0, value, generator=generator)
        elif kind == "log_linspace":
            full.copy_(torch.log(torch.linspace(
                1.0, float(value), value, device=full.device)).expand_as(
                    full))
        else:
            full.fill_(value)
        if model.specs is not None:
            param.copy_(_to_local(model, name, full))
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
    tree's f32 leaf (a layer's slice of a stacked ``blocks`` leaf; with a
    mesh this rank's part of it), checked against the parameter's
    shape."""
    stacked: Dict[str, np.ndarray] = {}
    for param, path, layer, _, name in _targets(model):
        if path not in stacked:
            node = tree
            for part in path.split("/"):
                node = node[part]
            stacked[path] = np.asarray(node, np.float32)
        value = stacked[path] if layer is None else stacked[path][layer]
        value = _to_local(model, name, torch.from_numpy(np.array(value)))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path} (layer {layer}): shape "
                             f"{tuple(value.shape)} != {tuple(param.shape)}")
        yield param, value, name


@torch.no_grad()
def load_jax_params(cfg: ArchConfig, tree, device="cuda", *,
                    trainable: bool = False,
                    parallel: ParallelCtx = LOCAL) -> TransformerLM:
    """An LM holding the JAX parameter tree ``tree`` (numpy or array-like
    leaves of any float dtype; ``blocks`` leaves stacked on a leading
    ``num_layers`` axis, as ``jax.vmap`` over layers builds them; the
    shapes of JAX's init with ``parallel``'s ``model_parallel``)."""
    model = TransformerLM(cfg, device=device, trainable=trainable,
                          parallel=parallel)
    for param, value, _ in _jax_values(model, tree):
        param.copy_(value)
    return model


def load_jax_opt_state(model: TransformerLM, jax_opt_state,
                       zero1: Optional[dict] = None):
    """The port's optimizer state (``repro_torch.optim.init_opt_state``'s
    layout: f32 moments keyed by the model's parameter names, on its
    device) holding JAX's ``{"m", "v", "step"}`` (numpy leaves, ``blocks``
    stacked on the layer axis, split here into the port's per-layer
    trees), so a JAX train state continues in the port.  ``zero1``
    (:func:`repro_torch.train.steps.zero1_slices`) keeps each rank's
    ZeRO-1 slice of the moments."""
    device = next(model.parameters()).device
    state = {}
    for key in ("m", "v"):
        loaded = {}
        for _, value, name in _jax_values(model, jax_opt_state[key]):
            z = (zero1 or {}).get(name)
            loaded[name] = (z.part(value) if z is not None
                            else value).contiguous().to(device)
        state[key] = {n: loaded[n] for n, _ in model.named_parameters()}
    state["step"] = torch.tensor(int(np.asarray(jax_opt_state["step"])),
                                 dtype=torch.int32, device=device)
    return state


def param_count(model: TransformerLM) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())


def model_partial_grads(model: TransformerLM) -> List[str]:
    """The parameters replicated over ``model`` whose gradient on each
    rank is that rank's part (so the step sums it over ``model``): every
    replicated leaf inside a mixer or an MLP, whose output feeds the
    rank's own heads or channels (q/k-norm scales, replicated K/V
    projections, RWKV's mixes, LoRAs, ``u`` and group-norm scale, the
    SSM's ``b_dt``), and, under ``sp``, the norms between blocks, which
    see the rank's part of the sequence.  The MoE router is not one: it
    routes the same tokens on every model rank from an input whose
    gradient is whole there."""
    if model.specs is None:
        return []
    mp = model.parallel.model_axis
    out = []
    for name, spec in model.specs.items():
        if any(a == mp or (isinstance(a, tuple) and mp in a) for a in spec):
            continue
        keys = sharding.leaf_keys(name)
        if keys[-2:] == ("moe", "router"):
            continue
        if len(keys) >= 2 and keys[-2] in BLOCK_NORMS and \
                not model.parallel.sp:
            continue
        out.append(name)
    return out


# --------------------------------------------------------------------------
# forward modes
# --------------------------------------------------------------------------

def _norm(cfg: ArchConfig):
    def norm(pn, x):
        return apply_norm(x, pn["scale"], kind=cfg.norm,
                          bias=pn["bias"] if "bias" in pn else None)
    return norm


def _attn_kwargs(cfg: ArchConfig, tp: Optional[TensorParallel] = None,
                 mp: int = 1) -> dict:
    if tp is None:
        hq, hkv = cfg.padded_heads(mp)
        heads = dict(num_heads=hq, num_kv_heads=hkv)
    else:
        heads = dict(share=tp.heads())
    return dict(heads, head_dim=cfg.resolved_head_dim, window=cfg.window,
                theta=cfg.rope_theta, qk_norm=cfg.qk_norm)


def _ctx(model: TransformerLM, parallel: Optional[ParallelCtx],
         remat: bool = False) -> ParallelCtx:
    parallel = model.parallel if parallel is None else parallel
    if parallel != model.parallel:
        raise ValueError("the model was built for another ParallelCtx: "
                         "pass the one it was built with (or none)")
    check_ctx(parallel, remat)
    return parallel


def _embed(model: TransformerLM, tokens: torch.Tensor,
           tp: TensorParallel) -> torch.Tensor:
    """The vocabulary-parallel embedding: each rank looks up the tokens in
    its rows, zeros the others', and the ranks' rows are summed
    (reduce-scattered along the sequence under ``sp``)."""
    table = model["embed"]["table"]
    if tp.group is None:
        return embed(model["embed"], tokens)
    v_l = table.shape[0]
    local = tokens - tp.r * v_l
    ok = (local >= 0) & (local < v_l)
    rows = table[local.clamp(0, v_l - 1)]
    return tp.leave(torch.where(ok[..., None], rows, 0))


def _kv_layout(tp: TensorParallel, kv: torch.Tensor, seq_dim: int,
               length: int) -> torch.Tensor:
    """Prefill K/V (a layer's ``(B, S, H, D)``, or Hymba's rings stacked
    ``(L, B, W, H, D)``; the rank's heads where they are split, all of
    them where replicated) at ``length`` positions along ``seq_dim``
    (zeros past ``S``), with a mesh in the flash-decoding layout: split
    over ``model``, every head."""
    if kv.shape[seq_dim] != length:
        pad = list(kv.shape)
        pad[seq_dim] = length - kv.shape[seq_dim]
        kv = torch.cat([kv, kv.new_zeros(pad)], dim=seq_dim)
    if tp.group is None:
        return kv
    if tp.heads().kv_split:
        return coll.heads_to_seq(kv, seq_dim, seq_dim + 1, tp.group)
    return tp.part(kv, seq_dim).contiguous()


def embed_inputs(cfg: ArchConfig, model: TransformerLM, batch,
                 tp: TensorParallel) -> torch.Tensor:
    """The blocks' input (JAX's ``embed_inputs``): the audio stub's
    ``features`` cast to the model's dtype, else the token embedding with,
    for the vision stub, ``image_embeds`` ``(B, P, d)`` over the first P
    positions (the sequence keeps its length).  Under ``sp`` this rank's
    part of the sequence."""
    if cfg.frontend == "audio":
        x = batch["features"].to(_DTYPES[cfg.dtype])
        return tp.part(x, 1) if tp.sp else x
    x = _embed(model, batch["tokens"], tp)
    if cfg.frontend != "vision" or "image_embeds" not in batch:
        return x
    pfx = batch["image_embeds"]
    n, lo = pfx.shape[1], 0
    if tp.sp:       # this rank's rows of the global positions
        lo = tp.r * x.shape[1]
        n = min(max(n - lo, 0), x.shape[1])
    if n == 0:
        return x
    return torch.cat([pfx[:, lo:lo + n].to(x.dtype), x[:, n:]], dim=1)


def _global_switch_aux(cfg: ArchConfig, router: torch.Tensor,
                       xr: torch.Tensor, groups) -> torch.Tensor:
    """JAX's aux of :func:`moe_local` over the whole batch (GSPMD's),
    from each rank's tokens: the probabilities' and the top-1 counts'
    sums reduced over the batch groups (the gradient reaches this rank's
    own probabilities)."""
    probs = torch.softmax(xr.reshape(-1, xr.shape[-1]).float() @ router,
                          dim=-1)
    e = cfg.moe_experts
    # the top-1 expert: the first of equal maxima, as the route's sort
    stats = torch.cat([probs.sum(dim=0), torch.nn.functional.one_hot(
        probs.argmax(dim=-1), e).float().sum(dim=0)])
    n = torch.full((), float(probs.shape[0]), device=probs.device)
    for g in groups:
        stats = coll.reduce_from(stats, g)
        n = coll.reduce_from(n, g)
    return e * torch.sum((stats[:e] / n) * (stats[e:] / n))


def _apply_moe(cfg: ArchConfig, p, h: torch.Tensor, parallel: ParallelCtx,
               tp: TensorParallel):
    """The MoE of a block (JAX's ``_apply_moe``) on the normed input ``h``
    (under ``sp`` the rank's part of the sequence): ``(out, aux)``, out
    whole (the rank's part of the sequence under ``sp``)."""
    k, act = cfg.moe_top_k, cfg.act
    mesh = parallel.mesh
    if mesh is None:
        return moe_local(p, h, k, act)
    # the experts' input (its gradient summed over ``model``, where each
    # rank holds its part of the FFN width) and the router's (the same
    # values; its gradient whole on every model rank).  At one model rank
    # nothing is summed, and both read one entry: ``h``'s gradient then
    # adds its parts in the plain path's order (ROADMAP C24)
    xe = tp.enter(h)
    if tp.m == 1:
        xr = xe
    else:
        xr = coll.gather_split(h, 1, tp.group) if tp.sp else h
    if tp.m > 1 and p["w_up"].shape[2] == cfg.moe_d_ff:
        raise ValueError(f"{cfg.name}: the expert width {cfg.moe_d_ff} "
                         f"does not split over {tp.m} model ranks")
    batch_groups = [mesh.get_group(a) for a in parallel.batch_axes]
    b, s, d = xe.shape
    if parallel.use_ep:
        out, aux = moe_ep_local(
            p, xe.reshape(b * s, d), k, num_experts=cfg.moe_experts,
            data_group=mesh.get_group(parallel.data_axis),
            model_group=tp.group, capacity_factor=parallel.moe_capacity,
            chunk_tokens=parallel.moe_chunk, act=act,
            fixed_capacity=parallel.moe_fixed_capacity,
            x_route=xr.reshape(b * s, d))
        out = out.reshape(b, s, d)
        aux = coll.mean_share(aux, batch_groups)
    else:
        full = dict(p.named_parameters())
        if full["w_up"].shape[0] != cfg.moe_experts:
            dg = mesh.get_group(parallel.data_axis)
            full = {n: (w if n == "router" else coll.gather_seq(w, 0, dg))
                    for n, w in full.items()}
        out, _ = moe_local(full, xe, k, act, x_route=xr)
        out = coll.reduce_from(out, tp.group)
        aux = _global_switch_aux(cfg, p["router"], xr, batch_groups)
    if tp.sp:
        out = coll.split(out, 1, tp.group)
    return out, aux


def _mlp_or_moe(cfg: ArchConfig, p, h: torch.Tensor, parallel: ParallelCtx,
                tp: TensorParallel):
    """A dense block's second half on the normed input ``h``: ``(out,
    aux)`` to add to the residual (the MLP, or the MoE with its dense
    residual MLP beside it)."""
    aux = None
    if cfg.moe_experts:
        out, aux = _apply_moe(cfg, p["moe"], h, parallel, tp)
        if cfg.moe_dense_residual:
            out = out + tp.leave(apply_mlp(p["mlp"], tp.enter(h), cfg.act))
        return out, aux
    return tp.leave(apply_mlp(p["mlp"], tp.enter(h), cfg.act)), aux


def run_blocks(cfg: ArchConfig, model: TransformerLM, x: torch.Tensor,
               parallel: ParallelCtx, tp: TensorParallel, *,
               use_kernel: Optional[bool] = None,
               return_cache: bool = False, cache_len: Optional[int] = None):
    """Every block over the full sequence ``x`` (JAX's ``_block_full``
    scanned over the layers; ``cfg.causal`` picks the attention's form):
    ``(x, aux summed over the layers, caches)``, the caches per layer,
    except a dense model's: its K and V, each written layer by layer into
    one ``(L, ...)`` buffer of :func:`_kv_layout`'s ``cache_len``
    positions (no per-layer copies to stack)."""
    norm = _norm(cfg)
    chunk = parallel.attn_chunk_kv
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block == "rwkv6":
        b = x.shape[0]
        state0 = init_rwkv_state(b, cfg.d_model, cfg.rwkv_head_dim,
                                 x.dtype, x.device)
        if tp.group is not None:
            state0 = state0._replace(wkv=tp.part(state0.wkv, 1))
        for p in model.blocks:
            x, st = rwkv_block(p, x, state0, cfg.rwkv_head_dim, norm,
                               use_kernel=use_kernel, tp=tp)
            if return_cache:
                caches.append(st)
    elif cfg.block == "hymba":
        kw = dict(_attn_kwargs(cfg, tp), causal=cfg.causal, chunk_kv=chunk)
        for p in model.blocks:
            fused, kv, h_fin = hymba_mix_full(
                p, tp.enter(norm(p["ln1"], x)), kw, norm,
                use_kernel=use_kernel, tp=tp)
            x = x + fused
            x = x + tp.leave(apply_mlp(p["mlp"],
                                       tp.enter(norm(p["ln2"], x)), cfg.act))
            if return_cache:
                caches.append((*kv, h_fin))
    else:
        kw = _attn_kwargs(cfg, tp)
        for i, p in enumerate(model.blocks):
            out, kv = attention_full(p["attn"], tp.enter(norm(p["ln1"], x)),
                                     causal=cfg.causal, **kw,
                                     use_kernel=use_kernel, chunk_kv=chunk)
            x = x + tp.leave(out)
            out, layer_aux = _mlp_or_moe(cfg, p, norm(p["ln2"], x),
                                         parallel, tp)
            x = x + out
            if layer_aux is not None:
                aux = aux + layer_aux
            if return_cache:
                kv = [_kv_layout(tp, t, 1, cache_len) for t in kv]
                if not caches:
                    caches = [t.new_empty((cfg.num_layers,) + t.shape)
                              for t in kv]
                for buf, t in zip(caches, kv):
                    buf[i] = t
    return x, aux, caches


def forward_hidden(cfg: ArchConfig, model: TransformerLM, batch, *,
                   parallel: Optional[ParallelCtx] = None,
                   remat: bool = False,
                   use_kernel: Optional[bool] = None,
                   return_cache: bool = False,
                   cache_len: Optional[int] = None):
    """The backbone up to the final norm: ``(x (B, S, d), aux, cache|None)``,
    ``aux`` the MoE auxiliary loss summed over the layers (an f32 zero
    without MoE; on a mesh JAX's ``pmean`` over the batch axes, its
    gradient the rank's share), the cache being what :func:`prefill`
    returns.  Under ``sp`` ``x`` is this rank's part of the sequence
    (``S / m`` rows).  ``cache_len``: a dense cache's length, zeros past
    ``S`` (default ``S``; with a mesh rounded up to a multiple of the
    ``model`` dim)."""
    parallel = _ctx(model, parallel, remat)
    tp = TensorParallel(cfg, parallel)
    norm = _norm(cfg)
    x = embed_inputs(cfg, model, batch, tp)
    length = x.shape[1] * (tp.m if tp.sp else 1) if cache_len is None \
        else cache_len
    if tp.group is not None:
        length = -(-length // tp.m) * tp.m
    x, aux, caches = run_blocks(cfg, model, x, parallel, tp,
                                use_kernel=use_kernel,
                                return_cache=return_cache,
                                cache_len=length)
    x = norm(model["ln_f"], x)
    if not return_cache:
        return x, aux, None
    if cfg.block == "attn_mlp":
        return x, aux, tuple(caches)
    stacked = tuple(torch.stack(parts) for parts in zip(*caches))
    if cfg.block == "hymba":
        k, v, h_fin = stacked
        ring = _ring_from_prefill(cfg, k, v, h_fin)
        w = ring.k_ring.shape[2]
        return x, aux, HymbaCache(h_fin, _kv_layout(tp, ring.k_ring, 2, w),
                                  _kv_layout(tp, ring.v_ring, 2, w),
                                  ring.ring_pos)
    if cfg.block == "rwkv6":
        xt, wkv, xc = stacked
        return x, aux, RWKVState(tp.part(xt, -1).contiguous(), wkv,
                                 tp.part(xc, -1).contiguous())


def _ring_from_prefill(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
                       h_fin: torch.Tensor) -> HymbaCache:
    """The Hymba cache after a prefill: per-layer K/V ``(L, B, S, Hkv, D)``
    and SSM states, with the last ``min(S, window)`` positions in their
    ring slots (ROADMAP C16: always ``window`` slots)."""
    s = k.shape[2]
    w = cfg.window or s
    n, b = k.shape[:2]
    ring = torch.zeros((n, b, w) + k.shape[3:], dtype=k.dtype,
                       device=k.device)
    k_ring, v_ring = ring, ring.clone()
    ring_pos = torch.full((n, w), -1, dtype=torch.int32, device=k.device)
    pos = torch.arange(max(0, s - w), s, device=k.device)
    slots = pos % w
    k_ring[:, :, slots] = k[:, :, pos]
    v_ring[:, :, slots] = v[:, :, pos]
    ring_pos[:, slots] = pos.to(torch.int32)
    return HymbaCache(h_fin, k_ring, v_ring, ring_pos)


def forward_train(cfg: ArchConfig, model: TransformerLM, batch, *,
                  parallel: Optional[ParallelCtx] = None,
                  remat: bool = False,
                  use_kernel: Optional[bool] = None):
    """Full-sequence logits ``(B, S, vocab)`` in f32; with a mesh this
    rank's vocabulary columns ``(B, S, vocab / m)`` of every position
    (JAX's logits are sharded the same way).  The MoE aux is
    :func:`forward_hidden`'s."""
    parallel = _ctx(model, parallel, remat)
    x, _, _ = forward_hidden(cfg, model, batch, use_kernel=use_kernel)
    return unembed(model["unembed"], TensorParallel(cfg, parallel).enter(x))


def make_dense_cache(cfg: ArchConfig, batch: int, seq_len: int,
                     device="cuda", parallel: ParallelCtx = LOCAL):
    """An empty decode cache: zero K/V ``(L, B, seq_len, Hkv, D)`` in
    ``parallel.kv_cache_dtype`` (JAX's default bf16; ``float8_e4m3fn``
    stores ``torch.float8_e4m3fn``), RWKV6's zero state per layer, or
    Hymba's per layer (:func:`init_hymba_cache`: a ring of ``window``
    slots, or ``seq_len`` without a window, in the model's dtype, as
    JAX's), with the heads padded at ``parallel.model_parallel``.  With a
    mesh, this rank's part by :func:`sharding.cache_shardings`."""
    check_ctx(parallel)
    device = resolve_device(device)
    n = cfg.num_layers
    if cfg.block == "rwkv6":
        st = init_rwkv_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                             _DTYPES[cfg.dtype], device)
        cache = dict(zip(RWKVState._fields,
                         (t.expand((n,) + t.shape) for t in st)))
        kind = RWKVState
    else:
        _, hkv = cfg.padded_heads(parallel.model_parallel)
        if cfg.block == "hymba":
            c = init_hymba_cache(batch, cfg.ssm_d_inner or cfg.d_model,
                                 cfg.ssm_state, cfg.window or seq_len, hkv,
                                 cfg.resolved_head_dim, _DTYPES[cfg.dtype],
                                 device)
            cache = dict(zip(HymbaCache._fields,
                             (t.expand((n,) + t.shape) for t in c)))
            kind = HymbaCache
        else:
            shape = (n, batch, seq_len, hkv, cfg.resolved_head_dim)
            z = torch.zeros(shape, dtype=KV_DTYPES[parallel.kv_cache_dtype],
                            device=device)
            cache, kind = {"k": z, "v": z}, None
    if parallel.mesh is not None:
        specs = sharding.cache_shardings(cfg, parallel.mesh, cache, parallel)
        cache = {k: sharding.local_part(k, t, specs[k], parallel.mesh)
                 for k, t in cache.items()}
    parts = tuple(t.clone() for t in cache.values())
    return parts if kind is None else kind(*parts)


@torch.no_grad()
def prefill(cfg: ArchConfig, model: TransformerLM, batch, *,
            parallel: Optional[ParallelCtx] = None,
            use_kernel: Optional[bool] = None,
            cache_len: Optional[int] = None):
    """The full sequence: ``(last_logits (B, vocab) f32, cache)`` (an MoE
    block's aux is dropped, as JAX's).  ``cache_len``: a dense cache's
    length (module docstring); with a mesh the cache is this rank's part
    of the flash-decoding layout and the logits are gathered over the
    vocabulary."""
    parallel = _ctx(model, parallel)
    tp = TensorParallel(cfg, parallel)
    x, _, cache = forward_hidden(cfg, model, batch, use_kernel=use_kernel,
                                 return_cache=True, cache_len=cache_len)
    logits = unembed(model["unembed"], tp.enter(x)[:, -1])
    return tp.gather(logits, -1), cache


def _decode_attention(cfg, p, h, k_c, v_c, pos: int, tp: TensorParallel,
                      valid: torch.Tensor, slot: Optional[int]):
    """One token's attention against this rank's part of a flash-decoding
    cache ``(B, C, Hkv, D)`` (``valid`` its slots' mask; ``slot`` the
    local slot this rank writes, or None): the token's q, k and v
    gathered over heads, the local softmax's partials merged over
    ``model`` by :func:`coll.lse_combine`, and the rank's heads' rows
    through ``wo`` (the caller sums them)."""
    share = tp.heads()
    hd = cfg.resolved_head_dim
    b = h.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q, k_new, v_new = project_qkv(
        p, h, share.hq_l, share.kv_heads if share.kv_split else share.hkv,
        hd, positions, cfg.rope_theta, cfg.qk_norm)
    q = tp.gather(q, 2)
    if share.kv_split:
        k_new, v_new = tp.gather(k_new, 2), tp.gather(v_new, 2)
    if slot is not None:
        k_c[:, slot] = k_new[:, 0].to(k_c.dtype)
        v_c[:, slot] = v_new[:, 0].to(v_c.dtype)
    o, lse = decode_partials(q, k_c, v_c, valid, hd)
    o = torch.where(torch.isfinite(lse)[..., None], o, 0.0)
    if tp.group is not None:
        o = coll.lse_combine(o, lse, tp.group)
    o = o.reshape(b, 1, share.hq, hd)
    o = tp.part(o, 2).reshape(b, 1, share.hq_l * hd).to(h.dtype)
    return o @ p["wo"]


@torch.no_grad()
def decode_step(cfg: ArchConfig, model: TransformerLM, token_batch, cache,
                pos: int, *, parallel: Optional[ParallelCtx] = None,
                use_kernel: Optional[bool] = None):
    """One token, ``token_batch["tokens"]`` (B, 1), at position ``pos``
    against ``cache``, which it updates in place.  Returns
    ``(logits (B, vocab) f32, cache)``; an MoE block's aux is dropped, as
    JAX's."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    parallel = _ctx(model, parallel)
    norm = _norm(cfg)
    tp = TensorParallel(cfg, parallel).without_sp()
    x = _embed(model, token_batch["tokens"], tp)
    if cfg.block == "rwkv6":
        for layer, p in enumerate(model.blocks):
            st = RWKVState(tp.gather(cache.x_tmix[layer], -1),
                           cache.wkv[layer],
                           tp.gather(cache.x_cmix[layer], -1))
            x, new = rwkv_block(p, x, st, cfg.rwkv_head_dim, norm,
                                use_kernel=use_kernel, tp=tp)
            cache.x_tmix[layer].copy_(tp.part(new.x_tmix, -1))
            cache.wkv[layer].copy_(new.wkv)
            cache.x_cmix[layer].copy_(tp.part(new.x_cmix, -1))
    elif cfg.block == "hymba" and tp.group is not None:
        w = cfg.window
        for layer, p in enumerate(model.blocks):
            c = HymbaCache(*(t[layer] for t in cache))
            fused = hymba_mix_decode(
                p, norm(p["ln1"], x), c, pos, window=w, norm_fn=norm,
                use_kernel=use_kernel, tp=tp,
                attend=lambda pa, h, kc, vc, valid, slot: _decode_attention(
                    cfg, pa, h, kc, vc, pos, tp, valid, slot))[0]
            x = x + fused
            x = x + tp.leave(apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act))
    elif cfg.block == "hymba":
        kw = _attn_kwargs(cfg, mp=parallel.model_parallel)
        kw.pop("qk_norm")
        for layer, p in enumerate(model.blocks):
            c = HymbaCache(*(t[layer] for t in cache))
            fused, _ = hymba_mix_decode(p, norm(p["ln1"], x), c, pos, **kw,
                                        norm_fn=norm, use_kernel=use_kernel)
            x = x + fused
            x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    elif tp.group is not None:
        k_c, v_c = cache
        n_slots = k_c.shape[2]
        kpos = tp.r * n_slots + torch.arange(n_slots, device=x.device)
        valid = kpos <= pos
        if cfg.window is not None:
            valid = valid & (kpos > pos - cfg.window)
        owner, slot = divmod(pos, n_slots)
        slot = slot if owner == tp.r else None
        for layer, p in enumerate(model.blocks):
            out = _decode_attention(cfg, p["attn"], norm(p["ln1"], x),
                                    k_c[layer], v_c[layer], pos, tp, valid,
                                    slot)
            x = x + tp.leave(out)
            x = x + _mlp_or_moe(cfg, p, norm(p["ln2"], x), parallel, tp)[0]
    else:
        kw = _attn_kwargs(cfg, mp=parallel.model_parallel)
        k_c, v_c = cache
        for layer, p in enumerate(model.blocks):
            out, _, _ = attention_decode(p["attn"], norm(p["ln1"], x),
                                         k_c[layer], v_c[layer], pos, **kw)
            x = x + out
            x = x + _mlp_or_moe(cfg, p, norm(p["ln2"], x), parallel, tp)[0]
    x = norm(model["ln_f"], x)
    return tp.gather(unembed(model["unembed"], x[:, -1]), -1), cache
