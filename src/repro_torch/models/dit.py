"""DiT denoiser (adaLN-zero), counterpart of ``repro.models.dit``.

Patchified image -> transformer blocks with time-conditioned modulation
-> unpatchify to an epsilon prediction, in the JAX layout ``(B, H, W, C)``
at the public functions; ``DiT.forward`` is the counterpart of JAX's
``dit_forward(cfg, params, x_img, t)``.  It follows the JAX code, not the
config: both in-block norms and ``ln_f`` are RMSNorm (eps 1e-6) whatever
``cfg.norm`` says, attention is non-causal without rope, the
modulation splits as ``(shift_attn, scale_attn, shift_mlp, gate_attn,
scale_mlp, gate_mlp)``, GELU is the tanh form, SiLU runs in f32.

:func:`load_jax_params` turns the JAX parameter tree (numpy leaves,
``blocks`` stacked on a leading ``num_layers`` axis) into a :class:`DiT`,
and :func:`load_jax_opt_state` JAX's AdamW moments into the port's
optimizer state, so a JAX train state continues here;
:func:`init_dit` draws a fresh DiT with the JAX shapes and scales from a
``torch.Generator``.  adaLN-zero leaves ``mod``, ``mod_b``, ``mod_f``,
``mod_fb`` and ``patch_out`` at zero, so a fresh DiT predicts eps == 0.
The parameters are trainable; the samplers' :func:`make_denoiser` runs
without autograd, on one device or patch-sharded over a mesh dim.

The TimeConditioned wrapper (JAX's ``init_time_conditioned`` and
``time_conditioned_forward``) makes any backbone of the LM zoo an
embedding-space denoiser: :class:`TimeConditioned` holds a
:class:`repro_torch.models.transformer.TransformerLM` and two leaves,
``time_in`` ``(256, d)`` and ``eps_out`` ``(d, d)``;
:func:`time_conditioned_forward` adds the sinusoidal time embedding to
every position of the latents, runs every block non-causal, then
``ln_f`` and ``eps_out``; :func:`make_time_conditioned_denoiser` is its
``model_fn(x, t)`` for ``srds_sample`` and ``sample_sequential``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .layers import (apply_mlp, apply_norm, attention_full,
                     sinusoidal_time_embed)

POS_ROWS = 4096          # positional table rows (the JAX init's size)
TIME_EMBED_DIM = 256
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must exist when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return device


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class DiTBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.attn = nn.ParameterDict({
            "wq": _param((d, cfg.num_heads * hd), dtype, device),
            "wk": _param((d, cfg.num_kv_heads * hd), dtype, device),
            "wv": _param((d, cfg.num_kv_heads * hd), dtype, device),
            "wo": _param((cfg.num_heads * hd, d), dtype, device)})
        self.mlp = nn.ParameterDict({
            "w_up": _param((d, cfg.d_ff), dtype, device),
            "w_down": _param((cfg.d_ff, d), dtype, device)})
        self.mod = _param((d, 6 * d), dtype, device)
        self.mod_b = _param((6 * d,), dtype, device)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class DiT(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = _DTYPES[cfg.dtype]
        d = cfg.d_model
        p_in = cfg.patch_size * cfg.patch_size * cfg.in_channels
        self.patch_in = _param((p_in, d), dtype, device)
        self.pos = _param((POS_ROWS, d), dtype, device)
        self.t_mlp1 = _param((TIME_EMBED_DIM, d), dtype, device)
        self.t_mlp2 = _param((d, d), dtype, device)
        self.blocks = nn.ModuleList(DiTBlock(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.ParameterDict(                     # RMSNorm, f32
            {"scale": _param((d,), torch.float32, device)})
        self.mod_f = _param((d, 2 * d), dtype, device)
        self.mod_fb = _param((2 * d,), dtype, device)
        self.patch_out = _param((d, p_in), dtype, device)

    def forward(self, x_img: torch.Tensor, t: torch.Tensor, *,
                use_kernel: Optional[bool] = None, shard_rank: int = 0,
                kv_gather: Optional[Callable] = None) -> torch.Tensor:
        """x_img: (B, H, W, C); t: (B,) conditioning times -> eps.
        ``use_kernel=False`` takes the plain attention (a yardstick).

        The row-sharded form (JAX's ``dit_forward(..., shard_axis=)``):
        ``x_img`` is shard ``shard_rank`` of ``m`` equal row shards of the
        image, its positions are offset by ``shard_rank * (gh * gw)``
        (row-major patches make a row shard one contiguous range), and
        ``kv_gather`` joins every layer's projected K and V along the
        sequence, so the local queries attend to the whole image.  Patch
        embedding, modulation, the MLP and unpatchify are per position."""
        cfg = self.cfg
        b, h, w, c = x_img.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        dtype = self.patch_in.dtype
        patches = x_img.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh * gw, p * p * c).to(dtype)
        off = shard_rank * gh * gw
        x = patches @ self.patch_in + self.pos[off:off + gh * gw][None]

        temb = sinusoidal_time_embed(t, TIME_EMBED_DIM).to(dtype)
        temb = F.silu((temb @ self.t_mlp1).float()).to(dtype)
        temb = temb @ self.t_mlp2                                # (B, d)
        silu_t = F.silu(temb.float()).to(dtype)

        for blk in self.blocks:
            mod = silu_t @ blk.mod + blk.mod_b
            sa, ga, sm, gm, s2, g2 = mod.chunk(6, dim=-1)
            h_in = _modulate(apply_norm(x), sa, ga)
            attn, _ = attention_full(
                blk.attn, h_in, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                causal=False, theta=None, use_kernel=use_kernel,
                kv_gather=kv_gather)
            x = x + gm[:, None] * attn
            h2 = _modulate(apply_norm(x), sm, s2)
            x = x + g2[:, None] * apply_mlp(blk.mlp, h2, act="gelu")

        sf, gf = (silu_t @ self.mod_f + self.mod_fb).chunk(2, dim=-1)
        x = _modulate(apply_norm(x, self.ln_f["scale"]), sf, gf)
        out = x @ self.patch_out                           # (B, n, p*p*c)
        out = out.reshape(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, c).to(x_img.dtype)


def _leaves(cfg: ArchConfig):
    """(path, shape) of every DiT leaf; a path names the leaf both in the
    JAX tree and in the module.  Block leaves carry no layer axis here."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p_in = cfg.patch_size * cfg.patch_size * cfg.in_channels
    top = [("patch_in", (p_in, d)), ("pos", (POS_ROWS, d)),
           ("t_mlp1", (TIME_EMBED_DIM, d)), ("t_mlp2", (d, d)),
           ("ln_f/scale", (d,)), ("mod_f", (d, 2 * d)), ("mod_fb", (2 * d,)),
           ("patch_out", (d, p_in))]
    blk = [("attn/wq", (d, cfg.num_heads * hd)),
           ("attn/wk", (d, cfg.num_kv_heads * hd)),
           ("attn/wv", (d, cfg.num_kv_heads * hd)),
           ("attn/wo", (cfg.num_heads * hd, d)),
           ("mlp/w_up", (d, cfg.d_ff)), ("mlp/w_down", (cfg.d_ff, d)),
           ("mod", (d, 6 * d)), ("mod_b", (6 * d,))]
    return top, blk


def random_jax_tree(cfg: ArchConfig, seed: int, adaln_scale: float = 0.1):
    """A JAX-layout parameter tree of numpy f32 arrays, every leaf drawn
    nonzero from ``seed`` (blocks stacked on a leading layer axis).  Weights
    are normal / sqrt(fan_in); the adaLN leaves (``mod*``) are scaled by
    ``adaln_scale`` so the modulation stays small, and ``ln_f``'s scale is
    1 + 0.1 * normal.  A parity check on a fresh adaLN-zero init compares
    zeros with zeros; this tree makes every layer count."""
    rng = np.random.default_rng(seed)
    top, blk = _leaves(cfg)

    def draw(path, shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        if path == "ln_f/scale":
            return 1.0 + 0.1 * x
        if path == "pos":
            return 0.02 * x
        fan_in = shape[-2] if len(shape) > 1 else cfg.d_model
        scale = fan_in ** -0.5
        if path.startswith("mod"):
            scale *= adaln_scale
        return x * np.float32(scale)

    def put(node, path, value):
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    tree = {"blocks": {}}
    for path, shape in top:
        put(tree, path, draw(path, shape))
    for path, shape in blk:
        put(tree["blocks"], path, draw(path, (cfg.num_layers,) + shape))
    return tree


def _module_param(root: nn.Module, path: str) -> nn.Parameter:
    node = root
    for part in path.split("/"):
        node = node[part] if isinstance(node, nn.ParameterDict) \
            else getattr(node, part)
    return node


def _tree_get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _set(param: nn.Parameter, value, what: str) -> None:
    value = np.array(value, dtype=np.float32)     # a writable copy
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{what}: shape {value.shape} != "
                         f"{tuple(param.shape)}")
    param.copy_(torch.from_numpy(value))


def jax_leaf_names(cfg: ArchConfig):
    """``(name, jax_path, layer)`` for every DiT parameter: ``name`` is the
    module's own (``blocks.3.attn.wq``), ``jax_path`` the leaf's path in the
    JAX tree (``blocks/attn/wq``) and ``layer`` its index on the stacked
    layer axis (None outside ``blocks``)."""
    top, blk = _leaves(cfg)
    out = [(path.replace("/", "."), path, None) for path, _ in top]
    out += [(f"blocks.{i}.{path.replace('/', '.')}", f"blocks/{path}", i)
            for path, _ in blk for i in range(cfg.num_layers)]
    return out


def _jax_values(cfg: ArchConfig, tree):
    """``{name: numpy f32 value}`` of a JAX-layout DiT tree."""
    out, leaves = {}, {}
    for name, path, layer in jax_leaf_names(cfg):
        if path not in leaves:
            leaves[path] = np.asarray(_tree_get(tree, path), np.float32)
            if layer is not None and leaves[path].shape[0] != cfg.num_layers:
                raise ValueError(f"{path}: {leaves[path].shape[0]} layers, "
                                 f"config has {cfg.num_layers}")
        out[name] = leaves[path] if layer is None else leaves[path][layer]
    return out


@torch.no_grad()
def load_jax_params(cfg: ArchConfig, tree, device="cuda") -> DiT:
    """A :class:`DiT` holding the JAX parameter tree ``tree`` (numpy or
    array-like leaves, any float dtype; ``blocks`` leaves stacked on a
    leading ``num_layers`` axis, as ``jax.vmap(blk)`` builds them)."""
    model = DiT(cfg, device=device)
    params = dict(model.named_parameters())
    for name, value in _jax_values(cfg, tree).items():
        _set(params[name], value, name)
    return model


@torch.no_grad()
def load_jax_opt_state(model: DiT, jax_opt_state):
    """The port's optimizer state (``repro_torch.optim.init_opt_state``'s
    layout, on the model's device) holding JAX's ``{"m", "v", "step"}``
    (numpy leaves, ``blocks`` stacked on the layer axis), so a JAX train
    state continues in the port."""
    device = next(model.parameters()).device
    state = {}
    for key in ("m", "v"):
        state[key] = {name: torch.from_numpy(np.array(value)).to(device)
                      for name, value in _jax_values(
                          model.cfg, jax_opt_state[key]).items()}
    state["step"] = torch.tensor(int(np.asarray(jax_opt_state["step"])),
                                 dtype=torch.int32, device=device)
    return state


@torch.no_grad()
def init_dit(cfg: ArchConfig, generator: torch.Generator,
             device="cuda") -> DiT:
    """A fresh DiT with the JAX init's shapes and scales (normal draws
    scaled by 1/sqrt(fan_in), ``pos`` by 0.02, unit ``ln_f``), adaLN-zero
    leaves at zero.  Draws on the CPU from ``generator``, then moves."""
    model = DiT(cfg, device="cpu")
    d = cfg.d_model
    p_in = cfg.patch_size * cfg.patch_size * cfg.in_channels
    scales = {"patch_in": p_in ** -0.5, "pos": 0.02,
              "t_mlp1": TIME_EMBED_DIM ** -0.5, "t_mlp2": d ** -0.5,
              "attn/wq": d ** -0.5, "attn/wk": d ** -0.5,
              "attn/wv": d ** -0.5, "attn/wo": d ** -0.5,
              "mlp/w_up": d ** -0.5, "mlp/w_down": cfg.d_ff ** -0.5}
    top, blk = _leaves(cfg)
    targets = [(model, path) for path, _ in top]
    targets += [(b, path) for b in model.blocks for path, _ in blk]
    for owner, path in targets:
        param = _module_param(owner, path)
        if path == "ln_f/scale":
            param.fill_(1.0)
        elif path in scales:
            draw = torch.randn(param.shape, generator=generator)
            param.copy_(draw * scales[path])
    return model.to(resolve_device(device))


def make_denoiser(model: DiT, *, shard_axis: Optional[str] = None,
                  mesh=None, use_kernel: Optional[bool] = None):
    """``model_fn(x, t)`` for the samplers: x (M, H, W, C), t a scalar or
    per-row ``(M,)``; runs without autograd.

    With ``shard_axis`` it returns a model-parallel
    :class:`repro_torch.core.denoiser.Denoiser` instead: the sample rows
    (H of ``(M, H, W, C)``) split over that mesh dim (``in_spec =
    out_spec = (None, shard_axis)``), ``shard_fn`` is the row-sharded
    forward with the K/V all-gathered over the dim's group, and ``fn`` the
    plain forward (the reference).  ``mesh`` binds it for standalone
    calls (``srds_sample``).  ``use_kernel=False`` takes the plain
    attention (the dry run's form)."""

    @torch.no_grad()
    def model_fn(x, t):
        tb = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        return model(x, tb.expand(x.shape[0]), use_kernel=use_kernel)

    if shard_axis is None:
        return model_fn

    from repro_torch.core.denoiser import Denoiser
    from repro_torch.parallel.collectives import all_gather_dim
    patch = model.cfg.patch_size

    @torch.no_grad()
    def shard_fn(x, t, mesh):
        if x.shape[1] % patch:
            raise ValueError(
                f"local row-shard of {x.shape[1]} rows is not divisible by "
                f"patch_size={patch}; pick a {shard_axis!r} axis size with "
                f"(H / axis_size) % patch_size == 0")
        group = mesh.get_group(shard_axis)

        def kv_gather(a):         # (M, S_local, Hkv, D) -> (M, S, Hkv, D)
            return all_gather_dim(a, 1, group)

        tb = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        return model(x, tb.expand(x.shape[0]), use_kernel=use_kernel,
                     shard_rank=mesh.get_local_rank(shard_axis),
                     kv_gather=kv_gather)

    den = Denoiser(fn=model_fn, shard_fn=shard_fn,
                   in_spec=(None, shard_axis), out_spec=(None, shard_axis),
                   mesh_axes={shard_axis: 1})
    return den.bind(mesh) if mesh is not None else den


def param_count(model: DiT) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())


# --------------------------------------------------------------------------
# TimeConditioned: any backbone of the LM zoo as a denoiser
# --------------------------------------------------------------------------

class TimeConditioned(nn.Module):
    """A backbone (``backbone``: a :class:`TransformerLM`, its embedding
    and unembedding unused) with ``time_in`` ``(256, d)`` and ``eps_out``
    ``(d, d)`` in the config's dtype, JAX's ``init_time_conditioned``
    tree.  Frozen unless ``trainable``; ``backbone`` a built one (by
    default zeros)."""

    def __init__(self, cfg: ArchConfig, device="cuda",
                 trainable: bool = False, backbone=None):
        from .transformer import TransformerLM
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.backbone = backbone if backbone is not None else \
            TransformerLM(cfg, device=device, trainable=trainable)
        d, dt = cfg.d_model, _DTYPES[cfg.dtype]
        self.time_in = nn.Parameter(torch.zeros(
            (TIME_EMBED_DIM, d), dtype=dt, device=device),
            requires_grad=trainable)
        self.eps_out = nn.Parameter(torch.zeros((d, d), dtype=dt,
                                                device=device),
                                    requires_grad=trainable)

    def forward(self, x, t, *, use_kernel: Optional[bool] = None):
        return time_conditioned_forward(self.cfg, self, x, t,
                                        use_kernel=use_kernel)


@torch.no_grad()
def init_time_conditioned(cfg: ArchConfig, generator: torch.Generator,
                          device="cuda") -> TimeConditioned:
    """A fresh :class:`TimeConditioned`: the backbone by
    :func:`repro_torch.models.transformer.init_params`, ``time_in`` normal
    times 256^-0.5 and ``eps_out`` normal times 0.02 d^-0.5 (JAX's
    scales), drawn on ``device`` from ``generator``."""
    from .transformer import init_params
    model = TimeConditioned(cfg, device=device, backbone=init_params(
        cfg, generator, device=device))
    d = cfg.d_model
    model.time_in.normal_(0.0, TIME_EMBED_DIM ** -0.5, generator=generator)
    model.eps_out.normal_(0.0, 0.02 * d ** -0.5, generator=generator)
    return model


@torch.no_grad()
def load_time_conditioned(cfg: ArchConfig, tree, device="cuda"
                          ) -> TimeConditioned:
    """A :class:`TimeConditioned` holding JAX's tree (the backbone's
    leaves, ``blocks`` stacked on the layer axis, and ``time_in``,
    ``eps_out``)."""
    from .transformer import load_jax_params
    model = TimeConditioned(cfg, device=device,
                            backbone=load_jax_params(cfg, tree,
                                                     device=device))
    for name in ("time_in", "eps_out"):
        _set(getattr(model, name), np.asarray(tree[name], np.float32), name)
    return model


def time_conditioned_forward(cfg: ArchConfig, model: TimeConditioned,
                             x: torch.Tensor, t: torch.Tensor, *,
                             use_kernel: Optional[bool] = None
                             ) -> torch.Tensor:
    """x: ``(B, S, d_model)`` latents, t: ``(B,)``; the epsilon
    prediction of x's shape and dtype (the blocks run in the config's
    dtype: JAX promotes a f32 ``x`` against bf16 weights, the port casts
    it).  Every block runs bidirectionally (``causal=False``; RWKV's
    recurrence and Hymba's SSM from zero states), the time embedding
    added at every position."""
    import dataclasses
    from repro_torch.parallel.tensor_parallel import TensorParallel
    from .transformer import LOCAL, run_blocks
    cfg_nc = dataclasses.replace(cfg, causal=False)
    dt = model.time_in.dtype
    temb = sinusoidal_time_embed(t, TIME_EMBED_DIM).to(dt) @ model.time_in
    h = x.to(dt) + temb[:, None, :]
    h, _, _ = run_blocks(cfg_nc, model.backbone, h, LOCAL,
                         TensorParallel(cfg_nc, LOCAL),
                         use_kernel=use_kernel)
    ln_f = model.backbone["ln_f"]
    h = apply_norm(h, ln_f["scale"], kind=cfg.norm,
                   bias=ln_f["bias"] if "bias" in ln_f else None)
    return (h @ model.eps_out).to(x.dtype)


def make_time_conditioned_denoiser(model: TimeConditioned):
    """``model_fn(x, t)`` for the samplers: x ``(M, S, d)``, t a scalar or
    per-row ``(M,)``; runs without autograd."""

    @torch.no_grad()
    def model_fn(x, t):
        tb = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        return model(x, tb.expand(x.shape[0]))

    return model_fn
