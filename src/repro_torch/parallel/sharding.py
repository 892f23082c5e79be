"""Sharding specs on a ``DeviceMesh`` (counterpart of
``repro.parallel.sharding``): a spec's parts of a tensor
(:func:`slice_spec`, :func:`gather_spec`, and for any leaf
:func:`local_part` / :func:`full_tensor`), the serving engine's specs
(:func:`microbatch_spec`, :func:`denoiser_spec`) and the language models'
rule tables (:func:`param_shardings` with ``fsdp=``/``zero1=``,
:func:`fsdp_dims`,
:func:`opt_state_shardings`, :func:`batch_shardings`,
:func:`cache_shardings`).

A spec is a plain tuple with one entry per leading dim of a tensor, each
``None`` (replicated), the name of a mesh dim the tensor is split over in
contiguous, rank-ordered chunks, or a tuple of names (split over their
product, row-major, as JAX's ``P(("pod", "data"))``); trailing dims past
the tuple are replicated, as JAX's ``PartitionSpec`` pads.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``); the
rule tables also take a plain ``{dim name: size}`` mapping, so the specs
of a 256-rank mesh can be read on one process.

The port's LM leaves are per layer (``blocks.3.attn.wq``), with no
stacked layer axis: JAX's rules wrap a ``blocks`` leaf's spec in a
leading ``None`` for that axis, and the port's specs are JAX's with that
entry dropped.  One leaf is not cut as its spec reads: hymba's ``w_in``
is ``[z | xs]`` on its columns, and a rank holds its ``1/m`` of each half
(:data:`HALVES`), not a contiguous ``1/m`` of the whole (which would give
rank 0 all of ``z``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .collectives import all_gather_dim

Spec = Tuple[Optional[str], ...]

__all__ = ["HALVES", "Spec", "batch_shardings", "cache_shardings",
           "denoiser_spec", "fsdp_dims", "full_tensor", "gather_spec",
           "local_part",
           "mesh_shape", "microbatch_spec", "opt_state_shardings",
           "param_shardings", "slice_spec"]

# leaves whose sharded dim is two halves side by side, each split
HALVES = ("w_in",)


def mesh_shape(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` (or of such a mapping)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names or (), mesh.mesh.shape))


def _spec_axes(spec: Spec):
    """(dim, name) pairs for every split dim of a spec."""
    out = []
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        if not isinstance(entry, str):
            raise ValueError(
                f"Denoiser specs shard each dim over at most one axis; got "
                f"{entry!r} at dim {dim}")
        out.append((dim, entry))
    return out


def slice_spec(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's ``spec``-part of ``x``, whole on every rank (a view)."""
    sizes = mesh_shape(mesh)
    for dim, name in _spec_axes(spec):
        n = sizes[name]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not "
                             f"divisible by axis {name!r} (size {n})")
        chunk = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(name) * chunk, chunk)
    return x


def gather_spec(y: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``spec``-part: one gather a
    split dim."""
    for dim, name in _spec_axes(spec):
        y = all_gather_dim(y, dim, mesh.get_group(name))
    return y


def _check_axes_bound(mesh, spec_axes) -> None:
    """A clear ``ValueError`` for a dim name the mesh does not have."""
    if mesh is None:
        return
    known = tuple(mesh.mesh_dim_names or ())
    for ax in spec_axes:
        if ax is not None and ax not in known:
            raise ValueError(f"axis {ax!r} is not bound by the mesh (axes: "
                             f"{known})")


def microbatch_spec(data_axis: str, *, mesh=None) -> Spec:
    """The spec of a serving micro-batch's ``(B, K, *sample)`` heads
    tensor with its K lanes split over ``data_axis``: ``(None,
    data_axis)``.  Lanes are independent, so the split needs no
    collective; the caller checks ``K % size == 0``.  ``mesh`` validates
    that the dim exists."""
    _check_axes_bound(mesh, (data_axis,))
    return (None, data_axis)


def denoiser_spec(data_axis: Optional[str], denoiser=None, *,
                  mesh=None) -> Spec:
    """The heads tensor's spec with a denoiser's own sample dims composed
    in: ``(None, data_axis, *in_spec[1:])``.

    A model-parallel :class:`repro_torch.core.denoiser.Denoiser`'s
    ``in_spec`` is over the sample layout ``(K, *sample_shape)``; its K
    entry (replicated: the engine owns that dim through ``data_axis``) is
    dropped and the rest shift past the heads tensor's K dim.  Inside the
    split the denoiser runs its ``shard_eval``.  Without a model-parallel
    denoiser this is :func:`microbatch_spec`'s.  ``mesh`` validates every
    named dim and the denoiser's mesh requirement."""
    from repro_torch.core.denoiser import as_denoiser
    den = as_denoiser(denoiser) if denoiser is not None else None
    sample_axes: Spec = ()
    if den is not None and den.is_model_parallel:
        in_spec = tuple(den.in_spec)
        if in_spec and in_spec[0] is not None:
            raise ValueError(
                "denoiser in_spec shards the sample-batch dim "
                f"({in_spec[0]!r}); the serving engine owns that dim via "
                "data_axis")
        if mesh is not None:
            den.check_mesh(mesh)
        sample_axes = in_spec[1:]
    _check_axes_bound(mesh, (data_axis,) + tuple(sample_axes))
    return (None, data_axis) + tuple(sample_axes)


# --------------------------------------------------------------------------
# the language models' rules
# --------------------------------------------------------------------------

def _param_spec(cfg, keys, shape, *, mp_axis: Optional[str],
                data_axis: Optional[str], fsdp: bool,
                kv_shardable: bool) -> Spec:
    """JAX's ``_param_spec`` on the port's per-layer leaves: ``keys`` are
    the name's parts with the layer index dropped (``("blocks", "attn",
    "wq")``); the spec has no stacked-axis entry."""
    name = keys[-1]
    fa = data_axis if fsdp else None

    def rep():
        return (None,) * len(shape)

    if name == "table":
        return (mp_axis, None)
    if keys[-2:] == ("unembed", "w"):
        return (fa, mp_axis)
    if name in ("time_in", "eps_out"):
        return (None, None)
    if "moe" in keys:               # experts over data, their width over model
        if name in ("w_up", "w_gate"):
            return (data_axis, None, mp_axis)
        if name == "w_down":
            return (data_axis, mp_axis, None)
        return rep()
    if "tmix" in keys:
        if name in ("wr", "wk", "wv", "wg"):
            return (fa, mp_axis)
        if name == "wo":
            return (mp_axis, fa)
        return rep()
    if "cmix" in keys:
        if name in ("wk_c", "wr_c"):
            return (fa, mp_axis)
        if name == "wv_c":
            return (mp_axis, fa)
        return rep()
    if name == "wq":
        return (fa, mp_axis)
    if name in ("wk", "wv"):
        return (fa, mp_axis if kv_shardable else None)
    if name == "wo":
        return (mp_axis, fa)
    if name == "bq":
        return (mp_axis,)
    if name in ("bk", "bv"):
        return (mp_axis if kv_shardable else None,)
    if name in ("w_up", "w_gate"):
        return (fa, mp_axis)
    if name == "w_down":
        return (mp_axis, fa)
    if name == "w_in":
        return (fa, mp_axis)
    if name in ("w_dt", "w_B", "w_C", "A_log"):
        return (mp_axis, None)
    if name == "D":
        return (mp_axis,)
    if name == "w_out":
        return (mp_axis, fa)
    return rep()


def _axes_size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def leaf_keys(name: str) -> Tuple[str, ...]:
    """A parameter's name split, with a block's layer index dropped:
    ``blocks.3.attn.wq`` -> ``("blocks", "attn", "wq")``."""
    return tuple(k for k in name.split(".") if not k.isdigit())


def kv_shardable(cfg, parallel) -> bool:
    """JAX's rule: K/V heads split over ``model`` only when the padded
    count divides the model-parallel degree's."""
    mp = parallel.model_parallel
    _, hkv = cfg.padded_heads(mp)
    return mp > 1 and hkv % mp == 0


def param_shardings(cfg, mesh, params, parallel, *, fsdp: bool = False,
                    zero1: bool = False) -> Dict[str, Spec]:
    """``{name: spec}`` for ``params`` (a mapping from the port's
    parameter names to tensors or shapes, global shapes: a model built on
    the meta device reads them without memory), JAX's
    ``param_shardings``: tensor parallelism on ``model`` (q heads, K/V
    heads where :func:`kv_shardable`, the MLP's and the experts' ``d_ff``,
    RWKV's and the SSM's channels, the vocabulary), expert parallelism on
    ``data`` (the MoE experts; the router replicated), ``data`` on the
    large dense weights' other dim with ``fsdp`` or ``zero1``, and an axis
    whose size does not divide its dim dropped."""
    mp, da = parallel.model_axis, parallel.data_axis
    kv = kv_shardable(cfg, parallel)
    sizes = mesh_shape(mesh)
    out = {}
    for name, leaf in params.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        spec = _param_spec(cfg, leaf_keys(name), shape, mp_axis=mp,
                           data_axis=da, fsdp=fsdp or zero1,
                           kv_shardable=kv)
        out[name] = tuple(
            ax if ax is not None and dim % max(sizes[ax], 1) == 0 else None
            for dim, ax in zip(shape, spec + (None,) * len(shape)))
    return out


def fsdp_dims(cfg, mesh, params, parallel) -> Dict[str, int]:
    """``{name: dim}`` of the leaves FSDP splits: those whose
    ``param_shardings(..., fsdp=True)`` spec puts ``data`` on a dim the
    plain spec leaves whole."""
    da = parallel.data_axis
    plain = param_shardings(cfg, mesh, params, parallel)
    out = {}
    for name, spec in param_shardings(cfg, mesh, params, parallel,
                                      fsdp=True).items():
        for dim, (a, b) in enumerate(zip(spec, plain[name])):
            if a == da and b != da:
                out[name] = dim
    return out


def opt_state_shardings(cfg, mesh, opt_state, parallel) -> dict:
    """ZeRO-1: the moments take the parameter rules with ``data`` on
    (``zero1=True``); the step is replicated."""
    return {"m": param_shardings(cfg, mesh, opt_state["m"], parallel,
                                 zero1=True),
            "v": param_shardings(cfg, mesh, opt_state["v"], parallel,
                                 zero1=True),
            "step": ()}


def batch_shardings(mesh, batch, batch_axes) -> Dict[str, Spec]:
    """Every batch leaf split on dim 0 over ``batch_axes`` (a tuple of
    mesh dims) where that size divides it, else replicated."""
    n = _axes_size(mesh, batch_axes)
    return {k: ((batch_axes if v.shape[0] % n == 0 else None),)
            + (None,) * (len(v.shape) - 1) for k, v in batch.items()}


def cache_shardings(cfg, mesh, cache, parallel, *,
                    kv_seq_shard: bool = True) -> Dict[str, Spec]:
    """The decode cache's layout (flash-decoding), JAX's
    ``cache_shardings`` on a cache's named fields (``{"k": ..., "v":
    ...}``, an ``RWKVState``'s or a ``HymbaCache``'s ``_asdict()``, each
    stacked on its layer axis): batch over the batch axes; dense K/V
    ``(L, B, S, Hkv, D)`` and hymba's ring along their sequence or slots
    over ``model`` (with ``kv_seq_shard``), RWKV's WKV states
    ``(L, B, H, dk, dk)`` on heads, SSM states ``(L, B, din, n)`` on
    ``din``, shift states ``(L, B, d)`` on ``d``; ``ring_pos`` ``(L, W)``
    replicated.  An axis that does not divide its dim is dropped."""
    ba, mp = parallel.batch_axes, parallel.model_axis
    sizes = mesh_shape(mesh)
    m = sizes.get(mp, 1)
    out = {}
    for name, leaf in cache.items():
        shape = tuple(leaf.shape)
        nd = len(shape)
        bsz = shape[1] if nd >= 2 else 1
        b_ax = ba if bsz % _axes_size(mesh, ba) == 0 else None
        if nd == 5:
            seq = mp if kv_seq_shard and shape[2] % m == 0 else None
            out[name] = (None, b_ax, seq, None, None)
        elif nd == 4:
            out[name] = (None, b_ax, mp if shape[2] % m == 0 else None, None)
        elif nd == 3:
            out[name] = (None, b_ax, mp if shape[2] % m == 0 else None)
        else:
            out[name] = (None,) * nd
    return out


def _entries(spec: Spec):
    """(dim, (names...)) for every split dim of a spec."""
    out = []
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        out.append((dim, (entry,) if isinstance(entry, str)
                    else tuple(entry)))
    return out


def _coord(mesh, names) -> Tuple[int, int]:
    """(this rank's index, count) over the product of ``names``,
    row-major."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in names:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def local_part(name: str, full: torch.Tensor, spec: Spec,
               mesh) -> torch.Tensor:
    """This rank's part of the whole tensor ``full`` by ``spec`` (a view
    where it can be).  ``name`` decides the :data:`HALVES` layout."""
    halves = leaf_keys(name)[-1] in HALVES
    x = full
    for dim, names in _entries(spec):
        idx, n = _coord(mesh, names)
        if halves and dim == len(full.shape) - 1:
            a, b = x.chunk(2, dim=dim)
            c = a.shape[dim] // n
            x = torch.cat([a.narrow(dim, idx * c, c),
                           b.narrow(dim, idx * c, c)], dim=dim)
            continue
        if x.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(x.shape)} does "
                             f"not split over {names} ({n})")
        c = x.shape[dim] // n
        x = x.narrow(dim, idx * c, c)
    return x


def full_tensor(name: str, part: torch.Tensor, spec: Spec,
                mesh) -> torch.Tensor:
    """The whole tensor from every rank's :func:`local_part` (one gather
    per mesh dim of the spec; every rank gets it)."""
    halves = leaf_keys(name)[-1] in HALVES
    y = part.detach()
    for dim, names in reversed(_entries(spec)):
        for a in reversed(names):
            group = mesh.get_group(a)
            if halves and dim == len(part.shape) - 1:
                m = mesh_shape(mesh)[a]
                h = y.shape[dim] // 2
                # every rank's (z_r | xs_r): gather, then z parts first
                g = all_gather_dim(y.contiguous(), dim, group)
                parts = g.chunk(m, dim=dim)
                y = torch.cat([p.narrow(dim, 0, h) for p in parts]
                              + [p.narrow(dim, h, h) for p in parts],
                              dim=dim)
            else:
                y = all_gather_dim(y.contiguous(), dim, group)
    return y
