"""Sharding specs on a ``DeviceMesh`` (the diffusion part of
``repro.parallel.sharding``): a spec's parts of a tensor
(:func:`slice_spec`, :func:`gather_spec`) and the serving engine's specs
(:func:`microbatch_spec`, :func:`denoiser_spec`).

A spec is a plain tuple with one entry per leading dim of a tensor, each
``None`` (replicated) or the name of a mesh dim the tensor is split over
in contiguous, rank-ordered chunks; trailing dims past the tuple are
replicated, as JAX's ``PartitionSpec`` pads.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``).

The LM rules of the JAX module (parameters, optimizer state, batches and
decode caches) are ROADMAP A10(c).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .collectives import all_gather_dim

Spec = Tuple[Optional[str], ...]

__all__ = ["Spec", "denoiser_spec", "gather_spec", "mesh_shape",
           "microbatch_spec", "slice_spec"]


def mesh_shape(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh``."""
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
