"""The model-eval seam, sharding-aware (counterpart of
``repro.core.denoiser``).

Every sampler and the serving engine evaluate the backbone through a
:class:`Denoiser`: ``den(x, t)`` with ``x`` of shape ``(M, ...)`` and
per-row times ``t (M,)`` (SRDS folds its blocks into the batch, so rows
sit at different times).  Besides ``fn``, the single-device math and the
reference, a Denoiser carries its parallelism contract:

* ``in_spec`` / ``out_spec``: tuples over the sample layout ``(M,
  *sample_shape)``, one entry per leading dim, ``None`` or the name of a
  mesh dim that dim is split over in contiguous rank-ordered chunks
  (the DiT's patch rows over ``model``: ``(None, "model")``);
* ``mesh_axes``: the dims it needs of a mesh, ``{name: min_size}``;
* ``shard_fn(x_shard, t, mesh)``: the per-shard body, which may run
  collectives on the groups of ``mesh``'s dims (a torch mesh dim's name
  means nothing without its mesh, so every mode hands it over);
* ``mesh``: a bound ``DeviceMesh`` for standalone calls.

A plain ``model_fn(x, t)`` adapts through :func:`as_denoiser`, and
``Denoiser(fn=f)`` with the defaults is exactly ``f``.  SPMD as in
:mod:`repro_torch.core.pipelined`: one process a rank, every rank calling
with the same inputs.  A model-parallel denoiser composes in three modes:

1. **standalone** (``den(x, t)`` on a bound mesh) and
2. **inner** (``den.inner_eval(mesh)``, for the sharded and wavefront
   drivers, whose operands are whole on every rank of the model dims) are
   one glue: slice this rank's part per ``in_spec`` (its place from
   ``mesh.get_local_rank(name)``), run ``shard_fn``, all-gather per
   ``out_spec`` (one ``all_gather_dim`` a split dim an eval; the spec
   helpers live in :mod:`repro_torch.parallel.sharding`);
3. **shard** (``den.shard_eval(mesh)``): ``shard_fn`` alone, for a caller
   that has split the operand already (the serving engine's fine solves,
   per :func:`repro_torch.parallel.sharding.denoiser_spec`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

from repro_torch.parallel.sharding import (Spec, gather_spec, mesh_shape,
                                          slice_spec)

__all__ = ["Denoiser", "as_denoiser", "check_driver_dims"]


@dataclasses.dataclass(frozen=True)
class Denoiser:
    """A model-eval callable carrying its sharding contract (see the
    module docstring)."""

    fn: Callable                           # (x (M, ...), t (M,)) -> eps
    shard_fn: Optional[Callable] = None    # (x_shard, t, mesh) -> eps shard
    in_spec: Spec = ()
    out_spec: Spec = ()
    mesh_axes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    mesh: object = None                    # a DeviceMesh for standalone calls

    def __post_init__(self):
        if self.mesh_axes and self.shard_fn is None:
            raise ValueError("a Denoiser with mesh_axes needs a shard_fn")
        if self.mesh is not None:
            self.check_mesh(self.mesh)

    @property
    def is_model_parallel(self) -> bool:
        return bool(self.mesh_axes)

    def check_mesh(self, mesh) -> None:
        """A clear ``ValueError`` unless ``mesh`` has every required dim
        at its minimum size."""
        shape = mesh_shape(mesh)
        for name, min_size in self.mesh_axes.items():
            if name not in shape:
                raise ValueError(
                    f"denoiser requires mesh axis {name!r} but mesh has "
                    f"axes {tuple(shape)}")
            if shape[name] < min_size:
                raise ValueError(
                    f"denoiser requires mesh axis {name!r} of size >= "
                    f"{min_size}, got {shape[name]}")

    def bind(self, mesh) -> "Denoiser":
        """A copy bound to ``mesh`` (validated) for standalone calls."""
        return dataclasses.replace(self, mesh=mesh)

    def _mesh(self, mesh):
        mesh = self.mesh if mesh is None else mesh
        if mesh is None:
            raise ValueError(
                "model-parallel Denoiser called without a bound mesh; use "
                ".bind(mesh), or pass the driver's mesh to "
                ".inner_eval(mesh)/.shard_eval(mesh)")
        return mesh

    def _glue(self, mesh) -> Callable:
        shard_fn, in_spec, out_spec = self.shard_fn, self.in_spec, \
            self.out_spec

        def eval_fn(x, t):
            return gather_spec(shard_fn(slice_spec(x, in_spec, mesh), t,
                                        mesh), out_spec, mesh)

        return eval_fn

    def __call__(self, x, t):
        """Global eval: ``fn`` for a plain denoiser; a model-parallel one
        slices, runs ``shard_fn`` and gathers over its bound mesh."""
        if not self.is_model_parallel:
            return self.fn(x, t)
        return self._glue(self._mesh(None))(x, t)

    def inner_eval(self, mesh=None) -> Callable:
        """The eval for a driver whose operands are whole on every rank of
        this denoiser's dims of ``mesh`` (default: the bound one): the
        standalone glue; ``fn`` itself for a plain denoiser."""
        if not self.is_model_parallel:
            return self.fn
        mesh = self._mesh(mesh)
        self.check_mesh(mesh)
        return self._glue(mesh)

    def shard_eval(self, mesh=None) -> Callable:
        """The eval for a caller that split the operand per ``in_spec``
        already: ``shard_fn`` on ``mesh`` (default: the bound one); ``fn``
        for a plain denoiser."""
        if not self.is_model_parallel:
            return self.fn
        mesh = self._mesh(mesh)
        self.check_mesh(mesh)
        shard_fn = self.shard_fn

        def eval_fn(x, t):
            return shard_fn(x, t, mesh)

        return eval_fn


def check_driver_dims(mesh, den: Denoiser, *axes) -> None:
    """``den``'s requirement of ``mesh``, and a driver's dims (``axes``,
    ``None`` for an unused one) distinct from each other and from the
    denoiser's (time, data and model of ``make_srds_mesh``)."""
    den.check_mesh(mesh)
    names = [a for a in axes if a is not None] + list(den.mesh_axes)
    if len(set(names)) != len(names):
        raise ValueError(f"the driver's and the denoiser's mesh dims must "
                         f"be distinct; got {names}")


def as_denoiser(fn) -> Denoiser:
    """Adapt a plain ``model_fn(x, t)`` (identity for a Denoiser)."""
    return fn if isinstance(fn, Denoiser) else Denoiser(fn=fn)
