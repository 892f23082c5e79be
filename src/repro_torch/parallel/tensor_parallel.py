"""One rank's view of the ``model`` dim of a language model's mesh: the
collectives a layer issues where GSPMD would insert them, and the rank's
share of the heads, channels and vocabulary.

:class:`TensorParallel` is built from a
:class:`repro_torch.models.transformer.ParallelCtx`.  Without a mesh it is
the single process: one rank, no group, and every method the identity
(the layers then run the plain path's operations).  With a mesh it holds
the ``model`` group and issues its collectives at every world size.

Where activations cross between replicated and per-rank work (Megatron's
``f`` and ``g``; :mod:`repro_torch.parallel.collectives`):

* :meth:`enter`: a replicated (or, under ``sp``, sequence-split) input
  before a layer's column shards: identity forward, gradient summed over
  ``model`` (under ``sp``: the sequence all-gathered, the gradient
  reduce-scattered);
* :meth:`leave`: a row shard's partial output: summed over ``model``
  (under ``sp``: reduce-scattered onto the sequence shards).

GQA pairing (``kv``).  Rank ``r`` holds q heads ``[r * hq_l, (r + 1) *
hq_l)``; q head ``j`` reads KV head ``j // group``.  Where the K/V heads
are split (JAX's ``kv_shardable``) the rank's KV heads are its own block.
Where they are replicated the rank computes every KV head and keeps
``kv_start`` .. ``kv_start + kv_heads`` when its q heads cover whole
groups or sit inside one (``kv_index`` None); otherwise (hymba's 26/13
heads at ``model`` 2: rank 1 starts mid-group) it repeats K/V to its q
heads by ``kv_index``, group 1, and autograd sums dK and dV back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import collectives as coll
from .sharding import kv_shardable, mesh_shape


@dataclasses.dataclass(frozen=True)
class HeadShare:
    hq: int                      # padded q heads, all ranks
    hkv: int                     # padded KV heads, all ranks
    hq_l: int                    # this rank's q heads
    kv_split: bool               # K/V heads split over model
    kv_start: int                # first KV head this rank's q heads read
    kv_heads: int                # KV heads handed to the kernel
    kv_index: Optional[tuple]    # KV head of each local q head (repeat)


class TensorParallel:
    def __init__(self, cfg, parallel, *, sp: Optional[bool] = None):
        mesh = parallel.mesh
        self.cfg, self.parallel = cfg, parallel
        axis = parallel.model_axis
        if mesh is not None and axis is not None:
            self.group = mesh.get_group(axis)
            self.m = mesh_shape(mesh)[axis]
            self.r = mesh.get_local_rank(axis)
            if self.m != parallel.model_parallel:
                raise ValueError(f"the mesh's {axis!r} dim has {self.m} "
                                 f"ranks; ParallelCtx.model_parallel is "
                                 f"{parallel.model_parallel}")
        else:
            self.group, self.m, self.r = None, 1, 0
        self.sp = bool(parallel.sp if sp is None else sp) \
            and self.group is not None

    def without_sp(self) -> "TensorParallel":
        """The same rank for one-token work (decode), where the sequence
        is not split."""
        return TensorParallel(self.cfg, self.parallel, sp=False)

    # ---- shares ------------------------------------------------------------

    def share(self, n: int, what: str) -> int:
        if n % self.m:
            raise ValueError(f"{self.cfg.name}: {what} {n} does not split "
                             f"over {self.m} model ranks")
        return n // self.m

    def heads(self) -> HeadShare:
        hq, hkv = self.cfg.padded_heads(self.parallel.model_parallel)
        hq_l = self.share(hq, "q heads")
        g = hq // hkv
        q0 = self.r * hq_l
        split = self.group is not None and kv_shardable(self.cfg,
                                                        self.parallel)
        if split:
            n = self.share(hkv, "KV heads")
            return HeadShare(hq, hkv, hq_l, True, self.r * n, n, None)
        if hq_l % g == 0:
            return HeadShare(hq, hkv, hq_l, False, q0 // g, hq_l // g, None)
        if g % hq_l == 0:
            return HeadShare(hq, hkv, hq_l, False, q0 // g, 1, None)
        idx = tuple((q0 + j) // g for j in range(hq_l))
        return HeadShare(hq, hkv, hq_l, False, idx[0], hq_l, idx)

    # ---- activations -------------------------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.sp:
            return coll.gather_seq(x, 1, self.group)
        return coll.copy_to(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        if self.sp:
            return coll.scatter_seq(x, 1, self.group)
        return coll.reduce_from(x, self.group)

    def reduce_both(self, *parts: torch.Tensor):
        """Partial sums each rank's own channels read: summed over
        ``model`` both ways, in one collective."""
        return coll.joined(parts, "reduce_both", self.group)

    def leave_parts(self, *parts: torch.Tensor):
        """:meth:`leave` for several row-shard outputs in one
        collective."""
        return coll.joined(parts, "scatter_seq" if self.sp else
                           "reduce_from", self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's part joined along ``dim`` (no gradient)."""
        if self.group is None:
            return x
        return coll.all_gather_dim(x, dim, self.group)

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``1/m`` of ``dim`` (a view)."""
        if self.m == 1:
            return x
        n = self.share(x.shape[dim], f"dim {dim}")
        return x.narrow(dim, self.r * n, n)
