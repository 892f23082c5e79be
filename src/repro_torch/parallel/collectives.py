"""Collectives on ``torch.distributed`` process groups (counterpart of
``repro.parallel.collectives``, with the sequence gather that JAX's
``all_gather(..., axis=d, tiled=True)`` spells in one call).

:func:`all_gather_dim`
    The rank-ordered concatenation of every rank's tensor along any dim.
    ``all_gather_into_tensor`` joins on dim 0 only, so a gather along dim
    ``d > 0`` moves ``d`` to the front, gathers into an ``(m * n_d, ...)``
    buffer and moves it back: one collective and one copy of the gathered
    tensor (``all_gather_dim.calls`` counts the collectives).
:func:`compressed_psum_mean`
    int8-quantized gradient mean with error feedback: each rank quantizes
    ``grad + carry`` against the largest per-tensor (or per-group) scale
    of the group (one ``all_reduce`` MAX over every scale), the int
    payloads are summed exactly in int32 (one ``all_reduce`` SUM over all
    tensors joined), and the quantization residual stays in the carry.
:func:`lse_combine`
    The flash-decoding merge of attention partials computed over disjoint
    KV-sequence slices, by their logsumexps.

The tensor- and sequence-parallel operators of the language models
(``autograd.Function``s; JAX has none, XLA inserts them): each is the
identity, issuing nothing, when ``group`` is None (a model without a
mesh), and issues its collective at every world size otherwise (at one
rank it returns its input's bits):

:func:`copy_to`      identity forward, all-reduce backward: where a
                     replicated activation enters a rank's own columns.
:func:`reduce_from`  all-reduce forward, identity backward: where the
                     ranks' partial sums leave for replicated work.
:func:`gather_seq`   all-gather forward, reduce-scatter backward (the
                     sequence gather before a mixer under ``sp``).
:func:`scatter_seq`  reduce-scatter forward, all-gather backward (a row
                     shard's output back onto the sequence shards).
:func:`gather_split` all-gather forward, this rank's slice backward (a
                     channel shard joined for replicated work).
:func:`split`        this rank's slice forward, all-gather backward.
:func:`joined`       several tensors through one collective each way:
                     ``reduce_from``'s or ``scatter_seq``'s, or an
                     all-reduce both ways (partial sums each rank's own
                     channels read: hymba's ``dt``, ``B``, ``C``).
:func:`heads_to_seq` one all-to-all, heads split to sequence split (the
                     flash-decoding cache from a prefill; no gradient).
:func:`mean_share`   the mean over the batch groups forward, this rank's
                     share (``g / n``) backward: a per-rank loss term
                     whose JAX counterpart is a ``pmean``.
:func:`all_to_all`   dim 0's equal chunks exchanged (chunk ``i`` to rank
                     ``i``, received in rank order: JAX's ``all_to_all(x,
                     axis, 0, 0, tiled=True)``); the backward is the
                     reverse exchange (the MoE dispatch over ``data``).

:data:`CALLS` counts every collective issued, by kind.

A CUDA tensor needs an NCCL group and a CPU tensor a gloo one
(:func:`check_backend`; the dry run's ``fake`` group takes either);
nothing here switches backend.
"""
from __future__ import annotations

import collections
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.transfer import host_to_device

__all__ = ["BACKENDS", "CALLS", "all_gather_dim", "all_to_all",
           "check_backend", "compressed_psum_mean", "copy_to", "gather_seq",
           "gather_split", "heads_to_seq", "joined", "lse_combine",
           "mean_share", "reduce_from", "reset_calls", "scatter_seq",
           "split"]

# the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
QMAX = 127                      # int8's symmetric range
# collectives issued, by kind ("all_reduce", "all_gather",
# "reduce_scatter", "all_to_all"), forward and backward
CALLS: collections.Counter = collections.Counter()


def reset_calls() -> None:
    CALLS.clear()


def check_backend(group, x: torch.Tensor) -> None:
    """``x`` must live where ``group``'s backend works: NCCL for a CUDA
    tensor, gloo for a CPU one; a ``fake`` group (the dry run's,
    :mod:`repro_torch.launch.dryrun`) takes either."""
    want = BACKENDS.get(x.device.type)
    have = str(dist.get_backend(group))
    if have == "fake":
        return
    if want is None or (have != want
                        and f"{x.device.type}:{want}" not in have):
        raise ValueError(f"a {x.device.type} tensor needs a {want} process "
                         f"group; this group runs {have}")


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` joined in rank order along ``dim``
    (JAX's ``all_gather(t, axis, axis=dim, tiled=True)``).  No gradient
    flows through it."""
    check_backend(group, t)
    m = dist.get_world_size(group)
    front = t.movedim(dim, 0).contiguous()
    out = front.new_empty((m * front.shape[0],) + tuple(front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    all_gather_dim.calls += 1
    CALLS["all_gather"] += 1
    return out.movedim(0, dim)


all_gather_dim.calls = 0


def _scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor quantum: ``max |x| / 127``, at least 1e-12 / 127."""
    return torch.clamp(x.abs().amax(), min=1e-12) / float(QMAX)


def compressed_psum_mean(grads: Mapping[str, torch.Tensor], group,
                         ef_carry: Mapping[str, torch.Tensor], *,
                         scale_groups: Optional[Mapping[str, str]] = None
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Mean over ``group`` of a dict of gradients, sent as int8 values
    with error feedback: ``(mean f32, new carry f32)``, keyed as
    ``grads``.

    Each rank adds its carry, every tensor's scale is the group's largest
    (``max |g + carry| / 127``), the values are rounded to int8 against
    it, summed exactly in int32 and dequantized as ``sum * scale / n``;
    the new carry is ``g + carry - q * scale``, so the long-run gradient
    is kept whole.  ``scale_groups`` maps names to keys: tensors of one
    key share one scale, their largest (JAX's leaf is a block parameter
    stacked over the layers, the port's a layer's own tensor); without
    it every tensor is a group of its own.  Two collectives whatever the
    number of tensors."""
    names = list(grads)
    if not names:
        return {}, {}
    gf = [grads[k].float() + ef_carry[k] for k in names]
    check_backend(group, gf[0])
    keys = names if scale_groups is None else [scale_groups[k]
                                               for k in names]
    index = {k: i for i, k in enumerate(dict.fromkeys(keys))}
    ids = host_to_device(np.asarray([index[k] for k in keys], np.int64),
                         gf[0].device)
    scales = torch.stack([_scale(x) for x in gf])
    shared = scales.new_zeros(len(index)).scatter_reduce(0, ids, scales,
                                                         "amax")
    dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
    scales = shared[ids]
    q = [torch.clamp(torch.round(x / s), -QMAX, QMAX).to(torch.int8)
         for x, s in zip(gf, scales)]
    carry = [x - qi.float() * s for x, qi, s in zip(gf, q, scales)]
    total = torch.cat([qi.reshape(-1).to(torch.int32) for qi in q])
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    mean, off = {}, 0
    for k, x, s in zip(names, gf, scales):
        part = total[off:off + x.numel()].reshape(x.shape)
        mean[k] = part.float() * s / n
        off += x.numel()
    return mean, dict(zip(names, carry))


def lse_combine(o_parts: torch.Tensor, lse_parts: torch.Tensor,
                group) -> torch.Tensor:
    """Combine per-rank attention partials over KV-sequence shards:
    ``o_parts (..., D)`` normalized by the local softmax, ``lse_parts
    (...)`` the local logsumexps; the result is normalized by the global
    one."""
    check_backend(group, o_parts)
    lse_max = lse_parts.clone()
    dist.all_reduce(lse_max, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse_parts - lse_max)
    num = o_parts * w[..., None]
    dist.all_reduce(num, group=group)
    den = w.clone()
    dist.all_reduce(den, group=group)
    CALLS["all_reduce"] += 3
    return num / den[..., None]


# --------------------------------------------------------------------------
# tensor- and sequence-parallel operators
# --------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    check_backend(group, x)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    CALLS["all_reduce"] += 1
    return y


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's ``1/m`` of ``dim`` of the sum over ``group``."""
    check_backend(group, x)
    m = dist.get_world_size(group)
    if x.shape[dim] % m:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split over {m} ranks")
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // m,) + tuple(front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    CALLS["reduce_scatter"] += 1
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    m, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % m:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split over {m} ranks")
    n = x.shape[dim] // m
    return x.narrow(dim, r * n, n)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    check_backend(group, x)
    m = dist.get_world_size(group)
    if x.shape[0] % m:
        raise ValueError(f"dim 0 of shape {tuple(x.shape)} does not split "
                         f"over {m} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    CALLS["all_to_all"] += 1
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        # chunk i came from rank i: its gradient goes back there
        return _all_to_all(g, ctx.group), None


class _MeanShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.detach().clone()
        n = 1
        for g in groups:
            check_backend(g, y)
            dist.all_reduce(y, group=g)
            CALLS["all_reduce"] += 1
            n *= dist.get_world_size(g)
        ctx.n = n
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather_dim(g.contiguous(), ctx.dim,
                               ctx.group).contiguous(), None, None)


class _Joined(torch.autograd.Function):
    """Tensors joined on their last dim through one collective each way;
    every part comes out contiguous, forward and backward."""

    @staticmethod
    def forward(ctx, fwd, bwd, *parts):
        ctx.bwd, ctx.sizes = bwd, [p.shape[-1] for p in parts]
        y = fwd(torch.cat(parts, dim=-1))
        return tuple(t.contiguous() for t in y.split(ctx.sizes, dim=-1))

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.bwd(torch.cat(grads, dim=-1))
        return (None, None) + tuple(t.contiguous()
                                    for t in g.split(ctx.sizes, dim=-1))


def joined(parts, kind: str, group):
    """``parts`` (same leading dims) through one collective as if each
    went through its own: ``kind`` ``"reduce_both"`` (the sum over
    ``group`` forward and backward), ``"reduce_from"``
    (:func:`reduce_from`) or ``"scatter_seq"`` (:func:`scatter_seq` along
    dim 1)."""
    if group is None:
        return tuple(parts)
    ar = lambda t: _all_reduce(t, group)  # noqa: E731
    fns = {"reduce_both": (ar, ar),
           "reduce_from": (ar, lambda t: t),
           "scatter_seq": (lambda t: _reduce_scatter(t, 1, group),
                           lambda t: all_gather_dim(t, 1, group))}
    return _Joined.apply(*fns[kind], *parts)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 cut into ``m`` equal chunks, chunk ``i`` sent to rank ``i``;
    the result holds rank ``j``'s chunk for this rank at chunk ``j``.  The
    gradient takes the reverse exchange (the same call)."""
    return x if group is None else _AllToAll.apply(x, group)


def mean_share(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over every group of ``groups`` (JAX's ``pmean``
    over the batch axes); the gradient is ``1/n`` of the upstream, this
    rank's share, so the ranks' gradients add up to the mean's."""
    return _MeanShare.apply(x, tuple(groups)) if groups else x


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; the gradient passes as it is."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' parts joined along ``dim``; the gradient is summed over
    ``group`` and split along ``dim`` (reduce-scatter)."""
    return x if group is None else _GatherSeq.apply(x, dim, group)


def scatter_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum over ``group``; the
    gradient is gathered."""
    return x if group is None else _ScatterSeq.apply(x, dim, group)


def gather_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' parts joined along ``dim``; the gradient (the same on
    every rank) is cut back to this rank's part."""
    return x if group is None else _GatherSplit.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part along ``dim`` of a replicated tensor; the gradient
    is gathered."""
    return x if group is None else _Split.apply(x, dim, group)


def heads_to_seq(x: torch.Tensor, seq_dim: int, head_dim: int,
                 group) -> torch.Tensor:
    """``x`` split over ``group`` on ``head_dim`` (each rank its heads,
    the whole sequence) to split on ``seq_dim`` (each rank its ``1/m``
    of the sequence, every head): one ``all_to_all``.  Heads join in rank
    order, so rank ``i``'s heads land at ``[i * H_l, (i + 1) * H_l)``."""
    if group is None:
        return x
    check_backend(group, x)
    m = dist.get_world_size(group)
    s = x.shape[seq_dim]
    if s % m:
        raise ValueError(f"a sequence of {s} does not split over {m} ranks")
    if not 0 <= seq_dim < head_dim:
        raise ValueError("heads_to_seq wants 0 <= seq_dim < head_dim")
    # (m, ..., S/m, ..., H_l, ...): chunk i goes to rank i
    send = x.unflatten(seq_dim, (m, s // m)).movedim(seq_dim, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    CALLS["all_to_all"] += 1
    # recv[i] holds rank i's heads of this rank's chunk: move i next to
    # the heads and join them
    return recv.movedim(0, head_dim).flatten(head_dim, head_dim + 1)
