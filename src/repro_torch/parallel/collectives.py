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

A CUDA tensor needs an NCCL group and a CPU tensor a gloo one
(:func:`check_backend`); nothing here switches backend.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.transfer import host_to_device

__all__ = ["BACKENDS", "all_gather_dim", "check_backend",
           "compressed_psum_mean", "lse_combine"]

# the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
QMAX = 127                      # int8's symmetric range


def check_backend(group, x: torch.Tensor) -> None:
    """``x`` must live where ``group``'s backend works: NCCL for a CUDA
    tensor, gloo for a CPU one."""
    want = BACKENDS.get(x.device.type)
    have = str(dist.get_backend(group))
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
    return num / den[..., None]
