"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): top-k
routing, grouped expert FFNs, and expert parallelism over the ``data``
dim of a mesh.

Two paths on one parameter layout (``router`` ``(d, E)`` in f32;
``w_up``, ``w_gate`` (SwiGLU only) ``(E, d, f)`` and ``w_down``
``(E, f, d)`` in the config's dtype):

:func:`moe_local`
    one process: route, stable-sort the assignments by expert, the
    grouped FFN, unsort, combine with the routing weights.
:func:`moe_ep_local`
    one rank of an expert-parallel mesh: the rank holds ``E / D`` experts
    (``D`` the ``data`` dim) and, with a ``model`` dim, its ``f / M``
    columns of ``w_up``/``w_gate`` and rows of ``w_down``.  The token axis
    runs in chunks; each chunk's assignments go to their expert's rank in
    a capacity-bounded ``all_to_all`` (``(D, cap, d)`` send buffers, the
    running count per destination rank in assignment order deciding the
    slot, slots past ``cap`` dropped), the received rows run the grouped
    FFN (``fixed_capacity``: JAX's per-expert windows of ``cap_e`` rows
    and dense batched products), the partial sums are reduced over
    ``model``, and the rows go back in the reverse exchange.  A dropped
    assignment contributes 0.  The aux is the mean of the chunks' Switch
    losses, each over that chunk's tokens on this rank.

Routing (both paths): the router's logits in f32, softmax, the top k in
descending order, the weights renormalised over the chosen k, and the
Switch load-balance loss ``E * sum_e mean(probs)_e * mean(one_hot(top1))_e``.
The top k come from a stable descending sort, so equal probabilities
keep the lower expert id first, as ``jax.lax.top_k`` does: exact ties
happen (the zero tokens padding an EP chunk have a uniform softmax and
pick experts ``0 .. k-1``).

The grouped matmul (:func:`ragged_dot`, JAX's ``jax.lax.ragged_dot``) is
a library call by decision: ``ragged_dot`` is an XLA op, not a Pallas
kernel, so the TPU side has no hand-written kernel to port.  It is
PyTorch's ``torch._grouped_mm`` with the groups' end offsets on the
device (one call for every expert; in bf16 no host sync), on the operands
that call takes (:data:`GROUPED_MM_DTYPES`, rows of 16 bytes); others
raise.  :func:`ragged_dot_ref`, the loop over groups, is its yardstick.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as coll

# the dtypes ``torch._grouped_mm`` takes, forward and backward, on the
# CPU and on the card (torch 2.11+cu128, whose f32 call synchronizes the
# host once: ROADMAP C23).  Rows of both operands must be multiples of
# 16 bytes (every zoo width is, and so is the reduced width 64).
GROUPED_MM_DTYPES = (torch.float32, torch.bfloat16)
# the EP path's rows per expert window in its fixed-capacity form (JAX's
# ``expert_slack``)
EXPERT_SLACK = 2.0


def ragged_dot_ref(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain grouped matmul, :func:`ragged_dot`'s yardstick: rows
    ``[o_g, o_g + n_g)`` of ``x`` times ``w[g]``, rows past the last group
    0; a loop over the groups, whose sizes it reads on the host."""
    parts, start = [], 0
    for g, n in enumerate(group_sizes.tolist()):
        if n:
            parts.append(x[start:start + n] @ w[g])
        start += n
    rest = x.shape[0] - start
    parts.append(x.new_zeros((rest, w.shape[2])))
    return torch.cat(parts)


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot(x, w, group_sizes)``: x ``(R, d)``, w
    ``(G, d, f)``, ``group_sizes`` ``(G,)`` ints summing to at most R;
    ``(R, f)`` in x's dtype, rows past ``sum(group_sizes)`` 0."""
    if x.dtype not in GROUPED_MM_DTYPES or w.dtype != x.dtype \
            or (x.shape[1] * x.element_size()) % 16 \
            or (w.shape[2] * w.element_size()) % 16:
        raise ValueError(f"torch._grouped_mm takes operands of one dtype "
                         f"of {GROUPED_MM_DTYPES} with rows of 16 bytes: "
                         f"x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
                         f"{tuple(w.shape)}")
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    # rows past the last offset are left unwritten, forward and backward
    live = (torch.arange(x.shape[0], device=x.device) < offs[-1])[:, None]
    if x.requires_grad and torch.is_grad_enabled():
        x = torch.where(live, x, 0)
    y = torch._grouped_mm(x.contiguous(), w, offs=offs)
    return torch.where(live, y, 0)


def route(router_w: torch.Tensor, x_flat: torch.Tensor, top_k: int):
    """``(top_v (T, k) f32, top_i (T, k) int64, aux f32 scalar)``."""
    logits = x_flat.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: ties keep the lower expert id first
    top_v, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[:, :top_k], top_i[:, :top_k]
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    e = router_w.shape[1]
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    return top_v, top_i, e * torch.sum(me * ce)


def counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of ``0 .. n-1`` in ``ids`` (no host sync, unlike
    ``torch.bincount`` on a CUDA tensor)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def expert_ffn(xs, w_gate, w_up, w_down, group_sizes, act: str):
    """The grouped FFN on expert-sorted rows: SiLU (or tanh-GELU) in f32,
    cast back to the rows' dtype, as JAX's ``_expert_ffn``."""
    if act == "swiglu":
        g = ragged_dot(xs, w_gate, group_sizes)
        h = F.silu(g.float()).to(xs.dtype) * ragged_dot(xs, w_up,
                                                        group_sizes)
    else:
        h = ragged_dot(xs, w_up, group_sizes)
        h = F.gelu(h.float(), approximate="tanh").to(xs.dtype)
    return ragged_dot(h, w_down, group_sizes)


def slots(a_e: torch.Tensor, e_local: int, d_sz: int):
    """``(dest, pos)`` of each assignment (expert ids ``a_e`` in
    assignment order, token-major then k): its expert's rank, and its slot
    in that rank's send buffer, the running count of the destination's
    assignments before it (JAX's one-hot cumsum; not a count per
    expert)."""
    dest = a_e // e_local
    onehot = F.one_hot(dest, d_sz)
    return dest, torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot,
                           dim=1)


def _inverse(order: torch.Tensor) -> torch.Tensor:
    return torch.argsort(order, stable=True)


def moe_local(p, x: torch.Tensor, top_k: int, act: str = "swiglu", *,
              x_route: Optional[torch.Tensor] = None):
    """One-process MoE, x ``(..., d)``: ``(out, aux)``.  ``x_route``: the
    same values as ``x`` for the router (a tensor-parallel caller routes
    from an input whose gradient is not summed over ``model``)."""
    shape = x.shape
    d = shape[-1]
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e = p["router"].shape[1]
    xr = x_flat if x_route is None else x_route.reshape(-1, d)
    top_v, top_i, aux = route(p["router"], xr, top_k)
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = x_flat[order // top_k]
    gs = counts(flat_e, e)
    w_gate = p["w_gate"] if "w_gate" in p else None
    ys = expert_ffn(xs, w_gate, p["w_up"], p["w_down"], gs, act)
    ys = ys[_inverse(order)].reshape(t, top_k, d)
    out = torch.sum(ys * top_v[..., None].to(ys.dtype), dim=1)
    return out.reshape(shape), aux


def _fixed_capacity_ffn(p, xs, gs, e_local: int, act: str,
                        slack: float = EXPERT_SLACK):
    """JAX's ``fixed_capacity`` form: each expert's first ``cap_e`` rows
    (``ceil(rows / E_local * slack)``) in a dense ``(E_l, cap_e, d)``
    window, batched products, the rows scattered back; rows past an
    expert's window and the pad expert's rows give 0."""
    rows, d = xs.shape
    cap_e = int(math.ceil(rows / max(e_local, 1) * slack))
    starts = torch.cumsum(gs, 0) - gs
    j = torch.arange(cap_e, device=xs.device)
    idx = starts[:e_local, None] + j[None, :]
    within = j[None, :] < gs[:e_local, None]
    idx_c = torch.clamp(idx, max=rows - 1)
    xg = torch.where(within[..., None], xs[idx_c], 0)
    if act == "swiglu":
        g = torch.einsum("ecd,edf->ecf", xg, p["w_gate"])
        h = F.silu(g.float()).to(xg.dtype)
        h = h * torch.einsum("ecd,edf->ecf", xg, p["w_up"])
    else:
        h = torch.einsum("ecd,edf->ecf", xg, p["w_up"])
        h = F.gelu(h.float(), approximate="tanh").to(xg.dtype)
    yg = torch.einsum("ecf,efd->ecd", h, p["w_down"])
    # a dump row at ``rows`` takes the slots outside the windows
    dest = torch.where(within, idx_c, rows).reshape(-1)
    ys = xs.new_zeros((rows + 1, d)).index_put(
        (dest,), torch.where(within[..., None], yg, 0).reshape(-1, d))
    return ys[:rows]


def moe_ep_local(p_local, x_local: torch.Tensor, top_k: int, *,
                 num_experts: int, data_group, model_group=None,
                 capacity_factor: float = 1.25, chunk_tokens: int = 8_192,
                 act: str = "swiglu", fixed_capacity: bool = False,
                 x_route: Optional[torch.Tensor] = None):
    """One rank's expert-parallel MoE (module docstring): x_local
    ``(T_local, d)`` this rank's tokens; ``p_local`` its experts' weights
    and the whole router.  Returns ``(out (T_local, d), aux)``, ``aux``
    the mean of the chunks' Switch losses on this rank.  ``data_group``
    (the experts' dim; None at one rank), ``model_group`` (the FFN width's
    dim, or None), ``x_route`` as :func:`moe_local`'s."""
    d_sz = 1 if data_group is None else \
        torch.distributed.get_world_size(data_group)
    if num_experts % d_sz:
        raise ValueError(f"{num_experts} experts do not split over "
                         f"{d_sz} data ranks")
    e_local = num_experts // d_sz
    t_local, d_model = x_local.shape
    chunk = min(chunk_tokens, t_local)
    n_chunks = -(-t_local // chunk)
    pad = n_chunks * chunk - t_local
    xr_all = x_local if x_route is None else x_route
    if pad:     # zero tokens: routed too, and counted in the aux
        x_local = F.pad(x_local, (0, 0, 0, pad))
        xr_all = F.pad(xr_all, (0, 0, 0, pad))
    cap = int(max(1, math.ceil(chunk * top_k / d_sz * capacity_factor)))
    dev = x_local.device
    a_tok = torch.arange(chunk * top_k, device=dev) // top_k
    w_gate = p_local["w_gate"] if "w_gate" in p_local else None
    outs, aux_total = [], 0.0
    for c in range(n_chunks):
        x_c = x_local[c * chunk:(c + 1) * chunk]
        top_v, top_i, aux = route(p_local["router"],
                                  xr_all[c * chunk:(c + 1) * chunk], top_k)
        a_e = top_i.reshape(-1)
        dest, pos = slots(a_e, e_local, d_sz)
        local_e = a_e % e_local
        keep = pos < cap
        slot_dest = torch.where(keep, dest, d_sz)   # row d_sz: dropped
        slot_pos = torch.where(keep, pos, 0)
        send_x = x_c.new_zeros((d_sz + 1, cap, d_model)).index_put(
            (slot_dest, slot_pos), x_c[a_tok])[:d_sz]
        send_e = torch.full((d_sz + 1, cap), e_local, dtype=torch.int64,
                            device=dev).index_put(
            (slot_dest, slot_pos), local_e)[:d_sz]
        recv_x = coll.all_to_all(send_x, data_group)
        recv_e = coll.all_to_all(send_e, data_group)
        rx = recv_x.reshape(d_sz * cap, d_model)
        re_ = recv_e.reshape(-1)
        # the local grouped FFN: sorted by expert, the pad expert last
        order = torch.argsort(re_, stable=True)
        xs = rx[order]
        gs = counts(re_, e_local + 1)
        if fixed_capacity:
            ys = _fixed_capacity_ffn(p_local, xs, gs, e_local, act)
        else:
            # the pad expert's rows lie past the real experts' groups,
            # where the grouped product gives 0 (JAX appends a zero
            # expert; both give exact zeros there)
            ys = expert_ffn(xs, w_gate, p_local["w_up"], p_local["w_down"],
                            gs[:e_local], act)
        ys = coll.reduce_from(ys, model_group)
        ys = ys[_inverse(order)].reshape(d_sz, cap, d_model)
        back = coll.all_to_all(ys, data_group)
        y_a = back[slot_dest.clamp(max=d_sz - 1),
                   torch.clamp(pos, max=cap - 1)]
        y_a = torch.where(keep[:, None], y_a, 0).reshape(chunk, top_k,
                                                         d_model)
        outs.append(torch.sum(y_a * top_v[..., None].to(y_a.dtype), dim=1))
        aux_total = aux_total + aux
    out = torch.cat(outs)[:t_local]
    return out, aux_total / n_chunks
