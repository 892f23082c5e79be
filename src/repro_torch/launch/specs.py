"""Input stand-ins for every (arch x shape) dry-run cell (counterpart of
``repro.launch.specs``): tensors on the ``meta`` device, with JAX's
names, keys, shapes and dtypes, and no memory.

JAX's ``param_specs`` stacks each block leaf on a layer axis; the port's
model keeps one leaf per layer (``blocks.3.attn.wq``), so its
:func:`param_specs` are the per-layer leaves of the port's model built on
``meta`` (the same element total).  With a mesh in ``parallel`` (a
``DeviceMesh``, or a ``{dim: size}`` mapping) they are this rank's parts
by :func:`repro_torch.parallel.sharding.param_shardings`.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import (LOCAL, ParallelCtx, TransformerLM,
                                            make_dense_cache)

META = torch.device("meta")
# the DiT's image side by arch (JAX's table)
DIT_IMAGE = {"srds-dit-cifar": 32, "srds-dit-lsun": 128, "srds-dit-sd2": 64}


def _s(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def dit_image_size(cfg: ArchConfig) -> int:
    return DIT_IMAGE.get(cfg.name, 32)


def batch_specs(cfg: ArchConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Inputs for the step this shape runs (train/prefill: the full
    sequence; decode: one token, the cache apart: :func:`cache_specs`)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "dit":
        size = dit_image_size(cfg)
        return {"images": _s((b, size, size, cfg.in_channels),
                             torch.float32)}
    if shape.is_decode:
        if cfg.frontend == "audio":
            return {"features": _s((b, 1, cfg.d_model), torch.bfloat16)}
        return {"tokens": _s((b, 1), torch.int32)}
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        out["features"] = _s((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _s((b, s), torch.int32)
        if cfg.frontend == "vision":
            out["image_embeds"] = _s((b, cfg.num_prefix_embeds, cfg.d_model),
                                     torch.bfloat16)
    if shape.kind == "train":
        out["labels"] = _s((b, s), torch.int32)
        if cfg.frontend == "audio":
            out["mask"] = _s((b, s), torch.bool)
    return out


def param_specs(cfg: ArchConfig, parallel: ParallelCtx = LOCAL
                ) -> Dict[str, torch.Tensor]:
    """``{name: meta tensor}`` of the model's parameters."""
    if cfg.family == "dit":
        from repro_torch.models.dit import DiT
        model = DiT(cfg, device=META)
    else:
        model = TransformerLM(cfg, device=META, parallel=parallel)
    return {n: p.detach() for n, p in model.named_parameters()}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig,
                parallel: ParallelCtx = LOCAL):
    """The decode step's input cache, or the prefill's output layout
    (:func:`make_dense_cache`'s: a ``(k, v)`` tuple, an ``RWKVState`` or a
    ``HymbaCache``), on ``meta``; with a ``DeviceMesh`` this rank's part."""
    return make_dense_cache(cfg, shape.global_batch, shape.seq_len,
                            device=META, parallel=parallel)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                parallel: ParallelCtx = LOCAL):
    """Everything the step needs, keyed by argument name."""
    specs = {"batch": batch_specs(cfg, shape)}
    if shape.is_decode:
        specs["cache"] = cache_specs(cfg, shape, parallel)
        specs["pos"] = _s((), torch.int32)
    return specs
