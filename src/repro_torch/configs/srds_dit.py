"""The paper's own DiT denoiser configs (same values as
``repro.configs.srds_dit``): CIFAR 32x32 and LSUN 128x128 pixel models and
the SD-v2-like 64x64x4 latent model.  ``causal``, ``act`` and ``norm``
carry the JAX values; the DiT reads none of them (see ``configs.base``)."""
from .base import ArchConfig, register_arch

SRDS_DIT_S = register_arch(ArchConfig(
    name="srds-dit-cifar", family="dit",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, causal=False, act="gelu", norm="layernorm",
    patch_size=4, in_channels=3,
    source="paper benchmark: 32x32 CIFAR pixel diffusion",
))

SRDS_DIT_L = register_arch(ArchConfig(
    name="srds-dit-lsun", family="dit",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, causal=False, act="gelu", norm="layernorm",
    patch_size=8, in_channels=3,
    source="paper benchmark: 128x128 LSUN pixel diffusion",
))

SRDS_DIT_SD = register_arch(ArchConfig(
    name="srds-dit-sd2", family="dit",
    num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
    d_ff=4608, causal=False, act="gelu", norm="layernorm",
    patch_size=2, in_channels=4,
    source="paper benchmark: SD-v2 latent diffusion (64x64x4 latents)",
))
