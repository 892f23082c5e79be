"""The paper's own DiT denoiser configs (same values as
``repro.configs.srds_dit``): CIFAR 32x32 and LSUN 128x128 pixel models and
the SD-v2-like 64x64x4 latent model.  ``causal``, ``act`` and ``norm``
carry the JAX values; the DiT reads none of them (see ``configs.base``).

:func:`dit_denoiser` wires a config into the
:class:`repro_torch.core.denoiser.Denoiser` seam, model-parallel or not."""
from .base import ArchConfig, get_arch, register_arch

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


def dit_denoiser(arch, model, *, shard_axis=None, mesh=None):
    """A DiT denoiser for a paper config, through the seam (JAX's
    ``dit_denoiser``, on a :class:`repro_torch.models.dit.DiT` of that
    config).  Without ``shard_axis`` this is the plain ``model_fn(x, t)``;
    with it, a Denoiser whose rows split over that mesh dim (``"model"``
    of :func:`repro_torch.launch.mesh.make_srds_mesh`), which every
    driver runs model-parallel with no driver-side changes."""
    from repro_torch.models import dit
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if model.cfg != cfg:
        raise ValueError(f"the model is a {model.cfg.name}, not {cfg.name}")
    return dit.make_denoiser(model, shard_axis=shard_axis, mesh=mesh)
