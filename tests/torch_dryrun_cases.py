"""The cells of ``tests/test_torch_dryrun.py``, shared by its port and
JAX subprocesses (this module imports no JAX)."""
import dataclasses

# JAX's test_dryrun_integration cases' families
BYTES_ARCHS = ("stablelm-3b", "arctic-480b", "rwkv6-1.6b", "hymba-1.5b",
               "hubert-xlarge")
BYTES_SHAPE = (8, 32)              # (global batch, seq) of the train cell
FLOP_SHAPE = (4, 32)
# the CLI cells' cut: depth, global batch, sequence
CLI_CUT = ["--layers", "1", "--batch", "16", "--seq", "256"]


def bytes_cfg(get_arch, arch):
    """A reduced config in bf16, the production dtype (the meta device's
    grouped product, an MoE's, takes bf16 only)."""
    return dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")


def flop_cfg(get_arch):
    """A reduced dense LM whose heads (8 q, 4 KV), ``d_ff`` and
    vocabulary split over 4 model ranks (``get_arch`` either package's)."""
    return dataclasses.replace(get_arch("qwen3-8b").reduced(), num_heads=8,
                               num_kv_heads=4)


def sample_cfg():
    """JAX's test_dryrun_srds_sample_cell DiT."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("srds-dit-cifar").reduced(),
                               patch_size=4, in_channels=3)
