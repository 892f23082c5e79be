"""phi-3-vision-4.2b [vlm]: phi3-mini with a CLIP frontend as a stub (the
batch carries patch embeddings, spliced over the first 576 positions)
(same values as ``repro.configs.phi3_vision``)."""
from .base import ArchConfig, register_arch

PHI3_VISION = register_arch(ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    act="swiglu", norm="rmsnorm",
    frontend="vision", num_prefix_embeds=576,   # 24 x 24 CLIP patch grid
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
))
