"""Model layers and the DiT denoiser (counterpart of ``repro.models``)."""
