"""Deterministic, restart-safe synthetic data (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of ``(dataset seed, step)``: its random
draws come from a ``torch.Generator`` seeded by :func:`fold_in` of the two,
on the CPU, so a restarted trainer resumes on exactly the batch it would
have seen, on any device.  The procedural formulas (:func:`image_formula`,
:func:`token_formula`) take the draws as arguments and run on the
stream's device.  The DiT's ``ImageStream`` and the language models'
``LMStream`` are ported; the audio and VLM streams wait for those archs
(ROADMAP A11), and the per-host slicing for the multi-device port (A10(c)):
the one host takes the whole global batch.  A stream's ``batch`` copies
its draws to the device through pinned memory, non-blocking, so a
training loop never waits for the card to fetch its next batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.transfer import host_to_device

_MASK64 = (1 << 64) - 1
IMAGE_SIZES = {"srds-dit-cifar": 32, "srds-dit-lsun": 128,
               "srds-dit-sd2": 64}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed mixing ``seed`` with ``data`` (splitmix64's
    finalizer), the counterpart of ``jax.random.fold_in``."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def image_formula(cx, cy, sig, grad_dir, amp, size: int) -> torch.Tensor:
    """Gaussian blobs over linear gradients, clipped to [-1, 1]:
    (B, size, size, C) f32 from the five draws (``cx``, ``cy``, ``sig`` of
    shape (B, 1, 1, 1); ``grad_dir``, ``amp`` of shape (B, 1, 1, C)), on
    their device.  The same formula as ``ImageStream._make`` in JAX."""
    ax = torch.arange(size, dtype=torch.float32, device=cx.device) / size
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    blob = torch.exp(-((xx[None, :, :, None] - cx) ** 2
                       + (yy[None, :, :, None] - cy) ** 2) / (2 * sig ** 2))
    base = grad_dir * (xx + yy)[None, :, :, None] / 2
    return torch.clamp(base + amp * blob, -1, 1).float()


class ImageStream:
    """Procedural images in [-1, 1]: Gaussian blobs over linear gradients."""

    def __init__(self, cfg: DataConfig, size: int, channels: int,
                 device="cuda"):
        self.cfg = cfg
        self.size = size
        self.channels = channels
        self.device = torch.device(device)

    def draws(self, step: int):
        """The five draws of ``step``'s batch, on the CPU."""
        g = torch.Generator().manual_seed(fold_in(self.cfg.seed ^ 0xD1F,
                                                  step))
        b, c = self.cfg.global_batch, self.channels

        def uniform(shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(shape, generator=g)

        return (uniform((b, 1, 1, 1)), uniform((b, 1, 1, 1)),
                uniform((b, 1, 1, 1), 0.05, 0.3),
                uniform((b, 1, 1, c), -1.0, 1.0),
                uniform((b, 1, 1, c), 0.3, 1.0))

    def batch(self, step: int):
        draws = [host_to_device(d, self.device) for d in self.draws(step)]
        return {"images": image_formula(*draws, self.size)}


def token_formula(a, b, noise, use_noise, seq_len: int,
                  vocab: int) -> torch.Tensor:
    """Affine-progression token sequences with uniform noise: (B, seq_len)
    int64 from the four draws (``a``, ``b`` of shape (B, 1); ``noise`` and
    the bool ``use_noise`` of shape (B, seq_len)), on their device.  Token
    i is ``(a * i + b) % vocab`` unless ``use_noise`` picks ``noise``: the
    same formula as ``LMStream._make`` in JAX."""
    i = torch.arange(seq_len, device=a.device)[None, :]
    prog = (a.long() * i + b.long()) % vocab
    return torch.where(use_noise, noise.long(), prog)


class LMStream:
    """Structured synthetic LM data: each sequence interleaves an affine
    progression (``t_{i+1} = t_i + a mod V``) with 15% uniform noise, so
    short training runs visibly reduce the loss."""

    def __init__(self, cfg: DataConfig, vocab: int, device="cuda"):
        self.cfg = cfg
        self.vocab = vocab
        self.device = torch.device(device)

    def draws(self, step: int):
        """The four draws of ``step``'s batch, on the CPU."""
        g = torch.Generator().manual_seed(fold_in(self.cfg.seed, step))
        b, s = self.cfg.global_batch, self.cfg.seq_len
        return (torch.randint(1, 8, (b, 1), generator=g),
                torch.randint(0, self.vocab, (b, 1), generator=g),
                torch.randint(0, self.vocab, (b, s), generator=g),
                torch.rand((b, s), generator=g) < 0.15)

    def batch(self, step: int):
        draws = [host_to_device(d, self.device) for d in self.draws(step)]
        tokens = token_formula(*draws, self.cfg.seq_len, self.vocab)
        return {"tokens": tokens, "labels": tokens}


def make_stream(cfg: ArchConfig, data_cfg: DataConfig, device="cuda"):
    """The arch's stream: images for the DiT, tokens for the dense, RWKV
    and hybrid (hymba) language models."""
    if cfg.family == "dit":
        return ImageStream(data_cfg, IMAGE_SIZES.get(cfg.name, 32),
                           cfg.in_channels, device)
    if cfg.family in ("dense", "ssm", "hybrid"):
        return LMStream(data_cfg, cfg.vocab_size, device)
    raise NotImplementedError(f"the {cfg.family} data streams (audio, "
                              f"vision) wait for those archs (ROADMAP A11)")
