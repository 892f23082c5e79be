"""Deterministic, restart-safe synthetic data (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of ``(dataset seed, step)``: its random
draws come from a ``torch.Generator`` seeded by :func:`fold_in` of the two,
on the CPU, so a restarted trainer resumes on exactly the batch it would
have seen, on any device.  The procedural formulas (:func:`image_formula`,
:func:`token_formula`) take the draws as arguments and run on the
stream's device: the DiT's ``ImageStream``, the language models'
``LMStream``, the audio stub's ``AudioStream`` (frame features, unit
labels and a Bernoulli 0.3 mask of the positions the loss counts) and
the vision stub's ``VLMStream`` (the LM stream's tokens and
``image_embeds``).  A stream's ``batch`` copies its draws to the device
through pinned memory, non-blocking, so a training loop never waits for
the card to fetch its next batch.

Per-rank slices (JAX's ``_host_slice``).  With a ``mesh``, a stream hands
each rank its rows of the global batch: the rank's position on the batch
axes (row-major, in place of ``jax.process_index()``) picks
``global_batch / n`` consecutive rows.  The draws are the global batch's
(JAX folds the slice's start into its key instead), so the ranks' slices,
concatenated, are the one-host batch bit for bit.
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


def _host_slice(global_batch: int, mesh=None,
                batch_axes=("data",)) -> tuple:
    """``(start, rows)`` of this rank's part of the global batch: its
    position on ``batch_axes`` of ``mesh`` (row-major) times
    ``global_batch / n``; the whole batch without a mesh."""
    if mesh is None:
        return 0, global_batch
    from repro_torch.parallel.sharding import mesh_shape
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in batch_axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over the batch axes {tuple(batch_axes)} ({n})")
    per = global_batch // n
    return idx * per, per


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
                 device="cuda", mesh=None, batch_axes=("data",)):
        self.cfg = cfg
        self.size = size
        self.channels = channels
        self.device = torch.device(device)
        self.rows = _host_slice(cfg.global_batch, mesh, batch_axes)

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
        start, per = self.rows
        draws = [host_to_device(d[start:start + per], self.device)
                 for d in self.draws(step)]
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

    def __init__(self, cfg: DataConfig, vocab: int, device="cuda",
                 mesh=None, batch_axes=("data",)):
        self.cfg = cfg
        self.vocab = vocab
        self.device = torch.device(device)
        self.rows = _host_slice(cfg.global_batch, mesh, batch_axes)

    def draws(self, step: int):
        """The four draws of ``step``'s batch, on the CPU."""
        g = torch.Generator().manual_seed(fold_in(self.cfg.seed, step))
        b, s = self.cfg.global_batch, self.cfg.seq_len
        return (torch.randint(1, 8, (b, 1), generator=g),
                torch.randint(0, self.vocab, (b, 1), generator=g),
                torch.randint(0, self.vocab, (b, s), generator=g),
                torch.rand((b, s), generator=g) < 0.15)

    def batch(self, step: int):
        start, per = self.rows
        draws = [host_to_device(d[start:start + per].contiguous(),
                                self.device) for d in self.draws(step)]
        tokens = token_formula(*draws, self.cfg.seq_len, self.vocab)
        return {"tokens": tokens, "labels": tokens}


def audio_formula(normal, labels, mask) -> dict:
    """The audio stub's batch from its three draws (a standard normal
    ``(B, S, d)``, labels ``(B, S)`` and the bool mask ``(B, S)``, true
    with probability 0.3): features ``normal * 0.5``, the labels as int64
    and the mask; the formulas of ``AudioStream.batch`` in JAX."""
    return {"features": normal * 0.5, "labels": labels.long(),
            "mask": mask}


class AudioStream:
    """Frame features, unit labels and the mask of the positions the
    masked-unit loss counts (the audio frontend is a stub)."""

    def __init__(self, cfg: DataConfig, d_model: int, vocab: int,
                 device="cuda", mesh=None, batch_axes=("data",)):
        self.cfg = cfg
        self.d_model = d_model
        self.vocab = vocab
        self.device = torch.device(device)
        self.rows = _host_slice(cfg.global_batch, mesh, batch_axes)

    def draws(self, step: int):
        """The three draws of ``step``'s batch, on the CPU."""
        g = torch.Generator().manual_seed(fold_in(self.cfg.seed ^ 0xA0D10,
                                                  step))
        b, s = self.cfg.global_batch, self.cfg.seq_len
        return (torch.randn((b, s, self.d_model), generator=g),
                torch.randint(0, self.vocab, (b, s), generator=g),
                torch.rand((b, s), generator=g) < 0.3)

    def batch(self, step: int):
        start, per = self.rows
        draws = [host_to_device(d[start:start + per].contiguous(),
                                self.device) for d in self.draws(step)]
        return audio_formula(*draws)


class VLMStream:
    """The LM stream's tokens with ``image_embeds`` ``(B, P, d)``, a
    normal draw times 0.2 (the vision frontend is a stub)."""

    def __init__(self, cfg: DataConfig, vocab: int, num_prefix: int,
                 d_model: int, device="cuda", mesh=None,
                 batch_axes=("data",)):
        self.cfg = cfg
        self.lm = LMStream(cfg, vocab, device, mesh, batch_axes)
        self.num_prefix = num_prefix
        self.d_model = d_model
        self.device = torch.device(device)
        self.rows = self.lm.rows

    def draws(self, step: int):
        """The image draw of ``step``'s batch, on the CPU."""
        g = torch.Generator().manual_seed(fold_in(self.cfg.seed ^ 0x1AB,
                                                  step))
        return torch.randn((self.cfg.global_batch, self.num_prefix,
                            self.d_model), generator=g)

    def batch(self, step: int):
        b = self.lm.batch(step)
        start, per = self.rows
        b["image_embeds"] = host_to_device(
            self.draws(step)[start:start + per].contiguous(),
            self.device) * 0.2
        return b


def make_stream(cfg: ArchConfig, data_cfg: DataConfig, device="cuda",
                mesh=None, batch_axes=("data",)):
    """The arch's stream (JAX's ``make_stream``): frames for the audio
    stub, tokens and image embeddings for the vision stub, images for the
    DiT, tokens for the other language models; with ``mesh``, this rank's
    rows (:func:`_host_slice`)."""
    if cfg.frontend == "audio":
        return AudioStream(data_cfg, cfg.d_model, cfg.vocab_size, device,
                           mesh, batch_axes)
    if cfg.frontend == "vision":
        return VLMStream(data_cfg, cfg.vocab_size, cfg.num_prefix_embeds,
                         cfg.d_model, device, mesh, batch_axes)
    if cfg.family == "dit":
        return ImageStream(data_cfg, IMAGE_SIZES.get(cfg.name, 32),
                           cfg.in_channels, device, mesh, batch_axes)
    return LMStream(data_cfg, cfg.vocab_size, device, mesh, batch_axes)
