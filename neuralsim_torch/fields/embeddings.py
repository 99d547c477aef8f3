"""Learnable embedding tables (port of neuralsim_tpu/fields/embeddings.py:20-36).

An :class:`Embedding` is an [n, dim] table looked up by index with the
index clamped into [0, n - 1] (``jnp.take(..., mode="clip")``): the latent
lookup ``ops/latent_take.py`` ``LatentTake``, kernel K13 on the card and the
plain take on the CPU. ``SeqEmbedding`` is the per-frame table of a camera's
appearance codes; its timestamp form ``at_time`` waits with the
time-conditioned fields.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.latent_take import LatentTake


class Embedding(nn.Module):
    """A plain [n, dim] table; parameter ``weight`` (the JAX name)."""

    def __init__(self, n: int, dim: int, init_scale: float = 1e-2):
        super().__init__()
        self.n, self.dim, self.init_scale = n, dim, init_scale
        self.weight = nn.Parameter(torch.zeros(n, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init in distribution: normal * ``init_scale``."""
        self.weight.copy_(torch.randn(self.n, self.dim, generator=generator) * self.init_scale)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """idx: int [...] -> [..., dim], each index clamped into the table."""
        flat = idx.reshape(-1)
        return LatentTake.apply(self.weight, flat, flat.numel()).reshape(
            idx.shape + (self.dim,))


class SeqEmbedding(Embedding):
    """A per-frame embedding: one row a frame, looked up by frame index."""

    def __init__(self, n_frames: int, dim: int, init_scale: float = 1e-2):
        super().__init__(n_frames, dim, init_scale)
