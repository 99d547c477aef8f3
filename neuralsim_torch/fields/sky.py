"""Directional MLP sky (port of neuralsim_tpu/fields/sky.py:20-40)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import MLP
from .embedders import sh_embedder


class SimpleSky(nn.Module):
    """rgb = MLP(SH(dir) [, h_appear]), blended by (1 - mask_volume) in the
    renderer."""

    def __init__(self, *, hidden: int = 64, depth: int = 2, sh_degree: int = 4,
                 appear_embed_dim: int = 0):
        super().__init__()
        self.dir_embed, dir_dim = sh_embedder(sh_degree)
        self.appear_embed_dim = appear_embed_dim
        self.net = MLP(dir_dim + appear_embed_dim, 3, hidden=hidden, depth=depth,
                       output_activation="sigmoid")

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def forward(self, dirs: torch.Tensor, h_appear: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """dirs [..., 3] -> rgb [..., 3]; ``h_appear`` [..., appear_embed_dim]
        (zeros where not given) where the sky takes an appearance code."""
        h = self.dir_embed(dirs)
        if self.appear_embed_dim:
            if h_appear is None:
                h_appear = h.new_zeros(dirs.shape[:-1] + (self.appear_embed_dim,))
            h = torch.cat([h, h_appear], dim=-1)
        return self.net(h)
