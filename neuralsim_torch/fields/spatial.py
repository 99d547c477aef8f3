"""Axis-aligned box space (port of neuralsim_tpu/fields/spatial.py:18-67)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.ray import ray_aabb_intersect


class AABBSpace(nn.Module):
    """Owns a model's bounding box: normalisation into the encoding's [0,1]^3
    domain and the ray test that seeds sampling. The box is two float32
    buffers, so it moves with the field that holds it."""

    def __init__(self, aabb_min: Sequence[float] = (-1.0, -1.0, -1.0),
                 aabb_max: Sequence[float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.register_buffer("aabb_min", torch.tensor(aabb_min, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("aabb_max", torch.tensor(aabb_max, dtype=torch.float32),
                             persistent=False)

    @property
    def center(self) -> torch.Tensor:
        return 0.5 * (self.aabb_min + self.aabb_max)

    @property
    def half_extent(self) -> torch.Tensor:
        return 0.5 * (self.aabb_max - self.aabb_min)

    def normalize_coords(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.aabb_min) / (self.aabb_max - self.aabb_min)

    def unnormalize_coords(self, u: torch.Tensor) -> torch.Tensor:
        return u * (self.aabb_max - self.aabb_min) + self.aabb_min

    def uniform_points(self, noise: torch.Tensor) -> torch.Tensor:
        """Points inside the box from uniform draws ``noise`` [n, 3] in [0, 1)
        (for the eikonal and sparsity losses); the caller draws the noise."""
        return self.unnormalize_coords(noise)

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near: Optional[torch.Tensor] = None, far: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-ray (near, far, hit) against the box."""
        n, f, hit = ray_aabb_intersect(rays_o, rays_d, self.aabb_min, self.aabb_max,
                                       t_min=0.0, t_max=1e10)
        if near is not None:
            n = torch.maximum(n, near)
        if far is not None:
            f = torch.minimum(f, far)
        return n, f, hit & (f > n)
