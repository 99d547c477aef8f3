"""Axis-aligned box space and the two contractions of the distant field, the
inverted sphere and the inverted cuboid (port of
neuralsim_tpu/fields/spatial.py:18-67, 97-131)."""
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

    @property
    def radius3d(self) -> torch.Tensor:
        return torch.linalg.norm(self.half_extent)

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


def contract_inverted_sphere(x: torch.Tensor, inner_radius: float = 1.0) -> torch.Tensor:
    """NeRF++ inverted-sphere parameterisation of background points: [..., 3]
    -> [..., 4] = (unit direction, inner_radius / r), with r clipped from
    below at the inner radius, so every channel is bounded."""
    r = torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=inner_radius)
    return torch.cat([x / r, inner_radius / r], dim=-1)


def contract_inverted_cuboid(x: torch.Tensor, center: torch.Tensor,
                             half: torch.Tensor) -> torch.Tensor:
    """NeRF++ ``fixed_cuboid_shells``: shells are scaled copies of the
    close-range box (``center``, ``half`` extent). [..., 3] -> [..., 4] =
    (the point on the unit shell, 1 / rho), rho the box's own radius of the
    point, max |(x - center) / half|. A point inside the box (rho < 1) lands
    on the rho = 1 shell: the distant field cannot hold close-range content."""
    xc = (x - center) / half
    rho = torch.amax(xc.abs(), dim=-1, keepdim=True)
    shell = xc / torch.clamp(rho, min=1e-9)
    return torch.cat([shell, 1.0 / torch.clamp(rho, min=1.0)], dim=-1)
