"""Extra camera models: orthographic and panorama (equirectangular) (port of
neuralsim_tpu/scene/observers/extra_cameras.py:15-52). The render tool's
``topdown`` mode casts its map through :func:`ortho_get_rays`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ...maths.transforms import apply_rotation, apply_transform, norm3


def ortho_get_rays(xy: torch.Tensor, c2w: torch.Tensor, *, width: float, height: float,
                   W: int, H: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthographic camera: parallel rays along the camera's +z, origins on
    the sensor plane of ``width`` x ``height`` world units. xy: [..., 2]
    pixel coordinates of a W x H image."""
    sx = (xy[..., 0] / W - 0.5) * width
    sy = (xy[..., 1] / H - 0.5) * height
    o_cam = torch.stack([sx, sy, torch.zeros_like(sx)], -1)
    d_cam = torch.tensor([0.0, 0.0, 1.0], dtype=o_cam.dtype,
                         device=o_cam.device).expand(o_cam.shape)
    rays_o = apply_transform(c2w, o_cam)
    rays_d = apply_rotation(c2w, d_cam)
    return rays_o, rays_d / norm3(rays_d)[..., None]


def panorama_get_rays(xy: torch.Tensor, c2w: torch.Tensor, *, W: int, H: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equirectangular panorama: pixel -> (azimuth, elevation) -> ray.
    Azimuth in [-pi, pi), elevation in [-pi/2, pi/2]; camera frame x right,
    y down, z forward."""
    az = (xy[..., 0] / W - 0.5) * 2.0 * math.pi
    el = -(xy[..., 1] / H - 0.5) * math.pi
    d_cam = torch.stack([torch.cos(el) * torch.sin(az), -torch.sin(el),
                         torch.cos(el) * torch.cos(az)], -1)
    rays_d = apply_rotation(c2w, d_cam)
    rays_o = c2w[..., :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def panorama_project(pts_cam: torch.Tensor, *, W: int, H: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points -> panorama pixels and range."""
    r = norm3(pts_cam)
    az = torch.atan2(pts_cam[..., 0], pts_cam[..., 2])
    el = torch.asin(torch.clamp(-pts_cam[..., 1] / torch.clamp(r, min=1e-9), -1, 1))
    u = (az / (2 * math.pi) + 0.5) * W
    v = (0.5 - el / math.pi) * H
    return torch.stack([u, v], -1), r
