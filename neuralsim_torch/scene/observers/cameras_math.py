"""Pinhole camera math with the OpenCV distortion (port of
neuralsim_tpu/scene/observers/cameras_math.py:21-64, 93-122).

Pixel centres sit at integer + 0.5; ``xy`` are continuous pixel coordinates
(u, v) in [0, W) x [0, H). The camera frame is OpenCV's: x right, y down, z
forward. Not ported yet: the fisheye model, projection and frustum culling.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...maths.transforms import apply_rotation, norm3


def pinhole_lift(xy: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> camera-space points at unit depth [..., 3];
    intr [..., 3, 3] (fx, fy, cx, cy and the skew)."""
    fx, fy = intr[..., 0, 0], intr[..., 1, 1]
    cx, cy, sk = intr[..., 0, 2], intr[..., 1, 2], intr[..., 0, 1]
    y = (xy[..., 1] - cy) / fy
    x = (xy[..., 0] - cx - y * sk) / fx
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def opencv_distort(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """OpenCV radial-tangential distortion of normalised coordinates [..., 2];
    dist [..., D] = (k1, k2, p1, p2, k3[, k4, k5, k6]), missing ones zero."""
    D = dist.shape[-1]
    get = lambda i: dist[..., i] if i < D else torch.zeros_like(dist[..., 0])
    k1, k2, p1, p2, k3 = get(0), get(1), get(2), get(3), get(4)
    k4, k5, k6 = get(5), get(6), get(7)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = (1 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def opencv_undistort(xd: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Inverse of :func:`opencv_distort` by a fixed number of fixed-point steps."""
    xn = xd
    for _ in range(iters):
        xn = xd - (opencv_distort(xn, dist) - xn)
    return xn


def get_rays(xy: torch.Tensor, intr: torch.Tensor, c2w: torch.Tensor,
             distortion: Optional[torch.Tensor] = None, camera_model: str = "pinhole",
             normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels [..., 2] -> world rays (origins, directions) [..., 3]."""
    if camera_model not in ("pinhole", "opencv"):
        raise NotImplementedError(f"camera model {camera_model} is not ported")
    xn = pinhole_lift(xy, intr)[..., :2]
    if camera_model == "opencv" and distortion is not None:
        xn = opencv_undistort(xn, distortion)
    dirs_cam = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    rays_d = apply_rotation(c2w, dirs_cam)
    if normalize:
        rays_d = rays_d / norm3(rays_d)[..., None]
    return c2w[..., :3, 3].expand(rays_d.shape), rays_d
