"""Camera observers: rays from a frozen scene (port of
neuralsim_tpu/scene/observers/cameras.py:24-44).

A camera is a scene node whose frame data carries ``intr`` [T, 3, 3], ``hw``
[T, 2] and optionally ``distortion`` [T, D].
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..scene import FrozenScene
from .cameras_math import get_rays


def camera_get_selected_rays(frozen: FrozenScene, cam_id: str, xy: torch.Tensor,
                             camera_model: str = "pinhole"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous pixel coordinates [..., 2] -> world rays, from the frozen
    camera's pose and intrinsics."""
    data = frozen.data(cam_id)
    return get_rays(xy, data["intr"], frozen.world_transform(cam_id),
                    distortion=data.get("distortion"), camera_model=camera_model)


def camera_get_all_rays(frozen: FrozenScene, cam_id: str, H: int, W: int,
                        camera_model: str = "pinhole") -> Tuple[torch.Tensor, torch.Tensor]:
    """The full frame's rays, row by row: (origins, directions) [H * W, 3]."""
    dev = frozen.world_transform(cam_id).device
    u, v = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
                          torch.arange(H, dtype=torch.float32, device=dev) + 0.5, indexing="xy")
    xy = torch.stack([u, v], dim=-1).reshape(-1, 2)
    ro, rd = camera_get_selected_rays(frozen, cam_id, xy, camera_model)
    return ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
