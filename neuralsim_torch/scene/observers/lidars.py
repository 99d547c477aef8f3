"""LiDAR observers: the dataset's beams in the world (port of
neuralsim_tpu/scene/observers/lidars.py:25-38).

A ``RaysLidar`` node replays the beams the dataset recorded in its own frame;
the frozen scene gives the sensor's pose (at one frame, or one frame per
beam). The synthetic beam generators are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...maths.transforms import apply_rotation, apply_transform, norm3
from ..scene import FrozenScene


def lidar_rays_to_world(frozen: FrozenScene, lidar_id: str, rays_o_local: torch.Tensor,
                        rays_d_local: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sensor-frame beams [..., 3] -> world (origins, unit directions)."""
    l2w = frozen.world_transform(lidar_id)
    o = apply_transform(l2w, rays_o_local)
    d = apply_rotation(l2w, rays_d_local)
    return o, d / torch.clamp(norm3(d)[..., None], min=1e-9)
