"""LiDAR observers: the dataset's beams in the world, and the synthetic beam
models that a simulated LiDAR fires (port of
neuralsim_tpu/scene/observers/lidars.py:25-127).

A ``RaysLidar`` node replays the beams the dataset recorded in its own frame;
the frozen scene gives the sensor's pose (at one frame, or one frame per
beam). A synthetic LiDAR is a fixed set of unit directions in the sensor's
frame (x forward, y left, z up), fired from its origin: the mechanical
surround models (``SurroundLidarGenerator``: the presets ``pandar64``,
``pandar_qt``, ``pandar_xt``, ``hdl64`` and ``vlp16``, an elevation table by
a ring of azimuths), a solid-state raster (``SolidStateLidarGenerator``) and a
Risley-prism rosette (``RisleyPrismLidarGenerator``). Their directions are
built in numpy as the JAX package builds them, kept as float32, and handed
out on the caller's device by ``get_all_rays(device)``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
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


class _Generator:
    """A synthetic LiDAR's beams: ``dirs`` [N, 3] float32 (CPU) from the
    sensor's origin, and its ``max_range``."""

    dirs: torch.Tensor
    max_range: float

    def _set_dirs(self, d: np.ndarray) -> None:
        self.dirs = torch.from_numpy(np.ascontiguousarray(d.reshape(-1, 3).astype(np.float32)))

    def get_all_rays(self, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        """(origins, directions) [N, 3] on ``device``, in the sensor's frame."""
        d = self.dirs.to(device)
        return torch.zeros_like(d), d


class SurroundLidarGenerator(_Generator):
    """Mechanical surround LiDAR: ``n_channels`` elevations evenly over
    [elev_min, elev_max] degrees by ``horizontal_res`` azimuths over
    [-pi, pi), row-major by channel. An unknown model takes ``pandar64``'s
    settings; keyword overrides replace a preset's."""

    PRESETS: Dict[str, Dict] = {
        "pandar64": {"n_channels": 64, "elev_min": -25.0, "elev_max": 15.0,
                     "horizontal_res": 1800, "max_range": 200.0},
        "pandar_qt": {"n_channels": 64, "elev_min": -52.1, "elev_max": 52.1,
                      "horizontal_res": 600, "max_range": 20.0},
        "pandar_xt": {"n_channels": 32, "elev_min": -16.0, "elev_max": 15.0,
                      "horizontal_res": 1800, "max_range": 120.0},
        "hdl64": {"n_channels": 64, "elev_min": -24.8, "elev_max": 2.0,
                  "horizontal_res": 1800, "max_range": 120.0},
        "vlp16": {"n_channels": 16, "elev_min": -15.0, "elev_max": 15.0,
                  "horizontal_res": 900, "max_range": 100.0},
    }

    def __init__(self, lidar_model: str = "pandar64", **overrides):
        cfg = dict(self.PRESETS.get(lidar_model, self.PRESETS["pandar64"]))
        cfg.update(overrides)
        self.cfg = cfg
        n, h = cfg["n_channels"], cfg["horizontal_res"]
        elev = np.deg2rad(np.linspace(cfg["elev_min"], cfg["elev_max"], n))
        azim = np.linspace(-math.pi, math.pi, h, endpoint=False)
        E, A = np.meshgrid(elev, azim, indexing="ij")
        self._set_dirs(np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1))
        self.max_range = cfg["max_range"]


class SolidStateLidarGenerator(_Generator):
    """Solid-state LiDAR: a ``res_v`` x ``res_h`` raster over a rectangular
    field of view (degrees), row-major by elevation."""

    def __init__(self, fov_h_deg: float = 120.0, fov_v_deg: float = 25.0,
                 res_h: int = 640, res_v: int = 128, max_range: float = 150.0):
        ah = np.deg2rad(np.linspace(-fov_h_deg / 2, fov_h_deg / 2, res_h))
        av = np.deg2rad(np.linspace(-fov_v_deg / 2, fov_v_deg / 2, res_v))
        V, H = np.meshgrid(av, ah, indexing="ij")
        self._set_dirs(np.stack([np.cos(V) * np.cos(H), np.cos(V) * np.sin(H), np.sin(V)], -1))
        self.max_range = max_range


class RisleyPrismLidarGenerator(_Generator):
    """Risley-prism scanning LiDAR (a Livox-style rosette): ``n_points``
    beams from two counter-rotating prism phases ``f1``, ``f2`` over a cone
    of ``fov_deg``."""

    def __init__(self, n_points: int = 24000, fov_deg: float = 70.0,
                 f1: float = 7294.0, f2: float = -4664.0, max_range: float = 260.0):
        t = np.arange(n_points) / n_points
        z = np.exp(1j * 2 * np.pi * f1 * t) + np.exp(1j * 2 * np.pi * f2 * t)
        theta = np.abs(np.deg2rad(fov_deg / 2) * 0.5 * np.abs(z))
        phi = np.angle(z)
        self._set_dirs(np.stack([np.cos(theta) * np.ones_like(phi),
                                 np.sin(theta) * np.cos(phi),
                                 np.sin(theta) * np.sin(phi)], -1))
        self.max_range = max_range


def make_lidar_generator(lidar_model: str, **kw) -> _Generator:
    """The generator of ``lidar_model``: a surround preset's name,
    ``solid_state`` / ``rs_m1``, or ``risley_prism`` / ``livox`` /
    ``horizon``; ``kw`` go to its constructor. Another name raises."""
    if lidar_model in SurroundLidarGenerator.PRESETS:
        return SurroundLidarGenerator(lidar_model, **kw)
    if lidar_model in ("solid_state", "rs_m1"):
        return SolidStateLidarGenerator(**kw)
    if lidar_model in ("risley_prism", "livox", "horizon"):
        return RisleyPrismLidarGenerator(**kw)
    raise ValueError(f"unknown lidar_model {lidar_model}")
