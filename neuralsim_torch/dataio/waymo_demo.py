"""The fabricated Waymo-layout driving sequence, in memory (port of
neuralsim_tpu/dataio/waymo_demo.py:26-142, 150-238; numpy).

An ego car drives +x over a ground plane; K vehicles (spheres in a unit-cube
canonical frame, like preprocessed box tracks) are parked, lead or come the
other way. ``DemoDrive`` is the analytic scene, unchanged. ``demo_scenario``
returns the scenario dict that the JAX package's ``build_demo_sequence``
saves as ``scenario.pt`` (the universal scenario format: an ego car with the
children ``camera_FRONT`` and ``lidar_TOP``, and one ``Vehicle`` object per
track), without tracing or writing images, masks or LiDAR: a render needs only
the poses, the intrinsics and the tracks. :func:`ground_sdf_tensor` is the
drive's static ground, on which the street's occupancy grid converges.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

# camera-to-ego rotation, OpenCV convention (x right, y down, z forward),
# ego +x forward / +y left / +z up
R_CAM2EGO = np.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, -1.0, 0.0]], np.float32)


class DemoDrive:
    """Analytic driving scene: ego trajectory, vehicle tracks and the SDF."""

    def __init__(self, n_frames: int = 8, speed: float = 1.5, n_vehicles: int = 3,
                 seed: int = 0):
        self.T = n_frames
        self.speed = speed
        self.K = n_vehicles
        rng = np.random.default_rng(seed)
        # vehicle k: lane offset, start x, velocity, radius
        lanes = [-2.2, 2.2, 0.0, -2.2, 2.2]
        self.veh = []
        for k in range(n_vehicles):
            self.veh.append({
                "y": lanes[k % len(lanes)],
                "x0": 6.0 + 4.0 * k + rng.uniform(-1, 1),
                "v": [0.0, speed * 0.7, -speed * 1.5][k % 3],
                "r": 0.9 + 0.15 * (k % 2),
            })

    def ego_pose(self, fi: int) -> np.ndarray:
        p = np.eye(4, dtype=np.float32)
        p[0, 3] = self.speed * fi
        p[2, 3] = 1.8
        return p

    def veh_center(self, k: int, fi: int) -> np.ndarray:
        v = self.veh[k]
        return np.array([v["x0"] + v["v"] * fi, v["y"], v["r"]], np.float32)

    def sdf(self, p: np.ndarray, fi: int) -> np.ndarray:
        d = p[..., 2]                                       # ground z=0
        for k in range(self.K):
            c = self.veh_center(k, fi)
            d = np.minimum(d, np.linalg.norm(p - c, axis=-1) - self.veh[k]["r"])
        return d


def ground_sdf_tensor(p: torch.Tensor) -> torch.Tensor:
    """The drive's static ground plane z = 0 as an SDF of points [..., 3], on
    their device (the vehicles move, so the street's grid holds the ground)."""
    return p[..., 2].float()


def demo_scenario(n_frames: int = 8, H: int = 80, W: int = 120, n_vehicles: int = 3,
                  speed: float = 1.5, seed: int = 0, seq_name: str = "demo_drive",
                  fov_deg: float = 62.0) -> Dict[str, Any]:
    """The scenario dict of ``build_demo_sequence``'s sequence, built in
    memory from the same arguments (numpy arrays for its tensors)."""
    drive = DemoDrive(n_frames, speed, n_vehicles, seed)
    f = 0.5 * W / math.tan(math.radians(fov_deg) / 2)
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam2ego = np.eye(4, dtype=np.float32)
    cam2ego[:3, :3] = R_CAM2EGO
    cam2ego[:3, 3] = [1.2, 0.0, 0.2]          # hood-mounted, slightly up
    lidar2ego = np.eye(4, dtype=np.float32)
    lidar2ego[:3, 3] = [0.0, 0.0, 0.6]
    ego = np.stack([drive.ego_pose(fi) for fi in range(n_frames)])
    ts = np.arange(n_frames, dtype=np.float64) * 0.1

    objects: Dict[str, Dict] = {}
    for k in range(n_vehicles):
        tf = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
        for fi in range(n_frames):
            tf[fi, :3, 3] = drive.veh_center(k, fi)
        r = drive.veh[k]["r"]
        objects[f"veh_{k}"] = {"class_name": "Vehicle", "segments": [{
            "start_frame": 0, "n_frames": n_frames,
            "data": {"transform": tf,
                     "scale": np.full((n_frames, 3), r, np.float32),
                     "valid": np.ones((n_frames,), bool)}}]}

    return {
        "scene_id": seq_name,
        "metas": {"num_frames": n_frames, "up_vec": "+z", "ego_car_id": "ego_car"},
        "observers": {
            "ego_car": {"class_name": "EgoVehicle", "n_frames": n_frames,
                        "data": {"transform": ego, "global_ts": ts},
                        "children": {
                            "camera_FRONT": {
                                "class_name": "Camera", "n_frames": n_frames,
                                "data": {
                                    "transform": np.tile(cam2ego, (n_frames, 1, 1)),
                                    "intr": np.tile(intr, (n_frames, 1, 1)),
                                    "hw": np.tile(np.array([H, W], np.int32), (n_frames, 1)),
                                    "global_ts": ts,
                                }},
                            "lidar_TOP": {
                                "class_name": "RaysLidar", "n_frames": n_frames,
                                "data": {"transform": np.tile(lidar2ego, (n_frames, 1, 1)),
                                         "global_ts": ts}},
                        }},
        },
        "objects": objects,
    }
