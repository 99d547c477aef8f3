"""The fabricated Waymo-layout driving sequence, in memory (port of
neuralsim_tpu/dataio/waymo_demo.py:26-240 and of the reader's occupancy and
semantic masks and its semantic ids, neuralsim_tpu/dataio/waymo.py:30-33,
137-150; numpy).

An ego car drives +x over a ground plane; K vehicles (spheres in a unit-cube
canonical frame, like preprocessed box tracks) are parked, lead or come the
other way. ``DemoDrive`` is the analytic scene, unchanged, sphere-traced for
the images, masks and LiDAR ranges. ``demo_scenario`` returns the scenario
dict that the JAX package's ``build_demo_sequence`` saves as ``scenario.pt``
(the universal scenario format: an ego car with the children ``camera_FRONT``
and ``lidar_TOP``, and one ``Vehicle`` object per track); a render needs only
that. ``demo_sequence`` adds the data of training, in memory: the camera
frames (the writer's uint8 values over 255, as its reader returns them, but
without the JPEG compression), the occupancy masks (semantic id != sky) and
the LiDAR beams with their ranges (0 where a beam hits nothing); its
semantic ids answer ``get_semantic_mask``, from which the multi-object
evaluation tells the ground pixels.
:func:`ground_sdf_tensor` is the drive's static ground, on which the street's
occupancy grid converges.

:func:`build_demo_sequence` writes the same sequence to disk in the Waymo
layout that ``dataio.waymo.WaymoDataset`` reads (port of
neuralsim_tpu/dataio/waymo_demo.py:138-259): the frames as JPEG at quality
95 (Pillow), the semantic ids and the LiDAR as ``.npz``, the scenario as a
torch-pickled ``scenario.pt``. From the command line::

    python -m neuralsim_torch.dataio.waymo_demo --root data/waymo_demo
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .scene_dataset import SceneDataset

# camera-to-ego rotation, OpenCV convention (x right, y down, z forward),
# ego +x forward / +y left / +z up
R_CAM2EGO = np.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, -1.0, 0.0]], np.float32)

VEH_COLORS = np.array([[0.85, 0.25, 0.2], [0.2, 0.4, 0.85],
                       [0.9, 0.75, 0.2], [0.3, 0.75, 0.4],
                       [0.7, 0.3, 0.8]], np.float32)
# Waymo semantic ids of the reference's mask taxonomy (cityscapes trainIds:
# sky 10, human 11/12, vehicle 13..18, dynamic their union)
SKY_ID = 10
HUMAN_IDS = (11, 12)
VEHICLE_IDS = (13, 14, 15, 16, 17, 18)
DYNAMIC_IDS = HUMAN_IDS + VEHICLE_IDS


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

    def albedo(self, p: np.ndarray, fi: int) -> np.ndarray:
        out = np.empty(p.shape, np.float32)
        # road: gray with dashed center-line stripes
        stripe = ((np.abs(p[..., 1]) < 0.15)
                  & ((p[..., 0] % 3.0) < 1.5))
        road = np.where(stripe[..., None],
                        np.array([0.85, 0.8, 0.3], np.float32),
                        np.array([0.35, 0.35, 0.37], np.float32)
                        + 0.05 * np.cos(p[..., :1] * 2.0))
        out[:] = road
        best = p[..., 2].copy()                             # ground distance
        for k in range(self.K):
            c = self.veh_center(k, fi)
            dk = np.linalg.norm(p - c, axis=-1) - self.veh[k]["r"]
            sel = dk < best
            out[sel] = VEH_COLORS[k % len(VEH_COLORS)]
            best = np.minimum(best, dk)
        return out

    def semantic(self, p: np.ndarray, hit: np.ndarray, fi: int) -> np.ndarray:
        sem = np.zeros(hit.shape, np.uint8)                 # road/other = 0
        sem[~hit] = 10                                      # sky
        best = np.where(hit, p[..., 2], np.inf)
        for k in range(self.K):
            c = self.veh_center(k, fi)
            dk = np.linalg.norm(p - c, axis=-1) - self.veh[k]["r"]
            sem[hit & (dk < best)] = 13                     # vehicle
            best = np.minimum(best, dk)
        return sem

    def trace(self, o: np.ndarray, d: np.ndarray, fi: int, max_t=60.0):
        t = np.full(d.shape[:-1], 0.05, np.float64)
        for _ in range(96):
            p = o + t[..., None] * d
            t = t + np.clip(self.sdf(p, fi), -0.1, 1.0)
            t = np.minimum(t, max_t)
        p = o + t[..., None] * d
        hit = (np.abs(self.sdf(p, fi)) < 5e-3) & (t < max_t * 0.99)
        return p, t, hit

    def shade(self, p, d, hit, fi) -> np.ndarray:
        eps = 1e-3
        g = np.stack([self.sdf(p + np.array([eps, 0, 0]), fi)
                      - self.sdf(p - np.array([eps, 0, 0]), fi),
                      self.sdf(p + np.array([0, eps, 0]), fi)
                      - self.sdf(p - np.array([0, eps, 0]), fi),
                      self.sdf(p + np.array([0, 0, eps]), fi)
                      - self.sdf(p - np.array([0, 0, eps]), fi)], -1)
        n = g / np.clip(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9, None)
        light = np.array([0.3, 0.25, -0.91])
        light /= np.linalg.norm(light)
        lam = np.clip(-(n * light).sum(-1), 0, 1) * 0.7 + 0.3
        rgb_fg = self.albedo(p, fi) * lam[..., None]
        # sky: horizon band (the "distant" content) + zenith gradient
        z01 = np.clip(0.5 * (d[..., 2] + 1.0), 0, 1)
        horizon = np.exp(-np.abs(d[..., 2]) * 14.0)
        sky = ((1 - z01[..., None]) * np.array([0.9, 0.85, 0.75])
               + z01[..., None] * np.array([0.35, 0.55, 0.9]))
        sky = sky * (1 - horizon[..., None]) \
            + horizon[..., None] * np.array([0.75, 0.6, 0.5])
        return np.where(hit[..., None], rgb_fg, sky).astype(np.float32)


def ground_sdf_tensor(p: torch.Tensor) -> torch.Tensor:
    """The drive's static ground plane z = 0 as an SDF of points [..., 3], on
    their device (the vehicles move, so the street's grid holds the ground)."""
    return p[..., 2].float()


def _rig(W: int, H: int, fov_deg: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(intrinsics, camera-to-ego, LiDAR-to-ego) of the demo car."""
    f = 0.5 * W / math.tan(math.radians(fov_deg) / 2)
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cam2ego = np.eye(4, dtype=np.float32)
    cam2ego[:3, :3] = R_CAM2EGO
    cam2ego[:3, 3] = [1.2, 0.0, 0.2]          # hood-mounted, slightly up
    lidar2ego = np.eye(4, dtype=np.float32)
    lidar2ego[:3, 3] = [0.0, 0.0, 0.6]
    return intr, cam2ego, lidar2ego


def demo_scenario(n_frames: int = 8, H: int = 80, W: int = 120, n_vehicles: int = 3,
                  speed: float = 1.5, seed: int = 0, seq_name: str = "demo_drive",
                  fov_deg: float = 62.0) -> Dict[str, Any]:
    """The scenario dict of ``build_demo_sequence``'s sequence, built in
    memory from the same arguments (numpy arrays for its tensors)."""
    drive = DemoDrive(n_frames, speed, n_vehicles, seed)
    intr, cam2ego, lidar2ego = _rig(W, H, fov_deg)
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


def beams_local(lidar_hw: Tuple[int, int] = (12, 64)) -> np.ndarray:
    """The demo LiDAR's unit beams in its own frame [lH * lW, 3], row by row."""
    lH, lW = lidar_hw
    az = np.linspace(-math.pi * 0.4, math.pi * 0.4, lW)
    el = np.linspace(-0.35, 0.05, lH)
    azg, elg = np.meshgrid(az, el)
    return np.stack([np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg),
                     np.sin(elg)], -1).reshape(-1, 3).astype(np.float32)


def camera_frame(drive: DemoDrive, fi: int, H: int = 80, W: int = 120,
                 fov_deg: float = 62.0) -> Tuple[np.ndarray, np.ndarray]:
    """Frame ``fi`` of the front camera, traced: (rgb [H, W, 3] float32 before
    quantising, semantic ids [H, W] uint8)."""
    intr, cam2ego, _ = _rig(W, H, fov_deg)
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs_cam = np.stack([(u - intr[0, 2]) / intr[0, 0], (v - intr[1, 2]) / intr[1, 1],
                         np.ones_like(u)], -1)
    c2w = drive.ego_pose(fi) @ cam2ego
    d = dirs_cam @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float64)
    p, _, hit = drive.trace(o, d, fi)
    return drive.shade(p, d, hit, fi), drive.semantic(p, hit, fi)


def lidar_ranges(drive: DemoDrive, fi: int, beams: np.ndarray) -> np.ndarray:
    """Each beam's range at frame ``fi`` [n], 0 where it hits nothing."""
    _, _, lidar2ego = _rig(1, 1, 62.0)
    l2w = drive.ego_pose(fi) @ lidar2ego
    dw = beams @ l2w[:3, :3].T
    ow = np.broadcast_to(l2w[:3, 3], dw.shape).astype(np.float64)
    _, t_l, hit_l = drive.trace(ow, dw, fi)
    return np.where(hit_l, t_l, 0.0).astype(np.float32)


class DemoSequence(SceneDataset):
    """The demo drive's sequence in memory, with the reader's interface that
    the data loader and the evaluation use: the scenario, and per camera and
    frame the image, the occupancy mask and the semantic mask, per LiDAR and
    frame its beams."""

    def __init__(self, scenario: Dict[str, Any], images: Dict[Tuple[str, int], np.ndarray],
                 semantics: Dict[Tuple[str, int], np.ndarray],
                 lidars: Dict[Tuple[str, int], Dict[str, np.ndarray]]):
        self.scenario = scenario
        self.images = images
        self.semantics = semantics
        self.lidars = lidars

    def scene_ids(self):
        return [self.scenario["scene_id"]]

    def get_scenario(self, scene_id: Optional[str] = None) -> Dict[str, Any]:
        return self.scenario

    def get_image(self, scene_id: str, cam_id: str, frame_index: int) -> np.ndarray:
        return self.images[(cam_id, frame_index)]

    def get_occupancy_mask(self, scene_id: str, cam_id: str, frame_index: int
                           ) -> Optional[np.ndarray]:
        sem = self.semantics.get((cam_id, frame_index))
        return None if sem is None else (sem != SKY_ID).astype(np.float32)

    def get_semantic_mask(self, scene_id: str, cam_id: str, frame_index: int,
                          kind: str = "all") -> Optional[np.ndarray]:
        """The semantic ids [H, W] (``kind`` "all"), or where they are of
        one kind: "sky", "human", "vehicle" or "dynamic" (bool [H, W])."""
        sem = self.semantics.get((cam_id, frame_index))
        if sem is None or kind == "all":
            return sem
        ids = {"sky": (SKY_ID,), "human": HUMAN_IDS, "vehicle": VEHICLE_IDS,
               "dynamic": DYNAMIC_IDS}[kind]
        return np.isin(sem, ids)

    def get_lidar(self, scene_id: str, lidar_id: str, frame_index: int
                  ) -> Optional[Dict[str, np.ndarray]]:
        return self.lidars.get((lidar_id, frame_index))


def demo_sequence(n_frames: int = 8, H: int = 80, W: int = 120, n_vehicles: int = 3,
                  speed: float = 1.5, seed: int = 0, seq_name: str = "demo_drive",
                  fov_deg: float = 62.0, lidar_hw: Tuple[int, int] = (12, 64)
                  ) -> DemoSequence:
    """The sequence that ``build_demo_sequence`` writes, built in memory from
    the same arguments: its scenario, and for every frame the front camera's
    image as the writer quantises it (``uint8(clip(rgb, 0, 1) * 255) / 255``;
    no JPEG compression), its semantic ids, and the LiDAR's beams with their
    ranges."""
    drive = DemoDrive(n_frames, speed, n_vehicles, seed)
    beams = beams_local(lidar_hw)
    images, semantics, lidars = {}, {}, {}
    for fi in range(n_frames):
        rgb, sem = camera_frame(drive, fi, H, W, fov_deg)
        images[("camera_FRONT", fi)] = \
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0
        semantics[("camera_FRONT", fi)] = sem
        lidars[("lidar_TOP", fi)] = {"rays_o": np.zeros_like(beams), "rays_d": beams,
                                     "ranges": lidar_ranges(drive, fi, beams)}
    scenario = demo_scenario(n_frames, H, W, n_vehicles, speed, seed, seq_name, fov_deg)
    return DemoSequence(scenario, images, semantics, lidars)


def build_demo_sequence(root: str, seq_name: str = "demo_drive", *, n_frames: int = 8,
                        H: int = 80, W: int = 120, n_vehicles: int = 3,
                        fov_deg: float = 62.0, lidar_hw: Tuple[int, int] = (12, 64),
                        speed: float = 1.5, seed: int = 0) -> str:
    """Write the sequence of ``demo_sequence`` (the same arguments) under
    ``root/seq_name`` in the Waymo layout; returns its path. Each frame's
    image is the writer's ``uint8(clip(rgb, 0, 1) * 255)`` as a JPEG of
    quality 95, so it reads back within the JPEG's error of the in-memory
    image; masks, LiDAR and scenario read back exactly."""
    from PIL import Image
    drive = DemoDrive(n_frames, speed, n_vehicles, seed)
    seq_dir = os.path.join(root, seq_name)
    for sub in ("images/camera_FRONT", "lidars/lidar_TOP", "masks/camera_FRONT"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    beams = beams_local(tuple(lidar_hw))
    for fi in range(n_frames):
        rgb, sem = camera_frame(drive, fi, H, W, fov_deg)
        Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(seq_dir, "images", "camera_FRONT", f"{fi:08d}.jpg"), quality=95)
        np.savez_compressed(os.path.join(seq_dir, "masks", "camera_FRONT", f"{fi:08d}.npz"),
                            mask=sem)
        np.savez_compressed(os.path.join(seq_dir, "lidars", "lidar_TOP", f"{fi:08d}.npz"),
                            rays_o=np.zeros_like(beams), rays_d=beams,
                            ranges=lidar_ranges(drive, fi, beams))
    torch.save(demo_scenario(n_frames, H, W, n_vehicles, speed, seed, seq_name, fov_deg),
               os.path.join(seq_dir, "scenario.pt"))
    return seq_dir


def main(argv: Optional[List[str]] = None) -> str:
    import argparse
    ap = argparse.ArgumentParser("waymo_demo", allow_abbrev=False)
    ap.add_argument("--root", default="data/waymo_demo")
    ap.add_argument("--seq", default="demo_drive")
    ap.add_argument("--n_frames", type=int, default=8)
    ap.add_argument("--H", type=int, default=80)
    ap.add_argument("--W", type=int, default=120)
    ap.add_argument("--n_vehicles", type=int, default=3)
    a = ap.parse_args(argv)
    out = build_demo_sequence(a.root, a.seq, n_frames=a.n_frames, H=a.H, W=a.W,
                              n_vehicles=a.n_vehicles)
    print(out)
    return out


if __name__ == "__main__":
    main()
