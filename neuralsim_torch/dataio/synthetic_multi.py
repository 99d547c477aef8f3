"""The procedural multi-object scene: two spheres moving over a ground plane
under a sky (port of neuralsim_tpu/dataio/synthetic_multi.py; numpy).

A scene graph with two moving ``Vehicle`` objects (one shared model in the
configs) and a static ``Street`` node, analytic ground-truth frames
(sphere-traced images, occupancy masks, depths and rays) and the scenario in
the universal format with per-frame object poses. The accessors of a scene
dataset (``get_image``, ``get_occupancy_mask``, ``get_lidar``) feed the data
loader's pixel sampler; ``sample_pixels`` draws world-ray batches directly.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from .synthetic import look_at


def _sphere(p, c, r):
    return np.linalg.norm(p - c, axis=-1) - r


class SyntheticMultiObjectDataset:
    """Two spheres orbiting + ground plane at z=-0.6 (world: z up)."""

    def __init__(self, n_frames: int = 8, H: int = 64, W: int = 64,
                 radius: float = 3.0, fov_deg: float = 55.0, **_):
        self.n_frames, self.H, self.W = n_frames, H, W
        f = 0.5 * W / math.tan(math.radians(fov_deg) / 2)
        self.intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        # camera orbits at height, always looking at origin; world z-up
        self.c2ws = np.stack([
            look_at(np.array([radius * math.cos(0.6 * i / n_frames * np.pi * 2),
                              radius * math.sin(0.6 * i / n_frames * np.pi * 2),
                              1.2]),
                    np.array([0.0, 0.0, 0.0]), up=(0, 0, 1))
            for i in range(n_frames)], axis=0)
        self._cache: Dict[int, Dict] = {}

    # object trajectories (world frame)
    def obj_centers(self, fi: int):
        t = fi / max(self.n_frames - 1, 1)
        c1 = np.array([0.8 * math.cos(t * np.pi), 0.8 * math.sin(t * np.pi), -0.1])
        c2 = np.array([-0.9 + 1.2 * t, -0.6, 0.05])
        return c1, c2

    R1, R2 = 0.35, 0.28
    GROUND_Z = -0.6

    def _scene_sdf(self, p: np.ndarray, fi: int) -> np.ndarray:
        c1, c2 = self.obj_centers(fi)
        return np.minimum(np.minimum(_sphere(p, c1, self.R1), _sphere(p, c2, self.R2)),
                          p[..., 2] - self.GROUND_Z)

    def _albedo(self, p: np.ndarray, fi: int) -> np.ndarray:
        c1, c2 = self.obj_centers(fi)
        d1 = _sphere(p, c1, self.R1)
        d2 = _sphere(p, c2, self.R2)
        dg = p[..., 2] - self.GROUND_Z
        a = np.where((d1 < d2)[..., None] & (d1 < dg)[..., None],
                     np.array([0.9, 0.3, 0.25]),
                     np.where((d2 < dg)[..., None], np.array([0.25, 0.45, 0.9]),
                              np.array([0.45, 0.42, 0.4])))
        return a.astype(np.float32)

    def render_frame(self, fi: int) -> Dict[str, np.ndarray]:
        if fi in self._cache:
            return self._cache[fi]
        H, W = self.H, self.W
        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        x = (u - self.intr[0, 2]) / self.intr[0, 0]
        y = (v - self.intr[1, 2]) / self.intr[1, 1]
        dirs = np.stack([x, y, np.ones_like(x)], -1)
        c2w = self.c2ws[fi]
        d = dirs @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float64)

        t = np.full(d.shape[:-1], 0.05)
        for _ in range(80):
            p = o + t[..., None] * d
            t = t + np.clip(self._scene_sdf(p, fi), -0.05, 0.3)
        p = o + t[..., None] * d
        hit = (np.abs(self._scene_sdf(p, fi)) < 3e-3) & (t < 12.0)
        eps = 1e-4
        g = np.stack([self._scene_sdf(p + np.array([eps, 0, 0]), fi)
                      - self._scene_sdf(p - np.array([eps, 0, 0]), fi),
                      self._scene_sdf(p + np.array([0, eps, 0]), fi)
                      - self._scene_sdf(p - np.array([0, eps, 0]), fi),
                      self._scene_sdf(p + np.array([0, 0, eps]), fi)
                      - self._scene_sdf(p - np.array([0, 0, eps]), fi)], -1)
        n = g / np.clip(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9, None)
        light = np.array([0.4, 0.2, -0.9])
        light /= np.linalg.norm(light)
        lam = np.clip(-(n * light).sum(-1), 0, 1) * 0.75 + 0.25
        rgb_fg = self._albedo(p, fi) * lam[..., None]
        sky_t = np.clip(0.5 * (d[..., 2] + 1.0), 0, 1)
        sky = ((1 - sky_t[..., None]) * np.array([0.95, 0.9, 0.8])
               + sky_t[..., None] * np.array([0.3, 0.5, 0.85]))
        rgb = np.where(hit[..., None], rgb_fg, sky).astype(np.float32)
        out = {"image_rgb": np.clip(rgb, 0, 1),
               "image_occupancy_mask": hit.astype(np.float32),
               "image_depth": np.where(hit, t, 0).astype(np.float32),
               "rays_o": o.astype(np.float32), "rays_d": d.astype(np.float32)}
        self._cache[fi] = out
        return out

    # -- scenario with per-frame object segments ------------------------------
    def get_scenario(self, scene_id: str = None) -> Dict:
        T = self.n_frames

        def obj_entry(get_center, radius):
            trs = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
            for fi in range(T):
                c1, c2 = self.obj_centers(fi)
                trs[fi, :3, 3] = get_center(c1, c2)
            return {"class_name": "Vehicle", "segments": [{
                "start_frame": 0, "n_frames": T,
                "data": {"transform": trs,
                         "scale": np.full((T, 3), radius, np.float32)}}]}

        ground = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
        ground[:, 2, 3] = self.GROUND_Z
        return {
            "scene_id": "synthetic_multi",
            "metas": {"num_frames": T, "up_vec": "+z"},
            "observers": {"camera_0": {
                "class_name": "Camera", "n_frames": T,
                "data": {"transform": self.c2ws,
                         "intr": np.tile(self.intr, (T, 1, 1)),
                         "hw": np.tile([self.H, self.W], (T, 1)),
                         "global_ts": np.arange(T, dtype=np.float32)}}},
            "objects": {
                "obj_a": obj_entry(lambda c1, c2: c1, self.R1 / 0.35 * 0.5),
                "obj_b": obj_entry(lambda c1, c2: c2, self.R2 / 0.35 * 0.5),
                "street": {"class_name": "Street", "segments": [{
                    "start_frame": 0, "n_frames": T,
                    "data": {"transform": ground,
                             "scale": np.ones((T, 3), np.float32)}}]},
            },
        }

    # -- SceneDataset-style accessors so SceneDataLoader/PixelSampler work
    # (the camera-pixel path: in-jit ray lifting, error maps, pose deltas)
    def scene_ids(self):
        return ["synthetic_multi"]

    def get_image(self, scene_id: str, cam_id: str, fi: int) -> np.ndarray:
        return self.render_frame(fi)["image_rgb"]

    def get_occupancy_mask(self, scene_id: str, cam_id: str, fi: int):
        return self.render_frame(fi)["image_occupancy_mask"]

    def get_lidar(self, scene_id: str, lidar_id: str, fi: int):
        return None

    def sample_pixels(self, rng, n: int) -> Dict[str, np.ndarray]:
        fidx = rng.integers(0, self.n_frames, n)
        ys = rng.integers(0, self.H, n)
        xs = rng.integers(0, self.W, n)
        outs = {k: [] for k in ("rays_o", "rays_d", "image_rgb",
                                "image_occupancy_mask", "rays_fidx")}
        for fi in np.unique(fidx):
            fr = self.render_frame(int(fi))
            sel = fidx == fi
            outs["rays_o"].append(fr["rays_o"][ys[sel], xs[sel]])
            outs["rays_d"].append(fr["rays_d"][ys[sel], xs[sel]])
            outs["image_rgb"].append(fr["image_rgb"][ys[sel], xs[sel]])
            outs["image_occupancy_mask"].append(
                fr["image_occupancy_mask"][ys[sel], xs[sel]])
            outs["rays_fidx"].append(np.full(sel.sum(), fi, np.int32))
        return {k: np.concatenate(v) for k, v in outs.items()}
