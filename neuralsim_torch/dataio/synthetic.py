"""The procedural synthetic object scene: cameras, rays and analytic ground
truth (port of neuralsim_tpu/dataio/synthetic.py:1-170; numpy only).

The scene is an analytic SDF (two spheres and a torus), Lambertian-shaded with
a smooth albedo over a sky gradient, so training needs no data files. Cameras
sit on a spiral around the origin and look at it; pinhole intrinsics; OpenCV
convention (x right, y down, z forward). The object's transform is the
identity, so the rays are already in object coordinates.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np


def _sdf_scene(p: np.ndarray) -> np.ndarray:
    """Union of a sphere (r .45 at 0), a sphere (r .22 at (.42, .3, 0)) and a
    torus in the xz plane. p: [..., 3]."""
    d1 = np.linalg.norm(p, axis=-1) - 0.45
    d2 = np.linalg.norm(p - np.array([0.42, 0.3, 0.0]), axis=-1) - 0.22
    q = np.stack([np.linalg.norm(p[..., [0, 2]], axis=-1) - 0.55, p[..., 1] + 0.35], -1)
    d3 = np.linalg.norm(q, axis=-1) - 0.08
    return np.minimum(np.minimum(d1, d2), d3)


def _sdf_grad(p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    g = np.stack([
        _sdf_scene(p + np.array([eps, 0, 0])) - _sdf_scene(p - np.array([eps, 0, 0])),
        _sdf_scene(p + np.array([0, eps, 0])) - _sdf_scene(p - np.array([0, eps, 0])),
        _sdf_scene(p + np.array([0, 0, eps])) - _sdf_scene(p - np.array([0, 0, eps])),
    ], axis=-1) / (2 * eps)
    return g / np.clip(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9, None)


def _albedo(p: np.ndarray) -> np.ndarray:
    """Smooth position-dependent albedo."""
    return 0.5 + 0.45 * np.stack([np.sin(4.0 * p[..., 0]),
                                  np.sin(4.0 * p[..., 1] + 2.0),
                                  np.sin(4.0 * p[..., 2] + 4.0)], axis=-1)


def _sphere_trace(rays_o: np.ndarray, rays_d: np.ndarray, n_steps: int = 96
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(t_hit, hit mask) by sphere tracing the analytic SDF."""
    t = np.full(rays_o.shape[:-1], 0.05, np.float64)
    for _ in range(n_steps):
        p = rays_o + t[..., None] * rays_d
        t = t + np.clip(_sdf_scene(p), -0.05, 0.25)
    p = rays_o + t[..., None] * rays_d
    hit = (np.abs(_sdf_scene(p)) < 2e-3) & (t < 6.0)
    return t.astype(np.float32), hit


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenCV-convention camera-to-world [4, 4]."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w.astype(np.float32)


class SyntheticObjectDataset:
    """The camera rig of the synthetic object scene and its ground-truth
    frames (image, occupancy mask, depth), rendered on first use."""

    def __init__(self, n_frames: int = 24, H: int = 64, W: int = 64,
                 radius: float = 2.0, fov_deg: float = 45.0):
        self.n_frames, self.H, self.W = n_frames, H, W
        f = 0.5 * W / math.tan(math.radians(fov_deg) / 2)
        self.intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        self.c2ws = np.stack([
            look_at(np.array([radius * math.cos(2 * math.pi * i / n_frames),
                              -0.6 + 0.4 * math.sin(4 * math.pi * i / n_frames),
                              radius * math.sin(2 * math.pi * i / n_frames)]),
                    np.zeros(3))
            for i in range(n_frames)], axis=0)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def frame_rays(self, fi: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-pixel (origins, unit directions), each [H, W, 3] float32."""
        u, v = np.meshgrid(np.arange(self.W) + 0.5, np.arange(self.H) + 0.5)
        x = (u - self.intr[0, 2]) / self.intr[0, 0]
        y = (v - self.intr[1, 2]) / self.intr[1, 1]
        dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        c2w = self.c2ws[fi]
        d = dirs @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2w[:3, 3], d.shape)
        return o.astype(np.float32), d.astype(np.float32)

    def sky_color(self, dirs: np.ndarray) -> np.ndarray:
        t = 0.5 * (dirs[..., 1] + 1.0)
        return ((1.0 - t[..., None]) * np.array([0.9, 0.95, 1.0])
                + t[..., None] * np.array([0.2, 0.35, 0.7])).astype(np.float32)

    def render_frame(self, fi: int) -> Dict[str, np.ndarray]:
        """Ground truth of frame ``fi``: image_rgb [H, W, 3], image_occupancy_mask
        and image_depth [H, W], with the frame's rays."""
        if fi in self._cache:
            return self._cache[fi]
        o, d = self.frame_rays(fi)
        t, hit = _sphere_trace(o.astype(np.float64), d.astype(np.float64))
        p = o + t[..., None] * d
        n = _sdf_grad(p)
        light = np.array([0.5, -0.8, 0.3])
        light = light / np.linalg.norm(light)
        lambert = np.clip(-(n * light).sum(-1), 0.0, 1.0) * 0.8 + 0.2
        rgb_fg = _albedo(p) * lambert[..., None]
        rgb = np.where(hit[..., None], rgb_fg, self.sky_color(d)).astype(np.float32)
        out = {"image_rgb": np.clip(rgb, 0, 1),
               "image_occupancy_mask": hit.astype(np.float32),
               "image_depth": np.where(hit, t, 0.0).astype(np.float32),
               "rays_o": o, "rays_d": d}
        self._cache[fi] = out
        return out

    def sample_pixels(self, rng: np.random.Generator, n: int,
                      frames: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """A random (frame, pixel) ray batch with its ground truth."""
        fidx = (rng.integers(0, self.n_frames, n) if frames is None
                else rng.choice(frames, n))
        ys = rng.integers(0, self.H, n)
        xs = rng.integers(0, self.W, n)
        outs = {"rays_o": [], "rays_d": [], "image_rgb": [],
                "image_occupancy_mask": [], "image_depth": []}
        for fi in np.unique(fidx):
            fr = self.render_frame(int(fi))
            sel = fidx == fi
            for k, v in outs.items():
                v.append(fr[k][ys[sel], xs[sel]])
        return {k: np.concatenate(v, 0) for k, v in outs.items()}
