"""Scene data loading: the image, mask and LiDAR caches of one scene, the
pixel and LiDAR samplers of training and the whole frames of evaluation (port
of neuralsim_tpu/dataio/dataloader.py:24-115, 151-243; numpy, on the host).

The pixel sampler emits (camera, frame, pixel) tuples with their ground
truth; the trainer lifts them to world rays through the frozen scene graph.
Its draws are numpy's, as in the JAX package (the native C++ batch assembler
of the JAX package, taken there only without importance sampling, is not
ported: the numpy path serves both).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..scene import Scene


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class SceneDataLoader:
    """Preloads one scene's images, occupancy masks and (filtered) LiDAR beams
    from a dataset (``get_image``, ``get_occupancy_mask``, ``get_lidar``)."""

    def __init__(self, scene: Scene, dataset, *, with_mask: bool = True,
                 with_lidar: bool = False, filter_lidar_in_cams: bool = False,
                 filter_lidar_max_range: float = 0.0):
        self.scene = scene
        self.dataset = dataset
        self.cam_ids = [oid for oid in scene.observer_ids()
                        if scene.observers[oid].class_name == "Camera"]
        self.lidar_ids = [oid for oid in scene.observer_ids()
                          if scene.observers[oid].class_name == "RaysLidar"]
        self.n_frames = scene.n_frames
        self.with_mask = with_mask
        self.with_lidar = with_lidar
        self.filter_lidar_in_cams = filter_lidar_in_cams
        self.filter_lidar_max_range = filter_lidar_max_range
        self.images: Dict[Tuple[str, int], np.ndarray] = {}
        self.masks: Dict[Tuple[str, int], np.ndarray] = {}
        self.lidars: Dict[Tuple[str, int], Dict[str, np.ndarray]] = {}
        for cid in self.cam_ids:
            for fi in range(self.n_frames):
                self.images[(cid, fi)] = dataset.get_image(scene.id, cid, fi)
                if with_mask:
                    m = dataset.get_occupancy_mask(scene.id, cid, fi)
                    if m is not None:
                        self.masks[(cid, fi)] = m
        if with_lidar:
            for lid in self.lidar_ids:
                for fi in range(self.n_frames):
                    ld = dataset.get_lidar(scene.id, lid, fi)
                    if ld is not None:
                        self.lidars[(lid, fi)] = self._filter_lidar(lid, fi, ld)

    def _filter_lidar(self, lid: str, fi: int, ld: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """Keep the beams with a return, within ``filter_lidar_max_range``
        where set, and with ``filter_lidar_in_cams`` only those whose hit
        projects into some camera's frame."""
        keep = ld["ranges"] > 0
        if self.filter_lidar_max_range > 0:
            keep &= ld["ranges"] <= self.filter_lidar_max_range
        if self.filter_lidar_in_cams and self.cam_ids:
            fr = self.scene.slice_at(fi)
            l2w = _np(fr.world_transform(lid))
            pts_w = (ld["rays_o"] + ld["ranges"][:, None] * ld["rays_d"]) @ l2w[:3, :3].T \
                + l2w[:3, 3]
            in_any = np.zeros(len(pts_w), bool)
            for cid in self.cam_ids:
                c2w = _np(fr.world_transform(cid))
                intr = _np(fr.data(cid)["intr"])
                H, W = (int(v) for v in _np(fr.data(cid)["hw"]))
                w2c = np.linalg.inv(c2w)
                pc = pts_w @ w2c[:3, :3].T + w2c[:3, 3]
                z = pc[:, 2]
                uv = (pc[:, :2] / np.clip(z[:, None], 1e-9, None)) @ intr[:2, :2].T + intr[:2, 2]
                in_any |= ((z > 1e-3) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                           & (uv[:, 1] >= 0) & (uv[:, 1] < H))
            keep &= in_any
        if keep.all():
            return ld
        return {k: v[keep] for k, v in ld.items()}

    def image(self, cam_id: str, fi: int) -> np.ndarray:
        return self.images[(cam_id, fi)]

    def image_wh(self, cam_id: str) -> Tuple[int, int]:
        img = self.image(cam_id, 0)
        return img.shape[1], img.shape[0]


class PixelSampler:
    """Random (camera, frame, pixel) batches with their ground truth: uniform,
    or from an :class:`~neuralsim_torch.training.error_map.ImpSampler`."""

    def __init__(self, loader: SceneDataLoader, *, n_rays: int = 4096, seed: int = 0,
                 imp_sampler=None):
        self.loader = loader
        self.n_rays = n_rays
        self.rng = np.random.default_rng(seed)
        self.imp_sampler = imp_sampler

    def sample(self, n_rays: Optional[int] = None) -> Dict[str, Any]:
        n = n_rays or self.n_rays
        L = self.loader
        cam_id = L.cam_ids[self.rng.integers(0, len(L.cam_ids))]
        W, H = L.image_wh(cam_id)
        if self.imp_sampler is not None:
            fidx, xs, ys = self.imp_sampler.sample(self.rng, cam_id, n, H, W)
        else:
            fidx = self.rng.integers(0, L.n_frames, n)
            xs = self.rng.integers(0, W, n)
            ys = self.rng.integers(0, H, n)
        rgb = np.empty((n, 3), np.float32)
        mask = np.empty((n,), np.float32)
        has_mask = bool(L.masks)
        for fi in np.unique(fidx):
            sel = fidx == fi
            rgb[sel] = L.image(cam_id, int(fi))[ys[sel], xs[sel]]
            if has_mask:
                mask[sel] = L.masks[(cam_id, int(fi))][ys[sel], xs[sel]]
        out = {"cam_id": cam_id, "rays_fidx": fidx.astype(np.int32),
               "rays_xy": np.stack([xs + 0.5, ys + 0.5], -1).astype(np.float32),
               "rays_sel": np.stack([ys, xs], -1), "image_rgb": rgb}
        if has_mask:
            out["image_occupancy_mask"] = mask
        return out


class LidarSampler:
    """LiDAR beam batches: one frame and one sensor (each as likely) a batch,
    beams drawn with replacement."""

    def __init__(self, loader: SceneDataLoader, *, n_rays: int = 4096, seed: int = 0):
        self.loader = loader
        self.n_rays = n_rays
        self.rng = np.random.default_rng(seed + 1)
        n = len(loader.lidar_ids)
        self.weights = np.full(n, 1.0 / max(n, 1))

    def sample(self, n_rays: Optional[int] = None) -> Optional[Dict[str, Any]]:
        n = n_rays or self.n_rays
        L = self.loader
        if not L.lidars:
            return None
        fi = int(self.rng.integers(0, L.n_frames))
        lid = L.lidar_ids[int(self.rng.choice(len(L.lidar_ids), p=self.weights))]
        ld = L.lidars.get((lid, fi))
        if ld is None:
            return None
        sel = self.rng.integers(0, ld["rays_d"].shape[0], n)
        return {"lidar_id": lid, "rays_fidx": np.full(n, fi, np.int32),
                "rays_o_local": ld["rays_o"][sel], "rays_d_local": ld["rays_d"][sel],
                "ranges": ld["ranges"][sel]}


class ImageSampler:
    """Whole frames for evaluation, every ``downscale``-th pixel of each row
    and column, each ray through the centre of its downscaled pixel."""

    def __init__(self, loader: SceneDataLoader, downscale: int = 1):
        self.loader = loader
        self.downscale = downscale

    def get(self, cam_id: str, fi: int) -> Dict[str, Any]:
        """{cam_id, fi, hw, rays_xy [H W, 2], image_rgb [H W, 3] and, where
        the loader has it, image_occupancy_mask [H W]}, rows in row order."""
        img = self.loader.image(cam_id, fi)
        s = self.downscale
        if s > 1:
            img = img[::s, ::s]
        H, W = img.shape[:2]
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        out = {"cam_id": cam_id, "fi": fi, "hw": (H, W),
               "rays_xy": np.stack([xs * s + 0.5 * s, ys * s + 0.5 * s],
                                   -1).reshape(-1, 2).astype(np.float32),
               "image_rgb": img.reshape(-1, 3)}
        m = self.loader.masks.get((cam_id, fi))
        if m is not None:
            out["image_occupancy_mask"] = m[::s, ::s].reshape(-1)
        return out
