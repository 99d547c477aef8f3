"""The Waymo-layout reader: a sequence in the universal scenario format on
disk (port of neuralsim_tpu/dataio/waymo.py:36-192; numpy, on the host)::

    root/<seq_name>/
        scenario.pt                          (torch-pickled scenario dict)
        images/<cam_id>/<frame:08d>.jpg      (or .png, .jpeg)
        lidars/<lidar_id>/<frame:08d>.npz    (rays_o, rays_d, ranges)
        masks/<cam_id>/<frame:08d>.npz       (semantic ids; the sky mask from them)
        depths/<cam_id>/..., normals/<cam_id>/...   (monocular cues)

``scenario.pt`` holds numpy arrays, so it is read with ``weights_only=False``
(torch's default since 2.6 refuses them). The images are decoded by Pillow,
imported where an image is read. ``camera_list`` and ``lidar_list`` keep only
the named sensors that the sequence has; ``drawable_class_names`` keeps the
objects of those classes. The semantic ids are the demo drive's
(``dataio.waymo_demo``: sky 10, human 11/12, vehicle 13..18).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .scene_dataset import SceneDataset
from .waymo_demo import DYNAMIC_IDS, HUMAN_IDS, SKY_ID, VEHICLE_IDS


def _to_numpy_tree(x):
    """Recursively convert a torch-pickled scenario tree to numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy_tree(v) for v in x)
    return x


def _keep_obs(oid, odict, camera_list, lidar_list) -> bool:
    cname = odict.get("class_name", "")
    if cname == "Camera" and camera_list is not None:
        return oid in camera_list
    if cname in ("RaysLidar", "Lidar") and lidar_list is not None:
        return oid in lidar_list
    return True


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path), np.float32) / 255.0


class WaymoDataset(SceneDataset):
    def __init__(self, root: str, *, sequences: Optional[List[str]] = None,
                 image_dirname: str = "images", lidar_dirname: str = "lidars",
                 mask_dirname: str = "masks", depth_dirname: str = "depths",
                 normals_dirname: str = "normals",
                 camera_list: Optional[List[str]] = None,
                 lidar_list: Optional[List[str]] = None, **_):
        self.root = root
        self.dirs = {"image": image_dirname, "lidar": lidar_dirname, "mask": mask_dirname,
                     "depth": depth_dirname, "normals": normals_dirname}
        if sequences is None:
            sequences = sorted(
                d for d in (os.listdir(root) if os.path.isdir(root) else [])
                if os.path.isfile(os.path.join(root, d, "scenario.pt")))
        self.sequences = sequences
        self.camera_list = camera_list
        self.lidar_list = lidar_list
        self._scenarios: Dict[str, Dict] = {}

    def scene_ids(self) -> List[str]:
        return list(self.sequences)

    def _load_scenario(self, scene_id: str) -> Dict:
        if scene_id not in self._scenarios:
            path = os.path.join(self.root, scene_id, "scenario.pt")
            self._scenarios[scene_id] = _to_numpy_tree(
                torch.load(path, map_location="cpu", weights_only=False))
        return self._scenarios[scene_id]

    def get_scenario(self, scene_id: str, *, observer_cfgs: Optional[Dict] = None,
                     drawable_class_names: Optional[List[str]] = None,
                     start_frame: int = 0, n_frames: Optional[int] = None,
                     **kw) -> Dict[str, Any]:
        """The scenario with the configured cameras and LiDARs (an ego car's
        children too) and the drawable classes kept."""
        sc = dict(self._load_scenario(scene_id))
        observers = dict(sc.get("observers", {}))
        if self.camera_list or self.lidar_list:
            def keep(oid, o):
                kids = o.get("children", {})
                if kids:
                    o = dict(o)
                    o["children"] = {k: v for k, v in kids.items()
                                     if _keep_obs(k, v, self.camera_list, self.lidar_list)}
                    return o
                return o if _keep_obs(oid, o, self.camera_list, self.lidar_list) else None
            observers = {k: v for k, v in ((k, keep(k, v)) for k, v in observers.items())
                         if v is not None}
        objects = sc.get("objects", {})
        if drawable_class_names is not None:
            objects = {k: v for k, v in objects.items()
                       if v.get("class_name") in drawable_class_names}
        return {"scene_id": sc.get("scene_id", scene_id), "metas": sc.get("metas", {}),
                "observers": observers, "objects": objects}

    def _frame_path(self, scene_id, kind, sensor_id, fi, ext):
        return os.path.join(self.root, scene_id, self.dirs[kind], sensor_id, f"{fi:08d}.{ext}")

    def get_image(self, scene_id: str, cam_id: str, frame_index: int) -> np.ndarray:
        for ext in ("jpg", "png", "jpeg"):
            p = self._frame_path(scene_id, "image", cam_id, frame_index, ext)
            if os.path.isfile(p):
                return _read_rgb(p)[..., :3]
        raise FileNotFoundError(f"image {scene_id}/{cam_id}/{frame_index}")

    def _load_semantic(self, scene_id, cam_id, fi) -> Optional[np.ndarray]:
        p = self._frame_path(scene_id, "mask", cam_id, fi, "npz")
        if os.path.isfile(p):
            with np.load(p) as z:
                return z[z.files[0]]
        return None

    def get_occupancy_mask(self, scene_id, cam_id, frame_index):
        sem = self._load_semantic(scene_id, cam_id, frame_index)
        return None if sem is None else (sem != SKY_ID).astype(np.float32)

    def get_semantic_mask(self, scene_id, cam_id, frame_index, kind="all"):
        sem = self._load_semantic(scene_id, cam_id, frame_index)
        if sem is None or kind == "all":
            return sem
        ids = {"sky": (SKY_ID,), "human": HUMAN_IDS, "vehicle": VEHICLE_IDS,
               "dynamic": DYNAMIC_IDS}[kind]
        return np.isin(sem, ids)

    def get_mono_depth(self, scene_id, cam_id, frame_index):
        p = self._frame_path(scene_id, "depth", cam_id, frame_index, "npz")
        if os.path.isfile(p):
            with np.load(p) as z:
                return z[z.files[0]].astype(np.float32)
        return None

    def get_mono_normals(self, scene_id, cam_id, frame_index):
        for ext in ("npz", "jpg", "png"):
            p = self._frame_path(scene_id, "normals", cam_id, frame_index, ext)
            if os.path.isfile(p):
                if ext == "npz":
                    with np.load(p) as z:
                        return z[z.files[0]].astype(np.float32)
                return _read_rgb(p) * 2.0 - 1.0
        return None

    def get_lidar(self, scene_id, lidar_id, frame_index):
        p = self._frame_path(scene_id, "lidar", lidar_id, frame_index, "npz")
        if not os.path.isfile(p):
            return None
        with np.load(p) as z:
            return {"rays_o": z["rays_o"].astype(np.float32).reshape(-1, 3),
                    "rays_d": z["rays_d"].astype(np.float32).reshape(-1, 3),
                    "ranges": z["ranges"].astype(np.float32).reshape(-1)}
