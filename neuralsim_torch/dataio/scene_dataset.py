"""The interface every dataset of a scene provides (port of
neuralsim_tpu/dataio/scene_dataset.py:16-59; numpy, on the host).

A dataset answers the scenario (the universal scenario dict) and, per sensor
and frame, the image, its masks, the monocular cues and the LiDAR beams; the
data loader (``dataio.dataloader.SceneDataLoader``) caches and batches them.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional

import numpy as np


class SceneDataset(abc.ABC):
    """Interface every dataset implementation provides."""

    @abc.abstractmethod
    def scene_ids(self) -> List[str]:
        ...

    @abc.abstractmethod
    def get_scenario(self, scene_id: str, **kw) -> Dict[str, Any]:
        """The universal scenario dict of ``scene_id``."""

    @abc.abstractmethod
    def get_image(self, scene_id: str, cam_id: str, frame_index: int) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1]."""

    def get_occupancy_mask(self, scene_id: str, cam_id: str,
                           frame_index: int) -> Optional[np.ndarray]:
        """[H, W] mask of the non-sky pixels (None if unavailable)."""
        return None

    def get_semantic_mask(self, scene_id: str, cam_id: str, frame_index: int,
                          kind: str = "all") -> Optional[np.ndarray]:
        return None

    def get_mono_depth(self, scene_id: str, cam_id: str,
                       frame_index: int) -> Optional[np.ndarray]:
        return None

    def get_mono_normals(self, scene_id: str, cam_id: str,
                         frame_index: int) -> Optional[np.ndarray]:
        return None

    def get_lidar(self, scene_id: str, lidar_id: str, frame_index: int
                  ) -> Optional[Dict[str, np.ndarray]]:
        """{'rays_o' [n, 3], 'rays_d' [n, 3], 'ranges' [n]} in the sensor's frame."""
        return None

    def get_image_wh(self, scene_id: str, cam_id: str, frame_index: int):
        img = self.get_image(scene_id, cam_id, frame_index)
        return img.shape[1], img.shape[0]

    @property
    def up_vec(self) -> np.ndarray:
        return np.array([0.0, 0.0, 1.0])
