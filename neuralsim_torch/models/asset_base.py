"""Asset base: the assignment axis and the model id (port of
neuralsim_tpu/models/asset_base.py:20-69).

An asset binds a field module to its role in a scene. Its ``assignment``
says how many models the asset bank makes of it: one per object, one per
scene, one shared by every object of its class in a scene, one across
scenes, or one free-floating. ``compute_id`` names the model accordingly.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, Optional

from torch import nn


class AssetAssignment(enum.Enum):
    OBJECT = 0               # one model per (scene, object)
    SCENE = 1                # one model per scene (street, sky, distant)
    MULTI_OBJ_ONE_SCENE = 2  # one shared model for a class within a scene
    MULTI_OBJ = 3            # one shared model for a class across scenes
    MISC = 4                 # free-floating


class AssetModel:
    """Base asset: ``populate`` builds the field (and an occupancy grid, where
    the asset has one) from its ``model_params``, reading the same keys with
    the same defaults as the JAX package."""

    assignment: AssetAssignment = AssetAssignment.OBJECT

    def __init__(self, model_params: Optional[Dict] = None,
                 asset_params: Optional[Dict] = None):
        self.model_params = dict(model_params or {})
        self.asset_params = dict(asset_params or {})
        self.field: Optional[nn.Module] = None
        self.query_cfg: Dict[str, Any] = {}
        self.accel = None

    @classmethod
    def compute_id(cls, class_name: str, scene_id: Optional[str] = None,
                   obj_id: Optional[str] = None) -> str:
        a = cls.assignment
        if a == AssetAssignment.OBJECT:
            return f"{class_name}#{scene_id}#{obj_id}"
        if a in (AssetAssignment.SCENE, AssetAssignment.MULTI_OBJ_ONE_SCENE):
            return f"{class_name}#{scene_id}"
        return class_name

    def populate(self, scene=None, obj_ids=None) -> None:
        raise NotImplementedError

    @property
    def training_cfg(self) -> Dict:
        """The model's optimizer settings (``asset_params.training_cfg``)."""
        return dict(self.asset_params.get("training_cfg", {}))

    def pretrain_shape(self) -> Optional[tuple]:
        """The shape of the uniform draws of :meth:`training_initialize`, or
        None where the asset has no geometry pretraining."""
        return None

    def training_initialize(self, noise: Any = None) -> None:
        """Geometry pretraining of the asset's field in place, from uniform
        draws of :meth:`pretrain_shape` (none by default)."""
