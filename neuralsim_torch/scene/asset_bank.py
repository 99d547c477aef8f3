"""AssetBank: builds every asset of a config for the scenes it applies to
(port of neuralsim_tpu/scene/asset_bank.py:26-120).

Config schema (the JAX package's ``assetbank_cfg``)::

    {class_name: {model_class: "neuralsim_tpu.models.assets.LoTDNeuSStreet",
                  model_params: {...}, asset_params: {training_cfg: {...}}}}

The parameters are the field modules themselves: :meth:`init_params` gives
them seeded values and returns them as one ``nn.ModuleDict`` keyed by model
id, the port's counterpart of the JAX ``{model_id: pytree}``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..models.asset_base import AssetAssignment, AssetModel
from ..models.assets import asset_class


class AssetBank:
    def __init__(self):
        self.assets: Dict[str, AssetModel] = {}        # model_id -> asset
        self.class_of: Dict[str, str] = {}             # model_id -> class name
        self.binding: Dict[tuple, str] = {}            # (scene_id, obj or class) -> model_id

    @classmethod
    def create(cls, assetbank_cfg: Dict[str, Dict], scene_bank: List) -> "AssetBank":
        """Make and populate each configured asset for every scene and
        object it applies to, by its assignment."""
        bank = cls()
        for class_name, cfg in assetbank_cfg.items():
            model_cls = asset_class(cfg["model_class"])
            mp, ap = cfg.get("model_params", {}), cfg.get("asset_params", {})
            a = model_cls.assignment
            for scene in scene_bank:
                of_class = [oid for oid in scene.drawable_ids()
                            if scene.drawables[oid].class_name == class_name]
                if a == AssetAssignment.OBJECT:
                    for oid in of_class:
                        asset = model_cls(mp, ap)
                        asset.populate(scene, [oid])
                        mid = model_cls.compute_id(class_name, scene.id, oid)
                        bank._register(mid, class_name, asset)
                        bank.binding[(scene.id, oid)] = mid
                elif a in (AssetAssignment.SCENE, AssetAssignment.MISC):
                    asset = model_cls(mp, ap)
                    asset.populate(scene, None)
                    mid = model_cls.compute_id(class_name, scene.id)
                    bank._register(mid, class_name, asset)
                    bank.binding[(scene.id, class_name)] = mid
                elif a == AssetAssignment.MULTI_OBJ_ONE_SCENE:
                    if not of_class:
                        continue
                    asset = model_cls(mp, ap)
                    asset.populate(scene, of_class)
                    mid = model_cls.compute_id(class_name, scene.id)
                    bank._register(mid, class_name, asset)
                    for oid in of_class:
                        bank.binding[(scene.id, oid)] = mid
                else:
                    raise NotImplementedError("models shared across scenes are not ported")
        return bank

    def _register(self, model_id: str, class_name: str, asset: AssetModel) -> None:
        self.assets[model_id] = asset
        self.class_of[model_id] = class_name

    def init_params(self, generator: torch.Generator, device="cpu") -> nn.ModuleDict:
        """Seeded parameters (the JAX init formulas, in distribution) of every
        asset's field, in the bank's order, moved to ``device``."""
        params = nn.ModuleDict()
        for mid, asset in self.assets.items():
            asset.field.reset_parameters(generator)
            params[mid] = asset.field
        return params.to(device)

    def pretrain_shapes(self) -> Dict[str, tuple]:
        """{model id: the shape of its pretrain's uniform draws}, in the
        bank's order, for the assets that pretrain their geometry."""
        return {mid: shp for mid, a in self.assets.items()
                if (shp := a.pretrain_shape()) is not None}

    def training_initialize(self, noise: Dict[str, Any]) -> None:
        """Each asset's geometry pretraining, in place, from its draws
        ``noise[model id]`` (:meth:`pretrain_shapes`)."""
        for mid, a in self.assets.items():
            if mid in noise:
                a.training_initialize(noise[mid])

    def training_cfgs(self) -> Dict[str, Dict]:
        """{model id: optimizer settings} of the assets that set them."""
        return {mid: a.training_cfg for mid, a in self.assets.items() if a.training_cfg}

    def model_for(self, scene_id: str, obj_or_class: str) -> Optional[str]:
        return self.binding.get((scene_id, obj_or_class))
