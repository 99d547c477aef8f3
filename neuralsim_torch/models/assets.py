"""Field construction of the assets on the slice's path (port of
neuralsim_tpu/models/assets.py:70-101, 263-287 and the SimpleSkyAsset at 294+).

An asset turns its ``model_params`` from the config into a field module; the
same keys are read, with the same defaults, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
from torch import nn

from ..accel import OccGridEma
from ..fields.nerf import NeRFDistantField
from ..fields.neus import NeuSField
from ..fields.sky import SimpleSky
from ..fields.spatial import AABBSpace


class AssetModel:
    def __init__(self, model_params: Optional[Dict] = None):
        self.model_params = dict(model_params or {})
        self.field: Optional[nn.Module] = None
        self.query_cfg: Dict[str, Any] = {}
        self.accel: Optional[OccGridEma] = None

    def populate(self) -> None:
        raise NotImplementedError


class LoTDNeuSObj(AssetModel):
    """Object-centric LoTD NeuS in a cube of half-size ``extent``."""

    def populate(self) -> None:
        mp = self.model_params
        if mp.get("appear_embed_dim", 0):
            raise NotImplementedError("appearance embeddings are not ported")
        extent = mp.get("extent", 1.0)
        space = AABBSpace([-extent] * 3, [extent] * 3)
        self.field = NeuSField(
            space,
            encoding_cfg=mp.get("encoding_cfg", {"n_levels": 12, "base_res": 16,
                                                 "max_res": 512,
                                                 "log2_hashmap_size": 17}),
            geo_feat_dim=mp.get("geo_feat_dim", 15),
            radiance_hidden=mp.get("radiance_hidden", 64),
            ln_inv_s_init=float(np.log(mp.get("inv_s_init", 20.0))),
            cos_anneal_stop_it=mp.get("cos_anneal_stop_it", 0))
        self.query_cfg = dict(mp.get("query_cfg", {}))
        accel_cfg = mp.get("accel_cfg")
        if accel_cfg:
            self.accel = OccGridEma(
                space, accel_cfg.get("resolution", 64),
                occ_thre=accel_cfg.get("occ_thre", 0.3),
                ema_decay=accel_cfg.get("ema_decay", 0.95),
                occ_inv_s=accel_cfg.get("inv_s", 256.0),
                n_steps_between_update=accel_cfg.get("n_steps_between_update", 16),
                samples_per_voxel=accel_cfg.get("samples_per_voxel", 1))


class NeRFDistant(AssetModel):
    """NeRF++ background with the MLP geometry (the 4-D LoTD one is not ported)."""

    def populate(self) -> None:
        mp = self.model_params
        if mp.get("appear_embed_dim", 0):
            raise NotImplementedError("appearance embeddings are not ported")
        if mp.get("cr_aabb") is not None:
            raise NotImplementedError("the fixed_cuboid_shells contraction is not ported")
        self.field = NeRFDistantField(inner_radius=mp.get("inner_radius", 1.0),
                                      geometry=mp.get("geometry", "mlp"),
                                      geo_feat_dim=mp.get("geo_feat_dim", 15))
        self.query_cfg = dict(mp.get("query_cfg", {}))


class SimpleSkyAsset(AssetModel):
    def populate(self) -> None:
        mp = self.model_params
        if mp.get("appear_embed_dim", 0):
            raise NotImplementedError("appearance embeddings are not ported")
        self.field = SimpleSky(hidden=mp.get("hidden", 64), depth=mp.get("depth", 2),
                               sh_degree=mp.get("sh_degree", 4))


ASSET_CLASSES = {"LoTDNeuSObj": LoTDNeuSObj, "NeRFDistant": NeRFDistant,
                 "SimpleSkyAsset": SimpleSkyAsset}


def asset_class(model_class: str):
    """Resolve a config ``model_class`` (a JAX dotted path or a bare name)."""
    name = model_class.rsplit(".", 1)[-1]
    if name not in ASSET_CLASSES:
        raise NotImplementedError(f"asset class {name} is not ported")
    return ASSET_CLASSES[name]
