"""Field construction of the assets on the port's paths (port of
neuralsim_tpu/models/assets.py:70-171, 263-302, 576-613).

An asset turns its ``model_params`` from the config into a field module (and
an occupancy grid where it has one); the same keys are read, with the same
defaults, as in the JAX package. Object assets are built per object, scene
assets per scene, and a shared categorical asset once for every object of
its class in a scene, with each object's ``instance_index``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..accel import OccGridEma
from ..fields.conditional import ConditionalLoTDNeuSField
from ..fields.nerf import NeRFDistantField
from ..fields.neus import NeuSField
from ..fields.sky import SimpleSky
from ..fields.spatial import AABBSpace
from .asset_base import AssetAssignment, AssetModel


def _no_appearance(mp: Dict[str, Any]) -> None:
    if mp.get("appear_embed_dim", 0):
        raise NotImplementedError("appearance embeddings are not ported")


def _occ_grid(space: AABBSpace, accel_cfg: Dict[str, Any], resolution: int) -> OccGridEma:
    """An asset's ``accel_cfg`` -> its grid (the march takes the default)."""
    return OccGridEma(space, accel_cfg.get("resolution", resolution),
                      occ_thre=accel_cfg.get("occ_thre", 0.3),
                      ema_decay=accel_cfg.get("ema_decay", 0.95),
                      occ_inv_s=accel_cfg.get("inv_s", 256.0),
                      n_steps_between_update=accel_cfg.get("n_steps_between_update", 16),
                      samples_per_voxel=accel_cfg.get("samples_per_voxel", 1))


class LoTDNeuSObj(AssetModel):
    """Object-centric LoTD NeuS in a cube of half-size ``extent``."""

    assignment = AssetAssignment.OBJECT

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        _no_appearance(mp)
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
        if mp.get("accel_cfg"):
            self.accel = _occ_grid(space, mp["accel_cfg"], 64)


class LoTDNeuSStreet(AssetModel):
    """The StreetSurf close-range SDF in the config's ``aabb``, with its
    occupancy grid and no sphere-init bias. Not ported yet: the box from the
    camera tracks (a config without ``aabb``) and the road-surface pretrain
    of ``training_initialize``."""

    assignment = AssetAssignment.SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        _no_appearance(mp)
        aabb = mp.get("aabb")
        if aabb is None:
            raise NotImplementedError("the street box from the camera tracks is not ported; "
                                      "give model_params.aabb")
        space = AABBSpace(aabb[0], aabb[1])
        self.field = NeuSField(
            space,
            encoding_cfg=mp.get("encoding_cfg", {"n_levels": 14, "base_res": 16,
                                                 "max_res": 4096,
                                                 "log2_hashmap_size": 19}),
            geo_feat_dim=mp.get("geo_feat_dim", 15),
            radiance_hidden=mp.get("radiance_hidden", 64),
            ln_inv_s_init=float(np.log(mp.get("inv_s_init", 10.0))),
            inv_s_final=mp.get("inv_s_final", 2000.0),
            inv_s_anneal_start_it=mp.get("inv_s_anneal_start_it", 0),
            inv_s_anneal_stop_it=mp.get("inv_s_anneal_stop_it", 0),
            cos_anneal_stop_it=mp.get("cos_anneal_stop_it", 0),
            sdf_scale=mp.get("sdf_scale", 1.0),
            radius_init=mp.get("radius_init", 0.0))
        self.query_cfg = dict(mp.get("query_cfg", {}))
        accel_cfg = mp.get("accel_cfg", {"resolution": 128})
        if accel_cfg:
            self.accel = _occ_grid(space, accel_cfg, 128)


class ADGenerativeLoTDConcatNeuSObj(AssetModel):
    """One conditional LoTD NeuS for every object of a class in a scene, with
    per-instance latents (``ConditionalLoTDNeuSField``). The canonical box has
    the class's mean aspect: the mean over the objects of each one's mean
    scale over its valid frames, over its largest entry. Not ported yet: the
    batched per-instance occupancy grids (``accel_cfg``)."""

    assignment = AssetAssignment.MULTI_OBJ_ONE_SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        if mp.get("accel_cfg"):
            raise NotImplementedError("batched occupancy grids (K10) are not ported")
        obj_ids = list(obj_ids or [])
        self.instance_index = {oid: i for i, oid in enumerate(obj_ids)}
        aspect = np.ones(3, np.float32)
        if scene is not None and obj_ids:
            scales = []
            for oid in obj_ids:
                fd = scene.drawables[oid].frame_data
                sc, valid = fd["scale"].cpu().numpy(), fd["valid"].cpu().numpy()
                if valid.any():
                    scales.append(sc[valid].mean(0))
            if scales:
                aspect = np.mean(scales, 0)
                aspect = aspect / max(aspect.max(), 1e-6)
        self.field = ConditionalLoTDNeuSField(
            AABBSpace(-aspect, aspect),
            n_instances=max(len(obj_ids), 1),
            z_dim=mp.get("z_dim", 8),
            encoding_cfg=mp.get("encoding_cfg"),
            geo_feat_dim=mp.get("geo_feat_dim", 15),
            radiance_hidden=mp.get("radiance_hidden", 64),
            ln_inv_s_init=float(np.log(mp.get("inv_s_init", 20.0))),
            cos_anneal_stop_it=mp.get("cos_anneal_stop_it", 0))
        self.query_cfg = dict(mp.get("query_cfg", {}))


class NeRFDistant(AssetModel):
    """NeRF++ background with the MLP geometry (the 4-D LoTD one is not
    ported); ``cr_aabb`` sets the ``fixed_cuboid_shells`` contraction, which
    the compose renderer otherwise wires to the street's box."""

    assignment = AssetAssignment.SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        _no_appearance(mp)
        self.field = NeRFDistantField(inner_radius=mp.get("inner_radius", 1.0),
                                      geometry=mp.get("geometry", "mlp"),
                                      geo_feat_dim=mp.get("geo_feat_dim", 15),
                                      cr_aabb=mp.get("cr_aabb"))
        self.query_cfg = dict(mp.get("query_cfg", {}))


class SimpleSkyAsset(AssetModel):
    assignment = AssetAssignment.SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        _no_appearance(mp)
        self.field = SimpleSky(hidden=mp.get("hidden", 64), depth=mp.get("depth", 2),
                               sh_degree=mp.get("sh_degree", 4))


ASSET_CLASSES = {c.__name__: c for c in (LoTDNeuSObj, LoTDNeuSStreet,
                                         ADGenerativeLoTDConcatNeuSObj, NeRFDistant,
                                         SimpleSkyAsset)}


def asset_class(model_class: str):
    """Resolve a config ``model_class`` (a JAX dotted path or a bare name)."""
    name = model_class.rsplit(".", 1)[-1]
    if name not in ASSET_CLASSES:
        raise NotImplementedError(f"asset class {name} is not ported")
    return ASSET_CLASSES[name]
