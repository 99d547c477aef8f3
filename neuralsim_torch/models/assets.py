"""Field construction of the assets on the port's paths (port of
neuralsim_tpu/models/assets.py:31-66, 70-171, 194-215, 263-302, 449-556,
576-613).

An asset turns its ``model_params`` from the config into a field module (and
an occupancy grid where it has one); the same keys are read, with the same
defaults, as in the JAX package. Object assets are built per object, scene
assets per scene, and a shared categorical asset once for every object of
its class in a scene, with each object's ``instance_index``. The street's
``training_initialize`` fits its SDF to the road plane before training
(:func:`pretrain_sdf`, the uniform points handed in as draws).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..accel import OccGridEma, OccGridEmaBatched
from ..fields.conditional import (ConditionalLoTDNeuSField, GenerativePermutoConcatNeuSField,
                                  PermutoNeuSField)
from ..fields.nerf import NeRFDistantField
from ..fields.neus import NeuSField
from ..fields.sky import SimpleSky
from ..fields.spatial import AABBSpace
from ..training.optimizers import ModelAdam
from .asset_base import AssetAssignment, AssetModel


def pretrain_sdf(field: NeuSField, target_sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                 noise: torch.Tensor, lr: float = 5e-3) -> None:
    """Fit the field's SDF to an analytic target over its space, in place:
    one Adam step (optax's ``adam(lr)``: betas 0.9, 0.999, eps 1e-8) of the
    mean squared error per entry of ``noise`` [n_iters, n_pts, 3], uniform
    draws that place each step's points in the box."""
    params = list(field.parameters())
    opt = ModelAdam(params, {"type": "constant", "lr": lr, "betas": (0.9, 0.999),
                             "eps": 1e-8})
    for u in noise:
        x = field.space.uniform_points(u)
        loss = torch.mean((field.query_sdf(x) - target_sdf_fn(x)) ** 2)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])


def road_surface_sdf(x: torch.Tensor, z_road: float, up_axis: int = 2,
                     sign: float = 1.0) -> torch.Tensor:
    """Half-space SDF: the signed height above the road plane."""
    return sign * (x[..., up_axis] - z_road)


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
    occupancy grid and no sphere-init bias; ``training_initialize`` pretrains
    it to the road surface. Not ported yet: the box from the camera tracks (a
    config without ``aabb``) and the capsule pretrain."""

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

    def _pretrain_cfg(self) -> Dict[str, Any]:
        pre = self.model_params.get("pretrain", {"type": "road_surface"})
        if pre and pre.get("type") not in ("road_surface", None):
            raise NotImplementedError(f"the {pre.get('type')} pretrain is not ported")
        return pre or {}

    def pretrain_shape(self) -> Optional[tuple]:
        pre = self._pretrain_cfg()
        return (pre.get("n_iters", 300), pre.get("n_pts", 4096), 3) if pre else None

    def training_initialize(self, noise: Any = None) -> None:
        """The road-surface pretrain: ``n_iters`` Adam steps toward the plane
        ``z_road`` (default: the box's centre) on ``n_pts`` uniform points."""
        pre = self._pretrain_cfg()
        if not pre:
            return
        up = pre.get("up_axis", 2)
        z_road = pre.get("z_road")
        if z_road is None:
            z_road = float(self.field.space.center[up])
        pretrain_sdf(self.field, lambda x: road_surface_sdf(x, z_road, up, pre.get("sign", 1.0)),
                     noise, lr=pre.get("lr", 5e-3))


class _SharedCategorical(AssetModel):
    """One conditional NeuS for every object of a class in a scene, with
    per-instance latents; each object's ``instance_index`` picks its latent.
    The canonical box has the class's mean aspect: the mean over the objects
    of each one's mean scale over its valid frames, over its largest entry.
    With an ``accel_cfg``, one occupancy grid per instance over that box
    (``OccGridEmaBatched``; of the config it reads the resolution, the
    threshold, the EMA decay and ``inv_s``, as the JAX package does)."""

    assignment = AssetAssignment.MULTI_OBJ_ONE_SCENE

    def _make_field(self, space: AABBSpace, n_instances: int, mp: Dict[str, Any]):
        raise NotImplementedError

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
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
        space = AABBSpace(-aspect, aspect)
        self.field = self._make_field(space, max(len(obj_ids), 1), mp)
        self.query_cfg = dict(mp.get("query_cfg", {}))
        accel_cfg = mp.get("accel_cfg")
        if accel_cfg:
            self.accel = OccGridEmaBatched(space, max(len(obj_ids), 1),
                                           accel_cfg.get("resolution", 32),
                                           occ_thre=accel_cfg.get("occ_thre", 0.3),
                                           ema_decay=accel_cfg.get("ema_decay", 0.95),
                                           occ_inv_s=accel_cfg.get("inv_s", 256.0))


class ADGenerativeLoTDConcatNeuSObj(_SharedCategorical):
    """The shared class model on a conditional LoTD NeuS
    (``ConditionalLoTDNeuSField``: the latent at the decoder's input)."""

    def _make_field(self, space, n_instances, mp):
        return ConditionalLoTDNeuSField(
            space,
            n_instances=n_instances,
            z_dim=mp.get("z_dim", 8),
            encoding_cfg=mp.get("encoding_cfg"),
            geo_feat_dim=mp.get("geo_feat_dim", 15),
            radiance_hidden=mp.get("radiance_hidden", 64),
            ln_inv_s_init=float(np.log(mp.get("inv_s_init", 20.0))),
            cos_anneal_stop_it=mp.get("cos_anneal_stop_it", 0))


# the permuto assets' default lattice (``permuto_cfg``; they read no
# ``encoding_cfg``)
_PERMUTO_CFG = {"n_levels": 12, "base_res": 4.0, "max_res": 256.0, "log2_hashmap_size": 17}


class ADGenerativePermutoConcatNeuSObj(_SharedCategorical):
    """The shared class model on a permutohedral NeuS over concat(xyz01,
    sigmoid(z)) (``ConditionalPermutoNeuSField``: the latent in the
    lattice, d = 3 + z_dim)."""

    def _make_field(self, space, n_instances, mp):
        return GenerativePermutoConcatNeuSField(
            space,
            n_instances=n_instances,
            z_dim=mp.get("z_dim", 4),
            permuto_cfg=mp.get("permuto_cfg", _PERMUTO_CFG),
            geo_feat_dim=mp.get("geo_feat_dim", 15),
            radiance_hidden=mp.get("radiance_hidden", 64),
            ln_inv_s_init=float(np.log(mp.get("inv_s_init", 20.0))),
            cos_anneal_stop_it=mp.get("cos_anneal_stop_it", 0))


class PermutoNeuSObj(AssetModel):
    """Object-centric permutohedral NeuS (d = 3) in a cube of half-size
    ``extent``."""

    assignment = AssetAssignment.OBJECT

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        extent = mp.get("extent", 1.0)
        self.field = PermutoNeuSField(
            AABBSpace([-extent] * 3, [extent] * 3),
            permuto_cfg=mp.get("permuto_cfg", {**_PERMUTO_CFG, "max_res": 512.0}),
            geo_feat_dim=mp.get("geo_feat_dim", 15),
            radiance_hidden=mp.get("radiance_hidden", 64),
            ln_inv_s_init=float(np.log(mp.get("inv_s_init", 20.0))))
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
                                         ADGenerativeLoTDConcatNeuSObj,
                                         ADGenerativePermutoConcatNeuSObj, PermutoNeuSObj,
                                         NeRFDistant, SimpleSkyAsset)}


def asset_class(model_class: str):
    """Resolve a config ``model_class`` (a JAX dotted path or a bare name)."""
    name = model_class.rsplit(".", 1)[-1]
    if name not in ASSET_CLASSES:
        raise NotImplementedError(f"asset class {name} is not ported")
    return ASSET_CLASSES[name]
