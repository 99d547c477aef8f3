"""Field construction of the assets on the port's paths (port of
neuralsim_tpu/models/assets.py:31-66, 70-193, 194-215, 263-338, 341-413,
416-446, 449-556, 576-613).

An asset turns its ``model_params`` from the config into a field module (and
an occupancy grid where it has one); the same keys are read, with the same
defaults, as in the JAX package. Object assets are built per object, scene
assets per scene, and a shared categorical asset once for every object of
its class in a scene, with each object's ``instance_index``. The street's
``training_initialize`` fits its SDF to the road plane before training
(:func:`pretrain_sdf`, the uniform points handed in as draws). The street,
the distant field and the sky take ``appear_embed_dim``, the width of the
per-frame appearance codes of :class:`ImageEmbeddings` (one table a camera).
EmerNeRF's street (:class:`EmerNerfStreet`) is the time-conditioned
static/dynamic field with its flow head, in the box of the camera tracks.
:class:`LearnableParams` holds pose refinement's deltas (rotation and
translation a node and frame, intrinsics and timestamp deltas), which the
single-scene trainer applies to the scene graph inside its step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..accel import OccGridEma, OccGridEmaBatched
from ..fields.conditional import (ConditionalLoTDNeuSField, GenerativePermutoConcatNeuSField,
                                  PermutoNeuSField)
from ..fields.embeddings import SeqEmbedding
from ..fields.emernerf import EmerNeRFField
from ..fields.nerf import NeRFDistantField
from ..fields.neus import NeuSField
from ..fields.sky import SimpleSky
from ..fields.spatial import AABBSpace
from ..maths.transforms import make_transform, quat_to_rot
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
    """The StreetSurf close-range SDF in the config's ``aabb`` (without one,
    the box of the scene's camera tracks widened by ``extend_size``; without
    a scene, JAX's default box), with its occupancy grid and no sphere-init
    bias; ``training_initialize`` pretrains it to the road surface. Not
    ported yet: the capsule pretrain."""

    assignment = AssetAssignment.SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        space = self.street_space(scene, mp)
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
            radius_init=mp.get("radius_init", 0.0),
            appear_embed_dim=mp.get("appear_embed_dim", 0))
        self.query_cfg = dict(mp.get("query_cfg", {}))
        accel_cfg = mp.get("accel_cfg", {"resolution": 128})
        if accel_cfg:
            self.accel = _occ_grid(space, accel_cfg, 128)

    @classmethod
    def street_space(cls, scene, mp: Dict[str, Any]) -> AABBSpace:
        """A street's box: the config's ``aabb``, else the camera tracks'
        (:meth:`aabb_from_cameras`), else (no scene) JAX's default box."""
        aabb = mp.get("aabb")
        if aabb is None and scene is not None:
            aabb = cls.aabb_from_cameras(scene, mp)
        if aabb is None:
            aabb = ([-60, -60, -10], [60, 60, 30])
        return AABBSpace(aabb[0], aabb[1])

    @staticmethod
    def aabb_from_cameras(scene, mp: Dict[str, Any]):
        """The box of the cameras' positions over their valid frames, widened
        by ``extend_size`` (60) on every side, as (min, max) lists, or None
        without a camera. As in the JAX package (``_aabb_from_cameras``), a
        position is the translation of the camera node's own per-frame
        transform, which is relative to its parent (the ego car, in a Waymo
        scenario)."""
        pts = []
        for oid in scene.observer_ids():
            node = scene.observers[oid]
            if node.class_name != "Camera":
                continue
            T = node.frame_data["transform"].cpu().numpy()
            valid = node.frame_data["valid"].cpu().numpy()
            pts.append(T[valid, :3, 3])
        if not pts:
            return None
        pts = np.concatenate(pts, 0)
        ext = float(mp.get("extend_size", 60.0))
        return (pts.min(0) - ext).tolist(), (pts.max(0) + ext).tolist()

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


class EmerNerfStreet(AssetModel):
    """EmerNeRF's self-supervised static and dynamic street (an
    :class:`~neuralsim_torch.fields.emernerf.EmerNeRFField`: the static LoTD,
    the dynamic permuto lattice over (xyz, t) and the flow head) in the
    config's ``aabb`` or the box of the camera tracks widened by
    ``extend_size`` (without a scene, JAX's default box); no occupancy grid
    and no pretrain."""

    assignment = AssetAssignment.SCENE
    only_dynamic = False

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        self.field = EmerNeRFField(LoTDNeuSStreet.street_space(scene, mp),
                                   static_encoding_cfg=mp.get("static_encoding_cfg"),
                                   dynamic_permuto_cfg=mp.get("dynamic_permuto_cfg"),
                                   geo_feat_dim=mp.get("geo_feat_dim", 15),
                                   radiance_hidden=mp.get("radiance_hidden", 64),
                                   with_flow=mp.get("with_flow", True),
                                   only_dynamic=self.only_dynamic)
        self.query_cfg = dict(mp.get("query_cfg", {}))


class EmerNerfStreetOnlyDynamic(EmerNerfStreet):
    """The same with the dynamic branch alone."""

    only_dynamic = True


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


class LoTDNeRFDistant(AssetModel):
    """NeRF++ background, by default on the 4-D LoTD (``geometry``,
    ``encoding_cfg``); ``cr_aabb`` sets the ``fixed_cuboid_shells``
    contraction, which the build functions otherwise wire to the close-range box."""

    assignment = AssetAssignment.SCENE
    default_geometry = "lotd"

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        self.field = NeRFDistantField(inner_radius=mp.get("inner_radius", 1.0),
                                      geometry=mp.get("geometry", self.default_geometry),
                                      encoding_cfg=mp.get("encoding_cfg"),
                                      geo_feat_dim=mp.get("geo_feat_dim", 15),
                                      appear_embed_dim=mp.get("appear_embed_dim", 0),
                                      cr_aabb=mp.get("cr_aabb"))
        self.query_cfg = dict(mp.get("query_cfg", {}))


class NeRFDistant(LoTDNeRFDistant):
    """The same background with the MLP geometry by default."""

    default_geometry = "mlp"


class SimpleSkyAsset(AssetModel):
    assignment = AssetAssignment.SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        self.field = SimpleSky(hidden=mp.get("hidden", 64), depth=mp.get("depth", 2),
                               sh_degree=mp.get("sh_degree", 4),
                               appear_embed_dim=mp.get("appear_embed_dim", 0))


class AppearanceTables(nn.ModuleDict):
    """One :class:`SeqEmbedding` a camera, keyed by camera id (parameters
    ``<camera>.weight``, the JAX tree's paths)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        for table in self.values():
            table.reset_parameters(generator)


class ImageEmbeddings(AssetModel):
    """Per-frame appearance codes: one [n_frames, ``dim``] table a camera of
    the scene (``cam_ids`` and ``n_frames`` of the config without a scene),
    looked up by frame index into the fields' ``h_appear``."""

    assignment = AssetAssignment.SCENE

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        self.dim = mp.get("dim", 4)
        self.cam_ids = [oid for oid in (scene.observer_ids() if scene else [])
                        if scene.observers[oid].class_name == "Camera"] \
            or mp.get("cam_ids", ["camera_0"])
        self.n_frames = scene.n_frames if scene else mp.get("n_frames", 1)
        self.field = AppearanceTables({cid: SeqEmbedding(self.n_frames, self.dim)
                                       for cid in self.cam_ids})

    @property
    def tables(self) -> Dict[str, SeqEmbedding]:
        return dict(self.field.items())

    def h_appear(self, params: AppearanceTables, cam_id: str, fidx: torch.Tensor
                 ) -> torch.Tensor:
        """The codes of camera ``cam_id`` at frame indices ``fidx`` [N] ->
        [N, dim], from the tables ``params`` (the bank's module)."""
        return params[cam_id](fidx)


class PoseDeltas(nn.ModuleDict):
    """Pose refinement's parameters: one ``nn.ParameterDict`` a node of
    {dquat [T, 3] (a rotation's so(3) tangent), dtrans [T, 3], dintr [T, 4]
    (dfx, dfy, dcx, dcy), dts [T] or [1]}, each where the node refines it;
    parameters ``<node>.<name>``, the JAX tree's paths. Zeros at init."""

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.zero_()


class LearnableParams(AssetModel):
    """Pose refinement and self-calibration: per-node, per-frame rotation and
    translation deltas on the scenario's poses (``refine_nodes``, by default
    the scene's observers), per-frame intrinsics deltas (``refine_intr``:
    True for every camera, or a list) and timestamp deltas (``refine_ts``:
    True for every observer, or a list; one offset a sensor with
    ``ts_holistic_offset``), switched on at iteration ``enable_after``."""

    assignment = AssetAssignment.MISC

    def populate(self, scene=None, obj_ids=None) -> None:
        mp = self.model_params
        observers = scene.observer_ids() if scene else []
        self.refine_nodes = list(mp.get("refine_nodes") or observers)
        self.n_frames = scene.n_frames if scene else mp.get("n_frames", 1)
        self.enable_after = mp.get("enable_after", 0)
        ri = mp.get("refine_intr", False)
        cams = [nid for nid in observers if scene.observers[nid].class_name == "Camera"]
        self.intr_nodes = cams if ri is True else list(ri or [])
        rt = mp.get("refine_ts", False)
        self.ts_nodes = observers if rt is True else list(rt or [])
        self.ts_holistic = bool(mp.get("ts_holistic_offset", False))
        T = self.n_frames
        zeros = lambda *shape: nn.Parameter(torch.zeros(shape))
        nodes: Dict[str, nn.ParameterDict] = {}
        for nid in self.refine_nodes:
            nodes[nid] = nn.ParameterDict({"dquat": zeros(T, 3), "dtrans": zeros(T, 3)})
        for nid in self.intr_nodes:
            nodes.setdefault(nid, nn.ParameterDict())["dintr"] = zeros(T, 4)
        for nid in self.ts_nodes:
            nodes.setdefault(nid, nn.ParameterDict())["dts"] = \
                zeros(1) if self.ts_holistic else zeros(T)
        self.field = PoseDeltas(nodes)

    @staticmethod
    def apply_intr_delta(intr: torch.Tensor, dintr: torch.Tensor) -> torch.Tensor:
        """[..., 3, 3] intrinsics plus (dfx, dfy, dcx, dcy) [..., 4] at (0, 0),
        (1, 1), (0, 2), (1, 2)."""
        z = torch.zeros_like(dintr[..., 0])
        dmat = torch.stack([torch.stack([dintr[..., 0], z, dintr[..., 2]], -1),
                            torch.stack([z, dintr[..., 1], dintr[..., 3]], -1),
                            torch.stack([z, z, z], -1)], -2)
        return intr + dmat

    @staticmethod
    def apply_delta(transform: torch.Tensor, dquat: torch.Tensor,
                    dtrans: torch.Tensor) -> torch.Tensor:
        """[..., 4, 4] with its rotation times exp(dquat) (the half-angle
        quaternion; the angle is the smoothed norm sqrt(|v|^2 + 1e-16), whose
        gradient is finite at a zero delta) and dtrans added to its
        translation."""
        angle = torch.sqrt(torch.sum(dquat * dquat, dim=-1, keepdim=True) + 1e-16)
        half = 0.5 * angle
        q = torch.cat([torch.cos(half), dquat * (torch.sin(half) / angle)], dim=-1)
        dR = quat_to_rot(q)
        R0 = transform[..., :3, :3]
        R = R0[..., :, 0:1] * dR[..., 0:1, :] + R0[..., :, 1:2] * dR[..., 1:2, :] \
            + R0[..., :, 2:3] * dR[..., 2:3, :]
        return make_transform(R, transform[..., :3, 3] + dtrans)


ASSET_CLASSES = {c.__name__: c for c in (LoTDNeuSObj, LoTDNeuSStreet,
                                         ADGenerativeLoTDConcatNeuSObj,
                                         ADGenerativePermutoConcatNeuSObj, PermutoNeuSObj,
                                         LoTDNeRFDistant, NeRFDistant, SimpleSkyAsset,
                                         ImageEmbeddings, EmerNerfStreet,
                                         EmerNerfStreetOnlyDynamic, LearnableParams)}


def asset_class(model_class: str):
    """Resolve a config ``model_class`` (a JAX dotted path or a bare name)."""
    name = model_class.rsplit(".", 1)[-1]
    if name not in ASSET_CLASSES:
        raise NotImplementedError(f"asset class {name} is not ported")
    return ASSET_CLASSES[name]
