"""Multi-object compose renderer: objects, street, distant field and sky
(port of neuralsim_tpu/renderers/buffer_compose.py:37-47, 77-404, 406-492),
for rendering and for training.

Per ray chunk: the rays go into every drawable's canonical frame (its world
transform inverted, divided by its scale; a scene frozen at one frame per ray,
as a training batch mixes frames, gives each ray its own object poses). A
group of instances of one shared model takes one of two paths:

* per instance (a model of its own, or a shared group of at most 4 under
  ``group_budget_frac: auto``): the rays that hit an instance's box are
  compacted, hits first in ray order, to a fixed budget of
  ``round(N * hit_budget_frac)`` rows per instance;
* pair budget (``group_budget_frac`` set, a shared group of K > 1; ``auto``
  from K > 4): one budget of ``round(N * group_budget_frac)`` (instance, ray)
  rows for the whole group, served round-robin across the instances (kernel
  K11, ``ops/pair_compact.py``).

One query of a shared model evaluates all its rows (each row with its
instance index ``bidx``; with a batched occupancy grid each row's coarse
samples come from its instance's grid, kernel K10); the object depths go back
to world depths (``t / |d_local|``), the normals to the world frame (each
row's own pose), and the rows are scattered back to [N, S] per instance. On
the training path (``with_per_obj=False``) a pair-budget group is instead
folded into one pseudo-source ``group:<model id>`` of ``max_hits_per_ray``
slot lanes a ray ([N, M * S]), so the composite's width does not grow with K.
The street (its coarse samples from its occupancy grid where a
state is handed in) and the distant field (from the street's far plane
outwards) query every ray. All buffers are concatenated unsorted and
composited once, order-free, by ``merge_and_integrate(sort_free=True)`` (the
K8 kernel on the card); each source's share is its masked sums (``per_obj``).
The sky fills what is left. Under autograd the gradients flow through the
compaction and the scatter-back into every field (K8's backward on the card).
Training draws come in as ``noise``, one entry per model id (the field's own
``noise`` argument); ``only_cr`` renders the street alone (the LiDAR step),
its NeuS alpha computed inside the composite (kernel K12).

Parameters live in the field modules, one ``nn.ModuleDict`` keyed by model
id (``AssetBank.init_params``); the bindings name the model ids only, so a
copy of the parameters on another device renders with the same renderer.
Not ported yet: the time condition, appearance embeddings and the image
post-processor.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..maths.transforms import apply_rotation
from ..ops.pair_compact import pair_budget, pair_compact
from .buffers import merge_and_integrate, volume_integrate
from .neus_composite import neus_integrate

_FRAME_KEYS = ("rgb_volume", "depth_volume", "mask_volume", "normals_volume", "rgb_sky")
_SOURCE_KEYS = ("rgb_volume", "depth_volume", "mask_volume")


class ObjectBinding:
    """One drawable bound to a model; ``bidx`` is its instance index in a
    shared model (None for a model of its own)."""

    def __init__(self, obj_id: str, model_id: str, query_cfg: Dict, bidx: Optional[int] = None):
        self.obj_id = obj_id
        self.model_id = model_id
        self.query_cfg = dict(query_cfg)
        self.bidx = bidx


class BufferComposeRenderer:
    """Composes K object models with the street ('cr'), distant and sky.

    ``scene_models``: role -> (model_id, query_cfg). ``accels``: role 'cr'
    (or an object's model id) -> its ``OccGridEma`` (``OccGridEmaBatched``
    for a shared model); the grid's state comes in with each call as
    ``occ_states``. ``group_budget_frac``: None, a fraction, or ``"auto"``
    (see the module's docstring); ``max_hits_per_ray``: the slot lanes a ray
    of a pair-budget group on the training path."""

    def __init__(self, scene, objects: Sequence[ObjectBinding],
                 scene_models: Dict[str, Tuple[str, Dict]], *,
                 hit_budget_frac: Optional[float] = 0.5,
                 group_budget_frac: Any = None,
                 max_hits_per_ray: int = 4,
                 accels: Optional[Dict[str, Any]] = None):
        self.scene = scene
        self.objects = list(objects)
        self.scene_models = dict(scene_models)
        self.hit_budget_frac = hit_budget_frac
        self.group_budget_frac = group_budget_frac
        self.max_hits_per_ray = max_hits_per_ray
        self.accels = dict(accels or {})

    def _grouped(self) -> Dict[str, List[ObjectBinding]]:
        groups: Dict[str, List[ObjectBinding]] = {}
        for ob in self.objects:
            groups.setdefault(ob.model_id, []).append(ob)
        return groups

    def _proposal(self, key: str, occ_states: Optional[Dict[str, Any]],
                  bidx: Optional[torch.Tensor] = None):
        """The coarse proposal from the grid of ``key``, where a state is
        given; with ``bidx`` (a shared model's rows) from each row's instance
        grid."""
        if not occ_states or key not in occ_states or key not in self.accels:
            return None
        accel, st = self.accels[key], occ_states[key]
        if bidx is None:
            return lambda ro, rd, n_, f_, nc, u: accel.ray_proposal(st, ro, rd, n_, f_, nc,
                                                                    noise=u)
        return lambda ro, rd, n_, f_, nc, u: accel.ray_proposal_batched(st, ro, rd, n_, f_, nc,
                                                                        bidx, noise=u)

    def _pair_rows(self, obs: List[ObjectBinding], n_rays: int) -> Optional[int]:
        """A group's pair budget Bg, or None for the per-instance path."""
        gf = self.group_budget_frac
        if gf == "auto":
            gf = None if len(obs) <= 4 else 1.0
        if gf is None or obs[0].bidx is None or len(obs) <= 1:
            return None
        return pair_budget(len(obs), n_rays, gf)

    def _query_group(self, params: nn.ModuleDict, frozen, model_id: str,
                     obs: List[ObjectBinding], rays_o: torch.Tensor, rays_d: torch.Tensor,
                     B: int, it, with_rgb: bool, qo: Dict[str, Any],
                     occ_states: Optional[Dict[str, Any]],
                     noise: Optional[Dict[str, Any]],
                     with_per_obj: bool) -> List[Tuple[str, Dict[str, Any]]]:
        """The K instances of one model -> [(source name, buffer)]: one
        [N, S] buffer per instance, or on the pair-budget training path one
        ``group:<model id>`` buffer of [N, M * S]. ``noise``: the field's
        draws for the group's rows (K * B, or Bg)."""
        N, K = rays_o.shape[0], len(obs)
        dev = rays_o.device
        field = params[model_id]
        w = torch.stack([frozen.world_transform(ob.obj_id) for ob in obs])  # [K, (N,) 4, 4]
        per_ray_tf = w.dim() == 4
        # [K, N, 3] canonical rays and [K, N] direction lengths
        o_l, d_l, dn = (torch.stack(v) for v in zip(
            *(frozen.rays_to_node(ob.obj_id, rays_o, rays_d) for ob in obs)))
        _, _, hit = field.space.ray_test(o_l, d_l)
        valid = torch.stack([frozen.valid(ob.obj_id).expand(N) for ob in obs])
        hit = hit & valid
        Bg = self._pair_rows(obs, N)
        qkw = dict(obs[0].query_cfg)
        inst = None if obs[0].bidx is None else \
            torch.tensor([ob.bidx for ob in obs], dtype=torch.long, device=dev)
        if Bg is not None:
            # one budget of (instance, ray) rows for the group, round-robin (K11)
            order, hit_c, slot_idx = pair_compact(
                hit, Bg, None if with_per_obj else self.max_hits_per_ray)
            k_idx = order // N
            flat = lambda a: a.reshape((K * N,) + a.shape[2:])[order]
            o_all, d_all, dn_c = flat(o_l), flat(d_l), flat(dn)
            qkw["bidx"] = inst[k_idx]
            rows = (Bg,)
        else:
            # hit-first compaction to a budget of B rows per instance: a stable
            # sort of the miss flags keeps the hits in ray order
            sel = torch.argsort((~hit).to(torch.uint8), dim=1, stable=True)[:, :B]  # [K, B]

            def take(a):
                idx = sel.reshape(sel.shape + (1,) * (a.dim() - 2)).expand((K, B) + a.shape[2:])
                return torch.gather(a, 1, idx)

            o_c, d_c, dn_c, hit_c = take(o_l), take(d_l), take(dn), take(hit)
            o_all, d_all = o_c.reshape(K * B, 3), d_c.reshape(K * B, 3)
            if inst is not None:
                qkw["bidx"] = inst.repeat_interleave(B)
            rows = (K, B)
        proposal = self._proposal(model_id, occ_states, qkw.get("bidx"))
        if proposal is not None:
            qkw.setdefault("occ_t_fn", proposal)
        buf_all = field.ray_query(o_all, d_all, it=it, with_rgb=with_rgb, noise=noise,
                                  **{**qkw, **qo})

        n_rows = rows[0] * (rows[1] if len(rows) == 2 else 1)
        is_rowed = lambda v: torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n_rows
        resh = lambda v: v.reshape(rows + v.shape[1:]) if is_rowed(v) else v
        buf = {k: resh(v) for k, v in buf_all.items() if k != "details"}
        det = {k: resh(v) for k, v in buf_all["details"].items()}
        # object-frame depth -> world depth: o_w + t_w d_w maps to o_l + (t_w |d_s|) d_l
        buf["t"] = buf["t"] / torch.clamp(dn_c[..., None], min=1e-9)
        buf["mask"] = buf["mask"] & hit_c[..., None]
        buf["alpha"] = torch.where(buf["mask"], buf["alpha"], 0.0)
        if "nablas" in buf:         # to the world frame, with each row's own pose
            if Bg is not None:
                n2w = w.reshape(K * N, 4, 4)[order] if per_ray_tf else w[k_idx]   # [Bg, 4, 4]
                buf["nablas"] = apply_rotation(n2w[:, None], buf["nablas"])
            else:
                n2w = take(w) if per_ray_tf else w[:, None]                 # [K, B|1, 4, 4]
                buf["nablas"] = apply_rotation(n2w[:, :, None], buf["nablas"])

        if Bg is not None and not with_per_obj:
            # the training path: the group as one source of M slot lanes a ray;
            # the sink row N * M takes the misses and the hits beyond M
            M = self.max_hits_per_ray

            def slot_scatter(v):
                if not (torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == Bg):
                    return v
                out = v.new_zeros((N * M + 1,) + v.shape[1:]).index_copy(0, slot_idx, v)
                out = out[:N * M].reshape((N, M) + v.shape[1:])
                return out.reshape((N, M * v.shape[1]) + v.shape[2:]) if v.dim() >= 2 else out

            g = {k: slot_scatter(v) for k, v in buf.items()}
            g["details"] = {k: slot_scatter(v) for k, v in det.items()}
            return [(f"group:{model_id}", g)]

        def scatter(v):
            """rows -> [K, N, ...], zeros where no row went."""
            if Bg is not None:
                if not (torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == Bg):
                    return v
                out = v.new_zeros((K * N,) + v.shape[1:]).index_copy(0, order, v)
                return out.reshape((K, N) + v.shape[1:])
            if not (torch.is_tensor(v) and v.dim() >= 2 and v.shape[:2] == (K, B)):
                return v
            idx = sel.reshape(sel.shape + (1,) * (v.dim() - 2)).expand(v.shape)
            out = torch.zeros((K, N) + v.shape[2:], dtype=v.dtype, device=v.device)
            return out.scatter(1, idx, v)

        buf = {k: scatter(v) for k, v in buf.items()}
        det = {k: scatter(v) for k, v in det.items()}
        pick = lambda v, ki: v[ki] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == K \
            else v
        out = []
        for ki, ob in enumerate(obs):
            b = {k: pick(v, ki) for k, v in buf.items()}
            b["details"] = {k: pick(v, ki) for k, v in det.items()}
            out.append((ob.obj_id, b))
        return out

    def ray_query(self, params: nn.ModuleDict, frozen, rays_o: torch.Tensor,
                  rays_d: torch.Tensor, *, it=None, with_rgb: bool = True,
                  only_cr: bool = False,
                  occ_states: Optional[Dict[str, Any]] = None,
                  return_buffer: bool = False,
                  query_overrides: Optional[Dict[str, Any]] = None,
                  with_per_obj: bool = True,
                  noise: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Render a flat batch of world rays [N, 3] of the frozen scene (at
        one frame, or one frame per ray) -> the rendered dict, with each
        source's share under ``rendered_per_obj_in_scene`` (objects by id,
        "street", "distant"; only the street's and the distant's without
        ``with_per_obj``, which also folds a pair-budget group into one
        source ``group:<model id>``). ``only_cr``: the street alone. ``query_overrides``
        go to every NeuS query (the distant field takes its own keys of
        them). ``noise``: {model id: that field's draws} for a training
        query (:meth:`noise_shapes`), None for the deterministic one."""
        N = rays_o.shape[0]
        qo = dict(query_overrides or {})
        noise = noise or {}
        buffers: List[Dict[str, Any]] = []
        names: List[str] = []
        B = self.budget(N)
        groups = {} if only_cr else self._grouped()
        with_distant = "distant" in self.scene_models and not only_cr
        # a street composited alone takes its alpha inside the composite (K12)
        fused = "cr" in self.scene_models and not groups and not with_distant
        for model_id, obs in groups.items():
            for name, buf in self._query_group(params, frozen, model_id, obs, rays_o, rays_d,
                                               B, it, with_rgb, qo, occ_states,
                                               noise.get(model_id), with_per_obj):
                names.append(name)
                buffers.append(buf)

        cr_far = cr_hit = None
        if "cr" in self.scene_models:
            mid, qcfg = self.scene_models["cr"]
            qcfg = dict(qcfg)
            proposal = self._proposal("cr", occ_states)
            if proposal is not None:
                qcfg.setdefault("occ_t_fn", proposal)
            buf = params[mid].ray_query(rays_o, rays_d, it=it, with_rgb=with_rgb,
                                        noise=noise.get(mid), fuse_alpha=fused,
                                        **{**qcfg, **qo})
            cr_far, cr_hit = buf["details"]["far"], buf["details"]["hit"]
            buffers.append(buf)
            names.append("street")

        if with_distant:
            mid, qcfg = self.scene_models["distant"]
            dv_near = torch.ones(N, dtype=torch.float32, device=rays_o.device) if cr_far is None \
                else torch.where(cr_hit, torch.clamp(cr_far, min=1e-3), 1.0)
            # of the overrides, the distant ladder takes its own keys
            dv_qo = {k: v for k, v in qo.items() if k in ("num_samples", "far_factor")}
            buffers.append(params[mid].ray_query(rays_o, rays_d, it=it, near=dv_near,
                                                 with_rgb=with_rgb, noise=noise.get(mid),
                                                 **{**qcfg, **dv_qo}))
            names.append("distant")

        per_idx = None if with_per_obj else \
            [i for i, n in enumerate(names) if n in ("street", "distant")]
        rendered = merge_and_integrate(buffers, with_per_src=True, per_src_indices=per_idx,
                                       sort_free=True,
                                       integrate=neus_integrate if fused else volume_integrate)
        rendered["src_names"] = names
        rendered["rendered_per_obj_in_scene"] = {
            n: r for n, r in zip(names, rendered["per_src"]) if r is not None}
        if "street" in names:
            rendered["rendered_cr"] = rendered["per_src"][names.index("street")]
            rendered["details_cr"] = buffers[names.index("street")]["details"]
        if "distant" in names:
            rendered["rendered_dv"] = rendered["per_src"][names.index("distant")]

        if with_rgb and "sky" in self.scene_models:
            sky_rgb = params[self.scene_models["sky"][0]](rays_d)
            rendered["rgb_sky"] = sky_rgb
            rendered["rgb_volume"] = rendered["rgb_volume"] \
                + (1.0 - rendered["mask_volume"][..., None]) * sky_rgb
        if not return_buffer:
            rendered.pop("merged_buffer")
        return rendered

    def budget(self, n_rays: int) -> int:
        """The compacted rows of each object instance for ``n_rays`` rays."""
        return n_rays if self.hit_budget_frac is None else \
            max(min(n_rays, int(round(n_rays * self.hit_budget_frac))), 1)

    def noise_shapes(self, n_rays: int, only_cr: bool = False) -> Dict[str, Dict[str, Any]]:
        """The draws of a training query of ``n_rays`` rays, by model id: a
        NeuS model's ``{"coarse" | "occ_proposal": (rows, num_coarse),
        "fine": [(rows, nf) per stage]}`` (its grid's proposal in place of the
        coarse jitter where it has one; a group's rows are its instances'
        compacted rows, K * budget, or its pair budget Bg), the distant
        field's ``(n_rays, num_samples)``."""
        out: Dict[str, Any] = {}

        def neus(rows: int, qcfg: Dict[str, Any], grid: bool) -> Dict[str, Any]:
            return {"occ_proposal" if grid else "coarse": (rows, qcfg.get("num_coarse", 128)),
                    "fine": [(rows, nf) for nf in qcfg.get("num_fine", (32, 32))]}

        if not only_cr:
            for model_id, obs in self._grouped().items():
                Bg = self._pair_rows(obs, n_rays)
                out[model_id] = neus(len(obs) * self.budget(n_rays) if Bg is None else Bg,
                                     obs[0].query_cfg, model_id in self.accels)
        if "cr" in self.scene_models:
            mid, qcfg = self.scene_models["cr"]
            out[mid] = neus(n_rays, qcfg, "cr" in self.accels)
        if "distant" in self.scene_models and not only_cr:
            mid, qcfg = self.scene_models["distant"]
            out[mid] = (n_rays, qcfg.get("num_samples", 64))
        return out

    @torch.no_grad()
    def render_chunked(self, params: nn.ModuleDict, frozen, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, *, rayschunk: int = 4096, **kw) -> Dict[str, Any]:
        """A whole frame in chunks of ``rayschunk`` rays, the last one padded
        to full size (rays of ones, dropped after), as the JAX package's
        ``lax.map`` does, so every chunk has the same hit budget. Returns the
        frame's volumes and ``per_obj`` {source: {rgb, depth, mask volumes}}."""
        n = rays_o.shape[0]
        pad = (-n) % rayschunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_ones((pad, 3))])
            rays_d = torch.cat([rays_d, rays_d.new_ones((pad, 3))])
        parts = []
        for s in range(0, n + pad, rayschunk):
            r = self.ray_query(params, frozen, rays_o[s:s + rayschunk],
                               rays_d[s:s + rayschunk], **kw)
            out = {k: r[k] for k in _FRAME_KEYS if k in r}
            out["per_obj"] = {name: {k: v for k, v in sub.items() if k in _SOURCE_KEYS}
                              for name, sub in r["rendered_per_obj_in_scene"].items()}
            parts.append(out)
        frame = {k: torch.cat([p[k] for p in parts])[:n] for k in parts[0] if k != "per_obj"}
        frame["per_obj"] = {name: {k: torch.cat([p["per_obj"][name][k] for p in parts])[:n]
                                   for k in sub}
                            for name, sub in parts[0]["per_obj"].items()}
        return frame

    @classmethod
    def from_asset_bank(cls, scene, bank, *, obj_query_cfg: Optional[Dict] = None,
                        cr_class: str = "Street", distant_class: str = "Distant",
                        sky_class: str = "Sky", **kw) -> "BufferComposeRenderer":
        """Bind every drawable of the scene, and the street, distant and sky
        models, from an :class:`AssetBank`. The distant field's contraction
        is set to the street's box (``fixed_cuboid_shells``) unless the
        config gave it one."""
        objects, accels = [], {}
        for oid in scene.drawable_ids():
            mid = bank.model_for(scene.id, oid)
            if mid is None or bank.assets[mid].field is None:
                continue
            asset = bank.assets[mid]
            objects.append(ObjectBinding(oid, mid, {**(obj_query_cfg or {}), **asset.query_cfg},
                                         bidx=getattr(asset, "instance_index", {}).get(oid)))
            if asset.accel is not None:
                accels[mid] = asset.accel
        scene_models = {}
        for role, cname in (("cr", cr_class), ("distant", distant_class), ("sky", sky_class)):
            for mid, asset in bank.assets.items():
                if bank.class_of[mid] == cname and asset.field is not None:
                    scene_models[role] = (mid, asset.query_cfg)
                    if role == "cr" and asset.accel is not None:
                        accels["cr"] = asset.accel
                    break
        if "cr" in scene_models and "distant" in scene_models:
            dv = bank.assets[scene_models["distant"][0]].field
            if dv.cub_center is None:
                dv.set_cr_aabb(bank.assets[scene_models["cr"][0]].field.space)
        return cls(scene, objects, scene_models, accels=accels, **kw)


def render_instance_segmentation(rendered: Dict[str, Any]) -> torch.Tensor:
    """Per ray, the index of the source with the largest visibility mass."""
    masses = torch.stack([r["mask_volume"] for r in rendered["per_src"]], dim=-1)
    return torch.argmax(masses, dim=-1)
