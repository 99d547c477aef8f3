"""Multi-object trainer over the compose renderer (port of
neuralsim_tpu/training/multi_trainer.py:28-385, for the ``pixel`` and
``lidar`` step types).

One loop iteration of the JAX package's ``train_multi`` takes a LiDAR step
(the street alone, ``only_cr``; depth and line-of-sight losses; ``it`` does
not advance) and then a pixel step (every source; rgb and occupancy-mask
losses; ``it`` advances and the grids refresh on their cadence). Both
step types add the uniform eikonal and sparsity of every NeuS model (objects,
then the street), the on-render eikonal on the NeuS lanes of the merged
buffer, the clearance of the street's first samples and the latent
regulariser.

The scene is frozen at the batch's frame indices, one frame per ray, inside
the step: a pixel batch comes as (camera, frame, pixel) and is lifted to
world rays here; a LiDAR batch comes lifted (:func:`lift_lidar_batch`).
Every random draw comes in as ``noise`` (:meth:`MultiObjectTrainer.draw_noise`),
and each model's Adam steps on both step types behind the finite guard (a
model that no loss of the step reaches steps with a zero gradient). ``it`` is
a host integer; nothing in a step waits for the card.

Not ported (each raises, naming itself): time-conditioned fields (``cond``),
pose refinement (``build_multi_trainer`` refuses a ``LearnableParams``
asset), appearance embeddings, the image post-processor, the ``image_patch``
and ``view`` steps, the flow, deformation and dynamic sparsity losses,
``debug_grads`` and ``use_ts_interp``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..fields.neus import NeuSField, map_chunked
from ..losses.core import (clearance_loss, eikonal_loss, lidar_loss, mask_entropy_loss,
                           mask_occupancy_loss, photometric_loss, sparsity_loss)
from ..scene.observers import camera_get_selected_rays, lidar_rays_to_world
from .optimizers import make_optimizer
from .trainer import TrainState, guarded_step

STEP_TYPES = ("pixel", "lidar")
_NOT_PORTED_LOSSES = ("flow", "dynamic_sparsity", "deformation", "s3im", "perceptual",
                      "mono_depth", "mono_normals")


def lift_lidar_batch(scene, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A LiDAR batch {lidar_id, rays_fidx, rays_o_local, rays_d_local, ranges}
    (tensors on the scene's device) -> world rays {rays_o, rays_d, ranges,
    rays_fidx}, each beam from its frame's sensor pose."""
    fr = scene.slice_at(batch["rays_fidx"].long())
    ro, rd = lidar_rays_to_world(fr, batch["lidar_id"], batch["rays_o_local"],
                                 batch["rays_d_local"])
    return {"rays_o": ro, "rays_d": rd, "ranges": batch["ranges"],
            "rays_fidx": batch["rays_fidx"]}


class MultiObjectTrainer:
    """Drives a :class:`~neuralsim_torch.renderers.buffer_compose.BufferComposeRenderer`
    over a scene; loss configs as the JAX package's (``rgb``,
    ``occupancy_mask``, ``mask_entropy``, ``eikonal``, ``sparsity``,
    ``clearance``, ``latent``, ``lidar``), ``training_cfgs`` {model id:
    optimizer config}."""

    def __init__(self, scene, renderer, loss_cfgs: Dict[str, Dict],
                 training_cfgs: Optional[Dict[str, Dict]] = None,
                 uniform_sample_n: int = 256,
                 default_optim_cfg: Optional[Dict] = None,
                 debug_grads: bool = False, use_ts_interp: bool = False):
        for name in _NOT_PORTED_LOSSES:
            if name in loss_cfgs:
                raise NotImplementedError(f"the {name} loss is not ported")
        if debug_grads:
            raise NotImplementedError("debug_grads is not ported")
        if use_ts_interp:
            raise NotImplementedError("use_ts_interp (interp_at) is not ported")
        self.scene = scene
        self.renderer = renderer
        self.loss_cfgs = dict(loss_cfgs)
        self.training_cfgs = dict(training_cfgs or {})
        self.uniform_sample_n = uniform_sample_n
        self.default_optim_cfg = default_optim_cfg or {"lr": 1e-2, "betas": (0.9, 0.99),
                                                       "eps": 1e-15}

    def init_state(self, params: nn.ModuleDict) -> TrainState:
        """Per-model Adam, ``it`` 0, no skips, and the renderer's occupancy
        grids at their initial state (``{role: OccGridState}``)."""
        opt = make_optimizer(self.training_cfgs, params, self.default_optim_cfg)
        dev = next(params.parameters()).device
        occ = {role: accel.init_state() for role, accel in self.renderer.accels.items()}
        return TrainState(params, opt, 0, torch.zeros((), dtype=torch.int32, device=dev),
                          occ or None)

    def _model_ids(self):
        """The NeuS models in the JAX package's order: the objects' models,
        then the street ('cr')."""
        out = []
        for ob in self.renderer.objects:
            if ob.model_id not in out:
                out.append(ob.model_id)
        if "cr" in self.renderer.scene_models:
            mid = self.renderer.scene_models["cr"][0]
            if mid not in out:
                out.append(mid)
        return out

    def draw_noise(self, step_type: str, n_rays: int, generator: torch.Generator,
                   it: Optional[int] = None) -> Dict[str, Any]:
        """One step's draws on the generator's device: ``"render"`` {model
        id: that field's draws} (``BufferComposeRenderer.noise_shapes``; the
        street alone for a LiDAR step), ``"uniform"`` {model id: [n, 3]} for
        the uniform eikonal and sparsity, normal ``"eikonal"`` noise where the
        eikonal config asks for it, and, for a pixel step whose ``it`` falls
        on a grid's cadence, ``"occ_update"`` {role: the voxel jitter}."""
        if step_type not in STEP_TYPES:
            raise NotImplementedError(f"the {step_type} step is not ported")
        dev = generator.device
        rand = lambda shape: torch.rand(shape, generator=generator, device=dev)

        def draws(spec):
            if isinstance(spec, tuple):
                return rand(spec)
            if isinstance(spec, list):
                return [draws(s) for s in spec]
            return {k: draws(v) for k, v in spec.items()}

        noise: Dict[str, Any] = {
            "render": draws(self.renderer.noise_shapes(n_rays, only_cr=step_type == "lidar")),
            "uniform": {mid: rand((self.uniform_sample_n, 3)) for mid in self._model_ids()}}
        if self.loss_cfgs.get("eikonal", {}).get("noise_std", 0.0) > 0:
            noise["eikonal"] = torch.randn((self.uniform_sample_n,), generator=generator,
                                           device=dev)
        if step_type == "pixel" and it is not None:
            refresh = {role: rand(a.jitter_shape) for role, a in self.renderer.accels.items()
                       if it % a.n_steps_between_update == 0}
            if refresh:
                noise["occ_update"] = refresh
        return noise

    def compute_losses(self, params: nn.ModuleDict, batch: Dict[str, torch.Tensor], it: int,
                       noise: Dict[str, Any], step_type: str = "pixel",
                       occ: Optional[Dict[str, Any]] = None, cam_id: Optional[str] = None
                       ) -> Tuple[torch.Tensor, Dict]:
        """The losses of one batch -> (total, {"losses", "aux"}). A pixel
        batch is {rays_fidx [N], rays_xy [N, 2], image_rgb, image_occupancy_mask}
        of camera ``cam_id``; a LiDAR batch {rays_fidx, rays_o, rays_d, ranges}."""
        if step_type not in STEP_TYPES:
            raise NotImplementedError(f"the {step_type} step is not ported")
        with_rgb = step_type != "lidar"
        frozen = self.scene.slice_at(batch["rays_fidx"].long())
        if "rays_xy" in batch:
            ro, rd = camera_get_selected_rays(frozen, cam_id, batch["rays_xy"])
            batch = {**batch, "rays_o": ro.contiguous(), "rays_d": rd.contiguous()}
        rendered = self.renderer.ray_query(
            params, frozen, batch["rays_o"], batch["rays_d"], it=it, with_rgb=with_rgb,
            only_cr=step_type == "lidar", occ_states=occ, return_buffer=True,
            with_per_obj=False, noise=noise["render"])
        buf = rendered["merged_buffer"]
        cfgs = self.loss_cfgs
        losses: Dict[str, torch.Tensor] = {}
        aux: Dict[str, Any] = {}
        if step_type == "pixel":
            if "rgb" in cfgs:
                losses["loss_rgb"], ph = photometric_loss(rendered, batch, it, cfgs["rgb"])
                aux.update(ph)
            if "occupancy_mask" in cfgs and "image_occupancy_mask" in batch:
                losses["loss_mask"] = mask_occupancy_loss(rendered, batch, it,
                                                          cfgs["occupancy_mask"])
            if "mask_entropy" in cfgs:
                if cfgs["mask_entropy"].get("mode", "").startswith("cross"):
                    raise NotImplementedError("the cross_cr_dv mask entropy is not ported")
                losses["loss_mask_entropy"] = mask_entropy_loss(rendered, it,
                                                                cfgs["mask_entropy"])
        if step_type == "lidar" and "lidar" in cfgs:
            # the single street buffer's weights: the K6 composite's, as alpha_to_vw's
            losses["loss_lidar"], lid_aux = lidar_loss(
                rendered, batch["ranges"], it, cfgs["lidar"], buf={**buf, "vw": rendered["vw"]})
            aux.update({f"lidar_{k}": v for k, v in lid_aux.items()})

        if "eikonal" in cfgs or "sparsity" in cfgs:
            total_eik = total_sparse = None
            for mid in self._model_ids():
                field = params[mid]
                x = field.space.uniform_points(noise["uniform"][mid])
                bidx = torch.zeros(x.shape[:-1], dtype=torch.long, device=x.device) \
                    if getattr(field, "n_instances", 0) else None
                sdf_u, nab, _ = field.sdf_nablas_feat(x, bidx=bidx)
                if "eikonal" in cfgs:
                    e = eikonal_loss(nab, it, cfgs["eikonal"], noise=noise.get("eikonal"))
                    total_eik = e if total_eik is None else total_eik + e
                if "sparsity" in cfgs:
                    sp = sparsity_loss(sdf_u, it, cfgs["sparsity"])
                    total_sparse = sp if total_sparse is None else total_sparse + sp
            if "eikonal" in cfgs:
                orr = cfgs["eikonal"].get("on_render_ratio", 0.1)
                if orr > 0:
                    # the NeuS lanes only: the street and every object, not the
                    # distant field (whose lanes carry zero nablas)
                    emask = buf["mask"]
                    for i, nm in enumerate(rendered["src_names"]):
                        if nm != "street" and nm.startswith(("distant", "sky")):
                            emask = emask & (buf["src"] != i)
                    total_eik = total_eik + orr * eikonal_loss(buf["nablas"], it, cfgs["eikonal"],
                                                               mask=emask.float())
                losses["loss_eikonal"] = total_eik
            if "sparsity" in cfgs:
                losses["loss_sparsity"] = total_sparse
        if "clearance" in cfgs and "details_cr" in rendered:
            losses["loss_clearance"] = clearance_loss(rendered["details_cr"]["near_sdf"], it,
                                                      cfgs["clearance"])
        if "latent" in cfgs:
            lat = [params[mid].latent_norm() for mid in self._model_ids()
                   if hasattr(params[mid], "latent_norm")]
            losses["loss_latent"] = sum(lat[1:], lat[0]) * cfgs["latent"].get("w", 1e-3) \
                if lat else torch.zeros((), device=buf["t"].device)

        total = sum(losses.values(), torch.zeros((), device=buf["t"].device))
        aux["rendered_mask_mean"] = rendered["mask_volume"].detach().mean()
        return total, {"losses": losses, "aux": aux}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Dict[str, Any], step_type: str = "pixel",
                   cam_id: Optional[str] = None, advance_it: bool = True
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step of ``step_type`` behind the finite guard. With
        ``advance_it`` (the pixel step of a loop iteration) the grids refresh
        on their cadence and ``it`` advances. Metrics are device tensors, under
        the JAX multi-object step's keys (no ``occ_frac``: a caller reads the
        street grid's share with ``renderer.accels["cr"].occupied_fraction``)."""
        total, extras = self.compute_losses(state.params, batch, state.it, noise, step_type,
                                            state.occ, cam_id)
        metrics = guarded_step(state, total, extras)
        if state.occ is not None and advance_it:
            self.refresh_occ(state, noise.get("occ_update", {}))
        if advance_it:
            state.it += 1
        return state, metrics

    @torch.no_grad()
    def refresh_occ(self, state: TrainState, jitter: Dict[str, torch.Tensor]) -> None:
        """Refresh each grid on its cadence at ``state.it`` from the SDF of its
        model as the guard left it (the street's for role 'cr'; a shared
        model's batched grids from each instance's SDF, ``query_sdf(x, bidx)``
        over all B R^3 voxels), in chunks of the field's ``eval_chunk``."""
        for role, accel in self.renderer.accels.items():
            mid = self.renderer.scene_models["cr"][0] if role == "cr" else role
            field: NeuSField = state.params[mid]
            lines = field.encoding.kernel_lines()
            sdf = lambda x, b=None, f=field, ln=lines: f.query_sdf(x, ln, b)
            query = lambda x, *b, f=field, q=sdf: map_chunked(q, x, f.eval_chunk, *b)
            state.occ[role] = accel.maybe_update(state.occ[role], query, jitter.get(role),
                                                 state.it)
