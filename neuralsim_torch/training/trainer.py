"""Trainer: loss assembly and the training step over a renderer (port of
neuralsim_tpu/training/trainer.py:31-71, 118-133, 134-350, 353-418 for the
``pixel`` and ``lidar`` steps of the single-scene models).

PyTorch runs eagerly, so the step is plain Python around autograd: render with
``return_buffer=True``, assemble the losses, differentiate, and step each
model's Adam behind the finite guard. Parameters live in the field modules
and are updated in place. Every random draw of a step comes in as ``noise``
(:meth:`Trainer.draw_noise` makes it from a ``torch.Generator``), so two runs
with the same noise take the same step.

The finite guard never syncs with the host: one device flag ``ok`` (the total
loss and every gradient are finite) selects, inside each optimizer, between
the new and the old value of every parameter, moment and step count
(``torch.where``), and ``skips`` counts on the device. A skipped step changes
nothing but ``skips``, ``it`` and, on its cadence, the occupancy grid.

Where the renderer has occupancy grids, their states ride in
``TrainState.occ``: the render reads them, and after the optimizer step each
grid is refreshed on its cadence from the parameters as the guard left them
(``it`` is a host integer, so the cadence is a host branch; the refresh runs
under ``torch.no_grad()``).

A pixel batch comes either as world rays {rays_o, rays_d, ...} or, with a
``scene``, as (frame, pixel) of camera ``cam_id`` {rays_fidx, rays_xy, ...},
lifted to world rays inside the step through the scene frozen at each ray's
frame (``slice_at``) or, with ``use_ts_interp``, at the camera's timestamp of
that frame (``sensor_ts`` + ``interp_at``). With a pose model
(``pose_model_id``: a ``LearnableParams`` asset's id in the parameters), its
deltas enter that lift, each multiplied by the gate ``it >=
pose_enable_after`` (0 or 1, as JAX multiplies: before the gate the deltas'
gradients are exact zeros and their Adam still counts the step), the camera's
``dts`` refining its timestamps in timestamp mode; the gradient then reaches
the deltas through the rays. A
``lidar`` step (StreetSurf's) renders the close range alone (``only_cr``),
with no rgb, for the depth and line-of-sight losses on the beams' ranges; it
does not advance ``it`` or refresh a grid (``advance_it=False``). With an
``embed_model`` (an ``ImageEmbeddings`` asset and its model id) each pixel
ray takes its frame's appearance code as ``h_appear``. A time-conditioned
close range (EmerNeRF's, ``use_time``) takes each ray's frame time
``rays_fidx / (n_frames - 1)`` of the scene as ``cond``, and EmerNeRF's
self-supervision: the flow cycle on uniform points and times of the box
(``flow``) and the mean dynamic density of the rendered lanes
(``dynamic_sparsity``).

Not ported yet (each raises, naming itself): the image-patch and view steps,
the image post-processor, the cross_cr_dv mask entropy, ``debug_grads`` and
the losses of ``NOT_PORTED_LOSSES``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

import warnings

from ..losses.core import (clearance_loss, eikonal_loss, lidar_loss, mask_entropy_loss,
                           mask_occupancy_loss, photometric_loss, sparsity_loss)
from ..fields.neus import map_chunked
from ..scene.observers import camera_get_selected_rays
from .optimizers import ModelAdam, make_optimizer

STEP_TYPES = ("pixel", "lidar")
# loss keys that the JAX trainer reads and this one does not compute (s3im,
# perceptual and the monocular cues belong to the image-patch and view steps)
NOT_PORTED_LOSSES = ("weight_reg", "ray_vw_entropy", "color_lipschitz", "mono_depth",
                     "mono_normals", "perceptual", "road_normal", "sdf_curvature", "s3im")


@dataclass
class TrainState:
    params: nn.ModuleDict            # updated in place by train_step
    opt: Dict[str, ModelAdam]        # per-model Adam moments and step counts
    it: int                          # loop iteration (host): drives the annealers
    skips: torch.Tensor              # steps skipped by the finite guard (device int32)
    occ: Optional[Dict[str, Any]] = None   # {role: OccGridState} of the renderer's grids


class Trainer:
    """Drives one renderer and loss config.

    loss_cfgs keys: ``rgb`` {fn_type, fn_param, w}, ``occupancy_mask`` {w,
    mode}, ``mask_entropy`` {w, mode}, ``eikonal`` {w, noise_std,
    on_render_ratio}, ``sparsity`` {w, inv_scale}, ``clearance`` {w, thresh,
    beta}, ``lidar`` {w, discard_toofar, discard_outliers_median, depth,
    line_of_sight}, ``flow`` {w, n_samples}, ``dynamic_sparsity`` {w}; the
    keys of ``NOT_PORTED_LOSSES`` raise. training_cfgs: {model id: optimizer
    config}. ``scene``: the scene that pixel batches of (frame, pixel) are
    lifted through (and whose ``n_frames`` normalises the frame time);
    ``embed_model``: (ImageEmbeddings asset, its model id) or None.
    ``pose_model_id``: the model id of a ``LearnableParams`` asset, whose
    deltas apply from iteration ``pose_enable_after`` on; ``use_ts_interp``:
    lift pixel batches at the camera's timestamps.
    """

    def __init__(self, renderer, loss_cfgs: Dict[str, Dict],
                 training_cfgs: Optional[Dict[str, Dict]] = None,
                 uniform_sample_n: int = 1024,
                 default_optim_cfg: Optional[Dict] = None,
                 scene=None, pose_model_id: Optional[str] = None,
                 pose_enable_after: int = 0,
                 embed_model: Optional[Tuple[Any, str]] = None,
                 debug_grads: bool = False, use_ts_interp: bool = False):
        if debug_grads:
            raise NotImplementedError("debug_grads is not ported")
        for name in NOT_PORTED_LOSSES:
            if name in loss_cfgs:
                raise NotImplementedError(f"the {name} loss is not ported")
        self.renderer = renderer
        self.loss_cfgs = dict(loss_cfgs)
        self.training_cfgs = dict(training_cfgs or {})
        self.uniform_sample_n = uniform_sample_n
        self.scene = scene
        self.pose_model_id = pose_model_id
        self.pose_enable_after = pose_enable_after
        self.use_ts_interp = use_ts_interp
        self.embed_model = embed_model
        self.default_optim_cfg = default_optim_cfg or {"lr": 1e-2, "betas": (0.9, 0.99),
                                                       "eps": 1e-15}
        me_mode = self.loss_cfgs.get("mask_entropy", {}).get("mode", "")
        if me_mode.startswith("cross"):
            if "distant" in renderer.param_keys:
                raise NotImplementedError(f"the {me_mode} mask entropy is not ported")
            # as the JAX trainer: without a distant model a cross* mode is the
            # generic mask entropy
            warnings.warn(f"mask_entropy mode '{me_mode}' needs a distant model in the "
                          f"renderer; falling back to the generic mask-entropy loss",
                          stacklevel=2)

    def init_state(self, params: nn.ModuleDict) -> TrainState:
        opt = make_optimizer(self.training_cfgs, params, self.default_optim_cfg)
        dev = next(params.parameters()).device
        occ = {role: accel.init_state() for role, accel in self.renderer.accels.items()}
        return TrainState(params, opt, 0, torch.zeros((), dtype=torch.int32, device=dev),
                          occ or None)

    def draw_noise(self, n_rays: int, generator: torch.Generator,
                   it: Optional[int] = None, step_type: str = "pixel") -> Dict[str, Any]:
        """One step's random draws, all on the generator's device: the coarse
        jitter (``"occ_proposal"`` instead of ``"coarse"`` where the occupancy
        grid places the coarse samples), each upsample stage's stratified
        noise, the distant ladder's jitter where the renderer has a distant
        model (not for a ``lidar`` step, which renders the close range
        alone), the uniform points of the geometry regularisers, where the
        eikonal config asks for it normal noise on the norms, where a
        pixel step at ``it`` refreshes an occupancy grid, ``"occ_update"``:
        {role: the voxel jitter}, and with the ``flow`` loss its points
        ``"flow_points"`` [n, 3] and times ``"flow_times"`` [n] (n: the loss's
        ``n_samples``, by default ``uniform_sample_n`` or 1,024)."""
        if step_type not in STEP_TYPES:
            raise NotImplementedError(f"the {step_type} step is not ported")
        pixel = step_type == "pixel"
        cfg = self.renderer.query_cfg
        dev = generator.device
        rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
        accels = self.renderer.accels
        noise: Dict[str, Any] = {
            "occ_proposal" if "cr" in accels else "coarse":
                rand(n_rays, cfg.get("num_coarse", 128)),
            "fine": [rand(n_rays, nf) for nf in cfg.get("num_fine", (32, 32))],
            "uniform": rand(self.uniform_sample_n, 3)}
        if "distant" in self.renderer.param_keys and pixel:
            noise["distant"] = rand(
                n_rays, self.renderer.distant_query_cfg.get("num_samples", 64))
        refresh = {role: rand(a.samples_per_voxel, a.res, a.res, a.res, 3)
                   for role, a in accels.items()
                   if pixel and it is not None and it % a.n_steps_between_update == 0}
        if refresh:
            noise["occ_update"] = refresh
        if self.loss_cfgs.get("eikonal", {}).get("noise_std", 0.0) > 0:
            noise["eikonal"] = torch.randn((self.uniform_sample_n,), generator=generator,
                                           device=dev)
        if "flow" in self.loss_cfgs:
            # a mean over no sample is NaN: 1,024 where uniform_sample_n is 0
            n_flow = int(self.loss_cfgs["flow"].get("n_samples", self.uniform_sample_n or 1024))
            noise["flow_points"], noise["flow_times"] = rand(n_flow, 3), rand(n_flow)
        return noise

    def time_cond(self, cr, batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """Each ray's normalised frame time [N, 1], ``rays_fidx / (n_frames -
        1)``, for a time-conditioned close range with a scene of frames."""
        if not getattr(cr, "use_time", False) or "rays_fidx" not in batch:
            return None
        n_fr = self.scene.n_frames if self.scene is not None else None
        if not n_fr:
            return None
        return (batch["rays_fidx"].to(torch.float32) / max(n_fr - 1, 1))[:, None]

    def h_appear(self, params: nn.ModuleDict, batch: Dict[str, torch.Tensor],
                 cam_id: Optional[str]) -> Optional[torch.Tensor]:
        """Each ray's appearance code [N, dim] from its frame index, where the
        trainer has an embedding model with a table for ``cam_id``."""
        if self.embed_model is None or cam_id is None or "rays_fidx" not in batch:
            return None
        easset, emid = self.embed_model
        if emid not in params or cam_id not in easset.tables:
            return None
        return easset.h_appear(params[emid], cam_id, batch["rays_fidx"].long())

    def pose_deltas(self, params: nn.ModuleDict, it: int
                    ) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """The pose model's deltas {node: {name: tensor}} times the gate
        ``it >= pose_enable_after`` (0 or 1), or None without a pose model."""
        if not self.pose_model_id or self.pose_model_id not in params:
            return None
        gate = float(it >= self.pose_enable_after)
        return {nid: {k: v * gate for k, v in pd.items()}
                for nid, pd in params[self.pose_model_id].items()}

    def lift(self, params: nn.ModuleDict, batch: Dict[str, torch.Tensor], it: int,
             cam_id: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The world rays of a pixel batch {rays_fidx, rays_xy} of camera
        ``cam_id``: through the scene frozen at each ray's frame, or at the
        camera's (refined) timestamp of it with ``use_ts_interp``, with the
        gated pose deltas applied."""
        fidx = batch["rays_fidx"].long()
        deltas = self.pose_deltas(params, it)
        if self.use_ts_interp:
            dts = (deltas or {}).get(cam_id, {}).get("dts")
            frozen = self.scene.interp_at(self.scene.sensor_ts(cam_id, fidx, dts),
                                          pose_deltas=deltas)
        else:
            frozen = self.scene.slice_at(fidx, pose_deltas=deltas)
        return camera_get_selected_rays(frozen, cam_id, batch["rays_xy"])

    def compute_losses(self, params: nn.ModuleDict, batch: Dict[str, torch.Tensor], it: int,
                       noise: Dict[str, Any], occ: Optional[Dict[str, Any]] = None,
                       step_type: str = "pixel", cam_id: Optional[str] = None
                       ) -> Tuple[torch.Tensor, Dict]:
        """The loss dict of one batch -> (total, {"losses", "aux"}): a pixel
        batch {rays_o, rays_d | rays_fidx, rays_xy (of camera ``cam_id``);
        image_rgb, image_occupancy_mask?}, or a LiDAR batch {rays_o, rays_d,
        ranges}. ``occ``: the occupancy grids' states, handed to the
        renderer. ``noise``: :meth:`draw_noise`'s draws."""
        if step_type not in STEP_TYPES:
            raise NotImplementedError(f"the {step_type} step is not ported")
        cr = params[self.renderer.pkey("cr")]
        losses: Dict[str, torch.Tensor] = {}
        aux: Dict[str, Any] = {}
        if "rays_xy" in batch and self.scene is not None:
            ro, rd = self.lift(params, batch, it, cam_id)
            batch = {**batch, "rays_o": ro.contiguous(), "rays_d": rd.contiguous()}
        lidar = step_type == "lidar"
        rendered = self.renderer.ray_query(params, batch["rays_o"], batch["rays_d"], it=it,
                                           noise=noise, with_rgb=not lidar, only_cr=lidar,
                                           return_buffer=True, occ_states=occ,
                                           h_appear=self.h_appear(params, batch, cam_id),
                                           cond=self.time_cond(cr, batch))
        buf = rendered["merged_buffer"]

        if step_type == "pixel":
            if "rgb" in self.loss_cfgs:
                losses["loss_rgb"], ph_aux = photometric_loss(rendered, batch, it,
                                                              self.loss_cfgs["rgb"])
                aux.update(ph_aux)
            if "occupancy_mask" in self.loss_cfgs and "image_occupancy_mask" in batch:
                losses["loss_mask"] = mask_occupancy_loss(rendered, batch, it,
                                                          self.loss_cfgs["occupancy_mask"])
            if "mask_entropy" in self.loss_cfgs:
                losses["loss_mask_entropy"] = mask_entropy_loss(rendered, it,
                                                                self.loss_cfgs["mask_entropy"])
        if lidar and "lidar" in self.loss_cfgs:
            # the close range's weights: the composite's, as alpha_to_vw's
            losses["loss_lidar"], lid_aux = lidar_loss(
                rendered, batch["ranges"], it, self.loss_cfgs["lidar"],
                buf={**buf, "vw": rendered["vw"]})
            aux.update({f"lidar_{k}": v for k, v in lid_aux.items()})

        # geometry regularisers on uniform points and on the rendered samples
        if "eikonal" in self.loss_cfgs or "sparsity" in self.loss_cfgs:
            _, sdf_u, nablas_u = cr.sample_pts_uniform(noise["uniform"])
            if "eikonal" in self.loss_cfgs:
                cfg = self.loss_cfgs["eikonal"]
                loss_eik = eikonal_loss(nablas_u, it, cfg, noise=noise.get("eikonal"))
                orr = cfg.get("on_render_ratio", 0.1)
                if orr > 0:
                    loss_eik = loss_eik + orr * eikonal_loss(buf["nablas"], it, cfg,
                                                             mask=buf["mask"].float())
                losses["loss_eikonal"] = loss_eik
            if "sparsity" in self.loss_cfgs:
                losses["loss_sparsity"] = sparsity_loss(sdf_u, it, self.loss_cfgs["sparsity"])
        if "clearance" in self.loss_cfgs:
            losses["loss_clearance"] = clearance_loss(rendered["details_cr"]["near_sdf"], it,
                                                      self.loss_cfgs["clearance"])
        # EmerNeRF's self-supervision: the flow cycle on uniform space-time
        # points, and the dynamic density of the rendered lanes
        if "flow" in self.loss_cfgs and getattr(cr, "with_flow", False):
            res = cr.flow_cycle_residual(cr.space.uniform_points(noise["flow_points"]),
                                         noise["flow_times"])
            losses["loss_flow"] = torch.mean(res) * self.loss_cfgs["flow"].get("w", 0.01)
        if "dynamic_sparsity" in self.loss_cfgs and "sigma_dynamic_cr" in rendered:
            losses["loss_dynamic_sparsity"] = torch.mean(
                torch.abs(rendered["sigma_dynamic_cr"])) \
                * self.loss_cfgs["dynamic_sparsity"].get("w", 0.01)

        total = sum(losses.values(), torch.zeros((), device=batch["rays_o"].device))
        aux["rendered_mask_mean"] = rendered["mask_volume"].detach().mean()
        inv_s = rendered["details_cr"].get("inv_s")
        aux["inv_s"] = total.new_zeros(()) if inv_s is None else inv_s.detach()
        return total, {"losses": losses, "aux": aux}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Dict[str, Any], step_type: str = "pixel",
                   cam_id: Optional[str] = None, advance_it: bool = True
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step of ``step_type`` behind the finite guard. Returns
        the state (parameters and optimizers updated in place; with
        ``advance_it``, the grids refreshed on their cadence and ``it``
        advanced) and the step's metrics, all device tensors: nothing here
        waits for the card."""
        total, extras = self.compute_losses(state.params, batch, state.it, noise, state.occ,
                                            step_type, cam_id)
        metrics = guarded_step(state, total, extras)
        if state.occ is not None:
            if advance_it:
                self.refresh_occ(state, noise.get("occ_update", {}))
            if "cr" in state.occ:
                metrics["occ_frac"] = self.renderer.accels["cr"].occupied_fraction(
                    state.occ["cr"])
        if advance_it:
            state.it += 1
        return state, metrics

    @torch.no_grad()
    def refresh_occ(self, state: TrainState, jitter: Dict[str, torch.Tensor]) -> None:
        """Refresh each occupancy grid on its cadence at ``state.it``, from the
        parameters as they stand after the guard (a skipped step refreshes
        too, from the unchanged parameters). ``jitter``: {role: the voxel
        jitter of :meth:`draw_noise`}. The 128^3 field evaluation runs in
        pieces of the field's ``eval_chunk``."""
        for role, accel in self.renderer.accels.items():
            field = state.params[self.renderer.pkey(role)]
            lines = field.encoding.kernel_lines()
            query = lambda x: map_chunked(lambda c: field.query_sdf(c, lines), x,
                                          field.eval_chunk)
            state.occ[role] = accel.maybe_update(state.occ[role], query, jitter.get(role),
                                                 state.it)


def guarded_step(state: TrainState, total: torch.Tensor, extras: Dict) -> Dict[str, Any]:
    """Differentiate ``total`` with respect to every optimized parameter (a
    parameter that ``total`` does not reach gets a zero gradient, and its Adam
    still steps), and step each model's Adam behind the finite guard: one
    device flag, the loss and every gradient finite, selects the new or the
    old values; ``state.skips`` counts the skipped steps. Returns the step's
    metrics (device tensors) from ``extras`` {"losses", "aux"}."""
    plist = [p for opt in state.opt.values() for p in opt.params]
    grads = torch.autograd.grad(total, plist, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]
    ok = torch.isfinite(total.detach())
    for g in grads:
        ok = ok & torch.isfinite(g).all()
    at = 0
    for opt in state.opt.values():
        opt.step(grads[at:at + len(opt.params)], ok)
        at += len(opt.params)
    skipped = (~ok).to(torch.int32)
    state.skips = state.skips + skipped
    return {"loss_total": total.detach(),
            **{k: v.detach() for k, v in extras["losses"].items()}, **extras["aux"],
            "step_skipped": skipped, "skips_total": state.skips}


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
