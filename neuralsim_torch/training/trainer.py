"""Trainer: loss assembly and the training step over a renderer (port of
neuralsim_tpu/training/trainer.py:31-71, 134-157, 213-231, 286-311, 353-418
for the ``pixel`` step of the single-scene NeuS model).

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
nothing but ``skips`` and ``it``.

Not ported yet: the lidar, image-patch and view steps, pose refinement,
appearance embeddings, the occupancy-grid refresh, ``debug_grads``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..losses.core import (eikonal_loss, mask_entropy_loss, mask_occupancy_loss,
                           photometric_loss, sparsity_loss)
from .optimizers import ModelAdam, make_optimizer


@dataclass
class TrainState:
    params: nn.ModuleDict            # updated in place by train_step
    opt: Dict[str, ModelAdam]        # per-model Adam moments and step counts
    it: int                          # loop iteration (host): drives the annealers
    skips: torch.Tensor              # steps skipped by the finite guard (device int32)


class Trainer:
    """Drives one renderer and loss config.

    loss_cfgs keys: ``rgb`` {fn_type, fn_param, w}, ``occupancy_mask`` {w,
    mode}, ``mask_entropy`` {w, mode}, ``eikonal`` {w, noise_std,
    on_render_ratio}, ``sparsity`` {w, inv_scale}. training_cfgs:
    {model id: optimizer config}.
    """

    def __init__(self, renderer, loss_cfgs: Dict[str, Dict],
                 training_cfgs: Optional[Dict[str, Dict]] = None,
                 uniform_sample_n: int = 1024,
                 default_optim_cfg: Optional[Dict] = None):
        self.renderer = renderer
        self.loss_cfgs = dict(loss_cfgs)
        self.training_cfgs = dict(training_cfgs or {})
        self.uniform_sample_n = uniform_sample_n
        self.default_optim_cfg = default_optim_cfg or {"lr": 1e-2, "betas": (0.9, 0.99),
                                                       "eps": 1e-15}

    def init_state(self, params: nn.ModuleDict) -> TrainState:
        opt = make_optimizer(self.training_cfgs, params, self.default_optim_cfg)
        dev = next(params.parameters()).device
        return TrainState(params, opt, 0, torch.zeros((), dtype=torch.int32, device=dev))

    def draw_noise(self, n_rays: int, generator: torch.Generator) -> Dict[str, Any]:
        """One step's random draws: the coarse jitter and each upsample
        stage's stratified noise (uniform), the uniform points of the geometry
        regularisers and, where the eikonal config asks for it, normal noise
        on the norms, all on the generator's device."""
        cfg = self.renderer.query_cfg
        dev = generator.device
        rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
        noise: Dict[str, Any] = {
            "coarse": rand(n_rays, cfg.get("num_coarse", 128)),
            "fine": [rand(n_rays, nf) for nf in cfg.get("num_fine", (32, 32))],
            "uniform": rand(self.uniform_sample_n, 3)}
        if self.loss_cfgs.get("eikonal", {}).get("noise_std", 0.0) > 0:
            noise["eikonal"] = torch.randn((self.uniform_sample_n,), generator=generator,
                                           device=dev)
        return noise

    def compute_losses(self, params: nn.ModuleDict, batch: Dict[str, torch.Tensor], it: int,
                       noise: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        """The loss dict of one pixel batch {rays_o, rays_d, image_rgb,
        image_occupancy_mask?} -> (total, {"losses", "aux"})."""
        cr = params[self.renderer.pkey("cr")]
        losses: Dict[str, torch.Tensor] = {}
        aux: Dict[str, Any] = {}
        rendered = self.renderer.ray_query(params, batch["rays_o"], batch["rays_d"], it=it,
                                           noise=noise, with_rgb=True, return_buffer=True)
        buf = rendered["merged_buffer"]

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

        total = sum(losses.values(), torch.zeros((), device=batch["rays_o"].device))
        aux["rendered_mask_mean"] = rendered["mask_volume"].detach().mean()
        aux["inv_s"] = rendered["details_cr"]["inv_s"].detach()
        return total, {"losses": losses, "aux": aux}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Dict[str, Any]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step behind the finite guard. Returns the state
        (parameters and optimizers updated in place, ``it`` advanced) and the
        step's metrics, all device tensors: nothing here waits for the card."""
        total, extras = self.compute_losses(state.params, batch, state.it, noise)
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
        state.it += 1
        metrics = {"loss_total": total.detach(),
                   **{k: v.detach() for k, v in extras["losses"].items()}, **extras["aux"],
                   "step_skipped": skipped, "skips_total": state.skips}
        return state, metrics


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
