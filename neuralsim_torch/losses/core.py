"""The training losses of the single-scene and multi-object NeuS steps, on the
``rendered`` dict (port of neuralsim_tpu/losses/core.py:23-145, 191-253).

Every loss is a function ``(rendered / ground truth / samples, it, cfg) ->
scalar``; per-loss weights, with their anneal and ``enable_after`` gate, come
from :func:`_w`. The mono-cue, curvature, colour-Lipschitz, weight and
ray-entropy regularisers are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..maths.common import normalized_logistic_density, safe_norm
from ..ops.segment import alpha_to_vw
from ..training.annealers import get_anneal_val
from .recon import get_recon_fn, reduce, safe_binary_cross_entropy, safe_mse_loss


def _w(cfg: Dict, it, default: float = 1.0) -> float:
    """A loss weight from its ``{w, anneal, enable_after}`` config."""
    w = cfg.get("w", default)
    if isinstance(w, dict):
        return get_anneal_val(it, **w)
    w = float(w)
    anneal = cfg.get("anneal")
    if anneal:
        w = w * get_anneal_val(it, **anneal)
    # enable_after gates whatever the anneal says
    enable_after = cfg.get("enable_after", 0)
    if enable_after:
        w = w * float(it >= enable_after)
    return w


def photometric_loss(rendered: Dict, gt: Dict, it, cfg: Dict
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """RGB reconstruction loss, and the detached per-ray error map (which
    feeds importance sampling in the JAX package)."""
    fn = get_recon_fn(cfg.get("fn_type", "mse"), **cfg.get("fn_param", {}))
    pred = rendered["rgb_volume"]
    target = gt["image_rgb"]
    err = fn(pred, target)                                     # [N, 3]
    mask = err_mask = None
    if cfg.get("respect_ignore_mask", False) and "image_ignore_mask" in gt:
        mask = 1.0 - gt["image_ignore_mask"].float()
        err_mask = mask[..., None]
    loss = reduce(err, err_mask, "mean") * _w(cfg, it)
    per_ray_err = torch.mean((pred - target).abs(), dim=-1).detach()
    if mask is not None:
        per_ray_err = per_ray_err * mask
    return loss, {"err_map": per_ray_err}


def mask_occupancy_loss(rendered: Dict, gt: Dict, it, cfg: Dict) -> torch.Tensor:
    """Binary cross entropy of the accumulated opacity against the ground-truth
    occupancy (non-sky) mask."""
    pred = torch.clamp(rendered["mask_volume"], 0.0, 1.0)
    target = gt["image_occupancy_mask"].float()
    mode = cfg.get("mode", "bce")
    bce = safe_binary_cross_entropy(pred, target, eps=cfg.get("pred_clip", 1e-3))
    if mode == "only_cull_non_occupied":
        return torch.sum(bce * (1.0 - target)) / pred.shape[0] * _w(cfg, it)
    if mode == "only_preserve_occupied":
        return torch.sum(bce * target) / pred.shape[0] * _w(cfg, it)
    return bce.mean() * _w(cfg, it)


def mask_entropy_loss(rendered: Dict, it, cfg: Dict) -> torch.Tensor:
    """Entropy regulariser that pushes ``mask_volume`` toward 0 or 1."""
    m = rendered["mask_volume"]
    if cfg.get("mode", "crisp") == "crisp_cr" and "rendered_cr" in rendered:
        m = rendered["rendered_cr"]["mask_volume"]
    m = torch.clamp(m, 1e-6, 1.0 - 1e-6)
    ent = -(m * torch.log(m) + (1.0 - m) * torch.log(1.0 - m))
    return ent.mean() * _w(cfg, it)


def eikonal_loss(nablas: torch.Tensor, it, cfg: Dict, mask: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``|grad sdf| = 1`` penalty, clipped (safe MSE). ``noise``: standard
    normal draws of the norms' shape, scaled by ``cfg["noise_std"]`` when that
    is positive (the caller draws them)."""
    norms = safe_norm(nablas, dim=-1)
    if noise is not None and cfg.get("noise_std", 0.0) > 0:
        norms = norms + noise * cfg["noise_std"]
    err = safe_mse_loss(norms, torch.ones_like(norms), limit=cfg.get("safe_mse_limit", 5.0))
    loss = reduce(err, mask, "mean")
    if cfg.get("alpha_reg_zero", 0.0) > 0:
        loss = loss + cfg["alpha_reg_zero"] * reduce(1.0 / (0.01 + norms), mask, "mean")
    return loss * _w(cfg, it)


def sparsity_loss(sdf: torch.Tensor, it, cfg: Dict) -> torch.Tensor:
    """Pushes SDF samples spread over the space away from the zero level set."""
    typ = cfg.get("type", "normalized_logistic_density")
    if typ == "normalized_logistic_density":
        val = normalized_logistic_density(sdf, cfg.get("inv_scale", 16.0)).mean()
    elif typ == "exp_normal":
        val = torch.exp(-(sdf ** 2) / (2 * cfg.get("sigma", 0.1) ** 2)).mean()
    else:
        raise ValueError(typ)
    return val * _w(cfg, it)


def clearance_loss(near_sdf: torch.Tensor, it, cfg: Dict) -> torch.Tensor:
    """Penalises an SDF below ``thresh`` at each ray's first sample, keeping
    the space in front of the sensor free: the mean of
    ``exp(min(-beta (sdf - thresh), 30)) - 1`` over those rays (the exponent
    is capped so that an untrained, deeply negative SDF gives a large but
    finite penalty)."""
    thresh = cfg.get("thresh", 0.001)
    beta = cfg.get("beta", 10.0)
    viol = near_sdf < thresh
    pen = torch.exp(torch.minimum(-beta * (near_sdf - thresh), near_sdf.new_tensor(30.0))) - 1.0
    return reduce(pen, viol.float(), "mean") * _w(cfg, it)


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of all entries, as ``jnp.median``: the mean of the two
    middle values of an even count (``torch.median`` returns the lower)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def lidar_loss(rendered: Dict, gt_ranges: torch.Tensor, it, cfg: Dict,
               buf: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Depth and line-of-sight supervision along LiDAR beams. A beam counts
    where the rendered mask exceeds 1e-7 and 0 < range <= ``discard_toofar``
    (80), and, with ``discard_outliers_median`` m, where its depth error is at
    most max(m x the median error, 1e-3) (the median over all beams, the
    others' errors taken as 0). ``buf``: the merged buffer, for the line of
    sight (its ``vw`` where the composite gave it)."""
    depth_pred = rendered["depth_volume"]
    valid = (rendered["mask_volume"] > 1e-7) & (gt_ranges > 0.0) \
        & (gt_ranges <= cfg.get("discard_toofar", 80.0))
    dom = cfg.get("discard_outliers_median", 0.0)
    if dom:
        err = (depth_pred - gt_ranges).abs().detach()
        med = median(torch.where(valid, err, torch.zeros_like(err)))
        valid = valid & (err <= torch.clamp(med * dom, min=1e-3))
    validf = valid.float()
    dcfg = cfg.get("depth", {})
    fn = get_recon_fn(dcfg.get("fn_type", "l1"), **dcfg.get("fn_param", {}))
    loss_depth = reduce(fn(depth_pred, gt_ranges), validf, "mean") * _w(dcfg, it)
    loss_los = torch.zeros((), device=depth_pred.device)
    lcfg = cfg.get("line_of_sight", {})
    if lcfg and buf is not None:
        loss_los = line_of_sight_loss(buf, gt_ranges, validf, it, lcfg)
    total = (loss_depth + loss_los) * _w(cfg, it)
    return total, {"loss_depth": loss_depth.detach(), "loss_los": loss_los.detach(),
                   "valid_frac": validf.mean()}


def line_of_sight_loss(buf: Dict, gt_ranges: torch.Tensor, valid: torch.Tensor, it,
                       cfg: Dict) -> torch.Tensor:
    """Shapes the visibility weights along each beam. ``neus_unisim``: the
    squared weights outside the band ``|t - range| <= eps``; ``neus_urban``
    (and ``nerf``): a gaussian of sigma eps / 3 inside the band, scaled to the
    band's largest weight, plus the squared weights before ``range - eps``.
    ``eps`` may follow an annealer. The weights are the buffer's ``vw`` where
    it carries them (the K6 composite's, the same as ``alpha_to_vw``)."""
    vw = buf["vw"] if "vw" in buf else alpha_to_vw(buf["alpha"], buf["mask"])
    t, mask = buf["t"], buf["mask"]
    fn_type = cfg.get("fn_type", "neus_unisim")
    eps_cfg = cfg.get("epsilon", 0.5)
    eps = get_anneal_val(it, **eps_cfg) if isinstance(eps_cfg, dict) else float(eps_cfg)
    g = gt_ranges[:, None]
    if fn_type == "neus_unisim":
        outside = ((t - g).abs() > eps) & mask
        pen = torch.sum(torch.where(outside, vw ** 2, 0.0), dim=-1)
        return reduce(pen, valid, "mean") * _w(cfg, it)
    if fn_type in ("nerf", "neus_urban"):
        target = torch.exp(-0.5 * ((t - g) / (eps / 3.0)) ** 2)
        near_band = ((t - g).abs() <= eps) & mask
        peak = torch.amax(torch.where(near_band, vw, 0.0), dim=-1, keepdim=True)
        band = torch.sum(torch.where(near_band, (vw - target * peak) ** 2, 0.0), dim=-1)
        before = (t < g - eps) & mask
        empty = torch.sum(torch.where(before, vw ** 2, 0.0), dim=-1)
        return reduce(band + empty, valid, "mean") * _w(cfg, it)
    raise ValueError(fn_type)
