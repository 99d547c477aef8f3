"""The training losses of the single-scene NeuS step, on the ``rendered`` dict
(port of neuralsim_tpu/losses/core.py:23-131).

Every loss is a function ``(rendered / ground truth / samples, it, cfg) ->
scalar``; per-loss weights, with their anneal and ``enable_after`` gate, come
from :func:`_w`. The lidar, mono-cue, curvature and clearance losses are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..maths.common import normalized_logistic_density, safe_norm
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
