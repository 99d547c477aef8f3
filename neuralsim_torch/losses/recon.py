"""Reconstruction error primitives and their clipped "safe" variants (port of
neuralsim_tpu/losses/recon.py): the error functions that the photometric loss
selects from by config, elementwise over ``pred`` and ``gt``."""
from __future__ import annotations

from typing import Optional

import torch


def mse(pred, gt):
    return (pred - gt) ** 2


def l1(pred, gt):
    return (pred - gt).abs()


def smooth_l1(pred, gt, beta: float = 1.0):
    d = (pred - gt).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def huber(pred, gt, delta: float = 0.1):
    d = (pred - gt).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def relative_l1(pred, gt, eps: float = 1e-2):
    return (pred - gt).abs() / (pred.detach().abs() + eps)


def relative_l2(pred, gt, eps: float = 1e-2):
    return (pred - gt) ** 2 / (pred.detach() ** 2 + eps)


def relative_l2_luminance(pred, gt, eps: float = 1e-2):
    """Relative L2 normalised by the prediction's per-pixel luminance."""
    coef = torch.tensor([0.299, 0.587, 0.114], dtype=pred.dtype, device=pred.device)
    lum = torch.sum(pred.detach() * coef, dim=-1, keepdim=True)
    return (pred - gt) ** 2 / (lum ** 2 + eps)


def mape(pred, gt, eps: float = 1e-2):
    return (pred - gt).abs() / (gt.abs() + eps)


def smape(pred, gt, eps: float = 1e-2):
    return (pred - gt).abs() / (0.5 * (pred.abs() + gt.abs()) + eps)


def l1_log(pred, gt, eps: float = 1e-8):
    return (torch.log(pred.clamp(min=eps)) - torch.log(gt.clamp(min=eps))).abs()


_FNS = {"mse": mse, "l2": mse, "l1": l1, "smooth_l1": smooth_l1, "huber": huber,
        "relative_l1": relative_l1, "relative_l2": relative_l2,
        "relative_l2_luminance": relative_l2_luminance, "mape": mape,
        "smape": smape, "l1_log": l1_log}


def get_recon_fn(name: str, **kw):
    fn = _FNS[name]
    if kw:
        return lambda p, g: fn(p, g, **kw)
    return fn


def safe_mse_loss(pred, gt, limit: float = 1.0):
    """Squared error of the error clamped to [-limit, limit]: outliers give a
    bounded value and no gradient beyond the clip."""
    return torch.clamp(pred - gt, -limit, limit) ** 2


def safe_binary_cross_entropy(pred, gt, eps: float = 1e-3, reduction: Optional[str] = None):
    """Binary cross entropy with the prediction clipped to [eps, 1 - eps]."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    out = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    return out.mean() if reduction == "mean" else out


def reduce(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
           reduction: str = "mean") -> torch.Tensor:
    """Masked reduction: the mean divides by the mask's sum."""
    if mask is not None:
        if reduction == "mean":
            return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1e-8)
        x = x * mask
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x
