"""Image metrics of the evaluation tools: PSNR and SSIM (port of
neuralsim_tpu/maths/metrics.py; numpy and scipy, on the host).

SSIM follows Wang et al. 2004 with the 11x11 gaussian window (sigma 1.5),
separable and reflected at the borders, averaged over the channels. LPIPS
needs pretrained VGG weights, which are not in the repository.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def psnr_np(pred: np.ndarray, gt: np.ndarray, max_val: float = 1.0) -> float:
    """10 log10(max_val^2 / MSE) in float64; 99 where the MSE is at most 1e-12."""
    mse = float(np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return 10.0 * np.log10(max_val ** 2 / mse)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The window ``k`` along the first two axes, reflected at the borders."""
    from scipy.ndimage import convolve1d
    return convolve1d(convolve1d(img, k, axis=0, mode="reflect"), k, axis=1, mode="reflect")


def ssim_np(pred: np.ndarray, gt: np.ndarray, max_val: float = 1.0,
            window_size: int = 11, sigma: float = 1.5) -> float:
    """Mean SSIM over the pixels and channels of [H, W, C] (or [H, W])
    images in [0, max_val]."""
    p = np.asarray(pred, np.float64)
    g = np.asarray(gt, np.float64)
    if p.ndim == 2:
        p, g = p[..., None], g[..., None]
    k = _gaussian_window(window_size, sigma)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    mu_p = _filter2d_sep(p, k)
    mu_g = _filter2d_sep(g, k)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    sig_p = _filter2d_sep(p * p, k) - mu_pp
    sig_g = _filter2d_sep(g * g, k) - mu_gg
    sig_pg = _filter2d_sep(p * g, k) - mu_pg
    ssim_map = ((2 * mu_pg + C1) * (2 * sig_pg + C2)) / \
        ((mu_pp + mu_gg + C1) * (sig_p + sig_g + C2))
    return float(ssim_map.mean())


def lpips_np(pred: np.ndarray, gt: np.ndarray,
             weights_path: Optional[str] = None) -> Optional[float]:
    """LPIPS: None without pretrained VGG16 weights (``weights_path``, the
    reported value then); the perceptual network is not ported, so a path
    raises."""
    if weights_path is None:
        return None
    raise NotImplementedError("lpips_np with VGG16 weights is not ported (the perceptual "
                              "network, losses/vgg.py: ROADMAP.md, queue 1 item 10)")
