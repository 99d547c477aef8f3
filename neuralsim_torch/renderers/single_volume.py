"""Single-volume renderer: close-range field + sky (port of
neuralsim_tpu/renderers/single_volume.py:24-133, 162-200, without the
distant field and the occupancy grid). ``ray_query`` runs under autograd (the
training step differentiates it); ``render_chunked`` switches autograd off.

Parameters live in the field modules, held by one ``nn.ModuleDict`` keyed by
model id (the port's analog of the JAX ``{model_id: params}`` tree); the
renderer maps roles ('cr', 'sky') to those keys.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .buffers import merge_and_integrate

# per-ray extras that render_chunked drops, as the JAX version does
_DROPPED = ("vw", "details_cr")


class SingleVolumeRenderer:
    def __init__(self, *, query_cfg: Optional[Dict[str, Any]] = None,
                 param_keys: Optional[Dict[str, str]] = None):
        self.query_cfg = dict(query_cfg or {})
        self.param_keys = dict(param_keys or {})

    def pkey(self, role: str) -> str:
        return self.param_keys.get(role, role)

    def ray_query(self, params: nn.ModuleDict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                  *, it=None, near: Optional[torch.Tensor] = None,
                  far: Optional[torch.Tensor] = None, with_rgb: bool = True,
                  query_overrides: Optional[Dict[str, Any]] = None,
                  noise: Optional[Dict[str, Any]] = None,
                  return_buffer: bool = False) -> Dict[str, Any]:
        """Render a flat batch of rays [N, 3] -> the ``rendered`` dict, under
        autograd. ``noise``: the close-range field's draws (see
        ``NeuSField.ray_query``), None for the deterministic query.
        ``return_buffer`` keeps the per-sample buffer as ``merged_buffer``."""
        cfg = dict(self.query_cfg)
        cfg.update(query_overrides or {})
        buf_cr = params[self.pkey("cr")].ray_query(rays_o, rays_d, it=it, near=near, far=far,
                                                   with_rgb=with_rgb, noise=noise, **cfg)
        rendered = merge_and_integrate([buf_cr])
        sky_key = self.pkey("sky")
        if with_rgb and sky_key in params:
            sky_rgb = params[sky_key](rays_d)
            mask = rendered["mask_volume"][..., None]
            rendered["rgb_sky"] = sky_rgb
            rendered["rgb_volume_occupied"] = rendered["rgb_volume"]
            rendered["rgb_volume_non_occupied"] = (1.0 - mask) * sky_rgb
            rendered["rgb_volume"] = rendered["rgb_volume"] + (1.0 - mask) * sky_rgb
        rendered["details_cr"] = buf_cr["details"]
        if not return_buffer:
            rendered.pop("merged_buffer")
        return rendered

    @torch.no_grad()
    def render_chunked(self, params: nn.ModuleDict, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, *, rayschunk: int = 4096, it=None,
                       **kw) -> Dict[str, torch.Tensor]:
        """Full-frame rendering in fixed-size ray chunks (the eval path)."""
        parts = []
        for s in range(0, rays_o.shape[0], rayschunk):
            r = self.ray_query(params, rays_o[s:s + rayschunk], rays_d[s:s + rayschunk],
                               it=it, with_rgb=True, **kw)
            parts.append({k: v for k, v in r.items() if k not in _DROPPED})
        return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
