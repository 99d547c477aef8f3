"""Single-volume renderer: close-range field, optional distant field and sky
(port of neuralsim_tpu/renderers/single_volume.py:24-200). The
close-range field is queried first (its coarse samples from the occupancy
grid where the caller hands in the grid's state), the distant field from the
close range's far plane outwards, the two buffers are composited together and
the sky fills what is left. A NeuS close range without a distant field is
composited alone, its NeuS alpha inside the composite (kernel K12); a buffer
that carries its alpha (EmerNeRF's, the distant field's) takes K6. A
per-ray appearance code ``h_appear`` goes to all three fields' radiance, a
per-ray time ``cond`` to a time-conditioned close range. Where the close
range is EmerNeRF's, the rendered dict carries its decomposition: the
dynamic density of its lanes (``sigma_dynamic_cr``), the static and dynamic
shares of the mask and the rgb, and the flows, each weighted by the
composite's weights ``vw`` of the close range's lanes.
``ray_query`` runs under autograd (the training step differentiates it);
``render_chunked`` switches autograd off.

Parameters live in the field modules, held by one ``nn.ModuleDict`` keyed by
model id (the port's analog of the JAX ``{model_id: params}`` tree); the
renderer maps roles ('cr', 'distant', 'sky') to those keys.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.segment import masked_sum
from .buffers import merge_and_integrate, volume_integrate
from .neus_composite import neus_integrate

# per-ray extras that render_chunked drops, as the JAX version does
_DROPPED = ("vw", "sigma_dynamic_cr", "details_cr", "per_src", "rendered_cr", "rendered_dv")


def decomposition(rendered: Dict[str, Any], buf_cr: Dict[str, Any], with_rgb: bool) -> None:
    """Add EmerNeRF's decomposition to ``rendered`` from the close range's
    buffer (JAX single_volume.py:134-163): its lanes come first in the merged
    buffer and transmittance runs forward, so the composite's weights of the
    first S_cr lanes are the close range's own."""
    m_cr = buf_cr["mask"]
    rendered["sigma_dynamic_cr"] = torch.where(m_cr, buf_cr["sigma_dynamic"],
                                               torch.zeros_like(buf_cr["sigma_dynamic"]))
    vw_cr = rendered["vw"][..., :buf_cr["t"].shape[-1]]
    r_dyn = buf_cr.get("dynamic_ratio")
    if r_dyn is not None:
        w_dyn, w_sta = vw_cr * r_dyn, vw_cr * (1.0 - r_dyn)
        rendered["mask_dynamic"] = masked_sum(w_dyn, m_cr)
        rendered["mask_static"] = masked_sum(w_sta, m_cr)
        if with_rgb and "rgb" in buf_cr:
            rendered["rgb_dynamic"] = masked_sum(w_dyn[..., None] * buf_cr["rgb"],
                                                 m_cr[..., None], dim=-2)
            rendered["rgb_static"] = masked_sum(w_sta[..., None] * buf_cr["rgb"],
                                                m_cr[..., None], dim=-2)
    # the flow belongs to the dynamic branch: weighted by vw times its share
    w = vw_cr * r_dyn if r_dyn is not None else vw_cr
    for fk in ("flow_fwd", "flow_bwd"):
        if fk in buf_cr:
            rendered[fk] = masked_sum(w[..., None] * buf_cr[fk], m_cr[..., None], dim=-2)


class SingleVolumeRenderer:
    def __init__(self, *, query_cfg: Optional[Dict[str, Any]] = None,
                 distant_query_cfg: Optional[Dict[str, Any]] = None,
                 param_keys: Optional[Dict[str, str]] = None,
                 accels: Optional[Dict[str, Any]] = None):
        self.query_cfg = dict(query_cfg or {})
        self.distant_query_cfg = dict(distant_query_cfg or {})
        self.param_keys = dict(param_keys or {})
        # role -> OccGridEma; the grid's state comes in with each call
        self.accels = dict(accels or {})

    def pkey(self, role: str) -> str:
        return self.param_keys.get(role, role)

    def ray_query(self, params: nn.ModuleDict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                  *, it=None, near: Optional[torch.Tensor] = None,
                  far: Optional[torch.Tensor] = None, with_rgb: bool = True,
                  only_cr: bool = False,
                  query_overrides: Optional[Dict[str, Any]] = None,
                  occ_states: Optional[Dict[str, Any]] = None,
                  noise: Optional[Dict[str, Any]] = None,
                  h_appear: Optional[torch.Tensor] = None,
                  cond: Optional[torch.Tensor] = None,
                  return_buffer: bool = False) -> Dict[str, Any]:
        """Render a flat batch of rays [N, 3] -> the ``rendered`` dict, under
        autograd. ``occ_states``: {role: OccGridState}; with a state and an
        accel for 'cr' the coarse samples come from the grid's march.
        ``noise``: the fields' draws (``NeuSField.ray_query``'s keys, plus
        ``"distant"`` [N, num_samples] for the distant ladder), None for the
        deterministic query. ``only_cr`` leaves the distant field out.
        ``h_appear`` [N, dim]: each ray's appearance code (the fields that take
        one read zeros without it). ``cond`` [N, 1] or [1, 1]: each ray's
        normalised time, for a time-conditioned close range.
        ``return_buffer`` keeps the per-sample buffer as ``merged_buffer``."""
        cfg = dict(self.query_cfg)
        cfg.update(query_overrides or {})
        cr = params[self.pkey("cr")]
        if occ_states and "cr" in occ_states and "cr" in self.accels:
            accel, st = self.accels["cr"], occ_states["cr"]
            cfg.setdefault("occ_t_fn", lambda ro, rd, n_, f_, nc, u:
                           accel.ray_proposal(st, ro, rd, n_, f_, nc, noise=u))
        dv_key = self.pkey("distant")
        use_distant = dv_key in params and not only_cr
        # a close range composited alone takes its alpha inside the composite (K12)
        fused = not use_distant
        if h_appear is not None:
            cfg["h_appear"] = h_appear
        if cond is not None:
            cfg["cond"] = cond
        buf_cr = cr.ray_query(rays_o, rays_d, it=it, near=near, far=far,
                              with_rgb=with_rgb, noise=noise, fuse_alpha=fused, **cfg)
        buffers = [buf_cr]

        if use_distant:
            # the distant ladder starts at the close range's far plane; rays
            # that miss the close-range box start at a tenth of its radius
            det = buf_cr["details"]
            dv_near = torch.where(det["hit"], torch.clamp(det["far"], min=1e-3),
                                  torch.clamp(cr.space.radius3d * 0.1, min=1e-3))
            buffers.append(params[dv_key].ray_query(
                rays_o, rays_d, it=it, near=dv_near, with_rgb=with_rgb,
                noise=None if noise is None else noise.get("distant"), h_appear=h_appear,
                **self.distant_query_cfg))

        # close-range samples end where the distant ones begin, so the
        # concatenation is already in depth order; a NeuS close range composited
        # alone comes without its alpha
        rendered = merge_and_integrate(
            buffers, with_per_src=use_distant, assume_sorted=True,
            integrate=volume_integrate if "alpha" in buf_cr else neus_integrate)
        if use_distant:
            rendered["rendered_cr"], rendered["rendered_dv"] = rendered["per_src"]
        sky_key = self.pkey("sky")
        if with_rgb and sky_key in params:
            sky_rgb = params[sky_key](rays_d, h_appear)
            mask = rendered["mask_volume"][..., None]
            rendered["rgb_sky"] = sky_rgb
            rendered["rgb_volume_occupied"] = rendered["rgb_volume"]
            rendered["rgb_volume_non_occupied"] = (1.0 - mask) * sky_rgb
            rendered["rgb_volume"] = rendered["rgb_volume"] + (1.0 - mask) * sky_rgb
        rendered["details_cr"] = buf_cr["details"]
        if "sigma_dynamic" in buf_cr:
            decomposition(rendered, buf_cr, with_rgb)
        if not return_buffer:
            rendered.pop("merged_buffer")
        return rendered

    @torch.no_grad()
    def render_chunked(self, params: nn.ModuleDict, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, *, rayschunk: int = 4096, it=None,
                       **kw) -> Dict[str, torch.Tensor]:
        """Full-frame rendering in fixed-size ray chunks (the eval path). A
        ``cond`` of one row a ray is cut with the rays; [1, 1] goes to every
        chunk."""
        parts = []
        n = rays_o.shape[0]
        cond = kw.pop("cond", None)
        for s in range(0, n, rayschunk):
            if cond is not None:
                kw["cond"] = cond[s:s + rayschunk] if cond.shape[0] == n > 1 else cond
            r = self.ray_query(params, rays_o[s:s + rayschunk], rays_d[s:s + rayschunk],
                               it=it, with_rgb=True, **kw)
            parts.append({k: v for k, v in r.items() if k not in _DROPPED})
        return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
