"""The NeRF++ inverted-sphere background field (port of
neuralsim_tpu/fields/nerf.py:131-267).

The field takes the 4-D contraction of a point and samples a ladder that is
linear in inverse depth from the close-range model's far plane outwards. The
contraction is the inverted sphere (unit direction, inner_radius / r) or,
once :meth:`NeRFDistantField.set_cr_aabb` has named the close-range box, the
``fixed_cuboid_shells`` one around that box. ``geometry="mlp"`` encodes the
contracted point with a sinusoidal embedding; ``geometry="lotd"`` (the
StreetSurf distant model) with a 4-D LoTD encoding of the point moved into
[0, 1]^4, dense and hash levels whose lookup is kernel K3 in four dimensions
(``lotd_grid4``). The radiance net takes an appearance code ``h_appear`` of
``appear_embed_dim`` (zeros where none is given). The field's samples join
the other models' buffers and are composited with them.

Not ported yet: ``NeRFField`` (the close-range NeRF).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.segment import tau_to_alpha
from .blocks import MLP
from .embedders import sh_embedder, sinusoidal_embedder
from .encodings.lotd import make_lotd
from .spatial import contract_inverted_cuboid, contract_inverted_sphere


class NeRFDistantField(nn.Module):
    """Parameters (JAX names): the ``decoder`` and ``radiance`` MLP layers,
    and with ``geometry="lotd"`` the encoding's ``encoding.table``."""

    def __init__(self, *, inner_radius: float = 1.0, geometry: str = "mlp",
                 encoding_cfg: Optional[Dict] = None,
                 geo_feat_dim: int = 15, decoder_hidden: int = 64, decoder_depth: int = 1,
                 radiance_hidden: int = 64, radiance_depth: int = 2,
                 use_view_dirs: bool = True, sh_degree: int = 4,
                 appear_embed_dim: int = 0, cr_aabb: Optional[Any] = None):
        super().__init__()
        if geometry not in ("mlp", "lotd"):
            raise ValueError(geometry)
        self.inner_radius = inner_radius
        self.use_view_dirs = use_view_dirs
        self.appear_embed_dim = appear_embed_dim
        # the fixed_cuboid_shells box: buffers, so they move with the field
        self.register_buffer("cub_center", None, persistent=False)
        self.register_buffer("cub_half", None, persistent=False)
        if geometry == "lotd":       # the encoding is a module only where there is one
            self.pe = None
            self.encoding = make_lotd({"n_levels": 12, "max_res": 1024, **(encoding_cfg or {})},
                                      input_dim=4)
            dec_in = self.encoding.out_dim
        else:
            self.pe, dec_in = sinusoidal_embedder(8, 4)
        self.decoder = MLP(dec_in, 1 + geo_feat_dim, hidden=decoder_hidden,
                           depth=decoder_depth)
        rad_in = geo_feat_dim + appear_embed_dim
        if use_view_dirs:
            self.dir_embed, dir_dim = sh_embedder(sh_degree)
            rad_in += dir_dim
        self.radiance = MLP(rad_in, 3, hidden=radiance_hidden, depth=radiance_depth,
                            output_activation="sigmoid")
        if cr_aabb is not None:
            self.set_cr_aabb(cr_aabb)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.decoder.reset_parameters(generator)
        self.radiance.reset_parameters(generator)
        if self.pe is None:
            self.encoding.reset_parameters(generator)

    def set_cr_aabb(self, aabb) -> None:
        """Switch to the ``fixed_cuboid_shells`` contraction around the
        close-range box: an ``AABBSpace`` or an (aabb_min, aabb_max) pair."""
        if hasattr(aabb, "aabb_min"):
            mn, mx = aabb.aabb_min, aabb.aabb_max
        else:
            mn, mx = torch.as_tensor(aabb, dtype=torch.float32).reshape(2, 3)
        dev = next(self.parameters()).device
        mn, mx = (torch.as_tensor(v, dtype=torch.float32).to(dev) for v in (mn, mx))
        self.cub_center = 0.5 * (mn + mx)
        self.cub_half = torch.clamp(0.5 * (mx - mn), min=1e-6)

    def query_density_feat(self, x: torch.Tensor):
        """x: [..., 3] -> (density [...], feature [..., geo_feat_dim]). The
        LoTD takes the contracted point with its unit-shell part moved into
        [0, 1] (c * 0.5 + 0.5) beside its inverse radius."""
        c = contract_inverted_sphere(x, self.inner_radius) if self.cub_center is None \
            else contract_inverted_cuboid(x, self.cub_center, self.cub_half)
        if self.pe is None:
            h = self.encoding(torch.cat([c[..., :3] * 0.5 + 0.5, c[..., 3:]], dim=-1))
        else:
            h = self.pe(c)
        out = self.decoder(h)
        # -1 bias: at init (raw ~ 0) the optical depth over the whole ladder is
        # ~0.4, so the background does not start opaque
        return torch.exp(torch.clamp(out[..., 0] - 1.0, -15.0, 15.0)), out[..., 1:]

    def ray_query(self, rays_o: torch.Tensor, rays_d: torch.Tensor, *, it=None,
                  near: Optional[torch.Tensor] = None, num_samples: int = 64,
                  with_rgb: bool = True, far_factor: float = 1e4,
                  noise: Optional[torch.Tensor] = None,
                  h_appear: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Samples linear in inverse depth on [near, near * far_factor]; ``near``
        per ray is the close-range model's far. ``noise``: [N, num_samples]
        uniform draws that jitter the ladder, None for the deterministic one.
        ``h_appear`` [N, appear_embed_dim]: a per-ray appearance code.
        Returns the dense buffer {t, mask, alpha, nablas (zeros), rgb, details}.
        """
        N = rays_o.shape[0]
        if near is None:
            near = torch.full((N,), self.inner_radius, dtype=torch.float32,
                              device=rays_o.device)
        near = torch.clamp(near, min=1e-3)
        u = torch.linspace(0.0, 1.0, num_samples, dtype=torch.float32,
                           device=rays_o.device).expand(N, num_samples)
        if noise is not None:
            u = torch.clamp(u + (noise - 0.5) / num_samples, 0.0, 1.0)
        inv_t = (1.0 / near)[:, None] * (1.0 - u) + (1.0 / (near * far_factor))[:, None] * u
        t = 1.0 / inv_t
        mask = torch.ones_like(t, dtype=torch.bool)

        x = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
        sigma, feat = self.query_density_feat(x)
        # integrate in the contracted coordinate s = near / t, uniform in
        # [1 / far_factor, 1]: the metric dt explodes toward the far shells.
        # The ladder does not close the integral at infinity; the sky owns the
        # residual transmittance.
        s = near[:, None] * inv_t
        ds = s[..., :-1] - s[..., 1:]
        ds = torch.cat([ds, ds[..., -1:]], dim=-1)
        alpha = tau_to_alpha(sigma * ds)
        buf: Dict[str, Any] = {"t": t, "mask": mask, "alpha": alpha,
                               "nablas": torch.zeros_like(x)}
        if with_rgb:
            inputs = [feat]
            if self.use_view_dirs:
                inputs.append(self.dir_embed(rays_d[:, None, :].expand(x.shape)))
            if self.appear_embed_dim:
                shape = feat.shape[:-1] + (self.appear_embed_dim,)
                inputs.append(feat.new_zeros(shape) if h_appear is None
                              else h_appear[:, None, :].expand(shape))
            buf["rgb"] = self.radiance(torch.cat(inputs, dim=-1))
        buf["details"] = {"hit": torch.ones((N,), dtype=torch.bool, device=rays_o.device),
                          "near": near, "far": t[..., -1]}
        return buf
