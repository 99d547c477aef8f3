"""EmerNeRF: a static density field and a time-conditioned dynamic one whose
densities add, with an optional scene-flow head (port of
neuralsim_tpu/fields/emernerf.py:28-154).

The static branch is a 3-D LoTD (the NGP ladder of dense and hash levels:
kernel K3) on the point moved into the box's [0, 1]^3; the dynamic branch a
permutohedral lattice over (xyz01, t01) (d 4: kernel K9). Each branch's MLP
gives a density (``exp`` of its first output, clipped to [-15, 15]) and a
feature; one radiance net reads the features mixed by the dynamic share of
the density, beside the SH of the direction. The flow head reads the dynamic
branch's encoding and gives forward and backward offsets, which the flow
loss holds to a cycle (:meth:`EmerNeRFField.flow_cycle_residual`).

Parameters (JAX names, so the bridge copies a JAX tree over as is):
``static_enc.table``, ``static_dec``, ``dyn_enc.table``, ``dyn_dec``,
``flow_dec``, ``radiance`` (``static_*`` absent with ``only_dynamic``,
``flow_dec`` without ``with_flow``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..maths.transforms import clip
from ..ops.segment import tau_to_alpha
from .blocks import MLP
from .embedders import sh_embedder
from .encodings.lotd import make_lotd
from .encodings.permuto import PermutoEncoding
from .neus import clip01
from .spatial import AABBSpace

_STATIC_CFG = {"n_levels": 12, "base_res": 16, "max_res": 2048, "log2_hashmap_size": 18}
_DYNAMIC_CFG = {"n_levels": 12, "base_res": 4.0, "max_res": 512.0, "log2_hashmap_size": 17}


def _act(raw: torch.Tensor) -> torch.Tensor:
    """exp(clip(raw, -15, 15)), the clip with ``jnp.clip``'s half gradient at a tie."""
    return torch.exp(clip(raw, -15.0, 15.0))


class EmerNeRFField(nn.Module):
    use_time = True     # the trainer conditions it on each ray's frame time

    def __init__(self, space: Optional[AABBSpace] = None, *,
                 static_encoding_cfg: Optional[Dict] = None,
                 dynamic_permuto_cfg: Optional[Dict] = None,
                 geo_feat_dim: int = 15, decoder_hidden: int = 64,
                 radiance_hidden: int = 64, sh_degree: int = 4,
                 with_flow: bool = True, only_dynamic: bool = False):
        super().__init__()
        self.space = space or AABBSpace()
        self.only_dynamic = only_dynamic
        self.with_flow = with_flow
        if not only_dynamic:
            self.static_enc = make_lotd(static_encoding_cfg or _STATIC_CFG, 3)
            self.static_dec = MLP(self.static_enc.out_dim, 1 + geo_feat_dim,
                                  hidden=decoder_hidden, depth=1)
        self.dyn_enc = PermutoEncoding(4, **{**_DYNAMIC_CFG, **(dynamic_permuto_cfg or {})})
        self.dyn_dec = MLP(self.dyn_enc.out_dim, 1 + geo_feat_dim, hidden=decoder_hidden,
                           depth=1)
        if with_flow:
            self.flow_dec = MLP(self.dyn_enc.out_dim, 6, hidden=decoder_hidden, depth=1)
        self.dir_embed, dir_dim = sh_embedder(sh_degree)
        self.radiance = MLP(geo_feat_dim + dir_dim, 3, hidden=radiance_hidden, depth=2,
                            output_activation="sigmoid")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init in distribution (the flow head's last bias 0)."""
        for name in ("dyn_enc", "dyn_dec", "radiance", "static_enc", "static_dec", "flow_dec"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)

    def _dynamic(self, u: torch.Tensor, t01: torch.Tensor) -> torch.Tensor:
        """The dynamic branch's encoding of normalised points u [..., 3] at
        times t01 [...]."""
        return self.dyn_enc(torch.cat([u, t01[..., None]], dim=-1))

    def query(self, x: torch.Tensor, t01: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [..., 3], t01 [...] -> both branches' densities and features and
        the flow: {sigma_dynamic, feat_dynamic, sigma_static?, feat_static?,
        flow_fwd?, flow_bwd?}."""
        u = self.space.normalize_coords(x)
        hd = self._dynamic(u, t01)
        dd = self.dyn_dec(hd)
        out = {"sigma_dynamic": _act(dd[..., 0]), "feat_dynamic": dd[..., 1:]}
        if not self.only_dynamic:
            ds = self.static_dec(self.static_enc(u))
            out["sigma_static"] = _act(ds[..., 0])
            out["feat_static"] = ds[..., 1:]
        if self.with_flow:
            fl = self.flow_dec(hd)
            out["flow_fwd"], out["flow_bwd"] = fl[..., :3], fl[..., 3:]
        return out

    def ray_query(self, rays_o: torch.Tensor, rays_d: torch.Tensor, *, it=None,
                  cond: Optional[torch.Tensor] = None, near: Optional[torch.Tensor] = None,
                  far: Optional[torch.Tensor] = None, num_coarse: int = 96,
                  perturb: bool = True, with_rgb: bool = True,
                  noise: Optional[Dict[str, Any]] = None, fuse_alpha: bool = False,
                  h_appear: Optional[torch.Tensor] = None,
                  forward_inv_s: Optional[float] = None) -> Dict[str, Any]:
        """The dense buffer of ``num_coarse`` samples a ray over the box's
        chord, with the summed density's alpha and each branch's share.
        ``cond`` [N, 1] (or [1, 1]): each ray's time in [0, 1], t = 0 without
        it. ``noise``: ``{"coarse": [N, num_coarse]}`` uniform draws that
        jitter the ladder (with ``perturb``), None for the deterministic one.
        The alpha is always in the buffer (``fuse_alpha`` and the LiDAR
        simulation's ``forward_inv_s`` are the NeuS fields', not read here, as
        the JAX field ignores them; no appearance code is read). Returns {t, mask, alpha,
        nablas (zeros), sigma_dynamic, sigma_static?, dynamic_ratio?,
        flow_fwd?, flow_bwd?, rgb?, details}."""
        N = rays_o.shape[0]
        n_, f_, hit = self.space.ray_test(rays_o, rays_d, near=near, far=far)
        u = torch.linspace(0.0, 1.0, num_coarse, dtype=rays_o.dtype,
                           device=rays_o.device).expand(N, num_coarse)
        if perturb and noise is not None:
            u = u + (noise["coarse"] - 0.5) / num_coarse
        t = n_[:, None] + (f_ - n_)[:, None] * clip01(u)
        mask = hit[:, None].expand(t.shape).contiguous()
        x = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
        t01 = rays_o.new_zeros((N,)) if cond is None else cond[..., 0]
        q = self.query(x, t01[:, None].expand(t.shape))

        sigma_d = q["sigma_dynamic"]
        sigma = sigma_d if self.only_dynamic else sigma_d + q["sigma_static"]
        dt = torch.cat([t[..., 1:] - t[..., :-1], torch.full_like(t[..., :1], 1e-3)], dim=-1)
        alpha = torch.where(mask, tau_to_alpha(sigma * dt), torch.zeros_like(sigma))
        buf: Dict[str, Any] = {"t": t, "mask": mask, "alpha": alpha,
                               "nablas": torch.zeros_like(x), "sigma_dynamic": sigma_d}
        ratio = sigma_d / torch.maximum(sigma, sigma.new_full((), 1e-8))
        if not self.only_dynamic:
            buf["sigma_static"] = q["sigma_static"]
            buf["dynamic_ratio"] = ratio
        if self.with_flow:
            buf["flow_fwd"], buf["flow_bwd"] = q["flow_fwd"], q["flow_bwd"]
        if with_rgb:
            # the shared colour head reads the features mixed by the dynamic share
            if self.only_dynamic:
                feat = q["feat_dynamic"]
            else:
                wd = ratio[..., None]
                feat = wd * q["feat_dynamic"] + (1 - wd) * q["feat_static"]
            dirs = rays_d[:, None, :].expand(x.shape)
            buf["rgb"] = self.radiance(torch.cat([feat, self.dir_embed(dirs)], dim=-1))
        buf["details"] = {"hit": hit, "near": n_, "far": f_}
        return buf

    def flow_cycle_residual(self, x: torch.Tensor, t01: torch.Tensor,
                            dt: float = 0.02) -> torch.Tensor:
        """The forward-then-backward flow's distance back to the start, squared:
        x [n, 3], t01 [n] -> [n]. Only the dynamic branch's flow reaches it,
        so neither branch's density is computed (the JAX function's value and
        gradients do not depend on them)."""
        if not self.with_flow:
            raise ValueError("flow_cycle_residual needs the flow head (with_flow)")
        space = self.space
        fwd = self.flow_dec(self._dynamic(space.normalize_coords(x), t01))[..., :3]
        x_fwd = x + fwd * dt
        bwd = self.flow_dec(self._dynamic(space.normalize_coords(x_fwd), t01 + dt))[..., 3:]
        x_back = x_fwd + bwd * dt
        return torch.sum((x_back - x) ** 2, dim=-1)
