"""The conditional LoTD NeuS field of shared categorical models (port of
neuralsim_tpu/fields/conditional.py:213-365).

One field serves every instance of a class (the vehicles of a scene): the
LoTD encoding stays 3-D and shared, and each instance's auto-decoder latent
(the ``latents`` parameter, [n_instances, z_dim]) is concatenated to the SDF
decoder's input. The instance of each point comes in as ``bidx``, taken from
the latents with clamped indices (JAX's ``mode="clip"``). The latent does not
depend on the position, so the analytic nablas chain the encoding's jacobian
with the decoder's input gradient of the encoding slice only
(:meth:`NeuSField.sdf_nablas_feat`).

Training: gradients reach the latents through the decoder, also through the
analytic nablas (the uniform eikonal queries instance 0), and
:meth:`latent_norm` feeds the latent regulariser. Not ported yet: the time
condition (``use_time``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .blocks import MLP
from .neus import NeuSField
from .spatial import AABBSpace


class ConditionalLoTDNeuSField(NeuSField):
    """NeuS on a shared LoTD with per-instance latents at the decoder input.

    Parameters (JAX names): those of :class:`NeuSField` and ``latents``."""

    def __init__(self, space: Optional[AABBSpace] = None, *, n_instances: int = 0,
                 z_dim: int = 8, use_time: bool = False,
                 encoding_cfg: Optional[Dict] = None, latent_init_scale: float = 1e-2,
                 **neus_kw):
        if use_time:
            raise NotImplementedError("the time-conditioned field is not ported")
        enc = {"type": "tpu_mixed", "n_levels": 10, "base_res": 8, "max_res": 256,
               "n_feats": 4, "n_hash_levels": 0, "cp_max_res": 512, **(encoding_cfg or {})}
        neus_kw.setdefault("radius_init", 0.4)
        super().__init__(space, encoding_cfg=enc, **neus_kw)
        self.n_instances = n_instances
        self.z_dim = z_dim if n_instances > 0 else 0
        self.latent_init_scale = latent_init_scale
        # the decoder again, for the widened input (encoding + latent)
        self.decoder = MLP(self.encoding.out_dim + self.z_dim, 1 + self.geo_feat_dim,
                           hidden=neus_kw.get("decoder_hidden", 64),
                           depth=neus_kw.get("decoder_depth", 1), activation="relu")
        if n_instances > 0:
            self.latents = nn.Parameter(torch.zeros(n_instances, self.z_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The NeuS parameters, and latents ~ N(0, 1) * latent_init_scale."""
        super().reset_parameters(generator)
        if self.n_instances > 0:
            self.latents.copy_(torch.randn(self.latents.shape, generator=generator)
                               * self.latent_init_scale)

    def _decoder_input(self, h: torch.Tensor, bidx: Optional[torch.Tensor]) -> torch.Tensor:
        """[h, the point's instance latent]; ``bidx`` None means instance 0."""
        if self.n_instances == 0:
            return h
        lead = h.shape[:-1]
        idx = torch.zeros(lead, dtype=torch.long, device=h.device) if bidx is None \
            else torch.clamp(bidx.expand(lead).long(), 0, self.n_instances - 1)
        return torch.cat([h, self.latents[idx]], dim=-1)

    def latent_norm(self) -> torch.Tensor:
        """The mean over instances of each latent's squared norm."""
        if self.n_instances == 0:
            return torch.zeros((), device=self.ln_inv_s.device)
        return torch.mean(torch.sum(self.latents ** 2, dim=-1))
