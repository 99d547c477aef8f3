"""The conditional NeuS fields of shared categorical models (port of
neuralsim_tpu/fields/conditional.py:33-210, 213-365, 367-378).

One field serves every instance of a class (the vehicles of a scene), with
each instance's auto-decoder latent (the ``latents`` parameter,
[n_instances, z_dim]). The instance of each point comes in as ``bidx``,
taken from the latents with clamped indices (JAX's ``mode="clip"``); None
means instance 0. Two ways to condition:

* :class:`ConditionalLoTDNeuSField`: the LoTD encoding stays 3-D and shared,
  and the latent is concatenated to the SDF decoder's input. The latent does
  not depend on the position, so the analytic nablas chain the encoding's
  jacobian with the decoder's input gradient of the encoding slice only.
* :class:`ConditionalPermutoNeuSField`: the latent enters the lattice, a
  permutohedral encoding over concat(xyz01, sigmoid(z)) (d = 3 + z_dim), and
  the decoder reads the encoding alone. Its jacobian covers the first three
  lattice dimensions (xyz); the latents' gradient comes back through the
  encoding's input gradient (kernel K9's backward on the card).

Training: gradients reach the latents through the decoder (LoTD) or the
lattice (permuto), also through the analytic nablas' query (the uniform
eikonal queries instance 0), and :meth:`latent_norm` feeds the latent
regulariser. Not ported yet: the time condition (``use_time``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .blocks import MLP
from .encodings.permuto import PermutoEncoding
from .neus import NeuSField
from .spatial import AABBSpace


def _no_time(use_time: bool) -> None:
    if use_time:
        raise NotImplementedError("the time-conditioned field is not ported")


class _Latents:
    """Per-instance latents: their init and the regulariser's norm. (The
    compose renderer queries a group of instances through ``ray_query`` with
    a per-ray ``bidx``; JAX's ``batched_ray_query`` alias has no caller.)"""

    n_instances: int
    latent_init_scale: float

    def _init_latents(self, n_instances: int, z_dim: int, scale: float) -> None:
        self.n_instances = n_instances
        self.z_dim = z_dim if n_instances > 0 else 0
        self.latent_init_scale = scale
        if n_instances > 0:
            self.latents = nn.Parameter(torch.zeros(n_instances, self.z_dim))

    def _instance_latents(self, lead: torch.Size, bidx: Optional[torch.Tensor],
                          device: torch.device) -> torch.Tensor:
        """The latent of each point [*lead, z_dim]; ``bidx`` None means
        instance 0, indices are clamped into range."""
        idx = torch.zeros(lead, dtype=torch.long, device=device) if bidx is None \
            else torch.clamp(bidx.expand(lead).long(), 0, self.n_instances - 1)
        return self.latents[idx]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The NeuS parameters, and latents ~ N(0, 1) * latent_init_scale."""
        super().reset_parameters(generator)
        if self.n_instances > 0:
            self.latents.copy_(torch.randn(self.latents.shape, generator=generator)
                               * self.latent_init_scale)

    def latent_norm(self) -> torch.Tensor:
        """The mean over instances of each latent's squared norm."""
        if self.n_instances == 0:
            return torch.zeros((), device=self.ln_inv_s.device)
        return torch.mean(torch.sum(self.latents ** 2, dim=-1))


class ConditionalLoTDNeuSField(_Latents, NeuSField):
    """NeuS on a shared LoTD with per-instance latents at the decoder input.

    Parameters (JAX names): those of :class:`NeuSField` and ``latents``."""

    def __init__(self, space: Optional[AABBSpace] = None, *, n_instances: int = 0,
                 z_dim: int = 8, use_time: bool = False,
                 encoding_cfg: Optional[Dict] = None, latent_init_scale: float = 1e-2,
                 **neus_kw):
        _no_time(use_time)
        enc = {"type": "tpu_mixed", "n_levels": 10, "base_res": 8, "max_res": 256,
               "n_feats": 4, "n_hash_levels": 0, "cp_max_res": 512, **(encoding_cfg or {})}
        neus_kw.setdefault("radius_init", 0.4)
        super().__init__(space, encoding_cfg=enc, **neus_kw)
        self._init_latents(n_instances, z_dim, latent_init_scale)
        # the decoder again, for the widened input (encoding + latent)
        self.decoder = MLP(self.encoding.out_dim + self.z_dim, 1 + self.geo_feat_dim,
                           hidden=neus_kw.get("decoder_hidden", 64),
                           depth=neus_kw.get("decoder_depth", 1), activation="relu")

    def _decoder_input(self, h: torch.Tensor, bidx: Optional[torch.Tensor]) -> torch.Tensor:
        """[h, the point's instance latent]."""
        if self.n_instances == 0:
            return h
        return torch.cat([h, self._instance_latents(h.shape[:-1], bidx, h.device)], dim=-1)


class ConditionalPermutoNeuSField(_Latents, NeuSField):
    """NeuS on a permutohedral encoding over concat(xyz01, [sigmoid(z)]).

    n_instances > 0: generative (per-instance latents in the lattice);
    n_instances = 0: the plain permuto NeuS (d = 3). Parameters (JAX names):
    ``encoding.table``, ``decoder``, ``radiance``, ``ln_inv_s`` and
    ``latents``."""

    def __init__(self, space: Optional[AABBSpace] = None, *, n_instances: int = 0,
                 z_dim: int = 4, use_time: bool = False,
                 permuto_cfg: Optional[Dict] = None, latent_init_scale: float = 1e-2,
                 radius_init: float = 0.4, ln_inv_s_init: float = math.log(20.0),
                 eval_chunk: int = 65536, **neus_kw):
        _no_time(use_time)
        pc = {"n_levels": 12, "base_res": 4.0, "max_res": 512.0, "log2_hashmap_size": 17,
              **(permuto_cfg or {})}
        enc = PermutoEncoding(3 + (z_dim if n_instances > 0 else 0), **pc)
        super().__init__(space, encoding=enc, radius_init=radius_init,
                         ln_inv_s_init=ln_inv_s_init, eval_chunk=eval_chunk, **neus_kw)
        self._init_latents(n_instances, z_dim, latent_init_scale)

    def _encoding_input(self, x: torch.Tensor, bidx: Optional[torch.Tensor]) -> torch.Tensor:
        """concat(x01, [sigmoid(z[bidx])]): the latent squashed into the
        lattice's [0, 1] domain."""
        u = self.space.normalize_coords(x)
        if self.n_instances == 0:
            return u
        z = self._instance_latents(x.shape[:-1], bidx, x.device)
        return torch.cat([u, torch.sigmoid(z)], dim=-1)

    def _decoder_input(self, h: torch.Tensor, bidx: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoding alone (the latent entered the lattice)."""
        return h


def PermutoNeuSField(space: Optional[AABBSpace] = None, **kw) -> ConditionalPermutoNeuSField:
    """The plain (unconditioned) permutohedral NeuS."""
    return ConditionalPermutoNeuSField(space, n_instances=0, use_time=False, **kw)


def GenerativePermutoConcatNeuSField(space: Optional[AABBSpace] = None, *, n_instances: int,
                                     z_dim: int = 4, **kw) -> ConditionalPermutoNeuSField:
    """The categorical shared permuto NeuS with per-instance latents."""
    return ConditionalPermutoNeuSField(space, n_instances=n_instances, z_dim=z_dim,
                                       use_time=False, **kw)
