"""NeuS SDF field: LoTD encoding + SDF decoder + radiance net + learned inv_s,
with the fixed-shape hierarchical ray query (port of
neuralsim_tpu/fields/neus.py:35-56, 63-100, 107-234, 237-329, 350-557).

The upsample stage (neighbour cos, NeuS alpha at a fixed inv_s, weights and
the inverse-CDF draws) is the first launch of the ``neus_upsample`` kernel
(K5a); its wrapper and plain version live here. Without ``noise`` the ray
query is deterministic: the JAX package's eval path (``key=None``,
``perturb=False``). With it, it is the training query: the caller draws the
coarse jitter and each stage's stratified noise from its own
``torch.Generator`` and hands them in. With ``occ_t_fn`` the coarse samples
come from the occupancy grid's march instead of the uniform ladder. The
proposal ladder only places
samples and always runs under ``torch.no_grad()`` (JAX's
``proposal_no_grad``); the final evaluation carries the gradients.

The LoTD geometry and, through ``fields/conditional.py``, the permutohedral
one are ported, with analytic nablas; the decoder's ``vjp`` is the explicit
backward :meth:`MLP.forward_and_input_grad`. The query passes a per-ray
instance index ``bidx`` on to every sample, for the conditional fields of
shared models (``fields/conditional.py``); this field itself takes none.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import kernels
from ..maths.common import safe_normalize
from ..maths.transforms import clip
from ..ops.segment import alpha_to_vw, det_u_on, merge_sorted_samples, sample_pdf
from .blocks import MLP
from .embedders import sh_embedder
from .encodings.lotd import CpLines, make_lotd
from .spatial import AABBSpace

K5A = kernels.register("neus_upsample.weights_pdf", "neuralsim_torch/csrc/neus_upsample.cu",
                       "neuralsim_tpu/fields/neus.py:93")


def map_chunked(fn: Callable[..., torch.Tensor], x: torch.Tensor, chunk: Optional[int],
                *more: torch.Tensor) -> torch.Tensor:
    """``fn(x, *more)`` over the leading axis of ``x`` (and of ``more``, the
    same length) in pieces of at most ``chunk`` rows, which bounds the memory
    of a huge field evaluation (the occupancy grid's 128^3 points); the values
    do not depend on the chunking."""
    if not chunk or x.shape[0] <= chunk:
        return fn(x, *more)
    return torch.cat([fn(x[s:s + chunk], *(m[s:s + chunk] for m in more))
                      for s in range(0, x.shape[0], chunk)], dim=0)


# ---------------------------------------------------------------------------
# NeuS SDF -> alpha math
# ---------------------------------------------------------------------------

def clip01(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) with ``jnp.clip``'s gradient (:func:`clip`)."""
    return clip(x, 0.0, 1.0)


def neus_alpha_from_sdf(sdf: torch.Tensor, cos: torch.Tensor, dist: torch.Tensor,
                        inv_s, eps: float = 1e-5) -> torch.Tensor:
    """NeuS CDF-ratio section alpha from the sample SDF and a cos estimate."""
    est_prev = sdf - cos * dist * 0.5
    est_next = sdf + cos * dist * 0.5
    cdf_prev = torch.sigmoid(est_prev * inv_s)
    cdf_next = torch.sigmoid(est_next * inv_s)
    return clip01((cdf_prev - cdf_next + eps) / (cdf_prev + eps))


def neus_final_alpha(t: torch.Tensor, mask: torch.Tensor, sdf: torch.Tensor,
                     nablas: torch.Tensor, rays_d: torch.Tensor, anneal: float,
                     inv_s) -> torch.Tensor:
    """The alpha of the final evaluation (JAX neus.py:529-543): the cos
    annealed from the half-shifted to the true cos ``rays_d . nablas``, the
    last lane's dt 1e-3, masked lanes 0. t/mask/sdf: [N, S]; nablas
    [N, S, 3]; rays_d [N, 3]."""
    true_cos = torch.sum(rays_d[:, None, :] * nablas, dim=-1)
    cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
            + torch.relu(-true_cos) * anneal)
    alpha = neus_alpha_from_sdf(sdf, cos, _dt_last_1e3(t), inv_s)
    return torch.where(mask, alpha, torch.zeros_like(alpha))


def neighbor_cos_estimate(t: torch.Tensor, sdf: torch.Tensor,
                          clip_range: Tuple[float, float] = (-1e3, 0.0)) -> torch.Tensor:
    """d(sdf)/dt from neighbouring samples, clipped non-positive; the last
    sample repeats its neighbour's estimate."""
    ds = sdf[..., 1:] - sdf[..., :-1]
    dt = torch.clamp(t[..., 1:] - t[..., :-1], min=1e-6)
    cos = torch.clamp(ds / dt, clip_range[0], clip_range[1])
    return torch.cat([cos, cos[..., -1:]], dim=-1)


def _dt_last_1e3(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t[..., 1:] - t[..., :-1], torch.full_like(t[..., :1], 1e-3)], dim=-1)


def sdf_to_upsample_weights(t: torch.Tensor, sdf: torch.Tensor, mask: torch.Tensor,
                            inv_s: float) -> torch.Tensor:
    """Visibility weights for one upsampling stage at a fixed inv_s."""
    cos = neighbor_cos_estimate(t, sdf)
    return alpha_to_vw(neus_alpha_from_sdf(sdf, cos, _dt_last_1e3(t), inv_s), mask)


def upsample_weights_pdf_plain(t: torch.Tensor, sdf: torch.Tensor, mask: torch.Tensor,
                               near: torch.Tensor, far: torch.Tensor, inv_s: float,
                               n_samples: int, noise: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5a: (weights [N, S], new depths [N, n_samples])."""
    w = sdf_to_upsample_weights(t, sdf, mask, inv_s)
    bins = torch.cat([t, torch.maximum(far, near + 1e-4)[:, None]], dim=-1)
    return w, sample_pdf(bins, w, n_samples, noise=noise)


# K5a stages a ray's 8 S + 1 floats in shared memory, two rays a warp: at
# most the H100's 227 KB a block
UPSAMPLE_MAX_SAMPLES = (227 * 1024 // 8 - 1) // 8


def upsample_weights_pdf(t: torch.Tensor, sdf: torch.Tensor, mask: torch.Tensor,
                         near: torch.Tensor, far: torch.Tensor, inv_s: float,
                         n_samples: int, noise: Optional[torch.Tensor] = None,
                         with_weights: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K5a wrapper: the plain version on the CPU, the CUDA kernel on the card,
    for up to UPSAMPLE_MAX_SAMPLES (3,631) samples a ray. The weights come
    back only ``with_weights`` (else None): the upsample stages need only the
    new depths."""
    if t.device.type == "cpu":
        w, t_new = upsample_weights_pdf_plain(t, sdf, mask, near, far, inv_s, n_samples, noise)
        return (w if with_weights else None), t_new
    N, S = t.shape
    # the draws: the midpoints, made once a device, or the noise, from which
    # the kernel forms the stratified draws itself
    if noise is None:
        u, draws = det_u_on(n_samples, t.device), (n_samples,)
    else:
        u, noise, draws = None, noise.contiguous(), (N, n_samples)
    given = noise if u is None else u
    kernels.check_cuda("neus_upsample_weights_pdf", t, sdf, mask, near, far, given)
    if sdf.shape != (N, S) or mask.shape != (N, S) or mask.dtype != torch.bool \
            or near.shape != (N,) or far.shape != (N,) or given.shape != draws \
            or any(x.dtype != torch.float32 for x in (t, sdf, near, far, given)):
        raise ValueError("neus_upsample_weights_pdf: bad shapes or dtypes")
    if S < 2 or n_samples < 1:
        raise ValueError("neus_upsample_weights_pdf: needs S >= 2 and n_samples >= 1")
    if S > UPSAMPLE_MAX_SAMPLES:
        raise ValueError(f"neus_upsample_weights_pdf: {S} samples a ray, more than "
                         f"{UPSAMPLE_MAX_SAMPLES}")
    w = torch.empty((N, S), dtype=torch.float32, device=t.device) if with_weights else None
    t_new = torch.empty((N, n_samples), dtype=torch.float32, device=t.device)
    K5A.launch("neus_upsample_weights_pdf", kernels.ptr(t), kernels.ptr(sdf),
               kernels.ptr(mask), kernels.ptr(near), kernels.ptr(far), kernels.ptr(u),
               kernels.ptr(noise), kernels.ptr(w), kernels.ptr(t_new), N, S, n_samples,
               float(inv_s), kernels.stream())
    return w, t_new


# ---------------------------------------------------------------------------
# The field model
# ---------------------------------------------------------------------------

class NeuSField(nn.Module):
    """NeuS implicit surface on an LoTD encoding (or on the ``encoding``
    module given, as the permuto fields do).

    Parameters (JAX names): ``encoding.table``, ``decoder`` and ``radiance``
    MLP layers, and the scalar ``ln_inv_s``. The radiance net conditions on
    (x, SH(view dir), normalised nablas, geometry feature[, appearance code
    h_appear of ``appear_embed_dim``]).
    """

    def __init__(self, space: Optional[AABBSpace] = None, *,
                 encoding_cfg: Optional[Dict] = None,
                 geo_feat_dim: int = 15,
                 decoder_hidden: int = 64, decoder_depth: int = 1,
                 radiance_hidden: int = 64, radiance_depth: int = 2,
                 sh_degree: int = 4,
                 ln_inv_s_init: float = math.log(20.0),
                 inv_s_final: Optional[float] = None,
                 inv_s_anneal_start_it: int = 0,
                 inv_s_anneal_stop_it: int = 0,
                 cos_anneal_stop_it: int = 0,
                 radius_init: float = 0.5,
                 sdf_scale: float = 1.0,
                 eval_chunk: int = 2_000_000,
                 appear_embed_dim: int = 0,
                 encoding: Optional[nn.Module] = None):
        super().__init__()
        self.space = space or AABBSpace()
        self.geo_feat_dim = geo_feat_dim
        self.ln_inv_s_init = ln_inv_s_init
        self.inv_s_final = inv_s_final
        self.inv_s_anneal_start_it = inv_s_anneal_start_it
        self.inv_s_anneal_stop_it = inv_s_anneal_stop_it
        self.cos_anneal_stop_it = cos_anneal_stop_it
        self.sdf_scale = sdf_scale
        self.eval_chunk = eval_chunk
        self.appear_embed_dim = appear_embed_dim
        self._geo_init_bias = radius_init

        self.encoding = make_lotd(encoding_cfg or {}, input_dim=3) if encoding is None \
            else encoding
        self.decoder = MLP(self.encoding.out_dim, 1 + geo_feat_dim, hidden=decoder_hidden,
                           depth=decoder_depth, activation="relu")
        self.dir_embed, dir_dim = sh_embedder(sh_degree)
        self.radiance = MLP(3 + dir_dim + 3 + geo_feat_dim + appear_embed_dim, 3,
                            hidden=radiance_hidden,
                            depth=radiance_depth, activation="relu",
                            output_activation="sigmoid")
        self.ln_inv_s = nn.Parameter(torch.tensor(ln_inv_s_init, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.decoder.reset_parameters(generator)
        self.radiance.reset_parameters(generator)
        self.encoding.reset_parameters(generator)
        self.ln_inv_s.fill_(self.ln_inv_s_init)

    # -- geometry ------------------------------------------------------------
    def _sphere_bias(self) -> float:
        return self._geo_init_bias * float(self.space.half_extent.mean())

    def _encoding_input(self, x: torch.Tensor, bidx: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoding's input at object coordinates ``x`` [..., 3]: the
        coordinates normalised into [0, 1] (the permuto conditional field
        appends the instance latent)."""
        return self.space.normalize_coords(x)

    def _decoder_input(self, h: torch.Tensor, bidx: Optional[torch.Tensor]) -> torch.Tensor:
        """The SDF decoder's input at encoding features ``h`` [..., C]: ``h``
        itself (this field takes no instance index; the conditional fields
        append to it)."""
        if bidx is not None:
            raise NotImplementedError("a NeuSField takes no instance index "
                                      "(the batched LoTD tables are not ported)")
        return h

    def query_sdf_feat(self, x: torch.Tensor, cp_lines: Optional[CpLines] = None,
                       bidx: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [..., 3] object coords -> (sdf [...], geometry feature [..., F]).
        ``cp_lines``: the encoding's ``kernel_lines()``, if already computed."""
        h = self.encoding(self._encoding_input(x, bidx), cp_lines)
        out = self.decoder(self._decoder_input(h, bidx))
        sdf = out[..., 0] * self.sdf_scale
        if self._geo_init_bias:
            # sphere-init bias: the field starts from an approximate sphere SDF
            sdf = sdf + (torch.linalg.norm(x - self.space.center, dim=-1)
                         - self._sphere_bias())
        return sdf, out[..., 1:]

    def query_sdf(self, x: torch.Tensor, cp_lines: Optional[CpLines] = None,
                  bidx: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.query_sdf_feat(x, cp_lines, bidx)[0]

    def sdf_nablas_feat(self, x: torch.Tensor, cp_lines: Optional[CpLines] = None,
                        bidx: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(sdf, nablas, feat) with analytic nablas: the encoding's jacobian
        chained with the decoder's input gradient of the sdf output."""
        h, jh = self.encoding.with_jacobian(self._encoding_input(x, bidx), cp_lines)
        cot = torch.zeros(h.shape[:-1] + (self.decoder.out_dim,), dtype=h.dtype,
                          device=h.device)
        cot[..., 0] = 1.0
        out, g_in = self.decoder.forward_and_input_grad(self._decoder_input(h, bidx), cot)
        g_h = g_in[..., :h.shape[-1]]            # d sdf / d features of the encoding
        sdf = out[..., 0] * self.sdf_scale
        feat = out[..., 1:]
        du_dx = 1.0 / (self.space.aabb_max - self.space.aabb_min)
        nablas = (g_h.unsqueeze(-1) * jh).sum(-2) * du_dx * self.sdf_scale
        if self._geo_init_bias:
            delta = x - self.space.center
            dist = torch.linalg.norm(delta, dim=-1, keepdim=True)
            sdf = sdf + (dist[..., 0] - self._sphere_bias())
            nablas = nablas + delta / torch.clamp(dist, min=1e-8)
        return sdf, nablas, feat

    # -- appearance ------------------------------------------------------------
    def query_radiance(self, x: torch.Tensor, v: torch.Tensor, nablas: torch.Tensor,
                       feat: torch.Tensor, h_appear: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """rgb at points x [..., 3]; ``h_appear`` broadcasts to x's leading
        shape (zeros where not given) when the field takes an appearance code."""
        inputs = [x, self.dir_embed(v), safe_normalize(nablas), feat]
        if self.appear_embed_dim:
            shape = x.shape[:-1] + (self.appear_embed_dim,)
            inputs.append(x.new_zeros(shape) if h_appear is None else h_appear.expand(shape))
        return self.radiance(torch.cat(inputs, dim=-1))

    # -- inv_s control ---------------------------------------------------------
    def forward_inv_s(self, it: Optional[float] = None,
                      override: Optional[float] = None) -> torch.Tensor:
        """Learned inv_s, optionally mixed linearly toward ``inv_s_final``.
        Without ``it`` (a render, an evaluation) the mix reads ``eval_it``, the
        iteration of the checkpoint the field was loaded from
        (``utils.misc.set_eval_iteration``), so that a checkpoint renders at
        the sharpness it reached; without either the anneal counts as
        complete."""
        if override is not None:
            return torch.tensor(override, dtype=torch.float32, device=self.ln_inv_s.device)
        inv_s = torch.exp(self.ln_inv_s)
        if it is None:
            it = getattr(self, "eval_it", None)
        if self.inv_s_final is not None and self.inv_s_anneal_stop_it > 0:
            if it is None:  # eval with unknown training stage: anneal complete
                return torch.tensor(self.inv_s_final, dtype=torch.float32,
                                    device=inv_s.device)
            start = self.inv_s_anneal_start_it
            span = max(self.inv_s_anneal_stop_it - start, 1)
            frac = min(max((float(it) - start) / span, 0.0), 1.0)
            inv_s = (1.0 - frac) * inv_s + frac * self.inv_s_final
        return inv_s

    def cos_anneal(self, it: Optional[float]) -> float:
        if it is None or self.cos_anneal_stop_it <= 0:
            return 1.0
        return min(max(float(it) / self.cos_anneal_stop_it, 0.0), 1.0)

    # -- ray query -------------------------------------------------------------
    def ray_query(self, rays_o: torch.Tensor, rays_d: torch.Tensor, *,
                  it: Optional[float] = None,
                  near: Optional[torch.Tensor] = None,
                  far: Optional[torch.Tensor] = None,
                  num_coarse: int = 128,
                  num_fine: Sequence[int] = (32, 32),
                  upsample_inv_s: float = 64.0,
                  upsample_inv_s_factors: Sequence[float] = (1.0, 4.0),
                  with_rgb: bool = True,
                  forward_inv_s: Optional[float] = None,
                  noise: Optional[Dict[str, Any]] = None,
                  occ_t_fn: Optional[Callable] = None,
                  bidx: Optional[torch.Tensor] = None,
                  fuse_alpha: bool = False,
                  h_appear: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Hierarchical NeuS ray query with fixed shapes: uniform coarse
        samples (or the occupancy march's), one upsample stage per ``num_fine`` entry at inv_s
        ``upsample_inv_s * factor``, each merged into the sorted buffer, then
        the full evaluation with the learned inv_s.

        rays_o/rays_d: [N, 3] object coords. ``noise``: uniform draws in
        [0, 1) for the training query, ``{"coarse": [N, num_coarse],
        "fine": [[N, nf] per stage]}``; None gives the deterministic query.
        ``occ_t_fn(rays_o, rays_d, near, far, num_coarse, noise) -> (t, mask)``
        replaces the uniform coarse ladder; it gets ``noise["occ_proposal"]``
        ([N, num_coarse], or None) and ``"coarse"`` is then not read.
        ``bidx`` [N] int: a per-ray instance index, handed to the field at
        every sample of the ray. ``h_appear`` [N, appear_embed_dim]: a
        per-ray appearance code for the radiance net.
        Returns the dense volume buffer
        {t, mask, alpha, sdf, nablas, rgb [N, S(, 3)], details}. With
        ``fuse_alpha`` (a buffer that is composited alone) the buffer has no
        ``alpha`` yet but the ray directions ``rays_d`` and the ``cos_anneal``:
        the renderer composites it with ``renderers.neus_composite.neus_integrate``,
        which computes the alpha inside the composite (kernel K12 on the card)
        and adds it to the buffer.
        """
        n_, f_, hit = self.space.ray_test(rays_o, rays_d, near=near, far=far)
        lines = self.encoding.kernel_lines()     # shared by the four encodings

        def per_sample(shape):
            """bidx broadcast over ``shape``'s samples: a view, read one
            index a ray by the conditional fields' latent lookup."""
            return None if bidx is None else bidx[:, None].expand(shape)

        with torch.no_grad():                    # the ladder only places samples
            if occ_t_fn is not None:
                t, mask = occ_t_fn(rays_o, rays_d, n_, f_, num_coarse,
                                   None if noise is None else noise.get("occ_proposal"))
                mask = mask & hit[:, None]
            else:
                u = torch.linspace(0.0, 1.0, num_coarse, dtype=torch.float32,
                                   device=rays_o.device)
                if noise is not None:
                    u = torch.clamp(u + (noise["coarse"] - 0.5) / num_coarse, 0.0, 1.0)
                t = n_[:, None] + (f_ - n_)[:, None] * u
                mask = hit[:, None].expand(t.shape).contiguous()

            x = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
            sdf = self.query_sdf(x.reshape(-1, 3), lines, per_sample(t.shape)).reshape(t.shape)

            for stage, (nf, fac) in enumerate(zip(num_fine, upsample_inv_s_factors)):
                _, t_new = upsample_weights_pdf(
                    t.contiguous(), sdf.contiguous(), mask, n_, f_, upsample_inv_s * fac, nf,
                    None if noise is None else noise["fine"][stage], with_weights=False)
                x_new = rays_o[:, None, :] + t_new[..., None] * rays_d[:, None, :]
                sdf_new = self.query_sdf(x_new.reshape(-1, 3), lines,
                                         per_sample(t_new.shape)).reshape(t_new.shape)
                m_new = hit[:, None].expand(t_new.shape).contiguous()
                t, mask, sdf = merge_sorted_samples(t.contiguous(), t_new, mask, m_new,
                                                    sdf.contiguous(), sdf_new.contiguous())

        x = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
        shp = t.shape
        sdf, nablas, feat = self.sdf_nablas_feat(x.reshape(-1, 3), lines, per_sample(shp))
        sdf = sdf.reshape(shp)
        nablas = nablas.reshape(shp + (3,))
        feat = feat.reshape(shp + (feat.shape[-1],))

        dirs = rays_d[:, None, :].expand(x.shape)
        anneal = self.cos_anneal(it)
        inv_s = self.forward_inv_s(it, override=forward_inv_s)
        buf: Dict[str, Any] = {"t": t, "mask": mask, "sdf": sdf, "nablas": nablas}
        if fuse_alpha:
            buf.update(rays_d=rays_d, cos_anneal=anneal)
        else:
            buf["alpha"] = neus_final_alpha(t, mask, sdf, nablas, rays_d, anneal, inv_s)
        if with_rgb:
            buf["rgb"] = self.query_radiance(x, dirs, nablas, feat,
                                             None if h_appear is None else h_appear[:, None, :])
        first_valid = torch.argmax(mask.to(torch.uint8), dim=-1)
        near_sdf = torch.gather(sdf, -1, first_valid[:, None])[:, 0]
        buf["details"] = {"near_sdf": torch.where(hit, near_sdf, torch.full_like(near_sdf, 1e10)),
                          "inv_s": inv_s, "hit": hit, "near": n_, "far": f_}
        return buf

    # -- training helpers ------------------------------------------------------
    def sample_pts_uniform(self, noise: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x, sdf, nablas) at points spread over the space by the uniform
        draws ``noise`` [n, 3]; feeds the eikonal and sparsity losses."""
        x = self.space.uniform_points(noise)
        sdf, nablas, _ = self.sdf_nablas_feat(x)
        return x, sdf, nablas
