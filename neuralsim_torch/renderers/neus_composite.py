"""The NeuS alpha fused into the composite: kernel K12 (port of
neuralsim_tpu/fields/neus.py:63-77 ``neus_alpha_from_sdf`` with the cos
anneal of neus.py:529-543, then K6's composite, renderers/buffers.py:21).

A NeuS buffer that is composited alone (the multi-object LiDAR step's
street, a close range without a distant field) comes from
``NeuSField.ray_query(fuse_alpha=True)`` without its alpha, carrying the ray
directions ``rays_d`` and the ``cos_anneal`` instead. The renderer that asks
for it composites it with :func:`neus_integrate`: the ``neus_composite``
kernel computes each lane's alpha from the sdf, the nablas and the ray
directions inside the composite, and its backward returns the gradients of
the sdf, the nablas, the rgb and a per-ray share of inv_s's (summed by torch,
so no float atomics). inv_s stays on the card: no host sync. It gives no
gradient to the depths or the ray directions: a backward that asks for one
(pose refinement of a NeuS path) raises on the card. Wrappers and plain
versions live here; on the CPU autograd differentiates the plain version.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import kernels
from ..fields.neus import neus_final_alpha
from .buffers import rendered_from_composite, volume_composite_plain

K12 = kernels.register("neus_composite", "neuralsim_torch/csrc/volume_composite.cu",
                       "neuralsim_tpu/fields/neus.py:63")
K12_BWD = kernels.register("neus_composite.bwd", "neuralsim_torch/csrc/volume_composite.cu",
                           "neuralsim_tpu/fields/neus.py:63")

NeuSComposite = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                      torch.Tensor, torch.Tensor, torch.Tensor]


def neus_composite_plain(t: torch.Tensor, mask: torch.Tensor, sdf: torch.Tensor,
                         nablas: torch.Tensor, rays_d: torch.Tensor, anneal: float,
                         inv_s: torch.Tensor, rgb: Optional[torch.Tensor] = None
                         ) -> NeuSComposite:
    """Plain version of K12. t/mask/sdf: [N, S]; nablas (and rgb): [N, S, 3];
    rays_d: [N, 3]; anneal: the cos anneal in [0, 1]; inv_s: a scalar tensor.

    ``neus_final_alpha`` (JAX neus.py:529-543), then K6's composite. Returns
    (vw, mask_volume, depth_volume, rgb_volume, normals_volume, samples_cnt,
    alpha)."""
    alpha = neus_final_alpha(t, mask, sdf, nablas, rays_d, anneal, inv_s)
    return (*volume_composite_plain(t, mask, alpha, rgb, nablas), alpha)


def _check_k12(name: str, t, mask, sdf, nablas, rays_d, inv_s, rgb) -> Tuple[int, int]:
    N, S = t.shape
    f32 = torch.float32
    want = [(t, (N, S), f32), (mask, (N, S), torch.bool), (sdf, (N, S), f32),
            (nablas, (N, S, 3), f32), (rays_d, (N, 3), f32), (inv_s, (), f32)]
    if rgb is not None:
        want.append((rgb, (N, S, 3), f32))
    kernels.check_cuda(name, *[x for x, _, _ in want])
    for x, shape, dt in want:
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"{name}: expected {shape} {dt}, got {tuple(x.shape)} {x.dtype}")
    return N, S


def neus_composite(t: torch.Tensor, mask: torch.Tensor, sdf: torch.Tensor,
                   nablas: torch.Tensor, rays_d: torch.Tensor, anneal: float,
                   inv_s: torch.Tensor, rgb: Optional[torch.Tensor] = None) -> NeuSComposite:
    """K12 wrapper: the plain version on the CPU, the CUDA kernel on the card
    (inv_s stays on the card: no host sync)."""
    if t.device.type == "cpu":
        return neus_composite_plain(t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb)
    N, S = _check_k12("neus_composite", t, mask, sdf, nablas, rays_d, inv_s, rgb)
    empty = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=t.device)
    vw, alpha = empty(N, S), empty(N, S)
    vw_sum, depth, nrm_v, cnt = empty(N), empty(N), empty(N, 3), empty(N, dt=torch.int32)
    rgb_v = None if rgb is None else empty(N, 3)
    K12.launch("neus_composite_fwd", *map(kernels.ptr, (
        t, mask, sdf, nablas, rays_d, inv_s, rgb, vw, vw_sum, depth, rgb_v, nrm_v, cnt, alpha)),
        N, S, float(anneal), kernels.stream())
    return vw, vw_sum, depth, rgb_v, nrm_v, cnt, alpha


NeuSGrads = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def neus_composite_bwd_plain(t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb, g_vw, g_mask,
                             g_depth, g_rgb, g_nrm, g_alpha) -> NeuSGrads:
    """Plain version of K12's backward: autograd of the plain forward. Takes
    the cotangents of (vw, mask_volume, depth_volume, rgb_volume,
    normals_volume, alpha), each of them possibly None, and returns (d sdf
    [N, S], d nablas [N, S, 3], d rgb, d inv_s of each ray [N]), whose sum is
    the gradient of inv_s."""
    N = t.shape[0]
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(True) for x in (sdf, nablas)]
        inv = inv_s.detach().expand(N).clone().requires_grad_(True)
        c = None if rgb is None else rgb.detach().requires_grad_(True)
        outs = neus_composite_plain(t, mask, *ins, rays_d, anneal, inv[:, None], c)
        cots = (g_vw, g_mask, g_depth, g_rgb, g_nrm, g_alpha)
        loss = sum(((o * g).sum() for o, g in zip(outs[:5] + outs[6:], cots)
                    if o is not None and g is not None), outs[0].new_zeros(()))
        leaves = ins + [inv] + ([] if c is None else [c])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return grads[0], grads[1], None if c is None else grads[3], grads[2]


def neus_composite_bwd(t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb, g_vw, g_mask,
                       g_depth, g_rgb, g_nrm, g_alpha) -> NeuSGrads:
    """K12 backward wrapper: autograd of the plain version on the CPU, the
    CUDA kernel on the card (a cotangent that is None counts as zero)."""
    if t.device.type == "cpu":
        return neus_composite_bwd_plain(t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb,
                                        g_vw, g_mask, g_depth, g_rgb, g_nrm, g_alpha)
    N, S = _check_k12("neus_composite_bwd", t, mask, sdf, nablas, rays_d, inv_s, rgb)
    if g_rgb is not None and rgb is None:
        raise ValueError("neus_composite_bwd: an rgb cotangent without rgb")
    cots = [(g_vw, (N, S)), (g_mask, (N,)), (g_depth, (N,)), (g_rgb, (N, 3)), (g_nrm, (N, 3)),
            (g_alpha, (N, S))]
    for g, shape in cots:
        if g is not None and (tuple(g.shape) != shape or g.dtype != torch.float32):
            raise ValueError(f"neus_composite_bwd: a cotangent must be {shape} float32")
    kernels.check_cuda("neus_composite_bwd", t, *[g for g, _ in cots if g is not None])
    d_sdf, d_nablas = torch.empty_like(sdf), torch.empty_like(nablas)
    d_rgb = None if rgb is None else torch.empty_like(rgb)
    d_inv = torch.empty((N,), dtype=torch.float32, device=t.device)
    K12_BWD.launch("neus_composite_bwd", *map(kernels.ptr, (
        t, mask, sdf, nablas, rays_d, inv_s, rgb, *[g for g, _ in cots], d_sdf, d_nablas,
        d_rgb, d_inv)), N, S, float(anneal), kernels.stream())
    return d_sdf, d_nablas, d_rgb, d_inv


class _NeuSCompositeOnCard(torch.autograd.Function):
    """K12 forward and backward under autograd."""

    @staticmethod
    def forward(ctx, t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb):
        out = neus_composite(t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb)
        ctx.save_for_backward(t, mask, sdf, nablas, rays_d, inv_s, rgb)
        ctx.anneal = anneal
        ctx.mark_non_differentiable(out[5])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_vw, g_mask, g_depth, g_rgb, g_nrm, _g_cnt, g_alpha):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[4]:
            # the CPU's plain version differentiates them; the kernel does not,
            # and a None would drop them without a word
            raise NotImplementedError("the gradient of K12 (neus_composite) to the depths t and "
                                      "the ray directions is not ported on the card (pose "
                                      "refinement)")
        t, mask, sdf, nablas, rays_d, inv_s, rgb = ctx.saved_tensors
        cont = lambda g: None if g is None else g.contiguous()
        d_sdf, d_nablas, d_rgb, d_inv = neus_composite_bwd(
            t, mask, sdf, nablas, rays_d, ctx.anneal, inv_s, rgb, cont(g_vw), cont(g_mask),
            cont(g_depth), cont(g_rgb), cont(g_nrm), cont(g_alpha))
        d_inv_s = d_inv.sum() if ctx.needs_input_grad[6] else None
        return None, None, d_sdf, d_nablas, None, None, d_inv_s, d_rgb


def neus_integrate(buf: Dict[str, Any]) -> Dict[str, Any]:
    """Integrate one NeuS buffer without alpha {t, mask, sdf, nablas,
    rays_d, cos_anneal, details.inv_s, rgb?} into the rendered dict of
    ``volume_integrate``, and add the lanes' alpha to ``buf`` for its
    consumers. K12 under autograd on the card, the plain version on the
    CPU."""
    args = (buf["t"], buf["mask"], buf["sdf"], buf["nablas"], buf["rays_d"],
            buf["cos_anneal"], buf["details"]["inv_s"], buf.get("rgb"))
    *comp, buf["alpha"] = neus_composite_plain(*args) if args[0].device.type == "cpu" \
        else _NeuSCompositeOnCard.apply(*args)
    return rendered_from_composite(*comp)
