"""Volume-buffer integration: dense masked buffers -> per-ray outputs (port of
neuralsim_tpu/renderers/buffers.py:21-52, 55-130).

The composite (masked alpha -> transmittance -> weighted sums) of a sorted
buffer is the ``volume_composite`` kernel (K6), and its gradient into alpha,
rgb and nablas the ``volume_composite.bwd`` kernel; wrappers and plain
versions live here. On the CPU autograd differentiates the plain version; on
the card ``volume_integrate`` goes through one ``torch.autograd.Function``
over the two kernels. The depths ``t`` take a gradient through the depth
sum where the caller asks for it (pose refinement moves the samples of
EmerNeRF's ladder): ``d t = mask * g_depth * vw / max(vw_sum, 1e-8)``, one
more output of the same backward kernel.

``merge_and_integrate`` takes one buffer; or several that are disjoint in
depth and in order (close range, then distant; ``assume_sorted``), which are
concatenated along the sample axis and composited once by K6; or, with
``sort_free``, several that overlap in depth (objects, street, distant): the
concatenation stays unsorted, the ``cross_source_vw`` kernel (K8, with its
backward kernel under autograd) gives each lane's visibility weight, and the
sums are masked sums, which need no order.
The sort-based merge is not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..ops.segment import alpha_to_vw, cross_source_vw, masked_sum

K6 = kernels.register("volume_composite", "neuralsim_torch/csrc/volume_composite.cu",
                      "neuralsim_tpu/renderers/buffers.py:21")

K6_BWD = kernels.register("volume_composite.bwd", "neuralsim_torch/csrc/volume_composite.cu",
                          "neuralsim_tpu/renderers/buffers.py:21")

Composite = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                  Optional[torch.Tensor], torch.Tensor]


def volume_composite_plain(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                           rgb: Optional[torch.Tensor] = None,
                           nablas: Optional[torch.Tensor] = None) -> Composite:
    """Plain version of K6. t/mask/alpha: [N, S]; rgb/nablas: [N, S, 3].

    Returns (vw, mask_volume, depth_volume, rgb_volume, normals_volume,
    samples_cnt); depth is normalised by the weight sum, normals are not.
    """
    vw = alpha_to_vw(alpha, mask)
    vw_sum = masked_sum(vw, mask)
    depth = masked_sum(vw * t, mask) / torch.clamp(vw_sum, min=1e-8)
    m3 = mask[..., None]
    rgb_v = None if rgb is None else masked_sum(vw[..., None] * rgb, m3, dim=-2)
    nrm_v = None if nablas is None else masked_sum(vw[..., None] * nablas, m3, dim=-2)
    return vw, vw_sum, depth, rgb_v, nrm_v, mask.sum(-1, dtype=torch.int32)


def volume_composite(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                     rgb: Optional[torch.Tensor] = None,
                     nablas: Optional[torch.Tensor] = None) -> Composite:
    """K6 wrapper: the plain version on the CPU, the CUDA kernel on the card."""
    if t.device.type == "cpu":
        return volume_composite_plain(t, mask, alpha, rgb, nablas)
    extra = [x for x in (rgb, nablas) if x is not None]
    kernels.check_cuda("volume_composite", t, mask, alpha, *extra)
    N, S = t.shape
    if mask.shape != (N, S) or mask.dtype != torch.bool or alpha.shape != (N, S) \
            or t.dtype != torch.float32 or alpha.dtype != torch.float32 \
            or any(x.shape != (N, S, 3) or x.dtype != torch.float32 for x in extra):
        raise ValueError("volume_composite: bad shapes or dtypes")
    dev = t.device
    vw = torch.empty((N, S), dtype=torch.float32, device=dev)
    vw_sum = torch.empty((N,), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    rgb_v = None if rgb is None else torch.empty((N, 3), dtype=torch.float32, device=dev)
    nrm_v = None if nablas is None else torch.empty((N, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((N,), dtype=torch.int32, device=dev)
    K6.launch("volume_composite_fwd", kernels.ptr(t), kernels.ptr(mask), kernels.ptr(alpha),
              kernels.ptr(rgb), kernels.ptr(nablas), kernels.ptr(vw), kernels.ptr(vw_sum),
              kernels.ptr(depth), kernels.ptr(rgb_v), kernels.ptr(nrm_v), kernels.ptr(cnt),
              N, S, kernels.stream())
    return vw, vw_sum, depth, rgb_v, nrm_v, cnt


Grads = Tuple[Optional[torch.Tensor], ...]


def volume_composite_bwd_plain(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                               rgb: Optional[torch.Tensor], nablas: Optional[torch.Tensor],
                               g_vw: torch.Tensor, g_mask: torch.Tensor,
                               g_depth: torch.Tensor, g_rgb: Optional[torch.Tensor],
                               g_nrm: Optional[torch.Tensor], with_dt: bool = False) -> Grads:
    """Plain version of K6's backward: autograd of the plain forward. Returns
    (d alpha [N, S], d rgb, d nablas [N, S, 3]) for the cotangents of (vw,
    mask_volume, depth_volume, rgb_volume, normals_volume), and d t [N, S]
    after them where ``with_dt``."""
    with torch.enable_grad():
        ins = [None if x is None else x.detach().requires_grad_(True)
               for x in (alpha, rgb, nablas) + ((t,) if with_dt else ())]
        vw, vw_sum, depth, rgb_v, nrm_v, _ = volume_composite_plain(
            ins[3] if with_dt else t, mask, *ins[:3])
        loss = (vw * g_vw).sum() + (vw_sum * g_mask).sum() + (depth * g_depth).sum()
        if rgb is not None:
            loss = loss + (rgb_v * g_rgb).sum()
        if nablas is not None:
            loss = loss + (nrm_v * g_nrm).sum()
        grads = iter(torch.autograd.grad(loss, [x for x in ins if x is not None]))
    return tuple(None if x is None else next(grads) for x in ins)


def volume_composite_bwd(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                         rgb: Optional[torch.Tensor], nablas: Optional[torch.Tensor],
                         g_vw: torch.Tensor, g_mask: torch.Tensor, g_depth: torch.Tensor,
                         g_rgb: Optional[torch.Tensor], g_nrm: Optional[torch.Tensor],
                         with_dt: bool = False) -> Grads:
    """K6 backward wrapper: autograd of the plain version on the CPU, the CUDA
    kernel on the card. ``with_dt``: d t as a fourth output (the kernel
    writes it in the same launch)."""
    if t.device.type == "cpu":
        return volume_composite_bwd_plain(t, mask, alpha, rgb, nablas, g_vw, g_mask,
                                          g_depth, g_rgb, g_nrm, with_dt)
    N, S = t.shape
    f32 = torch.float32
    want = [(t, (N, S), f32), (mask, (N, S), torch.bool), (alpha, (N, S), f32),
            (g_vw, (N, S), f32), (g_mask, (N,), f32), (g_depth, (N,), f32)]
    for x, g in ((rgb, g_rgb), (nablas, g_nrm)):
        if (x is None) != (g is None):
            raise ValueError("volume_composite_bwd: a payload and its cotangent go together")
        if x is not None:
            want += [(x, (N, S, 3), f32), (g, (N, 3), f32)]
    kernels.check_cuda("volume_composite_bwd", *[x for x, _, _ in want])
    for x, shape, dt in want:
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"volume_composite_bwd: expected {shape} {dt}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    d_alpha = torch.empty_like(alpha)
    d_rgb = None if rgb is None else torch.empty_like(rgb)
    d_nablas = None if nablas is None else torch.empty_like(nablas)
    d_t = torch.empty_like(t) if with_dt else None
    K6_BWD.launch("volume_composite_bwd", kernels.ptr(t), kernels.ptr(mask),
                  kernels.ptr(alpha), kernels.ptr(rgb), kernels.ptr(nablas), kernels.ptr(g_vw),
                  kernels.ptr(g_mask), kernels.ptr(g_depth), kernels.ptr(g_rgb),
                  kernels.ptr(g_nrm), kernels.ptr(d_alpha), kernels.ptr(d_rgb),
                  kernels.ptr(d_nablas), kernels.ptr(d_t), N, S, kernels.stream())
    return (d_alpha, d_rgb, d_nablas) + ((d_t,) if with_dt else ())


class _CompositeOnCard(torch.autograd.Function):
    """K6 forward and backward under autograd."""

    @staticmethod
    def forward(ctx, t, mask, alpha, rgb, nablas):
        out = volume_composite(t, mask, alpha, rgb, nablas)
        ctx.save_for_backward(t, mask, alpha, rgb, nablas)
        ctx.mark_non_differentiable(out[5])
        return out

    @staticmethod
    def backward(ctx, g_vw, g_mask, g_depth, g_rgb, g_nrm, _g_cnt):
        t, mask, alpha, rgb, nablas = ctx.saved_tensors
        cont = lambda g: None if g is None else g.contiguous()
        with_dt = ctx.needs_input_grad[0]
        d_alpha, d_rgb, d_nablas, *d_t = volume_composite_bwd(
            t, mask, alpha, rgb, nablas, cont(g_vw), cont(g_mask), cont(g_depth),
            cont(g_rgb), cont(g_nrm), with_dt=with_dt)
        return d_t[0] if with_dt else None, None, d_alpha, d_rgb, d_nablas


def _integrate_vw(buf: Dict[str, Any]) -> Dict[str, Any]:
    """The sums of :func:`volume_integrate` at given weights ``vw``: masked
    sums over the lanes, in no order."""
    vw, mask = buf["vw"], buf["mask"]
    vw_sum = masked_sum(vw, mask)
    out: Dict[str, Any] = {"mask_volume": vw_sum,
                           "depth_volume": masked_sum(vw * buf["t"], mask)
                           / torch.clamp(vw_sum, min=1e-8)}
    for k, name in (("rgb", "rgb_volume"), ("nablas", "normals_volume")):
        if k in buf:
            out[name] = masked_sum(vw[..., None] * buf[k], mask[..., None], dim=-2)
    out["vw"] = vw
    out["samples_cnt"] = mask.sum(-1, dtype=torch.int32)
    return out


def rendered_from_composite(vw: torch.Tensor, vw_sum: torch.Tensor, depth: torch.Tensor,
                            rgb_v: Optional[torch.Tensor], nrm_v: Optional[torch.Tensor],
                            cnt: torch.Tensor) -> Dict[str, Any]:
    """The rendered dict of a composite's outputs (K6's, or K12's)."""
    out: Dict[str, Any] = {"mask_volume": vw_sum, "depth_volume": depth}
    if rgb_v is not None:
        out["rgb_volume"] = rgb_v
    if nrm_v is not None:
        out["normals_volume"] = nrm_v
    out["vw"] = vw
    out["samples_cnt"] = cnt
    return out


def volume_integrate(buf: Dict[str, Any]) -> Dict[str, Any]:
    """Integrate one dense buffer {t, mask, alpha, rgb?, nablas?} into the
    rendered dict (depth normalised by the weight sum). The buffer is sorted
    in depth, or carries its lanes' visibility weights as ``vw`` (the
    order-free composite of an unsorted merge)."""
    if "vw" in buf:
        return _integrate_vw(buf)
    args = (buf["t"], buf["mask"], buf["alpha"], buf.get("rgb"), buf.get("nablas"))
    return rendered_from_composite(*(volume_composite_plain(*args)
                                     if args[0].device.type == "cpu"
                                     else _CompositeOnCard.apply(*args)))


def merge_and_integrate(buffers: Sequence[Dict[str, Any]], *, with_per_src: bool = False,
                        per_src_indices: Optional[Sequence[int]] = None,
                        assume_sorted: bool = False, sort_free: bool = False,
                        integrate: Callable[[Dict[str, Any]], Dict[str, Any]] = volume_integrate
                        ) -> Dict[str, Any]:
    """Merge the buffers of several models, composite once and, with
    ``with_per_src``, give each source's share of the total as
    ``per_src[i] = {mask_volume, depth_volume, rgb_volume}`` (None for a
    source outside ``per_src_indices``, when that is given).

    ``assume_sorted``: every valid sample of buffer k lies before buffer
    k+1's (close range, then distant, whose near is the close range's far), so
    the concatenation along the sample axis is already in depth order over
    the valid lanes, and masked lanes have alpha 0. ``sort_free``: buffers
    that overlap in depth, composited in no order by ``cross_source_vw``
    (K8). Several buffers need one of
    the two. The rendered dict carries the merged buffer, with each lane's
    source index ``src`` (and, sort-free, its weight ``vw``), under
    ``merged_buffer``. ``integrate`` composites the merged buffer into the
    rendered dict: :func:`volume_integrate`, or, for one NeuS buffer that
    carries no alpha yet, ``renderers.neus_composite.neus_integrate``.
    """
    if len(buffers) == 1:
        merged = dict(buffers[0])
        merged["src"] = torch.zeros_like(merged["t"], dtype=torch.int32)
    elif assume_sorted or sort_free:
        merged = {"t": torch.cat([b["t"] for b in buffers], dim=-1),
                  "mask": torch.cat([b["mask"] for b in buffers], dim=-1)}
        for k in ("alpha", "rgb", "nablas"):
            if all(k in b for b in buffers):
                merged[k] = torch.cat([b[k] for b in buffers],
                                      dim=-1 if k == "alpha" else -2).contiguous()
        merged["src"] = torch.cat([torch.full_like(b["t"], i, dtype=torch.int32)
                                   for i, b in enumerate(buffers)], dim=-1)
        if not assume_sorted:
            merged["vw"] = cross_source_vw(merged["t"], merged["mask"], merged["alpha"])
    else:
        raise NotImplementedError("merging buffers that overlap in depth needs sort_free=True "
                                  "(the sort-based merge is not ported)")
    out = integrate(merged)
    out["merged_buffer"] = merged
    if with_per_src:
        wanted = range(len(buffers)) if per_src_indices is None else per_src_indices
        vw = out["vw"]
        out["per_src"] = []
        for i in range(len(buffers)):
            if i not in wanted:
                out["per_src"].append(None)
                continue
            sel = (merged["src"] == i) & merged["mask"]
            share = masked_sum(vw, sel)
            d = {"mask_volume": share,
                 "depth_volume": masked_sum(vw * merged["t"], sel)
                 / torch.clamp(share, min=1e-8)}
            if "rgb" in merged:
                d["rgb_volume"] = masked_sum(vw[..., None] * merged["rgb"], sel[..., None],
                                             dim=-2)
            out["per_src"].append(d)
    return out
