"""Fixed-depth masked sample-buffer ops (port of the main-path part of
neuralsim_tpu/ops/segment.py:30-76, 105-190, 229-276).

Buffers are dense [N_rays, S] with a boolean validity mask, as in the JAX
package. Two kernels have their wrappers and plain versions here: the rank
merge of two sorted sample lists, the second launch of the ``neus_upsample``
kernel (K5b), and the order-free composite of an unsorted buffer,
``cross_source_vw`` (K8), forward and backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

K5B = kernels.register("neus_upsample.merge", "neuralsim_torch/csrc/neus_upsample.cu",
                       "neuralsim_tpu/ops/segment.py:150")
K8 = kernels.register("cross_source_vw", "neuralsim_torch/csrc/cross_source_vw.cu",
                      "neuralsim_tpu/ops/segment.py:105")
K8_BWD = kernels.register("cross_source_vw.bwd", "neuralsim_torch/csrc/cross_source_vw.cu",
                          "neuralsim_tpu/ops/segment.py:105")

_BIG = 1e10                   # the depth key of a masked lane
OCC_CAP_EPS = 1e-3            # an occluder's alpha is capped at 1 - this


# The two scans below run one float32 step at a time from the left, the order
# the kernels accumulate in. torch.cumsum/cumprod take another (double
# accumulation on the CPU, a parallel scan on the card), and the inverse-CDF
# draws turn a last-bit difference of the cdf in a near-empty bin into a
# visible shift of the drawn depth.

def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last axis."""
    out = torch.empty_like(x)
    acc = out[..., 0] = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = out[..., i] = acc + x[..., i]
    return out


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} x_j along the last axis (first element 1)."""
    out = torch.empty_like(x)
    acc = out[..., 0] = torch.ones_like(x[..., 0])
    for i in range(1, x.shape[-1]):
        acc = out[..., i] = acc * x[..., i - 1]
    return out


def alpha_to_vw(alpha: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Visibility weights vw_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10);
    masked samples have alpha 0, so they neither occlude nor emit."""
    if mask is not None:
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    return alpha * exclusive_cumprod(1.0 - alpha + 1e-10)


def tau_to_alpha(tau: torch.Tensor) -> torch.Tensor:
    """Optical thickness (sigma * dt) -> alpha."""
    return 1.0 - torch.exp(-torch.clamp(tau, min=0.0))


def masked_sum(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    if mask is not None:
        x = torch.where(mask, x, torch.zeros_like(x))
    return torch.sum(x, dim=dim)


def det_u(n_samples: int, device=None) -> torch.Tensor:
    """The deterministic draws of ``sample_pdf``: the n stratum midpoints."""
    return torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                          dtype=torch.float32, device=device)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               noise: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-transform sampling of ``n_samples`` depths per ray from the
    piecewise-constant pdf ``weights + eps`` over the sorted ``bins`` [N, S+1].

    The direct inverse-CDF form of the JAX package:
    ``t(u) = bins_0 + sum_i len_i * clip((u - cdf_i) / (cdf_{i+1} - cdf_i), 0, 1)``.
    Draws are the stratum midpoints, or ``(k + noise[:, k]) / n`` for a given
    [N, n] noise in [0, 1) (stratified, so the output is sorted either way).
    """
    w = weights + eps
    csum = cumsum_f32(w)
    cdf = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1) / csum[..., -1:]
    if noise is None:
        u = det_u(n_samples, bins.device).expand(cdf.shape[:-1] + (n_samples,))
    else:
        u = (torch.arange(n_samples, dtype=torch.float32, device=bins.device) + noise) \
            / n_samples
    c0 = cdf[..., None, :-1]
    c1 = cdf[..., None, 1:]
    seg = torch.clamp((u[..., :, None] - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0)
    dt = (bins[..., 1:] - bins[..., :-1])[..., None, :]
    return bins[..., :1] + torch.sum(seg * dt, dim=-1)


def merge_sorted_samples_plain(t_a: torch.Tensor, t_b: torch.Tensor,
                               mask_a: torch.Tensor, mask_b: torch.Tensor,
                               sdf_a: torch.Tensor, sdf_b: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5b: merge two per-ray ascending lists [N, A], [N, B]
    with their mask and sdf payloads by rank placement (ties: ``a`` first)."""
    A, B = t_a.shape[-1], t_b.shape[-1]
    pos_a = torch.arange(A, device=t_a.device) + \
        (t_b[:, None, :] < t_a[:, :, None]).sum(-1)
    pos_b = torch.arange(B, device=t_a.device) + \
        (t_a[:, :, None] <= t_b[:, None, :]).sum(-2)

    def place(a, b):
        out = torch.empty(a.shape[:-1] + (A + B,), dtype=a.dtype, device=a.device)
        out.scatter_(-1, pos_a, a)
        out.scatter_(-1, pos_b, b)
        return out

    return place(t_a, t_b), place(mask_a, mask_b), place(sdf_a, sdf_b)


# K5b holds one ray's A + B depths in a block's shared memory, at most the
# H100's 227 KB a block
MERGE_MAX_WIDTH = 227 * 1024 // 4


def merge_sorted_samples(t_a: torch.Tensor, t_b: torch.Tensor,
                         mask_a: torch.Tensor, mask_b: torch.Tensor,
                         sdf_a: torch.Tensor, sdf_b: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5b wrapper: the plain version on the CPU, the CUDA kernel on the card,
    for lists of up to MERGE_MAX_WIDTH (58,112) elements together; wider ones
    raise on the card."""
    if t_a.device.type == "cpu":
        return merge_sorted_samples_plain(t_a, t_b, mask_a, mask_b, sdf_a, sdf_b)
    kernels.check_cuda("merge_sorted_samples", t_a, t_b, mask_a, mask_b, sdf_a, sdf_b)
    N, A = t_a.shape
    B = t_b.shape[1]
    for x, shape, dt in ((t_b, (N, B), torch.float32), (mask_a, (N, A), torch.bool),
                         (mask_b, (N, B), torch.bool), (sdf_a, (N, A), torch.float32),
                         (sdf_b, (N, B), torch.float32), (t_a, (N, A), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"merge_sorted_samples: expected {shape} {dt}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if A + B > MERGE_MAX_WIDTH:
        raise ValueError(f"merge_sorted_samples: {A} + {B} elements a ray, more than the "
                         f"{MERGE_MAX_WIDTH} that fit a block's shared memory")
    t = torch.empty((N, A + B), dtype=torch.float32, device=t_a.device)
    m = torch.empty((N, A + B), dtype=torch.bool, device=t_a.device)
    s = torch.empty((N, A + B), dtype=torch.float32, device=t_a.device)
    K5B.launch("merge_sorted_samples", kernels.ptr(t_a), kernels.ptr(t_b),
               kernels.ptr(mask_a), kernels.ptr(mask_b), kernels.ptr(sdf_a),
               kernels.ptr(sdf_b), kernels.ptr(t), kernels.ptr(m), kernels.ptr(s),
               N, A, B, kernels.stream())
    return t, m, s


def cross_source_vw_plain(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of K8: visibility weights of an UNSORTED buffer [N, L].

    vw_i = a_i * exp(sum_j [(key_j, j) < (key_i, i)] * log(1 - min(a_j, 1 - 1e-3)))
    with a = mask ? clip(alpha, 0, 1) : 0 and key = mask ? t : 1e10: the
    composite of a stable depth sort, without sorting. The cap keeps an
    occluder's log finite (and its gradient bounded, 1 / 1e-3); it lets at
    most 1e-3 of the light through, while a lane's own emission stays exact.
    Autograd differentiates it through alpha (not through the order). The
    clip and the cap are ``torch.maximum`` / ``torch.minimum``, which split a
    tie's gradient in halves as ``jnp.clip`` and ``jnp.minimum`` do (at alpha
    exactly 0, 1 or float32(0.999)); ``torch.clamp`` would pass all of it."""
    zero, one = alpha.new_zeros(()), alpha.new_ones(())
    a = torch.where(mask, torch.minimum(torch.maximum(alpha, zero), one), zero)
    log1ma = torch.log1p(-torch.minimum(a, alpha.new_tensor(1.0 - OCC_CAP_EPS)))
    key = torch.where(mask, t, torch.full_like(t, _BIG))
    ki, kj = key[..., :, None], key[..., None, :]
    idx = torch.arange(t.shape[-1], device=t.device)
    before = (kj < ki) | ((kj == ki) & (idx[None, :] < idx[:, None]))
    log_t = torch.sum(torch.where(before, log1ma[..., None, :], 0.0), dim=-1)
    return a * torch.exp(log_t)


def _check_k8(name: str, *tensors: torch.Tensor) -> Tuple[int, int]:
    kernels.check_cuda(name, *tensors)
    N, L = tensors[0].shape
    for i, x in enumerate(tensors):           # the mask comes second
        want = torch.bool if i == 1 else torch.float32
        if tuple(x.shape) != (N, L) or x.dtype != want:
            raise ValueError(f"{name}: t, alpha [N, L] float32 and mask [N, L] bool, got "
                             f"{tuple(x.shape)} {x.dtype}")
    return N, L


def cross_source_vw_fwd(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                        with_logt: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The K8 forward kernel -> (vw, the log transmittance S [N, L] when
    ``with_logt``, which the backward kernel reads)."""
    N, L = _check_k8("cross_source_vw", t, mask, alpha)
    vw = torch.empty((N, L), dtype=torch.float32, device=t.device)
    logt = torch.empty_like(vw) if with_logt else None
    K8.launch("cross_source_vw", kernels.ptr(t), kernels.ptr(mask), kernels.ptr(alpha),
              kernels.ptr(vw), kernels.ptr(logt), N, L, kernels.stream())
    return vw, logt


def cross_source_vw_bwd(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                        logt: torch.Tensor, g_vw: torch.Tensor) -> torch.Tensor:
    """The K8 backward kernel: d alpha [N, L] for the cotangent ``g_vw`` of
    the weights, from the forward's log transmittance ``logt``."""
    N, L = _check_k8("cross_source_vw_bwd", t, mask, alpha, logt, g_vw)
    d_alpha = torch.empty_like(alpha)
    K8_BWD.launch("cross_source_vw_bwd", kernels.ptr(t), kernels.ptr(mask),
                  kernels.ptr(alpha), kernels.ptr(logt), kernels.ptr(g_vw),
                  kernels.ptr(d_alpha), N, L, kernels.stream())
    return d_alpha


def cross_source_vw_bwd_plain(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor,
                              g_vw: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's backward: autograd of the plain forward."""
    with torch.enable_grad():
        a = alpha.detach().requires_grad_(True)
        vw = cross_source_vw_plain(t, mask, a)
        return torch.autograd.grad(vw, a, g_vw)[0]


class _CrossSourceVwOnCard(torch.autograd.Function):
    """K8 forward and backward under autograd (no gradient to t or mask)."""

    @staticmethod
    def forward(ctx, t, mask, alpha):
        vw, logt = cross_source_vw_fwd(t, mask, alpha, with_logt=True)
        ctx.save_for_backward(t, mask, alpha, logt)
        return vw

    @staticmethod
    def backward(ctx, g_vw):
        t, mask, alpha, logt = ctx.saved_tensors
        return None, None, cross_source_vw_bwd(t, mask, alpha, logt, g_vw.contiguous())


def cross_source_vw(t: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """K8 wrapper: the plain version on the CPU; on the card the forward
    kernel, under autograd (where alpha asks for a gradient) with the
    backward kernel beside it."""
    if t.device.type == "cpu":
        return cross_source_vw_plain(t, mask, alpha)
    if torch.is_grad_enabled() and alpha.requires_grad:
        return _CrossSourceVwOnCard.apply(t, mask, alpha)
    return cross_source_vw_fwd(t, mask, alpha)[0]
