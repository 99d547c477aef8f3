"""The per-point lookup of instance latents (kernel K13) and its backward.

Port of the take in neuralsim_tpu/fields/conditional.py (``_cond_feats``,
line 281, and ``_lattice_input``, line 134): ``jnp.take(latents, bidx,
axis=0, mode="clip")``. Row p of the result is the latent of instance
``clamp(idx[p // per], 0, n - 1)``: ``idx`` gives one index a point
(``per`` 1), or one a ray for its ``per`` samples (the renderer's per-ray
index, never expanded to the samples), or is None (instance 0 everywhere).

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches the CUDA kernel (``csrc/latent_take.cu``) for CUDA tensors;
:class:`LatentTake` is the autograd Function of the conditional fields. The
backward is one launch: it sums the cotangent's rows by instance in an order
fixed by the shapes (the same bits on every call) and reads the cotangent
with its row stride.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

K13 = kernels.register("latent_take", "neuralsim_torch/csrc/latent_take.cu",
                       "neuralsim_tpu/fields/conditional.py:281")
K13_BWD = kernels.register("latent_take.bwd", "neuralsim_torch/csrc/latent_take.cu",
                           "neuralsim_tpu/fields/conditional.py:281")

# the backward kernel's blocks at most, per SM (the rows of its scratch)
BWD_BLOCKS_PER_SM = 2
# the backward's warps keep their sums, 8 x n x z floats a block, in shared
# memory up to this n x z (96 KB): the same bits on every call. Past it the
# kernel adds into the zeroed d latents with device atomics (a memset and the
# kernel; the last bits vary from call to call)
BWD_ORDERED_MAX_NZ = 3072

def _per(idx: Optional[torch.Tensor], n_points: int) -> int:
    """Points per index: 1 per point, S per ray of S samples."""
    if idx is None:
        return 1
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("latent_take: idx must be a 1-D int32 or int64 tensor")
    if idx.numel() == n_points:
        return 1
    if idx.numel() == 0 or n_points % idx.numel():
        raise ValueError(f"latent_take: {n_points} points are no multiple of "
                         f"{idx.numel()} indices")
    return n_points // idx.numel()


def point_rows(idx: Optional[torch.Tensor], n_points: int, n: int,
                device: torch.device) -> torch.Tensor:
    """The clamped instance of each point, int64 [n_points]."""
    if idx is None:
        return torch.zeros(n_points, dtype=torch.long, device=device)
    per = _per(idx, n_points)
    k = torch.clamp(idx.long(), 0, n - 1)
    return k if per == 1 else k[:, None].expand(idx.numel(), per).reshape(-1)


def latent_take_plain(latents: torch.Tensor, idx: Optional[torch.Tensor],
                      n_points: int) -> torch.Tensor:
    """Plain version of K13: ``latents[clamp(idx)]`` -> [n_points, z]."""
    return latents[point_rows(idx, n_points, latents.shape[0], latents.device)]


def latent_take_bwd_plain(d_out: torch.Tensor, idx: Optional[torch.Tensor],
                          n_instances: int) -> torch.Tensor:
    """Plain version of K13's backward: autograd of the plain forward (a
    sort-based ``index_put`` accumulation) -> d latents [n_instances, z]."""
    with torch.enable_grad():
        lat = d_out.new_zeros((n_instances, d_out.shape[1])).requires_grad_(True)
        return torch.autograd.grad(latent_take_plain(lat, idx, d_out.shape[0]), lat, d_out)[0]


def _is64(idx: Optional[torch.Tensor]) -> int:
    return int(idx is not None and idx.dtype == torch.int64)


def _check(name: str, idx: Optional[torch.Tensor], dev: torch.device) -> None:
    if idx is not None:
        kernels.check_cuda(name, idx)
        if idx.device != dev:
            raise ValueError(f"{name}: idx on {idx.device}, the latents on {dev}")


def latent_take(latents: torch.Tensor, idx: Optional[torch.Tensor],
                n_points: int) -> torch.Tensor:
    """K13 wrapper: the plain version on the CPU, the CUDA kernel on the card.
    latents [n, z] float32 (1 <= z <= 256); idx None, [n_points] or
    [n_points / S] int32 or int64 -> [n_points, z] float32."""
    if latents.device.type == "cpu":
        return latent_take_plain(latents, idx, n_points)
    kernels.check_cuda("latent_take", latents)
    _check("latent_take", idx, latents.device)
    if latents.dtype != torch.float32 or latents.dim() != 2 or not 1 <= latents.shape[1] <= 256:
        raise ValueError("latent_take: latents must be float32 [n, z <= 256]")
    n, z = latents.shape
    out = torch.empty((n_points, z), dtype=torch.float32, device=latents.device)
    K13.launch("latent_take_fwd", kernels.ptr(latents), kernels.ptr(idx), kernels.ptr(out),
               n_points, z, n, _per(idx, n_points), _is64(idx), kernels.stream())
    return out


def latent_take_bwd(d_out: torch.Tensor, idx: Optional[torch.Tensor],
                    n_instances: int) -> torch.Tensor:
    """K13 backward wrapper: d latents [n_instances, z] = the rows of d_out
    [P, z] summed by instance. The card reads d_out with its row stride (its
    columns must be adjacent), in one launch where n_instances x z <=
    BWD_ORDERED_MAX_NZ; the plain version on the CPU."""
    if d_out.device.type == "cpu":
        return latent_take_bwd_plain(d_out, idx, n_instances)
    _check("latent_take_bwd", idx, d_out.device)
    if d_out.dtype != torch.float32 or d_out.dim() != 2 or not 1 <= d_out.shape[1] <= 256:
        raise ValueError("latent_take_bwd: d_out must be float32 [P, z <= 256]")
    if d_out.stride(1) != 1 or d_out.stride(0) < d_out.shape[1]:
        d_out = d_out.contiguous()
    P, z = d_out.shape
    dev = d_out.device
    d_lat = torch.empty((n_instances, z), dtype=torch.float32, device=dev)
    scratch = torch.empty((BWD_BLOCKS_PER_SM * kernels.sm_count(dev.index), n_instances * z),
                          dtype=torch.float32, device=dev)
    K13_BWD.launch("latent_take_bwd", kernels.ptr(d_out), kernels.ptr(idx), kernels.ptr(d_lat),
                   kernels.ptr(scratch), kernels.ptr(kernels.ticket(dev, 1)), scratch.shape[0], P,
                   d_out.stride(0), z, n_instances, _per(idx, P), _is64(idx), kernels.stream())
    return d_lat


class LatentTake(torch.autograd.Function):
    """``latent_take`` under autograd: K13 and its backward on the card, the
    plain versions on the CPU. apply(latents [n, z], idx, n_points)."""

    @staticmethod
    def forward(ctx, latents, idx, n_points):
        ctx.save_for_backward(idx)
        ctx.n_instances = latents.shape[0]
        return latent_take(latents, idx, n_points)

    @staticmethod
    def backward(ctx, d_out):
        idx, = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return latent_take_bwd(d_out, idx, ctx.n_instances), None, None
