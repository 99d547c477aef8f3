"""Coordinate embedders: the sinusoidal positional encoding and real spherical
harmonics up to degree 4 (port of neuralsim_tpu/fields/embedders.py:15-43,
56-101; the SH basis is Instant-NGP's)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

def sinusoidal_embedder(n_freqs: int, input_dim: int = 3, include_input: bool = True
                        ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """NeRF positional encoding [x, sin(2^k x), cos(2^k x), ...] with
    frequencies 2^0 .. 2^(n_freqs-1), in the JAX package's channel order
    (frequency, then sin/cos, then input dimension). -> (embed, out_dim)."""
    if n_freqs == 0:
        return (lambda x: x), input_dim
    out_dim = 2 * n_freqs * input_dim + (input_dim if include_input else 0)

    def embed(x: torch.Tensor) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
        xb = x[..., None, :] * freqs[:, None]                       # [..., F, D]
        enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)   # [..., F, 2, D]
        enc = enc.reshape(x.shape[:-1] + (2 * n_freqs * x.shape[-1],))
        return torch.cat([x, enc], dim=-1) if include_input else enc

    return embed, out_dim


_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def spherical_harmonics(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions [..., 3] -> SH basis [..., degree**2]."""
    if not 1 <= degree <= 4:
        raise NotImplementedError(f"SH degree {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        out += [_C3[0] * y * (3 * xx - yy),
                _C3[1] * xy * z,
                _C3[2] * y * (4 * zz - xx - yy),
                _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _C3[4] * x * (4 * zz - xx - yy),
                _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def sh_embedder(degree: int = 4) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    return (lambda d: spherical_harmonics(d, degree)), degree * degree
