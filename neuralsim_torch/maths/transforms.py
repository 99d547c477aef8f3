"""Rigid transforms (port of neuralsim_tpu/maths/transforms.py:102-145).

Transforms are 4x4 matrices acting on column vectors, ``x_world = T @ [x, 1]``,
batched over any leading dimensions. Scale is kept out of the 4x4 (a scene
node carries it apart), so the inverse is the closed form of a rotation and a
translation.

The products are written out as elementwise multiplies and adds in a fixed
order, not as ``einsum`` (a matrix product in another summation order on
each device): a ray turned into an object's frame is then the same float on
the card and on the CPU, and so are the sample positions the fields see
(:func:`norm3` likewise for a direction's length).
"""
from __future__ import annotations

from typing import Optional

import torch


def make_transform(R: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., 4, 4] from a rotation [..., 3, 3] and a translation [..., 3]."""
    if R is None and t is None:
        return torch.eye(4)
    ref = R if R is not None else t
    batch = R.shape[:-2] if R is not None else t.shape[:-1]
    T = torch.zeros(batch + (4, 4), dtype=ref.dtype, device=ref.device)
    T[..., :3, :3] = torch.eye(3, dtype=ref.dtype, device=ref.device) if R is None else R
    if t is not None:
        T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [..., 3, 3] @ v [..., 3], summed from the first column on."""
    return M[..., :, 0] * v[..., None, 0] + M[..., :, 1] * v[..., None, 1] \
        + M[..., :, 2] * v[..., None, 2]


def inverse_transform(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid [..., 4, 4]: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -_matvec(Rt, T[..., :3, 3]))


def compose_transforms(parent: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """world = parent @ child, broadcasting over batch dimensions."""
    out = parent[..., :, 0:1] * child[..., 0:1, :]
    for k in range(1, 4):
        out = out + parent[..., :, k:k + 1] * child[..., k:k + 1, :]
    return out


def apply_transform(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] applied to points [..., 3]."""
    return _matvec(T[..., :3, :3], x) + T[..., :3, 3]


def apply_rotation(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rotation part of [..., 4, 4] applied to directions [..., 3]."""
    return _matvec(T[..., :3, :3], v)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| of [..., 3], its squares summed in order (the same float on every
    device, unlike a reduction)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
