"""Rigid transforms and quaternions (port of
neuralsim_tpu/maths/transforms.py:17-101, 102-145).

Transforms are 4x4 matrices acting on column vectors, ``x_world = T @ [x, 1]``,
batched over any leading dimensions. Scale is kept out of the 4x4 (a scene
node carries it apart), so the inverse is the closed form of a rotation and a
translation.

The products are written out as elementwise multiplies and adds in a fixed
order, not as ``einsum`` (a matrix product in another summation order on
each device): a ray turned into an object's frame is then the same float on
the card and on the CPU, and so are the sample positions the fields see
(:func:`norm3` likewise for a direction's length).

Quaternions are (w, x, y, z), batched over leading dimensions; they carry pose
refinement's rotation deltas and the rotation slerp of a timestamp between two
keyframes. Their clips are :func:`clip`, ``jnp.clip`` with its gradient.
"""
from __future__ import annotations

from typing import Optional

import torch


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) with ``jnp.clip``'s gradient: half of it at a tie
    (x == lo or x == hi), where ``torch.clamp`` passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(norm4(q), min=eps)[..., None]


def norm4(q: torch.Tensor) -> torch.Tensor:
    """|q| of [..., 4], its squares summed in order."""
    return torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]
                      + q[..., 3] * q[..., 3])


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (normalised first) -> rotation matrix [..., 3, 3]."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] with w >= 0: the
    four candidates, the one of the largest pivot taken (JAX's branchless
    form)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)                   # [..., 4, 4]
    pivots = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                          1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q, eps)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two [..., 4] quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t, eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation from q0 to q1 at ``t`` (broadcast; a weight
    without the last axis gets one), the shorter way round; the lerp where the
    two are nearly parallel (sin theta < eps)."""
    q0, q1 = quat_normalize(q0), quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(clip(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() < dot.dim():
        t = t[..., None]
    use_lerp = sin_theta < eps
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return a + (b - a) * t


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
