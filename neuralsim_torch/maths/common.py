"""Small numeric helpers (port of neuralsim_tpu/maths/common.py:12-19, 26-53, 119-138)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalized_logistic_density(x: torch.Tensor, inv_s: float = 16.0) -> torch.Tensor:
    """Logistic density scaled to peak 1 at x = 0: 4 sigmoid(s x) sigmoid(-s x)
    (the sparsity loss on uniform SDF samples)."""
    sx = torch.sigmoid(x * inv_s)
    return 4.0 * sx * (1.0 - sx)


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with ``eps**2`` inside the square root, so a zero or subnormal
    vector has a finite norm and a finite gradient. The eps form is kept as in
    the JAX package, although CUDA keeps denormals."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps * eps)


def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / safe_norm(x)."""
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)


CHAMFER_CHUNK = 4096


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, trim_quantile: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chamfer distance between the point sets ``a`` [N, 3] and ``b`` [M, 3]
    on their device: (mean over ``a`` of the distance to the nearest point of
    ``b``, the same from ``b`` to ``a``), nearest points found CHAMFER_CHUNK
    rows at a time. With ``trim_quantile`` q each direction keeps the distances at
    most its q-quantile (linear interpolation, as ``jnp.quantile``) and
    averages over the kept ones that are > 0 (the LiDAR evaluation's 99, 97
    and 95% trims)."""
    def nn_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.sqrt(torch.min(torch.sum((x[s:s + CHAMFER_CHUNK, None, :]
                                                          - y[None]) ** 2, dim=-1),
                                               dim=-1).values)
                          for s in range(0, x.shape[0], CHAMFER_CHUNK)])

    d_ab, d_ba = nn_dist(a, b), nn_dist(b, a)
    if trim_quantile is None:
        return d_ab.mean(), d_ba.mean()
    out = []
    for d in (d_ab, d_ba):
        kept = torch.where(d <= torch.quantile(d, trim_quantile), d, torch.zeros_like(d))
        out.append(kept.sum() / ((kept > 0).sum() + 1e-9))
    return out[0], out[1]
