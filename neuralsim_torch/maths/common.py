"""Small numeric helpers (port of neuralsim_tpu/maths/common.py:12-19, 119-138)."""
from __future__ import annotations

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
