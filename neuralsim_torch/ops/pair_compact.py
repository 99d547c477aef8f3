"""The pair-budget compaction of a shared model's group of instances (K11;
port of neuralsim_tpu/renderers/buffer_compose.py:181-207 and 291-320).

Of the K x N (instance, ray) pairs of a group, the hit pairs are served
round-robin across the instances up to a budget of Bg rows: the j-th hit of
instance k sorts with key ``j * K + k``, every miss with ``K * N``, and the
first Bg of a stable sort are the rows (misses fill the budget when there are
fewer hits). On the training path each selected hit also gets its slot among
the ``M = max_hits_per_ray`` lanes of its ray, in selection order; the slot M
and beyond, and every miss, go to the sink ``N * M``, which the caller's
scatter drops (a ray crossing more than M boxes loses its later hits, as in
the JAX package).

``pair_compact`` is the kernel on the card (``csrc/pair_compact.cu``, a
closed-form place per pair in place of the sort, one launch of a thread-block
cluster: :func:`pair_cluster_layout` says how the rays are split over it) and
the plain version on the CPU, which runs the JAX package's own lines: an
``argsort`` of the keys, and for the slots an ``argsort`` of the rows' rays
and a ``searchsorted``. Both return indices only; gradients flow through the
values gathered and scattered with them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

K11 = kernels.register("pair_compact", "neuralsim_torch/csrc/pair_compact.cu",
                       "neuralsim_tpu/renderers/buffer_compose.py:181")


# the kernel's cluster: at most PAIR_CLUSTER_MAX CTAs (past the portable 8:
# an H100 schedules 16), a CTA's shared memory at most PAIR_COMPACT_SMEM bytes
# (an H100 block's opt-in)
PAIR_CLUSTER_MAX = 16
PAIR_COMPACT_SMEM = 232_448


def pair_cluster_layout(K: int, N: int) -> Tuple[int, int, int]:
    """K11's split of the rays over its cluster, as ``csrc/pair_compact.cu``
    computes it: words of 32 rays, WC consecutive words of every instance a
    CTA, C CTAs (C = 1 where N <= 32), and the bytes of a CTA's shared
    memory (a ballot word and a count an (instance, word) of its tile, and
    4 K + 1 ints) -> (C, WC, bytes)."""
    n_words = (N + 31) // 32
    wc = -(-n_words // min(n_words, PAIR_CLUSTER_MAX))
    return -(-n_words // wc), wc, (2 * K * wc + 4 * K + 1) * 4


def pair_budget(K: int, N: int, frac: float) -> int:
    """The group's rows: ``max(min(K N, round(N frac)), 1)`` (Python's round)."""
    return max(min(K * N, int(round(N * frac))), 1)


def pair_compact_plain(hit: torch.Tensor, Bg: int, M: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K11. hit: [K, N] bool -> (order [Bg] int64, the
    selected pairs as flat indices ``k * N + r``; hit_c [Bg] bool; with ``M``,
    slot_idx [Bg] int64: ``r * M + slot`` of each selected hit, the sink
    ``N * M`` for the rest)."""
    K, N = hit.shape
    dev = hit.device
    rank = torch.cumsum(hit.to(torch.int64), dim=1) - 1
    keyv = torch.where(hit, rank * K + torch.arange(K, device=dev)[:, None],
                       torch.full_like(rank, K * N)).reshape(-1)
    order = torch.argsort(keyv, stable=True)[:Bg]
    hit_c = keyv[order] < K * N
    if M is None:
        return order, hit_c, None
    r_for_slot = torch.where(hit_c, order % N, torch.full_like(order, N))
    perm = torch.argsort(r_for_slot, stable=True)
    r_s = r_for_slot[perm]
    slot = torch.arange(Bg, device=dev) - torch.searchsorted(r_s, r_s, side="left")
    flat = torch.where((r_s < N) & (slot < M), r_s * M + slot, torch.full_like(r_s, N * M))
    slot_idx = torch.empty_like(flat)
    slot_idx[perm] = flat
    return order, hit_c, slot_idx


def pair_compact(hit: torch.Tensor, Bg: int, M: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K11 wrapper: the plain version on the CPU, the CUDA kernel on the card."""
    if hit.device.type == "cpu":
        return pair_compact_plain(hit, Bg, M)
    if hit.dim() != 2 or hit.dtype != torch.bool:
        raise ValueError(f"pair_compact: hit must be [K, N] bool, got {tuple(hit.shape)} "
                         f"{hit.dtype}")
    K, N = hit.shape
    if not 1 <= Bg <= K * N or (M is not None and M < 1) or K > 4096:
        raise ValueError(f"pair_compact: Bg {Bg} must lie in [1, K N] and M >= 1, K <= 4096")
    smem = pair_cluster_layout(K, N)[2]
    if smem > PAIR_COMPACT_SMEM:
        raise ValueError(f"pair_compact: hit [{K}, {N}] needs {smem} bytes of shared memory a "
                         f"CTA, past PAIR_COMPACT_SMEM ({PAIR_COMPACT_SMEM})")
    hit = hit.contiguous()
    kernels.check_cuda("pair_compact", hit)
    dev = hit.device
    order = torch.empty((Bg,), dtype=torch.int64, device=dev)
    hit_c = torch.empty((Bg,), dtype=torch.bool, device=dev)
    slot_idx = None if M is None else torch.empty((Bg,), dtype=torch.int64, device=dev)
    K11.launch("pair_compact", kernels.ptr(hit), kernels.ptr(order), kernels.ptr(hit_c),
               kernels.ptr(slot_idx), K, N, Bg, 0 if M is None else M, kernels.stream())
    return order, hit_c, slot_idx
