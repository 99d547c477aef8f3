"""LoTD ("Levels of Tensorial Decomposition") multi-resolution grid encoding.

Port of neuralsim_tpu/fields/encodings/lotd.py. All levels share one flat
float32 table with fixed per-level offsets, exactly the JAX layout, so a JAX
table copies over as is. Level types:

* ``cp``: d lines of [res, F]; features are the channelwise product of the
  per-axis linear interpolations. With two or more CP levels (the JAX default,
  "stacked CP") every level's lines are first resampled onto one grid of the
  largest CP resolution; the lookup is the ``lotd_cp_stacked`` kernel (K1).
  A single CP level, or any number under ``NEURALSIM_CP_STACKED=0`` (read
  when the encoding is built, as JAX does), takes the per-level path: each
  level's own lines straight from the table, all levels in one launch of the
  ``lotd_cp_level`` kernel (K2).
* ``dense`` / ``hash``: 8-corner trilinear gather from a [F, size] table
  segment, hashed with the Instant-NGP primes beyond the dense budget; the
  lookup is the ``lotd_grid`` kernel (K3).

The kernels also give the analytic jacobian d(features)/d(x01) that the NeuS
field turns into normals. Each kernel's wrapper below takes its plain PyTorch
version for tensors on the CPU and launches the kernel for CUDA tensors.

Training: the outputs carry gradients into ``table`` (the on-render eikonal
loss trains through the jacobian). On the CPU autograd differentiates the
plain versions; on the card one ``torch.autograd.Function`` runs the forward
kernels and, in its backward, the ``lotd_cp_stacked.bwd``,
``lotd_cp_level.bwd`` and ``lotd_grid.bwd`` kernels. No gradient goes to the
positions: rays are data and sample depths are detached in this slice (pose
refinement will add it).

Not ported yet: the batched ``bidx`` tables, 4-D inputs, the level anneal
window and ``NEURALSIM_CP_JAC_F32=1`` (float32 lines for the stacked
jacobian), which raises.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ... import kernels
from ...ops.gather import gather_cols

# Instant-NGP spatial-hash primes (Mueller et al. 2022).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF

K1 = kernels.register("lotd_cp_stacked", "neuralsim_torch/csrc/lotd_cp_stacked.cu",
                      "neuralsim_tpu/fields/encodings/lotd.py:346")
K3 = kernels.register("lotd_grid", "neuralsim_torch/csrc/lotd_grid.cu",
                      "neuralsim_tpu/fields/encodings/lotd.py:410")
K1_BWD = kernels.register("lotd_cp_stacked.bwd", "neuralsim_torch/csrc/lotd_cp_stacked.cu",
                          "neuralsim_tpu/fields/encodings/lotd.py:346")
K3_BWD = kernels.register("lotd_grid.bwd", "neuralsim_torch/csrc/lotd_grid.cu",
                          "neuralsim_tpu/fields/encodings/lotd.py:410")
K2 = kernels.register("lotd_cp_level", "neuralsim_torch/csrc/lotd_cp_level.cu",
                      "neuralsim_tpu/fields/encodings/lotd.py:250")
K2_BWD = kernels.register("lotd_cp_level.bwd", "neuralsim_torch/csrc/lotd_cp_level.cu",
                          "neuralsim_tpu/fields/encodings/lotd.py:250")

class LevelSpec:
    """Static per-level layout: resolution, feature width, type, rows, offset."""

    __slots__ = ("res", "n_feats", "typ", "size", "offset")

    def __init__(self, res: int, n_feats: int, typ: str, size: int, offset: int):
        self.res = res
        self.n_feats = n_feats
        self.typ = typ
        self.size = size
        self.offset = offset


def ngp_levels(n_levels: int = 16, n_feats: int = 2, log2_hashmap_size: int = 19,
               base_res: int = 16, max_res: int = 2048, input_dim: int = 3
               ) -> List[Tuple[int, int, str]]:
    """Instant-NGP geometric ladder: dense while the grid fits the hashmap."""
    b = math.exp((math.log(max_res) - math.log(base_res)) / (n_levels - 1)) \
        if n_levels > 1 else 1.0
    hashmap_size = 2 ** log2_hashmap_size
    out = []
    for l in range(n_levels):
        res = int(round(base_res * (b ** l)))
        out.append((res, n_feats,
                    "dense" if (res + 1) ** input_dim <= hashmap_size else "hash"))
    return out


def tpu_mixed_levels(n_levels: int = 8, *, base_res: int = 16, max_res: int = 2048,
                     n_feats: int = 4, n_hash_levels: int = 2,
                     log2_hashmap_size: int = 19, cp_max_res: int = 1024,
                     input_dim: int = 3) -> List[Tuple[int, int, str]]:
    """Mixed plan: small dense levels, CP levels through the middle
    resolutions, and the top ``n_hash_levels`` as hash levels."""
    b = math.exp((math.log(max_res) - math.log(base_res)) / (n_levels - 1)) \
        if n_levels > 1 else 1.0
    out = []
    for l in range(n_levels):
        res = int(round(base_res * (b ** l)))
        if (res + 1) ** input_dim <= 4096:
            out.append((res, n_feats, "dense"))
        elif l >= n_levels - n_hash_levels:
            out.append((res, n_feats, "hash"))
        else:
            out.append((min(res, cp_max_res), n_feats, "cp"))
    return out


# ---------------------------------------------------------------------------
# K1: stacked CP levels
# ---------------------------------------------------------------------------

def _tent(delta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - delta.abs(), min=0.0).to(torch.bfloat16).float()


def _tent_slope(delta: torch.Tensor) -> torch.Tensor:
    return torch.where(delta.abs() < 1.0, -torch.sign(delta), torch.zeros_like(delta))


class _RoundBf16(torch.autograd.Function):
    """x rounded to bf16, as float32; the gradient passes unrounded (a cast's
    own backward would round the gradient to bf16 as well)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def lotd_cp_stacked_plain(lines: torch.Tensor, pos01: torch.Tensor, rows: torch.Tensor,
                          out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """Plain version of K1. lines: [3, F, R] bf16 (or float32 values already
    rounded to bf16, when autograd is to reach them); pos01: [N, 3] float32.

    Writes stacked feature f to row ``rows[f]`` of ``out`` [C, N] and, given
    ``jac`` [3, C, N], its derivative along each axis of pos01. Only the two
    nonzero tent taps per axis are evaluated; bf16 tent weights and f32 sums
    give the JAX tent-matmul numbers.
    """
    R = lines.shape[-1]
    L = lines.float()                                       # [3, F, R]
    pos = pos01.clamp(0.0, 1.0).T * (R - 1)                 # [3, N]
    lo = torch.floor(pos).long().clamp(0, R - 2)
    d0 = pos - lo.float()
    d1 = pos - (lo + 1).float()
    w0, w1, s0, s1 = _tent(d0), _tent(d1), _tent_slope(d0), _tent_slope(d1)
    f_ax, g_ax = [], []
    for ax in range(3):
        a = L[ax][:, lo[ax]]                                # [F, N]
        b = L[ax][:, lo[ax] + 1]
        f_ax.append(a * w0[ax] + b * w1[ax])
        g_ax.append((a * s0[ax] + b * s1[ax]) * (R - 1))
    r = rows.long()
    out[r] = f_ax[0] * f_ax[1] * f_ax[2]
    if jac is not None:
        jac[0, r] = g_ax[0] * f_ax[1] * f_ax[2]
        jac[1, r] = g_ax[1] * f_ax[0] * f_ax[2]
        jac[2, r] = g_ax[2] * f_ax[0] * f_ax[1]


def _check_outputs(name: str, pos01: torch.Tensor, out: torch.Tensor,
                   jac: Optional[torch.Tensor]) -> None:
    if pos01.dtype != torch.float32 or pos01.dim() != 2 or pos01.shape[1] != 3:
        raise ValueError(f"{name}: pos01 must be [N, 3] float32")
    N = pos01.shape[0]
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != N:
        raise ValueError(f"{name}: out must be [C, N] float32")
    if jac is not None and (jac.dtype != torch.float32 or jac.shape != (3,) + out.shape):
        raise ValueError(f"{name}: jac must be [3, C, N] float32")


def lotd_cp_stacked(lines: torch.Tensor, pos01: torch.Tensor, rows: torch.Tensor,
                    out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """K1 wrapper: the plain version on the CPU, the CUDA kernel on the card.
    ``rows`` (int32 [F]) must index rows of ``out``."""
    if lines.device.type == "cpu":
        return lotd_cp_stacked_plain(lines, pos01, rows, out, jac)
    kernels.check_cuda("lotd_cp_stacked", lines, pos01, rows, out,
                       *([] if jac is None else [jac]))
    if lines.dtype != torch.bfloat16 or lines.dim() != 3 or lines.shape[0] != 3 \
            or lines.shape[2] < 2:
        raise ValueError(f"lotd_cp_stacked: lines must be [3, F, R >= 2] bf16, got "
                         f"{tuple(lines.shape)} {lines.dtype}")
    if rows.dtype != torch.int32 or rows.shape != (lines.shape[1],):
        raise ValueError("lotd_cp_stacked: rows must be int32 [F]")
    _check_outputs("lotd_cp_stacked", pos01, out, jac)
    K1.launch("lotd_cp_stacked_fwd", kernels.ptr(lines), kernels.ptr(pos01),
              kernels.ptr(rows), kernels.ptr(out), kernels.ptr(jac), pos01.shape[0],
              lines.shape[1], lines.shape[2], out.shape[0], kernels.stream())


def _cotangent_loss(out, jac, d_out, d_jac):
    loss = out.new_zeros(())
    if d_out is not None:
        loss = loss + (out * d_out).sum()
    if d_jac is not None:
        loss = loss + (jac * d_jac).sum()
    return loss


def _check_cotangents(name: str, pos01: torch.Tensor, d_out: Optional[torch.Tensor],
                      d_jac: Optional[torch.Tensor]) -> None:
    """d_out [C, N] and/or d_jac [3, C, N], float32, at least one of them."""
    if d_out is not None:
        _check_outputs(name, pos01, d_out, d_jac)
    elif d_jac is None or d_jac.dim() != 3 or d_jac.shape[0] != 3:
        raise ValueError(f"{name}: needs d_out [C, N] or d_jac [3, C, N]")
    else:
        _check_outputs(name, pos01, d_jac[0], None)


def lotd_cp_stacked_bwd_plain(lines: torch.Tensor, pos01: torch.Tensor, rows: torch.Tensor,
                              d_out: Optional[torch.Tensor],
                              d_jac: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of K1's backward: autograd of the plain forward. Returns
    d lines [3, F, R] float32 for cotangents d_out [C, N], d_jac [3, C, N]."""
    given = d_out if d_out is not None else d_jac
    with torch.enable_grad():
        L = lines.detach().float().requires_grad_(True)
        out = given.new_zeros(given.shape[-2:])
        jac = None if d_jac is None else torch.zeros_like(d_jac)
        lotd_cp_stacked_plain(L, pos01, rows, out, jac)
        return torch.autograd.grad(_cotangent_loss(out, jac, d_out, d_jac), L)[0]


def lotd_cp_stacked_bwd(lines: torch.Tensor, pos01: torch.Tensor, rows: torch.Tensor,
                        d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor]
                        ) -> torch.Tensor:
    """K1 backward wrapper: gradient of both outputs into the (bf16) lines,
    summed in float32 (float32 atomics on the card, so the last bits vary
    from run to run). Autograd of the plain version on the CPU, the CUDA
    kernel on the card, which sums into a [3, R, F] buffer (a point's
    features side by side, for float4 adds): the [3, F, R] result is its
    transposed view."""
    if lines.device.type == "cpu":
        return lotd_cp_stacked_bwd_plain(lines, pos01, rows, d_out, d_jac)
    given = [x for x in (d_out, d_jac) if x is not None]
    kernels.check_cuda("lotd_cp_stacked_bwd", lines, pos01, rows, *given)
    if lines.dtype != torch.bfloat16 or lines.dim() != 3 or lines.shape[0] != 3 \
            or lines.shape[2] < 2:
        raise ValueError("lotd_cp_stacked_bwd: lines must be [3, F, R >= 2] bf16")
    if rows.dtype != torch.int32 or rows.shape != (lines.shape[1],):
        raise ValueError("lotd_cp_stacked_bwd: rows must be int32 [F]")
    _check_cotangents("lotd_cp_stacked_bwd", pos01, d_out, d_jac)
    _, F, R = lines.shape
    d_lines = torch.zeros((3, R, F), dtype=torch.float32, device=lines.device)
    K1_BWD.launch("lotd_cp_stacked_bwd", kernels.ptr(lines), kernels.ptr(pos01),
                  kernels.ptr(rows), kernels.ptr(d_out), kernels.ptr(d_jac),
                  kernels.ptr(d_lines), pos01.shape[0], F, R, given[0].shape[-2],
                  kernels.stream())
    return d_lines.transpose(1, 2)


# ---------------------------------------------------------------------------
# K2: per-level CP levels
# ---------------------------------------------------------------------------

def lotd_cp_level_plain(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                        out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """Plain version of K2.

    table: the flat float32 LoTD table; pos01: [N, 3]; meta: int32 [L, 4]
    rows of (R, offset, F, out row). Each level's lines, the segment
    ``table[offset : offset + 3 R F]`` viewed as [3, R, F], are rounded to
    bf16 (the gradient passes unrounded), and the level's F features go to
    rows [out row, out row + F) of ``out`` [C, N] and, given ``jac``
    [3, C, N], their derivatives: K1's two-tap lerp at the level's own R,
    JAX's ``_cp_level_features``.
    """
    for R, offset, nf, row in meta.tolist():
        seg = table[offset:offset + 3 * R * nf].view(3, R, nf).transpose(1, 2)
        rows = torch.arange(row, row + nf, device=out.device)
        lotd_cp_stacked_plain(_RoundBf16.apply(seg), pos01, rows, out, jac)


def _check_k2(name: str, table: torch.Tensor, meta: torch.Tensor) -> None:
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError(f"{name}: table must be a flat float32 tensor")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 4 \
            or meta.shape[0] < 1:
        raise ValueError(f"{name}: meta must be int32 [L >= 1, 4]")


def lotd_cp_level(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                  out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """K2 wrapper: the plain version on the CPU, the CUDA kernel on the card.
    ``meta`` must describe levels (R >= 2) inside ``table`` and rows inside
    ``out``."""
    if table.device.type == "cpu":
        return lotd_cp_level_plain(table, pos01, meta, out, jac)
    kernels.check_cuda("lotd_cp_level", table, pos01, meta, out,
                       *([] if jac is None else [jac]))
    _check_k2("lotd_cp_level", table, meta)
    _check_outputs("lotd_cp_level", pos01, out, jac)
    K2.launch("lotd_cp_level_fwd", kernels.ptr(table), kernels.ptr(pos01), kernels.ptr(meta),
              kernels.ptr(out), kernels.ptr(jac), pos01.shape[0], meta.shape[0],
              out.shape[0], kernels.stream())


def lotd_cp_level_bwd_plain(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                            d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor],
                            d_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2's backward: autograd of the plain forward. Returns
    the gradient [n_table] float32 (added to ``d_table`` when given), zero
    outside the levels' segments."""
    given = d_out if d_out is not None else d_jac
    with torch.enable_grad():
        src = table.detach().requires_grad_(True)
        out = given.new_zeros(given.shape[-2:])
        jac = None if d_jac is None else torch.zeros_like(d_jac)
        lotd_cp_level_plain(src, pos01, meta, out, jac)
        g = torch.autograd.grad(_cotangent_loss(out, jac, d_out, d_jac), src)[0]
    return g if d_table is None else d_table.add_(g)


def lotd_cp_level_bwd(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                      d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor],
                      d_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 backward wrapper: the gradient of both outputs into the levels'
    (bf16-read) lines, summed in float32 and added to ``d_table`` (a zeroed
    float32 buffer of the table's size when not given), which it returns.
    Autograd of the plain version on the CPU, the CUDA kernel on the card
    (float32 atomics, so the last bits vary from run to run)."""
    if table.device.type == "cpu":
        return lotd_cp_level_bwd_plain(table, pos01, meta, d_out, d_jac, d_table)
    given = [x for x in (d_out, d_jac) if x is not None]
    if d_table is None:
        d_table = torch.zeros_like(table)
    kernels.check_cuda("lotd_cp_level_bwd", table, pos01, meta, d_table, *given)
    _check_k2("lotd_cp_level_bwd", table, meta)
    if d_table.shape != table.shape or d_table.dtype != torch.float32:
        raise ValueError("lotd_cp_level_bwd: d_table must be float32 of the table's shape")
    _check_cotangents("lotd_cp_level_bwd", pos01, d_out, d_jac)
    K2_BWD.launch("lotd_cp_level_bwd", kernels.ptr(table), kernels.ptr(pos01),
                  kernels.ptr(meta), kernels.ptr(d_out), kernels.ptr(d_jac),
                  kernels.ptr(d_table), pos01.shape[0], meta.shape[0], given[0].shape[-2],
                  kernels.stream())
    return d_table


# ---------------------------------------------------------------------------
# K3: dense / hash levels
# ---------------------------------------------------------------------------

def _corner_rows(cell: torch.Tensor, bits: Sequence[int], res: int, size: int,
                 is_hash: bool) -> torch.Tensor:
    if is_hash:
        h = None
        for i, b in enumerate(bits):
            term = ((cell[i] + b) * _PRIMES[i]) & _U32
            h = term if h is None else h ^ term
        return h % size
    rows = None
    for i, b in enumerate(bits):
        term = (cell[i] + b) * ((res + 1) ** i)
        rows = term if rows is None else rows + term
    return rows


def lotd_grid_plain(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                    out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """Plain version of K3.

    table: flat float32 LoTD table; pos01: [N, 3]; meta: int32 [L, 6] rows of
    (res, size, offset, F, is_hash, out row). Writes each level's F features
    to rows [out row, out row + F) of ``out`` [C, N] and, given ``jac``
    [3, C, N], their derivatives. The hash runs in int64 masked to 32 bits
    after each multiply (JAX's uint32 wrap-around).
    """
    x = pos01.clamp(0.0, 1.0).T                                  # [3, N]
    for res, size, offset, nf, is_hash, row in meta.tolist():
        tbl = table[offset:offset + nf * size].view(nf, size)
        pos = x * res
        cellf = torch.clamp(torch.floor(pos), max=res - 1)
        frac = pos - cellf
        cell = cellf.long()
        acc = None
        jl = [None, None, None]
        for corner in range(8):
            bits = [(corner >> i) & 1 for i in range(3)]
            aw = [frac[i] if b else 1.0 - frac[i] for i, b in enumerate(bits)]
            w = aw[0] * aw[1] * aw[2]
            f = gather_cols(tbl, _corner_rows(cell, bits, res, size, bool(is_hash)))
            term = w * f
            acc = term if acc is None else acc + term
            if jac is not None:
                for i in range(3):
                    dw = (1.0 if bits[i] else -1.0)
                    for j in range(3):
                        if j != i:
                            dw = dw * aw[j]
                    contrib = dw * f
                    jl[i] = contrib if jl[i] is None else jl[i] + contrib
        out[row:row + nf] = acc
        if jac is not None:
            jac[:, row:row + nf] = torch.stack(jl, dim=0) * res


def lotd_grid(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
              out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """K3 wrapper: the plain version on the CPU, the CUDA kernel on the card.
    ``meta`` must describe levels inside ``table`` and rows inside ``out``."""
    if table.device.type == "cpu":
        return lotd_grid_plain(table, pos01, meta, out, jac)
    kernels.check_cuda("lotd_grid", table, pos01, meta, out, *([] if jac is None else [jac]))
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("lotd_grid: table must be a flat float32 tensor")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 6:
        raise ValueError("lotd_grid: meta must be int32 [L, 6]")
    _check_outputs("lotd_grid", pos01, out, jac)
    K3.launch("lotd_grid_fwd", kernels.ptr(table), kernels.ptr(pos01), kernels.ptr(meta),
              kernels.ptr(out), kernels.ptr(jac), pos01.shape[0], out.shape[0],
              meta.shape[0], kernels.stream())


def lotd_grid_bwd_plain(n_table: int, pos01: torch.Tensor, meta: torch.Tensor,
                        d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor]
                        ) -> torch.Tensor:
    """Plain version of K3's backward: autograd of the plain forward (which is
    linear in the table). Returns d table [n_table] float32."""
    given = d_out if d_out is not None else d_jac
    with torch.enable_grad():
        table = given.new_zeros(n_table).requires_grad_(True)
        out = given.new_zeros(given.shape[-2:])
        jac = None if d_jac is None else torch.zeros_like(d_jac)
        lotd_grid_plain(table, pos01, meta, out, jac)
        return torch.autograd.grad(_cotangent_loss(out, jac, d_out, d_jac), table)[0]


# K3's backward sums the dense levels that fit this budget together in each
# block's shared memory, and the rest with device atomics (csrc/lotd_grid.cu).
GRID_BWD_SMEM_BUDGET = 96 * 1024
# ... in a launch of at least this many points a private float. Below it the
# private copies cost more than they save: they are zeroed, stored and summed
# by block, and a shared float add is slower than a device one where rows are
# seldom shared. scripts/torch_kernel_ab.py times both ways on the vehicles'
# 13,892 private floats: atomics were faster at 512 and 32,768 points (2.4 a
# float), the private copies at 196,608 (14 a float). The crossover between is
# not timed; any value from 2.4 to 14 sends the main path's launches (512 and
# 196,608 points) the same ways.
GRID_BWD_PRIVATE_MIN_POINTS = 8


class GridBwdPlan(NamedTuple):
    """The levels that K3's backward sums in shared memory: bit l of
    ``private_mask`` for row l of the meta; ``n_private``, their floats (one
    block's copy, a row of the scratch)."""
    private_mask: int
    n_private: int

    def at(self, n_points: int) -> "GridBwdPlan":
        """The plan of a launch of ``n_points``: private levels only where the
        launch has GRID_BWD_PRIVATE_MIN_POINTS points a private float."""
        if n_points >= GRID_BWD_PRIVATE_MIN_POINTS * self.n_private:
            return self
        return GridBwdPlan(0, 0)


def grid_bwd_plan(meta_rows: Sequence[Sequence[int]]) -> GridBwdPlan:
    """Split K3's levels, rows of (res, size, offset, F, is_hash, out row),
    into private ones, the dense levels taken in level order while their F x
    size floats fit GRID_BWD_SMEM_BUDGET together, and global ones: the hash
    levels (fine cells whose rows the hash scatters, so that neighbouring
    samples rarely share one) and the dense levels past the budget."""
    mask, used = 0, 0
    for l, (_, size, _, nf, is_hash, _) in enumerate(meta_rows):
        if not is_hash and l < 31 and (used + nf * size) * 4 <= GRID_BWD_SMEM_BUDGET:
            mask |= 1 << l
            used += nf * size
    return GridBwdPlan(mask, used)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """The scratch's rows, read once a device: the wrapper's host time counts
    in every training step, and every training path is host-bound."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def lotd_grid_bwd(n_table: int, pos01: torch.Tensor, meta: torch.Tensor,
                  d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor],
                  plan: Optional[GridBwdPlan] = None) -> torch.Tensor:
    """K3 backward wrapper: scatter-add of both cotangents into a zeroed table
    of ``n_table`` floats (float32 atomics on the card, so the last bits vary
    from run to run). ``meta`` must describe levels inside the table.
    ``plan``: the levels to sum in shared memory, used as given; without it,
    ``grid_bwd_plan(meta).at(N)`` (the meta read back to the host). A plan
    made from another meta costs speed, not correctness: the kernel sums a
    named level in shared memory only where it fits ``n_private``."""
    if pos01.device.type == "cpu":
        return lotd_grid_bwd_plain(n_table, pos01, meta, d_out, d_jac)
    given = [x for x in (d_out, d_jac) if x is not None]
    kernels.check_cuda("lotd_grid_bwd", pos01, meta, *given)
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 6:
        raise ValueError("lotd_grid_bwd: meta must be int32 [L, 6]")
    _check_cotangents("lotd_grid_bwd", pos01, d_out, d_jac)
    N = pos01.shape[0]
    if plan is None:
        plan = grid_bwd_plan(meta.tolist()).at(N)
    if plan.private_mask >> meta.shape[0]:
        raise ValueError("lotd_grid_bwd: the plan names a level past the meta")
    # a row of the scratch for each block of the persistent grid, one a SM
    scratch = torch.empty((_sm_count(pos01.device.index), plan.n_private), dtype=torch.float32,
                          device=pos01.device) if plan.n_private else None
    d_table = torch.zeros(n_table, dtype=torch.float32, device=pos01.device)
    K3_BWD.launch("lotd_grid_bwd", kernels.ptr(pos01), kernels.ptr(meta), kernels.ptr(d_out),
                  kernels.ptr(d_jac), kernels.ptr(d_table), kernels.ptr(scratch), N,
                  given[0].shape[-2], meta.shape[0], plan.private_mask, plan.n_private,
                  kernels.stream())
    return d_table


# ---------------------------------------------------------------------------
# The encoding
# ---------------------------------------------------------------------------

class _EncodeOnCard(torch.autograd.Function):
    """K1 (stacked CP), K2 (per-level CP) and K3 forward into one
    feature-major buffer; their backwards into the float32 stacked lines and
    the table. The stacked lines are rounded to bf16 here, inside, and K2
    rounds the table's CP segments as it reads them, so their gradients come
    back unrounded."""

    @staticmethod
    def forward(ctx, lines, table, xf, cp_rows, cp_meta, grid_meta, grid_plan, out_dim,
                with_jac):
        N = xf.shape[0]
        out = torch.empty((out_dim, N), dtype=torch.float32, device=xf.device)
        jac = torch.empty((3, out_dim, N), dtype=torch.float32, device=xf.device) \
            if with_jac else None
        lines_bf16 = None
        if lines is not None:
            lines_bf16 = lines.to(torch.bfloat16)
            lotd_cp_stacked(lines_bf16, xf, cp_rows, out, jac)
        if cp_meta.shape[0]:
            lotd_cp_level(table, xf, cp_meta, out, jac)
        if grid_meta.shape[0]:
            lotd_grid(table, xf, grid_meta, out, jac)
        ctx.save_for_backward(lines_bf16, table, xf, cp_rows, cp_meta, grid_meta)
        ctx.grid_plan = grid_plan
        ctx.set_materialize_grads(False)
        return out, jac

    @staticmethod
    def backward(ctx, d_out, d_jac):
        lines_bf16, table, xf, cp_rows, cp_meta, grid_meta = ctx.saved_tensors
        d_out = None if d_out is None else d_out.contiguous()
        d_jac = None if d_jac is None else d_jac.contiguous()
        d_lines = d_table = None
        if d_out is None and d_jac is None:
            return (None,) * 9
        if lines_bf16 is not None and ctx.needs_input_grad[0]:
            d_lines = lotd_cp_stacked_bwd(lines_bf16, xf, cp_rows, d_out, d_jac)
        if ctx.needs_input_grad[1]:
            if grid_meta.shape[0]:
                d_table = lotd_grid_bwd(table.numel(), xf, grid_meta, d_out, d_jac,
                                        ctx.grid_plan.at(xf.shape[0]))
            if cp_meta.shape[0]:
                d_table = lotd_cp_level_bwd(table, xf, cp_meta, d_out, d_jac, d_table)
        return d_lines, d_table, None, None, None, None, None, None, None


class LoTDEncoding(nn.Module):
    """Multi-level grid encoding over inputs in [0, 1]^3.

    levels: sequence of (resolution, n_feats, 'dense'|'hash'|'cp').
    Parameter: ``table``, the flat float32 table of every level.
    ``cp_stacked``: two or more CP levels take the stacked path (K1);
    ``NEURALSIM_CP_STACKED``, where set, decides instead ("1" stacked, any
    other value per-level, K2), as in the JAX constructor (lotd.py:169-173).
    """

    def __init__(self, levels: Sequence[Tuple[int, int, str]], input_dim: int = 3,
                 log2_hashmap_size: int = 19, param_init_scale: float = 1e-4,
                 cp_stacked: bool = True):
        super().__init__()
        if input_dim != 3:
            raise NotImplementedError("the port's LoTD takes 3-D inputs only")
        self.input_dim = input_dim
        self.param_init_scale = param_init_scale
        hashmap_size = 2 ** log2_hashmap_size
        self.specs: List[LevelSpec] = []
        offset = 0
        for (res, nf, typ) in levels:
            if typ == "cp":
                size = input_dim * res
                self.specs.append(LevelSpec(res, nf, "cp", size, offset))
            else:
                dense_size = (res + 1) ** input_dim
                is_dense = typ == "dense" or dense_size <= hashmap_size
                size = dense_size if is_dense else hashmap_size
                self.specs.append(LevelSpec(res, nf, "dense" if is_dense else "hash",
                                            size, offset))
            offset += size * nf
        self.total_params = offset
        self.out_dim = sum(s.n_feats for s in self.specs)
        self.n_levels = len(self.specs)
        self.table = nn.Parameter(torch.zeros(self.total_params))

        self.cp_spec_ids = [li for li, s in enumerate(self.specs) if s.typ == "cp"]
        self.grid_spec_ids = [li for li, s in enumerate(self.specs) if s.typ != "cp"]
        env = os.environ.get("NEURALSIM_CP_STACKED")
        if env is not None:
            cp_stacked = env == "1"
        self.cp_stacked = bool(cp_stacked) and len(self.cp_spec_ids) >= 2
        self.cp_rmax = max((self.specs[li].res for li in self.cp_spec_ids), default=0)
        self.cp_out_dim = sum(self.specs[li].n_feats for li in self.cp_spec_ids)
        if any(self.specs[li].res < 2 for li in self.cp_spec_ids) and not self.cp_stacked:
            raise ValueError("a per-level CP level needs R >= 2")
        # stacked-CP plan: each CP level's lines resampled onto the largest
        # CP resolution by a static two-tap lerp (same float64 plan as JAX)
        for k, li in enumerate(self.cp_spec_ids if self.cp_stacked else ()):
            R = self.specs[li].res
            posc = np.linspace(0.0, 1.0, self.cp_rmax) * (R - 1)
            lo = np.minimum(np.floor(posc).astype(np.int64), max(R - 2, 0))
            w = (posc - lo).astype(np.float32)
            self.register_buffer(f"_cp_lo{k}", torch.from_numpy(lo), persistent=False)
            self.register_buffer(f"_cp_w{k}", torch.from_numpy(w), persistent=False)

        # the kernels write straight into the feature-major output [out_dim, N]
        # in level order: the first row of each level, the rows of every
        # stacked-CP feature, the K2 metadata (R, offset, F, first row) of
        # each per-level CP level, and the K3 metadata (res, size, offset, F,
        # is_hash, first row) of each gather level
        first_row = np.cumsum([0] + [s.n_feats for s in self.specs])[:-1].tolist()
        cp_rows = [first_row[li] + f for li in self.cp_spec_ids
                   for f in range(self.specs[li].n_feats)]
        self.register_buffer("_cp_rows", torch.tensor(cp_rows, dtype=torch.int32),
                             persistent=False)
        cp_meta = [] if self.cp_stacked else [
            (self.specs[li].res, self.specs[li].offset, self.specs[li].n_feats, first_row[li])
            for li in self.cp_spec_ids]
        self.register_buffer("_cp_meta", torch.tensor(cp_meta, dtype=torch.int32)
                             .reshape(-1, 4), persistent=False)
        meta = []
        for li in self.grid_spec_ids:
            s = self.specs[li]
            meta.append((s.res, s.size, s.offset, s.n_feats, int(s.typ == "hash"),
                         first_row[li]))
        self.register_buffer("_grid_meta", torch.tensor(meta, dtype=torch.int32)
                             .reshape(-1, 6), persistent=False)
        self.grid_bwd_plan = grid_bwd_plan(meta)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX init in distribution: U(-1, 1) * scale, CP lines near +1."""
        t = torch.rand(self.total_params, generator=generator) * 2.0 - 1.0
        t = t * self.param_init_scale
        for s in self.specs:
            if s.typ == "cp":
                seg = slice(s.offset, s.offset + s.size * s.n_feats)
                t[seg] = t[seg] / self.param_init_scale * 0.1 + 1.0
        self.table.copy_(t)

    def cp_stacked_lines(self) -> torch.Tensor:
        """Resample every CP level's lines onto the R_max grid and stack them
        along features -> [3, F_cp, R_max] float32 (plain torch; it depends on
        the parameters only)."""
        cols = []
        for k, li in enumerate(self.cp_spec_ids):
            s = self.specs[li]
            seg = self.table[s.offset:s.offset + s.size * s.n_feats].view(3, s.res, s.n_feats)
            lo = getattr(self, f"_cp_lo{k}")
            w = getattr(self, f"_cp_w{k}")[:, None]
            l0 = seg[:, lo]
            l1 = seg[:, torch.clamp(lo + 1, max=s.res - 1)]
            cols.append(l0 * (1.0 - w) + l1 * w)
        return torch.cat(cols, dim=-1).transpose(1, 2).contiguous()

    def kernel_lines(self) -> Optional[torch.Tensor]:
        """The float32 stacked lines behind K1 (which rounds them to bf16),
        or None without stacked CP levels (K2 reads the table itself). They
        depend on the parameters only, so a caller that encodes several
        batches with the same parameters computes them once and passes them
        in (XLA hoists the same work out of the JAX package's chunked eval);
        gradients reach ``table`` through them."""
        return self.cp_stacked_lines() if self.cp_stacked else None

    def _encode(self, x: torch.Tensor, with_jac: bool, cp_lines: Optional[torch.Tensor]):
        lead = x.shape[:-1]
        xf = x.reshape(-1, 3).to(torch.float32).contiguous()
        N = xf.shape[0]
        if self.cp_stacked and cp_lines is None:
            cp_lines = self.kernel_lines()
        if with_jac and self.cp_stacked and os.environ.get("NEURALSIM_CP_JAC_F32") == "1":
            raise NotImplementedError("NEURALSIM_CP_JAC_F32=1 (float32 lines for the stacked "
                                      "jacobian) is not ported")
        if xf.device.type == "cpu":      # the plain versions, under autograd
            out = torch.empty((self.out_dim, N), dtype=torch.float32)
            jac = torch.empty((3, self.out_dim, N), dtype=torch.float32) if with_jac else None
            if self.cp_stacked:
                lotd_cp_stacked(_RoundBf16.apply(cp_lines), xf, self._cp_rows, out, jac)
            elif self.cp_spec_ids:
                lotd_cp_level(self.table, xf, self._cp_meta, out, jac)
            if self.grid_spec_ids:
                lotd_grid(self.table, xf, self._grid_meta, out, jac)
        else:
            out, jac = _EncodeOnCard.apply(cp_lines if self.cp_stacked else None, self.table,
                                           xf, self._cp_rows, self._cp_meta, self._grid_meta,
                                           self.grid_bwd_plan, self.out_dim, with_jac)
        h = out.T.reshape(lead + (self.out_dim,))
        if not with_jac:
            return h
        return h, jac.permute(2, 1, 0).reshape(lead + (self.out_dim, 3))

    def forward(self, x: torch.Tensor, cp_lines: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x: [..., 3] in [0, 1] -> features [..., out_dim]. ``cp_lines``:
        :meth:`kernel_lines`, when the caller already has them."""
        return self._encode(x, False, cp_lines)

    def with_jacobian(self, x: torch.Tensor, cp_lines: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Features [..., out_dim] and jac [..., out_dim, 3] = d feats / d x01."""
        return self._encode(x, True, cp_lines)


def make_lotd(cfg: Dict[str, Any], input_dim: int = 3) -> LoTDEncoding:
    """Config-driven constructor (the JAX ``make_lotd`` surface: explicit
    ``levels``, ``type: tpu_mixed`` or the NGP ladder)."""
    cfg = dict(cfg)
    if cfg.get("anneal_cfg") is not None:
        raise NotImplementedError("the LoTD level anneal is not ported")
    if "auto_compute_cfg" in cfg or "target_num_params" in cfg:
        raise NotImplementedError("the auto-computed NGP plan is not ported")
    if "levels" in cfg:
        levels = [tuple(l) for l in cfg["levels"]]
    elif cfg.get("type") == "tpu_mixed" or cfg.get("mixed"):
        levels = tpu_mixed_levels(
            cfg.get("n_levels", 8), base_res=cfg.get("base_res", 16),
            max_res=cfg.get("max_res", 2048), n_feats=cfg.get("n_feats", 4),
            n_hash_levels=cfg.get("n_hash_levels", 2),
            log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
            cp_max_res=cfg.get("cp_max_res", 1024), input_dim=input_dim)
    else:
        levels = ngp_levels(cfg.get("n_levels", 16), cfg.get("n_feats", 2),
                            cfg.get("log2_hashmap_size", 19), cfg.get("base_res", 16),
                            cfg.get("max_res", 2048), input_dim)
    return LoTDEncoding(levels, input_dim,
                        log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
                        param_init_scale=cfg.get("param_init_scale", 1e-4))
