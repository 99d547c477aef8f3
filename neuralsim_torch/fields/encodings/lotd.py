"""LoTD ("Levels of Tensorial Decomposition") multi-resolution grid encoding.

Port of neuralsim_tpu/fields/encodings/lotd.py. All levels share one flat
float32 table with fixed per-level offsets, exactly the JAX layout, so a JAX
table copies over as is. Level types:

* ``cp``: d lines of [res, F]; features are the channelwise product of the
  per-axis linear interpolations. With two or more CP levels (the JAX default,
  "stacked CP") every level's lines are first resampled onto one grid of the
  largest CP resolution (the ``lotd_cp_lines`` kernel, K14, once for all
  levels, which writes them in float32 for autograd and in the bf16 that K1
  reads; without grad the encoding keeps them until its table changes); the
  lookup is the ``lotd_cp_stacked`` kernel (K1).
  A single CP level, or any number under ``NEURALSIM_CP_STACKED=0`` (read
  when the encoding is built, as JAX does), takes the per-level path: each
  level's own lines straight from the table, all levels in one launch of the
  ``lotd_cp_level`` kernel (K2).
* ``dense`` / ``hash``: 2^d-corner multilinear gather from a [F, size]
  table segment, hashed with the Instant-NGP primes beyond the dense budget;
  the lookup is the ``lotd_grid`` kernel (K3), for 3-D inputs (8 corners, the
  NeuS fields) and 4-D ones (16 corners, the distant field's contracted
  points; counted apart as ``lotd_grid4``). A 4-D encoding has no CP level
  and no jacobian on the card.

The kernels also give the analytic jacobian d(features)/d(x01) that the NeuS
field turns into normals. Each kernel's wrapper below takes its plain PyTorch
version for tensors on the CPU and launches the kernel for CUDA tensors.

Training: the outputs carry gradients into ``table`` (the on-render eikonal
loss trains through the jacobian). On the CPU autograd differentiates the
plain versions; on the card one ``torch.autograd.Function`` runs the forward
kernels and, in its backward, the ``lotd_cp_stacked.bwd``,
``lotd_cp_level.bwd`` and ``lotd_grid.bwd`` kernels; another runs K14 and
its backward (``lotd_cp_lines.bwd``, into the table's CP entries). On the
card the gradient to the positions (pose refinement: the rays, and so the
samples, depend on the pose deltas) is the ``lotd_grid.bwd_x`` kernel's, for
an encoding whose levels are all dense or hash (K3) at D 3 and the features'
cotangent alone; a backward that asks for it with CP levels (K1, K2), with a
jacobian cotangent (the second-order term of a NeuS field) or at D 4 (K3-4D)
raises (``NotImplementedError``, naming pose refinement), where the CPU's
plain versions give it under autograd.

Not ported yet: the batched ``bidx`` tables, 4-D CP levels, the level
anneal window and ``NEURALSIM_CP_JAC_F32=1`` (float32 lines for the
stacked jacobian), which raises.
"""
from __future__ import annotations

import math
import os
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ... import kernels
from ...maths.transforms import clip
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
# K3 on 4-D points (the same source, D = 4), counted apart
K3_4D = kernels.register("lotd_grid4", "neuralsim_torch/csrc/lotd_grid.cu",
                         "neuralsim_tpu/fields/encodings/lotd.py:410")
K3_4D_BWD = kernels.register("lotd_grid4.bwd", "neuralsim_torch/csrc/lotd_grid.cu",
                             "neuralsim_tpu/fields/encodings/lotd.py:410")
# K3's backward to the positions (3-D points, no jacobian cotangent)
K3_BWD_X = kernels.register("lotd_grid.bwd_x", "neuralsim_torch/csrc/lotd_grid.cu",
                            "neuralsim_tpu/fields/encodings/lotd.py:410")
# the points' dimensions that K3 takes, and the kernels that count each
GRID_DIMS = {3: (K3, K3_BWD), 4: (K3_4D, K3_4D_BWD)}
K2 = kernels.register("lotd_cp_level", "neuralsim_torch/csrc/lotd_cp_level.cu",
                      "neuralsim_tpu/fields/encodings/lotd.py:250")
K2_BWD = kernels.register("lotd_cp_level.bwd", "neuralsim_torch/csrc/lotd_cp_level.cu",
                          "neuralsim_tpu/fields/encodings/lotd.py:250")
K14 = kernels.register("lotd_cp_lines", "neuralsim_torch/csrc/lotd_cp_lines.cu",
                       "neuralsim_tpu/fields/encodings/lotd.py:322")
K14_BWD = kernels.register("lotd_cp_lines.bwd", "neuralsim_torch/csrc/lotd_cp_lines.cu",
                           "neuralsim_tpu/fields/encodings/lotd.py:322")

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
                   jac: Optional[torch.Tensor], dims: Sequence[int] = (3,)) -> None:
    """pos01 [N, D] float32 with D in ``dims``; out [C, N] and jac [D, C, N]
    float32."""
    if pos01.dtype != torch.float32 or pos01.dim() != 2 or pos01.shape[1] not in dims:
        raise ValueError(f"{name}: pos01 must be [N, D] float32, D in {tuple(dims)}")
    N, D = pos01.shape
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != N:
        raise ValueError(f"{name}: out must be [C, N] float32")
    if jac is not None and (jac.dtype != torch.float32 or jac.shape != (D,) + out.shape):
        raise ValueError(f"{name}: jac must be [{D}, C, N] float32")


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
                      d_jac: Optional[torch.Tensor], dims: Sequence[int] = (3,)) -> None:
    """d_out [C, N] and/or d_jac [D, C, N], float32, at least one of them."""
    if d_out is not None:
        _check_outputs(name, pos01, d_out, d_jac, dims)
    elif d_jac is None or d_jac.dim() != 3 or d_jac.shape[0] != pos01.shape[-1]:
        raise ValueError(f"{name}: needs d_out [C, N] or d_jac [D, C, N]")
    else:
        _check_outputs(name, pos01, d_jac[0], None, dims)


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


def grid_corner_rows(cell: torch.Tensor, res: int, size: int, is_hash: bool
                     ) -> torch.Tensor:
    """The rows of a point's 2^D corners on one level (JAX's
    ``_corner_rows_weight``, lotd.py:219-248): ``cell`` int64 [D, N] ->
    int64 [2^D, N], corner c taking cell_i + bit i of c. Dense: sum_i
    (cell_i + bit_i) (res + 1)^i; hash: xor_i of (cell_i + bit_i) * prime_i
    wrapped to 32 bits, mod ``size``."""
    D = cell.shape[0]
    return torch.stack([_corner_rows(cell, [(c >> i) & 1 for i in range(D)], res, size,
                                     is_hash) for c in range(1 << D)])


def lotd_grid_plain(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                    out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """Plain version of K3.

    table: flat float32 LoTD table; pos01: [N, D] (D 3 or 4); meta: int32
    [L, 6] rows of (res, size, offset, F, is_hash, out row). Writes each
    level's F features to rows [out row, out row + F) of ``out`` [C, N] and,
    given ``jac`` [D, C, N], their derivatives. The hash runs in int64 masked
    to 32 bits after each multiply (JAX's uint32 wrap-around).
    """
    _grid_levels_plain(lambda res, size, offset, nf: table[offset:offset + nf * size]
                       .view(nf, size), pos01, meta.tolist(), out, jac)


def _grid_levels_plain(segment, pos01: torch.Tensor, meta_rows: Sequence[Sequence[int]],
                       out: torch.Tensor, jac: Optional[torch.Tensor]) -> None:
    """K3's arithmetic, each level's features gathered from ``segment(res,
    size, offset, F)``, a [F, size] view of its rows; the points' dimension D
    is pos01's second axis (2^D corners, in order)."""
    D = pos01.shape[1]
    # jnp.clip's gradient: half of it at a face of the box (x == 0 or 1)
    x = clip(pos01, 0.0, 1.0).T                                  # [D, N]
    for res, size, offset, nf, is_hash, row in meta_rows:
        tbl = segment(res, size, offset, nf)
        pos = x * res
        cellf = torch.clamp(torch.floor(pos), max=res - 1)
        frac = pos - cellf
        cell = cellf.long()
        acc = None
        jl = [None] * D
        for corner in range(1 << D):
            bits = [(corner >> i) & 1 for i in range(D)]
            aw = [frac[i] if b else 1.0 - frac[i] for i, b in enumerate(bits)]
            w = aw[0]
            for a in aw[1:]:
                w = w * a
            f = gather_cols(tbl, _corner_rows(cell, bits, res, size, bool(is_hash)))
            term = w * f
            acc = term if acc is None else acc + term
            if jac is not None:
                for i in range(D):
                    dw = (1.0 if bits[i] else -1.0)
                    for j in range(D):
                        if j != i:
                            dw = dw * aw[j]
                    contrib = dw * f
                    jl[i] = contrib if jl[i] is None else jl[i] + contrib
        out[row:row + nf] = acc
        if jac is not None:
            jac[:, row:row + nf] = torch.stack(jl, dim=0) * res


# K3's forward stages the levels that fit this budget together in each
# block's shared memory, each as a [size, F] copy (csrc/lotd_grid.cu); the
# others are interleaved into a scratch that the launch fills first.
GRID_FWD_SMEM_BUDGET = 96 * 1024


class GridFwdPlan(NamedTuple):
    """Where K3's forward reads each level: bit l of ``stage_mask`` names row
    l of the meta for a block's shared copy of ``n_shared`` floats; the other
    levels go to the ``n_inter`` floats of the interleaved scratch. Each
    level takes F x size floats, rounded up to 4 in the shared copy and to 8
    (a 32-byte sector) in the scratch, in level order, where it fits
    (:func:`grid_fwd_places`, the walk the kernel makes). The plan is the
    same for 3-D and 4-D points (a level's copy is its [size, F] rows)."""
    stage_mask: int
    n_shared: int
    n_inter: int
    max_f: int = 8  # the widest level's F: the kernel's narrow form where <= 2


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


def grid_fwd_plan(meta_rows: Sequence[Sequence[int]]) -> GridFwdPlan:
    """Split K3's levels, rows of (res, size, offset, F, is_hash, out row),
    into staged ones, taken in level order while their copies fit
    GRID_FWD_SMEM_BUDGET together (dense levels, and hash levels of a small
    table), and interleaved ones (the others: the 4-D distant field's levels,
    668 KB dense and 1 MB hashed)."""
    mask, staged, inter = 0, 0, 0
    for l, (_, size, _, nf, _, _) in enumerate(meta_rows):
        seg = _align4(nf * size)
        if l < 31 and (staged + seg) * 4 <= GRID_FWD_SMEM_BUDGET:
            mask |= 1 << l
            staged += seg
        else:
            inter += _align8(nf * size)
    return GridFwdPlan(mask, staged, inter, max((r[3] for r in meta_rows), default=1))


def grid_fwd_places(meta_rows: Sequence[Sequence[int]], plan: GridFwdPlan
                    ) -> List[Tuple[str, int]]:
    """Where K3's forward reads each level under ``plan``, as the kernel walks
    the meta: ("shared", offset) in a block's staged copy, ("scratch",
    offset) in the interleaved scratch, or ("table", offset) straight from
    the table (a level that fits neither)."""
    places, staged, inter = [], 0, 0
    for l, (_, size, offset, nf, _, _) in enumerate(meta_rows):
        seg = _align4(nf * size)
        if l < 31 and (plan.stage_mask >> l) & 1 and staged + seg <= plan.n_shared:
            places.append(("shared", staged))
            staged += seg
        elif inter + _align8(nf * size) <= plan.n_inter:
            places.append(("scratch", inter))
            inter += _align8(nf * size)
        else:
            places.append(("table", offset))
    return places


def grid_interleave_plain(table: torch.Tensor, meta_rows: Sequence[Sequence[int]],
                          plan: GridFwdPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's two copies as the kernel fills them: each staged level's [F, size]
    segment as [size, F] rows at its place in a block's shared copy
    [n_shared], each interleaved one in the scratch [n_inter] (padding
    zeros)."""
    copies = {"shared": table.new_zeros(plan.n_shared), "scratch": table.new_zeros(plan.n_inter)}
    for (_, size, offset, nf, _, _), (where, off) in zip(meta_rows,
                                                         grid_fwd_places(meta_rows, plan)):
        if where != "table":
            copies[where][off:off + nf * size] = \
                table[offset:offset + nf * size].view(nf, size).T.reshape(-1)
    return copies["shared"], copies["scratch"]


def lotd_grid_layout_plain(table: torch.Tensor, pos01: torch.Tensor,
                           meta_rows: Sequence[Sequence[int]], plan: GridFwdPlan,
                           out: torch.Tensor, jac: Optional[torch.Tensor] = None) -> None:
    """K3's forward read as the kernel reads it under ``plan``: each level's
    rows from its [size, F] copy (:func:`grid_interleave_plain`) or from the
    table, with the plain version's arithmetic."""
    copies = dict(zip(("shared", "scratch"), grid_interleave_plain(table, meta_rows, plan)))
    places = iter(grid_fwd_places(meta_rows, plan))

    def segment(res, size, offset, nf):
        where, off = next(places)
        if where == "table":
            return table[off:off + nf * size].view(nf, size)
        return copies[where][off:off + nf * size].view(size, nf).T

    _grid_levels_plain(segment, pos01, meta_rows, out, jac)


def _table_key(table: torch.Tensor) -> Tuple[Any, ...]:
    """What identifies a table's contents for the copies kept from it."""
    return (weakref.ref(table), table.device, table.data_ptr(), table._version)


def _same_table(key: Optional[Tuple[Any, ...]], table: torch.Tensor) -> bool:
    return key is not None and key[0]() is table and key[1:] == _table_key(table)[1:]


class GridScratch:
    """K3 forward's interleaved scratch, kept across calls on one table: the
    launch fills it again only where the table's storage or version has
    changed since the last fill (``_version`` moves with every in-place
    write: ModelAdam's ``copy_``, a checkpoint load; a write through
    ``.data`` is not seen)."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.key: Optional[Tuple[Any, ...]] = None

    def take(self, table: torch.Tensor, n: int) -> Tuple[torch.Tensor, bool]:
        """The scratch of ``n`` floats for ``table``, and whether it must be
        filled from it."""
        if self.buf is None or self.buf.numel() != n or self.buf.device != table.device:
            self.buf = torch.empty(n, dtype=torch.float32, device=table.device)
            self.key = None
        return self.buf, not _same_table(self.key, table)

    def filled(self, table: torch.Tensor) -> None:
        self.key = _table_key(table)


def lotd_grid(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
              out: torch.Tensor, jac: Optional[torch.Tensor] = None,
              plan: Optional[GridFwdPlan] = None,
              scratch: Optional[GridScratch] = None) -> None:
    """K3 wrapper: the plain version on the CPU, the CUDA kernel on the card.
    ``meta`` must describe levels inside ``table`` and rows inside ``out``.
    ``plan``: the levels to stage in shared memory and the scratch's size,
    used as given; without it, ``grid_fwd_plan(meta)`` (the meta read back
    to the host). A plan made from another meta costs speed, not
    correctness: the kernel reads a level that fits neither copy from the
    table. ``scratch``: the interleaved copy kept from an earlier call on
    this table and meta (filled again where the table changed); without it
    every call fills a fresh one. The points pos01 are [N, 3] (K3, with the
    jacobian where ``jac`` [3, C, N] is given) or [N, 4] (K3 in four
    dimensions, ``lotd_grid4``; no jacobian on the card)."""
    if table.device.type == "cpu":
        return lotd_grid_plain(table, pos01, meta, out, jac)
    kernels.check_cuda("lotd_grid", table, pos01, meta, out, *([] if jac is None else [jac]))
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("lotd_grid: table must be a flat float32 tensor")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 6:
        raise ValueError("lotd_grid: meta must be int32 [L, 6]")
    _check_outputs("lotd_grid", pos01, out, jac, tuple(GRID_DIMS))
    D = pos01.shape[1]
    if D == 4 and jac is not None:
        raise NotImplementedError("lotd_grid: the kernel's jacobian is for 3-D points only")
    if plan is None:
        plan = grid_fwd_plan(meta.tolist())
    if plan.stage_mask >> meta.shape[0] or plan.n_shared * 4 > GRID_FWD_SMEM_BUDGET:
        raise ValueError("lotd_grid: the plan names a level past the meta or stages past "
                         "GRID_FWD_SMEM_BUDGET")
    inter, fill = None, False
    if plan.n_inter and scratch is not None:
        inter, fill = scratch.take(table, plan.n_inter)
    elif plan.n_inter:
        inter, fill = torch.empty(plan.n_inter, dtype=torch.float32, device=table.device), True
    GRID_DIMS[D][0].launch("lotd_grid_fwd", kernels.ptr(table), kernels.ptr(pos01),
                           kernels.ptr(meta), kernels.ptr(out), kernels.ptr(jac),
                           kernels.ptr(inter), int(fill), pos01.shape[0], out.shape[0],
                           meta.shape[0], plan.stage_mask, plan.n_shared, plan.n_inter,
                           plan.max_f, D, kernels.stream())
    if fill and scratch is not None:
        scratch.filled(table)


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


def lotd_grid_bwd_x_plain(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                          d_out: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's backward to the positions: autograd of the plain
    forward with respect to ``pos01`` [N, D] for the cotangent ``d_out`` [C,
    N] of its features -> d pos01 [N, D] float32 (JAX's autodiff of
    ``_level_features``: through frac = x res - cell, cell constant, and the
    clip of x into [0, 1], half the gradient at a face)."""
    with torch.enable_grad():
        x = pos01.detach().requires_grad_(True)
        out = d_out.new_zeros(d_out.shape)
        lotd_grid_plain(table.detach(), x, meta, out)
        return torch.autograd.grad(out, x, d_out)[0]


def lotd_grid_bwd_x(table: torch.Tensor, pos01: torch.Tensor, meta: torch.Tensor,
                    d_out: torch.Tensor, plan: Optional[GridFwdPlan] = None,
                    scratch: Optional[GridScratch] = None) -> torch.Tensor:
    """K3 backward-to-the-positions wrapper: the plain version on the CPU, the
    CUDA kernel (``lotd_grid.bwd_x``) on the card, for 3-D points [N, 3] and
    the features' cotangent ``d_out`` [C, N] -> d pos01 [N, 3]. It reads the
    levels where the forward does, the interleaved ones from the forward's
    scratch: ``plan`` and ``scratch`` as :func:`lotd_grid` takes them (the
    scratch filled first where the table changed; without one, a fresh one
    each call). Each point owns its three outputs: no atomics, the same bits
    every call."""
    if pos01.device.type == "cpu":
        return lotd_grid_bwd_x_plain(table, pos01, meta, d_out)
    kernels.check_cuda("lotd_grid_bwd_x", table, pos01, meta, d_out)
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("lotd_grid_bwd_x: table must be a flat float32 tensor")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 6:
        raise ValueError("lotd_grid_bwd_x: meta must be int32 [L, 6]")
    if pos01.dim() != 2 or pos01.dtype != torch.float32:
        raise ValueError("lotd_grid_bwd_x: pos01 must be float32 [N, D]")
    N, D = pos01.shape
    if D != 3:
        raise NotImplementedError("the gradient to the positions of K3 in four dimensions "
                                  "(K3-4D) is not ported on the card (pose refinement)")
    if d_out.dtype != torch.float32 or d_out.dim() != 2 or d_out.shape[1] != N:
        raise ValueError(f"lotd_grid_bwd_x: d_out must be float32 [C, {N}]")
    if plan is None:
        plan = grid_fwd_plan(meta.tolist())
    inter, fill = None, False
    if plan.n_inter and scratch is not None:
        inter, fill = scratch.take(table, plan.n_inter)
    elif plan.n_inter:
        inter, fill = torch.empty(plan.n_inter, dtype=torch.float32, device=table.device), True
    d_x = torch.empty((N, 3), dtype=torch.float32, device=pos01.device)
    K3_BWD_X.launch("lotd_grid_bwd_x", kernels.ptr(table), kernels.ptr(pos01),
                    kernels.ptr(meta), kernels.ptr(d_out), kernels.ptr(d_x), kernels.ptr(inter),
                    int(fill), N, meta.shape[0], plan.stage_mask, plan.n_shared, plan.n_inter,
                    kernels.stream())
    if fill and scratch is not None:
        scratch.filled(table)
    return d_x


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
    block's copy, a row of the scratch). For 3-D points."""
    private_mask: int
    n_private: int

    def at(self, n_points: int) -> "GridBwdPlan":
        """The plan of a launch of ``n_points``: private levels only where the
        launch has GRID_BWD_PRIVATE_MIN_POINTS points a private float."""
        if n_points >= GRID_BWD_PRIVATE_MIN_POINTS * self.n_private:
            return self
        return GridBwdPlan(0, 0)


class Grid4BwdPlan(NamedTuple):
    """K3's backward on 4-D points (``lotd_grid4.bwd``), which sums no level
    in shared memory: ``n_inter``, the floats of its gradient scratch, each
    level's [size, F] rows at the places of the forward's interleaved scratch
    (:func:`grid_bwd_places`), while they fit."""
    n_inter: int
    private_mask = 0
    n_private = 0

    def at(self, n_points: int) -> "Grid4BwdPlan":
        return self


def grid_bwd_plan(meta_rows: Sequence[Sequence[int]], dim: int = 3
                  ) -> Union[GridBwdPlan, Grid4BwdPlan]:
    """For 3-D points, split K3's levels, rows of (res, size, offset, F,
    is_hash, out row), into private ones, the dense levels taken in level
    order while their F x size floats fit GRID_BWD_SMEM_BUDGET together, and
    global ones: the hash levels (fine cells whose rows the hash scatters, so
    that neighbouring samples rarely share one) and the dense levels past the
    budget. For 4-D points (``dim`` 4: the distant field, whose 17^4-row dense
    level fits no budget) every level goes to the gradient scratch."""
    if dim == 4:
        return Grid4BwdPlan(sum(_align8(r[3] * r[1]) for r in meta_rows))
    mask, used = 0, 0
    for l, (_, size, _, nf, is_hash, _) in enumerate(meta_rows):
        if not is_hash and l < 31 and (used + nf * size) * 4 <= GRID_BWD_SMEM_BUDGET:
            mask |= 1 << l
            used += nf * size
    return GridBwdPlan(mask, used)


def grid_bwd_places(meta_rows: Sequence[Sequence[int]], plan: Grid4BwdPlan
                    ) -> List[Tuple[str, int]]:
    """Where K3's 4-D backward adds each level under ``plan``: ("scratch",
    offset) in the gradient scratch, each level's F x size floats rounded up
    to 8 in level order while they fit ``plan.n_inter``, or ("table",
    offset) into the table's own [F, size] segment."""
    return grid_fwd_places(meta_rows, GridFwdPlan(0, 0, plan.n_inter))


def lotd_grid_bwd_layout_plain(n_table: int, pos01: torch.Tensor,
                               meta_rows: Sequence[Sequence[int]], plan: Grid4BwdPlan,
                               d_out: torch.Tensor) -> torch.Tensor:
    """K3's 4-D backward in the kernel's layout: each point's 16 corners (the
    plain version's rows and weights, in corner order) added into the [size,
    F] rows of the level's place in the gradient scratch (or into the table's
    [F, size] segment, a level past it), then the scratch written into the
    table's layout. d_out [C, N] -> d table [n_table]."""
    D = pos01.shape[1]
    x = pos01.clamp(0.0, 1.0).T
    scratch = d_out.new_zeros(plan.n_inter)
    d_table = d_out.new_zeros(n_table)
    places = grid_bwd_places(meta_rows, plan)
    for (res, size, offset, nf, is_hash, col), (where, off) in zip(meta_rows, places):
        pos = x * res
        cellf = torch.clamp(torch.floor(pos), max=res - 1)
        frac = pos - cellf
        cell = cellf.long()
        g = d_out[col:col + nf].T                                   # [N, F]
        rows_f = scratch[off:off + nf * size].view(size, nf) if where == "scratch" \
            else d_table[offset:offset + nf * size].view(nf, size).T
        for corner in range(1 << D):
            bits = [(corner >> i) & 1 for i in range(D)]
            w = None
            for i, b in enumerate(bits):
                a = frac[i] if b else 1.0 - frac[i]
                w = a if w is None else w * a
            r = _corner_rows(cell, bits, res, size, bool(is_hash)).clamp(0, size - 1)
            rows_f.index_add_(0, r, w[:, None] * g)
    for (res, size, offset, nf, _, _), (where, off) in zip(meta_rows, places):
        if where == "scratch":
            d_table[offset:offset + nf * size] = \
                scratch[off:off + nf * size].view(size, nf).T.reshape(-1)
    return d_table


def lotd_grid_bwd(n_table: int, pos01: torch.Tensor, meta: torch.Tensor,
                  d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor],
                  plan: Union[None, GridBwdPlan, Grid4BwdPlan] = None) -> torch.Tensor:
    """K3 backward wrapper: scatter-add of both cotangents into a zeroed table
    of ``n_table`` floats (float32 atomics on the card, so the last bits vary
    from run to run). ``meta`` must describe levels inside the table.
    ``plan``: the levels to sum in shared memory (3-D, a GridBwdPlan) or the
    gradient scratch's size (4-D, a Grid4BwdPlan), used as given; without it, ``grid_bwd_plan(meta,
    D).at(N)`` (the meta read back to the host). A plan made from another meta
    costs speed, not correctness: the kernel sums a named level in shared
    memory only where it fits ``n_private``, and adds a 4-D level past the
    scratch into the table a float at a time. Points of 4 dimensions
    (``lotd_grid4.bwd``) take ``d_out`` only."""
    if pos01.device.type == "cpu":
        return lotd_grid_bwd_plain(n_table, pos01, meta, d_out, d_jac)
    given = [x for x in (d_out, d_jac) if x is not None]
    kernels.check_cuda("lotd_grid_bwd", pos01, meta, *given)
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 6:
        raise ValueError("lotd_grid_bwd: meta must be int32 [L, 6]")
    _check_cotangents("lotd_grid_bwd", pos01, d_out, d_jac, tuple(GRID_DIMS))
    N, D = pos01.shape
    if D == 4 and d_jac is not None:
        raise NotImplementedError("lotd_grid_bwd: the kernel's jacobian is for 3-D points only")
    if plan is None:
        plan = grid_bwd_plan(meta.tolist(), D).at(N)
    if plan.private_mask >> meta.shape[0]:
        raise ValueError("lotd_grid_bwd: the plan names a level past the meta")
    dev = pos01.device
    scratch = inter = None
    n_inter = getattr(plan, "n_inter", 0) if D == 4 else 0
    if D == 4:
        # no level private; the gradient scratch, zeroed
        if n_inter:
            inter = torch.zeros(n_inter, dtype=torch.float32, device=dev)
    elif plan.n_private:
        # a row of the scratch for each block of the persistent grid, one a SM
        scratch = torch.empty((kernels.sm_count(dev.index), plan.n_private),
                              dtype=torch.float32, device=dev)
    d_table = torch.zeros(n_table, dtype=torch.float32, device=dev)
    GRID_DIMS[D][1].launch("lotd_grid_bwd", kernels.ptr(pos01), kernels.ptr(meta),
                           kernels.ptr(d_out), kernels.ptr(d_jac), kernels.ptr(d_table),
                           kernels.ptr(scratch), kernels.ptr(inter), N, given[0].shape[-2],
                           meta.shape[0], 0 if D == 4 else plan.private_mask,
                           0 if D == 4 else plan.n_private, n_inter, D, kernels.stream())
    return d_table


# ---------------------------------------------------------------------------
# K14: the stacked CP lines (every CP level resampled onto R_max)
# ---------------------------------------------------------------------------

class CpLinesPlan(NamedTuple):
    """K14's static plan for the CP levels stacked in order: each level's
    two taps onto R_max and, for the backward, the taps by source row and
    the work items that cover the table gradient."""
    lo: torch.Tensor       # int32 [L, R_max]: the lower tap's row
    w: torch.Tensor        # float32 [L, R_max]: the upper tap's weight
    levels: torch.Tensor   # int32 [L, 6]: (first CP entry, offset, R, F, first column, first row)
    rowptr: torch.Tensor   # int32 [sum R + 1]: a CSR over the levels' rows ...
    tap_j: torch.Tensor    # int32 [2 L R_max]: ... of the R_max positions that read each row
    tap_w: torch.Tensor    # float32 [2 L R_max]: ... and their weights, 1 - w or w
    items: torch.Tensor    # int32 [n_items, 4]: the backward's warps, see cp_lines_items
    n_entries: int         # the CP entries of the table, sum of 3 R F
    n_table: int           # the table's floats, all of which the backward writes
    n_cols: int            # F_cp, the stacked features: the levels' F summed

    def to(self, device) -> "CpLinesPlan":
        return self._replace(**{k: getattr(self, k).to(device) for k in CP_LINES_TENSORS})


CP_LINES_TENSORS = CpLinesPlan._fields[:-3]
# the backward's taps a lane, tried in this order: the first whose work list
# has at most CP_LINES_MAX_ITEMS warps (those an H100 holds at once, 32 an
# SM) is taken; a small table takes more lanes an entry and a shorter tap
# walk, a large one fewer warps
CP_LINES_TAPS_A_LANE = (1, 2, 4, 8, 16)
CP_LINES_MAX_ITEMS = 132 * 32
# the zeros a warp writes outside the CP segments
CP_LINES_ZERO_CHUNK = 1024


def cp_lines_items(levels: Sequence[Tuple[int, int, int, int, int, int]], rowptr: np.ndarray,
                   n_table: int, taps_a_lane: int) -> np.ndarray:
    """The backward's work list, one warp an item, int32 [n_items, 4]:
    (level k, its first local entry, G, 0) for the CP entries and (-1,
    first float, count, 0) for the zeros of the rest of the table.

    A level whose rows have at most T taps gets G = the least power of two
    >= T / taps_a_lane (at most 32) lanes an entry, so an item covers 32 / G
    consecutive entries (a row's features side by side) of one level; the
    levels with the longest rows come first. The zero items cover [0,
    n_table) outside the CP segments in chunks of CP_LINES_ZERO_CHUNK."""
    cp, zeros = [], []
    for k, (_, _, R, F, _, row) in enumerate(levels):
        taps = int(np.max(np.diff(rowptr[row:row + R + 1])))
        G = 1
        while G < 32 and G * taps_a_lane < taps:
            G *= 2
        n = 3 * R * F
        cp.append((-G, k, [(k, e, G, 0) for e in range(0, n, 32 // G)]))
    at = 0
    for _, offset, R, F, _, _ in sorted(levels, key=lambda m: m[1]) + [(0, n_table, 0, 0, 0, 0)]:
        for e in range(at, offset, CP_LINES_ZERO_CHUNK):
            zeros.append((-1, e, min(CP_LINES_ZERO_CHUNK, offset - e), 0))
        at = max(at, offset + 3 * R * F)
    items = [it for _, _, its in sorted(cp) for it in its] + zeros
    return np.asarray(items, np.int32).reshape(-1, 4)


def cp_lines_work(levels: Sequence[Tuple[int, int, int, int, int, int]], rowptr: np.ndarray,
                  n_table: int) -> Tuple[int, np.ndarray]:
    """The backward's taps a lane (the first of CP_LINES_TAPS_A_LANE whose
    work list fits CP_LINES_MAX_ITEMS, else the last) and its work list."""
    for taps in CP_LINES_TAPS_A_LANE:
        items = cp_lines_items(levels, rowptr, n_table, taps)
        if items.shape[0] <= CP_LINES_MAX_ITEMS:
            break
    return taps, items


def cp_lines_plan(levels: Sequence[Tuple[int, int, int]], rmax: int,
                  n_table: Optional[int] = None) -> CpLinesPlan:
    """The plan of CP levels (R, F, table offset) onto ``rmax``: JAX's
    float64 taps (lotd.py:178-185), lo = min(floor(pos), max(R - 2, 0)) and
    the upper tap min(lo + 1, R - 1), clamped where R is 1. A row's taps are
    listed by position, the lower tap first (CPU tensors). ``n_table``: the
    table's floats (by default where the last CP segment ends)."""
    los, ws, meta, tap_j, tap_w = [], [], [], [], []
    rowptr = [0]
    entry = col = row = 0
    for k, (R, F, offset) in enumerate(levels):
        posc = np.linspace(0.0, 1.0, rmax) * (R - 1)
        lo = np.minimum(np.floor(posc).astype(np.int64), max(R - 2, 0))
        w = (posc - lo).astype(np.float32)
        src = np.concatenate([lo, np.minimum(lo + 1, R - 1)])
        j = np.tile(np.arange(rmax), 2)
        order = np.lexsort((np.repeat([0, 1], rmax), j, src))   # by row, position, tap
        los.append(lo)
        ws.append(w)
        meta.append((entry, offset, R, F, col, row))
        tap_j.append(j[order])
        tap_w.append(np.concatenate([np.float32(1.0) - w, w])[order])
        rowptr += (rowptr[-1] + np.cumsum(np.bincount(src, minlength=R))).tolist()
        entry, col, row = entry + 3 * R * F, col + F, row + R
    if n_table is None:
        n_table = max(offset + 3 * R * F for R, F, offset in levels)
    T = lambda a, dt: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dt)))
    return CpLinesPlan(T(np.stack(los), np.int32), T(np.stack(ws), np.float32),
                       T(meta, np.int32).reshape(-1, 6),
                       T(rowptr, np.int32), T(np.concatenate(tap_j), np.int32),
                       T(np.concatenate(tap_w), np.float32),
                       torch.from_numpy(cp_lines_work(meta, np.asarray(rowptr), n_table)[1]),
                       entry, n_table, col)


class CpLines(NamedTuple):
    """The stacked lines [3, F_cp, R_max] in both forms K14 writes: ``f32``,
    the tensor that autograd differentiates (the edge into K14's backward),
    and ``bf16``, the same values rounded to bf16, which K1 reads (no
    gradient)."""
    f32: torch.Tensor
    bf16: torch.Tensor


def lotd_cp_lines_plain(table: torch.Tensor, plan: CpLinesPlan
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K14, JAX's ``_cp_stacked_lines`` op for op: per
    level two row takes and a lerp, stacked -> [3, F_cp, R_max] float32, and
    that rounded to bf16 (detached)."""
    cols = []
    for k, (_, offset, R, F, _, _) in enumerate(plan.levels.tolist()):
        seg = table[offset:offset + 3 * R * F].view(3, R, F)
        lo = plan.lo[k].long()
        w = plan.w[k][:, None]
        l0 = seg[:, lo]
        l1 = seg[:, torch.clamp(lo + 1, max=R - 1)]
        cols.append(l0 * (1.0 - w) + l1 * w)
    lines = torch.cat(cols, dim=-1).transpose(1, 2).contiguous()
    return lines, lines.detach().to(torch.bfloat16)


def lotd_cp_lines_bwd_plain(d_lines: torch.Tensor, n_table: int,
                            plan: CpLinesPlan) -> torch.Tensor:
    """Plain version of K14's backward: autograd of the plain forward (a
    zero-filled table gradient a level's slice, two index_put accumulations a
    level) -> d table [n_table] float32."""
    with torch.enable_grad():
        table = d_lines.new_zeros(n_table).requires_grad_(True)
        return torch.autograd.grad(lotd_cp_lines_plain(table, plan)[0], table, d_lines)[0]


def _lines_shape(plan: CpLinesPlan) -> Tuple[int, int, int]:
    return 3, plan.n_cols, plan.lo.shape[1]


def lotd_cp_lines(table: torch.Tensor, plan: CpLinesPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14 wrapper: the stacked lines [3, F_cp, R_max] in float32 and in bf16
    (the plain version on the CPU; on the card one launch writes both,
    bit-equal to it). ``plan`` must describe CP levels inside ``table``."""
    if table.device.type == "cpu":
        return lotd_cp_lines_plain(table, plan)
    kernels.check_cuda("lotd_cp_lines", table, plan.levels, plan.lo, plan.w)
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("lotd_cp_lines: table must be a flat float32 tensor")
    if plan.lo.dtype != torch.int32:
        raise ValueError("lotd_cp_lines: the plan's lo must be int32")
    out = torch.empty(_lines_shape(plan), dtype=torch.float32, device=table.device)
    out16 = torch.empty(_lines_shape(plan), dtype=torch.bfloat16, device=table.device)
    K14.launch("lotd_cp_lines_fwd", kernels.ptr(table), kernels.ptr(plan.levels),
               kernels.ptr(plan.lo), kernels.ptr(plan.w), kernels.ptr(out), kernels.ptr(out16),
               plan.levels.shape[0], out.shape[1], out.shape[2], kernels.stream())
    return out, out16


def lotd_cp_lines_bwd(d_lines: torch.Tensor, n_table: int, plan: CpLinesPlan) -> torch.Tensor:
    """K14 backward wrapper: the gradient of the stacked lines into the table
    gradient [n_table], its CP entries summed in gather form (no atomics: the
    same bits on every call) and every other entry 0. The card reads
    ``d_lines`` [3, F_cp, R_max] with its own strides and writes the whole
    gradient (``plan.n_table`` floats) in one launch; the plain version on
    the CPU."""
    if d_lines.device.type == "cpu":
        return lotd_cp_lines_bwd_plain(d_lines, n_table, plan)
    kernels.check_cuda("lotd_cp_lines_bwd", plan.levels, plan.items, plan.rowptr, plan.tap_j,
                       plan.tap_w)
    if d_lines.device != plan.levels.device or d_lines.dtype != torch.float32 \
            or tuple(d_lines.shape) != _lines_shape(plan) or min(d_lines.stride()) < 0:
        raise ValueError(f"lotd_cp_lines_bwd: d_lines must be float32 {_lines_shape(plan)} on "
                         f"{plan.levels.device}")
    if n_table != plan.n_table:
        raise ValueError(f"lotd_cp_lines_bwd: the plan covers a table of {plan.n_table} "
                         f"floats, not {n_table}")
    d_table = torch.empty(n_table, dtype=torch.float32, device=d_lines.device)
    K14_BWD.launch("lotd_cp_lines_bwd", kernels.ptr(d_lines), kernels.ptr(plan.levels),
                   kernels.ptr(plan.items), kernels.ptr(plan.rowptr), kernels.ptr(plan.tap_j),
                   kernels.ptr(plan.tap_w), kernels.ptr(d_table), *d_lines.stride(),
                   plan.items.shape[0], kernels.stream())
    return d_table


class _CpLinesOnCard(torch.autograd.Function):
    """K14 and its backward under autograd: the stacked lines from the table
    in float32 and bf16, the float32 lines' gradient into the table's CP
    entries. The bf16 lines are marked non-differentiable: autograd casts an
    output's gradient to its dtype, and the lines' gradient stays float32."""

    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan, ctx.n_table = plan, table.numel()
        lines, lines_bf16 = lotd_cp_lines(table, plan)
        ctx.mark_non_differentiable(lines_bf16)
        return lines, lines_bf16

    @staticmethod
    def backward(ctx, d_lines, _):
        return lotd_cp_lines_bwd(d_lines, ctx.n_table, ctx.plan), None


class LinesCache:
    """The stacked lines an encoding made without grad, kept until its table
    changes: served again only where the table is the same tensor on the same
    device with the same storage and ``_version`` (which moves with every
    in-place write: ModelAdam's ``copy_``, the bridge's ``copy_``, a
    checkpoint load; a write through ``.data`` is not seen, as for
    :class:`GridScratch`). Lines made with grad belong to their step's graph
    and are never stored; lines are never served with grad enabled
    (:meth:`LoTDEncoding.kernel_lines` asks only without)."""

    def __init__(self):
        self.lines: Optional[CpLines] = None
        self.key: Optional[Tuple[Any, ...]] = None

    def get(self, table: torch.Tensor) -> Optional[CpLines]:
        return self.lines if _same_table(self.key, table) else None

    def put(self, table: torch.Tensor, lines: CpLines) -> None:
        if lines.f32.requires_grad:
            raise ValueError("LinesCache: lines made with grad are not kept")
        self.lines, self.key = lines, _table_key(table)


# ---------------------------------------------------------------------------
# The encoding
# ---------------------------------------------------------------------------

class _EncodeOnCard(torch.autograd.Function):
    """K1 (stacked CP), K2 (per-level CP) and K3 forward into one
    feature-major buffer; their backwards into the float32 stacked lines and
    the table. K1 reads the bf16 lines that K14 wrote beside the float32
    ones (``lines_bf16``, data), and K2 rounds the table's CP segments as it
    reads them, so their gradients come back unrounded, in float32."""

    @staticmethod
    def forward(ctx, lines, lines_bf16, table, xf, cp_rows, cp_meta, grid_meta, grid_plans,
                out_dim, with_jac):
        N, D = xf.shape
        out = torch.empty((out_dim, N), dtype=torch.float32, device=xf.device)
        jac = torch.empty((D, out_dim, N), dtype=torch.float32, device=xf.device) \
            if with_jac else None
        if lines is not None:
            lotd_cp_stacked(lines_bf16, xf, cp_rows, out, jac)
        if cp_meta.shape[0]:
            lotd_cp_level(table, xf, cp_meta, out, jac)
        if grid_meta.shape[0]:
            lotd_grid(table, xf, grid_meta, out, jac, *grid_plans[0])
        ctx.save_for_backward(lines_bf16, table, xf, cp_rows, cp_meta, grid_meta)
        ctx.grid_fwd, ctx.grid_plan = grid_plans
        ctx.set_materialize_grads(False)
        return out, jac

    @staticmethod
    def backward(ctx, d_out, d_jac):
        lines_bf16, table, xf, cp_rows, cp_meta, grid_meta = ctx.saved_tensors
        d_out = None if d_out is None else d_out.contiguous()
        d_jac = None if d_jac is None else d_jac.contiguous()
        d_lines = d_table = d_x = None
        if d_out is None and d_jac is None:
            return (None,) * 10
        if ctx.needs_input_grad[3]:
            # K3's kernel gives it at D 3 from the features' cotangent; for the
            # rest the card has no kernel, and a None would drop it without a word
            if lines_bf16 is not None or cp_meta.shape[0]:
                raise NotImplementedError("the gradient to the positions of K1/K2 (CP levels) "
                                          "is not ported on the card (pose refinement)")
            if d_jac is not None:
                raise NotImplementedError("the gradient to the positions of K3 from a jacobian "
                                          "cotangent (the second-order term) is not ported on "
                                          "the card (pose refinement)")
            if xf.shape[1] != 3:
                raise NotImplementedError("the gradient to the positions of K3 in four "
                                          "dimensions (K3-4D) is not ported on the card (pose "
                                          "refinement)")
            d_x = lotd_grid_bwd_x(table, xf, grid_meta, d_out, *ctx.grid_fwd)
        if lines_bf16 is not None and ctx.needs_input_grad[0]:
            d_lines = lotd_cp_stacked_bwd(lines_bf16, xf, cp_rows, d_out, d_jac)
        if ctx.needs_input_grad[2]:
            if grid_meta.shape[0]:
                d_table = lotd_grid_bwd(table.numel(), xf, grid_meta, d_out, d_jac,
                                        ctx.grid_plan.at(xf.shape[0]))
            if cp_meta.shape[0]:
                d_table = lotd_cp_level_bwd(table, xf, cp_meta, d_out, d_jac, d_table)
        return d_lines, None, d_table, d_x, None, None, None, None, None, None


class LoTDEncoding(nn.Module):
    """Multi-level grid encoding over inputs in [0, 1]^d, d = ``input_dim``
    (3, or 4 for the distant field, whose levels are dense and hash only).

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
        if input_dim not in GRID_DIMS:
            raise NotImplementedError(f"the port's LoTD takes 3-D and 4-D inputs, not "
                                      f"{input_dim}-D")
        if input_dim != 3 and any(typ == "cp" for _, _, typ in levels):
            raise NotImplementedError(f"a CP level of a {input_dim}-D LoTD is not ported")
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
        # stacked-CP plan (K14): each CP level's lines resampled onto the
        # largest CP resolution by a static two-tap lerp (same float64 plan
        # as JAX), and the taps by source row for the backward
        self._cp_lines_entries = 0
        if self.cp_stacked:
            plan = cp_lines_plan([(self.specs[li].res, self.specs[li].n_feats,
                                   self.specs[li].offset) for li in self.cp_spec_ids],
                                 self.cp_rmax, self.total_params)
            for name in CP_LINES_TENSORS:
                self.register_buffer(f"_cp_lines_{name}", getattr(plan, name), persistent=False)
            self._cp_lines_entries = plan.n_entries

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
        self.grid_fwd_plan = grid_fwd_plan(meta)
        self.grid_bwd_plan = grid_bwd_plan(meta, input_dim)
        self.grid_scratch = GridScratch()
        self.lines_cache = LinesCache()

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

    def cp_lines_plan(self) -> CpLinesPlan:
        """K14's plan, on the encoding's device (stacked CP only)."""
        return CpLinesPlan(*(getattr(self, f"_cp_lines_{name}") for name in CP_LINES_TENSORS),
                           self._cp_lines_entries, self.total_params, self.cp_out_dim)

    def _make_lines(self) -> CpLines:
        """Resample every CP level's lines onto the R_max grid and stack them
        along features, in float32 and bf16: the plain version on the CPU, K14
        (one launch) and its backward on the card."""
        plan = self.cp_lines_plan()
        if self.table.device.type == "cpu":
            return CpLines(*lotd_cp_lines_plain(self.table, plan))
        return CpLines(*_CpLinesOnCard.apply(self.table, plan))

    def cp_stacked_lines(self) -> torch.Tensor:
        """The stacked lines [3, F_cp, R_max] float32 (they depend on the
        parameters only), made anew, under autograd where it is enabled."""
        return self._make_lines().f32

    def kernel_lines(self) -> Optional[CpLines]:
        """The stacked lines behind K1 (:class:`CpLines`: the float32 lines
        that gradients flow through, and the bf16 lines K1 reads), or None
        without stacked CP levels (K2 reads the table itself). They depend on
        the parameters only, so a caller that encodes several batches with the
        same parameters computes them once and passes them in (XLA hoists the
        same work out of the JAX package's chunked eval). With grad enabled
        each call makes them anew, for that step's graph; without grad, a
        call on an unchanged table returns the lines kept from the last such
        call (:class:`LinesCache`), so a render makes them once a table
        version."""
        if not self.cp_stacked:
            return None
        if torch.is_grad_enabled():
            return self._make_lines()
        lines = self.lines_cache.get(self.table)
        if lines is None:
            lines = self._make_lines()
            self.lines_cache.put(self.table, lines)
        return lines

    def _encode(self, x: torch.Tensor, with_jac: bool, cp_lines: Optional[CpLines]):
        lead = x.shape[:-1]
        D = self.input_dim
        # float32 on the card; the plain versions on the CPU in the table's
        # type (a float64 module gives a float64 yardstick)
        xf = x.reshape(-1, D).to(torch.float32 if x.is_cuda else self.table.dtype).contiguous()
        N = xf.shape[0]
        if self.cp_stacked and cp_lines is None:
            cp_lines = self.kernel_lines()
        if with_jac and self.cp_stacked and os.environ.get("NEURALSIM_CP_JAC_F32") == "1":
            raise NotImplementedError("NEURALSIM_CP_JAC_F32=1 (float32 lines for the stacked "
                                      "jacobian) is not ported")
        if xf.device.type == "cpu":      # the plain versions, under autograd
            out = torch.empty((self.out_dim, N), dtype=xf.dtype)
            jac = torch.empty((D, self.out_dim, N), dtype=xf.dtype) if with_jac else None
            if self.cp_stacked:
                lotd_cp_stacked(_RoundBf16.apply(cp_lines.f32), xf, self._cp_rows, out, jac)
            elif self.cp_spec_ids:
                lotd_cp_level(self.table, xf, self._cp_meta, out, jac)
            if self.grid_spec_ids:
                lotd_grid(self.table, xf, self._grid_meta, out, jac)
        else:
            f32, bf16 = cp_lines if self.cp_stacked else (None, None)
            out, jac = _EncodeOnCard.apply(f32, bf16, self.table,
                                           xf, self._cp_rows, self._cp_meta, self._grid_meta,
                                           ((self.grid_fwd_plan, self.grid_scratch),
                                            self.grid_bwd_plan),
                                           self.out_dim, with_jac)
        h = out.T.reshape(lead + (self.out_dim,))
        if not with_jac:
            return h
        return h, jac.permute(2, 1, 0).reshape(lead + (self.out_dim, D))

    def forward(self, x: torch.Tensor, cp_lines: Optional[CpLines] = None
                ) -> torch.Tensor:
        """x: [..., d] in [0, 1] -> features [..., out_dim]. ``cp_lines``:
        :meth:`kernel_lines`, when the caller already has them."""
        return self._encode(x, False, cp_lines)

    def with_jacobian(self, x: torch.Tensor, cp_lines: Optional[CpLines] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Features [..., out_dim] and jac [..., out_dim, d] = d feats / d x01
        (on the card for 3-D inputs only)."""
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
