"""Permutohedral-lattice hash encoding over [0, 1]^d inputs (port of
neuralsim_tpu/fields/encodings/permuto.py).

Each level scales the input by its resolution, elevates it onto the sum-zero
hyperplane of R^(d+1), rounds it greedily to the nearest remainder-0 lattice
point, ranks the differential to find the enclosing simplex, and
interpolates the d + 1 simplex vertices' features with barycentric weights;
a vertex's features are hashed rows of the level's slab (Adams et al. 2010,
"Fast High-Dimensional Filtering Using the Permutohedral Lattice"). All
levels share one flat float32 table in the JAX layout, feature-major within
a level (``table[offset + f * T + row]``), so a JAX table copies over as is.

The analytic jacobian d(features)/d(x01[:3]) reuses the gathered features:
inside a simplex the barycentric weights are linear in the elevation, so
d bary = down * oh^T E, a constant per simplex.

The lookup is kernel K9 (``csrc/permuto.cu``): its wrapper takes the plain
version below for tensors on the CPU and launches the kernel for CUDA
tensors. The plain version is the JAX math op for op (elevate, round, rank
with the index tie-break, wrap, one-hot barycentrics, vertex keys, uint32
hash), so its vertices and rows are the JAX package's bit for bit.

Training: on the CPU autograd differentiates the plain version; on the card
one ``torch.autograd.Function`` runs K9's forward and backward (the table's
gradient from both cotangents, and the inputs' gradient through the
barycentric weights, which carries the latents' gradient of a conditional
field). The jacobian has no gradient with respect to the inputs: the simplex
and the gathered rows are piecewise constant, as JAX's autodiff sees them.

Not ported yet: the batched ``bidx`` tables and the level anneal window.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ... import kernels

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737, 2654435741)
_U32 = 0xFFFFFFFF
# the input widths that K9 is instantiated for (xyz; xyz + time; xyz + a
# latent of 4 or 8)
CARD_DIMS = (3, 4, 7, 11)
JAC_DIMS = 3

K9 = kernels.register("permuto", "neuralsim_torch/csrc/permuto.cu",
                      "neuralsim_tpu/fields/encodings/permuto.py:183")
K9_BWD = kernels.register("permuto.bwd", "neuralsim_torch/csrc/permuto.cu",
                          "neuralsim_tpu/fields/encodings/permuto.py:183")


def _mul_u32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a * prime) mod 2^32 for a in [0, 2^32) int64, in two 16-bit halves of
    the prime so no int64 product overflows."""
    lo = (a * (prime & 0xFFFF)) & _U32
    hi = ((a * (prime >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_keys(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """keys: [d, N] int32 lattice coordinates -> [N] int64 rows: each key cast
    to uint32 (a negative key wraps), times its prime with uint32 wrap, XORed,
    modulo the table size (JAX ``_hash_keys``)."""
    h = None
    for i in range(keys.shape[0]):
        term = _mul_u32(keys[i].long() & _U32, _PRIMES[i % len(_PRIMES)])
        h = term if h is None else h ^ term
    return h % table_size


def lattice_constants(d: int) -> Tuple[List[float], List[float]]:
    """The elevation scales ``sf`` [d] and the diagonal of the elevation
    matrix E below its first row (``E[c + 1][c]`` = -(c + 1) sf[c]), as the
    float32 values JAX uses (computed in double, then rounded)."""
    inv_std = math.sqrt(2.0 / 3.0) * (d + 1)
    sf = [1.0 / math.sqrt((i + 1) * (i + 2)) * inv_std for i in range(d)]
    diag = [-(c + 1) * sf[c] for c in range(d)]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32).tolist()
    return f32(sf), f32(diag)


def lattice_tensor(d: int) -> torch.Tensor:
    """K9's constants of width d: sf [d], the diagonal [d] and f32(1 / (d+1)),
    float32 [2 d + 1]."""
    sf, diag = lattice_constants(d)
    return torch.tensor(sf + diag + [1.0 / (d + 1)], dtype=torch.float32)


def elevation_matrix(d: int) -> torch.Tensor:
    """E [d+1, d] float32: d(elevated)/d(pos) (JAX ``PermutoEncoding._E``)."""
    sf, diag = lattice_constants(d)
    E = torch.zeros(d + 1, d, dtype=torch.float32)
    E[0] = torch.tensor(sf)
    for i in range(1, d + 1):
        E[i, i:] = torch.tensor(sf[i:])
        E[i, i - 1] = diag[i - 1]
    return E


def simplex(pos: torch.Tensor, jac_dims: int = 0):
    """pos: [d, N] scaled coordinates -> (keys: d+1 of [d, N] int32, bary
    [d+1, N][, dbary [d+1, jac_dims, N]]), the JAX ``_simplex`` op for op."""
    d, N = pos.shape
    sf, _ = lattice_constants(d)
    elevated: List[Optional[torch.Tensor]] = [None] * (d + 1)
    sm = torch.zeros(N, dtype=pos.dtype, device=pos.device)
    for i in range(d, 0, -1):
        cf = pos[i - 1] * sf[i - 1]
        elevated[i] = sm - i * cf
        sm = sm + cf
    elevated[0] = sm
    elevated = torch.stack(elevated, 0)                          # [d+1, N]

    down = 1.0 / (d + 1)
    up = float(d + 1)
    v = elevated * down
    fl = torch.floor(v) * up
    ce = torch.ceil(v) * up
    rem0 = torch.where(ce - elevated < elevated - fl, ce, fl)
    sum_val = (torch.sum(rem0, 0) * down).to(torch.int32)

    # rank[i] = #{j > i: diff_i < diff_j} + #{j < i: diff_i <= diff_j}
    diff = elevated - rem0
    lt = diff[:, None, :] < diff[None, :, :]
    le = diff[:, None, :] <= diff[None, :, :]
    iu = torch.arange(d + 1, device=pos.device)
    upper = (iu[:, None] < iu[None, :])[..., None]
    lower = (iu[:, None] > iu[None, :])[..., None]
    rank = (torch.sum(lt & upper, 1) + torch.sum(le & lower, 1)).to(torch.int32)
    rank = rank + sum_val[None, :]
    low = rank < 0
    high = rank > d
    rank = torch.where(low, rank + d + 1, torch.where(high, rank - d - 1, rank))
    rem0 = torch.where(low, rem0 + (d + 1), torch.where(high, rem0 - (d + 1), rem0))

    diff = (elevated - rem0) * down
    rr = torch.arange(d + 2, device=pos.device)[None, :, None]
    oh = ((d - rank)[:, None, :] == rr).to(pos.dtype) \
        - ((d + 1 - rank)[:, None, :] == rr).to(pos.dtype)       # [d+1, d+2, N]
    bary = torch.sum(diff[:, None, :] * oh, 0)                   # [d+2, N]
    bary = torch.cat([bary[:1] + (1.0 + bary[d + 1:]), bary[1:]], 0)

    keys = []
    for k in range(d + 1):
        off = torch.where(rank >= (d + 1 - k), k - (d + 1), k)
        keys.append((rem0 + off).to(torch.int32)[:d])
    if not jac_dims:
        return keys, bary[:d + 1]
    E = elevation_matrix(d)[:, :jac_dims].to(pos.device)
    dbary = down * torch.einsum("irN,ic->rcN", oh, E)            # [d+2, jd, N]
    dbary = torch.cat([dbary[:1] + dbary[d + 1:], dbary[1:]], 0)
    return keys, bary[:d + 1], dbary[:d + 1]


def permuto_plain(table: torch.Tensor, x01: torch.Tensor, res: torch.Tensor,
                  meta: torch.Tensor, lat: torch.Tensor, table_size: int, with_jac: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K9. table: flat float32; x01: [N, d] float32 in
    [0, 1] (already clipped); res: float32 [L]; meta: int32 [L, 3] (table
    offset, F, first output row; levels in order); lat: K9's constants
    (:func:`lattice_tensor`; the plain version forms them itself). ->
    (features [C, N], jacobian [3, C, N] with respect to x01[:, :3], or
    None)."""
    xf = x01.T                                                   # [d, N]
    outs, jacs = [], []
    for r, (off, nf, _) in zip(res.tolist(), meta.tolist()):
        simp = simplex(xf * r, JAC_DIMS if with_jac else 0)
        keys, bary = simp[0], simp[1]
        tbl = table[off:off + nf * table_size].view(nf, table_size)
        acc = jac = None
        for k in range(len(keys)):
            feats = tbl[:, hash_keys(keys[k], table_size)]       # [F, N]
            term = bary[k][None, :] * feats
            acc = term if acc is None else acc + term
            if with_jac:
                jterm = feats[:, None, :] * (simp[2][k] * r)[None, :, :]
                jac = jterm if jac is None else jac + jterm      # [F, 3, N]
        outs.append(acc)
        if with_jac:
            jacs.append(jac)
    out = torch.cat(outs, 0)
    return out, (torch.cat(jacs, 0).transpose(0, 1) if with_jac else None)


def _check(name: str, table: torch.Tensor, x01: torch.Tensor, res: torch.Tensor,
           meta: torch.Tensor, lat: torch.Tensor, table_size: int) -> int:
    kernels.check_cuda(name, table, x01, res, meta, lat)
    d = x01.shape[1] if x01.dim() == 2 else 0
    if x01.dtype != torch.float32 or d not in CARD_DIMS:
        raise ValueError(f"{name}: x01 must be [N, d] float32 with d in {CARD_DIMS}, got "
                         f"{tuple(x01.shape)} {x01.dtype}")
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError(f"{name}: table must be a flat float32 tensor")
    L = res.shape[0]
    if res.dtype != torch.float32 or meta.dtype != torch.int32 or meta.shape != (L, 3):
        raise ValueError(f"{name}: res must be float32 [L] and meta int32 [L, 3]")
    if lat.dtype != torch.float32 or lat.shape != (2 * d + 1,):
        raise ValueError(f"{name}: lat must be float32 [2 d + 1]")
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"{name}: the table size must be a power of two")
    return d


def permuto(table: torch.Tensor, x01: torch.Tensor, res: torch.Tensor, meta: torch.Tensor,
            lat: torch.Tensor, table_size: int, n_out: int, with_jac: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K9 wrapper: the plain version on the CPU, the CUDA kernel on the card.
    ``meta`` must describe levels inside ``table`` and rows inside the
    ``n_out`` features."""
    if x01.device.type == "cpu":
        return permuto_plain(table, x01, res, meta, lat, table_size, with_jac)
    d = _check("permuto", table, x01, res, meta, lat, table_size)
    N = x01.shape[0]
    out = torch.empty((n_out, N), dtype=torch.float32, device=x01.device)
    jac = torch.empty((JAC_DIMS, n_out, N), dtype=torch.float32, device=x01.device) \
        if with_jac else None
    K9.launch("permuto_fwd", kernels.ptr(table), kernels.ptr(x01), kernels.ptr(res),
              kernels.ptr(meta), kernels.ptr(lat), kernels.ptr(out), kernels.ptr(jac), N, d,
              res.shape[0], n_out, table_size, kernels.stream())
    return out, jac


def permuto_bwd_plain(table: torch.Tensor, x01: torch.Tensor, res: torch.Tensor,
                      meta: torch.Tensor, lat: torch.Tensor, table_size: int,
                      d_out: Optional[torch.Tensor], d_jac: Optional[torch.Tensor],
                      need_dx: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K9's backward: autograd of the plain forward. ->
    (d table [numel] float32, d x01 [N, d] or None)."""
    with torch.enable_grad():
        t = table.detach().requires_grad_(True)
        x = x01.detach().requires_grad_(need_dx)
        out, jac = permuto_plain(t, x, res, meta, lat, table_size, d_jac is not None)
        loss = 0.0
        if d_out is not None:
            loss = loss + torch.sum(out * d_out)
        if d_jac is not None:
            loss = loss + torch.sum(jac * d_jac)
        grads = torch.autograd.grad(loss, [t, x] if need_dx else [t], allow_unused=True)
    d_table = grads[0] if grads[0] is not None else torch.zeros_like(table)
    d_x = (grads[1] if grads[1] is not None else torch.zeros_like(x01)) if need_dx else None
    return d_table, d_x


def permuto_bwd(table: torch.Tensor, x01: torch.Tensor, res: torch.Tensor, meta: torch.Tensor,
                lat: torch.Tensor, table_size: int, d_out: Optional[torch.Tensor],
                d_jac: Optional[torch.Tensor], need_dx: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K9 backward wrapper: the table's gradient from both cotangents (float32
    atomics on the card, so its last bits vary from run to run) and, with
    ``need_dx``, the gradient of x01 (one thread a point sums its levels)."""
    if x01.device.type == "cpu":
        return permuto_bwd_plain(table, x01, res, meta, lat, table_size, d_out, d_jac, need_dx)
    d = _check("permuto_bwd", table, x01, res, meta, lat, table_size)
    N = x01.shape[0]
    given = [g for g in (d_out, d_jac) if g is not None]
    kernels.check_cuda("permuto_bwd", x01, *given)
    n_out = given[0].shape[-2] if given else 0
    if d_out is not None and (d_out.dtype != torch.float32 or d_out.shape != (n_out, N)):
        raise ValueError("permuto_bwd: d_out must be [C, N] float32")
    if d_jac is not None and (d_jac.dtype != torch.float32
                              or d_jac.shape != (JAC_DIMS, n_out, N)):
        raise ValueError("permuto_bwd: d_jac must be [3, C, N] float32")
    d_table = torch.zeros_like(table)
    d_x = torch.empty_like(x01) if need_dx else None
    if not given:
        return d_table, (None if d_x is None else d_x.zero_())
    K9_BWD.launch("permuto_bwd", kernels.ptr(table), kernels.ptr(x01), kernels.ptr(res),
                  kernels.ptr(meta), kernels.ptr(lat), kernels.ptr(d_out), kernels.ptr(d_jac),
                  kernels.ptr(d_table), kernels.ptr(d_x), N, d, res.shape[0], n_out,
                  table_size, kernels.stream())
    return d_table, d_x


class _PermutoOnCard(torch.autograd.Function):
    """K9 forward, and in the backward K9's backward into the table and the
    inputs."""

    @staticmethod
    def forward(ctx, table, x01, res, meta, lat, table_size, n_out, with_jac):
        out, jac = permuto(table, x01, res, meta, lat, table_size, n_out, with_jac)
        ctx.save_for_backward(table, x01, res, meta, lat)
        ctx.table_size = table_size
        ctx.set_materialize_grads(False)
        return out, jac

    @staticmethod
    def backward(ctx, d_out, d_jac):
        table, x01, res, meta, lat = ctx.saved_tensors
        if (d_out is None and d_jac is None) or not any(ctx.needs_input_grad[:2]):
            return (None,) * 8
        d_out = None if d_out is None else d_out.contiguous()
        d_jac = None if d_jac is None else d_jac.contiguous()
        d_table, d_x = permuto_bwd(table, x01, res, meta, lat, ctx.table_size, d_out, d_jac,
                                   ctx.needs_input_grad[1])
        return (d_table if ctx.needs_input_grad[0] else None, d_x,
                None, None, None, None, None, None)


class PermutoEncoding(nn.Module):
    """Multi-level permutohedral hash encoding over [0, 1]^d.

    levels: sequence of (resolution, n_feats); by default the geometric
    ladder of ``n_levels`` from ``base_res`` to ``max_res``. Parameter:
    ``table``, the flat float32 table of every level (2^log2_hashmap_size
    rows a level)."""

    def __init__(self, input_dim: int, levels: Optional[Sequence[Tuple[float, int]]] = None, *,
                 n_levels: int = 16, n_feats: int = 2, base_res: float = 4.0,
                 max_res: float = 512.0, log2_hashmap_size: int = 18,
                 param_init_scale: float = 1e-4, anneal_cfg: Optional[Dict] = None):
        super().__init__()
        if anneal_cfg is not None:
            raise NotImplementedError("the permuto level anneal is not ported")
        if input_dim < JAC_DIMS:
            raise ValueError(f"the permuto encoding needs d >= {JAC_DIMS}")
        self.input_dim = input_dim
        self.param_init_scale = param_init_scale
        self.table_size = 2 ** log2_hashmap_size
        if levels is None:
            b = math.exp((math.log(max_res) - math.log(base_res)) / (n_levels - 1)) \
                if n_levels > 1 else 1.0
            levels = [(base_res * (b ** l), n_feats) for l in range(n_levels)]
        self.levels = [(float(r), int(f)) for r, f in levels]
        self.n_levels = len(self.levels)
        self.out_dim = sum(f for _, f in self.levels)
        meta, off, row = [], 0, 0
        for _, f in self.levels:
            meta.append((off, f, row))
            off += self.table_size * f
            row += f
        self.total_params = off
        self.table = nn.Parameter(torch.zeros(self.total_params))
        self.register_buffer("_res", torch.tensor([r for r, _ in self.levels],
                                                  dtype=torch.float32), persistent=False)
        self.register_buffer("_meta", torch.tensor(meta, dtype=torch.int32).reshape(-1, 3),
                             persistent=False)
        self.register_buffer("_lat", lattice_tensor(input_dim), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX init in distribution: U(-1, 1) * param_init_scale."""
        t = torch.rand(self.total_params, generator=generator) * 2.0 - 1.0
        self.table.copy_(t * self.param_init_scale)

    def kernel_lines(self) -> None:
        """No parameter-only precomputation (the NeuS query asks every
        encoding; only stacked CP has one)."""
        return None

    def _encode(self, x: torch.Tensor, with_jac: bool, bidx: Optional[torch.Tensor]):
        if bidx is not None:
            raise NotImplementedError("the batched permuto tables (bidx) are not ported")
        from ..neus import clip01
        lead = x.shape[:-1]
        xf = clip01(x.reshape(-1, self.input_dim).to(torch.float32)).contiguous()
        if xf.device.type == "cpu":          # the plain version, under autograd
            out, jac = permuto_plain(self.table, xf, self._res, self._meta, self._lat,
                                     self.table_size, with_jac)
        else:
            out, jac = _PermutoOnCard.apply(self.table, xf, self._res, self._meta, self._lat,
                                            self.table_size, self.out_dim, with_jac)
        h = out.T.reshape(lead + (self.out_dim,))
        if not with_jac:
            return h
        return h, jac.permute(2, 1, 0).reshape(lead + (self.out_dim, JAC_DIMS))

    def forward(self, x: torch.Tensor, cp_lines: None = None,
                bidx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [..., d] in [0, 1] (clipped) -> features [..., out_dim]."""
        return self._encode(x, False, bidx)

    def with_jacobian(self, x: torch.Tensor, cp_lines: None = None,
                      bidx: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Features [..., out_dim] and jac [..., out_dim, 3] = d feats / d
        x[..., :3], in units of the [0, 1] input domain."""
        return self._encode(x, True, bidx)
