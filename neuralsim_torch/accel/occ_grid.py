"""EMA occupancy grids and the fixed-shape grid-skipping ray proposal (port of
neuralsim_tpu/accel/occ_grid.py:27-337): one grid (:class:`OccGridEma`), one
per instance of a shared model (:class:`OccGridEmaBatched`) and one per time
keyframe (:class:`OccGridEmaDynamic`).

The grid state is explicit: an :class:`OccGridState` (float32 values, the
boolean mask ``val > occ_thre`` and its occupied fraction, device tensors) that the trainer carries and hands to the renderer. Four
kernels live here, each beside its plain version:

* ``occ_ray_proposal`` (K4): probe ``march_steps`` equal segments of
  [near, far] against the mask and draw all ``n_samples`` depths from the
  per-segment occupancy CDF. No gradient: it only places samples.
* K10 (``occ_ray_proposal`` with ``lead``; counted as
  ``occ_ray_proposal_batched``): the same march over one of G grids
  [G, R, R, R] per ray, picked by an int32 index ``lead`` (the row's
  instance, or its time's keyframe); the same device code as K4.
* ``occ_voxel_points`` (K7's points): the jittered voxel samples in world
  coordinates, the points a refresh hands the field.
* ``occ_ema_update`` (K7): raw field values of the jittered voxel samples ->
  occupancy, max over a voxel's samples, ``max(decay * old, new)``, the
  warm-up floor and the threshold, and the occupied count and fraction, so that
  :meth:`OccGridEma.occupied_fraction` launches nothing on the card. The
  batched and dynamic grids update all their G R^3 voxels in one call, one
  sample a voxel.

A refresh is thus one points kernel, the field query, and one K7.

Random draws come in as tensors (``noise`` for the proposal, ``u`` for the
update), so a caller can replay another package's draws.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..maths.common import normalized_logistic_density
from ..ops.segment import det_u_on, sample_pdf

K4 = kernels.register("occ_ray_proposal", "neuralsim_torch/csrc/occ_grid.cu",
                      "neuralsim_tpu/accel/occ_grid.py:158")
K10 = kernels.register("occ_ray_proposal_batched", "neuralsim_torch/csrc/occ_grid.cu",
                       "neuralsim_tpu/accel/occ_grid.py:247")
K7 = kernels.register("occ_ema_update", "neuralsim_torch/csrc/occ_grid.cu",
                      "neuralsim_tpu/accel/occ_grid.py:99")
K7_POINTS = kernels.register("occ_voxel_points", "neuralsim_torch/csrc/occ_grid.cu",
                             "neuralsim_tpu/accel/occ_grid.py:106")

_MODES = {"sdf": 0, "density": 1}


class OccGridState(NamedTuple):
    """val: [R, R, R] (or [G, R, R, R]: batched, dynamic) float32 EMA
    occupancy in [0, 1]; mask: bool, val > occ_thre; frac: float32 [], the
    share of True voxels of ``mask`` as :func:`occupied_fraction_plain`
    gives it on the mask's device. K7 writes it, and ``init_state`` and the
    bridge make it once; a state built from ``val`` and ``mask`` alone has
    None there (:meth:`OccGridEma.occupied_fraction` then refuses it on the
    card)."""
    val: torch.Tensor
    mask: torch.Tensor
    frac: Optional[torch.Tensor] = None


def occupied_fraction_plain(mask: torch.Tensor) -> torch.Tensor:
    """The share of True voxels of a mask (the JAX ``occupied_fraction``)."""
    return mask.to(torch.float32).mean()


# ---------------------------------------------------------------------------
# K4: the ray proposal
# ---------------------------------------------------------------------------

def occ_ray_proposal_plain(rays_o: torch.Tensor, rays_d: torch.Tensor, near: torch.Tensor,
                           far: torch.Tensor, mask: torch.Tensor, aabb_min: torch.Tensor,
                           aabb_max: torch.Tensor, edges01: torch.Tensor, n_samples: int,
                           noise: Optional[torch.Tensor] = None,
                           lead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4 and K10 -> depths [N, n_samples], ascending.

    rays_o/rays_d: [N, 3]; near/far: [N]; mask: [R, R, R] bool, or
    [G, R, R, R] with ``lead`` [N] int32, each ray's grid (the flat probe
    index ``lead * R^3 + cell`` clipped into the G grids, as the JAX take's
    ``mode="clip"``); edges01: [M + 1] segment edges in [0, 1]; noise:
    [N, n_samples] uniform draws, or None for the stratum midpoints. A ray
    with no occupied probe gets uniform weights (so an empty grid still
    renders).
    """
    R = mask.shape[-1]
    t_edges = near[:, None] + (far - near)[:, None] * edges01               # [N, M+1]
    t_mid = 0.5 * (t_edges[:, 1:] + t_edges[:, :-1])
    x = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    x01 = (x - aabb_min) / (aabb_max - aabb_min)
    inside = torch.all((x01 >= 0) & (x01 <= 1), dim=-1)
    cell = (x01 * R).to(torch.int32).clamp(0, R - 1).long()
    lin = (cell[..., 0] * R + cell[..., 1]) * R + cell[..., 2]
    if lead is not None:
        lin = (lead.long()[:, None] * R ** 3 + lin).clamp(0, mask.numel() - 1)
    occ = (mask.reshape(-1)[lin] & inside).to(torch.float32)                # [N, M]
    hit_any = occ.amax(dim=-1, keepdim=True) > 0.0
    w = occ + (~hit_any).to(torch.float32)
    return sample_pdf(t_edges, w, n_samples, noise=noise, eps=1e-6)


def occ_ray_proposal(rays_o: torch.Tensor, rays_d: torch.Tensor, near: torch.Tensor,
                     far: torch.Tensor, mask: torch.Tensor, aabb_min: torch.Tensor,
                     aabb_max: torch.Tensor, edges01: torch.Tensor, n_samples: int,
                     noise: Optional[torch.Tensor] = None,
                     lead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 wrapper (K10 with ``lead``, each ray's grid in a [G, R, R, R]
    mask): the plain version on the CPU, the CUDA kernel on the card."""
    if rays_o.device.type == "cpu":
        return occ_ray_proposal_plain(rays_o, rays_d, near, far, mask, aabb_min, aabb_max,
                                      edges01, n_samples, noise, lead)
    N = rays_o.shape[0]
    # the draws: the midpoints, made once a device, or the noise, from which
    # the kernel forms them itself
    if noise is None:
        u, draws = det_u_on(n_samples, rays_o.device), (n_samples,)
    else:
        u, noise, draws = None, noise.contiguous(), (N, n_samples)
    given = noise if u is None else u
    f32 = torch.float32
    R, M = mask.shape[-1], edges01.shape[0] - 1
    G = 1 if lead is None else mask.shape[0]
    checks = [(rays_o, (N, 3), f32), (rays_d, (N, 3), f32), (near, (N,), f32),
              (far, (N,), f32), (mask, (R, R, R) if lead is None else (G, R, R, R), torch.bool),
              (aabb_min, (3,), f32), (aabb_max, (3,), f32), (edges01, (M + 1,), f32)]
    if lead is not None:
        checks.append((lead, (N,), torch.int32))
    kernels.check_cuda("occ_ray_proposal", *(x for x, _, _ in checks), given)
    for x, shape, dt in checks:
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"occ_ray_proposal: expected {shape} {dt}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= M <= 64 or n_samples < 1 or given.dtype != f32 or given.shape != draws:
        raise ValueError("occ_ray_proposal: needs 1..64 segments and [N, n_samples] noise")
    t = torch.empty((N, n_samples), dtype=f32, device=rays_o.device)
    (K4 if lead is None else K10).launch(
        "occ_ray_proposal", kernels.ptr(rays_o), kernels.ptr(rays_d), kernels.ptr(near),
        kernels.ptr(far), kernels.ptr(mask), kernels.ptr(lead), kernels.ptr(aabb_min),
        kernels.ptr(aabb_max), kernels.ptr(edges01), kernels.ptr(u), kernels.ptr(noise),
        kernels.ptr(t), N, G, R, M, n_samples, kernels.stream())
    return t


# ---------------------------------------------------------------------------
# K7: the voxel points and the EMA update
# ---------------------------------------------------------------------------

_LEADS = (None, "index", "time")


def occ_voxel_points_plain(u: torch.Tensor, aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                           lead: Optional[str] = None):
    """Plain version of K7's points: jitter u [L, R, R, R, 3] -> the points
    [L * R^3, 3] of every voxel of each of the L leading entries (samples,
    instances or keyframes), ``((i + u) / R) * (max - min) + min``. With
    ``lead`` also each point's entry [L * R^3]: "index", the instance index
    (int64), or "time", the keyframe's time ``(l + 0.5) / L``."""
    L, R = u.shape[0], u.shape[-2]
    ar = torch.arange(R, device=u.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
    x = ((idx[None] + u) / R).reshape(-1, 3) * (aabb_max - aabb_min) + aabb_min
    if lead is None:
        return x
    if lead == "index":
        return x, torch.arange(L, device=u.device).repeat_interleave(R ** 3)
    return x, ((torch.arange(L, dtype=torch.float32, device=u.device) + 0.5) / L
               ).repeat_interleave(R ** 3)


def occ_voxel_points(u: torch.Tensor, aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                     lead: Optional[str] = None):
    """K7's points (and ``lead``, see the plain version): the plain version
    on the CPU, the CUDA kernel on the card, one launch (the card's plain
    version bit for bit: PyTorch divides by R and L there as a product with
    the float reciprocal, which the kernel takes too)."""
    if lead not in _LEADS:
        raise ValueError(f"occ_voxel_points: lead must be one of {_LEADS}, got {lead!r}")
    if u.device.type == "cpu":
        return occ_voxel_points_plain(u, aabb_min, aabb_max, lead)
    kernels.check_cuda("occ_voxel_points", u, aabb_min, aabb_max)
    R = u.shape[-2] if u.dim() == 5 else 0
    if u.dim() != 5 or tuple(u.shape[1:]) != (R, R, R, 3) or u.dtype != torch.float32 \
            or u.numel() == 0:
        raise ValueError(f"occ_voxel_points: u must be [L, R, R, R, 3] float32, got "
                         f"{tuple(u.shape)} {u.dtype}")
    for b in (aabb_min, aabb_max):
        if tuple(b.shape) != (3,) or b.dtype != torch.float32:
            raise ValueError("occ_voxel_points: the box must be two [3] float32 tensors")
    if u.numel() >= 2 ** 31:
        raise ValueError(f"occ_voxel_points: {tuple(u.shape)} is past the kernel's 2^31 floats")
    L, P = u.shape[0], u.numel() // 3
    x = torch.empty((P, 3), dtype=torch.float32, device=u.device)
    idx = torch.empty(P, dtype=torch.int64, device=u.device) if lead == "index" else None
    t = torch.empty(P, dtype=torch.float32, device=u.device) if lead == "time" else None
    K7_POINTS.launch("occ_voxel_points", kernels.ptr(u), kernels.ptr(aabb_min),
                     kernels.ptr(aabb_max), kernels.ptr(x), kernels.ptr(idx), kernels.ptr(t), L,
                     R, float(np.float32(1) / np.float32(R)), float(np.float32(1) / np.float32(L)),
                     kernels.stream())
    if lead is None:
        return x
    return x, (idx if lead == "index" else t)


def occ_from_raw(raw: torch.Tensor, mode: str, p: float, inv_s: float) -> torch.Tensor:
    """Raw field values -> occupancy in [0, 1]. ``sdf``: the logistic density
    of the sdf eroded by ``p``, half a voxel's diagonal (a sample within that
    distance of the surface registers the peak value); ``density``:
    ``1 - exp(-raw * p)`` with ``p`` the voxel size."""
    if mode == "sdf":
        return normalized_logistic_density(torch.clamp(raw.abs() - p, min=0.0), inv_s)
    if mode == "density":
        return 1.0 - torch.exp(-raw * p)
    raise ValueError(mode)


def occ_ema_update_plain(raw: torch.Tensor, val: torch.Tensor, mode: str, p: float,
                         inv_s: float, decay: float, thre: float,
                         warm_floor: Optional[float]) -> Tuple[torch.Tensor, ...]:
    """Plain version of K7. raw: [S, V] field values of S samples per voxel;
    val: [V] old values. -> (new val [V] float32, mask [V] bool, the occupied
    count int32 [], its fraction float32 [])."""
    new = torch.maximum(val * decay, occ_from_raw(raw, mode, p, inv_s).amax(dim=0))
    if warm_floor is not None:
        new = torch.clamp(new, min=warm_floor)
    mask = new > thre
    return new, mask, mask.sum(dtype=torch.int32), occupied_fraction_plain(mask)


def occ_ema_update(raw: torch.Tensor, val: torch.Tensor, mode: str, p: float, inv_s: float,
                   decay: float, thre: float,
                   warm_floor: Optional[float]) -> Tuple[torch.Tensor, ...]:
    """K7 wrapper: the plain version on the CPU, the CUDA kernel on the card
    (one launch writes the values, the mask, the count and the fraction).
    ``warm_floor``: the least value during the warm-up, None after it.
    -> (new val, mask, count, frac)."""
    if raw.device.type == "cpu":
        return occ_ema_update_plain(raw, val, mode, p, inv_s, decay, thre, warm_floor)
    kernels.check_cuda("occ_ema_update", raw, val)
    if mode not in _MODES:
        raise ValueError(mode)
    if raw.dim() != 2 or raw.shape[0] < 1 or val.dim() != 1 or val.shape != raw.shape[1:] \
            or raw.dtype != torch.float32 or val.dtype != torch.float32:
        raise ValueError("occ_ema_update: raw must be [S >= 1, V] and val [V], float32")
    V = val.shape[0]
    if not 1 <= V < 2 ** 31:
        raise ValueError(f"occ_ema_update: needs 1 <= V < 2^31 voxels, got {V}")
    dev = val.device
    new = torch.empty_like(val)
    mask = torch.empty(val.shape, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    frac = torch.empty((), dtype=torch.float32, device=dev)
    K7.launch("occ_ema_update", kernels.ptr(raw), kernels.ptr(val), kernels.ptr(new),
              kernels.ptr(mask), kernels.ptr(kernels.ticket(dev, 2)), kernels.ptr(count),
              kernels.ptr(frac), V, raw.shape[0], _MODES[mode], float(p), float(inv_s),
              float(decay), float(thre), float("-inf") if warm_floor is None else float(warm_floor),
              float(np.float32(1) / np.float32(V)), kernels.sm_count(dev.index), kernels.stream())
    return new, mask, count, frac


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

class OccGridEma:
    """Single-instance EMA occupancy grid over an AABB space.

    ``space`` is the field's :class:`AABBSpace`; its box is read once, here,
    and kept on every device the grid is asked on, so the same grid serves
    the field on the card and a copy of it on the CPU.
    """

    # the number of grids of a [G, R, R, R] state (None: one grid [R, R, R])
    n_grids: Optional[int] = None

    def __init__(self, space, resolution: int = 64, *, occ_thre: float = 0.3,
                 ema_decay: float = 0.95, occ_val_fn: str = "sdf",
                 occ_inv_s: float = 256.0, n_steps_between_update: int = 16,
                 n_warmup_steps: int = 256, init_occupied: bool = True,
                 march_steps: int = 64, samples_per_voxel: int = 1):
        if occ_val_fn not in _MODES:
            raise ValueError(occ_val_fn)
        self.space = space
        self.res = resolution
        self.occ_thre = occ_thre
        self.ema_decay = ema_decay
        self.occ_val_fn = occ_val_fn
        self.occ_inv_s = occ_inv_s
        self.n_steps_between_update = n_steps_between_update
        self.n_warmup_steps = n_warmup_steps
        self.init_occupied = init_occupied
        self.march_steps = march_steps
        self.samples_per_voxel = max(int(samples_per_voxel), 1)
        self._aabb = (space.aabb_min.detach().cpu(), space.aabb_max.detach().cpu())
        self._boxes: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        extent = self._aabb[1] - self._aabb[0]
        self._voxel_half_diag = float(torch.linalg.norm(extent / (2.0 * resolution)))
        self._voxel_size = float(extent.max() / resolution)
        self._edges01: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def box(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(aabb_min, aabb_max) on ``device``."""
        device = torch.device(device)
        if device not in self._boxes:
            self._boxes[device] = tuple(a.to(device) for a in self._aabb)
        return self._boxes[device]

    # -- state ---------------------------------------------------------------
    def init_state(self) -> OccGridState:
        """All occupied (or all empty), on the space's device, with its
        occupied fraction (the plain mean, once a build)."""
        fill = 1.0 if self.init_occupied else 0.0
        lead = () if self.n_grids is None else (self.n_grids,)
        v = torch.full(lead + (self.res,) * 3, fill, dtype=torch.float32,
                       device=self.space.aabb_min.device)
        mask = v > self.occ_thre
        return OccGridState(v, mask, occupied_fraction_plain(mask))

    @property
    def voxel_half_diag(self) -> float:
        """Half the diagonal of one voxel, in the space's units."""
        return self._voxel_half_diag

    @property
    def voxel_size(self) -> float:
        """The longest edge of one voxel."""
        return self._voxel_size

    @property
    def raw_scale(self) -> float:
        """What :func:`occ_from_raw` scales the raw value by in this grid's
        mode: the voxel's half diagonal (sdf) or its size (density)."""
        return self._voxel_half_diag if self.occ_val_fn == "sdf" else self._voxel_size

    def _occ_from_raw(self, out: torch.Tensor) -> torch.Tensor:
        return occ_from_raw(out, self.occ_val_fn, self.raw_scale, self.occ_inv_s)

    # -- EMA update -----------------------------------------------------------
    @property
    def jitter_shape(self) -> Tuple[int, ...]:
        """The shape of :meth:`update`'s voxel jitter ``u``: samples_per_voxel
        draws a voxel, or one a voxel of each of G grids (the JAX package's
        batched and dynamic updates ignore ``samples_per_voxel``)."""
        lead = self.samples_per_voxel if self.n_grids is None else self.n_grids
        return (lead,) + (self.res,) * 3 + (3,)

    def _voxel_points(self, u: torch.Tensor, lead: Optional[str] = None):
        """Jitter u [L, R, R, R, 3] -> the points [L * R^3, 3] of every voxel
        of each of the L leading entries (samples, instances or keyframes),
        and with ``lead`` each point's instance index or keyframe time: K7's
        points kernel on the card."""
        if u is None or tuple(u.shape) != self.jitter_shape:
            raise ValueError(f"update: the voxel jitter u must be {self.jitter_shape}, got "
                             f"{None if u is None else tuple(u.shape)}")
        return occ_voxel_points(u.contiguous(), *self.box(u.device), lead)

    def _ema(self, state: OccGridState, raw: torch.Tensor, it: int) -> OccGridState:
        """K7 over the whole state: ``raw`` [S, V] field values of the V voxels
        of ``state`` (flattened in order), S samples each."""
        warm_floor = self.occ_thre + 1e-3 if it < self.n_warmup_steps else None
        val, mask, _, frac = occ_ema_update(
            raw.to(torch.float32).contiguous(), state.val.reshape(-1).contiguous(),
            self.occ_val_fn, self.raw_scale, self.occ_inv_s, self.ema_decay, self.occ_thre,
            warm_floor)
        shape = state.val.shape
        return OccGridState(val.reshape(shape), mask.reshape(shape), frac)

    @torch.no_grad()
    def update(self, state: OccGridState, query_fn: Callable[[torch.Tensor], torch.Tensor],
               u: torch.Tensor, it: int) -> OccGridState:
        """One EMA update. ``query_fn``: points [P, 3] -> raw field values [P]
        (the sdf or the density); ``u``: [samples_per_voxel, R, R, R, 3]
        uniform draws that jitter the samples inside their voxels; ``it``: the
        iteration, for the warm-up."""
        raw = query_fn(self._voxel_points(u))
        return self._ema(state, raw.reshape(self.samples_per_voxel, -1), it)

    def maybe_update(self, state: OccGridState, query_fn: Callable,
                     u: Optional[torch.Tensor], it: int) -> OccGridState:
        """:meth:`update` on the cadence ``it % n_steps_between_update == 0``
        (``it`` is a host integer, so this is a host branch); ``u`` is read
        only then."""
        if it % self.n_steps_between_update != 0:
            return state
        return self.update(state, query_fn, u, it)

    # -- queries ---------------------------------------------------------------
    def occupancy_at(self, state: OccGridState, x: torch.Tensor) -> torch.Tensor:
        """bool occupancy at points [..., 3] (False outside the box)."""
        return self._occupancy_in(state, x)

    def _occupancy_in(self, state: OccGridState, x: torch.Tensor,
                      lead: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mask at points [..., 3], of grid ``lead`` [...] of a [G, R, R, R]
        state (a negative index counts from the end, then the index is clamped
        into the G grids, as JAX's indexing gather does)."""
        mn, mx = self.box(x.device)
        x01 = (x - mn) / (mx - mn)
        inside = torch.all((x01 >= 0) & (x01 <= 1), dim=-1)
        cell = (x01 * self.res).to(torch.int32).clamp(0, self.res - 1).long()
        at = (cell[..., 0], cell[..., 1], cell[..., 2])
        if lead is not None:
            G = state.mask.shape[0]
            lead = lead.long()
            at = (torch.where(lead < 0, lead + G, lead).clamp(0, G - 1),) + at
        return state.mask[at] & inside

    def occupied_fraction(self, state: OccGridState) -> torch.Tensor:
        """The share of occupied voxels (of all G grids of a [G, R, R, R]
        state): on the card the fraction the state carries, so nothing is
        launched; on the CPU the plain mean of the mask."""
        if state.mask.device.type == "cpu":
            return occupied_fraction_plain(state.mask)
        if state.frac is None:
            raise ValueError("occupied_fraction: a state on the card carries its fraction "
                             "(from init_state, an update or the bridge)")
        return state.frac

    def edges01(self, march_steps: int, device) -> torch.Tensor:
        """The march's segment edges in [0, 1]: ``i * (1 / M)`` in float32 and
        a last edge of 1, bit for bit what ``jnp.linspace(0, 1, M + 1)`` gives
        (``torch.linspace`` rounds a fifth of the 49 edges the other way, and
        the probes are discrete in the cell index). Computed once on the CPU
        and kept per device, so the card and the CPU march the same edges."""
        key = (march_steps, torch.device(device))
        if key not in self._edges01:
            step = np.float32(1.0) / np.float32(march_steps)
            e = np.append(np.arange(march_steps, dtype=np.float32) * step, np.float32(1.0))
            self._edges01[key] = torch.from_numpy(e).to(device)
        return self._edges01[key]

    # -- ray proposal ----------------------------------------------------------
    @torch.no_grad()
    def ray_proposal(self, state: OccGridState, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     near: torch.Tensor, far: torch.Tensor, n_samples: int,
                     noise: Optional[torch.Tensor] = None,
                     march_steps: Optional[int] = None,
                     lead: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Occupancy-concentrated depth proposal: ``n_samples`` ascending
        depths per ray, all inside occupied segments of the fixed-step march
        (uniform over [near, far] for a ray that touches nothing occupied).
        ``noise``: [N, n_samples] uniform draws; None gives the deterministic
        stratum midpoints. ``lead`` [N]: each ray's grid of a [G, R, R, R]
        state (K10). -> (t [N, n_samples], valid: all True)."""
        M = march_steps or self.march_steps
        t = occ_ray_proposal(rays_o.contiguous(), rays_d.contiguous(), near.contiguous(),
                             far.contiguous(), state.mask.contiguous(), *self.box(rays_o.device),
                             self.edges01(M, rays_o.device), n_samples, noise,
                             None if lead is None else lead.to(torch.int32).contiguous())
        return t, torch.ones_like(t, dtype=torch.bool)


class OccGridEmaBatched(OccGridEma):
    """One EMA grid per instance of a shared categorical model ([B, R, R, R]
    over the model's canonical box; port of occ_grid.py:206-268)."""

    def __init__(self, space, n_instances: int, resolution: int = 32, **kw):
        super().__init__(space, resolution, **kw)
        self.n_instances = self.n_grids = n_instances

    @torch.no_grad()
    def update(self, state: OccGridState,
               query_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               u: torch.Tensor, it: int) -> OccGridState:
        """``query_fn(x [P, 3], bidx [P])`` -> each instance's raw field
        values; ``u``: [B, R, R, R, 3]. All B R^3 voxels go through K7 at once."""
        x, bidx = self._voxel_points(u, "index")
        return self._ema(state, query_fn(x, bidx).reshape(1, -1), it)

    def occupancy_at(self, state: OccGridState, x: torch.Tensor,
                     bidx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bool occupancy of instance ``bidx`` [...] (default 0) at points [..., 3]."""
        return self._occupancy_in(state, x, torch.zeros(x.shape[:-1], dtype=torch.long,
                                                        device=x.device) if bidx is None
                                  else bidx)

    def ray_proposal_batched(self, state: OccGridState, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                             n_samples: int, bidx: torch.Tensor,
                             noise: Optional[torch.Tensor] = None,
                             march_steps: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`ray_proposal` over each ray's own instance grid ``bidx`` [N] (K10)."""
        return self.ray_proposal(state, rays_o, rays_d, near, far, n_samples, noise,
                                 march_steps, lead=bidx)


class OccGridEmaDynamic(OccGridEma):
    """One EMA grid per time keyframe ([K, R, R, R]) of a time-conditioned
    field; a query picks the keyframe of its normalized time in [0, 1]
    (port of occ_grid.py:271-337)."""

    def __init__(self, space, resolution: int = 32, *, n_keyframes: int = 8, **kw):
        super().__init__(space, resolution, **kw)
        self.n_keyframes = self.n_grids = n_keyframes

    def _kf(self, t01: torch.Tensor) -> torch.Tensor:
        return (t01 * self.n_keyframes).to(torch.int32).clamp(0, self.n_keyframes - 1)

    @torch.no_grad()
    def update(self, state: OccGridState,
               query_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               u: torch.Tensor, it: int) -> OccGridState:
        """``query_fn(x [P, 3], t01 [P])`` -> raw field values at keyframe k's
        time ``(k + 0.5) / K``; ``u``: [K, R, R, R, 3]."""
        x, t01 = self._voxel_points(u, "time")
        return self._ema(state, query_fn(x, t01).reshape(1, -1), it)

    def occupancy_at(self, state: OccGridState, x: torch.Tensor,
                     t01: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bool occupancy at points [..., 3] in the keyframe of ``t01`` (default 0)."""
        return self._occupancy_in(state, x, torch.zeros(x.shape[:-1], dtype=torch.long,
                                                        device=x.device) if t01 is None
                                  else self._kf(t01.expand(x.shape[:-1])))

    def ray_proposal_dynamic(self, state: OccGridState, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                             n_samples: int, t01: torch.Tensor,
                             noise: Optional[torch.Tensor] = None,
                             march_steps: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`ray_proposal` over the keyframe grid of each ray's time
        ``t01`` [N] (K10)."""
        return self.ray_proposal(state, rays_o, rays_d, near, far, n_samples, noise,
                                 march_steps, lead=self._kf(t01))
