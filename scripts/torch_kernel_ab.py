#!/usr/bin/env python3
"""Time the redesigned kernels at the multi-object shapes in one or more
checkouts of the port, in turns, on one card.

    python3 scripts/torch_kernel_ab.py [--composite-only | --grid-latent-only |
                                        --lines-pairs-only | --grid-refresh-only |
                                        --grid4-only]
                                       [ROOT ...]

Each ROOT (default: this checkout) holds ``neuralsim_torch/`` and
``chip_smoke.py``. Each is timed in a process of its own, which builds that
checkout's kernels, in the order given: "PARENT . . PARENT" compares two
checkouts on one card (parent, change, change, parent).
``--grid4-only`` times only K3 in four dimensions (lotd_grid4) and its
backward at the StreetSurf distant field's levels (configs/waymo_streetsurf.yaml:
a dense level of 17^4 rows and 9 hash levels of 2^17, F 2) with a N(0, 1)
table, on three point sets of 524,288: the distant samples and the cotangent
of one pixel step of WAYMO_STREETSURF (8,192 rays x 64 samples), captured
once by this checkout (chip_smoke.capture_k3_4d, after the road pretrain)
into build/k3_4d_path_points.npz and handed to every root; as many
ray-ordered points (chip_smoke.k3_4d_ray_points) and as many k3_4d_points.
Each call timed with its kernels and the profiler's time by kernel name,
the forward's output sha256, the backward's error against its plain version
relative to its largest entry; first, one line of counts computed on the
host from the points: the 32-byte sectors a point's corners touch a level
(k3_sectors, the levels on 16 and on 32 bytes), the forward's load
instructions and the sectors they ask for a warp (k3_4d_loads: a load a
corner, the levels on 16 and on 32 bytes, and a 16-byte load an axis-0
pair, a route tried and slower), and the backward's device atomics
(k3_4d_atomics: a float atomic a feature a run of a corner's equal rows,
and this kernel's vector atomics).
``--grid-refresh-only`` times only the occupancy refresh around the field
query (K7 and the points it is handed): at the street's grid (128^3 x 4
samples, waymo_demo_multi's, in the box GRID_BOX), the bench model's (128^3
x 1) and the crowd's (8 instance grids of 32^3), on seeded jitter, field
values (normal, 0.2) and old values: the voxel points (``_voxel_points``:
the kernel where the checkout has one, else the plain pass on the card),
K7 over the grid (``_ema``), ``occupied_fraction`` of its result, and the
refresh with a query that hands back those values (no field), each timed
with its kernels a call and the sha256 of the points, the values, the mask
and the fraction (beside the sha256 of the plain mean of the same mask);
then the street's refresh through the street field of
``build_compose_renderer(WAYMO_DEMO_MULTI)`` (seeded weights, the grid
converged on the drive's ground) by chip_smoke.time_refresh (host and busy
ms, the field query alone, peak MiB). ``--lines-pairs-only``
times only K14's forward and K11: K14 at the street's, the vehicles', the
bench ladder's and synthetic_object's stacked lines and at
chip_smoke.CP_LINES_EDGES, alone and as the path makes K1's input (where the
checkout's K14 writes float32 lines only, the lines and their bf16 cast),
with the sha256 of the float32 and the bf16 lines and the kernels a call;
K11 at the crowd's training call ([8, 4,096], a budget of 4,096 rows, slots
M 4, ~1,708 hits) and render call (no slots, ~1,815 hits) and at
synthetic_multi's ([2, 2,048], 2,048 rows, M 4, ~606 hits) on seeded masks,
and at chip_smoke.pair_edge_masks (digests only), with the sha256 of every
output and the kernels a call; and the ``-Xptxas -v`` lines of both
sources. ``--grid-latent-only``
times only K3's forward and the latent lookup (K13) with its backward:
K3 at synthetic_object's render chunk (4,096 rays x 96 samples on its two
hash levels) and at the vehicles' final query (6,144 rows x 32 samples on
their two dense levels), with and without the jacobian, each with the sha256
of its outputs, its kernels a call, the profiler's device time by kernel
name (and, where the checkout keeps K3's interleaved copy across calls,
timed so, one kernel a call), and the L2 sectors its corners touch (a corner's F features one row of
a [size, F] copy) beside the card's L2 rate as this script measures it (the
faster of a sum and a copy of a 16 MB buffer held in L2; a lower bound of
the rate, so the gather bound it gives is an upper one); K3 at
chip_smoke.k3_edge_cases and K13 at chip_smoke.latent_edge_cases, each
output's sha256; K13 forward and backward at the main path's pixel step
(196,608 points, one index a ray of 32 samples, 3 runs; the cotangent a
column slice at 32 of a [P, 40] gradient), the crowd's (131,072 points, 8
instances, 1,804 runs) and the uniform eikonal's (512 points, int64 zeros),
with the sha256 of each output, the kernels a call and, for the backward,
whether two calls give the same bits. Otherwise, first K6 and
K12 (``--composite-only``: only they), forward and backward, each with the
sha256 of every output: K6 at the bench model's step (8,192 rays of 64
lanes, a close-range and a distant buffer, with rgb and nablas, cotangents
of every output), K12 at the multi-object LiDAR step's street buffer (2,048
beams of 48 samples, no rgb) and at synthetic_object's render chunk (4,096
rays of 96 samples, with rgb), at cos anneal 0.5 and inv_s 300. The other
shapes are the multi-object iteration's (WAYMO_DEMO_MULTI): K5a at its five stage launches
(the street's 32 + 8 and 40 + 8 at 4,096 pixel rays and 2,048 beams, the
vehicles' 24 + 8 at 6,144 rows) and synthetic_object's 80 + 16 at 4,096
rays, with drawn noise, with the weights and, where the checkout can skip
them, without, each with the sha256 of its outputs' bytes (equal digests
in two checkouts: the same bits); K8 forward (the compose render's, no
gradient) and forward + backward under autograd (the pixel step's) at the
merged buffer's [4,096, 168] and at [64, 1,100]; K5b at the street's stages (32
and 40 samples + 8 draws at 4,096 pixel rays and 2,048 beams) and the
vehicles' (24 + 8 at 6,144 compacted rows), synthetic_object's render stage
(80 + 16 at 4,096 rays) and the bench model's (24 + 8 at 8,192), beside a
stable torch.sort of the keys; K3's backward at the vehicles' final query (3 x 2,048 rows x 32
samples, two dense levels of F 4), at their uniform eikonal (512 points), with
every point in one cell, and at synthetic_object's two hash levels (2,048
rays x 96 samples); K1's backward at the street's pixel and LiDAR steps, the
vehicles' final query and each model's uniform eikonal (512 points); K2's
backward (NEURALSIM_CP_STACKED=0) at the same five launches and the bench
ladder's (8,192 rays x 32 samples); where K3's backward takes a plan, its
private and atomics paths each forced at 512, 32,768 and 196,608 of the
vehicles' points; the latent lookup forward and backward through the
conditional LoTD field's decoder input (K13 where the checkout has it,
``latents[idx]`` and its sort-based index_put before) at the main path's
196,608 points (3 runs) and the crowd's (8 instances round-robin), and the
stacked lines forward and backward through ``cp_stacked_lines`` (K14 where
the checkout has it, the plain glue before) for the street and the
vehicles, each with the device kernels that one call launches, and K14's
backward alone at the street, the vehicles, the bench ladder,
synthetic_object and an edge ladder (R 1, 2, 37, 1,024 x 2); K4 at the
street's pixel step (4,096 rays, 64 segments, 32 draws), its LiDAR step
(2,048 beams) and the bench model (8,192, 48, 16), and K10 at the crowd's
per-instance grids (4,096 rows, [8, 32^3]), with noise and with the
midpoints, each with the sha256 of its depths and the kernels a call; K9 (the
permutohedral lattice) at the permuto path's shapes: its forward with the
jacobian at the pixel step's final query (196,608 points, d 11), without it
at the upsample ladder's 147,456, its backward from both cotangents, on
uniform points and on depth-sorted ray samples (this checkout's
``permuto_ray_points``, the order the pixel step queries in), and
PermutoNeuSObj's d 3 ladder alike, then forward and backward through
``PermutoEncoding.with_jacobian`` under autograd with the kernels a call
launches (the layout copies around K9 show there). Each checkout's K9 takes
its own arguments and cotangent layout: where its functions take the
lattice constants (``lat``), feature-major cotangents ([C, N], [3, C, N]),
else point-major ones.
Every root is timed by this checkout's chip_smoke.py: "ms", CUDA events over
20 calls back to back (``cuda_ms``: the host's pace where it is the slower);
"queued_ms", the same while the card was held busy as the host queued them;
"prof_ms", the device time of the call's kernels under torch.profiler, a
call; "host_ms", the host's time a call. Prints one JSON line per root, with
the card's name and power limit.
"""
from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# K4's and K10's launches (label, rays, march segments, draws, grids G or
# None, resolution): the street's proposal at the pixel step's rays and the
# LiDAR step's beams, the bench model's, the crowd's per-instance grids
# the refresh's grids (label, kind, leading entries, resolution): the
# street's (samples a voxel), the bench model's, the crowd's (instances)
GRID_SHAPES = (("street", "single", 4, 128), ("bench", "single", 1, 128),
               ("crowd", "batched", 8, 32))
GRID_BOX = ((-40.0, -25.0, -3.0), (60.0, 25.0, 9.5))
K4_SHAPES = (("K4 street pixel step", 4096, 64, 32, None, 128),
             ("K4 street LiDAR step", 2048, 64, 32, None, 128),
             ("K4 bench", 8192, 48, 16, None, 128),
             ("K10 crowd", 4096, 64, 24, 8, 32))
# K12's launches (label, rays, samples, with rgb)
K12_SHAPES = (("LiDAR step", 2048, 48, False), ("synthetic_object render chunk", 4096, 96, True))
# K5a's launches (rays, samples, draws, inv_s): the multi-object iteration's
# five (the street's two stages at the pixel step's rays and the LiDAR
# step's beams, the vehicles' one stage at their 3 x 2,048 rows) and
# synthetic_object's second render stage
K5A_SHAPES = ((4096, 32, 8, 64.0), (4096, 40, 8, 256.0), (2048, 32, 8, 64.0),
              (2048, 40, 8, 256.0), (6144, 24, 8, 64.0), (4096, 80, 16, 256.0))


def timer():
    """This checkout's chip_smoke.py, whatever the root being timed."""
    spec = importlib.util.spec_from_file_location("ab_timing", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cp_launches(cs, street, veh):
    """K1's and K2's launches in a multi-object iteration: each model's final
    query (the street's at a pixel and a LiDAR step) and uniform eikonal ->
    [(label, encoding, points)]."""
    return [("street, pixel step", street, cs.ray_points(4096, 48, street.cp_rmax, 30)),
            ("street, LiDAR step", street, cs.ray_points(2048, 48, street.cp_rmax, 30)),
            ("vehicles", veh, cs.ray_points(6144, 32, veh.cp_rmax, 30)),
            ("street, uniform eikonal", street, cs.enc_points(512, street.cp_rmax, 34)),
            ("vehicles, uniform eikonal", veh, cs.enc_points(512, veh.cp_rmax, 34))]


def digest(x) -> str:
    """sha256 of a tensor's bytes (a bf16 tensor's as int16)."""
    import torch
    x = x.detach().cpu().contiguous()
    return hashlib.sha256((x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
                          .numpy().tobytes()).hexdigest()


def f_cp(plan) -> int:
    """The stacked features of a K14 plan, in this checkout's form or an
    earlier one's (a [F_cp, 4] column table)."""
    return plan.n_cols if hasattr(plan, "n_cols") else plan.cols.shape[0]


def kernels_a_call(fn) -> int:
    """The device kernels (memsets included) of one call of fn, by the
    profiler, after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def digests(prefix, outs) -> dict:
    """The sha256 of each output of a call that has one."""
    return {f"{prefix}{i}_sha256": digest(x) for i, x in enumerate(outs) if x is not None}


def prof_by_name(fn, reps: int = 20) -> dict:
    """The profiler's device time a call (ms) of each kernel name that one
    call of fn launches, after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def l2_rate(tm, dev) -> float:
    """Bytes a second that torch's sum and copy reach on a 16 MB buffer held
    in L2 (queued, after a warm-up): the faster of the two."""
    import torch
    x = torch.rand(4 << 20, device=dev)
    y = torch.empty_like(x)
    nbytes = x.numel() * 4
    return max(nbytes / (tm.cuda_ms(lambda: x.sum(), reps=50, queued=True) * 1e-3),
               2 * nbytes / (tm.cuda_ms(lambda: y.copy_(x), reps=50, queued=True) * 1e-3))


def corner_rows(pts, level):
    """The rows of every corner of every point on one level (res, size, _, F,
    is_hash, _), as the kernels form them: int64 [N, 2^D], D the points'
    dimension (3 or 4), corner c taking cell_i + bit i of c."""
    import numpy as np
    res, size, _, _, is_hash, _ = level
    D = pts.shape[1]
    x = np.clip(pts, 0.0, 1.0).astype(np.float32)
    primes = np.array([1, 2654435761, 805459861, 3674653429][:D], dtype=np.uint64)
    pos = x * np.float32(res)
    cell = np.minimum(np.floor(pos), np.float32(res - 1)).astype(np.int64)
    out = []
    for corner in range(1 << D):
        ci = cell + np.array([(corner >> i) & 1 for i in range(D)])
        if is_hash:
            u = ci.astype(np.uint64) * primes & np.uint64(0xFFFFFFFF)
            h = u[:, 0]
            for i in range(1, D):
                h = h ^ u[:, i]
            row = (h % np.uint64(size)).astype(np.int64)
        else:
            row = sum(ci[:, i] * (res + 1) ** i for i in range(D))
        out.append(np.clip(row, 0, size - 1))
    return np.stack(out, 1)


def k3_sectors(pts, rows, starts=None) -> int:
    """The 32-byte sectors that the corners of each point touch on each level,
    a corner's F features one row of a [size, F] copy, counted per point and
    level (what a launch that keeps nothing in L1 reads from L2); points of 3
    or 4 dimensions. ``starts``: each level's first float in its copy (its
    sector alignment; default 0, every level on a sector)."""
    import numpy as np
    total = 0
    for l, level in enumerate(rows):
        nf = level[3]
        start = 0 if starts is None else starts[l]
        secs = np.sort((start + corner_rows(pts, level) * nf) * 4 // 32, 1)
        total += int(secs.shape[0] + (secs[:, 1:] != secs[:, :-1]).sum())
    return total


def k3_4d_loads(pts, rows, starts, paired):
    """K3-4D's loads of a launch at F 2, by warps of 32 consecutive points: the
    load instructions a warp issues (a corner each; or, ``paired``, the route
    measured and not taken: a 16-byte load of the aligned pair of rows
    holding corner c's row for each axis-0 pair c, c | 1, and corner c | 1's
    row apart where some lane's pair is not r, r ^ 1), and the distinct
    32-byte sectors each instruction asks for over its lanes (what L1 asks of
    L2 where it keeps nothing between instructions). ``starts``: each level's
    first float in the scratch."""
    import numpy as np
    n = pts.shape[0]
    W = -(-n // 32)
    inst = secs = 0

    def distinct(s, m):  # [W, 32] sectors, m the lanes that ask
        s = np.where(m, s, -1)
        s = np.sort(s, 1)
        return int(((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum() + (s[:, 0] >= 0).sum())

    for l, level in enumerate(rows):
        nf = level[3]
        r = np.full((W * 32, 16), -1, np.int64)
        r[:n] = corner_rows(pts, level)
        r = r.reshape(W, 32, 16)
        valid = (np.arange(W * 32) < n).reshape(W, 32)
        sec = lambda row: (starts[l] + row * nf) * 4 // 32
        if not paired:
            for c in range(16):
                inst += W
                secs += distinct(sec(r[..., c]), valid)
            continue
        for c in range(0, 16, 2):
            r0, r1 = r[..., c], r[..., c + 1]
            inst += W
            secs += distinct(sec(r0 & ~1), valid)
            apart = valid & ((r0 ^ r1) != 1)
            inst += int(apart.any(1).sum())
            secs += distinct(sec(r1), apart)
    return {"load_instructions": inst, "sectors_asked": secs}


def k3_4d_atomics(pts, rows):
    """The device atomics of K3-4D's backward at a launch of ``pts`` (F 2, in
    warps of 32 consecutive points), by the design that issues them:
    ``before``, the runs of equal rows of one corner in neighbouring lanes
    summed, a float atomic a feature a run; ``after``, the runs of equal
    cells summed (every corner), a corner pair of rows r, r ^ 1 one float4
    and any other pair two float2, a run's bit-3 corners (bit-3-clear
    corners) left to the next run where its cell is this one's plus (minus)
    one on axis 3."""
    import numpy as np
    n = pts.shape[0]
    W = -(-n // 32)
    before = f4 = f2 = taken = 0
    valid = (np.arange(W * 32) < n).reshape(W, 32)
    for level in rows:
        res, nf = level[0], level[3]
        r = np.full((W * 32, 16), -1, np.int64)
        r[:n] = corner_rows(pts, level)
        r = r.reshape(W, 32, 16)
        for c in range(16):
            head = np.ones((W, 32), bool)
            head[:, 1:] = r[:, 1:, c] != r[:, :-1, c]
            before += int((head & valid).sum()) * nf
        x = np.clip(pts, 0.0, 1.0).astype(np.float32) * np.float32(res)
        cell = np.full((W * 32, 4), -2, np.int64)
        cell[:n] = np.minimum(np.floor(x), np.float32(res - 1)).astype(np.int64)
        cell = cell.reshape(W, 32, 4)
        head = np.ones((W, 32), bool)
        head[:, 1:] = (cell[:, 1:] != cell[:, :-1]).any(-1)
        # each lane's next run start (32: none)
        nxt = np.full((W, 32), 32)
        for lane in range(30, -1, -1):
            nxt[:, lane] = np.where(head[:, lane + 1], lane + 1, nxt[:, lane + 1])
        e3 = np.array([0, 0, 0, 1])
        nc = np.take_along_axis(cell, np.minimum(nxt, 31)[..., None], 1)
        pc = np.concatenate([cell[:, :1], cell[:, :-1]], 1)
        live = head & valid & (nxt < 32) & (cell[..., 3] >= 0)
        first = np.zeros((W, 32), bool)
        first[:, 0] = True
        # a run gives no half that it may take into
        up = live & (nc == cell + e3).all(-1) & (first | ~(pc == cell + e3).all(-1))
        down = live & (nc == cell - e3).all(-1) & (first | ~(pc == cell - e3).all(-1))
        taken += int((up | down).sum())
        hv = head & valid
        for q in range(0, 8, 2):
            for c, skip in ((q, down), (q | 8, up)):
                pair = (r[..., c] ^ r[..., c | 1]) == 1
                m = hv & ~skip
                f4 += int((m & pair).sum())
                f2 += 2 * int((m & ~pair).sum())
    return {"before": {"float": before},
            "after": {"float4": f4, "float2": f2, "total": f4 + f2,
                      "runs_giving_half_their_corners": taken}}


def scratch_starts(rows, align):
    """Each level's first float in the interleaved scratch when every level
    goes there, each F x size rounded up to ``align`` floats."""
    starts, at = [], 0
    for level in rows:
        starts.append(at)
        at += -(-level[1] * level[3] // align) * align
    return starts


def zeros_out(C, N, dev, jac):
    """K3's outputs, zeroed: features [C, N] and, where ``jac``, [3, C, N]."""
    import torch
    return (torch.zeros((C, N), device=dev),
            torch.zeros((3, C, N), device=dev) if jac else None)


def grid_latent(tm, out, dev, timed) -> None:
    """K3's forward and K13 with its backward, with the digests of their
    outputs (see the module's docstring)."""
    import numpy as np
    import torch
    from neuralsim_torch.configs import SYNTHETIC_OBJECT, WAYMO_DEMO_MULTI
    from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.ops.latent_take import latent_take, latent_take_bwd

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rate = l2_rate(tm, dev)
    out["l2_bytes_per_s"] = rate
    # a K3 that takes a plan is handed the encoding's, as the module does
    planned = "plan" in inspect.signature(lotd.lotd_grid).parameters
    mp = WAYMO_DEMO_MULTI["assetbank_cfg"]
    veh = ConditionalLoTDNeuSField(
        n_instances=3, encoding_cfg=mp["Vehicle"]["model_params"]["encoding_cfg"]).encoding
    obj = lotd.make_lotd(SYNTHETIC_OBJECT["assetbank_cfg"]["Main"]["model_params"]["encoding_cfg"])
    for e in (veh, obj):
        e.reset_parameters(torch.Generator().manual_seed(0))
    veh, obj = veh.to(dev), obj.to(dev)
    for label, e, pts in (("synthetic_object render chunk, hash levels", obj,
                           tm.ray_points(4096, 96, obj.cp_rmax, 0)),
                          ("vehicles' final query, dense levels", veh,
                           tm.ray_points(6144, 32, veh.cp_rmax, 30))):
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        rows = e._grid_meta.tolist()
        kw = {"plan": e.grid_fwd_plan} if planned else {}
        sectors = k3_sectors(pts, rows)
        for jac in (False, True):
            buf = zeros_out(C, N, dev, jac)
            fn = lambda: lotd.lotd_grid(e.table.detach(), x, e._grid_meta, *buf, **kw)
            tag = f"K3 fwd {label} N={N} levels={[r[0] for r in rows]} F={rows[0][3]} jac={jac}"
            res = {**timed(fn), "kernels": kernels_a_call(fn), "by_kernel": prof_by_name(fn)}
            res.update(digests("out", buf))
            cols = sum(r[3] for r in rows)
            res["bytes_bound_ms"] = (N * 12 + N * cols * 4 * (4 if jac else 1)) \
                / tm.HBM_BYTES_PER_S * 1e3
            res["l2_sectors"] = sectors
            res["gather_bound_ms"] = sectors * 32 / rate * 1e3
            out[tag] = res
            if hasattr(lotd, "GridScratch") and e.grid_fwd_plan.n_inter:
                # as the encoding calls it: the interleaved copy kept from the
                # first call (the table unchanged), so a call is one kernel
                sc, table = lotd.GridScratch(), e.table.detach()
                fn = lambda: lotd.lotd_grid(table, x, e._grid_meta, *buf, **kw, scratch=sc)
                out[tag + " scratch kept"] = {**timed(fn), "kernels": kernels_a_call(fn)}
    if hasattr(tm, "k3_edge_cases"):
        for label, table, x, meta, C, _ in tm.k3_edge_cases(dev, with_plans=False):
            for jac in (False, True):
                buf = zeros_out(C, x.shape[0], dev, jac)
                lotd.lotd_grid(table, x, meta, *buf)
                out[f"K3 fwd edge {label} jac={jac}"] = digests("out", buf)
    for i, (label, n, z, idx, P, ld) in enumerate(tm.latent_edge_cases(dev)):
        lat = tm.cotangents((n, z), 70 + i, dev)
        out[f"K13 edge {label}"] = digests("out", [latent_take(lat, idx, P)])

    rng = np.random.default_rng(9)
    cuts = np.sort(rng.choice(np.arange(1, 4096), 1803, replace=False))
    inst = np.cumsum(rng.integers(1, 8, 1804)) % 8          # neighbouring runs differ
    crowd = np.repeat(inst, np.diff(np.concatenate([[0], cuts, [4096]])))
    for label, n, idx, P in (("main path pixel step: 6,144 rays x 32, 3 runs", 3,
                              np.repeat(np.arange(3), 2048), 196_608),
                             ("crowd: 4,096 rays x 32, 1,804 runs", 8, crowd, 131_072),
                             ("uniform eikonal: 512 points of instance 0", 3,
                              np.zeros(512, np.int64), 512)):
        b = T(idx)
        lat = tm.cotangents((n, 8), 71, dev)
        fn = lambda: latent_take(lat, b, P)
        out[f"K13 fwd {label} P={P} n={n} z=8"] = {
            **timed(fn), "kernels": kernels_a_call(fn), **digests("out", [fn()]),
            "bytes_bound_ms": (idx.size * 8 + n * 32 + P * 32) / tm.HBM_BYTES_PER_S * 1e3}
        g = tm.cotangents((P, 40), 81, dev)[:, 32:]
        fn = lambda: latent_take_bwd(g, b, n)
        got = fn()
        out[f"K13 bwd {label} P={P} n={n} z=8 ld=40"] = {
            **timed(fn), "kernels": kernels_a_call(fn), **digests("grad", [got]),
            "same_bits_twice": bool(torch.equal(got, fn())),
            "bytes_bound_ms": (idx.size * 8 + P * 32 + n * 32) / tm.HBM_BYTES_PER_S * 1e3}


# the 4-D LoTD of configs/waymo_streetsurf.yaml's distant field
DISTANT4 = {"n_levels": 10, "base_res": 16, "max_res": 1024, "log2_hashmap_size": 17}
K3_4D_N = 524_288


def capture_path_points(path) -> None:
    """One StreetSurf pixel step's distant samples and their cotangent
    (chip_smoke.capture_k3_4d on WAYMO_STREETSURF built at full width through
    build_everything, its road pretrain included), saved to ``path`` (.npz)."""
    import copy as copy_
    import numpy as np
    import torch
    tm = timer()
    from neuralsim_torch.configs import WAYMO_STREETSURF
    from neuralsim_torch.tools.build import build_everything
    from neuralsim_torch.tools.train import build_samplers
    cfg = copy_.deepcopy(WAYMO_STREETSURF)
    scene, _, _, trainer, state, loader = build_everything(cfg)
    samplers = build_samplers(cfg["training"], loader, int(cfg["seed"]))
    dev = torch.device("cuda")
    x, d_out = tm.capture_k3_4d(scene, tm.SingleStepTrainer(trainer), state, samplers, dev)
    np.savez(path, x=x.cpu().numpy(), d_out=d_out.cpu().numpy())


def point_sets(tm, path_file):
    """K3-4D's point sets (label -> (points, cotangent seed or the captured
    cotangent)): a pixel step's own (captured), as many ray-ordered points
    (chip_smoke.k3_4d_ray_points) and as many k3_4d_points."""
    import numpy as np
    sets = {}
    if path_file:
        z = np.load(path_file)
        sets["captured pixel step"] = (z["x"], z["d_out"])
    sets["ray-ordered"] = (tm.k3_4d_ray_points(K3_4D_N, 507), None)
    sets["k3_4d_points"] = (tm.k3_4d_points(K3_4D_N, 501), None)
    return sets


def grid4(tm, out, dev, timed, path_file) -> None:
    """K3-4D forward and backward at the distant field's levels on each point
    set (see point_sets), a N(0, 1) table: each timed, with its kernels a
    call and the profiler's time by kernel name, the forward's output
    sha256, the backward's largest error against its plain version relative
    to its largest entry."""
    import numpy as np
    import torch
    from neuralsim_torch.fields.encodings import lotd
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    enc = lotd.make_lotd(DISTANT4, input_dim=4).to(dev)
    table = T(np.random.default_rng(500).normal(size=enc.total_params).astype(np.float32))
    meta, C, n_table = enc._grid_meta, enc.out_dim, enc.total_params
    bplan = enc.grid_bwd_plan if "plan" in inspect.signature(lotd.lotd_grid_bwd).parameters \
        else None
    for label, (pts, cot) in point_sets(tm, path_file).items():
        x = T(pts)
        N = x.shape[0]
        d_out = T(cot) if cot is not None else tm.cotangents((C, N), 601, dev)
        buf = torch.empty((C, N), device=dev)
        fn = lambda: lotd.lotd_grid(table, x, meta, buf, None, plan=enc.grid_fwd_plan)
        fn()
        res = {**timed(fn), "kernels": kernels_a_call(fn), "by_kernel": prof_by_name(fn)}
        res.update(digests("out", [buf]))
        out[f"K3-4D fwd {label} N={N}"] = res
        kw = {} if bplan is None else {"plan": bplan}
        fn = lambda: lotd.lotd_grid_bwd(n_table, x, meta, d_out, None, **kw)
        got = fn()
        want = lotd.lotd_grid_bwd_plain(n_table, x, meta, d_out, None)
        out[f"K3-4D bwd {label} N={N}"] = {
            **timed(fn), "kernels": kernels_a_call(fn), "by_kernel": prof_by_name(fn),
            "rel_err": float((got - want).abs().max() / want.abs().max())}


def grid4_counts(path_file) -> dict:
    """The loads, sectors and atomics of a K3-4D launch on each point set,
    by the design before this kernel and by this one (k3_4d_loads,
    k3_4d_atomics, with the scratch's levels on 16 and on 32 bytes)."""
    import numpy as np
    tm = timer()
    sys.path.insert(0, str(HERE))
    from neuralsim_torch.fields.encodings import lotd
    rows = lotd.make_lotd(DISTANT4, input_dim=4)._grid_meta.tolist()
    out = {}
    for label, (pts, _) in point_sets(tm, path_file).items():
        pts = np.asarray(pts, np.float32)
        s16, s32 = scratch_starts(rows, 4), scratch_starts(rows, 8)
        out[label] = {
            "sectors_per_point_level": {"before": k3_sectors(pts, rows, s16),
                                        "after": k3_sectors(pts, rows, s32)},
            "fwd_loads": {"before": k3_4d_loads(pts, rows, s16, False),
                          "after": k3_4d_loads(pts, rows, s32, False),
                          "pairs_tried": k3_4d_loads(pts, rows, s32, True)},
            "bwd_atomics": k3_4d_atomics(pts, rows)}
    return out


# K11's calls on the main path (label, K, N, Bg, M, hits): the crowd's
# training and render calls and synthetic_multi's, their hit counts those of
# the path's own calls on the card (chip_smoke.py's log)
K11_CALLS = (("crowd training call", 8, 4096, 4096, 4, 1708),
             ("crowd render call", 8, 4096, 4096, None, 1815),
             ("synthetic_multi training call", 2, 2048, 2048, 4, 606))


def k11_mask(K, N, hits, seed):
    """A [K, N] mask of about ``hits`` hits: each instance a box, a run of
    neighbouring rays (one instance with none), as a camera sees a vehicle."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hit = np.zeros((K, N), bool)
    per = hits // max(K - 1, 1)
    for k in range(1 if K > 1 else 0, K):
        start = int(rng.integers(0, N - per))
        hit[k, start:start + per] = rng.random(per) < 0.95
    return hit


def lines_pairs(tm, out, dev, timed) -> None:
    """K14's forward and K11 (see the module's docstring)."""
    import numpy as np
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import BENCH_OBJECT, SYNTHETIC_OBJECT, WAYMO_DEMO_MULTI
    from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.ops.pair_compact import pair_compact

    build = kernels.build_log.splitlines()
    out["ptxas"] = [line.strip() for i, line in enumerate(build)
                    if ("registers" in line or "spill" in line or "entry function" in line)
                    and any(k in " ".join(build[max(0, i - 3):i + 1])
                            for k in ("pair_compact", "cp_lines_kernel"))]
    mp = WAYMO_DEMO_MULTI["assetbank_cfg"]
    encs = (("street", lotd.make_lotd(mp["Street"]["model_params"]["encoding_cfg"])),
            ("vehicles", ConditionalLoTDNeuSField(
                n_instances=3, encoding_cfg=mp["Vehicle"]["model_params"]["encoding_cfg"]
            ).encoding),
            ("bench ladder", lotd.make_lotd(BENCH_OBJECT["models"]["cr"]["params"]
                                            ["encoding_cfg"])),
            ("synthetic_object", lotd.make_lotd(SYNTHETIC_OBJECT["assetbank_cfg"]["Main"]
                                                ["model_params"]["encoding_cfg"])))
    sets = []
    for label, e in encs:
        e.reset_parameters(torch.Generator().manual_seed(0))
        e = e.to(dev)
        sets.append((label, e.table.detach(), e.cp_lines_plan(), True))
    sets += [(label, table, plan, False) for label, table, plan in tm.cp_lines_sets(dev, [])]
    for label, table, plan, path in sets:
        L, Rmax = plan.lo.shape
        got = lotd.lotd_cp_lines(table, plan)
        both = isinstance(got, tuple)          # this checkout's K14 writes the bf16 lines too
        f32, bf16 = got if both else (got, got.to(torch.bfloat16))
        tag = f"K14 {label} L={L} F_cp={f_cp(plan)} R_max={Rmax}"
        res = {"f32_sha256": digest(f32), "bf16_sha256": digest(bf16)}
        if path:
            fn = lambda: lotd.lotd_cp_lines(table, plan)
            k1_input = fn if both else (lambda: lotd.lotd_cp_lines(table, plan)
                                        .to(torch.bfloat16))
            res.update(**timed(fn), kernels=kernels_a_call(fn),
                       **timed(k1_input, "k1_input_"), k1_input_kernels=kernels_a_call(k1_input))
        out[tag] = res
    for i, (label, K, N, Bg, M, hits) in enumerate(K11_CALLS):
        hit = torch.from_numpy(k11_mask(K, N, hits, 50 + i)).to(dev)
        fn = lambda: pair_compact(hit, Bg, M)
        out[f"K11 {label} [{K}, {N}] Bg={Bg} M={M} hits={int(hit.sum())}"] = {
            **timed(fn), "kernels": kernels_a_call(fn), **digests("out", fn())}
    for label, hit, Bg, M in tm.pair_edge_masks(dev):
        out[f"K11 edge {label} Bg={Bg} M={M}"] = digests("out", pair_compact(hit, Bg, M))


def grid_refresh(tm, out, dev, timed) -> None:
    """The occupancy refresh around the field query (see the module's
    docstring)."""
    import torch
    from neuralsim_torch.accel import OccGridEma, OccGridEmaBatched
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI
    from neuralsim_torch.dataio.waymo_demo import ground_sdf_tensor
    from neuralsim_torch.fields.spatial import AABBSpace
    from neuralsim_torch.tools.build import build_compose_renderer, converge_occ

    space = AABBSpace(*GRID_BOX).to(dev)
    for label, kind, L, R in GRID_SHAPES:
        accel = OccGridEma(space, R, samples_per_voxel=L) if kind == "single" \
            else OccGridEmaBatched(space, L, R)
        gen = torch.Generator(device=dev).manual_seed(60)
        u = torch.rand(accel.jitter_shape, generator=gen, device=dev)
        S, V = (L, R ** 3) if kind == "single" else (1, L * R ** 3)
        raw = torch.randn((S, V), generator=gen, device=dev) * 0.2
        val = torch.rand(accel.init_state().val.shape, generator=gen, device=dev)
        st = type(accel.init_state())(val, val > accel.occ_thre)
        tag = f"{label} [{L}, {R}^3]"
        points = lambda: accel._voxel_points(u)
        out[f"points {tag}"] = {**timed(points), "kernels": kernels_a_call(points),
                                "sha256": digest(points())}
        ema = lambda: accel._ema(st, raw, 1000)
        new = ema()
        frac = lambda: accel.occupied_fraction(new)
        out[f"K7 {tag} S={S}"] = {
            **timed(ema), "kernels": kernels_a_call(ema), "val_sha256": digest(new.val),
            "mask_sha256": digest(new.mask), "frac": float(frac()),
            "frac_sha256": digest(frac()), "plain_mean_sha256": digest(new.mask.float().mean())}
        out[f"occupied_fraction {tag}"] = {**timed(frac), "kernels": kernels_a_call(frac)}
        flat = raw.reshape(-1)
        refresh = lambda: accel.update(st, lambda x, *lead: flat, u, 1000)
        out[f"refresh without the field {tag}"] = {**timed(refresh),
                                                   "kernels": kernels_a_call(refresh)}
    C = WAYMO_DEMO_MULTI
    _, _, renderer, params = build_compose_renderer(C, device=dev)
    accel = renderer.accels["cr"]
    st = converge_occ(accel, accel.init_state(), ground_sdf_tensor, seed=int(C["seed"]),
                      **C["occ_converge"])
    field = params[renderer.scene_models["cr"][0]]
    out[f"street refresh through the field [{accel.samples_per_voxel}, {accel.res}^3]"] = \
        tm.time_refresh(accel, st, field, dev)


def time_root(root: str, mode: str = "all") -> dict:
    tm = timer()
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import BENCH_OBJECT, SYNTHETIC_OBJECT, WAYMO_DEMO_MULTI
    from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.neus import upsample_weights_pdf
    from neuralsim_torch.ops.segment import cross_source_vw, merge_sorted_samples

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: CUDA is not available")
    if Path(kernels.__file__).resolve().parents[1] != Path(root).resolve():
        raise SystemExit(f"torch_kernel_ab: imported the port from {kernels.__file__}")
    kernels.library()
    dev = torch.device("cuda")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    planned = "plan" in inspect.signature(lotd.lotd_grid_bwd).parameters
    out = {"root": root, "k3_bwd_takes_a_plan": planned}

    def timed(fn, prefix=""):
        return {prefix + "ms": tm.cuda_ms(fn), prefix + "queued_ms": tm.cuda_ms(fn, queued=True),
                prefix + "prof_ms": tm.prof_ms(fn), prefix + "host_ms": tm.host_ms(fn)}

    if mode == "grid4":
        grid4(tm, out, dev, timed, os.environ.get("K3_4D_PATH_POINTS"))
        out["card"] = card()
        return out
    if mode == "grid-latent":
        grid_latent(tm, out, dev, timed)
        out["card"] = card()
        return out
    if mode == "lines-pairs":
        lines_pairs(tm, out, dev, timed)
        out["card"] = card()
        return out
    if mode == "grid-refresh":
        grid_refresh(tm, out, dev, timed)
        out["card"] = card()
        return out

    # K6 at the bench model's step and K12 at the LiDAR step and at
    # synthetic_object's render chunk, forward and backward, on this
    # checkout's seeded inputs, with the digests of their outputs (outputs
    # in the wrappers' order: K6 vw, mask, depth, rgb, normals, count; its
    # backward d alpha, d rgb, d nablas; K12 those and alpha; its backward
    # d sdf, d nablas, d rgb, d inv_s a ray)
    from neuralsim_torch.renderers.buffers import volume_composite, volume_composite_bwd
    from neuralsim_torch.renderers.neus_composite import neus_composite, neus_composite_bwd
    n, s = 8192, 64
    a = [T(v) for v in tm.composite_inputs(n, s, 5, two_buffers=True)]
    cots = [tm.cotangents(sh, 13 + i, dev)
            for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3)))]
    out[f"K6 bench {n} S={s} two buffers"] = {
        **timed(lambda: volume_composite(*a)), **digests("out", volume_composite(*a))}
    out[f"K6 bwd bench {n} S={s} two buffers"] = {
        **timed(lambda: volume_composite_bwd(*a, *cots)),
        **digests("grad", volume_composite_bwd(*a, *cots))}
    inv_s = torch.tensor(300.0, device=dev)
    for label, n, s, with_rgb in K12_SHAPES:
        t, mask, sdf, nablas, d, rgb = (T(v) for v in tm.neus_inputs(n, s, 4))
        a = (t, mask, sdf, nablas, d, 0.5, inv_s, rgb if with_rgb else None)
        cots = [tm.cotangents(sh, 8 + i, dev)
                for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3), (n, s)))]
        if not with_rgb:
            cots[3] = None
        tag = f"K12 {label} {n} S={s}{' rgb' if with_rgb else ''}"
        out[tag] = {**timed(lambda: neus_composite(*a)), **digests("out", neus_composite(*a))}
        out[tag.replace("K12", "K12 bwd")] = {
            **timed(lambda: neus_composite_bwd(*a, *cots)),
            **digests("grad", neus_composite_bwd(*a, *cots))}
    if mode == "composite":
        out["card"] = card()
        return out

    # K5a at the multi-object iteration's five stage launches and
    # synthetic_object's render stage, on seeded inputs and drawn noise, with
    # a digest of its outputs' bytes (the same digest in two checkouts: the
    # same bits); without the weights too where the checkout can skip them
    skips_w = "with_weights" in inspect.signature(upsample_weights_pdf).parameters
    for seed, (n, s, nf, inv_s) in enumerate(K5A_SHAPES, 40):
        args = [T(v) for v in cs.stage_inputs(n, s, seed)]
        noise = torch.rand((n, nf), generator=torch.Generator().manual_seed(seed)).to(dev)
        w, t_new = upsample_weights_pdf(*args, inv_s, nf, noise)
        tag = f"K5a {n} S={s} nf={nf}"
        out[tag] = {**timed(lambda: upsample_weights_pdf(*args, inv_s, nf, noise)),
                    "w_sha256": digest(w), "t_new_sha256": digest(t_new)}
        if skips_w:
            out[tag + " without w"] = timed(
                lambda: upsample_weights_pdf(*args, inv_s, nf, noise, with_weights=False))
    # K4 and K10 at the main path's shapes on seeded rays and grids (a fifth
    # of the cells occupied; K10's grids 5-60%), with drawn noise and with
    # the midpoints, each with the digest of its depths and the kernels a call
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal
    for seed, (label, n, m, nd, grids, res) in enumerate(K4_SHAPES, 200):
        for noisy in (True, False):
            a = tm.k4_edge_inputs(dev, n, m, nd, 0.2, noisy, False, seed, G=grids, R=res)
            if grids:
                a = (*a, tm.k10_lead("lead clipped", n, grids, seed, dev))
            fn = lambda: occ_ray_proposal(*a)
            out[f"{label} {n} M={m} n={nd} noise={noisy}"] = {
                **timed(fn), "kernels": kernels_a_call(fn), "t_sha256": digest(fn())}
    # K8 forward (the compose render's, no gradient) and forward + backward
    # under autograd (the pixel step's) at the merged buffer's width and a
    # wide one
    for n, L in ((4096, 168), (64, 1100)):
        t, mask, alpha = (T(v) for v in cs.edge_alpha_inputs(n, L, L))
        g = cs.cotangents((n, L), 11, dev)
        a = alpha.clone().requires_grad_(True)
        with torch.no_grad():
            out[f"K8 fwd {n} L={L}"] = timed(lambda: cross_source_vw(t, mask, alpha))
        fn = lambda: torch.autograd.grad(cross_source_vw(t, mask, a), a, g)
        out[f"K8 fwd+bwd under autograd {n} L={L}"] = {**timed(fn),
                                                        "kernels": kernels_a_call(fn)}
    for n, a, b in ((4096, 32, 8), (4096, 40, 8), (2048, 32, 8), (2048, 40, 8), (6144, 24, 8),
                    (4096, 80, 16), (8192, 24, 8)):
        ins = [T(v) for v in cs.merge_inputs(n, a, b, 3)]
        keys = torch.cat([ins[0], ins[1]], -1)
        out[f"K5b {n} {a}+{b}"] = {
            **timed(lambda: merge_sorted_samples(*ins)),
            **timed(lambda: torch.sort(keys, dim=-1, stable=True), "library_")}

    mp = WAYMO_DEMO_MULTI["assetbank_cfg"]
    veh = ConditionalLoTDNeuSField(
        n_instances=3, encoding_cfg=mp["Vehicle"]["model_params"]["encoding_cfg"]).encoding
    street = lotd.make_lotd(mp["Street"]["model_params"]["encoding_cfg"])
    obj = lotd.make_lotd(SYNTHETIC_OBJECT["assetbank_cfg"]["Main"]["model_params"]["encoding_cfg"])
    for e in (veh, street, obj):
        e.reset_parameters(torch.Generator().manual_seed(0))
    veh, street, obj = veh.to(dev), street.to(dev), obj.to(dev)
    rng = np.random.default_rng(8)
    k3_sets = (("vehicles' final query", veh, cs.ray_points(6144, 32, veh.cp_rmax, 30)),
               ("vehicles' uniform eikonal", veh, cs.enc_points(512, veh.cp_rmax, 34)),
               ("vehicles, one cell", veh,
                (0.3 + 1e-3 * rng.random((6144 * 32, 3))).astype(np.float32)),
               ("synthetic_object hash levels", obj, cs.ray_points(2048, 96, obj.cp_rmax, 6)))
    for label, e, pts in k3_sets:
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        args = (e.table.numel(), x, e._grid_meta, cs.cotangents((C, N), 31, dev),
                cs.cotangents((3, C, N), 32, dev))
        kw = {"plan": lotd.grid_bwd_plan(e._grid_meta.tolist()).at(N)} if planned else {}
        out[f"K3 bwd {label} N={N}"] = timed(lambda: lotd.lotd_grid_bwd(*args, **kw))
    if planned:  # K3 bwd's two paths, each forced, on the vehicles' dense levels
        for n_rays in (16, 1024, 6144):
            x = T(cs.ray_points(n_rays, 32, veh.cp_rmax, 36))
            N, C = x.shape[0], veh.out_dim
            args = (veh.table.numel(), x, veh._grid_meta, cs.cotangents((C, N), 31, dev),
                    cs.cotangents((3, C, N), 32, dev))
            for path, plan in (("private", veh.grid_bwd_plan), ("atomics", lotd.GridBwdPlan(0, 0))):
                out[f"K3 bwd vehicles N={N} {path} path"] = timed(
                    lambda: lotd.lotd_grid_bwd(*args, plan=plan))
    for label, e, pts in cp_launches(cs, street, veh):
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        lines = e.cp_stacked_lines().detach().to(torch.bfloat16)
        args = (lines, x, e._cp_rows, cs.cotangents((C, N), 31, dev),
                cs.cotangents((3, C, N), 32, dev))
        out[f"K1 bwd {label} N={N} F={lines.shape[1]} R={lines.shape[2]}"] = timed(
            lambda: lotd.lotd_cp_stacked_bwd(*args))
    with tm.cp_per_level():
        veh_l = ConditionalLoTDNeuSField(
            n_instances=3, encoding_cfg=mp["Vehicle"]["model_params"]["encoding_cfg"]).encoding
        street_l = lotd.make_lotd(mp["Street"]["model_params"]["encoding_cfg"])
        bench_l = lotd.make_lotd(BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"])
    for e in (veh_l, street_l, bench_l):
        e.reset_parameters(torch.Generator().manual_seed(0))
    veh_l, street_l, bench_l = veh_l.to(dev), street_l.to(dev), bench_l.to(dev)
    for label, e, pts in cp_launches(cs, street_l, veh_l) + [
            ("bench ladder", bench_l, cs.ray_points(8192, 32, 1024, 30))]:
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        args = (e.table.detach(), x, e._cp_meta, cs.cotangents((C, N), 31, dev),
                cs.cotangents((3, C, N), 32, dev))
        out[f"K2 bwd {label} N={N} levels={e._cp_meta.shape[0]}"] = timed(
            lambda: lotd.lotd_cp_level_bwd(*args))
    # the latent lookup and the stacked lines, forward and backward through
    # the modules the paths call
    enc_cfg = mp["Vehicle"]["model_params"]["encoding_cfg"]
    for label, n, idx in (("main path: 3 runs", 3, np.repeat(np.arange(3), 65_536)),
                          ("crowd: 8 round-robin", 8, np.tile(np.arange(8), 24_576))):
        f = ConditionalLoTDNeuSField(n_instances=n, encoding_cfg=enc_cfg).to(dev)
        h = cs.cotangents((idx.size, f.encoding.out_dim), 33, dev)
        b, g = T(idx), cs.cotangents((idx.size, f.encoding.out_dim + f.z_dim), 34, dev)
        fn = lambda: torch.autograd.grad(f._decoder_input(h, b), f.latents, g)
        out[f"latent lookup fwd+bwd {label} P={idx.size} n={n}"] = {
            **timed(fn), "kernels": kernels_a_call(fn)}
    # K14's backward alone at each model's stacked encoding and the first
    # edge ladder, from a cotangent in K1 bwd's layout
    bench = lotd.make_lotd(BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"])
    bench.reset_parameters(torch.Generator().manual_seed(0))
    bench = bench.to(dev)
    _, rmax, ladder, before, _, _ = tm.CP_LINES_EDGES[0]
    levels = [(R, F, before + sum(3 * r * f for r, f in ladder[:i]))
              for i, (R, F) in enumerate(ladder)]
    edge = (lotd.cp_lines_plan(levels, rmax).to(dev), levels[-1][2] + 3 * ladder[-1][0]
            * ladder[-1][1])
    for label, plan, n_table in [(label, e.cp_lines_plan(), e.table.numel()) for label, e in (
            ("street", street), ("vehicles", veh), ("bench ladder", bench),
            ("synthetic_object", obj))] + [("edge ladder", *edge)]:
        L, Rmax = plan.lo.shape
        g = cs.cotangents((3, Rmax, f_cp(plan)), 36, dev).transpose(1, 2)
        fn = lambda: lotd.lotd_cp_lines_bwd(g, n_table, plan)
        out[f"K14 bwd {label} L={L} F_cp={f_cp(plan)} R_max={Rmax}"] = {
            **timed(fn), "kernels": kernels_a_call(fn)}
    for label, e in (("street", street), ("vehicles", veh)):
        g = cs.cotangents((3, e.cp_rmax, e.cp_out_dim), 35, dev).transpose(1, 2)
        fn = lambda: torch.autograd.grad(e.cp_stacked_lines(), e.table, g)
        out[f"stacked lines fwd+bwd {label} F_cp={e.cp_out_dim} R_max={e.cp_rmax}"] = {
            **timed(fn), "kernels": kernels_a_call(fn)}
    from neuralsim_torch.fields.encodings import permuto as pm
    # a K9 that takes the lattice constants (``lat``, after the level
    # metadata) writes feature-major outputs
    takes_lat = "lat" in inspect.signature(pm.permuto).parameters
    for label, d, max_res, seed, rays in (("vehicles", 11, 256.0, 100, False),
                                          ("vehicles, ray-ordered", 11, 256.0, 100, True),
                                          ("PermutoNeuSObj ladder", 3, 512.0, 101, False)):
        enc = pm.PermutoEncoding(d, n_levels=12, base_res=4.0, max_res=max_res,
                                 log2_hashmap_size=17)
        _, enc, table, x = cs.permuto_set(label, enc, 196_608, seed, dev)
        if rays:
            x = T(tm.permuto_ray_points(6144, 32, d, 7))
        N, C = x.shape[0], enc.out_dim
        tag = f"K9 {label} d={d} T={enc.table_size}"
        a = (table, x, enc._res, enc._meta) + ((enc._lat,) if takes_lat else ()) \
            + (enc.table_size,)
        out[f"{tag} fwd with jacobian N={N}"] = timed(lambda: pm.permuto(*a, C, True))
        a2 = (table, x[:147_456]) + a[2:]
        out[f"{tag} fwd no jacobian N=147456"] = timed(lambda: pm.permuto(*a2, C, False))
        point_major = not takes_lat
        go = cs.cotangents((N, C) if point_major else (C, N), 31, dev)
        gj = cs.cotangents((N, C, 3) if point_major else (3, C, N), 32, dev)
        out[f"{tag} bwd both cotangents, d x01 N={N}"] = timed(
            lambda: pm.permuto_bwd(*a, go, gj))
        with torch.no_grad():
            enc.table.copy_(table)
        xg = x.clone().requires_grad_(True)
        ch, cj = cs.cotangents((N, C), 33, dev), cs.cotangents((N, C, 3), 34, dev)

        def through_module():
            h, j = enc.with_jacobian(xg)
            return torch.autograd.grad([h, j], [enc.table, xg], [ch, cj])
        out[f"{tag} with_jacobian fwd+bwd under autograd N={N}"] = {
            **timed(through_module), "kernels": kernels_a_call(through_module)}
    torch.cuda.synchronize()
    out["card"] = card()
    return out


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


MODES = {"--composite-only": "composite", "--grid-latent-only": "grid-latent",
         "--lines-pairs-only": "lines-pairs", "--grid-refresh-only": "grid-refresh",
         "--grid4-only": "grid4"}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(argv[1], MODES.get(argv[2], "all") if argv[2:] else "all")),
              flush=True)
        return 0
    if argv[:1] == ["--capture"]:
        capture_path_points(argv[1])
        return 0
    only = [a for a in argv if a in MODES][:1]
    roots = [str(Path(r).resolve()) for r in argv if r not in MODES] or [str(HERE)]
    rc = 0
    extra = {}
    if only == ["--grid4-only"]:
        # one pixel step's points, captured once in this checkout, for every root
        path_file = HERE / "build" / "k3_4d_path_points.npz"
        path_file.parent.mkdir(parents=True, exist_ok=True)
        p = subprocess.run([sys.executable, __file__, "--capture", str(path_file)], cwd=HERE,
                           env={**os.environ, "PYTHONPATH": str(HERE)}, capture_output=True,
                           text=True, timeout=1200)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(f"torch_kernel_ab: capturing a pixel step's points exited {p.returncode}",
                  file=sys.stderr)
            return 1
        extra = {"K3_4D_PATH_POINTS": str(path_file)}
        print(json.dumps({"counts": grid4_counts(str(path_file))}), flush=True)
    for root in roots:
        # the child imports the port from ``root``, never from this checkout
        env = {**os.environ, "PYTHONPATH": root, **extra}
        p = subprocess.run([sys.executable, __file__, "--one", root, *only], cwd=root, env=env,
                           capture_output=True, text=True, timeout=1200)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(f"torch_kernel_ab: {root} exited {p.returncode}", file=sys.stderr)
            rc = 1
            continue
        print(p.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
