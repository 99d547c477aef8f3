#!/usr/bin/env python3
"""Drive the PyTorch port (neuralsim_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the port's CUDA kernels from neuralsim_torch/csrc;
  3. kernels: hold every kernel to its plain PyTorch version on the card,
     each within a stated tolerance: the forward kernels to their plain
     versions at the render path's shapes (4,096 rays per chunk) and at the
     training path's (2,048 rays, the 512 uniform points, drawn noise), plus
     edge cases; the backward kernels to autograd of theirs at the training
     path's shapes, with non-zero cotangents of every output;
  4. render slice: build the full-width synthetic_object renderer with seeded
     weights, render 4 frames of the 96x96 synthetic rig with
     render_chunked(rayschunk=4096), check the images, check that every
     forward kernel launched (the close range is composited alone: K12, the
     NeuS alpha inside the composite, in place of K6), and compare a 32x32
     crop with the CPU (plain) path;
  5. training slice: build_trainer at full width from seed 42; the first
     step's loss terms and per-parameter gradients on the card against the
     same step (same parameters, batch and noise) through the plain versions
     on the CPU; K12 forward and backward at that step's own buffer
     (2,048 x 96 with rgb, its inv_s and cos anneal) against their plain
     versions; then train() for 60 steps of 2,048 rays: every loss finite,
     no step skipped, loss_rgb over the last 10 steps below the first 10,
     all eight kernels launched; one poisoned step (a NaN in the batch) is
     skipped and leaves every parameter bit-identical;
  6. bench model (BENCH_OBJECT: 12 stacked-CP levels of 8 features up to
     1,024, occupancy grid 128^3, distant field, sky): its kernels against
     their plain versions (K4 occ_ray_proposal at 8,192 and 4,096 rays on
     the converged grid, with and without noise, an empty and a full grid,
     probes that leave the box; K7 occ_ema_update at 128^3 with 1 and 4
     samples a voxel, warm-up on and off, sdf and density; K1 forward and
     backward at F = 96, R = 1,024 at the path's point sets; K5a, K5b, K6 and
     K6's backward at 8,192 and 4,096 rays of 16 -> 24 -> 32 samples and 64
     composited lanes of two buffers); build_trainer with the grid converged;
     the first step's losses and gradients at 8,192 rays on the card against
     the CPU path; 48 steps of 8,192 rays (three grid
     refreshes): finite losses, no skip, falling loss_rgb, a live grid, K4
     once a step, K7 once a refresh; a poisoned step on the grid's cadence is
     skipped, changes no parameter and still refreshes the grid; 4 frames of
     128x128 through render_chunked(occ_states=...) with a crop held to the
     CPU path ray by ray: tightly at the CPU path's own sample depths and on
     the rays that both sample at equal depths, the others in the mean (see
     check_crop_by_ray);
  7. multi-object compose render (WAYMO_DEMO_MULTI at full width: 3 vehicles
     on one conditional LoTD model, the street's LoTD NeuS with its 128^3
     grid converged on the drive's ground, the distant field on the street's
     cuboid shells, the sky): K8 cross_source_vw against its plain version on
     a chunk's merged buffer [4,096, 168] and on ragged, tied, masked buffers;
     K1 at the street's width (F_cp 40, R 1,024) and the vehicles' (F_cp 24,
     R 256), K3 on the vehicles' dense levels, K4 at 64 march segments, K5a
     and K5b at the stage widths; 4 frames of 80x120 through
     build_compose_renderer and render_multi_frame, with K8 and K4 launched
     once a chunk; the frames finite, the mask in [0, 1 + 1.1e-3] and the
     sources' shares summing to it; a crop held to the CPU path (the merge
     on identical buffers, then ray by ray, see check_compose_crop);
  8. multi-object training (WAYMO_DEMO_MULTI at full width, through
     build_multi_trainer and train_loop): build (the demo drive's sequence in
     memory, the bank, the street's 800-iteration road-surface pretrain, the
     grid at its initial state), each part timed; K8's backward against
     autograd of its plain version at the pixel step's merged buffer
     [4,096, 168] and on ragged, tied, masked buffers with edge alphas, K1's
     and K3's backwards at the path's point sets and widths, K6 forward and
     backward at the LiDAR step's street buffer (2,048 x 48, no rgb; now
     K12, the NeuS alpha inside the composite, in place of K6); the
     first iteration (a LiDAR step, then a pixel step; cut to 512 beams and
     1,024 rays) on the card against the CPU path at the CPU path's sample
     depths (sample_placements), the card's own step logged beside it; 48
     iterations (error-map sampling from the 16th): finite losses, no skip,
     falling loss_rgb and LiDAR depth loss, three grid refreshes, K8 and its
     backward and K12 and its backward once an iteration, K4 twice, K7 once a
     refresh; a poisoned pixel step skipped with every parameter unchanged;
     one 80x120 frame of the trained state rendered. K5b held exactly at the
     iteration's stage widths (street 32 + 8 and 40 + 8 at 4,096 and 2,048
     rays, vehicles 24 + 8 at 6,144 rows), at 1 and 4,097 rays and on lists
     full of ties; K3's backward (private dense levels in shared memory,
     global ones with atomics) at the vehicles' final query, their uniform
     eikonal, every point in one cell and small_encoding's mixed levels, with
     each cotangent alone too; K1's backward for the street's and the
     vehicles' lines at their pixel step's sorted samples, 512 uniform
     points, every point in one cell, 1 and 33 points, and lines of F 13 (a
     partial group of four), each cotangent alone and both;
     the shapes of K1 bwd, K3 bwd, K5a and K5b launches in one LiDAR and one
     pixel step;
  9. crowded multi-object scenes (WAYMO_DEMO_CROWD at full width: 8
     vehicles on one shared model with per-instance 32^3 occupancy grids, so
     the group takes the pair-budget path): the render from converged grids
     (the street's on the ground, the vehicles' on the model's own SDF): K8
     at the render chunk's merged buffer [4,096, 328], K10
     occ_ray_proposal_batched against its plain version at the group's rows
     (converged and random per-instance grids, noise, probes outside the
     box, grid indices outside [0, G), keyframes of times), K7 at the
     batched update's 262,144 voxels; 4 frames of 80x120 with K11, K10, K8
     and K4 launched once a chunk, the frames checked as in phase 7 and a
     crop held to the CPU path ray by ray at the CPU path's sample depths
     (the street's and the vehicle grids' proposals); the refresh of the
     vehicle grids timed. Then training (build_multi_trainer): K8 at the
     pixel step's merged buffer [4,096, 200] (4 slot lanes of 32 for the
     group), K11 integer-equal to its plain version on the path's render and
     training calls and on ragged, tied and crossing masks; the first
     iteration card vs CPU at the CPU path's sample depths; 48 iterations
     (finite, no skip, falling loss_rgb and LiDAR depth, both grids refreshed
     three times, K11, K10 and K8 with its backward once a pixel step); a
     poisoned pixel step; a frame of the trained state;
 10. configs/synthetic_multi.yaml (SYNTHETIC_MULTI at full width): build, 48
     pixel steps of 2,048 rays (finite, falling loss_rgb, no skip, K11 and K8
     with its backward once a step, K3 on the street's hash levels), a frame
     of the trained state, K11 equal to its plain version at its calls;
 11. per-level CP (WAYMO_DEMO_MULTI built under NEURALSIM_CP_STACKED=0, the
     setting of the JAX flagship runs: every CP level of the street (10, F 4,
     R 16..1,024) and of the vehicles (6, F 4, to 256) per-level, K2): K2
     forward (with and without the jacobian) and backward (each cotangent)
     against their plain versions at the street's pixel and LiDAR step
     shapes, the vehicles' rows, the bench model's ladder (12 levels of F 8
     to 1,024) and each model's 512 uniform points; K2's backward on K1's
     edge cases of phase 8, and on a level of R 9,000 beside R 16; the shapes
     of K2 bwd's launches in one LiDAR and one pixel step; K12 forward and
     backward at the LiDAR step's street buffer and at synthetic_object's
     [4,096, 96] with rgb, at cos anneals 0, 0.5 and 1; 4 frames of 80x120
     (K2, never K1) with a crop held to the CPU path at its street depths;
     the first iteration card vs CPU at the CPU path's sample depths; one
     LiDAR step (K12 and K2; no K6, no K1, no plain
     alpha chain) and one pixel step counted apart; 48 iterations (finite,
     no skip, falling loss_rgb and LiDAR depth) and a poisoned step; the
     per-level iteration and frame medians beside the stacked ones of phases
     7 and 8;
 12. permuto vehicles (WAYMO_DEMO_PERMUTO: the 3 vehicles on one
     ADGenerativePermutoConcatNeuSObj, a permutohedral NeuS over
     concat(xyz01, sigmoid(z)), d 11, 12 levels of F 2 to 256, 2^17 rows a
     level): K9 forward (with and without the jacobian) and backward (each
     cotangent; the table's and the inputs' gradients) against their plain
     versions at the pixel step's final query [196,608, 11], at
     PermutoNeuSObj's ladder (d 3, to 512) and at d 4; 4 frames of 80x120
     (K9 forward, never K3) with a crop held to the CPU path at its street
     depths; the first iteration card vs CPU at the CPU path's sample depths
     (the permuto table and the latents among the leaves); one LiDAR and one
     pixel step counted apart, with K9's shapes; 48 iterations (finite, no
     skip, falling loss_rgb and LiDAR depth) and a poisoned step; no call of
     the plain permuto functions on the card path; the permuto iteration and
     frame medians beside those of the LoTD vehicles (phases 7 and 8);
 13. timing: frame latency and rays/s; training step time and rays/s; each
     kernel's time at the training path's shapes (beside that path's launch
     count) and, for the forward kernels, at the render path's too, each
     beside its plain version, a library call where one exists, and its bound
     (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s); the same for
     the bench model's step (refresh steps apart, and the mean over a whole
     cadence of the grid), frame and kernels, for the compose frame and K8,
     K1, K3 and K4 at its shapes, and for the multi-object iteration (each
     step type apart; rays/s = 6,144 / iteration) with K8 forward and
     backward and K6 forward and backward at its shapes, and K1 bwd (its
     512-point launches too), K3 bwd, K5a and K5b (beside a stable
     torch.sort) at the iteration's shapes; K1 bwd, K2 bwd, K3 bwd, K4, K5a,
     K5b, K6, K10, K11 and K12 also queued (the card held busy while the
     host enqueues the calls) and by the profiler (card_ms); the
     same for the crowd (frame, iteration), and the synthetic_multi step; K11 at its three
     calls beside a stable torch.argsort of its keys, K10 at the group's
     rows, K7 at the batched update; K2 at each of its shapes, K12 at the
     LiDAR step's street buffer; K9 forward and backward at each of its
     shapes;
 14. one JSON line of results, one of per-kernel results, then the device
     line, last.

--profile adds torch.profiler tables of device time by kernel for one frame
and for one training step of each model, for one compose frame, and for one
LiDAR and one pixel step of the multi-object (with K1 bwd's, K3 bwd's, K5a's
and K5b's device time), the crowd, the per-level (with K2's, K2 bwd's and K3
bwd's) and the permuto training (with K9's and the latents' index_put device
time).
"""
from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
SLEEP_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock: torch.cuda._sleep's cycles a second
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
N_FRAMES = 4
FRAME_IDS = (0, 6, 12, 18)
RAYSCHUNK = 4096
# GPU frame vs CPU crop: cuBLAS and the CPU sum the MLP products in other
# orders; at silhouette pixels that last-bit sdf difference moves an upsampled
# depth inside a near-empty cdf bin, and the composite follows it
CROP_TOL = 2e-3
TRAIN_RAYS = 2048
# a backward kernel vs autograd of its plain version: both sum thousands of
# float32 terms per entry in different orders (atomics on the card)
GRAD_REL = 1e-4
TRAIN_STEPS = 60
# one training step on the card vs the CPU: loss terms relative, gradients
# relative to each parameter's largest gradient entry. The upsample stages'
# inverse-CDF draws move samples by the last-bit differences of the field
# (cuBLAS and the CPU sum the MLP products in other orders), as CROP_TOL says
STEP_LOSS_RTOL = 2e-4
STEP_GRAD_REL = 5e-3
# the bench model: 8,192 rays a step, 48 steps = three refreshes of the grid
BENCH_RAYS = 8192
BENCH_STEPS = 48
BENCH_FRAME_IDS = (0, 1, 2, 3)
# kernels that only the bench model's path runs (synthetic_object has no grid;
# its close range, composited alone, takes K12, and only the bench model's
# close range and distant buffers go through K6 together)
BENCH_ONLY = ("occ_ray_proposal", "occ_ema_update", "volume_composite",
              "volume_composite.bwd")
# its first step on the card vs the CPU, at the step's own 8,192 rays: the
# occupancy proposal's cdf bins are nearly all near-empty, so its inverse CDF
# moves a sample on a last-bit difference more often than the upsample
# stages' do
BENCH_STEP_LOSS_RTOL = 2e-4
BENCH_STEP_GRAD_REL = 2e-3
# that comparison runs on the rays that both sides sample alike: a ray on
# which a close-range sample depth differs by more than this (relative to
# 1 + depth; rounding alone gives ~1e-7, a few ulps) got another sample
# placement, and at the bench model's initial state, where the mask loss
# leaves a hundred unsaturated rays with weights of up to 1,000, two such rays
# move the table gradient by 11% of its largest entry (measured at 8,192 rays,
# where ~5% of the rays fall under this rule and ~2.5% lie more than 1e-4
# apart; without the latter every leaf agrees within 4.5e-4). At most
# BENCH_MOVED_MAX of a step's rays may fall under it
BENCH_SAME_SAMPLES = 1e-6
BENCH_MOVED_MAX = 0.15
BENCH_CROP_TOL = 5e-3
# the field's nablas at the same positions on the card and on the CPU (K1's
# jacobian is bit-exact; the decoder's products sum in other orders), relative
# to their largest entry
NABLA_TOL = 1e-4
# the bench model's render on the card vs the CPU where both use the same
# sample depths (see check_crop_by_ray): rounding only. Measured over 60 crops
# of 15 trained states (scripts/torch_crop_repeat.py, H100): <= 1.2e-6
EQUAL_DEPTH_TOL = 2e-5
# where the card places a sample elsewhere (same series): the share of rays
# with a depth more than BENCH_SAME_SAMPLES apart (measured 6-13% of a crop),
# the mean error of colour and mask over the rays whose depths are not
# bit-equal (measured <= 3.3e-4), and the share of all rays beyond
# BENCH_CROP_TOL in either (measured <= 10 of 1,024). Single rays are not
# limited: the worst read 0.19 in the colour and 0.24 in the mask
CROP_MOVED_MAX = 0.25
OTHER_MEAN_TOL = 2e-3
OTHER_OFF_MAX = 0.05
# a ray's mean depth, relative to 1 + its largest sample depth (thousands in
# the distant ladder), on a ray that both sides sample alike: the error of
# the weights, ~1e-7 (measured <= 4.1e-8)
BENCH_DEPTH_TOL = 1e-6
# K4's depths vs its plain version (another order of the cdf sums), and K7's
# values (expf against torch.exp); K7's mask may differ only where the value
# lies within that tolerance of the threshold
K4_TOL = dict(rtol=1e-5, atol=1e-6)
K7_ATOL = 1e-6
# the multi-object compose render (WAYMO_DEMO_MULTI): 4 frames of 80x120 of
# camera_FRONT, each 9,600 rays in three chunks of 4,096 (the last padded)
COMPOSE_ONLY = ("cross_source_vw",)
COMPOSE_FRAME_IDS = (0, 2, 4, 6)
COMPOSE_CAM = "camera_FRONT"
# K8 against its plain version: sums of up to L float32 logs in another order
K8_TOL = dict(rtol=1e-5, atol=1e-6)
# a frame's per-source mask volumes against its total (sums of the same
# weights over disjoint lanes), and the total's upper end: cross_source_vw
# lets 1e-3 of the light through an opaque lane (its occlusion cap), so the
# weights of a ray may sum to 1 + 1e-3
SHARE_SUM_TOL = 1e-5
MASK_CAP = 1.0 + 1.1e-3
# a field's sdf at the same positions on the card and on the CPU (the
# decoder's products sum in another order)
FIELD_SDF_TOL = 1e-5
# the compose crop (see check_compose_crop). The street's grid proposal
# differs from the CPU's in its last bits on every ray that crosses the
# ground (K4 sums its segments in another order than the plain version's
# torch.sum), and the upsample stages move a street sample by more than
# BENCH_SAME_SAMPLES on about half of them (measured 517 of 1,024 rays, H100;
# 313 at the card test's size), so the share moved is limited only against a
# failure of the proposal, and the share of rays beyond BENCH_CROP_TOL in
# colour or mask is the bench's share of moved rays scaled up (measured 38 of
# 1,024). At the CPU path's street depths, a vehicle depth differs in its
# last bits on ~5% of the rays (the vehicle decoder's products sum in
# another order on the card, 2.4e-7 in the sdf, and the upsample stage
# passes that on; measured 969 of 1,024 rays equal): at least
# COMPOSE_EQUAL_MIN of the rays must have every depth equal bit for bit
COMPOSE_MOVED_MAX = 0.75
COMPOSE_OFF_MAX = 0.10
COMPOSE_EQUAL_MIN = 0.5
# multi-object training of WAYMO_DEMO_MULTI: each loop iteration a LiDAR
# step of 2,048 beams (the street alone) and a pixel step of 4,096 rays
MULTI_RAYS, MULTI_BEAMS = 4096, 2048
MULTI_ONLY = ("cross_source_vw.bwd",)
# 48 iterations (three grid refreshes); the error map's importance sampling
# from the 16th pixel step on (the config's 200 cut so that it runs)
MULTI_ITERS = 48
# kernels whose launches a multi-object step records by shape, and the
# profiler's device-time split of a step by kernel name
MULTI_WATCHED = ("lotd_grid.bwd", "lotd_cp_stacked.bwd", "neus_upsample.weights_pdf",
                 "neus_upsample.merge")
MULTI_PROFILED = {"K3 bwd": ("grid_bwd",), "K5b": ("merge_kernel",),
                  "K1 bwd": ("cp_stacked_bwd",), "K5a": ("weights_pdf",)}
# the per-level steps' device-time split by kernel name
PERLEVEL_PROFILED = {"K2 bwd": ("cp_level_bwd",), "K2": ("cp_level_kernel",),
                     "K3 bwd": ("grid_bwd",)}
MULTI_ERROR_MAP_AFTER = 16
# its first iteration card vs CPU, cut to 1,024 rays and 512 beams (the plain
# K8 is O(N L^2) in memory on the CPU), at the CPU path's sample depths
# (replayed on the card, see sample_placements: the street's grid proposal,
# which K4 sums in another order, and the upsample stages' draws); the losses
# and every gradient leaf, relative to its largest entry
MULTI_CHECK_RAYS, MULTI_CHECK_BEAMS = 1024, 512
MULTI_STEP_LOSS_RTOL = 2e-4
MULTI_STEP_GRAD_REL = 2e-3
# the crowded scene (WAYMO_DEMO_CROWD): 8 vehicles on one shared model, on
# the pair-budget path (K11) with per-instance 32^3 grids (K10); rendered from
# converged grids and trained as the multi-object scene, under the same limits
CROWD_ONLY = ("pair_compact", "occ_ray_proposal_batched")
CROWD_VEHICLES = 8
CROWD_ITERS = 48
# synthetic_multi (configs/synthetic_multi.yaml): 48 pixel steps of 2,048 rays
SYNTH_STEPS = 48
SYNTH_CAM = "camera_0"
# WAYMO_DEMO_MULTI on the per-level CP path (NEURALSIM_CP_STACKED=0 while its
# models are built): K2 in place of K1 on every encoding. Its kernels' rows
# report this path: K2 runs on no other, K12 on its LiDAR step as on the
# stacked one. Rendered and trained under the multi-object limits.
PERLEVEL_ONLY = ("lotd_cp_level", "lotd_cp_level.bwd")
PERLEVEL_ROWS = PERLEVEL_ONLY + ("neus_composite", "neus_composite.bwd")
PERLEVEL_ITERS = 48
# K12 (the NeuS alpha inside the composite) against its plain version: each
# alpha is a difference of two sigmoids over the first, so a last-bit
# difference of the cos sum moves it by up to ~1e-7, and the depth by that
# over the ray's weight sum; its backward under GRAD_REL
K12_TOL = dict(rtol=1e-4, atol=1e-5)
K12_ANNEALS = (0.0, 0.5, 1.0)
# WAYMO_DEMO_PERMUTO: the vehicles on one permutohedral NeuS (d = 11: xyz and
# a latent of 8 in the lattice; 12 levels of F 2, 2^17 rows a level). K9 runs
# on this path only. Rendered and trained under the multi-object limits.
PERMUTO_ONLY = ("permuto", "permuto.bwd")
PERMUTO_ITERS = 48
# K9 against its plain version: the lattice rounds like the plain version
# operation by operation (explicit _rn), so both pick the same simplex, rows
# and weights, and sum the interpolation in the same order
K9_TOL = dict(rtol=1e-5, atol=1e-6)
# K9's backward: the table's gradient within GRAD_REL of its largest entry
# (float32 atomics in another order than autograd's scatter); the inputs'
# gradient, one thread a point summing its levels, within K9_DX_REL of its
# largest entry (autograd sums the same terms through the elevation chain)
K9_DX_REL = 1e-5


def log(*a):
    print(*a, flush=True)


def hold_card(fn, reps):
    """Keep the card busy (torch.cuda._sleep) for 1.5x the host time of
    ``reps`` calls of fn (capped at a second), so that the host enqueues them
    all before the first one runs."""
    import torch
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 1.0) * SLEEP_CYCLES_PER_S))


def cuda_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Mean device time of fn() over reps launches, after one warm-up, back
    to back: a kernel shorter than its wrapper's host time reads the host's
    pace. ``queued``: the card is held busy while the host enqueues them
    (hold_card), so the events time the card's work alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        hold_card(fn, reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def prof_ms(fn, reps: int = 20) -> float:
    """The device time of fn()'s kernels (memsets included) a call, under
    torch.profiler, after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def card_ms(fn, reps: int = 20) -> dict:
    """A kernel's time three ways: ``ms`` back to back (cuda_ms: the host's
    pace where that is the slower), ``queued_ms`` with the card held busy
    while the host enqueues the calls, ``prof_ms`` by the profiler."""
    return dict(ms=cuda_ms(fn, reps), queued_ms=cuda_ms(fn, reps, queued=True),
                prof_ms=prof_ms(fn, reps))


def card_keys(t) -> dict:
    """The queued and profiler times of a timing (and of its library call),
    where it has them, for the kernels line."""
    return {k: t[k] for k in ("queued_ms", "prof_ms", "library_queued_ms", "library_prof_ms")
            if k in t}


def card_extra(t) -> str:
    """``queued_ms`` and ``prof_ms`` of a timing, where it has them, for a log line."""
    return "".join(f", {k.split('_')[0]} {t[k]:.4f}" for k in ("queued_ms", "prof_ms") if k in t)


def host_ms(fn, reps: int = 20) -> float:
    """Mean host time of one call of fn while the card is held busy: what a
    wrapper costs the host, which bounds every training path (host-bound)."""
    import torch
    fn()
    hold_card(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return out


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encode_into(fn, args, C, N, dev, jac):
    """Run a K1/K3 entry (kernel or plain) into fresh zeroed [C, N] buffers."""
    import torch
    out = torch.zeros((C, N), device=dev)
    j = torch.zeros((3, C, N), device=dev) if jac else None
    fn(*args, out, j)
    return out, j


def compare(name, got, want, rtol, atol, exact=False):
    """Max abs error over paired outputs; raises past the tolerance."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        if exact:
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from its plain version")
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        err = max(err, float((g.float() - w.float()).abs().max()) if g.numel() else 0.0)
    log(f"check {name}: max_abs_err {err:.3g} (tol rtol {rtol:g} atol {atol:g})")
    return err


# ---------------------------------------------------------------------------
# Inputs at the slice's shapes (made from seeds with numpy)
# ---------------------------------------------------------------------------

def enc_points(n, rmax, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    k = np.arange(rmax, dtype=np.float32)
    xs = k / np.float32(rmax - 1)
    xs = xs[xs * np.float32(rmax - 1) == k]        # exactly integer CP positions
    if 2 * len(xs) > n - 4:                        # a wide grid has more knots than rows
        xs = xs[:(n - 4) // 2]
    x[:len(xs), 0] = xs
    x[len(xs):2 * len(xs), 1] = xs
    x[-4:, 2] = [0.0, 1.0, -0.5, 1.5]               # ends and clipped points
    return x


def ray_points(n_rays, s, rmax, seed):
    """Encoding inputs as the training step gives them: ``s`` depth-sorted
    samples on each of ``n_rays`` chords of the unit cube, ray after ray, so
    neighbouring points share cells (a backward kernel's atomics then collide
    as they do in training, unlike with scattered points). The last rows are
    the knot, end and clipped points of :func:`enc_points`."""
    rng = np.random.default_rng(seed)
    a, b = rng.random((2, n_rays, 1, 3))
    u = np.sort(rng.random((n_rays, s, 1)), 1)
    x = (a + (b - a) * u).reshape(-1, 3).astype(np.float32)
    x[-256:] = enc_points(256, rmax, seed)
    return x


def stage_inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    near = (0.5 + rng.random(n)).astype(np.float32)
    far = (near + 1.0 + rng.random(n)).astype(np.float32)
    u = np.sort(rng.random((n, s)), -1).astype(np.float32)
    t = (near[:, None] + (far - near)[:, None] * u).astype(np.float32)
    surf = near + (far - near) * rng.random(n)
    sdf = (surf[:, None] - t + rng.normal(0, 0.02, (n, s))).astype(np.float32)
    mask = np.ones((n, s), bool)
    miss = np.arange(n) % 11 == 0
    t[miss], near[miss], far[miss], mask[miss] = 0.0, 0.0, 0.0, False
    return t, sdf, mask, near, far


def merge_inputs(n, a, b, seed, levels=400):
    """Two ascending lists of depths on a grid of ``levels`` values (a few
    levels: ties inside each list and across them), a tie across in every
    ray, random masks and sdf."""
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.integers(0, levels, (n, a)) / 64.0, -1).astype(np.float32)
    tb = (rng.integers(0, levels, (n, b)) / 64.0).astype(np.float32)
    tb[:, 0] = ta[:, 3]
    tb = np.sort(tb, -1)
    return (ta, tb, rng.random((n, a)) > 0.2, rng.random((n, b)) > 0.2,
            rng.normal(size=(n, a)).astype(np.float32),
            rng.normal(size=(n, b)).astype(np.float32))


def composite_inputs(n, s, seed, two_buffers=False):
    """``two_buffers``: the mask of a close-range buffer followed by a distant
    one (the second half of the lanes valid on every ray, also on the rays
    whose close-range lanes are all masked)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 3.0, -1).astype(np.float32)
    alpha = (rng.random((n, s)) ** 4).astype(np.float32)
    alpha[::5, 5 * s // 12] = 1.0
    mask = rng.random((n, s)) > 0.1
    mask[::9] = False
    if two_buffers:
        mask[:, s // 2:] = True
    return (t, mask, alpha, rng.random((n, s, 3)).astype(np.float32),
            rng.normal(size=(n, s, 3)).astype(np.float32))


def small_encoding(dev):
    """An LoTD with dense levels too (the full config has none): 2 dense, 2
    stacked-CP and 2 hash levels."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    enc = lotd.make_lotd({"type": "tpu_mixed", "n_levels": 6, "base_res": 8, "max_res": 64,
                          "n_feats": 2, "n_hash_levels": 2, "log2_hashmap_size": 10,
                          "cp_max_res": 32})
    enc.reset_parameters(torch.Generator().manual_seed(1))
    return enc.to(dev)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version, on the card
# ---------------------------------------------------------------------------

def check_kernels(dev, params, n_rays, point_sets, noisy):
    """Hold the five forward kernels to their plain versions at one path's
    shapes: ``n_rays`` rays per call, K1 and K3 at each of ``point_sets``
    ((label, points) pairs; the last one is the one timed later), the
    upsample stages with and, where ``noisy``, without noise.
    -> ({kernel: (max_abs_err, atol)}, the inputs kept for timing)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    res, shapes = {}, {}
    enc = params["Main"].encoding
    C = enc.out_dim
    lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
    errs1, errs3 = [], []
    for label, pts in point_sets:
        x = T(pts)
        N = x.shape[0]
        a1 = (lines, x, enc._cp_rows)
        a3 = (enc.table.detach(), x, enc._grid_meta)
        for jac in (False, True):
            errs1.append(compare(f"K1 lotd_cp_stacked rays={n_rays} {label} N={N} jac={jac}",
                                 encode_into(lotd.lotd_cp_stacked, a1, C, N, dev, jac),
                                 encode_into(lotd.lotd_cp_stacked_plain, a1, C, N, dev, jac),
                                 1e-5, 1e-5))
            errs3.append(compare(f"K3 lotd_grid hash rays={n_rays} {label} N={N} jac={jac}",
                                 encode_into(lotd.lotd_grid, a3, C, N, dev, jac),
                                 encode_into(lotd.lotd_grid_plain, a3, C, N, dev, jac),
                                 1e-5, 1e-5))
    res["lotd_cp_stacked"] = (max(errs1), 1e-5)
    res["lotd_grid"] = (max(errs3), 1e-5)
    shapes["lotd_cp_stacked"] = dict(args=a1, C=C, label=label)
    shapes["lotd_grid"] = dict(args=a3, C=C)

    res_s, shapes_s = check_sample_kernels(dev, n_rays, ((64, 256.0), (80, 256.0)), 16, 96, noisy)
    res.update(res_s)
    shapes.update(shapes_s)
    return res, shapes


def check_sample_kernels(dev, n_rays, stages, n_draws, comp_s, noisy, two_buffers=False):
    """Hold K5a, K5b and K6 to their plain versions at one path's shapes:
    ``n_rays`` rays per call; ``stages`` = ((S, inv_s), ...), the buffer width
    and the fixed inv_s of each upsample stage, which draws ``n_draws`` new
    samples (with and without noise) that are merged into the S; the composite
    over ``comp_s`` lanes, of two buffers where ``two_buffers``. The inputs of
    the last stage are kept for timing, with noise where ``noisy``.
    -> ({kernel: (max_abs_err, atol)}, the inputs kept for timing)."""
    import torch
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    from neuralsim_torch.renderers.buffers import volume_composite, volume_composite_plain

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    res, shapes = {}, {}
    errs_w, errs_m = [], []
    drawn = torch.rand((n_rays, n_draws), generator=torch.Generator().manual_seed(4)).to(dev)
    for seed, (s, inv_s) in enumerate(stages, 2):
        args = [T(a) for a in stage_inputs(n_rays, s, seed)]
        for noise in (None, drawn):
            errs_w.append(compare(f"K5a weights_pdf rays={n_rays} S={s} draws={n_draws} "
                                  f"inv_s={inv_s:g} noise={noise is not None}",
                                  upsample_weights_pdf(*args, inv_s, n_draws, noise),
                                  upsample_weights_pdf_plain(*args, inv_s, n_draws, noise),
                                  1e-5, 1e-6))
        ins = [T(a) for a in merge_inputs(n_rays, s, n_draws, seed)]
        errs_m.append(compare(f"K5b merge rays={n_rays} A={s} B={n_draws}",
                              merge_sorted_samples(*ins),
                              merge_sorted_samples_plain(*ins), 0, 0, exact=True))
    res["neus_upsample.weights_pdf"] = (max(errs_w), 1e-6)
    res["neus_upsample.merge"] = (max(errs_m), 0.0)
    shapes["neus_upsample.weights_pdf"] = dict(args=args, noise=drawn if noisy else None,
                                               inv_s=inv_s, nf=n_draws)
    shapes["neus_upsample.merge"] = dict(ins=ins)

    cargs = [T(a) for a in composite_inputs(n_rays, comp_s, 5, two_buffers)]
    res["volume_composite"] = (compare(f"K6 volume_composite rays={n_rays} S={comp_s}"
                                       f"{' (two buffers)' if two_buffers else ''}",
                                       volume_composite(*cargs),
                                       volume_composite_plain(*cargs), 1e-5, 1e-6), 1e-6)
    shapes["volume_composite"] = dict(args=cargs)
    torch.cuda.synchronize()
    return res, shapes


def check_dense_levels(dev):
    """K3 forward on an encoding with dense levels (the full config has none)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    e, n = small_encoding(dev), 65_536
    x = torch.from_numpy(enc_points(n, 64, 1)).to(dev)
    a = (e.table.detach(), x, e._grid_meta)
    return max(compare(f"K3 lotd_grid dense+hash jac={jac}",
                       encode_into(lotd.lotd_grid, a, e.out_dim, n, dev, jac),
                       encode_into(lotd.lotd_grid_plain, a, e.out_dim, n, dev, jac),
                       1e-5, 1e-5) for jac in (False, True))


def path_point_sets(n_rays, rmax, uniform):
    """The point sets that one path hands K1 and K3 per call of ``n_rays``
    rays: the 64 coarse samples, a stage's 16 new ones, the 512 uniform
    points (training only) and, last, the final evaluation's 96."""
    sets = [("coarse", ray_points(n_rays, 64, rmax, 20)),
            ("upsample stage", ray_points(n_rays, 16, rmax, 21))]
    if uniform:
        sets.append(("uniform points", enc_points(512, rmax, 22)))
    return sets + [("final evaluation", ray_points(n_rays, 96, rmax, 0))]


def compare_rel(name, got, want, rel):
    """Max abs error over paired gradients; raises where it exceeds ``rel``
    times the largest magnitude of the plain gradient (the sums run in other
    orders, with float32 atomics on the card, so the error scales with the
    size of the sums and not with each entry)."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient")
        e, scale = float((g - w).abs().max()), float(w.abs().max())
        if e > rel * scale:
            raise AssertionError(f"{name}: max_abs_err {e:.3g} exceeds {rel:g} x {scale:.3g}")
        err = max(err, e)
    log(f"check {name}: max_abs_err {err:.3g} (tol {rel:g} x max |plain gradient|)")
    return err


def cotangents(shape, seed, dev):
    """Non-zero cotangents of a kernel's output, from a seed."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def one_cell_points(n, resolutions, seed):
    """``n`` points inside one cell of every CP resolution in ``resolutions``,
    along every axis: a box of 1e-5 around a centre that no cell face of
    those resolutions comes within 2e-5 of, so that every lane of every warp
    adds to the same two entries of each line."""
    rng = np.random.default_rng(seed)
    for c in np.linspace(0.3, 0.7, 40_001):
        if all(np.floor((c - 2e-5) * (r - 1)) == np.floor((c + 2e-5) * (r - 1))
               for r in resolutions):
            return (c + 1e-5 * (rng.random((n, 3)) - 0.5)).astype(np.float32)
    raise ValueError(f"no point lies in one cell of every resolution of {resolutions}")


def cp_bwd_point_sets(n_rows, s, rmax, resolutions, seed):
    """The point sets that the CP backwards are held on: depth-sorted samples
    along rays at a path's shape (runs of equal cells in a warp), the 512
    uniform points of the eikonal (a small grid), as many points as the first
    all in one cell (one run a warp), and 1 and 33 points (partial warps)."""
    rng = np.random.default_rng(seed)
    return [(f"{n_rows} rays x {s} sorted samples", ray_points(n_rows, s, rmax, seed)),
            ("512 uniform points", enc_points(512, rmax, seed + 1)),
            ("every point in one cell", one_cell_points(n_rows * s, resolutions, seed + 2)),
            ("N=1", rng.random((1, 3)).astype(np.float32)),
            ("N=33", rng.random((33, 3)).astype(np.float32))]


def check_cp_bwd(dev, label, bwd, plain, args_of, C, sets):
    """Hold a CP backward (``bwd``, K1's or K2's wrapper) to autograd of its
    plain version on each of ``sets`` ((name, points)), with both cotangents
    and with each alone -> [max_abs_err, ...]."""
    import torch
    errs = []
    for k, (name, pts) in enumerate(sets):
        x = torch.from_numpy(pts).to(dev)
        N = x.shape[0]
        d_out, d_jac = cotangents((C, N), 60 + k, dev), cotangents((3, C, N), 70 + k, dev)
        for which, do, dj in (("both", d_out, d_jac), ("feats", d_out, None),
                              ("jac", None, d_jac)):
            a = (*args_of(x), do, dj)
            errs.append(compare_rel(f"{label} {name} N={N} cotangents={which}", [bwd(*a)],
                                    [plain(*a)], GRAD_REL))
    return errs


def check_backward_kernels(dev, params):
    """Each backward kernel against autograd of its plain version, on the card,
    at the training step's shapes (2,048 rays x 96 samples, and 512 points)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    res, shapes = {}, {}
    enc = params["Main"].encoding
    C = enc.out_dim
    lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
    errs1, errs3 = [], []
    for N in (TRAIN_RAYS * 96, 512):
        x = T(ray_points(TRAIN_RAYS, 96, enc.cp_rmax, 6) if N != 512
              else enc_points(N, enc.cp_rmax, 6))
        d_out, d_jac = cotangents((C, N), 7, dev), cotangents((3, C, N), 8, dev)
        for name, do, dj in (("both", d_out, d_jac), ("feats", d_out, None),
                             ("jac", None, d_jac)):
            a1 = (lines, x, enc._cp_rows, do, dj)
            errs1.append(compare_rel(f"K1 bwd N={N} cotangents={name}",
                                     [lotd.lotd_cp_stacked_bwd(*a1)],
                                     [lotd.lotd_cp_stacked_bwd_plain(*a1)], GRAD_REL))
            a3 = (enc.table.numel(), x, enc._grid_meta, do, dj)
            errs3.append(compare_rel(f"K3 bwd hash N={N} cotangents={name}",
                                     [lotd.lotd_grid_bwd(*a3)],
                                     [lotd.lotd_grid_bwd_plain(*a3)], GRAD_REL))
        if N != 512:
            shapes["lotd_cp_stacked.bwd"] = dict(args=(lines, x, enc._cp_rows, d_out, d_jac))
            shapes["lotd_grid.bwd"] = dict(args=(enc.table.numel(), x, enc._grid_meta,
                                                 d_out, d_jac))
    small = small_encoding(dev)
    x = T(enc_points(65_536, 64, 9))
    a3 = (small.table.numel(), x, small._grid_meta, cotangents((small.out_dim, 65_536), 10, dev),
          cotangents((3, small.out_dim, 65_536), 11, dev))
    errs3.append(compare_rel("K3 bwd dense+hash", [lotd.lotd_grid_bwd(*a3)],
                             [lotd.lotd_grid_bwd_plain(*a3)], GRAD_REL))
    res["lotd_cp_stacked.bwd"] = (max(errs1), GRAD_REL)
    res["lotd_grid.bwd"] = (max(errs3), GRAD_REL)

    res["volume_composite.bwd"], shapes["volume_composite.bwd"] = \
        check_composite_bwd(dev, TRAIN_RAYS, 96)
    torch.cuda.synchronize()
    return res, shapes


def check_composite_bwd(dev, n, S, two_buffers=False):
    """K6's backward against autograd of its plain version at ``n`` rays of
    ``S`` lanes, with non-zero cotangents of all five outputs (vw too: the
    per-source sums of a two-buffer render send one).
    -> ((max_abs_err, tol), the inputs kept for timing)."""
    import torch
    from neuralsim_torch.renderers.buffers import (volume_composite_bwd,
                                                   volume_composite_bwd_plain)
    cargs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in composite_inputs(n, S, 12, two_buffers)]
    grads = [cotangents(sh, 13 + i, dev)
             for i, sh in enumerate(((n, S), (n,), (n,), (n, 3), (n, 3)))]
    err = compare_rel(f"K6 bwd rays={n} S={S}{' (two buffers)' if two_buffers else ''}",
                      volume_composite_bwd(*cargs, *grads),
                      volume_composite_bwd_plain(*cargs, *grads), GRAD_REL)
    return (err, GRAD_REL), dict(args=cargs + grads)


# ---------------------------------------------------------------------------
# Phase 4: the slice through the port's entry points
# ---------------------------------------------------------------------------

def frame_rays(rig, fi, dev, crop=None):
    import torch
    o, d = rig.frame_rays(fi)
    if crop is not None:
        o, d = o[crop], d[crop]
    return (torch.from_numpy(np.ascontiguousarray(o.reshape(-1, 3))).to(dev),
            torch.from_numpy(np.ascontiguousarray(d.reshape(-1, 3))).to(dev))


def render_frames(renderer, params, rig, dev, frame_ids=FRAME_IDS, **kw):
    import torch
    frames = []
    for fi in frame_ids:
        o, d = frame_rays(rig, fi, dev)
        frames.append(renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK, **kw))
    torch.cuda.synchronize()
    return frames


def check_frames(frames, H, W, corner_is_empty=True):
    import torch
    for out in frames:
        for k, v in out.items():
            if not torch.isfinite(v.float()).all():
                raise AssertionError(f"non-finite {k}")
        if out["rgb_volume"].shape != (H * W, 3) or out["depth_volume"].shape != (H * W,):
            raise AssertionError("unexpected output shapes")
    m = frames[0]["mask_volume"].reshape(H, W)
    centre, corner = float(m[H // 2, W // 2]), float(m[0, 0])
    depth = float(frames[0]["depth_volume"].reshape(H, W)[H // 2, W // 2])
    log(f"frame 0: mask_volume centre {centre:.4f} corner {corner:.4f}, centre depth {depth:.4f}")
    if not (centre > 0.5 and (corner < 0.5 or not corner_is_empty)):
        raise AssertionError("the sphere-init surface is not where it should be")


CROP_KEYS = ("rgb_volume", "depth_volume", "mask_volume", "normals_volume")


def crop_slices(H, W):
    return (slice(H // 2 - 16, H // 2 + 16), slice(W // 2 - 16, W // 2 + 16))


def check_crop(frames, renderer, params, rig, H, W, frame_id=FRAME_IDS[0], tol=CROP_TOL, **kw):
    """The centre 32x32 crop of the first frame against the CPU path."""
    crop = crop_slices(H, W)
    cpu_params = copy.deepcopy(params).to("cpu")
    o, d = frame_rays(rig, frame_id, "cpu", crop)
    ref = renderer.render_chunked(cpu_params, o, d, rayschunk=RAYSCHUNK, **kw)
    worst = 0.0
    for k in CROP_KEYS:
        g = frames[0][k].reshape((H, W) + frames[0][k].shape[1:])[crop].reshape(ref[k].shape)
        err = float((g.cpu() - ref[k]).abs().max())
        log(f"crop {k}: max_abs_err vs CPU {err:.3g} (tol {tol:g})")
        worst = max(worst, err)
    if worst > tol:
        raise AssertionError("the card's frame differs from the CPU crop")
    return worst


def check_crop_by_ray(renderer, params, o, d, dev, occ, occ_cpu, tol=EQUAL_DEPTH_TOL):
    """The rays ``o``, ``d`` (CPU tensors, one chunk) rendered on the card
    against the CPU path, ray by ray, for a model with an occupancy grid, a
    distant field and a wide stacked-CP encoding, where single rays differ by
    far more than rounding; the cause is checked, not assumed. The inverse
    CDFs of the grid's proposal and of the upsample stages move a sample on a
    last-bit difference of the field (see CROP_TOL), by ~1e-4 of its depth or,
    inside a near-empty bin, by the bin. And the encoding is no smooth
    function of the position: its tent weights are rounded to bfloat16, so a
    sample depth that differs in its last bit can flip a weight by 2^-9 and
    with it the sdf by ~1e-4, which the alpha multiplies by inv_s; and its
    gradient steps at every cell face (cells are 2/1023 of the box wide at
    R = 1,024). So a ray's outputs agree to rounding only where the sample
    depths are equal bit for bit, and that is what is held tightly:
      1. the field's nablas at the CPU path's own sample positions, evaluated
         on both devices, agree within NABLA_TOL of their largest entry;
      2. the whole render on the card AT THE CPU PATH'S SAMPLE DEPTHS (they
         take the place of the grid's proposal, with no upsample stage, so the
         wide K1 with its jacobian, the decoders, the distant field, K6 over
         both buffers and the sky all run) agrees with the CPU's on every ray
         within ``tol``;
      3. the card's own render (K4 and the K5 stages place the samples) agrees
         within ``tol`` on every ray whose close-range depths and masks equal
         the CPU's bit for bit, and there is such a ray;
      4. on the other rays another sample placement is another estimate of
         the integral, and a single ray at a silhouette may differ by tenths.
         Limited are the share of rays with a depth more than
         BENCH_SAME_SAMPLES apart (CROP_MOVED_MAX), the colour's and the
         mask's mean error over the other rays (OTHER_MEAN_TOL) and the share
         of all rays beyond BENCH_CROP_TOL in either (OTHER_OFF_MAX); their
         largest errors, the depth's and the normals' are logged.
    Errors: rgb and mask absolute; normals relative to the CPU render's
    largest normal entry (at least 1); the depth, a mean of sample depths
    that reach thousands in the distant ladder, relative to 1 + the ray's
    largest valid sample depth and held to BENCH_DEPTH_TOL, and beside it the
    close-range share of the depth integral (``rendered_cr``: depth times
    mask, depths of a few units), absolute. All sides go through ``ray_query``
    as ``render_chunked`` calls it for one chunk, which keeps the sample
    depths; ``render_chunked`` itself must return the card's outputs bit for
    bit.
    -> the worst errors of 1, 2 (as a share of its limit), 3 (likewise) and
    4, and the numbers of rays."""
    import torch
    key = renderer.pkey("cr")
    cpu_params = copy.deepcopy(params).to("cpu")
    with torch.no_grad():
        ref = renderer.ray_query(cpu_params, o, d, occ_states=occ_cpu, return_buffer=True)
        got = renderer.ray_query(params, o.to(dev), d.to(dev), occ_states=occ,
                                 return_buffer=True)
        chunked = renderer.render_chunked(params, o.to(dev), d.to(dev), rayschunk=RAYSCHUNK,
                                          occ_states=occ)
        if not all(torch.equal(chunked[k], got[k]) for k in CROP_KEYS):
            raise AssertionError("render_chunked and ray_query disagree on one chunk")
        buf, gbuf = ref["merged_buffer"], got["merged_buffer"]
        n_cr = int((buf["src"][0] == 0).sum())
        N = o.shape[0]
        t_c, m_c = buf["t"][:, :n_cr].contiguous(), buf["mask"][:, :n_cr].contiguous()
        t_g, m_g = gbuf["t"].cpu()[:, :n_cr], gbuf["mask"].cpu()[:, :n_cr]
        x = (o[:, None] + t_c[..., None] * d[:, None]).reshape(-1, 3)
        nab_cpu = cpu_params[key].sdf_nablas_feat(x)[1]
        nab_gpu = params[key].sdf_nablas_feat(x.to(dev))[1].cpu()
        same = renderer.ray_query(
            params, o.to(dev), d.to(dev), occ_states=occ, return_buffer=True,
            query_overrides={"occ_t_fn": lambda *a: (t_c.to(dev), m_c.to(dev)),
                             "num_coarse": n_cr, "num_fine": (), "upsample_inv_s_factors": ()})
        sbuf = same["merged_buffer"]
        if not (torch.equal(sbuf["t"].cpu(), buf["t"])
                and torch.equal(sbuf["mask"].cpu(), buf["mask"])):
            raise AssertionError("the card did not render at the CPU path's sample depths")
    field_err = float((nab_gpu - nab_cpu).abs().max()) / float(nab_cpu.abs().max())
    if field_err > NABLA_TOL:
        raise AssertionError("the card's nablas differ from the CPU's at equal positions")

    scale = max(1.0, float(ref["normals_volume"].abs().max()))
    t_max = (buf["t"] * buf["mask"]).amax(-1)
    cr_depth = lambda out: (out["rendered_cr"]["depth_volume"]
                            * out["rendered_cr"]["mask_volume"]).cpu()

    def ray_errs(out):
        """{output: ([N] error of each ray, its limit)}"""
        errs = {}
        for k in CROP_KEYS:
            if k == "depth_volume":
                errs[k] = ((out[k].cpu() - ref[k]).abs() / (1.0 + t_max), BENCH_DEPTH_TOL)
            elif k == "normals_volume":
                errs[k] = ((out[k].cpu() - ref[k]).abs().amax(-1) / scale, tol)
            else:
                errs[k] = ((out[k].cpu() - ref[k]).abs().reshape(N, -1).amax(-1), tol)
        errs["close-range depth integral"] = ((cr_depth(out) - cr_depth(ref)).abs(), tol)
        return errs

    valid = m_c | m_g
    gap = ((t_c - t_g).abs() / (1.0 + t_c.abs()) * valid).amax(-1)
    equal = (((t_c == t_g) | ~valid) & (m_c == m_g)).all(-1)
    other = ~equal
    moved = int((gap > BENCH_SAME_SAMPLES).sum())
    log(f"crop by ray: {N} rays; nablas at the CPU's sample positions, card vs CPU: "
        f"{field_err:.3g} of the largest (tol {NABLA_TOL:g}); {int(equal.sum())} rays with "
        f"close-range depths equal bit for bit, {moved} with one more than "
        f"{BENCH_SAME_SAMPLES:g} apart ({int((gap > 1e-5).sum())} more than 1e-05, "
        f"{int((gap > 1e-4).sum())} more than 0.0001), {int((m_c != m_g).any(-1).sum())} with "
        f"another mask")
    if not bool(equal.any()):
        raise AssertionError("the card places every ray's samples elsewhere than the CPU")
    if moved > CROP_MOVED_MAX * N:
        raise AssertionError("too many rays are sampled differently on the card")

    same_err = equal_err = 0.0           # in units of each output's own limit
    other_mean = other_max = 0.0         # absolute, of the colour and the mask
    off = torch.zeros(N, dtype=torch.bool)
    e_same, e_got = ray_errs(same), ray_errs(got)
    for k, (e, k_tol) in e_got.items():
        es = float(e_same[k][0].max())
        ee = float(e[equal].max())
        eo = e[other] if bool(other.any()) else torch.zeros(1)
        log(f"crop {k}: at the CPU's depths {es:.3g}, rays of equal depths {ee:.3g} (tol "
            f"{k_tol:g}); other rays mean {float(eo.mean()):.3g}, max {float(eo.max()):.3g}, "
            f"{int((eo > BENCH_CROP_TOL).sum())} beyond {BENCH_CROP_TOL:g}")
        same_err, equal_err = max(same_err, es / k_tol), max(equal_err, ee / k_tol)
        if k in ("rgb_volume", "mask_volume"):
            other_mean = max(other_mean, float(eo.mean()))
            other_max = max(other_max, float(eo.max()))
            off |= other & (e > BENCH_CROP_TOL)
    if same_err > 1.0:
        raise AssertionError("the card differs from the CPU at equal sample depths")
    if equal_err > 1.0:
        raise AssertionError("the card differs from the CPU on a ray that both sample alike")
    if other_mean > OTHER_MEAN_TOL or int(off.sum()) > OTHER_OFF_MAX * N:
        raise AssertionError("the card's colour or mask differs from the CPU's on the rays "
                             "that it samples elsewhere")
    return dict(field_err=field_err, same_depths_err=same_err, equal_rays_err=equal_err,
                other_mean_err=other_mean, other_max_err=other_max, off_rays=int(off.sum()),
                equal_rays=int(equal.sum()), moved_rays=moved, rays=N)


# ---------------------------------------------------------------------------
# Phase 5: the training slice
# ---------------------------------------------------------------------------

LOSS_TERMS = ("loss_total", "loss_rgb", "loss_mask", "loss_eikonal", "loss_sparsity")


def device_batch(rig, rng, n_rays, dev):
    from neuralsim_torch.tools.train import to_device_batch
    return to_device_batch(rig.sample_pixels(rng, n_rays), dev)


def occ_on(state, d):
    """The state's occupancy grids on device ``d`` (None without grids)."""
    if state.occ is None:
        return None
    return {role: type(st)(st.val.to(d), st.mask.to(d)) for role, st in state.occ.items()}


def rays_sampled_alike(trainer, state, cpu_params, batch, noise, dev, rtol):
    """The batch and its per-ray noise without the rays on which the card
    places a close-range sample elsewhere than the CPU path does (depths more
    than ``rtol`` apart, relative to 1 + depth), and the share left out."""
    import torch
    to = lambda tree, d: {k: [x.to(d) for x in v] if isinstance(v, list) else v.to(d)
                          for k, v in tree.items()}
    bufs = []
    with torch.no_grad():
        for params, d in ((cpu_params, "cpu"), (state.params, dev)):
            b = to(batch, d)
            bufs.append(trainer.renderer.ray_query(
                params, b["rays_o"], b["rays_d"], it=state.it, noise=to(noise, d),
                occ_states=occ_on(state, d), return_buffer=True)["merged_buffer"])
    ref, got = bufs
    cr = ref["src"][0] == 0
    t_c, t_g = ref["t"][:, cr], got["t"].cpu()[:, cr]
    gap = ((t_c - t_g).abs() / (1.0 + t_c.abs()) * ref["mask"][:, cr]).amax(-1)
    keep = gap <= rtol
    moved = 1.0 - float(keep.float().mean())
    log(f"first step: {int((~keep).sum())} of {keep.numel()} rays ({moved:.2%}) get another "
        f"sample placement on the card than on the CPU (depths more than {rtol:g} apart, the "
        f"largest {float(gap.max()):.3g}; median {float(gap.median()):.3g}); compared without them")
    per_ray = lambda v: v[keep] if v.shape[0] == keep.numel() else v
    noise = {k: [per_ray(x) for x in v] if isinstance(v, list) else
             (v if k == "uniform" else per_ray(v)) for k, v in noise.items()}
    return {k: v[keep] for k, v in batch.items()}, noise, moved


def check_first_step(trainer, state, rig, dev, n_rays=TRAIN_RAYS, loss_rtol=STEP_LOSS_RTOL,
                     grad_rel=STEP_GRAD_REL, same_samples=None):
    """Loss terms and per-parameter gradients of one step on the card against
    the same step (same parameters, grid, batch and noise) through the plain
    versions on the CPU. Steps nothing. With ``same_samples`` the rays that
    the two sides sample differently are left out (see
    BENCH_SAME_SAMPLES); their share must stay under
    BENCH_MOVED_MAX.
    -> (worst relative loss error, worst gradient error relative to its
    parameter's largest gradient entry)."""
    import torch
    batch = device_batch(rig, np.random.default_rng(1), n_rays, "cpu")
    noise = trainer.draw_noise(n_rays, torch.Generator().manual_seed(1))
    to = lambda tree, d: {k: [x.to(d) for x in v] if isinstance(v, list) else v.to(d)
                          for k, v in tree.items()}
    cpu_params = copy.deepcopy(state.params).to("cpu")
    if same_samples is not None:
        batch, noise, moved = rays_sampled_alike(trainer, state, cpu_params, batch, noise, dev,
                                                 same_samples)
        if moved > BENCH_MOVED_MAX:
            raise AssertionError("too many rays are sampled differently on the card")
    results = []
    for params, d in ((state.params, dev), (cpu_params, "cpu")):
        total, extras = trainer.compute_losses(params, to(batch, d), state.it, to(noise, d),
                                               occ_on(state, d))
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(total, list(named.values()))
        results.append(({"loss_total": total, **extras["losses"]},
                        {k: g.cpu() for k, g in zip(named, grads)}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results
    loss_err = 0.0
    for k, v in l_cpu.items():
        got, want = float(l_gpu[k].detach()), float(v.detach())
        e = abs(got - want) / abs(want)
        log(f"first step {k}: card {got:.6g} cpu {want:.6g} rel {e:.3g}")
        loss_err = max(loss_err, e)
    grad_err = 0.0
    for k, g in g_cpu.items():
        e = float((g_gpu[k] - g).abs().max()) / float(g.abs().max())
        log(f"first step grad {k}: rel err {e:.3g} (max |grad| {float(g.abs().max()):.3g})")
        grad_err = max(grad_err, e)
    log(f"first step: worst loss rel err {loss_err:.3g} (tol {loss_rtol:g}), worst "
        f"gradient rel err {grad_err:.3g} (tol {grad_rel:g})")
    if not (loss_err <= loss_rtol and grad_err <= grad_rel):
        raise AssertionError("the card's first training step differs from the CPU's")
    return loss_err, grad_err


def training_buffer(trainer, state, rig, dev):
    """The merged buffer of one synthetic_object training step (the close
    range composited alone, its alpha from K12), without gradients."""
    import torch
    batch = device_batch(rig, np.random.default_rng(2), TRAIN_RAYS, dev)
    noise = trainer.draw_noise(TRAIN_RAYS, torch.Generator(device=dev).manual_seed(2), state.it)
    with torch.no_grad():
        return trainer.renderer.ray_query(state.params, batch["rays_o"], batch["rays_d"],
                                          it=state.it, noise=noise, with_rgb=True,
                                          return_buffer=True,
                                          occ_states=occ_on(state, dev))["merged_buffer"]


def train_slice(cfg):
    """train() for TRAIN_STEPS steps, logging every step -> its result."""
    from neuralsim_torch.tools.train import train
    out = train({**cfg, "training": {**cfg["training"], "i_log": 1}}, TRAIN_STEPS)
    log_ = out["log"]
    if len(log_) != TRAIN_STEPS:
        raise AssertionError("train() did not log every step")
    for rec in log_:
        for k in LOSS_TERMS:
            if not np.isfinite(rec[k]):
                raise AssertionError(f"non-finite {k} at step {rec['it']}")
    if log_[-1]["skips_total"] != 0:
        raise AssertionError(f"{log_[-1]['skips_total']} steps were skipped")
    first = float(np.mean([r["loss_rgb"] for r in log_[:10]]))
    last = float(np.mean([r["loss_rgb"] for r in log_[-10:]]))
    log(f"training: loss_rgb first 10 steps {first:.5f}, last 10 steps {last:.5f}; "
        f"loss_total {log_[0]['loss_total']:.5f} -> {log_[-1]['loss_total']:.5f}")
    if not last < first:
        raise AssertionError("loss_rgb did not fall")
    return out, first, last


def check_poisoned_step(trainer, state, rig, dev, n_rays=TRAIN_RAYS):
    """A NaN in the batch: the step is skipped and leaves every parameter and
    moment bit-identical; where it falls on an occupancy grid's cadence, the
    grid is refreshed all the same."""
    import torch
    batch = device_batch(rig, np.random.default_rng(2), n_rays, dev)
    batch["image_rgb"][7, 1] = float("nan")
    before = [p.detach().clone() for p in state.params.parameters()]
    moments = [t.clone() for o in state.opt.values() for t in (*o.mu, *o.nu, o.count)]
    it = state.it
    grids = {} if state.occ is None else {r: st.val.clone() for r, st in state.occ.items()}
    state, m = trainer.train_step(
        state, batch,
        trainer.draw_noise(n_rays, torch.Generator(device=dev).manual_seed(2), it))
    torch.cuda.synchronize()
    for role, val in grids.items():
        due = it % trainer.renderer.accels[role].n_steps_between_update == 0
        fresh = not torch.equal(val, state.occ[role].val)
        log(f"poisoned step: grid '{role}' at it {it}: refresh due {due}, refreshed {fresh}, "
            f"occ_frac {float(m['occ_frac']):.4f}")
        if due != fresh or not torch.isfinite(state.occ[role].val).all():
            raise AssertionError("the occupancy grid did not follow its cadence on a skipped step")
    same = all(torch.equal(a, b) for a, b in zip(before, state.params.parameters())) and \
        all(torch.equal(a, b) for a, b in
            zip(moments, [t for o in state.opt.values() for t in (*o.mu, *o.nu, o.count)]))
    log(f"poisoned step: skipped {int(m['step_skipped'])}, skips_total "
        f"{int(m['skips_total'])}, parameters and moments unchanged {same}, it {it} -> {state.it}")
    if not (int(m["step_skipped"]) == 1 and int(m["skips_total"]) == 1 and same
            and state.it == it + 1):
        raise AssertionError("the poisoned step was not skipped cleanly")


def time_steps(trainer, state, rig, dev, reps=20, n_rays=TRAIN_RAYS):
    """Host-clock time of one training step (noise drawn on the card, batch
    already there) in ms over ``reps`` steps after 3 warm-ups: (median, min,
    max), and the times of the steps among them that refreshed an occupancy
    grid, which are kept out of the median (all_steps_ms weighs both by the
    grid's cadence)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    batches = [device_batch(rig, rng, n_rays, dev) for _ in range(4)]
    cadences = [a.n_steps_between_update for a in trainer.renderer.accels.values()]
    ts, refresh, i = [], [], 0
    while len(ts) < reps + 3:
        due = any(state.it % c == 0 for c in cadences)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batches[i % 4], trainer.draw_noise(n_rays, gen, state.it))
        torch.cuda.synchronize()
        (refresh if due else ts).append((time.perf_counter() - t0) * 1e3)
        i += 1
    ts = sorted(ts[3:])
    return (ts[reps // 2], ts[0], ts[-1]), refresh


def all_steps_ms(step_ms, refresh_ms, cadence):
    """The mean step time over a whole cadence of the grid: ``cadence - 1``
    steps at the off-cadence median and one at the mean of the refresh steps
    that were timed."""
    return ((cadence - 1) * step_ms + float(np.mean(refresh_ms))) / cadence


def off_cadence(trainer, state, rig, dev, n_rays):
    """Step until the next step refreshes no occupancy grid."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = device_batch(rig, np.random.default_rng(5), n_rays, dev)
    while any(state.it % a.n_steps_between_update == 0
              for a in trainer.renderer.accels.values()):
        trainer.train_step(state, batch, trainer.draw_noise(n_rays, gen, state.it))
    return batch, gen


def profile_step(trainer, state, rig, dev, n_rays=TRAIN_RAYS):
    """Profile one step that refreshes no grid."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch, gen = off_cadence(trainer, state, rig, dev, n_rays)
    trainer.train_step(state, batch, trainer.draw_noise(n_rays, gen, state.it))
    torch.cuda.synchronize()
    batch, gen = off_cadence(trainer, state, rig, dev, n_rays)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, trainer.draw_noise(n_rays, gen, state.it))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30))
    kernels_us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(kernels_us) / 1e3
    log(f"profile step: {len(kernels_us)} device kernels, busy {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall under the profiler")


# ---------------------------------------------------------------------------
# Phase 6: timing
# ---------------------------------------------------------------------------

def time_forward_kernels(shapes):
    """Each forward kernel, its plain version and its bound at one path's
    shapes (the inputs that check_kernels kept for that path)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd

    out = {}
    args, C = shapes["lotd_cp_stacked"]["args"], shapes["lotd_cp_stacked"]["C"]
    lines, x = args[0], args[1]
    N, F, R = x.shape[0], lines.shape[1], lines.shape[2]
    buf = (torch.empty((C, N), device=x.device), torch.empty((3, C, N), device=x.device))
    out["lotd_cp_stacked"] = dict(
        shape=f"N={N} F={F} R={R} with jacobian ({shapes['lotd_cp_stacked']['label']} of "
              f"{N // 96} rays x 96 depth-sorted samples)",
        ms=cuda_ms(lambda: lotd.lotd_cp_stacked(*args, *buf)),
        plain_ms=cuda_ms(lambda: lotd.lotd_cp_stacked_plain(*args, *buf)),
        library_ms=None,
        bound=bound(N * 12 + lines.numel() * 2 + N * F * 16, N * (30 + 29 * F)))

    args = shapes["lotd_grid"]["args"]
    meta = args[2]
    L = meta.shape[0]
    cols = int(meta[:, 3].sum())
    seg = int(sum(r[1] * r[3] for r in meta.tolist())) * 4
    out["lotd_grid"] = dict(
        shape=f"N={N} levels={L} (hash 172, 256; F=2) with jacobian, the same samples",
        ms=cuda_ms(lambda: lotd.lotd_grid(*args, *buf)),
        plain_ms=cuda_ms(lambda: lotd.lotd_grid_plain(*args, *buf), reps=5),
        library_ms=None,
        bound=bound(N * 12 + seg + N * cols * 16, N * L * (135 + 67 * 2)))

    out.update(time_sample_kernels(shapes))
    return out


def time_sample_kernels(shapes):
    """K5a, K5b and K6, their plain versions and bounds at the shapes that
    check_sample_kernels kept."""
    import torch
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    from neuralsim_torch.renderers.buffers import volume_composite, volume_composite_plain

    out = {}
    k5a = shapes["neus_upsample.weights_pdf"]
    args, noise, inv_s, nf = k5a["args"], k5a["noise"], k5a["inv_s"], k5a["nf"]
    n, S = args[0].shape
    out["neus_upsample.weights_pdf"] = dict(
        shape=f"rays={n} S={S} nf={nf} inv_s={inv_s:g} (second upsample stage, "
              f"{'drawn noise' if noise is not None else 'no noise'})",
        ms=cuda_ms(lambda: upsample_weights_pdf(*args, inv_s, nf, noise)),
        plain_ms=cuda_ms(lambda: upsample_weights_pdf_plain(*args, inv_s, nf, noise)),
        library_ms=None,
        bound=bound(n * S * 9 + n * 8 + (n if noise is not None else 1) * nf * 4
                    + n * S * 4 + n * nf * 4, n * S * (32 + 6 * nf)))

    ins = shapes["neus_upsample.merge"]["ins"]
    n, A = ins[0].shape
    B = ins[1].shape[1]
    keys = torch.cat([ins[0], ins[1]], -1)
    out["neus_upsample.merge"] = dict(
        shape=f"rays={n} A={A} B={B}",
        ms=cuda_ms(lambda: merge_sorted_samples(*ins)),
        plain_ms=cuda_ms(lambda: merge_sorted_samples_plain(*ins)),
        library_ms=cuda_ms(lambda: torch.sort(keys, dim=-1, stable=True)),
        bound=bound(2 * n * (A + B) * 9, n * (A + B)))

    cargs = shapes["volume_composite"]["args"]
    n, S = cargs[0].shape
    out["volume_composite"] = dict(
        shape=f"rays={n} S={S}",
        **card_ms(lambda: volume_composite(*cargs)),
        plain_ms=cuda_ms(lambda: volume_composite_plain(*cargs)),
        library_ms=None,
        bound=bound(n * S * 37 + n * 36, n * S * 18))
    return out


def time_composite_bwd(shape):
    """K6's backward, its plain version and bound at the kept inputs."""
    from neuralsim_torch.renderers.buffers import (volume_composite_bwd,
                                                   volume_composite_bwd_plain)
    args = shape["args"]
    n, S = args[0].shape
    return dict(
        shape=f"rays={n} S={S}, cotangents of all five outputs",
        **card_ms(lambda: volume_composite_bwd(*args)),
        plain_ms=cuda_ms(lambda: volume_composite_bwd_plain(*args), reps=3),
        library_ms=None,
        bound=bound(n * S * 37 + n * 32 + n * S * 28, n * S * 40))


def time_backward_kernels(shapes):
    from neuralsim_torch.fields.encodings import lotd
    out = {}
    args = shapes["lotd_cp_stacked.bwd"]["args"]
    lines, x = args[0], args[1]
    N, F, R = x.shape[0], lines.shape[1], lines.shape[2]
    out["lotd_cp_stacked.bwd"] = dict(
        shape=f"N={N} F={F} R={R}, cotangents of features and jacobian ({TRAIN_RAYS} rays "
              f"x 96 depth-sorted samples, as the final evaluation)",
        ms=cuda_ms(lambda: lotd.lotd_cp_stacked_bwd(*args)),
        plain_ms=cuda_ms(lambda: lotd.lotd_cp_stacked_bwd_plain(*args), reps=5),
        library_ms=None,
        bound=bound(N * 12 + lines.numel() * 2 + N * F * 16 + lines.numel() * 4,
                    N * (30 + 75 * F)))

    args = shapes["lotd_grid.bwd"]["args"]
    meta = args[2]
    L = meta.shape[0]
    cols = int(meta[:, 3].sum())
    seg = int(sum(r[1] * r[3] for r in meta.tolist())) * 4
    plan = lotd.grid_bwd_plan(meta.tolist()).at(args[1].shape[0])
    out["lotd_grid.bwd"] = dict(
        shape=f"N={N} levels={L} (hash 172, 256; F=2), cotangents of features and jacobian, "
              f"the same ray samples",
        ms=cuda_ms(lambda: lotd.lotd_grid_bwd(*args, plan=plan)),
        plain_ms=cuda_ms(lambda: lotd.lotd_grid_bwd_plain(*args), reps=3),
        library_ms=None,
        bound=bound(N * 12 + N * cols * 16 + seg, N * L * (135 + 8 * 8 * 2)))

    out["volume_composite.bwd"] = time_composite_bwd(shapes["volume_composite.bwd"])
    return out


def time_frames(renderer, params, rig, dev, reps=20, frame_id=FRAME_IDS[0], **kw):
    """Host-clock frame latency in ms over ``reps`` frames: (median, min, max)."""
    import torch
    o, d = frame_rays(rig, frame_id, dev)
    renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK, **kw)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK, **kw)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return (ts[reps // 2], ts[0], ts[-1]), o.shape[0]


def profile_frame(renderer, params, rig, dev, frame_id=FRAME_IDS[0], **kw):
    import torch
    from torch.profiler import ProfilerActivity, profile
    o, d = frame_rays(rig, frame_id, dev)
    renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    kernels_us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(kernels_us) / 1e3
    log(f"profile: {len(kernels_us)} device kernels, busy {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall under the profiler")


# ---------------------------------------------------------------------------
# Phase 6: the bench model (occupancy grid, distant field, 12 stacked-CP levels)
# ---------------------------------------------------------------------------

def check_occ_kernels(dev, trainer, state, rig):
    """K4 and K7 against their plain versions on the card, at the bench
    path's shapes. -> ({kernel: (max_abs_err, atol)}, inputs kept for timing)."""
    import torch
    from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                                occ_ray_proposal, occ_ray_proposal_plain)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    accel, st = trainer.renderer.accels["cr"], state.occ["cr"]
    space = state.params["cr"].space
    M, n = accel.march_steps, trainer.renderer.query_cfg["num_coarse"]
    box, edges = accel.box(dev), accel.edges01(M, dev)
    res, shapes, errs = {}, {}, []
    raw = rig.sample_pixels(np.random.default_rng(7), BENCH_RAYS)
    ray_sets = ((BENCH_RAYS, T(raw["rays_o"]), T(raw["rays_d"])),
                (RAYSCHUNK, *(x[:RAYSCHUNK].contiguous() for x in frame_rays(rig, 0, dev))))
    grids = (("converged", st.mask), ("empty", torch.zeros_like(st.mask)),
             ("full", torch.ones_like(st.mask)))
    for n_rays, o, d in ray_sets:
        near, far, hit = space.ray_test(o, d)
        noise = torch.rand((n_rays, n), generator=torch.Generator().manual_seed(8)).to(dev)
        mid = 0.5 * (edges[1:] + edges[:-1])
        x = o[:, None] + (near[:, None] + (far - near)[:, None] * mid)[..., None] * d[:, None]
        touched = accel.occupancy_at(st, x).any(-1)
        log(f"K4 inputs rays={n_rays}: {int(hit.sum())} hit the box, {int(touched.sum())} "
            f"touch an occupied cell, {int((hit & ~touched).sum())} hit it with no occupied probe")
        if not (0 < int(touched.sum()) < n_rays and int((hit & ~touched).sum()) > 0):
            raise AssertionError("K4's inputs lack a ray with no occupied probe")
        for label, mask in grids:
            for nz in (None, noise):
                a = (o, d, near, far, mask, *box, edges, n, nz)
                errs.append(compare(f"K4 occ_ray_proposal rays={n_rays} {label} grid "
                                    f"noise={nz is not None}", [occ_ray_proposal(*a)],
                                    [occ_ray_proposal_plain(*a)], **K4_TOL))
        if n_rays == BENCH_RAYS:
            shapes["occ_ray_proposal"] = dict(args=(o, d, near, far, st.mask, *box, edges, n,
                                                    noise))
        # probes that leave the box: march [0.1, 6] instead of the box's own [near, far]
        a = (o, d, torch.full_like(near, 0.1), torch.full_like(far, 6.0), st.mask, *box, edges,
             n, noise)
        errs.append(compare(f"K4 occ_ray_proposal rays={n_rays} probes outside the box",
                            [occ_ray_proposal(*a)], [occ_ray_proposal_plain(*a)], **K4_TOL))
    res["occ_ray_proposal"] = (max(errs), K4_TOL["atol"])

    V, errs = accel.res ** 3, []
    rng = np.random.default_rng(9)
    for S in (1, 4):
        sdf = T(rng.normal(0.0, 0.2, (S, V)).astype(np.float32))
        val = T(rng.random(V).astype(np.float32))
        for mode, p, raw_v in (("sdf", accel.voxel_half_diag, sdf),
                               ("density", accel.voxel_size, sdf.abs() * 40.0)):
            for floor in (None, accel.occ_thre + 1e-3):
                a = (raw_v, val, mode, p, accel.occ_inv_s, accel.ema_decay, accel.occ_thre, floor)
                got, want = occ_ema_update(*a), occ_ema_update_plain(*a)
                errs.append(compare(f"K7 occ_ema_update {accel.res}^3 S={S} {mode} "
                                    f"warm-up={floor is not None}", got[:1], want[:1], 0, K7_ATOL))
                off = (got[1] != want[1]) & ((want[0] - accel.occ_thre).abs() > K7_ATOL)
                if bool(off.any()) or got[1].dtype != torch.bool:
                    raise AssertionError("K7: the mask differs away from the threshold")
                if S == 1 and mode == "sdf" and floor is None:
                    shapes["occ_ema_update"] = dict(args=a)
    res["occ_ema_update"] = (max(errs), K7_ATOL)
    torch.cuda.synchronize()
    return res, shapes


def check_wide_encoding(dev, params):
    """K1 forward and backward at F = 96, R = 1,024 against their plain
    versions, at the point sets the bench path hands them."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    enc = params["cr"].encoding
    C, rmax = enc.out_dim, enc.cp_rmax
    lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
    log(f"wide K1: lines {tuple(lines.shape)} bf16, {lines.numel() * 4} bytes as float32")
    sets = (("coarse", ray_points(BENCH_RAYS, 16, rmax, 30), (False,)),
            ("upsample stage", ray_points(BENCH_RAYS, 8, rmax, 31), (False,)),
            ("uniform points", enc_points(1024, rmax, 32), (True,)),
            ("grid refresh chunk", enc_points(2_000_000, rmax, 33), (False,)),
            ("render final", ray_points(RAYSCHUNK, 32, rmax, 34), (True,)),
            ("final evaluation", ray_points(BENCH_RAYS, 32, rmax, 35), (False, True)))
    res, shapes, errs = {}, {}, []
    for label, pts, jacs in sets:
        x = T(pts)
        a1 = (lines, x, enc._cp_rows)
        for jac in jacs:
            errs.append(compare(f"K1 wide {label} N={x.shape[0]} jac={jac}",
                                encode_into(lotd.lotd_cp_stacked, a1, C, x.shape[0], dev, jac),
                                encode_into(lotd.lotd_cp_stacked_plain, a1, C, x.shape[0], dev, jac),
                                1e-5, 1e-5))
    res["lotd_cp_stacked"] = (max(errs), 1e-5)
    shapes["lotd_cp_stacked"] = dict(args=a1, C=C, label="final evaluation", samples=32)
    errs = []
    for N in (BENCH_RAYS * 32, 1024):
        x = T(ray_points(BENCH_RAYS, 32, rmax, 36) if N != 1024 else enc_points(N, rmax, 36))
        d_out, d_jac = cotangents((C, N), 37, dev), cotangents((3, C, N), 38, dev)
        for name, do, dj in (("both", d_out, d_jac), ("feats", d_out, None), ("jac", None, d_jac)):
            a = (lines, x, enc._cp_rows, do, dj)
            errs.append(compare_rel(f"K1 wide bwd N={N} cotangents={name}",
                                    [lotd.lotd_cp_stacked_bwd(*a)],
                                    [lotd.lotd_cp_stacked_bwd_plain(*a)], GRAD_REL))
        if N != 1024:
            shapes["lotd_cp_stacked.bwd"] = dict(args=(lines, x, enc._cp_rows, d_out, d_jac),
                                                 samples=32)
    res["lotd_cp_stacked.bwd"] = (max(errs), GRAD_REL)
    torch.cuda.synchronize()
    return res, shapes


def bench_steps(trainer, state, rig, dev):
    """BENCH_STEPS steps of BENCH_RAYS rays -> the per-step metrics."""
    import torch
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    log_ = []
    for _ in range(BENCH_STEPS):
        it = state.it
        batch = device_batch(rig, rng, BENCH_RAYS, dev)
        state, m = trainer.train_step(state, batch, trainer.draw_noise(BENCH_RAYS, gen, it))
        log_.append({"it": it, **{k: float(v) for k, v in m.items() if v.dim() == 0}})
    for rec in log_:
        for k in LOSS_TERMS:
            if not np.isfinite(rec[k]):
                raise AssertionError(f"bench model: non-finite {k} at step {rec['it']}")
        if not 0.0 < rec["occ_frac"] < 1.0:
            raise AssertionError(f"bench model: occ_frac {rec['occ_frac']} at step {rec['it']}")
    if log_[-1]["skips_total"] != 0:
        raise AssertionError(f"bench model: {log_[-1]['skips_total']} steps were skipped")
    first = float(np.mean([r["loss_rgb"] for r in log_[:10]]))
    last = float(np.mean([r["loss_rgb"] for r in log_[-10:]]))
    log(f"bench training: loss_rgb first 10 steps {first:.5f}, last 10 steps {last:.5f}; "
        f"loss_total {log_[0]['loss_total']:.5f} -> {log_[-1]['loss_total']:.5f}; occ_frac "
        f"{log_[0]['occ_frac']:.4f} -> {log_[-1]['occ_frac']:.4f}")
    if not last < first:
        raise AssertionError("bench model: loss_rgb did not fall")
    return log_, first, last


def time_bench_kernels(shapes):
    """K4, K7 and the wide K1 (forward and backward) beside their plain
    versions and bounds, at the bench step's shapes."""
    import torch
    from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                                occ_ray_proposal, occ_ray_proposal_plain)
    from neuralsim_torch.fields.encodings import lotd
    out = {}
    a = shapes["occ_ray_proposal"]["args"]
    N, n, M = a[0].shape[0], a[8], a[7].shape[0] - 1
    out["occ_ray_proposal"] = dict(
        shape=f"rays={N} march segments={M} samples={n} grid={a[4].shape[0]}^3 (drawn noise)",
        **card_ms(lambda: occ_ray_proposal(*a)),
        plain_ms=cuda_ms(lambda: occ_ray_proposal_plain(*a)),
        library_ms=None,
        bound=bound(N * 32 + N * M + (M + 1) * 4 + 2 * N * n * 4, N * (M * 30 + n * M * 6)))
    a = shapes["occ_ema_update"]["args"]
    S, V = a[0].shape
    out["occ_ema_update"] = dict(
        shape=f"voxels={V} samples per voxel={S} (sdf, after the warm-up)",
        ms=cuda_ms(lambda: occ_ema_update(*a)),
        plain_ms=cuda_ms(lambda: occ_ema_update_plain(*a)),
        library_ms=None,
        bound=bound(V * (4 * S + 4 + 4 + 1), V * (S * 12 + 4)))
    a, C = shapes["lotd_cp_stacked"]["args"], shapes["lotd_cp_stacked"]["C"]
    lines, x = a[0], a[1]
    N, F, R = x.shape[0], lines.shape[1], lines.shape[2]
    buf = (torch.empty((C, N), device=x.device), torch.empty((3, C, N), device=x.device))
    out["lotd_cp_stacked"] = dict(
        shape=f"N={N} F={F} R={R} with jacobian (final evaluation of {N // 32} rays x 32 "
              f"depth-sorted samples)",
        ms=cuda_ms(lambda: lotd.lotd_cp_stacked(*a, *buf)),
        plain_ms=cuda_ms(lambda: lotd.lotd_cp_stacked_plain(*a, *buf), reps=5),
        library_ms=None,
        bound=bound(N * 12 + lines.numel() * 2 + N * F * 16, N * (30 + 29 * F)))
    a = shapes["lotd_cp_stacked.bwd"]["args"]
    out["lotd_cp_stacked.bwd"] = dict(
        shape=f"N={N} F={F} R={R}, cotangents of features and jacobian ({N // 32} rays x 32 "
              f"depth-sorted samples)",
        ms=cuda_ms(lambda: lotd.lotd_cp_stacked_bwd(*a)),
        plain_ms=cuda_ms(lambda: lotd.lotd_cp_stacked_bwd_plain(*a), reps=3),
        library_ms=None,
        bound=bound(N * 12 + lines.numel() * 2 + N * F * 16 + lines.numel() * 4,
                    N * (30 + 75 * F)))
    return out


def bench_phase(dev, profile_it):
    """Phase 6 and the bench model's share of the timing -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import BENCH_OBJECT
    from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
    from neuralsim_torch.tools.build import build_trainer

    rig = SyntheticObjectDataset(**BENCH_OBJECT["dataset_cfg"]["params"])
    t0 = time.perf_counter()
    trainer, state = build_trainer(BENCH_OBJECT)
    torch.cuda.synchronize()
    renderer, accel = trainer.renderer, trainer.renderer.accels["cr"]
    occ_frac0 = float(accel.occupied_fraction(state.occ["cr"]))
    log(f"bench model: built, grid {accel.res}^3 converged in {time.perf_counter() - t0:.2f} s, "
        f"occupied fraction {occ_frac0:.4f}")
    if not 0.0 < occ_frac0 < 0.5:
        raise AssertionError("the converged grid should hold a small occupied share")

    errs, shapes = check_occ_kernels(dev, trainer, state, rig)
    errs_k1, shapes_k1 = check_wide_encoding(dev, state.params)
    errs.update(errs_k1)
    shapes.update(shapes_k1)
    # K5a, K5b, K6 and K6's backward at this path's shapes: 16 coarse samples
    # that two stages of 8 draws widen to 24 and 32, at inv_s 64 and 256; the
    # composite over the close-range and distant buffers together; a rendered
    # chunk's rays, then a step's (the ones timed)
    q = renderer.query_cfg
    widths = np.cumsum([q["num_coarse"], *q["num_fine"]]).tolist()
    stages = tuple((w, q["upsample_inv_s"] * f)
                   for w, f in zip(widths, q["upsample_inv_s_factors"]))
    comp_s = widths[-1] + renderer.distant_query_cfg["num_samples"]
    if (stages, set(q["num_fine"]), comp_s) != (((16, 64.0), (24, 256.0)), {8}, 64):
        raise AssertionError("the bench model's sample counts are not the ones checked here")
    for n_rays in (RAYSCHUNK, BENCH_RAYS):
        errs_s, shapes_s = check_sample_kernels(dev, n_rays, stages, q["num_fine"][0], comp_s,
                                                noisy=True, two_buffers=True)
        for name, (e, tol) in errs_s.items():
            errs[name] = (max(e, errs.get(name, (0.0, tol))[0]), tol)
    shapes.update(shapes_s)
    errs["volume_composite.bwd"], shapes["volume_composite.bwd"] = \
        check_composite_bwd(dev, BENCH_RAYS, comp_s, two_buffers=True)

    step_loss_err, step_grad_err = check_first_step(
        trainer, state, rig, dev, BENCH_RAYS, BENCH_STEP_LOSS_RTOL, BENCH_STEP_GRAD_REL,
        BENCH_SAME_SAMPLES)

    kernels.reset_counts()
    log_, rgb_first, rgb_last = bench_steps(trainer, state, rig, dev)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    refreshes = sum(1 for r in log_ if r["it"] % accel.n_steps_between_update == 0)
    log(f"bench training slice: {BENCH_STEPS} steps of {BENCH_RAYS} rays, {refreshes} grid "
        f"refreshes, launches {launches}")
    if launches["occ_ray_proposal"] != BENCH_STEPS or launches["occ_ema_update"] != refreshes \
            or refreshes != 3:
        raise AssertionError("K4 must launch once a step and K7 once a refresh")
    for name in ("lotd_cp_stacked", "lotd_cp_stacked.bwd", "neus_upsample.weights_pdf",
                 "neus_upsample.merge", "volume_composite", "volume_composite.bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the bench training path")
    if launches["lotd_grid"] or launches["lotd_grid.bwd"]:
        raise AssertionError("the bench encoding has no gather level, yet K3 launched")
    if state.it % accel.n_steps_between_update != 0:
        raise AssertionError("the poisoned step should fall on the grid's cadence")
    k7 = kernels.KERNELS["occ_ema_update"].launches
    check_poisoned_step(trainer, state, rig, dev, BENCH_RAYS)
    if kernels.KERNELS["occ_ema_update"].launches != k7 + 1:
        raise AssertionError("the skipped step on the cadence did not launch K7")

    kernels.reset_counts()
    frames = render_frames(renderer, state.params, rig, dev, BENCH_FRAME_IDS,
                           occ_states=state.occ)
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    chunks = len(BENCH_FRAME_IDS) * (rig.H * rig.W // RAYSCHUNK)
    log(f"bench render slice: {len(BENCH_FRAME_IDS)} frames of {rig.H}x{rig.W}, launches "
        f"{launches_render}")
    if launches_render["occ_ray_proposal"] != chunks or launches_render["occ_ema_update"]:
        raise AssertionError("a rendered chunk launches K4 once and K7 never")
    check_frames(frames, rig.H, rig.W, corner_is_empty=False)
    by_ray = check_crop_by_ray(
        renderer, state.params,
        *frame_rays(rig, BENCH_FRAME_IDS[0], "cpu", crop_slices(rig.H, rig.W)), dev,
        state.occ, occ_on(state, "cpu"))

    (frame_ms, frame_min, frame_max), n_rays = time_frames(
        renderer, state.params, rig, dev, frame_id=BENCH_FRAME_IDS[0], occ_states=state.occ)
    log(f"timing: bench frame median {frame_ms:.3f} ms (min {frame_min:.3f}, max "
        f"{frame_max:.3f}) for {n_rays} rays, {n_rays / frame_ms * 1e3:.1f} rays/s")
    (step_ms, step_min, step_max), refresh_ms = time_steps(trainer, state, rig, dev,
                                                           n_rays=BENCH_RAYS)
    all_ms = all_steps_ms(step_ms, refresh_ms, accel.n_steps_between_update)
    log(f"timing: bench training step median {step_ms:.3f} ms (min {step_min:.3f}, max "
        f"{step_max:.3f}) for {BENCH_RAYS} rays, {BENCH_RAYS / step_ms * 1e3:.1f} rays/s; steps "
        f"that refresh the grid apart: {['%.3f' % t for t in refresh_ms]} ms; over all steps "
        f"(one refresh in {accel.n_steps_between_update}) {all_ms:.3f} ms, "
        f"{BENCH_RAYS / all_ms * 1e3:.1f} rays/s; hand-kernel "
        f"launches per step {sum(launches.values()) / BENCH_STEPS:.1f}")
    times = {**time_bench_kernels(shapes), **time_sample_kernels(shapes),
             "volume_composite.bwd": time_composite_bwd(shapes["volume_composite.bwd"])}
    if profile_it:
        profile_frame(renderer, state.params, rig, dev, BENCH_FRAME_IDS[0], occ_states=state.occ)
        profile_step(trainer, state, rig, dev, BENCH_RAYS)
    summary = {"bench_occ_frac_converged": occ_frac0, "bench_occ_frac_last": log_[-1]["occ_frac"],
               "bench_frame_ms": frame_ms, "bench_frame_ms_min": frame_min,
               "bench_frame_ms_max": frame_max, "bench_rays_per_s": n_rays / frame_ms * 1e3,
               "bench_crop_by_ray": by_ray,
               "bench_train_step_ms": step_ms,
               "bench_train_step_ms_min": step_min, "bench_train_step_ms_max": step_max,
               "bench_train_rays_per_s": BENCH_RAYS / step_ms * 1e3,
               "bench_refresh_step_ms": refresh_ms, "bench_train_step_ms_all_steps": all_ms,
               "bench_train_rays_per_s_all_steps": BENCH_RAYS / all_ms * 1e3,
               "bench_train_steps": BENCH_STEPS,
               "bench_loss_rgb_first10": rgb_first, "bench_loss_rgb_last10": rgb_last,
               "bench_first_step_loss_rel_err": step_loss_err,
               "bench_first_step_grad_rel_err": step_grad_err}
    return dict(errs=errs, times=times, launches=launches, launches_render=launches_render,
                n_frames=len(BENCH_FRAME_IDS), summary=summary)


# ---------------------------------------------------------------------------
# Phase 7: the multi-object compose render (WAYMO_DEMO_MULTI)
# ---------------------------------------------------------------------------

def unsorted_inputs(n, L, seed):
    """An unsorted merged buffer [n, L]: depths with ties within and across
    sources, masked lanes anywhere and fully masked rays, alphas of 0, 1,
    near 1 and above 1 (clipped)."""
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, 80, (n, L)) / 8.0).astype(np.float32)
    alpha = (rng.random((n, L)) ** 3).astype(np.float32)
    alpha[:, ::7] = 1.0
    alpha[:, 3::11] = 0.9995
    alpha[:, 5::13] = 0.0
    alpha[1::17] = 1.2
    mask = rng.random((n, L)) > 0.25
    mask[2::19] = False
    return t, mask, alpha


def edge_alpha_inputs(n, L, seed):
    """:func:`unsorted_inputs` with alphas also at the clip's and the
    occlusion cap's edges, where JAX splits a gradient in halves: exactly 0
    and 1 inside the mask, float32(0.999), and below 0."""
    t, mask, alpha = unsorted_inputs(n, L, seed)
    alpha[:, 2::9] = np.float32(0.999)
    alpha[:, 4::17] = -0.1
    alpha[::3, 6::19] = 0.0
    alpha[::5, 8::21] = 1.0
    return t, mask, alpha


def check_cross_source_vw(dev, path_buffer):
    """K8 against its plain version: on the merged buffer of one chunk of the
    compose path (t, mask, alpha [4,096, 168]) and on unsorted buffers of
    ragged widths (1 to 1,100 lanes) with ties, masked lanes, fully masked
    rays and alphas at and near 1."""
    import torch
    from neuralsim_torch.ops.segment import cross_source_vw, cross_source_vw_plain
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sets = [("path chunk", path_buffer)] + [
        ("ties, masked lanes, alpha near 1", [T(a) for a in unsorted_inputs(n, L, L)])
        for n, L in ((4096, 168), (333, 1), (257, 5), (1000, 33), (512, 257), (64, 1100))]
    errs = []
    for label, args in sets:
        N, L = args[0].shape
        errs.append(compare(f"K8 cross_source_vw {label} rays={N} L={L}",
                            [cross_source_vw(*args)], [cross_source_vw_plain(*args)], **K8_TOL))
    torch.cuda.synchronize()
    return max(errs)


def check_compose_encodings(dev, params, models):
    """K1 at the street's width (F_cp 40, R 1,024) and the vehicles' (F_cp
    24, R 256), and K3 on the vehicles' two dense levels (8 and 13, F 4), at
    the point sets of one chunk: the street's 4,096 rays x 32 coarse, 8 new a
    stage and 48 final samples; the vehicles' 3 x 2,048 rows x 24, 8 and 32
    (the final ones with and without the jacobian).
    ``models``: ((label, model id, (coarse, stage, final) widths), ...).
    -> ({kernel: (max_abs_err, atol)}, the final sets kept for timing)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    errs1, errs3, shapes = [], [], {}
    for label, mid, n_rows, widths in models:
        enc = params[mid].encoding
        C, rmax = enc.out_dim, enc.cp_rmax
        lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
        for seed, (stage, s) in enumerate(zip(("coarse", "upsample stage", "final"), widths), 40):
            x = T(ray_points(n_rows, s, rmax, seed))
            N = x.shape[0]
            a1, a3 = (lines, x, enc._cp_rows), (enc.table.detach(), x, enc._grid_meta)
            for jac in ((False, True) if stage == "final" else (False,)):
                errs1.append(compare(f"K1 {label} F={lines.shape[1]} R={lines.shape[2]} {stage} "
                                     f"N={N} jac={jac}",
                                     encode_into(lotd.lotd_cp_stacked, a1, C, N, dev, jac),
                                     encode_into(lotd.lotd_cp_stacked_plain, a1, C, N, dev, jac),
                                     1e-5, 1e-5))
                if enc.grid_spec_ids:
                    errs3.append(compare(f"K3 {label} dense levels {stage} N={N} jac={jac}",
                                         encode_into(lotd.lotd_grid, a3, C, N, dev, jac),
                                         encode_into(lotd.lotd_grid_plain, a3, C, N, dev, jac),
                                         1e-5, 1e-5))
        what = f"final evaluation of {n_rows} rows x {widths[-1]} samples"
        shapes[f"lotd_cp_stacked/{label}"] = dict(args=a1, C=C, what=what)
        if enc.grid_spec_ids:
            shapes[f"lotd_grid/{label}"] = dict(args=a3, C=C, what=what)
    torch.cuda.synchronize()
    return {"lotd_cp_stacked": (max(errs1), 1e-5), "lotd_grid": (max(errs3), 1e-5)}, shapes


def check_compose_occ(dev, accel, st, space, o, d, n):
    """K4 at the street's shapes: one chunk's 4,096 rays, 64 march segments
    (one 64-bit word of occupancy bits, the top of the kernel's range), n =
    32 draws, the converged 128^3 grid, without noise (the render) and with;
    probes that leave the box. -> (max_abs_err, the inputs kept for timing)."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
    M = accel.march_steps
    box, edges = accel.box(dev), accel.edges01(M, dev)
    near, far, hit = space.ray_test(o, d)
    noise = torch.rand((o.shape[0], n), generator=torch.Generator().manual_seed(8)).to(dev)
    errs = []
    for label, nz, nf in (("converged grid", None, (near, far)),
                          ("converged grid, noise", noise, (near, far)),
                          ("probes outside the box", noise,
                           (torch.full_like(near, 0.1), torch.full_like(far, 120.0)))):
        a = (o, d, *nf, st.mask, *box, edges, n, nz)
        errs.append(compare(f"K4 occ_ray_proposal rays={o.shape[0]} M={M} n={n} {label}",
                            [occ_ray_proposal(*a)], [occ_ray_proposal_plain(*a)], **K4_TOL))
    torch.cuda.synchronize()
    return max(errs), dict(args=(o, d, near, far, st.mask, *box, edges, n, None))


def check_compose_frames(frames, H, W, vehicles):
    """Every output finite and of the frame's shape, the mask in [0,
    MASK_CAP], the sources' shares summing to the whole; the street shows in
    every frame and a vehicle in some frame."""
    import torch
    shown = 0
    for fi, out in zip(COMPOSE_FRAME_IDS, frames):
        subs = [("", {k: v for k, v in out.items() if k != "per_obj"})] + \
            [(f"{n}.", sub) for n, sub in out["per_obj"].items()]
        for prefix, d in subs:
            for k, v in d.items():
                if not torch.isfinite(v).all():
                    raise AssertionError(f"frame {fi}: non-finite {prefix}{k}")
                if v.shape[0] != H * W:
                    raise AssertionError(f"frame {fi}: {prefix}{k} of shape {tuple(v.shape)}")
        m = out["mask_volume"]
        share = sum(sub["mask_volume"] for sub in out["per_obj"].values())
        share_err = float((share - m).abs().max())
        veh = sum(int((out["per_obj"][v]["mask_volume"] > 0.5).sum()) for v in vehicles)
        street = float(out["per_obj"]["street"]["mask_volume"].mean())
        log(f"compose frame {fi}: mask_volume in [{float(m.min()):.4f}, {float(m.max()):.6f}], "
            f"sources sum to it within {share_err:.3g} (tol {SHARE_SUM_TOL:g}); street mean "
            f"share {street:.4f}, distant {float(out['per_obj']['distant']['mask_volume'].mean()):.4f}"
            f", {veh} pixels with a vehicle share above 0.5")
        if float(m.min()) < 0.0 or float(m.max()) > MASK_CAP:
            raise AssertionError(f"frame {fi}: mask_volume leaves [0, {MASK_CAP}]")
        if share_err > SHARE_SUM_TOL:
            raise AssertionError(f"frame {fi}: the sources' mask volumes do not sum to the total")
        if not street > 0.05:
            raise AssertionError(f"frame {fi}: the street does not show")
        shown += veh
    if shown == 0:
        raise AssertionError("no vehicle shows in any frame")


def compose_crop(H, W):
    """16 rows below the horizon x the centre 64 columns, 1,024 rays: the road
    ahead and, at frame 0, the oncoming vehicle in the middle lane."""
    return slice(H // 2, H // 2 + 16), slice(W // 2 - 32, W // 2 + 32)


def at_street_depths(renderer, t, mask, groups=None):
    """A copy of the compose ``renderer`` whose street samples at the depths
    ``t`` and masks ``mask`` [N, S] (moved to the rays' device) in place of
    its grid's proposal and upsample stages, and whose groups of a shared
    model with per-instance grids take the coarse depths ``groups`` {model
    id: [rows, n]} in place of their grids' proposal (K10); everything else
    as it was."""
    import torch
    from neuralsim_torch.renderers.buffer_compose import ObjectBinding
    mid, qcfg = renderer.scene_models["cr"]
    fixed = copy.copy(renderer)
    fixed.scene_models = {**renderer.scene_models, "cr": (mid, {
        **qcfg, "num_coarse": t.shape[1], "num_fine": (), "upsample_inv_s_factors": (),
        "occ_t_fn": lambda ro, *a: (t.to(ro.device), mask.to(ro.device))})}
    fixed_t = lambda tg: lambda ro, *a: (tg.to(ro.device),
                                         torch.ones(tg.shape, dtype=torch.bool, device=ro.device))
    fixed.objects = [ObjectBinding(ob.obj_id, ob.model_id,
                                   {**ob.query_cfg, "occ_t_fn": fixed_t(groups[ob.model_id])},
                                   ob.bidx)
                     if groups and ob.model_id in groups else ob for ob in renderer.objects]
    return fixed


@contextlib.contextmanager
def group_proposals(renderer, record):
    """Record into ``record`` {model id: depths} the coarse depths that each
    shared model's per-instance grids propose (K10) while the block runs."""
    grids = {mid: a for mid, a in renderer.accels.items() if mid != "cr" and a.n_grids}

    def wrap(mid, accel):
        def proposal(*a, **kw):
            t, m = type(accel).ray_proposal_batched(accel, *a, **kw)
            record[mid] = t.detach().clone()
            return t, m
        return proposal

    for mid, accel in grids.items():
        accel.ray_proposal_batched = wrap(mid, accel)
    try:
        yield
    finally:
        for accel in grids.values():
            del accel.ray_proposal_batched


def at_lattice_inputs(field, u, x, bidx):
    """A permutohedral ``field``'s sdf_nablas_feat at ``x`` with the lattice
    inputs ``u`` in place of its own."""
    field._encoding_input = lambda *a: u
    try:
        return field.sdf_nablas_feat(x, bidx=bidx)
    finally:
        del field._encoding_input


def check_compose_crop(renderer, params, frozen, frozen_cpu, o, d, dev, occ, occ_cpu):
    """The rays ``o``, ``d`` (CPU tensors, one chunk) of the compose render on
    the card against the CPU path, ray by ray, as check_crop_by_ray holds the
    bench model, and for the same reason: the inverse CDFs of the street's
    grid proposal and of every upsample stage move a sample on a last-bit
    difference, and the bf16 tent weights make the field step between
    positions a few ulps apart. Held:
      1. the merge on identical buffers: the CPU path's per-source buffers
         merged on the card (K8 and the masked sums) against the same merge
         on the CPU: the weights within K8_TOL, every output and every
         source's share within EQUAL_DEPTH_TOL (the depth relative to 1 + the
         ray's largest sample depth, at BENCH_DEPTH_TOL);
      2. the fields at the CPU path's own sample positions (the street's, and
         each vehicle's in its canonical frame with its instance index),
         evaluated on both devices: sdf within FIELD_SDF_TOL, nablas within
         NABLA_TOL of their largest entry. A permutohedral field's lattice
         input holds sigmoid(latent), which the card and the CPU may round
         apart in the last bit, and a position that close to a simplex face
         takes the other simplex, whose jacobian differs: so each device's
         field is also evaluated at the other's lattice inputs, and the nablas
         are held at equal inputs, at every position, both ways (the sdf
         at every input);
      3. the whole render AT THE CPU PATH'S STREET DEPTHS (at_street_depths,
         on both devices, with a shared model's per-instance grid proposals
         at the CPU path's depths too; on the CPU it must reproduce its path's
         buffer bit for bit): on the rays whose every depth and mask are then equal bit
         for bit (at least COMPOSE_EQUAL_MIN of them), every output and every
         source's share within the limits of 1; the other rays (a vehicle
         depth a few ulps apart) by the mean error of colour and mask
         (OTHER_MEAN_TOL) and the share beyond BENCH_CROP_TOL (OTHER_OFF_MAX);
      4. the card's own render (K4 and the K5 stages place the street's
         samples) by the share of rays with a depth more than
         BENCH_SAME_SAMPLES apart (COMPOSE_MOVED_MAX) and, over all rays,
         the mean error of colour and mask (OTHER_MEAN_TOL) and the share
         beyond BENCH_CROP_TOL (COMPOSE_OFF_MAX).
    ``render_chunked`` over the one chunk must equal ``ray_query`` bit for
    bit. Everything is logged before anything is held.
    -> the worst errors and the numbers of rays."""
    import torch
    from neuralsim_torch.fields.encodings.permuto import PermutoEncoding
    from neuralsim_torch.maths.transforms import apply_transform, inverse_transform
    from neuralsim_torch.renderers.buffers import merge_and_integrate
    cpu_params = copy.deepcopy(params).to("cpu")
    N = o.shape[0]
    groups = {}
    with torch.no_grad():
        with group_proposals(renderer, groups):
            ref = renderer.ray_query(cpu_params, frozen_cpu, o, d, occ_states=occ_cpu,
                                     return_buffer=True)
        got = renderer.ray_query(params, frozen, o.to(dev), d.to(dev), occ_states=occ,
                                 return_buffer=True)
        chunked = renderer.render_chunked(params, frozen, o.to(dev), d.to(dev), rayschunk=N,
                                          occ_states=occ)
        chunk_same = all(torch.equal(chunked[k], got[k]) for k in CROP_KEYS)
        buf, gbuf = ref["merged_buffer"], {k: v.cpu() for k, v in got["merged_buffer"].items()}
        names = ref["src_names"]
        src = buf["src"][0]
        counts = [int((src == i).sum()) for i in range(len(names))]
        keys = ("t", "mask", "alpha", "rgb", "nablas")
        parts = [dict(zip(keys, vals))
                 for vals in zip(*(torch.split(buf[k], counts, dim=1) for k in keys))]
        merged = [merge_and_integrate(bufs, with_per_src=True, sort_free=True)
                  for bufs in (parts, [{k: v.to(dev) for k, v in p.items()} for p in parts])]
        # the fields at the CPU path's sample positions: (label, model id, points, bidx)
        x_w = o[:, None] + buf["t"][..., None] * d[:, None]
        probes = [("street", renderer.scene_models["cr"][0], x_w[:, src == names.index("street")]
                   .reshape(-1, 3), None)]
        for ob in renderer.objects:
            lane = (src == names.index(ob.obj_id)) & buf["mask"].any(0)
            w2n = inverse_transform(frozen_cpu.world_transform(ob.obj_id))
            x_l = apply_transform(w2n, x_w[:, lane].reshape(-1, 3)) / frozen_cpu.data(ob.obj_id)["scale"]
            keep = buf["mask"][:, lane].reshape(-1)
            probes.append((ob.obj_id, ob.model_id, x_l[keep],
                           torch.full((int(keep.sum()),), ob.bidx, dtype=torch.long)))
        field_errs, lattice_errs = {}, {}
        for label, mid, x, bidx in probes:
            if x.shape[0] == 0:
                continue
            bidx_dev = None if bidx is None else bidx.to(dev)
            sc, nc, _ = cpu_params[mid].sdf_nablas_feat(x, bidx=bidx)
            sg, ng, _ = params[mid].sdf_nablas_feat(x.to(dev), bidx=bidx_dev)
            e_nab = (ng.cpu() - nc).abs().amax(-1) / float(nc.abs().max())
            e_sdf = float((sg.cpu() - sc).abs().max())
            if not isinstance(params[mid].encoding, PermutoEncoding):
                field_errs[label] = (e_sdf, float(e_nab.max()), x.shape[0])
                continue
            # the field of each device at the other's lattice inputs
            u_cpu = cpu_params[mid]._encoding_input(x, bidx)
            u_card = params[mid]._encoding_input(x.to(dev), bidx_dev)
            differ = (u_card.cpu().view(torch.int32) != u_cpu.view(torch.int32))
            sa, na, _ = at_lattice_inputs(params[mid], u_cpu.to(dev), x.to(dev), bidx_dev)
            sb, nb, _ = at_lattice_inputs(cpu_params[mid], u_card.cpu(), x, bidx)
            e_cpu_in = (na.cpu() - nc).abs().amax(-1) / float(nc.abs().max())
            e_card_in = (ng.cpu() - nb).abs().amax(-1) / float(nb.abs().max())
            beyond = e_nab > NABLA_TOL
            field_errs[label] = (max(e_sdf, float((sa.cpu() - sc).abs().max()),
                                     float((sg.cpu() - sb).abs().max())),
                                 max(float(e_cpu_in.max()), float(e_card_in.max())), x.shape[0])
            lattice_errs[label] = (int(differ.any(-1).sum()), int(differ[:, :3].any(-1).sum()),
                                   int(beyond.sum()), int((beyond & differ.any(-1)).sum()),
                                   float(e_cpu_in.max()), float(e_card_in.max()))
        # 3. the render at the CPU path's street depths, on both devices
        street = src == names.index("street")
        fixed = at_street_depths(renderer, buf["t"][:, street].contiguous(),
                                 buf["mask"][:, street].contiguous(), groups)
        ref_at = fixed.ray_query(cpu_params, frozen_cpu, o, d, occ_states=occ_cpu,
                                 return_buffer=True)
        got_at = fixed.ray_query(params, frozen, o.to(dev), d.to(dev), occ_states=occ,
                                 return_buffer=True)
        abuf = ref_at["merged_buffer"]
        agbuf = {k: v.cpu() for k, v in got_at["merged_buffer"].items()}
    reproduced = torch.equal(abuf["t"], buf["t"]) and torch.equal(abuf["mask"], buf["mask"])
    t_max = (buf["t"] * buf["mask"]).amax(-1)
    scale = max(1.0, float(ref["normals_volume"].abs().max()))

    def ray_errs(out, want):
        """{output: ([N] error of each ray, its limit)} over the frame's
        outputs and every source's share."""
        errs = {}
        for k in CROP_KEYS:
            e = (out[k].cpu() - want[k]).abs().reshape(N, -1).amax(-1)
            errs[k] = (e / (1.0 + t_max), BENCH_DEPTH_TOL) if k == "depth_volume" else \
                (e / scale if k == "normals_volume" else e, EQUAL_DEPTH_TOL)
        for i, name in enumerate(names):
            for k in ("mask_volume", "rgb_volume"):
                e = (out["per_src"][i][k].cpu() - want["per_src"][i][k]).abs().reshape(N, -1)
                errs[f"{name}.{k}"] = (e.amax(-1), EQUAL_DEPTH_TOL)
        return errs

    def depth_gaps(a, b):
        """-> ([N, L] relative depth gap over valid lanes, [N, L] lane equal
        bit for bit, [N] ray with every depth and mask equal)"""
        valid = a["mask"] | b["mask"]
        rel = (a["t"] - b["t"]).abs() / (1.0 + a["t"].abs()) * valid
        lane_equal = (a["t"] == b["t"]) | ~valid
        return rel, lane_equal, (lane_equal & (a["mask"] == b["mask"])).all(-1)

    def by_output(errs):
        """[(name, [N] error)] of the frame's outputs, and each ray's largest
        error over the sources' shares (absolute, as the colour's)"""
        shares = torch.stack([e for k, (e, _) in errs.items() if k not in CROP_KEYS]).amax(0)
        return [(k, errs[k][0]) for k in CROP_KEYS] + [("every source's share", shares)]

    def spread(errs, rays, label):
        """Log every output's error over ``rays``; -> (the largest mean error
        of colour and mask, [N] rays beyond BENCH_CROP_TOL in either)."""
        mean, off = 0.0, torch.zeros(N, dtype=torch.bool)
        for k, e in by_output(errs):
            eo = e[rays] if bool(rays.any()) else torch.zeros(1)
            log(f"compose crop {label} {k}: mean {float(eo.mean()):.3g}, max {float(eo.max()):.3g}"
                f", rays beyond 1e-3 / {BENCH_CROP_TOL:g} / 5e-2: {int((eo > 1e-3).sum())} / "
                f"{int((eo > BENCH_CROP_TOL).sum())} / {int((eo > 5e-2).sum())}")
            if k in ("rgb_volume", "mask_volume"):
                mean = max(mean, float(eo.mean()))
                off |= rays & (e > BENCH_CROP_TOL)
        return mean, off

    vw_err = float((merged[1]["vw"].cpu() - merged[0]["vw"]).abs().max())
    vw_close = bool(torch.allclose(merged[1]["vw"].cpu(), merged[0]["vw"], **K8_TOL))
    merge_err = max(float(e.max()) / tol for e, tol in ray_errs(merged[1], merged[0]).values())
    rel, lane_equal, _ = depth_gaps(buf, gbuf)
    moved = int((rel.amax(-1) > BENCH_SAME_SAMPLES).sum())
    _, _, equal = depth_gaps(abuf, agbuf)
    log(f"compose crop: {N} rays; render_chunked equals ray_query {chunk_same}; merge on "
        f"identical buffers: weights {vw_err:.3g} (tol {K8_TOL['atol']:g}), outputs and shares "
        f"{merge_err:.3g} of their limits; the card's own render: {moved} rays with a depth more "
        f"than {BENCH_SAME_SAMPLES:g} apart (limit {COMPOSE_MOVED_MAX:g} of them); at the CPU "
        f"path's street depths (reproduced on the CPU: {reproduced}): {int(equal.sum())} rays "
        f"with every depth and mask equal bit for bit (at least {COMPOSE_EQUAL_MIN:g} of them)")
    for label, (e_sdf, e_nab, n) in field_errs.items():
        log(f"compose crop: {label} field at the CPU's {n} sample positions: sdf {e_sdf:.3g} "
            f"(tol {FIELD_SDF_TOL:g}), nablas {e_nab:.3g} of the largest (tol {NABLA_TOL:g})")
        if label in lattice_errs:
            differ, differ_xyz, beyond, excused, e_cpu_in, e_card_in = lattice_errs[label]
            log(f"compose crop: {label} lattice inputs: {differ} of {n} positions differ card "
                f"vs CPU ({differ_xyz} in xyz01, the others in sigmoid(latent) only); nablas "
                f"at each device's own inputs: {beyond} positions beyond the tol, {excused} of "
                f"them excused (their inputs differ); at equal inputs, every position: "
                f"{e_cpu_in:.3g} at the CPU's, {e_card_in:.3g} at the card's")
    for i, name in enumerate(names):
        lanes = src == i
        log(f"compose crop: source {name} in the card's own render: "
            f"{int((buf['mask'] | gbuf['mask'])[:, lanes].any(-1).sum())} rays with a valid lane, "
            f"{int((~lane_equal[:, lanes]).any(-1).sum())} with a depth not bit-equal, "
            f"{int((rel[:, lanes].amax(-1) > BENCH_SAME_SAMPLES).sum())} more than "
            f"{BENCH_SAME_SAMPLES:g} apart (largest {float(rel[:, lanes].max()):.3g})")
    errs_at = ray_errs(got_at, ref_at)
    at_equal = {k: float(e[equal].max()) / tol if bool(equal.any()) else 0.0
                for k, (e, tol) in errs_at.items()}
    equal_err = max(at_equal.values())
    log("compose crop at the CPU's street depths, rays of equal depths, errors in units of "
        "their limits: " + ", ".join(f"{k} {at_equal[k]:.3g}" for k in CROP_KEYS)
        + f", every source's share {max(v for k, v in at_equal.items() if k not in CROP_KEYS):.3g}")
    at_mean, at_off = spread(errs_at, ~equal, "at the CPU's street depths, other rays,")
    own_mean, own_off = spread(ray_errs(got, ref), torch.ones(N, dtype=torch.bool),
                               "the card's own render, all rays,")
    if not chunk_same:
        raise AssertionError("render_chunked and ray_query disagree on one chunk")
    if not vw_close or merge_err > 1.0:
        raise AssertionError("the card's merge differs from the CPU's on identical buffers")
    if any(e_sdf > FIELD_SDF_TOL or e_nab > NABLA_TOL
           for e_sdf, e_nab, _ in field_errs.values()):
        raise AssertionError("a field differs on the card from the CPU at equal positions")
    if not reproduced:
        raise AssertionError("the CPU did not render at its own path's street depths")
    if int(equal.sum()) < COMPOSE_EQUAL_MIN * N:
        raise AssertionError("too few rays have equal depths at the CPU path's street depths")
    if equal_err > 1.0:
        raise AssertionError("the card differs from the CPU on a ray of equal depths")
    if moved > COMPOSE_MOVED_MAX * N:
        raise AssertionError("too many rays are sampled differently on the card")
    for mean, off, off_max in ((at_mean, at_off, OTHER_OFF_MAX),
                               (own_mean, own_off, COMPOSE_OFF_MAX)):
        if mean > OTHER_MEAN_TOL or int(off.sum()) > off_max * N:
            raise AssertionError("the card's colour or mask differs from the CPU's on the rays "
                                 "that it samples elsewhere")
    return dict(merge_vw_err=vw_err, merge_err=merge_err,
                field_errs={k: v[:2] for k, v in field_errs.items()},
                lattice_inputs_differ={k: v[0] for k, v in lattice_errs.items()},
                lattice_excused={k: v[3] for k, v in lattice_errs.items()},
                equal_rays_err=equal_err, equal_rays=int(equal.sum()),
                other_mean_err=at_mean, other_off_rays=int(at_off.sum()),
                own_mean_err=own_mean, own_off_rays=int(own_off.sum()), moved_rays=moved,
                rays=N)


def time_compose_frames(renderer, params, scene, occ, reps=20):
    """Host-clock latency of one whole frame through render_multi_frame
    (frame slice, rays, three chunks) in ms over ``reps`` frames after a
    warm-up: (median, min, max)."""
    import torch
    from neuralsim_torch.tools.build import render_multi_frame
    fi = COMPOSE_FRAME_IDS[0]
    render_multi_frame(renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render_multi_frame(renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[reps // 2], ts[0], ts[-1]


def profile_compose_frame(renderer, params, scene, occ):
    """Device kernels and busy time of one compose frame under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsim_torch.tools.build import render_multi_frame
    fi = COMPOSE_FRAME_IDS[0]
    render_multi_frame(renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_multi_frame(renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    kernels_us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(kernels_us) / 1e3
    log(f"profile compose frame: {len(kernels_us)} device kernels, busy {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall under the profiler")
    return len(kernels_us), busy


def time_compose_kernels(shapes):
    """K8, and K1, K3 and K4 at the compose path's shapes, beside their plain
    versions and bounds -> {kernel: [timing, ...]}."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.ops.segment import cross_source_vw, cross_source_vw_plain
    out = {}
    t, mask, alpha = shapes["cross_source_vw"]["args"]
    N, L = t.shape
    out["cross_source_vw"] = [dict(
        shape=f"rays={N} L={L} (one chunk's merged buffer: 3 vehicles x 32, street 48, "
              f"distant 24 lanes)",
        ms=cuda_ms(lambda: cross_source_vw(t, mask, alpha)),
        plain_ms=cuda_ms(lambda: cross_source_vw_plain(t, mask, alpha), reps=5),
        library_ms=None,
        # t, alpha and mask read, vw written; a compare and an add per pair
        bound=bound(N * L * 13, 2.0 * N * L * L))]
    for key in sorted(k for k in shapes if k.startswith("lotd_cp_stacked/")):
        a, C = shapes[key]["args"], shapes[key]["C"]
        lines, x = a[0], a[1]
        N, F, R = x.shape[0], lines.shape[1], lines.shape[2]
        buf = (torch.empty((C, N), device=x.device), torch.empty((3, C, N), device=x.device))
        out.setdefault("lotd_cp_stacked", []).append(dict(
            shape=f"{key.split('/')[1]}: N={N} F={F} R={R} with jacobian "
                  f"({shapes[key]['what']})",
            ms=cuda_ms(lambda: lotd.lotd_cp_stacked(*a, *buf)),
            plain_ms=cuda_ms(lambda: lotd.lotd_cp_stacked_plain(*a, *buf), reps=5),
            library_ms=None,
            bound=bound(N * 12 + lines.numel() * 2 + N * F * 16, N * (30 + 29 * F))))
    for key in sorted(k for k in shapes if k.startswith("lotd_grid/")):
        a, C = shapes[key]["args"], shapes[key]["C"]
        meta, x = a[2], a[1]
        N = x.shape[0]
        rows = meta.tolist()
        cols = sum(r[3] for r in rows)
        seg = sum(r[1] * r[3] for r in rows) * 4
        buf = (torch.empty((C, N), device=x.device), torch.empty((3, C, N), device=x.device))
        out.setdefault("lotd_grid", []).append(dict(
            shape=f"{key.split('/')[1]}: N={N} dense levels "
                  f"{', '.join(str(r[0]) for r in rows)} (F={rows[0][3]}) with jacobian "
                  f"({shapes[key]['what']})",
            ms=cuda_ms(lambda: lotd.lotd_grid(*a, *buf)),
            plain_ms=cuda_ms(lambda: lotd.lotd_grid_plain(*a, *buf), reps=5),
            library_ms=None,
            bound=bound(N * 12 + seg + N * cols * 16, N * sum(135 + 67 * r[3] for r in rows))))
    a = shapes["occ_ray_proposal"]["args"]
    N, n, M = a[0].shape[0], a[8], a[7].shape[0] - 1
    out["occ_ray_proposal"] = [dict(
        shape=f"street: rays={N} march segments={M} samples={n} grid={a[4].shape[0]}^3 "
              f"(no noise, as the render)",
        **card_ms(lambda: occ_ray_proposal(*a)),
        plain_ms=cuda_ms(lambda: occ_ray_proposal_plain(*a)),
        library_ms=None,
        bound=bound(N * 32 + N * M + (M + 1) * 4 + N * n * 4, N * (M * 30 + n * M * 6)))]
    return out


def compose_phase(dev, profile_it):
    """Phase 7 and the compose path's share of the timing -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI as C
    from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
    from neuralsim_torch.scene import Scene
    from neuralsim_torch.scene.observers import camera_get_all_rays
    from neuralsim_torch.tools.build import (build_compose_renderer, converge_occ,
                                             render_multi_frame)

    t0 = time.perf_counter()
    scene, bank, renderer, params = build_compose_renderer(C)
    accel = renderer.accels["cr"]
    occ = {"cr": converge_occ(accel, accel.init_state(), ground_sdf_tensor, seed=int(C["seed"]),
                              **C["occ_converge"])}
    torch.cuda.synchronize()
    occ_frac = float(accel.occupied_fraction(occ["cr"]))
    street_id, veh_id = renderer.scene_models["cr"][0], renderer.objects[0].model_id
    vehicles = [ob.obj_id for ob in renderer.objects]
    veh_enc, street_enc = params[veh_id].encoding, params[street_id].encoding
    qs, qv = bank.assets[street_id].query_cfg, renderer.objects[0].query_cfg
    widths = {"street": np.cumsum([qs["num_coarse"], *qs["num_fine"]]).tolist(),
              "vehicles": np.cumsum([qv["num_coarse"], *qv["num_fine"]]).tolist()}
    log(f"compose model: built in {time.perf_counter() - t0:.2f} s with the street grid "
        f"{accel.res}^3 converged on the ground, occupied fraction {occ_frac:.4f}; vehicles "
        f"{vehicles} on one model (F_cp {veh_enc.cp_out_dim}, R {veh_enc.cp_rmax}, dense "
        f"{[s.res for s in veh_enc.specs if s.typ == 'dense']}), street F_cp "
        f"{street_enc.cp_out_dim} R {street_enc.cp_rmax}; samples {widths}")
    if (veh_enc.cp_out_dim, veh_enc.cp_rmax, street_enc.cp_out_dim, street_enc.cp_rmax,
            accel.march_steps, len(vehicles), widths["street"], widths["vehicles"]) != \
            (24, 256, 40, 1024, 64, 3, [32, 40, 48], [24, 32]):
        raise AssertionError("the compose model's widths are not the ones checked here")
    if not 0.0 < occ_frac < 0.5:
        raise AssertionError("the converged street grid should hold a small occupied share")

    H, W = (int(v) for v in scene.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    frozen = scene.slice_at(COMPOSE_FRAME_IDS[0])
    o, d = camera_get_all_rays(frozen, COMPOSE_CAM, H, W)
    oc, dc = o[:RAYSCHUNK].contiguous(), d[:RAYSCHUNK].contiguous()
    rows = len(vehicles) * RAYSCHUNK // 2      # the vehicles' rows in one chunk
    errs, shapes = check_compose_encodings(
        dev, params, (("street", street_id, RAYSCHUNK, widths["street"]),
                      ("vehicles", veh_id, rows, widths["vehicles"])))
    e4, shapes["occ_ray_proposal"] = check_compose_occ(dev, accel, occ["cr"],
                                                       params[street_id].space, oc, dc,
                                                       qs["num_coarse"])
    errs["occ_ray_proposal"] = (e4, K4_TOL["atol"])
    # K5a, K5b at the stage widths: the street 32 -> 40 -> 48 at inv_s 64 and
    # 256, the vehicles 24 -> 32 at 64, 8 draws a stage, no noise
    for n_rays, q, w in ((RAYSCHUNK, qs, widths["street"]), (rows, qv, widths["vehicles"])):
        stages = tuple((s, q.get("upsample_inv_s", 64.0) * f)
                       for s, f in zip(w, q["upsample_inv_s_factors"]))
        es, _ = check_sample_kernels(dev, n_rays, stages, q["num_fine"][0], w[-1], noisy=False)
        for name in ("neus_upsample.weights_pdf", "neus_upsample.merge"):
            errs[name] = (max(es[name][0], errs.get(name, (0.0,))[0]), es[name][1])
    with torch.no_grad():
        chunk = renderer.ray_query(params, frozen, oc, dc, occ_states=occ, return_buffer=True)
    mb = chunk["merged_buffer"]
    path_buffer = (mb["t"], mb["mask"], mb["alpha"])
    if mb["t"].shape != (RAYSCHUNK, 168):
        raise AssertionError(f"the merged buffer is {tuple(mb['t'].shape)}, not [4096, 168]")
    errs["cross_source_vw"] = (check_cross_source_vw(dev, path_buffer), K8_TOL["atol"])
    shapes["cross_source_vw"] = dict(args=path_buffer)

    kernels.reset_counts()
    frames = [render_multi_frame(renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK)
              for fi in COMPOSE_FRAME_IDS]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    chunks = len(COMPOSE_FRAME_IDS) * -(-H * W // RAYSCHUNK)
    log(f"compose render slice: {len(COMPOSE_FRAME_IDS)} frames of {H}x{W} ({chunks} chunks), "
        f"launches {launches}")
    if launches["cross_source_vw"] != chunks or launches["occ_ray_proposal"] != chunks:
        raise AssertionError("a compose chunk launches K8 and K4 once each")
    for name in ("lotd_cp_stacked", "lotd_grid", "neus_upsample.weights_pdf",
                 "neus_upsample.merge"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the compose path")
    if launches["volume_composite"] or launches["occ_ema_update"] or \
            any(n for k, n in launches.items() if k.endswith(".bwd")):
        raise AssertionError("the compose render composites order-free and trains nothing")
    check_compose_frames(frames, H, W, vehicles)

    scene_cpu = Scene.load_from_scenario(demo_scenario(**C["dataset_cfg"]["params"]))
    crop = compose_crop(H, W)
    cut = lambda a: a.reshape(H, W, 3)[crop].reshape(-1, 3).cpu().contiguous()
    by_ray = check_compose_crop(renderer, params, frozen, scene_cpu.slice_at(COMPOSE_FRAME_IDS[0]),
                                cut(o), cut(d), dev, occ,
                                {"cr": type(occ["cr"])(occ["cr"].val.cpu(), occ["cr"].mask.cpu())})

    frame_ms, frame_min, frame_max = time_compose_frames(renderer, params, scene, occ)
    log(f"timing: compose frame median {frame_ms:.3f} ms (min {frame_min:.3f}, max "
        f"{frame_max:.3f}) for {H * W} rays, {H * W / frame_ms * 1e3:.1f} rays/s; hand-kernel "
        f"launches per frame {sum(launches.values()) / len(COMPOSE_FRAME_IDS):.1f}")
    times = time_compose_kernels(shapes)
    summary = {"compose_occ_frac": occ_frac, "compose_frame_ms": frame_ms,
               "compose_frame_ms_min": frame_min, "compose_frame_ms_max": frame_max,
               "compose_rays_per_s": H * W / frame_ms * 1e3,
               "compose_hand_launches_per_frame": sum(launches.values()) / len(COMPOSE_FRAME_IDS),
               "compose_crop_by_ray": by_ray}
    if profile_it:
        n_kernels, busy = profile_compose_frame(renderer, params, scene, occ)
        summary.update(compose_frame_device_kernels=n_kernels, compose_frame_busy_ms=busy)
    return dict(errs=errs, times=times, launches=launches, n_frames=len(COMPOSE_FRAME_IDS),
                summary=summary)


# ---------------------------------------------------------------------------
# Phase 8: multi-object training (WAYMO_DEMO_MULTI)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sample_placements(trainer, record=None, replay=None):
    """Record (into the list ``record``) or replay (from ``replay``, in the
    same order, moved to the rays' device) the sample depths of the compose
    path: every grid's proposal (the street's, and a shared model's
    per-instance grids', K10) and every upsample stage's draws. A step
    replayed at another device's depths differs from it only where the
    fields, composites and sums round differently, not by moved samples."""
    import torch
    import neuralsim_torch.fields.neus as neus
    accels = list(trainer.renderer.accels.values())
    method = lambda a: "ray_proposal_batched" if a.n_grids else "ray_proposal"
    stage_fn, queue = neus.upsample_weights_pdf, list(replay or [])

    def wrap(accel):
        def proposal(st, ro, *a, **kw):
            if replay is not None:
                t = queue.pop(0).to(ro.device)
                return t, torch.ones_like(t, dtype=torch.bool)
            t, m = getattr(type(accel), method(accel))(accel, st, ro, *a, **kw)
            record.append(t.detach().cpu())
            return t, m
        return proposal

    def stage(t, *a, **kw):
        if replay is not None:
            return None, queue.pop(0).to(t.device)
        w, t_new = stage_fn(t, *a, **kw)
        record.append(t_new.detach().cpu())
        return w, t_new

    for accel in accels:
        setattr(accel, method(accel), wrap(accel))
    neus.upsample_weights_pdf = stage
    try:
        yield
    finally:
        for accel in accels:
            delattr(accel, method(accel))
        neus.upsample_weights_pdf = stage_fn
    if queue:
        raise AssertionError("the replayed step used fewer sample placements than recorded")


def multi_batches(scene, samplers, dev, n_rays, n_beams, poison=False):
    """One LiDAR batch (lifted to world rays) and one pixel batch of the
    samplers, on ``dev``, and the pixel batch's camera."""
    from neuralsim_torch.tools.train_multi import _LIDAR_KEYS, _PIXEL_KEYS, to_device
    from neuralsim_torch.training.multi_trainer import lift_lidar_batch
    lb = samplers["lidar"].sample(n_beams)
    raw = samplers["pixel"].sample(n_rays)
    if poison:
        raw["image_rgb"] = raw["image_rgb"].copy()
        raw["image_rgb"][7, 1] = float("nan")
    on = scene.nodes[lb["lidar_id"]].frame_data["transform"].device
    lbatch = lift_lidar_batch(scene, {**to_device(lb, _LIDAR_KEYS, on),
                                      "lidar_id": lb["lidar_id"]})
    return ({k: v.to(dev) for k, v in lbatch.items()}, to_device(raw, _PIXEL_KEYS, dev),
            raw["cam_id"])


def check_multi_first_iteration(scene, trainer, state, samplers, dev):
    """The first loop iteration (a LiDAR step of MULTI_CHECK_BEAMS beams, a
    pixel step of MULTI_CHECK_RAYS rays) on the card against the CPU path,
    from the same parameters, grid, batches and noise; steps nothing. The
    CPU path's sample depths are replayed on the card (sample_placements),
    and the losses and every gradient leaf are held to MULTI_STEP_LOSS_RTOL
    and MULTI_STEP_GRAD_REL there; the card's own step (its own K4 and K5a
    placements) is logged beside it.
    -> (worst loss rel err, worst gradient rel err) at equal placements."""
    import torch
    to = lambda tree, d: {k: to(v, d) for k, v in tree.items()} if isinstance(tree, dict) \
        else [to(v, d) for v in tree] if isinstance(tree, list) else tree.to(d)
    lbatch, pbatch, cam = multi_batches(scene, samplers, "cpu", MULTI_CHECK_RAYS,
                                        MULTI_CHECK_BEAMS)
    cpu_params = copy.deepcopy(state.params).to("cpu")
    occ_cpu = occ_on(state, "cpu")
    gen = torch.Generator().manual_seed(7)
    worst_loss = worst_grad = 0.0
    for step_type, batch in (("lidar", lbatch), ("pixel", pbatch)):
        noise = trainer.draw_noise(step_type, batch["rays_fidx"].shape[0], gen, state.it)
        placements, results = [], {}
        for label, params, d, occ, ctx in (
                ("cpu", cpu_params, "cpu", occ_cpu, dict(record=placements)),
                ("card at the CPU's depths", state.params, dev, state.occ,
                 dict(replay=placements)),
                ("card", state.params, dev, state.occ, None)):
            saved = trainer.scene
            trainer.scene = scene_on(scene, d)
            try:
                with (sample_placements(trainer, **ctx) if ctx else contextlib.nullcontext()):
                    total, extras = trainer.compute_losses(params, to(batch, d), state.it,
                                                           to(noise, d), step_type, occ, cam)
            finally:
                trainer.scene = saved
            named = dict(params.named_parameters())
            grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
            results[label] = ({"loss_total": float(total.detach()),
                               **{k: float(v.detach()) for k, v in extras["losses"].items()}},
                              {k: torch.zeros(p.shape) if g is None else g.cpu()
                               for (k, p), g in zip(named.items(), grads)})
        l_cpu, g_cpu = results["cpu"]
        for label in ("card at the CPU's depths", "card"):
            l_gpu, g_gpu = results[label]
            le = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12) for k, v in l_cpu.items())
            ge = max(float((g_gpu[k] - g).abs().max()) / float(g.abs().max())
                     for k, g in g_cpu.items() if float(g.abs().max()) > 0)
            log(f"multi first iteration, {step_type} step, {label} vs cpu: worst loss rel err "
                f"{le:.3g}, worst gradient rel err {ge:.3g}; losses "
                f"{ {k: round(v, 6) for k, v in l_gpu.items()} }")
            if label != "card":
                for k, g in g_cpu.items():
                    if float(g.abs().max()) > 0:
                        e = float((g_gpu[k] - g).abs().max()) / float(g.abs().max())
                        if e > MULTI_STEP_GRAD_REL:
                            log(f"  gradient {k}: rel err {e:.3g}")
                worst_loss, worst_grad = max(worst_loss, le), max(worst_grad, ge)
        if not all(np.isfinite(v) for v in results["card"][0].values()):
            raise AssertionError("the card's own first step gives a non-finite loss")
    log(f"multi first iteration at equal sample depths: worst loss rel err {worst_loss:.3g} "
        f"(tol {MULTI_STEP_LOSS_RTOL:g}), worst gradient rel err {worst_grad:.3g} "
        f"(tol {MULTI_STEP_GRAD_REL:g})")
    if not (worst_loss <= MULTI_STEP_LOSS_RTOL and worst_grad <= MULTI_STEP_GRAD_REL):
        raise AssertionError("the card's first multi-object iteration differs from the CPU's")
    return worst_loss, worst_grad


def scene_on(scene, d):
    """The scene graph with its frame data on device ``d`` (a shallow copy
    whose nodes carry moved tensors)."""
    out = copy.copy(scene)
    out.nodes, out.nodes_topo = {}, []
    for n in scene.nodes_topo:
        m = copy.copy(n)
        m.frame_data = {k: v.to(d) for k, v in n.frame_data.items()}
        out.nodes[m.id] = m
        out.nodes_topo.append(m)
    return out


def step_buffers(trainer, state, scene, samplers, dev, seed):
    """The merged buffers of one LiDAR step (the street alone, its alpha
    from K12) and one pixel step (every source) of the training path, without
    gradients -> {"lidar": buffer, "pixel": buffer}."""
    import torch
    from neuralsim_torch.scene.observers import camera_get_selected_rays
    gen = torch.Generator(device=dev).manual_seed(seed)
    lbatch, pbatch, cam = multi_batches(scene, samplers, dev, MULTI_RAYS, MULTI_BEAMS)
    bufs = {}
    with torch.no_grad():
        for step_type, batch in (("lidar", lbatch), ("pixel", pbatch)):
            frozen = scene.slice_at(batch["rays_fidx"].long())
            if step_type == "pixel":
                ro, rd = camera_get_selected_rays(frozen, cam, batch["rays_xy"])
            else:
                ro, rd = batch["rays_o"], batch["rays_d"]
            noise = trainer.draw_noise(step_type, ro.shape[0], gen, state.it)
            bufs[step_type] = trainer.renderer.ray_query(
                state.params, frozen, ro.contiguous(), rd.contiguous(), it=state.it,
                with_rgb=step_type == "pixel", only_cr=step_type == "lidar",
                occ_states=state.occ, return_buffer=True, with_per_obj=False,
                noise=noise["render"])["merged_buffer"]
    return bufs


def check_multi_kernels(dev, trainer, state, scene, samplers):
    """K8's backward at the pixel step's merged buffer [4,096, 168] with
    non-zero cotangents and on ragged, tied and masked buffers with edge
    alphas; K1's and K3's backwards at the path's point sets (the street's
    F_cp 40 / R 1,024, the vehicles' F_cp 24 / R 256 and their dense levels),
    K3's also as check_grid_bwd lists; K5a and K5b at the stage shapes
    (check_stages); K12 forward and backward at the LiDAR step's street
    buffer (2,048 x 48, no rgb). -> ({kernel: (max_abs_err, tol)}, the inputs
    kept for timing)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.ops.segment import (cross_source_vw, cross_source_vw_bwd_plain,
                                             cross_source_vw_fwd)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bufs = step_buffers(trainer, state, scene, samplers, dev, 9)
    mb, lbuf = bufs["pixel"], bufs["lidar"]
    if mb["t"].shape != (MULTI_RAYS, 168) or lbuf["t"].shape != (MULTI_BEAMS, 48):
        raise AssertionError(f"the step buffers are {tuple(mb['t'].shape)} and "
                             f"{tuple(lbuf['t'].shape)}, not [4096, 168] and [2048, 48]")
    errs, shapes = {}, {}
    # K8 backward
    path = (mb["t"].contiguous(), mb["mask"].contiguous(), mb["alpha"].contiguous())
    g = cotangents(path[0].shape, 21, dev)
    sets = [("pixel step's merged buffer", path, g)] + [
        ("ragged, ties, masked lanes, edge alphas", [T(a) for a in edge_alpha_inputs(n, L, L)],
         cotangents((n, L), 22 + L, dev))
        for n, L in ((4096, 168), (333, 1), (257, 5), (1000, 33), (512, 257), (64, 1100))]
    e8 = []
    for label, (t, mask, alpha), gg in sets:
        a = alpha.clone().requires_grad_(True)
        got = torch.autograd.grad(cross_source_vw(t, mask, a), a, gg)[0]
        e8.append(compare_rel(f"K8 bwd {label} rays={t.shape[0]} L={t.shape[1]}", [got],
                              [cross_source_vw_bwd_plain(t, mask, alpha, gg)], GRAD_REL))
    errs["cross_source_vw.bwd"] = (max(e8), GRAD_REL)
    logt = cross_source_vw_fwd(*path, with_logt=True)[1]
    shapes["cross_source_vw.bwd"] = dict(args=(*path, logt, g))
    shapes["cross_source_vw"] = dict(args=path)
    # K1 and K3 backward at the final evaluations of the step
    e1, e3 = [], []
    veh_id = trainer.renderer.objects[0].model_id
    street_id = trainer.renderer.scene_models["cr"][0]
    for label, mid, n_rows, s in (("street, pixel step", street_id, MULTI_RAYS, 48),
                                  ("street, LiDAR step", street_id, MULTI_BEAMS, 48),
                                  ("vehicles", veh_id, 3 * MULTI_RAYS // 2, 32)):
        enc = state.params[mid].encoding
        C = enc.out_dim
        x = T(ray_points(n_rows, s, enc.cp_rmax, 30))
        N = x.shape[0]
        lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
        d_out, d_jac = cotangents((C, N), 31, dev), cotangents((3, C, N), 32, dev)
        a1 = (lines, x, enc._cp_rows, d_out, d_jac)
        e1.append(compare_rel(f"K1 bwd {label} F={lines.shape[1]} R={lines.shape[2]} N={N}",
                              [lotd.lotd_cp_stacked_bwd(*a1)], [lotd.lotd_cp_stacked_bwd_plain(*a1)],
                              GRAD_REL))
        shapes[f"lotd_cp_stacked.bwd/{label}"] = dict(args=a1, what=f"{n_rows} x {s} samples")
        if enc.grid_spec_ids:
            a3 = (enc.table.numel(), x, enc._grid_meta, d_out, d_jac)
            e3.append(compare_rel(f"K3 bwd {label} dense levels N={N}",
                                  [lotd.lotd_grid_bwd(*a3)], [lotd.lotd_grid_bwd_plain(*a3)],
                                  GRAD_REL))
            shapes["lotd_grid.bwd/1 vehicles' final query"] = dict(
                args=a3, plan=enc.grid_bwd_plan, what=f"{n_rows} rows x {s} samples")
    e3 += check_grid_bwd(dev, state.params[veh_id].encoding, shapes)
    # K1 bwd's 512-point launches (each model's uniform eikonal), kept for
    # timing, and the edge cases
    k1_encs = []
    for label, mid, n_rows, s in (("street", street_id, MULTI_RAYS, 48),
                                  ("vehicles", veh_id, 3 * MULTI_RAYS // 2, 32)):
        enc = state.params[mid].encoding
        C = enc.out_dim
        x = T(enc_points(512, enc.cp_rmax, 35))
        lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
        shapes[f"lotd_cp_stacked.bwd/{label}, uniform eikonal"] = dict(
            args=(lines, x, enc._cp_rows, cotangents((C, 512), 36, dev),
                  cotangents((3, C, 512), 37, dev)), what="512 uniform points")
        k1_encs.append((label, lines, enc._cp_rows, C,
                        cp_bwd_point_sets(n_rows, s, enc.cp_rmax, [enc.cp_rmax], 38)))
    e1 += check_k1_bwd_sets(dev, k1_encs)
    errs["lotd_cp_stacked.bwd"] = (max(e1), GRAD_REL)
    errs["lotd_grid.bwd"] = (max(e3), GRAD_REL)
    for name, (e, tol) in check_stages(dev, shapes).items():
        errs[name] = (max(e, errs.get(name, (0.0,))[0]), tol)
    # K12 at the LiDAR step's street buffer: no rgb, nablas for the on-render eikonal
    e12, s12 = check_neus_composite(dev, [("LiDAR step's street buffer", neus_args(lbuf))])
    errs.update(e12)
    shapes.update(s12)
    torch.cuda.synchronize()
    return errs, shapes


def check_k1_bwd_sets(dev, sets):
    """K1's backward (check_cp_bwd) on ``sets`` ((label, bf16 lines, rows, C,
    point sets)) and on lines of F 13 at R 1,024 (F not a multiple of four:
    a partial group, one add a value) -> [max_abs_err, ...]."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    rng = np.random.default_rng(57)
    lines13 = torch.from_numpy(rng.normal(1.0, 0.3, (3, 13, 1024)).astype(np.float32)).to(dev)
    sets = list(sets) + [("F 13, R 1,024", lines13.to(torch.bfloat16),
                          torch.arange(13, dtype=torch.int32, device=dev), 13,
                          [("2048 rays x 48 sorted samples", ray_points(2048, 48, 1024, 58)),
                           ("512 uniform points", enc_points(512, 1024, 59))])]
    errs = []
    for label, lines, rows, C, pts in sets:
        errs += check_cp_bwd(dev, f"K1 bwd {label} F={lines.shape[1]} R={lines.shape[2]}",
                             lotd.lotd_cp_stacked_bwd, lotd.lotd_cp_stacked_bwd_plain,
                             lambda x: (lines, x, rows), C, pts)
    return errs


# K5's calls in a multi-object iteration (rays, samples, draws, inv_s): the
# street's two stages (32 and 40 samples, 8 draws each, inv_s 64 and 256) at
# the pixel step's rays and the LiDAR step's beams, the vehicles' one stage
# (24 + 8, inv_s 64) at their 3 x 2,048 compacted rows
STAGE_SHAPES = ((MULTI_RAYS, 32, 8, 64.0), (MULTI_RAYS, 40, 8, 256.0),
                (MULTI_BEAMS, 32, 8, 64.0), (MULTI_BEAMS, 40, 8, 256.0),
                (3 * MULTI_RAYS // 2, 24, 8, 64.0))


def check_stages(dev, shapes):
    """K5a (with drawn noise, as in training) and K5b at the multi-object
    stage shapes (STAGE_SHAPES); K5b also at N = 1 and 4,097, on lists on a
    grid of 4 depths (ties inside each list and across, in every ray) and on
    lists too wide for four rays' depths in 48 KB of shared memory; K5b held
    exactly. The stage inputs are kept in ``shapes`` for timing
    -> {kernel: (max_abs_err, tol)}."""
    import torch
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    err_w, err_m = 0.0, 0.0
    for seed, (n, s, nf, inv_s) in enumerate(STAGE_SHAPES, 40):
        args = [T(a) for a in stage_inputs(n, s, seed)]
        noise = torch.rand((n, nf), generator=torch.Generator().manual_seed(seed)).to(dev)
        err_w = max(err_w, compare(f"K5a weights_pdf rays={n} S={s} draws={nf} inv_s={inv_s:g} "
                                   f"noise=True", upsample_weights_pdf(*args, inv_s, nf, noise),
                                   upsample_weights_pdf_plain(*args, inv_s, nf, noise),
                                   1e-5, 1e-6))
        shapes[f"neus_upsample.weights_pdf/{n} {s}+{nf}"] = dict(args=args, noise=noise,
                                                                 inv_s=inv_s, nf=nf)
    sets = [("stage", n, a, b, 400) for n, a, b, _ in STAGE_SHAPES] + [
        ("one ray", 1, 32, 8, 400), ("ragged", 4097, 40, 8, 400), ("ties", 4096, 32, 8, 4),
        ("ties, ragged", 4097, 24, 8, 4), ("ties, wide", 4097, 80, 16, 4),
        ("past 48 KB for four rays", 64, 3000, 200, 400),
        ("past 48 KB for one ray", 8, 16000, 100, 400)]
    for seed, (label, n, a, b, levels) in enumerate(sets, 50):
        ins = [T(v) for v in merge_inputs(n, a, b, seed, levels)]
        err_m = max(err_m, compare(f"K5b merge {label} rays={n} A={a} B={b}",
                                   merge_sorted_samples(*ins), merge_sorted_samples_plain(*ins),
                                   0, 0, exact=True))
        if label == "stage":
            shapes[f"neus_upsample.merge/{n} {a}+{b}"] = dict(ins=ins)
    return {"neus_upsample.weights_pdf": (err_w, 1e-6), "neus_upsample.merge": (err_m, 0.0)}


def check_grid_bwd(dev, enc, shapes):
    """K3's backward beside the vehicles' final query: at their uniform
    eikonal's 512 points; with every one of 196,608 points in one cell of
    each dense level (every lane of every warp on the same 8 rows); on
    small_encoding, whose dense levels are private and hash levels global;
    each with both cotangents and with each alone, and with the plan the
    path takes at its size and the private levels forced -> [max_abs_err, ...]."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    rng = np.random.default_rng(33)
    mixed = small_encoding(dev)
    plan = mixed.grid_bwd_plan
    if not plan.private_mask or plan.private_mask == (1 << mixed._grid_meta.shape[0]) - 1:
        raise AssertionError(f"small_encoding's K3 plan {plan} is not part private, part global")
    sets = [("vehicles' uniform eikonal", enc, enc_points(512, enc.cp_rmax, 34)),
            ("vehicles, one cell", enc,
             (0.3 + 1e-3 * rng.random((3 * MULTI_RAYS // 2 * 32, 3))).astype(np.float32)),
            ("small_encoding, private dense and global hash levels", mixed,
             ray_points(2048, 32, 64, 35))]
    errs = []
    for k, (label, e, pts) in enumerate(sets, 2):
        x = torch.from_numpy(pts).to(dev)
        N, C = x.shape[0], e.out_dim
        d_out, d_jac = cotangents((C, N), 36 + k, dev), cotangents((3, C, N), 46 + k, dev)
        for which, do, dj in (("both", d_out, d_jac), ("feats", d_out, None),
                              ("jac", None, d_jac)):
            a3 = (e.table.numel(), x, e._grid_meta, do, dj)
            want = lotd.lotd_grid_bwd_plain(*a3)
            for plan in dict.fromkeys((e.grid_bwd_plan.at(N), e.grid_bwd_plan)):
                errs.append(compare_rel(f"K3 bwd {label} N={N} cotangents={which} plan "
                                        f"{plan.private_mask:#x}/{plan.n_private}",
                                        [lotd.lotd_grid_bwd(*a3, plan=plan)], [want], GRAD_REL))
        shapes[f"lotd_grid.bwd/{k} {label}"] = dict(args=(e.table.numel(), x, e._grid_meta,
                                                          d_out, d_jac),
                                                    plan=e.grid_bwd_plan, what=label)
    return errs


def check_multi_training(scene, trainer, state, samplers, dev, iters=MULTI_ITERS,
                         label="multi-object", per_level=False, permuto=False):
    """``iters`` loop iterations through train_loop with every metric logged:
    finite losses, no skip, falling loss_rgb and LiDAR depth loss, every grid
    refreshed on its cadence (three times), the error map's importance
    sampling in use, and every kernel of the path launched as counted (with a
    pair-budget group K11 once a pixel step, with per-instance grids K10 once
    a pixel step; neither otherwise; K12 once a LiDAR step and K6 never; K2
    on the ``per_level`` path and K1 otherwise; K9 and no K3 with ``permuto``
    vehicles, no K9 otherwise). -> (log, launches, falls)."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.tools.train_multi import train_loop
    gen = torch.Generator(device=dev).manual_seed(11)
    log_ = []
    it0 = state.it
    kernels.reset_counts()
    train_loop(scene, trainer, state, samplers, it0 + iters, gen, 1, log_)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    r = trainer.renderer
    cadence = {a.n_steps_between_update for a in r.accels.values()}
    if len(cadence) != 1:
        raise AssertionError("the grids of this path should share one cadence")
    every = cadence.pop()
    refreshes = sum(1 for rec in log_ if rec["it"] % every == 0)
    log(f"{label} training: {iters} iterations of {MULTI_BEAMS} beams + {MULTI_RAYS} rays, "
        f"{refreshes} refreshes of each of {len(r.accels)} grids, launches {launches}")
    for rec in log_:
        for k, v in rec.items():
            if k.startswith(("loss", "lidar/loss")) and not np.isfinite(v):
                raise AssertionError(f"non-finite {k} at iteration {rec['it']}")
    if log_[-1]["skips_total"] != 0:
        raise AssertionError(f"{log_[-1]['skips_total']} steps were skipped")
    mean = lambda k, rs: float(np.mean([rec[k] for rec in rs]))
    falls = {}
    for k in ("loss_rgb", "lidar/lidar_loss_depth"):
        falls[k] = (mean(k, log_[:10]), mean(k, log_[-10:]))
        log(f"{label} training: {k} first 10 iterations {falls[k][0]:.5f}, last 10 "
            f"{falls[k][1]:.5f}")
        if not falls[k][1] < falls[k][0]:
            raise AssertionError(f"{k} did not fall")
    log(f"{label} training: occ_frac {log_[0]['occ_frac']:.4f} -> {log_[-1]['occ_frac']:.4f}"
        f", error-map updates {samplers['imp'].it} (importance sampling from "
        f"{samplers['imp'].enable_after})")
    pair = any(r._pair_rows(obs, MULTI_RAYS) for obs in r._grouped().values())
    batched = any(a.n_grids for a in r.accels.values())
    # the LiDAR step composites the street alone: K12, never K6; the
    # encodings take K1 (stacked) or K2 (per-level), never both
    want = {"cross_source_vw": iters, "cross_source_vw.bwd": iters,
            "neus_composite": iters, "neus_composite.bwd": iters,
            "volume_composite": 0, "volume_composite.bwd": 0,
            "occ_ray_proposal": 2 * iters, "occ_ema_update": refreshes * len(r.accels),
            "pair_compact": iters if pair else 0,
            "occ_ray_proposal_batched": iters if batched else 0,
            **dict.fromkeys(("lotd_cp_stacked", "lotd_cp_stacked.bwd") if per_level
                            else PERLEVEL_ONLY, 0),
            **dict.fromkeys(("lotd_grid", "lotd_grid.bwd") if permuto else PERMUTO_ONLY, 0)}
    if refreshes != 3 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"the {label} path's launches are not as counted: want {want}")
    for name, n in launches.items():
        if n <= 0 and want.get(name, 1):
            raise AssertionError(f"kernel {name} never launched on the {label} training path")
    if samplers["imp"].it != iters or samplers["imp"].enable_after >= iters:
        raise AssertionError("the error map's importance sampling did not run")
    return log_, launches, falls


def check_multi_poisoned_step(scene, trainer, state, samplers, dev):
    """A NaN in a pixel batch: the step is skipped and leaves every parameter
    and moment bit-identical."""
    import torch
    _, pbatch, cam = multi_batches(scene, samplers, dev, MULTI_RAYS, MULTI_BEAMS, poison=True)
    before = [p.detach().clone() for p in state.params.parameters()]
    moments = [t.clone() for o in state.opt.values() for t in (*o.mu, *o.nu, o.count)]
    it = state.it
    gen = torch.Generator(device=dev).manual_seed(12)
    state, m = trainer.train_step(state, pbatch, trainer.draw_noise("pixel", MULTI_RAYS, gen, it),
                                  "pixel", cam)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(before, state.params.parameters())) and \
        all(torch.equal(a, b) for a, b in
            zip(moments, [t for o in state.opt.values() for t in (*o.mu, *o.nu, o.count)]))
    log(f"multi poisoned step: skipped {int(m['step_skipped'])}, skips_total "
        f"{int(m['skips_total'])}, parameters and moments unchanged {same}, it {it} -> {state.it}")
    if not (int(m["step_skipped"]) == 1 and int(m["skips_total"]) == 1 and same
            and state.it == it + 1):
        raise AssertionError("the poisoned multi-object step was not skipped cleanly")


def time_multi_iterations(scene, trainer, state, samplers, dev, reps=20):
    """Host-clock time of each step type of a loop iteration, batch sampling,
    lifting and noise included (the pixel step's error-map update too), in
    ms over ``reps`` iterations after 3 warm-ups -> {lidar, pixel, iteration:
    (median, min, max)}."""
    import torch
    from neuralsim_torch.tools.train_multi import _LIDAR_KEYS, _PIXEL_KEYS, to_device
    from neuralsim_torch.training.multi_trainer import lift_lidar_batch
    gen = torch.Generator(device=dev).manual_seed(13)
    pix, lid, imp = samplers["pixel"], samplers["lidar"], samplers["imp"]
    ts = {"lidar": [], "pixel": [], "iteration": []}
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lb = lid.sample()
        lbatch = lift_lidar_batch(scene, {**to_device(lb, _LIDAR_KEYS, dev),
                                          "lidar_id": lb["lidar_id"]})
        trainer.train_step(state, lbatch, trainer.draw_noise("lidar", MULTI_BEAMS, gen, state.it),
                           "lidar", None, False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw = pix.sample()
        batch = to_device(raw, _PIXEL_KEYS, dev)
        _, m = trainer.train_step(state, batch,
                                  trainer.draw_noise("pixel", MULTI_RAYS, gen, state.it), "pixel",
                                  raw["cam_id"])
        W, H = pix.loader.image_wh(raw["cam_id"])
        imp.update(raw["rays_fidx"], raw["rays_sel"][:, 1], raw["rays_sel"][:, 0],
                   m["err_map"].cpu().numpy(), H, W, cam_id=raw["cam_id"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 3:
            ts["lidar"].append((t1 - t0) * 1e3)
            ts["pixel"].append((t2 - t1) * 1e3)
            ts["iteration"].append((t2 - t0) * 1e3)
    return {k: (sorted(v)[reps // 2], min(v), max(v)) for k, v in ts.items()}


def profile_multi_steps(scene, trainer, state, samplers, dev, named=None):
    """Device kernels and busy time of one LiDAR and one pixel step (off the
    grid's cadence) under the profiler, and the device time of the kernels
    whose names hold any of ``named`` {label: substrings} -> {step type:
    (kernels, busy ms, {label: ms})}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for step_type in ("lidar", "pixel"):
        for warm in (True, False):
            lbatch, pbatch, cam = multi_batches(scene, samplers, dev, MULTI_RAYS, MULTI_BEAMS)
            batch = lbatch if step_type == "lidar" else pbatch
            n = batch["rays_fidx"].shape[0]
            noise = trainer.draw_noise(step_type, n, gen, state.it)
            torch.cuda.synchronize()
            ctx = contextlib.nullcontext() if warm else \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        record_shapes=True)
            with ctx as prof:
                t0 = time.perf_counter()
                trainer.train_step(state, batch, noise, step_type,
                                   cam if step_type == "pixel" else None, False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
        # the same by operator and input shapes: which gather's backward it is
        log(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=40,
            max_shapes_column_width=80))
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels_us = [e.time_range.elapsed_us() for e in events]
        busy = sum(kernels_us) / 1e3
        by_name = {label: sum(e.time_range.elapsed_us() for e in events
                              if any(p in e.name for p in subs)) / 1e3
                   for label, subs in (named or {}).items()}
        log(f"profile multi {step_type} step: {len(kernels_us)} device kernels, busy {busy:.3f} ms "
            f"of {wall * 1e3:.3f} ms wall under the profiler"
            + "".join(f"; {k} {v:.3f} ms" for k, v in by_name.items()))
        out[step_type] = (len(kernels_us), busy, by_name)
    return out


def time_multi_kernels(shapes):
    """K8 forward (writing S, as the training step does) and backward at the
    pixel step's merged buffer, K12 forward and backward at the LiDAR step's
    street buffer, beside their plain versions and bounds."""
    from neuralsim_torch.ops.segment import (cross_source_vw_bwd, cross_source_vw_bwd_plain,
                                             cross_source_vw_fwd, cross_source_vw_plain)
    out = {}
    t, mask, alpha, logt, g = shapes["cross_source_vw.bwd"]["args"]
    N, L = t.shape
    what = f"rays={N} L={L} (the pixel step's merged buffer: 3 vehicles x 32, street 48, " \
           f"distant 24 lanes)"
    out["cross_source_vw"] = dict(
        shape=what + ", writing S", ms=cuda_ms(lambda: cross_source_vw_fwd(t, mask, alpha, True)),
        plain_ms=cuda_ms(lambda: cross_source_vw_plain(t, mask, alpha), reps=5), library_ms=None,
        # t, alpha and mask read, vw and S written; a compare and an add per pair
        bound=bound(N * L * 17, 2.0 * N * L * L))
    out["cross_source_vw.bwd"] = dict(
        shape=what, ms=cuda_ms(lambda: cross_source_vw_bwd(t, mask, alpha, logt, g)),
        plain_ms=cuda_ms(lambda: cross_source_vw_bwd_plain(t, mask, alpha, g), reps=5),
        library_ms=None,
        # t, mask, alpha, S and the cotangent read, d alpha written; a compare
        # and an add per pair
        bound=bound(N * L * 21, 2.0 * N * L * L))
    out.update(time_neus_composite(shapes))
    return out


def time_iteration_kernels(shapes):
    """K3's and K1's backwards, K5a and K5b at the multi-object shapes that
    check_multi_kernels kept, beside their plain versions and bounds (K5b
    beside a stable torch.sort of its keys); ``queued_ms`` beside ``ms``, the
    card held busy while the calls are enqueued (cuda_ms) -> {kernel:
    [timing, ...]}."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    out = {}

    def timed(fn, plain, plain_reps=20, library=None, **kw):
        return dict(**card_ms(fn), plain_ms=cuda_ms(plain, reps=plain_reps),
                    library_ms=None if library is None else cuda_ms(library),
                    library_queued_ms=None if library is None else cuda_ms(library, queued=True),
                    **kw)

    for key in sorted(k for k in shapes if k.startswith("lotd_grid.bwd/")):
        a = shapes[key]["args"]
        N, rows = a[1].shape[0], a[2].tolist()
        plan = shapes[key]["plan"].at(N)    # the plan the path takes at this size
        cols = sum(r[3] for r in rows)
        seg = sum(r[1] * r[3] for r in rows) * 4
        out.setdefault("lotd_grid.bwd", []).append(timed(
            lambda: lotd.lotd_grid_bwd(*a, plan=plan), lambda: lotd.lotd_grid_bwd_plain(*a), 3,
            shape=f"{key.split(' ', 1)[1]}: N={N} levels {[r[0] for r in rows]} "
                  f"({'hash' if any(r[4] for r in rows) else 'dense'}; F={rows[0][3]}; private "
                  f"mask {plan.private_mask:#x}, {plan.n_private} floats), both cotangents",
            # positions and cotangents read, the levels' gradients written once
            bound=bound(N * 12 + N * cols * 16 + seg, N * sum(135 + 64 * r[3] for r in rows))))
    for key in sorted(k for k in shapes if k.startswith("lotd_cp_stacked.bwd/")):
        a = shapes[key]["args"]
        lines, x = a[0], a[1]
        N, F, R = x.shape[0], lines.shape[1], lines.shape[2]
        out.setdefault("lotd_cp_stacked.bwd", []).append(timed(
            lambda: lotd.lotd_cp_stacked_bwd(*a), lambda: lotd.lotd_cp_stacked_bwd_plain(*a), 3,
            shape=f"{key.split('/')[1]}: N={N} F={F} R={R} ({shapes[key]['what']}), both "
                  f"cotangents",
            bound=bound(N * 12 + lines.numel() * 2 + N * F * 16 + lines.numel() * 4,
                        N * (30 + 75 * F))))
    for key in sorted(k for k in shapes if k.startswith("neus_upsample.weights_pdf/")):
        k5a = shapes[key]
        args, noise, inv_s, nf = k5a["args"], k5a["noise"], k5a["inv_s"], k5a["nf"]
        n, S = args[0].shape
        out.setdefault("neus_upsample.weights_pdf", []).append(timed(
            lambda: upsample_weights_pdf(*args, inv_s, nf, noise),
            lambda: upsample_weights_pdf_plain(*args, inv_s, nf, noise),
            shape=f"rays={n} S={S} nf={nf} inv_s={inv_s:g} (drawn noise)",
            bound=bound(n * S * 9 + n * 8 + n * nf * 4 + n * S * 4 + n * nf * 4,
                        n * S * (32 + 6 * nf))))
    for key in sorted(k for k in shapes if k.startswith("neus_upsample.merge/")):
        ins = shapes[key]["ins"]
        n, A = ins[0].shape
        B = ins[1].shape[1]
        keys = torch.cat([ins[0], ins[1]], -1)
        out.setdefault("neus_upsample.merge", []).append(timed(
            lambda: merge_sorted_samples(*ins), lambda: merge_sorted_samples_plain(*ins),
            library=lambda: torch.sort(keys, dim=-1, stable=True),
            shape=f"rays={n} A={A} B={B}",
            bound=bound(2 * n * (A + B) * 9, n * (A + B))))
    return out


@contextlib.contextmanager
def launch_shapes(record):
    """While the block runs, append to ``record[kernel]`` the integer
    arguments (the shapes) of each of its launches; None records nothing."""
    from neuralsim_torch import kernels
    if record is None:
        yield None
        return
    orig = kernels.Kernel.launch

    def launch(self, entry, *args):
        record.setdefault(self.name, []).append(
            tuple(a for a, c in zip(args, kernels.SIGNATURES[entry]) if c == "i"))
        orig(self, entry, *args)

    kernels.Kernel.launch = launch
    try:
        yield record
    finally:
        kernels.Kernel.launch = orig


def multi_phase(dev, profile_it):
    """Phase 8 and the multi-object training's share of the timing."""
    import torch
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI
    from neuralsim_torch.tools.build import build_multi_trainer, render_multi_frame

    cfg = copy.deepcopy(WAYMO_DEMO_MULTI)
    cfg["training"]["error_map"] = {**cfg["training"]["error_map"],
                                    "enable_after": MULTI_ERROR_MAP_AFTER}
    timings = {}
    t0 = time.perf_counter()
    scene, bank, trainer, state, samplers = build_multi_trainer(cfg, timings=timings)
    torch.cuda.synchronize()
    accel = trainer.renderer.accels["cr"]
    log(f"multi-object training: built in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()) + f"); pretrain "
        f"{bank.pretrain_shapes()}, street grid {accel.res}^3 at its initial state, occupied "
        f"fraction {float(accel.occupied_fraction(state.occ['cr'])):.4f}")
    t = cfg["training"]
    if (t["n_rays"], t["n_rays_lidar"], t["uniform_sample_n"]) != (MULTI_RAYS, MULTI_BEAMS, 512):
        raise AssertionError("the multi-object batch sizes are not the ones checked here")

    errs, shapes = check_multi_kernels(dev, trainer, state, scene, samplers)
    loss_err, grad_err = check_multi_first_iteration(scene, trainer, state, samplers, dev)
    log_, launches, falls = check_multi_training(scene, trainer, state, samplers, dev)
    check_multi_poisoned_step(scene, trainer, state, samplers, dev)
    # the shapes of the redesigned kernels' launches (and K1 bwd's, K5a's) in
    # one LiDAR and one pixel step
    step_shapes = {}
    step_launches(scene, trainer, state, samplers, dev, shapes=step_shapes)
    by_shape = {st: {k: {str(sh): calls.count(sh) for sh in sorted(set(calls))}
                     for k, calls in rec.items() if k in MULTI_WATCHED}
                for st, rec in step_shapes.items()}
    for st, rec in by_shape.items():
        log(f"multi-object {st} step: launches by integer arguments {rec}")
    if not all(by_shape["pixel"].get(k) for k in MULTI_WATCHED):
        raise AssertionError(f"a pixel step should launch each of {MULTI_WATCHED}")

    H, W = (int(v) for v in scene.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    frame = render_multi_frame(trainer.renderer, state.params, scene, 0, COMPOSE_CAM, state.occ,
                               RAYSCHUNK)
    torch.cuda.synchronize()
    m = frame["mask_volume"]
    log(f"multi-object training: rendered frame 0 ({H}x{W}) of the trained state, mask in "
        f"[{float(m.min()):.4f}, {float(m.max()):.6f}], mean {float(m.mean()):.4f}")
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        if not torch.isfinite(frame[k]).all() or frame[k].shape[0] != H * W:
            raise AssertionError(f"the trained frame's {k} is not finite of {H * W} rays")
    if float(m.min()) < 0.0 or float(m.max()) > MASK_CAP:
        raise AssertionError("the trained frame's mask leaves [0, 1 + 1.1e-3]")

    it_ms = time_multi_iterations(scene, trainer, state, samplers, dev)
    rays = MULTI_RAYS + MULTI_BEAMS
    for k, (med, lo, hi) in it_ms.items():
        log(f"timing: multi-object {k} median {med:.3f} ms (min {lo:.3f}, max {hi:.3f})")
    log(f"timing: multi-object iteration {rays} rays ({MULTI_BEAMS} beams + {MULTI_RAYS} "
        f"pixels), {rays / it_ms['iteration'][0] * 1e3:.1f} rays/s; hand-kernel launches per "
        f"iteration {sum(launches.values()) / MULTI_ITERS:.1f}")
    times = time_multi_kernels(shapes)
    kernel_times = time_iteration_kernels(shapes)
    summary = {"multi_build_s": timings, "multi_step_launch_shapes": by_shape, "multi_first_iteration_loss_rel_err": loss_err,
               "multi_first_iteration_grad_rel_err": grad_err,
               "multi_iterations": MULTI_ITERS,
               "multi_loss_rgb_first10": falls["loss_rgb"][0],
               "multi_loss_rgb_last10": falls["loss_rgb"][1],
               "multi_lidar_depth_first10": falls["lidar/lidar_loss_depth"][0],
               "multi_lidar_depth_last10": falls["lidar/lidar_loss_depth"][1],
               "multi_occ_frac_last": log_[-1]["occ_frac"],
               "multi_lidar_step_ms": it_ms["lidar"][0], "multi_pixel_step_ms": it_ms["pixel"][0],
               "multi_iteration_ms": it_ms["iteration"][0],
               "multi_iteration_ms_min": it_ms["iteration"][1],
               "multi_iteration_ms_max": it_ms["iteration"][2],
               "multi_rays_per_s": rays / it_ms["iteration"][0] * 1e3,
               "multi_hand_launches_per_iteration": sum(launches.values()) / MULTI_ITERS}
    if profile_it:
        prof = profile_multi_steps(scene, trainer, state, samplers, dev, named=MULTI_PROFILED)
        for k, (n, busy, named) in prof.items():
            summary[f"multi_{k}_step_device_kernels"] = n
            summary[f"multi_{k}_step_busy_ms"] = busy
            summary[f"multi_{k}_step_kernel_ms"] = named
    return dict(errs=errs, times=times, kernel_times=kernel_times, launches=launches,
                iters=MULTI_ITERS, summary=summary)


# ---------------------------------------------------------------------------
# Phase 9: crowded multi-object scenes (WAYMO_DEMO_CROWD): K11 and K10
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pair_calls(record):
    """Record into ``record`` the inputs (hit, Bg, M) of every K11 call that
    the compose renderer makes while the block runs."""
    import neuralsim_torch.renderers.buffer_compose as bc
    fn = bc.pair_compact

    def wrapped(hit, Bg, M=None):
        record.append((hit.clone(), Bg, M))
        return fn(hit, Bg, M)

    bc.pair_compact = wrapped
    try:
        yield
    finally:
        bc.pair_compact = fn


def pair_edge_masks(dev):
    """Hit masks beyond the path's: ragged (hit rates 5-95%, instances that
    hit nothing), tied (every pair a hit, so T = K N; none a hit, so the
    budget is all misses), rays that cross more than M = 4 boxes, odd N with
    a budget of half the rays, and one long row (the scan's runs) ->
    [(label, hit [K, N], Bg, M)]."""
    import torch
    from neuralsim_torch.ops.pair_compact import pair_budget
    gen = torch.Generator().manual_seed(17)
    out = []
    for K, N in ((2, 2048), (5, 2047), (8, 4096), (8, 333)):
        for p in (0.05, 0.5, 0.95):
            rate = torch.full((K, 1), p)
            rate[0] = 0.0                                   # an instance that hits nothing
            hit = torch.rand((K, N), generator=gen) < rate
            for gf in (1.0, 0.5):
                out.append((f"ragged K={K} N={N} p={p} gf={gf}", hit, pair_budget(K, N, gf), 4))
    for K, N in ((8, 4096), (3, 1001)):
        for label, hit in (("every pair a hit", torch.ones((K, N), dtype=torch.bool)),
                           ("no hit", torch.zeros((K, N), dtype=torch.bool))):
            for gf in (1.0, 0.5, float(K)):
                out.append((f"{label} K={K} N={N} gf={gf}", hit, pair_budget(K, N, gf), 4))
    hit = torch.rand((8, 4096), generator=gen) < 0.2
    hit[:, ::7] = True                                      # 8 boxes on every 7th ray
    out.append(("rays through 8 boxes, M=4", hit, 4096, 4))
    out.append(("rays through 8 boxes, M=1", hit, 2048, 1))
    hit = torch.rand((2, 200_003), generator=gen) < 0.3
    out.append(("long rows K=2 N=200003", hit, 200_003, 4))
    return [(label, h.to(dev), Bg, M) for label, h, Bg, M in out]


def check_pair_compact(dev, path_calls):
    """K11 against its plain version (the JAX package's argsort lines): the
    selected pairs, their hit flags and, with M, the slot indices equal,
    integer for integer, on the path's calls (with and without the slots) and
    on pair_edge_masks. -> the number of sets held."""
    import torch
    from neuralsim_torch.ops.pair_compact import pair_compact, pair_compact_plain
    sets = [(f"path call K={h.shape[0]} N={h.shape[1]} Bg={Bg} M={M}", h, Bg, M)
            for h, Bg, M in path_calls] + pair_edge_masks(dev)
    for label, hit, Bg, M in sets:
        for m in ((M,) if M is None else (M, None)):
            got, want = pair_compact(hit, Bg, m), pair_compact_plain(hit, Bg, m)
            torch.cuda.synchronize()
            same = all((g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))
                       for g, w in zip(got, want))
            if not same:
                raise AssertionError(f"K11 differs from its plain version: {label} M={m}")
    log(f"K11 pair_compact: {len(sets)} hit masks (path calls {len(path_calls)}), every "
        f"output equal to the plain version's, with and without the slots")
    return len(sets)


def check_batched_occ(dev, accel, st, rows):
    """K10 against its plain version at the path's rows (the recorded inputs
    of one vehicle group's proposal: rays, near, far, instance index), on the
    converged per-instance grids and on random grids whose occupied share
    differs from instance to instance (so a wrong grid index shows), without
    noise (the render) and with; on probes that leave the box; on grid
    indices outside [0, G) (clipped, as the JAX take's mode="clip"); and on
    the dynamic grid's keyframe index of times in [-0.2, 1.2].
    -> (max_abs_err, the inputs kept for timing)."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
    o, d, near, far, n, bidx = rows
    G, R = st.mask.shape[0], st.mask.shape[-1]
    M = accel.march_steps
    box, edges = accel.box(dev), accel.edges01(M, dev)
    gen = torch.Generator().manual_seed(19)
    noise = torch.rand((o.shape[0], n), generator=gen).to(dev)
    share = torch.linspace(0.05, 0.6, G)[:, None, None, None]
    rand_mask = (torch.rand((G, R, R, R), generator=gen) < share).to(dev)
    lead = bidx.to(torch.int32).contiguous()
    wild = torch.randint(-2, G + 2, lead.shape, generator=gen, dtype=torch.int32).to(dev)
    t01 = torch.rand(lead.shape, generator=gen).to(dev) * 1.4 - 0.2
    kf = (t01 * G).to(torch.int32).clamp(0, G - 1)
    far_out = far * 3.0 + 1.0
    errs = []
    for label, mask, ld, nf in (("converged grids", st.mask, lead, (near, far)),
                                ("random grids", rand_mask, lead, (near, far)),
                                ("random grids, probes outside the box", rand_mask, lead,
                                 (torch.full_like(near, 0.01), far_out)),
                                ("random grids, indices outside [0, G)", rand_mask, wild,
                                 (near, far)),
                                ("random grids, keyframes of times", rand_mask, kf, (near, far))):
        for nz in (None, noise):
            a = (o, d, *nf, mask, *box, edges, n, nz, ld)
            errs.append(compare(f"K10 occ_ray_proposal_batched rows={o.shape[0]} G={G} R={R} "
                                f"M={M} n={n} {label} noise={nz is not None}",
                                [occ_ray_proposal(*a)], [occ_ray_proposal_plain(*a)], **K4_TOL))
    torch.cuda.synchronize()
    return max(errs), dict(args=(o, d, near, far, st.mask, *box, edges, n, noise, lead))


def check_batched_ema(dev, accel, st, field):
    """K7 at the batched update's shape: the per-instance grids' V = G R^3
    voxels, one jittered sample each, raw values from the shared model's own
    SDF of each instance, warm-up on and off. -> (max_abs_err, inputs)."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ema_update, occ_ema_update_plain
    gen = torch.Generator(device=dev).manual_seed(23)
    x = accel._voxel_points(torch.rand(accel.jitter_shape, generator=gen, device=dev))
    bidx = torch.arange(accel.n_grids, device=dev).repeat_interleave(accel.res ** 3)
    with torch.no_grad():
        raw = field.query_sdf(x, bidx=bidx).reshape(1, -1).contiguous()
    val = st.val.reshape(-1).contiguous()
    errs = []
    for floor in (None, accel.occ_thre + 1e-3):
        a = (raw, val, accel.occ_val_fn, accel.raw_scale, accel.occ_inv_s, accel.ema_decay,
             accel.occ_thre, floor)
        got, want = occ_ema_update(*a), occ_ema_update_plain(*a)
        errs.append(compare(f"K7 occ_ema_update batched V={raw.shape[1]} S=1 "
                            f"warm-up={floor is not None}", got[:1], want[:1], 0, K7_ATOL))
        off = (got[1] != want[1]) & ((want[0] - accel.occ_thre).abs() > K7_ATOL)
        if bool(off.any()):
            raise AssertionError("K7 batched: the mask differs away from the threshold")
    return max(errs), dict(args=(raw, val, accel.occ_val_fn, accel.raw_scale, accel.occ_inv_s,
                                 accel.ema_decay, accel.occ_thre, None))


def time_refresh(accel, st, field, dev, reps=5):
    """Host-clock ms of one refresh of the per-instance grids (the jitter
    drawn, G R^3 points through the shared model in chunks of its
    eval_chunk, K7), median of ``reps``, and the peak memory it allocates
    above what was held before (MiB)."""
    import torch
    from neuralsim_torch.fields.neus import map_chunked
    gen = torch.Generator(device=dev).manual_seed(29)
    lines = field.encoding.kernel_lines()
    query = lambda x, b: map_chunked(lambda c, cb: field.query_sdf(c, lines, cb), x,
                                     field.eval_chunk, b)
    ts = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        accel.update(st, query, torch.rand(accel.jitter_shape, generator=gen, device=dev), 1000)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    ts = sorted(ts[1:])
    return ts[reps // 2], peak


def time_crowd_kernels(pair_shapes, occ_shapes, ema_shapes, synth_hit):
    """K11 at the crowd's render and training calls and at synthetic_multi's,
    beside its plain version and a stable torch.argsort of the same keys
    (the library call that selects the same pairs); K10 at the path's rows;
    K7 at the batched update's shape -> {kernel: [timing, ...]}."""
    import torch
    from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                                occ_ray_proposal, occ_ray_proposal_plain)
    from neuralsim_torch.ops.pair_compact import pair_compact, pair_compact_plain
    out = {"pair_compact": []}
    for label, (hit, Bg, M) in pair_shapes + [("synthetic_multi training call", synth_hit)]:
        K, N = hit.shape
        rank = torch.cumsum(hit.to(torch.int64), dim=1) - 1
        keyv = torch.where(hit, rank * K + torch.arange(K, device=hit.device)[:, None],
                           torch.full_like(rank, K * N)).reshape(-1)
        out["pair_compact"].append(dict(
            shape=f"{label}: hit [{K}, {N}], Bg={Bg}, {'slots M=' + str(M) if M else 'no slots'}"
                  f", {int(hit.sum())} hits",
            **card_ms(lambda: pair_compact(hit, Bg, M)),
            plain_ms=cuda_ms(lambda: pair_compact_plain(hit, Bg, M)),
            library_ms=cuda_ms(lambda: torch.argsort(keyv, stable=True)[:Bg]),
            library_queued_ms=cuda_ms(lambda: torch.argsort(keyv, stable=True)[:Bg],
                                      queued=True),
            library_prof_ms=prof_ms(lambda: torch.argsort(keyv, stable=True)[:Bg]),
            # the hit mask read, order, hit flags (and slots) written; the
            # rank formula's K compare-adds per pair, the slots' K per hit
            bound=bound(K * N + Bg * (9 + (8 if M else 0)), 2.0 * K * K * N * (2 if M else 1))))
    a = occ_shapes["args"]
    N, n, M, G, R = a[0].shape[0], a[8], a[7].shape[0] - 1, a[4].shape[0], a[4].shape[-1]
    out["occ_ray_proposal_batched"] = [dict(
        shape=f"vehicle rows={N} march segments={M} samples={n} grids [{G}, {R}, {R}, {R}] "
              f"(drawn noise)",
        **card_ms(lambda: occ_ray_proposal(*a)),
        plain_ms=cuda_ms(lambda: occ_ray_proposal_plain(*a)),
        library_ms=None,
        bound=bound(N * 36 + N * M + (M + 1) * 4 + 2 * N * n * 4, N * (M * 30 + n * M * 6)))]
    a = ema_shapes["args"]
    S, V = a[0].shape
    out["occ_ema_update"] = [dict(
        shape=f"batched: voxels={V} ({G} grids of {R}^3) samples per voxel={S} (sdf)",
        ms=cuda_ms(lambda: occ_ema_update(*a)),
        plain_ms=cuda_ms(lambda: occ_ema_update_plain(*a)),
        library_ms=None,
        bound=bound(V * (4 * S + 4 + 4 + 1), V * (S * 12 + 4)))]
    return out


def crowd_phase(dev, profile_it):
    """Phase 9 (WAYMO_DEMO_CROWD) and its share of the timing."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import WAYMO_DEMO_CROWD as C
    from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
    from neuralsim_torch.scene import Scene
    from neuralsim_torch.scene.observers import camera_get_all_rays, camera_get_selected_rays
    from neuralsim_torch.tools.build import (build_compose_renderer, build_multi_trainer,
                                             converge_occ, render_multi_frame)

    # -- the render, from converged grids ----------------------------------
    t0 = time.perf_counter()
    scene, bank, renderer, params = build_compose_renderer(C)
    veh_id = renderer.objects[0].model_id
    vehicles = [ob.obj_id for ob in renderer.objects]
    va, sa = renderer.accels[veh_id], renderer.accels["cr"]
    seed = int(C["seed"])
    occ = {"cr": converge_occ(sa, sa.init_state(), ground_sdf_tensor, seed=seed,
                              **C["occ_converge"]),
           veh_id: converge_occ(va, va.init_state(),
                                lambda x, b: params[veh_id].query_sdf(x, bidx=b), seed=seed,
                                **C["occ_converge"])}
    torch.cuda.synchronize()
    veh_frac = [float(m.float().mean()) for m in occ[veh_id].mask]
    log(f"crowd model: built in {time.perf_counter() - t0:.2f} s; {len(vehicles)} vehicles on "
        f"one model, group_budget_frac {renderer.group_budget_frac}, max_hits_per_ray "
        f"{renderer.max_hits_per_ray}; vehicle grids {tuple(occ[veh_id].mask.shape)} converged "
        f"on the model's own SDF, occupied shares {[round(f, 4) for f in veh_frac]}; street "
        f"grid occupied {float(sa.occupied_fraction(occ['cr'])):.4f}")
    if (len(vehicles), va.res, va.n_grids, va.march_steps, renderer.max_hits_per_ray,
            renderer._pair_rows(renderer.objects, RAYSCHUNK)) != (CROWD_VEHICLES, 32, 8, 64, 4,
                                                                   RAYSCHUNK):
        raise AssertionError("the crowd model's sizes are not the ones checked here")
    if not all(0.0 < f < 0.5 for f in veh_frac):
        raise AssertionError("the converged vehicle grids should hold a small occupied share")

    H, W = (int(v) for v in scene.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    frozen = scene.slice_at(COMPOSE_FRAME_IDS[0])
    o, d = camera_get_all_rays(frozen, COMPOSE_CAM, H, W)
    s0 = max(H * W // 2 - RAYSCHUNK // 2, 0)         # a chunk around the horizon
    oc, dc = o[s0:s0 + RAYSCHUNK].contiguous(), d[s0:s0 + RAYSCHUNK].contiguous()
    calls, rows = [], {}
    with torch.no_grad(), pair_calls(calls):
        orig = type(va).ray_proposal_batched

        def keep_rows(st, ro, rd, n_, f_, nc, bidx, **kw):
            rows["inputs"] = (ro, rd, n_, f_, nc, bidx)
            return orig(va, st, ro, rd, n_, f_, nc, bidx, **kw)

        va.ray_proposal_batched = keep_rows
        try:
            chunk = renderer.ray_query(params, frozen, oc, dc, occ_states=occ,
                                       return_buffer=True)
        finally:
            del va.ray_proposal_batched
    mb = chunk["merged_buffer"]
    lanes = CROWD_VEHICLES * 32 + 72
    if mb["t"].shape != (RAYSCHUNK, lanes):
        raise AssertionError(f"the render's merged buffer is {tuple(mb['t'].shape)}, not "
                             f"[4096, {lanes}]")
    errs = {"cross_source_vw": (check_cross_source_vw(dev, (mb["t"], mb["mask"], mb["alpha"])),
                                K8_TOL["atol"])}
    e10, occ_shapes = check_batched_occ(dev, va, occ[veh_id], rows["inputs"])
    errs["occ_ray_proposal_batched"] = (e10, K4_TOL["atol"])
    e7, ema_shapes = check_batched_ema(dev, va, occ[veh_id], params[veh_id])
    errs["occ_ema_update"] = (e7, K7_ATOL)

    kernels.reset_counts()
    frames = [render_multi_frame(renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK)
              for fi in COMPOSE_FRAME_IDS]
    torch.cuda.synchronize()
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    chunks = len(COMPOSE_FRAME_IDS) * -(-H * W // RAYSCHUNK)
    log(f"crowd render: {len(COMPOSE_FRAME_IDS)} frames of {H}x{W} ({chunks} chunks), "
        f"launches {launches_render}")
    for name in ("cross_source_vw", "occ_ray_proposal", "pair_compact",
                 "occ_ray_proposal_batched"):
        if launches_render[name] != chunks:
            raise AssertionError(f"a crowd chunk launches {name} once")
    check_compose_frames(frames, H, W, vehicles)
    scene_cpu = Scene.load_from_scenario(demo_scenario(**C["dataset_cfg"]["params"]))
    crop = compose_crop(H, W)
    cut = lambda a: a.reshape(H, W, 3)[crop].reshape(-1, 3).cpu().contiguous()
    by_ray = check_compose_crop(renderer, params, frozen, scene_cpu.slice_at(COMPOSE_FRAME_IDS[0]),
                                cut(o), cut(d), dev, occ,
                                {k: type(v)(v.val.cpu(), v.mask.cpu()) for k, v in occ.items()})
    frame_ms, frame_min, frame_max = time_compose_frames(renderer, params, scene, occ)
    log(f"timing: crowd frame median {frame_ms:.3f} ms (min {frame_min:.3f}, max "
        f"{frame_max:.3f}) for {H * W} rays, {H * W / frame_ms * 1e3:.1f} rays/s")
    refresh_ms, refresh_mib = time_refresh(va, occ[veh_id], params[veh_id], dev)
    log(f"timing: refresh of the {va.n_grids} vehicle grids ({va.n_grids * va.res ** 3} points "
        f"through the shared model, eval_chunk {params[veh_id].eval_chunk}) median "
        f"{refresh_ms:.3f} ms, peak {refresh_mib:.1f} MiB above what was held")
    del scene, bank, renderer, params, occ, frames

    # -- training ----------------------------------------------------------
    cfg = copy.deepcopy(C)
    cfg["training"]["error_map"] = {**cfg["training"]["error_map"],
                                    "enable_after": MULTI_ERROR_MAP_AFTER}
    timings = {}
    t0 = time.perf_counter()
    scene, bank, trainer, state, samplers = build_multi_trainer(cfg, timings=timings)
    torch.cuda.synchronize()
    log(f"crowd training: built in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()) + "); grids "
        f"{ {k: tuple(v.mask.shape) for k, v in state.occ.items()} } at their initial state")
    r = trainer.renderer
    gen = torch.Generator(device=dev).manual_seed(31)
    lbatch, pbatch, cam = multi_batches(scene, samplers, dev, MULTI_RAYS, MULTI_BEAMS)
    train_calls = []
    with torch.no_grad(), pair_calls(train_calls):
        fr = scene.slice_at(pbatch["rays_fidx"].long())
        ro, rd = camera_get_selected_rays(fr, cam, pbatch["rays_xy"])
        noise = trainer.draw_noise("pixel", MULTI_RAYS, gen, state.it)
        tb = r.ray_query(state.params, fr, ro.contiguous(), rd.contiguous(), it=state.it,
                         occ_states=state.occ, return_buffer=True, with_per_obj=False,
                         noise=noise["render"])["merged_buffer"]
    t_lanes = r.max_hits_per_ray * 32 + 72
    if tb["t"].shape != (MULTI_RAYS, t_lanes):
        raise AssertionError(f"the crowd pixel step's merged buffer is {tuple(tb['t'].shape)}, "
                             f"not [4096, {t_lanes}]")
    path = (tb["t"].contiguous(), tb["mask"].contiguous(), tb["alpha"].contiguous())
    errs["cross_source_vw"] = (max(errs["cross_source_vw"][0], check_cross_source_vw(dev, path)),
                               K8_TOL["atol"])
    n_sets = check_pair_compact(dev, calls[:1] + train_calls)
    errs["pair_compact"] = (0.0, 0.0)
    loss_err, grad_err = check_multi_first_iteration(scene, trainer, state, samplers, dev)
    log_, launches, falls = check_multi_training(scene, trainer, state, samplers, dev,
                                                 CROWD_ITERS, "crowd")
    check_multi_poisoned_step(scene, trainer, state, samplers, dev)
    frame = render_multi_frame(r, state.params, scene, 0, COMPOSE_CAM, state.occ, RAYSCHUNK)
    torch.cuda.synchronize()
    m = frame["mask_volume"]
    log(f"crowd training: rendered frame 0 ({H}x{W}) of the trained state, mask in "
        f"[{float(m.min()):.4f}, {float(m.max()):.6f}], mean {float(m.mean()):.4f}")
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        if not torch.isfinite(frame[k]).all() or frame[k].shape[0] != H * W:
            raise AssertionError(f"the trained crowd frame's {k} is not finite of {H * W} rays")
    if float(m.min()) < 0.0 or float(m.max()) > MASK_CAP:
        raise AssertionError("the trained crowd frame's mask leaves [0, 1 + 1.1e-3]")
    it_ms = time_multi_iterations(scene, trainer, state, samplers, dev)
    rays = MULTI_RAYS + MULTI_BEAMS
    for k, (med, lo, hi) in it_ms.items():
        log(f"timing: crowd {k} median {med:.3f} ms (min {lo:.3f}, max {hi:.3f})")
    log(f"timing: crowd iteration {rays} rays, {rays / it_ms['iteration'][0] * 1e3:.1f} rays/s; "
        f"hand-kernel launches per iteration {sum(launches.values()) / CROWD_ITERS:.1f}")
    pair_shapes = [("render call", calls[0]), ("training call", train_calls[0])]
    summary = {"crowd_frame_ms": frame_ms, "crowd_frame_ms_min": frame_min,
               "crowd_frame_ms_max": frame_max, "crowd_rays_per_s": H * W / frame_ms * 1e3,
               "crowd_vehicle_occ_frac": veh_frac, "crowd_crop_by_ray": by_ray,
               "crowd_refresh_ms": refresh_ms, "crowd_refresh_peak_mib": refresh_mib,
               "crowd_k11_sets_equal": n_sets, "crowd_build_s": timings,
               "crowd_first_iteration_loss_rel_err": loss_err,
               "crowd_first_iteration_grad_rel_err": grad_err,
               "crowd_iterations": CROWD_ITERS,
               "crowd_loss_rgb_first10": falls["loss_rgb"][0],
               "crowd_loss_rgb_last10": falls["loss_rgb"][1],
               "crowd_lidar_depth_first10": falls["lidar/lidar_loss_depth"][0],
               "crowd_lidar_depth_last10": falls["lidar/lidar_loss_depth"][1],
               "crowd_lidar_step_ms": it_ms["lidar"][0], "crowd_pixel_step_ms": it_ms["pixel"][0],
               "crowd_iteration_ms": it_ms["iteration"][0],
               "crowd_iteration_ms_min": it_ms["iteration"][1],
               "crowd_iteration_ms_max": it_ms["iteration"][2],
               "crowd_rays_per_s_training": rays / it_ms["iteration"][0] * 1e3,
               "crowd_hand_launches_per_iteration": sum(launches.values()) / CROWD_ITERS}
    if profile_it:
        prof = profile_multi_steps(scene, trainer, state, samplers, dev)
        for k, (n, busy, _) in prof.items():
            summary[f"crowd_{k}_step_device_kernels"] = n
            summary[f"crowd_{k}_step_busy_ms"] = busy
    return dict(errs=errs, launches=launches, launches_render=launches_render,
                iters=CROWD_ITERS, n_frames=len(COMPOSE_FRAME_IDS), summary=summary,
                shapes=(pair_shapes, occ_shapes, ema_shapes))


# ---------------------------------------------------------------------------
# Phase 10: configs/synthetic_multi.yaml end to end (SYNTHETIC_MULTI)
# ---------------------------------------------------------------------------

def synthetic_multi_phase(dev):
    """Build SYNTHETIC_MULTI at full width, 48 pixel steps of 2,048 rays
    through train_loop (finite losses, falling loss_rgb, no skip, K11 and K8
    with its backward once a step, K3 on the street's hash levels), one frame
    of the trained state, and the step time."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import SYNTHETIC_MULTI as C
    from neuralsim_torch.tools.build import build_multi_trainer, render_multi_frame
    from neuralsim_torch.tools.train_multi import _PIXEL_KEYS, to_device, train_loop
    timings = {}
    t0 = time.perf_counter()
    scene, bank, trainer, state, samplers = build_multi_trainer(C, timings=timings)
    torch.cuda.synchronize()
    r = trainer.renderer
    n_rays = C["training"]["n_rays"]
    street = bank.assets[r.scene_models["cr"][0]].field.encoding
    log(f"synthetic_multi: built in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()) + f"); vehicles "
        f"{[ob.obj_id for ob in r.objects]} on one model, pair budget "
        f"{r._pair_rows(r.objects, n_rays)} rows, street levels "
        f"{[(sp.res, sp.typ) for sp in street.specs]}, grids {list(r.accels)}, "
        f"LiDAR sampler {samplers['lidar']}")
    if (len(r.objects), r._pair_rows(r.objects, n_rays), samplers["lidar"], r.accels) \
            != (2, n_rays, None, {}):
        raise AssertionError("the synthetic_multi model is not the one checked here")
    gen = torch.Generator(device=dev).manual_seed(37)
    log_ = []
    kernels.reset_counts()
    train_loop(scene, trainer, state, samplers, SYNTH_STEPS, gen, 1, log_)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    log(f"synthetic_multi: {SYNTH_STEPS} pixel steps of {n_rays} rays, launches {launches}")
    for rec in log_:
        for k, v in rec.items():
            if k.startswith("loss") and not np.isfinite(v):
                raise AssertionError(f"synthetic_multi: non-finite {k} at step {rec['it']}")
    first = float(np.mean([rec["loss_rgb"] for rec in log_[:10]]))
    last = float(np.mean([rec["loss_rgb"] for rec in log_[-10:]]))
    log(f"synthetic_multi: loss_rgb first 10 steps {first:.5f}, last 10 {last:.5f}; skips "
        f"{log_[-1]['skips_total']}")
    if log_[-1]["skips_total"] != 0 or not last < first:
        raise AssertionError("synthetic_multi: a step was skipped or loss_rgb did not fall")
    want = {"pair_compact": SYNTH_STEPS, "cross_source_vw": SYNTH_STEPS,
            "cross_source_vw.bwd": SYNTH_STEPS, "volume_composite": 0,
            "occ_ray_proposal": 0, "occ_ray_proposal_batched": 0, "occ_ema_update": 0}
    if any(launches[k] != n for k, n in want.items()) or not launches["lotd_grid"] \
            or not launches["lotd_grid.bwd"]:
        raise AssertionError(f"synthetic_multi's launches are not as counted: want {want} and "
                             f"K3 (the street's hash levels)")
    hit_calls = []
    with torch.no_grad(), pair_calls(hit_calls):
        H, W = (int(v) for v in scene.nodes[SYNTH_CAM].frame_data["hw"][0].tolist())
        frame = render_multi_frame(r, state.params, scene, 0, SYNTH_CAM, None, RAYSCHUNK)
    torch.cuda.synchronize()
    m = frame["mask_volume"]
    log(f"synthetic_multi: frame 0 ({H}x{W}) of the trained state, mask in "
        f"[{float(m.min()):.4f}, {float(m.max()):.6f}], mean {float(m.mean()):.4f}, per source "
        f"{ {k: round(float(v['mask_volume'].mean()), 4) for k, v in frame['per_obj'].items()} }")
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        if not torch.isfinite(frame[k]).all() or frame[k].shape[0] != H * W:
            raise AssertionError(f"synthetic_multi: the frame's {k} is not finite of {H * W} rays")
    if float(m.min()) < 0.0 or float(m.max()) > MASK_CAP:
        raise AssertionError("synthetic_multi: the frame's mask leaves [0, 1 + 1.1e-3]")
    pix = samplers["pixel"]
    ts = []
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = pix.sample()
        trainer.train_step(state, to_device(raw, _PIXEL_KEYS, dev),
                           trainer.draw_noise("pixel", n_rays, gen, state.it), "pixel",
                           raw["cam_id"])
        torch.cuda.synchronize()
        if i >= 3:
            ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    log(f"timing: synthetic_multi step median {ts[10]:.3f} ms (min {ts[0]:.3f}, max "
        f"{ts[-1]:.3f}) for {n_rays} rays, {n_rays / ts[10] * 1e3:.1f} rays/s; hand-kernel "
        f"launches per step {sum(launches.values()) / SYNTH_STEPS:.1f}")
    # K11 at this path's training call: the same hit mask with the slots
    train_calls = []
    with torch.no_grad(), pair_calls(train_calls):
        raw = pix.sample()
        b = to_device(raw, _PIXEL_KEYS, dev)
        trainer.compute_losses(state.params, b, state.it,
                               trainer.draw_noise("pixel", n_rays, gen, state.it), "pixel",
                               state.occ, raw["cam_id"])
    check_pair_compact(dev, train_calls + hit_calls)
    summary = {"synthetic_multi_build_s": timings, "synthetic_multi_steps": SYNTH_STEPS,
               "synthetic_multi_loss_rgb_first10": first, "synthetic_multi_loss_rgb_last10": last,
               "synthetic_multi_step_ms": ts[10], "synthetic_multi_step_ms_min": ts[0],
               "synthetic_multi_step_ms_max": ts[-1],
               "synthetic_multi_rays_per_s": n_rays / ts[10] * 1e3,
               "synthetic_multi_hand_launches_per_step": sum(launches.values()) / SYNTH_STEPS}
    return dict(launches=launches, steps=SYNTH_STEPS, summary=summary, hit=train_calls[0])


# ---------------------------------------------------------------------------
# Phase 11: WAYMO_DEMO_MULTI on the per-level CP path (K2) with the NeuS
# alpha inside the composite (K12)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def cp_per_level():
    """NEURALSIM_CP_STACKED=0 while the block builds its models (an
    encoding reads it when it is built), as it was before afterwards."""
    import os
    old = os.environ.get("NEURALSIM_CP_STACKED")
    os.environ["NEURALSIM_CP_STACKED"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["NEURALSIM_CP_STACKED"]
        else:
            os.environ["NEURALSIM_CP_STACKED"] = old


def neus_inputs(n, s, seed):
    """A NeuS buffer as a final evaluation gives it: rays through a surface
    (sdf falling through 0, nablas against the ray with noise), masked lanes,
    a fully masked ray, and lanes whose alpha is exactly 1 (a 0.2 gap in
    depth behind a lane at the surface) -> (t, mask, sdf, nablas, rays_d,
    rgb) as numpy."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 2.0 + 0.5, -1).astype(np.float32)
    sdf = (0.7 + rng.random((n, 1)) * 1.5 - t + rng.normal(0, 0.01, (n, s))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    nablas = (-d[:, None, :] * (0.8 + 0.4 * rng.random((n, s, 1)))
              + rng.normal(0, 0.3, (n, s, 3))).astype(np.float32)
    mask = rng.random((n, s)) > 0.1
    mask[7] = False
    tie = np.arange(3, n, 6)
    t[tie, 11:] += 0.2
    t[tie, 10] = t[tie, 9] + 0.01
    t[tie] = np.sort(t[tie], -1)
    sdf[tie, 10], mask[tie, 10] = 0.03, True
    nablas[tie, 10] = -d[tie] * 1.2
    return t, mask, sdf, nablas, d, rng.random((n, s, 3)).astype(np.float32)


def neus_args(buf):
    """K12's arguments (t, mask, sdf, nablas, rays_d, anneal, inv_s, rgb) of a
    NeuS buffer that was composited alone."""
    c = lambda x: None if x is None else x.detach().contiguous()
    return (c(buf["t"]), c(buf["mask"]), c(buf["sdf"]), c(buf["nablas"]), c(buf["rays_d"]),
            float(buf["cos_anneal"]), c(buf["details"]["inv_s"]).reshape(()), c(buf.get("rgb")))


def check_neus_composite(dev, sets):
    """K12 forward and backward against their plain versions on each of
    ``sets`` ((label, args), args as neus_args gives them) at the cos anneals
    0, 0.5 and 1, the backward with non-zero cotangents of every output (the
    alpha's too) -> ({kernel: (max_abs_err, tol)}, the first set's inputs at
    its own anneal, kept for timing)."""
    import torch
    from neuralsim_torch.renderers.neus_composite import (neus_composite, neus_composite_bwd,
                                                          neus_composite_bwd_plain,
                                                          neus_composite_plain)
    ef, eb, shapes = [], [], {}
    for k, (label, args) in enumerate(sets):
        t, rgb = args[0], args[7]
        n, S = t.shape
        cots = [cotangents(sh, 60 + 7 * k + i, dev) for i, sh in enumerate(
            ((n, S), (n,), (n,), (n, 3), (n, 3), (n, S)))]
        if rgb is None:
            cots[3] = None
        what = f"{label} rays={n} S={S}{'' if rgb is None else ' with rgb'}"
        for anneal in K12_ANNEALS:
            a = (*args[:5], anneal, *args[6:])
            ef.append(compare(f"K12 neus_composite {what} anneal={anneal:g}",
                              neus_composite(*a), neus_composite_plain(*a), **K12_TOL))
            eb.append(compare_rel(f"K12 bwd {what} anneal={anneal:g}",
                                  neus_composite_bwd(*a, *cots),
                                  neus_composite_bwd_plain(*a, *cots), GRAD_REL))
        if k == 0:
            shapes["neus_composite"] = dict(args=args, what=what)
            shapes["neus_composite.bwd"] = dict(args=(*args, *cots), what=what)
    torch.cuda.synchronize()
    return ({"neus_composite": (max(ef), K12_TOL["atol"]),
             "neus_composite.bwd": (max(eb), GRAD_REL)}, shapes)


def time_neus_composite(shapes):
    """K12 forward and backward, their plain versions and bounds at the kept
    inputs."""
    from neuralsim_torch.renderers.neus_composite import (neus_composite, neus_composite_bwd,
                                                          neus_composite_bwd_plain,
                                                          neus_composite_plain)
    a, what = shapes["neus_composite"]["args"], shapes["neus_composite"]["what"]
    b = shapes["neus_composite.bwd"]["args"]
    n, S = a[0].shape
    c = 0 if a[7] is None else 12          # rgb bytes a lane
    return {
        "neus_composite": dict(
            shape=what, **card_ms(lambda: neus_composite(*a)),
            plain_ms=cuda_ms(lambda: neus_composite_plain(*a), reps=5), library_ms=None,
            # t, mask, sdf, nablas (rgb) read and vw, alpha written a lane; the
            # direction read and five sums written a ray; ~50 flops a lane
            bound=bound(n * S * (21 + c + 8) + n * (12 + 12 + 12 + c), n * S * 50)),
        "neus_composite.bwd": dict(
            shape=what, **card_ms(lambda: neus_composite_bwd(*b)),
            plain_ms=cuda_ms(lambda: neus_composite_bwd_plain(*b), reps=5), library_ms=None,
            # t, mask, sdf, nablas (rgb) and the vw and alpha cotangents read,
            # d sdf, d nablas (d rgb) written a lane; ~140 flops a lane
            bound=bound(n * S * (21 + c + 8 + 16 + c) + n * (12 + 20 + c + 4), n * S * 140))}


def check_cp_level(dev, sets):
    """K2 forward (with and without the jacobian) and backward (cotangents of
    the features, of the jacobian, of both) against their plain versions on
    each of ``sets`` ((label, encoding, points)) -> ({kernel: (max_abs_err,
    tol)}, each set's inputs kept for timing)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    ef, eb, shapes = [], [], {}
    for k, (label, enc, x) in enumerate(sets):
        C, N = enc.out_dim, x.shape[0]
        table = enc.table.detach()
        a = (table, x, enc._cp_meta)
        what = (f"{label}: N={N}, {enc._cp_meta.shape[0]} levels of F "
                f"{enc._cp_meta[0, 2].item()}, R {enc._cp_meta[0, 0].item()}.."
                f"{enc._cp_meta[-1, 0].item()}")
        for jac in (False, True):
            ef.append(compare(f"K2 lotd_cp_level {what} jac={jac}",
                              encode_into(lotd.lotd_cp_level, a, C, N, dev, jac),
                              encode_into(lotd.lotd_cp_level_plain, a, C, N, dev, jac),
                              1e-5, 1e-5))
        d_out, d_jac = cotangents((C, N), 70 + k, dev), cotangents((3, C, N), 80 + k, dev)
        for name, do, dj in (("both", d_out, d_jac), ("feats", d_out, None),
                             ("jac", None, d_jac)):
            eb.append(compare_rel(f"K2 bwd {what} cotangents={name}",
                                  [lotd.lotd_cp_level_bwd(*a, do, dj)],
                                  [lotd.lotd_cp_level_bwd_plain(*a, do, dj)], GRAD_REL))
        shapes[label] = dict(args=a, C=C, grads=(d_out, d_jac), what=what)
    torch.cuda.synchronize()
    return {"lotd_cp_level": (max(ef), 1e-5), "lotd_cp_level.bwd": (max(eb), GRAD_REL)}, shapes


def check_k2_bwd_sets(dev, encs):
    """K2's backward (check_cp_bwd) for the street's and the vehicles'
    per-level ladders on cp_bwd_point_sets at a pixel step's shape, and for a
    level of R 9,000 beside one of R 16 (3 R floats of one feature past what
    the parent's kernel kept in shared memory) -> [max_abs_err, ...]."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    with cp_per_level():
        past = lotd.LoTDEncoding([(16, 4, "cp"), (9000, 2, "cp")], cp_stacked=False)
    past.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        past.table.add_(torch.randn(past.total_params, generator=torch.Generator().manual_seed(4))
                        * 0.3)
    past = past.to(dev)
    sets = [(label, enc, cp_bwd_point_sets(n_rows, s, enc.cp_rmax,
                                           [sp.res for sp in enc.specs if sp.typ == "cp"], seed))
            for label, enc, n_rows, s, seed in (
                ("street", encs["street"], MULTI_RAYS, 48, 96),
                ("vehicles", encs["vehicles"], 3 * MULTI_RAYS // 2, 32, 97))]
    sets.append(("R 16 and R 9,000", past,
                 [("20000 points", enc_points(20_000, 9000, 5)),
                  ("512 rays x 32 sorted samples", ray_points(512, 32, 9000, 98))]))
    errs = []
    for label, enc, pts in sets:
        table = enc.table.detach()
        errs += check_cp_bwd(dev, f"K2 bwd {label}", lotd.lotd_cp_level_bwd,
                             lotd.lotd_cp_level_bwd_plain, lambda x: (table, x, enc._cp_meta),
                             enc.out_dim, pts)
    return errs


def time_cp_level(shapes):
    """K2 forward (with the jacobian) and backward at each kept set, beside
    their plain versions and bounds -> {kernel: [timing, ...]}."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    out = {"lotd_cp_level": [], "lotd_cp_level.bwd": []}
    for label, sh in shapes.items():
        a, C, (d_out, d_jac) = sh["args"], sh["C"], sh["grads"]
        x, meta = a[1], a[2].tolist()
        N, L, F = x.shape[0], len(meta), sum(r[2] for r in meta)
        lines = sum(3 * r[0] * r[2] for r in meta) * 4     # the f32 CP segments
        buf = (torch.empty((C, N), device=x.device), torch.empty((3, C, N), device=x.device))
        out["lotd_cp_level"].append(dict(
            shape=sh["what"] + " with jacobian",
            ms=cuda_ms(lambda: lotd.lotd_cp_level(*a, *buf)),
            plain_ms=cuda_ms(lambda: lotd.lotd_cp_level_plain(*a, *buf), reps=5),
            library_ms=None,
            # points and lines read, features and jacobian written; the taps of
            # every level, then ~29 flops a feature
            bound=bound(N * 12 + lines + N * F * 16, N * (30 * L + 29 * F))))
        out["lotd_cp_level.bwd"].append(dict(
            shape=sh["what"] + ", cotangents of features and jacobian",
            **card_ms(lambda: lotd.lotd_cp_level_bwd(*a, d_out, d_jac)),
            plain_ms=cuda_ms(lambda: lotd.lotd_cp_level_bwd_plain(*a, d_out, d_jac), reps=3),
            library_ms=None,
            # points, lines and both cotangents read, the lines' gradient written
            bound=bound(N * 12 + lines + N * F * 16 + lines, N * (30 * L + 75 * F))))
    return out


@contextlib.contextmanager
def count_alpha_chain(counter):
    """Count (into ``counter["calls"]``) the calls of the plain NeuS alpha
    chain (``neus_alpha_from_sdf``) while the block runs."""
    import neuralsim_torch.fields.neus as neus
    fn = neus.neus_alpha_from_sdf

    def counted(*a, **kw):
        counter["calls"] += 1
        return fn(*a, **kw)

    neus.neus_alpha_from_sdf = counted
    try:
        yield
    finally:
        neus.neus_alpha_from_sdf = fn


def step_launches(scene, trainer, state, samplers, dev, shapes=None):
    """The kernels one LiDAR step and one pixel step launch (off the grids'
    cadence, no parameter moved), and the plain alpha chain's calls in each
    -> {step type: ({kernel: launches}, alpha-chain calls)}; given a dict
    ``shapes``, also each launch's integer arguments into
    ``shapes[step type][kernel]``."""
    import torch
    from neuralsim_torch import kernels
    gen = torch.Generator(device=dev).manual_seed(15)
    lbatch, pbatch, cam = multi_batches(scene, samplers, dev, MULTI_RAYS, MULTI_BEAMS)
    it = state.it if state.it % 16 else state.it + 1
    out = {}
    for step_type, batch in (("lidar", lbatch), ("pixel", pbatch)):
        noise = trainer.draw_noise(step_type, batch["rays_fidx"].shape[0], gen, it)
        counter = {"calls": 0}
        kernels.reset_counts()
        with count_alpha_chain(counter), launch_shapes(
                None if shapes is None else shapes.setdefault(step_type, {})):
            total, _ = trainer.compute_losses(state.params, batch, it, noise, step_type,
                                              state.occ, cam if step_type == "pixel" else None)
            total.backward()
        torch.cuda.synchronize()
        state.params.zero_grad(set_to_none=True)
        out[step_type] = ({k.name: k.launches for k in kernels.KERNELS.values()},
                          counter["calls"])
    return out


def perlevel_phase(dev, profile_it, stacked):
    """Phase 11: WAYMO_DEMO_MULTI built with NEURALSIM_CP_STACKED=0 (every CP
    level of the street and the vehicles per-level, K2), rendered and trained
    through the entry points, with the per-level iteration and frame medians
    beside ``stacked``'s (the multi-object and compose summaries of the same
    run) -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import BENCH_OBJECT, WAYMO_DEMO_MULTI as C
    from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
    from neuralsim_torch.fields.encodings.lotd import make_lotd
    from neuralsim_torch.scene import Scene
    from neuralsim_torch.scene.observers import camera_get_all_rays
    from neuralsim_torch.tools.build import (build_compose_renderer, build_multi_trainer,
                                             converge_occ, render_multi_frame)

    cfg = copy.deepcopy(C)
    cfg["training"]["error_map"] = {**cfg["training"]["error_map"],
                                    "enable_after": MULTI_ERROR_MAP_AFTER}
    timings = {}
    t0 = time.perf_counter()
    with cp_per_level():
        scene_r, _, renderer, params_r = build_compose_renderer(C)
        scene, bank, trainer, state, samplers = build_multi_trainer(cfg, timings=timings)
        bench_enc = make_lotd(BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"])
    bench_enc.reset_parameters(torch.Generator().manual_seed(3))
    bench_enc = bench_enc.to(dev)
    accel = renderer.accels["cr"]
    occ = {"cr": converge_occ(accel, accel.init_state(), ground_sdf_tensor, seed=int(C["seed"]),
                              **C["occ_converge"])}
    torch.cuda.synchronize()
    street_id, veh_id = renderer.scene_models["cr"][0], renderer.objects[0].model_id
    plan = lambda e: [(s.res, s.n_feats) for s in e.specs if s.typ == "cp"]
    encs = {"street": state.params[street_id].encoding, "vehicles": state.params[veh_id].encoding,
            "bench": bench_enc}
    log(f"per-level CP: built in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()) + "); CP levels (R, F): "
        + "; ".join(f"{k} {plan(e)}" for k, e in encs.items()))
    for e in (*encs.values(), params_r[street_id].encoding, params_r[veh_id].encoding):
        if e.cp_stacked or e.kernel_lines() is not None or e._cp_meta.shape[0] != len(plan(e)):
            raise AssertionError("an encoding of the per-level phase took the stacked path")
    if ([r for r, _ in plan(encs["street"])][::9], {f for _, f in plan(encs["street"])},
            len(plan(encs["vehicles"])), {f for _, f in plan(encs["vehicles"])},
            len(plan(bench_enc)), {f for _, f in plan(bench_enc)}, plan(bench_enc)[-1][0]) != \
            ([16, 1024], {4}, 6, {4}, 12, {8}, 1024):
        raise AssertionError("the per-level ladders are not the ones checked here")

    # K2 at the path's point sets and the bench model's ladder; K12 at the
    # LiDAR step's street buffer and synthetic_object's buffer with rgb
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = 3 * MULTI_RAYS // 2                      # the vehicles' compacted rows
    errs, shapes2 = check_cp_level(dev, (
        ("street, pixel step", encs["street"], T(ray_points(MULTI_RAYS, 48, 1024, 90))),
        ("street, LiDAR step", encs["street"], T(ray_points(MULTI_BEAMS, 48, 1024, 91))),
        ("vehicles", encs["vehicles"], T(ray_points(rows, 32, 256, 92))),
        ("bench ladder", bench_enc, T(ray_points(BENCH_RAYS, 32, 1024, 93))),
        ("street, uniform eikonal", encs["street"], T(enc_points(512, 1024, 94))),
        ("vehicles, uniform eikonal", encs["vehicles"], T(enc_points(512, 256, 95)))))
    errs["lotd_cp_level.bwd"] = (max(errs["lotd_cp_level.bwd"][0],
                                     *check_k2_bwd_sets(dev, encs)), GRAD_REL)
    lbuf = step_buffers(trainer, state, scene, samplers, dev, 16)["lidar"]
    if lbuf["t"].shape != (MULTI_BEAMS, 48) or "rays_d" not in lbuf:
        raise AssertionError("the LiDAR step's street buffer should be [2048, 48], fused")
    e12, shapes12 = check_neus_composite(dev, (
        ("LiDAR step's street buffer", neus_args(lbuf)),
        ("synthetic_object's buffer", (*[T(a) for a in neus_inputs(RAYSCHUNK, 96, 17)[:5]],
                                       1.0, torch.tensor(300.0, device=dev),
                                       T(neus_inputs(RAYSCHUNK, 96, 17)[5])))))
    errs.update(e12)

    # the render: 4 frames, a crop against the CPU path at its street depths
    H, W = (int(v) for v in scene_r.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    vehicles = [ob.obj_id for ob in renderer.objects]
    kernels.reset_counts()
    frames = [render_multi_frame(renderer, params_r, scene_r, fi, COMPOSE_CAM, occ, RAYSCHUNK)
              for fi in COMPOSE_FRAME_IDS]
    torch.cuda.synchronize()
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    chunks = len(COMPOSE_FRAME_IDS) * -(-H * W // RAYSCHUNK)
    log(f"per-level render: {len(COMPOSE_FRAME_IDS)} frames of {H}x{W}, launches "
        f"{launches_render}")
    if launches_render["lotd_cp_level"] <= 0 or launches_render["lotd_cp_stacked"] or \
            launches_render["cross_source_vw"] != chunks:
        raise AssertionError("a per-level chunk launches K2 (never K1) and K8 once")
    check_compose_frames(frames, H, W, vehicles)
    frozen = scene_r.slice_at(COMPOSE_FRAME_IDS[0])
    o, d = camera_get_all_rays(frozen, COMPOSE_CAM, H, W)
    scene_cpu = Scene.load_from_scenario(demo_scenario(**C["dataset_cfg"]["params"]))
    crop = compose_crop(H, W)
    cut = lambda a: a.reshape(H, W, 3)[crop].reshape(-1, 3).cpu().contiguous()
    by_ray = check_compose_crop(renderer, params_r, frozen,
                                scene_cpu.slice_at(COMPOSE_FRAME_IDS[0]), cut(o), cut(d), dev,
                                occ, {"cr": type(occ["cr"])(occ["cr"].val.cpu(),
                                                            occ["cr"].mask.cpu())})

    # training: the first iteration against the CPU, the launches of each step
    # type, 48 iterations, a poisoned step
    loss_err, grad_err = check_multi_first_iteration(scene, trainer, state, samplers, dev)
    step_shapes = {}
    per_step = step_launches(scene, trainer, state, samplers, dev, shapes=step_shapes)
    for step_type, (n, calls) in per_step.items():
        log(f"per-level {step_type} step: launches {n}, plain alpha-chain calls {calls}")
    k2_shapes = {st: {str(sh): calls.count(sh) for sh in sorted(set(calls))}
                 for st, rec in step_shapes.items()
                 for calls in [rec.get("lotd_cp_level.bwd", [])]}
    log(f"per-level K2 bwd launches by integer arguments (N, L, C): {k2_shapes}")
    lid, pix = per_step["lidar"][0], per_step["pixel"][0]
    if per_step["lidar"][1] or not (lid["neus_composite"] == lid["neus_composite.bwd"] == 1) \
            or lid["lotd_cp_level"] <= 0 or lid["lotd_cp_level.bwd"] <= 0 \
            or any(lid[k] for k in ("volume_composite", "volume_composite.bwd",
                                    "lotd_cp_stacked", "lotd_cp_stacked.bwd")):
        raise AssertionError("the per-level LiDAR step should take K12 and K2, no plain alpha "
                             "chain, no K6 and no K1")
    if pix["neus_composite"] or pix["lotd_cp_stacked"] or pix["cross_source_vw.bwd"] != 1:
        raise AssertionError("the per-level pixel step composites through K8, on K2")
    log_, launches, falls = check_multi_training(scene, trainer, state, samplers, dev,
                                                 PERLEVEL_ITERS, "per-level", per_level=True)
    check_multi_poisoned_step(scene, trainer, state, samplers, dev)

    it_ms = time_multi_iterations(scene, trainer, state, samplers, dev)
    frame_ms = time_compose_frames(renderer, params_r, scene_r, occ)
    rays = MULTI_RAYS + MULTI_BEAMS
    for k, (med, lo, hi) in it_ms.items():
        key = "multi_iteration_ms" if k == "iteration" else f"multi_{k}_step_ms"
        log(f"timing: per-level {k} median {med:.3f} ms (min {lo:.3f}, max {hi:.3f}); stacked "
            f"{stacked[key]:.3f} ms in this run")
    log(f"timing: per-level iteration {rays / it_ms['iteration'][0] * 1e3:.1f} rays/s (stacked "
        f"{stacked['multi_rays_per_s']:.1f}); hand-kernel launches per iteration "
        f"{sum(launches.values()) / PERLEVEL_ITERS:.1f}")
    log(f"timing: per-level frame median {frame_ms[0]:.3f} ms (min {frame_ms[1]:.3f}, max "
        f"{frame_ms[2]:.3f}); stacked {stacked['compose_frame_ms']:.3f} ms in this run")
    times = {**time_cp_level(shapes2), **time_neus_composite(shapes12)}
    summary = {"perlevel_build_s": timings, "perlevel_crop_by_ray": by_ray,
               "perlevel_first_iteration_loss_rel_err": loss_err,
               "perlevel_first_iteration_grad_rel_err": grad_err,
               "perlevel_iterations": PERLEVEL_ITERS,
               "perlevel_loss_rgb_first10": falls["loss_rgb"][0],
               "perlevel_loss_rgb_last10": falls["loss_rgb"][1],
               "perlevel_lidar_depth_first10": falls["lidar/lidar_loss_depth"][0],
               "perlevel_lidar_depth_last10": falls["lidar/lidar_loss_depth"][1],
               "perlevel_lidar_step_ms": it_ms["lidar"][0],
               "perlevel_pixel_step_ms": it_ms["pixel"][0],
               "perlevel_iteration_ms": it_ms["iteration"][0],
               "perlevel_iteration_ms_min": it_ms["iteration"][1],
               "perlevel_iteration_ms_max": it_ms["iteration"][2],
               "perlevel_rays_per_s": rays / it_ms["iteration"][0] * 1e3,
               "perlevel_frame_ms": frame_ms[0], "perlevel_frame_ms_min": frame_ms[1],
               "perlevel_frame_ms_max": frame_ms[2],
               "perlevel_stacked_iteration_ms": stacked["multi_iteration_ms"],
               "perlevel_stacked_frame_ms": stacked["compose_frame_ms"],
               "perlevel_hand_launches_per_iteration": sum(launches.values()) / PERLEVEL_ITERS,
               "perlevel_step_launches": {k: v[0] for k, v in per_step.items()},
               "perlevel_k2_bwd_launch_shapes": k2_shapes}
    if profile_it:
        prof = profile_multi_steps(scene, trainer, state, samplers, dev, named=PERLEVEL_PROFILED)
        for k, (n, busy, named) in prof.items():
            summary[f"perlevel_{k}_step_device_kernels"] = n
            summary[f"perlevel_{k}_step_busy_ms"] = busy
            summary[f"perlevel_{k}_step_kernel_ms"] = named
    return dict(errs=errs, times=times, launches=launches, launches_render=launches_render,
                step_launches={k: v[0] for k, v in per_step.items()}, iters=PERLEVEL_ITERS,
                n_frames=len(COMPOSE_FRAME_IDS), summary=summary)


# ---------------------------------------------------------------------------
# Phase 12: the permuto vehicles (WAYMO_DEMO_PERMUTO): K9
# ---------------------------------------------------------------------------

def permuto_points(n, d, seed, n_instances=3):
    """[n, d] lattice inputs as a permuto field's query gives them: xyz01
    uniform in the box (some on its faces), then, for d > 3, each point's
    sigmoid(z) of one of ``n_instances`` latents drawn N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, d), np.float32)
    x[:, :3] = rng.random((n, 3))
    x[::97, 0], x[1::97, 1] = 0.0, 1.0
    if d > 3:
        z = rng.normal(0.0, 0.5, (n_instances, d - 3))
        x[:, 3:] = 1.0 / (1.0 + np.exp(-z[rng.integers(0, n_instances, n)]))
    return x


def permuto_set(label, enc, n, seed, dev):
    """(label, encoding, a seeded table of trained magnitude (N(0, 0.1)) on
    the card, inputs [n, d] on the card) for check_permuto."""
    import torch
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0.0, 0.1, enc.total_params).astype(np.float32)).to(dev)
    x = torch.from_numpy(permuto_points(n, enc.input_dim, seed)).to(dev)
    return label, enc.to(dev), table, x


def check_permuto(dev, sets):
    """K9 forward (with and without the jacobian) and backward (cotangents of
    the features, of the jacobian, of both) against their plain versions on
    each of ``sets`` ((label, encoding, table, x01)) -> ({kernel: (max_abs_err,
    tol)}, each set's inputs kept for timing)."""
    import torch
    from neuralsim_torch.fields.encodings import permuto as pm
    ef, eb, shapes = [], [], {}
    for k, (label, enc, table, x) in enumerate(sets):
        (N, d), C = x.shape, enc.out_dim
        a = (table, x, enc._res, enc._meta, enc._lat, enc.table_size)
        what = (f"{label}: N={N} d={d}, {enc.n_levels} levels of F {enc.levels[0][1]}, res "
                f"{enc.levels[0][0]:g}..{enc.levels[-1][0]:g}, T {enc.table_size}")
        for jac in (False, True):
            ef.append(compare(f"K9 permuto {what} jac={jac}", pm.permuto(*a, C, jac),
                              pm.permuto_plain(*a, jac), **K9_TOL))
        d_out, d_jac = cotangents((C, N), 90 + k, dev), cotangents((3, C, N), 95 + k, dev)
        for name, do, dj in (("both", d_out, d_jac), ("feats", d_out, None),
                             ("jac", None, d_jac)):
            gt, gx = pm.permuto_bwd(*a, do, dj)
            wt, wx = pm.permuto_bwd_plain(*a, do, dj)
            eb.append(compare_rel(f"K9 bwd {what} cotangents={name}, d table", [gt], [wt],
                                  GRAD_REL))
            if dj is None or do is not None:
                eb.append(compare_rel(f"K9 bwd {what} cotangents={name}, d x01", [gx], [wx],
                                      K9_DX_REL))
            elif gx.abs().max() != 0:
                raise AssertionError("K9 bwd: the jacobian's cotangent reached x01")
        shapes[label] = dict(args=a, C=C, grads=(d_out, d_jac), what=what)
    torch.cuda.synchronize()
    return {"permuto": (max(ef), K9_TOL["atol"]), "permuto.bwd": (max(eb), GRAD_REL)}, shapes


@contextlib.contextmanager
def permuto_watch(record):
    """While the block runs, append to ``record["calls"]`` (N, d, kind) of
    every K9 wrapper call on the card (kind "fwd", "fwd+jac" or "bwd"), and
    count in ``record["plain_on_card"]`` the calls of the plain permuto
    functions with tensors on the card: the card path must take none."""
    from neuralsim_torch.fields.encodings import permuto as pm
    names = ("permuto", "permuto_bwd", "permuto_plain", "permuto_bwd_plain")
    saved = {k: getattr(pm, k) for k in names}
    record.setdefault("calls", [])
    record.setdefault("plain_on_card", 0)

    def fwd(table, x01, *a):
        if x01.is_cuda:                                       # a[-1]: with_jac
            record["calls"].append((x01.shape[0], x01.shape[1], "fwd+jac" if a[-1] else "fwd"))
        return saved["permuto"](table, x01, *a)

    def bwd(table, x01, *a, **kw):
        if x01.is_cuda:
            record["calls"].append((x01.shape[0], x01.shape[1], "bwd"))
        return saved["permuto_bwd"](table, x01, *a, **kw)

    def plain(name):
        def counted(table, x01, *a, **kw):
            record["plain_on_card"] += int(x01.is_cuda)
            return saved[name](table, x01, *a, **kw)
        return counted

    pm.permuto, pm.permuto_bwd = fwd, bwd
    pm.permuto_plain, pm.permuto_bwd_plain = plain("permuto_plain"), plain("permuto_bwd_plain")
    try:
        yield record
    finally:
        for k, v in saved.items():
            setattr(pm, k, v)


def time_permuto(shapes, ladder_n):
    """K9 forward (with the jacobian, and without it at the upsample ladder's
    ``ladder_n`` points of the first set) and backward (both cotangents) at
    each kept set, beside their plain versions and bounds -> {kernel:
    [timing, ...]}."""
    from neuralsim_torch.fields.encodings import permuto as pm
    out = {"permuto": [], "permuto.bwd": []}
    for i, (label, sh) in enumerate(shapes.items()):
        table, x, res, meta, lat, size = sh["args"]
        C, (d_out, d_jac) = sh["C"], sh["grads"]
        (N, d), L, F = x.shape, res.shape[0], int(meta[0, 1])
        tb = table.numel() * 4
        # float32 work a point and level: elevation 4d, rounding and
        # differentials 11 (d+1), interpolation 2 (d+1) F; the jacobian's
        # weights 12 (d+1) and sums 6 (d+1) F. The ranks, keys and hashes are
        # integer work and not counted.
        walk, interp = 4 * d + 11 * (d + 1), 2 * (d + 1) * F
        jac_ops = 12 * (d + 1) + 6 * (d + 1) * F
        runs = [(sh["what"] + " with jacobian", N, True)]
        if i == 0:
            runs.append((f"{label}: N={ladder_n} d={d} (the upsample ladder), no jacobian",
                         ladder_n, False))
        for what, n, jac in runs:
            a = (table, x[:n], res, meta, lat, size)
            out["permuto"].append(dict(
                shape=what, ms=cuda_ms(lambda: pm.permuto(*a, C, jac)),
                plain_ms=cuda_ms(lambda: pm.permuto_plain(*a, jac), reps=3), library_ms=None,
                # x01 and the table read, features (and jacobian) written
                bound=bound(n * d * 4 + tb + n * C * 4 * (4 if jac else 1),
                            n * L * (walk + interp + (jac_ops if jac else 0)))))
        a = sh["args"]
        out["permuto.bwd"].append(dict(
            shape=sh["what"] + ", cotangents of features and jacobian, d x01",
            ms=cuda_ms(lambda: pm.permuto_bwd(*a, d_out, d_jac)),
            plain_ms=cuda_ms(lambda: pm.permuto_bwd_plain(*a, d_out, d_jac), reps=3),
            library_ms=None,
            # x01, the table and both cotangents read; the table's and the
            # inputs' gradients written; the lattice walk and the jacobian's
            # weights (12 (d+1)), no jacobian sums; per vertex and feature the
            # table gradient's value (8 flops), G (2), then d x01 (4 d a vertex)
            bound=bound(N * d * 4 * 2 + tb * 2 + N * C * 16,
                        N * L * (walk + 12 * (d + 1) + 10 * (d + 1) * F
                                 + 4 * d * (d + 1)))))
    return out


def permuto_phase(dev, profile_it, stacked):
    """Phase 12: WAYMO_DEMO_PERMUTO (the vehicles on one permutohedral NeuS,
    K9), rendered and trained through the entry points, with its iteration
    and frame medians beside ``stacked``'s (the LoTD vehicles' multi-object
    and compose summaries of the same run) -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import WAYMO_DEMO_PERMUTO as C
    from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
    from neuralsim_torch.fields.conditional import ConditionalPermutoNeuSField
    from neuralsim_torch.fields.encodings.permuto import PermutoEncoding
    from neuralsim_torch.scene import Scene
    from neuralsim_torch.scene.observers import camera_get_all_rays
    from neuralsim_torch.tools.build import (build_compose_renderer, build_multi_trainer,
                                             converge_occ, render_multi_frame)

    cfg = copy.deepcopy(C)
    cfg["training"]["error_map"] = {**cfg["training"]["error_map"],
                                    "enable_after": MULTI_ERROR_MAP_AFTER}
    timings = {}
    t0 = time.perf_counter()
    scene_r, _, renderer, params_r = build_compose_renderer(C)
    scene, bank, trainer, state, samplers = build_multi_trainer(cfg, timings=timings)
    accel = renderer.accels["cr"]
    occ = {"cr": converge_occ(accel, accel.init_state(), ground_sdf_tensor, seed=int(C["seed"]),
                              **C["occ_converge"])}
    torch.cuda.synchronize()
    veh_id = renderer.objects[0].model_id
    enc = state.params[veh_id].encoding
    log(f"permuto: built in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()) + f"); vehicles "
        f"{type(state.params[veh_id]).__name__}, d {enc.input_dim}, {enc.n_levels} levels "
        f"of F {enc.levels[0][1]} ({enc.levels[0][0]:g}..{enc.levels[-1][0]:g}), T "
        f"{enc.table_size}, {enc.total_params} table floats")
    for f in (state.params[veh_id], params_r[veh_id]):
        e = f.encoding
        if not isinstance(f, ConditionalPermutoNeuSField) or (
                e.input_dim, e.n_levels, {nf for _, nf in e.levels}, e.table_size,
                e.out_dim) != (11, 12, {2}, 2 ** 17, 24):
            raise AssertionError("the vehicles are not one permuto field of d 11, 12 levels "
                                 "of F 2 and 2^17 rows")

    # K9 at the pixel step's final query (3 vehicles x 2,048 rows x 32
    # samples, d 11), at PermutoNeuSObj's ladder (d 3, 12 levels to 512) and
    # at d 4
    n_final, n_ladder = 3 * MULTI_RAYS // 2 * 32, 3 * MULTI_RAYS // 2 * 24
    errs, shapes = check_permuto(dev, (
        permuto_set("vehicles, pixel step", enc, n_final, 100, dev),
        permuto_set("PermutoNeuSObj ladder", PermutoEncoding(
            3, n_levels=12, base_res=4.0, max_res=512.0, log2_hashmap_size=17), n_final, 101,
            dev),
        permuto_set("d 4", PermutoEncoding(4, n_levels=12, base_res=4.0, max_res=256.0,
                                           log2_hashmap_size=17), n_final, 102, dev)))

    # the render: 4 frames, a crop against the CPU path at its street depths
    H, W = (int(v) for v in scene_r.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    vehicles = [ob.obj_id for ob in renderer.objects]
    watch = {}
    kernels.reset_counts()
    with permuto_watch(watch):
        frames = [render_multi_frame(renderer, params_r, scene_r, fi, COMPOSE_CAM, occ,
                                     RAYSCHUNK) for fi in COMPOSE_FRAME_IDS]
        torch.cuda.synchronize()
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    chunks = len(COMPOSE_FRAME_IDS) * -(-H * W // RAYSCHUNK)
    log(f"permuto render: {len(COMPOSE_FRAME_IDS)} frames of {H}x{W}, launches "
        f"{launches_render}")
    if launches_render["permuto"] <= 0 or launches_render["permuto.bwd"] or \
            launches_render["lotd_grid"] or launches_render["cross_source_vw"] != chunks:
        raise AssertionError("a permuto chunk launches K9 (never K3, no backward) and K8 once")
    check_compose_frames(frames, H, W, vehicles)
    frozen = scene_r.slice_at(COMPOSE_FRAME_IDS[0])
    o, d = camera_get_all_rays(frozen, COMPOSE_CAM, H, W)
    scene_cpu = Scene.load_from_scenario(demo_scenario(**C["dataset_cfg"]["params"]))
    crop = compose_crop(H, W)
    cut = lambda a: a.reshape(H, W, 3)[crop].reshape(-1, 3).cpu().contiguous()
    by_ray = check_compose_crop(renderer, params_r, frozen,
                                scene_cpu.slice_at(COMPOSE_FRAME_IDS[0]), cut(o), cut(d), dev,
                                occ, {"cr": type(occ["cr"])(occ["cr"].val.cpu(),
                                                            occ["cr"].mask.cpu())})

    # training: the first iteration against the CPU, the launches and K9's
    # shapes of each step type, 48 iterations, a poisoned step
    with permuto_watch(watch):
        loss_err, grad_err = check_multi_first_iteration(scene, trainer, state, samplers, dev)
    step_watch = {}
    with permuto_watch(step_watch):
        per_step = step_launches(scene, trainer, state, samplers, dev)
    for step_type, (n, _) in per_step.items():
        log(f"permuto {step_type} step: launches {n}")
    calls = sorted(set(step_watch["calls"]))
    log(f"permuto: K9 calls of one LiDAR and one pixel step (N, d, kind): {calls}")
    pix = per_step["pixel"][0]
    if pix["permuto"] <= 0 or pix["permuto.bwd"] <= 0 or pix["lotd_grid"] or \
            (n_final, 11, "fwd+jac") not in calls or (n_ladder, 11, "fwd") not in calls:
        raise AssertionError(f"the permuto pixel step should launch K9 forward at "
                             f"[{n_ladder}, 11] and [{n_final}, 11] with the jacobian, and K9's "
                             f"backward, and never K3")
    with permuto_watch(watch):
        log_, launches, falls = check_multi_training(scene, trainer, state, samplers, dev,
                                                     PERMUTO_ITERS, "permuto", permuto=True)
        check_multi_poisoned_step(scene, trainer, state, samplers, dev)
    if watch["plain_on_card"] or step_watch["plain_on_card"]:
        raise AssertionError(f"the plain permuto functions ran on the card path "
                             f"{watch['plain_on_card'] + step_watch['plain_on_card']} times")

    it_ms = time_multi_iterations(scene, trainer, state, samplers, dev)
    frame_ms = time_compose_frames(renderer, params_r, scene_r, occ)
    rays = MULTI_RAYS + MULTI_BEAMS
    for k, (med, lo, hi) in it_ms.items():
        key = "multi_iteration_ms" if k == "iteration" else f"multi_{k}_step_ms"
        log(f"timing: permuto {k} median {med:.3f} ms (min {lo:.3f}, max {hi:.3f}); LoTD "
            f"vehicles {stacked[key]:.3f} ms in this run")
    log(f"timing: permuto iteration {rays / it_ms['iteration'][0] * 1e3:.1f} rays/s (LoTD "
        f"vehicles {stacked['multi_rays_per_s']:.1f}); hand-kernel launches per iteration "
        f"{sum(launches.values()) / PERMUTO_ITERS:.1f}; K9 {launches['permuto']} and its "
        f"backward {launches['permuto.bwd']} in {PERMUTO_ITERS} iterations")
    log(f"timing: permuto frame median {frame_ms[0]:.3f} ms (min {frame_ms[1]:.3f}, max "
        f"{frame_ms[2]:.3f}); LoTD vehicles {stacked['compose_frame_ms']:.3f} ms in this run")
    times = time_permuto(shapes, n_ladder)
    for name, ts in times.items():
        for t in ts:
            log(f"kernel {name} (permuto path): {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                f"bound {t['bound'][0]:.4f} by {t['bound'][1]}) at {t['shape']}")
    summary = {"permuto_build_s": timings, "permuto_crop_by_ray": by_ray,
               "permuto_first_iteration_loss_rel_err": loss_err,
               "permuto_first_iteration_grad_rel_err": grad_err,
               "permuto_iterations": PERMUTO_ITERS,
               "permuto_loss_rgb_first10": falls["loss_rgb"][0],
               "permuto_loss_rgb_last10": falls["loss_rgb"][1],
               "permuto_lidar_depth_first10": falls["lidar/lidar_loss_depth"][0],
               "permuto_lidar_depth_last10": falls["lidar/lidar_loss_depth"][1],
               "permuto_lidar_step_ms": it_ms["lidar"][0],
               "permuto_pixel_step_ms": it_ms["pixel"][0],
               "permuto_iteration_ms": it_ms["iteration"][0],
               "permuto_iteration_ms_min": it_ms["iteration"][1],
               "permuto_iteration_ms_max": it_ms["iteration"][2],
               "permuto_rays_per_s": rays / it_ms["iteration"][0] * 1e3,
               "permuto_frame_ms": frame_ms[0], "permuto_frame_ms_min": frame_ms[1],
               "permuto_frame_ms_max": frame_ms[2],
               "permuto_lotd_iteration_ms": stacked["multi_iteration_ms"],
               "permuto_lotd_frame_ms": stacked["compose_frame_ms"],
               "permuto_hand_launches_per_iteration": sum(launches.values()) / PERMUTO_ITERS,
               "permuto_step_launches": {k: v[0] for k, v in per_step.items()},
               "permuto_k9_calls_per_steps": calls}
    if profile_it:
        prof = profile_multi_steps(scene, trainer, state, samplers, dev,
                                   named={"K9": ("permuto_",),
                                          "index_put": ("index_put", "indexing_backward")})
        for k, (n, busy, named) in prof.items():
            summary[f"permuto_{k}_step_device_kernels"] = n
            summary[f"permuto_{k}_step_busy_ms"] = busy
            summary.update({f"permuto_{k}_step_{label}_ms": v for label, v in named.items()})
    return dict(errs=errs, times=times, launches=launches, launches_render=launches_render,
                step_launches={k: v[0] for k, v in per_step.items()}, iters=PERMUTO_ITERS,
                n_frames=len(COMPOSE_FRAME_IDS), summary=summary)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import SYNTHETIC_OBJECT
    from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
    from neuralsim_torch.tools.build import build_renderer, build_trainer

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line \
                or line.startswith("=="):
            log("  " + line.strip())

    dev = torch.device("cuda")
    renderer, params = build_renderer(SYNTHETIC_OBJECT)

    # 3. kernels against their plain versions, at each path's shapes
    rmax = params["Main"].encoding.cp_rmax
    errs_render, shapes_render = check_kernels(
        dev, params, RAYSCHUNK, path_point_sets(RAYSCHUNK, rmax, uniform=False), noisy=False)
    errs, shapes = check_kernels(
        dev, params, TRAIN_RAYS, path_point_sets(TRAIN_RAYS, rmax, uniform=True), noisy=True)
    for name, (e, tol) in errs_render.items():
        errs[name] = (max(e, errs[name][0]), tol)
    errs["lotd_grid"] = (max(errs["lotd_grid"][0], check_dense_levels(dev)), 1e-5)
    errs_bwd, shapes_bwd = check_backward_kernels(dev, params)
    errs.update(errs_bwd)

    # 4. the render slice
    rig = SyntheticObjectDataset(**SYNTHETIC_OBJECT["dataset_cfg"]["params"])
    kernels.reset_counts()
    frames = render_frames(renderer, params, rig, dev)
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    log(f"render slice: {N_FRAMES} frames of {rig.H}x{rig.W}, launches {launches_render}")
    for name, n in launches_render.items():
        if n <= 0 and not name.endswith(".bwd") and \
                name not in BENCH_ONLY + COMPOSE_ONLY + CROWD_ONLY + PERLEVEL_ONLY \
                + PERMUTO_ONLY:
            raise AssertionError(f"kernel {name} never launched on the render path")
    check_frames(frames, rig.H, rig.W)
    crop_err = check_crop(frames, renderer, params, rig, rig.H, rig.W)

    # 5. the training slice
    trainer, state = build_trainer(SYNTHETIC_OBJECT)
    step_loss_err, step_grad_err = check_first_step(trainer, state, rig, dev)
    tbuf = training_buffer(trainer, state, rig, dev)
    if tbuf["t"].shape != (TRAIN_RAYS, 96) or "rays_d" not in tbuf or "rgb" not in tbuf:
        raise AssertionError("synthetic_object's training buffer should be [2048, 96] with "
                             "rgb, its alpha from K12")
    errs.update(check_neus_composite(dev, [("synthetic_object's training step",
                                            neus_args(tbuf))])[0])
    del trainer, state, tbuf
    kernels.reset_counts()
    out, rgb_first, rgb_last = train_slice(SYNTHETIC_OBJECT)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    log(f"training slice: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays, launches {launches}")
    for name, n in launches.items():
        if n <= 0 and name not in BENCH_ONLY + COMPOSE_ONLY + MULTI_ONLY + CROWD_ONLY \
                + PERLEVEL_ONLY + PERMUTO_ONLY:
            raise AssertionError(f"kernel {name} never launched on the training path")
    trainer, state = out["trainer"], out["state"]
    check_poisoned_step(trainer, state, rig, dev)

    # 6. the bench model, with its own timing
    phase_s = {"build, kernels, synthetic_object": time.perf_counter() - t0}
    t1 = time.perf_counter()
    bench = bench_phase(dev, "--profile" in argv)
    phase_s["bench"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 7. the multi-object compose render, with its own timing
    compose = compose_phase(dev, "--profile" in argv)
    phase_s["compose"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 8. multi-object training, with its own timing
    multi = multi_phase(dev, "--profile" in argv)
    phase_s["multi"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 9. the crowded scene (K11, K10), and 10. synthetic_multi, with their timing
    crowd = crowd_phase(dev, "--profile" in argv)
    synth = synthetic_multi_phase(dev)
    crowd["times"] = time_crowd_kernels(*crowd["shapes"], synth["hit"])
    phase_s["crowd and synthetic_multi"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 11. WAYMO_DEMO_MULTI on the per-level CP path (K2, K12), with its timing
    perlevel = perlevel_phase(dev, "--profile" in argv,
                              {**multi["summary"], **compose["summary"]})
    phase_s["per-level"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 12. WAYMO_DEMO_PERMUTO, the vehicles on one permuto field (K9), with its timing
    permuto = permuto_phase(dev, "--profile" in argv, {**multi["summary"], **compose["summary"]})
    phase_s["permuto"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("phases (s, host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # 13. timing
    (frame_ms, frame_min, frame_max), n_rays = time_frames(renderer, params, rig, dev)
    log(f"timing: frame median {frame_ms:.3f} ms (min {frame_min:.3f}, max "
        f"{frame_max:.3f}) for {n_rays} rays, {n_rays / frame_ms * 1e3:.1f} rays/s")
    (step_ms, step_min, step_max), _ = time_steps(trainer, state, rig, dev)
    log(f"timing: training step median {step_ms:.3f} ms (min {step_min:.3f}, max "
        f"{step_max:.3f}) for {TRAIN_RAYS} rays, {TRAIN_RAYS / step_ms * 1e3:.1f} rays/s; "
        f"hand-kernel launches per step {sum(launches.values()) / TRAIN_STEPS:.1f}")
    # K6 is checked at synthetic_object's shapes but runs on the bench path only
    times = {k: v for k, v in {**time_forward_kernels(shapes),
                               **time_backward_kernels(shapes_bwd)}.items()
             if k not in BENCH_ONLY}
    times_render = {k: v for k, v in time_forward_kernels(shapes_render).items()
                    if k not in BENCH_ONLY}
    rows = []
    for name, k in kernels.KERNELS.items():
        # a kernel of the earlier slices reports its synthetic_object training
        # path at the top level and the bench path beside it; K4 and K7 run on
        # the bench path only, K8 on the compose render only (per frame), K8's
        # backward on the multi-object training only (per iteration)
        on_compose = name in COMPOSE_ONLY
        on_multi = name in MULTI_ONLY
        on_crowd = name in CROWD_ONLY
        on_perlevel = name in PERLEVEL_ROWS
        on_permuto = name in PERMUTO_ONLY
        on_bench = name not in times and not (on_compose or on_multi or on_crowd or on_perlevel
                                              or on_permuto)
        if on_permuto:
            # K9 at the pixel step's final query (its other shapes under "permuto")
            t, n_launch, steps, path = (permuto["times"][name][0], permuto["launches"][name],
                                        permuto["iters"], "waymo_demo_permuto training")
        elif on_perlevel:
            # K2 at the street's pixel-step shape (its other shapes under
            # "perlevel"), K12 at the LiDAR step's street buffer
            t = perlevel["times"][name]
            t = t[0] if isinstance(t, list) else t
            n_launch, steps, path = (perlevel["launches"][name], perlevel["iters"],
                                     "waymo_demo_multi per-level training")
        elif on_crowd:
            # K11's training call (its render call and synthetic_multi's
            # stand under "crowd"), K10's one shape
            t = crowd["times"][name][1 if name == "pair_compact" else 0]
            n_launch, steps, path = (crowd["launches"][name], crowd["iters"],
                                     "waymo_demo_crowd training")
        elif on_multi:
            t, n_launch, steps, path = (multi["times"][name], multi["launches"][name],
                                        multi["iters"], "waymo_demo_multi training")
        elif on_compose:
            t, n_launch, steps, path = (compose["times"][name][0], compose["launches"][name],
                                        compose["n_frames"], "waymo_demo_multi render")
        elif on_bench:
            t, n_launch, steps, path = (bench["times"][name], bench["launches"][name],
                                        BENCH_STEPS, "bench model training")
        else:
            t, n_launch, steps, path = (times[name], launches[name], TRAIN_STEPS,
                                        "synthetic_object training")
        found = [e[name] for e in (errs, bench["errs"], compose["errs"], multi["errs"],
                                   crowd["errs"], perlevel["errs"], permuto["errs"]) if name in e]
        err, tol = max(e for e, _ in found), found[0][1]
        bound_ms, bound_by = t["bound"]
        # K8 runs on no training step: its per-frame count is under "compose"
        row = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": n_launch,
               "launches_per_step": None if on_compose or on_multi or on_crowd or on_perlevel
               or on_permuto else n_launch / steps,
               "max_abs_err": err, "max_err": err,
               "tol": tol, "ms": t["ms"], **card_keys(t), "plain_ms": t["plain_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": t["library_ms"], "shape": t["shape"], "path": path}
        unit = "frame" if on_compose else "iteration" if on_multi or on_crowd or on_perlevel \
            or on_permuto else "step"
        log(f"kernel {name} ({path} path, {n_launch / steps:g} launches per {unit}): "
            f"{t['ms']:.4f} ms ({card_extra(t)[2:]}{', ' if card_keys(t) else ''}plain "
            f"{t['plain_ms']:.4f}, bound {bound_ms:.4f} by {bound_by}) at {t['shape']}")
        if name in times_render:
            r = times_render[name]
            row["render"] = {"launches": launches_render[name],
                             "launches_per_frame": launches_render[name] / N_FRAMES,
                             "ms": r["ms"], **card_keys(r), "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                             "library_ms": r["library_ms"], "shape": r["shape"]}
            log(f"kernel {name} (render path, {launches_render[name] / N_FRAMES:g} launches "
                f"per frame): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                f"{r['bound'][0]:.4f} by {r['bound'][1]}) at {r['shape']}")
        row["bench"] = {"launches": bench["launches"][name],
                        "launches_per_step": bench["launches"][name] / BENCH_STEPS,
                        "render_launches_per_frame":
                            bench["launches_render"][name] / bench["n_frames"]}
        if name in bench["times"] and not on_bench:
            b = bench["times"][name]
            row["bench"].update(ms=b["ms"], **card_keys(b), plain_ms=b["plain_ms"],
                                bound_ms=b["bound"][0],
                                bound_by=b["bound"][1], library_ms=b["library_ms"],
                                shape=b["shape"])
            log(f"kernel {name} (bench model training path, "
                f"{bench['launches'][name] / BENCH_STEPS:g} launches per step): {b['ms']:.4f} ms "
                f"({card_extra(b)[2:]}{', ' if card_keys(b) else ''}plain {b['plain_ms']:.4f}, "
                f"bound {b['bound'][0]:.4f} by {b['bound'][1]}) at "
                f"{b['shape']}")
        else:
            log(f"kernel {name} (bench model): {bench['launches'][name] / BENCH_STEPS:g} launches "
                f"per step, {bench['launches_render'][name] / bench['n_frames']:g} per frame")
        row["multi"] = {"launches": multi["launches"][name],
                        "launches_per_iteration": multi["launches"][name] / multi["iters"]}
        if name in multi["times"] and not on_multi:
            c = multi["times"][name]
            row["multi"].update(ms=c["ms"], **card_keys(c), plain_ms=c["plain_ms"],
                                bound_ms=c["bound"][0],
                                bound_by=c["bound"][1], library_ms=c["library_ms"],
                                shape=c["shape"])
        if "ms" in row["multi"]:
            c = row["multi"]
            log(f"kernel {name} (multi-object training path, {c['launches_per_iteration']:g} "
                f"launches per iteration): {c['ms']:.4f} ms ({card_extra(c)[2:]}"
                f"{', ' if card_keys(c) else ''}plain {c['plain_ms']:.4f}, bound "
                f"{c['bound_ms']:.4f} by {c['bound_by']}) at {c['shape']}")
        for c in multi["kernel_times"].get(name, []):
            row["multi"].setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                 "library_ms": c["library_ms"], "shape": c["shape"]})
            log(f"kernel {name} (multi-object training path, "
                f"{row['multi']['launches_per_iteration']:g} launches per iteration): "
                f"{c['ms']:.4f} ms ({card_extra(c)[2:]}, plain {c['plain_ms']:.4f}, "
                f"bound {c['bound'][0]:.4f} by {c['bound'][1]}, library "
                f"{'none' if c['library_ms'] is None else format(c['library_ms'], '.4f')}) at "
                f"{c['shape']}")
        row["compose"] = {"launches": compose["launches"][name],
                          "launches_per_frame": compose["launches"][name] / compose["n_frames"]}
        for c in compose["times"].get(name, []):
            row["compose"].setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0],
                 "bound_by": c["bound"][1], "library_ms": c["library_ms"], "shape": c["shape"]})
            log(f"kernel {name} (compose render path, {row['compose']['launches_per_frame']:g} "
                f"launches per frame): {c['ms']:.4f} ms ({card_extra(c)[2:]}"
                f"{', ' if card_keys(c) else ''}plain {c['plain_ms']:.4f}, bound "
                f"{c['bound'][0]:.4f} by {c['bound'][1]}) at {c['shape']}")
        row["crowd"] = {"launches": crowd["launches"][name],
                        "launches_per_iteration": crowd["launches"][name] / crowd["iters"],
                        "render_launches_per_frame":
                            crowd["launches_render"][name] / crowd["n_frames"]}
        for c in crowd["times"].get(name, []):
            row["crowd"].setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0],
                 "bound_by": c["bound"][1], "library_ms": c["library_ms"], "shape": c["shape"]})
            log(f"kernel {name} (crowd path, {row['crowd']['launches_per_iteration']:g} launches "
                f"per iteration, {row['crowd']['render_launches_per_frame']:g} per frame): "
                f"{c['ms']:.4f} ms ({card_extra(c)[2:]}{', ' if card_keys(c) else ''}plain "
                f"{c['plain_ms']:.4f}, bound {c['bound'][0]:.3g} by "
                f"{c['bound'][1]}, library "
                f"{'none' if c['library_ms'] is None else format(c['library_ms'], '.4f')}) at "
                f"{c['shape']}")
        row["synthetic_multi"] = {"launches": synth["launches"][name],
                                  "launches_per_step": synth["launches"][name] / synth["steps"]}
        row["perlevel"] = {
            "launches": perlevel["launches"][name],
            "launches_per_iteration": perlevel["launches"][name] / perlevel["iters"],
            "launches_per_lidar_step": perlevel["step_launches"]["lidar"][name],
            "launches_per_pixel_step": perlevel["step_launches"]["pixel"][name],
            "render_launches_per_frame":
                perlevel["launches_render"][name] / perlevel["n_frames"]}
        for c in perlevel["times"].get(name, []) if name in PERLEVEL_ONLY else []:
            row["perlevel"].setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0],
                 "bound_by": c["bound"][1], "library_ms": c["library_ms"], "shape": c["shape"]})
        p = row["perlevel"]
        log(f"kernel {name} (per-level path: {p['launches_per_lidar_step']} launches per "
            f"LiDAR step, {p['launches_per_pixel_step']} per pixel step, "
            f"{p['render_launches_per_frame']:g} per frame)")
        for c in p.get("times", []):
            log(f"kernel {name} (per-level path): {c['ms']:.4f} ms ({card_extra(c)[2:]}"
                f"{', ' if card_keys(c) else ''}plain {c['plain_ms']:.4f}, "
                f"bound {c['bound_ms']:.4f} by {c['bound_by']}) at {c['shape']}")
        row["permuto"] = {
            "launches": permuto["launches"][name],
            "launches_per_iteration": permuto["launches"][name] / permuto["iters"],
            "launches_per_lidar_step": permuto["step_launches"]["lidar"][name],
            "launches_per_pixel_step": permuto["step_launches"]["pixel"][name],
            "render_launches_per_frame":
                permuto["launches_render"][name] / permuto["n_frames"]}
        for c in permuto["times"].get(name, []):
            row["permuto"].setdefault("times", []).append(
                {"ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
                 "bound_by": c["bound"][1], "library_ms": c["library_ms"], "shape": c["shape"]})
        q = row["permuto"]
        log(f"kernel {name} (permuto path: {q['launches_per_lidar_step']} launches per LiDAR "
            f"step, {q['launches_per_pixel_step']} per pixel step, "
            f"{q['render_launches_per_frame']:g} per frame)")
        rows.append(row)
    if "--profile" in argv:
        profile_frame(renderer, params, rig, dev)
        profile_step(trainer, state, rig, dev)

    # 14. results
    log(json.dumps({"frame_ms": frame_ms, "frame_ms_min": frame_min,
                    "frame_ms_max": frame_max, "rays_per_s": n_rays / frame_ms * 1e3,
                    "crop_max_abs_err": crop_err,
                    "train_step_ms": step_ms, "train_step_ms_min": step_min,
                    "train_step_ms_max": step_max,
                    "train_rays_per_s": TRAIN_RAYS / step_ms * 1e3,
                    "train_steps": TRAIN_STEPS, "loss_rgb_first10": rgb_first,
                    "loss_rgb_last10": rgb_last, "first_step_loss_rel_err": step_loss_err,
                    "first_step_grad_rel_err": step_grad_err, **bench["summary"],
                    **compose["summary"], **multi["summary"], **crowd["summary"],
                    **synth["summary"], **perlevel["summary"], **permuto["summary"],
                    "card": smi}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
