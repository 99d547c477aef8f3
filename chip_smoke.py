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
     path's shapes, with non-zero cotangents of every output; K4 at K4_EDGES
     and K10 at K10_EDGES (march segments 1-64, draws 1-64, the uniform
     fallback, rays past 32 occupied segments, midpoints on cdf values,
     ragged ray counts, probes outside the box, grid indices 0, G - 1 and
     clipped), each the same bits on two calls; K6 and K12, forward and
     backward, at COMPOSITE_EDGE_S x COMPOSITE_EDGE_N (1 to 1,100 samples
     across the lane groups' and chunks' edges, 0 to 600 rays; wholly masked
     rows, runs of alpha == 1 lanes, with and without payloads) and with a
     NaN lane (which stays NaN), each output the same bits on two calls; K3
     forward at K3_EDGE_ENCODINGS (F 1, 2, 3, 4 and 8, dense and hash levels
     in one meta, levels staged in shared memory, interleaved into the
     scratch, and read from the table under a plan with no copies or another
     meta's) at x01 of 0, 1, one ulp below 1, below 0 and above 1, N 1, 31,
     33 and 65,537, with and without the jacobian;
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
     versions (timed, with the render chunk's [4,096, 96], in phase 13);
     then train() for 60 steps of 2,048 rays: every loss finite,
     no step skipped, loss_rgb over the last 10 steps below the first 10,
     all eight kernels launched; one poisoned step (a NaN in the batch) is
     skipped and leaves every parameter bit-identical;
  6. bench model (BENCH_OBJECT: 12 stacked-CP levels of 8 features up to
     1,024, occupancy grid 128^3, distant field, sky): its kernels against
     their plain versions (K4 occ_ray_proposal at 8,192 and 4,096 rays on
     the converged grid, with and without noise, an empty and a full grid,
     probes that leave the box; K7 occ_ema_update at 128^3 with 1 and 4
     samples a voxel, warm-up on and off, sdf and density, and at K7_EDGES,
     its count the mask's and its fraction the plain mean bit for bit; K7's
     points (occ_voxel_points) bit-equal at K7_POINT_SHAPES; a refresh
     without the field is K7's points and K7 alone (profiler); K1 forward and
     backward at F = 96, R = 1,024 at the path's point sets; K5a, K5b, K6 and
     K6's backward at 8,192 and 4,096 rays of 16 -> 24 -> 32 samples and 64
     composited lanes of two buffers); build_trainer with the grid converged;
     the first step's losses and gradients at 8,192 rays on the card against
     the CPU path; 48 steps of 8,192 rays (three grid
     refreshes): finite losses, no skip, falling loss_rgb, a live grid, K4
     once a step, K7's points and K7 once a refresh, no plain K7 or mean of
     the mask on the card (no_plain_on_card); a poisoned step on the grid's
     cadence is skipped, changes no parameter and still refreshes the grid; 4 frames of
     128x128 through render_chunked(occ_states=...) with a crop held to the
     CPU path ray by ray: tightly at the CPU path's own sample depths and on
     the rays that both sample at equal depths, the others in the mean (see
     check_crop_by_ray);
  7. multi-object compose render (WAYMO_DEMO_MULTI at full width: 3 vehicles
     on one conditional LoTD model, the street's LoTD NeuS with its 128^3
     grid converged on the drive's ground, the distant field on the street's
     cuboid shells, the sky): K8 cross_source_vw against its plain version on
     a chunk's merged buffer [4,096, 168] and on ragged (1 to 6,144 lanes),
     tied (-0.0 beside +0.0, equal depths across sources), masked buffers,
     the same bits on two calls;
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
     [4,096, 168] and on the forward's buffers with edge alphas (the same
     bits on two calls); K5a at the stage shapes and its edges (S 2, 80,
     100; nf 1, 16, 33; no noise; every lane masked; the depths without the
     weights the same bits) and K5b; K1's
     and K3's backwards at the path's point sets and widths, K6 forward and
     backward at the LiDAR step's street buffer (2,048 x 48, no rgb; now
     K12, the NeuS alpha inside the composite, in place of K6); the
     first iteration (a LiDAR step, then a pixel step; cut to 512 beams and
     1,024 rays) on the card against the CPU path at the CPU path's sample
     depths (sample_placements), the card's own step logged beside it; 48
     iterations (error-map sampling from the 16th): finite losses, no skip,
     falling loss_rgb and LiDAR depth loss, three grid refreshes, K8 and its
     backward and K12 and its backward once an iteration, K4 twice, K7's
     points and K7 once a refresh; a poisoned pixel step skipped with every
     parameter unchanged; the street's refresh (128^3 x 4 samples): K7's
     points bit-equal in its box, K7's points and K7 alone without the field,
     and timed (time_refresh: host and busy ms, the field query alone, peak
     MiB);
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
     the shapes of K1 bwd, K3 bwd, K5a, K5b, K13 and K14 launches in one
     LiDAR and one pixel step; K13 (the latent lookup) against its plain
     version at that step's own calls, with their indices (the vehicles'
     runs of compacted rows, the eikonal's instance 0), and on edge cases
     (indices outside [0, n), no index, int32 and int64 indices a point and
     a ray, n 1, 8, 48 and 64, z 5, 8 and 12, a cotangent slice that is not
     16-byte aligned, n 64 at z 256, one point): the forward exact, the
     backward within GRAD_REL at a column-slice cotangent and with the same
     bits on two calls, one kernel a call at the step's calls (by the
     profiler); K14 (the
     stacked CP lines) at the street's, the vehicles', the bench ladder's,
     synthetic_object's and three edge ladders (CP_LINES_EDGES): the forward's
     float32 and bf16 lines bit-equal to the plain lines and to their cast,
     one launch a call, the backward within GRAD_REL at a cotangent in K1
     bwd's layout, the same bits twice; in every counted render and training
     run of every phase (no_plain_on_card): no plain K13 or K14 and no cast
     to bf16 on the card (a TorchDispatchMode counter), and in every render
     K14 on its first frame only (the encodings' lines cache);
  9. crowded multi-object scenes (WAYMO_DEMO_CROWD at full width: 8
     vehicles on one shared model with per-instance 32^3 occupancy grids, so
     the group takes the pair-budget path): the render from converged grids
     (the street's on the ground, the vehicles' on the model's own SDF): K8
     at the render chunk's merged buffer [4,096, 328], K10
     occ_ray_proposal_batched against its plain version at the group's rows
     (converged and random per-instance grids, noise, probes outside the
     box, grid indices outside [0, G), keyframes of times), K7 at the
     batched update's 262,144 voxels with its count, its points in the
     model's box; 4 frames of 80x120 with K11, K10, K8
     and K4 launched once a chunk, the frames checked as in phase 7 and a
     crop held to the CPU path ray by ray at the CPU path's sample depths
     (the street's and the vehicle grids' proposals); the refresh of the
     vehicle grids timed. Then training (build_multi_trainer): K8 at the
     pixel step's merged buffer [4,096, 200] (4 slot lanes of 32 for the
     group), K11 integer-equal to its plain version on the path's render and
     training calls and on ragged, tied, crossing, long and many-instance
     masks (K 17 and 4,096), one launch a call; the first
     iteration card vs CPU at the CPU path's sample depths; 48 iterations
     (finite, no skip, falling loss_rgb and LiDAR depth, both grids refreshed
     three times, K11, K10 and K8 with its backward once a pixel step); a
     poisoned pixel step; a frame of the trained state; K13 at the crowd
     step's own calls (the group's round-robin rows);
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
     level): K9 forward (with and without the jacobian; its entries that
     are not bit-equal counted) and backward (each cotangent; the table's
     and the inputs' gradients, the latter the same bits on two calls)
     against their plain versions at the pixel step's final query
     [196,608, 11] on uniform points and on depth-sorted ray samples, at
     PermutoNeuSObj's ladder (d 3, to 512), at d 4 and at d 7; 4 frames of 80x120
     (K9 forward, never K3) with a crop held to the CPU path at its street
     depths; the first iteration card vs CPU at the CPU path's sample depths
     (the permuto table and the latents among the leaves); one LiDAR and one
     pixel step counted apart, with K9's shapes; 48 iterations (finite, no
     skip, falling loss_rgb and LiDAR depth) and a poisoned step; no call of
     the plain permuto functions on the card path; the permuto iteration and
     frame medians beside those of the LoTD vehicles (phases 7 and 8);
 13. checkpoints and the evaluation tools (WAYMO_DEMO_MULTI, stacked CP):
     tools.train_multi.main_function for 48 iterations on the schedule
     rescaled to them into a temporary exp dir (finite, no skip, the
     multi-object kernels launched); its final checkpoint loaded into a
     fresh build whose frame 0 was rendered before the load (so K14's lines
     cache and K3's scratch hold the fresh tables): every tensor of the
     loaded state (parameters, buffers, Adam moments and counts, it, skips,
     the grid's values, mask and fraction) and frame 0 after the load the
     trained state's bits; K8 and K5b at one 8,192-ray chunk of that frame
     against their plain versions; eval_multi (frames 0, 3, 6 at 8,192 rays
     a chunk) and eval_lidar (frames 0, 3, 6) from the exp dir, their means
     and seconds, each path's kernels launched (K14 once an encoding, no K8
     in the LiDAR query), no plain K7/K13/K14 and no bf16 cast on the card;
     frame 0's scores (every 4th pixel) and its LiDAR scores on the card
     against the CPU path loaded from the same checkpoint, at the CPU
     path's sample depths (EVAL_* limits);
 14. StreetSurf's single street (WAYMO_STREETSURF: configs/waymo_streetsurf.yaml
     at full width on the demo drive, through tools.build.build_everything
     with the 500-step road pretrain, each part of the build timed, and the
     single-scene Trainer): the first iteration (a LiDAR step, then a
     pixel step; cut to 512 beams and 1,024 rays) on the card against the
     CPU path at the CPU path's sample depths under the multi-object limits;
     one LiDAR step (K12, no K3-4D, no K6) and one pixel step (K6, K3-4D and
     its backward once each) counted apart; K3 in four dimensions
     (lotd_grid4: the distant field's dense level of 17^4 rows and 9 hash
     levels of 2^17, F 2, no level staged) and its backward against their
     plain versions at the 524,288 distant samples that one pixel step of
     8,192 rays hands the distant encoding, with that step's cotangent
     (captured), and at as many k3_4d_points (each with the field's table
     and a N(0, 1) one), at 1 to 4,097 edge points (0, 1, one ulp below 1,
     below 0 and above 1 in all four coordinates) and ray-ordered ones, and
     on 4-D ladders of F 4 (staged; no copies) and F 1: the forward
     bit-equal, the table gradient within GRAD_REL; 48 iterations of 8,192
     beams and 8,192 rays (finite, no skip, falling loss_rgb and LiDAR depth
     loss, the latter over every frame's fixed beams from the 10th
     iteration to the 48th, three grid refreshes, error-map sampling from
     the 16th); a poisoned pixel
     step; the iteration median; a validation frame (tools.train.validate),
     a whole 80x120 frame timed and a crop held to the CPU path at its
     sample depths (STREET_CROP_*); K3-4D timed on both point sets (the
     step's own as the headline);
 15. the Waymo layout on disk (``disk_phase``): the demo drive written by
     the port's writer to a temporary directory and read back by the
     Waymo-layout reader (scenario, masks and LiDAR the in-memory drive's
     exactly, each frame within DISK_JPEG_MEAN / DISK_JPEG_MAX of it; Pillow's
     version printed), then both driving YAMLs as written from the command
     line on it, DISK_ITERS iterations at full width:
     configs/waymo_demo_multi.yaml through tools.train_multi.main, then
     eval_multi, eval_lidar, render replay (one frame) and topdown (two
     frames and their video) through their main(argv) from its exp dir;
     configs/waymo_streetsurf.yaml through tools.train.main, then eval and
     eval_lidar's single-scene branch; each tool's launches counted (its
     path's kernels launched), no plain K7/K13/K14 and no bf16 cast on the
     card, no skip, finite losses and scores, the seconds and the iteration
     medians;
 16. EmerNeRF (``emernerf_phase``): configs/waymo_emernerf.yaml as written at
     full width on the drive phase 15 wrote (the static LoTD of 4 dense and
     8 hash levels of 2^18, the dynamic permuto lattice of 12 levels of 2^17
     over (xyz, t), the flow head, the sky; 8,192 rays of 96 stratified
     samples a step): the first step card vs CPU at MULTI_CHECK_RAYS rays
     under the multi-object limits; one pixel step's own inputs and
     cotangents captured, and against them K3 (the static samples,
     [786,432, 3], no jacobian) and its backward, K9 at d 4 (the rendered
     samples, the flow loss's points and the points the flow moved) and its
     backward into the table and, at the moved points, into x01 (the same
     bits twice), K6 and its backward at [8,192, 96], each timed queued
     beside its plain version and bound; 48 iterations (finite losses, the
     flow and dynamic sparsity among them, no skip, EMER_STEP_LAUNCHES a
     step and nothing else, no plain K3/K6/K9/K7/K13/K14 on the card) with
     the rgb loss over every pixel of three fixed frames (the same draws)
     lower after the 48th iteration than after the 10th, the iteration
     median; then the YAML from the command line: tools.train.main for
     DISK_ITERS iterations, eval.main (frames 0, 3, 6) and render.main
     (replay of frame 0: rgb, depth and the seven decomposition channels),
     each tool's K3, K9 and K6 launched, the final checkpoint restored into
     a fresh build bit for bit;
 17. pose refinement (``pose_phase``): the same YAML at full width plus a
     Pose asset (POSE_ARGV: LearnableParams refining the ego car and the
     camera, the camera's intrinsics and timestamp; the gate at
     POSE_ENABLE_AFTER), on the same drive: the first step card vs CPU at
     MULTI_CHECK_RAYS rays with seeded non-zero deltas, frame slicing and
     timestamp mode, every gradient leaf the deltas' included under the
     multi-object limits; one pixel step's own inputs captured, and against
     them K3's backward to the positions (lotd_grid.bwd_x, [786,432, 3],
     also at K3's edges and the step's table at its cell faces, the same
     bits twice), K9's backward with d x01 at [786,432, 4] and K6's with d t,
     each timed; 48 iterations from zero deltas: exactly zero through
     iteration 9, moved and finite after, falling held rgb loss, no skip,
     POSE_STEP_LAUNCHES a step; then tools.train.main with POSE_ARGV for
     DISK_ITERS iterations, its checkpoint into a fresh build bit for bit,
     and one iteration in timestamp mode;
 18. simulation (``simulation_phase``): the sensor-simulation and editing
     tools through their main(argv) on phase 15's exp dirs (both YAMLs at
     full width): render lidar (a pandar64, 64 x 1,800 beams, on two frames,
     a solid-state raster on one, the recorded beams on every frame; each
     frame's npz finite, points.ply non-empty) on both, one pandar64 frame
     timed (beams/s) and its launches counted, and MULTI_CHECK_RAYS of its
     beams held to the CPU path at its sample depths; nvs (street_view,
     small_circle; 8 frames at downscale 1, each timed, finite); replay with
     reverse_ego and with a file moving the ego and a vehicle, each more than
     SIM_GREY grey levels from the plain replay somewhere; replay with the
     StreetSurf street's mesh overlaid; manipulate rotate, translate, delete,
     thanos, each finite and not the unedited frame; extract_mesh at 128
     (non-empty; the host's marching timed), the street's SDF at 256^3 in
     chunks of 65,536 timed with 65,536 of its points held to the CPU path;
     extract_occgrid, extract_visible_grid (camera, lidar_gt),
     visualize_slice and a run chain of two tasks, each writing its files;
     every tool's launches counted, no plain K7/K13/K14 or bf16 cast on the
     card;
 19. timing: frame latency and rays/s; training step time and rays/s; each
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
     torch.sort) at the iteration's shapes; K1 bwd, K2 bwd, K3, K3 bwd, K4,
     K5a, K5b, K6, K10, K11, K12 and K13 also queued (the card held busy while the
     host enqueues the calls) and by the profiler (card_ms); the
     same for the crowd (frame, iteration), and the synthetic_multi step; K11 at its three
     calls beside a stable torch.argsort of its keys, K10 at the group's
     rows, K7 and its points at the batched update (K7 and its points also
     at the bench model's, the street's and the crowd's shapes, queued and
     by the profiler); K2 at each of its shapes, K12 at the
     LiDAR step's street buffer; K9 forward and backward at each of its
     shapes; K13 and its backward at the main path's and the crowd's largest
     calls (and the eikonal's) beside index_select, index_add_ into zeros,
     F.embedding's backward and the sort-based index_put; K14 and its
     backward at each encoding and at the edge ladders of CP_LINES_EDGES
     (library none; the per-level F.interpolate sum as an aside);
 20. one JSON line of results, one of per-kernel results (with each
     kernel's launches on a simulated LiDAR frame and an SDF grid), then the
     device line, last.

--profile adds torch.profiler tables of device time by kernel for one frame
and for one training step of each model, for one compose frame, and for one
LiDAR and one pixel step of the multi-object (with K1 bwd's, K3 bwd's, K4's,
K5a's, K5b's, K14's and K14 bwd's device time), the crowd, the per-level (with K2's,
K2 bwd's and K3 bwd's) and the permuto training (with K9's), each with K13's,
K13 bwd's and what is left of the library's index_put, and one EmerNeRF pixel
step without and one with pose refinement (the lift's forward and backward
split from the rest of what the pose model adds).
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
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
BENCH_ONLY = ("occ_ray_proposal", "occ_ema_update", "occ_voxel_points", "volume_composite",
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
# K4's and K10's edges (k4_edge_inputs), each held at K4_TOL and to the same
# bits on two calls: (label, rays, march segments M, draws n, the grid's
# occupied share, noise, probes outside the box). M 1-64 (the kernel's
# range), n 1-64 (draws past a ray's lanes take a second pass), 8,192 rays
# (16 lanes a ray) and fewer (32), a grid with nothing occupied (the
# uniform fallback), one so full that rays pass 32 occupied segments (an
# empty segment's 1e-6 is then lost in f32 and the cdf has steps of 0), the
# midpoints without noise on a full grid (draws land exactly on cdf
# values), rays not a multiple of a block's 16
K4_EDGES = (("M 1", 4096, 1, 16, 0.3, True, False),
            ("M 2", 4096, 2, 16, 0.3, True, False),
            ("M 33", 4096, 33, 16, 0.3, True, False),
            ("M 48", 8192, 48, 16, 0.3, True, False),
            ("M 64", 4096, 64, 32, 0.3, True, False),
            ("n 1", 4096, 64, 1, 0.3, True, False),
            ("n 16", 4096, 64, 16, 0.3, True, False),
            ("n 33", 2048, 64, 33, 0.3, True, False),
            ("n 64", 2048, 64, 64, 0.3, True, False),
            ("no occupied probe", 4096, 64, 32, 0.0, True, False),
            ("33+ occupied segments", 4096, 64, 32, 0.85, True, False),
            ("33+ occupied segments, midpoints", 4096, 64, 32, 0.85, False, False),
            ("full grid, midpoints on cdf values", 4096, 64, 32, 1.0, False, False),
            ("midpoints M 48 n 16", 8192, 48, 16, 0.3, False, False),
            ("4,099 rays", 4099, 64, 32, 0.3, True, False),
            ("probes outside the box", 4096, 64, 32, 0.3, True, True))
# K10's edges on [G, R, R, R] = [8, 32^3] grids of other occupied shares:
# (label, each ray's grid index: 0, G - 1, or drawn in [-3, G + 3) and
# clipped), each with and without noise
K10_EDGES = ("lead 0", "lead G - 1", "lead clipped")
K7_ATOL = 1e-6
# K7's points (occ_voxel_points) at each path's jitter [L, R, R, R, 3], with
# the lead the grid asks for (None, each point's instance "index", or its
# keyframe's "time"): the street's 128^3 x 4 samples (waymo_demo_multi), the
# bench model's 128^3 x 1, the crowd's 8 instance grids of 32^3, a dynamic
# grid's 2 keyframes of 32^3, and R 1, 3 and 48 (3 and 48 no power of two:
# there the card's plain version multiplies by fl(1 / R), the CPU's
# divides); held bit-equal, each also from a jitter 4 bytes off 16-byte
# alignment (the kernel's scalar path)
K7_POINT_SHAPES = (("street", 4, 128, None), ("bench", 1, 128, None),
                   ("crowd", 8, 32, "index"), ("dynamic", 2, 32, "time"), ("R 1", 3, 1, None),
                   ("R 3", 3, 3, "time"), ("R 48", 1, 48, "index"))
# K7 at (V, S) edges: V past a multiple of 4, one voxel, S 2 and 3 (not
# unrolled), each also on values 4 bytes off 16-byte alignment
K7_EDGES = ((4099, 3), (1, 1), (1027, 2), (4096, 4))
# the grids whose refresh a fresh process profiles (label, kind, leading
# entries, resolution): the street's 128^3 x 4 samples, the bench model's
# 128^3 x 1, the crowd's 8 instance grids of 32^3, a dynamic grid's 2
# keyframes of 16^3; REFRESH_PROFILED_REPS refreshes a profiler session
REFRESH_PROFILED = (("street", "single", 4, 128), ("bench", "single", 1, 128),
                    ("crowd", "batched", 8, 32), ("dynamic", "dynamic", 2, 16))
REFRESH_PROFILED_REPS = 5
# the aten ops a refresh without the field may run: allocations and views
REFRESH_ALLOC_OPS = ("aten.empty", "aten.empty_like", "aten.view", "aten._unsafe_view",
                     "aten._reshape_alias", "aten.reshape", "aten.alias")
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
# K13 runs on the multi-object paths only (any conditional field); its row
# and K14's (every stacked encoding) report the multi-object training
LATENT_ONLY = ("latent_take", "latent_take.bwd")
LINES_KERNELS = ("lotd_cp_lines", "lotd_cp_lines.bwd")
# 48 iterations (three grid refreshes); the error map's importance sampling
# from the 16th pixel step on (the config's 200 cut so that it runs)
MULTI_ITERS = 48
# kernels whose launches a multi-object step records by shape, and the
# profiler's device-time split of a step by kernel name
MULTI_WATCHED = ("lotd_grid.bwd", "lotd_cp_stacked.bwd", "neus_upsample.weights_pdf",
                 "neus_upsample.merge", "latent_take", "latent_take.bwd", "lotd_cp_lines",
                 "lotd_cp_lines.bwd")
# K13's device time in a step, and what is left of the library's index_put
# (the latents' backward before K13)
LATENT_PROFILED = {"K13": ("latent_take_kernel",),
                   "K13 bwd": ("latent_take_bwd", "latent_take_flush"),
                   "index_put": ("index_put", "indexing_backward")}
MULTI_PROFILED = {"K3 bwd": ("grid_bwd",), "K5b": ("merge_kernel",),
                  "K1 bwd": ("cp_stacked_bwd",), "K5a": ("weights_pdf",),
                  "K8": ("cross_source_vw_kernel", "cross_source_vw_block_kernel"),
                  "K8 bwd": ("cross_source_vw_bwd",),
                  "K14": ("cp_lines_kernel",), "K14 bwd": ("cp_lines_bwd",),
                  "K4": ("occ_ray_proposal_kernel",), **LATENT_PROFILED}
# the per-level steps' device-time split by kernel name
PERLEVEL_PROFILED = {"K2 bwd": ("cp_level_bwd",), "K2": ("cp_level_kernel",),
                     "K3 bwd": ("grid_bwd",), **LATENT_PROFILED}
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
# K6 and K12 at the edges of their lane groups and chunks (a ray takes 8,
# 16 or 32 lanes, a chunk 4 samples a lane): widths of 1, 7, a group and one
# past it, a chunk and one past it, 300 and 1,100 (several chunks); 0, 1
# and 3 rays (32 lanes a ray: fewer rays than the card has SMs) and 600
# (8 or 16 lanes where the width allows); each with a wholly masked row and
# runs of alpha == 1 lanes, K6 with and without rgb and nablas, K12 with and
# without rgb
COMPOSITE_EDGE_S = (1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 300, 1100)
# K12's inv_s there: a sigmoid about as wide as those widths' sample spacing,
# so that each ray has lanes off its flat tails (a gradient through a tail is
# the last bits of 1 - P, which torch's sigmoid and the kernel's expf and
# divide round apart: the earlier kernel and this one differ alike from the
# plain version on such a ray)
COMPOSITE_EDGE_INV_S = 20.0
COMPOSITE_EDGE_N = (0, 1, 3, 600)
# a NaN lane (masked in) at these (rays, width): the ray's outputs stay NaN
COMPOSITE_NAN_SHAPES = ((3, 7), (3, 33), (600, 65), (3, 300))
# WAYMO_DEMO_PERMUTO: the vehicles on one permutohedral NeuS (d = 11: xyz and
# a latent of 8 in the lattice; 12 levels of F 2, 2^17 rows a level). K9 runs
# on this path only. Rendered and trained under the multi-object limits.
PERMUTO_ONLY = ("permuto", "permuto.bwd")
PERMUTO_ITERS = 48
# checkpoints and the evaluation tools (WAYMO_DEMO_MULTI, stacked CP):
# tools.train_multi.main_function for CKPT_ITERS iterations on the schedule
# rescaled to them (configs.at_num_iters) into a temporary exp dir; its final
# checkpoint loaded into a fresh build, every tensor and the first frame the
# same bits; eval_multi (EVAL_FRAMES, EVAL_CHUNK rays a chunk) and eval_lidar
# (EVAL_FRAMES) from the exp dir, each launching EVAL_FRAME_KERNELS or
# EVAL_LIDAR_KERNELS; K8 and K5b at one EVAL_CHUNK chunk against their plain
# versions; and one frame's scores (every EVAL_CPU_DOWNSCALE-th pixel,
# EVAL_CPU_CHUNK rays a chunk) and its LiDAR scores on the card against the
# CPU path from the same checkpoint, at the CPU path's sample depths
# (sample_placements: every grid proposal and upsample stage replayed). The
# rays are lifted on each device, so positions differ in their last bits and
# the bf16 tents step the field on some rays (as in the first-iteration
# check): PSNRs within EVAL_PSNR_TOL dB, SSIM within EVAL_SSIM_TOL, each
# source's visibility mass and ground shares within EVAL_MASS_TOL, mask BCE,
# mean depths, LiDAR errors and chamfer distances within EVAL_REL_TOL
# relative, mask accuracy, dominant pixels and LiDAR hits within
# EVAL_PIXELS_TOL pixels or beams (measured on the H100: PSNRs 1.2e-6 dB,
# SSIM 1.5e-8, masses 1.3e-7, relative 3.3e-7, no pixel or beam; the limits
# leave room for a ray whose position rounds apart and steps the field)
CKPT_ITERS = 48
EVAL_FRAMES = [0, 3, 6]
EVAL_CHUNK = 8192
EVAL_CPU_DOWNSCALE, EVAL_CPU_CHUNK = 4, 1024
EVAL_PSNR_TOL, EVAL_SSIM_TOL, EVAL_MASS_TOL, EVAL_REL_TOL, EVAL_PIXELS_TOL = \
    1e-3, 1e-5, 1e-5, 1e-3, 2
EVAL_FRAME_KERNELS = ("lotd_cp_stacked", "lotd_grid", "occ_ray_proposal",
                      "neus_upsample.weights_pdf", "neus_upsample.merge", "cross_source_vw",
                      "latent_take", "lotd_cp_lines")
EVAL_LIDAR_KERNELS = ("neus_composite", "lotd_cp_stacked", "occ_ray_proposal",
                      "neus_upsample.weights_pdf", "neus_upsample.merge", "lotd_cp_lines")
CKPT_TRAIN_KERNELS = ("cross_source_vw", "cross_source_vw.bwd", "neus_composite",
                      "neus_composite.bwd", "occ_voxel_points", "occ_ema_update")
# K14 in a whole evaluation: once for each stacked encoding (the street's and
# the vehicles'), its lines kept while the tables do not change
EVAL_K14_LAUNCHES = 2
# K9 against its plain version: the lattice rounds like the plain version
# operation by operation (explicit _rn), so both pick the same simplex, rows
# and weights, and sum the interpolation in the same order
K9_TOL = dict(rtol=1e-5, atol=1e-6)
# K9's backward: the table's gradient within GRAD_REL of its largest entry
# (float32 atomics in another order than autograd's scatter); the inputs'
# gradient, one thread a point summing its levels, within K9_DX_REL of its
# largest entry (autograd sums the same terms through the elevation chain)
K9_DX_REL = 1e-5

# StreetSurf's single-street path (WAYMO_STREETSURF: configs/waymo_streetsurf.yaml
# at full width on the demo drive, through tools.build.build_everything and
# the single-scene Trainer): each loop iteration a LiDAR step of 8,192
# beams (the street alone, K12) and a pixel step of 8,192 rays (the street
# and the 4-D LoTD distant field composited together, K6). K3 in four
# dimensions (``lotd_grid4``) runs on this path only: the distant field's
# dense level of 17^4 rows and 9 hash levels of 2^17, F 2, on the pixel
# step's 8,192 x 64 distant samples (the JAX tool reads the distant ladder
# from the renderer block, 64 by default, not from the distant asset's
# query_cfg). Its first iteration is held to the CPU path at
# MULTI_CHECK_RAYS rays and MULTI_CHECK_BEAMS beams under the multi-object
# limits; 48 iterations with the error map's importance sampling from the
# 16th pixel step on (the config's 500 cut so that it runs).
STREETSURF_ONLY = ("lotd_grid4", "lotd_grid4.bwd")
# K3's backward to the positions runs on the pose-refinement path alone
POSE_ONLY = ("lotd_grid.bwd_x",)
STREETSURF_RAYS = STREETSURF_BEAMS = 8192
STREETSURF_ITERS = 48
# the fixed draw of beams on which the LiDAR depth loss is held to fall
# (lidar_depth_over_frames), from the state after the first
# STREETSURF_DEPTH_EARLY iterations to the state after the last: the first
# steps of Adam move the road pretrain's geometry (on the H100 the loss went
# from 0.037 before training to 0.126-0.130 after 10 iterations, then fell
# to 0.116 by the 48th), and the check, like the training log's first and
# last 10 iterations, is of the fall after them
STREETSURF_DEPTH_SEED = 23
STREETSURF_DEPTH_EARLY = 10
# K3-4D's edge point sets: (label, points); the distant field's own table
# and a table of N(0, 1) values of its size
K3_4D_EDGE_N = (1, 31, 625, 4097)
# the half extents (m) of k3_4d_ray_points' box: the street box that
# build_everything makes from the demo drive's camera tracks (120 m a side)
K3_4D_RAY_BOX = (60.0, 60.0, 60.0)
# a crop of frame 0 (rows, columns of camera_FRONT's 80x120), rendered on the
# CPU and on the card at the CPU path's sample depths (sample_placements):
# each ray's rgb and mask within STREET_CROP_TOL, and its weighted depth (the
# mean depth times the mask, the sum of weight x depth) within STREET_CROP_TOL
# of 1 + its largest sample depth, on all but STREET_CROP_OFF_MAX of the
# rays (a ray whose position rounds apart can step the bf16 tents, see
# EQUAL_DEPTH_TOL). The mean depth alone is not held: on a ray into the sky
# the distant field's weights are ~1e-6 each, 1 - exp(-tau) of taus of
# ~1e-5, whose last bits (exp rounds an ulp apart on the card) are a tenth of
# a percent of them, and the ladder reaches 1e4 times the close range's far
# plane (measured on the H100: rgb 7.7e-7, mask 1.8e-6, the mean depth
# 8.9e-5 of 1 + the largest depth, 0.09% of the distant share's depth on a
# ray of mask 0.002)
STREET_CROP = (slice(32, 48), slice(40, 72))
STREET_CROP_TOL = EQUAL_DEPTH_TOL
STREET_CROP_OFF_MAX = 0.02


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


def prof_ms(fn, reps: int = 20):
    """The device time of fn()'s kernels (memsets included) a call, under
    torch.profiler, after one warm-up; a session that records no kernel is
    run again, and None stands where a second one records none either."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if us:
            return sum(us) / 1e3 / reps
    return None


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


def extra_keys(t) -> dict:
    """A timing's other keys for the kernels line, where it has them: each
    library call's times, K14's per-level F.interpolate aside, and K7's and
    its points' other paths' shapes."""
    return {k: t[k] for k in ("library_calls", "interpolate_ms", "interpolate_max_abs_err",
                              "at_shapes", "random_points") if k in t}


def card_extra(t) -> str:
    """``queued_ms`` and ``prof_ms`` of a timing, where it has them, for a log line."""
    return "".join(f", {k.split('_')[0]} {t[k]:.4f}" for k in ("queued_ms", "prof_ms")
                   if t.get(k) is not None)


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


def k5a_bound(n, S, nf, noisy):
    """K5a's least time: t, sdf, mask, near, far and the draws read, the
    weights and the new depths written; each sample's alpha once (~32
    operations) with its transmittance and cdf steps (~6), and a binary
    search over the S + 1 cdf edges and the bin's lerp a draw."""
    return bound(n * S * 9 + n * 8 + (n if noisy else 1) * nf * 4 + n * S * 4 + n * nf * 4,
                 n * S * 38 + n * nf * (2 * math.ceil(math.log2(S + 1)) + 10))


def k8_bound(N, L, bytes_a_lane):
    """K8's least time (forward or backward) at ``bytes_a_lane`` of traffic:
    a sort's compares a lane (log2 L), the scan, the log and the exp."""
    return bound(N * L * bytes_a_lane, N * L * (math.ceil(math.log2(max(L, 2))) + 4))


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
    shapes["lotd_grid"] = dict(args=a3, C=C, plan=enc.grid_fwd_plan)

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


# K3 forward's edge encodings (label, levels, log2 hashmap size): levels of
# F 1, 2, 3, 4 and 8, dense and hash levels in one meta; levels staged in
# shared memory (past 48 KB in the second), a hash level past the staging
# budget and a dense level too large for it (R 40: 1.1 MB) interleaved into
# the scratch, small hash tables staged
K3_EDGE_ENCODINGS = (
    ("dense F 1, 2, 8, 3 staged; hash F 4, dense R 40 interleaved",
     ((8, 1, "dense"), (13, 2, "dense"), (6, 8, "dense"), (16, 4, "hash"), (5, 3, "dense"),
      (40, 4, "dense")), 12),
    ("hash F 8 interleaved; hash F 1, 2 staged (96 KB); dense F 4 past the budget",
     ((20, 8, "hash"), (30, 1, "hash"), (50, 2, "hash"), (9, 4, "dense")), 13))
K3_EDGE_N = (1, 31, 33, 65_537)
K3_EDGE_COUNT = len(K3_EDGE_ENCODINGS) * len(K3_EDGE_N) + 2


def k3_edge_points(n, seed):
    """K3's edge positions first (every combination over the axes of 0, 1,
    one ulp below 1, -0.25 and 1.5), then uniform ones in [-0.1, 1.1]."""
    import itertools
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (max(n, 125), 3)).astype(np.float32)
    edges = np.array([0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)), -0.25, 1.5],
                     dtype=np.float32)
    x[:125] = np.array(list(itertools.product(edges, repeat=3)), dtype=np.float32)
    return x[:n]


def k3_edge_inputs(dev):
    """K3 forward's edge encodings [(label, table, meta, C)], each of
    K3_EDGE_ENCODINGS with a table of N(0, 1) values."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    out = []
    for i, (label, levels, log2) in enumerate(K3_EDGE_ENCODINGS):
        e = lotd.LoTDEncoding(levels, log2_hashmap_size=log2)
        out.append((label, torch.from_numpy(np.random.default_rng(400 + i).normal(
            size=e.total_params).astype(np.float32)).to(dev), e._grid_meta.to(dev), e.out_dim))
    return out


def k3_edge_cases(dev, with_plans=True):
    """K3 forward's edge cases [(label, table, points, meta, C, plan)]: each
    encoding of k3_edge_inputs at each of K3_EDGE_N points (plan None: the
    one the wrapper derives); then, ``with_plans``, at 65,537 points the
    first with the second's plan (another meta's: levels staged,
    interleaved and one read from the table) and the second with no copies
    (every level read from the table)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    encs, cases = k3_edge_inputs(dev), []
    for label, table, meta, C in encs:
        for n in K3_EDGE_N:
            cases.append((f"{label}, N={n}", table, torch.from_numpy(
                k3_edge_points(n, 410 + n)).to(dev), meta, C, None))
    if not with_plans:
        return cases
    x = torch.from_numpy(k3_edge_points(65_537, 420)).to(dev)
    (la, ta, ma, ca), (lb, tb, mb, cb) = encs
    cases.append((f"{la}, N=65537, the second encoding's plan", ta, x, ma, ca,
                  lotd.grid_fwd_plan(mb.tolist())))
    cases.append((f"{lb}, N=65537, no copies (each level from the table)", tb, x, mb, cb,
                  lotd.GridFwdPlan(0, 0, 0)))
    assert len(cases) == K3_EDGE_COUNT
    return cases


def check_k3_edges(dev):
    """K3 forward at k3_edge_cases, with and without the jacobian, within
    1e-5 of its plain version; the entries that are not bit-equal are
    counted in the log -> max abs err."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    errs, unequal = [], 0
    for label, table, x, meta, C, plan in k3_edge_cases(dev):
        fn = lotd.lotd_grid if plan is None else \
            (lambda *a, plan=plan: lotd.lotd_grid(*a, plan=plan))
        for jac in (False, True):
            got = encode_into(fn, (table, x, meta), C, x.shape[0], dev, jac)
            want = encode_into(lotd.lotd_grid_plain, (table, x, meta), C, x.shape[0], dev, jac)
            errs.append(compare(f"K3 edge {label} jac={jac}", got, want, 1e-5, 1e-5))
            unequal += sum(int((g != w).sum()) for g, w in zip(got, want) if w is not None)
    log(f"K3 edges: {len(errs)} calls, {unequal} entries not bit-equal to the plain version")
    return max(errs)


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
        if w.numel() == 0:  # no ray: the shapes agree
            if g.shape != w.shape:
                raise AssertionError(f"{name}: shape {tuple(g.shape)}, not {tuple(w.shape)}")
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite gradient")
        e, scale = float((g - w).abs().max()), float(w.abs().max())
        if e > rel * scale:
            raise AssertionError(f"{name}: max_abs_err {e:.3g} exceeds {rel:g} x {scale:.3g}")
        err = max(err, e)
    log(f"check {name}: max_abs_err {err:.3g} (tol {rel:g} x max |plain gradient|)")
    return err


def compare_f64(name, got, plain, exact, rel=GRAD_REL):
    """The yardstick of scripts/torch_composite_conditioning.py, for
    gradients whose float32 plain version is itself ill-conditioned (sums
    that cancel to a few ulps of their terms): each output of the kernel no
    further from the plain version run in float64 (``exact``) than the
    float32 plain version is, plus ``rel`` times the float64 output's largest
    entry; raises otherwise. -> the largest kernel-vs-float32-plain error."""
    err = 0.0
    for i, (g, p, w) in enumerate(zip(got, plain, exact)):
        if w is None:
            continue
        if not torch_isfinite(g):
            raise AssertionError(f"{name}: non-finite gradient")
        scale = float(w.abs().max()) or 1.0
        ek, ep = float((g.double() - w).abs().max()), float((p.double() - w).abs().max())
        log(f"check {name} output {i}: from float64 kernel {ek / scale:.3g}, float32 plain "
            f"{ep / scale:.3g} of its largest entry {scale:.3g} (tol plain + {rel:g})")
        if not ek <= ep + rel * scale:
            raise AssertionError(f"{name} output {i}: the kernel lies further from float64 "
                                 f"({ek:.3g}) than the float32 plain version ({ep:.3g}) plus "
                                 f"{rel:g} x {scale:.3g}")
        err = max(err, float((g - p).abs().max()))
    return err


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


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


def frames_guarded(label, frame_ids, render_one):
    """``render_one(fi)`` for each frame under no_plain_on_card, counting
    K14's launches a frame: no parameter changes while a render runs, so the
    encodings' lines cache leaves K14 nothing to do after the first frame
    (raises if it launched) -> the frames."""
    import torch
    from neuralsim_torch import kernels
    k14 = kernels.KERNELS["lotd_cp_lines"]
    frames, per = [], []
    with no_plain_on_card(f"{label} render"):
        for fi in frame_ids:
            n0 = k14.launches
            frames.append(render_one(fi))
            per.append(k14.launches - n0)
        torch.cuda.synchronize()
    log(f"{label} render: K14 launches by frame {per}")
    if any(per[1:]):
        raise AssertionError(f"{label} render: K14 launched on a frame after the first: {per}")
    return frames


def render_frames(renderer, params, rig, dev, frame_ids=FRAME_IDS, label="synthetic_object",
                  **kw):
    def one(fi):
        o, d = frame_rays(rig, fi, dev)
        return renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK, **kw)
    return frames_guarded(label, frame_ids, one)


def render_multi_frames(label, renderer, params, scene, occ):
    """COMPOSE_FRAME_IDS through render_multi_frame, guarded as frames_guarded."""
    from neuralsim_torch.tools.build import render_multi_frame
    return frames_guarded(label, COMPOSE_FRAME_IDS, lambda fi: render_multi_frame(
        renderer, params, scene, fi, COMPOSE_CAM, occ, RAYSCHUNK))


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
    return {role: type(st)(*(None if t is None else t.to(d) for t in st))
            for role, st in state.occ.items()}


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
    with no_plain_on_card("synthetic_object training"):
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

    args, plan = shapes["lotd_grid"]["args"], shapes["lotd_grid"]["plan"]
    meta = args[2]
    L = meta.shape[0]
    cols = int(meta[:, 3].sum())
    seg = int(sum(r[1] * r[3] for r in meta.tolist())) * 4
    out["lotd_grid"] = dict(
        shape=f"N={N} levels={L} (hash 172, 256; F=2) with jacobian, the same samples",
        **card_ms(lambda: lotd.lotd_grid(*args, *buf, plan=plan)),
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
        bound=k5a_bound(n, S, nf, noise is not None))

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
    """K4, K7 and K7's points against their plain versions on the card, at
    the bench path's shapes (K7 at S 1 and the street's S 4, its edges, and
    its points at K7_POINT_SHAPES). -> ({kernel: (max_abs_err, atol)},
    inputs kept for timing)."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
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
                errs.append(check_k7(f"K7 occ_ema_update {accel.res}^3 S={S} {mode} "
                                     f"warm-up={floor is not None}", a))
                if mode == "sdf" and floor is None:
                    shapes["occ_ema_update" if S == 1 else "occ_ema_update S=4"] = dict(args=a)
    for V_e, S_e in K7_EDGES:
        for offset in (0, 1):
            val = T(rng.random(V_e + offset).astype(np.float32))[offset:]
            a = (T(rng.normal(0.0, 0.2, (S_e, V_e)).astype(np.float32)), val, "sdf",
                 accel.voxel_half_diag, accel.occ_inv_s, accel.ema_decay, accel.occ_thre, None)
            errs.append(check_k7(f"K7 occ_ema_update edge V={V_e} S={S_e} values off 16-byte "
                                 f"alignment={bool(offset)}", a))
    res["occ_ema_update"] = (max(errs), K7_ATOL)
    res["occ_voxel_points"] = (check_k7_points(dev, box), 0.0)
    gen = torch.Generator(device=dev).manual_seed(47)
    for label, L, R, lead in K7_POINT_SHAPES[:3]:
        shapes[f"occ_voxel_points {label}"] = dict(
            args=(torch.rand((L, R, R, R, 3), generator=gen, device=dev), *box, lead))
    check_refresh_kernels("bench model", accel, st, dev)
    check_refresh_device_kernels()
    torch.cuda.synchronize()
    return res, shapes


def check_k7(label, a):
    """K7 (with its count) against its plain version on the card: the values
    within K7_ATOL, the mask equal away from the threshold, the count the
    kernel's mask's and the fraction that mask's plain mean, bit for bit.
    -> max_abs_err of the values."""
    import torch
    from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                                occupied_fraction_plain)
    got, want = occ_ema_update(*a), occ_ema_update_plain(*a)
    err = compare(label, got[:1], want[:1], 0, K7_ATOL)
    off = (got[1] != want[1]) & ((want[0] - a[6]).abs() > K7_ATOL)
    if bool(off.any()) or got[1].dtype != torch.bool:
        raise AssertionError(f"{label}: the mask differs away from the threshold")
    plain = occupied_fraction_plain(got[1])
    if int(got[2]) != int(got[1].sum()) or not torch.equal(got[3], plain):
        raise AssertionError(f"{label}: count {int(got[2])} and fraction {float(got[3])!r} "
                             f"against the mask's {int(got[1].sum())} and {float(plain)!r}")
    return err


def check_k7_points(dev, box, shapes=K7_POINT_SHAPES):
    """K7's points kernel (with each shape's lead) against its plain version
    on the card at ``shapes`` in the box ``box`` (aabb_min, aabb_max): bit
    for bit, one launch a call, also from a jitter 4 bytes off 16-byte
    alignment. -> 0.0, the largest difference (anything else raises)."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.accel.occ_grid import occ_voxel_points, occ_voxel_points_plain
    gen = torch.Generator(device=dev).manual_seed(41)
    k = kernels.KERNELS["occ_voxel_points"]
    for label, L, R, lead in shapes:
        for offset in (0, 1):
            u = torch.rand(L * R ** 3 * 3 + offset, generator=gen, device=dev)[offset:]
            u = u.view(L, R, R, R, 3)
            n0 = k.launches
            got = occ_voxel_points(u, *box, lead)
            want = occ_voxel_points_plain(u, *box, lead)
            got, want = ((got,), (want,)) if lead is None else (got, want)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("points", lead)):
                if k.launches != n0 + 1 or g.shape != w.shape or g.dtype != w.dtype \
                        or not torch.equal(g, w):
                    bad = int((g != w).reshape(w.shape[0], -1).any(-1).sum()) \
                        if g.shape == w.shape else -1
                    raise AssertionError(f"K7 points {label} [{L}, {R}^3] offset {offset}: "
                                         f"{bad} {what} differ from the plain version's")
    log(f"K7 points: bit-equal to the plain version at {[s[0] for s in shapes]}, aligned and "
        f"4 bytes off, one launch a call")
    return 0.0


def check_refresh_kernels(label, accel, st, dev):
    """A refresh without the field (its query hands back fixed values) is one
    launch of K7's points and one of K7 (their counters) and runs no aten op
    but allocations and views (a TorchDispatchMode: no plain point pass, no
    cast or mean of the mask). Which device kernels a refresh runs, the
    profiler shows in a fresh process (check_refresh_device_kernels)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from neuralsim_torch import kernels
    gen = torch.Generator(device=dev).manual_seed(43)
    u = torch.rand(accel.jitter_shape, generator=gen, device=dev)
    raw = torch.rand(int(np.prod(accel.jitter_shape[:-1])), generator=gen, device=dev)
    refresh = lambda: accel.update(st, lambda x, *lead: raw, u, 1000)
    refresh()           # the box on the card and the ticket are made once a device
    ops = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    n0 = {k: kernels.KERNELS[k].launches for k in ("occ_voxel_points", "occ_ema_update")}
    with Ops():
        refresh()
    torch.cuda.synchronize()
    once = all(kernels.KERNELS[k].launches == n + 1 for k, n in n0.items())
    compute = sorted(set(ops) - set(REFRESH_ALLOC_OPS))
    if not once or compute:
        raise AssertionError(f"a {label} refresh should be K7's points and K7 alone: launches "
                             f"{ {k: kernels.KERNELS[k].launches - n for k, n in n0.items()} }, "
                             f"aten ops {compute} besides allocations and views")
    log(f"{label} refresh ({list(accel.jitter_shape)} jitter): one launch of each wrapper, "
        f"aten ops {sorted(set(ops))}")


def refresh_kinds(names):
    """(K7's points, K7, any other) kernels among the profiler's names."""
    pts = sum("occ_voxel_points_kernel" in n for n in names)
    k7 = sum("occ_ema_update_kernel" in n for n in names)
    return pts, k7, len(names) - pts - k7


def refresh_device_kernels() -> dict:
    """In this process, on the card: the device kernels, by the profiler, of
    REFRESH_PROFILED_REPS refreshes without the field of a grid at each of
    REFRESH_PROFILED -> {label: names}. A session is run again (three at
    most) while it lacks one of the two kernels and shows no other: a
    session can drop records."""
    import torch
    from neuralsim_torch.accel import OccGridEma, OccGridEmaBatched, OccGridEmaDynamic
    from neuralsim_torch.fields.spatial import AABBSpace
    dev = torch.device("cuda")
    space = AABBSpace().to(dev)
    gen = torch.Generator(device=dev).manual_seed(44)
    out = {}
    for label, kind, L, R in REFRESH_PROFILED:
        accel = {"single": lambda: OccGridEma(space, R, samples_per_voxel=L),
                 "batched": lambda: OccGridEmaBatched(space, L, R),
                 "dynamic": lambda: OccGridEmaDynamic(space, R, n_keyframes=L)}[kind]()
        st = accel.init_state()
        u = torch.rand(accel.jitter_shape, generator=gen, device=dev)
        raw = torch.rand(int(np.prod(accel.jitter_shape[:-1])), generator=gen, device=dev)
        seen = lambda names: all(refresh_kinds(names)[:2]) or refresh_kinds(names)[2] > 0
        out[label] = device_kernels(lambda: accel.update(st, lambda x, *lead: raw, u, 1000),
                                    REFRESH_PROFILED_REPS, done=seen)
    return out


def check_refresh_device_kernels() -> dict:
    """The device kernels of a refresh without the field at each of
    REFRESH_PROFILED, by the profiler in a fresh process
    (refresh_device_kernels; late in a long process its sessions were seen
    to drop records or record none): K7's points and K7 and no other kernel
    (no memset, no copy), each at least once and at most once a refresh.
    Raises otherwise, and where every session recorded nothing. -> {label:
    names}."""
    r = subprocess.run([sys.executable, "-c", "import json, chip_smoke; "
                        "print(json.dumps(chip_smoke.refresh_device_kernels()))"],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"the refresh profiler process failed ({r.returncode}): "
                             f"{r.stderr[-3000:]}")
    found = json.loads(r.stdout.strip().splitlines()[-1])
    for label, names in found.items():
        pts, k7, other = refresh_kinds(names)
        if not pts or not k7 or other or max(pts, k7) > REFRESH_PROFILED_REPS:
            raise AssertionError(f"a {label} refresh should launch K7's points and K7 alone: "
                                 f"{REFRESH_PROFILED_REPS} refreshes gave the kernels "
                                 f"{sorted(set(names)) or 'none recorded by the profiler'}")
        log(f"{label} refresh, {REFRESH_PROFILED_REPS} under the profiler in a fresh process: "
            f"{pts} of K7's points, {k7} of K7, no other kernel")
    return found


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


def time_k7(a, what):
    """K7 with its count, three ways, beside its plain version (with the
    plain mean the count replaces) and its bound, at args ``a``."""
    from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                                occupied_fraction_plain)
    S, V = a[0].shape
    return dict(shape=f"{what}: voxels={V} samples per voxel={S} (sdf, after the warm-up)",
                **card_ms(lambda: occ_ema_update(*a)),
                plain_ms=cuda_ms(lambda: occupied_fraction_plain(occ_ema_update_plain(*a)[1])),
                library_ms=None,
                # raw and the old values read, the new values, the mask, the
                # count and the fraction written; ~12 operations a sample
                bound=bound(V * (4 * S + 4 + 4 + 1) + 8, V * (S * 12 + 4)))


def time_k7_points(a, what):
    """K7's points three ways beside their plain version and bound, at
    args ``a`` (u, aabb_min, aabb_max, lead)."""
    from neuralsim_torch.accel.occ_grid import occ_voxel_points, occ_voxel_points_plain
    u, lead = a[0], a[3]
    L, R, P = u.shape[0], u.shape[1], u.numel() // 3
    return dict(shape=f"{what}: jitter [{L}, {R}, {R}, {R}, 3], {P} points"
                      + (f" and their {lead}" if lead else ""),
                **card_ms(lambda: occ_voxel_points(*a)),
                plain_ms=cuda_ms(lambda: occ_voxel_points_plain(*a)),
                library_ms=None,
                # the jitter read and the points written, 12 bytes each a
                # point, and the lead (8 or 4 bytes); 4 operations a coordinate
                bound=bound(P * (24 + {None: 0, "index": 8, "time": 4}[lead]) + 24, P * 12))


def timing_entry(t) -> dict:
    """A timing as the kernels line writes one shape."""
    return {"ms": t["ms"], **card_keys(t), "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"], "shape": t["shape"]}


def time_bench_kernels(shapes):
    """K4, K7 and its points, and the wide K1 (forward and backward) beside
    their plain versions and bounds, at the bench step's shapes (K7 and its
    points also at the street's and the crowd's, under ``at_shapes``)."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
    from neuralsim_torch.fields.encodings import lotd
    out = {}
    a = shapes["occ_ray_proposal"]["args"]
    N, n, M = a[0].shape[0], a[8], a[7].shape[0] - 1
    out["occ_ray_proposal"] = dict(
        shape=f"rays={N} march segments={M} samples={n} grid={a[4].shape[0]}^3 (drawn noise)",
        **card_ms(lambda: occ_ray_proposal(*a)),
        plain_ms=cuda_ms(lambda: occ_ray_proposal_plain(*a)),
        library_ms=None,
        bound=k4_bound(N, M, n, a[9] is not None))
    out["occ_ema_update"] = time_k7(shapes["occ_ema_update"]["args"], "bench")
    out["occ_ema_update"]["at_shapes"] = [
        timing_entry(time_k7(shapes["occ_ema_update S=4"]["args"], "street"))]
    out["occ_voxel_points"] = time_k7_points(shapes["occ_voxel_points bench"]["args"], "bench")
    out["occ_voxel_points"]["at_shapes"] = [
        timing_entry(time_k7_points(shapes[f"occ_voxel_points {w}"]["args"], w))
        for w in ("street", "crowd")]
    for name in ("occ_ema_update", "occ_voxel_points"):
        for t in [timing_entry(out[name])] + out[name]["at_shapes"]:
            log(f"kernel {name}: {t['ms']:.4f} ms ({card_extra(t)[2:]}, plain "
                f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']}) at "
                f"{t['shape']}")
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
    with no_plain_on_card("bench model training"):
        log_, rgb_first, rgb_last = bench_steps(trainer, state, rig, dev)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    refreshes = sum(1 for r in log_ if r["it"] % accel.n_steps_between_update == 0)
    log(f"bench training slice: {BENCH_STEPS} steps of {BENCH_RAYS} rays, {refreshes} grid "
        f"refreshes, launches {launches}")
    if launches["occ_ray_proposal"] != BENCH_STEPS or launches["occ_ema_update"] != refreshes \
            or launches["occ_voxel_points"] != refreshes or refreshes != 3:
        raise AssertionError("K4 must launch once a step, K7's points and K7 once a refresh")
    for name in ("lotd_cp_stacked", "lotd_cp_stacked.bwd", "neus_upsample.weights_pdf",
                 "neus_upsample.merge", "volume_composite", "volume_composite.bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the bench training path")
    if launches["lotd_grid"] or launches["lotd_grid.bwd"]:
        raise AssertionError("the bench encoding has no gather level, yet K3 launched")
    if state.it % accel.n_steps_between_update != 0:
        raise AssertionError("the poisoned step should fall on the grid's cadence")
    k7 = [kernels.KERNELS[k].launches for k in ("occ_ema_update", "occ_voxel_points")]
    check_poisoned_step(trainer, state, rig, dev, BENCH_RAYS)
    if [kernels.KERNELS[k].launches for k in ("occ_ema_update", "occ_voxel_points")] != \
            [k7[0] + 1, k7[1] + 1]:
        raise AssertionError("the skipped step on the cadence did not launch K7 and its points")

    kernels.reset_counts()
    frames = render_frames(renderer, state.params, rig, dev, BENCH_FRAME_IDS, "bench model",
                           occ_states=state.occ)
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    chunks = len(BENCH_FRAME_IDS) * (rig.H * rig.W // RAYSCHUNK)
    log(f"bench render slice: {len(BENCH_FRAME_IDS)} frames of {rig.H}x{rig.W}, launches "
        f"{launches_render}")
    if launches_render["occ_ray_proposal"] != chunks or launches_render["occ_ema_update"] \
            or launches_render["occ_voxel_points"]:
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


def tie_inputs(n, L, seed):
    """:func:`unsorted_inputs` with depths of four values, -0.0 and +0.0
    among them: equal depths across every source, and -0.0 beside +0.0 in
    every ray of two lanes or more (the plain version's float compare ties
    them, so they go by lane)."""
    t, mask, alpha = unsorted_inputs(n, L, seed)
    t = np.random.default_rng(seed).choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), (n, L))
    t[:, 0] = -0.0
    t[:, -1] = 0.0
    mask[:, 0] = mask[:, -1] = True
    return t, mask, alpha


# K8's widths beside the path's buffer: ragged ones through the warp kernels
# (up to 256 lanes) and the block kernels past them, up to 6,144 (a
# LiDAR-length buffer; the backward, under autograd, runs the forward too)
K8_WIDTHS = ((4096, 168), (333, 1), (257, 5), (1000, 33), (512, 257), (64, 1100), (64, 4096),
             (16, 6144))


def k8_sets(dev, inputs):
    """K8's check buffers: ``inputs`` (unsorted_inputs or edge_alpha_inputs)
    at K8_WIDTHS, signed-zero and cross-source ties (tie_inputs) at 168 and
    1,100 lanes, and a buffer with every lane masked -> [(label, (t, mask,
    alpha))]."""
    import torch
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sets = [("ties, masked lanes, edge alphas", [T(a) for a in inputs(n, L, L)])
            for n, L in K8_WIDTHS]
    sets += [("-0.0 beside +0.0, ties across sources", [T(a) for a in tie_inputs(n, L, L + 1)])
             for n, L in ((4096, 168), (64, 1100))]
    t, mask, alpha = inputs(512, 168, 3)
    sets.append(("every lane masked", [T(t), T(np.zeros_like(mask)), T(alpha)]))
    return sets


def same_bits(name, fn):
    """Two calls of fn give the same bits, in its output or in each output
    of a tuple (NaN too)."""
    a, b = fn(), fn()
    for x, y in zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]:
        if x is not None and x.cpu().numpy().tobytes() != y.cpu().numpy().tobytes():
            raise AssertionError(f"{name}: two calls differ")


def check_cross_source_vw(dev, path_buffer):
    """K8 against its plain version: on the merged buffer of one chunk of the
    compose path (t, mask, alpha [4,096, 168]) and on unsorted buffers of
    ragged widths (1 to 6,144 lanes: k8_sets) with ties (-0.0 beside +0.0,
    equal depths across sources), masked lanes, fully masked rays and
    alphas at and near 1; the same bits on two calls."""
    import torch
    from neuralsim_torch.ops.segment import cross_source_vw, cross_source_vw_plain
    errs = []
    for label, args in [("path chunk", path_buffer)] + k8_sets(dev, unsorted_inputs):
        N, L = args[0].shape
        errs.append(compare(f"K8 cross_source_vw {label} rays={N} L={L}",
                            [cross_source_vw(*args)], [cross_source_vw_plain(*args)], **K8_TOL))
        same_bits(f"K8 cross_source_vw {label} rays={N} L={L}", lambda: cross_source_vw(*args))
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
            shapes[f"lotd_grid/{label}"] = dict(args=a3, C=C, what=what, plan=enc.grid_fwd_plan)
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


def k4_edge_inputs(dev, n_rays, M, n, share, noisy, outside, seed, G=None, R=32):
    """K4's arguments (K10's with ``G`` grids, the lead last) from a seed:
    rays from a sphere of radius 3 aimed into the box [-1, 1]^3 (about one
    in ten misses it), a random grid with ``share`` of its cells occupied
    (one share a grid from 0.05 to 0.6 for K10), JAX's linspace edges;
    ``outside``: march [0.1, 6] past the box."""
    import torch
    from neuralsim_torch.accel.occ_grid import OccGridEma
    from neuralsim_torch.fields.spatial import AABBSpace
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    o = rng.normal(size=(n_rays, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.1, 1.1, (n_rays, 3)) - o
    o, d = T(o), T(d / np.linalg.norm(d, axis=-1, keepdims=True))
    space = AABBSpace().to(dev)
    near, far, _ = space.ray_test(o, d)
    if outside:
        near, far = torch.full_like(near, 0.1), torch.full_like(far, 6.0)
    shape = (R, R, R) if G is None else (G, R, R, R)
    shares = share if G is None else np.linspace(0.05, 0.6, G)[:, None, None, None]
    mask = torch.from_numpy(rng.random(shape) < shares).to(dev)
    accel = OccGridEma(space, R, march_steps=M)
    noise = T(rng.random((n_rays, n))) if noisy else None
    return (o, d, near, far, mask, *accel.box(dev), accel.edges01(M, dev), n, noise)


def k10_lead(label, n_rays, G, seed, dev):
    import torch
    if label == "lead 0":
        lead = np.zeros(n_rays)
    elif label == "lead G - 1":
        lead = np.full(n_rays, G - 1)
    else:
        lead = np.random.default_rng(seed).integers(-3, G + 3, n_rays)
    return torch.from_numpy(lead.astype(np.int32)).to(dev)


def occupied_probes(args):
    """Each ray's occupied probes [N] by the plain version's probe."""
    import torch
    o, d, near, far, mask, lo, hi, edges = args[:8]
    lead = args[10] if len(args) > 10 else None
    R = mask.shape[-1]
    t_edges = near[:, None] + (far - near)[:, None] * edges
    x = o[:, None] + (0.5 * (t_edges[:, 1:] + t_edges[:, :-1]))[..., None] * d[:, None]
    x01 = (x - lo) / (hi - lo)
    cell = (x01 * R).to(torch.int32).clamp(0, R - 1).long()
    at = (cell[..., 0] * R + cell[..., 1]) * R + cell[..., 2]
    if lead is not None:
        at = (lead.long()[:, None] * R ** 3 + at).clamp(0, mask.numel() - 1)
    inside = torch.all((x01 >= 0) & (x01 <= 1), dim=-1)
    return (mask.reshape(-1)[at] & inside).sum(-1)


def check_k4_edges(dev):
    """K4 at K4_EDGES and K10 at K10_EDGES against their plain version at
    K4_TOL, each giving the same bits on two calls; the inputs hold what the
    edges name (a ray past 32 occupied probes, none occupied anywhere)
    -> {kernel: (max_abs_err, atol)}."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
    e4, e10 = [], []
    for seed, (label, N, M, n, share, noisy, outside) in enumerate(K4_EDGES, 300):
        a = k4_edge_inputs(dev, N, M, n, share, noisy, outside, seed)
        most = int(occupied_probes(a).max())
        if (share == 0.0 and most) or (share >= 0.85 and most < 33):
            raise AssertionError(f"K4 {label}: {most} occupied probes at most on a ray")
        name = f"K4 occ_ray_proposal {label}: rays={N} M={M} n={n} noise={noisy}"
        e4.append(compare(name, [occ_ray_proposal(*a)], [occ_ray_proposal_plain(*a)],
                          **K4_TOL))
        same_bits(name, lambda: occ_ray_proposal(*a))
    G = 8
    for seed, label in enumerate(K10_EDGES, 320):
        for noisy in (False, True):
            a = k4_edge_inputs(dev, 4096, 64, 24, None, noisy, False, seed, G=G)
            a = (*a, k10_lead(label, 4096, G, seed, dev))
            name = f"K10 occ_ray_proposal_batched {label}: G={G} noise={noisy}"
            e10.append(compare(name, [occ_ray_proposal(*a)], [occ_ray_proposal_plain(*a)],
                               **K4_TOL))
            same_bits(name, lambda: occ_ray_proposal(*a))
    torch.cuda.synchronize()
    log(f"K4 edges: {len(e4)} cases, max abs err {max(e4):.3g}; K10 edges: {len(e10)} cases, "
        f"max abs err {max(e10):.3g}; each the same bits on two calls")
    return {"occ_ray_proposal": (max(e4), K4_TOL["atol"]),
            "occ_ray_proposal_batched": (max(e10), K4_TOL["atol"])}


def k4_bound(N, M, n, noisy, lead=False):
    """K4's (K10's) least time: the rays, near and far (and the lead) read,
    one mask byte a probe, the edges, the draws and the depths; a probe's
    ~30 operations, the cdf and prefix steps (~6 a segment), and a binary
    search over the M segments with the bin's lerp a draw."""
    return bound(N * (32 + (4 if lead else 0) + M) + (M + 1) * 4
                 + ((N if noisy else 1) + N) * n * 4,
                 N * (M * 36 + n * (8 * math.ceil(math.log2(M + 1)) + 10)))


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
        **card_ms(lambda: cross_source_vw(t, mask, alpha)),
        plain_ms=cuda_ms(lambda: cross_source_vw_plain(t, mask, alpha), reps=5),
        library_ms=None,
        # t, alpha and mask read, vw written
        bound=k8_bound(N, L, 13))]
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
            **card_ms(lambda: lotd.lotd_grid(*a, *buf, plan=shapes[key]["plan"])),
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
        bound=k4_bound(N, M, n, a[9] is not None))]
    return out


def compose_phase(dev, profile_it):
    """Phase 7 and the compose path's share of the timing -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI as C
    from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
    from neuralsim_torch.scene import Scene
    from neuralsim_torch.scene.observers import camera_get_all_rays
    from neuralsim_torch.tools.build import build_compose_renderer, converge_occ

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
    frames = render_multi_frames("compose", renderer, params, scene, occ)
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
            launches["occ_voxel_points"] or any(n for k, n in launches.items()
                                                if k.endswith(".bwd")):
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


def check_multi_first_iteration(scene, trainer, state, samplers, dev, path="multi"):
    """The first loop iteration (a LiDAR step of MULTI_CHECK_BEAMS beams, a
    pixel step of MULTI_CHECK_RAYS rays) on the card against the CPU path,
    from the same parameters, grid, batches and noise; steps nothing. The
    CPU path's sample depths are replayed on the card (sample_placements),
    and the losses and every gradient leaf are held to MULTI_STEP_LOSS_RTOL
    and MULTI_STEP_GRAD_REL there; the card's own step (its own K4 and K5a
    placements) is logged beside it. ``path`` names the path in the log.
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
            log(f"{path} first iteration, {step_type} step, {label} vs cpu: worst loss rel err "
                f"{le:.3g}, worst gradient rel err {ge:.3g}; losses "
                f"{ {k: round(v, 6) for k, v in l_gpu.items()} }")
            if label != "card":
                rel = {k: float((g_gpu[k] - g).abs().max()) / float(g.abs().max())
                       for k, g in g_cpu.items() if float(g.abs().max()) > 0}
                for k, e in rel.items():
                    if e > MULTI_STEP_GRAD_REL or e == max(rel.values()):
                        log(f"  gradient {k}: rel err {e:.3g}")
                worst_loss, worst_grad = max(worst_loss, le), max(worst_grad, ge)
        if not all(np.isfinite(v) for v in results["card"][0].values()):
            raise AssertionError("the card's own first step gives a non-finite loss")
    log(f"{path} first iteration at equal sample depths: worst loss rel err {worst_loss:.3g} "
        f"(tol {MULTI_STEP_LOSS_RTOL:g}), worst gradient rel err {worst_grad:.3g} "
        f"(tol {MULTI_STEP_GRAD_REL:g})")
    if not (worst_loss <= MULTI_STEP_LOSS_RTOL and worst_grad <= MULTI_STEP_GRAD_REL):
        raise AssertionError(f"the card's first {path} iteration differs from the CPU's")
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
        (label, args, cotangents(args[0].shape, 22 + args[0].shape[1], dev))
        for label, args in k8_sets(dev, edge_alpha_inputs)]
    e8 = []
    for label, (t, mask, alpha), gg in sets:
        a = alpha.clone().requires_grad_(True)
        grad = lambda: torch.autograd.grad(cross_source_vw(t, mask, a), a, gg)[0]
        what = f"K8 bwd {label} rays={t.shape[0]} L={t.shape[1]}"
        e8.append(compare_rel(what, [grad()], [cross_source_vw_bwd_plain(t, mask, alpha, gg)],
                              GRAD_REL))
        same_bits(what, grad)
    errs["cross_source_vw.bwd"] = (max(e8), GRAD_REL)
    _, logt, rank = cross_source_vw_fwd(*path, with_logt=True)
    shapes["cross_source_vw.bwd"] = dict(args=(*path, logt, rank, g))
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


# K5a's cases beside STAGE_SHAPES: (label, rays, samples, draws, inv_s,
# drawn noise, every lane masked). A ray takes 16 lanes (samples past 16
# give a lane more, S 100 seven, S 3,000 past 48 KB a block; draws past 16
# too, nf 33 three); without noise the draws are the [nf] midpoints;
# stage_inputs masks every lane of every 11th ray, and the last case masks
# every ray
K5A_EDGES = (("two samples", 4096, 2, 8, 64.0, True, False),
             ("3,000 samples", 64, 3000, 16, 256.0, True, False),
             ("80 samples, 16 draws", 4096, 80, 16, 256.0, True, False),
             ("100 samples", 1024, 100, 16, 256.0, True, False),
             ("one draw", 4096, 32, 1, 64.0, True, False),
             ("16 draws", 4096, 40, 16, 256.0, True, False),
             ("33 draws", 2048, 40, 33, 256.0, True, False),
             ("no noise", 4096, 32, 8, 64.0, False, False),
             ("every lane masked", 4096, 32, 8, 64.0, True, True))


def k5a_case(dev, n, s, nf, noisy, all_masked, seed):
    """K5a's inputs ([t, sdf, mask, near, far], noise or None) from a seed."""
    import torch
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in stage_inputs(n, s, seed)]
    if all_masked:
        args[2] = torch.zeros_like(args[2])
    noise = torch.rand((n, nf), generator=torch.Generator().manual_seed(seed)).to(dev) \
        if noisy else None
    return args, noise


def check_k5a(name, args, inv_s, nf, noise):
    """K5a against its plain version (the weights and the new depths), and
    its new depths without the weights the same bits -> max_abs_err."""
    import torch
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    got = upsample_weights_pdf(*args, inv_s, nf, noise)
    err = compare(name, got, upsample_weights_pdf_plain(*args, inv_s, nf, noise), 1e-5, 1e-6)
    w, t_new = upsample_weights_pdf(*args, inv_s, nf, noise, with_weights=False)
    if w is not None or not torch.equal(t_new, got[1]):
        raise AssertionError(f"{name}: the depths without the weights differ")
    return err


def check_stages(dev, shapes):
    """K5a (with drawn noise, as in training) and K5b at the multi-object
    stage shapes (STAGE_SHAPES), K5a also at K5A_EDGES and without the
    weights (the same depths); K5b also at N = 1 and 4,097, on lists on a
    grid of 4 depths (ties inside each list and across, in every ray) and on
    lists too wide for four rays' depths in 48 KB of shared memory; K5b held
    exactly. The stage inputs are kept in ``shapes`` for timing
    -> {kernel: (max_abs_err, tol)}."""
    import torch
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    err_w, err_m = 0.0, 0.0
    for seed, (n, s, nf, inv_s) in enumerate(STAGE_SHAPES, 40):
        args, noise = k5a_case(dev, n, s, nf, True, False, seed)
        err_w = max(err_w, check_k5a(f"K5a weights_pdf rays={n} S={s} draws={nf} "
                                     f"inv_s={inv_s:g} noise=True", args, inv_s, nf, noise))
        shapes[f"neus_upsample.weights_pdf/{n} {s}+{nf}"] = dict(args=args, noise=noise,
                                                                 inv_s=inv_s, nf=nf)
    for seed, (label, n, s, nf, inv_s, noisy, masked) in enumerate(K5A_EDGES, 60):
        args, noise = k5a_case(dev, n, s, nf, noisy, masked, seed)
        err_w = max(err_w, check_k5a(f"K5a weights_pdf {label} rays={n} S={s} draws={nf}",
                                     args, inv_s, nf, noise))
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
    with no_plain_on_card(label):
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
    shares = {role: round(float(a.occupied_fraction(state.occ[role])), 4)
              for role, a in r.accels.items()}
    log(f"{label} training: the grids' occupied fractions after it {shares}, error-map "
        f"updates {samplers['imp'].it} (importance sampling from "
        f"{samplers['imp'].enable_after})")
    pair = any(r._pair_rows(obs, MULTI_RAYS) for obs in r._grouped().values())
    batched = any(a.n_grids for a in r.accels.values())
    # the LiDAR step composites the street alone: K12, never K6; the
    # encodings take K1 (stacked) or K2 (per-level), never both
    want = {"cross_source_vw": iters, "cross_source_vw.bwd": iters,
            "neus_composite": iters, "neus_composite.bwd": iters,
            "volume_composite": 0, "volume_composite.bwd": 0,
            "occ_ray_proposal": 2 * iters, "occ_ema_update": refreshes * len(r.accels),
            "occ_voxel_points": refreshes * len(r.accels),
            "pair_compact": iters if pair else 0,
            "occ_ray_proposal_batched": iters if batched else 0,
            **dict.fromkeys(("lotd_cp_stacked", "lotd_cp_stacked.bwd") + LINES_KERNELS
                            if per_level else PERLEVEL_ONLY, 0),
            **dict.fromkeys(("lotd_grid", "lotd_grid.bwd") if permuto else PERMUTO_ONLY, 0),
            **dict.fromkeys(STREETSURF_ONLY + POSE_ONLY, 0)}
    if refreshes != 3 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"the {label} path's launches are not as counted: want {want}")
    for name, n in launches.items():
        if n <= 0 and want.get(name, 1):
            raise AssertionError(f"kernel {name} never launched on the {label} training path")
    if samplers["imp"].it != iters or samplers["imp"].enable_after >= iters:
        raise AssertionError("the error map's importance sampling did not run")
    return log_, launches, falls


def check_multi_poisoned_step(scene, trainer, state, samplers, dev, path="multi"):
    """A NaN in a pixel batch: the step is skipped and leaves every parameter
    and moment bit-identical (``path`` names the path in the log)."""
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
    log(f"{path} poisoned step: skipped {int(m['step_skipped'])}, skips_total "
        f"{int(m['skips_total'])}, parameters and moments unchanged {same}, it {it} -> {state.it}")
    if not (int(m["step_skipped"]) == 1 and int(m["skips_total"]) == 1 and same
            and state.it == it + 1):
        raise AssertionError(f"the poisoned {path} step was not skipped cleanly")


def time_multi_iterations(scene, trainer, state, samplers, dev, reps=20, n_rays=MULTI_RAYS,
                          n_beams=MULTI_BEAMS):
    """Host-clock time of each step type of a loop iteration of ``n_beams``
    beams and ``n_rays`` rays, batch sampling, lifting and noise included
    (the pixel step's error-map update too), in ms over ``reps`` iterations
    after 3 warm-ups -> {lidar, pixel, iteration: (median, min, max)}."""
    import torch
    from neuralsim_torch.tools.train_multi import _LIDAR_KEYS, _PIXEL_KEYS, to_device
    from neuralsim_torch.training.multi_trainer import lift_lidar_batch
    gen = torch.Generator(device=dev).manual_seed(13)
    pix, lid, imp = samplers["pixel"], samplers["lidar"], samplers["imp"]
    ts = {"lidar": [], "pixel": [], "iteration": []}
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lb = lid.sample(n_beams)
        lbatch = lift_lidar_batch(scene, {**to_device(lb, _LIDAR_KEYS, dev),
                                          "lidar_id": lb["lidar_id"]})
        trainer.train_step(state, lbatch, trainer.draw_noise("lidar", n_beams, gen, state.it),
                           "lidar", None, False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw = pix.sample(n_rays)
        batch = to_device(raw, _PIXEL_KEYS, dev)
        _, m = trainer.train_step(state, batch,
                                  trainer.draw_noise("pixel", n_rays, gen, state.it), "pixel",
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
    t, mask, alpha, logt, rank, g = shapes["cross_source_vw.bwd"]["args"]
    N, L = t.shape
    what = f"rays={N} L={L} (the pixel step's merged buffer: 3 vehicles x 32, street 48, " \
           f"distant 24 lanes)"
    out["cross_source_vw"] = dict(
        shape=what + ", writing S and the ranks",
        **card_ms(lambda: cross_source_vw_fwd(t, mask, alpha, True)),
        plain_ms=cuda_ms(lambda: cross_source_vw_plain(t, mask, alpha), reps=5), library_ms=None,
        # t, alpha and mask read, vw, S and the int16 rank written
        bound=k8_bound(N, L, 19))
    out["cross_source_vw.bwd"] = dict(
        shape=what, **card_ms(lambda: cross_source_vw_bwd(mask, alpha, logt, rank, g)),
        plain_ms=cuda_ms(lambda: cross_source_vw_bwd_plain(t, mask, alpha, g), reps=5),
        library_ms=None,
        # mask, alpha, S, the rank and the cotangent read, d alpha written
        bound=k8_bound(N, L, 19))
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
            bound=k5a_bound(n, S, nf, True)))
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
    from neuralsim_torch.configs import BENCH_OBJECT, SYNTHETIC_OBJECT, WAYMO_DEMO_MULTI
    from neuralsim_torch.fields.encodings.lotd import make_lotd
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
    occ_frac_last = float(accel.occupied_fraction(state.occ["cr"]))
    check_multi_poisoned_step(scene, trainer, state, samplers, dev)
    # the street's refresh: K7's points in its own box, the refresh K7's
    # points and K7 alone, and its time split into the field query and the rest
    street = state.params[trainer.renderer.scene_models["cr"][0]]
    check_k7_points(dev, accel.box(dev), [("street, its own box", accel.samples_per_voxel,
                                           accel.res, None)])
    check_refresh_kernels("street", accel, state.occ["cr"], dev)
    refresh = time_refresh(accel, state.occ["cr"], street, dev)
    log(refresh_line(f"street grid, {accel.res}^3 x {accel.samples_per_voxel} samples, "
                     f"eval_chunk {street.eval_chunk}", refresh))
    # the shapes of the redesigned kernels' launches (and K1 bwd's, K5a's,
    # K13's and K14's) in one LiDAR and one pixel step, K13's calls with
    # their indices
    step_shapes, lat_record = {}, []
    with latent_calls(lat_record):
        step_launches(scene, trainer, state, samplers, dev, shapes=step_shapes)
    by_shape = {st: {k: {str(sh): calls.count(sh) for sh in sorted(set(calls))}
                     for k, calls in rec.items() if k in MULTI_WATCHED}
                for st, rec in step_shapes.items()}
    for st, rec in by_shape.items():
        log(f"multi-object {st} step: launches by integer arguments {rec}")
    if not all(by_shape["pixel"].get(k) for k in MULTI_WATCHED):
        raise AssertionError(f"a pixel step should launch each of {MULTI_WATCHED}")
    # K13 at the step's own calls (the vehicles' runs of compacted rows, the
    # eikonal's instance 0) and the edge cases; K14 at the street's and the
    # vehicles' encodings, the bench ladder's, synthetic_object's and an edge
    # ladder
    k13_cases, k13_timed = path_latent_cases(lat_record, "main path")
    e13 = check_latent_take(dev, k13_cases + latent_edge_cases(dev))
    check_latent_bwd_launches(dev, k13_cases)
    ladders = []
    for label, enc_cfg in (
            ("bench ladder", BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"]),
            ("synthetic_object",
             SYNTHETIC_OBJECT["assetbank_cfg"]["Main"]["model_params"]["encoding_cfg"])):
        e = make_lotd(enc_cfg)
        e.reset_parameters(torch.Generator().manual_seed(0))
        ladders.append((label, e.to(dev)))
    k14_sets = cp_lines_sets(dev, [
        ("street", state.params[trainer.renderer.scene_models["cr"][0]].encoding),
        ("vehicles", state.params[trainer.renderer.objects[0].model_id].encoding)] + ladders)
    e14 = check_cp_lines(dev, k14_sets)
    errs.update({"latent_take": (e13[0], 0.0), "latent_take.bwd": (e13[1], GRAD_REL),
                 "lotd_cp_lines": (e14[0], 0.0), "lotd_cp_lines.bwd": (e14[1], GRAD_REL)})

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
    # K13 and K14: the main path's largest call in the row, the others beside
    for name, ts in {**time_latent_take(k13_timed), **time_cp_lines(k14_sets)}.items():
        times[name], kernel_times[name] = ts[0], ts[1:]
    summary = {"multi_build_s": timings, "multi_step_launch_shapes": by_shape, "multi_first_iteration_loss_rel_err": loss_err,
               "multi_first_iteration_grad_rel_err": grad_err,
               "multi_iterations": MULTI_ITERS,
               "multi_loss_rgb_first10": falls["loss_rgb"][0],
               "multi_loss_rgb_last10": falls["loss_rgb"][1],
               "multi_lidar_depth_first10": falls["lidar/lidar_loss_depth"][0],
               "multi_lidar_depth_last10": falls["lidar/lidar_loss_depth"][1],
               "multi_occ_frac_last": occ_frac_last, "multi_street_refresh": refresh,
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
    a budget of half the rays, one long row (782 words a CTA of the
    cluster), and many instances (K 17 and 4,096, N not a multiple of 32)
    -> [(label, hit [K, N], Bg, M)]."""
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
    for K, N in ((17, 1000), (4096, 45)):                  # many instances, one word a CTA
        rate = torch.linspace(0.0, 0.9, K)[:, None]
        hit = torch.rand((K, N), generator=gen) < rate
        for gf in (0.5, 1.0):
            out.append((f"many instances K={K} N={N} gf={gf}", hit, pair_budget(K, N, gf), 4))
        out.append((f"many instances K={K} N={N} every pair a hit",
                    torch.ones((K, N), dtype=torch.bool), pair_budget(K, N, 1.0), 4))
    return [(label, h.to(dev), Bg, M) for label, h, Bg, M in out]


def check_pair_compact(dev, path_calls):
    """K11 against its plain version (the JAX package's argsort lines): the
    selected pairs, their hit flags and, with M, the slot indices equal,
    integer for integer, on the path's calls (with and without the slots) and
    on pair_edge_masks; one launch a call (its counter; the card tests count
    the device kernels by the profiler). -> the number of sets held."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.ops.pair_compact import pair_compact, pair_compact_plain
    sets = [(f"path call K={h.shape[0]} N={h.shape[1]} Bg={Bg} M={M}", h, Bg, M)
            for h, Bg, M in path_calls] + pair_edge_masks(dev)
    k11 = kernels.KERNELS["pair_compact"]
    for label, hit, Bg, M in sets:
        for m in ((M,) if M is None else (M, None)):
            n0 = k11.launches
            got = pair_compact(hit, Bg, m)
            if k11.launches != n0 + 1:
                raise AssertionError(f"K11 {label}: {k11.launches - n0} launches in a call")
            want = pair_compact_plain(hit, Bg, m)
            torch.cuda.synchronize()
            same = all((g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))
                       for g, w in zip(got, want))
            if not same:
                raise AssertionError(f"K11 differs from its plain version: {label} M={m}")
    log(f"K11 pair_compact: {len(sets)} hit masks (path calls {len(path_calls)}), every "
        f"output equal to the plain version's, with and without the slots; one launch a "
        f"call")
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
    SDF of each instance, warm-up on and off, with its count; its points in
    the model's own box, bit-equal to the plain version's; the refresh K7's
    points and K7 alone. -> (max_abs_err, inputs)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(23)
    u = torch.rand(accel.jitter_shape, generator=gen, device=dev)
    x, bidx = accel._voxel_points(u, "index")
    check_k7_points(dev, accel.box(dev),
                    [("crowd, the model's box", accel.n_grids, accel.res, "index")])
    with torch.no_grad():
        raw = field.query_sdf(x, bidx=bidx).reshape(1, -1).contiguous()
    val = st.val.reshape(-1).contiguous()
    errs = []
    for floor in (None, accel.occ_thre + 1e-3):
        a = (raw, val, accel.occ_val_fn, accel.raw_scale, accel.occ_inv_s, accel.ema_decay,
             accel.occ_thre, floor)
        errs.append(check_k7(f"K7 occ_ema_update batched V={raw.shape[1]} S=1 "
                             f"warm-up={floor is not None}", a))
    check_refresh_kernels("vehicle grids'", accel, st, dev)
    return max(errs), dict(args=(raw, val, accel.occ_val_fn, accel.raw_scale, accel.occ_inv_s,
                                 accel.ema_decay, accel.occ_thre, None),
                           points=(u, *accel.box(dev), "index"))


def time_refresh(accel, st, field, dev, reps=5) -> dict:
    """One refresh of a grid as the trainer runs it (the jitter drawn, K7's
    points, the points through the field in chunks of its eval_chunk, with
    each point's instance index for per-instance grids, then K7), host clock
    to a sync, median of ``reps``, beside the field query alone on one
    refresh's points; each also by the profiler (device busy a call). The
    rest (``rest_*``) is the refresh less the query: the draw, the points,
    K7. ``peak_mib``: the most a refresh allocates above what was held."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsim_torch.fields.neus import map_chunked
    gen = torch.Generator(device=dev).manual_seed(29)
    lines = field.encoding.kernel_lines()
    sdf = lambda x, b=None: field.query_sdf(x, lines, b)
    query = lambda x, *b: map_chunked(sdf, x, field.eval_chunk, *b)
    refresh = lambda: accel.update(
        st, query, torch.rand(accel.jitter_shape, generator=gen, device=dev), 1000)
    u = torch.rand(accel.jitter_shape, generator=gen, device=dev)
    if accel.n_grids is None:
        x, lead = accel._voxel_points(u), ()
    else:           # each point's instance index, as the batched update makes it
        x = accel._voxel_points(u)
        lead = (torch.arange(accel.n_grids, device=dev).repeat_interleave(accel.res ** 3),)

    @torch.no_grad()
    def alone():
        return query(x, *lead)

    def host(fn):
        ts = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts[1:])[reps // 2]

    def busy(fn):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            if us:
                return sum(us) / 1e3, len(us)
        return None, 0

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {"host_ms": host(refresh)}
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    out["busy_ms"], out["kernels"] = busy(refresh)
    out["query_host_ms"] = host(alone)
    out["query_busy_ms"], out["query_kernels"] = busy(alone)
    out["rest_host_ms"] = out["host_ms"] - out["query_host_ms"]
    if out["busy_ms"] is not None and out["query_busy_ms"] is not None:
        out["rest_busy_ms"] = out["busy_ms"] - out["query_busy_ms"]
    out["points"] = x.shape[0]
    return out


def refresh_line(label, r) -> str:
    """A log line of a time_refresh result."""
    f = lambda v: "not measured" if v is None else f"{v:.3f}"
    return (f"timing: refresh of the {label} ({r['points']} points): host {r['host_ms']:.3f} ms "
            f"(field query alone {r['query_host_ms']:.3f}, the rest {r['rest_host_ms']:.3f}); "
            f"busy {f(r['busy_ms'])} ms in {r['kernels']} kernels (query {f(r['query_busy_ms'])} "
            f"in {r['query_kernels']}, the rest {f(r.get('rest_busy_ms'))}); peak "
            f"{r['peak_mib']:.1f} MiB above what was held")


def time_crowd_kernels(pair_shapes, occ_shapes, ema_shapes, synth_hit):
    """K11 at the crowd's render and training calls and at synthetic_multi's,
    beside its plain version and a stable torch.argsort of the same keys
    (the library call that selects the same pairs); K10 at the path's rows;
    K7 and its points at the batched update's shape -> {kernel: [timing, ...]}."""
    import torch
    from neuralsim_torch.accel.occ_grid import occ_ray_proposal, occ_ray_proposal_plain
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
            # the hit mask read, order, hit flags (and slots) written; a
            # hit's place is K min-adds, a selected hit's slot K compares
            bound=bound(K * N + Bg * (9 + (8 if M else 0)),
                        2.0 * K * (int(hit.sum()) + (min(Bg, int(hit.sum())) if M else 0)))))
    a = occ_shapes["args"]
    N, n, M, G, R = a[0].shape[0], a[8], a[7].shape[0] - 1, a[4].shape[0], a[4].shape[-1]
    out["occ_ray_proposal_batched"] = [dict(
        shape=f"vehicle rows={N} march segments={M} samples={n} grids [{G}, {R}, {R}, {R}] "
              f"(drawn noise)",
        **card_ms(lambda: occ_ray_proposal(*a)),
        plain_ms=cuda_ms(lambda: occ_ray_proposal_plain(*a)),
        library_ms=None,
        bound=k4_bound(N, M, n, a[9] is not None, lead=True))]
    out["occ_ema_update"] = [time_k7(ema_shapes["args"], f"batched, {G} grids of {R}^3")]
    out["occ_voxel_points"] = [time_k7_points(ema_shapes["points"],
                                              f"batched, {G} grids, the model's box")]
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
    frames = render_multi_frames("crowd", renderer, params, scene, occ)
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
    refresh = time_refresh(va, occ[veh_id], params[veh_id], dev)
    log(refresh_line(f"{va.n_grids} vehicle grids through the shared model, eval_chunk "
                     f"{params[veh_id].eval_chunk}", refresh))
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
    # K13 at the crowd step's own calls: the group's round-robin rows (K11)
    lat_record = []
    with latent_calls(lat_record):
        step_launches(scene, trainer, state, samplers, dev)
    latent_cases, latent_timed = path_latent_cases(lat_record, "crowd")
    e13 = check_latent_take(dev, latent_cases)
    check_latent_bwd_launches(dev, latent_cases)
    errs.update({"latent_take": (e13[0], 0.0), "latent_take.bwd": (e13[1], GRAD_REL)})
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
               "crowd_refresh_ms": refresh["host_ms"], "crowd_refresh": refresh,
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
        prof = profile_multi_steps(scene, trainer, state, samplers, dev, named=LATENT_PROFILED)
        for k, (n, busy, named) in prof.items():
            summary[f"crowd_{k}_step_device_kernels"] = n
            summary[f"crowd_{k}_step_busy_ms"] = busy
            summary[f"crowd_{k}_step_kernel_ms"] = named
    return dict(errs=errs, launches=launches, launches_render=launches_render,
                iters=CROWD_ITERS, n_frames=len(COMPOSE_FRAME_IDS), summary=summary,
                shapes=(pair_shapes, occ_shapes, ema_shapes), latent_timed=latent_timed)


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
    with no_plain_on_card("synthetic_multi training"):
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
            "occ_ray_proposal": 0, "occ_ray_proposal_batched": 0, "occ_ema_update": 0,
            "occ_voxel_points": 0}
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


def composite_edge_inputs(n, s, seed):
    """K6's inputs at an edge shape: row 1 wholly masked, every third row
    from row 2 a run of three alpha == 1 lanes (masked in) from lane s // 3;
    alphas of at least 1e-3, so that no ray's weight sum lies just above the
    depth's 1e-8 clamp (where the depth's gradient is its last bits over
    1e-8 in any order of operations) -> (t, mask, alpha, rgb, nablas) as
    numpy."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 3.0, -1).astype(np.float32)
    alpha = np.maximum(rng.random((n, s)) ** 4, 1e-3).astype(np.float32)
    mask = rng.random((n, s)) > 0.15
    run = slice(s // 3, min(s // 3 + 3, s))
    alpha[2::3, run], mask[2::3, run] = 1.0, True
    mask[1:2] = False
    return (t, mask, alpha, rng.random((n, s, 3)).astype(np.float32),
            rng.normal(size=(n, s, 3)).astype(np.float32))


def neus_edge_inputs(n, s, seed):
    """K12's inputs at an edge shape, for inv_s COMPOSITE_EDGE_INV_S: rays
    whose surface passes within ~0.01 of one of their samples (masked in),
    nablas against the ray with noise, row 1 wholly masked, every third row
    from row 2 a run of three lanes from lane s // 3 whose alpha is exactly 1
    (sdf 0, nablas -1.2 d, 2.0 before the next lane: P rounds to 1, Q is
    below 1e-9) -> (t, mask, sdf, nablas, rays_d, rgb) as numpy."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 2.0 + 0.5, -1).astype(np.float32)
    at = rng.integers(0, s, n)
    surface = t[np.arange(n), at] + rng.normal(0, 0.005, n)
    sdf = (surface[:, None] - t + rng.normal(0, 0.01, (n, s))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    nablas = (-d[:, None, :] * (0.8 + 0.4 * rng.random((n, s, 1)))
              + rng.normal(0, 0.3, (n, s, 3))).astype(np.float32)
    mask = rng.random((n, s)) > 0.1
    mask[np.arange(n), at] = True
    mask[1:2] = False
    rows = np.arange(2, n, 3)
    for j in range(s // 3, min(s // 3 + 3, s - 1)):
        t[rows, j + 1:] += np.float32(2.0)
        sdf[rows, j], mask[rows, j] = 0.0, True
        nablas[rows, j] = -d[rows] * np.float32(1.2)
    return t, mask, sdf, nablas, d, rng.random((n, s, 3)).astype(np.float32)


def check_composite_edges(dev, widths=COMPOSITE_EDGE_S, rays=COMPOSITE_EDGE_N,
                          nan_shapes=COMPOSITE_NAN_SHAPES):
    """K6 and K12, forward and backward (cotangents of every output), against
    their plain versions at ``widths`` x ``rays`` samples, K6 with and
    without rgb and nablas, K12 with and without rgb (at the cos anneals in
    turn, inv_s COMPOSITE_EDGE_INV_S), each output the same bits on two calls; then a masked-in NaN
    alpha (K6) or sdf (K12) at ``nan_shapes`` (rays, width): the plain version's
    NaNs where it has them and its values elsewhere, the gradient NaN on
    that ray and within GRAD_REL on the others -> {kernel: (max_abs_err,
    tol)}."""
    import torch
    from neuralsim_torch.renderers.buffers import (volume_composite, volume_composite_bwd,
                                                   volume_composite_bwd_plain,
                                                   volume_composite_plain)
    from neuralsim_torch.renderers.neus_composite import (neus_composite, neus_composite_bwd,
                                                          neus_composite_bwd_plain,
                                                          neus_composite_plain)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    inv_s = torch.tensor(COMPOSITE_EDGE_INV_S, device=dev)
    e6, e6b, e12, e12b = [], [], [], []
    cases = [(n, s) for s in widths for n in rays]
    for n, s in cases:
        seed = 1000 * s + n  # each shape its own inputs, however the cases are split
        full = [T(a) for a in composite_edge_inputs(n, s, seed)]
        for payload in (True, False):
            a = full if payload else full[:3] + [None, None]
            cots = [cotangents(sh, seed + i, dev)
                    for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3)))]
            if not payload:
                cots[3:] = [None, None]
            what = f"rays={n} S={s}{'' if payload else ' without rgb and nablas'}"
            e6.append(compare(f"K6 edge {what}", volume_composite(*a),
                              volume_composite_plain(*a), 1e-5, 1e-6))
            same_bits(f"K6 edge {what}", lambda: volume_composite(*a))
            e6b.append(compare_rel(f"K6 bwd edge {what}", volume_composite_bwd(*a, *cots),
                                   volume_composite_bwd_plain(*a, *cots), GRAD_REL))
            same_bits(f"K6 bwd edge {what}", lambda: volume_composite_bwd(*a, *cots))
        t, mask, sdf, nablas, d, rgb = (T(v) for v in neus_edge_inputs(n, s, seed))
        anneal = K12_ANNEALS[seed % len(K12_ANNEALS)]
        for with_rgb in (True, False):
            a = (t, mask, sdf, nablas, d, anneal, inv_s, rgb if with_rgb else None)
            cots = [cotangents(sh, seed + 10 + i, dev) for i, sh in enumerate(
                ((n, s), (n,), (n,), (n, 3), (n, 3), (n, s)))]
            if not with_rgb:
                cots[3] = None
            what = f"rays={n} S={s} anneal={anneal:g}{'' if with_rgb else ' without rgb'}"
            e12.append(compare(f"K12 edge {what}", neus_composite(*a), neus_composite_plain(*a),
                               **K12_TOL))
            same_bits(f"K12 edge {what}", lambda: neus_composite(*a))
            e12b.append(compare_rel(f"K12 bwd edge {what}", neus_composite_bwd(*a, *cots),
                                    neus_composite_bwd_plain(*a, *cots), GRAD_REL))
            same_bits(f"K12 bwd edge {what}", lambda: neus_composite_bwd(*a, *cots))
    for seed, (n, s) in enumerate(nan_shapes, 500):
        t, mask, alpha, rgb, nablas = composite_edge_inputs(n, s, seed)
        alpha[0, s // 2], mask[0, s // 2] = np.nan, True
        a = [T(v) for v in (t, mask, alpha, rgb, nablas)]
        cots = [cotangents(sh, seed + i, dev)
                for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3)))]
        e6.append(check_nan_lane(f"K6 NaN lane rays={n} S={s}", volume_composite(*a),
                                 volume_composite_plain(*a), 1e-5, 1e-6))
        e6b.append(check_nan_grads(f"K6 bwd NaN lane rays={n} S={s}",
                                   volume_composite_bwd(*a, *cots),
                                   volume_composite_bwd_plain(*a, *cots)))
        same_bits(f"K6 NaN lane rays={n} S={s}", lambda: (*volume_composite(*a),
                                                          *volume_composite_bwd(*a, *cots)))
        t, mask, sdf, nablas, d, rgb = neus_edge_inputs(n, s, seed)
        sdf[0, s // 2], mask[0, s // 2] = np.nan, True
        a = (T(t), T(mask), T(sdf), T(nablas), T(d), 0.5, inv_s, T(rgb))
        cots = [cotangents(sh, seed + 10 + i, dev) for i, sh in enumerate(
            ((n, s), (n,), (n,), (n, 3), (n, 3), (n, s)))]
        e12.append(check_nan_lane(f"K12 NaN lane rays={n} S={s}", neus_composite(*a),
                                  neus_composite_plain(*a), **K12_TOL))
        e12b.append(check_nan_grads(f"K12 bwd NaN lane rays={n} S={s}",
                                    neus_composite_bwd(*a, *cots),
                                    neus_composite_bwd_plain(*a, *cots)))
        same_bits(f"K12 NaN lane rays={n} S={s}", lambda: (*neus_composite(*a),
                                                           *neus_composite_bwd(*a, *cots)))
    torch.cuda.synchronize()
    e6, e6b, e12, e12b = (max(e, default=0.0) for e in (e6, e6b, e12, e12b))
    log(f"K6 / K12 edges: {len(cases)} shapes and {len(nan_shapes)} NaN lanes, forward max abs "
        f"err {e6:.3g} / {e12:.3g}, backward {e6b:.3g} / {e12b:.3g}; each the same bits on two "
        f"calls")
    return {"volume_composite": (e6, 1e-6), "volume_composite.bwd": (e6b, GRAD_REL),
            "neus_composite": (e12, K12_TOL["atol"]), "neus_composite.bwd": (e12b, GRAD_REL)}


def check_nan_lane(name, got, want, rtol, atol):
    """A composite of rays whose first holds a NaN lane: every output NaN
    where the plain version's is and within the tolerance elsewhere; that
    ray's weight sum NaN."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")
        ok = ~torch.isnan(w)
        err = max(err, float((g[ok].float() - w[ok].float()).abs().max()) if ok.any() else 0.0)
    if not torch.isnan(got[1][0]):
        raise AssertionError(f"{name}: the NaN lane's weight sum is not NaN")
    log(f"check {name}: NaN where the plain version's, max_abs_err {err:.3g} elsewhere")
    return err


def check_nan_grads(name, got, want):
    """The gradients of a composite whose first ray holds a NaN lane: NaN in
    the first gradient's first row on both sides, within GRAD_REL on the
    other rays."""
    import torch
    if not (torch.isnan(got[0][0]).any() and torch.isnan(want[0][0]).any()):
        raise AssertionError(f"{name}: the NaN lane's ray has a finite gradient")
    return compare_rel(name, [None if g is None else g[1:] for g in got],
                       [None if w is None else w[1:] for w in want], GRAD_REL)


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
                                             converge_occ)

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
    frames = render_multi_frames("per-level", renderer, params_r, scene_r, occ)
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


def permuto_ray_points(n_rays, s, d, seed, n_instances=3):
    """[n_rays s, d] lattice inputs ordered as the pixel step's final query
    gives them: ``s`` depth-sorted samples on each chord of the box, ray
    after ray, the rays split evenly over ``n_instances`` vehicles, each ray
    with its vehicle's sigmoid(z) (drawn N(0, 0.5)) past xyz."""
    rng = np.random.default_rng(seed)
    a, b = rng.random((2, n_rays, 1, 3))
    u = np.sort(rng.random((n_rays, s, 1)), 1)
    x = np.empty((n_rays, s, d), np.float32)
    x[..., :3] = a + (b - a) * u
    if d > 3:
        z = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 0.5, (n_instances, d - 3))))
        x[..., 3:] = z[np.arange(n_rays) * n_instances // n_rays][:, None, :]
    return x.reshape(-1, d)


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
    each of ``sets`` ((label, encoding, table, x01)); the inputs' gradient
    must be the same bits on two calls. -> ({kernel: (max_abs_err, tol)},
    each set's inputs kept for timing)."""
    import torch
    from neuralsim_torch.fields.encodings import permuto as pm
    ef, eb, shapes = [], [], {}
    for k, (label, enc, table, x) in enumerate(sets):
        (N, d), C = x.shape, enc.out_dim
        a = (table, x, enc._res, enc._meta, enc.table_size)
        fs = sorted({nf for _, nf in enc.levels})
        what = (f"{label}: N={N} d={d}, {enc.n_levels} levels of F {'/'.join(map(str, fs))}, "
                f"res {enc.levels[0][0]:g}..{enc.levels[-1][0]:g}, T {enc.table_size}")
        for jac in (False, True):
            got, want = pm.permuto(*a, C, jac), pm.permuto_plain(*a, jac)
            ef.append(compare(f"K9 permuto {what} jac={jac}", got, want, **K9_TOL))
            differ = sum(int((g != w).sum()) for g, w in zip(got, want) if w is not None)
            log(f"check K9 permuto {what} jac={jac}: {differ} entries not bit-equal")
        d_out, d_jac = cotangents((N, C), 90 + k, dev), cotangents((N, C, 3), 95 + k, dev)
        for name, do, dj in (("both", d_out, d_jac), ("feats", d_out, None),
                             ("jac", None, d_jac)):
            gt, gx = pm.permuto_bwd(*a, do, dj)
            wt, wx = pm.permuto_bwd_plain(*a, do, dj)
            eb.append(compare_rel(f"K9 bwd {what} cotangents={name}, d table", [gt], [wt],
                                  GRAD_REL))
            if dj is None or do is not None:
                eb.append(compare_rel(f"K9 bwd {what} cotangents={name}, d x01", [gx], [wx],
                                      K9_DX_REL))
                if not torch.equal(gx, pm.permuto_bwd(*a, do, dj)[1]):
                    raise AssertionError(f"K9 bwd {what}: d x01 differs between two calls")
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
        table, x, res, meta, size = sh["args"]
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
            a = (table, x[:n], res, meta, size)
            out["permuto"].append(dict(
                shape=what, **card_ms(lambda: pm.permuto(*a, C, jac)),
                plain_ms=cuda_ms(lambda: pm.permuto_plain(*a, jac), reps=3), library_ms=None,
                # x01 and the table read, features (and jacobian) written
                bound=bound(n * d * 4 + tb + n * C * 4 * (4 if jac else 1),
                            n * L * (walk + interp + (jac_ops if jac else 0)))))
        a = sh["args"]
        out["permuto.bwd"].append(dict(
            shape=sh["what"] + ", cotangents of features and jacobian, d x01",
            **card_ms(lambda: pm.permuto_bwd(*a, d_out, d_jac)),
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
                                             converge_occ)

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
    # samples, d 11) on uniform points and in the step's own order (each
    # ray's depth-sorted samples, a warp a ray), at PermutoNeuSObj's ladder
    # (d 3, 12 levels to 512), at d 4 and at d 7
    n_final, n_ladder = 3 * MULTI_RAYS // 2 * 32, 3 * MULTI_RAYS // 2 * 24
    ray_set = permuto_set("vehicles, pixel step, ray samples", enc, n_final, 104, dev)
    ray_set = ray_set[:3] + (torch.from_numpy(permuto_ray_points(
        3 * MULTI_RAYS // 2, 32, 11, 104)).to(dev),)
    errs, shapes = check_permuto(dev, (
        permuto_set("vehicles, pixel step", enc, n_final, 100, dev), ray_set,
        permuto_set("PermutoNeuSObj ladder", PermutoEncoding(
            3, n_levels=12, base_res=4.0, max_res=512.0, log2_hashmap_size=17), n_final, 101,
            dev),
        permuto_set("d 4", PermutoEncoding(4, n_levels=12, base_res=4.0, max_res=256.0,
                                           log2_hashmap_size=17), n_final, 102, dev),
        permuto_set("d 7 (a latent of 4)", PermutoEncoding(
            7, n_levels=12, base_res=4.0, max_res=256.0, log2_hashmap_size=17), n_final, 103,
            dev)))

    # the render: 4 frames, a crop against the CPU path at its street depths
    H, W = (int(v) for v in scene_r.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    vehicles = [ob.obj_id for ob in renderer.objects]
    watch = {}
    kernels.reset_counts()
    with permuto_watch(watch):
        frames = render_multi_frames("permuto", renderer, params_r, scene_r, occ)
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
            log(f"kernel {name} (permuto path): {t['ms']:.4f} ms ({card_extra(t)[2:]}, plain "
                f"{t['plain_ms']:.4f}, bound {t['bound'][0]:.4f} by {t['bound'][1]}) at "
                f"{t['shape']}")
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
                                   named={"K9": ("permuto_",), **LATENT_PROFILED})
        for k, (n, busy, named) in prof.items():
            summary[f"permuto_{k}_step_device_kernels"] = n
            summary[f"permuto_{k}_step_busy_ms"] = busy
            summary.update({f"permuto_{k}_step_{label}_ms": v for label, v in named.items()})
    return dict(errs=errs, times=times, launches=launches, launches_render=launches_render,
                step_launches={k: v[0] for k, v in per_step.items()}, iters=PERMUTO_ITERS,
                n_frames=len(COMPOSE_FRAME_IDS), summary=summary)


# ---------------------------------------------------------------------------
# K13 (the latent lookup) and K14 (the stacked CP lines), on every path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def latent_calls(record):
    """While the block runs, append to ``record`` each K13 call on the card:
    (kind "fwd" or "bwd", a copy of its index or None, points, n instances,
    z, row stride: the cotangent's, or z for the forward)."""
    from neuralsim_torch.ops import latent_take as lt
    fwd, bwd = lt.latent_take, lt.latent_take_bwd

    def take(latents, idx, n_points):
        if latents.is_cuda:
            record.append(("fwd", None if idx is None else idx.clone(), n_points,
                           *latents.shape, latents.shape[1]))
        return fwd(latents, idx, n_points)

    def take_bwd(d_out, idx, n_instances):
        if d_out.is_cuda:
            record.append(("bwd", None if idx is None else idx.clone(), d_out.shape[0],
                           n_instances, d_out.shape[1], d_out.stride(0)))
        return bwd(d_out, idx, n_instances)

    lt.latent_take, lt.latent_take_bwd = take, take_bwd
    try:
        yield record
    finally:
        lt.latent_take, lt.latent_take_bwd = fwd, bwd


def bf16_cast_counter():
    """A TorchDispatchMode that records the shape of every tensor on the card
    cast to bf16 while it is active (``aten._to_copy`` to bf16, or a copy_
    into a bf16 tensor, from another dtype): the card path makes its bf16
    lines in K14 and casts nothing (``.casts``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.casts = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.ops.aten._to_copy.default:
                src, dst = args[0], kwargs.get("dtype")
            elif func is torch.ops.aten.copy_.default:
                src, dst = args[1], args[0].dtype
            else:
                src = dst = None
            if dst == torch.bfloat16 and src.is_cuda and src.dtype != torch.bfloat16:
                self.casts.append(tuple(src.shape))
            return func(*args, **kwargs)

    return Counter()


@contextlib.contextmanager
def no_plain_on_card(label):
    """The block may not call the plain K7 (its points, its update, the mean
    of the mask that K7's fraction replaces), K13 or K14 with tensors on the
    card (the card path launches the kernels or raises), nor cast a tensor on
    the card to bf16 (K14 writes the bf16 lines that K1 reads; counted by
    bf16_cast_counter): raises after it if it did. The one plain mean of a
    grid's ``init_state`` (a build, which ``train()`` runs inside the block)
    is not a step's, and is not counted."""
    from neuralsim_torch.accel import occ_grid as og
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.ops import latent_take as lt
    hits, building = [], []
    saved = [(m, n, getattr(m, n)) for m, n in (
        (lt, "latent_take_plain"), (lt, "latent_take_bwd_plain"),
        (lotd, "lotd_cp_lines_plain"), (lotd, "lotd_cp_lines_bwd_plain"),
        (og, "occ_voxel_points_plain"), (og, "occ_ema_update_plain"),
        (og, "occupied_fraction_plain"), (og.OccGridEma, "init_state"))]

    def counted(name, fn):
        def call(t, *a, **kw):
            if t.is_cuda and not building:
                hits.append(name)
            return fn(t, *a, **kw)
        return call

    def built(fn):
        def call(*a, **kw):
            building.append(1)
            try:
                return fn(*a, **kw)
            finally:
                building.pop()
        return call

    for m, n, fn in saved:
        setattr(m, n, built(fn) if n == "init_state" else counted(n, fn))
    casts = bf16_cast_counter()
    try:
        with casts:
            yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    if hits:
        raise AssertionError(f"the {label} path ran plain K7/K13/K14 on the card: "
                             f"{sorted(set(hits))}")
    if casts.casts:
        raise AssertionError(f"the {label} path cast {len(casts.casts)} tensors to bf16 on the "
                             f"card: {sorted(set(casts.casts))}")
    log(f"{label}: no plain K7/K13/K14 and no bf16 cast on the card")


def runs_of(idx):
    """The runs of equal values of a 1-D index tensor."""
    return 1 + int((idx[1:] != idx[:-1]).sum()) if idx.numel() else 0


def path_latent_cases(record, label):
    """K13's distinct calls in ``record`` (latent_calls) as check cases with
    the path's own index (its runs, its interleaving), points, n, z and row
    stride -> ([(label, n, z, idx, points, ld)], the cases to time: the
    largest forward, the largest and the smallest backward)."""
    cases, kinds, seen = [], {"fwd": [], "bwd": []}, set()
    for kind, idx, P, n, z, ld in record:
        key = (kind, P, n, z, ld, None if idx is None else (idx.numel(), str(idx.dtype)))
        if key in seen:
            continue
        seen.add(key)
        what = "no index" if idx is None else \
            f"{idx.numel()} indices x {P // idx.numel()} points, {runs_of(idx)} runs"
        case = (f"{label} {kind}: P={P} n={n} z={z} ld={ld}, {what}", n, z, idx, P, ld)
        cases.append(case)
        kinds[kind].append(case)
    if not kinds["fwd"] or not kinds["bwd"]:
        raise AssertionError(f"the {label} step launched no K13 forward or backward")
    by_p = lambda c: c[4]
    timed = {"latent_take": [max(kinds["fwd"], key=by_p)],
             "latent_take.bwd": sorted({c[0]: c for c in (max(kinds["bwd"], key=by_p),
                                                           min(kinds["bwd"], key=by_p))}.values(),
                                       key=by_p, reverse=True)}
    return cases, timed


LATENT_EDGE_COUNT = 14


def latent_edge_cases(dev):
    """K13's edge cases: indices outside [0, n), no index (z 8 and 5), int32
    and int64 indices a point and a ray, n 1, 8, 48 and 64 (interleaved,
    runs, shuffled), z 5 (a float a lane), 8 and 12 (three float4 lanes), a
    cotangent slice at a column that is not 16-byte aligned, n 64 at z 256
    (past the backward's shared sums: device atomics, two column chunks of
    lanes), one point."""
    import torch
    rng = np.random.default_rng(61)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = [
        ("indices in [-3, 7), n 3, per point", 3, 8, T(rng.integers(-3, 7, 100_003)), 100_003, 8),
        ("no index, 512 points", 3, 8, None, 512, 40),
        ("n 1, one int32 index a ray of 16", 1, 4,
         T(rng.integers(-1, 2, 4097).astype(np.int32)), 4097 * 16, 12),
        ("n 8, round-robin rays of 32", 8, 8, T(np.arange(6144) % 8), 6144 * 32, 40),
        ("n 48, runs of 7 points", 48, 8, T(np.repeat(np.arange(48), 7)), 48 * 7, 8),
        ("n 64, shuffled", 64, 8, T(rng.integers(0, 64, 50_000)), 50_000, 8),
        ("z 5, per point", 3, 5, T(rng.integers(0, 3, 33_333)), 33_333, 5),
        ("one point", 3, 8, T(np.array([2])), 1, 8),
        ("z 12, int32 runs of 100 rays of 8", 3, 12,
         T(np.repeat(np.arange(3), 100).astype(np.int32)), 300 * 8, 12),
        ("z 8, the cotangent's columns from 5 (not 16-byte aligned), int32 per point", 3, 8,
         T(rng.integers(0, 3, 20_000).astype(np.int32)), 20_000, 13),
        ("n 48, int64 runs of 3 rays of 5", 48, 8, T(np.repeat(np.arange(48), 3)), 48 * 15, 8),
        ("no index, z 5, 1,000 points", 3, 5, None, 1000, 5),
        ("n 64, z 256 (device atomics)", 64, 256, T(rng.integers(0, 64, 3000)), 3000, 256),
        ("n 8, z 8, rays of 32 in runs, 1,000 rays", 8, 8,
         T(np.repeat(rng.integers(0, 8, 100), 10)), 1000 * 32, 40)]
    assert len(cases) == LATENT_EDGE_COUNT
    return cases


def check_latent_take(dev, cases):
    """K13 against its plain version on ``cases`` [(label, n, z, idx, points,
    ld)]: the forward exact; the backward within GRAD_REL, its cotangent a
    column slice of a [points, ld] gradient (its last z columns), with the
    same bits on two calls (where n x z <= BWD_ORDERED_MAX_NZ, the sums kept
    in shared memory) -> (forward err, backward err)."""
    import torch
    from neuralsim_torch.ops.latent_take import (BWD_ORDERED_MAX_NZ, latent_take,
                                                 latent_take_bwd, latent_take_bwd_plain,
                                                 latent_take_plain)
    ef = eb = 0.0
    for i, (label, n, z, idx, P, ld) in enumerate(cases):
        lat = cotangents((n, z), 70 + i, dev)
        ef = max(ef, compare(f"K13 {label}", [latent_take(lat, idx, P)],
                             [latent_take_plain(lat, idx, P)], 0.0, 0.0, exact=True))
        g = cotangents((P, ld), 80 + i, dev)[:, ld - z:]
        got = latent_take_bwd(g, idx, n)
        if n * z <= BWD_ORDERED_MAX_NZ and not torch.equal(got, latent_take_bwd(g, idx, n)):
            raise AssertionError(f"K13 bwd {label}: two calls gave other bits")
        eb = max(eb, compare_rel(f"K13 bwd {label}", [got],
                                 [latent_take_bwd_plain(g, idx, n)], GRAD_REL))
    torch.cuda.synchronize()
    return ef, eb


def device_kernels(fn, reps: int = 20, done=bool):
    """The device kernels (memsets included) that ``reps`` calls of fn
    launch, by name, by the profiler, after a warm-up; a session whose names
    fail ``done`` (by default: one that records no kernel) is run again (as
    in prof_ms), twice at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if done(names):
            break
    return names


def check_latent_bwd_launches(dev, cases):
    """K13's backward is one kernel a call (no memset, no second kernel) at
    each of ``cases`` whose n x z <= BWD_ORDERED_MAX_NZ, by the profiler
    over 20 calls."""
    from neuralsim_torch.ops.latent_take import BWD_ORDERED_MAX_NZ, latent_take_bwd
    for label, n, z, idx, P, ld in cases:
        if n * z > BWD_ORDERED_MAX_NZ:
            continue
        g = cotangents((P, ld), 5, dev)[:, ld - z:]
        # the profiler in a long process can drop some of a session's
        # records, so: no other kernel, and no more than one a call
        names = device_kernels(lambda: latent_take_bwd(g, idx, n), reps=20)
        if not names or len(names) > 20 or \
                any("latent_take_bwd_kernel" not in k for k in names):
            raise AssertionError(f"K13 bwd {label}: 20 calls launched {sorted(set(names))} "
                                 f"({len(names)} kernels)")
    log(f"K13 bwd: one kernel a call at {len(cases)} cases")


# K14's edge ladders: (label, R_max, (R, F) levels, floats before the first
# level, between levels, after the last). The first has R 1 (both taps on
# one row: the upper one clamped, 2,048 taps a row), R 2, R 37 at F 5 and
# two levels of R_max 1,024 (1-2 taps a row), past a dense level's 250
# floats; the second odd F, R 3 (~511 taps a row), R 16 at F 1 and a level
# of R == R_max, with floats that no CP level owns before, between and after
# its levels (written as zeros by the backward); the third an R_max that is
# not a multiple of 4 (the forward's thread a position) at F 2, 8 and 3, odd
# offsets
CP_LINES_EDGES = (("edge ladder: R 1, 2, 37 (F 5), 1,024 x 2", 1024,
                   ((1, 3), (2, 4), (37, 5), (1024, 4), (1024, 3)), 250, 0, 0),
                  ("edge ladder: odd F, R 3, 16 (F 1), 100 (F 9), 512 == R_max (F 5), gaps",
                   512, ((3, 7), (16, 1), (100, 9), (512, 5)), 1000, 777, 3000),
                  ("edge ladder: R_max 37, F 2, 8, 3, odd offsets", 37,
                   ((2, 2), (9, 8), (37, 3)), 5, 3, 1))


def cp_lines_sets(dev, encodings):
    """K14's sets [(label, table, plan)]: each of ``encodings`` [(label, a
    stacked LoTDEncoding on the card)], and the ladders of CP_LINES_EDGES."""
    import torch
    from neuralsim_torch.fields.encodings.lotd import cp_lines_plan
    sets = [(label, e.table.detach(), e.cp_lines_plan()) for label, e in encodings]
    for i, (label, rmax, ladder, before, between, after) in enumerate(CP_LINES_EDGES):
        levels, off = [], before
        for R, F in ladder:
            levels.append((R, F, off))
            off += 3 * R * F + between
        n_table = off - between + after
        table = torch.from_numpy(np.random.default_rng(62 + i).normal(1.0, 0.3, n_table)
                                 .astype(np.float32)).to(dev)
        sets.append((label, table, cp_lines_plan(levels, rmax, n_table).to(dev)))
    return sets


def lines_cotangent(plan, seed, dev):
    """A [3, F_cp, R_max] cotangent laid out as K1's backward leaves it: the
    transposed view of a [3, R_max, F_cp] buffer."""
    return cotangents((3, plan.lo.shape[1], plan.n_cols), seed, dev).transpose(1, 2)


def check_cp_lines(dev, sets):
    """K14 against its plain version: the forward's float32 lines bit-equal
    to the plain lines and its bf16 lines to the plain lines cast to bf16, in
    one launch (its counter; the card tests count the device kernels by the
    profiler); the backward within GRAD_REL (with the same bits on two calls)
    at a cotangent in K1 bwd's layout -> (forward err, backward err)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    K14 = lotd.K14
    ef = eb = 0.0
    for i, (label, table, plan) in enumerate(sets):
        got, want = lotd.lotd_cp_lines(table, plan), lotd.lotd_cp_lines_plain(table, plan)
        tag = f"K14 {label} F_cp={plan.n_cols} R_max={plan.lo.shape[1]}"
        if got[1].dtype != torch.bfloat16:
            raise AssertionError(f"{tag}: the second lines should be bf16")
        ef = max(ef, compare(tag, got, want, 0.0, 0.0, exact=True))   # want[1]: want[0] cast
        n0 = K14.launches
        lotd.lotd_cp_lines(table, plan)
        if K14.launches != n0 + 1:
            raise AssertionError(f"{tag}: K14 should be one launch a call")
        g = lines_cotangent(plan, 90 + i, dev)
        got = lotd.lotd_cp_lines_bwd(g, table.numel(), plan)
        if not torch.equal(got, lotd.lotd_cp_lines_bwd(g, table.numel(), plan)):
            raise AssertionError(f"K14 bwd {label}: two calls gave other bits")
        eb = max(eb, compare_rel(f"K14 bwd {label}", [got],
                                 [lotd.lotd_cp_lines_bwd_plain(g, table.numel(), plan)],
                                 GRAD_REL))
    torch.cuda.synchronize()
    return ef, eb


def timed_with_library(fn, plain, library, **kw):
    """card_ms of fn, the plain version's time, and each library call's back
    to back and queued; ``library_ms`` is the fastest back to back."""
    lib = {k: dict(ms=cuda_ms(f), queued_ms=cuda_ms(f, queued=True)) for k, f in library.items()}
    return dict(**card_ms(fn), plain_ms=cuda_ms(plain, reps=5),
                library_ms=min((v["ms"] for v in lib.values()), default=None),
                library_calls=lib, **kw)


def time_latent_take(timed):
    """K13 and its backward at ``timed`` (path_latent_cases), beside their
    plain versions and the PyTorch calls for the same function at the same
    index expanded to the points: index_select; index_add_ into zeros,
    F.embedding's backward (embedding_dense_backward) and the sort-based
    index_put of autograd's latents[idx] -> {kernel: [timing, ...]}."""
    import torch
    from neuralsim_torch.ops.latent_take import (latent_take, latent_take_bwd,
                                                 latent_take_bwd_plain, latent_take_plain,
                                                 point_rows)
    out = {}
    for name, cases in timed.items():
        for label, n, z, idx, P, ld in cases:
            dev = torch.device("cuda")
            rows = point_rows(idx, P, n, dev)
            idx_bytes = 0 if idx is None else idx.numel() * idx.element_size()
            if name == "latent_take":
                lat = cotangents((n, z), 71, dev)
                out.setdefault(name, []).append(timed_with_library(
                    lambda: latent_take(lat, idx, P), lambda: latent_take_plain(lat, idx, P),
                    {"index_select": lambda: torch.index_select(lat, 0, rows)}, shape=label,
                    # the index and the latents read, the rows written
                    bound=bound(idx_bytes + n * z * 4 + P * z * 4, P * z)))
                continue
            g = cotangents((P, ld), 81, dev)[:, ld - z:]
            zeros = lambda: torch.zeros((n, z), device=dev)
            out.setdefault(name, []).append(timed_with_library(
                lambda: latent_take_bwd(g, idx, n), lambda: latent_take_bwd_plain(g, idx, n),
                {"index_add_": lambda: zeros().index_add_(0, rows, g),
                 "embedding_dense_backward": lambda: torch.ops.aten.embedding_dense_backward(
                     g, rows, n, -1, False),
                 "index_put_ (sort-based)": lambda: zeros().index_put_((rows,), g,
                                                                      accumulate=True)},
                shape=label,
                # the index and the cotangent's z columns read, d latents written
                bound=bound(idx_bytes + P * z * 4 + n * z * 4, P * z)))
    return out


def interpolated_lines(table, plan):
    """The stacked lines by one F.interpolate(mode="linear",
    align_corners=True) a level: the same positions as K14's plan, rounded
    otherwise (an aside to the kernels line, no port path)."""
    import torch
    import torch.nn.functional as Fn
    cols = []
    for _, offset, R, F, _, _ in plan.levels.tolist():
        seg = table[offset:offset + 3 * R * F].view(3, R, F).transpose(1, 2)
        cols.append(Fn.interpolate(seg, size=plan.lo.shape[1], mode="linear",
                                   align_corners=True))
    return torch.cat(cols, dim=1)


def time_cp_lines(sets):
    """K14 and its backward at ``sets`` (cp_lines_sets), beside their plain
    versions; no one PyTorch call computes the stack (library none), the
    per-level F.interpolate sum as an aside with its max abs difference ->
    {kernel: [timing, ...]}."""
    from neuralsim_torch.fields.encodings import lotd
    out = {}
    for i, (label, table, plan) in enumerate(sets):
        L, Rmax = plan.lo.shape
        Fcp, E = plan.n_cols, plan.tap_j.numel()
        shape = f"{label}: L={L} F_cp={Fcp} R_max={Rmax}, {plan.n_entries} CP entries"
        lines = lotd.lotd_cp_lines(table, plan)[0]
        out.setdefault("lotd_cp_lines", []).append(dict(
            **card_ms(lambda: lotd.lotd_cp_lines(table, plan)),
            plain_ms=cuda_ms(lambda: lotd.lotd_cp_lines_plain(table, plan), reps=5),
            library_ms=None, shape=shape,
            interpolate_ms=cuda_ms(lambda: interpolated_lines(table, plan)),
            interpolate_max_abs_err=float((interpolated_lines(table, plan) - lines)
                                          .abs().max()),
            # the CP segments, taps (int32 lo, f32 w) and metadata read, the
            # lines written in f32 and bf16; a lerp (4 operations) a value
            bound=bound(plan.n_entries * 4 + L * Rmax * 8 + L * 24 + 3 * Fcp * Rmax * (4 + 2),
                        3 * Fcp * Rmax * 4)))
        g = lines_cotangent(plan, 95 + i, dev=table.device)
        out.setdefault("lotd_cp_lines.bwd", []).append(dict(
            **card_ms(lambda: lotd.lotd_cp_lines_bwd(g, table.numel(), plan)),
            plain_ms=cuda_ms(lambda: lotd.lotd_cp_lines_bwd_plain(g, table.numel(), plan),
                             reps=5),
            library_ms=None, shape=shape + " (cotangent in K1 bwd's layout)",
            # the cotangent and the CSR read, the CP entries written; a
            # multiply-add for each tap of every stacked value
            bound=bound(3 * Fcp * Rmax * 4 + E * 8 + (plan.rowptr.numel() + L * 6) * 4
                        + plan.n_entries * 4, 12 * Fcp * Rmax)))
    return out


# ---------------------------------------------------------------------------
# Phase 13: checkpoints and the evaluation tools (WAYMO_DEMO_MULTI, stacked)
# ---------------------------------------------------------------------------

def state_tensors(state) -> dict:
    """Every tensor and number of a train state, by name: the models'
    parameters and buffers, each Adam's moments and count, it, skips and
    every grid's values, mask and occupied fraction."""
    import torch
    out = {f"param {k}": v for k, v in state.params.state_dict().items()}
    for mid, opt in state.opt.items():
        out.update({f"{mid} mu {i}": t for i, t in enumerate(opt.mu)})
        out.update({f"{mid} nu {i}": t for i, t in enumerate(opt.nu)})
        out[f"{mid} count"] = opt.count
    out["skips"], out["it"] = state.skips, torch.tensor(state.it)
    for role, st in (state.occ or {}).items():
        out.update({f"occ {role} val": st.val, f"occ {role} mask": st.mask,
                    f"occ {role} frac": st.frac})
    return out


def frame_bits(frame) -> dict:
    """A rendered frame's outputs and every source's share, as bytes."""
    out = {k: frame[k].cpu().numpy().tobytes() for k in CROP_KEYS}
    for name, sub in frame["per_obj"].items():
        out.update({f"{name} {k}": v.cpu().numpy().tobytes() for k, v in sub.items()})
    return out


def check_eval_chunk(dev, renderer, params, scene, occ):
    """K8 and K5b at one EVAL_CHUNK-ray chunk of frame 0 (the evaluation's
    chunk; the earlier phases render 4,096): K8 on the chunk's merged buffer
    ([8,192, 168] at full width) within K8_TOL and the same bits twice, K5b
    on each of the chunk's merges exactly. -> (K8's error, K5b's, the
    merges' shapes)."""
    import torch
    import neuralsim_torch.fields.neus as neus
    from neuralsim_torch.ops.segment import (cross_source_vw, cross_source_vw_plain,
                                             merge_sorted_samples_plain)
    from neuralsim_torch.scene.observers import camera_get_all_rays
    frozen = scene.slice_at(0)
    H, W = (int(v) for v in scene.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    o, d = camera_get_all_rays(frozen, COMPOSE_CAM, H, W)
    o, d = o[:EVAL_CHUNK].contiguous(), d[:EVAL_CHUNK].contiguous()
    merges, merge = [], neus.merge_sorted_samples

    def recorded(*a):
        merges.append(a)
        return merge(*a)

    neus.merge_sorted_samples = recorded
    try:
        with torch.no_grad():
            mb = renderer.ray_query(params, frozen, o, d, occ_states=occ,
                                    return_buffer=True)["merged_buffer"]
    finally:
        neus.merge_sorted_samples = merge
    args = (mb["t"], mb["mask"], mb["alpha"])
    N, L = mb["t"].shape
    if N != EVAL_CHUNK:
        raise AssertionError(f"the merged buffer has {N} rays, not {EVAL_CHUNK}")
    e8 = compare(f"K8 cross_source_vw evaluation chunk rays={N} L={L}",
                 [cross_source_vw(*args)], [cross_source_vw_plain(*args)], **K8_TOL)
    same_bits("K8 cross_source_vw evaluation chunk", lambda: cross_source_vw(*args))
    e5 = max(compare(f"K5b merge_sorted_samples evaluation chunk {tuple(a[0].shape)} + "
                     f"{tuple(a[1].shape)}", list(merge(*a)),
                     list(merge_sorted_samples_plain(*a)), 0.0, 0.0, exact=True)
             for a in merges)
    shapes = sorted({(a[0].shape[0], a[0].shape[1], a[1].shape[1]) for a in merges})
    log(f"evaluation chunk: K8 at [{N}, {L}], K5b at {shapes} (rays, A, B)")
    return e8, e5, shapes


def score_errors(got, want) -> dict:
    """{score: |card - CPU|} (relative where EVAL_REL_TOL holds it) of two
    results of evaluate_multi or eval_lidar_frames, per frame, per source
    and per class."""
    rel = ("mask_bce", "mean_depth", "rmse", "mae")
    errs = {}
    pairs = list(zip(got["per_frame"], want["per_frame"]))
    pairs += list(zip(got.get("per_object", []), want.get("per_object", [])))
    pairs += [(got["per_class"][c], w) for c, w in want.get("per_class", {}).items()]
    for g, w in pairs:
        if set(g) != set(w):
            raise AssertionError(f"card and CPU scores have other keys: {sorted(set(g) ^ set(w))}")
        for k, v in w.items():
            if isinstance(v, str) or v is None or k in ("frame", "n_objects"):
                if g[k] != v:
                    raise AssertionError(f"score {k}: {g[k]} on the card, {v} on the CPU")
                continue
            e = abs(g[k] - v)
            if k in rel or k.startswith("chamfer"):
                e /= max(abs(v), 1e-12)
            errs[k] = max(errs.get(k, 0.0), e)
    return errs


def check_score_errors(label, errs, n_pixels):
    log(f"{label} card vs CPU at the CPU path's sample depths: "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(errs.items())))
    for k, e in errs.items():
        if k.startswith("psnr"):
            tol = EVAL_PSNR_TOL
        elif k == "ssim":
            tol = EVAL_SSIM_TOL
        elif k in ("mask_acc", "hit_recall", "hit_frac", "miss_in_cuboid_frac",
                   "miss_out_cuboid_frac"):
            tol = EVAL_PIXELS_TOL / n_pixels
        elif k == "pixels_dominant":
            tol = EVAL_PIXELS_TOL
        elif k in ("vis_mass", "road_vis_mass", "road_dominant_frac"):
            tol = EVAL_MASS_TOL
        else:
            tol = EVAL_REL_TOL
        if e > tol:
            raise AssertionError(f"{label}: {k} {e:.3g} apart on the card and the CPU "
                                 f"(limit {tol:g})")


def check_eval_scores(cfg, exp, trainer, state, scene, loader):
    """One frame's scores and its LiDAR scores on the card (the loaded build
    ``trainer``, ``state``) against the CPU path loaded from the same
    checkpoint (``eval_multi.load_for_eval`` on the CPU), at the CPU path's
    sample depths. -> the largest errors."""
    from types import SimpleNamespace
    from neuralsim_torch.tools.eval_lidar import ComposeLidarAdapter, eval_lidar_frames
    from neuralsim_torch.tools.eval_multi import evaluate_multi, load_for_eval
    from neuralsim_torch.utils.misc import set_eval_iteration
    t0 = time.perf_counter()
    scene_c, rend_c, params_c, occ_c, loader_c, _ = load_for_eval(
        {**cfg, "resume_dir": exp, "ckpt": "final"}, "cpu")
    set_eval_iteration(state.params.values(), state.it)
    space = params_c[rend_c.scene_models["cr"][0]].space
    aabb = (space.aabb_min.numpy(), space.aabb_max.numpy())
    kw = dict(cam_id=COMPOSE_CAM, frames=[0], downscale=EVAL_CPU_DOWNSCALE,
              rayschunk=EVAL_CPU_CHUNK)
    rec, lrec = [], []
    with sample_placements(SimpleNamespace(renderer=rend_c), record=rec):
        cpu = evaluate_multi(scene_c, rend_c, params_c, loader_c, occ=occ_c, **kw)
    with sample_placements(SimpleNamespace(renderer=rend_c), record=lrec):
        lcpu = eval_lidar_frames(scene_c, ComposeLidarAdapter(scene_c, rend_c), params_c,
                                 loader_c, frames=[0], occ=occ_c, cr_aabb=aabb)
    with no_plain_on_card("evaluation at the CPU path's depths"):
        with sample_placements(SimpleNamespace(renderer=trainer.renderer), replay=rec):
            card = evaluate_multi(scene, trainer.renderer, state.params, loader, occ=state.occ,
                                  **kw)
        with sample_placements(SimpleNamespace(renderer=trainer.renderer), replay=lrec):
            lcard = eval_lidar_frames(scene, ComposeLidarAdapter(scene, trainer.renderer),
                                      state.params, loader, frames=[0], occ=state.occ,
                                      cr_aabb=aabb)
    H, W = (-(-int(v) // EVAL_CPU_DOWNSCALE)
            for v in scene.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    n_beams = len(loader.lidars[(loader.lidar_ids[0], 0)]["ranges"])
    log(f"evaluation card vs CPU ({time.perf_counter() - t0:.1f} s): frame 0 at {H}x{W}, "
        f"CPU {json.dumps(cpu['per_frame'][0])}, card {json.dumps(card['per_frame'][0])}; "
        f"LiDAR ({n_beams} beams) CPU {json.dumps(lcpu['per_frame'])}, card "
        f"{json.dumps(lcard['per_frame'])}")
    if not lcpu["per_frame"]:
        raise AssertionError("the trained street has fewer than 10 LiDAR hits on the CPU path")
    errs = score_errors(card, cpu)
    check_score_errors("eval_multi frame 0", errs, H * W)
    lerrs = score_errors(lcard, lcpu)
    check_score_errors("eval_lidar frame 0", lerrs, n_beams)
    return {"frame": errs, "lidar": lerrs}


def checkpoint_eval_phase(dev):
    """Phase 13: train into an exp dir, the checkpoint round trip, the
    evaluation tools from the exp dir and against the CPU path."""
    import tempfile
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI, at_num_iters
    from neuralsim_torch.tools import eval_lidar, eval_multi
    from neuralsim_torch.tools.build import build_multi_trainer, render_multi_frame
    from neuralsim_torch.tools.train_multi import main_function
    from neuralsim_torch.utils.checkpoint import CheckpointIO

    def counts():
        torch.cuda.synchronize()
        return {k.name: k.launches for k in kernels.KERNELS.values()}

    summary, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        exp = os.path.join(tmp, "exp")
        cfg = at_num_iters(WAYMO_DEMO_MULTI, CKPT_ITERS)
        cfg["exp_dir"] = exp
        cfg["training"]["i_log"] = 16
        # 1. training into the exp dir through the driver
        kernels.reset_counts()
        t0 = time.perf_counter()
        with no_plain_on_card("train_multi.main_function"):
            out = main_function(cfg)
        launches["train"] = counts()
        summary["ckpt_train_s"] = time.perf_counter() - t0
        it_ms = np.asarray(out["iter_s"]) * 1e3
        losses = [r["loss_total"] for r in out["log"]]
        log(f"train_multi.main_function: {CKPT_ITERS} iterations (schedule of "
            f"{CKPT_ITERS}: street anneal {cfg['assetbank_cfg']['Street']['model_params']['inv_s_anneal_start_it']}"
            f"..{CKPT_ITERS}) in {summary['ckpt_train_s']:.1f} s, iteration median "
            f"{np.median(it_ms):.1f} ms, losses {losses}, skips {out['skips_total']}, exp dir "
            f"{sorted(os.listdir(exp))}, checkpoints {sorted(os.listdir(os.path.join(exp, 'ckpts')))}")
        if out["skips_total"] or not all(math.isfinite(v) for v in losses):
            raise AssertionError("the driver's run skipped a step or logged a non-finite loss")
        for name in MULTI_WATCHED + CKPT_TRAIN_KERNELS:
            if launches["train"][name] <= 0:
                raise AssertionError(f"kernel {name} never launched in the driver's run")
        # 2. the checkpoint round trip: a fresh build, its frame rendered
        # before the load (filling K14's lines cache and K3's scratch from
        # the fresh tables), then after it: every tensor and the frame the
        # trained state's bits
        trained, trainer = out["state"], out["trainer"]
        ref = render_multi_frame(trainer.renderer, trained.params, out["scene"], 0, COMPOSE_CAM,
                                 trained.occ, RAYSCHUNK)
        t0 = time.perf_counter()
        scene2, _, trainer2, state2, samplers2 = build_multi_trainer(cfg, pretrain=False)
        before = render_multi_frame(trainer2.renderer, state2.params, scene2, 0, COMPOSE_CAM,
                                    state2.occ, RAYSCHUNK)
        CheckpointIO(os.path.join(exp, "ckpts")).load(state2, "final")
        summary["ckpt_load_s"] = time.perf_counter() - t0
        want, got = state_tensors(trained), state_tensors(state2)
        if set(want) != set(got):
            raise AssertionError(f"the loaded state has other tensors: {sorted(set(want) ^ set(got))}")
        differ = [k for k, v in want.items()
                  if got[k].device != v.device or got[k].dtype != v.dtype
                  or got[k].cpu().numpy().tobytes() != v.cpu().numpy().tobytes()]
        if differ:
            raise AssertionError(f"the loaded state differs from the saved one in {differ[:8]}")
        with no_plain_on_card("render after the load"):
            after = render_multi_frame(trainer2.renderer, state2.params, scene2, 0, COMPOSE_CAM,
                                       state2.occ, RAYSCHUNK)
        rb, ab, bb = frame_bits(ref), frame_bits(after), frame_bits(before)
        if rb != ab:
            raise AssertionError("frame 0 of the loaded state differs from the trained state's: "
                                 f"{[k for k in rb if rb[k] != ab.get(k)]}")
        if rb["rgb_volume"] == bb["rgb_volume"]:
            raise AssertionError("the fresh build renders the trained frame before the load")
        log(f"checkpoint round trip: {len(want)} tensors bit-equal after the load into a fresh "
            f"build ({summary['ckpt_load_s']:.1f} s with the build and a frame), frame 0 the "
            f"trained state's bits in all {len(rb)} outputs (the fresh tables' frame differs)")
        e8, e5, merge_shapes = check_eval_chunk(dev, trainer2.renderer, state2.params, scene2,
                                                state2.occ)
        # 3. the tools from the exp dir
        ecfg = {**cfg, "resume_dir": exp}
        kernels.reset_counts()
        t0 = time.perf_counter()
        with no_plain_on_card("eval_multi"):
            ev = eval_multi.main_function({**ecfg, "eval": {"frames": EVAL_FRAMES,
                                                            "rayschunk": EVAL_CHUNK}})
        launches["eval_multi"] = counts()
        summary["eval_multi_s"] = time.perf_counter() - t0
        kernels.reset_counts()
        t0 = time.perf_counter()
        with no_plain_on_card("eval_lidar"):
            lv = eval_lidar.main_function({**ecfg, "renderer": {**cfg["renderer"], "type": "multi"},
                                           "eval": {"frames": EVAL_FRAMES}})
        launches["eval_lidar"] = counts()
        summary["eval_lidar_s"] = time.perf_counter() - t0
        log(f"eval_multi from the exp dir: {summary['eval_multi_s']:.2f} s, frames {EVAL_FRAMES} "
            f"at {EVAL_CHUNK} rays a chunk, mean {json.dumps(ev['mean'])}, per class "
            f"{json.dumps(ev['per_class'])}, files {sorted(os.listdir(os.path.join(exp, 'eval_multi')))}")
        log(f"eval_lidar from the exp dir: {summary['eval_lidar_s']:.2f} s, mean "
            f"{json.dumps(lv['mean'])}")
        for label, names in (("eval_multi", EVAL_FRAME_KERNELS), ("eval_lidar", EVAL_LIDAR_KERNELS)):
            log(f"{label} launches {launches[label]}")
            missing = [n for n in names if launches[label][n] <= 0]
            if missing:
                raise AssertionError(f"{label} never launched {missing}")
        if launches["eval_multi"]["lotd_cp_lines"] != EVAL_K14_LAUNCHES \
                or launches["eval_lidar"]["cross_source_vw"]:
            raise AssertionError("eval_multi should make the stacked lines once an encoding, and "
                                 "eval_lidar composite the street alone (K12, no K8)")
        scores = [v for v in ev["mean"].values() if v is not None] + list(lv["mean"].values())
        if not lv["per_frame"] or not all(math.isfinite(v) for v in scores):
            raise AssertionError("the evaluation's scores are not finite, or no LiDAR frame hit")
        # 4. one frame card vs CPU from the same checkpoint
        score_errs = check_eval_scores(cfg, exp, trainer2, state2, scene2,
                                       samplers2["pixel"].loader)
    summary.update({"ckpt_iterations": CKPT_ITERS,
                    "ckpt_iteration_ms_median": float(np.median(it_ms)),
                    "eval_multi_mean": ev["mean"], "eval_lidar_mean": lv["mean"],
                    "eval_card_vs_cpu": score_errs, "eval_chunk_merges": merge_shapes})
    return dict(summary=summary, launches=launches,
                errs={"cross_source_vw": (e8, K8_TOL["atol"]), "neus_upsample.merge": (e5, 0.0)})


class SingleStepTrainer:
    """The single-scene Trainer behind the multi-object trainer's argument
    order (``draw_noise(step_type, n, generator, it)``, ``compute_losses(params,
    batch, it, noise, step_type, occ, cam_id)``), so that the shared loop and
    the multi-object checks drive it; any other attribute, read or written,
    is the Trainer's own."""

    def __init__(self, trainer):
        object.__setattr__(self, "inner", trainer)

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def __setattr__(self, k, v):
        setattr(self.inner, k, v)

    def draw_noise(self, step_type, n, generator, it=None):
        return self.inner.draw_noise(n, generator, it, step_type)

    def compute_losses(self, params, batch, it, noise, step_type="pixel", occ=None,
                       cam_id=None):
        return self.inner.compute_losses(params, batch, it, noise, occ, step_type, cam_id)


def k3_4d_points(n, seed):
    """4-D points drawn apart from each other: a point on the unit shell
    moved into [0, 1]^3 (one coordinate on a face, 0 or 1) beside the
    inverse radius in [1e-4, 1] (log-uniform in the radius); the first 625
    (fewer where n is smaller) every combination over the axes of 0, 1, one
    ulp below 1, -0.25 and 1.5."""
    import itertools
    rng = np.random.default_rng(seed)
    m = max(n, 625)
    x = rng.random((m, 4)).astype(np.float32)
    x[np.arange(m), rng.integers(0, 3, m)] = rng.integers(0, 2, m)
    x[:, 3] = np.exp(-rng.uniform(0.0, np.log(1e4), m))
    edges = np.array([0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)), -0.25, 1.5],
                     np.float32)
    x[:625] = np.array(list(itertools.product(edges, repeat=4)), np.float32)
    return x[:n]


def k3_4d_ray_points(n, seed, samples=64):
    """4-D points in the order a pixel step hands them to K3-4D: rays from
    within 2 m of the centre of the street box (half extents K3_4D_RAY_BOX),
    where the cameras ride, in random directions, each sampled as the
    distant field samples it (``samples`` depths linear in inverse depth from
    the box's exit to 1e4 times it, jittered), contracted by the box's
    shells (contract_inverted_cuboid, the shell point moved into [0, 1]^3
    beside 1 / rho) and flattened [rays, samples], so that the lanes of a
    warp hold neighbouring samples of one ray; the first ``n`` of them."""
    import torch
    from neuralsim_torch.fields.spatial import contract_inverted_cuboid
    rng = np.random.default_rng(seed)
    rays = -(-n // samples)
    half = np.float32(K3_4D_RAY_BOX)
    o = rng.uniform(-2.0, 2.0, (rays, 3)).astype(np.float32)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        exit_t = np.where(d != 0, (np.sign(d) * half - o) / d, np.inf).min(-1)
    near = np.maximum(exit_t, 1e-3).astype(np.float32)[:, None]
    u = np.linspace(0.0, 1.0, samples, dtype=np.float32)[None]
    u = np.clip(u + (rng.random((rays, samples), np.float32) - 0.5) / samples, 0.0, 1.0)
    inv_t = (1.0 / near) * (1.0 - u) + (1.0 / (near * 1e4)) * u
    x = o[:, None] + (1.0 / inv_t)[..., None] * d[:, None]
    c = contract_inverted_cuboid(torch.from_numpy(x.astype(np.float32)),
                                 torch.zeros(3), torch.from_numpy(half)).numpy()
    c = np.concatenate([c[..., :3] * 0.5 + 0.5, c[..., 3:]], -1).reshape(-1, 4)
    return np.ascontiguousarray(c[:n], dtype=np.float32)


@contextlib.contextmanager
def k3_4d_recorded(record):
    """Record the 4-D points that K3-4D's wrapper is handed (``record["x"]``)
    and the cotangent that its backward's is (``record["d_out"]``), copied,
    while the block runs; the calls themselves run as they are."""
    from neuralsim_torch.fields.encodings import lotd
    fwd, bwd = lotd.lotd_grid, lotd.lotd_grid_bwd

    def grid(table, pos01, *a, **kw):
        if pos01.shape[1] == 4:
            record["x"] = pos01.detach().clone()
        return fwd(table, pos01, *a, **kw)

    def grid_bwd(n_table, pos01, meta, d_out, *a, **kw):
        if pos01.shape[1] == 4:
            record["d_out"] = d_out.clone()
        return bwd(n_table, pos01, meta, d_out, *a, **kw)

    lotd.lotd_grid, lotd.lotd_grid_bwd = grid, grid_bwd
    try:
        yield
    finally:
        lotd.lotd_grid, lotd.lotd_grid_bwd = fwd, bwd


def capture_k3_4d(scene, trainer, state, samplers, dev):
    """One pixel step of STREETSURF_RAYS rays off the grid's cadence, no
    parameter moved: the points that the distant encoding hands K3-4D (the
    flattened [rays, samples] of its ladder) and the cotangent that reaches
    its backward -> (x [N, 4], d_out [C, N])."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(17)
    _, pbatch, cam = multi_batches(scene, samplers, dev, STREETSURF_RAYS, STREETSURF_BEAMS)
    it = state.it if state.it % 16 else state.it + 1
    noise = trainer.draw_noise("pixel", pbatch["rays_fidx"].shape[0], gen, it)
    record = {}
    with k3_4d_recorded(record):
        total, _ = trainer.compute_losses(state.params, pbatch, it, noise, "pixel", state.occ,
                                          cam)
        total.backward()
    torch.cuda.synchronize()
    state.params.zero_grad(set_to_none=True)
    if set(record) != {"x", "d_out"}:
        raise AssertionError("a StreetSurf pixel step should hand K3-4D its points and cotangent")
    return record["x"], record["d_out"]


def check_k3_4d(dev, enc, n_path, path=None):
    """K3 in four dimensions (``lotd_grid4``) and its backward against their
    plain versions: on the distant field's levels at the points ``path`` (x
    [n, 4], d_out [C, n]: a pixel step's own, capture_k3_4d; without it,
    ``n_path`` k3_4d_ray_points) and at ``n_path`` k3_4d_points, each with the
    field's own table and with a table of N(0, 1) values; at K3_4D_EDGE_N
    edge sets of both kinds; on a 4-D ladder of F 4 whose two levels are
    staged (the wide kernel), and with no copies (each level read from the
    table, added to it a float at a time); on a ladder of F 1 (the backward's
    pairs of rows as float2). The forward bit-equal, the table gradient
    within GRAD_REL of its largest entry. Raises where the distant field's
    plans stage a level -> ({kernel: (max_abs_err, tol)}, the inputs for
    timing: both point sets with their cotangents)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    if enc.input_dim != 4 or enc.grid_fwd_plan.n_shared \
            or not isinstance(enc.grid_bwd_plan, lotd.Grid4BwdPlan) \
            or not enc.grid_bwd_plan.n_inter:
        raise AssertionError(f"the distant encoding should be 4-D with no level staged and "
                             f"a gradient scratch: {enc.grid_fwd_plan}, {enc.grid_bwd_plan}")
    wide = lotd.LoTDEncoding([(4, 4, "dense"), (16, 4, "hash")], input_dim=4,
                             log2_hashmap_size=12).to(dev)
    if wide.grid_fwd_plan.stage_mask != 0b11 or not isinstance(wide.grid_bwd_plan,
                                                                lotd.Grid4BwdPlan):
        raise AssertionError(f"the F 4 ladder should stage both levels and keep none private: "
                             f"{wide.grid_fwd_plan}, {wide.grid_bwd_plan}")
    one = lotd.LoTDEncoding([(8, 1, "dense"), (32, 1, "hash"), (64, 1, "hash")], input_dim=4,
                            log2_hashmap_size=14).to(dev)
    normal = lambda e, seed: torch.from_numpy(np.random.default_rng(seed).normal(
        size=e.total_params).astype(np.float32)).to(dev)
    table = normal(enc, 500)
    T = lambda a: torch.from_numpy(a).to(dev)
    if path is None:
        path = (T(k3_4d_ray_points(n_path, 507)), cotangents((enc.out_dim, n_path), 508, dev))
    rand = (T(k3_4d_points(n_path, 501)), cotangents((enc.out_dim, n_path), 601, dev))
    own = enc.table.detach()
    no_copies = (lotd.GridFwdPlan(0, 0, 0, 4), lotd.Grid4BwdPlan(0))
    sets = [("the pixel step's distant samples, the field's table", enc, own, path, None),
            ("the pixel step's distant samples, N(0, 1) table", enc, table, path, None),
            ("k3_4d_points, the field's table", enc, own, rand, None),
            ("k3_4d_points, N(0, 1) table", enc, table, rand, None)]
    for n in K3_4D_EDGE_N:
        sets += [(f"edges N={n}", enc, table, T(k3_4d_points(n, 510 + n)), None),
                 (f"ray-ordered N={n}", enc, table, T(k3_4d_ray_points(n, 520 + n)), None)]
    sets += [("F 4 ladder, staged", wide, normal(wide, 503), T(k3_4d_points(65_537, 504)), None),
             ("F 4 ladder, no copies", wide, normal(wide, 505), T(k3_4d_points(4097, 506)),
              no_copies),
             ("F 1 ladder, ray-ordered", one, normal(one, 509), T(k3_4d_ray_points(65_536, 511)),
              None)]
    fwd, bwd = [], []
    for i, (label, e, tbl, x, plans) in enumerate(sets):
        d_out = None
        if isinstance(x, tuple):
            x, d_out = x
        n = x.shape[0]
        meta, C, T_ = e._grid_meta, e.out_dim, e.total_params
        fplan, bplan = plans or (e.grid_fwd_plan, e.grid_bwd_plan)
        got = encode_into(lambda *a: lotd.lotd_grid(*a, plan=fplan), (tbl, x, meta), C, n, dev,
                          False)
        want = encode_into(lotd.lotd_grid_plain, (tbl, x, meta), C, n, dev, False)
        fwd.append(compare(f"K3-4D {label}", got, want, 0.0, 0.0, exact=True))
        if d_out is None:
            d_out = cotangents((C, n), 700 + i, dev)
        want_g = lotd.lotd_grid_bwd_plain(T_, x, meta, d_out, None)
        bwd.append(compare_rel(f"K3-4D bwd {label}",
                               [lotd.lotd_grid_bwd(T_, x, meta, d_out, None, plan=bplan)],
                               [want_g], GRAD_REL))
    log(f"K3-4D: {len(sets)} point sets, the forward bit-equal, the backward within "
        f"{max(bwd):.3g} (tol {GRAD_REL:g} of the largest entry)")
    return ({"lotd_grid4": (max(fwd), 0.0), "lotd_grid4.bwd": (max(bwd), GRAD_REL)},
            dict(table=table, enc=enc, sets={"path": path, "random": rand}))


def time_k3_4d(t):
    """K3-4D's forward and backward at the pixel step's own distant samples
    (the headline) and at as many k3_4d_points: card_ms (the forward fills
    the interleaved scratch at every call, as a training step does after
    each update of the table), the plain versions, the least time (the
    points, the table and the cotangent read once, the features or the table
    gradient written once; ~2 operations a corner and feature and 3 a
    corner's weight) -> {kernel: timing, its k3_4d_points timing under
    "random_points"}."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    enc, table = t["enc"], t["table"]
    meta, C, T = enc._grid_meta, enc.out_dim, enc.total_params
    L, F = meta.shape[0], int(meta[0, 3])
    times = {}
    for which, (x, d_out) in t["sets"].items():
        N = x.shape[0]
        out = torch.empty((C, N), device=x.device)
        plan, bplan = enc.grid_fwd_plan, enc.grid_bwd_plan.at(N)
        ops = N * L * 16 * (2 * F + 3)
        shape = (f"[{N:,}, 4] {'points of a pixel step' if which == 'path' else 'k3_4d_points'}"
                 f", {L} levels of F {F} (dense {int(meta[0, 1]):,} rows, hash "
                 f"{int(meta[-1, 1]):,}), {T:,} table floats")
        fwd = {**card_ms(lambda: lotd.lotd_grid(table, x, meta, out, None, plan=plan)),
               "plain_ms": cuda_ms(lambda: lotd.lotd_grid_plain(table, x, meta, out), reps=3),
               "bound": bound(16 * N + 4 * T + 4 * C * N, ops), "library_ms": None,
               "shape": shape}
        bwd = {**card_ms(lambda: lotd.lotd_grid_bwd(T, x, meta, d_out, None, plan=bplan)),
               "plain_ms": cuda_ms(lambda: lotd.lotd_grid_bwd_plain(T, x, meta, d_out, None),
                                   reps=3),
               "bound": bound(16 * N + 4 * C * N + 4 * T, ops), "library_ms": None,
               "shape": shape + ", d_out [C, N]"}
        for name, r in (("lotd_grid4", fwd), ("lotd_grid4.bwd", bwd)):
            log(f"timing {name}: {r['ms']:.4f} ms ({card_extra(r)[2:]}, plain "
                f"{r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]}, library "
                f"none) at {r['shape']}")
            times.setdefault(which, {})[name] = r
    return {name: {**r, "random_points": {k: v for k, v in times["random"][name].items()}}
            for name, r in times["path"].items()}


def lidar_depth_over_frames(scene, trainer, state, samplers, dev, it):
    """The LiDAR step's depth loss (``lidar_loss_depth``) at iteration ``it``
    over a fixed draw (STREETSURF_DEPTH_SEED) of STREETSURF_BEAMS beams of
    every frame of every LiDAR, each with a fixed noise, no parameter moved:
    the mean over the frames. A training batch holds one frame, and the
    depth loss differs from frame to frame by more than 48 iterations move
    it, so the training log's own means are no measure of its fall."""
    import torch
    from neuralsim_torch.tools.train_multi import _LIDAR_KEYS, to_device
    from neuralsim_torch.training.multi_trainer import lift_lidar_batch
    rng = np.random.default_rng(STREETSURF_DEPTH_SEED)
    vals = []
    for (lid, fi), ld in sorted(samplers["lidar"].loader.lidars.items()):
        sel = rng.integers(0, ld["rays_d"].shape[0], STREETSURF_BEAMS)
        raw = {"rays_fidx": np.full(STREETSURF_BEAMS, fi, np.int32),
               "rays_o_local": ld["rays_o"][sel], "rays_d_local": ld["rays_d"][sel],
               "ranges": ld["ranges"][sel]}
        on = scene.nodes[lid].frame_data["transform"].device
        batch = lift_lidar_batch(scene, {**to_device(raw, _LIDAR_KEYS, on), "lidar_id": lid})
        batch = {k: v.to(dev) for k, v in batch.items()}
        gen = torch.Generator(device=dev).manual_seed(STREETSURF_DEPTH_SEED)
        noise = trainer.draw_noise("lidar", STREETSURF_BEAMS, gen, it)
        _, extras = trainer.compute_losses(state.params, batch, it, noise, "lidar", state.occ)
        vals.append(float(extras["aux"]["lidar_loss_depth"]))
    return float(np.mean(vals))


def check_streetsurf_training(scene, trainer, state, samplers, dev, iters=STREETSURF_ITERS):
    """``iters`` loop iterations of the single-scene path (tools.train's
    train_loop, the trainer behind SingleStepTrainer) with every metric
    logged: finite losses, no skip, falling loss_rgb (the last 10
    iterations' mean below the first 10's) and LiDAR depth loss (over every
    frame's fixed beams, lidar_depth_over_frames, after the first
    STREETSURF_DEPTH_EARLY iterations and after the last, both at the first
    iteration's anneal), the grid refreshed on its cadence (three times),
    the error map's importance sampling in use, and the path's kernels
    launched as counted: K12 once a LiDAR step, K6 and K3-4D (forward and
    backward) once a pixel step, K4 once a step; no K8, K9, K10, K11, K13 or
    K2. -> (log, launches, falls)."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.tools.train import train_loop
    gen = torch.Generator(device=dev).manual_seed(11)
    log_ = []
    it0 = state.it
    depth, launches = [], {}
    for end in (it0 + STREETSURF_DEPTH_EARLY, it0 + iters):
        kernels.reset_counts()
        with no_plain_on_card("streetsurf training"):
            train_loop(scene, trainer, state, samplers, end, gen, 1, log_)
            torch.cuda.synchronize()
        for k in kernels.KERNELS.values():
            launches[k.name] = launches.get(k.name, 0) + k.launches
        depth.append(lidar_depth_over_frames(scene, trainer, state, samplers, dev, it0))
    accel = trainer.renderer.accels["cr"]
    refreshes = sum(1 for rec in log_ if rec["it"] % accel.n_steps_between_update == 0)
    log(f"streetsurf training: {iters} iterations of {STREETSURF_BEAMS} beams + "
        f"{STREETSURF_RAYS} rays, {refreshes} grid refreshes, launches {launches}")
    for rec in log_:
        for k, v in rec.items():
            if k.startswith(("loss", "lidar/loss")) and not np.isfinite(v):
                raise AssertionError(f"non-finite {k} at iteration {rec['it']}")
    if log_[-1]["skips_total"] != 0:
        raise AssertionError(f"{log_[-1]['skips_total']} steps were skipped")
    mean = lambda k, rs: float(np.mean([rec[k] for rec in rs]))
    for k in ("loss_rgb", "lidar/lidar_loss_depth"):
        log(f"streetsurf training: {k} first 10 iterations {mean(k, log_[:10]):.5f}, last 10 "
            f"{mean(k, log_[-10:]):.5f}")
    falls = {"loss_rgb": (mean("loss_rgb", log_[:10]), mean("loss_rgb", log_[-10:])),
             "lidar/lidar_loss_depth": tuple(depth)}
    log(f"streetsurf training: lidar_loss_depth over every frame's fixed beams (at iteration "
        f"{it0}'s anneal) after {STREETSURF_DEPTH_EARLY} iterations {depth[0]:.5f}, after "
        f"{iters} {depth[1]:.5f}")
    for k, (before, after) in falls.items():
        if not after < before:
            raise AssertionError(f"{k} did not fall")
    log(f"streetsurf training: the grid's occupied fraction after it "
        f"{float(accel.occupied_fraction(state.occ['cr'])):.4f}, error-map updates "
        f"{samplers['imp'].it} (importance sampling from {samplers['imp'].enable_after})")
    want = {"volume_composite": iters, "volume_composite.bwd": iters,
            "neus_composite": iters, "neus_composite.bwd": iters,
            "lotd_grid4": iters, "lotd_grid4.bwd": iters,
            "occ_ray_proposal": 2 * iters, "occ_ema_update": refreshes,
            "occ_voxel_points": refreshes,
            **dict.fromkeys(COMPOSE_ONLY + MULTI_ONLY + CROWD_ONLY + PERLEVEL_ONLY
                            + PERMUTO_ONLY + LATENT_ONLY + POSE_ONLY, 0)}
    if refreshes != 3 or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"the streetsurf path's launches are not as counted: want {want}")
    for name, n in launches.items():
        if n <= 0 and want.get(name, 1):
            raise AssertionError(f"kernel {name} never launched on the streetsurf training path")
    if samplers["imp"].it != iters or samplers["imp"].enable_after >= iters:
        raise AssertionError("the error map's importance sampling did not run")
    return log_, launches, falls


def check_street_crop(trainer, renderer, state, scene, dev):
    """STREET_CROP of frame 0 rendered on the CPU path and on the card at the
    CPU path's sample depths (sample_placements: the grid's proposal and
    both upsample stages replayed; the distant ladder is deterministic), one
    query of the crop's rays as a render's chunk: rgb, mask and the weighted
    depth (the mean depth times the mask, relative to 1 + the ray's largest
    sample depth) held per ray to STREET_CROP_TOL on all but
    STREET_CROP_OFF_MAX of the rays; the mean depth's own error is logged
    -> {the worst and mean errors, the share off}."""
    import torch
    from neuralsim_torch.scene.observers import camera_get_all_rays
    cam = COMPOSE_CAM
    H, W = (int(v) for v in scene.nodes[cam].frame_data["hw"][0].tolist())
    ro, rd = camera_get_all_rays(scene_on(scene, "cpu").slice_at(0), cam, H, W)
    ro = ro.reshape(H, W, 3)[STREET_CROP].reshape(-1, 3).contiguous()
    rd = rd.reshape(H, W, 3)[STREET_CROP].reshape(-1, 3).contiguous()
    record = []
    cpu_params, occ_cpu = copy.deepcopy(state.params).to("cpu"), occ_on(state, "cpu")
    keys = ("rgb_volume", "mask_volume", "depth_volume")
    with torch.no_grad():
        with sample_placements(trainer, record=record):
            w = renderer.ray_query(cpu_params, ro, rd, occ_states=occ_cpu, return_buffer=True)
        with sample_placements(trainer, replay=record), no_plain_on_card("streetsurf crop"):
            g = renderer.ray_query(state.params, ro.to(dev), rd.to(dev), occ_states=state.occ,
                                   return_buffer=True)
    want, got = {k: w[k] for k in keys}, {k: g[k].cpu() for k in keys}
    far = w["merged_buffer"]["t"].amax(-1)
    weighted = lambda r: r["depth_volume"] * r["mask_volume"]
    per_ray = {"rgb": (got["rgb_volume"] - want["rgb_volume"]).abs().amax(-1),
               "mask": (got["mask_volume"] - want["mask_volume"]).abs(),
               "weighted_depth": (weighted(got) - weighted(want)).abs() / (1.0 + far)}
    off = torch.zeros(ro.shape[0], dtype=torch.bool)
    for v in per_ray.values():
        off |= v > STREET_CROP_TOL
    per_ray["depth"] = (got["depth_volume"] - want["depth_volume"]).abs() / (1.0 + far)
    out = {**{f"{k}_max": float(v.max()) for k, v in per_ray.items()},
           **{f"{k}_mean": float(v.mean()) for k, v in per_ray.items()},
           "off_share": float(off.float().mean()), "rays": ro.shape[0]}
    # the worst ray's depth by source (the street's share, the distant
    # field's), to tell which moves
    i = int(per_ray["depth"].argmax())
    log("streetsurf crop, the worst depth's ray: " + json.dumps({
        "far": float(far[i]), **{f"{src} {k} {side}": float(r[src][k][i])
                                for src in ("rendered_cr", "rendered_dv")
                                for k in ("depth_volume", "mask_volume")
                                for side, r in (("cpu", w), ("card", g))}}))
    log(f"streetsurf crop {STREET_CROP} card vs CPU at the CPU path's depths: {json.dumps(out)} "
        f"(tol {STREET_CROP_TOL:g}, at most {STREET_CROP_OFF_MAX:g} of the rays off)")
    if out["off_share"] > STREET_CROP_OFF_MAX or not all(
            torch.isfinite(v).all() for v in got.values()):
        raise AssertionError("the card's StreetSurf crop differs from the CPU's")
    return out


def streetsurf_phase(dev, profile_it):
    """Phase 14: WAYMO_STREETSURF (configs/waymo_streetsurf.yaml at full width
    on the demo drive: the street's 9 stacked-CP and 3 hash levels of F 4,
    the 4-D LoTD distant field, the sky with appearance inputs) built
    through tools.build.build_everything with the 500-step road pretrain
    and trained through the single-scene Trainer: K3-4D against its plain
    version at the path's shapes and edges, the first iteration card vs
    CPU, each step type's launches, 48 iterations, a poisoned step, the
    iteration median, a validation frame (tools.train.validate) and a crop
    card vs CPU, K3-4D timed -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import WAYMO_STREETSURF as C
    from neuralsim_torch.scene.observers import camera_get_all_rays
    from neuralsim_torch.tools.build import build_everything
    from neuralsim_torch.tools.train import build_samplers, validate

    cfg = copy.deepcopy(C)
    cfg["training"]["error_map"] = {**cfg["training"]["error_map"],
                                    "enable_after": MULTI_ERROR_MAP_AFTER}
    timings = {}
    t0 = time.perf_counter()
    scene, bank, renderer, trainer, state, loader = build_everything(cfg, timings=timings)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    samplers = build_samplers(cfg["training"], loader, int(cfg["seed"]))
    street = state.params[renderer.pkey("cr")]
    distant = state.params[renderer.pkey("distant")]
    enc_s, enc_d = street.encoding, distant.encoding
    n_distant = renderer.distant_query_cfg.get("num_samples", 64)
    log(f"streetsurf: built in {build_s:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()) + f"); street box "
        f"{street.space.aabb_min.tolist()}..{street.space.aabb_max.tolist()}, levels "
        f"{[(s.res, s.typ) for s in enc_s.specs]}, {enc_s.total_params:,} table floats; distant "
        f"{[(s.res, s.typ, s.size) for s in enc_d.specs]}, {enc_d.total_params:,} floats, "
        f"{n_distant} samples a ray; appearance inputs {street.appear_embed_dim}, "
        f"{distant.appear_embed_dim}, {state.params[renderer.pkey('sky')].appear_embed_dim}")
    if [s.typ for s in enc_s.specs] != ["cp"] * 9 + ["hash"] * 3 or not enc_s.cp_stacked \
            or enc_s.cp_rmax != 903 or [s.typ for s in enc_d.specs] != ["dense"] + ["hash"] * 9 \
            or enc_d.specs[0].size != 17 ** 4 or enc_d.specs[1].size != 2 ** 17 \
            or street.appear_embed_dim != 4 or distant.appear_embed_dim != 4:
        raise AssertionError("the StreetSurf model is not the YAML's at full width")

    adapter = SingleStepTrainer(trainer)
    loss_err, grad_err = check_multi_first_iteration(scene, adapter, state, samplers, dev,
                                                     path="streetsurf")
    per_step = step_launches(scene, adapter, state, samplers, dev)
    path_x, path_d = capture_k3_4d(scene, adapter, state, samplers, dev)
    if path_x.shape != (STREETSURF_RAYS * n_distant, 4):
        raise AssertionError(f"a pixel step's distant samples should be "
                             f"[{STREETSURF_RAYS * n_distant}, 4], not {tuple(path_x.shape)}")
    errs, k3_inputs = check_k3_4d(dev, enc_d, path_x.shape[0], path=(path_x, path_d))
    for step_type, (l, alpha_calls) in per_step.items():
        log(f"streetsurf {step_type} step launches {l}; plain alpha chain calls {alpha_calls}")
    # the pixel step composites the street's buffer with the distant one (K6),
    # the street's NeuS alpha made before it by the plain chain, as on the
    # bench model's path (the alpha inside a two-buffer composite is in the
    # kernel queue); the LiDAR step's street alone takes K12, the alpha inside
    (lid, lid_alpha), (pix, pix_alpha) = per_step["lidar"], per_step["pixel"]
    if lid_alpha or pix_alpha != 1 or lid["lotd_grid4"] or lid["lotd_grid4.bwd"] \
            or lid["volume_composite"] or lid["neus_composite"] != 1 \
            or pix["lotd_grid4"] != 1 or pix["lotd_grid4.bwd"] != 1 \
            or pix["volume_composite"] != 1 or pix["neus_composite"]:
        raise AssertionError("a StreetSurf LiDAR step takes K12 and no K3-4D or plain alpha "
                             "chain, a pixel step K6 and K3-4D forward and backward once, "
                             "the street's alpha by the plain chain once")
    log_, launches, falls = check_streetsurf_training(scene, adapter, state, samplers, dev)
    check_multi_poisoned_step(scene, adapter, state, samplers, dev, path="streetsurf")
    it_ms = time_multi_iterations(scene, adapter, state, samplers, dev,
                                  n_rays=STREETSURF_RAYS, n_beams=STREETSURF_BEAMS)
    log("streetsurf timing (host clock, ms): " + ", ".join(
        f"{k} median {v[0]:.2f} (min {v[1]:.2f}, max {v[2]:.2f})" for k, v in it_ms.items()))

    # a validation frame as the tool renders it, the whole frame timed, a crop vs the CPU
    with no_plain_on_card("streetsurf validation"):
        psnr = validate(scene, renderer, state.params, loader, COMPOSE_CAM, 0, None, state.it,
                        downscale=cfg["training"]["val_downscale"], occ=state.occ)
    if not math.isfinite(psnr):
        raise AssertionError("the StreetSurf validation frame is not finite")
    H, W = (int(v) for v in scene.nodes[COMPOSE_CAM].frame_data["hw"][0].tolist())
    ro, rd = camera_get_all_rays(scene.slice_at(0), COMPOSE_CAM, H, W)
    frame = lambda: renderer.render_chunked(state.params, ro.contiguous(), rd.contiguous(),
                                            occ_states=state.occ)
    kernels.reset_counts()
    out = frame()
    torch.cuda.synchronize()
    frame_launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    if frame_launches["lotd_grid4"] <= 0 or not torch.isfinite(out["rgb_volume"]).all():
        raise AssertionError("a StreetSurf frame should launch K3-4D and be finite")
    frame_ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        frame_ts.append((time.perf_counter() - t1) * 1e3)
    frame_ms = sorted(frame_ts)[2]
    log(f"streetsurf frames: validation PSNR {psnr:.3f} dB (every "
        f"{cfg['training']['val_downscale']}th pixel of frame 0), a whole {H}x{W} frame median "
        f"{frame_ms:.2f} ms (min {min(frame_ts):.2f}, max {max(frame_ts):.2f}), launches "
        f"{frame_launches}")
    crop = check_street_crop(adapter, renderer, state, scene, dev)
    times = time_k3_4d(k3_inputs)
    if profile_it:
        profile_multi_steps(scene, adapter, state, samplers, dev)
    summary = {"streetsurf_build_s": build_s, "streetsurf_build_parts_s": timings,
               "streetsurf_first_iter_loss_rel_err": loss_err,
               "streetsurf_first_iter_grad_rel_err": grad_err,
               "streetsurf_iterations": STREETSURF_ITERS,
               "streetsurf_iteration_ms": it_ms["iteration"], "streetsurf_lidar_step_ms":
                   it_ms["lidar"], "streetsurf_pixel_step_ms": it_ms["pixel"],
               "streetsurf_loss_falls": falls, "streetsurf_val_psnr": psnr,
               "streetsurf_frame_ms": frame_ms, "streetsurf_frame_hw": [H, W],
               "streetsurf_crop": crop, "streetsurf_distant_samples": n_distant}
    return dict(summary=summary, errs=errs, times=times, launches=launches,
                iters=STREETSURF_ITERS, step_launches={k: v[0] for k, v in per_step.items()},
                frame_launches=frame_launches)


DISK_ITERS = 8
# the JPEG's error (quality 95) of a written frame against the in-memory
# frame, a mean over the frame's values and the largest value (measured with
# Pillow 12.1.0 on the CPU: means 0.0048-0.0070, largest 0.38, ringing at the
# vehicles' edges)
DISK_JPEG_MEAN, DISK_JPEG_MAX = 0.01, 0.5
DISK_MULTI_TRAIN = ("lotd_cp_stacked", "lotd_cp_stacked.bwd", "lotd_grid", "lotd_grid.bwd",
                    "occ_ray_proposal", "neus_upsample.weights_pdf", "neus_upsample.merge",
                    "cross_source_vw", "cross_source_vw.bwd", "neus_composite",
                    "neus_composite.bwd", "occ_voxel_points", "occ_ema_update", "latent_take",
                    "latent_take.bwd", "lotd_cp_lines", "lotd_cp_lines.bwd")
DISK_STREET_TRAIN = ("lotd_cp_stacked", "lotd_cp_stacked.bwd", "lotd_grid", "lotd_grid.bwd",
                     "lotd_grid4", "lotd_grid4.bwd", "occ_ray_proposal",
                     "neus_upsample.weights_pdf", "neus_upsample.merge", "volume_composite",
                     "volume_composite.bwd", "neus_composite", "neus_composite.bwd",
                     "occ_voxel_points", "occ_ema_update", "lotd_cp_lines", "lotd_cp_lines.bwd")
DISK_STREET_FRAME = ("lotd_cp_stacked", "lotd_grid", "lotd_grid4", "occ_ray_proposal",
                     "neus_upsample.weights_pdf", "neus_upsample.merge", "volume_composite",
                     "lotd_cp_lines")
DISK_STREET_LIDAR = EVAL_LIDAR_KERNELS


def check_written_drive(root):
    """The demo drive written by the port's writer, read back by the
    Waymo-layout reader: the scenario, the semantic and occupancy masks and
    the LiDAR exactly the in-memory drive's, each frame within the JPEG's
    error -> [(mean, largest) a frame]."""
    from neuralsim_torch.dataio.waymo import WaymoDataset
    from neuralsim_torch.dataio.waymo_demo import demo_sequence
    disk, mem = WaymoDataset(root), demo_sequence()
    sid, cam, lid = "demo_drive", COMPOSE_CAM, "lidar_TOP"

    def same(a, b, path):
        if isinstance(b, dict):
            if set(a) != set(b):
                raise AssertionError(f"the written scenario's {path} has other keys")
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, np.ndarray):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"the written scenario's {path} differs")
        elif isinstance(b, list):
            if not isinstance(a, list) or len(a) != len(b):
                raise AssertionError(f"the written scenario's {path} has another length")
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        elif a != b:
            raise AssertionError(f"the written scenario's {path} differs")

    same(disk.get_scenario(sid), mem.get_scenario(sid), "scenario")
    errs = []
    for fi in range(mem.scenario["metas"]["num_frames"]):
        for kind in ("all", "sky", "human", "vehicle", "dynamic"):
            if not np.array_equal(disk.get_semantic_mask(sid, cam, fi, kind),
                                  mem.get_semantic_mask(sid, cam, fi, kind)):
                raise AssertionError(f"frame {fi}'s {kind} mask differs from the in-memory drive")
        if not np.array_equal(disk.get_occupancy_mask(sid, cam, fi),
                              mem.get_occupancy_mask(sid, cam, fi)):
            raise AssertionError(f"frame {fi}'s occupancy mask differs")
        got, want = disk.get_lidar(sid, lid, fi), mem.get_lidar(sid, lid, fi)
        if any(not np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"frame {fi}'s LiDAR differs from the in-memory drive")
        err = np.abs(disk.get_image(sid, cam, fi) - mem.get_image(sid, cam, fi))
        errs.append((float(err.mean()), float(err.max())))
    if not all(m <= DISK_JPEG_MEAN and x <= DISK_JPEG_MAX for m, x in errs):
        raise AssertionError(f"a written frame is further from the in-memory frame than the "
                             f"JPEG's error: {errs}")
    return errs


def run_tool(label, fn, argv, want):
    """A tool's ``main(argv)`` on the card with every count at 0 before it,
    no plain K7/K13/K14 or bf16 cast on the card (no_plain_on_card) -> (its
    result, its seconds on the host clock to a sync, each kernel's launches);
    raises where a kernel of ``want`` was not launched."""
    import torch
    from neuralsim_torch import kernels
    kernels.reset_counts()
    t0 = time.perf_counter()
    with no_plain_on_card(label):
        out = fn(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels.KERNELS.values()}
    missing = [n for n in want if counts[n] <= 0]
    log(f"{label}: {secs:.2f} s, launches {counts}")
    if missing:
        raise AssertionError(f"{label} never launched {missing}")
    return out, secs, counts


def disk_phase(dev, tmp):
    """Phase 15: the demo drive written to disk in the Waymo layout (under
    ``tmp``/data, where phase 16 reads it too) and both driving YAMLs from the
    command line on it, as written (the dataset's ``root`` and the
    schedule's length the only overrides), at full width:
    configs/waymo_demo_multi.yaml through tools.train_multi.main, then
    eval_multi, eval_lidar and render (replay of one frame, topdown) from
    its exp dir; configs/waymo_streetsurf.yaml through tools.train.main,
    then eval and eval_lidar. Each tool's launches counted, no plain
    K7/K13/K14 or bf16 cast on the card, finite losses and scores."""
    import PIL
    from neuralsim_torch.dataio.waymo_demo import build_demo_sequence
    from neuralsim_torch.tools import eval as single_eval
    from neuralsim_torch.tools import eval_lidar, eval_multi, render, train, train_multi

    log(f"waymo layout: Pillow {PIL.__version__} (the reader's and the writer's JPEG codec)")
    run = run_tool

    def trained(label, out):
        it_ms = np.asarray(out["iter_s"]) * 1e3
        losses = [v for rec in out["log"] for k, v in rec.items()
                  if k.startswith(("loss", "lidar/loss"))]
        if out["skips_total"] or len(it_ms) != DISK_ITERS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{label} skipped a step, logged a non-finite loss or ran "
                                 f"another number of iterations")
        log(f"{label}: iteration median {np.median(it_ms):.2f} ms (min {it_ms.min():.2f}, max "
            f"{it_ms.max():.2f}), loss_total {[rec['loss_total'] for rec in out['log']]}")
        return float(np.median(it_ms))

    def finite(label, res):
        vals = [v for v in res["mean"].values() if v is not None]
        if not res["per_frame"] or not all(map(math.isfinite, vals)):
            raise AssertionError(f"{label}'s scores are not finite, or no frame was scored")
        log(f"{label} mean {json.dumps(res['mean'])}")

    summary, launches = {"pillow": PIL.__version__}, {}
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    build_demo_sequence(data)
    summary["disk_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["disk_jpeg_err"] = check_written_drive(data)
    summary["disk_read_check_s"] = time.perf_counter() - t0
    log(f"waymo layout: the demo drive written in {summary['disk_write_s']:.2f} s and read "
        f"back in {summary['disk_read_check_s']:.2f} s: scenario, masks and LiDAR the "
        f"in-memory drive's, frames within the JPEG's error (mean, largest) "
        f"{summary['disk_jpeg_err']}")
    common = [f"--dataset_cfg.params.root={data}", f"--training.num_iters={DISK_ITERS}",
              "--training.i_log=1"]
    exp = os.path.join(tmp, "multi")
    out, summary["disk_multi_train_s"], launches["multi_train"] = run(
        "train_multi.main (configs/waymo_demo_multi.yaml)", train_multi.main,
        ["--config", "configs/waymo_demo_multi.yaml", f"--exp_dir={exp}"] + common,
        DISK_MULTI_TRAIN)
    summary["disk_multi_iteration_ms"] = trained("waymo_demo_multi from disk", out)
    del out
    at = ["--resume_dir", exp]
    ev, summary["disk_eval_multi_s"], launches["eval_multi"] = run(
        "eval_multi.main", eval_multi.main,
        at + ["--eval.frames=0,3,6", f"--eval.rayschunk={EVAL_CHUNK}"], EVAL_FRAME_KERNELS)
    finite("eval_multi", ev)
    lv, summary["disk_eval_lidar_multi_s"], launches["eval_lidar_multi"] = run(
        "eval_lidar.main (multi)", eval_lidar.main,
        at + ["--renderer.type=multi", "--eval.frames=0,3,6"], EVAL_LIDAR_KERNELS)
    finite("eval_lidar (multi)", lv)
    for mode, extra in (("replay", ["--render.frames=0", "--render.video=false"]),
                        ("topdown", ["--render.frames=0,4", "--render.topdown_w=256",
                                     "--render.fps=6"])):
        r, summary[f"disk_render_{mode}_s"], launches[f"render_{mode}"] = run(
            f"render.main ({mode})", render.main,
            at + ["--renderer.type=multi", f"--render.mode={mode}"] + extra,
            EVAL_FRAME_KERNELS)
        files = sorted(os.listdir(r["out_dir"]))
        log(f"render {mode}: {files}")
        if not {f"rgb_{fi:04d}.png" for fi in r["frames"]} <= set(files) \
                or (mode == "topdown") != bool(r["video"]):
            raise AssertionError(f"render {mode} did not write its frames (or its video)")
    summary.update(disk_eval_multi_mean=ev["mean"], disk_eval_lidar_multi_mean=lv["mean"])

    exp = os.path.join(tmp, "street")
    out, summary["disk_street_train_s"], launches["street_train"] = run(
        "train.main (configs/waymo_streetsurf.yaml)", train.main,
        ["--config", "configs/waymo_streetsurf.yaml", f"--exp_dir={exp}"] + common,
        DISK_STREET_TRAIN)
    summary["disk_street_iteration_ms"] = trained("waymo_streetsurf from disk", out)
    cams = out["samplers"]["pixel"].loader.cam_ids
    if cams != [COMPOSE_CAM] or not math.isfinite(out["psnr"]):
        raise AssertionError(f"StreetSurf's camera_list should keep the one camera the "
                             f"drive has, {cams}, and its validation frame be finite")
    del out
    at = ["--resume_dir", exp]
    ev, summary["disk_eval_s"], launches["eval"] = run(
        "eval.main", single_eval.main, at + ["--eval.frames=0,3,6"], DISK_STREET_FRAME)
    finite("eval (streetsurf)", ev)
    lv, summary["disk_eval_lidar_s"], launches["eval_lidar"] = run(
        "eval_lidar.main (single-scene)", eval_lidar.main, at + ["--eval.frames=0,3,6"],
        DISK_STREET_LIDAR)
    finite("eval_lidar (streetsurf)", lv)
    summary.update(disk_eval_mean=ev["mean"], disk_eval_lidar_mean=lv["mean"])
    summary["disk_iterations"] = DISK_ITERS
    summary["disk_launches"] = launches
    return dict(summary=summary)


# EmerNeRF (configs/waymo_emernerf.yaml as written, at full width, on the demo
# drive written to disk; the data's root and the schedule's length the only
# overrides): each iteration a pixel step of 8,192 rays of 96 stratified
# samples through the static LoTD (4 dense levels of 16-60 and 8 hash levels
# of 2^18 to 2,048, F 2: K3 without the jacobian) and the dynamic permuto
# lattice over (xyz, t) (12 levels of 2^17, d 4: K9), composited with the
# sky by K6 at [8,192, 96]; the flow loss's two queries of the dynamic branch
# at its 1,024 points (K9 and its backward into the table and, for the
# points moved by the flow, into x01). Its first step is held to the CPU path
# at MULTI_CHECK_RAYS rays under the multi-object limits (the samples are
# stratified, so both sides sample at the same depths).
EMER_YAML = "configs/waymo_emernerf.yaml"
EMER_RAYS, EMER_SAMPLES = 8192, 96          # the YAML's n_rays and num_coarse
EMER_ITERS = 48
EMER_EARLY = 10
# the fixed pixels the rgb loss is held to fall on: every pixel of these
# frames of the first camera, each frame's query with the same draws
EMER_HELD_FRAMES = (0, 3, 6)
EMER_HELD_SEED = 29
# the first step's rays are all opaque where 1 - their mean mask is below this
EMER_OPAQUE = 1e-5
EMER_KERNELS = ("lotd_grid", "lotd_grid.bwd", "permuto", "permuto.bwd", "volume_composite",
                "volume_composite.bwd")
# launches a pixel step: K3 and K6 once each way, K9 three times each way (the
# rendered samples, the flow loss's query at its points and at the points
# the flow moved)
EMER_STEP_LAUNCHES = {"lotd_grid": 1, "lotd_grid.bwd": 1, "permuto": 3, "permuto.bwd": 3,
                      "volume_composite": 1, "volume_composite.bwd": 1}
EMER_CHANNELS = ("rgb", "depth", "flow_fwd", "flow_bwd", "rgb_static", "rgb_dynamic",
                 "mask_static", "mask_dynamic")


def emernerf_cfg(root, num_iters):
    """configs/waymo_emernerf.yaml with the drive's root and the schedule's
    length the only overrides."""
    from neuralsim_torch.config import load_config
    return load_config(EMER_YAML, [f"--dataset_cfg.params.root={root}",
                                   f"--training.num_iters={num_iters}"])


@contextlib.contextmanager
def plain_on_card(record):
    """While the block runs, count in ``record["plain_on_card"]`` the calls of
    K3's, K9's and K6's plain versions (forward and backward, K3's to the
    positions too) with a tensor on the card: a card path takes none."""
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.encodings import permuto as pm
    from neuralsim_torch.renderers import buffers
    names = [(lotd, "lotd_grid_plain"), (lotd, "lotd_grid_bwd_plain"),
             (lotd, "lotd_grid_bwd_x_plain"), (pm, "permuto_plain"),
             (pm, "permuto_bwd_plain"), (buffers, "volume_composite_plain"),
             (buffers, "volume_composite_bwd_plain")]
    saved = [(m, n, getattr(m, n)) for m, n in names]
    record.setdefault("plain_on_card", 0)

    def counted(fn):
        def call(*a, **kw):
            record["plain_on_card"] += int(any(getattr(x, "is_cuda", False) for x in a))
            return fn(*a, **kw)
        return call

    for m, n, fn in saved:
        setattr(m, n, counted(fn))
    try:
        yield record
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def emernerf_recorded(record):
    """Record, copied, the inputs and cotangents that one pixel step hands
    K3 (3-D), K9 and K6 and their backwards, K3's to the positions among
    them: ``record[kernel]`` a list of argument tuples, call by call, and
    ``record["kw"][kernel]`` their keyword arguments; the calls themselves
    run as they are."""
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.encodings import permuto as pm
    from neuralsim_torch.renderers import buffers
    keep = lambda a: tuple(x.detach().clone() if hasattr(x, "detach") else x for x in a)
    names = [(lotd, "lotd_grid", "lotd_grid"), (lotd, "lotd_grid_bwd", "lotd_grid.bwd"),
             (pm, "permuto", "permuto"), (pm, "permuto_bwd", "permuto.bwd"),
             (buffers, "volume_composite", "volume_composite"),
             (buffers, "volume_composite_bwd", "volume_composite.bwd"),
             (lotd, "lotd_grid_bwd_x", "lotd_grid.bwd_x")]
    saved = [(m, n, k, getattr(m, n)) for m, n, k in names]

    def recorded(k, fn):
        def call(*a, **kw):
            record.setdefault(k, []).append(keep(a))
            record.setdefault("kw", {}).setdefault(k, []).append(dict(kw))
            return fn(*a, **kw)
        return call

    for m, n, k, fn in saved:
        setattr(m, n, recorded(k, fn))
    try:
        yield record
    finally:
        for m, n, _, fn in saved:
            setattr(m, n, fn)


def emernerf_batch(samplers, n, dev):
    from neuralsim_torch.tools.train import _PIXEL_KEYS, to_device
    raw = samplers["pixel"].sample(n)
    return to_device(raw, _PIXEL_KEYS, dev), raw["cam_id"]


def first_step_side(scene, trainer, params, batch, cam, noise, it, d):
    """One pixel step's losses and gradients on device ``d`` (the scene, the
    batch and the draws moved there), no parameter moved -> ({loss: value},
    {leaf: gradient on the CPU}, 1 - the mean rendered mask)."""
    import torch
    to = lambda tree, dv: {k: to(v, dv) for k, v in tree.items()} if isinstance(tree, dict) \
        else [to(v, dv) for v in tree] if isinstance(tree, list) else tree.to(dv)
    saved = trainer.scene
    trainer.scene = scene_on(scene, d)
    try:
        total, extras = trainer.compute_losses(params, to(batch, d), it, to(noise, d), None,
                                               "pixel", cam)
    finally:
        trainer.scene = saved
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    return ({"loss_total": float(total.detach()),
             **{k: float(v.detach()) for k, v in extras["losses"].items()}},
            {k: torch.zeros(p.shape) if g is None else g.cpu()
             for (k, p), g in zip(named.items(), grads)},
            1.0 - float(extras["aux"]["rendered_mask_mean"]))


def compare_first_step(label, trainer, cpu, card, exact=None):
    """A first step's losses and gradients (first_step_side) on the card
    against the CPU's: the worst loss rel err and each leaf's largest
    difference over its largest entry, held to MULTI_STEP_LOSS_RTOL and
    MULTI_STEP_GRAD_REL. With ``exact``, the same step's gradients from a
    float64 CPU run: a pose leaf (``Pose.*``) that misses MULTI_STEP_GRAD_REL
    against the float32 CPU is held to that yardstick instead, as compare_f64
    holds K6's and K12's backwards: the card no further from float64 than
    the float32 CPU is, plus MULTI_STEP_GRAD_REL of the float64 leaf's
    largest entry. Every other leaf stays at MULTI_STEP_GRAD_REL. ->
    (worst loss rel err, worst gradient rel err against the float32 CPU,
    {leaf: its rel err} of the leaves the CPU's step reaches, {pose leaf:
    (card vs float32 CPU, card vs float64, float32 CPU vs float64) over its
    largest entry}, empty without ``exact``)."""
    (l_cpu, g_cpu, opaque), (l_gpu, g_gpu, _) = cpu, card
    if set(l_cpu) != {"loss_total", "loss_rgb", "loss_mask", "loss_flow",
                      "loss_dynamic_sparsity"}:
        raise AssertionError(f"an EmerNeRF step should have the YAML's four losses: {l_cpu}")
    le = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12) for k, v in l_cpu.items())
    # the sky's leaves take their gradient through 1 - mask_volume alone; where
    # the close range is opaque on every ray (the YAML's fields at init: a
    # density of ~2 a metre over 60 m and more of box), 1 - mask is the
    # float32 rounding of a sum of weights next to 1, another noise on each
    # side, and the sky's gradient that noise (~1e-8 of the step's largest):
    # it is then held to the step's largest gradient, not to its own
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    sky = trainer.renderer.pkey("sky") + "."
    noise_only = {k for k in g_cpu if k.startswith(sky)} if opaque < EMER_OPAQUE else set()
    rel = {k: float((g_gpu[k] - g).abs().max())
           / (scale if k in noise_only else float(g.abs().max()))
           for k, g in g_cpu.items() if float(g.abs().max()) > 0}
    ge = max(rel.values())
    if noise_only:
        log(f"{label} first step: every ray opaque (1 - mean mask {opaque:.3g} on the CPU): "
            f"the sky's leaves held to the step's largest gradient, {scale:.3g}")
    log(f"{label} first step card vs cpu ({MULTI_CHECK_RAYS} rays): worst loss rel err "
        f"{le:.3g} (tol {MULTI_STEP_LOSS_RTOL:g}), worst gradient rel err {ge:.3g} (tol "
        f"{MULTI_STEP_GRAD_REL:g}); losses {json.dumps(l_gpu)}; "
        f"gradients by leaf {json.dumps({k: float(f'{e:.3g}') for k, e in rel.items()})}")
    # a leaf the step does not reach on the CPU (the sky behind an opaque
    # close range at init) must get none on the card either
    zero = sorted(set(g_cpu) - set(rel))
    if zero:
        log(f"{label} first step: no gradient on the CPU for {zero}")
    if any(float(g_gpu[k].abs().max()) > 1e-12 * scale for k in zero):
        raise AssertionError(f"the card's step reaches leaves that the CPU's does not: {zero}")
    held, yard = dict(rel), {}
    for k in (k for k in rel if exact is not None and k.startswith("Pose.")):
        g, p, w = card[1][k].double(), cpu[1][k].double(), exact[k]
        top = float(w.abs().max()) or 1.0
        ek, ep = float((g - w).abs().max()), float((p - w).abs().max())
        yard[k] = (rel[k], ek / top, ep / top)
        if rel[k] > MULTI_STEP_GRAD_REL:
            log(f"{label} first step, {k}: {rel[k]:.3g} of its largest against the float32 "
                f"CPU; from float64 the card {ek / top:.3g}, the float32 CPU {ep / top:.3g} "
                f"(tol the CPU's + {MULTI_STEP_GRAD_REL:g})")
            if not ek <= ep + MULTI_STEP_GRAD_REL * top:
                raise AssertionError(f"the card's first {label} step: {k} lies further from "
                                     f"float64 than the float32 CPU")
            held[k] = 0.0
    if not (le <= MULTI_STEP_LOSS_RTOL and max(held.values()) <= MULTI_STEP_GRAD_REL):
        raise AssertionError(f"the card's first {label} step differs from the CPU's")
    return le, ge, rel, yard


def first_step_inputs(trainer, state, samplers):
    """The first step's batch (MULTI_CHECK_RAYS pixels), camera and draws, on
    the CPU."""
    import torch
    batch, cam = emernerf_batch(samplers, MULTI_CHECK_RAYS, "cpu")
    noise = trainer.draw_noise(MULTI_CHECK_RAYS, torch.Generator().manual_seed(7), state.it)
    return batch, cam, noise


def check_emernerf_first_step(scene, trainer, state, samplers, dev):
    """The first pixel step (MULTI_CHECK_RAYS rays, the flow loss at its
    1,024 points) on the card against the CPU path, from the same
    parameters, batch and draws (compare_first_step); steps nothing. ->
    (worst loss rel err, worst gradient rel err)."""
    inputs = first_step_inputs(trainer, state, samplers)
    cpu = first_step_side(scene, trainer, copy.deepcopy(state.params).to("cpu"), *inputs,
                          state.it, "cpu")
    card = first_step_side(scene, trainer, state.params, *inputs, state.it, dev)
    return compare_first_step("emernerf", trainer, cpu, card)[:2]


def capture_emernerf_step(trainer, state, samplers, dev):
    """One pixel step of the YAML's 8,192 rays, no parameter moved, with the
    kernels' inputs and cotangents recorded (emernerf_recorded) and their
    launches counted -> (record, launches)."""
    import torch
    from neuralsim_torch import kernels
    batch, cam = emernerf_batch(samplers, None, dev)
    noise = trainer.draw_noise(batch["rays_fidx"].shape[0],
                               torch.Generator(device=dev).manual_seed(17), state.it)
    record = {}
    kernels.reset_counts()
    with emernerf_recorded(record):
        total, _ = trainer.compute_losses(state.params, batch, state.it, noise, None, "pixel",
                                          cam)
        total.backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    state.params.zero_grad(set_to_none=True)
    got = {k: len(v) for k, v in record.items() if k != "kw"}
    if got != EMER_STEP_LAUNCHES or {k: launches[k] for k in EMER_KERNELS} != got \
            or sum(launches.values()) != sum(got.values()):
        raise AssertionError(f"an EmerNeRF pixel step should call {EMER_STEP_LAUNCHES} and "
                             f"launch nothing else: calls {got}, launches {launches}")
    return record, launches


def check_emernerf_kernels(dev, enc_s, enc_d, record):
    """K3 (the static branch's 786,432 samples) and its backward, K9 at d 4
    (the dynamic branch's samples, the flow loss's 1,024 points and the
    points the flow moved) and its backward into the table and, at the
    moved points, into x01, K6 and its backward at [8,192, 96], each against
    its plain version at the step's own inputs and cotangents -> ({kernel:
    (max_abs_err, tol)}, the timings' inputs)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.encodings import permuto as pm
    from neuralsim_torch.renderers import buffers
    errs, shapes = {}, {}
    # K3: the field's table (its kept scratch), meta and plans as the path
    (table, x, meta, *_), = record["lotd_grid"]
    (n_table, xb, metab, d_out, d_jac, *_), = record["lotd_grid.bwd"]
    N, C = x.shape[0], enc_s.out_dim
    if x.shape != (EMER_RAYS * EMER_SAMPLES, 3) or d_jac is not None \
            or not torch.equal(xb, x):
        raise AssertionError(f"K3 should see the step's [786,432, 3] samples without the "
                             f"jacobian, its backward the same points: {tuple(x.shape)}")
    got = encode_into(lambda *a: lotd.lotd_grid(*a, plan=enc_s.grid_fwd_plan), (table, x, meta),
                      C, N, dev, False)
    want = encode_into(lotd.lotd_grid_plain, (table, x, meta), C, N, dev, False)
    e3 = compare(f"K3 emernerf static samples N={N:,} L={meta.shape[0]}", got, want, 1e-5, 1e-5)
    bplan = enc_s.grid_bwd_plan.at(N)
    e3b = compare_rel(f"K3 bwd emernerf static samples N={N:,}",
                      [lotd.lotd_grid_bwd(n_table, x, meta, d_out, None, plan=bplan)],
                      [lotd.lotd_grid_bwd_plain(n_table, x, meta, d_out, None)], GRAD_REL)
    errs["lotd_grid"], errs["lotd_grid.bwd"] = (e3, 1e-5), (e3b, GRAD_REL)
    shapes["lotd_grid"] = dict(args=(table, x, meta), plan=enc_s.grid_fwd_plan, C=C)
    shapes["lotd_grid.bwd"] = dict(args=(n_table, x, meta, d_out), plan=bplan)
    # K9 at d 4: its three calls and their backwards, in the order the step makes them
    fwd, bwd = record["permuto"], record["permuto.bwd"]
    labels = ("the rendered samples", "the flow loss's points", "the points the flow moved")
    if len(fwd) != 3 or fwd[0][1].shape[0] != EMER_RAYS * EMER_SAMPLES:
        raise AssertionError("K9 should see the rendered samples, then the flow loss's two "
                             "queries")
    e9, e9b, e9x = [], [], []
    for label, (table9, x01, res, meta9, size, n_out, jac) in zip(labels, fwd):
        if x01.shape[1] != 4 or jac:
            raise AssertionError("K9 on this path is d 4 without the jacobian")
        a = (table9, x01, res, meta9, size)
        e9.append(compare(f"K9 emernerf d 4 {label} N={x01.shape[0]:,}",
                          pm.permuto(*a, n_out, False), pm.permuto_plain(*a, False), **K9_TOL))
    for table9, x01, res, meta9, size, d_o, d_j, need_dx in bwd:
        a = (table9, x01, res, meta9, size)
        gt, gx = pm.permuto_bwd(*a, d_o, None, need_dx)
        wt, wx = pm.permuto_bwd_plain(*a, d_o, None, need_dx)
        what = f"K9 bwd emernerf d 4 N={x01.shape[0]:,}{' with d x01' if need_dx else ''}"
        e9b.append(compare_rel(what + ", d table", [gt], [wt], GRAD_REL))
        if need_dx:
            e9x.append(compare_rel(what + ", d x01", [gx], [wx], K9_DX_REL))
            if not torch.equal(gx, pm.permuto_bwd(*a, d_o, None, True)[1]):
                raise AssertionError("K9 bwd: d x01 differs between two calls")
    if [b[-1] for b in bwd].count(True) != 1:
        raise AssertionError("one of K9's three backwards (at the points the flow moved) "
                             "should return d x01")
    errs["permuto"] = (max(e9), K9_TOL["atol"])
    errs["permuto.bwd"] = (max(e9b + e9x), GRAD_REL)
    shapes["permuto"] = [dict(args=f[:5], C=f[5], label=label) for label, f in zip(labels, fwd)]
    shapes["permuto.bwd"] = [dict(args=b[:5], d_out=b[5], need_dx=b[7]) for b in bwd]
    # K6 at [8,192, 96] and its backward at the step's cotangents
    (cargs,) = record["volume_composite"]
    (bargs,) = record["volume_composite.bwd"]
    if cargs[0].shape != (EMER_RAYS, EMER_SAMPLES):
        raise AssertionError(f"K6 should composite [8,192, 96], not {tuple(cargs[0].shape)}")
    e6 = compare("K6 emernerf close range [8,192, 96]", buffers.volume_composite(*cargs),
                 buffers.volume_composite_plain(*cargs), 1e-5, 1e-6)
    # at the step's own cotangents on rays that are opaque from their first
    # samples, with a colour that hardly varies along them (the fields at
    # init), d alpha is a sum that cancels to ~1e-11: held to float64
    f64 = [x.double() if x is not None and x.dtype == torch.float32 else x for x in bargs]
    e6b = compare_f64("K6 bwd emernerf [8,192, 96], the step's cotangents",
                      buffers.volume_composite_bwd(*bargs),
                      buffers.volume_composite_bwd_plain(*bargs),
                      buffers.volume_composite_bwd_plain(*f64))
    # and at GRAD_REL with N(0, 1) cotangents of all five outputs (a weight's
    # own cotangent makes each d alpha a sum that does not cancel)
    n6, s6 = cargs[0].shape
    rand = [cotangents(sh, 40 + i, dev) for i, sh in enumerate(
        ((n6, s6), (n6,), (n6,), (n6, 3), (n6, 3)))]
    e6b = max(e6b, compare_rel("K6 bwd emernerf [8,192, 96], N(0, 1) cotangents",
                               buffers.volume_composite_bwd(*cargs, *rand),
                               buffers.volume_composite_bwd_plain(*cargs, *rand), GRAD_REL))
    errs["volume_composite"], errs["volume_composite.bwd"] = (e6, 1e-6), (e6b, GRAD_REL)
    shapes["volume_composite"], shapes["volume_composite.bwd"] = cargs, bargs
    torch.cuda.synchronize()
    return errs, shapes


def time_emernerf_kernels(shapes):
    """Each kernel queued (card_ms) at the step's own inputs, beside its plain
    version and its least time (each input read once, each output written
    once at 3.35 TB/s, or its float work at 67 TFLOP/s) -> {kernel:
    [timing, ...]}."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.encodings import permuto as pm
    from neuralsim_torch.renderers import buffers
    out = {}
    table, x, meta = shapes["lotd_grid"]["args"]
    N, C, T = x.shape[0], shapes["lotd_grid"]["C"], table.numel()
    L, F = meta.shape[0], int(meta[0, 3])
    buf = torch.empty((C, N), device=x.device)
    ops = N * L * 8 * (2 * F + 3)            # 8 corners: a weight, then F multiply-adds
    what = (f"[{N:,}, 3] the static branch's samples, {L} levels of F {F} "
            f"(dense {[int(r[0]) for r in meta.tolist() if not r[4]]}, hash 2^18), "
            f"{T:,} table floats, no jacobian")
    out["lotd_grid"] = [dict(shape=what, **card_ms(lambda: lotd.lotd_grid(
        table, x, meta, buf, None, plan=shapes["lotd_grid"]["plan"])),
        plain_ms=cuda_ms(lambda: lotd.lotd_grid_plain(table, x, meta, buf), reps=3),
        library_ms=None, bound=bound(N * 12 + T * 4 + C * N * 4, ops))]
    n_table, xb, metab, d_out = shapes["lotd_grid.bwd"]["args"]
    bplan = shapes["lotd_grid.bwd"]["plan"]
    out["lotd_grid.bwd"] = [dict(shape=what + ", d_out [C, N]", **card_ms(
        lambda: lotd.lotd_grid_bwd(n_table, xb, metab, d_out, None, plan=bplan)),
        plain_ms=cuda_ms(lambda: lotd.lotd_grid_bwd_plain(n_table, xb, metab, d_out, None),
                         reps=3),
        library_ms=None, bound=bound(N * 12 + C * N * 4 + n_table * 4, ops))]
    for sh in shapes["permuto"]:
        t9, x01, res, meta9, size = sh["args"]
        (n, d), L9, F9 = x01.shape, res.shape[0], int(meta9[0, 1])
        walk, interp = 4 * d + 11 * (d + 1), 2 * (d + 1) * F9
        out.setdefault("permuto", []).append(dict(
            shape=f"[{n:,}, 4] {sh['label']}, {L9} levels of F {F9}, T {size:,}, no jacobian",
            **card_ms(lambda: pm.permuto(*sh["args"], sh["C"], False)),
            plain_ms=cuda_ms(lambda: pm.permuto_plain(*sh["args"], False), reps=3),
            library_ms=None,
            bound=bound(n * d * 4 + t9.numel() * 4 + n * sh["C"] * 4, n * L9 * (walk + interp))))
    for sh in shapes["permuto.bwd"]:
        t9, x01, res, meta9, size = sh["args"]
        (n, d), L9, F9 = x01.shape, res.shape[0], int(meta9[0, 1])
        dx = sh["need_dx"]
        walk = 4 * d + 11 * (d + 1)
        out.setdefault("permuto.bwd", []).append(dict(
            shape=f"[{n:,}, 4]{', d x01' if dx else ''}, the features' cotangent",
            **card_ms(lambda: pm.permuto_bwd(*sh["args"], sh["d_out"], None, dx)),
            plain_ms=cuda_ms(lambda: pm.permuto_bwd_plain(*sh["args"], sh["d_out"], None, dx),
                             reps=3),
            library_ms=None,
            # x01 and the cotangent read (the table too for d x01), the table's
            # gradient (and d x01) written
            bound=bound(n * d * 4 * (2 if dx else 1) + t9.numel() * 4 * (2 if dx else 1)
                        + n * sh["d_out"].shape[1] * 4,
                        n * L9 * (walk + 10 * (d + 1) * F9 + (4 * d * (d + 1) if dx else 0)))))
    cargs, bargs = shapes["volume_composite"], shapes["volume_composite.bwd"]
    n, S = cargs[0].shape
    out["volume_composite"] = [dict(
        shape=f"rays={n:,} S={S} (EmerNeRF's close range, with rgb and zero nablas)",
        **card_ms(lambda: buffers.volume_composite(*cargs)),
        plain_ms=cuda_ms(lambda: buffers.volume_composite_plain(*cargs), reps=3),
        library_ms=None, bound=bound(n * S * 37 + n * 36, n * S * 18))]
    out["volume_composite.bwd"] = [dict(
        shape=f"rays={n:,} S={S}, the step's cotangents",
        **card_ms(lambda: buffers.volume_composite_bwd(*bargs)),
        plain_ms=cuda_ms(lambda: buffers.volume_composite_bwd_plain(*bargs), reps=3),
        library_ms=None, bound=bound(n * S * 37 + n * 32 + n * S * 28, n * S * 40))]
    for name, rows in out.items():
        for r in rows:
            log(f"timing {name} (emernerf): {r['ms']:.4f} ms ({card_extra(r)[2:]}, plain "
                f"{r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]}, library "
                f"none) at {r['shape']}")
    return out


def emernerf_held_loss(scene, trainer, state, loader, dev):
    """The rgb loss over every pixel of EMER_HELD_FRAMES of the first camera,
    each frame's query with the same draws (EMER_HELD_SEED), no parameter
    moved: the mean over the frames."""
    import torch
    from neuralsim_torch.dataio.dataloader import ImageSampler
    cam = loader.cam_ids[0]
    sampler = ImageSampler(loader, 1)
    vals = []
    with torch.no_grad():
        for fi in EMER_HELD_FRAMES:
            fr = sampler.get(cam, fi)
            n = fr["rays_xy"].shape[0]
            batch = {"rays_fidx": torch.full((n,), fi, dtype=torch.int32, device=dev),
                     "rays_xy": torch.from_numpy(fr["rays_xy"]).to(dev),
                     "image_rgb": torch.from_numpy(np.ascontiguousarray(fr["image_rgb"])).to(dev)}
            gen = torch.Generator(device=dev).manual_seed(EMER_HELD_SEED)
            noise = trainer.draw_noise(n, gen, state.it)
            _, extras = trainer.compute_losses(state.params, batch, state.it, noise, None,
                                               "pixel", cam)
            vals.append(float(extras["losses"]["loss_rgb"]))
    return float(np.mean(vals))


def check_emernerf_training(scene, trainer, state, samplers, loader, dev):
    """EMER_ITERS loop iterations (tools.train's train_loop) with every
    metric logged: finite losses (the flow and dynamic sparsity among
    them), no skip, the held set's rgb loss (emernerf_held_loss) lower after
    the last iteration than after EMER_EARLY, each kernel launched as
    counted (EMER_STEP_LAUNCHES an iteration, nothing else), no plain
    version on the card -> (log, launches, (held before, after), iteration
    ms median of the later iterations)."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.tools.train import train_loop
    gen = torch.Generator(device=dev).manual_seed(11)
    draw = lambda step, n, g, it: trainer.draw_noise(n, g, it, step)
    log_, iter_s, held, launches, plain = [], [], [], {}, {}
    for end in (EMER_EARLY, EMER_ITERS):
        kernels.reset_counts()
        with no_plain_on_card("emernerf training"), plain_on_card(plain):
            train_loop(scene, trainer, state, samplers, end, gen, 1, log_, iter_s=iter_s,
                       draw=draw)
            torch.cuda.synchronize()
        for k in kernels.KERNELS.values():
            launches[k.name] = launches.get(k.name, 0) + k.launches
        held.append(emernerf_held_loss(scene, trainer, state, loader, dev))
    for rec in log_:
        for k in ("loss_total", "loss_rgb", "loss_mask", "loss_flow", "loss_dynamic_sparsity"):
            if not np.isfinite(rec[k]):
                raise AssertionError(f"non-finite {k} at iteration {rec['it']}")
    if log_[-1]["skips_total"] != 0 or len(log_) != EMER_ITERS:
        raise AssertionError(f"{log_[-1]['skips_total']} steps were skipped")
    want = {name: EMER_ITERS * EMER_STEP_LAUNCHES.get(name, 0) for name in launches}
    if launches != want or plain["plain_on_card"]:
        raise AssertionError(f"the EmerNeRF path's launches are not as counted: {launches}, "
                             f"want {want}; plain calls on the card {plain['plain_on_card']}")
    ms = float(np.median(iter_s[EMER_EARLY:]) * 1e3)
    mean = lambda k, rs: float(np.mean([rec[k] for rec in rs]))
    log(f"emernerf training: {EMER_ITERS} iterations of {samplers['pixel'].n_rays} rays, "
        f"launches {launches}; held rgb loss (every pixel of frames {EMER_HELD_FRAMES}) after "
        f"{EMER_EARLY} iterations {held[0]:.5f}, after {EMER_ITERS} {held[1]:.5f}; loss_flow "
        f"first 10 {mean('loss_flow', log_[:10]):.3g}, last 10 {mean('loss_flow', log_[-10:]):.3g}"
        f"; loss_dynamic_sparsity first 10 {mean('loss_dynamic_sparsity', log_[:10]):.3g}, last "
        f"10 {mean('loss_dynamic_sparsity', log_[-10:]):.3g}; iteration median {ms:.2f} ms "
        f"(host clock, iterations {EMER_EARLY}-{EMER_ITERS - 1}, min "
        f"{min(iter_s[EMER_EARLY:]) * 1e3:.2f}, max {max(iter_s[EMER_EARLY:]) * 1e3:.2f})")
    if not held[1] < held[0]:
        raise AssertionError("the held set's rgb loss did not fall")
    return log_, launches, tuple(held), ms


def emernerf_cli(dev, data, tmp):
    """The YAML from the command line on the drive at ``data``:
    tools.train.main for DISK_ITERS iterations into ``tmp``, then eval.main
    and render.main (replay of frame 0) from its exp dir; each tool's K3, K9
    and K6 launched, no plain version on the card, the seven channels
    written, finite scores; the final checkpoint loaded into a fresh build
    holds every tensor of the trained state bit for bit."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.config import load_config
    from neuralsim_torch.tools import eval as single_eval
    from neuralsim_torch.tools import render, train
    from neuralsim_torch.tools.build import build_everything
    from neuralsim_torch.utils.checkpoint import CheckpointIO
    summary = {}

    def run(label, fn, argv, want):
        kernels.reset_counts()
        plain = {}
        t0 = time.perf_counter()
        with no_plain_on_card(label), plain_on_card(plain):
            out = fn(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels.KERNELS.values()}
        log(f"{label}: {secs:.2f} s, launches {counts}")
        missing = [n for n in want if counts[n] <= 0]
        if missing or plain["plain_on_card"]:
            raise AssertionError(f"{label} never launched {missing}, or ran "
                                 f"{plain['plain_on_card']} plain calls on the card")
        return out, secs, counts

    exp = os.path.join(tmp, "emernerf")
    out, summary["emernerf_cli_train_s"], tl = run(
        f"train.main ({EMER_YAML})", train.main,
        ["--config", EMER_YAML, f"--exp_dir={exp}", f"--dataset_cfg.params.root={data}",
         f"--training.num_iters={DISK_ITERS}", "--training.i_log=1"], EMER_KERNELS)
    losses = [v for rec in out["log"] for k, v in rec.items() if k.startswith("loss")]
    if out["skips_total"] or len(out["iter_s"]) != DISK_ITERS \
            or not all(map(math.isfinite, losses + [out["psnr"]])):
        raise AssertionError("the EmerNeRF YAML skipped a step or logged a non-finite value")
    summary["emernerf_cli_iteration_ms"] = float(np.median(out["iter_s"]) * 1e3)
    state = out["state"]
    want_bits = {k: v.detach().cpu().clone() for k, v in state_tensors(state).items()}
    del out
    at = ["--resume_dir", exp]
    ev, summary["emernerf_cli_eval_s"], el = run(
        "eval.main (emernerf)", single_eval.main, at + ["--eval.frames=0,3,6"],
        ("lotd_grid", "permuto", "volume_composite"))
    vals = [v for v in ev["mean"].values() if v is not None]
    if len(ev["per_frame"]) != 3 or not all(map(math.isfinite, vals)):
        raise AssertionError("the EmerNeRF evaluation's scores are not finite")
    r, summary["emernerf_cli_render_s"], rl = run(
        "render.main (emernerf replay)", render.main,
        at + ["--render.mode=replay", "--render.frames=0", "--render.video=false"],
        ("lotd_grid", "permuto", "volume_composite"))
    files = sorted(os.listdir(r["out_dir"]))
    log(f"render replay (emernerf): {files}")
    if not {f"{ch}_0000.png" for ch in EMER_CHANNELS} <= set(files):
        raise AssertionError("the EmerNeRF replay did not write its eight channels")
    # the final checkpoint into a fresh build
    cfg = load_config(os.path.join(exp, "config.json"))
    *_, fresh, _ = build_everything(cfg, dev, pretrain=False)
    before = {k: v.detach().cpu().clone() for k, v in state_tensors(fresh).items()}
    fresh, _ = CheckpointIO(os.path.join(exp, "ckpts")).load(fresh, "final")
    got = {k: v.detach().cpu() for k, v in state_tensors(fresh).items()}
    if set(got) != set(want_bits) or any(
            not torch.equal(got[k], want_bits[k]) for k in want_bits) \
            or all(torch.equal(before[k], want_bits[k]) for k in want_bits
                   if k.startswith("param")):
        raise AssertionError("the EmerNeRF checkpoint did not restore the trained state's bits")
    log(f"emernerf checkpoint: {len(got)} tensors of the trained state restored bit-equal")
    summary.update(emernerf_cli_eval_mean=ev["mean"],
                   emernerf_cli_launches={"train": tl, "eval": el, "render": rl})
    return summary


def emernerf_phase(dev, data, tmp, profile_it):
    """Phase 16: EmerNeRF (configs/waymo_emernerf.yaml at full width on the
    drive written to ``data``): the build, the first step card vs CPU, K3,
    K9 at d 4 (with its x01 backward) and K6 at a pixel step's own inputs
    and cotangents against their plain versions and timed, 48 iterations
    with the held set's rgb loss falling, then the YAML from the command
    line (train, eval, render replay) -> its results."""
    import torch
    from neuralsim_torch.fields.emernerf import EmerNeRFField
    from neuralsim_torch.tools.build import build_everything
    from neuralsim_torch.tools.train import build_samplers
    t0 = time.perf_counter()
    cfg = emernerf_cfg(data, EMER_ITERS)
    timings = {}
    scene, bank, renderer, trainer, state, loader = build_everything(cfg, timings=timings)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    samplers = build_samplers(cfg["training"], loader, int(cfg["seed"]))
    field = state.params[renderer.pkey("cr")]
    enc_s, enc_d = field.static_enc, field.dyn_enc
    specs = [(s.res, s.typ) for s in enc_s.specs]
    parts = ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
    log(f"emernerf: built in {build_s:.2f} s ({parts}); box {field.space.aabb_min.tolist()}..{field.space.aabb_max.tolist()}; static "
        f"{specs}, {enc_s.total_params:,} table floats; dynamic d {enc_d.input_dim}, "
        f"{enc_d.n_levels} levels {enc_d.levels[0][0]:g}..{enc_d.levels[-1][0]:g} of "
        f"{enc_d.table_size:,} rows, {enc_d.total_params:,} floats; {renderer.query_cfg} a ray, "
        f"{samplers['pixel'].n_rays} rays a step, roles {renderer.param_keys}")
    if not isinstance(field, EmerNeRFField) \
            or [t for _, t in specs] != ["dense"] * 4 + ["hash"] * 8 \
            or enc_s.specs[-1].res != 2048 or enc_s.specs[-1].size != 2 ** 18 \
            or enc_d.input_dim != 4 or enc_d.n_levels != 12 or enc_d.table_size != 2 ** 17 \
            or renderer.query_cfg.get("num_coarse") != EMER_SAMPLES \
            or samplers["pixel"].n_rays != EMER_RAYS \
            or state.occ is not None or "distant" in renderer.param_keys:
        raise AssertionError("the EmerNeRF model is not the YAML's at full width")
    loss_err, grad_err = check_emernerf_first_step(scene, trainer, state, samplers, dev)
    record, step_launches = capture_emernerf_step(trainer, state, samplers, dev)
    errs, shapes = check_emernerf_kernels(dev, enc_s, enc_d, record)
    del record
    log_, launches, held, it_ms = check_emernerf_training(scene, trainer, state, samplers,
                                                          loader, dev)
    times = time_emernerf_kernels(shapes)
    del shapes
    if profile_it:
        from torch.profiler import ProfilerActivity, profile
        gen = torch.Generator(device=dev).manual_seed(31)
        batch, cam = emernerf_batch(samplers, None, dev)
        noise = trainer.draw_noise(batch["rays_fidx"].shape[0], gen, state.it)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(state, batch, noise, "pixel", cam)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    cli = emernerf_cli(dev, data, tmp)
    summary = {"emernerf_build_s": build_s, "emernerf_build_parts_s": timings,
               "emernerf_first_step_loss_rel_err": loss_err,
               "emernerf_first_step_grad_rel_err": grad_err,
               "emernerf_iterations": EMER_ITERS, "emernerf_iteration_ms": it_ms,
               "emernerf_held_rgb_loss": held,
               "emernerf_loss_flow_last": log_[-1]["loss_flow"],
               "emernerf_loss_dynamic_sparsity_last": log_[-1]["loss_dynamic_sparsity"],
               "emernerf_step_launches": step_launches,
               "emernerf_phase_s": time.perf_counter() - t0, **cli}
    return dict(summary=summary, errs=errs, times=times, launches=launches, iters=EMER_ITERS)


# Phase 17: pose refinement on EmerNeRF's path (the YAML plus a Pose asset)
POSE_ARGV = ("--assetbank_cfg.Pose.model_class=neuralsim_tpu.models.assets.LearnableParams",
             "--assetbank_cfg.Pose.model_params.refine_nodes=[ego_car,camera_FRONT]",
             "--assetbank_cfg.Pose.model_params.refine_intr=[camera_FRONT]",
             "--assetbank_cfg.Pose.asset_params.training_cfg.lr=0.001")
POSE_TS_ARGV = ("--assetbank_cfg.Pose.model_params.refine_ts=[camera_FRONT]",
                "--training.use_ts_interp=true")
POSE_ENABLE_AFTER = 10
POSE_ITERS = 48
# the first step's seeded deltas: 1e-3 rad, 1 cm, 0.5 px, 10 ms (a tenth of
# the drive's frame interval), each leaf's N(0, 1) draws times its scale
POSE_DELTA_SCALE = {"dquat": 1e-3, "dtrans": 1e-2, "dintr": 0.5, "dts": 1e-2}
POSE_KERNELS = EMER_KERNELS + POSE_ONLY
# a pixel step with pose deltas: EmerNeRF's launches and K3's backward to the
# positions once (K9's backward at the rendered samples now with d x01, K6's
# with d t: the same launches)
POSE_STEP_LAUNCHES = {**EMER_STEP_LAUNCHES, "lotd_grid.bwd_x": 1}


def pose_cfg(root, num_iters):
    """configs/waymo_emernerf.yaml with the drive's root, the schedule's
    length, POSE_ARGV, the camera's timestamp delta (``refine_ts``: read in
    timestamp mode only) and ``enable_after`` POSE_ENABLE_AFTER."""
    from neuralsim_torch.config import load_config
    return load_config(EMER_YAML, [f"--dataset_cfg.params.root={root}",
                                   f"--training.num_iters={num_iters}", *POSE_ARGV,
                                   POSE_TS_ARGV[0],
                                   f"--assetbank_cfg.Pose.model_params.enable_after="
                                   f"{POSE_ENABLE_AFTER}"])


def pose_deltas(params):
    """The Pose asset's leaves {name: tensor}."""
    return dict(params["Pose"].named_parameters())


def set_pose_deltas(params, seed):
    """Each delta leaf to seeded N(0, 1) draws times POSE_DELTA_SCALE (None:
    zeros, a fresh asset)."""
    import torch
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in pose_deltas(params).items():
            v = np.zeros(p.shape, np.float32) if seed is None else \
                (rng.normal(size=p.shape) * POSE_DELTA_SCALE[name.split(".")[-1]])
            p.copy_(torch.from_numpy(np.asarray(v, np.float32)))


def as_float64(tree):
    """Floating tensors of a dict / list tree in float64."""
    if isinstance(tree, dict):
        return {k: as_float64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_float64(v) for v in tree]
    return tree.double() if tree.is_floating_point() else tree


def check_pose_first_steps(scene, trainer, state, samplers, dev):
    """The first pixel step card vs CPU with seeded non-zero deltas past the
    gate, in both lifts (frame slicing, and timestamp mode with the camera's
    ``dts``), at check_emernerf_first_step's limits: losses 2e-4, every
    gradient leaf, the deltas' included, 2e-3 of its largest entry. The
    same step also runs on the CPU in float64 (parameters, scene, batch and
    draws; the plain versions follow the table's type there): a pose leaf
    that misses 2e-3 against the float32 CPU is held to that yardstick
    instead (compare_first_step). Every delta leaf reached (``dts`` in
    timestamp mode only); the deltas zero again after it -> {mode: (loss
    rel err, gradient rel err against the float32 CPU, {pose leaf: (card vs
    float32 CPU, card vs float64, float32 CPU vs float64) over its largest
    entry})}."""
    out = {}
    gate = trainer.pose_enable_after
    set_pose_deltas(state.params, 41)
    trainer.pose_enable_after = 0
    try:
        for mode in ("slice_at", "timestamps"):
            trainer.use_ts_interp = mode == "timestamps"
            batch, cam, noise = first_step_inputs(trainer, state, samplers)
            cpu = first_step_side(scene, trainer, copy.deepcopy(state.params).to("cpu"), batch,
                                  cam, noise, 0, "cpu")
            card = first_step_side(scene, trainer, state.params, batch, cam, noise, 0, dev)
            scene64 = scene_on(scene, "cpu")
            for n in scene64.nodes_topo:
                n.frame_data = as_float64(n.frame_data)
            exact = first_step_side(scene64, trainer,
                                    copy.deepcopy(state.params).to("cpu").double(),
                                    as_float64(batch), cam, as_float64(noise), 0, "cpu")[1]
            le, ge, _, leaves = compare_first_step(f"pose ({mode})", trainer, cpu, card, exact)
            want = {f"Pose.{k}" for k in pose_deltas(state.params)
                    if mode == "timestamps" or not k.endswith(".dts")}
            if set(leaves) != want:
                raise AssertionError(f"the {mode} step reaches the deltas {sorted(leaves)}, "
                                     f"not {sorted(want)}")
            log(f"pose first step ({mode}): the deltas' gradients (card vs float32 CPU, card vs "
                f"float64, float32 CPU vs float64, of the leaf's largest) "
                f"{json.dumps({k: [float(f'{x:.3g}') for x in v] for k, v in leaves.items()})}")
            out[mode] = (le, ge, leaves)
    finally:
        trainer.pose_enable_after = gate
        trainer.use_ts_interp = False
        set_pose_deltas(state.params, None)
    return out


def capture_pose_step(trainer, state, samplers, dev):
    """One pixel step of the YAML's 8,192 rays with seeded deltas past the
    gate, no parameter moved, with the kernels' inputs, cotangents and
    keyword arguments recorded and their launches counted (POSE_STEP_LAUNCHES,
    nothing else) -> record."""
    import torch
    from neuralsim_torch import kernels
    batch, cam = emernerf_batch(samplers, None, dev)
    noise = trainer.draw_noise(batch["rays_fidx"].shape[0],
                               torch.Generator(device=dev).manual_seed(43), state.it)
    record = {}
    set_pose_deltas(state.params, 42)
    kernels.reset_counts()
    with emernerf_recorded(record):
        total, _ = trainer.compute_losses(state.params, batch, POSE_ENABLE_AFTER, noise, None,
                                          "pixel", cam)
        total.backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    state.params.zero_grad(set_to_none=True)
    set_pose_deltas(state.params, None)
    got = {k: len(v) for k, v in record.items() if k != "kw"}
    if got != POSE_STEP_LAUNCHES or {k: launches[k] for k in POSE_KERNELS} != got \
            or sum(launches.values()) != sum(got.values()):
        raise AssertionError(f"a pose step should call {POSE_STEP_LAUNCHES} and launch nothing "
                             f"else: calls {got}, launches {launches}")
    if record["kw"]["volume_composite.bwd"] != [{"with_dt": True}]:
        raise AssertionError("K6's backward on the pose path should give d t")
    return record


def k3_bwd_x_cases(table, meta, dev):
    """K3's backward to the positions at its edges on the step's own table
    and meta: k3_edge_points (0, 1, one ulp below 1, -0.25, 1.5 on every
    axis, then uniform in [-0.1, 1.1]) and every level's cell faces k / res
    (with a point a ulp to either side), [(label, points)]."""
    import torch
    rows = meta.tolist()
    faces = []
    for res, *_ in rows:
        k = np.arange(res + 1, dtype=np.float32) / np.float32(res)
        k = np.concatenate([k, np.nextafter(k, np.float32(-1)), np.nextafter(k, np.float32(2))])
        g = np.random.default_rng(res).random((k.size, 3)).astype(np.float32)
        g[:, res % 3] = k
        faces.append(g)
    return [("k3_edge_points", torch.from_numpy(k3_edge_points(65_537, 430)).to(dev)),
            ("cell faces of every level", torch.from_numpy(np.concatenate(faces)).to(dev))]


def check_pose_kernels(dev, enc_s, record):
    """K3's backward to the positions at the step's own points, table and
    cotangent, at k3_bwd_x_cases on the same table and at K3's edge
    encodings (F 1-8, levels staged, interleaved and read from the table),
    within GRAD_REL of its plain version and the same bits on two calls; K9's
    backward with d x01 at the step's [786,432, 4] samples; K6's backward with
    d t at the step's cotangents (float64 yardstick) and N(0, 1) ones with a
    depth cotangent (GRAD_REL) -> ({kernel: (max err, tol)}, the timings'
    inputs)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.encodings import permuto as pm
    from neuralsim_torch.renderers import buffers
    errs, shapes = {}, {}
    (table, x, meta, d_out, plan, scratch), = record["lotd_grid.bwd_x"]
    N = x.shape[0]
    if x.shape != (EMER_RAYS * EMER_SAMPLES, 3) or d_out.shape != (enc_s.out_dim, N) \
            or plan != enc_s.grid_fwd_plan:
        raise AssertionError(f"K3's backward to the positions should see the step's "
                             f"[786,432, 3] samples: {tuple(x.shape)}")
    fn = lambda: lotd.lotd_grid_bwd_x(table, x, meta, d_out, plan, scratch)
    e = [compare_rel(f"K3 bwd x emernerf static samples N={N:,}", [fn()],
                     [lotd.lotd_grid_bwd_x_plain(table, x, meta, d_out)], GRAD_REL)]
    same_bits("K3 bwd x emernerf static samples", fn)
    for label, pts in k3_bwd_x_cases(table, meta, dev):
        cot = cotangents((enc_s.out_dim, pts.shape[0]), 44, dev)
        e.append(compare_rel(f"K3 bwd x on the static table, {label} N={pts.shape[0]:,}",
                             [lotd.lotd_grid_bwd_x(table, pts, meta, cot)],
                             [lotd.lotd_grid_bwd_x_plain(table, pts, meta, cot)], GRAD_REL))
        same_bits(f"K3 bwd x {label}", lambda: lotd.lotd_grid_bwd_x(table, pts, meta, cot))
    for label, tb, pts, mt, C, pl in k3_edge_cases(dev):
        cot = cotangents((C, pts.shape[0]), 45, dev)
        got = lotd.lotd_grid_bwd_x(tb, pts, mt, cot, pl)
        e.append(compare_rel(f"K3 bwd x edge {label}", [got],
                             [lotd.lotd_grid_bwd_x_plain(tb, pts, mt, cot)], GRAD_REL))
        if not torch.equal(got, lotd.lotd_grid_bwd_x(tb, pts, mt, cot, pl)):
            raise AssertionError(f"K3 bwd x edge {label}: two calls differ")
    errs["lotd_grid.bwd_x"] = (max(e), GRAD_REL)
    shapes["lotd_grid.bwd_x"] = dict(args=(table, x, meta, d_out, plan, scratch))
    # K9's backward with d x01 at the rendered samples
    bwd = [b for b in record["permuto.bwd"] if b[1].shape[0] == N]
    if len(bwd) != 1 or not bwd[0][-1]:
        raise AssertionError("K9's backward at the rendered samples should give d x01")
    table9, x01, res, meta9, size, d_o, _, _ = bwd[0]
    a = (table9, x01, res, meta9, size)
    gt, gx = pm.permuto_bwd(*a, d_o, None, True)
    wt, wx = pm.permuto_bwd_plain(*a, d_o, None, True)
    what = f"K9 bwd emernerf d 4 N={N:,} with d x01 (pose)"
    e9 = max(compare_rel(what + ", d table", [gt], [wt], GRAD_REL),
             compare_rel(what + ", d x01", [gx], [wx], K9_DX_REL))
    if not torch.equal(gx, pm.permuto_bwd(*a, d_o, None, True)[1]):
        raise AssertionError("K9 bwd: d x01 differs between two calls")
    errs["permuto.bwd"] = (e9, GRAD_REL)
    shapes["permuto.bwd"] = dict(args=a, d_out=d_o)
    # K6's backward with d t
    (bargs,) = record["volume_composite.bwd"]
    f64 = [x_.double() if x_ is not None and x_.dtype == torch.float32 else x_ for x_ in bargs]
    e6 = compare_f64("K6 bwd emernerf [8,192, 96] with d t, the step's cotangents",
                     buffers.volume_composite_bwd(*bargs, with_dt=True),
                     buffers.volume_composite_bwd_plain(*bargs, with_dt=True),
                     buffers.volume_composite_bwd_plain(*f64, with_dt=True))
    cargs = bargs[:5]
    n6, s6 = cargs[0].shape
    rand = [cotangents(sh, 46 + i, dev) for i, sh in enumerate(
        ((n6, s6), (n6,), (n6,), (n6, 3), (n6, 3)))]
    got = buffers.volume_composite_bwd(*cargs, *rand, with_dt=True)
    want = buffers.volume_composite_bwd_plain(*cargs, *rand, with_dt=True)
    if float(want[3].abs().max()) <= 0:
        raise AssertionError("K6's d t should not vanish under a depth cotangent")
    e6 = max(e6, compare_rel("K6 bwd emernerf [8,192, 96] with d t, N(0, 1) cotangents",
                             got, want, GRAD_REL))
    same_bits("K6 bwd with d t", lambda: buffers.volume_composite_bwd(*cargs, *rand,
                                                                     with_dt=True))
    errs["volume_composite.bwd"] = (e6, GRAD_REL)
    shapes["volume_composite.bwd"] = (*cargs, *rand)
    torch.cuda.synchronize()
    return errs, shapes


def time_pose_kernels(shapes):
    """K3's backward to the positions, K9's backward with d x01 and K6's with
    d t, queued and back to back at the step's own inputs, beside their plain
    versions and least times -> {kernel: [timing]}."""
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.fields.encodings import permuto as pm
    from neuralsim_torch.renderers import buffers
    out = {}
    table, x, meta, d_out, plan, scratch = shapes["lotd_grid.bwd_x"]["args"]
    N, C, T = x.shape[0], d_out.shape[0], table.numel()
    L, F = meta.shape[0], int(meta[0, 3])
    # points, cotangent and the table read once, d x written; 8 corners a
    # level: the weights' derivatives, F multiply-adds and 3 more
    out["lotd_grid.bwd_x"] = [dict(
        shape=f"[{N:,}, 3] the static branch's samples, d_out [{C}, N], {L} levels of F {F}, "
              f"{T:,} table floats",
        **card_ms(lambda: lotd.lotd_grid_bwd_x(table, x, meta, d_out, plan, scratch)),
        plain_ms=cuda_ms(lambda: lotd.lotd_grid_bwd_x_plain(table, x, meta, d_out), reps=3),
        library_ms=None, bound=bound(N * 12 + C * N * 4 + T * 4 + N * 12,
                                     N * L * 8 * (2 * F + 12)))]
    a, d_o = shapes["permuto.bwd"]["args"], shapes["permuto.bwd"]["d_out"]
    t9, x01 = a[0], a[1]
    (n, d), L9, F9 = x01.shape, a[2].shape[0], int(a[3][0, 1])
    walk = 4 * d + 11 * (d + 1)
    out["permuto.bwd"] = [dict(
        shape=f"[{n:,}, 4] the rendered samples with d x01 (pose), the features' cotangent",
        **card_ms(lambda: pm.permuto_bwd(*a, d_o, None, True)),
        plain_ms=cuda_ms(lambda: pm.permuto_bwd_plain(*a, d_o, None, True), reps=3),
        library_ms=None,
        bound=bound(n * d * 4 * 2 + t9.numel() * 4 * 2 + n * d_o.shape[1] * 4,
                    n * L9 * (walk + 10 * (d + 1) * F9 + 4 * d * (d + 1))))]
    bargs = shapes["volume_composite.bwd"]
    n6, S = bargs[0].shape
    out["volume_composite.bwd"] = [dict(
        shape=f"rays={n6:,} S={S} with d t, N(0, 1) cotangents",
        **card_ms(lambda: buffers.volume_composite_bwd(*bargs, with_dt=True)),
        plain_ms=cuda_ms(lambda: buffers.volume_composite_bwd_plain(*bargs, with_dt=True),
                         reps=3),
        library_ms=None, bound=bound(n6 * S * 37 + n6 * 32 + n6 * S * 32, n6 * S * 42))]
    for name, rows in out.items():
        for r in rows:
            log(f"timing {name} (pose): {r['ms']:.4f} ms ({card_extra(r)[2:]}, plain "
                f"{r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]}, library "
                f"none) at {r['shape']}")
    return out


def pose_norms(params):
    return {k: float(v.detach().norm()) for k, v in pose_deltas(params).items()}


def check_pose_training(scene, trainer, state, samplers, loader, dev):
    """POSE_ITERS loop iterations from zero deltas: exactly zero through
    iteration POSE_ENABLE_AFTER - 1, non-zero and finite after it (the
    camera's dts, which frame slicing does not read, stays zero); no skip;
    the held set's rgb loss lower after the last iteration than after
    POSE_ENABLE_AFTER; POSE_STEP_LAUNCHES an iteration and nothing else; no
    plain version on the card -> (log, launches, held, iteration ms median,
    {iteration: the deltas' norms})."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.tools.train import train_loop
    gen = torch.Generator(device=dev).manual_seed(47)
    draw = lambda step, n, g, it: trainer.draw_noise(n, g, it, step)
    log_, iter_s, held, launches, plain, norms = [], [], [], {}, {}, {}
    for end in (POSE_ENABLE_AFTER, POSE_ITERS):
        kernels.reset_counts()
        with no_plain_on_card("pose training"), plain_on_card(plain):
            train_loop(scene, trainer, state, samplers, end, gen, 1, log_, iter_s=iter_s,
                       draw=draw)
            torch.cuda.synchronize()
        for k in kernels.KERNELS.values():
            launches[k.name] = launches.get(k.name, 0) + k.launches
        held.append(emernerf_held_loss(scene, trainer, state, loader, dev))
        norms[end] = pose_norms(state.params)
        d = pose_deltas(state.params)
        if end == POSE_ENABLE_AFTER and any(v.any() for v in d.values()):
            raise AssertionError(f"the deltas moved before the gate: {norms[end]}")
        if end == POSE_ITERS and any(
                not torch.isfinite(v).all() or bool(v.any()) == k.endswith(".dts")
                for k, v in d.items()):
            raise AssertionError(f"the deltas after the gate should be non-zero and finite, "
                                 f"dts zero: {norms[end]}")
    for rec in log_:
        for k in ("loss_total", "loss_rgb", "loss_mask", "loss_flow", "loss_dynamic_sparsity"):
            if not np.isfinite(rec[k]):
                raise AssertionError(f"non-finite {k} at iteration {rec['it']}")
    if log_[-1]["skips_total"] != 0 or len(log_) != POSE_ITERS:
        raise AssertionError(f"{log_[-1]['skips_total']} steps were skipped")
    want = {name: POSE_ITERS * POSE_STEP_LAUNCHES.get(name, 0) for name in launches}
    if launches != want or plain["plain_on_card"]:
        raise AssertionError(f"the pose path's launches are not as counted: {launches}, "
                             f"want {want}; plain calls on the card {plain['plain_on_card']}")
    ms = float(np.median(iter_s[POSE_ENABLE_AFTER:]) * 1e3)
    log(f"pose training: {POSE_ITERS} iterations of {samplers['pixel'].n_rays} rays, the gate "
        f"at {POSE_ENABLE_AFTER}, launches {launches}; held rgb loss after "
        f"{POSE_ENABLE_AFTER} iterations {held[0]:.5f}, after {POSE_ITERS} {held[1]:.5f}; the "
        f"deltas' norms {json.dumps(norms)}; iteration median {ms:.2f} ms (host clock, "
        f"iterations {POSE_ENABLE_AFTER}-{POSE_ITERS - 1}, min "
        f"{min(iter_s[POSE_ENABLE_AFTER:]) * 1e3:.2f}, max {max(iter_s[POSE_ENABLE_AFTER:]) * 1e3:.2f})")
    if not held[1] < held[0]:
        raise AssertionError("the held set's rgb loss did not fall")
    return log_, launches, tuple(held), ms, norms


def time_pose_overhead(trainer, state, samplers, dev, n=12):
    """What pose refinement costs an iteration: pixel steps of the YAML's
    8,192 rays with the pose model and without it (the same trainer, its
    ``pose_model_id`` set aside: no delta, no gradient to the positions), in
    turns, each ended by a device sync -> {"pose"|"no_pose": (host ms median,
    device ms median by CUDA events)}."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(53)
    times = {"pose": ([], []), "no_pose": ([], [])}
    mid = trainer.pose_model_id
    try:
        for i in range(2 * n):
            label = ("pose", "no_pose")[i % 2]
            trainer.pose_model_id = mid if label == "pose" else None
            batch, cam = emernerf_batch(samplers, None, dev)
            noise = trainer.draw_noise(batch["rays_fidx"].shape[0], gen, state.it, "pixel")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            trainer.train_step(state, batch, noise, "pixel", cam)
            end.record()
            torch.cuda.synchronize()
            if i >= 2:                      # a warm-up step each
                times[label][0].append((time.perf_counter() - t0) * 1e3)
                times[label][1].append(start.elapsed_time(end))
    finally:
        trainer.pose_model_id = mid
    out = {k: (float(np.median(h)), float(np.median(d))) for k, (h, d) in times.items()}
    log(f"pose overhead: a pixel step of {EMER_RAYS} rays with the pose model {out['pose'][0]:.2f} "
        f"ms host, {out['pose'][1]:.2f} ms by CUDA events; without it {out['no_pose'][0]:.2f}, "
        f"{out['no_pose'][1]:.2f} (medians of {n - 1}, in turns)")
    return out


def pose_cli(dev, data, tmp):
    """The YAML plus POSE_ARGV from the command line on the drive at
    ``data``: tools.train.main for DISK_ITERS iterations (the deltas from
    iteration 0), its launches, the deltas moved and finite; the final
    checkpoint in a fresh build holds every tensor, the deltas among them,
    bit for bit; then one iteration in timestamp mode (POSE_TS_ARGV) that
    moves the camera's dts."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.config import load_config
    from neuralsim_torch.tools import train
    from neuralsim_torch.tools.build import build_everything
    from neuralsim_torch.utils.checkpoint import CheckpointIO
    summary = {}

    def run(label, argv):
        kernels.reset_counts()
        plain = {}
        t0 = time.perf_counter()
        with no_plain_on_card(label), plain_on_card(plain):
            out = train.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels.KERNELS.values()}
        log(f"{label}: {secs:.2f} s, launches {counts}")
        missing = [n for n in POSE_KERNELS if counts[n] <= 0]
        if missing or plain["plain_on_card"] or out["skips_total"]:
            raise AssertionError(f"{label} never launched {missing}, ran "
                                 f"{plain['plain_on_card']} plain calls on the card or skipped")
        return out, secs

    exp = os.path.join(tmp, "pose")
    base = ["--config", EMER_YAML, f"--dataset_cfg.params.root={data}", *POSE_ARGV,
            "--training.i_log=1"]
    out, summary["pose_cli_train_s"] = run(
        "train.main (emernerf + Pose)", base + [f"--exp_dir={exp}",
                                                f"--training.num_iters={DISK_ITERS}"])
    if out["trainer"].pose_model_id != "Pose" or len(out["iter_s"]) != DISK_ITERS:
        raise AssertionError("the command line did not bind the Pose asset")
    d = pose_deltas(out["state"].params)
    if any(not torch.isfinite(v).all() or not v.any() for v in d.values()):
        raise AssertionError("the command line's deltas did not move, or are not finite")
    summary["pose_cli_norms"] = pose_norms(out["state"].params)
    want_bits = {k: v.detach().cpu().clone() for k, v in state_tensors(out["state"]).items()}
    del out
    cfg = load_config(os.path.join(exp, "config.json"))
    *_, fresh, _ = build_everything(cfg, dev, pretrain=False)
    fresh, _ = CheckpointIO(os.path.join(exp, "ckpts")).load(fresh, "final")
    got = {k: v.detach().cpu() for k, v in state_tensors(fresh).items()}
    if set(got) != set(want_bits) or any(not torch.equal(got[k], want_bits[k])
                                         for k in want_bits) \
            or not any(k.startswith("param Pose.") for k in got):
        raise AssertionError("the pose run's checkpoint did not restore its bits")
    log(f"pose checkpoint: {len(got)} tensors restored bit-equal, the deltas among them")
    del fresh
    out, summary["pose_cli_ts_train_s"] = run(
        "train.main (emernerf + Pose, timestamp mode)",
        base + [*POSE_TS_ARGV, f"--exp_dir={exp}_ts", "--training.num_iters=1"])
    dts = pose_deltas(out["state"].params)["camera_FRONT.dts"]
    if not out["trainer"].use_ts_interp or not dts.any() or not torch.isfinite(dts).all():
        raise AssertionError("timestamp mode did not move the camera's dts")
    return summary


def lift_split(prof):
    """A profiled step's aten ops and device ms (kernels under each op),
    split into the lift's forward (the ``pose lift`` range) and its backward
    (the autograd nodes whose sequence numbers the lift's ops took) ->
    {"lift_fwd": (ops, ms), "lift_bwd": (ops, ms)}."""
    def ops(e):
        return (e.name.startswith("aten::")) + sum(ops(c) for c in e.cpu_children)

    def below(e):
        yield e
        for c in e.cpu_children:
            yield from below(c)
    events = prof.events()
    fwd = [e for e in events if e.name == "pose lift"]
    seq = {d.sequence_nr for e in fwd for d in below(e) if d.sequence_nr >= 0}
    bwd = [e for e in events if e.name.startswith("autograd::engine::evaluate_function")
           and e.sequence_nr in seq]
    return {"lift_fwd": (sum(ops(e) for e in fwd), sum(e.device_time_total for e in fwd) / 1e3),
            "lift_bwd": (sum(ops(e) for e in bwd), sum(e.device_time_total for e in bwd) / 1e3)}


def profile_pose_steps(trainer, state, samplers, dev):
    """One pixel step with the pose model and one without, under the
    profiler: device time by kernel, the busy total against the host's, and
    the aten ops and device ms of the lift's forward and backward
    (lift_split); what the pose model adds beyond the lift is the renderer's
    backward to the positions and the deltas' Adam."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    gen = torch.Generator(device=dev).manual_seed(59)
    mid, lift = trainer.pose_model_id, trainer.lift

    def ranged_lift(*a, **kw):
        with record_function("pose lift"):
            return lift(*a, **kw)
    trainer.lift = ranged_lift
    seen = {}
    try:
        for label, pm_id in (("with the pose model", mid), ("without it", None)):
            trainer.pose_model_id = pm_id
            batch, cam = emernerf_batch(samplers, None, dev)
            noise = trainer.draw_noise(batch["rays_fidx"].shape[0], gen, state.it)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                trainer.train_step(state, batch, noise, "pixel", cam)
                torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            busy = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            n_ops = sum(1 for e in prof.events() if e.name.startswith("aten::"))
            split = lift_split(prof)
            seen[label] = (n_ops, busy, split)
            log(f"pose step profile, {label}: device busy {busy:.2f} ms of {host:.2f} ms on "
                f"the host clock (under the profiler), {n_ops} aten ops; the lift's forward "
                f"{split['lift_fwd'][0]} ops, {split['lift_fwd'][1]:.3f} ms on the device, its "
                f"backward {split['lift_bwd'][0]} ops, {split['lift_bwd'][1]:.3f} ms")
            log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    finally:
        trainer.pose_model_id = mid
        del trainer.lift
    (n1, b1, s1), (n0, b0, s0) = seen.values()
    fwd = (s1["lift_fwd"][0] - s0["lift_fwd"][0], s1["lift_fwd"][1] - s0["lift_fwd"][1])
    bwd = (s1["lift_bwd"][0] - s0["lift_bwd"][0], s1["lift_bwd"][1] - s0["lift_bwd"][1])
    log(f"pose step profile, added by the pose model: {n1 - n0} aten ops, {b1 - b0:.2f} ms "
        f"on the device; the lift's forward {fwd[0]} ops, {fwd[1]:.3f} ms; its backward "
        f"{bwd[0]} ops, {bwd[1]:.3f} ms; the rest (the renderer's backward to the positions, "
        f"the deltas' Adam) {n1 - n0 - fwd[0] - bwd[0]} ops, "
        f"{b1 - b0 - fwd[1] - bwd[1]:.3f} ms")


def pose_phase(dev, data, tmp, profile_it=False):
    """Phase 17: pose refinement (configs/waymo_emernerf.yaml at full width
    plus a Pose asset, on the drive written to ``data``): the build, the
    first step card vs CPU in both lifts, K3's backward to the positions, K9's
    with d x01 and K6's with d t at a pixel step's own inputs against their
    plain versions and timed, POSE_ITERS iterations through the gate, the
    command line and its checkpoint -> its results."""
    import torch
    from neuralsim_torch.models.assets import LearnableParams
    from neuralsim_torch.tools.build import build_everything
    from neuralsim_torch.tools.train import build_samplers
    t0 = time.perf_counter()
    cfg = pose_cfg(data, POSE_ITERS)
    scene, bank, renderer, trainer, state, loader = build_everything(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    samplers = build_samplers(cfg["training"], loader, int(cfg["seed"]))
    field = state.params[renderer.pkey("cr")]
    enc_s = field.static_enc
    shapes_ = {k: tuple(v.shape) for k, v in pose_deltas(state.params).items()}
    log(f"pose: built in {build_s:.2f} s; the Pose asset's leaves {shapes_}, the gate at "
        f"{trainer.pose_enable_after}, lr {float(state.opt['Pose'].lr()):g}")
    if not isinstance(bank.assets.get("Pose"), LearnableParams) \
            or trainer.pose_model_id != "Pose" or trainer.pose_enable_after != POSE_ENABLE_AFTER \
            or trainer.use_ts_interp or set(shapes_) != {
                "ego_car.dquat", "ego_car.dtrans", "camera_FRONT.dquat", "camera_FRONT.dtrans",
                "camera_FRONT.dintr", "camera_FRONT.dts"} \
            or [s.typ for s in enc_s.specs] != ["dense"] * 4 + ["hash"] * 8 \
            or enc_s.specs[-1].size != 2 ** 18 or field.dyn_enc.table_size != 2 ** 17 \
            or renderer.query_cfg.get("num_coarse") != EMER_SAMPLES \
            or samplers["pixel"].n_rays != EMER_RAYS or "distant" in renderer.param_keys:
        raise AssertionError("the pose model is not the YAML's at full width with its Pose asset")
    first = check_pose_first_steps(scene, trainer, state, samplers, dev)
    record = capture_pose_step(trainer, state, samplers, dev)
    errs, shapes = check_pose_kernels(dev, enc_s, record)
    del record
    log_, launches, held, it_ms, norms = check_pose_training(scene, trainer, state, samplers,
                                                             loader, dev)
    times = time_pose_kernels(shapes)
    del shapes
    overhead = time_pose_overhead(trainer, state, samplers, dev)
    if profile_it:
        profile_pose_steps(trainer, state, samplers, dev)
    cli = pose_cli(dev, data, tmp)
    summary = {"pose_build_s": build_s,
               **{f"pose_first_step_{m}": {"loss_rel_err": le, "grad_rel_err": ge,
                                          "pose_leaves_rel_err": leaves}
                  for m, (le, ge, leaves) in first.items()},
               "pose_iterations": POSE_ITERS, "pose_enable_after": POSE_ENABLE_AFTER,
               "pose_iteration_ms": it_ms, "pose_held_rgb_loss": held, "pose_delta_norms": norms,
               "pose_step_ms": overhead["pose"], "pose_no_pose_step_ms": overhead["no_pose"],
               "pose_phase_s": time.perf_counter() - t0, **cli}
    return dict(summary=summary, errs=errs, times=times, launches=launches, iters=POSE_ITERS)


# Phase 18, the simulation tools on phase 15's exp dirs (both YAMLs at full
# width on the drive on disk, DISK_ITERS iterations): a pandar64 (64 x 1,800
# beams) on two frames, a solid-state raster (640 x 128) on one, the
# recorded beams on every frame, each a frame of the street alone through
# K4, K1 (and K3 at StreetSurf's hash levels), K14, K5a, K5b and K12 in
# chunks of the tool's 4,096 beams; NVS at downscale 1; re-simulation; the
# edits; the geometry tools.
SIM_LIDAR_FRAMES = "0,4"
SIM_GRID_FRAMES = "0,4"
SIM_P64_BEAMS = 64 * 1800
SIM_SOLID_BEAMS = 640 * 128
SIM_NVS_FRAMES = 8
SIM_MESH_RES = 128
SIM_SDF_RES = 256
SIM_SDF_CHUNK = 65536
# the street's SDF at the same points on the card and on the CPU, relative to
# 1 + |sdf| (its values reach tens of metres over StreetSurf's box; the
# decoder's products sum in another order, as FIELD_SDF_TOL says)
SIM_SDF_TOL = FIELD_SDF_TOL
SIM_SDF_CHECK = 65536
SIM_TIME_REPS = 3
SIM_EDITS = ("rotate", "translate", "delete", "thanos")
# the compose path of an edit renders without a grid state (the JAX tool
# hands none to its renderer): the street's samples from the uniform ladder
SIM_EDIT_KERNELS = tuple(k for k in EVAL_FRAME_KERNELS if k != "occ_ray_proposal")
SIM_SDF_KERNELS = ("lotd_cp_stacked", "lotd_grid", "lotd_cp_lines")
# a frame differs from the plain replay by more than this many grey levels
# somewhere (JAX's tests/test_cli_train_e2e.py:382-411 holds its own so)
SIM_GREY = 2.0


def png(path):
    from PIL import Image
    return np.asarray(Image.open(path), np.float32)


def lidar_crop(label, cfg, card, o, d):
    """MULTI_CHECK_RAYS beams ``o``, ``d`` (CPU tensors) through
    ``render.lidar_query`` on the card against the CPU path loaded from the
    same checkpoint, at the CPU path's sample depths (sample_placements): each
    beam's mask within STREET_CROP_TOL and its depth within STREET_CROP_TOL
    of 1 + the depth, the hits (mask > LIDAR_HIT) the same, on all but
    STREET_CROP_OFF_MAX of the beams (a position that rounds apart can step
    the bf16 tents, EQUAL_DEPTH_TOL) -> the errors."""
    from types import SimpleNamespace
    from neuralsim_torch.tools.render import LIDAR_HIT, lidar_query, load_render
    cpu = load_render({**cfg, "ckpt": "final"}, "cpu")
    kw = dict(forward_inv_s=256.0, rayschunk=o.shape[0])
    rec = []
    with sample_placements(SimpleNamespace(renderer=cpu.renderer), record=rec):
        dc, mc = lidar_query(cpu.renderer, cpu.params, o, d, occ=cpu.occ, **kw,
                             frozen=cpu.scene.slice_at(0) if cpu.multi else None)
    with no_plain_on_card(f"{label} LiDAR crop at the CPU path's depths"):
        with sample_placements(SimpleNamespace(renderer=card.renderer), replay=rec):
            dev = next(card.params.parameters()).device
            dg, mg = lidar_query(card.renderer, card.params, o.to(dev), d.to(dev), occ=card.occ,
                                 frozen=card.scene.slice_at(0) if card.multi else None, **kw)
    dg, mg = dg.cpu(), mg.cpu()
    e_depth = (dg - dc).abs() / (1.0 + dc.abs())
    e_mask = (mg - mc).abs()
    off = (e_depth > STREET_CROP_TOL) | (e_mask > STREET_CROP_TOL) \
        | ((mg > LIDAR_HIT) != (mc > LIDAR_HIT))
    ok = ~off
    out = dict(beams=o.shape[0], hits_cpu=int((mc > LIDAR_HIT).sum()), off=int(off.sum()),
               depth_err=float(e_depth[ok].max()), mask_err=float(e_mask[ok].max()),
               depth_err_all=float(e_depth.max()), mask_err_all=float(e_mask.max()))
    log(f"{label} LiDAR crop card vs CPU at the CPU path's depths: {json.dumps(out)} "
        f"(tol {STREET_CROP_TOL:g}, at most {STREET_CROP_OFF_MAX:g} of the beams off)")
    if int(off.sum()) > STREET_CROP_OFF_MAX * o.shape[0] or not bool((mc > LIDAR_HIT).any()):
        raise AssertionError(f"{label}: the simulated beams differ from the CPU path's")
    return out


def simulation_phase(dev, tmp):
    """Phase 18: the simulation tools through their ``main(argv)`` on the
    card, on phase 15's exp dirs under ``tmp`` (configs/waymo_demo_multi.yaml's
    ``multi``, configs/waymo_streetsurf.yaml's ``street``), each tool's
    launches counted, no plain K7/K13/K14 or bf16 cast on the card:
    ``render`` lidar (pandar64 on two frames, solid_state on one, the recorded
    beams on every frame) on both, with a crop of the beams held to the CPU
    path, beams/s and one frame's launches; nvs (street_view on multi,
    small_circle on street), its ms a frame; replay with ``reverse_ego`` and
    with a file moving the ego and a vehicle (each frame more than SIM_GREY
    grey levels from the plain replay somewhere); replay with the mesh
    overlaid; ``manipulate`` (SIM_EDITS, each frame finite and not the
    unedited one); ``extract_mesh`` at SIM_MESH_RES with the host's marching
    timed; the street's SDF at SIM_SDF_RES³ timed, a subset held to the CPU;
    ``extract_occgrid``, ``extract_visible_grid`` (camera, lidar_gt),
    ``visualize_slice`` and a ``run`` chain of two tasks -> its results."""
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.config import BaseConfig
    from neuralsim_torch.graphics import load_mesh_ply, marching_tets
    from neuralsim_torch.scene.observers import camera_get_selected_rays
    from neuralsim_torch.scene.observers.cameras_math import get_rays
    from neuralsim_torch.tools import (extract_mesh, extract_occgrid, extract_visible_grid,
                                       manipulate, render, run, visualize_slice)
    from neuralsim_torch.tools.extract_mesh import close_range_box, close_range_sdf
    from neuralsim_torch.tools.render import (lidar_frame_rays, lidar_query, load_render, nvs_poses,
                                              pixel_centres)
    summary, launches = {}, {}
    exps = {"multi": (os.path.join(tmp, "multi"), ["--renderer.type=multi"], EVAL_LIDAR_KERNELS,
                      EVAL_FRAME_KERNELS),
            "street": (os.path.join(tmp, "street"), [], DISK_STREET_LIDAR, DISK_STREET_FRAME)}

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, (exp, extra, lidar_k, frame_k) in exps.items():
        at = ["--resume_dir", exp] + extra
        # the LiDAR through the tool: every model, each frame's npz and the cloud
        for model, frames, n_beams in (("pandar64", SIM_LIDAR_FRAMES, SIM_P64_BEAMS),
                                       ("solid_state", "0", SIM_SOLID_BEAMS),
                                       ("original", None, None)):
            argv = at + ["--render.mode=lidar", f"--render.lidar_model={model}"] \
                + ([f"--render.frames={frames}"] if frames else [])
            r, secs, launches[f"{name}_lidar_{model}"] = run_tool(
                f"render.main lidar {model} ({name})", render.main, argv, lidar_k)
            want = [int(f) for f in frames.split(",")] if frames else None
            if (want is not None and (r["frames"] != want or r["beams"] != n_beams * len(want))) \
                    or not r["frames"] or r["points"] <= 0:
                raise AssertionError(f"lidar {model} ({name}) rendered {r['frames']}, "
                                     f"{r['beams']} beams, {r['points']} hit points")
            cloud = load_mesh_ply(os.path.join(r["out_dir"], "points.ply"))[0]
            for fi in r["frames"]:
                with np.load(os.path.join(r["out_dir"], f"lidar_{fi:04d}.npz")) as z:
                    if not np.isfinite(z["depth"]).all():
                        raise AssertionError(f"lidar {model} ({name}) frame {fi}: a depth is "
                                             f"not finite")
            if cloud.shape[0] != r["points"] or not np.isfinite(cloud).all():
                raise AssertionError(f"lidar {model} ({name}): points.ply holds "
                                     f"{cloud.shape[0]} points, not {r['points']} finite ones")
            summary[f"sim_{name}_lidar_{model}"] = dict(frames=r["frames"], beams=r["beams"],
                                                        points=r["points"], seconds=secs)
        # a pandar64 frame timed and counted on the loaded run, its crop vs the CPU
        cfg = BaseConfig("chip_smoke").parse(at)
        card = load_render(cfg, dev)
        multi, scene, rend, params, occ, loader = card[:6]
        cam = loader.cam_ids[0]
        frozen0 = scene.slice_at(0) if multi else None
        ro, rd = lidar_frame_rays(scene.slice_at(0), loader, 0, "pandar64", {}, cam, dev)
        query = lambda: lidar_query(rend, params, ro, rd, frozen=frozen0, occ=occ)
        kernels.reset_counts()
        with no_plain_on_card(f"one simulated LiDAR frame ({name})"):
            (depth, mask), _ = sync_s(query)
        frame_launches = {k.name: k.launches for k in kernels.KERNELS.values()}
        secs = sorted(sync_s(query)[1] for _ in range(SIM_TIME_REPS))
        med = secs[len(secs) // 2]
        log(f"simulated LiDAR ({name}): pandar64 frame of {ro.shape[0]} beams {med * 1e3:.1f} ms "
            f"(host clock to a sync, median of {SIM_TIME_REPS}; {secs}), "
            f"{ro.shape[0] / med:.0f} beams/s; hits {int((mask > 0.95).sum())}; launches "
            f"{ {k: v for k, v in frame_launches.items() if v} }")
        idx = torch.arange(0, ro.shape[0], ro.shape[0] // MULTI_CHECK_RAYS)[:MULTI_CHECK_RAYS]
        crop = lidar_crop(name, cfg, card, ro[idx].cpu().contiguous(), rd[idx].cpu().contiguous())
        summary[f"sim_{name}_lidar_frame"] = dict(
            beams=ro.shape[0], ms=med * 1e3, ms_all=[s * 1e3 for s in secs],
            beams_per_s=ro.shape[0] / med, hits=int((mask > 0.95).sum()), crop=crop,
            rayschunk=4096)
        launches[f"{name}_lidar_frame"] = frame_launches

        # NVS: the tool, then its frames timed on the loaded run
        path = "street_view" if multi else "small_circle"
        nvs = at + ["--render.mode=nvs", f"--render.path={path}",
                    f"--render.n_frames={SIM_NVS_FRAMES}", "--render.downscale=1"]
        r, secs, launches[f"{name}_nvs"] = run_tool(f"render.main nvs {path} ({name})",
                                                    render.main, nvs, frame_k)
        if r["frames"] != list(range(SIM_NVS_FRAMES)) or not r["video"]:
            raise AssertionError(f"nvs ({name}) wrote {r['frames']}, video {r['video']}")
        W, H = loader.image_wh(cam)
        xy = pixel_centres(W, H, 1, dev)
        intr = scene.observers[cam].frame_data["intr"][0]
        times = []
        for c2w in nvs_poses(scene, cam, {"path": path, "n_frames": SIM_NVS_FRAMES}):
            o, d = get_rays(xy, intr, torch.from_numpy(c2w).to(dev))
            at_ = (scene.slice_at(0),) if multi else ()
            fr, s_ = sync_s(lambda: rend.render_chunked(params, *at_, o.contiguous(),
                                                        d.contiguous(), rayschunk=4096,
                                                        occ_states=occ))
            times.append(s_ * 1e3)
            if not all(bool(torch.isfinite(fr[k]).all()) for k in ("rgb_volume", "depth_volume")):
                raise AssertionError(f"an nvs frame ({name}) is not finite")
        summary[f"sim_{name}_nvs"] = dict(path=path, frames=SIM_NVS_FRAMES, hw=[H, W],
                                          ms_median=float(np.median(times)), ms=times,
                                          tool_s=secs)
        log(f"nvs {path} ({name}): {H}x{W} at downscale 1, median {np.median(times):.1f} ms a "
            f"frame (host clock to a sync) {times}")
        del card, rend, params, occ, scene
        torch.cuda.empty_cache()

    # re-simulation on the multi-object run: against phase 15's plain replay
    exp, extra = exps["multi"][:2]
    at = ["--resume_dir", exp] + extra
    base = png(os.path.join(exp, "render_replay", "rgb_0000.png"))
    replay = ["--render.frames=0", "--render.video=false"]
    ego = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ego[:, :3, 3] = [[0.0, 3.0, 1.8], [1.5, 3.0, 1.8]]
    veh = np.eye(4, dtype=np.float32)[None].copy()
    veh[:, :3, 3] = [5.0, -2.2, 0.9]
    traj = os.path.join(tmp, "traj.npz")
    np.savez(traj, ego_car=ego, veh_0=veh)
    for form, anim in (("reverse_ego", "reverse_ego"), ("file", traj)):
        r, _, launches[f"anim_{form}"] = run_tool(f"render.main replay anim {form}", render.main,
                                                  at + replay + [f"--render.anim={anim}"],
                                                  EVAL_FRAME_KERNELS)
        diff = float(np.abs(png(os.path.join(r["out_dir"], "rgb_0000.png")) - base).max())
        log(f"anim {form}: frame 0 at most {diff:g} grey levels from the plain replay")
        if diff <= SIM_GREY:
            raise AssertionError(f"anim {form} did not change the replayed frame")
        summary[f"sim_anim_{form}_grey"] = diff

    # the edits on the multi-object run, against the unedited frame
    card = load_render(BaseConfig("chip_smoke").parse(at), dev)
    scene, rend, params, loader = card.scene, card.renderer, card.params, card.loader
    o, d = camera_get_selected_rays(scene.slice_at(0), loader.cam_ids[0],
                                    pixel_centres(*loader.image_wh(loader.cam_ids[0]), 2, dev))
    with torch.no_grad():
        unedited = rend.ray_query(params, scene.slice_at(0), o.contiguous(),
                                  d.contiguous())["rgb_volume"].cpu().numpy()
    del card, rend, params, scene
    for mode in SIM_EDITS:
        r, _, launches[f"edit_{mode}"] = run_tool(
            f"manipulate.main {mode}", manipulate.main,
            ["--resume_dir", exp, f"--manipulate.mode={mode}"], SIM_EDIT_KERNELS)
        diff = float(np.abs(r["rgb"].reshape(-1, 3) - unedited).max())
        log(f"manipulate {mode}: {r['path']}, at most {diff:.4g} from the unedited frame")
        if not np.isfinite(r["rgb"]).all() or diff <= 0:
            raise AssertionError(f"manipulate {mode}: the frame is not finite, or unedited")
        summary[f"sim_edit_{mode}_diff"] = diff

    # geometry on the StreetSurf run
    exp = exps["street"][0]
    at = ["--resume_dir", exp]
    m, secs, launches["extract_mesh"] = run_tool("extract_mesh.main", extract_mesh.main,
                                                 at + [f"--res={SIM_MESH_RES}"], SIM_SDF_KERNELS)
    if m["faces"].shape[0] == 0 or not np.isfinite(m["verts"]).all():
        raise AssertionError("extract_mesh wrote an empty mesh")
    summary["sim_mesh"] = dict(res=SIM_MESH_RES, verts=int(m["verts"].shape[0]),
                               faces=int(m["faces"].shape[0]), tool_s=secs)
    r, _, _ = run_tool("render.main replay (streetsurf)", render.main,
                       at + replay, DISK_STREET_FRAME)
    base = png(os.path.join(r["out_dir"], "rgb_0000.png"))
    r, _, launches["mesh_overlay"] = run_tool(
        "render.main replay mesh_overlay", render.main,
        at + replay + [f"--render.mesh_overlay={m['path']}"], DISK_STREET_FRAME)
    diff = float(np.abs(png(os.path.join(r["out_dir"], "rgb_0000.png")) - base).max())
    log(f"mesh overlay: frame 0 at most {diff:g} grey levels from the plain replay")
    if diff <= SIM_GREY:
        raise AssertionError("the mesh overlay did not paint the replayed frame")
    summary["sim_mesh_overlay_grey"] = diff

    card = load_render(BaseConfig("chip_smoke").parse(at), dev)
    sdf = close_range_sdf(card.params, card.cr_id)
    mn, mx = close_range_box(card.params, card.cr_id)

    def grid_points(res):
        xs = [np.linspace(mn[i], mx[i], res) for i in range(3)]
        return np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)

    def sdf_grid(pts):
        vals = np.empty(pts.shape[0], np.float32)
        for i in range(0, pts.shape[0], SIM_SDF_CHUNK):
            vals[i:i + SIM_SDF_CHUNK] = sdf(pts[i:i + SIM_SDF_CHUNK])
        return vals

    pts = grid_points(SIM_MESH_RES)
    vals, _ = sync_s(lambda: sdf_grid(pts))
    t0 = time.perf_counter()
    verts, faces = marching_tets(vals.reshape((SIM_MESH_RES,) * 3), origin=mn,
                                 spacing=(mx - mn) / (SIM_MESH_RES - 1))
    summary["sim_mesh"]["marching_s"] = time.perf_counter() - t0
    pts = grid_points(SIM_SDF_RES)
    kernels.reset_counts()
    vals, secs = sync_s(lambda: sdf_grid(pts))
    sdf_launches = {k.name: k.launches for k in kernels.KERNELS.values() if k.launches}
    sel = np.random.default_rng(0).choice(pts.shape[0], SIM_SDF_CHECK, replace=False)
    cpu = load_render({**BaseConfig("chip_smoke").parse(at), "ckpt": "final"}, "cpu")
    ref = close_range_sdf(cpu.params, cpu.cr_id)(pts[sel])
    e_sdf = float((np.abs(vals[sel] - ref) / (1.0 + np.abs(ref))).max())
    summary["sim_sdf_grid"] = dict(res=SIM_SDF_RES, points=int(pts.shape[0]), s=secs,
                                   points_per_s=pts.shape[0] / secs, chunk=SIM_SDF_CHUNK,
                                   cpu_check_points=SIM_SDF_CHECK, max_rel_err=e_sdf,
                                   launches=sdf_launches)
    log(f"street SDF grid {SIM_SDF_RES}^3: {secs:.2f} s, {pts.shape[0] / secs:.4g} points/s "
        f"(chunks of {SIM_SDF_CHUNK}, host clock to a sync, copies included), launches "
        f"{sdf_launches}; {SIM_SDF_CHECK} points vs the CPU {e_sdf:.3g} of 1 + |sdf| (tol "
        f"{SIM_SDF_TOL:g}); marching at {SIM_MESH_RES}^3 on the host "
        f"{summary['sim_mesh']['marching_s']:.2f} s ({verts.shape[0]} verts)")
    if e_sdf > SIM_SDF_TOL or not np.isfinite(vals).all():
        raise AssertionError("the street's SDF grid differs from the CPU path's")
    del card, cpu, pts, vals

    res = 64
    g, _, launches["extract_occgrid"] = run_tool("extract_occgrid.main", extract_occgrid.main,
                                                 at + [f"--res={res}"], SIM_SDF_KERNELS)
    with np.load(g["path"]) as z:
        if set(z.files) != {"occ_corners", "sidelength", "aabb_min", "aabb_max", "voxel_size",
                            "occ_thresh"} or len(z["occ_corners"]) == 0:
            raise AssertionError("extract_occgrid wrote another npz, or no voxel")
    summary["sim_occgrid_voxels"] = int(len(g["occ_corners"]))
    for source, want in (("camera", DISK_STREET_FRAME), ("lidar_gt", ())):
        v, _, launches[f"visible_grid_{source}"] = run_tool(
            f"extract_visible_grid.main {source}", extract_visible_grid.main,
            at + [f"--grid.source={source}", f"--grid.res={res}", f"--grid.frames={SIM_GRID_FRAMES}",
                  f"--grid.out={os.path.join(tmp, f'vg_{source}.npz')}"], want)
        if v["voxels"] <= 0 or not os.path.isfile(v["path"]):
            raise AssertionError(f"extract_visible_grid {source} found no voxel")
        summary[f"sim_visible_grid_{source}_voxels"] = v["voxels"]
    sl, _, launches["visualize_slice"] = run_tool("visualize_slice.main", visualize_slice.main,
                                                  at, SIM_SDF_KERNELS)
    if len(sl["files"]) != 9 or not all(os.path.isfile(f) for f in sl["files"]):
        raise AssertionError("visualize_slice did not write its nine slices")
    rc, _, launches["run"] = run_tool(
        "run.main extract_occgrid,visualize_slice", run.main,
        ["extract_occgrid,visualize_slice"] + at
        + [f"--res={res // 2}", "--slice.res=64", f"--out={os.path.join(tmp, 'run_occ.npz')}"],
        SIM_SDF_KERNELS)
    if rc != 0 or not os.path.isfile(os.path.join(tmp, "run_occ.npz")):
        raise AssertionError("the run chain did not write its files")
    return dict(summary=summary, launches=launches)


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
    errs["lotd_grid"] = (max(errs["lotd_grid"][0], check_dense_levels(dev), check_k3_edges(dev)),
                         1e-5)
    errs_bwd, shapes_bwd = check_backward_kernels(dev, params)
    errs.update(errs_bwd)
    errs.update(check_k4_edges(dev))

    # 4. the render slice
    rig = SyntheticObjectDataset(**SYNTHETIC_OBJECT["dataset_cfg"]["params"])
    kernels.reset_counts()
    frames = render_frames(renderer, params, rig, dev)
    launches_render = {k.name: k.launches for k in kernels.KERNELS.values()}
    log(f"render slice: {N_FRAMES} frames of {rig.H}x{rig.W}, launches {launches_render}")
    if launches_render["lotd_cp_lines"] != 1:
        raise AssertionError("a render of one table version should launch K14 once")
    for name, n in launches_render.items():
        if n <= 0 and not name.endswith(".bwd") and \
                name not in BENCH_ONLY + COMPOSE_ONLY + CROWD_ONLY + PERLEVEL_ONLY \
                + PERMUTO_ONLY + LATENT_ONLY + STREETSURF_ONLY + POSE_ONLY:
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
    errs12, shapes12 = check_neus_composite(dev, [("synthetic_object's training step",
                                                   neus_args(tbuf))])
    errs.update(errs12)
    for name, (e, tol) in check_composite_edges(dev).items():
        errs[name] = (max(e, errs[name][0]), tol)
    # K12 at synthetic_object's render chunk: 4,096 rays of 96 samples with
    # rgb, at the step's inv_s and cos anneal (timed in phase 13)
    render12 = [torch.from_numpy(v).to(dev) for v in neus_inputs(RAYSCHUNK, 96, 5)]
    step12 = shapes12["neus_composite"]["args"]
    render12 = (*render12[:5], step12[5], step12[6], render12[5])
    errs12_render, shapes12_render = check_neus_composite(
        dev, [("synthetic_object's render chunk", render12)])
    for name, (e, tol) in errs12_render.items():
        errs[name] = (max(e, errs[name][0]), tol)
    del trainer, state, tbuf
    kernels.reset_counts()
    out, rgb_first, rgb_last = train_slice(SYNTHETIC_OBJECT)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    log(f"training slice: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays, launches {launches}")
    for name, n in launches.items():
        if n <= 0 and name not in BENCH_ONLY + COMPOSE_ONLY + MULTI_ONLY + CROWD_ONLY \
                + PERLEVEL_ONLY + PERMUTO_ONLY + LATENT_ONLY + STREETSURF_ONLY + POSE_ONLY:
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
    crowd["times"] = {**time_crowd_kernels(*crowd["shapes"], synth["hit"]),
                      **time_latent_take(crowd["latent_timed"])}
    phase_s["crowd and synthetic_multi"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 11. WAYMO_DEMO_MULTI on the per-level CP path (K2, K12), with its timing
    perlevel = perlevel_phase(dev, "--profile" in argv,
                              {**multi["summary"], **compose["summary"]})
    phase_s["per-level"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 12. WAYMO_DEMO_PERMUTO, the vehicles on one permuto field (K9), with its timing
    permuto = permuto_phase(dev, "--profile" in argv, {**multi["summary"], **compose["summary"]})
    phase_s["permuto"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 13. checkpoints and the evaluation tools on the stacked waymo_demo_multi path
    ckpt = checkpoint_eval_phase(dev)
    phase_s["checkpoints and evaluation"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 14. StreetSurf's single-street path (K3 in four dimensions), with its timing
    street = streetsurf_phase(dev, "--profile" in argv)
    phase_s["streetsurf"], t1 = time.perf_counter() - t1, time.perf_counter()

    # 15. the demo drive on disk and both YAMLs from the command line, then
    # 16. EmerNeRF's YAML on the same drive, with its timing
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_") as tmp:
        disk = disk_phase(dev, tmp)
        phase_s["waymo layout and command line"], t1 = (time.perf_counter() - t1,
                                                        time.perf_counter())
        emer = emernerf_phase(dev, os.path.join(tmp, "data"), tmp, "--profile" in argv)
        phase_s["emernerf"], t1 = time.perf_counter() - t1, time.perf_counter()
        # 17. pose refinement on EmerNeRF's path, on the same drive
        pose = pose_phase(dev, os.path.join(tmp, "data"), tmp, "--profile" in argv)
        phase_s["pose refinement"], t1 = time.perf_counter() - t1, time.perf_counter()
        # 18. the simulation tools on phase 15's exp dirs
        sim = simulation_phase(dev, tmp)
        phase_s["simulation"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("phases (s, host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # 19. timing
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
    # K12 at synthetic_object's training step and render chunk
    t12_step, t12_render = time_neus_composite(shapes12), time_neus_composite(shapes12_render)
    times12 = {name: [t12_step[name], t12_render[name]] for name in t12_step}
    rows = []
    for name, k in kernels.KERNELS.items():
        # a kernel of the earlier slices reports its synthetic_object training
        # path at the top level and the bench path beside it; K4 and K7 run on
        # the bench path only, K8 on the compose render only (per frame), K8's
        # backward on the multi-object training only (per iteration); K13 and
        # K14 report the multi-object training (its largest call)
        on_compose = name in COMPOSE_ONLY
        on_multi = name in MULTI_ONLY + LATENT_ONLY + LINES_KERNELS
        on_crowd = name in CROWD_ONLY
        on_perlevel = name in PERLEVEL_ROWS
        on_permuto = name in PERMUTO_ONLY
        on_street = name in STREETSURF_ONLY
        on_pose = name in POSE_ONLY
        on_bench = name not in times and not (on_compose or on_multi or on_crowd or on_perlevel
                                              or on_permuto or on_street or on_pose)
        if on_pose:
            # K3's backward to the positions at the pose step's own samples
            t, n_launch, steps, path = (pose["times"][name][0], pose["launches"][name],
                                        pose["iters"], "emernerf pose refinement training")
        elif on_street:
            # K3-4D at the pixel step's distant samples
            t, n_launch, steps, path = (street["times"][name], street["launches"][name],
                                        street["iters"], "waymo_streetsurf training")
        elif on_permuto:
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
                                   crowd["errs"], perlevel["errs"], permuto["errs"],
                                   ckpt["errs"], street["errs"], emer["errs"],
                                   pose["errs"]) if name in e]
        err, tol = max(e for e, _ in found), found[0][1]
        bound_ms, bound_by = t["bound"]
        # K8 runs on no training step: its per-frame count is under "compose"
        row = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": n_launch,
               "launches_per_step": None if on_compose or on_multi or on_crowd or on_perlevel
               or on_permuto or on_street or on_pose else n_launch / steps,
               "max_abs_err": err, "max_err": err,
               "tol": tol, "ms": t["ms"], **card_keys(t), "plain_ms": t["plain_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": t["library_ms"], **extra_keys(t), "shape": t["shape"],
               "path": path}
        unit = "frame" if on_compose else "iteration" if on_multi or on_crowd or on_perlevel \
            or on_permuto or on_street or on_pose else "step"
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
        for c, where in zip(times12.get(name, []), ("training step", "render chunk")):
            sub = row.setdefault("synthetic_object", {
                "launches_per_step": launches[name] / TRAIN_STEPS,
                "launches_per_frame": launches_render[name] / N_FRAMES})
            sub.setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                 "library_ms": c["library_ms"], "shape": c["shape"]})
            log(f"kernel {name} (synthetic_object {where}, {sub['launches_per_step']:g} launches "
                f"per step, {sub['launches_per_frame']:g} per frame): {c['ms']:.4f} ms "
                f"({card_extra(c)[2:]}, plain {c['plain_ms']:.4f}, bound {c['bound'][0]:.4f} by "
                f"{c['bound'][1]}) at {c['shape']}")
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
                 "library_ms": c["library_ms"], **extra_keys(c), "shape": c["shape"]})
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
                 "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                 "library_ms": c["library_ms"], **extra_keys(c), "shape": c["shape"]})
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
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0],
                 "bound_by": c["bound"][1], "library_ms": c["library_ms"], "shape": c["shape"]})
        q = row["permuto"]
        log(f"kernel {name} (permuto path: {q['launches_per_lidar_step']} launches per LiDAR "
            f"step, {q['launches_per_pixel_step']} per pixel step, "
            f"{q['render_launches_per_frame']:g} per frame)")
        row["eval"] = {"train_multi_launches": ckpt["launches"]["train"][name],
                       "eval_multi_launches": ckpt["launches"]["eval_multi"][name],
                       "eval_lidar_launches": ckpt["launches"]["eval_lidar"][name]}
        log(f"kernel {name} (checkpoint and evaluation path: "
            f"{ckpt['launches']['train'][name] / CKPT_ITERS:g} launches per iteration of the "
            f"driver, {ckpt['launches']['eval_multi'][name] / len(EVAL_FRAMES):g} per evaluated "
            f"frame, {ckpt['launches']['eval_lidar'][name] / len(EVAL_FRAMES):g} per LiDAR frame)")
        row["streetsurf"] = {
            "launches": street["launches"][name],
            "launches_per_iteration": street["launches"][name] / street["iters"],
            "launches_per_lidar_step": street["step_launches"]["lidar"][name],
            "launches_per_pixel_step": street["step_launches"]["pixel"][name],
            "frame_launches": street["frame_launches"][name]}
        q = row["streetsurf"]
        log(f"kernel {name} (streetsurf path: {q['launches_per_lidar_step']} launches per LiDAR "
            f"step, {q['launches_per_pixel_step']} per pixel step, {q['frame_launches']} per "
            f"frame)")
        # EmerNeRF's pixel step: K3, K9 at d 4 and K6 at its own inputs
        row["emernerf"] = {"launches": emer["launches"][name],
                           "launches_per_iteration": emer["launches"][name] / emer["iters"]}
        for c in emer["times"].get(name, []):
            row["emernerf"].setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                 "library_ms": c["library_ms"], "shape": c["shape"]})
        log(f"kernel {name} (emernerf path: {row['emernerf']['launches_per_iteration']:g} "
            f"launches per iteration)")
        # the pose-refinement path: K3's backward to the positions, K9's with
        # d x01 and K6's with d t at its own inputs
        row["pose"] = {"launches": pose["launches"][name],
                       "launches_per_iteration": pose["launches"][name] / pose["iters"]}
        for c in pose["times"].get(name, []):
            row["pose"].setdefault("times", []).append(
                {"ms": c["ms"], **card_keys(c), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                 "library_ms": c["library_ms"], "shape": c["shape"]})
            log(f"kernel {name} (pose path, {row['pose']['launches_per_iteration']:g} launches "
                f"per iteration): {c['ms']:.4f} ms ({card_extra(c)[2:]}, plain "
                f"{c['plain_ms']:.4f}, bound {c['bound'][0]:.4f} by {c['bound'][1]}) at "
                f"{c['shape']}")
        # the simulation path: one pandar64 frame of each YAML's street, the
        # street's SDF grid
        row["simulation"] = {
            "lidar_frame_launches_multi": sim["launches"]["multi_lidar_frame"][name],
            "lidar_frame_launches_street": sim["launches"]["street_lidar_frame"][name],
            "sdf_grid_launches": sim["summary"]["sim_sdf_grid"]["launches"].get(name, 0)}
        log(f"kernel {name} (simulation path: {row['simulation']['lidar_frame_launches_multi']} "
            f"launches per pandar64 frame of waymo_demo_multi's street, "
            f"{row['simulation']['lidar_frame_launches_street']} of StreetSurf's, "
            f"{row['simulation']['sdf_grid_launches']} per {SIM_SDF_RES}^3 SDF grid)")
        rows.append(row)
    if "--profile" in argv:
        profile_frame(renderer, params, rig, dev)
        profile_step(trainer, state, rig, dev)

    # 20. results
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
                    **ckpt["summary"], **street["summary"], **disk["summary"],
                    **emer["summary"], **pose["summary"], **sim["summary"], "card": smi}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
