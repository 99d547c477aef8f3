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
     forward kernel launched, and compare a 32x32 crop with the CPU (plain)
     path;
  5. training slice: build_trainer at full width from seed 42; the first
     step's loss terms and per-parameter gradients on the card against the
     same step (same parameters, batch and noise) through the plain versions
     on the CPU; then train() for 60 steps of 2,048 rays: every loss finite,
     no step skipped, loss_rgb over the last 10 steps below the first 10,
     all eight kernels launched; one poisoned step (a NaN in the batch) is
     skipped and leaves every parameter bit-identical;
  6. timing: frame latency and rays/s; training step time and rays/s; each
     kernel's time at the training path's shapes (beside that path's launch
     count) and, for the forward kernels, at the render path's too, each
     beside its plain version, a library call where one exists, and its bound
     (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s);
  7. one JSON line of results, one of per-kernel results, then the device
     line, last.

--profile adds torch.profiler tables of device time by kernel for one frame
and for one training step.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
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


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def merge_inputs(n, a, b, seed):
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.integers(0, 400, (n, a)) / 64.0, -1).astype(np.float32)
    tb = (rng.integers(0, 400, (n, b)) / 64.0).astype(np.float32)
    tb[:, 0] = ta[:, 3]
    tb = np.sort(tb, -1)
    return (ta, tb, rng.random((n, a)) > 0.2, rng.random((n, b)) > 0.2,
            rng.normal(size=(n, a)).astype(np.float32),
            rng.normal(size=(n, b)).astype(np.float32))


def composite_inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 3.0, -1).astype(np.float32)
    alpha = (rng.random((n, s)) ** 4).astype(np.float32)
    alpha[::5, 40] = 1.0
    mask = rng.random((n, s)) > 0.1
    mask[::9] = False
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
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    from neuralsim_torch.renderers.buffers import volume_composite, volume_composite_plain

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

    errs_w, errs_m = [], []
    drawn = torch.rand((n_rays, 16), generator=torch.Generator().manual_seed(4)).to(dev)
    for s, seed in ((64, 2), (80, 3)):
        args = [T(a) for a in stage_inputs(n_rays, s, seed)]
        for noise in (None, drawn):
            errs_w.append(compare(f"K5a weights_pdf rays={n_rays} S={s} noise={noise is not None}",
                                  upsample_weights_pdf(*args, 256.0, 16, noise),
                                  upsample_weights_pdf_plain(*args, 256.0, 16, noise),
                                  1e-5, 1e-6))
        ins = [T(a) for a in merge_inputs(n_rays, s, 16, seed)]
        errs_m.append(compare(f"K5b merge rays={n_rays} A={s} B=16", merge_sorted_samples(*ins),
                              merge_sorted_samples_plain(*ins), 0, 0, exact=True))
    res["neus_upsample.weights_pdf"] = (max(errs_w), 1e-6)
    res["neus_upsample.merge"] = (max(errs_m), 0.0)
    shapes["neus_upsample.weights_pdf"] = dict(args=args, noise=drawn if noisy else None)
    shapes["neus_upsample.merge"] = dict(ins=ins)

    cargs = [T(a) for a in composite_inputs(n_rays, 96, 5)]
    res["volume_composite"] = (compare(f"K6 volume_composite rays={n_rays}",
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


def check_backward_kernels(dev, params):
    """Each backward kernel against autograd of its plain version, on the card,
    at the training step's shapes (2,048 rays x 96 samples, and 512 points)."""
    import torch
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.renderers.buffers import (volume_composite_bwd,
                                                   volume_composite_bwd_plain)

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

    n, S = TRAIN_RAYS, 96
    cargs = [T(a) for a in composite_inputs(n, S, 12)]
    grads = [cotangents(sh, 13 + i, dev)
             for i, sh in enumerate(((n, S), (n,), (n,), (n, 3), (n, 3)))]
    res["volume_composite.bwd"] = (
        compare_rel("K6 bwd", volume_composite_bwd(*cargs, *grads),
                    volume_composite_bwd_plain(*cargs, *grads), GRAD_REL), GRAD_REL)
    shapes["volume_composite.bwd"] = dict(args=cargs + grads)
    torch.cuda.synchronize()
    return res, shapes


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


def render_frames(renderer, params, rig, dev):
    import torch
    frames = []
    for fi in FRAME_IDS:
        o, d = frame_rays(rig, fi, dev)
        frames.append(renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK))
    torch.cuda.synchronize()
    return frames


def check_frames(frames, H, W):
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
    if not (centre > 0.5 and corner < 0.5):
        raise AssertionError("the sphere-init surface is not where it should be")


def check_crop(frames, renderer, params, rig, H, W):
    import torch
    crop = (slice(H // 2 - 16, H // 2 + 16), slice(W // 2 - 16, W // 2 + 16))
    cpu_params = copy.deepcopy(params).to("cpu")
    o, d = frame_rays(rig, FRAME_IDS[0], "cpu", crop)
    ref = renderer.render_chunked(cpu_params, o, d, rayschunk=RAYSCHUNK)
    worst = 0.0
    for k in ("rgb_volume", "depth_volume", "mask_volume", "normals_volume"):
        g = frames[0][k].reshape((H, W) + frames[0][k].shape[1:])[crop].reshape(ref[k].shape)
        err = float((g.cpu() - ref[k]).abs().max())
        log(f"crop {k}: max_abs_err vs CPU {err:.3g} (tol {CROP_TOL:g})")
        worst = max(worst, err)
    if worst > CROP_TOL:
        raise AssertionError("the card's frame differs from the CPU crop")
    return worst


# ---------------------------------------------------------------------------
# Phase 5: the training slice
# ---------------------------------------------------------------------------

LOSS_TERMS = ("loss_total", "loss_rgb", "loss_mask", "loss_eikonal", "loss_sparsity")


def device_batch(rig, rng, n_rays, dev):
    from neuralsim_torch.tools.train import to_device_batch
    return to_device_batch(rig.sample_pixels(rng, n_rays), dev)


def check_first_step(trainer, state, rig, dev, n_rays=TRAIN_RAYS):
    """Loss terms and per-parameter gradients of one step on the card against
    the same step (same parameters, batch and noise) through the plain
    versions on the CPU. Steps nothing. -> (worst relative loss error, worst
    gradient error relative to its parameter's largest gradient entry)."""
    import torch
    batch = device_batch(rig, np.random.default_rng(1), n_rays, "cpu")
    noise = trainer.draw_noise(n_rays, torch.Generator().manual_seed(1))
    to = lambda tree, d: {k: [x.to(d) for x in v] if isinstance(v, list) else v.to(d)
                          for k, v in tree.items()}
    results = []
    for params, d in ((state.params, dev), (copy.deepcopy(state.params).to("cpu"), "cpu")):
        total, extras = trainer.compute_losses(params, to(batch, d), state.it, to(noise, d))
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
    log(f"first step: worst loss rel err {loss_err:.3g} (tol {STEP_LOSS_RTOL:g}), worst "
        f"gradient rel err {grad_err:.3g} (tol {STEP_GRAD_REL:g})")
    if not (loss_err <= STEP_LOSS_RTOL and grad_err <= STEP_GRAD_REL):
        raise AssertionError("the card's first training step differs from the CPU's")
    return loss_err, grad_err


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


def check_poisoned_step(trainer, state, rig, dev):
    import torch
    batch = device_batch(rig, np.random.default_rng(2), TRAIN_RAYS, dev)
    batch["image_rgb"][7, 1] = float("nan")
    before = [p.detach().clone() for p in state.params.parameters()]
    moments = [t.clone() for o in state.opt.values() for t in (*o.mu, *o.nu, o.count)]
    it = state.it
    state, m = trainer.train_step(
        state, batch, trainer.draw_noise(TRAIN_RAYS, torch.Generator(device=dev).manual_seed(2)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(before, state.params.parameters())) and \
        all(torch.equal(a, b) for a, b in
            zip(moments, [t for o in state.opt.values() for t in (*o.mu, *o.nu, o.count)]))
    log(f"poisoned step: skipped {int(m['step_skipped'])}, skips_total "
        f"{int(m['skips_total'])}, parameters and moments unchanged {same}, it {it} -> {state.it}")
    if not (int(m["step_skipped"]) == 1 and int(m["skips_total"]) == 1 and same
            and state.it == it + 1):
        raise AssertionError("the poisoned step was not skipped cleanly")


def time_steps(trainer, state, rig, dev, reps=20):
    """Host-clock time of one training step (noise drawn on the card, batch
    already there) in ms over ``reps`` steps: (median, min, max)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    batches = [device_batch(rig, rng, TRAIN_RAYS, dev) for _ in range(4)]
    ts = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batches[i % 4], trainer.draw_noise(TRAIN_RAYS, gen))
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = sorted(ts[3:])
    return ts[reps // 2], ts[0], ts[-1]


def profile_step(trainer, state, rig, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = device_batch(rig, np.random.default_rng(4), TRAIN_RAYS, dev)
    trainer.train_step(state, batch, trainer.draw_noise(TRAIN_RAYS, gen))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, trainer.draw_noise(TRAIN_RAYS, gen))
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
    from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
    from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
    from neuralsim_torch.renderers.buffers import volume_composite, volume_composite_plain

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

    args = shapes["neus_upsample.weights_pdf"]["args"]
    noise = shapes["neus_upsample.weights_pdf"]["noise"]
    n, S = args[0].shape
    nf = 16
    out["neus_upsample.weights_pdf"] = dict(
        shape=f"rays={n} S={S} nf={nf} (second upsample stage, "
              f"{'drawn noise' if noise is not None else 'no noise'})",
        ms=cuda_ms(lambda: upsample_weights_pdf(*args, 256.0, nf, noise)),
        plain_ms=cuda_ms(lambda: upsample_weights_pdf_plain(*args, 256.0, nf, noise)),
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
        ms=cuda_ms(lambda: volume_composite(*cargs)),
        plain_ms=cuda_ms(lambda: volume_composite_plain(*cargs)),
        library_ms=None,
        bound=bound(n * S * 37 + n * 36, n * S * 18))
    return out


def time_backward_kernels(shapes):
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.renderers.buffers import (volume_composite_bwd,
                                                   volume_composite_bwd_plain)
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
    out["lotd_grid.bwd"] = dict(
        shape=f"N={N} levels={L} (hash 172, 256; F=2), cotangents of features and jacobian, "
              f"the same ray samples",
        ms=cuda_ms(lambda: lotd.lotd_grid_bwd(*args)),
        plain_ms=cuda_ms(lambda: lotd.lotd_grid_bwd_plain(*args), reps=3),
        library_ms=None,
        bound=bound(N * 12 + N * cols * 16 + seg, N * L * (135 + 8 * 8 * 2)))

    args = shapes["volume_composite.bwd"]["args"]
    n, S = args[0].shape
    out["volume_composite.bwd"] = dict(
        shape=f"rays={n} S={S}, cotangents of all five outputs",
        ms=cuda_ms(lambda: volume_composite_bwd(*args)),
        plain_ms=cuda_ms(lambda: volume_composite_bwd_plain(*args), reps=3),
        library_ms=None,
        bound=bound(n * S * 37 + n * 32 + n * S * 28, n * S * 40))
    return out


def time_frames(renderer, params, rig, dev, reps=20):
    """Host-clock frame latency in ms over ``reps`` frames: (median, min, max)."""
    import torch
    o, d = frame_rays(rig, FRAME_IDS[0], dev)
    renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return (ts[reps // 2], ts[0], ts[-1]), o.shape[0]


def profile_frame(renderer, params, rig, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile
    o, d = frame_rays(rig, FRAME_IDS[0], dev)
    renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render_chunked(params, o, d, rayschunk=RAYSCHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    kernels_us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(kernels_us) / 1e3
    log(f"profile: {len(kernels_us)} device kernels, busy {busy:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall under the profiler")


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
        if "registers" in line or "spill" in line or line.startswith("=="):
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
        if n <= 0 and not name.endswith(".bwd"):
            raise AssertionError(f"kernel {name} never launched on the render path")
    check_frames(frames, rig.H, rig.W)
    crop_err = check_crop(frames, renderer, params, rig, rig.H, rig.W)

    # 5. the training slice
    trainer, state = build_trainer(SYNTHETIC_OBJECT)
    step_loss_err, step_grad_err = check_first_step(trainer, state, rig, dev)
    del trainer, state
    kernels.reset_counts()
    out, rgb_first, rgb_last = train_slice(SYNTHETIC_OBJECT)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    log(f"training slice: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays, launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the training path")
    trainer, state = out["trainer"], out["state"]
    check_poisoned_step(trainer, state, rig, dev)

    # 6. timing
    (frame_ms, frame_min, frame_max), n_rays = time_frames(renderer, params, rig, dev)
    log(f"timing: frame median {frame_ms:.3f} ms (min {frame_min:.3f}, max "
        f"{frame_max:.3f}) for {n_rays} rays, {n_rays / frame_ms * 1e3:.1f} rays/s")
    step_ms, step_min, step_max = time_steps(trainer, state, rig, dev)
    log(f"timing: training step median {step_ms:.3f} ms (min {step_min:.3f}, max "
        f"{step_max:.3f}) for {TRAIN_RAYS} rays, {TRAIN_RAYS / step_ms * 1e3:.1f} rays/s; "
        f"hand-kernel launches per step {sum(launches.values()) / TRAIN_STEPS:.1f}")
    times = {**time_forward_kernels(shapes), **time_backward_kernels(shapes_bwd)}
    times_render = time_forward_kernels(shapes_render)
    rows = []
    for name, k in kernels.KERNELS.items():
        t = times[name]
        bound_ms, bound_by = t["bound"]
        row = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": launches[name],
               "launches_per_step": launches[name] / TRAIN_STEPS,
               "max_abs_err": errs[name][0], "max_err": errs[name][0],
               "tol": errs[name][1], "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": t["library_ms"], "shape": t["shape"]}
        log(f"kernel {name} (training path, {launches[name] / TRAIN_STEPS:g} launches per "
            f"step): {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
            f"{bound_ms:.4f} by {bound_by}) at {t['shape']}")
        if name in times_render:
            r = times_render[name]
            row["render"] = {"launches": launches_render[name],
                             "launches_per_frame": launches_render[name] / N_FRAMES,
                             "ms": r["ms"], "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                             "library_ms": r["library_ms"], "shape": r["shape"]}
            log(f"kernel {name} (render path, {launches_render[name] / N_FRAMES:g} launches "
                f"per frame): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                f"{r['bound'][0]:.4f} by {r['bound'][1]}) at {r['shape']}")
        rows.append(row)
    if "--profile" in argv:
        profile_frame(renderer, params, rig, dev)
        profile_step(trainer, state, rig, dev)

    # 7. results
    log(json.dumps({"frame_ms": frame_ms, "frame_ms_min": frame_min,
                    "frame_ms_max": frame_max, "rays_per_s": n_rays / frame_ms * 1e3,
                    "crop_max_abs_err": crop_err,
                    "train_step_ms": step_ms, "train_step_ms_min": step_min,
                    "train_step_ms_max": step_max,
                    "train_rays_per_s": TRAIN_RAYS / step_ms * 1e3,
                    "train_steps": TRAIN_STEPS, "loss_rgb_first10": rgb_first,
                    "loss_rgb_last10": rgb_last, "first_step_loss_rel_err": step_loss_err,
                    "first_step_grad_rel_err": step_grad_err, "card": smi}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
