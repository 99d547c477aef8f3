"""StreetSurf's LiDAR fit through the road pretrain and the first training
iterations, in the JAX package and in the PyTorch port, on the CPU.

    python tests/streetsurf_lidar_fit.py [--iters 10] [--rays 512] [--beams 8192]

(It imports both packages, as the tests do, so it lives beside them; pytest
collects no test from it.)

Both packages build configs/waymo_streetsurf.yaml's model
(``WAYMO_STREETSURF``, its dataset the in-memory demo drive of 8 frames) with
the street at a narrow width (``NARROW_STREET``: its pretrain fits the road as
the full width does on an H100, 0.030 here against 0.037 there), from the same
parameters: JAX's seeded init copied into the port, the port's road-surface
pretrain as the config writes it (500 Adam steps toward the plane through the
street box's centre), copied back into the JAX tree. Then ``--iters`` loop
iterations (a LiDAR step, then a pixel step that advances ``it`` and refreshes
the grid on its cadence) run through both packages' ``Trainer.train_step`` on
the same batches and draws, JAX's train step compiled once a step type without
XLA's algebraic simplifier, as tests/test_torch_streetsurf.py compiles it.

The measure is chip_smoke.py's ``lidar_depth_over_frames``: the LiDAR step's
``lidar_loss_depth`` at iteration 0's anneal over a fixed draw (seed 23) of
``--beams`` beams of every frame, each frame with a fixed draw of noise (JAX's
from a key, the port's the same numbers), no parameter moved, the mean over
the frames. It is printed after the pretrain and after iterations 1, 3 and
10 (a JSON line, both packages), then the ratio of the last to the first.
The JAX step's compile with the 128^3 grid's refresh peaks at ~16 GB.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEPTH_SEED = 23
MEASURE_AT = (1, 3, 10)
# the street's encoding and decoder widths; every other value of the config
# stays as the YAML writes it
NARROW_STREET = {"geo_feat_dim": 7, "radiance_hidden": 16,
                 "encoding_cfg": {"type": "tpu_mixed", "n_levels": 5, "base_res": 8,
                                  "max_res": 64, "n_feats": 2, "n_hash_levels": 1,
                                  "log2_hashmap_size": 10, "cp_max_res": 64}}


def make_cfg(rays: int):
    from neuralsim_torch.configs import WAYMO_STREETSURF
    cfg = copy.deepcopy(WAYMO_STREETSURF)
    cfg["assetbank_cfg"]["Street"]["model_params"].update(copy.deepcopy(NARROW_STREET))
    cfg["training"].update(n_rays=rays, n_rays_lidar=rays)
    return cfg


def noise_of(cfg, key, step_type, n, it=None):
    """The draws of one JAX step of ``step_type`` on ``n`` rays from its key
    (compute_losses splits (render, uniform, eikonal); the renderer (cr,
    distant); the grid's proposal draws from the cr key and the upsample
    stages split off it; on a pixel step at the grid's cadence the refresh's
    jitter comes from fold_in(key, 7)), as torch tensors."""
    import jax
    import torch
    mp = cfg["assetbank_cfg"]["Street"]["model_params"]
    q, accel = mp["query_cfg"], mp["accel_cfg"]
    t = lambda a: torch.from_numpy(np.array(a))
    k_render, k_uniform, _ = jax.random.split(key, 3)
    kcr, kdv = jax.random.split(k_render)
    noise = {"occ_proposal": t(jax.random.uniform(kcr, (n, q["num_coarse"]))), "fine": []}
    k = kcr
    for nf in q["num_fine"]:
        sk, k = jax.random.split(k)
        noise["fine"].append(t(jax.random.uniform(sk, (n, nf))))
    if step_type == "pixel":
        ns = cfg.get("renderer", {}).get("distant_query_cfg", {}).get("num_samples", 64)
        noise["distant"] = t(jax.random.uniform(kdv, (n, ns)))
    noise["uniform"] = t(jax.random.uniform(k_uniform, (cfg["training"]["uniform_sample_n"], 3)))
    if step_type == "pixel" and it is not None and it % accel["n_steps_between_update"] == 0:
        R = accel["resolution"]
        noise["occ_update"] = {"cr": t(jax.random.uniform(
            jax.random.fold_in(key, 7), (accel["samples_per_voxel"], R, R, R, 3)))}
    return noise


def fixed_beams(scene, loader, n_beams):
    """Every frame's fixed beams as world-ray LiDAR batches (torch, CPU)."""
    from neuralsim_torch.tools.train import _LIDAR_KEYS, to_device
    from neuralsim_torch.training.multi_trainer import lift_lidar_batch
    rng = np.random.default_rng(DEPTH_SEED)
    out = []
    for (lid, fi), ld in sorted(loader.lidars.items()):
        sel = rng.integers(0, ld["rays_d"].shape[0], n_beams)
        raw = {"rays_fidx": np.full(n_beams, fi, np.int32),
               "rays_o_local": ld["rays_o"][sel], "rays_d_local": ld["rays_d"][sel],
               "ranges": ld["ranges"][sel]}
        b = lift_lidar_batch(scene, {**to_device(raw, _LIDAR_KEYS, "cpu"), "lidar_id": lid})
        out.append({k: v for k, v in b.items() if k != "rays_fidx"})
    return out


def port_measure(cfg, trainer, state, beams):
    import jax
    import torch
    vals = []
    with torch.no_grad():
        for i, b in enumerate(beams):
            noise = noise_of(cfg, jax.random.PRNGKey(DEPTH_SEED + i), "lidar",
                             b["rays_o"].shape[0])
            _, ex = trainer.compute_losses(state.params, b, 0, noise, state.occ, "lidar")
            vals.append(float(ex["aux"]["lidar_loss_depth"]))
    return float(np.mean(vals))


def build_port(cfg, jp):
    import jax
    import torch
    from neuralsim_torch.bridge import load_jax_params
    from neuralsim_torch.tools.build import build_everything
    scene, bank, renderer, trainer, state, loader = build_everything(cfg, "cpu", pretrain=False)
    load_jax_params(state.params, jp)
    gen = torch.Generator().manual_seed(int(cfg["seed"]) + 1)
    t0 = time.perf_counter()
    bank.training_initialize({mid: torch.rand(shape, generator=gen)
                              for mid, shape in bank.pretrain_shapes().items()})
    print(f"pretrain {time.perf_counter() - t0:.1f} s", flush=True)
    return scene, trainer, state, loader


def _from_port(tree, sd, prefix=""):
    if isinstance(tree, dict):
        return {k: _from_port(v, sd, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_port(v, sd, f"{prefix}.{i}") for i, v in enumerate(tree)]
    return sd[prefix].detach().numpy().copy()


def main(args):
    import torch
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    cfg = make_cfg(args.rays)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from neuralsim_torch.bridge import occ_state_from_numpy
    from neuralsim_torch.dataio.dataloader import LidarSampler, PixelSampler
    from neuralsim_torch.tools.train import _LIDAR_KEYS, _PIXEL_KEYS, to_device
    from neuralsim_torch.training.multi_trainer import lift_lidar_batch
    from neuralsim_tpu.tools.train import build_everything as jax_build_everything

    opts = {"xla_disable_hlo_passes": "algsimp"}
    _, _, jbank, _, jt, _ = jax_build_everything(copy.deepcopy(cfg))
    jp = jax.tree.map(np.asarray, jbank.init_params(jax.random.PRNGKey(int(cfg["seed"]))))
    scene, trainer, state, loader = build_port(cfg, jp)
    jp = _from_port(jp, dict(state.params.named_parameters()))
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, jp))
    state.occ["cr"] = occ_state_from_numpy(np.asarray(jstate.occ["cr"].val),
                                           np.asarray(jstate.occ["cr"].mask))
    beams = fixed_beams(scene, loader, args.beams)
    jbeams = [{k: jnp.asarray(v.numpy()) for k, v in b.items()} for b in beams]
    jmeasure_c = []

    def jax_measure(js):
        if not jmeasure_c:
            f = lambda p, b, k, occ: jt.compute_losses(p, b, jnp.asarray(0), k, "lidar",
                                                       occ=occ)[1]["aux"]["lidar_loss_depth"]
            jmeasure_c.append(jax.jit(f).lower(js.params, jbeams[0], jax.random.PRNGKey(0),
                                               js.occ).compile(compiler_options=opts))
        return float(np.mean([float(jmeasure_c[0](js.params, b,
                                                  jax.random.PRNGKey(DEPTH_SEED + i), js.occ))
                              for i, b in enumerate(jbeams)]))

    rec = {"rays": args.rays, "beams_a_frame": args.beams,
           "port": {"pretrain": port_measure(cfg, trainer, state, beams)},
           "jax": {"pretrain": jax_measure(jstate)}}
    print(json.dumps(rec), flush=True)
    jstep, compiled = type(jt).train_step.__wrapped__, {}
    pix = PixelSampler(loader, n_rays=args.rays, seed=7)
    lid = LidarSampler(loader, n_rays=args.rays, seed=7)
    key = jax.random.PRNGKey(5)
    for i in range(1, args.iters + 1):
        t0 = time.perf_counter()
        key, k_lidar, k_pixel = jax.random.split(key, 3)
        lb, raw = lid.sample(), pix.sample()
        lbatch = lift_lidar_batch(scene, {**to_device(lb, _LIDAR_KEYS, "cpu"),
                                          "lidar_id": lb["lidar_id"]})
        for step_type, batch, cam, k in (
                ("lidar", {n: v for n, v in lbatch.items() if n != "rays_fidx"}, None, k_lidar),
                ("pixel", to_device(raw, _PIXEL_KEYS, "cpu"), raw["cam_id"], k_pixel)):
            pixel = step_type == "pixel"
            state, m = trainer.train_step(
                state, batch, noise_of(cfg, k, step_type, args.rays, state.it), step_type,
                cam, pixel)
            jb = {n: jnp.asarray(v.numpy()) for n, v in batch.items()}
            if step_type not in compiled:
                compiled[step_type] = jax.jit(
                    lambda st, b, kk, s=step_type, c=cam: jstep(jt, st, b, kk, s, c, s == "pixel")
                ).lower(jstate, jb, k).compile(compiler_options=opts)
            jstate, jm = compiled[step_type](jstate, jb, k)
            if int(m["step_skipped"]) or int(jm["step_skipped"]):
                raise AssertionError(f"iteration {i}: a {step_type} step was skipped")
        print(f"iteration {i}: {time.perf_counter() - t0:.1f} s", flush=True)
        if i in MEASURE_AT or i == args.iters:
            rec["port"][f"it{i}"] = port_measure(cfg, trainer, state, beams)
            rec["jax"][f"it{i}"] = jax_measure(jstate)
            print(json.dumps(rec), flush=True)
    last = f"it{args.iters}"
    for pkg in ("port", "jax"):
        rec[pkg]["ratio_last_to_pretrain"] = rec[pkg][last] / rec[pkg]["pretrain"]
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--beams", type=int, default=8192)
    main(ap.parse_args())
