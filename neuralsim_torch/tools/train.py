"""Train a config's scene with the port: the single-scene tool (port of
neuralsim_tpu/tools/train.py:21-446) and the loop both tools share.

    from neuralsim_torch.configs import SYNTHETIC_OBJECT, WAYMO_STREETSURF, at_num_iters
    from neuralsim_torch.tools.train import main, main_function, train
    out = main_function({**at_num_iters(WAYMO_STREETSURF, 3000),
                         "exp_dir": "logs/streetsurf"})             # on the card
    out = main_function({**cfg, "resume_dir": "logs/streetsurf"})   # resume a run
    main(["--config", "configs/waymo_streetsurf.yaml", "--training.num_iters=3000",
          "--dataset_cfg.params.root=data/waymo_demo"])
    out = train(SYNTHETIC_OBJECT, 20, device="cpu")      # plain versions on the CPU

or ``python -m neuralsim_torch.tools.train --config configs/waymo_streetsurf.yaml
--dataset_cfg.params.root=data/waymo_demo [--training.num_iters=3000]
[--exp_dir=logs/run0] [--device=cpu]`` on a sequence in the Waymo layout (the
demo drive written by ``python -m neuralsim_torch.dataio.waymo_demo --root
data/waymo_demo``), or with
``--dataset_cfg.target=neuralsim_torch.dataio.waymo_demo.demo_sequence`` on
the demo drive in memory.

:func:`main_function` trains a config of a dataset (StreetSurf's
street, 4-D LoTD distant field and sky on the demo drive; EmerNeRF's
time-conditioned street and sky, configs/waymo_emernerf.yaml, whose
validation and evaluation render at t = 0 as the JAX tools do): it builds everything
(``tools.build.build_everything``), writes the exp dir (``config.json``, the
resolved config as JSON; ``metrics.jsonl`` and ``stats.p``; ``ckpts/``:
``latest`` every ``training.i_save`` seconds, ``step_N`` every
``training.i_backup`` iterations, ``final`` at the end), resumes from
``resume_dir``'s newest checkpoint with the loop's own random state and error
maps, and runs :func:`train_loop`: each iteration a LiDAR step (the street
alone) and a pixel step with the error-map sampler, the finite guard's
watchdog (:class:`FiniteWatch`) at each log, a validation frame (camera 0,
frame 0, ``training.val_downscale``) every ``training.i_val`` iterations and
at the end. ``backup_codebase``, ``training.data_parallel``,
``frame_sample_mode``, ``image_patch``, ``view`` and ``profile_iters`` are not
ported (each raises, naming itself, where a config sets it). Pose refinement
is a ``LearnableParams`` asset in the bank (``--assetbank_cfg.Pose.model_class=
neuralsim_tpu.models.assets.LearnableParams`` and its ``model_params``), whose
deltas the checkpoints keep with the other parameters; ``training.use_ts_interp``
lifts the pixel batches at the cameras' timestamps. :func:`main` is the
command line (``config.BaseConfig``), on the card unless ``--device=cpu``.

:func:`train` trains the procedural synthetic object (``SYNTHETIC_OBJECT``)
from its dataset's world-ray batches, with no exp dir.
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import BaseConfig, save_config
from ..configs import resolve_refs
from ..dataio.dataloader import ImageSampler, LidarSampler, PixelSampler
from ..dataio.synthetic import SyntheticObjectDataset
from ..scene.observers import camera_get_selected_rays
from ..training.error_map import ErrorMap, ImpSampler
from ..training.multi_trainer import lift_lidar_batch
from ..training.trainer import psnr
from ..utils.checkpoint import CheckpointIO
from ..utils.logger import Logger
from .build import build_everything, build_trainer

_BATCH_KEYS = ("rays_o", "rays_d", "image_rgb", "image_occupancy_mask")
# entries of the JAX tool's config that the port does not run
_NOT_PORTED = ("backup_codebase", "training.data_parallel", "training.frame_sample_mode",
               "training.image_patch", "training.view", "training.profile_iters")


class FiniteWatch:
    """The finite guard's watchdog (port of neuralsim_tpu/tools/train.py:304-330
    and train_multi.py:194-319). The guard skips a poisoned step on the
    device; at each log, where the loop reads the metrics anyway, this reports
    the non-finite metrics and the steps skipped since the last log (the
    ``skips_total`` counter), and raises ``FloatingPointError`` when every
    step of the window was skipped (the multi-object loop first saves the
    state as the checkpoint ``nan_debug``)."""

    def __init__(self, i_log: int, skips: int = 0):
        self.i_log = i_log
        self.last = skips

    def check(self, mm: Dict[str, float], it: int) -> None:
        bad = sorted(k for k, v in mm.items() if not math.isfinite(v))
        if bad:
            print(f"[finite-guard] non-finite metrics at it={it}: {bad} (step was skipped)",
                  flush=True)
        skips = int(mm.get("skips_total", 0))
        delta = skips - self.last
        if delta > 0:
            print(f"[finite-guard] {delta} poisoned step(s) skipped since last log "
                  f"(total {skips})", flush=True)
        self.last = skips
        if delta >= self.i_log and it > 0:
            raise FloatingPointError(f"every step in the last {self.i_log}-iteration window "
                                     f"was skipped by the finite guard at it={it}")


def to_device_batch(raw: Dict[str, np.ndarray], device, with_mask: bool = True
                    ) -> Dict[str, torch.Tensor]:
    keys = [k for k in _BATCH_KEYS if with_mask or k != "image_occupancy_mask"]
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device) for k in keys}


_PIXEL_KEYS = ("rays_fidx", "rays_xy", "image_rgb", "image_occupancy_mask")
_LIDAR_KEYS = ("rays_fidx", "rays_o_local", "rays_d_local", "ranges")


def to_device(raw: Dict[str, Any], keys, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
            for k in keys if k in raw}


def train_loop(scene, trainer, state, samplers: Dict[str, Any], num_iters: int,
               generator: torch.Generator, i_log: int = 100,
               log: Optional[list] = None, logger: Optional[Logger] = None,
               ckpt: Optional[CheckpointIO] = None, iter_s: Optional[list] = None,
               draw: Optional[Callable] = None,
               on_iter: Optional[Callable[[int, Any], None]] = None):
    """Run loop iterations from ``state.it`` up to ``num_iters``, each a
    LiDAR step (where the samplers have LiDAR data; ``it`` stays) and a pixel
    step (``it`` advances); every ``i_log`` iterations (the only other place
    the loop waits for the card) the scalar metrics of both steps go to
    ``log`` and ``logger``, are printed and go through the finite guard's
    watchdog (``FloatingPointError`` when every step of the window was
    skipped, after saving the checkpoint ``nan_debug``). After each iteration
    ``on_iter(it, state)`` (the single-scene tool's validation) and
    ``ckpt.maybe_save``; ``iter_s`` receives each iteration's seconds on the
    host clock. ``draw(step_type, n, generator, it)`` makes a step's noise
    (default: the multi-object trainer's ``draw_noise``). Returns the state."""
    draw = draw or trainer.draw_noise
    dev = state.skips.device
    pix, lid, imp = samplers["pixel"], samplers.get("lidar"), samplers.get("imp")
    log = [] if log is None else log
    t0 = time.time()
    watch = FiniteWatch(i_log, int(state.skips))
    sticky: Dict[str, torch.Tensor] = {}
    for it in range(state.it, num_iters):
        t_it = time.perf_counter()
        if lid is not None:
            lb = lid.sample()
            if lb is not None:
                lbatch = lift_lidar_batch(scene, {**to_device(lb, _LIDAR_KEYS, dev),
                                                  "lidar_id": lb["lidar_id"]})
                noise = draw("lidar", lbatch["ranges"].shape[0], generator, state.it)
                state, ml = trainer.train_step(state, lbatch, noise, "lidar", None, False)
                sticky.update({f"lidar/{k}": v for k, v in ml.items()})
        raw = pix.sample()
        batch = to_device(raw, _PIXEL_KEYS, dev)
        noise = draw("pixel", batch["rays_fidx"].shape[0], generator, state.it)
        state, m = trainer.train_step(state, batch, noise, "pixel", raw["cam_id"])
        if imp is not None and "err_map" in m:
            W, H = pix.loader.image_wh(raw["cam_id"])
            imp.update(raw["rays_fidx"], raw["rays_sel"][:, 1], raw["rays_sel"][:, 0],
                       m["err_map"].cpu().numpy(), H, W, cam_id=raw["cam_id"])
        if it % i_log == 0:
            mm = {k: float(v) for k, v in {**sticky, **m}.items() if v.dim() == 0}
            rate = (it + 1) * pix.n_rays / max(time.time() - t0, 1e-9)
            print(f"it={it} loss={mm['loss_total']:.4f} rays/s={rate:.0f}", flush=True)
            log.append({"it": it, **mm})
            if logger is not None:
                logger.add_scalars(mm, it)
            try:
                watch.check(mm, it)
            except FloatingPointError:
                if ckpt is not None:
                    ckpt.save(state, it, tag="nan_debug")
                raise
        if on_iter is not None:
            on_iter(it, state)
        if ckpt is not None:
            ckpt.maybe_save(state, it)
        if iter_s is not None:
            iter_s.append(time.perf_counter() - t_it)
    return state


def loop_state(generator: torch.Generator, samplers: Dict[str, Any]) -> Dict[str, Any]:
    """What the loop carries besides the train state: the noise generator's
    state, the samplers' numpy generators and the importance sampler's error
    maps and count."""
    imp = samplers.get("imp")
    return {"generator": generator.get_state(), "generator_device": generator.device.type,
            "rngs": {name: samplers[name].rng.bit_generator.state
                     for name in ("pixel", "lidar") if samplers.get(name) is not None},
            "imp": None if imp is None else {
                "it": imp.it, "default": torch.from_numpy(imp.error_map.map),
                "maps": {cam: torch.from_numpy(m.map) for cam, m in imp.maps.items()}}}


def restore_loop(loop: Dict[str, Any], generator: torch.Generator,
                 samplers: Dict[str, Any]) -> None:
    """Set the loop's state saved by :func:`loop_state`; the noise generator
    only on the device type it was saved from (its state is another on the
    CPU and on the card)."""
    if loop["generator_device"] != generator.device.type:
        raise ValueError(f"a run saved on {loop['generator_device']} resumes there, not on "
                         f"{generator.device.type}")
    generator.set_state(loop["generator"])
    for name, st in loop["rngs"].items():
        samplers[name].rng.bit_generator.state = st
    imp = samplers.get("imp")
    if loop["imp"] is not None:
        imp.it = int(loop["imp"]["it"])
        imp.error_map.map[...] = loop["imp"]["default"].numpy()
        for cam, m in loop["imp"]["maps"].items():
            imp._map_for(cam).map[...] = m.numpy()


def train(cfg: Dict[str, Any], num_iters: Optional[int] = None, device="cuda"
          ) -> Dict[str, Any]:
    """Train for ``num_iters`` steps (default: the config's), logging every
    ``training.i_log`` steps. ``num_iters`` also sets the learning-rate
    schedules that refer to ``${training.num_iters}``. Returns the trainer,
    the final state and the logged metrics."""
    cfg = resolve_refs({**cfg, "training": {**cfg["training"], **(
        {} if num_iters is None else {"num_iters": num_iters})}})
    tcfg = cfg["training"]
    num_iters, n_rays, i_log = tcfg["num_iters"], tcfg.get("n_rays", 4096), tcfg.get("i_log", 100)
    trainer, state = build_trainer(cfg, device)
    dev = state.skips.device
    dataset = SyntheticObjectDataset(**cfg["dataset_cfg"]["params"])
    seed = int(cfg.get("seed", 0))
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    log = []
    watch = FiniteWatch(i_log)
    t0 = time.time()
    for it in range(num_iters):
        batch = to_device_batch(dataset.sample_pixels(rng, n_rays), dev,
                                tcfg.get("with_mask", True))
        state, m = trainer.train_step(state, batch, trainer.draw_noise(n_rays, gen, state.it))
        if it % i_log == 0:     # the only place the loop waits for the device
            mm = {k: float(v) for k, v in m.items() if v.dim() == 0}
            rate = (it + 1) * n_rays / max(time.time() - t0, 1e-9)
            print(f"it={it} loss={mm['loss_total']:.4f} rays/s={rate:.0f}", flush=True)
            log.append({"it": it, **mm})
            watch.check(mm, it)
    return {"trainer": trainer, "state": state, "log": log}


def lift_pixel_batch(scene, batch: Dict[str, torch.Tensor], cam_id: str
                     ) -> Dict[str, torch.Tensor]:
    """A pixel batch {rays_fidx, rays_xy, ...} of camera ``cam_id`` -> the
    same with world rays ``rays_o``, ``rays_d`` (the scene frozen at each
    ray's frame). The training step lifts its batches itself; this is for a
    caller that wants the rays."""
    frozen = scene.slice_at(batch["rays_fidx"].long())
    ro, rd = camera_get_selected_rays(frozen, cam_id, batch["rays_xy"])
    return {**batch, "rays_o": ro, "rays_d": rd}


@torch.no_grad()
def validate(scene, renderer, params, loader, cam_id: str, fi: int,
             logger: Optional[Logger] = None, it: int = 0, downscale: int = 2,
             rayschunk: int = 4096, occ=None) -> float:
    """Render frame ``fi`` of camera ``cam_id`` at ``downscale`` (the
    deterministic query, in chunks) and return its PSNR against the image,
    logged as ``val/psnr`` (the JAX tool's image galleries are not ported)."""
    frame = ImageSampler(loader, downscale).get(cam_id, fi)
    dev = scene.nodes[cam_id].frame_data["transform"].device
    ro, rd = camera_get_selected_rays(scene.slice_at(fi), cam_id,
                                      torch.from_numpy(frame["rays_xy"]).to(dev))
    out = renderer.render_chunked(params, ro.contiguous(), rd.contiguous(),
                                  rayschunk=rayschunk, occ_states=occ)
    p = float(psnr(out["rgb_volume"], torch.from_numpy(frame["image_rgb"]).to(dev)))
    if logger is not None:
        logger.add_scalar("val/psnr", p, it)
    return p


def build_samplers(tcfg: Dict[str, Any], loader, seed: int) -> Dict[str, Any]:
    """The loop's samplers of a ``training`` block: {"pixel": PixelSampler
    (``n_rays``, with the ``error_map`` importance sampler where the block
    has one), "lidar": LidarSampler (``n_rays_lidar``) or None without
    ``with_lidar``, "imp": the ImpSampler or None}."""
    em = tcfg.get("error_map", {})
    imp = ImpSampler(ErrorMap(loader.n_frames, tuple(em.get("hw", (32, 64)))),
                     frac_uniform=em.get("frac_uniform", 0.5),
                     enable_after=em.get("enable_after", 0)) if em else None
    return {"pixel": PixelSampler(loader, n_rays=tcfg.get("n_rays", 4096), seed=seed,
                                  imp_sampler=imp),
            "lidar": LidarSampler(loader, n_rays=tcfg.get("n_rays_lidar", 4096))
            if tcfg.get("with_lidar") else None,
            "imp": imp}


def _refuse_not_ported(cfg: Dict[str, Any]) -> None:
    for path in _NOT_PORTED:
        node: Any = cfg
        for key in path.split("."):
            node = node.get(key) if isinstance(node, dict) else None
        if node:
            raise NotImplementedError(f"{path} is not ported")


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Train a single-scene config into its exp dir (``exp_dir``, default
    ``logs/exp``), resuming from ``resume_dir``'s newest checkpoint where
    given, and save ``final``. Returns {psnr (the final validation frame's),
    exp_dir, state, skips_total, scene, bank, trainer, samplers, log, iter_s
    (each iteration's seconds)}."""
    cfg = resolve_refs(cfg)
    _refuse_not_ported(cfg)
    tcfg = cfg.get("training", {})
    exp_dir = cfg.get("exp_dir", os.path.join("logs", "exp"))
    scene, bank, renderer, trainer, state, loader = build_everything(cfg, device,
                                                                      exp_dir=exp_dir)
    os.makedirs(exp_dir, exist_ok=True)
    save_config(cfg, os.path.join(exp_dir, "config.json"))
    seed = int(cfg.get("seed", 42))
    samplers = build_samplers(tcfg, loader, seed)
    gen = torch.Generator(device=state.skips.device).manual_seed(seed)
    logger = Logger(exp_dir)
    ckpt = CheckpointIO(os.path.join(exp_dir, "ckpts"), i_save_seconds=tcfg.get("i_save", 900),
                        i_backup=tcfg.get("i_backup", 0),
                        loop=lambda: loop_state(gen, samplers))
    if cfg.get("resume_dir"):
        restored = CheckpointIO(os.path.join(cfg["resume_dir"], "ckpts")).load(state)
        if restored is not None:
            state, loop = restored
            if loop is not None:
                restore_loop(loop, gen, samplers)
            print(f"resumed at it={state.it}", flush=True)

    num_iters = int(tcfg.get("num_iters", 1000))
    i_val = int(tcfg.get("i_val", max(num_iters // 4, 1)))
    val_cam = loader.cam_ids[0]
    val_ds = tcfg.get("val_downscale", 2)

    def on_iter(it, st):
        if (it + 1) % i_val == 0:
            p = validate(scene, renderer, st.params, loader, val_cam, 0, logger, it,
                         downscale=val_ds, occ=st.occ)
            print(f"[val] it={it} psnr={p:.2f}", flush=True)

    log: list = []
    iter_s: list = []
    state = train_loop(scene, trainer, state, samplers, num_iters, gen,
                       int(tcfg.get("i_log", 50)), log, logger, ckpt, iter_s,
                       draw=lambda step, n, g, it: trainer.draw_noise(n, g, it, step),
                       on_iter=on_iter)
    ckpt.save(state, num_iters, tag="final")
    p = validate(scene, renderer, state.params, loader, val_cam, 0, logger, num_iters,
                 downscale=val_ds, occ=state.occ)
    logger.save_stats()
    logger.close()
    skips_total = int(state.skips)
    print(f"done: final psnr={p:.2f} exp_dir={exp_dir} skips_total={skips_total}", flush=True)
    return {"psnr": p, "exp_dir": exp_dir, "state": state, "skips_total": skips_total,
            "scene": scene, "bank": bank, "trainer": trainer, "samplers": samplers,
            "log": log, "iter_s": iter_s}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line: ``--config`` (a YAML or JSON file), dot overrides,
    ``--resume_dir``; ``--device=cpu`` runs the plain versions on the CPU
    (default ``device``, the card)."""
    cfg = BaseConfig("neuralsim_torch trainer").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
