"""Train a multi-object scene with the port (the loop and the driver of
neuralsim_tpu/tools/train_multi.py:81-329).

    from neuralsim_torch.configs import WAYMO_DEMO_MULTI, at_num_iters
    from neuralsim_torch.tools.train_multi import main_function, train_multi
    out = main_function({**at_num_iters(WAYMO_DEMO_MULTI, 6000),
                         "exp_dir": "logs/demo"})              # on the card
    out = main_function({**cfg, "resume_dir": "logs/demo"})    # resume a run
    out = train_multi(SMALL_CFG, 3, device="cpu")              # no exp dir, the CPU

Each loop iteration takes a LiDAR step (``training.n_rays_lidar`` beams, the
street alone; ``it`` stays; none without LiDAR data) and then a pixel step
(``training.n_rays`` rays of one camera over mixed frames; ``it`` advances and
the occupancy grids refresh on their cadence); with an error map, the pixel
step's per-ray errors go back to the importance sampler (the one host copy of
the loop besides the log). At each log the finite guard's watchdog
(``tools.train.FiniteWatch``) reports the skipped steps and stops a run whose
every step of the window was skipped.

:func:`main_function` is the driver: it writes the exp dir (``config.json``,
the resolved config as JSON; ``metrics.jsonl`` and ``stats.p`` of
``utils.logger.Logger``; ``ckpts/`` of ``utils.checkpoint.CheckpointIO``:
``latest`` every ``training.i_save`` seconds, ``step_N`` every 5,000
iterations, ``final`` at the end), resumes from ``resume_dir``'s newest
checkpoint (with the loop's own random state and error maps, so that the
resumed run takes the steps an unbroken one would) and returns the run's
``skips_total``. ``nan_debug``, ``profile_iters``, ``image_patch`` and
data-parallel training are not ported (each raises, naming itself).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import resolve_refs
from ..training.multi_trainer import lift_lidar_batch
from ..utils.checkpoint import CheckpointIO
from ..utils.logger import Logger
from .build import build_multi_trainer
from .train import FiniteWatch

_PIXEL_KEYS = ("rays_fidx", "rays_xy", "image_rgb", "image_occupancy_mask")
_LIDAR_KEYS = ("rays_fidx", "rays_o_local", "rays_d_local", "ranges")


def to_device(raw: Dict[str, Any], keys, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
            for k in keys if k in raw}


def train_loop(scene, trainer, state, samplers: Dict[str, Any], num_iters: int,
               generator: torch.Generator, i_log: int = 100,
               log: Optional[list] = None, logger: Optional[Logger] = None,
               ckpt: Optional[CheckpointIO] = None, iter_s: Optional[list] = None):
    """Run loop iterations from ``state.it`` up to ``num_iters``; every
    ``i_log`` iterations (the only other place the loop waits for the card)
    the scalar metrics of both steps go to ``log`` and ``logger``, are
    printed and go through the finite guard's watchdog (``FloatingPointError``
    when every step of the window was skipped, after saving the checkpoint
    ``nan_debug``). After each iteration ``ckpt.maybe_save``; ``iter_s``
    receives each iteration's seconds on the host clock. Returns the state."""
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
                noise = trainer.draw_noise("lidar", lbatch["ranges"].shape[0], generator,
                                           state.it)
                state, ml = trainer.train_step(state, lbatch, noise, "lidar", None, False)
                sticky.update({f"lidar/{k}": v for k, v in ml.items()})
        raw = pix.sample()
        batch = to_device(raw, _PIXEL_KEYS, dev)
        noise = trainer.draw_noise("pixel", batch["rays_fidx"].shape[0], generator, state.it)
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


def train_multi(cfg: Dict[str, Any], num_iters: Optional[int] = None, device="cuda"
                ) -> Dict[str, Any]:
    """Build (:func:`~neuralsim_torch.tools.build.build_multi_trainer`) and
    train for ``num_iters`` loop iterations (default: the config's), with no
    exp dir. Returns the scene, the bank, the trainer, the final state, the
    samplers and the logged metrics."""
    cfg = resolve_refs({**cfg, "training": {**cfg["training"], **(
        {} if num_iters is None else {"num_iters": num_iters})}})
    tcfg = cfg["training"]
    scene, bank, trainer, state, samplers = build_multi_trainer(cfg, device)
    gen = torch.Generator(device=state.skips.device).manual_seed(int(cfg.get("seed", 0)))
    log: list = []
    state = train_loop(scene, trainer, state, samplers, tcfg["num_iters"], gen,
                       tcfg.get("i_log", 100), log)
    return {"scene": scene, "bank": bank, "trainer": trainer, "state": state,
            "samplers": samplers, "log": log}


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Train a config into its exp dir (``exp_dir``, default
    ``logs/exp_multi``), resuming from ``resume_dir``'s newest checkpoint
    where given, and save ``final``. Returns {exp_dir, state, skips_total,
    scene, bank, trainer, samplers, log, iter_s (each iteration's seconds)}."""
    cfg = resolve_refs(cfg)
    tcfg = cfg.get("training", {})
    for name in ("nan_debug", "profile_iters"):
        if tcfg.get(name):
            raise NotImplementedError(f"training.{name} is not ported")
    scene, bank, trainer, state, samplers = build_multi_trainer(cfg, device)
    exp_dir = cfg.get("exp_dir", os.path.join("logs", "exp_multi"))
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    gen = torch.Generator(device=state.skips.device).manual_seed(int(cfg.get("seed", 0)))
    logger = Logger(exp_dir)
    ckpt = CheckpointIO(os.path.join(exp_dir, "ckpts"), i_save_seconds=tcfg.get("i_save", 900),
                        loop=lambda: loop_state(gen, samplers))
    if cfg.get("resume_dir"):
        restored = CheckpointIO(os.path.join(cfg["resume_dir"], "ckpts")).load(state)
        if restored is not None:
            state, loop = restored
            if loop is not None:
                restore_loop(loop, gen, samplers)
            print(f"resumed at it={state.it}", flush=True)
    num_iters = int(tcfg.get("num_iters", 2000))
    log: list = []
    iter_s: list = []
    state = train_loop(scene, trainer, state, samplers, num_iters, gen, int(tcfg.get("i_log", 50)),
                       log, logger, ckpt, iter_s)
    ckpt.save(state, num_iters, tag="final")
    logger.save_stats()
    logger.close()
    skips_total = int(state.skips)
    print(f"done multi: exp_dir={exp_dir} skips_total={skips_total}", flush=True)
    return {"exp_dir": exp_dir, "state": state, "skips_total": skips_total, "scene": scene,
            "bank": bank, "trainer": trainer, "samplers": samplers, "log": log,
            "iter_s": iter_s}
