"""Train a multi-object scene with the port (the loop of
neuralsim_tpu/tools/train_multi.py:223-320).

    from neuralsim_torch.configs import WAYMO_DEMO_MULTI
    from neuralsim_torch.tools.train_multi import train_multi
    out = train_multi(WAYMO_DEMO_MULTI, 600)                # on the card
    out = train_multi(SMALL_CFG, 3, device="cpu")           # plain versions on the CPU

Each loop iteration takes a LiDAR step (``training.n_rays_lidar`` beams, the
street alone; ``it`` stays; none without LiDAR data) and then a pixel step
(``training.n_rays`` rays of one camera over mixed frames; ``it`` advances and
the occupancy grids refresh on their cadence); with an error map, the pixel
step's per-ray errors go back to the importance sampler (the one host copy of
the loop besides the log). At each log the finite guard's watchdog
(``tools.train.FiniteWatch``) reports the skipped steps and stops a run whose
every step of the window was skipped.
Checkpoints, the logger, ``nan_debug``, ``profile_iters`` and data-parallel
training are not ported.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import resolve_refs
from ..training.multi_trainer import lift_lidar_batch
from .build import build_multi_trainer
from .train import FiniteWatch

_PIXEL_KEYS = ("rays_fidx", "rays_xy", "image_rgb", "image_occupancy_mask")
_LIDAR_KEYS = ("rays_fidx", "rays_o_local", "rays_d_local", "ranges")


def to_device(raw: Dict[str, Any], keys, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
            for k in keys if k in raw}


def train_loop(scene, trainer, state, samplers: Dict[str, Any], num_iters: int,
               generator: torch.Generator, i_log: int = 100,
               log: Optional[list] = None):
    """Run loop iterations from ``state.it`` up to ``num_iters``; every
    ``i_log`` iterations (the only other place the loop waits for the card)
    the scalar metrics of both steps go to ``log``, are printed and go through
    the finite guard's watchdog (``FloatingPointError`` when every step of
    the window was skipped). Returns the state."""
    dev = state.skips.device
    pix, lid, imp = samplers["pixel"], samplers.get("lidar"), samplers.get("imp")
    log = [] if log is None else log
    t0 = time.time()
    watch = FiniteWatch(i_log, int(state.skips))
    sticky: Dict[str, torch.Tensor] = {}
    for it in range(state.it, num_iters):
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
            watch.check(mm, it)
    return state


def train_multi(cfg: Dict[str, Any], num_iters: Optional[int] = None, device="cuda"
                ) -> Dict[str, Any]:
    """Build (:func:`~neuralsim_torch.tools.build.build_multi_trainer`) and
    train for ``num_iters`` loop iterations (default: the config's). Returns the
    scene, the bank, the trainer, the final state, the samplers and the
    logged metrics."""
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
