"""Train a config's scene with the port (the loop of
neuralsim_tpu/tools/train.py:346-419 over pixel batches).

    from neuralsim_torch.configs import SYNTHETIC_OBJECT
    from neuralsim_torch.tools.train import train
    out = train(SYNTHETIC_OBJECT, 1500)                  # on the card
    out = train(SYNTHETIC_OBJECT, 20, device="cpu")      # plain versions on the CPU

Batches come from the synthetic dataset's ``sample_pixels`` (its object's
transform is the identity, so the rays are already in object coordinates). At
each log the finite guard's watchdog (:class:`FiniteWatch`) reports the steps
that the guard skipped and stops a run whose every step of the window was
skipped. The scene graph, the asset bank, the data loader with its importance sampling,
checkpoints, validation frames and the command line of the JAX tool are not
ported yet.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import resolve_refs
from ..dataio.synthetic import SyntheticObjectDataset
from .build import build_trainer

_BATCH_KEYS = ("rays_o", "rays_d", "image_rgb", "image_occupancy_mask")


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
