"""Train a multi-object scene with the port (the tool of
neuralsim_tpu/tools/train_multi.py:81-329; the loop, ``train_loop``, is the
single-scene tool's, in tools/train.py).

    from neuralsim_torch.configs import WAYMO_DEMO_MULTI, at_num_iters
    from neuralsim_torch.tools.train_multi import main_function, train_multi
    out = main_function({**at_num_iters(WAYMO_DEMO_MULTI, 6000),
                         "exp_dir": "logs/demo"})              # on the card
    out = main_function({**cfg, "resume_dir": "logs/demo"})    # resume a run
    out = train_multi(SMALL_CFG, 3, device="cpu")              # no exp dir, the CPU
    main(["--config", "configs/waymo_demo_multi.yaml",
          "--dataset_cfg.params.root=data/waymo_demo"])          # the YAML as written

or ``python -m neuralsim_torch.tools.train_multi --config configs/waymo_demo_multi.yaml
--dataset_cfg.params.root=data/waymo_demo [--training.num_iters=6000]
[--exp_dir=logs/run0] [--device=cpu]``.

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
``skips_total``. ``nan_debug``, ``profile_iters``, ``image_patch``,
data-parallel training and pose refinement (a ``LearnableParams`` asset) are
not ported (each raises, naming itself).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..utils.checkpoint import CheckpointIO
from ..utils.logger import Logger
from .build import build_multi_trainer
# the loop is the single-scene tool's, shared by both tools
from .train import (_LIDAR_KEYS, _PIXEL_KEYS, FiniteWatch, loop_state,  # noqa: F401
                    restore_loop, to_device, train_loop)

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


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--config`` (a YAML or JSON
    file) or ``--resume_dir`` (whose ``config.json`` is read without
    ``--config``), dot overrides, ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch multi trainer").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
