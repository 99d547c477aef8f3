"""Train waymo_demo_multi with the PyTorch port for its whole schedule, then
evaluate it and write its record (scripts/torch_finish_waymo_demo.py).

    python scripts/torch_run_waymo_demo.py [iters] [--seed 42] [--device cuda]
        [--results DIR] [--logs DIR] [--i-save SECONDS] [--data-root DIR] [--skip-render]
    NEURALSIM_CP_STACKED=0 python scripts/torch_run_waymo_demo.py 6000   # per-level CP

Without ``--data-root`` the config is ``WAYMO_DEMO_MULTI`` (the demo drive in
memory, its frames uncompressed) with its schedule set for ``iters``
(``configs.at_num_iters``). With ``--data-root`` the script runs the chain of
the JAX package's runner (scripts/run_waymo_demo.py) in the port: the demo
drive (8 frames of 80x120, 3 vehicles) is written there in the Waymo layout
by the port's writer where it is missing (its frames JPEG at quality 95),
configs/waymo_demo_multi.yaml is read as written by the port's config reader
with ``dataset_cfg.params.root`` pointed at it, and after the evaluation the
run is rendered (``replay`` of frames 0 and 4, ``topdown`` 256 pixels wide,
with its video where Pillow is there to assemble it) unless
``--skip-render``. Either way the run is logged every iters // 20
iterations into a fresh exp dir ``<logs>/torch_<cp>[_jpeg]_s<seed>_<time>``
(``latest`` saved every ``--i-save`` seconds, so that a cut run resumes:
``main_function`` with ``resume_dir``, then the finish script). The summary
adds the training's seconds, each iteration's median, 10th and 90th
percentile on the host clock (the loop waits for the card once an iteration,
for the error map) and the skipped steps that the run returned.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from torch_finish_waymo_demo import RESULTS, ROOT, finish

LOGS = os.path.join(ROOT, "logs", "waymo_demo_torch")


YAML = os.path.join(ROOT, "configs", "waymo_demo_multi.yaml")


def config(args, exp: str) -> dict:
    """The run's config: the YAML on the drive written under ``--data-root``,
    or ``WAYMO_DEMO_MULTI`` in memory."""
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI, at_num_iters, load_config
    if args.data_root:
        from neuralsim_torch.dataio.waymo_demo import build_demo_sequence
        if not os.path.isfile(os.path.join(args.data_root, "demo_drive", "scenario.pt")):
            build_demo_sequence(args.data_root, n_frames=8, H=80, W=120, n_vehicles=3)
        cfg = load_config(YAML)
        cfg["dataset_cfg"]["params"]["root"] = args.data_root
        cfg["training"]["num_iters"] = args.iters
    else:
        cfg = at_num_iters(WAYMO_DEMO_MULTI, args.iters)
    cfg.update(exp_dir=exp, seed=args.seed)
    cfg["training"].update(i_log=max(args.iters // 20, 1), i_save=args.i_save)
    return cfg


def main(args) -> dict:
    from neuralsim_torch.tools.train_multi import main_function as train_main

    cp = "stacked" if os.environ.get("NEURALSIM_CP_STACKED", "1") != "0" else "perlevel"
    data = "_jpeg" if args.data_root else ""
    run = time.strftime(f"torch_{cp}{data}_s{args.seed}_%Y%m%d_%H%M%S")
    exp = os.path.join(args.logs, run)
    os.makedirs(exp, exist_ok=False)
    cfg = config(args, exp)
    t0 = time.perf_counter()
    out = train_main(cfg, args.device)
    it_ms = np.asarray(out["iter_s"]) * 1e3
    train = {"train_s": time.perf_counter() - t0, "iterations_timed": int(it_ms.size),
             "iteration_ms_median": float(np.median(it_ms)),
             "iteration_ms_p10": float(np.percentile(it_ms, 10)),
             "iteration_ms_p90": float(np.percentile(it_ms, 90)),
             "skips_total_returned": out["skips_total"]}
    del out
    summary = finish(exp, args.results, args.device, train, render=not args.skip_render)
    if summary["skips_total"] != train["skips_total_returned"]:
        raise AssertionError("the final checkpoint's skips differ from the run's")
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("iters", nargs="?", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--logs", default=LOGS)
    ap.add_argument("--i-save", type=float, default=300.0,
                    help="seconds between the 'latest' checkpoints")
    ap.add_argument("--data-root", default=None,
                    help="train the YAML on the demo drive written (if missing) here")
    ap.add_argument("--skip-render", action="store_true")
    main(ap.parse_args())
