"""Train waymo_demo_multi with the PyTorch port for its whole schedule, then
evaluate it and write its record (scripts/torch_finish_waymo_demo.py).

    python scripts/torch_run_waymo_demo.py [iters] [--seed 42] [--device cuda]
        [--results DIR] [--logs DIR] [--i-save SECONDS]
    NEURALSIM_CP_STACKED=0 python scripts/torch_run_waymo_demo.py 6000   # per-level CP

The config is ``WAYMO_DEMO_MULTI`` with its schedule set for ``iters``
(``configs.at_num_iters``), logged every iters // 20 iterations, into a fresh
exp dir ``<logs>/torch_<cp>_s<seed>_<time>`` (``latest`` saved every
``--i-save`` seconds, so that a cut run resumes: ``main_function`` with
``resume_dir``, then the finish script). The summary adds the training's
seconds, each iteration's median, 10th and 90th percentile on the host clock
(the loop waits for the card once an iteration, for the error map) and the
skipped steps that the run returned.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from torch_finish_waymo_demo import RESULTS, ROOT, finish

LOGS = os.path.join(ROOT, "logs", "waymo_demo_torch")


def main(args) -> dict:
    from neuralsim_torch.configs import WAYMO_DEMO_MULTI, at_num_iters
    from neuralsim_torch.tools.train_multi import main_function as train_main

    cp = "stacked" if os.environ.get("NEURALSIM_CP_STACKED", "1") != "0" else "perlevel"
    run = time.strftime(f"torch_{cp}_s{args.seed}_%Y%m%d_%H%M%S")
    exp = os.path.join(args.logs, run)
    os.makedirs(exp, exist_ok=False)
    cfg = at_num_iters(WAYMO_DEMO_MULTI, args.iters)
    cfg.update(exp_dir=exp, seed=args.seed)
    cfg["training"].update(i_log=max(args.iters // 20, 1), i_save=args.i_save)
    t0 = time.perf_counter()
    out = train_main(cfg, args.device)
    it_ms = np.asarray(out["iter_s"]) * 1e3
    train = {"train_s": time.perf_counter() - t0, "iterations_timed": int(it_ms.size),
             "iteration_ms_median": float(np.median(it_ms)),
             "iteration_ms_p10": float(np.percentile(it_ms, 10)),
             "iteration_ms_p90": float(np.percentile(it_ms, 90)),
             "skips_total_returned": out["skips_total"]}
    del out
    summary = finish(exp, args.results, args.device, train)
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
    main(ap.parse_args())
