"""Evaluate a trained waymo_demo_multi run of the PyTorch port and write its
record: eval_multi (frames 0, 3 and 6, 8,192 rays a chunk), eval_lidar
(frames 0, 3 and 6), the three gates of the JAX package's demo runner, and
the summary with both metrics files under the results directory.

    python scripts/torch_finish_waymo_demo.py <exp_dir> [--results DIR] [--device cuda]
        [--skip-render]

The run's ``final`` checkpoint is evaluated, and ``skips_total`` (the steps
the finite guard skipped) is read from that checkpoint. A run whose training
was cut is first resumed to its end (``tools.train_multi.main_function`` with
``resume_dir``). A run of the drive on disk (``dataset_cfg.target``
``WaymoDataset``) is then rendered as the JAX package's runner renders it
(``tools.render``: ``replay`` of frames 0 and 4, ``topdown`` 256 pixels wide
with its video; the record names the Pillow that wrote it) unless ``--skip-render``; an in-memory run renders nothing besides the
evaluation's images.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RESULTS = os.path.join(ROOT, "results", "waymo_demo_torch")


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the device."""
    if not device.startswith("cuda"):
        return device
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def gates(summary: dict) -> dict:
    """The JAX runner's acceptance gates, from the unrounded metrics: under 1%
    of the steps skipped; the street owns the road pixels (its visibility
    mass there above 0.5 and above twice the distant field's); under 25% of
    the valid beams miss inside the street's box."""
    pc = summary["eval_multi"]["per_class"]
    street = pc.get("street", {}).get("road_vis_mass")
    distant = pc.get("distant", {}).get("road_vis_mass")
    return {"skips_ok": summary["skips_total"] < summary["iters"] * 0.01,
            "road_ownership_ok": (street is not None and distant is not None
                                  and street > 2 * distant and street > 0.5),
            "lidar_recall_ok": summary["eval_lidar"].get("miss_in_cuboid_frac", 1.0) < 0.25}


def render_run(base: dict, device: str) -> dict:
    """The JAX runner's renders of a run (scripts/run_waymo_demo.py:97-107):
    replay of frames 0 and 4, then the top-down map 256 pixels wide and its
    video -> what was written."""
    import PIL
    from neuralsim_torch.tools.render import main_function as render_main
    renderer = {**base["renderer"], "type": "multi"}
    out = {"pillow": PIL.__version__}
    t0 = time.perf_counter()
    r = render_main({**base, "renderer": renderer,
                     "render": {"mode": "replay", "frames": [0, 4], "video": False,
                                "per_obj": True}}, device)
    out["replay"] = {"s": time.perf_counter() - t0, "frames": r["frames"],
                     "files": sorted(os.listdir(r["out_dir"]))}
    t0 = time.perf_counter()
    r = render_main({**base, "renderer": renderer,
                     "render": {"mode": "topdown", "topdown_w": 256,
                                "video": True, "fps": 6}}, device)
    out["topdown"] = {"s": time.perf_counter() - t0, "frames": r["frames"],
                      "video": r["video"] and os.path.basename(r["video"]),
                      "files": sorted(os.listdir(r["out_dir"]))}
    return out


def finish(exp: str, results: str = RESULTS, device: str = "cuda", train: dict = None,
           render: bool = True) -> dict:
    """Evaluate the run in ``exp`` (and render a run of the drive on disk,
    where ``render``) and write ``<results>/<run>.json`` (the summary, with
    ``train`` merged in), ``<run>_metrics.json`` and
    ``<run>_lidar_metrics.json``. Returns the summary."""
    import torch
    from neuralsim_torch.tools.eval_lidar import main_function as eval_lidar_main
    from neuralsim_torch.tools.eval_multi import main_function as eval_main
    from neuralsim_torch.utils.checkpoint import STATE_FILE

    exp = os.path.abspath(exp)
    run = os.path.basename(exp.rstrip("/"))
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    final = os.path.join(exp, "ckpts", "final", STATE_FILE)
    if not os.path.isfile(final):
        raise FileNotFoundError(f"{final}: the run has no final checkpoint; resume it to its "
                                "end first")
    ck = torch.load(final, map_location="cpu", weights_only=True)
    summary = {"run": run, "exp_dir": exp, "iters": int(cfg["training"]["num_iters"]),
               "seed": cfg.get("seed"), "device": device, "card": card(device),
               "cp": "stacked" if os.environ.get("NEURALSIM_CP_STACKED", "1") != "0"
               else "per-level", **(train or {}),
               "checkpoint_it": int(ck["it"]), "skips_total": int(ck["skips"]),
               "skips_total_source": "ckpts/final"}
    base = {**cfg, "resume_dir": exp, "ckpt": "final"}
    t0 = time.perf_counter()
    out = eval_main({**base, "eval": {"frames": [0, 3, 6], "rayschunk": 8192}}, device)
    summary["eval_multi_s"] = time.perf_counter() - t0
    summary["eval_multi"] = {"mean": out["mean"], "per_class": out["per_class"]}
    t0 = time.perf_counter()
    lout = eval_lidar_main({**base, "renderer": {**cfg["renderer"], "type": "multi"},
                            "eval": {"frames": [0, 3, 6]}}, device)
    summary["eval_lidar_s"] = time.perf_counter() - t0
    summary["eval_lidar"] = lout["mean"]
    on_disk = cfg["dataset_cfg"]["target"].rsplit(".", 1)[-1] == "WaymoDataset"
    summary["data"] = {"target": cfg["dataset_cfg"]["target"],
                       "frames": "in memory, uncompressed"}
    if on_disk:
        import PIL
        summary["data"].update(root=cfg["dataset_cfg"]["params"]["root"],
                               frames="JPEG, quality 95, decoded by Pillow " + PIL.__version__)
    if on_disk and render:
        summary["render"] = render_run(base, device)
    summary["gates"] = gates(summary)
    summary["gates_all_ok"] = all(summary["gates"].values())
    os.makedirs(results, exist_ok=True)
    with open(os.path.join(results, f"{run}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for rel in ("eval_multi/metrics.json", "eval/lidar_metrics.json"):
        shutil.copy(os.path.join(exp, rel),
                    os.path.join(results, f"{run}_{os.path.basename(rel)}"))
    print("WAYMO DEMO FINISH DONE ->", exp, flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_dir")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-render", action="store_true")
    args = ap.parse_args()
    finish(args.exp_dir, args.results, args.device, render=not args.skip_render)
