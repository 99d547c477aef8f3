"""Evaluate a single-scene run: PSNR, SSIM (LPIPS None: no VGG weights) and
the foreground and background PSNR of validation frames (port of
neuralsim_tpu/tools/eval.py:19-116).

    from neuralsim_torch.tools.eval import main
    main(["--resume_dir", "logs/waymo_streetsurf", "--eval.frames=0,4"])   # on the card

or ``python -m neuralsim_torch.tools.eval --resume_dir <exp> [--eval.frames=0,4,8]
[--eval.downscale=2] [--device=cpu]``. Each frame of the first camera is
rendered whole (the deterministic query, in chunks, the grid's state of the
checkpoint) and scored against its image; the ground truth's occupancy mask
splits the foreground from the background and scores the rendered mask's
accuracy. :func:`main_function` restores the checkpoint ``ckpt`` (default the
newest) of ``resume_dir`` (or ``exp_dir``) with its iteration stamped on the
fields and writes ``<exp>/eval/metrics.json``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..dataio.dataloader import ImageSampler
from ..maths.metrics import lpips_np, psnr_np, ssim_np
from ..scene.observers import camera_get_selected_rays
from ..utils.checkpoint import CheckpointIO
from ..utils.misc import set_eval_iteration
from .build import build_everything
from .eval_multi import eval_frames


@torch.no_grad()
def evaluate(scene, renderer, params, loader, *, cam_id: str, frames: List[int],
             downscale: int = 1, rayschunk: int = 4096, lpips_weights: Optional[str] = None,
             occ=None) -> Dict[str, Any]:
    """Render and score ``frames`` of camera ``cam_id``. Returns {per_frame, mean}."""
    dev = next(params.parameters()).device
    sampler = ImageSampler(loader, downscale)
    rows = []
    for fi in frames:
        frame = sampler.get(cam_id, fi)
        ro, rd = camera_get_selected_rays(scene.slice_at(fi), cam_id,
                                          torch.from_numpy(frame["rays_xy"]).to(dev))
        r = renderer.render_chunked(params, ro.contiguous(), rd.contiguous(),
                                    rayschunk=rayschunk, occ_states=occ)
        H, W = frame["hw"]
        pred = r["rgb_volume"].cpu().numpy().reshape(H, W, 3)
        gt = np.asarray(frame["image_rgb"]).reshape(H, W, 3)
        row = {"frame": fi, "psnr": psnr_np(pred, gt), "ssim": ssim_np(pred, gt),
               "lpips": lpips_np(pred, gt, lpips_weights)}
        if "image_occupancy_mask" in frame:
            m = np.asarray(frame["image_occupancy_mask"]).reshape(H, W) > 0.5
            if m.any():
                row["psnr_fg"] = psnr_np(pred[m], gt[m])
            if (~m).any():
                row["psnr_bg"] = psnr_np(pred[~m], gt[~m])
            pred_mask = r["mask_volume"].cpu().numpy().reshape(H, W)
            row["mask_acc"] = float(((pred_mask > 0.5) == m).mean())
        rows.append(row)

    agg = {}
    for k in rows[0]:
        if k == "frame":
            continue
        vals = [x[k] for x in rows if x.get(k) is not None]
        agg[k] = float(np.mean(vals)) if vals else None
    return {"per_frame": rows, "mean": agg}


def load_single_for_eval(cfg: Dict[str, Any], device="cuda"):
    """A single-scene config's scene, renderer, parameters and data loader
    (built without the geometry pretraining) with the checkpoint ``ckpt`` (a
    tag, default the newest) of ``resume_dir`` (or ``exp_dir``) copied in and
    its iteration stamped on the fields. -> (scene, renderer, params, occ
    (None without a checkpoint), loader, exp dir)."""
    scene, _, renderer, trainer, state, loader = build_everything(cfg, device,
                                                                  pretrain=False)
    exp_dir = cfg.get("resume_dir") or cfg.get("exp_dir", ".")
    restored = CheckpointIO(os.path.join(exp_dir, "ckpts")).load(state, cfg.get("ckpt"))
    occ = None
    if restored is not None:
        occ = state.occ
        set_eval_iteration(state.params.values(), state.it)
    return scene, renderer, state.params, occ, loader, exp_dir


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Evaluate the run of ``resume_dir`` (or ``exp_dir``) with the ``eval``
    block {frames, downscale, rayschunk, lpips_weights} and write
    ``<exp>/eval/metrics.json``. Returns :func:`evaluate`'s result."""
    cfg = resolve_refs(cfg)
    scene, renderer, params, occ, loader, exp_dir = load_single_for_eval(cfg, device)
    ecfg = cfg.get("eval", {})
    out = evaluate(scene, renderer, params, loader, cam_id=loader.cam_ids[0],
                   frames=eval_frames(ecfg, scene.n_frames),
                   downscale=int(ecfg.get("downscale", 1)),
                   rayschunk=int(ecfg.get("rayschunk", 4096)),
                   lpips_weights=ecfg.get("lpips_weights"), occ=occ)
    os.makedirs(os.path.join(exp_dir, "eval"), exist_ok=True)
    with open(os.path.join(exp_dir, "eval", "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["mean"]), flush=True)
    return out


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch eval").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
