"""Evaluate a multi-object scene: full, foreground and background image
metrics and each source's share of the composited frame (port of
neuralsim_tpu/tools/eval_multi.py).

    from neuralsim_torch.tools.eval_multi import main_function
    out = main_function({**cfg, "resume_dir": "logs/demo",
                         "eval": {"frames": [0, 3, 6], "rayschunk": 8192}})   # on the card
    main(["--resume_dir", "logs/demo", "--eval.frames=0,3,6"])     # the command line

Each frame is rendered whole by the compose renderer (deterministic, every
source's share kept) and scored against its image: PSNR, SSIM (LPIPS None:
no VGG weights), PSNR on the ground-truth mask's foreground and background,
the rendered mask's BCE and accuracy. Each source (an object by id, "street",
"distant") gets its visibility mass and its PSNR where it dominates, and, on
the ground pixels of the dataset's semantic mask (not sky, human or vehicle),
its visibility mass and dominant share there (``road_vis_mass``,
``road_dominant_frac``: which model owns the road); the means by class
follow. :func:`main_function` restores the newest checkpoint of
``resume_dir`` (or ``exp_dir``) with its iteration stamped on the fields
(``utils.misc.set_eval_iteration``) and writes
``<exp>/eval_multi/metrics.json``, ``per_object.csv`` and the first frame's
images (``rgb_``, ``gt_``, ``depth_``, ``obj_<source>_<frame>.png``). The
port builds no time-conditioned field (its config raises at build), so a
frame is rendered without a frame time.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..dataio.dataloader import ImageSampler
from ..dataio.waymo_demo import DYNAMIC_IDS, HUMAN_IDS, SKY_ID, VEHICLE_IDS
from ..maths.metrics import lpips_np, psnr_np, ssim_np
from ..scene.observers import camera_get_selected_rays
from ..utils.checkpoint import CheckpointIO
from ..utils.logger import _write_png, color_depth
from ..utils.misc import set_eval_iteration
from .build import build_multi_trainer


def _bce(pred: np.ndarray, gt: np.ndarray, eps: float = 1e-6) -> float:
    p = np.clip(pred, eps, 1.0 - eps)
    return float(-(gt * np.log(p) + (1.0 - gt) * np.log(1.0 - p)).mean())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def ground_mask(loader, scene_id: str, cam_id: str, fi: int, H: int, W: int
                ) -> Optional[np.ndarray]:
    """The ground pixels [H, W] of a frame scored at H x W (not sky, human,
    vehicle or dynamic, by the dataset's semantic mask, subsampled to the
    scoring size), or None where the dataset has no semantic mask or the
    frame no ground."""
    ds = getattr(loader, "dataset", None)
    if ds is None or not hasattr(ds, "get_semantic_mask"):
        return None
    sem = ds.get_semantic_mask(scene_id, cam_id, fi)
    if sem is None:
        return None
    non_ground = np.isin(sem, (SKY_ID,) + HUMAN_IDS + VEHICLE_IDS + DYNAMIC_IDS)
    s = max(sem.shape[0] // H, 1)
    ground = ~non_ground[::s, ::s][:H, :W]
    return ground if ground.any() else None


@torch.no_grad()
def evaluate_multi(scene, renderer, params, loader, *, cam_id: str, frames: List[int],
                   downscale: int = 1, rayschunk: int = 4096,
                   lpips_weights: Optional[str] = None, out_dir: Optional[str] = None,
                   occ=None) -> Dict[str, Any]:
    """Render and score ``frames`` of camera ``cam_id`` (every
    ``downscale``-th pixel, ``rayschunk`` rays a chunk, the grids' states
    ``occ``). Returns {per_frame, per_object, per_class, mean}; with
    ``out_dir`` the first frame's images go there."""
    dev = next(params.parameters()).device
    sampler = ImageSampler(loader, downscale)
    rows: List[Dict[str, Any]] = []
    obj_rows: List[Dict[str, Any]] = []
    class_of = {oid: scene.drawables[oid].class_name for oid in scene.drawable_ids()}

    for fi in frames:
        frame = sampler.get(cam_id, fi)
        frozen = scene.slice_at(fi)
        ro, rd = camera_get_selected_rays(frozen, cam_id,
                                          torch.from_numpy(frame["rays_xy"]).to(dev))
        r = renderer.render_chunked(params, frozen, ro.contiguous(), rd.contiguous(),
                                    rayschunk=rayschunk, occ_states=occ)
        H, W = frame["hw"]
        pred = _np(r["rgb_volume"]).reshape(H, W, 3)
        gt = np.asarray(frame["image_rgb"]).reshape(H, W, 3)
        row: Dict[str, Any] = {"frame": fi, "cam": cam_id, "psnr": psnr_np(pred, gt),
                               "ssim": ssim_np(pred, gt),
                               "lpips": lpips_np(pred, gt, lpips_weights)}
        pred_mask = _np(r["mask_volume"]).reshape(H, W)
        if "image_occupancy_mask" in frame:
            m = np.asarray(frame["image_occupancy_mask"]).reshape(H, W) > 0.5
            if m.any():
                row["psnr_fg"] = psnr_np(pred[m], gt[m])
            if (~m).any():
                row["psnr_bg"] = psnr_np(pred[~m], gt[~m])
            row["mask_bce"] = _bce(pred_mask, m.astype(np.float32))
            row["mask_acc"] = float(((pred_mask > 0.5) == m).mean())
        rows.append(row)

        ground = ground_mask(loader, scene.id, cam_id, fi, H, W)
        per_obj = sorted(r.get("per_obj", {}).items())
        for name, sub in per_obj:
            om = _np(sub["mask_volume"]).reshape(H, W)
            dominant = om > 0.5
            orow: Dict[str, Any] = {"frame": fi, "object": name,
                                    "class": class_of.get(name, name),
                                    "vis_mass": float(om.mean()),
                                    "pixels_dominant": int(dominant.sum())}
            if dominant.any():
                orow["psnr_in_scene"] = psnr_np(pred[dominant], gt[dominant])
                orow["mean_depth"] = float(_np(sub["depth_volume"]).reshape(H, W)[dominant]
                                           .mean())
            if ground is not None:
                orow["road_vis_mass"] = float(om[ground].mean())
                orow["road_dominant_frac"] = float((om[ground] > 0.5).mean())
            obj_rows.append(orow)

        if out_dir and fi == frames[0]:
            _write_png(os.path.join(out_dir, f"rgb_{fi:04d}.png"), _u8(pred))
            _write_png(os.path.join(out_dir, f"gt_{fi:04d}.png"), _u8(gt))
            _write_png(os.path.join(out_dir, f"depth_{fi:04d}.png"),
                       _u8(color_depth(_np(r["depth_volume"]).reshape(H, W))))
            for name, sub in per_obj:
                _write_png(os.path.join(out_dir, f"obj_{name}_{fi:04d}.png"),
                           _u8(_np(sub["rgb_volume"]).reshape(H, W, 3)))

    agg: Dict[str, Any] = {}
    for k in rows[0]:
        if k in ("frame", "cam"):
            continue
        vals = [x[k] for x in rows if x.get(k) is not None]
        agg[k] = float(np.mean(vals)) if vals else None
    per_class: Dict[str, Dict[str, Any]] = {}
    for cls in sorted({o["class"] for o in obj_rows}):
        sel = [o for o in obj_rows if o["class"] == cls]
        psnrs = [o["psnr_in_scene"] for o in sel if "psnr_in_scene" in o]
        per_class[cls] = {"vis_mass": float(np.mean([o["vis_mass"] for o in sel])),
                          "psnr_in_scene": float(np.mean(psnrs)) if psnrs else None,
                          "n_objects": len({o["object"] for o in sel})}
        road = [o["road_vis_mass"] for o in sel if "road_vis_mass" in o]
        if road:
            per_class[cls]["road_vis_mass"] = float(np.mean(road))
            per_class[cls]["road_dominant_frac"] = float(np.mean(
                [o["road_dominant_frac"] for o in sel]))
    return {"per_frame": rows, "per_object": obj_rows, "per_class": per_class, "mean": agg}


def load_for_eval(cfg: Dict[str, Any], device="cuda"):
    """The config's scene, renderer, parameters and data loader (built
    without the geometry pretraining) with the checkpoint ``ckpt`` (a tag,
    default the newest) of ``resume_dir`` (or ``exp_dir``) copied in and its
    iteration stamped on the fields. -> (scene, renderer, params, occ (None
    without a checkpoint), loader, exp dir)."""
    scene, _, trainer, state, samplers = build_multi_trainer(cfg, device, pretrain=False)
    exp_dir = cfg.get("resume_dir") or cfg.get("exp_dir", ".")
    restored = CheckpointIO(os.path.join(exp_dir, "ckpts")).load(state, cfg.get("ckpt"))
    occ = None
    if restored is not None:
        occ = state.occ
        set_eval_iteration(state.params.values(), state.it)
    return scene, trainer.renderer, state.params, occ, samplers["pixel"].loader, exp_dir


def eval_frames(ecfg: Dict[str, Any], n_frames: int) -> List[int]:
    """``eval.frames`` as a list (a "0,3,6" string, an int or a list);
    default every (n // 8)-th frame."""
    frames = ecfg.get("frames")
    if isinstance(frames, str):
        frames = [int(x) for x in frames.split(",")]
    elif isinstance(frames, int):
        frames = [frames]
    return frames or list(range(0, n_frames, max(n_frames // 8, 1)))


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Evaluate the run of ``resume_dir`` (or ``exp_dir``) with the ``eval``
    block {frames, cam_id, downscale, rayschunk, lpips_weights} and write
    ``<exp>/eval_multi/``. Returns :func:`evaluate_multi`'s result."""
    cfg = resolve_refs(cfg)
    scene, renderer, params, occ, loader, exp_dir = load_for_eval(cfg, device)
    ecfg = cfg.get("eval", {})
    out_dir = os.path.join(exp_dir, "eval_multi")
    os.makedirs(out_dir, exist_ok=True)
    out = evaluate_multi(scene, renderer, params, loader, occ=occ,
                         cam_id=ecfg.get("cam_id", loader.cam_ids[0]),
                         frames=eval_frames(ecfg, scene.n_frames),
                         downscale=int(ecfg.get("downscale", 1)),
                         rayschunk=int(ecfg.get("rayschunk", 4096)),
                         lpips_weights=ecfg.get("lpips_weights"), out_dir=out_dir)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    if out["per_object"]:
        with open(os.path.join(out_dir, "per_object.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted({k for o in out["per_object"] for k in o}))
            w.writeheader()
            w.writerows(out["per_object"])
    print(json.dumps({"mean": out["mean"], "per_class": out["per_class"]}), flush=True)
    return out


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--config`` (a YAML or JSON
    file) or ``--resume_dir`` (whose ``config.json`` is read without
    ``--config``), dot overrides, ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch multi eval").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
