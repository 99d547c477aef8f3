"""LiDAR evaluation of a multi-object scene: the street's depth along the
ground-truth beams, chamfer distances and the depth errors (port of
neuralsim_tpu/tools/eval_lidar.py).

    from neuralsim_torch.tools.eval_lidar import main_function
    out = main_function({**cfg, "resume_dir": "logs/demo",
                         "renderer": {**cfg["renderer"], "type": "multi"},
                         "eval": {"frames": [0, 3, 6]}})               # on the card

Each frame's beams (those with a return) are rendered through the compose
renderer frozen at that frame, the street alone (``only_cr``, no rgb), at the
field's own inv_s (or ``eval.forward_inv_s``). A beam whose rendered mask
clears ``pred_mask`` is a hit: the depth RMSE and MAE are over the hits;
``hit_recall`` is their share of the beams; the misses split into those whose
ground-truth return lies inside the street's box and those outside it; the
chamfer distance (full, 99, 97 and 95% trims) holds the hit points against
the whole ground-truth cloud, both ways. :func:`main_function` restores the
newest checkpoint of ``resume_dir`` (or ``exp_dir``) and writes
``<exp>/eval/lidar_metrics.json``. A single-scene config (``renderer.type``
other than "multi") is built by ``tools.build.build_everything`` and its
street is rendered alone along the beams by the single-volume renderer.
From the command line: ``python -m neuralsim_torch.tools.eval_lidar
--resume_dir <exp> [--renderer.type=multi] [--eval.frames=0,3,6]
[--device=cpu]``.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..maths.common import chamfer_distance
from ..scene.observers import lidar_rays_to_world
from .eval import load_single_for_eval
from .eval_multi import eval_frames, load_for_eval

_TRIMS = ((None, ""), (0.99, "_99"), (0.97, "_97"), (0.95, "_95"))


class ComposeLidarAdapter:
    """A compose renderer frozen at one frame (``set_frame``), with the
    single-scene renderer's ``ray_query(params, rays_o, rays_d, **kw)``."""

    def __init__(self, scene, renderer):
        self.scene, self.renderer = scene, renderer
        self._fi = 0

    def set_frame(self, fi: int) -> None:
        self._fi = fi

    def ray_query(self, params, rays_o, rays_d, **kw):
        kw = {k: v for k, v in kw.items()
              if k in ("with_rgb", "only_cr", "query_overrides", "occ_states")}
        return self.renderer.ray_query(params, self.scene.slice_at(self._fi), rays_o, rays_d,
                                       **kw)


@torch.no_grad()
def eval_lidar_frames(scene, renderer, params, loader, *, frames, forward_inv_s=None,
                      occ=None, pred_mask: float = 0.5, cr_aabb=None) -> Dict[str, Any]:
    """Score the beams of every LiDAR of the loader at ``frames`` (a frame
    with fewer than 10 hits is left out). ``cr_aabb`` (min, max), where
    given, splits the misses by the street's box. Returns {per_frame, mean}."""
    dev = next(params.parameters()).device
    rows = []
    for fi in frames:
        fr = scene.slice_at(fi)
        if hasattr(renderer, "set_frame"):
            renderer.set_frame(fi)
        for lid in loader.lidar_ids:
            ld = loader.lidars.get((lid, fi))
            if ld is None:
                continue
            valid_gt = ld["ranges"] > 0
            ro, rd = lidar_rays_to_world(fr, lid, torch.from_numpy(ld["rays_o"]).to(dev),
                                         torch.from_numpy(ld["rays_d"]).to(dev))
            ro, rd = ro.contiguous(), rd.contiguous()
            qo = {"forward_inv_s": forward_inv_s} if forward_inv_s else {}
            r = renderer.ray_query(params, ro, rd, with_rgb=False, only_cr=True,
                                   occ_states=occ, query_overrides=qo)
            depth = r["depth_volume"].cpu().numpy()
            hit = (r["mask_volume"].cpu().numpy() > pred_mask) & valid_gt
            if hit.sum() < 10:
                continue
            ro_np, rd_np = ro.cpu().numpy(), rd.cpu().numpy()
            pd_r = depth[hit]
            err = pd_r - ld["ranges"][hit]
            n_valid = int(valid_gt.sum())
            row = {"frame": fi, "lidar": lid,
                   "rmse": float(np.sqrt(np.mean(err ** 2))),
                   "mae": float(np.mean(np.abs(err))),
                   "hit_recall": float(hit.sum() / max(n_valid, 1)),
                   "hit_frac": float(hit.mean()),
                   "no_return_frac": float(1.0 - valid_gt.mean())}
            miss = valid_gt & ~hit
            if cr_aabb is not None and miss.any():
                pts_miss = ro_np[miss] + ld["ranges"][miss][:, None] * rd_np[miss]
                lo, hi = np.asarray(cr_aabb[0]), np.asarray(cr_aabb[1])
                in_box = np.all((pts_miss >= lo) & (pts_miss <= hi), axis=-1)
                row["miss_in_cuboid_frac"] = float(in_box.sum() / max(n_valid, 1))
                row["miss_out_cuboid_frac"] = float((~in_box).sum() / max(n_valid, 1))
            pts_gt = torch.from_numpy(ro_np[valid_gt] + ld["ranges"][valid_gt][:, None]
                                      * rd_np[valid_gt]).to(dev)
            pts_pd = torch.from_numpy(ro_np[hit] + pd_r[:, None] * rd_np[hit]).to(dev)
            for trim, suffix in _TRIMS:
                a2b, b2a = chamfer_distance(pts_pd, pts_gt, trim_quantile=trim)
                row[f"chamfer_pred{suffix}"] = float(a2b)
                row[f"chamfer_gt{suffix}"] = float(b2a)
                row[f"chamfer{suffix}"] = float(a2b + b2a) / 2
            rows.append(row)

    agg = {}
    keys = set().union(*(r.keys() for r in rows)) if rows else set()
    for k in sorted(keys - {"frame", "lidar"}):
        agg[k] = float(np.mean([r[k] for r in rows if k in r]))
    return {"per_frame": rows, "mean": agg}


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Score the LiDAR of the run of ``resume_dir`` (or ``exp_dir``) with the
    ``eval`` block {frames, forward_inv_s, pred_mask} and write
    ``<exp>/eval/lidar_metrics.json``. Returns :func:`eval_lidar_frames`'s
    result."""
    cfg = copy.deepcopy(resolve_refs(cfg))
    cfg.setdefault("training", {})["with_lidar"] = True
    cr_aabb = None
    if cfg.get("renderer", {}).get("type") == "multi":
        scene, renderer, params, occ, loader, exp_dir = load_for_eval(cfg, device)
        cr_id = renderer.scene_models["cr"][0] if "cr" in renderer.scene_models else None
        renderer = ComposeLidarAdapter(scene, renderer)
    else:
        scene, renderer, params, occ, loader, exp_dir = load_single_for_eval(cfg, device)
        cr_id = renderer.pkey("cr")
    if cr_id is not None:
        space = params[cr_id].space
        cr_aabb = (space.aabb_min.cpu().numpy(), space.aabb_max.cpu().numpy())
    ecfg = cfg.get("eval", {})
    fis = ecfg.get("forward_inv_s")
    out = eval_lidar_frames(scene, renderer, params, loader,
                            frames=eval_frames(ecfg, scene.n_frames), occ=occ,
                            forward_inv_s=float(fis) if fis else None,
                            pred_mask=float(ecfg.get("pred_mask", 0.5)), cr_aabb=cr_aabb)
    os.makedirs(os.path.join(exp_dir, "eval"), exist_ok=True)
    with open(os.path.join(exp_dir, "eval", "lidar_metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["mean"]), flush=True)
    return out


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch eval_lidar").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
