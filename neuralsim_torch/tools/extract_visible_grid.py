"""Voxelise what the scene's observers see into a visible grid (port of
neuralsim_tpu/tools/extract_visible_grid.py:23-111).

    from neuralsim_torch.tools.extract_visible_grid import main
    main(["--resume_dir", "logs/waymo_streetsurf", "--grid.source=lidar_gt"])  # on the card

or ``python -m neuralsim_torch.tools.extract_visible_grid --resume_dir <exp>
[--renderer.type=multi] [--grid.source=camera|lidar_gt] [--grid.res=128]
[--grid.morphology=close|close2|dilation] [--grid.frames=0,4] [--device=cpu]``.

A ``models.misc_assets.VisibleGrid`` of ``grid.res``³ over the close
range's box (the street of a multi-object config) takes, at each frame of
``grid.frames`` (default all):
- ``lidar_gt``: every LiDAR's recorded returns (range > 0) in the world;
- ``camera``: each camera of ``grid.cam_ids`` (default all) rendered at
  every ``grid.downscale``-th pixel (default 4) in chunks of
  ``grid.rayschunk`` (8,192), its depth back-projected where the mask is
  above 0.5 (and the depth below ``grid.depth_max``, where set). As in the
  JAX tool the close range's samples come from its occupancy grid's initial
  state, not the checkpoint's (that tool reads the grid of the state it
  built before restoring); a multi-object scene is frozen at the frame.
Then the morphology (``grid.morphology``, default ``close``) and the npz,
by default ``<exp>/visible_grid_res<res>.npz``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..models.misc_assets import VisibleGrid
from ..scene.observers import camera_get_selected_rays
from .extract_mesh import close_range_box
from .render import frames_of, load_render, pixel_centres


@torch.no_grad()
def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Extract the visible grid of the run of ``resume_dir`` (or ``exp_dir``)
    -> {path, voxels (before the morphology), grid (the VisibleGrid)}."""
    cfg = resolve_refs(cfg)
    multi, scene, renderer, params, _, loader, exp_dir, cr_id = load_render(cfg, device)
    dev = next(params.parameters()).device
    gcfg = cfg.get("grid", {})
    source = gcfg.get("source", "camera")
    res = int(gcfg.get("res", 128))
    downscale = int(gcfg.get("downscale", 4))
    depth_max = float(gcfg.get("depth_max", 0.0))
    morphology = gcfg.get("morphology", "close")
    vg = VisibleGrid(*close_range_box(params, cr_id), resolution=res)
    fis = frames_of(gcfg, scene.n_frames)

    if source == "lidar_gt":
        for fi in fis:
            fr = scene.slice_at(fi)
            for lid in loader.lidar_ids:
                ld = loader.lidars.get((lid, fi))
                if ld is None:
                    continue
                keep = ld["ranges"] > 0
                l2w = fr.world_transform(lid).cpu().numpy()
                pts_l = ld["rays_o"][keep] + ld["ranges"][keep][:, None] * ld["rays_d"][keep]
                vg.add_points(pts_l @ l2w[:3, :3].T + l2w[:3, 3])
    else:
        occ = {role: accel.init_state() for role, accel in renderer.accels.items()}
        cam_ids = gcfg.get("cam_ids") or loader.cam_ids
        if isinstance(cam_ids, str):
            cam_ids = cam_ids.split(",")
        for fi in fis:
            fr = scene.slice_at(fi)
            for cid in cam_ids:
                ro, rd = camera_get_selected_rays(fr, cid,
                                                  pixel_centres(*loader.image_wh(cid), downscale, dev))
                at = (fr,) if multi else ()
                r = renderer.render_chunked(params, *at, ro.contiguous(), rd.contiguous(),
                                            rayschunk=int(gcfg.get("rayschunk", 8192)),
                                            occ_states=occ)
                depth = r["depth_volume"].cpu().numpy().reshape(-1)
                mask = r["mask_volume"].cpu().numpy().reshape(-1) > 0.5
                if depth_max > 0:
                    mask &= depth < depth_max
                vg.add_depth_points(ro.cpu().numpy(), rd.cpu().numpy(), depth, mask)

    n_before = int(vg.grid.sum())
    vg.postprocess(morphology)
    out = gcfg.get("out", os.path.join(exp_dir, f"visible_grid_res{res}.npz"))
    vg.save(out)
    print(f"visible grid: {n_before} voxels -> {int(vg.grid.sum())} after {morphology} "
          f"({len(fis)} frames, source={source}) -> {out}", flush=True)
    return {"path": out, "voxels": n_before, "grid": vg}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch extract_visible_grid").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
