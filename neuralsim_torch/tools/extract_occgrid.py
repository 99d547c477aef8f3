"""Export the voxels the close range's surface passes through (port of
neuralsim_tpu/tools/extract_occgrid.py:15-61).

    from neuralsim_torch.tools.extract_occgrid import main
    main(["--resume_dir", "logs/waymo_streetsurf", "--res=128"])        # on the card

or ``python -m neuralsim_torch.tools.extract_occgrid --resume_dir <exp>
[--renderer.type=multi] [--res=128] [--out=<grid.npz>] [--device=cpu]``. The
close range's SDF (the street of a multi-object config) is queried on the
card at the centres of a ``res``³ grid over its box, in chunks of 65,536
points; a voxel whose |sdf| is below half its diagonal is occupied. The npz
(default ``<exp>/occgrid_res<res>.npz``) holds the JAX tool's keys:
``occ_corners`` [M, 3] int32, ``sidelength``, ``aabb_min``, ``aabb_max``,
``voxel_size`` and ``occ_thresh``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ..config import BaseConfig
from ..configs import resolve_refs
from .extract_mesh import close_range_box, close_range_sdf
from .render import load_render

CHUNK = 65536


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Export the occupied voxels of the run of ``resume_dir`` (or
    ``exp_dir``) -> {path, occ_corners}."""
    cfg = resolve_refs(cfg)
    run = load_render(cfg, device)
    sdf, (mn, mx) = close_range_sdf(run.params, run.cr_id), close_range_box(run.params, run.cr_id)
    res = int(cfg.get("res", 128))
    voxel = (mx - mn) / res
    thresh = float(np.linalg.norm(voxel)) * 0.5
    xs = [np.linspace(mn[i] + voxel[i] / 2, mx[i] - voxel[i] / 2, res) for i in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    vals = np.empty(pts.shape[0], np.float32)
    for i in range(0, pts.shape[0], CHUNK):
        vals[i:i + CHUNK] = sdf(pts[i:i + CHUNK])
    occ = np.abs(vals) < thresh
    coords = np.stack(np.unravel_index(np.nonzero(occ)[0], (res, res, res)), -1)
    out = cfg.get("out", os.path.join(run.exp_dir, f"occgrid_res{res}.npz"))
    np.savez_compressed(out, occ_corners=coords.astype(np.int32),
                        sidelength=np.array([res] * 3, np.int32), aabb_min=mn, aabb_max=mx,
                        voxel_size=voxel, occ_thresh=thresh)
    print(f"occgrid: {coords.shape[0]} occupied voxels / {res ** 3} -> {out}", flush=True)
    return {"path": out, "occ_corners": coords.astype(np.int32)}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch extract_occgrid").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
