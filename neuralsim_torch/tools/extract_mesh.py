"""Extract the close range's surface as a mesh (port of
neuralsim_tpu/tools/extract_mesh.py:13-61).

    from neuralsim_torch.tools.extract_mesh import main
    main(["--resume_dir", "logs/waymo_streetsurf", "--res=256"])        # on the card

or ``python -m neuralsim_torch.tools.extract_mesh --resume_dir <exp>
[--renderer.type=multi] [--res=128] [--level=0.0] [--visible_grid=<grid.npz>]
[--out=<mesh.ply>] [--device=cpu]``. The close range's SDF (the street of a
multi-object config) is queried on the card on a ``res``³ grid over its box,
in chunks of 65,536 points (``graphics.extract_mesh``); the ``level`` set is
extracted on the host by marching tetrahedra and written as a binary PLY,
by default ``<exp>/mesh_res<res>.ply``. With ``visible_grid`` (a
``tools/extract_visible_grid.py`` npz) a point outside the visible voxels is
pushed outside the level set (|sdf| + 1000). The checkpoint ``ckpt``
(default the newest) of ``resume_dir`` (or ``exp_dir``) is restored with its
iteration stamped on the fields.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..graphics import export_mesh_ply, extract_mesh
from ..models.misc_assets import VisibleGrid
from .render import load_render


def close_range_sdf(params, cr_id: str) -> Callable[[np.ndarray], np.ndarray]:
    """points [P, 3] (numpy) -> the close range's SDF [P] (numpy), queried on
    the parameters' device without autograd."""
    field = params[cr_id]
    dev = next(field.parameters()).device

    @torch.no_grad()
    def sdf(pts: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        return field.query_sdf(x).cpu().numpy()
    return sdf


def close_range_box(params, cr_id: str):
    """The close range's box (min, max) [3] as numpy."""
    space = params[cr_id].space
    return space.aabb_min.cpu().numpy(), space.aabb_max.cpu().numpy()


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Extract the mesh of the run of ``resume_dir`` (or ``exp_dir``) ->
    {path, verts [V, 3], faces [F, 3]}."""
    cfg = resolve_refs(cfg)
    run = load_render(cfg, device)
    sdf, (mn, mx) = close_range_sdf(run.params, run.cr_id), close_range_box(run.params, run.cr_id)
    res = int(cfg.get("res", 128))
    level = float(cfg.get("level", 0.0))
    vg = VisibleGrid.load(cfg["visible_grid"]) if cfg.get("visible_grid") else None

    def sdf_fn(pts):
        vals = sdf(pts)
        if vg is not None:
            vals = np.where(vg.contains(pts), vals, np.abs(vals) + 1e3)
        return vals

    verts, faces = extract_mesh(sdf_fn, aabb_min=mn, aabb_max=mx, resolution=res, level=level)
    out = cfg.get("out", os.path.join(run.exp_dir, f"mesh_res{res}.ply"))
    export_mesh_ply(out, verts, faces)
    print(f"mesh: {verts.shape[0]} verts, {faces.shape[0]} faces -> {out}", flush=True)
    return {"path": out, "verts": verts, "faces": faces}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch extract_mesh").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
