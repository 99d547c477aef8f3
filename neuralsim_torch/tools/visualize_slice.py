"""Axis-aligned cross-sections of the close range's SDF as images (port of
neuralsim_tpu/tools/visualize_slice.py:14-78).

    from neuralsim_torch.tools.visualize_slice import main
    main(["--resume_dir", "logs/waymo_streetsurf"])                     # on the card

or ``python -m neuralsim_torch.tools.visualize_slice --resume_dir <exp>
[--renderer.type=multi] [--slice.res=256] [--device=cpu]``. Nine slices, at a
quarter, a half and three quarters of the box along each axis, each
``slice.res``² points queried on the card in one call and coloured by
:func:`sdf_slice_image` (outside red, inside blue, the zero level set
white), to ``<exp>/slices/axis<a>_<frac>.png``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ..config import BaseConfig
from ..configs import resolve_refs
from ..utils.logger import _write_png
from .extract_mesh import close_range_box, close_range_sdf
from .render import load_render


def sdf_slice_image(sdf_fn, aabb_min, aabb_max, *, axis: int = 2, coord: float = 0.0,
                    res: int = 256) -> np.ndarray:
    """[res, res, 3] image of the slice ``axis = coord`` of ``sdf_fn``
    (points [P, 3] -> [P]): tanh(sdf / (2 mean |sdf|)) in red outside and
    blue inside, green 0.2, white where |sdf| is below 2% of that scale."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    axes = [i for i in range(3) if i != axis]
    u = np.linspace(aabb_min[axes[0]], aabb_max[axes[0]], res)
    v = np.linspace(aabb_min[axes[1]], aabb_max[axes[1]], res)
    U, V = np.meshgrid(u, v)
    pts = np.zeros((res * res, 3), np.float32)
    pts[:, axes[0]] = U.ravel()
    pts[:, axes[1]] = V.ravel()
    pts[:, axis] = coord
    sdf = np.asarray(sdf_fn(pts)).reshape(res, res)

    scale = float(np.abs(sdf).mean()) * 2 + 1e-6
    t = np.tanh(sdf / scale)
    img = np.zeros((res, res, 3), np.float32)
    img[..., 0] = np.clip(t, 0, 1)
    img[..., 2] = np.clip(-t, 0, 1)
    img[..., 1] = 0.2
    img[np.abs(sdf) < scale * 0.02] = 1.0
    return img


def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Write the slices of the run of ``resume_dir`` (or ``exp_dir``) ->
    {out_dir, files}."""
    cfg = resolve_refs(cfg)
    run = load_render(cfg, device)
    sdf, (mn, mx) = close_range_sdf(run.params, run.cr_id), close_range_box(run.params, run.cr_id)
    out_dir = os.path.join(run.exp_dir, "slices")
    os.makedirs(out_dir, exist_ok=True)
    res = int(cfg.get("slice", {}).get("res", 256))
    files = []
    for axis in (0, 1, 2):
        for frac in (0.25, 0.5, 0.75):
            coord = float(mn[axis] + (mx[axis] - mn[axis]) * frac)
            img = sdf_slice_image(sdf, mn, mx, axis=axis, coord=coord, res=res)
            files.append(os.path.join(out_dir, f"axis{axis}_{frac:.2f}.png"))
            _write_png(files[-1], (img * 255).astype(np.uint8))
    print(f"slices -> {out_dir}", flush=True)
    return {"out_dir": out_dir, "files": files}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch visualize_slice").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
