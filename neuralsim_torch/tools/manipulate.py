"""Edit a multi-object scene and render the edit (port of
neuralsim_tpu/tools/manipulate.py:25-153).

    from neuralsim_torch.tools.manipulate import main
    main(["--resume_dir", "logs/waymo_demo_multi", "--manipulate.mode=rotate",
          "--manipulate.angle=1.2"])                                    # on the card

or ``python -m neuralsim_torch.tools.manipulate --resume_dir <exp>
[--manipulate.mode=rotate|translate|scale|thanos|delete] [--manipulate.node=veh_0]
[--manipulate.frame=0] [--manipulate.downscale=2] [--device=cpu]``.

The edits are functions of a frozen scene that return another, the input
left as it was: ``rotate_object`` (about the node's own ``axis``, x, y or
z), ``translate_object`` (an offset in the world), ``scale_object`` (the
node's scale), ``delete_objects`` (its ``valid`` cleared, so the compose
renderer drops it), ``thanos`` (half of the drawables, picked by
``rng.choice`` without replacement) and ``replicate_object`` (a moved copy's
world transform and data, for a caller to bind). An edit changes only the
node's own world transform: its children keep the ones they were frozen
with, as in the JAX package.

:func:`main_function` restores the checkpoint ``ckpt`` (default the newest)
of ``resume_dir`` (or ``exp_dir``) with its iteration stamped on the fields,
freezes the scene at ``manipulate.frame``, edits ``manipulate.node``
(default the first drawable; ``delete`` takes ``manipulate.nodes``, by
default that node; ``thanos`` draws from ``seed``), and renders the first
camera at every ``manipulate.downscale``-th pixel in one query (the street
from its uniform ladder: the JAX tool hands no grid state to the renderer)
to ``<exp>/manipulate/<mode>_<node>_<frame>.png``. Another mode renders the
frame unedited, as in the JAX tool.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..maths.transforms import compose_transforms, make_transform
from ..scene.observers import camera_get_selected_rays
from ..scene.scene import FrozenScene
from ..utils.logger import _write_png
from .eval_multi import load_for_eval
from .render import pixel_centres


def _copy(frozen: FrozenScene) -> FrozenScene:
    out = FrozenScene.__new__(FrozenScene)
    out.scene = frozen.scene
    out.node_data = list(frozen.node_data)
    out.world = list(frozen.world)
    return out


def _edit_world(frozen: FrozenScene, node_id: str, fn) -> FrozenScene:
    idx = frozen.scene.nodes[node_id].index
    out = _copy(frozen)
    out.world[idx] = fn(out.world[idx])
    return out


def rotate_object(frozen: FrozenScene, node_id: str, angle_rad: float,
                  axis: str = "z") -> FrozenScene:
    """The node turned by ``angle_rad`` about its own ``axis``."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    R = {"z": [[c, -s, 0], [s, c, 0], [0, 0, 1]],
         "y": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
         "x": [[1, 0, 0], [0, c, -s], [0, s, c]]}[axis]

    def fn(T):
        Rm = make_transform(torch.tensor(R, dtype=torch.float32, device=T.device))
        return compose_transforms(T, Rm)
    return _edit_world(frozen, node_id, fn)


def _shifted(T: torch.Tensor, offset) -> torch.Tensor:
    T = T.clone()
    T[..., :3, 3] += torch.as_tensor(offset, dtype=torch.float32, device=T.device)
    return T


def translate_object(frozen: FrozenScene, node_id: str, offset) -> FrozenScene:
    """The node moved by ``offset`` [3] in the world."""
    return _edit_world(frozen, node_id, lambda T: _shifted(T, offset))


def scale_object(frozen: FrozenScene, node_id: str, factor: float) -> FrozenScene:
    """The node's scale times ``factor``."""
    idx = frozen.scene.nodes[node_id].index
    out = _copy(frozen)
    d = dict(out.node_data[idx])
    d["scale"] = d["scale"] * factor
    out.node_data[idx] = d
    return out


def delete_objects(frozen: FrozenScene, node_ids: List[str]) -> FrozenScene:
    """The nodes marked invalid (the renderer drops their samples)."""
    out = _copy(frozen)
    for nid in node_ids:
        idx = frozen.scene.nodes[nid].index
        d = dict(out.node_data[idx])
        d["valid"] = torch.zeros_like(torch.as_tensor(d["valid"]))
        out.node_data[idx] = d
    return out


def thanos(frozen: FrozenScene, rng: np.random.Generator) -> FrozenScene:
    """Half of the drawables (``len // 2``, drawn by ``rng.choice`` without
    replacement) deleted."""
    ids = frozen.scene.drawable_ids()
    return delete_objects(frozen, [str(i) for i in rng.choice(ids, size=len(ids) // 2,
                                                               replace=False)])


def replicate_object(frozen: FrozenScene, node_id: str, offset):
    """A copy of the node moved by ``offset``: (its world transform, its
    data), for a caller to bind as another object."""
    idx = frozen.scene.nodes[node_id].index
    return _shifted(frozen.world[idx], offset), frozen.node_data[idx]


def edit(frozen: FrozenScene, mcfg: Dict[str, Any], target: str, seed: int) -> FrozenScene:
    """The ``manipulate`` block's edit of ``target`` (see the module)."""
    mode = mcfg.get("mode", "rotate")
    if mode == "rotate":
        return rotate_object(frozen, target, float(mcfg.get("angle", 0.7)))
    if mode == "translate":
        return translate_object(frozen, target, mcfg.get("offset", [1, 0, 0]))
    if mode == "scale":
        return scale_object(frozen, target, float(mcfg.get("factor", 1.5)))
    if mode == "thanos":
        return thanos(frozen, np.random.default_rng(seed))
    if mode == "delete":
        return delete_objects(frozen, mcfg.get("nodes", [target]))
    return frozen


@torch.no_grad()
def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Edit and render the run of ``resume_dir`` (or ``exp_dir``) with the
    ``manipulate`` block -> {path, rgb (the frame [H, W, 3])}."""
    cfg = resolve_refs(cfg)
    scene, renderer, params, _, loader, exp_dir = load_for_eval(cfg, device)
    dev = next(params.parameters()).device
    mcfg = cfg.get("manipulate", {})
    mode = mcfg.get("mode", "rotate")
    fi = int(mcfg.get("frame", 0))
    target = mcfg.get("node") or scene.drawable_ids()[0]
    frozen = edit(scene.slice_at(fi), mcfg, target, int(cfg.get("seed", 42)))

    cam_id = loader.cam_ids[0]
    W, H = loader.image_wh(cam_id)
    ds = int(mcfg.get("downscale", 2))
    ro, rd = camera_get_selected_rays(frozen, cam_id, pixel_centres(W, H, ds, dev))
    out = renderer.ray_query(params, frozen, ro.contiguous(), rd.contiguous())
    rgb = out["rgb_volume"].cpu().numpy().reshape(H // ds, W // ds, 3)
    out_dir = os.path.join(exp_dir, "manipulate")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{mode}_{target}_{fi:04d}.png")
    _write_png(path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    print(f"manipulated render -> {path}", flush=True)
    return {"path": path, "rgb": rgb}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch manipulate").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
