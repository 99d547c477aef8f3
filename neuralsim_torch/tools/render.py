"""Render a trained run: the recorded camera track (``replay``) or an
orthographic map from above (``topdown``), for single-scene and
multi-object configs (port of neuralsim_tpu/tools/render.py:70-92, 140-201,
230-333, 373-423).

    from neuralsim_torch.tools.render import main
    main(["--resume_dir", "logs/waymo_demo_multi", "--renderer.type=multi",
          "--render.mode=topdown", "--render.topdown_w=256"])          # on the card

or ``python -m neuralsim_torch.tools.render --resume_dir <exp> [--renderer.type=multi]
[--render.mode=replay|topdown] [--render.frames=0,4] [--render.downscale=2]
[--render.video=false] [--device=cpu]``. The checkpoint ``ckpt`` (default the
newest) of ``resume_dir`` (or ``exp_dir``) is restored with its iteration
stamped on the fields; a multi-object config (``renderer.type: multi``) is
rendered by its compose renderer frozen at each frame, a single-scene one by
the single-volume renderer. Frames go to ``<exp>/render_<mode>/``:

- ``replay``: camera ``render.cam_id`` (default the first) at every
  ``render.downscale``-th pixel (default 2), ``rgb_<frame>.png`` and
  ``depth_<frame>.png`` (``utils.logger.color_depth``); a time-conditioned
  close range (EmerNeRF's) is rendered at the frame's time and also writes
  its decomposition, ``flow_fwd``/``flow_bwd`` (``utils.logger.scene_flow_to_rgb``
  up to ``render.flow_max_radius``, default 0.5), ``rgb_static``/``rgb_dynamic``
  and ``mask_static``/``mask_dynamic``, each ``<channel>_<frame>.png``;
- ``topdown``: parallel rays straight down over the close-range box's x-y
  footprint (or ``render.extent`` [[x0, y0], [x1, y1]] from
  ``render.altitude``), ``render.topdown_w`` pixels wide (default 320),
  ``rgb_<frame>.png`` and ``height_<frame>.png``.

With ``render.video`` (default true) the rgb frames are stitched by
:func:`assemble_video`. The modes ``nvs`` and ``lidar`` and the options
``mesh_overlay``, ``anim`` and ``data_parallel`` are not ported (each raises,
naming itself); ``per_obj`` is read by neither package.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import BaseConfig
from ..configs import resolve_refs
from ..scene.observers import camera_get_selected_rays
from ..scene.observers.extra_cameras import ortho_get_rays
from ..utils.logger import _write_png, color_depth, scene_flow_to_rgb
from .eval import load_single_for_eval
from .eval_multi import load_for_eval

_NOT_PORTED_MODES = ("nvs", "lidar")
_NOT_PORTED_OPTIONS = ("mesh_overlay", "anim", "data_parallel")


def assemble_video(out_dir: str, pattern: str = "rgb_", fps: int = 12,
                   name: str = "video") -> Optional[str]:
    """Stitch the rendered frames ``<pattern>*.png`` of ``out_dir`` into an
    animated GIF with Pillow. Returns its path, or None without frames."""
    from PIL import Image
    frames = sorted(p for p in os.listdir(out_dir) if p.startswith(pattern) and p.endswith(".png"))
    if not frames:
        return None
    imgs = [Image.open(os.path.join(out_dir, p)) for p in frames]
    path = os.path.join(out_dir, f"{name}.gif")
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return path


def _u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@torch.no_grad()
def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Render the run of ``resume_dir`` (or ``exp_dir``) with the ``render``
    block. Returns {out_dir, frames, video}."""
    cfg = resolve_refs(cfg)
    rcfg = cfg.get("render", {})
    mode = rcfg.get("mode", "replay")
    if mode in _NOT_PORTED_MODES:
        raise NotImplementedError(f"render mode {mode} is not ported")
    if mode not in ("replay", "topdown"):
        raise ValueError(mode)
    for name in _NOT_PORTED_OPTIONS:
        if rcfg.get(name):
            raise NotImplementedError(f"render.{name} is not ported")
    multi = cfg.get("renderer", {}).get("type") == "multi"
    if multi:
        scene, renderer, params, occ, loader, exp_dir = load_for_eval(cfg, device)
        cr_id = renderer.scene_models["cr"][0] if "cr" in renderer.scene_models else None
    else:
        scene, renderer, params, occ, loader, exp_dir = load_single_for_eval(cfg, device)
        cr_id = renderer.pkey("cr")
    dev = next(params.parameters()).device
    out_dir = os.path.join(exp_dir, f"render_{mode}")
    os.makedirs(out_dir, exist_ok=True)
    rayschunk = int(rcfg.get("rayschunk", 4096))
    frames = rcfg.get("frames")
    if isinstance(frames, str):
        frames = [int(x) for x in frames.split(",")]
    elif isinstance(frames, int):
        frames = [frames]           # "--render.frames=0" parses as an int
    frames = frames or list(range(scene.n_frames))

    # a time-conditioned close range is rendered at the frame's time
    timed = not multi and getattr(params[cr_id], "use_time", False) and scene.n_frames > 1

    def render(ro, rd, fi):
        # the compose renderer takes the scene frozen at the frame
        at = (scene.slice_at(fi),) if multi else ()
        kw = {"cond": torch.full((1, 1), fi / (scene.n_frames - 1), device=dev)} if timed else {}
        return renderer.render_chunked(params, *at, ro.contiguous(), rd.contiguous(),
                                       rayschunk=rayschunk, occ_states=occ, **kw)

    def write_extra_channels(r, fi, h, w):
        """EmerNeRF's decomposition and flow channels, where the render has them."""
        for k in ("flow_fwd", "flow_bwd"):
            if k in r:
                im = scene_flow_to_rgb(r[k].cpu().numpy().reshape(h, w, 3),
                                       flow_max_radius=float(rcfg.get("flow_max_radius", 0.5)))
                _write_png(os.path.join(out_dir, f"{k}_{fi:04d}.png"), (im * 255).astype(np.uint8))
        for k, shape in (("rgb_static", (h, w, 3)), ("rgb_dynamic", (h, w, 3)),
                         ("mask_static", (h, w)), ("mask_dynamic", (h, w))):
            if k in r:
                _write_png(os.path.join(out_dir, f"{k}_{fi:04d}.png"),
                           _u8(r[k].cpu().numpy().reshape(shape)))

    if mode == "replay":
        cam_id = rcfg.get("cam_id", loader.cam_ids[0])
        W, H = loader.image_wh(cam_id)
        ds = int(rcfg.get("downscale", 2))
        Hs, Ws = H // ds, W // ds
        ys, xs = np.meshgrid(np.arange(Hs), np.arange(Ws), indexing="ij")
        xy = torch.from_numpy(np.stack([xs * ds + 0.5 * ds, ys * ds + 0.5 * ds], -1)
                              .reshape(-1, 2).astype(np.float32)).to(dev)
        for fi in frames:
            ro, rd = camera_get_selected_rays(scene.slice_at(fi), cam_id, xy)
            r = render(ro, rd, fi)
            write_extra_channels(r, fi, Hs, Ws)
            _write_png(os.path.join(out_dir, f"rgb_{fi:04d}.png"),
                       _u8(r["rgb_volume"].cpu().numpy().reshape(Hs, Ws, 3)))
            _write_png(os.path.join(out_dir, f"depth_{fi:04d}.png"),
                       _u8(color_depth(r["depth_volume"].cpu().numpy().reshape(Hs, Ws))))
        size = (Ws, Hs)
    else:
        if rcfg.get("extent"):
            (x0, y0), (x1, y1) = rcfg["extent"]
            z_top = float(rcfg.get("altitude", 50.0))
        elif cr_id is not None:
            mn = params[cr_id].space.aabb_min.cpu().numpy()
            mx = params[cr_id].space.aabb_max.cpu().numpy()
            x0, y0, x1, y1 = float(mn[0]), float(mn[1]), float(mx[0]), float(mx[1])
            z_top = float(mx[2]) + 0.25 * float(mx[2] - mn[2]) + 1.0
        else:
            raise ValueError("topdown needs a close-range model with a space, or "
                             "render.extent=[[x0,y0],[x1,y1]]")
        Wt = int(rcfg.get("topdown_w", 320))
        Ht = max(int(round(Wt * (y1 - y0) / max(x1 - x0, 1e-6))), 8)
        # the camera's axes in the world: x = +x, y = -y, z = -z (looking down)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        c2w[:3, 3] = [0.5 * (x0 + x1), 0.5 * (y0 + y1), z_top]
        ys, xs = np.meshgrid(np.arange(Ht) + 0.5, np.arange(Wt) + 0.5, indexing="ij")
        xy = torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)).to(dev)
        ro, rd = ortho_get_rays(xy, torch.from_numpy(c2w).to(dev), width=x1 - x0,
                                height=y1 - y0, W=Wt, H=Ht)
        for fi in frames:
            r = render(ro, rd, fi)
            _write_png(os.path.join(out_dir, f"rgb_{fi:04d}.png"),
                       _u8(r["rgb_volume"].cpu().numpy().reshape(Ht, Wt, 3)))
            # the height map: z = z_top - depth (the rays are unit -z)
            height = z_top - r["depth_volume"].cpu().numpy().reshape(Ht, Wt)
            _write_png(os.path.join(out_dir, f"height_{fi:04d}.png"), _u8(color_depth(height)))
        size = (Wt, Ht)
    video = assemble_video(out_dir, "rgb_", int(rcfg.get("fps", 12))) \
        if rcfg.get("video", True) else None
    if video:
        print(f"video -> {video}", flush=True)
    print(f"{mode}: {len(frames)} frames ({size[0]}x{size[1]}) -> {out_dir}", flush=True)
    return {"out_dir": out_dir, "frames": frames, "video": video}


def main(argv=None, device: str = "cuda") -> Dict[str, Any]:
    """The command line (``config.BaseConfig``): ``--resume_dir`` (whose
    ``config.json`` is read without ``--config``), dot overrides,
    ``--device=cpu``."""
    cfg = BaseConfig("neuralsim_torch render").parse(argv)
    return main_function(cfg, device=cfg.pop("device", device))


if __name__ == "__main__":
    main()
