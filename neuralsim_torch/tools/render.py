"""Render a trained run: the recorded camera track (``replay``), an
orthographic map from above (``topdown``), a camera off the track (``nvs``)
or a simulated LiDAR (``lidar``), for single-scene and multi-object configs,
with the scene's trajectories edited first where ``render.anim`` asks (port
of neuralsim_tpu/tools/render.py).

    from neuralsim_torch.tools.render import main
    main(["--resume_dir", "logs/waymo_demo_multi", "--renderer.type=multi",
          "--render.mode=lidar", "--render.lidar_model=pandar64"])     # on the card

or ``python -m neuralsim_torch.tools.render --resume_dir <exp> [--renderer.type=multi]
[--render.mode=replay|topdown|nvs|lidar] [--render.frames=0,4] [--render.downscale=2]
[--render.anim=reverse_ego|<trajectories.npz>] [--render.video=false] [--device=cpu]``.
The checkpoint ``ckpt`` (default the newest) of ``resume_dir`` (or
``exp_dir``) is restored with its iteration stamped on the fields; a
multi-object config (``renderer.type: multi``) is rendered by its compose
renderer with the scene frozen at a frame, a single-scene one by the
single-volume renderer. Frames go to ``<exp>/render_<mode>/`` (with
``render.anim``, ``<exp>/render_<mode>_anim/``):

- ``replay``: camera ``render.cam_id`` (default the first) at every
  ``render.downscale``-th pixel (default 2), ``rgb_<frame>.png`` and
  ``depth_<frame>.png`` (``utils.logger.color_depth``); a time-conditioned
  close range (EmerNeRF's) is rendered at the frame's time and also writes
  its decomposition, ``flow_fwd``/``flow_bwd`` (``utils.logger.scene_flow_to_rgb``
  up to ``render.flow_max_radius``, default 0.5), ``rgb_static``/``rgb_dynamic``
  and ``mask_static``/``mask_dynamic``, each ``<channel>_<frame>.png``. With
  ``render.mesh_overlay`` (a PLY of ``tools/extract_mesh.py``) the mesh is
  splatted over each rgb frame (:func:`overlay_mesh`, ``render.mesh_alpha``
  0.5);
- ``topdown``: parallel rays straight down over the close-range box's x-y
  footprint (or ``render.extent`` [[x0, y0], [x1, y1]] from
  ``render.altitude``), ``render.topdown_w`` pixels wide (default 320),
  ``rgb_<frame>.png`` and ``height_<frame>.png``;
- ``nvs``: ``render.n_frames`` (24) poses of the camera along
  ``render.path``: ``spherical_spiral`` around ``render.center`` at
  ``render.radius`` (2.0), ``small_circle`` around the camera's first pose
  (``render.radius`` 0.2), ``street_view`` along its world track shifted by
  ``render.shift_l`` / ``shift_v`` and pitched down ``render.pitch_deg``, or
  (any other name) ``interpolation`` along its track; the first three read
  the camera node's own transforms, relative to its parent, as the JAX
  package does. ``rgb_<i>.png``; a multi-object scene is frozen at frame 0;
- ``lidar``: the street alone (no rgb, the deterministic query at
  ``render.lidar_forward_inv_s``, 256) along the beams of each frame: the
  first LiDAR's recorded beams (``render.lidar_model`` ``original``, a frame
  without them skipped) or a synthetic model
  (``scene.observers.lidars.make_lidar_generator`` with
  ``render.lidar_params``) mounted on ``render.mount_node`` (default the
  camera), in chunks of ``render.rayschunk`` beams. A beam whose mask is
  above 0.95 is a hit. ``lidar_<frame>.npz`` (depth, mask, rays_o, rays_d)
  and ``points.ply`` (every hit point). A multi-object scene is frozen at
  frame 0 for the query, the beams at their own frame.

With ``render.video`` (default true) the rgb frames are stitched by
:func:`assemble_video`. ``render.data_parallel`` is not ported (it raises,
naming itself); ``per_obj`` is read by neither package.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..anim import create_anim
from ..config import BaseConfig
from ..configs import resolve_refs
from ..dataio.synthetic import look_at
from ..graphics import export_pcl_ply, load_mesh_ply
from ..maths.transforms import make_transform, quat_slerp, quat_to_rot, rot_to_quat
from ..scene.observers import camera_get_selected_rays, lidar_rays_to_world, make_lidar_generator
from ..scene.observers.cameras_math import get_rays
from ..scene.observers.extra_cameras import ortho_get_rays
from ..utils.logger import _write_png, color_depth, scene_flow_to_rgb
from .eval import load_single_for_eval
from .eval_multi import load_for_eval

MODES = ("replay", "topdown", "nvs", "lidar")
_NOT_PORTED_OPTIONS = ("data_parallel",)
# a simulated beam is a hit where its rendered mask is above this
LIDAR_HIT = 0.95


# ---------------------------------------------------------------------------
# camera paths for novel views (numpy, c2w [n, 4, 4] in OpenCV's convention)
# ---------------------------------------------------------------------------

def get_path_spherical_spiral(center, radius: float, n_frames: int, *, up=(0, 0, 1),
                              n_rounds: float = 2.0, elev_range=(0.1, 0.7)) -> np.ndarray:
    """Poses on a spiral over the sphere of ``radius`` around ``center``,
    looking at it: ``n_rounds`` turns while the elevation rises over
    ``elev_range`` (radians). ``up`` is not read: the view's up is (0, 0, -1),
    as in the JAX package."""
    center = np.asarray(center, np.float64)
    out = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        az = 2 * np.pi * n_rounds * t
        el = elev_range[0] + (elev_range[1] - elev_range[0]) * t
        eye = center + radius * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                                          np.sin(el)])
        out.append(look_at(eye, center, up=(0.0, 0.0, -1.0)))
    return np.stack(out)


def get_path_small_circle(c2w0: np.ndarray, n_frames: int, radius: float = 0.2) -> np.ndarray:
    """The pose ``c2w0`` moved round a circle of ``radius`` in its own x-y
    plane, its rotation kept."""
    out = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        d = c2w0[:3, 0] * np.cos(a) * radius + c2w0[:3, 1] * np.sin(a) * radius
        T = c2w0.copy()
        T[:3, 3] = c2w0[:3, 3] + d
        out.append(T)
    return np.stack(out)


def get_path_street_view(c2ws: np.ndarray, n_frames: int, *, shift_l: float = 2.0,
                         shift_v: float = 1.0, pitch_deg: float = 10.0) -> np.ndarray:
    """Along the track ``c2ws`` (:func:`get_path_interpolation`), each pose
    moved ``shift_l`` to the camera's right and ``shift_v`` up, and pitched
    ``pitch_deg`` down towards the road."""
    base = get_path_interpolation(c2ws, n_frames)
    out = []
    s, c = np.sin(np.radians(pitch_deg)), np.cos(np.radians(pitch_deg))
    # OpenCV's camera: +x right, +y down, +z forward; pitching down turns the
    # forward axis towards +y
    Rp = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    for T in base:
        T = T.copy()
        T[:3, 3] = T[:3, 3] + T[:3, 0] * shift_l - T[:3, 1] * shift_v
        T[:3, :3] = T[:3, :3] @ Rp
        out.append(T)
    return np.asarray(out)


def get_path_interpolation(c2ws: np.ndarray, n_frames: int) -> np.ndarray:
    """``n_frames`` poses evenly along the track ``c2ws`` [T, 4, 4]: the
    rotation by slerp and the position by lerp between neighbouring poses
    (float32, ``maths.transforms``)."""
    T = c2ws.shape[0]
    ts = np.linspace(0, T - 1 - 1e-4, n_frames)
    lo = np.floor(ts).astype(int)
    w = ts - lo
    hi = np.minimum(lo + 1, T - 1)
    q = rot_to_quat(torch.from_numpy(np.ascontiguousarray(c2ws[:, :3, :3], np.float32)))
    qi = quat_slerp(q[torch.from_numpy(lo)], q[torch.from_numpy(hi)],
                    torch.from_numpy(w.astype(np.float32)))
    tr = c2ws[lo, :3, 3] * (1 - w[:, None]) + c2ws[hi, :3, 3] * w[:, None]
    return make_transform(quat_to_rot(qi), torch.from_numpy(tr.astype(np.float32))).numpy()


def overlay_mesh(rgb: np.ndarray, depth: Optional[np.ndarray], verts: np.ndarray,
                 faces: np.ndarray, intr: np.ndarray, c2w: np.ndarray, *, alpha: float = 0.5,
                 splat: int = 1) -> np.ndarray:
    """A shaded mesh blended over a rendered frame [H, W, 3]: each vertex in
    front of the camera splatted over (2 ``splat`` + 1)² pixels, far to near,
    where it is no deeper than the rendered ``depth`` (x 1.02 + 0.05), its
    shade from the vertex normals the faces give."""
    H, W = rgb.shape[:2]
    w2c = np.linalg.inv(c2w)
    vc = verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = vc[:, 2]
    front = z > 1e-4
    uv = (vc[:, :2] / np.clip(z[:, None], 1e-6, None)) @ np.asarray(intr)[:2, :2].T \
        + np.asarray(intr)[:2, 2]
    xs = np.round(uv[:, 0]).astype(int)
    ys = np.round(uv[:, 1]).astype(int)
    ok = front & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.clip(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-9, None)
    shade = 0.3 + 0.7 * np.clip(vn[:, 2] * -0.5 + vn[:, 1] * -0.5 + 0.5, 0, 1)
    color = np.stack([0.2 * shade, 0.9 * shade, 0.4 * shade], -1)

    out = rgb.copy()
    zbuf = depth.copy() if depth is not None else np.full((H, W), np.inf)
    order = np.argsort(-z[ok])
    xs, ys, zs = xs[ok][order], ys[ok][order], z[ok][order]
    cs = color[ok][order]
    vis = zs <= zbuf[ys, xs] * 1.02 + 0.05
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            yy = np.clip(ys[vis] + dy, 0, H - 1)
            xx = np.clip(xs[vis] + dx, 0, W - 1)
            out[yy, xx] = (1 - alpha) * out[yy, xx] + alpha * cs[vis]
    return out


def nvs_poses(scene, cam_id: str, rcfg: Dict[str, Any]) -> np.ndarray:
    """The ``render.n_frames`` poses of ``render.path`` for camera ``cam_id``
    (see the module's docstring)."""
    n = int(rcfg.get("n_frames", 24))
    path_type = rcfg.get("path", "spherical_spiral")
    c2ws = scene.observers[cam_id].frame_data["transform"].cpu().numpy()
    if path_type == "spherical_spiral":
        center = c2ws[:, :3, 3].mean(0) * 0 + np.asarray(rcfg.get("center", [0.0, 0.0, 0.0]))
        return get_path_spherical_spiral(center, float(rcfg.get("radius", 2.0)), n)
    if path_type == "small_circle":
        return get_path_small_circle(c2ws[0], n, float(rcfg.get("radius", 0.2)))
    if path_type == "street_view":
        world = np.stack([scene.slice_at(fi).world_transform(cam_id).cpu().numpy()
                          for fi in range(scene.n_frames)])
        return get_path_street_view(world, n, shift_l=float(rcfg.get("shift_l", 2.0)),
                                    shift_v=float(rcfg.get("shift_v", 1.0)),
                                    pitch_deg=float(rcfg.get("pitch_deg", 10.0)))
    return get_path_interpolation(c2ws, n)


def lidar_frame_rays(frozen, loader, fi: int, lidar_model: str, lidar_params: Dict[str, Any],
                     mount: str, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The world beams (origins, unit directions) [N, 3] of one frame: the
    loader's first LiDAR's at frame ``fi`` for ``original`` (None where the
    frame has none), else ``lidar_model``'s generator mounted on node
    ``mount`` of the frozen scene. A loader without a LiDAR sends
    ``original`` to the generators, which refuse it."""
    if lidar_model == "original" and loader.lidar_ids:
        lid = loader.lidar_ids[0]
        ld = loader.lidars.get((lid, fi))
        if ld is None:
            return None
        return lidar_rays_to_world(frozen, lid, torch.from_numpy(ld["rays_o"]).to(device),
                                   torch.from_numpy(ld["rays_d"]).to(device))
    o, d = make_lidar_generator(lidar_model, **lidar_params).get_all_rays(device)
    return lidar_rays_to_world(frozen, mount, o, d)


@torch.no_grad()
def lidar_query(renderer, params, rays_o: torch.Tensor, rays_d: torch.Tensor, *, frozen=None,
                occ=None, forward_inv_s: float = 256.0, rayschunk: int = 4096
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The street alone along world beams [N, 3], no rgb, the deterministic
    query at ``forward_inv_s``, in chunks of ``rayschunk`` beams (a beam's
    result depends on no other's) -> (depth, mask volume) [N]. ``frozen``:
    the scene for a compose renderer, None for the single-volume one."""
    at = () if frozen is None else (frozen,)
    depth, mask = [], []
    for s in range(0, rays_o.shape[0], rayschunk):
        r = renderer.ray_query(params, *at, rays_o[s:s + rayschunk].contiguous(),
                               rays_d[s:s + rayschunk].contiguous(), with_rgb=False,
                               only_cr=True, occ_states=occ,
                               query_overrides={"forward_inv_s": forward_inv_s})
        depth.append(r["depth_volume"])
        mask.append(r["mask_volume"])
    return torch.cat(depth), torch.cat(mask)


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


def frames_of(rcfg: Dict[str, Any], n_frames: int) -> List[int]:
    """``render.frames`` as a list (a "0,4" string, an int or a list);
    default every frame."""
    frames = rcfg.get("frames")
    if isinstance(frames, str):
        frames = [int(x) for x in frames.split(",")]
    elif isinstance(frames, int):
        frames = [frames]           # "--render.frames=0" parses as an int
    return frames or list(range(n_frames))


class LoadedRun(NamedTuple):
    """A trained run restored for rendering (``load_render``): ``multi`` for
    the compose renderer (which takes the scene frozen at a frame), the
    close range's model id ``cr_id`` (None where there is none)."""
    multi: bool
    scene: Any
    renderer: Any
    params: Any
    occ: Any
    loader: Any
    exp_dir: str
    cr_id: Optional[str]


def load_render(cfg: Dict[str, Any], device="cuda") -> LoadedRun:
    """The run of ``resume_dir`` (or ``exp_dir``): the multi-object config's
    (``renderer.type: multi``) through ``eval_multi.load_for_eval``, else the
    single-scene one's through ``eval.load_single_for_eval``."""
    if cfg.get("renderer", {}).get("type") == "multi":
        scene, renderer, params, occ, loader, exp_dir = load_for_eval(cfg, device)
        cr_id = renderer.scene_models["cr"][0] if "cr" in renderer.scene_models else None
        return LoadedRun(True, scene, renderer, params, occ, loader, exp_dir, cr_id)
    scene, renderer, params, occ, loader, exp_dir = load_single_for_eval(cfg, device)
    return LoadedRun(False, scene, renderer, params, occ, loader, exp_dir, renderer.pkey("cr"))


def pixel_centres(W: int, H: int, ds: int, device) -> torch.Tensor:
    """The centres of every ``ds``-th pixel of a W x H image, row by row:
    [(H // ds) * (W // ds), 2] in full-resolution pixel coordinates."""
    ys, xs = np.meshgrid(np.arange(H // ds), np.arange(W // ds), indexing="ij")
    return torch.from_numpy(np.stack([xs * ds + 0.5 * ds, ys * ds + 0.5 * ds], -1)
                            .reshape(-1, 2).astype(np.float32)).to(device)


@torch.no_grad()
def main_function(cfg: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Render the run of ``resume_dir`` (or ``exp_dir``) with the ``render``
    block. Returns {out_dir, frames, video} (``lidar`` also {beams, points}:
    the beams rendered and the hit points written)."""
    cfg = resolve_refs(cfg)
    rcfg = cfg.get("render", {})
    mode = rcfg.get("mode", "replay")
    if mode not in MODES:
        raise ValueError(mode)
    for name in _NOT_PORTED_OPTIONS:
        if rcfg.get(name):
            raise NotImplementedError(f"render.{name} is not ported")
    multi, scene, renderer, params, occ, loader, exp_dir, cr_id = load_render(cfg, device)
    dev = next(params.parameters()).device
    # re-simulation: the trajectories are edited before anything is rendered
    anim_cfg = rcfg.get("anim")
    if anim_cfg:
        create_anim(anim_cfg, scene).apply(scene)
    out_dir = os.path.join(exp_dir, f"render_{mode}{'_anim' if anim_cfg else ''}")
    os.makedirs(out_dir, exist_ok=True)
    rayschunk = int(rcfg.get("rayschunk", 4096))
    frames = frames_of(rcfg, scene.n_frames)
    cam_id = rcfg.get("cam_id", loader.cam_ids[0])
    W, H = loader.image_wh(cam_id)
    ds = int(rcfg.get("downscale", 2))
    Hs, Ws = H // ds, W // ds
    xy = pixel_centres(W, H, ds, dev)

    # a time-conditioned close range is rendered at the frame's time
    timed = not multi and getattr(params[cr_id], "use_time", False) and scene.n_frames > 1

    def render(ro, rd, fi, at_time=True):
        # the compose renderer takes the scene frozen at the frame
        at = (scene.slice_at(fi),) if multi else ()
        kw = {"cond": torch.full((1, 1), fi / (scene.n_frames - 1), device=dev)} \
            if timed and at_time else {}
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
        mesh = load_mesh_ply(rcfg["mesh_overlay"]) if rcfg.get("mesh_overlay") else None
        intr_s = None
        for fi in frames:
            fr = scene.slice_at(fi)
            ro, rd = camera_get_selected_rays(fr, cam_id, xy)
            r = render(ro, rd, fi)
            write_extra_channels(r, fi, Hs, Ws)
            rgb = r["rgb_volume"].cpu().numpy().reshape(Hs, Ws, 3)
            depth = r["depth_volume"].cpu().numpy().reshape(Hs, Ws)
            if mesh is not None:
                if intr_s is None:
                    intr_s = fr.data(cam_id)["intr"].cpu().numpy().astype(np.float64)
                    intr_s[:2] /= ds
                rgb = overlay_mesh(rgb, depth, mesh[0], mesh[1], intr_s,
                                   fr.world_transform(cam_id).cpu().numpy(),
                                   alpha=float(rcfg.get("mesh_alpha", 0.5)))
            _write_png(os.path.join(out_dir, f"rgb_{fi:04d}.png"), _u8(rgb))
            _write_png(os.path.join(out_dir, f"depth_{fi:04d}.png"), _u8(color_depth(depth)))
        size = (Ws, Hs)
    elif mode == "nvs":
        poses = nvs_poses(scene, cam_id, rcfg)
        intr = scene.observers[cam_id].frame_data["intr"][0]
        for i, c2w in enumerate(poses):
            ro, rd = get_rays(xy, intr, torch.from_numpy(np.asarray(c2w, np.float32)).to(dev))
            # no frame's time; a multi-object scene frozen at frame 0
            r = render(ro, rd, 0, at_time=False)
            _write_png(os.path.join(out_dir, f"rgb_{i:04d}.png"),
                       _u8(r["rgb_volume"].cpu().numpy().reshape(Hs, Ws, 3)))
        frames, size = list(range(len(poses))), (Ws, Hs)
    elif mode == "lidar":
        lidar_model = rcfg.get("lidar_model", "original")
        inv_s = float(rcfg.get("lidar_forward_inv_s", 256.0))
        all_pts, done, beams = [], [], 0
        for fi in frames:
            fr = scene.slice_at(fi)
            rays = lidar_frame_rays(fr, loader, fi, lidar_model, rcfg.get("lidar_params", {}),
                                    rcfg.get("mount_node", cam_id), dev)
            if rays is None:
                continue
            depth, mask = lidar_query(renderer, params, *rays,
                                      frozen=scene.slice_at(0) if multi else None, occ=occ,
                                      forward_inv_s=inv_s, rayschunk=rayschunk)
            ro, rd = (t.cpu().numpy() for t in rays)
            depth, mask = depth.cpu().numpy(), mask.cpu().numpy() > LIDAR_HIT
            all_pts.append(ro[mask] + depth[mask, None] * rd[mask])
            np.savez(os.path.join(out_dir, f"lidar_{fi:04d}.npz"), depth=depth, mask=mask,
                     rays_o=ro, rays_d=rd)
            done.append(fi)
            beams += depth.shape[0]
        if all_pts:
            export_pcl_ply(os.path.join(out_dir, "points.ply"), np.concatenate(all_pts, 0))
        print(f"lidar[{lidar_model}]: {len(frames)} frames -> {out_dir}", flush=True)
        return {"out_dir": out_dir, "frames": done, "video": None, "beams": beams,
                "points": int(sum(p.shape[0] for p in all_pts))}
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
        xyt = torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)).to(dev)
        ro, rd = ortho_get_rays(xyt, torch.from_numpy(c2w).to(dev), width=x1 - x0,
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
