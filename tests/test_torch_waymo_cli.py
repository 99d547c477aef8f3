"""Both driving YAMLs as written, from the command line, on the demo drive
written to disk in the Waymo layout (``dataio.waymo_demo.build_demo_sequence``,
2 frames of 16x24), on the CPU.

configs/waymo_demo_multi.yaml and configs/waymo_streetsurf.yaml go through the
port's config reader with ``dataset_cfg.params.root`` at the written drive
and narrow widths as dot overrides (the YAMLs' ``WaymoDataset`` target kept;
StreetSurf's three cameras name one that the drive has). ``--device=cpu``
trains each for 2 iterations (``tools.train_multi.main``, ``tools.train.main``),
then from the exp dir ``eval_multi``, ``eval_lidar`` (both branches), ``eval``
and ``render`` (``replay``, ``topdown``) run through their ``main(argv)``:
each writes the JAX tools' file names with finite metrics.

Against ``neuralsim_tpu`` on the same files: the data loader over each
package's reader (images, masks, filtered LiDAR: equal), the orthographic
and panorama cameras' rays (1e-6 absolute plus 1e-6 relative: the same
float32 products, summed in another order; the worst ortho origin, ~40 m,
used 0.79 of it, 3.8e-6), the panorama projection (1e-5: 1.9e-6 measured on
pixels up to 32) and ``tools.eval.evaluate``'s scoring of the same rendered
arrays (equal).
"""
import copy
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neuralsim_tpu.dataio.dataloader import SceneDataLoader as JaxLoader
from neuralsim_tpu.dataio.waymo import WaymoDataset as JaxReader
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.scene.observers.extra_cameras import ortho_get_rays as jax_ortho
from neuralsim_tpu.tools.eval import evaluate as jax_evaluate
from neuralsim_torch.config import load_config
from neuralsim_torch.dataio.dataloader import SceneDataLoader
from neuralsim_torch.dataio.waymo import WaymoDataset
from neuralsim_torch.dataio.waymo_demo import build_demo_sequence
from neuralsim_torch.scene import Scene
from neuralsim_torch.scene.observers.extra_cameras import (ortho_get_rays, panorama_get_rays,
                                                           panorama_project)
from neuralsim_torch.tools import eval as single_eval
from neuralsim_torch.tools import (eval_lidar, eval_multi, extract_mesh, extract_occgrid,
                                   extract_visible_grid, manipulate, render, run, train,
                                   train_multi, visualize_slice)
from neuralsim_torch.tools.build import multi_dataset, multi_scenario, single_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTI_YAML = os.path.join(ROOT, "configs", "waymo_demo_multi.yaml")
STREET_YAML = os.path.join(ROOT, "configs", "waymo_streetsurf.yaml")
DRIVE = dict(n_frames=2, H=16, W=24)
SID, CAM, LID = "demo_drive", "camera_FRONT", "lidar_TOP"
TRAIN = ["--training.num_iters=2", "--training.n_rays=32", "--training.n_rays_lidar=32",
         "--training.uniform_sample_n=16", "--training.i_log=1"]
MULTI_ARGV = TRAIN + [
    "--training.error_map={hw: [4, 6], frac_uniform: 0.5, enable_after: 1}",
    "--assetbank_cfg.Vehicle.model_params.z_dim=4",
    "--assetbank_cfg.Vehicle.model_params.geo_feat_dim=7",
    "--assetbank_cfg.Vehicle.model_params.radiance_hidden=16",
    "--assetbank_cfg.Vehicle.model_params.encoding_cfg={n_levels: 4, base_res: 4, max_res: 32, "
    "n_feats: 2, cp_max_res: 32}",
    "--assetbank_cfg.Vehicle.model_params.query_cfg={num_coarse: 8, num_fine: [4], "
    "upsample_inv_s_factors: [1.0]}",
    "--assetbank_cfg.Street.model_params.geo_feat_dim=7",
    "--assetbank_cfg.Street.model_params.radiance_hidden=16",
    "--assetbank_cfg.Street.model_params.encoding_cfg={type: tpu_mixed, n_levels: 3, "
    "base_res: 16, max_res: 64, n_feats: 2, n_hash_levels: 0, cp_max_res: 64}",
    "--assetbank_cfg.Street.model_params.query_cfg={num_coarse: 8, num_fine: [4, 4], "
    "upsample_inv_s: 64.0, upsample_inv_s_factors: [1.0, 4.0]}",
    "--assetbank_cfg.Street.model_params.pretrain.n_iters=200",
    "--assetbank_cfg.Street.model_params.pretrain.n_pts=256",
    "--assetbank_cfg.Street.model_params.accel_cfg.resolution=16",
    "--assetbank_cfg.Street.model_params.accel_cfg.samples_per_voxel=1",
    "--assetbank_cfg.Distant.model_params.geo_feat_dim=4",
    "--assetbank_cfg.Distant.model_params.query_cfg={num_samples: 8}",
    "--assetbank_cfg.Sky.model_params={hidden: 8}"]
STREET_ARGV = TRAIN + [
    "--assetbank_cfg.Street.model_params.encoding_cfg={type: tpu_mixed, n_levels: 4, "
    "base_res: 8, max_res: 64, n_feats: 2, n_hash_levels: 1, log2_hashmap_size: 10, "
    "cp_max_res: 64}",
    "--assetbank_cfg.Street.model_params.accel_cfg.resolution=16",
    "--assetbank_cfg.Street.model_params.pretrain.n_iters=200",
    "--assetbank_cfg.Street.model_params.pretrain.n_pts=256",
    "--assetbank_cfg.Street.model_params.query_cfg={num_coarse: 8, num_fine: [4, 4]}",
    "--assetbank_cfg.Distant.model_params.encoding_cfg={n_levels: 3, base_res: 4, max_res: 16, "
    "log2_hashmap_size: 10}",
    "--renderer.distant_query_cfg.num_samples=8"]
# every beam whose rendered mask is above this counts as a hit, so that an
# untrained street scores its frames (at the YAML's 0.5 none may pass)
EVAL_ARGV = ["--eval.frames=0,1", "--eval.pred_mask=0.001", "--eval.rayschunk=256"]
MULTI_FILES = ("config.json", "metrics.jsonl", "ckpts/final", "eval_multi/metrics.json",
               "eval_multi/per_object.csv", "eval_multi/rgb_0000.png", "eval_multi/gt_0000.png",
               "eval_multi/depth_0000.png", "eval/lidar_metrics.json",
               "render_replay/rgb_0000.png", "render_replay/depth_0000.png",
               "render_topdown/rgb_0000.png", "render_topdown/height_0000.png",
               "render_topdown/rgb_0001.png")
STREET_FILES = ("config.json", "metrics.jsonl", "ckpts/final", "eval/metrics.json",
                "eval/lidar_metrics.json", "render_replay/rgb_0001.png",
                "render_replay/depth_0001.png", "render_topdown/rgb_0000.png",
                "render_topdown/height_0000.png")


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    build_demo_sequence(root, **DRIVE)
    return root


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    return tree is None or isinstance(tree, str) or math.isfinite(tree)


@pytest.fixture(scope="module")
def multi_run(drive, tmp_path_factory):
    """configs/waymo_demo_multi.yaml trained for 2 iterations from the command
    line, then each tool from the exp dir; -> (exp dir, {tool: its result})."""
    exp = str(tmp_path_factory.mktemp("multi"))
    out = {"train": train_multi.main(["--config", MULTI_YAML, f"--exp_dir={exp}",
                                      f"--dataset_cfg.params.root={drive}", "--device=cpu"]
                                     + MULTI_ARGV)}
    at = ["--resume_dir", exp, "--device=cpu"]
    out["eval_multi"] = eval_multi.main(at + EVAL_ARGV)
    out["eval_lidar"] = eval_lidar.main(at + ["--renderer.type=multi"] + EVAL_ARGV)
    out["replay"] = render.main(at + ["--renderer.type=multi", "--render.mode=replay",
                                      "--render.frames=0", "--render.video=false"])
    out["topdown"] = render.main(at + ["--renderer.type=multi", "--render.mode=topdown",
                                       "--render.topdown_w=32", "--render.fps=6"])
    return exp, out


@pytest.fixture(scope="module")
def street_run(drive, tmp_path_factory):
    """configs/waymo_streetsurf.yaml, the same way (its single-scene tools)."""
    exp = str(tmp_path_factory.mktemp("street"))
    out = {"train": train.main(["--config", STREET_YAML, f"--exp_dir={exp}",
                                f"--dataset_cfg.params.root={drive}", "--device=cpu"]
                               + STREET_ARGV)}
    at = ["--resume_dir", exp, "--device=cpu"]
    out["eval"] = single_eval.main(at + EVAL_ARGV)
    out["eval_lidar"] = eval_lidar.main(at + EVAL_ARGV)
    out["replay"] = render.main(at + ["--render.mode=replay", "--render.frames=1",
                                      "--render.downscale=1", "--render.video=false"])
    out["topdown"] = render.main(at + ["--render.mode=topdown", "--render.frames=0",
                                       "--render.topdown_w=24", "--render.video=false"])
    return exp, out


def test_both_yamls_read_as_written_with_the_root_pointed_at_the_drive(drive):
    for path, argv in ((MULTI_YAML, MULTI_ARGV), (STREET_YAML, STREET_ARGV)):
        cfg = load_config(path, [f"dataset_cfg.params.root={drive}"]
                          + [a[2:] for a in argv]).to_plain()
        assert cfg["dataset_cfg"]["target"] == "neuralsim_tpu.dataio.waymo.WaymoDataset"
        assert cfg["dataset_cfg"]["params"]["root"] == drive
    street = load_config(STREET_YAML, [f"dataset_cfg.params.root={drive}"]).to_plain()
    ds = single_dataset(street)
    assert isinstance(ds, WaymoDataset) and ds.lidar_list == [LID]
    assert ds.camera_list == [CAM, "camera_FRONT_LEFT", "camera_FRONT_RIGHT"]
    assert list(ds.get_scenario(SID)["observers"]["ego_car"]["children"]) == [CAM, LID]
    multi = load_config(MULTI_YAML, [f"dataset_cfg.params.root={drive}"]).to_plain()
    assert isinstance(multi_dataset(multi), WaymoDataset)
    assert multi_scenario(multi)["scene_id"] == SID
    with pytest.raises(NotImplementedError, match="multi-object"):
        multi_dataset({"dataset_cfg": {"target": "x.KITTIDataset", "params": {}}})


@pytest.mark.parametrize("name", MULTI_FILES)
def test_the_multi_object_tools_write_jax_s_files(multi_run, name):
    assert os.path.exists(os.path.join(multi_run[0], name)), name


@pytest.mark.parametrize("name", STREET_FILES)
def test_the_single_scene_tools_write_jax_s_files(street_run, name):
    assert os.path.exists(os.path.join(street_run[0], name)), name


@pytest.mark.parametrize("tool", ["train", "eval_multi", "eval_lidar", "replay", "topdown"])
def test_the_multi_object_chain_runs_with_finite_metrics(multi_run, tool):
    exp, out = multi_run
    r = out[tool]
    if tool == "train":
        assert r["state"].it == 2 and r["skips_total"] == 0
        assert all(_finite({k: v for k, v in rec.items()}) for rec in r["log"])
        with open(os.path.join(exp, "config.json")) as f:
            cfg = json.load(f)
        assert cfg["dataset_cfg"]["target"].endswith("waymo.WaymoDataset")
    elif tool == "eval_multi":
        assert [row["frame"] for row in r["per_frame"]] == [0, 1]
        assert math.isfinite(r["mean"]["psnr"]) and _finite(r["per_class"])
        with open(os.path.join(exp, "eval_multi", "metrics.json")) as f:
            assert json.load(f) == json.loads(json.dumps(r))
    elif tool == "eval_lidar":
        assert [row["frame"] for row in r["per_frame"]] == [0, 1]
        assert {"mae", "rmse", "hit_recall", "chamfer", "no_return_frac"} <= set(r["mean"])
        assert _finite(r["mean"])
    else:
        assert r["out_dir"] == os.path.join(exp, f"render_{tool}")
        assert r["frames"] == ([0] if tool == "replay" else [0, 1])
        assert (r["video"] is None) == (tool == "replay")
        assert tool == "replay" or os.path.isfile(r["video"])


@pytest.mark.parametrize("tool", ["train", "eval", "eval_lidar", "replay", "topdown"])
def test_the_single_scene_chain_runs_with_finite_metrics(street_run, tool):
    exp, out = street_run
    r = out[tool]
    if tool == "train":
        assert r["state"].it == 2 and r["skips_total"] == 0 and math.isfinite(r["psnr"])
        assert all(math.isfinite(rec["lidar/loss_lidar"]) for rec in r["log"])
    elif tool == "eval":
        assert [row["frame"] for row in r["per_frame"]] == [0, 1]
        assert {"psnr", "ssim", "psnr_fg", "psnr_bg", "mask_acc"} <= set(r["mean"])
        assert r["mean"]["lpips"] is None and _finite(r["mean"])
        with open(os.path.join(exp, "eval", "metrics.json")) as f:
            assert json.load(f) == json.loads(json.dumps(r))
    elif tool == "eval_lidar":
        assert [row["frame"] for row in r["per_frame"]] == [0, 1]
        assert {"mae", "chamfer_95", "hit_frac"} <= set(r["mean"])
        assert _finite(r["mean"])
    else:
        assert r["video"] is None and len(r["frames"]) == 1


def test_render_refuses_what_is_not_ported(street_run):
    at = ["--resume_dir", street_run[0], "--device=cpu"]
    with pytest.raises(NotImplementedError, match="data_parallel"):
        render.main(at + ["--render.data_parallel=true"])
    with pytest.raises(ValueError, match="spin"):
        render.main(at + ["--render.mode=spin"])
    with pytest.raises(ValueError, match="unknown anim type"):
        render.main(at + ["--render.anim={type: reverse}"])
    with pytest.raises(ValueError, match="unknown lidar_model"):
        render.main(at + ["--render.mode=lidar", "--render.lidar_model=velodyne"])


@pytest.mark.parametrize("filters", [{}, {"filter_lidar_max_range": 12.0},
                                     {"filter_lidar_in_cams": True}])
def test_the_loader_over_the_reader_equals_jax_s(drive, filters):
    mine_ds, jax_ds = WaymoDataset(drive), JaxReader(drive)
    sc = mine_ds.get_scenario(SID)
    mine = SceneDataLoader(Scene.load_from_scenario(sc), mine_ds, with_lidar=True, **filters)
    theirs = JaxLoader(JaxScene.load_from_scenario(jax_ds.get_scenario(SID)), jax_ds,
                       with_lidar=True, **filters)
    assert mine.cam_ids == theirs.cam_ids == [CAM] and mine.lidar_ids == theirs.lidar_ids
    for got, want in ((mine.images, theirs.images), (mine.masks, theirs.masks)):
        assert set(got) == set(want) and len(got) == DRIVE["n_frames"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert set(mine.lidars) == set(theirs.lidars) and len(mine.lidars) == DRIVE["n_frames"]
    for key, want in theirs.lidars.items():
        for k in want:
            np.testing.assert_array_equal(mine.lidars[key][k], want[k], err_msg=f"{key} {k}")
    if filters:
        assert all(len(mine.lidars[k]["ranges"]) < 12 * 64 for k in mine.lidars)


@pytest.mark.parametrize("size", [(32, 27, 83.0, 70.0), (7, 13, 1.5, 2.5)])
def test_ortho_rays_match_jax(size):
    W, H, width, height = size
    rng = np.random.default_rng(W)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = [33.5, 0.0, 9.95]
    for T in (c2w, np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)):
        if T.shape == (3, 3):
            T = np.concatenate([np.concatenate([T, [[1.0], [2.0], [3.0]]], 1),
                                [[0, 0, 0, 1]]]).astype(np.float32)
        got = ortho_get_rays(torch.from_numpy(xy), torch.from_numpy(T), width=width,
                             height=height, W=W, H=H)
        want = jax_ortho(jnp.asarray(xy), jnp.asarray(T), width=width, height=height, W=W, H=H)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_panorama_rays_and_projection_match_jax():
    from neuralsim_tpu.scene.observers.extra_cameras import panorama_get_rays as jax_pano
    from neuralsim_tpu.scene.observers.extra_cameras import panorama_project as jax_project
    rng = np.random.default_rng(0)
    xy = (rng.uniform(0, 1, (64, 2)) * [32, 16]).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.0, -2.0, 0.5]
    got = panorama_get_rays(torch.from_numpy(xy), torch.from_numpy(T), W=32, H=16)
    want = jax_pano(jnp.asarray(xy), jnp.asarray(T), W=32, H=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    got = panorama_project(torch.from_numpy(pts), W=32, H=16)
    want = jax_project(jnp.asarray(pts), W=32, H=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


class _StubSingle:
    """A single-volume renderer that returns the next of ``frames`` (seeded
    arrays [H W]), as numpy (the JAX package) or torch tensors."""

    def __init__(self, frames, torch_out):
        self.frames, self.torch_out = list(frames), torch_out

    def render_chunked(self, params, ro, rd, **kw):
        f = self.frames.pop(0)
        return {k: torch.from_numpy(v) if self.torch_out else v for k, v in f.items()}


@pytest.mark.parametrize("downscale", [1, 2])
def test_evaluate_scores_as_jax(drive, downscale):
    """The same rendered arrays scored by both packages' ``evaluate`` over
    the same frames from each package's reader and loader: equal rows and
    means."""
    mine_ds, jax_ds = WaymoDataset(drive), JaxReader(drive)
    scene = Scene.load_from_scenario(mine_ds.get_scenario(SID))
    jscene = JaxScene.load_from_scenario(jax_ds.get_scenario(SID))
    loader, jloader = SceneDataLoader(scene, mine_ds), JaxLoader(jscene, jax_ds)
    H, W = -(-DRIVE["H"] // downscale), -(-DRIVE["W"] // downscale)
    rng = np.random.default_rng(downscale)
    stub = [{"rgb_volume": rng.uniform(0, 1, (H * W, 3)).astype(np.float32),
             "mask_volume": rng.uniform(0, 1, H * W).astype(np.float32)} for _ in range(2)]
    params = nn.ModuleDict({"m": nn.Linear(1, 1)})
    got = single_eval.evaluate(scene, _StubSingle(stub, True), params, loader, cam_id=CAM,
                               frames=[1, 0], downscale=downscale)
    want = jax_evaluate(jscene, _StubSingle(copy.deepcopy(stub), False), None, jloader,
                        cam_id=CAM, frames=[1, 0], downscale=downscale)
    assert got == want
    assert [r["frame"] for r in got["per_frame"]] == [1, 0] and "psnr_fg" in got["mean"]


@pytest.mark.parametrize("tool", ["train_multi", "train", "eval_multi", "eval_lidar", "eval",
                                  "render", "render_lidar", "manipulate", "extract_mesh",
                                  "extract_occgrid", "extract_visible_grid", "visualize_slice",
                                  "run"])
def test_every_command_line_runs_on_the_card_unless_asked(multi_run, drive, monkeypatch, tool):
    """Without ``--device=cpu`` each tool asks for the card, and says so
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = {"train_multi": train_multi.main, "train": train.main, "eval_multi": eval_multi.main,
           "eval_lidar": eval_lidar.main, "eval": single_eval.main, "render": render.main,
           "render_lidar": lambda a: render.main(a + ["--render.mode=lidar"]),
           "manipulate": manipulate.main, "extract_mesh": extract_mesh.main,
           "extract_occgrid": extract_occgrid.main,
           "extract_visible_grid": extract_visible_grid.main,
           "visualize_slice": visualize_slice.main,
           "run": lambda a: run.main(["extract_mesh,render"] + a)}
    if tool.startswith("train"):
        argv = ["--config", MULTI_YAML if tool == "train_multi" else STREET_YAML,
                f"--dataset_cfg.params.root={drive}", "--exp_dir=/nonexistent/x"]
    else:
        argv = ["--resume_dir", multi_run[0]] + (["--renderer.type=multi"]
                                                 if tool != "eval" else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fns[tool](argv)


# the sensor-simulation and editing tools from the same exp dirs: a pandar64
# cut to 4 x 32 beams, NVS at 2 frames, the mesh at res 16, grids of 16
SIM_LIDAR = ["--render.mode=lidar", "--render.lidar_model=pandar64",
             "--render.lidar_params={n_channels: 4, horizontal_res: 32}"]
NVS_PATHS = ("spherical_spiral", "small_circle", "street_view", "interpolation")
EDIT_MODES = ("rotate", "translate", "scale", "delete", "thanos")


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path), np.float32)


def _lidar_files(r):
    """-> (the render's result, {frame: the npz's arrays}, points.ply's vertices)."""
    from neuralsim_torch.graphics import load_mesh_ply
    npz = {}
    for fi in r["frames"]:
        with np.load(os.path.join(r["out_dir"], f"lidar_{fi:04d}.npz")) as z:
            npz[fi] = {k: z[k] for k in z.files}
    return r, npz, load_mesh_ply(os.path.join(r["out_dir"], "points.ply"))[0]


@pytest.fixture(scope="module")
def multi_sim(multi_run, tmp_path_factory):
    """The simulation tools on the multi-object exp dir -> {case: result}."""
    exp = multi_run[0]
    at = ["--resume_dir", exp, "--device=cpu", "--renderer.type=multi"]
    out = {"lidar_original": _lidar_files(render.main(at + ["--render.mode=lidar"])),
           "lidar_pandar64": _lidar_files(render.main(at + SIM_LIDAR)),
           "nvs_street_view": render.main(at + ["--render.mode=nvs", "--render.path=street_view",
                                                "--render.n_frames=2", "--render.video=false"])}
    base = _png(os.path.join(exp, "render_replay", "rgb_0000.png"))
    replay = ["--render.frames=0", "--render.video=false"]
    rev = render.main(at + replay + ["--render.anim=reverse_ego"])
    out["anim_reverse_ego"] = (rev, np.abs(_png(os.path.join(rev["out_dir"], "rgb_0000.png"))
                                           - base).max())
    ego = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ego[:, :3, 3] = [[0.0, 3.0, 1.8], [1.5, 3.0, 1.8]]           # off the lane
    veh = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    veh[:, :3, 3] = [5.0, -2.2, 0.9]                             # one pose, held
    traj = str(tmp_path_factory.mktemp("anim") / "traj.npz")
    np.savez(traj, ego_car=ego, veh_0=veh)
    moved = render.main(at + replay + [f"--render.anim={traj}"])
    out["anim_file"] = (moved, np.abs(_png(os.path.join(moved["out_dir"], "rgb_0000.png"))
                                      - base).max())
    edit = ["--resume_dir", exp, "--device=cpu"]
    out["edit_none"] = manipulate.main(edit + ["--manipulate.mode=none"])
    for mode in EDIT_MODES:
        out[f"edit_{mode}"] = manipulate.main(edit + [f"--manipulate.mode={mode}"])
    out["extract_mesh"] = extract_mesh.main(at + ["--res=16"])
    out["visible_grid_camera"] = extract_visible_grid.main(
        at + ["--grid.res=16", "--grid.frames=0", "--grid.rayschunk=64"])
    return exp, out


@pytest.fixture(scope="module")
def street_sim(street_run):
    """The simulation tools on the single-scene exp dir -> {case: result}."""
    exp = street_run[0]
    at = ["--resume_dir", exp, "--device=cpu"]
    out = {"lidar_original": _lidar_files(render.main(at + ["--render.mode=lidar"])),
           "lidar_pandar64": _lidar_files(render.main(at + SIM_LIDAR + ["--render.frames=1"]))}
    for path in NVS_PATHS:
        out[f"nvs_{path}"] = render.main(at + ["--render.mode=nvs", f"--render.path={path}",
                                               "--render.n_frames=2", "--render.fps=4"])
        out[f"nvs_{path}_frame"] = _png(os.path.join(exp, "render_nvs", "rgb_0001.png"))
    out["extract_mesh"] = extract_mesh.main(at + ["--res=16"])
    plain = _png(os.path.join(exp, "render_replay", "rgb_0001.png"))     # overwritten below
    over = render.main(at + ["--render.frames=1", "--render.downscale=1", "--render.video=false",
                             f"--render.mesh_overlay={out['extract_mesh']['path']}",
                             "--render.mesh_alpha=0.9"])
    out["mesh_overlay"] = (over, np.abs(_png(os.path.join(over["out_dir"], "rgb_0001.png"))
                                        - plain).max())
    out["extract_occgrid"] = extract_occgrid.main(at + ["--res=16"])
    out["visible_grid_lidar_gt"] = extract_visible_grid.main(
        at + ["--grid.source=lidar_gt", "--grid.res=16", "--grid.morphology=close2"])
    out["visualize_slice"] = visualize_slice.main(at + ["--slice.res=12"])
    out["slice_shapes"] = [_png(f).shape for f in out["visualize_slice"]["files"]]  # run redoes them
    out["run"] = run.main(["extract_occgrid,visualize_slice"] + at
                          + ["--res=8", "--slice.res=8", f"--out={exp}/run_occ.npz"])
    return exp, out


@pytest.mark.parametrize("which", ["multi", "street"])
@pytest.mark.parametrize("model", ["original", "pandar64"])
def test_lidar_simulation_writes_each_frame_and_the_cloud(multi_sim, street_sim, which, model):
    exp, out = multi_sim if which == "multi" else street_sim
    r, npz, cloud = out[f"lidar_{model}"]
    assert r["out_dir"] == os.path.join(exp, "render_lidar")
    assert r["frames"] == ([0, 1] if which == "multi" or model == "original" else [1])
    n = 4 * 32 if model == "pandar64" else None
    for fi, z in npz.items():
        assert set(z) == {"depth", "mask", "rays_o", "rays_d"} and z["mask"].dtype == bool
        assert n is None or z["depth"].shape == (n,)
        assert np.isfinite(z["depth"]).all() and np.isfinite(z["rays_o"]).all()
        np.testing.assert_allclose(np.linalg.norm(z["rays_d"], axis=-1), 1.0, atol=1e-5)
    assert r["beams"] == sum(z["depth"].shape[0] for z in npz.values())
    assert r["points"] == cloud.shape[0] == sum(int(z["mask"].sum()) for z in npz.values())
    assert np.isfinite(cloud).all()


@pytest.mark.parametrize("path", NVS_PATHS + ("multi_street_view",))
def test_nvs_renders_each_path(multi_sim, street_sim, path):
    exp, out = (multi_sim if path.startswith("multi") else street_sim)
    r = out[path.replace("multi_", "nvs_") if path.startswith("multi") else f"nvs_{path}"]
    assert r["out_dir"] == os.path.join(exp, "render_nvs") and r["frames"] == [0, 1]
    assert os.path.isfile(os.path.join(r["out_dir"], "rgb_0001.png"))
    assert path.startswith("multi") or (r["video"] and os.path.isfile(r["video"]))
    if not path.startswith("multi"):
        assert out[f"nvs_{path}_frame"].shape == (8, 12, 3)


@pytest.mark.parametrize("form", ["reverse_ego", "file"])
def test_anim_changes_the_replayed_frame(multi_sim, form):
    """As JAX's tests/test_cli_train_e2e.py holds its own: more than 2 grey
    levels apart somewhere."""
    exp, out = multi_sim
    r, diff = out[f"anim_{form}"]
    assert r["out_dir"] == os.path.join(exp, "render_replay_anim")
    assert diff > 2.0, diff


def test_mesh_overlay_paints_the_replayed_frame(street_sim):
    exp, out = street_sim
    r, diff = out["mesh_overlay"]
    assert r["out_dir"] == os.path.join(exp, "render_replay") and r["frames"] == [1]
    assert out["extract_mesh"]["faces"].shape[0] > 0 and diff > 2.0, diff


@pytest.mark.parametrize("mode", EDIT_MODES)
def test_each_edit_renders_and_changes_the_frame(multi_sim, mode):
    exp, out = multi_sim
    r, base = out[f"edit_{mode}"], out["edit_none"]
    assert r["path"] == os.path.join(exp, "manipulate", f"{mode}_veh_0_0000.png")
    assert os.path.isfile(r["path"]) and np.isfinite(r["rgb"]).all()
    assert r["rgb"].shape == base["rgb"].shape == (8, 12, 3)
    assert np.abs(r["rgb"] - base["rgb"]).max() > 0


@pytest.mark.parametrize("tool", ["extract_mesh_multi", "extract_mesh", "extract_occgrid",
                                  "visible_grid_camera", "visible_grid_lidar_gt",
                                  "visualize_slice", "run"])
def test_the_geometry_tools_write_their_files(multi_sim, street_sim, tool):
    from neuralsim_torch.graphics import load_mesh_ply
    from neuralsim_torch.models.misc_assets import VisibleGrid
    exp, out = multi_sim if tool in ("extract_mesh_multi", "visible_grid_camera") else street_sim
    r = out[tool.replace("_multi", "")]
    if tool.startswith("extract_mesh"):
        assert r["path"] == os.path.join(exp, "mesh_res16.ply")
        v, f = load_mesh_ply(r["path"])
        np.testing.assert_array_equal(v, r["verts"])
        np.testing.assert_array_equal(f, r["faces"])
        assert len(f) > 0 and np.isfinite(v).all()
    elif tool == "extract_occgrid":
        with np.load(os.path.join(exp, "occgrid_res16.npz")) as z:
            assert set(z.files) == {"occ_corners", "sidelength", "aabb_min", "aabb_max",
                                    "voxel_size", "occ_thresh"}
            np.testing.assert_array_equal(z["occ_corners"], r["occ_corners"])
            assert 0 < len(z["occ_corners"]) < 16 ** 3
    elif tool.startswith("visible_grid"):
        assert r["path"] == os.path.join(exp, "visible_grid_res16.npz")
        vg = VisibleGrid.load(r["path"])
        assert r["voxels"] > 0 and vg.grid.sum() >= r["voxels"]
    elif tool == "visualize_slice":
        assert r["out_dir"] == os.path.join(exp, "slices") and len(r["files"]) == 9
        assert out["slice_shapes"] == [(12, 12, 3)] * 9
    else:
        assert r == 0 and os.path.isfile(os.path.join(exp, "run_occ.npz"))
        assert _png(os.path.join(exp, "slices", "axis2_0.50.png")).shape == (8, 8, 3)
