"""configs/waymo_emernerf.yaml as written, from the command line, on the demo
drive written to disk in the Waymo layout (3 frames of 16x24), on the CPU:
``tools.train.main`` for 2 iterations at narrow widths (dot overrides; the
YAML's ``WaymoDataset`` target, its three cameras of which the drive has
one, its losses and schedule kept), then ``tools.eval.main`` and
``tools.render.main`` (replay) from the exp dir. The replay writes the
frame's rgb and depth and EmerNeRF's seven channels, rendered at the frame's
time; the evaluation renders at t = 0, as JAX's does. ``scene_flow_to_rgb``
equals JAX's (both numpy) on seeded flows, to 1e-6 (the same float32
operations; NumPy's arctan2 may round an ulp apart on another build)."""
import math
import os

import numpy as np
import pytest
import torch

from neuralsim_tpu.utils.logger import scene_flow_to_rgb as jax_scene_flow_to_rgb
from neuralsim_torch.dataio.waymo_demo import build_demo_sequence
from neuralsim_torch.fields.emernerf import EmerNeRFField
from neuralsim_torch.renderers.single_volume import SingleVolumeRenderer
from neuralsim_torch.tools import eval as single_eval
from neuralsim_torch.tools import render, train
from neuralsim_torch.utils.logger import scene_flow_to_rgb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "waymo_emernerf.yaml")
N_FRAMES = 3
NARROW_ARGV = [
    "--training.num_iters=2", "--training.n_rays=32", "--training.i_log=1",
    "--training.uniform_sample_n=16",
    "--training.error_map={hw: [4, 6], frac_uniform: 0.5, enable_after: 1}",
    "--assetbank_cfg.Street.model_params.static_encoding_cfg={n_levels: 3, base_res: 4, "
    "max_res: 16, log2_hashmap_size: 10}",
    "--assetbank_cfg.Street.model_params.dynamic_permuto_cfg={n_levels: 2, base_res: 4.0, "
    "max_res: 8.0, log2_hashmap_size: 10}",
    "--assetbank_cfg.Street.model_params.geo_feat_dim=7",
    "--assetbank_cfg.Street.model_params.radiance_hidden=16",
    "--assetbank_cfg.Street.model_params.query_cfg={num_coarse: 8}",
    "--assetbank_cfg.Sky.model_params={hidden: 8}"]
CHANNELS = ("rgb", "depth", "flow_fwd", "flow_bwd", "rgb_static", "rgb_dynamic",
            "mask_static", "mask_dynamic")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The YAML trained from the command line, then eval and replay from its
    exp dir, every render_chunked call's time recorded by its caller."""
    drive = str(tmp_path_factory.mktemp("waymo"))
    build_demo_sequence(drive, n_frames=N_FRAMES, H=16, W=24)
    exp = str(tmp_path_factory.mktemp("emernerf"))
    calls = []
    orig = SingleVolumeRenderer.render_chunked

    def recorded(self, params, rays_o, rays_d, **kw):
        calls[-1][1].append(kw.get("cond"))
        return orig(self, params, rays_o, rays_d, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(SingleVolumeRenderer, "render_chunked", recorded)
    try:
        out = {}
        calls.append(("train", []))
        out["train"] = train.main(["--config", YAML, f"--exp_dir={exp}",
                                   f"--dataset_cfg.params.root={drive}", "--device=cpu"]
                                  + NARROW_ARGV)
        at = ["--resume_dir", exp, "--device=cpu"]
        calls.append(("eval", []))
        out["eval"] = single_eval.main(at + ["--eval.frames=0,2", "--eval.rayschunk=128"])
        calls.append(("replay", []))
        out["replay"] = render.main(at + ["--render.mode=replay", "--render.frames=0,2",
                                          "--render.video=false"])
        calls.append(("lidar", []))
        out["lidar"] = render.main(at + ["--render.mode=lidar", "--render.lidar_model=vlp16",
                                         "--render.lidar_params={horizontal_res: 32}",
                                         "--render.frames=1"])
    finally:
        mp.undo()
    return exp, out, dict(calls)


def test_training_runs_the_yaml_with_its_losses(run):
    exp, out, _ = run
    tr = out["train"]
    assert tr["skips_total"] == 0 and math.isfinite(tr["psnr"])
    assert tr["state"].it == 2 and tr["state"].occ is None
    field = tr["state"].params[tr["trainer"].renderer.pkey("cr")]
    assert isinstance(field, EmerNeRFField) and field.with_flow and not field.only_dynamic
    assert tr["samplers"]["pixel"].loader.cam_ids == ["camera_FRONT"]
    for rec in tr["log"]:
        for k in ("loss_rgb", "loss_mask", "loss_flow", "loss_dynamic_sparsity"):
            assert math.isfinite(rec[k]), k
    for f in ("config.json", "metrics.jsonl", "ckpts/final"):
        assert os.path.exists(os.path.join(exp, f)), f


def test_eval_scores_frames_at_time_zero(run):
    exp, out, calls = run
    ev = out["eval"]
    assert [r["frame"] for r in ev["per_frame"]] == [0, 2]
    assert all(math.isfinite(v) for v in ev["mean"].values() if v is not None)
    assert os.path.exists(os.path.join(exp, "eval", "metrics.json"))
    assert calls["eval"] and all(c is None for c in calls["eval"])
    assert calls["train"] and all(c is None for c in calls["train"])   # validation


def test_replay_writes_the_seven_channels_at_each_frame_s_time(run):
    exp, out, calls = run
    files = set(os.listdir(out["replay"]["out_dir"]))
    for fi in (0, 2):
        for ch in CHANNELS:
            assert f"{ch}_{fi:04d}.png" in files, (ch, fi)
    times = [float(c.reshape(-1)[0]) for c in calls["replay"]]
    assert [tuple(c.shape) for c in calls["replay"]] == [(1, 1), (1, 1)]
    assert times == [0.0, 1.0]


def test_lidar_simulation_runs_on_the_density_field(run):
    """The simulated LiDAR through EmerNeRF's field, which reads no inv_s (as
    JAX's ignores it), at no frame's time (JAX's lidar mode passes none)."""
    _, out, calls = run
    r = out["lidar"]
    assert r["frames"] == [1] and r["beams"] == 16 * 32 and r["points"] > 0
    with np.load(os.path.join(r["out_dir"], "lidar_0001.npz")) as z:
        assert np.isfinite(z["depth"]).all() and z["mask"].sum() == r["points"]
    assert not calls["lidar"]                # one ray_query a chunk, no render_chunked


@pytest.mark.parametrize("radius", [0.5, 2.0])
def test_scene_flow_to_rgb_matches_jax(radius):
    rng = np.random.default_rng(int(radius * 10))
    flow = rng.normal(0.0, 1.0, (40, 30, 3)).astype(np.float32)
    flow[0, :3] = 0.0
    flow[1, 0] = [1.0, 0.0, 0.0]
    got = scene_flow_to_rgb(flow, flow_max_radius=radius)
    want = jax_scene_flow_to_rgb(flow, flow_max_radius=radius)
    assert got.shape == (40, 30, 3) and np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, 0], [1.0, 1.0, 1.0])   # no flow is white
