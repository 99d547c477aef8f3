"""Port parity for the data side of multi-object training: the demo drive's
sequence in memory (images, occupancy masks, LiDAR), the scene data loader
with its pixel and LiDAR samplers, the error map and its importance sampler,
the scene frozen at one frame per ray, and the camera and LiDAR lifts to
world rays, against ``neuralsim_tpu`` on the CPU.

The images, semantic ids and LiDAR ranges come from the same numpy code in
both packages and must be bit-equal. The port keeps the writer's uint8
values (over 255) without the JPEG compression that the JAX package's
writer and reader add: against the JAX reader's frames of the same drive the
port's differ by the JPEG's error only (measured at this test's 24x40: mean
1.55e-2, at most 0.349 at an edge pixel; at the config's 80x120: mean
5.7e-3, at most 0.380), while masks and ranges are equal. The samplers draw from
numpy generators with the same seeds and must give the same draws. The
frozen scene's transforms and the rays: 1e-6 (3x3 products in float32 summed
in another order), rays in an object's frame 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.dataio.dataloader import LidarSampler as JaxLidarSampler
from neuralsim_tpu.dataio.dataloader import PixelSampler as JaxPixelSampler
from neuralsim_tpu.dataio.dataloader import SceneDataLoader as JaxLoader
from neuralsim_tpu.dataio.waymo import WaymoDataset
from neuralsim_tpu.dataio.waymo_demo import DemoDrive as JaxDrive
from neuralsim_tpu.dataio.waymo_demo import build_demo_sequence
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.scene.observers import camera_get_selected_rays as jax_cam_rays
from neuralsim_tpu.scene.observers import lidar_rays_to_world as jax_lidar_rays
from neuralsim_tpu.training.error_map import ErrorMap as JaxErrorMap
from neuralsim_tpu.training.error_map import ImpSampler as JaxImpSampler
from neuralsim_torch.dataio.dataloader import LidarSampler, PixelSampler, SceneDataLoader
from neuralsim_torch.dataio.waymo_demo import (SKY_ID, DemoDrive, beams_local, camera_frame,
                                               demo_sequence, lidar_ranges)
from neuralsim_torch.scene import Scene
from neuralsim_torch.scene.observers import camera_get_selected_rays, lidar_rays_to_world
from neuralsim_torch.training.error_map import ErrorMap, ImpSampler
from neuralsim_torch.training.multi_trainer import lift_lidar_batch

torch.set_num_threads(1)

DRIVE = dict(n_frames=4, H=24, W=40, n_vehicles=3, seed=0)
JPEG_MEAN_TOL, JPEG_MAX_TOL = 2e-2, 0.45


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def seq():
    return demo_sequence(**DRIVE)


@pytest.fixture(scope="module")
def scenes(seq):
    return Scene.load_from_scenario(seq.scenario), JaxScene.load_from_scenario(seq.scenario)


def _jax_frame(drive, fi, H, W):
    """The JAX writer's arrays of one camera frame, before it quantises
    (neuralsim_tpu/dataio/waymo_demo.py build_demo_sequence)."""
    import math
    f = 0.5 * W / math.tan(math.radians(62.0) / 2)
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs_cam = np.stack([(u - intr[0, 2]) / intr[0, 0], (v - intr[1, 2]) / intr[1, 1],
                         np.ones_like(u)], -1)
    cam2ego = np.eye(4, dtype=np.float32)
    cam2ego[:3, :3] = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    cam2ego[:3, 3] = [1.2, 0.0, 0.2]
    c2w = drive.ego_pose(fi) @ cam2ego
    d = dirs_cam @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float64)
    p, _, hit = drive.trace(o, d, fi)
    return drive.shade(p, d, hit, fi), drive.semantic(p, hit, fi)


@pytest.mark.parametrize("fi", [0, 3])
def test_camera_frames_and_lidar_ranges_are_bit_equal_to_jax(fi):
    H, W = DRIVE["H"], DRIVE["W"]
    mine, theirs = DemoDrive(4, 1.5, 3, 0), JaxDrive(4, 1.5, 3, 0)
    rgb, sem = camera_frame(mine, fi, H, W)
    jrgb, jsem = _jax_frame(theirs, fi, H, W)
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_array_equal(sem, jsem)
    assert rgb.dtype == np.float32 and {0, 10, 13} <= set(np.unique(sem).tolist())
    beams = beams_local()
    lid2ego = np.eye(4, dtype=np.float32)
    lid2ego[:3, 3] = [0.0, 0.0, 0.6]
    l2w = theirs.ego_pose(fi) @ lid2ego
    dw = beams @ l2w[:3, :3].T
    _, t_l, hit_l = theirs.trace(np.broadcast_to(l2w[:3, 3], dw.shape).astype(np.float64), dw, fi)
    np.testing.assert_array_equal(lidar_ranges(mine, fi, beams),
                                  np.where(hit_l, t_l, 0.0).astype(np.float32))


def test_sequence_quantises_like_the_writer_and_masks_the_sky(seq):
    drive = DemoDrive(4, 1.5, 3, 0)
    for fi in range(DRIVE["n_frames"]):
        rgb, sem = camera_frame(drive, fi, DRIVE["H"], DRIVE["W"])
        img = seq.get_image("demo_drive", "camera_FRONT", fi)
        np.testing.assert_array_equal(
            img, (np.clip(rgb, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0)
        np.testing.assert_array_equal(seq.get_occupancy_mask("demo_drive", "camera_FRONT", fi),
                                      (sem != SKY_ID).astype(np.float32))
        ld = seq.get_lidar("demo_drive", "lidar_TOP", fi)
        assert ld["rays_d"].shape == (12 * 64, 3) and not ld["rays_o"].any()
        assert 0.3 < (ld["ranges"] > 0).mean() < 1.0


def test_sequence_against_the_jax_writer_and_reader(seq, tmp_path):
    """The JAX package's files of the same drive: the same scenario, masks
    and LiDAR; the images differ by the JPEG's error only."""
    root = build_demo_sequence(str(tmp_path), **{k: v for k, v in DRIVE.items()})
    ds = WaymoDataset(str(tmp_path))
    sid = ds.scene_ids()[0]
    assert root.endswith(sid)
    errs = []
    for fi in range(DRIVE["n_frames"]):
        errs.append(np.abs(seq.get_image(sid, "camera_FRONT", fi)
                           - ds.get_image(sid, "camera_FRONT", fi)))
        np.testing.assert_array_equal(seq.get_occupancy_mask(sid, "camera_FRONT", fi),
                                      ds.get_occupancy_mask(sid, "camera_FRONT", fi))
        for k, v in ds.get_lidar(sid, "lidar_TOP", fi).items():
            np.testing.assert_array_equal(seq.get_lidar(sid, "lidar_TOP", fi)[k], v)
    errs = np.stack(errs)
    assert errs.mean() <= JPEG_MEAN_TOL and errs.max() <= JPEG_MAX_TOL


@pytest.fixture(scope="module")
def loaders(seq, scenes):
    scene, jscene = scenes
    return (SceneDataLoader(scene, seq, with_lidar=True),
            JaxLoader(jscene, seq, with_lidar=True))


def test_loader_caches_match_jax(loaders):
    mine, theirs = loaders
    assert mine.cam_ids == theirs.cam_ids == ["camera_FRONT"]
    assert mine.lidar_ids == theirs.lidar_ids == ["lidar_TOP"]
    for key, ld in theirs.lidars.items():          # beams with no return are dropped
        assert (ld["ranges"] > 0).all()
        for k, v in ld.items():
            np.testing.assert_array_equal(mine.lidars[key][k], v)
    assert mine.image_wh("camera_FRONT") == theirs.image_wh("camera_FRONT")


@pytest.mark.parametrize("max_range,in_cams", [(20.0, False), (0.0, True)])
def test_lidar_filters_match_jax(seq, scenes, max_range, in_cams):
    kw = dict(with_lidar=True, filter_lidar_max_range=max_range, filter_lidar_in_cams=in_cams)
    mine, theirs = SceneDataLoader(scenes[0], seq, **kw), JaxLoader(scenes[1], seq, **kw)
    for key, ld in theirs.lidars.items():
        assert 0 < len(ld["ranges"]) < 12 * 64
        for k, v in ld.items():
            np.testing.assert_array_equal(mine.lidars[key][k], v)


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_pixel_sampler_with_the_error_map_draws_like_jax(loaders):
    """Uniform draws until enable_after error updates, then half from the
    error map; the same per-ray errors go into both maps."""
    mine, theirs = loaders
    H, W = DRIVE["H"], DRIVE["W"]
    imp = ImpSampler(ErrorMap(DRIVE["n_frames"], (4, 6)), frac_uniform=0.5, enable_after=2)
    jimp = JaxImpSampler(JaxErrorMap(DRIVE["n_frames"], (4, 6)), frac_uniform=0.5,
                         enable_after=2)
    ps = PixelSampler(mine, n_rays=97, seed=42, imp_sampler=imp)
    jps = JaxPixelSampler(theirs, n_rays=97, seed=42, imp_sampler=jimp, use_native=False)
    rng = np.random.default_rng(5)
    for _ in range(5):
        a, b = ps.sample(), jps.sample()
        _assert_batches_equal(a, b)
        err = rng.random(97).astype(np.float32)
        err[3] = np.nan                     # a poisoned ray is sanitised in both
        for s, raw in ((imp, a), (jimp, b)):
            s.update(raw["rays_fidx"], raw["rays_sel"][:, 1], raw["rays_sel"][:, 0], err, H, W,
                     cam_id=raw["cam_id"])
    np.testing.assert_array_equal(imp.maps["camera_FRONT"].map, jimp.maps["camera_FRONT"].map)
    assert imp.it == jimp.it == 5


def test_error_map_draws_like_jax():
    em, jem = ErrorMap(3, (5, 7)), JaxErrorMap(3, (5, 7))
    rng = np.random.default_rng(0)
    for _ in range(3):
        f = rng.integers(0, 3, 200)
        xy = rng.random((200, 2))
        e = rng.random(200)
        em.step_error_map(f, xy, e)
        jem.step_error_map(f, xy, e)
    np.testing.assert_array_equal(em.map, jem.map)
    for a, b in zip(em.sample_joint(np.random.default_rng(1), 300),
                    jem.sample_joint(np.random.default_rng(1), 300)):
        np.testing.assert_array_equal(a, b)


def test_lidar_sampler_draws_like_jax(loaders):
    mine, theirs = loaders
    ls, jls = LidarSampler(mine, n_rays=131), JaxLidarSampler(theirs, n_rays=131)
    for _ in range(4):
        _assert_batches_equal(ls.sample(), jls.sample())


def test_slice_at_a_frame_per_ray_matches_jax(scenes):
    scene, jscene = scenes
    fidx = np.random.default_rng(3).integers(0, DRIVE["n_frames"], 50)
    fr, jfr = scene.slice_at(_t(fidx).long()), jscene.slice_at(jnp.asarray(fidx))
    for nid in scene.nodes:
        np.testing.assert_allclose(fr.world_transform(nid).numpy(),
                                   np.asarray(jfr.world_transform(nid)), rtol=1e-6, atol=1e-6)
        for k in ("valid", "scale"):
            np.testing.assert_array_equal(fr.data(nid)[k].numpy(), np.asarray(jfr.data(nid)[k]))
        assert fr.world_transform(nid).shape == (50, 4, 4)
    rng = np.random.default_rng(4)
    o = rng.normal(0, 3, (50, 3)).astype(np.float32)
    d = rng.normal(0, 1, (50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for vid in ("veh_0", "veh_2"):
        got = fr.rays_to_node(vid, _t(o), _t(d))
        want = jfr.rays_to_node(vid, jnp.asarray(o), jnp.asarray(d))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_camera_and_lidar_lifts_match_jax(scenes, loaders):
    scene, jscene = scenes
    raw = PixelSampler(loaders[0], n_rays=64, seed=1).sample()
    fr = scene.slice_at(_t(raw["rays_fidx"]).long())
    jfr = jscene.slice_at(jnp.asarray(raw["rays_fidx"]))
    got = camera_get_selected_rays(fr, "camera_FRONT", _t(raw["rays_xy"]))
    want = jax_cam_rays(jfr, "camera_FRONT", jnp.asarray(raw["rays_xy"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    lb = LidarSampler(loaders[0], n_rays=64).sample()
    lifted = lift_lidar_batch(scene, {"lidar_id": lb["lidar_id"],
                                      **{k: _t(lb[k]) for k in ("rays_fidx", "rays_o_local",
                                                                "rays_d_local", "ranges")}})
    jfr = jscene.slice_at(jnp.asarray(lb["rays_fidx"]))
    want = jax_lidar_rays(jfr, "lidar_TOP", jnp.asarray(lb["rays_o_local"]),
                          jnp.asarray(lb["rays_d_local"]))
    for k, w in zip(("rays_o", "rays_d"), want):
        np.testing.assert_allclose(lifted[k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(lifted["ranges"].numpy(), lb["ranges"])
    frame_rays = lidar_rays_to_world(scene.slice_at(int(lb["rays_fidx"][0])), "lidar_TOP",
                                     _t(lb["rays_o_local"]), _t(lb["rays_d_local"]))
    for a, b in zip(frame_rays, (lifted["rays_o"], lifted["rays_d"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
