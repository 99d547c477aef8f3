"""Port parity for the Waymo-layout data on disk against ``neuralsim_tpu`` on
the CPU: the reader (``dataio.waymo.WaymoDataset``) and the demo drive's
writer (``dataio.waymo_demo.build_demo_sequence`` and its command line), at
2 frames of 16x24.

- A drive written by the JAX package's writer reads back equal through both
  readers: the scenario tree array by array, the images, the occupancy mask
  and the semantic masks of each kind, the LiDAR, the ``camera_list``,
  ``lidar_list`` and ``drawable_class_names`` filtering and ``scene_ids``.
- The port's writer and the JAX package's, given the same arguments, write
  the same files, the same ``.npz`` arrays, equal ``scenario.pt`` trees and
  JPEGs that decode to the same pixels.
- The port's written drive is the in-memory ``demo_sequence`` exactly in its
  scenario, masks and LiDAR; its frames are the in-memory frames within the
  JPEG's error at quality 95.

Tolerances: exact everywhere (both readers decode with the same Pillow here),
but for the JPEG's own error against the uncompressed in-memory frames: a
mean absolute error under JPEG_MEAN_ERR (measured 0.0181-0.0200 at 16x24,
where 8x8 blocks cover many edges; 6.6e-3 at the drive's 80x120) and at most
JPEG_MAX_ERR (measured 0.36).
"""
import os

import numpy as np
import pytest
import torch

from neuralsim_tpu.dataio.waymo import WaymoDataset as JaxReader
from neuralsim_tpu.dataio.waymo_demo import build_demo_sequence as jax_build
from neuralsim_torch.dataio.scene_dataset import SceneDataset
from neuralsim_torch.dataio.waymo import WaymoDataset, _keep_obs, _to_numpy_tree
from neuralsim_torch.dataio.waymo_demo import DemoSequence, build_demo_sequence, demo_sequence
from neuralsim_torch.dataio.waymo_demo import main as writer_main

DRIVE = dict(n_frames=2, H=16, W=24)
SID, CAM, LID = "demo_drive", "camera_FRONT", "lidar_TOP"
KINDS = ("all", "sky", "human", "vehicle", "dynamic")
JPEG_MEAN_ERR, JPEG_MAX_ERR = 0.025, 0.5


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"jax": a drive written by the JAX package's writer, "port": the same
    arguments through the port's writer, "cli": the port's command line}."""
    out = {k: str(tmp_path_factory.mktemp(k)) for k in ("jax", "port", "cli")}
    jax_build(out["jax"], **DRIVE)
    build_demo_sequence(out["port"], **DRIVE)
    writer_main(["--root", out["cli"], "--n_frames", "2", "--H", "16", "--W", "24"])
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_both_readers_see_the_same_scenes(roots):
    assert WaymoDataset(roots["jax"]).scene_ids() == JaxReader(roots["jax"]).scene_ids() == [SID]
    assert WaymoDataset(roots["jax"], sequences=["x"]).scene_ids() == ["x"]
    assert WaymoDataset(os.path.join(roots["jax"], "missing")).scene_ids() == []
    assert isinstance(WaymoDataset(roots["jax"]), SceneDataset)
    assert issubclass(DemoSequence, SceneDataset)


@pytest.mark.parametrize("filters", [
    {}, {"camera_list": [CAM, "camera_FRONT_LEFT", "camera_FRONT_RIGHT"], "lidar_list": [LID]},
    {"camera_list": ["camera_SIDE_LEFT"]}, {"lidar_list": ["lidar_FRONT"]}])
@pytest.mark.parametrize("classes", [None, ["Vehicle"], ["Pedestrian"]])
def test_scenario_reads_back_as_the_jax_reader_s(roots, filters, classes):
    """The scenario, array by array, with the sensor and class filters: a
    camera or LiDAR that the sequence lacks is left out, as JAX does."""
    got = WaymoDataset(roots["jax"], **filters).get_scenario(SID, drawable_class_names=classes)
    want = JaxReader(roots["jax"], **filters).get_scenario(SID, drawable_class_names=classes)
    _assert_tree_equal(got, want)
    kids = got["observers"]["ego_car"]["children"]
    assert (CAM in kids) == (CAM in filters.get("camera_list", [CAM]))
    assert (LID in kids) == (LID in filters.get("lidar_list", [LID]))
    assert len(got["objects"]) == (0 if classes == ["Pedestrian"] else 3)


@pytest.mark.parametrize("fi", range(DRIVE["n_frames"]))
def test_frames_read_back_as_the_jax_reader_s(roots, fi):
    mine, theirs = WaymoDataset(roots["jax"]), JaxReader(roots["jax"])
    img = mine.get_image(SID, CAM, fi)
    assert img.dtype == np.float32 and img.shape == (DRIVE["H"], DRIVE["W"], 3)
    np.testing.assert_array_equal(img, theirs.get_image(SID, CAM, fi))
    occ = mine.get_occupancy_mask(SID, CAM, fi)
    assert occ.dtype == np.float32
    np.testing.assert_array_equal(occ, theirs.get_occupancy_mask(SID, CAM, fi))
    for kind in KINDS:
        got, want = (r.get_semantic_mask(SID, CAM, fi, kind) for r in (mine, theirs))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=kind)
    got, want = mine.get_lidar(SID, LID, fi), theirs.get_lidar(SID, LID, fi)
    assert set(got) == set(want) == {"rays_o", "rays_d", "ranges"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for r in (mine, theirs):
        assert r.get_lidar(SID, LID, 99) is None and r.get_semantic_mask(SID, CAM, 99) is None
        assert r.get_mono_depth(SID, CAM, fi) is None and r.get_mono_normals(SID, CAM, fi) is None
    with pytest.raises(FileNotFoundError):
        mine.get_image(SID, CAM, 99)
    assert mine.get_image_wh(SID, CAM, fi) == (DRIVE["W"], DRIVE["H"])
    np.testing.assert_array_equal(mine.up_vec, theirs.up_vec)


def test_monocular_cues_read_back_as_the_jax_reader_s(tmp_path):
    """Depths and normals (``.npz``; normals also as an image) where a
    sequence has them."""
    from PIL import Image
    jax_build(str(tmp_path), **DRIVE)
    rng = np.random.default_rng(0)
    seq = tmp_path / SID
    for sub in ("depths/camera_FRONT", "normals/camera_FRONT"):
        (seq / sub).mkdir(parents=True)
    np.savez_compressed(seq / "depths/camera_FRONT/00000000.npz",
                        d=rng.uniform(1, 9, (16, 24)).astype(np.float64))
    np.savez_compressed(seq / "normals/camera_FRONT/00000000.npz",
                        n=rng.normal(size=(16, 24, 3)).astype(np.float32))
    Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).save(
        seq / "normals/camera_FRONT/00000001.png")
    mine, theirs = WaymoDataset(str(tmp_path)), JaxReader(str(tmp_path))
    for fi in (0, 1):
        for fn in ("get_mono_depth", "get_mono_normals"):
            got, want = getattr(mine, fn)(SID, CAM, fi), getattr(theirs, fn)(SID, CAM, fi)
            if want is None:
                assert got is None, (fn, fi)
            else:
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want)


def test_numpy_tree_and_sensor_filter_match_jax():
    from neuralsim_tpu.dataio.waymo import _keep_obs as jax_keep
    from neuralsim_tpu.dataio.waymo import _to_numpy_tree as jax_tree
    tree = {"a": torch.arange(3), "b": [torch.ones(2, 2), (np.zeros(1), "s")], "c": 1.5}
    _assert_tree_equal(_to_numpy_tree(tree), jax_tree(tree))
    for oid, cls in (("camera_FRONT", "Camera"), ("lidar_TOP", "RaysLidar"),
                     ("lidar_TOP", "Lidar"), ("ego_car", "EgoVehicle"), ("x", "Camera")):
        for cams, lids in ((None, None), ([CAM], None), (None, [LID]), ([], [])):
            assert _keep_obs(oid, {"class_name": cls}, cams, lids) == \
                jax_keep(oid, {"class_name": cls}, cams, lids)


@pytest.mark.parametrize("which", ["port", "cli"])
def test_the_port_s_writer_writes_what_the_jax_writer_writes(roots, which):
    """The same files; the same arrays in every ``.npz`` under the same keys;
    equal scenario trees; JPEGs that decode to the same pixels."""
    from PIL import Image
    got_root, want_root = roots[which], roots["jax"]
    names = _files(want_root)
    assert _files(got_root) == names and len(names) == 1 + 3 * DRIVE["n_frames"]
    for name in names:
        got, want = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".npz"):
            with np.load(got) as g, np.load(want) as w:
                assert g.files == w.files, name
                for k in w.files:
                    assert g[k].dtype == w[k].dtype, (name, k)
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
        elif name.endswith(".jpg"):
            np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                          np.asarray(Image.open(want)), err_msg=name)
        else:
            assert name == os.path.join(SID, "scenario.pt")
            load = lambda p: torch.load(p, map_location="cpu", weights_only=False)
            _assert_tree_equal(load(got), load(want))


def test_the_written_drive_is_the_in_memory_drive(roots):
    """Scenario, semantic ids, masks and LiDAR exactly; the frames within
    the JPEG's error of the uncompressed in-memory frames."""
    mine, mem = WaymoDataset(roots["port"]), demo_sequence(**DRIVE)
    _assert_tree_equal(mine.get_scenario(SID), mem.get_scenario(SID))
    errs = []
    for fi in range(DRIVE["n_frames"]):
        for kind in KINDS:
            np.testing.assert_array_equal(mine.get_semantic_mask(SID, CAM, fi, kind),
                                          mem.get_semantic_mask(SID, CAM, fi, kind))
        np.testing.assert_array_equal(mine.get_occupancy_mask(SID, CAM, fi),
                                      mem.get_occupancy_mask(SID, CAM, fi))
        got, want = mine.get_lidar(SID, LID, fi), mem.get_lidar(SID, LID, fi)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        err = np.abs(mine.get_image(SID, CAM, fi) - mem.get_image(SID, CAM, fi))
        errs.append((float(err.mean()), float(err.max())))
    assert all(0 < m < JPEG_MEAN_ERR and x <= JPEG_MAX_ERR for m, x in errs), errs
