"""Port parity for the scene graph of the multi-object path: the in-memory
demo scenario, the rigid-transform helpers, ``Scene.load_from_scenario`` and
``slice_at`` with their world transforms, and the camera rays, against
``neuralsim_tpu`` on the CPU.

The demo scenario is held to the JAX package's own writer and reader:
``build_demo_sequence`` into a temporary directory, then
``WaymoDataset.get_scenario``, for a small drive (3 frames of 16x24, 2
vehicles); every array must be equal, dtype and all.

Tolerances: rotations, world poses and rays 1e-6 (3x3 products in float32,
the two packages sum in another order; the demo's translations are exact
small multiples); products with random translations of ~10 units 1e-5; rays
in an object's frame 1e-5 (that frame's origin lies tens of units away).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.dataio.waymo import WaymoDataset
from neuralsim_tpu.dataio.waymo_demo import DemoDrive as JaxDrive
from neuralsim_tpu.dataio.waymo_demo import build_demo_sequence
from neuralsim_tpu.maths import transforms as jt
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.scene.observers import camera_get_all_rays as jax_all_rays
from neuralsim_tpu.scene.observers.cameras_math import get_rays as jax_get_rays
from neuralsim_torch.dataio.waymo_demo import DemoDrive, demo_scenario, ground_sdf_tensor
from neuralsim_torch.maths import transforms as pt
from neuralsim_torch.scene import Scene
from neuralsim_torch.scene.observers import camera_get_all_rays
from neuralsim_torch.scene.observers.cameras_math import get_rays

torch.set_num_threads(1)

SMALL_DRIVE = dict(n_frames=3, H=16, W=24, n_vehicles=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tree_equal(got, want, path="scenario"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


def test_demo_scenario_equals_the_written_sequence(tmp_path):
    build_demo_sequence(str(tmp_path), **SMALL_DRIVE)
    want = WaymoDataset(str(tmp_path)).get_scenario("demo_drive")
    _assert_tree_equal(demo_scenario(**SMALL_DRIVE), want)


def test_demo_drive_and_its_ground_match_jax():
    got, want = DemoDrive(8, 1.5, 3, 0), JaxDrive(8, 1.5, 3, 0)
    assert got.veh == want.veh
    p = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32) * 5.0
    for fi in (0, 5):
        np.testing.assert_array_equal(got.ego_pose(fi), want.ego_pose(fi))
        np.testing.assert_array_equal(got.sdf(p, fi), want.sdf(p, fi))
    np.testing.assert_array_equal(ground_sdf_tensor(_t(p)).numpy(), p[:, 2])


def _rigid(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jt.quat_to_rot(jnp.asarray(q, jnp.float32)))
    return R, rng.normal(size=(n, 3)).astype(np.float32) * 10.0


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    R, t = _rigid(rng, 7)
    T = np.asarray(jt.make_transform(jnp.asarray(R), jnp.asarray(t)))
    np.testing.assert_array_equal(pt.make_transform(_t(R), _t(t)).numpy(), T)
    np.testing.assert_array_equal(pt.make_transform(t=_t(t)).numpy(),
                                  np.asarray(jt.make_transform(t=jnp.asarray(t))))
    inv = pt.inverse_transform(_t(T)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jt.inverse_transform(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_allclose((_t(T) @ _t(inv)).numpy(), np.broadcast_to(np.eye(4), T.shape),
                               atol=1e-5)
    P = T[::-1].copy()
    np.testing.assert_allclose(pt.compose_transforms(_t(P), _t(T)).numpy(),
                               np.asarray(jt.compose_transforms(jnp.asarray(P), jnp.asarray(T))),
                               atol=1e-5)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(pt.apply_transform(_t(T), _t(x)).numpy(),
                               np.asarray(jt.apply_transform(jnp.asarray(T), jnp.asarray(x))),
                               atol=1e-5)
    np.testing.assert_allclose(pt.apply_rotation(_t(T), _t(x)).numpy(),
                               np.asarray(jt.apply_rotation(jnp.asarray(T), jnp.asarray(x))),
                               atol=1e-6)
    # a [K, 1, 4, 4] stack broadcast against [N, 3] points, as the renderer uses it
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    got = pt.apply_transform(_t(T)[:, None], _t(pts)).numpy()
    assert got.shape == (7, 5, 3)
    np.testing.assert_allclose(got, np.asarray(jt.apply_transform(jnp.asarray(T)[:, None],
                                                                  jnp.asarray(pts))), atol=1e-5)


@pytest.fixture(scope="module")
def scenes():
    scenario = demo_scenario(n_frames=4, H=20, W=30, n_vehicles=3)
    return Scene.load_from_scenario(scenario), JaxScene.load_from_scenario(scenario)


def test_scene_graph_matches_jax(scenes):
    got, want = scenes
    assert [n.id for n in got.nodes_topo] == [n.id for n in want.nodes_topo]
    assert [n.parent_index for n in got.nodes_topo] == [n.parent_index for n in want.nodes_topo]
    assert got.observer_ids() == list(want.observer_ids()) == ["camera_FRONT", "lidar_TOP"]
    assert got.drawable_ids() == list(want.drawable_ids()) == ["veh_0", "veh_1", "veh_2"]
    assert got.n_frames == want.n_frames == 4 and got.id == want.id == "demo_drive"
    assert got.nodes["camera_FRONT"].parent == "ego_car"
    for node in got.nodes_topo:
        jn = want.nodes[node.id]
        assert set(node.frame_data) == set(jn.frame_data), node.id
        for k, v in node.frame_data.items():
            w = np.asarray(jn.frame_data[k])
            assert v.numpy().dtype == w.dtype, (node.id, k)
            np.testing.assert_array_equal(v.numpy(), w, err_msg=f"{node.id}.{k}")


@pytest.mark.parametrize("fi", [0, 3])
def test_slice_at_world_transforms_match_jax(scenes, fi):
    got, want = scenes[0].slice_at(fi), scenes[1].slice_at(fi)
    for nid in ("ego_car", "camera_FRONT", "lidar_TOP", "veh_0", "veh_1", "veh_2"):
        np.testing.assert_allclose(got.world_transform(nid).numpy(),
                                   np.asarray(want.world_transform(nid)), atol=1e-6,
                                   err_msg=nid)
        for k in ("scale", "valid"):
            np.testing.assert_array_equal(got.data(nid)[k].numpy(),
                                          np.asarray(want.data(nid)[k]))
    # the camera rides the ego car: its pose is the car's times the mount
    cam = got.world_transform("camera_FRONT").numpy()
    ego = got.world_transform("ego_car").numpy()
    mount = got.data("camera_FRONT")["transform"].numpy()
    np.testing.assert_allclose(cam, ego @ mount, atol=1e-6)
    assert cam[0, 3] == pytest.approx(1.5 * fi + 1.2, abs=1e-5)


@pytest.mark.parametrize("fi", [0, 2])
def test_camera_rays_match_jax(scenes, fi):
    got_scene, want_scene = scenes
    frozen, jfrozen = got_scene.slice_at(fi), want_scene.slice_at(fi)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", 20, 30)
    jo, jd = jax_all_rays(jfrozen, "camera_FRONT", 20, 30)
    assert o.shape == d.shape == (600, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0, atol=1e-6)
    # the ray of the centre pixel looks along the ego car's +x
    assert float(d[10 * 30 + 15, 0]) > 0.99
    # rays in a vehicle's canonical frame
    lo, ld, dn = frozen.rays_to_node("veh_1", o, d)
    jlo, jld, jdn = jfrozen.rays_to_node("veh_1", jo, jd)
    for g, w in ((lo, jlo), (ld, jld), (dn, jdn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_opencv_rays_match_jax():
    rng = np.random.default_rng(2)
    R, t = _rigid(rng, 1)
    c2w = np.asarray(jt.make_transform(jnp.asarray(R[0]), jnp.asarray(t[0])))
    intr = np.array([[60.0, 0.5, 24.0], [0.0, 58.0, 16.0], [0.0, 0.0, 1.0]], np.float32)
    dist = np.array([-0.2, 0.05, 1e-3, -2e-3, 0.01], np.float32)
    xy = (rng.random((40, 2)) * [48.0, 32.0]).astype(np.float32)
    for model, distortion in (("pinhole", None), ("opencv", dist)):
        got = get_rays(_t(xy), _t(intr), _t(c2w), None if distortion is None else _t(distortion),
                       camera_model=model)
        want = jax_get_rays(jnp.asarray(xy), jnp.asarray(intr), jnp.asarray(c2w),
                            None if distortion is None else jnp.asarray(distortion),
                            camera_model=model)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=model)
    with pytest.raises(NotImplementedError, match="fisheye"):
        get_rays(_t(xy), _t(intr), _t(c2w), _t(dist[:4]), camera_model="fisheye")
