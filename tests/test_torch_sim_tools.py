"""Port parity for the sensor-simulation and scene-editing modules, against
the JAX package on the CPU, from seeded numpy inputs: the synthetic LiDARs'
beams (``scene/observers/lidars.py``), the novel-view camera paths and the
mesh overlay (``tools/render.py``), marching tetrahedra and the PLY files
(``graphics/marching.py``), the visible grid (``models/misc_assets.py``),
the SDF slice image (``tools/visualize_slice.py``), the animations
(``anim/anim.py``) on the demo drive's scene, and the scene edits
(``tools/manipulate.py``).

Tolerances: the generators' directions within 1e-6 (both round the same
float64 numpy directions to float32: measured equal); the camera paths within
1e-6 absolute (the spiral, the circle: the same numpy; the interpolation's
slerp in float32 by each package's quaternion maths, measured 2.4e-7, the
spiral equal); overlay, marching, PLY, visible grid and slice images equal
(the same numpy); the animations' tracks within 1e-6 (the [T, 7] form's
rotations from each package's ``quat_to_rot``; measured equal); the edits'
world transforms within 1e-6 (a product each package sums in its own order;
measured equal), everything else equal, ``thanos`` the same nodes.
"""
import json

import numpy as np
import pytest
import torch

from neuralsim_tpu.anim import create_anim as jax_create_anim
from neuralsim_tpu.graphics.marching import export_mesh_ply as jax_export_ply
from neuralsim_tpu.graphics.marching import extract_mesh as jax_extract_mesh
from neuralsim_tpu.graphics.marching import load_mesh_ply as jax_load_ply
from neuralsim_tpu.graphics.marching import marching_tets as jax_marching
from neuralsim_tpu.models.misc_assets import VisibleGrid as JaxGrid
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.scene.observers import lidars as jax_lidars
from neuralsim_tpu.tools import manipulate as jax_manipulate
from neuralsim_tpu.tools import render as jax_render
from neuralsim_tpu.tools.visualize_slice import sdf_slice_image as jax_slice
from neuralsim_torch.anim import create_anim
from neuralsim_torch.dataio.waymo_demo import demo_scenario
from neuralsim_torch.graphics import (export_mesh_ply, export_pcl_ply, extract_mesh,
                                      load_mesh_ply, marching_tets)
from neuralsim_torch.models.misc_assets import VisibleGrid
from neuralsim_torch.scene import Scene
from neuralsim_torch.scene.observers import lidars
from neuralsim_torch.tools import manipulate, render
from neuralsim_torch.tools.visualize_slice import sdf_slice_image

GEN_ATOL = PATH_ATOL = ROT_ATOL = 1e-6
GENERATORS = [("pandar64", {}), ("pandar_qt", {}), ("pandar_xt", {}), ("hdl64", {}),
              ("vlp16", {}), ("pandar64", {"n_channels": 8, "horizontal_res": 64}),
              ("unknown_model_takes_pandar64", {}), ("solid_state", {}),
              ("rs_m1", {"res_h": 32, "res_v": 8, "fov_h_deg": 90.0}), ("risley_prism", {}),
              ("livox", {"n_points": 5000, "fov_deg": 38.4})]


def _sphere(p):
    return np.linalg.norm(p, axis=-1) - 0.6


@pytest.mark.parametrize("model,kw", GENERATORS, ids=[g[0] + str(len(g[1])) for g in GENERATORS])
def test_lidar_generators_match_jax(model, kw):
    if model.startswith("unknown"):
        got, want = lidars.SurroundLidarGenerator(model), jax_lidars.SurroundLidarGenerator(model)
    else:
        got = lidars.make_lidar_generator(model, **kw)
        want = jax_lidars.make_lidar_generator(model, **kw)
    o, d = got.get_all_rays("cpu")
    wo, wd = want.get_all_rays()
    assert d.dtype == torch.float32 and d.shape == tuple(wd.shape)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=0, atol=GEN_ATOL)
    assert not o.any() and not np.asarray(wo).any() and got.max_range == want.max_range
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown lidar_model"):
        lidars.make_lidar_generator("original")


def _poses(rng, n):
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.normal(size=3) * 5
    return out


@pytest.mark.parametrize("path", ["spherical_spiral", "small_circle", "street_view",
                                  "interpolation"])
def test_camera_paths_match_jax(path):
    rng = np.random.default_rng(3)
    c2ws = _poses(rng, 5)
    args = {"spherical_spiral": ((np.array([1.0, -2.0, 0.5]), 3.5, 7), {"n_rounds": 1.5}),
            "small_circle": ((c2ws[2], 6, 0.4), {}),
            "street_view": ((c2ws, 9), {"shift_l": 1.5, "shift_v": 0.7, "pitch_deg": 12.0}),
            "interpolation": ((c2ws, 11), {})}[path]
    got = getattr(render, f"get_path_{path}")(*args[0], **args[1])
    want = np.asarray(getattr(jax_render, f"get_path_{path}")(*args[0], **args[1]))
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PATH_ATOL)


def test_mesh_overlay_matches_jax():
    rng = np.random.default_rng(5)
    verts, faces = marching_tets(rng.normal(size=(9, 10, 11)), spacing=(0.3, 0.3, 0.3),
                                 origin=(-1.2, -1.4, 3.0))
    rgb = rng.uniform(0, 1, (24, 32, 3))
    depth = rng.uniform(2.0, 6.0, (24, 32))
    intr = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    for c2w, dep in ((np.eye(4), depth), (_poses(rng, 1)[0] * 0 + np.eye(4), None)):
        got = render.overlay_mesh(rgb, dep, verts, faces, intr, c2w, alpha=0.6)
        want = jax_render.overlay_mesh(rgb, dep, verts, faces, intr, c2w, alpha=0.6)
        np.testing.assert_array_equal(got, want)
        assert (got != rgb).any()


def test_marching_and_extract_mesh_match_jax():
    rng = np.random.default_rng(7)
    grid = rng.normal(size=(12, 9, 10)).astype(np.float32)
    for level in (0.0, 0.3):
        for g, w in zip(marching_tets(grid, level=level, origin=(1, 2, 3), spacing=(0.5, 1, 2)),
                        jax_marching(grid, level=level, origin=(1, 2, 3), spacing=(0.5, 1, 2))):
            np.testing.assert_array_equal(g, w)
    T = _poses(rng, 1)[0]
    got = extract_mesh(_sphere, aabb_min=(-1, -1, -1), aabb_max=(1, 1, 1), resolution=20,
                       chunk=1000, to_world=T)
    want = jax_extract_mesh(_sphere, aabb_min=(-1, -1, -1), aabb_max=(1, 1, 1), resolution=20,
                            chunk=1000, to_world=T)
    assert got[0].shape[0] > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ply_files_match_jax(tmp_path):
    verts, faces = extract_mesh(_sphere, aabb_min=(-1, -1, -1), aabb_max=(1, 1, 1),
                                resolution=12)
    colors = np.random.default_rng(1).uniform(0, 1, verts.shape)
    for c in (None, colors):
        export_mesh_ply(str(tmp_path / "a.ply"), verts, faces, c)
        jax_export_ply(str(tmp_path / "b.ply"), verts, faces, c)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
        for g, w in zip(load_mesh_ply(str(tmp_path / "a.ply")), jax_load_ply(str(tmp_path / "b.ply"))):
            np.testing.assert_array_equal(g, w)
    export_pcl_ply(str(tmp_path / "p.ply"), verts)
    v, f = jax_load_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(v, verts)
    assert f.shape == (0, 3)


@pytest.mark.parametrize("morphology", ["dilation", "close", "close2"])
def test_visible_grid_matches_jax(tmp_path, morphology):
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.2, 1.2, (300, 3))
    ro = rng.normal(size=(50, 3)) * 0.1
    rd = rng.normal(size=(50, 3))
    depth = rng.uniform(0.1, 1.0, 50)
    mask = rng.uniform(size=50) > 0.3
    grids = []
    for cls in (VisibleGrid, JaxGrid):
        vg = cls((-1, -1, -1), (1, 1, 1), resolution=16)
        vg.add_points(pts)
        vg.add_depth_points(ro, rd, depth, mask)
        vg.postprocess(morphology)
        grids.append(vg)
    got, want = grids
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_array_equal(got.hits, want.hits)
    probe = rng.uniform(-1.5, 1.5, (500, 3))
    np.testing.assert_array_equal(got.contains(probe), want.contains(probe))
    for g, w in zip(got.voxel_aabbs(), want.voxel_aabbs()):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.pyramid(), want.pyramid()):
        np.testing.assert_array_equal(g, w)
    got.save(str(tmp_path / "g.npz"))
    back = JaxGrid.load(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(back.grid, got.grid)
    np.testing.assert_array_equal(back.hits, got.hits)
    again = VisibleGrid.load(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(again.grid, got.grid)
    st = again.to_occ_state()
    assert st.mask.dtype == torch.bool and torch.equal(st.mask, torch.from_numpy(got.grid))
    assert float(st.frac) == pytest.approx(got.grid.mean())
    intr = np.array([[20.0, 0, 10], [0, 20.0, 8], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.0, -3.0]
    got.carve_frustum(intr, c2w, (16, 20), near=0.5, far=4.0)
    want.carve_frustum(intr, c2w, (16, 20), near=0.5, far=4.0)
    np.testing.assert_array_equal(got.grid, want.grid)
    with pytest.raises(ValueError):
        got.postprocess("open")


def test_sdf_slice_image_matches_jax():
    for axis, coord in ((0, 0.1), (1, -0.3), (2, 0.0)):
        got = sdf_slice_image(_sphere, (-1, -1, -1), (1, 1, 1), axis=axis, coord=coord, res=40)
        want = jax_slice(_sphere, (-1, -1, -1), (1, 1, 1), axis=axis, coord=coord, res=40)
        np.testing.assert_array_equal(got, want)


SCENARIO = dict(n_frames=5, H=16, W=24, n_vehicles=2, seed=0)


def _scenes(scenario=None):
    sc = scenario or demo_scenario(**SCENARIO)
    return Scene.load_from_scenario(sc), JaxScene.load_from_scenario(sc)


def _anim_forms(tmp_path):
    rng = np.random.default_rng(13)
    ego = _poses(rng, 3)                                   # shorter: the last pose held
    veh7 = np.concatenate([rng.normal(size=(7, 3)), rng.normal(size=(7, 4))], -1)
    np.savez(tmp_path / "t.npz", ego_car=ego, veh_0=veh7.astype(np.float32))
    (tmp_path / "t.json").write_text(json.dumps({"veh_1": _poses(rng, 5).tolist()}))
    return ["reverse_ego", "reverse_ego:ego_car", {"type": "reverse_ego"},
            {"type": "reverse_ego", "node_id": "veh_1"}, str(tmp_path / "t.npz"),
            str(tmp_path / "t.json"), {"type": "file", "path": str(tmp_path / "t.npz")}]


@pytest.mark.parametrize("form", range(7))
def test_every_anim_form_matches_jax_on_the_demo_scene(tmp_path, form):
    cfg = _anim_forms(tmp_path)[form]
    mine, theirs = _scenes()
    create_anim(cfg, mine).apply(mine)
    jax_create_anim(cfg, theirs).apply(theirs)
    moved = 0
    base, _ = _scenes()
    for node in theirs.nodes_topo:
        got = mine.nodes[node.id].frame_data["transform"]
        want = np.asarray(node.frame_data["transform"])
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROT_ATOL, err_msg=node.id)
        moved += not torch.equal(got, base.nodes[node.id].frame_data["transform"])
    assert moved >= 1
    for fi in range(mine.n_frames):                       # the frozen world follows
        np.testing.assert_allclose(mine.slice_at(fi).world_transform("camera_FRONT").numpy(),
                                   np.asarray(theirs.slice_at(fi).world_transform("camera_FRONT")),
                                   rtol=0, atol=1e-5)


def test_anim_default_ego_and_refusals_match_jax(tmp_path):
    sc = demo_scenario(**SCENARIO)
    sc["metas"] = {k: v for k, v in sc["metas"].items() if k != "ego_car_id"}
    mine, theirs = _scenes(sc)
    assert create_anim("reverse_ego", mine).node_id == jax_create_anim("reverse_ego", theirs).node_id \
        == "ego_car"
    assert create_anim("reverse_ego").node_id == "ego"
    for bad, err in (({"type": "spin"}, "unknown anim type"), ("x.txt", "unsupported anim")):
        with pytest.raises(ValueError, match=err):
            create_anim(bad, mine)


EDITS = [("rotate", lambda m, f: m.rotate_object(f, "veh_0", 0.9)),
         ("rotate_x", lambda m, f: m.rotate_object(f, "veh_1", -0.4, axis="x")),
         ("translate", lambda m, f: m.translate_object(f, "ego_car", [0.5, -1.0, 0.25])),
         ("scale", lambda m, f: m.scale_object(f, "veh_1", 1.7)),
         ("delete", lambda m, f: m.delete_objects(f, ["veh_0", "veh_1"])),
         ("thanos", lambda m, f: m.thanos(f, np.random.default_rng(42)))]


def _same_frozen(got, want):
    assert len(got.world) == len(want.world) == len(got.node_data)
    for g, w in zip(got.world, want.world):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for gd, wd in zip(got.node_data, want.node_data):
        assert set(gd) == set(wd)
        for k in wd:
            np.testing.assert_array_equal(np.asarray(gd[k]), np.asarray(wd[k]), err_msg=k)


@pytest.mark.parametrize("name,fn", EDITS, ids=[e[0] for e in EDITS])
def test_each_edit_matches_jax(name, fn):
    mine, theirs = _scenes()
    frozen, jfrozen = mine.slice_at(2), theirs.slice_at(2)
    got, want = fn(manipulate, frozen), fn(jax_manipulate, jfrozen)
    _same_frozen(got, want)
    _same_frozen(frozen, jfrozen)                         # the input is left as it was
    changed = [i for i, (a, b) in enumerate(zip(got.node_data, frozen.node_data))
               if any(not torch.equal(torch.as_tensor(a[k]), b[k]) for k in b)]
    changed += [i for i, (a, b) in enumerate(zip(got.world, frozen.world)) if not torch.equal(a, b)]
    assert changed
    if name == "thanos":
        killed = [n.id for n in mine.nodes_topo if not bool(got.data(n.id)["valid"])
                  and bool(frozen.data(n.id)["valid"])]
        assert len(killed) == len(mine.drawable_ids()) // 2
    got_r, want_r = (m.replicate_object(f, "veh_0", [1.0, 2.0, 0.0])
                     for m, f in ((manipulate, frozen), (jax_manipulate, jfrozen)))
    np.testing.assert_allclose(got_r[0].numpy(), np.asarray(want_r[0]), rtol=0, atol=1e-6)
