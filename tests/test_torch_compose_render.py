"""Port parity for the whole multi-object slice: the compose render of the
``waymo_demo_multi`` scene (shared conditional vehicle model, street with its
occupancy grid, distant field on the street's cuboid shells, sky) through
``build_compose_renderer`` and ``render_multi_frame``, against the JAX
package's ``AssetBank`` + ``BufferComposeRenderer.render_chunked`` on the CPU.

Small size: 2 vehicles, 3 frames of 32x48, the config's structure with
narrow encodings (vehicles 2 dense + 2 CP levels of 2 features, the street 3
CP levels up to 64), 8 coarse + 4 fine object samples, 8 coarse + (4, 4)
fine street samples, 8 distant samples, a 16^3 street grid converged against
the drive's ground and handed to both as numpy; chunks of 512 rays, hit
budget 256 rows per vehicle. The JAX parameters come from
``AssetBank.init_params`` and are carried over through
``neuralsim_torch.bridge`` (the vehicle latents too); the JAX render's
``lax.map`` compiles its chunk body (its eager form takes a minute here).

Tolerances, by ray. The vehicles' shares: every ray within 2e-4 (relative,
1 + |value|; measured <= 8.9e-5): their samples are placed alike. The
street's, the distant field's and the whole frame's: the street's coarse
depths come from the grid's inverse CDF, which the two packages sum in
another order, so they differ in their last bits on most rays; the encoding's
tent weights are rounded to bf16, so the sdf steps by ~5e-4 between such
positions and the upsample stages move a sample on 10-15% of the rays.
Those rays are other estimates of the integral: at most 20% of the rays may
lie beyond 1e-4 (measured <= 15.3%), at most 3% beyond 5e-3 (<= 1.2%), and
the mean error over all rays within 2e-3 (depth 5e-3: a moved ray's depth
weighs distant depths of 1e5; measured <= 1.04e-3).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel.occ_grid import OccGridState as JaxOcc
from neuralsim_tpu.config import load_config
from neuralsim_tpu.dataio.waymo_demo import build_demo_sequence
from neuralsim_tpu.renderers.buffer_compose import BufferComposeRenderer as JaxCompose
from neuralsim_tpu.scene import AssetBank as JaxBank
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.scene.observers import camera_get_all_rays as jax_all_rays
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import WAYMO_DEMO_MULTI
from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
from neuralsim_torch.renderers.buffer_compose import BufferComposeRenderer
from neuralsim_torch.scene.observers import camera_get_all_rays
from neuralsim_torch.tools.build import (build_compose_renderer, converge_occ,
                                         render_multi_frame)

torch.set_num_threads(1)

SMALL = copy.deepcopy(WAYMO_DEMO_MULTI)
SMALL["dataset_cfg"]["params"] = {"n_frames": 3, "H": 32, "W": 48, "n_vehicles": 2, "seed": 0}
_B = SMALL["assetbank_cfg"]
_B["Vehicle"]["model_params"].update(
    z_dim=4, geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32},
    query_cfg={"num_coarse": 8, "num_fine": [4], "upsample_inv_s_factors": [1.0]})
_B["Street"]["model_params"].update(
    geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"type": "tpu_mixed", "n_levels": 3, "base_res": 16, "max_res": 64,
                  "n_feats": 2, "n_hash_levels": 0, "cp_max_res": 64},
    query_cfg={"num_coarse": 8, "num_fine": [4, 4], "upsample_inv_s": 64.0,
               "upsample_inv_s_factors": [1.0, 4.0]})
_B["Street"]["model_params"]["accel_cfg"].update(resolution=16, samples_per_voxel=1)
_B["Distant"]["model_params"].update(geo_feat_dim=4, query_cfg={"num_samples": 8})
_B["Sky"]["model_params"] = {"hidden": 8}
CHUNK, FRAMES, H, W = 512, (0, 2), 32, 48
VEHICLES = ("veh_0", "veh_1")
FRAME_KEYS = ("rgb_volume", "depth_volume", "mask_volume", "normals_volume")
SOURCE_KEYS = ("rgb_volume", "depth_volume", "mask_volume")


def _ray_errors(got, want):
    """[rays] largest error of each ray, relative to 1 + |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    e = np.abs(got - want) / (1.0 + np.abs(want))
    return e.reshape(e.shape[0], -1).max(-1)


def _assert_moved_rays_bounded(got, want, name):
    e = _ray_errors(got, want)
    assert (e > 1e-4).mean() <= 0.20, name
    assert (e > 5e-3).mean() <= 0.03, name
    assert e.mean() <= (5e-3 if "depth" in name else 2e-3), name


@pytest.fixture(scope="module")
def pair():
    scene, bank, renderer, params = build_compose_renderer(SMALL, device="cpu")
    jscene = JaxScene.load_from_scenario(demo_scenario(**SMALL["dataset_cfg"]["params"]))
    jbank = JaxBank.create(_B, [jscene])
    r = SMALL["renderer"]
    jr = JaxCompose.from_asset_bank(jscene, jbank, cr_class=r["cr_class"],
                                    distant_class=r["distant_class"], sky_class=r["sky_class"],
                                    hit_budget_frac=0.5, group_budget_frac=r["group_budget_frac"],
                                    max_hits_per_ray=r["max_hits_per_ray"])
    jp = jax.tree.map(np.asarray, jbank.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for tree in jp.values():            # move the tables off their init, so the fields vary
        if "encoding" in tree:
            tbl = tree["encoding"]["table"]
            tree["encoding"]["table"] = (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
    load_jax_params(params, jp)
    accel = renderer.accels["cr"]
    st = converge_occ(accel, accel.init_state(), ground_sdf_tensor, n=30)
    jst = JaxOcc(jnp.asarray(st.val.numpy()), jnp.asarray(st.mask.numpy()))
    return dict(scene=scene, bank=bank, renderer=renderer, params=params, st=st,
                jscene=jscene, jbank=jbank, jr=jr, jp=jax.tree.map(jnp.asarray, jp), jst=jst)


@pytest.fixture(scope="module")
def frames(pair):
    out = {}
    for fi in FRAMES:
        got = render_multi_frame(pair["renderer"], pair["params"], pair["scene"], fi,
                                 "camera_FRONT", {"cr": pair["st"]}, rayschunk=CHUNK)
        frozen = pair["jscene"].slice_at(fi)
        o, d = jax_all_rays(frozen, "camera_FRONT", H, W)
        want = pair["jr"].render_chunked(pair["jp"], frozen, o, d, rayschunk=CHUNK,
                                         query_overrides={"perturb": False},
                                         occ_states={"cr": pair["jst"]})
        out[fi] = (got, jax.tree.map(np.asarray, want))
    return out


def test_bank_and_bindings_match_jax(pair):
    assert list(pair["params"]) == list(pair["jbank"].assets) == [
        "Vehicle#demo_drive", "Street#demo_drive", "Distant#demo_drive", "Sky#demo_drive"]
    r, jr = pair["renderer"], pair["jr"]
    assert [(o.obj_id, o.model_id, o.bidx, o.query_cfg) for o in r.objects] == \
        [(o.obj_id, o.model_id, o.bidx, o.query_cfg) for o in jr.objects]
    assert {k: v[0] for k, v in r.scene_models.items()} == \
        {k: v[1] for k, v in jr.scene_models.items()}
    assert set(r.accels) == set(jr.accels) == {"cr"}
    dv, jdv = pair["params"]["Distant#demo_drive"], jr.scene_models["distant"][0]
    np.testing.assert_allclose(dv.cub_center.numpy(), np.asarray(jdv.cub_center))
    np.testing.assert_allclose(dv.cub_half.numpy(), np.asarray(jdv.cub_half))
    np.testing.assert_array_equal(pair["params"]["Vehicle#demo_drive"].latents.detach().numpy(),
                                  np.asarray(pair["jp"]["Vehicle#demo_drive"]["latents"]))
    assert 0.05 < float(r.accels["cr"].occupied_fraction(pair["st"])) < 0.95


def _vehicle_pixels(frame):
    return sum(int((frame["per_obj"][n]["mask_volume"] > 0.1).sum()) for n in VEHICLES)


def _vehicle_mass(frame):
    return sum(float(frame["per_obj"][n]["mask_volume"].sum()) for n in VEHICLES)


def _assert_vehicle_shares_match(got, want):
    assert set(got["per_obj"]) == set(want["per_obj"]) == {*VEHICLES, "street", "distant"}
    for name in VEHICLES:
        for k in SOURCE_KEYS:
            e = _ray_errors(got["per_obj"][name][k].numpy(), want["per_obj"][name][k])
            assert e.max() <= 2e-4, (name, k, e.max())


@pytest.mark.parametrize("fi", FRAMES)
def test_vehicle_shares_match_jax_on_every_ray(frames, fi):
    got, want = frames[fi]
    _assert_vehicle_shares_match(got, want)
    assert _vehicle_pixels(got) > 10          # the vehicles show


def test_a_hit_budget_that_overflows_drops_the_same_rays_as_jax(pair, frames):
    """With 32 rows a vehicle per chunk (of up to 164 rays that hit its box),
    the compaction keeps each chunk's first hits in ray order (a stable sort)
    and drops the rest."""
    kw = dict(hit_budget_frac=32 / CHUNK, group_budget_frac="auto")
    renderer = BufferComposeRenderer.from_asset_bank(pair["scene"], pair["bank"], **kw)
    jr = JaxCompose.from_asset_bank(pair["jscene"], pair["jbank"], **kw)
    frozen, jfrozen = pair["scene"].slice_at(0), pair["jscene"].slice_at(0)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", H, W)
    got = renderer.render_chunked(pair["params"], frozen, o, d, rayschunk=CHUNK,
                                  occ_states={"cr": pair["st"]})
    want = jr.render_chunked(pair["jp"], jfrozen, *jax_all_rays(jfrozen, "camera_FRONT", H, W),
                             rayschunk=CHUNK, query_overrides={"perturb": False},
                             occ_states={"cr": pair["jst"]})
    _assert_vehicle_shares_match(got, jax.tree.map(np.asarray, want))
    assert 0.1 < _vehicle_mass(got) < _vehicle_mass(frames[0][0]) - 1.0


@pytest.mark.parametrize("fi", FRAMES)
@pytest.mark.parametrize("key", FRAME_KEYS + ("rgb_sky",))
def test_frame_matches_jax(frames, fi, key):
    got, want = frames[fi]
    assert got[key].shape == want[key].shape == ((H * W, 3) if key != "depth_volume" and
                                                 key != "mask_volume" else (H * W,))
    assert torch.isfinite(got[key]).all()
    if key == "rgb_sky":
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-6)
    else:
        _assert_moved_rays_bounded(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("fi", FRAMES)
@pytest.mark.parametrize("src", ["street", "distant"])
def test_street_and_distant_shares_match_jax(frames, fi, src):
    got, want = frames[fi]
    for k in SOURCE_KEYS:
        _assert_moved_rays_bounded(got["per_obj"][src][k].numpy(), want["per_obj"][src][k],
                                   f"{src}.{k}")
    assert float(got["per_obj"][src]["mask_volume"].max()) > 0.1     # both sources show


def test_shares_sum_to_the_frame(frames):
    """The mask lies in [0, 1] up to the occlusion cap of cross_source_vw,
    which lets 1e-3 through an opaque lane."""
    for got, _ in frames.values():
        m = got["mask_volume"]
        assert float(m.min()) >= 0.0 and float(m.max()) <= 1.0 + 1.1e-3
        total = sum(sub["mask_volume"] for sub in got["per_obj"].values())
        assert float((total - m).abs().max()) <= 1e-5


def test_render_chunked_is_ray_query_chunk_by_chunk(pair):
    """The last chunk is padded to full size (so every chunk has the same
    hit budget) and the padding dropped; the rest is ray_query's output."""
    renderer, params, scene = pair["renderer"], pair["params"], pair["scene"]
    frozen = scene.slice_at(1)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", H, W)
    o, d = o[:700], d[:700]
    whole = renderer.render_chunked(params, frozen, o, d, rayschunk=CHUNK,
                                    occ_states={"cr": pair["st"]})
    pad = torch.ones((CHUNK - 188, 3))
    parts = []
    with torch.no_grad():
        for ro, rd in ((o[:512], d[:512]), (torch.cat([o[512:], pad]), torch.cat([d[512:], pad]))):
            parts.append(renderer.ray_query(params, frozen, ro, rd, occ_states={"cr": pair["st"]},
                                            return_buffer=True))
    for k in FRAME_KEYS:
        assert torch.equal(whole[k], torch.cat([p[k] for p in parts])[:700]), k
    for name, sub in whole["per_obj"].items():
        for k in SOURCE_KEYS:
            want = torch.cat([p["rendered_per_obj_in_scene"][name][k] for p in parts])[:700]
            assert torch.equal(sub[k], want), (name, k)
    buf = parts[0]["merged_buffer"]
    # 2 x 12 vehicle lanes, 16 street, 8 distant; unsorted, with each lane's weight
    assert buf["t"].shape == (512, 48) and buf["vw"].shape == (512, 48)
    assert buf["src"][0].tolist() == [0] * 12 + [1] * 12 + [2] * 16 + [3] * 8
    assert parts[0]["src_names"] == [*VEHICLES, "street", "distant"]
    obj = parts[0]["rendered_per_obj_in_scene"]
    assert parts[0]["rendered_cr"] is obj["street"] and parts[0]["rendered_dv"] is obj["distant"]


def test_training_shares_and_only_the_street(pair):
    """Without ``with_per_obj`` (the training path) only the street's and the
    distant field's shares are decomposed, and they are the same as with it."""
    renderer, params, frozen = pair["renderer"], pair["params"], pair["scene"].slice_at(0)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", H, W)
    with torch.no_grad():
        r = renderer.ray_query(params, frozen, o[:256], d[:256], occ_states={"cr": pair["st"]},
                               with_per_obj=False)
        full = renderer.ray_query(params, frozen, o[:256], d[:256], occ_states={"cr": pair["st"]})
    assert set(r["rendered_per_obj_in_scene"]) == {"street", "distant"}
    assert r["per_src"][0] is None and r["per_src"][1] is None
    for src in ("street", "distant"):
        for k in SOURCE_KEYS:
            assert torch.equal(r["rendered_per_obj_in_scene"][src][k],
                               full["rendered_per_obj_in_scene"][src][k]), (src, k)


def test_pair_budget_is_named_as_not_ported(pair):
    """The pair-budget path (group_budget_frac 1.0 on the two vehicles) is
    ported now (K11; its parity with JAX is in test_torch_pair_compact.py):
    where the budget holds every hit of the group, it renders what the exact
    per-instance path renders."""
    b, frozen = pair["bank"], pair["scene"].slice_at(0)
    pair_r = BufferComposeRenderer.from_asset_bank(pair["scene"], b, group_budget_frac=1.0)
    exact = BufferComposeRenderer.from_asset_bank(pair["scene"], b, hit_budget_frac=None)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", H, W)
    o, d = o[H * W // 2 - 32:H * W // 2 + 32], d[H * W // 2 - 32:H * W // 2 + 32]
    with torch.no_grad():
        got = pair_r.ray_query(pair["params"], frozen, o, d, occ_states={"cr": pair["st"]})
        want = exact.ray_query(pair["params"], frozen, o, d, occ_states={"cr": pair["st"]})
    vehicles = [n for n in want["src_names"] if n.startswith("veh")]
    hits = sum(int((want["rendered_per_obj_in_scene"][v]["mask_volume"] > 0).sum())
               for v in vehicles)
    assert pair_r._pair_rows(pair_r.objects, 64) == 64 and 0 < hits <= 64
    for k in FRAME_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
    for name in want["src_names"]:
        for k in SOURCE_KEYS:
            np.testing.assert_allclose(got["rendered_per_obj_in_scene"][name][k].numpy(),
                                       want["rendered_per_obj_in_scene"][name][k].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_config_mirrors_the_yaml():
    want = load_config("configs/waymo_demo_multi.yaml")
    for k in ("exp_dir", "seed", "assetbank_cfg", "renderer", "training"):
        assert WAYMO_DEMO_MULTI[k] == want[k], k
    # the dataset: the sequence that neuralsim_tpu.dataio.waymo_demo writes by default
    import inspect
    defaults = {k: p.default for k, p in inspect.signature(build_demo_sequence).parameters.items()
                if p.default is not inspect.Parameter.empty}
    params = WAYMO_DEMO_MULTI["dataset_cfg"]["params"]
    assert all(params[k] == defaults[k] for k in params) and len(params) == 5


def test_full_width_model_builds_on_the_cpu():
    """The config at full width: the vehicle LoTD (dense 8 and 13, six CP
    levels of 4 features up to 256: F_cp 24), decoder 40 -> 64 -> 16,
    radiance 32 wide; the street's 10 CP levels up to 1,024 (F_cp 40) and its
    128^3 grid; a merged buffer of 3 x 32 + 48 + 24 = 168 lanes."""
    scene, bank, renderer, params = build_compose_renderer(WAYMO_DEMO_MULTI, device="cpu")
    veh, street = params["Vehicle#demo_drive"], params["Street#demo_drive"]
    assert [(s.res, s.typ) for s in veh.encoding.specs][:3] == [(8, "dense"), (13, "dense"),
                                                                (22, "cp")]
    assert (veh.encoding.cp_out_dim, veh.encoding.cp_rmax) == (24, 256)
    assert (veh.decoder.in_dim, veh.decoder.layers[0].W.shape[1], veh.decoder.out_dim) == \
        (40, 64, 16)
    assert veh.radiance.layers[0].W.shape[1] == 32 and veh.latents.shape == (3, 8)
    assert (street.encoding.cp_out_dim, street.encoding.cp_rmax) == (40, 1024)
    assert all(s.typ == "cp" for s in street.encoding.specs)
    assert renderer.accels["cr"].res == 128 and renderer.accels["cr"].march_steps == 64
    frozen = scene.slice_at(4)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", 80, 120)
    idx = torch.arange(0, 9600, 600)
    with torch.no_grad():
        r = renderer.ray_query(params, frozen, o[idx], d[idx],
                               occ_states={"cr": renderer.accels["cr"].init_state()},
                               return_buffer=True)
    assert r["merged_buffer"]["t"].shape == (16, 168)
    assert all(torch.isfinite(r[k]).all() for k in FRAME_KEYS)
