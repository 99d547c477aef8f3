"""Port parity for both evaluation tools end to end: ``evaluate_multi`` and
``eval_lidar_frames`` over the compose renderer of the ``waymo_demo_multi``
scene, against the JAX package's on the CPU, from the same parameters.

Small size: test_torch_compose_render.py's model (2 vehicles, 3 frames of
32x48, narrow encodings, a 16^3 street grid converged against the drive's
ground and handed to both), its JAX parameters with the street pretrained to
the road surface (``AssetBank.training_initialize``, 200 steps) and the
vehicle tables moved off their init, carried over through
``neuralsim_torch.bridge``; frames 0 and 2 at chunks of 512 rays; both
packages' loaders over the same frames (the port's demo sequence in memory),
so the ground truth and the road pixels are the same. The JAX LiDAR query
runs through the compose renderer frozen at each frame, as its
``main_function`` wraps it.

Tolerances (measured, as test_torch_compose_render.py's rays explain: the
street's coarse depths come from the grid's inverse CDF, summed in another
order in each package, so some rays take other samples, and the bf16 tents
step the field between such positions; a frame's scores average them).
Each frame's PSNRs within PSNR_TOL dB (measured <= 1.6e-5), SSIM within
SSIM_TOL (<= 5.5e-7), mask BCE within REL_TOL relative (<= 1.5e-4) and
accuracy within PIXELS_TOL pixels (equal); each source's visibility mass and
ground shares within MASS_TOL (<= 4.2e-7), its PSNR where it dominates
within PSNR_TOL (<= 1.9e-5), its mean depth there within REL_TOL (<= 2e-5)
and its dominant pixels within PIXELS_TOL (equal). The LiDAR: every beam a
hit in both, RMSE, MAE and the chamfer distances within LIDAR_REL relative
(measured <= 1.1e-3, the 95% trim of the predicted points: a moved sample
moves a hit point across the quantile cut). The LiDAR simulation of
``tools/render.py`` (a pandar64 cut to 8 x 64 beams on the camera at frames
0 and 2, the street alone at forward_inv_s 256) and the street's SDF on a
16^3 grid against JAX's from the same parameters, each with its limits in
its test.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel.occ_grid import OccGridState as JaxOcc
from neuralsim_tpu.dataio.dataloader import SceneDataLoader as JaxLoader
from neuralsim_tpu.renderers.buffer_compose import BufferComposeRenderer as JaxCompose
from neuralsim_tpu.scene import AssetBank as JaxBank
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.tools.eval_lidar import eval_lidar_frames as jax_eval_lidar
from neuralsim_tpu.tools.eval_multi import evaluate_multi as jax_evaluate
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.dataio.dataloader import SceneDataLoader
from neuralsim_torch.dataio.waymo_demo import demo_sequence, ground_sdf_tensor
from neuralsim_torch.tools.build import build_compose_renderer, converge_occ
from neuralsim_torch.tools.eval_lidar import ComposeLidarAdapter, eval_lidar_frames
from neuralsim_torch.tools.eval_multi import evaluate_multi
from test_torch_compose_render import CHUNK, SMALL

torch.set_num_threads(1)

FRAMES = [0, 2]
PSNR_TOL, SSIM_TOL, REL_TOL, MASS_TOL, PIXELS_TOL, LIDAR_REL = 1e-3, 1e-5, 1e-3, 1e-5, 2, 3e-3
SDF_TOL = 1e-5
CFG = copy.deepcopy(SMALL)
CFG["assetbank_cfg"]["Street"]["model_params"]["pretrain"]["n_iters"] = 200


class _JaxLidarAdapter:
    """The JAX ``eval_lidar.main_function``'s wrapper of the compose renderer,
    its query jitted (the eager query takes a minute here)."""

    def __init__(self, scene, renderer):
        self.scene, self.renderer, self.fi = scene, renderer, 0

    def set_frame(self, fi):
        self.fi = fi

    def ray_query(self, params, ro, rd, occ_states=None, **kw):
        kw = {k: v for k, v in kw.items() if k in ("with_rgb", "only_cr", "query_overrides")}
        frozen = self.scene.slice_at(self.fi)
        keys = ("depth_volume", "mask_volume")
        query = jax.jit(lambda p, o, d, occ: {k: v for k, v in self.renderer.ray_query(
            p, frozen, o, d, key=None, occ_states=occ, **kw).items() if k in keys})
        return query(params, ro, rd, occ_states)


@pytest.fixture(scope="module")
def pair():
    seq = demo_sequence(**CFG["dataset_cfg"]["params"])
    scene, bank, renderer, params = build_compose_renderer(CFG, device="cpu",
                                                           scenario=seq.scenario)
    jscene = JaxScene.load_from_scenario(seq.scenario)
    _B = CFG["assetbank_cfg"]
    jbank = JaxBank.create(_B, [jscene])
    r = CFG["renderer"]
    jr = JaxCompose.from_asset_bank(jscene, jbank, cr_class=r["cr_class"],
                                    distant_class=r["distant_class"], sky_class=r["sky_class"],
                                    hit_budget_frac=0.5, group_budget_frac=r["group_budget_frac"],
                                    max_hits_per_ray=r["max_hits_per_ray"])
    jp = jbank.training_initialize(jbank.init_params(jax.random.PRNGKey(0)),
                                   jax.random.PRNGKey(1))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    tbl = jp["Vehicle#demo_drive"]["encoding"]["table"]
    jp["Vehicle#demo_drive"]["encoding"]["table"] = \
        (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
    load_jax_params(params, jp)
    accel = renderer.accels["cr"]
    st = converge_occ(accel, accel.init_state(), ground_sdf_tensor, n=30)
    jst = JaxOcc(jnp.asarray(st.val.numpy()), jnp.asarray(st.mask.numpy()))
    return dict(scene=scene, renderer=renderer, params=params, st=st, jscene=jscene, jr=jr,
                jp=jax.tree.map(jnp.asarray, jp), jst=jst,
                loader=SceneDataLoader(scene, seq, with_lidar=True),
                jloader=JaxLoader(jscene, seq, with_lidar=True),
                cr_aabb=(np.asarray(jr.scene_models["cr"][0].space.aabb_min),
                         np.asarray(jr.scene_models["cr"][0].space.aabb_max)))


@pytest.fixture(scope="module")
def scores(pair):
    got = evaluate_multi(pair["scene"], pair["renderer"], pair["params"], pair["loader"],
                         cam_id="camera_FRONT", frames=FRAMES, rayschunk=CHUNK,
                         occ={"cr": pair["st"]})
    want = jax_evaluate(pair["jscene"], pair["jr"], pair["jp"], pair["jloader"],
                        cam_id="camera_FRONT", frames=FRAMES, rayschunk=CHUNK,
                        occ={"cr": pair["jst"]})
    return got, want


def _close(got, want, key):
    if want is None or isinstance(want, str) or key in ("frame", "n_objects"):
        assert got == want, key
    elif key.startswith("psnr"):
        assert abs(got - want) <= PSNR_TOL, (key, got, want)
    elif key == "ssim":
        assert abs(got - want) <= SSIM_TOL, (key, got, want)
    elif key in ("mask_bce", "mean_depth"):
        assert abs(got - want) <= REL_TOL * abs(want), (key, got, want)
    elif key == "mask_acc":
        assert abs(got - want) <= PIXELS_TOL / (32 * 48), (key, got, want)
    elif key == "pixels_dominant":
        assert abs(got - want) <= PIXELS_TOL, (key, got, want)
    else:
        assert abs(got - want) <= MASS_TOL, (key, got, want)


def test_frame_scores_match_jax(scores):
    got, want = scores
    for g, w in zip(got["per_frame"] + [got["mean"]], want["per_frame"] + [want["mean"]]):
        assert set(g) == set(w) >= {"psnr", "ssim", "psnr_fg", "psnr_bg", "mask_bce", "mask_acc"}
        for k in w:
            _close(g[k], w[k], k)


def test_per_source_and_class_scores_match_jax(scores):
    got, want = scores
    assert [(o["frame"], o["object"], o["class"]) for o in got["per_object"]] == \
        [(o["frame"], o["object"], o["class"]) for o in want["per_object"]]
    for g, w in zip(got["per_object"], want["per_object"]):
        assert set(g) == set(w) and "road_vis_mass" in w
        for k in w:
            _close(g[k], w[k], k)
    assert set(got["per_class"]) == set(want["per_class"]) == {"Vehicle", "street", "distant"}
    for cls, w in want["per_class"].items():
        for k in w:
            _close(got["per_class"][cls][k], w[k], k)
    assert want["per_class"]["street"]["road_vis_mass"] > 0.5     # the pretrained road


def test_lidar_scores_match_jax(pair):
    got = eval_lidar_frames(pair["scene"], ComposeLidarAdapter(pair["scene"], pair["renderer"]),
                            pair["params"], pair["loader"], frames=FRAMES,
                            occ={"cr": pair["st"]}, cr_aabb=pair["cr_aabb"])
    want = jax_eval_lidar(pair["jscene"], _JaxLidarAdapter(pair["jscene"], pair["jr"]),
                          pair["jp"], pair["jloader"], frames=FRAMES,
                          occ={"cr": pair["jst"]}, cr_aabb=pair["cr_aabb"])
    assert len(got["per_frame"]) == len(want["per_frame"]) == len(FRAMES)
    for g, w in zip(got["per_frame"] + [got["mean"]], want["per_frame"] + [want["mean"]]):
        assert set(g) == set(w)
        for k, v in w.items():
            if k in ("frame", "lidar") or k.startswith(("hit", "no_return", "miss")):
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=LIDAR_REL, err_msg=k)
    assert want["mean"]["hit_recall"] > 0.5


SIM_FRAMES = (0, 2)
SIM_LIDAR = {"n_channels": 8, "horizontal_res": 64}


@pytest.fixture(scope="module")
def simulated(pair):
    """A small surround LiDAR (8 x 64 beams) mounted on the camera at frames
    0 and 2, the street alone at forward_inv_s 256 through each package's
    render tool's pieces -> [(port's, JAX's) (rays_o, rays_d, depth, mask)]."""
    from neuralsim_tpu.scene.observers.lidars import make_lidar_generator as jax_generator
    from neuralsim_tpu.scene.observers.lidars import lidar_rays_to_world as jax_to_world
    from neuralsim_torch.tools.render import lidar_frame_rays, lidar_query
    out = []
    for fi in SIM_FRAMES:
        ro, rd = lidar_frame_rays(pair["scene"].slice_at(fi), pair["loader"], fi, "pandar64",
                                  SIM_LIDAR, "camera_FRONT", "cpu")
        depth, mask = lidar_query(pair["renderer"], pair["params"], ro, rd,
                                  frozen=pair["scene"].slice_at(0), occ={"cr": pair["st"]},
                                  forward_inv_s=256.0, rayschunk=CHUNK)
        o, d = jax_generator("pandar64", **SIM_LIDAR).get_all_rays()
        jo, jd = jax_to_world(pair["jscene"].slice_at(fi), "camera_FRONT", o, d)
        r = _JaxLidarAdapter(pair["jscene"], pair["jr"]).ray_query(
            pair["jp"], jo, jd, occ_states={"cr": pair["jst"]}, with_rgb=False, only_cr=True,
            query_overrides={"perturb": False, "forward_inv_s": 256.0})
        out.append(((ro.numpy(), rd.numpy(), depth.numpy(), mask.numpy()),
                    (np.asarray(jo), np.asarray(jd), np.asarray(r["depth_volume"]),
                     np.asarray(r["mask_volume"]))))
    return out


def test_simulated_lidar_matches_jax(simulated):
    """Beams within 1e-6 (the camera's world pose, each package's products:
    measured 6e-8); the hits (mask > 0.95, the render tool's rule) equal;
    each beam's depth within the file's LiDAR limit relative to 1 + depth,
    and its hit point's distance from JAX's too (measured <= 1.09e-3: 2 of
    512 beams a frame past 1e-4, a sample moved as on the camera rays; the
    mean 3.6e-6)."""
    from neuralsim_torch.tools.render import LIDAR_HIT
    for (ro, rd, depth, mask), (jo, jd, jdepth, jmask) in simulated:
        np.testing.assert_allclose(ro, jo, rtol=0, atol=1e-6)
        np.testing.assert_allclose(rd, jd, rtol=0, atol=1e-6)
        hit = mask > LIDAR_HIT
        np.testing.assert_array_equal(hit, jmask > LIDAR_HIT)
        assert 0.2 < hit.mean() < 1.0
        e = np.abs(depth - jdepth) / (1.0 + np.abs(jdepth))
        assert e.max() <= LIDAR_REL, e.max()
        pts, jpts = ro[hit] + depth[hit, None] * rd[hit], jo[hit] + jdepth[hit, None] * jd[hit]
        assert (np.linalg.norm(pts - jpts, axis=-1) / (1.0 + jdepth[hit])).max() <= LIDAR_REL


def test_street_sdf_grid_matches_jax(pair):
    """The street's SDF on a 16^3 grid over its box, the port's
    ``tools.extract_mesh.close_range_sdf`` against JAX's ``query_sdf`` from
    the same parameters: within SDF_TOL (float32 sums in each
    package's order over values up to 7.1; measured 2.4e-6)."""
    from neuralsim_torch.tools.extract_mesh import close_range_sdf
    field, mid, _ = pair["jr"].scene_models["cr"]
    mn, mx = pair["cr_aabb"]
    xs = [np.linspace(mn[i], mx[i], 16) for i in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    got = close_range_sdf(pair["params"], pair["renderer"].scene_models["cr"][0])(pts)
    want = np.asarray(field.query_sdf(pair["jp"][mid], jnp.asarray(pts)))
    assert got.shape == want.shape == (16 ** 3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SDF_TOL)
