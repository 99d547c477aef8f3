"""Port parity for StreetSurf's single-street path (configs/waymo_streetsurf.yaml
on the demo drive) against the JAX package on the CPU: the 4-D LoTD distant
field, the street box from the camera tracks, the LiDAR loss's median filter,
the per-frame appearance codes, one pixel step and one LiDAR step of the
single-scene trainer, and the tool's driver with a checkpoint and a resume.

Small size (``NARROW``): the YAML's model with its level types kept (the
street's dense, stacked-CP and hash levels, 16^3 grid; the distant field's
dense and hash levels in 4-D) at narrow widths, 3 frames of 24x32, 64 pixel
rays and 48 LiDAR beams, 8 coarse + (4, 4) fine street samples and 8 distant
samples, 32 uniform points, plus an ``ImageEmbeddings`` asset (the YAML has
none) so that the appearance codes reach the street, the distant field and
the sky. Both packages build from the same dict (the JAX tool's
``build_everything`` on the port's in-memory demo drive) and take the same
parameters (``neuralsim_torch.bridge``), batches and draws: the test replays
the JAX key tree (``compute_losses`` splits (render, uniform, eikonal), the
renderer (cr, distant), the street's grid proposal draws from the whole cr
key and the upsample stages split off it, the distant ladder draws from its
key). The JAX step is jitted (one compile a step type): the grid is at its
initial state (every voxel occupied), so its proposal has no near-empty cdf
bin whose last bits would move a sample (test_torch_bench_model.py measures
that effect on a converged grid); the eager step agrees as closely and takes
five times as long.

Tolerances. The distant field: t, alpha and rgb 1e-5 relative (t: 1 / a
lerp of inverse depths, which XLA rounds in other places; measured 1.01e-6), each
gradient leaf 1e-4 of its largest entry (float32 sums in another order). The
steps (at iteration 1,200, past the mask-entropy, sparsity and error-map
starts): each loss term 1e-4 relative (the eikonal 1e-3: it squares
``|nablas| - 1`` near zero; measured <= 7.5e-6), each gradient leaf 5e-4 of
its largest entry (measured <= 1.3e-5), the street's table 5e-3 (JAX rounds
its stacked-CP line gradient to bf16, see test_torch_lotd_grad.py; measured
1.6e-3). The median and the beams it keeps: exact (the same
floats sorted); the LiDAR loss 1e-5 relative (a mean in another order;
measured 2.9e-6).
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralsim_tpu.fields.nerf import NeRFDistantField as JaxDistant
from neuralsim_tpu.losses.core import lidar_loss as jax_lidar_loss
from neuralsim_tpu.models.assets import ImageEmbeddings as JaxEmbeddings
from neuralsim_tpu.models.assets import LoTDNeuSStreet as JaxStreet
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.tools.train import build_everything as jax_build_everything
from neuralsim_tpu.tools.train import lift_pixel_batch as jax_lift_pixel_batch
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves, occ_state_from_numpy
from neuralsim_torch.configs import WAYMO_STREETSURF, at_num_iters
from neuralsim_torch.dataio.dataloader import LidarSampler, PixelSampler
from neuralsim_torch.dataio.waymo_demo import demo_sequence
from neuralsim_torch.fields.nerf import NeRFDistantField
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.losses.core import lidar_loss, median
from neuralsim_torch.models.assets import ImageEmbeddings, LoTDNeuSStreet
from neuralsim_torch.scene import Scene
from neuralsim_torch.tools.build import build_everything
from neuralsim_torch.tools.train import (_LIDAR_KEYS, _PIXEL_KEYS, lift_pixel_batch,
                                         main_function, to_device)
from neuralsim_torch.training.multi_trainer import lift_lidar_batch
from neuralsim_torch.utils.checkpoint import STATE_FILE

torch.set_num_threads(1)

N_RAYS, N_LIDAR, N_UNIFORM, R, NS, IT0 = 64, 48, 32, 16, 8, 1200
NARROW = at_num_iters(WAYMO_STREETSURF, 3)
NARROW["dataset_cfg"]["params"] = {"n_frames": 3, "H": 24, "W": 32, "n_vehicles": 1, "seed": 0,
                                   "lidar_hw": [4, 16]}
_B = NARROW["assetbank_cfg"]
_B["Street"]["model_params"].update(
    geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"type": "tpu_mixed", "n_levels": 5, "base_res": 8, "max_res": 64, "n_feats": 2,
                  "n_hash_levels": 1, "log2_hashmap_size": 10, "cp_max_res": 64},
    query_cfg={"num_coarse": 8, "num_fine": [4, 4], "upsample_inv_s": 64.0,
               "upsample_inv_s_factors": [1.0, 4.0]},
    pretrain={"type": "road_surface", "z_road": 0.0, "up_axis": 2, "n_iters": 40,
              "n_pts": 512})
_B["Street"]["model_params"]["accel_cfg"].update(resolution=R, samples_per_voxel=1,
                                                  n_steps_between_update=2)
_B["Distant"]["model_params"].update(
    geo_feat_dim=4, encoding_cfg={"n_levels": 3, "base_res": 4, "max_res": 16,
                                  "log2_hashmap_size": 10})
_B["Sky"]["model_params"] = {"hidden": 8, "appear_embed_dim": 4}
_B["ImageEmbeddings"] = {"model_class": "neuralsim_tpu.models.assets.ImageEmbeddings",
                         "model_params": {"dim": 4}}
NARROW["renderer"]["distant_query_cfg"] = {"num_samples": NS}
NARROW["training"].update(n_rays=N_RAYS, n_rays_lidar=N_LIDAR, uniform_sample_n=N_UNIFORM,
                          i_log=1, i_val=2, val_downscale=4,
                          error_map={"hw": [4, 6], "frac_uniform": 0.5, "enable_after": 1})
LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_mask_entropy", "loss_eikonal",
          "loss_sparsity", "loss_clearance")
LIDAR_LOSSES = ("loss_total", "loss_lidar", "loss_eikonal", "loss_sparsity", "loss_clearance")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the 4-D LoTD distant field
# ---------------------------------------------------------------------------

BOX = ([-6.0, -5.0, -1.0], [9.0, 5.0, 4.0])
DIST_KW = dict(geometry="lotd", geo_feat_dim=4, radiance_hidden=16, appear_embed_dim=4,
               encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32,
                             "log2_hashmap_size": 10})


def _distant_rays(n=48, seed=3):
    """Rays that start inside the street box (some at its centre, some near a
    face, one on it) and leave it, with the near plane at the box's exit,
    as the renderer hands it to the distant field."""
    rng = np.random.default_rng(seed)
    lo, hi = np.float32(BOX[0]), np.float32(BOX[1])
    o = (lo + (hi - lo) * rng.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
    o[:4] = 0.5 * (lo + hi)
    o[4:8, 0] = hi[0] - 1e-3
    o[8, 1] = lo[1]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[4:8] = [1.0, 0.05, 0.02]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, far, _ = AABBSpace(*BOX).ray_test(_t(o), _t(d))
    return o, d, far.numpy()


@pytest.fixture(scope="module")
def distant_pair():
    jf = JaxDistant(cr_aabb=BOX, **DIST_KW)
    jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    tbl = jp["encoding"]["table"]
    jp["encoding"]["table"] = (tbl + rng.normal(0, 0.5, tbl.shape)).astype(np.float32)
    for layer in jp["decoder"]["layers"]:
        layer["b"] = rng.normal(0.0, 0.3, layer["b"].shape).astype(np.float32)
    pf = NeRFDistantField(**DIST_KW)
    load_jax_params(pf, jp)
    pf.set_cr_aabb(AABBSpace(*BOX))
    return jf, jp, pf


@pytest.mark.parametrize("noisy", [False, True])
def test_lotd_distant_ray_query_and_gradients_match_jax(distant_pair, noisy):
    jf, jp, pf = distant_pair
    o, d, near = _distant_rays()
    h = np.random.default_rng(7).normal(0, 0.3, (o.shape[0], 4)).astype(np.float32)
    key = jax.random.PRNGKey(11) if noisy else None
    w_a, w_c = (np.random.default_rng(8).normal(size=s).astype(np.float32)
                for s in ((o.shape[0], 16), (o.shape[0], 16, 3)))

    def jloss(p):
        b = jf.ray_query(p, jnp.asarray(o), jnp.asarray(d), key=key, near=jnp.asarray(near),
                         num_samples=16, h_appear=jnp.asarray(h))
        return jnp.sum(b["alpha"] * w_a) + jnp.sum(b["rgb"] * w_c), b

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, jp))
    noise = None if key is None else _t(jax.random.uniform(key, (o.shape[0], 16)))
    got = pf.ray_query(_t(o), _t(d), near=_t(near), num_samples=16, noise=noise, h_appear=_t(h))
    loss = (got["alpha"] * _t(w_a)).sum() + (got["rgb"] * _t(w_c)).sum()
    grads = dict(zip(dict(pf.named_parameters()),
                     torch.autograd.grad(loss, list(pf.parameters()))))
    np.testing.assert_allclose(got["t"].detach().numpy(), np.asarray(want["t"]), rtol=1e-5)
    for k in ("alpha", "rgb"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(got["alpha"].max()) > 0.02 and float(got["t"].max()) > 1e4
    want_g = named_jax_leaves({"f": jax.tree.map(np.asarray, jg)}, {"f": "f"})
    assert {f"f.{k}" for k in grads} == set(want_g)
    for name, g in grads.items():
        w = want_g[f"f.{name}"]
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_distant_field_without_an_appearance_code_reads_zeros(distant_pair):
    jf, jp, pf = distant_pair
    o, d, near = _distant_rays(16)
    want = jf.ray_query(jax.tree.map(jnp.asarray, jp), jnp.asarray(o), jnp.asarray(d),
                        near=jnp.asarray(near), num_samples=8)
    with torch.no_grad():
        got = pf.ray_query(_t(o), _t(d), near=_t(near), num_samples=8)
        zeros = pf.ray_query(_t(o), _t(d), near=_t(near), num_samples=8,
                             h_appear=torch.zeros(16, 4))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=1e-5, atol=1e-5)
    assert torch.equal(got["rgb"], zeros["rgb"])


# ---------------------------------------------------------------------------
# the street box, the LiDAR median filter, the appearance codes
# ---------------------------------------------------------------------------

def test_street_box_from_the_camera_tracks_matches_jax():
    seq = demo_sequence()
    mp = WAYMO_STREETSURF["assetbank_cfg"]["Street"]["model_params"]
    want = JaxStreet._aabb_from_cameras(JaxScene.load_from_scenario(seq.get_scenario()), mp)
    scene = Scene.load_from_scenario(seq.get_scenario())
    got = LoTDNeuSStreet.aabb_from_cameras(scene, mp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)
    street = LoTDNeuSStreet({**NARROW["assetbank_cfg"]["Street"]["model_params"]})
    street.populate(scene)
    np.testing.assert_allclose(street.field.space.aabb_min.numpy(), want[0], atol=1e-6)
    np.testing.assert_allclose(street.field.space.aabb_max.numpy(), want[1], atol=1e-6)
    assert np.all(np.asarray(want[1]) - np.asarray(want[0]) >= 120.0)
    assert LoTDNeuSStreet.aabb_from_cameras(Scene.load_from_scenario(
        {**seq.get_scenario(), "observers": {}}), mp) is None


@pytest.mark.parametrize("n", [8192, 8191, 48, 7])
def test_lidar_median_filter_matches_jax_at_even_and_odd_counts(n):
    rng = np.random.default_rng(n)
    ranges = rng.uniform(0.5, 150.0, n).astype(np.float32)
    ranges[: n // 10] = 0.0                                     # beams that hit nothing
    depth = (ranges + rng.normal(0, 0.5, n) * (rng.random(n) < 0.9)
             + rng.normal(0, 60.0, n) * (rng.random(n) < 0.05)).astype(np.float32)
    mask = rng.uniform(0.0, 1.0, n).astype(np.float32)
    mask[n // 10: n // 5] = 0.0
    cfg = dict(WAYMO_STREETSURF["training"]["losses"]["lidar"], line_of_sight={})
    err = np.abs(depth - ranges)
    valid = (mask > 1e-7) & (ranges > 0) & (ranges <= 120.0)
    masked = np.where(valid, err, 0.0).astype(np.float32)
    assert float(median(_t(masked))) == float(jnp.median(jnp.asarray(masked)))
    for dom in (100.0, 2.0, 1e-6):          # 1e-6: the 1e-3 floor decides
        c = {**cfg, "discard_outliers_median": dom}
        jt, jaux = jax_lidar_loss({"depth_volume": jnp.asarray(depth),
                                   "mask_volume": jnp.asarray(mask)}, jnp.asarray(ranges),
                                  2000, c)
        pt, paux = lidar_loss({"depth_volume": _t(depth), "mask_volume": _t(mask)}, _t(ranges),
                              2000, c)
        np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5)
        assert float(paux["valid_frac"]) == float(jaux["valid_frac"])
    assert float(paux["valid_frac"]) < float(valid.mean())


def test_median_averages_the_two_middle_values():
    assert float(median(torch.tensor([4.0, 1.0, 3.0, 2.0]))) == 2.5
    assert float(median(torch.tensor([5.0, 1.0, 3.0]))) == 3.0


def test_image_embeddings_lookups_and_gradients_match_jax():
    seq = demo_sequence(n_frames=5, H=8, W=8)
    jscene = JaxScene.load_from_scenario(seq.get_scenario())
    ja = JaxEmbeddings({"dim": 4})
    ja.populate(jscene)
    jp = jax.tree.map(np.asarray, ja.init(jax.random.PRNGKey(2)))
    pa = ImageEmbeddings({"dim": 4})
    pa.populate(Scene.load_from_scenario(seq.get_scenario()))
    assert pa.cam_ids == ja.cam_ids == ["camera_FRONT"] and pa.n_frames == 5
    load_jax_params(pa.field, jp)
    fidx = np.array([0, 4, 2, 2, -3, 9, 1], np.int32)          # out of range: clipped
    cot = np.random.default_rng(0).normal(size=(7, 4)).astype(np.float32)
    want = np.asarray(ja.h_appear(jp, "camera_FRONT", fidx))
    jg = jax.grad(lambda p: jnp.sum(ja.h_appear(p, "camera_FRONT", fidx) * cot))(jp)
    got = pa.h_appear(pa.field, "camera_FRONT", torch.from_numpy(fidx).long())
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.autograd.grad((got * _t(cot)).sum(), pa.field["camera_FRONT"].weight)[0]
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["camera_FRONT"]["weight"]), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# one pixel step and one LiDAR step, both packages from the same dict
# ---------------------------------------------------------------------------

def _noise(key, step_type):
    """The draws of one JAX step of ``step_type`` from its key."""
    q = NARROW["assetbank_cfg"]["Street"]["model_params"]["query_cfg"]
    n = N_RAYS if step_type == "pixel" else N_LIDAR
    k_render, k_uniform, _ = jax.random.split(key, 3)
    kcr, kdv = jax.random.split(k_render)
    noise = {"occ_proposal": jax.random.uniform(kcr, (n, q["num_coarse"])), "fine": []}
    k = kcr
    for nf in q["num_fine"]:
        sk, k = jax.random.split(k)
        noise["fine"].append(jax.random.uniform(sk, (n, nf)))
    if step_type == "pixel":
        noise["distant"] = jax.random.uniform(kdv, (n, NS))
    noise["uniform"] = jax.random.uniform(k_uniform, (N_UNIFORM, 3))
    return jax.tree.map(_t, noise)


def _from_port(tree, sd, prefix=""):
    """A JAX parameter tree of ``tree``'s structure with the port's values."""
    if isinstance(tree, dict):
        return {k: _from_port(v, sd, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_port(v, sd, f"{prefix}.{i}") for i, v in enumerate(tree)]
    return sd[prefix].detach().numpy().copy()


def make_pair():
    """Both packages built from NARROW with the same parameters: JAX's init,
    the tables moved off it, a background that shows and appearance codes
    that differ by frame, then the port's road-surface pretrain of the street
    (40 Adam steps toward z = 0, so that rays below the horizon meet the
    ground and the others the distant field), copied back into the JAX tree."""
    _, jscene, jbank, jr, jt, _ = jax_build_everything(copy.deepcopy(NARROW))
    jp = jax.tree.map(np.asarray, jbank.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for mid, tree in jp.items():
        if "encoding" in tree:          # move the tables off their init, so the fields vary
            tbl = tree["encoding"]["table"]
            tree["encoding"]["table"] = (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
        if mid.startswith("Distant"):
            for layer in tree["decoder"]["layers"]:
                layer["b"] = rng.normal(0.0, 0.3, layer["b"].shape).astype(np.float32)
        if mid.startswith("ImageEmbeddings"):
            for cam in tree.values():
                cam["weight"] = rng.normal(0, 0.3, cam["weight"].shape).astype(np.float32)
    scene, bank, renderer, trainer, state, loader = build_everything(NARROW, "cpu",
                                                                     pretrain=False)
    load_jax_params(state.params, jp)
    gen = torch.Generator().manual_seed(1)
    bank.training_initialize({mid: torch.rand(shape, generator=gen)
                              for mid, shape in bank.pretrain_shapes().items()})
    jp = _from_port(jp, dict(state.params.named_parameters()))
    js = jt.init_state(None, params=jax.tree.map(jnp.asarray, jp))
    state.occ["cr"] = occ_state_from_numpy(np.asarray(js.occ["cr"].val),
                                           np.asarray(js.occ["cr"].mask))
    state.it = IT0
    return dict(jt=jt, jp=jp, js=js, scene=scene, bank=bank, trainer=trainer, state=state,
                loader=loader)


def run_steps(pair, jitted=True):
    """One pixel step's and one LiDAR step's losses and gradients in both
    packages (the JAX step jitted, or eager)."""
    jt, trainer, state = pair["jt"], pair["trainer"], pair["state"]
    raw = PixelSampler(pair["loader"], n_rays=N_RAYS, seed=3).sample()
    lb = LidarSampler(pair["loader"], n_rays=N_LIDAR, seed=3).sample()
    lbatch = lift_lidar_batch(pair["scene"], {**to_device(lb, _LIDAR_KEYS, "cpu"),
                                              "lidar_id": lb["lidar_id"]})
    batches = {"pixel": (to_device(raw, _PIXEL_KEYS, "cpu"), raw["cam_id"]),
               "lidar": ({k: v for k, v in lbatch.items() if k != "rays_fidx"}, None)}
    out = {}
    plist = dict(state.params.named_parameters())
    jparams = jax.tree.map(jnp.asarray, pair["jp"])
    for i, (step_type, (batch, cam)) in enumerate(batches.items()):
        key = jax.random.PRNGKey(20 + i)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

        def jloss(p):
            return jt.compute_losses(p, jb, jnp.asarray(IT0), key, step_type,
                                     occ=pair["js"].occ, cam_id=cam)

        vg = jax.value_and_grad(jloss, has_aux=True)
        if jitted:
            (_, jextras), jg = jax.jit(vg)(jparams)
        else:
            with jax.disable_jit():
                (_, jextras), jg = vg(jparams)
        total, extras = trainer.compute_losses(state.params, batch, IT0,
                                               _noise(key, step_type), state.occ, step_type,
                                               cam)
        grads = torch.autograd.grad(total, list(plist.values()), allow_unused=True)
        out[step_type] = {
            "port": {"total": float(total.detach()), **{k: float(v) for k, v in extras["losses"].items()},
                     "aux": extras["aux"],
                     "grads": {k: (torch.zeros_like(p) if g is None else g)
                               for (k, p), g in zip(plist.items(), grads)}},
            "jax": {"total": float(sum(jextras["losses"].values())),
                    **{k: float(v) for k, v in jextras["losses"].items()},
                    "aux": jextras["aux"],
                    "grads": {k: np.asarray(v) for k, v in
                              named_jax_leaves(jg, {m: m for m in jg}).items()}}}
    return out


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def steps(pair):
    return run_steps(pair)


def _step_noise(key, step_type, it):
    """The draws of one JAX train step of ``step_type`` at iteration ``it``:
    compute_losses' (_noise) and, on a pixel step at the grid's cadence, the
    refresh's voxel jitter from ``fold_in(key, 7)``."""
    noise = _noise(key, step_type)
    accel = NARROW["assetbank_cfg"]["Street"]["model_params"]["accel_cfg"]
    if step_type == "pixel" and it % accel["n_steps_between_update"] == 0:
        noise["occ_update"] = {"cr": _t(jax.random.uniform(
            jax.random.fold_in(key, 7), (accel["samples_per_voxel"], R, R, R, 3)))}
    return noise


# XLA's algebraic simplifier, left on, rewrites the compiled step's sums
# whose terms cancel: the gradient of a street decoder unit that no training
# sample reaches, 2.27e-13 in JAX's own eager step and in the port, comes out
# 0, and Adam with eps 1e-15 turns such a difference into steps of ~lr apart
# (0.7 lr on that bias after three iterations, and the grid's values 8e-4
# apart where it moves the sdf); with it off, the compiled step computes
# JAX's eager arithmetic
JAX_STEP_COMPILER_OPTIONS = {"xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(scope="module")
def runs(pair):
    """Three loop iterations (a LiDAR step, then a pixel step that advances
    ``it`` and refreshes the grid on its cadence) through both packages'
    ``Trainer.train_step``, from the pair's parameters and grid with fresh
    Adam states, on the same batches and draws; JAX's train step compiled
    once a step type, under JAX_STEP_COMPILER_OPTIONS."""
    trainer, jt = pair["trainer"], pair["jt"]
    jstep, compiled = type(jt).train_step.__wrapped__, {}
    state = copy.deepcopy(pair["state"])
    state.opt = trainer.init_state(state.params).opt
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, pair["jp"]))
    jstate = jstate._replace(it=jnp.asarray(IT0, jnp.int32),
                             occ={"cr": type(pair["js"].occ["cr"])(
                                 jnp.asarray(state.occ["cr"].val.numpy()),
                                 jnp.asarray(state.occ["cr"].mask.numpy()))})
    pix = PixelSampler(pair["loader"], n_rays=N_RAYS, seed=7)
    lid = LidarSampler(pair["loader"], n_rays=N_LIDAR, seed=7)
    key = jax.random.PRNGKey(5)
    curves = []
    for _ in range(3):
        key, k_lidar, k_pixel = jax.random.split(key, 3)
        lb, raw = lid.sample(), pix.sample()
        lbatch = lift_lidar_batch(pair["scene"], {**to_device(lb, _LIDAR_KEYS, "cpu"),
                                                  "lidar_id": lb["lidar_id"]})
        for step_type, batch, cam, k in (
                ("lidar", {k: v for k, v in lbatch.items() if k != "rays_fidx"}, None, k_lidar),
                ("pixel", to_device(raw, _PIXEL_KEYS, "cpu"), raw["cam_id"], k_pixel)):
            pixel = step_type == "pixel"
            state, m = trainer.train_step(state, batch, _step_noise(k, step_type, state.it),
                                          step_type, cam, pixel)
            assert int(m["step_skipped"]) == 0
            jb = {name: jnp.asarray(v.numpy()) for name, v in batch.items()}
            if step_type not in compiled:
                compiled[step_type] = jax.jit(
                    lambda st, b, kk, s=step_type, c=cam: jstep(jt, st, b, kk, s, c, s == "pixel")
                ).lower(jstate, jb, k).compile(compiler_options=JAX_STEP_COMPILER_OPTIONS)
            jstate, jm = compiled[step_type](jstate, jb, k)
            assert int(jm["step_skipped"]) == 0
            term = "loss_rgb" if pixel else "loss_lidar"
            curves.append({name: (float(m[name]), float(jm[name]))
                           for name in ("loss_total", term)})
    return state, jstate, curves


def test_three_iterations_follow_jax(runs):
    """``it`` and every model's Adam count equal, the grid's values within
    1e-4 and its mask equal on all but 0.5% of the voxels, every parameter
    within one lr of JAX's on all but 0.5% of each leaf's entries and within
    6 lr everywhere (the multi-object test's bounds: Adam with eps 1e-15
    steps by lr * sign(g) where a gradient is tiny, and JAX's bf16 line
    gradients of the stacked CP levels flip such signs)."""
    state, jstate, curves = runs
    assert state.it == int(jstate.it) == IT0 + 3
    for mid, opt in state.opt.items():
        chain = jstate.opt_state.inner_states[mid].inner_state
        adam = next(st for st in chain if isinstance(st, optax.ScaleByAdamState))
        assert int(opt.count) == int(adam.count) == 6, mid     # both step types
    val, jval = state.occ["cr"].val.numpy(), np.asarray(jstate.occ["cr"].val)
    np.testing.assert_allclose(val, jval, atol=1e-4)
    assert np.mean(state.occ["cr"].mask.numpy() != np.asarray(jstate.occ["cr"].mask)) <= 5e-3
    want = named_jax_leaves(jax.device_get(jstate.params), {m: m for m in jstate.params})
    lrs = {mid: float(opt.lr()) for mid, opt in state.opt.items()}
    for k, p in state.params.named_parameters():
        diff = np.abs(p.detach().numpy() - np.asarray(want[k]))
        lr = lrs[k.split(".")[0]]
        assert np.mean(diff > lr) <= 5e-3 and diff.max() <= 6 * lr, (k, float(diff.max()), lr)


def test_three_iterations_loss_curve_is_jax_s(runs):
    """Each of the six steps' total loss and its main term (rgb, LiDAR)
    within the first step's 1e-4 relative of JAX's."""
    curves = runs[2]
    assert len(curves) == 6
    for i, step in enumerate(curves):
        for name, (got, want) in step.items():
            assert np.isfinite(got) and want != 0, (i, name)
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f"step {i} {name}")


@pytest.mark.parametrize("step_type,term", [("pixel", t) for t in LOSSES]
                         + [("lidar", t) for t in LIDAR_LOSSES])
def test_first_step_loss_terms_match_jax(steps, step_type, term):
    got = steps[step_type]["port"]["total" if term == "loss_total" else term]
    want = steps[step_type]["jax"]["total" if term == "loss_total" else term]
    assert np.isfinite(got) and want != 0, term
    np.testing.assert_allclose(got, want, rtol=1e-3 if term == "loss_eikonal" else 1e-4)


@pytest.mark.parametrize("step_type", ["pixel", "lidar"])
def test_first_step_gradients_match_jax_leaf_by_leaf(steps, step_type):
    got, want = steps[step_type]["port"]["grads"], steps[step_type]["jax"]["grads"]
    assert set(got) == set(want)
    zero = set()
    for name, g in got.items():
        w = want[name]
        scale = np.abs(w).max()
        if scale == 0:
            assert not g.any(), name
            zero.add(name)
            continue
        tol = 5e-3 if name == "Street#demo_drive.encoding.table" else 5e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * scale, err_msg=name)
    # ln_inv_s: the anneal has reached inv_s_final at this iteration; the LiDAR
    # step renders no rgb (no radiance net) and reaches neither the distant
    # field, the sky nor the appearance codes
    lidar_off = {n for n in got if not n.startswith("Street") or ".radiance." in n}
    assert zero == {"Street#demo_drive.ln_inv_s"} | (lidar_off if step_type == "lidar" else set())


def test_lidar_aux_and_step_shapes(steps, pair):
    aux = steps["lidar"]["port"]["aux"]
    jaux = steps["lidar"]["jax"]["aux"]
    for k in ("lidar_loss_depth", "lidar_loss_los", "lidar_valid_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    assert 0.0 < float(aux["lidar_valid_frac"]) <= 1.0
    p = steps["pixel"]["port"]["aux"]
    np.testing.assert_allclose(p["err_map"].numpy(), np.asarray(steps["pixel"]["jax"]["aux"]
                                                                ["err_map"]), rtol=1e-4,
                               atol=1e-5)


def test_pixel_batch_lifts_to_the_jax_rays(pair):
    """(frame, pixel) of camera_FRONT over mixed frames -> world rays, as the
    JAX tool's lift_pixel_batch through its own scene graph."""
    raw = PixelSampler(pair["loader"], n_rays=N_RAYS, seed=5).sample()
    got = lift_pixel_batch(pair["scene"], to_device(raw, _PIXEL_KEYS, "cpu"), raw["cam_id"])
    jscene = JaxScene.load_from_scenario(pair["loader"].dataset.get_scenario())
    want = jax_lift_pixel_batch(jscene, raw)
    assert len(np.unique(raw["rays_fidx"])) > 1
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_build_everything_binds_the_roles_as_the_jax_tool(pair):
    tr = pair["trainer"]
    r = tr.renderer
    assert r.param_keys == {"cr": "Street#demo_drive", "distant": "Distant#demo_drive",
                            "sky": "Sky#demo_drive"}
    assert set(r.accels) == {"cr"} and r.distant_query_cfg == {"num_samples": NS}
    emb, mid = tr.embed_model
    assert mid == "ImageEmbeddings#demo_drive" and emb.cam_ids == ["camera_FRONT"]
    dv = pair["state"].params["Distant#demo_drive"]
    street = pair["state"].params["Street#demo_drive"]
    np.testing.assert_allclose(dv.cub_center.numpy(), street.space.center.numpy())
    assert dv.encoding.input_dim == 4
    noise = tr.draw_noise(N_LIDAR, torch.Generator().manual_seed(0), IT0, "lidar")
    assert "distant" not in noise and "occ_update" not in noise
    noise = tr.draw_noise(N_RAYS, torch.Generator().manual_seed(0), IT0, "pixel")
    assert noise["distant"].shape == (N_RAYS, NS) and "occ_update" in noise


# ---------------------------------------------------------------------------
# the driver: 3 iterations, a checkpoint, a resume
# ---------------------------------------------------------------------------

def _cfg(exp, n, **kw):
    """NARROW for ``n`` iterations into ``exp``; the street's learning-rate
    decay spans 5 iterations whatever ``n`` (a run resumed toward 5 and an
    unbroken one of 5 take the same schedule)."""
    cfg = {**copy.deepcopy(NARROW), "exp_dir": str(exp),
           "training": {**NARROW["training"], "num_iters": n}, **kw}
    cfg["assetbank_cfg"]["Street"]["asset_params"]["training_cfg"]["total_steps"] = 5
    return cfg


def test_main_function_trains_saves_and_resumes(tmp_path):
    """3 iterations of a LiDAR and a pixel step each into an exp dir (the
    config as JSON, metrics, stats, the scenario, the final checkpoint), a
    validation frame, and a run resumed from that exp dir that takes the 4th
    and 5th iterations as an unbroken 5-iteration run does, bit for bit."""
    out = main_function(_cfg(tmp_path / "a", 3), device="cpu")
    exp = tmp_path / "a"
    assert {"config.json", "metrics.jsonl", "stats.p", "ckpts", "scenarios"} <= \
        set(os.listdir(exp))
    assert os.path.isfile(exp / "ckpts" / "final" / STATE_FILE)
    assert os.listdir(exp / "scenarios") == ["demo_drive.pkl"]
    with open(exp / "config.json") as f:
        assert json.load(f)["training"]["num_iters"] == 3
    assert out["state"].it == 3 and out["skips_total"] == 0 and np.isfinite(out["psnr"])
    assert [r["it"] for r in out["log"]] == [0, 1, 2]
    for r in out["log"]:
        assert np.isfinite(r["loss_total"]) and np.isfinite(r["lidar/loss_lidar"])
    whole = main_function(_cfg(tmp_path / "whole", 5), device="cpu")
    resumed = main_function(_cfg(tmp_path / "b", 5, resume_dir=str(exp)), device="cpu")
    assert [r["it"] for r in resumed["log"]] == [3, 4]
    assert resumed["log"] == whole["log"][3:]
    sd_w, sd_r = whole["state"].params.state_dict(), resumed["state"].params.state_dict()
    for k, v in sd_w.items():
        assert torch.equal(v, sd_r[k]), k


@pytest.mark.parametrize("key", ["backup_codebase", "training.data_parallel",
                                 "training.frame_sample_mode", "training.image_patch",
                                 "training.view"])
def test_driver_refuses_what_is_not_ported(tmp_path, key):
    cfg = _cfg(tmp_path / "x", 1)
    node = cfg
    *head, last = key.split(".")
    for k in head:
        node = node[k]
    node[last] = {"every": 2} if last in ("image_patch", "view") else True
    with pytest.raises(NotImplementedError, match=key):
        main_function(cfg, device="cpu")


def test_only_the_demo_drive_is_a_dataset(tmp_path):
    """The single-scene build reads the demo drive, in memory or written in
    the Waymo layout (``WaymoDataset``, tests/test_torch_waymo_cli.py); any
    other dataset, and the multi-object path's scenario alone, raise."""
    for target in ("neuralsim_tpu.dataio.ad_datasets.NuScenesDataset", "x.demo_scenario"):
        cfg = _cfg(tmp_path / "y", 1)
        cfg["dataset_cfg"] = {"target": target, "params": {}}
        with pytest.raises(NotImplementedError, match=target):
            build_everything(cfg, "cpu")
