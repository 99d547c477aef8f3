"""``configs/synthetic_multi.yaml`` in the port: the numpy copy of the
procedural two-sphere dataset (``neuralsim_torch.dataio.synthetic_multi``)
against the JAX package's, the ``SYNTHETIC_MULTI`` dict against the YAML, the
full-width model built on the CPU, and a short port-only run at narrow
widths through ``build_multi_trainer`` and ``train_multi``.

The dataset is held exactly where the two compute the same numpy in the same
order (scenario, images, masks, depths, rays and ``sample_pixels`` draws from
the same generator state); everything is numpy float64 cast to float32 on
both sides, so any difference above 1e-6 would be a porting fault.
"""
import copy

import numpy as np
import pytest
import torch

from neuralsim_tpu.config import load_config
from neuralsim_tpu.dataio.synthetic_multi import SyntheticMultiObjectDataset as JaxDataset
from neuralsim_torch import kernels
from neuralsim_torch.configs import SYNTHETIC_MULTI
from neuralsim_torch.dataio.synthetic_multi import SyntheticMultiObjectDataset
from neuralsim_torch.tools.build import (build_compose_renderer, build_multi_trainer,
                                         multi_dataset, multi_scenario, render_multi_frame)
from neuralsim_torch.tools.train_multi import train_multi

torch.set_num_threads(1)

PARAMS = {"n_frames": 4, "H": 24, "W": 32}


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_equal(g, w, f"{path}.{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)
    else:
        assert got == want, path


def test_scenario_matches_jax():
    _tree_equal(SyntheticMultiObjectDataset(**PARAMS).get_scenario(),
                JaxDataset(**PARAMS).get_scenario())


@pytest.mark.parametrize("fi", [0, 3])
def test_frames_match_jax(fi):
    got, want = SyntheticMultiObjectDataset(**PARAMS), JaxDataset(**PARAMS)
    g, w = got.render_frame(fi), want.render_frame(fi)
    _tree_equal(g, w)
    assert 0 < g["image_occupancy_mask"].mean() < 1
    np.testing.assert_array_equal(got.get_image("synthetic_multi", "camera_0", fi),
                                  want.get_image("synthetic_multi", "camera_0", fi))
    np.testing.assert_array_equal(got.get_occupancy_mask("synthetic_multi", "camera_0", fi),
                                  want.get_occupancy_mask("synthetic_multi", "camera_0", fi))
    assert got.get_lidar("synthetic_multi", "lidar", fi) is None and got.scene_ids() == \
        want.scene_ids()


def test_sample_pixels_matches_jax():
    got, want = SyntheticMultiObjectDataset(**PARAMS), JaxDataset(**PARAMS)
    _tree_equal(got.sample_pixels(np.random.default_rng(3), 200),
                want.sample_pixels(np.random.default_rng(3), 200))


def test_config_mirrors_the_yaml():
    want = load_config("configs/synthetic_multi.yaml")
    for k in ("exp_dir", "seed", "dataset_cfg", "assetbank_cfg", "renderer", "training"):
        assert SYNTHETIC_MULTI[k] == want[k], k
    assert set(SYNTHETIC_MULTI) == set(want)


def test_full_width_model_builds_on_the_cpu():
    """The YAML at full width: two spheres on one conditional model (2 dense +
    6 CP levels of 4 features to 128, F_cp 24), the street's 2 dense + 4 CP +
    2 hash levels of 2 features (2^15 rows), no grid, no distant field, a
    sky; the pair budget (K = 2) of 2,048 rows at the config's 2,048 rays."""
    scene, bank, renderer, params = build_compose_renderer(SYNTHETIC_MULTI, device="cpu")
    assert list(params) == ["Vehicle#synthetic_multi", "Street#synthetic_multi",
                            "Sky#synthetic_multi"]
    veh, street = params["Vehicle#synthetic_multi"], params["Street#synthetic_multi"]
    assert [s.typ for s in veh.encoding.specs] == ["dense"] * 2 + ["cp"] * 6
    assert (veh.encoding.cp_out_dim, veh.encoding.cp_rmax) == (24, 128)
    assert [s.typ for s in street.encoding.specs] == ["dense"] * 2 + ["cp"] * 4 + ["hash"] * 2
    assert [o.obj_id for o in renderer.objects] == ["obj_a", "obj_b"]
    assert renderer.accels == {} and set(renderer.scene_models) == {"cr", "sky"}
    assert renderer.group_budget_frac == 1.0 and renderer.max_hits_per_ray == 4
    assert renderer._pair_rows(renderer.objects, 2048) == 2048
    shapes = renderer.noise_shapes(2048)
    assert shapes["Vehicle#synthetic_multi"]["coarse"] == (2048, 24)
    assert shapes["Street#synthetic_multi"]["fine"] == [(2048, 8), (2048, 8)]
    assert multi_scenario(SYNTHETIC_MULTI)["scene_id"] == "synthetic_multi"
    assert isinstance(multi_dataset(SYNTHETIC_MULTI), SyntheticMultiObjectDataset)


NARROW = copy.deepcopy(SYNTHETIC_MULTI)
NARROW["dataset_cfg"]["params"].update(n_frames=3, H=24, W=24)
_B = NARROW["assetbank_cfg"]
_B["Vehicle"]["model_params"].update(
    z_dim=4, geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32},
    query_cfg={"num_coarse": 8, "num_fine": [4], "upsample_inv_s_factors": [1.0]})
_B["Street"]["model_params"].update(
    geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"type": "tpu_mixed", "n_levels": 5, "base_res": 4, "max_res": 64,
                  "n_feats": 2, "n_hash_levels": 1, "log2_hashmap_size": 10},
    query_cfg={"num_coarse": 8, "num_fine": [4, 4], "upsample_inv_s_factors": [1.0, 4.0]},
    pretrain={"type": "road_surface", "z_road": -0.6, "up_axis": 2, "n_iters": 5, "n_pts": 64})
_B["Sky"]["model_params"] = {"hidden": 8}
NARROW["training"].update(n_rays=128, uniform_sample_n=32, i_log=1)


def test_two_steps_and_a_frame_on_the_cpu():
    """The loop on the pixel sampler (no LiDAR): two steps, finite, the
    pair-budget group trained (its latents move), no kernel launched; then a
    frame of the trained state through the pair path's per-instance scatter."""
    kernels.reset_counts()
    out = train_multi(NARROW, 2, device="cpu")
    state, log = out["state"], out["log"]
    assert state.it == 2 and [r["it"] for r in log] == [0, 1]
    assert out["samplers"]["lidar"] is None and out["samplers"]["imp"] is None
    for r in log:
        assert np.isfinite(r["loss_total"]) and r["step_skipped"] == 0
        assert {"loss_rgb", "loss_mask", "loss_eikonal", "loss_latent"} <= set(r)
    assert not any(k.launches for k in kernels.KERNELS.values())
    lat = state.params["Vehicle#synthetic_multi"].latents
    assert int(out["trainer"].renderer.objects[1].bidx) == 1 and lat.shape == (2, 4)
    frame = render_multi_frame(out["trainer"].renderer, state.params, out["scene"], 1,
                               "camera_0", None, rayschunk=256)
    assert set(frame["per_obj"]) == {"obj_a", "obj_b", "street"}
    m = frame["mask_volume"]
    assert m.shape == (24 * 24,) and bool(torch.isfinite(frame["rgb_volume"]).all())
    assert float(m.min()) >= 0.0 and float(m.max()) <= 1.0 + 1.1e-3
    share = sum(sub["mask_volume"] for sub in frame["per_obj"].values())
    assert float((share - m).abs().max()) <= 1e-5


def test_build_multi_trainer_feeds_the_pixel_sampler():
    scene, _, trainer, state, samplers = build_multi_trainer(NARROW, device="cpu")
    raw = samplers["pixel"].sample()
    assert raw["cam_id"] == "camera_0" and raw["image_rgb"].shape == (128, 3)
    assert raw["rays_xy"].shape == (128, 2) and "image_occupancy_mask" in raw
    assert state.occ is None and scene.n_frames == 3
    noise = trainer.draw_noise("pixel", 128, torch.Generator().manual_seed(0), 0)
    assert noise["render"]["Vehicle#synthetic_multi"]["coarse"].shape == (128, 8)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_multi_trainer({**NARROW, "dataset_cfg": {"target": "x.NuScenesDataset"}},
                            device="cpu")
