"""Port parity for the whole slice: the synthetic_object render path.

A small config with the same level types as configs/synthetic_object.yaml
(2 dense, 2 stacked-CP and 2 hash levels; 16 coarse and (4, 4) fine samples;
narrow MLPs) is built in both packages, the JAX parameters are carried over
through ``neuralsim_torch.bridge``, and the port's ``ray_query`` is held to
JAX's eager ``ray_query`` on 64 rays, some of which miss the box.

Tolerance: atol 1e-4. Each kernel alone agrees to ~1e-6, but the sample
placement of each upsample stage feeds back through the field.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.dataio.synthetic import SyntheticObjectDataset as JaxRig
from neuralsim_tpu.models.assets import LoTDNeuSObj as JaxNeuSObj
from neuralsim_tpu.models.assets import SimpleSkyAsset as JaxSkyAsset
from neuralsim_tpu.renderers.single_volume import SingleVolumeRenderer as JaxRenderer
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import MIRRORED_KEYS, SYNTHETIC_OBJECT, load_config
from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
from neuralsim_torch.tools.build import build_renderer

torch.set_num_threads(1)

SMALL = copy.deepcopy(SYNTHETIC_OBJECT)
SMALL["assetbank_cfg"]["Main"]["model_params"].update(
    encoding_cfg={"type": "tpu_mixed", "n_levels": 6, "base_res": 8, "max_res": 64,
                  "n_feats": 2, "n_hash_levels": 2, "log2_hashmap_size": 10,
                  "cp_max_res": 32},
    geo_feat_dim=7, radiance_hidden=16,
    query_cfg={"num_coarse": 16, "num_fine": [4, 4], "upsample_inv_s": 64.0,
               "upsample_inv_s_factors": [1.0, 4.0]})
SMALL["assetbank_cfg"]["Sky"]["model_params"] = {"hidden": 16}
KEYS = ("mask_volume", "depth_volume", "rgb_volume", "normals_volume", "rgb_sky",
        "samples_cnt")
TOL = dict(rtol=1e-4, atol=1e-4)


def _rays():
    rig = SyntheticObjectDataset(n_frames=4, H=8, W=6)
    o, d = rig.frame_rays(1)
    rng = np.random.default_rng(0)
    o2 = rng.normal(size=(16, 3))
    o2 = 3.0 * o2 / np.linalg.norm(o2, axis=-1, keepdims=True)
    d2 = rng.normal(size=(16, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = np.concatenate([o.reshape(-1, 3), o2]).astype(np.float32)
    d = np.concatenate([d.reshape(-1, 3), d2]).astype(np.float32)
    return o, d


@pytest.fixture(scope="module")
def slice_pair():
    mp = SMALL["assetbank_cfg"]
    cr = JaxNeuSObj(mp["Main"]["model_params"])
    cr.populate()
    sky = JaxSkyAsset(mp["Sky"]["model_params"])
    sky.populate()
    jr = JaxRenderer({"cr": cr.field, "sky": sky.field}, query_cfg=cr.query_cfg)
    jp = jax.tree.map(np.asarray, jr.init(jax.random.PRNGKey(7)))
    # spread the table so the dense and hash levels move the surface too
    rng = np.random.default_rng(1)
    tbl = jp["cr"]["encoding"]["table"]
    jp["cr"]["encoding"]["table"] = (tbl + rng.normal(0, 0.05, tbl.shape)).astype(np.float32)

    renderer, params = build_renderer(SMALL, device="cpu")
    load_jax_params(params, {"Main": jp["cr"], "Sky": jp["sky"]})
    o, d = _rays()
    want = jr.ray_query(jax.tree.map(jnp.asarray, jp), jnp.asarray(o), jnp.asarray(d),
                        key=None, query_overrides={"perturb": False})
    want = {k: np.asarray(want[k]) for k in KEYS}
    return renderer, params, o, d, want


def test_ray_query_matches_jax(slice_pair):
    renderer, params, o, d, want = slice_pair
    with torch.no_grad():
        got = renderer.ray_query(params, torch.from_numpy(o), torch.from_numpy(d))
    hit = got["details_cr"]["hit"].numpy()
    assert 0 < hit.sum() < len(hit)                      # hits and misses
    assert got["mask_volume"].numpy()[hit].max() > 0.5   # a surface in view
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)


def test_render_chunked_equals_ray_query(slice_pair):
    renderer, params, o, d, _ = slice_pair
    with torch.no_grad():
        whole = renderer.ray_query(params, torch.from_numpy(o), torch.from_numpy(d))
    chunked = renderer.render_chunked(params, torch.from_numpy(o), torch.from_numpy(d),
                                      rayschunk=24)
    assert "vw" not in chunked and "details_cr" not in chunked
    for k, v in chunked.items():
        torch.testing.assert_close(v, whole[k], rtol=0, atol=0, msg=k)


def test_rig_matches_jax():
    ours = SyntheticObjectDataset(**SYNTHETIC_OBJECT["dataset_cfg"]["params"])
    ref = JaxRig(**SYNTHETIC_OBJECT["dataset_cfg"]["params"])
    np.testing.assert_array_equal(ours.c2ws, ref.c2ws)
    np.testing.assert_array_equal(ours.intr, ref.intr)
    for fi in (0, 13):
        for a, b in zip(ours.frame_rays(fi), ref.frame_rays(fi)):
            np.testing.assert_array_equal(a, b)


def test_config_dict_mirrors_yaml():
    cfg = load_config("configs/synthetic_object.yaml")
    for k in MIRRORED_KEYS:
        assert SYNTHETIC_OBJECT[k] == cfg[k], k


def test_full_width_renderer_builds_on_cpu():
    renderer, params = build_renderer(SYNTHETIC_OBJECT, device="cpu")
    enc = params["Main"].encoding
    assert enc.total_params == 133_004 and enc.out_dim == 16
    assert [s.typ for s in enc.specs] == ["cp"] * 6 + ["hash"] * 2
    assert enc.cp_rmax == 116 and enc.cp_out_dim == 12
    assert [tuple(l.W.shape) for l in params["Main"].decoder.layers] == [(16, 64), (64, 16)]
    assert [tuple(l.W.shape) for l in params["Main"].radiance.layers] == \
        [(37, 64), (64, 64), (64, 3)]
    assert [tuple(l.W.shape) for l in params["Sky"].net.layers] == \
        [(16, 32), (32, 32), (32, 3)]
    assert renderer.query_cfg["num_fine"] == [16, 16]
