"""Port parity for the modules of the multi-object compose path, one by one,
against ``neuralsim_tpu`` on the CPU: the conditional LoTD NeuS field of the
shared vehicle model (sdf, nablas and features with a per-point instance
index; its ray query runs in test_torch_compose_render.py), the
inverted-cuboid contraction and the distant field that uses it, the
order-free composite ``cross_source_vw`` (the plain version behind the K8
kernel), the sort-free ``merge_and_integrate`` with per-source shares, the
instance segmentation, and the assets that the multi-object config builds.

Inputs come from numpy seeds; JAX parameters are carried over through
``neuralsim_torch.bridge``.

Tolerances: the contraction 1e-6; ``cross_source_vw`` 1e-6 (a sum of up to
L float32 logs, in another order); the merge's sums 1e-5; the field's sdf and
features 1e-5, its nablas 1e-5 of their largest entry (the jacobian's bf16
taps are summed in another order than JAX's tent matmul).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.conditional import ConditionalLoTDNeuSField as JaxCondField
from neuralsim_tpu.fields.nerf import NeRFDistantField as JaxDistant
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_tpu.fields.spatial import contract_inverted_cuboid as jax_cuboid
from neuralsim_tpu.models import assets as jax_assets
from neuralsim_tpu.ops.segment import alpha_to_vw as jax_alpha_to_vw
from neuralsim_tpu.ops.segment import cross_source_vw as jax_cross_source_vw
from neuralsim_tpu.renderers.buffer_compose import \
    render_instance_segmentation as jax_segmentation
from neuralsim_tpu.renderers.buffers import merge_and_integrate as jax_merge
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import WAYMO_DEMO_MULTI
from neuralsim_torch.dataio.waymo_demo import demo_scenario
from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
from neuralsim_torch.fields.nerf import NeRFDistantField
from neuralsim_torch.fields.spatial import AABBSpace, contract_inverted_cuboid
from neuralsim_torch.models.assets import asset_class
from neuralsim_torch.ops.segment import cross_source_vw, cross_source_vw_plain
from neuralsim_torch.renderers.buffer_compose import render_instance_segmentation
from neuralsim_torch.renderers.buffers import merge_and_integrate
from neuralsim_torch.scene import Scene

torch.set_num_threads(1)

ENC = {"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32}
STREET_BOX = WAYMO_DEMO_MULTI["assetbank_cfg"]["Street"]["model_params"]["aabb"]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The conditional field of the shared vehicle model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cond_pair():
    box = ([-1.0, -0.5, -0.8], [1.0, 0.5, 0.8])
    kw = dict(n_instances=3, z_dim=4, encoding_cfg=ENC, geo_feat_dim=5, radiance_hidden=8,
              ln_inv_s_init=float(np.log(30.0)))
    jf = JaxCondField(JaxSpace(*box), **kw)
    jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tbl = jp["encoding"]["table"]
    jp["encoding"]["table"] = (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
    jp["latents"] = rng.normal(0, 0.5, jp["latents"].shape).astype(np.float32)
    pf = ConditionalLoTDNeuSField(AABBSpace(*box), **kw)
    load_jax_params(pf, jp)
    return jf, jax.tree.map(jnp.asarray, jp), pf


def test_conditional_field_layout_matches_jax(cond_pair):
    jf, jp, pf = cond_pair
    assert [(s.res, s.typ) for s in pf.encoding.specs] == [(s.res, s.typ) for s in jf.encoding.specs]
    assert [s.typ for s in pf.encoding.specs] == ["dense", "dense", "cp", "cp"]
    assert pf.decoder.in_dim == pf.encoding.out_dim + 4 == 12 and pf.latents.shape == (3, 4)
    assert pf._geo_init_bias == jf._geo_init_bias == 0.4
    names = {n for n, _ in pf.named_parameters()}
    assert "latents" in names and "encoding.table" in names


@pytest.mark.parametrize("with_bidx", [True, False], ids=["bidx", "no-bidx"])
def test_conditional_sdf_nablas_feat_match_jax(cond_pair, with_bidx):
    jf, jp, pf = cond_pair
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32)
    bidx = rng.integers(-1, 5, 200) if with_bidx else None      # -1 and 3, 4 are clamped
    jb = None if bidx is None else jnp.asarray(bidx, jnp.int32)
    tb = None if bidx is None else _t(bidx)
    sdf, nablas, feat = pf.sdf_nablas_feat(_t(x), bidx=tb)
    jsdf, jnab, jfeat = jf.sdf_nablas_feat(jp, jnp.asarray(x), bidx=jb)
    np.testing.assert_allclose(sdf.detach().numpy(), np.asarray(jsdf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-5)
    jnab = np.asarray(jnab)
    np.testing.assert_allclose(nablas.detach().numpy(), jnab, rtol=0,
                               atol=1e-5 * np.abs(jnab).max())
    s2, f2 = pf.query_sdf_feat(_t(x), bidx=tb)
    j2, jf2 = jf.query_sdf_feat(jp, jnp.asarray(x), bidx=jb)
    np.testing.assert_allclose(s2.detach().numpy(), np.asarray(j2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f2.detach().numpy(), np.asarray(jf2), rtol=1e-5, atol=1e-5)
    if with_bidx:      # the latent changes the field
        other = pf.query_sdf(_t(x), bidx=torch.zeros(200, dtype=torch.long))
        assert float((other - s2).abs().max().detach()) > 1e-3


# ---------------------------------------------------------------------------
# The distant field's inverted-cuboid contraction
# ---------------------------------------------------------------------------

def test_contract_inverted_cuboid_matches_jax():
    rng = np.random.default_rng(3)
    c, h = np.array([33.5, 0.0, 3.1], np.float32), np.array([41.5, 35.0, 3.9], np.float32)
    x = (c + h * rng.normal(size=(600, 3)) * rng.choice([0.2, 1.0, 30.0], (600, 1))
         ).astype(np.float32)
    x[0] = c                                                    # the centre: rho = 0
    got = contract_inverted_cuboid(_t(x), _t(c), _t(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_cuboid(jnp.asarray(x), jnp.asarray(c),
                                                          jnp.asarray(h))), rtol=1e-6, atol=1e-6)
    inside = np.abs((x - c) / h).max(-1) < 1.0
    assert inside.sum() > 50 and (got[inside, 3] == 1.0).all()  # inside lands on the shell
    np.testing.assert_allclose(np.abs(got[1:, :3]).max(-1), 1.0, atol=1e-6)


def test_distant_field_on_the_street_box_matches_jax():
    kw = dict(geometry="mlp", geo_feat_dim=4, decoder_hidden=16, radiance_hidden=8)
    jf = JaxDistant(cr_aabb=STREET_BOX, **kw)
    jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(4)))
    pf = NeRFDistantField(**kw)
    assert pf.cub_center is None
    pf.set_cr_aabb(AABBSpace(*STREET_BOX))
    load_jax_params(pf, jp)
    np.testing.assert_allclose(pf.cub_center.numpy(), np.asarray(jf.cub_center))
    np.testing.assert_allclose(pf.cub_half.numpy(), np.asarray(jf.cub_half))
    x = (np.random.default_rng(5).normal(size=(300, 3)) * 80.0).astype(np.float32)
    sigma, feat = pf.query_density_feat(_t(x))
    jsigma, jfeat = jf.query_density_feat(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-5)
    # the box moves with the field, and a pair of corners sets it too
    assert "cub_center" not in dict(pf.named_parameters())
    pf2 = NeRFDistantField(cr_aabb=STREET_BOX, **kw)
    assert torch.equal(pf2.cub_half, pf.cub_half)


# ---------------------------------------------------------------------------
# K8's plain version and the sort-free merge
# ---------------------------------------------------------------------------

def _unsorted_buffer(n, L, seed):
    """Depths in no order, ties (equal depths, in and across sources), masked
    lanes anywhere (and all-masked rays), alphas of 0, 1 and near 1."""
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, 40, (n, L)) / 8.0).astype(np.float32)
    alpha = (rng.random((n, L)) ** 3).astype(np.float32)
    alpha[:, ::7] = 1.0
    alpha[:, 3::11] = 0.9995
    alpha[:, 5::13] = 0.0
    alpha[1, :] = 1.2                                     # clipped to 1
    mask = rng.random((n, L)) > 0.25
    mask[2] = False
    return t, mask, alpha


@pytest.mark.parametrize("L", [5, 37, 168])
def test_cross_source_vw_matches_jax(L):
    t, mask, alpha = _unsorted_buffer(64, L, L)
    got = cross_source_vw(_t(t), _t(mask), _t(alpha)).numpy()
    want = np.asarray(jax_cross_source_vw(jnp.asarray(t), jnp.asarray(mask), jnp.asarray(alpha)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[~mask] == 0).all() and (got[2] == 0).all()


def _tied_buffer(n, L, seed):
    """:func:`_unsorted_buffer` with depths of four values, -0.0 and +0.0
    among them (-0.0 beside +0.0 in every ray), so that every source's lanes
    tie with the others'."""
    t, mask, alpha = _unsorted_buffer(n, L, seed)
    t = np.random.default_rng(seed).choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), (n, L))
    t[:, 0], t[:, -1] = -0.0, 0.0
    mask[:, 0] = mask[:, -1] = True
    return t, mask, alpha


@pytest.mark.parametrize("L", [24, 168])
def test_cross_source_vw_ties_match_jax(L):
    """Signed zeros and equal depths across sources: the float compare ties
    -0.0 with +0.0 in both packages, and lanes go by index."""
    t, mask, alpha = _tied_buffer(48, L, L)
    got = cross_source_vw(_t(t), _t(mask), _t(alpha)).numpy()
    want = np.asarray(jax_cross_source_vw(jnp.asarray(t), jnp.asarray(mask), jnp.asarray(alpha)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    a = _t(alpha).requires_grad_(True)
    g = np.random.default_rng(L).normal(size=t.shape).astype(np.float32)
    (d,) = torch.autograd.grad(cross_source_vw(_t(t), _t(mask), a), a, _t(g))
    d_j = jax.grad(lambda x: jnp.sum(jax_cross_source_vw(jnp.asarray(t), jnp.asarray(mask), x)
                                     * g))(jnp.asarray(alpha))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(d_j)).max()))


def test_cross_source_vw_is_a_stable_sort_composite():
    """Below the occlusion cap, the order-free weights are those of a stable
    depth sort followed by the transmittance product."""
    t, mask, alpha = _unsorted_buffer(32, 40, 9)
    alpha = np.minimum(alpha, 0.99).astype(np.float32)
    key = np.where(mask, t, 1e10)
    order = np.argsort(key, axis=-1, kind="stable")
    a_s = np.take_along_axis(np.where(mask, alpha, 0.0), order, -1)
    vw_s = np.asarray(jax_alpha_to_vw(jnp.asarray(a_s)))
    want = np.zeros_like(vw_s)
    np.put_along_axis(want, order, vw_s, -1)
    got = cross_source_vw_plain(_t(t), _t(mask), _t(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cross_source_vw_plain_is_differentiable_on_the_cpu():
    t, mask, alpha = _unsorted_buffer(8, 12, 10)
    a = _t(alpha).requires_grad_(True)
    cross_source_vw(_t(t), _t(mask), a).sum().backward()
    assert torch.isfinite(a.grad).all() and float(a.grad.abs().sum()) > 0


def _source_buffers(seed, n=48):
    """Two object buffers, a street buffer and a distant one that overlap in
    depth, with their payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for lo, hi, s in ((2.0, 6.0, 6), (3.0, 9.0, 6), (0.5, 20.0, 8), (15.0, 900.0, 5)):
        buf = {"t": np.sort(rng.uniform(lo, hi, (n, s)), -1).astype(np.float32),
               "mask": rng.random((n, s)) > 0.3,
               "alpha": (rng.random((n, s)) ** 2).astype(np.float32),
               "rgb": rng.random((n, s, 3)).astype(np.float32),
               "nablas": rng.normal(size=(n, s, 3)).astype(np.float32)}
        buf["alpha"] = np.where(buf["mask"], buf["alpha"], 0).astype(np.float32)
        out.append(buf)
    out[0]["mask"][:10] = False                         # rays that miss an object
    out[3]["mask"][:] = True
    out[3]["nablas"][:] = 0.0
    return out


@pytest.mark.parametrize("per_idx", [None, [2, 3]], ids=["every-source", "street-distant"])
def test_sort_free_merge_matches_jax(per_idx):
    bufs = _source_buffers(11)
    want = jax_merge([{k: jnp.asarray(v) for k, v in b.items()} for b in bufs],
                     with_per_src=True, per_src_indices=per_idx, sort_free=True)
    got = merge_and_integrate([{k: _t(v) for k, v in b.items()} for b in bufs],
                              with_per_src=True, per_src_indices=per_idx, sort_free=True)
    for k in ("mask_volume", "depth_volume", "rgb_volume", "normals_volume", "vw",
              "samples_cnt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in ("t", "mask", "alpha", "rgb", "nablas", "src", "vw"):
        np.testing.assert_allclose(got["merged_buffer"][k].numpy(),
                                   np.asarray(want["merged_buffer"][k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["merged_buffer"]["t"].shape == (48, 25)
    total = 0.0
    for i, (g, w) in enumerate(zip(got["per_src"], want["per_src"])):
        assert (g is None) == (w is None)
        if g is None:
            continue
        for k in ("mask_volume", "depth_volume", "rgb_volume"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"per_src[{i}].{k}")
        total = total + g["mask_volume"]
    if per_idx is None:      # the shares add up to the whole
        np.testing.assert_allclose(total.numpy(), got["mask_volume"].numpy(), atol=1e-6)
        segm = render_instance_segmentation(got).numpy()
        np.testing.assert_array_equal(segm, np.asarray(jax_segmentation(want)))


# ---------------------------------------------------------------------------
# The assets of the multi-object config
# ---------------------------------------------------------------------------

def test_multi_object_assets_match_jax():
    scenario = demo_scenario(n_frames=3, H=16, W=24, n_vehicles=2)
    scene, jscene = Scene.load_from_scenario(scenario), JaxScene.load_from_scenario(scenario)
    bank = WAYMO_DEMO_MULTI["assetbank_cfg"]
    veh = asset_class(bank["Vehicle"]["model_class"])(bank["Vehicle"]["model_params"])
    jveh = jax_assets.ADGenerativeLoTDConcatNeuSObj(bank["Vehicle"]["model_params"])
    veh.populate(scene, ["veh_0", "veh_1"])
    jveh.populate(jscene, ["veh_0", "veh_1"])
    assert veh.instance_index == jveh.instance_index == {"veh_0": 0, "veh_1": 1}
    np.testing.assert_allclose(veh.field.space.aabb_max.numpy(),
                               np.asarray(jveh.field.space.aabb_max), rtol=1e-6)
    assert veh.field.n_instances == 2 and veh.field.z_dim == 8 and veh.accel is None
    assert [(s.res, s.typ) for s in veh.field.encoding.specs] == \
        [(s.res, s.typ) for s in jveh.field.encoding.specs]
    street = asset_class(bank["Street"]["model_class"])(bank["Street"]["model_params"])
    jstreet = jax_assets.LoTDNeuSStreet(bank["Street"]["model_params"])
    street.populate(scene)
    jstreet.populate(jscene)
    a, ja = street.accel, jstreet.accel
    assert (a.res, a.occ_thre, a.ema_decay, a.occ_inv_s, a.n_steps_between_update,
            a.samples_per_voxel, a.march_steps) == \
        (ja.res, ja.occ_thre, ja.ema_decay, ja.occ_inv_s, ja.n_steps_between_update,
         ja.samples_per_voxel, ja.march_steps) == (128, 0.3, 0.95, 10.0, 16, 4, 64)
    f, jf = street.field, jstreet.field
    assert f._geo_init_bias == jf._geo_init_bias == 0.0
    assert (f.inv_s_final, f.inv_s_anneal_start_it, f.inv_s_anneal_stop_it) == \
        (jf.inv_s_final, jf.inv_s_anneal_start_it, jf.inv_s_anneal_stop_it) == (30.0, 1200, 6000)
    assert street.query_cfg == jstreet.query_cfg
    # with an accel_cfg: one grid per instance over the class's box, read as JAX reads it
    mp = {**bank["Vehicle"]["model_params"], "accel_cfg": {"resolution": 16, "inv_s": 64.0}}
    veh_g = asset_class(bank["Vehicle"]["model_class"])(mp)
    jveh_g = jax_assets.ADGenerativeLoTDConcatNeuSObj(mp)
    veh_g.populate(scene, ["veh_0", "veh_1"])
    jveh_g.populate(jscene, ["veh_0", "veh_1"])
    a, ja = veh_g.accel, jveh_g.accel
    assert (a.n_instances, a.res, a.occ_thre, a.ema_decay, a.occ_inv_s,
            a.n_steps_between_update, a.march_steps) == \
        (ja.n_instances, ja.res, ja.occ_thre, ja.ema_decay, ja.occ_inv_s,
         ja.n_steps_between_update, ja.march_steps) == (2, 16, 0.3, 0.95, 64.0, 16, 64)
    np.testing.assert_allclose(a.box("cpu")[1].numpy(), np.asarray(ja.space.aabb_max),
                               rtol=1e-6)
    assert a.init_state().val.shape == (2, 16, 16, 16)
