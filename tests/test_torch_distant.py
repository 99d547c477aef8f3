"""Port parity for what the bench model adds around the occupancy grid: the
NeRF++ distant field with its embedder and contraction, ``tau_to_alpha``, the
two-buffer ``merge_and_integrate`` with ``per_src``, and the stacked-CP
encoding at the bench model's width (12 CP levels of 8 features, 16 .. 1,024:
F_cp = 96, R_max = 1,024) against ``neuralsim_tpu`` on the CPU.

Inputs come from numpy seeds; the distant ladder's jitter is drawn with
``jax.random.uniform(key, [N, num_samples])`` as ``NeRFDistantField.ray_query``
draws it and handed to the port.

Tolerances: elementwise functions 1e-6; the sinusoidal embedder 2e-5 (its
highest frequency multiplies the input by 128 before the sine, and the two
packages' sine differ by an ulp of that argument); the distant buffer 1e-5
(small MLPs, ``exp`` of a clipped logit); the composite 1e-5; the wide
encoding against JAX's dense bf16 tent matmul 1e-5 on values of order one and,
for the jacobian, 1e-5 of its largest entry (the two nonzero taps are summed
in another order than the matmul's 1,024 terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.embedders import sinusoidal_embedder as jax_sinusoidal
from neuralsim_tpu.fields.encodings.lotd import make_lotd as jax_make_lotd
from neuralsim_tpu.fields.nerf import NeRFDistantField as JaxDistant
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_tpu.fields.spatial import contract_inverted_sphere as jax_contract
from neuralsim_tpu.ops.segment import tau_to_alpha as jax_tau_to_alpha
from neuralsim_tpu.renderers.buffers import merge_and_integrate as jax_merge
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import BENCH_OBJECT
from neuralsim_torch.fields.embedders import sinusoidal_embedder
from neuralsim_torch.fields.encodings.lotd import (lotd_cp_stacked_bwd, lotd_cp_stacked_bwd_plain,
                                                   make_lotd)
from neuralsim_torch.fields.nerf import NeRFDistantField
from neuralsim_torch.fields.spatial import AABBSpace, contract_inverted_sphere
from neuralsim_torch.models.assets import asset_class
from neuralsim_torch.ops.segment import tau_to_alpha
from neuralsim_torch.renderers.buffers import merge_and_integrate

torch.set_num_threads(1)

N, NS = 48, 8
BENCH_ENC = BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(N, 3))
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 2.0 + 0.3 * rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_contract_inverted_sphere_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(500, 3)) * rng.choice([0.1, 1.0, 50.0], (500, 1))).astype(np.float32)
    x[0] = 0.0                                              # r clipped at the inner radius
    for radius in (1.0, 2.5):
        got = contract_inverted_sphere(_t(x), radius).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_contract(jnp.asarray(x), radius)),
                                   rtol=1e-6, atol=1e-6)
        assert got.shape == (500, 4) and np.abs(got).max() <= 1.0 + 1e-6


def test_sinusoidal_embedder_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (300, 4)).astype(np.float32)
    embed, dim = sinusoidal_embedder(8, 4)
    jembed, jdim = jax_sinusoidal(8, 4)
    assert dim == jdim == 68
    got = embed(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jembed(jnp.asarray(x))), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[:, :4], x)            # the input comes first
    ident, d0 = sinusoidal_embedder(0, 3)
    assert d0 == 3 and ident(_t(x[:, :3])).shape == (300, 3)


def test_tau_to_alpha_and_radius3d_match_jax():
    tau = np.array([-1.0, 0.0, 1e-6, 0.3, 5.0, 80.0], np.float32)
    np.testing.assert_allclose(tau_to_alpha(_t(tau)).numpy(),
                               np.asarray(jax_tau_to_alpha(jnp.asarray(tau))), rtol=1e-6,
                               atol=1e-9)
    box = ([-1.0, -2.0, -0.5], [1.0, 2.0, 0.5])
    np.testing.assert_allclose(float(AABBSpace(*box).radius3d), float(JaxSpace(*box).radius3d),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def distant_pair():
    kw = dict(inner_radius=1.0, geometry="mlp", geo_feat_dim=4, decoder_hidden=16,
              radiance_hidden=8)
    jf = JaxDistant(**kw)
    jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)      # move the biases off zero, so the density varies
    for layer in jp["decoder"]["layers"]:
        layer["b"] = rng.normal(0, 0.3, layer["b"].shape).astype(np.float32)
    pf = NeRFDistantField(**kw)
    load_jax_params(pf, jp)
    return jf, jax.tree.map(jnp.asarray, jp), pf


def test_distant_density_matches_jax(distant_pair):
    jf, jp, pf = distant_pair
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(400, 3)) * 20.0).astype(np.float32)
    sigma, feat = pf.query_density_feat(_t(x))
    jsigma, jfeat = jf.query_density_feat(jp, jnp.asarray(x))
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-5)
    assert float(sigma.detach().min()) > 0 and sigma.shape == (400,)


@pytest.mark.parametrize("noisy", [False, True], ids=["deterministic", "noise"])
def test_distant_ray_query_matches_jax(distant_pair, noisy):
    jf, jp, pf = distant_pair
    o, d = _rays()
    near = np.random.default_rng(5).uniform(0.0, 3.0, N).astype(np.float32)
    near[:3] = [0.0, 1e-4, 2.0]                             # clipped at 1e-3 from below
    key = jax.random.PRNGKey(6) if noisy else None
    want = jf.ray_query(jp, jnp.asarray(o), jnp.asarray(d), key=key, near=jnp.asarray(near),
                        num_samples=NS)
    noise = _t(jax.random.uniform(key, (N, NS))) if noisy else None
    got = pf.ray_query(_t(o), _t(d), near=_t(near), num_samples=NS, noise=noise)
    assert set(got) == set(want) == {"t", "mask", "alpha", "nablas", "rgb", "details"}
    for k in ("t", "alpha", "rgb"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert got["mask"].all() and not got["nablas"].any() and got["nablas"].shape == (N, NS, 3)
    for k in ("hit", "near", "far"):
        np.testing.assert_allclose(got["details"][k].numpy(), np.asarray(want["details"][k]),
                                   rtol=1e-5, err_msg=k)
    t = got["t"]
    assert (t[:, 1:] > t[:, :-1]).all()
    if not noisy:                                           # the ladder starts at the near plane
        assert float(t[2, 0]) == pytest.approx(2.0, rel=1e-5)
    # without a near plane the ladder starts at the inner radius
    np.testing.assert_allclose(pf.ray_query(_t(o), _t(d), num_samples=NS)["t"].numpy(),
                               np.asarray(jf.ray_query(jp, jnp.asarray(o), jnp.asarray(d),
                                                       num_samples=NS)["t"]), rtol=1e-5)


def test_distant_lotd_geometry_is_named_as_not_ported():
    """The 4-D LoTD geometry is ported (tests/test_torch_streetsurf.py holds
    it to JAX); what of it is not, a CP level in four dimensions, raises
    naming itself. The NeRFDistant asset keeps the MLP geometry."""
    f = NeRFDistantField(geometry="lotd", encoding_cfg={"n_levels": 2, "max_res": 32})
    assert f.encoding.input_dim == 4 and [s.typ for s in f.encoding.specs] == ["dense", "hash"]
    with pytest.raises(NotImplementedError, match="CP level of a 4-D LoTD"):
        NeRFDistantField(geometry="lotd", encoding_cfg={"levels": [(8, 2, "cp")]})
    asset = asset_class("neuralsim_tpu.models.assets.NeRFDistant")({"geo_feat_dim": 8})
    asset.populate()
    assert isinstance(asset.field, NeRFDistantField) and asset.field.decoder.out_dim == 9


def _buffers(seed):
    rng = np.random.default_rng(seed)
    out = []
    for lo, hi, s in ((0.5, 2.0, 6), (2.0, 30.0, 5)):       # disjoint in depth, in order
        buf = {"t": np.sort(rng.uniform(lo, hi, (N, s)), -1).astype(np.float32),
               "mask": rng.random((N, s)) > 0.2,
               "alpha": (rng.random((N, s)) ** 2).astype(np.float32),
               "rgb": rng.random((N, s, 3)).astype(np.float32),
               "nablas": rng.normal(size=(N, s, 3)).astype(np.float32)}
        out.append(buf)
    out[0]["mask"][:4] = False                              # rays that miss the close range
    out[0]["alpha"] = np.where(out[0]["mask"], out[0]["alpha"], 0).astype(np.float32)
    out[1]["nablas"][:] = 0.0
    return out


def test_two_buffer_merge_and_integrate_matches_jax():
    bufs = _buffers(7)
    want = jax_merge([{k: jnp.asarray(v) for k, v in b.items()} for b in bufs],
                     with_per_src=True, assume_sorted=True)
    tb = [{k: _t(v).requires_grad_(k in ("alpha", "rgb")) for k, v in b.items()} for b in bufs]
    got = merge_and_integrate(tb, with_per_src=True, assume_sorted=True)
    for k in ("mask_volume", "depth_volume", "rgb_volume", "normals_volume", "vw", "samples_cnt"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("t", "mask", "alpha", "rgb", "nablas", "src"):
        np.testing.assert_array_equal(got["merged_buffer"][k].detach().numpy(),
                                      np.asarray(want["merged_buffer"][k]), err_msg=k)
    assert got["merged_buffer"]["t"].shape == (N, 11) and len(got["per_src"]) == 2
    for i in range(2):
        for k in ("mask_volume", "depth_volume", "rgb_volume"):
            np.testing.assert_allclose(got["per_src"][i][k].detach().numpy(),
                                       np.asarray(want["per_src"][i][k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"per_src[{i}].{k}")
    # the shares add up to the whole, and gradients reach both sources through them
    np.testing.assert_allclose((got["per_src"][0]["mask_volume"]
                                + got["per_src"][1]["mask_volume"]).detach().numpy(),
                               got["mask_volume"].detach().numpy(), atol=1e-6)
    got["per_src"][1]["rgb_volume"].sum().backward()
    assert float(tb[0]["alpha"].grad.abs().sum()) > 0 and float(tb[1]["rgb"].grad.abs().sum()) > 0


def test_merge_and_integrate_refuses_overlapping_buffers():
    bufs = [{k: _t(v) for k, v in b.items()} for b in _buffers(8)]
    with pytest.raises(NotImplementedError, match="overlap"):
        merge_and_integrate(bufs, with_per_src=True)
    one = merge_and_integrate(bufs[:1])
    assert "per_src" not in one and not one["merged_buffer"]["src"].any()


@pytest.fixture(scope="module")
def wide_pair():
    je, pe = jax_make_lotd(BENCH_ENC), make_lotd(BENCH_ENC)
    table = np.asarray(je.init(jax.random.PRNGKey(8))["table"])
    rng = np.random.default_rng(8)
    table = (table + rng.normal(0, 0.05, table.shape)).astype(np.float32)
    load_jax_params(pe, {"table": table})
    return je, pe, table


def test_bench_encoding_plan_matches_jax(wide_pair):
    je, pe, _ = wide_pair
    assert [(s.res, s.n_feats, s.typ, s.size, s.offset) for s in pe.specs] == \
        [(s.res, s.n_feats, s.typ, s.size, s.offset) for s in je.specs]
    assert all(s.typ == "cp" for s in pe.specs) and len(pe.specs) == 12
    assert pe.total_params == je.total_params and pe.out_dim == je.out_dim == 96
    assert pe.cp_rmax == je.cp_rmax == 1024 and pe.cp_out_dim == 96
    # most levels' (R - 1) does not divide R_max - 1 = 1023
    assert sum(1023 % (s.res - 1) != 0 for s in pe.specs) >= 8


def test_wide_kernel_lines_match_jax(wide_pair):
    je, pe, table = wide_pair
    want = np.asarray(je._cp_stacked_lines(jnp.asarray(table)))
    got = pe.kernel_lines().f32.detach().numpy()
    assert got.shape == want.shape == (3, 96, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wide_stacked_cp_matches_jax(wide_pair):
    je, pe, table = wide_pair
    rng = np.random.default_rng(9)
    x = rng.random((600, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.75], [1.5, -0.5, 0.3]]   # knots, clipped
    want, want_jac = je._cp_stacked_features(
        je._cp_stacked_lines(jnp.asarray(table)), jnp.clip(jnp.asarray(x).T, 0.0, 1.0),
        with_jac=True)
    got, got_jac = pe.with_jacobian(_t(x))
    np.testing.assert_allclose(got.detach().numpy().T, np.asarray(want), rtol=1e-5, atol=1e-5)
    jac = np.asarray(want_jac)                                            # [3, F, N]
    np.testing.assert_allclose(got_jac.detach().numpy().transpose(2, 1, 0), jac, rtol=0,
                               atol=1e-5 * np.abs(jac).max())
    np.testing.assert_allclose(pe(_t(x)).detach().numpy(), got.detach().numpy())


def test_wide_backward_reaches_every_level(wide_pair):
    _, pe, _ = wide_pair
    rng = np.random.default_rng(10)
    x = _t(rng.random((300, 3)).astype(np.float32))
    lines = pe.kernel_lines().bf16
    d_out = _t(rng.normal(size=(96, 300)).astype(np.float32))
    d_jac = _t(rng.normal(size=(3, 96, 300)).astype(np.float32))
    g = lotd_cp_stacked_bwd(lines, x, pe._cp_rows, d_out, d_jac)
    assert g.shape == (3, 96, 1024) and g.dtype == torch.float32
    assert torch.equal(g, lotd_cp_stacked_bwd_plain(lines, x, pe._cp_rows, d_out, d_jac))
    assert (g.abs().sum(dim=(0, 2)) > 0).all()              # every stacked feature got some
    h, j = pe.with_jacobian(x)
    ((h * d_out.T).sum() + (j * d_jac.permute(2, 1, 0)).sum()).backward()
    per_level = [float(pe.table.grad[s.offset:s.offset + s.size * s.n_feats].abs().sum())
                 for s in pe.specs]
    assert all(v > 0 for v in per_level)
