"""Port parity for the multi-object training slice's pieces of arithmetic:
K8's backward (``cross_source_vw``), the clearance, LiDAR (depth, line of
sight ``neus_unisim`` and ``neus_urban``) and latent losses and the
photometric error map, each against the JAX package on the same numpy
inputs on the CPU.

Tolerances. K8's gradient: autograd of the plain version against ``jax.vjp``
of the JAX function, every entry within 1e-6 of the largest (both sum up to
L float32 terms per entry, in other orders; the clip's and the cap's edges
follow JAX's rule exactly, so no entry differs by a half). The losses: rtol
1e-5 / atol 1e-6 (elementwise float32 arithmetic and masked means), their
gradients rtol 1e-5 / atol 1e-7; each at iterations before and after every
milestone and anneal edge of the waymo_demo_multi config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.conditional import ConditionalLoTDNeuSField as JaxCond
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_tpu.losses import core as jcore
from neuralsim_tpu.ops.segment import cross_source_vw as jax_csvw
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import WAYMO_DEMO_MULTI
from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.losses import core
from neuralsim_torch.ops.segment import cross_source_vw, cross_source_vw_bwd_plain

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-5, atol=1e-7)
K8_GRAD_REL = 1e-6
LOSSES = WAYMO_DEMO_MULTI["training"]["losses"]
# before and after the sparsity gate and ramp (600 .. 3000) and the line of
# sight's epsilon milestones (2000, 4000)
ITS = (0, 599, 600, 1999, 2000, 2999, 3000, 3999, 4000, 6000)
T = torch.from_numpy


def _edge_buffer(n, L, seed):
    """An unsorted merged buffer with ties, masked lanes, fully masked rays
    and alphas at 0, 1 and float32(0.999) (where JAX splits a gradient in
    halves), just below and above those, and outside [0, 1]."""
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, 40, (n, L)) / 4.0).astype(np.float32)
    alpha = (rng.random((n, L)) ** 2).astype(np.float32)
    edges = np.array([0.0, 1.0, 0.999, 0.9995, 0.9985, -0.1, 1.2, 1e-7], np.float32)
    pick = rng.random((n, L)) < 0.3
    alpha[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
    mask = rng.random((n, L)) > 0.2
    mask[::7] = False
    return t, mask, alpha


@pytest.mark.parametrize("n,L", [(64, 168), (97, 1), (33, 5), (16, 257), (5, 700)])
def test_k8_plain_gradient_matches_jax_vjp(n, L):
    t, mask, alpha = _edge_buffer(n, L, L)
    g = np.random.default_rng(L + 1).normal(size=(n, L)).astype(np.float32)
    vw, vjp = jax.vjp(lambda a: jax_csvw(jnp.asarray(t), jnp.asarray(mask), a), jnp.asarray(alpha))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = cross_source_vw_bwd_plain(T(t), T(mask), T(alpha), T(g)).numpy()
    assert np.abs(got - want).max() <= K8_GRAD_REL * np.abs(want).max()
    np.testing.assert_allclose(cross_source_vw(T(t), T(mask), T(alpha)).numpy(), np.asarray(vw),
                               rtol=1e-6, atol=1e-7)
    for edge in (0.0, 1.0, np.float32(0.999)):        # the edges are there
        sel = mask & (alpha == edge)
        assert sel.any() and np.all(np.isfinite(got[sel]))


def test_k8_plain_gradient_halves_at_the_edges_like_jax():
    """A single lane: at alpha exactly 0 or 1 the clip passes half the
    gradient, at float32(0.999) the cap passes half of the occlusion term."""
    t = np.array([[1.0, 2.0]], np.float32)
    mask = np.ones((1, 2), bool)
    g = np.ones((1, 2), np.float32)
    for a0 in (0.0, 1.0, 0.999, 0.5, -0.5, 1.5):
        alpha = np.array([[a0, 0.5]], np.float32)
        _, vjp = jax.vjp(lambda a: jax_csvw(jnp.asarray(t), jnp.asarray(mask), a),
                         jnp.asarray(alpha))
        np.testing.assert_allclose(cross_source_vw_bwd_plain(T(t), T(mask), T(alpha), T(g)),
                                   np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6, atol=0)


def _near_sdf(seed=0, n=300):
    rng = np.random.default_rng(seed)
    s = rng.normal(0.0, 0.5, n).astype(np.float32)
    s[::10] = -8.0                  # deeply negative: the capped exponent
    s[1::10] = 1e10                 # rays that miss the street
    s[2::10] = 0.02                 # exactly the threshold
    return s


@pytest.mark.parametrize("it", ITS)
def test_clearance_loss_matches_jax(it):
    s = _near_sdf()
    cfg = LOSSES["clearance"]
    x = T(s).requires_grad_(True)
    got = core.clearance_loss(x, it, cfg)
    (g,) = torch.autograd.grad(got, x)
    want, jg = jax.value_and_grad(lambda a: jcore.clearance_loss(a, it, cfg))(jnp.asarray(s))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GTOL)
    assert np.isfinite(float(want)) and float(want) > 0


def _lidar_inputs(seed=0, n=200, s=24):
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(2.0, 60.0, n).astype(np.float32)
    ranges[::9] = 0.0               # no return
    ranges[1::13] = 95.0            # beyond discard_toofar
    t = np.sort(rng.uniform(0.5, 70.0, (n, s)), -1).astype(np.float32)
    alpha = (rng.random((n, s)) ** 3).astype(np.float32)
    mask = rng.random((n, s)) > 0.15
    mask[4::17] = False             # rays with no sample
    depth = (ranges + rng.normal(0, 1.0, n)).astype(np.float32)
    mvol = rng.random(n).astype(np.float32)
    mvol[5::11] = 0.0
    return dict(ranges=ranges, t=t, alpha=alpha, mask=mask, depth=depth, mvol=mvol)


@pytest.mark.parametrize("it", ITS)
@pytest.mark.parametrize("fn_type", ["neus_unisim", "neus_urban", None])
def test_lidar_loss_matches_jax(fn_type, it):
    """The depth term alone (None) and with each line-of-sight variant, with
    its epsilon on the config's milestones; values and gradients to the
    rendered depth and to alpha (through alpha_to_vw)."""
    d = _lidar_inputs()
    cfg = dict(LOSSES["lidar"])
    if fn_type is None:
        cfg.pop("line_of_sight")
    else:
        cfg["line_of_sight"] = {**cfg["line_of_sight"], "fn_type": fn_type}

    def jloss(depth, alpha):
        buf = {"t": jnp.asarray(d["t"]), "mask": jnp.asarray(d["mask"]), "alpha": alpha}
        rendered = {"depth_volume": depth, "mask_volume": jnp.asarray(d["mvol"])}
        return jcore.lidar_loss(rendered, jnp.asarray(d["ranges"]), it, cfg, buf=buf)

    (want, jaux), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["depth"]), jnp.asarray(d["alpha"]))
    depth, alpha = T(d["depth"]).requires_grad_(True), T(d["alpha"]).requires_grad_(True)
    got, aux = core.lidar_loss({"depth_volume": depth, "mask_volume": T(d["mvol"])},
                               T(d["ranges"]), it, cfg,
                               buf={"t": T(d["t"]), "mask": T(d["mask"]), "alpha": alpha})
    grads = torch.autograd.grad(got, [depth, alpha], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for k in ("loss_depth", "loss_los", "valid_frac"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **TOL)
    for g, w in zip(grads, jg):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), **GTOL)


def test_line_of_sight_reads_the_composite_weights_where_given():
    """The port hands the K6 composite's weights in as ``vw``; they equal
    ``alpha_to_vw``'s, so the loss is the same."""
    from neuralsim_torch.ops.segment import alpha_to_vw
    d = _lidar_inputs(1)
    cfg = LOSSES["lidar"]["line_of_sight"]
    buf = {"t": T(d["t"]), "mask": T(d["mask"]), "alpha": T(d["alpha"])}
    valid = T((d["ranges"] > 0).astype(np.float32))
    a = core.line_of_sight_loss(buf, T(d["ranges"]), valid, 100, cfg)
    b = core.line_of_sight_loss({**buf, "vw": alpha_to_vw(buf["alpha"], buf["mask"])},
                                T(d["ranges"]), valid, 100, cfg)
    assert a.item() == b.item() > 0


def test_latent_loss_matches_jax():
    """The latent regulariser: the conditional field's mean squared latent
    norm times w, and its gradient to the latents."""
    jf = JaxCond(JaxSpace([-1.0] * 3, [1.0] * 3), n_instances=3, z_dim=8,
                 encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2,
                               "cp_max_res": 32}, geo_feat_dim=7, radiance_hidden=16)
    jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(3)))
    jp["latents"] = np.random.default_rng(0).normal(0, 0.3, jp["latents"].shape).astype(np.float32)
    f = ConditionalLoTDNeuSField(AABBSpace([-1.0] * 3, [1.0] * 3), n_instances=3, z_dim=8,
                                 encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32,
                                               "n_feats": 2, "cp_max_res": 32},
                                 geo_feat_dim=7, radiance_hidden=16)
    load_jax_params(f, jp)
    w = LOSSES["latent"]["w"]
    want, jg = jax.value_and_grad(lambda p: jf.latent_norm(p) * w)(
        jax.tree.map(jnp.asarray, jp))
    got = f.latent_norm() * w
    (g,) = torch.autograd.grad(got, f.latents)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["latents"]), **GTOL)


def test_photometric_error_map_matches_jax():
    rng = np.random.default_rng(2)
    pred, gt = rng.random((128, 3)).astype(np.float32), rng.random((128, 3)).astype(np.float32)
    cfg = LOSSES["rgb"]
    want, jaux = jcore.photometric_loss({"rgb_volume": jnp.asarray(pred)},
                                        {"image_rgb": jnp.asarray(gt)}, 10, cfg)
    got, aux = core.photometric_loss({"rgb_volume": T(pred)}, {"image_rgb": T(gt)}, 10, cfg)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(aux["err_map"].numpy(), np.asarray(jaux["err_map"]), **TOL)
