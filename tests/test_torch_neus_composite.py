"""Port parity: the NeuS alpha fused into the composite (kernel K12), its
plain PyTorch version against the JAX package on the CPU: the cos anneal and
``neus_alpha_from_sdf`` of ``NeuSField.ray_query`` (neus.py:529-543), the
mask, then ``alpha_to_vw`` and ``volume_integrate``. Forward outputs, and the
gradients into sdf, nablas, rgb and ``ln_inv_s`` under cotangents of every
output; the backward wrapper (its plain version here; the CUDA kernel is held
to it in test_torch_kernels_cuda.py); the clip tie of ``neus_alpha_from_sdf``.

The buffer has masked lanes, fully masked rays and lanes whose alpha rounds
to exactly 1 (P near 1, Q below 3e-8), where ``jnp.clip`` passes half the
gradient. Tolerances: forward rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 /
atol 1e-5 of the largest entry (JAX differentiates an associative scan of the
transmittance product, torch a left-to-right loop, as in
test_torch_composite_grad.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import COMPOSITE_EDGE_INV_S, neus_edge_inputs, neus_inputs
from neuralsim_tpu.fields.neus import neus_alpha_from_sdf as jax_alpha
from neuralsim_tpu.renderers.buffers import volume_integrate as jax_integrate
from neuralsim_torch.fields.neus import neus_alpha_from_sdf
from neuralsim_torch.renderers.buffers import volume_integrate
from neuralsim_torch.renderers.neus_composite import (neus_composite_bwd, neus_composite_plain,
                                                      neus_integrate)

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
OUTS = ("vw", "mask_volume", "depth_volume", "rgb_volume", "normals_volume", "alpha")
LN_INV_S = np.float32(np.log(300.0))


def _buffer(n=48, s=40, seed=0):
    """Rays through a surface (chip_smoke.neus_inputs): sdf falling through 0,
    nablas against the ray with noise, masked lanes, a fully masked ray, and
    lanes whose alpha is exactly 1."""
    keys = ("t", "mask", "sdf", "nablas", "rays_d", "rgb")
    return dict(zip(keys, neus_inputs(n, s, seed)))


def _cotangents(buf, seed=3):
    rng = np.random.default_rng(seed)
    n, s = buf["t"].shape
    shapes = {"vw": (n, s), "mask_volume": (n,), "depth_volume": (n,), "rgb_volume": (n, 3),
              "normals_volume": (n, 3), "alpha": (n, s)}
    return {k: rng.normal(size=sh).astype(np.float32) for k, sh in shapes.items()}


def _jax_outputs(buf, anneal, sdf, nablas, rgb, ln_inv_s):
    inv_s = jnp.exp(ln_inv_s)
    true_cos = jnp.sum(jnp.asarray(buf["rays_d"])[:, None, :] * nablas, axis=-1)
    cos = -(jax.nn.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
            + jax.nn.relu(-true_cos) * anneal)
    t = jnp.asarray(buf["t"])
    dt = jnp.concatenate([t[..., 1:] - t[..., :-1], jnp.ones_like(t[..., :1]) * 1e-3], -1)
    mask = jnp.asarray(buf["mask"])
    alpha = jnp.where(mask, jax_alpha(sdf, cos, dt, inv_s), 0.0)
    r = jax_integrate({"t": t, "mask": mask, "alpha": alpha, "rgb": rgb, "nablas": nablas})
    return {**r, "alpha": alpha}


def _port_outputs(buf, anneal, sdf, nablas, rgb, ln_inv_s):
    vw, m, dep, c, nrm, cnt, alpha = neus_composite_plain(
        torch.from_numpy(buf["t"]), torch.from_numpy(buf["mask"]), sdf, nablas,
        torch.from_numpy(buf["rays_d"]), anneal, torch.exp(ln_inv_s), rgb)
    return {"vw": vw, "mask_volume": m, "depth_volume": dep, "rgb_volume": c,
            "normals_volume": nrm, "samples_cnt": cnt, "alpha": alpha}


def _inputs(buf, ln_inv_s=LN_INV_S):
    return [buf["sdf"], buf["nablas"], buf["rgb"], ln_inv_s]


# the kernels' lane groups and chunks at their edges (rays, samples, cos
# anneal): one sample, odd widths across a group; a wholly masked row (row
# 1) and runs of lanes whose alpha is exactly 1 (a clip tie; every third row
# from row 2), at chip_smoke's inv_s for these inputs
EDGES = [(4, 1, 0.0), (6, 7, 0.5), (5, 33, 1.0)]
EDGE_IDS = [f"S {s}" for _, s, _ in EDGES]
LN_EDGE_INV_S = np.float32(np.log(COMPOSITE_EDGE_INV_S))


def _edge_buffer(n, s):
    keys = ("t", "mask", "sdf", "nablas", "rays_d", "rgb")
    return dict(zip(keys, neus_edge_inputs(n, s, 1000 * s + n)))


@pytest.mark.parametrize("anneal", [0.0, 0.5, 1.0])
def test_forward_matches_jax(anneal):
    buf = _buffer()
    want = _jax_outputs(buf, anneal, *map(jnp.asarray, _inputs(buf)))
    got = _port_outputs(buf, anneal, *[torch.from_numpy(np.asarray(a)) for a in _inputs(buf)])
    assert int((got["alpha"] == 1.0).sum()) >= 5, "the buffer should hold alpha == 1 ties"
    assert not bool(got["alpha"][~torch.from_numpy(buf["mask"])].any())
    for k in OUTS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **FWD, err_msg=k)
    assert np.array_equal(got["samples_cnt"].numpy(), np.asarray(want["samples_cnt"]))


@pytest.mark.parametrize("anneal", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("outs", [OUTS, ("vw",), ("rgb_volume", "normals_volume"), ("alpha",)],
                         ids=["all", "vw", "rgb+normals", "alpha"])
def test_gradients_match_jax(anneal, outs):
    buf = _buffer(seed=1)
    cot = _cotangents(buf)

    def loss(*a):
        r = _jax_outputs(buf, anneal, *a)
        return sum(jnp.sum(r[k] * cot[k]) for k in outs)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, _inputs(buf)))
    ins = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in _inputs(buf)]
    r = _port_outputs(buf, anneal, *ins)
    got = torch.autograd.grad(sum((r[k] * torch.from_numpy(cot[k])).sum() for k in outs), ins,
                              allow_unused=True)
    for name, g, w in zip(("sdf", "nablas", "rgb", "ln_inv_s"), got, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


@pytest.mark.parametrize("n,s,anneal", EDGES, ids=EDGE_IDS)
def test_forward_at_edges_matches_jax(n, s, anneal):
    buf = _edge_buffer(n, s)
    ins = _inputs(buf, LN_EDGE_INV_S)
    want = jax.jit(lambda *a: _jax_outputs(buf, anneal, *a))(*map(jnp.asarray, ins))
    got = _port_outputs(buf, anneal, *[torch.from_numpy(np.asarray(a)) for a in ins])
    for k in OUTS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **FWD, err_msg=k)
    assert not got["mask_volume"][1] and not got["depth_volume"][1]   # 0 / 1e-8
    if s > 1:
        assert int((got["alpha"][2] == 1.0).sum()) >= 3, "the run of alpha == 1 lanes"


@pytest.mark.parametrize("n,s,anneal", EDGES, ids=EDGE_IDS)
def test_gradients_at_edges_match_jax(n, s, anneal):
    """Every output's cotangent; at the clip ties jnp.clip passes half the
    gradient, and so does the port."""
    buf = _edge_buffer(n, s)
    cot = _cotangents(buf, seed=s)
    ins = _inputs(buf, LN_EDGE_INV_S)

    def loss(*a):
        r = _jax_outputs(buf, anneal, *a)
        return sum(jnp.sum(r[k] * cot[k]) for k in OUTS)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, ins))
    leaves = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in ins]
    r = _port_outputs(buf, anneal, *leaves)
    got = torch.autograd.grad(sum((r[k] * torch.from_numpy(cot[k])).sum() for k in OUTS),
                              leaves)
    for name, g, w in zip(("sdf", "nablas", "rgb", "ln_inv_s"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_backward_wrapper_is_the_autograd_gradient(with_rgb):
    """K12's backward wrapper (its plain version here): d sdf, d nablas, d rgb
    and the per-ray shares of d inv_s, whose sum is autograd's d inv_s; a
    cotangent that is None counts as zero."""
    buf = _buffer(seed=2)
    cot = {k: torch.from_numpy(v) for k, v in _cotangents(buf, seed=4).items()}
    T = {k: torch.from_numpy(v) for k, v in buf.items()}
    rgb = T["rgb"] if with_rgb else None
    ins = [T["sdf"].clone().requires_grad_(True), T["nablas"].clone().requires_grad_(True)]
    inv_s = torch.tensor(300.0).requires_grad_(True)
    c = None if rgb is None else rgb.clone().requires_grad_(True)
    out = neus_composite_plain(T["t"], T["mask"], *ins, T["rays_d"], 0.5, inv_s, c)
    names = ("vw", "mask_volume", "depth_volume", "rgb_volume", "normals_volume")
    loss = sum((o * cot[k]).sum() for o, k in zip(out[:5], names) if o is not None)
    leaves = ins + [inv_s] + ([] if c is None else [c])
    want = torch.autograd.grad(loss, leaves)
    d_sdf, d_nab, d_rgb, d_inv = neus_composite_bwd(
        T["t"], T["mask"], T["sdf"], T["nablas"], T["rays_d"], 0.5, torch.tensor(300.0), rgb,
        cot["vw"], cot["mask_volume"], cot["depth_volume"],
        cot["rgb_volume"] if with_rgb else None, cot["normals_volume"], None)
    assert d_inv.shape == (T["t"].shape[0],) and float(d_inv[7]) == 0.0
    for g, w in zip((d_sdf, d_nab, d_inv.sum(), d_rgb), want[:3] + want[3:]):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))
    assert (d_rgb is None) == (not with_rgb)


def test_fused_buffer_integrates_as_the_alpha_buffer():
    """neus_integrate on a buffer without alpha (rays_d, cos_anneal and
    details.inv_s instead) gives volume_integrate's outputs of the buffer
    with its alpha, and leaves that alpha in the buffer."""
    b = {k: torch.from_numpy(v) for k, v in _buffer(seed=5).items()}
    inv_s = torch.tensor(300.0)
    ref = neus_composite_plain(b["t"], b["mask"], b["sdf"], b["nablas"], b["rays_d"], 0.25,
                               inv_s, b["rgb"])
    fused = {"t": b["t"], "mask": b["mask"], "sdf": b["sdf"], "nablas": b["nablas"],
             "rgb": b["rgb"], "rays_d": b["rays_d"], "cos_anneal": 0.25,
             "details": {"inv_s": inv_s}}
    with_alpha = {"t": b["t"], "mask": b["mask"], "alpha": ref[6], "rgb": b["rgb"],
                  "nablas": b["nablas"]}
    got, want = neus_integrate(fused), volume_integrate(with_alpha)
    assert torch.equal(fused["alpha"], ref[6])
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_alpha_clip_tie_passes_half_the_gradient_as_jax():
    """neus_alpha_from_sdf at alpha == 1 exactly: jnp.clip passes half the
    gradient there, and so does the port (torch.clamp would pass it all)."""
    sdf = np.array([0.03, 0.03, 0.2, 0.001], np.float32)
    cos = np.array([-1.2, -1.0, -0.5, -0.1], np.float32)
    dist = np.array([0.2, 0.2, 0.1, 0.05], np.float32)
    inv_s = np.float32(300.0)
    jg = np.asarray(jax.grad(lambda s, c: jnp.sum(jax_alpha(s, c, dist, inv_s)),
                             argnums=(0, 1))(jnp.asarray(sdf), jnp.asarray(cos))[0])
    s = torch.from_numpy(sdf).requires_grad_(True)
    a = neus_alpha_from_sdf(s, torch.from_numpy(cos), torch.from_numpy(dist), inv_s)
    tie = (a == 1.0).numpy()
    assert tie[:2].all() and not tie[3]
    (pg,) = torch.autograd.grad(a.sum(), s)
    assert np.all(np.abs(jg[tie]) > 0)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-5, atol=0)
    s2 = torch.from_numpy(sdf).requires_grad_(True)
    est_p, est_n = s2 - torch.from_numpy(cos * dist * 0.5), s2 + torch.from_numpy(cos * dist * 0.5)
    p, q = torch.sigmoid(est_p * inv_s), torch.sigmoid(est_n * inv_s)
    (full,) = torch.autograd.grad(torch.clamp((p - q + 1e-5) / (p + 1e-5), 0, 1).sum(), s2)
    np.testing.assert_allclose(pg.numpy()[tie], 0.5 * full.numpy()[tie], rtol=1e-6)
