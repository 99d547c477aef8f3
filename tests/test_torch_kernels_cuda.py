"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Inputs come from the seeded input functions of chip_smoke.py. Tolerances: K1/K3 1e-5
(the kernels round like the plain versions, operation by operation; they
agree bit for bit on the H100), K5a and K6 atol 1e-6 / rtol 1e-5 (the plain
versions reduce over the samples in another order), K5b exact. A whole
render on the card is held to the CPU at chip_smoke.CROP_TOL (see there). The
backward kernels are held to autograd of their plain versions at
chip_smoke.GRAD_REL times the largest gradient entry (both sides sum
thousands of float32 terms per entry in another order, the kernels with
atomics), and one training step on the card to the same step on the CPU at
chip_smoke.STEP_LOSS_RTOL and STEP_GRAD_REL (see there). K4's depths are held
to chip_smoke.K4_TOL, K7's values to chip_smoke.K7_ATOL with its mask exact
away from the threshold, the wide K1 (F = 96, R = 1,024) to the tolerances of
the narrow one, and a render of a small bench model (occupancy grid, distant
field) on the card to the CPU at chip_smoke.BENCH_CROP_TOL. K8 is held to its
plain version at chip_smoke.K8_TOL, and a small compose render (shared
vehicle model, street with its grid, distant field, sky) to the CPU ray by
ray as chip_smoke.check_compose_crop does. K8's backward is held to autograd
of its plain version at chip_smoke.GRAD_REL on buffers with alphas at the
clip's and the cap's edges, and the first multi-object training iteration
on the card to the CPU at the CPU's sample depths at
chip_smoke.MULTI_STEP_LOSS_RTOL and MULTI_STEP_GRAD_REL. K11's integer
outputs are held equal to its plain version's, K10's depths to
chip_smoke.K4_TOL, and a small crowd (6 vehicles on the pair-budget path with
per-instance grids) to the CPU as the compose render and the multi-object
iteration are.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from neuralsim_torch import kernels
from neuralsim_torch.accel import OccGridEma, OccGridEmaBatched
from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                            occ_ray_proposal, occ_ray_proposal_plain)
from neuralsim_torch.configs import (BENCH_OBJECT, SYNTHETIC_OBJECT, WAYMO_DEMO_CROWD,
                                    WAYMO_DEMO_MULTI)
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset, sdf_scene_tensor
from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
from neuralsim_torch.fields.encodings import lotd
from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
from neuralsim_torch.ops.pair_compact import pair_compact, pair_compact_plain
from neuralsim_torch.ops.segment import (cross_source_vw, cross_source_vw_bwd,
                                         cross_source_vw_bwd_plain, cross_source_vw_fwd,
                                         cross_source_vw_plain, merge_sorted_samples,
                                         merge_sorted_samples_plain)
from neuralsim_torch.renderers.buffers import (volume_composite, volume_composite_bwd,
                                               volume_composite_bwd_plain,
                                               volume_composite_plain)
from neuralsim_torch.scene import Scene
from neuralsim_torch.scene.observers import camera_get_all_rays
from neuralsim_torch.tools.build import (build_compose_renderer, build_multi_trainer,
                                         build_renderer, build_trainer, converge_occ,
                                         render_multi_frame)
from neuralsim_torch.tools.train_multi import train_loop

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _close(got, want, rtol, atol):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_jac", [False, True])
def test_k1_cp_stacked(dev, with_jac):
    _, params = build_renderer(SYNTHETIC_OBJECT, device=dev)
    enc = params["Main"].encoding
    lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
    x = _t(cs.enc_points(100_003, enc.cp_rmax, 0), dev)
    args = (lines, x, enc._cp_rows)
    _close(cs.encode_into(lotd.lotd_cp_stacked, args, enc.out_dim, x.shape[0], dev, with_jac),
           cs.encode_into(lotd.lotd_cp_stacked_plain, args, enc.out_dim, x.shape[0], dev,
                          with_jac), 1e-5, 1e-5)


@pytest.mark.parametrize("cfg", ["full", "dense"])
def test_k3_grid(dev, cfg):
    if cfg == "full":
        _, params = build_renderer(SYNTHETIC_OBJECT, device=dev)
        enc = params["Main"].encoding
    else:
        enc = cs.small_encoding(dev)
    x = _t(cs.enc_points(100_003, 64, 1), dev)
    args = (enc.table.detach(), x, enc._grid_meta)
    for jac in (False, True):
        _close(cs.encode_into(lotd.lotd_grid, args, enc.out_dim, x.shape[0], dev, jac),
               cs.encode_into(lotd.lotd_grid_plain, args, enc.out_dim, x.shape[0], dev, jac),
               1e-5, 1e-5)


@pytest.mark.parametrize("noisy", [False, True])
def test_k5a_weights_pdf(dev, noisy):
    args = [_t(a, dev) for a in cs.stage_inputs(4096, 80, 2)]
    noise = torch.rand((4096, 16), generator=torch.Generator().manual_seed(0)).to(dev) \
        if noisy else None
    got = upsample_weights_pdf(*args, 256.0, 16, noise)
    want = upsample_weights_pdf_plain(*args, 256.0, 16, noise)
    _close(got[:1], want[:1], 1e-5, 1e-6)
    _close(got[1:], want[1:], 1e-5, 1e-6)


def test_k5b_merge(dev):
    ins = [_t(a, dev) for a in cs.merge_inputs(4096, 80, 16, 3)]
    got = merge_sorted_samples(*ins)
    want = merge_sorted_samples_plain(*ins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k6_composite(dev):
    args = [_t(a, dev) for a in cs.composite_inputs(4096, 96, 4)]
    _close(volume_composite(*args), volume_composite_plain(*args), 1e-5, 1e-6)


def test_render_on_card_matches_cpu(dev):
    renderer, params = build_renderer(SYNTHETIC_OBJECT, device=dev)
    rig = SyntheticObjectDataset(n_frames=4, H=16, W=16)
    o, d = (torch.from_numpy(a.reshape(-1, 3).copy()) for a in rig.frame_rays(0))
    kernels.reset_counts()
    got = renderer.render_chunked(params, o.to(dev), d.to(dev), rayschunk=100)
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in kernels.KERNELS.values()
               if not k.name.endswith(".bwd")
               and k.name not in cs.BENCH_ONLY + cs.COMPOSE_ONLY + cs.CROWD_ONLY)
    want = renderer.render_chunked(copy.deepcopy(params).to("cpu"), o, d, rayschunk=100)
    for k, v in want.items():
        torch.testing.assert_close(got[k].cpu(), v, rtol=0, atol=cs.CROP_TOL,
                                   msg=lambda m, k=k: f"{k}: {m}")


def _rel_close(got, want, rel):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= rel * float(w.abs().max())


@pytest.mark.parametrize("which", ["feats", "jac", "both"])
@pytest.mark.parametrize("n", [512, 100_003])
def test_k1_cp_stacked_backward(dev, which, n):
    _, params = build_renderer(SYNTHETIC_OBJECT, device=dev)
    enc = params["Main"].encoding
    lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
    x = _t(cs.enc_points(n, enc.cp_rmax, 0), dev)
    d_out = None if which == "jac" else cs.cotangents((enc.out_dim, n), 1, dev)
    d_jac = None if which == "feats" else cs.cotangents((3, enc.out_dim, n), 2, dev)
    args = (lines, x, enc._cp_rows, d_out, d_jac)
    _rel_close([lotd.lotd_cp_stacked_bwd(*args)], [lotd.lotd_cp_stacked_bwd_plain(*args)],
               cs.GRAD_REL)


@pytest.mark.parametrize("which", ["feats", "jac", "both"])
@pytest.mark.parametrize("cfg", ["full", "dense"])
def test_k3_grid_backward(dev, cfg, which):
    if cfg == "full":
        _, params = build_renderer(SYNTHETIC_OBJECT, device=dev)
        enc = params["Main"].encoding
    else:
        enc = cs.small_encoding(dev)
    n = 100_003
    x = _t(cs.enc_points(n, 64, 1), dev)     # cell faces, 0 and 1 included
    d_out = None if which == "jac" else cs.cotangents((enc.out_dim, n), 3, dev)
    d_jac = None if which == "feats" else cs.cotangents((3, enc.out_dim, n), 4, dev)
    args = (enc.table.numel(), x, enc._grid_meta, d_out, d_jac)
    _rel_close([lotd.lotd_grid_bwd(*args)], [lotd.lotd_grid_bwd_plain(*args)], cs.GRAD_REL)


def test_k6_composite_backward(dev):
    n, s = 2048, 96
    args = [_t(a, dev) for a in cs.composite_inputs(n, s, 4)]     # alpha == 1, masked rays
    grads = [cs.cotangents(sh, 5 + i, dev)
             for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3)))]
    _rel_close(volume_composite_bwd(*args, *grads), volume_composite_bwd_plain(*args, *grads),
               cs.GRAD_REL)
    got = volume_composite_bwd(*args[:3], None, None, *grads[:3], None, None)
    want = volume_composite_bwd_plain(*args[:3], None, None, *grads[:3], None, None)
    assert got[1] is None and got[2] is None
    _rel_close(got[:1], want[:1], cs.GRAD_REL)


def test_encoding_autograd_on_card_matches_cpu(dev):
    enc = cs.small_encoding(dev)
    x = _t(cs.enc_points(4096, enc.cp_rmax, 2), dev)
    c1, c2 = cs.cotangents((4096, enc.out_dim), 6, dev), cs.cotangents((4096, enc.out_dim, 3), 7,
                                                                         dev)
    grads = []
    for e, to in ((enc, lambda a: a), (copy.deepcopy(enc).cpu(), lambda a: a.cpu())):
        h, j = e.with_jacobian(to(x))
        ((to(c1) * h).sum() + (to(c2) * j).sum()).backward()
        grads.append(e.table.grad.cpu())
    _rel_close(grads[:1], grads[1:], cs.GRAD_REL)


def test_train_step_on_card_matches_cpu(dev):
    trainer, state = build_trainer(SYNTHETIC_OBJECT, device=dev)
    rig = SyntheticObjectDataset(**SYNTHETIC_OBJECT["dataset_cfg"]["params"])
    kernels.reset_counts()
    loss_err, grad_err = cs.check_first_step(trainer, state, rig, dev, n_rays=512)
    assert all(k.launches > 0 for k in kernels.KERNELS.values()
               if k.name not in cs.BENCH_ONLY + cs.COMPOSE_ONLY + cs.MULTI_ONLY + cs.CROWD_ONLY)
    assert loss_err <= cs.STEP_LOSS_RTOL and grad_err <= cs.STEP_GRAD_REL


# ---------------------------------------------------------------------------
# The bench model's kernels: K4, K7 and K1 at F = 96, R = 1,024
# ---------------------------------------------------------------------------

def _grid(dev, res=64):
    accel = OccGridEma(AABBSpace().to(dev), res, n_warmup_steps=0, occ_inv_s=64.0,
                       march_steps=48, ema_decay=0.5)
    return accel, converge_occ(accel, accel.init_state(), sdf_scene_tensor, n=4)


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("grid", ["converged", "empty", "full", "outside"])
def test_k4_occ_ray_proposal(dev, grid, noisy):
    accel, st = _grid(dev)
    rig = SyntheticObjectDataset(n_frames=4, H=64, W=64)
    o, d = (_t(a.reshape(-1, 3).copy(), dev) for a in rig.frame_rays(1))
    near, far, _ = AABBSpace().to(dev).ray_test(o, d)
    mask = {"empty": torch.zeros_like(st.mask), "full": torch.ones_like(st.mask)}.get(grid, st.mask)
    if grid == "outside":       # probes that leave the box
        near, far = torch.full_like(near, 0.1), torch.full_like(far, 6.0)
    noise = torch.rand((o.shape[0], 16), generator=torch.Generator().manual_seed(0)).to(dev) \
        if noisy else None
    args = (o, d, near, far, mask, *accel.box(dev), accel.edges01(48, dev), 16, noise)
    n0 = kernels.KERNELS["occ_ray_proposal"].launches
    got = occ_ray_proposal(*args)
    assert kernels.KERNELS["occ_ray_proposal"].launches == n0 + 1
    _close([got], [occ_ray_proposal_plain(*args)], **cs.K4_TOL)


@pytest.mark.parametrize("floor", [None, 0.301])
@pytest.mark.parametrize("mode", ["sdf", "density"])
@pytest.mark.parametrize("s", [1, 4])
def test_k7_occ_ema_update(dev, s, mode, floor):
    rng = np.random.default_rng(1)
    v = 64 ** 3
    raw = _t(rng.normal(0, 0.2, (s, v)).astype(np.float32), dev)
    raw = raw if mode == "sdf" else raw.abs() * 40.0
    val = _t(rng.random(v).astype(np.float32), dev)
    args = (raw, val, mode, 0.027, 64.0, 0.95, 0.3, floor)
    got, want = occ_ema_update(*args), occ_ema_update_plain(*args)
    _close(got[:1], want[:1], 0, cs.K7_ATOL)
    assert got[1].dtype == torch.bool
    assert not ((got[1] != want[1]) & ((want[0] - 0.3).abs() > cs.K7_ATOL)).any()


def _wide_encoding(dev):
    _, params = build_renderer(BENCH_OBJECT, device=dev)
    enc = params["cr"].encoding
    assert enc.cp_out_dim == 96 and enc.cp_rmax == 1024
    return enc, enc.cp_stacked_lines().detach().to(torch.bfloat16)


@pytest.mark.parametrize("with_jac", [False, True])
def test_k1_cp_stacked_wide(dev, with_jac):
    enc, lines = _wide_encoding(dev)
    x = _t(cs.ray_points(1024, 32, enc.cp_rmax, 0), dev)
    args = (lines, x, enc._cp_rows)
    _close(cs.encode_into(lotd.lotd_cp_stacked, args, enc.out_dim, x.shape[0], dev, with_jac),
           cs.encode_into(lotd.lotd_cp_stacked_plain, args, enc.out_dim, x.shape[0], dev,
                          with_jac), 1e-5, 1e-5)


@pytest.mark.parametrize("which", ["feats", "jac", "both"])
@pytest.mark.parametrize("n", [1024, 32_768])
def test_k1_cp_stacked_wide_backward(dev, which, n):
    enc, lines = _wide_encoding(dev)
    x = _t(cs.ray_points(n // 32, 32, enc.cp_rmax, 0), dev)
    d_out = None if which == "jac" else cs.cotangents((enc.out_dim, n), 1, dev)
    d_jac = None if which == "feats" else cs.cotangents((3, enc.out_dim, n), 2, dev)
    args = (lines, x, enc._cp_rows, d_out, d_jac)
    _rel_close([lotd.lotd_cp_stacked_bwd(*args)], [lotd.lotd_cp_stacked_bwd_plain(*args)],
               cs.GRAD_REL)


@pytest.mark.parametrize("n_rays", [4096, 8192])
def test_sample_kernels_at_the_bench_shapes(dev, n_rays):
    """K5a, K5b and K6 at 16 -> 24 -> 32 samples with 8 draws a stage and the
    two-buffer composite over 64 lanes; K6's backward with all five cotangents."""
    res, _ = cs.check_sample_kernels(dev, n_rays, ((16, 64.0), (24, 256.0)), 8, 64, noisy=True,
                                     two_buffers=True)
    assert set(res) == {"neus_upsample.weights_pdf", "neus_upsample.merge", "volume_composite"}
    (err, tol), _ = cs.check_composite_bwd(dev, n_rays, 64, two_buffers=True)
    assert tol == cs.GRAD_REL and np.isfinite(err)


def _small_bench():
    cfg = copy.deepcopy(BENCH_OBJECT)
    cfg["accel_cfg"]["cr"].update(resolution=32, ema_decay=0.5)
    cfg["occ_converge"] = {"n": 4, "it": 1000}
    cfg["training"].update(n_rays=512, uniform_sample_n=128)
    return cfg


def test_bench_render_on_card_matches_cpu(dev):
    trainer, state = build_trainer(_small_bench(), device=dev)
    rig = SyntheticObjectDataset(n_frames=4, H=16, W=16)
    o, d = (torch.from_numpy(a.reshape(-1, 3).copy()) for a in rig.frame_rays(0))
    kernels.reset_counts()
    got = trainer.renderer.render_chunked(state.params, o.to(dev), d.to(dev), rayschunk=100,
                                          occ_states=state.occ)
    torch.cuda.synchronize()
    assert kernels.KERNELS["occ_ray_proposal"].launches == 3
    want = trainer.renderer.render_chunked(copy.deepcopy(state.params).to("cpu"), o, d,
                                           rayschunk=100, occ_states=cs.occ_on(state, "cpu"))
    # the normals apart: the untrained 1,024-wide grid's gradient is noise of
    # slope ~100 that steps at every cell face, so chip_smoke.check_crop_by_ray
    # holds them at equal sample depths and on every ray that both sides sample
    # at bit-equal depths (see there)
    for k, v in want.items():
        if k == "normals_volume":
            continue
        scale = 1.0 + v.abs() if k == "depth_volume" else 1.0
        assert float(((got[k].cpu() - v).abs() / scale).max()) <= cs.BENCH_CROP_TOL, k
    res = cs.check_crop_by_ray(trainer.renderer, state.params, o, d, dev, state.occ,
                               cs.occ_on(state, "cpu"))
    assert res["same_depths_err"] <= 1.0 and res["equal_rays_err"] <= 1.0
    assert res["other_mean_err"] <= cs.OTHER_MEAN_TOL


def test_bench_train_step_on_card_matches_cpu(dev):
    trainer, state = build_trainer(_small_bench(), device=dev)
    rig = SyntheticObjectDataset(n_frames=4, H=32, W=32)
    kernels.reset_counts()
    loss_err, grad_err = cs.check_first_step(trainer, state, rig, dev, 512,
                                             cs.BENCH_STEP_LOSS_RTOL, cs.BENCH_STEP_GRAD_REL,
                                             cs.BENCH_SAME_SAMPLES)
    assert loss_err <= cs.BENCH_STEP_LOSS_RTOL and grad_err <= cs.BENCH_STEP_GRAD_REL
    # once to find the rays that both sides sample alike, once in the step
    assert kernels.KERNELS["occ_ray_proposal"].launches == 2
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = cs.device_batch(rig, np.random.default_rng(0), 512, dev)
    state, m = trainer.train_step(state, batch, trainer.draw_noise(512, gen, state.it))
    torch.cuda.synchronize()
    assert kernels.KERNELS["occ_ema_update"].launches == 1 and 0 < float(m["occ_frac"]) < 1
    assert kernels.KERNELS["lotd_cp_stacked.bwd"].launches >= 2 and int(m["step_skipped"]) == 0


# ---------------------------------------------------------------------------
# The compose path: K8, K4 at 64 march segments, a small compose render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,L", [(4096, 168), (333, 1), (257, 5), (512, 257), (64, 1100)])
def test_k8_cross_source_vw(dev, n, L):
    args = [_t(a, dev) for a in cs.unsorted_inputs(n, L, L)]
    n0 = kernels.KERNELS["cross_source_vw"].launches
    got = cross_source_vw(*args)
    assert kernels.KERNELS["cross_source_vw"].launches == n0 + 1
    _close([got], [cross_source_vw_plain(*args)], **cs.K8_TOL)


def test_k8_gradient_on_the_card_runs_both_kernels(dev):
    """A gradient on the card is no longer refused: under autograd the forward
    kernel (which also writes the log transmittance) and the backward kernel
    run, and nothing falls back to the plain version."""
    t, mask, alpha = (_t(a, dev) for a in cs.edge_alpha_inputs(16, 12, 0))
    counts = lambda: [kernels.KERNELS[k].launches for k in ("cross_source_vw",
                                                           "cross_source_vw.bwd")]
    n0 = counts()
    a = alpha.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(cross_source_vw(t, mask, a).sum(), a)
    assert counts() == [n0[0] + 1, n0[1] + 1]
    assert torch.isfinite(g).all()
    with torch.no_grad():
        assert torch.isfinite(cross_source_vw(t, mask, a)).all()
    assert counts() == [n0[0] + 2, n0[1] + 1]


@pytest.mark.parametrize("n,L", [(4096, 168), (333, 1), (257, 5), (512, 257), (64, 1100)])
def test_k8_cross_source_vw_backward(dev, n, L):
    """K8's backward kernel against autograd of the plain version on ragged,
    tied and masked buffers with alphas at 0, 1, float32(0.999) and outside
    [0, 1], within cs.GRAD_REL of the largest entry."""
    t, mask, alpha = (_t(a, dev) for a in cs.edge_alpha_inputs(n, L, L))
    g = cs.cotangents((n, L), 11, dev)
    a = alpha.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(cross_source_vw(t, mask, a), a, g)
    _rel_close([got], [cross_source_vw_bwd_plain(t, mask, alpha, g)], cs.GRAD_REL)
    logt = cross_source_vw_fwd(t, mask, alpha, with_logt=True)[1]
    _rel_close([cross_source_vw_bwd(t, mask, alpha, logt, g)], [got], 0.0)


def test_k4_occ_ray_proposal_at_64_segments(dev):
    accel = OccGridEma(AABBSpace().to(dev), 64, n_warmup_steps=0, occ_inv_s=64.0,
                       march_steps=64, ema_decay=0.5)
    st = converge_occ(accel, accel.init_state(), sdf_scene_tensor, n=4)
    rig = SyntheticObjectDataset(n_frames=4, H=64, W=64)
    o, d = (_t(a.reshape(-1, 3).copy(), dev) for a in rig.frame_rays(2))
    near, far, _ = AABBSpace().to(dev).ray_test(o, d)
    noise = torch.rand((o.shape[0], 32), generator=torch.Generator().manual_seed(0)).to(dev)
    for nz in (None, noise):
        args = (o, d, near, far, st.mask, *accel.box(dev), accel.edges01(64, dev), 32, nz)
        _close([occ_ray_proposal(*args)], [occ_ray_proposal_plain(*args)], **cs.K4_TOL)


def _small_compose():
    cfg = copy.deepcopy(WAYMO_DEMO_MULTI)
    cfg["dataset_cfg"]["params"].update(H=40, W=64)
    b = cfg["assetbank_cfg"]
    b["Street"]["model_params"]["accel_cfg"].update(resolution=32)
    b["Vehicle"]["model_params"]["query_cfg"].update(num_coarse=12)
    return cfg


def test_compose_render_on_card_matches_cpu(dev):
    cfg = _small_compose()
    scene, _, renderer, params = build_compose_renderer(cfg, device=dev)
    accel = renderer.accels["cr"]
    occ = {"cr": converge_occ(accel, accel.init_state(), ground_sdf_tensor, n=30)}
    kernels.reset_counts()
    out = render_multi_frame(renderer, params, scene, 0, "camera_FRONT", occ, rayschunk=1024)
    torch.cuda.synchronize()
    assert kernels.KERNELS["cross_source_vw"].launches == 3
    assert kernels.KERNELS["occ_ray_proposal"].launches == 3
    assert kernels.KERNELS["volume_composite"].launches == 0
    m = out["mask_volume"]
    assert float(m.min()) >= 0.0 and float(m.max()) <= cs.MASK_CAP
    share = sum(sub["mask_volume"] for sub in out["per_obj"].values())
    assert float((share - m).abs().max()) <= cs.SHARE_SUM_TOL
    frozen = scene.slice_at(0)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", 40, 64)
    crop = cs.compose_crop(40, 64)
    cut = lambda a: a.reshape(40, 64, 3)[crop].reshape(-1, 3).cpu().contiguous()
    scene_cpu = Scene.load_from_scenario(demo_scenario(**cfg["dataset_cfg"]["params"]))
    res = cs.check_compose_crop(renderer, params, frozen, scene_cpu.slice_at(0), cut(o), cut(d),
                                dev, occ, {"cr": type(occ["cr"])(occ["cr"].val.cpu(),
                                                                occ["cr"].mask.cpu())})
    assert res["merge_err"] <= 1.0 and res["equal_rays_err"] <= 1.0
    assert res["equal_rays"] >= cs.COMPOSE_EQUAL_MIN * res["rays"]
    assert max(res["other_mean_err"], res["own_mean_err"]) <= cs.OTHER_MEAN_TOL


# ---------------------------------------------------------------------------
# Multi-object training: K1 and K3 backwards at its shapes, its first
# iteration card vs CPU, a few iterations with their launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,n_rows,s", [("Street", 4096, 48), ("Street", 2048, 48),
                                            ("Vehicle", 3 * 2048, 32)])
def test_k1_k3_backward_at_the_multi_object_training_shapes(dev, model, n_rows, s):
    """The street's K1 (F_cp 40, R 1,024) at a pixel and a LiDAR step's final
    samples, the vehicles' K1 (F_cp 24, R 256) and K3 (two dense levels) at
    their compacted rows' final samples, both cotangents."""
    _, _, _, params = build_compose_renderer(WAYMO_DEMO_MULTI, device=dev)
    enc = params[f"{model}#demo_drive"].encoding
    x = _t(cs.ray_points(n_rows, s, enc.cp_rmax, 5), dev)
    n = x.shape[0]
    d_out = cs.cotangents((enc.out_dim, n), 6, dev)
    d_jac = cs.cotangents((3, enc.out_dim, n), 7, dev)
    lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
    args = (lines, x, enc._cp_rows, d_out, d_jac)
    _rel_close([lotd.lotd_cp_stacked_bwd(*args)], [lotd.lotd_cp_stacked_bwd_plain(*args)],
               cs.GRAD_REL)
    if enc.grid_spec_ids:
        args = (enc.table.numel(), x, enc._grid_meta, d_out, d_jac)
        _rel_close([lotd.lotd_grid_bwd(*args)], [lotd.lotd_grid_bwd_plain(*args)], cs.GRAD_REL)


@pytest.fixture
def multi_built(dev):
    return build_multi_trainer(WAYMO_DEMO_MULTI, device=dev)


def test_multi_object_first_iteration_on_card_matches_cpu(dev, multi_built):
    scene, _, trainer, state, samplers = multi_built
    loss_err, grad_err = cs.check_multi_first_iteration(scene, trainer, state, samplers, dev)
    assert loss_err <= cs.MULTI_STEP_LOSS_RTOL and grad_err <= cs.MULTI_STEP_GRAD_REL


def test_multi_object_iterations_launch_their_kernels(dev, multi_built):
    """Three loop iterations: K8 and its backward, K6 and its backward once an
    iteration, K4 twice, K7 on the first (the grid's cadence), no skip."""
    scene, _, trainer, state, samplers = multi_built
    kernels.reset_counts()
    log = []
    train_loop(scene, trainer, state, samplers, 3, torch.Generator(device=dev).manual_seed(0), 1,
               log)
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in kernels.KERNELS.values()}
    assert [n[k] for k in ("cross_source_vw", "cross_source_vw.bwd", "volume_composite",
                           "volume_composite.bwd", "occ_ray_proposal", "occ_ema_update")] == \
        [3, 3, 3, 3, 6, 1]
    assert all(v > 0 for k, v in n.items() if k not in cs.CROWD_ONLY)
    assert not any(n[k] for k in cs.CROWD_ONLY)      # 3 vehicles: no pair budget, no K10
    assert log[-1]["skips_total"] == 0 and all(np.isfinite(r["loss_total"]) for r in log)


# ---------------------------------------------------------------------------
# Crowded scenes: K11 (pair-budget compaction), K10 (per-instance grids)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["ragged", "every pair", "no hit", "rays through", "long"])
def test_k11_pair_compact(dev, group):
    """Selected pairs, hit flags and slot indices equal to the plain version
    (the JAX package's argsort lines), integer for integer, with and without
    the slots: T below and above the budget, odd N at half a budget, rays
    through more boxes than slots."""
    sets = [c for c in cs.pair_edge_masks(dev) if c[0].startswith(group)]
    assert sets
    for label, hit, Bg, M in sets:
        for m in (M, None):
            n0 = kernels.KERNELS["pair_compact"].launches
            got = pair_compact(hit, Bg, m)
            assert kernels.KERNELS["pair_compact"].launches == n0 + 1
            want = pair_compact_plain(hit, Bg, m)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w)), \
                    (label, m)


def _batched_grid(dev, G=8, R=32):
    accel = OccGridEmaBatched(AABBSpace().to(dev), G, R, n_warmup_steps=0, occ_inv_s=64.0)
    shift = torch.linspace(-0.3, 0.3, G, device=dev)
    st = converge_occ(accel, accel.init_state(),
                      lambda x, b: sdf_scene_tensor(x + shift[b][:, None]), n=4)
    return accel, st


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("case", ["converged", "random", "outside", "wild lead", "keyframes"])
def test_k10_occ_ray_proposal_batched(dev, case, noisy):
    """K10 against its plain version: per-instance grids that differ (a wrong
    grid index shows), probes outside the box, grid indices outside [0, G)
    (clipped), the dynamic grid's keyframes of times in [-0.2, 1.2]."""
    accel, st = _batched_grid(dev)
    G, R = st.mask.shape[0], st.mask.shape[-1]
    rig = SyntheticObjectDataset(n_frames=4, H=64, W=64)
    o, d = (_t(a.reshape(-1, 3).copy(), dev) for a in rig.frame_rays(1))
    n = o.shape[0]
    near, far, _ = AABBSpace().to(dev).ray_test(o, d)
    gen = torch.Generator().manual_seed(3)
    lead = torch.randint(0, G, (n,), generator=gen, dtype=torch.int32).to(dev)
    mask = st.mask
    if case != "converged":
        share = torch.linspace(0.05, 0.6, G)[:, None, None, None]
        mask = (torch.rand((G, R, R, R), generator=gen) < share).to(dev)
    if case == "outside":
        near, far = torch.full_like(near, 0.1), torch.full_like(far, 6.0)
    if case == "wild lead":
        lead = torch.randint(-3, G + 3, (n,), generator=gen, dtype=torch.int32).to(dev)
    if case == "keyframes":
        t01 = torch.rand((n,), generator=gen).to(dev) * 1.4 - 0.2
        lead = (t01 * G).to(torch.int32).clamp(0, G - 1)
    noise = torch.rand((n, 24), generator=gen).to(dev) if noisy else None
    args = (o, d, near, far, mask, *accel.box(dev), accel.edges01(64, dev), 24, noise, lead)
    n4, n10 = (kernels.KERNELS[k].launches for k in ("occ_ray_proposal",
                                                     "occ_ray_proposal_batched"))
    got = occ_ray_proposal(*args)
    assert kernels.KERNELS["occ_ray_proposal_batched"].launches == n10 + 1
    assert kernels.KERNELS["occ_ray_proposal"].launches == n4
    _close([got], [occ_ray_proposal_plain(*args)], **cs.K4_TOL)


def _small_crowd():
    cfg = copy.deepcopy(WAYMO_DEMO_CROWD)
    cfg["dataset_cfg"]["params"].update(H=40, W=64, n_vehicles=6)
    b = cfg["assetbank_cfg"]
    b["Street"]["model_params"]["accel_cfg"].update(resolution=32)
    b["Vehicle"]["model_params"]["accel_cfg"].update(resolution=16)
    return cfg


def test_crowd_render_on_card_matches_cpu(dev):
    """6 vehicles (pair budget, per-instance grids converged on the model's
    own SDF): K11, K10, K8 and K4 once a chunk; the frame within the mask
    limits; a crop held to the CPU path as chip_smoke.check_compose_crop
    holds it (at the CPU path's street and vehicle-grid depths)."""
    cfg = _small_crowd()
    scene, _, renderer, params = build_compose_renderer(cfg, device=dev)
    veh = renderer.objects[0].model_id
    sa, va = renderer.accels["cr"], renderer.accels[veh]
    occ = {"cr": converge_occ(sa, sa.init_state(), ground_sdf_tensor, n=30),
           veh: converge_occ(va, va.init_state(),
                             lambda x, b: params[veh].query_sdf(x, bidx=b), n=40)}
    kernels.reset_counts()
    out = render_multi_frame(renderer, params, scene, 0, "camera_FRONT", occ, rayschunk=1024)
    torch.cuda.synchronize()
    for k in ("cross_source_vw", "occ_ray_proposal", "pair_compact", "occ_ray_proposal_batched"):
        assert kernels.KERNELS[k].launches == 3, k
    m = out["mask_volume"]
    assert float(m.min()) >= 0.0 and float(m.max()) <= cs.MASK_CAP
    share = sum(sub["mask_volume"] for sub in out["per_obj"].values())
    assert float((share - m).abs().max()) <= cs.SHARE_SUM_TOL
    frozen = scene.slice_at(0)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", 40, 64)
    crop = cs.compose_crop(40, 64)
    cut = lambda a: a.reshape(40, 64, 3)[crop].reshape(-1, 3).cpu().contiguous()
    scene_cpu = Scene.load_from_scenario(demo_scenario(**cfg["dataset_cfg"]["params"]))
    res = cs.check_compose_crop(renderer, params, frozen, scene_cpu.slice_at(0), cut(o), cut(d),
                                dev, occ, {k: type(v)(v.val.cpu(), v.mask.cpu())
                                           for k, v in occ.items()})
    assert res["merge_err"] <= 1.0 and res["equal_rays_err"] <= 1.0
    assert res["equal_rays"] >= cs.COMPOSE_EQUAL_MIN * res["rays"]


@pytest.fixture
def crowd_built(dev):
    cfg = _small_crowd()
    cfg["training"].update(n_rays=1024, n_rays_lidar=512)
    return build_multi_trainer(cfg, device=dev)


def test_crowd_first_iteration_on_card_matches_cpu(dev, crowd_built):
    scene, _, trainer, state, samplers = crowd_built
    loss_err, grad_err = cs.check_multi_first_iteration(scene, trainer, state, samplers, dev)
    assert loss_err <= cs.MULTI_STEP_LOSS_RTOL and grad_err <= cs.MULTI_STEP_GRAD_REL


def test_crowd_iterations_launch_their_kernels(dev, crowd_built):
    """Three loop iterations: K11 and K10 once a pixel step, K8 and its
    backward once, K4 twice, K7 on the first for both grids, no skip."""
    scene, _, trainer, state, samplers = crowd_built
    kernels.reset_counts()
    log = []
    train_loop(scene, trainer, state, samplers, 3, torch.Generator(device=dev).manual_seed(0), 1,
               log)
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in kernels.KERNELS.values()}
    assert [n[k] for k in ("pair_compact", "occ_ray_proposal_batched", "cross_source_vw",
                           "cross_source_vw.bwd", "occ_ray_proposal", "occ_ema_update")] == \
        [3, 3, 3, 3, 6, 2]
    assert log[-1]["skips_total"] == 0 and all(np.isfinite(r["loss_total"]) for r in log)
