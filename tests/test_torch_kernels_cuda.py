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
iteration are. K2 (per-level CP) is held to its plain version at K1's
tolerances, its backward at chip_smoke.GRAD_REL (also for a level past the
backward's shared memory); K12 (the NeuS alpha inside the composite) at
chip_smoke.K12_TOL, its backward at chip_smoke.GRAD_REL. K9 (the permuto
lattice) at chip_smoke.K9_TOL, its table gradient at chip_smoke.GRAD_REL and
its inputs' gradient at chip_smoke.K9_DX_REL, the permuto field under
autograd against the CPU at GRAD_REL, and the permuto vehicles' first
iteration as the multi-object one.
"""
import contextlib
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
                                    WAYMO_DEMO_MULTI, WAYMO_DEMO_PERMUTO)
from neuralsim_torch.fields.conditional import (ConditionalLoTDNeuSField,
                                                ConditionalPermutoNeuSField)
from neuralsim_torch.fields.encodings import permuto as pm
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
from neuralsim_torch.renderers.neus_composite import (neus_composite, neus_composite_bwd,
                                                      neus_composite_bwd_plain,
                                                      neus_composite_plain)
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


@pytest.mark.parametrize("n,a,b,levels", [*((n, a, b, 400) for n, a, b, _ in cs.STAGE_SHAPES),
                                           (1, 32, 8, 400), (4097, 40, 8, 400),
                                           (4097, 24, 8, 4), (4096, 32, 8, 4), (1, 80, 16, 4)])
def test_k5b_merge_at_the_multi_object_stage_widths(dev, n, a, b, levels):
    """The multi-object stages (cs.STAGE_SHAPES), one ray, a ragged count,
    and depths on a grid of 4 values (ties inside each list and across)."""
    ins = [_t(v, dev) for v in cs.merge_inputs(n, a, b, 7, levels)]
    got, want = merge_sorted_samples(*ins), merge_sorted_samples_plain(*ins)
    torch.cuda.synchronize()
    assert got[0].shape == (n, a + b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,a,b", [(64, 3000, 200), (8, 16000, 100)])
def test_k5b_merge_of_wide_lists(dev, n, a, b):
    """Lists past 48 KB of shared memory for four rays: three rays a block
    (3,200 depths a ray), then one with the opt-in limit (16,100)."""
    ins = [_t(v, dev) for v in cs.merge_inputs(n, a, b, 8)]
    got, want = merge_sorted_samples(*ins), merge_sorted_samples_plain(*ins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k5b_merge_refuses_lists_past_shared_memory(dev):
    from neuralsim_torch.ops.segment import MERGE_MAX_WIDTH
    ins = [_t(v, dev) for v in cs.merge_inputs(1, MERGE_MAX_WIDTH - 7, 8, 8)]
    with pytest.raises(ValueError, match="shared memory"):
        merge_sorted_samples(*ins)


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
               and k.name not in cs.BENCH_ONLY + cs.COMPOSE_ONLY + cs.CROWD_ONLY
               + cs.PERLEVEL_ONLY + cs.PERMUTO_ONLY)
    assert kernels.KERNELS["volume_composite"].launches == 0    # K12 composites it
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


def _vehicle_encoding(dev):
    """The vehicles' LoTD (2 dense levels, F 4, and 6 CP levels) as their
    conditional field builds it, on the card."""
    cfg = WAYMO_DEMO_MULTI["assetbank_cfg"]["Vehicle"]["model_params"]["encoding_cfg"]
    enc = ConditionalLoTDNeuSField(n_instances=3, encoding_cfg=cfg).encoding
    enc.reset_parameters(torch.Generator().manual_seed(0))
    return enc.to(dev)


def _k3_case(dev, case):
    """(encoding, points) for K3's backward: the vehicles' final query (3 x
    2,048 compacted rows x 32 samples), the same count of points all in one
    cell of each dense level, small_encoding's private dense and global hash
    levels at 2,048 rays x 32 samples."""
    if case == "mixed":
        return cs.small_encoding(dev), cs.ray_points(2048, 32, 64, 9)
    enc = _vehicle_encoding(dev)
    if case == "vehicles":
        return enc, cs.ray_points(3 * 2048, 32, enc.cp_rmax, 8)
    rng = np.random.default_rng(8)
    return enc, (0.3 + 1e-3 * rng.random((3 * 2048 * 32, 3))).astype(np.float32)


@pytest.mark.parametrize("which", ["feats", "jac", "both"])
@pytest.mark.parametrize("case", ["vehicles", "one cell", "mixed"])
def test_k3_backward_with_private_levels(dev, case, which):
    """The private levels summed in shared memory and flushed by block, the
    global ones with atomics, against autograd of the plain version."""
    enc, pts = _k3_case(dev, case)
    plan = enc.grid_bwd_plan
    assert plan.private_mask and plan == lotd.grid_bwd_plan(enc._grid_meta.tolist())
    x = _t(pts, dev)
    n = x.shape[0]
    d_out = None if which == "jac" else cs.cotangents((enc.out_dim, n), 3, dev)
    d_jac = None if which == "feats" else cs.cotangents((3, enc.out_dim, n), 4, dev)
    args = (enc.table.numel(), x, enc._grid_meta, d_out, d_jac)
    n0 = kernels.KERNELS["lotd_grid.bwd"].launches
    got = lotd.lotd_grid_bwd(*args, plan=plan)
    assert kernels.KERNELS["lotd_grid.bwd"].launches == n0 + 1
    _rel_close([got], [lotd.lotd_grid_bwd_plain(*args)], cs.GRAD_REL)


@pytest.mark.parametrize("plan", [(0b11, 2 * (729 + 2197)), (0b11, 2 * 13_892), (0b10, 100)],
                         ids=["first level fits", "more floats", "no level fits"])
def test_k3_backward_with_a_plan_of_another_meta(dev, plan):
    """A plan that does not match the meta (small_encoding's at the
    vehicles' levels, one with floats to spare, one too small for any level)
    costs speed, not correctness: a named level that does not fit the copy
    takes device atomics."""
    enc, pts = _k3_case(dev, "vehicles")
    x = _t(pts, dev)
    n = x.shape[0]
    args = (enc.table.numel(), x, enc._grid_meta, cs.cotangents((enc.out_dim, n), 13, dev),
            cs.cotangents((3, enc.out_dim, n), 14, dev))
    _rel_close([lotd.lotd_grid_bwd(*args, plan=lotd.GridBwdPlan(*plan))],
               [lotd.lotd_grid_bwd_plain(*args)], cs.GRAD_REL)


def test_k3_backward_then_k2_backward_into_one_buffer(dev, monkeypatch):
    """On the per-level path K2's backward adds the CP levels into the buffer
    that K3's backward filled with the dense levels."""
    monkeypatch.setenv("NEURALSIM_CP_STACKED", "0")
    enc = _vehicle_encoding(dev)
    assert not enc.cp_stacked and enc._cp_meta.shape[0] == 6
    x = _t(cs.ray_points(3 * 2048, 32, enc.cp_rmax, 10), dev)
    n = x.shape[0]
    d_out = cs.cotangents((enc.out_dim, n), 11, dev)
    d_jac = cs.cotangents((3, enc.out_dim, n), 12, dev)
    table, grid = enc.table.detach(), (enc.table.numel(), x, enc._grid_meta, d_out, d_jac)
    got = lotd.lotd_cp_level_bwd(table, x, enc._cp_meta, d_out, d_jac,
                                 lotd.lotd_grid_bwd(*grid, plan=enc.grid_bwd_plan))
    want = lotd.lotd_cp_level_bwd_plain(table, x, enc._cp_meta, d_out, d_jac,
                                        lotd.lotd_grid_bwd_plain(*grid))
    dense = sum(r[1] * r[3] for r in enc._grid_meta.tolist())    # the dense levels come first
    _rel_close([got, got[:dense]], [want, want[:dense]], cs.GRAD_REL)


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
               if k.name not in cs.BENCH_ONLY + cs.COMPOSE_ONLY + cs.MULTI_ONLY + cs.CROWD_ONLY
               + cs.PERLEVEL_ONLY + cs.PERMUTO_ONLY)
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
    """Three loop iterations: K8 and its backward, K12 and its backward (the
    LiDAR step's street, composited alone) once an iteration, K6 never, K4
    twice, K7 on the first (the grid's cadence), no skip."""
    scene, _, trainer, state, samplers = multi_built
    kernels.reset_counts()
    log = []
    train_loop(scene, trainer, state, samplers, 3, torch.Generator(device=dev).manual_seed(0), 1,
               log)
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in kernels.KERNELS.values()}
    assert [n[k] for k in ("cross_source_vw", "cross_source_vw.bwd", "neus_composite",
                           "neus_composite.bwd", "volume_composite", "volume_composite.bwd",
                           "occ_ray_proposal", "occ_ema_update")] == [3, 3, 3, 3, 0, 0, 6, 1]
    assert all(v > 0 for k, v in n.items() if k not in cs.CROWD_ONLY + cs.PERLEVEL_ONLY
               + cs.PERMUTO_ONLY + ("volume_composite", "volume_composite.bwd"))
    assert not any(n[k] for k in cs.CROWD_ONLY)      # 3 vehicles: no pair budget, no K10
    assert not any(n[k] for k in cs.PERMUTO_ONLY)    # LoTD vehicles
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


# ---------------------------------------------------------------------------
# Per-level CP (K2), the NeuS alpha inside the composite (K12)
# ---------------------------------------------------------------------------

_LADDERS = {"street": {"type": "tpu_mixed", "n_levels": 10, "base_res": 16, "max_res": 1024,
                       "n_feats": 4, "n_hash_levels": 0, "cp_max_res": 1024},
            "bench": {"type": "tpu_mixed", "n_levels": 12, "base_res": 16, "max_res": 1024,
                      "n_feats": 8, "n_hash_levels": 0, "cp_max_res": 2048}}


def _per_level(dev, monkeypatch, ladder):
    monkeypatch.setenv("NEURALSIM_CP_STACKED", "0")
    enc = lotd.make_lotd(_LADDERS[ladder])
    assert not enc.cp_stacked and enc._cp_meta.shape[0] == enc.n_levels
    enc.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():      # spread the lines off their init, so the features vary
        enc.table.add_(torch.randn(enc.total_params, generator=torch.Generator().manual_seed(1))
                       * 0.3)
    return enc.to(dev)


@pytest.mark.parametrize("ladder", ["street", "bench"])
@pytest.mark.parametrize("with_jac", [False, True])
def test_k2_cp_level(dev, monkeypatch, ladder, with_jac):
    enc = _per_level(dev, monkeypatch, ladder)
    x = _t(cs.ray_points(4096, 48, 1024, 0), dev)
    args = (enc.table.detach(), x, enc._cp_meta)
    n0 = kernels.KERNELS["lotd_cp_level"].launches
    got = cs.encode_into(lotd.lotd_cp_level, args, enc.out_dim, x.shape[0], dev, with_jac)
    assert kernels.KERNELS["lotd_cp_level"].launches == n0 + 1
    _close(got, cs.encode_into(lotd.lotd_cp_level_plain, args, enc.out_dim, x.shape[0], dev,
                               with_jac), 1e-5, 1e-5)


@pytest.mark.parametrize("ladder", ["street", "bench"])
@pytest.mark.parametrize("which", ["feats", "jac", "both"])
def test_k2_cp_level_backward(dev, monkeypatch, ladder, which):
    enc = _per_level(dev, monkeypatch, ladder)
    x = _t(cs.ray_points(2048, 48, 1024, 1), dev)
    n = x.shape[0]
    d_out = None if which == "jac" else cs.cotangents((enc.out_dim, n), 2, dev)
    d_jac = None if which == "feats" else cs.cotangents((3, enc.out_dim, n), 3, dev)
    args = (enc.table.detach(), x, enc._cp_meta, d_out, d_jac)
    _rel_close([lotd.lotd_cp_level_bwd(*args)], [lotd.lotd_cp_level_bwd_plain(*args)],
               cs.GRAD_REL)


def test_k2_encoding_autograd_on_card_matches_cpu(dev, monkeypatch):
    """The per-level encoding under autograd (K2 and K3 forward and backward
    in one autograd Function) against the CPU path."""
    monkeypatch.setenv("NEURALSIM_CP_STACKED", "0")
    enc = lotd.make_lotd({"type": "tpu_mixed", "n_levels": 6, "base_res": 8, "max_res": 64,
                          "n_feats": 2, "n_hash_levels": 1, "log2_hashmap_size": 10,
                          "cp_max_res": 64})
    assert not enc.cp_stacked and enc._cp_meta.shape[0] >= 2 and enc.grid_spec_ids
    enc.reset_parameters(torch.Generator().manual_seed(2))
    x = _t(cs.enc_points(4096, 64, 2), dev)
    c1, c2 = cs.cotangents((4096, enc.out_dim), 6, dev), cs.cotangents((4096, enc.out_dim, 3),
                                                                         7, dev)
    grads = []
    for e, to in ((copy.deepcopy(enc).to(dev), lambda a: a), (enc, lambda a: a.cpu())):
        h, j = e.with_jacobian(to(x))
        ((to(c1) * h).sum() + (to(c2) * j).sum()).backward()
        grads.append(e.table.grad.cpu())
    _rel_close(grads[:1], grads[1:], cs.GRAD_REL)


def _neus_args(dev, n, s, anneal, with_rgb):
    t, mask, sdf, nablas, d, rgb = (_t(a, dev) for a in cs.neus_inputs(n, s, 4))
    return (t, mask, sdf, nablas, d, anneal, torch.tensor(300.0, device=dev),
            rgb if with_rgb else None)


@pytest.mark.parametrize("anneal", cs.K12_ANNEALS)
@pytest.mark.parametrize("shape", [(2048, 48, False), (4096, 96, True)],
                         ids=["lidar step", "synthetic_object with rgb"])
def test_k12_neus_composite(dev, anneal, shape):
    args = _neus_args(dev, *shape[:2], anneal, shape[2])
    n0 = kernels.KERNELS["neus_composite"].launches
    got = neus_composite(*args)
    assert kernels.KERNELS["neus_composite"].launches == n0 + 1
    want = neus_composite_plain(*args)
    assert int((want[6] == 1.0).sum()) > 0          # alpha == 1 ties in the buffer
    _close(got, want, **cs.K12_TOL)


@pytest.mark.parametrize("anneal", cs.K12_ANNEALS)
@pytest.mark.parametrize("shape", [(2048, 48, False), (4096, 96, True)],
                         ids=["lidar step", "synthetic_object with rgb"])
def test_k12_neus_composite_backward(dev, anneal, shape):
    n, s, with_rgb = shape
    args = _neus_args(dev, n, s, anneal, with_rgb)
    cots = [cs.cotangents(sh, 8 + i, dev)
            for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3), (n, s)))]
    if not with_rgb:
        cots[3] = None
    got = neus_composite_bwd(*args, *cots)
    _rel_close([g for g in got if g is not None],
               [w for w in neus_composite_bwd_plain(*args, *cots) if w is not None], cs.GRAD_REL)
    # cotangents that are None count as zero
    only_vw = [cots[0]] + [None] * 5
    got = neus_composite_bwd(*args, *only_vw)
    _rel_close([g for g in got if g is not None],
               [w for w in neus_composite_bwd_plain(*args, *only_vw) if w is not None],
               cs.GRAD_REL)


def test_k2_level_past_the_backward_shared_memory(dev):
    """A level of R 9,000 (3 R floats of one feature do not fit the
    backward's 96 KB of shared memory) beside a coarse one: the backward adds
    that level's shares to the table's gradient directly, and both levels
    still match the plain version."""
    enc = lotd.LoTDEncoding([(16, 4, "cp"), (9000, 2, "cp")], cp_stacked=False)
    enc.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        enc.table.add_(torch.randn(enc.total_params, generator=torch.Generator().manual_seed(4))
                       * 0.3)
    enc = enc.to(dev)
    x = _t(cs.enc_points(20_000, 9000, 5), dev)
    n = x.shape[0]
    args = (enc.table.detach(), x, enc._cp_meta)
    _close(cs.encode_into(lotd.lotd_cp_level, args, enc.out_dim, n, dev, True),
           cs.encode_into(lotd.lotd_cp_level_plain, args, enc.out_dim, n, dev, True), 1e-5, 1e-5)
    cots = (cs.cotangents((enc.out_dim, n), 6, dev), cs.cotangents((3, enc.out_dim, n), 7, dev))
    got = lotd.lotd_cp_level_bwd(*args, *cots)
    want = lotd.lotd_cp_level_bwd_plain(*args, *cots)
    cut = int(enc._cp_meta[1, 1])                   # each level to its own largest entry
    _rel_close([got[:cut], got[cut:]], [want[:cut], want[cut:]], cs.GRAD_REL)
    assert float(want[cut:].abs().max()) > 0


def test_per_level_iterations_launch_k2_and_k12(dev, monkeypatch):
    """WAYMO_DEMO_MULTI built under NEURALSIM_CP_STACKED=0: three loop
    iterations launch K2 and its backward, K12 and its backward once an
    iteration, and never K1 or K6; no skip."""
    monkeypatch.setenv("NEURALSIM_CP_STACKED", "0")
    scene, _, trainer, state, samplers = build_multi_trainer(WAYMO_DEMO_MULTI, device=dev)
    monkeypatch.delenv("NEURALSIM_CP_STACKED")
    kernels.reset_counts()
    log = []
    train_loop(scene, trainer, state, samplers, 3, torch.Generator(device=dev).manual_seed(0), 1,
               log)
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in kernels.KERNELS.values()}
    assert n["lotd_cp_level"] > 0 and n["lotd_cp_level.bwd"] > 0
    assert [n[k] for k in ("neus_composite", "neus_composite.bwd", "lotd_cp_stacked",
                           "lotd_cp_stacked.bwd", "volume_composite", "volume_composite.bwd")] \
        == [3, 3, 0, 0, 0, 0]
    assert log[-1]["skips_total"] == 0 and all(np.isfinite(r["loss_total"]) for r in log)


# ---------------------------------------------------------------------------
# The permutohedral lattice (K9) and the permuto vehicles
# ---------------------------------------------------------------------------

def _permuto_encoding(d):
    """12 levels of F 2 on 2^17 rows: PermutoNeuSObj's ladder (to 512) at
    d 3, the vehicles' (to 256) otherwise."""
    return pm.PermutoEncoding(d, n_levels=12, base_res=4.0, max_res=512.0 if d == 3 else 256.0,
                              log2_hashmap_size=17)


@pytest.mark.parametrize("d", pm.CARD_DIMS)
def test_k9_permuto_forward_and_backward(dev, d):
    """Features (with and without the jacobian), the table's gradient from
    each cotangent and the inputs' gradient, against the plain versions."""
    n0 = kernels.KERNELS["permuto.bwd"].launches
    cs.check_permuto(dev, [cs.permuto_set(f"d {d}", _permuto_encoding(d), 50_000, 200 + d, dev)])
    assert kernels.KERNELS["permuto.bwd"].launches == n0 + 3


def test_k9_refuses_other_widths(dev):
    enc = pm.PermutoEncoding(5, n_levels=2, log2_hashmap_size=10).to(dev)
    x = torch.rand(64, 5, device=dev)
    with pytest.raises(ValueError, match="d in"):
        pm.permuto(enc.table.detach(), x, enc._res, enc._meta, enc._lat, enc.table_size,
                   enc.out_dim, False)


def test_permuto_field_autograd_on_card_matches_cpu(dev):
    """The conditional permuto field (d 11) under autograd: sdf, nablas and
    feature cotangents into the table, the latents (through K9's inputs'
    gradient) and the decoder, on the card against the CPU path."""
    f = ConditionalPermutoNeuSField(n_instances=3, z_dim=8, geo_feat_dim=7,
                                    permuto_cfg={"n_levels": 4, "max_res": 64.0,
                                                 "log2_hashmap_size": 12})
    f.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        f.encoding.table.add_(torch.randn(f.encoding.total_params,
                                          generator=torch.Generator().manual_seed(2)) * 0.1)
        f.latents.mul_(30.0)
    x = _t(np.random.default_rng(3).random((8192, 3)).astype(np.float32) * 1.8 - 0.9, dev)
    b = _t(np.random.default_rng(4).integers(0, 3, 8192).astype(np.int64), dev)
    cots = [cs.cotangents(sh, 5 + i, dev) for i, sh in enumerate(((8192,), (8192, 3), (8192, 7)))]
    grads, outs = [], []
    for field, to in ((copy.deepcopy(f).to(dev), lambda a: a), (f, lambda a: a.cpu())):
        s, n, feat = field.sdf_nablas_feat(to(x), bidx=to(b))
        loss = sum((to(c) * o).sum() for c, o in zip(cots, (s, n, feat)))
        keys = ("encoding.table", "latents", "decoder.layers.0.W")
        named = dict(field.named_parameters())
        grads.append(dict(zip(keys, (g.cpu() for g in torch.autograd.grad(
            loss, [named[k] for k in keys])))))
        outs.append([o.detach().cpu() for o in (s, n, feat)])
    _close(outs[0], outs[1], 1e-4, 1e-5)
    for k in grads[1]:
        _rel_close([grads[0][k]], [grads[1][k]], cs.GRAD_REL)
    assert float(grads[1]["latents"].abs().max()) > 0


@pytest.fixture
def permuto_built(dev):
    return build_multi_trainer(WAYMO_DEMO_PERMUTO, device=dev)


def test_permuto_first_iteration_on_card_matches_cpu(dev, permuto_built):
    scene, _, trainer, state, samplers = permuto_built
    watch = {}
    with cs.permuto_watch(watch):
        loss_err, grad_err = cs.check_multi_first_iteration(scene, trainer, state, samplers, dev)
    assert loss_err <= cs.MULTI_STEP_LOSS_RTOL and grad_err <= cs.MULTI_STEP_GRAD_REL
    assert watch["plain_on_card"] == 0 and watch["calls"]


def test_permuto_iterations_launch_k9(dev, permuto_built):
    """Three loop iterations: K9 and its backward every iteration, K8 and K12
    as on the LoTD path, never K3 (the street has no dense level), no skip."""
    scene, _, trainer, state, samplers = permuto_built
    kernels.reset_counts()
    log = []
    train_loop(scene, trainer, state, samplers, 3, torch.Generator(device=dev).manual_seed(0), 1,
               log)
    torch.cuda.synchronize()
    n = {k.name: k.launches for k in kernels.KERNELS.values()}
    assert n["permuto"] >= 3 and n["permuto.bwd"] >= 3
    assert [n[k] for k in ("cross_source_vw", "cross_source_vw.bwd", "neus_composite",
                           "neus_composite.bwd", "lotd_grid", "lotd_grid.bwd")] == \
        [3, 3, 3, 3, 0, 0]
    assert log[-1]["skips_total"] == 0 and all(np.isfinite(r["loss_total"]) for r in log)


# ---------------------------------------------------------------------------
# K1's and K2's backwards at the multi-object shapes and the edge cases of
# chip_smoke.cp_bwd_point_sets: a step's sorted samples (runs of equal cells
# in a warp), 512 uniform points, every point in one cell, partial warps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cp_models():
    """The street's and the vehicles' encodings of WAYMO_DEMO_MULTI on the
    card, stacked (K1: F_cp 40 at R 1,024, 24 at R 256) and per-level (K2:
    10 and 6 levels of F 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfgs = WAYMO_DEMO_MULTI["assetbank_cfg"]
    out = {}
    for stacked in (True, False):
        with contextlib.ExitStack() as stack:
            if not stacked:
                stack.enter_context(cs.cp_per_level())
            street = lotd.make_lotd(cfgs["Street"]["model_params"]["encoding_cfg"])
            veh = ConditionalLoTDNeuSField(
                n_instances=3,
                encoding_cfg=cfgs["Vehicle"]["model_params"]["encoding_cfg"]).encoding
        for name, enc in (("street", street), ("vehicles", veh)):
            enc.reset_parameters(torch.Generator().manual_seed(0))
            with torch.no_grad():  # spread the lines off their init, so the features vary
                enc.table.add_(torch.randn(enc.total_params,
                                           generator=torch.Generator().manual_seed(1)) * 0.3)
            assert enc.cp_stacked == stacked
            out[name, stacked] = enc.to("cuda")
    return out


# (rays, samples) of a model's final query in a pixel step
_ROWS = {"street": (4096, 48), "vehicles": (6144, 32)}


def _cp_points(model, enc, case):
    """A case's points: the sorted samples of a step's final query (the
    street's LiDAR step: 2,048 beams), or one of cp_bwd_point_sets' edge
    cases at the pixel step's shape."""
    if case == "LiDAR step":
        return cs.ray_points(2048, 48, enc.cp_rmax, 5)
    n_rows, s = _ROWS[model]
    if case == "pixel step":
        return cs.ray_points(n_rows, s, enc.cp_rmax, 5)
    sets = dict(cs.cp_bwd_point_sets(n_rows, s, enc.cp_rmax,
                                     [sp.res for sp in enc.specs if sp.typ == "cp"], 6))
    return sets[case]


_CP_CASES = [("street", "pixel step"), ("street", "LiDAR step"), ("vehicles", "pixel step"),
             ("street", "512 uniform points"), ("vehicles", "512 uniform points"),
             ("street", "every point in one cell"), ("vehicles", "every point in one cell"),
             ("street", "N=1"), ("street", "N=33")]
_ONE_COTANGENT = [("street", "pixel step"), ("vehicles", "512 uniform points"),
                  ("street", "N=33")]


def _cp_bwd_case(cp_models, model, case, stacked, which):
    enc = cp_models[model, stacked]
    x = _t(_cp_points(model, enc, case), "cuda")
    n, C = x.shape[0], enc.out_dim
    d_out = None if which == "jac" else cs.cotangents((C, n), 2, "cuda")
    d_jac = None if which == "feats" else cs.cotangents((3, C, n), 3, "cuda")
    if stacked:
        lines = enc.cp_stacked_lines().detach().to(torch.bfloat16)
        args, kernel = (lines, x, enc._cp_rows, d_out, d_jac), "lotd_cp_stacked.bwd"
        bwd, plain = lotd.lotd_cp_stacked_bwd, lotd.lotd_cp_stacked_bwd_plain
    else:
        args, kernel = (enc.table.detach(), x, enc._cp_meta, d_out, d_jac), "lotd_cp_level.bwd"
        bwd, plain = lotd.lotd_cp_level_bwd, lotd.lotd_cp_level_bwd_plain
    n0 = kernels.KERNELS[kernel].launches
    got = bwd(*args)
    assert kernels.KERNELS[kernel].launches == n0 + 1
    _rel_close([got], [plain(*args)], cs.GRAD_REL)


@pytest.mark.parametrize("model,case", _CP_CASES)
def test_k1_backward_at_each_case(dev, cp_models, model, case):
    _cp_bwd_case(cp_models, model, case, True, "both")


@pytest.mark.parametrize("which", ["feats", "jac"])
@pytest.mark.parametrize("model,case", _ONE_COTANGENT)
def test_k1_backward_with_one_cotangent(dev, cp_models, model, case, which):
    _cp_bwd_case(cp_models, model, case, True, which)


@pytest.mark.parametrize("model,case", _CP_CASES)
def test_k2_backward_at_each_case(dev, cp_models, model, case):
    _cp_bwd_case(cp_models, model, case, False, "both")


@pytest.mark.parametrize("which", ["feats", "jac"])
@pytest.mark.parametrize("model,case", _ONE_COTANGENT)
def test_k2_backward_with_one_cotangent(dev, cp_models, model, case, which):
    _cp_bwd_case(cp_models, model, case, False, which)


@pytest.mark.parametrize("n", [512, 98_304])
def test_k1_backward_with_f_not_a_multiple_of_four(dev, n):
    """F 13 at R 1,024: a partial group of four features, so one add a value
    and no float4 add."""
    rng = np.random.default_rng(11)
    lines = _t(rng.normal(1.0, 0.3, (3, 13, 1024)).astype(np.float32), dev).to(torch.bfloat16)
    x = _t(cs.ray_points(n // 48, 48, 1024, 12) if n > 512 else cs.enc_points(n, 1024, 12), dev)
    args = (lines, x, torch.arange(13, dtype=torch.int32, device=dev),
            cs.cotangents((13, n), 13, dev), cs.cotangents((3, 13, n), 14, dev))
    _rel_close([lotd.lotd_cp_stacked_bwd(*args)], [lotd.lotd_cp_stacked_bwd_plain(*args)],
               cs.GRAD_REL)
