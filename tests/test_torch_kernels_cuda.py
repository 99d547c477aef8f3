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
chip_smoke.STEP_LOSS_RTOL and STEP_GRAD_REL (see there).
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from neuralsim_torch import kernels
from neuralsim_torch.configs import SYNTHETIC_OBJECT
from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
from neuralsim_torch.fields.encodings import lotd
from neuralsim_torch.fields.neus import upsample_weights_pdf, upsample_weights_pdf_plain
from neuralsim_torch.ops.segment import merge_sorted_samples, merge_sorted_samples_plain
from neuralsim_torch.renderers.buffers import (volume_composite, volume_composite_bwd,
                                               volume_composite_bwd_plain,
                                               volume_composite_plain)
from neuralsim_torch.tools.build import build_renderer, build_trainer

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
    assert all(k.launches > 0 for k in kernels.KERNELS.values() if not k.name.endswith(".bwd"))
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
    assert all(k.launches > 0 for k in kernels.KERNELS.values())
    assert loss_err <= cs.STEP_LOSS_RTOL and grad_err <= cs.STEP_GRAD_REL
