"""Port parity: the loss functions, the annealers, the learning-rate schedules
and one Adam step, each against the JAX package (optax for Adam) on the same
numpy inputs on the CPU.

Tolerances: rtol 1e-5 / atol 1e-6 for values (elementwise float32 arithmetic
and one mean); 1e-6 relative for schedule values (the port evaluates
annealers in Python floats, JAX in float32); rtol 1e-5 for the Adam step and
the loss gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralsim_tpu.fields.blocks import MLP as JaxMLP
from neuralsim_tpu.losses import core as jcore
from neuralsim_tpu.losses import recon as jrecon
from neuralsim_tpu.maths.common import normalized_logistic_density as jax_nld
from neuralsim_tpu.training import annealers as jann
from neuralsim_tpu.training import optimizers as jopt
from neuralsim_tpu.training.trainer import psnr as jax_psnr
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.fields.blocks import MLP
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.losses import core, recon
from neuralsim_torch.maths.common import normalized_logistic_density
from neuralsim_torch.training import annealers, optimizers
from neuralsim_torch.training.trainer import psnr

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
T = torch.from_numpy


def _pair(seed=0, n=257):
    rng = np.random.default_rng(seed)
    pred = rng.random((n, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.2, (n, 3)), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("name,kw", [
    ("mse", {}), ("l2", {}), ("l1", {}), ("smooth_l1", {"beta": 0.3}), ("huber", {"delta": 0.1}),
    ("relative_l1", {}), ("relative_l2", {}), ("relative_l2_luminance", {}), ("mape", {}),
    ("smape", {}), ("l1_log", {})])
def test_recon_fn_matches_jax(name, kw):
    pred, gt = _pair()
    want = jrecon.get_recon_fn(name, **kw)(jnp.asarray(pred), jnp.asarray(gt))
    got = recon.get_recon_fn(name, **kw)(T(pred), T(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_safe_losses_and_reduce_match_jax():
    pred, gt = _pair(1)
    np.testing.assert_allclose(recon.safe_mse_loss(T(pred) * 3, T(gt), 0.5).numpy(),
                               np.asarray(jrecon.safe_mse_loss(pred * 3, gt, 0.5)), **TOL)
    p = np.concatenate([pred[:, 0], [0.0, 1.0]]).astype(np.float32)
    g = (np.concatenate([gt[:, 0], [1.0, 0.0]]) > 0.5).astype(np.float32)
    for red in (None, "mean"):
        np.testing.assert_allclose(
            recon.safe_binary_cross_entropy(T(p), T(g), reduction=red).numpy(),
            np.asarray(jrecon.safe_binary_cross_entropy(p, g, reduction=red)), **TOL)
    mask = (pred[:, :1] > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        for red in ("mean", "sum", "none"):
            want = jrecon.reduce(jnp.asarray(pred), None if m is None else jnp.asarray(m), red)
            got = recon.reduce(T(pred), None if m is None else T(m), red)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


W_CFGS = [{"w": 0.3}, {"w": 2.0, "anneal": {"type": "linear", "stop_it": 100}},
          {"w": {"type": "exponential", "stop_it": 50, "start_val": 1e-2, "stop_val": 2.0}},
          {"w": 1.5, "enable_after": 30},
          {"w": {"type": "milestones", "milestones": [10, 40], "vals": [0.1, 0.5, 1.0]}}]


@pytest.mark.parametrize("cfg", W_CFGS, ids=range(len(W_CFGS)))
@pytest.mark.parametrize("it", [0, 7, 30, 40, 400])
def test_loss_weight_matches_jax(cfg, it):
    np.testing.assert_allclose(core._w(cfg, it), float(jcore._w(cfg, it)), rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    {"type": "constant", "val": 0.7}, {"type": "linear", "start_it": 5, "stop_it": 25,
                                       "start_val": 1.0, "stop_val": -1.0},
    {"type": "exponential", "stop_it": 100}, {"type": "mix_linear", "start_it": 10, "stop_it": 20},
    {"type": "milestones", "milestones": [3, 9], "vals": [1.0, 2.0, 3.0]}],
    ids=["constant", "linear", "exponential", "mix_linear", "milestones"])
def test_annealers_match_jax(cfg):
    for it in (0, 3, 5, 9, 15, 20, 99, 1000):
        np.testing.assert_allclose(annealers.get_anneal_val(it, **cfg),
                                   float(jann.get_anneal_val(it, **cfg)), rtol=1e-6)
    assert annealers.make_annealer(cfg)(7) == annealers.get_anneal_val(7, **cfg)
    with pytest.raises(ValueError):
        annealers.get_anneal_val(0, type="nope")


def _rendered(seed=2, n=301):
    rng = np.random.default_rng(seed)
    r = {"rgb_volume": rng.random((n, 3)).astype(np.float32),
         "mask_volume": np.clip(rng.normal(0.5, 0.4, n), -0.1, 1.1).astype(np.float32)}
    gt = {"image_rgb": rng.random((n, 3)).astype(np.float32),
          "image_occupancy_mask": (rng.random(n) > 0.5).astype(np.float32),
          "image_ignore_mask": rng.random(n) > 0.8}
    return r, gt


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: T(v) for k, v in d.items()}


@pytest.mark.parametrize("cfg", [
    {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0}, {"w": 1.0},
    {"fn_type": "l1", "respect_ignore_mask": True,
     "w": {"type": "linear", "stop_it": 20, "start_val": 0.5, "stop_val": 2.0}}],
    ids=["huber", "mse", "l1_ignore"])
def test_photometric_loss_matches_jax(cfg):
    r, gt = _rendered()
    want, waux = jcore.photometric_loss(_j(r), _j(gt), 10, cfg)
    got, gaux = core.photometric_loss(_t(r), _t(gt), 10, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gaux["err_map"].numpy(), np.asarray(waux["err_map"]), **TOL)


@pytest.mark.parametrize("mode", ["bce", "only_cull_non_occupied", "only_preserve_occupied"])
def test_mask_occupancy_loss_matches_jax(mode):
    r, gt = _rendered(3)
    cfg = {"w": 0.3, "mode": mode}
    np.testing.assert_allclose(core.mask_occupancy_loss(_t(r), _t(gt), 0, cfg).numpy(),
                               np.asarray(jcore.mask_occupancy_loss(_j(r), _j(gt), 0, cfg)),
                               **TOL)


def test_mask_entropy_loss_matches_jax():
    r, _ = _rendered(4)
    r["rendered_cr"] = {"mask_volume": r["mask_volume"][::-1].copy() * 0.5}
    for cfg in ({"w": 0.1}, {"w": 0.2, "mode": "crisp_cr"}):
        jr = {**_j({k: v for k, v in r.items() if k != "rendered_cr"}),
              "rendered_cr": _j(r["rendered_cr"])}
        tr = {**_t({k: v for k, v in r.items() if k != "rendered_cr"}),
              "rendered_cr": _t(r["rendered_cr"])}
        np.testing.assert_allclose(core.mask_entropy_loss(tr, 0, cfg).numpy(),
                                   np.asarray(jcore.mask_entropy_loss(jr, 0, cfg)), **TOL)


@pytest.mark.parametrize("cfg", [{"w": 0.01, "on_render_ratio": 0.3},
                                 {"w": 0.1, "safe_mse_limit": 0.5, "alpha_reg_zero": 0.01}],
                         ids=["config", "clipped_reg"])
@pytest.mark.parametrize("masked", [False, True])
def test_eikonal_loss_and_gradient_match_jax(cfg, masked):
    rng = np.random.default_rng(5)
    nablas = (rng.normal(size=(64, 24, 3)) * rng.random((64, 24, 1)) * 3).astype(np.float32)
    nablas[0, 0] = 0.0                                       # a zero vector: finite gradient
    mask = (rng.random((64, 24)) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, wgrad = jax.value_and_grad(
        lambda nb: jcore.eikonal_loss(nb, 0, cfg, mask=jm))(jnp.asarray(nablas))
    nb = T(nablas).requires_grad_(True)
    got = core.eikonal_loss(nb, 0, cfg, mask=None if mask is None else T(mask))
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(nb.grad).all()
    np.testing.assert_allclose(nb.grad.numpy(), np.asarray(wgrad), rtol=1e-5, atol=1e-8)


def test_eikonal_noise_is_the_callers():
    rng = np.random.default_rng(6)
    nablas = rng.normal(size=(128, 3)).astype(np.float32)
    noise = rng.normal(size=128).astype(np.float32)
    cfg = {"w": 1.0, "noise_std": 0.05}
    norms = np.sqrt((nablas ** 2).sum(-1) + 1e-24) + noise * 0.05
    want = np.mean(np.clip(norms - 1.0, -5, 5) ** 2)
    np.testing.assert_allclose(core.eikonal_loss(T(nablas), 0, cfg, noise=T(noise)).numpy(),
                               want, rtol=1e-5)
    assert core.eikonal_loss(T(nablas), 0, {"w": 1.0}, noise=T(noise)) == \
        core.eikonal_loss(T(nablas), 0, {"w": 1.0})


@pytest.mark.parametrize("cfg", [{"w": 0.002}, {"w": 1.0, "inv_scale": 4.0},
                                 {"w": 0.5, "type": "exp_normal", "sigma": 0.2}],
                         ids=["config", "inv_scale", "exp_normal"])
def test_sparsity_loss_matches_jax(cfg):
    sdf = np.random.default_rng(7).normal(0, 0.3, 512).astype(np.float32)
    np.testing.assert_allclose(core.sparsity_loss(T(sdf), 0, cfg).numpy(),
                               np.asarray(jcore.sparsity_loss(jnp.asarray(sdf), 0, cfg)), **TOL)
    np.testing.assert_allclose(normalized_logistic_density(T(sdf), 16.0).numpy(),
                               np.asarray(jax_nld(jnp.asarray(sdf), 16.0)), **TOL)
    with pytest.raises(ValueError):
        core.sparsity_loss(T(sdf), 0, {"type": "nope"})


def test_psnr_matches_jax():
    pred, gt = _pair(8)
    np.testing.assert_allclose(psnr(T(pred), T(gt)).numpy(),
                               np.asarray(jax_psnr(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-5)


SCHEDS = [{"lr": 0.01, "type": "exponential", "total_steps": 1500, "decay_target_factor": 0.1},
          {"lr": 0.003}, {"lr": 0.02, "type": "constant", "warmup_steps": 10},
          {"lr": 0.01, "type": "cosine", "total_steps": 200, "decay_target_factor": 0.05},
          {"lr": 0.01, "type": "exponential", "total_steps": 100, "warmup_steps": 20},
          {"type": "linear", "start_it": 5, "stop_it": 1500, "start_val": 0.01,
           "stop_val": 0.001, "warmup_steps": 4},
          {"type": "milestones", "milestones": [5, 100, 1500], "vals": [0.01, 0.003, 0.001, 0.0003]},
          {"type": "milestones", "milestones": [19, 50], "vals": [0.01, 0.003]}]


@pytest.mark.parametrize("cfg", SCHEDS, ids=["main", "sky", "constant_warmup", "cosine",
                                              "exp_warmup", "linear", "milestones",
                                              "milestones_short_vals"])
def test_lr_schedule_matches_jax(cfg):
    js, ps = jopt.make_lr_schedule(cfg), optimizers.make_lr_schedule(cfg)
    for it in (0, 1, 5, 19, 50, 100, 1499, 1500, 20000):
        np.testing.assert_allclose(float(ps(it)), float(js(it)), rtol=1e-6)
        np.testing.assert_allclose(float(ps(torch.tensor(it, dtype=torch.int32))), float(js(it)),
                                   rtol=1e-6)


def test_unknown_schedule_type_is_refused():
    with pytest.raises(ValueError):
        optimizers.make_lr_schedule({"type": "nope"})


def _adam_pair(cfgs, seed=9):
    rng = np.random.default_rng(seed)
    tree = {"A": {"W": rng.normal(size=(5, 4)).astype(np.float32),
                  "b": rng.normal(size=4).astype(np.float32)},
            "B": {"W": rng.normal(size=(3, 2)).astype(np.float32),
                  "b": np.zeros(2, np.float32)}}
    mods = torch.nn.ModuleDict({k: torch.nn.ParameterDict(
        {n: torch.nn.Parameter(T(v.copy())) for n, v in sub.items()}) for k, sub in tree.items()})
    default = {"lr": 1e-2}
    jo = jopt.make_optimizer(cfgs, tree, default)
    po = optimizers.make_optimizer(cfgs, mods, default)
    return rng, tree, mods, jo, po


@pytest.mark.parametrize("cfgs", [
    {"A": {"lr": 0.01, "eps": 1e-15, "betas": (0.9, 0.99), "type": "exponential",
           "total_steps": 20, "decay_target_factor": 0.1}, "B": {"lr": 0.003}},
    {"A": {"lr": 0.01, "clip_grad_norm": 0.5}, "B": {"lr": 0.01, "clip_grad_val": 0.1}}],
    ids=["config", "clips"])
def test_adam_steps_match_optax(cfgs):
    rng, tree, mods, jo, po = _adam_pair(cfgs)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jo.init(jp)
    for step in range(4):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -step,
                             tree)
        upd, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for mid, opt in po.items():
            names = [n for n, _ in mods[mid].named_parameters()]
            opt.step([T(grads[mid][n]) for n in names])
        for mid in tree:
            for n, p in mods[mid].named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[mid][n]),
                                           rtol=1e-5, atol=1e-7, err_msg=f"{step} {mid}.{n}")
    assert int(po["A"].count) == 4


def test_adam_step_skipped_by_the_flag_changes_nothing():
    rng, tree, mods, _, po = _adam_pair({"A": {"lr": 0.01}})
    g = lambda mid: [T(rng.normal(size=tuple(p.shape)).astype(np.float32))
                     for p in mods[mid].parameters()]
    po["A"].step(g("A"))
    before = [t.clone() for t in (*po["A"].params, *po["A"].mu, *po["A"].nu, po["A"].count)]
    bad = g("A")
    bad[0][0, 0] = float("nan")
    po["A"].step(bad, torch.tensor(False))
    after = [*po["A"].params, *po["A"].mu, *po["A"].nu, po["A"].count]
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    po["A"].step(g("A"), torch.tensor(True))
    assert int(po["A"].count) == 2 and not torch.equal(po["A"].params[0], before[0])


def test_decoder_input_gradient_is_differentiable_in_the_weights():
    """The eikonal loss differentiates the decoder's input gradient: the
    port's explicit backward against jax.vjp, value and weight gradients."""
    jm = JaxMLP(6, 4, hidden=8, depth=2)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    jp = jax.tree.map(lambda a: (a + rng.normal(0, 0.3, a.shape)).astype(np.float32), jp)
    x = rng.normal(size=(33, 6)).astype(np.float32)
    cot = np.zeros((33, 4), np.float32)
    cot[:, 0] = 1.0

    def jloss(p):
        out, vjp = jax.vjp(lambda xx: jm(p, xx), jnp.asarray(x))
        g = vjp(jnp.asarray(cot))[0]
        return jnp.sum((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2) + jnp.sum(out ** 2)

    want, wgrad = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jp))
    pm = MLP(6, 4, hidden=8, depth=2)
    load_jax_params(pm, jp)
    out, g = pm.forward_and_input_grad(T(x), T(cot))
    got = torch.sum((torch.linalg.norm(g, dim=-1) - 1.0) ** 2) + torch.sum(out ** 2)
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    for i, layer in enumerate(pm.layers):
        for n in ("W", "b"):
            np.testing.assert_allclose(getattr(layer, n).grad.numpy(),
                                       np.asarray(wgrad["layers"][i][n]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"layers.{i}.{n}")


def test_uniform_points_fill_the_box():
    space = AABBSpace([-1.0, -2.0, 0.0], [1.0, 2.0, 4.0])
    u = T(np.random.default_rng(11).random((64, 3)).astype(np.float32))
    x = space.uniform_points(u)
    torch.testing.assert_close(space.normalize_coords(x), u, rtol=1e-6, atol=1e-6)
    assert (x >= space.aabb_min).all() and (x <= space.aabb_max).all()
