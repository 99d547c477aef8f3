"""Port parity for the whole slice: the single-scene NeuS training step.

A small model with the level types of configs/synthetic_object.yaml (2 dense,
2 stacked-CP and 2 hash levels; 16 coarse and (4, 4) fine samples; narrow
MLPs; 256 rays; 64 uniform points) and the config's losses is built in both
packages from the same parameters (``neuralsim_torch.bridge``). Both take the
same six steps on the same batches with the same noise: the test draws every
random number with ``jax.random``, following the key splits of the JAX
trainer, renderer and field, and hands them to the port as numpy. The JAX
side is its jitted ``Trainer.train_step`` (one compile); its step-1 gradients
are read back from the Adam first moments, ``mu = (1 - b1) * grad``.

Tolerances. Step 1: each loss term rtol 1e-4 (the eikonal term 1e-3: it
squares ``|nablas| - 1``, which is near zero at the sphere init, so the
cancellation magnifies float32 differences of the normals); each gradient leaf
5e-4 of the leaf's largest entry (2e-3 for the table: JAX rounds its
stacked-CP line gradient to bf16, see test_torch_lotd_grad.py; measured 1.3e-3
and at most 1.4e-4 elsewhere). After 5 steps: loss terms rtol 1e-3 (eikonal
3e-2, as above); of every parameter leaf, 99% of the entries within 5e-3 of
the leaf's largest entry and at most 0.5% of the entries more than one lr
apart (measured: 0.22% of the table, none elsewhere). Adam with
eps = 1e-15 steps by ``lr * g / |g|`` at first, so a table entry whose tiny
gradient has the other sign (or is exactly zero in one package) moves a full
2 * lr apart in one step, and the inverse-CDF draws amplify last-bit
differences of the field. Both Adam moments after step 5 against optax's
``ScaleByAdamState``: within 5e-4 of each leaf's largest entry (5e-3 for the
table, whose gradient JAX rounds; measured 2.6e-4 and 3.1e-3). The poisoned step is skipped in
both and changes no parameter and no moment, bit for bit.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralsim_tpu.models.assets import LoTDNeuSObj as JaxNeuSObj
from neuralsim_tpu.models.assets import SimpleSkyAsset as JaxSkyAsset
from neuralsim_tpu.renderers.single_volume import SingleVolumeRenderer as JaxRenderer
from neuralsim_tpu.training.trainer import Trainer as JaxTrainer
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves
from neuralsim_torch.configs import SYNTHETIC_OBJECT, resolve_refs
from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
from neuralsim_torch.tools.build import build_trainer
from neuralsim_torch.tools.train import to_device_batch, train
from test_torch_render import SMALL as SMALL_RENDER

torch.set_num_threads(1)

N_RAYS, N_UNIFORM, N_STEPS, NUM_ITERS = 256, 64, 5, 40
SMALL = copy.deepcopy(SMALL_RENDER)
SMALL["assetbank_cfg"]["Main"]["model_params"]["cos_anneal_stop_it"] = 20
SMALL["training"] = {**copy.deepcopy(SYNTHETIC_OBJECT["training"]), "num_iters": NUM_ITERS,
                     "n_rays": N_RAYS, "uniform_sample_n": N_UNIFORM, "i_log": 2}
SMALL["dataset_cfg"]["params"] = {"n_frames": 4, "H": 24, "W": 24, "radius": 2.0}
ROLES = {"cr": "Main", "sky": "Sky"}
B1 = 0.9


def _noise(key, query_cfg):
    """The draws of one JAX train step from its key, as numpy."""
    k_render, k_uniform, _ = jax.random.split(key, 3)
    kcr, _ = jax.random.split(k_render)
    jit_k, k = jax.random.split(kcr)
    noise = {"coarse": jax.random.uniform(jit_k, (N_RAYS, query_cfg["num_coarse"])), "fine": []}
    for nf in query_cfg["num_fine"]:
        sk, k = jax.random.split(k)
        noise["fine"].append(jax.random.uniform(sk, (N_RAYS, nf)))
    noise["uniform"] = jax.random.uniform(k_uniform, (N_UNIFORM, 3))
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), noise)


def _adam_state(opt_state, role):
    chain = opt_state.inner_states[role].inner_state
    return next(s for s in chain if isinstance(s, optax.ScaleByAdamState))


def _scalars(m):
    return {k: float(v) for k, v in m.items() if np.ndim(v) == 0}


@pytest.fixture(scope="module")
def runs():
    cfg = resolve_refs(SMALL)
    mp = cfg["assetbank_cfg"]
    cr = JaxNeuSObj(mp["Main"]["model_params"])
    cr.populate()
    sky = JaxSkyAsset(mp["Sky"]["model_params"])
    sky.populate()
    jr = JaxRenderer({"cr": cr.field, "sky": sky.field}, query_cfg=cr.query_cfg)
    jt = JaxTrainer(jr, loss_cfgs=cfg["training"]["losses"],
                    training_cfgs={r: mp[m]["asset_params"]["training_cfg"]
                                   for r, m in ROLES.items()},
                    uniform_sample_n=N_UNIFORM, default_optim_cfg={"lr": 1e-2})
    jp = jax.tree.map(np.asarray, jr.init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1)
    tbl = jp["cr"]["encoding"]["table"]
    jp["cr"]["encoding"]["table"] = (tbl + rng.normal(0, 0.05, tbl.shape)).astype(np.float32)

    trainer, state = build_trainer(SMALL, device="cpu")
    load_jax_params(state.params, {ROLES[r]: jp[r] for r in ROLES})

    dataset = SyntheticObjectDataset(**cfg["dataset_cfg"]["params"])
    brng = np.random.default_rng(0)
    batches = [dataset.sample_pixels(brng, N_RAYS) for _ in range(N_STEPS + 1)]
    batches[-1] = {k: v.copy() for k, v in batches[-1].items()}
    batches[-1]["image_rgb"][3, 1] = np.nan                  # the poisoned batch
    keys, key = [], jax.random.PRNGKey(1)
    for _ in batches:
        key, sk = jax.random.split(key)
        keys.append(sk)

    # --- JAX ------------------------------------------------------------------
    out = {"jax": [], "port": [], "trainer": trainer}
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, jp))
    for raw, sk in zip(batches, keys):
        jb = {k: jnp.asarray(v) for k, v in to_device_batch(raw, "cpu").items()}
        jstate, m = jt.train_step(jstate, jb, sk, "pixel")
        leaves = lambda tree: {k: np.array(v) for k, v in named_jax_leaves(tree, ROLES).items()}
        out["jax"].append({
            "metrics": _scalars(jax.device_get(m)), "params": leaves(jstate.params),
            "mu": leaves({r: _adam_state(jstate.opt_state, r).mu[r] for r in ROLES}),
            "nu": leaves({r: _adam_state(jstate.opt_state, r).nu[r] for r in ROLES}),
            "it": int(jstate.it)})

    # --- the port -------------------------------------------------------------
    plist = dict(state.params.named_parameters())
    for i, (raw, sk) in enumerate(zip(batches, keys)):
        batch = to_device_batch(raw, "cpu")
        noise = _noise(sk, jr.query_cfg)
        rec = {}
        if i == 0:      # the first step's gradients, by autograd, before the step
            total, _ = trainer.compute_losses(state.params, batch, state.it, noise)
            rec["grads"] = dict(zip(plist, torch.autograd.grad(total, list(plist.values()))))
        state, m = trainer.train_step(state, batch, noise)
        rec.update(metrics=_scalars(m), it=state.it,
                   params={k: v.detach().clone() for k, v in plist.items()},
                   moments=[t.clone() for o in state.opt.values()
                            for t in (*o.mu, *o.nu, o.count)],
                   **{mom: {f"{mid}.{n}": t.clone() for mid, o in state.opt.items()
                            for (n, _), t in zip(state.params[mid].named_parameters(),
                                                 getattr(o, mom))}
                      for mom in ("mu", "nu")})
        out["port"].append(rec)
    return out


LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_eikonal", "loss_sparsity")


@pytest.mark.parametrize("term", LOSSES + ("rendered_mask_mean", "inv_s"))
def test_first_step_loss_terms_match_jax(runs, term):
    got, want = runs["port"][0]["metrics"][term], runs["jax"][0]["metrics"][term]
    assert np.isfinite(got) and want != 0
    np.testing.assert_allclose(got, want, rtol=1e-3 if term == "loss_eikonal" else 1e-4)


def test_first_step_gradients_match_jax_leaf_by_leaf(runs):
    grads, mu = runs["port"][0]["grads"], runs["jax"][0]["mu"]
    assert set(grads) == set(mu) and len(grads) == 18
    for name, g in grads.items():
        want = mu[name] / (1.0 - B1)
        scale = np.abs(want).max()
        assert scale > 0, name
        tol = 2e-3 if name.endswith("table") else 5e-4
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol * scale, err_msg=name)


def test_five_steps_follow_jax(runs):
    for i in range(N_STEPS):
        got, want = runs["port"][i]["metrics"], runs["jax"][i]["metrics"]
        for term in LOSSES:
            np.testing.assert_allclose(got[term], want[term],
                                       rtol=3e-2 if term == "loss_eikonal" else 1e-3,
                                       err_msg=f"step {i} {term}")
        assert got["step_skipped"] == want["step_skipped"] == 0
    lr = 1e-2
    last, jlast = runs["port"][N_STEPS - 1], runs["jax"][N_STEPS - 1]
    for name, p in last["params"].items():
        want = jlast["params"][name]
        diff = np.abs(p.numpy() - want)
        assert np.quantile(diff, 0.99) <= 5e-3 * np.abs(want).max(), name
        assert np.mean(diff > lr) <= 5e-3, name
        assert not torch.equal(p, runs["port"][0]["params"][name]), name   # it did train
        tol = 5e-3 if name.endswith("table") else 5e-4
        for mom in ("mu", "nu"):
            want = jlast[mom][name]
            np.testing.assert_allclose(last[mom][name].numpy(), want, rtol=0,
                                       atol=tol * np.abs(want).max(), err_msg=f"{mom} {name}")


def test_poisoned_step_is_skipped_in_both(runs):
    jlast, jprev = runs["jax"][-1], runs["jax"][-2]
    last, prev = runs["port"][-1], runs["port"][-2]
    assert jlast["metrics"]["step_skipped"] == last["metrics"]["step_skipped"] == 1
    assert jlast["metrics"]["skips_total"] == last["metrics"]["skips_total"] == 1
    assert not np.isfinite(last["metrics"]["loss_total"])
    assert last["it"] == jlast["it"] == N_STEPS + 1            # `it` still advances
    for name, p in last["params"].items():
        assert torch.equal(p, prev["params"][name]), name
        np.testing.assert_array_equal(jlast["params"][name], jprev["params"][name])
    for a, b in zip(last["moments"], prev["moments"]):
        assert torch.equal(a, b)


def test_draw_noise_shapes_and_seed(runs):
    trainer = runs["trainer"]
    a = trainer.draw_noise(N_RAYS, torch.Generator().manual_seed(3))
    b = trainer.draw_noise(N_RAYS, torch.Generator().manual_seed(3))
    assert a["coarse"].shape == (N_RAYS, 16) and [f.shape[1] for f in a["fine"]] == [4, 4]
    assert a["uniform"].shape == (N_UNIFORM, 3) and "eikonal" not in a
    assert torch.equal(a["coarse"], b["coarse"]) and torch.equal(a["fine"][1], b["fine"][1])
    assert 0.0 <= float(a["uniform"].min()) and float(a["uniform"].max()) < 1.0


def test_train_loop_runs_on_the_cpu_and_the_loss_falls():
    out = train(SMALL, NUM_ITERS, device="cpu")
    log = out["log"]
    assert [r["it"] for r in log] == list(range(0, NUM_ITERS, 2))
    assert all(np.isfinite(r["loss_total"]) for r in log) and log[-1]["skips_total"] == 0
    assert np.mean([r["loss_rgb"] for r in log[-5:]]) < np.mean([r["loss_rgb"] for r in log[:5]])
    assert out["state"].it == NUM_ITERS
    # the schedule that refers to ${training.num_iters} follows the argument
    main = out["state"].opt["Main"]
    np.testing.assert_allclose(float(main.lr()), 0.01 * 0.1, rtol=1e-5)
    assert int(main.count) == NUM_ITERS


def test_full_width_trainer_builds_on_cpu():
    trainer, state = build_trainer(SYNTHETIC_OBJECT, device="cpu")
    assert trainer.uniform_sample_n == 512 and set(trainer.loss_cfgs) == \
        {"rgb", "occupancy_mask", "eikonal", "sparsity"}
    assert len(state.opt["Main"].params) == 12 and len(state.opt["Sky"].params) == 6
    np.testing.assert_allclose(float(state.opt["Main"].schedule(1500)), 1e-3, rtol=1e-5)
    np.testing.assert_allclose(float(state.opt["Sky"].schedule(10000)), 3e-4, rtol=1e-5)
    assert state.opt["Main"].eps == 1e-15 and state.opt["Sky"].b2 == 0.99
    assert resolve_refs(SYNTHETIC_OBJECT)["assetbank_cfg"]["Main"]["asset_params"][
        "training_cfg"]["total_steps"] == 1500
