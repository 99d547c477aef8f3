"""Port parity for the whole slice: the model that the JAX package's bench.py
builds (NeuS on stacked-CP levels, EMA occupancy grid, NeRF++ distant MLP,
sky), rendered and trained, against ``neuralsim_tpu`` on the CPU.

Small size: 4 CP levels of 2 features (16 .. 64), grid 16^3 with 8 march
segments refreshed every 2nd step, 8 coarse + (4, 4) fine + 8 distant
samples, narrow MLPs, 64 rays, 32 uniform points. Both packages get the same
parameters and the same converged grid (``neuralsim_torch.bridge``), the same
batches and the same noise: the test draws every random number with
``jax.random``, replaying the JAX key tree. ``Trainer.compute_losses`` splits
the step's key into (render, uniform, eikonal); ``SingleVolumeRenderer``
splits the render key into (cr, distant); with the grid's proposal the NeuS
query hands the whole cr key to the proposal's draw and then splits the stage
keys off the same key (no jitter key comes first); the distant ladder draws
from its key; the refresh draws from ``fold_in(step key, 7)``.

The JAX steps run under ``jax.disable_jit()``, as its eager ``ray_query``
does in the render tests: XLA's fused step rounds the proposal's cdf in other
places than the eager operations, nearly every cdf bin of the occupancy
proposal is near-empty (weight 1e-6 against 1), and the inverse CDF turns
that last-bit difference into another sample placement. Measured here, the
jitted JAX step's gradients lie up to 3.4% of the largest table entry away
from both the eager JAX step and the port, which agree with each other as
below (0.2%); ``test_jitted_jax_step_lies_apart_from_the_eager_step_and_the_port``
keeps that measurement and holds the port to the jitted step at 5%.

Tolerances. The render: 95% of each output's entries within 1e-4 and all
within 5e-3 (rtol and atol; each kernel's plain version agrees to ~1e-6, but
on one or two of the 64 rays an upsampled depth moves by ~1e-4 inside a
near-empty cdf bin, and with 16 samples a ray the composite follows it; the
mean depth of such a ray weighs distant depths of up to 1e4, measured 2.1e-3).
Step 1: loss terms rtol 1e-4 (eikonal 1e-3: it squares ``|nablas| - 1`` near
zero; the mean mask 5e-4); each gradient leaf 5e-4 of its largest entry
(3e-3 for the table, whose line gradient JAX rounds to bf16, see
test_torch_lotd_grad.py; measured 2.2e-3). Later steps: loss terms rtol 2e-3
(eikonal 3e-2);
Adam with eps = 1e-15 steps by ``lr * sign(g)`` at first, so the parameters
drift apart where a tiny gradient has the other sign. The grid after a
refresh from those parameters: values within 2e-2 and at most 1% of the
voxels with another mask bit (``val`` is a steep logistic of the sdf); the
refresh that follows the first step alone is also checked from carried-over
parameters at atol 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel import OccGridEma as JaxGrid
from neuralsim_tpu.fields import AABBSpace as JaxSpace
from neuralsim_tpu.fields import NeRFDistantField as JaxDistant
from neuralsim_tpu.fields import NeuSField as JaxNeuS
from neuralsim_tpu.fields import SimpleSky as JaxSky
from neuralsim_tpu.renderers import SingleVolumeRenderer as JaxRenderer
from neuralsim_tpu.training import Trainer as JaxTrainer
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves, occ_state_from_numpy
from neuralsim_torch.configs import BENCH_OBJECT, SYNTHETIC_OBJECT
from neuralsim_torch.dataio.synthetic import (SyntheticObjectDataset, _sdf_scene,
                                              sdf_scene_tensor)
from neuralsim_torch.tools.build import build_renderer, build_trainer, converge_occ
from neuralsim_torch.tools.train import to_device_batch, train
from test_torch_render import _rays      # a frame of the rig and 16 rays that mostly miss
from test_torch_train import _adam_state, _scalars

torch.set_num_threads(1)

N_RAYS, N_UNIFORM, R = 64, 32, 16
SMALL = copy.deepcopy(BENCH_OBJECT)
SMALL["models"]["cr"]["params"].update(
    encoding_cfg={**BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"], "n_levels": 4,
                  "n_feats": 2, "max_res": 64},
    geo_feat_dim=7, decoder_hidden=16, radiance_hidden=16, cos_anneal_stop_it=20)
SMALL["models"]["distant"]["params"].update(geo_feat_dim=4, radiance_hidden=8)
SMALL["models"]["sky"]["params"] = {"hidden": 8}
SMALL["renderer"]["query_cfg"].update(num_coarse=8, num_fine=[4, 4])
SMALL["renderer"]["distant_query_cfg"] = {"num_samples": 8}
SMALL["accel_cfg"]["cr"].update(resolution=R, march_steps=8, ema_decay=0.5,
                                n_steps_between_update=2)
SMALL["occ_converge"] = {"n": 3, "it": 1000}
SMALL["training"].update(n_rays=N_RAYS, uniform_sample_n=N_UNIFORM, i_log=1)
SMALL["dataset_cfg"]["params"] = {"n_frames": 4, "H": 24, "W": 24}
ROLES = {"cr": "cr", "distant": "distant", "sky": "sky"}
B1 = 0.9
LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_eikonal", "loss_sparsity")
RENDER_KEYS = ("mask_volume", "depth_volume", "rgb_volume", "normals_volume", "rgb_sky",
               "samples_cnt", "rgb_volume_occupied", "rgb_volume_non_occupied")
POISONED = 2                      # the third step (it = 2) falls on the grid's cadence
# the port against the jitted JAX step (see the test that uses them)
JIT_GRAD_REL = 5e-2
JIT_LOSS_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_side():
    """The model as bench.py builds it, from SMALL's values."""
    m, r = SMALL["models"], SMALL["renderer"]
    cr = m["cr"]["params"]
    space = JaxSpace(*m["cr"]["aabb"])
    field = JaxNeuS(space, geometry="lotd", encoding_cfg=cr["encoding_cfg"],
                    geo_feat_dim=cr["geo_feat_dim"], decoder_hidden=cr["decoder_hidden"],
                    radiance_hidden=cr["radiance_hidden"], ln_inv_s_init=cr["ln_inv_s_init"],
                    cos_anneal_stop_it=cr["cos_anneal_stop_it"], remat=False,
                    eval_chunk=cr["eval_chunk"])
    q = r["query_cfg"]
    jr = JaxRenderer({"cr": field, "distant": JaxDistant(**m["distant"]["params"]),
                      "sky": JaxSky(**m["sky"]["params"])},
                     query_cfg={**q, "num_fine": tuple(q["num_fine"]),
                                "upsample_inv_s_factors": tuple(q["upsample_inv_s_factors"])},
                     distant_query_cfg=r["distant_query_cfg"])
    jg = JaxGrid(space, **SMALL["accel_cfg"]["cr"])
    jr.accels = {"cr": jg}
    t = SMALL["training"]
    jt = JaxTrainer(jr, loss_cfgs=t["losses"], training_cfgs=t["optim"],
                    uniform_sample_n=N_UNIFORM)
    return jr, jg, jt


def _noise(key, it):
    """The draws of one JAX train step at iteration ``it`` from its key."""
    q = SMALL["renderer"]["query_cfg"]
    k_render, k_uniform, _ = jax.random.split(key, 3)
    kcr, kdv = jax.random.split(k_render)
    noise = {"occ_proposal": jax.random.uniform(kcr, (N_RAYS, q["num_coarse"])), "fine": []}
    k = kcr                                     # the stage keys come off the whole cr key
    for nf in q["num_fine"]:
        sk, k = jax.random.split(k)
        noise["fine"].append(jax.random.uniform(sk, (N_RAYS, nf)))
    noise["distant"] = jax.random.uniform(kdv, (N_RAYS, 8))
    noise["uniform"] = jax.random.uniform(k_uniform, (N_UNIFORM, 3))
    if it % 2 == 0:
        noise["occ_update"] = {"cr": jax.random.uniform(jax.random.fold_in(key, 7),
                                                        (1, R, R, R, 3))}
    return jax.tree.map(_t, noise)


@pytest.fixture(scope="module")
def pair():
    jr, jg, jt = _jax_side()
    jp = jax.tree.map(np.asarray, jr.init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1)
    tbl = jp["cr"]["encoding"]["table"]
    jp["cr"]["encoding"]["table"] = (tbl + rng.normal(0, 0.05, tbl.shape)).astype(np.float32)
    for layer in jp["distant"]["decoder"]["layers"]:        # a background that shows
        layer["b"] = rng.normal(0.0, 0.3, layer["b"].shape).astype(np.float32)
    js = jg.init_state()
    for i in range(3):
        js = jg.update(js, lambda x: jnp.asarray(_sdf_scene(np.asarray(x)).astype(np.float32)),
                       jax.random.PRNGKey(i), 1000)
    trainer, state = build_trainer(SMALL, device="cpu")
    load_jax_params(state.params, jp)
    state.occ["cr"] = occ_state_from_numpy(np.asarray(js.val), np.asarray(js.mask))
    return dict(jr=jr, jg=jg, jt=jt, jp=jp, js=js, trainer=trainer, state=state)


@pytest.fixture(scope="module")
def renders(pair):
    o, d = _rays()
    want = pair["jr"].ray_query(jax.tree.map(jnp.asarray, pair["jp"]), jnp.asarray(o),
                                jnp.asarray(d), key=None, occ_states={"cr": pair["js"]},
                                return_buffer=True)
    with torch.no_grad():
        got = pair["trainer"].renderer.ray_query(pair["state"].params, _t(o), _t(d),
                                                 occ_states=pair["state"].occ,
                                                 return_buffer=True)
    return got, want


def _assert_render_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) / (1.0 + np.abs(want))      # rtol = atol
    assert np.quantile(excess, 0.95) <= 1e-4, name
    assert excess.max() <= 5e-3, name


@pytest.mark.parametrize("key", RENDER_KEYS)
def test_render_with_grid_distant_and_sky_matches_jax(renders, key):
    got, want = renders
    _assert_render_close(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("src", ["rendered_cr", "rendered_dv"])
def test_per_source_shares_match_jax(renders, src):
    got, want = renders
    assert set(got[src]) == set(want[src]) == {"mask_volume", "depth_volume", "rgb_volume"}
    for k, v in want[src].items():
        _assert_render_close(got[src][k].numpy(), v, k)
    assert float(got[src]["mask_volume"].max()) > 0.05      # both sources show


def test_merged_buffer_is_cr_then_distant(renders):
    got, want = renders
    buf = got["merged_buffer"]
    assert buf["t"].shape == (64, 16 + 8) and set(buf) >= {"t", "mask", "alpha", "rgb",
                                                           "nablas", "src"}
    np.testing.assert_array_equal(buf["src"].numpy(), np.asarray(want["merged_buffer"]["src"]))
    np.testing.assert_array_equal(buf["mask"].numpy(), np.asarray(want["merged_buffer"]["mask"]))
    np.testing.assert_allclose(buf["t"].numpy(), np.asarray(want["merged_buffer"]["t"]),
                               rtol=1e-4, atol=1e-4)
    # the distant lanes carry zero nablas under a true mask, as in the JAX package
    assert buf["mask"][:, 16:].all() and not buf["nablas"][:, 16:].any()
    hit = got["details_cr"]["hit"]
    assert (buf["t"][hit][:, 16] >= buf["t"][hit][:, 15] - 1e-6).all()


def test_render_chunked_drops_the_per_source_entries(pair):
    o, d = _rays()
    renderer, state = pair["trainer"].renderer, pair["state"]
    out = renderer.render_chunked(state.params, _t(o), _t(d), rayschunk=32,
                                  occ_states=state.occ)
    assert not {"per_src", "rendered_cr", "rendered_dv", "merged_buffer", "vw",
                "details_cr"} & set(out)
    with torch.no_grad():
        whole = renderer.ray_query(state.params, _t(o), _t(d), occ_states=state.occ)
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        np.testing.assert_allclose(out[k].numpy(), whole[k].numpy(), atol=1e-6)
    only_cr = renderer.ray_query(state.params, _t(o), _t(d), occ_states=state.occ,
                                 only_cr=True, return_buffer=True)
    assert only_cr["merged_buffer"]["t"].shape[1] == 16 and "rendered_dv" not in only_cr


@pytest.fixture(scope="module")
def runs(pair):
    """Four steps in both packages; the third batch is poisoned."""
    jt, trainer = pair["jt"], pair["trainer"]
    state = copy.deepcopy(pair["state"])
    state.opt = trainer.init_state(state.params).opt         # moments of the copied parameters
    dataset = SyntheticObjectDataset(**SMALL["dataset_cfg"]["params"])
    brng = np.random.default_rng(0)
    batches = [dataset.sample_pixels(brng, N_RAYS) for _ in range(4)]
    batches[POISONED] = {k: v.copy() for k, v in batches[POISONED].items()}
    batches[POISONED]["image_rgb"][3, 1] = np.nan
    keys, key = [], jax.random.PRNGKey(1)
    for _ in batches:
        key, sk = jax.random.split(key)
        keys.append(sk)
    leaves = lambda tree: {k: np.array(v) for k, v in named_jax_leaves(tree, ROLES).items()}

    out = {"jax": [], "port": []}
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, pair["jp"]))
    jstate = jstate._replace(occ={"cr": pair["js"]})
    for raw, sk in zip(batches, keys):
        jb = {k: jnp.asarray(v) for k, v in to_device_batch(raw, "cpu").items()}
        with jax.disable_jit():
            jstate, m = jt.train_step(jstate, jb, sk, "pixel")
        out["jax"].append({
            "metrics": _scalars(jax.device_get(m)), "params": leaves(jstate.params),
            "mu": leaves({r: _adam_state(jstate.opt_state, r).mu[r] for r in ROLES}),
            "val": np.array(jstate.occ["cr"].val), "mask": np.array(jstate.occ["cr"].mask)})

    plist = dict(state.params.named_parameters())
    for i, (raw, sk) in enumerate(zip(batches, keys)):
        batch = to_device_batch(raw, "cpu")
        noise = _noise(sk, state.it)
        rec = {}
        if i == 0:      # the first step's gradients, by autograd, before the step
            total, _ = trainer.compute_losses(state.params, batch, state.it, noise, state.occ)
            rec["grads"] = dict(zip(plist, torch.autograd.grad(total, list(plist.values()))))
        state, m = trainer.train_step(state, batch, noise)
        rec.update(metrics=_scalars(m), it=state.it, occ=state.occ["cr"],
                   params={k: v.detach().clone() for k, v in plist.items()})
        out["port"].append(rec)
    return out


@pytest.fixture(scope="module")
def jitted_first_step(pair):
    """The first step of ``runs`` again, through the jitted JAX step that a
    user of the JAX package runs."""
    jt = pair["jt"]
    raw = SyntheticObjectDataset(**SMALL["dataset_cfg"]["params"]).sample_pixels(
        np.random.default_rng(0), N_RAYS)
    sk = jax.random.split(jax.random.PRNGKey(1))[1]
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, pair["jp"]))
    jstate = jstate._replace(occ={"cr": pair["js"]})
    jb = {k: jnp.asarray(v) for k, v in to_device_batch(raw, "cpu").items()}
    jstate, m = jt.train_step(jstate, jb, sk, "pixel")
    mu = named_jax_leaves({r: _adam_state(jstate.opt_state, r).mu[r] for r in ROLES}, ROLES)
    return {"metrics": _scalars(jax.device_get(m)),
            "grads": {k: np.array(v) / (1.0 - B1) for k, v in mu.items()}}


def _grad_gaps(got, want):
    """Per leaf, the largest difference relative to ``want``'s largest entry."""
    return {k: float(np.abs(np.asarray(got[k]) - w).max() / np.abs(w).max())
            for k, w in want.items()}


def test_jitted_jax_step_lies_apart_from_the_eager_step_and_the_port(runs, jitted_first_step):
    """Why the parity tests above run JAX eagerly, as a measurement: the
    jitted step's gradients differ from the eager step's by more than the
    eager step's differ from the port's (XLA fuses the proposal's cdf, the
    inverse CDF turns the last-bit difference into another sample placement),
    while the jitted step's losses still agree. The port is held to the
    jitted step at the limit that this gap allows: every gradient leaf within
    JIT_GRAD_REL of its largest entry, every loss term within JIT_LOSS_RTOL."""
    eager = {k: v / (1.0 - B1) for k, v in runs["jax"][0]["mu"].items()}
    port = {k: g.numpy() for k, g in runs["port"][0]["grads"].items()}
    jit = jitted_first_step["grads"]
    jit_eager, jit_port, eager_port = (_grad_gaps(jit, eager), _grad_gaps(port, jit),
                                       _grad_gaps(port, eager))
    assert set(jit) == set(eager) == set(port)
    # measured: 3.4e-2 (table), 1.8e-2 (first radiance layer); port vs eager 2.0e-3
    assert max(jit_eager.values()) > 3e-3, "the jitted step now follows the eager one: " \
        "the parity tests can run it"
    assert max(jit_eager.values()) <= JIT_GRAD_REL
    assert max(eager_port.values()) < 0.2 * max(jit_eager.values())
    for name, gap in jit_port.items():
        assert gap <= JIT_GRAD_REL, name
    for term in LOSSES:     # measured: 2.5e-4 (eikonal), 1.0e-4 (mask)
        np.testing.assert_allclose(runs["port"][0]["metrics"][term],
                                   jitted_first_step["metrics"][term], rtol=JIT_LOSS_RTOL,
                                   err_msg=term)


def test_sdf_scene_tensor_matches_the_numpy_scene():
    """The tensor form that ``converge_occ`` evaluates on the grid's device
    against the numpy scene, within float32 rounding (1e-6)."""
    x = np.random.default_rng(5).uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)
    got = sdf_scene_tensor(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4096,)
    np.testing.assert_allclose(got.numpy(), _sdf_scene(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("term", LOSSES + ("rendered_mask_mean", "inv_s", "occ_frac"))
def test_first_step_loss_terms_match_jax(runs, term):
    got, want = runs["port"][0]["metrics"][term], runs["jax"][0]["metrics"][term]
    assert np.isfinite(got) and want != 0
    rtol = {"loss_eikonal": 1e-3, "rendered_mask_mean": 5e-4}.get(term, 1e-4)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_first_step_gradients_match_jax_leaf_by_leaf(runs):
    grads, mu = runs["port"][0]["grads"], runs["jax"][0]["mu"]
    assert set(grads) == set(mu) and len(grads) == 12 + 10 + 6    # cr, distant, sky
    for name, g in grads.items():
        want = mu[name] / (1.0 - B1)
        scale = np.abs(want).max()
        assert scale > 0, name
        tol = 3e-3 if name.endswith("table") else 5e-4
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol * scale, err_msg=name)


def test_first_refresh_matches_jax(pair, runs):
    """The refresh after step 1, from the JAX package's own step-1 parameters
    carried over, with the same jitter: the grid alone, without the drift of
    the two optimizers."""
    trainer = pair["trainer"]
    state = copy.deepcopy(pair["state"])
    load_jax_params(state.params, runs["jax"][0]["params"])     # leaves by dotted name
    key = jax.random.split(jax.random.PRNGKey(1))[1]
    trainer.refresh_occ(state, _noise(key, 0)["occ_update"])
    np.testing.assert_allclose(state.occ["cr"].val.numpy(), runs["jax"][0]["val"], rtol=0,
                               atol=1e-5)
    differ = state.occ["cr"].mask.numpy() != runs["jax"][0]["mask"]
    assert not np.any(differ & (np.abs(runs["jax"][0]["val"] - 0.3) > 1e-5))
    assert not torch.equal(state.occ["cr"].val, pair["state"].occ["cr"].val)


def test_steps_across_a_refresh_follow_jax(runs):
    for i in range(4):
        got, want = runs["port"][i]["metrics"], runs["jax"][i]["metrics"]
        assert got["step_skipped"] == want["step_skipped"] == int(i == POISONED)
        np.testing.assert_allclose(got["occ_frac"], want["occ_frac"], atol=0.01)
        if i == POISONED:
            continue
        for term in LOSSES:
            np.testing.assert_allclose(got[term], want[term],
                                       rtol=3e-2 if term == "loss_eikonal" else 2e-3,
                                       err_msg=f"step {i} {term}")
    for i in range(4):
        occ, val = runs["port"][i]["occ"], runs["jax"][i]["val"]
        np.testing.assert_allclose(occ.val.numpy(), val, rtol=0, atol=2e-2, err_msg=f"step {i}")
        assert np.mean(occ.mask.numpy() != runs["jax"][i]["mask"]) <= 0.01


def test_grid_refreshes_on_its_cadence_only(runs):
    vals = [r["occ"].val for r in runs["port"]]
    jvals = [r["val"] for r in runs["jax"]]
    assert torch.equal(vals[0], vals[1]) and np.array_equal(jvals[0], jvals[1])    # it = 1
    assert not torch.equal(vals[1], vals[2]) and not np.array_equal(jvals[1], jvals[2])
    assert torch.equal(vals[2], vals[3])                                          # it = 3
    assert [r["it"] for r in runs["port"]] == [1, 2, 3, 4]


def test_poisoned_step_on_the_cadence_is_skipped_but_refreshes_the_grid(runs):
    last, prev = runs["port"][POISONED], runs["port"][POISONED - 1]
    jlast, jprev = runs["jax"][POISONED], runs["jax"][POISONED - 1]
    assert last["metrics"]["step_skipped"] == jlast["metrics"]["step_skipped"] == 1
    assert last["metrics"]["skips_total"] == jlast["metrics"]["skips_total"] == 1
    assert not np.isfinite(last["metrics"]["loss_total"])
    for name, p in last["params"].items():
        assert torch.equal(p, prev["params"][name]), name
        np.testing.assert_array_equal(jlast["params"][name], jprev["params"][name])
    assert not torch.equal(last["occ"].val, prev["occ"].val)
    assert not np.array_equal(jlast["val"], jprev["val"])
    assert torch.isfinite(last["occ"].val).all() and 0 < last["metrics"]["occ_frac"] < 1


def test_draw_noise_for_the_bench_model(pair):
    trainer = pair["trainer"]
    a = trainer.draw_noise(N_RAYS, torch.Generator().manual_seed(3), it=4)
    b = trainer.draw_noise(N_RAYS, torch.Generator().manual_seed(3), it=5)
    assert set(a) == {"occ_proposal", "fine", "distant", "uniform", "occ_update"}
    assert set(b) == set(a) - {"occ_update"}                 # it = 5 is off the cadence
    assert a["occ_proposal"].shape == (N_RAYS, 8) and a["distant"].shape == (N_RAYS, 8)
    assert a["occ_update"]["cr"].shape == (1, R, R, R, 3) and a["uniform"].shape == (32, 3)
    assert torch.equal(a["fine"][1], b["fine"][1])
    assert "occ_update" not in trainer.draw_noise(N_RAYS, torch.Generator().manual_seed(3))


def test_converge_occ_carves_the_scene():
    renderer, _ = build_renderer(SMALL, device="cpu")
    accel = renderer.accels["cr"]
    st = converge_occ(accel, accel.init_state(), sdf_scene_tensor, n=3, it=1000, seed=0)
    frac = float(accel.occupied_fraction(st))
    assert 0.02 < frac < 0.6
    again = converge_occ(accel, accel.init_state(), sdf_scene_tensor, n=3, it=1000, seed=0)
    assert torch.equal(st.val, again.val)                    # from the seed
    x = torch.tensor([[0.45, 0.0, 0.0], [0.95, 0.95, 0.95]])     # on the sphere; a far corner
    assert accel.occupancy_at(st, x).tolist() == [True, False]


def test_train_loop_runs_on_the_cpu_and_the_loss_falls():
    out = train(SMALL, 40, device="cpu")
    log = out["log"]
    assert len(log) == 40 and all(np.isfinite(r["loss_total"]) for r in log)
    assert log[-1]["skips_total"] == 0 and all(0 < r["occ_frac"] < 1 for r in log)
    assert np.mean([r["loss_rgb"] for r in log[-5:]]) < np.mean([r["loss_rgb"] for r in log[:5]])
    assert out["state"].it == 40 and out["state"].occ["cr"].mask.dtype == torch.bool


def test_asset_route_builds_a_grid_and_a_distant_field():
    """The YAML route (``assetbank_cfg``): ``LoTDNeuSObj.accel_cfg`` gives the
    close-range model its occupancy grid, a ``NeRFDistant`` asset the distant
    field; the trainer carries the grid's state, renders through it and
    refreshes it on its cadence."""
    cfg = copy.deepcopy(SYNTHETIC_OBJECT)
    main = cfg["assetbank_cfg"]["Main"]["model_params"]
    main["encoding_cfg"].update(n_levels=4, max_res=64, n_hash_levels=0)
    main["query_cfg"].update(num_coarse=8, num_fine=[4, 4])
    main["accel_cfg"] = {"resolution": 16, "inv_s": 64.0, "ema_decay": 0.5,
                         "n_steps_between_update": 2}
    cfg["assetbank_cfg"]["Distant"] = {
        "model_class": "neuralsim_tpu.models.assets.NeRFDistant",
        "model_params": {"inner_radius": 1.0, "geo_feat_dim": 4,
                         "query_cfg": {"num_samples": 8}},
        "asset_params": {"training_cfg": {"lr": 5e-3}}}
    cfg["training"].update(n_rays=N_RAYS, uniform_sample_n=N_UNIFORM, num_iters=4)
    trainer, state = build_trainer(cfg, device="cpu")
    renderer = trainer.renderer
    accel = renderer.accels["cr"]
    assert (accel.res, accel.occ_inv_s, accel.ema_decay, accel.n_steps_between_update,
            accel.occ_thre, accel.samples_per_voxel) == (16, 64.0, 0.5, 2, 0.3, 1)
    assert renderer.param_keys == {"cr": "Main", "sky": "Sky", "distant": "Distant"}
    assert renderer.distant_query_cfg == {"num_samples": 8}
    assert set(state.occ) == {"cr"} and state.occ["cr"].mask.shape == (16, 16, 16)
    assert set(state.opt) == {"Main", "Sky", "Distant"}
    np.testing.assert_allclose(float(state.opt["Distant"].lr()), 5e-3, rtol=1e-6)
    state.occ["cr"] = converge_occ(accel, state.occ["cr"], sdf_scene_tensor, n=3)
    o, d = _rays()
    with torch.no_grad():
        out = renderer.ray_query(state.params, _t(o), _t(d), occ_states=state.occ,
                                 return_buffer=True)
    assert out["merged_buffer"]["t"].shape == (o.shape[0], 16 + 8)
    assert {"rendered_cr", "rendered_dv"} <= set(out)
    assert all(torch.isfinite(out[k]).all() for k in ("rgb_volume", "depth_volume"))
    dataset = SyntheticObjectDataset(n_frames=4, H=24, W=24)
    rng, gen = np.random.default_rng(0), torch.Generator().manual_seed(0)
    vals = []
    for _ in range(3):
        batch = to_device_batch(dataset.sample_pixels(rng, N_RAYS), "cpu")
        state, m = trainer.train_step(state, batch,
                                      trainer.draw_noise(N_RAYS, gen, state.it))
        vals.append(state.occ["cr"].val.clone())
        # the asset leaves the grid's warm-up at its default, so the floor keeps
        # every voxel occupied on these first steps
        assert np.isfinite(float(m["loss_total"])) and float(m["occ_frac"]) == 1.0
    assert accel.n_warmup_steps > 3
    assert torch.equal(vals[0], vals[1]) and not torch.equal(vals[1], vals[2])   # it 0, 1, 2
    # geometry "lotd" gives the 4-D LoTD distant field (held to JAX in
    # test_torch_streetsurf.py); a CP level of it is not ported and raises
    lotd4 = copy.deepcopy(cfg)
    lotd4["assetbank_cfg"]["Distant"]["model_params"].update(
        geometry="lotd", encoding_cfg={"n_levels": 2, "base_res": 4, "max_res": 8,
                                       "log2_hashmap_size": 10})
    _, st4 = build_trainer(lotd4, device="cpu")
    assert st4.params["Distant"].encoding.input_dim == 4
    with pytest.raises(NotImplementedError, match="CP level of a 4-D LoTD"):
        lotd4["assetbank_cfg"]["Distant"]["model_params"]["encoding_cfg"] = {
            "levels": [(8, 2, "cp")]}
        build_trainer(lotd4, device="cpu")


def test_full_width_bench_model_builds_on_cpu():
    """The full-width model, without its 128^3 warm-up (that runs on the card)."""
    cfg = {k: v for k, v in BENCH_OBJECT.items() if k != "occ_converge"}
    trainer, state = build_trainer(cfg, device="cpu")
    enc = state.params["cr"].encoding
    assert enc.out_dim == 96 and enc.cp_rmax == 1024 and enc.total_params == 77256
    assert state.params["cr"].decoder.layers[0].W.shape == (96, 64)
    assert state.params["distant"].decoder.layers[0].W.shape == (68, 64)
    assert state.params["distant"].radiance.layers[0].W.shape == (8 + 16, 32)
    accel = trainer.renderer.accels["cr"]
    assert (accel.res, accel.march_steps, accel.n_warmup_steps, accel.occ_inv_s) == \
        (128, 48, 0, 64.0)
    assert state.occ["cr"].mask.shape == (128, 128, 128) and state.occ["cr"].mask.all()
    assert trainer.uniform_sample_n == 1024 and trainer.renderer.distant_query_cfg == \
        {"num_samples": 32}
    np.testing.assert_allclose([float(state.opt[r].lr()) for r in ("cr", "distant", "sky")],
                               [1e-2, 5e-3, 3e-3], rtol=1e-6)
    np.testing.assert_allclose(float(state.params["cr"].forward_inv_s()), 30.0, rtol=1e-5)
