"""Port parity for the whole multi-object training slice: the
``waymo_demo_multi`` scene trained through ``build_multi_trainer`` and
``MultiObjectTrainer`` (a LiDAR step of the street alone, then a pixel step of
every source, each with the uniform and on-render eikonal, sparsity,
clearance and latent losses), against the JAX package's ``AssetBank``,
``BufferComposeRenderer`` and ``MultiObjectTrainer`` on the CPU.

Small size: the compose render test's model (2 vehicles on one conditional
model of 2 dense + 2 CP levels of 2 features, the street of 3 CP levels to
64 with a 16^3 grid refreshed every 2nd step, 8 distant samples, narrow
MLPs), 3 frames of 32x48, 64 pixel rays and 48 LiDAR beams a step, 32 uniform
points a model. The JAX parameters (their tables moved off the init) are
carried over through ``neuralsim_torch.bridge``; both packages get the same
batches (the port's samplers) and the same draws, made with ``jax.random``
by replaying the JAX key tree: ``compute_losses`` splits the step's key into
(render, uniform, eikonal); the vehicles' group draws from ``fold_in(render,
0)`` (coarse jitter off a split, then one split a stage), the street from
``fold_in(render, 1000)`` (its grid's proposal from the whole key, then the
stage splits), the distant field from ``fold_in(render, 1001)``, model i's
uniform points from ``fold_in(uniform, i)`` and the grid refresh from
``fold_in(step key, 7)``. The steps run at iterations 2000-2002, where the
sparsity ramp, the street's inv_s anneal and the line of sight's epsilon
milestones are live.

Sample placement is shared: the street's grid proposal and the upsample
stages' inverse CDFs turn last-bit differences of their cdf sums (another
summation order in each package, and another again in the jitted JAX step)
into moved samples on some rays (here 6 of 64 pixel rays; with the
occupancy-mask loss's steep log near a mask of 1, one such ray moves the mean
loss by 1e-3), so each port step records its sample depths (the grid's
proposal and every upsample stage's draws) and the JAX step, traced anew,
takes them as constants in place of its own. Every other operation of both
steps runs as is, JAX's jitted. The placements themselves are held to JAX in
test_torch_occ_grid.py and test_torch_upsample.py.

Tolerances. One LiDAR step and one pixel step: every loss term within 1e-4
relative (measured <= 3.5e-5, the eikonal: it squares ``|nablas| - 1`` near
zero; the others <= 1.3e-6), every gradient leaf within GRAD_REL of its
largest entry (measured <= 1.9e-4), the table leaves within TABLE_GRAD_REL
(JAX rounds its stacked-CP line gradient to bf16, see test_torch_lotd_grad.py;
measured <= 2.8e-3). Three whole iterations: the Adam counts and ``it``
equal, the grid's values within 1e-4 and its mask equal on all but 0.5% of
the voxels (measured: equal), and the parameters within one lr on all but
0.5% of each leaf's entries and within 6 lr everywhere (Adam with eps 1e-15
steps by ``lr * sign(g)`` where a gradient is tiny, and the tables' bf16
line gradients flip such signs; measured: 0.45% of the vehicle table beyond
one lr, at most 2.98 lr). The road-surface pretrain: 5 Adam steps (lr 5e-3,
eps 1e-8) with the same draws, every street leaf within 2% of one lr (JAX
rounds the table's line gradient to bf16, the port keeps float32; measured
0.92% of an lr in the table).
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralsim_tpu.fields.neus as jax_neus
from neuralsim_tpu.accel.occ_grid import OccGridState as JaxOcc
from neuralsim_tpu.renderers.buffer_compose import BufferComposeRenderer as JaxCompose
from neuralsim_tpu.scene import AssetBank as JaxBank
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.training.multi_trainer import MultiObjectTrainer as JaxMOT
import neuralsim_torch.fields.neus as port_neus
from neuralsim_torch import kernels
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves
from neuralsim_torch.configs import WAYMO_DEMO_MULTI
from neuralsim_torch.tools.build import build_multi_trainer
from neuralsim_torch.tools.train_multi import _LIDAR_KEYS, _PIXEL_KEYS, to_device, train_multi
from neuralsim_torch.training.multi_trainer import lift_lidar_batch

torch.set_num_threads(1)

N_RAYS, N_LIDAR, N_UNIFORM, R, IT0 = 64, 48, 32, 16, 2000
SMALL = copy.deepcopy(WAYMO_DEMO_MULTI)
SMALL["dataset_cfg"]["params"] = {"n_frames": 3, "H": 32, "W": 48, "n_vehicles": 2, "seed": 0}
_B = SMALL["assetbank_cfg"]
_B["Vehicle"]["model_params"].update(
    z_dim=4, geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32},
    query_cfg={"num_coarse": 8, "num_fine": [4], "upsample_inv_s_factors": [1.0]})
_B["Street"]["model_params"].update(
    geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"type": "tpu_mixed", "n_levels": 3, "base_res": 16, "max_res": 64,
                  "n_feats": 2, "n_hash_levels": 0, "cp_max_res": 64},
    query_cfg={"num_coarse": 8, "num_fine": [4, 4], "upsample_inv_s": 64.0,
               "upsample_inv_s_factors": [1.0, 4.0]},
    pretrain={"type": "road_surface", "z_road": 0.0, "up_axis": 2, "n_iters": 5, "n_pts": 64})
_B["Street"]["model_params"]["accel_cfg"].update(resolution=R, samples_per_voxel=1,
                                                  n_steps_between_update=2, ema_decay=0.2)
_B["Distant"]["model_params"].update(geo_feat_dim=4, query_cfg={"num_samples": 8})
_B["Sky"]["model_params"] = {"hidden": 8}
SMALL["training"].update(n_rays=N_RAYS, n_rays_lidar=N_LIDAR, uniform_sample_n=N_UNIFORM,
                         i_log=1, error_map={"hw": [4, 6], "frac_uniform": 0.5,
                                             "enable_after": 1})
LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_eikonal", "loss_sparsity",
          "loss_clearance", "loss_latent")
LIDAR_LOSSES = ("loss_total", "loss_lidar", "loss_eikonal", "loss_sparsity", "loss_clearance",
                "loss_latent")
GRAD_REL, TABLE_GRAD_REL = 1e-3, 5e-3
PRETRAIN_LR, PRETRAIN_TOL = 5e-3, 0.02


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    scene, bank, trainer, state, samplers = build_multi_trainer(SMALL, device="cpu")
    r = SMALL["renderer"]
    jscene = JaxScene.load_from_scenario(samplers["pixel"].loader.dataset.scenario)
    jbank = JaxBank.create(_B, [jscene])
    jr = JaxCompose.from_asset_bank(jscene, jbank, cr_class=r["cr_class"],
                                    distant_class=r["distant_class"], sky_class=r["sky_class"],
                                    hit_budget_frac=0.5, group_budget_frac=r["group_budget_frac"],
                                    max_hits_per_ray=r["max_hits_per_ray"])
    t = SMALL["training"]
    jt = JaxMOT(jscene, jr, loss_cfgs=t["losses"], training_cfgs=jbank.training_cfgs(),
                uniform_sample_n=N_UNIFORM)
    jp = jax.tree.map(np.asarray, jbank.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for tree in jp.values():            # move the tables off their init, so the fields vary
        if "encoding" in tree:
            tbl = tree["encoding"]["table"]
            tree["encoding"]["table"] = (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
    jp["Vehicle#demo_drive"]["latents"] = rng.normal(0, 0.3, (2, 4)).astype(np.float32)
    load_jax_params(state.params, jp)
    state = trainer.init_state(state.params)
    state.it = IT0
    batches = []
    for _ in range(3):
        lb = samplers["lidar"].sample()
        raw = samplers["pixel"].sample()
        batches.append((lb, raw))
    return dict(scene=scene, bank=bank, trainer=trainer, state=state, samplers=samplers,
                jscene=jscene, jbank=jbank, jr=jr, jt=jt, jp=jp, batches=batches)


def _noise(pair, step_type, key, it):
    """The draws of one JAX step of ``step_type`` at iteration ``it``."""
    k_render, k_uniform, _ = jax.random.split(key, 3)
    trainer = pair["trainer"]
    n = N_LIDAR if step_type == "lidar" else N_RAYS
    shapes = trainer.renderer.noise_shapes(n, only_cr=step_type == "lidar")
    street = trainer.renderer.scene_models["cr"][0]
    distant = trainer.renderer.scene_models["distant"][0]
    render = {}
    for mid, spec in shapes.items():
        if mid == distant:
            render[mid] = jax.random.uniform(jax.random.fold_in(k_render, 1001), spec)
            continue
        if mid == street:
            kb = jax.random.fold_in(k_render, 1000)
            render[mid] = {"occ_proposal": jax.random.uniform(kb, spec["occ_proposal"])}
            k = kb                          # the stage keys come off the whole street key
        else:
            kb = jax.random.fold_in(k_render, 0)        # the one object group
            jit_k, k = jax.random.split(kb)
            render[mid] = {"coarse": jax.random.uniform(jit_k, spec["coarse"])}
        render[mid]["fine"] = []
        for shp in spec["fine"]:
            sk, k = jax.random.split(k)
            render[mid]["fine"].append(jax.random.uniform(sk, shp))
    noise = {"render": render,
             "uniform": {mid: jax.random.uniform(jax.random.fold_in(k_uniform, i), (N_UNIFORM, 3))
                         for i, mid in enumerate(trainer._model_ids())}}
    if step_type == "pixel" and it % 2 == 0:
        noise["occ_update"] = {"cr": jax.random.uniform(jax.random.fold_in(key, 7),
                                                        (1, R, R, R, 3))}
    return jax.tree.map(_t, noise)


def _port_batch(pair, step_type, raw):
    if step_type == "lidar":
        return lift_lidar_batch(pair["scene"], {**to_device(raw, _LIDAR_KEYS, "cpu"),
                                                "lidar_id": raw["lidar_id"]})
    return to_device(raw, _PIXEL_KEYS, "cpu")


def _jax_batch(pair, step_type, raw):
    if step_type == "lidar":
        from neuralsim_tpu.tools.train import lift_lidar_batch as jax_lift
        b = jax_lift(pair["jscene"], raw)
        b["rays_fidx"] = jnp.asarray(raw["rays_fidx"])
        return b
    return {k: jnp.asarray(raw[k]) for k in _PIXEL_KEYS}


def _scalars(m):
    return {k: float(v) for k, v in m.items() if np.ndim(v) == 0}


@contextlib.contextmanager
def _port_records(pair, placements):
    """Record the port's sample depths, in call order, into ``placements``."""
    accel = pair["trainer"].renderer.accels["cr"]
    upsample = port_neus.upsample_weights_pdf

    def proposal(*a, **kw):
        t, m = type(accel).ray_proposal(accel, *a, **kw)
        placements.append(t.numpy().copy())
        return t, m

    def stage(*a, **kw):
        w, t_new = upsample(*a, **kw)
        placements.append(t_new.numpy().copy())
        return w, t_new

    accel.ray_proposal, port_neus.upsample_weights_pdf = proposal, stage
    try:
        yield
    finally:
        del accel.ray_proposal
        port_neus.upsample_weights_pdf = upsample


@contextlib.contextmanager
def _jax_takes(pair, placements):
    """Hand ``placements`` to a JAX step being traced, in the same order."""
    accel, pdf = pair["jr"].accels["cr"], jax_neus.sample_pdf
    queue = list(placements)

    def take(shape):
        t = queue.pop(0)
        assert t.shape == tuple(shape), (t.shape, shape)
        return jnp.asarray(t)

    def proposal(st, rays_o, rays_d, near, far, n, key=None, **kw):
        return take((rays_o.shape[0], n)), jnp.ones((rays_o.shape[0], n), bool)

    accel.ray_proposal = proposal
    jax_neus.sample_pdf = lambda bins, w, n, **kw: take(bins.shape[:-1] + (n,))
    try:
        yield
    finally:
        del accel.ray_proposal
        jax_neus.sample_pdf = pdf
    assert not queue


@pytest.fixture(scope="module")
def first_steps(pair):
    """One LiDAR step's and one pixel step's losses and gradients, from the
    same parameters and sample depths, in both packages."""
    out = {}
    trainer, state, jt = pair["trainer"], pair["state"], pair["jt"]
    jparams = jax.tree.map(jnp.asarray, pair["jp"])
    jocc = {"cr": JaxOcc(jnp.asarray(state.occ["cr"].val.numpy()),
                         jnp.asarray(state.occ["cr"].mask.numpy()))}
    plist = dict(state.params.named_parameters())
    lb, raw = pair["batches"][0]
    for step_type, b in (("lidar", lb), ("pixel", raw)):
        key = jax.random.PRNGKey({"lidar": 11, "pixel": 12}[step_type])
        cam = raw["cam_id"] if step_type == "pixel" else None
        placements = []
        with _port_records(pair, placements):
            total, extras = trainer.compute_losses(
                state.params, _port_batch(pair, step_type, b), IT0,
                _noise(pair, step_type, key, IT0), step_type, state.occ, cam)
        grads = torch.autograd.grad(total, list(plist.values()), allow_unused=True)
        jb = _jax_batch(pair, step_type, b)
        with _jax_takes(pair, placements):
            (jtotal, jextras), jg = jax.jit(jax.value_and_grad(
                lambda p: jt.compute_losses(p, jb, IT0, key, step_type, occ=jocc, cam_id=cam),
                has_aux=True))(jparams)
        out[step_type] = dict(
            got={"loss_total": float(total.detach()),
                 **_scalars({k: v.detach() for k, v in extras["losses"].items()})},
            want={"loss_total": float(jtotal), **_scalars(jextras["losses"])},
            got_aux=extras["aux"], want_aux=jextras["aux"],
            grads={k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
                   for (k, p), g in zip(plist.items(), grads)},
            jgrads=named_jax_leaves(jax.device_get(jg), {m: m for m in jg}))
    return out


@pytest.mark.parametrize("step_type,term", [("lidar", t) for t in LIDAR_LOSSES]
                         + [("pixel", t) for t in LOSSES])
def test_first_step_loss_terms_match_jax(first_steps, step_type, term):
    r = first_steps[step_type]
    assert set(r["got"]) == set(r["want"])
    np.testing.assert_allclose(r["got"][term], r["want"][term], rtol=1e-4, atol=1e-7)


def test_lidar_step_aux_and_error_map_match_jax(first_steps):
    lid, pix = first_steps["lidar"], first_steps["pixel"]
    for k in ("lidar_loss_depth", "lidar_loss_los", "lidar_valid_frac", "rendered_mask_mean"):
        np.testing.assert_allclose(float(lid["got_aux"][k]), float(lid["want_aux"][k]),
                                   rtol=1e-4, atol=1e-7)
    assert float(lid["got_aux"]["lidar_loss_los"]) > 0
    np.testing.assert_allclose(pix["got_aux"]["err_map"].numpy(),
                               np.asarray(pix["want_aux"]["err_map"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("step_type", ["lidar", "pixel"])
def test_first_step_gradients_match_jax_leaf_by_leaf(first_steps, step_type):
    r = first_steps[step_type]
    assert set(r["grads"]) == set(r["jgrads"])
    reached = 0
    for k, w in r["jgrads"].items():
        w = np.asarray(w)
        g = r["grads"][k]
        if not np.abs(w).max():
            assert not np.abs(g).max(), k           # what JAX does not reach, nor does the port
            continue
        reached += 1
        rel = TABLE_GRAD_REL if k.endswith("encoding.table") else GRAD_REL
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (k, np.abs(g - w).max(),
                                                                np.abs(w).max())
    street_only = all(k.startswith("Street") for k, w in r["jgrads"].items()
                      if np.abs(np.asarray(w)).max())
    if step_type == "lidar":
        # the LiDAR step reaches the street and the vehicles' latents (latent loss)
        assert reached >= 5 and not street_only
    else:
        assert reached >= 15
        assert np.abs(r["grads"]["Vehicle#demo_drive.latents"]).max() > 0


@pytest.fixture(scope="module")
def runs(pair):
    """Three loop iterations (LiDAR step, then pixel step) in both packages,
    each JAX step traced anew with the port step's sample depths; with each
    step type's metric keys in both ({step type: (port's, JAX's)})."""
    trainer = pair["trainer"]
    state = copy.deepcopy(pair["state"])
    state.opt = trainer.init_state(state.params).opt
    jt = pair["jt"]
    jstep = type(jt).train_step.__wrapped__           # traced anew for each step below
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, pair["jp"]))
    jstate = jstate._replace(it=jnp.asarray(IT0, jnp.int32),
                             occ={"cr": JaxOcc(jnp.asarray(state.occ["cr"].val.numpy()),
                                               jnp.asarray(state.occ["cr"].mask.numpy()))})
    key = jax.random.PRNGKey(1)
    keys = {}
    for lb, raw in pair["batches"]:
        key, k_lidar, k_pixel = jax.random.split(key, 3)
        for step_type, b, k in (("lidar", lb, k_lidar), ("pixel", raw, k_pixel)):
            cam = raw["cam_id"] if step_type == "pixel" else None
            placements = []
            with _port_records(pair, placements):
                state, m = trainer.train_step(state, _port_batch(pair, step_type, b),
                                              _noise(pair, step_type, k, state.it), step_type,
                                              cam, step_type == "pixel")
            assert int(m["step_skipped"]) == 0
            jb = _jax_batch(pair, step_type, b)
            with _jax_takes(pair, placements):
                jstate, jm = jax.jit(lambda st: jstep(jt, st, jb, k, step_type, cam,
                                                      step_type == "pixel"))(jstate)
            keys[step_type] = (set(m), set(jm))
    return state, jstate, keys


def test_three_iterations_follow_jax(pair, runs):
    state, jstate, _ = runs
    assert state.it == int(jstate.it) == IT0 + 3
    for mid, opt in state.opt.items():
        chain = jstate.opt_state.inner_states[mid].inner_state
        adam = next(s for s in chain if isinstance(s, optax.ScaleByAdamState))
        assert int(opt.count) == int(adam.count) == 6       # both step types, every model
    val, jval = state.occ["cr"].val.numpy(), np.asarray(jstate.occ["cr"].val)
    np.testing.assert_allclose(val, jval, atol=1e-4)
    assert np.mean(state.occ["cr"].mask.numpy() != np.asarray(jstate.occ["cr"].mask)) <= 5e-3
    want = named_jax_leaves(jax.device_get(jstate.params), {m: m for m in jstate.params})
    lrs = {mid: float(opt.lr()) for mid, opt in state.opt.items()}
    for k, p in state.params.named_parameters():
        diff = np.abs(p.detach().numpy() - np.asarray(want[k]))
        lr = lrs[k.split(".")[0]]
        assert np.mean(diff > lr) <= 5e-3 and diff.max() <= 6 * lr, (k, float(diff.max()))


@pytest.mark.parametrize("step_type", ["lidar", "pixel"])
def test_step_metric_keys_are_the_jax_steps(runs, step_type):
    """A multi-object step returns the JAX step's metric keys: no grid share
    (``occ_frac``), which the JAX multi-object step does not report."""
    got, want = runs[2][step_type]
    assert "occ_frac" not in got
    assert got == want, {"port only": sorted(got - want), "JAX only": sorted(want - got)}


def test_a_poisoned_pixel_step_is_skipped_and_changes_nothing(pair):
    trainer = pair["trainer"]
    state = copy.deepcopy(pair["state"])
    state.opt = trainer.init_state(state.params).opt
    before = {k: v.detach().clone() for k, v in state.params.named_parameters()}
    raw = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in pair["batches"][1][1].items()}
    raw["image_rgb"][5, 0] = np.nan
    gen = torch.Generator().manual_seed(0)
    state, m = trainer.train_step(state, _port_batch(pair, "pixel", raw),
                                  trainer.draw_noise("pixel", N_RAYS, gen, state.it), "pixel",
                                  raw["cam_id"])
    assert int(m["step_skipped"]) == 1 and int(state.skips) == 1 and state.it == IT0 + 1
    for k, v in state.params.named_parameters():
        assert torch.equal(v, before[k]), k
    assert all(int(o.count) == 0 for o in state.opt.values())


def test_pretrain_matches_jax(pair):
    """The bank's geometry pretraining: the street's 5 road-surface Adam steps
    on the same uniform points, from the same parameters."""
    jbank, bank = pair["jbank"], pair["bank"]
    k_pre = jax.random.PRNGKey(9)
    jp = jax.tree.map(jnp.asarray, pair["jp"])
    want = jbank.training_initialize(jp, k_pre)
    street = "Street#demo_drive"
    i = list(jbank.assets).index(street)
    keys = jax.random.split(jax.random.fold_in(k_pre, i), 5)
    noise = np.stack([np.asarray(jax.random.uniform(k, (64, 3))) for k in keys])
    assert bank.pretrain_shapes() == {street: (5, 64, 3)}
    params = copy.deepcopy(pair["state"].params)
    load_jax_params(params, pair["jp"])
    fields = {mid: a.field for mid, a in bank.assets.items()}
    try:
        for mid in params:
            bank.assets[mid].field = params[mid]
        bank.training_initialize({street: _t(noise)})
    finally:
        for mid, f in fields.items():
            bank.assets[mid].field = f
    got = dict(params.named_parameters())
    moved = 0
    for k, w in named_jax_leaves(jax.device_get(want), {m: m for m in want}).items():
        w, g = np.asarray(w), got[k].detach().numpy()
        assert np.abs(g - w).max() <= PRETRAIN_TOL * PRETRAIN_LR, k
        moved += not np.array_equal(w, np.asarray(named_jax_leaves(pair["jp"], {
            m: m for m in pair["jp"]})[k]))
    assert moved >= 3                  # the street's table and decoder moved


def test_draw_noise_shapes(pair):
    trainer = pair["trainer"]
    gen = torch.Generator().manual_seed(0)
    lid = trainer.draw_noise("lidar", N_LIDAR, gen, 2000)
    pix = trainer.draw_noise("pixel", N_RAYS, gen, 2000)
    street, veh = "Street#demo_drive", "Vehicle#demo_drive"
    assert set(lid["render"]) == {street} and "occ_update" not in lid
    assert set(pix["render"]) == {veh, street, "Distant#demo_drive"}
    assert pix["render"][veh]["coarse"].shape == (2 * N_RAYS // 2, 8)
    assert pix["render"][street]["occ_proposal"].shape == (N_RAYS, 8)
    assert pix["occ_update"]["cr"].shape == (1, R, R, R, 3)
    assert "occ_update" not in trainer.draw_noise("pixel", N_RAYS, gen, 2001)
    assert list(pix["uniform"]) == [veh, street]
    with pytest.raises(NotImplementedError, match="image_patch"):
        trainer.draw_noise("image_patch", N_RAYS, gen, 0)


def test_train_multi_runs_on_the_cpu():
    """The loop: a LiDAR and a pixel step an iteration, the error map fed back,
    no kernel launched on the CPU."""
    kernels.reset_counts()
    out = train_multi(SMALL, 3, device="cpu")
    assert out["state"].it == 3 and [r["it"] for r in out["log"]] == [0, 1, 2]
    for r in out["log"]:
        assert np.isfinite(r["loss_total"]) and np.isfinite(r["lidar/loss_total"])
        assert r["step_skipped"] == 0 and r["lidar/step_skipped"] == 0
    assert out["samplers"]["imp"].it == 3
    assert not any(k.launches for k in kernels.KERNELS.values())
