"""Port parity for a training step of a crowded scene: 6 vehicles on one
shared model with per-instance occupancy grids, so the group takes the
pair-budget path (K11) and its coarse samples come from each row's instance
grid (K10), folded into ``max_hits_per_ray`` slot lanes a ray; against the
JAX package's ``MultiObjectTrainer`` built from the same dict, on the CPU.

Small size: test_torch_multi_train.py's widths with 6 vehicles, the
vehicles' grids at 16^3 (their cadence is the JAX package's fixed 16 steps)
and the street's at 16^3 refreshed every 2nd step, 3 frames of 32x48, 64
pixel rays, 32 uniform points a model; the step at iteration 2000, on both
grids' cadence. The JAX parameters (their tables moved off the init, random
latents) are carried over through ``neuralsim_torch.bridge``; both packages
get the same batch and the same draws (``jax.random``, replaying the JAX key
tree as test_torch_multi_train.py does; the vehicles' grid proposal draws
from the whole group key, as the street's), and the JAX step, traced anew
and jitted, takes the port step's sample depths (every grid proposal and
upsample stage), as there.

Tolerances, as test_torch_multi_train.py holds its steps: every loss term
within 1e-4 relative, every gradient leaf within 1e-3 of its largest entry,
the tables within 5e-3 (JAX rounds its stacked-CP line gradient to bf16). The
refresh after the step, on both grids' cadence, from the port's stepped
parameters in both packages: the grids' values within 1e-4 and their masks
equal on all but 0.5% of the voxels.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel.occ_grid import OccGridState as JaxOcc
from neuralsim_tpu.renderers.buffer_compose import BufferComposeRenderer as JaxCompose
from neuralsim_tpu.scene import AssetBank as JaxBank
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.training.multi_trainer import MultiObjectTrainer as JaxMOT
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves
from neuralsim_torch.configs import WAYMO_DEMO_CROWD
from neuralsim_torch.tools.build import build_multi_trainer
from neuralsim_torch.tools.train_multi import _PIXEL_KEYS, to_device
from test_torch_pair_compact import _records as _port_records
from test_torch_pair_compact import _takes as _jax_takes

torch.set_num_threads(1)

N_RAYS, N_UNIFORM, R, R_VEH, IT0 = 64, 32, 16, 16, 2000
VEH, STREET = "Vehicle#demo_drive", "Street#demo_drive"
SMALL = copy.deepcopy(WAYMO_DEMO_CROWD)
SMALL["dataset_cfg"]["params"] = {"n_frames": 3, "H": 32, "W": 48, "n_vehicles": 6, "seed": 0}
_B = SMALL["assetbank_cfg"]
_B["Vehicle"]["model_params"].update(
    z_dim=4, geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32},
    query_cfg={"num_coarse": 8, "num_fine": [4], "upsample_inv_s_factors": [1.0]})
_B["Vehicle"]["model_params"]["accel_cfg"]["resolution"] = R_VEH
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
SMALL["training"].update(n_rays=N_RAYS, n_rays_lidar=48, uniform_sample_n=N_UNIFORM, i_log=1)
LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_eikonal", "loss_sparsity",
          "loss_clearance", "loss_latent")
GRAD_REL, TABLE_GRAD_REL = 1e-3, 5e-3


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
    jt = JaxMOT(jscene, jr, loss_cfgs=SMALL["training"]["losses"],
                training_cfgs=jbank.training_cfgs(), uniform_sample_n=N_UNIFORM)
    jp = jax.tree.map(np.asarray, jbank.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for tree in jp.values():            # move the tables off their init, so the fields vary
        if "encoding" in tree:
            tbl = tree["encoding"]["table"]
            tree["encoding"]["table"] = (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
    jp[VEH]["latents"] = rng.normal(0, 0.3, jp[VEH]["latents"].shape).astype(np.float32)
    load_jax_params(state.params, jp)
    state = trainer.init_state(state.params)
    state.it = IT0
    # grids that are not all occupied: the vehicles' from random masks that
    # differ by instance, the street's from its initial state decayed
    g = np.random.default_rng(1)
    val = (g.random((6, R_VEH, R_VEH, R_VEH)) * np.linspace(0.4, 1.0, 6)[:, None, None, None]
           ).astype(np.float32)
    state.occ[VEH] = type(state.occ[VEH])(torch.from_numpy(val), torch.from_numpy(val > 0.3))
    return dict(scene=scene, trainer=trainer, state=state, samplers=samplers, jr=jr, jt=jt,
                jp=jp, raw=samplers["pixel"].sample())


def _jocc(state):
    return {k: JaxOcc(jnp.asarray(v.val.numpy()), jnp.asarray(v.mask.numpy()))
            for k, v in state.occ.items()}


def _noise(trainer, key, it):
    """The draws of one JAX pixel step at iteration ``it``."""
    k_render, k_uniform, _ = jax.random.split(key, 3)
    shapes = trainer.renderer.noise_shapes(N_RAYS)
    distant = trainer.renderer.scene_models["distant"][0]
    render = {}
    for mid, spec in shapes.items():
        if mid == distant:
            render[mid] = jax.random.uniform(jax.random.fold_in(k_render, 1001), spec)
            continue
        # a grid's proposal draws from the model's whole key, the stages off it
        k = jax.random.fold_in(k_render, 1000 if mid == STREET else 0)
        render[mid] = {"occ_proposal": jax.random.uniform(k, spec["occ_proposal"]), "fine": []}
        for shp in spec["fine"]:
            sk, k = jax.random.split(k)
            render[mid]["fine"].append(jax.random.uniform(sk, shp))
    k_occ = jax.random.fold_in(key, 7)
    noise = {"render": render,
             "uniform": {mid: jax.random.uniform(jax.random.fold_in(k_uniform, i), (N_UNIFORM, 3))
                         for i, mid in enumerate(trainer._model_ids())},
             "occ_update": {role: jax.random.uniform(k_occ, a.jitter_shape)
                            for role, a in trainer.renderer.accels.items()
                            if it % a.n_steps_between_update == 0}}
    return jax.tree.map(_t, noise)


@pytest.fixture(scope="module")
def step(pair):
    """One pixel step's losses and gradients in both packages, then the port's
    step with its refresh."""
    trainer, state, raw = pair["trainer"], pair["state"], pair["raw"]
    key = jax.random.PRNGKey(12)
    noise = _noise(trainer, key, IT0)
    assert set(noise["occ_update"]) == {"cr", VEH}
    plist = dict(state.params.named_parameters())
    placements = []
    batch = to_device(raw, _PIXEL_KEYS, "cpu")
    with _port_records(trainer.renderer, placements):
        total, extras = trainer.compute_losses(state.params, batch, IT0, noise, "pixel",
                                               state.occ, raw["cam_id"])
    grads = torch.autograd.grad(total, list(plist.values()), allow_unused=True)
    jb = {k: jnp.asarray(raw[k]) for k in _PIXEL_KEYS}
    jocc = _jocc(state)
    with _jax_takes(pair["jr"], placements):
        (jtotal, jextras), jg = jax.jit(jax.value_and_grad(
            lambda p: pair["jt"].compute_losses(p, jb, IT0, key, "pixel", occ=jocc,
                                                cam_id=raw["cam_id"]),
            has_aux=True))(jax.tree.map(jnp.asarray, pair["jp"]))
    st = copy.deepcopy(state)
    st, m = trainer.train_step(st, batch, noise, "pixel", raw["cam_id"])
    return dict(
        got={"loss_total": float(total.detach()),
             **{k: float(v.detach()) for k, v in extras["losses"].items()}},
        want={"loss_total": float(jtotal),
              **{k: float(v) for k, v in jextras["losses"].items()}},
        grads={k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
               for (k, p), g in zip(plist.items(), grads)},
        jgrads=named_jax_leaves(jax.device_get(jg), {m_: m_ for m_ in jg}),
        placements=placements, stepped=st, metrics=m, key=key, before=jocc)


def test_the_step_takes_the_pair_budget_path_with_vehicle_grids(pair, step):
    r = pair["trainer"].renderer
    assert r._pair_rows(r.objects, N_RAYS) == N_RAYS and set(r.accels) == {"cr", VEH}
    # proposals and stages in call order: vehicles (grid, one stage), street (grid, two)
    assert [p.shape for p in step["placements"]] == [(N_RAYS, 8), (N_RAYS, 4), (N_RAYS, 8),
                                                     (N_RAYS, 4), (N_RAYS, 4)]
    assert int(step["metrics"]["step_skipped"]) == 0


@pytest.mark.parametrize("term", LOSSES)
def test_pixel_step_loss_terms_match_jax(step, term):
    assert set(step["got"]) == set(step["want"])
    np.testing.assert_allclose(step["got"][term], step["want"][term], rtol=1e-4, atol=1e-7)


def test_pixel_step_gradients_match_jax_leaf_by_leaf(step):
    assert set(step["grads"]) == set(step["jgrads"])
    reached = 0
    for k, w in step["jgrads"].items():
        w, g = np.asarray(w), step["grads"][k]
        if not np.abs(w).max():
            assert not np.abs(g).max(), k
            continue
        reached += 1
        rel = TABLE_GRAD_REL if k.endswith("encoding.table") else GRAD_REL
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (k, np.abs(g - w).max(),
                                                                np.abs(w).max())
    assert reached >= 15 and np.abs(step["grads"][f"{VEH}.latents"]).max() > 0


def _as_jax(tree, named):
    """The JAX tree ``tree`` with each leaf replaced by the port's parameter
    of the same dotted path."""
    def leaf(path, _):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path)
        return jnp.asarray(named[key].detach().numpy())
    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_refresh_on_the_cadence_matches_jax(pair, step):
    """Both grids refreshed after the step, from the stepped parameters, with
    the step's jitter (``fold_in(key, 7)``), against the JAX package's grids'
    update as its train_step calls it."""
    st, jr = step["stepped"], pair["jr"]
    assert st.it == IT0 + 1
    k_occ = jax.random.fold_in(step["key"], 7)
    for role, mid, field in (("cr", STREET, jr.scene_models["cr"][0]),
                             (VEH, VEH, jr.objects[0].field)):
        p = _as_jax(pair["jp"][mid], dict(st.params[mid].named_parameters()))
        fn = (lambda x, f=field, p=p: f.query_sdf(p, x)) if role == "cr" else \
            (lambda x, b, f=field, p=p: f.query_sdf(p, x, bidx=b))
        want = jr.accels[role].update(step["before"][role], fn, k_occ, IT0)
        got = st.occ[role]
        np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val), atol=1e-4)
        assert np.mean(got.mask.numpy() != np.asarray(want.mask)) <= 5e-3
    # the vehicles' grids moved off their random start (the street's, 16^3 over
    # an 83 m box, has every voxel within half a voxel's diagonal of its SDF)
    assert not torch.equal(st.occ[VEH].mask, pair["state"].occ[VEH].mask)
