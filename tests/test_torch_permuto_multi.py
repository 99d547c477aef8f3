"""Port parity for the permuto slice: the ``waymo_demo_multi`` scene with
its vehicles on one ``ADGenerativePermutoConcatNeuSObj``
(``WAYMO_DEMO_PERMUTO``) trained and rendered through
``build_multi_trainer``, against the JAX package on the CPU (the fields alone:
test_torch_permuto_field.py).

test_torch_multi_train.py's ``SMALL`` with the vehicles on the permuto model
(2 vehicles, one lattice level of 2 features at 16 on a 2^10 table, z_dim 8,
so d = 11: the JAX reference's trace and compile grow with the levels, and
the level ladder is held by test_torch_permuto.py and
test_torch_permuto_field.py at 3 levels), with that file's batches, replay of
the JAX key tree and sharing of sample depths (each port step records its
sample depths and the JAX step, traced anew and jitted, takes them). One
LiDAR step and one pixel step: every loss term within 1e-4 relative, every
gradient leaf within 1e-3 of its largest entry (the permuto table and the
latents included; the street's table within TABLE_GRAD_REL, its stacked-CP
line gradient rounded to bf16 by JAX). The compose crop (512 rays of frame 0
at the port's sample depths, every source): the limits of
test_torch_perlevel_multi.py.
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
from neuralsim_tpu.scene.observers import camera_get_all_rays as jax_all_rays
from neuralsim_tpu.training.multi_trainer import MultiObjectTrainer as JaxMOT
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves
from neuralsim_torch.configs import WAYMO_DEMO_PERMUTO
from neuralsim_torch.dataio.waymo_demo import ground_sdf_tensor
from neuralsim_torch.scene.observers import camera_get_all_rays
from neuralsim_torch.tools.build import build_multi_trainer, converge_occ
from test_torch_multi_train import (IT0, LIDAR_LOSSES, LOSSES, N_UNIFORM, SMALL,
                                    TABLE_GRAD_REL, _jax_batch, _jax_takes, _noise, _port_batch,
                                    _port_records, _scalars)
from test_torch_permuto_field import _moved_off_init

torch.set_num_threads(1)

GRAD_REL = 1e-3
CROP = 512
VEHICLES = ("veh_0", "veh_1")
FRAME_KEYS = ("rgb_volume", "depth_volume", "mask_volume", "normals_volume")
VEH = "Vehicle#demo_drive"
LATTICE = {"n_levels": 1, "base_res": 16.0, "max_res": 16.0, "log2_hashmap_size": 10}

PERMUTO_SMALL = copy.deepcopy(SMALL)
_B = PERMUTO_SMALL["assetbank_cfg"]
_B["Vehicle"]["model_class"] = WAYMO_DEMO_PERMUTO["assetbank_cfg"]["Vehicle"]["model_class"]
_B["Vehicle"]["model_params"].update(z_dim=8, permuto_cfg=LATTICE)


def _port_values_as_jax_tree(jbank, params):
    """The JAX bank's parameter tree, its structure traced (not computed),
    holding the port's parameter values leaf by leaf (the names as
    ``named_jax_leaves`` gives them)."""
    port = {k: p.detach().numpy().copy() for k, p in params.named_parameters()}
    shapes = jax.eval_shape(jbank.init_params, jax.random.PRNGKey(0))

    def leaf(path, shape):
        v = port.pop(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path))
        assert (v.shape, v.dtype) == (shape.shape, shape.dtype)
        return v

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    assert not port
    return tree


@pytest.fixture(scope="module")
def pair():
    scene, bank, trainer, state, samplers = build_multi_trainer(PERMUTO_SMALL, device="cpu")
    r = PERMUTO_SMALL["renderer"]
    jscene = JaxScene.load_from_scenario(samplers["pixel"].loader.dataset.scenario)
    jbank = JaxBank.create(_B, [jscene])
    jr = JaxCompose.from_asset_bank(jscene, jbank, cr_class=r["cr_class"],
                                    distant_class=r["distant_class"], sky_class=r["sky_class"],
                                    hit_budget_frac=0.5, group_budget_frac=r["group_budget_frac"],
                                    max_hits_per_ray=r["max_hits_per_ray"])
    jt = JaxMOT(jscene, jr, loss_cfgs=PERMUTO_SMALL["training"]["losses"],
                training_cfgs=jbank.training_cfgs(), uniform_sample_n=N_UNIFORM)
    jp = _port_values_as_jax_tree(jbank, state.params)
    rng = np.random.default_rng(0)
    for tree in jp.values():            # move the tables off their init, so the fields vary
        if "encoding" in tree:
            _moved_off_init(tree, rng)
    load_jax_params(state.params, jp)
    state = trainer.init_state(state.params)
    state.it = IT0
    batches = [(samplers["lidar"].sample(), samplers["pixel"].sample())]
    return dict(scene=scene, bank=bank, trainer=trainer, state=state, samplers=samplers,
                jscene=jscene, jbank=jbank, jr=jr, jt=jt, jp=jp, batches=batches)


def test_the_vehicles_are_one_permuto_model_in_both_packages(pair):
    field, jfield = pair["state"].params[VEH], pair["jbank"].assets[VEH].field
    assert type(field).__name__ == type(jfield).__name__ == "ConditionalPermutoNeuSField"
    assert field.encoding.input_dim == jfield.encoding.input_dim == 11
    assert field.encoding.levels == [(float(r), f) for r, f in jfield.encoding.levels]
    assert field.latents.shape == (2, 8) and pair["bank"].assets[VEH].instance_index == \
        pair["jbank"].assets[VEH].instance_index


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
        key = jax.random.PRNGKey({"lidar": 31, "pixel": 32}[step_type])
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


@pytest.mark.parametrize("step_type", ["lidar", "pixel"])
def test_first_step_gradients_match_jax_leaf_by_leaf(first_steps, step_type):
    r = first_steps[step_type]
    assert set(r["grads"]) == set(r["jgrads"])
    reached = 0
    for k, w in r["jgrads"].items():
        w = np.asarray(w)
        g = r["grads"][k]
        if not np.abs(w).max():
            assert not np.abs(g).max(), k
            continue
        reached += 1
        rel = TABLE_GRAD_REL if k.startswith("Street") and k.endswith("encoding.table") \
            else GRAD_REL
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (k, np.abs(g - w).max(),
                                                                np.abs(w).max())
    assert reached >= (5 if step_type == "lidar" else 15)
    assert np.abs(r["grads"][f"{VEH}.latents"]).max() > 0
    if step_type == "pixel":
        assert np.abs(r["grads"][f"{VEH}.encoding.table"]).max() > 0


def test_compose_crop_matches_jax_at_equal_sample_depths(pair):
    """512 rays of frame 0 through the compose renderer (every source, the
    street's grid converged on the ground), the JAX render taking the port's
    sample depths."""
    renderer, params, scene = pair["trainer"].renderer, pair["state"].params, pair["scene"]
    accel = renderer.accels["cr"]
    st = converge_occ(accel, accel.init_state(), ground_sdf_tensor, n=30)
    jst = JaxOcc(jnp.asarray(st.val.numpy()), jnp.asarray(st.mask.numpy()))
    H, W = (int(v) for v in scene.nodes["camera_FRONT"].frame_data["hw"][0].tolist())
    frozen, jfrozen = scene.slice_at(0), pair["jscene"].slice_at(0)
    o, d = camera_get_all_rays(frozen, "camera_FRONT", H, W)
    jo, jd = jax_all_rays(jfrozen, "camera_FRONT", H, W)
    sel = slice(H * W // 2 - CROP // 2, H * W // 2 + CROP // 2)
    placements = []
    with torch.no_grad(), _port_records(pair, placements):
        got = renderer.ray_query(params, frozen, o[sel].contiguous(), d[sel].contiguous(),
                                 occ_states={"cr": st}, return_buffer=True)
    mb = got["merged_buffer"]
    t_max = torch.where(mb["mask"], mb["t"], 0.0).max(-1).values.numpy().astype(np.float64)

    def render(p):
        r = pair["jr"].ray_query(p, jfrozen, jo[sel], jd[sel], occ_states={"cr": jst},
                                 query_overrides={"perturb": False})
        return {k: r[k] for k in FRAME_KEYS + ("rendered_per_obj_in_scene",)}

    with _jax_takes(pair, placements):
        want = jax.jit(render)(jax.tree.map(jnp.asarray, pair["jp"]))
    assert float(got["mask_volume"].max()) > 0.1
    assert float(got["rendered_per_obj_in_scene"]["veh_0"]["mask_volume"].max()) > 0
    outs = [(k, got[k], want[k]) for k in FRAME_KEYS] + [
        (f"{src}.{k}", got["rendered_per_obj_in_scene"][src][k],
         want["rendered_per_obj_in_scene"][src][k])
        for src in ("street", "distant", *VEHICLES) for k in ("rgb_volume", "mask_volume")]
    for k, g, w in outs:
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        e = np.abs(g - w) / (1.0 + (t_max if k == "depth_volume" else np.abs(w)))
        e = e.reshape(e.shape[0], -1).max(-1)
        assert (e > 2e-4).mean() <= 0.02 and e.max() <= 1e-2 and e.mean() <= 2e-5, \
            (k, float(e.max()), float((e > 2e-4).mean()), float(e.mean()))


def test_train_multi_runs_the_permuto_scene_on_the_cpu():
    """The loop over the permuto vehicles: a LiDAR and a pixel step an
    iteration, finite, no skip, no kernel launched on the CPU."""
    from neuralsim_torch import kernels
    from neuralsim_torch.tools.train_multi import train_multi
    kernels.reset_counts()
    out = train_multi(PERMUTO_SMALL, 3, device="cpu")
    assert out["state"].it == 3
    for r in out["log"]:
        assert np.isfinite(r["loss_total"]) and np.isfinite(r["lidar/loss_total"])
        assert r["step_skipped"] == 0 and r["lidar/step_skipped"] == 0
    assert not any(k.launches for k in kernels.KERNELS.values())
    assert float(out["state"].params[VEH].latents.detach().abs().max()) > 0
