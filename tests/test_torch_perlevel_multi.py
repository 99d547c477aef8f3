"""Port parity for the multi-object slice on the per-level CP path: the
``waymo_demo_multi`` scene built with ``NEURALSIM_CP_STACKED=0`` (the setting
of the JAX package's flagship runs), so every CP level of the street and the
vehicles takes the per-level path (K2's plain version), and the LiDAR step's
street buffer is composited with its NeuS alpha inside the composite (K12's
plain version). Against the JAX package's ``AssetBank``,
``BufferComposeRenderer`` and ``MultiObjectTrainer`` built under the same
variable, on the CPU.

Small size: test_torch_multi_train.py's ``SMALL`` (2 vehicles on one
conditional model of 2 dense + 2 CP levels, the street of 3 CP levels to 64
with a 16^3 grid, 8 distant samples, narrow MLPs; 64 pixel rays and 48 LiDAR
beams a step), with its batches, its replay of the JAX key tree and its
sharing of sample depths: each port step records its sample depths (the
grid's proposal and every upsample stage's draws) and the JAX step, traced
anew and jitted, takes them (see that file).

Tolerances. One LiDAR and one pixel step: the loss terms within 1e-4
relative, every gradient leaf within 1e-3 of its largest entry, as in
test_torch_multi_train.py; the tables within 2**-7 of their largest entry
(JAX rounds each per-level line gradient to bf16 three times: the
cotangents of the feature and the slope matmul and their sum, see
test_torch_lotd_cp_level.py). The compose crop (512 rays of frame 0 at the
port's sample depths), each output and each source's share by ray, relative
to 1 + |value| (the depth to 1 + the ray's deepest sample: distant lanes lie
at 1e4-1e5): at most 2% of the rays beyond 2e-4, the limit of
test_torch_compose_render.py for rays sampled alike (measured <= 0.6%), none
beyond 1e-2 (<= 6.6e-4) and a mean within 2e-5 (<= 4.1e-6). The few rays
beyond 2e-4 are the street's: at equal depths its steep alpha turns a
last-bit difference of the position (the jitted JAX step fuses ``o + t d``
and the tent weights' arithmetic, which the port does op by op) into a flip
of a bf16 tent weight on one of ten levels (eagerly, JAX is within 1.2e-4
of the port on all but one ray).
"""
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
from neuralsim_torch.scene.observers import camera_get_all_rays
from neuralsim_torch.tools.build import build_multi_trainer, converge_occ
from neuralsim_torch.dataio.waymo_demo import ground_sdf_tensor
from test_torch_multi_train import (IT0, LIDAR_LOSSES, LOSSES, N_UNIFORM, SMALL, _B,
                                    _jax_batch, _jax_takes, _noise, _port_batch,
                                    _port_records, _scalars)

torch.set_num_threads(1)

GRAD_REL, TABLE_GRAD_REL = 1e-3, 2.0 ** -7
CROP = 512
VEHICLES = ("veh_0", "veh_1")
FRAME_KEYS = ("rgb_volume", "depth_volume", "mask_volume", "normals_volume")


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEURALSIM_CP_STACKED", "0")
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
    batches = [(samplers["lidar"].sample(), samplers["pixel"].sample())]
    return dict(scene=scene, bank=bank, trainer=trainer, state=state, samplers=samplers,
                jscene=jscene, jbank=jbank, jr=jr, jt=jt, jp=jp, batches=batches)


def test_every_encoding_is_per_level_in_both_packages(pair):
    encs = {mid: f.encoding for mid, f in pair["state"].params.items() if hasattr(f, "encoding")}
    assert set(encs) == {"Vehicle#demo_drive", "Street#demo_drive"}
    for mid, enc in encs.items():
        jenc = pair["jbank"].assets[mid].field.encoding
        n_cp = sum(s.typ == "cp" for s in enc.specs)
        assert n_cp >= 2 and not enc.cp_stacked and not jenc.cp_stacked, mid
        assert enc._cp_meta.shape == (n_cp, 4) and enc.kernel_lines() is None


@pytest.fixture(scope="module")
def first_steps(pair):
    """One LiDAR step's and one pixel step's losses, gradients and merged
    buffers, from the same parameters and sample depths, in both packages."""
    out = {}
    trainer, state, jt = pair["trainer"], pair["state"], pair["jt"]
    jparams = jax.tree.map(jnp.asarray, pair["jp"])
    jocc = {"cr": JaxOcc(jnp.asarray(state.occ["cr"].val.numpy()),
                         jnp.asarray(state.occ["cr"].mask.numpy()))}
    plist = dict(state.params.named_parameters())
    lb, raw = pair["batches"][0]
    renderer, calls = trainer.renderer, []
    ray_query = type(renderer).ray_query

    def recording(*a, **kw):
        calls.append(ray_query(renderer, *a, **kw))
        return calls[-1]

    renderer.ray_query = recording
    try:
        for step_type, b in (("lidar", lb), ("pixel", raw)):
            key = jax.random.PRNGKey({"lidar": 21, "pixel": 22}[step_type])
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
                    lambda p: jt.compute_losses(p, jb, IT0, key, step_type, occ=jocc,
                                                cam_id=cam), has_aux=True))(jparams)
            out[step_type] = dict(
                got={"loss_total": float(total.detach()),
                     **_scalars({k: v.detach() for k, v in extras["losses"].items()})},
                want={"loss_total": float(jtotal), **_scalars(jextras["losses"])},
                buffer=calls[-1]["merged_buffer"],
                grads={k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
                       for (k, p), g in zip(plist.items(), grads)},
                jgrads=named_jax_leaves(jax.device_get(jg), {m: m for m in jg}))
    finally:
        del renderer.ray_query
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
        rel = TABLE_GRAD_REL if k.endswith("encoding.table") else GRAD_REL
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (k, np.abs(g - w).max(),
                                                                np.abs(w).max())
    assert reached >= (5 if step_type == "lidar" else 15)
    assert np.abs(r["grads"]["Street#demo_drive.encoding.table"]).max() > 0


def test_the_lidar_step_fuses_the_alpha_and_the_pixel_step_does_not(first_steps):
    """The LiDAR step's street buffer came without alpha (rays_d and the cos
    anneal instead; K12's plain version added it), the pixel step's merged
    buffer composites alphas order-free (K8)."""
    lid, pix = first_steps["lidar"]["buffer"], first_steps["pixel"]["buffer"]
    assert "rays_d" in lid and "cos_anneal" in lid and "vw" not in lid
    assert lid["alpha"].shape == lid["t"].shape
    assert not bool(lid["alpha"][~lid["mask"]].any())
    assert "rays_d" not in pix and "vw" in pix


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
